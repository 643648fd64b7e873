"""The plain references agree with srcaco2_tpu_torch at tiny sizes on the
CPU, in float32: the networks, the batch assembly, the loss and Adam;
and they import nothing of the program."""
import subprocess
import sys

import pytest
import torch

from benchmark import core
from benchmark.drivers import train as T
from benchmark.reference import common as RC
from conftest import tiny_cell

CPU = torch.device('cpu')


def _f32(cell):
    cell.cfg['compute_dtype'] = 'float32'
    return cell


@pytest.mark.parametrize('name,sides', [('tiny_swinir.train', (16, 32)),
                                        ('tiny_dbpn.train', (4, 8))])
def test_network_forward_matches_the_program(name, sides):
    from srcaco2_tpu_torch.models.registry import define_g
    cell = _f32(tiny_cell(name))
    port, ref = cell.port(), cell.reference()
    params = T.weights(cell, 3, CPU)
    model = define_g(port.port_args(cell.cfg, 128), CPU)
    model.load_state_dict(port.to_port(params, cell.cfg))
    back = port.from_port(dict(model.state_dict()), cell.cfg)
    assert set(back) == set(params)
    assert all(torch.equal(back[k], params[k]) for k in params)
    for side in sides:
        x = torch.rand(2, cell.cfg['in_chans'], side, side)
        for train in (True, False):
            model.train(train)
            with torch.no_grad():
                got = model(x)
            got = got['out'] if isinstance(got, dict) else got
            want = ref.forward(params, x, cell.cfg)
            assert got.shape == want.shape
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_batch_assembly_matches_the_program():
    from srcaco2_tpu_torch.data import pipeline as P
    cell = tiny_cell('tiny_swinir.train')
    tr, cfg = cell.traffic, cell.cfg
    hr, lr = T.make_stacks(cell, 9, CPU)
    draws = T.Draws(cell, 9, CPU)
    for _ in range(4):
        idxs, x0, y0, mode = draws.next()
        batch = P.assemble(hr, lr, idxs, P.Draws(x0, y0, mode),
                           P.PipeConfig(scale=cfg['scale'],
                                        h_size=tr['h_size']))
        x, y = RC.train_batch(hr, lr, idxs, x0, y0, mode, cfg['scale'],
                              tr['h_size'])
        assert torch.equal(batch['l_im'], x)
        assert torch.equal(batch['h_im'], y)


def test_loss_and_adam_match_the_program():
    from srcaco2_tpu_torch.config.defaults import get_config
    from srcaco2_tpu_torch.losses.master import build_loss
    from srcaco2_tpu_torch.train.schedule import build_optimizer
    cfg = tiny_cell('tiny_swinir.train').cfg
    loss, opt = cfg['train']['loss'], cfg['train']['optimizer']
    args = get_config()
    args.update(l2=True, l2_lambda=loss['l2_lambda'], ssim=True,
                ssim_lambda=loss['ssim_lambda'],
                ssim_window_s=loss['ssim_window'])
    g = torch.Generator().manual_seed(0)
    p = torch.rand(4, 1, 32, 32, generator=g)
    y = torch.rand(4, 1, 32, 32, generator=g)
    total, holder = build_loss(args)({'out': p}, {'h_im': y})
    a, b = RC.loss_part(p, y, loss, 4)
    torch.testing.assert_close(a + b, total, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a, holder['l2'])
    # two halves of the batch add up to the whole
    a1, b1 = RC.loss_part(p[:2], y[:2], loss, 4)
    a2, b2 = RC.loss_part(p[2:], y[2:], loss, 4)
    torch.testing.assert_close(a1 + b1 + a2 + b2, total, rtol=1e-5,
                               atol=1e-6)
    args['train'].update(G_optimizer_lr=opt['lr'],
                         G_optimizer_wd=opt['weight_decay'])
    tx = build_optimizer(args['train'])
    params = {'w': torch.randn(5, 3, generator=g)}
    mine = {'w': params['w'].clone()}
    state, st = tx.init(params), RC.adam_init(mine)
    for _ in range(3):
        grads = {'w': torch.randn(5, 3, generator=g)}
        upd, state = tx.update(grads, state, params)
        params = {'w': params['w'] + upd['w']}
        RC.adam_update(mine, grads, st, opt)
        torch.testing.assert_close(mine['w'], params['w'], rtol=1e-6,
                                   atol=1e-8)


def test_references_import_nothing_of_the_program():
    code = ('import sys\n'
            f'sys.path.insert(0, {str(core.ROOT)!r})\n'
            'import benchmark.reference.swinir, benchmark.reference.dbpn\n'
            'import benchmark.reference.common\n'
            'print(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("srcaco2_tpu_torch", "srcaco2_tpu", "jax")))\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
