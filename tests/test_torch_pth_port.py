"""The port's reference `.pth` loader (srcaco2_tpu_torch/diagnosis:
torch_port, parity, manifest) against the JAX package's.

For every net that eval_pretrained_pth dispatches, at small widths: the
port's flax-layout template has the paths, shapes and order of JAX's
init tree (its creation order, read inside the trace: a jit boundary
sorts the keys), and a reference-layout state list made from JAX's init
tree (numpy-seeded values) (the inverse of `_fits`; SwinIR,
GRL and DSR-Splines under the reference's names) ported by the port
gives bit for bit the parameters that JAX's port_* + bridge.flax_to_torch
give. Then the checkpoint walk on a made-up tree, eval_pretrained_pth
and the batch mode against JAX's on a tiny synthetic dataset (within
1e-5 dB), and the fold manifest's reports."""
import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srcaco2_tpu.config.defaults import get_config as jget
from srcaco2_tpu.config.parser import _derive as jderive
from srcaco2_tpu.diagnosis import manifest as JM
from srcaco2_tpu.diagnosis import parity as JPAR
from srcaco2_tpu.diagnosis import torch_port as JTP
from srcaco2_tpu.models.registry import define_g as jdefine
from srcaco2_tpu_torch.bridge import flax_to_torch
from srcaco2_tpu_torch.config.defaults import get_config as tget
from srcaco2_tpu_torch.config.parser import _derive as tderive
from srcaco2_tpu_torch.diagnosis import manifest as TM
from srcaco2_tpu_torch.diagnosis import parity as TPAR
from srcaco2_tpu_torch.diagnosis import torch_port as TTP
from srcaco2_tpu_torch.models.registry import define_g as tdefine


@pytest.fixture(autouse=True, scope='module')
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_SWIN = dict(swinir_embed_dim=16, swinir_depths=[2, 2],
             swinir_num_heads=[2, 2], swinir_window_size=4)
# name: (net_type, netG overrides, LR side of the init input)
NETS = {
    'SRCNN': ('SRCNN', {}, 16),
    'VDSR': ('VDSR', {}, 8),
    'DRRN': ('DRRN', {'drrn_num_residual_units': 2}, 8),
    'MemNet': ('MemNet', {'memnet_num_memory_blocks': 2,
                          'memnet_num_residual_blocks': 2}, 8),
    'DFCAN': ('DFCAN', {}, 8),
    'MSLapSRN': ('MSLapSRN', {}, 8),
    'SRFBN': ('SRFBN', {'srfbn_num_features': 8, 'srfbn_num_steps': 2,
                        'srfbn_num_groups': 2}, 8),
    'ENLCN': ('ENLCN', {'enlcn_n_resblock': 2, 'enlcn_n_feats': 16}, 8),
    'ACT': ('ACT', dict(act_n_feats=8, act_n_resgroups=2, act_n_resblocks=2,
                        act_reduction=4, act_n_heads=4, act_n_layers=2,
                        act_n_fusionblocks=2, act_expansion_ratio=2), 9),
    'OmniSR': ('OmniSR', dict(omnisr_num_feat=16, omnisr_res_num=1,
                              omnisr_block_num=1, omnisr_window_size=4), 8),
    'NLSN': ('NLSN', dict(nlsn_n_resblocks=2, nlsn_n_feats=16,
                          nlsn_n_hashes=2, nlsn_chunk_size=16), 8),
    # an even stage (scanned pairs) and an odd one (unrolled)
    'GRL': ('GRL', dict(grl_embed_dim=16, grl_depths=[2, 1],
                        grl_num_heads_window=[2, 2],
                        grl_num_heads_stripe=[2, 2], grl_window_size=4), 8),
    'EDSR_LIIF': ('EDSR_LIIF', dict(edsr_liif_n_feats=8,
                                    edsr_liif_n_resblocks=2), 8),
    'ProSR': ('ProSR', dict(prosr_num_init_features=16, prosr_growth_rate=8,
                            prosr_bn_size=2,
                            prosr_level_config={2: [[2, 2]]}), 8),
    'DBPN': ('DBPN', dict(dbpn_base_filter=8, dbpn_feat=16,
                          dbpn_num_stages=2), 8),
    'DSRSplines': ('DSRSplines', dict(dsrsplines_n_splines_per_color=4), 8),
    'CSRCNN': ('CSRCNN', dict(csrcnn_inner_channel=8, csrcnn_res_blocks=1,
                              csrcnn_channel_mults='1_2',
                              csrcnn_ngroups=4, csrcnn_norm_groups=4), 8),
    # uniform stages: scanned (stages/RSTB_0) with the fused stack
    'SwinIR': ('SwinIR', _SWIN, 8),
    # non-uniform stages: rstb{s}
    'SwinIR_rstb': ('SwinIR', dict(_SWIN, swinir_depths=[2, 3]), 8),
    # the unfused layout: scanned pairs, and an odd unrolled stage
    'SwinIR_unfused': ('SwinIR', dict(_SWIN, swinir_use_fused_blocks=False,
                                      swinir_depths=[2, 3]), 8),
}


def _np(tree):
    """numpy leaves, the dict order kept (jax.tree_util sorts keys)."""
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _args(get, derive, nt, over):
    args = get(nt)
    args.update(scale=2, n_channels=1, h_size=32)
    args['netG'][f'{nt.lower()}_in_chans'] = 1
    args['netG'].update({'dbpn_remat_blocks': False,
                         'memnet_remat_passes': False}
                        if nt in ('DBPN', 'MemNet') else {})
    args['netG'].update(over)
    return derive(args)


def _jax_init_tree(model, x, seed=0):
    """JAX's init param tree in creation order, traced only: the order is
    read from the dict inside the trace (a jit or eval_shape boundary
    sorts the keys), and the leaves are numpy-seeded normal draws of the
    traced shapes."""
    from flax.traverse_util import flatten_dict
    order = []

    def init(k, t):
        v = model.init(k, t, train=False)['params']
        order.extend(flatten_dict(v).keys())
        return v

    shapes = flatten_dict(jax.eval_shape(init, jax.random.key(0),
                                         jnp.asarray(x)))
    rng = np.random.default_rng(seed)
    return TTP.unflatten_dict({k: rng.standard_normal(shapes[k].shape)
                               .astype(np.float32) for k in order})


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX's init tree for the net, in creation order, numpy-seeded
    values; the port's net of the same config; the init input; JAX's
    netG)."""
    nt, over, hw = NETS[name]
    hw = 2 * hw if nt == 'SRCNN' else hw
    x = np.zeros((1, 1, hw, hw), np.float32)
    ja = _args(jget, jderive, nt, over)
    params = _jax_init_tree(jdefine(ja), x)
    tm = tdefine(_args(tget, tderive, nt, over), 'cpu')
    return params, tm, torch.from_numpy(x), ja['netG']


def _flat(tree):
    return [('/'.join(k), tuple(np.shape(a)))
            for k, a in TTP.flatten_dict(tree).items()]


@pytest.mark.parametrize('name', list(NETS))
def test_template_has_jax_key_order(name):
    params, tm, x, _ = _pair(name)
    tpl = TTP.flax_template(tm, NETS[name][0], x)
    assert _flat(tpl) == _flat(params)


# ---------------------------------------- reference-layout state lists
def _torch_layout(path, a):
    """_fits inverted: a flax leaf in the torch layout the reference
    saves (Conv2d (O, I, kh, kw), ConvTranspose2d (I, O, kh, kw) flipped,
    Linear (O, I), a PReLU slope (1,)), with its module kind."""
    if a.ndim == 4 and 'ConvTranspose_0' in path:
        return a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1], 'ConvTranspose2d'
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1), 'Conv2d'
    if a.ndim == 2 and path[-1] == 'kernel':
        return a.T, 'Linear'
    if a.ndim == 0:
        return a.reshape(1), 'PReLU'
    return a, ''


def _order_list(params):
    """The reference's ordered (name, array, kind) list of an order-based
    net: JAX's leaves in creation order, in torch layouts."""
    out = []
    for path, a in TTP.flatten_dict(params).items():
        t, kind = _torch_layout(path, a)
        out.append(('.'.join(path), np.ascontiguousarray(t, np.float32),
                    kind))
    return out


def _grl_list(params):
    """port_grl inverted: the reference GRL's names (network_grl.py)."""
    out = []
    for path, a in TTP.flatten_dict(params).items():
        ks = '/'.join(path)
        leaf = path[-1]
        rel = (lambda v: _torch_layout(path, v)[0])
        if path[0].endswith('_blocks'):
            s_i, member = int(path[0][1:-7]), int(path[1][-1])
            rest = '/'.join(path[2:])
            tleaf = JTP._GRL_BLOCK[rest] if leaf == 'logit_scale' else \
                JTP._GRL_BLOCK[rest.rsplit('/', 1)[0]] + '.' + JTP._WB[leaf]
            for p in range(a.shape[0]):
                out.append((f'layers.{s_i}.blocks.{2 * p + member}.{tleaf}',
                            rel(a[p])))
        elif path[0].endswith('_conv'):
            out.append((f'layers.{path[0][1:-5]}.conv.{JTP._WB[leaf]}',
                        rel(a)))
        else:
            mod = ks.rsplit('/', 1)[0]
            base = JTP._GRL_PLAIN.get(mod, JTP._GRL_PLAIN.get(path[0]))
            out.append((f'{base}.{JTP._WB[leaf]}', rel(a)))
    return [(n, np.ascontiguousarray(t, np.float32)) for n, t in out]


def _dsr_list(params):
    """port_dsr_splines inverted: one network per spline."""
    flat = TTP.flatten_dict(params)
    convs = sorted({k[1] for k in flat}, key=lambda c: int(c[5:]))
    n_s = flat[('splines', convs[0], 'bias')].shape[0]
    return [(f'splines.{s}.model.{c}.conv.{wb}', np.ascontiguousarray(
        flat[('splines', c, leaf)][s].transpose(3, 2, 0, 1)
        if leaf == 'kernel' else flat[('splines', c, leaf)][s]))
        for s in range(n_s) for c in convs
        for leaf, wb in (('kernel', 'weight'), ('bias', 'bias'))]


def _swin_list(params, tm):
    """The reference SwinIR's names through the port: JAX's tree
    bridged onto the port's net, then chip_smoke.swinir_reference_state,
    through the .pth loader's filter."""
    import tempfile
    state = flax_to_torch(params, tm)
    ref = _chip_smoke().swinir_reference_state(state)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, 'G.pth')
        torch.save(ref, p)
        return TPAR.load_pth_state(p), JPAR.load_pth_state(p)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize('name', list(NETS))
def test_port_equals_jax_port(name):
    """The port's port_* on its template, then flax_to_torch, equals
    JAX's port_* on its init tree, then flax_to_torch, bit for bit."""
    params, tm, x, netg = _pair(name)
    nt = NETS[name][0]
    fused = nt == 'SwinIR' and netg.get('swinir_use_fused_blocks')
    tpl = TTP.flax_template(tm, nt, x)
    if fused:
        tp, tp_jax = _swin_list(params, tm)
        assert [n for n, _ in tp] == [n for n, _ in tp_jax]
        got, want = TTP.port_swinir(tp, tpl), JTP.port_swinir(tp, params)
    elif nt == 'DSRSplines':
        tp = _dsr_list(params)
        got, want = TTP.port_dsr_splines(tp, tpl), \
            JTP.port_dsr_splines(tp, params)
    elif nt == 'DBPN':
        tp = _order_list(params)
        got = TTP.port_dbpn(tp, tpl, remat_blocks=False)
        want = JTP.port_dbpn(tp, params, remat_blocks=False)
    else:
        tp = _order_list(params)
        got, want = TTP.port_state_dict(tp, tpl), \
            JTP.port_state_dict(tp, params)
    want = _np(want)
    assert _flat(got) == _flat(want)
    a, b = flax_to_torch(got, tm), flax_to_torch(want, tm)
    assert a.keys() == b.keys() == dict(tm.named_parameters()).keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # and through parity.port_pth, the loader's own path, for the nets
    # whose template forward is cheap at the loader's input size
    if nt in ('SRCNN', 'SwinIR', 'DSRSplines', 'DBPN'):
        state = TPAR.port_pth(tp, tm, nt, netg, 2)
        for k in a:
            assert torch.equal(state[k], a[k]), k


def test_port_grl_by_name():
    """port_grl (name-based, all stages even: scanned) against JAX's."""
    over = dict(NETS['GRL'][1], grl_depths=[2, 2])
    NETS['GRL_even'] = ('GRL', over, 8)
    try:
        params, tm, x, _ = _pair('GRL_even')
    finally:
        del NETS['GRL_even']
    tp = _grl_list(params)
    tpl = TTP.flax_template(tm, 'GRL', x)
    got = TTP.port_grl(tp, tpl)
    want = _np(JTP.port_grl(tp, params))
    a, b = flax_to_torch(got, tm), flax_to_torch(want, tm)
    assert all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def test_dbpn_guard_and_mismatch_raise():
    with pytest.raises(ValueError, match='remat_blocks=False'):
        TTP.port_dbpn([], {}, remat_blocks=True)
    params, tm, x, _ = _pair('SRCNN')
    tpl = TTP.flax_template(tm, 'SRCNN', x)
    tp = _order_list(params)
    with pytest.raises(ValueError, match='count mismatch'):
        TTP.port_state_dict(tp[:-1], tpl)
    with pytest.raises(ValueError, match='shape mismatch'):
        TTP.port_state_dict([tp[1]] + tp[1:], tpl)


def test_torch_named_params_kinds():
    m = torch.nn.Sequential(torch.nn.Conv2d(2, 2, 3),
                            torch.nn.ConvTranspose2d(2, 2, 3))
    got = TTP.torch_named_params(m)
    want = JTP.torch_named_params(m)
    assert [(n, k) for n, _, k in got] == [(n, k) for n, _, k in want]
    assert [k for _, _, k in got] == ['Conv2d'] * 2 + ['ConvTranspose2d'] * 2


# ------------------------------------------------- the checkpoint walk
def _mk_tree(root):
    def mk(*parts):
        p = os.path.join(root, *parts, 'best-models')
        os.makedirs(p)
        return os.path.join(p, 'G-model.pth')
    return mk


def test_discover_pth_checkpoints(tmp_path, capsys):
    mk = _mk_tree(str(tmp_path))
    for parts in (('super-resolution', 'ACT',
                   'caco2_train_X_2_in_256_out_512_cell_CELL0',
                   'id_12_21-tsk_super-resolution-x_2-netG_ACT-sd_0-l2_yes'),
                  ('super-resolution', 'SwinIR',
                   'caco2_train_X_8_in_64_out_512_cell_CELL2', 'no_tag'),
                  ('super-resolution', 'NOTANET',
                   'caco2_train_X_4_in_128_out_512_cell_CELL1', 'no_tag')):
        torch.save({'w': torch.zeros(1)}, mk(*parts))
    got = TPAR.discover_pth_checkpoints(str(tmp_path))
    assert got == JPAR.discover_pth_checkpoints(str(tmp_path))
    assert sorted((n, s, c) for _, n, s, c in got) == [
        ('ACT', 2, 'CELL0'), ('SwinIR', 8, 'CELL2')]
    assert 'unparseable checkpoint path skipped' in capsys.readouterr().out


@pytest.fixture(scope='module')
def ds_root(tmp_path_factory):
    from srcaco2_tpu_torch.data.synthetic import make_synthetic_dataset
    root = str(tmp_path_factory.mktemp('pthds'))
    make_synthetic_dataset(root, scale=2, cell='CELL0', n_train=1, n_val=1,
                           n_test=2, size=64)
    return root


@pytest.fixture(scope='module')
def srcnn_pth(tmp_path_factory):
    """A reference-layout SRCNN checkpoint (default widths) made from
    JAX's init tree, saved as the reference saves its state_dict."""
    ja = _args(jget, jderive, 'SRCNN', {})
    v = jdefine(ja).init(jax.random.key(3), jnp.zeros((1, 1, 32, 32)),
                         train=False)
    tp = _order_list(_np(v['params']))
    p = str(tmp_path_factory.mktemp('pth') / 'G-model.pth')
    torch.save({n: torch.from_numpy(a.copy()) for n, a, _ in tp}, p)
    return p


def _close_rows(a, b, tol=1e-5):
    """Each metric within tol of max(1, |JAX's|): PSNR within 1e-5 dB."""
    for scope in ('full', 'roi'):
        for m, v in b[scope].items():
            assert abs(float(a[scope][m]) - float(v)) <= \
                tol * max(1.0, abs(float(v))), (scope, m)


def test_eval_pretrained_pth_equals_jax(ds_root, srcnn_pth, monkeypatch):
    # random weights: a negative SSIM is a warning, not a stop, on both
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')
    got = TPAR.eval_pretrained_pth(srcnn_pth, 'SRCNN', 2, 'CELL0', ds_root,
                                   ds_root, device='cpu')
    want = JPAR.eval_pretrained_pth(srcnn_pth, 'SRCNN', 2, 'CELL0', ds_root,
                                    ds_root)
    assert got['n'] == want['n'] == 2
    _close_rows(got, want)


def test_eval_pth_batch_and_main(ds_root, srcnn_pth, tmp_path, monkeypatch):
    """The batch walk evaluates the good checkpoint, records the broken
    one and goes on, as JAX's; main reports the failure by its exit
    code and writes the report."""
    import shutil
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')
    mk = _mk_tree(str(tmp_path / 'tree'))
    shutil.copy(srcnn_pth, mk('super-resolution', 'SRCNN',
                              'caco2_train_X_2_in_256_out_512_cell_CELL0',
                              'id_a-tsk_sr-x_2-netG_SRCNN-sd_0'))
    torch.save({'garbage.weight': torch.zeros(3, 3)},
               mk('super-resolution', 'VDSR',
                  'caco2_train_X_2_in_256_out_512_cell_CELL0',
                  'id_b-tsk_sr-x_2-netG_VDSR-sd_0'))
    got_r, want_r = {}, {}
    got = TPAR.eval_pth_batch(str(tmp_path / 'tree'), ds_root, ds_root,
                              got_r, device='cpu')
    want = JPAR.eval_pth_batch(str(tmp_path / 'tree'), ds_root, ds_root,
                               want_r)
    assert got['n_ok'] == want['n_ok'] == 1
    assert got['failures'].keys() == want['failures'].keys() == {
        'VDSR x2 CELL0'}
    lab = 'SRCNN (ported .pth)'
    _close_rows(got_r[2]['methods'][lab]['CELL0'],
                want_r[2]['methods'][lab]['CELL0'])
    out_md = str(tmp_path / 'report.md')
    rc = TPAR.main(['--data_root', ds_root, '--scales', '2', '--cells',
                    'CELL0', '--pth_root', str(tmp_path / 'tree'),
                    '--out', out_md, '--device', 'cpu'])
    assert rc == 3
    md = open(out_md).read()
    assert lab in md and '| Bicubic |' in md


def test_bicubic_parity_and_published_override(ds_root, tmp_path):
    """check_bicubic_parity against JAX's, and main's PASS / FAIL on a
    fabricated published table (written as JSON, which the port's
    reader and YAML read alike)."""
    from srcaco2_tpu_torch.config import yaml_io
    got = TPAR.check_bicubic_parity(ds_root, ds_root, 2, cells=['CELL0'],
                                    device='cpu')
    want = JPAR.check_bicubic_parity(ds_root, ds_root, 2, cells=['CELL0'])
    _close_rows(got['CELL0'], want['CELL0'])
    pub = {'full': {'2,CELL0': got['CELL0']['full_psnr']},
           'roi': {'2,CELL0': got['CELL0']['roi_psnr']}}
    path = str(tmp_path / 'published.yaml')
    with open(path, 'w') as f:
        f.write(yaml_io.to_json(pub))
    args = ['--data_root', ds_root, '--scales', '2', '--cells', 'CELL0',
            '--published', path, '--out', str(tmp_path / 'r.md'),
            '--device', 'cpu']
    assert TPAR.main(args) == 0
    pub['full']['2,CELL0'] += 1.0
    with open(path, 'w') as f:
        f.write(yaml_io.to_json(pub))
    assert TPAR.main(args) == 1
    assert 'FAIL' in open(str(tmp_path / 'r.md')).read()
    assert TPAR.build_report({2: {'bicubic': want}}, ['CELL0'], '') == \
        JPAR.build_report({2: {'bicubic': want}}, ['CELL0'], '')


def test_load_pth_state_unwraps_and_filters(tmp_path):
    sd = {'params': {
        'conv.weight': torch.zeros(4, 1, 3, 3),
        'conv.bias': torch.zeros(4),
        'layers.0.attn_mask': torch.zeros(4, 4),
        'rpi.relative_position_index': torch.zeros(9, 9, dtype=torch.long)}}
    p = str(tmp_path / 'x.pth')
    torch.save(sd, p)
    got, want = TPAR.load_pth_state(p), JPAR.load_pth_state(p)
    assert [n for n, _ in got] == [n for n, _ in want] == \
        ['conv.weight', 'conv.bias']


def test_main_needs_a_card_or_device_cpu(ds_root):
    if torch.cuda.is_available():
        pytest.skip('a card is visible')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TPAR.main(['--data_root', ds_root, '--scales', '2'])


# ------------------------------------------------------- the manifest
def test_manifest_reports_equal_jax(tmp_path):
    root = str(tmp_path / 'splits')
    os.makedirs(root)
    ds = 'caco2_test_X_2_in_256_out_512_cell_CELL0'
    assert TM.fold_manifest(root) == JM.fold_manifest(root)
    import yaml
    with open(JM.SHIPPED_MANIFEST) as f:
        assert yaml.safe_load(open(TM.SHIPPED_MANIFEST)) == yaml.safe_load(f)

    def both(**kw):
        a = TM.validate_layout(root, ds_names=[ds], **kw)
        b = JM.validate_layout(root, ds_names=[ds], **kw)
        assert a == b
        return a

    assert both(expected_path=TM.SHIPPED_MANIFEST)['ok']
    fd = os.path.join(root, TM.FOLDS_SUBDIR, ds)
    lh = os.path.join(fd, 'l_h.txt')
    lines = open(lh).read().splitlines()
    with open(lh, 'w') as f:
        f.write('\n'.join(lines[:10]) + '\n')
    rep = both(expected_path=JM.SHIPPED_MANIFEST)
    assert not rep['ok'] and 'sha256' in '\n'.join(rep['errors'])
    argv = ['--splits_root', root, '--datasets',
            ds + ',caco2_test_X_4_in_128_out_512_cell_CELL9']
    assert TM.main(argv) == JM.main(argv) == 1
    with open(lh, 'w') as f:
        f.write('a.tif,b.tif\n')
    with open(os.path.join(fd, 'h_l.txt'), 'w') as f:
        f.write('b.tif,a.tif\n')
    data_root = str(tmp_path / 'data')
    os.makedirs(data_root)
    open(os.path.join(data_root, 'a.tif'), 'w').close()
    rep = both(data_root=data_root)
    assert any('missing under' in e and 'b.tif' in e for e in rep['errors'])
    # written and read back as JSON, without PyYAML as with it
    out = str(tmp_path / 'm.yaml')
    man = TM.write_manifest(root, out)
    assert TM.validate_layout(root, expected_path=out,
                              ds_names=[ds])['ok']
    assert yaml.safe_load(open(out))['datasets'] == man
