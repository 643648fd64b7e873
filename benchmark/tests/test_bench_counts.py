"""The frozen operation and byte counts, and the readers that use them."""
import re
import pytest

from benchmark import core, counts
from conftest import tiny_cell

CSRC = core.ROOT / 'srcaco2_tpu_torch' / 'ops' / 'csrc'
FLAG = core.load_json(core.BENCH / 'configs' / 'swinir_x8.json')
DBPN = core.load_json(core.BENCH / 'configs' / 'dbpn_x8.json')
H100 = 'NVIDIA H100 80GB HBM3'


def test_kernel_counts_at_the_flagship_shapes():
    tokens = 128 * 16 * 16
    assert counts.swin_kernel_work('k1', FLAG, tokens, 256)[0] == \
        pytest.approx(18.50e9, rel=1e-3)
    assert counts.swin_kernel_work('k2', FLAG, tokens, 256)[0] == \
        pytest.approx(51.24e9, rel=1e-3)
    assert counts.swin_kernel_work('k5', FLAG, 8 * 64 * 64, 256)[0] == \
        pytest.approx(18.50e9, rel=1e-3)
    flops, nbytes = counts.swin_kernel_work('k1', FLAG, tokens, 256)
    # operations bound K1 on the H100
    assert flops / 989e12 > nbytes / 3.35e12


def test_forward_counts():
    assert counts.forward_flops(FLAG, 16, 16) == pytest.approx(6.30e9,
                                                               rel=1e-3)
    assert counts.forward_flops(FLAG, 64, 64) == pytest.approx(100.82e9,
                                                               rel=1e-4)
    assert counts.forward_flops(DBPN, 16, 16) == pytest.approx(43.58e9,
                                                               rel=1e-3)
    assert counts.peak(H100)['flops'] == 989e12


@pytest.mark.parametrize('name,pattern', [
    ('k1_roofline', 'swin_block_fwd_kernel'),
    ('k2_roofline', 'swin_block_bwd_window_kernel'),
    ('k2_roofline', 'swin_block_bwd_reduce_kernel'),
    ('k5_roofline', 'swin_block_grouped_kernel')])
def test_readers_name_the_kernels_of_the_sources(name, pattern):
    read = tiny_cell('tiny_swinir.train').reader(name)
    assert any(v.search(f'void {pattern}<__nv_bfloat16>(Params)')
               for v in read.__globals__.values()
               if isinstance(v, re.Pattern))
    assert any(re.search(rf'__global__[^;{{]*\b{pattern}\s*\(',
                         p.read_text(), re.S)
               for p in list(CSRC.glob('*.cu')) + list(CSRC.glob('*.cuh')))


def _obs(cell, kernels, traced_s=1.0, samples=0):
    return dict(cfg=cell.cfg, traffic=cell.traffic, peak=counts.peak(H100),
                traced=dict(kernels=kernels, busy_s=0.5), traced_s=traced_s,
                traced_samples=samples)


def test_roofline_readers_and_nothing_to_read():
    cell = tiny_cell('tiny_swinir.train')
    read = cell.reader('k1_roofline')
    name = 'void swin_block_fwd_kernel<__nv_bfloat16>(Params)'
    tr, cfg = cell.traffic, cell.cfg
    tokens = tr['batch'] * (tr['h_size'] // cfg['scale']) ** 2
    flops, nbytes = counts.swin_kernel_work('k1', cfg, tokens, 256)
    least = max(flops / 989e12, nbytes / 3.35e12)
    got = read(_obs(cell, {name: (4 * least * 2, 4)}))
    assert got == pytest.approx(50.0)
    assert read(_obs(cell, {})) is None
    assert read(dict(_obs(cell, {name: (1.0, 1)}), peak=None)) is None
    # K2's time is its two passes', per launch of its window pass
    read2 = cell.reader('k2_roofline')
    w = 'void swin_block_bwd_window_kernel<__nv_bfloat16>(BwdParams)'
    r = 'void swin_block_bwd_reduce_kernel<__nv_bfloat16>(BwdParams)'
    one = read2(_obs(cell, {w: (0.3, 2), r: (0.1, 2)}))
    assert one == pytest.approx(read2(_obs(cell, {w: (0.4, 2)})))


def test_mfu_idle_and_memory_readers():
    cell = tiny_cell('tiny_swinir.train')
    obs = _obs(cell, {}, traced_s=2.0, samples=10)
    side = cell.traffic['h_size'] // cell.cfg['scale']
    want = 100 * 3 * counts.forward_flops(cell.cfg, side, side) * 10 \
        / 2.0 / 989e12
    assert cell.reader('step_mfu.train')(obs) == pytest.approx(want)
    assert cell.reader('device_idle.train')(obs) == pytest.approx(75.0)
    assert cell.reader('peak_mem_gib.train')(
        dict(obs, window_peak_bytes=3 * 2 ** 30)) == 3.0
    assert cell.reader('step_mfu.train')(dict(obs, traced_s=None)) is None
    serve = tiny_cell('tiny_swinir.serve')
    sobs = _obs(serve, {}, traced_s=2.0, samples=4)
    s = serve.traffic['lr_side']
    assert serve.reader('step_mfu.serve')(sobs) == pytest.approx(
        100 * counts.forward_flops(serve.cfg, s, s) * 4 / 2.0 / 989e12)


def test_trace_reduction():
    ev = [dict(ph='X', cat='kernel', name='a', ts=10.0, dur=10.0),
          dict(ph='X', cat='kernel', name='b', ts=15.0, dur=10.0),
          dict(ph='X', cat='kernel', name='a', ts=40.0, dur=5.0),
          dict(ph='X', cat='user_annotation', name='bench.step', ts=0.0,
               dur=50.0),
          dict(ph='X', cat='cpu_op', name='aten::mul', ts=24.0, dur=10.0)]
    s = core.summarize_events(ev)
    assert s['busy_s'] == pytest.approx(20e-6)
    assert s['span_s'] == pytest.approx(50e-6)
    assert s['kernels']['a'] == (pytest.approx(15e-6), 2)
    gaps = dict((k, v) for k, v in s['idle_gaps'])
    assert gaps['bench.step / aten::mul'] == pytest.approx(15e-6)
    assert gaps['bench.step'] == pytest.approx(15e-6)
    assert s['device_ops'][0][0] == 'a'
