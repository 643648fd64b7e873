"""The cluster scratch sync (srcaco2_tpu_torch/utils/cluster.py) against
the JAX package's (srcaco2_tpu/utils/cluster.py): with SLURM_JOB_ID set,
a `scratch_root` and synch_scratch_epoch_freq 1, the port's run mirrors
its experiment directory to <scratch_root>/<exp name> at every epoch
boundary, and every mirror holds the same relative file set as JAX's
sync_exp_to_durable makes of that directory at that moment; on the
copytree path, and on the rsync path (the installed rsync, or where
there is none a stand-in on PATH that does what `rsync -a [--delete]
SRC DST` does for these trees). The node staging copies alike."""
import os
import shutil
import stat
import sys

import pytest
import torch

from srcaco2_tpu.utils import cluster as JCL
from srcaco2_tpu_torch import main as TMAIN
from srcaco2_tpu_torch.train import trainer as TT
from srcaco2_tpu_torch.utils import cluster as TCL
from srcaco2_tpu_torch.utils.logger import DLLogger

from test_torch_ddp_entry import _argv, _exp, synth  # noqa: F401

RSYNC_STANDIN = '''#!{python}
"""rsync -a [--delete] SRC DST for directory trees: SRC/ mirrors the
contents of SRC into DST, SRC without a slash copies SRC into DST."""
import os, shutil, sys
args = [a for a in sys.argv[1:] if not a.startswith('-')]
delete = '--delete' in sys.argv
src, dst = args
if not src.endswith('/'):
    dst = os.path.join(dst, os.path.basename(src))
if delete and os.path.isdir(dst):
    shutil.rmtree(dst)
shutil.copytree(src, dst, dirs_exist_ok=True)
'''


def _files(root):
    out = set()
    for d, _, fs in os.walk(root):
        for f in fs:
            out.add(os.path.relpath(os.path.join(d, f), root))
    return out


@pytest.fixture(params=['copytree', 'rsync'])
def sync_path(request, tmp_path, monkeypatch):
    """Which copy the syncs take: no rsync on PATH, or one (the
    installed rsync, else the stand-in)."""
    bin_dir = tmp_path / 'bin'
    bin_dir.mkdir()
    real = shutil.which('rsync')
    if request.param == 'rsync' and not real:
        exe = bin_dir / 'rsync'
        exe.write_text(RSYNC_STANDIN.format(python=sys.executable))
        exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    elif request.param == 'rsync':
        os.symlink(real, bin_dir / 'rsync')
    monkeypatch.setenv('PATH', str(bin_dir) if request.param == 'copytree'
                       else f'{bin_dir}{os.pathsep}{os.environ["PATH"]}')
    assert bool(shutil.which('rsync')) == (request.param == 'rsync')
    return request.param


def test_run_mirrors_the_experiment_as_jax_would(synth, tmp_path, sync_path,
                                                 monkeypatch):
    root, names = synth
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')   # skip the final tests
    monkeypatch.setenv('SLURM_JOB_ID', '4242')
    durable, jax_root = tmp_path / 'durable', tmp_path / 'jax'
    mirrors = []
    port_sync = TT.sync_exp_to_durable

    def both(exp_dir, dst_root):
        port_sync(exp_dir, dst_root)
        JCL.sync_exp_to_durable(exp_dir, str(jax_root))
        name = os.path.basename(exp_dir)
        mirrors.append((_files(os.path.join(dst_root, name)),
                        _files(os.path.join(str(jax_root), name)),
                        _files(exp_dir)))
    monkeypatch.setattr(TT, 'sync_exp_to_durable', both)
    cwd = tmp_path / 'cwd'
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    torch.set_num_threads(2)
    try:
        TMAIN.main(_argv(root, names, scratch_root=str(durable),
                         synch_scratch_epoch_freq=1, swinir=False))
    finally:
        DLLogger.reset()
    exp = _exp(str(cwd))
    assert len(mirrors) == 2                 # 2 epochs, one sync each
    for port, jax_, live in mirrors:
        assert port == jax_ == live
        assert any(f.startswith('models/') for f in port)
    # the last sync saw the second epoch's checkpoint
    assert 'models/4_G.pt' in mirrors[-1][0]
    assert os.path.isdir(durable / os.path.basename(exp))


@pytest.mark.parametrize('cluster', [False, True])
def test_no_sync_off_a_cluster_or_without_scratch_root(synth, tmp_path,
                                                       monkeypatch, cluster):
    """Off a cluster with a scratch_root, or on one without: no sync."""
    root, names = synth
    monkeypatch.setenv('SRCACO2_FAST_SWEEP', '1')   # skip the final tests
    calls = []
    monkeypatch.setattr(TT, 'sync_exp_to_durable',
                        lambda *a: calls.append(a))
    monkeypatch.delenv('CC_CLUSTER', raising=False)
    if cluster:
        monkeypatch.setenv('SLURM_JOB_ID', '1')
    else:
        monkeypatch.delenv('SLURM_JOB_ID', raising=False)
    extra = {} if cluster else dict(scratch_root=str(tmp_path / 'd'))
    monkeypatch.chdir(tmp_path)
    try:
        TMAIN.main(_argv(root, names, synch_scratch_epoch_freq=1,
                         swinir=False, max_epochs=1, **extra))
    finally:
        DLLogger.reset()
    assert calls == []


def test_node_staging_copies_as_jax_does(tmp_path, sync_path, monkeypatch):
    src = tmp_path / 'data'
    (src / 'caco2' / 'sub').mkdir(parents=True)
    (src / 'caco2' / 'a.tif').write_bytes(b'a')
    (src / 'caco2' / 'sub' / 'b.tif').write_bytes(b'b')
    monkeypatch.setenv('SLURM_JOB_ID', '7')
    monkeypatch.setenv('SLURM_LOCALID', '0')
    out = {}
    for name, mod in (('port', TCL), ('jax', JCL)):
        monkeypatch.setenv('SLURM_TMPDIR', str(tmp_path / name))
        dst = mod.stage_dataset_to_node(str(src))
        out[name] = (os.path.relpath(dst, tmp_path / name), _files(dst))
    assert out['port'] == out['jax']
    assert out['port'][1] == {'caco2/a.tif', 'caco2/sub/b.tif'}
    monkeypatch.delenv('SLURM_JOB_ID')
    assert TCL.stage_dataset_to_node(str(src)) == str(src)
