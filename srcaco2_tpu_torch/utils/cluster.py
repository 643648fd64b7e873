"""Cluster and preemption support (port of srcaco2_tpu/utils/cluster.py).

On a managed cluster (CC_CLUSTER or SLURM_JOB_ID set) the datasets can
be copied once per node to node-local scratch, and the experiment
directory is mirrored to durable storage (`scratch_root`) every
`synch_scratch_epoch_freq` epochs (train/trainer.py). rsync where it is
installed, shutil.copytree otherwise. The trainer calls the mirror from
the master only, the one process that writes the experiment directory.
"""
import os
import shutil
import subprocess

from srcaco2_tpu_torch.utils.logger import DLLogger


def is_cluster() -> bool:
    """On a managed cluster (CC_CLUSTER or SLURM_JOB_ID set)."""
    return bool(os.environ.get('CC_CLUSTER')
                or os.environ.get('SLURM_JOB_ID'))


def node_scratch_dir() -> str:
    return os.environ.get('SLURM_TMPDIR', '/tmp')


def is_node_master() -> bool:
    return int(os.environ.get('SLURM_LOCALID', 0)) == 0


def stage_dataset_to_node(src_root: str, subdirs=('caco2',)) -> str:
    """Copy the dataset to node-local scratch once per node; the new
    data_root (src_root off a cluster)."""
    if not is_cluster():
        return src_root
    dst_root = os.path.join(node_scratch_dir(), 'srcaco2_data')
    if is_node_master():
        for sd in subdirs:
            src = os.path.join(src_root, sd)
            dst = os.path.join(dst_root, sd)
            if os.path.isdir(src) and not os.path.isdir(dst):
                DLLogger.log(f'[cluster] staging {src} -> {dst}')
                if shutil.which('rsync'):
                    os.makedirs(dst_root, exist_ok=True)
                    subprocess.run(['rsync', '-a', src, dst_root],
                                   check=True)
                else:
                    shutil.copytree(src, dst)
    return dst_root


def sync_exp_to_durable(exp_dir: str, durable_root: str):
    """Mirror the experiment directory to
    <durable_root>/<its base name>, deleting what it no longer holds."""
    if not durable_root:
        return
    dst = os.path.join(durable_root, os.path.basename(exp_dir.rstrip('/')))
    if shutil.which('rsync'):
        subprocess.run(['rsync', '-a', '--delete', exp_dir + '/', dst],
                       check=True)
    else:
        if os.path.isdir(dst):
            shutil.rmtree(dst)
        shutil.copytree(exp_dir, dst)
    DLLogger.log(f'[cluster] synced {exp_dir} -> {dst}')
