"""Train, validate and test one experiment (port of the JAX package's
main.py): parse -> experiment directory -> Experiment.train_valid ->
config_final.yml and config_model.yml (which `eval` and
inference/super_res.load_exp read back).

    python -m srcaco2_tpu_torch.main --net_type SwinIR --scale 8 ...
        [--device cpu]

The flags are the JAX package's (config/parser.py). It runs on the card
unless --device cpu is given; with no card visible it raises.

On several cards, one process per card under torchrun, over NCCL:

    python -m torch.distributed.run --nproc_per_node N \
        -m srcaco2_tpu_torch.main --distributed True ...

(under SLURM without torchrun, SLURM_PROCID, SLURM_NTASKS and
SLURM_LOCALID stand in for RANK, WORLD_SIZE and LOCAL_RANK, with
--init_method tcp://host:port or MASTER_ADDR / MASTER_PORT).
"""
import os

from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.config.parser import parse_input
from srcaco2_tpu_torch.parallel import mesh
from srcaco2_tpu_torch.train.trainer import Experiment
from srcaco2_tpu_torch.utils.logger import DLLogger, fmsg


def main(argv=None):
    args = parse_input(argv)
    DLLogger.log(fmsg(f"{args['method']} x{args['scale']} -> "
                      f"{args['fd_exp']}"))
    exp = Experiment(args)
    exp.train_valid()
    if args['is_master']:
        for name in ('config_final.yml', 'config_model.yml'):
            yaml_io.dump(args, os.path.join(args['abs_fd_exp'], name))
    if mesh.is_initialized():
        mesh.destroy_process_group(exp.device)


if __name__ == '__main__':
    main()
