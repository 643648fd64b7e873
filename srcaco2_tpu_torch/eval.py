"""Re-score a trained experiment directory (port of the JAX package's
eval.py): re-hydrate config_model.yml, load best-models/G-model.pt, run
the test protocol (the bicubic baseline included), save the trackers
and the run's kernel launches under <exp>/eval_test_<split>/.

    python -m srcaco2_tpu_torch.eval --exp_path <exp dir> [--split test]
        [--eval_over_roi_also True|False] [--device cpu]

It runs on the card unless --device cpu is given.
"""
import argparse
import os

from srcaco2_tpu_torch import constants, resolve_device
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.train import checkpoint as CKPT
from srcaco2_tpu_torch.train.trainer import Experiment
from srcaco2_tpu_torch.utils import tracker as T
from srcaco2_tpu_torch.utils.logger import DLLogger, fmsg


def evaluate_pretrained(exp_path: str, split: str = constants.TESTSET,
                        over_roi: bool = None, device=None):
    """The test protocol over the experiment's best model; returns the
    summary {ds_name: {'psnr', 'ssim', ...}} (bicubic rows included)."""
    cfg_path = os.path.join(exp_path, 'config_model.yml')
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(cfg_path)
    args = yaml_io.load(cfg_path)
    args['is_train'] = False
    args['distributed'] = False
    args['abs_fd_exp'] = os.path.abspath(exp_path)
    args['device'] = str(resolve_device(device))
    if over_roi is not None:
        # re-score a finished experiment over ROI even if it trained
        # with the ROI pass off
        args['eval_over_roi_also'] = bool(over_roi)

    outd = os.path.join(exp_path, f'eval_test_{split}')
    os.makedirs(outd, exist_ok=True)
    DLLogger.init(outdir=outd, is_master=True,
                  verbose=args.get('verbose', True))
    DLLogger.log(fmsg(f"eval {args['method']} x{args['scale']} "
                      f"({exp_path})"))
    exp = Experiment(args)
    CKPT.copy_into({**exp.state.params, **exp.buffers},
                   CKPT.load_best(exp_path, exp.device))
    summary = exp.evaluate_test(step=0, use_best=True)
    T.save_tracker(exp.tracker, outd)
    T.save_tracker(exp.roi_tracker, outd, 'roi_tracker.pkl')
    T.plot_tracker(exp.tracker, outd)
    exp.write_stats(outd)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(prog='srcaco2_tpu_torch.eval')
    p.add_argument('--exp_path', required=True)
    p.add_argument('--split', default=constants.TESTSET)
    p.add_argument('--eval_over_roi_also', default=None,
                   help='True/False: override the saved config (re-score '
                        'a finished experiment over ROI)')
    p.add_argument('--device', default=None,
                   help="'cpu' to run on the CPU (default: the card)")
    ns = p.parse_args(argv)
    over_roi = None
    if ns.eval_over_roi_also is not None:
        over_roi = str(ns.eval_over_roi_also).lower() in ('1', 'true', 'yes')
    evaluate_pretrained(ns.exp_path, ns.split, over_roi, ns.device)


if __name__ == '__main__':
    main()
