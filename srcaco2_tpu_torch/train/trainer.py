"""Training orchestration: train_valid and the test protocol (port of
srcaco2_tpu/train/trainer.py:Experiment).

The JAX package's loop and order of host actions: the step-0 bicubic
validation; chunks of up to train_steps_per_call steps that never cross
an epoch, eval, save, regularizer or end boundary; the weight
regularizers (orth, clip) after the steps they fall on; the skip /
corruption flags read in
one stacked transfer every failure_surface_lag steps and before each
eval and save; the epoch's losses read in one stacked transfer at its
end, then the ELB t update, test_epoch_freq and plot_epoch_freq; the
final save, validation, test on the best model plus the bicubic rows,
`passed.txt` and `LOG.txt`.

Random draws: each step's from a generator seeded from (myseed, step)
(and its hash rotations, NLSN's, from another),
each epoch's permutation from one seeded from (myseed, epoch)
(utils/reproducibility.py), so the superstep, one step per call and a
resumed run follow one trajectory on a device.

Besides the JAX package's files the run writes `run_stats.json`: the
kernel launches of training, validation and test (each wrapper's count,
read around those phases), for each window of steps between two flag
reads its host time and peak device memory, and the process's peak
device memory, allocated and reserved.

ROI / EDT patch sampling draws from the origin weight maps of the
staged train images (data/pipeline.py:OriginWeights), kept for the whole
stack while they take at most an eighth of the card's memory
(pipeline.cache_budget) and else computed for each step's batch; ppiw
builds its color table from the staged train HR stack.

Data parallelism (`distributed`, parallel/mesh.py): one process per
card, a data x model grid of the ranks; the train step takes each
rank's rows of the global batch and averages the grads over the ranks,
`fast_eval` shares the batches. The master alone writes the experiment
directory (checkpoints, best models, trackers, plots, `run_stats.json`,
`passed.txt`), each save followed by a barrier; every rank reads the
same files on resume. With a superstep (train_steps_per_call > 1) the
start-up probe times K against K=1 on the live state, restored after
it, and rank 0's choice holds on every rank (JAX's
`_probe_superstep`). On a cluster (SLURM_JOB_ID or CC_CLUSTER) with
`scratch_root`, the master mirrors the experiment directory there every
synch_scratch_epoch_freq epochs (utils/cluster.py).

The reconstruct task (JAX's trainer.py:112-127) trains at scale 1 on the
LR grid (data/dataset.py maps the pairs): the net's `<net>_upscale`,
where it has one, becomes 1 before it is built, so that the saved
config_model.yml rebuilds the scale-1 net; the pipeline takes scale 1
and h_size // scale patches, and the `_bicubic` rows the identity (the
unrestored input). As in JAX, the eval forward keeps the config's scale,
which only its test modes read, and the metrics' border stays the
config's scale (train/evaluator.py).
"""
import dataclasses
import json
import os
import time
from collections import Counter
from typing import Dict, List

import numpy as np
import torch

from srcaco2_tpu_torch import constants, exact_f32, resolve_device
from srcaco2_tpu_torch.config import yaml_io
from srcaco2_tpu_torch.config.net_defaults import safe_str_var
from srcaco2_tpu_torch.data import pipeline as P
from srcaco2_tpu_torch.data import sampling as SMP
from srcaco2_tpu_torch.data.dataset import SRDataset, load_dataset, SEP
from srcaco2_tpu_torch.losses.elb import update_t
from srcaco2_tpu_torch.losses.master import build_loss
from srcaco2_tpu_torch.models.registry import define_g
from srcaco2_tpu_torch.ops.launches import launch_counts
from srcaco2_tpu_torch.parallel import mesh
from srcaco2_tpu_torch.train import checkpoint as CKPT
from srcaco2_tpu_torch.train.evaluator import (fast_eval, log_perf,
                                               make_interpolate_forward)
from srcaco2_tpu_torch.train.regularizers import (regularizer_clip,
                                                  regularizer_orth)
from srcaco2_tpu_torch.train.schedule import build_optimizer
from srcaco2_tpu_torch.train.state import TrainState
from srcaco2_tpu_torch.train.steps import make_eval_forward, make_train_step
from srcaco2_tpu_torch.utils import reproducibility as R
from srcaco2_tpu_torch.utils import tracker as T
from srcaco2_tpu_torch.utils.cluster import is_cluster, sync_exp_to_durable
from srcaco2_tpu_torch.utils.logger import DLLogger, fmsg


def _freq_to_iters(v, steps_per_epoch: int) -> int:
    """int = iterations; float in ]0,1] = fraction of an epoch."""
    if isinstance(v, float) and 0 < v <= 1.0:
        return max(1, int(round(v * steps_per_epoch)))
    return int(v)


def choose_superstep(k: int, rate_k: float, rate_1: float,
                     margin: float = 1.05) -> int:
    """The superstep probe's rule (JAX's trainer.choose_superstep): keep
    the configured K unless one step per call (K=1) measures faster by
    more than the margin."""
    if rate_1 > margin * rate_k:
        return 1
    return k


def _summary_entry(perf: Dict) -> Dict:
    """One fast_eval perf dict as an evaluate_test summary row."""
    row = {'psnr': float(perf['full']['psnr']),
           'ssim': float(perf['full']['ssim']),
           'nrmse': float(perf['full']['nrmse']),
           'n': int(perf['n']), 'time': float(perf['time'])}
    if 'roi' in perf:
        row['roi_psnr'] = float(perf['roi']['psnr'])
        row['roi_ssim'] = float(perf['roi']['ssim'])
    return row


def _host_values(tensors: List[torch.Tensor]) -> np.ndarray:
    """Many device scalars / vectors in one device->host transfer."""
    if not tensors:
        return np.zeros((0,))
    return torch.cat([t.reshape(-1).float() for t in tensors]).cpu().numpy()


class Experiment:
    """Builds and holds all training components for one experiment."""

    def __init__(self, args: dict):
        self.args = args
        self.device = dev = resolve_device(args.get('device'))
        self.is_master = bool(args.get('is_master', True))
        self.grid = None
        if args.get('distributed', False):
            if not mesh.is_initialized():
                raise RuntimeError('distributed needs the process group '
                                   '(config/parser.py:_setup_process)')
            self.grid = mesh.make_mesh(args)
        self.exp_dir = args['abs_fd_exp'] or os.getcwd()
        nt = args['netG']['net_type']
        self.net_type = nt
        self.seed = int(args.get('myseed', 0))
        R.set_seed(self.seed)
        exact_f32(dev)

        # datasets ---------------------------------------------------
        tr_names = [s for s in str(args['train_dsets']).split(SEP) if s]
        train_sets: List[SRDataset] = [
            load_dataset(args, n, constants.TRAIN_PHASE,
                         frac=float(args.get('train_n', 1.0)))
            for n in tr_names]
        if not train_sets:
            raise ValueError('no train dataset')
        if len(train_sets) == 1:
            self.train_ds = train_sets[0]
        else:
            d0 = train_sets[0]
            self.train_ds = SRDataset(
                name=SEP.join(tr_names), phase=constants.TRAIN_PHASE,
                scale=d0.scale, n_channels=d0.n_channels,
                hr=np.concatenate([d.hr for d in train_sets]),
                lr=np.concatenate([d.lr for d in train_sets]),
                ids=sum([d.ids for d in train_sets], []),
                h_paths=sum([d.h_paths for d in train_sets], []),
                l_paths=sum([d.l_paths for d in train_sets], []),
                lr_is_real=d0.lr_is_real)
        self.train_ds.stage(dev)
        n_val = int(args.get('valid_n_samples', -1))
        self.valid_sets = [
            load_dataset(args, n, constants.EVAL_PHASE, n=n_val).stage(dev)
            for n in str(args['valid_dsets']).split(SEP) if n]
        self.test_sets = [
            load_dataset(args, n, constants.EVAL_PHASE)
            for n in str(args['test_dsets']).split(SEP) if n]

        # model + loss + optimizer ------------------------------------
        reconstruct = args.get('task') == constants.RECONSTRUCT
        if reconstruct and f'{safe_str_var(nt)}_upscale' in args['netG']:
            args['netG'][f'{safe_str_var(nt)}_upscale'] = 1
        self.model = define_g(args, dev, seed=self.seed)
        # the model's persistent buffers (ENLCN's fixed projections): not
        # trained, but saved and loaded with the parameters
        params = dict(self.model.named_parameters())
        self.buffers = {k: v for k, v in
                        self.model.state_dict(keep_vars=True).items()
                        if k not in params}
        self.master = build_loss(args)
        self.tx = build_optimizer(args['train'])
        self.pipe_cfg = P.from_args(args)
        if reconstruct:
            self.pipe_cfg = dataclasses.replace(
                self.pipe_cfg, scale=1,
                h_size=int(args['h_size']) // int(args['scale']))
        bs = int(args['batch_size'])
        self.batch_size = bs
        self.steps_per_epoch = max(1, len(self.train_ds) // bs)
        if self.grid is not None:
            dsize = self.grid.data
            if bs % dsize:
                raise ValueError(f'batch_size {bs} not divisible by the '
                                 f'data axis {dsize}')
            DLLogger.log(f'grid: {self.grid.shape} over '
                         f'{self.grid.world} processes')
            if int(args['eval_bsize']) % dsize:
                DLLogger.log(
                    f"[warn] eval_bsize {args['eval_bsize']} not divisible "
                    f"by the data axis {dsize} (the ranks share whole "
                    f"eval batches, so nothing changes)")

        pre = args['netG'].get('init_pretrained_path', '')
        if pre:
            template = {**dict(self.model.named_parameters()),
                        **self.buffers}
            load = CKPT.load_params \
                if bool(args['train'].get('G_param_strict', True)) \
                else CKPT.load_params_nonstrict
            with torch.no_grad():
                for k, v in load(pre, template).items():
                    template[k].copy_(v)
            DLLogger.log(f'loaded pretrained weights from {pre}')
        n_params = sum(p.numel() for p in self.model.parameters())
        DLLogger.log(f'netG {nt}: {n_params:,} params')

        e_decay = float(args['train'].get('E_decay', 0.0) or 0.0)
        self.e_decay = e_decay
        self.eval_netE = e_decay > 0 and bool(
            args['train'].get('eval_netE', False))
        self.state = TrainState.create(
            dict(self.model.named_parameters()), self.tx, e_decay,
            elb_init_t=float(args.get('elb_init_t', 1.0)))
        self.origins = None
        cfg = self.pipe_cfg
        if cfg.sample_tr_patch != constants.SAMPLE_UNIF:
            self._warn_edt_cap()
            hr_hw = self.train_ds.hr_dev.shape[1:3]
            cache = P.OriginWeights.nbytes(len(self.train_ds), hr_hw, cfg) \
                <= P.cache_budget(dev)
            self.origins = P.OriginWeights(self.train_ds.lr_dev, hr_hw, cfg,
                                           cache)
            DLLogger.log(f'{cfg.sample_tr_patch} patch sampling: origin '
                         f'weights {"kept" if cache else "per step"}')
        self.ppiw_table = None
        if args.get('ppiw', False):
            self.ppiw_table = torch.as_tensor(P.per_color_weights(
                self.train_ds.hr,
                float(args.get('ppiw_min_per_col_w', 0.001)))).to(dev)
        self.steps_per_call = max(
            1, int(args['train'].get('train_steps_per_call', 1) or 1))
        self.train_step = make_train_step(
            self.model, self.master, self.tx, nt, self.pipe_cfg,
            e_decay=e_decay, steps_per_epoch=self.steps_per_epoch,
            ppiw_table=self.ppiw_table, netG=args['netG'],
            steps_per_call=self.steps_per_call, grid=self.grid)
        # amp without amp_eval: evaluate an f32 twin of the same weights
        eval_model = self.model
        if args.get('amp', False) and not args.get('amp_eval', False):
            eval_model = define_g({**args, 'amp': False}, dev)
        self.eval_model = eval_model
        self.forward = make_eval_forward(
            eval_model, nt, int(args['scale']), netG=args['netG'],
            test_mode=int(args.get('test_mode', 0) or 0))
        self.interp_forward = make_interpolate_forward(
            int(self.pipe_cfg.scale),
            args.get('basic_interpolation', constants.INTER_BICUBIC))

        # tracker ------------------------------------------------------
        eval_names = [d.name for d in self.valid_sets] + \
            [d.name for d in self.test_sets] + \
            [d.name + '_bicubic' for d in self.test_sets]
        self.tracker = T.find_last_tracker(self.exp_dir) or \
            T.init_tracker(self.master.names, eval_names)
        self.roi_tracker = T.find_last_tracker(
            self.exp_dir, 'roi_tracker.pkl') or \
            T.init_tracker(self.master.names, eval_names)
        self.stats = {'device': str(dev),
                      'world_size': self.grid.world if self.grid else 1,
                      'launches': {}, 'train_steps': 0,
                      'model_forwards': Counter(), 'train_windows': []}

    # ------------------------------------------------------------ helpers
    def _warn_edt_cap(self):
        """Warn when the device EDT's chamfer cap (48) binds: the true
        interior depth of the first staged HR image's ROI, on the host
        (JAX's trainer.py:167-186)."""
        if self.pipe_cfg.sample_tr_patch not in (constants.SAMPLE_EDT,
                                                 constants.SAMPLE_EDTXROI):
            return
        hr0 = np.asarray(self.train_ds.hr[0])
        hr0 = hr0[..., 0] if hr0.ndim == 3 else hr0
        depth = float(SMP.edt_map(SMP.roi_mask(
            hr0, self.pipe_cfg.th_style, self.pipe_cfg.th_fix)).max())
        if depth > SMP.EDT_CAP:
            DLLogger.log(
                f'[warn] EDT sampling: true interior depth {depth:.0f}px '
                f'exceeds the device chamfer cap ({SMP.EDT_CAP}); '
                f'deepest-interior pixels share the max weight (sampling '
                f'slightly flattened there)')

    def eval_params(self):
        """Weights for validation / model selection / test: netE (EMA)
        with train.eval_netE and E_decay > 0, else netG; with the model's
        buffers."""
        if self.eval_netE and self.state.ema_params is not None:
            return {**self.state.ema_params, **self.buffers}
        return {**self.state.params, **self.buffers}

    def _counted(self, phase: str, fn, *a, **k):
        """fn(*a, **k), adding the kernel launches it makes to
        stats['launches'][phase]."""
        before = launch_counts()
        out = fn(*a, **k)
        after = launch_counts()
        acc = self.stats['launches'].setdefault(phase, Counter())
        acc.update({n: after[n] - before[n] for n in after})
        return out

    def _model_eval(self, phase: str, params, ds: SRDataset, **kw):
        """fast_eval of the model over `ds`, its launches and batches
        counted under `phase`."""
        bsz = int(self.args['eval_bsize'])
        self.stats['model_forwards'][phase] += -(-len(ds) // bsz)
        return self._counted(phase, fast_eval, self.forward, params, ds,
                             self.args, bsz, phase, grid=self.grid, **kw)

    def _barrier(self):
        """Every rank waits for the master's writes (no-op alone)."""
        if self.grid is not None:
            self.grid.barrier(self.device)

    def write_stats(self, outdir: str):
        if not self.is_master:
            return
        if self.device.type == 'cuda':
            # the process's peaks so far (training, validation and test)
            self.stats['max_memory_allocated'] = \
                torch.cuda.max_memory_allocated(self.device)
            self.stats['max_memory_reserved'] = \
                torch.cuda.max_memory_reserved(self.device)
        with open(os.path.join(outdir, 'run_stats.json'), 'w') as f:
            json.dump(self.stats, f, indent=1)

    def resume(self) -> int:
        self.state, step = CKPT.load_checkpoint(
            self.exp_dir, self.state, buffers=self.buffers,
            load_optimizer=bool(
                self.args['train'].get('G_optimizer_reuse', True)))
        if step:
            DLLogger.log(fmsg(f'Resumed from iteration {step}'))
        return step

    def _validate(self, step: int) -> None:
        args = self.args
        multi = len(self.valid_sets) > 1
        for ds in self.valid_sets:
            img_dir = os.path.join(self.exp_dir, args['save_dir_imgs'],
                                   constants.VALIDSET, ds.name)
            if self.is_master:
                os.makedirs(img_dir, exist_ok=True)
            perf = self._model_eval(constants.VALIDSET, self.eval_params(),
                                    ds, save_img_dir=img_dir,
                                    current_step=step,
                                    track_evolution_img=True)
            log_perf(f'valid/{ds.name}@{step}', perf)
            is_best = T.update_tracker_eval(
                self.tracker, constants.VALIDSET, ds.name, perf['full'],
                step, args['model_select_mtr'])
            if 'roi' in perf:
                roi_best = T.update_tracker_eval(
                    self.roi_tracker, constants.VALIDSET, ds.name,
                    perf['roi'], step, args['model_select_mtr'])
                if args.get('eval_over_roi_also_model_select', False):
                    is_best = roi_best
            if is_best and self.is_master:
                CKPT.save_best(self.exp_dir, self.eval_params(),
                               ds.name if multi else None)
                safe = ds.name.replace('/', '_')
                bd = os.path.join(self.exp_dir, 'best-models')
                yaml_io.dump(perf['details'],
                             os.path.join(bd, f'details_{safe}.yml'))
                summary = {'step': int(step), 'full': perf['full']}
                if 'roi' in perf:
                    summary['roi'] = perf['roi']
                yaml_io.dump(summary, os.path.join(bd, f'summary_{safe}.yaml'))
                DLLogger.log(f'[best] new best on {ds.name} @ {step}')
        self._barrier()       # the best models are on disk for every rank

    def evaluate_test(self, step: int, use_best: bool = True):
        """Test protocol: per test set, the best model (of the matching
        validation set with several), then the bicubic baseline under
        <ds>_bicubic. Returns {ds_name: {'psnr', 'ssim', ...}}."""
        args = self.args
        multi = len(self.valid_sets) > 1
        summary = {}
        for ds in self.test_sets:
            params = self.eval_params()
            if use_best:
                vds = ds.name.replace('test', 'val') if multi else None
                try:
                    params = CKPT.load_best(self.exp_dir, self.device, vds)
                except FileNotFoundError as e:
                    DLLogger.log(f'[test] no best model yet ({e}); using '
                                 f'the current weights')
            img_dir = os.path.join(self.exp_dir, args['save_dir_imgs'],
                                   constants.TESTSET, ds.name)
            if self.is_master:
                os.makedirs(img_dir, exist_ok=True)
            perf = self._model_eval(constants.TESTSET, params, ds,
                                    save_img_dir=img_dir,
                                    current_step=step)
            log_perf(f'test/{ds.name}@{step}', perf)
            summary[ds.name] = _summary_entry(perf)
            if self.is_master:
                dd = os.path.join(self.exp_dir, 'best-models')
                os.makedirs(dd, exist_ok=True)
                yaml_io.dump(perf['details'], os.path.join(
                    dd, f'details_test_{ds.name}.yml'.replace('/', '_')))
                if 'roi_details' in perf:
                    yaml_io.dump(perf['roi_details'], os.path.join(
                        dd, f'details_test_roi_{ds.name}.yml'
                        .replace('/', '_')))
            T.update_tracker_eval(self.tracker, constants.TESTSET,
                                  ds.name, perf['full'], step,
                                  args['model_select_mtr'])
            if 'roi' in perf:
                T.update_tracker_eval(self.roi_tracker, constants.TESTSET,
                                      ds.name, perf['roi'], step,
                                      args['model_select_mtr'])
            bperf = self._counted(constants.TESTSET, fast_eval,
                                  self.interp_forward, None, ds, args,
                                  int(args['eval_bsize']), constants.TESTSET,
                                  grid=self.grid)
            log_perf(f'test/{ds.name}_bicubic@{step}', bperf)
            summary[ds.name + '_bicubic'] = _summary_entry(bperf)
            T.update_tracker_eval(self.tracker, constants.TESTSET,
                                  ds.name + '_bicubic', bperf['full'],
                                  step, args['model_select_mtr'])
            if 'roi' in bperf:
                T.update_tracker_eval(self.roi_tracker, constants.TESTSET,
                                      ds.name + '_bicubic', bperf['roi'],
                                      step, args['model_select_mtr'])
        return summary

    def _save(self) -> None:
        if self.is_master:
            CKPT.save_checkpoint(self.exp_dir, self.state, self.buffers)
            CKPT.gc_checkpoints(self.exp_dir, int(self.state.step))
        self._barrier()

    def _save_trackers(self) -> None:
        if self.is_master:
            T.save_tracker(self.tracker, self.exp_dir)
            T.save_tracker(self.roi_tracker, self.exp_dir,
                           'roi_tracker.pkl')

    # ------------------------------------------------------ superstep probe
    def _snapshot(self) -> dict:
        """Copies of everything a train step changes: the parameters, the
        optimizer state, the EMA, step, elb_t and the model's buffers
        (BatchNorm statistics, ENLCN's projections)."""
        st = self.state

        def clone(tree):
            if isinstance(tree, dict):
                return {k: clone(v) for k, v in tree.items()}
            return tree.detach().clone() if torch.is_tensor(tree) else tree
        return dict(params=clone(st.params), opt_state=clone(st.opt_state),
                    ema=clone(st.ema_params), step=clone(st.step),
                    elb_t=clone(st.elb_t), buffers=clone(self.buffers))

    def _restore(self, snap: dict) -> None:
        st = self.state
        CKPT.copy_into(st.params, snap['params'])
        CKPT.copy_into(self.buffers, snap['buffers'])
        if st.ema_params is not None:
            CKPT.copy_into(st.ema_params, snap['ema'])
        st.opt_state = snap['opt_state']
        st.step, st.elb_t = snap['step'], snap['elb_t']

    def _probe_superstep(self, hr_dev, lr_dev, n_train: int) -> None:
        """Time K = train_steps_per_call against K=1 on the staged data
        and keep the faster (choose_superstep's hysteresis toward K), as
        JAX does under a mesh. The steps run on the live state and
        everything they change is restored after them, so training with
        the probe equals training without it bit for bit. Rank 0's
        choice holds on every rank (the timings differ between ranks)."""
        args = self.args
        k, bs, dev = self.steps_per_call, self.batch_size, self.device
        hr_hw = tuple(hr_dev.shape[1:3])
        fn1 = make_train_step(
            self.model, self.master, self.tx, self.net_type, self.pipe_cfg,
            e_decay=self.e_decay, steps_per_epoch=self.steps_per_epoch,
            ppiw_table=self.ppiw_table, netG=args['netG'],
            steps_per_call=1, grid=self.grid)

        def sync():
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)

        def rate(fn, kk, calls):
            idxs = (torch.arange(kk * bs, device=dev) % n_train).reshape(
                kk, bs)
            draws = [P.draw(
                R.step_generator(self.seed, j, dev), bs, self.pipe_cfg,
                hr_hw, None if self.origins is None
                else self.origins.of(idxs[j]))._replace(
                    lsh=R.lsh_generator(self.seed, j)) for j in range(kk)]
            args_ = (idxs, draws) if kk > 1 else (idxs[0], draws[0])
            fn(self.state, hr_dev, lr_dev, *args_)           # warm-up
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(self.state, hr_dev, lr_dev, *args_)
            sync()
            return calls * kk * bs / (time.perf_counter() - t0)

        snap = self._snapshot()
        try:
            calls_k = 3
            rate_k = rate(self.train_step, k, calls_k)
            rate_1 = rate(fn1, 1, calls_k * k)
        finally:
            self._restore(snap)
        chosen = self.grid.broadcast_int(choose_superstep(k, rate_k, rate_1),
                                         dev)
        DLLogger.log(f'superstep probe (grid {self.grid.shape}): K={k} '
                     f'{rate_k:.1f} patches/s vs K=1 {rate_1:.1f} '
                     f'patches/s -> K={chosen}')
        if chosen == 1:
            self.steps_per_call = 1
            self.train_step = fn1

    # ------------------------------------------------------------- train
    def train_valid(self):
        args = self.args
        t_start = time.perf_counter()
        start_step = self.resume()
        spe = self.steps_per_epoch
        max_epochs = int(args['max_epochs'])
        total_steps = max_epochs * spe
        n_check_eval = _freq_to_iters(args['train']['checkpoint_eval'], spe)
        n_check_save = _freq_to_iters(args['train']['checkpoint_save'], spe)
        test_epoch_freq = int(args['train'].get('test_epoch_freq', 0))
        plot_epoch_freq = int(args['train'].get('plot_epoch_freq', 0))

        if start_step == 0:
            DLLogger.log(fmsg('step-0 bicubic-baseline validation'))
            for ds in self.valid_sets:
                perf = fast_eval(self.interp_forward, None, ds, args,
                                 int(args['eval_bsize']), constants.VALIDSET,
                                 grid=self.grid)
                log_perf(f'valid/{ds.name}_bicubic@0', perf)

        hr_dev, lr_dev = self.train_ds.hr_dev, self.train_ds.lr_dev
        hr_hw = tuple(hr_dev.shape[1:3])
        n_train = len(self.train_ds)
        bs = self.batch_size
        step = start_step
        epoch_losses: Dict[str, list] = {}
        last_epoch = step // spe
        # JAX's condition, with distributed in place of its mesh
        if (self.grid is not None and self.steps_per_call > 1
                and bool(args['train'].get('train_superstep_probe', True))
                and spe >= self.steps_per_call
                and total_steps - start_step >= 50 * self.steps_per_call):
            self._probe_superstep(hr_dev, lr_dev, n_train)
        sync_freq = int(args['train'].get('synch_scratch_epoch_freq', 0)
                        or 0)
        DLLogger.log(fmsg(
            f'training {self.net_type}: {n_train} samples, '
            f'{spe} steps/epoch, {max_epochs} epochs'))

        # per-step failure flags (device tensors), read in ONE stacked
        # transfer every `failure_surface_lag` steps and before every
        # eval and save: a blocking read per step serializes the card.
        flag_lag = max(1, int(args['train'].get(
            'failure_surface_lag', 32) or 1))
        pending = []        # [(first step, flags (k,) or scalar)]
        window = {}         # the steps since the last flag read

        def drain_flags():
            if not pending:
                return
            entries = list(pending)
            pending.clear()
            vals = _host_values([d for _, d in entries]).astype(np.int64)
            if window:
                rec = dict(first_step=window['first'],
                           steps=step - window['first'],
                           seconds=time.perf_counter() - window['t0'])
                if self.device.type == 'cuda':
                    rec['max_memory_allocated'] = \
                        torch.cuda.max_memory_allocated(self.device)
                self.stats['train_windows'].append(rec)
                window.clear()
            off = 0
            for s0, d in entries:
                for j in range(d.numel()):
                    v = vals[off + j]
                    if v & 1:
                        DLLogger.log(f'[warn] step {s0 + j}: non-finite '
                                     f'loss/grads — update skipped')
                    if v & 2:
                        raise RuntimeError(
                            f'step {s0 + j}: corrupted parameters or '
                            f'predictions (non-finite) — stopping')
                off += d.numel()

        spc = self.steps_per_call
        state = self.state
        # periodic weight regularizers (model_plain.py:365-387)
        orthstep = int(args['train'].get('G_regularizer_orthstep', 0) or 0)
        clipstep = int(args['train'].get('G_regularizer_clipstep', 0) or 0)
        while step < total_steps:
            epoch = step // spe
            if step == start_step or step % spe == 0:
                perm = R.epoch_indices(self.seed, n_train, epoch,
                                       self.device)
            i_in_epoch = step % spe
            # chunk: up to steps_per_call steps, never crossing an epoch,
            # eval, save, regularizer or end boundary
            k = min(spc, spe - i_in_epoch, total_steps - step)
            for per in (n_check_eval, n_check_save, orthstep, clipstep):
                if per:
                    k = min(k, per - step % per)
            idxs = perm[i_in_epoch * bs:(i_in_epoch + k) * bs].reshape(k, bs)
            draws = []
            for j in range(k):
                weights = None if self.origins is None \
                    else self.origins.of(idxs[j])
                draws.append(P.draw(
                    R.step_generator(self.seed, step + j, self.device), bs,
                    self.pipe_cfg, hr_hw, weights)._replace(
                        lsh=R.lsh_generator(self.seed, step + j)))
            if not window:
                window.update(first=step, t0=time.perf_counter())
                if self.device.type == 'cuda':
                    torch.cuda.reset_peak_memory_stats(self.device)
            if spc > 1:
                state, holder, _ = self._counted(
                    'train', self.train_step, state, hr_dev, lr_dev, idxs,
                    draws)
            else:
                state, holder, _ = self._counted(
                    'train', self.train_step, state, hr_dev, lr_dev, idxs[0],
                    draws[0])
            step += k
            self.stats['train_steps'] += k

            pending.append((step - k, holder['_flags']))
            if sum(d.numel() for _, d in pending) >= flag_lag:
                drain_flags()
            if orthstep > 0 and step % orthstep == 0:
                regularizer_orth(self.model)
            if clipstep > 0 and step % clipstep == 0:
                regularizer_clip(state.params)
            for name, v in holder.items():
                if not name.startswith('_'):
                    epoch_losses.setdefault(name, []).append(v)

            if step % n_check_eval == 0:
                drain_flags()          # surface failures before eval
                self.state = state
                self._validate(step)
            if step % n_check_save == 0:
                drain_flags()          # never checkpoint a corrupt state
                self.state = state
                self._save()
                self._save_trackers()

            new_epoch = step // spe
            if new_epoch != last_epoch:
                # epoch boundary: the epoch's losses in one transfer
                names = list(epoch_losses)
                vals = _host_values([v for n in names
                                     for v in epoch_losses[n]])
                per_iter, off = {}, 0
                for n in names:
                    cnt = sum(v.numel() for v in epoch_losses[n])
                    per_iter[n] = [float(v) for v in vals[off:off + cnt]]
                    off += cnt
                for n, vs in per_iter.items():
                    self.tracker['train'][T.PERIOD_ITER].setdefault(
                        n, []).extend(vs)
                agg = {n: float(np.mean(vs)) for n, vs in per_iter.items()}
                T.update_tracker_train(self.tracker, T.PERIOD_EPOCH, agg)
                loss_line = ' '.join(f'{n}={v:.6f}' for n, v in agg.items())
                DLLogger.log(f'[epoch {last_epoch}] {loss_line} '
                             f'({time.perf_counter() - t_start:.1f}s '
                             f'elapsed)')
                epoch_losses = {}
                state.elb_t = update_t(state.elb_t, self.master.elb_mulcoef,
                                       self.master.elb_max_t)
                if test_epoch_freq and new_epoch % test_epoch_freq == 0:
                    self.state = state
                    self.evaluate_test(step)
                if plot_epoch_freq and new_epoch % plot_epoch_freq == 0 \
                        and self.is_master:
                    T.plot_tracker(self.tracker, self.exp_dir)
                # the preemptible cluster's mirror (the master writes the
                # experiment directory, so it alone mirrors it)
                if sync_freq and new_epoch % sync_freq == 0 \
                        and self.is_master and is_cluster() \
                        and args.get('scratch_root'):
                    sync_exp_to_durable(self.exp_dir, args['scratch_root'])
                last_epoch = new_epoch

        drain_flags()

        # final: save, validate, test, plots ---------------------------
        self.state = state
        self._save()
        self._validate(step)
        fast_sweep = os.environ.get('SRCACO2_FAST_SWEEP') == '1'
        if not fast_sweep:
            self.evaluate_test(step, use_best=True)
        self._save_trackers()
        if not fast_sweep and self.is_master:
            T.plot_tracker(self.tracker, self.exp_dir)
            if args.get('eval_over_roi_also', False):
                T.plot_tracker(self.roi_tracker, self.exp_dir,
                               prefix='roi_tracker')
            for split in (constants.VALIDSET, constants.TESTSET):
                T.plot_tracker_dashboard(
                    self.tracker, self.roi_tracker, split,
                    os.path.join(self.exp_dir, f'dashboard_{split}.png'),
                    roi_select=bool(args.get(
                        'eval_over_roi_also_model_select', False)))
        self.write_stats(self.exp_dir)
        total_t = time.perf_counter() - t_start
        if self.is_master:
            with open(os.path.join(self.exp_dir, 'passed.txt'), 'w') as f:
                f.write(f'done in {total_t:.1f}s\n')
            with open(os.path.join(self.exp_dir, 'LOG.txt'), 'a') as f:
                f.write(f'{self.net_type} x{args["scale"]} '
                        f'steps={step} time={total_t:.1f}s\n')
        DLLogger.log(fmsg(f'training done in {total_t:.1f}s'))
