"""Default configuration (port of srcaco2_tpu/config/defaults.py:
get_config), with the same keys and values and one of the port's own:
`device`. Three stages as in the JAX package: this dict -> per-network
defaults (`init_net_g`) -> the command line (config/parser.py).
"""
from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.config.net_defaults import init_net_g

# reconstruction-task names (the task itself is not ported)
LOW_RES = 'low_res'
RECON_IN_FAKE = 'fake'


def get_config(net_type: str = constants.SWINIR) -> dict:
    args = {
        # ------------------------------------------------------ general
        "task": constants.SUPER_RES,
        "reconstruct_type": LOW_RES,
        "reconstruct_input": RECON_IN_FAKE,
        "is_train": True,
        "myseed": 0,
        "n_channels": 3,
        "debug_subfolder": '',
        "train_dsets": '',
        "valid_dsets": '',
        "test_dsets": '',
        "multi_valid": False,
        "valid_n_samples": -1,
        "h_size": 96,          # HR crop size; LR crop = h_size // scale.
        "scale": 2,
        "train_n": 1.,
        "color_min": 0,
        "color_max": 255,
        "batch_size": 8,
        "eval_bsize": 8,
        "num_workers": 4,      # image-decoding threads.
        "exp_id": "123456789",
        "verbose": True,
        "fd_exp": None,
        "abs_fd_exp": None,
        "t0": None,
        "tend": None,
        "running_time": None,
        "save_dir_models": 'models',
        "save_dir_imgs": 'images',
        "data_root": '',
        "splits_root": '',
        "scratch_root": '',   # durable mirror target on preemptible
                              # clusters (reference: CC $SCRATCH sync).
        "model_select_mtr": constants.PSNR_MTR,
        "basic_interpolation": constants.INTER_BICUBIC,
        "use_interpolated_low": False,
        "inter_low_th": 7.,
        "inter_low_sigma": 6.,
        "method": constants.NETTYPE_METHOD[net_type],
        "netG": {
            "net_task": constants.REGRESSION,
            "net_type": net_type,
            "init_pretrained_path": '',
            "checkpoint_path_netG": '',
            "checkpoint_path_optimizerG": '',
            "checkpoint_path_netE": '',
        },
        "train": {
            "E_decay": 0.0,                  # EMA decay; 0 disables netE.
            # Evaluate/select/test on netE (the EMA weights) instead of
            # netG when E_decay > 0. Beyond-reference: the reference
            # maintains + checkpoints netE (model_base.py:214) but its
            # test() always runs netG (model_plain.py:398); this flag
            # opts validation/model-selection/test onto the smoothed
            # weights (standard EMA practice the machinery exists for).
            "eval_netE": False,
            "G_optimizer_type": constants.ADAM,
            "G_optimizer_lr": 2e-4,
            "G_optimizer_wd": 1e-4,
            "G_optimizer_clipgrad": 0.0,
            "G_optimizer_reuse": True,
            "G_optimizer_momentum": 0.9,
            "G_optimizer_nesterov": True,
            "G_optimizer_beta1": 0.9,
            "G_optimizer_beta2": 0.999,
            "G_optimizer_eps_adam": 1e-08,
            "G_optimizer_amsgrad": False,
            "G_scheduler_type": constants.MULTISTEPLR,
            "G_scheduler_milestones": [500000000, 900000000],
            "G_scheduler_step_size": 3,      # MyStepLR only; ticks on iters.
            "G_scheduler_gamma": 0.5,
            "G_scheduler_min_lr": 1e-4,      # MyStepLR floor.
            "G_scheduler_warmup": 0,         # linear warmup iters (0 off).
            "G_regularizer_orthstep": 0.0,
            "G_regularizer_clipstep": 0.0,
            "G_param_strict": True,
            "E_param_strict": True,
            "checkpoint_eval": 5000,         # iters, or float in ]0,1] of
            "checkpoint_save": 5000,         # an epoch.
            "test_epoch_freq": 50,
            "plot_epoch_freq": 5,
            "synch_scratch_epoch_freq": 50,
            # per-step skip / corruption flags are read from the device
            # in ONE stacked transfer every N steps (and before every
            # eval and save) instead of one blocking read per step; a
            # per-step read serializes the card. 1 = per-step surfacing.
            "failure_surface_lag": 32,
            # superstep: K optimizer updates per call with no host read
            # between them (train/steps.py); the trainer chunks so eval,
            # save and epoch boundaries never fall inside a call.
            "train_steps_per_call": 8,
            # with --distributed True, time K against K=1 at start-up on
            # copies of the state and keep K unless K=1 is faster by
            # more than 5% (train/trainer.py:_probe_superstep), as JAX
            # does under a mesh.
            "train_superstep_probe": True,
        },
        # --------------------------------------------------- evaluation
        "test_mode": 0,       # tiled/ensembled inference: 0 normal,
                              # 1 pad, 2 split, 3 x8 TTA, 4 split+x8
                              # (train/test_modes.py).
        "eval_over_roi_also": False,
        "eval_over_roi_also_ths": constants.ROI_THRESH,
        "eval_over_roi_also_model_select": False,
        # ---------------------------------------- local data augmentation
        "da_blur": False,
        "da_blur_prob": 0.5,
        "da_blur_area": 0.3,
        "da_blur_sigma": 1.,
        "da_dot_bin_noise": False,
        "da_dot_bin_noise_prob": 0.5,
        "da_dot_bin_noise_area": 0.3,
        "da_dot_bin_noise_p": 0.5,
        "da_add_gaus_noise": False,
        "da_add_gaus_noise_prob": 0.5,
        "da_add_gaus_noise_area": 0.3,
        "da_add_gaus_noise_std": 0.03,
        # -------------------------------------------------- weight sparsity
        "w_sparsity": False,
        "w_sparsity_lambda": 1.,
        # ------------------------------------------------------------- ELB
        "elb_init_t": 1.,
        "elb_max_t": 10.,
        "elb_mulcoef": 1.01,
        # --------------------------------------------------------- training
        "max_epochs": 1000000,
        "ppiw": False,
        "ppiw_min_per_col_w": 0.001,
        "augment": False,
        "augment_nbr_steps": 2,
        "augment_use_roi": False,
        "sample_tr_patch": constants.SAMPLE_UNIF,
        "sample_tr_patch_th_style": constants.TH_AUTO,
        "sample_tr_patch_th": constants.TH_AUTO,
        # False = reference-exact paired crop (HR origin on the HR
        # grid, LR origin = origin // scale: pairs misaligned by up to
        # scale-1 HR px — dataset_dpsr.py:866-877). True snaps origins
        # to the LR grid (exact alignment; beyond-reference option,
        # see data/pipeline.PipeConfig and docs/QUALITY.md).
        "train_aligned_crops": False,
        # ----------------------------------------------------------- losses
        "l1": False, "l1_use_residuals": False, "l1_lambda": 1.,
        "l2": False, "l2_use_residuals": False, "l2_lambda": 1.,
        "l2sum": False, "l2sum_use_residuals": False, "l2sum_lambda": 1.,
        "ssim": False, "ssim_lambda": 1., "ssim_window_s": 11,
        "charbonnier": False, "charbonnier_use_residuals": False,
        "charbonnier_lambda": 1., "charbonnier_eps": 1e-9,
        "boundpred": False, "boundpred_use_residuals": False,
        "boundpred_lambda": 1., "boundpred_eps": 1.,
        "boundpred_restore_range": True,
        "local_moments": False, "local_moments_use_residuals": False,
        "local_moments_lambda": 1., "local_moments_ksz": '3',
        "img_grad": False, "img_grad_use_residuals": False,
        "img_grad_lambda": 1., "img_grad_norm": constants.NORM2,
        "norm_img_grad": False, "norm_img_grad_use_residuals": False,
        "norm_img_grad_lambda": 1., "norm_img_grad_type": constants.NORM2,
        "laplace": False, "laplace_use_residuals": False,
        "laplace_lambda": 1., "laplace_norm": constants.NORM2,
        "norm_laplace": False, "norm_laplace_use_residuals": False,
        "norm_laplace_lambda": 1., "norm_laplace_type": constants.NORM2,
        "loc_var": False, "loc_var_ksz": 3, "loc_var_use_residuals": False,
        "loc_var_lambda": 1., "loc_var_norm": constants.NORM2,
        "norm_loc_var": False, "norm_loc_var_ksz": 3,
        "norm_loc_var_use_residuals": False, "norm_loc_var_lambda": 1.,
        "norm_loc_var_type": constants.NORM2,
        "hist": False, "hist_lambda": 1., "hist_sigma": 1e5,
        "hist_metric": constants.NORM2,
        "kde": False, "kde_lambda": 1., "kde_nbins": 256,
        "kde_kde_bw": 1. / (255. ** 2), "kde_metric": constants.NORM2,
        "ce": False, "ce_lambda": 1.,
        # ----------------------------------------------------------- mixed
        # bf16 compute over f32 params; amp_eval False evaluates an f32
        # twin of the same weights.
        "amp": False,
        "amp_eval": False,
        # ------------------------------------------------------ processes
        # data parallelism (parallel/mesh.py): distributed True runs one
        # process per card under torchrun (or SLURM's variables), over
        # NCCL on the card and gloo on the CPU; a data x model grid of
        # the ranks whose product must be the world size. mesh_data -1 =
        # world_size // mesh_model.
        "dist_backend": constants.BACKEND_ICI,
        "distributed": False,
        "mesh_data": -1,
        "mesh_model": 1,
        # the port's own process-group keys: the rendezvous
        # ('' = env://, torchrun's MASTER_ADDR / MASTER_PORT; or
        # file:///path, tcp://host:port) and the collectives' timeout
        "init_method": '',
        "dist_timeout_s": 1800,
        "rank": 0,
        "world_size": 1,
        "is_master": True,
        "is_node_master": True,
        "device_data_pipeline": True,
        # the port's own key: where the entry points run ('cuda', or
        # 'cpu' when the caller asks; nothing falls back to the CPU).
        "device": 'cuda',
    }

    args['netG'] = init_net_g(args['netG'], args)
    return args
