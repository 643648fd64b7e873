"""Default configuration: the port's copy of the entries of
srcaco2_tpu/config/defaults.py:get_config that the training step reads
(the data and patch settings, the local-augmentation and ppiw flags,
the loss flags, amp and the `train` section), with the same values.
The trainer's own settings (checkpoints, logging, mesh) are not ported
yet (see ROADMAP.md)."""
from srcaco2_tpu_torch import constants
from srcaco2_tpu_torch.config.net_defaults import init_net_g


def get_config(net_type: str = constants.SWINIR) -> dict:
    args = {
        "n_channels": 3,
        "h_size": 96,          # HR crop size; LR crop = h_size // scale.
        "scale": 2,
        "netG": {"net_type": net_type},
        "train": {
            "E_decay": 0.0,                  # EMA decay; 0 disables netE.
            "G_optimizer_type": constants.ADAM,
            "G_optimizer_lr": 2e-4,
            "G_optimizer_wd": 1e-4,
            "G_optimizer_clipgrad": 0.0,
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
        },
        # local data augmentation (not ported: they raise when set)
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
        "elb_init_t": 1.,
        "elb_max_t": 10.,
        "elb_mulcoef": 1.01,
        "ppiw": False,
        "sample_tr_patch": constants.SAMPLE_UNIF,
        "sample_tr_patch_th_style": constants.TH_AUTO,
        "sample_tr_patch_th": constants.TH_AUTO,
        "train_aligned_crops": False,
        # losses
        "l1": False, "l1_use_residuals": False, "l1_lambda": 1.,
        "l2": False, "l2_use_residuals": False, "l2_lambda": 1.,
        "l2sum": False, "l2sum_use_residuals": False, "l2sum_lambda": 1.,
        "ssim": False, "ssim_lambda": 1., "ssim_window_s": 11,
        "charbonnier": False, "boundpred": False, "local_moments": False,
        "img_grad": False, "norm_img_grad": False, "laplace": False,
        "norm_laplace": False, "loc_var": False, "norm_loc_var": False,
        "hist": False, "kde": False, "ce": False, "w_sparsity": False,
        # bf16 compute over f32 params
        "amp": False,
    }
    args['netG'] = init_net_g(args['netG'], args)
    return args
