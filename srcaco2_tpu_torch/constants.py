"""The registry names the port needs (own copy of srcaco2_tpu/constants.py
entries; the port imports nothing of the JAX package)."""

# tasks
SUPER_RES = 'super-resolution'
RECONSTRUCT = 'reconstruct'
TASKS = [SUPER_RES, RECONSTRUCT]
REGRESSION = 'regression'
SEGMENTATION = 'segmentation'
NET_TASKS = [REGRESSION, SEGMENTATION]

SWINIR = 'SwinIR'
SRCNN = 'SRCNN'
VDSR = 'VDSR'
DFCAN = 'DFCAN'
MSLAPSR = 'MSLapSRN'
SRFBN = 'SRFBN'
ENLCN = 'ENLCN'
ACT = 'ACT'
OMNISR = 'OmniSR'
PROSR = 'ProSR'
NLSN = 'NLSN'
GRL = 'GRL'
DRRN = 'DRRN'
MEMNET = 'MemNet'
DBPN = 'DBPN'
DSRSPLINES = 'DSRSplines'
CSRCNN = 'CSRCNN'
EDSR_LIIF = 'EDSR_LIIF'
# every net of the JAX zoo, all ported (config/net_defaults.py:PORTED_NETS)
MODELS = [SWINIR, DSRSPLINES, CSRCNN, DFCAN, SRCNN, VDSR, MEMNET,
          DRRN, OMNISR, GRL, ENLCN, ACT, NLSN, EDSR_LIIF,
          SRFBN, DBPN, MSLAPSR, PROSR]
NETTYPE_METHOD = {m: m for m in MODELS}
INIT_W_DEFAULT = 'init_w_default'
INIT_BN_CONSTANT = 'init_bn_constant'

# Networks that consume the bicubically pre-upscaled input.
PRE_UPSAMPLED_INPUT_NETS = [SRCNN]

# swinir upsampler styles
US_PIXEL_SHUFFLE = 'pixelshuffle'
US_PIXEL_SHUFFLE_DIRECT = 'pixelshuffledirect'
US_NEAREST_CONV = 'nearest_conv'

R_CONNECTION_1CONV = '1conv'
R_CONNECTION_3CONV = '3conv'

# CSR-CNN's variants: the two named ones, else a key of NETS_CNN
NET_TYPE_UNET = 'unet'
NET_TYPE_PYRAMID = 'pyramid'

# DSR-Splines' spline networks: hidden widths of one spline branch
SPLINE_NET_TYPES = [f'snet_type{i}' for i in range(1, 9)]
SPLINEHIDDEN = {
    f'snet_type{i}': [32] * (i - 1) + [16] for i in range(1, 9)
}
SPLINEHIDDEN['snet_type1'] = [16]

# small-CNN layer configs for the CSR-CNN 'snet_type*' variants
NETS_CNN = {
    'snet_type1': [32],
    'snet_type2': [32, 32],
    'snet_type3': [256, 256, 256],
    'snet_type4': [32] * 4,
    'snet_type5': [32] * 5,
    'snet_type6': [32] * 6,
    'snet_type7': [32] * 7,
    'snet_type8': [32] * 8,
}

# patch sampling (data/sampling.py)
SAMPLE_UNIF = 'uniform'
SAMPLE_ROI = 'roi'
SAMPLE_EDT = 'edt'
SAMPLE_EDTXROI = 'edt*roi'
SAMPLE_PATCHES = [SAMPLE_UNIF, SAMPLE_ROI, SAMPLE_EDT, SAMPLE_EDTXROI]
TH_AUTO = 'automatic_threshold'
TH_FIX = 'fix_threshold'

# phases, splits, datasets
TRAIN_PHASE = 'train'
EVAL_PHASE = 'eval'
TRAINSET = 'train'
VALIDSET = 'val'
TESTSET = 'test'
SPLITS = [TRAINSET, VALIDSET, TESTSET]
CELL0 = 'CELL0'  # Survivin
CELL1 = 'CELL1'  # E-cadherin / GFP-tubulin
CELL2 = 'CELL2'  # mCherry-Histone-H2B
SCALES = [2, 4, 8]
CODE_IDENTIFIER = 'CODEXXXXXXXIDENTIFIER'
_CACO2_FMT = 'caco2_{split}_X_{scale}_in_{inres}_out_512_cell_{cell}'


def caco2_name(split: str, scale: int, cell: str) -> str:
    """Canonical dataset name, e.g.
    caco2_train_X_8_in_64_out_512_cell_CELL2."""
    if split not in SPLITS or scale not in SCALES:
        raise ValueError(f'split {split!r}, scale {scale!r}')
    return _CACO2_FMT.format(split=split, scale=scale, inres=512 // scale,
                             cell=cell)


def parse_caco2_name(name: str):
    """Inverse of caco2_name -> (split, scale, cell); biosr_* names
    follow the same pattern."""
    parts = name.split('_')
    if parts[0] not in ('caco2', 'biosr'):
        raise ValueError(f'not a caco2 / biosr dataset name: {name!r}')
    return parts[1], int(parts[3]), parts[-1]


# interpolation of the bicubic baseline
INTER_BICUBIC = 'bicubic'

# loss norms and distribution metrics (losses/master.py)
NORM1 = '1'
NORM2 = '2'
NORM0EXP = '0EXP'
KL = 'KL'
BH = 'BHATTACHARYYA'

# optimizers and schedules
SGD = 'sgd'
ADAM = 'adam'
OPTIMIZERS = [SGD, ADAM]
MULTISTEPLR = 'MultiStepLR'
MYSTEPLR = 'MyStepLR'
STEPSLR = [MULTISTEPLR, MYSTEPLR]

# evaluation metrics (ops/metrics.py, train/evaluator.py)
PSNR_MTR = 'psnr'
SSIM_MTR = 'ssim'
MSE_MTR = 'mse'
NRMSE_MTR = 'nrmse'
PSNR_Y_MTR = 'psnr_y'
SSIM_Y_MTR = 'ssim_y'
METRICS = [PSNR_MTR, SSIM_MTR, MSE_MTR, NRMSE_MTR, PSNR_Y_MTR, SSIM_Y_MTR]
# the better of two values of each metric
BEST_MTR = {PSNR_MTR: max, SSIM_MTR: max, MSE_MTR: min, NRMSE_MTR: min,
            PSNR_Y_MTR: max, SSIM_Y_MTR: max}
# ROI thresholds the ROI metrics are marginalized over
ROI_THRESH = [4, 5, 6, 7, 8, 9, 10]

# the process set-up (config/parser.py:_setup_process, parallel/mesh.py):
# `dist_backend` says whether the job spans one node ('ici') or several
# ('dcn'), as in the JAX package; neither picks the torch backend, which
# is NCCL on the card and gloo on the CPU
BACKEND_ICI = 'ici'          # one node
BACKEND_MULTIHOST = 'dcn'    # several nodes
BACKENDS = [BACKEND_ICI, BACKEND_MULTIHOST]

DATA_AXIS = 'data'           # the grid's data-parallel axis
MODEL_AXIS = 'model'         # its replica axis (ranks of one data shard)
