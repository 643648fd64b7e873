"""The registry names the port needs (own copy of srcaco2_tpu/constants.py
entries; the port imports nothing of the JAX package)."""

SWINIR = 'SwinIR'
SRCNN = 'SRCNN'

# Networks that consume the bicubically pre-upscaled input.
PRE_UPSAMPLED_INPUT_NETS = [SRCNN]

# swinir upsampler styles
US_PIXEL_SHUFFLE = 'pixelshuffle'
US_PIXEL_SHUFFLE_DIRECT = 'pixelshuffledirect'
US_NEAREST_CONV = 'nearest_conv'

R_CONNECTION_1CONV = '1conv'
R_CONNECTION_3CONV = '3conv'

# nets whose input the step dispatch names (train/steps.py:net_input)
CSRCNN = 'CSRCNN'
NET_TYPE_UNET = 'unet'
NET_TYPE_PYRAMID = 'pyramid'

# patch sampling (only uniform sampling is ported)
SAMPLE_UNIF = 'uniform'
TH_AUTO = 'automatic_threshold'
TH_FIX = 'fix_threshold'

# optimizers and schedules
SGD = 'sgd'
ADAM = 'adam'
MULTISTEPLR = 'MultiStepLR'
MYSTEPLR = 'MyStepLR'

# evaluation metrics (ops/metrics.py, train/evaluator.py)
PSNR_MTR = 'psnr'
SSIM_MTR = 'ssim'
MSE_MTR = 'mse'
NRMSE_MTR = 'nrmse'
PSNR_Y_MTR = 'psnr_y'
# ROI thresholds the ROI metrics are marginalized over
ROI_THRESH = [4, 5, 6, 7, 8, 9, 10]
