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
