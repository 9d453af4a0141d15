"""Numerics layer: resampling, activations, modulated convolution, the
filtered leaky ReLU, and the warp kernel pairs (fused upsample+warp of
the ADA augmentation; plain affine warp)."""

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .filtered_lrelu import filtered_lrelu
from .grid_sample import affine_grid, grid_sample
from .modulated_conv2d import modulated_conv2d
from .upfirdn2d import downsample2d, filter2d, setup_filter, upfirdn2d, upsample2d
from .upwarp import up_affine_warp
from .warp import affine_warp

__all__ = [
    "activation_funcs",
    "bias_act",
    "conv2d_resample",
    "affine_grid",
    "grid_sample",
    "modulated_conv2d",
    "setup_filter",
    "upfirdn2d",
    "filter2d",
    "upsample2d",
    "downsample2d",
    "up_affine_warp",
    "affine_warp",
    "filtered_lrelu",
]
