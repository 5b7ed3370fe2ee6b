"""The port's ops and their hand-written CUDA kernels: attention
(``flash_attention``, routed by ``attention``), the UNet's 3x3 conv
(``conv2d``) and the fused bias + leaky ReLU (``fused_act``)."""

from .conv2d import (
    conv3x3,
    conv3x3_pallas,
    conv3x3_reference,
    conv3x3_supported,
    conv3x3_wgrad_pallas,
    conv3x3_wgrad_reference,
    use_pallas_conv,
)
from .fused_act import FusedLeakyReLU, fused_leaky_relu, fused_leaky_relu_reference

__all__ = [
    "FusedLeakyReLU",
    "conv3x3",
    "conv3x3_pallas",
    "conv3x3_reference",
    "conv3x3_supported",
    "conv3x3_wgrad_pallas",
    "conv3x3_wgrad_reference",
    "fused_leaky_relu",
    "fused_leaky_relu_reference",
    "use_pallas_conv",
]
