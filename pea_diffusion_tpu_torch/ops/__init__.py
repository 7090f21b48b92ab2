"""The attention dispatch and the kernels' wrappers. The differentiable
``flash_attention`` is reached as ``ops.flash_attention.flash_attention``:
the package attribute ``flash_attention`` is its module."""
from .attention import dot_product_attention, use_flash, xla_attention, xla_attention_bshd
from .flash_attention import flash_backward, flash_backward_ref, flash_forward, flash_forward_ref
from .onepass_attention import bshd_attention, onepass_forward, onepass_forward_ref, supports

__all__ = [
    "dot_product_attention", "use_flash", "xla_attention", "xla_attention_bshd",
    "flash_backward", "flash_backward_ref", "flash_forward", "flash_forward_ref",
    "bshd_attention", "onepass_forward", "onepass_forward_ref", "supports",
]
