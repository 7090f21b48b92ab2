from .attention import dot_product_attention, use_flash, xla_attention, xla_attention_bshd
from .flash_attention import flash_forward, flash_forward_ref
from .onepass_attention import onepass_forward, onepass_forward_ref, supports

__all__ = [
    "dot_product_attention", "use_flash", "xla_attention", "xla_attention_bshd",
    "flash_forward", "flash_forward_ref",
    "onepass_forward", "onepass_forward_ref", "supports",
]
