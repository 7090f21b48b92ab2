"""Attention dispatch (port of ``pea_diffusion_tpu/ops/attention.py``): the
differentiable flash attention (B3 forward, B4/B5 backward) for long query
sequences on the card, plain PyTorch math otherwise. "On a TPU" in the JAX
package reads "on a CUDA tensor" here."""
from __future__ import annotations

import math
import os
from typing import Optional

import torch

from .flash_attention import flash_attention

# Minimum query length for the kernel paths (the JAX package's threshold).
FLASH_MIN_SEQ = 1024


def use_flash(sq: int, backend: str = "auto", device_type: str = "cuda") -> bool:
    """backend: "flash" always, "xla" never (the plain path; the name is the
    JAX package's), "auto" for CUDA tensors with sq >= FLASH_MIN_SEQ unless
    ``PEA_DISABLE_FLASH`` is set (to anything non-empty, read at each call,
    as the JAX package reads it)."""
    if backend == "flash":
        return True
    if backend == "xla":
        return False
    if backend != "auto":
        raise ValueError(f"attention backend {backend!r}: auto | flash | xla")
    if os.environ.get("PEA_DISABLE_FLASH"):
        return False
    return device_type == "cuda" and sq >= FLASH_MIN_SEQ


def xla_attention(q, k, v, scale, mask: Optional[torch.Tensor] = None):
    """q: [BH, Sq, D]; fp32 scores and softmax, P in V's type for P.V."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def xla_attention_bshd(q, k, v, scale):
    """[B, S, H, D] attention with the head axis kept in place."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None,
                          backend: str = "auto"):
    """Multi-head attention over flattened [B*H, S, D] tensors."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if mask is None and use_flash(q.shape[1], backend, q.device.type):
        return flash_attention(q, k, v, scale)
    return xla_attention(q, k, v, scale, mask)
