"""Flash attention on head-major [BH, S, D]: the forward B3, the backward B4
(dK, dV) and B5 (dQ), and ``flash_attention``, the differentiable function
over them.

Port of ``pea_diffusion_tpu/ops/flash_attention.py``. On a CUDA tensor each
bare wrapper launches its hand-written Hopper kernel: ``flash_forward`` the
forward in ``csrc/attention_fwd.cu`` (entry point ``pea_flash_attention_fwd``,
replacing the TPU kernel ``_fwd_kernel``), ``flash_backward_dkdv`` and
``flash_backward_dq`` the backward in ``csrc/attention_bwd.cu`` (replacing
``_bwd_dkdv_kernel`` and ``_bwd_dq_kernel``). On a CPU tensor each runs its
plain version. The kernels' outputs carry no autograd history, so a bare
wrapper raises on CUDA tensors that need a gradient while grad mode is on:
differentiable callers go through ``flash_attention``, whose backward is B4
and B5 (the counterpart of the JAX package's custom VJP,
``_flash_attention_vjp``). The bounds and designs are described in the
sources.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import kernel_build

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def check_no_grad(name: str, *tensors: torch.Tensor,
                  instead: str = "flash_attention / bshd_attention") -> None:
    """A bare kernel wrapper's output has no history: refuse to cut it."""
    if tensors[0].is_cuda and needs_grad(*tensors):
        raise RuntimeError(
            f"{name} launches a kernel whose output carries no gradient; "
            f"call the differentiable {instead} instead "
            "(or run under torch.no_grad())")


def flash_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: Optional[float] = None, with_lse: bool = False):
    """Plain version: [BH, Sq, D] x [BH, Skv, D] -> out [BH, Sq, D], and
    lse = m + log(l) [BH, Sq] in fp32 if `with_lse`. fp32 scores times
    `scale`; P cast to V's type for P.V accumulated in fp32; divided by the
    fp32 row sum; output in q's type."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    if with_lse:
        return out, (m + torch.log(l)).squeeze(-1)
    return out


# pea_flash_attention_fwd(q, k, v, o, lse, bh, sq, skv, head_dim, scale,
#                         dtype, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


# Head dims the kernels are built for: SD1.5's 40 and 80, SDXL's 64, and 128.
HEAD_DIMS = (40, 64, 80, 128)


def _check_shapes(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    bh, sq, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} (takes {', '.join(map(str, HEAD_DIMS))})")
    if k.shape != (bh, skv, d) or v.shape != k.shape or skv < 1 or sq < 1:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None, with_lse: bool = False):
    """[BH, Sq, D] x [BH, Skv, D] -> out [BH, Sq, D] (+ fp32 lse [BH, Sq]).

    CUDA tensors (bfloat16 or float16, D in ``HEAD_DIMS``) launch the Hopper kernel
    and count the launch in ``flash_forward.launches`` (and, with the lse,
    in ``flash_forward.lse_launches`` too); anything the kernel does not
    take raises, and so do inputs that need a gradient. CPU tensors run
    ``flash_forward_ref``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not q.is_cuda:
        return flash_forward_ref(q, k, v, scale, with_lse)
    check_no_grad("flash_forward", q, k, v)
    dtype = kernel_build.half_dtype_code(q, k, v)
    _check_shapes("flash kernel", q, k, v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel_build.launch("pea_flash_attention_fwd", _ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        bh, sq, k.shape[1], d, scale, dtype, q.device.index,
                        kernel_build.stream_of(q))
    flash_forward.launches += 1
    flash_forward.lse_launches += with_lse
    return (out, lse) if with_lse else out


flash_forward.launches = 0
flash_forward.lse_launches = 0


def flash_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                       scale: float) -> Grads:
    """Plain version of B4 and B5, step by step in fp32 (not autograd of
    the forward): delta = rowsum(dO * O); P = exp(S * scale - lse);
    dV = P^T dO with P cast to dO's type; dP = dO V^T; dS = P * (dP - delta);
    dK = dS^T Q * scale and dQ = dS K * scale with dS cast to the operand
    type. Returns (dq, dk, dv) in the inputs' types."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    s = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
    p = torch.exp(s - lse.float()[..., None])
    dv = torch.einsum("bqk,bqd->bkd", p.to(g.dtype).float(), gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, vf)
    ds = p * (dp - delta)
    dk = torch.einsum("bqk,bqd->bkd", ds.to(q.dtype).float(), qf) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds.to(k.dtype).float(), kf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# pea_flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, dk, dv, bh, sq,
#                              skv, head_dim, scale, dtype, device, stream)
_DKDV_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# pea_flash_attention_bwd_dq(q, k, v, dout, lse, delta, dq, bh, sq, skv,
#                            head_dim, scale, dtype, device, stream)
_DQ_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _backward_args(q, k, v, g, lse, delta):
    """Checks what the backward kernels take and returns the dtype code."""
    dtype = kernel_build.half_dtype_code(q, k, v, g)
    _check_shapes("flash backward kernel", q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"flash backward kernel: dO {tuple(g.shape)} vs q {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != q.shape[:2] or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"flash backward kernel: {name} must be contiguous fp32 "
                             f"{tuple(q.shape[:2])} on {q.device}")
    return dtype


def flash_backward_dkdv(q, k, v, g, lse, delta, scale: float):
    """B4: (dk, dv) [BH, Skv, D] from q, dO [BH, Sq, D], k, v [BH, Skv, D],
    fp32 lse and delta [BH, Sq]. CUDA only (the plain version of the whole
    backward is ``flash_backward_ref``); counts in
    ``flash_backward_dkdv.launches``."""
    check_no_grad("flash_backward_dkdv", q, k, v, g)
    dtype = _backward_args(q, k, v, g, lse, delta)
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel_build.launch("pea_flash_attention_bwd_dkdv", _DKDV_ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        bh, sq, k.shape[1], d, scale, dtype, q.device.index,
                        kernel_build.stream_of(q))
    flash_backward_dkdv.launches += 1
    return dk, dv


flash_backward_dkdv.launches = 0


def flash_backward_dq(q, k, v, g, lse, delta, scale: float):
    """B5: dq [BH, Sq, D], same inputs as ``flash_backward_dkdv``. CUDA
    only; counts in ``flash_backward_dq.launches``."""
    check_no_grad("flash_backward_dq", q, k, v, g)
    dtype = _backward_args(q, k, v, g, lse, delta)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    kernel_build.launch("pea_flash_attention_bwd_dq", _DQ_ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                        bh, sq, k.shape[1], d, scale, dtype, q.device.index,
                        kernel_build.stream_of(q))
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                   scale: float) -> Grads:
    """(dq, dk, dv) of attention at (q, k, v) with output `out`, fp32 `lse`
    and output gradient `g`, all head-major. CUDA tensors compute delta =
    rowsum(dO * O) in fp32 and launch B4 then B5; CPU tensors run
    ``flash_backward_ref``."""
    if not q.is_cuda:
        return flash_backward_ref(q, k, v, out, lse, g, scale)
    delta = (g.float() * out.float()).sum(dim=-1)
    dk, dv = flash_backward_dkdv(q, k, v, g, lse, delta, scale)
    dq = flash_backward_dq(q, k, v, g, lse, delta, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """B3 with lse forward, B4 + B5 backward (``_flash_fwd_rule`` and
    ``_flash_bwd_rule`` of the JAX package)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_forward(q, k, v, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(), ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable attention on [BH, S, D]. When no input needs a
    gradient it is the plain forward (B3 without lse), as the JAX custom
    VJP's primal is; otherwise ``FlashAttention``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)
