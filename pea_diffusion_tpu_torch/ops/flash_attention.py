"""Flash attention on head-major [BH, S, D]: the forward B3, the backward B4
(dK, dV) and B5 (dQ), and ``flash_attention``, the differentiable function
over them.

Port of ``pea_diffusion_tpu/ops/flash_attention.py``. On a CUDA tensor each
bare wrapper launches its hand-written Hopper kernel: ``flash_forward`` the
forward (entry point ``pea_flash_attention_fwd`` of ``csrc/attention_fwd.cu``,
replacing the TPU kernel ``_fwd_kernel``), which runs the wgmma + TMA body
of ``csrc/attention_fwd_sm90_body.cuh`` or, where its shipped rule says so,
the mma.sync body of ``attention_fwd.cu`` (``flash_forward_variant`` runs
any of its variants), ``flash_backward_dkdv`` and
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
import functools
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


# Head dims the kernels are built for: SD1.5's 40, 80 and 160 (level 2 and
# the mid block, on the flash route at 1024² and up), SDXL's 64, and 128.
HEAD_DIMS = (40, 64, 80, 128, 160)


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
    out, lse = _launch_forward("pea_flash_attention_fwd", _ARGTYPES, q, k, v, scale, with_lse)
    flash_forward.launches += 1
    flash_forward.lse_launches += with_lse
    return (out, lse) if with_lse else out


def _launch_forward(symbol: str, argtypes, q, k, v, scale: float, with_lse: bool, *extra):
    """Checks what the forward kernels take, allocates the output (and the
    fp32 lse) and launches the entry point `symbol`: (q, k, v, o, lse, bh,
    sq, skv, head_dim, scale, dtype, *extra, device, stream). Returns (out,
    lse or None)."""
    dtype = kernel_build.half_dtype_code(q, k, v)
    _check_shapes("flash kernel", q, k, v)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    kernel_build.launch(symbol, argtypes, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), None if lse is None else lse.data_ptr(),
                        bh, sq, k.shape[1], d, scale, dtype, *extra, q.device.index,
                        kernel_build.stream_of(q))
    return out, lse


flash_forward.launches = 0
flash_forward.lse_launches = 0

# B3's variants, in the order of the C table (attention_fwd.cu,
# kFlashVariants), and the head dims each is built for: the mma.sync body
# (B3's earlier body), and the wgmma + TMA body with 1 or 2 warpgroups of
# 64 query rows and K/V tiles of 128 or 64 rows (each head dim's launch_dim,
# attention_fwd_sm90.cu and flash_fwd_sm90_d<D>.cu).
FLASH_VARIANTS = {
    "mma_sync": HEAD_DIMS,
    "wg1_kv128": (40, 64, 80, 160),
    "wg2_kv128": (40, 64, 80),
    "wg1_kv64": HEAD_DIMS,
    "wg2_kv64": HEAD_DIMS,
}
# pea_flash_attention_fwd_variant(q, k, v, o, lse, bh, sq, skv, head_dim,
#                                 scale, dtype, variant, device, stream)
_VARIANT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                     + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.cache
def library_flash_variants() -> tuple:
    """The variant names the built library lists, in its order (read once)."""
    count = kernel_build.function("pea_flash_variant_count", [])()
    name = kernel_build.function("pea_flash_variant_name", [ctypes.c_int], ctypes.c_char_p)
    return tuple(name(i).decode() for i in range(count))


def shipped_flash_variant(skv: int, head_dim: int) -> str:
    """The variant ``flash_forward`` runs for `skv` KV rows at `head_dim`:
    the library's own rule (``pea_flash_shipped_variant``), so it needs the
    built library."""
    index = kernel_build.function("pea_flash_shipped_variant", [ctypes.c_int] * 2)(
        skv, head_dim)
    return tuple(FLASH_VARIANTS)[index]


def flash_forward_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, variant: str,
                          scale: Optional[float] = None, with_lse: bool = False):
    """B3 in the variant `variant` (a name of ``FLASH_VARIANTS``), the same
    function as ``flash_forward``. CUDA tensors launch it and count the launch
    in ``flash_forward_variant.launches[variant]`` (not in
    ``flash_forward.launches``) and raise on anything ``flash_forward``
    refuses; CPU tensors run ``flash_forward_ref``. A head dim the variant is
    not built for raises on either."""
    if variant not in FLASH_VARIANTS:
        raise ValueError(f"flash variant {variant!r}: one of {', '.join(FLASH_VARIANTS)}")
    d = q.shape[-1]
    if d not in FLASH_VARIANTS[variant]:
        raise ValueError(f"flash variant {variant}: head_dim {d} (built for "
                         f"{', '.join(map(str, FLASH_VARIANTS[variant]))})")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not q.is_cuda:
        return flash_forward_ref(q, k, v, scale, with_lse)
    check_no_grad("flash_forward_variant", q, k, v)
    if library_flash_variants() != tuple(FLASH_VARIANTS):
        raise RuntimeError(f"the library's flash variants {library_flash_variants()} are not "
                           f"{tuple(FLASH_VARIANTS)}")
    out, lse = _launch_forward("pea_flash_attention_fwd_variant", _VARIANT_ARGTYPES, q, k, v,
                               scale, with_lse, tuple(FLASH_VARIANTS).index(variant))
    flash_forward_variant.launches[variant] += 1
    return (out, lse) if with_lse else out


flash_forward_variant.launches = dict.fromkeys(FLASH_VARIANTS, 0)


def flash_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                       scale: float) -> Grads:
    """Plain version of B4 and B5, step by step in fp32 (not autograd of
    the forward): delta = rowsum(dO * O); P = exp(S * scale - lse);
    dV = P^T dO with P cast to dO's type; dP = dO V^T; dS = P * (dP - delta);
    dK = dS^T Q * scale and dQ = dS K * scale with dS cast to the operand
    type. Returns (dq, dk, dv) in the inputs' types."""
    delta = (g.float() * out.float()).sum(dim=-1)
    return _backward_from_delta(q, k, v, g, lse, delta, scale)


def _backward_from_delta(q, k, v, g, lse, delta, scale: float) -> Grads:
    """``flash_backward_ref`` from delta = rowsum(dO * O) [BH, Sq] (fp32)."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    delta = delta.float()[..., None]
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
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"flash backward kernel: {name} must be contiguous, 16-byte "
                             f"aligned fp32 {tuple(q.shape[:2])} on {q.device}")
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

# B4's and B5's variants, in the order of the C tables (attention_bwd.cu,
# kDkdvVariants and kDqVariants), and the head dims each is built for: the
# mma.sync body (their earlier body), and the wgmma + TMA body with 1 or 2
# warpgroups of 64 rows (B4: K/V rows, B5: Q rows) and streamed tiles of
# q<rows> Q and dO rows (B4) or kv<rows> K and V rows (B5) (each head dim's
# bwd_launch_dim, flash_bwd_sm90_d<D>.cu).
BWD_VARIANTS = {
    "dkdv": {
        "mma_sync": HEAD_DIMS,
        "wg1_q64": HEAD_DIMS,
        "wg2_q64": HEAD_DIMS,
        "wg2_q32": HEAD_DIMS,
    },
    "dq": {
        "mma_sync": HEAD_DIMS,
        "wg1_kv64": HEAD_DIMS,
        "wg2_kv64": HEAD_DIMS,
        "wg2_kv128": (40, 64),
    },
}
_WHICH = tuple(BWD_VARIANTS)  # the C side's `which`: 0 = B4 (dkdv), 1 = B5 (dq)


@functools.cache
def library_bwd_variants(which: str) -> tuple:
    """The variant names of B4 ("dkdv") or B5 ("dq") the built library lists,
    in its order (read once)."""
    index = _WHICH.index(which)
    count = kernel_build.function("pea_flash_bwd_variant_count", [ctypes.c_int])(index)
    name = kernel_build.function("pea_flash_bwd_variant_name", [ctypes.c_int] * 2,
                                 ctypes.c_char_p)
    return tuple(name(index, i).decode() for i in range(count))


def shipped_bwd_variant(which: str, sq: int, skv: int, head_dim: int) -> str:
    """The variant ``flash_backward_dkdv`` ("dkdv") or ``flash_backward_dq``
    ("dq") runs at (`sq`, `skv`, `head_dim`): the library's own rule
    (``pea_flash_bwd_shipped_variant``), so it needs the built library."""
    index = kernel_build.function("pea_flash_bwd_shipped_variant", [ctypes.c_int] * 4)(
        _WHICH.index(which), sq, skv, head_dim)
    return tuple(BWD_VARIANTS[which])[index]


def flash_backward_variant(q, k, v, g, lse, delta, scale: float, variant: str, which: str):
    """B4 (`which` "dkdv": returns (dk, dv)) or B5 ("dq": returns dq) in the
    variant `variant` (a name of ``BWD_VARIANTS[which]``), with the inputs of
    ``flash_backward_dkdv``. CUDA tensors launch it and count the launch in
    ``flash_backward_variant.launches[which][variant]`` (not in the bare
    wrappers' counts) and raise on anything those refuse; CPU tensors run
    ``flash_backward_ref``'s arithmetic from `delta`. An unknown kernel or
    variant, or a head dim the variant is not built for, raises on either."""
    if which not in BWD_VARIANTS:
        raise ValueError(f"flash backward kernel {which!r}: one of {', '.join(BWD_VARIANTS)}")
    table = BWD_VARIANTS[which]
    if variant not in table:
        raise ValueError(f"flash backward {which} variant {variant!r}: one of "
                         f"{', '.join(table)}")
    d = q.shape[-1]
    if d not in table[variant]:
        raise ValueError(f"flash backward {which} variant {variant}: head_dim {d} (built for "
                         f"{', '.join(map(str, table[variant]))})")
    if not q.is_cuda:
        dq, dk, dv = _backward_from_delta(q, k, v, g, lse, delta, scale)
        return (dk, dv) if which == "dkdv" else dq
    check_no_grad("flash_backward_variant", q, k, v, g)
    dtype = _backward_args(q, k, v, g, lse, delta)
    if library_bwd_variants(which) != tuple(table):
        raise RuntimeError(f"the library's flash backward {which} variants "
                           f"{library_bwd_variants(which)} are not {tuple(table)}")
    bh, sq, d = q.shape
    index = tuple(table).index(variant)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    tail = (bh, sq, k.shape[1], d, scale, dtype, index, q.device.index,
            kernel_build.stream_of(q))
    if which == "dkdv":
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        kernel_build.launch("pea_flash_attention_bwd_dkdv_variant", _DKDV_VARIANT_ARGTYPES,
                            *args, dk.data_ptr(), dv.data_ptr(), *tail)
        out = (dk, dv)
    else:
        out = torch.empty_like(q)
        kernel_build.launch("pea_flash_attention_bwd_dq_variant", _DQ_VARIANT_ARGTYPES,
                            *args, out.data_ptr(), *tail)
    flash_backward_variant.launches[which][variant] += 1
    return out


flash_backward_variant.launches = {which: dict.fromkeys(table, 0)
                                   for which, table in BWD_VARIANTS.items()}
# the entry points' arguments with the variant's index before device, stream
_DKDV_VARIANT_ARGTYPES = _DKDV_ARGTYPES[:-2] + [ctypes.c_int] + _DKDV_ARGTYPES[-2:]
_DQ_VARIANT_ARGTYPES = _DQ_ARGTYPES[:-2] + [ctypes.c_int] + _DQ_ARGTYPES[-2:]


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
