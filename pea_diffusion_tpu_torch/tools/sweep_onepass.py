"""S1: a sweep of the one-pass attention kernel B1 over its CUDA tile shapes.

    python3 -m pea_diffusion_tpu_torch.tools.sweep_onepass [--iters 20] \\
        [--out sweep.json] [--shapes b16,b2]

Port of the JAX package's ``tools/sweep_onepass.py``, whose Pallas variants
of B1 (``_kernel_variant``, ``_kernel_bb``) swept a TPU core's query block,
two-head interleave, exp2 and batch blocking. Here the variants are B1's two
CUDA bodies (entry point ``pea_onepass_attention_fwd_variant`` of
``csrc/attention_fwd.cu``) at other tile shapes: the mma.sync body of
``attention_fwd.cu`` (query block 64 or 128 rows, 4 or 8 warps; KV tile 64
or 128 rows; 2 or 3 ``cp.async`` stages) and the wgmma body of
``attention_fwd_sm90_body.cuh`` (1 or 2 warpgroups of 64 query rows; 2 or 3 TMA
stages of 128 K/V rows; the staged form filled by ``cp.async``).
``shipped_variant(seq)`` is the instantiation B1 ships at that sequence
length; ``q64_kv64_s2`` is the mma.sync body's shipped shape, which B1 ran
before. exp2 with log2(e) folded into the scale
is in both bodies already; the interleave and batch blocking schedule a TPU
core's units and its sequential grid and have no variant here (see the
source).

Prints one JSON row per (shape, variant), as the JAX tool does: ``shape``,
``variant``, ``us`` (mean CUDA-event time, each launch after an L2 flush),
``tflops``, ``max_abs_err_vs_base`` (against shipped B1 on the same
inputs), ``equals_base``, ``shipped`` (whether B1 ships this variant at
this shape) and ``rel_err_vs_plain`` (max |variant - plain| /
max |plain|, the plain version ``onepass_forward_ref`` in fp32 from the
same bf16 inputs), ``launches``. Runs on a CUDA card only and raises
without one. It picks no winner itself: B1's choice between the wgmma
variants is a fixed rule in its source, set from this sweep's rows.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import sys
from typing import Callable, Dict, List, Optional

import torch

from ..ops import kernel_build
from ..ops.onepass_attention import onepass_forward, onepass_forward_ref

# The C source's table (attention_fwd.cu, kVariants), in its order: the
# mma.sync body's q<query block>_kv<KV tile>_s<stages>, then the wgmma
# body's wg<warpgroups>_kv128_s<stages>[_cpasync].
VARIANTS = ("q64_kv64_s2", "q64_kv64_s3", "q64_kv128_s2", "q64_kv128_s3",
            "q128_kv64_s2", "q128_kv64_s3", "q128_kv128_s2", "q128_kv128_s3",
            "wg1_kv128_s2", "wg2_kv128_s2", "wg2_kv128_s3", "wg1_kv128_s2_cpasync")
ONE_WARPGROUP_MAX_SQ = 1024  # attention_fwd_sm90.cu, kOneWarpgroupMaxSq


def shipped_variant(seq: int) -> str:
    """The variant B1 ships for `seq` query rows: one warpgroup of 64 query
    rows per block up to ONE_WARPGROUP_MAX_SQ, two above (the rule in
    ``attention_fwd_sm90.cu``)."""
    return "wg1_kv128_s2" if seq <= ONE_WARPGROUP_MAX_SQ else "wg2_kv128_s2"

# The JAX tool's shapes (label, batch, heads, seq, head_dim): SDXL's
# self-attention at levels 1 and 2, at serving batch 8 (16 CFG rows) and 1.
SHAPES = {
    "b16": [("lvl1-self b8", 16, 10, 4096, 64), ("lvl2-self b8", 16, 20, 1024, 64)],
    "b2": [("lvl1-self b1", 2, 10, 4096, 64), ("lvl2-self b1", 2, 20, 1024, 64)],
}
PLAIN_SCORES = 2**29  # fp32 score elements per chunk of the plain version

# pea_onepass_attention_fwd_variant(q, k, v, o, batch, heads, sq, skv,
#                                   head_dim, scale, dtype, variant, device, stream)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])


@functools.cache
def library_variants() -> tuple:
    """The variant names the built library lists, in its order (read once)."""
    count = kernel_build.function("pea_onepass_variant_count", [])()
    name = kernel_build.function("pea_onepass_variant_name", [ctypes.c_int], ctypes.c_char_p)
    return tuple(name(i).decode() for i in range(count))


def onepass_forward_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            heads: int, head_dim: int, variant: str,
                            scale: Optional[float] = None) -> torch.Tensor:
    """B1 in the tile variant `variant` (a name of ``VARIANTS``): q [B, Sq,
    H*D] x k, v [B, Skv, H*D] -> [B, Sq, H*D].

    CUDA tensors (bfloat16, head_dim 64) launch the variant and count the
    launch in ``onepass_forward_variant.launches[variant]``; anything the
    variants do not take raises. CPU tensors run ``onepass_forward_ref``."""
    if variant not in VARIANTS:
        raise ValueError(f"one-pass variant {variant!r}: one of {', '.join(VARIANTS)}")
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    if not q.is_cuda:
        return onepass_forward_ref(q, k, v, heads, head_dim, scale)
    if kernel_build.half_dtype_code(q, k, v) != 0:
        raise TypeError("the one-pass variants take bfloat16")
    b, sq, feat = q.shape
    skv = k.shape[1]
    if head_dim != 64 or feat != heads * head_dim:
        raise ValueError(f"one-pass variants: heads={heads} head_dim={head_dim} "
                         f"does not fit feature width {feat} (head_dim 64)")
    if k.shape != (b, skv, feat) or v.shape != k.shape or skv < 1 or sq < 1:
        raise ValueError(f"one-pass variants: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if library_variants() != VARIANTS:
        raise RuntimeError(f"the library's variants {library_variants()} are not {VARIANTS}")
    out = torch.empty_like(q)
    kernel_build.launch("pea_onepass_attention_fwd_variant", _ARGTYPES,
                        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, heads, sq, skv, head_dim, scale, 0, VARIANTS.index(variant),
                        q.device.index, kernel_build.stream_of(q))
    onepass_forward_variant.launches[variant] += 1
    return out


onepass_forward_variant.launches = dict.fromkeys(VARIANTS, 0)


def shapes(keys: str) -> List[tuple]:
    """The (label, batch, heads, seq, head_dim) rows of comma-separated
    ``SHAPES`` keys."""
    return [row for key in keys.split(",") for row in SHAPES[key]]


def make_inputs(batch: int, heads: int, seq: int, head_dim: int, seed: int = 0):
    """Seeded bf16 q, k, v [batch, seq, heads * head_dim] on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(batch, seq, heads * head_dim, generator=gen,
                             device="cuda").bfloat16() for _ in range(3))


def plain_forward(q, k, v, heads: int, head_dim: int) -> torch.Tensor:
    """``onepass_forward_ref`` in fp32 from `q`, `k`, `v`, over chunks of
    batch rows whose fp32 score matrices fit ``PLAIN_SCORES`` elements."""
    n = max(1, PLAIN_SCORES // (heads * q.shape[1] * k.shape[1]))
    return torch.cat([onepass_forward_ref(q[i:i + n].float(), k[i:i + n].float(),
                                          v[i:i + n].float(), heads, head_dim)
                      for i in range(0, q.shape[0], n)])


def time_us(fn: Callable[[], object], iters: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of `fn` in microseconds, each launch after
    overwriting `flush`, a buffer larger than L2, after two warm-up calls."""
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters * 1e3


def sweep(shape_keys: str = "b16", iters: int = 20, seed: int = 0,
          emit: Callable[[dict], None] = lambda row: None) -> List[Dict]:
    """Every variant at every shape of `shape_keys`: checked against shipped
    B1 and the plain version, then timed. Returns the rows (and hands each
    to `emit` as it is made)."""
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_onepass runs on a CUDA card only; none is available")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = []
    for label, b, h, s, d in shapes(shape_keys):
        q, k, v = make_inputs(b, h, s, d, seed)
        with torch.no_grad():
            base = onepass_forward(q, k, v, h, d)
            plain = plain_forward(q, k, v, h, d)
        plain_max = plain.abs().max().item()
        flops = 4 * b * h * s * s * d
        for name in VARIANTS:
            before = onepass_forward_variant.launches[name]
            with torch.no_grad():
                out = onepass_forward_variant(q, k, v, h, d, name)
                us = time_us(lambda: onepass_forward_variant(q, k, v, h, d, name), iters, flush)
            row = {"shape": label, "variant": name, "batch": b, "heads": h, "seq": s,
                   "head_dim": d, "us": us, "tflops": flops / us / 1e6,
                   "max_abs_err_vs_base": (out.float() - base.float()).abs().max().item(),
                   "equals_base": torch.equal(out, base),
                   "shipped": name == shipped_variant(s),
                   "rel_err_vs_plain": (out.float() - plain).abs().max().item() / plain_max,
                   "launches": onepass_forward_variant.launches[name] - before}
            rows.append(row)
            emit(row)
            del out
        del q, k, v, base, plain
    del flush
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None, help="also write the rows to this JSON file")
    ap.add_argument("--shapes", default="b16", help="comma-separated keys of SHAPES")
    args = ap.parse_args(argv)
    unknown = [key for key in args.shapes.split(",") if key not in SHAPES]
    if unknown:
        ap.error(f"--shapes {unknown}: the keys are {', '.join(SHAPES)}")
    rows = sweep(args.shapes, args.iters, emit=lambda row: print(json.dumps(row), flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
