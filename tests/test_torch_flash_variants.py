"""B3's variants (``flash_forward_variant``: the mma.sync body, and the wgmma
+ TMA body with 1 or 2 warpgroups and K/V tiles of 64 or 128 rows) as the
port lists them, against the CUDA sources' tables, and each variant's plain
version on the CPU against the JAX package's Pallas flash forward in
interpret mode, output and lse (fp32, atol 2e-5 as the JAX package's own
kernel tests). The kernels themselves are held against the plain version on
the card by test_torch_kernels_on_card.py.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pea_diffusion_tpu.ops.flash_attention import _flash_forward
from pea_diffusion_tpu_torch.ops import flash_attention
from pea_diffusion_tpu_torch.ops.flash_attention import FLASH_VARIANTS

CSRC = Path(__file__).resolve().parent.parent / "pea_diffusion_tpu_torch" / "csrc"
ATOL = 2e-5
# (sq, skv) per head dim: ragged Sq and Skv, Skv below one tile and above
SHAPES = {40: (130, 52), 64: (200, 130), 80: (257, 77), 128: (100, 300), 160: (64, 200)}


def _built_shapes():
    """{variant name: head dims} from each head dim's launch_dim
    (launch_shapes<D, kFlashStages, warpgroups * 1000 + K/V rows, ...>)."""
    built = {}
    for path in sorted(CSRC.glob("*.cu")):
        for d, shapes in re.findall(r"launch_shapes<(\d+), kFlashStages, ([\d, ]+)>\(",
                                    path.read_text()):
            for shape in map(int, shapes.split(",")):
                built.setdefault(f"wg{shape // 1000}_kv{shape % 1000}", set()).add(int(d))
    return built


def test_variant_names_match_the_cuda_table():
    """The wrapper's names are the C table's (kFlashVariants), in its order,
    each naming its body's shape: the mma.sync body at its shipped tile, then
    the wgmma body's warpgroups and K/V tile rows."""
    src = (CSRC / "attention_fwd.cu").read_text()
    table = src[src.index("constexpr FlashVariant kFlashVariants[] = {"):]
    entries = re.findall(r'\{"(\w+)", (\w+), (\w+)\}', table[:table.index("};")])
    assert tuple(name for name, *_ in entries) == tuple(FLASH_VARIANTS)
    assert entries[0] == ("mma_sync", "0", "kBlockN")
    for name, warpgroups, kv_tile in entries[1:]:
        assert name == f"wg{warpgroups}_kv{kv_tile}"


def test_variant_head_dims_match_each_launch_dim():
    """The head dims the wrapper lists for each wgmma variant are those its
    instantiations are built for; the mma.sync body takes every head dim."""
    built = _built_shapes()
    assert set(built) == set(FLASH_VARIANTS) - {"mma_sync"}
    for name, dims in built.items():
        assert set(FLASH_VARIANTS[name]) == dims, name
    assert FLASH_VARIANTS["mma_sync"] == flash_attention.HEAD_DIMS


def test_shipped_rule_picks_built_variants():
    """The shipped rule (attention_fwd.cu, shipped_flash_variant): two
    warpgroups with K/V tiles of 64 rows from D = 64 on; at D = 40 K/V
    tiles of 128 rows, but the mma.sync body up to kFlashShortKv KV rows.
    Every variant it names is built at the head dim it names it for, and no
    self-attention length takes the mma.sync body."""
    src = (CSRC / "attention_fwd.cu").read_text()
    short = int(re.search(r"constexpr int kFlashShortKv = (\d+);", src).group(1))
    assert "if (head_dim != 40) return flash_variant(2, 64);" in src
    assert ("return skv <= kFlashShortKv ? flash_variant(0, kBlockN) : flash_variant(2, 128);"
            in src)
    for d in flash_attention.HEAD_DIMS:
        for skv in (52, 77, 1000, 1024, 16384):
            if d != 40:
                name = "wg2_kv64"
            else:
                name = "mma_sync" if skv <= short else "wg2_kv128"
            assert d in FLASH_VARIANTS[name], (d, skv, name)
            assert skv < 1000 or name != "mma_sync"


@functools.cache
def _jax_reference(d):
    sq, skv = SHAPES[d]
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32) for s in (sq, skv, skv))
    out, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0 / np.sqrt(d),
                              block_q=128, block_k=128, interpret=True, with_lse=True)
    return (q, k, v), np.asarray(out), np.asarray(lse)


@pytest.mark.parametrize("variant,d", [(name, d) for name, dims in FLASH_VARIANTS.items()
                                       for d in dims])
def test_each_variant_on_cpu_matches_jax_kernel(variant, d):
    """On CPU tensors every variant runs the plain version, with and without
    lse, and counts no launch."""
    (q, k, v), want, want_lse = _jax_reference(d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    before = dict(flash_attention.flash_forward_variant.launches)
    got, got_lse = flash_attention.flash_forward_variant(tq, tk, tv, variant, with_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=ATOL)
    plain = flash_attention.flash_forward_variant(tq, tk, tv, variant)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)
    assert flash_attention.flash_forward_variant.launches == before


def test_variants_refuse_what_they_are_not_built_for():
    """An unknown name, and a head dim the variant is not built for, raise
    (on any device), naming what it takes."""
    x = torch.zeros(2, 8, 160)
    with pytest.raises(ValueError, match="mma_sync"):
        flash_attention.flash_forward_variant(x, x, x, "wg3_kv256")
    missing = [(name, d) for name, dims in FLASH_VARIANTS.items()
               for d in flash_attention.HEAD_DIMS if d not in dims]
    assert ("wg2_kv128", 160) in missing  # 241 KB of shared memory
    for name, d in missing:
        x = torch.zeros(2, 8, d)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_forward_variant(x, x, x, name)
