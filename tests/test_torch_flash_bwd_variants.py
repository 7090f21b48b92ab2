"""B4's and B5's variants (``flash_backward_variant``: the mma.sync body, and
the wgmma + TMA body with 1 or 2 warpgroups and streamed tiles of 32, 64 or
128 rows) as the port lists them, against the CUDA sources' tables and
shipped rule, and each variant's plain version on the CPU against the JAX
package's Pallas flash backward in interpret mode (fp32, atol 2e-4 as
tests/test_flash_vjp.py). The kernels themselves are held against the plain
version on the card by test_torch_kernels_on_card.py.
"""
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pea_diffusion_tpu.ops.flash_attention import _flash_backward_impl, _flash_forward
from pea_diffusion_tpu_torch.ops import flash_attention
from pea_diffusion_tpu_torch.ops.flash_attention import BWD_VARIANTS

CSRC = Path(__file__).resolve().parent.parent / "pea_diffusion_tpu_torch" / "csrc"
ATOL = 2e-4
# (sq, skv) per head dim: ragged Sq and Skv, Sq > Skv and Sq < Skv, Skv
# below one tile and above
SHAPES = {40: (130, 52), 64: (200, 130), 80: (257, 77), 128: (100, 300), 160: (190, 70)}
TABLES = {"dkdv": ("kDkdvVariants", "q", "kBlockM"), "dq": ("kDqVariants", "kv", "kBlockN")}


def _built_shapes(which):
    """{variant name: head dims} from each head dim's bwd_launch_dim
    (launch_<which>_shapes<D, warpgroups * 1000 + rows, ...>)."""
    _, tag, _ = TABLES[which]
    built = {}
    for path in sorted(CSRC.glob("*.cu")):
        for d, shapes in re.findall(rf"launch_{which}_shapes<(\d+), ([\d, ]+)>\(",
                                    path.read_text()):
            for shape in map(int, shapes.split(",")):
                built.setdefault(f"wg{shape // 1000}_{tag}{shape % 1000}", set()).add(int(d))
    return built


@pytest.mark.parametrize("which", ["dkdv", "dq"])
def test_bwd_variant_names_match_the_cuda_table(which):
    """The wrapper's names are the C table's (kDkdvVariants, kDqVariants), in
    its order, each naming its body's shape: the mma.sync body at its shipped
    tile, then the wgmma body's warpgroups and streamed tile rows (B4's Q
    tiles, B5's K/V tiles)."""
    table_name, tag, first_rows = TABLES[which]
    src = (CSRC / "attention_bwd.cu").read_text()
    table = src[src.index(f"constexpr BwdVariant {table_name}[] = {{"):]
    entries = re.findall(r'\{"(\w+)", (\w+), (\w+)\}', table[:table.index("};")])
    assert tuple(name for name, *_ in entries) == tuple(BWD_VARIANTS[which])
    assert entries[0] == ("mma_sync", "0", first_rows)
    for name, warpgroups, rows in entries[1:]:
        assert name == f"wg{warpgroups}_{tag}{rows}"


@pytest.mark.parametrize("which", ["dkdv", "dq"])
def test_bwd_variant_head_dims_match_each_launch_dim(which):
    """The head dims the wrapper lists for each wgmma variant are those its
    instantiations are built for, one source per head dim; the mma.sync
    body takes every head dim."""
    built = _built_shapes(which)
    assert set(built) == set(BWD_VARIANTS[which]) - {"mma_sync"}
    for name, dims in built.items():
        assert set(BWD_VARIANTS[which][name]) == dims, name
    assert BWD_VARIANTS[which]["mma_sync"] == flash_attention.HEAD_DIMS
    for d in flash_attention.HEAD_DIMS:
        assert f"bwd_launch_dim<{d}>(" in (CSRC / f"flash_bwd_sm90_d{d}.cu").read_text()


def _mirror_shipped(which, sq, skv, d, short):
    """attention_bwd.cu's shipped_bwd_variant, as the test below reads it."""
    if which == "dkdv":
        return "wg1_q64" if skv <= short else "wg2_q64"
    return "mma_sync" if skv <= short and d <= 80 else "wg2_kv64"


def test_bwd_shipped_rule_picks_built_variants():
    """The shipped rule (attention_bwd.cu, shipped_bwd_variant): B4 with Q
    tiles of 64 rows, two warpgroups, one up to kBwdShortKv K/V rows; B5
    with two warpgroups and K/V tiles of 64 rows, but the mma.sync body at
    D <= 80 up to kBwdShortKv K/V rows. Every variant it names is built at
    the head dim it names it for, and no self-attention length takes the
    mma.sync body."""
    src = (CSRC / "attention_bwd.cu").read_text()
    short = int(re.search(r"constexpr int kBwdShortKv = (\d+);", src).group(1))
    assert "if (which == 0) return bwd_variant(0, short_kv ? 1 : 2, 64);" in src
    assert ("return short_kv && head_dim <= 80 ? bwd_variant(1, 0, kBlockN) : "
            "bwd_variant(1, 2, 64);" in src)
    for which in BWD_VARIANTS:
        for d in flash_attention.HEAD_DIMS:
            for sq, skv in ((1600, 52), (4096, 77), (1000, 1000), (1024, 1024), (16384, 16384)):
                name = _mirror_shipped(which, sq, skv, d, short)
                assert d in BWD_VARIANTS[which][name], (which, d, name)
                assert sq != skv or name != "mma_sync"


@functools.cache
def _jax_reference(d):
    """Inputs (q, k, v, dO, out, lse) and the JAX kernels' (dq, dk, dv) at
    SHAPES[d], batch-heads 2."""
    sq, skv = SHAPES[d]
    rng = np.random.default_rng(d + 1)
    q, k, v = (rng.standard_normal((2, s, d)).astype(np.float32) for s in (sq, skv, skv))
    g = rng.standard_normal((2, sq, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                              block_q=128, block_k=128, interpret=True, with_lse=True)
    want = _flash_backward_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                                jnp.asarray(g), scale, block_q=128, block_k=128, interpret=True)
    return (q, k, v, g, np.asarray(out), np.asarray(lse)), tuple(np.asarray(x) for x in want)


@pytest.mark.parametrize("which,variant,d", [(which, name, d)
                                             for which, table in BWD_VARIANTS.items()
                                             for name, dims in table.items() for d in dims])
def test_each_bwd_variant_on_cpu_matches_jax_kernels(which, variant, d):
    """On CPU tensors every variant runs the plain version (the bits of
    flash_backward_ref) and counts no launch; it matches the JAX package's
    B4 / B5 in interpret mode."""
    arrays, (want_dq, want_dk, want_dv) = _jax_reference(d)
    tq, tk, tv, tg, tout, tlse = (torch.tensor(x) for x in arrays)
    tdelta = (tg * tout).sum(-1)  # as flash_backward_ref computes it
    scale = 1.0 / np.sqrt(d)
    before = {w: dict(n) for w, n in flash_attention.flash_backward_variant.launches.items()}
    bare = (flash_attention.flash_backward_dkdv.launches,
            flash_attention.flash_backward_dq.launches)
    got = flash_attention.flash_backward_variant(tq, tk, tv, tg, tlse, tdelta, scale, variant,
                                                 which)
    ref_dq, ref_dk, ref_dv = flash_attention.flash_backward_ref(tq, tk, tv, tout, tlse, tg, scale)
    if which == "dkdv":
        pairs = [("dk", got[0], ref_dk, want_dk), ("dv", got[1], ref_dv, want_dv)]
    else:
        pairs = [("dq", got, ref_dq, want_dq)]
    for name, a, ref, want in pairs:
        torch.testing.assert_close(a, ref, rtol=0, atol=0)
        np.testing.assert_allclose(a.numpy(), want, atol=ATOL, err_msg=name)
    assert flash_attention.flash_backward_variant.launches == before
    assert (flash_attention.flash_backward_dkdv.launches,
            flash_attention.flash_backward_dq.launches) == bare


def test_bwd_variants_refuse_what_they_are_not_built_for():
    """An unknown kernel or variant, and a head dim the variant is not built
    for, raise (on any device), naming what they take."""
    x, rows = torch.zeros(2, 8, 64), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="dkdv, dq"):
        flash_attention.flash_backward_variant(x, x, x, x, rows, rows, 0.1, "wg2_q64", "dqdk")
    for which, table in BWD_VARIANTS.items():
        with pytest.raises(ValueError, match="mma_sync"):
            flash_attention.flash_backward_variant(x, x, x, x, rows, rows, 0.1, "wg3_q256",
                                                   which)
    missing = [(which, name, d) for which, table in BWD_VARIANTS.items()
               for name, dims in table.items() for d in flash_attention.HEAD_DIMS
               if d not in dims]
    assert ("dq", "wg2_kv128", 160) in missing
    for which, name, d in missing:
        x = torch.zeros(2, 8, d)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_backward_variant(x, x, x, x, rows, rows, 0.1, name, which)
