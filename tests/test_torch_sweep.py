"""S1: the port's sweep of B1's CUDA tile variants
(pea_diffusion_tpu_torch/tools/sweep_onepass.py) against the JAX package's
tools/sweep_onepass.py, whose Pallas variants of the one-pass kernel run here
in interpret mode, and against the CUDA source's table of variants.

On the CPU the variant wrapper runs the plain version; the kernels
themselves are held against it on the card (test_torch_kernels_on_card.py
and chip_smoke.py's sweep phase).
"""
import ast
import functools
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pea_diffusion_tpu_torch.ops import onepass_attention
from pea_diffusion_tpu_torch.tools import sweep_onepass as sw

REPO = Path(__file__).resolve().parent.parent
JAX_TOOL = REPO / "tools" / "sweep_onepass.py"
ATOL = 2e-5  # fp32, as the JAX package's own kernel tests


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_sweep_onepass", JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tool_is_under_the_import_guard():
    """The tool imports no JAX: it is one of the sources whose imports
    test_torch_imports.py checks."""
    import test_torch_imports

    assert REPO / "pea_diffusion_tpu_torch" / "tools" / "sweep_onepass.py" in \
        test_torch_imports.SOURCES


def test_shapes_match_the_jax_tool():
    """--shapes b16 and b2 name the JAX tool's (label, batch, heads, seq,
    head_dim) rows, read from its source."""
    tree = ast.parse(JAX_TOOL.read_text())
    tables = [ast.literal_eval(node.value) for node in ast.walk(tree)
              if isinstance(node, ast.Assign)
              and any(getattr(t, "id", None) == "all_shapes" for t in node.targets)]
    assert len(tables) == 1
    assert {k: [tuple(r) for r in rows] for k, rows in tables[0].items()} == sw.SHAPES
    assert sw.shapes("b16,b2") == sw.SHAPES["b16"] + sw.SHAPES["b2"]


def test_variant_names_match_the_cuda_table():
    """The wrapper's names are the C table's, in its order, each naming its
    template's shape: the mma.sync body's query block, KV tile and stages,
    then the wgmma body's warpgroups and stages (_cpasync: the staged form
    without TMA). shipped_variant is the rule B1 ships by (one warpgroup up
    to kOneWarpgroupMaxSq query rows, two above; kShippedStages, TMA), and
    the mma.sync body's own shipped tile shape (kBlockM, kBlockN, kStages),
    which B1 ran before, is in the table."""
    csrc = REPO / "pea_diffusion_tpu_torch" / "csrc"
    src = (csrc / "attention_fwd.cu").read_text()
    body = src[src.index("constexpr Variant kVariants[] = {"):]
    body = body[:body.index("};")]
    entries = re.findall(r'\{"(\w+)", (\w+)<([^>]*)>\}', body)
    assert tuple(name for name, *_ in entries) == sw.VARIANTS
    for name, fn, args in entries:
        if fn == "launch":
            assert name == "q{}_kv{}_s{}".format(*re.fullmatch(
                r"__nv_bfloat16, 64, (\d+), (\d+), (\d+)", args).groups())
        else:
            assert fn == "wgmma_variant"
            wg, st, mode = re.fullmatch(r"(\d), (\d), (\d)", args).groups()
            assert name == f"wg{wg}_kv128_s{st}" + {"0": "_cpasync", "1": ""}[mode]
    common = (csrc / "attention_common.cuh").read_text()
    mma_sync = tuple(re.search(rf"constexpr int {c} = (\d+);", common).group(1)
                     for c in ("kBlockM", "kBlockN", "kStages"))
    assert "q{}_kv{}_s{}".format(*mma_sync) in sw.VARIANTS
    sm90 = (csrc / "attention_fwd_sm90.cu").read_text()
    stages, max_sq = (int(re.search(rf"constexpr int {c} = (\d+);", sm90).group(1))
                      for c in ("kShippedStages", "kOneWarpgroupMaxSq"))
    assert "sq <= kOneWarpgroupMaxSq ? 1 : 2;" in sm90
    assert re.search(r"warpgroups,\s+kShippedStages, sm90::kTma, device", sm90)
    assert max_sq == sw.ONE_WARPGROUP_MAX_SQ
    for seq, wg in ((1, 1), (max_sq, 1), (max_sq + 1, 2), (4096, 2)):
        assert sw.shipped_variant(seq) == f"wg{wg}_kv128_s{stages}" in sw.VARIANTS
    assert len(set(sw.VARIANTS)) == len(sw.VARIANTS) == 12


def test_without_a_card_the_tool_exits_non_zero():
    """No fallback: on a host without a card the command fails with a
    message and prints no row."""
    proc = subprocess.run([sys.executable, "-m", "pea_diffusion_tpu_torch.tools.sweep_onepass",
                           "--shapes", "b2", "--iters", "1"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr
    assert proc.stdout == ""
    with pytest.raises(RuntimeError, match="CUDA card"):
        sw.sweep("b2", iters=1)


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 96, 128)).astype(np.float32))
               for _ in range(3))
    before = dict(sw.onepass_forward_variant.launches)
    want = onepass_attention.onepass_forward_ref(q, k, v, 2, 64)
    for name in sw.VARIANTS:
        torch.testing.assert_close(sw.onepass_forward_variant(q, k, v, 2, 64, name), want,
                                   rtol=0, atol=0)
    assert sw.onepass_forward_variant.launches == before
    with pytest.raises(ValueError, match="q64_kv64_s2"):
        sw.onepass_forward_variant(q, k, v, 2, 64, "bq128+inter")


@pytest.mark.parametrize("block_q,interleave,use_exp2,batch_block", [
    (128, False, False, 1),   # bq128
    (256, True, True, 1),     # bq256+inter+exp2
    (128, False, True, 2),    # the batch-blocked kernel, bb2+exp2
])
def test_variants_match_the_jax_tools_variants(monkeypatch, block_q, interleave, use_exp2,
                                               batch_block):
    """Every tile variant computes B1's function: the JAX tool's Pallas
    variants (interpret mode) and the port's variant wrapper on the same
    inputs agree in fp32."""
    from jax.experimental import pallas as pl

    tool = _jax_tool()
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    b, h, s, d = 2, 2, 256, 64
    rng = np.random.default_rng(block_q + batch_block)
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    want = tool.forward_variant(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads=h,
                                head_dim=d, block_q=block_q, interleave=interleave,
                                use_exp2=use_exp2, batch_block=batch_block)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for name in sw.VARIANTS:
        got = sw.onepass_forward_variant(tq, tk, tv, h, d, name)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=name)
