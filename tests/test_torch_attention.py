"""The port's attention kernels (B1 one-pass, B3 flash forward) held against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain versions; the tolerance is
the JAX package's own kernel tests' (fp32, atol 2e-5). The kernels
themselves are compared with the plain versions on the card by
test_torch_kernels_on_card.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pea_diffusion_tpu.ops import attention as jax_attention
from pea_diffusion_tpu.ops.flash_attention import _flash_forward
from pea_diffusion_tpu.ops.flash_attention import flash_attention as jax_flash
from pea_diffusion_tpu.ops.onepass_attention import onepass_forward as jax_onepass
from pea_diffusion_tpu.ops.onepass_attention import supports as jax_supports
from pea_diffusion_tpu_torch.models.layers import attention_route
from pea_diffusion_tpu_torch.ops import flash_attention, onepass_attention
from pea_diffusion_tpu_torch.ops.attention import dot_product_attention

ATOL = 2e-5


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32),
            rng.standard_normal(shape_kv).astype(np.float32))


@pytest.mark.parametrize("b,sq,skv,h,d", [
    (1, 256, 512, 2, 64),    # aligned
    (1, 256, 600, 2, 64),    # ragged KV: the kernel masks past kv_len
    (1, 256, 512, 2, 128),   # one 128-wide head per lane group
])
def test_onepass_ref_matches_jax_kernel(b, sq, skv, h, d):
    q, k, v = _qkv((b, sq, h * d), (b, skv, h * d), seed=skv + d)
    want = jax_onepass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, d,
                       interpret=True)
    got = onepass_attention.onepass_forward(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_ref_matches_jax_kernel(with_lse):
    bh, sq, skv, d = 2, 300, 77, 64
    q, k, v = _qkv((bh, sq, d), (bh, skv, d), seed=7)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    scale = 1.0 / np.sqrt(d)
    if with_lse:
        want, want_lse = _flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
            block_q=128, block_k=128, interpret=True, with_lse=True)
        got, got_lse = flash_attention.flash_forward(tq, tk, tv, scale,
                                                     with_lse=True)
        assert got_lse.dtype == torch.float32 and got_lse.shape == (bh, sq)
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                                   atol=ATOL)
    else:
        want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         scale=scale, block_q=128, block_k=128, interpret=True)
        got = flash_attention.flash_forward(tq, tk, tv, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_cpu_wrappers_run_plain_versions_without_launching():
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 64, 128), (1, 64, 128), 3))
    b1, b3 = onepass_attention.onepass_forward.launches, \
        flash_attention.flash_forward.launches
    out = onepass_attention.onepass_forward(q, k, v, 2, 64)
    torch.testing.assert_close(
        out, onepass_attention.onepass_forward_ref(q, k, v, 2, 64), rtol=0, atol=0)
    qm = q.reshape(1, 64, 2, 64).transpose(1, 2).reshape(2, 64, 64)
    out = dot_product_attention(qm, qm, qm, backend="flash")
    torch.testing.assert_close(
        out, flash_attention.flash_forward_ref(qm, qm, qm), rtol=0, atol=0)
    assert onepass_attention.onepass_forward.launches == b1
    assert flash_attention.flash_forward.launches == b3


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No silent fallback: a CUDA call whose kernel cannot be built raises."""
    from pea_diffusion_tpu_torch.ops import kernel_build

    monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "kernels")
    assert not kernel_build.library_path().exists()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_build.build()


def _jax_route(sq, skv, heads, head_dim, backend):
    """layers.py:272-298 of the JAX package, as it dispatches on a TPU."""
    if jax_attention.use_flash(sq, backend):
        if jax_supports(sq, skv, heads, head_dim):
            return "onepass"
        return "flash"
    return "plain"


@pytest.mark.parametrize("sq,skv,heads,head_dim,backend,want", [
    (4096, 4096, 10, 64, "auto", "onepass"),   # SDXL self-attention, level 1
    (1024, 1024, 20, 64, "auto", "onepass"),   # SDXL self-attention, level 2
    (4096, 52, 10, 64, "auto", "flash"),       # SDXL cross-attention, level 1
    (1024, 52, 20, 64, "auto", "flash"),       # SDXL cross-attention, level 2
    (1024, 77, 20, 64, "auto", "flash"),       # 77-token cross-attention
    (256, 256, 2, 64, "auto", "plain"),        # short S
    (52, 52, 16, 64, "auto", "plain"),         # the text tower
    (16384, 16384, 1, 512, "xla", "plain"),    # the VAE mid attention
])
def test_dispatch_matches_jax_on_card(monkeypatch, sq, skv, heads, head_dim,
                                      backend, want):
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    assert _jax_route(sq, skv, heads, head_dim, backend) == want
    assert attention_route(sq, skv, heads, head_dim, backend, "cuda") == want
    # on a CPU tensor, "auto" always takes the plain path
    if backend == "auto":
        assert attention_route(sq, skv, heads, head_dim, backend, "cpu") == "plain"
