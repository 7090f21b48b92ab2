"""The port's attention kernels (B1 one-pass, B3 flash forward, B4/B5 flash
backward) and the differentiable functions over them (flash_attention,
bshd_attention) held against the JAX package's Pallas kernels and custom
VJPs, run in interpret mode on the CPU, at SDXL's head dim 64 and SD1.5's
40, 80 and 160 (which the JAX kernels pad to 128 or 256 lanes, and the
port's do not).

On the CPU the port's wrappers run their plain versions; the tolerance is
the JAX package's own kernel tests' (fp32, atol 2e-5 forward, 2e-4 to 3e-4
for gradients, as tests/test_flash_vjp.py). The kernels themselves are
compared with the plain versions on the card by
test_torch_kernels_on_card.py.
"""
import jax
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


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("d,sq,skv", [
    (40, 300, 77),    # SD1.5 level-0 heads; teacher-length KV
    (40, 130, 200),   # ragged Sq and Skv over blocks of 128
    (80, 300, 52),    # SD1.5 level-1 heads; student-length KV
    (80, 257, 300),
    (160, 300, 52),   # SD1.5 level-2 and mid-block heads (flash route at 1024²)
    (160, 257, 300),
])
def test_flash_ref_matches_jax_kernel_sd15_head_dims(d, sq, skv, with_lse):
    bh = 2
    q, k, v = _qkv((bh, sq, d), (bh, skv, d), seed=d + sq + skv)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    scale = 1.0 / np.sqrt(d)  # the true head dim's, as JAX takes it before padding
    want = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                          block_q=128, block_k=128, interpret=True, with_lse=with_lse)
    got = flash_attention.flash_forward(tq, tk, tv, with_lse=with_lse)
    if with_lse:
        (want, want_lse), (got, got_lse) = want, got
        np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL)
    assert got.shape == (bh, sq, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_kernel_shape_check_names_the_head_dim():
    """What the CUDA kernels take: head dims 40, 64, 80, 128 and 160
    (SD1.5's level 2 and mid block). Any other raises before a launch,
    naming the width."""
    assert 160 in flash_attention.HEAD_DIMS
    for d in flash_attention.HEAD_DIMS:
        x = torch.zeros(2, 8, d)
        flash_attention._check_shapes("flash kernel", x, x, x)
    for d in (32, 48, 96, 256):
        x = torch.zeros(2, 8, d)
        with pytest.raises(ValueError, match=f"head_dim {d} "):
            flash_attention._check_shapes("flash kernel", x, x, x)


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
    (4096, 4096, 8, 40, "auto", "flash"),      # SD1.5 self-attention, level 0
    (4096, 52, 8, 40, "auto", "flash"),        # SD1.5 cross-attention, level 0
    (4096, 77, 8, 40, "auto", "flash"),        # SD1.5 teacher cross-attention
    (1024, 1024, 8, 80, "auto", "flash"),      # SD1.5 self-attention, level 1
    (1024, 52, 8, 80, "auto", "flash"),        # SD1.5 cross-attention, level 1
    (256, 256, 8, 160, "auto", "plain"),       # SD1.5 level 2 at 512², mid block at 1024²
    (64, 52, 8, 160, "auto", "plain"),         # SD1.5 mid block at 512²
    (1024, 1024, 8, 160, "auto", "flash"),     # SD1.5 self-attention, level 2 at 1024²
    (1024, 52, 8, 160, "auto", "flash"),       # SD1.5 cross-attention, level 2 at 1024²
    (16384, 16384, 8, 40, "auto", "flash"),    # SD1.5 self-attention, level 0 at 1024²
])
def test_dispatch_matches_jax_on_card(monkeypatch, sq, skv, heads, head_dim,
                                      backend, want):
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    assert _jax_route(sq, skv, heads, head_dim, backend) == want
    assert attention_route(sq, skv, heads, head_dim, backend, "cuda") == want
    # on a CPU tensor, "auto" always takes the plain path
    if backend == "auto":
        assert attention_route(sq, skv, heads, head_dim, backend, "cpu") == "plain"


@pytest.mark.parametrize("sq,skv,heads,head_dim", [
    (4096, 4096, 10, 64), (1024, 52, 20, 64), (4096, 4096, 8, 40), (1024, 1024, 8, 160),
])
def test_disable_flash_makes_the_auto_routes_plain(monkeypatch, sq, skv, heads, head_dim):
    """PEA_DISABLE_FLASH turns the "auto" backend's kernel routes plain, as
    in the JAX package; "flash" still forces the kernels, in both."""
    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("PEA_DISABLE_FLASH", "1")
    assert _jax_route(sq, skv, heads, head_dim, "auto") == "plain"
    assert attention_route(sq, skv, heads, head_dim, "auto", "cuda") == "plain"
    forced = attention_route(sq, skv, heads, head_dim, "flash", "cuda")
    assert forced == _jax_route(sq, skv, heads, head_dim, "flash") != "plain"


def test_disable_flash_makes_the_smoke_route_walk_plain(monkeypatch):
    """chip_smoke.py's walk of the SDXL UNet's attention modules (meta
    device) at 1024²: onepass and flash calls without the knob, all plain
    with it."""
    import chip_smoke
    from pea_diffusion_tpu_torch.configs import SDXL_UNET
    from pea_diffusion_tpu_torch.models import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(SDXL_UNET)
    monkeypatch.delenv("PEA_DISABLE_FLASH", raising=False)
    routes = chip_smoke.attention_routes(unet, 128, 52)
    assert {r for r, *_ in routes} == {"onepass", "flash"}
    monkeypatch.setenv("PEA_DISABLE_FLASH", "1")
    plain = chip_smoke.attention_routes(unet, 128, 52)
    assert {r for r, *_ in plain} == {"plain"}
    assert sum(plain.values()) == sum(routes.values()) == 140


# --- the backward (B4, B5) and the autograd Functions -------------------------

BWD_ATOL = 2e-4  # fp32, as tests/test_flash_vjp.py


@pytest.mark.parametrize("sq,skv", [(384, 300), (300, 52)])
def test_flash_backward_ref_matches_jax_kernels(sq, skv):
    """Several Q and KV blocks of 128 and a ragged KV tail on the JAX side."""
    from pea_diffusion_tpu.ops.flash_attention import _flash_backward_impl

    bh, d = 2, 64
    q, k, v = _qkv((bh, sq, d), (bh, skv, d), seed=sq + skv)
    g = np.random.default_rng(5).standard_normal((bh, sq, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                              block_q=128, block_k=128, interpret=True, with_lse=True)
    want = _flash_backward_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                                jnp.asarray(g), scale, block_q=128, block_k=128,
                                interpret=True)
    got = flash_attention.flash_backward(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_ATOL, err_msg=name)


@pytest.mark.parametrize("d,sq,skv", [(40, 384, 300), (40, 300, 77), (80, 300, 52),
                                      (80, 200, 260), (160, 300, 52), (160, 257, 300)])
def test_flash_backward_ref_matches_jax_kernels_sd15_head_dims(d, sq, skv):
    from pea_diffusion_tpu.ops.flash_attention import _flash_backward_impl

    bh = 2
    q, k, v = _qkv((bh, sq, d), (bh, skv, d), seed=d * sq + skv)
    g = np.random.default_rng(6).standard_normal((bh, sq, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                              block_q=128, block_k=128, interpret=True, with_lse=True)
    want = _flash_backward_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                                jnp.asarray(g), scale, block_q=128, block_k=128,
                                interpret=True)
    got = flash_attention.flash_backward(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_ATOL, err_msg=name)


def _jax_grads(fn, arrays, cotangent_fn):
    return jax.grad(lambda *xs: cotangent_fn(fn(*xs)), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in arrays))


@pytest.mark.parametrize("shape_q,shape_kv,scale,loss", [
    ((2, 130, 32), (2, 70, 32), 0.2, "cos"),
    ((1, 384, 64), (1, 300, 64), None, "square"),
])
def test_flash_attention_grads_match_jax(shape_q, shape_kv, scale, loss):
    q, k, v = _qkv(shape_q, shape_kv, seed=shape_q[1])
    jloss = (lambda o: jnp.sum(o * jnp.cos(o))) if loss == "cos" else (lambda o: jnp.sum(o ** 2))
    tloss = (lambda o: (o * torch.cos(o)).sum()) if loss == "cos" else (lambda o: (o ** 2).sum())
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, scale, 128, 128, True),
                      (q, k, v), jloss)
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention.flash_attention(*ts, scale)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(tloss(out), ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


@pytest.mark.parametrize("d,sq,skv", [(40, 260, 77), (80, 300, 300), (160, 300, 52),
                                      (160, 257, 300)])
def test_flash_attention_grads_match_jax_sd15_head_dims(d, sq, skv):
    """The differentiable flash_attention (B3 with lse, B4, B5) against the
    JAX custom VJP at SD1.5's head dims, default scale 1/sqrt(D)."""
    q, k, v = _qkv((2, sq, d), (2, skv, d), seed=sq + d)
    want = _jax_grads(lambda a, b, c: jax_flash(a, b, c, None, 128, 128, True),
                      (q, k, v), lambda o: jnp.sum(o * jnp.cos(o)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = flash_attention.flash_attention(*ts)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad((out * torch.cos(out)).sum(), ts)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


def test_bshd_attention_grads_match_jax():
    from pea_diffusion_tpu.ops.onepass_attention import bshd_attention as jax_bshd

    b, sq, skv, h, d = 1, 256, 520, 2, 64
    q, k, v = _qkv((b, sq, h * d), (b, skv, h * d), seed=9)
    want = _jax_grads(lambda x, y, z: jax_bshd(x, y, z, h, d, None, True), (q, k, v),
                      lambda o: jnp.sum(o ** 2))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = onepass_attention.bshd_attention(*ts, h, d)
    assert type(out.grad_fn).__name__ == "BSHDAttentionBackward"
    got = torch.autograd.grad((out ** 2).sum(), ts)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=2e-4)
    # without a gradient the primal is the one-pass forward
    with torch.no_grad():
        torch.testing.assert_close(onepass_attention.bshd_attention(*ts, h, d),
                                   onepass_attention.onepass_forward_ref(*ts, h, d))


def _function_nodes(t, depth=6):
    """Names of the autograd nodes within `depth` steps of t.grad_fn."""
    names, frontier = set(), [t.grad_fn]
    for _ in range(depth):
        nxt = []
        for node in frontier:
            if node is None:
                continue
            names.add(type(node).__name__)
            nxt += [n for n, _ in node.next_functions]
        frontier = nxt
    return names


@pytest.mark.parametrize("context_len,route,node", [
    (None, "onepass", "BSHDAttentionBackward"),
    (52, "flash", "FlashAttentionBackward"),
])
def test_attention_module_grads_go_through_the_functions(context_len, route, node):
    """backend="flash" takes both kernel routes on the CPU: the attention
    output hangs off the route's Function, and the input gradients equal
    the plain route's."""
    from pea_diffusion_tpu_torch.models.layers import MultiHeadAttention

    torch.manual_seed(0)
    attn = MultiHeadAttention(32, 2, 64, context_dim=context_len and 24, backend="flash")
    attn.requires_grad_(False)
    x = torch.randn(1, 512, 32)
    ctx = None if context_len is None else torch.randn(1, context_len, 24)
    assert attention_route(512, context_len or 512, 2, 64, "flash", "cpu") == route
    seen = {}
    attn.to_out[0].register_forward_hook(lambda m, inp, out: seen.update(inp=inp[0]))

    def grads(backend):
        attn.backend = backend
        xs = x.clone().requires_grad_(True)
        cs = None if ctx is None else ctx.clone().requires_grad_(True)
        attn(xs, cs).pow(2).sum().backward()
        return [t.grad for t in (xs, cs) if t is not None]

    got = grads("flash")
    assert node in _function_nodes(seen["inp"])
    want = grads("xla")
    assert node not in _function_nodes(seen["inp"])
    for a, b in zip(got, want):
        assert a.abs().max() > 0
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


def test_smoke_route_walk_of_sd15_at_1024():
    """chip_smoke.py's walk of the SD1.5 UNet's attention modules (meta
    device, no weights) at a 1024² image (latent 128): per forward 30 flash
    calls, 10 of them at level 2 with head dim 160 (5 self, 5 cross), and
    the mid block's 2 calls plain at S = 256; at 512² D = 160 runs plain
    only."""
    from collections import Counter

    import chip_smoke
    from pea_diffusion_tpu_torch.configs import SD15_UNET
    from pea_diffusion_tpu_torch.models import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(SD15_UNET)
    calls = list(chip_smoke.attention_calls(unet, 128, 52))
    by_dim = Counter((route, d) for route, _, _, d in calls)
    assert by_dim == {("flash", 40): 10, ("flash", 80): 10, ("flash", 160): 10,
                      ("plain", 160): 2}
    assert Counter(c[:3] for c in calls if c[3] == 160) == {
        ("flash", 1024, 1024): 5, ("flash", 1024, 52): 5, ("plain", 256, 256): 1,
        ("plain", 256, 52): 1}
    assert chip_smoke.routes_by_head_dim(unet, 64, 52) == {
        ("flash", 40): 10, ("flash", 80): 10, ("plain", 160): 12}
    assert sum(chip_smoke.attention_routes(unet, 128, 52).values()) == len(calls) == 32


def test_smoke_names_each_kernel_in_its_build_lines():
    """chip_smoke.py's [build] lines: one per compiled kernel, its name
    (namespaces below pea kept), element type and integer and bool template
    arguments (the wgmma body's head dim, warpgroups, K/V tile rows, stages
    and fill mode; the persistent GroupNorm's vector width and layout), with
    ptxas's registers, static shared memory and spills; a wgmma
    serialisation warning as it stands."""
    import chip_smoke

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN3pea20attention_fwd_kernelI13__nv_bfloat16Li160ELi64ELi64ELi2EEEvNS_10AttnParamsE'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for x",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 238 registers, used 1 barriers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN3pea30attention_bwd_dkdv_wide_kernelI6__halfLi160EEEvNS_9BwdParamsE' for 'sm_90a'",
        "    80 bytes stack frame, 80 bytes spill stores, 80 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN3pea2gn10stats_nhwcIfLi4EEEvNS0_8GnParamsE'"
        " for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 54 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN3pea2gn13gn_persistentI13__nv_bfloat16Li8ELb1EEEvNS0_7PParamsE' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 64 bytes smem, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN3pea4sm9022wgmma_attention_kernelI6__half"
        "Li160ELi2ELi64ELi2ELi1EEEvNS0_6ParamsE14CUtensorMap_stS3_S3_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN3pea4sm9022wgmma_attention_kernelI6__half"
        "Li160ELi2ELi64ELi2ELi1EEEvNS0_6ParamsE14CUtensorMap_stS3_S3_",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
        "are serialized due to insufficient register resources for the wgmma pipeline",
        "ptxas info    : Used 128 registers, used 1 barriers, 816 bytes cmem[0]",
    ])
    assert chip_smoke.ptxas_lines(log) == [
        "attention_fwd_kernel<bf16,160,64,64,2>: 238 registers, 0 bytes static smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "attention_bwd_dkdv_wide_kernel<fp16,160>: 255 registers, 0 bytes static smem; "
        "80 bytes stack frame, 80 bytes spill stores, 80 bytes spill loads",
        "gn::stats_nhwc<fp32,4>: 54 registers, 0 bytes static smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "gn::gn_persistent<bf16,8,1>: 128 registers, 64 bytes static smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
        "are serialized due to insufficient register resources for the wgmma pipeline",
        "sm90::wgmma_attention_kernel<fp16,160,2,64,2,1>: 128 registers, 0 bytes static smem; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
    ]


def _mutants():
    from pea_diffusion_tpu_torch.tools import kernel_mutants

    return kernel_mutants.MUTANTS


@pytest.mark.parametrize("n", range(30))
def test_each_kernel_mutant_names_text_of_the_sources(n):
    """tools/kernel_mutants.py plants each fault by replacing text of the
    CUDA sources: every replaced text occurs in its source as often as the
    mutant says, so that no mutant silently stops planting its fault."""
    from pea_diffusion_tpu_torch.tools import kernel_mutants

    assert len(_mutants()) == 30
    what, edits, _ = _mutants()[n]
    csrc = kernel_mutants.REPO / "pea_diffusion_tpu_torch" / "csrc"
    for name, old, new, *count in edits:
        assert old != new
        assert (csrc / name).read_text().count(old) == (count[0] if count else 1), (what, old)
