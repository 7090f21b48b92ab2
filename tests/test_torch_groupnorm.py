"""The port's fused GroupNorm (pea_diffusion_tpu_torch/ops/groupnorm.py) held
against the JAX package's, on the CPU: the plain version of B6 and B6-b
against the JAX ``fused_group_norm`` run in interpret mode (the Pallas
kernel's own arithmetic) and against its ``group_norm``, for act none and
silu, with and without the per-(sample, channel) bias t; the autograd
Functions' gradients in x, t, scale and bias against ``jax.vjp`` of the JAX
fused function; the opt-in gate's table; the GroupNorm module with the
opt-in on (the CPU never takes the kernel); a channels-last input; and the
wrapper's layout, vector width and chunking rules, which the CUDA kernels
rely on and which this host can reach. The kernels themselves run in
tests/test_torch_kernels_on_card.py.

Tolerances: fp32 atol 2e-5 (as tests/test_fused_groupnorm.py holds the
Pallas kernel), gradients 3e-4; bf16 3e-2 (one bf16 rounding of outputs of
order 1, taken at other points in each framework).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import host_params, sub_state_dict, t
from pea_diffusion_tpu.models import layers as J
from pea_diffusion_tpu.ops import groupnorm as JG
from pea_diffusion_tpu_torch.models import layers as P
from pea_diffusion_tpu_torch.ops import groupnorm as G


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return t(x).permute(0, 3, 1, 2).contiguous()


def _inputs(shape, seed):
    n, _, _, c = shape
    x = _rand(*shape, seed=seed) * 2 + 1
    scale = 1 + 0.1 * _rand(c, seed=seed + 1)
    bias = 0.1 * _rand(c, seed=seed + 2)
    tb = _rand(n, c, seed=seed + 3)
    return x, scale, bias, tb


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((3, 4, 6, 16), 4)])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("with_t", [False, True])
def test_plain_version_matches_jax_kernel_and_group_norm(shape, groups, act, with_t):
    x, scale, bias, tb = _inputs(shape, seed=len(shape) + groups)
    tb = tb if with_t else None
    want = JG.fused_group_norm(jnp.asarray(x), scale, bias, groups, 1e-5, act=act,
                               extra_bias=None if tb is None else jnp.asarray(tb),
                               interpret=True)
    ref = JG._reference_gn(jnp.asarray(x), scale, bias, groups, 1e-5, act,
                           None if tb is None else jnp.asarray(tb))
    got = G.fused_gn_ref(_nchw(x), t(scale), t(bias), groups, 1e-5, act,
                         None if tb is None else t(tb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # the CPU path of each wrapper is the plain version
    fn = (G.group_norm_fwd(_nchw(x), t(scale), t(bias), groups, 1e-5, act) if tb is None
          else G.group_norm_bias_fwd(_nchw(x), t(tb), t(scale), t(bias), groups, 1e-5, act))
    np.testing.assert_array_equal(fn.permute(0, 2, 3, 1).numpy(), got.numpy())


@pytest.mark.parametrize("with_t", [False, True])
def test_plain_version_bf16_matches_jax(with_t):
    x, scale, bias, tb = _inputs((2, 4, 4, 32), seed=7)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = JG.fused_group_norm(xb, scale, bias, 8, 1e-5, act="silu",
                               extra_bias=jnp.asarray(tb) if with_t else None,
                               interpret=True)
    xt = _nchw(np.array(xb.astype(jnp.float32))).bfloat16()
    got = G.fused_gn_ref(xt, t(scale), t(bias), 8, 1e-5, "silu",
                         t(tb) if with_t else None)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("act,with_t", [("none", False), ("silu", False), ("silu", True),
                                        ("none", True)])
def test_function_gradients_match_jax(act, with_t):
    """x, t, scale, bias gradients through FusedGroupNorm / FusedGroupNormBias
    against jax.vjp of the JAX fused function (its custom VJP)."""
    x, scale, bias, tb = _inputs((2, 4, 4, 32), seed=11)
    g = _rand(2, 4, 4, 32, seed=12)
    if with_t:
        fn = lambda x, s, b, tb: JG.fused_group_norm(  # noqa: E731
            x, s, b, 8, 1e-5, act=act, extra_bias=tb, interpret=True)
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, scale, bias, tb)))
    else:
        fn = lambda x, s, b: JG.fused_group_norm(x, s, b, 8, 1e-5, act=act,  # noqa: E731
                                                 interpret=True)
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    xs, ss, bs, ts = (v.requires_grad_(True) for v in (_nchw(x), t(scale), t(bias), t(tb)))
    y = G.fused_group_norm(xs, ss, bs, 8, 1e-5, act, ts if with_t else None)
    name = "FusedGroupNormBiasBackward" if with_t else "FusedGroupNormBackward"
    assert type(y.grad_fn).__name__ == name
    y.backward(_nchw(g))
    got = [xs.grad.permute(0, 2, 3, 1), ss.grad, bs.grad] + ([ts.grad] if with_t else [])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


def test_function_returns_only_the_gradients_asked_for():
    x, scale, bias, tb = _inputs((1, 4, 4, 16), seed=13)
    xs = _nchw(x).requires_grad_(True)
    y = G.fused_group_norm(xs, t(scale), t(bias), 4, 1e-5, "silu", t(tb))
    y.sum().backward()
    assert xs.grad is not None and xs.grad.abs().max() > 0
    with torch.no_grad():  # no gradient needed: the bare wrapper, no history
        assert G.fused_group_norm(xs, t(scale), t(bias), 4).grad_fn is None


def test_function_backward_under_checkpointing():
    """KD training runs the frozen UNet under non-reentrant checkpointing,
    which lets a Function's backward unpack its saved tensors only once."""
    from torch.utils.checkpoint import checkpoint

    x, scale, bias, tb = _inputs((2, 4, 4, 16), seed=17)
    xs = _nchw(x).requires_grad_(True)

    def f(v):
        return G.fused_group_norm(v * 1.5, t(scale), t(bias), 4, 1e-5, "silu", t(tb))

    checkpoint(f, xs, use_reentrant=False).square().sum().backward()
    ref_x = _nchw(x).requires_grad_(True)
    G.fused_gn_ref(ref_x * 1.5, t(scale), t(bias), 4, 1e-5, "silu", t(tb)).square().sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), ref_x.grad.numpy(), atol=1e-5)


def _fake(ndim=4, channels=32, cuda=True):
    return SimpleNamespace(ndim=ndim, shape=(2, channels, 8, 8)[:ndim] + (8,) * (ndim - 4),
                           is_cuda=cuda)


@pytest.mark.parametrize("env,x,groups,want", [
    (None, _fake(), 8, False),                 # opt-in unset
    ("0", _fake(), 8, False),                  # opt-in off
    ("true", _fake(), 8, False),               # only "1" turns it on
    ("1", _fake(), 8, True),                   # a 4-d CUDA tensor, 32 = 8 groups of 4
    ("1", _fake(ndim=3), 8, False),            # not 4-d
    ("1", _fake(channels=30), 8, False),       # channels not divisible by groups
    ("1", _fake(channels=960), 32, True),      # no 128-lane rule (960 % 128 != 0)
    ("1", _fake(cuda=False), 8, False),        # a CPU tensor: the plain version
])
def test_gate_table(monkeypatch, env, x, groups, want):
    if env is None:
        monkeypatch.delenv("PEA_FUSED_GROUPNORM", raising=False)
    else:
        monkeypatch.setenv("PEA_FUSED_GROUPNORM", env)
    assert G.fused_gn_applicable(x, groups) is want


def test_gate_reads_the_environment_at_call_time(monkeypatch):
    x = _fake()
    monkeypatch.setenv("PEA_FUSED_GROUPNORM", "1")
    assert G.fused_gn_applicable(x, 8)
    monkeypatch.setenv("PEA_FUSED_GROUPNORM", "0")
    assert not G.fused_gn_applicable(x, 8)


@pytest.mark.parametrize("act,with_t", [("silu", True), ("none", False)])
def test_group_norm_module_with_opt_in_matches_jax(monkeypatch, act, with_t):
    """With PEA_FUSED_GROUPNORM=1 the CPU keeps the plain path, and the
    module agrees with the JAX module (whose gate needs a TPU)."""
    monkeypatch.setenv("PEA_FUSED_GROUPNORM", "1")
    x, tb = _rand(2, 4, 4, 32), _rand(2, 32, seed=1)
    jm = J.GroupNorm(8, 1e-5, act=act)
    params = host_params(jm, x, tb if with_t else None)
    pm = P.GroupNorm(32, 8, 1e-5, act=act)
    pm.load_state_dict(sub_state_dict("norm", params["params"]), strict=True)
    got = pm(_nchw(x), t(tb) if with_t else None).permute(0, 2, 3, 1)
    want = jm.apply(params, x, extra_bias=tb if with_t else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("batch", [2, 3])
def test_plain_version_takes_channels_last(batch):
    """Transformer2D hands on channels-last tensors: the plain version gives
    the same values for either layout, in the input's shape."""
    x, scale, bias, tb = _inputs((batch, 6, 5, 16), seed=21)
    dense = _nchw(x)
    cl = dense.contiguous(memory_format=torch.channels_last)
    assert G.layout(dense) == "nchw" and G.layout(cl) == "nhwc"
    assert G.layout(dense[:, :, :, 1:]) == "strided"
    for tb_ in (None, t(tb)):
        a = G.fused_gn_ref(dense, t(scale), t(bias), 4, 1e-5, "silu", tb_)
        b = G.fused_gn_ref(cl, t(scale), t(bias), 4, 1e-5, "silu", tb_)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


@pytest.mark.parametrize("row,size,ptr,want", [
    (16384, 2, 0, 8),      # SDXL level 0 H*W, bf16
    (900, 2, 0, 4),        # 30x30: not a multiple of 8
    (30, 2, 0, 2),         # channels-last row of 30 channels
    (31, 2, 0, 1),
    (960, 4, 0, 4),        # fp32: at most 16 bytes
    (1024, 2, 4, 2),       # a view 4 bytes past an aligned address
])
def test_vector_width(row, size, ptr, want):
    assert G.vector_width(row, size, ptr) == want


@pytest.mark.parametrize("n,c,hw,groups,nhwc,vec", [
    (2, 320, 128 * 128, 32, False, 8),
    (2, 1280, 32 * 32, 32, False, 8),
    (1, 128, 1024 * 1024, 32, False, 8),
    (2, 2560, 32 * 32, 32, True, 8),
    (2, 960, 64 * 64, 32, True, 8),
    (1, 30, 7, 3, True, 2),
    (2, 64, 9, 32, False, 1),
])
def test_chunk_plan_covers_the_map(n, c, hw, groups, nhwc, vec):
    """Every chunk count is at least 1, cuts no more finely than 4 vectors a
    thread, and fills the card for the large maps."""
    chunks = G.plan(n, c, hw, groups, nhwc, vec)
    blocks = n * chunks * (1 if nhwc else groups)
    assert chunks >= 1
    if nhwc:
        assert chunks <= max(1, hw)
    else:
        per_group = c // groups * hw // vec
        assert chunks <= max(1, -(-per_group // G.THREADS))
    if n * c * hw >= 2**24:
        assert blocks >= G.TARGET_BLOCKS


def test_bare_wrappers_on_cpu_are_differentiable_plain_versions():
    x, scale, bias, tb = _inputs((2, 4, 4, 16), seed=3)
    xs = _nchw(x).requires_grad_(True)
    G.group_norm_bias_fwd(xs, t(tb), t(scale), t(bias), 4, 1e-5, "silu").sum().backward()
    assert xs.grad is not None
    assert G.group_norm_fwd.launches == 0 and G.group_norm_bias_fwd.launches == 0
