"""The port's UNet/VAE building blocks (pea_diffusion_tpu_torch/models/layers.py)
held against the JAX package's, in fp32 on the CPU, at the same weights
(carried over by checkpoints/from_jax.py) and the same seeded inputs.

Tolerance: atol 1e-4 on outputs of order 1 — the same math in fp32 whose
sums run in another order in each framework.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import host_params, sub_state_dict, t
from pea_diffusion_tpu.models import layers as J
from pea_diffusion_tpu_torch.models import layers as P
from pea_diffusion_tpu_torch.ops import groupnorm as P_gn

ATOL = 1e-4


def _nhwc_to_nchw(x):
    return t(x).permute(0, 3, 1, 2)


def _close(got, want, nchw=False):
    if nchw:
        got = got.permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module


def test_timestep_embedding():
    ts = np.array([0, 1, 499, 999], np.int32)
    for flip in (True, False):
        want = J.timestep_embedding(jnp.asarray(ts), 32, flip, 1.0)
        got = P.timestep_embedding(torch.from_numpy(ts), 32, flip, 1.0)
        _close(got, want)


def test_timestep_embedding_module():
    x = _rand(2, 16)
    jm = J.TimestepEmbedding(32)
    params = host_params(jm, x)
    sd = {f"{n}.{k}": v for n in ("linear_1", "linear_2")
          for k, v in sub_state_dict("lin", params["params"][n], prefix=n).items()}
    _close(_load(P.TimestepEmbedding(16, 32), sd)(t(x)), jm.apply(params, x))


@pytest.mark.parametrize("batch", [2, 3])  # the two group_norm forms
def test_group_norm_both_forms(batch):
    x = _rand(batch, 4, 5, 16) * 3 + 1
    rng = np.random.default_rng(1)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    want = J.group_norm(jnp.asarray(x), scale, bias, 4, 1e-5)
    got = P.group_norm(_nhwc_to_nchw(x), t(scale), t(bias), 4, 1e-5)
    _close(got, want, nchw=True)


@pytest.mark.parametrize("knob", ["1", "0", None])
@pytest.mark.parametrize("batch", [1, 3])
def test_group_norm_knob_pins_the_form(monkeypatch, knob, batch):
    """PEA_GN_GROUPED=1 pins the grouped form and =0 the per-channel sums,
    at any batch; unset, batch <= 2 takes the grouped one. The port's
    group_norm matches the JAX one under the same setting and gives the bits
    of the form the setting names. The input sits far from 0, where the
    one-pass statistics of the two forms round differently."""
    if knob is None:
        monkeypatch.delenv("PEA_GN_GROUPED", raising=False)
    else:
        monkeypatch.setenv("PEA_GN_GROUPED", knob)
    x = _rand(batch, 6, 7, 16) + 3
    rng = np.random.default_rng(2)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    args = (_nhwc_to_nchw(x), t(scale), t(bias), 4, 1e-5)
    got = P.group_norm(*args)
    grouped, sums = P_gn.group_norm_grouped(*args), P_gn.group_norm_sums(*args)
    assert not torch.equal(grouped, sums)
    assert torch.equal(got, grouped if knob == "1" or (knob is None and batch <= 2) else sums)
    _close(got, J.group_norm(jnp.asarray(x), scale, bias, 4, 1e-5), nchw=True)


@pytest.mark.parametrize("batch", [2, 3])
def test_group_norm_module_extra_bias_silu(batch):
    x, tb = _rand(batch, 4, 4, 16), _rand(batch, 16, seed=1)
    jm = J.GroupNorm(4, 1e-5, act="silu")
    params = host_params(jm, x, tb)
    sd = sub_state_dict("norm", params["params"])
    got = _load(P.GroupNorm(16, 4, 1e-5, act="silu"), sd)(_nhwc_to_nchw(x), t(tb))
    _close(got, jm.apply(params, x, extra_bias=tb), nchw=True)


@pytest.mark.parametrize("cin,cout,temb", [(16, 32, 64), (32, 32, None)])
def test_resnet_block(cin, cout, temb):
    x = _rand(2, 8, 8, cin)
    te = None if temb is None else _rand(2, temb, seed=1)
    jm = J.ResnetBlock2D(cout, norm_num_groups=8)
    params = host_params(jm, x, te)
    pm = _load(P.ResnetBlock2D(cin, cout, temb, 8),
               sub_state_dict("resnet", params["params"]))
    got = pm(_nhwc_to_nchw(x), None if te is None else t(te))
    _close(got, jm.apply(params, x, te), nchw=True)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_down_and_upsample(kind):
    x = _rand(2, 8, 8, 16)
    jm = (J.Downsample2D if kind == "down" else J.Upsample2D)(24)
    params = host_params(jm, x)
    sd = {f"conv.{k}": v for k, v in
          sub_state_dict("conv", params["params"]["conv"], prefix="conv").items()}
    pm = _load((P.Downsample2D if kind == "down" else P.Upsample2D)(16, 24), sd)
    _close(pm(_nhwc_to_nchw(x)), jm.apply(params, x), nchw=True)


@pytest.mark.parametrize("sq,ctx,heads,hd,qkv_bias,backend", [
    (64, None, 2, 16, False, "auto"),   # self-attention, plain path
    (64, 7, 2, 16, False, "auto"),      # cross-attention, plain path
    (64, None, 1, 32, True, "xla"),     # the VAE's single biased head
    (512, None, 2, 64, False, "flash"),  # one-pass route (B1's plain version)
    (300, 7, 2, 64, False, "flash"),    # flash route: head-major split/merge
])
def test_multi_head_attention(sq, ctx, heads, hd, qkv_bias, backend):
    dim = heads * hd
    x = _rand(2, sq, dim)
    c = None if ctx is None else _rand(2, ctx, 24, seed=1)
    jm = J.MultiHeadAttention(heads, hd, qkv_bias=qkv_bias, backend="xla")
    params = host_params(jm, x, c)
    pm = _load(P.MultiHeadAttention(dim, heads, hd, None if c is None else 24,
                                    qkv_bias, backend),
               sub_state_dict("attention", params["params"]))
    route = P.attention_route(sq, sq if ctx is None else ctx, heads, hd,
                              backend, "cpu")
    assert route == {"flash": "onepass" if ctx is None else "flash"}.get(
        backend, "plain")
    _close(pm(t(x), None if c is None else t(c)), jm.apply(params, x, c))


def test_feed_forward_geglu_order():
    x = _rand(2, 5, 32)
    jm = J.FeedForward(32)
    params = host_params(jm, x)
    pm = _load(P.FeedForward(32), sub_state_dict("feed_forward", params["params"]))
    _close(pm(t(x)), jm.apply(params, x))


def test_layer_norm_fp32():
    x = _rand(2, 5, 32) * 2 + 0.5
    jm = J.LayerNormFP32()
    params = host_params(jm, x)
    pm = _load(P.LayerNormFP32(32), sub_state_dict("norm", params["params"]))
    _close(pm(t(x)), jm.apply(params, x))


def test_basic_transformer_block():
    x, c = _rand(2, 16, 32), _rand(2, 7, 24, seed=1)
    jm = J.BasicTransformerBlock(2, 16)
    params = host_params(jm, x, c)
    pm = _load(P.BasicTransformerBlock(32, 2, 16, 24),
               sub_state_dict("transformer_block", params["params"]))
    _close(pm(t(x), t(c)), jm.apply(params, x, c))


@pytest.mark.parametrize("linear", [True, False])
def test_transformer2d(linear):
    x, c = _rand(2, 4, 4, 32), _rand(2, 7, 24, seed=1)
    jm = J.Transformer2D(num_heads=2, head_dim=16, depth=2, norm_num_groups=8,
                         use_linear_projection=linear)
    params = host_params(jm, x, c)
    pm = _load(P.Transformer2D(32, 2, 16, 2, 24, 8, linear),
               sub_state_dict("transformer", params["params"], linear))
    _close(pm(_nhwc_to_nchw(x), t(c)), jm.apply(params, x, c), nchw=True)
