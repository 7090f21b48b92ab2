"""The port's models held against the JAX package's, in fp32 on the CPU, at
the same weights (carried over by checkpoints/from_jax.py): the PEA adapter
for every preset (widths cut by 32), the BERT text tower on BERT_TINY, the
UNet on SDXL_UNET_TINY with the SDXL added conditioning, and the VAE on
VAE_TINY.

Each model's state dict also goes back through the JAX package's own
`convert_*` and must give the original JAX tree exactly: the port's
parameter names are the diffusers/transformers names those converters read.

Tolerance: atol 1e-4 (2e-4 through the whole UNet) on outputs of order 1,
fp32 sums in another order in each framework.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal, host_params, t, to_numpy_sd
from pea_diffusion_tpu.checkpoints.torch_convert import (convert_adapter,
                                                         convert_bert_text,
                                                         convert_unet,
                                                         convert_vae)
from pea_diffusion_tpu.configs import adapter as jax_adapter_cfg
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.models import adapter as jax_adapter
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JaxBert
from pea_diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.configs import (ADAPTER_PRESETS, BERT_TINY,
                                             SDXL_UNET_TINY, VAE_TINY)
from pea_diffusion_tpu_torch.configs.adapter import AdapterConfig
from pea_diffusion_tpu_torch.models import (AutoencoderKL, BertTextEncoder,
                                            PEAAdapter, UNet2DCondition)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def test_configs_are_copies_of_the_jax_presets():
    assert dataclasses.asdict(SDXL_UNET_TINY) == dataclasses.asdict(JAX_UNET_TINY)
    assert dataclasses.asdict(VAE_TINY) == dataclasses.asdict(JAX_VAE_TINY)
    assert dataclasses.asdict(BERT_TINY) == dataclasses.asdict(JAX_BERT_TINY)
    assert {k: dataclasses.asdict(v) for k, v in ADAPTER_PRESETS.items()} == {
        k: dataclasses.asdict(v)
        for k, v in jax_adapter_cfg.ADAPTER_PRESETS.items()}


@pytest.mark.parametrize("preset", sorted(ADAPTER_PRESETS))
def test_adapter_every_preset(preset):
    full = ADAPTER_PRESETS[preset]
    small = dict(in_dim=full.in_dim // 32,
                 projector_dims=tuple(d // 32 for d in full.projector_dims),
                 projector_bias=full.projector_bias,
                 head_dim=None if full.head_dim is None else full.head_dim // 32,
                 use_residual=full.use_residual)
    jm = jax_adapter.PEAAdapter(jax_adapter_cfg.AdapterConfig(**small))
    x = _rand(2, 6, small["in_dim"])
    params = host_params(jm, x)
    pm = PEAAdapter(AdapterConfig(**small))
    pm.load_state_dict(from_jax.adapter_state_dict(params), strict=True)
    want, got = jm.apply(params, x), pm(t(x))
    if full.head_dim is None:
        _close(got, want)
    else:
        _close(got[0], want[0])  # pooled
        _close(got[1], want[1])  # seq
    assert_tree_equal(convert_adapter(to_numpy_sd(pm)), params)


@pytest.mark.parametrize("variant", [
    {},                                                   # Chinese-CLIP / BERT
    {"roberta_position_ids": True, "pad_token_id": 1,     # XLM-R positions and
     "project_dim": 24},                                  # the AltCLIP head
])
def test_bert_text_encoder(variant):
    ids = np.random.default_rng(0).integers(5, 1000, (2, 16)).astype(np.int32)
    ids[1, 11:] = variant.get("pad_token_id", 0)  # padding: the attention mask
    jm = JaxBert(dataclasses.replace(JAX_BERT_TINY, **variant))
    params = host_params(jm, ids)
    pm = BertTextEncoder(dataclasses.replace(BERT_TINY, **variant))
    pm.load_state_dict(from_jax.bert_text_state_dict(params), strict=True)
    want = jm.apply(params, ids)
    got = pm(torch.from_numpy(ids).long())
    _close(got.last_hidden_state, want.last_hidden_state)
    _close(got.pooled, want.pooled)
    if "project_dim" in variant:
        _close(got.projected, want.projected)
    else:
        assert_tree_equal(
            convert_bert_text(to_numpy_sd(pm), BERT_TINY.num_layers), params)


def _skip_shapes(cfg, b, hw):
    """NHWC shapes of the UNet's down-path skips (ControlNet residuals)."""
    shapes = [(b, hw, hw, cfg.block_out_channels[0])]
    for i, ch in enumerate(cfg.block_out_channels):
        shapes += [(b, hw, hw, ch)] * cfg.layers_per_block
        if i < cfg.num_blocks - 1:
            hw //= 2
            shapes.append((b, hw, hw, ch))
    return shapes, (b, hw, hw, cfg.block_out_channels[-1])


def test_unet_sdxl_tiny_with_added_cond_residuals_and_features():
    cfg = SDXL_UNET_TINY
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    x, ehs = _rand(2, 8, 8, 4), _rand(2, 5, cfg.cross_attention_dim, seed=1)
    ts = np.array([999, 500], np.int32)
    added = {"text_embeds": _rand(2, pooled, seed=2),
             "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))}
    skips, mid = _skip_shapes(cfg, 2, 8)
    down_res = tuple(0.1 * _rand(*s, seed=10 + i) for i, s in enumerate(skips))
    mid_res = 0.1 * _rand(*mid, seed=9)
    jm = JaxUNet(JAX_UNET_TINY)
    params = host_params(jm, x, ts, ehs, added)
    want, want_f = jax.jit(lambda p, *a: jm.apply(p, *a, capture_features=True))(
        params, x, ts, ehs, added, down_res, mid_res)
    pm = UNet2DCondition(cfg)
    pm.load_state_dict(from_jax.unet_state_dict(params, cfg), strict=True)
    got, got_f = pm(t(x), torch.from_numpy(ts).long(), t(ehs),
                    {k: t(v) for k, v in added.items()},
                    down_block_additional_residuals=[t(r) for r in down_res],
                    mid_block_additional_residual=t(mid_res),
                    capture_features=True)
    _close(got, want, atol=2e-4)
    assert sorted(got_f) == sorted(want_f)
    for k in want_f:
        _close(got_f[k], want_f[k], atol=2e-4)
    assert_tree_equal(convert_unet(to_numpy_sd(pm), JAX_UNET_TINY), params)


def test_vae_tiny_decode_and_encode():
    x, z = _rand(2, 16, 16, 3), _rand(2, 4, 4, 4, seed=1)
    jm = JaxVAE(JAX_VAE_TINY)
    params = host_params(jm, x, jax.random.PRNGKey(1))
    pm = AutoencoderKL(VAE_TINY)
    pm.load_state_dict(from_jax.vae_state_dict(params, VAE_TINY), strict=True)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(params, z)
    _close(pm.decode(t(z)), want)
    mean, logvar = jax.jit(
        lambda p, x: jm.apply(p, x, method=jm.encode_moments))(params, x)
    got_mean, got_logvar = pm.encode_moments(t(x))
    _close(got_mean, mean)
    _close(got_logvar, logvar)
    assert_tree_equal(convert_vae(to_numpy_sd(pm), JAX_VAE_TINY), params)
