"""The port's UNet presets and the SDXL base + refiner ensemble held against
the JAX package's, in fp32 on the CPU: the SDXL inpainting, SD2.1, refiner
and SSD-1B presets field by field (and SSD-1B from its diffusers config),
the refiner's [B, 5] time ids, the `denoising_end` / `denoising_start`
windows at the pairs where float64 arithmetic would move them,
`generate_sdxl(denoising_end=...)`'s latents, `refine_sdxl` on a tiny
refiner-shaped UNet (four levels, attention at the middle two, 5 time ids)
and `generate_sdxl_ensemble`, with JAX's initial noise passed in; UNet
forwards on tiny SSD-1B-shaped (per-layer transformer depths), SD2.1-shaped
(odd head counts, linear projections) and 9-channel configs; the factory's
9-channel UNet and refiner adapter; and chip_smoke.py's route walk of the
new paths against the JAX dispatch and its kernel rows.

Tolerances: exact for configs, time ids and windows; 2e-4 through a whole
UNet, as tests/test_torch_models.py; 2e-3 on latents and images, as
tests/test_torch_pipeline.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import host_params, one_torch_thread, t, tiny_sdxl_pair  # noqa: F401
from test_diffusers_goldens import SSD1B_DIFFUSERS_CONFIG
from pea_diffusion_tpu.configs import unet as jax_unet_cfg
from pea_diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from pea_diffusion_tpu.ops import attention as jax_attention
from pea_diffusion_tpu.pipelines import sampling as jax_sampling
from pea_diffusion_tpu.pipelines import text2image as jax_t2i
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as JAX_SCHEDULE
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli.generate import make_tokenizer
from pea_diffusion_tpu_torch.configs import unet as port_unet_cfg
from pea_diffusion_tpu_torch.models import UNet2DCondition
from pea_diffusion_tpu_torch.pipelines import (generate_sdxl, generate_sdxl_ensemble,
                                               make_add_time_ids, make_sampler, refine_sdxl,
                                               steps_at_or_above)
from pea_diffusion_tpu_torch.schedulers import SDXL_SCHEDULE

PRESETS = ("SDXL_INPAINT_UNET", "SD21_UNET", "SDXL_REFINER_UNET", "SSD_1B_UNET")
SIDE = 64  # 8x8 latents


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_is_a_copy_of_the_jax_preset(name):
    assert dataclasses.asdict(getattr(port_unet_cfg, name)) == dataclasses.asdict(
        getattr(jax_unet_cfg, name))


def test_ssd_1b_preset_is_its_diffusers_config():
    cfg = port_unet_cfg.UNetConfig.from_diffusers_config(SSD1B_DIFFUSERS_CONFIG)
    assert cfg == port_unet_cfg.SSD_1B_UNET
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_unet_cfg.UNetConfig.from_diffusers_config(SSD1B_DIFFUSERS_CONFIG))


@pytest.mark.parametrize("score", [6.0, 2.5, 5.9999])
def test_make_add_time_ids_aesthetic_form(score):
    want = jax_t2i.make_add_time_ids((1024, 768), (0, 16), (512, 512), 3,
                                     aesthetic_score=jnp.float32(score))
    got = make_add_time_ids((1024, 768), (0, 16), (512, 512), 3, aesthetic_score=score)
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sampler_name", ["ddim", "dpm++", "euler"])
@pytest.mark.parametrize("steps,fraction,want", [
    (30, 0.9, 26), (30, 0.57, 17), (10, 0.8, 8), (4, 0.9995, 4)])
def test_window_is_jax_float32(sampler_name, steps, fraction, want):
    """sum(timesteps >= cutoff), the cutoff in float32: where
    `generate_sdxl(denoising_end)` stops and `refine_sdxl` starts (at
    0.9995 every timestep lies at or above it: the refiner runs no step)."""
    js = jax_sampling.make_sampler(sampler_name, JAX_SCHEDULE, steps)
    cutoff = JAX_SCHEDULE.num_train_timesteps * (1.0 - jnp.float32(fraction))
    jax_end = int(jnp.sum((js.timesteps >= cutoff).astype(jnp.int32)))
    got = steps_at_or_above(make_sampler(sampler_name, SDXL_SCHEDULE, steps), SDXL_SCHEDULE,
                            fraction)
    assert got == jax_end
    if sampler_name == "ddim":
        assert got == want


# A tiny refiner: four levels, attention at the middle two, a 48-d text
# width, 5 time ids of 32 plus a 40-d pooled embedding.
TINY_REFINER = dict(
    block_out_channels=(32, 64, 64, 64), transformer_layers=(0, 1, 1, 0),
    num_attention_heads=(2, 2, 4, 4), cross_attention_dim=48, mid_transformer_layers=1,
    norm_num_groups=8, addition_embed_type="text_time", addition_time_embed_dim=32,
    projection_class_embeddings_input_dim=32 * 5 + 40, use_linear_projection=True)


@pytest.fixture(scope="module")
def ensemble():
    """The tiny SDXL base and the tiny refiner (each with its own tower,
    adapter and VAE weights) in both frameworks."""
    base = tiny_sdxl_pair(jax_unet_cfg.SDXL_UNET_TINY, port_unet_cfg.SDXL_UNET_TINY, seed=5)
    refiner = tiny_sdxl_pair(jax_unet_cfg.UNetConfig(**TINY_REFINER),
                             port_unet_cfg.UNetConfig(**TINY_REFINER), time_ids=5, seed=6)
    return base, refiner


def _prompts():
    tokenize = make_tokenizer(1000, 16)
    return tokenize(["山间的小屋"]), tokenize([""]), tokenize(["雪"])


def _forwards(unet):
    calls = []
    return calls, unet.register_forward_pre_hook(lambda m, args: calls.append(1))


def test_generate_sdxl_denoising_end_matches_jax(ensemble):
    """The undecoded latents after the window's steps (26 of 30 at 0.9, 17
    at 0.57, where float64 would run 27 and 16), with JAX's noise."""
    (jmodels, params, pmodels), _ = ensemble
    ids, uncond, _ = _prompts()
    key = jax.random.PRNGKey(8)
    noise = np.array(jax.random.normal(key, (1, SIDE // 8, SIDE // 8, 4), jnp.float32))
    for end, forwards in ((0.9, 26), (0.57, 17)):
        want = np.asarray(jax_t2i.generate_sdxl(
            jmodels, params, jnp.asarray(ids, jnp.int32), jnp.asarray(uncond, jnp.int32), key,
            sampler_name="ddim", height=SIDE, width=SIDE, num_steps=30,
            guidance_scale=7.5, denoising_end=end))
        calls, hook = _forwards(pmodels.unet)
        try:
            got = generate_sdxl(pmodels, ids, uncond, sampler_name="ddim", height=SIDE,
                                width=SIDE, num_steps=30, guidance_scale=7.5,
                                denoising_end=end, init_noise=noise)
        finally:
            hook.remove()
        assert got.shape == want.shape == (1, SIDE // 8, SIDE // 8, 4)
        assert len(calls) == forwards
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_refine_sdxl_matches_jax(ensemble):
    """The refiner from the window's start on handed-over latents, its
    scores traced in JAX: 30 steps from 0.9 (4 steps) and 0.57 (13), and
    from 0.9995, where no step runs and the latents are decoded as they
    are."""
    _, (jmodels, params, pmodels) = ensemble
    ids, uncond, _ = _prompts()
    latents = _rand(1, SIDE // 8, SIDE // 8, 4, seed=9)
    outs = []
    for start, score, negative, forwards in ((0.9, 6.0, 2.5, 4), (0.57, 7.0, 1.0, 13),
                                             (0.9995, 6.0, 2.5, 0)):
        want = np.asarray(jax_t2i.refine_sdxl(
            jmodels, params, jnp.asarray(ids, jnp.int32), jnp.asarray(uncond, jnp.int32),
            jnp.asarray(latents), jax.random.PRNGKey(0), num_steps=30,
            denoising_start=start, aesthetic_score=score, negative_aesthetic_score=negative))
        calls, hook = _forwards(pmodels.unet)
        try:
            got = refine_sdxl(pmodels, ids, uncond, latents, num_steps=30,
                              denoising_start=start, aesthetic_score=score,
                              negative_aesthetic_score=negative)
        finally:
            hook.remove()
        assert got.shape == (1, SIDE // 4, SIDE // 4, 3) and len(calls) == forwards
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
        outs.append(want)
    assert np.abs(outs[0] - outs[1]).max() > 1e-2


def test_generate_sdxl_ensemble_matches_jax(ensemble):
    """Base to 0.9, refiner (with its own prompt ids) from there, the base's
    noise JAX's draw from the request's key."""
    (jbase, jbase_params, pbase), (jref, jref_params, pref) = ensemble
    ids, uncond, ref_ids = _prompts()
    key = jax.random.PRNGKey(4)
    want = np.asarray(jax_t2i.generate_sdxl_ensemble(
        jbase, jbase_params, jref, jref_params, jnp.asarray(ids, jnp.int32),
        jnp.asarray(uncond, jnp.int32), key, height=SIDE, width=SIDE, num_steps=30,
        high_noise_frac=0.9, refiner_ids=jnp.asarray(ref_ids, jnp.int32)))
    noise = np.array(jax.random.normal(key, (1, SIDE // 8, SIDE // 8, 4), jnp.float32))
    got = generate_sdxl_ensemble(pbase, pref, ids, uncond, height=SIDE, width=SIDE,
                                 num_steps=30, high_noise_frac=0.9, refiner_ids=ref_ids,
                                 init_noise=noise)
    assert got.shape == (1, SIDE // 4, SIDE // 4, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


# Tiny configs of each preset's shape class.
TINY_SHAPES = {
    # SSD-1B: per-layer transformer depths, pruned differently down and up
    "ssd_1b": dict(block_out_channels=(32, 64, 64), transformer_layers=(0, (1, 2), 2),
                   reverse_transformer_layers=((2, 1, 1), (1, 1, 2), 0),
                   num_attention_heads=(2, 2, 4), cross_attention_dim=64,
                   mid_transformer_layers=2, norm_num_groups=8, addition_embed_type="text_time",
                   addition_time_embed_dim=32, projection_class_embeddings_input_dim=256,
                   use_linear_projection=True),
    # SD2.1: SD1.5's four levels, odd head counts, linear projections
    "sd21": dict(block_out_channels=(40, 48, 80, 80), num_attention_heads=(5, 3, 5, 5),
                 cross_attention_dim=48, norm_num_groups=8, use_linear_projection=True),
    # the inpainting UNet: 9 input channels
    "inpaint": dict(dataclasses.asdict(jax_unet_cfg.SDXL_UNET_TINY), in_channels=9),
}


@pytest.mark.parametrize("shape", sorted(TINY_SHAPES))
def test_unet_of_each_preset_shape_matches_jax(shape):
    fields = TINY_SHAPES[shape]
    jcfg, pcfg = jax_unet_cfg.UNetConfig(**fields), port_unet_cfg.UNetConfig(**fields)
    x = _rand(2, 8, 8, pcfg.in_channels)
    ts = np.array([999, 31], np.int32)
    ehs = _rand(2, 7, pcfg.cross_attention_dim, seed=1)
    added = None
    if pcfg.addition_embed_type:
        added = {"text_embeds": _rand(2, 64, seed=2),
                 "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))}
    jm = JaxUNet(jcfg)
    params = host_params(jm, x, ts, ehs, added, seed=3)
    want = jax.jit(lambda p, *a: jm.apply(p, *a))(params, x, ts, ehs, added)
    pm = UNet2DCondition(pcfg)
    pm.load_state_dict(from_jax.unet_state_dict(params, pcfg), strict=True)
    got = pm(t(x), torch.from_numpy(ts).long(), t(ehs),
             None if added is None else {k: t(v) for k, v in added.items()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4)


def test_factory_takes_a_nine_channel_unet_and_a_refiner_adapter():
    """`with_unet` on the tiny stack: a 9-channel UNet sharing the tower and
    VAE, and a refiner-shaped UNet with its own adapter; then the full-size
    refiner adapter (the sdxl_chinese_clip projector with a 1280-d head)
    against SDXL_REFINER_UNET on the meta device: pooled 1280 + 5 x 256
    time ids feed the add embedding, the 1280-d states the cross-attention."""
    from pea_diffusion_tpu_torch.cli.generate import build_demo
    from pea_diffusion_tpu_torch.configs import AdapterConfig, SDXL_REFINER_UNET
    from pea_diffusion_tpu_torch.models import PEAAdapter
    from pea_diffusion_tpu_torch.pipelines import with_unet

    models, _, _ = build_demo("cpu")
    nine = with_unet(models, dataclasses.replace(models.unet.config, in_channels=9),
                     dtype=torch.float32, seed=1)
    assert nine.unet.conv_in.in_channels == 9
    assert nine.adapter is models.adapter and nine.vae is models.vae
    refiner = with_unet(models, port_unet_cfg.UNetConfig(**TINY_REFINER),
                        AdapterConfig(64, (96, 40), head_dim=48), dtype=torch.float32, seed=2)
    assert refiner.adapter is not models.adapter and refiner.text_encoder is models.text_encoder
    assert refiner.adapter.fc.out_features == 48
    with torch.device("meta"):
        adapter = PEAAdapter(AdapterConfig(1024, (1024, 1024, 1280), head_dim=1280))
        unet = UNet2DCondition(SDXL_REFINER_UNET)
        pooled, seq = adapter(torch.empty(2, 52, 1024))
        out = unet(torch.empty(2, 16, 16, 4), torch.zeros(2, dtype=torch.long), seq,
                   {"text_embeds": pooled, "time_ids": make_add_time_ids(
                       (128, 128), (0, 0), (128, 128), 2, "meta", aesthetic_score=6.0)})
    assert tuple(out.shape) == (2, 16, 16, 4)


def _jax_route(sq, skv, heads, head_dim):
    """The JAX layers' dispatch (layers.py:272-298) on a TPU."""
    from pea_diffusion_tpu.ops import onepass_attention as jax_onepass

    if jax_attention.use_flash(sq, "auto"):
        return "onepass" if jax_onepass.supports(sq, skv, heads, head_dim) else "flash"
    return "plain"


@pytest.mark.parametrize("name,latent,skv", [
    ("SDXL_REFINER_UNET", 128, 52), ("SSD_1B_UNET", 128, 52), ("SD21_UNET", 96, 77),
    ("SDXL_INPAINT_UNET", 128, 52)])
def test_smoke_route_walk_of_the_presets(monkeypatch, name, latent, skv):
    """chip_smoke.py's walk of each preset's attention modules (meta device)
    at its serving size: every call's route is the JAX dispatch's; the
    refiner's levels take B1 (12 and 24 heads), SD2.1's level 0 B3 (5
    heads); each kernel call has a kernel row of its path."""
    import chip_smoke

    monkeypatch.setattr(jax_attention.jax, "default_backend", lambda: "tpu")
    with torch.device("meta"):
        unet = UNet2DCondition(getattr(port_unet_cfg, name))
    calls = list(chip_smoke.attention_calls(unet, latent, skv, heads=True))
    for route, sq, kv, d, h in calls:
        assert route == _jax_route(sq, kv, h, d), (sq, kv, h, d)
    counts = chip_smoke.attention_routes(unet, latent, skv, heads=True)
    kernel_calls = {key for key in counts if key[0] != "plain"}
    if name == "SDXL_REFINER_UNET":
        assert counts == {("onepass", 4096, 4096, 12): 20, ("flash", 4096, 52, 12): 20,
                          ("onepass", 1024, 1024, 24): 20, ("flash", 1024, 52, 24): 20,
                          ("plain", 256, 256, 24): 4, ("plain", 256, 52, 24): 4}
        path, keys = chip_smoke.ENSEMBLE_PATH, kernel_calls
    elif name == "SD21_UNET":
        assert {k: n for k, n in counts.items() if k[0] != "plain"} == {
            ("flash", 9216, 9216, 5): 5, ("flash", 9216, 77, 5): 5,
            ("onepass", 2304, 2304, 10): 5, ("flash", 2304, 77, 10): 5}
        path, keys = chip_smoke.SD21_PATH, {k[:3] for k in kernel_calls}
    else:
        b1 = sum(n for k, n in counts.items() if k[0] == "onepass")
        assert b1 == sum(n for k, n in counts.items() if k[0] == "flash") == (
            34 if name == "SSD_1B_UNET" else 70)
        path = chip_smoke.SSD_1B_PATH if name == "SSD_1B_UNET" else chip_smoke.INPAINT_9CH
        keys = {k[:3] for k in kernel_calls}
    rows = {r[7][path] for r in chip_smoke.forward_cases() if path in r[7]}
    assert keys <= rows


def test_smoke_rows_of_the_ensemble_cover_the_base_and_the_refiner():
    """The ensemble path's rows are keyed by heads: the base's SDXL calls
    and the refiner's, at the same sequences, land on different rows."""
    import chip_smoke
    from pea_diffusion_tpu_torch.configs import SDXL_UNET

    with torch.device("meta"):
        base = UNet2DCondition(SDXL_UNET)
        refiner = UNet2DCondition(port_unet_cfg.SDXL_REFINER_UNET)
    walk = {k for u in (base, refiner)
            for k in chip_smoke.attention_routes(u, 128, 52, heads=True) if k[0] != "plain"}
    rows = [r for r in chip_smoke.forward_cases() if chip_smoke.ENSEMBLE_PATH in r[7]]
    assert {r[7][chip_smoke.ENSEMBLE_PATH] for r in rows} == walk
    for kern, b, sq, skv, h, d, lse, stands_for, _ in rows:
        route, _, _, heads = stands_for[chip_smoke.ENSEMBLE_PATH]
        assert not lse and d == 64 and (route == "onepass") == (kern == "B1")
        assert (b, h) == (2, heads) if kern == "B1" else (b, h) == (2 * heads, 1)
