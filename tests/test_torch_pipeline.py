"""The port's samplers and SDXL pipeline held against the JAX package's, in
fp32 on the CPU: scheduler steps on fixed tensors, `cfg_combine`, the ragged
chunked VAE decode, and the whole tiny text-to-image slice (text tower ->
adapter -> UNet under DDIM with CFG -> VAE) at the same weights, with the
initial noise passed in because the two frameworks draw different random
numbers.

Tolerances: 1e-5 on the sampler trajectories (the same float32 arithmetic),
1e-4 on the decode, 2e-3 on the final images.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import perturb, t
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JaxAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu.pipelines import sampling as jax_sampling
from pea_diffusion_tpu.pipelines import text2image as jax_t2i
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as JAX_SCHEDULE
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli.generate import build_demo, main, make_tokenizer
from pea_diffusion_tpu_torch.pipelines import (StableDiffusionXLPEAPipeline,
                                               cfg_combine, decode_latents,
                                               generate_sdxl, make_add_time_ids,
                                               make_sampler)
from pea_diffusion_tpu_torch.schedulers import SDXL_SCHEDULE


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name,steps", [("ddim", 5), ("dpm++", 5), ("dpm++", 2)])
def test_sampler_trajectory(name, steps):
    """Both samplers over a fixed model output function: every step's
    latents and the timestep tables agree."""
    js = jax_sampling.make_sampler(name, JAX_SCHEDULE, steps)
    ps = make_sampler(name, SDXL_SCHEDULE, steps)
    np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
    x0 = _rand(2, 4, 4, 4)
    jx, jst = jnp.asarray(x0), js.init(x0.shape)
    px, pst = t(x0), ps.init()
    for i in range(steps):
        out = _rand(2, 4, 4, 4, seed=i + 1)
        jx, jst = js.step(i, js.scale(i, jx), jnp.asarray(out) + 0.3 * jx, jst)
        px, pst = ps.step(i, ps.scale(i, px), t(out) + 0.3 * px, pst)
        np.testing.assert_allclose(px.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("scale,rescale", [
    (7.5, 0.0), (7.5, 0.7), ([7.5, 0.5], [0.0, 0.3]),  # vector row < 1 clamps
])
def test_cfg_combine(scale, rescale):
    pair = _rand(4, 3, 3, 4)
    want = jax_t2i.cfg_combine(jnp.asarray(pair), jnp.asarray(scale, jnp.float32),
                               jnp.asarray(rescale, jnp.float32))
    got = cfg_combine(t(pair), scale, rescale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_make_add_time_ids():
    want = jax_t2i.make_add_time_ids((1024, 768), (0, 16), (512, 512), 3)
    got = make_add_time_ids((1024, 768), (0, 16), (512, 512), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def stacks():
    """The tiny SDXL stack in both frameworks at the same weights."""
    ucfg = JAX_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(JAX_BERT_TINY.hidden_size, (96, pooled),
                                     head_dim=ucfg.cross_attention_dim),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, dtype=jnp.float32)
    params = perturb(jax_factory.init_params_host(jmodels, "chinese_clip",
                                                  JAX_BERT_TINY), seed=3)
    pmodels, tokenize, _ = build_demo(device="cpu")
    pmodels.text_encoder.load_state_dict(
        from_jax.bert_text_state_dict(params["text"]), strict=True)
    pmodels.adapter.load_state_dict(
        from_jax.adapter_state_dict(params["adapter"]), strict=True)
    pmodels.unet.load_state_dict(
        from_jax.unet_state_dict(params["unet"], pmodels.unet.config), strict=True)
    pmodels.vae.load_state_dict(
        from_jax.vae_state_dict(params["vae"], pmodels.vae.config), strict=True)
    return jmodels, params, pmodels, tokenize


def test_decode_latents_ragged_chunk(stacks):
    jmodels, params, pmodels, _ = stacks
    lat = _rand(3, 4, 4, 4)
    want = jax_t2i.decode_latents(jmodels, params["vae"], jnp.asarray(lat), chunk=2)
    got = decode_latents(pmodels, t(lat), chunk=2)
    assert got.shape == (3, 8, 8, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("guidance_scale,guidance_rescale", [
    (7.5, 0.0), (7.5, 0.5), (1.0, 0.0),  # CFG, CFG + rescale, no CFG
])
def test_generate_sdxl_slice_matches_jax(stacks, guidance_scale, guidance_rescale):
    jmodels, params, pmodels, tokenize = stacks
    ids, uncond = tokenize(["一只戴着帽子的可爱猫咪"]), tokenize([""])
    noise = _rand(1, 8, 8, 4, seed=11)
    want = jax_t2i.generate_sdxl(
        jmodels, params, ids.astype(np.int32), uncond.astype(np.int32),
        jax.random.PRNGKey(0), sampler_name="ddim", height=64, width=64,
        num_steps=2, guidance_scale=guidance_scale,
        guidance_rescale=guidance_rescale, init_noise=jnp.asarray(noise))
    if guidance_rescale:
        got = StableDiffusionXLPEAPipeline(pmodels, "ddim")(
            ids, uncond, height=64, width=64, num_steps=2,
            guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
            init_noise=noise)
    else:
        got = generate_sdxl(pmodels, ids, uncond, sampler_name="ddim",
                            height=64, width=64, num_steps=2,
                            guidance_scale=guidance_scale, init_noise=noise)
    assert got.shape == (1, 16, 16, 3)
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_unported_samplers_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 15"):
        make_sampler("euler_a", SDXL_SCHEDULE, 4)


def test_cli_demo_writes_an_image(tmp_path):
    from PIL import Image

    out = tmp_path / "out.png"
    main(["--demo", "--device", "cpu", "--sampler", "ddim", "--steps", "2",
          "--size", "64", "-o", str(out)])
    assert Image.open(out).size == (16, 16)  # VAE_TINY upsamples 2x


def test_demo_tokenizer_is_deterministic():
    tok = make_tokenizer(1000, 8)
    ids = tok(["猫a", ""])
    assert ids.tolist() == [[(ord("猫") % 995) + 5, ord("a") % 995 + 5] + [4] * 6,
                            [4] * 8]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default succeeds here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_demo()
