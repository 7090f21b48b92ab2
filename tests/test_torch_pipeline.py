"""The port's samplers and SD1.5 and SDXL pipelines held against the JAX
package's, in fp32 on the CPU: scheduler steps on fixed tensors,
`cfg_combine`, the ragged chunked VAE decode, and the whole tiny
text-to-image slices (text tower -> adapter -> UNet under DDIM or DPM++
with CFG -> VAE) at the same weights, with the initial noise passed in
because the two frameworks draw different random numbers (for SD1.5, the
noise JAX's generate_sd draws from its key).

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
from pea_diffusion_tpu.configs.unet import SD15_UNET_TINY as JAX_SD15_UNET_TINY
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu.pipelines import sampling as jax_sampling
from pea_diffusion_tpu.pipelines import text2image as jax_t2i
from pea_diffusion_tpu.schedulers import SD15_SCHEDULE as JAX_SD15_SCHEDULE
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as JAX_SCHEDULE
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli.generate import build_demo, main, make_tokenizer
from pea_diffusion_tpu_torch.pipelines import (StableDiffusionPEAPipeline,
                                               StableDiffusionXLPEAPipeline,
                                               cfg_combine, decode_latents,
                                               generate_sd, generate_sdxl,
                                               make_add_time_ids, make_sampler)
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


@pytest.fixture(scope="module")
def sd15_stacks():
    """The tiny SD1.5 stack (seq-only adapter, 1x1-conv projections) in both
    frameworks at the same weights."""
    ucfg = JAX_SD15_UNET_TINY
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(JAX_BERT_TINY.hidden_size,
                                     (96, 96, ucfg.cross_attention_dim)),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, schedule=JAX_SD15_SCHEDULE,
        dtype=jnp.float32)
    params = perturb(jax_factory.init_params_host(jmodels, "chinese_clip",
                                                  JAX_BERT_TINY), seed=4)
    pmodels, tokenize, _ = build_demo(device="cpu", model="sd15")
    assert pmodels.vae_scaling == jmodels.vae_scaling == 0.18215
    pmodels.text_encoder.load_state_dict(
        from_jax.bert_text_state_dict(params["text"]), strict=True)
    pmodels.adapter.load_state_dict(
        from_jax.adapter_state_dict(params["adapter"]), strict=True)
    pmodels.unet.load_state_dict(
        from_jax.unet_state_dict(params["unet"], pmodels.unet.config), strict=True)
    pmodels.vae.load_state_dict(
        from_jax.vae_state_dict(params["vae"], pmodels.vae.config), strict=True)
    return jmodels, params, pmodels, tokenize


@pytest.mark.parametrize("sampler_name", ["ddim", "dpm++"])
def test_generate_sd_slice_matches_jax(sd15_stacks, sampler_name):
    """SD1.5 text-to-image with CFG 7.5: the port's generate_sd, given the
    noise JAX's generate_sd draws from its key, against JAX's images."""
    jmodels, params, pmodels, tokenize = sd15_stacks
    ids, uncond = tokenize(["雪山下的湖泊"]), tokenize([""])
    key = jax.random.PRNGKey(5)
    want = jax_t2i.generate_sd(
        jmodels, params, jnp.asarray(ids, jnp.int32), jnp.asarray(uncond, jnp.int32), key,
        sampler_name=sampler_name, height=64, width=64, num_steps=3, guidance_scale=7.5)
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    if sampler_name == "ddim":
        got = generate_sd(pmodels, ids, uncond, sampler_name="ddim", height=64, width=64,
                          num_steps=3, guidance_scale=7.5, init_noise=noise)
    else:
        got = StableDiffusionPEAPipeline(pmodels, "dpm++")(
            ids, uncond, height=64, width=64, num_steps=3, init_noise=noise)
    assert got.shape == (1, 16, 16, 3)
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


@pytest.mark.parametrize("name", ["euler", "euler_a", "euler_ancestral", "lcm"])
def test_few_step_samplers_are_built(name):
    """The few-step samplers build with the JAX sampler's timesteps and
    initial noise scale; a name neither package knows raises ValueError."""
    js = jax_sampling.make_sampler(name, JAX_SCHEDULE, 4)
    ps = make_sampler(name, SDXL_SCHEDULE, 4)
    np.testing.assert_array_equal(np.asarray(js.timesteps), ps.timesteps)
    assert ps.num_steps == js.num_steps and ps.init_noise_sigma == js.init_noise_sigma
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler(name + "_x", SDXL_SCHEDULE, 4)


def test_cli_demo_writes_an_image(tmp_path):
    from PIL import Image

    out = tmp_path / "out.png"
    main(["--demo", "--device", "cpu", "--sampler", "ddim", "--steps", "2",
          "--size", "64", "-o", str(out)])
    assert Image.open(out).size == (16, 16)  # VAE_TINY upsamples 2x


def test_cli_demo_sd15_writes_an_image(tmp_path):
    from PIL import Image

    out = tmp_path / "sd15.png"
    main(["--model", "sd15", "--demo", "--device", "cpu", "--sampler", "dpm++",
          "--steps", "2", "--size", "64", "-o", str(out)])
    assert Image.open(out).size == (16, 16)


@pytest.mark.parametrize("mode,size,side", [
    ("--demo-full", 128, 32),   # --size above the model's own size is taken
    ("--demo-full", None, 16),  # no --size: the model's own
    ("--demo", 128, 16),        # the tiny stack caps it at its own size
])
def test_cli_size_is_capped_only_under_demo(monkeypatch, tmp_path, mode, size, side):
    """--demo-full renders the --size asked for (SD1.5 at 1024² above its
    native 512²); only --demo caps it. Both builders are swapped for the
    tiny SD1.5 stack reporting 64 as its size (the full stack's 512 at an
    eighth), so the image (VAE_TINY: latent x2) is side 32 at --size 128
    and 16 at the cap."""
    from PIL import Image

    from pea_diffusion_tpu_torch.cli import generate

    def tiny(device="cpu", model="sdxl", seed=0):
        models, tokenize, _ = build_demo(device, model)
        return models, tokenize, 64

    monkeypatch.setattr(generate, "build_demo", tiny)
    monkeypatch.setattr(generate, "build_demo_full", tiny)
    out = tmp_path / "out.png"
    main(["--model", "sd15", mode, "--device", "cpu", "--sampler", "ddim", "--steps", "1",
          "-o", str(out)] + ([] if size is None else ["--size", str(size)]))
    assert Image.open(out).size == (side, side)


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


def test_cli_int8_ranges_file_then_same_png(tmp_path, capsys):
    """--quant int8 --calib-ranges PATH on --demo: the first run calibrates
    and writes PATH, the second loads it and writes the same PNG bit for
    bit (and --aot-cache and --no-compile-cache are taken)."""
    from pea_diffusion_tpu_torch.data import native_reader
    from pea_diffusion_tpu_torch.ops import kernel_build

    ranges = tmp_path / "ranges.json"
    base = ["--demo", "--device", "cpu", "--sampler", "ddim", "--steps", "2", "--size", "64",
            "--quant", "int8", "--calib-ranges", str(ranges)]
    build_dirs = kernel_build.BUILD_DIR, native_reader.BUILD_DIR
    try:
        main(base + ["-o", str(tmp_path / "a.png"), "--aot-cache", str(tmp_path / "aot")])
        first = ranges.read_text()
        main(base + ["-o", str(tmp_path / "b.png"), "--no-compile-cache"])
    finally:
        kernel_build.BUILD_DIR, native_reader.BUILD_DIR = build_dirs
    assert ranges.read_text() == first and "down_0_resnet_0/conv1" in first
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    assert capsys.readouterr().out.count("wrote ") == 2


def test_cli_repl_writes_an_image_a_prompt(tmp_path, monkeypatch, capsys):
    """--repl: after -o, one image a prompt read from the input (out-1.png,
    out-2.png), until an empty line; at the end of the input it stops too."""
    from PIL import Image

    for lines, want in ((["一只猫", "雪山", "", "never read"], 2), (["一只猫"], 1)):
        feed = iter(lines)

        def read(prompt):
            try:
                return next(feed)
            except StopIteration:
                raise EOFError from None

        monkeypatch.setattr("builtins.input", read)
        out = tmp_path / f"out{want}.png"
        main(["--demo", "--device", "cpu", "--sampler", "ddim", "--steps", "1", "--size", "64",
              "-o", str(out), "--repl"])
        written = [out] + [tmp_path / f"out{want}-{i}.png" for i in range(1, want + 1)]
        assert all(Image.open(p).size == (16, 16) for p in written)
        assert not (tmp_path / f"out{want}-{want + 1}.png").exists()
        assert capsys.readouterr().out.count("wrote ") == want + 1
    if want == 1:
        assert list(feed) == []


@pytest.mark.parametrize("argv,message", [
    (["--tp", "2"], "launch it with torchrun --nproc-per-node 2 -m "
                    "pea_diffusion_tpu_torch.cli.generate"),
    (["--quant", "int8:bogus"], "unknown int8 scopes ['bogus']"),
    (["--aot-cache", "c", "--no-compile-cache"], "give one"),
    (["--quant", "int8", "--inpaint-image", "a.png", "--mask", "m.png"], "text-to-image only"),
    (["--model", "sd15", "--quant", "int8"], "SDXL stack"),
])
def test_cli_refuses_tp_and_bad_quant(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        main(["--demo", "--device", "cpu"] + argv)
    assert exc.value.code == 2 and message in capsys.readouterr().err
