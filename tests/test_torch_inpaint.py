"""The port's SDXL inpainting held against the JAX package's, in fp32 on the
CPU: `preprocess_mask` / `preprocess_image` bit for bit, the mask's resize
to the latents' size against ``jax.image.resize`` "nearest", the strength
and `denoising_start` windows at the pairs where float64 arithmetic would
move them, and `generate_sdxl_inpaint` on the tiny stacks (a 4-channel
UNet with the blend, a 9-channel one with the mask and masked-image
latents as input) at the same weights, with JAX's three draws (noise, the
two VAE encodes) passed in; then the generate CLI's inpaint mode.

Strength, guidance, the aesthetic score and `denoising_start` are traced in
JAX, so the cases are grouped by what JAX compiles anew (the UNet, the
sampler, whether a score or a `denoising_start` is given).

Tolerances: exact for the helpers and the windows; 2e-3 on the images, as
tests/test_torch_pipeline.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dirs as dirs
from _torch_parity import one_torch_thread, tiny_sdxl_pair  # noqa: F401 (a fixture)
from pea_diffusion_tpu.configs import unet as jax_unet_cfg
from pea_diffusion_tpu.pipelines import inpaint as jax_inpaint
from pea_diffusion_tpu.pipelines import sampling as jax_sampling
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as JAX_SCHEDULE
from pea_diffusion_tpu_torch.cli.generate import main, make_tokenizer
from pea_diffusion_tpu_torch.configs import unet as port_unet_cfg
from pea_diffusion_tpu_torch.pipelines import (denoising_start_index, generate_sdxl_inpaint,
                                               make_sampler, mask_to_latents,
                                               preprocess_image, preprocess_mask,
                                               strength_start)
from pea_diffusion_tpu_torch.schedulers import SDXL_SCHEDULE

SIDE = 16  # VAE_TINY halves the image: 8x8 latents


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("case", ["2d01", "2d255", "rgb01", "rgb255", "float_grey"])
def test_preprocess_mask_is_bit_equal(case):
    rng = _rng(len(case))
    shape = (37, 29, 3) if case.startswith("rgb") else (37, 29)
    if case.endswith("255"):
        mask = rng.integers(0, 256, shape).astype(np.uint8)
    elif case == "float_grey":
        mask = rng.random(shape).astype(np.float32)
    else:
        mask = (rng.random(shape) > 0.5).astype(np.float32)
    for h, w in ((32, 32), (24, 40)):
        want = jax_inpaint.preprocess_mask(mask, h, w)
        got = preprocess_mask(mask, h, w)
        assert got.dtype == want.dtype and got.shape == (1, h, w, 1)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(48, 40, 3), (32, 32, 3), (20, 30)])
def test_preprocess_image_is_bit_equal(shape):
    image = _rng(sum(shape)).integers(0, 256, shape).astype(np.uint8)
    want = jax_inpaint.preprocess_image(image, 32, 24)
    got = preprocess_image(image, 32, 24)
    assert got.dtype == want.dtype and got.shape == (1, 32, 24, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [2, 8])
def test_mask_resize_is_jax_nearest(stride):
    """Half-pixel nearest: a 16 -> 2 resize picks rows 4 and 12."""
    mask = (_rng(stride).random((2, 16 * stride, 8 * stride, 1)) > 0.5).astype(np.float32)
    lh, lw = 16, 8
    want = jax.image.resize(jnp.asarray(mask), (2, lh, lw, 1), "nearest")
    got = mask_to_latents(torch.from_numpy(mask), lh, lw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rows = torch.arange(16.0).reshape(1, 16, 1, 1)
    assert mask_to_latents(rows, 2, 1).flatten().tolist() == [4.0, 12.0]


def _jax_start(num_steps, strength):
    """The JAX pipeline's start index, on a float32 traced strength."""
    f = jax.jit(lambda s: jnp.minimum((num_steps * (1.0 - s)).astype(jnp.int32),
                                      num_steps - 1))
    return int(f(jnp.float32(strength)))


@pytest.mark.parametrize("steps,strength,want", [
    (10, 0.6, 3), (20, 0.85, 2), (10, 0.9, 1), (5, 0.6, 1), (10, 0.85, 1), (10, 1.0, 0),
    (30, 0.3, 21)])
def test_strength_start_is_jax_float32(steps, strength, want):
    assert strength_start(steps, strength) == _jax_start(steps, strength) == want


@pytest.mark.parametrize("sampler_name", ["ddim", "dpm++", "euler"])
@pytest.mark.parametrize("steps,start", [(30, 0.9), (30, 0.57), (10, 0.5), (4, 0.9995)])
def test_denoising_start_index_is_jax_argmax(sampler_name, steps, start):
    """argmax(timesteps < cutoff) with the cutoff in float32; at 0.9995 no
    timestep lies below it and the index is 0 (the whole loop runs)."""
    js = jax_sampling.make_sampler(sampler_name, JAX_SCHEDULE, steps)
    cutoff = JAX_SCHEDULE.num_train_timesteps * (1.0 - jnp.float32(start))
    want = int(jnp.argmax((js.timesteps < cutoff).astype(jnp.int32)))
    got = denoising_start_index(make_sampler(sampler_name, SDXL_SCHEDULE, steps).timesteps,
                                SDXL_SCHEDULE, start)
    assert got == want
    if start == 0.9995:
        assert got == 0


@pytest.fixture(scope="module")
def stacks():
    """stacks[channels, time ids]: the tiny SDXL stack in both frameworks
    with a 4- or 9-channel UNet taking 6 time ids, or 5 (the aesthetic-score
    form, whose add embedding is 32 inputs narrower), built on first use."""
    built = {}

    def get(key):
        if key not in built:
            channels, ids = key
            fields = dict(in_channels=channels, projection_class_embeddings_input_dim=(
                jax_unet_cfg.SDXL_UNET_TINY.projection_class_embeddings_input_dim
                - 32 * (6 - ids)))
            built[key] = tiny_sdxl_pair(
                dataclasses.replace(jax_unet_cfg.SDXL_UNET_TINY, **fields),
                dataclasses.replace(port_unet_cfg.SDXL_UNET_TINY, **fields),
                time_ids=ids, seed=channels + ids)
        return built[key]

    return get


def _inputs():
    rng = _rng(0)
    image = preprocess_image(rng.integers(0, 256, (40, 40, 3)), SIDE, SIDE)
    mask = np.zeros((40, 40), np.float32)
    mask[8:28, 12:32] = 1.0  # an 8x8 block at the output side
    return image, preprocess_mask(mask, SIDE, SIDE)


def _jax_draws(key, b=1):
    """JAX's three draws: the initial noise and the two VAE encodes' eps."""
    shape = (b, SIDE // 2, SIDE // 2, 4)
    return [np.array(jax.random.normal(k, shape, jnp.float32))
            for k in jax.random.split(key, 3)]


# (UNet channels, sampler, aesthetic score, denoising_start, steps, the
# values run through one JAX program: strengths, or denoising_starts). The
# strengths include the pairs where float64 would start elsewhere: 10 steps
# at 0.6 and 0.9, 20 at 0.85.
CASES = [
    (4, "ddim", None, None, 10, (0.6, 0.9, 1.0)),
    (9, "dpm++", 6.0, None, 20, (0.85,)),
    (4, "dpm++", None, 0.5, 5, (0.5, 0.9995)),
]


@pytest.mark.parametrize("channels,sampler_name,aesthetic,denoising_start,steps,values",
                         CASES, ids=[f"{c}ch-{s}-score{a}-start{d}-{n}steps"
                                     for c, s, a, d, n, _ in CASES])
def test_generate_sdxl_inpaint_matches_jax(stacks, channels, sampler_name, aesthetic,
                                           denoising_start, steps, values):
    """Each value of the group through both pipelines with the same draws;
    the strengths (or denoising_starts) must give different images."""
    jmodels, params, pmodels = stacks((channels, 6 if aesthetic is None else 5))
    tokenize = make_tokenizer(1000, 16)
    ids, uncond = tokenize(["湖边的房子"]), tokenize([""])
    image, mask = _inputs()
    key = jax.random.PRNGKey(channels)
    noise, eps1, eps2 = _jax_draws(key)
    outs = []
    for v in values:
        strength, start = (0.85, v) if denoising_start is not None else (v, None)
        want = np.asarray(jax_inpaint.generate_sdxl_inpaint(
            jmodels, params, jnp.asarray(ids, jnp.int32), jnp.asarray(uncond, jnp.int32),
            jnp.asarray(image), jnp.asarray(mask), key, sampler_name=sampler_name,
            height=SIDE, width=SIDE, num_steps=steps, guidance_scale=7.5, strength=strength,
            aesthetic_score=aesthetic, denoising_start=start))
        got = generate_sdxl_inpaint(
            pmodels, ids, uncond, image, mask, sampler_name=sampler_name, height=SIDE,
            width=SIDE, num_steps=steps, guidance_scale=7.5, strength=strength,
            aesthetic_score=aesthetic, denoising_start=start, init_noise=noise,
            vae_eps=(eps1, eps2))
        assert got.shape == (1, SIDE, SIDE, 3) and np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, atol=2e-3)
        outs.append(want)
    for a, b in zip(outs, outs[1:]):
        assert np.abs(a - b).max() > 1e-2


@pytest.mark.parametrize("steps,strength", [(5, 0.6), (10, 0.6)])
def test_inpaint_runs_the_jax_window(stacks, steps, strength):
    """The pipeline runs steps [start, steps) with JAX's start where float64
    would start elsewhere (the other pairs run against JAX's images): one
    UNet call a step."""
    _, _, pmodels = stacks((4, 6))
    tokenize = make_tokenizer(1000, 16)
    image, mask = _inputs()
    calls = []
    hook = pmodels.unet.register_forward_pre_hook(lambda m, args: calls.append(1))
    try:
        generate_sdxl_inpaint(pmodels, tokenize(["猫"]), tokenize([""]), image, mask,
                              generator=torch.Generator().manual_seed(0), sampler_name="dpm++",
                              height=SIDE, width=SIDE, num_steps=steps, strength=strength)
    finally:
        hook.remove()
    assert len(calls) == steps - _jax_start(steps, strength)


def test_inpaint_broadcasts_image_and_mask_and_draws_in_order(stacks):
    """A batch of 2 from one image and mask; without draws passed in, the
    generator gives noise, then the two VAE draws, in that order."""
    _, _, pmodels = stacks((4, 6))
    tokenize = make_tokenizer(1000, 16)
    image, mask = _inputs()
    ids, uncond = tokenize(["猫", "狗"]), tokenize(["", ""])
    kw = dict(sampler_name="ddim", height=SIDE, width=SIDE, num_steps=2, strength=0.7)
    drawn = generate_sdxl_inpaint(pmodels, ids, uncond, image, mask,
                                  generator=torch.Generator().manual_seed(5), **kw)
    gen = torch.Generator().manual_seed(5)
    draws = [torch.randn((2, SIDE // 2, SIDE // 2, 4), generator=gen) for _ in range(3)]
    given = generate_sdxl_inpaint(pmodels, ids, uncond, image, mask, init_noise=draws[0],
                                  vae_eps=draws[1:], **kw)
    assert drawn.shape == (2, SIDE, SIDE, 3)
    assert torch.equal(drawn, given)


def _write_png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)
    return str(path)


@pytest.fixture()
def pictures(tmp_path):
    rng = _rng(7)
    mask = np.zeros((48, 48), np.uint8)
    mask[12:36, 12:36] = 255
    return (_write_png(tmp_path / "image.png", rng.integers(0, 256, (48, 48, 3), np.uint8)),
            _write_png(tmp_path / "mask.png", mask))


def test_cli_demo_inpaint_writes_an_image(tmp_path, pictures, capsys):
    from PIL import Image

    out = tmp_path / "inpaint.png"
    main(["--demo", "--device", "cpu", "--inpaint-image", pictures[0], "--mask", pictures[1],
          "--sampler", "dpm++", "--steps", "3", "--strength", "0.6", "--size", "32",
          "-o", str(out)])
    assert Image.open(out).size == (32, 32)  # the VAE encodes and decodes at 2x
    assert f"wrote {out}" in capsys.readouterr().out


@pytest.mark.parametrize("argv,message", [
    (["--inpaint-image", "IMAGE"], "needs both --inpaint-image and --mask"),
    (["--mask", "MASK"], "needs both --inpaint-image and --mask"),
    (["--model", "sd15", "--inpaint-image", "IMAGE", "--mask", "MASK"],
     "inpaint mode runs the SDXL stack"),
])
def test_cli_inpaint_flags_need_each_other_and_sdxl(pictures, capsys, argv, message):
    argv = [a.replace("IMAGE", pictures[0]).replace("MASK", pictures[1]) for a in argv]
    with pytest.raises(SystemExit):
        main(["--demo", "--device", "cpu"] + argv)
    assert message in capsys.readouterr().err


def test_cli_controlnet_wins_over_inpaint(tmp_path, pictures, monkeypatch):
    """Both modes asked for: the ControlNet path runs, as in the JAX CLI."""
    from pea_diffusion_tpu_torch.cli import generate

    ran = []
    monkeypatch.setattr(generate, "make_inpaint_run", lambda *a: ran.append("inpaint"))
    out = tmp_path / "cn.png"
    main(["--demo", "--device", "cpu", "--control-image", pictures[0], "--inpaint-image",
          pictures[0], "--mask", pictures[1], "--sampler", "ddim", "--steps", "1",
          "--size", "64", "-o", str(out)])
    assert out.exists() and not ran


def test_cli_real_mode_serves_a_nine_channel_directory(tmp_path, pictures, capsys,
                                                       monkeypatch):
    """A --model-dir whose unet/config.json says in_channels 9 loads through
    load_unet and runs the 9-channel path (a transformers tokenizer read
    from the text tower's vocab.txt; the tiny adapter registered as a
    preset for the run)."""
    from PIL import Image

    from pea_diffusion_tpu_torch.checkpoints import orbax_io
    from pea_diffusion_tpu_torch.configs import ADAPTER_PRESETS

    from pea_diffusion_tpu_torch.cli.generate import tiny_adapter_config
    from pea_diffusion_tpu_torch.configs import BERT_TINY, VAE_TINY
    from pea_diffusion_tpu_torch.pipelines import build_models

    pmodels = build_models(
        family="chinese_clip", text_cfg=BERT_TINY, adapter_cfg=tiny_adapter_config("sdxl"),
        unet_cfg=dataclasses.replace(port_unet_cfg.SDXL_UNET_TINY, in_channels=9),
        vae_cfg=VAE_TINY, dtype=torch.float32, device="cpu", seed=3)
    root = tmp_path / "inpaint"
    dirs.write_model_dir(root, dict(dirs.SDXL_UNET_JSON, in_channels=9),
                         pmodels.unet.state_dict(), pmodels.vae.state_dict())
    dirs.write_text_dir(str(tmp_path / "text"), pmodels.text_encoder.state_dict())
    monkeypatch.setitem(ADAPTER_PRESETS, "tiny", pmodels.adapter.config)
    adapter = orbax_io.export_adapter(pmodels.adapter, str(tmp_path), 1)
    seen = []
    monkeypatch.setattr(pmodels.unet.__class__, "forward", _recording(seen))
    out = tmp_path / "out.png"
    main(["--model-dir", str(root), "--text-encoder-dir", str(tmp_path / "text"),
          "--adapter", f"{adapter}/pytorch_model.bin", "--adapter-preset", "tiny",
          "--inpaint-image", pictures[0], "--mask", pictures[1], "--sampler", "ddim",
          "--steps", "2", "--size", "32", "--max-length", "8", "--device", "cpu",
          "--prompt", "一丁", "-o", str(out)])
    assert Image.open(out).size == (32, 32)
    assert seen and set(seen) == {9}
    assert f"wrote {out}" in capsys.readouterr().out


def _recording(seen):
    from pea_diffusion_tpu_torch.models.unet import UNet2DCondition

    forward = UNet2DCondition.forward

    def record(self, sample, *args, **kwargs):
        seen.append(sample.shape[-1])
        return forward(self, sample, *args, **kwargs)

    return record
