"""The port's SDXL ControlNet slice held against the JAX package's, in fp32 on
the CPU at tiny widths (SDXL_UNET_TINY, the demo's conditioning embedder
(8, 8, 16, 16)): the ControlNet module's residuals, the UNet fed with them,
the state dict's round trip through the JAX package's ``convert_controlnet``,
the keep schedule, the control image's preprocessing, the numpy Canny, the
whole ``generate_sdxl_controlnet`` (CFG, guess mode, a (0, 0.6) keep window)
given the noise JAX's function draws from its key, and the CLI's ControlNet
mode.

Tolerances: atol 2e-4 through the ControlNet and the UNet (fp32 sums in
another order in each framework), 2e-3 on the final images (as the
text-to-image slice); exact for the keep schedule, the preprocessing and the
Canny map (the same numpy arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_tree_equal, host_params, perturb, t, to_numpy_sd
from pea_diffusion_tpu.checkpoints.torch_convert import convert_controlnet
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JaxAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.configs.unet import ControlNetConfig as JaxControlNetConfig
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.models.controlnet import ControlNet as JaxControlNet
from pea_diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from pea_diffusion_tpu.pipelines import controlnet as jax_cn
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli.generate import build_demo, main
from pea_diffusion_tpu_torch.configs import SDXL_UNET_TINY, ControlNetConfig
from pea_diffusion_tpu_torch.models import ControlNet, UNet2DCondition
from pea_diffusion_tpu_torch.pipelines import (build_controlnet, canny_edges,
                                               generate_sdxl, generate_sdxl_controlnet,
                                               keep_schedule, prepare_control_image)
from pea_diffusion_tpu_torch.pipelines.controlnet import _canny_numpy

EMBED = (8, 8, 16, 16)  # the demo's embedder: three stride-2 stages, image -> latent
CFG = ControlNetConfig(unet=SDXL_UNET_TINY, conditioning_embedding_channels=EMBED)
JAX_CFG = JaxControlNetConfig(unet=JAX_UNET_TINY, conditioning_embedding_channels=EMBED)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=2e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


def test_config_is_a_copy_of_the_jax_one():
    assert dataclasses.asdict(ControlNetConfig()) == dataclasses.asdict(JaxControlNetConfig())
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JAX_CFG)


@pytest.fixture(scope="module")
def module_inputs():
    cfg = SDXL_UNET_TINY
    pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
    return dict(
        x=_rand(2, 8, 8, 4), ts=np.array([999, 500], np.int32),
        ehs=_rand(2, 5, cfg.cross_attention_dim, seed=1),
        cond=np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
        added={"text_embeds": _rand(2, pooled, seed=3),
               "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))})


@pytest.fixture(scope="module")
def controlnets(module_inputs):
    a = module_inputs
    jm = JaxControlNet(JAX_CFG)
    params = host_params(jm, a["x"], a["ts"], a["ehs"], a["cond"], 1.0, a["added"], seed=5)
    pm = ControlNet(CFG)
    pm.load_state_dict(from_jax.controlnet_state_dict(params, CFG), strict=True)
    return jm, params, pm


def test_controlnet_residuals_match_jax_and_the_state_dict_round_trips(module_inputs,
                                                                      controlnets):
    a = module_inputs
    jm, params, pm = controlnets
    want_down, want_mid = jm.apply(params, a["x"], a["ts"], a["ehs"], a["cond"], 0.7,
                                   a["added"])
    added = {k: t(v) for k, v in a["added"].items()}
    down, mid = pm(t(a["x"]), torch.from_numpy(a["ts"]), t(a["ehs"]), t(a["cond"]),
                   torch.tensor(0.7), added)
    assert len(down) == len(want_down) == 9
    for got, want in zip(down, want_down):
        assert got.shape == want.shape
        _close(got, want)
    _close(mid, want_mid)
    assert float(np.abs(np.asarray(want_mid)).max()) > 0
    assert_tree_equal(convert_controlnet(to_numpy_sd(pm), JAX_CFG), params)


def test_unet_fed_by_the_controlnet_matches_jax(module_inputs, controlnets):
    a = module_inputs
    jm, params, pm = controlnets
    ju = JaxUNet(JAX_UNET_TINY)
    uparams = host_params(ju, a["x"], a["ts"], a["ehs"], a["added"], seed=6)
    pu = UNet2DCondition(SDXL_UNET_TINY)
    pu.load_state_dict(from_jax.unet_state_dict(uparams, SDXL_UNET_TINY), strict=True)
    down, mid = jm.apply(params, a["x"], a["ts"], a["ehs"], a["cond"], 0.5, a["added"])
    want = ju.apply(uparams, a["x"], a["ts"], a["ehs"], a["added"],
                    down_block_additional_residuals=down, mid_block_additional_residual=mid)
    added = {k: t(v) for k, v in a["added"].items()}
    ts = torch.from_numpy(a["ts"])
    pdown, pmid = pm(t(a["x"]), ts, t(a["ehs"]), t(a["cond"]), 0.5, added)
    got = pu(t(a["x"]), ts, t(a["ehs"]), added, down_block_additional_residuals=pdown,
             mid_block_additional_residual=pmid)
    _close(got, want)


@pytest.mark.parametrize("steps,start,end", [(10, 0.0, 1.0), (10, 0.3, 0.7), (3, 0.0, 0.6),
                                             (1, 0.0, 1.0), (7, 0.5, 0.5)])
def test_keep_schedule_matches_jax(steps, start, end):
    np.testing.assert_array_equal(keep_schedule(steps, start, end).numpy(),
                                  np.asarray(jax_cn.keep_schedule(steps, start, end)))


@pytest.mark.parametrize("image", [
    np.random.default_rng(0).integers(0, 256, (32, 32)),           # HW ints, resized
    np.random.default_rng(1).integers(0, 256, (64, 64, 3)).astype(np.uint8),  # same size
    np.random.default_rng(2).uniform(0, 1, (48, 40, 3)).astype(np.float32),   # [0, 1] floats
])
def test_prepare_control_image_matches_jax(image):
    want = jax_cn.prepare_control_image(image, 64, 64, 2)
    got = prepare_control_image(image, 64, 64, 2)
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,low,high", [((48, 48), 60, 120), ((40, 56, 3), 100, 200)])
def test_canny_numpy_is_bit_equal_to_jax(shape, low, high):
    rng = np.random.default_rng(3)
    img = np.zeros(shape, np.uint8)
    img[10:30, 12:40] = 200
    img = np.clip(img + rng.integers(0, 40, shape), 0, 255).astype(np.uint8)
    got = _canny_numpy(img, low, high)
    np.testing.assert_array_equal(got, jax_cn._canny_numpy(img, low, high))
    assert got.dtype == np.uint8 and got.any()
    assert canny_edges(img).shape == shape[:2] + (3,)


@pytest.fixture(scope="module")
def stacks():
    """The tiny SDXL stack and tiny ControlNet in both frameworks at the
    same weights (the ControlNet's zero convs filled too)."""
    ucfg = JAX_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(JAX_BERT_TINY.hidden_size, (96, pooled),
                                     head_dim=ucfg.cross_attention_dim),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, dtype=jnp.float32)
    params = perturb(jax_factory.init_params_host(jmodels, "chinese_clip", JAX_BERT_TINY),
                     seed=8)
    pmodels, tokenize, _ = build_demo(device="cpu")
    pmodels.text_encoder.load_state_dict(from_jax.bert_text_state_dict(params["text"]))
    pmodels.adapter.load_state_dict(from_jax.adapter_state_dict(params["adapter"]))
    pmodels.unet.load_state_dict(from_jax.unet_state_dict(params["unet"], ucfg))
    pmodels.vae.load_state_dict(from_jax.vae_state_dict(params["vae"], JAX_VAE_TINY))
    jcn = JaxControlNet(JAX_CFG)
    cn_params = host_params(
        jcn, np.zeros((1, 8, 8, 4), np.float32), np.zeros((1,), np.int32),
        np.zeros((1, 16, ucfg.cross_attention_dim), np.float32),
        np.zeros((1, 64, 64, 3), np.float32), 1.0,
        {"text_embeds": np.zeros((1, pooled), np.float32),
         "time_ids": np.zeros((1, 6), np.float32)}, seed=9)
    pcn = build_controlnet(SDXL_UNET_TINY, EMBED, dtype=torch.float32, device="cpu")
    pcn.load_state_dict(from_jax.controlnet_state_dict(cn_params, CFG), strict=True)
    control = prepare_control_image(canny_edges(
        np.random.default_rng(4).integers(0, 256, (64, 64, 3)).astype(np.uint8)), 64, 64, 1)
    return jmodels, params, jcn, cn_params, pmodels, pcn, tokenize, control


@pytest.mark.parametrize("guess,start,end,scale", [
    (False, 0.0, 1.0, 1.0), (True, 0.0, 1.0, 0.8), (False, 0.0, 0.6, 1.0)])
def test_generate_sdxl_controlnet_matches_jax(stacks, guess, start, end, scale):
    jmodels, params, jcn, cn_params, pmodels, pcn, tokenize, control = stacks
    ids, uncond = tokenize(["一只戴着帽子的可爱猫咪"]), tokenize([""])
    key = jax.random.PRNGKey(6)
    kw = dict(sampler_name="ddim", height=64, width=64, num_steps=2, guidance_scale=7.5,
              controlnet_conditioning_scale=scale, guess_mode=guess,
              control_guidance_start=start, control_guidance_end=end)
    want = jax_cn.generate_sdxl_controlnet(
        jmodels, jcn, params, cn_params, jnp.asarray(ids, jnp.int32),
        jnp.asarray(uncond, jnp.int32), jnp.asarray(control.numpy()), key, **kw)
    noise = np.array(jax.random.normal(key, (1, 8, 8, 4), jnp.float32))
    got = generate_sdxl_controlnet(pmodels, pcn, ids, uncond, control, init_noise=noise, **kw)
    assert got.shape == (1, 16, 16, 3)
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def test_residuals_reach_the_unet_and_zero_convs_leave_it_alone(stacks):
    """With the zero convs at zero (the factory's default, as diffusers and
    the JAX package initialise them) the image is text-to-image's; with
    random ones, scale 0 is text-to-image's and scale 1 differs."""
    _, _, _, _, pmodels, pcn, tokenize, control = stacks
    ids, uncond = tokenize(["雪山"]), tokenize([""])
    noise = _rand(1, 8, 8, 4, seed=5)
    kw = dict(sampler_name="ddim", height=64, width=64, num_steps=2, init_noise=noise)
    plain = generate_sdxl(pmodels, ids, uncond, **kw)
    zeroed = build_controlnet(SDXL_UNET_TINY, EMBED, dtype=torch.float32, device="cpu")
    assert all(c.weight.abs().max() == 0 for c in zeroed.zero_convs())
    np.testing.assert_allclose(
        generate_sdxl_controlnet(pmodels, zeroed, ids, uncond, control, **kw).numpy(),
        plain.numpy(), atol=1e-6)
    off = generate_sdxl_controlnet(pmodels, pcn, ids, uncond, control,
                                   controlnet_conditioning_scale=0.0, **kw)
    on = generate_sdxl_controlnet(pmodels, pcn, ids, uncond, control, **kw)
    np.testing.assert_allclose(off.numpy(), plain.numpy(), atol=1e-6)
    assert (on - off).abs().max() > 1e-3


def test_cli_controlnet_demo_writes_an_image(tmp_path):
    from PIL import Image

    ctrl = tmp_path / "ctrl.png"
    arr = np.zeros((64, 64, 3), np.uint8)
    arr[16:48, 16:48] = 255
    Image.fromarray(arr).save(ctrl)
    out = tmp_path / "out.png"
    main(["--demo", "--device", "cpu", "--size", "64", "--steps", "2", "--sampler", "ddim",
          "--control-image", str(ctrl), "--control-canny", "--control-scale", "0.8",
          "--control-end", "0.6", "--control-guess", "-o", str(out)])
    assert Image.open(out).size == (16, 16)  # VAE_TINY upsamples 2x


def test_cli_controlnet_checkpoints_name_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 9"):
        main(["--demo", "--device", "cpu", "--controlnet", str(tmp_path),
              "--control-image", "x.png"])


def test_smoke_derives_every_groupnorm_call_from_the_modules():
    """chip_smoke.py expects as many B6/B6-b launches as its walk of the
    modules gives. The walk must name every GroupNorm call of a forward at
    the shape it runs: held here against hooks on the tiny UNet, ControlNet
    and VAE decoder, and, by module counts, on the full SDXL ones (UNet 29
    B6 + 17 B6-b, ControlNet 13 + 8, VAE decoder 30 + 0)."""
    from collections import Counter

    import chip_smoke
    from pea_diffusion_tpu_torch.configs import SDXL_UNET, SDXL_VAE, VAE_TINY
    from pea_diffusion_tpu_torch.models import AutoencoderKL
    from pea_diffusion_tpu_torch.models.layers import GroupNorm

    seen = Counter()

    def hook(mod, args, kwargs):
        x = args[0]
        kern = "B6-b" if kwargs.get("extra_bias") is not None else "B6"
        seen[kern, x.shape[0], x.shape[1], x.shape[2], mod.act] += 1

    unet, cn = UNet2DCondition(SDXL_UNET_TINY), ControlNet(CFG)
    decoder = AutoencoderKL(VAE_TINY).decoder
    for m in (unet, cn, decoder):
        for norm in m.modules():
            if isinstance(norm, GroupNorm):
                norm.register_forward_pre_hook(hook, with_kwargs=True)
    pooled = (SDXL_UNET_TINY.projection_class_embeddings_input_dim
              - 6 * SDXL_UNET_TINY.addition_time_embed_dim)
    x, ts, ctx = torch.zeros(2, 8, 8, 4), torch.tensor([1, 2]), torch.zeros(2, 5, 64)
    added = {"text_embeds": torch.zeros(2, pooled), "time_ids": torch.zeros(2, 6)}
    with torch.no_grad():
        unet(x, ts, ctx, added)
        cn(x, ts, ctx, torch.zeros(2, 64, 64, 3), 1.0, added)
        decoder(torch.zeros(1, 4, 8, 8))
    want = (chip_smoke.groupnorm_calls(unet, 8, 2) + chip_smoke.groupnorm_calls(cn, 8, 2)
            + chip_smoke.groupnorm_calls(decoder, 8, 1))
    assert seen == want

    with torch.device("meta"):
        full = {(29, 17): UNet2DCondition(SDXL_UNET),
                (13, 8): ControlNet(ControlNetConfig(unet=SDXL_UNET)),
                (30, 0): AutoencoderKL(SDXL_VAE).decoder}
    for counts, m in full.items():
        calls = chip_smoke.groupnorm_calls(m, 128, 2)
        assert tuple(sum(n for k, n in calls.items() if k[0] == kern)
                     for kern in ("B6", "B6-b")) == counts
