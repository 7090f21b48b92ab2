"""The port's weight loading held against the JAX package's, on files the
tests write: safetensors both ways (every dtype; the same bytes from one
dict), LoRA fusion in the peft, legacy and kohya formats (text-encoder
routing, the to_out -> to_out.0 retry, 1x1 convolutions), the loaders on
tiny SDXL, SD1.5 and ControlNet directories (sharded safetensors, a .bin, a
trailing v-prediction scheduler, a prefixed Chinese-CLIP text checkpoint, a
LoRA), the reference adapter format, and the generate CLI's real mode.

Tolerances: exact for files, configs, schedules and adapter weights (the
same bytes); 1e-6 on fused weights in fp32 (a float32 product summed in
another order); atol 1e-4 through the text tower, VAE and ControlNet and
2e-4 through the whole UNet, as tests/test_torch_models.py (fp32 sums in
another order in each framework).
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import _torch_dirs as dirs
from _torch_parity import host_params, t
from pea_diffusion_tpu.checkpoints import load_pretrained as jax_lp
from pea_diffusion_tpu.checkpoints import lora as jax_lora
from pea_diffusion_tpu.checkpoints import orbax_io as jax_orbax
from pea_diffusion_tpu.checkpoints import safetensors_io as jax_st
from pea_diffusion_tpu.configs import unet as jax_unet_cfg
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.configs.text_encoder import CLIP_TINY as JAX_CLIP_TINY
from pea_diffusion_tpu.configs.text_encoder import T5_TINY as JAX_T5_TINY
from pea_diffusion_tpu.configs import text_encoder as jax_text_cfg
from pea_diffusion_tpu.models.adapter import PEAAdapter as JaxAdapter
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JaxBert
from pea_diffusion_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from pea_diffusion_tpu.models.controlnet import ControlNet as JaxControlNet
from pea_diffusion_tpu.models.mt5 import T5Encoder as JaxT5
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from pea_diffusion_tpu_torch.checkpoints import from_jax, load_pretrained, lora, orbax_io
from pea_diffusion_tpu_torch.checkpoints import safetensors_io as st
from pea_diffusion_tpu_torch.cli.generate import main
from pea_diffusion_tpu_torch.configs import ADAPTER_PRESETS, CLIP_TINY, UNetConfig, VAEConfig
from pea_diffusion_tpu_torch.configs import text_encoder as port_text_cfg
from pea_diffusion_tpu_torch.configs import unet as port_unet_cfg
from pea_diffusion_tpu_torch.models import PEAAdapter
from pea_diffusion_tpu_torch.pipelines.factory import make_text_encoder_fn
from pea_diffusion_tpu_torch.schedulers import NoiseScheduleConfig

CPU = dict(device="cpu")


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


# --- safetensors ------------------------------------------------------------

DTYPES = [np.float64, np.float32, np.float16, np.int64, np.int32, np.int16, np.int8,
          np.uint8, np.bool_]


def _sample(dtype, seed=0):
    rng = np.random.default_rng(seed)
    return {"a.weight": np.abs(rng.standard_normal((3, 5)) * 50).astype(dtype),
            "b": (rng.standard_normal(7) * 50 * (np.dtype(dtype).kind != "u")).astype(dtype),
            "scalar": np.asarray(abs(rng.standard_normal()) * 50).astype(dtype),
            "empty": np.zeros((0, 4), dtype)}


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_safetensors_both_ways_and_the_same_bytes(tmp_path, dtype):
    tensors = _sample(dtype)
    jax_file, port_file = str(tmp_path / "jax.safetensors"), str(tmp_path / "port.safetensors")
    jax_st.save_safetensors(jax_file, tensors, metadata={"format": "pt"})
    st.save_safetensors(port_file, tensors, metadata={"format": "pt"})
    assert open(jax_file, "rb").read() == open(port_file, "rb").read()
    for got in (st.load_safetensors(jax_file), jax_st.load_safetensors(port_file),
                {k: v.numpy() for k, v in st.load_safetensors_torch(jax_file).items()}):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            v = np.ascontiguousarray(v)  # both writers store a 0-d array as shape [1]
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v)


def test_safetensors_bf16_from_torch_reads_the_same_in_both(tmp_path):
    """The JAX writer takes numpy arrays, which have no bfloat16: the port
    writes BF16 from torch tensors, and both readers give the same values
    (float32 by default, the raw bits without the upcast); the port's torch
    reader keeps bfloat16 with the same bits."""
    w = torch.from_numpy(_rand(6, 9)).bfloat16()
    path = str(tmp_path / "bf16.safetensors")
    st.save_safetensors(path, {"w": w, "f16": w.half(), "f32": w.float()})
    want = w.float().numpy()
    for upcast in (True, False):
        a, b = jax_st.load_safetensors(path, upcast), st.load_safetensors(path, upcast)
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["f16"], w.half().numpy())
    np.testing.assert_array_equal(jax_st.load_safetensors(path)["w"], want)
    np.testing.assert_array_equal(jax_st.load_safetensors(path, False)["w"],
                                  w.view(torch.int16).numpy().view(np.uint16))
    mm = st.load_safetensors_torch(path)
    assert mm["w"].dtype == torch.bfloat16 and torch.equal(mm["w"], w)
    assert st.load_safetensors_torch(path, upcast_bf16=True)["w"].dtype == torch.float32


# --- LoRA ---------------------------------------------------------------------

BASE = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"
KOHYA = "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn1_to_q"


def _lora_case(fmt, rng):
    down = rng.standard_normal((4, 6)).astype(np.float32)  # rank 4
    up = rng.standard_normal((8, 4)).astype(np.float32)
    if fmt == "peft":
        return {f"unet.{BASE}.lora_A.weight": down, f"unet.{BASE}.lora_B.weight": up}
    if fmt == "legacy":
        return {f"{BASE}.lora.down.weight": down, f"{BASE}.lora.up.weight": up}
    if fmt == "legacy_linear_layer":
        return {f"{BASE}.lora_linear_layer.down.weight": down,
                f"{BASE}.lora_linear_layer.up.weight": up}
    return {f"{KOHYA}.lora_down.weight": down, f"{KOHYA}.lora_up.weight": up,
            f"{KOHYA}.alpha": np.float32(6.0)}


def _merge_both(sd, lora_sd, scale, component="unet"):
    want = jax_lora.merge_lora_into_state_dict(sd, lora_sd, scale, component=component)
    got, n = lora.merge_lora_into_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()},
        {k: torch.as_tensor(v) for k, v in lora_sd.items()}, scale, component=component)
    return want, got, n


@pytest.mark.parametrize("fmt", ["peft", "legacy", "legacy_linear_layer", "kohya"])
def test_lora_merge_matches_jax(fmt):
    rng = np.random.default_rng(0)
    sd = {f"{BASE}.weight": rng.standard_normal((8, 6)).astype(np.float32),
          "other.weight": np.ones((3, 3), np.float32)}
    want, got, n = _merge_both(sd, _lora_case(fmt, rng), 0.7)
    assert n == 1 and not np.allclose(want[f"{BASE}.weight"], sd[f"{BASE}.weight"])
    for k in sd:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("fmt", ["peft", "kohya"])
def test_lora_text_encoder_routing_matches_jax(fmt):
    rng = np.random.default_rng(2)
    path = "text_model.encoder.layers.0.self_attn.q_proj"
    sd = {f"{path}.weight": rng.standard_normal((8, 6)).astype(np.float32)}
    down = rng.standard_normal((2, 6)).astype(np.float32)
    up = rng.standard_normal((8, 2)).astype(np.float32)
    if fmt == "peft":
        lora_sd = {f"text_encoder_2.{path}.lora_A.weight": down,
                   f"text_encoder_2.{path}.lora_B.weight": up}
    else:
        kbase = "lora_te2_text_model_encoder_layers_0_self_attn_q_proj"
        lora_sd = {f"{kbase}.lora_down.weight": down, f"{kbase}.lora_up.weight": up}
    for component, fused in (("text_encoder", 0), ("text_encoder_2", 1), ("unet", 0)):
        want, got, n = _merge_both(sd, lora_sd, 1.0, component)
        assert n == fused
        np.testing.assert_allclose(got[f"{path}.weight"].numpy(), want[f"{path}.weight"],
                                   atol=1e-6, rtol=0)


def test_lora_to_out_retry_and_1x1_conv_match_jax(capsys):
    """`to_out` pairs fuse into to_out.0; 1x1 convolution LoRAs (4-D or 2-D
    down) into a [out, in, 1, 1] weight; a pair with no base weight is
    reported and skipped."""
    rng = np.random.default_rng(1)
    to_out = "mid_block.attentions.0.transformer_blocks.0.attn2.to_out"
    conv = "down_blocks.0.resnets.0.conv_shortcut"
    proj = "down_blocks.0.attentions.0.proj_in"
    sd = {f"{to_out}.0.weight": rng.standard_normal((4, 4)).astype(np.float32),
          f"{conv}.weight": rng.standard_normal((6, 5, 1, 1)).astype(np.float32),
          f"{proj}.weight": rng.standard_normal((6, 5, 1, 1)).astype(np.float32)}
    lora_sd = {
        f"unet.{to_out}.lora_A.weight": rng.standard_normal((2, 4)).astype(np.float32),
        f"unet.{to_out}.lora_B.weight": rng.standard_normal((4, 2)).astype(np.float32),
        f"{conv}.lora.down.weight": rng.standard_normal((3, 5, 1, 1)).astype(np.float32),
        f"{conv}.lora.up.weight": rng.standard_normal((6, 3, 1, 1)).astype(np.float32),
        f"unet.{proj}.lora_A.weight": rng.standard_normal((3, 5)).astype(np.float32),
        f"unet.{proj}.lora_B.weight": rng.standard_normal((6, 3)).astype(np.float32),
        "unet.no.such.layer.lora_A.weight": np.ones((1, 2), np.float32),
        "unet.no.such.layer.lora_B.weight": np.ones((2, 1), np.float32),
    }
    want, got, n = _merge_both(sd, lora_sd, 0.5)
    assert n == 3
    assert capsys.readouterr().out.count("no base weight for unet.no.such.layer") == 2
    for k in sd:
        assert not np.allclose(want[k], sd[k]), k
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=1e-6, rtol=0, err_msg=k)


def test_lora_merge_into_bf16_weights_gives_the_jax_bits():
    """A bf16 weight fuses in float32 and is cast back once: the bits of
    the JAX package's merge on the upcast weight, cast to bfloat16 last."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((16, 12)).astype(np.float32)).bfloat16()
    lora_sd = {f"unet.{BASE}.lora_A.weight": rng.standard_normal((4, 12)).astype(np.float32),
               f"unet.{BASE}.lora_B.weight": rng.standard_normal((16, 4)).astype(np.float32)}
    want = jax_lora.merge_lora_into_state_dict({f"{BASE}.weight": w.float().numpy()},
                                               lora_sd, 0.8)[f"{BASE}.weight"]
    got, _ = lora.merge_lora_into_state_dict(
        {f"{BASE}.weight": w}, {k: torch.from_numpy(v) for k, v in lora_sd.items()}, 0.8)
    assert got[f"{BASE}.weight"].dtype == torch.bfloat16
    assert torch.equal(got[f"{BASE}.weight"], torch.from_numpy(want).bfloat16())


# --- configs and schedules -----------------------------------------------------

SSD1B_JSON = dict(dirs.SDXL_UNET_JSON, block_out_channels=[320, 640, 1280],
                  attention_head_dim=[5, 10, 20], cross_attention_dim=2048,
                  norm_num_groups=32, addition_time_embed_dim=256,
                  projection_class_embeddings_input_dim=2816,
                  transformer_layers_per_block=[1, [2, 2], [4, 4]],
                  reverse_transformer_layers_per_block=[[4, 4, 4], [2, 2, 1], 0])


@pytest.mark.parametrize("name,config", [
    ("sd15", dict(dirs.SD15_UNET_JSON, block_out_channels=[320, 640, 1280, 1280],
                  attention_head_dim=8, cross_attention_dim=768, norm_num_groups=32)),
    ("sdxl", dict(dirs.SDXL_UNET_JSON, block_out_channels=[320, 640, 1280],
                  transformer_layers_per_block=[1, 2, 10], attention_head_dim=[5, 10, 20],
                  cross_attention_dim=2048, norm_num_groups=32, addition_time_embed_dim=256,
                  projection_class_embeddings_input_dim=2816)),
    ("ssd1b", SSD1B_JSON),
    ("heads_by_count", dict(dirs.SD15_UNET_JSON, num_attention_heads=[1, 2, 2, 4],
                            mid_block_type="UNetMidBlock2D")),
    ("tiny_sdxl", dirs.SDXL_UNET_JSON), ("tiny_sd15", dirs.SD15_UNET_JSON),
])
def test_from_diffusers_config_matches_jax(name, config):
    got = UNetConfig.from_diffusers_config(config)
    want = jax_unet_cfg.UNetConfig.from_diffusers_config(config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for i in range(got.num_blocks):
        assert got.down_block_layers(i) == want.down_block_layers(i)
        assert got.up_block_layers(i) == want.up_block_layers(i)
    presets = {"sd15": "SD15_UNET", "sdxl": "SDXL_UNET", "tiny_sdxl": "SDXL_UNET_TINY",
               "tiny_sd15": "SD15_UNET_TINY"}
    if name in presets:
        assert got == getattr(port_unet_cfg, presets[name])
    vae = dict(dirs.VAE_JSON, block_out_channels=[128, 256, 512, 512], norm_num_groups=32)
    assert dataclasses.asdict(VAEConfig.from_diffusers_config(vae)) == dataclasses.asdict(
        jax_unet_cfg.VAEConfig.from_diffusers_config(vae))
    assert VAEConfig.from_diffusers_config(vae) == VAEConfig(scaling_factor=0.13025,
                                                             force_upcast=False)


@pytest.mark.parametrize("scheduler", [None, dirs.TURBO_SCHEDULER_JSON,
                                       {"rescale_betas_zero_snr": True, "steps_offset": 0,
                                        "beta_schedule": "linear", "clip_sample": True}])
def test_load_schedule_matches_jax_field_by_field(tmp_path, scheduler):
    if scheduler is not None:
        dirs.write_json(str(tmp_path / "scheduler" / "scheduler_config.json"), scheduler)
    got = load_pretrained.load_schedule(str(tmp_path))
    want = jax_lp.load_schedule(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# --- loaders on tiny directories -------------------------------------------------

X, TS = _rand(2, 8, 8, 4), np.array([999, 500], np.int32)
EHS = _rand(2, 5, 64, seed=1)
ADDED = {"text_embeds": _rand(2, 64, seed=2),
         "time_ids": np.tile(np.array([[64, 64, 0, 0, 64, 64]], np.float32), (2, 1))}


def _unet_sd(model, seed):
    cfg = (port_unet_cfg.SDXL_UNET_TINY if model == "sdxl" else port_unet_cfg.SD15_UNET_TINY)
    jcfg = (jax_unet_cfg.SDXL_UNET_TINY if model == "sdxl" else jax_unet_cfg.SD15_UNET_TINY)
    params = host_params(JaxUNet(jcfg), X, TS, EHS, ADDED if model == "sdxl" else None,
                         seed=seed)
    return from_jax.unet_state_dict(params, cfg)


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """Tiny SDXL and SD1.5 model directories, a Chinese-CLIP text tower with
    its vocabulary, a LoRA over the SDXL UNet and an adapter checkpoint."""
    root = tmp_path_factory.mktemp("deploy")
    vae_params = host_params(JaxVAE(jax_unet_cfg.VAE_TINY), _rand(1, 16, 16, 3),
                             jax.random.PRNGKey(1), seed=3)
    vae_sd = from_jax.vae_state_dict(vae_params, port_unet_cfg.VAE_TINY)
    sdxl_sd = _unet_sd("sdxl", 1)
    out = {"sdxl_sd": sdxl_sd,
           "sdxl": dirs.write_model_dir(root / "sdxl", dirs.SDXL_UNET_JSON, sdxl_sd, vae_sd,
                                        dirs.TURBO_SCHEDULER_JSON),
           "sd15": dirs.write_model_dir(root / "sd15", dirs.SD15_UNET_JSON, _unet_sd("sd15", 2),
                                        vae_sd, unet_shards=1, vae_fmt="safetensors")}
    ids = np.random.default_rng(0).integers(5, 1000, (2, 12)).astype(np.int32)
    text_params = host_params(JaxBert(JAX_BERT_TINY), ids, seed=4)
    out["text_sd"] = from_jax.bert_text_state_dict(text_params)
    out["ids"] = ids
    out["text"] = str(root / "text")
    dirs.write_text_dir(out["text"], out["text_sd"])
    out["lora"] = str(root / "lora.safetensors")
    jax_st.save_safetensors(out["lora"], dirs.peft_lora(dirs.numpy_sd(sdxl_sd), rank=4))
    adapter = PEAAdapter(ADAPTER_PRESETS["sdxl_small"])
    out["adapter_module"] = adapter
    out["adapter"] = orbax_io.export_adapter(adapter, str(root), 5)
    return out


_JAX_UNET = {model: jax.jit(lambda p, added, jcfg=jcfg: JaxUNet(jcfg).apply(p, X, TS, EHS, added))
             for model, jcfg in (("sdxl", jax_unet_cfg.SDXL_UNET_TINY),
                                 ("sd15", jax_unet_cfg.SD15_UNET_TINY))}


def _unet_forward(model, jparams, jcfg, module):
    added = ADDED if model == "sdxl" else None
    assert jcfg == (jax_unet_cfg.SDXL_UNET_TINY if model == "sdxl"
                    else jax_unet_cfg.SD15_UNET_TINY)
    want = _JAX_UNET[model](jparams, added)
    got = module(t(X), torch.from_numpy(TS).long(), t(EHS),
                 None if added is None else {k: t(v) for k, v in added.items()})
    return got, want


@pytest.mark.parametrize("model,with_lora", [("sdxl", False), ("sdxl", True), ("sd15", False)])
def test_load_unet_matches_jax(deployment, model, with_lora):
    """The loaded UNet's forward against JAX's load_unet on the same files
    (SDXL: two safetensors shards; SD1.5: 1x1-conv projections), with and
    without the LoRA fused; dtype bf16 casts every weight once."""
    loras = [deployment["lora"]] if with_lora else []
    jcfg, jparams = jax_lp.load_unet(deployment[model], lora_paths=loras)
    cfg, unet = load_pretrained.load_unet(deployment[model], lora_paths=loras, **CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got, want = _unet_forward(model, jparams, jcfg, unet)
    _close(got, want, atol=2e-4)
    if model == "sdxl":
        key = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight"
        moved = not torch.equal(unet.state_dict()[key], deployment["sdxl_sd"][key])
        assert moved == with_lora
        _, b16 = load_pretrained.load_unet(deployment[model], lora_paths=loras,
                                           dtype=torch.bfloat16, **CPU)
        assert torch.equal(b16.state_dict()[key], unet.state_dict()[key].bfloat16())


def test_load_vae_and_bert_text_match_jax(deployment, tmp_path):
    jcfg, jparams = jax_lp.load_vae(deployment["sdxl"])
    cfg, vae = load_pretrained.load_vae(deployment["sdxl"], **CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.scaling_factor == 0.13025
    z = _rand(1, 4, 4, 4, seed=5)
    jm = JaxVAE(jcfg)
    want = jax.jit(lambda p: jm.apply(p, z, method=jm.decode))(jparams)
    _close(vae.decode(t(z)), want)
    _, sd15_vae = load_pretrained.load_vae(deployment["sd15"], **CPU)  # from safetensors
    _close(sd15_vae.decode(t(z)), want)

    jcfg, jparams = jax_lp.load_bert_text(deployment["text"])
    cfg, text = load_pretrained.load_student_tower("chinese_clip", deployment["text"], **CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ids = deployment["ids"]
    want = JaxBert(jcfg).apply(jparams, ids)
    _close(text(torch.from_numpy(ids).long()).last_hidden_state, want.last_hidden_state)
    # the mt5 family from a transformers mT5 directory
    mt5_dir = dirs.write_mt5(str(tmp_path / "mt5"), _tower_sd("mt5"))
    jcfg, jparams = jax_lp.load_student_tower("mt5", mt5_dir)
    cfg, text = load_pretrained.load_student_tower("mt5", mt5_dir, **CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(JAX_T5_TINY)
    _close(text(torch.from_numpy(ids).long()), JaxT5(jcfg).apply(jparams, ids))


# --- the other student towers -----------------------------------------------

JAX_XLMR_TINY = dataclasses.replace(JAX_BERT_TINY, **dirs.XLMR_SETTINGS)
JAX_ALTCLIP_TINY = dataclasses.replace(JAX_XLMR_TINY, project_dim=24)


def _tower_sd(kind, seed=7):
    """A tiny tower's port state dict from seeded JAX params: "xlmr",
    "altclip" (the 24-d head), "bert" or "mt5"."""
    if kind == "mt5":
        ids = np.zeros((1, 8), np.int32)
        return from_jax.t5_encoder_state_dict(host_params(JaxT5(JAX_T5_TINY), ids, seed=seed))
    cfg = {"xlmr": JAX_XLMR_TINY, "altclip": JAX_ALTCLIP_TINY, "bert": JAX_BERT_TINY}[kind]
    return from_jax.bert_text_state_dict(host_params(JaxBert(cfg), np.zeros((1, 8), np.int32),
                                                     seed=seed))


@pytest.fixture
def tiny_tower_presets(monkeypatch):
    """The JAX and port loaders take open_clip's tower as XLM_ROBERTA_LARGE
    and an AltCLIP file without config.json as ALT_CLIP_XLMR_L: both set to
    the tiny towers for the test, in both packages."""
    for pkg in (jax_text_cfg, port_text_cfg):
        monkeypatch.setattr(pkg, "XLM_ROBERTA_LARGE", dataclasses.replace(
            pkg.BERT_TINY, **dirs.XLMR_SETTINGS))
        monkeypatch.setattr(pkg, "ALT_CLIP_XLMR_L", dataclasses.replace(
            pkg.BERT_TINY, project_dim=24, **dirs.XLMR_SETTINGS))


def _tower_files(family, root):
    """(directory, directory_zh) of `family`'s checkpoint files under root."""
    if family == "chinese_clip":
        return dirs.write_text_dir(str(root / "zh"), _tower_sd("bert")), None
    if family == "mul_clip":
        return dirs.write_open_clip_xlmr(str(root / "xlmr" / "open_clip_pytorch_model.bin"),
                                         _tower_sd("xlmr")), None
    if family == "alt_clip":
        return dirs.write_altclip(str(root / "altclip"), _tower_sd("altclip")), None
    if family == "mt5":
        return dirs.write_mt5(str(root / "mt5"), _tower_sd("mt5")), None
    mul, _ = _tower_files("mul_clip", root)
    zh, _ = _tower_files("chinese_clip", root)
    return os.path.dirname(mul), zh


def _ids_for(family, cfg):
    rng = np.random.default_rng(2)
    if family == "mul_zh":
        return {k: _ids_for("mul_clip" if k == "mul" else "chinese_clip", c)
                for k, c in zip(("mul", "zh"), cfg)}
    ids = rng.integers(5, 1000, (2, 10)).astype(np.int32)
    ids[1, 6:] = cfg.pad_token_id  # a padded tail
    return ids


@pytest.mark.parametrize("family", ["chinese_clip", "mul_clip", "alt_clip", "mt5", "mul_zh"])
def test_load_student_tower_every_family_matches_jax(tmp_path, tiny_tower_presets, family,
                                                     capsys):
    """Each family's checkpoint files through the JAX and the port's
    load_student_tower: equal configs, and the family's encoder function
    (make_text_encoder_fn on the loaded tower) giving JAX's token states."""
    directory, directory_zh = _tower_files(family, tmp_path)
    jcfg, jparams = jax_lp.load_student_tower(family, directory, directory_zh)
    cfg, module = load_pretrained.load_student_tower(family, directory, directory_zh, **CPU)
    if family == "mul_zh":
        assert [dataclasses.asdict(c) for c in cfg] == [dataclasses.asdict(c) for c in jcfg]
        assert {k.split(".")[0] for k in module.state_dict()} == {"mul", "zh"}
    else:
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ids = _ids_for(family, cfg)
    _, jfn = jax_factory.make_text_encoder_fn(family, jcfg)
    _, fn = make_text_encoder_fn(family, cfg, module)
    got = fn({k: torch.from_numpy(v).long() for k, v in ids.items()} if family == "mul_zh"
             else torch.from_numpy(ids).long())
    _close(got, jfn(jparams, ids))
    if family == "mt5":  # the tied embedding, a decoder weight and lm_head
        assert "3 extra keys ignored" in capsys.readouterr().out


def test_load_open_clip_xlmr_and_altclip_layouts_match_jax(tmp_path, tiny_tower_presets):
    """open_clip's checkpoint by its file and by its directory; AltCLIP in
    the HF layout (config from its text_config) and a FlagAI dump without a
    config (ALT_CLIP_XLMR_L), against the JAX loaders."""
    ids = _ids_for("mul_clip", port_text_cfg.XLM_ROBERTA_LARGE)
    path = dirs.write_open_clip_xlmr(str(tmp_path / "oc" / "open_clip_pytorch_model.bin"),
                                     _tower_sd("xlmr"))
    for where in (path, os.path.dirname(path)):
        jcfg, jparams = jax_lp.load_open_clip_xlmr(where)
        cfg, enc = load_pretrained.load_open_clip_xlmr(where, **CPU)
        assert cfg == port_text_cfg.XLM_ROBERTA_LARGE
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        _close(enc(torch.from_numpy(ids).long()).last_hidden_state,
               JaxBert(jcfg).apply(jparams, ids).last_hidden_state)
    for layout in ("hf", "flagai"):
        d = dirs.write_altclip(str(tmp_path / layout), _tower_sd("altclip", seed=9), layout)
        jcfg, jparams = jax_lp.load_altclip_text(d)
        cfg, enc = load_pretrained.load_altclip_text(d, **CPU)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and cfg.project_dim == 24
        _close(enc(torch.from_numpy(ids).long()).projected,
               JaxBert(jcfg).apply(jparams, ids).projected)


def test_the_wrong_tower_layouts_raise(tmp_path, tiny_tower_presets):
    """A checkpoint with no text.transformer.* keys is not open_clip's
    XLM-R, a BERT directory without pre_LN is not AltCLIP, mul_zh needs
    its Chinese directory: each raises ValueError in both packages, as does
    an unknown family."""
    zh = dirs.write_text_dir(str(tmp_path / "zh"), _tower_sd("bert"))
    for jax_fn, port_fn, match in (
            (jax_lp.load_open_clip_xlmr, load_pretrained.load_open_clip_xlmr,
             "text.transformer"),
            (jax_lp.load_altclip_text, load_pretrained.load_altclip_text, "pre_LN")):
        for fn in (jax_fn, functools.partial(port_fn, **CPU)):
            with pytest.raises(ValueError, match=match):
                fn(zh)
    for fn in (jax_lp.load_student_tower, functools.partial(load_pretrained.load_student_tower,
                                                            **CPU)):
        with pytest.raises(ValueError, match="second"):
            fn("mul_zh", zh)
        with pytest.raises(ValueError, match="unknown"):
            fn("wukong", zh)


def test_load_clip_text_fuses_the_text_encoder_2_half(tmp_path):
    """A transformers CLIPTextModelWithProjection directory, with a kohya
    LoRA's te2 half fused (component text_encoder_2) or left out
    (text_encoder), against JAX's load_clip_text."""
    ids = np.random.default_rng(0).integers(1, 999, (2, 8)).astype(np.int32)
    jparams = host_params(JaxCLIP(JAX_CLIP_TINY), ids, seed=6)
    sd = {("text_projection.weight" if k == "text_projection.weight" else f"text_model.{k}"): v
          for k, v in from_jax.clip_text_state_dict(jparams).items()}
    cfg_json = {"vocab_size": 1000, "hidden_size": 64, "num_hidden_layers": 2,
                "num_attention_heads": 4, "intermediate_size": 128,
                "max_position_embeddings": 77, "projection_dim": 64, "eos_token_id": 49407}
    dirs.write_component(str(tmp_path / "te2"), cfg_json, sd, name="model")
    rng = np.random.default_rng(1)
    kbase = "lora_te2_text_model_encoder_layers_1_self_attn_v_proj"
    lora_path = str(tmp_path / "lora.safetensors")
    jax_st.save_safetensors(lora_path, {
        f"{kbase}.lora_down.weight": rng.standard_normal((2, 64)).astype(np.float32),
        f"{kbase}.lora_up.weight": rng.standard_normal((64, 2)).astype(np.float32),
        f"{kbase}.alpha": np.asarray(4.0, np.float32)})
    for component in ("text_encoder_2", "text_encoder"):
        kw = dict(with_projection=True, lora_paths=[lora_path], component=component)
        jcfg, jp = jax_lp.load_clip_text(str(tmp_path / "te2"), **kw)
        cfg, enc = load_pretrained.load_clip_text(str(tmp_path / "te2"), **kw, **CPU)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) == dataclasses.asdict(
            CLIP_TINY)
        want, got = JaxCLIP(jcfg).apply(jp, ids), enc(torch.from_numpy(ids).long())
        _close(got.last_hidden_state, want.last_hidden_state)
        _close(got.projected, want.projected)


def test_load_controlnet_matches_jax(tmp_path):
    from pea_diffusion_tpu.configs.unet import ControlNetConfig as JaxControlNetConfig

    jcfg = JaxControlNetConfig(unet=jax_unet_cfg.SDXL_UNET_TINY,
                               conditioning_embedding_channels=(8, 8, 16, 16))
    cond = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    params = host_params(JaxControlNet(jcfg), X, TS, EHS, cond, 1.0, ADDED, seed=7)
    from pea_diffusion_tpu_torch.configs import ControlNetConfig

    pcfg = ControlNetConfig(unet=port_unet_cfg.SDXL_UNET_TINY,
                            conditioning_embedding_channels=(8, 8, 16, 16))
    dirs.write_component(str(tmp_path / "cn"), dirs.CONTROLNET_JSON,
                         from_jax.controlnet_state_dict(params, pcfg))
    jcfg2, jparams = jax_lp.load_controlnet(str(tmp_path / "cn"))
    cfg, cn = load_pretrained.load_controlnet(str(tmp_path / "cn"), **CPU)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg2) == dataclasses.asdict(jcfg)
    want_down, want_mid = jax.jit(lambda p: JaxControlNet(jcfg2).apply(
        p, X, TS, EHS, cond, 0.7, ADDED))(jparams)
    down, mid = cn(t(X), torch.from_numpy(TS), t(EHS), t(cond), torch.tensor(0.7),
                   {k: t(v) for k, v in ADDED.items()})
    for g, w in zip(down, want_down):
        _close(g, w, atol=2e-4)
    _close(mid, want_mid, atol=2e-4)


@pytest.mark.parametrize("part", ["unet", "text"])
def test_a_missing_key_raises(deployment, tmp_path, part):
    """The loader names the missing weights; the JAX loader raises too."""
    if part == "unet":
        sd = dict(deployment["sdxl_sd"])
        del sd["mid_block.attentions.0.transformer_blocks.1.attn2.to_k.weight"]
        d = dirs.write_model_dir(tmp_path, dirs.SDXL_UNET_JSON, sd, {}, unet_shards=1)
        port, jax_load = (lambda: load_pretrained.load_unet(d, **CPU),
                          lambda: jax_lp.load_unet(d))
    else:
        sd = dict(deployment["text_sd"])
        del sd["encoder.layer.1.output.dense.weight"]
        dirs.write_text_dir(str(tmp_path), sd)
        port, jax_load = (lambda: load_pretrained.load_bert_text(str(tmp_path), **CPU),
                          lambda: jax_lp.load_bert_text(str(tmp_path)))
    with pytest.raises(KeyError, match="weights missing"):
        port()
    with pytest.raises(KeyError):
        jax_load()


# --- the reference adapter format --------------------------------------------------


@pytest.mark.parametrize("scheme", ["projector", "fc"])
def test_import_adapter_matches_jax_on_both_naming_schemes(tmp_path, scheme):
    rng = np.random.default_rng(3)
    if scheme == "projector":  # a Sequential with GELUs: indices 0, 2, 4
        cfg = ADAPTER_PRESETS["sdxl_chinese_clip"]
        dims = [(1024, 1024, "projector.0"), (1024, 1024, "projector.2"),
                (1280, 1024, "projector.4"), (2048, 1280, "fc")]
    else:  # the two-layer fc1/fc2 variant: fc1 the projector, fc2 the head
        cfg = dataclasses.replace(ADAPTER_PRESETS["sd15_chinese_clip"], projector_dims=(96,),
                                  projector_bias=True, head_dim=64)
        dims = [(96, 1024, "fc1"), (64, 96, "fc2")]
    sd = {"layernorm.weight": 1 + 0.1 * rng.standard_normal(1024),
          "layernorm.bias": 0.1 * rng.standard_normal(1024)}
    for out_f, in_f, name in dims:
        sd[f"{name}.weight"] = rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)
        if name.startswith("fc"):
            sd[f"{name}.bias"] = 0.1 * rng.standard_normal(out_f)
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in sd.items()}
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(sd, path)
    got = orbax_io.import_adapter(path, PEAAdapter(cfg))
    want = jax_orbax.import_adapter(path)
    assert got.keys() == from_jax.adapter_state_dict(want).keys()
    for k, v in from_jax.adapter_state_dict(want).items():
        assert torch.equal(got[k], v), k
    x = _rand(2, 5, 1024, seed=8)
    jm = JaxAdapter(jax_adapter_cfg(cfg))
    pm = PEAAdapter(cfg)
    pm.load_state_dict(got)
    _close(pm(t(x))[1], jm.apply(want, x)[1], atol=1e-5)


def jax_adapter_cfg(cfg):
    from pea_diffusion_tpu.configs.adapter import AdapterConfig

    return AdapterConfig(**dataclasses.asdict(cfg))


def test_export_import_adapter_round_trip_both_ways(tmp_path, deployment):
    """The port writes proj_N/pytorch_model.bin and its safetensors sibling;
    each reads back to the same tensors in both packages, and a JAX export
    reads into the port."""
    adapter = deployment["adapter_module"]
    d = deployment["adapter"]
    want = adapter.state_dict()
    for name in ("pytorch_model.bin", "model.safetensors"):
        got = orbax_io.import_adapter(os.path.join(d, name))
        assert all(torch.equal(got[k], want[k]) for k in want) and got.keys() == want.keys()
        jax_got = from_jax.adapter_state_dict(jax_orbax.import_adapter(os.path.join(d, name)))
        assert all(torch.equal(jax_got[k], want[k]) for k in want)
    cfg = jax_adapter_cfg(ADAPTER_PRESETS["sdxl_small"])
    jparams = host_params(JaxAdapter(cfg), _rand(1, 4, 1024), seed=9)
    jd = jax_orbax.export_adapter(jparams, cfg, str(tmp_path), 3)
    for name in ("pytorch_model.bin", "model.safetensors"):
        got = orbax_io.import_adapter(os.path.join(jd, name), PEAAdapter(
            ADAPTER_PRESETS["sdxl_small"]))
        for k, v in from_jax.adapter_state_dict(jparams).items():
            assert torch.equal(got[k], v), k


def test_train_cli_starts_from_a_reference_adapter(tmp_path):
    """--resume-adapter loads a reference-format adapter before training:
    at learning rate 0 the step-1 export holds exactly its tensors."""
    from pea_diffusion_tpu_torch.cli import train as train_cli
    from pea_diffusion_tpu_torch.cli.generate import tiny_adapter_config

    start = PEAAdapter(tiny_adapter_config("sdxl"))
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in start.parameters():
            p.normal_(0.0, 0.05, generator=gen)
    d = orbax_io.export_adapter(start, str(tmp_path), 0)
    out = tmp_path / "run"
    train_cli.main(["--demo", "--device", "cpu", "--steps", "1", "--lr", "0", "--resume-adapter",
                    os.path.join(d, "model.safetensors"), "--output", str(out)])
    got = orbax_io.import_adapter(str(out / "proj_1" / "pytorch_model.bin"))
    assert got.keys() == start.state_dict().keys()
    for k, v in start.state_dict().items():
        assert torch.equal(got[k], v), k


# --- the CLI's real mode -------------------------------------------------------------


TINY_ADAPTER = dataclasses.replace(ADAPTER_PRESETS["sdxl_small"], in_dim=64,
                                   projector_dims=(96, 64), head_dim=64)


def test_cli_real_mode_serves_a_directory_with_a_lora(deployment, tmp_path, capsys,
                                                      monkeypatch):
    """--model-dir with --lora, the LCM sampler at guidance 0 and a
    transformers tokenizer read from the text tower's vocab.txt: one image
    (VAE_TINY decodes latents at twice their side), the LoRA fused. The
    tiny stack's adapter is registered as a preset for the run."""
    from PIL import Image

    monkeypatch.setitem(ADAPTER_PRESETS, "tiny", TINY_ADAPTER)
    d = orbax_io.export_adapter(PEAAdapter(TINY_ADAPTER), str(tmp_path), 1)
    out = tmp_path / "out.png"
    main(["--model-dir", deployment["sdxl"], "--text-encoder-dir", deployment["text"],
          "--adapter", os.path.join(d, "pytorch_model.bin"), "--adapter-preset",
          "tiny", "--lora", deployment["lora"], "--lora-scale", "0.5",
          "--sampler", "lcm", "--steps", "2", "--guidance", "0", "--size", "64",
          "--max-length", "8", "--device", "cpu", "--prompt", "一丁", "-o", str(out)])
    text = capsys.readouterr().out
    assert Image.open(out).size == (16, 16)
    assert "[lora] fused" in text and f"wrote {out}" in text


@pytest.mark.parametrize("family", ["mul_clip", "alt_clip", "mt5", "mul_zh"])
def test_cli_real_mode_serves_every_tower_family(deployment, tmp_path, capsys, monkeypatch,
                                                 tiny_tower_presets, family):
    """--family with its tower's files (mul_zh: --text-encoder-dir-2 the
    Chinese-CLIP directory, the prompt tokenized twice into dict ids); the
    tokenizer is the Chinese-CLIP directory's vocab.txt (--tokenizer-dir),
    whose ids fall inside each tiny vocab."""
    from PIL import Image

    directory, directory_zh = _tower_files(family, tmp_path)
    width = {"alt_clip": 24, "mul_zh": 128}.get(family, 64)
    monkeypatch.setitem(ADAPTER_PRESETS, "tiny", dataclasses.replace(TINY_ADAPTER, in_dim=width))
    d = orbax_io.export_adapter(PEAAdapter(ADAPTER_PRESETS["tiny"]), str(tmp_path), 1)
    out = tmp_path / "out.png"
    args = ["--model-dir", deployment["sdxl"], "--family", family, "--text-encoder-dir",
            directory, "--tokenizer-dir", deployment["text"], "--adapter",
            os.path.join(d, "pytorch_model.bin"), "--adapter-preset", "tiny", "--sampler",
            "ddim", "--steps", "2", "--size", "64", "--max-length", "8", "--device", "cpu",
            "--prompt", "一丁", "-o", str(out)]
    if family == "mul_zh":
        args += ["--text-encoder-dir-2", directory_zh]
    main(args)
    assert Image.open(out).size == (16, 16) and f"wrote {out}" in capsys.readouterr().out


def test_cli_mul_zh_needs_the_chinese_tower(deployment, capsys):
    with pytest.raises(SystemExit):
        main(["--model-dir", deployment["sdxl"], "--family", "mul_zh", "--text-encoder-dir",
              deployment["text"], "--adapter", "a.bin", "--device", "cpu"])
    assert "--text-encoder-dir-2" in capsys.readouterr().err


def test_smoke_deployment_configs_are_the_serving_stack_and_its_rows_cover_the_walk(tmp_path):
    """chip_smoke.py writes its few-step deployment with hand-written config
    files: they must read back as the serving stack's configs (SDXL UNet and
    VAE, the Chinese-CLIP RoBERTa-large tower, a trailing schedule), and
    each B1/B3 call of its two paths, at batch 1, must have a kernel row."""
    import chip_smoke
    from pea_diffusion_tpu_torch.configs import CHINESE_CLIP_LARGE, SDXL_UNET, SDXL_VAE
    from pea_diffusion_tpu_torch.models import UNet2DCondition

    assert UNetConfig.from_diffusers_config(chip_smoke.SDXL_UNET_CONFIG) == SDXL_UNET
    assert VAEConfig.from_diffusers_config(chip_smoke.SDXL_VAE_CONFIG) == SDXL_VAE
    assert load_pretrained.bert_text_config(chip_smoke.CHINESE_CLIP_TEXT_CONFIG) == \
        CHINESE_CLIP_LARGE
    dirs.write_json(str(tmp_path / "scheduler" / "scheduler_config.json"),
                    chip_smoke.TURBO_SCHEDULER_CONFIG)
    assert load_pretrained.load_schedule(str(tmp_path)) == NoiseScheduleConfig(
        timestep_spacing="trailing")
    with torch.device("meta"):
        unet = UNet2DCondition(SDXL_UNET)
    rows = chip_smoke.forward_cases()
    for path, spec in chip_smoke.FEWSTEP.items():
        routes = chip_smoke.attention_routes(unet, spec["size"] // 8, chip_smoke.TEXT_TOKENS)
        kernel_keys = {key for key in routes if key[0] != "plain"}
        assert kernel_keys and kernel_keys == {
            r[7][path] for r in rows if path in r[7]}, path
        for kern, b, _, _, h, *_ in (r for r in rows if path in r[7]):
            assert (b, h) in ((1, 10), (1, 20)) if kern == "B1" else h == 1 and b in (10, 20)
