"""Loads a PEA deployment from checkpoints on disk (port of
``pea_diffusion_tpu/checkpoints/load_pretrained.py``):

- a diffusers model directory (SDXL / SD1.5 / SSD-1B layout: unet/, vae/,
  scheduler/, each with its config and *.safetensors or *.bin weights);
- a student text tower of each family: a transformers Chinese-CLIP / BERT
  directory, open_clip's xlm-roberta-large-ViT-H-14 checkpoint (its text
  tower), an AltCLIP text model (HF or FlagAI layout), a transformers mT5
  directory, or the mul_zh pair of an XLM-R checkpoint and a Chinese-CLIP
  directory;
- a diffusers ControlNetModel directory;
- a CLIP vision tower (transformers Chinese-CLIP / CLIP directory) for
  evaluation;
- LoRA safetensors fused into the UNet or a CLIP tower at load time.

The port's modules carry the diffusers/transformers parameter names, so a
loader strips the wrapper prefixes the JAX converters strip, loads the state
dict into the module the factory builds (a missing key raises; extra keys
are ignored and counted), and casts. Each returns (config, module) on
`device` (the card unless the caller asks for the CPU); `dtype` None keeps
float32, as the JAX loaders keep float32 parameters without one.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from ..configs import text_encoder as text_configs
from ..configs.text_encoder import BertTextConfig, CLIPTextConfig, T5Config
from ..configs.unet import ControlNetConfig, UNetConfig, VAEConfig
from ..pipelines.factory import load_weights
from .lora import merge_lora_into_state_dict
from .safetensors_io import load_safetensors_torch


def _torch_load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def load_state_dict(directory: str) -> Dict[str, torch.Tensor]:
    """A (possibly sharded) state dict from a directory's *.safetensors
    files, or else its *.bin / *.pt files, or a single such file. The
    tensors keep their stored type and view memory maps of the files."""
    if os.path.isfile(directory):
        if directory.endswith(".safetensors"):
            return load_safetensors_torch(directory)
        return _torch_load(directory)
    files = sorted(os.listdir(directory))
    for suffixes, read in (((".safetensors",), load_safetensors_torch),
                           ((".bin", ".pt"), _torch_load)):
        shards = [f for f in files if f.endswith(suffixes)]
        if shards:
            out: Dict[str, torch.Tensor] = {}
            for f in shards:
                out.update(read(os.path.join(directory, f)))
            return out
    raise FileNotFoundError(f"no weights in {directory}")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _fuse_loras(sd, lora_paths, lora_scales, component, device):
    """Fuses each LoRA file's `component` pairs into `sd` (scales default to
    1.0); the float32 products run on `device`."""
    scales = list(lora_scales) + [1.0] * len(lora_paths)
    for path, scale in zip(lora_paths, scales):
        sd, _ = merge_lora_into_state_dict(sd, load_safetensors_torch(path), scale,
                                           component=component, device=device)
    return sd


def load_unet(model_dir: str, lora_paths=(), lora_scales=(), dtype=None, device="cuda"):
    """model_dir/unet -> (UNetConfig, UNet2DCondition), the LoRAs fused
    first (the load_lora_weights + fuse_lora path)."""
    from ..models.unet import UNet2DCondition

    d = os.path.join(model_dir, "unet")
    cfg = UNetConfig.from_diffusers_config(d)
    sd = _fuse_loras(load_state_dict(d), lora_paths, lora_scales, "unet", device)
    with torch.device("meta"):
        unet = UNet2DCondition(cfg)
    return cfg, load_weights(unet, sd, dtype or torch.float32, device, "unet")


def load_vae(model_dir: str, dtype=None, device="cuda"):
    """model_dir/vae -> (VAEConfig, AutoencoderKL)."""
    from ..models.vae import AutoencoderKL

    d = os.path.join(model_dir, "vae")
    cfg = VAEConfig.from_diffusers_config(d)
    with torch.device("meta"):
        vae = AutoencoderKL(cfg)
    return cfg, load_weights(vae, load_state_dict(d), dtype or torch.float32, device, "vae")


def load_schedule(model_dir: str):
    """model_dir/scheduler/scheduler_config.json -> NoiseScheduleConfig.

    Checkpoints carry their own schedule conventions (SDXL-Turbo ships
    trailing spacing; some fine-tunes ship v_prediction or zero-SNR betas);
    without a scheduler directory, the repo's default SDXL_SCHEDULE."""
    from ..schedulers import SDXL_SCHEDULE, NoiseScheduleConfig

    path = os.path.join(model_dir, "scheduler", "scheduler_config.json")
    if not os.path.exists(path):
        return SDXL_SCHEDULE
    c = _read_json(path)
    return NoiseScheduleConfig(
        num_train_timesteps=c.get("num_train_timesteps", 1000),
        beta_start=c.get("beta_start", 0.00085),
        beta_end=c.get("beta_end", 0.012),
        beta_schedule=c.get("beta_schedule", "scaled_linear"),
        prediction_type=c.get("prediction_type", "epsilon"),
        timestep_spacing=c.get("timestep_spacing", "leading"),
        steps_offset=c.get("steps_offset", 1),
        clip_sample=c.get("clip_sample", False),
        set_alpha_to_one=c.get("set_alpha_to_one", False),
        rescale_betas_zero_snr=c.get("rescale_betas_zero_snr", False),
    )


def load_controlnet(directory: str, dtype=None, device="cuda"):
    """A diffusers ControlNetModel directory -> (ControlNetConfig,
    ControlNet)."""
    from ..models.controlnet import ControlNet

    cfg = ControlNetConfig.from_diffusers_config(_read_json(os.path.join(directory,
                                                                          "config.json")))
    with torch.device("meta"):
        cn = ControlNet(cfg)
    return cfg, load_weights(cn, load_state_dict(directory), dtype or torch.float32, device,
                             "controlnet")


def _strip(sd, prefixes):
    """The keys under the first of `prefixes` that any key has, without it
    (the others dropped); `sd` itself if none has one."""
    for prefix in prefixes:
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def load_clip_text(directory: str, with_projection: bool = False, lora_paths=(),
                   lora_scales=(), component: str = "text_encoder", dtype=None,
                   device="cuda"):
    """A transformers CLIPText{Model,ModelWithProjection} directory ->
    (CLIPTextConfig, CLIPTextEncoder). `lora_paths` fuse the text-encoder
    halves of LoRA files first; pass component="text_encoder_2" for SDXL's
    bigG tower so that each file's pairs reach the right tower."""
    from ..models.clip_text import CLIPTextEncoder

    c = _read_json(os.path.join(directory, "config.json"))
    cfg = CLIPTextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        hidden_act=c.get("hidden_act", "quick_gelu"),
        eos_token_id=c.get("eos_token_id", 49407),
        projection_dim=c.get("projection_dim") if with_projection else None,
    )
    sd = _fuse_loras(load_state_dict(directory), lora_paths, lora_scales, component, device)
    proj = sd.get("text_projection.weight")
    sd = _strip(sd, ("text_model.",))
    if proj is not None:
        sd["text_projection.weight"] = proj
    with torch.device("meta"):
        enc = CLIPTextEncoder(cfg)
    return cfg, load_weights(enc, sd, dtype or torch.float32, device, "clip text")


def load_clip_vision(directory: str, dtype=None, device="cuda", sd=None):
    """A transformers ChineseCLIPModel / CLIPModel /
    CLIPVisionModelWithProjection directory -> (CLIPVisionConfig,
    CLIPVisionEncoder): the `vision_model.` prefix stripped,
    `visual_projection.weight` kept, `pre_layernorm` read as the module's
    `pre_layrnorm`. The config comes from `vision_config` (or the top level)
    with the keys and defaults of the JAX evaluate CLI, which reads neither
    `hidden_act` nor `layer_norm_eps` (so quick_gelu and eps 1e-5), and
    `projection_dim` from the top level (default 1024). `sd`: the
    directory's state dict, if the caller has read it already."""
    from ..models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder

    c = _read_json(os.path.join(directory, "config.json"))
    vc = c.get("vision_config", c)
    cfg = CLIPVisionConfig(
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 14),
        hidden_size=vc.get("hidden_size", 1280),
        num_layers=vc.get("num_hidden_layers", 32),
        num_heads=vc.get("num_attention_heads", 16),
        intermediate_size=vc.get("intermediate_size", 5120),
        projection_dim=c.get("projection_dim", 1024),
    )
    sd = load_state_dict(directory) if sd is None else sd
    proj = sd.get("visual_projection.weight")
    sd = _strip(sd, ("vision_model.",))
    if proj is not None:
        sd["visual_projection.weight"] = proj
    sd = {("pre_layrnorm" + k[len("pre_layernorm"):] if k.startswith("pre_layernorm.") else k): v
          for k, v in sd.items()}
    with torch.device("meta"):
        enc = CLIPVisionEncoder(cfg)
    return cfg, load_weights(enc, sd, dtype or torch.float32, device, "clip vision")


def bert_text_config(c: dict, roberta: Optional[bool] = None) -> BertTextConfig:
    """A transformers Bert / XLM-R config dict (or a ChineseCLIPConfig, whose
    `text_config` is read) -> BertTextConfig; RoBERTa positions when the
    model type says roberta, unless `roberta` is given."""
    c = c.get("text_config", c)
    if roberta is None:
        roberta = "roberta" in c.get("model_type", "")
    return BertTextConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        type_vocab_size=c.get("type_vocab_size", 2),
        pad_token_id=c.get("pad_token_id", 0),
        layer_norm_eps=c.get("layer_norm_eps", 1e-12),
        roberta_position_ids=bool(roberta),
    )


def load_bert_text(directory: str, roberta: Optional[bool] = None, dtype=None,
                   device="cuda", sd=None):
    """A transformers Bert / XLM-R / Chinese-CLIP text directory ->
    (BertTextConfig, BertTextEncoder), the `text_model.`, `bert.` or
    `roberta.` prefix stripped. `sd`: the directory's state dict, if the
    caller has read it already."""
    from ..models.bert_text import BertTextEncoder

    cfg = bert_text_config(_read_json(os.path.join(directory, "config.json")), roberta)
    sd = load_state_dict(directory) if sd is None else sd
    sd = _strip(sd, ("text_model.", "bert.", "roberta."))
    with torch.device("meta"):
        enc = BertTextEncoder(cfg)
    return cfg, load_weights(enc, sd, dtype or torch.float32, device, "bert text")


def load_open_clip_xlmr(checkpoint_path: str, dtype=None, device="cuda"):
    """open_clip's `open_clip_pytorch_model.bin` (xlm-roberta-large-ViT-H-14;
    the checkpoint file or its directory) -> (XLM_ROBERTA_LARGE,
    BertTextEncoder), the mul_clip student tower: the transformers
    XLM-RoBERTa model under `text.transformer.*`. The visual tower
    (`visual.*`), the pooled projection (`text.proj*`) and `logit_scale` are
    not on the student path (it takes the unprojected token states) and are
    dropped."""
    from ..models.bert_text import BertTextEncoder

    prefix = "text.transformer."
    sd = {k[len(prefix):]: v for k, v in load_state_dict(checkpoint_path).items()
          if k.startswith(prefix)}
    if not sd:
        raise ValueError("not an open_clip XLM-R checkpoint: no text.transformer.* keys")
    cfg = text_configs.XLM_ROBERTA_LARGE
    sd = _strip(sd, ("text_model.", "bert.", "roberta."))
    with torch.device("meta"):
        enc = BertTextEncoder(cfg)
    return cfg, load_weights(enc, sd, dtype or torch.float32, device, "xlm-r text")


def load_altclip_text(directory: str, dtype=None, device="cuda"):
    """An AltCLIP text model (HF BAAI/AltCLIP layout, `text_model.roberta.*`
    + `text_model.pre_LN` + `text_model.transformation`, or a FlagAI
    AltCLIP-XLMR-L dump under `model.`) -> (BertTextConfig,
    BertTextEncoder with the pre_LN + transformation head), the alt_clip
    student. The config is the directory's config.json (its `text_config`
    where it has one), else ALT_CLIP_XLMR_L."""
    from ..models.bert_text import BertTextEncoder

    cfg = text_configs.ALT_CLIP_XLMR_L
    cfg_path = os.path.join(directory, "config.json") if os.path.isdir(directory) else None
    if cfg_path and os.path.exists(cfg_path):
        c = _read_json(cfg_path)
        c = c.get("text_config", c)
        if "hidden_size" in c:
            cfg = BertTextConfig(
                vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
                num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
                intermediate_size=c["intermediate_size"],
                max_position_embeddings=c["max_position_embeddings"],
                type_vocab_size=c.get("type_vocab_size", 1),
                pad_token_id=c.get("pad_token_id", 1),
                layer_norm_eps=c.get("layer_norm_eps", 1e-5),
                roberta_position_ids=True,
                project_dim=c.get("project_dim", 768),
            )
    sd = load_state_dict(directory)
    for prefix in ("text_model.", "model."):
        if any(k.startswith((prefix + "roberta.", prefix + "pre_LN")) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break
    if not any(k.startswith("pre_LN") for k in sd):
        raise ValueError("not an AltCLIP text checkpoint: no pre_LN keys")
    head = {k: v for k, v in sd.items() if k.startswith(("pre_LN.", "transformation."))}
    sd = dict(_strip(sd, ("text_model.", "bert.", "roberta.")), **head)
    with torch.device("meta"):
        enc = BertTextEncoder(cfg)
    return cfg, load_weights(enc, sd, dtype or torch.float32, device, "altclip text")


def load_t5_encoder(directory: str, dtype=None, device="cuda"):
    """A transformers mT5 / T5 directory (T5EncoderModel or the whole
    encoder-decoder) -> (T5Config, T5Encoder). The config reads the sizes and
    the relative-attention buckets only, as the JAX loader does: the norm eps
    and the gated-GELU feed-forward keep T5Config's defaults. The tied
    `encoder.embed_tokens.weight` and every `decoder.*` / `lm_head.*` key are
    extra keys, ignored."""
    from ..models.mt5 import T5Encoder

    c = _read_json(os.path.join(directory, "config.json"))
    cfg = T5Config(
        vocab_size=c["vocab_size"], d_model=c["d_model"], d_kv=c["d_kv"],
        d_ff=c["d_ff"], num_layers=c["num_layers"], num_heads=c["num_heads"],
        relative_attention_num_buckets=c.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=c.get("relative_attention_max_distance", 128),
    )
    with torch.device("meta"):
        enc = T5Encoder(cfg)
    return cfg, load_weights(enc, load_state_dict(directory), dtype or torch.float32, device,
                             "t5 encoder")


def load_student_tower(family: str, directory: str, directory_zh: Optional[str] = None,
                       dtype=None, device="cuda"):
    """The student text tower of a family -> (config, module), shaped for
    ``pipelines.factory.make_text_encoder_fn(family, config, module)``:

    - chinese_clip: a transformers Chinese-CLIP / BERT directory;
    - mul_clip: open_clip's xlm-roberta-large checkpoint (or its directory);
    - alt_clip: an AltCLIP text directory (HF or FlagAI);
    - mt5: a transformers mT5 directory;
    - mul_zh: the mul_clip checkpoint and `directory_zh`, a Chinese-CLIP
      directory; returns ((mul_cfg, zh_cfg), ConcatTextEncoder).
    """
    if family == "mt5":
        return load_t5_encoder(directory, dtype, device)
    if family == "mul_clip":
        return load_open_clip_xlmr(directory, dtype, device)
    if family == "alt_clip":
        return load_altclip_text(directory, dtype, device)
    if family == "mul_zh":
        from ..models.bert_text import ConcatTextEncoder

        if directory_zh is None:
            raise ValueError("mul_zh needs a second (Chinese) encoder dir")
        mul_cfg, mul = load_open_clip_xlmr(directory, dtype, device)
        zh_cfg, zh = load_bert_text(directory_zh, dtype=dtype, device=device)
        with torch.device("meta"):
            enc = ConcatTextEncoder(mul_cfg, zh_cfg)
        enc.mul, enc.zh = mul, zh
        return (mul_cfg, zh_cfg), enc.eval()
    if family == "chinese_clip":
        return load_bert_text(directory, dtype=dtype, device=device)
    raise ValueError(f"unknown text-encoder family: {family}")
