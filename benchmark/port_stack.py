"""The program's stacks at a configuration's widths, through its own module
classes and its own weight loading (``pipelines/factory.py::load_weights``,
as a checkpoint loads), filled with the run's weights (``weights.py``)."""
from __future__ import annotations

from typing import Dict

import torch

from . import weights


def _port_configs(config: Dict):
    from pea_diffusion_tpu_torch.configs.adapter import AdapterConfig
    from pea_diffusion_tpu_torch.configs.text_encoder import BertTextConfig, CLIPTextConfig
    from pea_diffusion_tpu_torch.configs.unet import UNetConfig, VAEConfig
    from pea_diffusion_tpu_torch.schedulers import NoiseScheduleConfig

    comp = config["components"]

    def clip(c):
        return CLIPTextConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_position_embeddings=c["max_position_embeddings"], hidden_act=c["hidden_act"],
            eos_token_id=c["eos_token_id"], projection_dim=c.get("projection_dim"),
            layer_norm_eps=c["layer_norm_eps"])

    t = comp["text_encoder"]["config"]
    a = comp["adapter"]["config"]
    s = config["scheduler"]
    out = {
        "unet": UNetConfig.from_diffusers_config(comp["unet"]["config"]),
        "vae": VAEConfig.from_diffusers_config(comp["vae"]["config"]),
        "text_encoder": BertTextConfig(
            vocab_size=t["vocab_size"], hidden_size=t["hidden_size"],
            num_layers=t["num_hidden_layers"], num_heads=t["num_attention_heads"],
            intermediate_size=t["intermediate_size"],
            max_position_embeddings=t["max_position_embeddings"],
            type_vocab_size=t["type_vocab_size"], pad_token_id=t["pad_token_id"],
            hidden_act=t["hidden_act"], layer_norm_eps=t["layer_norm_eps"]),
        "adapter": AdapterConfig(a["in_dim"], tuple(a["projector_dims"]),
                                 projector_bias=a.get("projector_bias", False),
                                 head_dim=a.get("head_dim"),
                                 layernorm_eps=a.get("layernorm_eps", 1e-5)),
        "schedule": NoiseScheduleConfig(
            num_train_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
            beta_end=s["beta_end"], beta_schedule=s["beta_schedule"],
            prediction_type=s["prediction_type"], timestep_spacing=s["timestep_spacing"],
            steps_offset=s["steps_offset"]),
    }
    for name in ("teacher_1", "teacher_2"):
        if name in comp:
            out[name] = clip(comp[name]["config"])
    return out


def _load(module, config, component, seed, device):
    from pea_diffusion_tpu_torch.pipelines.factory import load_weights

    dtype = weights.served_dtype(config, component)
    state = weights.component_state(seed, component, config["components"][component]["config"],
                                    dtype, device)
    return load_weights(module, state, dtype, device, component)


def _student(config, cfgs, seed, device, compute_dtype):
    from pea_diffusion_tpu_torch.models.adapter import PEAAdapter
    from pea_diffusion_tpu_torch.models.unet import UNet2DCondition
    from pea_diffusion_tpu_torch.models.vae import AutoencoderKL
    from pea_diffusion_tpu_torch.pipelines.factory import make_text_encoder_fn

    with torch.device("meta"):
        text, _ = make_text_encoder_fn("chinese_clip", cfgs["text_encoder"])
        adapter = PEAAdapter(cfgs["adapter"], dtype=compute_dtype)
        unet = UNet2DCondition(cfgs["unet"])
        vae = AutoencoderKL(cfgs["vae"])
    text = _load(text, config, "text_encoder", seed, device)
    _, text_fn = make_text_encoder_fn("chinese_clip", cfgs["text_encoder"], text)
    return dict(text_encoder=text, text_encoder_fn=text_fn,
                adapter=_load(adapter, config, "adapter", seed, device),
                unet=_load(unet, config, "unet", seed, device),
                vae=_load(vae, config, "vae", seed, device))


def serving_models(config: Dict, seed: int, device):
    """The program's PEAModels for serving: the adapter computes in the
    configuration's serving type over its fp32 weights."""
    from pea_diffusion_tpu_torch.pipelines.text2image import PEAModels

    cfgs = _port_configs(config)
    compute = weights.DTYPES[config["components"]["adapter"]["serve_compute_dtype"]]
    parts = _student(config, cfgs, seed, device, compute)
    return PEAModels(schedule=cfgs["schedule"], vae_scaling=cfgs["vae"].scaling_factor,
                     device=torch.device(device), **parts)


def kd_models(config: Dict, seed: int, device, vae_encode_chunk: int = 2):
    """The program's KDModels: the student stack, the frozen CLIP teachers,
    the adapter computing in fp32 and the only trainable part."""
    from pea_diffusion_tpu_torch.models.clip_text import CLIPTextEncoder
    from pea_diffusion_tpu_torch.train.kd import KDModels

    cfgs = _port_configs(config)
    compute = weights.DTYPES[config["components"]["adapter"]["train_compute_dtype"]]
    parts = _student(config, cfgs, seed, device, compute)
    teachers = []
    for name in ("teacher_1", "teacher_2"):
        if name in cfgs:
            with torch.device("meta"):
                t = CLIPTextEncoder(cfgs[name])
            teachers.append(_load(t, config, name, seed, device))
    teachers += [None, None]
    parts["adapter"] = parts["adapter"].train()
    return KDModels(teacher_clip1=teachers[0], teacher_clip2=teachers[1],
                    schedule=cfgs["schedule"], vae_scaling=cfgs["vae"].scaling_factor,
                    vae_encode_chunk=vae_encode_chunk, **parts).freeze()
