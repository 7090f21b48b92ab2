"""Writes tiny checkpoint directories in the diffusers / transformers layouts
for the tests of the port's loaders: hand-written config.json files for the
tiny configs, weights through the JAX package's ``save_safetensors`` (or
``torch.save`` for a .bin), and a word-piece vocabulary for transformers'
BertTokenizer; the other student towers' files too (open_clip's XLM-R
checkpoint, AltCLIP text models in the HF and FlagAI layouts, an mT5
encoder-decoder directory)."""
import json
import os

import numpy as np
import torch

from pea_diffusion_tpu.checkpoints.safetensors_io import save_safetensors

# diffusers config.json of the tiny configs (SDXL_UNET_TINY, SD15_UNET_TINY,
# VAE_TINY, the demo's ControlNet) and a ChineseCLIPConfig around BERT_TINY
SDXL_UNET_JSON = {
    "_class_name": "UNet2DConditionModel", "in_channels": 4, "out_channels": 4,
    "block_out_channels": [32, 64, 128], "layers_per_block": 2,
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
    "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
    "transformer_layers_per_block": [1, 1, 2], "attention_head_dim": [2, 4, 8],
    "cross_attention_dim": 64, "norm_num_groups": 8, "addition_embed_type": "text_time",
    "addition_time_embed_dim": 32, "projection_class_embeddings_input_dim": 256,
    "use_linear_projection": True, "sample_size": 8,
}
SD15_UNET_JSON = {
    "_class_name": "UNet2DConditionModel", "in_channels": 4, "out_channels": 4,
    "block_out_channels": [32, 64, 64, 64], "layers_per_block": 2,
    "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
    "attention_head_dim": 2, "cross_attention_dim": 64, "norm_num_groups": 8,
}
VAE_JSON = {"_class_name": "AutoencoderKL", "block_out_channels": [16, 32],
            "layers_per_block": 2, "latent_channels": 4, "norm_num_groups": 8,
            "scaling_factor": 0.13025, "force_upcast": False}
CONTROLNET_JSON = dict(
    {k: v for k, v in SDXL_UNET_JSON.items() if k not in ("out_channels", "up_block_types")},
    _class_name="ControlNetModel", conditioning_embedding_out_channels=[8, 8, 16, 16])
BERT_JSON = {"model_type": "bert", "vocab_size": 1000, "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4, "intermediate_size": 128,
             "max_position_embeddings": 512, "type_vocab_size": 2, "pad_token_id": 0,
             "layer_norm_eps": 1e-12}
CHINESE_CLIP_JSON = {"model_type": "chinese_clip", "text_config": BERT_JSON,
                     "vision_config": {"hidden_size": 32}, "projection_dim": 16}
# The other student towers around the tiny sizes: XLM-R settings (pad id 1,
# one token type, 514 positions), AltCLIP's text_config (+ the 24-d head)
# and an mT5 config as transformers writes it (T5_TINY's sizes; its eps,
# feed-forward and tying fields are ones the loaders do not read).
XLMR_SETTINGS = dict(type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5,
                     max_position_embeddings=514, roberta_position_ids=True)
ALTCLIP_JSON = {"model_type": "altclip", "projection_dim": 16,
                "text_config": dict(BERT_JSON, model_type="altclip_text_model",
                                    max_position_embeddings=514, type_vocab_size=1,
                                    pad_token_id=1, layer_norm_eps=1e-5, project_dim=24),
                "vision_config": {"hidden_size": 32}}
MT5_JSON = {"model_type": "mt5", "architectures": ["MT5ForConditionalGeneration"],
            "vocab_size": 1000, "d_model": 64, "d_kv": 16, "d_ff": 128, "num_layers": 2,
            "num_decoder_layers": 2, "num_heads": 4, "relative_attention_num_buckets": 32,
            "relative_attention_max_distance": 128, "layer_norm_epsilon": 1e-6,
            "feed_forward_proj": "gated-gelu", "tie_word_embeddings": False,
            "pad_token_id": 0}
TURBO_SCHEDULER_JSON = {"_class_name": "EulerAncestralDiscreteScheduler",
                        "beta_start": 0.00085, "beta_end": 0.012,
                        "beta_schedule": "scaled_linear", "num_train_timesteps": 1000,
                        "prediction_type": "v_prediction", "timestep_spacing": "trailing",
                        "steps_offset": 1}


def numpy_sd(sd):
    return {k: np.ascontiguousarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in sd.items()}


def write_json(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def write_component(directory, config, sd, shards=1, fmt="safetensors",
                    name="diffusion_pytorch_model"):
    """config.json plus the weights, in `shards` safetensors files or one
    torch .bin."""
    write_json(os.path.join(directory, "config.json"), config)
    sd = numpy_sd(sd)
    if fmt == "bin":
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   os.path.join(directory, f"{name}.bin"))
        return
    keys = list(sd)
    for i, part in enumerate(np.array_split(np.arange(len(keys)), shards)):
        suffix = f"-{i + 1:05d}-of-{shards:05d}" if shards > 1 else ""
        save_safetensors(os.path.join(directory, f"{name}{suffix}.safetensors"),
                         {keys[j]: sd[keys[j]] for j in part})


def write_text_dir(directory, text_sd, vocab_size=1000):
    """A Chinese-CLIP checkpoint around the tiny BERT: the text tower under
    `text_model.`, plus a vision weight and a projection the loader ignores,
    and a BertTokenizer vocabulary of `vocab_size` entries (the special
    tokens, then CJK characters)."""
    sd = {f"text_model.{k}": v for k, v in numpy_sd(text_sd).items()}
    sd["vision_model.embeddings.class_embedding"] = np.zeros(32, np.float32)
    sd["text_projection.weight"] = np.zeros((16, 64), np.float32)
    write_component(directory, CHINESE_CLIP_JSON, sd, name="model")
    special = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = [chr(0x4E00 + i) for i in range(vocab_size - len(special))]
    with open(os.path.join(directory, "vocab.txt"), "w") as f:
        f.write("\n".join(special + chars) + "\n")
    write_json(os.path.join(directory, "tokenizer_config.json"),
               {"tokenizer_class": "BertTokenizer", "do_lower_case": True})
    return str(directory)


def write_model_dir(root, unet_json, unet_sd, vae_sd, scheduler=None, unet_shards=2,
                    vae_fmt="bin"):
    """A diffusers model directory: unet/ (sharded safetensors), vae/ (a
    .bin by default) and, when given, scheduler/scheduler_config.json."""
    write_component(os.path.join(root, "unet"), unet_json, unet_sd, shards=unet_shards)
    write_component(os.path.join(root, "vae"), VAE_JSON, vae_sd, fmt=vae_fmt)
    if scheduler is not None:
        write_json(os.path.join(root, "scheduler", "scheduler_config.json"), scheduler)
    return str(root)


def peft_lora(unet_sd, rank=2, seed=0, ends=(".to_q", ".to_v", ".to_out.0")):
    """A peft-form LoRA (unet.<path>.lora_A/lora_B.weight) over the UNet's
    linears whose path ends in one of `ends`, B nonzero."""
    rng = np.random.default_rng(seed)
    lora = {}
    for k, w in unet_sd.items():
        path = k[:-len(".weight")]
        if not (k.endswith(".weight") and path.endswith(ends)):
            continue
        out_f, in_f = tuple(w.shape)
        lora[f"unet.{path}.lora_A.weight"] = (
            rng.standard_normal((rank, in_f)) / np.sqrt(in_f)).astype(np.float32)
        lora[f"unet.{path}.lora_B.weight"] = (
            0.1 * rng.standard_normal((out_f, rank))).astype(np.float32)
    return lora


def write_open_clip_xlmr(path, text_sd):
    """open_clip's xlm-roberta-large-ViT-H-14 checkpoint as one torch .bin:
    the HF XLM-RoBERTa model under `text.transformer.`, its pooler, the
    pooled projection, a visual weight and logit_scale."""
    sd = {f"text.transformer.{k}": v for k, v in numpy_sd(text_sd).items()}
    sd["text.transformer.pooler.dense.weight"] = np.zeros((64, 64), np.float32)
    sd["text.proj.0.weight"] = np.zeros((32, 64), np.float32)
    sd["visual.conv1.weight"] = np.zeros((8, 3, 2, 2), np.float32)
    sd["logit_scale"] = np.zeros((), np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def write_altclip(directory, text_sd, layout="hf"):
    """An AltCLIP text model: "hf" is transformers' AltCLIPModel layout
    (`text_model.roberta.*`, `text_model.pre_LN`, `text_model.transformation`,
    a vision weight, config.json with its text_config); "flagai" a FlagAI
    AltCLIP-XLMR-L dump under `model.` with no config.json."""
    head = ("pre_LN.", "transformation.")
    prefix = "text_model." if layout == "hf" else "model."
    sd = {prefix + (k if k.startswith(head) else f"roberta.{k}"): v
          for k, v in numpy_sd(text_sd).items()}
    if layout == "hf":
        sd["vision_model.embeddings.class_embedding"] = np.zeros(32, np.float32)
        write_component(directory, ALTCLIP_JSON, sd, name="model")
    else:
        os.makedirs(directory, exist_ok=True)
        save_safetensors(os.path.join(directory, "model.safetensors"), sd)
    return str(directory)


def write_mt5(directory, t5_sd):
    """A transformers MT5ForConditionalGeneration directory: the encoder's
    weights, the tied copy `encoder.embed_tokens.weight`, a decoder weight
    and lm_head (the extra keys an encoder loader ignores)."""
    sd = numpy_sd(t5_sd)
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    sd["decoder.block.0.layer.0.SelfAttention.q.weight"] = np.zeros((64, 64), np.float32)
    sd["lm_head.weight"] = np.zeros((1000, 64), np.float32)
    write_component(directory, MT5_JSON, sd, name="model")
    return str(directory)
