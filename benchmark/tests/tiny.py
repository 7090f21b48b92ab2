"""Tiny configurations and traffic mixes of the benchmark's shapes, for the
CPU tests (the same topology as the cells' models, small widths)."""
from __future__ import annotations

import copy

BERT = {"vocab_size": 1000, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 4, "intermediate_size": 128, "max_position_embeddings": 512,
        "type_vocab_size": 2, "pad_token_id": 0, "hidden_act": "gelu",
        "layer_norm_eps": 1e-12}
VAE = {"block_out_channels": [16, 32], "in_channels": 3, "out_channels": 3,
       "latent_channels": 4, "layers_per_block": 2, "norm_num_groups": 8}
SCHEDULER = {"num_train_timesteps": 1000, "beta_start": 0.00085, "beta_end": 0.012,
             "beta_schedule": "scaled_linear", "prediction_type": "epsilon",
             "timestep_spacing": "leading", "steps_offset": 1}


def _clip(hidden, inter, act, proj=None):
    return {"vocab_size": 500, "hidden_size": hidden, "num_hidden_layers": 2,
            "num_attention_heads": 2, "intermediate_size": inter,
            "max_position_embeddings": 16, "hidden_act": act, "eos_token_id": 499,
            "projection_dim": proj, "layer_norm_eps": 1e-5}


def _comp(cfg, dtype="float32", **kw):
    return dict(config=cfg, weights_dtype=dtype, **kw)


def sdxl(dtype="float32"):
    unet = {"block_out_channels": [32, 64, 128], "in_channels": 4, "out_channels": 4,
            "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
            "transformer_layers_per_block": [1, 1, 2], "attention_head_dim": [2, 4, 8],
            "cross_attention_dim": 64, "layers_per_block": 2, "norm_num_groups": 8,
            "addition_embed_type": "text_time", "addition_time_embed_dim": 32,
            "projection_class_embeddings_input_dim": 32 * 6 + 64, "flip_sin_to_cos": True,
            "freq_shift": 0, "use_linear_projection": True}
    return {"name": "tiny-sdxl", "scheduler": SCHEDULER, "components": {
        "unet": _comp(unet, dtype),
        "vae": _comp(dict(VAE, scaling_factor=0.13025)),
        "text_encoder": _comp(BERT, dtype),
        "adapter": _comp({"in_dim": 64, "projector_dims": [96, 64], "head_dim": 64},
                         serve_compute_dtype=dtype, train_compute_dtype="float32"),
        "teacher_1": _comp(_clip(24, 48, "quick_gelu"), dtype),
        "teacher_2": _comp(_clip(40, 64, "gelu", proj=64), dtype),
    }}


def sd15(dtype="float32"):
    unet = {"block_out_channels": [32, 64, 64, 64], "in_channels": 4, "out_channels": 4,
            "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
            "attention_head_dim": 2, "cross_attention_dim": 64, "layers_per_block": 2,
            "norm_num_groups": 8, "flip_sin_to_cos": True, "freq_shift": 0}
    return {"name": "tiny-sd15", "scheduler": SCHEDULER, "components": {
        "unet": _comp(unet, dtype),
        "vae": _comp(dict(VAE, scaling_factor=0.18215)),
        "text_encoder": _comp(BERT, dtype),
        "adapter": _comp({"in_dim": 64, "projector_dims": [96, 96, 64], "head_dim": None},
                         serve_compute_dtype=dtype, train_compute_dtype="float32"),
        "teacher_1": _comp(_clip(64, 64, "quick_gelu"), dtype),
    }}


SERVE = {"driver": "serve", "clients": 2, "max_batch": 2, "window_ms": 150,
         "size": 64, "steps": 4, "sampler": "dpm++", "guidance": [5.0, 8.5],
         "prompt_chars": [3, 8], "max_length": 8, "negative_prompt": "",
         "check": {"requests": 2}}

TRAIN = {"driver": "train", "batch": 4, "size": 64, "text_tokens": 12, "teacher_tokens": 16,
         "checked_steps": 3, "pool": 2, "reference_chunk": 2, "trace_steps": 1,
         "train": {"learning_rate": 1e-3, "min_learning_rate": 5e-8, "total_steps": 1000,
                   "weight_decay": 0.1, "adam_beta1": 0.9, "adam_beta2": 0.999,
                   "adam_epsilon": 1e-8, "noise_offset": 0.5, "cfg_dropout": 0.1,
                   "feature_loss_weight": 0.1, "kd": True, "hybrid_training": True,
                   "remat_policy": "full", "log_every_n_steps": 100, "every_n_steps": 5000}}


def sdxl_f8(dtype="float32"):
    """The tiny SDXL stack with a VAE of four levels (8x down), for images
    at the aspect buckets' real sizes."""
    cfg = sdxl(dtype)
    cfg["components"]["vae"]["config"]["block_out_channels"] = [8, 8, 16, 16]
    return cfg


def train_shards(**kw):
    """The shards mix at tiny sizes: 2 shards of 12 samples, batches of 2."""
    import json
    from pathlib import Path

    mix = json.loads((Path(__file__).resolve().parents[1] / "traffic" /
                      "kd-b10-shards.json").read_text())
    mix.update(batch=2, text_tokens=12, teacher_tokens=16, decode_workers=2,
               reference_chunk=2, trace_steps=1, train=copy.deepcopy(TRAIN["train"]))
    mix["shards"].update(count=2, samples=12, area=[420000, 480000])
    return dict(mix, **kw)


def serve(**kw):
    return dict(copy.deepcopy(SERVE), **kw)


def train(**kw):
    return dict(copy.deepcopy(TRAIN), **kw)
