"""Carries weights from the JAX package to the port.

Each converter takes a JAX parameter tree as nested dicts of numpy arrays
(``{"params": {...}}``, as the JAX package's ``init``/``init_params_host``
and checkpoint loaders give it) and returns the port module's state dict, in
the diffusers/transformers names the port's modules carry. The JAX package's
own ``convert_*`` (``checkpoints/torch_convert.py``) maps such a state dict
back to the JAX tree, which is how the tests check the names both ways.

Layout rules: Dense kernel [in, out] -> Linear weight [out, in]; Conv HWIO
-> OIHW; norm scale -> weight; Embed embedding -> weight; the UNet's GEGLU
halves geglu_h / geglu_gate fuse into ff.net.0.proj in [h | gate] order.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..configs.unet import ControlNetConfig, UNetConfig, VAEConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


class _Writer:
    def __init__(self):
        self.sd: StateDict = {}

    def lin(self, name: str, node: Mapping):
        self.sd[f"{name}.weight"] = _t(np.asarray(node["kernel"], np.float32).T)
        if "bias" in node:
            self.sd[f"{name}.bias"] = _t(node["bias"])

    def conv(self, name: str, node: Mapping):
        self.sd[f"{name}.weight"] = _t(
            np.asarray(node["kernel"], np.float32).transpose(3, 2, 0, 1))
        if "bias" in node:
            self.sd[f"{name}.bias"] = _t(node["bias"])

    def conv1x1_from_dense(self, name: str, node: Mapping):
        self.sd[f"{name}.weight"] = _t(
            np.asarray(node["kernel"], np.float32).T[:, :, None, None])
        self.sd[f"{name}.bias"] = _t(node["bias"])

    def norm(self, name: str, node: Mapping):
        self.sd[f"{name}.weight"] = _t(node["scale"])
        self.sd[f"{name}.bias"] = _t(node["bias"])

    def embed(self, name: str, node: Mapping):
        self.sd[f"{name}.weight"] = _t(node["embedding"])

    def resnet(self, name: str, node: Mapping):
        self.norm(f"{name}.norm1", node["norm1"])
        self.conv(f"{name}.conv1", node["conv1"])
        self.norm(f"{name}.norm2", node["norm2"])
        self.conv(f"{name}.conv2", node["conv2"])
        if "time_emb_proj" in node:
            self.lin(f"{name}.time_emb_proj", node["time_emb_proj"])
        if "conv_shortcut" in node:
            self.conv(f"{name}.conv_shortcut", node["conv_shortcut"])

    def attention(self, name: str, node: Mapping):
        for w in ("to_q", "to_k", "to_v"):
            self.lin(f"{name}.{w}", node[w])
        self.lin(f"{name}.to_out.0", node["to_out"])

    def transformer(self, name: str, node: Mapping, linear_proj: bool):
        self.norm(f"{name}.norm", node["norm"])
        proj = self.lin if linear_proj else self.conv1x1_from_dense
        proj(f"{name}.proj_in", node["proj_in"])
        proj(f"{name}.proj_out", node["proj_out"])
        k = 0
        while f"blocks_{k}" in node:
            self.transformer_block(f"{name}.transformer_blocks.{k}",
                                   node[f"blocks_{k}"])
            k += 1

    def transformer_block(self, name: str, node: Mapping):
        for ln in ("norm1", "norm2", "norm3"):
            self.norm(f"{name}.{ln}", node[ln])
        self.attention(f"{name}.attn1", node["attn1"])
        self.attention(f"{name}.attn2", node["attn2"])
        self.feed_forward(f"{name}.ff", node["ff"])

    def feed_forward(self, name: str, node: Mapping):
        h, g = node["geglu_h"], node["geglu_gate"]
        self.lin(f"{name}.net.0.proj", {
            "kernel": np.concatenate([np.asarray(h["kernel"], np.float32),
                                      np.asarray(g["kernel"], np.float32)], axis=1),
            "bias": np.concatenate([np.asarray(h["bias"], np.float32),
                                    np.asarray(g["bias"], np.float32)])})
        self.lin(f"{name}.net.2", node["proj_out"])


def adapter_state_dict(params: Mapping) -> StateDict:
    """PEAAdapter params -> the port's PEAAdapter state dict."""
    p, w = params["params"], _Writer()
    w.norm("layernorm", p["layernorm"])
    i = 0
    while f"projector_{i}" in p:
        w.lin(f"projector.{2 * i}", p[f"projector_{i}"])
        i += 1
    if "fc" in p:
        w.lin("fc", p["fc"])
    return w.sd


def bert_text_state_dict(params: Mapping) -> StateDict:
    """BertTextEncoder params -> the port's BertTextEncoder state dict."""
    p, w = params["params"], _Writer()
    w.embed("embeddings.word_embeddings", p["word_embeddings"])
    w.embed("embeddings.position_embeddings", p["position_embeddings"])
    w.embed("embeddings.token_type_embeddings", p["token_type_embeddings"])
    w.norm("embeddings.LayerNorm", p["embeddings_ln"])
    i = 0
    while f"layers_{i}" in p:
        pre, layer = f"encoder.layer.{i}", p[f"layers_{i}"]
        for n in ("query", "key", "value"):
            w.lin(f"{pre}.attention.self.{n}", layer["self_attn"][n])
        w.lin(f"{pre}.attention.output.dense", layer["attn_out"])
        w.norm(f"{pre}.attention.output.LayerNorm", layer["attn_ln"])
        w.lin(f"{pre}.intermediate.dense", layer["intermediate"])
        w.lin(f"{pre}.output.dense", layer["output"])
        w.norm(f"{pre}.output.LayerNorm", layer["out_ln"])
        i += 1
    if "pre_ln" in p:
        w.norm("pre_LN", p["pre_ln"])
        w.lin("transformation", p["transformation"])
    return w.sd


def clip_text_state_dict(params: Mapping) -> StateDict:
    """CLIPTextEncoder params -> the port's CLIPTextEncoder state dict."""
    p, w = params["params"], _Writer()
    w.embed("embeddings.token_embedding", p["token_embedding"])
    w.sd["embeddings.position_embedding.weight"] = _t(p["position_embedding"])
    w.norm("final_layer_norm", p["final_layer_norm"])
    i = 0
    while f"layers_{i}" in p:
        pre, layer = f"encoder.layers.{i}", p[f"layers_{i}"]
        w.norm(f"{pre}.layer_norm1", layer["ln1"])
        w.norm(f"{pre}.layer_norm2", layer["ln2"])
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            w.lin(f"{pre}.self_attn.{n}", layer["attn"][n])
        w.lin(f"{pre}.mlp.fc1", layer["fc1"])
        w.lin(f"{pre}.mlp.fc2", layer["fc2"])
        i += 1
    if "text_projection" in p:
        w.sd["text_projection.weight"] = _t(np.asarray(p["text_projection"], np.float32).T)
    return w.sd


def _time_embeddings(w: _Writer, p: Mapping):
    w.lin("time_embedding.linear_1", p["time_embedding"]["linear_1"])
    w.lin("time_embedding.linear_2", p["time_embedding"]["linear_2"])
    if "add_embedding" in p:
        w.lin("add_embedding.linear_1", p["add_embedding"]["linear_1"])
        w.lin("add_embedding.linear_2", p["add_embedding"]["linear_2"])


def _down_and_mid(w: _Writer, p: Mapping, config: UNetConfig):
    """The down and mid blocks, which a UNet and a ControlNet share."""
    lin_proj = config.use_linear_projection
    for i in range(config.num_blocks):
        for j in range(config.layers_per_block):
            w.resnet(f"down_blocks.{i}.resnets.{j}", p[f"down_{i}_resnet_{j}"])
            if f"down_{i}_attn_{j}" in p:
                w.transformer(f"down_blocks.{i}.attentions.{j}",
                              p[f"down_{i}_attn_{j}"], lin_proj)
        if i < config.num_blocks - 1:
            w.conv(f"down_blocks.{i}.downsamplers.0.conv",
                   p[f"down_{i}_downsample"]["conv"])
    w.resnet("mid_block.resnets.0", p["mid_resnet_0"])
    w.resnet("mid_block.resnets.1", p["mid_resnet_1"])
    if "mid_attn" in p:
        w.transformer("mid_block.attentions.0", p["mid_attn"], lin_proj)


def unet_state_dict(params: Mapping, config: UNetConfig) -> StateDict:
    """UNet2DCondition params -> the port's UNet2DCondition state dict."""
    p, w = params["params"], _Writer()
    lin_proj = config.use_linear_projection
    w.conv("conv_in", p["conv_in"])
    _time_embeddings(w, p)
    w.norm("conv_norm_out", p["conv_norm_out"])
    w.conv("conv_out", p["conv_out"])
    _down_and_mid(w, p, config)
    for i in range(config.num_blocks):
        for j in range(config.layers_per_block + 1):
            w.resnet(f"up_blocks.{i}.resnets.{j}", p[f"up_{i}_resnet_{j}"])
            if f"up_{i}_attn_{j}" in p:
                w.transformer(f"up_blocks.{i}.attentions.{j}",
                              p[f"up_{i}_attn_{j}"], lin_proj)
        if i < config.num_blocks - 1:
            w.conv(f"up_blocks.{i}.upsamplers.0.conv",
                   p[f"up_{i}_upsample"]["conv"])
    return w.sd


def controlnet_state_dict(params: Mapping, config: ControlNetConfig) -> StateDict:
    """ControlNet params -> the port's ControlNet state dict (diffusers
    ControlNetModel names: the inverse of the JAX package's
    ``convert_controlnet``). The zero convs keep the order both sides append
    them in: conv_in's output, each down-path skip, then the mid output."""
    p, w = params["params"], _Writer()
    w.conv("conv_in", p["conv_in"])
    _time_embeddings(w, p)
    emb = p["cond_embedder"]
    w.conv("controlnet_cond_embedding.conv_in", emb["conv_in"])
    i = 0
    while f"conv_{i}" in emb:
        w.conv(f"controlnet_cond_embedding.blocks.{i}", emb[f"conv_{i}"])
        i += 1
    w.conv("controlnet_cond_embedding.conv_out", emb["conv_out"])
    _down_and_mid(w, p, config.unet)
    k = 0
    while f"zero_conv_{k}" in p:
        w.conv(f"controlnet_down_blocks.{k}", p[f"zero_conv_{k}"])
        k += 1
    w.conv("controlnet_mid_block", p["zero_conv_mid"])
    return w.sd


def _vae_mid(w: _Writer, name: str, node: Mapping):
    w.resnet(f"{name}.resnets.0", node["resnet_0"])
    w.resnet(f"{name}.resnets.1", node["resnet_1"])
    w.norm(f"{name}.attentions.0.group_norm", node["attn_norm"])
    w.attention(f"{name}.attentions.0", node["attn"])


def vae_state_dict(params: Mapping, config: VAEConfig) -> StateDict:
    """AutoencoderKL params -> the port's AutoencoderKL state dict."""
    p, w = params["params"], _Writer()
    n = len(config.block_out_channels)
    enc, dec = p["encoder"], p["decoder"]
    w.conv("encoder.conv_in", enc["conv_in"])
    for i in range(n):
        for j in range(config.layers_per_block):
            w.resnet(f"encoder.down_blocks.{i}.resnets.{j}", enc[f"down_{i}_resnet_{j}"])
        if i < n - 1:
            w.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                   enc[f"down_{i}_downsample"]["conv"])
    _vae_mid(w, "encoder.mid_block", enc["mid"])
    w.norm("encoder.conv_norm_out", enc["conv_norm_out"])
    w.conv("encoder.conv_out", enc["conv_out"])
    w.conv("decoder.conv_in", dec["conv_in"])
    _vae_mid(w, "decoder.mid_block", dec["mid"])
    for i in range(n):
        for j in range(config.layers_per_block + 1):
            w.resnet(f"decoder.up_blocks.{i}.resnets.{j}", dec[f"up_{i}_resnet_{j}"])
        if i < n - 1:
            w.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                   dec[f"up_{i}_upsample"]["conv"])
    w.norm("decoder.conv_norm_out", dec["conv_norm_out"])
    w.conv("decoder.conv_out", dec["conv_out"])
    w.conv("quant_conv", p["quant_conv"])
    w.conv("post_quant_conv", p["post_quant_conv"])
    return w.sd
