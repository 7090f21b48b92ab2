"""Plain fp32 PyTorch reference of the PEA stacks: the SD1.5 / SDXL UNet, the
KL VAE, the BERT-family student tower (Chinese-CLIP RoBERTa), the CLIP
teacher towers and the PEA adapter.

Independent of the program under test: it imports only torch. Parameter
names are diffusers' / transformers' (the names the port's modules carry),
so one state dict, made by ``benchmark/weights.py`` from the run's seed,
fills both. Images and latents are NHWC at the public methods.

Departures from diffusers, shared with the program (the JAX package's
forms, which the port reproduces): every stride-2 convolution pads 1 on
each side (diffusers' VAE encoder pads (0, 1, 0, 1)); the CLIP teachers
pool the state at the first eos id (the argmax of ``ids == eos``).
Attention is written out as softmax(Q K^T / sqrt(d)) V; norms are
``F.group_norm`` / ``F.layer_norm``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.GroupNorm):
    """GroupNorm with an optional trailing SiLU."""

    def __init__(self, channels: int, groups: int, eps: float, silu: bool = False):
        super().__init__(groups, channels, eps)
        self.silu = silu

    def forward(self, x):
        y = super().forward(x)
        return F.silu(y) if self.silu else y


class LayerNorm(nn.LayerNorm):
    pass


NORMS = (GroupNorm, LayerNorm)


def conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2)


def attention(q, k, v, heads: int):
    """[B, Sq, H*D] x [B, Skv, H*D] -> [B, Sq, H*D]."""
    b, sq, inner = q.shape
    d = inner // heads
    q = q.reshape(b, sq, heads, d).transpose(1, 2)
    k = k.reshape(b, -1, heads, d).transpose(1, 2)
    v = v.reshape(b, -1, heads, d).transpose(1, 2)
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d), dim=-1)
    return (p @ v).transpose(1, 2).reshape(b, sq, inner)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       shift: float = 0.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / (half - shift))
    emb = t.float()[:, None] * freqs[None]
    parts = [torch.cos(emb), torch.sin(emb)]
    return torch.cat(parts if flip_sin_to_cos else parts[::-1], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, cout)
        self.linear_2 = nn.Linear(cout, cout)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Resnet(nn.Module):
    def __init__(self, cin: int, cout: int, temb: Optional[int], groups: int):
        super().__init__()
        self.norm1 = GroupNorm(cin, groups, 1e-5, silu=True)
        self.conv1 = conv(cin, cout, 3)
        self.time_emb_proj = None if temb is None else nn.Linear(temb, cout)
        self.norm2 = GroupNorm(cout, groups, 1e-5, silu=True)
        self.conv2 = conv(cout, cout, 3)
        self.conv_shortcut = None if cin == cout else conv(cin, cout, 1)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Sampler(nn.Module):
    """A stride-2 conv (down) or nearest x2 then a conv (up)."""

    def __init__(self, ch: int, up: bool):
        super().__init__()
        self.up = up
        self.conv = conv(ch, ch, 3, stride=1 if up else 2)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest") if self.up else x)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: Optional[int] = None,
                 bias: bool = False):
        super().__init__()
        inner, cdim = dim, dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=bias)
        self.to_k = nn.Linear(cdim, inner, bias=bias)
        self.to_v = nn.Linear(cdim, inner, bias=bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, context=None):
        c = x if context is None else context
        return self.to_out[0](attention(self.to_q(x), self.to_k(c), self.to_v(c), self.heads))


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, 4 * dim), nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, context_dim)
        self.norm3 = LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, heads: int, depth: int, context_dim: int, groups: int,
                 linear: bool):
        super().__init__()
        self.norm = GroupNorm(ch, groups, 1e-6)
        self.linear = linear
        self.proj_in = nn.Linear(ch, ch) if linear else nn.Conv2d(ch, ch, 1)
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, heads, context_dim) for _ in range(depth)])
        self.proj_out = nn.Linear(ch, ch) if linear else nn.Conv2d(ch, ch, 1)

    def _project(self, layer, x):
        return layer(x) if self.linear else F.linear(x, layer.weight.flatten(1), layer.bias)

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = self._project(self.proj_in, t)
        for block in self.transformer_blocks:
            t = block(t, context)
        t = self._project(self.proj_out, t)
        return t.reshape(b, h, w, c).permute(0, 3, 1, 2) + x


class Block(nn.Module):
    def __init__(self, resnets, attentions=(), down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])

    def attn(self, j):
        return self.attentions[j] if hasattr(self, "attentions") else None


class UNetSpec:
    """The shape of a diffusers UNet2DConditionModel config.json."""

    def __init__(self, cfg: Dict):
        self.blocks = list(cfg["block_out_channels"])
        n = len(self.blocks)
        tl = cfg.get("transformer_layers_per_block", 1)
        tl = [tl] * n if isinstance(tl, int) else list(tl)
        down_types = cfg["down_block_types"]
        self.depth = [tl[i] if "CrossAttn" in t else 0 for i, t in enumerate(down_types)]
        mid_type = str(cfg.get("mid_block_type", "UNetMidBlock2DCrossAttn"))
        self.mid_depth = tl[-1] if "CrossAttn" in mid_type else 0
        heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
        self.heads = [heads] * n if isinstance(heads, int) else list(heads)
        self.lpb = cfg.get("layers_per_block", 2)
        self.groups = cfg.get("norm_num_groups", 32)
        self.context_dim = cfg["cross_attention_dim"]
        self.linear = cfg.get("use_linear_projection", False)
        self.added = cfg.get("addition_embed_type")
        self.added_time_dim = cfg.get("addition_time_embed_dim", 256)
        self.added_in = cfg.get("projection_class_embeddings_input_dim")
        self.in_channels, self.out_channels = cfg["in_channels"], cfg["out_channels"]
        self.flip = cfg.get("flip_sin_to_cos", True)
        self.shift = cfg.get("freq_shift", 0)


class UNet(nn.Module):
    """UNet2DConditionModel: sample [B, H, W, C] NHWC, timesteps [B],
    context [B, T, D], added {"text_embeds", "time_ids"} for SDXL ->
    [B, H, W, C]; with `features`, also the per-block outputs (NHWC)
    d0..dN, m, u0..uN that the KD feature loss taps."""

    def __init__(self, cfg: Dict):
        super().__init__()
        s = self.spec = UNetSpec(cfg)
        c0, g, n = s.blocks[0], s.groups, len(s.blocks)
        temb = 4 * c0
        self.conv_in = conv(s.in_channels, c0, 3)
        self.time_embedding = TimestepEmbedding(c0, temb)
        if s.added == "text_time":
            self.add_embedding = TimestepEmbedding(s.added_in, temb)

        def tr(ch, level, depth):
            return Transformer2D(ch, s.heads[level], depth, s.context_dim, g, s.linear)

        skips, ch = [c0], c0
        self.down_blocks = nn.ModuleList()
        for i, out in enumerate(s.blocks):
            res, att = [], []
            for _ in range(s.lpb):
                res.append(Resnet(ch, out, temb, g))
                ch = out
                skips.append(ch)
                if s.depth[i]:
                    att.append(tr(out, i, s.depth[i]))
            down = None
            if i < n - 1:
                down = Sampler(out, up=False)
                skips.append(ch)
            self.down_blocks.append(Block(res, att, down=down))
        self.mid_block = Block([Resnet(ch, ch, temb, g), Resnet(ch, ch, temb, g)],
                               [tr(ch, n - 1, s.mid_depth)] if s.mid_depth else ())
        self.up_blocks = nn.ModuleList()
        for i, out in enumerate(reversed(s.blocks)):
            level = n - 1 - i
            res, att = [], []
            for _ in range(s.lpb + 1):
                res.append(Resnet(ch + skips.pop(), out, temb, g))
                ch = out
                if s.depth[level]:
                    att.append(tr(out, level, s.depth[level]))
            up = Sampler(out, up=True) if i < n - 1 else None
            self.up_blocks.append(Block(res, att, up=up))
        self.conv_norm_out = GroupNorm(ch, g, 1e-5, silu=True)
        self.conv_out = conv(ch, s.out_channels, 3)

    def forward(self, sample, timesteps, context, added=None, features: bool = False):
        s = self.spec
        dt = self.conv_in.weight.dtype
        temb = self.time_embedding(
            timestep_embedding(timesteps, s.blocks[0], s.flip, s.shift).to(dt))
        if s.added == "text_time":
            ids = added["time_ids"]
            t_emb = timestep_embedding(ids.reshape(-1), s.added_time_dim, s.flip,
                                       s.shift).reshape(ids.shape[0], -1)
            temb = temb + self.add_embedding(
                torch.cat([added["text_embeds"].to(dt), t_emb.to(dt)], -1))
        context = context.to(dt)
        feats = {}
        h = self.conv_in(sample.to(dt).permute(0, 3, 1, 2))
        stack = [h]
        for i, block in enumerate(self.down_blocks):
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                if block.attn(j) is not None:
                    h = block.attn(j)(h, context)
                stack.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                stack.append(h)
            feats[f"d{i}"] = h
        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        if mid.attn(0) is not None:
            h = mid.attn(0)(h, context)
        h = mid.resnets[1](h, temb)
        feats["m"] = h
        for i, block in enumerate(self.up_blocks):
            for j, res in enumerate(block.resnets):
                h = res(torch.cat([h, stack.pop()], dim=1), temb)
                if block.attn(j) is not None:
                    h = block.attn(j)(h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
            feats[f"u{i}"] = h
        out = self.conv_out(self.conv_norm_out(h)).permute(0, 2, 3, 1)
        if features:
            return out, {k: v.permute(0, 2, 3, 1) for k, v in feats.items()}
        return out


class VAEAttention(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = GroupNorm(ch, groups, 1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, h):
        b, c, hh, ww = h.shape
        x = self.group_norm(h).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        x = self.to_out[0](attention(self.to_q(x), self.to_k(x), self.to_v(x), 1))
        return h + x.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def _vae_mid(ch, g):
    return Block([Resnet(ch, ch, None, g), Resnet(ch, ch, None, g)], [VAEAttention(ch, g)])


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        chans, g, lpb = cfg["block_out_channels"], cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = conv(cfg["in_channels"], chans[0], 3)
        self.down_blocks = nn.ModuleList()
        ch = chans[0]
        for i, out in enumerate(chans):
            res = []
            for _ in range(lpb):
                res.append(Resnet(ch, out, None, g))
                ch = out
            down = Sampler(ch, up=False) if i < len(chans) - 1 else None
            self.down_blocks.append(Block(res, down=down))
        self.mid_block = _vae_mid(ch, g)
        self.conv_norm_out = GroupNorm(ch, g, 1e-6, silu=True)
        self.conv_out = conv(ch, 2 * cfg["latent_channels"], 3)

    def forward(self, x):
        h = self.conv_in(x)
        for block in self.down_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        return self.conv_out(self.conv_norm_out(_run_mid(self.mid_block, h)))


class Decoder(nn.Module):
    def __init__(self, cfg: Dict):
        super().__init__()
        rev = list(reversed(cfg["block_out_channels"]))
        g, lpb = cfg["norm_num_groups"], cfg["layers_per_block"]
        self.conv_in = conv(cfg["latent_channels"], rev[0], 3)
        self.mid_block = _vae_mid(rev[0], g)
        self.up_blocks = nn.ModuleList()
        ch = rev[0]
        for i, out in enumerate(rev):
            res = []
            for _ in range(lpb + 1):
                res.append(Resnet(ch, out, None, g))
                ch = out
            up = Sampler(ch, up=True) if i < len(rev) - 1 else None
            self.up_blocks.append(Block(res, up=up))
        self.conv_norm_out = GroupNorm(ch, g, 1e-6, silu=True)
        self.conv_out = conv(ch, cfg["out_channels"], 3)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for block in self.up_blocks:
            for res in block.resnets:
                h = res(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class VAE(nn.Module):
    """AutoencoderKL. encode: image [B, H, W, 3] in [-1, 1] and eps -> a
    latent sample (unscaled); decode: unscaled latents -> image in [-1, 1]."""

    def __init__(self, cfg: Dict):
        super().__init__()
        lat = cfg["latent_channels"]
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * lat, 2 * lat, 1)
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)

    def encode(self, x, eps):
        moments = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * eps

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, inner: int, eps: float):
        super().__init__()
        self.heads = heads
        self.attention = nn.Module()
        self.attention.self = nn.Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.self, name, nn.Linear(hidden, hidden))
        self.attention.output = nn.Module()
        self.attention.output.dense = nn.Linear(hidden, hidden)
        self.attention.output.LayerNorm = LayerNorm(hidden, eps=eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(hidden, inner)
        self.output = nn.Module()
        self.output.dense = nn.Linear(inner, hidden)
        self.output.LayerNorm = LayerNorm(hidden, eps=eps)

    def forward(self, x, bias):
        a, d = self.attention.self, x.shape[-1] // self.heads
        b, t, _ = x.shape

        def split(y):
            return y.reshape(b, t, self.heads, d).transpose(1, 2)

        q, k, v = split(a.query(x)), split(a.key(x)), split(a.value(x))
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d) + bias, dim=-1)
        o = (p @ v).transpose(1, 2).reshape(b, t, -1)
        x = self.attention.output.LayerNorm(x + self.attention.output.dense(o))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class BertTower(nn.Module):
    """A BERT / RoBERTa-wwm text tower (transformers' BertModel names):
    ids [B, T] -> last hidden state [B, T, H]; positions 0..T-1, token
    type 0, pad ids masked out of the keys."""

    def __init__(self, cfg: Dict):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.pad = cfg["pad_token_id"]
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.embeddings.position_embeddings = nn.Embedding(cfg["max_position_embeddings"], h)
        self.embeddings.token_type_embeddings = nn.Embedding(cfg["type_vocab_size"], h)
        self.embeddings.LayerNorm = LayerNorm(h, eps=eps)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList([
            BertLayer(h, cfg["num_attention_heads"], cfg["intermediate_size"], eps)
            for _ in range(cfg["num_hidden_layers"])])

    def forward(self, ids):
        e = self.embeddings
        pos = torch.arange(ids.shape[1], device=ids.device)[None]
        x = e.word_embeddings(ids) + e.position_embeddings(pos) \
            + e.token_type_embeddings(torch.zeros_like(ids))
        x = e.LayerNorm(x)
        bias = torch.where(ids[:, None, None, :] != self.pad, 0.0,
                           torch.finfo(x.dtype).min).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


class CLIPLayer(nn.Module):
    def __init__(self, h: int, heads: int, inner: int, act: str, eps: float):
        super().__init__()
        self.heads, self.act = heads, act
        self.layer_norm1 = LayerNorm(h, eps=eps)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(h, h))
        self.layer_norm2 = LayerNorm(h, eps=eps)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(h, inner)
        self.mlp.fc2 = nn.Linear(inner, h)

    def forward(self, x, mask):
        a = self.self_attn
        b, t, h = x.shape
        d = h // self.heads
        y = self.layer_norm1(x)

        def split(z):
            return z.reshape(b, t, self.heads, d).transpose(1, 2)

        q, k, v = split(a.q_proj(y)), split(a.k_proj(y)), split(a.v_proj(y))
        s = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(~mask, torch.finfo(s.dtype).min), dim=-1)
        x = x + a.out_proj((p @ v).transpose(1, 2).reshape(b, t, h))
        m = self.mlp.fc1(self.layer_norm2(x))
        m = m * torch.sigmoid(1.702 * m) if self.act == "quick_gelu" else F.gelu(m)
        return x + self.mlp.fc2(m)


class CLIPTower(nn.Module):
    """A CLIP text tower (transformers' CLIPTextModel names without
    ``text_model.``, plus ``text_projection``): ids [B, 77] -> (last
    hidden state after the final LayerNorm, penultimate hidden state,
    projected pooled state or None)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        h, eps = cfg["hidden_size"], cfg["layer_norm_eps"]
        self.eos = cfg["eos_token_id"]
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg["vocab_size"], h)
        self.embeddings.position_embedding = nn.Embedding(cfg["max_position_embeddings"], h)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            CLIPLayer(h, cfg["num_attention_heads"], cfg["intermediate_size"],
                      cfg["hidden_act"], eps) for _ in range(cfg["num_hidden_layers"])])
        self.final_layer_norm = LayerNorm(h, eps=eps)
        proj = cfg.get("projection_dim")
        self.text_projection = None if proj is None else nn.Linear(h, proj, bias=False)

    def forward(self, ids):
        b, t = ids.shape
        x = self.embeddings.token_embedding(ids) + self.embeddings.position_embedding.weight[:t]
        mask = torch.tril(torch.ones(t, t, dtype=torch.bool, device=ids.device))
        pen = x
        for i, layer in enumerate(self.encoder.layers):
            if i == len(self.encoder.layers) - 1:
                pen = x
            x = layer(x, mask)
        last = self.final_layer_norm(x)
        proj = None
        if self.text_projection is not None:
            eos = (ids == self.eos).int().argmax(dim=-1)
            proj = self.text_projection(last[torch.arange(b, device=ids.device), eos])
        return last, pen, proj


class Adapter(nn.Module):
    """The PEA adapter: LayerNorm, Linear layers with GELU between; with a
    head (SDXL) returns (mean over tokens of the projector output, fc(GELU(
    projector output))), else the projector output."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.layernorm = LayerNorm(cfg["in_dim"], eps=cfg.get("layernorm_eps", 1e-5))
        layers, prev = [], cfg["in_dim"]
        for i, d in enumerate(cfg["projector_dims"]):
            if i:
                layers.append(nn.GELU())
            layers.append(nn.Linear(prev, d, bias=cfg.get("projector_bias", False)))
            prev = d
        self.projector = nn.Sequential(*layers)
        head = cfg.get("head_dim")
        self.fc = None if head is None else nn.Linear(prev, head)

    def forward(self, x):
        h = self.projector(self.layernorm(x))
        if self.fc is None:
            return h
        return h.mean(dim=1), self.fc(F.gelu(h))


COMPONENTS = {"unet": UNet, "vae": VAE, "text_encoder": BertTower, "adapter": Adapter,
              "teacher_1": CLIPTower, "teacher_2": CLIPTower}


def build(component: str, cfg: Dict, device="meta") -> nn.Module:
    """The reference module of a configuration component, on `device`
    (meta: shapes only, for the weights' layout and the FLOP count)."""
    with torch.device(device):
        return COMPONENTS[component](cfg)


def parameter_layout(module: nn.Module) -> List[tuple]:
    """(name, shape, fill) of every parameter in order: fill "one" for a
    norm's weight, "zero" for any bias, "normal" otherwise."""
    out = []
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if pname == "bias":
                fill = "zero"
            elif isinstance(mod, NORMS):
                fill = "one"
            else:
                fill = "normal"
            out.append((name, tuple(p.shape), fill))
    return out
