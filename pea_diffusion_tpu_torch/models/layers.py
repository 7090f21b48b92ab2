"""Shared building blocks of the UNet and VAE (port of
``pea_diffusion_tpu/models/layers.py``).

Modules carry the diffusers parameter names, so a diffusers state dict loads
as it is and the JAX package's ``convert_*`` maps the port's state dict to
its own tree. Feature maps are NCHW inside the blocks; the UNet and VAE take
and return NHWC at their public methods, as the JAX package does. Norms
compute in fp32 and return the input's type; matrix products and
convolutions run in the parameters' type.

Numerics follow diffusers' SD-era blocks as the JAX package does (resnet GN
eps 1e-5, transformer GN eps 1e-6, GEGLU feed-forward, exact-erf GELU).

Tensor parallelism (parallel/tp.py): ``shard_bundle_for_tp`` cuts the
weights of ``MultiHeadAttention``, ``FeedForward`` and ``ResnetBlock2D`` to
a rank's shard and sets their ``tp_group``; each then ends in one
``all_reduce`` of its partial result. A module with no group runs as it
always did.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import onepass_attention
from ..parallel.tp import reduce_partial
from ..ops.attention import dot_product_attention, use_flash, xla_attention_bshd
from ..ops.groupnorm import fused_gn_applicable, fused_group_norm, group_norm, group_norm_act
from ..quant.int8 import make_conv, parse_scopes
from ..utils.trace import span


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embeddings, diffusers get_timestep_embedding parity."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    if flip_sin_to_cos:
        return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """linear_1 -> silu -> linear_2 (diffusers TimestepEmbedding)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, out_dim)
        self.linear_2 = nn.Linear(out_dim, out_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class GroupNorm(nn.Module):
    """GroupNorm with an optional preceding per-(sample, channel) bias
    (`extra_bias`, the resnet time embedding) and trailing SiLU. Where
    ``fused_gn_applicable`` holds (on a CUDA tensor, when no input needs a
    gradient, or always with PEA_FUSED_GROUPNORM=1; never with =0) the
    whole chain is one fused kernel, B6 or B6-b; otherwise the plain fp32
    ``group_norm_act``. Either way the call is one ``groupnorm`` span
    (utils/trace.py) whose argument is the route, "kernel" or "plain"."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5, act: str = "none"):
        super().__init__()
        self.num_groups, self.eps, self.act = num_groups, eps, act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, extra_bias: Optional[torch.Tensor] = None):
        inputs = (self.weight, self.bias) + (() if extra_bias is None else (extra_bias,))
        kernel = fused_gn_applicable(x, self.num_groups, *inputs)
        with span("groupnorm", "kernel" if kernel else "plain"):
            return (fused_group_norm if kernel else group_norm_act)(
                x, self.weight, self.bias, self.num_groups, self.eps, self.act, extra_bias)


class ResnetBlock2D(nn.Module):
    """GN-silu-conv x2 with timestep bias and 1x1 shortcut (diffusers
    ResnetBlock2D, output_scale_factor=1). `temb_channels=None` (the VAE)
    has no time projection. `conv_quant` ("int8:<scopes>", quant/int8.py)
    makes the two 3x3s int8 under the "resnet" scope and the shortcut under
    "shortcut"; the norms and the time projection stay float."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None,
                 norm_num_groups: int = 32, eps: float = 1e-5, conv_quant: str = "none"):
        super().__init__()
        scopes = parse_scopes(conv_quant)
        self.norm1 = GroupNorm(in_channels, norm_num_groups, eps, act="silu")
        self.conv1 = make_conv(in_channels, out_channels, 3, quantized="resnet" in scopes)
        self.time_emb_proj = (None if temb_channels is None
                              else nn.Linear(temb_channels, out_channels))
        self.norm2 = GroupNorm(out_channels, norm_num_groups, eps, act="silu")
        self.conv2 = make_conv(out_channels, out_channels, 3, quantized="resnet" in scopes)
        self.conv_shortcut = (None if in_channels == out_channels
                              else make_conv(in_channels, out_channels, 1,
                                             quantized="shortcut" in scopes))
        # tensor parallelism: the group, and this rank's input channels of
        # the shortcut (parallel/tp.py)
        self.tp_group = None
        self.tp_in = None

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        h = self.conv1(self.norm1(x))
        t = None
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
        h = self.norm2(h, extra_bias=t)
        if self.tp_group is not None:
            return self._tp_out(x, h)
        h = self.conv2(h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _tp_out(self, x, h):
        """conv2 over this rank's channels `h` plus the shortcut over its
        slice of `x`: one partial sum, one all_reduce, the biases after."""
        y = conv_partial(self.conv2, h)
        bias = self.conv2.bias.float()
        if self.conv_shortcut is not None:
            lo, hi = self.tp_in
            y = y + conv_partial(self.conv_shortcut, x[:, lo:hi])
            bias = bias + self.conv_shortcut.bias.float()
        y = reduce_partial(y, self.tp_group) + bias[:, None, None]
        if self.conv_shortcut is None:
            y = y + x.float()
        return y.to(h.dtype)


def conv_partial(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A convolution's product without its bias, in fp32 (an input-sharded
    conv's partial sum): an ``nn.Conv2d``'s (rounded to `x`'s type by the
    convolution first: no conv gives fp32 out of bf16 in, and an fp32
    conv moved a TP = 2 SDXL forward's error no closer to fp32), or an int8
    ``QConvInt8``'s dequantized int32 sums."""
    if isinstance(conv, nn.Conv2d):
        return F.conv2d(x, conv.weight, None, conv.stride, conv.padding).float()
    return conv.dequantized(x).permute(0, 3, 1, 2)


def row_parallel_linear(layer: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-sharded Linear: the partial product over this rank's input
    features, one all_reduce, the bias after, in `x`'s type. On a card a
    bf16 / fp16 partial leaves the tensor cores in fp32 (``torch.mm``'s
    out_dtype), so that only the sum is rounded, as the unsharded product's
    output is."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        part = torch.mm(x.reshape(-1, x.shape[-1]), layer.weight.t(), out_dtype=torch.float32)
        part = part.view(*x.shape[:-1], -1)
    else:
        part = F.linear(x, layer.weight)
    y = reduce_partial(part, group) + layer.bias.float()
    return y.to(x.dtype)


class Downsample2D(nn.Module):
    """3x3 stride-2 conv with symmetric padding 1 (the JAX package's form),
    int8 under the "sampler" scope."""

    def __init__(self, channels: int, out_channels: int, conv_quant: str = "none"):
        super().__init__()
        self.conv = make_conv(channels, out_channels, 3, stride=2,
                              quantized="sampler" in parse_scopes(conv_quant))

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """Nearest x2 then a 3x3 conv, int8 under the "sampler" scope."""

    def __init__(self, channels: int, out_channels: int, conv_quant: str = "none"):
        super().__init__()
        self.conv = make_conv(channels, out_channels, 3,
                              quantized="sampler" in parse_scopes(conv_quant))

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def attention_route(sq: int, skv: int, heads: int, head_dim: int,
                    backend: str, device_type: str) -> str:
    """Which attention a MultiHeadAttention call takes, the dispatch of the
    JAX package's layers.py:272-298 with "on a TPU" read as "on a CUDA
    tensor": "onepass" (B1) where the one-pass gate holds, else "flash" (B3)
    for long queries, else "plain"."""
    if use_flash(sq, backend, device_type):
        if onepass_attention.supports(sq, skv, heads, head_dim):
            return "onepass"
        return "flash"
    return "plain"


class MultiHeadAttention(nn.Module):
    """to_q/k/v (bias-free in the UNet, biased in the VAE) and a biased
    to_out, over the attention dispatch (diffusers Attention names). Both
    kernel routes are differentiable: "onepass" through ``bshd_attention``,
    "flash" through ``dot_product_attention``'s ``flash_attention``."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 context_dim: Optional[int] = None, qkv_bias: bool = False,
                 backend: str = "auto"):
        super().__init__()
        inner = num_heads * head_dim
        context_dim = query_dim if context_dim is None else context_dim
        self.num_heads, self.head_dim, self.backend = num_heads, head_dim, backend
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(context_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(context_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])
        self.tp_group = None  # set with the heads cut to a rank's (parallel/tp.py)

    def forward(self, x, context: Optional[torch.Tensor] = None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        b, sq, inner = q.shape
        skv = k.shape[1]
        h, d = self.num_heads, self.head_dim
        scale = 1.0 / math.sqrt(d)
        route = attention_route(sq, skv, h, d, self.backend, q.device.type)
        if route == "onepass":
            out = onepass_attention.bshd_attention(q, k, v, h, d, scale)
        elif route == "flash":
            def split(t, s):  # head-major layout for the flash kernel
                return t.reshape(b, s, h, d).transpose(1, 2).reshape(b * h, s, d).contiguous()

            out = dot_product_attention(split(q, sq), split(k, skv),
                                        split(v, skv), scale=scale,
                                        backend=self.backend)
            out = out.reshape(b, h, sq, d).transpose(1, 2).reshape(b, sq, inner)
        else:
            out = xla_attention_bshd(q.reshape(b, sq, h, d),
                                     k.reshape(b, skv, h, d),
                                     v.reshape(b, skv, h, d),
                                     scale).reshape(b, sq, inner)
        if self.tp_group is not None:
            return row_parallel_linear(self.to_out[0], out, self.tp_group)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """One fused [dim -> 2*inner] projection chunked into [h | gate]. Under
    tensor parallelism a rank holds its rows of each half, [h_r | gate_r],
    so the same chunk gives its own h and gate."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward (diffusers names ff.net.0.proj / ff.net.2)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])
        self.tp_group = None  # net.2 row-sharded (parallel/tp.py)

    def forward(self, x):
        if self.tp_group is not None:
            return row_parallel_linear(self.net[2], self.net[0](x), self.tp_group)
        for layer in self.net:
            x = layer(x)
        return x


class LayerNormFP32(nn.Module):
    """LayerNorm with fp32 one-pass statistics, output in the input's type."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        dt = x.dtype
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        x = (x - mean) * torch.rsqrt(var + self.eps) * self.weight.float() + self.bias.float()
        return x.to(dt)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn, LN -> cross-attn, LN -> GEGLU-FF, pre-norm residuals."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 context_dim: int, backend: str = "auto"):
        super().__init__()
        self.norm1 = LayerNormFP32(dim)
        self.attn1 = MultiHeadAttention(dim, num_heads, head_dim, backend=backend)
        self.norm2 = LayerNormFP32(dim)
        self.attn2 = MultiHeadAttention(dim, num_heads, head_dim, context_dim,
                                        backend=backend)
        self.norm3 = LayerNormFP32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


def _project(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A Transformer2D in/out projection over [B, HW, C] tokens: a Linear, or
    a 1x1 conv (its weight [C, C, 1, 1] applied as a Linear)."""
    if isinstance(layer, nn.Conv2d):
        return F.linear(x, layer.weight.flatten(1), layer.bias)
    return layer(x)


class Transformer2D(nn.Module):
    """GN -> proj_in -> N transformer blocks over HW tokens -> proj_out + res."""

    def __init__(self, channels: int, num_heads: int, head_dim: int,
                 depth: int, context_dim: int, norm_num_groups: int = 32,
                 use_linear_projection: bool = False, backend: str = "auto"):
        super().__init__()
        self.norm = GroupNorm(channels, norm_num_groups, 1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if use_linear_projection \
            else (lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(channels, num_heads, head_dim, context_dim,
                                  backend)
            for _ in range(depth)])
        self.proj_out = proj()

    def forward(self, x, context, segment=None):
        """`segment` (the KD step's "blocks" remat, see models/unet.py's
        ``checkpoint_segment``) runs each transformer block as its own
        recompute segment; None runs them plainly."""
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = _project(self.proj_in, x)
        for block in self.transformer_blocks:
            x = block(x, context) if segment is None else segment(block, x, context)
        x = _project(self.proj_out, x)
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2) + residual
