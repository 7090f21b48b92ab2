"""UNet / VAE configurations (the port's own copy of the JAX package's
``configs/unet.py`` for the models this port runs).

A down block with ``transformer_layers[i] == 0`` is a plain resnet block,
otherwise a cross-attention block — diffusers' ``down_block_types`` without
string matching.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

LayerSpec = Union[int, Tuple[int, ...]]  # per-block: int or per-layer tuple


def _normalize_layers(spec: LayerSpec, n_layers: int) -> Tuple[int, ...]:
    """Expand a per-block transformer-layer spec to one int per resnet layer."""
    if isinstance(spec, int):
        return (spec,) * n_layers
    if len(spec) != n_layers:
        raise ValueError(f"layer spec {spec} does not have {n_layers} entries")
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # Transformer depth per down block (int, or per-resnet-layer tuple).
    # 0 => plain DownBlock (no attention).
    transformer_layers: Tuple[LayerSpec, ...] = (1, 1, 1, 0)
    # Up-path override (deepest block first). None => reversed(transformer_layers),
    # each entry expanded to layers_per_block + 1 resnet layers.
    reverse_transformer_layers: Optional[Tuple[LayerSpec, ...]] = None
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    mid_transformer_layers: int = 1  # 0 => mid block without attention
    norm_num_groups: int = 32
    addition_embed_type: Optional[str] = None  # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: Optional[int] = None
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    # Transformer2D in/out projections stored as 1x1 convs (False) or
    # linears (True); the math is the same.
    use_linear_projection: bool = False

    @property
    def num_blocks(self) -> int:
        return len(self.block_out_channels)

    def down_block_layers(self, i: int) -> Tuple[int, ...]:
        return _normalize_layers(self.transformer_layers[i], self.layers_per_block)

    def up_block_layers(self, i: int) -> Tuple[int, ...]:
        """Transformer depths for up block i (i=0 is the deepest block)."""
        n = self.layers_per_block + 1
        if self.reverse_transformer_layers is not None:
            return _normalize_layers(self.reverse_transformer_layers[i], n)
        spec = tuple(reversed(self.transformer_layers))[i]
        if isinstance(spec, int):
            return (spec,) * n
        # mirror per-layer tuples and extend to n entries
        rev = tuple(reversed(spec))
        return rev + (rev[-1],) * (n - len(rev))


SD15_UNET = UNetConfig()  # the defaults are SD1.5

SDXL_UNET = UNetConfig(
    block_out_channels=(320, 640, 1280),
    transformer_layers=(0, 2, 10),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    mid_transformer_layers=10,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2816,  # 1280 pooled + 6*256 time ids
    use_linear_projection=True,
)

# Tiny configs for tests (same topology, small dims).
SD15_UNET_TINY = UNetConfig(
    block_out_channels=(32, 64, 64, 64),
    num_attention_heads=(2, 2, 2, 2),
    cross_attention_dim=64,
    norm_num_groups=8,
)
SDXL_UNET_TINY = UNetConfig(
    block_out_channels=(32, 64, 128),
    transformer_layers=(0, 1, 2),
    num_attention_heads=(2, 4, 8),
    cross_attention_dim=64,
    mid_transformer_layers=2,
    norm_num_groups=8,
    addition_embed_type="text_time",
    addition_time_embed_dim=32,
    projection_class_embeddings_input_dim=32 * 6 + 64,  # time ids + pooled(64)
    use_linear_projection=True,
)


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet: the UNet's down and mid blocks with zero-initialised
    output convs and a conditioning-image embedder; each embedder stage
    after the first halves the image (three stages: image -> latent)."""

    unet: UNetConfig = SDXL_UNET
    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # SDXL: 0.13025
    force_upcast: bool = True


SD15_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
VAE_TINY = VAEConfig(block_out_channels=(16, 32), norm_num_groups=8)
