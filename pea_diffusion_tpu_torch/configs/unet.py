"""UNet / VAE configurations (the port's own copy of the JAX package's
``configs/unet.py`` for the models this port runs).

A down block with ``transformer_layers[i] == 0`` is a plain resnet block,
otherwise a cross-attention block — diffusers' ``down_block_types`` without
string matching. ``from_diffusers_config`` reads a diffusers ``config.json``,
so a checkpoint directory defines its own architecture at load time.
"""
from __future__ import annotations

import dataclasses
import json
import os
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

    @staticmethod
    def from_diffusers_config(cfg: Union[dict, str]) -> "UNetConfig":
        """A diffusers UNet2DConditionModel (or ControlNetModel) config, as a
        dict or the directory holding its config.json."""
        cfg = _read_config(cfg)
        blocks = tuple(cfg["block_out_channels"])
        n = len(blocks)
        down_types = cfg.get("down_block_types") or ["CrossAttnDownBlock2D"] * n
        tl = cfg.get("transformer_layers_per_block", 1)
        if isinstance(tl, int):
            tl = [tl] * n
        layers = []
        for i, t in enumerate(down_types):
            if "CrossAttn" in t:
                spec = tl[i]
                layers.append(tuple(spec) if isinstance(spec, list) else spec)
            else:
                layers.append(0)
        rev = cfg.get("reverse_transformer_layers_per_block")
        if rev is not None:
            rev = tuple(tuple(r) if isinstance(r, list) else r for r in rev)
        # diffusers' `attention_head_dim` is historically the head *count*
        # of SD-era UNets (8 for SD1.5, [5, 10, 20] for SDXL)
        heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
        if isinstance(heads, int):
            heads = [heads] * n
        mid_type = str(cfg.get("mid_block_type", "UNetMidBlock2DCrossAttn"))
        mid = tl[-1] if "CrossAttn" in mid_type else 0
        if isinstance(mid, (list, tuple)):
            mid = mid[0]
        return UNetConfig(
            in_channels=cfg["in_channels"],
            out_channels=cfg["out_channels"],
            block_out_channels=blocks,
            layers_per_block=cfg.get("layers_per_block", 2),
            transformer_layers=tuple(layers),
            reverse_transformer_layers=rev,
            num_attention_heads=tuple(heads),
            cross_attention_dim=cfg.get("cross_attention_dim", 768),
            mid_transformer_layers=mid,
            norm_num_groups=cfg.get("norm_num_groups", 32),
            addition_embed_type=cfg.get("addition_embed_type"),
            addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256),
            projection_class_embeddings_input_dim=cfg.get(
                "projection_class_embeddings_input_dim"),
            flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
            freq_shift=cfg.get("freq_shift", 0),
            use_linear_projection=cfg.get("use_linear_projection", False),
        )


def _read_config(cfg: Union[dict, str]) -> dict:
    if isinstance(cfg, str):
        with open(os.path.join(cfg, "config.json")) as f:
            return json.load(f)
    return cfg


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

SDXL_INPAINT_UNET = dataclasses.replace(SDXL_UNET, in_channels=9)

# SD 2.1 (768-v): SD1.5's topology, 1024-d OpenCLIP-H conditioning, linear
# projections, heads of 64 (5 at level 0).
SD21_UNET = UNetConfig(
    num_attention_heads=(5, 10, 20, 20),
    cross_attention_dim=1024,
    use_linear_projection=True,
)

# The SDXL refiner's shape: four levels, 1280-d (bigG-only) conditioning,
# aesthetic-score time ids (5 * 256 + 1280 pooled = 2560). A checkpoint's
# own config.json defines its exact architecture (from_diffusers_config).
SDXL_REFINER_UNET = UNetConfig(
    block_out_channels=(384, 768, 1536, 1536),
    transformer_layers=(0, 4, 4, 0),
    num_attention_heads=(6, 12, 24, 24),
    cross_attention_dim=1280,
    mid_transformer_layers=4,
    addition_embed_type="text_time",
    projection_class_embeddings_input_dim=2560,
    use_linear_projection=True,
)

# SSD-1B, the pruned SDXL: the 1280-wide transformer stacks cut from 10 to 4
# layers, the 640-wide ones kept at 2; diffusers takes the mid depth from
# transformer_layers_per_block[-1], so 4 (1.32 B parameters).
SSD_1B_UNET = dataclasses.replace(
    SDXL_UNET,
    transformer_layers=(0, 2, 4),
    mid_transformer_layers=4,
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

    @staticmethod
    def from_diffusers_config(cfg: Union[dict, str]) -> "ControlNetConfig":
        """A diffusers ControlNetModel config, as a dict or the directory
        holding its config.json (it has no output head: out_channels is
        in_channels)."""
        cfg = dict(_read_config(cfg))
        cfg.setdefault("out_channels", cfg.get("in_channels", 4))
        return ControlNetConfig(
            unet=UNetConfig.from_diffusers_config(cfg),
            conditioning_channels=cfg.get("conditioning_channels", 3),
            conditioning_embedding_channels=tuple(
                cfg.get("conditioning_embedding_out_channels", (16, 32, 96, 256))))


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

    @staticmethod
    def from_diffusers_config(cfg: Union[dict, str]) -> "VAEConfig":
        """A diffusers AutoencoderKL config, as a dict or its directory."""
        cfg = _read_config(cfg)
        return VAEConfig(
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            block_out_channels=tuple(cfg["block_out_channels"]),
            layers_per_block=cfg.get("layers_per_block", 2),
            latent_channels=cfg.get("latent_channels", 4),
            norm_num_groups=cfg.get("norm_num_groups", 32),
            scaling_factor=cfg.get("scaling_factor", 0.18215),
            force_upcast=cfg.get("force_upcast", True),
        )


SD15_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
VAE_TINY = VAEConfig(block_out_channels=(16, 32), norm_num_groups=8)
