"""PEA adapter configurations (the port's own copy of the JAX package's
``configs/adapter.py``; same fields, same presets).

Every reference adapter variant is one shape:

    h   = projector(LayerNorm(x))          # stack of Linear(+GELU between)
    seq = fc(GELU(h))                      # optional head -> cross-attn states
    pooled = mean(h (+x if residual), axis=seq)   # optional pooled embed
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AdapterConfig:
    """Configuration for :class:`pea_diffusion_tpu_torch.models.adapter.PEAAdapter`."""

    in_dim: int
    # Output dims of the projector Linears; GELU between layers, none after last.
    projector_dims: Tuple[int, ...]
    projector_bias: bool = False
    # If set, a biased Linear head maps GELU(projector_out) -> head_dim and the
    # module returns (pooled[B, projector_dims[-1]], seq[B, T, head_dim]).
    # If None, the module returns seq = projector_out only (SD1.5 style).
    head_dim: Optional[int] = None
    use_residual: bool = False
    layernorm_eps: float = 1e-5


ADAPTER_PRESETS = {
    # SDXL "MLP_plus" variants: (pooled 1280, seq 2048)
    "sdxl_mul_clip": AdapterConfig(1024, (2048, 2048, 1280), head_dim=2048),
    "sdxl_chinese_clip": AdapterConfig(1024, (1024, 1024, 1280), head_dim=2048),
    "sdxl_mt5": AdapterConfig(2048, (2048, 2048, 1280), head_dim=2048),
    "sdxl_alt_clip": AdapterConfig(768, (2048, 2048, 1280), head_dim=2048),
    "sdxl_concat": AdapterConfig(2048, (2048, 2048, 1280), head_dim=2048),
    "sdxl_wukong": AdapterConfig(768, (1024, 1024, 1280), head_dim=2048),
    "sdxl_plus": AdapterConfig(1024, (2048, 2048, 1280), head_dim=2048),
    # 2-layer variant with biased projector Linears
    "sdxl_small": AdapterConfig(
        1024, (1024, 1280), projector_bias=True, head_dim=2048
    ),
    # SD1.5: seq-only 768-d output
    "sd15_chinese_clip": AdapterConfig(1024, (2048, 2048, 768)),
    "sd15_deep": AdapterConfig(1024, (3072, 3072, 3072, 3072, 768)),
}
