"""LoRA fusion into a torch state dict (the port's own copy of the JAX
package's ``checkpoints/lora.py``: the ``load_lora_weights`` + ``fuse_lora``
path).

Fusion always happens at load time: W' = W + scale * (alpha / rank) * up @
down, computed in float32 from the stored weight and cast back to the
stored dtype once. A bfloat16 weight thus gets bf16(W + delta), the bits the
JAX package gets by upcasting the whole state dict to float32, merging, and
casting to bfloat16 last.

Key formats:
- peft/diffusers:   unet.<path>.lora_A.weight / lora_B.weight
- legacy diffusers: <path>.lora.down.weight / lora.up.weight
                    (also `.lora_linear_layer.down/up`, text encoders)
- kohya:            lora_unet_<path with _>.lora_down.weight / lora_up.weight,
                    lora_te{,1,2}_... for the text towers, optional `.alpha`
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, Mapping, Tuple

import torch

# path segments that diffusers joins with "." where kohya keys use "_"
_SEGMENTS = (
    "down_blocks", "up_blocks", "mid_block", "transformer_blocks", "attentions",
    "resnets", "attn1", "attn2", "to_q", "to_k", "to_v", "to_out", "proj_in",
    "proj_out", "ff", "net", "time_emb_proj", "conv1", "conv2", "conv_shortcut",
    # CLIP text-encoder segments (lora_te*_text_model_...)
    "text_model", "encoder", "layers", "self_attn", "q_proj", "k_proj", "v_proj",
    "out_proj", "mlp", "fc1", "fc2",
)


def _kohya_to_diffusers(key: str) -> str:
    """lora_unet_down_blocks_1_attentions_0_... -> down_blocks.1....;
    lora_te2_* is the bigG tower (text_encoder_2), lora_te_ / lora_te1_ the
    CLIP-L tower (kohya's SDXL naming). Other keys pass through."""
    m = re.match(r"^lora_(unet|te\d?)_(.*)$", key)
    if not m:
        return key
    prefixes = {"unet": "", "te": "text_encoder.", "te1": "text_encoder.",
                "te2": "text_encoder_2."}
    prefix = prefixes.get(m.group(1))
    if prefix is None:  # an unknown tower (lora_te3_): left unmapped
        warnings.warn(f"unrecognized LoRA tower prefix in key {key!r}; "
                      "passing through unmapped")
        return key
    rest = m.group(2)
    for pat in _SEGMENTS:
        rest = rest.replace("_" + pat, "." + pat)
        rest = rest.replace(pat + "_", pat + ".")
    return prefix + rest


def extract_lora_pairs(lora_sd: Mapping[str, torch.Tensor]):
    """-> {base_path: (down, up, alpha or None)} with diffusers-style base
    paths; a half without its other half is dropped."""
    pairs: Dict[str, list] = {}
    alphas: Dict[str, float] = {}
    for k, v in lora_sd.items():
        if k.endswith(".alpha"):
            alphas[_kohya_to_diffusers(k[:-len(".alpha")])] = float(v)
            continue
        m = re.match(
            r"(.*?)\.(?:lora_A|lora\.down|lora_down|lora_linear_layer\.down)\.weight$", k)
        if m:
            pairs.setdefault(_kohya_to_diffusers(m.group(1)), [None, None])[0] = v
            continue
        m = re.match(
            r"(.*?)\.(?:lora_B|lora\.up|lora_up|lora_linear_layer\.up)\.weight$", k)
        if m:
            pairs.setdefault(_kohya_to_diffusers(m.group(1)), [None, None])[1] = v
    return {base: (down, up, alphas.get(base))
            for base, (down, up) in pairs.items() if down is not None and up is not None}


def strip_prefix(base: str) -> Tuple[str, str]:
    """-> (component, path): the 'unet.' / 'text_encoder(_2).' prefixes."""
    for comp in ("unet", "text_encoder_2", "text_encoder"):
        if base.startswith(comp + "."):
            return comp, base[len(comp) + 1:]
    return "unet", base


def lora_delta(down: torch.Tensor, up: torch.Tensor, alpha, scale: float,
               shape) -> torch.Tensor:
    """scale * (alpha / rank) * up @ down in float32, shaped as the weight
    (`shape`; a 1x1 convolution's [out, in, 1, 1] included), on up's device."""
    down, up = down.float(), up.float().to(down.device)
    rank = down.shape[0]
    a = (alpha / rank) if alpha is not None else 1.0
    if len(shape) == 4:  # 1x1 conv LoRA
        delta = (up[:, :, 0, 0] @ down[:, :, 0, 0] if down.ndim == 4
                 else up.reshape(up.shape[0], -1) @ down.reshape(rank, -1))
        delta = delta.reshape(shape[0], shape[1])[..., None, None]
    else:
        delta = up @ down
    return scale * a * delta


def merge_lora_into_state_dict(sd: Mapping[str, torch.Tensor],
                               lora_sd: Mapping[str, torch.Tensor],
                               scale: float = 1.0, component: str = "unet",
                               device=None):
    """Fuses the LoRA pairs of `component` into a copy of `sd` (the inputs
    stay as they are). Each fused weight is computed in float32 (on `device`
    if given, else where the weight lies) and cast back to its dtype and
    device once. A pair with no base weight is reported and skipped (e.g. a
    text encoder's half while fusing the UNet). Returns (state dict, number
    of fused layers)."""
    sd = dict(sd)
    n_applied = 0
    for base, (down, up, alpha) in extract_lora_pairs(lora_sd).items():
        comp, path = strip_prefix(base)
        if comp != component:
            continue
        wkey = path + ".weight"
        if wkey not in sd and path.endswith("to_out"):  # diffusers' to_out.0
            wkey = path + ".0.weight"
        if wkey not in sd:
            print(f"[lora] no base weight for {base} (looked for {wkey})")
            continue
        w = sd[wkey]
        dev = w.device if device is None else torch.device(device)
        delta = lora_delta(down.to(dev), up.to(dev), alpha, scale, w.shape)
        sd[wkey] = (w.to(dev).float() + delta).to(dtype=w.dtype, device=w.device)
        n_applied += 1
    print(f"[lora] fused {n_applied} layers (scale={scale})")
    return sd, n_applied
