"""Where a full-width student tower's bf16 states leave an fp32 run of the
same weights, block by block: the tower's weights drawn as the factory
draws them (N(0, 0.02), norm weights 1, biases 0, from a seed) and then
scaled to each of `--std`, one prompt of 52 ids (24 real, a padded tail).

    python3 -m pea_diffusion_tpu_torch.tools.tower_precision --family mt5 --std 0.02 0.01

Prints one line per standard deviation: after each block and after the
final norm (mt5) or the head (alt_clip), the max |bf16 - fp32| over max
|fp32|, and the fp32 states' RMS. Runs on the card unless --device cpu.
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from .. import configs
from ..pipelines.factory import _materialize, make_text_encoder_fn, resolve_device

TOWERS = {"mt5": "MT5_XL", "mul_clip": "XLM_ROBERTA_LARGE", "alt_clip": "ALT_CLIP_XLMR_L",
          "chinese_clip": "CHINESE_CLIP_LARGE"}


def block_gaps(family: str, std: float, device, seed: int = 21, tokens: int = 52,
               real: int = 24):
    """[(gap, fp32 RMS)] after each block, then of the family's output."""
    cfg = getattr(configs, TOWERS[family])
    with torch.device("meta"):
        enc, _ = make_text_encoder_fn(family, cfg)
    enc = _materialize(enc, torch.bfloat16, device,
                       torch.Generator(device=device).manual_seed(seed))
    with torch.no_grad():
        for mod in enc.modules():
            for name, p in mod.named_parameters(recurse=False):
                if p.ndim > 1:  # embeddings and projections, not norms or biases
                    p.mul_(std / 0.02)
    ids = np.random.default_rng(seed).integers(5, cfg.vocab_size, (1, tokens))
    ids[:, real:] = cfg.pad_token_id
    ids = torch.as_tensor(ids, device=device)
    runs = []
    for tower in (enc, copy.deepcopy(enc).float()):
        blocks = tower.encoder.block if family == "mt5" else tower.encoder.layer
        states = []
        hooks = [b.register_forward_hook(
            lambda m, a, out: states.append((out[0] if isinstance(out, tuple) else out).float()))
            for b in blocks]
        _, fn = make_text_encoder_fn(family, cfg, tower)
        with torch.inference_mode():
            states.append(fn(ids).float())
        for h in hooks:
            h.remove()
        runs.append(states)
    return [(((a - b).abs().max() / b.abs().max()).item(), b.square().mean().sqrt().item())
            for a, b in zip(*runs)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="mt5", choices=sorted(TOWERS))
    ap.add_argument("--std", nargs="+", type=float, default=[0.02, 0.01])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    for std in args.std:
        gaps = block_gaps(args.family, std, device)
        print(f"[tower_precision] {args.family} weights N(0, {std}): gap/rms by block "
              + " ".join(f"{i}:{g:.3g}/{r:.3g}" for i, (g, r) in enumerate(gaps[:-1]))
              + f"; output {gaps[-1][0]:.4g}", flush=True)


if __name__ == "__main__":
    main()
