"""The comparison that decides ``correct`` in the ControlNet serving cell:
the plain fp32 references (``controlnet.py``, ``models.py``; TF32 off)
worked out from the run's own inputs (the seed's weights, token ids, noise,
guidance, control maps as the client sent them, and conditioning scales),
following the program's own state as ``checks.serve_check`` does. Imports
nothing of the program.

At a checked step i of a request: the reference ControlNet's residuals at
the program's latents x_i, the request's map and its scale against the
program's (``control_gap``: the worst relative gap over the ten residuals
of the CFG pair); the reference UNet's two outputs with the reference's
residuals against the program's (``pair_gap``; ``eps_gap`` after the per-row
guidance); the reference's DPM-Solver++ update from x_i against the
program's next latents (``step_gap``); the reference's decode of the
program's final latents against the PNG the client received
(``image_gap_max`` / ``image_gap_mean``, uint8 levels); the program's
initial latents against the request's noise (``start_gap``, exact).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import weights
from . import checks, controlnet, diffusion


def control_map(png_levels: np.ndarray) -> torch.Tensor:
    """The map a client sent, uint8 [H, W] or [H, W, 3], as the reference
    takes it: [1, H, W, 3] float32, levels over 255."""
    arr = np.asarray(png_levels)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return torch.from_numpy(arr.astype(np.float32) / 255.0)[None]


def controlnet_check(config: Dict, traffic: Dict, seed: int, requests: List[Dict],
                     device) -> Dict[str, float]:
    """`requests`: each as ``checks.serve_check`` takes them ({"text",
    "guidance", "seed", "checked", "steps": {i: (x_i, eps pair)} for each
    checked step, its predecessor and its successor, "final", "png"}) and
    "scale" (its conditioning scale), "map" (uint8 levels of the map it
    sent) and "residuals": {i: (the ten residuals of the pair as the
    ControlNet returned them, [2, h', w', C] each: uncond, cond)} at each
    checked step. Returns the worst of each number over the requests."""
    comp = config["components"]
    vocab = comp["text_encoder"]["config"]["vocab_size"]
    size, steps = traffic["size"], traffic["steps"]
    solver = diffusion.DPMSolver(config["scheduler"], steps)
    out = {"start_gap": 0.0, "control_gap": 0.0, "pair_gap": 0.0, "eps_gap": 0.0,
           "step_gap": 0.0, "image_gap_max": 0.0, "image_gap_mean": 0.0}
    with torch.no_grad(), checks.fp32_exact():
        text = weights.reference_module(config, "text_encoder", seed, device)
        adapter = weights.reference_module(config, "adapter", seed, device)
        ids = torch.as_tensor(np.stack(
            [checks.token_ids(r["text"], vocab, traffic["max_length"]) for r in requests]
            + [checks.token_ids(traffic.get("negative_prompt", ""), vocab,
                                traffic["max_length"])]), device=device)
        pooled, seq = adapter(text(ids))
        del text, adapter
        unet = weights.reference_module(config, "unet", seed, device)
        cn = controlnet.reference_controlnet(config, seed, device)
        time_ids = torch.tensor([[size, size, 0, 0, size, size]], dtype=torch.float32,
                                device=device).repeat(2, 1)
        for k, r in enumerate(requests):
            noise = torch.as_tensor(checks.request_noise(r["seed"], r["steps"][0][0].shape[1]))
            out["start_gap"] = max(out["start_gap"],
                                   float((r["steps"][0][0].cpu() - noise).abs().max()))
            ctx = torch.stack([seq[-1], seq[k]])
            added = {"text_embeds": torch.stack([pooled[-1], pooled[k]]), "time_ids": time_ids}
            cond = control_map(r["map"]).to(device).repeat(2, 1, 1, 1)

            def pair(i):
                """(the reference's residuals, its UNet outputs) at the
                program's x_i."""
                x = r["steps"][i][0].to(device).float()
                x2 = torch.cat([x, x])
                t = torch.full((2,), int(solver.t[i]), device=device)
                down, mid = cn(x2, t, ctx, cond, r["scale"], added)
                return down + [mid], controlnet.unet_with_residuals(unet, x2, t, ctx, added,
                                                                    down, mid)

            def eps(p):
                return diffusion.cfg_combine(p[:1], p[1:], [r["guidance"]])

            for i in r["checked"]:
                x = r["steps"][i][0].to(device).float()
                res_ref, p_ref = pair(i)
                for a, b in zip(r["residuals"][i], res_ref):
                    out["control_gap"] = max(out["control_gap"],
                                             checks.rel(a.to(device).float(), b))
                e_ref = eps(p_ref)
                prog = r["steps"][i][1].to(device).float()
                out["pair_gap"] = max(out["pair_gap"], checks.rel(prog, p_ref))
                out["eps_gap"] = max(out["eps_gap"], checks.rel(eps(prog), e_ref))
                prev = None
                if 0 < i < steps - 1:
                    prev = solver.x0(i - 1, r["steps"][i - 1][0].to(device).float(),
                                     eps(pair(i - 1)[1]))
                x_ref = solver.step(i, x, e_ref, prev)
                x_next = (r["steps"][i + 1][0] if i + 1 < steps else r["final"]).to(
                    device).float()
                out["step_gap"] = max(out["step_gap"], checks.rel(x_next, x_ref, x_ref - x))
        del unet, cn
        vae = weights.reference_module(config, "vae", seed, device)
        scaling = comp["vae"]["config"]["scaling_factor"]
        for r in requests:
            img = vae.decode(r["final"].to(device).float() / scaling)
            ref = torch.round(torch.clamp(img / 2 + 0.5, 0, 1)[0] * 255)
            diff = (torch.as_tensor(r["png"].copy(), device=device).float() - ref).abs()
            out["image_gap_max"] = max(out["image_gap_max"], float(diff.max()))
            out["image_gap_mean"] = max(out["image_gap_mean"], float(diff.mean()))
        del vae
    return out
