"""The comparisons that decide ``correct``: the plain fp32 reference (TF32
off) worked out from the run's own inputs (the seed's weights, token ids,
noise, guidance, images and draws), judging what the program's timed path
produced. Imports nothing of the program.

Serving follows the program's trajectory: at a checked step i of a
request, the reference's guided noise prediction at the program's latents
x_i (the reference's own prompt states) is compared with the program's
(``eps_gap``), and the reference's DPM-Solver++ update from x_i with the
program's next latents (``step_gap``, relative to the reference's update);
the reference's VAE decode of the program's final latents is compared with
the PNG the client received (``image_gap``, uint8 levels).

Training follows its own three steps from the same initial adapter, on the
same batches and draws: each step's loss, the first gradient per leaf (the
program's read from AdamW's first moment after one step) and the adapter's
change over the three steps per leaf, each as the gap of norms against the
reference's norm of that leaf or of the median leaf, whichever is larger.
"""
from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import weights
from . import diffusion, lowp


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the reference's matrix products and convolutions."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def token_ids(text: str, vocab: int, length: int, pad: int = 4) -> np.ndarray:
    """A prompt's ids: one a character, the code point folded into the
    vocabulary past the 5 special ids, padded with `pad` (the deployment's
    stand-in tokenizer; the configuration's ``assumed``)."""
    ids = [(ord(c) % (vocab - 5)) + 5 for c in text[:length]]
    return np.asarray(ids + [pad] * (length - len(ids)), np.int64)


def request_noise(seed: int, latent: int) -> np.ndarray:
    """A request's initial latents [1, latent, latent, 4] from its seed."""
    rs = np.random.RandomState(seed & 0x7FFFFFFF)
    return rs.standard_normal((1, latent, latent, 4)).astype(np.float32)


def rel(a: torch.Tensor, b: torch.Tensor, base: Optional[torch.Tensor] = None) -> float:
    """||a - b|| / ||base|| (base: b), in fp64."""
    base = b if base is None else base
    return float((a.double() - b.double()).norm() / base.double().norm())


def serve_check(config: Dict, traffic: Dict, seed: int, requests: List[Dict],
                device) -> Dict[str, float]:
    """`requests`: each {"text", "guidance", "seed", "checked" (step indices),
    "steps": {i: (x_i [1,h,w,4] fp32, eps pair [2,h,w,4] as the UNet
    returned it: uncond, cond)} for each checked step, its predecessor and
    its successor, "final" (the latents the program decoded, [1,h,w,4]),
    "png" (uint8 [H, W, 3])}. Returns start_gap (the program's initial
    latents against the request's noise: exact), the worst pair_gap (the
    UNet's two outputs before guidance), eps_gap and
    step_gap over the checked steps, the worst image_gap_max /
    image_gap_mean over the requests."""
    comp = config["components"]
    vocab = comp["text_encoder"]["config"]["vocab_size"]
    size, steps = traffic["size"], traffic["steps"]
    solver = diffusion.DPMSolver(config["scheduler"], steps)
    out = {"start_gap": 0.0, "pair_gap": 0.0, "eps_gap": 0.0, "step_gap": 0.0,
           "image_gap_max": 0.0, "image_gap_mean": 0.0}
    with torch.no_grad(), fp32_exact():
        text = weights.reference_module(config, "text_encoder", seed, device)
        adapter = weights.reference_module(config, "adapter", seed, device)
        ids = torch.as_tensor(np.stack(
            [token_ids(r["text"], vocab, traffic["max_length"]) for r in requests]
            + [token_ids(traffic.get("negative_prompt", ""), vocab, traffic["max_length"])]),
            device=device)
        pooled, seq = adapter(text(ids))
        del text, adapter
        unet = weights.reference_module(config, "unet", seed, device)
        time_ids = torch.tensor([[size, size, 0, 0, size, size]], dtype=torch.float32,
                                device=device).repeat(2, 1)
        for k, r in enumerate(requests):
            noise = torch.as_tensor(request_noise(r["seed"], r["steps"][0][0].shape[1]))
            out["start_gap"] = max(out["start_gap"],
                                   float((r["steps"][0][0].cpu() - noise).abs().max()))
            ctx = torch.stack([seq[-1], seq[k]])
            added = {"text_embeds": torch.stack([pooled[-1], pooled[k]]), "time_ids": time_ids}

            def pair(i):
                x = r["steps"][i][0].to(device).float()
                t = torch.full((2,), int(solver.t[i]), device=device)
                return unet(torch.cat([x, x]), t, ctx, added)

            def eps(i, p=None):
                p = pair(i) if p is None else p
                return diffusion.cfg_combine(p[:1], p[1:], [r["guidance"]])

            for i in r["checked"]:
                x = r["steps"][i][0].to(device).float()
                p_ref = pair(i)
                e_ref = eps(i, p_ref)
                prog = r["steps"][i][1].to(device).float()
                out["pair_gap"] = max(out["pair_gap"], rel(prog, p_ref))
                e_prog = diffusion.cfg_combine(prog[:1], prog[1:], [r["guidance"]])
                out["eps_gap"] = max(out["eps_gap"], rel(e_prog, e_ref))
                prev = None
                if 0 < i < steps - 1:
                    prev = solver.x0(i - 1, r["steps"][i - 1][0].to(device).float(), eps(i - 1))
                x_ref = solver.step(i, x, e_ref, prev)
                x_next = (r["steps"][i + 1][0] if i + 1 < steps else r["final"]).to(device).float()
                out["step_gap"] = max(out["step_gap"], rel(x_next, x_ref, x_ref - x))
        del unet
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


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> float:
    """The worst | ||prog_leaf|| - ||ref_leaf|| | over the leaves `keep`,
    each against the larger of its reference norm and the median leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    median = statistics.median(norms.values())
    return max(abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], median)
               for k in keep)


def train_reference(config: Dict, hp: Dict, seed: int, batches: List[Dict],
                    draw_seeds: List[int], device, chunk: int, dtype=torch.float32,
                    fault: Optional[str] = None, control: bool = False) -> Dict:
    """The reference's steps over `batches` (one a step, the step's draws
    from its generator seed), from the seed's adapter, every module, the
    adapter's weights and AdamW's moments in `dtype`; the loss of each step
    is accumulated over row chunks of `chunk`. Returns the losses, the
    first step's clipped gradient per leaf, the change per leaf and the
    first step's gradient (for the leaf rule).

    `fault` plants one in the reference put in the program's place: "half"
    takes the loss over the first half of the rows only (their mean);
    "altered" doubles the largest leaf's gradient where it is made.
    `control` runs it one precision step below the configuration's
    (``lowp.py``): every module and the moments in bfloat16, and the
    bfloat16-served components' forward products in fp8."""
    if control:
        dtype = torch.bfloat16
    names = ["vae", "text_encoder", "unet", "adapter", "teacher_1", "teacher_2"]
    with fp32_exact():
        m = {n: weights.reference_module(config, n, seed, device, dtype=dtype)
             for n in names if n in config["components"]}
        if control:
            m = {n: lowp.Fp8Forward(mod) if weights.served_dtype(config, n) == torch.bfloat16
                 else mod for n, mod in m.items()}
        params = dict(m["adapter"].named_parameters())
        start = {k: p.detach().float().clone() for k, p in params.items()}
        for p in params.values():
            p.requires_grad_(True)
        opt = diffusion.AdamW({k: p.detach() for k, p in params.items()}, hp, dtype)
        acp = diffusion.alphas_cumprod(config["scheduler"])
        f = 2 ** (len(config["components"]["vae"]["config"]["block_out_channels"]) - 1)
        losses, first_grad, raw = [], None, None
        for step, (batch, dseed) in enumerate(zip(batches, draw_seeds)):
            rows, (h, w) = batch["pixel_values"].shape[0], batch["pixel_values"].shape[1:3]
            draws = diffusion.kd_draws(dseed, rows, (h // f, w // f), device)
            used = rows // 2 if fault == "half" else rows
            grads = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
            loss = 0.0
            for lo in range(0, used, chunk):
                part, _ = diffusion.kd_loss_rows(m, hp, batch, draws, acp,
                                                 slice(lo, min(lo + chunk, used)), used)
                g = torch.autograd.grad(part, list(params.values()))
                for k, gk in zip(params, g):
                    grads[k] += gk.float()
                loss += float(part.detach())
            if fault == "altered":
                big = max(grads, key=lambda k: float(grads[k].norm()))
                grads[big] = 2 * grads[big]
            losses.append(loss)
            opt.step({k: p.detach() for k, p in params.items()}, grads)
            if step == 0:
                first_grad = {k: opt.mu[k].float() / (1 - hp["adam_beta1"]) for k in params}
                raw = grads
        change = {k: params[k].detach().float() - start[k] for k in params}
    return {"losses": losses, "first_grad": first_grad, "change": change, "raw_grad": raw}


def leaves_kept(raw_grad: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose first reference gradient is not nought to rounding:
    norm at least a thousandth of the median leaf's."""
    norms = {k: float(g.double().norm()) for k, g in raw_grad.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """prog / ref: {"losses": [...], "first_grad": {leaf: tensor},
    "change": {leaf: tensor}}; the leaves kept by the reference's rule."""
    keep = leaves_kept(ref["raw_grad"])
    n = len(ref["losses"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"][:n], ref["losses"])),
        "grad_gap": leaf_gaps(prog["first_grad"], ref["first_grad"], keep),
        "change_gap": leaf_gaps(prog["change"], ref["change"], keep),
        "leaves_kept": len(keep), "leaves": len(ref["raw_grad"]),
    }
