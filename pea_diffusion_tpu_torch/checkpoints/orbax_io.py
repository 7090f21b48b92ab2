"""The reference's adapter checkpoint format, both ways (the port's
counterpart of the adapter half of the JAX package's
``checkpoints/orbax_io.py``; the train state itself goes through
``torch.save``, see ``train/trainer.py``).

The reference saves its projector as ``proj_<step>/pytorch_model.bin``:
``layernorm``, the MLP as ``projector.{0,2,4,...}`` (a Sequential with GELUs
between) and the ``fc`` head. The port's PEAAdapter carries those names, so
its state dict is the checkpoint. Some reference variants name a two-layer
MLP ``fc1``/``fc2`` instead; ``import_adapter`` reads both schemes.
"""
from __future__ import annotations

import os
import re
from typing import Dict, Mapping

import torch

from .safetensors_io import load_safetensors_torch, save_safetensors


def adapter_to_torch_names(adapter) -> Dict[str, torch.Tensor]:
    """A PEAAdapter (or its state dict) -> the reference `proj` state dict,
    fp32 on the CPU."""
    sd = adapter if isinstance(adapter, Mapping) else adapter.state_dict()
    return {k: v.detach().float().cpu().contiguous() for k, v in sd.items()}


def export_adapter(adapter, directory: str, step: int) -> str:
    """Writes ``proj_{step}/pytorch_model.bin`` as the reference does, plus
    a ``model.safetensors`` sibling with the same tensors. Returns the
    directory."""
    d = os.path.join(directory, f"proj_{step}")
    os.makedirs(d, exist_ok=True)
    sd = adapter_to_torch_names(adapter)
    save_safetensors(os.path.join(d, "model.safetensors"), sd)
    torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    return d


def _renamed(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Either naming scheme -> the PEAAdapter's names (the JAX package's
    ``torch_convert.convert_adapter``): `projector.N` in order of N becomes
    projector.0, 2, 4, ...; `fc1 .. fcK` becomes projector.0, 2, .. for all
    but the last, which is the `fc` head."""
    out = {f"layernorm.{p}": sd[f"layernorm.{p}"] for p in ("weight", "bias")}
    seq = sorted(int(m.group(1)) for k in sd
                 if (m := re.match(r"projector\.(\d+)\.weight$", k)))
    if seq:
        layers = [f"projector.{j}" for j in seq]
        head = "fc" if "fc.weight" in sd else None
    else:
        n = 1
        while f"fc{n + 1}.weight" in sd:
            n += 1
        layers, head = [f"fc{i}" for i in range(1, n)], f"fc{n}"
    names = [(name, f"projector.{2 * i}") for i, name in enumerate(layers)]
    for src, dst in names + ([(head, "fc")] if head else []):
        for p in ("weight", "bias"):
            if f"{src}.{p}" in sd:
                out[f"{dst}.{p}"] = sd[f"{src}.{p}"]
    return out


def import_adapter(path: str, adapter=None) -> Dict[str, torch.Tensor]:
    """Reads a reference ``pytorch_model.bin`` or ``.safetensors`` adapter
    checkpoint -> the PEAAdapter state dict (fp32); loads it into
    `adapter` too when one is given (every one of its tensors must be
    there)."""
    if path.endswith(".safetensors"):
        sd = load_safetensors_torch(path, upcast_bf16=True)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.float() for k, v in _renamed(sd).items()}
    if adapter is not None:
        adapter.load_state_dict(sd, strict=True)
    return sd
