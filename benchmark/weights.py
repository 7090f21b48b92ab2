"""Random weights of a configuration's components, made from the run's seed
on the device: every weight N(0, 0.02), norm weights 1, biases 0, in the
type the component is served in, from one ``torch.Generator`` per
component and one ``randn`` call for all of its normal weights. The layout
(names, shapes, order) is the plain reference's (``reference/models.py``),
whose names the program's modules carry too, so the same state dict fills
both sides; the reference makes it again after the window, bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference import models as ref

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
# one generator stream per component, whatever else the configuration holds
SALT = {name: i for i, name in enumerate(ref.COMPONENTS)}


def generator(seed: int, component: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 64 + SALT[component]) % (2 ** 63))


def component_state(seed: int, component: str, cfg: Dict, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    layout = ref.parameter_layout(ref.build(component, cfg))
    n = sum(math.prod(shape) for _, shape, fill in layout if fill == "normal")
    flat = torch.randn(n, generator=generator(seed, component, device), device=device,
                       dtype=dtype).mul_(0.02)
    out, off = {}, 0
    for name, shape, fill in layout:
        if fill == "normal":
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape).clone()
            off += k
        else:
            out[name] = torch.full(shape, 1.0 if fill == "one" else 0.0, dtype=dtype,
                                   device=device)
    return out


def served_dtype(config: Dict, component: str) -> torch.dtype:
    return DTYPES[config["components"][component]["weights_dtype"]]


def reference_module(config: Dict, component: str, seed: int, device,
                     dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """The reference module of `component` holding the run's weights (made
    in the served type, then cast to `dtype`), for inference."""
    cfg = config["components"][component]["config"]
    state = component_state(seed, component, cfg, served_dtype(config, component), device)
    module = ref.build(component, cfg)
    module.load_state_dict({k: v.to(dtype) for k, v in state.items()}, assign=True)
    return module.eval().requires_grad_(False)
