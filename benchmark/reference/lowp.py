"""The training cells' control: the reference one precision step below what
the configuration states. Components served in bfloat16 (the UNet and the
text towers) take their forward matrix products and convolutions in fp8
(e4m3, one scale a tensor: each operand rounded to fp8 and back, the
product then in bfloat16); components in float32 (the VAE, the adapter,
AdamW's moments) run in bfloat16. Plain PyTorch; imports nothing of the
program.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.overrides import TorchFunctionMode

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
# the products the reference's modules call (nn.Linear, nn.Conv2d, and `@`,
# which the mode sees as matmul), whose operands go through fp8
PRODUCTS = ("linear", "conv2d", "matmul")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to e4m3 under one per-tensor scale and back, in `x`'s
    type; the gradient passes straight through."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (x.detach().float() / scale).to(FP8).float().mul(scale).to(x.dtype)
    return x + (q - x).detach()


class Fp8Products(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") in PRODUCTS:
            args = tuple(fp8_round(a) if torch.is_tensor(a) and a.is_floating_point() else a
                         for a in args)
        return func(*args, **kwargs)


class Fp8Forward(nn.Module):
    """`module`'s forward with fp8 products; its parameters are the
    module's own."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, *args, **kwargs):
        with Fp8Products():
            return self.module(*args, **kwargs)
