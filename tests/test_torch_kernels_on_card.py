"""The port's attention kernels (B1 one-pass, B3 flash forward) against
their plain versions on a CUDA card, in the working types bf16/fp16: the
max error must stay below 8e-3 of the largest output, twice the most that
rounding the output to bf16 (2^-8 of its size) can move it.

This file imports neither JAX nor the JAX package, so it runs where the
card is, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_on_card.py

On a host without a card every test skips.
"""
import pytest
import torch

from pea_diffusion_tpu_torch.ops import flash_attention, onepass_attention

RTOL = 8e-3  # max |kernel - plain| / max |plain|


def _rel_err(out, ref):
    return ((out.float() - ref).abs().max() / ref.abs().max()).item()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,h,d,dtype", [
    (2, 1024, 1024, 20, 64, torch.bfloat16),
    (1, 300, 600, 2, 64, torch.bfloat16),
    (1, 256, 512, 2, 128, torch.float16),
])
def test_onepass_kernel_matches_plain_on_card(b, sq, skv, h, d, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(b, sq, h * d, device=dev, generator=g).to(dtype)
    k = torch.randn(b, skv, h * d, device=dev, generator=g).to(dtype)
    v = torch.randn(b, skv, h * d, device=dev, generator=g).to(dtype)
    n = onepass_attention.onepass_forward.launches
    out = onepass_attention.onepass_forward(q, k, v, h, d)
    torch.cuda.synchronize()
    assert onepass_attention.onepass_forward.launches == n + 1
    ref = onepass_attention.onepass_forward_ref(q.float(), k.float(), v.float(), h, d)
    assert out.dtype == dtype
    assert _rel_err(out, ref) < RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,d", [(20, 4096, 52, 64), (4, 300, 77, 128)])
def test_flash_kernel_matches_plain_on_card(bh, sq, skv, d):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g).bfloat16()
               for s in (sq, skv, skv))
    out, lse = flash_attention.flash_forward(q, k, v, with_lse=True)
    ref, ref_lse = flash_attention.flash_forward_ref(
        q.float(), k.float(), v.float(), with_lse=True)
    torch.cuda.synchronize()
    assert _rel_err(out, ref) < RTOL
    assert (lse - ref_lse).abs().max().item() < 1e-3


@pytest.mark.gpu
def test_kernels_reject_fp32_on_card():
    dev = _card()
    x = torch.zeros(1, 128, 128, device=dev)
    with pytest.raises(TypeError):
        onepass_attention.onepass_forward(x, x, x, 2, 64)
    with pytest.raises(TypeError):
        flash_attention.flash_forward(x, x, x)
