"""The port's attention kernels (B1 one-pass, at head dim 64 the wgmma + TMA
body; B3 flash forward, on the wgmma + TMA body, in every variant; B4/B5
flash backward, on the wgmma + TMA body, in every variant) against their
plain versions
on a CUDA card, in the working types bf16/fp16, at SDXL's head dim 64,
SD1.5's 40, 80 and 160, and 128, and B1's tile variants (S1, both bodies)
against the plain version and shipped B1. Forward: the
max error must stay below 8e-3 of the largest output, twice the most that rounding the output to bf16 (2^-8 of its size)
can move it. Backward: below 2e-2 of the largest gradient, per output (P
and dS are rounded to bf16 before their products, and dS is a difference of
rounded terms). The attention modules' input gradients through the kernels
must match the plain route's within 2e-2 too. The GroupNorm kernels (B6,
B6-b) are held, in each variant (three_pass, persistent), to 8e-3 of their
fp32 plain version in bf16, fp16 and fp32, contiguous and channels-last,
and must give the same bits on a second run, also at the main paths'
shapes (CFG batch 16, the fp32 VAE maps); an SDXL UNet forward at CFG
batch 16 launches them for all 46 GroupNorms, and a KD step takes the
plain route only where an input needs a gradient. A LoRA fused on the card
gives the bits it gives on the CPU. The data pipeline's prefetcher copies
pinned host batches to the card on a side stream, in order, values intact.
The serving engine co-batches two requests into one call of the tiny stack
on the card, within 1 uint8 level of the same engine on the CPU.
The int8 convolution's product (torch._int_mm over an im2col, K and N
padded with zeros, rows padded past 16) gives its float64 plain version's
int32 sums exactly, and QConvInt8 on the card gives the CPU's bits.

This file imports neither JAX nor the JAX package, so it runs where the
card is, without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_on_card.py

On a host without a card every test skips.
"""
import pytest
import torch

from pea_diffusion_tpu_torch.models.layers import MultiHeadAttention, attention_route
from pea_diffusion_tpu_torch.ops import flash_attention, onepass_attention

RTOL = 8e-3  # max |kernel - plain| / max |plain|
BWD_RTOL = 2e-2  # the same, per gradient


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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,sq,skv,h", [
    (2, 4096, 4096, 10),   # SDXL self-attention, level 1
    (2, 1024, 1024, 20),   # SDXL self-attention, level 2
    (10, 1600, 1600, 10),  # the SDXL training teacher: ragged Q and KV tails at batch ends
    (2, 1024, 1000, 10),   # masked ragged KV
    (3, 200, 100, 4),      # a single KV tile (Skv <= 128), ragged Q
    (1, 4096, 4096, 10),   # no CFG (LCM-LoRA 1024²): batch 1, level 1
    (1, 1024, 1024, 20),   # no CFG (LCM-LoRA 1024²): batch 1, level 2
    (1, 1024, 1024, 10),   # no CFG (Turbo 512²): batch 1, level 1
])
def test_onepass_wgmma_kernel_matches_plain_on_card(b, sq, skv, h, dtype):
    """B1 at head dim 64, the wgmma + TMA body (attention_fwd_sm90_body.cuh), at
    the paths' shapes and the ragged cases its 3-D tensor maps must read as
    zeros, in both working types."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn(b, sq, h * 64, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, skv, h * 64, device=dev, generator=g).to(dtype) for _ in range(2))
    n = onepass_attention.onepass_forward.launches
    out = onepass_attention.onepass_forward(q, k, v, h, 64)
    torch.cuda.synchronize()
    assert onepass_attention.onepass_forward.launches == n + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = torch.cat([onepass_attention.onepass_forward_ref(q[i:i + 1].float(), k[i:i + 1].float(),
                                                           v[i:i + 1].float(), h, 64)
                     for i in range(b)])
    assert _rel_err(out, ref) < RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,d,dtype", [
    (20, 4096, 52, 64, torch.bfloat16),
    (4, 300, 77, 128, torch.bfloat16),
    (16, 4096, 4096, 40, torch.bfloat16),  # SD1.5 self-attention, level 0
    (16, 4096, 52, 40, torch.float16),     # SD1.5 cross-attention, level 0
    (16, 1024, 1024, 80, torch.float16),   # SD1.5 self-attention, level 1
    (16, 1024, 52, 80, torch.bfloat16),    # SD1.5 cross-attention, level 1
    (4, 1000, 1000, 40, torch.bfloat16),   # ragged Sq and Skv
    (4, 1000, 77, 80, torch.float16),
    (3, 77, 300, 40, torch.float16),       # fewer queries than one block
    (16, 1024, 1024, 160, torch.bfloat16),  # SD1.5 self-attention, level 2 at 1024²
    (16, 1024, 52, 160, torch.float16),     # SD1.5 cross-attention, level 2 at 1024²
    (4, 1000, 1000, 160, torch.bfloat16),   # ragged Sq and Skv
    (3, 77, 300, 160, torch.float16),
    (10, 4096, 52, 64, torch.bfloat16),     # no CFG (LCM-LoRA 1024²): cross-attention, level 1
    (20, 1024, 52, 64, torch.bfloat16),     # no CFG (LCM-LoRA 1024²): level 2
    (10, 1024, 52, 64, torch.bfloat16),     # no CFG (Turbo 512²): level 1
])
def test_flash_kernel_matches_plain_on_card(bh, sq, skv, d, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g).to(dtype)
               for s in (sq, skv, skv))
    out, lse = flash_attention.flash_forward(q, k, v, with_lse=True)
    plain = flash_attention.flash_forward(q, k, v)
    ref, ref_lse = flash_attention.flash_forward_ref(
        q.float(), k.float(), v.float(), with_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.equal(out, plain)
    assert _rel_err(out, ref) < RTOL
    assert (lse - ref_lse).abs().max().item() < 1e-3


# B3's cases for every variant: ragged Sq and Skv, Sq > Skv and Sq < Skv,
# one partial K/V tile (Skv 52 and 77), a single K/V tile of 100 rows
FLASH_CASES = [(4, 1000, 1000), (2, 1600, 1000), (2, 1000, 1600), (4, 300, 52), (4, 300, 77),
               (3, 200, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_variants_match_plain_on_card(d, dtype, bh, sq, skv):
    """B3 in every variant built at the head dim (the wgmma + TMA body's
    warpgroups and K/V tiles, and the mma.sync body), with and without
    lse: below 8e-3 of max |plain|, the lse within 1e-3 of the plain one,
    the same output with and without lse, one launch each; shipped B3
    gives the bits of the variant its rule picks."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d + sq + skv)
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g).to(dtype)
               for s in (sq, skv, skv))
    ref, ref_lse = flash_attention.flash_forward_ref(
        q.float(), k.float(), v.float(), with_lse=True)
    shipped = flash_attention.shipped_flash_variant(skv, d)
    for name, dims in flash_attention.FLASH_VARIANTS.items():
        if d not in dims:
            continue
        n = flash_attention.flash_forward_variant.launches[name]
        out, lse = flash_attention.flash_forward_variant(q, k, v, name, with_lse=True)
        plain = flash_attention.flash_forward_variant(q, k, v, name)
        torch.cuda.synchronize()
        assert flash_attention.flash_forward_variant.launches[name] == n + 2
        assert out.dtype == dtype and out.shape == q.shape and lse.shape == (bh, sq)
        assert torch.equal(out, plain), name
        assert _rel_err(out, ref) < RTOL, name
        assert (lse - ref_lse).abs().max().item() < 1e-3, name
        if name == shipped:
            got, got_lse = flash_attention.flash_forward(q, k, v, with_lse=True)
            assert torch.equal(got, out) and torch.equal(got_lse, lse)


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,d", [
    (4096, 4096, 40), (16384, 16384, 40), (4096, 52, 40), (4096, 77, 40),  # SD1.5 level 0
    (1024, 1024, 80), (4096, 4096, 80), (1024, 52, 80), (4096, 77, 80),    # level 1
    (1024, 1024, 160), (1024, 52, 160), (1024, 77, 160),                  # level 2 at 1024²
    (1600, 1600, 64), (1600, 52, 64), (4096, 52, 64), (1024, 52, 64),     # SDXL
])
def test_flash_ships_its_variant_at_the_paths_shapes_on_card(sq, skv, d):
    """At each (Sq, Skv, D) the paths run, shipped B3 gives the bits of the
    variant its rule names, with and without lse, and every self-attention
    shape runs the wgmma body."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(4, s, d, device=dev, generator=g).bfloat16() for s in (sq, skv, skv))
    shipped = flash_attention.shipped_flash_variant(skv, d)
    assert sq != skv or shipped != "mma_sync"
    for with_lse in (False, True):
        got = flash_attention.flash_forward(q, k, v, with_lse=with_lse)
        want = flash_attention.flash_forward_variant(q, k, v, shipped, with_lse=with_lse)
        for a, b in zip(got if with_lse else [got], want if with_lse else [want]):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernels_reject_fp32_on_card():
    dev = _card()
    x = torch.zeros(1, 128, 128, device=dev)
    with pytest.raises(TypeError):
        onepass_attention.onepass_forward(x, x, x, 2, 64)
    with pytest.raises(TypeError):
        flash_attention.flash_forward(x, x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv,d,dtype", [
    (4, 1600, 1600, 64, torch.bfloat16),   # self-attention, level 2
    (4, 6400, 52, 64, torch.bfloat16),     # cross-attention, Skv < one tile
    (2, 1000, 1000, 64, torch.bfloat16),   # ragged Sq and Skv
    (2, 300, 520, 128, torch.float16),
    (4, 4096, 4096, 40, torch.bfloat16),   # SD1.5 self-attention, level 0
    (4, 4096, 52, 40, torch.float16),      # SD1.5 cross-attention, level 0
    (8, 1024, 1024, 80, torch.bfloat16),   # SD1.5 self-attention, level 1
    (8, 1024, 52, 80, torch.float16),      # SD1.5 cross-attention, level 1
    (8, 1000, 1000, 40, torch.float16),    # ragged Sq and Skv
    (4, 1000, 77, 80, torch.bfloat16),
    (2, 300, 520, 80, torch.float16),
    (8, 1024, 1024, 160, torch.bfloat16),  # SD1.5 self-attention, level 2 at 1024²
    (8, 1024, 52, 160, torch.float16),     # SD1.5 cross-attention, level 2 at 1024²
    (4, 1000, 1000, 160, torch.bfloat16),  # ragged Sq and Skv
    (2, 300, 520, 160, torch.float16),
])
def test_flash_backward_kernels_match_plain_on_card(bh, sq, skv, d, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g).to(dtype)
               for s in (sq, skv, skv))
    do = torch.randn(bh, sq, d, device=dev, generator=g).to(dtype)
    out, lse = flash_attention.flash_forward(q, k, v, with_lse=True)
    scale = d ** -0.5
    n4, n5 = (flash_attention.flash_backward_dkdv.launches,
              flash_attention.flash_backward_dq.launches)
    got = flash_attention.flash_backward(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert flash_attention.flash_backward_dkdv.launches == n4 + 1
    assert flash_attention.flash_backward_dq.launches == n5 + 1
    want = flash_attention.flash_backward_ref(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        assert _rel_err(a, b) < BWD_RTOL, (name, _rel_err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("bh,sq,skv", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", flash_attention.HEAD_DIMS)
def test_flash_backward_variants_match_plain_on_card(d, dtype, bh, sq, skv):
    """B4 and B5 in every variant built at the head dim (the wgmma + TMA
    body's warpgroups and streamed tiles, and the mma.sync body): dQ, dK and
    dV each below 2e-2 of max |plain|, the same bits from two launches, one
    launch each; the shipped B4 and B5 give the bits of the variant their
    rule picks."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(d + sq + skv + 1)
    q, k, v = (torch.randn(bh, s, d, device=dev, generator=g).to(dtype)
               for s in (sq, skv, skv))
    do = torch.randn(bh, sq, d, device=dev, generator=g).to(dtype)
    out, lse = flash_attention.flash_forward(q, k, v, with_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    scale = d ** -0.5
    args = (q, k, v, do, lse, delta, scale)
    ref_dq, ref_dk, ref_dv = flash_attention.flash_backward_ref(
        q.float(), k.float(), v.float(), out.float(), lse, do.float(), scale)
    shipped = {"dkdv": flash_attention.flash_backward_dkdv(*args),
               "dq": (flash_attention.flash_backward_dq(*args),)}
    refs = {"dkdv": (("dk", ref_dk), ("dv", ref_dv)), "dq": (("dq", ref_dq),)}
    for which, table in flash_attention.BWD_VARIANTS.items():
        ship = flash_attention.shipped_bwd_variant(which, sq, skv, d)
        for name, dims in table.items():
            if d not in dims:
                continue
            n = flash_attention.flash_backward_variant.launches[which][name]
            got = flash_attention.flash_backward_variant(*args, name, which)
            again = flash_attention.flash_backward_variant(*args, name, which)
            got, again = (got, again) if which == "dkdv" else ((got,), (again,))
            torch.cuda.synchronize()
            assert flash_attention.flash_backward_variant.launches[which][name] == n + 2
            for a, b, (out_name, ref) in zip(got, again, refs[which]):
                assert a.dtype == dtype and a.shape == ref.shape, (name, out_name)
                assert torch.equal(a, b), (name, out_name)
                assert _rel_err(a, ref) < BWD_RTOL, (name, out_name, _rel_err(a, ref))
            if name == ship:
                assert all(torch.equal(a, b) for a, b in zip(got, shipped[which])), name


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv,d", [
    (4096, 4096, 40), (16384, 16384, 40), (4096, 52, 40), (16384, 52, 40),  # SD1.5 level 0
    (1024, 1024, 80), (4096, 4096, 80), (1024, 52, 80), (4096, 52, 80),    # level 1
    (1024, 1024, 160), (1024, 52, 160),                                   # level 2 at 1024²
    (1600, 1600, 64), (1600, 52, 64),                                     # SDXL training
])
def test_flash_backward_ships_its_variant_at_the_paths_shapes_on_card(sq, skv, d):
    """At each (Sq, Skv, D) the training paths run, shipped B4 and B5 give
    the bits of the variants their rule names, and every self-attention
    shape runs the wgmma body."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(10)
    q, k, v = (torch.randn(2, s, d, device=dev, generator=g).bfloat16() for s in (sq, skv, skv))
    do = torch.randn(2, sq, d, device=dev, generator=g).bfloat16()
    out, lse = flash_attention.flash_forward(q, k, v, with_lse=True)
    args = (q, k, v, do, lse, (do.float() * out.float()).sum(-1), d ** -0.5)
    for which, run in (("dkdv", flash_attention.flash_backward_dkdv),
                       ("dq", flash_attention.flash_backward_dq)):
        shipped = flash_attention.shipped_bwd_variant(which, sq, skv, d)
        assert sq != skv or shipped != "mma_sync"
        got, want = run(*args), flash_attention.flash_backward_variant(*args, shipped, which)
        got, want = (got, want) if which == "dkdv" else ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), which


@pytest.mark.gpu
@pytest.mark.parametrize("sq,skv_ctx,channels,heads", [
    (1024, None, 640, 10), (1024, 52, 640, 10), (1600, None, 640, 10),
    # SD1.5: 8 heads of 40 at level 0, 8 of 80 at level 1, 8 of 160 at level
    # 2 (1024²), all on B3
    (4096, None, 320, 8), (4096, 52, 320, 8), (1024, None, 640, 8), (1024, 77, 640, 8),
    (1024, None, 1280, 8), (1024, 52, 1280, 8),
])
def test_attention_module_input_grads_through_kernels_on_card(sq, skv_ctx, channels, heads):
    """dx and dcontext through the kernel routes (onepass: B3 with lse, B4,
    B5 via bshd_attention; flash: the same via flash_attention) are
    non-zero and match the plain route."""
    dev = _card()
    torch.manual_seed(0)
    d = channels // heads
    attn = MultiHeadAttention(channels, heads, d, context_dim=skv_ctx and 64).to(
        dev, torch.bfloat16)
    attn.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(1, sq, channels, device=dev, generator=g).bfloat16()
    ctx = (None if skv_ctx is None else
           torch.randn(1, skv_ctx, 64, device=dev, generator=g).bfloat16())
    route = attention_route(sq, sq if ctx is None else skv_ctx, heads, d, "flash", "cuda")
    assert route == ("onepass" if ctx is None and d == 64 else "flash")

    def grads(backend):
        attn.backend = backend
        xs = x.clone().requires_grad_(True)
        cs = None if ctx is None else ctx.clone().requires_grad_(True)
        out = attn(xs, cs)
        out.float().pow(2).sum().backward()
        return [t.grad for t in (xs, cs) if t is not None]

    n4 = flash_attention.flash_backward_dkdv.launches
    got = grads("flash")
    assert flash_attention.flash_backward_dkdv.launches == n4 + 1
    want = grads("xla")
    for a, b in zip(got, want):
        assert a.abs().max().item() > 0
        assert _rel_err(a, b.float()) < BWD_RTOL


@pytest.mark.gpu
def test_bshd_attention_grads_through_kernels_on_card():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(2, s, 640, device=dev, generator=g).bfloat16().requires_grad_(True)
               for s in (1600, 1600, 1600))
    assert onepass_attention.supports(1600, 1600, 10, 64)
    out = onepass_attention.bshd_attention(q, k, v, 10, 64)
    assert type(out.grad_fn).__name__ == "BSHDAttentionBackward"
    gout = torch.randn(out.shape, device=dev, generator=g).bfloat16()
    got = torch.autograd.grad(out, (q, k, v), gout)
    qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
    ref = onepass_attention.onepass_forward_ref(qf, kf, vf, 10, 64)
    want = torch.autograd.grad(ref, (qf, kf, vf), gout.float())
    for a, b in zip(got, want):
        assert a.abs().max().item() > 0
        assert _rel_err(a, b) < BWD_RTOL


@pytest.mark.gpu
def test_bare_kernel_wrappers_refuse_inputs_that_need_grad_on_card():
    dev = _card()
    x = torch.zeros(2, 128, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    lse = torch.zeros(2, 128, device=dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention.flash_forward(x, x, x)
    with pytest.raises(RuntimeError, match="no gradient"):
        onepass_attention.onepass_forward(x.view(1, 256, 64), x.view(1, 256, 64),
                                          x.view(1, 256, 64), 1, 64)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention.flash_backward_dkdv(x, x, x, x, lse, lse, 0.125)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention.flash_backward_dq(x, x, x, x, lse, lse, 0.125)
    with torch.no_grad():  # without grad mode the kernels run
        flash_attention.flash_forward(x, x, x)


@pytest.mark.gpu
def test_kernels_reject_other_head_dims_on_card():
    """Any width the kernels are not built for (they take 40, 64, 80, 128
    and 160) raises on a CUDA tensor, naming the width; nothing falls
    back."""
    dev = _card()
    for d in (32, 96, 256):
        x = torch.zeros(2, 128, d, device=dev, dtype=torch.bfloat16)
        lse = torch.zeros(2, 128, device=dev)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_forward(x, x, x)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_backward_dkdv(x, x, x, x, lse, lse, 0.1)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_backward_dq(x, x, x, x, lse, lse, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,h", [
    (2, 1024, 1024, 20),  # the sweep's b2 level-2 shape
    (1, 300, 600, 2),     # ragged Sq and Skv against 128-row tiles
    (3, 77, 1000, 4),     # fewer queries than one block
])
def test_onepass_variants_match_plain_and_b1_on_card(b, sq, skv, h):
    """S1: every tile variant of B1 against the plain version; the variant
    B1 ships at the shape gives B1's bits."""
    from pea_diffusion_tpu_torch.tools import sweep_onepass as sw

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(b, sq, h * 64, device=dev, generator=g).bfloat16()
    k, v = (torch.randn(b, skv, h * 64, device=dev, generator=g).bfloat16() for _ in range(2))
    shipped = onepass_attention.onepass_forward(q, k, v, h, 64)
    ref = onepass_attention.onepass_forward_ref(q.float(), k.float(), v.float(), h, 64)
    assert sw.library_variants() == sw.VARIANTS
    for name in sw.VARIANTS:
        n = sw.onepass_forward_variant.launches[name]
        out = sw.onepass_forward_variant(q, k, v, h, 64, name)
        torch.cuda.synchronize()
        assert sw.onepass_forward_variant.launches[name] == n + 1
        assert out.dtype == torch.bfloat16 and out.shape == q.shape
        assert _rel_err(out, ref) < RTOL, name
        if name == sw.shipped_variant(sq):
            assert torch.equal(out, shipped)


@pytest.mark.gpu
def test_onepass_variants_reject_what_they_do_not_take_on_card():
    from pea_diffusion_tpu_torch.tools import sweep_onepass as sw

    dev = _card()
    x = torch.zeros(1, 128, 128, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        sw.onepass_forward_variant(x, x, x, 2, 64, sw.shipped_variant(128))
    with pytest.raises(ValueError, match="head_dim=128"):
        sw.onepass_forward_variant(x.bfloat16(), x.bfloat16(), x.bfloat16(), 1, 128,
                                    sw.shipped_variant(128))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups,dtype,act,with_t", [
    ((2, 320, 128, 128), 32, torch.bfloat16, "silu", True),   # SDXL level 0 norm2
    ((2, 2560, 32, 32), 32, torch.bfloat16, "silu", False),   # up block level 2 norm1
    ((2, 1280, 32, 32), 32, torch.float16, "none", False),    # Transformer2D.norm
    ((1, 128, 256, 256), 32, torch.float32, "silu", False),   # fp32 VAE
    ((2, 960, 30, 30), 32, torch.bfloat16, "silu", True),     # ragged H*W, 30 per group
    ((1, 93, 17, 19), 3, torch.float16, "none", True),        # 31 per group, odd rows
    ((2, 1280, 64, 64), 32, torch.bfloat16, "silu", True),    # resident over many blocks
    ((1, 256, 512, 512), 32, torch.bfloat16, "silu", False),  # VAE: read twice
])
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("variant", ["three_pass", "persistent"])
def test_groupnorm_kernels_match_plain_on_card(shape, groups, dtype, act, with_t,
                                               channels_last, variant):
    """Each variant of B6/B6-b against fused_gn_ref in fp32, the same bits
    from two launches, and the shipped wrapper with the bits of the variant
    the library's rule picks for the shape."""
    from pea_diffusion_tpu_torch.ops import groupnorm

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    n, c = shape[:2]
    x = (0.5 + 2 * torch.randn(*shape, device=dev, generator=g)).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    scale = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(c, device=dev, generator=g)).float()  # fp32 beside x's type
    t = torch.randn(n, c, device=dev, generator=g).to(dtype) if with_t else None
    fn = groupnorm.group_norm_bias_fwd if with_t else groupnorm.group_norm_fwd
    runs = groupnorm.group_norm_variant.launches[variant]
    out, again = (groupnorm.group_norm_variant(x, scale, bias, groups, 1e-5, act, t=t,
                                               variant=variant) for _ in range(2))
    n6 = fn.launches
    shipped = (fn(x, t, scale, bias, groups, 1e-5, act) if with_t
               else fn(x, scale, bias, groups, 1e-5, act))
    torch.cuda.synchronize()
    assert groupnorm.group_norm_variant.launches[variant] == runs + 2
    assert fn.launches == n6 + 1
    ref = groupnorm.fused_gn_ref(x.float(), scale.float(), bias, groups, 1e-5, act,
                                 None if t is None else t.float())
    assert out.dtype == dtype and out.shape == x.shape
    assert out.is_contiguous(memory_format=torch.channels_last) == channels_last
    assert torch.equal(out, again)  # fixed summation order: the same bits every run
    assert _rel_err(out, ref) < RTOL
    if groupnorm.shipped_gn_variant(n, c, shape[2] * shape[3], groups, channels_last,
                                    dtype, x.data_ptr()) == variant:
        assert torch.equal(shipped, out)


@pytest.mark.gpu
def test_groupnorm_persistent_raises_on_a_grid_the_card_cannot_hold_on_card():
    """The persistent variant's cooperative launch with more blocks than the
    card holds at once is refused, and the wrapper raises instead of
    running anything else; the next launch runs as before."""
    from pea_diffusion_tpu_torch.ops import groupnorm

    dev = _card()
    x = torch.randn(2, 320, 16, 16, device=dev).bfloat16().contiguous(
        memory_format=torch.channels_last)
    w, b = torch.ones(320, device=dev), torch.zeros(320, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    runs = groupnorm.group_norm_variant.launches["persistent"]
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        groupnorm.group_norm_variant(x, w, b, 32, variant="persistent", blocks=8 * sms)
    assert groupnorm.group_norm_variant.launches["persistent"] == runs
    out = groupnorm.group_norm_variant(x, w, b, 32, variant="persistent")
    assert _rel_err(out, groupnorm.fused_gn_ref(x.float(), w, b, 32)) < RTOL


@pytest.mark.gpu
def test_groupnorm_kernel_copies_other_strides_on_card():
    from pea_diffusion_tpu_torch.ops import groupnorm

    dev = _card()
    x = torch.randn(2, 64, 8, 12, device=dev, dtype=torch.bfloat16)[..., :8]
    w, b = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    copies = groupnorm.group_norm_fwd.copies
    out = groupnorm.group_norm_fwd(x, w, b, 32)
    assert groupnorm.group_norm_fwd.copies == copies + 1
    assert _rel_err(out, groupnorm.fused_gn_ref(x.float(), w, b, 32)) < RTOL


@pytest.mark.gpu
def test_groupnorm_module_takes_the_kernels_behind_the_opt_in_on_card(monkeypatch):
    """GroupNorm(act=silu) with a time embedding: B6-b with the opt-in on
    (values, and x/t/scale/bias gradients through the Function's plain VJP),
    nothing with it off."""
    from pea_diffusion_tpu_torch.models.layers import GroupNorm
    from pea_diffusion_tpu_torch.ops import groupnorm

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(6)
    norm = GroupNorm(640, 32, 1e-5, act="silu").to(dev, torch.bfloat16)
    x = torch.randn(2, 640, 64, 64, device=dev, generator=g).bfloat16().requires_grad_(True)
    t = torch.randn(2, 640, device=dev, generator=g).bfloat16().requires_grad_(True)
    gout = torch.randn(2, 640, 64, 64, device=dev, generator=g).bfloat16()
    grads = {}
    for on in ("0", "1"):
        monkeypatch.setenv("PEA_FUSED_GROUPNORM", on)
        n = groupnorm.group_norm_bias_fwd.launches
        out = norm(x, t)
        assert groupnorm.group_norm_bias_fwd.launches == n + int(on == "1")
        grads[on] = [out.float()] + list(torch.autograd.grad(
            out, (x, t, norm.weight, norm.bias), gout))
    for a, b in zip(grads["1"], grads["0"]):
        assert _rel_err(a, b.float()) < BWD_RTOL


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [
    ((16, 320, 128, 128), torch.bfloat16),   # SDXL at CFG batch 16: level 0
    ((16, 640, 128, 128), torch.bfloat16),   # up block 2's concat
    ((16, 960, 128, 128), torch.bfloat16),   # up block 2's first resnet: over 28 MB a sample
    ((16, 1280, 64, 64), torch.bfloat16),
    ((16, 1920, 64, 64), torch.bfloat16),
    ((16, 2560, 32, 32), torch.bfloat16),
    ((1, 128, 1024, 1024), torch.float32),   # the SDXL VAE decoder's last level
    ((1, 512, 128, 128), torch.float32),     # its mid block
    ((2, 128, 512, 512), torch.float32),     # the SD1.5 VAE encoder's chunk of 2
    ((2, 512, 64, 64), torch.float32),
])
@pytest.mark.parametrize("with_t", [False, True])
def test_groupnorm_kernels_at_main_path_shapes_on_card(shape, dtype, with_t):
    """B6 / B6-b, as the route launches them (the shipped variant and wave
    plan, channels-last), against fused_gn_ref in fp32 at the main paths'
    shapes, and the same bits on a second run."""
    from pea_diffusion_tpu_torch.ops import groupnorm

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    n, c = shape[:2]
    x = (0.5 + 2 * torch.randn(*shape, device=dev, generator=g)).to(dtype).contiguous(
        memory_format=torch.channels_last)
    scale = (1 + 0.1 * torch.randn(c, device=dev, generator=g)).to(dtype)
    bias = (0.1 * torch.randn(c, device=dev, generator=g)).to(dtype)
    t = torch.randn(n, c, device=dev, generator=g).to(dtype) if with_t else None
    fn = groupnorm.group_norm_bias_fwd if with_t else groupnorm.group_norm_fwd
    args = ((x, t) if with_t else (x,)) + (scale, bias, 32, 1e-5, "silu")
    launches = fn.launches
    out, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 2
    assert out.dtype == dtype and out.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(out, again)
    ref = groupnorm.fused_gn_ref(x.float(), scale.float(), bias.float(), 32, 1e-5, "silu",
                                 None if t is None else t.float())
    assert _rel_err(out, ref) < RTOL


def _gn_counts():
    from pea_diffusion_tpu_torch.ops import groupnorm

    return (groupnorm.group_norm_fwd.launches + groupnorm.group_norm_bias_fwd.launches,
            groupnorm.group_norm_act.cuda_calls)


@pytest.mark.gpu
def test_sdxl_unet_at_cfg_batch_16_takes_the_kernel_for_every_groupnorm_on_card(monkeypatch):
    """Under inference_mode, with PEA_FUSED_GROUPNORM unset, one SDXL UNet
    forward at CFG batch 16 (1024², bf16, random weights) launches B6 / B6-b
    for each of its 46 GroupNorms and takes the plain route for none."""
    from pea_diffusion_tpu_torch.configs import SDXL_UNET
    from pea_diffusion_tpu_torch.models import UNet2DCondition
    from pea_diffusion_tpu_torch.models.layers import GroupNorm

    dev = _card()
    monkeypatch.delenv("PEA_FUSED_GROUPNORM", raising=False)
    with torch.device(dev):
        unet = UNet2DCondition(SDXL_UNET).to(torch.bfloat16)
    assert sum(isinstance(m, GroupNorm) for m in unet.modules()) == 46
    g = torch.Generator(device=dev).manual_seed(8)
    b = 16
    with torch.inference_mode():
        kernel, plain = _gn_counts()
        unet(torch.randn(b, 128, 128, 4, device=dev, generator=g), torch.full((b,), 500.0,
                                                                               device=dev),
             torch.randn(b, 77, 2048, device=dev, generator=g),
             {"text_embeds": torch.randn(b, 1280, device=dev, generator=g),
              "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * b, device=dev)})
        torch.cuda.synchronize()
        assert _gn_counts() == (kernel + 46, plain)


@pytest.mark.gpu
def test_kd_step_takes_the_plain_route_only_where_a_gradient_is_needed_on_card(
        tmp_path, monkeypatch):
    """One KD step of the full-width SD1.5 stack (bf16 UNet, fp32 VAE, batch
    2 at 256²) on the card: every GroupNorm call (VAE encode, teacher, the
    student's forward and its recompute) launches the kernel where no input
    needs a gradient and takes the plain route where one does, and only the
    student's calls need one."""
    from pea_diffusion_tpu_torch.cli import train as train_cli
    from pea_diffusion_tpu_torch.configs import TrainConfig
    from pea_diffusion_tpu_torch.models.layers import GroupNorm
    from pea_diffusion_tpu_torch.ops.flash_attention import needs_grad
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    _card()
    monkeypatch.delenv("PEA_FUSED_GROUPNORM", raising=False)
    models, make_batches = train_cli.build_demo_full("cuda", batch_size=2, size=256,
                                                     model="sd15")
    trainer = KDTrainer(models, TrainConfig(output_dir=str(tmp_path), batch_size_per_device=2,
                                            log_every_n_steps=100, every_n_steps=100))
    calls = []  # (module, whether an input needs a gradient)

    def record(module, args, kwargs):
        extra = kwargs.get("extra_bias", args[1] if len(args) > 1 else None)
        inputs = (args[0], module.weight, module.bias) + (() if extra is None else (extra,))
        calls.append((module, needs_grad(*inputs)))

    hooks = [m.register_forward_pre_hook(record, with_kwargs=True)
             for net in (models.unet, models.vae) for m in net.modules()
             if isinstance(m, GroupNorm)]
    try:
        kernel, plain = _gn_counts()
        trainer.fit(make_batches(0), max_steps=1)
        torch.cuda.synchronize()
        got = _gn_counts()
    finally:
        for h in hooks:
            h.remove()
    unet_norms = {m for m in models.unet.modules() if isinstance(m, GroupNorm)}
    graded = sum(grad for _, grad in calls)
    assert 0 < graded < len(calls)
    assert all(m in unet_norms for m, grad in calls if grad)
    assert got == (kernel + len(calls) - graded, plain + graded)


@pytest.mark.gpu
def test_groupnorm_wrappers_refuse_inputs_that_need_grad_on_card():
    from pea_diffusion_tpu_torch.ops import groupnorm

    dev = _card()
    x = torch.zeros(1, 32, 4, 4, device=dev, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(32, device=dev)
    with pytest.raises(RuntimeError, match="no gradient"):
        groupnorm.group_norm_fwd(x, w, w, 8)
    with pytest.raises(RuntimeError, match="no gradient"):
        groupnorm.group_norm_bias_fwd(x, w[None], w, w, 8)
    with pytest.raises(TypeError):
        groupnorm.group_norm_fwd(x.detach().double(), w, w, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_merge_on_card_gives_the_cpu_bits(dtype):
    """checkpoints/lora.py on CUDA tensors (weights on the card, or on the
    CPU with the products on the card, as the loaders run it) against the
    CPU. On a grid of 1/8 every product and sum is exact in fp32, so the
    bits must be equal whatever the summation order; on normal draws the
    float32 merge agrees within 1e-6 of its scale."""
    from pea_diffusion_tpu_torch.checkpoints.lora import merge_lora_into_state_dict

    dev = _card()
    g = torch.Generator().manual_seed(0)
    key = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q"
    base = f"unet.{key}"
    for grid in (True, False):
        if grid:
            w = (torch.randint(-64, 64, (640, 640), generator=g) / 8).to(dtype)
            down = torch.randint(-8, 8, (64, 640), generator=g) / 8
            up = torch.randint(-8, 8, (640, 64), generator=g) / 8
        else:
            w = torch.randn(640, 640, generator=g).to(dtype)
            down, up = torch.randn(64, 640, generator=g), torch.randn(640, 64, generator=g)
        lora_sd = {f"{base}.lora_A.weight": down, f"{base}.lora_B.weight": up,
                   f"{base}.alpha": torch.tensor(32.0)}
        cpu, n = merge_lora_into_state_dict({f"{key}.weight": w}, lora_sd, 0.5)
        on_card, _ = merge_lora_into_state_dict(
            {f"{key}.weight": w.to(dev)}, {k: v.to(dev) for k, v in lora_sd.items()}, 0.5)
        products_on_card, _ = merge_lora_into_state_dict({f"{key}.weight": w}, lora_sd, 0.5,
                                                         device=dev)
        want = cpu[f"{key}.weight"]
        assert n == 1 and want.dtype == dtype and not torch.equal(want, w)
        assert on_card[f"{key}.weight"].device.type == "cuda"
        assert products_on_card[f"{key}.weight"].device.type == "cpu"
        for got in (on_card[f"{key}.weight"].cpu(), products_on_card[f"{key}.weight"]):
            assert got.dtype == dtype
            err = (got.float() - want.float()).abs()
            if grid:
                assert torch.equal(got, want)
            elif dtype == torch.float32:
                assert err.max().item() <= 1e-6 * want.abs().max().item()
            else:  # at most one bf16 step
                assert bool((err <= 2.0 ** (torch.frexp(want.float())[1] - 8)).all())


@pytest.mark.gpu
def test_prefetcher_copies_pinned_batches_on_a_side_stream_on_card():
    """The data pipeline's prefetcher on the card: each batch arrives on the
    card with the host tensors' values while the consumer's stream is busy
    with work on the previous batch, in order, lists passed through, and
    the producer's exception raised in the consumer."""
    dev = _card()
    from pea_diffusion_tpu_torch.data.pipeline import prefetch_to_device

    gen = torch.Generator().manual_seed(0)
    src = [{"pixel_values": torch.randn((4, 256, 256, 3), generator=gen),
            "input_ids": torch.randint(0, 1000, (4, 52), generator=gen),
            "prompts": [f"p{i}"] * 4} for i in range(6)]
    seen = []
    for i, batch in enumerate(prefetch_to_device(iter(src), "cuda", depth=2)):
        assert batch["pixel_values"].device.type == dev.type
        assert batch["prompts"] == src[i]["prompts"]
        x = batch["pixel_values"]
        for _ in range(20):  # keep the consumer's stream busy while copies continue
            x = x * 1.0001
        seen.append((x.sum().item(), batch["pixel_values"].cpu(), batch["input_ids"].cpu()))
    assert len(seen) == len(src)
    for (_, px, ids), s in zip(seen, src):
        assert torch.equal(px, s["pixel_values"]) and torch.equal(ids, s["input_ids"])

    def failing():
        yield src[0]
        raise OSError("shard unreadable")

    it = iter(prefetch_to_device(failing(), "cuda"))
    next(it)
    with pytest.raises(OSError, match="shard unreadable"):
        next(it)


@pytest.mark.gpu
def test_serving_engine_cobatches_on_card():
    """The serving engine (cli/serve.py) on the card: two concurrent requests
    with different guidance run as one call of the tiny fp32 SDXL stack
    (DDIM, 2 steps; its worker thread owns every CUDA op), and each image
    is within 1 uint8 level of the same engine's on the CPU at the same
    weights (TF32 off)."""
    import threading

    import numpy as np

    from pea_diffusion_tpu_torch.cli.generate import build_demo
    from pea_diffusion_tpu_torch.cli.serve import BatchingEngine
    from pea_diffusion_tpu_torch.pipelines import StableDiffusionXLPEAPipeline

    _card()
    cpu, tokenize, _ = build_demo("cpu")
    gpu, _, _ = build_demo("cuda")
    for name in ("text_encoder", "adapter", "unet", "vae"):
        getattr(gpu, name).load_state_dict(getattr(cpu, name).state_dict())
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    reqs = [("一只猫", "", 2, 7.5, 0.0, 3), ("雪山下的湖泊", "模糊", 2, 5.0, 0.0, 4)]
    images = {}
    try:
        for dev, models in (("cpu", cpu), ("cuda", gpu)):
            engine = BatchingEngine(StableDiffusionXLPEAPipeline(models, "ddim"), tokenize, 64,
                                    max_batch=2, window_ms=60_000)
            out = [None, None]

            def call(i):
                out[i] = engine.submit(*reqs[i])

            threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
                assert not t.is_alive()
            engine.close(60)
            assert engine.stats["device_calls"] == 1 and engine.stats["batch_hist"] == {"2": 1}
            images[dev] = [np.asarray(img, np.int16) for img in out]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    for got, want in zip(images["cuda"], images["cpu"]):
        assert got.shape == (16, 16, 3)
        assert np.abs(got - want).max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("b,cin,cout,side,k,stride", [
    (2, 320, 320, 32, 3, 1),
    (2, 320, 640, 32, 3, 2),
    (1, 4, 320, 16, 3, 1),    # the stem: K = 9 * 4 = 36, padded with zero codes to 40
    (1, 12, 20, 3, 3, 1),     # 9 rows (below _int_mm's 17) and N = 20 (not a multiple of 8)
    (2, 640, 1280, 16, 1, 1),  # a shortcut
])
def test_int8_conv_matches_its_plain_version_on_card(b, cin, cout, side, k, stride):
    """The int8 product (torch._int_mm over the im2col) gives the int32
    sums of its float64 plain version exactly, and QConvInt8 on the card
    gives the CPU's bits."""
    from pea_diffusion_tpu_torch.quant.int8 import QConvInt8, int8_conv, int8_conv_plain

    dev = _card()
    g = torch.Generator().manual_seed(b * cin + k)
    xq = torch.randint(-127, 128, (b, cin, side, side), generator=g, dtype=torch.int8)
    kq = torch.randint(-127, 128, (cout, cin, k, k), generator=g, dtype=torch.int8)
    for layout in (torch.contiguous_format, torch.channels_last):
        x = xq.to(dev).contiguous(memory_format=layout)
        got = int8_conv(x, kq.to(dev), (stride, stride))
        want = int8_conv_plain(x, kq.to(dev), (stride, stride))
        assert got.dtype == torch.int32 and torch.equal(got.double(), want)
        assert torch.equal(got.cpu(), int8_conv(xq, kq, (stride, stride)))
    conv = QConvInt8(cin, cout, k, stride)
    with torch.no_grad():
        conv.kernel_q.copy_(kq)
        conv.w_scale.copy_(torch.rand(cout, generator=g) * 1e-3 + 1e-4)
        conv.x_scale.fill_(0.02)
        conv.bias.copy_(torch.randn(cout, generator=g))
    xf = torch.randn(b, cin, side, side, generator=g)
    want = conv(xf)
    got = conv.to(dev)(xf.to(dev))
    assert torch.equal(got.cpu(), want)
