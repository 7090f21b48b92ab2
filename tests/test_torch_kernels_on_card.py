"""The port's attention kernels (B1 one-pass, B3 flash forward, B4/B5 flash
backward) against their plain versions on a CUDA card, in the working types
bf16/fp16, at SDXL's head dim 64, SD1.5's 40 and 80, and 128. Forward: the max error must stay below 8e-3 of the largest
output, twice the most that rounding the output to bf16 (2^-8 of its size)
can move it. Backward: below 2e-2 of the largest gradient, per output (P
and dS are rounded to bf16 before their products, and dS is a difference of
rounded terms). The attention modules' input gradients through the kernels
must match the plain route's within 2e-2 too. The GroupNorm kernels (B6,
B6-b) are held to 8e-3 of their fp32 plain version in bf16, fp16 and fp32,
contiguous and channels-last, and must give the same bits on a second run.

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
@pytest.mark.parametrize("sq,skv_ctx,channels,heads", [
    (1024, None, 640, 10), (1024, 52, 640, 10), (1600, None, 640, 10),
    # SD1.5: 8 heads of 40 at level 0, 8 of 80 at level 1, all on B3
    (4096, None, 320, 8), (4096, 52, 320, 8), (1024, None, 640, 8), (1024, 77, 640, 8),
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
    """D = 160 (SD1.5's level 2 and mid block; it reaches the flash route
    only at 1024² and up) and any other width the kernels are not built for
    raise on a CUDA tensor, naming the width; nothing falls back."""
    dev = _card()
    for d in (160, 32, 96):
        x = torch.zeros(2, 128, d, device=dev, dtype=torch.bfloat16)
        lse = torch.zeros(2, 128, device=dev)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_forward(x, x, x)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_backward_dkdv(x, x, x, x, lse, lse, 0.1)
        with pytest.raises(ValueError, match=f"head_dim {d}"):
            flash_attention.flash_backward_dq(x, x, x, x, lse, lse, 0.1)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,groups,dtype,act,with_t", [
    ((2, 320, 128, 128), 32, torch.bfloat16, "silu", True),   # SDXL level 0 norm2
    ((2, 2560, 32, 32), 32, torch.bfloat16, "silu", False),   # up block level 2 norm1
    ((2, 1280, 32, 32), 32, torch.float16, "none", False),    # Transformer2D.norm
    ((1, 128, 256, 256), 32, torch.float32, "silu", False),   # fp32 VAE
    ((2, 960, 30, 30), 32, torch.bfloat16, "silu", True),     # ragged H*W, 30 per group
    ((1, 93, 17, 19), 3, torch.float16, "none", True),        # 31 per group, odd rows
])
@pytest.mark.parametrize("channels_last", [False, True])
def test_groupnorm_kernels_match_plain_on_card(shape, groups, dtype, act, with_t,
                                               channels_last):
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
    n6 = fn.launches
    out = (fn(x, t, scale, bias, groups, 1e-5, act) if with_t
           else fn(x, scale, bias, groups, 1e-5, act))
    again = (fn(x, t, scale, bias, groups, 1e-5, act) if with_t
             else fn(x, scale, bias, groups, 1e-5, act))
    torch.cuda.synchronize()
    assert fn.launches == n6 + 2
    ref = groupnorm.fused_gn_ref(x.float(), scale.float(), bias, groups, 1e-5, act,
                                 None if t is None else t.float())
    assert out.dtype == dtype and out.shape == x.shape
    assert out.is_contiguous(memory_format=torch.channels_last) == channels_last
    assert torch.equal(out, again)  # fixed summation order: the same bits every run
    assert _rel_err(out, ref) < RTOL


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
