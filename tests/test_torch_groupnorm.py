"""The port's fused GroupNorm (pea_diffusion_tpu_torch/ops/groupnorm.py) held
against the JAX package's, on the CPU: the plain version of B6 and B6-b
against the JAX ``fused_group_norm`` run in interpret mode (the Pallas
kernel's own arithmetic) and against its ``group_norm``, for act none and
silu, with and without the per-(sample, channel) bias t; the autograd
Functions' gradients in x, t, scale and bias against ``jax.vjp`` of the JAX
fused function; the route's table (PEA_FUSED_GROUPNORM unset, 0 and 1, with
and without an input that needs a gradient, on a CUDA tensor and a CPU
one), the GroupNorm module's route on a tensor that reads as a CUDA one
(which function it calls, the plain route's counter, the span's route
argument); the GroupNorm module with the opt-in on (the CPU never takes
the kernel); a channels-last input; and the
wrapper's layout, vector width and chunking rules and the persistent
variant's tile plan (every element in exactly one tile, the resident
decision against the shared-memory budget at every path shape), which the
CUDA kernels rely on and which this host can reach. The kernels themselves
run in tests/test_torch_kernels_on_card.py.

Tolerances: fp32 atol 2e-5 (as tests/test_fused_groupnorm.py holds the
Pallas kernel), gradients 3e-4; bf16 3e-2 (one bf16 rounding of outputs of
order 1, taken at other points in each framework).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import host_params, sub_state_dict, t
from pea_diffusion_tpu.models import layers as J
from pea_diffusion_tpu.ops import groupnorm as JG
from pea_diffusion_tpu_torch.models import layers as P
from pea_diffusion_tpu_torch.ops import groupnorm as G


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return t(x).permute(0, 3, 1, 2).contiguous()


def _inputs(shape, seed):
    n, _, _, c = shape
    x = _rand(*shape, seed=seed) * 2 + 1
    scale = 1 + 0.1 * _rand(c, seed=seed + 1)
    bias = 0.1 * _rand(c, seed=seed + 2)
    tb = _rand(n, c, seed=seed + 3)
    return x, scale, bias, tb


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8), ((3, 4, 6, 16), 4)])
@pytest.mark.parametrize("act", ["none", "silu"])
@pytest.mark.parametrize("with_t", [False, True])
def test_plain_version_matches_jax_kernel_and_group_norm(shape, groups, act, with_t):
    x, scale, bias, tb = _inputs(shape, seed=len(shape) + groups)
    tb = tb if with_t else None
    want = JG.fused_group_norm(jnp.asarray(x), scale, bias, groups, 1e-5, act=act,
                               extra_bias=None if tb is None else jnp.asarray(tb),
                               interpret=True)
    ref = JG._reference_gn(jnp.asarray(x), scale, bias, groups, 1e-5, act,
                           None if tb is None else jnp.asarray(tb))
    got = G.fused_gn_ref(_nchw(x), t(scale), t(bias), groups, 1e-5, act,
                         None if tb is None else t(tb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # the CPU path of each wrapper is the plain version
    fn = (G.group_norm_fwd(_nchw(x), t(scale), t(bias), groups, 1e-5, act) if tb is None
          else G.group_norm_bias_fwd(_nchw(x), t(tb), t(scale), t(bias), groups, 1e-5, act))
    np.testing.assert_array_equal(fn.permute(0, 2, 3, 1).numpy(), got.numpy())


@pytest.mark.parametrize("with_t", [False, True])
def test_plain_version_bf16_matches_jax(with_t):
    x, scale, bias, tb = _inputs((2, 4, 4, 32), seed=7)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = JG.fused_group_norm(xb, scale, bias, 8, 1e-5, act="silu",
                               extra_bias=jnp.asarray(tb) if with_t else None,
                               interpret=True)
    xt = _nchw(np.array(xb.astype(jnp.float32))).bfloat16()
    got = G.fused_gn_ref(xt, t(scale), t(bias), 8, 1e-5, "silu",
                         t(tb) if with_t else None)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("act,with_t", [("none", False), ("silu", False), ("silu", True),
                                        ("none", True)])
def test_function_gradients_match_jax(act, with_t):
    """x, t, scale, bias gradients through FusedGroupNorm / FusedGroupNormBias
    against jax.vjp of the JAX fused function (its custom VJP)."""
    x, scale, bias, tb = _inputs((2, 4, 4, 32), seed=11)
    g = _rand(2, 4, 4, 32, seed=12)
    if with_t:
        fn = lambda x, s, b, tb: JG.fused_group_norm(  # noqa: E731
            x, s, b, 8, 1e-5, act=act, extra_bias=tb, interpret=True)
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, scale, bias, tb)))
    else:
        fn = lambda x, s, b: JG.fused_group_norm(x, s, b, 8, 1e-5, act=act,  # noqa: E731
                                                 interpret=True)
        _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (x, scale, bias)))
    want = vjp(jnp.asarray(g))
    xs, ss, bs, ts = (v.requires_grad_(True) for v in (_nchw(x), t(scale), t(bias), t(tb)))
    y = G.fused_group_norm(xs, ss, bs, 8, 1e-5, act, ts if with_t else None)
    name = "FusedGroupNormBiasBackward" if with_t else "FusedGroupNormBackward"
    assert type(y.grad_fn).__name__ == name
    y.backward(_nchw(g))
    got = [xs.grad.permute(0, 2, 3, 1), ss.grad, bs.grad] + ([ts.grad] if with_t else [])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-4)


def test_function_returns_only_the_gradients_asked_for():
    x, scale, bias, tb = _inputs((1, 4, 4, 16), seed=13)
    xs = _nchw(x).requires_grad_(True)
    y = G.fused_group_norm(xs, t(scale), t(bias), 4, 1e-5, "silu", t(tb))
    y.sum().backward()
    assert xs.grad is not None and xs.grad.abs().max() > 0
    with torch.no_grad():  # no gradient needed: the bare wrapper, no history
        assert G.fused_group_norm(xs, t(scale), t(bias), 4).grad_fn is None


def test_function_backward_under_checkpointing():
    """KD training runs the frozen UNet under non-reentrant checkpointing,
    which lets a Function's backward unpack its saved tensors only once."""
    from torch.utils.checkpoint import checkpoint

    x, scale, bias, tb = _inputs((2, 4, 4, 16), seed=17)
    xs = _nchw(x).requires_grad_(True)

    def f(v):
        return G.fused_group_norm(v * 1.5, t(scale), t(bias), 4, 1e-5, "silu", t(tb))

    checkpoint(f, xs, use_reentrant=False).square().sum().backward()
    ref_x = _nchw(x).requires_grad_(True)
    G.fused_gn_ref(ref_x * 1.5, t(scale), t(bias), 4, 1e-5, "silu", t(tb)).square().sum().backward()
    np.testing.assert_allclose(xs.grad.numpy(), ref_x.grad.numpy(), atol=1e-5)


def _fake(ndim=4, channels=32, cuda=True, grad=False):
    return SimpleNamespace(ndim=ndim, shape=(2, channels, 8, 8)[:ndim] + (8,) * (ndim - 4),
                           is_cuda=cuda, requires_grad=grad)


@pytest.mark.parametrize("env,x,groups,want", [
    (None, _fake(), 8, True),                  # unset: the kernel, as no input needs a gradient
    ("0", _fake(), 8, False),                  # the plain form everywhere
    ("true", _fake(), 8, True),                # any value but 0 and 1 reads as unset
    ("1", _fake(), 8, True),                   # a 4-d CUDA tensor, 32 = 8 groups of 4
    ("1", _fake(ndim=3), 8, False),            # not 4-d
    ("1", _fake(channels=30), 8, False),       # channels not divisible by groups
    ("1", _fake(channels=960), 32, True),      # no 128-lane rule (960 % 128 != 0)
    ("1", _fake(cuda=False), 8, False),        # a CPU tensor: the plain version
])
def test_gate_table(monkeypatch, env, x, groups, want):
    if env is None:
        monkeypatch.delenv("PEA_FUSED_GROUPNORM", raising=False)
    else:
        monkeypatch.setenv("PEA_FUSED_GROUPNORM", env)
    assert G.fused_gn_applicable(x, groups) is want


def test_gate_reads_the_environment_at_call_time(monkeypatch):
    x = _fake()
    monkeypatch.setenv("PEA_FUSED_GROUPNORM", "1")
    assert G.fused_gn_applicable(x, 8)
    monkeypatch.setenv("PEA_FUSED_GROUPNORM", "0")
    assert not G.fused_gn_applicable(x, 8)


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("grad_on", [None, "x", "weight", "t"])
@pytest.mark.parametrize("cuda", [True, False])
def test_route_table(monkeypatch, env, grad_on, cuda):
    """A CUDA tensor takes the kernels unless PEA_FUSED_GROUPNORM=0, and,
    unset, only where no input (x, weight, bias, t) needs a gradient; a CPU
    tensor never does."""
    if env is None:
        monkeypatch.delenv("PEA_FUSED_GROUPNORM", raising=False)
    else:
        monkeypatch.setenv("PEA_FUSED_GROUPNORM", env)
    x = _fake(cuda=cuda, grad=grad_on == "x")
    inputs = [torch.ones(32, requires_grad=grad_on == "weight"), torch.zeros(32),
              torch.zeros(2, 32, requires_grad=grad_on == "t")]
    want = cuda and env != "0" and (env == "1" or grad_on is None)
    assert G.fused_gn_applicable(x, 8, *inputs) is want
    with torch.no_grad():  # nothing needs a gradient under no_grad
        assert G.fused_gn_applicable(x, 8, *inputs) is (cuda and env != "0")


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a CUDA one, to follow the module's route
    past the gate here."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("env", [None, "0", "1"])
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("with_t", [False, True])
def test_group_norm_module_route_counter_and_span(monkeypatch, env, grad, with_t):
    """The module launches B6 / B6-b (here stand-ins that count) where the
    route says so, through FusedGroupNorm(Bias) when an input needs a
    gradient, and otherwise calls the plain route, which counts its CUDA
    calls in group_norm_act.cuda_calls; either way one groupnorm span whose
    argument names the route. Values match the plain version."""
    if env is None:
        monkeypatch.delenv("PEA_FUSED_GROUPNORM", raising=False)
    else:
        monkeypatch.setenv("PEA_FUSED_GROUPNORM", env)
    launched = []

    def stand_in(name):
        def run(x, *args):
            launched.append(name)
            t_ = args[0] if name == "B6-b" else None
            rest = args[1:] if name == "B6-b" else args
            return G.fused_gn_ref(x, *rest, extra_bias=t_)
        return run

    monkeypatch.setattr(G, "group_norm_fwd", stand_in("B6"))
    monkeypatch.setattr(G, "group_norm_bias_fwd", stand_in("B6-b"))
    spans = []
    real_span = P.span
    monkeypatch.setattr(P, "span", lambda name, args=None: spans.append((name, args))
                        or real_span(name, args))
    x_np, tb_np = _rand(2, 4, 4, 32, seed=7), _rand(2, 32, seed=8)
    x = _nchw(x_np).as_subclass(_OnCard).requires_grad_(grad)
    tb = t(tb_np).as_subclass(_OnCard) if with_t else None
    norm = P.GroupNorm(32, 8, 1e-5, act="silu")
    norm.requires_grad_(False)
    plain = G.group_norm_act.cuda_calls
    out = norm(x, tb)
    kernel = env != "0" and (env == "1" or not grad)
    assert launched == ([("B6-b" if with_t else "B6")] if kernel else [])
    assert G.group_norm_act.cuda_calls == plain + (not kernel)
    assert spans == [("groupnorm", "kernel" if kernel else "plain")]
    assert out.requires_grad == grad
    want = G.fused_gn_ref(_nchw(x_np), norm.weight, norm.bias, 8, 1e-5, "silu",
                          t(tb_np) if with_t else None)
    np.testing.assert_allclose(out.detach().numpy(), want.numpy(), atol=1e-5)


def test_plain_route_counts_only_cuda_calls():
    x, scale, bias, tb = _inputs((2, 4, 4, 16), seed=9)
    calls = G.group_norm_act.cuda_calls
    G.group_norm_act(_nchw(x), t(scale), t(bias), 4, 1e-5, "silu", t(tb))
    assert G.group_norm_act.cuda_calls == calls
    G.group_norm_act(_nchw(x).as_subclass(_OnCard), t(scale), t(bias), 4, 1e-5)
    assert G.group_norm_act.cuda_calls == calls + 1


@pytest.mark.parametrize("act,with_t", [("silu", True), ("none", False)])
def test_group_norm_module_with_opt_in_matches_jax(monkeypatch, act, with_t):
    """With PEA_FUSED_GROUPNORM=1 the CPU keeps the plain path, and the
    module agrees with the JAX module (whose gate needs a TPU)."""
    monkeypatch.setenv("PEA_FUSED_GROUPNORM", "1")
    x, tb = _rand(2, 4, 4, 32), _rand(2, 32, seed=1)
    jm = J.GroupNorm(8, 1e-5, act=act)
    params = host_params(jm, x, tb if with_t else None)
    pm = P.GroupNorm(32, 8, 1e-5, act=act)
    pm.load_state_dict(sub_state_dict("norm", params["params"]), strict=True)
    got = pm(_nchw(x), t(tb) if with_t else None).permute(0, 2, 3, 1)
    want = jm.apply(params, x, extra_bias=tb if with_t else None)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("batch", [2, 3])
def test_plain_version_takes_channels_last(batch):
    """Transformer2D hands on channels-last tensors: the plain version gives
    the same values for either layout, in the input's shape."""
    x, scale, bias, tb = _inputs((batch, 6, 5, 16), seed=21)
    dense = _nchw(x)
    cl = dense.contiguous(memory_format=torch.channels_last)
    assert G.layout(dense) == "nchw" and G.layout(cl) == "nhwc"
    assert G.layout(dense[:, :, :, 1:]) == "strided"
    for tb_ in (None, t(tb)):
        a = G.fused_gn_ref(dense, t(scale), t(bias), 4, 1e-5, "silu", tb_)
        b = G.fused_gn_ref(cl, t(scale), t(bias), 4, 1e-5, "silu", tb_)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)


@pytest.mark.parametrize("row,size,ptr,want", [
    (16384, 2, 0, 8),      # SDXL level 0 H*W, bf16
    (900, 2, 0, 4),        # 30x30: not a multiple of 8
    (30, 2, 0, 2),         # channels-last row of 30 channels
    (31, 2, 0, 1),
    (960, 4, 0, 4),        # fp32: at most 16 bytes
    (1024, 2, 4, 2),       # a view 4 bytes past an aligned address
])
def test_vector_width(row, size, ptr, want):
    assert G.vector_width(row, size, ptr) == want


@pytest.mark.parametrize("c,cg,size,ptr,want", [
    (320, 10, 2, 0, 8),     # SDXL level 0: 16 bytes, a vector over two groups
    (640, 20, 2, 0, 8),
    (1280, 40, 2, 0, 8),    # 8 divides 40: one group a vector
    (128, 4, 4, 0, 4),      # fp32 VAE: 16 bytes
    (96, 3, 2, 0, 4),       # 3 a group: at most 4 elements span two groups
    (64, 1, 2, 0, 2),       # 1 a group
    (320, 10, 2, 4, 2),     # a view 4 bytes past an aligned address
])
def test_nhwc_vector_width(c, cg, size, ptr, want):
    got = G.nhwc_vector_width(c, cg, size, ptr)
    assert got == want and c % got == 0 and got - 1 <= cg


@pytest.mark.parametrize("n,c,hw,groups,nhwc,vec", [
    (2, 320, 128 * 128, 32, False, 8),
    (2, 1280, 32 * 32, 32, False, 8),
    (1, 128, 1024 * 1024, 32, False, 8),
    (2, 2560, 32 * 32, 32, True, 8),
    (2, 960, 64 * 64, 32, True, 8),
    (1, 30, 7, 3, True, 2),
    (2, 64, 9, 32, False, 1),
])
def test_chunk_plan_covers_the_map(n, c, hw, groups, nhwc, vec):
    """Every chunk count is at least 1, cuts no more finely than 4 vectors a
    thread, and fills the card for the large maps."""
    chunks = G.plan(n, c, hw, groups, nhwc, vec)
    blocks = n * chunks * (1 if nhwc else groups)
    assert chunks >= 1
    if nhwc:
        assert chunks <= max(1, hw)
    else:
        per_group = c // groups * hw // vec
        assert chunks <= max(1, -(-per_group // G.THREADS))
    if n * c * hw >= 2**24:
        assert blocks >= G.TARGET_BLOCKS


def _coverage(n, c, hw, groups, nhwc, vec, elem_size, blocks):
    """How often the persistent plan's tiles, block by block, cover each
    element of an [N, C, H*W] map (in its memory order), checking that each
    block takes at most per_block tiles, a segment's blocks are consecutive
    and no block before the last busy one is empty."""
    p = G.persistent_plan(n, c, hw, groups, nhwc, vec, elem_size, blocks)
    counts = np.zeros(n * c * hw, np.int32)
    owners = {}
    busy = [b for b in range(blocks) if G.plan_tiles(p, b)]
    assert busy == list(range(len(busy)))
    for b in busy:
        tiles = G.plan_tiles(p, b)
        assert len(tiles) <= p.per_block
        for seg, r0, rows in tiles:
            owners.setdefault(seg, set()).add(b)
            start = (seg * p.seg_rows + r0) * p.width
            counts[start:start + rows * p.width] += 1
    for blks in owners.values():
        assert sorted(blks) == list(range(min(blks), max(blks) + 1))
    return p, counts


@pytest.mark.parametrize("n,c,hw,groups,vec,elem_size,blocks", [
    (2, 64, 96, 8, 8, 2, 132),     # fewer tiles than blocks
    (3, 32, 50, 4, 8, 2, 4),       # segments shared between blocks
    (5, 12, 7, 3, 4, 2, 2),        # more samples than blocks
    (1, 93, 323, 3, 1, 2, 7),      # 31 channels per group, ragged rows
    (2, 96, 900, 32, 1, 2, 16),    # 3 per group: 1-element vectors
    (1, 16, 4096, 4, 4, 4, 3),     # fp32, many tiles a block
    (16, 320, 64, 32, 8, 2, 132),  # 10 channels a group: vectors span two groups
    (5, 60, 33, 3, 4, 2, 16),      # 20 a group, ragged rows
])
@pytest.mark.parametrize("nhwc", [True, False])
def test_persistent_plan_covers_every_element_once(n, c, hw, groups, vec, elem_size,
                                                   blocks, nhwc):
    if not nhwc:
        vec = G.vector_width(hw, elem_size, 0)
    p, counts = _coverage(n, c, hw, groups, nhwc, vec, elem_size, blocks)
    assert (counts == 1).all()
    if nhwc:  # a row is one pixel's C channels; a vector spans at most two groups
        assert (p.segs, p.seg_rows, p.width) == (n, hw, c) and vec - 1 <= c // groups
    else:  # a row lies in one channel of a (sample, group) slab
        assert p.segs == n * groups and hw % p.width == 0 and p.width % vec == 0


def test_persistent_plan_at_every_path_shape():
    """At each GroupNorm shape of the SDXL ControlNet path (and the smoke's
    check shapes) and of the main paths (tools/sweep_groupnorm.py: the SDXL
    UNet at CFG batch 16, the SD1.5 teacher at batch 40, the fp32 VAE
    decoder and encoder), on the H100's 132 SMs, both layouts: each
    segment's rows covered once, the ring within the shared-memory budget,
    and the map resident (every block's tiles in its slots) exactly when
    they fit: the maps up to about 132 x TILE_BUDGET bytes."""
    import chip_smoke

    from pea_diffusion_tpu_torch.tools import sweep_groupnorm

    sms = 132
    seen = {}
    cases = [(b, c, h, w, groups, dtype)
             for _, b, c, h, w, groups, _, dtype, _, _ in chip_smoke.groupnorm_cases()]
    cases += [(b, c, h, w, groups, dtype) for _, _, b, c, groups, h, w, _, dtype, _
              in sweep_groupnorm.path_cases(list(sweep_groupnorm.PATHS))]
    for b, c, h, w, groups, dtype in cases:
        size = torch.empty((), dtype=dtype).element_size()
        for nhwc in (True, False):
            vec = (G.nhwc_vector_width(c, c // groups, size, 0) if nhwc
                   else G.vector_width(h * w, size, 0))
            p = G.persistent_plan(b, c, h * w, groups, nhwc, vec, size, sms)
            rows = {}
            for blk in range(sms):
                for seg, r0, n_rows in G.plan_tiles(p, blk):
                    rows.setdefault(seg, []).append((r0, n_rows))
            assert sorted(rows) == list(range(p.segs))
            for spans in rows.values():
                assert sum(n_rows for _, n_rows in spans) == p.seg_rows
                assert all(r0 == prev + n for (prev, n), (r0, _) in zip(spans, spans[1:]))
            assert 1 <= p.slots <= G.MAX_SLOTS and p.smem <= G.SMEM_MAX
            assert p.tile_rows * p.width * size <= p.slot_bytes <= G.TILE_BUDGET
            fits = p.per_block * p.slot_bytes <= G.TILE_BUDGET and p.per_block <= G.MAX_SLOTS
            assert p.resident == fits
            assert p.slots == min(p.per_block, G.MAX_SLOTS, G.TILE_BUDGET // p.slot_bytes)
            nbytes = b * c * h * w * size
            if nbytes * 1.1 <= sms * G.TILE_BUDGET:
                assert p.resident, (b, c, h, w, nhwc)
            if nbytes > sms * G.TILE_BUDGET:
                assert not p.resident, (b, c, h, w, nhwc)
            if nhwc:
                seen[b, c, h, size] = p.resident
    # the maps the paths keep on chip, and those they read twice (bf16: 2
    # bytes an element; the fp32 VAE's 4)
    assert seen[2, 1280, 64, 2] and seen[2, 320, 128, 2] and seen[1, 512, 128, 2]
    assert seen[2, 2560, 32, 2] and seen[2, 960, 64, 2] and seen[2, 512, 64, 4]
    assert seen[16, 640, 32, 2] and seen[40, 1280, 16, 2] and seen[40, 2560, 8, 2]
    assert not (seen[2, 1920, 64, 2] or seen[2, 640, 128, 2] or seen[2, 960, 128, 2]
                or seen[1, 512, 256, 2] or seen[1, 128, 1024, 2] or seen[16, 1280, 32, 2]
                or seen[40, 320, 64, 2] or seen[1, 512, 128, 4] or seen[2, 128, 512, 4])


def test_sweep_walk_counts_the_groupnorms_a_forward_calls():
    """tools/sweep_groupnorm.py's walk of the GroupNorm modules (channels,
    groups, spatial side, B6 or B6-b, act) gives what hooks on the modules
    see in one forward of the tiny SD1.5 UNet and VAE encoder (the
    ControlNet path's walk is held in tests/test_torch_controlnet.py)."""
    from collections import Counter

    from pea_diffusion_tpu_torch.configs.unet import SD15_UNET_TINY, VAE_TINY
    from pea_diffusion_tpu_torch.models import AutoencoderKL, UNet2DCondition
    from pea_diffusion_tpu_torch.tools import sweep_groupnorm

    seen = Counter()

    def hook(mod, args, kwargs):
        x = args[0]
        kern = "B6-b" if kwargs.get("extra_bias") is not None else "B6"
        seen[kern, x.shape[0], x.shape[1], mod.num_groups, x.shape[2], mod.act] += 1

    torch.manual_seed(0)
    unet, encoder = UNet2DCondition(SD15_UNET_TINY), AutoencoderKL(VAE_TINY).encoder
    for m in (unet, encoder):
        for norm in m.modules():
            if isinstance(norm, P.GroupNorm):
                norm.register_forward_pre_hook(hook, with_kwargs=True)
    with torch.no_grad():
        unet(torch.zeros(2, 8, 8, 4), torch.tensor([1, 2]),
             torch.zeros(2, 5, SD15_UNET_TINY.cross_attention_dim))
        encoder(torch.zeros(1, 3, 16, 16))
    assert seen == (sweep_groupnorm.groupnorm_calls(unet, 8, 2)
                    + sweep_groupnorm.groupnorm_calls(encoder, 16, 1))


@pytest.mark.parametrize("hw,vec,want", [
    (16384, 8, 4096),   # at most 512 vectors a row
    (900, 4, 900),
    (323, 1, 323),
    (1024 * 1024, 8, 4096),
    (2 * 1031, 2, 2),   # H*W itself would be 1031 vectors: rows of one vector
])
def test_row_width(hw, vec, want):
    got = G.row_width(hw, vec)
    assert hw % got == 0 and got % vec == 0 and got // vec <= G.P_THREADS
    assert got == want


def test_persistent_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="groups"):
        G.persistent_plan(1, 2048, 64, 2048, True, 1, 2, 132)  # over 1024 groups
    with pytest.raises(ValueError, match="rows of"):
        G.persistent_plan(1, 1024, 64, 4, True, 1, 2, 132)  # 1024 vectors a row
    with pytest.raises(ValueError, match="channels per group"):
        G.persistent_plan(1, 2048, 64, 1, False, 8, 2, 132)  # contiguous, 2048 a group


@pytest.mark.parametrize("variant", G.GN_VARIANTS)
@pytest.mark.parametrize("with_t", [False, True])
def test_variant_wrapper_on_cpu_is_the_plain_version(variant, with_t):
    x, scale, bias, tb = _inputs((2, 4, 4, 16), seed=31)
    args = (_nchw(x), t(scale), t(bias), 4, 1e-5, "silu")
    got = G.group_norm_variant(*args, t=t(tb) if with_t else None, variant=variant)
    want = G.fused_gn_ref(*args, extra_bias=t(tb) if with_t else None)
    assert torch.equal(got, want)
    assert G.group_norm_variant.launches == dict.fromkeys(G.GN_VARIANTS, 0)
    with pytest.raises(ValueError, match="one of"):
        G.group_norm_variant(*args, variant="two_pass")


def test_variant_names_match_the_cuda_table():
    """The wrapper's variant names are the C table's (kGnVariants), in its
    order, and its persistent constants are the kernel's."""
    import re
    from pathlib import Path

    csrc = Path(G.__file__).resolve().parent.parent / "csrc"
    table = re.search(r"kGnVariants\[\] = \{([^}]*)\}", (csrc / "groupnorm.cu").read_text())
    assert tuple(re.findall(r'"(\w+)"', table.group(1))) == G.GN_VARIANTS
    src = (csrc / "groupnorm_sm90.cu").read_text()
    for name, value in (("kPThreads", G.P_THREADS), ("kRedFloats", G.RED_FLOATS),
                        ("kMaxSlots", G.MAX_SLOTS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "constexpr int kPersistentSmem = 227 * 1024;" in src and G.SMEM_MAX == 227 * 1024


def test_bare_wrappers_on_cpu_are_differentiable_plain_versions():
    x, scale, bias, tb = _inputs((2, 4, 4, 16), seed=3)
    xs = _nchw(x).requires_grad_(True)
    G.group_norm_bias_fwd(xs, t(tb), t(scale), t(bias), 4, 1e-5, "silu").sum().backward()
    assert xs.grad is not None
    assert G.group_norm_fwd.launches == 0 and G.group_norm_bias_fwd.launches == 0
