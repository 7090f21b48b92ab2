"""The port's int8 post-training quantization (pea_diffusion_tpu_torch/quant)
against the JAX package's (pea_diffusion_tpu/quant), on the tiny SDXL stack
at the same weights, fp32 on the CPU.

Tolerances: the weight codes and scales bit-equal (the same fp32 division
and round-half-to-even); QConvInt8 within 1e-5 relative L2 (the int32 sums
are exact on both sides; a code could flip at an exact .5 only if XLA
rewrote x / x_scale as a product, and the dequantize may fuse into one FMA
in XLA); the int8 product against its float64 plain version bit-equal;
calibration ranges within 1e-5 relative with the same keys; the quantized
state dicts bit-equal to the JAX trees carried across; the int8 UNet and VAE
decoder within the JAX package's own bounds against float, and against the
JAX package's at the same quantized tree within twice what a 1e-6 nudge of
the input does to them (see the UNet test); per-conv SQNR within 0.01 dB;
the ranges files interchangeable both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import one_torch_thread, t, tiny_sdxl_pair  # noqa: F401
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.models.unet import UNet2DCondition as JaxUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JaxVAE
from pea_diffusion_tpu.pipelines import text2image as jax_t2i
from pea_diffusion_tpu.quant import int8 as jq
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli.generate import make_tokenizer
from pea_diffusion_tpu_torch.configs import BERT_TINY, SDXL_UNET_TINY, VAE_TINY
from pea_diffusion_tpu_torch.models import UNet2DCondition
from pea_diffusion_tpu_torch.models.vae import AutoencoderKL
from pea_diffusion_tpu_torch.pipelines import generate_sdxl
from pea_diffusion_tpu_torch.quant import int8 as pq

FULL = frozenset({"resnet", "shortcut", "sampler", "stem"})
SCOPES = {"resnet": frozenset({"resnet"}), "full": FULL}
BOUND = {"resnet": 0.05, "full": 0.08}  # the JAX package's own int8-vs-float bounds
SIZE = 64


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def stack():
    """The tiny SDXL stack in both frameworks at the same weights, one UNet
    batch (CFG pair) and one VAE decoder batch."""
    jmodels, params, pmodels = tiny_sdxl_pair(JAX_UNET_TINY, SDXL_UNET_TINY)
    ucfg = SDXL_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    time_ids = np.tile(np.array([[128, 128, 0, 0, 128, 128]], np.float32), (2, 1))
    batch = (_rand(2, 16, 16, 4, seed=1), np.array([500, 10]),
             _rand(2, 12, ucfg.cross_attention_dim, seed=2),
             {"text_embeds": 0.5 * _rand(2, pooled, seed=3), "time_ids": time_ids})
    z = _rand(2, 8, 8, VAE_TINY.latent_channels, seed=4) / 0.13
    return jmodels, params, pmodels, batch, z


@pytest.fixture(scope="module")
def jax_ranges(stack):
    """The JAX package's calibration of the UNet batch over every UNet
    scope; a narrower scope's ranges are its subset."""
    jmodels, params, _, batch, _ = stack
    return jq.calibrate_conv_ranges(jmodels.unet, params["unet"], [_jax_args(batch)], FULL)


def _jax_args(batch):
    x, ts, ctx, added = batch
    return (jnp.asarray(x), jnp.asarray(ts, jnp.int32), jnp.asarray(ctx),
            {k: jnp.asarray(v) for k, v in added.items()})


def _port_args(batch):
    x, ts, ctx, added = batch
    return (t(x), torch.as_tensor(ts), t(ctx), {k: t(v) for k, v in added.items()})


def _nudged(args, seed=0):
    """The UNet's float inputs (latents, text states, pooled text) times
    1 + 1e-6 N(0, 1): a rounding-sized change."""
    g = torch.Generator().manual_seed(seed)

    def nudge(x):
        return x * (1 + 1e-6 * torch.randn(x.shape, generator=g))

    x, ts, ctx, added = args
    return (nudge(x), ts, nudge(ctx), dict(added, text_embeds=nudge(added["text_embeds"])))


def _assert_quantized_equal(got, want):
    """Two quantized state dicts: the same keys and bits, except that the
    JAX package's quantize_for_serving quantizes under jit, where XLA turns
    the division by 127 into a product: a channel's w_scale may then be one
    fp32 ulp off, and that channel's codes one step off where k / w_scale
    sat at a rounding edge."""
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        if key.endswith(".w_scale"):
            np.testing.assert_array_max_ulp(got[key].numpy(), v.numpy(), maxulp=1)
        elif key.endswith(".kernel_q"):
            same = got[key[:-len("kernel_q")] + "w_scale"] == want[key[:-len("kernel_q")] +
                                                                  "w_scale"]
            diff = (got[key].int() - v.int()).abs()
            assert int(diff[same].max()) == 0 and int(diff.max()) <= 1, key
        else:
            assert torch.equal(got[key], v), key


@pytest.mark.parametrize("spec", ["none", "", "int8", "int8:resnet,shortcut", "int8:stem,vae",
                                  "int8:resnet,,sampler", "int8:bogus", "fp8",
                                  "int8:resnet,attention"])
def test_parse_scopes_matches_jax(spec):
    try:
        want = jq.parse_scopes(spec)
    except AssertionError:
        with pytest.raises(ValueError):
            pq.parse_scopes(spec)
        return
    assert pq.parse_scopes(spec) == want


@pytest.mark.parametrize("shape", [(3, 3, 32, 64), (1, 1, 16, 8), (3, 3, 4, 32)])
def test_quantize_weight_bit_equal(shape):
    w = _rand(*shape, seed=sum(shape))
    w[..., 0] = 0.0  # an all-zero output channel takes the 1e-8 floor
    kq, ws = jq.quantize_weight(jnp.asarray(w))
    pkq, pws = pq.quantize_weight(t(w.transpose(3, 2, 0, 1)))
    assert pkq.dtype == torch.int8 and pws.dtype == torch.float32
    np.testing.assert_array_equal(pkq.numpy().transpose(2, 3, 1, 0), np.asarray(kq))
    np.testing.assert_array_equal(pws.numpy(), np.asarray(ws))


@pytest.mark.parametrize("k,stride,cin,cout", [(3, 1, 16, 24), (3, 2, 16, 24), (1, 1, 16, 8)])
def test_qconv_int8_matches_jax(k, stride, cin, cout):
    rng = np.random.default_rng(k * 10 + stride)
    kq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    leaves = {"kernel_q": kq, "w_scale": (rng.random(cout) * 1e-2 + 1e-3).astype(np.float32),
              "x_scale": np.float32(2.5 / 127), "bias": _rand(cout, seed=5)}
    x = _rand(2, 9, 9, cin, seed=6)
    want = jq.QConvInt8(cout, (k, k), (stride, stride)).apply(
        {"params": jax.tree.map(jnp.asarray, leaves)}, jnp.asarray(x))
    conv = pq.QConvInt8(cin, cout, k, stride)
    from pea_diffusion_tpu_torch.checkpoints.from_jax import _Writer

    w = _Writer()
    w.conv("c", leaves)
    conv.load_state_dict({n[2:]: v for n, v in w.sd.items()})
    got = conv(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("b,cin,cout,side,k,stride", [
    (2, 16, 24, 9, 3, 1), (2, 16, 24, 9, 3, 2), (1, 4, 32, 8, 3, 1), (1, 12, 20, 3, 3, 1),
    (2, 16, 8, 6, 1, 1)])
def test_int8_product_is_its_plain_version(b, cin, cout, side, k, stride):
    """torch._int_mm over the im2col gives the float64 plain version's sums
    exactly: the stem's K = 36, fewer than 17 rows, N not a multiple of 8,
    both memory formats."""
    g = torch.Generator().manual_seed(cin * side + k)
    xq = torch.randint(-127, 128, (b, cin, side, side), generator=g, dtype=torch.int8)
    kq = torch.randint(-127, 128, (cout, cin, k, k), generator=g, dtype=torch.int8)
    want = pq.int8_conv_plain(xq, kq, (stride, stride))
    for x in (xq, xq.contiguous(memory_format=torch.channels_last)):
        got = pq.int8_conv(x, kq, (stride, stride))
        assert got.dtype == torch.int32 and torch.equal(got.double(), want)


@pytest.mark.parametrize("scope", ["resnet", "full"])
def test_calibration_and_int8_unet_match_jax(stack, jax_ranges, scope):
    """The same batch through both calibrations (the same keys, values
    within 1e-5), then the JAX package's quantized tree carried across:
    the port's own quantize_unet_params gives it bit for bit, and both int8
    UNets stay within the JAX bounds against float. The two int8 UNets
    cannot agree within 1e-4: the float paths into each quantize differ by
    ~1.5e-6 between the frameworks, which flips a few activation codes, and
    each flip re-draws the quantization noise downstream (a 1e-6 relative
    nudge of the input moves the port's own int8 UNet by ~1.1e-2 here). So
    they must differ by no more than twice what that nudge does."""
    _, params, pmodels, batch, _ = stack
    scopes = SCOPES[scope]
    ranges = {k: v for k, v in jax_ranges.items()
              if jq._is_target_conv(tuple(k.split("/")), scopes)}
    got = pq.calibrate_conv_ranges(pmodels.unet, [_port_args(batch)], scopes)
    assert sorted(got) == sorted(ranges)
    for key, v in ranges.items():
        assert abs(got[key] - v) <= 1e-5 * v, key
    if scope == "full":
        assert "conv_in" in got and any("downsample/conv" in k for k in got)

    qtree = jq.quantize_unet_params(params["unet"], ranges, scopes=scopes)
    carried = from_jax.unet_state_dict(qtree, SDXL_UNET_TINY)
    mine = pq.quantize_unet_params(pmodels.unet.state_dict(), ranges, scopes=scopes)
    assert sorted(mine) == sorted(carried)
    for key, v in carried.items():
        assert torch.equal(mine[key], v), key
    quant = "int8:" + ",".join(sorted(scopes))
    qunet = UNet2DCondition(SDXL_UNET_TINY, conv_quant=quant).eval()
    qunet.load_state_dict(carried)
    jq_unet = JaxUNet(JAX_UNET_TINY, conv_quant=quant)
    want = np.asarray(jax.jit(jq_unet.apply)(qtree, *_jax_args(batch)))
    args = _port_args(batch)
    with torch.inference_mode():
        out = qunet(*args).numpy()
        ref = pmodels.unet(*args).numpy()
        chaos = _rel(qunet(*_nudged(args)).numpy(), out)
    assert _rel(out, want) <= 2 * chaos
    for q in (out, want):
        assert 1e-6 < _rel(q, ref) < BOUND[scope]


def test_vae_decoder_quant_matches_jax(stack):
    jmodels, params, pmodels, _, z = stack
    jvae = JaxVAE(JAX_VAE_TINY)
    ranges = jq.calibrate_vae_decoder(jvae, params["vae"], [jnp.asarray(z)])
    got = pq.calibrate_vae_decoder(pmodels.vae, [t(z)])
    assert sorted(got) == sorted(ranges)
    assert all(abs(got[k] - v) <= 1e-5 * v for k, v in ranges.items())
    assert not any("conv_in" in k or "conv_out" in k for k in got)
    assert any("upsample" in k for k in got) and any(k.endswith("/conv_shortcut") for k in got)

    qtree = jq.quantize_vae_decoder_params(params["vae"], ranges)
    carried = from_jax.vae_state_dict(qtree, VAE_TINY)
    mine = pq.quantize_vae_decoder_params(pmodels.vae.state_dict(), ranges)
    assert sorted(mine) == sorted(carried)
    assert all(torch.equal(mine[k], v) for k, v in carried.items())
    assert sum(v.dtype == torch.int8 for v in mine.values()) >= 6
    qvae = AutoencoderKL(VAE_TINY, pq.VAE_DECODER_CONV_QUANT).eval()
    qvae.load_state_dict(carried)
    jqvae = JaxVAE(JAX_VAE_TINY, conv_quant=jq.VAE_DECODER_CONV_QUANT)
    want = np.asarray(jqvae.apply(qtree, jnp.asarray(z), method=jqvae.decode))
    with torch.inference_mode():
        out = qvae.decode(t(z)).numpy()
        ref = pmodels.vae.decode(t(z)).numpy()
    assert _rel(out, want) <= 1e-4
    for q in (out, want):
        assert 1e-7 < _rel(q, ref) < 0.08


def test_per_conv_sqnr_matches_jax(stack, jax_ranges):
    """Within 0.01 dB, except at a conv where an activation code sits at a
    rounding edge: there a rounding-sized nudge of the inputs moves the
    port's own SQNR too (0.011 dB at one conv of this batch), and the bound
    is twice that move."""
    jmodels, params, pmodels, batch, _ = stack
    ranges = jax_ranges
    want = jq.per_conv_sqnr(jmodels.unet, params["unet"], [_jax_args(batch)], ranges, FULL)
    got = pq.per_conv_sqnr(pmodels.unet, [_port_args(batch)], ranges, FULL)
    nudged = pq.per_conv_sqnr(pmodels.unet, [_nudged(_port_args(batch))], ranges, FULL)
    assert sorted(got) == sorted(want)
    for key, v in want.items():  # 0.01 dB, or twice what a rounding-sized nudge moves it
        assert abs(got[key] - v) <= max(0.01, 2 * abs(nudged[key] - got[key])), (key, got[key], v)


def _jax_calibration_draws(jmodels, params, ids, uncond, size, seed=0):
    """The latents JAX's calibrate_sdxl draws (its key splits, in the
    adapter output's dtype)."""
    context, _ = jax_t2i.encode_prompt_sdxl(jmodels, params, ids, uncond)
    rng, out = jax.random.PRNGKey(seed), []
    for _ in range(5):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(
            k, (context.shape[0], size // 8, size // 8, 4), context.dtype)))
    return out


def _jax_vae_draws(size):
    return [np.asarray(jax.random.normal(jax.random.PRNGKey(s), (1, size // 8, size // 8, 4),
                                         jnp.float32)) for s in range(2)]


def test_quantize_for_serving_ranges_files_both_ways(stack, tmp_path):
    """A ranges file JAX's quantize_for_serving writes loads in the port
    (the port's quantized state then equals the JAX tree carried across),
    the port's calibration with JAX's draws writes the same ranges within
    1e-5, and a file the port writes loads in JAX, giving the same
    x_scales. The wide scope's vae:: keys too."""
    jmodels, params, pmodels, _, _ = stack
    tokenize = make_tokenizer(BERT_TINY.vocab_size, 16)
    ids, uncond = tokenize(["一只戴着帽子的可爱猫咪"]), tokenize([""])
    jids, juncond = jnp.asarray(ids, jnp.int32), jnp.asarray(uncond, jnp.int32)
    spec = "int8:resnet,shortcut,vae"
    jpath, ppath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jmq, jpq = jq.quantize_for_serving(jmodels, params, jids, juncond, SIZE, ranges_path=jpath,
                                       conv_quant=spec)
    assert jmq.unet.conv_quant == "int8:resnet,shortcut"

    loaded = pq.quantize_for_serving(pmodels, ids, uncond, SIZE, ranges_path=jpath,
                                     conv_quant=spec)
    assert loaded.unet.conv_quant == "int8:resnet,shortcut"
    assert loaded.vae.conv_quant == pq.VAE_DECODER_CONV_QUANT
    _assert_quantized_equal(loaded.unet.state_dict(),
                            from_jax.unet_state_dict(jpq["unet"], SDXL_UNET_TINY))
    _assert_quantized_equal(loaded.vae.state_dict(), from_jax.vae_state_dict(jpq["vae"], VAE_TINY))

    fresh = pq.quantize_for_serving(
        pmodels, ids, uncond, SIZE, ranges_path=ppath, conv_quant=spec,
        draws=_jax_calibration_draws(jmodels, params, jids, juncond, SIZE),
        vae_draws=_jax_vae_draws(SIZE))
    mine, theirs = pq.load_ranges(ppath), pq.load_ranges(jpath)
    assert sorted(mine) == sorted(theirs) and any(k.startswith("vae::") for k in mine)
    for key, v in theirs.items():
        assert abs(mine[key] - v) <= 1e-5 * v, key
    _, jpq2 = jq.quantize_for_serving(jmodels, params, jids, juncond, SIZE, ranges_path=ppath,
                                      conv_quant=spec)
    got = fresh.unet.state_dict()
    want = from_jax.unet_state_dict(jpq2["unet"], SDXL_UNET_TINY)
    scales = [k for k in want if k.endswith(".x_scale")]
    assert scales and all(torch.equal(got[k], want[k]) for k in scales)


def test_ranges_round_trip_and_stale_caches(stack, tmp_path):
    _, _, pmodels, _, _ = stack
    r = {"down_0_resnet_0/conv1": 3.25, "mid_resnet_0/conv2": 0.5, "vae::resnet_0/conv1": 1.5}
    p = str(tmp_path / "ranges.json")
    pq.save_ranges(p, r)
    assert pq.load_ranges(p) == r == jq.load_ranges(p)
    tokenize = make_tokenizer(BERT_TINY.vocab_size, 16)
    ids, uncond = tokenize(["一只猫"]), tokenize([""])
    only_vae = str(tmp_path / "vae_only.json")
    pq.save_ranges(only_vae, {"vae::resnet_0/conv1": 1.0})
    with pytest.raises(ValueError, match="no UNet conv ranges"):
        pq.quantize_for_serving(pmodels, ids, uncond, SIZE, ranges_path=only_vae)
    only_unet = str(tmp_path / "unet_only.json")
    pq.save_ranges(only_unet, {"down_0_resnet_0/conv1": 1.0})
    with pytest.raises(ValueError, match="no vae:: ranges"):
        pq.quantize_for_serving(pmodels, ids, uncond, SIZE, ranges_path=only_unet,
                                conv_quant="int8:resnet,vae")
    with pytest.raises(ValueError):
        pq.quantize_for_serving(pmodels, ids, uncond, SIZE, conv_quant="none")


def test_missing_ranges_warn_only_when_provided(stack, capsys):
    """ranges=None is silent; a provided dict, even an empty one, warns
    for every miss, with the JAX package's count."""
    _, params, pmodels, _, _ = stack
    sd = pmodels.unet.state_dict()
    pq.quantize_unet_params(sd, None, default_amax=4.0)
    assert "WARNING" not in capsys.readouterr().out
    pq.quantize_unet_params(sd, {})
    mine = capsys.readouterr().out
    jq.quantize_unet_params(params["unet"], {})
    theirs = capsys.readouterr().out
    assert "WARNING" in mine and mine.split(" in-scope")[0] == theirs.split(" in-scope")[0]
    qunet = UNet2DCondition(SDXL_UNET_TINY, conv_quant="int8").eval()
    qunet.load_state_dict(pq.quantize_unet_params(sd, None, default_amax=4.0))
    with torch.inference_mode():
        assert torch.isfinite(qunet(*_port_args(stack[3]))).all()


def test_generate_sdxl_decode_chunk(stack, monkeypatch):
    """decode_chunk=2 at batch 3 gives decode_chunk=0's bits (the GroupNorm
    form pinned, since it is picked by batch size), and stays within the
    tiny stack's image tolerance (2e-3) of JAX's split_decode=True,
    decode_chunk=2 from the same initial noise."""
    jmodels, params, pmodels, _, _ = stack
    monkeypatch.setenv("PEA_GN_GROUPED", "1")
    tokenize = make_tokenizer(BERT_TINY.vocab_size, 16)
    prompts = ["一只猫", "一条狗", "雪山"]
    ids, uncond = tokenize(prompts), tokenize([""] * 3)
    noise = _rand(3, SIZE // 8, SIZE // 8, 4, seed=9)
    common = dict(sampler_name="ddim", height=SIZE, width=SIZE, num_steps=2,
                  guidance_scale=7.5, init_noise=noise)
    whole = generate_sdxl(pmodels, ids, uncond, **common)
    chunked = generate_sdxl(pmodels, ids, uncond, split_decode=True, decode_chunk=2, **common)
    assert whole.shape[0] == 3 and torch.equal(whole, chunked)
    want = jax_t2i.generate_sdxl(
        jmodels, params, jnp.asarray(ids, jnp.int32), jnp.asarray(uncond, jnp.int32),
        jax.random.PRNGKey(0), split_decode=True, decode_chunk=2,
        **dict(common, init_noise=jnp.asarray(noise)))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=2e-3)


def test_jax_module_paths_name_every_conv():
    """Every conv of the port's UNet and VAE decoder maps to a JAX module
    path whose range key the JAX package's parameter tree has."""
    ucfg = SDXL_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    unet = UNet2DCondition(ucfg)
    jtree = jax.eval_shape(lambda: JaxUNet(JAX_UNET_TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.array([1]),
        jnp.zeros((1, 4, ucfg.cross_attention_dim)),
        {"text_embeds": jnp.zeros((1, pooled)), "time_ids": jnp.zeros((1, 6))}))["params"]
    dec = jax.eval_shape(lambda: JaxVAE(JAX_VAE_TINY).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
        jax.random.PRNGKey(1)))["params"]["decoder"]
    for root, tree, vae in ((unet, jtree, False), (AutoencoderKL(VAE_TINY).decoder, dec, True)):
        convs = [n for n, m in root.named_modules() if isinstance(m, torch.nn.Conv2d)
                 and "attentions" not in n]
        assert convs
        for name in convs:
            node = tree
            for part in pq.jax_module_path(name, vae):
                node = node[part]
            assert "kernel" in node, name
