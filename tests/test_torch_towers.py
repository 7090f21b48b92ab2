"""The port's student text towers held against the JAX package's, in fp32 on
the CPU, at the same weights (carried over by checkpoints/from_jax.py): the
mT5 encoder (T5_TINY, ids with pads) and its bucket table, the BERT tower at
tiny XLM-R settings (pad id 1, one token type, RoBERTa positions over a
padded tail) and tiny AltCLIP settings (the pre_LN + transformation head),
`make_text_encoder_fn` for all five families, the mul_zh concat's length
check, the tiny SDXL `generate_sdxl` with mul_zh dict ids on the same
initial noise, and `kd_loss` with mul_zh's dual ids on the same draws.

Each tower's state dict also goes back through the JAX package's own
`convert_*` and must give the original JAX tree exactly.

Tolerances: exact for configs, the bucket table and the bf16 T5 norm
(rounding the normalized value before the scale, as transformers does,
moves about a quarter of the elements of that test by a bf16 step); atol
1e-4 through a tower (fp32 sums in another order in each framework); 2e-4
on the images of the whole tiny
pipeline; 1e-5 on the KD losses and 1e-4 on the adapter gradients, as
tests/test_torch_train.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dirs as dirs
from _torch_parity import assert_tree_equal, host_params, one_torch_thread, t  # noqa: F401
from _torch_parity import to_numpy_sd
from pea_diffusion_tpu.checkpoints.torch_convert import convert_bert_text, convert_t5_encoder
from pea_diffusion_tpu.configs import text_encoder as jax_text_cfg
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import CLIPTextConfig as JCLIPTextConfig
from pea_diffusion_tpu.configs.train import TrainConfig as JTrainConfig
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as J_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as J_VAE_TINY
from pea_diffusion_tpu.models import mt5 as jax_mt5
from pea_diffusion_tpu.models.adapter import PEAAdapter as JPEAAdapter
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JBert
from pea_diffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from pea_diffusion_tpu.models.unet import UNet2DCondition as JUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JVAE
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu.pipelines import text2image as jax_t2i
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as J_SDXL_SCHEDULE
from pea_diffusion_tpu.train import kd as jax_kd
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.configs import (SDXL_UNET_TINY, VAE_TINY, AdapterConfig,
                                             CLIPTextConfig, TrainConfig)
from pea_diffusion_tpu_torch.configs import text_encoder as port_text_cfg
from pea_diffusion_tpu_torch.models import mt5
from pea_diffusion_tpu_torch.models import BertTextEncoder, ConcatTextEncoder, T5Encoder
from pea_diffusion_tpu_torch.pipelines import build_models, generate_sdxl, ids_batch_size
from pea_diffusion_tpu_torch.pipelines.factory import (build_kd_models, make_text_encoder_fn,
                                                       with_text_tower)
from pea_diffusion_tpu_torch.train import kd

# Tiny towers of each family's settings, the same in both packages.
TINY = {"bert": {}, "xlmr": dirs.XLMR_SETTINGS,
        "altclip": dict(dirs.XLMR_SETTINGS, project_dim=24)}


def _bert(pkg, kind):
    return dataclasses.replace(pkg.BERT_TINY, **TINY[kind])


def _text_cfgs(pkg, family):
    """The tiny tower config(s) of `family` from the configs module `pkg`."""
    return {"chinese_clip": _bert(pkg, "bert"), "mul_clip": _bert(pkg, "xlmr"),
            "alt_clip": _bert(pkg, "altclip"), "mt5": pkg.T5_TINY,
            "mul_zh": (_bert(pkg, "xlmr"), _bert(pkg, "bert"))}[family]


def _ids(pad, b=2, n=12, seed=0):
    """Ids inside the tiny vocab with a padded tail on the second row."""
    ids = np.random.default_rng(seed).integers(5, 1000, (b, n)).astype(np.int32)
    ids[-1, n - 4:] = pad
    return ids


def _close(got, want, atol=1e-4):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol)


@pytest.mark.parametrize("name", ["XLM_ROBERTA_LARGE", "ALT_CLIP_XLMR_L", "MT5_XL",
                                  "T5_TINY", "BERT_TINY", "CHINESE_CLIP_LARGE"])
def test_configs_are_copies_of_the_jax_presets(name):
    assert dataclasses.asdict(getattr(port_text_cfg, name)) == dataclasses.asdict(
        getattr(jax_text_cfg, name))


@pytest.mark.parametrize("buckets,distance", [(32, 128), (16, 32), (64, 256)])
def test_relative_position_bucket_is_jax_exactly(buckets, distance):
    rel = np.arange(-600, 601)
    want = jax_mt5.relative_position_bucket(rel, buckets, distance)
    got = mt5.relative_position_bucket(rel, buckets, distance)
    np.testing.assert_array_equal(got, want)
    table = np.arange(40)[None, :] - np.arange(40)[:, None]
    np.testing.assert_array_equal(mt5.relative_position_bucket(table, buckets, distance),
                                  jax_mt5.relative_position_bucket(table, buckets, distance))


def test_t5_encoder_matches_jax_and_its_names_are_transformers():
    ids = _ids(0)
    jm = jax_mt5.T5Encoder(jax_text_cfg.T5_TINY)
    params = host_params(jm, ids)
    pm = T5Encoder(port_text_cfg.T5_TINY)
    pm.load_state_dict(from_jax.t5_encoder_state_dict(params), strict=True)
    want = jm.apply(params, ids)
    _close(pm(torch.from_numpy(ids).long()), want)
    assert [k for k in pm.state_dict() if "relative_attention_bias" in k] == [
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    assert_tree_equal(convert_t5_encoder(to_numpy_sd(pm), 2), params)
    # the block-0 bias is cached per (T, device) and reused by every block
    attn = pm.encoder.block[0].layer[0].SelfAttention
    assert list(attn._buckets) == [(12, torch.device("cpu"))]


def test_t5_layer_norm_in_bf16_scales_before_the_cast():
    """bf16 input and scale: fp32 RMS, the upcast scale applied, then one
    cast back (the JAX order; transformers casts before the scale)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    x16, s16 = torch.from_numpy(x).bfloat16(), torch.from_numpy(scale).bfloat16()
    jn = jax_mt5.T5LayerNorm(1e-6)
    want = jn.apply({"params": {"scale": jnp.asarray(s16.float().numpy())}},
                    jnp.asarray(x16.float().numpy()).astype(jnp.bfloat16))
    norm = mt5.T5LayerNorm(64, 1e-6).bfloat16()
    norm.weight.data.copy_(s16)
    with torch.no_grad():
        got = norm(x16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["xlmr", "altclip"])
def test_bert_tower_at_xlmr_and_altclip_settings(kind):
    ids = _ids(1)
    jm = JBert(_bert(jax_text_cfg, kind))
    params = host_params(jm, ids)
    pm = BertTextEncoder(_bert(port_text_cfg, kind))
    pm.load_state_dict(from_jax.bert_text_state_dict(params), strict=True)
    want = jm.apply(params, ids)
    got = pm(torch.from_numpy(ids).long())
    _close(got.last_hidden_state, want.last_hidden_state)
    _close(got.pooled, want.pooled)
    if kind == "altclip":
        assert got.projected.shape == (2, 12, 24)
        _close(got.projected, want.projected)
    else:
        assert got.projected is None
        assert_tree_equal(convert_bert_text(to_numpy_sd(pm), 2), params)


def _family_params(family, enc, ids):
    if family == "mul_zh":
        return {"mul": host_params(enc[0], ids["mul"], seed=1),
                "zh": host_params(enc[1], ids["zh"], seed=2)}
    return host_params(enc, ids, seed=1)


def _family_state_dict(family, params):
    if family == "mul_zh":
        return from_jax.mul_zh_state_dict(params)
    if family == "mt5":
        return from_jax.t5_encoder_state_dict(params)
    return from_jax.bert_text_state_dict(params)


@pytest.mark.parametrize("family", ["chinese_clip", "mul_clip", "alt_clip", "mt5", "mul_zh"])
def test_make_text_encoder_fn_matches_jax(family):
    jcfg, pcfg = _text_cfgs(jax_text_cfg, family), _text_cfgs(port_text_cfg, family)
    if family == "mul_zh":
        ids = {"mul": _ids(1, seed=3), "zh": _ids(0, seed=4)}
    else:
        ids = _ids(0 if family in ("chinese_clip", "mt5") else 1)
    enc, jfn = jax_factory.make_text_encoder_fn(family, jcfg)
    params = _family_params(family, enc, ids)
    module, fn = make_text_encoder_fn(family, pcfg)
    module.load_state_dict(_family_state_dict(family, params), strict=True)
    want = jfn(params, ids)
    got = fn({k: torch.from_numpy(v).long() for k, v in ids.items()}
             if family == "mul_zh" else torch.from_numpy(ids).long())
    width = {"alt_clip": 24, "mul_zh": 128}.get(family, 64)
    assert got.shape == (2, 12, width) == want.shape
    _close(got, want)
    if family == "mul_zh":
        assert {k.split(".")[0] for k in module.state_dict()} == {"mul", "zh"}
        for tower in ("mul", "zh"):
            sd = {k[len(tower) + 1:]: v for k, v in to_numpy_sd(module).items()
                  if k.startswith(tower + ".")}
            assert_tree_equal(convert_bert_text(sd, 2), params[tower])


def test_an_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown text-encoder family"):
        make_text_encoder_fn("wukong", port_text_cfg.BERT_TINY)


def test_mul_zh_at_unequal_lengths_raises():
    enc = ConcatTextEncoder(port_text_cfg.BERT_TINY, port_text_cfg.BERT_TINY)
    ids = {"mul": torch.zeros((1, 8), dtype=torch.long),
           "zh": torch.zeros((1, 6), dtype=torch.long)}
    with pytest.raises(ValueError, match="same"):
        enc(ids)
    assert ids_batch_size(ids) == 1


def test_build_models_gives_the_t5_norms_unit_weights():
    """The factory fills every T5 RMS norm's weight with 1, as the JAX
    package's init_params_host fills a "scale" leaf with ones."""
    from pea_diffusion_tpu_torch.models.mt5 import T5LayerNorm

    m = build_models(family="mt5", text_cfg=port_text_cfg.T5_TINY,
                     adapter_cfg=AdapterConfig(64, (96, 64), head_dim=64),
                     unet_cfg=SDXL_UNET_TINY, vae_cfg=VAE_TINY, dtype=torch.float32,
                     device="cpu")
    norms = [n for n in m.text_encoder.modules() if isinstance(n, T5LayerNorm)]
    assert len(norms) == 2 * port_text_cfg.T5_TINY.num_layers + 1
    assert all(bool((n.weight == 1).all()) for n in norms)
    bias = m.text_encoder.encoder.block[0].layer[0].SelfAttention.relative_attention_bias
    assert 0.01 < float(bias.weight.std()) < 0.03


# --- the mul_zh slice: generate_sdxl with dict ids, kd_loss with dual ids -----

B, T, TT, IMG = 2, 12, 16, 32
POOLED = J_UNET_TINY.projection_class_embeddings_input_dim - 6 * J_UNET_TINY.addition_time_embed_dim


def _adapter_dims():
    return 2 * port_text_cfg.BERT_TINY.hidden_size, (96, POOLED)


def _unet_args():
    added = {"text_embeds": np.zeros((1, POOLED), np.float32),
             "time_ids": np.zeros((1, 6), np.float32)}
    return (np.zeros((1, 8, 8, 4), np.float32), np.array([500], np.int32),
            np.zeros((1, T, J_UNET_TINY.cross_attention_dim), np.float32), added)


def test_generate_sdxl_with_mul_zh_dict_ids_matches_jax():
    jcfg, pcfg = _text_cfgs(jax_text_cfg, "mul_zh"), _text_cfgs(port_text_cfg, "mul_zh")
    dims = _adapter_dims()
    jmodels = jax_factory.build_models(
        family="mul_zh", text_cfg=jcfg,
        adapter_cfg=JAdapterConfig(*dims, head_dim=J_UNET_TINY.cross_attention_dim),
        unet_cfg=J_UNET_TINY, vae_cfg=J_VAE_TINY, dtype=jnp.float32)
    enc, _ = jax_factory.make_text_encoder_fn("mul_zh", jcfg)
    ids = {"mul": _ids(1, b=1, seed=5), "zh": _ids(0, b=1, seed=6)}
    ids["mul"][0, 8:], ids["zh"][0, 9:] = 1, 0  # padded tails
    uncond = {"mul": np.full((1, T), 1, np.int32), "zh": np.full((1, T), 0, np.int32)}
    params = {
        "text": _family_params("mul_zh", enc, ids),
        "adapter": host_params(jmodels.adapter, np.zeros((1, T, dims[0]), np.float32),
                               seed=3),
        "unet": host_params(jmodels.unet, *_unet_args(), seed=4),
        "vae": host_params(jmodels.vae, np.zeros((1, 16, 16, 3), np.float32),
                           jax.random.PRNGKey(0), seed=5),
    }
    pmodels = build_models(family="mul_zh", text_cfg=pcfg,
                           adapter_cfg=AdapterConfig(*dims,
                                                     head_dim=SDXL_UNET_TINY.cross_attention_dim),
                           unet_cfg=SDXL_UNET_TINY, vae_cfg=VAE_TINY, dtype=torch.float32,
                           device="cpu")
    assert isinstance(pmodels.text_encoder, ConcatTextEncoder)
    pmodels.text_encoder.load_state_dict(from_jax.mul_zh_state_dict(params["text"]))
    pmodels.adapter.load_state_dict(from_jax.adapter_state_dict(params["adapter"]))
    pmodels.unet.load_state_dict(from_jax.unet_state_dict(params["unet"], SDXL_UNET_TINY))
    pmodels.vae.load_state_dict(from_jax.vae_state_dict(params["vae"], VAE_TINY))
    noise = np.random.default_rng(11).standard_normal((1, 8, 8, 4)).astype(np.float32)
    want = jax_t2i.generate_sdxl(
        jmodels, params, jax_t2i.as_ids(ids), jax_t2i.as_ids(uncond), jax.random.PRNGKey(0),
        sampler_name="ddim", height=64, width=64, num_steps=2, init_noise=jnp.asarray(noise))
    got = generate_sdxl(pmodels, ids, uncond, sampler_name="ddim", height=64, width=64,
                        num_steps=2, init_noise=noise)
    assert got.shape == (1, 16, 16, 3)
    assert float(np.abs(np.asarray(want)).max()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


CLIP1 = dict(vocab_size=500, hidden_size=24, num_layers=2, num_heads=2,
             intermediate_size=48, max_position_embeddings=TT, eos_token_id=499)
CLIP2 = dict(vocab_size=500, hidden_size=40, num_layers=2, num_heads=2,
             intermediate_size=64, projection_dim=POOLED,
             max_position_embeddings=TT, eos_token_id=499, hidden_act="gelu")


def _kd_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
        "input_ids": rng.randint(4, 500, (B, T)),
        "input_ids_uncond": np.full((B, T), 1),
        "input_ids_zh": rng.randint(4, 500, (B, T)),
        "input_ids_uncond_zh": np.full((B, T), 0),
        "teacher_ids_1": rng.randint(4, 499, (B, TT)),
        "teacher_ids_2": rng.randint(4, 499, (B, TT)),
        "teacher_uncond_ids_1": np.full((B, TT), 4),
        "teacher_uncond_ids_2": np.full((B, TT), 4),
        "time_ids": np.tile(np.array([[IMG, IMG, 0, 0, IMG, IMG]], np.float32), (B, 1)),
        "zh_or_not": np.asarray([1, 0], np.float32),
    }


def _jax_draws(key):
    r_noise, r_offset, r_t, r_cfg, r_vae = jax.random.split(key, 5)
    f = 2 ** (len(J_VAE_TINY.block_out_channels) - 1)
    shape = (B, IMG // f, IMG // f, 4)
    d = {"vae_eps": jax.random.normal(r_vae, shape, jnp.float32),
         "noise": jax.random.normal(r_noise, shape, jnp.float32),
         "offset_noise": jax.random.normal(r_offset, (B, 1, 1, 4), jnp.float32),
         "timesteps": jax.random.randint(r_t, (B,), 0, 1000),
         "cfg_uniform": jax.random.uniform(r_cfg, (B, 1, 1))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_kd_loss_with_mul_zh_dual_ids_matches_jax():
    """One kd_loss (CFG dropout 0.5) and its adapter gradients on each side,
    the mul_zh towers fed input_ids / input_ids_zh, on the same draws."""
    jcfg, pcfg = _text_cfgs(jax_text_cfg, "mul_zh"), _text_cfgs(port_text_cfg, "mul_zh")
    dims = _adapter_dims()
    enc, text_fn = jax_factory.make_text_encoder_fn("mul_zh", jcfg)
    jm = jax_kd.KDModels(
        adapter=JPEAAdapter(JAdapterConfig(*dims, head_dim=J_UNET_TINY.cross_attention_dim)),
        unet=JUNet(J_UNET_TINY), vae=JVAE(J_VAE_TINY), text_encoder_fn=text_fn,
        teacher_clip1=JCLIP(JCLIPTextConfig(**CLIP1)),
        teacher_clip2=JCLIP(JCLIPTextConfig(**CLIP2)),
        schedule=J_SDXL_SCHEDULE, vae_scaling=J_VAE_TINY.scaling_factor,
        vae_encode_chunk=None)
    ids0, tids = np.zeros((1, T), np.int32), np.zeros((1, TT), np.int32)
    frozen = {
        "text": _family_params("mul_zh", enc, {"mul": ids0, "zh": ids0}),
        "unet": host_params(jm.unet, *_unet_args(), seed=2),
        "vae": host_params(jm.vae, np.zeros((1, IMG, IMG, 3), np.float32),
                           jax.random.PRNGKey(0), seed=3),
        "teacher_clip1": host_params(jm.teacher_clip1, tids, seed=4),
        "teacher_clip2": host_params(jm.teacher_clip2, tids, seed=5),
    }
    adapter_params = host_params(jm.adapter, np.zeros((1, T, dims[0]), np.float32), seed=6)
    tm = build_kd_models(
        family="mul_zh", text_cfg=pcfg,
        adapter_cfg=AdapterConfig(*dims, head_dim=SDXL_UNET_TINY.cross_attention_dim),
        unet_cfg=SDXL_UNET_TINY, vae_cfg=VAE_TINY,
        teacher_cfgs=(CLIPTextConfig(**CLIP1), CLIPTextConfig(**CLIP2)),
        dtype=torch.float32, device="cpu", vae_encode_chunk=None)
    tm.text_encoder.load_state_dict(from_jax.mul_zh_state_dict(frozen["text"]))
    tm.unet.load_state_dict(from_jax.unet_state_dict(frozen["unet"], SDXL_UNET_TINY))
    tm.vae.load_state_dict(from_jax.vae_state_dict(frozen["vae"], VAE_TINY))
    tm.teacher_clip1.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip1"]))
    tm.teacher_clip2.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip2"]))
    tm.adapter.load_state_dict(from_jax.adapter_state_dict(adapter_params))

    key, batch = jax.random.PRNGKey(0), _kd_batch()
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt, k: jax_kd.kd_loss(p, jm, frozen, JTrainConfig(cfg_dropout=0.5), bt, k),
        has_aux=True))
    (want_loss, want_m), want_g = fn(adapter_params,
                                     {k: jnp.asarray(v) for k, v in batch.items()}, key)
    want_g = from_jax.adapter_state_dict(jax.tree.map(np.asarray, want_g))
    loss, metrics = kd.kd_loss(tm, TrainConfig(cfg_dropout=0.5),
                               {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
                               draws=_jax_draws(key))
    loss.backward()
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-5)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]), atol=1e-5, err_msg=k)
    for k, p in tm.adapter.named_parameters():
        assert p.grad.abs().max() > 0, k
        np.testing.assert_allclose(p.grad.numpy(), want_g[k].numpy(), atol=1e-4, err_msg=k)


def test_with_text_tower_swaps_the_tower_and_adapter_as_build_models_makes_them():
    """A deployment with another family's tower keeps the UNet and VAE and
    gets the tower and adapter weights build_models makes from that seed."""
    stack = dict(unet_cfg=SDXL_UNET_TINY, vae_cfg=VAE_TINY, dtype=torch.float32, device="cpu")
    adapter_cfg = AdapterConfig(64, (96, POOLED), head_dim=64)
    base = build_models(family="chinese_clip", text_cfg=port_text_cfg.BERT_TINY,
                        adapter_cfg=adapter_cfg, seed=0, **stack)
    want = build_models(family="mt5", text_cfg=port_text_cfg.T5_TINY, adapter_cfg=adapter_cfg,
                        seed=5, **stack)
    got = with_text_tower(base, "mt5", port_text_cfg.T5_TINY, adapter_cfg, torch.float32, seed=5)
    assert got.unet is base.unet and got.vae is base.vae and base.text_encoder is not None
    for name in ("text_encoder", "adapter"):
        a, b = getattr(got, name).state_dict(), getattr(want, name).state_dict()
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), name
    ids = torch.from_numpy(_ids(0)).long()
    torch.testing.assert_close(got.text_encoder_fn(ids), want.text_encoder_fn(ids))


def test_smoke_towers_phase_walk_has_kernel_rows():
    """chip_smoke.py's towers paths run the SDXL serving shapes and its
    mul_zh KD step the SDXL training shapes: each kernel call of their walk
    has a forward (and, for the KD step's student, a backward) kernel row;
    each family's full-width tower feeds its adapter preset's width, and
    the smoke's ids are padded rows inside the vocab."""
    import chip_smoke
    from pea_diffusion_tpu_torch.configs import ADAPTER_PRESETS, SDXL_UNET
    from pea_diffusion_tpu_torch.models import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(SDXL_UNET)
    fwd, bwd = chip_smoke.forward_cases(), chip_smoke.backward_cases()
    routes = chip_smoke.attention_routes(unet, chip_smoke.PRESET_SIZE // 8, chip_smoke.TEXT_TOKENS)
    serving = {k for k in routes if k[0] != "plain"}
    for path, spec in chip_smoke.TOWERS.items():
        assert serving and serving == {r[7][path] for r in fwd if path in r[7]}, path
        cfg = chip_smoke.tower_configs(spec["text"])
        width = {"mt5": "d_model", "alt_clip": "project_dim"}.get(spec["family"], "hidden_size")
        width = (sum(c.hidden_size for c in cfg) if spec["family"] == "mul_zh"
                 else getattr(cfg, width))
        assert width == ADAPTER_PRESETS[spec["adapter"]].in_dim, path
        ids = chip_smoke.tower_ids(cfg, 0, (24, 37))
        for rows, c in (zip(ids.values(), cfg) if isinstance(ids, dict) else [(ids, cfg)]):
            assert rows.shape == (2, chip_smoke.TEXT_TOKENS) and rows.max() < c.vocab_size
            assert (rows[1, 37:] == c.pad_token_id).all() and (rows[1, :37] >= 5).all()
    latent = chip_smoke.TRAINING["sdxl training"]["size"] // 8
    student = {k for k in chip_smoke.attention_routes(unet, latent, chip_smoke.TEXT_TOKENS)
               if k[0] != "plain"}
    teacher = {k for k in chip_smoke.attention_routes(unet, latent, chip_smoke.TEACHER_TOKENS)
               if k[0] != "plain"}
    path = chip_smoke.MUL_ZH_KD_PATH
    assert student | teacher == {r[7][path] for r in fwd if path in r[7]}
    assert student == {r[4][path] for r in bwd if path in r[4]}
    assert not chip_smoke.attention_routes(unet, latent, chip_smoke.TEXT_TOKENS, grad_free=True)


@pytest.mark.parametrize("family", ["mt5", "alt_clip"])
def test_tower_precision_tool_walks_every_block(monkeypatch, family):
    """tools/tower_precision.py on a tiny tower: a gap after each block and
    one of the output, finite and small where bf16 rounding is all that
    differs."""
    from pea_diffusion_tpu_torch import configs
    from pea_diffusion_tpu_torch.tools import tower_precision

    tiny = _text_cfgs(port_text_cfg, family)
    monkeypatch.setattr(configs, tower_precision.TOWERS[family], tiny)
    gaps = tower_precision.block_gaps(family, 0.02, torch.device("cpu"), tokens=12, real=8)
    assert len(gaps) == tiny.num_layers + 1
    assert all(0 < g < 0.1 and r > 0 for g, r in gaps)
