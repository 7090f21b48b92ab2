"""The port's KD training (train/kd.py, optim.py, trainer.py, cli/train.py)
held against the JAX package's on the tiny stack of tests/test_kd_train.py
(SDXL: dual CLIP teacher, pooled and time-id conditioning) and on the full
path of tests/test_kd_sd15.py (SD1.5: one CLIP teacher's last states, a
seq-only adapter, no added conditioning), in fp32 on the CPU.

Parameters are made with numpy from a seed for the JAX modules and carried
to the port by checkpoints/from_jax.py; the random draws of a step (VAE
eps, noise, offset noise, timesteps, CFG-drop uniforms) are JAX's, made
from its key splits and injected into the port's kd_loss. Tolerances: atol
1e-5 on the losses, 1e-4 on the adapter gradients (fp32 sums in another
order through the UNet's backward), 1e-5 on the adapter after three
optimizer steps on the same gradients, 1e-4 after three whole train steps
(ADAM_ATOL).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pea_diffusion_tpu.checkpoints.orbax_io import import_adapter as jax_import_adapter
from pea_diffusion_tpu.checkpoints.torch_convert import convert_adapter
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as J_BERT_TINY
from pea_diffusion_tpu.configs.text_encoder import CLIPTextConfig as JCLIPTextConfig
from pea_diffusion_tpu.configs.train import TrainConfig as JTrainConfig
from pea_diffusion_tpu.configs.unet import SD15_UNET_TINY as J_SD15_UNET_TINY
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as J_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as J_VAE_TINY
from pea_diffusion_tpu.models.adapter import PEAAdapter as JPEAAdapter
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JBert
from pea_diffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from pea_diffusion_tpu.models.unet import UNet2DCondition as JUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JVAE
from pea_diffusion_tpu.schedulers import SD15_SCHEDULE as J_SD15_SCHEDULE
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as J_SDXL_SCHEDULE
from pea_diffusion_tpu.train import kd as jax_kd
from pea_diffusion_tpu.train.optim import _decay_mask, make_optimizer
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli import train as train_cli
from pea_diffusion_tpu_torch.configs import (BERT_TINY, SD15_UNET_TINY, SDXL_UNET_TINY,
                                             VAE_TINY, AdapterConfig, CLIPTextConfig,
                                             TrainConfig)
from pea_diffusion_tpu_torch.pipelines.factory import build_kd_models
from pea_diffusion_tpu_torch.schedulers import SD15_SCHEDULE
from pea_diffusion_tpu_torch.train import kd, optim
from pea_diffusion_tpu_torch.checkpoints.orbax_io import export_adapter, import_adapter
from pea_diffusion_tpu_torch.train.trainer import KDTrainer

from _torch_parity import host_params

B, T, TT, IMG = 4, 12, 16, 32
POOLED = 64  # SDXL_UNET_TINY's pooled width
CLIP1 = dict(vocab_size=500, hidden_size=24, num_layers=2, num_heads=2,
             intermediate_size=48, max_position_embeddings=TT, eos_token_id=499)
CLIP2 = dict(vocab_size=500, hidden_size=40, num_layers=2, num_heads=2,
             intermediate_size=64, projection_dim=POOLED,
             max_position_embeddings=TT, eos_token_id=499, hidden_act="gelu")
LOSS_ATOL, GRAD_ATOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
# The adapter after whole train steps: Adam's m / (sqrt(v) + eps) turns a
# gradient element near 0 into up to +-lr, so an element whose fp32
# gradient differs in its last bits between the frameworks can move by a
# fraction of lr (1e-3 here); a tenth of one step's largest update.
ADAM_ATOL = 1e-4


@pytest.fixture(scope="module")
def stacks():
    """The tiny KD stack on both sides, with the same weights."""
    adapter_cfg = (BERT_TINY.hidden_size, (96, POOLED))
    enc = JBert(J_BERT_TINY)
    jm = jax_kd.KDModels(
        adapter=JPEAAdapter(JAdapterConfig(*adapter_cfg,
                                           head_dim=J_UNET_TINY.cross_attention_dim)),
        unet=JUNet(J_UNET_TINY), vae=JVAE(J_VAE_TINY),
        text_encoder_fn=lambda p, ids: enc.apply(p, ids).last_hidden_state,
        teacher_clip1=JCLIP(JCLIPTextConfig(**CLIP1)),
        teacher_clip2=JCLIP(JCLIPTextConfig(**CLIP2)),
        schedule=J_SDXL_SCHEDULE, vae_scaling=J_VAE_TINY.scaling_factor,
        vae_encode_chunk=None)
    ids, tids = jnp.zeros((1, T), jnp.int32), jnp.zeros((1, TT), jnp.int32)
    added = {"text_embeds": jnp.zeros((1, POOLED)), "time_ids": jnp.zeros((1, 6))}
    frozen = {
        "text": host_params(enc, ids, seed=1),
        "unet": host_params(jm.unet, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                            jnp.zeros((1, T, J_UNET_TINY.cross_attention_dim)), added,
                            seed=2),
        "teacher_clip1": host_params(jm.teacher_clip1, tids, seed=4),
        "teacher_clip2": host_params(jm.teacher_clip2, tids, seed=5),
    }
    frozen["vae"] = host_params(jm.vae, jnp.zeros((1, IMG, IMG, 3)),
                                jax.random.PRNGKey(0), seed=3)
    adapter_params = host_params(jm.adapter, jnp.zeros((1, T, BERT_TINY.hidden_size)),
                                 seed=6)

    tm = build_kd_models(
        family="chinese_clip", text_cfg=BERT_TINY,
        adapter_cfg=AdapterConfig(*adapter_cfg, head_dim=SDXL_UNET_TINY.cross_attention_dim),
        unet_cfg=SDXL_UNET_TINY, vae_cfg=VAE_TINY,
        teacher_cfgs=(CLIPTextConfig(**CLIP1), CLIPTextConfig(**CLIP2)),
        dtype=torch.float32, device="cpu", vae_encode_chunk=None)
    tm.text_encoder.load_state_dict(from_jax.bert_text_state_dict(frozen["text"]))
    tm.unet.load_state_dict(from_jax.unet_state_dict(frozen["unet"], SDXL_UNET_TINY))
    tm.vae.load_state_dict(from_jax.vae_state_dict(frozen["vae"], VAE_TINY))
    tm.teacher_clip1.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip1"]))
    tm.teacher_clip2.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip2"]))
    tm.adapter.load_state_dict(from_jax.adapter_state_dict(adapter_params))
    return jm, frozen, adapter_params, tm


def _batch(seed=0, zh=(1, 1, 0, 0)):
    rng = np.random.RandomState(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (B, IMG, IMG, 3)).astype(np.float32),
        "input_ids": rng.randint(4, 500, (B, T)),
        "input_ids_uncond": np.full((B, T), 4),
        "teacher_ids_1": rng.randint(4, 499, (B, TT)),
        "teacher_ids_2": rng.randint(4, 499, (B, TT)),
        "teacher_uncond_ids_1": np.full((B, TT), 4),
        "teacher_uncond_ids_2": np.full((B, TT), 4),
        "time_ids": np.tile(np.array([[IMG, IMG, 0, 0, IMG, IMG]], np.float32), (B, 1)),
        "zh_or_not": np.asarray(zh, np.float32),
    }


def _jax_draws(key, b=B):
    """kd_loss's draws from `key`, as the JAX package makes them."""
    r_noise, r_offset, r_t, r_cfg, r_vae = jax.random.split(key, 5)
    f = 2 ** (len(J_VAE_TINY.block_out_channels) - 1)
    shape = (b, IMG // f, IMG // f, 4)
    d = {"vae_eps": jax.random.normal(r_vae, shape, jnp.float32),
         "noise": jax.random.normal(r_noise, shape, jnp.float32),
         "offset_noise": jax.random.normal(r_offset, (b, 1, 1, 4), jnp.float32),
         "timesteps": jax.random.randint(r_t, (b,), 0, 1000),
         "cfg_uniform": jax.random.uniform(r_cfg, (b, 1, 1))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_loss_and_grads(stacks, cfg, batch, key):
    jm, frozen, adapter_params, _ = stacks
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt, k: jax_kd.kd_loss(p, jm, frozen, cfg, bt, k), has_aux=True))
    (loss, metrics), grads = fn(adapter_params,
                                {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        from_jax.adapter_state_dict(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def parity(stacks):
    """One kd_loss on each side, on the same batch and draws, with cfg
    dropout 0.5 so that some rows take the unconditional states."""
    key = jax.random.PRNGKey(0)
    batch = _batch()
    want = _jax_loss_and_grads(stacks, JTrainConfig(cfg_dropout=0.5), batch, key)
    tm = stacks[3]
    tm.adapter.zero_grad()
    loss, metrics = kd.kd_loss(tm, TrainConfig(cfg_dropout=0.5), _torch_batch(batch),
                               draws=_jax_draws(key))
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.adapter.named_parameters()}
    tm.adapter.zero_grad()
    return want, (loss.item(), {k: float(v) for k, v in metrics.items()}, grads)


def test_kd_loss_and_metrics_match_jax(parity):
    (want_loss, want_m, _), (loss, m, _) = parity
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, want_loss, atol=LOSS_ATOL)
    assert set(m) == set(want_m) == {"train_loss", "train_loss_logits",
                                     "train_loss_features", "loss"}
    for k in want_m:
        np.testing.assert_allclose(m[k], want_m[k], atol=LOSS_ATOL, err_msg=k)


def test_kd_adapter_grads_match_jax(parity):
    (_, _, want), (_, _, got) = parity
    assert set(got) == set(want)
    for k in want:
        assert got[k].abs().max() > 0, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=GRAD_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("options", [dict(kd=False), dict(hybrid_training=False)],
                         ids=["no_kd", "no_hybrid"])
def test_kd_loss_branches_match_jax(stacks, options):
    """The train CLI's --no-kd and --no-hybrid: loss, metrics and adapter
    gradients against the JAX package's on the same batch and draws."""
    key = jax.random.PRNGKey(1)
    batch = _batch(1)
    want_loss, want_m, want_g = _jax_loss_and_grads(stacks, JTrainConfig(**options),
                                                    batch, key)
    tm = stacks[3]
    tm.adapter.zero_grad()
    loss, m = kd.kd_loss(tm, TrainConfig(**options), _torch_batch(batch),
                         draws=_jax_draws(key))
    loss.backward()
    got = {k: p.grad.clone() for k, p in tm.adapter.named_parameters()}
    tm.adapter.zero_grad()
    np.testing.assert_allclose(loss.item(), want_loss, atol=LOSS_ATOL)
    assert set(m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(m[k]), want_m[k], atol=LOSS_ATOL, err_msg=k)
    assert set(got) == set(want_g)
    for k in want_g:
        np.testing.assert_allclose(got[k].numpy(), want_g[k].numpy(), atol=GRAD_ATOL,
                                   err_msg=k)


def test_hybrid_masking_routes_losses(stacks):
    tm = stacks[3]
    cfg = TrainConfig(cfg_dropout=0.0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        _, m_en = kd.kd_loss(tm, cfg, _torch_batch(_batch(zh=[0, 0, 0, 0])), gen)
        _, m_zh = kd.kd_loss(tm, cfg, _torch_batch(_batch(zh=[1, 1, 1, 1])), gen)
    assert float(m_en["train_loss"]) == 0.0 and float(m_en["train_loss_logits"]) > 0.0
    assert float(m_zh["train_loss"]) > 0.0
    assert float(m_zh["train_loss_logits"]) == 0.0
    assert float(m_zh["train_loss_features"]) == 0.0


def _snapshot(tm):
    return {name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in [("adapter", tm.adapter), *tm.frozen_modules().items()]}


def test_only_the_adapter_trains(stacks):
    tm = stacks[3]
    assert all(p.requires_grad for p in tm.adapter.parameters())
    for m in tm.frozen_modules().values():
        assert not any(p.requires_grad for p in m.parameters())
    before = _snapshot(tm)
    init_fn, step_fn = kd.make_train_step(tm, TrainConfig(warmup_steps=0, warmup_ratio=0.0, learning_rate=1e-3))
    step_fn(init_fn(), _torch_batch(_batch(3)), torch.Generator().manual_seed(0))
    after = _snapshot(tm)
    tm.adapter.load_state_dict(before["adapter"])
    for name in before:
        same = all(torch.equal(before[name][k], after[name][k]) for k in before[name])
        assert same == (name != "adapter"), name


def test_grad_accum_is_the_mean_of_micro_batch_grads(stacks):
    tm = stacks[3]
    batch = _torch_batch(_batch(4))
    draws = [_jax_draws(jax.random.PRNGKey(i), b=B // 2) for i in (7, 8)]
    grads = []
    for i, d in enumerate(draws):
        half = {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
        tm.adapter.zero_grad()
        kd.kd_loss(tm, TrainConfig(), half, draws=dict(d))[0].backward()
        grads.append({k: p.grad.clone() for k, p in tm.adapter.named_parameters()})
    tm.adapter.zero_grad()
    mean = {k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]}

    before = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    cfg = TrainConfig(grad_accum_steps=2, warmup_steps=0, warmup_ratio=0.0,
                      learning_rate=1e-3)
    init_fn, step_fn = kd.make_train_step(tm, cfg)
    _, metrics = step_fn(init_fn(), batch, draws=[dict(d) for d in draws])
    after = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    tm.adapter.load_state_dict(before)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(optim.global_norm(mean)), rtol=1e-6)
    # the step applied the mean gradient: the same update from it by hand
    want = {k: v.clone() for k, v in before.items()}
    optim.apply_update(cfg, want, mean, optim.init_state(want), optim.decay_mask(tm.adapter))
    for k in want:
        torch.testing.assert_close(after[k], want[k], rtol=0, atol=1e-7)


# --- SD1.5: tests/test_kd_sd15.py's full path -------------------------------

SD15_B, SD15_T, SD15_TT = 2, 10, 14
SD15_CLIP = dict(vocab_size=500, hidden_size=SD15_UNET_TINY.cross_attention_dim, num_layers=2,
                 num_heads=2, intermediate_size=64, max_position_embeddings=SD15_TT,
                 eos_token_id=499)


@pytest.fixture(scope="module")
def sd15_stacks():
    """The tiny SD1.5 KD stack on both sides, with the same weights: one
    CLIP teacher as wide as the UNet's cross-attention, a seq-only adapter."""
    ucfg = J_SD15_UNET_TINY
    adapter_cfg = (BERT_TINY.hidden_size, (96, 96, ucfg.cross_attention_dim))
    enc = JBert(J_BERT_TINY)
    jm = jax_kd.KDModels(
        adapter=JPEAAdapter(JAdapterConfig(*adapter_cfg)), unet=JUNet(ucfg),
        vae=JVAE(J_VAE_TINY),
        text_encoder_fn=lambda p, ids: enc.apply(p, ids).last_hidden_state,
        teacher_clip1=JCLIP(JCLIPTextConfig(**SD15_CLIP)), teacher_clip2=None,
        schedule=J_SD15_SCHEDULE, vae_scaling=J_VAE_TINY.scaling_factor)
    frozen = {
        "text": host_params(enc, jnp.zeros((1, SD15_T), jnp.int32), seed=21),
        "unet": host_params(jm.unet, jnp.zeros((1, 8, 8, 4)), jnp.array([0]),
                            jnp.zeros((1, SD15_T, ucfg.cross_attention_dim)), seed=22),
        "vae": host_params(jm.vae, jnp.zeros((1, IMG, IMG, 3)), jax.random.PRNGKey(0),
                           seed=23),
        "teacher_clip1": host_params(jm.teacher_clip1, jnp.zeros((1, SD15_TT), jnp.int32),
                                     seed=24),
    }
    adapter_params = host_params(jm.adapter, jnp.zeros((1, SD15_T, BERT_TINY.hidden_size)),
                                 seed=25)
    tm = build_kd_models(
        family="chinese_clip", text_cfg=BERT_TINY, adapter_cfg=AdapterConfig(*adapter_cfg),
        unet_cfg=SD15_UNET_TINY, vae_cfg=VAE_TINY,
        teacher_cfgs=(CLIPTextConfig(**SD15_CLIP),), schedule=SD15_SCHEDULE,
        dtype=torch.float32, device="cpu")
    assert tm.teacher_clip2 is None and tm.vae_scaling == jm.vae_scaling == 0.18215
    tm.text_encoder.load_state_dict(from_jax.bert_text_state_dict(frozen["text"]))
    tm.unet.load_state_dict(from_jax.unet_state_dict(frozen["unet"], SD15_UNET_TINY))
    tm.vae.load_state_dict(from_jax.vae_state_dict(frozen["vae"], VAE_TINY))
    tm.teacher_clip1.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip1"]))
    tm.adapter.load_state_dict(from_jax.adapter_state_dict(adapter_params))
    return jm, frozen, adapter_params, tm


def _sd15_batch(seed=2, zh=(1, 0)):
    """tests/test_kd_sd15.py's batch: no second teacher, no time ids."""
    rng = np.random.RandomState(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (SD15_B, IMG, IMG, 3)).astype(np.float32),
        "input_ids": rng.randint(4, 500, (SD15_B, SD15_T)),
        "input_ids_uncond": np.full((SD15_B, SD15_T), 4),
        "teacher_ids_1": rng.randint(4, 499, (SD15_B, SD15_TT)),
        "teacher_uncond_ids_1": np.full((SD15_B, SD15_TT), 4),
        "zh_or_not": np.asarray(zh, np.float32),
    }


@pytest.mark.parametrize("options", [dict(cfg_dropout=0.5), dict(kd=False)],
                         ids=["full_path", "no_kd"])
def test_sd15_kd_loss_and_adapter_grads_match_jax(sd15_stacks, options):
    """kd_loss's SD1.5 branch (teacher_clip2 None: the teacher's last hidden
    state; no pooled, no added conditioning): loss, metrics and adapter
    gradients against the JAX package's on the same batch and draws."""
    key = jax.random.PRNGKey(4)
    batch = _sd15_batch(zh=(1, 0) if options.get("kd", True) else (1, 1))
    want_loss, want_m, want_g = _jax_loss_and_grads(sd15_stacks, JTrainConfig(**options),
                                                    batch, key)
    tm = sd15_stacks[3]
    tm.adapter.zero_grad()
    loss, m = kd.kd_loss(tm, TrainConfig(**options), _torch_batch(batch),
                         draws=_jax_draws(key, b=SD15_B))
    loss.backward()
    got = {k: p.grad.clone() for k, p in tm.adapter.named_parameters()}
    tm.adapter.zero_grad()
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), want_loss, atol=LOSS_ATOL)
    assert set(m) == set(want_m)
    assert ("train_loss_features" in m) == options.get("kd", True)
    for k in want_m:
        np.testing.assert_allclose(float(m[k]), want_m[k], atol=LOSS_ATOL, err_msg=k)
    assert set(got) == set(want_g) and "fc.weight" not in got
    for k in want_g:
        assert got[k].abs().max() > 0, k
        np.testing.assert_allclose(got[k].numpy(), want_g[k].numpy(), atol=GRAD_ATOL,
                                   err_msg=k)


def test_sd15_train_steps_match_jax(sd15_stacks):
    """Three make_train_step steps on each side (test_kd_sd15.py's config:
    lr 1e-3, no CFG dropout; no warmup, so every step moves the adapter),
    each step with JAX's draws from its key: per-step metrics and the
    adapter after the steps."""
    jm, frozen, adapter_params, tm = sd15_stacks
    opts = dict(total_steps=100, warmup_steps=0, warmup_ratio=0.0, learning_rate=1e-3,
                cfg_dropout=0.0)
    j_init, j_step = jax_kd.make_train_step(jm, JTrainConfig(**opts))
    jstate, _ = j_init(adapter_params)
    j_step = jax.jit(j_step)
    before = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    t_init, t_step = kd.make_train_step(tm, TrainConfig(**opts))
    tstate = t_init()
    batch = _sd15_batch()
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm_ = j_step(jstate, frozen, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tstate, tm_ = t_step(tstate, _torch_batch(batch), draws=[_jax_draws(key, b=SD15_B)])
        assert set(tm_) == set(jm_)
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), atol=LOSS_ATOL,
                                       rtol=1e-5, err_msg=f"step {i} {k}")
    after = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    tm.adapter.load_state_dict(before)
    want = from_jax.adapter_state_dict(jax.tree.map(np.asarray, jstate.adapter_params))
    assert tstate.step == 3
    for k in want:
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), want[k].numpy(), atol=ADAM_ATOL,
                                   err_msg=k)


def _tiny_adapter_params():
    cfg = JAdapterConfig(16, (24, 8), head_dim=12)
    params = host_params(JPEAAdapter(cfg), jnp.zeros((1, 5, 16)), seed=11)
    return cfg, params


def test_decay_mask_matches_jax():
    from pea_diffusion_tpu_torch.models.adapter import PEAAdapter

    cfg, params = _tiny_adapter_params()
    port = PEAAdapter(AdapterConfig(16, (24, 8), head_dim=12))
    mask = optim.decay_mask(port)
    # carry each mask value through the converter as a constant array
    sd = {k: np.full(tuple(p.shape), mask[k]) for k, p in port.named_parameters()}
    got = convert_adapter(sd)
    want = _decay_mask(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(map(str, flat_got)) == set(map(str, flat_want))
    for path, m in flat_want.items():
        leaf = flat_got[path]
        assert bool(leaf.all()) == bool(leaf.any()) == bool(m), jax.tree_util.keystr(path)


@pytest.mark.parametrize("scheduler", ["polynomial", "cosine"])
def test_three_optimizer_steps_match_optax(scheduler):
    """Warmup (2 steps) and clipping (grad norms 3 to 9) both active."""
    _, params = _tiny_adapter_params()
    jcfg = JTrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                        scheduler_type=scheduler)
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                      scheduler_type=scheduler)
    tx = make_optimizer(jcfg, params)
    opt_state = tx.init(params)
    jparams = params
    tparams = {k: v.clone() for k, v in from_jax.adapter_state_dict(params).items()}
    from pea_diffusion_tpu_torch.models.adapter import PEAAdapter

    mask = optim.decay_mask(PEAAdapter(AdapterConfig(16, (24, 8), head_dim=12)))
    state = optim.init_state(tparams)
    rng = np.random.default_rng(0)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: (3.0 * (step + 1) * rng.standard_normal(p.shape)
                       / np.sqrt(p.size)).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        norm = optim.apply_update(cfg, tparams, from_jax.adapter_state_dict(grads), state, mask)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        assert float(norm) > 1.0  # the clip is active
    want = from_jax.adapter_state_dict(jax.tree.map(np.asarray, jparams))
    for k in want:
        np.testing.assert_allclose(tparams[k].numpy(), want[k].numpy(), atol=PARAM_ATOL,
                                   err_msg=k)
    assert state["count"] == 3


def test_trainer_fit_checkpoint_resume(tmp_path):
    out = str(tmp_path / "run")
    models, make_batches = train_cli.build_demo("cpu", batch_size=2)
    cfg = TrainConfig(total_steps=100, warmup_steps=0, every_n_steps=2,
                      log_every_n_steps=1, output_dir=out, batch_size_per_device=2)
    trainer = KDTrainer(models, cfg)
    assert trainer.resume() == 0
    trainer.fit(make_batches(), max_steps=3)
    assert trainer.host_step == 3 and trainer.consumed_samples == 3 * 2
    with open(os.path.join(out, "metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    assert last["consumed_samples"] == 6 and np.isfinite(last["loss"])
    assert os.path.exists(os.path.join(out, "proj_2", "pytorch_model.bin"))
    saved = torch.load(os.path.join(out, "checkpoints", "step_2.pt"), weights_only=True)

    models2, _ = train_cli.build_demo("cpu", batch_size=2, seed=1)
    trainer2 = KDTrainer(models2, cfg)
    assert trainer2.resume() == 2
    assert trainer2.consumed_samples == 2 * cfg.batch_size_per_device
    for k, v in models2.adapter.state_dict().items():
        assert torch.equal(v, saved["adapter"][k]), k
    assert trainer2.state.optimizer["count"] == 2
    trainer2.fit(make_batches(2), max_steps=4)
    assert trainer2.host_step == 4


def test_exported_adapter_round_trips_through_jax_import_adapter(tmp_path, stacks):
    tm = stacks[3]
    d = export_adapter(tm.adapter, str(tmp_path), 7)
    got = jax_import_adapter(os.path.join(d, "pytorch_model.bin"))
    want = convert_adapter({k: v.detach().numpy() for k, v in tm.adapter.state_dict().items()})
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(flat_got) == set(flat_want)
    for path, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[path]), v)
    # and back into a port adapter through the port's own import
    from pea_diffusion_tpu_torch.models.adapter import PEAAdapter

    back = PEAAdapter(tm.adapter.config)
    import_adapter(os.path.join(d, "pytorch_model.bin"), back)
    for k, v in tm.adapter.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def test_cli_train_demo_sd15_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "sd15")
    train_cli.main(["--model", "sd15", "--demo", "--device", "cpu", "--steps", "2",
                    "--output", out])
    assert "done at step 2" in capsys.readouterr().out
    assert os.path.exists(os.path.join(out, "proj_2", "pytorch_model.bin"))


def test_cli_train_demo_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "cli")
    train_cli.main(["--demo", "--device", "cpu", "--steps", "2", "--output", out])
    text = capsys.readouterr().out
    assert "done at step 2" in text
    assert os.path.exists(os.path.join(out, "proj_2", "pytorch_model.bin"))
    with pytest.raises(SystemExit):  # the real mode needs its directories
        train_cli.main(["--output", out])
    assert "--model-dir required without --demo" in capsys.readouterr().err
