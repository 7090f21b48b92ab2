"""The rest of the port's KD training (train/kd.py's remat policies and
feature-tap dtype, trainer.py's mul_zh keys, warmup and profiler window,
cli/train.py's real mode) on a small stack, in fp32 on the CPU.

The stack: BERT_TINY, two tiny CLIP teachers, a two-level SDXL-architecture
UNet (`MINI`: no attention at level 0, two transformer blocks a unit at
level 1, one in the mid block, so that the "blocks" policy nests block
segments inside unit segments) and a four-level VAE (`VAE8`, 8x down, so
that bucket-sized images stay small latents). Parameters are made with
numpy from a seed for the JAX modules and carried to the port by
checkpoints/from_jax.py; a step's draws are JAX's, injected into the port.

Tolerances: the adapter gradients within GRAD_ATOL 1e-4 of JAX's under each
remat policy, as tests/test_torch_train.py holds them (fp32 sums in another
order through the UNet's backward); with bfloat16 feature taps the loss and
the gradients within TAP_RTOL of their largest value: each tap difference
is rounded to bf16 (a relative step of 2^-8 = 3.9e-3) where XLA may keep
some of those differences in fp32 across its fused ops, so one rounding
step of the feature terms bounds the gap.
"""
import dataclasses
import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils.checkpoint import CheckpointPolicy

import _torch_dirs as dirs
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as J_BERT_TINY
from pea_diffusion_tpu.configs.text_encoder import CLIPTextConfig as JCLIPTextConfig
from pea_diffusion_tpu.configs.train import TrainConfig as JTrainConfig
from pea_diffusion_tpu.configs.unet import UNetConfig as JUNetConfig
from pea_diffusion_tpu.configs.unet import VAEConfig as JVAEConfig
from pea_diffusion_tpu.models.adapter import PEAAdapter as JPEAAdapter
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JBert
from pea_diffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from pea_diffusion_tpu.models.unet import UNet2DCondition as JUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JVAE
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as J_SDXL_SCHEDULE
from pea_diffusion_tpu.train import kd as jax_kd
from pea_diffusion_tpu.train import trainer as jax_trainer
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli import train as train_cli
from pea_diffusion_tpu_torch.configs import (ADAPTER_PRESETS, BERT_TINY, AdapterConfig,
                                             CLIPTextConfig, TrainConfig,
                                             UNetConfig, VAEConfig)
from pea_diffusion_tpu_torch.models import unet as unet_mod
from pea_diffusion_tpu_torch.pipelines.factory import build_kd_models
from pea_diffusion_tpu_torch.train import kd, trainer
from pea_diffusion_tpu_torch.train.trainer import KDTrainer

from _torch_parity import host_params, one_torch_thread  # noqa: F401

B, T, TT, IMG = 2, 12, 16, 32
POOLED = 64
MINI = dict(block_out_channels=(32, 64), layers_per_block=1, transformer_layers=(0, 2),
            num_attention_heads=(2, 4), cross_attention_dim=64, mid_transformer_layers=1,
            norm_num_groups=8, addition_embed_type="text_time", addition_time_embed_dim=32,
            projection_class_embeddings_input_dim=32 * 6 + POOLED, use_linear_projection=True)
VAE8 = dict(block_out_channels=(8, 8, 8, 8), layers_per_block=1, norm_num_groups=8,
            scaling_factor=0.13025)
CLIP1 = dict(vocab_size=500, hidden_size=24, num_layers=2, num_heads=2,
             intermediate_size=48, max_position_embeddings=TT, eos_token_id=499)
CLIP2 = dict(CLIP1, hidden_size=40, intermediate_size=64, projection_dim=POOLED,
             hidden_act="gelu")
ADAPTER = (BERT_TINY.hidden_size, (96, POOLED))
GRAD_ATOL = 1e-4
TAP_RTOL = 4e-3


@pytest.fixture(scope="module")
def stacks():
    enc = JBert(J_BERT_TINY)
    jm = jax_kd.KDModels(
        adapter=JPEAAdapter(JAdapterConfig(*ADAPTER, head_dim=64)),
        unet=JUNet(JUNetConfig(**MINI)), vae=JVAE(JVAEConfig(**VAE8)),
        text_encoder_fn=lambda p, ids: enc.apply(p, ids).last_hidden_state,
        teacher_clip1=JCLIP(JCLIPTextConfig(**CLIP1)),
        teacher_clip2=JCLIP(JCLIPTextConfig(**CLIP2)),
        schedule=J_SDXL_SCHEDULE, vae_scaling=VAE8["scaling_factor"], vae_encode_chunk=None)
    ids, tids = jnp.zeros((1, T), jnp.int32), jnp.zeros((1, TT), jnp.int32)
    added = {"text_embeds": jnp.zeros((1, POOLED)), "time_ids": jnp.zeros((1, 6))}
    frozen = {
        "text": host_params(enc, ids, seed=1),
        "unet": host_params(jm.unet, jnp.zeros((1, 4, 4, 4)), jnp.array([0]),
                            jnp.zeros((1, T, 64)), added, seed=2),
        "vae": host_params(jm.vae, jnp.zeros((1, IMG, IMG, 3)), jax.random.PRNGKey(0), seed=3),
        "teacher_clip1": host_params(jm.teacher_clip1, tids, seed=4),
        "teacher_clip2": host_params(jm.teacher_clip2, tids, seed=5),
    }
    adapter_params = host_params(jm.adapter, jnp.zeros((1, T, ADAPTER[0])), seed=6)
    unet_cfg, vae_cfg = UNetConfig(**MINI), VAEConfig(**VAE8)
    tm = build_kd_models(
        family="chinese_clip", text_cfg=BERT_TINY,
        adapter_cfg=AdapterConfig(*ADAPTER, head_dim=64), unet_cfg=unet_cfg, vae_cfg=vae_cfg,
        teacher_cfgs=(CLIPTextConfig(**CLIP1), CLIPTextConfig(**CLIP2)),
        dtype=torch.float32, device="cpu", vae_encode_chunk=None)
    tm.text_encoder.load_state_dict(from_jax.bert_text_state_dict(frozen["text"]))
    tm.unet.load_state_dict(from_jax.unet_state_dict(frozen["unet"], unet_cfg))
    tm.vae.load_state_dict(from_jax.vae_state_dict(frozen["vae"], vae_cfg))
    tm.teacher_clip1.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip1"]))
    tm.teacher_clip2.load_state_dict(from_jax.clip_text_state_dict(frozen["teacher_clip2"]))
    tm.adapter.load_state_dict(from_jax.adapter_state_dict(adapter_params))
    return jm, frozen, adapter_params, tm


def _batch(seed=0, b=B, img=IMG):
    rng = np.random.RandomState(seed)
    return {
        "pixel_values": rng.uniform(-1, 1, (b, img, img, 3)).astype(np.float32),
        "input_ids": rng.randint(4, 500, (b, T)),
        "input_ids_uncond": np.full((b, T), 4),
        "teacher_ids_1": rng.randint(4, 499, (b, TT)),
        "teacher_ids_2": rng.randint(4, 499, (b, TT)),
        "teacher_uncond_ids_1": np.full((b, TT), 4),
        "teacher_uncond_ids_2": np.full((b, TT), 4),
        "time_ids": np.tile(np.array([[img, img, 0, 0, img, img]], np.float32), (b, 1)),
        "zh_or_not": np.asarray([1, 0][:b] + [0] * (b - 2), np.float32),
    }


def _jax_draws(key):
    r_noise, r_offset, r_t, r_cfg, r_vae = jax.random.split(key, 5)
    shape = (B, IMG // 8, IMG // 8, 4)
    d = {"vae_eps": jax.random.normal(r_vae, shape, jnp.float32),
         "noise": jax.random.normal(r_noise, shape, jnp.float32),
         "offset_noise": jax.random.normal(r_offset, (B, 1, 1, 4), jnp.float32),
         "timesteps": jax.random.randint(r_t, (B,), 0, 1000),
         "cfg_uniform": jax.random.uniform(r_cfg, (B, 1, 1))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax_loss_and_grads(stacks, key, **models_kw):
    jm, frozen, adapter_params, _ = stacks
    jm = dataclasses.replace(jm, **models_kw)
    cfg = JTrainConfig(cfg_dropout=0.5)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt, k: jax_kd.kd_loss(p, jm, frozen, cfg, bt, k), has_aux=True))
    (loss, metrics), grads = fn(adapter_params, {k: jnp.asarray(v) for k, v in
                                                 _batch().items()}, key)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            from_jax.adapter_state_dict(jax.tree.map(np.asarray, grads)))


def _port_loss_and_grads(stacks, key, **models_kw):
    tm = dataclasses.replace(stacks[3], **models_kw)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch().items()}
    loss, metrics = kd.kd_loss(tm, TrainConfig(cfg_dropout=0.5), batch, draws=_jax_draws(key))
    names, params = zip(*tm.adapter.named_parameters())
    grads = torch.autograd.grad(loss, params)
    return (loss.item(), {k: float(v) for k, v in metrics.items()}, dict(zip(names, grads)))


@pytest.mark.parametrize("policy", ["full", "dots", "blocks"])
def test_remat_policy_adapter_grads_match_jax(stacks, policy):
    """kd_loss's adapter gradients under each remat policy against JAX's
    kd_loss under the same KDModels(remat_policy=...), same draws."""
    key = jax.random.PRNGKey(3)
    want_loss, want_m, want = _jax_loss_and_grads(stacks, key, remat_policy=policy)
    loss, metrics, got = _port_loss_and_grads(stacks, key, remat_policy=policy)
    assert abs(loss - want_loss) < 1e-5 and metrics.keys() == want_m.keys()
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=GRAD_ATOL, rtol=0, err_msg=k)
    assert max(v.abs().max().item() for v in got.values()) > 10 * GRAD_ATOL


def test_bfloat16_feature_taps_match_jax(stacks):
    """feature_tap_dtype="bfloat16": the feature term, the loss and the
    adapter gradients against JAX's within TAP_RTOL of their largest
    value, and the taps' bf16 rounding moves the feature term off fp32's."""
    key = jax.random.PRNGKey(4)
    want_loss, want_m, want = _jax_loss_and_grads(stacks, key, feature_tap_dtype="bfloat16")
    loss, metrics, got = _port_loss_and_grads(stacks, key, feature_tap_dtype="bfloat16")
    _, fp32_m, _ = _port_loss_and_grads(stacks, key)
    for name in ("train_loss_features", "loss"):
        assert abs(metrics[name] - want_m[name]) <= TAP_RTOL * abs(want_m[name]), name
    assert metrics["train_loss_features"] != fp32_m["train_loss_features"]
    scale = max(v.abs().max().item() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TAP_RTOL * scale, rtol=0,
                                   err_msg=k)


def _student_args(tm, b=B):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, 4, 4, 4), generator=gen)
    seq = torch.randn((b, T, 64), generator=gen).requires_grad_(True)
    added = {"text_embeds": torch.randn((b, POOLED), generator=gen).requires_grad_(True),
             "time_ids": torch.zeros((b, 6))}
    return x, torch.tensor([10, 600])[:b], seq, added


def _saved_bytes(tm, monkeypatch):
    """Bytes the student forward keeps for its backward: every tensor that
    autograd packs through saved_tensors_hooks outside the checkpoints, and
    for "dots" the outputs the selective policy saves (PyTorch keeps those
    in the checkpoint's own cache, past the hooks). A storage counts once;
    the UNet's parameters do not count."""
    params = {p.untyped_storage().data_ptr() for p in tm.unet.parameters()}
    seen = {}

    def note(t):
        st = t.untyped_storage()
        if st.data_ptr() not in params:
            seen[st.data_ptr()] = st.nbytes()

    def policy(ctx, op, *args, **kwargs):
        decision = kd_policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            note(ctx.op_output)
        return decision

    kd_policy = kd.dots_policy
    monkeypatch.setattr(kd, "dots_policy", policy)

    def pack(t):
        note(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, feats = kd.student_forward(tm, *_student_args(tm))
    monkeypatch.setattr(kd, "dots_policy", kd_policy)
    return sum(seen.values()), out, feats


def test_saved_bytes_fall_in_the_remat_order(stacks, monkeypatch):
    """no remat > "dots" > "blocks" > "full", and every policy gives the
    same outputs (a "blocks" that silently ran as "full" would save as
    little as "full")."""
    tm = stacks[3]
    runs = {name: _saved_bytes(dataclasses.replace(tm, **kw), monkeypatch)
            for name, kw in (("none", dict(remat=False)), ("dots", dict(remat_policy="dots")),
                             ("blocks", dict(remat_policy="blocks")),
                             ("full", dict(remat_policy="full")))}
    sizes = {k: v[0] for k, v in runs.items()}
    assert sizes["none"] > sizes["dots"] > sizes["blocks"] > sizes["full"] > 0, sizes
    for name, (_, out, feats) in runs.items():
        assert torch.equal(out, runs["none"][1]), name
        assert all(torch.equal(feats[k], runs["none"][2][k]) for k in feats), name


def test_blocks_checkpoints_every_unet_seg_site_and_keeps_the_bits(stacks, monkeypatch):
    """remat_segments=True runs one segment per site the JAX UNet tags
    "unet_seg" (down units, the mid block, up units, each transformer
    block) and gives the plain forward's bits; without it no segment runs."""
    tm = stacks[3]
    calls = []

    def counting(fn, *args):
        calls.append(fn)
        return unet_mod.checkpoint(fn, *args, use_reentrant=False)

    monkeypatch.setattr(unet_mod, "checkpoint_segment", counting)
    args = _student_args(tm)
    plain = tm.unet(*args, capture_features=True)
    assert calls == []
    seg = tm.unet(*args, capture_features=True, remat_segments=True)
    cfg = tm.unet.config
    n_blocks = sum(len(t.transformer_blocks) for t in tm.unet.modules()
                   if isinstance(t, unet_mod.Transformer2D))
    units = cfg.num_blocks * cfg.layers_per_block + 1 + cfg.num_blocks * (cfg.layers_per_block + 1)
    assert len(calls) == units + n_blocks and n_blocks == 2 * 1 + 1 + 2 * 2
    assert torch.equal(seg[0], plain[0])
    assert all(torch.equal(seg[1][k], plain[1][k]) for k in plain[1])


def test_an_unknown_remat_policy_raises(stacks):
    with pytest.raises(ValueError, match="remat_policy"):
        kd.student_forward(dataclasses.replace(stacks[3], remat_policy="some"),
                           *_student_args(stacks[3]))


# --- the trainer ----------------------------------------------------------------------


def test_array_keys_are_the_jax_trainers():
    assert set(trainer.ARRAY_KEYS) == set(jax_trainer.ARRAY_KEYS)


def _mul_zh_stack():
    xlmr = dataclasses.replace(BERT_TINY, **dirs.XLMR_SETTINGS)
    return build_kd_models(
        family="mul_zh", text_cfg=(xlmr, BERT_TINY),
        adapter_cfg=AdapterConfig(2 * BERT_TINY.hidden_size, (128, 128, POOLED), head_dim=64),
        unet_cfg=UNetConfig(**MINI), vae_cfg=VAEConfig(**VAE8),
        teacher_cfgs=(CLIPTextConfig(**CLIP1), CLIPTextConfig(**CLIP2)),
        dtype=torch.float32, device="cpu", seed=3)


def test_fit_trains_a_mul_zh_stack(tmp_path):
    """KDTrainer.fit on the mul_zh towers (tiny XLM-R + Chinese-CLIP, an
    sdxl_concat-shaped adapter): the Chinese ids reach the concat tower,
    the losses are finite and the adapter moves."""
    tm = _mul_zh_stack()
    before = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    cfg = TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir=str(tmp_path),
                      log_every_n_steps=1, batch_size_per_device=B)

    def batches():
        for seed in range(2):
            b = _batch(seed)
            b["input_ids"][:, 0] = 0  # XLM-R's <s> (pad is 1)
            b["input_ids_zh"] = np.random.RandomState(seed + 9).randint(5, 1000, (B, T))
            b["input_ids_uncond_zh"] = np.zeros((B, T), np.int64)
            yield b

    KDTrainer(tm, cfg).fit(batches(), max_steps=2)
    recs = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in recs)
    assert any(not torch.equal(v, tm.adapter.state_dict()[k]) for k, v in before.items())


def _state(tr):
    out = {f"adapter.{k}": v.clone() for k, v in tr.models.adapter.state_dict().items()}
    out.update({f"grad.{k}": p.grad.clone() for k, p in tr.models.adapter.named_parameters()})
    for name, tree in tr.state.optimizer.items():
        for k, v in (tree.items() if isinstance(tree, dict) else [("", tree)]):
            out[f"opt.{name}.{k}"] = v.clone() if torch.is_tensor(v) else v
    return out


def test_warmup_leaves_the_train_state_bit_identical(stacks, tmp_path, capsys):
    """warmup over three buckets (micro-batch 1 at the buckets' shapes)
    after one fit step: the adapter, its .grad, the optimizer state,
    host_step and the metric log are exactly as they were."""
    tm = stacks[3]
    saved = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    cfg = TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir=str(tmp_path),
                      log_every_n_steps=1, batch_size_per_device=B)
    tr = KDTrainer(tm, cfg)
    tr.fit(iter([_batch(1)]), max_steps=1)
    for p in tm.adapter.parameters():
        p.grad = torch.randn_like(p)
    before, step = _state(tr), tr.host_step
    log = open(tmp_path / "metrics.jsonl").read()
    tr.warmup(1, T, TT, buckets=(0, 4, 8))
    after = _state(tr)
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert (torch.equal(after[k], v) if torch.is_tensor(v) else after[k] == v), k
    assert tr.host_step == step and open(tmp_path / "metrics.jsonl").read() == log
    text = capsys.readouterr().out
    assert "warmup: bucket 0 (448x896) ready" in text and "bucket 8 (896x448)" in text
    tm.adapter.load_state_dict(saved)
    for p in tm.adapter.parameters():
        p.grad = None


@pytest.mark.parametrize("window", [(1, 2), (2, 9)])
def test_profiler_window_writes_a_chrome_trace_on_the_cpu(stacks, tmp_path, window):
    """A window inside the run stops at its end step; one the run ends
    inside stops when fit returns. Either way a Chrome trace of the
    window's steps, with the KD step's ops in it."""
    tm = stacks[3]
    saved = {k: v.clone() for k, v in tm.adapter.state_dict().items()}
    cfg = TrainConfig(warmup_steps=0, warmup_ratio=0.0, output_dir=str(tmp_path),
                      log_every_n_steps=1, batch_size_per_device=B)
    tr = KDTrainer(tm, cfg, profile_window=window)
    tr.fit((_batch(s) for s in range(3)), max_steps=3)
    tm.adapter.load_state_dict(saved)
    path = tmp_path / "trace" / f"trace_steps_{window[0]}_{window[1]}.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names) and any("addmm" in n or "mm" == n for n in names)


# --- the CLI's real mode ---------------------------------------------------------------


def _bytes_to_unicode():
    """GPT-2's byte-level symbols (the CLIP tokenizer's alphabet)."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return [chr(c) for c in cs]


def _write_clip_dir(directory, module, cfg, with_projection):
    sd = {(k if k.startswith("text_projection") else f"text_model.{k}"): v
          for k, v in module.state_dict().items()}
    config = {"vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
              "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
              "intermediate_size": cfg.intermediate_size,
              "max_position_embeddings": cfg.max_position_embeddings,
              "hidden_act": cfg.hidden_act, "eos_token_id": cfg.eos_token_id}
    if with_projection:
        config["projection_dim"] = cfg.projection_dim
    dirs.write_component(directory, config, sd, name="model")


def _write_clip_tokenizer(directory):
    """A 514-entry byte-level vocabulary (the 256 symbols, their </w> forms,
    the two specials) and no merges: each byte of a word is one token."""
    symbols = _bytes_to_unicode()
    vocab = {s: i for i, s in enumerate(symbols + [s + "</w>" for s in symbols]
                                         + ["<|startoftext|>", "<|endoftext|>"])}
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n")


def _write_shards(root, sizes=((560, 1120), (560, 1040), (640, 960), (720, 880), (800, 800),
                                (880, 720), (960, 640), (1040, 560), (1120, 560))):
    """Two shards, an image of each of `sizes` a shard (by default one in
    each of the nine buckets, 1.25x the bucket's sides), parallel captions."""
    for s in range(2):
        with tarfile.open(os.path.join(root, f"{s:05d}.tar"), "w") as tf:
            for i, (w, h) in enumerate(sizes):
                yy, xx = np.mgrid[0:h, 0:w]
                img = Image.fromarray(np.stack([(xx // 3) % 256, (yy // 2) % 256,
                                                (xx + yy + 40 * i) % 256], -1).astype(np.uint8))
                buf = io.BytesIO()
                img.save(buf, "JPEG", quality=80)
                meta = {"caption_zh": "一只猫" if i % 2 else "一条狗",
                        "caption_en": "a cat" if i % 2 else "a dog",
                        "watermark": 0.1, "aesthetic_score": 7.0}
                for name, data in ((f"{s}{i:03d}.jpg", buf.getvalue()),
                                   (f"{s}{i:03d}.json", json.dumps(meta).encode())):
                    info = tarfile.TarInfo(name)
                    info.size = len(data)
                    tf.addfile(info, io.BytesIO(data))
    return os.path.join(root, "{00000..00001}.tar")


def _real_mode_args(tmp_path, monkeypatch):
    """The real mode's inputs written under tmp_path: a diffusers directory
    (the tiny SDXL UNet, a VAE 8x down, two CLIP teachers with byte-level
    tokenizers) and a Chinese-CLIP tower directory; returns the CLI's
    arguments without --urls and --batch-size."""
    clip1 = CLIPTextConfig(**dict(CLIP1, vocab_size=514, max_position_embeddings=77,
                                  eos_token_id=513))
    clip2 = CLIPTextConfig(**dict(CLIP2, vocab_size=514, max_position_embeddings=77,
                                  eos_token_id=513))
    unet_json = dict(dirs.SDXL_UNET_JSON)
    vae_json = dict(dirs.VAE_JSON, block_out_channels=[8, 8, 8, 8], layers_per_block=1)
    m = build_kd_models(family="chinese_clip", text_cfg=BERT_TINY,
                        adapter_cfg=AdapterConfig(64, (96, 64), head_dim=64),
                        unet_cfg=UNetConfig.from_diffusers_config(unet_json),
                        vae_cfg=VAEConfig.from_diffusers_config(vae_json),
                        teacher_cfgs=(clip1, clip2), dtype=torch.float32, device="cpu", seed=4)
    model_dir = dirs.write_model_dir(str(tmp_path / "sdxl"), unet_json, m.unet.state_dict(),
                                     m.vae.state_dict(), unet_shards=1)
    os.rename(os.path.join(model_dir, "vae", "config.json"), str(tmp_path / "c.json"))
    dirs.write_json(os.path.join(model_dir, "vae", "config.json"), vae_json)
    for name, module, cfg, proj in (("text_encoder", m.teacher_clip1, clip1, False),
                                    ("text_encoder_2", m.teacher_clip2, clip2, True)):
        _write_clip_dir(os.path.join(model_dir, name), module, cfg, proj)
    for name in ("tokenizer", "tokenizer_2"):
        _write_clip_tokenizer(os.path.join(model_dir, name))
    text_dir = dirs.write_text_dir(str(tmp_path / "cn_clip"), m.text_encoder.state_dict())
    monkeypatch.setitem(ADAPTER_PRESETS, "tiny", AdapterConfig(64, (96, 64), head_dim=64))
    return ["--model-dir", model_dir, "--text-encoder-dir", text_dir, "--adapter-preset",
            "tiny", "--num-workers", "2", "--max-length", "8", "--device", "cpu",
            "--every-n-steps", "1", "--log-every", "1"]


def test_cli_real_mode_trains_from_shards_and_resumes(tmp_path, capsys, monkeypatch):
    """--model-dir (a diffusers directory written here: the tiny SDXL UNet,
    a VAE 8x down, two CLIP teachers with byte-level tokenizers), a
    Chinese-CLIP tower directory, webdataset shards: 2 steps, then a rerun
    to step 3 that resumes from the step-2 checkpoint."""
    out = str(tmp_path / "run")
    args = _real_mode_args(tmp_path, monkeypatch) + [
        "--urls", _write_shards(str(tmp_path)), "--batch-size", "2", "--output", out]
    train_cli.main(args + ["--steps", "2"])
    text = capsys.readouterr().out
    assert "done at step 2" in text
    assert os.path.exists(os.path.join(out, "proj_2", "pytorch_model.bin"))
    train_cli.main(args + ["--steps", "3"])
    text = capsys.readouterr().out
    assert "resumed from step 2" in text and "done at step 3" in text
    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in recs)


def test_cli_real_mode_defaults_to_batches_of_10(tmp_path, monkeypatch):
    """Without --batch-size the real mode batches 10 rows (the JAX CLI's
    default), resolved before the data pipeline is built: twelve images of
    one bucket, the trainer handed the stream and the config."""
    from types import SimpleNamespace

    from pea_diffusion_tpu_torch.train import trainer as trainer_mod

    seen = {}

    class Trainer:
        def __init__(self, models, cfg, profile_window=None):
            seen["batch_size"] = cfg.batch_size_per_device

        def resume(self):
            return 0

        def fit(self, batches, max_steps=None):
            seen["rows"] = next(iter(batches))["pixel_values"].shape[0]
            return SimpleNamespace(step=0)

    monkeypatch.setattr(trainer_mod, "KDTrainer", Trainer)
    shards = tmp_path / "shards"
    shards.mkdir()
    urls = _write_shards(str(shards), sizes=[(800, 800)] * 6)
    train_cli.main(_real_mode_args(tmp_path, monkeypatch) + [
        "--urls", urls, "--steps", "1", "--output", str(tmp_path / "run")])
    assert seen == {"batch_size": 10, "rows": 10}


@pytest.mark.parametrize("argv,message", [
    (["--text-encoder-dir", "t", "--urls", "u.tar"], "--model-dir required without --demo"),
    (["--model-dir", "m", "--urls", "u.tar"], "--text-encoder-dir required without --demo"),
    (["--model", "sd15", "--model-dir", "m", "--text-encoder-dir", "t"], "trains SDXL"),
    (["--model-dir", "m", "--text-encoder-dir", "t", "--family", "mul_zh", "--urls", "u"],
     "--text-encoder-dir-2"),
])
def test_cli_real_mode_argument_errors(argv, message, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


# --- chip_smoke.py's shards phase ---------------------------------------------------------


def test_smoke_shards_walk_has_kernel_rows_per_bucket():
    """The shards path's warmup and fit steps at its four buckets: each
    kernel call of the walk at the buckets' (h, w) latents has a forward
    row (and for the student a backward row), level 1 runs at S = 1456,
    1536, 1568 and 1600, and the square form of the walk is the (h, w)
    form at h = w."""
    import chip_smoke
    from pea_diffusion_tpu_torch.configs import SDXL_UNET
    from pea_diffusion_tpu_torch.data.buckets import BUCKETS
    from pea_diffusion_tpu_torch.models import UNet2DCondition

    with torch.device("meta"):
        unet = UNet2DCondition(SDXL_UNET)
    fwd, bwd = chip_smoke.forward_cases(), chip_smoke.backward_cases()
    student, teacher = set(), set()
    for b in chip_smoke.SHARD_BUCKETS:
        w, h = BUCKETS[b]
        for skv, keys in ((chip_smoke.TEXT_TOKENS, student), (chip_smoke.TEACHER_TOKENS, teacher)):
            keys |= {k for k in chip_smoke.attention_routes(unet, (h // 8, w // 8), skv)
                     if k[0] != "plain"}
    assert {k[1] for k in student} == {1456, 1536, 1568, 1600}
    for path in (chip_smoke.SHARDS_PATH, chip_smoke.SHARDS_WARMUP):
        assert student | teacher == {r[7][path] for r in fwd if path in r[7]}, path
        assert student == {r[4][path] for r in bwd if path in r[4]}, path
    assert chip_smoke.attention_routes(unet, 80, 52) == chip_smoke.attention_routes(
        unet, (80, 80), 52)


def test_smoke_shards_give_one_batch_a_bucket_without_the_filtered(tmp_path, monkeypatch):
    """chip_smoke.py's shards through one pass of make_train_iterator at
    micro-batch 10: four batches, one a bucket, each with both zh_or_not
    values, none of the filtered captions, read by the native reader."""
    import chip_smoke
    from pea_diffusion_tpu_torch.configs import DataConfig
    from pea_diffusion_tpu_torch.data import wds_reader
    from pea_diffusion_tpu_torch.data.pipeline import make_train_iterator

    url, filtered = chip_smoke.write_shards(tmp_path / "shards")
    tokenize, teacher = chip_smoke.shard_tokenizers()
    monkeypatch.setattr(wds_reader.sample_stream, "samples", {"native": 0, "python": 0})
    cfg = DataConfig(urls=(url,), batch_size=chip_smoke.SHARDS_BATCH,
                     num_workers=chip_smoke.SHARDS_WORKERS)
    batches = list(make_train_iterator(cfg, tokenize, teacher, epochs=1))
    assert sorted(int(b["bucket_id"]) for b in batches) == sorted(chip_smoke.SHARD_BUCKETS)
    for b in batches:
        assert sorted(set(b["zh_or_not"].tolist())) == [0.0, 1.0]
        assert not filtered & set(b["prompts"]) and len(b["prompts"]) == 10
        assert b["input_ids"].shape == (10, 52) and b["teacher_ids_2"].shape == (10, 77)
    assert wds_reader.sample_stream.samples == {"native": 48, "python": 0}
