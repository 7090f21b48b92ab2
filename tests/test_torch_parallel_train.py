"""The port's data-parallel and FSDP KD training (parallel/mesh.py,
train/trainer.py's mesh, train/kd.py's shared draws, cli/train.py's
--coordinator/--num-processes/--process-id) on spawned gloo ranks on the
CPU (tests/_torch_dist.py), held against the one-process step and the JAX
package's.

- data = 2, and separately fsdp = 2: the adapter gradient of a 2-rank
  kd_loss on the JAX package's draws (after the reduce) against JAX's
  gradient on the 4-row batch (1e-4, tests/test_torch_train.py's
  tolerance), and one trainer step on the global batch from the shared
  generator against the one-process step: the adapter and the optimizer's
  moments within 1e-5 of their largest magnitude, fp32.
- The train CLI on two processes at a coordinator address takes 2 steps,
  rank 0 alone logging and checkpointing, and trains the adapter a
  one-process run takes on the same 4-row demo stream.
- make_mesh / make_hybrid_mesh shapes and the rows each of 4 ranks keeps
  (tests/test_optim_mesh.py's checks in JAX).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import free_port, kd_train_config, run_ranks
from _torch_parity import host_params, one_torch_thread  # noqa: F401
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as J_BERT_TINY
from pea_diffusion_tpu.configs.text_encoder import CLIPTextConfig as JCLIPTextConfig
from pea_diffusion_tpu.configs.train import TrainConfig as JTrainConfig
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as J_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as J_VAE_TINY
from pea_diffusion_tpu.models.adapter import PEAAdapter as JPEAAdapter
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JBert
from pea_diffusion_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from pea_diffusion_tpu.models.unet import UNet2DCondition as JUNet
from pea_diffusion_tpu.models.vae import AutoencoderKL as JVAE
from pea_diffusion_tpu.schedulers import SDXL_SCHEDULE as J_SDXL_SCHEDULE
from pea_diffusion_tpu.train import kd as jax_kd
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.configs import (BERT_TINY, SDXL_UNET_TINY, VAE_TINY,
                                             AdapterConfig, CLIPTextConfig)
from pea_diffusion_tpu_torch.pipelines.factory import build_kd_models
from pea_diffusion_tpu_torch.train import kd
from pea_diffusion_tpu_torch.train.trainer import KDTrainer

B, T, TT, IMG = 4, 12, 16, 32
POOLED = 64
CLIP1 = dict(vocab_size=500, hidden_size=24, num_layers=2, num_heads=2,
             intermediate_size=48, max_position_embeddings=TT, eos_token_id=499)
CLIP2 = dict(vocab_size=500, hidden_size=40, num_layers=2, num_heads=2,
             intermediate_size=64, projection_dim=POOLED,
             max_position_embeddings=TT, eos_token_id=499, hidden_act="gelu")
GRAD_ATOL = 1e-4  # tests/test_torch_train.py's JAX-vs-port adapter gradient tolerance
STEP_RTOL = 1e-5  # N ranks vs one process, of the largest magnitude
BUILD = dict(family="chinese_clip", text_cfg=BERT_TINY,
             adapter_cfg=AdapterConfig(BERT_TINY.hidden_size, (96, POOLED),
                                       head_dim=SDXL_UNET_TINY.cross_attention_dim),
             unet_cfg=SDXL_UNET_TINY, vae_cfg=VAE_TINY,
             teacher_cfgs=(CLIPTextConfig(**CLIP1), CLIPTextConfig(**CLIP2)))


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


def _jax_draws(key):
    """kd_loss's draws from `key`, as the JAX package makes them."""
    r_noise, r_offset, r_t, r_cfg, r_vae = jax.random.split(key, 5)
    f = 2 ** (len(J_VAE_TINY.block_out_channels) - 1)
    shape = (B, IMG // f, IMG // f, 4)
    d = {"vae_eps": jax.random.normal(r_vae, shape, jnp.float32),
         "noise": jax.random.normal(r_noise, shape, jnp.float32),
         "offset_noise": jax.random.normal(r_offset, (B, 1, 1, 4), jnp.float32),
         "timesteps": jax.random.randint(r_t, (B,), 0, 1000),
         "cfg_uniform": jax.random.uniform(r_cfg, (B, 1, 1))}
    return {k: np.array(v) for k, v in d.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The tiny KD stack's weights (numpy, from JAX), JAX's adapter gradient
    on the 4-row batch and its draws, and the port's one-process trainer
    step on that batch."""
    enc = JBert(J_BERT_TINY)
    jm = jax_kd.KDModels(
        adapter=JPEAAdapter(JAdapterConfig(BERT_TINY.hidden_size, (96, POOLED),
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
        "vae": host_params(jm.vae, jnp.zeros((1, IMG, IMG, 3)), jax.random.PRNGKey(0), seed=3),
        "teacher_clip1": host_params(jm.teacher_clip1, tids, seed=4),
        "teacher_clip2": host_params(jm.teacher_clip2, tids, seed=5),
    }
    adapter_params = host_params(jm.adapter, jnp.zeros((1, T, BERT_TINY.hidden_size)), seed=6)
    batch, key = _batch(), jax.random.PRNGKey(0)
    fn = jax.jit(jax.value_and_grad(
        lambda p, bt, k: jax_kd.kd_loss(p, jm, frozen, JTrainConfig(cfg_dropout=0.5), bt, k),
        has_aux=True))
    _, grads = fn(adapter_params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jax_grads = from_jax.adapter_state_dict(jax.tree.map(np.asarray, grads))
    state = {
        "text_encoder": from_jax.bert_text_state_dict(frozen["text"]),
        "unet": from_jax.unet_state_dict(frozen["unet"], SDXL_UNET_TINY),
        "vae": from_jax.vae_state_dict(frozen["vae"], VAE_TINY),
        "teacher_clip1": from_jax.clip_text_state_dict(frozen["teacher_clip1"]),
        "teacher_clip2": from_jax.clip_text_state_dict(frozen["teacher_clip2"]),
        "adapter": from_jax.adapter_state_dict(adapter_params),
    }
    tm = build_kd_models(**BUILD, dtype=torch.float32, device="cpu", vae_encode_chunk=None)
    for name, sd in state.items():
        getattr(tm, name).load_state_dict(sd)
    names = [k for k, _ in tm.adapter.named_parameters()]
    trainer = KDTrainer(tm, kd_train_config(str(tmp_path_factory.mktemp("one"))))
    trainer.fit([batch], max_steps=1)
    return {"state": {n: {k: v.numpy() for k, v in sd.items()} for n, sd in state.items()},
            "batch": batch, "draws": _jax_draws(key),
            "jax_grads": kd._flatten({k: jax_grads[k] for k in names}).numpy(),
            "adapter": {k: v.numpy() for k, v in tm.adapter.state_dict().items()},
            "optimizer": trainer.state.optimizer, "consumed": trainer.consumed_samples}


def _close_of_max(got, want, rtol=STEP_RTOL):
    """Two {name: array} dicts within `rtol` of the largest magnitude over
    all of `want`."""
    assert sorted(got) == sorted(want)
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in sorted(want)])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel() for k in sorted(want)])
    assert np.abs(g - w).max() <= rtol * np.abs(w).max()


@pytest.mark.parametrize("mesh_shape,rows", [((2, 1), 2), ((1, 2), 4)], ids=["data2", "fsdp2"])
def test_two_rank_kd_step_is_the_global_batch_step(reference, mesh_shape, rows, tmp_path):
    """Two ranks over (data, fsdp) = `mesh_shape`: the reduced adapter
    gradient on JAX's draws equals JAX's on the 4-row batch; one trainer
    step on the global batch (every rank draws the global randoms from the
    shared generator and keeps its rows) equals the one-process step;
    consumed_samples counts every data rank; the UNet is under FSDP2 at
    fsdp 2 and unwrapped at fsdp 1 (the JAX rule replicates); rank 0 alone
    wrote the metric log."""
    ref = reference
    results = run_ranks("kd_step", 2, mesh_shape, BUILD, ref["state"], ref["batch"],
                        ref["draws"], str(tmp_path))
    for r in results:
        assert r["rows"] == rows and r["fsdp"] == (mesh_shape[1] > 1)
        np.testing.assert_allclose(r["grads"], ref["jax_grads"], atol=GRAD_ATOL, rtol=0)
        _close_of_max(r["adapter"], ref["adapter"])
        opt = r["optimizer"]
        assert opt["count"] == ref["optimizer"]["count"] == 1
        for moment in ("mu", "nu"):
            _close_of_max(opt[moment], {k: v.numpy() for k, v in
                                        ref["optimizer"][moment].items()})
        assert r["consumed"] == ref["consumed"] == B
    np.testing.assert_array_equal(results[0]["grads"], results[1]["grads"])
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["consumed_samples"] == B


def test_train_cli_two_processes_at_a_coordinator(tmp_path):
    """cli/train.py --demo on two processes (--coordinator, --num-processes,
    --process-id): 2 steps of 2 rows a rank, rank 0's log and checkpoint,
    and the adapter of a one-process run with --batch-size 4 (the same
    global demo stream)."""
    from pea_diffusion_tpu_torch.cli import train as train_cli

    argv = ["--demo", "--device", "cpu", "--steps", "2", "--lr", "1e-4"]
    run_ranks("train_cli", 2, argv + ["--batch-size", "2", "--output", str(tmp_path / "two"),
                                      "--coordinator", f"127.0.0.1:{free_port()}",
                                      "--num-processes", "2"], init=False)
    train_cli.main(argv + ["--batch-size", "4", "--output", str(tmp_path / "one")])
    recs = [json.loads(x) for x in (tmp_path / "two" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2]
    assert [r["consumed_samples"] for r in recs] == [4, 8]
    one = torch.load(tmp_path / "one" / "checkpoints" / "step_2.pt", weights_only=True)
    two = torch.load(tmp_path / "two" / "checkpoints" / "step_2.pt", weights_only=True)
    assert two["step"] == 2
    _close_of_max({k: v.numpy() for k, v in two["adapter"].items()},
                  {k: v.numpy() for k, v in one["adapter"].items()})
    assert (tmp_path / "two" / "proj_2" / "pytorch_model.bin").exists()


def test_meshes_and_the_rows_each_rank_keeps():
    """Four ranks: make_mesh and make_hybrid_mesh's names and shapes (the
    JAX tests/test_optim_mesh.py checks), each rank's index over dcn x data
    and its rows of a 16-row batch, contiguous, and with accum 2 its block
    of each micro-batch; the adapter gradient's group spans the data
    indices (dcn x data)."""
    x = np.arange(16)
    res = run_ranks("meshes", 4, {"x": x})
    shapes = {k: v[:2] for k, v in res[0].items()}
    assert shapes == {"data": (("data", "fsdp"), (4, 1)), "fsdp": (("data", "fsdp"), (2, 2)),
                      "hybrid": (("dcn", "data", "fsdp"), (2, 2, 1)),
                      "hybrid_fsdp": (("dcn", "data", "fsdp"), (2, 1, 2))}
    for rank, r in enumerate(res):
        for name, n, index in (("data", 4, rank), ("fsdp", 2, rank // 2),
                               ("hybrid", 4, rank), ("hybrid_fsdp", 2, rank // 2)):
            assert r[name][2] == (index, n) and r[name][5] == n, (name, rank)
            lb = 16 // n
            assert r[name][3].tolist() == list(range(index * lb, (index + 1) * lb))
            half = 8 // n
            assert r[name][4].tolist() == (list(range(index * half, (index + 1) * half))
                                           + list(range(8 + index * half, 8 + (index + 1) * half)))
