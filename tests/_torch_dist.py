"""Spawned gloo ranks on the CPU for the port's multi-process tests
(tests/test_torch_parallel*.py), and the functions the ranks run.

This module imports torch and the port only (no JAX): each rank is a fresh
``spawn`` process that imports it, joins a gloo process group through
``parallel.distributed.initialize`` on a free localhost port, runs one
function on one torch thread and hands its result (numpy) back through a
queue. A rank that raises, dies or outlives `timeout` fails the call.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import traceback
from types import SimpleNamespace

import numpy as np
import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_numpy(v) for v in x)
    return x


def _entry(fn_name, rank, world, port, args, q, init):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        from pea_diffusion_tpu_torch.parallel import initialize

        if init:
            initialize(device="cpu")
        out = globals()[fn_name](rank, world, *args)
        q.put((rank, "ok", _numpy(out)))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        q.put((rank, "error", traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn_name: str, world: int, *args, timeout: float = 120.0, init: bool = True):
    """[result of rank 0, rank 1, ...] of ``fn_name(rank, world, *args)``
    (a function of this module) in `world` spawned gloo ranks; with `init`
    False the function starts the process group itself (torchrun's
    environment is set)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(fn_name, r, world, port, args, q, init),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            try:
                rank, status, out = q.get(timeout=timeout)
            except queue_mod.Empty:
                raise TimeoutError(f"{fn_name}: a rank gave no result in {timeout} s")
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    finally:
        for p in procs:
            p.join(5 if not errors else 0.1)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


# --- what the ranks run -------------------------------------------------------


def tp_unet_forward(rank, world, cases):
    """For each case (UNet config, state dict, conv_quant, inputs: sample,
    timesteps, context, added; nudged inputs or None) the UNet sharded at
    tp = world: its output, the all_reduce count of that forward, the
    local leaves' shapes, and its output on the nudged inputs (or None)."""
    from pea_diffusion_tpu_torch.models.unet import UNet2DCondition
    from pea_diffusion_tpu_torch.parallel import tp

    mesh = tp.make_tp_mesh((1, world))
    out = []
    for cfg, state_dict, conv_quant, inputs, nudged in cases:
        unet = UNet2DCondition(cfg, conv_quant=conv_quant)
        unet.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
        tp.shard_bundle_for_tp(SimpleNamespace(unet=unet), mesh)

        def run(x):
            sample, t, context = (torch.as_tensor(x[k]) for k in ("sample", "t", "context"))
            added = {k: torch.as_tensor(v) for k, v in x["added"].items()}
            with torch.no_grad():
                return unet(sample, t, context, added)

        tp.reset_collectives()
        y = run(inputs)
        n = tp.COLLECTIVES["all_reduce"]
        out.append((y, n, {k: tuple(v.shape) for k, v in unet.state_dict().items()},
                    None if nudged is None else run(nudged)))
    return out


def generate_cli(rank, world, argv):
    """cli/generate.py's main on every rank (it starts the process group)."""
    from pea_diffusion_tpu_torch.cli import generate

    generate.main(argv)


def _serve_main(argv, serve_forever):
    """cli/serve.py's main with its HTTP server replaced by one whose
    serve_forever is ``serve_forever(engine)``."""
    from pea_diffusion_tpu_torch.cli import serve

    class Server:
        def __init__(self, engine, port, default_steps):
            self.engine = engine

        def serve_forever(self):
            serve_forever(self.engine)

        def shutdown(self):
            pass

        def server_close(self):
            pass

    serve.make_server = Server
    serve.main(argv)


def serve_tp(rank, world, argv, requests):
    """cli/serve.py's main at --tp world: rank 0's server answers
    `requests` ((prompt, negative, steps, guidance, rescale, seed), one
    after another) and closes; the other ranks follow. Rank 0 returns the
    images, the others the count of calls they replayed."""
    from pea_diffusion_tpu_torch.cli import serve

    got = {}
    follow = serve.TPLink.follow

    def counted(link, run):
        got["replayed"] = follow(link, run)
        return got["replayed"]

    serve.TPLink.follow = counted
    _serve_main(argv, lambda engine: got.__setitem__(
        "images", [np.asarray(engine.submit(*r)) for r in requests]))
    return got["images"] if rank == 0 else got["replayed"]


def serve_tp_rank_fails(rank, world, argv, requests, failing):
    """cli/serve.py's main at --tp world, where rank `failing` raises inside
    the first call's UNet forward (at its third resnet). Every rank returns
    what ended its main and when; rank 0 also each request's error and the
    seconds its submit took."""
    import time

    from pea_diffusion_tpu_torch.models import layers

    if rank == failing:
        forward, calls = layers.ResnetBlock2D.forward, []

        def boom(self, *a, **k):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError(f"injected failure on rank {rank}")
            return forward(self, *a, **k)

        layers.ResnetBlock2D.forward = boom
    got = {"submits": []}

    def serve_forever(engine):
        for r in requests:
            t0 = time.time()
            try:
                engine.submit(*r)
                err = None
            except RuntimeError as e:
                err = str(e)
            got["submits"].append((err, time.time() - t0))

    t0 = time.time()
    try:
        _serve_main(argv, serve_forever)
        got["ended"] = "returned"
    except BaseException as e:  # noqa: BLE001 -- what ended main is the result
        got["ended"] = f"{type(e).__name__}: {e}"
    got["seconds"] = time.time() - t0
    return got


def train_cli(rank, world, argv):
    """cli/train.py's main with --process-id rank (it starts the process
    group at the --coordinator address in `argv`)."""
    from pea_diffusion_tpu_torch.cli import train

    train.main(argv + ["--process-id", str(rank)])


def meshes(rank, world, batch):
    """Mesh shapes and this rank's rows of `batch` under each mesh:
    {name: (dim names, shape, batch_shards, rows of batch["x"], the same at
    accum 2, the size of the batch group)}."""
    import torch.distributed as dist

    from pea_diffusion_tpu_torch.parallel import make_hybrid_mesh, make_mesh, shard_batch
    from pea_diffusion_tpu_torch.parallel.mesh import batch_group, batch_shards

    out = {}
    for name, mesh in (("data", make_mesh((-1, 1))), ("fsdp", make_mesh((2, -1))),
                       ("hybrid", make_hybrid_mesh(2, (-1, 1))),
                       ("hybrid_fsdp", make_hybrid_mesh(2, (1, -1)))):
        out[name] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape), batch_shards(mesh),
                     shard_batch(batch, mesh)["x"], shard_batch(batch, mesh, accum=2)["x"],
                     dist.get_world_size(batch_group(mesh)))
    return out


def _kd_models(build: dict, state: dict):
    from pea_diffusion_tpu_torch.pipelines.factory import build_kd_models

    tm = build_kd_models(**build, dtype=torch.float32, device="cpu", vae_encode_chunk=None)
    for name, sd in state.items():
        getattr(tm, name).load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return tm


def kd_train_config(out_dir: str):
    """The KD steps' config: cfg dropout 0.5 (some rows take the
    unconditional states), no warmup, so that the first update moves the
    adapter, at a learning rate of 1e-4."""
    from pea_diffusion_tpu_torch.configs.train import TrainConfig

    return TrainConfig(cfg_dropout=0.5, warmup_steps=0, warmup_ratio=0.0, learning_rate=1e-4,
                       output_dir=out_dir, every_n_steps=1, log_every_n_steps=1)


def kd_step(rank, world, mesh_shape, build, state, batch, draws, out_dir):
    """One KD stack (`build` kwargs of build_kd_models, module state dicts)
    over the (data, fsdp) mesh `mesh_shape`: the adapter gradient of the
    global `batch` on the given `draws` (this rank's rows, averaged over the
    data ranks), then one trainer step on the global batch from the shared
    generator: {grads (flat), adapter, optimizer, consumed_samples, fsdp}."""
    import torch.distributed as dist

    from pea_diffusion_tpu_torch.parallel import make_mesh, shard_batch
    from pea_diffusion_tpu_torch.parallel.mesh import batch_group
    from pea_diffusion_tpu_torch.train import kd
    from pea_diffusion_tpu_torch.train.trainer import KDTrainer

    tm = _kd_models(build, state)
    cfg = kd_train_config(out_dir)
    mesh = make_mesh(tuple(mesh_shape))
    trainer = KDTrainer(tm, cfg, mesh=mesh)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    local = shard_batch(tb, mesh)
    ldraws = shard_batch({k: torch.as_tensor(v) for k, v in draws.items()}, mesh)
    loss, _ = kd.kd_loss(tm, cfg, local, draws=ldraws)
    names = [k for k, p in tm.adapter.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.adapter.parameters()))
    flat = kd._flatten(dict(zip(names, grads)))
    dist.all_reduce(flat, group=batch_group(mesh))
    flat /= trainer.data_shard[1]
    trainer.fit([batch], max_steps=1)
    fsdp = type(tm.unet).__name__.startswith("FSDP")
    return {"grads": flat, "adapter": tm.adapter.state_dict(),
            "optimizer": trainer.state.optimizer, "consumed": trainer.consumed_samples,
            "rows": local["pixel_values"].shape[0], "fsdp": fsdp}
