"""Serving daemon of the PyTorch port (port of
``pea_diffusion_tpu/cli/serve.py``): an HTTP server in the standard library
that co-batches concurrent requests.

POST /generate {"prompt", "negative_prompt", "steps", "guidance",
"guidance_rescale", "seed"} answers a PNG; GET /healthz answers status,
requests served, uptime and the engine's co-batching counters. An error is
a 400 with a JSON body {"error": ...}; any other path a 404.

Requests that arrive within --batch-window-ms of each other (up to
--max-batch) run as one pipeline call: grouped by `steps`, padded to a power
of two, with per-request guidance as a [B] vector when the group's values
differ. Each request's initial latents come from its own seed
(numpy's RandomState, the JAX engine's draws bit for bit), so co-batching
does not change a request's noise. Its image can still move by rounding:
the UNet's GroupNorm picks its form by batch size (grouped up to 2 rows,
per-channel sums from 3; PEA_GN_GROUPED=1/0 pins one) and the GEMMs' shapes
change with the batch.

  python -m pea_diffusion_tpu_torch.cli.serve --demo --device cpu --port 8471
  curl -X POST localhost:8471/generate -d '{"prompt": "一只猫"}' > out.png
  python -m pea_diffusion_tpu_torch.cli.serve --demo-full --max-batch 8
  python -m pea_diffusion_tpu_torch.cli.serve --demo-full --quant int8 \
      --calib-ranges ranges.json --aot-cache aot

--quant int8[:scopes] quantizes the UNet's in-scope convs (and under vae the
VAE decoder's) at start-up, calibrated on --calib-prompt, the ranges read
from or written to --calib-ranges (quant/int8.py). --aot-cache DIR keeps the
compiled kernel library under DIR; --no-compile-cache builds it into a
temporary directory; by default it is built into the checkout's build/
(utils/startup.py).

--tp N serves the UNet Megatron-sharded over N ranks (parallel/tp.py), under
``torchrun --nproc-per-node N -m pea_diffusion_tpu_torch.cli.serve ... --tp
N``. Rank 0 runs the HTTP server and the engine; for each engine call it
broadcasts the call's spec (ids, guidance, steps, size and seeds) over a CPU
gloo group, and the other ranks replay the call (the noise is numpy from
the seeds, so every rank makes it) and drop the images, until ``close()``
sends a stop; a barrier ends each call. A failure inside a call is fatal to
the group, since the ranks' collectives are out of step after it: a
follower that fails exits non-zero, and its closed connections fail rank
0's pending collective at once; rank 0 then fails the call and every queued
request, stops the server and exits non-zero, which in turn fails the
pending collective of every follower still waiting. (A pending NCCL
collective does not see a peer's exit; there torchrun, which launches the
ranks, ends the others when one exits non-zero, and the collective's
timeout, ``parallel.distributed.TIMEOUT``, bounds the wait.)
"""
from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
import traceback
from typing import Optional
from http.server import BaseHTTPRequestHandler, HTTPServer
from socketserver import ThreadingMixIn

import numpy as np
import torch
import torch.distributed as dist

from ..utils.trace import span


def request_noise(seed: int, n: int, latent: int) -> np.ndarray:
    """A request's initial latents [n, latent, latent, 4] from its seed."""
    rs = np.random.RandomState(seed & 0x7FFFFFFF)
    return rs.standard_normal((n, latent, latent, 4)).astype(np.float32)


def run_spec(pipe, spec: dict, size: int, latent: int):
    """One engine call from its spec: {"ids", "uncond" (token ids), "steps",
    "guidance", "rescale", "seeds": [(seed, rows), ...]}."""
    noise = np.concatenate([request_noise(s, n, latent) for s, n in spec["seeds"]])
    return pipe(spec["ids"], spec["uncond"], height=size, width=size,
                num_steps=spec["steps"], guidance_scale=spec["guidance"],
                guidance_rescale=spec["rescale"], init_noise=noise)


class TPLink:
    """The ranks' link for tensor-parallel serving: a CPU gloo group (made
    by every rank, in the same order) that carries each call's spec from
    rank 0 and the barrier that ends the call. An exception inside a call
    leaves the ranks out of step: the caller ends the group (see the
    module's docstring)."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo")
        self.calls = 0

    def lead(self, run, spec: dict):
        """Rank 0: sends `spec`, then runs the call with the others."""
        dist.broadcast_object_list([spec], src=0, group=self.group)
        out = run()
        dist.barrier(group=self.group)
        self.calls += 1
        return out

    def stop(self):
        dist.broadcast_object_list([None], src=0, group=self.group)

    def follow(self, run) -> int:
        """A rank above 0: runs `run(spec)` for each spec rank 0 sends,
        dropping the result, until the stop; returns the calls replayed.
        An exception propagates: the caller exits."""
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.group)
            if box[0] is None:
                return self.calls
            run(box[0])
            dist.barrier(group=self.group)
            self.calls += 1


class BatchingEngine:
    """Collects concurrent requests into one padded pipeline call.

    submit() blocks the calling handler thread until its image is ready. One
    worker thread owns the pipeline and runs every operation on the card
    (under inference mode, on the pipeline's device). Only `steps` splits a
    drain cycle into separate calls; guidance and rescale are per-request [B]
    operands (``pipelines/text2image.py::cfg_combine``), so mixed-CFG
    requests share one call. A uniform group passes scalars.

    Under tensor parallelism (`tp`) a failed call stops the engine: the
    call's requests, the queued ones and every later submit get the error,
    ``failed`` holds it and ``on_failure`` (if set) is called once."""

    def __init__(self, pipe, tokenize, size, max_batch=8, window_ms=150,
                 latent_factor=8, tp: Optional[TPLink] = None):
        self.pipe, self.tokenize, self.size, self.tp = pipe, tokenize, size, tp
        self.max_batch, self.window = max_batch, window_ms / 1000.0
        self.latent = size // latent_factor
        # /healthz "engine": pipeline calls against requests show co-batching
        self.stats = {"device_calls": 0, "requests_batched": 0,
                      "vector_cfg_calls": 0, "batch_hist": {}}
        self._lock = threading.Lock()
        self.failed: Optional[str] = None
        self.on_failure = None
        # the worker runs on the pipeline's card (a bare "cuda": the caller's)
        device = torch.device(getattr(getattr(pipe, "models", None), "device", "cpu"))
        self._cuda_index = None
        if device.type == "cuda":
            self._cuda_index = (torch.cuda.current_device() if device.index is None
                                else device.index)
        self.q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, prompt, negative, steps, guidance, rescale, seed):
        done, slot = threading.Event(), {}
        with self._lock:  # the queue takes nothing after a failure stopped the worker
            if self.failed is not None:
                raise RuntimeError(self.failed)
            self.q.put(((steps, guidance, rescale),
                        (prompt, negative, int(seed)), done, slot))
        done.wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["img"]

    def stats_snapshot(self) -> dict:
        """A copy of `stats`, taken while the worker cannot change it."""
        with self._lock:
            return json.loads(json.dumps(self.stats))

    def close(self, timeout=None):
        """Stops the worker after the requests queued before this call (and
        under tensor parallelism, the other ranks after it)."""
        self.q.put(None)
        self._thread.join(timeout)
        if self.tp is not None and self.failed is None and not self._thread.is_alive():
            self.tp.stop()

    def _noise(self, seed, n):
        return request_noise(seed, n, self.latent)

    def run(self, spec: dict):
        """One call of the pipeline from its spec (see `run_spec`)."""
        rows = sum(n for _, n in spec["seeds"])
        with span("engine.call", str(rows)):
            return run_spec(self.pipe, spec, self.size, self.latent)

    def _worker(self):
        from ..pipelines.text2image import to_pil

        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        with torch.inference_mode():
            while self._drain(to_pil):
                pass

    def _drain(self, to_pil) -> bool:
        """One drain cycle: the first request, then whatever arrives within
        the window (up to max_batch), run group by group. False on close."""
        with span("engine.refill_wait"):
            first = self.q.get()
        if first is None:
            return False
        batch = [first]
        deadline = time.time() + self.window
        stop = False
        with span("engine.batch_window"):
            while len(batch) < self.max_batch:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    item = self.q.get(timeout=left)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                    break
                batch.append(item)
        groups: dict = {}
        for item in batch:
            groups.setdefault(item[0][0], []).append(item)  # by steps
        for steps, items in groups.items():
            if self.failed is not None:
                break
            try:
                with span("engine.prepare"):
                    spec, n, guidance = self._spec(steps, items)
                out = (self.run(spec) if self.tp is None
                       else self.tp.lead(lambda: self.run(spec), spec))
                with span("engine.to_pil"):
                    imgs = to_pil(out)
                with self._lock:
                    st = self.stats
                    st["device_calls"] += 1
                    st["requests_batched"] += n
                    st["vector_cfg_calls"] += int(not isinstance(guidance, float))
                    st["batch_hist"][str(n)] = st["batch_hist"].get(str(n), 0) + 1
                for it, img in zip(items, imgs):
                    it[3]["img"] = img
            except Exception as e:  # every submitter hears; one process keeps serving
                traceback.print_exc()
                for it in items:
                    it[3]["error"] = f"{type(e).__name__}: {e}"
                if self.tp is not None:
                    with self._lock:
                        self.failed = f"tensor-parallel serving stopped: {type(e).__name__}: {e}"
            finally:
                for it in items:
                    it[2].set()
        if self.failed is not None:
            self._stop_after_failure(batch)
            return False
        return not stop

    def _spec(self, steps, items):
        """The call spec of one group of requests (see `run_spec`): prompts
        padded to a power of two with row 0's, tokenised, with per-row
        guidance where the group's values differ. Returns (spec, requests,
        guidance)."""
        n = len(items)
        padded = 1 << (n - 1).bit_length()  # a power of two
        prompts = [it[1][0] for it in items]
        negatives = [it[1][1] for it in items]
        prompts += [prompts[0]] * (padded - n)
        negatives += [negatives[0]] * (padded - n)
        seeds = [(it[1][2], 1) for it in items]
        if padded > n:
            seeds.append((0, padded - n))
        # pad rows reuse row 0's CFG, so do_cfg is unaffected
        gs = [it[0][1] for it in items] + [items[0][0][1]] * (padded - n)
        rs = [it[0][2] for it in items] + [items[0][0][2]] * (padded - n)
        guidance = gs[0] if len(set(gs)) == 1 else np.asarray(gs, np.float32)
        rescale = rs[0] if len(set(rs)) == 1 else np.asarray(rs, np.float32)
        spec = {"ids": self.tokenize(prompts), "uncond": self.tokenize(negatives),
                "steps": steps, "guidance": guidance, "rescale": rescale, "seeds": seeds}
        return spec, n, guidance

    def _stop_after_failure(self, batch):
        """Fails the drain cycle's unanswered requests and the queued ones,
        then calls on_failure."""
        left = [it for it in batch if not it[2].is_set()]
        with self._lock:
            while True:
                try:
                    item = self.q.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    left.append(item)
        for it in left:
            it[3]["error"] = self.failed
            it[2].set()
        if self.on_failure is not None:
            self.on_failure()


class _ThreadingHTTPServer(ThreadingMixIn, HTTPServer):
    daemon_threads = True


def make_server(engine: BatchingEngine, port: int, default_steps: int,
                host: str = "0.0.0.0") -> HTTPServer:
    """The HTTP front end over `engine`, bound to (host, port) (port 0: any
    free port, read back from ``server_address``). Each connection gets a
    thread that blocks in ``engine.submit`` while the engine co-batches;
    run it with ``serve_forever()`` and stop it with ``shutdown()`` and
    ``server_close()``."""
    stats = {"requests": 0, "started": time.time()}
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            with lock:
                served = stats["requests"]
            self._send(200, "application/json", json.dumps({
                "status": "ok", "requests": served,
                "uptime_s": round(time.time() - stats["started"], 1),
                "engine": engine.stats_snapshot(),
            }).encode())

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompt = req.get("prompt", "")
                if not prompt:
                    raise ValueError("missing 'prompt'")
                img = engine.submit(
                    prompt, req.get("negative_prompt", ""),
                    int(req.get("steps", default_steps)),
                    float(req.get("guidance", 7.5)),
                    float(req.get("guidance_rescale", 0.0)),
                    int(req.get("seed", 0)))
                buf = io.BytesIO()
                img.save(buf, "PNG")
                with lock:
                    stats["requests"] += 1
                self._send(200, "image/png", buf.getvalue())
            except Exception as e:  # a structured error; the server keeps serving
                self._send(400, "application/json", json.dumps({"error": str(e)}).encode())

        def log_message(self, fmt, *a):
            print(f"[serve] {fmt % a}", flush=True)

    return _ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8471)
    ap.add_argument("--demo", action="store_true", help="tiny random-weight stack")
    ap.add_argument("--demo-full", action="store_true",
                    help="full-size SDXL stack with random weights: the real serving "
                         "shapes, steps and latency without checkpoints, for load "
                         "benchmarks (tools/bench_serve.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--model-dir")
    ap.add_argument("--text-encoder-dir")
    ap.add_argument("--adapter")
    ap.add_argument("--adapter-preset", default="sdxl_chinese_clip")
    ap.add_argument("--family", default="chinese_clip",
                    choices=["chinese_clip", "mul_clip", "mt5", "alt_clip"],
                    help="the student tower's family (mul_zh, two towers: cli.generate)")
    ap.add_argument("--sampler", default="dpm++",
                    choices=["dpm++", "ddim", "euler", "euler_a", "lcm"])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--max-length", type=int, default=52)
    ap.add_argument("--default-steps", type=int, default=30)
    ap.add_argument("--aot-cache", metavar="DIR",
                    help="keep the compiled kernel library under DIR (keyed by the sources, "
                         "torch, CUDA and the card): a restarted server builds nothing")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="build the kernel library into a temporary directory, removed at "
                         "exit (every start compiles)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="co-batch up to N concurrent requests into one call "
                         "(1 = no batching)")
    ap.add_argument("--quant", default="none",
                    help="'int8' (= int8:resnet) or 'int8:<scopes>' from {resnet, shortcut, "
                         "sampler, stem, vae}: int8 PTQ of the UNet's in-scope convs (vae: "
                         "the VAE decoder's) at start-up, calibrated on --calib-prompt")
    ap.add_argument("--calib-prompt", default="一只戴着帽子的可爱猫咪",
                    help="calibration prompt for --quant")
    ap.add_argument("--calib-ranges", metavar="PATH",
                    help="JSON calibration-ranges cache for --quant: read if it exists, "
                         "written otherwise")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: the UNet Megatron-sharded over N ranks "
                         "(launch under torchrun --nproc-per-node N)")
    ap.add_argument("--batch-window-ms", type=int, default=150,
                    help="how long the batcher waits to fill a batch")
    args = ap.parse_args(argv)
    from .generate import check_serving_flags

    check_serving_flags(ap, args, "serve")
    real_mode = not (args.demo or args.demo_full)
    if real_mode:
        for req in ("model_dir", "text_encoder_dir", "adapter"):
            if getattr(args, req) is None:
                ap.error(f"--{req.replace('_', '-')} required without --demo/--demo-full")

    from ..pipelines.text2image import StableDiffusionXLPEAPipeline
    from .generate import (build_demo, build_demo_full, build_real, shard_for_tp,
                           start_compile_cache, start_tp)

    mesh = start_tp(args)
    start_compile_cache(args)
    if args.demo_full:
        models, tokenize, size = build_demo_full(args.device)
        size, default_steps = min(size, args.size), args.default_steps
    elif args.demo:
        models, tokenize, size = build_demo(args.device)
        default_steps = 6
    else:
        # what build_real reads beyond these flags: no LoRA, one tower, the
        # text-encoder directory's tokenizer
        args.lora = args.lora_scale = args.text_encoder_dir_2 = None
        args.tokenizer_dir = args.tokenizer_dir_2 = None
        models, tokenize, size = build_real(args)
        default_steps = args.default_steps

    if args.quant != "none":
        from ..quant import quantize_for_serving

        models = quantize_for_serving(models, tokenize([args.calib_prompt]), tokenize([""]),
                                      size, ranges_path=args.calib_ranges,
                                      conv_quant=args.quant)
    models = shard_for_tp(models, mesh)
    pipe = StableDiffusionXLPEAPipeline(models, args.sampler, aot_dir=args.aot_cache,
                                        mesh=mesh)
    tp = TPLink() if mesh is not None else None
    if tp is not None and dist.get_rank() != 0:
        with torch.inference_mode():  # an error ends this process (see the docstring)
            calls = tp.follow(lambda spec: run_spec(pipe, spec, size, size // 8))
        print(f"rank {dist.get_rank()}: replayed {calls} calls", flush=True)
        return
    engine = BatchingEngine(pipe, tokenize, size, max_batch=max(1, args.max_batch),
                            window_ms=args.batch_window_ms, tp=tp)
    srv = make_server(engine, args.port, default_steps)
    # shutdown() waits for serve_forever, so not on the engine's thread
    engine.on_failure = lambda: threading.Thread(target=srv.shutdown, daemon=True).start()
    print(f"serving on :{args.port} (size={size}, sampler={args.sampler}, "
          f"max_batch={args.max_batch}, device={models.device})", flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
        engine.close(timeout=60)
    if engine.failed is not None:
        raise SystemExit(engine.failed)


if __name__ == "__main__":
    main()
