"""Co-batched SDXL serving under a closed loop: the program's HTTP server
(``cli/serve.py::make_server`` over ``BatchingEngine`` over
``StableDiffusionXLPEAPipeline``) on 127.0.0.1, port 0, and `clients`
clients that each send their next request when their PNG arrives.

Request i of a run has a prompt of seeded CJK characters (its length drawn
from ``prompt_chars``, padded to ``max_length`` ids), a guidance scale
drawn from ``guidance`` (so that one call carries a per-row CFG vector)
and a seed for its initial latents, all from (run seed, i).

The clients' first call warms every shape and counts as set-up; the window
opens when its last PNG arrives and closes when the last PNG of the first
call to end at least the run's seconds later arrives. A client whose answer
comes after that sends no more, so the run ends with that call; with
--trace 1 the clients go on until the profiled sub-window has closed: one
whole period of the engine, from the start of the first full call that
starts after the window to the start of the next (prompt encoding, the 30
UNet steps, the decode, and the turn-around of PNGs, HTTP and the batching
window). The benchmark's hooks on the program's modules record, per call,
the latents entering each UNet forward and its output and the latents the
VAE decodes, for the check after the window.
"""
from __future__ import annotations

import dataclasses
import io
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from .. import client, harness, port_stack
from ..reference import checks


def request_params(seed: int, i: int, tr: Dict) -> Dict:
    rng = np.random.default_rng([seed, i])
    n = int(rng.integers(tr["prompt_chars"][0], tr["prompt_chars"][1] + 1))
    text = "".join(chr(c) for c in rng.integers(0x4E00, 0xA000, n))
    lo, hi = tr["guidance"]
    return {"prompt": text, "negative_prompt": tr.get("negative_prompt", ""),
            "steps": tr["steps"], "guidance": float(rng.uniform(lo, hi)),
            "guidance_rescale": 0.0, "seed": int(rng.integers(1, 2 ** 31 - 1))}


class Recorder:
    """The benchmark's wrappers and hooks around the program's engine,
    UNet and VAE decoder."""

    def __init__(self, engine, models, cuda: bool, trace: bool):
        self.cuda = cuda
        self.calls: List[Dict] = []
        self.submits: Dict[int, float] = {}
        self.lock = threading.Lock()
        self.current = None
        self.sub = harness.SubWindow(cuda) if trace else None
        self.traced_rows: List[int] = []  # batch of each UNet forward in the sub-window
        # the sub-window opens at the first full call that starts after this
        # time (the window's end), so that profiling slows no call of the
        # window and a split drain does not change what it profiles, and
        # closes as the next call starts
        self.profile_after = float("inf")
        self.full_rows = engine.max_batch
        self._engine_run, self._engine_submit = engine.run, engine.submit
        engine.run, engine.submit = self._run, self._submit
        self.handles = [
            models.unet.register_forward_pre_hook(self._unet_pre),
            models.unet.register_forward_hook(self._unet_post),
            models.vae.post_quant_conv.register_forward_pre_hook(self._decode_in),
            models.vae.decoder.register_forward_pre_hook(self._decode_pre),
            models.vae.decoder.register_forward_hook(self._decode_post),
        ]

    def _event(self):
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _submit(self, prompt, negative, steps, guidance, rescale, seed):
        with self.lock:
            self.submits[int(seed)] = time.perf_counter()
        return self._engine_submit(prompt, negative, steps, guidance, rescale, seed)

    def _run(self, spec):
        rows = [s for s, n in spec["seeds"] for _ in range(n)]
        rec = {"id": len(self.calls), "start": time.perf_counter(), "rows": rows,
               "requests": [s for s in rows if s != 0], "x": [], "out": [], "unet_ev": [],
               "decode_ev": [], "final": None}
        self.calls.append(rec)
        self.current = rec
        sub = self.sub
        if sub is not None and sub.prof is None and rec["start"] > self.profile_after \
                and len(rows) == self.full_rows:
            sub.start()
        elif sub is not None and sub.prof is not None and not sub.done:
            sub.stop()
        with harness.annotate("engine.call"):
            out = self._engine_run(spec)
        rec["end"] = time.perf_counter()
        return out

    def _unet_pre(self, mod, args):
        rec = self.current
        x = args[0]
        if self.sub is not None and self.sub.prof is not None and not self.sub.done:
            self.traced_rows.append(x.shape[0])
        rec["x"].append(x[: x.shape[0] // 2].detach().float().clone())
        rec["unet_ev"].append([self._event(), None])
        self._range("unet.forward")

    def _unet_post(self, mod, args, out):
        rec = self.current
        self._range(None)
        rec["out"].append(out.detach().clone())
        rec["unet_ev"][-1][1] = self._event()

    def _decode_in(self, mod, args):
        self.current["final"] = args[0].detach().float().clone()

    def _decode_pre(self, mod, args):
        self.current["decode_ev"] = [self._event(), None, args[0].shape[0]]
        self._range("vae.decode")

    def _decode_post(self, mod, args, out):
        self._range(None)
        self.current["decode_ev"][1] = self._event()

    def _range(self, name):
        """Closes the open host range of a forward, or opens one: the
        breakdown names idle gaps by them."""
        if name is None:
            self._open.__exit__(None, None, None)
        else:
            self._open = harness.annotate(name)
            self._open.__enter__()

    def close(self):
        for h in self.handles:
            h.remove()


def _control(models, tokenize, size, prompt):
    """The program's own lower-precision path: int8 UNet convs (calibrated
    on `prompt`) and the VAE in bf16."""
    from pea_diffusion_tpu_torch.quant import quantize_for_serving

    models = quantize_for_serving(models, tokenize([prompt]), tokenize([""]), size,
                                  conv_quant="int8")
    return dataclasses.replace(models, vae=models.vae.to(torch.bfloat16))


def run(config: Dict, tr: Dict, lims: Dict, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", variant: str = "program") -> Dict:
    from PIL import Image

    from pea_diffusion_tpu_torch.cli.generate import make_tokenizer
    from pea_diffusion_tpu_torch.cli.serve import BatchingEngine, make_server
    from pea_diffusion_tpu_torch.pipelines.text2image import StableDiffusionXLPEAPipeline

    cuda = torch.device(device).type == "cuda"
    if config["components"]["unet"]["config"].get("addition_embed_type") != "text_time":
        raise ValueError("serve drives the SDXL pipeline")
    vocab = config["components"]["text_encoder"]["config"]["vocab_size"]
    tokenize = make_tokenizer(vocab, tr["max_length"])
    models = port_stack.serving_models(config, seed, device)
    if variant == "control":
        models = _control(models, tokenize, tr["size"], request_params(seed, 10 ** 9, tr)["prompt"])
    pipe = StableDiffusionXLPEAPipeline(models, tr["sampler"])
    engine = BatchingEngine(pipe, tokenize, tr["size"], max_batch=tr["max_batch"],
                            window_ms=tr["window_ms"])
    rec = Recorder(engine, models, cuda, trace)
    server = make_server(engine, 0, tr["steps"], host="127.0.0.1")
    host, port = server.server_address[:2]
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()

    results: Dict[int, Dict] = {}
    lock = threading.Lock()
    counter = iter(range(10 ** 9))
    state = {"open": None, "stop": False}

    def loop():
        while True:
            with lock:
                if state["stop"]:
                    return
                t_open = state["open"]
                if rec.sub is not None:  # on past the window to the profiled boundary
                    if rec.sub.done:
                        return
                elif t_open is not None and time.perf_counter() - t_open >= seconds:
                    return
                i = next(counter)
            params = request_params(seed, i, tr)
            res = client.post(host, port, params)
            res["params"] = params
            with lock:
                results[i] = res
                if state["open"] is None and _first_call_done(rec, results):
                    state["open"] = _call_done_at(rec.calls[0], results)
                    rec.profile_after = state["open"] + seconds

    try:
        if not client.wait_healthy(host, port):
            raise RuntimeError("the server never answered /healthz")
        clients = [threading.Thread(target=loop) for _ in range(tr["clients"])]
        for c in clients:
            c.start()
        deadline = time.perf_counter() + 3 * seconds + 1200
        for c in clients:
            c.join(max(1.0, deadline - time.perf_counter()))
        with lock:
            state["stop"] = True
        for c in clients:
            c.join(600)
    finally:
        server.shutdown()
        server.server_close()
        engine.close(timeout=600)
        rec.close()
    if any(c.is_alive() for c in clients):
        raise RuntimeError("a client never finished")
    if state["open"] is None:
        raise RuntimeError("the first call never completed")

    # calls and their completions (the last PNG of the call that arrived)
    by_seed = {r["params"]["seed"]: r for r in results.values()}
    events, call_of = [], {}
    for c in rec.calls:
        if "end" not in c or not all(s in by_seed for s in c["requests"]):
            continue
        images = sum(1 for s in c["requests"] if by_seed[s]["error"] is None)
        events.append((_call_done_at(c, results), float(images), c["id"]))
        for row, s in enumerate(c["rows"]):
            if s != 0:
                call_of[s] = (c, row)
    t0, t1, images = harness.window([(t, u) for t, u, _ in events], seconds)
    in_window = [cid for t, _, cid in events if t0 < t <= t1]
    calls = [c for c in rec.calls if c["id"] in in_window]
    answered = [r for r in results.values() if t0 < r["received"] <= t1]
    done = [r for r in answered if r["error"] is None]
    failed = [r for r in results.values() if r["error"] is not None]
    if not done:
        raise RuntimeError("no request completed inside the window")
    out = {
        "e2e": {"images_per_s": images / (t1 - t0),
                "request_p95_s": harness.percentile(
                    [r["received"] - r["sent"] for r in done], 95),
                "setup_s": t0 - t_start},
        "attempted": len(answered),
        "failed": len(answered) - len(done),
        "device": harness.device_record() if cuda else {"platform": "cpu"},
        "info": {"window_s": t1 - t0, "calls_in_window": len(in_window),
                 "rows_of_calls": [len(c["requests"]) for c in calls],
                 "requests_in_window": len(done), "requests_sent": len(results),
                 "first_error": failed[0]["error"] if failed else None},
    }
    ctx = {"calls": calls, "window_s": t1 - t0, "images": images, "traffic": tr,
           "config": config, "subwindow": rec.sub,
           "queue_wait_s": [c["start"] - rec.submits[s] for c in calls for s in c["requests"]
                            if s in rec.submits]}
    if cuda:
        torch.cuda.synchronize()
        ctx["unet_ms"] = [a.elapsed_time(b) for c in calls for a, b in c["unet_ev"]]
        ctx["decode_ms_per_image"] = [c["decode_ev"][0].elapsed_time(c["decode_ev"][1])
                                      / c["decode_ev"][2] for c in calls]
    if rec.sub is not None and rec.sub.done:
        ctx["trace"] = rec.sub.reduce()
        ctx["trace_forwards"] = rec.traced_rows
    out["ctx"] = ctx

    # the check: a sample of the window's requests, drawn from the seed
    rng = np.random.default_rng([seed, 7])
    pool = sorted(r["params"]["seed"] for r in done if r["params"]["seed"] in call_of)
    picked = rng.choice(len(pool), size=min(tr["check"]["requests"], len(pool)), replace=False)
    reqs = []
    for k in sorted(int(p) for p in picked):
        c, row = call_of[pool[k]]
        res = by_seed[pool[k]]
        steps = tr["steps"]
        mid = int(rng.integers(1, steps - 1)) if steps > 2 else 0
        checked = sorted({0, mid, steps - 1})
        need = sorted({j for i in checked for j in (i - 1, i, i + 1) if 0 <= j < steps})
        p = len(c["rows"])
        reqs.append({
            "text": res["params"]["prompt"], "guidance": res["params"]["guidance"],
            "seed": res["params"]["seed"],
            "checked": checked,
            "steps": {j: (c["x"][j][row:row + 1].cpu(),
                          torch.stack([c["out"][j][row], c["out"][j][p + row]]).cpu())
                      for j in need},
            "final": c["final"][row:row + 1].permute(0, 2, 3, 1).cpu()
            * config["components"]["vae"]["config"]["scaling_factor"],
            "png": np.asarray(Image.open(io.BytesIO(res["png"])).convert("RGB")),
        })
    for c in rec.calls:  # the program's state goes before the reference runs
        c["x"], c["out"], c["final"] = [], [], None
    del models, pipe, engine, rec
    if cuda:
        torch.cuda.empty_cache()
    values = checks.serve_check(config, tr, seed, reqs, device)
    out["correct"], out["checks"] = harness.checks_report(values, lims)
    out["correct"] &= out["failed"] == 0  # an answer that never came
    out["info"]["compared"] = values
    return out


def _first_call_done(rec, results) -> bool:
    if not rec.calls or "end" not in rec.calls[0]:
        return False
    got = {r["params"]["seed"] for r in results.values()}
    return all(s in got for s in rec.calls[0]["requests"])


def _call_done_at(call, results) -> float:
    seeds = set(call["requests"])
    return max(r["received"] for r in results.values() if r["params"]["seed"] in seeds)
