"""Co-batched SDXL ControlNet serving under a closed loop: the program's
HTTP server (``cli/serve.py::make_server`` over ``BatchingEngine`` over
``pipelines/controlnet.py::StableDiffusionXLControlNetPEAPipeline``) on
127.0.0.1, port 0, and `clients` clients that each send their next request
when their PNG arrives.

Request i of a run is the plain serving cell's (``drivers/serve.py``: its
prompt, guidance and noise seed from (run seed, i)) with a control map and
a conditioning scale drawn from ``control_scale``, also from (run seed, i).
The map is an edge map at the served size, white line segments, polylines
and ellipse outlines on black until they cover a share of the pixels drawn
from ``edge_cover``, as Canny maps of photographs do; it goes as a base64
grey-level PNG. Maps are made before the warm-up (``map_pool`` of them;
any later request makes its own), so that clients send at once.

Set-up, window, traced sub-window and the sample of checked requests are
``drivers/serve.py``'s. Besides its records, the benchmark's hook on the
program's ControlNet keeps its residuals at three steps of each call that
can fall in the window (0, the last, and one between drawn per call), for
``reference/controlnet_checks.py``.

A program without the ControlNet serving path ends the run at once,
before any weight is made: the cell does not apply to it.
"""
from __future__ import annotations

import base64
import inspect
import io
import threading
import time
from typing import Dict

import numpy as np
import torch

from .. import client, harness, port_stack, weights
from ..reference import controlnet as ref_cn
from ..reference import controlnet_checks, lowp
from . import serve


def require_controlnet_serving():
    """The program's ControlNet serving pieces, or SystemExit where it has
    none (a program older than them)."""
    try:
        from pea_diffusion_tpu_torch.cli.serve import BatchingEngine
        from pea_diffusion_tpu_torch.pipelines.controlnet import (
            StableDiffusionXLControlNetPEAPipeline)
    except ImportError as e:
        raise SystemExit(f"benchmark: the program serves no ControlNet requests ({e})")
    if "control" not in inspect.signature(BatchingEngine.submit).parameters:
        raise SystemExit("benchmark: the program's engine takes no control maps")
    return StableDiffusionXLControlNetPEAPipeline


def edge_map(seed: int, i: int, size: int, cover) -> np.ndarray:
    """Request i's edge map, uint8 [size, size] (0 or 255), from (seed, i)."""
    from PIL import Image, ImageDraw

    rng = np.random.default_rng([seed, i, 2])
    target = rng.uniform(cover[0], cover[1]) * size * size
    img = Image.new("L", (size, size), 0)
    draw = ImageDraw.Draw(img)
    while np.count_nonzero(np.asarray(img)) < target:
        for _ in range(8):
            kind, width = int(rng.integers(3)), int(rng.choice([1, 1, 1, 2]))
            if kind == 0:
                draw.line([tuple(p) for p in rng.uniform(0, size, (2, 2))], fill=255,
                          width=width)
            elif kind == 1:
                start = rng.uniform(0, size, 2)
                steps = rng.normal(0, size / 16, (int(rng.integers(4, 12)), 2))
                draw.line([tuple(p) for p in start + np.cumsum(steps, axis=0)], fill=255,
                          width=width)
            else:
                c, r = rng.uniform(0, size, 2), rng.uniform(size / 64, size / 4, 2)
                draw.ellipse([c[0] - r[0], c[1] - r[1], c[0] + r[0], c[1] + r[1]],
                             outline=255, width=width)
    return np.asarray(img)


def png_b64(levels: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(levels).save(buf, "PNG", compress_level=1)
    return base64.b64encode(buf.getvalue()).decode("ascii")


class Maps:
    """Request i's map (uint8 levels) and its base64 PNG: the first `pool`
    made up front, any later one when it is asked for."""

    def __init__(self, seed: int, tr: Dict):
        self.seed, self.size, self.cover = seed, tr["size"], tr["edge_cover"]
        self.made: Dict[int, tuple] = {}
        self.lock = threading.Lock()
        for i in range(tr["map_pool"]):
            self.get(i)

    def get(self, i: int) -> tuple:
        with self.lock:
            if i in self.made:
                return self.made[i]
        levels = edge_map(self.seed, i, self.size, self.cover)
        made = (levels, png_b64(levels))
        with self.lock:
            self.made[i] = made
        return made


def request_params(seed: int, i: int, tr: Dict, maps: Maps) -> Dict:
    params = serve.request_params(seed, i, tr)
    lo, hi = tr["control_scale"]
    params["controlnet_conditioning_scale"] = float(
        np.random.default_rng([seed, i, 1]).uniform(lo, hi))
    params["control_image"] = maps.get(i)[1]
    return params


class Recorder(serve.Recorder):
    """``drivers/serve.py``'s wrappers and hooks, the engine's submit taking
    the control operands, and a hook on the program's ControlNet that keeps
    its residuals at steps 0, `mid` and the last of each call that can fall
    in the window: every call after call 0 (the warm-up, never in it) whose
    predecessor returned before the window's earliest close (a call whose
    predecessor's answers came after that closes the window or follows
    it)."""

    def __init__(self, engine, models, controlnet, cuda: bool, trace: bool, seed: int,
                 steps: int):
        super().__init__(engine, models, cuda, trace)
        self.seed, self.steps = seed, steps
        self.traced_cn_rows = []  # batch of each ControlNet forward in the sub-window
        self.handles.append(controlnet.register_forward_hook(self._cn_post))

    def _submit(self, prompt, negative, steps, guidance, rescale, seed, **control):
        with self.lock:
            self.submits[int(seed)] = time.perf_counter()
        return self._engine_submit(prompt, negative, steps, guidance, rescale, seed, **control)

    def mid_step(self, call_id: int) -> int:
        rng = np.random.default_rng([self.seed, call_id, 11])
        return int(rng.integers(1, self.steps - 1)) if self.steps > 2 else 0

    def _cn_post(self, mod, args, out):
        rec = self.current
        if self.sub is not None and self.sub.prof is not None and not self.sub.done:
            self.traced_cn_rows.append(args[0].shape[0])
        i = rec.setdefault("cn_forwards", 0)
        rec["cn_forwards"] = i + 1
        if rec["id"] == 0 or self.calls[rec["id"] - 1]["end"] > self.profile_after:
            return
        if i in (0, self.mid_step(rec["id"]), self.steps - 1):
            down, mid = out
            rec.setdefault("residuals", {})[i] = [r.detach().clone() for r in down] + [
                mid.detach().clone()]


def _control(models, controlnet, tokenize, size, prompt):
    """The program one precision step below: its int8 UNet convs and bf16
    VAE (``drivers/serve.py``'s control; quantize_for_serving does not
    reach the ControlNet), and the ControlNet's products in fp8
    (``reference/lowp.py``)."""
    return serve._control(models, tokenize, size, prompt), lowp.Fp8Forward(controlnet)


def controlnet_module(config: Dict, seed: int, device):
    """The program's ControlNet at the configuration's widths, loaded as a
    checkpoint loads (``pipelines/factory.py::load_weights``) with the
    run's weights."""
    from pea_diffusion_tpu_torch.configs.unet import ControlNetConfig
    from pea_diffusion_tpu_torch.models.controlnet import ControlNet
    from pea_diffusion_tpu_torch.pipelines.factory import load_weights

    comp = config["components"]["controlnet"]
    dtype = weights.DTYPES[comp["weights_dtype"]]
    with torch.device("meta"):
        cn = ControlNet(ControlNetConfig.from_diffusers_config(comp["config"]))
    state = ref_cn.controlnet_state(seed, comp["config"], dtype, device)
    return load_weights(cn, state, dtype, device, "controlnet")


def run(config: Dict, tr: Dict, lims: Dict, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", variant: str = "program") -> Dict:
    from PIL import Image

    pipeline_cls = require_controlnet_serving()
    from pea_diffusion_tpu_torch.cli.generate import make_tokenizer
    from pea_diffusion_tpu_torch.cli.serve import BatchingEngine, make_server

    cuda = torch.device(device).type == "cuda"
    if config["components"]["unet"]["config"].get("addition_embed_type") != "text_time":
        raise ValueError("serve_controlnet drives the SDXL ControlNet pipeline")
    vocab = config["components"]["text_encoder"]["config"]["vocab_size"]
    tokenize = make_tokenizer(vocab, tr["max_length"])
    maps = Maps(seed, tr)
    models = port_stack.serving_models(config, seed, device)
    cn = controlnet_module(config, seed, device)
    pipe_cn = cn
    if variant == "control":
        models, pipe_cn = _control(models, cn, tokenize, tr["size"],
                                   serve.request_params(seed, 10 ** 9, tr)["prompt"])
    pipe = pipeline_cls(models, pipe_cn, tr["sampler"])
    engine = BatchingEngine(pipe, tokenize, tr["size"], max_batch=tr["max_batch"],
                            window_ms=tr["window_ms"])
    rec = Recorder(engine, models, cn, cuda, trace, seed, tr["steps"])
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
            params = request_params(seed, i, tr, maps)
            res = client.post(host, port, params)
            res["params"], res["index"] = params, i
            with lock:
                results[i] = res
                if state["open"] is None and serve._first_call_done(rec, results):
                    state["open"] = serve._call_done_at(rec.calls[0], results)
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

    by_seed = {r["params"]["seed"]: r for r in results.values()}
    events, call_of = [], {}
    for c in rec.calls:
        if "end" not in c or not all(s in by_seed for s in c["requests"]):
            continue
        images = sum(1 for s in c["requests"] if by_seed[s]["error"] is None)
        events.append((serve._call_done_at(c, results), float(images), c["id"]))
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
        ctx["trace_controlnet_forwards"] = rec.traced_cn_rows
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
        checked = sorted({0, rec.mid_step(c["id"]), steps - 1})
        need = sorted({j for i in checked for j in (i - 1, i, i + 1) if 0 <= j < steps})
        p = len(c["rows"])
        reqs.append({
            "text": res["params"]["prompt"], "guidance": res["params"]["guidance"],
            "seed": res["params"]["seed"],
            "scale": res["params"]["controlnet_conditioning_scale"],
            "map": maps.get(res["index"])[0],
            "checked": checked,
            "steps": {j: (c["x"][j][row:row + 1].cpu(),
                          torch.stack([c["out"][j][row], c["out"][j][p + row]]).cpu())
                      for j in need},
            "residuals": {i: [torch.stack([r[row], r[p + row]]).cpu()
                              for r in c["residuals"][i]] for i in checked},
            "final": c["final"][row:row + 1].permute(0, 2, 3, 1).cpu()
            * config["components"]["vae"]["config"]["scaling_factor"],
            "png": np.asarray(Image.open(io.BytesIO(res["png"])).convert("RGB")),
        })
    for c in rec.calls:  # the program's state goes before the reference runs
        c["x"], c["out"], c["final"] = [], [], None
        c.pop("residuals", None)
    del models, cn, pipe_cn, pipe, engine, rec
    if cuda:
        torch.cuda.empty_cache()
    values = controlnet_checks.controlnet_check(config, tr, seed, reqs, device)
    out["correct"], out["checks"] = harness.checks_report(values, lims)
    out["correct"] &= out["failed"] == 0  # an answer that never came
    out["info"]["compared"] = values
    return out

