"""Load client for the port's serving daemon (``cli/serve.py``): N
concurrent clients against a running server, reporting requests/s and
p50/p95/max latency, with the server's co-batching counters before and
after (the port-side counterpart of the repo's ``tools/bench_serve.py``).

The server runs in its own process (it owns the card):

  python -m pea_diffusion_tpu_torch.cli.serve --demo-full --max-batch 8 \\
      --port 8471 --default-steps 30 &
  python -m pea_diffusion_tpu_torch.tools.bench_serve --port 8471 --clients 8 \\
      --requests 24 --steps 30 --mixed-guidance

Request i asks for prompt "一只猫 {i}" with seed i; --mixed-guidance gives it
guidance 5.0 + (i % 8) * 0.5, so that concurrent requests differ in CFG and
still share device calls (the engine's [B] guidance). Untimed warm-up first:
`warmup` serial requests, then one concurrent burst of `clients` requests
shaped like the timed load. Standard library only (http.client, threads).
"""
from __future__ import annotations

import argparse
import http.client
import json
import statistics
import sys
import threading
import time

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def wait_healthy(host, port, timeout_s=3600):
    """True once GET /healthz answers 200, False after `timeout_s`."""
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        try:
            c = http.client.HTTPConnection(host, port, timeout=10)
            c.request("GET", "/healthz")
            if c.getresponse().status == 200:
                return True
        except OSError:
            time.sleep(5)
    return False


def engine_stats(host, port):
    """The server's BatchingEngine counters (/healthz "engine"): device
    calls against requests batched shows co-batching from outside."""
    try:
        c = http.client.HTTPConnection(host, port, timeout=10)
        c.request("GET", "/healthz")
        return json.loads(c.getresponse().read()).get("engine") or {}
    except (OSError, ValueError):
        return {}


def request_body(i, steps, mixed_guidance):
    """The JSON body of request i."""
    guidance = 5.0 + (i % 8) * 0.5 if mixed_guidance else 7.5
    return {"prompt": f"一只猫 {i}", "steps": steps, "guidance": guidance, "seed": i}


def run(host="127.0.0.1", port=8471, clients=8, requests=24, steps=30,
        mixed_guidance=False, warmup=1, timeout_s=3600, keep_images=False):
    """Warm-up, then `requests` timed requests from `clients` concurrent
    clients. Returns {"requests_per_s", "p50_s", "p95_s", "max_s", "wall_s",
    "requests" (timed ones answered), "errors" (list of messages),
    "cobatch" (the engine counters' change over the timed load)} and, with
    `keep_images`, "images": {request index: PNG bytes} of every request
    answered, warm-up included (indices 0 .. warmup + clients - 1)."""
    lat, errors, images = [], [], {}
    lock = threading.Lock()
    idx = iter(range(10 ** 9))

    def one_request(i, timed=True):
        body = json.dumps(request_body(i, steps, mixed_guidance))
        t0 = time.time()
        try:
            c = http.client.HTTPConnection(host, port, timeout=timeout_s)
            c.request("POST", "/generate", body)
            r = c.getresponse()
            data = r.read()
            if r.status != 200:
                raise RuntimeError(f"{r.status}: {data[:200]!r}")
            if data[:8] != PNG_MAGIC:
                raise RuntimeError("not a PNG")
        except Exception as e:  # every failure is counted and reported
            with lock:
                errors.append(f"request {i}: {type(e).__name__}: {e}")
            return
        with lock:
            if timed:
                lat.append(time.time() - t0)
            if keep_images:
                images[i] = data

    def in_threads(targets):
        threads = [threading.Thread(target=f, args=a) for f, a in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    for w in range(warmup):
        one_request(next(idx), timed=False)
        print(f"[bench_serve] warmup {w + 1}/{warmup} done", file=sys.stderr, flush=True)
    in_threads([(one_request, (next(idx), False)) for _ in range(clients)])
    print(f"[bench_serve] concurrent warmup burst ({clients}) done", file=sys.stderr,
          flush=True)

    before = engine_stats(host, port)
    sem = threading.Semaphore(clients)

    def client(i):
        with sem:
            one_request(i)

    t_start = time.time()
    in_threads([(client, (next(idx),)) for _ in range(requests)])
    wall = time.time() - t_start
    after = engine_stats(host, port)

    lat.sort()
    n = len(lat)
    out = {"requests_per_s": n / wall, "wall_s": wall, "requests": n, "errors": errors,
           "p50_s": statistics.median(lat) if n else None,
           "p95_s": lat[max(0, int(0.95 * n) - 1)] if n else None,
           "max_s": lat[-1] if n else None, "cobatch": {}}
    if after:
        calls = after.get("device_calls", 0) - before.get("device_calls", 0)
        reqs = after.get("requests_batched", 0) - before.get("requests_batched", 0)
        out["cobatch"] = {
            "device_calls": calls, "requests_batched": reqs,
            "avg_batch": reqs / calls if calls else None,
            "vector_cfg_calls": (after.get("vector_cfg_calls", 0)
                                 - before.get("vector_cfg_calls", 0)),
            "batch_hist_total": after.get("batch_hist", {}),
        }
    if keep_images:
        out["images"] = images
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8471)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24,
                    help="total requests across all clients")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--mixed-guidance", action="store_true",
                    help="per-request CFG strengths (co-batching proof)")
    ap.add_argument("--warmup", type=int, default=1, help="untimed serial warm-up requests")
    args = ap.parse_args(argv)

    if not wait_healthy(args.host, args.port):
        print("server never became healthy", file=sys.stderr)
        return 1
    r = run(args.host, args.port, args.clients, args.requests, args.steps,
            args.mixed_guidance, args.warmup)
    if r["errors"]:
        print(f"[bench_serve] {len(r['errors'])} errors, first: {r['errors'][0]}",
              file=sys.stderr)
    if not r["requests"]:
        return 1
    print(json.dumps({
        "metric": "serving throughput under concurrent load",
        "value": round(r["requests_per_s"], 4), "unit": "requests/s",
        "detail": {
            "clients": args.clients, "requests": r["requests"], "wall_s": round(r["wall_s"], 1),
            "steps": args.steps, "mixed_guidance": args.mixed_guidance,
            "p50_s": round(r["p50_s"], 2), "p95_s": round(r["p95_s"], 2),
            "max_s": round(r["max_s"], 2), "errors": len(r["errors"]),
            "cobatch": r["cobatch"],
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
