"""HTTP client of the serving cells (the benchmark's own copy of the port's
``tools/bench_serve.py`` request code, so that the yardstick does not move
with the program): one POST /generate a request, PNG answers checked by
their magic bytes, every failure counted. Standard library only."""
from __future__ import annotations

import http.client
import json
import time
from typing import Dict, Optional

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def wait_healthy(host: str, port: int, timeout_s: float = 600) -> bool:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        try:
            c = http.client.HTTPConnection(host, port, timeout=10)
            c.request("GET", "/healthz")
            if c.getresponse().status == 200:
                return True
        except OSError:
            time.sleep(0.5)
    return False


def post(host: str, port: int, body: Dict, timeout_s: float = 600) -> Dict:
    """Sends one request; returns {"sent", "received" (perf_counter times),
    "png" (bytes, or None) and "error" (None, or the message)}."""
    out: Dict[str, Optional[object]] = {"png": None, "error": None}
    out["sent"] = time.perf_counter()
    try:
        c = http.client.HTTPConnection(host, port, timeout=timeout_s)
        c.request("POST", "/generate", json.dumps(body))
        r = c.getresponse()
        data = r.read()
        c.close()
        if r.status != 200:
            raise RuntimeError(f"{r.status}: {data[:200]!r}")
        if data[:8] != PNG_MAGIC:
            raise RuntimeError("not a PNG")
        out["png"] = data
    except Exception as e:  # every failure is counted and reported
        out["error"] = f"{type(e).__name__}: {e}"
    out["received"] = time.perf_counter()
    return out
