"""The harness on the CPU: files found by name, the window and percentile
arithmetic, the roofline's counts against hand counts, the import guard
and the manifest's form."""
from __future__ import annotations

import ast
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import harness, roofline
from benchmark.reference import models as ref
from benchmark.tests import tiny

BENCH = Path(harness.__file__).resolve().parent
MAN = harness.manifest()
READER = harness.reader


def test_every_named_file_is_found():
    for wl in MAN["workloads"]:
        cfg = harness.config(MAN, wl["config"])
        assert set(cfg["components"]) >= {"unet", "vae", "text_encoder", "adapter"}
        tr = harness.traffic(wl["traffic"])
        assert hasattr(harness.driver(tr["driver"]), "run")
        assert harness.limits(wl["name"])["numbers"]
        for trace in (False, True):
            assert harness.cell_metrics(MAN, wl["name"], trace)
    for m in MAN["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert harness.reader(m["name"])({}) is None  # nothing to read: no number


def test_a_new_metric_file_is_picked_up_without_edits(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "metrics" / "dummy_ms.serve.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['x']\n")
    man = json.loads(json.dumps(MAN))
    wl = man["workloads"][0]["name"]
    man["per_layer"].append({"name": "dummy_ms.serve", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "front end and engine",
                             "moves": "images_per_s", "workloads": [wl]})
    names = [m["name"] for m in harness.cell_metrics(man, wl, True)]
    assert "dummy_ms.serve" in names
    assert harness.reader("dummy_ms.serve", bench=bench)({"x": 3.0}) == 6.0
    assert not (BENCH / "metrics" / "dummy_ms.serve.py").exists()


def test_a_new_cell_is_added_by_files_and_entries(tmp_path):
    """A configuration, a traffic mix and a cell that the benchmark did not
    have: three new files and new manifest entries, found by name and run
    (tiny, on the CPU), with no file of the benchmark edited."""
    import time

    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "tiny-sdxl.json").write_text(json.dumps(tiny.sdxl()))
    (bench / "traffic" / "tiny-serve.json").write_text(json.dumps(tiny.serve()))
    (bench / "limits" / "tiny-sdxl.serve.json").write_text(
        json.dumps(harness.limits("sdxl-serve-dpm30-c8")))
    man = json.loads(json.dumps(MAN))
    man["configs"].append({"name": "tiny-sdxl", "source": "the tests' tiny SDXL stack",
                           "file": "benchmark/configs/tiny-sdxl.json", "reduced": [],
                           "why": "a dummy"})
    man["workloads"].append({"name": "tiny-sdxl.serve", "config": "tiny-sdxl",
                             "traffic": "tiny-serve", "chips": 1, "why": "a dummy"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("images_per_s", "request_p95_s") or m["name"].endswith(".serve"):
            m["workloads"].append("tiny-sdxl.serve")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    man = harness.manifest(tmp_path)
    wl = harness.workload(man, "tiny-sdxl.serve")
    tr = harness.traffic(wl["traffic"], bench)
    res = harness.driver(tr["driver"]).run(
        harness.config(man, wl["config"], tmp_path), tr, harness.limits(wl["name"], bench),
        2 ** 31 + 3, 1.0, False, time.perf_counter(), device="cpu")
    assert res["correct"], res["checks"]
    assert {m["name"] for m in harness.cell_metrics(man, wl["name"], False)} == {
        "images_per_s", "request_p95_s", "setup_s"}
    assert all(p.read_bytes() == b for p, b in before.items())


def rate(events, seconds):
    t0, t1, units = harness.window(events, seconds)
    return units / (t1 - t0)


def test_window_opens_and_closes_on_completions():
    # completions of 8 images every 10 s from t = 5; window of 35 s
    events = [(5.0 + 10 * k, 8.0) for k in range(6)]
    t0, t1, units = harness.window(events, 35.0)
    assert (t0, t1, units) == (5.0, 45.0, 32.0)
    assert rate(events, 35.0) == pytest.approx(32.0 / 40.0)
    # a stall inside the window lowers the rate, wherever it falls: the
    # second call ends 8 s late, or the last one does
    for stalled in ([(5.0, 8.0), (23.0, 8.0), (33.0, 8.0), (43.0, 8.0), (53.0, 8.0)],
                    [(5.0, 8.0), (15.0, 8.0), (25.0, 8.0), (43.0, 8.0), (53.0, 8.0)]):
        assert rate(stalled, 35.0) < rate(events, 35.0)
    with pytest.raises(RuntimeError):
        harness.window([(0.0, 1.0), (20.0, 1.0)], 35.0)


def test_percentile_nearest_rank():
    v = list(range(1, 25))  # 24 latencies
    assert harness.percentile(v, 95) == 23
    assert harness.percentile(v, 50) == 12
    assert harness.percentile([7.0], 95) == 7.0


def test_attention_counts_against_hand_counts():
    # forward: QK^T and PV, 2 * sq * skv * d each, per head and row
    flops, nbytes = roofline.forward_cost(2, 4096, 52, 10, 64)
    assert flops == 2 * 10 * 2 * (2 * 4096 * 52 * 64)
    assert nbytes == 2 * 2 * 10 * 64 * (4096 + 52 + 52 + 4096)
    flops, nbytes = roofline.backward_cost(1, 1024, 1024, 8, 40)
    assert flops == 8 * 5 * 2 * 1024 * 1024 * 40
    assert nbytes == 2 * 8 * 40 * (3 * 1024 + 4 * 1024) + 8 * 8 * 1024
    # least time: the larger of the two bounds
    assert roofline.least_time((989e12, 0.0)) == pytest.approx(1.0)
    assert roofline.least_time((0.0, 3.35e12)) == pytest.approx(1.0)
    # PERF.md's kernel table: B1 at b2 S4096 H10 D64 is bound by its
    # operations at 0.08685 ms, B3 at BH160 Sq4096 Skv52 by its bytes
    assert roofline.least_time(roofline.forward_cost(2, 4096, 4096, 10, 64)) * 1e3 == \
        pytest.approx(0.08685, abs=5e-6)
    flops, nbytes = roofline.forward_cost(16, 4096, 52, 10, 64)
    assert nbytes / 3.35e12 > flops / 989e12
    assert roofline.least_time((flops, nbytes)) * 1e3 == pytest.approx(0.0507, abs=5e-5)


def test_unet_attention_calls_of_the_tiny_models():
    sd15 = tiny.sd15()["components"]["unet"]["config"]
    calls = roofline.unet_attention(sd15, 8, 8, 12)
    # levels 0-2 hold attention: 2 down + 3 up transformers each, plus the mid
    # block at level 3; one block each, a self and a cross call per block
    assert len(calls) == 2 * (3 * (2 + 3) + 1)
    assert calls[0] == (64, 64, 2, 16, False)  # no added conditioning: no backward
    assert calls[1] == (64, 12, 2, 16, True)
    sdxl = tiny.sdxl()["components"]["unet"]["config"]
    calls = roofline.unet_attention(sdxl, 8, 8, 12)
    # level 1: depth 1, level 2 and the mid block: depth 2
    assert len(calls) == 2 * (2 * 1 + 2 * 2 + 2 + 3 * 1 + 3 * 2)
    assert all(grad for *_, grad in calls)
    assert roofline.attention_least_s(calls, 2) == 0.0  # all shorter than the kernels take


def test_kernel_share_needs_a_kernel():
    kernels = [("void pea::sm90::wgmma_attention_kernel<bf16>", 0.0, 2.0),
               ("nvjet_gemm", 2.0, 10.0)]
    assert roofline.kernel_seconds(kernels) == pytest.approx(2e-6)
    assert roofline.share(1e-6, kernels) == pytest.approx(50.0)
    assert roofline.share(1e-6, kernels[1:]) is None


def test_model_flops_against_hand_counts():
    cfg = tiny.sd15()["components"]["adapter"]["config"]
    adapter = ref.build("adapter", cfg)
    x = torch.zeros((2, 12, 64), device="meta")
    counted = roofline._count(lambda: adapter(x))
    dims = [64] + cfg["projector_dims"]
    assert counted == sum(2 * 2 * 12 * a * b for a, b in zip(dims, dims[1:]))
    per_image = roofline.serve_flops_per_image(tiny.sdxl(), tiny.serve())
    per_sample = roofline.train_flops_per_sample(tiny.sd15(), tiny.train())
    assert per_image > 0 and per_sample > 0
    # a training step's count depends on its pixel count alone, as
    # metrics/mfu.train.py assumes: transposed buckets count alike
    cfg, mix = tiny.sdxl_f8(), tiny.train_shards()
    assert roofline.train_flops_per_sample(cfg, mix, (448, 896)) == \
        roofline.train_flops_per_sample(cfg, mix, (896, 448))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert files
    for path in files:
        assert not set(_imports(path)) & set(harness.FORBIDDEN), path
    for path in (BENCH / "reference").rglob("*.py"):
        assert "pea_diffusion_tpu_torch" not in set(_imports(path)), path


def test_the_guard_compares_whole_top_level_names():
    assert harness.forbidden_loaded(["pea_diffusion_tpu_torch.models", "jaxtyping"]) == []
    assert harness.forbidden_loaded(["pea_diffusion_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "pea_diffusion_tpu"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_form():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"] and 1 <= MAN["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in MAN[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for wl in m["workloads"]:
            reported = [x["name"] for x in harness.cell_metrics(MAN, wl, False)]
            assert m["moves"] in reported
    for c in MAN["configs"]:
        assert (harness.ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for wl in MAN["workloads"]:
        assert wl["chips"] == 1 and len(wl["why"]) <= 200
        assert len(harness.cell_metrics(MAN, wl["name"], True)) >= 1


def _run_main(monkeypatch, tmp_path, capsys, reader_source):
    """run.py's main over a stub driver and one per-layer metric whose
    reader is `reader_source`: (exit code, lines printed)."""
    import sys
    import types

    from benchmark import run

    (tmp_path / "metrics").mkdir(exist_ok=True)
    (tmp_path / "metrics" / "dummy_ms.stub.py").write_text(reader_source)
    man = {"workloads": [{"name": "stub", "config": "stub", "traffic": "stub", "chips": 1}],
           "end_to_end": [{"name": "setup_s", "unit": "s"}],
           "per_layer": [{"name": "dummy_ms.stub", "unit": "ms", "moves": "setup_s",
                          "workloads": ["stub"]}]}
    result = {"e2e": {"setup_s": 1.0}, "ctx": {"trace": {"busy_s": 1.0, "window_s": 2.0,
                                                         "breakdown": {}}},
              "device": {"platform": "gpu"}, "info": {}, "correct": True, "attempted": 1,
              "failed": 0, "checks": {}}
    monkeypatch.setattr(harness, "manifest", lambda: man)
    monkeypatch.setattr(harness, "require_cards", lambda n: None)
    monkeypatch.setattr(harness, "card_record", lambda: {})
    monkeypatch.setattr(harness, "config", lambda m, name: {})
    monkeypatch.setattr(harness, "traffic", lambda name: {"driver": "stub"})
    monkeypatch.setattr(harness, "limits", lambda name: {})
    monkeypatch.setattr(harness, "driver",
                        lambda name: types.SimpleNamespace(run=lambda *a: result))
    monkeypatch.setattr(harness, "reader", lambda name: READER(name, bench=tmp_path))
    monkeypatch.syspath_prepend(str(tmp_path))
    try:
        rc = run.main(["--workload", "stub", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                       "--trace", "1"])
    finally:
        sys.modules.pop("jax", None)
    return rc, capsys.readouterr().out.strip().splitlines()


def test_a_reader_that_loads_jax_stops_the_result(monkeypatch, tmp_path, capsys):
    """The import guard runs after every per-layer reader: a reader that
    loads a module named ``jax`` leaves the run with no result line."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "__init__.py").write_text("")
    rc, lines = _run_main(monkeypatch, tmp_path, capsys, "def read(ctx):\n    return 3.0\n")
    assert rc == 0 and json.loads(lines[-1])["metrics"]["dummy_ms.stub"]["value"] == 3.0
    rc, lines = _run_main(monkeypatch, tmp_path, capsys,
                          "def read(ctx):\n    import jax  # noqa: F401\n    return 3.0\n")
    assert rc == 1 and not any('"correct"' in line for line in lines)


def test_trace_reduction_names_idle_gaps_by_the_host():
    """Busy time is the union of the kernels' intervals; each idle gap is
    named by the innermost host range over its middle, else by the
    benchmark's range that ended last before it."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def ev(name, s, t, device=DeviceType.CPU):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=t),
                               device_type=device, is_user_annotation=False)

    cuda = DeviceType.CUDA
    events = [ev("bench/unet.forward", 0, 100), ev("aten::mm", 40, 60),
              ev("bench/vae.decode", 200, 300), ev("png", 320, 900),
              ev("gemm", 0, 30, cuda), ev("gemm", 20, 35, cuda), ev("gemm", 55, 100, cuda),
              ev("conv", 200, 300, cuda), ev("gemm", 1000, 1100, cuda)]
    out = harness.reduce_events(events, 2e-3)
    assert out["busy_s"] == pytest.approx((35 + 45 + 100 + 100) / 1e6)
    idle = dict(out["breakdown"]["idle_gaps"])
    assert idle == pytest.approx({"aten::mm": 20e-6, "after bench/unet.forward": 100e-6,
                                  "png": 700e-6})
    # the stretch after the last kernel counts too (the engine's turn-around)
    events.append(ev("png", 1100, 1400))
    idle = dict(harness.reduce_events(events, 2e-3)["breakdown"]["idle_gaps"])
    assert idle["png"] == pytest.approx(1000e-6)
    assert out["breakdown"]["device_ops"][0] == ["gemm", pytest.approx(190e-6)]
