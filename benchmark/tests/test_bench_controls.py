"""The comparison that decides ``correct`` must fail what it is there to
catch. At tiny sizes on the CPU, under each cell's own limits
(``limits/<cell>.json``): sound runs of the program pass; the control (the
program's int8 UNet convs and bf16 VAE for serving; for training the
reference one precision step lower, ``reference/lowp.py``, put in the
program's place) and each fault the cell can have, planted in the program
underneath a whole run of its driver, fail.
The readings at the cells' own sizes come from ``tools/readings.py`` on the
card (PERF.md)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import serve as serve_driver, train as train_driver
from benchmark.reference import checks
from benchmark.tests import tiny

SEED = 2 ** 31 + 29
SERVE_LIMITS = harness.limits("sdxl-serve-dpm30-c8")
TRAIN_LIMITS = harness.limits("sd15-kd-train-b40")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def serve(variant="program"):
    return serve_driver.run(tiny.sdxl(), tiny.serve(), SERVE_LIMITS, SEED, 1.0, False,
                                 time.perf_counter(), device="cpu", variant=variant)


def train():
    return train_driver.run(tiny.sd15(), tiny.train(), TRAIN_LIMITS, SEED, 1.0, False,
                        time.perf_counter(), device="cpu")


def test_sound_runs_pass():
    res = serve()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    res = train()
    assert res["correct"], res["checks"]


def test_serving_control_fails():
    res = serve("control")
    assert not res["correct"], res["checks"]


def _stuck_step(monkeypatch):
    from pea_diffusion_tpu_torch.schedulers import dpm_solver

    step = dpm_solver.step

    def stuck(sched, i, sample, out, prev):
        return sample, step(sched, i, sample, out, prev)[1]

    monkeypatch.setattr(dpm_solver, "step", stuck)


def _swapped_answers(monkeypatch):
    from pea_diffusion_tpu_torch.pipelines import text2image

    to_pil = text2image.to_pil
    monkeypatch.setattr(text2image, "to_pil", lambda images: to_pil(images.flip(0)))


def _altered_answer(monkeypatch):
    from pea_diffusion_tpu_torch.pipelines import text2image

    to_pil = text2image.to_pil

    def altered(images):
        images = images.clone()
        images[:, :4, :4] = 1 - images[:, :4, :4]
        return to_pil(images)

    monkeypatch.setattr(text2image, "to_pil", altered)


def _lost_answers(monkeypatch):
    from pea_diffusion_tpu_torch.pipelines import text2image

    to_pil, calls = text2image.to_pil, []

    def lost(images):
        calls.append(1)
        if len(calls) % 3 == 0:
            raise RuntimeError("planted: the call's answers never come")
        return to_pil(images)

    monkeypatch.setattr(text2image, "to_pil", lost)


@pytest.mark.parametrize("fault", [_stuck_step, _swapped_answers, _altered_answer,
                                   _lost_answers])
def test_serving_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    res = serve()
    assert not res["correct"], res["checks"]


def _state_unchanged(monkeypatch):
    from pea_diffusion_tpu_torch.train import optim

    monkeypatch.setattr(optim, "apply_update",
                        lambda cfg, params, grads, state, mask: optim.global_norm(grads))


def _half_batch(monkeypatch):
    from pea_diffusion_tpu_torch.train import kd

    def half(a, b, weight, dtype=torch.float32):
        d = (a.to(dtype) - b.to(dtype)) ** 2
        per = d.float().mean(dim=tuple(range(1, d.ndim)))
        n = per.shape[0] // 2
        return (per * weight)[:n].mean()

    monkeypatch.setattr(kd, "_masked_mse", half)


def _altered_gradient(monkeypatch):
    from pea_diffusion_tpu_torch.train import optim

    apply = optim.apply_update

    def altered(cfg, params, grads, state, mask):
        big = max(grads, key=lambda k: float(grads[k].norm()))
        return apply(cfg, params, {**grads, big: 2 * grads[big]}, state, mask)

    monkeypatch.setattr(optim, "apply_update", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered_gradient])
def test_training_faults_fail(monkeypatch, fault):
    fault(monkeypatch)
    res = train()
    assert not res["correct"], res["checks"]


def _altered_pixels(monkeypatch):
    from pea_diffusion_tpu_torch.data import pipeline

    collate = pipeline.collate

    def altered(examples, *a, **kw):
        batch = collate(examples, *a, **kw)
        batch["pixel_values"][:, :2, :2] *= -1
        return batch

    monkeypatch.setattr(pipeline, "collate", altered)


@pytest.mark.parametrize("fault", [None, _altered_pixels])
def test_training_from_shards(monkeypatch, fault):
    """The shards path end to end at tiny widths: the written samples
    through the program's data pipeline pass, and a batch altered where
    the pipeline makes it fails ``batch_gap``."""
    limits = {"numbers": dict(TRAIN_LIMITS["numbers"], batch_gap={"limit": 0.0})}
    if fault is not None:
        fault(monkeypatch)
    res = train_driver.run(tiny.sdxl_f8(), tiny.train_shards(), limits, SEED, 1.0, False,
                           time.perf_counter(), device="cpu")
    assert (res["checks"]["batch_gap"]["value"] == 0) == (fault is None), res["checks"]
    assert res["correct"] == (fault is None), res["checks"]


def test_training_control_fails():
    cfg, tr = tiny.sd15(), tiny.train()
    hp = train_driver.hyper(cfg, tr)
    n = tr["checked_steps"]
    batches = [train_driver.make_batch(cfg, tr, SEED, s, "cpu") for s in range(n)]
    draws = [SEED * 1_000_003 + s for s in range(n)]
    ref = checks.train_reference(cfg, hp, SEED, batches, draws, "cpu", 2)
    low = checks.train_reference(cfg, hp, SEED, batches, draws, "cpu", 2, control=True)
    correct, report = harness.checks_report(checks.train_numbers(low, ref), TRAIN_LIMITS)
    assert not correct, report


def test_fp8_products_round_the_operands():
    from benchmark.reference import lowp

    x = torch.randn(64, 32, dtype=torch.float64)
    err = float((lowp.fp8_round(x) - x).abs().max() / x.abs().max())
    assert 0 < err <= 2 ** -4
    lin = torch.nn.Linear(32, 16).double()
    exact, low = lin(x), lowp.Fp8Forward(lin)(x)
    assert 1e-3 < float((low - exact).norm() / exact.norm()) < 0.2
    y = x.clone().requires_grad_(True)
    lowp.Fp8Forward(lin)(y).sum().backward()
    want = lin.weight.detach().sum(0).expand_as(y)  # through the rounded weight
    assert float((y.grad - want).norm() / want.norm()) < 0.1
    a, b = torch.randn(16, 32, dtype=torch.float64), torch.randn(32, 8, dtype=torch.float64)

    class Product(torch.nn.Module):
        def forward(self, u, v):
            return u @ v

    rounded = lowp.Fp8Forward(Product())(a, b)
    assert 1e-3 < float((rounded - a @ b).norm() / (a @ b).norm()) < 0.2


@pytest.mark.gpu
def test_reference_runs_on_the_card():
    """The plain reference at a cell's own widths on the card: one fp32 SDXL
    UNet forward of a CFG pair at 1024² (what the serving check runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import weights

    cfg = harness.config(harness.manifest(), "sdxl-base-pea-zh")
    unet = weights.reference_module(cfg, "unet", SEED, "cuda")
    with torch.no_grad(), checks.fp32_exact():
        out = unet(torch.randn(2, 128, 128, 4, device="cuda"),
                   torch.tensor([999, 999], device="cuda"),
                   torch.randn(2, 52, 2048, device="cuda"),
                   {"text_embeds": torch.randn(2, 1280, device="cuda"),
                    "time_ids": torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]],
                                             device="cuda").repeat(2, 1)})
    assert out.shape == (2, 128, 128, 4) and bool(torch.isfinite(out).all())
