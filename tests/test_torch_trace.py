"""The port's spans (utils/trace.py): with no profiler running a span is the
shared no-op object and builds no ``record_function``; under a CPU
``torch.profiler`` the tiny stacks show the engine, pipeline, GroupNorm and
KD-step spans with their parents and counts: a ``BatchingEngine`` whose
profiler is started inside a wrapper of ``engine.run`` (as a benchmark
starts one), ``generate_sdxl`` at 2 steps, and one ``KDTrainer.fit`` step.
A span opened on a thread that did not start the profiler (an HTTP
handler's) is not recorded."""
import threading
from collections import Counter

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_parity import one_torch_thread  # noqa: F401
from pea_diffusion_tpu_torch.cli import generate as gen_cli
from pea_diffusion_tpu_torch.cli import train as train_cli
from pea_diffusion_tpu_torch.cli.serve import BatchingEngine
from pea_diffusion_tpu_torch.configs import TrainConfig
from pea_diffusion_tpu_torch.models.layers import GroupNorm
from pea_diffusion_tpu_torch.pipelines import StableDiffusionXLPEAPipeline
from pea_diffusion_tpu_torch.pipelines.text2image import generate_sdxl
from pea_diffusion_tpu_torch.train.trainer import KDTrainer
from pea_diffusion_tpu_torch.utils import trace

TIMEOUT = 120  # seconds a test waits on a request or a thread
SIZE = 64  # image side of the tiny stacks' calls


def _groupnorms(module) -> int:
    return sum(isinstance(m, GroupNorm) for m in module.modules())


def _spans(events):
    """[(name, parent)] of the pea/ host ranges, each with the innermost
    pea/ range around it on its thread (None at the top)."""
    out = []
    for e in events:
        if not e.name.startswith(trace.PREFIX) or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(trace.PREFIX):
            p = p.cpu_parent
        out.append((e.name[len(trace.PREFIX):],
                    None if p is None else p.name[len(trace.PREFIX):]))
    return out


def _profile(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof.events())


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler running")

    monkeypatch.setattr(trace, "record_function", refuse)
    assert trace.span("engine.call", "8") is trace.NO_SPAN
    with trace.span("x"), trace.span("y"):  # the shared object nests
        pass
    gn = GroupNorm(8, 2, act="silu")  # a program site takes the same gate
    x = torch.randn(2, 8, 4, 4)
    torch.testing.assert_close(gn(x), torch.nn.functional.silu(
        torch.nn.functional.group_norm(x, 2, gn.weight, gn.bias, gn.eps)))


def test_span_under_a_profiler_is_a_named_range():
    def nested():
        with trace.span("outer", "8"):
            with trace.span("inner"):
                torch.ones(2) + 1

    assert _profile(nested) == [("outer", None), ("inner", "outer")]


def test_generate_sdxl_spans():
    models, tokenize, _ = gen_cli.build_demo("cpu")
    ids = tokenize(["一只猫"])
    spans = _profile(lambda: generate_sdxl(models, ids, tokenize([""]), height=SIZE,
                                           width=SIZE, num_steps=2,
                                           init_noise=np.zeros((1, SIZE // 8, SIZE // 8, 4),
                                                               np.float32)))
    n_unet, n_dec = _groupnorms(models.unet), _groupnorms(models.vae.decoder)
    assert n_unet > 0 and n_dec > 0
    assert Counter(spans) == Counter({
        ("pipe.encode_prompt", None): 1, ("pipe.sampler_step", None): 2,
        ("pipe.unet", "pipe.sampler_step"): 2, ("pipe.decode", None): 1,
        ("groupnorm", "pipe.unet"): 2 * n_unet, ("groupnorm", "pipe.decode"): n_dec})


def test_engine_spans_with_the_profiler_started_in_a_wrapper_of_run():
    models, tokenize, _ = gen_cli.build_demo("cpu")
    pipe = StableDiffusionXLPEAPipeline(models, "dpm++")
    engine = BatchingEngine(pipe, tokenize, SIZE, max_batch=2, window_ms=1)
    prof = profile(activities=[ProfilerActivity.CPU])
    calls, run = [], engine.run

    def wrapped(spec):  # one whole period: from a call's start to the next's
        calls.append(spec)
        if len(calls) == 1:
            prof.start()
        else:
            prof.stop()
        return run(spec)

    engine.run = wrapped
    try:
        engine.submit("一只猫", "", 2, 7.5, 0.0, 1)
        with trace.span("handler"):  # this thread did not start the profiler
            engine.submit("一只狗", "", 2, 7.5, 0.0, 2)
    finally:
        engine.close(TIMEOUT)
    assert not engine._thread.is_alive() and len(calls) == 2
    spans = _spans(prof.events())
    n_unet, n_dec = _groupnorms(models.unet), _groupnorms(models.vae.decoder)
    assert Counter(spans) == Counter({
        ("engine.call", None): 1, ("pipe.encode_prompt", "engine.call"): 1,
        ("pipe.sampler_step", "engine.call"): 2, ("pipe.unet", "pipe.sampler_step"): 2,
        ("pipe.decode", "engine.call"): 1, ("groupnorm", "pipe.unet"): 2 * n_unet,
        ("groupnorm", "pipe.decode"): n_dec, ("engine.to_pil", None): 1,
        ("engine.refill_wait", None): 1, ("engine.batch_window", None): 1,
        ("engine.prepare", None): 1})


def test_kd_fit_step_spans(tmp_path):
    models, make_batches = train_cli.build_demo("cpu", batch_size=2, model="sd15")
    trainer = KDTrainer(models, TrainConfig(output_dir=str(tmp_path), batch_size_per_device=2,
                                            log_every_n_steps=100, every_n_steps=100))
    spans = _profile(lambda: trainer.fit(make_batches(0), max_steps=1))
    n_unet, n_enc = _groupnorms(models.unet), _groupnorms(models.vae.encoder)
    assert models.remat and models.remat_policy == "full"
    assert Counter(spans) == Counter({
        ("train.h2d", None): 1, ("kd.vae_encode", None): 1, ("kd.student", None): 1,
        ("kd.teacher", None): 1, ("kd.loss", None): 2, ("kd.backward", None): 1,
        ("kd.optimizer", None): 1, ("groupnorm", "kd.vae_encode"): n_enc,
        ("groupnorm", "kd.student"): n_unet, ("groupnorm", "kd.teacher"): n_unet,
        # the checkpointed student forward runs again in the backward
        ("groupnorm", "kd.backward"): n_unet})


def test_a_span_on_another_thread_is_not_recorded():
    """What the profiler sees of threads: the one that started it, not a
    thread it did not start (an HTTP handler's PNG encode)."""
    def other():
        with trace.span("other"):
            torch.ones(2) + 1

    def run():
        t = threading.Thread(target=other)
        t.start()
        t.join(TIMEOUT)
        assert not t.is_alive()
        with trace.span("own"):
            torch.ones(2) + 1

    assert _profile(run) == [("own", None)]
