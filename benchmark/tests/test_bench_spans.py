"""The attribution of device events to the program's spans
(benchmark/spans.py) on synthetic event lists, one a case: a kernel under
nested spans (with a torch op sharing its launch's correlation id), a launch
from the autograd engine's thread with no span open, a backward node joined
to its forward op under ``groupnorm`` by its sequence number (and a
recompute inside a node, which is not), an unattributed kernel, and
GPU-side ``pea/`` annotations, which never count as device work. Then each
reader of those spans on a synthetic serving period and training steps,
and None with no trace or with a trace without spans."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans

SERVE = ("turnaround_ms.serve", "refill_wait_ms.serve", "call_idle_ms.serve",
         "unet_launches.serve", "groupnorm_ms.serve")
TRAIN = ("vae_encode_ms.train", "student_ms.train", "teacher_ms.train", "backward_ms.train",
         "groupnorm_ms.train")


class Trace:
    """A synthetic ``prof.events()`` list, built call by call."""

    def __init__(self):
        self.events = []
        self.ids = iter(range(1000, 10 ** 6))

    def host(self, name, s, t, thread=1, seq=-1, fwd=0, eid=None):
        self.events.append(SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=s, end=t), device_type=DeviceType.CPU,
            is_user_annotation=name.startswith("pea/"), thread=thread, fwd_thread=fwd,
            sequence_nr=seq, id=next(self.ids) if eid is None else eid))

    def span(self, name, s, t, thread=1):
        self.host("pea/" + name, s, t, thread)

    def kernel(self, at, s, t, thread=1, name="kernel", launch="cudaLaunchKernel", eid=None):
        """A device event [s, t] launched at host time `at` on `thread`."""
        eid = next(self.ids) if eid is None else eid
        self.host(launch, at, at + 1, thread, eid=eid)
        self.device(name, s, t, eid)

    def device(self, name, s, t, eid, annotation=False):
        self.events.append(SimpleNamespace(
            name=name, time_range=SimpleNamespace(start=s, end=t), device_type=DeviceType.CUDA,
            is_user_annotation=annotation, thread=1, fwd_thread=0, sequence_nr=-1, id=eid))


def _one(found, name="kernel"):
    [d] = [d for d in found.device if d.name == name]
    return d


def test_a_kernel_under_nested_spans():
    tr = Trace()
    tr.span("engine.call", 0, 100)
    tr.span("pipe.sampler_step", 10, 90)
    tr.span("pipe.unet", 20, 80)
    tr.span("groupnorm", 30, 40)
    tr.kernel(35, 50, 52, eid=7)
    tr.host("aten::mul", 85, 88, eid=7)  # a torch op with the launch's id: not a launch
    d = _one(spans.attribute(tr.events))
    assert d.under == ("engine.call", "pipe.sampler_step", "pipe.unet")
    assert d.phase == "pipe.unet" and d.component == "groupnorm"


def test_a_launch_from_the_autograd_thread_with_no_span_open():
    tr = Trace()
    tr.span("kd.student", 0, 90)
    tr.span("kd.backward", 100, 200)
    tr.kernel(150, 150, 160, thread=2, name="grad")
    tr.span("groupnorm", 170, 180, thread=2)  # a recompute's own span on that thread
    tr.kernel(175, 175, 178, thread=2, name="recompute", launch="cuLaunchKernel")
    found = spans.attribute(tr.events)
    assert _one(found, "grad").under == ("kd.backward",)
    assert _one(found, "grad").component is None
    assert _one(found, "recompute").phase == "kd.backward"
    assert _one(found, "recompute").component == "groupnorm"


def test_a_backward_node_joins_its_forward_op_under_groupnorm():
    tr = Trace()
    tr.span("kd.student", 0, 90)
    tr.span("groupnorm", 20, 40)
    tr.host("aten::native_group_norm", 25, 30, seq=5)
    tr.host("aten::silu", 32, 35, seq=6)
    tr.host("aten::mul", 50, 55, seq=7)  # outside the norm
    tr.span("kd.backward", 100, 300)
    tr.host("NativeGroupNormBackward0", 110, 130, thread=2, seq=5, fwd=1)
    tr.host("aten::native_group_norm_backward", 112, 128, thread=2)
    tr.kernel(115, 115, 125, thread=2, name="gn_bwd")
    tr.host("MulBackward0", 140, 150, thread=2, seq=7, fwd=1)
    tr.kernel(145, 145, 148, thread=2, name="mul_bwd")
    # the checkpoint's recompute runs inside the first node that unpacks
    tr.host("SiluBackward0", 160, 260, thread=2, seq=6, fwd=1)
    tr.host("aten::convolution", 170, 200, thread=2, seq=3)
    tr.kernel(180, 180, 190, thread=2, name="recompute_conv")
    tr.kernel(250, 250, 255, thread=2, name="silu_bwd")
    found = spans.attribute(tr.events)
    assert _one(found, "gn_bwd").component == "groupnorm"
    assert _one(found, "silu_bwd").component == "groupnorm"
    assert _one(found, "mul_bwd").component is None
    assert _one(found, "recompute_conv").component is None
    assert {d.phase for d in found.device} == {"kd.backward"}


def test_unattributed_kernels():
    tr = Trace()
    tr.span("kd.loss", 0, 10)
    tr.device("orphan", 20, 30, eid=55)  # no launch joins it
    tr.kernel(50, 50, 60, name="outside")  # launched outside every span
    found = spans.attribute(tr.events)
    assert _one(found, "orphan").phase is None and _one(found, "outside").under == ()
    assert spans.report(found)["device_s"] == pytest.approx({"unattributed": 20e-6})


def test_gpu_side_annotations_are_never_device_work():
    tr = Trace()
    tr.span("engine.call", 0, 100)
    tr.kernel(10, 20, 30)
    tr.device("pea/engine.call", 20, 90, eid=1, annotation=True)
    tr.device("pea/pipe.unet", 20, 90, eid=2)  # not flagged: still an annotation by name
    tr.device("bench/engine.call", 20, 90, eid=3)
    found = spans.attribute(tr.events)
    assert [d.name for d in found.device] == ["kernel"]
    assert found.idle_us(0, 100) == pytest.approx(90)


def _ctx(tr, **kw):
    sub = SimpleNamespace(done=True, prof=SimpleNamespace(events=lambda: tr.events))
    return {"subwindow": sub, **kw}


def _serving_period():
    """One engine period (us): the call with its prompt encoding, one step
    (a UNet forward with a GroupNorm, then the CFG combine), the decode
    (with a GroupNorm), the images' copy, then the turn-around."""
    tr = Trace()
    tr.span("engine.call", 0, 1000)
    tr.span("pipe.encode_prompt", 10, 50)
    tr.kernel(20, 60, 100)
    tr.span("pipe.sampler_step", 100, 500)
    tr.span("pipe.unet", 110, 400)
    tr.kernel(120, 130, 200)
    tr.span("groupnorm", 210, 260)
    tr.kernel(220, 230, 250)
    tr.kernel(410, 420, 430)
    tr.span("pipe.decode", 600, 900)
    tr.kernel(610, 700, 850)
    tr.span("groupnorm", 620, 640)
    tr.kernel(625, 850, 860)
    tr.span("engine.to_pil", 1000, 1100)
    tr.kernel(1010, 1020, 1030, name="Memcpy DtoH", launch="cudaMemcpyAsync")
    tr.span("engine.refill_wait", 1100, 1500)
    tr.span("engine.batch_window", 1500, 1650)
    tr.span("engine.prepare", 1650, 1700)
    tr.host("cudaDeviceSynchronize", 1700, 1710)
    tr.device("pea/engine.call", 60, 860, eid=0, annotation=True)
    return tr


def _training_steps():
    """Two steps' worth of phases (us) on the main thread (1) and the
    autograd engine's (2), read as `trace_steps` = 2."""
    tr = Trace()
    tr.span("train.h2d", 0, 10)
    tr.kernel(5, 6, 16, name="Memcpy HtoD", launch="cudaMemcpyAsync")
    tr.span("kd.vae_encode", 10, 100)
    tr.kernel(20, 20, 60)
    tr.span("groupnorm", 30, 40)
    tr.kernel(35, 60, 70)  # the VAE's norm: not the UNets'
    tr.kernel(105, 100, 102, name="draw")  # the noise draws: no span
    tr.span("kd.student", 110, 300)
    tr.kernel(120, 120, 180)
    tr.span("groupnorm", 190, 210)
    tr.host("aten::native_group_norm", 195, 205, seq=5)
    tr.host("aten::silu", 206, 208, seq=6)
    tr.kernel(200, 200, 230)
    tr.span("kd.loss", 300, 320)
    tr.kernel(310, 310, 315)
    tr.span("kd.teacher", 320, 400)
    tr.kernel(330, 330, 380)
    tr.span("kd.backward", 400, 800)
    tr.host("NativeGroupNormBackward0", 410, 430, thread=2, seq=5, fwd=1)
    tr.kernel(420, 420, 460, thread=2)
    tr.host("SiluBackward0", 450, 600, thread=2, seq=6, fwd=1)
    tr.host("aten::convolution", 460, 500, thread=2, seq=2)
    tr.kernel(470, 470, 520, thread=2)
    tr.span("groupnorm", 510, 540, thread=2)
    tr.kernel(520, 520, 545, thread=2)
    tr.span("kd.optimizer", 800, 900)
    tr.kernel(810, 810, 830)
    return tr


def test_serving_readers():
    ctx = _ctx(_serving_period())
    got = {m: harness.reader(m)(ctx) for m in SERVE}
    assert got == pytest.approx({
        "turnaround_ms.serve": (1710 - 1030) / 1e3,
        "refill_wait_ms.serve": 400 / 1e3,
        "call_idle_ms.serve": (800 - (40 + 70 + 20 + 10 + 150 + 10)) / 1e3,
        "unet_launches.serve": 2.0,
        "groupnorm_ms.serve": 20 / 1e3})


def test_training_readers():
    ctx = _ctx(_training_steps(), trace_steps=2)
    got = {m: harness.reader(m)(ctx) for m in TRAIN}
    assert got == pytest.approx({
        "vae_encode_ms.train": (40 + 10) / 2 / 1e3,
        "student_ms.train": (60 + 30) / 2 / 1e3,
        "teacher_ms.train": 50 / 2 / 1e3,
        "backward_ms.train": (40 + 50 + 25) / 2 / 1e3,
        "groupnorm_ms.train": (30 + 40 + 25) / 2 / 1e3})
    rep = spans.report(spans.of(ctx))
    assert rep["device_s"]["unattributed"] == pytest.approx(2e-6)
    assert sum(rep["device_s"].values()) == pytest.approx(
        sum(d.end - d.start for d in spans.of(ctx).device) / 1e6)
    assert rep["component_s"] == pytest.approx({"groupnorm": 105e-6})


def test_idle_stretches_are_named_by_the_main_threads_span():
    """Each stretch with no device event, before the first and after the
    last too, by the innermost phase span over its middle."""
    rep = spans.report(spans.attribute(_serving_period().events))
    assert rep["idle_s"] == pytest.approx({
        "pipe.encode_prompt": 60e-6, "pipe.unet": (30 + 30 + 170) * 1e-6,
        "engine.call": (270 + 160) * 1e-6, "engine.refill_wait": 680e-6})


@pytest.mark.parametrize("metric", SERVE + TRAIN)
def test_readers_read_nothing_without_spans(metric):
    read = harness.reader(metric)
    assert read({}) is None
    assert read({"subwindow": SimpleNamespace(done=False, prof=None)}) is None
    parent = Trace()  # the benchmark's own ranges and kernels, no program span
    parent.host("bench/engine.call", 0, 100)
    parent.kernel(10, 10, 20)
    assert read(_ctx(parent, trace_steps=2)) is None


def test_a_real_profile_is_read():
    """The fields the attribution reads exist on the profiler's own events
    (here a CPU profile of the program's spans: no device event)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pea_diffusion_tpu_torch.utils.trace import span

    w = torch.ones(4, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("kd.student"), span("groupnorm"):
            y = torch.nn.functional.group_norm(torch.randn(2, 4, 3, 3) * w[None, :, None, None], 2)
        with span("kd.backward"):
            y.sum().backward()
    found = spans.attribute(prof.events())
    assert [s.name for s in found.spans] == ["kd.student", "groupnorm", "kd.backward"]
    assert found.device == [] and found.host_end > found.host_start
