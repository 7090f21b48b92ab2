"""The ControlNet serving cell's pieces on the CPU at tiny sizes: its driver
end to end under the cell's own limits (``limits/sdxl-controlnet-serve-c8
.json``): a sound run passes; the control (the program's int8 UNet convs
and bf16 VAE with the ControlNet's products in fp8) and a planted fault,
the conditioning scale applied as one number a call where each row has its
own, fail. A program without the ControlNet serving path is refused before
any weight is made. Then the edge maps, the ControlNet's attention cores
and FLOPs against hand counts, and the new readers on a recorded period.
The readings at the cell's own size come from the chip (PERF.md)."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import harness, roofline, roofline_controlnet, spans
from benchmark.drivers import serve_controlnet
from benchmark.tests import tiny
from benchmark.tests.test_bench_spans import Trace, _ctx

SEED = 2 ** 31 + 31
LIMITS = harness.limits("sdxl-controlnet-serve-c8")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config():
    """tiny.sdxl() and a ControlNet of its UNet's widths (embedder 8/8/16/16:
    64 px maps to 8 px latents)."""
    cfg = tiny.sdxl()
    cn = {k: v for k, v in cfg["components"]["unet"]["config"].items() if k != "out_channels"}
    cn.update(conditioning_channels=3, conditioning_embedding_out_channels=[8, 8, 16, 16])
    cfg["components"]["controlnet"] = {"config": cn, "weights_dtype": "float32"}
    return cfg


def mix():
    return tiny.serve(driver="serve_controlnet", control_scale=[0.5, 1.0],
                      edge_cover=[0.05, 0.12], map_pool=4)


def run(variant="program"):
    return serve_controlnet.run(config(), mix(), LIMITS, SEED, 1.0, False, time.perf_counter(),
                                device="cpu", variant=variant)


def test_a_sound_run_passes():
    res = run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert set(res["checks"]) == {"start_gap", "control_gap", "pair_gap", "step_gap",
                                  "image_gap_max"}
    assert harness.reader("rows_per_call.serve")(res["ctx"]) == 2.0


def test_the_control_fails():
    res = run("control")
    assert not res["correct"], res["checks"]


def test_one_scale_a_call_fails(monkeypatch):
    """The planted fault: the call's mean conditioning scale for every row."""
    from pea_diffusion_tpu_torch.pipelines import controlnet

    call = controlnet.StableDiffusionXLControlNetPEAPipeline.__call__

    def one_scale(self, *args, controlnet_conditioning_scale=1.0, **kw):
        return call(self, *args, **kw, controlnet_conditioning_scale=float(
            np.mean(controlnet_conditioning_scale)))

    monkeypatch.setattr(controlnet.StableDiffusionXLControlNetPEAPipeline, "__call__",
                        one_scale)
    res = run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["control_gap"]["value"] > res["checks"]["control_gap"]["limit"]


def test_a_program_without_controlnet_serving_is_refused(monkeypatch):
    from pea_diffusion_tpu_torch.pipelines import controlnet

    from benchmark import port_stack

    monkeypatch.delattr(controlnet, "StableDiffusionXLControlNetPEAPipeline")
    monkeypatch.setattr(port_stack, "serving_models",
                        lambda *a, **k: pytest.fail("weights made for a refused program"))
    with pytest.raises(SystemExit, match="serves no ControlNet"):
        run()


def test_edge_maps_cover_their_share():
    a = serve_controlnet.edge_map(SEED, 0, 256, (0.05, 0.12))
    assert a.dtype == np.uint8 and a.shape == (256, 256) and set(np.unique(a)) == {0, 255}
    share = np.count_nonzero(a) / a.size
    assert 0.05 <= share <= 0.14  # the last batch of strokes may pass the drawn share
    assert np.array_equal(a, serve_controlnet.edge_map(SEED, 0, 256, (0.05, 0.12)))
    assert not np.array_equal(a, serve_controlnet.edge_map(SEED, 1, 256, (0.05, 0.12)))


def test_controlnet_attention_and_flops_against_the_unets():
    cfg = config()
    unet, cn = (cfg["components"][k]["config"] for k in ("unet", "controlnet"))
    calls = roofline_controlnet.controlnet_attention(cn, 8, 8, 12)
    # the UNet's down and mid cores, in order: level 1 depth 1, level 2 and
    # the mid block depth 2, a self and a cross call per block
    assert len(calls) == 2 * (2 * 1 + 2 * 2 + 2)
    assert [c[:4] for c in calls] == [c[:4] for c in roofline.unet_attention(unet, 8, 8, 12)
                                      [:len(calls)]]
    tr = mix()
    base = roofline.serve_flops_per_image(cfg, tr)
    with_cn = roofline_controlnet.serve_flops_per_image(cfg, tr)
    # the embedder's first conv alone: 2 x 3 x 8 x 9 a pixel of the 64 px map
    assert with_cn - base > tr["steps"] * 2 * (2 * 3 * 8 * 9 * 64 * 64)


def _cn_period():
    """One step of an engine period (us): the ControlNet forward (its
    embedder, a GroupNorm, a zero conv) then the UNet's (a GroupNorm, a
    kernel), under one sampler step."""
    tr = Trace()
    tr.span("engine.call", 0, 1000)
    tr.span("pipe.sampler_step", 100, 900)
    tr.span("pipe.controlnet", 110, 400)
    tr.span("controlnet.cond_embed", 120, 200)
    tr.kernel(130, 130, 170)
    tr.kernel(150, 170, 180)
    tr.span("groupnorm", 250, 280)
    tr.kernel(260, 260, 290)
    tr.kernel(300, 300, 340, name="wgmma_attention_kernel<bf16>")
    tr.span("pipe.unet", 410, 800)
    tr.span("groupnorm", 420, 450)
    tr.kernel(430, 430, 440)
    tr.kernel(500, 500, 600, name="wgmma_attention_kernel<bf16>")
    tr.kernel(700, 700, 720)
    return tr


def test_the_new_readers_on_a_recorded_period():
    ctx = _ctx(_cn_period())
    read = {m: harness.reader(m)(ctx) for m in (
        "controlnet_ms.cn_serve", "cond_embed_ms.cn_serve", "unet_launches.serve",
        "groupnorm_ms.serve")}
    assert read == pytest.approx({"controlnet_ms.cn_serve": (40 + 10 + 30 + 40) / 1e3,
                                  "cond_embed_ms.cn_serve": 50 / 1e3,
                                  "unet_launches.serve": 3.0,
                                  "groupnorm_ms.serve": 10 / 1e3})
    cfg, tr = config(), mix()
    kernels = [(d.name, d.start, d.end) for d in spans.of(ctx).device]
    trace = {"kernels": kernels, "busy_s": 1.0, "window_s": 1.0}
    rows = {"trace": trace, "trace_forwards": [4], "trace_controlnet_forwards": [4],
            "traffic": tr, "config": cfg}
    # at 64 px no core is as long as the kernels take: nothing of their time is least time
    assert harness.reader("attn_roofline.cn_serve")(rows) == 0.0
    big = dict(tr, size=1024)
    lat = 128
    least = roofline.attention_least_s(roofline.unet_attention(
        cfg["components"]["unet"]["config"], lat, lat, tr["max_length"]), 4) + \
        roofline.attention_least_s(roofline_controlnet.controlnet_attention(
            cfg["components"]["controlnet"]["config"], lat, lat, tr["max_length"]), 4)
    assert least > 0
    assert harness.reader("attn_roofline.cn_serve")(dict(rows, traffic=big)) == \
        pytest.approx(100 * least / 140e-6)
    mfu = harness.reader("mfu.cn_serve")({"window_s": 2.0, "images": 4, "trace": trace,
                                          "config": cfg, "traffic": tr})
    assert mfu == pytest.approx(
        100 * 4 * roofline_controlnet.serve_flops_per_image(cfg, tr) / (2 * 989e12))


@pytest.mark.parametrize("metric", ["controlnet_ms.cn_serve", "cond_embed_ms.cn_serve",
                                    "attn_roofline.cn_serve", "mfu.cn_serve"])
def test_the_new_readers_read_nothing_from_a_program_without_them(metric):
    read = harness.reader(metric)
    assert read({}) is None
    parent = Trace()  # the plain pipeline's spans only
    parent.span("pipe.unet", 0, 100)
    parent.kernel(10, 10, 20)
    assert read(_ctx(parent)) is None
