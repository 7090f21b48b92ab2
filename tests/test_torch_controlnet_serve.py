"""ControlNet requests on the port's serving path, held against the plain fp32
reference (``benchmark/reference/controlnet.py`` with the UNet, VAE, tower
and adapter of ``benchmark/reference/models.py``: torch only, no JAX, no
kernel of the port) at a tiny size on the CPU: the residuals and the UNet
fed with them; BatchingEngine co-batching maps, conditioning scales and
guidance, against solo calls and against the reference's own pipeline;
plain and ControlNet requests kept in separate calls; the HTTP round trip
with a base64 map and its 400s; the spans a step opens; the CLI's flags.

Tolerances: fp32 on both sides, so the residuals and the UNet's output
agree to a few ulps of their norms (1e-5 relative leaves ~10x room over the
~1e-6 measured); images are uint8 levels, where values a rounding apart
may land on either side of a level's edge (1 level)."""
import base64
import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import one_torch_thread  # noqa: F401
from benchmark import port_stack, weights
from benchmark.reference import checks, diffusion
from benchmark.reference import controlnet as ref_cn
from benchmark.tests import tiny
from pea_diffusion_tpu_torch.cli import serve
from pea_diffusion_tpu_torch.cli.generate import make_tokenizer
from pea_diffusion_tpu_torch.cli.serve import BatchingEngine, make_server
from pea_diffusion_tpu_torch.configs.unet import ControlNetConfig
from pea_diffusion_tpu_torch.models.controlnet import ControlNet
from pea_diffusion_tpu_torch.pipelines import StableDiffusionXLControlNetPEAPipeline
from pea_diffusion_tpu_torch.pipelines.controlnet import generate_sdxl_controlnet
from pea_diffusion_tpu_torch.pipelines.factory import load_weights

TIMEOUT = 120  # seconds a test waits on a request or a thread
SEED, SIZE, STEPS, LENGTH = 2 ** 31 + 41, 64, 2, 8


def config():
    """The tiny SDXL stack of the benchmark's CPU tests and a ControlNet of
    its UNet's widths (embedder 8/8/16/16: 64 px maps to 8 px latents)."""
    cfg = tiny.sdxl()
    cn = {k: v for k, v in cfg["components"]["unet"]["config"].items() if k != "out_channels"}
    cn.update(conditioning_channels=3, conditioning_embedding_out_channels=[8, 8, 16, 16])
    cfg["components"]["controlnet"] = {"config": cn, "weights_dtype": "float32"}
    return cfg


def port_controlnet(cfg):
    comp = cfg["components"]["controlnet"]
    with torch.device("meta"):
        cn = ControlNet(ControlNetConfig.from_diffusers_config(comp["config"]))
    return load_weights(cn, ref_cn.controlnet_state(SEED, comp["config"], torch.float32, "cpu"),
                        torch.float32, "cpu", "controlnet")


@pytest.fixture(scope="module")
def stack():
    cfg = config()
    models = port_stack.serving_models(cfg, SEED, "cpu")
    vocab = cfg["components"]["text_encoder"]["config"]["vocab_size"]
    return cfg, models, port_controlnet(cfg), make_tokenizer(vocab, LENGTH)


def edge_map(seed, size=SIZE):
    """A uint8 [size, size, 3] map of white lines on black."""
    rng = np.random.default_rng(seed)
    arr = np.zeros((size, size), np.uint8)
    for _ in range(6):
        r, c = rng.integers(0, size, 2)
        arr[r, :] = 255 if rng.integers(2) else 0
        arr[:, c] = 255
    return np.repeat(arr[..., None], 3, axis=-1)


def png_b64(arr, mode=None):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def inputs(cfg, b=2):
    g = torch.Generator().manual_seed(3)
    u = cfg["components"]["unet"]["config"]
    pooled = u["projection_class_embeddings_input_dim"] - 6 * u["addition_time_embed_dim"]
    return dict(x=torch.randn(b, 8, 8, 4, generator=g), t=torch.tensor([999, 500][:b]),
                ctx=torch.randn(b, 6, u["cross_attention_dim"], generator=g),
                cond=torch.rand(b, SIZE, SIZE, 3, generator=g),
                added={"text_embeds": torch.randn(b, pooled, generator=g),
                       "time_ids": torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]] * b,
                                                dtype=torch.float32)})


def rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_residuals_and_the_unet_fed_by_them_match_the_plain_reference(stack):
    cfg, models, cn, _ = stack
    ref = ref_cn.reference_controlnet(cfg, SEED, "cpu")
    unet = weights.reference_module(cfg, "unet", SEED, "cpu")
    i = inputs(cfg)
    scale = torch.tensor([0.5, 0.9])
    with torch.no_grad():
        down, mid = cn(i["x"], i["t"], i["ctx"], i["cond"], scale.reshape(2, 1, 1, 1),
                       i["added"])
        r_down, r_mid = ref(i["x"], i["t"], i["ctx"], i["cond"], scale, i["added"])
        assert len(down) == len(r_down) == 9  # conv_in, 2 a level, 2 downsamplers
        for a, b in zip(list(down) + [mid], r_down + [r_mid]):
            assert rel(a, b) <= 1e-5
        # the rows' scales reach their own rows only
        one, _ = cn(i["x"][:1], i["t"][:1], i["ctx"][:1], i["cond"][:1], 0.5,
                    {k: v[:1] for k, v in i["added"].items()})
        assert rel(one[3], down[3][:1]) <= 1e-5
        got = models.unet(i["x"], i["t"], i["ctx"], i["added"],
                          down_block_additional_residuals=r_down,
                          mid_block_additional_residual=r_mid)
        want = ref_cn.unet_with_residuals(unet, i["x"], i["t"], i["ctx"], i["added"],
                                          r_down, r_mid)
        assert rel(got, want) <= 1e-5
        assert rel(want, unet(i["x"], i["t"], i["ctx"], i["added"])) > 1e-3  # they count


def reference_image(cfg, tokenize, prompt, guidance, scale, control, seed):
    """The plain reference's pipeline for one request: the tower and the
    adapter on the prompt and the empty negative prompt, DPM-Solver++ over
    STEPS steps with the ControlNet and the UNet on the CFG pair each step,
    the decode; uint8 [H, W, 3]."""
    solver = diffusion.DPMSolver(cfg["scheduler"], STEPS)
    with torch.no_grad():
        text = weights.reference_module(cfg, "text_encoder", SEED, "cpu")
        adapter = weights.reference_module(cfg, "adapter", SEED, "cpu")
        unet = weights.reference_module(cfg, "unet", SEED, "cpu")
        vae = weights.reference_module(cfg, "vae", SEED, "cpu")
        cn = ref_cn.reference_controlnet(cfg, SEED, "cpu")
        pooled, seq = adapter(text(torch.as_tensor(tokenize(["", prompt]))))
        added = {"text_embeds": pooled,
                 "time_ids": torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]] * 2,
                                          dtype=torch.float32)}
        cond = torch.as_tensor(control)[None].repeat(2, 1, 1, 1)
        x = torch.as_tensor(checks.request_noise(seed, SIZE // 8))
        prev = None
        for i in range(STEPS):
            t = torch.full((2,), int(solver.t[i]))
            down, mid = cn(torch.cat([x, x]), t, seq, cond, scale, added)
            pair = ref_cn.unet_with_residuals(unet, torch.cat([x, x]), t, seq, added, down, mid)
            eps = diffusion.cfg_combine(pair[:1], pair[1:], [guidance])
            x, prev = solver.step(i, x, eps, prev), solver.x0(i, x, eps)
        img = vae.decode(x / cfg["components"]["vae"]["config"]["scaling_factor"])
    return np.asarray(torch.round(torch.clamp(img / 2 + 0.5, 0, 1)[0] * 255), np.int16)


@pytest.fixture
def engines():
    made = []

    def make(*args, **kwargs):
        made.append(BatchingEngine(*args, **kwargs))
        return made[-1]

    yield make
    for e in made:
        e.close(TIMEOUT)
        assert not e._thread.is_alive()


def _submit_many(engine, reqs):
    out, errs = [None] * len(reqs), [None] * len(reqs)

    def call(i, r):
        args, kw = r
        try:
            out[i] = engine.submit(*args, **kw)
        except Exception as e:
            errs[i] = e

    ts = [threading.Thread(target=call, args=(i, r)) for i, r in enumerate(reqs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
        assert not t.is_alive(), "a request did not finish"
    return out, errs


def _pixels(img):
    return np.asarray(img, np.int16)


MAPS = [edge_map(k) for k in range(3)]
# three requests, each with its own map, scale and guidance: padded to 4 rows
REQUESTS = [(("一只戴着帽子的可爱猫咪", "", STEPS, 7.5, 0.0, 3),
             {"control": MAPS[0] / np.float32(255), "control_scale": 0.5}),
            (("雪山下的湖泊", "", STEPS, 5.0, 0.0, 11),
             {"control": MAPS[1] / np.float32(255), "control_scale": 1.0}),
            (("一只猫", "", STEPS, 8.5, 0.0, 2 ** 31 + 4),
             {"control": MAPS[2] / np.float32(255), "control_scale": 0.75})]


def test_cobatched_rows_match_solo_calls_and_the_plain_reference(stack, engines):
    cfg, models, cn, tokenize = stack
    pipe = StableDiffusionXLControlNetPEAPipeline(models, cn, "dpm++")
    cob = engines(pipe, tokenize, SIZE, max_batch=3, window_ms=60_000)
    solo = engines(pipe, tokenize, SIZE, max_batch=1, window_ms=10)
    got, errs = _submit_many(cob, REQUESTS)
    assert errs == [None] * 3
    assert cob.stats == {"device_calls": 1, "requests_batched": 3, "vector_cfg_calls": 1,
                         "batch_hist": {"3": 1}, "controlnet_calls": 1,
                         "controlnet_rows": 3}
    for (args, kw), img, levels in zip(REQUESTS, got, MAPS):
        alone, errs = _submit_many(solo, [(args, kw)])
        assert errs == [None]
        assert np.abs(_pixels(alone[0]) - _pixels(img)).max() <= 1
        want = reference_image(cfg, tokenize, args[0], args[3], kw["control_scale"],
                               levels / np.float32(255), args[5])
        assert np.abs(_pixels(img) - want).max() <= 1
    assert len({_pixels(g).tobytes() for g in got}) == 3
    # the maps and scales change the rows: scale 0 is text to image
    plain, _ = _submit_many(solo, [(REQUESTS[0][0], {})])
    off, _ = _submit_many(solo, [(REQUESTS[0][0], dict(REQUESTS[0][1], control_scale=0.0))])
    assert np.abs(_pixels(plain[0]) - _pixels(off[0])).max() <= 1
    assert np.abs(_pixels(plain[0]) - _pixels(got[0])).max() > 1


class FakePipe:
    """Records each call and its operands; a ControlNet stands in by its
    attribute alone."""

    controlnet = object()

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, ids, uncond_ids, *, height, width, num_steps, guidance_scale,
                 guidance_rescale, init_noise, **control):
        with self.lock:
            self.calls.append({"n": len(ids), "g": guidance_scale, **control})
        return torch.zeros(len(ids), 2, 2, 3)


def test_plain_and_controlnet_requests_go_in_separate_calls(engines):
    pipe = FakePipe()
    eng = engines(pipe, lambda t: np.zeros((len(t), 4), np.int64), size=16, max_batch=8,
                  window_ms=300)
    m = [np.full((16, 16, 3), k / 4, np.float32) for k in range(3)]
    reqs = [(("a", "", 4, 7.5, 0.0, 0), {}),
            (("b", "", 4, 5.0, 0.0, 1), {"control": m[0], "control_scale": 0.6}),
            (("c", "", 4, 7.5, 0.0, 2), {}),
            (("d", "", 4, 5.0, 0.0, 3), {"control": m[1], "control_scale": 0.9}),
            (("e", "", 4, 5.0, 0.0, 4), {"control": m[2], "control_scale": 0.9})]
    _, errs = _submit_many(eng, reqs)
    assert errs == [None] * 5
    calls = sorted(pipe.calls, key=lambda c: "control_image" in c)
    assert [c["n"] for c in calls] == [2, 4]
    assert set(calls[0]) == {"n", "g"}  # the plain call's operands as before
    assert np.asarray(calls[0]["g"]).ndim == 0
    control = calls[1]["control_image"]
    assert control.shape == (4, 16, 16, 3)
    by_scale = {round(float(s), 3) for s in calls[1]["controlnet_conditioning_scale"]}
    assert by_scale == {0.6, 0.9}
    row0 = {0.6: 0, 0.9: 1}[round(float(calls[1]["controlnet_conditioning_scale"][0]), 3)]
    # the pad row repeats row 0's map and scale
    assert np.array_equal(control[3], control[0]) and np.array_equal(control[0], m[row0])
    assert calls[1]["controlnet_conditioning_scale"][3] == \
        calls[1]["controlnet_conditioning_scale"][0]
    assert eng.stats["controlnet_calls"] == 1 and eng.stats["controlnet_rows"] == 3
    assert eng.stats["device_calls"] == 2
    # a uniform scale stays a number
    _submit_many(eng, [(("f", "", 4, 5.0, 0.0, 5), {"control": m[0], "control_scale": 0.7}),
                       (("g", "", 4, 5.0, 0.0, 6), {"control": m[1], "control_scale": 0.7})])
    assert np.asarray(pipe.calls[-1]["controlnet_conditioning_scale"]).ndim == 0


class PlainPipe(FakePipe):
    controlnet = None


def test_maps_are_refused_without_a_controlnet_or_at_another_size(engines):
    tok = lambda t: np.zeros((len(t), 4), np.int64)  # noqa: E731
    eng = engines(PlainPipe(), tok, size=16)
    with pytest.raises(ValueError, match="no ControlNet"):
        eng.submit("a", "", 4, 7.5, 0.0, 0, control=np.zeros((16, 16, 3), np.float32))
    eng = engines(FakePipe(), tok, size=16)
    with pytest.raises(ValueError, match="shape"):
        eng.submit("a", "", 4, 7.5, 0.0, 0, control=np.zeros((8, 8, 3), np.float32))


def _http(port, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("POST", "/generate", json.dumps(body))
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def _serving(engine):
    srv = make_server(engine, 0, STEPS, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, thread


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(TIMEOUT)
    assert not thread.is_alive()


def test_http_round_trip_with_a_control_map(stack, engines):
    cfg, models, cn, tokenize = stack
    eng = engines(StableDiffusionXLControlNetPEAPipeline(models, cn, "dpm++"), tokenize, SIZE,
                  max_batch=1, window_ms=10)
    srv, thread = _serving(eng)
    port = srv.server_address[1]
    try:
        req = {"prompt": "一只猫", "guidance": 6.0, "seed": 5,
               "control_image": png_b64(MAPS[1][..., 0], "L"),
               "controlnet_conditioning_scale": 0.8}
        status, ctype, data = _http(port, req)
        assert (status, ctype) == (200, "image/png")
        want = eng.submit("一只猫", "", STEPS, 6.0, 0.0, 5, control=MAPS[1] / np.float32(255),
                          control_scale=0.8)
        assert np.array_equal(_pixels(Image.open(io.BytesIO(data))), _pixels(want))
        # an RGB map at another size is resized to the served one
        big = np.asarray(Image.fromarray(MAPS[1]).resize((2 * SIZE, 2 * SIZE)))
        assert _http(port, dict(req, control_image=png_b64(big)))[0] == 200
        for bad, says in ((dict(req, control_image="not base64!"), "not a base64 PNG"),
                          (dict(req, control_image=base64.b64encode(b"GIF89a").decode()),
                           "not a base64 PNG"),
                          (dict(req, control_image=png_b64(
                              np.zeros((SIZE, SIZE, 4), np.uint8), "RGBA")), "RGB or L"),
                          (dict(req, control_image=7), "base64 string"),
                          (dict(req, controlnet_conditioning_scale="nan"), "finite")):
            status, ctype, data = _http(port, bad)
            assert (status, ctype) == (400, "application/json")
            assert says in json.loads(data)["error"]
        assert eng.stats["controlnet_calls"] == 3 and eng.stats["device_calls"] == 3
    finally:
        _stop(srv, thread)

    srv, thread = _serving(engines(PlainPipe(), tokenize, SIZE))
    try:
        status, _, data = _http(srv.server_address[1], req)
        assert status == 400 and "no ControlNet" in json.loads(data)["error"]
    finally:
        _stop(srv, thread)


def test_a_step_opens_one_controlnet_and_one_unet_span(stack):
    from torch.profiler import ProfilerActivity, profile

    cfg, models, cn, tokenize = stack
    ids, uncond = tokenize(["一只猫", "雪山"]), tokenize(["", ""])
    control = torch.as_tensor(np.stack(MAPS[:2]) / np.float32(255))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        generate_sdxl_controlnet(models, cn, ids, uncond, control, sampler_name="dpm++",
                                 height=SIZE, width=SIZE, num_steps=3,
                                 controlnet_conditioning_scale=np.float32([0.5, 1.0]))
    spans = [e for e in prof.events() if e.name.startswith("pea/")]
    count = {n: sum(1 for e in spans if e.name == "pea/" + n)
             for n in ("pipe.sampler_step", "pipe.controlnet", "pipe.unet",
                       "controlnet.cond_embed")}
    assert count == {"pipe.sampler_step": 3, "pipe.controlnet": 3, "pipe.unet": 3,
                     "controlnet.cond_embed": 3}

    def inside(name, outer):
        outers = [e.time_range for e in spans if e.name == "pea/" + outer]
        return all(any(o.start <= e.time_range.start and e.time_range.end <= o.end
                       for o in outers) for e in spans if e.name == "pea/" + name)

    assert inside("pipe.controlnet", "pipe.sampler_step")
    assert inside("pipe.unet", "pipe.sampler_step")
    assert inside("controlnet.cond_embed", "pipe.controlnet")


def test_cli_serves_a_demo_controlnet_and_checks_its_flags(monkeypatch, capsys):
    served = {}

    class Server:
        def __init__(self, engine, port, default_steps):
            served.update(engine=engine)

        def serve_forever(self):
            pass

        def shutdown(self):
            pass

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "make_server", Server)
    serve.main(["--demo", "--demo-controlnet", "--device", "cpu", "--port", "0"])
    engine = served["engine"]
    assert engine.serves_control and isinstance(engine.pipe.controlnet, ControlNet)
    assert "controlnet=True" in capsys.readouterr().out
    for argv, says in ((["--demo", "--controlnet", "cn"], "--controlnet DIR is real mode"),
                       (["--model-dir", "m", "--text-encoder-dir", "t", "--adapter", "a",
                         "--demo-controlnet"], "--demo-controlnet goes with"),):
        with pytest.raises(SystemExit):
            serve.main(argv + ["--device", "cpu"])
        assert says in capsys.readouterr().err
