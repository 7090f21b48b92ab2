"""The port's serving daemon (pea_diffusion_tpu_torch/cli/serve.py) against
the JAX package's: the BatchingEngine's co-batching, power-of-two padding,
per-request noise, grouping by steps, vector CFG, counters and error
propagation on a fake pipeline (the cases of tests/test_serve_batching.py);
the noise draws bit-equal to the JAX engine's; the tiny SDXL stack served
co-batched by both engines at the same weights (within 1 uint8 level: both
decode fp32 images that differ by ~1e-6 and round them the same way); solo
against co-batched on the port with the GroupNorm form pinned (within 1
level); an HTTP round trip on 127.0.0.1; the CLI's real mode on a model
directory the test writes, and its argparse errors."""
import http.client
import io
import json
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import one_torch_thread, perturb  # noqa: F401
from pea_diffusion_tpu.cli.serve import BatchingEngine as JaxBatchingEngine
from pea_diffusion_tpu.configs.adapter import AdapterConfig as JaxAdapterConfig
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.configs.unet import SDXL_UNET_TINY as JAX_UNET_TINY
from pea_diffusion_tpu.configs.unet import VAE_TINY as JAX_VAE_TINY
from pea_diffusion_tpu.pipelines import factory as jax_factory
from pea_diffusion_tpu.pipelines.text2image import (
    StableDiffusionXLPEAPipeline as JaxSDXLPipeline)
from pea_diffusion_tpu_torch.checkpoints import from_jax
from pea_diffusion_tpu_torch.cli import serve
from pea_diffusion_tpu_torch.cli.generate import build_demo
from pea_diffusion_tpu_torch.cli.serve import BatchingEngine, make_server
from pea_diffusion_tpu_torch.pipelines import StableDiffusionXLPEAPipeline

TIMEOUT = 120  # seconds a test waits on a request or a thread


class FakePipe:
    """Records each call; its images carry a function of each row's noise,
    so that two rows with the same noise give the same pixels."""

    def __init__(self):
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, ids, uncond_ids, *, height, width, num_steps,
                 guidance_scale, guidance_rescale, init_noise):
        with self.lock:
            self.calls.append({"n": len(ids), "steps": num_steps, "g": guidance_scale,
                               "r": guidance_rescale, "noise": np.asarray(init_noise).copy()})
        rows = torch.as_tensor(np.asarray(init_noise)).reshape(len(ids), -1)[:, :12]
        return torch.sigmoid(rows).reshape(len(ids), 2, 2, 3)


def _tok(texts):
    return np.zeros((len(texts), 4), np.int32)


def _submit_many(engine, reqs, timeout=TIMEOUT):
    out, errs = [None] * len(reqs), [None] * len(reqs)

    def call(i, r):
        try:
            out[i] = engine.submit(*r)
        except Exception as e:
            errs[i] = e

    ts = [threading.Thread(target=call, args=(i, r)) for i, r in enumerate(reqs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
        assert not t.is_alive(), "a request did not finish"
    return out, errs


@pytest.fixture
def engines():
    """Engines made by a test, closed after it."""
    made = []

    def make(*args, **kwargs):
        made.append(BatchingEngine(*args, **kwargs))
        return made[-1]

    yield make
    for e in made:
        e.close(TIMEOUT)
        assert not e._thread.is_alive()


def _pixels(img):
    return np.asarray(img, np.int16)


def test_cobatches_and_pads_to_pow2(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=8, window_ms=300)
    out, errs = _submit_many(eng, [("p%d" % i, "", 4, 7.5, 0.0, i) for i in range(3)])
    assert errs == [None] * 3 and all(o is not None for o in out)
    assert len(pipe.calls) == 1
    assert pipe.calls[0]["n"] == 4  # 3 requests pad to 4 rows
    assert pipe.calls[0]["noise"].shape == (4, 8, 8, 4)


def test_noise_is_per_request_seed_deterministic(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=8, window_ms=300)
    out1, _ = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 42)])
    out2, _ = _submit_many(eng, [("b", "", 4, 7.5, 0.0, 42), ("c", "", 4, 7.5, 0.0, 7)])
    assert np.array_equal(_pixels(out1[0]), _pixels(out2[0]))  # unchanged by co-batching
    assert not np.array_equal(_pixels(out2[0]), _pixels(out2[1]))  # other seeds differ


def test_mismatched_steps_split_into_calls(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=8, window_ms=300)
    out, errs = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0), ("b", "", 8, 7.5, 0.0, 1),
                                   ("c", "", 4, 7.5, 0.0, 2)])
    assert errs == [None] * 3
    assert len(pipe.calls) == 2  # the steps=4 pair co-batched, steps=8 alone
    assert sorted(c["n"] for c in pipe.calls) == [1, 2]


def test_mixed_guidance_cobatches_as_vector(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=8, window_ms=300)
    out, errs = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0), ("b", "", 4, 5.0, 0.7, 1),
                                   ("c", "", 4, 9.0, 0.0, 2)])
    assert errs == [None] * 3 and all(o is not None for o in out)
    assert len(pipe.calls) == 1
    call = pipe.calls[0]
    assert call["n"] == 4
    g = np.asarray(call["g"])
    assert g.shape == (4,)
    np.testing.assert_allclose(g, [7.5, 5.0, 9.0, 7.5], rtol=1e-6)  # pad row = row 0's
    np.testing.assert_allclose(np.asarray(call["r"]), [0.0, 0.7, 0.0, 0.0], rtol=1e-6)


def test_uniform_guidance_stays_scalar(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=8, window_ms=300)
    out, errs = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0), ("b", "", 4, 7.5, 0.0, 1)])
    assert errs == [None, None]
    assert len(pipe.calls) == 1
    assert np.asarray(pipe.calls[0]["g"]).ndim == 0
    assert np.asarray(pipe.calls[0]["r"]).ndim == 0


def test_error_propagates_to_all_cobatched(engines):
    class BoomPipe(FakePipe):
        def __call__(self, *a, **k):
            raise ValueError("boom")

    eng = engines(BoomPipe(), _tok, size=64, max_batch=4, window_ms=200)
    out, errs = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0), ("b", "", 4, 7.5, 0.0, 1)])
    assert out == [None, None]
    assert all(isinstance(e, RuntimeError) and "boom" in str(e) for e in errs)
    out, errs = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0)])  # the worker survives
    assert isinstance(errs[0], RuntimeError)


def test_engine_stats_counters(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=8, window_ms=300)
    _submit_many(eng, [("a", "", 4, 7.5, 0.0, i) for i in range(3)])
    _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0), ("b", "", 4, 5.0, 0.0, 1)])
    assert eng.stats["device_calls"] == 2
    assert eng.stats["requests_batched"] == 5  # real rows, not pad rows
    assert eng.stats["vector_cfg_calls"] == 1
    assert eng.stats["batch_hist"] == {"3": 1, "2": 1}
    assert eng.stats_snapshot() == eng.stats


def test_max_batch_one_disables_cobatching(engines):
    pipe = FakePipe()
    eng = engines(pipe, _tok, size=64, max_batch=1, window_ms=50)
    out, errs = _submit_many(eng, [("a", "", 4, 7.5, 0.0, 0), ("b", "", 4, 7.5, 0.0, 1)])
    assert errs == [None, None]
    assert len(pipe.calls) == 2
    assert all(c["n"] == 1 for c in pipe.calls)


@pytest.mark.parametrize("seed,n", [(0, 1), (42, 3), (2**31 + 5, 2), (-7, 1)])
def test_noise_equals_the_jax_engines_bit_for_bit(engines, seed, n):
    port = engines(FakePipe(), _tok, size=64)
    ref = JaxBatchingEngine(FakePipe(), _tok, size=64)
    got, want = port._noise(seed, n), ref._noise(seed, n)
    assert got.dtype == want.dtype == np.float32 and got.shape == (n, 8, 8, 4)
    assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def stacks():
    """The tiny SDXL stack in both frameworks at the same weights, and a
    tokenizer for each (the port's ids, int32 for JAX)."""
    ucfg = JAX_UNET_TINY
    pooled = ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim
    jmodels = jax_factory.build_models(
        family="chinese_clip", text_cfg=JAX_BERT_TINY,
        adapter_cfg=JaxAdapterConfig(JAX_BERT_TINY.hidden_size, (96, pooled),
                                     head_dim=ucfg.cross_attention_dim),
        unet_cfg=ucfg, vae_cfg=JAX_VAE_TINY, dtype=jnp.float32)
    params = perturb(jax_factory.init_params_host(jmodels, "chinese_clip", JAX_BERT_TINY),
                     seed=3)
    pmodels, tokenize, _ = build_demo(device="cpu")
    pmodels.text_encoder.load_state_dict(from_jax.bert_text_state_dict(params["text"]))
    pmodels.adapter.load_state_dict(from_jax.adapter_state_dict(params["adapter"]))
    pmodels.unet.load_state_dict(from_jax.unet_state_dict(params["unet"], pmodels.unet.config))
    pmodels.vae.load_state_dict(from_jax.vae_state_dict(params["vae"], pmodels.vae.config))
    return jmodels, params, pmodels, tokenize


SIZE, STEPS = 64, 2
# mixed guidance (a [B] vector), one rescale: padded to 4 rows
REQUESTS = [("一只戴着帽子的可爱猫咪", "", STEPS, 7.5, 0.0, 3),
            ("雪山下的湖泊", "模糊", STEPS, 5.0, 0.5, 11),
            ("一只猫", "", STEPS, 9.0, 0.0, 2**31 + 4)]


def test_cobatched_images_match_the_jax_engine(stacks, engines):
    jmodels, params, pmodels, tokenize = stacks
    jax_engine = JaxBatchingEngine(JaxSDXLPipeline(jmodels, params, "ddim"),
                                   lambda t: tokenize(t).astype(np.int32), SIZE,
                                   max_batch=3, window_ms=60_000)
    port_engine = engines(StableDiffusionXLPEAPipeline(pmodels, "ddim"), tokenize, SIZE,
                          max_batch=3, window_ms=60_000)
    want, errs = _submit_many(jax_engine, REQUESTS, timeout=600)
    assert errs == [None] * 3
    got, errs = _submit_many(port_engine, REQUESTS)
    assert errs == [None] * 3
    assert port_engine.stats == {"device_calls": 1, "requests_batched": 3,
                                 "vector_cfg_calls": 1, "batch_hist": {"3": 1},
                                 "controlnet_calls": 0, "controlnet_rows": 0}
    for g, w in zip(got, want):
        assert g.size == w.size == (16, 16) and g.mode == w.mode == "RGB"
        assert np.abs(_pixels(g) - _pixels(w)).max() <= 1
    assert len({_pixels(g).tobytes() for g in got}) == 3


def test_solo_matches_cobatched_with_the_groupnorm_form_pinned(stacks, engines, monkeypatch):
    monkeypatch.setenv("PEA_GN_GROUPED", "1")
    _, _, pmodels, tokenize = stacks
    pipe = StableDiffusionXLPEAPipeline(pmodels, "ddim")
    solo = engines(pipe, tokenize, SIZE, max_batch=1, window_ms=10)
    cob = engines(pipe, tokenize, SIZE, max_batch=3, window_ms=60_000)
    co, errs = _submit_many(cob, REQUESTS)
    assert errs == [None] * 3
    for req, img in zip(REQUESTS, co):
        alone, errs = _submit_many(solo, [req])
        assert errs == [None]
        assert np.abs(_pixels(alone[0]) - _pixels(img)).max() <= 1
    assert solo.stats["batch_hist"] == {"1": 3} and cob.stats["batch_hist"] == {"3": 1}


def _http(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request(method, path, body)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def test_http_round_trip(stacks, engines):
    _, _, pmodels, tokenize = stacks
    eng = engines(StableDiffusionXLPEAPipeline(pmodels, "ddim"), tokenize, SIZE,
                  max_batch=1, window_ms=10)
    srv = make_server(eng, 0, STEPS, host="127.0.0.1")
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = {"prompt": "一只猫", "negative_prompt": "模糊", "guidance": 6.0, "seed": 5}
        status, ctype, data = _http(port, "POST", "/generate", json.dumps(req))
        assert (status, ctype) == (200, "image/png")
        png = Image.open(io.BytesIO(data))
        want = eng.submit("一只猫", "模糊", STEPS, 6.0, 0.0, 5)
        assert png.mode == "RGB" and np.array_equal(_pixels(png), _pixels(want))

        status, ctype, data = _http(port, "GET", "/healthz")
        health = json.loads(data)
        assert (status, ctype, health["status"], health["requests"]) == (
            200, "application/json", "ok", 1)
        assert health["engine"]["device_calls"] == 2
        assert health["engine"]["batch_hist"] == {"1": 2}

        status, ctype, data = _http(port, "POST", "/generate", json.dumps({"seed": 1}))
        assert (status, ctype) == (400, "application/json")
        assert json.loads(data) == {"error": "missing 'prompt'"}
        assert _http(port, "GET", "/generate")[0] == 404
        assert _http(port, "POST", "/nowhere", "{}")[0] == 404
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(TIMEOUT)
    assert not thread.is_alive()


def test_cli_real_mode_serves_a_model_directory(stacks, tmp_path, monkeypatch):
    """Real mode end to end up to the server: --model-dir (the tiny SDXL
    stack as a diffusers directory), --text-encoder-dir (a Chinese-CLIP
    directory with its vocabulary: the tokenizer through transformers),
    --adapter; build_real gets every attribute it reads, and the engine
    the server is given answers a request with the stack's image."""
    import dataclasses
    import os

    import _torch_dirs as dirs
    from pea_diffusion_tpu_torch.checkpoints.orbax_io import export_adapter
    from pea_diffusion_tpu_torch.configs.adapter import ADAPTER_PRESETS

    _, _, pmodels, _ = stacks
    model_dir = dirs.write_model_dir(tmp_path / "sdxl", dirs.SDXL_UNET_JSON,
                                     pmodels.unet.state_dict(), pmodels.vae.state_dict())
    text_dir = dirs.write_text_dir(str(tmp_path / "text"), pmodels.text_encoder.state_dict())
    monkeypatch.setitem(ADAPTER_PRESETS, "tiny", dataclasses.replace(
        ADAPTER_PRESETS["sdxl_small"], in_dim=64, projector_dims=(96, 64),
        projector_bias=False, head_dim=64))
    adapter = os.path.join(export_adapter(pmodels.adapter, str(tmp_path), 1),
                           "pytorch_model.bin")
    served = {}

    class Server:
        def __init__(self, engine, port, default_steps):
            served.update(engine=engine, default_steps=default_steps)

        def serve_forever(self):
            served["img"] = served["engine"].submit("一丁", "", 2, 7.5, 0.0, 3)

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "make_server", Server)
    serve.main(["--model-dir", model_dir, "--text-encoder-dir", text_dir, "--adapter", adapter,
                "--adapter-preset", "tiny", "--sampler", "ddim", "--size", "64",
                "--max-length", "8", "--device", "cpu", "--port", "0"])
    assert served["default_steps"] == 30
    assert served["img"].size == (16, 16) and served["img"].mode == "RGB"
    assert not served["engine"]._thread.is_alive()  # main closed it


@pytest.mark.parametrize("argv,message", [
    (["--demo", "--tp", "2"], "launch it with torchrun --nproc-per-node 2 -m "
                              "pea_diffusion_tpu_torch.cli.serve"),
    (["--demo", "--quant", "int8:bogus"], "unknown int8 scopes ['bogus']"),
    (["--demo", "--aot-cache", "cache", "--no-compile-cache"], "give one"),
    (["--text-encoder-dir", "te", "--adapter", "proj.bin"], "--model-dir required"),
])
def test_cli_refuses_what_is_not_ported_and_real_mode_without_a_model(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("case", ["aot-cache", "quant", "calib-prompt", "calib-ranges"])
def test_cli_serves_int8_and_from_an_aot_cache(case, tmp_path, monkeypatch):
    """The demo server starts with each start-up and int8 flag and answers
    a request: --aot-cache points the kernel library's build under the
    directory, --quant int8 quantizes the UNet's resnet convs, calibrated
    on --calib-prompt (default: the JAX CLI's prompt), and --calib-ranges
    writes the ranges file (with the VAE decoder's under the vae scope)."""
    from pea_diffusion_tpu_torch.data import native_reader
    from pea_diffusion_tpu_torch.ops import kernel_build
    from pea_diffusion_tpu_torch import quant
    from pea_diffusion_tpu_torch.quant import int8

    monkeypatch.setattr(kernel_build, "BUILD_DIR", kernel_build.BUILD_DIR)
    monkeypatch.setattr(native_reader, "BUILD_DIR", native_reader.BUILD_DIR)
    argv = {"aot-cache": ["--aot-cache", str(tmp_path / "aot")],
            "quant": ["--quant", "int8"],
            "calib-prompt": ["--quant", "int8", "--calib-prompt", "雪山"],
            "calib-ranges": ["--quant", "int8:resnet,vae", "--calib-ranges",
                             str(tmp_path / "ranges.json")]}[case]
    calibrated, served = [], {}
    quantize = quant.quantize_for_serving
    monkeypatch.setattr(quant, "quantize_for_serving",
                        lambda models, ids, *a, **k: calibrated.append(ids) or quantize(
                            models, ids, *a, **k))

    class Server:
        def __init__(self, engine, port, default_steps):
            served.update(engine=engine)

        def serve_forever(self):
            served["img"] = served["engine"].submit("一丁", "", 2, 7.5, 0.0, 3)

        def server_close(self):
            pass

    monkeypatch.setattr(serve, "make_server", Server)
    serve.main(["--demo", "--device", "cpu", "--sampler", "ddim", "--port", "0"] + argv)
    assert served["img"].size == (64, 64) and served["img"].mode == "RGB"  # the demo's 256²
    unet = served["engine"].pipe.models.unet
    if case == "aot-cache":
        assert not calibrated and unet.conv_quant == "none"
        assert Path(kernel_build.BUILD_DIR).parent.parent == (tmp_path / "aot").resolve()
        return
    tokenize = served["engine"].tokenize
    prompt = "雪山" if case == "calib-prompt" else "一只戴着帽子的可爱猫咪"
    assert len(calibrated) == 1 and np.array_equal(calibrated[0], tokenize([prompt]))
    assert unet.conv_quant == "int8:resnet"
    if case == "calib-ranges":
        ranges = json.loads((tmp_path / "ranges.json").read_text())
        assert any(k.startswith("vae::") for k in ranges) and "down_0_resnet_0/conv1" in ranges
        assert served["engine"].pipe.models.vae.conv_quant == int8.VAE_DECODER_CONV_QUANT
