"""The port's CLIP vision tower (pea_diffusion_tpu_torch/models/clip_vision.py)
against the JAX package's CLIPVisionEncoder and transformers'
CLIPVisionModelWithProjection, in fp32 on the CPU: last_hidden_state, pooled
and projected within 2e-5 (fp32 sums in another order over two layers),
with the weights carried both ways (from_jax.clip_vision_state_dict, and the
JAX package's convert_clip_vision of the port's state dict), at quick_gelu
and exact GELU, with and without a projection; preprocess_clip_image equal
to the JAX package's; load_clip_vision on directories the test writes."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from _torch_parity import host_params, one_torch_thread  # noqa: F401
from pea_diffusion_tpu.checkpoints.safetensors_io import save_safetensors
from pea_diffusion_tpu.checkpoints.torch_convert import convert_clip_vision, to_numpy_state_dict
from pea_diffusion_tpu.models import clip_vision as jax_cv
from pea_diffusion_tpu_torch.checkpoints.from_jax import clip_vision_state_dict
from pea_diffusion_tpu_torch.checkpoints.load_pretrained import load_clip_vision
from pea_diffusion_tpu_torch.models import clip_vision as cv

ATOL = 2e-5
CONFIGS = {
    "tiny": dict(),
    "gelu": dict(hidden_act="gelu"),
    "no projection": dict(projection_dim=None),
}


def _configs(name):
    fields = {f: getattr(cv.CLIP_VISION_TINY, f) for f in cv.CLIPVisionConfig.__dataclass_fields__}
    fields.update(CONFIGS[name])
    return jax_cv.CLIPVisionConfig(**fields), cv.CLIPVisionConfig(**fields)


def _pixels(n=2, size=32, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _random_port(cfg, seed=0):
    """A port tower with every tensor drawn from a seed (norm weights near
    1), so that each affine is exercised."""
    m = cv.CLIPVisionEncoder(cfg).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            noise = 0.1 * torch.randn(p.shape, generator=g)
            p.copy_(noise + 1.0 if "norm" in name and name.endswith("weight") else noise)
    return m


def _assert_close(out, ref):
    for got, want in zip(out, ref):
        if want is None:
            assert got is None
            continue
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_encoder_matches_jax(name, direction):
    jcfg, pcfg = _configs(name)
    jm = jax_cv.CLIPVisionEncoder(jcfg)
    pix = _pixels()
    if direction == "from_jax":
        params = host_params(jm, pix, seed=1)
        port = cv.CLIPVisionEncoder(pcfg).eval()
        port.load_state_dict(clip_vision_state_dict(params), strict=True)
    else:
        port = _random_port(pcfg, seed=1)
        params = convert_clip_vision(to_numpy_state_dict(port), pcfg.num_layers)
    want = jm.apply(params, jnp.asarray(pix))
    with torch.no_grad():
        got = port(torch.from_numpy(pix))
    assert (got.projected is None) == (pcfg.projection_dim is None)
    assert float(np.abs(np.asarray(want.last_hidden_state)).max()) > 0
    _assert_close(got, want)


def test_state_dict_names_round_trip():
    """from_jax and convert_clip_vision invert each other: the same keys,
    shapes and values both ways."""
    jcfg, pcfg = _configs("tiny")
    params = host_params(jax_cv.CLIPVisionEncoder(jcfg), _pixels(), seed=2)
    sd = clip_vision_state_dict(params)
    assert sorted(sd) == sorted(cv.CLIPVisionEncoder(pcfg).state_dict())
    back = convert_clip_vision({k: v.numpy() for k, v in sd.items()}, pcfg.num_layers)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)  # noqa: E731
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(params), flat(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _transformers_tower(act="quick_gelu", seed=0):
    torch.manual_seed(seed)
    tcfg = transformers.CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128, projection_dim=48, hidden_act=act)
    return transformers.CLIPVisionModelWithProjection(tcfg).eval()


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_encoder_matches_transformers(act):
    tm = _transformers_tower(act)
    sd = {k[len("vision_model."):] if k.startswith("vision_model.") else k: v
          for k, v in tm.state_dict().items()}
    _, pcfg = _configs("gelu" if act == "gelu" else "tiny")
    port = cv.CLIPVisionEncoder(pcfg).eval()
    port.load_state_dict({k: v for k, v in sd.items() if "position_ids" not in k}, strict=True)
    pix = _pixels(seed=3)
    with torch.no_grad():
        got = port(torch.from_numpy(pix))
        ref = tm(torch.from_numpy(pix.transpose(0, 3, 1, 2)), output_hidden_states=True)
    np.testing.assert_allclose(got.projected.numpy(), ref.image_embeds.numpy(), atol=ATOL)
    np.testing.assert_allclose(got.last_hidden_state.numpy(), ref.last_hidden_state.numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_preprocess_equals_the_jax_packages(kind):
    rng = np.random.default_rng(4)
    if kind == "uint8":
        imgs = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    else:
        imgs = rng.uniform(-0.2, 1.2, (2, 40, 56, 3)).astype(np.float32)
    got = cv.preprocess_clip_image(imgs, 32)
    want = jax_cv.preprocess_clip_image(imgs, 32)
    assert got.shape == (2, 32, 32, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pre", ["pre_layrnorm", "pre_layernorm"])
def test_load_clip_vision_from_a_chinese_clip_directory(tmp_path, pre):
    """A Chinese-CLIP layout: the vision tower under `vision_model.` (with
    either spelling of the first LayerNorm), `visual_projection.weight` at
    the top level, a text weight the loader ignores; the config's keys as
    the JAX evaluate CLI reads them."""
    _, pcfg = _configs("tiny")
    src = _random_port(pcfg, seed=5)
    sd = {}
    for k, v in src.state_dict().items():
        if k.startswith("visual_projection."):
            sd[k] = v.numpy()
        else:
            k = pre + k[len("pre_layrnorm"):] if k.startswith("pre_layrnorm.") else k
            sd[f"vision_model.{k}"] = v.numpy()
    sd["text_projection.weight"] = np.zeros((48, 64), np.float32)
    save_safetensors(os.path.join(tmp_path, "model.safetensors"), sd)
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump({"model_type": "chinese_clip", "projection_dim": 48,
                   "text_config": {"hidden_size": 64},
                   "vision_config": {"image_size": 32, "patch_size": 8, "hidden_size": 64,
                                     "num_hidden_layers": 2, "num_attention_heads": 4,
                                     "intermediate_size": 128}}, f)
    cfg, loaded = load_clip_vision(str(tmp_path), device="cpu")
    assert cfg == pcfg
    pix = torch.from_numpy(_pixels(seed=6))
    with torch.no_grad():
        for got, want in zip(loaded(pix), src(pix)):
            assert torch.equal(got, want)
