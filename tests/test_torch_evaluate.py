"""The port's evaluation (pea_diffusion_tpu_torch/utils/fid.py and
cli/evaluate.py) against the JAX package's: the Fréchet distance and its
Gaussian statistics in fp64 within 1e-10 (the same numpy operations), their
ValueErrors, clip_score with its clamp at 0 (1e-6, fp32), the demo CLI on
PNGs the test writes, and the real-mode CLI on a tiny Chinese-CLIP
directory the test writes (BERT text tower + projection, ViT + projection,
a BertTokenizer vocabulary): per-image CLIP-scores, their mean and the
CLIP-FID equal to the JAX CLI's within 1e-4 (the CLIs print scores and FID
rounded to 4 decimals)."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from _torch_dirs import BERT_JSON, write_text_dir
from _torch_parity import host_params, one_torch_thread  # noqa: F401
from pea_diffusion_tpu.checkpoints.safetensors_io import save_safetensors
from pea_diffusion_tpu.cli import evaluate as jax_evaluate
from pea_diffusion_tpu.configs.text_encoder import BERT_TINY as JAX_BERT_TINY
from pea_diffusion_tpu.models.bert_text import BertTextEncoder as JaxBertTextEncoder
from pea_diffusion_tpu.utils import fid as jax_fid
from pea_diffusion_tpu_torch.checkpoints.from_jax import bert_text_state_dict
from pea_diffusion_tpu_torch.cli import evaluate
from pea_diffusion_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionEncoder
from pea_diffusion_tpu_torch.utils import fid

FEATURE_SETS = {  # (Na, Nb, D): full rank, N < D (rank-deficient), one wide
    "full rank": (64, 48, 8),
    "rank deficient": (6, 9, 16),
    "same size": (32, 32, 32),
}


def _feats(n, d, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((d, d)) * 0.5
    return (rng.standard_normal((n, d)) @ mix + shift).astype(np.float32)


@pytest.mark.parametrize("name", list(FEATURE_SETS))
def test_fid_matches_jax(name):
    na, nb, d = FEATURE_SETS[name]
    a, b = _feats(na, d, 0), _feats(nb, d, 1, shift=0.3)
    for got, want in zip(fid.gaussian_stats(a), jax_fid.gaussian_stats(a)):
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    got = fid.fid_from_features(a, b)
    want = jax_fid.fid_from_features(a, b)
    assert got > 0 and abs(got - want) <= 1e-10
    mu1, c1 = fid.gaussian_stats(a)
    mu2, c2 = fid.gaussian_stats(b)
    for eps in (0.0, 1e-6, 1e-3):
        assert abs(fid.frechet_distance(mu1, c1, mu2, c2, eps)
                   - jax_fid.frechet_distance(mu1, c1, mu2, c2, eps)) <= 1e-10
    assert 0.0 <= fid.fid_from_features(a, a) < 1e-8


def test_frechet_distance_clamps_at_zero():
    mu, cov = np.zeros(3), np.eye(3)
    assert fid.frechet_distance(mu, cov, mu, cov) == jax_fid.frechet_distance(
        mu, cov, mu, cov) == 0.0


@pytest.mark.parametrize("features,message", [
    (np.zeros((4, 2, 3)), r"must be \[N, D\]"),
    (np.zeros((1, 5)), ">= 2 samples"),
])
def test_gaussian_stats_raises_as_jax(features, message):
    for module in (fid, jax_fid):
        with pytest.raises(ValueError, match=message):
            module.gaussian_stats(features)


@pytest.mark.parametrize("t,v", [
    ([[1.0, 0.0], [0.0, 2.0], [1.0, 0.0]], [[2.0, 0.0], [0.0, 1.0], [-1.0, 0.0]]),
    (_feats(5, 7, 2).tolist(), _feats(5, 7, 3).tolist()),
])
def test_clip_score_matches_jax(t, v):
    got = evaluate.clip_score(torch.tensor(t), torch.tensor(v))
    want = np.asarray(jax_evaluate.clip_score(np.asarray(t, np.float32),
                                              np.asarray(v, np.float32)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    assert float(got.min()) >= 0.0


def _write_pngs(directory, n, seed, size=(40, 48)):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(directory, f"img_{seed}_{i}.png")
        Image.fromarray(rng.integers(0, 256, size + (3,), dtype=np.uint8)).save(path)
        paths.append(path)
    return paths


def _write_prompts(path, n):
    with open(path, "w") as f:  # characters inside the test vocabulary (CJK from U+4E00)
        f.write("\n".join("".join(chr(0x4E00 + (7 * i + j) % 900) for j in range(3 + i))
                          for i in range(n)) + "\n")
    return str(path)


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_demo_cli_prints_both_metrics(tmp_path, capsys):
    images, ref = _write_pngs(tmp_path, 3, 0), _write_pngs(tmp_path, 2, 1)
    evaluate.main(["--demo", "--device", "cpu", "--images", *images,
                   "--prompts", _write_prompts(tmp_path / "p.txt", 3), "--fid-ref", *ref])
    score, fid_line = _json_lines(capsys.readouterr().out)
    assert score["metric"] == "CLIP-score" and score["n"] == 3 and "demo" in score
    assert 0.0 <= score["value"] <= 1.0
    assert fid_line["metric"] == "CLIP-FID" and fid_line["value"] >= 0.0
    assert (fid_line["n"], fid_line["n_ref"]) == (3, 2) and "demo" in fid_line


VISION = dict(image_size=32, patch_size=8, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128)


def _write_chinese_clip(directory):
    """A tiny ChineseCLIPModel directory: BERT_TINY's tower under
    `text_model.` with `text_projection`, a two-layer ViT under
    `vision_model.` with `visual_projection`, projection_dim 16."""
    text = host_params(JaxBertTextEncoder(JAX_BERT_TINY), np.zeros((1, 8), np.int32), seed=4)
    write_text_dir(directory, bert_text_state_dict(text))  # the vocabulary
    vcfg = CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                            num_heads=4, intermediate_size=128, projection_dim=16)
    vision = CLIPVisionEncoder(vcfg)
    g = torch.Generator().manual_seed(5)
    sd = {f"text_model.{k}": v.numpy() for k, v in bert_text_state_dict(text).items()}
    for k, v in vision.state_dict().items():
        w = (0.1 * torch.randn(v.shape, generator=g) + (1.0 if "norm" in k and
                                                       k.endswith("weight") else 0.0))
        sd[k if k.startswith("visual_projection") else f"vision_model.{k}"] = w.numpy()
    sd["text_projection.weight"] = (0.2 * torch.randn((16, 64), generator=g)).numpy()
    save_safetensors(os.path.join(directory, "model.safetensors"), sd)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"model_type": "chinese_clip", "projection_dim": 16,
                   "text_config": BERT_JSON, "vision_config": VISION}, f)
    return str(directory)


def _scores(out):
    return [float(ln.split()[0]) for ln in out.splitlines() if ln.endswith(".png")]


def test_real_mode_matches_the_jax_cli(tmp_path, capsys):
    clip_dir = _write_chinese_clip(tmp_path / "cn-clip")
    images, ref = _write_pngs(tmp_path, 4, 2), _write_pngs(tmp_path, 3, 3)
    argv = ["--clip-dir", clip_dir, "--images", *images,
            "--prompts", _write_prompts(tmp_path / "p.txt", 4), "--fid-ref", *ref,
            "--max-length", "12"]
    jax_evaluate.main(argv)
    want = capsys.readouterr().out
    evaluate.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    got_scores, want_scores = _scores(got), _scores(want)
    assert len(got_scores) == len(want_scores) == 4
    assert len(set(got_scores)) > 1
    np.testing.assert_allclose(got_scores, want_scores, atol=1e-4 + 1e-9, rtol=0)
    (gs, gf), (ws, wf) = _json_lines(got), _json_lines(want)
    assert gs["metric"] == ws["metric"] == "CLIP-score" and gs["n"] == ws["n"] == 4
    assert abs(gs["value"] - ws["value"]) <= 1e-4
    assert gf["metric"] == wf["metric"] == "CLIP-FID" and gf["value"] > 0
    assert abs(gf["value"] - wf["value"]) <= 1e-4 + 1e-9
    assert {k: v for k, v in gf.items() if k != "value"} == {
        k: v for k, v in wf.items() if k != "value"}


def test_image_features_do_not_depend_on_the_chunk(tmp_path):
    """Each call takes `chunk` rows with a zero-padded tail: the features of
    an image are the same whatever set or chunk size it comes in."""
    towers = evaluate.load_dual_tower(_write_chinese_clip(tmp_path / "cn-clip"), "cpu")
    images = _write_pngs(tmp_path, 5, 6)
    whole = towers.image_features(images, chunk=4)
    assert whole.shape == (5, 16)
    np.testing.assert_allclose(towers.image_features(images[3:], chunk=4).numpy(),
                               whole[3:].numpy(), atol=1e-6)
    np.testing.assert_allclose(towers.image_features(images, chunk=32).numpy(),
                               whole.numpy(), atol=1e-6)
