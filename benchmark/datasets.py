"""Training data written as webdataset shards from the run's seed, the way a
KD corpus reaches the trainer: each sample a JPEG and a JSON of captions and
quality scores, ``<key>.jpg`` and ``<key>.json`` next to each other in a tar.

What a shards mix sets (``traffic/<mix>.json``, key ``"shards"``):

- ``count`` shards of ``samples`` samples each;
- image sizes: the aspect (width / height) of one of the ``buckets``
  drawn with ``bucket_weights``, times a factor in ``aspect_jitter``, and
  an area in ``area`` (pixels); drawn once from ``sizes_seed``, so every
  run holds the same set of sizes, and its images differ with the seed;
- ``zh_share``: the share of Chinese-native samples (a ``caption_ori`` in
  Chinese, trained on the denoising loss), the others machine-translated
  parallel samples (``caption_zh``, trained on distillation); every sample
  carries its English ``caption_en`` for the teacher;
- ``caption_chars`` (least and most characters a caption), the
  characters of the Chinese ones (``zh_chars``: simplified characters,
  which the program's caption cleaning keeps as they are) and
  ``jpeg_quality``.

The token ids come from seeded stand-in tokenizers (no vocabulary is on
disk): the student's one id a character after [CLS], then [SEP] and
padding; the teachers' CLIP form, a start id, one id a character, the end
id, then the tower's padding.
"""
from __future__ import annotations

import io
import json
import math
import tarfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

STUDENT_CLS, STUDENT_SEP, STUDENT_PAD = 101, 102, 0


def student_tokenizer(vocab: int, length: int):
    """texts -> [B, length] int64: [CLS], a character's code point folded
    into the vocabulary past the first 106 ids, [SEP], then padding."""
    def tokenize(texts: List[str]) -> np.ndarray:
        out = np.full((len(texts), length), STUDENT_PAD, np.int64)
        for i, t in enumerate(texts):
            ids = [STUDENT_CLS] + [106 + ord(c) % (vocab - 106) for c in t][:length - 2] \
                + [STUDENT_SEP]
            out[i, :len(ids)] = ids
        return out
    return tokenize


def teacher_tokenizer(eos: int, length: int, pad: Optional[int]):
    """texts -> [B, length] int64 in CLIP's form: the start id (eos - 1),
    one id a character (from 256 up to the start id), the end id `eos`,
    then `pad` (None: the end id, as CLIP ViT-L's tokenizer pads)."""
    pad = eos if pad is None else pad

    def tokenize(texts: List[str]) -> np.ndarray:
        out = np.full((len(texts), length), pad, np.int64)
        for i, t in enumerate(texts):
            ids = [eos - 1] + [256 + ord(c) % (eos - 257) for c in t][:length - 2] + [eos]
            out[i, :len(ids)] = ids
        return out
    return tokenize


def sizes(spec: Dict) -> List[tuple]:
    """The mix's image sizes (width, height), the same for every run."""
    rng = np.random.default_rng(spec["sizes_seed"])
    n = spec["count"] * spec["samples"]
    w = np.asarray(spec["bucket_weights"], np.float64)
    aspects = rng.choice(np.asarray([bw / bh for bw, bh in spec["buckets"]]), size=n,
                         p=w / w.sum())
    aspects = aspects * rng.uniform(*spec["aspect_jitter"], size=n)
    areas = rng.uniform(*spec["area"], size=n)
    out = []
    for a, area in zip(aspects, areas):
        width = int(round(math.sqrt(area * a)))
        out.append((width, int(math.ceil(area / width))))
    return out


def _image(rng: np.random.Generator, width: int, height: int, quality: int) -> bytes:
    """A smooth seeded image with fine noise, as JPEG bytes."""
    from PIL import Image

    coarse = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
    img = np.asarray(Image.fromarray(coarse).resize((width, height), Image.BICUBIC),
                     np.int16)
    img = img + rng.integers(-12, 13, img.shape, dtype=np.int16)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(buf, "JPEG",
                                                                quality=quality)
    return buf.getvalue()


def _text(rng: np.random.Generator, lo: int, hi: int, chars: str) -> str:
    n = int(rng.integers(lo, hi + 1))
    return "".join(chars[int(i)] for i in rng.integers(0, len(chars), n))


ENGLISH = "abcdefghijklmnopqrstuvwxyz     "


def samples(spec: Dict, seed: int) -> List[Dict]:
    """Every sample of the mix under `seed`: {"key", "jpg" (bytes), "json"
    (dict)}, in shard order. Captions end in the sample's index, so that no
    two are alike."""
    rng = np.random.default_rng([int(seed), 11])
    out = []
    for i, (w, h) in enumerate(sizes(spec)):
        zh = bool(rng.random() < spec["zh_share"])
        chinese = _text(rng, *spec["caption_chars"], spec["zh_chars"]) + str(i)
        meta = {"caption_en": _text(rng, *spec["caption_chars"], ENGLISH) + f" {i}",
                "aesthetic_score": float(rng.uniform(6.0, 7.5)),
                "watermark": float(rng.uniform(0.0, 0.4))}
        meta["caption_ori" if zh else "caption_zh"] = chinese
        out.append({"key": f"{i:06d}", "jpg": _image(rng, w, h, spec["jpeg_quality"]),
                    "json": meta})
    return out


def write_shards(spec: Dict, seed: int, root: Path) -> List[Dict]:
    """Writes the mix's shards under `root` (``shard-000000.tar`` on);
    returns the samples written."""
    data = samples(spec, seed)
    per = spec["samples"]
    for s in range(spec["count"]):
        with tarfile.open(root / f"shard-{s:06d}.tar", "w") as tar:
            for smp in data[s * per:(s + 1) * per]:
                for ext, payload in (("jpg", smp["jpg"]),
                                     ("json", json.dumps(smp["json"]).encode())):
                    info = tarfile.TarInfo(f"{smp['key']}.{ext}")
                    info.size = len(payload)
                    tar.addfile(info, io.BytesIO(payload))
    return data


def shard_urls(spec: Dict, root: Path) -> str:
    """The shards as one brace pattern, as a training config names them."""
    return str(root / f"shard-{{000000..{spec['count'] - 1:06d}}}.tar")
