"""Plain reference of the data stage of KD training from shards: what a
batch of written samples must hold when it reaches the train step (the
reference's preprocessing, utils/custom_dataset_sdxl.py): the caption
routed to the prompt, the image decoded, assigned to the bucket of nearest
aspect, resized (bilinear) to cover it and cropped at the sample's
coordinates, scaled to [-1, 1]; SDXL's time ids (original height and
width, crop top and left, bucket height and width); the token ids of the
prompt, the empty negative prompt and the English caption. Imports numpy,
PIL and the benchmark's tokenizers, nothing of the program.

The crop of a sample is random, drawn as the program documents it: from a
``random.Random`` keyed by the crc32 of "<data seed>:<sample key>", x then
y, each uniform over the margin.
"""
from __future__ import annotations

import io
import random
import re
import zlib
from typing import Dict, List, Sequence

import numpy as np

# Chinese ideographs, punctuation and digits are kept in a native caption
_DROP = re.compile(r"[^一-龥,.!?:;，。！？：；“”1234567890]")


def bucket_of(width: int, height: int, buckets: Sequence[Sequence[int]]) -> int:
    aspects = np.asarray([w / h for w, h in buckets])
    return int(np.abs(aspects - width / height).argmin())


def covering(width: int, height: int, dw: int, dh: int):
    if int(width * dh / height) >= dw:
        return int(width * dh / height), dh
    return dw, int(height * dw / width)


def crop_at(data_seed: int, key: str, size, dst):
    rng = random.Random(zlib.crc32(f"{data_seed}:{key}".encode("utf-8")))
    x = rng.randint(0, max(size[0] - dst[0], 0))
    y = rng.randint(0, max(size[1] - dst[1], 0))
    return y, x


def prompt_of(meta: Dict):
    """(prompt, 1 for a Chinese-native sample else 0)."""
    if "caption_ori" in meta:
        return _DROP.sub("", meta["caption_ori"]), 1
    return meta["caption_zh"], 0


def sample_rows(smp: Dict, data_seed: int, buckets) -> Dict:
    from PIL import Image

    img = Image.open(io.BytesIO(smp["jpg"]))
    img.load()
    img = img.convert("RGB")
    w, h = img.size
    dw, dh = buckets[bucket_of(w, h, buckets)]
    nw, nh = covering(w, h, dw, dh)
    img = img.resize((nw, nh), resample=Image.BILINEAR)
    top, left = crop_at(data_seed, smp["key"], (nw, nh), (dw, dh))
    img = img.crop((left, top, left + dw, top + dh))
    prompt, zh = prompt_of(smp["json"])
    return {"pixels": np.asarray(img, np.float32) / 255.0 * 2.0 - 1.0,
            "time_ids": np.asarray([h, w, top, left, dh, dw], np.float32),
            "prompt": prompt, "zh": float(zh), "caption_en": smp["json"]["caption_en"]}


def expected_batch(prompts: List[str], samples: List[Dict], data_seed: int, buckets,
                   tokenize, teacher_tokenize) -> Dict[str, np.ndarray]:
    """The batch the train step must get for rows whose prompts are
    `prompts` (each names its sample by the index it ends in)."""
    rows = [sample_rows(samples[int(re.search(r"(\d+)$", p).group(1))], data_seed, buckets)
            for p in prompts]
    n = len(rows)
    out = {"pixel_values": np.stack([r["pixels"] for r in rows]),
           "time_ids": np.stack([r["time_ids"] for r in rows]),
           "zh_or_not": np.asarray([r["zh"] for r in rows], np.float32),
           "input_ids": tokenize([r["prompt"] for r in rows]),
           "input_ids_uncond": tokenize([""] * n)}
    for k, tok in enumerate(teacher_tokenize, start=1):
        out[f"teacher_ids_{k}"] = tok([r["caption_en"] for r in rows])
        out[f"teacher_uncond_ids_{k}"] = tok([""] * n)
    out["prompts"] = [r["prompt"] for r in rows]
    return out


def batch_gap(program: Dict, expected: Dict) -> float:
    """The largest absolute difference over every array the step takes; a
    prompt that differs counts as 1."""
    gap = 0.0
    for k, want in expected.items():
        if k == "prompts":
            gap = max(gap, float(any(a != b for a, b in zip(program[k], want))))
            continue
        got = np.asarray(program[k], np.float64)
        if got.shape != want.shape:
            return float("inf")
        gap = max(gap, float(np.abs(got - want.astype(np.float64)).max()))
    return gap
