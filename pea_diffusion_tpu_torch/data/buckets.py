"""Aspect-ratio bucketing (the port's own copy of
``pea_diffusion_tpu/data/buckets.py``; reference
utils/custom_dataset_sdxl.py:30-31,53-88).

9 buckets from 448x896 to 896x448 with empirical sampling probabilities;
images are assigned to the nearest-aspect bucket, resized so the bucket
rectangle is covered, then random- (train) or center-cropped, recording
`crops_coords_top_left` for SDXL micro-conditioning.
"""
from __future__ import annotations

import random
from typing import Tuple

import numpy as np

# [width, height] (PIL convention, matching the reference constants)
BUCKETS = [[448, 896], [448, 832], [512, 768], [576, 704], [640, 640],
           [704, 576], [768, 512], [832, 448], [896, 448]]
BUCKET_PROBS = [0.004886049723756906, 0.006837016574585636,
                0.08071477900552486, 0.07225483425414364,
                0.22078729281767956, 0.20676795580110496,
                0.29387085635359117, 0.09240331491712707,
                0.021477900552486186]
MAX_AR_ERROR = 2.0
ASPECTS = np.array([b[0] / b[1] for b in BUCKETS])


def assign_bucket(width: int, height: int) -> int:
    """Nearest-aspect bucket id (utils/custom_dataset_sdxl.py:71-74)."""
    aspect = float(width) / float(height)
    return int(np.abs(ASPECTS - aspect).argmin())


def scaled_size_to_cover(size: Tuple[int, int], dst: Tuple[int, int]) -> Tuple[int, int]:
    """Resize dims (w,h) so the image covers dst (w,h), preserving aspect
    (the two-branch Resize at utils/custom_dataset_sdxl.py:292-299)."""
    w, h = size
    dw, dh = dst
    if int(w * dh / h) >= dw:
        return int(w * dh / h), dh
    return dw, int(h * dw / w)


def random_crop_coords(size: Tuple[int, int], dst: Tuple[int, int],
                       rng: random.Random) -> Tuple[int, int]:
    """(top, left) for a random crop of dst out of size (crop_left_upper,
    utils/custom_dataset_sdxl.py:81-88 — returns (y, x))."""
    w, h = size
    dw, dh = dst
    x = rng.randint(0, max(w - dw, 0))
    y = rng.randint(0, max(h - dh, 0))
    return y, x


def center_crop_coords(size: Tuple[int, int], dst: Tuple[int, int]) -> Tuple[int, int]:
    w, h = size
    dw, dh = dst
    return max((h - dh) // 2, 0), max((w - dw) // 2, 0)


def resize_and_crop(img, bucket_id: int, center: bool, rng: random.Random):
    """PIL image -> (cropped PIL image at bucket size, (top, left))."""
    dst = BUCKETS[bucket_id]
    nw, nh = scaled_size_to_cover(img.size, tuple(dst))
    img = img.resize((nw, nh), resample=2)  # PIL.Image.BILINEAR
    if center:
        top, left = center_crop_coords((nw, nh), tuple(dst))
    else:
        top, left = random_crop_coords((nw, nh), tuple(dst), rng)
    img = img.crop((left, top, left + dst[0], top + dst[1]))
    return img, (top, left)


def normalize_to_tensor(img) -> np.ndarray:
    """PIL RGB -> float32 NHWC in [-1, 1] (transforms.Normalize([0.5],[0.5]))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0
