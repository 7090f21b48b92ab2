"""Fréchet distance (FID) over image-feature sets (the port's own copy of
``pea_diffusion_tpu/utils/fid.py``).

The features come from the CLIP vision tower (``models/clip_vision.py``):
the CLIP-FID variant (Kynkäänniemi et al. 2022, arXiv:2203.06026). The
linear algebra runs in numpy fp64 on the host, as in the JAX package:
feature sets are small next to the generation cost, so the features come off
the card (``.cpu().numpy()``) before they reach these functions.
"""
from __future__ import annotations

import numpy as np


def gaussian_stats(features: np.ndarray):
    """[N, D] features -> (mu [D], cov [D, D]) with the unbiased estimator
    (ddof=1, as clean-fid and pytorch-fid)."""
    f = np.asarray(features, np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be [N, D], got {f.shape}")
    if f.shape[0] < 2:
        raise ValueError(
            f"FID needs >= 2 samples per feature set to estimate a "
            f"covariance (ddof=1), got N={f.shape[0]}")
    mu = f.mean(axis=0)
    cov = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(cov)


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(C1 + C2 - 2 sqrtm(C1 C2)).

    Tr(sqrtm(C1 C2)) is taken through the symmetric form
    sqrtm(C1) C2 sqrtm(C1) (a similar matrix, PSD), so `eigh` suffices: no
    scipy sqrtm, no complex arithmetic. `eps` regularizes both covariances
    (+eps*I, pytorch-fid's stabilizer) so that near-singular estimates from
    small feature sets stay PSD; the result is clamped at 0."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    d = np.asarray(cov1).shape[0]
    cov1 = np.asarray(cov1, np.float64) + eps * np.eye(d)
    cov2 = np.asarray(cov2, np.float64) + eps * np.eye(d)
    diff = mu1 - mu2

    w1, v1 = np.linalg.eigh(cov1)
    s1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = s1 @ cov2 @ s1
    wm = np.linalg.eigvalsh((m + m.T) / 2.0)
    tr_sqrt = np.sqrt(np.clip(wm, 0.0, None)).sum()

    fid = diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt
    return float(max(fid, 0.0))


def fid_from_features(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID between two feature sets [Na, D], [Nb, D]."""
    return frechet_distance(*gaussian_stats(feats_a),
                            *gaussian_stats(feats_b))
