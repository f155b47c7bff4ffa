"""Frechet Inception Distance (the port's copy of `aclgan_tpu/eval/fid.py`).

numpy and scipy only: the mean and covariance of pool3 features, and the
Frechet distance through scipy's float64 `sqrtm` of the covariance product,
retried with a small diagonal offset when that is not finite. The features
come from `aclgan_tpu_torch.eval.inception.InceptionScorer`.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
from scipy import linalg


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean, covariance)."""
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, sigma


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


def compute_fid(
    real_batches: Iterable[np.ndarray],
    fake_batches: Iterable[np.ndarray],
    scorer=None,
    weights_path: Optional[str] = None,
    device: str = "cuda",
) -> float:
    """FID between two streams of NHWC [0,1] image batches."""
    if scorer is None:
        from aclgan_tpu_torch.eval.inception import InceptionScorer

        scorer = InceptionScorer(weights_path, device=device)
    real_f = np.concatenate([scorer.features(b) for b in real_batches], 0)
    fake_f = np.concatenate([scorer.features(b) for b in fake_batches], 0)
    return frechet_distance(*feature_stats(real_f), *feature_stats(fake_f))
