"""Latent-space utilities: slerp interpolation + parameter counting.

Port of `aclgan_tpu/utils/latent.py`: `slerp` / `get_slerp_interp`
interpolate style codes between two samples (numpy, as there), and
`get_parameter_number` counts an `nn.Module`'s parameters.
"""

from __future__ import annotations

import numpy as np
from torch import nn


def slerp(val: float, low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """Spherical interpolation between two latent vectors."""
    low = np.asarray(low, np.float64)
    high = np.asarray(high, np.float64)
    omega = np.arccos(np.clip(
        np.dot(low / np.linalg.norm(low), high / np.linalg.norm(high)), -1.0, 1.0))
    so = np.sin(omega)
    if so == 0.0:  # parallel vectors: fall back to lerp
        return ((1.0 - val) * low + val * high).astype(np.float32)
    return (np.sin((1.0 - val) * omega) / so * low
            + np.sin(val * omega) / so * high).astype(np.float32)


def get_slerp_interp(nb_latents: int, nb_interp: int, z_dim: int,
                     seed: int = 0) -> np.ndarray:
    """(nb_latents*nb_interp, z_dim) slerp chains between random endpoints."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(nb_latents):
        low = rng.randn(z_dim)
        high = rng.randn(z_dim)
        for v in np.linspace(0, 1, num=nb_interp):
            out.append(slerp(float(v), low, high))
    return np.stack(out).astype(np.float32)


def get_parameter_number(module: nn.Module) -> dict:
    """Total and trainable parameter counts of a module."""
    params = list(module.parameters())
    return {"Total": sum(p.numel() for p in params),
            "Trainable": sum(p.numel() for p in params if p.requires_grad)}
