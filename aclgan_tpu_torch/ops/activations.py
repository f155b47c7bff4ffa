"""Activation menu of Conv2dBlock/LinearBlock (`aclgan_tpu/ops/activations.py`)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = ("relu", "lrelu", "prelu", "selu", "tanh", "none")


def apply_activation(x: torch.Tensor, activ: str,
                     prelu_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """relu / lrelu(0.2) / prelu (learnable alpha) / selu / tanh / none."""
    if activ == "relu":
        return F.relu(x)
    if activ == "lrelu":
        return F.leaky_relu(x, 0.2)
    if activ == "prelu":
        alpha = torch.as_tensor(0.25 if prelu_alpha is None else prelu_alpha)
        alpha = alpha.to(device=x.device, dtype=x.dtype)
        return torch.where(x >= 0, x, alpha * x)
    if activ == "selu":
        return F.selu(x)
    if activ == "tanh":
        return torch.tanh(x)
    if activ == "none":
        return x
    raise ValueError(f"Unsupported activation: {activ!r} (supported: {ACTIVATIONS})")
