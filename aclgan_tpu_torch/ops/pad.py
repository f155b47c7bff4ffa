"""Spatial padding of NCHW tensors (`aclgan_tpu/ops/pad.py`).

The JAX module carries a custom VJP that existed for the TPU's slow autodiff
of reflect pads; autograd's own pad backward serves here, so only the mode
table is ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# torch pad_type -> F.pad mode
PAD_MODES = {"reflect": "reflect", "replicate": "replicate", "zero": "constant"}


def pad2d(x: torch.Tensor, p: int, mode: str = "reflect") -> torch.Tensor:
    """Pad H and W of an NCHW tensor by p (reflect / replicate / zero)."""
    if mode not in PAD_MODES:
        raise ValueError(f"Unsupported padding type: {mode!r}")
    if p == 0:
        return x
    return F.pad(x, (p, p, p, p), mode=PAD_MODES[mode])
