"""Focus-mask blends (`aclgan_tpu/losses.py:76-92`), NCHW, f32 math.

The loss heads wait for the training slice.
"""

from __future__ import annotations

import torch


def focus_translation(x_fg: torch.Tensor, x_bg: torch.Tensor,
                      x_focus: torch.Tensor) -> torch.Tensor:
    """Train-time mask blend: mask=(focus+1)/2; fg*mask + bg*(1-mask).
    x_focus: (N,1,H,W), broadcast over channels."""
    x_map = (x_focus.float() + 1.0) * 0.5
    return (x_fg.float() * x_map + x_bg.float() * (1.0 - x_map)).to(x_fg.dtype)


def focus_translation_eval(x_fg: torch.Tensor, x_bg: torch.Tensor,
                           x_focus: torch.Tensor) -> torch.Tensor:
    """Test-time variant: blends in [0,1] space, then rescales to [-1,1]
    (a deliberate train/test difference of the reference)."""
    x_map = (x_focus.float() + 1.0) * 0.5
    fg01 = (x_fg.float() + 1.0) * 0.5
    bg01 = (x_bg.float() + 1.0) * 0.5
    out = fg01 * x_map + bg01 * (1.0 - x_map)
    return (out * 2.0 - 1.0).to(x_fg.dtype)
