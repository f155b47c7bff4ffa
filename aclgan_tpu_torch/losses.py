"""Loss heads and focus-mask blends (`aclgan_tpu/losses.py`), NCHW, f32 math.

The heads take the per-scale logit lists of `MsDiscriminator` (the reference
couples them to the module, networks.py:60-106).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

Logits = List[torch.Tensor]


def _bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """mean BCE(sigmoid(logits), target) in the stable form
    log(1 + e^x) - t*x (networks.py:71-72)."""
    return torch.mean(torch.logaddexp(logits, torch.zeros_like(logits)) - target * logits)


def _head(out: torch.Tensor, target: float, gan_type: str) -> torch.Tensor:
    """Push one logit map towards `target` (0 or 1)."""
    out = out.float()
    if gan_type == "lsgan":
        return torch.mean(torch.square(out - target))
    if gan_type == "nsgan":
        return _bce_with_logits(out, target)
    raise ValueError(f"Unsupported GAN type: {gan_type!r}")


def dis_loss(fake_outs: Logits, real_outs: Logits, gan_type: str) -> torch.Tensor:
    """D-step loss: D(fake)->0, D(real)->1, summed over scales
    (calc_dis_loss, networks.py:60-75)."""
    return sum(_head(f, 0.0, gan_type) + _head(r, 1.0, gan_type)
               for f, r in zip(fake_outs, real_outs))


def gen_loss(fake_outs: Logits, gan_type: str) -> torch.Tensor:
    """G-step loss: D(fake)->1, summed over scales (calc_gen_loss, networks.py:77-89)."""
    return sum(_head(f, 1.0, gan_type) for f in fake_outs)


def gen_d2_loss(pair1_outs: Logits, pair2_outs: Logits, gan_type: str) -> torch.Tensor:
    """Generator-side consistency loss: D2(pair1)->1, D2(pair2)->0, the mirror
    of dis_loss(pair1, pair2) (calc_gen_d2_loss, networks.py:91-106)."""
    return sum(_head(p1, 1.0, gan_type) + _head(p2, 0.0, gan_type)
               for p1, p2 in zip(pair1_outs, pair2_outs))


def l1_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean |x - target| (recon_criterion, trainer.py:61-62)."""
    return torch.mean(torch.abs(x.float() - target.float()))


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


def focus_size_loss(mask01: torch.Tensor, upper: float, lower: float,
                    delta: float) -> torch.Tensor:
    """relu(sum(m - upper))^2*delta + relu(sum(lower - m))^2*delta, the sums
    over the whole batch tensor (trainer.py:149-157)."""
    m = mask01.float()
    over = F.relu(torch.sum(m - upper))
    under = F.relu(torch.sum(lower - m))
    return (over * over + under * under) * delta


def focus_digit_loss(mask01: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Binarization pressure: sum(1/(|m-0.5|+eps)) (trainer.py:151,154,158)."""
    m = mask01.float()
    return torch.sum(1.0 / (torch.abs(m - 0.5) + epsilon))
