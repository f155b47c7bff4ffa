"""Adam with a bfloat16 first moment, for `tpu.moment_dtype: bfloat16`.

The JAX package's optimizer is `optax.chain(add_decayed_weights(wd),
scale_by_adam(mu_dtype=bfloat16))` (`aclgan_tpu/trainer.py:101-109`). This
module follows its update step for step, per parameter p with gradient g:

    g   = g + wd * p                      # coupled L2, before the moments
    mu  = (1 - b1) * g + (b1 * mu_bf16)   # b1 * mu in bf16, the sum in f32
    nu  = (1 - b2) * g * g + b2 * nu      # float32
    u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    p   = p + (-lr * u)
    mu_bf16 = bf16(mu)                     # the f32 mu served the update

In `b1 * mu_bf16` JAX casts the Python scalar b1 to bfloat16 before the
product (a weak type takes the array's dtype), so b1 is rounded to bf16
here too: 0.9 becomes 0.8984375 in that product, not in `1 - b1`.

`state_dict()` keeps `torch.optim.Adam`'s keys (`step`, `exp_avg`,
`exp_avg_sq`), so `utils/checkpoint.py` writes and reads both optimizers
alike. float32 moments use `torch.optim.Adam` itself (`trainer.py`).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch


class AdamBf16Mu(torch.optim.Optimizer):
    """Adam + coupled L2 whose first moment is stored in bfloat16."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.tensor(0.0)
            st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    def load_state_dict(self, state_dict: dict) -> None:
        """`Optimizer.load_state_dict` casts every moment to its parameter's
        dtype; the first moment goes back to bf16 (bf16 -> f32 -> bf16 is exact)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamBf16Mu takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state(p) for p in params]
            b1, b2 = group["betas"]
            g = [p.grad for p in params]
            if group["weight_decay"]:
                g = torch._foreach_add(g, torch._foreach_mul(params, group["weight_decay"]))
            mu_bf16 = [st["exp_avg"] for st in states]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            mu = torch._foreach_mul(g, 1.0 - b1)
            torch._foreach_add_(mu, [t.float() for t in torch._foreach_mul(mu_bf16, b1_bf16)])
            nu = [st["exp_avg_sq"] for st in states]
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            for st in states:
                st["step"] += 1
            t = int(states[0]["step"])
            bc1 = torch.tensor(1.0) - torch.tensor(b1) ** t  # float32, as optax's
            bc2 = torch.tensor(1.0) - torch.tensor(b2) ** t
            upd = torch._foreach_div(mu, float(bc1))
            den = torch._foreach_div(nu, float(bc2))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)
            for st, m in zip(states, mu):
                st["exp_avg"].copy_(m)  # rounds to bf16
        return None
