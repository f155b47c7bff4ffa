"""Adam whose step can be captured in a CUDA graph, with float32 or bfloat16
first moments (`tpu.moment_dtype`).

The JAX package's optimizer is `optax.chain(add_decayed_weights(wd),
scale_by_adam(mu_dtype=...))` (`aclgan_tpu/trainer.py:101-109`), applied as
`p + (-lr * u)`. This module follows its update step for step, per parameter
p with gradient g:

    g   = g + wd * p                      # coupled L2, before the moments
    mu  = (1 - b1) * g + (b1 * mu)        # bf16 moments: b1 * mu in bf16, the sum in f32
    nu  = (1 - b2) * g * g + b2 * nu      # float32
    u   = (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)
    p   = p + (-lr * u)
    mu  = mu cast to its dtype            # the f32 mu served the update

In `b1 * mu_bf16` JAX casts the Python scalar b1 to bfloat16 before the
product (a weak type takes the array's dtype), so b1 is rounded to bf16
here too: 0.9 becomes 0.8984375 in that product, not in `1 - b1`.

Nothing in `update()` reads a tensor back to the host, so the card can
record it into a CUDA graph (`graphs.py`): the step count t lives in device
tensors (`state["step"]`, float32, as `torch.optim.Adam(capturable=True)`
keeps it), the bias corrections are computed on the device, and the learning
rate is read from a 0-dim device tensor per group that `set_lr` (or `step`)
writes outside the update. The same update runs on the CPU, where the tests
hold it against optax. `torch.optim.Adam(capturable=True)` itself takes no
CPU tensors, and a tensor lr with `foreach=True` it refuses uncaptured.

`state_dict()` keeps `torch.optim.Adam`'s keys (`step`, `exp_avg`,
`exp_avg_sq`) and a float lr in `param_groups`, so `utils/checkpoint.py`
writes and reads both moment dtypes alike, and a file written by
`torch.optim.Adam` loads.
"""

from __future__ import annotations

import struct
from typing import Iterable, Tuple

import torch


def _round_bf16(x: float) -> float:
    """x rounded to the nearest bfloat16 (ties to even), in pure Python: a
    tensor's `float()` would be a host read in the step."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


class Adam(torch.optim.Optimizer):
    """Adam + coupled L2 in optax's arithmetic, first moment in `mu_dtype`."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-4,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype: torch.dtype = torch.float32):
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype must be float32 or bfloat16, got {mu_dtype}")
        self.mu_dtype = mu_dtype
        self._lr = []          # a 0-dim f32 lr tensor per group, on its parameters' device
        self._lr_written = []  # the value each holds
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def add_param_group(self, param_group: dict) -> None:
        super().add_param_group(param_group)
        group = self.param_groups[-1]
        device = group["params"][0].device if group["params"] else torch.device("cpu")
        self._lr.append(torch.full((), group["lr"], dtype=torch.float32, device=device))
        self._lr_written.append(group["lr"])

    def set_lr(self, lr: float) -> None:
        """Every group's learning rate, written to its device tensor only when
        it changed (one small launch then; none under a constant lr)."""
        for group in self.param_groups:
            group["lr"] = lr
        self._sync_lr()

    def _sync_lr(self) -> None:
        for i, group in enumerate(self.param_groups):
            if group["lr"] != self._lr_written[i]:
                self._lr[i].fill_(group["lr"])
                self._lr_written[i] = group["lr"]

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
            st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    def load_state_dict(self, state_dict: dict) -> None:
        """`Optimizer.load_state_dict` casts every moment to its parameter's
        dtype and leaves a saved CPU step where it was: the first moment goes
        back to `mu_dtype` (bf16 -> f32 -> bf16 is exact), the step to a
        float32 tensor on its parameter's device."""
        super().load_state_dict(state_dict)
        for p, st in self.state.items():
            st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)
            st["step"] = torch.as_tensor(st["step"], dtype=torch.float32).to(p.device)

    @torch.no_grad()
    def step(self, closure=None):
        """Write each group's float lr to its tensor where it changed, then
        `update()`."""
        if closure is not None:
            raise ValueError(f"{type(self).__name__} takes no closure")
        self._sync_lr()
        self.update()

    @torch.no_grad()
    def update(self) -> None:
        """One Adam update from each parameter's `.grad` at the lr tensors'
        values: device ops only, no host read."""
        for group, lr in zip(self.param_groups, self._lr):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self._state(p) for p in params]
            b1, b2 = group["betas"]
            g = [p.grad for p in params]
            if group["weight_decay"]:
                g = torch._foreach_add(g, torch._foreach_mul(params, group["weight_decay"]))
            mu_old = [st["exp_avg"] for st in states]
            if self.mu_dtype == torch.float32:
                prod = torch._foreach_mul(mu_old, b1)
            else:  # b1 * mu in bf16, with b1 rounded to bf16, then to f32
                prod = [t.float() for t in torch._foreach_mul(mu_old, _round_bf16(b1))]
            mu = torch._foreach_mul(g, 1.0 - b1)
            torch._foreach_add_(mu, prod)
            nu = [st["exp_avg_sq"] for st in states]
            sq = torch._foreach_mul(g, g)
            torch._foreach_mul_(sq, 1.0 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, sq)
            steps = [st["step"] for st in states]
            torch._foreach_add_(steps, 1.0)
            t = steps[0]  # every parameter of a group steps together
            bc1 = 1.0 - torch.pow(b1, t)  # float32, as optax's
            bc2 = 1.0 - torch.pow(b2, t)
            upd = torch._foreach_div(mu, bc1)
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(upd, den)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
            torch._foreach_copy_(mu_old, mu)  # rounds to bf16 for bf16 moments

