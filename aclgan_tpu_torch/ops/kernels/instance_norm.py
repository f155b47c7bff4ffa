"""Fused instance norm (+AdaIN affine) (+activation): CUDA kernels and plain versions.

K1, the forward, replaces the TPU kernel
`aclgan_tpu/ops/pallas/instance_norm.py::_fwd_kernel` (launched by
`_fwd_pallas`), and computes what the JAX model computes at every
`norm='in'` / `norm='adain'` ConvBlock: `norms.instance_norm` or
`norms.adaptive_instance_norm`, then `apply_activation`. K2, the backward,
replaces `_bwd_kernel` (launched by `_bwd_pallas`); `_FusedInstanceNorm`
pairs them as the `custom_vjp` `_fused_in` does.

Kernels: `aclgan_tpu_torch/csrc/instance_norm.cu`, one block per (n, c) row.
Bound on an H100: bytes. K1 reads x once and writes y once (4 bytes an
element in bf16), 96.5 MB per 256² image on the translation path, 0.92 ms per
batch of 32 at 3.35 TB/s; it streams each row three times (sum, centered sum
of squares, normalize), because a 65,536-element row does not fit in shared
memory, so it moves up to 2x the bound's bytes. K2 reads x, y and dy and
writes dx (8 bytes an element in bf16) and streams x four times and y, dy
twice. Holding a row in shared memory, splitting it over a cluster, or
saving (mean, rsig) from K1 for K2 is left for later work.

K1 is also one dispatcher op, `torch.ops.aclgan.instance_norm_fwd(x, scale,
shift, eps, activ)` (activ: the code in `_FUSED_ACTS`), registered when this
module is imported: its CUDA impl launches the kernel, its CPU impl is the
plain version, and its fake impl gives `torch.export` the output's shape, so
an exported translation step holds K1 as one graph node and launches the
kernel on the card whatever device it was traced on. Loading such a program
needs this module and nothing of the model. The op is defined through
`torch.library.Library` rather than `torch.library.custom_op`: the latter
wraps every call in more Python, and the serving and D-step paths call K1
19 to 49 times a step.

`fused_instance_norm` calls the op when no gradient is needed. With one, a
tensor on the CPU takes the plain version (autograd gives its backward) and a
CUDA tensor `_FusedInstanceNorm` (K1 forward, K2 backward). Nothing falls back
from a kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from aclgan_tpu_torch.ops.activations import apply_activation
from aclgan_tpu_torch.ops.norms import adaptive_instance_norm, instance_norm

SOURCE = "instance_norm.cu"
# activations the kernel applies itself; prelu and selu run after it in torch
_FUSED_ACTS = {"none": 0, "relu": 1, "lrelu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (K1: `launches`, K2: `bwd_launches`);
# the smoke run reads them to show the model's path went through the kernels.
launches = 0
bwd_launches = 0


def instance_norm_plain(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None, eps: float = 1e-5,
                        activ: str = "none",
                        prelu_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in torch ops: IN or AdaIN, cast, then activation."""
    if scale is not None:
        y = adaptive_instance_norm(x, scale, shift, eps)
    else:
        y = instance_norm(x, eps)
    return apply_activation(y, activ, prelu_alpha)


def _gate(dy: torch.Tensor, y: torch.Tensor, activ: str) -> torch.Tensor:
    """dy through the activation, from its output y (`_bwd_kernel:113-118`)."""
    if activ == "relu":
        return torch.where(y > 0, dy, torch.zeros_like(dy))
    if activ == "lrelu":
        return torch.where(y >= 0, dy, 0.2 * dy)
    if activ == "tanh":
        return dy * (1.0 - y * y)
    if activ == "none":
        return dy
    raise ValueError(f"K2 gates relu / lrelu / tanh / none, not {activ!r}")


def instance_norm_bwd_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                            y: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5,
                            activ: str = "none"):
    """K2's function in torch ops: (dx in x's dtype, dscale, dshift as (N, C)
    f32) for y = act(xhat * scale + shift); scale None is plain IN (s = 1)."""
    x32, y32 = x.float(), y.float()
    dyp = _gate(dy.float(), y32, activ)
    mean = x32.mean(dim=(2, 3), keepdim=True)
    xc = x32 - mean
    rsig = torch.rsqrt((xc * xc).mean(dim=(2, 3), keepdim=True) + eps)
    xhat = xc * rsig
    s = 1.0 if scale is None else scale.float()[:, :, None, None]
    m_dy = dyp.mean(dim=(2, 3), keepdim=True)
    m_dyx = (dyp * xhat).mean(dim=(2, 3), keepdim=True)
    dx = rsig * s * (dyp - m_dy - xhat * m_dyx)
    return dx.to(x.dtype), (dyp * xhat).sum(dim=(2, 3)), dyp.sum(dim=(2, 3))


def _check(x, scale, shift, activ):
    if x.dim() != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    if scale is not None:
        n, c = x.shape[:2]
        for name, t in (("scale", scale), ("shift", shift)):
            if tuple(t.shape) != (n, c):
                raise ValueError(f"{name} must be (N, C) = {(n, c)}, got {tuple(t.shape)}")
    if activ not in _FUSED_ACTS and activ not in ("prelu", "selu"):
        raise ValueError(f"Unsupported activation: {activ!r}")


def _rows(x: torch.Tensor):
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel takes an NCHW-contiguous tensor")
    n, c, h, w = x.shape
    rows, row_len = n * c, h * w
    if rows > 2**31 - 1:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    return rows, row_len


def _vec(t: Optional[torch.Tensor], x: torch.Tensor) -> Optional[torch.Tensor]:
    """An (N, C) scale or shift as the contiguous f32 rows the kernels read."""
    return None if t is None else t.to(device=x.device, dtype=torch.float32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.aclgan_cuda_error_string(err).decode())


def _launch_device(x: torch.Tensor):
    """The kernels launch on the runtime's current device: a guard that makes
    it x's, entered only when it is not (the guard costs host time on every
    call, and the short rows' launches are host-bound)."""
    if x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


def _launch(x: torch.Tensor, scale, shift, eps: float, activ: str) -> torch.Tensor:
    """K1 on a CUDA tensor; scale/shift None or f32 (N, C) on x's device."""
    global launches
    rows, row_len = _rows(x)
    y = torch.empty_like(x)
    if rows == 0 or row_len == 0:
        return y
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_fwd(
            x.data_ptr(), _ptr(scale), _ptr(shift), y.data_ptr(),
            rows, row_len, _DTYPES[x.dtype], _FUSED_ACTS[activ], float(eps),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "instance_norm")
    launches += 1
    return y


def instance_norm_bwd(x: torch.Tensor, scale: Optional[torch.Tensor], y: torch.Tensor,
                      dy: torch.Tensor, eps: float = 1e-5, activ: str = "none"):
    """K2 on CUDA tensors: (dx, dscale, dshift), the latter two (N, C) f32, or
    None when scale is None. x, y and dy: one NCHW-contiguous shape and dtype."""
    global bwd_launches
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on a CUDA tensor, got {x.device}")
    if activ not in _FUSED_ACTS:
        raise ValueError(f"K2 gates relu / lrelu / tanh / none, not {activ!r}")
    rows, row_len = _rows(x)
    for name, t in (("y", y), ("dy", dy)):
        if t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be NCHW-contiguous {tuple(x.shape)} {x.dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    scale = _vec(scale, x)
    dx = torch.empty_like(x)
    ds = db = None
    if scale is not None:
        ds = torch.zeros(x.shape[:2], device=x.device, dtype=torch.float32)
        db = torch.zeros_like(ds)
    if rows == 0 or row_len == 0:
        return dx, ds, db
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_bwd(
            x.data_ptr(), _ptr(scale), y.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            _ptr(ds), _ptr(db), rows, row_len, _DTYPES[x.dtype], _FUSED_ACTS[activ],
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, err, "instance_norm backward")
    bwd_launches += 1
    return dx, ds, db


class _FusedInstanceNorm(torch.autograd.Function):
    """K1 forward, K2 backward (the `custom_vjp` `_fused_in`, `:161-179`).

    The (N, C) scale/shift may arrive in any dtype and layout (the AdaIN
    vector is a bf16 slice of the MLP output); the kernels read them as
    contiguous f32, and their gradients go back in the dtype given."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps, activ):
        s32, b32 = _vec(scale, x), _vec(shift, x)
        y = _launch(x, s32, b32, eps, activ)
        ctx.save_for_backward(x, s32, b32, y)
        ctx.eps, ctx.activ = eps, activ
        ctx.dtypes = (None if scale is None else scale.dtype,
                      None if shift is None else shift.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s32, _, y = ctx.saved_tensors
        # autograd may hand over a non-contiguous or differently typed gradient
        dy = dy.to(x.dtype).contiguous()
        dx, ds, db = instance_norm_bwd(x, s32, y, dy, ctx.eps, ctx.activ)
        if ds is None:
            return dx, None, None, None, None
        return dx, ds.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None, None


def _library() -> ctypes.CDLL:
    from aclgan_tpu_torch.ops.kernels.build import load

    lib = load(SOURCE)
    fn = lib.aclgan_instance_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.aclgan_instance_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.aclgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aclgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None, eps: float = 1e-5,
                        activ: str = "none",
                        prelu_alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """IN (scale/shift None) or AdaIN, then activation. x: (N, C, H, W);
    scale/shift: (N, C). Without a gradient, the `aclgan::instance_norm_fwd`
    op: K1 on a CUDA tensor, the plain version on a CPU one. With one, the
    plain version on the CPU and K1 + K2 (`_FusedInstanceNorm`) on CUDA.
    prelu/selu are applied after the op or kernel in torch."""
    _check(x, scale, shift, activ)
    act = activ if activ in _FUSED_ACTS else "none"
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, shift)):
        if x.device.type == "cpu":
            return instance_norm_plain(x, scale, shift, eps, activ, prelu_alpha)
        if x.device.type != "cuda":
            raise ValueError(f"no kernel for device {x.device}")
        y = _FusedInstanceNorm.apply(x, scale, shift, eps, act)
    else:
        y = torch.ops.aclgan.instance_norm_fwd(x, scale, shift, eps, _FUSED_ACTS[act])
    return y if act == activ else apply_activation(y, activ, prelu_alpha)


# K1 as one dispatcher op (see the module docstring); kept alive with the module
_ACT_NAMES = {code: name for name, code in _FUSED_ACTS.items()}
_LIB = torch.library.Library("aclgan", "DEF")
_LIB.define("instance_norm_fwd(Tensor x, Tensor? scale, Tensor? shift, float eps, "
            "int activ) -> Tensor")


def _op_cuda(x, scale, shift, eps, activ):
    return _launch(x, _vec(scale, x), _vec(shift, x), eps, _ACT_NAMES[activ])


def _op_cpu(x, scale, shift, eps, activ):
    return instance_norm_plain(x, scale, shift, eps, _ACT_NAMES[activ])


def _op_fake(x, scale, shift, eps, activ):
    return torch.empty_like(x)


_LIB.impl("instance_norm_fwd", _op_cuda, "CUDA")
_LIB.impl("instance_norm_fwd", _op_cpu, "CPU")
torch.library.register_fake("aclgan::instance_norm_fwd", _op_fake, lib=_LIB)
