"""Fused instance norm (+AdaIN affine) (+activation): CUDA kernel and plain version.

Replaces the TPU kernel `aclgan_tpu/ops/pallas/instance_norm.py::_fwd_kernel`
(launched by `_fwd_pallas`), and computes what the JAX model computes at
every `norm='in'` / `norm='adain'` ConvBlock: `norms.instance_norm` or
`norms.adaptive_instance_norm`, then `apply_activation`.

Kernel: `aclgan_tpu_torch/csrc/instance_norm.cu`, one block per (n, c) row.
Bound on an H100: bytes. The function reads x once and writes y once
(4 bytes an element in bf16), 96.5 MB per 256² image on the translation path,
0.92 ms per batch of 32 at 3.35 TB/s. The kernel streams each row three times
(sum, centered sum of squares, normalize), because a 65,536-element row does
not fit in shared memory, so it moves up to 2x the bound's bytes; holding a
row in shared memory or splitting it over a cluster is left for later work.

`fused_instance_norm` runs the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; nothing falls back from the kernel. The backward
(TPU `_bwd_kernel`) is not ported yet, so a CUDA call that needs a gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from aclgan_tpu_torch.ops.activations import apply_activation
from aclgan_tpu_torch.ops.norms import adaptive_instance_norm, instance_norm

SOURCE = "instance_norm.cu"
# activations the kernel applies itself; prelu and selu run after it in torch
_FUSED_ACTS = {"none": 0, "relu": 1, "lrelu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset; the smoke run reads it to show the
# model's path went through the kernel.
launches = 0


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


def _launch(x: torch.Tensor, scale, shift, eps: float, activ: str) -> torch.Tensor:
    global launches
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel takes an NCHW-contiguous tensor")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, scale, shift)):
        raise NotImplementedError(
            "K2 (the fused instance-norm backward) is not ported yet; "
            "run the CUDA forward under torch.no_grad() / inference_mode()")
    n, c, h, w = x.shape
    rows, row_len = n * c, h * w
    if rows > 2**31 - 1:
        raise ValueError(f"{rows} rows exceed the kernel's grid")
    y = torch.empty_like(x)
    if rows == 0 or row_len == 0:
        return y
    if scale is not None:
        scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
        shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
    lib = _library()
    err = lib.aclgan_instance_norm_fwd(
        x.data_ptr(), None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), y.data_ptr(),
        rows, row_len, _DTYPES[x.dtype], _FUSED_ACTS[activ], float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("instance_norm kernel launch failed: "
                           + lib.aclgan_cuda_error_string(err).decode())
    launches += 1
    return y


def _library() -> ctypes.CDLL:
    from aclgan_tpu_torch.ops.kernels.build import load

    lib = load(SOURCE)
    fn = lib.aclgan_instance_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_longlong,
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
    scale/shift: (N, C). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (prelu/selu are applied after it in torch)."""
    _check(x, scale, shift, activ)
    if x.device.type == "cpu":
        return instance_norm_plain(x, scale, shift, eps, activ, prelu_alpha)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if activ in _FUSED_ACTS:
        return _launch(x, scale, shift, eps, activ)
    return apply_activation(_launch(x, scale, shift, eps, "none"), activ, prelu_alpha)
