"""Fused instance norm (+AdaIN affine) (+activation): CUDA kernels and plain versions.

K1, the forward, replaces the TPU kernel
`aclgan_tpu/ops/pallas/instance_norm.py::_fwd_kernel` (launched by
`_fwd_pallas`), and computes what the JAX model computes at every
`norm='in'` / `norm='adain'` ConvBlock: `norms.instance_norm` or
`norms.adaptive_instance_norm`, then `apply_activation`. K2, the backward,
replaces `_bwd_kernel` (launched by `_bwd_pallas`); `_FusedInstanceNorm`
pairs them as the `custom_vjp` `_fused_in` does.

Kernels: `aclgan_tpu_torch/csrc/instance_norm.cu`. Bound on an H100: bytes.
K1 reads x once and writes y once (4 bytes an element in bf16), 96.5 MB per
256² image on the translation path, 0.92 ms per batch of 32 at 3.35 TB/s;
K2 reads x, y and dy and writes dx (8 bytes an element in bf16). Each holds
its share of a row in registers, loaded once as 16-byte words, and a row
longer than one CTA holds is split over a thread block cluster of up to 8
CTAs whose partial sums meet in distributed shared memory, so each reads
and writes every byte once. K1 can also return each row's f32 (mean, rsig):
`_FusedInstanceNorm` saves them, and K2 reads them rather than recomputing
them from x (`instance_norm_stats_plain` is their formula). The launch plan
(`_fused_plan`, computed here and cached) picks the CTAs a row, the
elements a load and the variant: rows too long for 8 CTAs take a streaming
variant of each kernel, one CTA a row, which reads its inputs two (K2) or
three (K1) times.

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

Under a mesh that splits H over ranks (`parallel/spatial.py`), a row's
elements lie on several ranks, and `fused_instance_norm` takes the split
form, `_ShardedFusedInstanceNorm`: K1m (each row's f32 sum and sum of
squares on this rank) -> one all-reduce over the spatial group -> K1a (the
statistics from the summed moments, then normalize, affine, activation; it
also writes the (N, C) mean and rsig the backward saves) in the forward, with
no torch op between the all-reduce and K1a; K2m (each row's sums of the gated
dy and of it times xhat) -> one all-reduce -> K2a (dx) in the backward. The
four kernels sit in the same `.cu` file, each with its plain version here
(`_stats` holds the statistics' formula for K1a's); their wrappers take the
plain version for a tensor on the CPU (the gloo ranks of the tests) and
launch the kernel for a CUDA one. Each takes a launch plan computed here and
cached: K1m and K2m from `_split_plan` (the CTAs of a cluster a row, the
elements of a load), K1a and K2a from `_apply_plan` (the chunks of a row,
each on its own CTA, and the elements of a load). A rank's short rows take a
few microseconds of the card each, so every split wrapper keeps the host's
work to the checks, `torch.empty` outputs, per-row vectors passed through
when they already are contiguous f32 on the device, and the ctypes call
(signatures set once in `_configure`) on the raw current stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional

import torch
import torch.distributed as dist

from aclgan_tpu_torch.ops.activations import apply_activation
from aclgan_tpu_torch.ops.norms import adaptive_instance_norm, instance_norm
from aclgan_tpu_torch.parallel.spatial import sharded

SOURCE = "instance_norm.cu"
# activations the kernel applies itself; prelu and selu run after it in torch
_FUSED_ACTS = {"none": 0, "relu": 1, "lrelu": 2, "tanh": 3}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset (K1: `launches`, K2: `bwd_launches`);
# the smoke run reads them to show the model's path went through the kernels.
launches = 0
bwd_launches = 0
# the split form's launches: K1m, K1a, K2m, K2a
moments_launches = 0
apply_launches = 0
bwd_sums_launches = 0
bwd_apply_launches = 0
# every counter above, by name. A wrapper counts in Python, so a CUDA graph's
# replay calls none: `graphs.py` keeps each counter's change over the capture
# and adds it at every replay instead.
COUNTERS = ("launches", "bwd_launches", "moments_launches", "apply_launches",
            "bwd_sums_launches", "bwd_apply_launches")


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


def _col(t: torch.Tensor) -> torch.Tensor:
    return t.float()[:, :, None, None]


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


def instance_norm_stats_plain(x: torch.Tensor, eps: float = 1e-5):
    """Each (n, c) row's f32 (mean, rsig), (N, C): the centered two-pass
    formula of `ops/norms.py::_normalize` and of `_fwd_kernel`; what K1
    writes when asked."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3))
    xc = x32 - mean[:, :, None, None]
    return mean, torch.rsqrt((xc * xc).mean(dim=(2, 3)) + eps)


def instance_norm_bwd_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                            y: torch.Tensor, dy: torch.Tensor, eps: float = 1e-5,
                            activ: str = "none", mean: Optional[torch.Tensor] = None,
                            rsig: Optional[torch.Tensor] = None):
    """K2's function in torch ops: (dx in x's dtype, dscale, dshift as (N, C)
    f32) for y = act(xhat * scale + shift); scale None is plain IN (s = 1).
    xhat from the given (N, C) mean and rsig (K2's case, the forward's
    statistics), or from x's own (`_bwd_kernel`'s) when they are None."""
    x32, y32 = x.float(), y.float()
    dyp = _gate(dy.float(), y32, activ)
    if mean is None:
        mean, rsig = instance_norm_stats_plain(x, eps)
    rsig = _col(rsig)
    xhat = (x32 - _col(mean)) * rsig
    s = 1.0 if scale is None else _col(scale)
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


def _rows_f32(t: torch.Tensor, x: torch.Tensor, count: int, what: str) -> torch.Tensor:
    """A per-row vector ((N, C) statistics, scale or shift; (N, C, 2) sums) as
    the `count` contiguous f32 values a kernel reads: as given when it
    already is that (the sharded path's case), else converted as `_vec` does
    (a bf16 AdaIN slice, a strided view, another device)."""
    if t.dtype is not torch.float32 or not t.is_contiguous() or t.get_device() != x.get_device():
        t = _vec(t, x)
    if t.numel() != count:
        raise ValueError(f"{what}: a per-row input must hold {count} values, "
                         f"got {tuple(t.shape)}")
    return t


def _affine_f32(scale, shift, x: torch.Tensor):
    """AdaIN's (N, C) scale and shift as K1 and K2 read them (`_rows_f32`),
    or (None, None) for IN."""
    if scale is None:
        return None, None
    rows = x.shape[0] * x.shape[1]
    return _rows_f32(scale, x, rows, "scale"), _rows_f32(shift, x, rows, "shift")


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


def _launch(x: torch.Tensor, scale, shift, eps: float, activ: str, stats: bool = False,
            plan=None):
    """K1 on a CUDA tensor: y, or (y, mean, rsig) with each row's f32
    statistics, (N, C), when `stats`; scale/shift None or contiguous f32
    (N, C) on x's device (`_affine_f32`). `plan`, a (ctas_per_row, vec,
    on_chip) to launch instead of `_fused_plan`'s, lets a check or a timing
    take either variant at one shape; the kernel refuses one it cannot run."""
    global launches
    rows, row_len = _rows(x)
    y = torch.empty_like(x)
    if rows == 0 or row_len == 0:
        return (y, *instance_norm_stats_plain(x, eps)) if stats else y
    mean = rsig = None
    if stats:
        n, c = x.shape[0], x.shape[1]  # ints: a torch.Size costs torch.empty more host time
        mean = torch.empty(n, c, dtype=torch.float32, device=x.device)
        rsig = torch.empty(n, c, dtype=torch.float32, device=x.device)
    px, py = x.data_ptr(), y.data_ptr()
    ctas, vec, on_chip = plan or _fused_plan(rows, row_len, x.element_size(), _align(px, py), 1)
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_fwd(
            px, _ptr(scale), _ptr(shift), py, _ptr(mean), _ptr(rsig), rows, row_len,
            _DTYPES[x.dtype], _FUSED_ACTS[activ], eps, ctas, vec, on_chip, _stream(x))
    _raise_on(lib, err, "instance_norm")
    launches += 1
    return (y, mean, rsig) if stats else y


def instance_norm_bwd(x: torch.Tensor, scale: Optional[torch.Tensor], y: torch.Tensor,
                      dy: torch.Tensor, mean: torch.Tensor, rsig: torch.Tensor,
                      activ: str = "none", plan=None):
    """K2 on CUDA tensors: (dx, dscale, dshift), the latter two (N, C) f32, or
    None when scale is None. x, y and dy: one NCHW-contiguous shape and dtype;
    mean and rsig: the (N, C) statistics K1 wrote for x; `plan` as `_launch`'s."""
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
    n, c = x.shape[0], x.shape[1]
    dx = torch.empty_like(x)
    if rows == 0 or row_len == 0:  # the sums of nothing
        ds = None if scale is None else torch.zeros(n, c, device=x.device)
        return dx, ds, None if ds is None else torch.zeros_like(ds)
    ds = db = None
    if scale is not None:  # every row is written
        scale = _rows_f32(scale, x, rows, "K2")
        ds = torch.empty(n, c, dtype=torch.float32, device=x.device)
        db = torch.empty(n, c, dtype=torch.float32, device=x.device)
    mean, rsig = _rows_f32(mean, x, rows, "K2"), _rows_f32(rsig, x, rows, "K2")
    px, py, pdy, pdx = x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr()
    ctas, vec, on_chip = plan or _fused_plan(rows, row_len, x.element_size(),
                                             _align(px, py, pdy, pdx), 3)
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_bwd(
            px, _ptr(scale), py, pdy, mean.data_ptr(), rsig.data_ptr(), pdx, _ptr(ds),
            _ptr(db), rows, row_len, _DTYPES[x.dtype], _FUSED_ACTS[activ], ctas, vec,
            on_chip, _stream(x))
    _raise_on(lib, err, "instance_norm backward")
    bwd_launches += 1
    return dx, ds, db


class _FusedInstanceNorm(torch.autograd.Function):
    """K1 forward, K2 backward (the `custom_vjp` `_fused_in`, `:161-179`); K1
    writes each row's (mean, rsig), saved for K2.

    The (N, C) scale/shift may arrive in any dtype and layout (the AdaIN
    vector is a bf16 slice of the MLP output); the kernels read them as
    contiguous f32, and their gradients go back in the dtype given."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps, activ):
        s32, b32 = _affine_f32(scale, shift, x)
        y, mean, rsig = _launch(x, s32, b32, eps, activ, stats=True)
        ctx.save_for_backward(x, s32, y, mean, rsig)
        ctx.activ = activ
        ctx.dtypes = (None if scale is None else scale.dtype,
                      None if shift is None else shift.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s32, y, mean, rsig = ctx.saved_tensors
        # autograd may hand over a non-contiguous or differently typed gradient
        dy = dy.to(x.dtype).contiguous()
        dx, ds, db = instance_norm_bwd(x, s32, y, dy, mean, rsig, ctx.activ)
        if ds is None:
            return dx, None, None, None, None
        return dx, ds.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None, None


# ----------------------------------------------------------------- split form
def row_moments_plain(x: torch.Tensor) -> torch.Tensor:
    """K1m's function: each (n, c) row's f32 (sum x, sum x^2), (N, C, 2)."""
    x32 = x.float()
    return torch.stack([x32.sum((2, 3)), (x32 * x32).sum((2, 3))], -1)


def _stats(moments: torch.Tensor, n: int, eps: float):
    """(mean, rsig) from the rows' (sum, sum of squares) over n elements, the
    variance clamped at 0 (`aclgan_tpu/parallel/halo.py:146-157`): K1a's
    prologue, here for its plain version."""
    mean = moments[..., 0] / n
    var = torch.clamp(moments[..., 1] / n - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def apply_plain(x: torch.Tensor, moments: torch.Tensor, n: int, eps: float,
                scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                activ: str = "none"):
    """K1a's function: (mean, rsig) from the rows' (N, C, 2) sums over their
    global length n (`_stats`), then y = act((x - mean) * rsig * scale +
    shift), cast to x's dtype before the activation, as
    `instance_norm_plain`. Returns (y, mean, rsig), the last two (N, C) f32."""
    mean, rsig = _stats(moments.float(), n, eps)
    y = (x.float() - _col(mean)) * _col(rsig)
    if scale is not None:
        y = y * _col(scale) + _col(shift)
    return apply_activation(y.to(x.dtype), activ), mean, rsig


def bwd_row_sums_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                       mean: torch.Tensor, rsig: torch.Tensor,
                       activ: str = "none") -> torch.Tensor:
    """K2m's function: each row's f32 (sum dyp, sum dyp * xhat), (N, C, 2),
    dyp = dy through the activation's gate, xhat from the given statistics."""
    dyp = _gate(dy.float(), y.float(), activ)
    xhat = (x.float() - _col(mean)) * _col(rsig)
    return torch.stack([dyp.sum((2, 3)), (dyp * xhat).sum((2, 3))], -1)


def bwd_apply_plain(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                    mean: torch.Tensor, rsig: torch.Tensor,
                    scale: Optional[torch.Tensor], sums: torch.Tensor, n: int,
                    activ: str = "none") -> torch.Tensor:
    """K2a's function: dx = rsig * s * (dyp - sum dyp / n - xhat * sum(dyp *
    xhat) / n), from the rows' sums over every rank and their global length
    n; in x's dtype."""
    dyp = _gate(dy.float(), y.float(), activ)
    xhat = (x.float() - _col(mean)) * _col(rsig)
    s = 1.0 if scale is None else _col(scale)
    dx = _col(rsig) * s * (dyp - _col(sums[..., 0]) / n - xhat * _col(sums[..., 1]) / n)
    return dx.to(x.dtype)


def _split_args(x: torch.Tensor, what: str, *tensors: torch.Tensor):
    """Rows and row length of a split kernel's launch on CUDA tensors;
    raises on any other device."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA or CPU tensor, got {x.device}")
    rows, row_len = _rows(x)
    for t in tensors:
        if t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous():
            raise ValueError(f"{what}: y and dy must be NCHW-contiguous {tuple(x.shape)} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    return rows, row_len


# The split kernels' launch plans (`csrc/instance_norm.cu`, above the kernels)
SPLIT_THREADS = 256      # a CTA's threads
SPLIT_SMS = 132          # an H100 SXM's SMs
SPLIT_WAVES = 4          # CTAs to aim for: this many times the SMs
SPLIT_MIN_LOADS = 4      # vector loads a thread gets at least, once a row is split
SPLIT_MAX_CLUSTER = 8    # the portable cluster size


def _load_width(row_len: int, elem_bytes: int, ptr_align: int) -> int:
    """vec, the elements a load: the widest power of two within 16 bytes
    that divides both the base alignment `ptr_align` and the row length, so
    that every row starts on a whole load (1 where neither allows 2)."""
    vec = 16 // elem_bytes
    while vec > 1 and (ptr_align % (vec * elem_bytes) or row_len % vec):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=None)
def _split_plan(rows: int, row_len: int, elem_bytes: int, ptr_align: int):
    """(ctas_per_row, vec) for K1m / K2m over `rows` rows of `row_len`
    elements of `elem_bytes` bytes, at base pointers aligned to `ptr_align`
    bytes; vec from `_load_width`. ctas_per_row doubles from 1 up to 8 while
    rows x CTAs stays below SPLIT_WAVES x the SMs and the halved chunk still
    gives each thread SPLIT_MIN_LOADS loads."""
    vec = _load_width(row_len, elem_bytes, ptr_align)
    ctas = 1
    while (ctas < SPLIT_MAX_CLUSTER and rows * ctas < SPLIT_WAVES * SPLIT_SMS
           and row_len // (2 * ctas) >= SPLIT_THREADS * vec * SPLIT_MIN_LOADS):
        ctas *= 2
    return ctas, vec


@functools.lru_cache(maxsize=None)
def _apply_plan(rows: int, row_len: int, elem_bytes: int, ptr_align: int):
    """(chunks_per_row, vec) for K1a / K2a, vec as `_split_plan`'s. Their
    CTAs reduce nothing together, so a row takes any number of chunks (no
    cluster): as many as bring rows x chunks up to SPLIT_WAVES x the SMs
    (rounded down), as long as each thread keeps SPLIT_MIN_LOADS loads, and
    at least 1. A rank's (2, 64, 256, 512) layer gets 4 chunks a row, its
    rows of 8,192 elements 1."""
    vec = _load_width(row_len, elem_bytes, ptr_align)
    most = row_len // vec // (SPLIT_THREADS * SPLIT_MIN_LOADS)
    return max(1, min(SPLIT_WAVES * SPLIT_SMS // rows, most)), vec


def _fused_elems(elem_bytes: int, inputs: int) -> int:
    """Elements of each input a thread of K1 (`inputs` 1: x) or K2 (3: x, y,
    dy) holds on chip (`row_elems` in `csrc/instance_norm.cu`, which says
    why): 32 in bf16; in f32, 64 for K1 and 16 for K2."""
    return 32 if elem_bytes == 2 else (64 if inputs == 1 else 16)


@functools.lru_cache(maxsize=None)
def _fused_plan(rows: int, row_len: int, elem_bytes: int, ptr_align: int, inputs: int):
    """(ctas_per_row, vec, on_chip) for K1 (`inputs` 1) or K2 (3) over `rows`
    rows of `row_len` elements of `elem_bytes` bytes, at base pointers
    aligned to `ptr_align` bytes; vec from `_load_width`. On chip: the fewest
    CTAs of 1, 2, 4, 8 (a cluster above 1) whose whole-vector chunks
    (`_chunk_bounds`) leave each thread at most `_fused_elems` elements of
    each input. A row that 8 CTAs cannot hold (over 65,536 elements in
    bf16; in f32, over 131,072 for K1 and 32,768 for K2) takes the streaming
    variant, (1, vec, False)."""
    vec = _load_width(row_len, elem_bytes, ptr_align)
    per_cta = SPLIT_THREADS * (_fused_elems(elem_bytes, inputs) // vec)  # vectors
    n_vec = row_len // vec
    ctas = 1
    while ctas <= SPLIT_MAX_CLUSTER:
        if -(-n_vec // ctas) <= per_cta and rows * ctas <= 2**31 - 1:
            return ctas, vec, True
        ctas *= 2
    return 1, vec, False


def _chunk_bounds(row_len: int, ctas: int, vec: int):
    """The [lo, hi) element ranges of a row that its `ctas` CTAs take (a
    cluster's for K1m / K2m, the chunks for K1a / K2a), in order: runs of
    ceil(n_vec / ctas) whole vectors, the last CTA also taking the
    row_len % vec elements past the last vector (`chunk_bounds` in
    `csrc/instance_norm.cu`)."""
    n_vec = row_len // vec
    per = -(-n_vec // ctas)
    bounds = []
    for rank in range(ctas):
        lo = min(rank * per, n_vec)
        hi = min(lo + per, n_vec)
        bounds.append((lo * vec, row_len if rank == ctas - 1 else hi * vec))
    return bounds


def _align(*ptrs: int) -> int:
    """The largest power of two, at most 16, dividing every address."""
    addr = 16
    for p in ptrs:
        addr |= p
    return addr & -addr


# the raw handle of the current stream without a `torch.cuda.Stream` object,
# where this build of PyTorch has it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as the kernels take it."""
    if _raw_stream is not None:
        return _raw_stream(x.get_device())
    return torch.cuda.current_stream(x.device).cuda_stream


def instance_norm_row_moments(x: torch.Tensor) -> torch.Tensor:
    """K1m on a CUDA tensor (the plain version on a CPU one): (N, C, 2) f32."""
    global moments_launches
    if x.is_cpu:
        return row_moments_plain(x)
    rows, row_len = _split_args(x, "K1m")
    n, c = x.shape[:2]
    if rows == 0 or row_len == 0:  # the sums of nothing
        return torch.zeros((n, c, 2), device=x.device, dtype=torch.float32)
    out = torch.empty((n, c, 2), device=x.device, dtype=torch.float32)
    px = x.data_ptr()
    ctas, vec = _split_plan(rows, row_len, x.element_size(), _align(px))
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_row_moments(
            px, out.data_ptr(), rows, row_len, _DTYPES[x.dtype], ctas, vec, _stream(x))
    _raise_on(lib, err, "instance_norm row moments")
    moments_launches += 1
    return out


def instance_norm_apply(x: torch.Tensor, moments: torch.Tensor, n: int, eps: float,
                        scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                        activ: str = "none"):
    """K1a on a CUDA tensor (the plain version on a CPU one): (y, mean, rsig)
    from x, the rows' all-reduced (N, C, 2) sums `moments` over their global
    length n, and scale and shift (N, C) or None; mean and rsig (N, C) f32."""
    global apply_launches
    if x.is_cpu:
        return apply_plain(x, moments, n, eps, scale, shift, activ)
    rows, row_len = _split_args(x, "K1a")
    n_, c = x.shape[0], x.shape[1]  # ints: a torch.Size costs torch.empty more host time
    y = torch.empty_like(x)
    mean = torch.empty(n_, c, dtype=torch.float32, device=x.device)
    rsig = torch.empty(n_, c, dtype=torch.float32, device=x.device)
    if rows == 0:
        return y, mean, rsig
    moments = _rows_f32(moments, x, 2 * rows, "K1a")
    if scale is not None:
        scale, shift = _rows_f32(scale, x, rows, "K1a"), _rows_f32(shift, x, rows, "K1a")
    px, py = x.data_ptr(), y.data_ptr()
    chunks, vec = _apply_plan(rows, row_len, x.element_size(), _align(px, py))
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_apply(
            px, moments.data_ptr(), _ptr(scale), _ptr(shift), py, mean.data_ptr(),
            rsig.data_ptr(), rows, row_len, n, eps, _DTYPES[x.dtype], _FUSED_ACTS[activ],
            chunks, vec, _stream(x))
    _raise_on(lib, err, "instance_norm apply")
    apply_launches += 1
    return y, mean, rsig


def instance_norm_bwd_row_sums(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                               mean: torch.Tensor, rsig: torch.Tensor,
                               activ: str = "none") -> torch.Tensor:
    """K2m on CUDA tensors (the plain version on CPU ones): (N, C, 2) f32."""
    global bwd_sums_launches
    if x.is_cpu:
        return bwd_row_sums_plain(x, y, dy, mean, rsig, activ)
    rows, row_len = _split_args(x, "K2m", y, dy)
    n, c = x.shape[:2]
    if rows == 0 or row_len == 0:  # the sums of nothing
        return torch.zeros((n, c, 2), device=x.device, dtype=torch.float32)
    out = torch.empty((n, c, 2), device=x.device, dtype=torch.float32)
    mean, rsig = _rows_f32(mean, x, rows, "K2m"), _rows_f32(rsig, x, rows, "K2m")
    px, py, pdy = x.data_ptr(), y.data_ptr(), dy.data_ptr()
    ctas, vec = _split_plan(rows, row_len, x.element_size(), _align(px, py, pdy))
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_bwd_row_sums(
            px, py, pdy, mean.data_ptr(), rsig.data_ptr(), out.data_ptr(), rows, row_len,
            _DTYPES[x.dtype], _FUSED_ACTS[activ], ctas, vec, _stream(x))
    _raise_on(lib, err, "instance_norm backward row sums")
    bwd_sums_launches += 1
    return out


def instance_norm_bwd_apply(x: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                            mean: torch.Tensor, rsig: torch.Tensor,
                            scale: Optional[torch.Tensor], sums: torch.Tensor, n: int,
                            activ: str = "none") -> torch.Tensor:
    """K2a on CUDA tensors (the plain version on CPU ones): dx in x's dtype;
    sums (N, C, 2) over every rank, n the rows' global length."""
    global bwd_apply_launches
    if x.is_cpu:
        return bwd_apply_plain(x, y, dy, mean, rsig, scale, sums, n, activ)
    rows, row_len = _split_args(x, "K2a", y, dy)
    dx = torch.empty_like(x)
    if rows == 0 or row_len == 0:
        return dx
    mean, rsig = _rows_f32(mean, x, rows, "K2a"), _rows_f32(rsig, x, rows, "K2a")
    sums = _rows_f32(sums, x, 2 * rows, "K2a")
    if scale is not None:
        scale = _rows_f32(scale, x, rows, "K2a")
    px, py, pdy, pdx = x.data_ptr(), y.data_ptr(), dy.data_ptr(), dx.data_ptr()
    chunks, vec = _apply_plan(rows, row_len, x.element_size(), _align(px, py, pdy, pdx))
    lib = _library()
    with _launch_device(x):
        err = lib.aclgan_instance_norm_bwd_apply(
            px, py, pdy, mean.data_ptr(), rsig.data_ptr(), _ptr(scale), sums.data_ptr(), pdx,
            rows, row_len, 1.0 / n, _DTYPES[x.dtype], _FUSED_ACTS[activ], chunks, vec,
            _stream(x))
    _raise_on(lib, err, "instance_norm backward apply")
    bwd_apply_launches += 1
    return dx


class _ShardedFusedInstanceNorm(torch.autograd.Function):
    """IN / AdaIN + activation over rows split across the ranks of `group`
    (each rank holding row_len of the n_spatial * row_len elements of every
    row): K1m -> all-reduce -> K1a forward (no torch op between the last two:
    K1a computes the statistics and hands them to the backward), K2m ->
    all-reduce -> K2a backward. dscale and dshift are this rank's partial
    sums: the AdaIN vector is replicated over the group, and its producer's
    gradients are summed over the ranks afterwards, so all-reduced values
    here would count them n_spatial times."""

    @staticmethod
    def forward(ctx, x, scale, shift, eps, activ, group, n_spatial):
        s32, b32 = _vec(scale, x), _vec(shift, x)
        n = x.shape[2] * x.shape[3] * n_spatial
        moments = instance_norm_row_moments(x)
        dist.all_reduce(moments, group=group)
        y, mean, rsig = instance_norm_apply(x, moments, n, eps, s32, b32, activ)
        ctx.save_for_backward(x, s32, mean, rsig, y)
        ctx.activ, ctx.group, ctx.n = activ, group, n
        ctx.dtypes = (None if scale is None else scale.dtype,
                      None if shift is None else shift.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s32, mean, rsig, y = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        partial = instance_norm_bwd_row_sums(x, y, dy, mean, rsig, ctx.activ)
        sums = partial.clone()
        dist.all_reduce(sums, group=ctx.group)
        dx = instance_norm_bwd_apply(x, y, dy, mean, rsig, s32, sums, ctx.n, ctx.activ)
        if s32 is None:
            return dx, None, None, None, None, None, None
        return (dx, partial[..., 1].to(ctx.dtypes[0]), partial[..., 0].to(ctx.dtypes[1]),
                None, None, None, None)


_cdll: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """The kernels' library, its functions' ctypes signatures set once, when
    `build.load` first returns it."""
    global _cdll
    if _cdll is None:
        from aclgan_tpu_torch.ops.kernels import build

        _cdll = _configure(build.load(SOURCE))
    return _cdll


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    rows = [ctypes.c_longlong, ctypes.c_longlong]
    for name, argtypes in (
            ("fwd", [ctypes.c_void_p] * 6 + rows + [ctypes.c_int] * 2 + [ctypes.c_float]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
            ("bwd", [ctypes.c_void_p] * 9 + rows + [ctypes.c_int] * 5 + [ctypes.c_void_p]),
            ("row_moments", [ctypes.c_void_p] * 2 + rows + [ctypes.c_int] * 3
             + [ctypes.c_void_p]),
            ("apply", [ctypes.c_void_p] * 7 + rows + [ctypes.c_longlong, ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
            ("bwd_row_sums",
             [ctypes.c_void_p] * 6 + rows + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
            ("bwd_apply", [ctypes.c_void_p] * 8 + rows + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])):
        fn = getattr(lib, f"aclgan_instance_norm_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.aclgan_cuda_error_string.argtypes = [ctypes.c_int]
    lib.aclgan_cuda_error_string.restype = ctypes.c_char_p
    return lib


def fused_instance_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None, eps: float = 1e-5,
                        activ: str = "none", prelu_alpha: Optional[torch.Tensor] = None,
                        mesh=None) -> torch.Tensor:
    """IN (scale/shift None) or AdaIN, then activation. x: (N, C, H, W);
    scale/shift: (N, C). Without a gradient, the `aclgan::instance_norm_fwd`
    op: K1 on a CUDA tensor, the plain version on a CPU one. With one, the
    plain version on the CPU and K1 + K2 (`_FusedInstanceNorm`) on CUDA.
    Under a `mesh` that splits H, the split form (`_ShardedFusedInstanceNorm`)
    with or without a gradient. prelu/selu are applied after the op or
    kernel in torch."""
    _check(x, scale, shift, activ)
    act = activ if activ in _FUSED_ACTS else "none"
    if sharded(mesh):
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"no kernel for device {x.device}")
        y = _ShardedFusedInstanceNorm.apply(x, scale, shift, eps, act, mesh.spatial_group,
                                            mesh.n_spatial)
    elif torch.is_grad_enabled() and any(
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
    return _launch(x, *_affine_f32(scale, shift, x), eps, _ACT_NAMES[activ])


def _op_cpu(x, scale, shift, eps, activ):
    return instance_norm_plain(x, scale, shift, eps, _ACT_NAMES[activ])


def _op_fake(x, scale, shift, eps, activ):
    return torch.empty_like(x)


_LIB.impl("instance_norm_fwd", _op_cuda, "CUDA")
_LIB.impl("instance_norm_fwd", _op_cpu, "CPU")
torch.library.register_fake("aclgan::instance_norm_fwd", _op_fake, lib=_LIB)
