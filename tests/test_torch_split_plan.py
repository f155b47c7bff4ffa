"""The split kernels' launch plans: K1m's and K2m's (`_split_plan`: CTAs a
row and elements a load), the chunks it gives each CTA of a cluster and the
reduction order it implies against the plain versions; K1a's and K2a's
(`_apply_plan`: chunks a row and elements a load), the chunks covering each
row once and the C entry points' refusal of a plan they cannot run; K1's
and K2's (`_fused_plan`: CTAs a row, elements a load, on chip or streaming)
on the model's rows, the chunks covering each row once within the threads'
registers, and their entry points' refusal of a bad plan; the kernels'
ctypes signatures set once. All on the CPU; the kernels themselves
run in `tests/test_torch_cuda.py`, and the plain versions are held to the JAX
package in `tests/test_torch_halo.py`."""

import ctypes
import re

import numpy as np
import pytest
import torch

from aclgan_tpu_torch.ops.kernels import build
from aclgan_tpu_torch.ops.kernels import instance_norm as K

# The IN / AdaIN layers of one rank of chip_smoke.py phase 27 (male2female at
# 512^2, global batch 2 on a 1 x 2 grid, 256 x 512 rows a rank): the content
# encoder at batch 2 and 4, the decoder's AdaIN at batch 2, 4 and 6.
PHASE27_SHAPES = [(n, 64, 256, 512) for n in (2, 4)] + \
    [(n, 128, 128, 256) for n in (2, 4)] + [(n, 256, 64, 128) for n in (2, 4, 6)]
ELEM_BYTES = {"float32": 4, "bfloat16": 2}
ACTIVS = ("none", "relu", "lrelu", "tanh")


@pytest.mark.parametrize("dtype", sorted(ELEM_BYTES))
@pytest.mark.parametrize("shape", PHASE27_SHAPES)
def test_plan_on_phase27_shapes(shape, dtype):
    """16-byte loads on every aligned layer; a row split over 2-8 CTAs only
    while the card is short of CTAs and each thread keeps its loads."""
    n, c, h, w = shape
    rows, row_len, elem = n * c, h * w, ELEM_BYTES[dtype]
    ctas, vec = K._split_plan(rows, row_len, elem, 16)
    assert vec * elem == 16
    assert ctas in (1, 2, 4, 8)
    target = K.SPLIT_WAVES * K.SPLIT_SMS
    if ctas > 1:  # split only as far as it pays
        assert rows * ctas // 2 < target
        assert row_len // ctas >= K.SPLIT_THREADS * vec * K.SPLIT_MIN_LOADS
    if ctas < 8:  # and no further than that
        assert (rows * ctas >= target
                or row_len // (2 * ctas) < K.SPLIT_THREADS * vec * K.SPLIT_MIN_LOADS)


@pytest.mark.parametrize("rows,row_len,elem,want", [
    (128, 131072, 2, 8),   # a rank's 64 x 256 x 512 layer at batch 2
    (256, 131072, 2, 4),   # at batch 4
    (256, 32768, 2, 4),
    (512, 32768, 2, 2),
    (512, 8192, 2, 1),     # the 64 x 128 rows: one CTA a row
    (1536, 8192, 2, 1),
    (128, 131072, 4, 8),
    (4, 262144, 2, 8),     # the long-row check's (1, 4, 512, 512)
    (16, 262144, 4, 8),
    (8, 4096, 2, 1),       # few rows, too short to split
])
def test_plan_picks_these_clusters(rows, row_len, elem, want):
    assert K._split_plan(rows, row_len, elem, 16)[0] == want


NARROWED = [
    (63, 2, 16, 1),        # a ragged 7 x 9 row: odd, so one element a load
    (63, 4, 16, 1),
    (62, 2, 16, 2),
    (60, 2, 16, 4),
    (60, 4, 16, 4),
    (256, 2, 2, 1),        # a bf16 base at storage offset 1
    (256, 4, 4, 1),        # an f32 base at storage offset 1
    (256, 2, 4, 2),
    (256, 2, 8, 4),
    (256, 4, 8, 2),
    (256, 2, 16, 8),
    (256, 4, 16, 4),
]


@pytest.mark.parametrize("row_len,elem,align,want_vec", NARROWED)
def test_plan_narrows_the_load(row_len, elem, align, want_vec):
    """The widest load within 16 bytes that divides the base alignment and
    the row length, so every row starts on a whole load."""
    ctas, vec = K._split_plan(6, row_len, elem, align)
    assert vec == want_vec
    assert vec * elem <= 16 and align % (vec * elem) == 0 and row_len % vec == 0
    assert ctas in (1, 2, 4, 8)


@pytest.mark.parametrize("offset,want", [(0, 16), (1, 2), (2, 4), (4, 8), (8, 16)])
def test_align_of_a_slice(offset, want):
    base = torch.empty(64, dtype=torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    x = base[offset:offset + 32].view(2, 16)
    assert K._align(x.data_ptr()) == want
    assert K._align(x.data_ptr(), base.data_ptr()) == want


@pytest.mark.parametrize("ctas", [1, 2, 4, 8])
@pytest.mark.parametrize("row_len,vec", [(131072, 8), (8192, 8), (63, 1), (62, 2), (7, 4),
                                         (5, 1), (1, 1), (12, 8), (1000, 4)])
def test_chunk_bounds_partition_the_row(row_len, vec, ctas):
    """The CTAs' chunks cover [0, row_len) in rank order with no gap and no
    overlap, each starting on a whole vector."""
    bounds = K._chunk_bounds(row_len, ctas, vec)
    assert len(bounds) == ctas
    assert bounds[0][0] == 0 and bounds[-1][1] == row_len
    for (lo, hi), (nxt, _) in zip(bounds, bounds[1:]):
        assert lo <= hi == nxt
    for lo, hi in bounds:
        assert lo % vec == 0 and lo <= hi


def _planned(fn, x, *tensors):
    """Each row's sums in the order the planned launch takes them: every CTA
    reduces its chunk in f32, and the chunks' sums are added in rank order
    starting from rank 0's. fn maps the chunks' slices to their (N, C, 2)
    sums."""
    n, c, h, w = x.shape
    rows, row_len = n * c, h * w
    ctas, vec = K._split_plan(rows, row_len, x.element_size(), 16)
    flat = [t.reshape(n, c, 1, row_len) for t in (x,) + tensors]
    total = None
    for lo, hi in K._chunk_bounds(row_len, ctas, vec):
        part = fn(*(t[..., lo:hi] for t in flat))
        total = part if total is None else total + part
    return total, ctas


# the phase-27 row lengths with few rows (so a row is split), a ragged row
_ORDER_SHAPES = [(1, 2, 256, 512), (1, 4, 128, 256), (2, 3, 64, 128), (2, 3, 7, 9),
                 (1, 2, 512, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _ORDER_SHAPES)
def test_planned_order_matches_row_moments_plain(shape, dtype):
    """K1m's chunked, rank-ordered sums against `row_moments_plain`, within
    f32 rounding: 1e-5 of each row's sum of |terms| (131,072-262,144 terms
    summed in two orders; f32's unit round-off is 6e-8)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + 0.5).to(dtype)
    got, ctas = _planned(K.row_moments_plain, x)
    want = K.row_moments_plain(x)
    x32 = x.float()
    scale = torch.stack([x32.abs().sum((2, 3)), (x32 * x32).sum((2, 3))], -1)
    assert torch.all((got - want).abs() <= 1e-5 * scale + 1e-30)
    if shape[2] * shape[3] >= 32768:
        assert ctas > 1  # the order under test is a cluster's


@pytest.mark.parametrize("activ", ACTIVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _ORDER_SHAPES)
def test_planned_order_matches_bwd_row_sums_plain(shape, dtype, activ):
    """K2m's chunked, rank-ordered sums against `bwd_row_sums_plain`, with
    the tolerance of the K1m case on each row's sum of |terms|."""
    rng = np.random.RandomState(1)
    n, c, h, w = shape
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32) * 2 + 0.5).to(dtype)
    dy = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
    y, mean, rsig = K.apply_plain(x, K.row_moments_plain(x), h * w, 1e-5, None, None, activ)
    got, _ = _planned(lambda a, b, d: K.bwd_row_sums_plain(a, b, d, mean, rsig, activ),
                      x, y, dy)
    want = K.bwd_row_sums_plain(x, y, dy, mean, rsig, activ)
    dyp = K._gate(dy.float(), y.float(), activ).abs()
    xhat = ((x.float() - mean[..., None, None]) * rsig[..., None, None]).abs()
    scale = torch.stack([dyp.sum((2, 3)), (dyp * xhat).sum((2, 3))], -1)
    assert torch.all((got - want).abs() <= 1e-5 * scale + 1e-30)


class _StubFn:
    """A ctypes function that counts the assignments of its signature."""

    def __init__(self):
        self.sets = 0
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.sets += 1
        self._argtypes = value


class _StubLib:
    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("aclgan_"):
            return self.fns.setdefault(name, _StubFn())
        raise AttributeError(name)


def test_library_sets_ctypes_signatures_once(monkeypatch):
    loads = []

    def load(source):
        loads.append(source)
        return _StubLib()

    monkeypatch.setattr(build, "load", load)
    monkeypatch.setattr(K, "_cdll", None)
    libs = {id(K._library()) for _ in range(100)}
    assert len(libs) == 1 and loads == [K.SOURCE]
    fns = K._library().fns
    assert set(fns) == {"aclgan_instance_norm_fwd", "aclgan_instance_norm_bwd",
                        "aclgan_instance_norm_row_moments", "aclgan_instance_norm_apply",
                        "aclgan_instance_norm_bwd_row_sums", "aclgan_instance_norm_bwd_apply",
                        "aclgan_cuda_error_string"}
    assert all(f.sets == 1 for f in fns.values())
    # K1m and K2m take the plan: (ctas_per_row, vec) before the stream
    assert fns["aclgan_instance_norm_row_moments"].argtypes[-4:] == \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert fns["aclgan_instance_norm_bwd_row_sums"].argtypes[-5:] == \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    # K1a takes n and eps, then (dtype, act, chunks_per_row, vec) before the
    # stream; K2a inv_n and the same four
    assert fns["aclgan_instance_norm_apply"].argtypes[-7:] == \
        [ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    assert fns["aclgan_instance_norm_bwd_apply"].argtypes[-6:] == \
        [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    # K1: six pointers (x, scale, shift, y, mean, rsig), rows, row_len, dtype,
    # act, eps, then the plan (ctas_per_row, vec, on_chip) before the stream;
    # K2: nine pointers (x, scale, y, dy, mean, rsig, dx, dscale, dshift), no eps
    rows = [ctypes.c_longlong] * 2
    assert fns["aclgan_instance_norm_fwd"].argtypes == \
        [ctypes.c_void_p] * 6 + rows + [ctypes.c_int] * 2 + [ctypes.c_float] \
        + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert fns["aclgan_instance_norm_bwd"].argtypes == \
        [ctypes.c_void_p] * 9 + rows + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def test_split_wrappers_take_the_plain_version_on_the_cpu():
    """On a CPU tensor K1m and K2m are their plain versions, launch nothing and
    load no library."""
    x = torch.randn(2, 3, 7, 9)
    dy = torch.randn(2, 3, 7, 9)
    mean, rsig = K._stats(K.row_moments_plain(x), 63, 1e-5)
    before = (K.moments_launches, K.bwd_sums_launches)
    torch.testing.assert_close(K.instance_norm_row_moments(x), K.row_moments_plain(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(K.instance_norm_bwd_row_sums(x, x, dy, mean, rsig, "relu"),
                               K.bwd_row_sums_plain(x, x, dy, mean, rsig, "relu"),
                               rtol=0, atol=0)
    assert (K.moments_launches, K.bwd_sums_launches) == before


# ------------------------------------------------------------- K1a and K2a
@pytest.mark.parametrize("dtype", sorted(ELEM_BYTES))
@pytest.mark.parametrize("shape", PHASE27_SHAPES)
def test_apply_plan_on_phase27_shapes(shape, dtype):
    """16-byte loads on every aligned layer; a row cut into chunks only while
    the card is short of CTAs and each thread keeps its loads, and no further."""
    n, c, h, w = shape
    rows, row_len, elem = n * c, h * w, ELEM_BYTES[dtype]
    chunks, vec = K._apply_plan(rows, row_len, elem, 16)
    assert vec * elem == 16
    target = K.SPLIT_WAVES * K.SPLIT_SMS
    least = K.SPLIT_THREADS * K.SPLIT_MIN_LOADS  # vectors a chunk holds at least
    if chunks > 1:
        assert rows * chunks <= target and row_len // vec // chunks >= least
    assert rows * (chunks + 1) > target or row_len // vec // (chunks + 1) < least


@pytest.mark.parametrize("rows,row_len,elem,want", [
    (128, 131072, 2, 4),   # a rank's 64 x 256 x 512 layer at batch 2
    (256, 131072, 2, 2),   # at batch 4
    (256, 32768, 2, 2),
    (512, 32768, 2, 1),
    (512, 8192, 2, 1),     # the 64 x 128 rows: one CTA a row
    (1536, 8192, 2, 1),
    (128, 131072, 4, 4),
    (4, 262144, 2, 32),    # the long-row check's (1, 4, 512, 512): each thread's loads cap it
    (16, 262144, 4, 33),   # 16 rows: the CTA target caps it
    (8, 4096, 2, 1),       # few rows, too short to cut
    (6, 63, 2, 1),         # a ragged 7 x 9 row
    (6, 1, 2, 1),          # rows of one element
    (6, 0, 2, 1),          # empty rows: chunk 0 still writes the statistics
])
def test_apply_plan_picks_these_chunks(rows, row_len, elem, want):
    assert K._apply_plan(rows, row_len, elem, 16)[0] == want


@pytest.mark.parametrize("row_len,elem,align,want_vec", NARROWED)
def test_apply_plan_narrows_the_load(row_len, elem, align, want_vec):
    """K1a's and K2a's load is `_split_plan`'s: the widest within 16 bytes
    that divides every base's alignment and the row length."""
    chunks, vec = K._apply_plan(6, row_len, elem, align)
    assert vec == want_vec == K._split_plan(6, row_len, elem, align)[1]
    assert chunks >= 1


# (rows, row_len, element bytes, base alignment): phase-27 rows, a ragged row
# alone and over many chunks, rows of one element, bases off 16 bytes
_COVER = [(128, 131072, 2, 16), (256, 32768, 4, 16), (512, 8192, 2, 16), (6, 63, 2, 16),
          (4, 262143, 2, 16), (4, 262144, 2, 16), (4, 262144, 2, 2), (16, 262144, 4, 8),
          (6, 1, 4, 16), (3, 4100, 2, 4)]


@pytest.mark.parametrize("rows,row_len,elem,align", _COVER)
def test_apply_chunks_cover_each_row_once(rows, row_len, elem, align):
    """The chunks of a planned row cover each element exactly once, in order,
    each chunk starting on a whole vector and the last one ending the row
    (the row_len % vec tail included)."""
    chunks, vec = K._apply_plan(rows, row_len, elem, align)
    bounds = K._chunk_bounds(row_len, chunks, vec)
    assert len(bounds) == chunks
    hits = np.zeros(row_len, np.int64)
    for lo, hi in bounds:
        assert lo % vec == 0 and lo <= hi
        hits[lo:hi] += 1
    assert np.all(hits == 1)
    assert bounds[-1][1] == row_len
    if row_len >= 2 * K.SPLIT_THREADS * vec * K.SPLIT_MIN_LOADS and rows < 64:
        assert chunks > 1  # these rows are cut


def _cu_body(src: str, signature: str) -> str:
    """The body of the C++ function whose definition starts with `signature`."""
    start = src.index("{", src.index(signature))
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start + 1:i]
    raise AssertionError(f"unbalanced braces after {signature}")


def test_apply_entry_points_refuse_a_bad_plan_before_launching():
    """The `.cu` contract: K1a's and K2a's entry points check the plan with
    `apply_plan_ok` before anything else and return cudaErrorInvalidValue
    without launching when it fails; the check refuses fewer than one chunk,
    more than 2^31 - 1 CTAs, a load wider than 16 bytes or not a power of
    two, a row length it does not divide and a base off its width. Every
    plan `_apply_plan` makes passes that check."""
    src = (build.CSRC / K.SOURCE).read_text()
    load_ok = _cu_body(src, "bool load_ok(")
    for clause in ("vec < 1", "vec & (vec - 1)", "vec * sizeof(T) > 16", "row_len % vec",
                   "% (vec * sizeof(T))"):
        assert clause in load_ok, clause
    plan_ok = _cu_body(src, "bool apply_plan_ok(")
    for clause in ("chunks >= 1", "rows * chunks <= INT_MAX", "load_ok<T>(bases, row_len, vec)"):
        assert clause in plan_ok, clause
    for name, bases in (("int run_apply(", "{x, y}"), ("int run_bwd_apply(", "{x, y, dy, dx}")):
        body = _cu_body(src, name).strip()
        assert re.match(r"if \(!apply_plan_ok<T>\(" + re.escape(bases)
                        + r", rows, row_len, chunks, vec\)\)\s*return static_cast<int>"
                        r"\(cudaErrorInvalidValue\);", body), name
        # the one launch (a macro over vec 1, 2, 4, 8) comes after the check
        assert body.count("launch_apply(") == 1
        assert body.index("launch_apply(") > body.index("cudaErrorInvalidValue")
    for entry, impl in (("aclgan_instance_norm_apply(", "run_apply<"),
                        ("aclgan_instance_norm_bwd_apply(", "run_bwd_apply<")):
        body = _cu_body(src, 'extern "C" int ' + entry)
        assert "<<<" not in body and "launch_apply" not in body and impl in body

    def contract(rows, row_len, elem, align, chunks, vec):  # apply_plan_ok, restated
        return (chunks >= 1 and rows * chunks <= 2**31 - 1 and vec >= 1
                and vec & (vec - 1) == 0 and vec * elem <= 16 and row_len % vec == 0
                and align % (vec * elem) == 0)

    for rows, row_len, elem, align in _COVER + [(n * c, h * w, e, 16)
                                                for n, c, h, w in PHASE27_SHAPES
                                                for e in (2, 4)]:
        assert contract(rows, row_len, elem, align, *K._apply_plan(rows, row_len, elem, align))
    for bad in ((6, 256, 2, 16, 0, 8), (6, 256, 2, 16, 1, 16), (6, 256, 2, 16, 1, 3),
                (6, 256, 2, 2, 1, 8), (6, 63, 2, 16, 1, 2), (2**30, 256, 2, 16, 2, 8)):
        assert not contract(*bad), bad


def test_apply_wrappers_take_the_plain_version_on_the_cpu():
    """On CPU tensors K1a and K2a are their plain versions, launch nothing and
    load no library; K1a's statistics are `_stats`'s to the bit."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy((rng.randn(2, 3, 7, 9) * 2 + 0.5).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 3, 7, 9).astype(np.float32))
    scale, shift = (torch.from_numpy(rng.randn(2, 3).astype(np.float32)) for _ in range(2))
    moments = K.row_moments_plain(x)
    before = (K.apply_launches, K.bwd_apply_launches)
    y, mean, rsig = K.instance_norm_apply(x, moments, 63, 1e-5, scale, shift, "lrelu")
    want = K.apply_plain(x, moments, 63, 1e-5, scale, shift, "lrelu")
    for got, w in zip((y, mean, rsig), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    want_mean, want_rsig = K._stats(moments, 63, 1e-5)
    assert torch.equal(mean, want_mean) and torch.equal(rsig, want_rsig)
    assert mean.shape == rsig.shape == (2, 3) and mean.dtype == torch.float32
    sums = K.bwd_row_sums_plain(x, y, dy, mean, rsig, "lrelu")
    torch.testing.assert_close(
        K.instance_norm_bwd_apply(x, y, dy, mean, rsig, scale, sums, 63, "lrelu"),
        K.bwd_apply_plain(x, y, dy, mean, rsig, scale, sums, 63, "lrelu"), rtol=0, atol=0)
    assert (K.apply_launches, K.bwd_apply_launches) == before


# ------------------------------------------------------------- K1 and K2
# The IN / AdaIN layers of the 256^2 model (male2female) at the training and
# serving batches of chip_smoke.py (16, 32, 48), and phase 7's f32 check at
# 128^2, batch 2
MAIN_SHAPES = [(n, c, s, s) for n in (16, 32, 48) for c, s in ((64, 256), (128, 128), (256, 64))]
F32_CHECK_SHAPES = [(2, 64, 128, 128), (2, 128, 64, 64), (2, 256, 32, 32)]
KERNEL_INPUTS = {"K1": 1, "K2": 3}


@pytest.mark.parametrize("kernel", sorted(KERNEL_INPUTS))
@pytest.mark.parametrize("shape", MAIN_SHAPES)
def test_fused_plan_holds_every_main_path_row_on_chip_in_bf16(shape, kernel):
    """Every bf16 row of the 256^2 model goes on chip for K1 and K2, with
    16-byte loads, on the fewest CTAs that hold it: 8 for 256^2, 2 for 128^2,
    1 for 64^2. In f32, K1's rows go on chip as well (64 elements a thread:
    4 CTAs for 256^2, one for 128^2); K2's 256^2 rows stream."""
    n, c, h, w = shape
    ctas, vec, on_chip = K._fused_plan(n * c, h * w, 2, 16, KERNEL_INPUTS[kernel])
    assert on_chip and vec == 8 and ctas == {65536: 8, 16384: 2, 4096: 1}[h * w]
    ctas, vec, on_chip = K._fused_plan(n * c, h * w, 4, 16, KERNEL_INPUTS[kernel])
    assert vec == 4
    if kernel == "K1":
        assert on_chip and ctas == {65536: 4, 16384: 1, 4096: 1}[h * w]
    elif h * w <= 32768:
        assert on_chip and ctas == {16384: 4, 4096: 1}[h * w]
    else:
        assert (ctas, on_chip) == (1, False)


@pytest.mark.parametrize("kernel", sorted(KERNEL_INPUTS))
@pytest.mark.parametrize("shape", F32_CHECK_SHAPES)
def test_fused_plan_holds_the_f32_check_rows_on_chip(shape, kernel):
    n, c, h, w = shape
    ctas, vec, on_chip = K._fused_plan(n * c, h * w, 4, 16, KERNEL_INPUTS[kernel])
    assert on_chip and vec == 4 and ctas in (1, 2, 4, 8)


@pytest.mark.parametrize("kernel", sorted(KERNEL_INPUTS))
@pytest.mark.parametrize("elem", [2, 4])
def test_fused_plan_streams_the_512_rows(elem, kernel):
    """The one-process reference of phase 27 (512^2, 262,144-element rows) is
    the main path's case for the streaming variants: one CTA a row."""
    assert K._fused_plan(2 * 64, 512 * 512, elem, 16, KERNEL_INPUTS[kernel]) == \
        (1, 16 // elem, False)


@pytest.mark.parametrize("row_len,elem,inputs,want", [
    (4096, 2, 1, (1, 8, True)),
    (8192, 2, 1, (1, 8, True)),      # 256 threads x 32 elements: one CTA exactly
    (8200, 2, 1, (2, 8, True)),
    (65536, 2, 1, (8, 8, True)),
    (65544, 2, 1, (1, 8, False)),    # one vector more than 8 CTAs hold
    (1920, 2, 1, (1, 8, True)),      # 48 x 40: a row off 2,048
    (1935, 2, 1, (1, 1, True)),      # 45 x 43: odd, one element a load
    (8193, 2, 1, (2, 1, True)),
    (65537, 2, 1, (1, 1, False)),
    (65536, 4, 1, (4, 4, True)),     # f32 K1: 64 elements a thread
    (16384, 4, 1, (1, 4, True)),     # an f32 128^2 row on one CTA
    (131072, 4, 1, (8, 4, True)),
    (131076, 4, 1, (1, 4, False)),
    (65536, 2, 3, (8, 8, True)),
    (32768, 4, 3, (8, 4, True)),     # f32 K2: 16 elements of each input a thread
    (32772, 4, 3, (1, 4, False)),
    (65536, 4, 3, (1, 4, False)),
    (4096, 4, 3, (1, 4, True)),
    (4100, 4, 3, (2, 4, True)),
    (63, 2, 3, (1, 1, True)),        # a ragged 7 x 9 row
])
def test_fused_plan_picks_these(row_len, elem, inputs, want):
    assert K._fused_plan(64, row_len, elem, 16, inputs) == want


@pytest.mark.parametrize("kernel", sorted(KERNEL_INPUTS))
@pytest.mark.parametrize("row_len,elem,align,want_vec", NARROWED)
def test_fused_plan_narrows_the_load(row_len, elem, align, want_vec, kernel):
    """K1's and K2's load is the split kernels': the widest within 16 bytes
    that divides every base's alignment and the row length."""
    ctas, vec, on_chip = K._fused_plan(6, row_len, elem, align, KERNEL_INPUTS[kernel])
    assert vec == want_vec == K._split_plan(6, row_len, elem, align)[1]
    assert on_chip and ctas in (1, 2, 4, 8)


# (rows, row_len, element bytes, base alignment, inputs): main-path rows,
# a row off 2,048, an odd row, rows of one element, bases off 16 bytes, rows
# at each CTA count's edge
_FUSED_COVER = [(1024, 65536, 2, 16, 1), (1024, 65536, 2, 16, 3), (2048, 16384, 4, 16, 3),
                (4096, 4096, 2, 16, 3), (6, 1920, 2, 16, 1), (6, 1935, 4, 16, 3),
                (6, 1, 2, 16, 1), (6, 256, 2, 2, 3), (6, 4096, 4, 8, 1), (6, 8200, 2, 16, 1),
                (6, 65536, 2, 4, 1), (6, 32768, 4, 16, 3), (6, 16388, 2, 16, 3)]


@pytest.mark.parametrize("rows,row_len,elem,align,inputs", _FUSED_COVER)
def test_fused_chunks_cover_each_row_once_within_the_threads(rows, row_len, elem, align,
                                                             inputs):
    """On chip, the cluster's chunks cover each element of a row exactly once,
    in rank order, each starting on a whole vector; no thread holds more than
    `_fused_elems` elements of an input; and one CTA fewer would not hold the
    row (the fewest CTAs)."""
    ctas, vec, on_chip = K._fused_plan(rows, row_len, elem, align, inputs)
    assert on_chip
    hits = np.zeros(row_len, np.int64)
    most = 0
    for lo, hi in K._chunk_bounds(row_len, ctas, vec):
        assert lo % vec == 0 and lo <= hi
        hits[lo:hi] += 1
        most = max(most, -(-(hi - lo) // (vec * K.SPLIT_THREADS)) * vec)
    assert np.all(hits == 1)
    assert most <= K._fused_elems(elem, inputs)
    if ctas > 1:
        n_vec = row_len // vec
        assert -(-n_vec // (ctas // 2)) > K.SPLIT_THREADS * (K._fused_elems(elem, inputs) // vec)


def test_fused_elems_fit_the_register_budget():
    """32 elements a thread in bf16; in f32, 64 for K1 (64 registers) and 16
    for K2 (three inputs in 48 registers, as bf16 K2's)."""
    assert [K._fused_elems(e, i) for e in (2, 4) for i in (1, 3)] == [32, 32, 64, 16]
    for e, i in ((2, 3), (4, 3), (4, 1)):  # packed 32-bit registers a thread
        assert i * K._fused_elems(e, i) * e // 4 <= 64


def test_fused_entry_points_refuse_a_bad_plan_before_launching():
    """The `.cu` contract: K1's and K2's launchers check the plan with
    `fused_plan_ok` (and K2 its statistics pointers) before anything else and
    return cudaErrorInvalidValue without launching when it fails; the check
    refuses a load `load_ok` refuses, more than 2^31 - 1 CTAs, a streaming
    plan over more than one CTA, and on chip a CTA count other than 1, 2, 4,
    8 or a chunk the CTA's threads cannot hold. Every plan `_fused_plan`
    makes passes that check."""
    src = (build.CSRC / K.SOURCE).read_text()
    plan_ok = _cu_body(src, "bool fused_plan_ok(")
    for clause in ("!load_ok<T>(bases, row_len, vec)", "rows * ctas > INT_MAX",
                   "if (!on_chip) return ctas == 1;",
                   "ctas != 1 && ctas != 2 && ctas != 4 && ctas != 8",
                   "(row_len / vec + ctas - 1) / ctas",
                   "static_cast<long long>(kThreads) * (row_elems<T, INPUTS>() / vec)"):
        assert clause in plan_ok, clause
    for name, check, launch in (("int run_fwd(", "fused_plan_ok<T, 1>({x, y}", "launch_fwd<"),
                                ("int run_bwd(", "fused_plan_ok<T, 3>({x, y, dy, dx}",
                                 "launch_bwd<")):
        body = _cu_body(src, name).strip()
        assert body.startswith("if (!" + check), name
        # the one launch (a macro over vec 1, 2, 4, 8) comes after the check
        assert body.index("cudaErrorInvalidValue") < body.index("#define")
        assert body.count(launch) == 1 and "<<<" not in body
    elems = _cu_body(src, "constexpr int row_elems(")  # `_fused_elems`, restated
    assert "return sizeof(T) == 2 ? 32 : (INPUTS == 1 ? 64 : 16);" in elems
    for entry, impl in (("aclgan_instance_norm_fwd(", "run_fwd<"),
                        ("aclgan_instance_norm_bwd(", "run_bwd<")):
        body = _cu_body(src, 'extern "C" int ' + entry)
        assert "<<<" not in body and "launch_" not in body and impl in body

    def contract(rows, row_len, elem, align, inputs, ctas, vec, on_chip):  # restated
        if not (vec >= 1 and vec & (vec - 1) == 0 and vec * elem <= 16 and row_len % vec == 0
                and align % (vec * elem) == 0 and rows * ctas <= 2**31 - 1):
            return False
        if not on_chip:
            return ctas == 1
        return (ctas in (1, 2, 4, 8) and -(-(row_len // vec) // ctas)
                <= K.SPLIT_THREADS * (K._fused_elems(elem, inputs) // vec))

    cases = [c for c in _FUSED_COVER] + [(n * c, h * w, e, 16, i) for n, c, h, w in MAIN_SHAPES
                                         for e in (2, 4) for i in (1, 3)]
    cases += [(128, 262144, e, 16, i) for e in (2, 4) for i in (1, 3)]
    for rows, row_len, elem, align, inputs in cases:
        assert contract(rows, row_len, elem, align, inputs,
                        *K._fused_plan(rows, row_len, elem, align, inputs))
    for bad in ((6, 65536, 2, 16, 1, 4, 8, True), (6, 65536, 2, 16, 1, 3, 8, True),
                (6, 262144, 2, 16, 1, 8, 8, True), (6, 4096, 2, 16, 1, 2, 8, False),
                (6, 4096, 2, 2, 1, 1, 8, True), (6, 63, 2, 16, 1, 1, 2, True),
                (6, 32768, 4, 16, 3, 4, 4, True), (2**30, 256, 2, 16, 1, 2, 8, True)):
        assert not contract(*bad), bad
