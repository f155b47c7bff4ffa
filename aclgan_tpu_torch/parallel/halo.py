"""Halo exchange for convolutions over an H-sharded NCHW activation.

Port of `aclgan_tpu/parallel/halo.py`. Each spatial rank holds H/n rows. A
conv window needs `padding` rows above a rank's first row and
`kh - stride - padding` below its last: they come from the neighbouring
ranks, and the global top and bottom ranks put in their own pad rows
instead (reflect / replicate / zero, as `_edge_pad_rows` does). W is not
sharded, so it is padded locally after H. (The JAX module moves
`kh - 1 - padding` rows below; at stride s the last s - 1 of them are never
read, and at the bottom rank they would be reflect rows that a 2-row shard
of a 4x4/s2 layer does not have.)

The JAX module moves the rows with a pair of `ppermute`s. Here the form
depends on what the spatial group can move (`_point_to_point`):

- over NCCL, and over gloo on the CPU, the rows go point to point, as the
  `ppermute`s send them: one `dist.batch_isend_irecv` a layer sends a rank's
  last `top` rows to the next spatial rank and its first `bottom` rows to
  the previous one; the grid's first and last ranks send and receive
  nothing that `halo_rows` would discard. Over NCCL this is device work,
  which the train step's CUDA graph records;
- gloo with CUDA tensors (two ranks sharing one card) moves them only by
  `all_reduce` and `broadcast`, so there the exchange is one `all_reduce`
  over the spatial group: each rank writes the rows its neighbours need
  into its own slot of a zeroed (n, N, C, top + bottom, W) buffer and reads
  its neighbours' slots, at n times the bytes.

`sharded_instance_norm` is the plain counterpart of the JAX function; the
model's IN / AdaIN layers take the split kernels instead
(`ops/kernels/instance_norm.py`, `_ShardedFusedInstanceNorm`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from aclgan_tpu_torch.ops.pad import PAD_MODES
from aclgan_tpu_torch.parallel.mesh import all_reduce_sum


def _edge_rows(x: torch.Tensor, n_rows: int, top: bool, pad_type: str) -> torch.Tensor:
    """The rows F.pad would put above (top) or below the image's edge rows,
    from this rank's own rows."""
    if pad_type == "zero":
        return x.new_zeros(x.shape[0], x.shape[1], n_rows, x.shape[3])
    if pad_type == "reflect":  # reflect skips the edge row
        rows = x[:, :, 1:n_rows + 1] if top else x[:, :, x.shape[2] - n_rows - 1:-1]
        return rows.flip(2)
    if pad_type == "replicate":
        row = x[:, :, :1] if top else x[:, :, -1:]
        return row.expand(-1, -1, n_rows, -1)
    raise ValueError(f"Unsupported padding type: {pad_type!r}")


def _point_to_point(x: torch.Tensor, group) -> bool:
    """The halo's form for `x` over `group`: point to point over NCCL and
    over gloo on the CPU; one all-reduce for gloo with CUDA tensors, which
    gloo cannot send point to point."""
    return x.device.type == "cpu" or dist.get_backend(group) == "nccl"


def _exchange(mesh, sends, recv_like):
    """Point to point in the spatial group: `sends` {offset: tensor} go to
    the spatial rank at that offset (+1 next, -1 previous); returns
    {offset: tensor} received from those ranks, one `recv_like[offset]`
    (shape, tensor to match) each."""
    ops, got = [], {}
    for off, t in sends.items():
        ops.append(dist.P2POp(dist.isend, t.contiguous(), mesh.rank + off, mesh.spatial_group))
    for off, (shape, like) in recv_like.items():
        got[off] = like.new_empty(shape)
        ops.append(dist.P2POp(dist.irecv, got[off], mesh.rank + off, mesh.spatial_group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _HaloExchange(torch.autograd.Function):
    """(the previous spatial rank's last `top` rows, the next rank's first
    `bottom` rows). The grid's first and last ranks get zeros where the
    all-reduce form gives them the rows of the other end: `halo_rows` uses
    neither. The backward is the transpose: each halo row's gradient goes
    back to the rank that owns the row and is added to it there."""

    @staticmethod
    def forward(ctx, x, top, bottom, mesh):
        ctx.top, ctx.bottom, ctx.mesh, ctx.h = top, bottom, mesh, x.shape[2]
        ctx.p2p = _point_to_point(x, mesh.spatial_group)
        n, r, h = mesh.n_spatial, mesh.spatial_rank, x.shape[2]
        if ctx.p2p:
            def rows(k):
                return x.shape[:2] + (k, x.shape[3])

            sends, recvs = {}, {}
            if top and r < n - 1:
                sends[1] = x[:, :, h - top:]  # the next rank's top halo
            if bottom and r > 0:
                sends[-1] = x[:, :, :bottom]  # the previous rank's bottom halo
            if top and r > 0:
                recvs[-1] = (rows(top), x)
            if bottom and r < n - 1:
                recvs[1] = (rows(bottom), x)
            got = _exchange(mesh, sends, recvs)
            return (got[-1] if -1 in got else x.new_zeros(rows(top)),
                    got[1] if 1 in got else x.new_zeros(rows(bottom)))
        buf = x.new_zeros((n,) + x.shape[:2] + (top + bottom, x.shape[3]))
        buf[r, :, :, :top] = x[:, :, h - top:]  # for the next rank's top halo
        buf[r, :, :, top:] = x[:, :, :bottom]   # for the previous rank's bottom halo
        dist.all_reduce(buf, group=mesh.spatial_group)
        return (buf[(r - 1) % n, :, :, :top].contiguous(),
                buf[(r + 1) % n, :, :, top:].contiguous())

    @staticmethod
    def backward(ctx, g_prev, g_next):
        top, bottom, mesh, h = ctx.top, ctx.bottom, ctx.mesh, ctx.h
        n, r = mesh.n_spatial, mesh.spatial_rank
        dx = g_prev.new_zeros(g_prev.shape[:2] + (h, g_prev.shape[3]))
        if ctx.p2p:
            sends, recvs = {}, {}
            if top and r > 0:
                sends[-1] = g_prev
            if bottom and r < n - 1:
                sends[1] = g_next
            if top and r < n - 1:
                recvs[1] = (g_prev.shape, g_prev)
            if bottom and r > 0:
                recvs[-1] = (g_next.shape, g_next)
            got = _exchange(mesh, sends, recvs)
            if 1 in got:
                dx[:, :, h - top:] += got[1]
            if -1 in got:
                dx[:, :, :bottom] += got[-1]
            return dx, None, None, None
        buf = g_prev.new_zeros((n,) + g_prev.shape[:2] + (top + bottom, g_prev.shape[3]))
        if r > 0:
            buf[r, :, :, :top] = g_prev
        if r < n - 1:
            buf[r, :, :, top:] = g_next
        dist.all_reduce(buf, group=mesh.spatial_group)
        if r < n - 1:
            dx[:, :, h - top:] += buf[r + 1, :, :, :top]
        if r > 0:
            dx[:, :, :bottom] += buf[r - 1, :, :, top:]
        return dx, None, None, None


def halo_rows(x: torch.Tensor, top: int, bottom: int, mesh, pad_type: str) -> torch.Tensor:
    """This rank's rows with `top` rows above and `bottom` below: the
    neighbours' rows, or the image's own `pad_type` rows at its global top
    and bottom. Differentiable."""
    if top == 0 and bottom == 0:
        return x
    n, r = mesh.n_spatial, mesh.spatial_rank
    if n > 1:
        from_prev, from_next = _HaloExchange.apply(x, top, bottom, mesh)
    above = _edge_rows(x, top, True, pad_type) if r == 0 else from_prev
    below = _edge_rows(x, bottom, False, pad_type) if r == n - 1 else from_next
    return torch.cat([above, x, below], 2)


def check_halo(h_local: int, n_spatial: int, kh: int, stride: int, padding: int,
               pad_type: str, layer: str = "") -> None:
    """JAX's shard-exactness preconditions (`halo.py:77-89`): each shard
    emits h_local / stride rows on the global stride grid. Reflect also
    needs more rows a shard than `padding`, as it skips the edge row.
    Raises ValueError naming `layer` where given."""
    where = f"{layer}: " if layer else ""
    top, bottom = padding, kh - 1 - padding
    if not 1 <= kh - 2 * padding <= stride:
        raise ValueError(
            f"{where}halo_conv requires 1 <= kh - 2*padding <= stride "
            f"(got kh={kh}, padding={padding}, stride={stride})")
    h = h_local * n_spatial
    if h_local % stride or max(top, bottom) > h_local:
        raise ValueError(
            f"{where}halo_conv: H={h} must split into {n_spatial} shards of "
            f"stride-divisible height >= the halo ({top},{bottom})")
    if pad_type == "reflect" and padding >= h_local:
        raise ValueError(
            f"{where}halo_conv: reflect padding {padding} needs more than {padding} "
            f"rows a shard (H={h} over n_spatial={n_spatial})")


def halo_pad(x: torch.Tensor, kh: int, stride: int, padding: int, pad_type: str, mesh,
             layer: str = "") -> torch.Tensor:
    """This rank's rows of pad(x_global) that a VALID kh x kh conv at
    `stride` reads: the halo in H, then `padding` columns of `pad_type` in
    W."""
    if pad_type not in PAD_MODES:
        raise ValueError(f"Unsupported padding type: {pad_type!r}")
    check_halo(x.shape[2], mesh.n_spatial, kh, stride, padding, pad_type, layer)
    xe = halo_rows(x, padding, kh - stride - padding, mesh, pad_type)
    if padding:
        xe = F.pad(xe, (padding, padding, 0, 0), mode=PAD_MODES[pad_type])
    return xe


def halo_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mesh,
              stride: int = 1, padding: int = 0, pad_type: str = "reflect") -> torch.Tensor:
    """conv(pad(x_global)) on this rank's rows of an H-sharded NCHW
    activation: weight (out, in, kh, kw), VALID at `stride` after `padding`
    rows and columns of `pad_type`."""
    xe = halo_pad(x, weight.shape[2], stride, padding, pad_type, mesh)
    return F.conv2d(xe, weight.to(xe.dtype), bias.to(xe.dtype), stride)


def sharded_instance_norm(x: torch.Tensor, mesh, eps: float = 1e-5) -> torch.Tensor:
    """Instance norm over an H-sharded activation: each (n, c) row's
    statistics from the all-reduced local sums and sums of squares, the
    variance clamped at 0 (`halo.py:132-159`)."""
    x32 = x.float()
    n = x.shape[2] * x.shape[3] * mesh.n_spatial
    sums = all_reduce_sum(torch.stack([x32.sum((2, 3)), (x32 * x32).sum((2, 3))]),
                          mesh.spatial_group)
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    out = (x32 - mean[:, :, None, None]) * torch.rsqrt(var + eps)[:, :, None, None]
    return out.to(x.dtype)
