"""Packed embedding tables on Hopper: the layout helpers, the packed
lookup, and the kernel that writes its gradient (``pack_write``).

Port of ``hetu_tpu/ops/pallas/sparse_densify.py``.  A table of narrow rows
(dim | 128) is stored packed as ``[p_rows, 128]``, q = 128 / dim logical
rows to a 128-lane line, and the dense optimizer updates it whole, as in
the JAX package.  The lookup's gradient is the dense packed gradient:
each gradient row placed at its lane offset inside its line
(``_position_lines``), then the lines of equal pack ids summed and written
into a zero fill (``pack_write``).

``pack_write`` replaces the Pallas TPU kernel reached through the JAX
``pack_write`` (``pl.pallas_call`` at line 152) and the duplicate merge
that feeds it (``_merge_duplicate_lines``).  The ids are sorted with
``torch.sort`` (stable; XLA's argsort in the JAX package) and the output
is a ``torch.zeros`` fill; the merge and the write are one CUDA kernel,
``hetu_tpu_torch/csrc/pack_write.cu``, whose header says what bounds it
and how it sums without atomics.  The gate is the reference's
(``_kernel_supported``): the kernel takes f32 lines; other dtypes run the
plain composition that the JAX package runs below its gate, on any
device.  An f32 CUDA tensor launches the kernel or raises; a CPU tensor
runs ``pack_write_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LANES = 128
_SOURCE = "pack_write.cu"
_fn = []


def pack_factor(dim):
    """Rows per 128-lane line, or 0 when the dim doesn't pack."""
    if dim <= LANES and LANES % dim == 0:
        return LANES // dim
    return 0


def packed_rows(num_rows, dim):
    """Lines needed to hold ``num_rows`` logical rows (the last line may
    be partly used; lookups never see the padding)."""
    q = pack_factor(dim)
    return (num_rows + q - 1) // q


def pack_table(table):
    """[num_rows, dim] -> packed [p_rows, 128] on the table's device,
    zero-padding the tail line."""
    n, d = table.shape
    q = pack_factor(d)
    if not q:
        raise ValueError(f"dim {d} does not pack into 128 lanes")
    pad = packed_rows(n, d) * q - n
    if pad:
        table = torch.cat([table, table.new_zeros(pad, d)])
    return table.reshape(-1, LANES)


def unpack_table(packed, num_rows, dim):
    """Packed [p_rows, 128] -> [num_rows, dim]."""
    return packed.reshape(-1, dim)[:num_rows]


def pack_write_plain(pack_ids, lines, p_rows):
    """out[pack_ids[i]] += lines[i] into zeros [p_rows, 128]: the JAX
    package's composition below its kernel gate (sparse_densify.py:129-132),
    a scatter-add into p_rows + 1 rows whose spare row takes the ids to
    drop.  JAX's scatter drops ids past the spare row; here every id outside
    [0, p_rows) goes to the spare row, which gives the same result."""
    ids = pack_ids.reshape(-1).long()
    lines = lines.reshape(ids.shape[0], LANES)
    safe = torch.where((ids >= 0) & (ids < p_rows), ids, p_rows)
    out = torch.zeros(p_rows + 1, LANES, dtype=lines.dtype,
                      device=lines.device)
    return out.index_add_(0, safe, lines)[:p_rows]


def _kernel():
    if not _fn:
        fn = build.load(_SOURCE).hetu_pack_write
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _uses_kernel(lines):
    """The reference's gate (``_kernel_supported``): f32 lines away from
    the CPU go to the kernel; a CPU tensor or another dtype runs the plain
    composition."""
    return lines.device.type != "cpu" and lines.dtype == torch.float32


def pack_write_kernel(ids_sorted, order, lines, out):
    """The CUDA kernel on sorted ids: for each run of equal ids in
    ``ids_sorted`` [M] int32 (ascending) it writes the sum of the run's
    rows ``lines[order[k]]`` ([M, 128] f32), taken in sorted order, to
    ``out[id]`` (a zero-filled [p_rows, 128] f32); ids < 0 or >= p_rows
    are skipped.  Returns ``out``."""
    m, p_rows = ids_sorted.shape[0], out.shape[0]
    dev = lines.device
    if not (lines.is_cuda and ids_sorted.device == dev
            and order.device == dev and out.device == dev):
        raise ValueError("pack_write_kernel: every tensor must lie on one "
                         "CUDA device")
    if (ids_sorted.dtype != torch.int32 or order.dtype != torch.int64
            or lines.dtype != torch.float32 or out.dtype != torch.float32):
        raise TypeError("pack_write_kernel: ids int32, order int64, lines "
                        "and out f32")
    if (tuple(order.shape) != (m,) or tuple(lines.shape) != (m, LANES)
            or out.dim() != 2 or out.shape[1] != LANES
            or not all(t.is_contiguous() for t in (ids_sorted, order, lines,
                                                   out))
            or lines.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("pack_write_kernel: contiguous [M], [M], [M, 128] "
                         "and [p_rows, 128], the rows 16-byte aligned")
    err = _kernel()(ids_sorted.data_ptr(), order.data_ptr(),
                    lines.data_ptr(), out.data_ptr(), m, p_rows,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"pack_write_kernel: launch failed with CUDA error {err}")
    if m:  # no ids launch nothing
        pack_write_kernel.launches += 1
    return out


pack_write_kernel.launches = 0


def pack_write(pack_ids, lines, p_rows):
    """Write-only densify: out[p] = the sum of lines[i] over pack_ids[i] = p
    (ids < 0 or >= p_rows ignored), zeros elsewhere.  Shapes: pack_ids [M]
    int, lines [M, 128] -> [p_rows, 128] in the lines' dtype.

    f32 lines on the card: a stable sort, a zero fill and
    ``pack_write_kernel``, which sums each run of equal ids in input
    order, so two calls give the same bits.  Other dtypes, and CPU
    tensors: ``pack_write_plain``."""
    pack_ids = pack_ids.reshape(-1)
    m = pack_ids.shape[0]
    lines = lines.reshape(m, LANES)
    if not _uses_kernel(lines):
        return pack_write_plain(pack_ids, lines, p_rows)
    if p_rows >= 2 ** 31:
        raise ValueError(f"pack_write: p_rows {p_rows} exceeds int32 ids")
    out = torch.zeros(p_rows, LANES, dtype=lines.dtype, device=lines.device)
    ids_sorted, order = torch.sort(pack_ids.to(torch.int32), stable=True)
    lines = lines.contiguous()
    if lines.data_ptr() % 16:  # the kernel reads float4s
        lines = lines.clone()
    return pack_write_kernel(ids_sorted, order, lines, out)


def _position_lines(ids, g, q, dim):
    """Place each [dim] gradient row at its lane offset inside a [128]
    line: [M, 128], zeros outside the row's slot."""
    off = torch.where(ids >= 0, ids % q, 0)
    tiled = g.repeat(1, q)
    lane_slot = torch.arange(q * dim, device=g.device) // dim
    mask = lane_slot[None, :] == off[:, None]
    return torch.where(mask, tiled, torch.zeros((), dtype=g.dtype,
                                                device=g.device))


def _lookup(table, ids, dim):
    """Rows [..., dim] of a packed table at ``ids``, negative ids clamped
    to logical row 0.  The JAX forward gathers whole lines and extracts the
    row with a masked select-sum; this gathers the row directly from the
    [p_rows * q, dim] view.  Both give each row's own values and nothing of
    its line's other rows, so a NaN or Inf in a co-resident row cannot
    reach it, and both give the same values for finite tables (the
    select-sum adds zeros to the row; it only turns a -0.0 into 0.0)."""
    flat = ids.reshape(-1).long().clamp_min(0)
    rows = table.reshape(-1, dim).index_select(0, flat)
    return rows.reshape(tuple(ids.shape) + (dim,))


class PackedLookupFn(torch.autograd.Function):
    """Row lookup from a packed [p_rows, 128] table, whose backward is the
    dense packed gradient through ``pack_write`` (the JAX package's
    ``custom_vjp``).  Negative ids contribute no gradient."""

    @staticmethod
    def forward(ctx, table, ids, dim):
        ctx.save_for_backward(ids)
        ctx.dim, ctx.p_rows = dim, table.shape[0]
        return _lookup(table, ids, dim)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        dim = ctx.dim
        q = LANES // dim
        flat = ids.reshape(-1).long()
        lines = _position_lines(flat, g.reshape(-1, dim), q, dim)
        grad = pack_write(torch.div(flat, q, rounding_mode="floor"), lines,
                          ctx.p_rows)
        return grad, None, None


def packed_lookup(table, ids, dim):
    """Rows [..., dim] for integer ``ids`` from a packed [p_rows, 128]
    table (shape-preserving, like an index select); differentiable in the
    table."""
    if not pack_factor(dim):
        raise ValueError(f"dim {dim} does not pack into 128 lanes")
    return PackedLookupFn.apply(table, ids, dim)
