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
and how it sums without atomics.

Two plain versions, each named for what it is:

- ``pack_write_plain``: the JAX package's composition below its kernel
  gate, a scatter-add into a zero fill, which adds each line's terms one
  after another in input order, as JAX's scatter does on the CPU.  It is
  what a CPU tensor runs, so that the port's CPU path keeps the JAX
  package's values.
- ``pack_write_ordered``: the same sums in the order that defines the
  kernel's, a tree over the sorted positions (leaves of ``FAN`` positions
  summed in sorted order, each node summing its ``FAN`` children's pieces
  of a run in order).  The kernel equals it bitwise, on the card and on
  the CPU.  It differs from the scatter-add only by the order of the
  additions: at most 2 k 2^-24 sum|term| on a line of k terms.

The gate is the reference's (``_kernel_supported``): the kernel takes f32
lines.  An f32 CUDA tensor launches the kernel or raises; a CPU tensor,
and any other dtype on any device, runs ``pack_write_plain``, as the JAX
package runs its composition below its gate.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LANES = 128
FAN = 32  # positions a leaf and children a node of the summation tree
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


def tree_slots(m):
    """Scratch slots of ``pack_write_kernel`` for m positions: two (a run
    entering a node from the left, a run starting inside it) for each node
    of every tree level that has more than one, as the CUDA source lays
    them out."""
    slots, span = 0, FAN
    while True:
        nodes = -(-m // span)
        if nodes <= 1:
            return slots
        slots += 2 * nodes
        span *= FAN


def pack_write_ordered(pack_ids, lines, p_rows):
    """``pack_write`` in the kernel's summation order, in plain PyTorch:
    the ids sorted (stable), then a tree over the sorted positions.  Level
    0 cuts them into leaves of ``FAN`` positions and sums each run of equal
    ids inside a leaf from 0 in sorted order; each higher level groups
    ``FAN`` consecutive nodes and sums, from 0 and in order, the pieces of
    each run that they hold, up to the one node that holds all positions.
    Each level is ``FAN`` steps, one child of every piece a step, so that
    every piece receives its terms one at a time in order.  Ids outside
    [0, p_rows) are dropped; other lines are zero."""
    ids = pack_ids.reshape(-1).long()
    m = ids.shape[0]
    lines = lines.reshape(m, LANES)
    out = torch.zeros(p_rows, LANES, dtype=lines.dtype, device=lines.device)
    if m == 0:
        return out
    ids_sorted, order = torch.sort(ids, stable=True)
    vals = lines[order]
    run_start = torch.ones(m, dtype=torch.bool, device=ids.device)
    run_start[1:] = ids_sorted[1:] != ids_sorted[:-1]
    run = torch.cumsum(run_start, 0) - 1
    node = torch.arange(m, device=ids.device)  # each item's node index
    while True:
        parent = torch.div(node, FAN, rounding_mode="floor")
        step = node - parent * FAN
        new = torch.ones_like(run_start[:node.shape[0]])
        new[1:] = (parent[1:] != parent[:-1]) | (run[1:] != run[:-1])
        piece = torch.cumsum(new, 0) - 1
        acc = vals.new_zeros(int(piece[-1]) + 1, LANES)
        for t in range(FAN):
            sel = (step == t).nonzero().squeeze(1)
            dst = piece[sel]
            acc[dst] = acc[dst] + vals[sel]
        vals, node, run = acc, parent[new], run[new]
        if int(node[-1]) == 0:  # one node holds every position
            break
    run_ids = ids_sorted[run_start]
    keep = (run_ids >= 0) & (run_ids < p_rows)
    out[run_ids[keep]] = vals[keep]
    return out


def _kernel():
    if not _fn:
        fn = build.load(_SOURCE).hetu_pack_write
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _uses_kernel(lines):
    """The reference's gate (``_kernel_supported``): f32 lines away from
    the CPU go to the kernel; a CPU tensor or another dtype runs the plain
    composition."""
    return lines.device.type != "cpu" and lines.dtype == torch.float32


def pack_write_kernel(ids_sorted, order, lines, out, pieces, counters):
    """The CUDA kernel on sorted ids: for each run of equal ids in
    ``ids_sorted`` [M] int32 (ascending) it writes the sum of the run's
    rows ``lines[order[k]]`` ([M, 128] f32), in ``pack_write_ordered``'s
    order, to ``out[id]`` (a zero-filled [p_rows, 128] f32); ids < 0 or
    >= p_rows are skipped.  ``pieces`` [tree_slots(M), 128] f32 is scratch;
    ``counters`` [tree_slots(M)] int32 must be zero, and the kernel leaves
    it zero.  Returns ``out``."""
    m, p_rows = ids_sorted.shape[0], out.shape[0]
    slots = tree_slots(m)
    dev = lines.device
    tensors = (ids_sorted, order, lines, out, pieces, counters)
    if not (lines.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("pack_write_kernel: every tensor must lie on one "
                         "CUDA device")
    if (ids_sorted.dtype != torch.int32 or order.dtype != torch.int64
            or lines.dtype != torch.float32 or out.dtype != torch.float32
            or pieces.dtype != torch.float32
            or counters.dtype != torch.int32):
        raise TypeError("pack_write_kernel: ids int32, order int64, lines, "
                        "out and pieces f32, counters int32")
    if (tuple(order.shape) != (m,) or tuple(lines.shape) != (m, LANES)
            or out.dim() != 2 or out.shape[1] != LANES
            or tuple(pieces.shape) != (slots, LANES)
            or tuple(counters.shape) != (slots,)
            or not all(t.is_contiguous() for t in tensors)
            or lines.data_ptr() % 16 or out.data_ptr() % 16
            or pieces.data_ptr() % 16):
        raise ValueError("pack_write_kernel: contiguous [M], [M], [M, 128], "
                         "[p_rows, 128], [slots, 128] and [slots], the rows "
                         "16-byte aligned")
    err = _kernel()(*(t.data_ptr() for t in tensors), m, p_rows,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"pack_write_kernel: launch failed with CUDA error {err}")
    if m:  # no ids launch nothing
        pack_write_kernel.launches += 1
    return out


pack_write_kernel.launches = 0


def kernel_buffers(m, p_rows, device):
    """(out, pieces, counters) for ``pack_write_kernel``: out and the
    counters share one zero fill (the counters are its int32 tail), the
    pieces are left unset."""
    slots = tree_slots(m)
    flat = torch.zeros(p_rows * LANES + slots, dtype=torch.float32,
                       device=device)
    out = flat[:p_rows * LANES].view(p_rows, LANES)
    counters = flat[p_rows * LANES:].view(torch.int32)
    pieces = torch.empty(slots, LANES, dtype=torch.float32, device=device)
    return out, pieces, counters


def pack_write(pack_ids, lines, p_rows):
    """Write-only densify: out[p] = the sum of lines[i] over pack_ids[i] = p
    (ids < 0 or >= p_rows ignored), zeros elsewhere.  Shapes: pack_ids [M]
    int, lines [M, 128] -> [p_rows, 128] in the lines' dtype.

    f32 lines on the card: a stable sort, one zero fill and
    ``pack_write_kernel``, which sums in ``pack_write_ordered``'s fixed
    order, so two calls give the same bits.  CPU tensors and other dtypes:
    ``pack_write_plain``."""
    pack_ids = pack_ids.reshape(-1)
    m = pack_ids.shape[0]
    lines = lines.reshape(m, LANES)
    if not _uses_kernel(lines):
        return pack_write_plain(pack_ids, lines, p_rows)
    if p_rows >= 2 ** 31:
        raise ValueError(f"pack_write: p_rows {p_rows} exceeds int32 ids")
    out, pieces, counters = kernel_buffers(m, p_rows, lines.device)
    ids_sorted, order = torch.sort(pack_ids.to(torch.int32), stable=True)
    lines = lines.contiguous()
    if lines.data_ptr() % 16:  # the kernel reads float4s
        lines = lines.clone()
    return pack_write_kernel(ids_sorted, order, lines, out, pieces, counters)


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
