"""The port's packed embedding path (ops/kernels/sparse_densify.py) against
the JAX package's (hetu_tpu/ops/pallas/sparse_densify.py) on the CPU.

On the CPU the JAX ``pack_write`` runs its jnp composition (its kernel
gate admits TPU only) and the port runs ``pack_write_plain``, the same
composition.  ``pack_write_ordered`` is the CUDA kernel's fixed summation
tree, which the kernel equals bitwise on the card (``chip_smoke.py``);
here it is held to the JAX composition and to ``pack_write_plain``.

Tolerances: the layout helpers and the lookup forward are exact (a packed
table is a reshape; both lookups return each row's own values).
``pack_write`` and the lookup's gradient: a line with one contributor is
one ``0 + x`` add on both sides and is compared bitwise; a line that merges
several rows is a sum of f32 terms that the two scatter-adds may take in
another order, held to rtol 1e-6 and atol 1e-6 (inputs ~N(0, 1), at most
a few hundred terms a line, so a reordering moves the sum by a few f32
ulps of its terms' magnitude).  ``pack_write_ordered`` adds in a tree
order instead, which moves a sum whose terms cancel by more than that
relative tolerance: its merged lines are held to the bound of any two
summation orders of k terms, 2 k 2^-24 sum|term| (each order's error is
at most k 2^-24 sum|term|), and its single lines bitwise.
"""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hetu_tpu.ops.pallas import sparse_densify as jsd
from hetu_tpu_torch.ops.kernels import sparse_densify as tsd


def _ids_case(kind, rng, m, p_rows):
    """pack ids [m] int32 of one kind: uniform, Zipf-skewed (many
    duplicates a line), with negatives, in the tail line, out of range."""
    if kind == "uniform":
        return rng.integers(0, p_rows, m)
    if kind == "zipf":
        return np.minimum(rng.zipf(1.05, m) - 1, p_rows - 1)
    if kind == "negative":
        ids = rng.integers(0, p_rows, m)
        ids[rng.random(m) < 0.3] = -1
        ids[::7] = -5
        return ids
    if kind == "tail":
        return np.where(rng.random(m) < 0.5, p_rows - 1,
                        rng.integers(0, p_rows, m))
    if kind == "out_of_range":
        ids = rng.integers(0, p_rows, m)
        ids[::5] = p_rows
        ids[1::5] = p_rows + 3
        return ids
    raise ValueError(kind)


def _assert_lines(got, want, counts):
    """Bitwise where a line has one contributor; rtol/atol 1e-6 where the
    scatter-adds merge several (module docstring)."""
    single = counts == 1
    np.testing.assert_array_equal(got[single], want[single])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [1, 8, 16, 32, 64, 100, 128, 256])
def test_pack_factor_and_rows_match_jax(dim):
    assert tsd.pack_factor(dim) == jsd.pack_factor(dim)
    if tsd.pack_factor(dim):
        for n in (1, 337000, 337001, 33762577):
            assert tsd.packed_rows(n, dim) == jsd.packed_rows(n, dim)


def test_published_table_sizes():
    """bench_wdl's table and Criteo's 33.76M features at dim 16."""
    assert tsd.packed_rows(337000, 16) == 42125
    assert tsd.packed_rows(33762577, 16) == 4220323


@pytest.mark.parametrize("rows,dim", [(1001, 16), (640, 8), (77, 32),
                                      (5, 128)])
def test_pack_unpack_roundtrip_matches_jax(rows, dim):
    w = np.random.default_rng(rows).standard_normal((rows, dim)).astype(
        np.float32)
    want = np.asarray(jsd.pack_table(w))
    got = tsd.pack_table(torch.from_numpy(w))
    assert tuple(got.shape) == (tsd.packed_rows(rows, dim), 128)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tsd.unpack_table(got, rows, dim).numpy(),
        np.asarray(jsd.unpack_table(jnp.asarray(want), rows, dim)))
    with pytest.raises(ValueError, match="does not pack"):
        tsd.pack_table(torch.zeros(4, 100))


@pytest.mark.parametrize("kind", ["uniform", "zipf", "negative", "tail",
                                  "out_of_range"])
@pytest.mark.parametrize("m,p_rows", [(333, 40), (3328, 4213)])
def test_pack_write_plain_matches_jax(kind, m, p_rows):
    rng = np.random.default_rng(m + p_rows)
    ids = _ids_case(kind, rng, m, p_rows).astype(np.int32)
    lines = rng.standard_normal((m, 128)).astype(np.float32)
    want = np.asarray(jsd.pack_write(jnp.asarray(ids), jnp.asarray(lines),
                                     p_rows, use_pallas=False))
    got = tsd.pack_write(torch.from_numpy(ids), torch.from_numpy(lines),
                         p_rows)
    assert got.shape == (p_rows, 128) and got.dtype == torch.float32
    counts = np.bincount(ids[(ids >= 0) & (ids < p_rows)],
                         minlength=p_rows)
    assert counts.max() > 1  # every case merges some lines
    _assert_lines(got.numpy(), want, counts)
    assert np.all(got.numpy()[counts == 0] == 0)


def _ordered_case(kind, rng):
    """(pack ids, p_rows) of the ordered version's cases: runs that
    straddle leaf and node borders, one run over many leaves (Zipf with
    every draw past the table clipped onto its last line, as chip_smoke.py
    draws W&D's skewed ids), negative and out-of-range ids."""
    fan = tsd.FAN
    if kind == "straddle":
        # runs of 1, fan - 1, fan, fan + 1, 2 fan + 1 and fan^2 + 3 ids,
        # laid end to end from an offset, so they cross leaf and node
        # borders at every phase
        lengths = [1, fan - 1, fan, fan + 1, 2 * fan + 1, 3, fan * fan + 3,
                   5, fan + 7]
        ids = np.concatenate([np.full(n, i) for i, n in enumerate(lengths)])
        return np.concatenate([np.full(fan // 2 + 1, -1), ids]), len(lengths)
    if kind == "zipf_long":
        p_rows = 42125  # W&D's table, 337,000 rows of 16
        return np.minimum(rng.zipf(1.05, 40000) - 1, p_rows - 1), p_rows
    if kind == "negative_out_of_range":
        ids = rng.integers(0, 60, 5000)
        ids[rng.random(5000) < 0.3] = -1
        ids[::11] = 60
        ids[1::13] = 65
        return ids, 60
    if kind == "uniform":
        return rng.integers(0, 42125, 3328), 42125
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["straddle", "zipf_long",
                                  "negative_out_of_range", "uniform"])
def test_pack_write_ordered_matches_jax_and_scatter_add(kind):
    rng = np.random.default_rng(len(kind))
    ids, p_rows = _ordered_case(kind, rng)
    ids = ids.astype(np.int32)
    lines = rng.standard_normal((ids.shape[0], 128)).astype(np.float32)
    want = np.asarray(jsd.pack_write(jnp.asarray(ids), jnp.asarray(lines),
                                     p_rows, use_pallas=False))
    t_ids, t_lines = torch.from_numpy(ids), torch.from_numpy(lines)
    got = tsd.pack_write_ordered(t_ids, t_lines, p_rows)
    assert got.shape == (p_rows, 128) and got.dtype == torch.float32
    counts = np.bincount(ids[(ids >= 0) & (ids < p_rows)],
                         minlength=p_rows)
    if kind != "uniform":
        assert counts.max() > tsd.FAN  # some run spans leaves
    abs_sum = tsd.pack_write_plain(t_ids, t_lines.abs(), p_rows).numpy()
    bound = 2.0 * counts[:, None] * 2.0 ** -24 * abs_sum
    single = counts == 1
    for other in (want, tsd.pack_write_plain(t_ids, t_lines, p_rows).numpy()):
        np.testing.assert_array_equal(got.numpy()[single], other[single])
        assert np.all(np.abs(got.numpy() - other) <= bound)
    assert np.all(got.numpy()[counts == 0] == 0)


def test_pack_write_ordered_sums_in_its_tree_order():
    """The order itself: a run inside one leaf is summed in sorted
    (stable: input) order from 0; a run over two leaves is 0 + A + B, A
    and B its leaves' sums; a run over leaves of two nodes adds the
    nodes' pieces in turn."""
    fan = tsd.FAN
    rng = np.random.default_rng(3)

    def seq(rows):
        acc = np.zeros(128, np.float32)
        for r in rows:
            acc = acc + r
        return acc

    # id 1 at positions 3..fan+9 (two leaves); id 2 over three nodes
    n2 = 2 * fan * fan + 5
    ids = np.concatenate([np.zeros(3), np.ones(fan + 7), np.full(n2, 2)])
    lines = (rng.standard_normal((ids.shape[0], 128)) * 1e3).astype(
        np.float32)
    perm = rng.permutation(ids.shape[0])  # the ids unsorted
    got = tsd.pack_write_ordered(torch.from_numpy(ids[perm].astype(np.int32)),
                                 torch.from_numpy(lines[perm]), 3).numpy()
    # the stable sort keeps equal ids in their input order
    lines = lines[perm][np.argsort(ids[perm], kind="stable")]
    np.testing.assert_array_equal(got[0], seq(lines[:3]))
    a, b = seq(lines[3:fan]), seq(lines[fan:fan + 10])
    np.testing.assert_array_equal(got[1], seq([a, b]))
    start = fan + 10
    leaves = [seq(lines[max(p, start):p + fan])
              for p in range(start - start % fan, ids.shape[0], fan)]
    first = fan - start % fan  # leaves of id 2 in the first node
    node0 = seq(leaves[:fan - 1])  # leaves 1..fan-1 of node 0
    node1 = seq(leaves[fan - 1:2 * fan - 1])
    node2 = seq(leaves[2 * fan - 1:])
    assert first and len(leaves) == 2 * fan + 1
    np.testing.assert_array_equal(got[2], seq([node0, node1, node2]))
    assert not np.array_equal(got[2], seq(lines[start:]))


def test_tree_slots_match_the_cuda_source():
    """The tree's fan-out in Python is the CUDA source's (``kFan``), and
    the scratch holds two slots for each node of every level with more
    than one."""
    src = os.path.join(os.path.dirname(tsd.__file__), "..", "..", "csrc",
                       "pack_write.cu")
    with open(src) as f:
        text = f.read()
    assert int(re.search(r"constexpr int kFan = (\d+);", text).group(1)) \
        == tsd.FAN
    assert [tsd.tree_slots(m) for m in (0, 1, 32, 33, 1024, 1025, 65536)] \
        == [0, 0, 0, 4, 64, 66 + 4, 4096 + 128 + 4]


def test_pack_write_empty():
    out = tsd.pack_write(torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0, 128), 7)
    ordered = tsd.pack_write_ordered(torch.zeros(0, dtype=torch.int32),
                                     torch.zeros(0, 128), 7)
    assert ordered.shape == (7, 128) and not ordered.any()
    want = jsd.pack_write(jnp.zeros(0, jnp.int32), jnp.zeros((0, 128)), 7,
                          use_pallas=False)
    assert out.shape == (7, 128) and not out.any()
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_pack_write_dtype_gate():
    """The reference's gate: f32 lines away from the CPU take the kernel
    route (a non-CUDA device then raises rather than falling back); other
    dtypes run the plain composition, as JAX runs its jnp form for them
    even on TPU, and give JAX's bf16 result."""
    meta = torch.empty(4, 128, device="meta")
    assert tsd._uses_kernel(meta)
    assert not tsd._uses_kernel(meta.to(torch.bfloat16))
    assert not tsd._uses_kernel(torch.empty(4, 128))
    with pytest.raises(ValueError, match="one CUDA device"):
        tsd.pack_write(torch.zeros(4, dtype=torch.int32, device="meta"),
                       meta, 3)
    rng = np.random.default_rng(5)
    ids = np.array([0, 2, 2, -1, 1, 2], np.int32)
    lines = rng.standard_normal((6, 128)).astype(np.float32)
    want = jsd.pack_write(jnp.asarray(ids),
                          jnp.asarray(lines).astype(jnp.bfloat16), 3)
    got = tsd.pack_write(torch.from_numpy(ids),
                         torch.from_numpy(lines).to(torch.bfloat16), 3)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    # lines 0 and 1 have one contributor; line 2 sums three bf16 rows,
    # which XLA may add in f32 before rounding: one bf16 ulp (2^-7)
    np.testing.assert_array_equal(got[:2], want[:2])
    np.testing.assert_allclose(got[2], want[2], rtol=2.0 ** -7, atol=1e-2)


def test_position_lines_matches_jax():
    rng = np.random.default_rng(2)
    for dim in (8, 16, 32):
        q = 128 // dim
        ids = rng.integers(-3, 500, 64).astype(np.int32)
        g = rng.standard_normal((64, dim)).astype(np.float32)
        want = jsd._position_lines(jnp.asarray(ids), jnp.asarray(g), q, dim)
        got = tsd._position_lines(torch.from_numpy(ids).long(),
                                  torch.from_numpy(g), q, dim)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _lookup_both(w, ids, dim):
    tbl = np.array(jsd.pack_table(w))
    want = np.asarray(jsd.packed_lookup(jnp.asarray(tbl), jnp.asarray(ids),
                                        dim))
    got = tsd.packed_lookup(torch.from_numpy(tbl), torch.from_numpy(ids),
                            dim)
    return got, want


@pytest.mark.parametrize("dim", [8, 16, 32])
def test_packed_lookup_forward_matches_jax(dim):
    rng = np.random.default_rng(dim)
    rows = 640 + 3  # a partly used tail line
    w = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = rng.integers(0, rows, (4, 7)).astype(np.int32)
    ids[0, 0] = rows - 1
    got, want = _lookup_both(w, ids, dim)
    assert tuple(got.shape) == (4, 7, dim)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w[ids])


@pytest.mark.parametrize("dim", [8, 16, 32])
def test_packed_lookup_vjp_matches_jax(dim):
    """Duplicate ids, same-line collisions and negative ids: the cases the
    merge and the write-only kernel exist for."""
    rng = np.random.default_rng(100 + dim)
    rows = 640
    q = 128 // dim
    w = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, rows, 58),
                          [5, 5, 6, 7, 12, 100, -1, -4, q, q + 1]]).astype(
        np.int32)
    ct = rng.standard_normal((len(ids), dim)).astype(np.float32)
    tbl = np.array(jsd.pack_table(w))
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jsd.packed_lookup(t, jnp.asarray(ids), dim) * jnp.asarray(ct)))(
        jnp.asarray(tbl)))
    t = torch.from_numpy(tbl).requires_grad_()
    out = tsd.packed_lookup(t, torch.from_numpy(ids), dim)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(ct))
    valid = ids[ids >= 0]
    counts = np.bincount(valid // q, minlength=tbl.shape[0])
    _assert_lines(got.numpy(), want, counts)
    # against the gradient of a plain row gather, negatives dropped
    ref = np.zeros_like(w)
    np.add.at(ref, valid, ct[ids >= 0])
    np.testing.assert_allclose(tsd.unpack_table(got, rows, dim).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dim", [8, 16, 32])
def test_packed_lookup_nan_stays_in_its_row(dim):
    """A NaN or Inf row leaks into no other row of its 128-lane line, in
    either package; looking it up returns it."""
    rng = np.random.default_rng(7)
    q = 128 // dim
    w = rng.standard_normal((4 * q, dim)).astype(np.float32)
    w[q + 1, 0] = np.nan        # line 1
    w[2 * q + q - 1, :] = np.inf  # line 2, last slot
    ids = np.array([q, q + 1, q + 2, 2 * q, 2 * q + q - 1, 0], np.int32)
    got, want = _lookup_both(w, ids, dim)
    np.testing.assert_array_equal(got.numpy(), want)  # NaN == NaN here
    ok = [0, 2, 3, 5]
    assert np.isfinite(got.numpy()[ok]).all()
    np.testing.assert_array_equal(got.numpy()[ok], w[ids[ok]])
    assert np.isnan(got.numpy()[1, 0]) and np.isinf(got.numpy()[4]).all()


def test_packed_lookup_negative_ids_clamp_to_row_zero():
    """Padding ids follow the IndexedSlices convention in both packages:
    the forward returns logical row 0, the backward drops them."""
    rng = np.random.default_rng(0)
    rows, dim = 64, 16
    w = rng.standard_normal((rows, dim)).astype(np.float32)
    ids = np.array([3, -1, 7, -5, 0], np.int32)
    got, want = _lookup_both(w, ids, dim)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), w[np.maximum(ids, 0)])
    t = torch.from_numpy(np.array(jsd.pack_table(w))).requires_grad_()
    ct = rng.standard_normal((5, dim)).astype(np.float32)
    (g,) = torch.autograd.grad(
        tsd.packed_lookup(t, torch.from_numpy(ids), dim), t,
        torch.from_numpy(ct))
    ref = np.zeros_like(w)
    for i, r in zip(ids, ct):
        if i >= 0:
            ref[i] += r
    np.testing.assert_array_equal(tsd.unpack_table(g, rows, dim).numpy(),
                                  ref)
