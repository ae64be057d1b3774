"""The port's MoE row gather (ops/kernels/moe_dispatch.py) against the JAX
package's (hetu_tpu/ops/pallas/moe_dispatch.py) on the CPU.

On the CPU the JAX ``row_gather`` runs its ``jnp.take`` composition (its
kernel envelope admits the TPU only, and the kernel has no interpret
mode), and the port runs ``row_gather_plain``, the same composition; the
CUDA kernel is held to ``row_gather_plain`` bitwise on the card by
``chip_smoke.py``.

Tolerances: the forward is a copy and is compared bitwise in f32 and bf16.
The backward scatter-adds the cotangent rows: where each source row
receives at most two of them (the MoE use: a token feeds at most k = 2
slots) and zeros, any order of the adds gives the same bits, so it is
compared bitwise too; with many duplicates a row is a sum of up to a few
dozen N(0, 1) terms that the two scatter-adds may take in another order,
held to rtol 1e-6 and atol 1e-6 (a few f32 ulps of the terms).
"""

import numpy as np
import jax
import jax.numpy as jnp
import ml_dtypes
import pytest
import torch

from hetu_tpu.ops.pallas import moe_dispatch as jmd
from hetu_tpu_torch.ops.kernels import moe_dispatch as tmd

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16)}


def _idx(rng, n, m, kind):
    """[m] int32 indices: a slot map (each source at most twice, the rest
    -1, as MoE dispatch makes), or uniform with duplicates; both with -1,
    n, n + 5 and the int32 extremes mixed in."""
    if kind == "slots":
        idx = np.full(m, -1, np.int64)
        src = np.concatenate([rng.permutation(n), rng.permutation(n)])
        take = rng.permutation(m)[:min(int(0.8 * m), 2 * n)]
        idx[take] = src[:take.size]
    else:
        idx = rng.integers(0, n, m)
    idx[:7] = [-1, n, n + 5, -2 ** 31, 2 ** 31 - 1, -n, n - 1]
    return idx.astype(np.int32)


def _to_torch(a, tdt):
    return torch.from_numpy(np.array(a, np.float32)).to(tdt)


def _bits(t):
    """f32 or bf16 tensor -> numpy integers of its bits."""
    return (t.view(torch.int32) if t.dtype == torch.float32
            else t.view(torch.int16)).numpy()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,m,h", [(64, 160, 128), (160, 64, 128),
                                   (33, 50, 256), (40, 12, 96)])
def test_row_gather_plain_matches_jax_bitwise(dtype, n, m, h):
    ndt, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(n * m + h)
    src = rng.standard_normal((n, h)).astype(ndt)
    idx = _idx(rng, n, m, "uniform")
    want = np.asarray(jmd.row_gather(jnp.asarray(src, jdt), jnp.asarray(idx)))
    got = tmd.row_gather_plain(_to_torch(src, tdt), torch.from_numpy(idx))
    assert got.dtype == tdt and tuple(got.shape) == (m, h)
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_to_torch(want, tdt)))
    # out-of-range rows are zero, the others copies
    bad = (idx < 0) | (idx >= n)
    assert (got[torch.from_numpy(bad)] == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_row_gather_backward_matches_jax_bitwise_on_slot_maps(dtype):
    ndt, jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    n, m, h = 48, 120, 128
    src = rng.standard_normal((n, h)).astype(ndt)
    ct = rng.standard_normal((m, h)).astype(ndt)
    idx = _idx(rng, n, m, "slots")
    j_idx = jnp.asarray(idx)
    want = jax.grad(lambda s: jnp.sum(
        jmd.row_gather(s, j_idx).astype(jnp.float32)
        * jnp.asarray(ct, jnp.float32)))(jnp.asarray(src, jdt))
    s = _to_torch(src, tdt).requires_grad_()
    out = tmd.row_gather(s, torch.from_numpy(idx))
    (got,) = torch.autograd.grad(out, s, _to_torch(ct, tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_to_torch(want, tdt)))


def test_row_gather_backward_with_duplicates_matches_jax():
    rng = np.random.default_rng(8)
    n, m, h = 16, 300, 128
    src = rng.standard_normal((n, h)).astype(np.float32)
    ct = rng.standard_normal((m, h)).astype(np.float32)
    idx = _idx(rng, n, m, "uniform")
    j_idx = jnp.asarray(idx)
    want = jax.grad(lambda s: jnp.sum(jmd.row_gather(s, j_idx) * ct))(
        jnp.asarray(src))
    s = torch.from_numpy(src).requires_grad_()
    (got,) = torch.autograd.grad(tmd.row_gather(s, torch.from_numpy(idx)),
                                 s, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # sources that no valid index names get a zero gradient
    named = np.zeros(n, bool)
    named[idx[(idx >= 0) & (idx < n)]] = True
    assert (got[torch.from_numpy(~named)] == 0).all()


@pytest.mark.parametrize("h,dtype,kernel", [
    (512, torch.float32, True), (4096, torch.float32, True),
    (512, torch.bfloat16, True), (4096, torch.bfloat16, True),
    (16384, torch.float32, True), (128, torch.bfloat16, True),
    (96, torch.float32, False), (16512, torch.float32, False),
    (640 + 64, torch.bfloat16, False), (512, torch.float16, False),
    (512, torch.float64, False)])
def test_envelope_gate_is_the_references(h, dtype, kernel, monkeypatch):
    assert tmd._supported((8, h), dtype) is kernel
    # the reference's own gate agrees once its backend check passes
    monkeypatch.setattr(jmd.jax, "default_backend", lambda: "tpu")
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16, torch.float64: np.float64}[dtype]
    assert jmd._supported((8, h), jdt) is kernel


@pytest.mark.parametrize("h", [512, 96])
def test_wrapper_on_cpu_runs_plain_and_launches_nothing(h):
    rng = np.random.default_rng(h)
    src = torch.from_numpy(rng.standard_normal((20, h)).astype(np.float32))
    idx = torch.from_numpy(_idx(rng, 20, 30, "slots"))
    before = tmd.row_gather_kernel.launches
    got = tmd.row_gather(src, idx)
    assert torch.equal(got, tmd.row_gather_plain(src, idx))
    assert tmd.row_gather_kernel.launches == before
    # the index may come as int64 (the MoE slots) with any shape
    assert torch.equal(tmd.row_gather(src, idx.long().reshape(5, 6)), got)


def test_kernel_refuses_what_it_does_not_take():
    src = torch.zeros(4, 128)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tmd.row_gather_kernel(src, idx)
    # importing the module built nothing: the kernel is built at first
    # launch, on the card
    assert tmd._fn == []
