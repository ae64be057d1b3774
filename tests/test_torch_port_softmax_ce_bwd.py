"""The port's softmax-CE backward on the CPU against the JAX package's
Pallas kernel: ``softmax_ce_bwd_plain`` (and ``SoftmaxCEFn`` under
torch.autograd) against ``jax.vjp`` of ``fused_softmax_ce_sparse``, whose
custom VJP runs ``_bwd`` in interpret mode, on the same numpy logits,
labels (ignored and out-of-range among them) and row cotangents.

Tolerances: f32 atol 1e-6 + rtol 2e-6 (the same f32 formula on both
sides; exp and the lse it subtracts may differ in their last bits, a few
f32 ulps of |dx| <= |g| ~ 3); bf16 dx atol 1e-6 + rtol 2^-7 (both sides
round the same f32 value to bf16, and a last-bit difference in exp can
flip that rounding by one ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hetu_tpu.ops.pallas import softmax_ce as jce
from hetu_tpu_torch.ops.kernels import softmax_ce as tce

TOL = {"float32": dict(atol=1e-6, rtol=2e-6),
       "bfloat16": dict(atol=1e-6, rtol=2.0 ** -7)}


def _inputs(seed, N, V, dtype):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((N, V))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < 0.15] = -1
    labels[0] = V + 5            # out of range: no one-hot column
    labels[1] = -7               # negative but not ignored: likewise
    g = rng.standard_normal(N).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    # the same (rounded) values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xj, xt, labels, g


@pytest.mark.parametrize("N", [8, 300])
@pytest.mark.parametrize("V", [1024, 3000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_bwd_matches_pallas(N, V, dtype):
    xj, xt, labels, g = _inputs(N * V, N, V, dtype)
    _, vjp = jax.vjp(lambda x: jce.fused_softmax_ce_sparse(
        x, jnp.asarray(labels)), xj)
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want.astype(jnp.float32))
    lab = torch.from_numpy(labels)
    _, lse = tce.softmax_ce_fwd(xt, lab)
    got = tce.softmax_ce_bwd(xt, lab, lse, torch.from_numpy(g))
    assert got.dtype == xt.dtype and got.shape == (N, V)
    assert torch.all(got[lab == -1] == 0)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    # the same gradient through the autograd function
    xg = xt.clone().requires_grad_()
    loss = tce.fused_softmax_ce_sparse(xg, lab)
    (dx,) = torch.autograd.grad(loss, xg, torch.from_numpy(g))
    assert torch.equal(dx, got)


def test_ce_bwd_rows_sum_to_zero_for_in_range_labels():
    """For a live in-range label, sum_v dx = (sum_v p - 1) g = 0."""
    _, xt, labels, g = _inputs(1, 64, 2048, "float32")
    lab = torch.from_numpy(labels)
    _, lse = tce.softmax_ce_fwd(xt, lab)
    dx = tce.softmax_ce_bwd_plain(xt, lab, lse, torch.from_numpy(g))
    live = (lab >= 0) & (lab < 2048)
    torch.testing.assert_close(dx.sum(-1)[live],
                               torch.zeros(int(live.sum())),
                               atol=1e-5, rtol=0)
