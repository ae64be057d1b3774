"""The port's fused softmax-CE forward against the JAX package's Pallas
kernel (``fused_softmax_ce_sparse``, interpret mode on the CPU).

Tolerances: f32 logits atol 1e-5 (both sides sum exp in f32, in another
order); bf16 logits are upcast exactly on both sides, so the same
tolerance holds, scaled by the larger logits (atol 1e-4).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hetu_tpu.ops.pallas import softmax_ce as jce
from hetu_tpu_torch.ops import losses as tlosses
from hetu_tpu_torch.ops.kernels import softmax_ce as tce


def _inputs(seed, N, V, ignored_frac=0.15):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((N, V))).astype(np.float32)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < ignored_frac] = -1
    return x, labels


@pytest.mark.parametrize("N", [8, 300])
@pytest.mark.parametrize("V", [1024, 3000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ce_matches_pallas(N, V, dtype):
    x, labels = _inputs(N + V, N, V)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(jce.fused_softmax_ce_sparse(xj, jnp.asarray(labels)))
    # the same (rounded) values on both sides
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = tce.fused_softmax_ce_sparse(xt, torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (N,)
    assert np.all(got.numpy()[labels == -1] == 0.0)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 if dtype == "float32" else 1e-4)


def test_ce_lse_and_out_of_range_label():
    """Ignored rows still get their lse; a label outside [0, V) picks
    nothing, so its loss is the lse — as the Pallas kernel computes."""
    N, V = 16, 3000
    x, labels = _inputs(3, N, V)
    labels[0], labels[1] = V + 5, -7
    loss_j, lse_j = jce._fwd(jnp.asarray(x), jnp.asarray(labels), -1)
    loss, lse = tce.softmax_ce_fwd(torch.from_numpy(x),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), atol=1e-5)
    np.testing.assert_allclose(loss.numpy()[:2], lse.numpy()[:2])


@pytest.mark.parametrize("N,V", [(4, 3000), (300, 1000)])
def test_ce_gate_declines_small_shapes(N, V):
    """V < 1024 or N < 8: both packages decline the kernel and the op
    runs the plain form (which clamps a negative label to column 0)."""
    x, labels = _inputs(N * V, N, V)
    assert jce.fused_softmax_ce_sparse(jnp.asarray(x),
                                       jnp.asarray(labels)) is None
    xt, lt = torch.from_numpy(x), torch.from_numpy(labels)
    assert tce.fused_softmax_ce_sparse(xt, lt) is None
    from hetu_tpu.ops import losses as jlosses
    want = jlosses._softmax_cross_entropy_sparse(jnp.asarray(x),
                                                 jnp.asarray(labels))
    got = tlosses._softmax_cross_entropy_sparse(xt, lt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ce_refuses_backward():
    """The raw forward has no backward: it refuses logits that require
    grad (``SoftmaxCEFn`` is the differentiable form)."""
    x = torch.zeros(8, 1024, requires_grad=True)
    with pytest.raises(RuntimeError, match="SoftmaxCEFn"):
        tce.softmax_ce_fwd(x, torch.zeros(8, dtype=torch.int32))
