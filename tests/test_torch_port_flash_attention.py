"""The port's flash-attention forward against the JAX package's Pallas
kernel, run in interpret mode on the CPU.

The same numpy inputs go through ``hetu_tpu``'s ``flash_attention`` (o)
and ``_fwd`` (lse) and through ``hetu_tpu_torch``'s wrapper, which on a
CPU tensor runs the kernel's plain PyTorch version.  Tolerance: f32 atol
2e-5 (both sides accumulate in f32; only the order of the sums differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hetu_tpu.ops.pallas import flash_attention as jfa
from hetu_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 2e-5


def _inputs(seed, B, H, S, D, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    mask = None
    if mask_kind == "bert":
        mask = np.where(rng.random((B, 1, 1, S)) < 0.25, -10000.0,
                        0.0).astype(np.float32)
    elif mask_kind == "empty_row":
        # batch 0 keeps a padding mask; batch 1 has every key masked
        mask = np.where(rng.random((B, 1, 1, S)) < 0.25, -1e30,
                        0.0).astype(np.float32)
        mask[1] = -1e30
    return q, k, v, mask


def _port(q, k, v, mask, causal):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return tfa.flash_attention_fwd(t(q), t(k), t(v), mask=t(mask),
                                   causal=causal)


@pytest.mark.parametrize("S", [128, 256, 200])
@pytest.mark.parametrize("D", [64, 40, 80])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "bert"])
def test_flash_output_matches_pallas(S, D, causal, mask_kind):
    q, k, v, mask = _inputs(S + D, 1, 2, S, D, mask_kind)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               mask=None if mask is None else jnp.asarray(mask),
                               causal=causal)
    o, lse = _port(q, k, v, mask, causal)
    assert o.dtype == torch.float32 and lse.shape == (1, 2, S)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "bert"])
def test_flash_lse_matches_pallas(S, causal, mask_kind):
    B, H, D = 2, 2, 64
    q, k, v, mask = _inputs(S, B, H, S, D, mask_kind)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if mask is None else jnp.asarray(mask),
                          causal, 1.0 / np.sqrt(D), block_q=S, block_k=S)
    o, lse = _port(q, k, v, mask, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_j).reshape(B, H, S),
                               atol=ATOL, rtol=1e-6)


def test_flash_fully_masked_rows():
    """Every key of batch 1 masked: o = 0 and lse = +1e30, as the TPU
    kernel writes them; batch 0 still matches."""
    B, H, S, D = 2, 2, 256, 64
    q, k, v, mask = _inputs(7, B, H, S, D, "empty_row")
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(mask), False, 1.0 / np.sqrt(D),
                          block_q=S, block_k=S)
    o, lse = _port(q, k, v, mask, False)
    assert np.all(o.numpy()[1] == 0.0)
    assert np.all(lse.numpy()[1] == tfa.EMPTY_LSE)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(lse_j).reshape(B, H, S), rtol=1e-6)


def test_flash_fully_masked_rows_causal():
    """Causal with every key masked: the port keeps the empty-row contract
    (o = 0, lse = +1e30).  The Pallas kernel does not here: it fills
    causally excluded scores with -1e30, the same value as its running-max
    floor, so they get weight exp2(0) = 1 and row i returns the mean of
    the future rows v[i+1:] of its kv block (ROADMAP queue 3)."""
    B, H, S, D = 1, 1, 256, 64
    q, k, v, _ = _inputs(11, B, H, S, D, None)
    mask = np.full((B, 1, 1, S), -1e30, np.float32)
    o_j = np.asarray(jfa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask), causal=True))
    np.testing.assert_allclose(o_j[0, 0, 0], v[0, 0, 1:].mean(0), atol=1e-5)
    o, lse = _port(q, k, v, mask, True)
    assert np.all(o.numpy() == 0.0)
    assert np.all(lse.numpy() == tfa.EMPTY_LSE)


@pytest.mark.parametrize("shape,mask_shape", [
    ((1, 2, 64, 64), None),              # S < 128: the composition is cheaper
    ((1, 2, 256, 520), None),            # d > 512
    ((1, 2, 256, 64), (1, 1, 256, 256)),  # not a [B,1,1,S] key mask
])
def test_flash_envelope_returns_none(shape, mask_shape):
    q = np.zeros(shape, np.float32)
    mask = None if mask_shape is None else np.zeros(mask_shape, np.float32)
    assert jfa.flash_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                               mask=None if mask is None
                               else jnp.asarray(mask)) is None
    assert _port(q, q, q, mask, False) is None


def test_flash_refuses_training_paths():
    """The raw forward has no backward: it refuses inputs that require
    grad (``flash_attention`` is the differentiable form), and dropout
    without a seed tensor."""
    q = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_attention_fwd(q, q, q, dropout_keep=0.9)
    with pytest.raises(RuntimeError, match="flash_attention"):
        tfa.flash_attention_fwd(q.clone().requires_grad_(), q, q)
