"""The port's blockwise flash attention (the ring's block API) on the CPU,
held against the JAX package's ``flash_attention_block`` and
``flash_attention_block_bwd``, whose Pallas kernels run in interpret mode.

B=1, H=2, f32, at Sq = Sk = 128 and at Sq = 128 with Sk = 256, at the
full, diagonal, empty and partial offsets, at d = 32 and at GPT-3 2.7B's
d = 80 (the head whose blockwise dQ and dK/dV the card's wgmma kernels
hold to these plain versions).  The backward gets what a
ring gives it: the (o, lse) of the block combined by logaddexp with the
q block's own diagonal block, so no row is empty, and a random cotangent.
Tolerance: atol 1e-5 on o, lse, dq, dk and dv (f32 on both sides; only
the order of the sums differs); a row with no live key in the block has
lse = -1e30 and o = 0 exactly.  Port-only cases: ``ring=(n, r)`` equals
its ranks' block pairs one by one, and rows with no live key inside a kv
tile the kernel runs keep the contract, where the TPU kernel gives them
weight (ROADMAP §3, fault 2).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hetu_tpu.ops.pallas import flash_attention as jfa
from hetu_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 1e-5
B, H, D = 1, 2, 32


def _rand(rng, s, d=D):
    return rng.standard_normal((B, H, s, d)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# (sq, sk, q_off, k_off): full, diagonal, empty and partial blocks
CASES = {
    "128-full": (128, 128, 128, 0),
    "128-diagonal": (128, 128, 0, 0),
    "128-empty": (128, 128, 0, 128),
    "128-partial": (128, 128, 128, 64),
    "sk256-full": (128, 256, 256, 0),
    "sk256-diagonal": (128, 256, 0, 0),
    "sk256-empty": (128, 256, 0, 128),
    "sk256-partial": (128, 256, 128, 0),
}


@pytest.mark.parametrize(
    "case, d", [(c, d) for d in (D, 80) for c in CASES],
    ids=[c if d == D else f"d80-{c}" for d in (D, 80) for c in CASES])
def test_block_matches_pallas(case, d):
    idx = sorted(CASES).index(case)
    rng = np.random.default_rng(idx if d == D else (80, idx))
    sq, sk, q_off, k_off = CASES[case]
    q, do, kd, vd = (_rand(rng, sq, d) for _ in range(4))
    k, v = _rand(rng, sk, d), _rand(rng, sk, d)
    o_j, lse_j = jfa.flash_attention_block(q, k, v, jnp.int32(q_off),
                                           jnp.int32(k_off))
    o_t, lse_t = tfa.flash_attention_block(_t(q), _t(k), _t(v), q_off, k_off)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL)
    empty = np.asarray(lse_j) == np.float32(-1e30)
    assert (lse_t.numpy()[empty] == np.float32(-1e30)).all()
    assert (o_t.numpy()[empty] == 0).all()
    if case.endswith("empty"):
        assert empty.all()

    # the ring's combined (o, lse): this block and q's own diagonal block
    o_d, lse_d = jfa.flash_attention_block(q, kd, vd, jnp.int32(q_off),
                                           jnp.int32(q_off))
    lse_c = jnp.logaddexp(lse_j, lse_d)
    o_c = (o_j * jnp.exp(lse_j - lse_c)[..., None]
           + o_d * jnp.exp(lse_d - lse_c)[..., None])
    g_j = jfa.flash_attention_block_bwd(q, k, v, o_c, lse_c, do,
                                        jnp.int32(q_off), jnp.int32(k_off))
    g_t = tfa.flash_attention_block_bwd(_t(q), _t(k), _t(v), _t(o_c),
                                        _t(lse_c), _t(do), q_off, k_off)
    for got, want in zip(g_t, g_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if case.endswith("empty"):
        assert all((g.numpy() == 0).all() for g in g_t)


@pytest.mark.parametrize("r", range(4))
def test_ring_step_equals_its_block_pairs(r):
    """One ``ring=(4, r)`` call equals the four ranks' pairs one by one:
    rank g's q rows attend rank (g - r) mod 4's K/V rows at their global
    offsets, and each block's dK/dV land at its own rows."""
    rng = np.random.default_rng(20 + r)
    n, s = 4, 128
    q, k, v, do = (_t(_rand(rng, n * s)) for _ in range(4))
    lse = _t(rng.standard_normal((B, H, n * s)).astype(np.float32) + 8.0)
    dsum = _t(rng.standard_normal((B, H, n * s)).astype(np.float32))
    o, l = tfa.flash_attention_block(q, k, v, 0, 0, ring=(n, r))
    dq = tfa.flash_attention_block_bwd_dq(q, k, v, do, lse, dsum, 0, 0,
                                          ring=(n, r))
    dk, dv = tfa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum, 0, 0,
                                               ring=(n, r))
    for g in range(n):
        src = (g - r) % n
        qs, ks = slice(g * s, (g + 1) * s), slice(src * s, (src + 1) * s)
        o_g, l_g = tfa.flash_attention_block(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], g * s, src * s)
        assert torch.equal(o[:, :, qs], o_g) and torch.equal(l[:, :, qs], l_g)
        dq_g = tfa.flash_attention_block_bwd_dq(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], do[:, :, qs],
            lse[:, :, qs], dsum[:, :, qs], g * s, src * s)
        dk_g, dv_g = tfa.flash_attention_block_bwd_dkv(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], do[:, :, qs],
            lse[:, :, qs], dsum[:, :, qs], g * s, src * s)
        assert torch.equal(dq[:, :, qs], dq_g)
        assert torch.equal(dk[:, :, ks], dk_g)
        assert torch.equal(dv[:, :, ks], dv_g)
    if r:  # ranks g < r hold a block wholly above their diagonal
        assert (l[:, :, :r * s] == -1e30).all()
        assert (o[:, :, :r * s] == 0).all()


def test_rows_without_a_live_key_keep_the_block_contract():
    """K/V at offset 32 against q at 0: rows 0-31 see no key, inside the
    first kv tile the kernel runs.  The port gives them lse = -1e30 and
    o = 0; the TPU kernel, whose excluded scores sit at its running-max
    floor, weighs the excluded keys (fault 2) and gives another lse."""
    rng = np.random.default_rng(31)
    q, k, v = (_rand(rng, 128) for _ in range(3))
    o_t, lse_t = tfa.flash_attention_block(_t(q), _t(k), _t(v), 0, 32)
    assert (lse_t[:, :, :32] == -1e30).all() and (o_t[:, :, :32] == 0).all()
    assert (lse_t[:, :, 32:] > -1e29).all()
    _, lse_j = jfa.flash_attention_block(q, k, v, jnp.int32(0),
                                         jnp.int32(32))
    assert (np.asarray(lse_j)[:, :, :32] != np.float32(-1e30)).all()
    np.testing.assert_allclose(lse_t.numpy()[:, :, 32:],
                               np.asarray(lse_j)[:, :, 32:], atol=ATOL)


def test_blockwise_gate_matches_jax():
    for q_shape, k_shape in (((1, 2, 128, 32), (1, 2, 256, 32)),
                             ((1, 2, 128, 16), (1, 2, 128, 16)),
                             ((1, 2, 96, 64), (1, 2, 128, 64)),
                             ((1, 2, 384, 520), (1, 2, 384, 520)),
                             ((1, 2, 640, 40), (1, 2, 640, 40))):
        assert (tfa.blockwise_supported(q_shape, k_shape)
                == jfa.blockwise_supported(q_shape, k_shape))
        assert tfa._block_sizes(q_shape[2], k_shape[2]) == \
            jfa._block_sizes(q_shape[2], k_shape[2])
