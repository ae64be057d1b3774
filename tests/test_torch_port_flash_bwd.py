"""The port's flash-attention backward and dropout on the CPU, held against
the JAX package.

* keep 1: ``flash_attention_bwd_plain`` against ``jax.vjp`` through
  ``hetu_tpu``'s ``flash_attention``, whose custom VJP runs the Pallas
  ``_bwd_impl`` kernels in interpret mode (the wrapper pads S=200 to the
  kernel's tiles), on the same numpy inputs and cotangent.
* dropout: the keep matrix from ``dropout_keep_mask_plain`` drives a jnp
  reference of dropout attention (as
  ``tests/test_flash_attention.py::test_dropout_replay_matches_extracted_mask``
  does with the TPU kernel's extracted masks); its output and ``jax.vjp``
  gradients are compared with the port's plain forward and backward for
  the same seed.
* the keep bits themselves: the int64 tensor hash against the same hash
  in Python's unbounded integers masked to 32 bits, their statistics, and
  their dependence on each of seed, bh, row and col.

Tolerance: f32 atol 2e-5 on o, dq, dk and dv (both sides accumulate in
f32; only the order of the sums differs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hetu_tpu.ops.pallas import flash_attention as jfa
from hetu_tpu_torch.ops.kernels import flash_attention as tfa

ATOL = 2e-5


def _inputs(seed, B, H, S, D, mask_kind):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    mask = None
    if mask_kind == "bert":
        # key 0 stays live (BERT's CLS token): a causal row whose every
        # visible key sits at -10000 has scores near -14427 in base 2,
        # where f32 keeps ~1e-3, and both packages then differ from the
        # exact gradient by ~1e-3
        mask = np.where(rng.random((B, 1, 1, S)) < 0.25, -10000.0,
                        0.0).astype(np.float32)
        mask[..., 0] = 0.0
    elif mask_kind == "empty_row":
        # batch 0 keeps a padding mask; batch 1 has every key masked
        mask = np.where(rng.random((B, 1, 1, S)) < 0.25, -1e30,
                        0.0).astype(np.float32)
        mask[1] = -1e30
    return q, k, v, do, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _jax_grads(q, k, v, do, mask, causal):
    def f(q, k, v):
        return jfa.flash_attention(q, k, v, mask=None if mask is None
                                   else jnp.asarray(mask), causal=causal)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_grads(q, k, v, do, mask, causal, keep=1.0, seed=None):
    o, lse = tfa.flash_attention_plain(_t(q), _t(k), _t(v), mask=_t(mask),
                                       causal=causal, dropout_keep=keep,
                                       seed=seed)
    grads = tfa.flash_attention_bwd_plain(
        _t(q), _t(k), _t(v), o, lse, _t(do), mask=_t(mask), causal=causal,
        dropout_keep=keep, seed=seed)
    return [o.numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("S,D", [(256, 64), (200, 40)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mask_kind", [None, "bert"])
def test_flash_bwd_matches_pallas(S, D, causal, mask_kind):
    q, k, v, do, mask = _inputs(S + D, 1, 1, S, D, mask_kind)
    want = _jax_grads(q, k, v, do, mask, causal)
    got = _port_grads(q, k, v, do, mask, causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def test_flash_bwd_fully_masked_rows():
    """Every key of batch 1 masked: lse = +1e30 there, so P = 0 and every
    gradient of batch 1 is 0 on both sides; batch 0 still matches."""
    q, k, v, do, mask = _inputs(7, 2, 2, 256, 64, "empty_row")
    want = _jax_grads(q, k, v, do, mask, False)
    got = _port_grads(q, k, v, do, mask, False)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.all(a[1] == 0.0), name
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def test_flash_autograd_fn_runs_the_plain_backward_on_cpu():
    """``flash_attention`` (FlashAttentionFn) under torch.autograd gives
    the plain backward's gradients, and a zero gradient for the mask."""
    q, k, v, do, mask = _inputs(3, 1, 2, 256, 64, "bert")
    ts = [_t(a).requires_grad_() for a in (q, k, v, mask)]
    o = tfa.flash_attention(*ts[:3], mask=ts[3])
    grads = torch.autograd.grad(o, ts, _t(do))
    want = _port_grads(q, k, v, do, mask, False)
    np.testing.assert_array_equal(o.detach().numpy(), want[0])
    for g, w in zip(grads[:3], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert torch.all(grads[3] == 0)


def _ref_dropout_attention(mask, causal, keep_mat, keep):
    def f(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
        if mask is not None:
            s = s + jnp.asarray(mask)
        if causal:
            n = s.shape[-1]
            s = jnp.where(jnp.tril(jnp.ones((n, n), bool)), s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(keep_mat, p / keep, 0.0)
        return jnp.einsum("bhqk,bhkd->bhqd", p, v)
    return f


@pytest.mark.parametrize("S,D,causal,mask_kind", [
    (256, 64, False, "bert"), (200, 40, True, None), (256, 64, True, "bert")])
def test_flash_dropout_matches_reference_with_replayed_mask(S, D, causal,
                                                            mask_kind):
    B, H, keep = 2, 2, 0.9
    q, k, v, do, mask = _inputs(S * D, B, H, S, D, mask_kind)
    seed = torch.tensor([-123456789], dtype=torch.int32)
    keep_mat = tfa.dropout_keep_mask_plain(seed, B * H, S, S, keep).reshape(
        B, H, S, S).numpy()
    f = _ref_dropout_attention(mask, causal, keep_mat, keep)
    o, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    got = _port_grads(q, k, v, do, mask, causal, keep=keep, seed=seed)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)
    # the mask really dropped something: without it the output differs
    o_nodrop = _port_grads(q, k, v, do, mask, causal)[0]
    assert np.abs(o_nodrop - got[0]).max() > 1e-2


def _fmix(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _mix(h, x):
    return _fmix(((h ^ x) + 0x9E3779B9) & 0xFFFFFFFF)


def test_keep_bits_match_unbounded_integer_hash():
    """The int64 tensor hash equals the uint32 hash computed with Python's
    unbounded integers (so no product overflowed): over a whole small mask,
    and at coordinates near the top of their ranges for extreme seeds."""
    thr = tfa.keep_threshold(0.7)
    seed = -987654321
    got = tfa.dropout_keep_mask_plain(seed, 3, 5, 7, 0.7)
    want = np.zeros((3, 5, 7), bool)
    for b in range(3):
        for r in range(5):
            rk = _mix(_mix(_fmix(seed & 0xFFFFFFFF), b), r)
            for c in range(7):
                want[b, r, c] = _mix(rk, c) < thr
    np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(5)
    coords = rng.integers(2**31 - 2**20, 2**31, (3, 64))
    for seed in (-2**31, -1, 0, 2**31 - 1, int(rng.integers(-2**31, 2**31))):
        bh, row, col = (torch.from_numpy(c) for c in coords)
        h = tfa._fmix32(torch.tensor(seed).long() & 0xFFFFFFFF)
        bits = tfa._mix(tfa._mix(tfa._mix(h, bh), row), col)
        want = [_mix(_mix(_mix(_fmix(seed & 0xFFFFFFFF), int(b)), int(r)),
                     int(c)) for b, r, c in coords.T]
        assert bits.tolist() == want


def test_keep_bits_statistics_and_dependence():
    keep, shape = 0.9, (8, 256, 256)
    seed = torch.tensor([42], dtype=torch.int32)
    m = tfa.dropout_keep_mask_plain(seed, *shape, keep)
    n = m.numel()
    frac = m.float().mean().item()
    assert abs(frac - keep) < 4 * np.sqrt(keep * (1 - keep) / n)
    # stable across calls, and the same for an int seed
    assert torch.equal(m, tfa.dropout_keep_mask_plain(seed, *shape, keep))
    assert torch.equal(m, tfa.dropout_keep_mask_plain(42, *shape, keep))
    # changing any one of seed, bh, row, col changes the bits: about
    # 2 keep (1 - keep) of them differ between independent masks
    other = tfa.dropout_keep_mask_plain(43, *shape, keep)
    pairs = [(m, other), (m[0], m[1]), (m[:, 0], m[:, 1]),
             (m[..., 0], m[..., 1])]
    for a, b in pairs:
        differ = (a != b).float().mean().item()
        assert 0.1 < differ < 0.26, differ
    assert tfa.keep_threshold(1.0) == 2**32 - 1
    assert tfa.keep_threshold(0.9) == int(0.9 * 2**32)


def test_flash_fwd_dropout_keeps_undropped_row_sums():
    """O = dropout(softmax(S)) V: with V = 1 every output row is the kept
    share of its (undropped-normalised) probabilities scaled by 1/keep."""
    B, H, S, D, keep = 1, 2, 256, 64, 0.8
    q, k, _, _, _ = _inputs(9, B, H, S, D, None)
    v = torch.ones(B, H, S, D)
    seed = torch.tensor([7], dtype=torch.int32)
    o, _ = tfa.flash_attention_fwd(_t(q), _t(k), v, dropout_keep=keep,
                                   seed=seed)
    s = torch.from_numpy(q) @ torch.from_numpy(k).transpose(-1, -2) / 8.0
    p = torch.softmax(s, -1)
    mask = tfa.dropout_keep_mask_plain(seed, B * H, S, S, keep).reshape(
        B, H, S, S)
    want = (p * mask).sum(-1) / keep
    torch.testing.assert_close(o[..., 0], want, atol=1e-5, rtol=0)
