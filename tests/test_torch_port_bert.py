"""BERT pretraining evaluation through both packages' Executors on the CPU.

A 2-layer, hidden-64, 4-head, S=128, V=1100 BERT is built with each
package's graph API; the JAX executor's params carry across with
``Executor.load_params`` (weights.params_from_jax), and the same numpy
batch goes through both ``validate`` subgraphs.  At S=128 both run the
attention composition; the MLM head's CE (a 128-row bucket x V=1100) runs
the JAX package's Pallas kernel in interpret mode and the port's plain
version of its kernel.

Tolerances: f32 loss rtol 1e-5 and logits atol 1e-4 (same arithmetic,
another summation order).  bf16 compute: both packages round every
activation to bf16 (8 bits of mantissa) but at different places (XLA
fuses, PyTorch rounds each op's output), so the loss is held to rtol 2e-3
and the logits, which stay below 1 in magnitude (a bf16 ulp of 2^-8 near
0.8), to atol 3e-2: a few ulps of differently placed rounding.  The bf16
test also repeats the overflow-counter check.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm

B, S, L, H, NH, V = 2, 128, 2, 64, 4, 1100


def _build(pkg, models):
    ids = pkg.placeholder_op("input_ids", (B, S), dtype=np.int32)
    tt = pkg.placeholder_op("token_type_ids", (B, S), dtype=np.int32)
    am = pkg.placeholder_op("attention_mask", (B, S))
    ml = pkg.placeholder_op("mlm_labels", (B * S,), dtype=np.int32)
    nl = pkg.placeholder_op("nsp_labels", (B,), dtype=np.int32)
    cfg = models.BertConfig(vocab_size=V, hidden_size=H, num_hidden_layers=L,
                            num_attention_heads=NH, intermediate_size=4 * H,
                            seq_len=S, max_position_embeddings=S)
    # `loss` names its MLM overflow counter outside the model's own scope;
    # a fresh scope keeps that name independent of what the process built
    # before (other test files in the same worker)
    with pkg.name_scope():
        model = models.BertForPreTraining(cfg)
        return (model.loss(ids, tt, am, ml, nl), list(model(ids, tt, am)))


def _batch(seed, mask_rate=0.15):
    rng = np.random.default_rng(seed)
    am = np.ones((B, S), np.float32)
    am[1, 100:] = 0.0
    ml = np.full(B * S, -1, np.int32)
    pos = rng.random(B * S) < mask_rate
    ml[pos] = rng.integers(0, V, pos.sum())
    return {"input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
            "token_type_ids": rng.integers(0, 2, (B, S)).astype(np.int32),
            "attention_mask": am, "mlm_labels": ml,
            "nsp_labels": rng.integers(0, 2, B).astype(np.int32)}


@pytest.fixture(scope="module")
def pair():
    j_loss, j_logits = _build(jt, jm)
    t_loss, t_logits = _build(pt, pm)
    jex = jt.Executor({"validate": [j_loss], "logits": j_logits})
    params = {k: np.asarray(v) for k, v in jex.params.items()}
    tex = pt.Executor({"validate": [t_loss], "logits": t_logits},
                      device="cpu")
    tex.load_params(params)
    return jex, tex, params, (j_loss, j_logits, t_loss, t_logits)


def test_same_variable_names_and_shapes(pair):
    jex, tex, _, _ = pair
    assert {k: tuple(v.shape) for k, v in jex.params.items()} == \
        {k: tuple(v.shape) for k, v in tex.params.items()}


def test_loss_and_logits_match_f32(pair):
    jex, tex, _, _ = pair
    feed = _batch(0)
    (want,) = jex.run("validate", feed_dict=feed,
                      convert_to_numpy_ret_vals=True)
    (got,) = tex.run("validate", feed_dict=feed,
                     convert_to_numpy_ret_vals=True)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    logits_j = jex.run("logits", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
    logits_t = tex.run("logits", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
    for a, b in zip(logits_t, logits_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_mlm_overflow_counter_matches(pair):
    """A batch that masks more positions than the 128-row bucket: both
    packages drop the excess from the loss and count it."""
    jex, tex, _, _ = pair
    feed = _batch(1, mask_rate=0.7)
    n_masked = int((feed["mlm_labels"] >= 0).sum())
    assert n_masked > 128
    name = [k for k in tex.params if k.endswith("overflow_total")]
    assert len(name) == 1
    before_j = int(np.asarray(jex.params[name[0]]))
    before_t = int(tex.params[name[0]])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (want,) = jex.run("validate", feed_dict=feed,
                          convert_to_numpy_ret_vals=True)
        (got,) = tex.run("validate", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(np.asarray(jex.params[name[0]])) - before_j == n_masked - 128
    assert int(tex.params[name[0]]) - before_t == n_masked - 128
    assert tex.params[name[0]].dtype == torch.int32


def test_loss_and_logits_match_bf16(pair):
    """The f32 checks again at bf16 compute_dtype over the same f32 params:
    loss, ``__call__`` logits, and the MLM overflow counter."""
    _, _, params, (j_loss, j_logits, t_loss, t_logits) = pair
    jex = jt.Executor({"validate": [j_loss], "logits": j_logits},
                      compute_dtype=jnp.bfloat16)
    jex.params = {k: jnp.asarray(v) for k, v in params.items()}
    tex = pt.Executor({"validate": [t_loss], "logits": t_logits},
                      compute_dtype=torch.bfloat16, device="cpu")
    tex.load_params(params)
    feed = _batch(2)
    (want,) = jex.run("validate", feed_dict=feed,
                      convert_to_numpy_ret_vals=True)
    (got,) = tex.run("validate", feed_dict=feed,
                     convert_to_numpy_ret_vals=True)
    assert tex.params[next(iter(tex.params))].dtype == torch.float32
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    logits_j = jex.run("logits", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
    logits_t = tex.run("logits", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
    for a, b in zip(logits_t, logits_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32), atol=3e-2)

    feed = _batch(1, mask_rate=0.7)
    n_masked = int((feed["mlm_labels"] >= 0).sum())
    assert n_masked > 128
    (name,) = [k for k in tex.params if k.endswith("overflow_total")]
    before_j = int(np.asarray(jex.params[name]))
    before_t = int(tex.params[name])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        (want,) = jex.run("validate", feed_dict=feed,
                          convert_to_numpy_ret_vals=True)
        (got,) = tex.run("validate", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    assert int(np.asarray(jex.params[name])) - before_j == n_masked - 128
    assert int(tex.params[name]) - before_t == n_masked - 128
    assert tex.params[name].dtype == torch.int32


def test_load_params_refuses_mismatch(pair):
    _, tex, params, _ = pair
    with pytest.raises(ValueError, match="missing"):
        tex.load_params({k: v for k, v in list(params.items())[1:]})
    with pytest.raises(ValueError, match="extra"):
        tex.load_params(dict(params, stray=np.zeros(3, np.float32)))
    name = next(k for k, v in params.items()
                if v.ndim == 2 and v.shape[0] != v.shape[1])
    with pytest.raises(ValueError, match="shape"):
        tex.load_params(dict(params, **{name: params[name].T}))
