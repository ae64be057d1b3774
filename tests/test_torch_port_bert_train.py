"""The BERT pretraining step through both packages' Executors on the CPU.

A 2-layer, hidden-64, 4-head, S=128, V=1100 BERT with dropout 0 is built
with each package's graph API; the JAX executor's params carry across with
``Executor.load_params`` (weights.params_from_jax).  Both run
``AdamWOptimizer(1e-3, weight_decay=0.01).minimize(loss)`` in a ``train``
subgraph on the same numpy batches, plus a ``grads`` subgraph of
``gradients(loss, vars)``.  At S=128 both run the attention composition;
the MLM head's CE (a 128-row bucket x V=1100) runs the JAX package's
Pallas forward and backward in interpret mode and the port's plain
versions of its two kernels.

Tolerances, f32: loss rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-6
of the largest gradient of the model (the same arithmetic in another
summation order; the atol covers entries that cancel to near zero, such as
the attention key biases, whose gradient is zero in exact arithmetic
because softmax ignores a constant added to a row); params after 3 steps
atol 1e-5, and each param's change over the 3 steps within 1e-4 of JAX's
change, relative, in the 2-norm (readings up to 8.7e-6).  The key biases
are held to atol 6 lr only: Adam moves an entry by ~lr whatever its
gradient's size, so noise-level gradients of either sign move the two
packages' key biases apart by up to 2 lr per step.  bf16 compute over f32
masters: both packages round every activation to bf16 (8 bits) at
different places (XLA fuses, PyTorch rounds each op's output), so the
loss is held to rtol 2e-3, and each param's change over the 3 steps
(param minus its init) to within 0.3 of JAX's change, relative, in the
2-norm (readings: median 0.038, largest 0.19, on a layer-norm bias
whose gradient is small; where a bf16 gradient is near zero the two
packages may see it with opposite signs).  A param left unchanged reads
1 and an update of the wrong sign 2, so both fail.  The key biases, whose
change is noise, are held to atol 6 lr as in f32.  Both tests check that
the MLM overflow counter grows by the excess once per step.
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
LR = 1e-3


def _build(pkg, models):
    ids = pkg.placeholder_op("input_ids", (B, S), dtype=np.int32)
    tt = pkg.placeholder_op("token_type_ids", (B, S), dtype=np.int32)
    am = pkg.placeholder_op("attention_mask", (B, S))
    ml = pkg.placeholder_op("mlm_labels", (B * S,), dtype=np.int32)
    nl = pkg.placeholder_op("nsp_labels", (B,), dtype=np.int32)
    cfg = models.BertConfig(vocab_size=V, hidden_size=H, num_hidden_layers=L,
                            num_attention_heads=NH, intermediate_size=4 * H,
                            seq_len=S, max_position_embeddings=S,
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0)
    with pkg.name_scope():
        model = models.BertForPreTraining(cfg)
        loss = model.loss(ids, tt, am, ml, nl)
    xs = pkg.graph_variables([loss], trainable_only=True)
    train_op = pkg.AdamWOptimizer(learning_rate=LR,
                                  weight_decay=0.01).minimize(loss)
    return {"train": [loss, train_op],
            "grads": [loss, *pkg.gradients(loss, xs)]}, xs


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
def graphs():
    return _build(jt, jm), _build(pt, pm)


def _executors(graphs, compute_dtype):
    (j_nodes, _), (t_nodes, t_xs) = graphs
    jex = jt.Executor(j_nodes, compute_dtype=None if compute_dtype is None
                      else jnp.bfloat16)
    params = {k: np.asarray(v) for k, v in jex.params.items()}
    tex = pt.Executor(t_nodes, device="cpu", compute_dtype=compute_dtype)
    tex.load_params(params)
    return jex, tex, t_xs


def _overflow_name(tex):
    (name,) = [k for k in tex.params if k.endswith("overflow_total")]
    return name


def _is_key_bias(name):
    # the key biases' exact gradient is zero (see the module docstring)
    return name.endswith("_attn_k_bias")


def _train_and_compare(jex, tex, xs, loss_rtol, param_atol, delta_rtol):
    """3 train steps, the last batch masking more positions than the
    128-row bucket; compares losses, params, each param's change from its
    init and the overflow counter."""
    counter = _overflow_name(tex)
    init = {v.name: tex.params[v.name].numpy().copy() for v in xs}
    batches = [_batch(1), _batch(2), _batch(3, mask_rate=0.7)]
    excess = [max(0, int((b["mlm_labels"] >= 0).sum()) - 128)
              for b in batches]
    assert excess[-1] > 0
    for step, feed in enumerate(batches):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jex.run("train", feed_dict=feed,
                           convert_to_numpy_ret_vals=True)
            got = tex.run("train", feed_dict=feed,
                          convert_to_numpy_ret_vals=True)
        assert got[1] is None and np.isfinite(got[0])
        np.testing.assert_allclose(got[0], want[0], rtol=loss_rtol)
        assert int(tex.params[counter]) == sum(excess[:step + 1])
        assert int(np.asarray(jex.params[counter])) == sum(excess[:step + 1])
    for v in xs:
        assert tex.params[v.name].dtype == torch.float32
        got = tex.params[v.name].numpy()
        want = np.asarray(jex.params[v.name])
        if _is_key_bias(v.name):
            np.testing.assert_allclose(got, want, atol=6 * LR, err_msg=v.name)
            continue
        if param_atol is not None:
            np.testing.assert_allclose(got, want, atol=param_atol,
                                       err_msg=v.name)
        err = np.linalg.norm(got - want) / np.linalg.norm(want - init[v.name])
        assert err <= delta_rtol, (v.name, err)


def test_bert_train_matches_jax_f32(graphs):
    jex, tex, xs = _executors(graphs, None)
    feed = _batch(0)
    want = jex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    got = tex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    scale = max(np.abs(np.asarray(b)).max() for b in want[1:])
    for v, a, b in zip(xs, got[1:], want[1:]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=v.name)
    _train_and_compare(jex, tex, xs, loss_rtol=1e-5, param_atol=1e-5,
                       delta_rtol=1e-4)


def test_bert_train_matches_jax_bf16(graphs):
    jex, tex, xs = _executors(graphs, torch.bfloat16)
    _train_and_compare(jex, tex, xs, loss_rtol=2e-3, param_atol=None,
                       delta_rtol=0.3)
