"""The port's autodiff (``gradients`` on torch.autograd) and the
executor's training rules on the CPU, held against the JAX package where
both define the behaviour.

Tolerances: f32 gradients rtol 1e-5, atol 1e-6 (the same arithmetic, in
another summation order).
"""

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu_torch as pt


def _mlp(pkg, seed=0, with_ct=False):
    """The same small graph in either package: linear + gelu + layer norm +
    tanh, a scalar loss, and an unused variable."""
    rng = np.random.default_rng(seed)
    x = pkg.placeholder_op("x", (4, 8))
    w = pkg.Variable("w", value=rng.standard_normal((8, 6)).astype(np.float32))
    b = pkg.Variable("b", value=rng.standard_normal((6,)).astype(np.float32))
    g = pkg.Variable("g", value=np.ones(6, np.float32))
    unused = pkg.Variable("unused", value=np.ones(3, np.float32))
    h = pkg.gelu_op(pkg.linear_op(x, w, b))
    h = pkg.tanh_op(pkg.layer_normalization_op(h, g, b * 0.5) * 1.5)
    loss = pkg.reduce_mean_op(h * h)
    ct = pkg.placeholder_op("ct", ()) if with_ct else None
    xs = [w, b, g, unused]
    return x, ct, loss, xs, pkg.gradients(loss, xs, grad_out=ct)


@pytest.mark.parametrize("with_ct", [False, True])
def test_gradients_match_jax(with_ct):
    X = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    xj, ctj, lj, _, gj = _mlp(jt, with_ct=with_ct)
    xt, ctt, lt, _, gt = _mlp(pt, with_ct=with_ct)
    feed_j, feed_t = {xj: X}, {xt: X}
    if with_ct:
        feed_j[ctj] = np.float32(2.5)
        feed_t[ctt] = np.float32(2.5)
    want = jt.Executor({"grads": [lj] + gj}).run(
        "grads", feed_dict=feed_j, convert_to_numpy_ret_vals=True)
    got = pt.Executor({"grads": [lt] + gt}, device="cpu").run(
        "grads", feed_dict=feed_t, convert_to_numpy_ret_vals=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    assert np.all(got[-1] == 0)  # the unused variable: a zero gradient


def test_gradients_under_bf16_are_bf16():
    """Gradients are taken w.r.t. the compute-dtype values bound for the
    variables, as in JAX (the cast happens before the vjp)."""
    X = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    xt, _, lt, _, gt = _mlp(pt)
    out = pt.Executor({"grads": gt}, device="cpu",
                      compute_dtype=torch.bfloat16).run(
        "grads", feed_dict={xt: X})
    assert all(g.dtype == torch.bfloat16 for g in out)


class _CountOp(pt.Op):
    """Adds one to an int32 counter each time it is computed; returns x."""

    def __init__(self, x, counter):
        super().__init__(x, counter)
        self.counter = counter

    def _compute(self, input_vals, ctx):
        x, total = input_vals
        ctx.record_update(self.counter, total + 1)
        return x


def test_forward_runs_once_and_stateful_update_records_once():
    """The fused-primal contract: one forward per step, so an op on the
    loss path records its update once per step, not twice."""
    x = pt.placeholder_op("x", (2, 3))
    counter = pt.Variable("count", value=np.zeros((), np.int32),
                          trainable=False, dtype=np.int32)
    w = pt.Variable("w", value=np.full((3, 3), 0.5, np.float32))
    loss = pt.reduce_mean_op(pt.matmul_op(_CountOp(x, counter), w))
    train_op = pt.AdamWOptimizer(learning_rate=1e-3).minimize(loss)
    ex = pt.Executor({"train": [loss, train_op]}, device="cpu")
    for _ in range(3):
        out = ex.run("train", feed_dict={x: np.ones((2, 3))})
    assert out[1] is None
    assert int(ex.params[counter.name]) == 3


def test_gradients_refuse_non_variables():
    x = pt.placeholder_op("x", (2, 3))
    h = x * 2.0
    with pytest.raises(NotImplementedError, match="slice F"):
        pt.gradients(pt.reduce_mean_op(h), [h])


def _dropout_graph():
    x = pt.placeholder_op("x", (64, 64))
    w = pt.Variable("w", value=np.ones((64, 64), np.float32) / 64)
    y = pt.dropout_op(pt.matmul_op(x, w), keep_prob=0.5)
    loss = pt.reduce_mean_op(y)
    return x, w, y, loss


def test_train_subgraph_trains_without_training_flag():
    """The JAX rule: a subgraph with an optimizer or gradient op trains
    (dropout on) unless its name marks evaluation; ``validate`` neither
    applies dropout nor mutates params; an explicit ``training=`` wins."""
    x, w, y, loss = _dropout_graph()
    opt = pt.AdamWOptimizer(learning_rate=1e-2)
    train_op = opt.minimize(loss)
    ex = pt.Executor({"train": [y, train_op], "validate": [y],
                      "eval": [y, *pt.gradients(loss, [w])]},
                     device="cpu", rng_impl="rbg", donate_params=True)
    assert ex.subexecutor["train"].training
    assert not ex.subexecutor["validate"].training
    assert not ex.subexecutor["eval"].training     # gradients, eval name
    X = np.ones((64, 64), np.float32)
    w0 = ex.params[w.name].clone()
    (v,) = ex.run("validate", feed_dict={x: X})
    torch.testing.assert_close(v, torch.ones(64, 64))
    assert torch.equal(ex.params[w.name], w0)
    y_train, _ = ex.run("train", feed_dict={x: X})
    zeros = float((y_train == 0).float().mean())
    assert 0.4 < zeros < 0.6                        # half dropped
    assert set(y_train.unique().tolist()) <= {0.0, 2.0}
    assert not torch.equal(ex.params[w.name], w0)   # the step moved w
    forced = pt.Executor({"train": [y]}, device="cpu", training=False)
    assert not forced.subexecutor["train"].training


def test_dropout_is_reproducible_from_the_executor_seed():
    x, _, y, _ = _dropout_graph()
    X = np.ones((64, 64), np.float32)
    runs = []
    for seed in (3, 3, 4):
        ex = pt.Executor({"train": [y]}, device="cpu", seed=seed,
                         training=True)
        runs.append(ex.run("train", feed_dict={x: X})[0])
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
