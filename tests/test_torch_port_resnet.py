"""ResNet through both packages' Executors on the CPU.

``ResNet((1, 1, 1, 1))`` at full channel widths (64-512) on 8x8 inputs,
batch 4, trains with ``MomentumOptimizer(0.01, 0.9).minimize(loss)`` in a
``train`` subgraph beside a ``validate`` subgraph of the logits; the JAX
executor's params carry across with ``Executor.load_params``.

Tolerances, f32 (the same arithmetic, its convolutions and batch-norm
means summed in another order): the logits rtol 1e-4 with an atol of 1e-4
of their largest |value|; the losses of 3 steps rtol 1e-4 (readings up to
5e-6); each param's change over the 3 steps, running stats included,
within 1e-3 of JAX's change, relative, in the 2-norm (readings up to
6e-5), and each velocity likewise; then the ``validate`` logits on the
trained params and running stats as before.  The step's lr is 0.01: at
0.1 a batch of 4 drives the loss from 3.0 to 10.7 in 3 steps, and both
packages' rounding grows with it.
"""

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm

B = 4


def _build(pkg, models, blocks=(1, 1, 1, 1), channels_last=False):
    with pkg.name_scope():
        shape = (B, 8, 8, 3) if channels_last else (B, 3, 8, 8)
        x = pkg.placeholder_op("rn_x", shape)
        y = pkg.placeholder_op("rn_y", (B,), dtype=np.int32)
        model = models.ResNet(blocks, 10, channels_last=channels_last)
        logits = model(x)
        loss = pkg.reduce_mean_op(
            pkg.softmax_cross_entropy_sparse_op(logits, y))
        train_op = pkg.MomentumOptimizer(0.01, 0.9).minimize(loss)
    return {"train": [loss, train_op], "validate": [logits]}, x, y, train_op


def _logits_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _change_close(got, want, init, what):
    change = want - init
    err = np.linalg.norm(got - want) / max(np.linalg.norm(change), 1e-30)
    assert err <= 1e-3, f"{what}: change error {err:.3e}"


def test_resnet_trains_like_jax():
    jnodes, jx, jy, jop = _build(jt, jm)
    tnodes, tx, ty, top = _build(pt, pm)
    jex = jt.Executor(jnodes, seed=0)
    tex = pt.Executor(tnodes, device="cpu")
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    init = {k: np.asarray(v).copy() for k, v in jex.params.items()}
    # 12 BatchNorms: the stem's, two a block, three shortcuts'
    assert sum("running" in k for k in init) == 2 * 12
    rng = np.random.default_rng(0)

    def validate():
        X = rng.standard_normal((B, 3, 8, 8)).astype(np.float32)
        want = jex.run("validate", feed_dict={jx: X},
                       convert_to_numpy_ret_vals=True)[0]
        got = tex.run("validate", feed_dict={tx: X},
                      convert_to_numpy_ret_vals=True)[0]
        assert got.shape == (B, 10)
        _logits_close(got, want)

    validate()
    for _ in range(3):
        X = rng.standard_normal((B, 3, 8, 8)).astype(np.float32)
        Y = rng.integers(0, 10, B).astype(np.int32)
        want = jex.run("train", feed_dict={jx: X, jy: Y},
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict={tx: X, ty: Y},
                      convert_to_numpy_ret_vals=True)
        assert got[1] is None
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    for k, v in init.items():
        _change_close(tex.params[k].numpy(), np.asarray(jex.params[k]), v, k)
    jslots = jex.opt_state[jop.name]["slots"]
    tslots = tex.opt_state[top.name]["slots"]
    assert set(tslots) == set(jslots)
    for k, slots in tslots.items():
        assert set(slots) == {"velocity"}
        _change_close(slots["velocity"].numpy(),
                      np.asarray(jslots[k]["velocity"]), 0.0, k)
    assert int(tex.opt_state[top.name]["step"]) == 3
    # validate changes no param, running stats included
    before = {k: v.clone() for k, v in tex.params.items()}
    validate()
    assert all(torch.equal(before[k], v) for k, v in tex.params.items())


def test_resnet18_names_and_shapes_match_jax():
    """resnet18() makes the same variables in both packages, in the same
    order: names, shapes and trainability (running stats are not)."""
    def variables(pkg, models):
        with pkg.name_scope():
            x = pkg.placeholder_op("rn_x", (2, 3, 32, 32))
            logits = models.resnet18(num_classes=10)(x)
        return [(v.name, tuple(v.shape), v.trainable)
                for v in pkg.graph_variables([logits])]

    want = variables(jt, jm)
    got = variables(pt, pm)
    assert got == want
    # 20 convs, 20 BatchNorms (scale, bias, two running stats), fc
    assert len(got) == 102 and sum(t for _, _, t in got) == 62
    assert ("resnet_conv1_weight", (3, 3, 3, 64), True) in got


def test_resnet_channels_last_equals_nchw():
    """channels_last=True (NHWC activations) against the NCHW model with
    the same weights, 3 Momentum steps: losses and params within f32
    rounding: losses rtol 1e-5, params rtol 1e-5 with atol 1e-5 (the
    convolutions run in other memory formats, and a weight's gradient sums
    its products in another order; readings up to 1.5e-6)."""
    nodes, x, y, _ = _build(pt, pm)
    cl_nodes, cl_x, cl_y, _ = _build(pt, pm, channels_last=True)
    ex = pt.Executor(nodes, device="cpu", seed=1)
    cl = pt.Executor(cl_nodes, device="cpu", seed=2)
    assert list(cl.params) == list(ex.params)
    cl.load_params({k: v.numpy() for k, v in ex.params.items()})
    rng = np.random.default_rng(1)
    for _ in range(3):
        X = rng.standard_normal((B, 3, 8, 8)).astype(np.float32)
        Y = rng.integers(0, 10, B).astype(np.int32)
        want = ex.run("train", feed_dict={x: X, y: Y})[0]
        got = cl.run("train", feed_dict={cl_x: X.transpose(0, 2, 3, 1),
                                         cl_y: Y})[0]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    for k, v in ex.params.items():
        torch.testing.assert_close(cl.params[k], v, rtol=1e-5, atol=1e-5)
    X = rng.standard_normal((B, 3, 8, 8)).astype(np.float32)
    torch.testing.assert_close(
        cl.run("validate", feed_dict={cl_x: X.transpose(0, 2, 3, 1)})[0],
        ex.run("validate", feed_dict={x: X})[0], rtol=1e-4, atol=1e-5)


def test_resnet_pipeline_stages_raise():
    with pytest.raises(NotImplementedError, match="slice F"):
        pm.ResNet((1, 1, 1, 1), pipeline_stages=2)
