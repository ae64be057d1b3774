"""The port's optimizers and learning-rate schedules on the CPU, held
against the JAX package on the same graph, params and feeds.

Tolerances: AdamW params after 3 steps atol 1e-6 (f32 on both sides; the
steps move params by ~lr = 1e-2, and the rule is the same arithmetic).  At
step 1 the update is lr * g / (|g| + eps), about lr * sign(g), which hides
gradient errors, so the gradients are compared directly too (rtol 1e-5,
atol 1e-7).  Schedules: rtol 1e-6 (f32 arithmetic on both sides) + atol
1e-8: the cosine term is computed at the scale of lr = 0.1 and cancels
towards its end, so a few f32 ulps of 0.1 remain.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.optim.optimizer as jopt
import hetu_tpu_torch as pt
import hetu_tpu_torch.optim as popt


def _graph(pkg):
    rng = np.random.default_rng(0)
    x = pkg.placeholder_op("x", (8, 16))
    w1 = pkg.Variable("w1", value=rng.standard_normal((16, 32)).astype(
        np.float32) * 0.3)
    b1 = pkg.Variable("b1", value=np.zeros(32, np.float32))
    w2 = pkg.Variable("w2", value=rng.standard_normal((32, 4)).astype(
        np.float32) * 0.3)
    h = pkg.tanh_op(pkg.linear_op(x, w1, b1))
    loss = pkg.reduce_mean_op(pkg.matmul_op(h, w2) * pkg.matmul_op(h, w2))
    return x, loss, [w1, b1, w2]


@pytest.mark.parametrize("kind", ["adamw", "adam_l2"])
def test_adamw_with_clip_matches_jax_over_three_steps(kind):
    def build(pkg, opt_mod):
        x, loss, xs = _graph(pkg)
        grads = pkg.gradients(loss, xs)
        if kind == "adamw":
            opt = pkg.AdamWOptimizer(learning_rate=1e-2, weight_decay=0.01)
        else:
            opt = pkg.AdamOptimizer(learning_rate=1e-2, l2reg=0.05)
        op = opt_mod.OptimizerOp(grads, xs, opt, clip_global_norm=0.5)
        return x, loss, xs, grads, op

    xj, lj, vj, gj, opj = build(jt, jopt)
    xt, lt, vt, gt, opt_ = build(pt, popt)
    jex = jt.Executor({"train": [lj, opj, *gj]})
    tex = pt.Executor({"train": [lt, opt_, *gt]}, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(3):
        X = rng.standard_normal((8, 16)).astype(np.float32)
        want = jex.run("train", feed_dict={xj: X},
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict={xt: X},
                      convert_to_numpy_ret_vals=True)
        assert got[1] is None
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for a, b in zip(got[2:], want[2:]):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                       atol=1e-7)
        for v in vt:
            np.testing.assert_allclose(tex.params[v.name].numpy(),
                                       np.asarray(jex.params[v.name]),
                                       atol=1e-6)
    state = tex.opt_state[opt_.name]
    assert int(state["step"]) == 3
    assert set(state["slots"][vt[0].name]) == {"m", "v"}


def test_clip_scales_by_the_global_norm():
    """With a clip far below the gradient norm, the gradients the update
    rule sees have a global norm of the clip; with a zero learning rate no
    param moves."""
    x, loss, xs = _graph(pt)
    grads = pt.gradients(loss, xs)
    seen = {}

    class Probe(pt.AdamWOptimizer):
        def apply_dense(self, param, grad, slots, lr, step):
            seen.setdefault("sq", []).append(float(grad.square().sum()))
            return super().apply_dense(param, grad, slots, lr, step)

    op = popt.OptimizerOp(grads, xs, Probe(learning_rate=0.0),
                          clip_global_norm=1e-3)
    ex = pt.Executor({"train": [loss, op]}, device="cpu")
    before = {v.name: ex.params[v.name].clone() for v in xs}
    ex.run("train", feed_dict={x: np.ones((8, 16), np.float32)})
    assert sum(seen["sq"]) ** 0.5 == pytest.approx(1e-3, rel=1e-3)
    for v in xs:
        assert torch.equal(ex.params[v.name], before[v.name])


@pytest.mark.parametrize("name,args", [
    ("FixedScheduler", (0.1,)),
    ("StepScheduler", (0.1, 7, 0.5)),
    ("MultiStepScheduler", (0.1, (5, 20, 60), 0.3)),
    ("ExponentialScheduler", (0.1, 0.97)),
    ("CosineScheduler", (0.1, 80, 0.001, 10)),
    ("LinearWarmupScheduler", (0.1, 10, 90)),
])
def test_lr_schedules_match_jax(name, args):
    js = getattr(jt.lr_scheduler, name)(*args)
    ts = getattr(pt.lr_scheduler, name)(*args)
    for step in range(101):
        want = np.asarray(js.get(jnp.asarray(step, jnp.int32)))
        got = ts.get(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-8)


def test_later_slices_raise():
    x, loss, xs = _graph(pt)
    with pytest.raises(NotImplementedError, match="slice B"):
        pt.AdamWOptimizer().minimize(loss, sparse_vars=[xs[0]])
    with pytest.raises(NotImplementedError, match="slice A3"):
        pt.AdamOptimizer(amsgrad=True)
    for name in ("SGDOptimizer", "MomentumOptimizer", "AdaGradOptimizer",
                 "AMSGradOptimizer", "LambOptimizer"):
        with pytest.raises(NotImplementedError, match="slice A3"):
            getattr(pt, name)(learning_rate=0.1)
