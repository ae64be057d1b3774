"""The port's optimizers and learning-rate schedules on the CPU, held
against the JAX package on the same graph, params and feeds.

Tolerances: AdamW params after 3 steps atol 1e-6 (f32 on both sides; the
steps move params by ~lr = 1e-2, and the rule is the same arithmetic).
SGD and Momentum: the update rules alone, on the same params, gradients
and slots for 5 steps, bitwise against the JAX rules run op by op (the
same f32 operations in the same order), with and without ``l2reg``;
Nesterov within an ulp of the largest |param| a step (``p - (lr g - m v)`` rounds
once where JAX's ``(p + m v) - lr g`` rounds twice).  Through both
executors, the params after 5 steps atol 1e-6 (gradients summed in another
order).  At
step 1 the update is lr * g / (|g| + eps), about lr * sign(g), which hides
gradient errors, so the gradients are compared directly too (rtol 1e-5,
atol 1e-7).  Schedules: rtol 1e-6 (f32 arithmetic on both sides) + atol
1e-8: the cosine term is computed at the scale of lr = 0.1 and cancels
towards its end, so a few f32 ulps of 0.1 remain.
"""

import weakref

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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

    # each graph in its own package's name_scope, and the variables paired
    # by position: a bare "w1" made earlier in the same process (another
    # test file on the same xdist worker) would rename the JAX one "w1_1"
    with jt.name_scope():
        xj, lj, vj, gj, opj = build(jt, jopt)
    with pt.name_scope():
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
        for v, u in zip(vt, vj):
            np.testing.assert_allclose(tex.params[v.name].numpy(),
                                       np.asarray(jex.params[u.name]),
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
        def apply_dense_(self, param, grad, slots, lr, step):
            seen.setdefault("sq", []).append(float(grad.square().sum()))
            return super().apply_dense_(param, grad, slots, lr, step)

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
    with pytest.raises(NotImplementedError, match="slice B2"):
        pt.AdamWOptimizer().minimize(loss, sparse_vars=[xs[0]])
    with pytest.raises(NotImplementedError, match="slice A3"):
        pt.AdamOptimizer(amsgrad=True)
    for name in ("AdaGradOptimizer", "AMSGradOptimizer", "LambOptimizer"):
        with pytest.raises(NotImplementedError, match="slice A3"):
            getattr(pt, name)(learning_rate=0.1)


class _LiveStorages(TorchDispatchMode):
    """Counts the live storages of ``numel`` elements across the ops run
    under it (the tensors in ``start`` live from the outset); ``peak`` is
    the most seen at once."""

    def __init__(self, numel, start):
        super().__init__()
        self.numel, self.live, self.peak = numel, {}, 0
        for t in start:
            self._track(t)

    def _track(self, t):
        if not isinstance(t, torch.Tensor) or t.numel() != self.numel:
            return
        ptr = t.untyped_storage().data_ptr()
        self.live[ptr] = self.live.get(ptr, 0) + 1
        weakref.finalize(t, self._drop, ptr)
        self.peak = max(self.peak, len(self.live))

    def _drop(self, ptr):
        self.live[ptr] -= 1
        if not self.live[ptr]:
            del self.live[ptr]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            self._track(t)
        return out


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_update_holds_one_temporary(kind):
    """The dense update of a parameter holds at most one temporary of its
    size beside the parameter, its gradient and the old and new moments
    (8 in all; the plain formula held 11), and gives the same bits as the
    JAX formula written out op by op."""
    n = 4099
    gen = torch.Generator().manual_seed(0)
    param, grad, m, v = (torch.randn(n, generator=gen) for _ in range(4))
    v = v.abs()
    step, lr = torch.tensor(4, dtype=torch.int32), 1e-2
    opt = (pt.AdamOptimizer(lr) if kind == "adam"
           else pt.AdamWOptimizer(lr, weight_decay=0.01))
    with _LiveStorages(n, (param, grad, m, v)) as live:
        new_p, slots = opt.apply_dense(param, grad, {"m": m, "v": v}, lr,
                                       step)
    assert live.peak == 8
    t = step.float() + 1.0
    m_ref = 0.9 * m + (1.0 - 0.9) * grad
    v_ref = 0.999 * v + (1.0 - 0.999) * grad * grad
    mhat = m_ref / (1.0 - torch.pow(0.9, t))
    denom = torch.sqrt(v_ref / (1.0 - torch.pow(0.999, t))) + 1e-7
    if kind == "adam":
        p_ref = param - lr * mhat / denom
    else:
        p_ref = param - lr * (mhat / denom + 0.01 * param)
    assert torch.equal(slots["m"], m_ref) and torch.equal(slots["v"], v_ref)
    assert torch.equal(new_p, p_ref)


_RULES = [("sgd", {}), ("sgd", {"l2reg": 0.05}), ("momentum", {}),
          ("momentum", {"l2reg": 0.05}), ("nesterov", {}),
          ("nesterov", {"l2reg": 0.05})]


def _opt(pkg, kind, kw, lr=0.1):
    if kind == "sgd":
        return pkg.SGDOptimizer(learning_rate=lr, **kw)
    return pkg.MomentumOptimizer(learning_rate=lr, momentum=0.9,
                                 nesterov=kind == "nesterov", **kw)


@pytest.mark.parametrize("kind,kw", _RULES,
                         ids=[f"{k}-{sorted(kw)}" for k, kw in _RULES])
def test_sgd_momentum_rules_match_jax_bits(kind, kw):
    """The in-place rule (``apply_dense_``, the param then written as ``p -
    d``, as the executor writes it) against JAX's functional rule over 5
    steps from the same state and gradients."""
    rng = np.random.default_rng(2)
    n = 4099
    p = rng.standard_normal(n).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.from_numpy(p.copy())
    jo, to = _opt(jt, kind, kw), _opt(pt, kind, kw)
    jslots = {k: jnp.zeros(n, jnp.float32) for k in jo.slot_names}
    tslots = to.init_slots(tp)
    assert set(tslots) == set(jslots)
    for step in range(5):
        g = rng.standard_normal(n).astype(np.float32)
        lr_j = jo.lr.get(jnp.asarray(step, jnp.int32))
        lr_t = to.lr.get(torch.tensor(step, dtype=torch.int32))
        jp, jslots = jo.apply_dense(jp, jnp.asarray(g), jslots, lr_j, step)
        tp.sub_(to.apply_dense_(tp, torch.from_numpy(g), tslots, lr_t,
                                step))
        for k in jslots:
            np.testing.assert_array_equal(tslots[k].numpy(),
                                          np.asarray(jslots[k]))
        if kind == "nesterov":
            np.testing.assert_allclose(
                tp.numpy(), np.asarray(jp), rtol=0,
                atol=np.spacing(np.abs(np.asarray(jp))).max())
            tp.copy_(torch.from_numpy(np.array(jp)))
        else:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


@pytest.mark.parametrize("kind,kw", _RULES[::2] + [_RULES[3]],
                         ids=["sgd", "momentum", "nesterov", "momentum-l2"])
def test_sgd_momentum_minimize_matches_jax_over_five_steps(kind, kw):
    def build(pkg):
        x, loss, xs = _graph(pkg)
        return x, loss, xs, _opt(pkg, kind, kw, lr=0.05).minimize(loss)

    with jt.name_scope():
        xj, lj, vj, opj = build(jt)
    with pt.name_scope():
        xt, lt, vt, opt_ = build(pt)
    jex = jt.Executor({"train": [lj, opj]})
    tex = pt.Executor({"train": [lt, opt_]}, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(5):
        X = rng.standard_normal((8, 16)).astype(np.float32)
        want = jex.run("train", feed_dict={xj: X},
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict={xt: X},
                      convert_to_numpy_ret_vals=True)
        assert got[1] is None
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for v, u in zip(vt, vj):
        np.testing.assert_allclose(tex.params[v.name].numpy(),
                                   np.asarray(jex.params[u.name]), atol=1e-6)
    state = tex.opt_state[opt_.name]
    assert int(state["step"]) == 5
    assert set(state["slots"][vt[0].name]) == (
        set() if kind == "sgd" else {"velocity"})
