"""The port's graph layer (node, trace, executor, initializers) on the CPU,
held against the JAX package where both define the behaviour, and the
import rule: the port imports neither JAX nor ``hetu_tpu``."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu_torch.graph.node import find_topo_sort

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _mlp(pkg, seed=0):
    """The same small graph in either package: linear + gelu + layer norm +
    tanh, sugar ops, reshape/transpose/slice, a scalar mean."""
    rng = np.random.default_rng(seed)
    x = pkg.placeholder_op("x", (4, 8))
    w = pkg.Variable("w", value=rng.standard_normal((8, 6)).astype(np.float32))
    b = pkg.Variable("b", value=rng.standard_normal((6,)).astype(np.float32))
    g = pkg.Variable("g", value=np.ones(6, np.float32))
    h = pkg.gelu_op(pkg.linear_op(x, w, b))
    h = pkg.layer_normalization_op(h, g, b * 0.5) - 0.25
    h = pkg.tanh_op(h * h + 1.0)
    t = pkg.transpose_op(pkg.array_reshape_op(h, output_shape=(2, 2, 6)),
                         perm=(1, 0, 2))
    s = pkg.slice_op(t, begin_pos=(0, 1, 2), output_shape=(-1, 1, 3))
    return x, h, s, pkg.reduce_mean_op(h)


def test_graph_matches_jax_and_feeds_by_node_or_name():
    X = np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32)
    xj, *outs_j = _mlp(jt)
    xt, *outs_t = _mlp(pt)
    want = jt.Executor(outs_j).run(feed_dict={xj: X},
                                   convert_to_numpy_ret_vals=True)
    ex = pt.Executor(outs_t, device="cpu")
    by_node = ex.run(feed_dict={xt: X}, convert_to_numpy_ret_vals=True)
    by_name = ex.run(feed_dict={"x": torch.from_numpy(X)},
                     convert_to_numpy_ret_vals=True)
    for w, a, b in zip(want, by_node, by_name):
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-6)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="missing feeds"):
        ex.run(feed_dict={})


def test_topo_order_puts_inputs_first():
    x = pt.placeholder_op("x", (2, 2))
    a = x + 1.0
    b = a * x
    c = b - a
    order = find_topo_sort([c])
    pos = {n: i for i, n in enumerate(order)}
    assert len(order) == len(set(order)) == 4  # x, a, b, c
    for n in order:
        for i in n.inputs:
            assert pos[i] < pos[n]
    assert order[-1] is c


def test_validate_dropout_is_identity_and_training_refuses():
    """Dropout is the identity in ``validate`` and drops in training; a
    training executor still refuses what later slices bring (the step
    guard, slice G)."""
    x = pt.placeholder_op("x", (3, 5))
    y = pt.dropout_op(x, keep_prob=0.5)
    X = np.arange(1, 16, dtype=np.float32).reshape(3, 5)
    ex = pt.Executor({"validate": [y]}, device="cpu")
    (out,) = ex.run("validate", feed_dict={x: X},
                    convert_to_numpy_ret_vals=True)
    np.testing.assert_array_equal(out, X)
    train = pt.Executor({"train": [y]}, device="cpu", training=True)
    (out,) = train.run("train", feed_dict={x: X},
                       convert_to_numpy_ret_vals=True)
    assert np.all((out == 0) | (out == 2 * X)) and np.any(out == 0)
    with pytest.raises(NotImplementedError, match="slice G"):
        pt.Executor({"train": [y]}, device="cpu", training=True,
                    step_guard=object())


class _CountOp(pt.Op):
    """Adds one to an int32 counter each run and returns x."""

    def __init__(self, x, counter):
        super().__init__(x, counter)
        self.counter = counter

    def _compute(self, input_vals, ctx):
        x, total = input_vals
        ctx.record_update(self.counter, total + 1)
        return x


def test_record_update_and_compute_dtype_keep_ints():
    x = pt.placeholder_op("x", (2, 3))
    ids = pt.placeholder_op("ids", (2,), dtype=np.int32)
    counter = pt.Variable("count", value=np.zeros((), np.int32),
                          trainable=False, dtype=np.int32)
    w = pt.Variable("w", value=np.full((3, 3), 0.5, np.float32))
    y = pt.matmul_op(_CountOp(x, counter), w)
    seen = {}

    class _Probe(pt.Op):
        def _compute(self, input_vals, ctx):
            seen["ids"] = input_vals[0].dtype
            seen["w"] = input_vals[1].dtype
            return input_vals[0]

    probe = _Probe(ids, w)
    ex = pt.Executor({"validate": [y, probe]}, device="cpu",
                     compute_dtype=torch.bfloat16)
    for _ in range(3):
        out, _ = ex.run("validate", feed_dict={x: np.ones((2, 3)),
                                               ids: np.arange(2)})
    assert out.dtype == torch.bfloat16
    assert seen == {"ids": torch.int32, "w": torch.bfloat16}
    assert ex.params[counter.name].dtype == torch.int32
    assert int(ex.params[counter.name]) == 3
    assert ex.params[w.name].dtype == torch.float32  # params keep their dtype


def test_initializers_deterministic_by_name_and_seed():
    def build(seed, extra_first):
        with pt.name_scope():
            if extra_first:
                pt.Variable("other", shape=(7,), initializer=pt.init.normal())
            a = pt.Variable("a", shape=(16, 4),
                            initializer=pt.init.xavier_normal())
            t = pt.Variable("t", shape=(64,),
                            initializer=pt.init.truncated_normal(0.0, 0.02))
        ex = pt.Executor([a + 0.0, t + 0.0], seed=seed, device="cpu")
        return ex.params["a"], ex.params["t"]

    a0, t0 = build(0, False)
    a1, t1 = build(0, True)
    a2, _ = build(1, False)
    assert torch.equal(a0, a1) and torch.equal(t0, t1)
    assert not torch.equal(a0, a2)
    assert t0.abs().max() <= 0.04 + 1e-7   # cut at two stddevs
    assert abs(float(a0.std()) - (2.0 / 20) ** 0.5) < 0.1


def test_device_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = pt.placeholder_op("x", (2,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.Executor([x + 1.0])
    assert pt.Executor([x + 1.0], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"dist_strategy": object()},
    {"comm_mode": "AllReduce"}, {"pipeline": "gpipe"},
    {"step_guard": object()}, {"numerics": object()}])
def test_later_slices_raise(kwargs):
    x = pt.placeholder_op("x", (2,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.Executor([x + 1.0], device="cpu", **kwargs)


def test_training_names_raise():
    """The optimizers of slice A3 and gradients with respect to interior
    nodes (slice F) raise, naming their slice."""
    with pytest.raises(NotImplementedError, match="slice A3"):
        pt.SGDOptimizer(learning_rate=1e-4)
    x = pt.placeholder_op("x", (2,))
    with pytest.raises(NotImplementedError, match="slice F"):
        pt.gradients(pt.reduce_mean_op(x * 2.0), [x])


def test_load_state_dict_roundtrip_and_shape_check():
    x = pt.placeholder_op("x", (2, 3))
    w = pt.Variable("w", shape=(3, 3), initializer=pt.init.normal())
    ex = pt.Executor([pt.matmul_op(x, w)], device="cpu", seed=3)
    state = ex.state_dict()
    ex2 = pt.Executor([pt.matmul_op(x, w)], device="cpu", seed=4)
    assert not torch.equal(ex2.params[w.name], ex.params[w.name])
    ex2.load_state_dict(state)
    assert torch.equal(ex2.params[w.name], ex.params[w.name])
    with pytest.raises(ValueError, match="shape"):
        ex2.load_state_dict({"params": {w.name: np.zeros((2, 3))}})


def _port_sources():
    pkg = os.path.join(ROOT, "hetu_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax_nor_hetu_tpu():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "hetu_tpu"):
                    bad.append(f"{path}: {name}")
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = ("import sys, hetu_tpu_torch, hetu_tpu_torch.models; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'hetu_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
