"""The port's checkpoints (graph/checkpoint.py, Executor.state_dict /
load_state_dict / save / load) on the CPU, against the JAX package's
contract: a run resumed through a checkpoint into a fresh executor equals
the uninterrupted run bitwise (params, Adam/AdamW step and moments, the lr
schedule, dropout's generator), the payload has the reference's keys, and
a torn file or an optimizer that does not pair raises."""

import pickle

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu_torch as pt
from hetu_tpu.graph import checkpoint as jckpt
from hetu_tpu_torch.graph import checkpoint as tckpt

B, D_IN, D_H = 8, 12, 16


def _graph(opt="adamw", n_opt=1):
    """A small MLP with dropout and a decaying lr under its own name scope,
    so that a rebuilt graph has the same variable names; returns (loss,
    train ops, placeholders)."""
    with pt.name_scope():
        x = pt.placeholder_op("x", (B, D_IN))
        y = pt.placeholder_op("y", (B, 1))
        w1 = pt.Variable("w1", shape=(D_IN, D_H),
                         initializer=pt.init.normal(0.0, 0.3))
        b1 = pt.Variable("b1", shape=(D_H,), initializer=pt.init.zeros())
        w2 = pt.Variable("w2", shape=(D_H, 1),
                         initializer=pt.init.normal(0.0, 0.3))
        h = pt.dropout_op(pt.relu_op(pt.linear_op(x, w1, b1)), keep_prob=0.7)
        loss = pt.reduce_mean_op(pt.matmul_op(h, w2) - y)
        loss = loss * loss
        lr = pt.lr_scheduler.ExponentialScheduler(0.05, gamma=0.7)
        if opt == "adamw":
            opts = [pt.AdamWOptimizer(lr, weight_decay=0.1)]
        else:
            opts = [pt.AdamOptimizer(lr, l2reg=0.01)]
        if n_opt == 2:  # two optimizers over disjoint variables
            opts = [pt.AdamOptimizer(lr), pt.AdamWOptimizer(0.01)]
            train = [opts[0].minimize(loss, var_list=[w1, b1]),
                     opts[1].minimize(loss, var_list=[w2])]
        else:
            train = [opts[0].minimize(loss)]
    return loss, train, (x, y)


def _feeds(steps):
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((B, D_IN)).astype(np.float32),
             rng.standard_normal((B, 1)).astype(np.float32))
            for _ in range(steps)]


def _step(ex, phs, feed):
    return ex.run("train", feed_dict=dict(zip(phs, feed)))[0]


def _executor(opt="adamw", n_opt=1, seed=3):
    loss, train, phs = _graph(opt, n_opt)
    return pt.Executor({"train": [loss, *train]}, device="cpu",
                       seed=seed), phs


def _assert_same_state(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for (na, sa), (nb, sb) in zip(a.opt_state.items(), b.opt_state.items()):
        assert torch.equal(sa["step"], sb["step"])
        for var in sa["slots"]:
            for k in sa["slots"][var]:
                assert torch.equal(sa["slots"][var][k],
                                   sb["slots"][var][k]), (var, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("via", ["save_load", "state_dict"])
@pytest.mark.parametrize("opt,n_opt", [("adamw", 1), ("adam", 1),
                                       ("adam", 2)])
def test_resume_equals_uninterrupted_run_bitwise(tmp_path, via, opt, n_opt):
    """Two steps, a checkpoint, a fresh executor over a rebuilt graph (its
    optimizer ops named anew, its seed another), one more step: the loss,
    params, optimizer state and generator equal three uninterrupted steps
    bitwise, with dropout on and a decaying lr."""
    feeds = _feeds(3)
    ref, ref_phs = _executor(opt, n_opt)
    want = [_step(ref, ref_phs, f) for f in feeds]

    ex, phs = _executor(opt, n_opt)
    for f in feeds[:2]:
        _step(ex, phs, f)
    fresh, fresh_phs = _executor(opt, n_opt, seed=11)
    assert set(fresh.opt_state) != set(ex.opt_state)  # names differ
    if via == "save_load":
        path = tmp_path / "ckpt.pkl"
        ex.save(path)
        fresh.load(path)
    else:
        fresh.load_state_dict(ex.state_dict())
    got = _step(fresh, fresh_phs, feeds[2])
    assert torch.equal(got, want[2])
    assert fresh._global_step == ref._global_step == 3
    _assert_same_state(fresh, ref)
    for st in fresh.opt_state.values():
        assert int(st["step"]) == 3


def test_without_the_optimizer_state_a_resume_diverges():
    """The case the checkpoint's optimizer state exists for: params alone
    restart Adam (step 0, zero moments, the lr schedule from its start):
    the third step's loss still agrees, the update after it does not."""
    feeds = _feeds(3)
    ref, ref_phs = _executor()
    for f in feeds:
        _step(ref, ref_phs, f)
    ex, phs = _executor()
    for f in feeds[:2]:
        _step(ex, phs, f)
    state = ex.state_dict()
    fresh, fresh_phs = _executor()
    fresh.load_params(state["params"])
    fresh.generator.set_state(torch.from_numpy(state["generator_state"]))
    _step(fresh, fresh_phs, feeds[2])
    assert not all(torch.equal(fresh.params[k], ref.params[k])
                   for k in ref.params)


def test_state_dict_has_the_reference_keys():
    """The JAX package's keys, apart from the generator's, which replaces
    the PRNG key; the same format tag and the same opt_meta."""
    loss, train, _ = _graph()
    st = pt.Executor({"train": [loss, *train]}, device="cpu").state_dict()
    with jt.name_scope():
        x = jt.placeholder_op("x", (B, D_IN))
        w = jt.Variable("w1", shape=(D_IN, 1),
                        initializer=jt.init.normal(0.0, 0.3))
        jloss = jt.reduce_mean_op(jt.matmul_op(x, w))
        jtrain = jt.AdamWOptimizer(0.05, weight_decay=0.1).minimize(jloss)
    ref = jt.Executor({"train": [jloss, jtrain]}).state_dict()
    assert set(st) - {"generator_state", "generator_device"} == \
        set(ref) - {"base_key"}
    assert st["format"] == ref["format"]
    assert [m["class"] for m in st["opt_meta"].values()] == \
        [m["class"] for m in ref["opt_meta"].values()]
    assert [m["order"] for m in st["opt_meta"].values()] == [0]
    assert st["generator_state"].dtype == np.uint8
    assert st["generator_device"] == "cpu"
    (opt,) = st["opt_state"].values()
    assert set(opt) == {"step", "slots"} and int(opt["step"]) == 0
    assert all(set(s) == {"m", "v"} for s in opt["slots"].values())
    # every leaf is numpy, so the payload pickles without torch
    blob = pickle.dumps(st)
    assert b"torch" not in blob


def test_truncated_or_foreign_file_raises(tmp_path):
    ex, _ = _executor()
    path = tmp_path / "ckpt.pkl"
    ex.save(path)
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(tckpt.CheckpointError, match="not a readable"):
        ex.load(path)
    path.write_bytes(pickle.dumps({"params": {}}))
    with pytest.raises(tckpt.CheckpointError, match="missing required"):
        ex.load(path)
    with pytest.raises(FileNotFoundError):
        ex.load(tmp_path / "absent.pkl")
    assert not list(tmp_path.glob("*.tmp.*"))  # no temporary file left


def test_unpaired_optimizers_raise_and_change_nothing():
    ex, phs = _executor()
    _step(ex, phs, _feeds(1)[0])
    state = ex.state_dict()
    fresh, _ = _executor()
    before = {k: v.clone() for k, v in fresh.params.items()}

    bad = dict(state, opt_meta={n: dict(m, **{"class": "AdamOptimizer"})
                                for n, m in state["opt_meta"].items()})
    with pytest.raises(tckpt.CheckpointError, match="is a AdamOptimizer"):
        fresh.load_state_dict(bad)
    bad = dict(state, opt_meta={"optimizer_0": {"class": "AdamWOptimizer",
                                                "order": 0}})
    with pytest.raises(tckpt.CheckpointError, match="opt_meta names"):
        fresh.load_state_dict(bad)
    two, _ = _executor("adam", n_opt=2)
    with pytest.raises(tckpt.CheckpointError, match="1 optimizer state"):
        two.load_state_dict(state)
    # the states pair, but over other variables
    (name,) = state["opt_state"]
    slots = dict(state["opt_state"][name]["slots"])
    slots["elsewhere"] = slots.pop(sorted(slots)[0])
    bad = dict(state, opt_state={name: {"step": state["opt_state"][name][
        "step"], "slots": slots}})
    with pytest.raises(tckpt.CheckpointError, match="other variables"):
        fresh.load_state_dict(bad)
    for k, v in before.items():
        assert torch.equal(fresh.params[k], v)
    assert all(int(s["step"]) == 0 for s in fresh.opt_state.values())


def test_validate_state_matches_the_reference():
    """The same verdicts as the JAX package's validate_state on the keys
    the two contracts share."""
    good = {"params": {}, "opt_state": {}, "global_step": 0}
    port = dict(good, generator_state=np.zeros(16, np.uint8))
    ref = dict(good, base_key=np.zeros(2, np.uint32))
    for change in ({}, {"format": {"version": 1}},
                   {"format": {"version": 2}}, {"format": "HWIO"},
                   {"params": []}):
        outcomes = []
        for mod, payload in ((tckpt, dict(port, **change)),
                             (jckpt, dict(ref, **change))):
            try:
                mod.validate_state(payload)
                outcomes.append("ok")
            except mod.CheckpointError:
                outcomes.append("raises")
        assert outcomes[0] == outcomes[1], change
    with pytest.raises(tckpt.CheckpointError, match="payload is list"):
        tckpt.validate_state([])
    with pytest.raises(tckpt.CheckpointError, match="generator_state"):
        tckpt.validate_state(good)
