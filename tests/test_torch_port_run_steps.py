"""The executor's step on the CPU: ``run_steps``, ``profile`` and the
storage rules that a step captured in a CUDA graph relies on.

On the CPU every step runs the same step body that the card captures
(``SubExecutor._body``), eagerly, so these tests hold that body:
``run_steps(n)`` against n ``run()`` calls, bitwise (the same ops on the
same inputs, dropout drawn from the same generator); the params, the
optimizer state and the generator keep their identity from step to step;
a returned value is a copy that no later step changes; ``load_params``
and ``load_state_dict`` write into the executor's tensors.

Against the JAX package: W&D on a packed table (2,000 rows, batch 16,
Adam(0.01)), 7 steps of the JAX ``run_steps`` and of the port's from the
same params (``load_params``), as ``tests/test_packed_embedding.py``'s
``test_run_steps_equals_n_runs`` runs JAX's with SGD.  Tolerances, f32 on
both sides: the last loss rtol 1e-5, and each param's change over the 7
steps within 1e-4 of JAX's change, relative, in the 2-norm (the same
arithmetic with sums in another order; the CTR tests hold 3 steps so).
"""

import tempfile

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm
from hetu_tpu_torch.graph import executor as pexec

ROWS, B = 2000, 16


def _wdl(pkg, models, packed=True):
    dense = pkg.placeholder_op("rs_dense", (B, 13))
    sparse = pkg.placeholder_op("rs_sparse", (B, 26), dtype=np.int32)
    labels = pkg.placeholder_op("rs_labels", (B,))
    with pkg.name_scope():
        model = models.WDL(ROWS, embedding_dim=16, packed_embedding=packed)
        loss = model.loss(dense, sparse, labels)
        train_op = pkg.AdamOptimizer(0.01).minimize(loss)
    return {"train": [loss, train_op]}, (dense, sparse, labels)


def _wdl_feed(seed, feeds):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, 13)).astype(np.float32),
              rng.integers(0, ROWS, (B, 26)).astype(np.int32),
              rng.integers(0, 2, (B,)).astype(np.float32))
    return dict(zip(feeds, arrays))


def _bert(dropout=0.1):
    b, s = 2, 64
    ph = pt.placeholder_op
    feeds = (ph("input_ids", (b, s), dtype=np.int32),
             ph("token_type_ids", (b, s), dtype=np.int32),
             ph("attention_mask", (b, s)),
             ph("mlm_labels", (b * s,), dtype=np.int32),
             ph("nsp_labels", (b,), dtype=np.int32))
    cfg = pm.BertConfig(vocab_size=500, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        seq_len=s, max_position_embeddings=s,
                        hidden_dropout_prob=dropout,
                        attention_probs_dropout_prob=dropout)
    with pt.name_scope():
        loss = pm.BertForPreTraining(cfg).loss(*feeds)
        train_op = pt.AdamWOptimizer(1e-3, weight_decay=0.01).minimize(loss)
    rng = np.random.default_rng(3)
    ml = np.full(b * s, -1, np.int32)
    pos = rng.random(b * s) < 0.15
    ml[pos] = rng.integers(0, 500, pos.sum())
    arrays = (rng.integers(0, 500, (b, s)).astype(np.int32),
              rng.integers(0, 2, (b, s)).astype(np.int32),
              np.ones((b, s), np.float32), ml,
              rng.integers(0, 2, b).astype(np.int32))
    return {"train": [loss, train_op]}, dict(zip(feeds, arrays))


def _state_equal(a, b):
    """Two ``state_dict`` payloads hold the same bits."""
    def flat(st):
        out = {("param", k): v for k, v in st["params"].items()}
        for name, o in st["opt_state"].items():
            order = st["opt_meta"][name]["order"]
            out[("step", order)] = o["step"]
            for var, slots in o["slots"].items():
                for k, v in slots.items():
                    out[("slot", order, var, k)] = v
        out["generator"] = st["generator_state"]
        return out
    fa, fb = flat(a), flat(b)
    return (a["global_step"] == b["global_step"] and fa.keys() == fb.keys()
            and all(np.array_equal(fa[k], fb[k]) for k in fa))


def _model(kind):
    if kind == "wdl":
        nodes, feeds = _wdl(pt, pm)
        return nodes, _wdl_feed(0, feeds)
    return _bert()


@pytest.mark.parametrize("kind", ["wdl", "bert_dropout"])
def test_run_steps_equals_n_runs_bitwise(kind):
    nodes, feed = _model(kind)
    ex1 = pt.Executor(nodes, device="cpu", seed=4)
    ex2 = pt.Executor(nodes, device="cpu", seed=4)
    assert _state_equal(ex1.state_dict(), ex2.state_dict())
    for _ in range(4):
        last = ex1.run("train", feed_dict=feed)
    out = ex2.run_steps("train", feed, 4)
    assert out[1] is None and last[1] is None
    assert torch.equal(out[0], last[0])
    assert ex1._global_step == ex2._global_step == 4
    assert torch.equal(ex1.generator.get_state(), ex2.generator.get_state())
    assert _state_equal(ex1.state_dict(), ex2.state_dict())
    # and the next step of each, after run_steps as after run
    a = ex1.run("train", feed_dict=feed, convert_to_numpy_ret_vals=True)
    b = ex2.run_steps("train", feed, 1, convert_to_numpy_ret_vals=True)
    assert np.array_equal(a[0], b[0])


def test_dropout_draws_advance_each_step():
    """With dropout on, consecutive steps on one batch draw new bits: the
    generator advances, so run_steps does not replay one draw."""
    nodes, feed = _bert()
    ex = pt.Executor(nodes, device="cpu", seed=4)
    s0 = ex.generator.get_state().clone()
    ex.run_steps("train", feed, 2)
    s2 = ex.generator.get_state().clone()
    ex.run("train", feed_dict=feed)
    assert not torch.equal(s0, s2)
    assert not torch.equal(s2, ex.generator.get_state())


def test_run_steps_matches_jax_run_steps():
    j_nodes, j_feeds = _wdl(jt, jm)
    t_nodes, t_feeds = _wdl(pt, pm)
    jex = jt.Executor(j_nodes, seed=5)
    tex = pt.Executor(t_nodes, device="cpu", seed=5)
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    init = {k: v.clone() for k, v in tex.params.items()}
    want = jex.run_steps("train", _wdl_feed(1, j_feeds), 7,
                         convert_to_numpy_ret_vals=True)
    got = tex.run_steps("train", _wdl_feed(1, t_feeds), 7,
                        convert_to_numpy_ret_vals=True)
    assert got[1] is None and np.isfinite(got[0])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert jex._global_step == tex._global_step == 7
    for name, before in init.items():
        ref = np.asarray(jex.params[name]) - before.numpy()
        change = tex.params[name].numpy() - before.numpy()
        err = np.linalg.norm(change - ref) / np.linalg.norm(ref)
        assert err <= 1e-4, (name, err)


def test_run_steps_guards():
    nodes, feeds = _wdl(pt, pm)
    ex = pt.Executor(nodes, device="cpu")
    with pytest.raises(ValueError, match="missing feeds"):
        ex.run_steps("train", {}, 3)
    feed = _wdl_feed(0, feeds)
    for n in (0, -2):
        with pytest.raises(ValueError, match="n >= 1"):
            ex.run_steps("train", feed, n)
    assert ex._global_step == 0
    out = ex.run_steps("train", feed, 2, convert_to_numpy_ret_vals=True)
    assert np.isfinite(out[0]) and ex._global_step == 2


def _tensors(ex):
    out = [ex.generator, *ex.params.values()]
    for st in ex.opt_state.values():
        out.append(st["step"])
        out += [t for slots in st["slots"].values() for t in slots.values()]
    return out


def test_state_tensors_keep_their_identity():
    """A step writes into the params, the slots and the step counters
    already there (a captured graph reads and writes those addresses)."""
    nodes, feed = _bert()
    ex = pt.Executor(nodes, device="cpu")
    before = _tensors(ex)
    ptrs = [t.data_ptr() for t in before[1:]]
    values = [t.clone() for t in before[1:]]
    ex.run("train", feed_dict=feed)
    ex.run_steps("train", feed, 2)
    after = _tensors(ex)
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))
    assert [t.data_ptr() for t in after[1:]] == ptrs
    # and they did change: every step counter is 3, every param moved
    assert all(int(st["step"]) == 3 for st in ex.opt_state.values())
    changed = [not torch.equal(a, v) for a, v in zip(after[1:], values)]
    assert sum(changed) > len(changed) // 2


def test_returned_values_are_copies():
    """A value returned by one step is not changed by the next, also
    where it is a variable's value (returned as it was before the
    step's update) or a feed."""
    x = pt.placeholder_op("rv_x", (4, 3))
    w = pt.Variable("rv_w", value=np.full((3, 2), 0.5, np.float32))
    loss = pt.reduce_mean_op(pt.matmul_op(x, w) * pt.matmul_op(x, w))
    ex = pt.Executor({"train": [loss, w, x,
                                pt.AdamOptimizer(0.1).minimize(loss)]},
                     device="cpu")
    feed = {x: np.ones((4, 3), np.float32)}
    loss1, w1, x1, _ = ex.run("train", feed_dict=feed)
    kept = [t.clone() for t in (loss1, w1, x1)]
    assert torch.equal(w1, torch.full((3, 2), 0.5))
    assert not torch.equal(ex.params[w.name], w1)  # the step moved w
    after1 = ex.params[w.name].clone()
    loss2, w2, _, _ = ex.run("train", feed_dict={x: np.zeros((4, 3),
                                                             np.float32)})
    assert all(torch.equal(a, b) for a, b in zip((loss1, w1, x1), kept))
    assert torch.equal(w2, after1)
    assert w2.data_ptr() != ex.params[w.name].data_ptr()


def test_load_params_and_state_take_effect_on_the_next_step():
    nodes, feed = _bert()
    ex = pt.Executor(nodes, device="cpu", seed=2)
    ref = pt.Executor(nodes, device="cpu", seed=2)
    init = {k: v.numpy().copy() for k, v in ex.params.items()}
    ids = _tensors(ex)
    s1 = ex.state_dict()
    first = ex.run("train", feed_dict=feed)[0]
    second = ex.run("train", feed_dict=feed)[0]
    ex.run_steps("train", feed, 2)
    ex.load_state_dict(s1)
    assert torch.equal(ex.run("train", feed_dict=feed)[0], first)
    assert torch.equal(ex.run("train", feed_dict=feed)[0], second)
    assert all(a is b for a, b in zip(_tensors(ex), ids))
    # load_params: the params (not the optimizer state) of the seed's init
    ex.load_params(init)
    ref.load_params(init)
    for st_ex, st_ref in zip(ex.opt_state.values(), ref.opt_state.values()):
        st_ref["step"].copy_(st_ex["step"])
        for var, slots in st_ex["slots"].items():
            for k, t in slots.items():
                st_ref["slots"][var][k].copy_(t)
    ref.generator.set_state(ex.generator.get_state())
    assert torch.equal(ex.run("train", feed_dict=feed)[0],
                       ref.run("train", feed_dict=feed)[0])
    assert all(a is b for a, b in zip(_tensors(ex), ids))


def test_a_tensor_put_into_params_by_hand_is_used():
    nodes, feed = _model("wdl")
    ex = pt.Executor(nodes, device="cpu")
    ex.run("train", feed_dict=feed)
    name = next(iter(ex.params))
    ex.params[name] = torch.zeros_like(ex.params[name])
    fresh = ex.params[name]
    ex.run("train", feed_dict=feed)
    assert ex.params[name] is fresh and fresh.abs().sum() > 0


def test_get_params_is_a_snapshot():
    nodes, feed = _model("wdl")
    ex = pt.Executor(nodes, device="cpu")
    snap = ex.get_params()
    kept = {k: v.clone() for k, v in snap.items()}
    ex.run("train", feed_dict=feed)
    assert all(torch.equal(snap[k], v) for k, v in kept.items())
    assert any(not torch.equal(ex.params[k], v) for k, v in kept.items())


def test_profile_returns_a_pair_and_trace_dir_raises():
    nodes, feed = _model("wdl")
    ex = pt.Executor(nodes, device="cpu")
    dt, aggs = ex.profile("train", feed, repeats=2)
    assert aggs is None and isinstance(dt, float) and dt > 0
    assert ex._global_step == 3  # one warm-up step on the CPU, 2 timed
    dt, _ = ex.profile(feed_dict=feed, repeats=1)  # the first subgraph
    assert ex._global_step == 5
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(NotImplementedError, match="slice G"):
            ex.profile("train", feed, trace_dir=tmp)
    assert ex._global_step == 5


def test_monitors_run_on_their_cadence():
    """The MLM overflow monitor is read at the first step and then every
    ``monitor_interval`` steps; run_steps reads it once at its end when
    one of its steps falls on the cadence."""
    nodes, feed = _bert()
    ex = pt.Executor(nodes, device="cpu", monitor_interval=3)
    sub = ex.subexecutor["train"]
    assert sub._monitor_vars
    seen = []
    sub.check_monitors = lambda: seen.append(sub._runs)
    ex.run("train", feed_dict=feed)       # run 1
    ex.run_steps("train", feed, 1)        # run 2
    ex.run_steps("train", feed, 3)        # runs 3-5: 3 on the cadence
    ex.run_steps("train", feed, 1)        # run 6
    ex.run_steps("train", feed, 2)        # runs 7-8
    assert seen == [1, 5, 6]


def test_disable_capture_is_a_scoped_switch():
    assert pexec._CAPTURE == [True]
    with pt.disable_capture():
        assert pexec._CAPTURE == [False]
        with pt.disable_capture():
            pass
        assert pexec._CAPTURE == [False]
    assert pexec._CAPTURE == [True]
    with pytest.raises(KeyError):
        with pt.disable_capture():
            raise KeyError("x")
    assert pexec._CAPTURE == [True]
    assert issubclass(pt.CaptureError, RuntimeError)


def test_each_signature_runs_as_one_captured_program():
    """The executor's steps go through ``graph/capture.py``'s
    ``Captured``, the port's one capture mechanism: a program a feed
    signature, a subgraph's programs in one memory pool, the state they
    are bound to the params (the program adds the generator)."""
    from hetu_tpu_torch.graph.capture import Captured
    x = pt.placeholder_op("cap_x", (2, 3))
    w = pt.Variable("cap_w", shape=(3,),
                    initializer=pt.init.normal(0.0, 0.1))
    ex = pt.Executor({"f": [pt.reduce_sum_op(x * w, axes=[1])]},
                     device="cpu")
    sub = ex.subexecutor["f"]
    a = ex.run("f", {x: np.ones((2, 3), np.float32)})[0]
    b = ex.run("f", {x: np.ones((4, 3), np.float32)})[0]
    ex.run("f", {x: np.ones((2, 3), np.float32)})
    assert a.shape == (2,) and b.shape == (4,)
    progs = [sig.program for sig in sub._sigs.values()]
    assert len(progs) == 2
    assert all(isinstance(p, Captured) for p in progs)
    assert all(p.pool is sub._pool and p.owner is ex for p in progs)
    assert [p.builds for p in progs] == [1, 1]  # the CPU: built once
    state = progs[0].state()
    assert len(state) == 1 and state[0] is ex.params["cap_w"]
    assert sub.graph_bytes == 0  # nothing captured on the CPU


def test_disable_capture_steps_equal_default_steps_on_the_cpu():
    nodes, feed = _bert()
    ex1 = pt.Executor(nodes, device="cpu", seed=6)
    ex2 = pt.Executor(nodes, device="cpu", seed=6)
    with pt.disable_capture():
        a = [ex1.run("train", feed_dict=feed)[0] for _ in range(2)]
    b = [ex2.run("train", feed_dict=feed)[0] for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _state_equal(ex1.state_dict(), ex2.state_dict())


@pytest.mark.parametrize("kind", ["few_rows", "many_rows", "pad_rows",
                                  "zipf", "two_rows"])
def test_row_lookup_gradient_sums_each_rows_gradients(kind):
    """The row lookup's backward (the ids sorted, each run summed in a
    fixed tree order) gives each row the sum of its gradients, as the JAX
    package's scatter-add: rows looked up several times, once and never
    in a table of 6 or 40 rows (f32, rtol 1e-6: sums of up to 3 terms in
    another order); runs many blocks long, as a batch's [PAD] id (a
    quarter of the ids on row 0), Zipf-distributed tokens and a 2-row
    token-type table give them (f32 against f64 sums, atol 1e-4 for up
    to ~1,000 terms)."""
    rng = np.random.default_rng(1)
    n, n_rows = 1500, 64
    if kind in ("few_rows", "many_rows"):
        n_rows = 6 if kind == "few_rows" else 40
        ids = np.array([[0, 2, 2], [5, 2, 0]])
    elif kind == "pad_rows":
        ids = rng.integers(1, n_rows, n)
        ids[rng.random(n) < 0.25] = 0
    elif kind == "zipf":
        ids = np.minimum(rng.zipf(1.05, n) - 1, n_rows - 1)
    else:
        n_rows = 2
        ids = (np.arange(n) >= n // 3).astype(np.int64)
    table = torch.from_numpy(
        rng.standard_normal((n_rows, 3)).astype(np.float32))
    g = rng.standard_normal(ids.shape + (3,)).astype(np.float32)
    table.requires_grad_()
    ids_t = torch.from_numpy(ids.astype(np.int32))
    rows = pt.ops.embedding._embedding_lookup(table, ids_t)
    assert torch.equal(rows.detach(), table.detach()[ids_t.long()])
    (grad,) = torch.autograd.grad(rows, table, torch.from_numpy(g))
    want = np.zeros((n_rows, 3))
    np.add.at(want, ids.reshape(-1), g.reshape(-1, 3).astype(np.float64))
    if kind in ("few_rows", "many_rows"):
        np.testing.assert_allclose(grad.numpy(), want, rtol=1e-6)
        assert not grad[[1, 3, 4]].any()
    else:
        np.testing.assert_allclose(grad.numpy(), want, atol=1e-4)


def test_functional_and_in_place_updates_give_the_same_bits():
    """An optimizer's functional form (``apply_dense``, as in JAX: a new
    param and new slots) and the in-place rule the optimizer op runs
    (``apply_dense_``: the slots updated, the param's step ``d``
    returned) give the same param and moments, bitwise; the functional
    form leaves the slots it was given as they were."""
    gen = torch.Generator().manual_seed(3)
    param, grad, m, v = (torch.randn(257, generator=gen) for _ in range(4))
    step, lr = torch.tensor(2, dtype=torch.int32), 1e-2
    for opt in (pt.AdamOptimizer(lr, l2reg=1e-3),
                pt.AdamWOptimizer(lr, weight_decay=0.01)):
        slots = {"m": m.clone(), "v": v.abs()}
        given = {k: t.clone() for k, t in slots.items()}
        new_p, new_slots = opt.apply_dense(param, grad, slots, lr, step)
        assert all(torch.equal(slots[k], given[k]) for k in slots)
        d = opt.apply_dense_(param, grad, slots, lr, step)
        assert torch.equal(param - d, new_p)
        assert all(torch.equal(slots[k], new_slots[k]) for k in slots)
        assert not torch.equal(slots["m"], given["m"])
