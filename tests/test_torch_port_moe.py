"""The port's MoE slice (ops/moe.py, layers/moe.py, ``mse_loss_op``)
against the JAX package on the CPU, on the same numpy inputs and, for the
layer, the same weights carried across with ``Executor.load_params``.

On the CPU both packages' ``row_gather`` run the ``jnp.take`` composition
and its port (tests/test_torch_port_moe_dispatch.py); the CUDA kernel is
held to it on the card by ``chip_smoke.py``.

Tolerances, each with the reading on the CPU that it was set from:
- expert indices, queue positions and the dispatch are exact (argmax takes
  the first maximum in both packages; positions are sums of 0/1 in f32);
- gates and the aux loss rtol 1e-6: a softmax over E = 4 in f32, which the
  two libraries evaluate with another exp (readings 1.7e-7 and 1.2e-7);
  the combine, a gate-weighted sum of two N(0, 1) rows, atol 1e-6 with it
  (reading 2.4e-7);
- the sparse route against the dense einsum route: rtol 1e-6 and atol
  1e-7; the einsums add one nonzero term per slot to zeros (readings 0 for
  the dispatch, 1.2e-7 for the combine's two terms);
- the layer: output atol 1e-7 (reading 6.1e-9 on outputs up to 0.016),
  aux rtol 1e-6 (reading 6.0e-8), loss rtol 1e-5 (f32 means over 8192
  elements in another order; reading 3.7e-7), gradients rtol 1e-5 + atol
  1e-5 * max|g| (products over 64 tokens and 256 hidden units in another
  order; readings <= 1.1e-6 of max|g|);
- each param's change over 3 Adam(1e-3) steps within 1e-4 of JAX's change,
  relative in the 2-norm (readings <= 2.6e-6 for the top-k gate's layer,
  the gate weights'; <= 1.8e-5 for the other gates' layers, k-top-1's gate
  weights, whose per-prototype softmax over 2 experts gives smaller
  gradients; the losses of all: <= 4.6e-7 relative).  A bound
  on the params themselves looser than lr would pass a param that did not
  move; this one fails an unchanged param (error 1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.initializers as jinit
import hetu_tpu.ops.moe as jmoe
import hetu_tpu_torch as pt
import hetu_tpu_torch.initializers as tinit
import hetu_tpu_torch.ops.moe as tmoe
from hetu_tpu.layers import MoELayer as JMoELayer
from hetu_tpu_torch.layers import MoELayer as TMoELayer

T, E, H, F = 64, 4, 128, 256


def _logits(seed, ties=False):
    logits = np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)
    if ties:  # coarse values: many rows hold a tied maximum
        logits = np.round(logits)
    return logits


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _choices_both(logits, k, capacity):
    want, aux_j = jmoe.top_k_gating_choices(jnp.asarray(logits), k, capacity)
    got, aux_t = tmoe.top_k_gating_choices(torch.from_numpy(logits), k,
                                           capacity)
    return want, aux_j, got, aux_t


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("capacity", [64, 12], ids=["no_drops", "drops"])
@pytest.mark.parametrize("k", [1, 2])
def test_top_k_gating_choices_match_jax(k, capacity, ties):
    logits = _logits(k * 100 + capacity, ties)
    want, aux_j, got, aux_t = _choices_both(logits, k, capacity)
    assert len(got) == len(want) == k
    for (ij, gj, pj), (it, gt, p_t) in zip(want, got):
        np.testing.assert_array_equal(_np(it), _np(ij))
        np.testing.assert_array_equal(_np(p_t), _np(pj))
        np.testing.assert_allclose(_np(gt), _np(gj), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(aux_t), _np(aux_j), rtol=1e-6)
    positions = np.concatenate([_np(p) for _, _, p in got])
    dropped = positions >= capacity
    # 64 tokens over 4 experts: capacity 12 drops some, 64 none
    assert dropped.any() == (capacity == 12)
    # dropped choices carry no gate
    gates = np.concatenate([_np(g) for _, g, _ in got])
    assert (gates[dropped] == 0).all()


@pytest.mark.parametrize("k", [1, 2])
def test_top_k_gating_dense_and_balance_aux_match_jax(k):
    logits = _logits(5 + k)
    d_j, c_j, a_j = jmoe.top_k_gating(jnp.asarray(logits), k, 12)
    d_t, c_t, a_t = tmoe.top_k_gating(torch.from_numpy(logits), k, 12)
    np.testing.assert_array_equal(_np(d_t), _np(d_j))
    np.testing.assert_allclose(_np(c_t), _np(c_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(a_t), _np(a_j), rtol=1e-6)
    np.testing.assert_allclose(
        _np(tmoe.top_k_balance_aux(torch.from_numpy(logits))),
        _np(jmoe.top_k_balance_aux(jnp.asarray(logits))), rtol=1e-6)


@pytest.mark.parametrize("capacity", [64, 12], ids=["no_drops", "drops"])
def test_sparse_dispatch_and_combine_match_jax_and_dense(capacity):
    rng = np.random.default_rng(capacity)
    logits = _logits(capacity + 1)
    tokens = rng.standard_normal((T, H)).astype(np.float32)
    expert_out = rng.standard_normal((E, capacity, H)).astype(np.float32)
    want, _, got, _ = _choices_both(logits, 2, capacity)

    d_j = jmoe.sparse_dispatch(jnp.asarray(tokens), want, E, capacity)
    d_t = tmoe.sparse_dispatch(torch.from_numpy(tokens), got, E, capacity)
    assert tuple(d_t.shape) == (E, capacity, H)
    np.testing.assert_array_equal(_np(d_t), _np(d_j))
    c_j = jmoe.sparse_combine(jnp.asarray(expert_out), want)
    c_t = tmoe.sparse_combine(torch.from_numpy(expert_out), got)
    np.testing.assert_allclose(_np(c_t), _np(c_j), rtol=1e-6, atol=1e-6)

    # the dense route: one-hot [T, E, C] tensors and einsums
    dispatch, combine = tmoe._accumulate_dispatch(T, E, capacity, got,
                                                  torch.float32)
    np.testing.assert_allclose(
        _np(torch.einsum("tec,th->ech", dispatch, torch.from_numpy(tokens))),
        _np(d_t), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        _np(torch.einsum("ech,tec->th", torch.from_numpy(expert_out),
                         combine)),
        _np(c_t), rtol=1e-6, atol=1e-7)


def test_layout_transform_ops_match_jax():
    rng = np.random.default_rng(3)
    logits = _logits(9)
    tokens = rng.standard_normal((T, H)).astype(np.float32)
    out = rng.standard_normal((E, 12, H)).astype(np.float32)
    d, c, _ = jmoe.top_k_gating(jnp.asarray(logits), 2, 12)
    d, c = np.array(d), np.array(c)

    def run(pkg, mod):
        ph = pkg.placeholder_op
        x, dd, cc, oo = (ph("x", tokens.shape), ph("d", d.shape),
                         ph("c", c.shape), ph("o", out.shape))
        nodes = [mod.layout_transform_op(x, dd),
                 mod.reverse_layout_transform_op(oo, cc)]
        kw = {} if pkg is jt else {"device": "cpu"}
        return pkg.Executor(nodes, **kw).run(
            feed_dict={x: tokens, dd: d, cc: c, oo: out},
            convert_to_numpy_ret_vals=True)

    for a, b in zip(run(pt, tmoe), run(jt, jmoe)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_mse_loss_matches_jax(reduction):
    rng = np.random.default_rng(4)
    y, y_ = (rng.standard_normal((8, 32, 16)).astype(np.float32)
             for _ in range(2))

    def run(pkg, **kw):
        a, b = pkg.placeholder_op("a", y.shape), pkg.placeholder_op(
            "b", y.shape)
        node = pkg.mse_loss_op(a, b, reduction=reduction)
        return pkg.Executor([node], **kw).run(
            feed_dict={a: y, b: y_}, convert_to_numpy_ret_vals=True)[0]

    np.testing.assert_allclose(run(pt, device="cpu"), np.asarray(run(jt)),
                               rtol=1e-6)


def _layer_graph(pkg, layer_cls, act, sparse=True):
    """bench_moe's graph at a small size: mse(moe(x), y) + 0.01 aux,
    Adam(1e-3), the gradients fetched too; built in the package's own
    name_scope."""
    with pkg.name_scope():
        x = pkg.placeholder_op("moe_x", (2, T // 2, H))
        y = pkg.placeholder_op("moe_y", (2, T // 2, H))
        moe = layer_cls(H, F, num_experts=E, k=2, capacity_factor=1.25,
                        expert_act=act, sparse=sparse)
        out = moe(x)
        aux = moe.aux_loss()
        loss = pkg.mse_loss_op(out, y) + aux * 0.01
        xs = pkg.graph_variables([loss], trainable_only=True)
        grads = pkg.gradients(loss, xs)
        train = pkg.AdamOptimizer(1e-3).apply_gradients(list(zip(grads, xs)))
    return moe, x, y, xs, {"train": [loss, train, *grads],
                           "forward": [out, aux]}


def _feeds(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, T // 2, H)).astype(np.float32),
            0.1 * rng.standard_normal((2, T // 2, H)).astype(np.float32))


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_moe_layer_three_adam_steps_match_jax(act):
    _, xj, yj, vj, nj = _layer_graph(jt, JMoELayer, act)
    moe, xt, yt, vt, nt = _layer_graph(pt, TMoELayer, act)
    jex = jt.Executor(nj)
    tex = pt.Executor(nt, device="cpu")
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    assert [v.name for v in vt] == [v.name for v in vj]
    init = {v.name: tex.params[v.name].clone() for v in vt}

    X, Y = _feeds(0)
    want = jex.run("forward", feed_dict={xj: X, yj: Y},
                   convert_to_numpy_ret_vals=True)
    got = tex.run("forward", feed_dict={xt: X, yt: Y},
                  convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(got[0], want[0], atol=1e-7)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert all(torch.equal(tex.params[k], v) for k, v in init.items())

    for step in range(3):
        X, Y = _feeds(step + 1)
        want = jex.run("train", feed_dict={xj: X, yj: Y},
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict={xt: X, yt: Y},
                      convert_to_numpy_ret_vals=True)
        assert got[1] is None
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        for v, a, b in zip(vt, got[2:], want[2:]):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max(),
                                       err_msg=v.name)
    for v, u in zip(vt, vj):
        before = init[v.name].numpy()
        ref = np.asarray(jex.params[u.name]) - before
        change = tex.params[v.name].numpy() - before
        assert np.linalg.norm(ref) > 0, v.name
        err = np.linalg.norm(change - ref) / np.linalg.norm(ref)
        assert err <= 1e-4, (v.name, err)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_moe_layer_dense_route_matches_sparse(act):
    outs = []
    for sparse in (True, False):
        moe, x, y, _, nodes = _layer_graph(pt, TMoELayer, act, sparse)
        ex = pt.Executor({"forward": nodes["forward"]}, device="cpu")
        if outs:
            ex.load_params(params)
        params = {k: v.numpy() for k, v in ex.params.items()}
        X, Y = _feeds(5)
        outs.append(ex.run("forward", feed_dict={x: X, y: Y},
                           convert_to_numpy_ret_vals=True))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_moe_params_carry_across_by_name():
    jmoe_layer, _, _, vj, nj = _layer_graph(jt, JMoELayer, "gelu")
    _, _, _, vt, nt = _layer_graph(pt, TMoELayer, "gelu")
    jex = jt.Executor(nj)
    tex = pt.Executor(nt, device="cpu")
    params = {k: np.array(v) for k, v in jex.params.items()}
    assert {k: v.shape for k, v in params.items()} == {
        "moe_w1": (E, H, F), "moe_b1": (E, F), "moe_w2": (E, F, H),
        "moe_b2": (E, H), "moe1_w": (H, E)}
    tex.load_params(params)
    for k, v in params.items():
        assert torch.equal(tex.params[k], torch.from_numpy(v)), k
    with pytest.raises(ValueError, match="missing"):
        tex.load_params({k: v for k, v in params.items() if k != "moe_w2"})
    with pytest.raises(ValueError, match="shape"):
        tex.load_params(dict(params, moe_w1=params["moe_w1"].transpose(
            0, 2, 1)))
    _, _, _, _, ns = _layer_graph(pt, TMoELayer, "swiglu")
    sex = pt.Executor(ns, device="cpu")
    assert {k: tuple(v.shape) for k, v in sex.params.items()} == {
        "moe_w1": (E, H, F), "moe_w2": (E, F, H), "moe_w3": (E, H, F),
        "moe1_w": (H, E)}


@pytest.mark.parametrize("shape", [(E, H, F), (E, F, H), (H, E), (E, F)])
def test_xavier_uniform_fans_match_jax(shape):
    assert tinit._fans(shape) == jinit._fans(shape)
    fan_in, fan_out = jinit._fans(shape)
    limit = np.sqrt(6.0 / (fan_in + fan_out))
    got = tinit.xavier_uniform()(torch.Generator().manual_seed(0), shape)
    want = np.asarray(jinit.xavier_uniform()(jax.random.PRNGKey(0), shape))
    for a in (got.numpy(), want):
        assert np.abs(a).max() <= limit
        assert np.abs(a).max() > 0.99 * limit


def test_expert_parallelism_raises_naming_slice_f():
    with pytest.raises(NotImplementedError, match="slice F"):
        TMoELayer(H, F, num_experts=E, ep_axis="ep")


# -- the other gates: hash, k-top-1, SAM, BASE balance --------------------

def _gate_fns(kind):
    """(choices fn, dense fn, aux-only fn or None) of a gate kind, called on
    (module, input) with the kind's hyper-parameters."""
    return {
        "hash": (lambda m, x: m.hash_gating_choices(x, E, 12),
                 lambda m, x: m.hash_gating(x, E, 12), None),
        "ktop1": (lambda m, x: m.ktop1_gating_choices(x, 2, 12),
                  lambda m, x: m.ktop1_gating(x, 2, 12),
                  lambda m, x: m.ktop1_balance_aux(x, 2)),
        "sam": (lambda m, x: m.sam_gating_choices(x, 2, 12, 2),
                lambda m, x: m.sam_gating(x, 2, 12, 2),
                lambda m, x: m.sam_balance_aux(x, 2)),
        "balance": (None, lambda m, x: m.base_balance_gating(x, 20), None),
    }[kind]


def _gate_input(kind, seed):
    if kind == "hash":
        return np.random.default_rng(seed).integers(-50, 50, T).astype(
            np.int32)
    return _logits(seed)


def _as(pkg_mod, a):
    return jnp.asarray(a) if pkg_mod is jmoe else torch.from_numpy(a)


@pytest.mark.parametrize("kind", ["hash", "ktop1", "sam", "balance"])
def test_other_gates_match_jax(kind):
    choices_fn, dense_fn, aux_fn = _gate_fns(kind)
    a = _gate_input(kind, 11)
    if choices_fn is not None:
        want, aux_j = choices_fn(jmoe, _as(jmoe, a))
        got, aux_t = choices_fn(tmoe, _as(tmoe, a))
        for (ij, gj, pj), (it, gt, p_t) in zip(want, got):
            np.testing.assert_array_equal(_np(it), _np(ij))
            np.testing.assert_array_equal(_np(p_t), _np(pj))
            np.testing.assert_allclose(_np(gt), _np(gj), rtol=1e-6, atol=0)
        np.testing.assert_allclose(_np(aux_t), _np(aux_j), rtol=1e-6)
    d_j, c_j, a_j = dense_fn(jmoe, _as(jmoe, a))
    d_t, c_t, a_t = dense_fn(tmoe, _as(tmoe, a))
    np.testing.assert_array_equal(_np(d_t), _np(d_j))
    np.testing.assert_allclose(_np(c_t), _np(c_j), rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(a_t), _np(a_j), rtol=1e-6)
    if aux_fn is not None:
        np.testing.assert_allclose(_np(aux_fn(tmoe, _as(tmoe, a))),
                                   _np(aux_fn(jmoe, _as(jmoe, a))),
                                   rtol=1e-6)


@pytest.mark.parametrize("capacity", [None, 20])
def test_balance_assignment_matches_jax(capacity):
    scores = _logits(12)
    want = np.asarray(jmoe.balance_assignment(jnp.asarray(scores), capacity))
    got = tmoe.balance_assignment(torch.from_numpy(scores), capacity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    cap = capacity or T // E
    assert np.bincount(want, minlength=E).max() <= cap


def test_small_moe_ops_match_jax():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((T, 6)).astype(np.float32)
    groups = rng.integers(0, 3, T).astype(np.int32)
    np.testing.assert_allclose(
        tmoe.sam_group_sum(torch.from_numpy(x), torch.from_numpy(groups),
                           3).numpy(),
        np.asarray(jmoe.sam_group_sum(jnp.asarray(x), jnp.asarray(groups),
                                      3)), rtol=1e-6, atol=1e-6)

    def run(pkg, **kw):
        ph = pkg.placeholder_op
        v, i = ph("v", (10, 6)), ph("i", (10,), dtype=np.int32)
        nodes = [pkg.topk_idx_op(v, k=3), pkg.topk_val_op(v, k=3),
                 pkg.scatter1d_op(v, i, size=16)]
        return pkg.Executor(nodes, **kw).run(
            feed_dict={v: x[:10], i: rng_perm},
            convert_to_numpy_ret_vals=True)

    rng_perm = rng.permutation(16)[:10].astype(np.int32)
    for a, b in zip(run(pt, device="cpu"), run(jt)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="size"):
        tmoe._scatter1d(torch.from_numpy(x), torch.zeros(T, dtype=torch.int32))


def _gate_layer_graph(pkg, layer_cls, kind):
    """An MoE layer with gate ``kind`` (k = 2; hash gets token ids) under
    mse + 0.01 aux and Adam(1e-3), in the package's own name_scope."""
    with pkg.name_scope():
        x = pkg.placeholder_op("moe_x", (2, T // 2, H))
        y = pkg.placeholder_op("moe_y", (2, T // 2, H))
        ids = (pkg.placeholder_op("moe_ids", (2, T // 2), dtype=np.int32)
               if kind == "hash" else None)
        moe = layer_cls(H, F, num_experts=E, k=2, capacity_factor=1.25,
                        gate=kind)
        out = moe(x, ids=ids)
        loss = pkg.mse_loss_op(out, y) + moe.aux_loss() * 0.01
        train = pkg.AdamOptimizer(1e-3).minimize(loss)
    return [p for p in (x, y, ids) if p is not None], {
        "train": [loss, train], "forward": [out]}


@pytest.mark.parametrize("kind", ["hash", "ktop1", "sam", "balance"])
def test_moe_layer_other_gates_match_jax(kind):
    pj, nj = _gate_layer_graph(jt, JMoELayer, kind)
    p_t, nt = _gate_layer_graph(pt, TMoELayer, kind)
    jex = jt.Executor(nj)
    tex = pt.Executor(nt, device="cpu")
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    init = {k: v.clone() for k, v in tex.params.items()}
    ids = np.random.default_rng(14).integers(0, 1000, (2, T // 2)).astype(
        np.int32)
    for step in range(3):
        feeds = list(_feeds(20 + step)) + [ids]
        want = jex.run("train", feed_dict=dict(zip(pj, feeds)),
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict=dict(zip(p_t, feeds)),
                      convert_to_numpy_ret_vals=True)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, before in init.items():
        ref = np.asarray(jex.params[name]) - before.numpy()
        change = tex.params[name].numpy() - before.numpy()
        if name.endswith("_centroids"):  # BASE centroids are not trained
            assert not change.any() and not ref.any()
            continue
        err = np.linalg.norm(change - ref) / np.linalg.norm(ref)
        assert err <= 1e-4, (name, err)
