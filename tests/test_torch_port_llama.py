"""The Llama causal-LM training step through both packages' Executors on
the CPU, without a mesh and under context parallelism.

* Mesh-less: a 2-layer, hidden-64, 4-head, 2-KV-head (GQA 2:1), S=64,
  V=256 Llama, so RoPE, grouped-query attention, RMSNorm and SwiGLU all
  run; both packages run the attention composition at S=64.  The JAX
  executor's params carry across with ``Executor.load_params``; the logits
  of a forward and three ``AdamWOptimizer(1e-3, weight_decay=0.01)``
  steps (bench_llama's labels: the ids rolled by one) are compared.
* cp = 4: a 2-layer, hidden-128, 4-head (d = 32, the blockwise kernels'
  smallest head), 2-KV-head Llama at S=512 under JAX's
  ``Executor(mesh=make_mesh({"cp": 4}))`` and the port's
  ``Executor(mesh=make_mesh({"cp": 4}, devices=["cpu"] * 4))``: local
  length 128, so both run the flash ring (JAX's Pallas block kernels in
  interpret mode, the port's plain versions).  The loss, the gradient of
  every param and the params after two AdamW steps are compared; and the
  port's cp loss and gradients against its own mesh-less step.

Tolerances, f32 (the same arithmetic in another summation order): logits
atol 1e-5; loss rtol 1e-5; gradients atol 1e-6 of the largest gradient
plus rtol 1e-4; each param's change over the steps within 1e-4 of JAX's
change, relative, in the 2-norm, and every entry within atol 5e-5 (lr/20)
of JAX's: Adam moves an entry by ~lr whatever its gradient's size, so an
entry whose gradient is near noise level (readings up to 1.07e-5 on the
q projection, mesh-less) parts the packages by a fraction of lr.  Under
cp = 4 the change tolerance is 3e-4: XLA partitions JAX's step over the 4
devices and sums the lm-head and embedding gradients across them in yet
another order (readings: lm head 1.3e-4, embedding 8.1e-5, the rest below
5e-5).  The ring against
the port's own mesh-less step: loss rtol 1e-5, gradients atol 1e-5 of the
largest plus rtol 1e-3 (the ring combines per-block softmax sums with
logaddexp, in another order than the one-block softmax).
"""

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
from hetu_tpu.parallel.mesh import make_mesh as jax_make_mesh
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm
from hetu_tpu_torch.parallel import make_mesh

LR = 1e-3


def _config(models, hidden, S):
    return models.LlamaConfig(vocab_size=256, hidden_size=hidden,
                              num_layers=2, num_heads=4, num_kv_heads=2,
                              intermediate_size=2 * hidden, seq_len=S)


def _build(pkg, models, B, S, hidden, name):
    """{"train", "grads", "logits"} subgraphs of one Llama, built inside
    the package's own name_scope; returns (nodes, trainable vars)."""
    with pkg.name_scope():
        ids = pkg.placeholder_op("lm_ids", (B, S), dtype=np.int32)
        labels = pkg.placeholder_op("lm_labels", (B, S), dtype=np.int32)
        model = models.LlamaForCausalLM(_config(models, hidden, S),
                                        name=name)
        loss = model.loss(ids, labels)
        logits = model(ids)
        xs = pkg.graph_variables([loss], trainable_only=True)
        train_op = pkg.AdamWOptimizer(learning_rate=LR,
                                      weight_decay=0.01).minimize(loss)
        grads = pkg.gradients(loss, xs)
    return {"train": [loss, train_op], "grads": [loss, *grads],
            "logits": [logits]}, xs


def _feed(seed, B, S):
    ids = np.random.default_rng(seed).integers(0, 256, (B, S))
    return {"lm_ids": ids.astype(np.int32),
            "lm_labels": np.roll(ids, -1, 1).astype(np.int32)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grads_close(got, want, rtol, atol_frac):
    scale = max(np.abs(_np(g)).max() for g in want)
    for g_t, g_j in zip(got, want):
        np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=rtol,
                                   atol=atol_frac * scale)


def _params_close(tex, jex, xs_t, xs_j, init, delta_rtol=1e-4):
    for vt, vj in zip(xs_t, xs_j):
        got = tex.params[vt.name].numpy()
        want = np.asarray(jex.params[vj.name])
        np.testing.assert_allclose(got, want, atol=5e-5)
        d_t, d_j = got - init[vt.name], want - init[vt.name]
        assert (np.linalg.norm(d_t - d_j)
                <= delta_rtol * np.linalg.norm(d_j)), vt.name


def _pair(B, S, hidden, jax_mesh=None, port_mesh=None, tag=""):
    (j_nodes, xs_j) = _build(jt, jm, B, S, hidden, f"llama{tag}")
    (t_nodes, xs_t) = _build(pt, pm, B, S, hidden, f"llama{tag}")
    jex = jt.Executor(j_nodes, mesh=jax_mesh)
    tex = pt.Executor(t_nodes, device="cpu", mesh=port_mesh)
    params = {k: np.asarray(v) for k, v in jex.params.items()}
    tex.load_params(params)
    init = {vt.name: params[vj.name] for vt, vj in zip(xs_t, xs_j)}
    return jex, tex, xs_j, xs_t, init


def test_llama_forward_and_adamw_steps_match_jax():
    B, S = 2, 64
    jex, tex, xs_j, xs_t, init = _pair(B, S, 64)
    assert [v.name for v in xs_t] == [v.name for v in xs_j]
    feed = _feed(0, B, S)
    (lj,) = jex.run("logits", feed_dict=feed, convert_to_numpy_ret_vals=True)
    (lt,) = tex.run("logits", feed_dict=feed, convert_to_numpy_ret_vals=True)
    assert lt.shape == (B * S, 256)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    out_j = jex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    out_t = tex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-5)
    _grads_close(out_t[1:], out_j[1:], 1e-4, 1e-6)
    for step in range(3):
        feed = _feed(step + 1, B, S)
        loss_j = jex.run("train", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)[0]
        loss_t = tex.run("train", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)[0]
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _params_close(tex, jex, xs_t, xs_j, init)


@pytest.fixture(scope="module")
def cp_pair():
    B, S = 2, 512
    return _pair(B, S, 128, jax_mesh=jax_make_mesh({"cp": 4}),
                 port_mesh=make_mesh({"cp": 4}, devices=["cpu"] * 4),
                 tag="cp")


def test_llama_cp4_ring_step_matches_jax(cp_pair):
    B, S = 2, 512
    jex, tex, xs_j, xs_t, init = cp_pair
    feed = _feed(7, B, S)
    out_j = jex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    out_t = tex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-5)
    _grads_close(out_t[1:], out_j[1:], 1e-4, 1e-6)
    for step in range(2):
        feed = _feed(step + 8, B, S)
        loss_j = jex.run("train", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)[0]
        loss_t = tex.run("train", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)[0]
        np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    _params_close(tex, jex, xs_t, xs_j, init, delta_rtol=3e-4)


def test_llama_cp4_ring_matches_the_ports_single_device_step():
    B, S = 2, 512
    nodes, xs = _build(pt, pm, B, S, 128, "llamacmp")
    ex_cp = pt.Executor(nodes, device="cpu", seed=5,
                        mesh=make_mesh({"cp": 4}, devices=["cpu"] * 4))
    ex_sd = pt.Executor(nodes, device="cpu", seed=5)
    feed = _feed(11, B, S)
    out_cp = ex_cp.run("grads", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
    out_sd = ex_sd.run("grads", feed_dict=feed,
                       convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(out_cp[0], out_sd[0], rtol=1e-5)
    _grads_close(out_cp[1:], out_sd[1:], 1e-3, 1e-5)


def test_llama_later_slices_raise():
    with pytest.raises(NotImplementedError, match="slice C"):
        pm.LlamaForCausalLM(pm.LlamaConfig(
            **dict(pm.LLAMA_CONFIGS["baichuan-13b"], num_layers=1)))
    with pytest.raises(NotImplementedError, match="slice C"):
        pm.LlamaForCausalLM(pm.LlamaConfig(
            vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64, num_experts=4))
    with pytest.raises(NotImplementedError, match="slice F"):
        pm.LlamaForCausalLM(pm.LlamaConfig(
            vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
            intermediate_size=64), pipeline_stages=2)
