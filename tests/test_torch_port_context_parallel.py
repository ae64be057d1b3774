"""The port's context parallelism on the CPU, held against the JAX
package's: ``ring_attention`` and ``ulysses_attention`` on a 4-position
mesh (the JAX package's on 4 of the 8 virtual CPU devices, the port's on
``make_mesh({"cp": 4}, devices=["cpu"] * 4)``), on the same numpy q, k, v
and cotangent.

* the flash ring (local length 128: JAX's Pallas block kernels in
  interpret mode, the port's plain versions) and the plain online-softmax
  ring (local length 16), forward and the three gradients;
* a dp = 2 x cp = 2 mesh, the batch passing through;
* Ulysses with the flash kernel (S = 512) and with the composition (S =
  64);
* the graph op's lowering: an Executor with a cp mesh against one
  without, and against the JAX package's (``ring`` and ``ulysses``), as
  ``tests/test_pipeline_cp_moe.py::test_graph_attention_lowers_to_ring_on_cp_mesh``
  does for the JAX package.

Tolerance, f32: atol 2e-5 on the outputs and gradients (both sides
accumulate in f32; the order of the sums differs; the plain ring's
exp/logaddexp run through different libms).  The graph test holds the
loss to rtol 1e-5 and the gradient of w to rtol 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hetu_tpu as jt
from hetu_tpu.parallel import context_parallel as jcp
from hetu_tpu.parallel.mesh import make_mesh as jax_make_mesh
import hetu_tpu_torch as pt
from hetu_tpu_torch.parallel import (make_mesh, ring_attention,
                                     ulysses_attention)
from hetu_tpu_torch.parallel import context_parallel as tcp

ATOL = 2e-5


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _jax(fn, mesh, q, k, v, g):
    o, vjp = jax.vjp(lambda q, k, v: fn(mesh, q, k, v, causal=True),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(o)] + [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port(fn, mesh, q, k, v, g):
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = fn(mesh, q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), torch.from_numpy(g))
    return [o.detach().numpy()] + [x.numpy() for x in grads]


def _close(got, want):
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("axes,S", [({"cp": 4}, 512), ({"cp": 4}, 64),
                                    ({"dp": 2, "cp": 2}, 512)],
                         ids=["flash-ring", "plain-ring", "dp2-cp2"])
def test_ring_attention_matches_jax(axes, S):
    B = 4 if "dp" in axes else 2
    q, k, v, g = _inputs(S, (B, 2, S, 32))
    want = _jax(jcp.ring_attention, jax_make_mesh(axes), q, k, v, g)
    got = _port(ring_attention, make_mesh(axes, devices=["cpu"] * 4),
                q, k, v, g)
    _close(got, want)


def test_flash_ring_runs_one_block_launch_per_step():
    """On the CPU the wrappers run their plain versions and count nothing;
    the ring calls the block forward once a step for all ranks."""
    calls = []
    orig = tcp.flash_attention_block

    def spy(*args, **kw):
        calls.append(kw["ring"])
        return orig(*args, **kw)

    mesh = make_mesh({"cp": 4}, devices=["cpu"] * 4)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, (1, 2, 512, 32)))
    tcp.flash_attention_block = spy
    try:
        ring_attention(mesh, q, k, v)
    finally:
        tcp.flash_attention_block = orig
    assert calls == [(4, 0), (4, 1), (4, 2), (4, 3)]


@pytest.mark.parametrize("S", [512, 64], ids=["flash", "composition"])
def test_ulysses_attention_matches_jax(S):
    q, k, v, g = _inputs(S + 1, (2, 4, S, 32))
    want = _jax(jcp.ulysses_attention, jax_make_mesh({"cp": 4}), q, k, v, g)
    got = _port(ulysses_attention, make_mesh({"cp": 4}, devices=["cpu"] * 4),
                q, k, v, g)
    _close(got, want)


def _graph(pkg, tag, B, H, S, D):
    with pkg.name_scope():
        q = pkg.placeholder_op(f"cpq_{tag}", (B, H, S, D))
        w = pkg.Variable(f"cpw_{tag}", shape=(D, D),
                         initializer=pkg.init.ones())
        qk = pkg.matmul_op(pkg.array_reshape_op(q, output_shape=(-1, D)), w)
        qk = pkg.array_reshape_op(qk, output_shape=(B, H, S, D))
        att = pkg.scaled_dot_product_attention_op(qk, qk, qk, causal=True)
        loss = pkg.reduce_mean_op(att * att)
        (gw,) = pkg.gradients(loss, [w])
    return q, {"train": [loss, gw]}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_graph_attention_lowers_on_cp_mesh(impl):
    B, H, S, D = 1, 4, 512, 32
    Q = np.random.default_rng(8).standard_normal((B, H, S, D)).astype(
        np.float32) * 0.3
    outs = {}
    for tag, mesh in (("cp", make_mesh({"cp": 4}, devices=["cpu"] * 4)),
                      ("local", None)):
        q, nodes = _graph(pt, tag, B, H, S, D)
        ex = pt.Executor(nodes, device="cpu", mesh=mesh, cp_impl=impl)
        outs[tag] = ex.run("train", feed_dict={q: Q},
                           convert_to_numpy_ret_vals=True)
    q, nodes = _graph(jt, "cp", B, H, S, D)
    jex = jt.Executor(nodes, mesh=jax_make_mesh({"cp": 4}), cp_impl=impl)
    outs["jax"] = jex.run("train", feed_dict={q: Q},
                          convert_to_numpy_ret_vals=True)
    for ref in ("local", "jax"):
        np.testing.assert_allclose(outs["cp"][0], outs[ref][0], rtol=1e-5)
        np.testing.assert_allclose(outs["cp"][1], outs[ref][1], rtol=1e-4,
                                   atol=1e-6)


def test_mesh_rules(monkeypatch):
    mesh = make_mesh({"dp": 2, "cp": 2}, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "cp": 2}
    assert mesh.devices.shape == (2, 2)
    x = pt.placeholder_op("mesh_x", (2,))
    # a mesh over distinct devices needs the multi-device transport
    split = make_mesh({"cp": 2}, devices=["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="slice F"):
        pt.Executor([x + 1.0], device="cpu", mesh=split)
    with pytest.raises(NotImplementedError, match="slice F"):
        ring_attention(split, *(torch.zeros(1, 2, 256, 32),) * 3)
    # the mesh's device must be the executor's
    with pytest.raises(ValueError, match="executor's device"):
        pt.Executor([x + 1.0], device="cpu",
                    mesh=make_mesh({"cp": 2}, devices=["meta"] * 2))
    with pytest.raises(ValueError, match="cp_impl"):
        pt.Executor([x + 1.0], device="cpu", cp_impl="spiral")
    with pytest.raises(AssertionError, match="needs 4 devices"):
        make_mesh({"cp": 4}, devices=["cpu"] * 2)
    # devices=None takes the visible CUDA devices, distinct, as JAX does
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(AssertionError, match="have 0"):
        make_mesh({"cp": 1})
