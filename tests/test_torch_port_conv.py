"""The port's convolutions, pools and BatchNorm on the CPU, held against the
JAX package on the same numpy inputs.

Tolerances, f32: the convolutions' outputs and the gradients of x, w and b
(``jax.vjp`` against ``torch.autograd``) rtol 1e-5 with an atol of 1e-5 of
the largest |value| (XLA's and oneDNN's convolutions sum the same products
in another order); max pool bitwise, forward and backward (a max and a
routing of the cotangent, no arithmetic; random inputs have no ties);
avg pool and the global mean rtol 1e-6, atol 1e-6 (sums of 4-1024 terms in
another order).  BatchNorm: the output and the running stats after 3
steps rtol 1e-5, atol 1e-5 (f32 means over 128 elements in another
order); the gradients of x, scale and bias rtol 1e-4 with an atol of 1e-5
of the largest gradient (the backward's sums over the batch cancel);
bf16 compute: the bf16 output atol 2e-2 (a few bf16 ulps of values ~1,
rounded at other places), the f32 running stats rtol 1e-5 (their stats
are f32 on both sides).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu_torch as pt
import hetu_tpu_torch.layers as pl
import hetu_tpu_torch.ops.nn as pnn


def _close(got, want, rtol=1e-5, rel_atol=1e-5):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rel_atol * scale)


def _vjp_both(jfn, tfn, args, ct_shape, seed=1):
    """Outputs and input gradients of ``jfn`` (JAX) and ``tfn`` (torch) on
    the same numpy ``args`` and a random cotangent."""
    ct = np.random.default_rng(seed).standard_normal(ct_shape).astype(
        np.float32)
    out_j, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    grads_j = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    out_t = tfn(*ts)
    grads_t = torch.autograd.grad(out_t, ts, torch.from_numpy(ct))
    return (out_t.detach().numpy(), np.asarray(out_j),
            [g.numpy() for g in grads_t], [np.asarray(g) for g in grads_j])


# (op, x layout, w layout, stride, padding, dilation, groups, bias)
CONV_CASES = [
    ("conv2d_op", "nchw", "oihw", 1, 0, 1, 1, False),
    ("conv2d_add_bias_op", "nchw", "oihw", 2, 1, 1, 1, True),
    ("conv2d_op", "nchw", "oihw", 1, 2, 2, 2, False),
    ("conv2d_hwio_op", "nchw", "hwio", 1, 1, 1, 1, False),
    ("conv2d_hwio_op", "nchw", "hwio", 2, 1, 2, 1, False),
    ("conv2d_hwio_add_bias_op", "nchw", "hwio", 2, 1, 1, 2, True),
    ("conv2d_nhwc_op", "nhwc", "hwio", 1, 1, 1, 1, False),
    ("conv2d_nhwc_op", "nhwc", "hwio", 1, 2, 2, 2, False),
    ("conv2d_nhwc_add_bias_op", "nhwc", "hwio", 2, 0, 1, 1, True),
]


@pytest.mark.parametrize("case", CONV_CASES,
                         ids=lambda c: f"{c[0]}-s{c[3]}p{c[4]}d{c[5]}g{c[6]}")
def test_conv_forms_match_jax(case):
    name, xl, wl, stride, padding, dilation, groups, bias = case
    rng = np.random.default_rng(0)
    B, C, O, H, W, K = 2, 4, 6, 9, 10, 3
    X = rng.standard_normal((B, C, H, W)).astype(np.float32)
    Wt = rng.standard_normal((O, C // groups, K, K)).astype(np.float32)
    if xl == "nhwc":
        X = X.transpose(0, 2, 3, 1).copy()
    if wl == "hwio":
        Wt = Wt.transpose(2, 3, 1, 0).copy()
    args = [X, Wt] + ([rng.standard_normal(O).astype(np.float32)]
                      if bias else [])
    attrs = dict(stride=stride, padding=padding, dilation=dilation,
                 groups=groups)
    # each package's op constructor on its own nodes; impl is the function
    # the node evaluates
    jnode = getattr(jt, name)(*[jt.placeholder_op(f"c{i}", a.shape)
                                for i, a in enumerate(args)], **attrs)
    tnode = getattr(pt, name)(*[pt.placeholder_op(f"c{i}", a.shape)
                                for i, a in enumerate(args)], **attrs)
    jfn = lambda *a: jnode.impl(*a, **jnode.attrs)  # noqa: E731
    tfn = lambda *a: tnode.impl(*a, **tnode.attrs)  # noqa: E731
    out_shape = np.asarray(jfn(*[jnp.asarray(a) for a in args])).shape
    got, want, g_t, g_j = _vjp_both(jfn, tfn, args, out_shape)
    assert got.shape == want.shape
    _close(got, want)
    for a, b in zip(g_t, g_j):
        _close(a, b)


def test_nhwc_conv_keeps_channels_last_without_copies():
    """The NHWC form views its input as torch's channels_last NCHW and
    returns an NHWC tensor that is contiguous, so no activation is
    copied on the way in or out."""
    x = torch.randn(2, 8, 8, 4)
    w = torch.randn(3, 3, 4, 6)
    out = pnn._conv2d_nhwc(x, w, padding=1)
    assert out.shape == (2, 8, 8, 6) and out.is_contiguous()
    assert x.permute(0, 3, 1, 2).is_contiguous(
        memory_format=torch.channels_last)


POOL_CASES = [
    ("max_pool2d_op", dict(kernel_H=3, kernel_W=3, padding=1, stride=2)),
    ("max_pool2d_op", dict(kernel_H=2, kernel_W=2, padding=0, stride=2)),
    ("avg_pool2d_op", dict(kernel_H=3, kernel_W=3, padding=1, stride=2)),
    ("avg_pool2d_op", dict(kernel_H=2, kernel_W=3, padding=1, stride=1)),
    ("global_avg_pool2d_op", dict(channels_last=False)),
    ("global_avg_pool2d_op", dict(channels_last=True)),
]


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=lambda c: f"{c[0]}-{sorted(c[1].values())}")
def test_pools_match_jax(case):
    name, attrs = case
    X = np.random.default_rng(2).standard_normal((2, 5, 9, 8)).astype(
        np.float32)
    jnode = getattr(jt, name)(jt.placeholder_op("p", X.shape), **attrs)
    tnode = getattr(pt, name)(pt.placeholder_op("p", X.shape), **attrs)
    jfn = lambda a: jnode.impl(a, **jnode.attrs)  # noqa: E731
    tfn = lambda a: tnode.impl(a, **tnode.attrs)  # noqa: E731
    out_shape = np.asarray(jfn(jnp.asarray(X))).shape
    got, want, (g_t,), (g_j,) = _vjp_both(jfn, tfn, [X], out_shape)
    assert got.shape == want.shape
    if name == "max_pool2d_op":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(g_t, g_j)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g_t, g_j, rtol=1e-6, atol=1e-6)


def _bn_graph(pkg, shape, channel_axis, precise):
    """y = bn(x_var + noise); the gradients of sum(y * r) with respect to
    x_var, scale and bias; a ``train`` subgraph (y and the gradients) and
    a ``validate`` one (y, on the running stats)."""
    c = shape[channel_axis]
    xv = pkg.Variable("bnt_x", value=np.zeros(shape, np.float32))
    noise = pkg.placeholder_op("bnt_noise", shape)
    r = pkg.placeholder_op("bnt_r", shape)
    scale = pkg.Variable("bnt_scale", value=np.ones(c, np.float32))
    bias = pkg.Variable("bnt_bias", value=np.zeros(c, np.float32))
    y = pkg.batch_normalization_op(xv + noise, scale, bias,
                                   precise_stats=precise,
                                   channel_axis=channel_axis)
    loss = pkg.reduce_sum_op(y * r)
    grads = pkg.gradients(loss, [xv, scale, bias])
    return {"train": [y, *grads], "validate": [y]}, y, noise, r


def _bn_pair(shape, channel_axis=1, precise=False, compute_dtype=None,
             params=None):
    with jt.name_scope():
        jnodes, jy, jn, jr = _bn_graph(jt, shape, channel_axis, precise)
    with pt.name_scope():
        tnodes, ty, tn, tr = _bn_graph(pt, shape, channel_axis, precise)
    jex = jt.Executor(jnodes, compute_dtype=compute_dtype)
    tex = pt.Executor(tnodes, device="cpu",
                      compute_dtype=None if compute_dtype is None
                      else torch.bfloat16)
    if params is not None:
        jex.params = {k: jnp.asarray(params[k]) for k in jex.params}
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    return (jex, jy, jn, jr), (tex, ty, tn, tr)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("precise", [False, True])
def test_batchnorm_train_eval_matches_jax(layout, precise):
    """Output and gradients at each of 3 training steps, the running stats
    after them, then the evaluation output on those stats."""
    shape, ax = ((8, 3, 4, 4), 1) if layout == "nchw" else ((8, 4, 4, 3), -1)
    rng = np.random.default_rng(3)
    # scale, bias and the running stats off their inits, and x_var
    # centred away from 0 so that the shift matters
    c = shape[ax]
    params = {"bnt_x": (rng.standard_normal(shape) * 2 + 1).astype(
                  np.float32),
              "bnt_scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bnt_bias": rng.standard_normal(c).astype(np.float32),
              "bn_bnt_scale_running_mean": rng.standard_normal(c).astype(
                  np.float32),
              "bn_bnt_scale_running_var": rng.uniform(0.5, 2, c).astype(
                  np.float32)}
    (jex, jy, jn, jr), (tex, ty, tn, tr) = _bn_pair(shape, ax, precise,
                                                   params=params)
    for _ in range(3):
        N = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        R = rng.standard_normal(shape).astype(np.float32)
        want = jex.run("train", feed_dict={jn: N, jr: R},
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict={tn: N, tr: R},
                      convert_to_numpy_ret_vals=True)
        _close(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            _close(a, b, rtol=1e-4)
    for name in (jy.running_mean.name, jy.running_var.name):
        np.testing.assert_allclose(tex.params[name].numpy(),
                                   np.asarray(jex.params[name]),
                                   rtol=1e-5, atol=1e-5)
    assert not np.allclose(tex.params[jy.running_mean.name].numpy(),
                           params[jy.running_mean.name])
    N = rng.standard_normal(shape).astype(np.float32)
    want = jex.run("validate", feed_dict={jn: N},
                   convert_to_numpy_ret_vals=True)[0]
    got = tex.run("validate", feed_dict={tn: N},
                  convert_to_numpy_ret_vals=True)[0]
    _close(got, want)


def test_batchnorm_bf16_reads_the_f32_master_stats():
    """Under compute_dtype=bfloat16 the shift and the running-stat update
    read the f32 masters: running stats set to values bf16 cannot hold
    move to within f32 rounding of JAX's, where the bf16 working copies
    would be off by ~2^-9 relative."""
    shape = (8, 3, 4, 4)
    rng = np.random.default_rng(4)
    # x exact in bf16 and zero noise: the bf16 input is the same in both
    # packages (XLA may keep an f32 sum where torch rounds it to bf16)
    x = jnp.asarray(rng.standard_normal(shape) + 3, jnp.bfloat16)
    params = {"bnt_x": np.asarray(x, np.float32),
              "bnt_scale": np.ones(3, np.float32),
              "bnt_bias": np.zeros(3, np.float32),
              "bn_bnt_scale_running_mean":
                  np.array([3.0123457, 2.9876543, 3.1111111], np.float32),
              "bn_bnt_scale_running_var":
                  np.array([1.0123457, 0.9876543, 1.1111111], np.float32)}
    (jex, jy, jn, jr), (tex, ty, tn, tr) = _bn_pair(
        shape, compute_dtype=jnp.bfloat16, params=params)
    N = np.zeros(shape, np.float32)
    for _ in range(3):
        R = rng.standard_normal(shape).astype(np.float32)
        want = jex.run("train", feed_dict={jn: N, jr: R},
                       convert_to_numpy_ret_vals=True)
        got = tex.run("train", feed_dict={tn: N, tr: R},
                      convert_to_numpy_ret_vals=True)
        np.testing.assert_allclose(got[0], np.asarray(want[0], np.float32),
                                   atol=2e-2)
    for name in (jy.running_mean.name, jy.running_var.name):
        assert tex.params[name].dtype == torch.float32
        np.testing.assert_allclose(tex.params[name].numpy(),
                                   np.asarray(jex.params[name]), rtol=1e-5)


@pytest.mark.parametrize("precise", [False, True])
def test_batchnorm_huge_mean(precise):
    """Per-channel mean ~1e4, std ~1 (tests/test_executor.py's case): the
    two-pass ``precise_stats`` form keeps the variance (JAX's and the f64
    oracle's); the shifted one-pass form with the zero-initialised shift
    loses it in the port as in JAX, while its running mean stays right."""
    shape = (8, 3, 4, 4)
    base = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    X = base + 1e4
    (jex, jy, jn, jr), (tex, ty, tn, tr) = _bn_pair(
        shape, precise=precise, params={
            "bnt_x": X, "bnt_scale": np.ones(3, np.float32),
            "bnt_bias": np.zeros(3, np.float32),
            "bn_bnt_scale_running_mean": np.zeros(3, np.float32),
            "bn_bnt_scale_running_var": np.ones(3, np.float32)})
    zeros = np.zeros(shape, np.float32)
    want = jex.run("train", feed_dict={jn: zeros, jr: zeros},
                   convert_to_numpy_ret_vals=True)[0]
    got = tex.run("train", feed_dict={tn: zeros, tr: zeros},
                  convert_to_numpy_ret_vals=True)[0]
    x64 = X.astype(np.float64)
    true_var = x64.var((0, 2, 3))
    # rv = 0.9 * 1 + 0.1 * var after one step
    var = (tex.params[ty.running_var.name].numpy() - 0.9) / 0.1
    np.testing.assert_allclose(tex.params[ty.running_mean.name].numpy(),
                               0.1 * x64.mean((0, 2, 3)), rtol=1e-5)
    if precise:
        oracle = (x64 - x64.mean((0, 2, 3), keepdims=True)) / np.sqrt(
            x64.var((0, 2, 3), keepdims=True) + 1e-5)
        np.testing.assert_allclose(got, oracle, atol=1e-2)
        np.testing.assert_allclose(got, want, atol=1e-2)
        np.testing.assert_allclose(var, true_var, rtol=1e-3)
    else:
        assert not np.allclose(var, true_var, rtol=0.2)


def test_conv2d_init_has_he_fan_in_of_the_hwio_weight():
    """Conv2d stores HWIO but draws He-normal in OIHW: std sqrt(2 /
    (ci kh kw)), as the JAX layer's; read on the HWIO shape, the fan-in
    would be ci kw co and the std 8x too small here."""
    with pt.name_scope():
        conv = pl.Conv2d(64, 128, 3, bias=False, name="initc")
        x = pt.placeholder_op("initc_x", (1, 64, 8, 8))
        ex = pt.Executor([conv(x)], device="cpu", seed=0)
    w = ex.params[conv.weight.name]
    assert tuple(w.shape) == (3, 3, 64, 128)
    want = np.sqrt(2.0 / (64 * 3 * 3))
    assert float(w.std()) == pytest.approx(want, rel=0.02)
    with jt.name_scope():
        jconv = jt.layers.Conv2d(64, 128, 3, bias=False, name="initc")
        jx = jt.placeholder_op("initc_x", (1, 64, 8, 8))
        jex = jt.Executor([jconv(jx)], seed=0)
    jw = np.asarray(jex.params[jconv.weight.name])
    assert jw.shape == (3, 3, 64, 128)
    assert float(jw.std()) == pytest.approx(want, rel=0.02)


def test_conv2d_oihw_round_trip():
    w = np.random.default_rng(5).standard_normal((6, 4, 3, 2)).astype(
        np.float32)
    hwio = pl.Conv2d.load_oihw(w)
    assert hwio.shape == (3, 2, 4, 6)
    np.testing.assert_array_equal(pl.Conv2d.dump_oihw(hwio), w)
    np.testing.assert_array_equal(
        hwio, jt.layers.Conv2d.load_oihw(w))
