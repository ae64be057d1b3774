"""The GPT causal-LM training step through both packages' Executors on the
CPU (``models/gpt.py``: learned positions, pre-norm causal blocks, a tied
head, the masked-mean sparse CE).

Each package builds its graph inside its own ``name_scope()``; variables
are paired by position and the JAX executor's params carry across with
``Executor.load_params``.  Labels are the ids rolled by one, as
bench_gpt_e2e's.

* S = 64: a 2-layer, hidden-64, 4-head, V = 1024 GPT with dropout off;
  both packages run the attention composition (below the flash gate of
  S = 256).  The logits and loss of a forward, the gradient of every
  param, and three ``AdamWOptimizer(1e-3, weight_decay=0.01)`` steps.
* S = 256: hidden 128, 4 heads (d = 32).  The JAX graph op is let past its
  TPU-only gate (the test's stand-in for ``_use_flash``), so JAX runs its
  Pallas flash forward and backward in interpret mode; the port on the
  CPU runs its plain composition.  The loss, every gradient (``wte``'s
  from the lookup and the tied head together) and the params after three
  AdamW steps.
* A -1 tail on the labels: the masked mean (held to a numpy CE over the
  valid positions of the logits) and, because attention is causal, an
  exactly zero gradient of the position table's rows in the tail.
* bf16 compute over f32 masters: three steps against JAX's.
* Dropout 0.1, the port only: a seed repeats its losses bitwise and
  another seed changes them.

Tolerances, f32 (the same arithmetic in another summation order): logits
atol 1e-5; loss rtol 1e-5; gradients rtol 1e-4 with an atol of 1e-6 of
the largest gradient of the model (the attention key biases' gradient is
zero in exact arithmetic, so both sides hold rounding noise there); params
after the steps atol 5e-5 (lr / 20: Adam moves an entry by ~lr whatever
its gradient's size, so an entry whose gradient is at noise level parts
the packages by a fraction of lr), and each param's change within 1e-4 of
JAX's, relative, in the 2-norm, the key biases (whose change is noise)
excepted from the relative reading.  bf16 compute: both packages round
every activation to bf16 (8 bits) at different places (XLA fuses, PyTorch
rounds each op's output), so the loss is held to rtol 2e-3 and each
param's change over the three steps to within 0.3 of JAX's, relative, in
the 2-norm (as the BERT training test holds it); a param left unchanged
reads 1 and an update of the wrong sign 2, so both fail.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
import hetu_tpu.ops.attention as jattn
import hetu_tpu.ops.pallas.flash_attention as jflash
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm
from hetu_tpu_torch.serving import GPTSlotAdapter, adapter_for

V = 1024
LR = 1e-3


def _config(models, hidden, S, dropout=0.0):
    return models.GPTConfig(vocab_size=V, hidden_size=hidden, num_layers=2,
                            num_heads=4, seq_len=S, dropout_prob=dropout)


def _build(pkg, models, B, S, hidden, name, dropout=0.0):
    """{"train", "grads", "logits"} subgraphs of one GPT, built inside the
    package's own name_scope; returns (nodes, trainable vars)."""
    with pkg.name_scope():
        ids = pkg.placeholder_op("gpt_ids", (B, S), dtype=np.int32)
        labels = pkg.placeholder_op("gpt_labels", (B, S), dtype=np.int32)
        model = models.GPTLMHeadModel(_config(models, hidden, S, dropout),
                                      name=name)
        loss = model.loss(ids, labels)
        logits = model(ids)
        xs = pkg.graph_variables([loss], trainable_only=True)
        train_op = pkg.AdamWOptimizer(learning_rate=LR,
                                      weight_decay=0.01).minimize(loss)
        grads = pkg.gradients(loss, xs)
    return {"train": [loss, train_op], "grads": [loss, *grads],
            "logits": [logits]}, xs


def _feed(seed, B, S, tail=0):
    ids = np.random.default_rng(seed).integers(0, V, (B, S))
    labels = np.roll(ids, -1, 1)
    if tail:
        labels[:, S - tail:] = -1
    return {"gpt_ids": ids.astype(np.int32),
            "gpt_labels": labels.astype(np.int32)}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _grads_close(got, want, rtol=1e-4, atol_frac=1e-6):
    scale = max(np.abs(_np(g)).max() for g in want)
    for g_t, g_j in zip(got, want):
        np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=rtol,
                                   atol=atol_frac * scale)


def _changes(tex, jex, xs_t, xs_j, init):
    """{name: (port's change, JAX's change)} of every trainable param."""
    return {vt.name: (tex.params[vt.name].float().numpy() - init[vt.name],
                      np.asarray(jex.params[vj.name], np.float32)
                      - init[vt.name])
            for vt, vj in zip(xs_t, xs_j)}


def _params_close(tex, jex, xs_t, xs_j, init):
    for name, (d_t, d_j) in _changes(tex, jex, xs_t, xs_j, init).items():
        np.testing.assert_allclose(d_t, d_j, atol=5e-5, err_msg=name)
        if "_k_bias" not in name:
            assert (np.linalg.norm(d_t - d_j)
                    <= 1e-4 * np.linalg.norm(d_j)), name


def _pair(B, S, hidden, tag, jax_compute=None, port_compute=None):
    j_nodes, xs_j = _build(jt, jm, B, S, hidden, f"gpt{tag}")
    t_nodes, xs_t = _build(pt, pm, B, S, hidden, f"gpt{tag}")
    jex = jt.Executor(j_nodes, compute_dtype=jax_compute)
    tex = pt.Executor(t_nodes, device="cpu", compute_dtype=port_compute)
    params = {k: np.asarray(v) for k, v in jex.params.items()}
    tex.load_params(params)
    init = {vt.name: params[vj.name] for vt, vj in zip(xs_t, xs_j)}
    return jex, tex, xs_j, xs_t, init


def _steps(jex, tex, B, S, first_seed, n=3, rtol=1e-5):
    for step in range(n):
        feed = _feed(first_seed + step, B, S)
        loss_j = jex.run("train", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)[0]
        loss_t = tex.run("train", feed_dict=feed,
                         convert_to_numpy_ret_vals=True)[0]
        np.testing.assert_allclose(loss_t, loss_j, rtol=rtol)


def test_gpt_config_and_presets_match_jax():
    for kw in ({}, {"hidden_size": 96, "intermediate_size": 200,
                    "dropout_prob": 0.0}):
        got, want = vars(pm.GPTConfig(**kw)), vars(jm.GPTConfig(**kw))
        assert got == want
    assert pm.GPT_CONFIGS == jm.GPT_CONFIGS
    assert pm.GPTConfig().intermediate_size == 3072


@pytest.mark.parametrize("preset", ["gpt-small", "gpt-2.7b"])
def test_gpt_param_names_and_shapes_match_jax(preset):
    """At a preset's widths and heads (two layers, a short vocab and
    context) both packages make the same variables, in the same order."""
    def variables(pkg, models):
        with pkg.name_scope():
            ids = pkg.placeholder_op("gpt_ids", (1, 16), dtype=np.int32)
            labels = pkg.placeholder_op("gpt_labels", (1, 16),
                                        dtype=np.int32)
            cfg = models.GPTConfig(**dict(models.GPT_CONFIGS[preset],
                                          num_layers=2, vocab_size=64,
                                          seq_len=16))
            loss = models.GPTLMHeadModel(cfg).loss(ids, labels)
            return [(v.name, tuple(v.shape)) for v in
                    pkg.graph_variables([loss], trainable_only=True)]

    got, want = variables(pt, pm), variables(jt, jm)
    assert got == want
    hidden = pm.GPT_CONFIGS[preset]["hidden_size"]
    assert got[:2] == [("gpt_wte_table", (64, hidden)),
                       ("gpt_wpe", (16, hidden))]


def test_gpt_forward_grads_and_adamw_steps_match_jax():
    B, S = 2, 64
    jex, tex, xs_j, xs_t, init = _pair(B, S, 64, "f")
    feed = _feed(0, B, S)
    (lj,) = jex.run("logits", feed_dict=feed, convert_to_numpy_ret_vals=True)
    (lt,) = tex.run("logits", feed_dict=feed, convert_to_numpy_ret_vals=True)
    assert lt.shape == (B * S, V)
    np.testing.assert_allclose(lt, lj, atol=1e-5)
    out_j = jex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    out_t = tex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-5)
    _grads_close(out_t[1:], out_j[1:])
    _steps(jex, tex, B, S, 1)
    _params_close(tex, jex, xs_t, xs_j, init)


def test_gpt_step_matches_jax_pallas_flash_at_s256(monkeypatch):
    """S = 256, d = 32: JAX's graph op runs its Pallas flash kernels in
    interpret mode (let past the TPU-only platform check), the port its
    plain composition on the CPU."""
    calls = []
    flash = jflash.flash_attention

    def counted(*args, **kwargs):
        out = flash(*args, **kwargs)
        calls.append(out is not None)
        return out

    monkeypatch.setattr(jflash, "flash_attention", counted)
    monkeypatch.setattr(jattn, "_use_flash", lambda q: (
        q.ndim == 4 and q.shape[-2] >= jattn._FLASH_MIN_SEQ
        and 32 <= q.shape[-1] <= 512 and q.shape[-1] % 8 == 0))
    B, S = 2, 256
    jex, tex, xs_j, xs_t, init = _pair(B, S, 128, "p")
    feed = _feed(20, B, S)
    out_j = jex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    assert calls and all(calls), calls   # one trace of 2 layers' attention
    out_t = tex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-5)
    # the tied table: rows of tokens absent from the batch take the
    # head's share of the gradient only
    wte = next(i for i, v in enumerate(xs_t) if v.name.endswith("_wte"
                                                                "_table"))
    absent = np.setdiff1d(np.arange(V), feed["gpt_ids"])
    assert np.abs(out_t[1 + wte][absent]).min(1).max() > 0
    _grads_close(out_t[1:], out_j[1:])
    _steps(jex, tex, B, S, 21)
    _params_close(tex, jex, xs_t, xs_j, init)


def test_gpt_ignored_label_tail_matches_jax():
    B, S, tail = 2, 64, 24
    jex, tex, xs_j, xs_t, init = _pair(B, S, 64, "t")
    feed = _feed(30, B, S, tail=tail)
    out_j = jex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    out_t = tex.run("grads", feed_dict=feed, convert_to_numpy_ret_vals=True)
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=1e-5)
    _grads_close(out_t[1:], out_j[1:])
    # the masked mean: the CE of the logits over the valid positions only
    (logits,) = tex.run("logits", feed_dict=feed,
                        convert_to_numpy_ret_vals=True)
    labels = feed["gpt_labels"].reshape(-1)
    valid = labels >= 0
    x = logits[valid].astype(np.float64)
    lse = np.log(np.exp(x - x.max(1, keepdims=True)).sum(1)) + x.max(1)
    want = (lse - x[np.arange(len(x)), labels[valid]]).mean()
    np.testing.assert_allclose(out_t[0], want, rtol=1e-5)
    # causal attention: no valid position sees the tail, so the position
    # table's tail rows get no gradient at all, in both packages
    wpe = next(i for i, v in enumerate(xs_t) if v.name.endswith("_wpe"))
    for out in (out_t, out_j):
        g = _np(out[1 + wpe])
        assert np.all(g[S - tail:] == 0)
        assert np.abs(g[:S - tail]).max() > 0


def test_gpt_bf16_compute_steps_match_jax():
    B, S = 2, 64
    jex, tex, xs_j, xs_t, init = _pair(B, S, 64, "b",
                                       jax_compute=jnp.bfloat16,
                                       port_compute=torch.bfloat16)
    _steps(jex, tex, B, S, 40, rtol=2e-3)
    for name, (d_t, d_j) in _changes(tex, jex, xs_t, xs_j, init).items():
        assert tex.params[name].dtype == torch.float32, name
        if "_k_bias" in name:
            np.testing.assert_allclose(d_t, d_j, atol=6 * 3 * LR,
                                       err_msg=name)
            continue
        assert (np.linalg.norm(d_t - d_j)
                <= 0.3 * np.linalg.norm(d_j)), name


def test_gpt_dropout_repeats_by_seed():
    B, S = 2, 64
    nodes, _ = _build(pt, pm, B, S, 64, "gptd", dropout=0.1)
    init = {k: v.numpy().copy() for k, v in
            pt.Executor(nodes, device="cpu", seed=3).params.items()}

    def losses(seed):
        ex = pt.Executor(nodes, device="cpu", seed=seed)
        ex.load_params(init)
        return [ex.run("train", feed_dict=_feed(50 + i, B, S),
                       convert_to_numpy_ret_vals=True)[0] for i in range(2)]

    a, b, c = losses(3), losses(3), losses(4)
    assert all(np.isfinite(v) for v in a)
    assert [v.tobytes() for v in a] == [v.tobytes() for v in b]
    assert a[0] != c[0]


def test_gpt_later_slices_raise():
    cfg = pm.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                       num_heads=2, seq_len=16)
    for cls in (pm.GPTModel, pm.GPTLMHeadModel):
        with pytest.raises(NotImplementedError, match="slice F"):
            cls(cfg, pipeline_stages=2)
    with pytest.raises(NotImplementedError, match="GPT decode.*slice C"):
        GPTSlotAdapter(cfg, "gpt")
    with pytest.raises(NotImplementedError, match="GPT decode.*slice C"):
        adapter_for(pm.GPTLMHeadModel(cfg), "gpt")
