"""The port's KV-cache decode pieces (models/_decode_common.py,
models/llama_decode.py, serving/adapters.py) against the JAX package's,
on the CPU at tests/test_serving.py's size: V = 64, hidden 32, 2 layers,
4 query and 2 KV heads (GQA 2:1), FFN 56, f32.  The JAX executor's params
carry across with ``Executor.load_params``.

Tolerances, f32 (the same arithmetic in another summation order):
attention outputs, block outputs, logits and cache rows atol 1e-5; the
rotary tables atol 1.2e-7 (one f32 ulp at 1: the two libraries' cos and
sin differ by an ulp, the angles are the same bits); tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
from hetu_tpu.models import _decode_common as jdc
from hetu_tpu.models import llama_decode as jld
from hetu_tpu.ops.rotary import _rope_tables as jax_rope
from hetu_tpu.serving.adapters import LlamaSlotAdapter as JaxAdapter
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm
from hetu_tpu_torch.models import _decode_common as pdc
from hetu_tpu_torch.models import llama_decode as pld
from hetu_tpu_torch.ops.rotary import _rope_tables as port_rope
from hetu_tpu_torch.serving import (GPTSlotAdapter, LlamaSlotAdapter,
                                    adapter_for)

V = 64
NAME = "dec"
ATOL = 1e-5


def _config(models, **kw):
    return models.LlamaConfig(vocab_size=V, hidden_size=32, num_layers=2,
                              num_heads=4, num_kv_heads=2,
                              intermediate_size=56, seq_len=16, **kw)


@pytest.fixture(scope="module")
def pair():
    """(jax executor, jax model, port executor, port model): one Llama,
    the JAX params carried into the port."""
    with jt.name_scope():
        jmodel = jm.LlamaForCausalLM(_config(jm), name=NAME)
        ids = jt.placeholder_op(f"{NAME}_ids", (1, 4), dtype=np.int32)
        jex = jt.Executor([jmodel(ids)])
    with pt.name_scope():
        pmodel = pm.LlamaForCausalLM(_config(pm), name=NAME)
        ids = pt.placeholder_op(f"{NAME}_ids", (1, 4), dtype=np.int32)
        pex = pt.Executor([pmodel(ids)], device="cpu")
    pex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    return jex, jmodel, pex, pmodel


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol)


# -- rotary tables ------------------------------------------------------------

@pytest.mark.parametrize("t,d,theta", [(1024, 128, 1e4), (4096, 128, 5e5),
                                       (32, 8, 1e4)])
def test_rope_tables_match_jax_at_decode_positions(t, d, theta):
    jc, js = jax_rope(t, d, theta)
    pc, ps = port_rope(t, d, theta)
    _close(pc, jc, atol=1.2e-7)
    _close(ps, js, atol=1.2e-7)
    # a decode position's row is the same row of a longer table
    pc2, _ = port_rope(t + 7, d, theta)
    assert torch.equal(pc2[:t], pc)


# -- make_attend, make_block, make_picker, pad_prompts ------------------------

@pytest.mark.parametrize("sq,t,per_row_mask", [(1, 12, True), (6, 6, False),
                                               (3, 9, True)])
def test_make_attend_matches_jax(sq, t, per_row_mask):
    rng = np.random.default_rng(sq * 100 + t)
    b, h, kv, d = 3, 4, 2, 8
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    if per_row_mask:
        pos = rng.integers(0, t, (b,))
        mask = (np.arange(t)[None, None, :]
                <= (pos[:, None, None] + np.arange(sq)[None, :, None]))
        want = np.stack([np.asarray(jdc.make_attend(d, h // kv)(
            jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1]),
            jnp.asarray(v[i:i + 1]), jnp.asarray(mask[i])))[0]
            for i in range(b)])
    else:
        mask = np.arange(t)[None, :] <= np.arange(sq)[:, None]
        want = jdc.make_attend(d, h // kv)(q, k, v, jnp.asarray(mask))
    got = pdc.make_attend(d, h // kv)(_t(q), _t(k), _t(v), _t(mask))
    _close(got, want)


def test_make_attend_keeps_the_values_dtype_with_f32_scores():
    """bf16 operands: f32 scores and sums, a bf16 output within bf16
    rounding of the f32 attention."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 1, 8), (2, 2, 16, 8), (2, 2, 16, 8)))
    mask = torch.ones(1, 16, dtype=torch.bool)
    attend = pdc.make_attend(8, 2)
    ref = attend(q, k, v, mask)
    got = attend(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max() < 3e-2


def test_make_block_matches_jax(pair):
    """One layer at per-row write positions: the output and the caches
    (the JAX block returns new caches; the port's writes its own rows in
    place)."""
    jex, jmodel, pex, pmodel = pair
    c = pmodel.config
    rng = np.random.default_rng(2)
    b, sq, t, hd = 3, 1, 10, 8
    x = rng.standard_normal((b, sq, 32)).astype(np.float32)
    ck = rng.standard_normal((b, 2, t, hd)).astype(np.float32)
    cv = rng.standard_normal((b, 2, t, hd)).astype(np.float32)
    pos = np.array([0, 4, 9])
    cos_t, sin_t = jax_rope(t, hd, c.rope_theta)
    cos, sin = np.asarray(cos_t)[pos][:, None], np.asarray(sin_t)[pos][:, None]
    mask = (np.arange(t)[None, :] <= pos[:, None])[:, None]
    jlp = jld.make_layer_params(jmodel.config, NAME)(jex.params, 1)
    jblock = jax.jit(jld.make_block(jmodel.config))
    want = [jblock(jlp, x[i:i + 1], ck[i:i + 1], cv[i:i + 1], cos[i],
                   sin[i], mask[i], pos[i]) for i in range(b)]
    plp = pld.make_layer_params(c, NAME)(pex.params, 1)
    pk, pv = _t(ck), _t(cv)
    got = pld.make_block(c)(plp, _t(x), pk, pv, _t(cos), _t(sin),
                            _t(mask), torch.from_numpy(pos))
    _close(got, np.concatenate([np.asarray(w[0]) for w in want]))
    _close(pk, np.concatenate([np.asarray(w[1]) for w in want]))
    _close(pv, np.concatenate([np.asarray(w[2]) for w in want]))


def test_make_picker_greedy_is_argmax_with_ties_to_the_first():
    logits = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                       [-1.0, -5.0, 0.5, 0.5]], np.float32)
    want = np.asarray(jdc.make_picker(0.0, 0)(jnp.asarray(logits), None))
    got = pdc.make_picker(0.0, 0)(_t(logits), None)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, [1, 0, 2])


def test_make_picker_samples_within_top_k_and_repeats_at_a_seed():
    logits = torch.from_numpy(
        np.random.default_rng(3).standard_normal((64, 40)).astype(
            np.float32))
    pick = pdc.make_picker(0.8, 5)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return pick(logits, g)

    a, b = draw(11), draw(11)
    assert torch.equal(a, b)
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert bool((top5 == a[:, None]).any(-1).all())
    # top_k = 1 is greedy
    g = torch.Generator().manual_seed(0)
    assert torch.equal(pdc.make_picker(0.8, 1)(logits, g),
                       torch.argmax(logits, -1))


def test_pad_prompts_and_param_prefix_match_jax(pair):
    jex, _, pex, _ = pair
    prompts = [np.array([3, 4, 5]), np.array([7]), np.array([1, 2])]
    for pad_to in (None, 6):
        got = pdc.pad_prompts(prompts, pad_to=pad_to)
        want = jdc.pad_prompts(prompts, pad_to=pad_to)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="exceeds"):
        pdc.pad_prompts(prompts, pad_to=2)
    assert (pdc.param_prefix(pex, "_embed_table")
            == jdc.param_prefix(jex, "_embed_table") == NAME)


# -- the slot adapter ---------------------------------------------------------

def _pool(rng, c, s, t):
    shape = (c.num_layers, s, c.num_kv_heads, t,
             c.hidden_size // c.num_heads)
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))


def test_slot_adapter_prefill_matches_jax(pair):
    """Logits of every prompt row, and rows [0, P) of the slot written in
    every layer, the other slots and rows untouched."""
    jex, jmodel, pex, pmodel = pair
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, V, (1, 7)).astype(np.int32)
    jlogits, jk, jv = jax.jit(JaxAdapter(jmodel.config, NAME).prefill)(
        jex.params, jnp.asarray(prompt))
    k, v = _pool(rng, pmodel.config, 3, 12)
    k0, v0 = k.clone(), v.clone()
    ad = LlamaSlotAdapter(pmodel.config, NAME)
    slot = torch.tensor([2])
    logits = ad.prefill(pex.params, torch.from_numpy(prompt), k, v, slot)
    _close(logits, jlogits)
    _close(k[:, 2, :, :7], jk)
    _close(v[:, 2, :, :7], jv)
    assert torch.equal(k[:, :2], k0[:, :2])
    assert torch.equal(v[:, :2], v0[:, :2])
    assert torch.equal(k[:, 2, :, 7:], k0[:, 2, :, 7:])
    rows = torch.tensor([6])
    one = ad.prefill(pex.params, torch.from_numpy(prompt), k, v, slot,
                     rows=rows)
    _close(one, np.asarray(jlogits)[6:7])


def test_slot_adapter_decode_matches_jax(pair):
    """One token per slot at its own position: logits and the row each
    slot writes, in every layer; nothing else of the pool changes."""
    jex, jmodel, pex, pmodel = pair
    c = pmodel.config
    rng = np.random.default_rng(5)
    s, t = 3, 12
    k, v = _pool(rng, c, s, t)
    k0, v0 = k.clone(), v.clone()
    tokens = rng.integers(1, V, (s,)).astype(np.int32)
    positions = np.array([5, 0, 11], np.int32)
    jlogits, jk, jv = jax.jit(JaxAdapter(jmodel.config, NAME).decode)(
        jex.params, jnp.asarray(tokens), jnp.asarray(positions),
        jnp.asarray(k.numpy().transpose(1, 0, 2, 3, 4)),
        jnp.asarray(v.numpy().transpose(1, 0, 2, 3, 4)))
    logits = LlamaSlotAdapter(c, NAME).decode(
        pex.params, torch.from_numpy(tokens).long(),
        torch.from_numpy(positions).long(), k, v)
    _close(logits, jlogits)
    _close(k.permute(1, 0, 2, 3, 4), jk)
    _close(v.permute(1, 0, 2, 3, 4), jv)
    written = torch.zeros(k.shape, dtype=torch.bool)
    for i, p in enumerate(positions):
        written[:, i, :, p] = True
    assert torch.equal(k[~written], k0[~written])
    assert torch.equal(v[~written], v0[~written])


# -- greedy decoding ----------------------------------------------------------

def test_greedy_generate_matches_jax_with_every_steps_logits(pair):
    """Tokens equal to JAX's ``greedy_generate``; then, teacher-forcing
    that stream through both packages' slot adapters, the prefill's and
    every decode step's logits agree and the port picks the same token."""
    jex, jmodel, pex, pmodel = pair
    rng = np.random.default_rng(6)
    prompts = rng.integers(1, V, (2, 5)).astype(np.int32)
    max_new = 8
    want = jld.greedy_generate(jex, jmodel, prompts, max_new, name=NAME)
    got = pld.greedy_generate(pex, pmodel, prompts, max_new, name=NAME)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.shape == (2, 5 + max_new)

    jad = JaxAdapter(jmodel.config, NAME)
    jprefill, jdecode = jax.jit(jad.prefill), jax.jit(jad.decode)
    pad = LlamaSlotAdapter(pmodel.config, NAME)
    t = 5 + max_new
    jk = jnp.zeros((1, 2, 2, t, 8))
    jv = jnp.zeros((1, 2, 2, t, 8))
    pk, pv = torch.zeros(2, 1, 2, t, 8), torch.zeros(2, 1, 2, t, 8)
    row = want[0]
    jl, kn, vn = jprefill(jex.params, jnp.asarray(row[None, :5]))
    jk = jk.at[0, :, :, :5].set(kn)
    jv = jv.at[0, :, :, :5].set(vn)
    pl = pad.prefill(pex.params, _t(row[None, :5]), pk, pv,
                     torch.tensor([0]))
    _close(pl, jl)
    assert int(torch.argmax(pl[-1])) == row[5]
    for pos in range(5, t - 1):
        tok = np.array([row[pos]], np.int32)
        jl, jk, jv = jdecode(jex.params, jnp.asarray(tok),
                                jnp.asarray([pos]), jk, jv)
        pl = pad.decode(pex.params, torch.from_numpy(tok).long(),
                        torch.tensor([pos]), pk, pv)
        _close(pl, jl)
        assert int(torch.argmax(pl[0])) == row[pos + 1]


def test_build_greedy_decode_sampling(pair):
    """top_k = 1 samples the greedy stream; a fixed generator seed
    repeats a sampled stream."""
    _, _, pex, pmodel = pair
    prompts = torch.from_numpy(
        np.random.default_rng(7).integers(1, V, (2, 4)).astype(np.int32))
    greedy = pld.build_greedy_decode(pmodel.config, 6, name=NAME)
    top1 = pld.build_greedy_decode(pmodel.config, 6, name=NAME,
                                   temperature=0.7, top_k=1)
    assert torch.equal(greedy(pex.params, prompts),
                       top1(pex.params, prompts))
    sampled = pld.build_greedy_decode(pmodel.config, 6, name=NAME,
                                      temperature=1.5)
    a = sampled(pex.params, prompts, torch.Generator().manual_seed(3))
    b = sampled(pex.params, prompts, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(a[:, :4], prompts.long())


# -- what later slices bring --------------------------------------------------

def test_moe_and_gpt_decode_raise_naming_slice_c(pair):
    _, _, _, pmodel = pair
    moe = _config(pm)
    moe.num_experts = 4
    for make in (lambda: pld.make_block(moe),
                 lambda: pld.make_layer_params(moe, NAME),
                 lambda: pld.build_greedy_decode(moe, 4, name=NAME)):
        with pytest.raises(NotImplementedError, match="slice C"):
            make()
    with pytest.raises(NotImplementedError, match="slice C"):
        GPTSlotAdapter()

    class GPTish:
        class config:
            seq_len, num_layers = 16, 2

    with pytest.raises(NotImplementedError, match="slice C"):
        adapter_for(GPTish, "gpt")
    assert isinstance(adapter_for(pmodel, NAME), LlamaSlotAdapter)
