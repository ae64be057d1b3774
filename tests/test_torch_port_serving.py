"""The port's slot serving engine (hetu_tpu_torch/serving/) on the CPU, at
tests/test_serving.py's size (V = 64, hidden 32, 2 layers, 4/2 heads, FFN
56, f32), with the JAX executor's params carried across by
``Executor.load_params``.

* Against the JAX engine: one seeded Poisson trace (bench.py's
  ``_serve_trace`` form) through both engines gives the same greedy
  streams token for token, and ``request_latency_summary`` the same keys.
* The slot engine's contracts of tests/test_serving.py and
  tests/test_serving_robustness.py, each on the port: the pool's cycle and
  overrun, engine = ``greedy_generate``, the gang twin, EOS, FIFO, no
  leak under churn, a fixed seed, compile-once counters, ``stream`` and
  its callback, records, oversize requests, overload with hysteresis and
  the shed policies, deadlines, cancel, the watchdog (a poisoned slot
  quarantined alone, the others bitwise), a raising step, the leak
  reconcile, a detached consumer.
* Sampling: ``top_k=1`` is greedy, and a seed repeats a sampled stream.
* Every argument and method of a later slice raises naming its slice.
"""

import warnings

import numpy as np
import pytest
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
from hetu_tpu.metrics import request_latency_summary as jax_summary
from hetu_tpu.serving import InferenceEngine as JaxEngine
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm
from hetu_tpu_torch.metrics import latency_stats, request_latency_summary
from hetu_tpu_torch.models.llama_decode import greedy_generate
from hetu_tpu_torch.serving import (EngineOverloaded, InferenceEngine,
                                    SlotKVCache)

V = 64
NAME = "psrv"


class InjectedFault(RuntimeError):
    pass


class ManualClock:
    """Deterministic engine clock: deadline tests advance time by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _config(models):
    return models.LlamaConfig(vocab_size=V, hidden_size=32, num_layers=2,
                              num_heads=4, num_kv_heads=2,
                              intermediate_size=56, seq_len=16)


@pytest.fixture(scope="module")
def served():
    """(port executor, port model, jax executor, jax model)."""
    with jt.name_scope():
        jmodel = jm.LlamaForCausalLM(_config(jm), name=NAME)
        ids = jt.placeholder_op(f"{NAME}_ids", (1, 4), dtype=np.int32)
        jex = jt.Executor([jmodel(ids)])
    with pt.name_scope():
        model = pm.LlamaForCausalLM(_config(pm), name=NAME)
        ids = pt.placeholder_op(f"{NAME}_ids", (1, 4), dtype=np.int32)
        ex = pt.Executor([model(ids)], device="cpu")
    ex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    return ex, model, jex, jmodel


def _engine(served, **kw):
    ex, model = served[:2]
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 32)
    kw.setdefault("max_prompt_len", 8)
    return InferenceEngine(ex, model, name=NAME, device="cpu", **kw)


def _prompts(rng, n, lo=3, hi=9):
    return [rng.integers(1, V, (int(L),))
            for L in rng.integers(lo, hi, n)]


def _trace(seed, n, p_lo, p_hi, new_lo, new_hi, mean_gap=0.6):
    """bench.py's ``_serve_trace``: Poisson arrivals in iterations."""
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(mean_gap, n))).astype(int)
    out = []
    for i in range(n):
        p_len = int(rng.integers(p_lo, p_hi + 1))
        out.append((int(arrivals[i]),
                    rng.integers(1, V, (p_len,)).astype(np.int32),
                    int(rng.integers(new_lo, new_hi + 1))))
    return out


def _replay(engine, trace):
    submitted, it, reqs = 0, 0, []
    while submitted < len(trace) or not engine.scheduler.idle:
        while submitted < len(trace) and trace[submitted][0] <= it:
            _, prompt, max_new = trace[submitted]
            reqs.append(engine.submit(prompt, max_new))
            submitted += 1
        engine.step()
        it += 1
    assert all(r.finished for r in reqs)
    return reqs


def _poison(engine, slot):
    """NaN in every cache row of ``slot`` (the port's pool is layer-major:
    [L, S, KV, T, D])."""
    engine.cache.k[:, slot] = float("nan")
    engine.cache.v[:, slot] = float("nan")


def _raising_step(engine, at):
    orig = engine._step_fn
    state = {"n": 0}

    def wrapped(*args, **kw):
        n = state["n"]
        state["n"] += 1
        if n == at:
            raise InjectedFault(f"injected decode-step failure at call {at}")
        return orig(*args, **kw)

    engine._step_fn = wrapped
    return lambda: setattr(engine, "_step_fn", orig)


# -- against the JAX engine ---------------------------------------------------

def test_engine_matches_jax_engine_on_a_seeded_trace(served):
    ex, model, jex, jmodel = served
    trace = _trace(0, 12, 3, 8, 2, 10)
    kw = dict(n_slots=3, max_len=24, max_prompt_len=8, prefill_budget=2,
              name=NAME)
    jreqs = _replay(JaxEngine(jex, jmodel, **kw), trace)
    eng = InferenceEngine(ex, model, device="cpu", **kw)
    reqs = _replay(eng, trace)
    for a, b in zip(reqs, jreqs):
        np.testing.assert_array_equal(a.result(), b.result())
        assert a.finish_reason == b.finish_reason
    got = request_latency_summary(eng.records)
    want = jax_summary(eng.records)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key].keys() == want[key].keys()
        np.testing.assert_allclose([got[key][q] for q in got[key]],
                                   [want[key][q] for q in got[key]])


def test_latency_stats_drop_missing_edges():
    s = latency_stats([0.1, None, 0.3])
    assert s["count"] == 2 and s["max"] == 0.3
    assert np.isclose(s["p50"], 0.2)
    assert np.isnan(latency_stats([])["p99"])


# -- slot pool ----------------------------------------------------------------

def test_slot_pool_alloc_free_cycle():
    pool = SlotKVCache(3, layers=2, kv_heads=2, max_len=8, head_dim=4,
                       device="cpu")
    assert pool.k.shape == (2, 3, 2, 8, 4)
    assert pool.nbytes == 2 * 2 * 3 * 2 * 8 * 4 * 4
    a, b = pool.alloc(owner=1), pool.alloc(owner=2)
    assert (a, b) == (0, 1) and pool.n_free == 1
    pool.free(a)
    assert pool.n_free == 2 and pool.owner(a) is None
    with pytest.raises(RuntimeError, match="double free"):
        pool.free(a)
    c = pool.alloc()
    assert c == a    # freed slot is reused
    assert pool.alloc() is not None
    assert pool.alloc() is None          # exhausted -> None, not raise
    assert pool.audit() == {"allocs": 4, "frees": 1, "in_use": 3}


def test_slot_pool_position_overrun_raises():
    pool = SlotKVCache(1, layers=1, kv_heads=1, max_len=2, head_dim=2,
                       device="cpu")
    s = pool.alloc()
    pool.advance([s])
    pool.advance([s])
    with pytest.raises(RuntimeError, match="overran"):
        pool.advance([s])


# -- output correctness -------------------------------------------------------

def test_engine_matches_single_request_greedy_generate(served, rng):
    ex, model = served[:2]
    prompts = _prompts(rng, 6)
    eng = _engine(served, n_slots=3)
    outs = eng.generate_many(prompts, max_new=6)
    for p, o in zip(prompts, outs):
        want = greedy_generate(ex, model, p[None], 6, name=NAME)[0, len(p):]
        np.testing.assert_array_equal(o, want)


def test_gang_twin_produces_identical_outputs(served, rng):
    prompts = _prompts(rng, 6)
    max_news = [int(m) for m in rng.integers(2, 9, 6)]

    def run(gang):
        e = _engine(served, n_slots=3, gang=gang)
        reqs = [e.submit(p, m) for p, m in zip(prompts, max_news)]
        e.run(max_iterations=2000)
        return e, [r.result() for r in reqs]

    e_cont, outs_c = run(False)
    e_gang, outs_g = run(True)
    for a, b in zip(outs_c, outs_g):
        np.testing.assert_array_equal(a, b)
    assert e_cont.decode_steps <= e_gang.decode_steps


def test_eos_retires_slot_early(served, rng):
    prompts = _prompts(rng, 4)
    probe = _engine(served).generate_many(prompts, max_new=8)
    eos = int(probe[0][3])
    eng = _engine(served, eos_id=eos)
    outs = eng.generate_many(prompts, max_new=8)
    for full, out in zip(probe, outs):
        want = list(full)
        if eos in want:
            want = want[:want.index(eos) + 1]
        np.testing.assert_array_equal(out, np.asarray(want))
    assert [r for r in eng.records if r["finish_reason"] == "eos"]
    assert eng.cache.n_free == eng.cache.n_slots


# -- scheduling invariants ----------------------------------------------------

def test_fifo_admission_order(served, rng):
    eng = _engine(served, prefill_budget=1)
    reqs = [eng.submit(p, int(m)) for p, m in
            zip(_prompts(rng, 8), rng.integers(1, 9, 8))]
    eng.run(max_iterations=2000)
    assert eng.scheduler.admitted_order == [r.rid for r in reqs]


def test_no_slot_leak_mixed_churn(served, rng):
    eng = _engine(served, n_slots=3)
    n = 30
    reqs = [eng.submit(p, int(m)) for p, m in
            zip(_prompts(rng, n), rng.integers(1, 13, n))]
    eng.run(max_iterations=5000)
    assert all(r.finished for r in reqs)
    assert eng.cache.n_free == eng.cache.n_slots
    assert eng.cache.alloc_count == eng.cache.free_count == n
    assert len(eng.records) == n


@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_deterministic_under_fixed_seed(served, rng, temp):
    prompts = _prompts(rng, 5)
    outs = [_engine(served, temperature=temp, top_k=8,
                    seed=7).generate_many(prompts, max_new=6)
            for _ in range(2)]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_top_k_one_samples_the_greedy_stream(served, rng):
    prompts = _prompts(rng, 4)
    greedy = _engine(served).generate_many(prompts, max_new=6)
    top1 = _engine(served, temperature=0.9, top_k=1,
                   seed=3).generate_many(prompts, max_new=6)
    for a, b in zip(greedy, top1):
        np.testing.assert_array_equal(a, b)


def test_compile_once_after_warmup(served, rng):
    eng = _engine(served, n_slots=3)
    eng.generate_many([_prompts(rng, 1)[0]], 2)
    assert eng.trace_counts == {"prefill": 1, "step": 1}
    eng.generate_many(_prompts(rng, 12), 5)
    for p, m in zip(_prompts(rng, 3), (1, 4, 9)):
        eng.submit(p, m)
    eng.run(max_iterations=2000)
    assert eng.trace_counts == {"prefill": 1, "step": 1}


# -- streaming, records, guard rails ------------------------------------------

def test_stream_yields_tokens_incrementally(served, rng):
    ex, model = served[:2]
    p = _prompts(rng, 1)[0]
    seen = list(_engine(served).stream(p, max_new=6))
    assert len(seen) == 6
    want = greedy_generate(ex, model, p[None], 6, name=NAME)[0, len(p):]
    np.testing.assert_array_equal(np.asarray(seen), want)


def test_stream_callback_fires_per_token(served, rng):
    eng = _engine(served)
    got = []
    req = eng.submit(_prompts(rng, 1)[0], 5,
                     stream=lambda tok, r: got.append((tok, r.rid)))
    eng.run(max_iterations=2000)
    assert [t for t, _ in got] == req.tokens
    assert {r for _, r in got} == {req.rid}


def test_request_records_carry_latencies(served, rng):
    eng = _engine(served)
    eng.generate_many(_prompts(rng, 4), 4)
    assert len(eng.records) == 4
    for rec in eng.records:
        assert rec["ttft"] >= rec["queue_wait"] >= 0.0
        assert rec["tpot"] >= 0.0
        assert rec["n_tokens"] == 4
    assert 0.0 < eng.stats()["mean_occupancy"] <= 1.0


def test_oversize_requests_rejected(served, rng):
    eng = _engine(served, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_prompt_len"):
        eng.submit(rng.integers(1, V, (9,)), 2)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(rng.integers(1, V, (8,)), 9)
    with pytest.raises(ValueError, match="max_prompt_len"):
        _engine(served, max_len=8, max_prompt_len=9)


# -- admission control --------------------------------------------------------

def test_overload_raises_typed_with_queue_depth_hint(served, rng):
    eng = _engine(served, max_queue=2)
    eng.submit(_prompts(rng, 1)[0], 4)
    eng.submit(_prompts(rng, 1)[0], 4)
    with pytest.raises(EngineOverloaded) as ei:
        eng.submit(_prompts(rng, 1)[0], 4)
    assert (ei.value.queue_depth, ei.value.max_queue) == (2, 2)
    assert eng.scheduler.rejected == 1
    assert eng.scheduler.queue_depth_peak == 2
    eng.run(max_iterations=500)


def test_watermark_hysteresis_reopens_after_drain(served, rng):
    eng = _engine(served, n_slots=1, max_queue=4, low_watermark=1,
                  prefill_budget=1)
    reqs = [eng.submit(p, 2) for p in _prompts(rng, 4)]
    with pytest.raises(EngineOverloaded):
        eng.submit(_prompts(rng, 1)[0], 2)
    eng.step()
    assert len(eng.scheduler.queue) == 3
    with pytest.raises(EngineOverloaded):
        eng.submit(_prompts(rng, 1)[0], 2)
    while len(eng.scheduler.queue) > 1:
        eng.step()
    late = eng.submit(_prompts(rng, 1)[0], 2)
    eng.run(max_iterations=500)
    assert late.finished and all(r.finished for r in reqs)
    assert eng.scheduler.rejected == 2


def test_drop_expired_first_sheds_dead_seats(served, rng):
    clk = ManualClock()
    eng = _engine(served, n_slots=1, max_queue=2,
                  shed_policy="drop_expired_first", clock=clk)
    dead = [eng.submit(p, 4, ttl=1.0) for p in _prompts(rng, 2)]
    clk.advance(5.0)
    live = eng.submit(_prompts(rng, 1)[0], 4)
    assert all(r.finish_reason == "deadline" and not r.tokens for r in dead)
    assert {d.rid for d in dead} <= {r["id"] for r in eng.records}
    eng.run(max_iterations=500)
    assert live.finish_reason == "max_new"
    eng2 = _engine(served, n_slots=1, max_queue=2, clock=clk)
    for p in _prompts(rng, 2):
        eng2.submit(p, 4, ttl=1.0)
    clk.advance(5.0)
    with pytest.raises(EngineOverloaded):
        eng2.submit(_prompts(rng, 1)[0], 4)
    eng2.run(max_iterations=500)


# -- deadlines ----------------------------------------------------------------

def test_queued_deadline_expires_without_taking_a_slot(served, rng):
    clk = ManualClock()
    eng = _engine(served, n_slots=1, clock=clk)
    hog = eng.submit(_prompts(rng, 1)[0], 10)
    doomed = eng.submit(_prompts(rng, 1)[0], 10, ttl=5.0)
    eng.step()
    clk.advance(10.0)
    eng.run(max_iterations=500)
    assert hog.finish_reason == "max_new" and len(hog.tokens) == 10
    assert doomed.finish_reason == "deadline" and doomed.tokens == []
    assert eng.cache.alloc_count == eng.cache.free_count == 1
    rec = next(r for r in eng.records if r["id"] == doomed.rid)
    assert rec["finish_reason"] == "deadline" and rec["ttft"] is None
    assert eng.expirations == 1


def test_midflight_deadline_returns_partial_and_frees_slot(served, rng):
    clk = ManualClock()
    eng = _engine(served, n_slots=1, clock=clk)
    req = eng.submit(_prompts(rng, 1)[0], 12, ttl=3.0)
    eng.step()
    eng.step()
    produced = len(req.tokens)
    assert 0 < produced < 12
    clk.advance(5.0)
    eng.step()
    assert req.finished and req.finish_reason == "deadline"
    assert len(req.tokens) == produced
    assert eng.cache.n_free == eng.cache.n_slots
    assert eng.cache.alloc_count == eng.cache.free_count == 1


def test_ttl_and_deadline_are_exclusive_and_validated(served, rng):
    eng = _engine(served, clock=ManualClock())
    with pytest.raises(ValueError, match="not both"):
        eng.submit(_prompts(rng, 1)[0], 4, ttl=1.0, deadline=2.0)
    with pytest.raises(ValueError, match="ttl"):
        eng.submit(_prompts(rng, 1)[0], 4, ttl=0.0)


# -- cancellation -------------------------------------------------------------

def test_cancel_running_frees_slot_immediately(served, rng):
    eng = _engine(served, n_slots=1)
    req = eng.submit(_prompts(rng, 1)[0], 12)
    eng.step()
    eng.step()
    produced = len(req.tokens)
    assert produced > 0 and req.slot is not None
    assert eng.cancel(req.rid) is True
    assert req.finished and req.finish_reason == "cancelled"
    assert req.slot is None and eng.cache.n_free == eng.cache.n_slots
    assert len(req.tokens) == produced
    assert eng.cancel(req.rid) is False
    assert eng.cancel(10 ** 9) is False


def test_cancel_queued_never_takes_a_slot(served, rng):
    eng = _engine(served, n_slots=1)
    hog = eng.submit(_prompts(rng, 1)[0], 6)
    queued = eng.submit(_prompts(rng, 1)[0], 6)
    eng.step()
    assert eng.cancel(queued.rid) is True
    assert queued.finish_reason == "cancelled" and queued.tokens == []
    eng.run(max_iterations=500)
    assert hog.finish_reason == "max_new"
    assert eng.cache.alloc_count == eng.cache.free_count == 1


def test_cancel_churn_no_slot_leak(served, rng):
    eng = _engine(served, n_slots=2, prefill_budget=1)
    n = 18
    reqs = [eng.submit(p, int(m)) for p, m in
            zip(_prompts(rng, n), rng.integers(2, 9, n))]
    it = 0
    while not eng.scheduler.idle:
        eng.step()
        it += 1
        if it % 2 == 0:
            victims = [r for r in reqs if r.rid % 3 == 0 and not r.finished]
            if victims:
                eng.cancel(victims[0].rid)
        assert it < 2000
    assert all(r.finished for r in reqs)
    assert eng.cache.alloc_count == eng.cache.free_count
    assert eng.cache.n_free == eng.cache.n_slots
    assert len(eng.records) == n
    cancelled = [r for r in reqs if r.finish_reason == "cancelled"]
    assert cancelled and eng.cancellations == len(cancelled)


# -- the decode watchdog and the other protections ----------------------------

def test_watchdog_quarantines_only_poisoned_slot_bitwise(served, rng):
    prompts = _prompts(rng, 3)
    baseline = _engine(served, n_slots=3,
                       prefill_budget=3).generate_many(prompts, 8)
    eng = _engine(served, n_slots=3, prefill_budget=3)
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.step()
    _poison(eng, reqs[1].slot)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.run(max_iterations=500)
    assert reqs[1].finish_reason == "error"
    assert eng.watchdog_trips >= 1
    np.testing.assert_array_equal(reqs[0].result(), baseline[0])
    np.testing.assert_array_equal(reqs[2].result(), baseline[2])
    assert eng.cache.alloc_count == eng.cache.free_count
    # the engine keeps serving after the quarantine
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = eng.generate_many([prompts[0]], 8)[0]
    np.testing.assert_array_equal(fresh, baseline[0])


def test_raising_step_retires_in_flight_and_engine_survives(served, rng):
    prompts = _prompts(rng, 2)
    eng = _engine(served)
    reqs = [eng.submit(p, 8) for p in prompts]
    undo = _raising_step(eng, at=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.run(max_iterations=500)
    assert all(r.finish_reason == "error" for r in reqs)
    assert eng.cache.n_free == eng.cache.n_slots
    assert len(eng.generate_many([prompts[0]], 6)[0]) == 6
    undo()


def test_unprotected_twin_propagates_the_same_fault(served, rng):
    eng = _engine(served, watchdog=False)
    eng.submit(_prompts(rng, 1)[0], 8)
    _raising_step(eng, at=0)
    with pytest.raises(InjectedFault):
        eng.run(max_iterations=500)


def test_slot_leak_reconciled_within_one_iteration(served, rng):
    eng = _engine(served)
    assert eng.cache.alloc(owner="__injected_leak__") is not None
    reqs = [eng.submit(p, 4) for p in _prompts(rng, 3)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.run(max_iterations=500)
    assert all(r.finished for r in reqs)
    assert eng.slot_leaks_reclaimed >= 1
    assert eng.cache.alloc_count == eng.cache.free_count
    assert eng.cache.n_free == eng.cache.n_slots


def test_stream_consumer_raise_and_stall_are_detached(served, rng):
    clk = ManualClock()
    eng = _engine(served, stream_stall_timeout=1.0, clock=clk)
    got = []

    def fail_cb(tok, req):
        got.append(tok)
        if len(got) > 1:
            raise InjectedFault("consumer gone")

    stalls = []

    def stall_cb(tok, req):
        stalls.append(tok)
        clk.advance(5.0)

    r1 = eng.submit(_prompts(rng, 1)[0], 6, stream=fail_cb)
    r2 = eng.submit(_prompts(rng, 1)[0], 6, stream=stall_cb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.run(max_iterations=500)
    assert eng.streams_detached == 2
    assert len(r1.tokens) == 6 and len(r2.tokens) == 6
    assert len(got) == 2 and len(stalls) == 1
    assert r1.finish_reason == r2.finish_reason == "max_new"


def test_request_ids_scoped_per_scheduler_and_stats(served, rng):
    a, b = _engine(served), _engine(served)
    assert [a.submit(p, 2).rid for p in _prompts(rng, 3)] == [0, 1, 2]
    assert [b.submit(p, 2).rid for p in _prompts(rng, 3)] == [0, 1, 2]
    a.run(max_iterations=500)
    b.run(max_iterations=500)
    clk = ManualClock()
    eng = _engine(served, max_queue=2, clock=clk)
    eng.submit(_prompts(rng, 1)[0], 4)
    eng.submit(_prompts(rng, 1)[0], 4, ttl=1.0)
    with pytest.raises(EngineOverloaded):
        eng.submit(_prompts(rng, 1)[0], 4)
    clk.advance(2.0)
    eng.step()
    s = eng.stats()
    assert (s["rejections"], s["expirations"], s["queue_depth_peak"]) == (
        1, 1, 2)
    for k in ("cancellations", "watchdog_trips", "slot_leaks_reclaimed",
              "streams_detached", "trace_counts"):
        assert k in s
    eng.run(max_iterations=500)


# -- the device rule and what later slices bring ------------------------------

def test_engine_runs_on_the_card_unless_asked_for_the_cpu(served):
    ex, model = served[:2]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(ex, model, name=NAME)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlotKVCache(1, 1, 1, 2, 2)


@pytest.mark.parametrize("kw,slice_", [
    (dict(paged=True), "slice D2"), (dict(page_len=32), "slice D2"),
    (dict(n_pages=64), "slice D2"), (dict(prefill_token_budget=8), "slice D2"),
    (dict(spec_k=2), "slice D2"), (dict(draft=object()), "slice D2"),
    (dict(draft_layers=1), "slice D2"),
    (dict(spec_min_accept=1.0), "slice D2"),
    (dict(prefix_cache=True), "slice D2"), (dict(mesh=object()), "slice D2"),
    (dict(gather_dtype="int8"), "slice D2"),
    (dict(kv_dtype="int8"), "slice D2"),
    (dict(shared_params={}), "slice D2"),
    (dict(latency_buckets=(0.1,)), "slice G")])
def test_later_engine_arguments_raise_naming_their_slice(served, kw, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        _engine(served, **kw)


def test_later_engine_methods_raise_naming_their_slice(served):
    eng = _engine(served)
    for call, slice_ in ((lambda: eng.adopt_request([1], [], [], 0, 2),
                          "slice D2"),
                         (lambda: eng.release_migrated(0), "slice D2"),
                         (eng.cost_programs, "slice G"),
                         (lambda: eng.capture_cost_profiles(None),
                          "slice G")):
        with pytest.raises(NotImplementedError, match=slice_):
            call()
    with pytest.raises(ValueError, match="slice D2"):
        eng.submit([1, 2], 2, temperature=0.5)
    with pytest.raises(NotImplementedError, match="slice D2"):
        pm.make_wdl_scorer(None)


def test_cast_params_serves_bf16_weights(served, rng):
    """``Executor.cast_params`` replaces each floating param by its cast;
    the engine then serves bf16 weights from a bf16 pool."""
    ex = served[0]
    with pt.name_scope():
        model = pm.LlamaForCausalLM(_config(pm), name=NAME)
        ids = pt.placeholder_op(f"{NAME}_ids", (1, 4), dtype=np.int32)
        bex = pt.Executor([model(ids)], device="cpu")
    bex.load_params({k: v.numpy() for k, v in ex.params.items()})
    before = dict(bex.params)
    bex.cast_params(torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bex.params.values())
    for k, t in bex.params.items():
        assert t is not before[k]
        assert torch.equal(t, before[k].to(torch.bfloat16))
    eng = InferenceEngine(bex, model, n_slots=2, max_len=32,
                          max_prompt_len=8, name=NAME, device="cpu")
    assert eng.cache.k.dtype == torch.bfloat16
    outs = eng.generate_many(_prompts(rng, 3), max_new=5)
    assert [len(o) for o in outs] == [5, 5, 5]
    assert all(((o >= 0) & (o < V)).all() for o in outs)


@pytest.mark.parametrize("program", ["_prefill_fn", "_step_fn"])
def test_capture_error_is_never_swallowed(served, rng, program):
    """A program that cannot be captured raises ``CaptureError`` to the
    caller, also under the watchdog (which contains every other fault)."""
    eng = _engine(served)

    def fails():
        raise pt.CaptureError("serving program: capture failed")

    setattr(eng, program, fails)
    eng.submit(_prompts(rng, 1)[0], 4)
    with pytest.raises(pt.CaptureError):
        eng.run(max_iterations=50)
    assert eng.watchdog_trips == 0
