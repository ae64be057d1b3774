"""Continuous-batching inference engine over a slot-pooled KV cache (port
of the slot engine of ``hetu_tpu/serving/engine.py``).

``InferenceEngine`` wraps an Executor-trained decode model into exactly
TWO programs whose shapes never change:

* ``prefill`` — one prompt (padded to the fixed bucket P =
  ``max_prompt_len``) through all layers, its K/V written into rows
  [0, P) of its slot of the pool, and the request's first token picked
  from the true last prompt row;
* ``step`` — ONE decode iteration for every slot at once, each slot at
  its own position, each writing its own cache row.  Inactive slots
  compute masked garbage — the price of a static shape — and their
  outputs are discarded on the host.

On the card each program is captured in a CUDA graph (the counterpart of
``jax.jit``, graph/capture.py): the first call runs eagerly, the second
is captured, every later call replays.  The slot, the prompt length, the
tokens, the positions and the active mask are static device buffers the
host fills before a replay, so one graph serves every slot and every
prompt length.  ``trace_counts`` counts the captures (on the CPU, where
programs run eagerly, their first runs): 1 each after warm-up.
``disable_capture()`` runs both eagerly on the card.  Unlike the JAX
package, programs are not shared between engines: each engine's graphs
are bound to its own pool, and two engines of one geometry run the same
kernels on the same shapes, so a twin's streams are the same bits.

The KV pool is written in place: prefill copies its rows into its slot,
a decode step writes one row a slot (the JAX programs rebuild the pool
and XLA updates it in place through donation).  Each program returns
its tokens and a FINITENESS SENTINEL (``prefill``: one ok flag for its
logits row; ``step``: a per-slot ok vector) in one tensor, which the
host reads with one device-to-host copy a call.

The engine serves the dtype ``executor.params`` hold (the KV pool takes
the embedding's dtype): ``Executor.cast_params(torch.bfloat16)`` before
building the engine serves bf16 weights.  It reads the executor's
tensors: an executor step that updates them in place changes what it
serves.  Sampling draws from the engine's ``torch.Generator`` (seeded by
``seed``), registered with the graphs; JAX's ``categorical`` bits cannot
be reproduced (ROADMAP.md §3).

Failure surface (all enabled by default, as in the JAX package):
admission control (``max_queue``, typed ``EngineOverloaded``, watermark
hysteresis, two shed policies), deadlines (``ttl=``/``deadline=``),
cancellation, the decode watchdog (a slot whose logits go non-finite is
quarantined alone; a raising program retires everything in flight and
the engine lives on; a program that cannot be captured raises
``CaptureError`` to the caller), the slot-leak reconcile, and consumer
protection (a raising or stalling stream callback is detached).
``watchdog=False`` builds the unprotected twin.

The paged pool, speculative decoding, the prefix cache, tensor-parallel
and quantized serving, the fleet's migration hooks (slice D2) and the
telemetry mirrors (registry, tracer, request timeline, flight recorder,
cost profiles: slice G) are not ported yet; their arguments and methods
raise naming their slice (ROADMAP.md).  ``records``, ``occupancy``,
``stats()`` and the counter attributes carry the same numbers, and the
``serve_prefill`` / ``serve_decode`` ranges (``torch.profiler``) stand in
for the tracer's spans.

Usage::

    engine = InferenceEngine(ex, model, n_slots=8, max_len=256,
                             max_queue=64)
    outs = engine.generate_many(prompts, max_new=64)      # batch API
    h = engine.submit(prompt, max_new=64, ttl=2.0,
                      stream=lambda tok, req: print(tok)) # callback API
    engine.cancel(h.rid)                                  # mid-flight
    for tok in engine.stream(prompt, max_new=64):         # generator API
        ...
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch
from torch.profiler import record_function

from ..graph.capture import Captured
from ..graph.executor import CaptureError, resolve_device
from ..models._decode_common import make_picker, param_prefix, pad_prompts
from ..parallel.mesh import same_device
from .adapters import adapter_for
from .kv_cache import SlotKVCache
from .scheduler import Request, Scheduler

# arguments of the JAX engine that later slices bring
_LATER = {
    "paged": "slice D2 (the paged pool and chunked prefill)",
    "page_len": "slice D2 (the paged pool and chunked prefill)",
    "n_pages": "slice D2 (the paged pool and chunked prefill)",
    "prefill_token_budget": "slice D2 (the paged pool and chunked prefill)",
    "spec_k": "slice D2 (speculative decoding)",
    "draft": "slice D2 (speculative decoding)",
    "draft_layers": "slice D2 (speculative decoding)",
    "spec_min_accept": "slice D2 (speculative decoding)",
    "prefix_cache": "slice D2 (the prefix cache)",
    "mesh": "slice D2 (tensor-parallel serving)",
    "gather_dtype": "slice D2 (tensor-parallel serving, ops/quant.py)",
    "kv_dtype": "slice D2 (the quantized paged pool, ops/quant.py)",
    "shared_params": "slice D2 (the fleet)",
    "latency_buckets": "slice G (telemetry)",
}


def _later(what, where):
    raise NotImplementedError(
        f"InferenceEngine {what} arrives with {where} of the port "
        "(ROADMAP.md)")


class InferenceEngine:
    """Continuous-batching generation over a slot-pooled KV cache.

    ``gang=True`` degrades scheduling to static batching (admit only
    when every slot is free) — the baseline twin; the numerics and
    programs are identical, only admission differs.  ``watchdog=False``
    disables every host-side protection (quarantine, exception
    containment, leak reconcile) — the unprotected twin.  ``device``:
    the card unless ``"cpu"``; params on another device are copied to
    it.
    """

    def __init__(self, executor, model, n_slots=4, max_len=128,
                 max_prompt_len=None, prefill_budget=2, eos_id=None,
                 temperature=0.0, top_k=0, seed=0, name=None,
                 gang=False, max_queue=None, low_watermark=None,
                 shed_policy="reject_newest", watchdog=True,
                 stream_stall_timeout=None, clock=None, instance=None,
                 device=None, paged=False, spec_k=0, **later):
        if paged:
            _later("paged=True", _LATER["paged"])
        if spec_k:
            _later("spec_k=", _LATER["spec_k"])
        for key, value in later.items():
            if key not in _LATER:
                raise TypeError(f"unexpected keyword argument {key!r}")
            if value is not None:
                _later(f"{key}=", _LATER[key])
        self.device = resolve_device(device)
        params = executor.params
        if not all(same_device(t.device, self.device)
                   for t in params.values()):
            params = {k: t.to(self.device) for k, t in params.items()}
        self.params = params
        self.instance = None if instance is None else str(instance)
        name = name or param_prefix(executor, "_embed_table")
        self.adapter = adapter_for(model, name)
        self.max_len = int(max_len)
        self.max_prompt_len = int(max_prompt_len or max(1, max_len // 2))
        if self.max_prompt_len > self.max_len:
            raise ValueError(
                f"max_prompt_len={self.max_prompt_len} > max_len="
                f"{self.max_len}")
        emb = self.params[self.adapter.embed_param]
        self.cache = SlotKVCache(
            n_slots, self.adapter.layers, self.adapter.kv_heads,
            self.max_len, self.adapter.head_dim, dtype=emb.dtype,
            device=self.device)
        self.scheduler = Scheduler(self.cache,
                                   prefill_budget=prefill_budget,
                                   gang=gang, max_queue=max_queue,
                                   low_watermark=low_watermark,
                                   shed_policy=shed_policy,
                                   rid_prefix=self.instance)
        self.eos_id = eos_id
        self.watchdog = bool(watchdog)
        self.stream_stall_timeout = (
            None if stream_stall_timeout is None
            else float(stream_stall_timeout))
        self._clock = clock if clock is not None else time.perf_counter
        self._sampling = (float(temperature), int(top_k))
        self._pick = make_picker(temperature, top_k)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._last_tokens = np.zeros(n_slots, np.int32)
        # per-request latency records + per-iteration occupancy log
        self.records = []
        self.occupancy = []
        self.decode_steps = 0
        self.prefills = 0
        self.peak_active = 0
        self.peak_live_tokens = 0
        self.cancellations = 0
        self.expirations = 0
        self.watchdog_trips = 0
        self.slot_leaks_reclaimed = 0
        self.streams_detached = 0
        self.replayed_tokens = 0
        self._build()

    # -- the two programs --------------------------------------------------
    def _build(self):
        """The prefill and step programs over static buffers: the prompt
        row, its true length and its slot (``_in_prefill`` [P + 2]); the
        slots' tokens, positions and active flags (``_in_step`` [3, S]).
        The host fills a (pinned) host twin of each and copies it in
        with one transfer a call."""
        adapter, pick, cache = self.adapter, self._pick, self.cache
        dev, p_max, s = self.device, self.max_prompt_len, cache.n_slots
        pin = dev.type == "cuda"

        def buffers(*shape):
            return (torch.zeros(shape, dtype=torch.long, device=dev),
                    torch.zeros(shape, dtype=torch.long, pin_memory=pin))

        self._in_prefill, self._host_prefill = buffers(p_max + 2)
        self._in_step, self._host_step = buffers(3, s)
        self._out_prefill = torch.zeros(2, dtype=torch.long, pin_memory=pin)
        self._out_step = torch.zeros(2, s, dtype=torch.long, pin_memory=pin)

        def prefill():
            buf = self._in_prefill
            row = adapter.prefill(self.params, buf[:p_max].view(1, p_max),
                                  cache.k, cache.v, buf[p_max + 1:],
                                  rows=buf[p_max:p_max + 1] - 1)
            # watchdog sentinel: finiteness of the row that seeds the
            # request
            ok = torch.isfinite(row).all()
            tok = pick(row, self.generator)[0]
            return torch.stack([tok, ok.long()])

        def step():
            tokens, positions, active = self._in_step
            logits = adapter.decode(self.params, tokens, positions,
                                    cache.k, cache.v)
            # per-slot watchdog sentinel: a poisoned slot flags ONLY
            # itself (slots attend their own cache rows only)
            slot_ok = torch.isfinite(logits).all(dim=-1)
            nxt = pick(logits, self.generator)
            return torch.stack([torch.where(active.bool(), nxt, 0),
                                slot_ok.long()])

        def state():
            return [cache.k, cache.v, *self.params.values()]

        self._prefill_fn = Captured("serving prefill", _no_grad(prefill),
                                    dev, owner=self, state=state)
        self._step_fn = Captured("serving decode step", _no_grad(step),
                                 dev, owner=self, state=state)

    def _call(self, program, dev_in, host_in, host_out):
        """One program call: its inputs in with one copy, its outputs
        out with one copy (the call's only sync)."""
        dev_in.copy_(host_in, non_blocking=True)
        host_out.copy_(program(), non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host_out.numpy()

    @property
    def trace_counts(self):
        """{'prefill': n, 'step': n} — times each program was captured
        (on the CPU: first run); 1 after warm-up means every call since
        replayed the same graph."""
        return {"prefill": self._prefill_fn.builds,
                "step": self._step_fn.builds}

    @property
    def graph_bytes(self):
        """Device bytes the captures of the two programs reserved."""
        return {"prefill": self._prefill_fn.graph_bytes,
                "step": self._step_fn.graph_bytes}

    def cost_programs(self, force=False):
        raise NotImplementedError(
            "cost_programs (AOT cost analysis) arrives with slice G "
            "(telemetry) of the port (ROADMAP.md)")

    def capture_cost_profiles(self, profiler, kind="serve", prefix=None):
        raise NotImplementedError(
            "capture_cost_profiles arrives with slice G (telemetry) of "
            "the port (ROADMAP.md)")

    def adopt_request(self, *args, **kwargs):
        raise NotImplementedError(
            "adopt_request (live KV migration) arrives with slice D2 "
            "(kv_transfer and the fleet) of the port (ROADMAP.md)")

    def release_migrated(self, rid):
        raise NotImplementedError(
            "release_migrated (live KV migration) arrives with slice D2 "
            "(kv_transfer and the fleet) of the port (ROADMAP.md)")

    def close(self):
        """Release the pool's accounting (nothing to release in the
        port: the HBM ledger is slice G).  Idempotent; scheduler/stats
        state stays readable."""
        self.cache.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- request API -------------------------------------------------------
    def submit(self, prompt, max_new, stream=None, eos_id=None,
               arrival=None, deadline=None, ttl=None, replay=None,
               rid=None, temperature=None, top_k=None, seed=None):
        """Queue one generation request; returns its Request handle.
        ``stream(token, request)`` is called per generated token.
        ``ttl`` (seconds from now) or ``deadline`` (absolute, on the
        engine's monotonic clock) bounds the request's lifetime: past
        it, the request finishes with ``finish_reason="deadline"`` and
        whatever tokens it produced.  ``replay=`` teacher-forces a
        previous attempt's tokens to rebuild the KV state without
        re-emitting them, and ``rid=`` keeps that attempt's id.
        Per-request sampling (``temperature=`` / ``top_k=`` / ``seed=``)
        is the paged engine's (slice D2).  Raises
        :class:`~.scheduler.EngineOverloaded` when the bounded queue
        refuses admission."""
        if temperature is not None or top_k is not None or seed is not None:
            raise ValueError(
                "per-request sampling (temperature/top_k/seed) requires "
                "a paged engine, slice D2 of the port (ROADMAP.md); the "
                "slot engine fixes sampling at construction")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size > self.max_prompt_len:
            raise ValueError(
                f"prompt length {prompt.size} exceeds max_prompt_len="
                f"{self.max_prompt_len}")
        max_new = int(max_new)
        if prompt.size + max_new > self.max_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new ({max_new}) exceeds "
                f"max_len={self.max_len}")
        now = self._now()
        if ttl is not None:
            if deadline is not None:
                raise ValueError("pass ttl= or deadline=, not both")
            if ttl <= 0:
                raise ValueError(f"ttl must be > 0, got {ttl}")
            deadline = now + float(ttl)
        req = Request(prompt, max_new,
                      arrival=now if arrival is None else arrival,
                      stream=stream,
                      eos_id=self.eos_id if eos_id is None else eos_id,
                      deadline=deadline, replay=replay, rid=rid)
        try:
            self.scheduler.submit(req, now=now)
        finally:
            # drop_expired_first may have shed dead seats even when the
            # newcomer was still refused — their records must not be lost
            for shed in self.scheduler.drain_shed():
                self.expirations += 1
                self._finalize_unadmitted(shed, "deadline", now)
        return req

    def cancel(self, rid):
        """Cancel the live request with this rid: a queued request
        leaves the queue, a running one is retired MID-FLIGHT (slot
        freed immediately).  Either way it finishes with
        ``finish_reason="cancelled"`` and its partial tokens in
        ``result()``.  Returns True if a live request was cancelled,
        False if the rid is unknown or already finished."""
        req = self.scheduler.find(rid)
        if req is None:
            return False
        now = self._now()
        req.cancel_requested = True
        if req.slot is not None:
            self._finalize_active(req, "cancelled", now)
        else:
            self.scheduler.remove_queued(req)
            self._finalize_unadmitted(req, "cancelled", now)
        self.cancellations += 1
        return True

    def _now(self):
        return self._clock()

    def _absorb_replay(self, req, tok):
        """Book a teacher-forced replay token: it lands in ``tokens``
        (so eos/max_new accounting and ``result()`` see the full stream)
        but is never re-emitted."""
        req.tokens.append(int(tok))
        self.replayed_tokens += 1

    def _detach(self, req, why):
        req.stream = None
        self.streams_detached += 1
        warnings.warn(f"stream callback for request {req.rid} {why}")

    def _emit(self, req, tok, now):
        req.tokens.append(int(tok))
        if req.t_first is None:
            req.t_first = now
        if req.stream is not None:
            t0 = self._clock()
            try:
                req.stream(int(tok), req)
            except Exception as e:
                if not self.watchdog:
                    raise
                # a raising consumer is the CLIENT's fault — detach it
                # and keep decoding; the tokens still land in result()
                self._detach(req, f"raised {type(e).__name__}: {e} — "
                             "detached (decode continues, tokens land in "
                             "result())")
                return
            if (self.stream_stall_timeout is not None
                    and self._clock() - t0 > self.stream_stall_timeout):
                # one stalled delivery already cost a full iteration for
                # every slot; don't let it happen again
                self._detach(req, f"stalled longer than "
                             f"{self.stream_stall_timeout}s — detached "
                             "(decode continues)")

    def _record(self, req):
        self.records.append({
            "id": req.rid, "prompt_len": int(req.prompt.size),
            "n_tokens": len(req.tokens),
            "queue_wait": req.queue_wait, "ttft": req.ttft,
            "tpot": req.tpot, "finish_reason": req.finish_reason})

    def _finalize_active(self, req, reason, now):
        """Retire a RUNNING request (slot freed immediately)."""
        req.t_done = now
        self.scheduler.retire(req, reason)
        self._record(req)

    def _finalize_unadmitted(self, req, reason, now):
        """Finish a request that never held a slot (expired or
        cancelled while queued): zero tokens, ttft None."""
        req.t_done = now
        req.finished = True
        req.finish_reason = reason
        self._record(req)

    def _maybe_retire(self, req, tok, now):
        done_eos = req.eos_id is not None and int(tok) == req.eos_id
        if done_eos or len(req.tokens) >= req.max_new:
            self._finalize_active(req, "eos" if done_eos else "max_new",
                                  now)

    def _expire(self, now):
        """Deadline sweep: queued requests past their deadline finish
        without ever taking a slot; running ones retire mid-flight with
        their partial tokens."""
        for req in self.scheduler.take_expired(now):
            self.expirations += 1
            self._finalize_unadmitted(req, "deadline", now)
        expired = [r for r in self.scheduler.running.values()
                   if r.expired(now)]
        for req in expired:
            self.expirations += 1
            self._finalize_active(req, "deadline", now)

    def harvest(self):
        """Remove every live request (fleet failover): running ones
        retire with the attempt-level ``finish_reason="failover"`` (slot
        freed on the spot), queued ones leave the queue the same way.
        Returns them, running (admission order) before queued (FIFO) —
        the order a sibling should re-admit them in."""
        now = self._now()
        out = []
        for rid in self.scheduler.admitted_order:
            req = next((r for r in self.scheduler.running.values()
                        if r.rid == rid), None)
            if req is not None:
                self._finalize_active(req, "failover", now)
                out.append(req)
        # defensive: any running request not in admitted_order
        for req in list(self.scheduler.running.values()):
            self._finalize_active(req, "failover", now)
            out.append(req)
        while self.scheduler.queue:
            req = self.scheduler.queue.popleft()
            self._finalize_unadmitted(req, "failover", now)
            out.append(req)
        return out

    def _trip(self, why):
        self.watchdog_trips += 1
        warnings.warn(f"decode watchdog: {why}")

    def _quarantine_all(self, reason, now):
        """A fault that cannot be attributed to one slot (a program
        raised): retire everything in flight with "error" and keep the
        engine alive for new work."""
        for req in list(self.scheduler.running.values()):
            self._finalize_active(req, "error", now)
        self._trip(f"{reason} — all in-flight requests retired with "
                   "finish_reason='error'; engine continues")

    # -- the iteration -----------------------------------------------------
    def step(self):
        """One scheduler iteration: expire/admit/prefill, then one fused
        decode step for everything in flight.  Returns the number of
        tokens produced."""
        produced = 0
        self._expire(self._now())
        p_max = self.max_prompt_len
        for req, slot in self.scheduler.admit():
            req.t_admit = self._now()
            padded, _ = pad_prompts([req.prompt], pad_to=p_max)
            host = self._host_prefill.numpy()
            host[:p_max] = padded[0]
            host[p_max] = req.prompt.size
            host[p_max + 1] = slot
            try:
                with record_function("serve_prefill"):
                    tok, ok = self._call(self._prefill_fn, self._in_prefill,
                                         self._host_prefill,
                                         self._out_prefill)
                    self.cache.positions[slot] = req.prompt.size
                    tok, ok = int(tok), bool(ok)
            except CaptureError:
                raise  # a program that cannot be captured is no slot's fault
            except Exception as e:
                if not self.watchdog:
                    raise
                self._trip(f"prefill of request {req.rid} raised "
                           f"{type(e).__name__}: {e} — quarantined")
                self._finalize_active(req, "error", self._now())
                continue
            self.prefills += 1
            now = self._now()
            if self.watchdog and not ok:
                self._trip(f"non-finite prefill logits for request "
                           f"{req.rid} — quarantined")
                self._finalize_active(req, "error", now)
                continue
            forced = req.next_replay()
            if forced is not None:
                # failover replay: the first generated token is already
                # known (and was already delivered) — force it
                tok = forced
                self._last_tokens[slot] = tok
                self._absorb_replay(req, tok)
            else:
                self._last_tokens[slot] = tok
                self._emit(req, tok, now)
                produced += 1
            self._maybe_retire(req, tok, now)
        return produced + self._step_decode()

    def _step_decode(self):
        """One fused decode iteration over every active slot."""
        produced = 0
        live = len(self.scheduler.running)
        if live:
            self.peak_active = max(self.peak_active, live)
            self.peak_live_tokens = max(self.peak_live_tokens,
                                        int(self.cache.positions.sum()))
        slots = self.scheduler.active_slots()
        if slots:
            host = self._host_step.numpy()
            host[0] = self._last_tokens
            host[1] = self.cache.positions
            host[2] = 0
            host[2, slots] = 1
            occ = len(slots) / self.cache.n_slots
            self.occupancy.append(occ)
            try:
                with record_function("serve_decode"):
                    nxt, slot_ok = self._call(self._step_fn, self._in_step,
                                              self._host_step,
                                              self._out_step)
                    self.cache.advance(slots)
            except CaptureError:
                raise
            except Exception as e:
                if not self.watchdog:
                    raise
                self._quarantine_all(
                    f"decode step raised {type(e).__name__}: {e}",
                    self._now())
                return produced
            self.decode_steps += 1
            now = self._now()
            for slot in slots:
                req = self.scheduler.running[slot]
                if self.watchdog and not slot_ok[slot]:
                    # quarantine: only THIS slot is poisoned; the bad
                    # token is never emitted, the slot is reclaimed, and
                    # the other streams stay bitwise identical
                    self._trip(f"non-finite logits in slot {slot} "
                               f"(request {req.rid}) — quarantined")
                    self._finalize_active(req, "error", now)
                    continue
                forced = req.next_replay()
                if forced is not None:
                    # teacher-forced replay step: the cache row written
                    # by this iteration is a function of the FED token
                    tok = forced
                    self._last_tokens[slot] = tok
                    self._absorb_replay(req, tok)
                    self._maybe_retire(req, tok, now)
                    continue
                tok = int(nxt[slot])
                self._last_tokens[slot] = tok
                self._emit(req, tok, now)
                produced += 1
                self._maybe_retire(req, tok, now)
        return self._leak_sweep(produced)

    def _leak_sweep(self, produced):
        """Leak sweep (end of every decode iteration): a slot owned by
        nobody can never be retired through the request path — reclaim
        it so the pool cannot starve."""
        if (self.watchdog
                and self.cache.n_active != len(self.scheduler.running)):
            reclaimed = self.scheduler.reconcile()
            if reclaimed:
                self.slot_leaks_reclaimed += reclaimed
                warnings.warn(
                    f"slot reconcile: reclaimed {reclaimed} leaked KV "
                    "slot(s)")
        return produced

    def run(self, max_iterations=None):
        """Step until queue and slots drain; returns iterations used."""
        it = 0
        while not self.scheduler.idle:
            if max_iterations is not None and it >= max_iterations:
                raise RuntimeError(
                    f"engine did not drain in {max_iterations} iterations")
            self.step()
            it += 1
        return it

    def generate_many(self, prompts, max_new, eos_id=None):
        """Synchronous batch API: submit all, drain, return each
        request's generated ids (prompt excluded)."""
        reqs = [self.submit(p, max_new, eos_id=eos_id) for p in prompts]
        # worst case every request runs alone to max_len
        self.run(max_iterations=(len(reqs) + 1) * (self.max_len + 2))
        return [r.result() for r in reqs]

    def stream(self, prompt, max_new, eos_id=None, ttl=None):
        """Generator API: yields tokens as the engine produces them
        (pumping the engine between yields; other in-flight requests
        advance too)."""
        req = self.submit(prompt, max_new, eos_id=eos_id, ttl=ttl)
        emitted = 0
        guard = (self.max_len + 2) * (len(self.scheduler.queue)
                                      + self.cache.n_slots + 1)
        it = 0
        while emitted < len(req.tokens) or not req.finished:
            if emitted < len(req.tokens):
                emitted += 1
                yield req.tokens[emitted - 1]
                continue
            if it >= guard:
                raise RuntimeError("stream did not make progress")
            self.step()
            it += 1

    def reset_stats(self):
        """Clear per-request records and step counters (NOT the capture
        counters — a capture after warm-up is exactly what the
        compile-once check must still see)."""
        self.records = []
        self.occupancy = []
        self.decode_steps = 0
        self.prefills = 0
        self.peak_active = 0
        self.peak_live_tokens = 0
        self.cancellations = 0
        self.expirations = 0
        self.watchdog_trips = 0
        self.slot_leaks_reclaimed = 0
        self.streams_detached = 0
        self.replayed_tokens = 0

    # -- reporting ---------------------------------------------------------
    def stats(self):
        occ = float(np.mean(self.occupancy)) if self.occupancy else 0.0
        return {"n_slots": self.cache.n_slots,
                "mean_occupancy": round(occ, 4),
                "decode_steps": self.decode_steps,
                "prefills": self.prefills,
                "peak_active": self.peak_active,
                "peak_live_tokens": self.peak_live_tokens,
                "requests_finished": len(self.records),
                "slot_allocs": self.cache.alloc_count,
                "slot_frees": self.cache.free_count,
                "rejections": self.scheduler.rejected,
                "queue_depth_peak": self.scheduler.queue_depth_peak,
                "cancellations": self.cancellations,
                "expirations": self.expirations,
                "watchdog_trips": self.watchdog_trips,
                "slot_leaks_reclaimed": self.slot_leaks_reclaimed,
                "streams_detached": self.streams_detached,
                "replayed_tokens": self.replayed_tokens,
                "trace_counts": self.trace_counts}


def _no_grad(fn):
    def run():
        with torch.no_grad():
            return fn()
    return run
