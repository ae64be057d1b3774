"""Iteration-level (continuous-batching) request scheduler (port of
``hetu_tpu/serving/scheduler.py``).

One scheduler iteration == one engine step: first ADMIT queued requests
into free KV slots (FIFO, at most ``prefill_budget`` prefills per
iteration so admission can't starve in-flight decode latency), then the
engine runs ONE slot-batched decode step for everything in flight.  A
request that finishes (EOS or max_new) retires immediately and its slot
goes back to the pool, so the next queued request is admitted on the
very next iteration — mid-flight, without waiting for the rest of the
batch.  This is the orca/vLLM iteration-level scheduling idea with the
compile-once twist that the step shape never changes (empty slots are
masked no-ops, not absent), so each program is captured once.

``gang=True`` turns the same machinery into the static-batching
baseline twin the serve bench compares against: admission waits until
EVERY slot is free, then fills the whole pool at once — requests that
finish early leave their slots idle until the stragglers drain, exactly
the occupancy collapse continuous batching removes.

Admission control (``max_queue``): production engines die by queue, not
by compute — an arrival burst that outruns decode grows the waiting
line without bound until every queued request is past its deadline and
the host is out of memory.  A bounded queue with watermark hysteresis
sheds load at the door instead: once depth hits ``max_queue`` the
scheduler REJECTS new work (typed :class:`EngineOverloaded`, carrying
the depth so clients can back off) until the queue drains to
``low_watermark`` — the hysteresis stops the accept/reject flapping a
single hard bound produces at saturation.  Two documented shed
policies:

* ``"reject_newest"`` (default) — the incoming request is refused;
  everything already queued keeps its FIFO position.  Predictable for
  clients (admission is decided at submit time, never revoked) and the
  right default when requests have no deadlines.
* ``"drop_expired_first"`` — before refusing, queued requests whose
  deadline has already passed are shed (they would be expired at
  admission anyway and are only holding seats); the incoming request is
  refused only if the queue is still full.  Strictly better goodput
  when deadlines are in play — a seat held by a dead request serves
  nobody.

The JAX package mirrors the queue depth, admissions and rejections into
its telemetry registry and request timeline; those are slice G of the
port (ROADMAP.md).  The same numbers stay on the scheduler as attributes
(``rejected``, ``queue_depth_peak``, ``admitted_order``).
"""

from __future__ import annotations

import itertools
from collections import deque

import numpy as np

#: every terminal state a request can reach.  "eos"/"max_new" are the
#: healthy LLM terminals and "scored" the healthy EMBEDDING one (an
#: EmbeddingServer request completes in a single batched
#: lookup+score iteration); "deadline" (TTL passed — at admission or
#: mid-flight), "cancelled" (engine.cancel / scheduler shed), and
#: "error" (decode watchdog quarantined the slot) all return whatever
#: tokens were produced so far as a PARTIAL result.  "failover" is
#: terminal only for the ENGINE-LEVEL attempt: the fleet harvested the
#: request off this engine (crash/quarantine/wedge) and the same rid
#: continues on a sibling — cluster-level, the request is still live.
FINISH_REASONS = ("eos", "max_new", "scored", "deadline", "cancelled",
                  "error", "failover")

#: the healthy terminals — what a fleet treats as "this attempt
#: SUCCEEDED" (everything else is a partial, a refusal, or a fault)
TERMINAL_OK = ("eos", "max_new", "scored")

SHED_POLICIES = ("reject_newest", "drop_expired_first")


class EngineOverloaded(RuntimeError):
    """Admission refused: the request queue is at (or draining from) its
    bound.  Carries ``queue_depth``/``max_queue`` so a client can size
    its backoff instead of guessing."""

    def __init__(self, queue_depth, max_queue):
        super().__init__(
            f"engine overloaded: {queue_depth} requests queued "
            f"(max_queue={max_queue}) — retry after the queue drains")
        self.queue_depth = int(queue_depth)
        self.max_queue = int(max_queue)


class Request:
    """One generation request and its lifecycle timestamps.

    ``rid`` is assigned by the scheduler at submit time (ids are scoped
    PER SCHEDULER, not process-global: two engines each number their
    requests 0, 1, 2, …, so id-keyed records are deterministic per run
    and never collide across engines or leak across tests).  A scheduler
    built with ``rid_prefix=`` mints CLUSTER-LEVEL ids ("e0-0", "e0-1",
    …) so a fleet's records name the engine instance that admitted each
    request; a pre-assigned ``rid=`` (a fleet failing a request over to
    a sibling) is kept as-is.

    ``replay=`` carries tokens a previous attempt already generated (and
    delivered): the engine rebuilds the KV state by teacher-forcing them
    — prefill + one decode step per replayed token through the SAME
    shared executables — without re-emitting them, so a failed-over
    greedy stream continues bitwise identically where it left off.
    """

    def __init__(self, prompt, max_new, arrival=None, stream=None,
                 eos_id=None, deadline=None, replay=None, rid=None,
                 temperature=None, top_k=None, seed=None):
        self.rid = rid            # scheduler-scoped, set on submit
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        self.max_new = int(max_new)
        self.stream = stream
        self.eos_id = eos_id
        # per-request sampling overrides (paged engines thread these as
        # decode operands; None = use the engine's defaults)
        self.temperature = (None if temperature is None
                            else float(temperature))
        self.top_k = None if top_k is None else int(top_k)
        self.seed = None if seed is None else int(seed)
        # absolute deadline on the engine's monotonic clock; None = no TTL
        self.deadline = None if deadline is None else float(deadline)
        if replay is None:
            self.replay = None
        else:
            self.replay = np.asarray(replay, np.int32).reshape(-1)
            if self.replay.size >= self.max_new:
                raise ValueError(
                    f"replay carries {self.replay.size} tokens but "
                    f"max_new={self.max_new} — the request was already "
                    "complete")
        self._replay_pos = 0
        self.tokens = []          # generated ids, prompt excluded
        self.slot = None
        self.finished = False
        self.finish_reason = None   # one of FINISH_REASONS
        self.cancel_requested = False
        # lifecycle clocks (engine fills these from its monotonic clock)
        self.t_arrival = arrival
        self.t_admit = None       # prefill start == queue exit
        self.t_first = None       # first token produced (prefill end)
        self.t_done = None

    def expired(self, now):
        return self.deadline is not None and now >= self.deadline

    # -- failover replay ----------------------------------------------------
    @property
    def replaying(self):
        """True while tokens from a previous attempt remain to rebuild."""
        return (self.replay is not None
                and self._replay_pos < self.replay.size)

    def next_replay(self):
        """The next token to teacher-force (consuming it), or None once
        the replay is exhausted and decoding continues live."""
        if not self.replaying:
            return None
        tok = int(self.replay[self._replay_pos])
        self._replay_pos += 1
        return tok

    # -- latency views (None until the corresponding edge has passed) ------
    @property
    def queue_wait(self):
        if self.t_admit is None or self.t_arrival is None:
            return None
        return self.t_admit - self.t_arrival

    @property
    def ttft(self):
        if self.t_first is None or self.t_arrival is None:
            return None
        return self.t_first - self.t_arrival

    @property
    def tpot(self):
        """Mean time per output token AFTER the first (the decode-rate
        metric); 0.0 for single-token requests."""
        if self.t_done is None or self.t_first is None:
            return None
        n = len(self.tokens)
        return (self.t_done - self.t_first) / (n - 1) if n > 1 else 0.0

    def result(self):
        return np.asarray(self.tokens, np.int32)

    def __repr__(self):
        state = ("done" if self.finished
                 else "running" if self.slot is not None else "queued")
        return (f"Request(id={self.rid}, prompt={self.prompt.size}, "
                f"max_new={self.max_new}, {state})")


class Scheduler:
    """FIFO admission over a SlotKVCache pool, with an optional bounded
    queue (``max_queue`` + watermark hysteresis, see module doc)."""

    def __init__(self, cache, prefill_budget=2, gang=False,
                 max_queue=None, low_watermark=None,
                 shed_policy="reject_newest", rid_prefix=None,
                 lookahead=0):
        if prefill_budget < 1:
            raise ValueError(
                f"prefill_budget must be >= 1, got {prefill_budget}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy must be one of {SHED_POLICIES}, got "
                f"{shed_policy!r}")
        self.cache = cache
        self.prefill_budget = int(prefill_budget)
        self.gang = bool(gang)
        self.max_queue = None if max_queue is None else int(max_queue)
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {self.max_queue}")
        if low_watermark is None:
            # drain to half before reopening — enough hysteresis to stop
            # flapping without holding the door shut for a full drain
            self.low_watermark = (None if self.max_queue is None
                                  else max(0, self.max_queue // 2))
        else:
            self.low_watermark = int(low_watermark)
            if (self.max_queue is not None
                    and not 0 <= self.low_watermark < self.max_queue):
                raise ValueError(
                    f"low_watermark={self.low_watermark} must be in "
                    f"[0, max_queue={self.max_queue})")
        self.shed_policy = shed_policy
        # speculative lookahead: extra per-request token reservation so
        # a verify window (k candidates past the newest position) can
        # never scatter outside the slot's pages — admission stays the
        # only refusal point (engine passes spec_k)
        self.lookahead = int(lookahead)
        if self.lookahead < 0:
            raise ValueError(
                f"lookahead must be >= 0, got {self.lookahead}")
        # prefix-cache hook (engine-installed): prompt -> (pages,
        # n_tokens) of an interned prefix to share into the new slot,
        # or None on a miss
        self.prefix_lookup = None
        self.queue = deque()
        self.running = {}           # slot -> Request
        self.admitted_order = []    # rids in prefill order (FIFO witness)
        self._ids = itertools.count()   # rid source, scoped to THIS scheduler
        # cluster-level ids: "e0-0", "e0-1", … name the engine instance
        self.rid_prefix = None if rid_prefix is None else str(rid_prefix)
        self._shedding = False      # watermark hysteresis state
        self.shed = []              # expired requests shed at submit
        self.rejected = 0
        self.queue_depth_peak = 0

    # -- admission control --------------------------------------------------
    def _admission_open(self):
        """Bounded-queue watermark hysteresis: closed from the moment
        depth hits ``max_queue`` until it drains to ``low_watermark``."""
        if self.max_queue is None:
            return True
        depth = len(self.queue)
        if self._shedding:
            if depth <= self.low_watermark:
                self._shedding = False
                return True
            return False
        if depth >= self.max_queue:
            self._shedding = True
            return False
        return True

    def take_expired(self, now):
        """Remove and return every QUEUED request whose deadline has
        passed (the engine finalizes them with reason "deadline" —
        partial result: zero tokens, never admitted)."""
        if not self.queue:
            return []
        expired = [r for r in self.queue if r.expired(now)]
        if expired:
            self.queue = deque(r for r in self.queue
                               if not r.expired(now))
        return expired

    def submit(self, request, now=None):
        """Assign a scheduler-scoped rid and enqueue, or raise
        :class:`EngineOverloaded` when the bounded queue refuses it
        (after shedding expired seats under ``drop_expired_first``)."""
        if not self._admission_open():
            if (self.shed_policy == "drop_expired_first"
                    and now is not None):
                # expired seats serve nobody: shed them before refusing
                # live work (the engine collects them via drain_shed and
                # records them with reason "deadline").  Freed seats
                # reopen admission immediately — the hysteresis exists
                # to stop flapping under LIVE load, not to refuse work
                # while dead seats are being vacated.
                dropped = self.take_expired(now)
                if dropped:
                    self.shed.extend(dropped)
                    if len(self.queue) < self.max_queue:
                        self._shedding = False
            if not self._admission_open():
                self.rejected += 1
                raise EngineOverloaded(len(self.queue), self.max_queue)
        if request.rid is None:
            n = next(self._ids)
            request.rid = (n if self.rid_prefix is None
                           else f"{self.rid_prefix}-{n}")
        self.queue.append(request)
        depth = len(self.queue)
        if depth > self.queue_depth_peak:
            self.queue_depth_peak = depth
        return request

    def drain_shed(self):
        """Requests ``submit`` shed under ``drop_expired_first`` since
        the last call — the engine finalizes + records them."""
        shed, self.shed = self.shed, []
        return shed

    @property
    def idle(self):
        return not self.queue and not self.running

    def backlog(self):
        """Outstanding token debt, for predictive admission: the
        generated-token budget still owed to queued requests (their
        whole ``max_new``) and running ones (what's left of it)."""
        queued = sum(r.max_new for r in self.queue)
        running = sum(max(0, r.max_new - len(r.tokens))
                      for r in self.running.values())
        return {"depth": len(self.queue) + len(self.running),
                "queued_tokens": int(queued),
                "running_tokens": int(running)}

    def admit(self, token_budget=None):
        """Move queued requests into free slots; returns the admitted
        [(request, slot)] for the engine to prefill, FIFO order.

        ``token_budget`` (paged engines) additionally caps the PROMPT
        tokens admitted this iteration — the chunked-prefill knob that
        keeps one long prompt from stalling in-flight decode.  Slot
        allocation passes each request's worst-case token need
        (prompt + max_new) so a paged pool reserves pages up front and
        can never run out mid-flight."""
        out = []
        if self.gang and self.cache.n_active > 0:
            return out   # static batching: wait for the batch to drain
        budget = self.cache.n_slots if self.gang else self.prefill_budget
        used_tokens = 0
        while self.queue and len(out) < budget:
            req = self.queue[0]
            if (token_budget is not None
                    and used_tokens + int(req.prompt.size) > token_budget
                    and out):
                break   # FIFO: don't skip ahead past a too-long prompt
            shared, shared_tokens = None, 0
            if self.prefix_lookup is not None:
                hit = self.prefix_lookup(req.prompt)
                if hit is not None:
                    shared, shared_tokens = hit
            alloc_kw = {"shared": shared} if shared is not None else {}
            slot = self.cache.alloc(owner=req.rid,
                                    n_tokens=(int(req.prompt.size)
                                              + req.max_new
                                              + self.lookahead),
                                    **alloc_kw)
            if slot is None:
                break
            req.prefix_tokens = shared_tokens
            used_tokens += int(req.prompt.size) - shared_tokens
            self.queue.popleft()
            req.slot = slot
            self.running[slot] = req
            self.admitted_order.append(req.rid)
            out.append((req, slot))
        return out

    def retire(self, request, reason):
        """Release a finished request's slot back to the pool."""
        slot = request.slot
        if slot is None or self.running.get(slot) is not request:
            raise RuntimeError(f"retire of non-running {request!r}")
        request.finished = True
        request.finish_reason = reason
        del self.running[slot]
        request.slot = None
        self.cache.free(slot)

    def remove_queued(self, request):
        """Drop a still-queued request (cancellation); False if it was
        not in the queue (already admitted or finished)."""
        try:
            self.queue.remove(request)
        except ValueError:
            return False
        return True

    def find(self, rid):
        """The live (queued or running) request with this rid, or None."""
        for req in self.running.values():
            if req.rid == rid:
                return req
        for req in self.queue:
            if req.rid == rid:
                return req
        return None

    def reconcile(self):
        """Free cache slots owned by nobody (a leaked slot: allocated
        but absent from ``running``).  A healthy scheduler never has
        any; after a fault (or injected leak) this returns the pool to
        balance instead of letting the engine starve.  Returns the
        number of slots reclaimed."""
        leaked = [s for s in self.cache.allocated_slots()
                  if s not in self.running]
        for s in leaked:
            self.cache.free(s)
        return len(leaked)

    def active_slots(self):
        return sorted(self.running)
