"""Executor: named subgraphs run as one step each on one device.

Counterpart of ``hetu_tpu/graph/executor.py`` on one device.  The JAX
executor jit-compiles each named subgraph into one XLA program; here one
step function (``SubExecutor._body``) walks the subgraph's topo order op by
op on an explicit device.  On the card that step is captured in one CUDA
graph per signature (the subgraph and each placeholder's shape, as
``jax.jit`` retraces on a new signature), each a ``Captured`` program
(``graph/capture.py``): the first call of a signature
runs the body eagerly on a side stream (it builds the hand-written
kernels and settles the allocator), the second captures it on that
stream into the subgraph's memory pool, with the executor's generator
registered so that each replay draws fresh bits and advances it as an
eager step does, and every later call replays the graph.  Inside the
graph each hand-written kernel stays one launch.  The body reads its
feeds from per-signature static buffers, writes new params and optimizer
state into the tensors already in ``params`` and ``opt_state``, and
returns clones of its outputs, so a replay never works on stale storage
and a value returned once is never changed by a later step.  A capture
that fails (a host read inside the step, an op that cannot be captured)
raises naming the op; nothing falls back to eager by itself.
``disable_capture()`` (the counterpart of ``jax.disable_jit()``) runs
steps eagerly on the card; on the CPU every step runs the same body
eagerly.  ``run_steps`` runs n steps on the same feeds (n replays, no
sync between them), ``profile`` wall-clocks captured steps.

A subgraph trains, as in JAX, iff it holds an optimizer or gradient op and
its name is not ``validate``/``inference``/``eval`` (an explicit
``training=`` overrides): training turns dropout on.  Subgraphs that
train or hold gradient ops run with autograd recording; the others run
under ``torch.inference_mode()``.  Mixed precision follows the JAX policy:
with ``compute_dtype``, floating params and feeds are cast for the step
while ``params`` keep their own dtype (the optimizers update these f32
masters), and integers are never cast.  Updates that ops record
(optimizer steps, the BERT MLM overflow counter) are written into
``params`` in each param's dtype once the step's walk is done, and each
optimizer's state is kept in ``opt_state``.

A ``mesh`` (parallel/mesh.py) whose positions all sit on the executor's
device gives the ops a ``cp`` axis to lower long-context attention onto
(ring or, with ``cp_impl="ulysses"``, Ulysses attention); the params stay
whole on that device, as the JAX executor replicates them over the mesh.

``state_dict`` / ``load_state_dict`` and ``save`` / ``load`` (through
``graph/checkpoint.py``) carry the params, every optimizer's step and
slots, the step count and the generator's state, so that a resumed run
continues bitwise where the saved one stopped.  ``load_params`` and
``load_state_dict`` copy into the executor's tensors, so captured graphs
stay valid; a tensor put into ``params`` or ``opt_state`` by hand is seen
before the next replay, and the subgraph's graphs are captured anew.

Guards, numerics, data parallelism and the parameter server are later
slices (ROADMAP.md).  Those arguments raise ``NotImplementedError`` here
rather than being ignored.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
import warnings
import zlib

import numpy as np
import torch

# CaptureError and disable_capture are the executor's names too
from .capture import (_CAPTURE, CaptureError, Captured, GraphPool,  # noqa: F401
                      disable_capture)
from .checkpoint import (CheckpointError, atomic_pickle, read_checkpoint,
                         validate_state)
from .node import Op, PlaceholderOp, VariableOp, find_topo_sort
from .trace import TraceContext, evaluate

_EVAL_NAMES = ("validate", "inference", "eval")

# Executor keyword arguments of the JAX package that belong to later slices
_LATER = {
    "dist_strategy": "slice A3 (data parallelism) / slice F",
    "comm_mode": "slice A3 (data parallelism) / slice B2 (parameter server)",
    "pipeline": "slice F (pipeline parallelism)",
    "step_guard": "slice G (resilience)",
    "numerics": "slice G (telemetry)",
}
_CP_IMPLS = ("ring", "ulysses")


def torch_dtype(dtype) -> torch.dtype:
    """numpy (or torch) dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def resolve_device(device) -> torch.device:
    """``None`` means the card.  Never falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "hetu_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def init_seed(seed: int, name: str) -> int:
    """The per-variable init seed: ``(seed, crc32(name))`` folded into one
    32-bit integer (the CPU generator keeps 32 bits of its seed), so a
    variable's value depends on its name and the executor seed only, not
    on what else the process built."""
    return zlib.crc32(str(int(seed)).encode(),
                      zlib.crc32(name.encode("utf-8")))


def _to_numpy(t):
    # a copy: the executor's steps update its tensors in place
    t = t.detach().to("cpu", copy=True)
    # numpy has no bfloat16: return such outputs as float32
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class _Signature:
    """One feed signature of a subgraph: its static feed buffers and the
    program (``graph/capture.py``) that runs the step on them."""

    def __init__(self, feeds, program):
        self.feeds = feeds
        self.program = program


class SubExecutor:
    """One named subgraph, run as one step (captured on the card)."""

    def __init__(self, name, eval_nodes, executor):
        self.name = name
        self.eval_nodes = list(eval_nodes)
        self.executor = executor
        self.topo = find_topo_sort(self.eval_nodes)
        self.placeholders = [n for n in self.topo
                             if isinstance(n, PlaceholderOp)]
        self.variables = [n for n in self.topo if isinstance(n, VariableOp)]
        for p in self.placeholders:
            if hasattr(p, "ps_embedding"):
                raise NotImplementedError(
                    f"{p.name}: parameter-server rows arrive with slice B2 of "
                    "the port (ROADMAP.md)")
        self.opt_ops = [n for n in self.topo if hasattr(n, "init_state")]
        # train/eval mode: training iff the subgraph optimizes or
        # differentiates, unless its name marks it as evaluation (the JAX
        # rule, hetu_tpu/graph/executor.py:50-57)
        self.has_grads = any(hasattr(n, "_compute_with_env")
                             for n in self.topo)
        self.training = bool(executor.config.get(
            "training", (bool(self.opt_ops) or self.has_grads)
            and name not in _EVAL_NAMES))
        self._monitor_vars = [v for v in self.variables
                              if v.monitor is not None]
        self._monitor_interval = int(
            executor.config.get("monitor_interval", 200))
        self._runs = 0
        self._sigs = {}    # {feed shapes: _Signature}
        # one CUDA graph memory pool for the subgraph's signatures
        self._pool = GraphPool()
        self._ctx = None   # the running step's TraceContext

    def _signature(self, feed_dict):
        """The signature of ``feed_dict``, its feeds copied into the
        signature's static buffers (in each placeholder's dtype)."""
        ex = self.executor
        fed = {}
        for node, value in (feed_dict or {}).items():
            fed[node.name if isinstance(node, Op) else node] = value
        missing = [p.name for p in self.placeholders if p.name not in fed]
        if missing:
            raise ValueError(f"missing feeds for placeholders: {missing}")
        values = [fed[p.name] for p in self.placeholders]
        values = [v if isinstance(v, torch.Tensor)
                  else torch.as_tensor(np.asarray(v)) for v in values]
        key = tuple(tuple(v.shape) for v in values)
        sig = self._sigs.get(key)
        if sig is None:
            feeds = {p: torch.empty(v.shape, dtype=torch_dtype(p.dtype),
                                    device=ex.device)
                     for p, v in zip(self.placeholders, values)}
            sig = self._sigs[key] = _Signature(feeds, Captured(
                f"the step of subgraph {self.name!r}",
                lambda: self._body(feeds), ex.device, owner=ex,
                state=self._state, pool=self._pool, where=self._failed_at,
                on_stale=self._drop, clone_outputs=True))
        for p, v in zip(self.placeholders, values):
            sig.feeds[p].copy_(v)
        return sig

    def _body(self, feeds):
        """The step: the walk on the static feeds, the recorded updates
        written into ``params`` in place, and clones of the outputs (taken
        before those writes).  The step's TraceContext is kept (a failed
        capture names the op it stopped at from it)."""
        ex = self.executor
        self._ctx = None
        cast = ex._cast
        bindings = {v: cast(ex.params[v.name]) for v in self.variables}
        for p, v in feeds.items():
            bindings[p] = cast(v)
        ctx = TraceContext(
            generator=ex.generator, training=self.training,
            master_params=ex.params if ex.compute_dtype is not None
            else None, mesh=ex.mesh,
            cp_impl=ex.config.get("cp_impl", "ring"))
        ctx.opt_state = ex.opt_state
        self._ctx = ctx
        with (torch.enable_grad() if self.has_grads or self.training
              else torch.inference_mode()):
            vals = evaluate(self.eval_nodes, bindings, ctx, topo=self.topo)
            vals = [v.detach().clone() if isinstance(v, torch.Tensor)
                    else v for v in vals]
            with torch.no_grad():
                for var, val in ctx.updates.items():
                    ex.params[var.name].copy_(val)
                for var, d in ctx.decrements.items():
                    ex.params[var.name].sub_(d)
        return vals

    def _state(self):
        """The tensors a captured step reads and writes in place (the
        program adds the generator it draws from)."""
        ex = self.executor
        out = [ex.params[v.name] for v in self.variables]
        for op in self.opt_ops:
            st = ex.opt_state[op.name]
            out.append(st["step"])
            out += [t for slots in st["slots"].values()
                    for t in slots.values()]
        return out

    def _failed_at(self):
        return f"at op {self._ctx.op if self._ctx is not None else None}"

    @property
    def graph_bytes(self):
        """The device bytes the captures of this subgraph's graphs
        reserved (their memory pool), 0 before any capture."""
        return sum(sig.program.graph_bytes for sig in self._sigs.values())

    def _drop(self):
        """Forget this subgraph's captured graphs (the next call of each
        signature captures anew) and their memory pool: a param, a slot
        or the generator was replaced."""
        for sig in self._sigs.values():
            sig.program.drop()
        self._pool.handle = None

    def _advance(self, n):
        """Count ``n`` steps; check the monitors when one of them falls on
        the cadence (the first run, then every ``monitor_interval``)."""
        self.executor._global_step += n
        first = self._runs + 1
        self._runs += n
        every = self._monitor_interval
        if self._monitor_vars and (
                first == 1 or self._runs // every > (first - 1) // every):
            self.check_monitors()

    def run(self, feed_dict=None, convert_to_numpy_ret_vals=False):
        vals = self._signature(feed_dict).program()
        self._advance(1)
        return _returned(vals, convert_to_numpy_ret_vals)

    def run_steps(self, feed_dict, n, convert_to_numpy_ret_vals=False):
        """Run ``n`` consecutive steps on the SAME feeds and return the
        last step's values (the JAX package's ``run_steps``, one
        ``lax.fori_loop`` dispatch there).  The feeds are copied once; on
        the card each step is a replay of the captured graph, with no
        sync between them.  The step count and the generator advance as
        over ``n`` ``run()`` calls, and the results are the same bits."""
        if n < 1:
            raise ValueError(f"run_steps needs n >= 1, got {n}")
        sig = self._signature(feed_dict)
        for _ in range(n):
            vals = sig.program()
        self._advance(n)
        return _returned(vals, convert_to_numpy_ret_vals)

    def profile(self, feed_dict=None, repeats=10):
        """Wall-clock ``repeats`` steps, after the warm-up that brings the
        signature to replays (reference ``SubExecutor.profile``): seconds
        a step, the device synchronised at the end."""
        sig = self._signature(feed_dict)
        for _ in range(2 if self.executor.device.type == "cuda"
                       and _CAPTURE[0] and sig.program.graph is None
                       else 1):
            self.run(feed_dict)
        _sync(self.executor.device)
        start = time.perf_counter()
        for _ in range(repeats):
            self.run(feed_dict)
        _sync(self.executor.device)
        return (time.perf_counter() - start) / repeats

    def check_monitors(self):
        """Warn on any tripped monitor counter (MLM overflow etc.)."""
        for v in self._monitor_vars:
            msg = v.monitor(float(self.executor.params[v.name]))
            if msg:
                warnings.warn(msg)


def _returned(vals, to_numpy):
    if to_numpy:
        return [None if v is None else _to_numpy(v) for v in vals]
    return vals


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Executor:
    """Runs named subgraphs of one graph on one device.

    ``eval_node_dict`` may be a list (single anonymous subgraph) or a dict
    {name: eval_node_list}.  ``device=None`` means ``"cuda"`` and raises
    when no card is present; pass ``device="cpu"`` to run on the CPU.
    ``seed`` drives variable init and the executor's ``torch.Generator``,
    from which dropout draws.  ``rng_impl`` is accepted for the JAX
    package's signature (it picks a JAX PRNG there) and selects nothing:
    the port has one generator kind.  ``donate_params`` is accepted and
    selects nothing either: each step writes its updates into the tensors
    already in ``params`` and ``opt_state``, so no step holds two copies.
    """

    def __init__(self, eval_node_dict, ctx=None, seed=0, mesh=None,
                 dist_strategy=None, comm_mode=None, compute_dtype=None,
                 device=None, **kwargs):
        later = dict(kwargs, dist_strategy=dist_strategy,
                     comm_mode=comm_mode)
        for key, value in later.items():
            if key in _LATER and value is not None:
                raise NotImplementedError(
                    f"Executor({key}=...) arrives with {_LATER[key]} of the "
                    "port (ROADMAP.md)")
        if isinstance(eval_node_dict, (list, tuple)):
            eval_node_dict = {"default": list(eval_node_dict)}
        self.eval_node_dict = {k: list(v) for k, v in eval_node_dict.items()}
        self.device = resolve_device(device)
        if mesh is not None:
            from ..parallel.mesh import mesh_device, same_device
            dev = mesh_device(mesh, "Executor(mesh=...)")
            if not same_device(dev, self.device):
                raise ValueError(f"the mesh's device {dev} is not the "
                                 f"executor's device {self.device}")
        if kwargs.get("cp_impl", "ring") not in _CP_IMPLS:
            raise ValueError(f"cp_impl must be one of {_CP_IMPLS}")
        self.mesh = mesh
        self.compute_dtype = (torch_dtype(compute_dtype)
                              if compute_dtype is not None else None)
        self.config = kwargs
        self.seed = int(seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self._global_step = 0

        all_nodes = [n for lst in self.eval_node_dict.values() for n in lst]
        self.all_topo = find_topo_sort(all_nodes)
        self.variables = [n for n in self.all_topo
                          if isinstance(n, VariableOp)]
        by_name = {}
        for v in self.variables:
            if by_name.setdefault(v.name, v) is not v:
                raise ValueError(
                    f"two distinct variables named {v.name!r} reach this "
                    "executor; give the models distinct `name=`s or build "
                    "them under separate `name_scope()`s")
        # each variable draws from its own generator, so the draws run in
        # threads (torch releases the GIL) with the same values
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(8, os.cpu_count() or 1)) as pool:
            values = list(pool.map(self._init_value, self.variables))
        self.params = {v.name: t for v, t in zip(self.variables, values)}
        # {optimizer_op_name: state}, each optimizer initialised once;
        # _opt_ops keeps the ops in graph (construction) order
        self.opt_state = {}
        self._opt_ops = {}
        for n in self.all_topo:
            if hasattr(n, "init_state"):
                self.opt_state[n.name] = n.init_state(self.params,
                                                      self.device)
                self._opt_ops[n.name] = n
        self.subexecutor = {name: SubExecutor(name, nodes, self)
                            for name, nodes in self.eval_node_dict.items()}

    def _init_value(self, v):
        gen = torch.Generator().manual_seed(init_seed(self.seed, v.name))
        value = v.initializer(gen, v.shape, torch_dtype(v.dtype))
        return value.to(self.device)

    def _cast(self, x):
        if self.compute_dtype is not None and x.is_floating_point():
            return x.to(self.compute_dtype)
        return x

    def run(self, name_or_feed=None, feed_dict=None,
            convert_to_numpy_ret_vals=False):
        if isinstance(name_or_feed, str):
            name = name_or_feed
        else:
            name = next(iter(self.subexecutor))
            if feed_dict is None:
                feed_dict = name_or_feed
        return self.subexecutor[name].run(
            feed_dict=feed_dict,
            convert_to_numpy_ret_vals=convert_to_numpy_ret_vals)

    def run_steps(self, name, feed_dict, n, convert_to_numpy_ret_vals=False):
        """Run ``n`` steps of subgraph ``name`` on the same feeds and
        return the last step's values (see ``SubExecutor.run_steps``)."""
        return self.subexecutor[name].run_steps(
            feed_dict, n,
            convert_to_numpy_ret_vals=convert_to_numpy_ret_vals)

    def profile(self, name=None, feed_dict=None, repeats=10,
                trace_dir=None):
        """Wall-clock ``repeats`` steps of subgraph ``name`` (reference
        ``Executor.profile``): ``(avg_seconds_per_step, None)``, a pair as
        in the JAX package, whose second item holds per-op aggregates
        when ``trace_dir`` is given."""
        if trace_dir is not None:
            raise NotImplementedError(
                "profile(trace_dir=...) writes per-op aggregates through "
                "the timeline module, which arrives with slice G "
                "(telemetry) of the port (ROADMAP.md)")
        if name is None:
            name = next(iter(self.subexecutor))
        return self.subexecutor[name].profile(feed_dict,
                                              repeats=repeats), None

    def check_monitors(self):
        for sub in self.subexecutor.values():
            sub.check_monitors()

    def get_params(self):
        """A copy of the params: the executor updates its own tensors in
        place at every step."""
        return {k: v.clone() for k, v in self.params.items()}

    def cast_params(self, dtype):
        """Cast every floating param to ``dtype`` (e.g. bf16 for serving),
        one at a time, so that the card holds the old dtype's copy of one
        param at most.  The tensors are replaced: a captured step is
        captured anew at its next call."""
        dtype = torch_dtype(dtype)
        for name, t in self.params.items():
            if t.is_floating_point() and t.dtype != dtype:
                self.params[name] = t.to(dtype)
                del t

    def load_params(self, params, dtype=None):
        """Replace every param from a JAX executor's ``params`` converted
        to numpy (see ``weights.params_from_jax``); raises on a missing or
        extra name or a shape mismatch."""
        from ..weights import params_from_jax
        expect = {v.name: (v.shape, torch_dtype(v.dtype))
                  for v in self.variables}
        for name, value in params_from_jax(params, self.device, dtype=dtype,
                                           expect=expect).items():
            _assign(self.params, name, value)

    def state_dict(self):
        """The executor's state as numpy, with the JAX package's keys
        (``hetu_tpu/graph/executor.py`` ``state_dict``): ``params`` (the
        f32 masters under a ``compute_dtype``), ``opt_state`` (each
        optimizer op's ``step`` and ``slots``), ``opt_meta`` (each
        optimizer op's class and construction order, by which
        ``load_state_dict`` pairs the ops), the ``format`` tag and
        ``global_step``.  In place of JAX's PRNG key (``base_key``) it
        holds ``generator_state``, the bytes of the executor's
        ``torch.Generator`` (uint8), and ``generator_device``, the device
        type of that generator ("cpu" or "cuda")."""
        self.check_monitors()
        opt = {name: {"step": _to_numpy(st["step"]),
                      "slots": {var: {k: _to_numpy(t)
                                      for k, t in slots.items()}
                                for var, slots in st["slots"].items()}}
               for name, st in self.opt_state.items()}
        meta = {name: {"class": type(op.optimizer).__name__, "order": i}
                for i, (name, op) in enumerate(self._opt_ops.items())}
        return {"params": {k: _to_numpy(v) for k, v in self.params.items()},
                "opt_state": opt, "opt_meta": meta,
                "format": {"conv_layout": "HWIO", "version": 1},
                "global_step": self._global_step,
                "generator_state": self.generator.get_state().numpy().copy(),
                "generator_device": self.device.type}

    def save(self, path):
        """Write ``state_dict()`` to ``path`` atomically: a kill mid-save
        leaves the previous file intact."""
        atomic_pickle(self.state_dict(), path)

    def load(self, path):
        """Restore from a file written by ``save``; a torn or foreign file
        raises ``CheckpointError``."""
        self.load_state_dict(read_checkpoint(path))

    def load_state_dict(self, state):
        """Restore what ``state_dict`` saved, on this executor's device.

        A partial params restore warns; a param or slot of another shape
        raises ``ValueError``; a payload without the required keys, or
        whose optimizer states do not pair with this graph's optimizer ops
        by construction order and class (``opt_meta``) and variable sets,
        raises ``CheckpointError``.  Nothing changes unless every check
        passes.  A generator state saved on another device type cannot
        continue this executor's stream: it warns and keeps its own."""
        validate_state(state, source="state_dict payload")
        var_by_name = {v.name: v for v in self.variables}
        extra = sorted(set(state["params"]) - set(var_by_name))
        absent = sorted(set(var_by_name) - set(state["params"]))
        if extra or absent:
            warnings.warn(
                f"partial restore: {len(absent)} graph param(s) not in the "
                f"state (keep their init: {absent[:4]}...), {len(extra)} "
                f"state param(s) unused ({extra[:4]}...)", stacklevel=2)
        params = {}
        for name, value in state["params"].items():
            v = var_by_name.get(name)
            if v is not None:
                params[name] = self._restore(
                    f"state param {name!r}", value, v.shape,
                    torch_dtype(v.dtype))
        opt_state = {}
        for cur_name, sv in self._pair_opt_state(state).items():
            cur = self.opt_state[cur_name]
            if set(sv["slots"]) != set(cur["slots"]):
                raise CheckpointError(
                    f"checkpoint optimizer state for {cur_name!r} covers "
                    "other variables than this graph's")
            slots = {}
            for var, cur_slots in cur["slots"].items():
                if set(sv["slots"][var]) != set(cur_slots):
                    raise CheckpointError(
                        f"checkpoint slots of {var!r} are "
                        f"{sorted(sv['slots'][var])}, this graph's "
                        f"{sorted(cur_slots)}")
                slots[var] = {
                    k: self._restore(f"slot {k!r} of {var!r}",
                                     sv["slots"][var][k], t.shape, t.dtype)
                    for k, t in cur_slots.items()}
            opt_state[cur_name] = {
                "step": self._restore(f"step of {cur_name!r}", sv["step"],
                                      cur["step"].shape, cur["step"].dtype),
                "slots": slots}
        gen_state = torch.from_numpy(
            np.array(state["generator_state"], dtype=np.uint8))
        same_kind = state.get("generator_device",
                              self.device.type) == self.device.type
        if not same_kind:
            warnings.warn(
                f"the checkpoint's generator state is a "
                f"{state['generator_device']} generator's; this executor's "
                f"{self.device.type} generator keeps its own state",
                stacklevel=2)
        for name, value in params.items():
            _assign(self.params, name, value)
        for name, st in opt_state.items():
            cur = self.opt_state[name]
            _assign(cur, "step", st["step"])
            for var, slots in st["slots"].items():
                for k, value in slots.items():
                    _assign(cur["slots"][var], k, value)
        self._global_step = int(state["global_step"])
        if same_kind:
            self.generator.set_state(gen_state)

    def _restore(self, what, value, shape, dtype):
        value = torch.as_tensor(np.asarray(value))
        if tuple(value.shape) != tuple(shape):
            raise ValueError(f"{what} has shape {tuple(value.shape)} but "
                             f"the graph expects {tuple(shape)}")
        return value.to(self.device, dtype)

    def _pair_opt_state(self, state):
        """{this graph's optimizer op name: saved state}, paired by
        construction order and class (``opt_meta``), as the JAX package
        pairs them when the names differ; op names carry a process-wide
        counter, so a rebuilt graph names its ops anew."""
        saved, meta = state["opt_state"], state.get("opt_meta")
        if meta is None:
            if set(saved) != set(self._opt_ops):
                raise CheckpointError(
                    "checkpoint has no opt_meta and its optimizer states "
                    f"{sorted(saved)} are not this graph's "
                    f"{sorted(self._opt_ops)}")
            return dict(saved)
        if set(meta) != set(saved):
            raise CheckpointError(
                f"opt_meta names {sorted(meta)} but the checkpoint holds "
                f"optimizer states {sorted(saved)}")
        if len(saved) != len(self._opt_ops):
            raise CheckpointError(
                f"checkpoint holds {len(saved)} optimizer state(s), this "
                f"graph has {len(self._opt_ops)} optimizer op(s)")
        order = sorted(saved, key=lambda n: meta[n]["order"])
        paired = {}
        for (cur_name, op), sv_name in zip(self._opt_ops.items(), order):
            cls = type(op.optimizer).__name__
            if meta[sv_name]["class"] != cls:
                raise CheckpointError(
                    f"checkpoint optimizer {sv_name!r} is a "
                    f"{meta[sv_name]['class']} but this graph's "
                    f"{cur_name!r} is a {cls}")
            paired[cur_name] = saved[sv_name]
        return paired

    def close(self):
        """Release this executor's device memory (its params, optimizer
        state, feed buffers and captured graphs); the executor cannot run
        afterwards."""
        for sub in self.subexecutor.values():
            sub._drop()
            sub._sigs = {}
        self.params = {}
        self.opt_state = {}


def _assign(store, key, value):
    """``store[key] = value`` by a copy into the tensor already there when
    it has ``value``'s shape, dtype and device (a captured step keeps
    reading it), else by rebinding (the next step captures anew)."""
    cur = store.get(key)
    if (cur is not None and cur.shape == value.shape
            and cur.dtype == value.dtype and cur.device == value.device):
        with torch.no_grad():
            cur.copy_(value)
    else:
        store[key] = value
