"""Executor: named subgraphs evaluated eagerly on one device.

Counterpart of ``hetu_tpu/graph/executor.py`` on one device.  The JAX
executor jit-compiles each named subgraph into one XLA program; here
``run`` walks the subgraph's topo order eagerly on an explicit device.  A
subgraph trains, as in JAX, iff it holds an optimizer or gradient op and
its name is not ``validate``/``inference``/``eval`` (an explicit
``training=`` overrides): training turns dropout on.  Subgraphs that
train or hold gradient ops run with autograd recording; the others run
under ``torch.inference_mode()``, and what they record into ``params`` is
cloned out of inference mode so that a later training step can use it.
Mixed precision follows the JAX policy: with ``compute_dtype``, floating
params and feeds are cast for the step while ``params`` keep their own
dtype (the optimizers update these f32 masters), and integers are never
cast.  Updates that ops record (optimizer steps, the
BERT MLM overflow counter) are written back into ``params`` in each
param's dtype, and each optimizer's state is kept in ``opt_state``.

Guards, numerics, save/resume with RNG state, data parallelism and the
parameter server are later slices (ROADMAP.md).  Those arguments raise
``NotImplementedError`` here rather than being ignored.
"""

from __future__ import annotations

import warnings
import zlib

import numpy as np
import torch

from .node import Op, PlaceholderOp, VariableOp, find_topo_sort
from .trace import TraceContext, evaluate

_EVAL_NAMES = ("validate", "inference", "eval")

# Executor keyword arguments of the JAX package that belong to later slices
_LATER = {
    "mesh": "slice F (parallelism beyond DP)",
    "dist_strategy": "slice A3 (data parallelism) / slice F",
    "comm_mode": "slice A3 (data parallelism) / slice B (parameter server)",
    "pipeline": "slice F (pipeline parallelism)",
    "step_guard": "slice G (resilience)",
    "numerics": "slice G (telemetry)",
    "cp_impl": "slice F (context parallelism)",
}


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
    t = t.detach().cpu()
    # numpy has no bfloat16: return such outputs as float32
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


class SubExecutor:
    """One named subgraph, evaluated eagerly in topo order."""

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
                    f"{p.name}: parameter-server rows arrive with slice B of "
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

    def _feeds(self, feed_dict):
        ex = self.executor
        fed = {}
        for node, value in (feed_dict or {}).items():
            fed[node.name if isinstance(node, Op) else node] = value
        missing = [p.name for p in self.placeholders if p.name not in fed]
        if missing:
            raise ValueError(f"missing feeds for placeholders: {missing}")
        feeds = {}
        for p in self.placeholders:
            v = fed[p.name]
            want = torch_dtype(p.dtype)
            if isinstance(v, torch.Tensor):
                feeds[p] = v.to(device=ex.device, dtype=want)
            else:
                feeds[p] = torch.as_tensor(np.asarray(v)).to(
                    device=ex.device, dtype=want)
        return feeds

    def run(self, feed_dict=None, convert_to_numpy_ret_vals=False):
        ex = self.executor
        cast = ex._cast
        bindings = {v: cast(ex.params[v.name]) for v in self.variables}
        for p, v in self._feeds(feed_dict).items():
            bindings[p] = cast(v)
        ctx = TraceContext(
            generator=ex.generator, training=self.training,
            master_params=ex.params if ex.compute_dtype is not None
            else None)
        ctx.opt_state = ex.opt_state
        with (torch.enable_grad() if self.has_grads or self.training
              else torch.inference_mode()):
            vals = evaluate(self.eval_nodes, bindings, ctx, topo=self.topo)
        for var, val in ctx.updates.items():
            if val.is_inference():
                val = val.clone()
            ex.params[var.name] = val.detach().to(ex.params[var.name].dtype)
        ex.opt_state.update(ctx.new_opt_state)
        vals = [v.detach() if isinstance(v, torch.Tensor) else v
                for v in vals]
        ex._global_step += 1
        self._runs += 1
        if self._monitor_vars and (
                self._runs == 1 or self._runs % self._monitor_interval == 0):
            self.check_monitors()
        if convert_to_numpy_ret_vals:
            vals = [None if v is None else _to_numpy(v) for v in vals]
        return vals

    def check_monitors(self):
        """Warn on any tripped monitor counter (MLM overflow etc.)."""
        for v in self._monitor_vars:
            msg = v.monitor(float(self.executor.params[v.name]))
            if msg:
                warnings.warn(msg)


class Executor:
    """Runs named subgraphs of one graph on one device.

    ``eval_node_dict`` may be a list (single anonymous subgraph) or a dict
    {name: eval_node_list}.  ``device=None`` means ``"cuda"`` and raises
    when no card is present; pass ``device="cpu"`` to run on the CPU.
    ``seed`` drives variable init and the executor's ``torch.Generator``,
    from which dropout draws.  ``rng_impl`` is accepted for the JAX
    package's signature (it picks a JAX PRNG there) and selects nothing:
    the port has one generator kind.  ``donate_params`` is accepted and
    selects nothing either: each step's updates are new tensors that
    replace the old in ``params``, which frees them.
    """

    def __init__(self, eval_node_dict, ctx=None, seed=0, mesh=None,
                 dist_strategy=None, comm_mode=None, compute_dtype=None,
                 device=None, **kwargs):
        later = dict(kwargs, mesh=mesh, dist_strategy=dist_strategy,
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
        self.params = {}
        for v in self.variables:
            gen = torch.Generator().manual_seed(init_seed(self.seed, v.name))
            value = v.initializer(gen, v.shape, torch_dtype(v.dtype))
            self.params[v.name] = value.to(self.device)
        # {optimizer_op_name: state}, each optimizer initialised once
        self.opt_state = {}
        for n in self.all_topo:
            if hasattr(n, "init_state"):
                self.opt_state[n.name] = n.init_state(self.params,
                                                      self.device)
        self.subexecutor = {name: SubExecutor(name, nodes, self)
                            for name, nodes in self.eval_node_dict.items()}

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

    def check_monitors(self):
        for sub in self.subexecutor.values():
            sub.check_monitors()

    def get_params(self):
        return dict(self.params)

    def load_params(self, params, dtype=None):
        """Replace every param from a JAX executor's ``params`` converted
        to numpy (see ``weights.params_from_jax``); raises on a missing or
        extra name or a shape mismatch."""
        from ..weights import params_from_jax
        expect = {v.name: (v.shape, torch_dtype(v.dtype))
                  for v in self.variables}
        self.params = params_from_jax(params, self.device, dtype=dtype,
                                      expect=expect)

    def state_dict(self):
        self.check_monitors()
        return {"params": {k: _to_numpy(v) for k, v in self.params.items()},
                "global_step": self._global_step}

    def load_state_dict(self, state):
        """Restore params (and the step count) saved by ``state_dict``.
        A partial restore warns; a shape mismatch raises."""
        var_by_name = {v.name: v for v in self.variables}
        extra = sorted(set(state["params"]) - set(var_by_name))
        absent = sorted(set(var_by_name) - set(state["params"]))
        if extra or absent:
            warnings.warn(
                f"partial restore: {len(absent)} graph param(s) not in the "
                f"state (keep their init: {absent[:4]}...), {len(extra)} "
                f"state param(s) unused ({extra[:4]}...)", stacklevel=2)
        for name, value in state["params"].items():
            v = var_by_name.get(name)
            if v is None:
                continue
            value = torch.as_tensor(np.asarray(value))
            if tuple(value.shape) != tuple(v.shape):
                raise ValueError(
                    f"state param {name!r} has shape {tuple(value.shape)} "
                    f"but the graph expects {tuple(v.shape)}")
            self.params[name] = value.to(self.device, torch_dtype(v.dtype))
        self._global_step = int(state.get("global_step", self._global_step))

    def close(self):
        """Release this executor's device memory (its params and optimizer
        state); the executor cannot run afterwards."""
        self.params = {}
        self.opt_state = {}
