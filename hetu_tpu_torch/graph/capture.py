"""Programs captured in CUDA graphs: the port's one capture-and-replay
mechanism.

``Captured`` runs a body over static device buffers: eagerly on the CPU
and under ``disable_capture()``; on the card eagerly on a side stream at
its first call (it builds the hand-written kernels and settles the
allocator), captured in a CUDA graph at its second into a memory pool
(the owner's generator registered, so that each replay draws fresh bits
and advances it as an eager call does), and replayed after.  Inside the
graph each hand-written kernel stays one launch: the launches its wrappers
count at the capture are taken back and added again at every replay, as
if each replay had called them.  The caller fills the body's input buffers
before each call and reads its outputs before the next.  When the tensors
the body is bound to change (``state``), the graph is dropped and captured
anew.  A capture that fails raises ``CaptureError`` naming the program;
nothing falls back to eager by itself.  The executor's steps (one program
per subgraph signature, ``graph/executor.py``), the serving engine's
prefill and decode step and the one-shot greedy decoder's step run so.
"""

from __future__ import annotations

import contextlib
import operator

import torch

from ..ops import kernels

_CAPTURE = [True]


@contextlib.contextmanager
def disable_capture():
    """Run the programs started inside eagerly, op by op, on the card too:
    the counterpart of ``jax.disable_jit()``, for comparing a captured
    step with its eager run and for stepping through one.  Captured
    graphs are kept for later calls."""
    prev = _CAPTURE[0]
    _CAPTURE[0] = False
    try:
        yield
    finally:
        _CAPTURE[0] = prev


class CaptureError(RuntimeError):
    """A program could not be captured in a CUDA graph."""


def end_pool_routing(device, pool):
    """After a failed capture: a ``capture_end`` that raises leaves the
    allocator routing the side stream's allocations into ``pool`` (as
    PyTorch 2.11 does); end that."""
    try:
        torch._C._cuda_endAllocateToPool(
            torch.cuda.current_device() if device.index is None
            else device.index, pool)
    except RuntimeError:
        pass  # capture_end had ended it


def root_error(e):
    """The body's own error under a failed capture's end."""
    while e.__context__ is not None:
        e = e.__context__
    return e


class GraphPool:
    """A CUDA graph memory pool that programs share: a capture may reuse
    what another's freed, since no two of them replay at once and each
    caller reads a replay's outputs before the next."""

    def __init__(self):
        self.handle = None

    def get(self):
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        return self.handle

    def abandon(self, device):
        """After a failed capture: end the allocator's routing into the
        pool, and capture later graphs into a new pool."""
        end_pool_routing(device, self.handle)
        self.handle = None


class Captured:
    """``body()`` as one program.

    ``owner.generator`` (if any) is the generator the body draws from; a
    failed capture replaces it by a fresh one in its state before the
    capture.  ``state()`` lists the tensors the body reads or writes in
    place, besides its buffers; when one is replaced, ``on_stale()`` runs
    (by default ``drop()``).  ``pool`` is a ``GraphPool`` shared with
    other programs (by default one of its own).  ``where()`` names the
    place a failed capture stopped at, for its message.  With
    ``clone_outputs`` a replay returns clones of the graph's outputs, so
    that a value returned once is never changed by a later replay.
    ``builds`` counts how often the program was set up for its shapes:
    each capture on the card, the first run elsewhere."""

    def __init__(self, name, body, device, owner=None, state=None,
                 pool=None, where=None, on_stale=None, clone_outputs=False):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.owner = owner
        self.state = state or (lambda: [])
        self.pool = pool if pool is not None else GraphPool()
        self.where = where
        self.on_stale = on_stale or self.drop
        self.clone_outputs = clone_outputs
        self.builds = 0
        self.graph = self.outputs = self.bound = self.launches = None
        self._graph_bytes = 0
        self._warm = False
        self._stream = None

    def __call__(self):
        if self.device.type != "cuda":
            if not self._warm:
                self._warm = True
                self.builds += 1
            return self.body()
        if not _CAPTURE[0]:
            return self.body()
        if self.graph is not None and not self._same_state():
            self.on_stale()
        if self.graph is None:
            if not self._warm:
                self._warm = True
                return self._eager_on_side()
            self._capture()
        kernels.add_launches(self.launches)
        self.graph.replay()
        if self.clone_outputs:
            return _map_tensors(self.outputs, torch.Tensor.clone)
        return self.outputs

    @property
    def graph_bytes(self):
        """The device bytes the capture reserved (its share of the memory
        pool), 0 while no graph is held."""
        return self._graph_bytes if self.graph is not None else 0

    def drop(self):
        """Forget the graph; the next call captures anew."""
        self.graph = self.outputs = self.bound = self.launches = None

    def _same_state(self):
        state = self._bound_state()
        return (len(state) == len(self.bound)
                and all(map(operator.is_, state, self.bound)))

    def _bound_state(self):
        gen = getattr(self.owner, "generator", None)
        return [gen] + list(self.state())

    def _side_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _eager_on_side(self):
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            outs = self.body()
        cur.wait_stream(side)
        for t in _tensors(outs):
            t.record_stream(cur)
        return outs

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        gen = getattr(self.owner, "generator", None)
        if gen is not None:
            graph.register_generator_state(gen)
            gen_state = gen.get_state()
        pool = self.pool.get()
        counts = kernels.launch_counts()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        try:
            # torch.cuda.graph's steps, with the stream restored also when
            # the capture fails (its __exit__ skips that when capture_end
            # raises)
            with torch.cuda.stream(self._side_stream()):
                graph.capture_begin(pool=pool)
                try:
                    outputs = self.body()
                finally:
                    graph.capture_end()
        except Exception as e:
            where = f" {self.where()}" if self.where is not None else ""
            self.pool.abandon(self.device)
            if gen is not None:
                # the generator stays in capture mode: replace it by a
                # fresh one in the same state (the capture advanced nothing)
                fresh = torch.Generator(device=self.device)
                fresh.set_state(gen_state)
                self.owner.generator = fresh
            root = root_error(e)
            raise CaptureError(
                f"{self.name}: capturing it in a CUDA graph failed{where} "
                f"({type(root).__name__}: "
                f"{str(root).splitlines()[0] if str(root) else ''}).  It "
                "must not read a tensor on the host (.item(), float(t), "
                "nonzero, a boolean mask, a shape from data); run it under "
                "hetu_tpu_torch.disable_capture() to run it eagerly") from e
        finally:
            after = kernels.launch_counts()
            kernels.restore_launches(counts)
        self.launches = {k: n - counts.get(k, 0) for k, n in after.items()
                         if n != counts.get(k, 0)}
        self.builds += 1
        self.graph, self.outputs = graph, outputs
        self.bound = self._bound_state()
        self._graph_bytes = (torch.cuda.memory_reserved(self.device)
                             - reserved)


def _tensors(outs):
    if isinstance(outs, torch.Tensor):
        return [outs]
    if isinstance(outs, (list, tuple)):
        return [t for t in outs if isinstance(t, torch.Tensor)]
    return []


def _map_tensors(outs, fn):
    if isinstance(outs, torch.Tensor):
        return fn(outs)
    return [fn(t) if isinstance(t, torch.Tensor) else t for t in outs]
