"""Continuous-batching LLM serving (port of ``hetu_tpu/serving/``, slice
D1): the dense slot pool (kv_cache.py), the iteration-level FIFO
scheduler with bounded-queue admission control (scheduler.py), the
slot-batched Llama adapter (adapters.py) and the engine tying them
together with per-request deadlines, cancellation and a decode watchdog
(engine.py), its prefill and decode step each captured in a CUDA graph
on the card.

The paged pool, speculative decoding, the prefix cache, tensor-parallel
serving, KV transfer, the fleet with its health and control planes, and
the embedding server arrive with slice D2 (ROADMAP.md).
"""

from .kv_cache import SlotKVCache
from .scheduler import (EngineOverloaded, Request, Scheduler,
                        FINISH_REASONS, SHED_POLICIES, TERMINAL_OK)
from .adapters import LlamaSlotAdapter, GPTSlotAdapter, adapter_for
from .engine import InferenceEngine

__all__ = ["SlotKVCache", "Request", "Scheduler", "EngineOverloaded",
           "FINISH_REASONS", "SHED_POLICIES", "TERMINAL_OK",
           "LlamaSlotAdapter", "GPTSlotAdapter", "adapter_for",
           "InferenceEngine"]
