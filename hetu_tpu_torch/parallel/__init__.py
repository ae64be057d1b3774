"""Parallelism (port of ``hetu_tpu/parallel``): the device mesh and
context parallelism (slice F1).  Strategies, tensor, pipeline and expert
parallelism arrive with the rest of slice F (ROADMAP.md)."""

from .mesh import Mesh, make_mesh
from .context_parallel import (ring_attention, ulysses_attention,
                               ring_attention_shard, ulysses_attention_shard)
