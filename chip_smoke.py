#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hetu_tpu_torch) end to end on one card.

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each fatal on failure (exit 1, no result lines):

1. Card and build: the card's name and power limit, and the build of every
   kernel of the paths from the sources in this checkout: one nvcc per CUDA
   source (flash-attention forward with dropout and its blockwise offset
   path; dQ and dK/dV backward, also blockwise; the packed-gradient write;
   the MoE row gather), all started together, then Triton's compiler for
   the softmax-CE forward and backward.  The ptxas report names each
   kernel's registers and spill stores (the wgmma kernels, and any that
   spills); the d = 80 wgmma forward, dQ and dK/dV must spill nothing.
2. Kernels against their plain PyTorch versions on the card, on the same
   inputs: the dropout keep bits bitwise, of the helper and inside the
   wgmma forward, dQ and dK/dV kernels (d = 64, 128 and GPT-3 2.7B's 80);
   two launches of each wgmma and mma.sync kernel give the same bits (at
   BERT's, Llama's, ragged, the d = 128 block and GPT's shapes, d = 80
   ragged, causal and under the key mask, the empty, diagonal and full
   blocks' dK/dV, the full one also against its plain version, and the
   d = 80 blockwise forward, dQ and dK/dV at every step of a 4-rank ring
   of [1,32,2048,80] blocks, also against their plain versions, q rows
   with no live key dq = 0 and unseen K/V rows dk = dv = 0 bitwise); the
   flash forward (with and without dropout), dQ, dK/dV
   and the CE forward and backward at the main paths' shapes (the wgmma
   route for bf16 heads of 64, 80 and 128)
   and at ragged, causal, fully-masked, d = 80 (ragged causal, key mask),
   d = 96 (the mma.sync route), wide-head and f32 ones;
   at GPT's causal shapes, GPT-small's [8,12,1024,64] at keep 0.9 and
   GPT-3 2.7B's [2,32,2048,80] at keep 0.9 and 1 (all on wgmma), each on
   its route, dQ, dK and dV within the spread of their bf16 terms; the
   CE at GPT's V = 50257, [8192,50257] and
   [4096,50257] bf16, with out-of-range labels (loss = lse there);
   ``pack_write`` at the W&D shapes (uniform, Zipf-skewed at M = 3328 and
   65,536, negative, out-of-range and tail-line ids, Criteo's table, no
   ids), bitwise against ``pack_write_ordered`` (its summation tree) on
   the card and on the CPU and against itself across two runs and on
   reused scratch, and within the reordering bound of the card's
   ``index_add_`` (bitwise on lines with one contributor); the packed lookup's
   forward on the card against the CPU, with a NaN and an Inf row and
   negative ids; ``row_gather`` bitwise at the MoE dispatch and combine
   shapes of bench_moe and of the Mixtral layer, f32 and bf16, with
   out-of-range indices, and one backward through ``RowGatherFn``; the
   blockwise (ring) forward, dQ and dK/dV at the full, diagonal, empty,
   partial and misaligned offsets, with a K/V block twice q's length, and
   every step of a 4-rank ring at the cp path's shape and of ones with
   64-row groups (the mma.sync route at d = 64 and 80; at d = 80 the
   smoke's only launch of flash_bwd_dq_mma<80>), f32 and bf16, d 64, 80
   and 128 (empty rows lse = -1e30 and o = 0, unseen K/V rows dk = dv =
   0, bitwise); and ``ring_attention`` over a 4-position mesh against the
   single-device flash kernel on the global sequence, output and three
   gradients.  Each check prints its max |error| beside its stated
   tolerance.
3. Main paths, each driven with the launch counters set to 0 just before
   its timed steps and read just after: the ten kernels' and the flash
   kernels' by route (``flash_attention.route_launches``), so that each
   path shows its forward, dQ and dK/dV launches on the wgmma kernels.
   Every step runs as the executor runs it on the card: the first call of
   a subgraph eagerly, the second captured in a CUDA graph, the rest as
   replays, so each path warms up with at least 2 steps and its timed
   steps are replays, whose launches the executor counts from the
   capture (once a replay).  First, a step that reads a tensor on the
   host must raise ``CaptureError`` naming the op when captured, and run
   under ``disable_capture()``.
   a. BERT-base (vocab 30522, hidden 768, 12 layers, 12 heads, FFN 3072,
      seq 512, MLM bucket 0.25 -> 8192 rows) evaluated through
      ``Executor({"validate": [loss]}, compute_dtype=bfloat16)`` at batch
      64 with random weights from ``--seed``: 12 flash forward launches and
      1 CE forward launch per step, no backward launch.
   b. The BERT-base training step at the same shapes with hidden and
      attention dropout 0.1: ``AdamWOptimizer(1e-4, weight_decay=0.01)
      .minimize(loss)`` and ``Executor({"train": [loss, train_op]},
      compute_dtype=bfloat16)`` over f32 master params, 3 warm-up and
      ``--steps`` timed steps: per step 12 flash forward, 12 dQ, 12 dK/dV,
      1 CE forward and 1 CE backward launches, every loss finite.
   c. Wide&Deep on the packed embedding table (26 sparse fields of dim 16,
      13 dense, deep (256, 256, 256)) trained through ``Executor({"train":
      [loss, AdamOptimizer(0.01).minimize(loss)], "predict": [logit]})``
      at batch 128, f32, at bench_wdl's 337,000 rows and at Criteo's
      33,762,577 (a 2.16 GB table updated whole by dense Adam each step):
      3 warm-up and ``--steps`` timed steps, 1 ``pack_write`` launch per
      step, every loss finite, then a ``predict`` run that changes no
      param.  Then one step each of DeepFM, DCN and DLRM on the packed
      table at 337,000 rows: a finite loss and 1 ``pack_write`` launch.
      Then a checkpoint round trip: two W&D steps, ``Executor.save`` to a
      temporary file, a fresh executor over a rebuilt graph ``load``s it;
      Adam's step and moments and the CUDA generator state must come back
      equal, and the next step's loss must agree with the saved
      executor's.
   d. bench_moe's training step (BASELINE config 5): ``MoELayer(512, 2048,
      num_experts=8, k=2, capacity_factor=1.25)``, gelu experts, loss
      ``mse_loss_op(moe(x), y) + 0.01 * moe.aux_loss()`` under
      ``Executor({"train": [loss, AdamOptimizer(1e-3).minimize(loss)]})``
      at B=8 S=1024, f32: 3 warm-up and ``--steps`` timed steps, 3
      ``row_gather`` launches per step (the dispatch and two combines; the
      backward is a scatter-add), every loss finite, tokens/s; then the
      same 3 steps twice from the same params, bitwise equal.  Then the
      Mixtral-8x7B MoE layer (hidden 4096, FFN 14336, 8 swiglu experts,
      top-2, capacity 4.0) at B=1 S=2048, f32, Adam: 2 warm-up and 3
      timed steps, 3 ``row_gather`` launches per step.
   e. bench_llama's Llama (vocab 32000, hidden 768, 12 layers, 12 heads,
      4 KV heads, FFN 2048) at B=8 S=1024, bf16 over f32 masters,
      ``AdamWOptimizer(1e-4, weight_decay=0.01)``, labels the ids rolled
      by one, through ``Executor({"train": [loss, train_op]},
      mesh=make_mesh({"cp": 4}, devices=[cuda:0] * 4),
      compute_dtype=bfloat16)``: 3 warm-up and ``--steps`` timed steps,
      per step 48 blockwise forward, 48 dQ and 48 dK/dV launches (12
      layers x 4 ring steps) and 1 CE forward and backward; then the same
      steps without a mesh from the same params (12 flash forward, dQ and
      dK/dV launches a step), ms/step, tokens/s and peak memory of both.
      Then 2 of Mistral-7B's 32 layers at its published widths (hidden
      4096, 32 heads, 8 KV heads, FFN 14336) at B=1 S=8192 under cp=4: 2
      warm-up and 3 timed steps.
   f. Each path (BERT eval and train, W&D at both sizes, bench_moe and
      the Mixtral layer, Llama cp=4 and mesh-less, the witness, g's
      ResNet-18 and i's two GPTs), on its executor: 5 steps under ``disable_capture()`` and 5 captured
      steps from the same state (3 each for the Mixtral layer and the
      witness) must give bitwise equal losses and checkpoints (params,
      optimizer steps and slots, generator state, step count);
      ``run_steps(..., 20)`` must equal 20 ``run()`` calls bitwise (the
      last loss and the checkpoint; 5 for the Mixtral layer, the
      witness and GPT-3 2.7B's widths); eager and captured ms/step in
      alternating turns (eager, captured, captured, eager, twice), peak
      memory (captured: allocated plus the graph pool), and traced
      windows of each in turns: busy time, idle share, launches.  A ``{"capture":
      [...]}`` line before the kernels' line sums them up.
   g. bench_resnet's ResNet-18 (BASELINE config 1): ``resnet18(10)``, the
      mean sparse CE, ``MomentumOptimizer(0.1, 0.9).minimize(loss)`` and
      ``Executor({"train": [loss, train_op], "validate": [logits]})`` at
      B=2048, 3x32x32 f32 (x normal, y uniform in [0, 10)): 3 warm-up and
      ``--steps`` timed steps, no hand-written kernel launched (the CE at
      10 classes is below its kernel's gate, as in JAX), every loss
      finite, every running stat moved, then a ``validate`` run with
      finite logits that changes no param; its breakdown (convolution
      forward, dgrad and wgrad, reductions, elementwise) and phase f.
      Then ``channels_last=True`` against NCHW from the same weights (one
      step compared, then ms/step of both captured, in turns), and the
      step's convolutions timed under the port's deterministic cuDNN
      choice and under cuDNN's default, in turns, beside their FLOPs and
      f32 bound.
   h. The continuous-batching serving engine (slice D1, bench.py --serve's
      slot engine) at Mistral-7B's published widths with all 32 layers
      (hidden 4096, 32/8 heads, FFN 14336, vocab 32000; 7.24 B params),
      the executor's params cast to bf16 (``Executor.cast_params``):
      ``InferenceEngine(n_slots=16, max_len=1024, max_prompt_len=512,
      prefill_budget=2)``, greedy, on bench.py's ``_serve_trace`` (seed 0,
      64 requests, Poisson gaps of 0.6 iterations, prompts of 64-512
      uniform ids, max_new 32-256), its prefill and decode step each
      captured in a CUDA graph: output tokens/s, TTFT, TPOT and queue-wait
      p50/p99, mean occupancy, peak memory beside params + KV pool, each
      graph's pool (smaller than the KV pool: written in place), no
      hand-written kernel launched (counted and traced), ``trace_counts``
      1 each after warm-up; the trace's first 16 requests eagerly
      (``disable_capture()``) and the whole trace through the gang twin
      (``gang=True``), both with bitwise equal streams; prefill at P = 512
      and decode ms/step with every slot active, eager against captured in
      turns, beside their bounds, and traced prefill and decode windows
      (busy time, idle share, no hand-written kernel traced or counted;
      the card's activity only); ``greedy_generate`` against an engine
      serving the trace's first request alone, bitwise.  The programs'
      replays add the launches their captures counted, as the executor's
      do, so the counters see what a captured prefill or step launches.
   i. GPT causal-LM training (slice C1): ``GPTLMHeadModel(...).loss(ids,
      labels)`` (tied head, masked-mean CE), ``AdamWOptimizer(1e-4,
      weight_decay=0.01)``, ``Executor({"train": [loss, train_op]},
      compute_dtype=bfloat16)`` over f32 masters, dropout 0.1 (hidden, and
      attention in the flash kernels), Zipf ids rolled by one as labels.
      i1: bench_gpt_e2e's GPT-small (hidden 768, 12 layers, 12 heads, V =
      50257) at B=8 S=1024, nothing cut: 3 warm-up and ``--steps`` timed
      steps, per step 12 forward, 12 dQ and 12 dK/dV launches on the
      wgmma kernels and 1 CE forward and backward; samples/s, tokens/s,
      ms/step, peak memory; phase f.  i2: GPT-3 2.7B's published widths
      (hidden 2560, 32 heads of d = 80, FFN 10240, V = 50257) at
      bench_gpt_layer's B=2 S=2048, 8 of its 32 layers: 2 warm-up and 3
      timed steps, per step 8 forward, 8 dQ and 8 dK/dV launches on the
      wgmma kernels and none on mma.sync, 1/1 CE; phase f at
      the witness's counts (3 steps, ``run_steps(5)``).
   Each path's step is broken down by kernel class under torch.profiler.
   Then each kernel is timed at the paths' shapes beside its bound, its
   plain version and one PyTorch library call (a yardstick only; the port
   never calls it; the self-attention and CE kernels and yardsticks each
   20 calls captured in one CUDA graph, the least of 3 replays, so that
   no reading holds the host's cost of a call): the CE forward also
   under each launch of its sweep (rows a program, chunk width, warps,
   stages); ``pack_write`` also under
   Zipf ids at M = 3328 and 65,536 against ``index_add_`` in turns;
   ``row_gather``'s step also against ``index_select`` in alternating
   turns, and beside a read-only pass over the bytes each gather reads
   and a write-only pass over the bytes it writes, timed the same way.
   Then one f32 training step of BERT (batch 2, 2 layers, full widths,
   dropout off), one of W&D (337,000 rows), one of a small
   MoE layer (H=128, F=256, 4 experts, 64 tokens), one of a small
   Llama under cp=4 (2 layers, hidden 256, 4 heads, 2 KV heads, S=1024),
   one of ResNet-18 at B=8 and one of a small GPT (2 layers, hidden 256,
   4 heads, V=1024, S=256, dropout off) run from the same params on the card
   (kernels, cuDNN) and on the CPU (plain versions): loss, every gradient
   and every updated param (ResNet's running stats too) are compared; and
   a small f32 Llama (2 layers, hidden 256, 8/2 heads, vocab 1024) served
   on both: the slot adapter's prefill and decode logits, and the
   engines' streams on a seeded trace.
   The blockwise kernels are timed at the witness's block shape, q
   [1,32,2048,128] bf16, for the full, diagonal and empty blocks, beside
   scaled_dot_product_attention (the yardstick) and its backward; the
   wgmma forward, dQ and dK/dV at the mesh-less Llama's causal
   [8,12,1024,64], and at keep 0.9 (GPT-small's); at GPT-3 2.7B's causal
   [2,32,2048,80] the wgmma forward, dQ and dK/dV, at keep
   1 and 0.9, beside the causal scaled_dot_product_attention and its
   backward; BERT's dQ and
   dK/dV at keep 1 beside keep 0.9; the CE forward and backward at
   GPT-small's [8192,50257] beside cross_entropy.
4. Result: the run's seconds, a {"gpt_flash": [...]} line (path i's
   flash kernels at GPT's shapes, each on its route: launches of the path
   that runs each, ms, plain ms, bound and sdpa's time), the {"capture": [...]}
   line, a {"kernels": [...]} JSON line (the ten kernels of the TPU
   kernels' entry points and the three wgmma kernels, launches from the
   captured steps of the paths, path i's among them, on both flash
   routes), the nvidia-smi line, and last {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import math
import re
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over HBM bandwidth and its products over the
# tensor-core (or f32 vector) rate of their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
CUDA_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                "pack_write.cu", "row_gather.cu")
WDL_ROWS = 337000         # bench_wdl's table (bench.py:567)
CRITEO_ROWS = 33762577    # Criteo's features (hetu_tpu/datasets/criteo.py)
CTR_BATCH = 128
# bench_moe (bench.py:463-497, BASELINE config 5, examples/moe): top-2 of 8
# gelu experts, capacity factor 1.25, B=8 S=1024 H=512 F=2048, f32
MOE = dict(B=8, S=1024, H=512, F=2048, E=8, k=2, cf=1.25, act="gelu")
# the MoE layer of the Mixtral-8x7B config (hetu_tpu/models/llama.py:85-88,
# 129-134): hidden 4096, FFN 14336, 8 swiglu experts, top-2, capacity 4.0
MIXTRAL = dict(B=1, S=2048, H=4096, F=14336, E=8, k=2, cf=4.0, act="swiglu")
# bench_resnet (bench.py:407-461, BASELINE config 1): ResNet-18 on CIFAR-10
# shapes, f32, Momentum(0.1, 0.9)
RESNET = dict(B=2048, C=3, HW=32, classes=10, lr=0.1, momentum=0.9)
# ResNet-18's convolutions on 32x32 inputs: (C_in, C_out, kernel, stride,
# input H = W, count); the stem's input needs no gradient
RESNET_CONVS = ((3, 64, 3, 1, 32, 1), (64, 64, 3, 1, 32, 4),
                (64, 128, 3, 2, 32, 1), (128, 128, 3, 1, 16, 3),
                (64, 128, 1, 2, 32, 1), (128, 256, 3, 2, 16, 1),
                (256, 256, 3, 1, 8, 3), (128, 256, 1, 2, 16, 1),
                (256, 512, 3, 2, 8, 1), (512, 512, 3, 1, 4, 3),
                (256, 512, 1, 2, 8, 1))

failures = []
T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def check(name, got, want, atol, why, rtol=0.0):
    """Pass iff |got - want| <= atol + rtol * |want| everywhere."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    excess = (diff - rtol * want.float().abs()).max().item()
    ok = excess <= atol  # False for NaN
    tol = f"{atol:g}" + (f" + {rtol:g}*|plain|" if rtol else "")
    log(f"check {name}: max_abs_err={err:.3e} tol={tol} ({why}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return err


def check_spread(name, got, want, atol, rtol, spread, why):
    """Pass iff |got - want| <= atol + rtol * |want| + 2^-8 * spread
    everywhere: ``spread`` is, per entry, the sum of the sizes of the bf16
    terms that make it, each of which the two sides may round one ulp
    apart (2^-8 of the term)."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - rtol * want.float().abs() - atol
              - 2.0 ** -8 * spread).max().item()
    ok = excess <= 0  # False for NaN
    log(f"check {name}: max_abs_err={diff.max().item():.3e} tol={atol:g} + "
        f"{rtol:g}*|want| + 2^-8*spread (max spread "
        f"{spread.max().item():.3e}; {why}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(name)
    return diff.max().item()


def free_memory(tag):
    """Collect garbage (executors sit in reference cycles), return the
    allocator's free cached blocks to the card, and log what stays and
    the seconds since the script started."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"memory {tag}: allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
        f" GiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f} GiB, at "
        f"{time.perf_counter() - T0:.0f} s")


def require(name, ok):
    log(f"check {name}: {'ok' if ok else 'FAIL'}")
    if not ok:
        # on the error stream too, where a caller that keeps only its end
        # still reads which check failed
        print(f"check {name}: FAIL", file=sys.stderr, flush=True)
        failures.append(name)


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` in ms over ``iters`` back-to-back calls
    (CUDA events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, windows=3, prep=None):
    """Device time of ``fn`` in ms per call, without its host cost:
    ``iters`` calls captured once in one CUDA graph, the graph replayed
    ``windows`` times under CUDA events, the least reading.  For calls
    whose launches cost the host longer than their kernels take the card
    (an autograd backward read 0.45 ms by back-to-back events at two
    shapes 2.7x apart in work), and for the kernels held against them.
    ``prep``: run once on the capture's stream before it, its result
    passed to ``fn`` (an autograd forward, so that its backward, which
    runs on its forward's stream, is captured)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        state = prep() if prep else None
        call = (lambda: fn(state)) if prep else fn  # noqa: E731
        for _ in range(2):
            call()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                call()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()  # a warm-up replay
    readings = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        readings.append(start.elapsed_time(end) / iters)
    del graph, state
    torch.cuda.empty_cache()
    return min(readings)


def device_ms(fn, iters=100, cold=False):
    """Device time of ``fn`` in ms per call: the time of the kernels it
    launches, summed under torch.profiler over ``iters`` calls.  For calls
    whose launch costs the host longer than their kernels take the card,
    where back-to-back CUDA events time the host.  ``cold``: each call
    finds the 50 MB L2 cache holding none of its inputs (a 256 MB pass
    over another buffer runs before it and is left out of the sum).  A
    window in which the profiler recorded no kernel of ``fn`` (it
    sometimes drops a short window's device records) is profiled again,
    up to 3 times, and logged; 0 if none recorded any."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") \
        if cold else None
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if cold:
                    flush.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not (cold and "bitwise_not" in e.key)) / iters / 1e3
        if ms > 0:
            return ms
        log(f"device_ms: the profiler recorded no device time of the call "
            f"(window {attempt + 1} of 3)")
    return 0.0


def bound(n_bytes, ops, dtype):
    """(ms, "bytes" or "operations"): the least time of the work on an
    H100 SXM."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bert_mask(rng, B, S, device):
    """Additive BERT key mask [B,1,1,S]: -10000 on padding, each sequence
    keeping between S/2 and S tokens."""
    lengths = rng.integers(S // 2, S + 1, B)
    keep = np.arange(S)[None, :] < lengths[:, None]
    mask = np.where(keep, 0.0, -10000.0).astype(np.float32)
    return torch.from_numpy(mask).reshape(B, 1, 1, S).to(device)


def seed_tensor(rng):
    """A dropout seed: one int32 on the card, the full int32 range."""
    return torch.tensor([int(rng.integers(-2**31, 2**31))],
                        dtype=torch.int32, device="cuda")


def randn(rng, shape, dtype):
    """Normal inputs on the card: drawn there when large, else from rng."""
    if math.prod(shape) > 1 << 26:
        gen = torch.Generator("cuda").manual_seed(int(rng.integers(1 << 31)))
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)


# -- phase 1 -----------------------------------------------------------------

def ptxas_report(text):
    """[(kernel, registers, spill-store bytes)] from nvcc's -Xptxas=-v
    output, the kernels' names demangled where c++filt is found."""
    out, name = [], None
    for line in text.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[1].strip()
            spill = 0
        elif name and "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in line and "registers" in line:
            regs = int(line.split("Used")[1].split("registers")[0])
            out.append([name, regs, spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(n for n, _, _ in out),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for row, pretty in zip(out, names):
            row[0] = pretty.replace("(anonymous namespace)::", "").split(
                "(")[0]
    except (OSError, subprocess.CalledProcessError):
        pass
    return [tuple(row) for row in out]


# the d = 80 wgmma kernels that must spill nothing, by source: the
# (demangled, mangled) name of each instance
D80_SPILL_FREE = {
    "flash_attention_fwd.cu": (("flash_fwd_wgmma<80>",
                                "flash_fwd_wgmmaILi80E"),),
    "flash_attention_bwd.cu": (("flash_bwd_dq_wgmma<80>",
                                "flash_bwd_dq_wgmmaILi80E"),
                               ("flash_bwd_dkv_wgmma<80, false>",
                                "flash_bwd_dkv_wgmmaILi80ELb0E"),
                               ("flash_bwd_dkv_wgmma<80, true>",
                                "flash_bwd_dkv_wgmmaILi80ELb1E"))}


def build_kernels(build, ce):
    """One nvcc per CUDA source, all at once; then the Triton kernels."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        libs = dict(zip(CUDA_SOURCES, pool.map(build.build, CUDA_SOURCES)))
    log(f"build: nvcc {' '.join(CUDA_SOURCES)} in parallel "
        f"{time.perf_counter() - t0:.1f} s")
    for source, lib in libs.items():
        with open(lib + ".log") as f:
            report = ptxas_report(f.read())
        spills = [(n, r, b) for n, r, b in report if b]
        log(f"  {source}: {len(report)} kernels, registers "
            f"{min(r for _, r, _ in report)}-{max(r for _, r, _ in report)}"
            f", {len(spills)} with spill stores")
        for name, regs, spill in report:
            if "wgmma" in name or spill:
                log(f"  {source}: {name}: {regs} registers, {spill} bytes "
                    "spill stores")
        # the d = 80 forward's 40-register O fits beside its scores, dQ's
        # beside S, dP and the dS fragments, and dK/dV's two 40-register
        # accumulators beside S^T and dP^T
        for demangled, mangled in D80_SPILL_FREE.get(source, ()):
            d80 = [b for n, _, b in report if demangled in n or mangled in n]
            require(f"ptxas: {demangled} built with 0 bytes of spill stores "
                    f"({d80})", d80 == [0])
    t0 = time.perf_counter()
    probe = torch.zeros(8, 1024, device="cuda", dtype=torch.bfloat16)
    labels = torch.zeros(8, dtype=torch.int32, device="cuda")
    _, lse = ce.softmax_ce_fwd(probe, labels)
    ce.softmax_ce_bwd(probe, labels, lse, torch.ones_like(lse))
    torch.cuda.synchronize()
    log(f"build: triton softmax_ce_fwd, softmax_ce_bwd "
        f"{time.perf_counter() - t0:.1f} s")


# -- phase 2 -----------------------------------------------------------------

# (atol, reason, rtol) of the flash forward's o
FWD_TOL = {
    torch.bfloat16: (1e-2, "the kernel rounds P to bf16 before the P.V "
                     "product (2^-9 relative, |v| <= ~5), and both sides "
                     "round o to bf16 (one ulp, 2^-7 relative)", 2.0 ** -7),
    torch.float32: (1e-4, "f32 throughout; the order of the sums over d "
                    "and over keys differs", 0.0)}
LSE_TOL = (1e-3, "f32 scores and sums; summation order differs")
# (atol, reason, rtol) of dQ, dK, dV
BWD_TOL = {
    torch.bfloat16: (2e-3, "both sides round dS and P~ to bf16 before "
                     "their products and the result to bf16 (one ulp, "
                     "2^-7 relative); f32 scores computed in another order "
                     "flip the rounding of a few dS terms (2^-8 of a term "
                     "of ~1e-3)", 2.0 ** -7),
    torch.float32: (1e-4, "f32 throughout; the order of the sums over d, "
                    "keys and queries differs", 1e-4)}


def dropout_checks(rng, fa):
    """Phase 2a: the CUDA keep-mask helper against the plain hash, bitwise,
    at the slice shape and at S=200."""
    for bh, s in ((64 * 12, 512), (2 * 3, 200)):
        seed = seed_tensor(rng)
        got = fa.dropout_keep_mask(seed, bh, s, s, 0.9)
        torch.cuda.synchronize()
        want = fa.dropout_keep_mask_plain(seed, bh, s, s, 0.9)
        diff = int((got != want).sum())
        frac = got.float().mean().item()
        log(f"check dropout keep bits [{bh},{s},{s}] seed {seed.item()}: "
            f"{diff} of {got.numel()} differ, keep fraction {frac:.6f}")
        require(f"dropout keep bits [{bh},{s},{s}] bitwise equal", diff == 0)
        del got, want


# the largest error of the wgmma forward's o, of dQ and of dK, dV over
# phase 2's checks
WGMMA_ERR = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}


def kernel_dropout_checks(rng, fa):
    """Phase 2a': the keep bits inside the wgmma forward, dQ and dK/dV
    kernels at d = 64, 128 and GPT-3 2.7B's 80, bitwise.  With q = 0
    every key of a row has p = 1/S; with V (and K for dQ) holding the
    identity on keys [p d, (p + 1) d) and zeros elsewhere, o[i, c] =
    keep(i, p d + c) / (keep S), and with dO = 1 and D = 0, dQ[i, c] =
    scale keep(i, p d + c) / (keep S): nonzero exactly where the key is
    kept.  For dK/dV, dO holds the identity on rows [p d,
    (p + 1) d) instead, so dV[key, c] = keep(p d + c, key) / (keep S):
    nonzero exactly where row p d + c keeps the key.  S is a whole number
    of d-key blocks.  Compared with the plain hash's bits over every (row,
    key)."""
    B, H, keep = 2, 3, 0.9
    bf = torch.bfloat16
    for D, S, routes in ((64, 256, WGMMA), (128, 256, WGMMA),
                         (80, 320, WGMMA)):
        assert all(fa.flash_route(kern, bf, D, S, S) == routes[kern]
                   for kern in ("fwd", "dq", "dkv"))
        seed = seed_tensor(rng)
        want = fa.dropout_keep_mask_plain(seed, B * H, S, S, keep).reshape(
            B, H, S, S)
        q = torch.zeros(B, H, S, D, dtype=bf, device="cuda")
        k = randn(rng, (B, H, S, D), bf)
        do = torch.ones(B, H, S, D, dtype=bf, device="cuda")
        lse = torch.full((B, H, S), math.log(S), device="cuda")
        dsum = torch.zeros(B, H, S, device="cuda")
        got_o = torch.zeros(B, H, S, S, dtype=torch.bool, device="cuda")
        got_dq = torch.zeros_like(got_o)
        got_dv = torch.zeros_like(got_o)
        for p in range(S // D):
            eye = torch.zeros(B, H, S, D, dtype=bf, device="cuda")
            eye[:, :, p * D:(p + 1) * D] = torch.eye(D, dtype=bf,
                                                     device="cuda")
            o, _ = fa.flash_attention_fwd(q, k, eye, dropout_keep=keep,
                                          seed=seed)
            dq = fa.flash_attention_bwd_dq(q, eye, eye, do, lse, dsum,
                                           dropout_keep=keep, seed=seed)
            _, dv = fa.flash_attention_bwd_dkv(q, k, k, eye, lse, dsum,
                                               dropout_keep=keep, seed=seed)
            got_o[..., p * D:(p + 1) * D] = o != 0
            got_dq[..., p * D:(p + 1) * D] = dq != 0
            got_dv[..., p * D:(p + 1) * D, :] = (dv != 0).transpose(-1, -2)
        torch.cuda.synchronize()
        for kern, label, got in (("fwd", "forward", got_o),
                                 ("dq", "dQ", got_dq),
                                 ("dkv", "dK/dV", got_dv)):
            diff = int((got != want).sum())
            log(f"check {routes[kern]} {label} d={D} dropout keep bits "
                f"[{B * H},{S},{S}]: {diff} of {got.numel()} differ")
            require(f"{routes[kern]} {label} d={D} keep bits bitwise equal "
                    "to the plain hash", diff == 0)


# the route of each flash kernel at a shape (flash_attention.flash_route):
# all three on wgmma at bf16 d = 64, 80 and 128; f32 on plain FMA
WGMMA = dict(fwd="wgmma", dq="wgmma", dkv="wgmma")
SIMT = dict(fwd="simt", dq="simt", dkv="simt")
# GPT's attention (path i): GPT-small's causal heads with dropout and GPT-3
# 2.7B's d = 80 heads (bench_gpt_layer's [2,32,2048,80], bench.py:198),
# with and without dropout, all on the wgmma kernels
GPT_FLASH = (((8, 12, 1024, 64), 0.9, WGMMA),
             ((2, 32, 2048, 80), 0.9, WGMMA),
             ((2, 32, 2048, 80), 1.0, WGMMA))


def flash_repeat_checks(rng, fa, rng80):
    """Phase 2a'': two launches of each wgmma and mma.sync kernel on the
    same inputs give the same bits (no atomics, no order that varies): the
    forward, dQ and dK/dV at BERT's, Llama's, the d = 128 block's, ragged,
    d = 80 (ragged causal, and the key mask at keep 0.9; inputs from
    ``rng80``) and GPT's (``GPT_FLASH``) shapes, then the blockwise dK/dV
    at the witness's empty, diagonal and full blocks, the full one also
    against its plain version, and the d = 80 blockwise forward, dQ and
    dK/dV (``d80_ring_checks``)."""
    bf = torch.bfloat16
    for gen, (B, H, S, D), causal, masked, keep in (
            (rng, (64, 12, 512, 64), False, True, 0.9),
            (rng, (8, 12, 1024, 64), True, False, 1.0),
            (rng, (1, 32, 2048, 128), False, False, 1.0),
            (rng, (2, 3, 200, 64), False, True, 0.9),
            (rng, (2, 3, 1000, 128), True, False, 1.0),
            (rng80, (2, 3, 1000, 80), True, False, 1.0),
            (rng80, (2, 4, 512, 80), False, True, 0.9),
            *((rng, shape, True, False, keep)
              for shape, keep, _ in GPT_FLASH)):
        q, k, v, do = (randn(gen, (B, H, S, D), bf) for _ in range(4))
        mask = bert_mask(gen, B, S, "cuda") if masked else None
        seed = seed_tensor(gen) if keep < 1.0 else None
        kw = dict(mask=mask, causal=causal, dropout_keep=keep, seed=seed)
        runs = []
        for _ in range(2):
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            dsum = (do.float() * o.float()).sum(-1)
            runs.append((o, lse, fa.flash_attention_bwd_dq(
                q, k, v, do, lse, dsum, **kw), *fa.flash_attention_bwd_dkv(
                    q, k, v, do, lse, dsum, **kw)))
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        route = "/".join(fa.flash_route(kern, bf, D, S, S)
                         for kern in ("fwd", "dq", "dkv"))
        require(f"{route} [{B},{H},{S},{D}] causal={causal} keep {keep}: two "
                f"launches give the same bits (o, lse, dq, dk, dv: {same})",
                all(same))
        del q, k, v, do, runs
    B, H, S, D = 1, 32, 2048, 128
    assert fa.flash_route("dkv", bf, D, S, S) == "wgmma"
    q, k, v, do = (randn(rng, (B, H, S, D), bf) for _ in range(4))
    # an empty block's rows take the diagonal's lse, as the ring's combined
    # lse would give them
    lse_diag = fa.flash_attention_block(q, k, v, 0, 0)[1]
    for label, q_off, k_off in (("full", S, 0), ("diagonal", 0, 0),
                                ("empty", 0, S)):
        o, lse = fa.flash_attention_block(q, k, v, q_off, k_off)
        if label == "empty":
            lse = lse_diag
        dsum = (do.float() * o.float()).sum(-1)
        runs = [fa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum,
                                                 q_off, k_off)
                for _ in range(2)]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        require(f"wgmma block dK/dV [{B},{H},{S},{D}] {label} ({q_off},"
                f"{k_off}): two launches give the same bits (dk, dv: "
                f"{same})", all(same))
        if label == "full":
            _, dk_p, dv_p = fa.flash_attention_block_bwd_plain(
                q, k, v, do, lse, dsum, q_off, k_off)
            for g, got, want in (("dk", runs[0][0], dk_p),
                                 ("dv", runs[0][1], dv_p)):
                err = check(f"wgmma block dK/dV [{B},{H},{S},{D}] full "
                            f"{g}", got, want, *BWD_TOL[bf])
                WGMMA_ERR["dkv"] = max(WGMMA_ERR["dkv"], err)
            del dk_p, dv_p
        del o, lse, dsum, runs
    del q, k, v, do, lse_diag
    d80_ring_checks(rng80, fa)


def d80_ring_checks(rng, fa):
    """The d = 80 blockwise forward, dQ and dK/dV on the wgmma kernels at
    every step of a 4-rank ring of [1,32,2048,80] blocks (q, K/V
    [1,32,8192,80]): step 0 runs the diagonal blocks, steps 1-3 full ones
    (rank g >= r) and empty ones (g < r).  Two launches give the same
    bits; o and lse (live rows) agree with the plain version, dq, dk and
    dv (from the step's own o and lse and a random cotangent) within the
    spread of their bf16 terms; rows with no live key get lse = -1e30, o =
    0 and dq = 0, K/V rows that no query sees dk = dv = 0, bitwise.  Logs
    the seconds the dQ checks took."""
    bf = torch.bfloat16
    B, H, G, D, n = 1, 32, 2048, 80, 4
    routes = {kern: fa.flash_route(kern, bf, D, n * G, n * G, n)
              for kern in ("fwd", "dq", "dkv")}
    require(f"block ring [{B},{H},{G},{D}] x {n}: the wgmma forward, dQ and "
            f"dK/dV ({routes})", routes == WGMMA)
    q, k, v = (randn(rng, (B, H, n * G, D), bf) for _ in range(3))
    do = randn(rng, (B, H, n * G, D), bf)
    atol, _, rtol = BWD_TOL[bf]
    why = ("both sides round dS and P~ to bf16 before their products; a "
           "term whose f32 value the two compute in another order may round "
           "one ulp apart, and short causal rows make terms of ~1")
    dq_s = 0.0
    for r in range(n):
        name = f"wgmma block ring [{B},{H},{G},{D}] x {n} step {r}"
        runs = [fa.flash_attention_block(q, k, v, 0, 0, ring=(n, r))
                for _ in range(2)]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        require(f"{name}: two launches give the same bits (o, lse: {same})",
                all(same))
        o, lse = runs[0]
        o_p, lse_p = fa.flash_attention_block_plain(q, k, v, 0, 0,
                                                    ring=(n, r))
        err = check(f"{name} o", o, o_p, *FWD_TOL[bf])
        WGMMA_ERR["fwd"] = max(WGMMA_ERR["fwd"], err)
        live = lse_p > -1e30
        check(f"{name} lse (live rows)", torch.where(live, lse, 0.0),
              torch.where(live, lse_p, 0.0), *LSE_TOL)
        require(f"{name}: empty rows lse = -1e30 and o = 0 bitwise "
                f"({int((~live).sum())} rows)",
                bool((lse[~live] == -1e30).all())
                and bool((o.float().abs().sum(-1)[~live] == 0).all()))
        dsum = (do.float() * o.float()).sum(-1)
        runs = [fa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum, 0,
                                                 0, ring=(n, r))
                for _ in range(2)]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(*runs)]
        require(f"{name} dK/dV: two launches give the same bits (dk, dv: "
                f"{same})", all(same))
        dk, dv = runs[0]
        t0 = time.perf_counter()
        dqs = [fa.flash_attention_block_bwd_dq(q, k, v, do, lse, dsum, 0, 0,
                                               ring=(n, r))
               for _ in range(2)]
        torch.cuda.synchronize()
        require(f"{name} dQ: two launches give the same bits",
                torch.equal(*dqs))
        dq_s += time.perf_counter() - t0
        dq_p, dk_p, dv_p = fa.flash_attention_block_bwd_plain(
            q, k, v, do, lse_p, dsum, 0, 0, ring=(n, r))
        sp_q, sp_k, sp_v = bwd_spread(q, k, v, do, lse_p, dsum, 0, 0, (n, r))
        t0 = time.perf_counter()
        err = check_spread(f"{name} dq", dqs[0], dq_p, atol, rtol, sp_q, why)
        WGMMA_ERR["dq"] = max(WGMMA_ERR["dq"], err)
        dead = ~live[0, 0]  # q rows with no live key, in every head
        require(f"{name}: q rows with no live key get dq = 0 bitwise "
                f"({int(dead.sum())} rows)",
                bool((dqs[0][:, :, dead] == 0).all()))
        dq_s += time.perf_counter() - t0
        for g, got, want, sp in (("dk", dk, dk_p, sp_k),
                                 ("dv", dv, dv_p, sp_v)):
            err = check_spread(f"{name} {g}", got, want, atol, rtol, sp, why)
            WGMMA_ERR["dkv"] = max(WGMMA_ERR["dkv"], err)
        dead = dead_kv_rows(G * n, G * n, 0, 0, (n, r))
        require(f"{name}: K/V rows no query sees get dk = dv = 0 bitwise "
                f"({int(dead.sum())} rows)",
                bool((dk[:, :, dead] == 0).all())
                and bool((dv[:, :, dead] == 0).all()))
        del (runs, o, lse, o_p, lse_p, live, dsum, dk, dv, dqs, dq_p, dk_p,
             dv_p, sp_q, sp_k, sp_v)
    log(f"block ring [{B},{H},{G},{D}] x {n}: the dQ checks took {dq_s:.1f} s "
        "(launches, bits, spread, dead rows; the plain backward and the "
        "spreads are shared with dK/dV)")
    del q, k, v, do
    torch.cuda.empty_cache()


def flash_fwd_checks(rng, fa, rng80):
    """Phase 2b: the CUDA flash forward against its plain version; at
    GPT's shapes (``GPT_FLASH``) each on its route; d = 80's own cases
    draw from ``rng80``."""
    def case(label, B, H, S, D, dtype, mask=None, causal=False, keep=1.0,
             route=None, gen=rng):
        q, k, v = (randn(gen, (B, H, S, D), dtype) for _ in range(3))
        seed = seed_tensor(gen) if keep < 1.0 else None
        o, lse = fa.flash_attention_fwd(q, k, v, mask=mask, causal=causal,
                                        dropout_keep=keep, seed=seed)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask,
                                              causal=causal,
                                              dropout_keep=keep, seed=seed)
        got = fa.flash_route("fwd", dtype, D, S, S)
        name = f"flash fwd {label} {str(dtype).split('.')[-1]} ({got})"
        if route:
            require(f"{name}: the {route} route", got == route)
        err = check(f"{name} o", o, o_p, *FWD_TOL[dtype])
        check(f"{name} lse", lse, lse_p, *LSE_TOL)
        if got == "wgmma":
            WGMMA_ERR["fwd"] = max(WGMMA_ERR["fwd"], err)
        return o, lse, err

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        mask = bert_mask(rng, 64, 512, "cuda")
        errs[dtype] = case("[64,12,512,64] bert-mask", 64, 12, 512, 64,
                           dtype, mask=mask)[-1]
        errs[dtype, 0.9] = case("[64,12,512,64] bert-mask keep 0.9", 64, 12,
                                512, 64, dtype, mask=mask, keep=0.9)[-1]
        case("[2,4,512,64] causal", 2, 4, 512, 64, dtype, causal=True)
        case("[2,4,512,64] causal+mask keep 0.9", 2, 4, 512, 64, dtype,
             mask=bert_mask(rng, 2, 512, "cuda"), causal=True, keep=0.9)
        empty = bert_mask(rng, 2, 256, "cuda") * 1e26  # -1e30 on padding
        empty[1] = -1e30                                # every key of batch 1
        o, lse, _ = case("[2,4,256,64] fully-masked", 2, 4, 256, 64, dtype,
                         mask=empty)
        require(f"flash fwd fully-masked rows o = 0, lse = 1e30 "
                f"{str(dtype).split('.')[-1]}",
                bool((o[1] == 0).all()) and bool((lse[1] == 1e30).all()))
        case("[2,3,200,40] padded+mask", 2, 3, 200, 40, dtype,
             mask=bert_mask(rng, 2, 200, "cuda"))
        case("[2,3,200,40] padded+mask keep 0.9", 2, 3, 200, 40, dtype,
             mask=bert_mask(rng, 2, 200, "cuda"), keep=0.9)
        case("[2,3,200,40] padded causal", 2, 3, 200, 40, dtype, causal=True)
        # ragged S on the wgmma kernel, masked inside it
        case("[2,3,200,64] padded+mask keep 0.9", 2, 3, 200, 64, dtype,
             mask=bert_mask(rng, 2, 200, "cuda"), keep=0.9)
        case("[2,3,1000,64] padded causal", 2, 3, 1000, 64, dtype,
             causal=True)
        # GPT-3 2.7B's head on the wgmma kernel (64-column halves, the
        # second filled in part): ragged causal, and the key mask
        case("[2,3,1000,80] padded causal", 2, 3, 1000, 80, dtype,
             causal=True, gen=rng80)
        case("[2,4,512,80] bert-mask", 2, 4, 512, 80, dtype,
             mask=bert_mask(rng80, 2, 512, "cuda"), gen=rng80)
        case("[2,4,512,80] bert-mask keep 0.9", 2, 4, 512, 80, dtype,
             mask=bert_mask(rng80, 2, 512, "cuda"), keep=0.9, gen=rng80)
        # a head the wgmma kernel does not take: the mma.sync kernel
        case("[2,4,512,96] bert-mask keep 0.9", 2, 4, 512, 96, dtype,
             mask=bert_mask(rng, 2, 512, "cuda"), keep=0.9)
        case("[1,2,256,128] head-128", 1, 2, 256, 128, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"))
        case("[1,2,256,256] wide-head", 1, 2, 256, 256, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"))
        case("[1,2,256,512] widest-head causal", 1, 2, 256, 512, dtype,
             causal=True)
        # more (batch, head) pairs than the 65535 blocks of a grid's y axis
        case("[4100,16,128,32] many-heads", 4100, 16, 128, 32, dtype,
             mask=bert_mask(rng, 4100, 128, "cuda"))
    for (B, H, S, D), keep, routes in GPT_FLASH:
        case(f"[{B},{H},{S},{D}] causal keep {keep}", B, H, S, D,
             torch.bfloat16, causal=True, keep=keep, route=routes["fwd"])
        torch.cuda.empty_cache()
    return errs


def flash_bwd_checks(rng, fa, rng80):
    """Phase 2c: the dQ and dK/dV kernels against the plain backward, from
    the same forward outputs (o, lse) and cotangent; at GPT's shapes
    (``GPT_FLASH``) each on its routes and within the spread of the bf16
    terms of each entry (``spread``, causal and unmasked only), as the
    block checks hold them: short causal rows make terms of ~1.  d = 80's
    own cases draw from ``rng80``."""
    def case(label, B, H, S, D, dtype, mask=None, causal=False, keep=1.0,
             routes=None, spread=False, gen=rng):
        q, k, v, do = (randn(gen, (B, H, S, D), dtype) for _ in range(4))
        seed = seed_tensor(gen) if keep < 1.0 else None
        o, lse = fa.flash_attention_fwd(q, k, v, mask=mask, causal=causal,
                                        dropout_keep=keep, seed=seed)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, mask=mask,
                                       causal=causal, dropout_keep=keep,
                                       seed=seed)
        torch.cuda.synchronize()
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, mask=mask,
                                             causal=causal,
                                             dropout_keep=keep, seed=seed)
        route_dq = fa.flash_route("dq", dtype, D, S, S)
        route_kv = fa.flash_route("dkv", dtype, D, S, S)
        name = (f"flash bwd {label} {str(dtype).split('.')[-1]} (dq "
                f"{route_dq}, dkv {route_kv})")
        if routes:
            require(f"{name}: dq on {routes['dq']}, dkv on {routes['dkv']}",
                    (route_dq, route_kv) == (routes["dq"], routes["dkv"]))
        if spread:
            drop = None if keep >= 1.0 else (fa.dropout_keep_mask_plain(
                seed, B * H, S, S, keep).reshape(B, H, S, S).float(), keep)
            spreads = bwd_spread(q, k, v, do, lse,
                                 (do.float() * o.float()).sum(-1), 0, 0,
                                 drop=drop)
            del drop
            atol, _, rtol = BWD_TOL[dtype]
            errs = [check_spread(
                f"{name} {g}", got, want, atol, rtol, sp,
                "both sides round dS and P~ to bf16 before their products; "
                "a term whose f32 value the two compute in another order "
                "may round one ulp apart")
                for g, got, want, sp in zip(("dq", "dk", "dv"), grads, plain,
                                            spreads)]
        else:
            errs = [check(f"{name} {g}", got, want, *BWD_TOL[dtype])
                    for g, got, want in zip(("dq", "dk", "dv"), grads,
                                            plain)]
        if route_dq == "wgmma":
            WGMMA_ERR["dq"] = max(WGMMA_ERR["dq"], errs[0])
        if route_kv == "wgmma":
            WGMMA_ERR["dkv"] = max(WGMMA_ERR["dkv"], *errs[1:])
        return grads, errs

    errs = {}
    dtype = torch.bfloat16
    mask = bert_mask(rng, 64, 512, "cuda")
    _, e = case("[64,12,512,64] bert-mask keep 0.9", 64, 12, 512, 64, dtype,
                mask=mask, keep=0.9)
    errs["dq"], errs["dkv"] = e[0], max(e[1:])
    case("[64,12,512,64] bert-mask keep 1.0", 64, 12, 512, 64, dtype,
         mask=mask)
    for dtype in (torch.bfloat16, torch.float32):
        case("[2,4,512,64] bert-mask keep 0.9", 2, 4, 512, 64, dtype,
             mask=bert_mask(rng, 2, 512, "cuda"), keep=0.9)
        case("[2,4,512,64] causal keep 0.9", 2, 4, 512, 64, dtype,
             causal=True, keep=0.9)
        case("[2,4,512,64] causal+mask", 2, 4, 512, 64, dtype,
             mask=bert_mask(rng, 2, 512, "cuda"), causal=True)
        empty = bert_mask(rng, 2, 256, "cuda") * 1e26
        empty[1] = -1e30
        grads, _ = case("[2,4,256,64] fully-masked keep 0.9", 2, 4, 256, 64,
                        dtype, mask=empty, keep=0.9)
        require(f"flash bwd fully-masked rows give zero gradients "
                f"{str(dtype).split('.')[-1]}",
                all(bool((g[1] == 0).all()) for g in grads))
        case("[2,3,200,40] padded+mask keep 0.9", 2, 3, 200, 40, dtype,
             mask=bert_mask(rng, 2, 200, "cuda"), keep=0.9)
        case("[2,3,200,40] padded causal", 2, 3, 200, 40, dtype, causal=True)
        case("[2,3,200,64] padded+mask keep 0.9", 2, 3, 200, 64, dtype,
             mask=bert_mask(rng, 2, 200, "cuda"), keep=0.9)
        case("[2,3,1000,64] padded causal", 2, 3, 1000, 64, dtype,
             causal=True)
        # GPT-3 2.7B's head on the wgmma dQ and dK/dV kernels (64-column
        # halves, the second filled in part): ragged causal, and the key
        # mask
        case("[2,3,1000,80] padded causal", 2, 3, 1000, 80, dtype,
             causal=True, gen=rng80)
        case("[2,4,512,80] bert-mask keep 0.9", 2, 4, 512, 80, dtype,
             mask=bert_mask(rng80, 2, 512, "cuda"), keep=0.9, gen=rng80)
        case("[2,4,512,96] bert-mask keep 0.9", 2, 4, 512, 96, dtype,
             mask=bert_mask(rng, 2, 512, "cuda"), keep=0.9)
        case("[1,2,256,128] head-128 keep 0.9", 1, 2, 256, 128, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"), keep=0.9)
        case("[1,2,256,256] wide-head causal keep 0.9", 1, 2, 256, 256,
             dtype, causal=True, keep=0.9)
        case("[1,2,256,512] widest-head", 1, 2, 256, 512, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"))
    for (B, H, S, D), keep, routes in GPT_FLASH:
        case(f"[{B},{H},{S},{D}] causal keep {keep}", B, H, S, D,
             torch.bfloat16, causal=True, keep=keep, routes=routes,
             spread=True)
        torch.cuda.empty_cache()
    return errs


def _name(dtype):
    return str(dtype).split(".")[-1]


def bwd_spread(q, k, v, do, lse, dsum, q_off, k_off, ring=None, drop=None):
    """Per entry of (dq, dk, dv) of the blockwise backward: the sum of the
    sizes of its terms (|dS| |K| scale, |dS|^T |Q| scale, P~^T |dO|) over
    each rank's block pair, in f32.  With dropout, ``drop`` = (m, keep), m
    the keep bits as f32 [B, H, Sq, Sk]: P~ = P m / keep and dS = P (m dP
    / keep - D)."""
    n, r = ring or (1, 0)
    gq, gk = q.shape[2] // n, k.shape[2] // n
    scale = q.shape[-1] ** -0.5
    out = [torch.zeros(t.shape, device=t.device) for t in (q, k, v)]
    for g in range(n):
        src = (g - r) % n
        qs, ks = slice(g * gq, (g + 1) * gq), slice(src * gk, (src + 1) * gk)
        qf, kf, vf, dof = (t.float() for t in (q[:, :, qs], k[:, :, ks],
                                               v[:, :, ks], do[:, :, qs]))
        rows = q_off + g * gq + torch.arange(gq, device=q.device)
        keys = k_off + src * gk + torch.arange(gk, device=q.device)
        p = torch.exp(qf @ kf.transpose(-1, -2) * scale
                      - lse[:, :, qs, None]).masked_fill(
                          keys[None, :] > rows[:, None], 0.0)
        dp = dof @ vf.transpose(-1, -2)
        if drop is not None:
            p_kept = p * drop[0][:, :, qs, ks] / drop[1]
            dp = dp * drop[0][:, :, qs, ks] / drop[1]
        ds = (p * (dp - dsum[:, :, qs, None])).abs()
        out[0][:, :, qs] = scale * ds @ kf.abs()
        out[1][:, :, ks] = scale * ds.transpose(-1, -2) @ qf.abs()
        out[2][:, :, ks] = (p if drop is None else p_kept).transpose(
            -1, -2) @ dof.abs()
    return out


def dead_kv_rows(sq, sk, q_off, k_off, ring=None):
    """The K/V rows [sk] of a blockwise step that no query sees causally:
    each row of q sits at q_off + i, each key at k_off + j, a ring rank's
    at its block's."""
    n, r = ring or (1, 0)
    gq, gk = sq // n, sk // n
    dead = torch.zeros(sk, dtype=torch.bool, device="cuda")
    for g in range(n):
        src = (g - r) % n
        last_row = q_off + g * gq + gq - 1
        keys = k_off + src * gk + torch.arange(gk, device="cuda")
        dead[src * gk:(src + 1) * gk] = keys > last_row
    return dead


def block_checks(rng, fa, rng80):
    """Phase 2c': the blockwise (ring) forward, dQ and dK/dV kernels
    against their plain versions: one block pair at the full, diagonal,
    empty and partial offsets, a K/V block twice q's length, and every
    step of a 4-rank ring at the main path's shape and of 4-rank rings of
    64-row groups at d = 64 and 80 (the mma.sync kernels; at d = 80 the
    smoke's only launch of flash_bwd_dq_mma<80>, its seconds logged).
    The backward takes the forward's own (o, lse) and a random
    cotangent.  Empty rows must
    give lse = -1e30 and o = 0, and K/V rows that no query sees dk = dv =
    0, bitwise.  The d = 80 cases draw from ``rng80``.  Returns the
    largest errors of the bf16 ring cases (the main path's)."""
    def case(label, q_shape, sk, q_off, k_off, dtype, ring=None):
        B, H, S, D = q_shape
        gen = rng80 if D == 80 else rng
        q, do = (randn(gen, q_shape, dtype) for _ in range(2))
        k, v = (randn(gen, (B, H, sk, D), dtype) for _ in range(2))
        kw = dict(ring=ring)
        o, lse = fa.flash_attention_block(q, k, v, q_off, k_off, **kw)
        dsum = (do.float() * o.float()).sum(-1)
        dq = fa.flash_attention_block_bwd_dq(q, k, v, do, lse, dsum, q_off,
                                             k_off, **kw)
        dk, dv = fa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum,
                                                  q_off, k_off, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_block_plain(q, k, v, q_off, k_off,
                                                    ring=ring)
        plain = fa.flash_attention_block_bwd_plain(q, k, v, do, lse_p, dsum,
                                                   q_off, k_off, ring=ring)
        n = (ring or (1, 0))[0]
        route, route_dq, route_kv = (fa.flash_route(kern, dtype, D, S, sk, n)
                                     for kern in ("fwd", "dq", "dkv"))
        name = (f"block {label} {_name(dtype)} ({route}, dq {route_dq}, dkv "
                f"{route_kv})")
        errs = [check(f"{name} o", o, o_p, *FWD_TOL[dtype])]
        live = lse_p > -1e30
        check(f"{name} lse (live rows)", torch.where(live, lse, 0.0),
              torch.where(live, lse_p, 0.0), *LSE_TOL)
        require(f"{name}: empty rows lse = -1e30 and o = 0 bitwise "
                f"({int((~live).sum())} rows)",
                bool((lse[~live] == -1e30).all())
                and bool((o.float().abs().sum(-1)[~live] == 0).all()))
        if dtype == torch.float32:
            errs += [check(f"{name} {g}", got, want, *BWD_TOL[dtype])
                     for g, got, want in zip(("dq", "dk", "dv"),
                                             (dq, dk, dv), plain)]
        else:
            spread = bwd_spread(q, k, v, do, lse_p, dsum, q_off, k_off, ring)
            atol, _, rtol = BWD_TOL[dtype]
            errs += [check_spread(
                f"{name} {g}", got, want, atol, rtol, sp,
                "both sides round dS and P~ to bf16 before their products; "
                "a term whose f32 value the two compute in another order "
                "may round one ulp apart, and short causal rows make terms "
                "of ~1") for g, got, want, sp in zip(
                    ("dq", "dk", "dv"), (dq, dk, dv), plain, spread)]
        if route == "wgmma":
            WGMMA_ERR["fwd"] = max(WGMMA_ERR["fwd"], errs[0])
        if route_dq == "wgmma":
            WGMMA_ERR["dq"] = max(WGMMA_ERR["dq"], errs[1])
        if route_kv == "wgmma":
            WGMMA_ERR["dkv"] = max(WGMMA_ERR["dkv"], *errs[2:])
        dead = dead_kv_rows(S, sk, q_off, k_off, ring)
        require(f"{name}: K/V rows no query sees get dk = dv = 0 bitwise "
                f"({int(dead.sum())} rows)",
                bool((dk[:, :, dead] == 0).all())
                and bool((dv[:, :, dead] == 0).all()))
        return errs

    for dtype in (torch.bfloat16, torch.float32):
        for D in (64, 80, 128):
            S = 256
            for label, q_off, k_off in (("full", S, 0), ("diagonal", 0, 0),
                                        ("empty", 0, S)):
                case(f"[2,4,{S},{D}] {label} ({q_off},{k_off})",
                     (2, 4, S, D), S, q_off, k_off, dtype)
            case(f"[2,4,256,{D}] partial (192,0)", (2, 4, 256, D), 256, 192,
                 0, dtype)
            case(f"[2,4,256,{D}] Sk=512 (512,128)", (2, 4, 256, D), 512, 512,
                 128, dtype)
            case(f"[2,4,256,{D}] Sk=512 (0,0)", (2, 4, 256, D), 512, 0, 0,
                 dtype)
            # rows 0-31 have no live key in the first kv tile they run
            case(f"[2,4,256,{D}] misaligned (0,32)", (2, 4, 256, D), 256, 0,
                 32, dtype)
    errs, mma80_s = [], 0.0
    for r in range(4):
        # the main path's ring steps: [8,12,1024,64] over 4 ranks
        errs.append(case(f"ring [8,12,1024,64] cp=4 step {r}",
                         (8, 12, 1024, 64), 1024, 0, 0, torch.bfloat16,
                         ring=(4, r)))
        case(f"ring [1,2,1024,128] cp=4 step {r}", (1, 2, 1024, 128), 1024,
             0, 0, torch.float32, ring=(4, r))
        # groups of 64 rows, which a 128-row wgmma q tile or kv item would
        # straddle: the mma.sync kernels
        case(f"ring [2,4,256,64] cp=4 step {r}", (2, 4, 256, 64), 256, 0, 0,
             torch.bfloat16, ring=(4, r))
        # d = 80 64-row ring groups: the mma.sync dQ's only launch in the
        # smoke
        t0 = time.perf_counter()
        before = fa.route_launches["dq", "mma"]
        case(f"ring [2,4,256,80] cp=4 step {r}", (2, 4, 256, 80), 256, 0, 0,
             torch.bfloat16, ring=(4, r))
        route = fa.flash_route("dq", torch.bfloat16, 80, 256, 256, 4)
        require(f"ring [2,4,256,80] cp=4 step {r}: dQ on the mma.sync "
                f"route, flash_bwd_dq_mma<80> ({route}, "
                f"{fa.route_launches['dq', 'mma'] - before} launch)",
                route == "mma"
                and fa.route_launches["dq", "mma"] == before + 1)
        mma80_s += time.perf_counter() - t0
    log(f"ring [2,4,256,80] cp=4, 64-row groups on mma.sync: {mma80_s:.1f} "
        "s for its 4 steps' checks")
    return {"fwd": max(e[0] for e in errs), "dq": max(e[1] for e in errs),
            "dkv": max(max(e[2:]) for e in errs)}


def ce_checks(rng, ce):
    """Phase 2d: the Triton CE forward and backward against their plain
    versions, ~15% ignored labels; at GPT's vocab of 50257 (24 chunks of
    2048 and a 1105-wide tail) also ~1% of labels out of range (past V,
    or negative and not ignored), which pick no logit."""
    why = "f32 online max/sum-exp over the same upcast values; order differs"
    bwd_tol = {torch.bfloat16: (1e-6, "the same f32 formula on both sides; "
                                "exp may differ in its last f32 bit, which "
                                "can flip the bf16 rounding (one ulp)",
                                2.0 ** -7),
               torch.float32: (1e-6, "the same f32 formula; exp may differ "
                               "in its last bits", 1e-5)}

    def case(N, V, dtype, out_of_range=False):
        x = randn(rng, (N, V), torch.float32).mul_(3.0).to(dtype)
        labels = rng.integers(0, V, N)
        labels[rng.random(N) < 0.15] = -1
        if out_of_range:
            far = rng.random(N) < 0.01
            labels[far] = np.where(rng.random(far.sum()) < 0.5,
                                   rng.integers(V, 2 * V, far.sum()),
                                   rng.integers(-1000, -1, far.sum()))
        labels = torch.from_numpy(labels.astype(np.int32)).cuda()
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).cuda()
        loss, lse = ce.softmax_ce_fwd(x, labels)
        dx = ce.softmax_ce_bwd(x, labels, lse, g)
        torch.cuda.synchronize()
        loss_p, lse_p = ce.softmax_ce_plain(x, labels)
        dx_p = ce.softmax_ce_bwd_plain(x, labels, lse, g)
        name = (f"ce [{N},{V}] {str(dtype).split('.')[-1]}"
                + (" out-of-range labels" if out_of_range else ""))
        err = check(f"{name} loss", loss, loss_p, 2e-4, why)
        check(f"{name} lse", lse, lse_p, 2e-4, why)
        err_bwd = check(f"{name} dx", dx, dx_p, *bwd_tol[dtype])
        require(f"{name} dx zero on ignored rows and in the logits' dtype",
                bool((dx[labels == -1] == 0).all()) and dx.dtype == dtype)
        if out_of_range:
            far = ((labels < -1) | (labels >= V)).cpu()
            require(f"{name}: loss = lse on the {int(far.sum())} rows whose "
                    "label is out of range", bool(far.any()) and torch.equal(
                        loss.cpu()[far], lse.cpu()[far]))
        return err, err_bwd

    errs = case(8192, 30522, torch.bfloat16)
    for n in (8192, 4096):  # GPT-small's and GPT-3 2.7B's LM-head rows
        case(n, 50257, torch.bfloat16, out_of_range=True)
    case(300, 3000, torch.bfloat16)
    case(300, 3000, torch.float32)
    return errs


def ctr_ids(rng, kind, m, n):
    """m ids in [0, n) of one kind: uniform, Zipf-skewed (s = 1.05, a few
    ids take most of the draws; every draw past the table lands on its
    last id), 30% negative (padding), half of them on the last id, or with
    every fifth id past the table (``out_of_range``)."""
    ids = rng.integers(0, n, m)
    if kind == "zipf":
        ids = np.minimum(rng.zipf(1.05, m) - 1, n - 1)
    elif kind == "negative":
        ids[rng.random(m) < 0.3] = -1
    elif kind == "tail":
        ids[rng.random(m) < 0.5] = n - 1
    elif kind == "out_of_range":
        ids[::5] = n
        ids[1::10] = n + 3
    return ids.astype(np.int32)


def pack_write_checks(rng, sd):
    """Phase 2e: the pack_write kernel bitwise against
    ``pack_write_ordered`` (its summation tree in plain PyTorch) on the
    card and on the CPU, and within the reordering bound of
    ``pack_write_plain`` on the card (a scatter-add with atomics); returns
    the max |error| against ``pack_write_ordered`` at the main path's
    shape."""
    p337 = sd.packed_rows(WDL_ROWS, 16)
    cases = (("uniform (main path)", "uniform", 3328, p337),
             ("zipf", "zipf", 3328, p337), ("zipf", "zipf", 65536, p337),
             ("30% negative", "negative", 3328, p337),
             ("out of range", "out_of_range", 3328, p337),
             # 337,001 rows: the last line holds one row
             ("tail line", "tail", 3328, sd.packed_rows(WDL_ROWS + 1, 16)),
             ("criteo table", "uniform", 3328,
              sd.packed_rows(CRITEO_ROWS, 16)),
             ("no ids", "uniform", 0, p337))
    main_err = None
    for label, kind, m, p_rows in cases:
        ids_np = ctr_ids(rng, kind, m, p_rows)
        ids = torch.from_numpy(ids_np).cuda()
        lines = randn(rng, (m, 128), torch.float32)
        got = sd.pack_write(ids, lines, p_rows)
        again = sd.pack_write(ids, lines, p_rows)
        plain = sd.pack_write_plain(ids, lines, p_rows)
        ordered = sd.pack_write_ordered(ids, lines, p_rows)
        abs_sum = sd.pack_write_plain(ids, lines.abs(), p_rows)
        torch.cuda.synchronize()
        name = f"pack_write {label} M={m} p_rows={p_rows}"
        ok = (ids_np >= 0) & (ids_np < p_rows)
        counts = torch.from_numpy(np.bincount(
            ids_np[ok], minlength=p_rows)).cuda()
        single, merged = counts == 1, counts > 1
        # both sides add the same k terms, each in its own order: two
        # recursive sums differ by at most 2 k 2^-24 sum|term|
        diff = (got - plain).abs()
        tol = 2.0 * counts[:, None].float() * 2.0 ** -24 * abs_sum
        err = (got - ordered).abs().max().item() if m else 0.0
        log(f"check {name}: {int(single.sum())} single and "
            f"{int(merged.sum())} merged lines (largest run "
            f"{int(counts.max())}), max_abs_err={err:.3e} vs "
            f"pack_write_ordered (tol 0), "
            f"{(diff.max().item() if m else 0.0):.3e} vs the card's "
            "index_add_ (tol 0 on single lines and 2*k*2^-24*sum|term| on "
            "merged ones: atomics add in another order)")
        require(f"{name}: two runs bitwise equal", torch.equal(got, again))
        require(f"{name}: bitwise equal to pack_write_ordered on the card",
                torch.equal(got, ordered))
        require(f"{name}: single lines bitwise equal to plain",
                torch.equal(got[single], plain[single]))
        require(f"{name}: merged lines within tolerance",
                bool((diff <= tol).all()))
        require(f"{name}: lines with no id stay zero",
                bool((got[counts == 0] == 0).all()))
        cpu = sd.pack_write_ordered(ids.cpu(), lines.cpu(), p_rows)
        n_diff = int((got.cpu() != cpu).any(dim=1).sum())
        require(f"{name}: bitwise equal to pack_write_ordered on the CPU "
                f"({n_diff} lines differ)", n_diff == 0)
        if m:
            ids_sorted, order = torch.sort(ids, stable=True)
            out, pieces, counters = sd.kernel_buffers(m, p_rows, "cuda")
            sd.pack_write_kernel(ids_sorted, order, lines, out, pieces,
                                 counters)
            sd.pack_write_kernel(ids_sorted, order, lines, out.zero_(),
                                 pieces, counters)
            torch.cuda.synchronize()
            require(f"{name}: the kernel leaves its {counters.numel()} "
                    "counters zero, so a second launch on the same scratch "
                    "gives the same bits",
                    not bool(counters.any()) and torch.equal(out, got))
            del out, pieces, counters
        if main_err is None:
            main_err = err
        del got, again, plain, ordered, abs_sum, diff, tol, cpu
    return main_err


def packed_lookup_checks(rng, sd):
    """Phase 2f: the packed lookup's forward on the card against the CPU,
    bitwise, with a NaN and an Inf row sharing lines with looked-up rows
    and with negative ids (clamped to row 0)."""
    rows, dim = WDL_ROWS + 1, 16
    table = randn(rng, (sd.packed_rows(rows, dim), 128), torch.float32)
    table[5, 3 * dim + 2] = float("nan")   # logical row 43
    table[9, 7 * dim:] = float("inf")      # logical row 79
    ids = torch.from_numpy(rng.integers(0, rows, (CTR_BATCH, 26)).astype(
        np.int32))
    ids[(ids == 43) | (ids == 79)] = 0
    ids[0, :5] = torch.tensor([42, 43, 44, 78, 79])
    ids[1, :3] = torch.tensor([-1, -7, rows - 1])
    got = sd.packed_lookup(table, ids.cuda(), dim)
    torch.cuda.synchronize()
    want = sd.packed_lookup(table.cpu(), ids, dim)
    same = torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    bad = ~torch.isfinite(got.cpu()).all(dim=-1)
    require("packed_lookup forward [128,26] dim 16: card bitwise equal to "
            "the CPU", same)
    require("packed_lookup: only the NaN and Inf rows themselves are "
            "non-finite", bad.nonzero().tolist() == [[0, 1], [0, 4]])
    require("packed_lookup: negative ids return logical row 0",
            torch.equal(got[1, :2].cpu(),
                        table[0, :dim].cpu().expand(2, dim)))


def moe_routing(rng, moe):
    """The gather indices of one top-2 MoE forward at the shapes of
    ``moe`` (a MOE or MIXTRAL dict): random N(0, 1) f32 logits [T, E],
    routed by the layer's gating (``top_k_gating_choices``) at the layer's
    capacity.  Returns (T, C, dispatch index [E*C] int32, [combine index
    [T] int32 per choice])."""
    from hetu_tpu_torch.ops import moe as ops_moe
    T, E = moe["B"] * moe["S"], moe["E"]
    C = max(math.ceil(moe["cf"] * T * moe["k"] / E), 1)
    logits = randn(rng, (T, E), torch.float32)
    choices, _ = ops_moe.top_k_gating_choices(logits, moe["k"], C)
    return (T, C, ops_moe.slot_to_token(choices, E, C),
            [ops_moe.token_to_slot(c, C).to(torch.int32) for c in choices])


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def row_gather_checks(rng, md):
    """Phase 2g: the row_gather kernel against ``row_gather_plain`` on the
    card, bitwise (a copy): the dispatch and the two combine gathers of
    the bench_moe path and of the Mixtral layer, in f32 and bf16, with -1,
    n, n + 5 and the int32 extremes mixed into the real routing; then one
    backward through ``RowGatherFn`` against the plain composition's
    autograd.  Returns the max |error| (0 if bitwise)."""
    worst = 0.0
    for label, moe in (("bench_moe", MOE), ("mixtral", MIXTRAL)):
        T, C, disp, combs = moe_routing(rng, moe)
        E, H = moe["E"], moe["H"]
        for name, n, idx in (("dispatch", T, disp),
                             ("combine 0", E * C, combs[0]),
                             ("combine 1", E * C, combs[1])):
            idx = idx.clone()
            idx[:6] = torch.tensor([-1, n, n + 5, -2 ** 31, 2 ** 31 - 1,
                                    n - 1], dtype=torch.int32)
            for dtype in (torch.float32, torch.bfloat16):
                src = randn(rng, (n, H), dtype)
                got = md.row_gather(src, idx)
                torch.cuda.synchronize()
                want = md.row_gather_plain(src, idx)
                err = (got.float() - want.float()).abs().max().item()
                worst = max(worst, err)
                valid = int(((idx >= 0) & (idx < n)).sum())
                require(f"row_gather {label} {name} [{n},{H}] by "
                        f"{idx.numel()} ({valid} in range) "
                        f"{str(dtype).split('.')[-1]}: bitwise equal to "
                        f"plain (max_abs_err={err:.3e}, tol 0: a copy)",
                        torch.equal(_bits(got), _bits(want)))
                del src, got, want
    # the backward: a scatter-add of the cotangent rows; each token feeds
    # at most k = 2 slots, and two addends onto a zero row give the same
    # bits in either order, so the card's atomics match the plain
    # composition's autograd (index_select's backward) bitwise
    T, C, disp, _ = moe_routing(rng, MOE)
    src = randn(rng, (T, MOE["H"]), torch.float32)
    ct = randn(rng, (disp.numel(), MOE["H"]), torch.float32)
    s1 = src.clone().requires_grad_()
    (g_kernel,) = torch.autograd.grad(md.row_gather(s1, disp), s1, ct)
    s2 = src.clone().requires_grad_()
    (g_plain,) = torch.autograd.grad(md.row_gather_plain(s2, disp), s2, ct)
    torch.cuda.synchronize()
    require("row_gather backward (RowGatherFn) at the bench_moe dispatch: "
            "bitwise equal to the plain composition's autograd",
            torch.equal(_bits(g_kernel), _bits(g_plain)))
    return worst


# -- phase 3 -----------------------------------------------------------------

def build_bert(ht, models, B, S, L, dropout=0.1):
    """The BERT-base pretraining loss graph at batch B, seq S, L layers."""
    ph = ht.placeholder_op
    feeds = (ph("input_ids", (B, S), dtype=np.int32),
             ph("token_type_ids", (B, S), dtype=np.int32),
             ph("attention_mask", (B, S)),
             ph("mlm_labels", (B * S,), dtype=np.int32),
             ph("nsp_labels", (B,), dtype=np.int32))
    cfg = models.BertConfig(vocab_size=30522, hidden_size=768,
                            num_hidden_layers=L, num_attention_heads=12,
                            intermediate_size=3072,
                            max_position_embeddings=512, seq_len=S,
                            hidden_dropout_prob=dropout,
                            attention_probs_dropout_prob=dropout,
                            mlm_bucket_frac=0.25)
    return models.BertForPreTraining(cfg).loss(*feeds)


def zipf_tokens(rng, V, shape, s=1.05):
    """Token ids whose frequencies follow Zipf's law (exponent ``s``) over
    a vocabulary of ``V``, as a text's words do; the ranks are given to
    ids at random."""
    p = np.arange(1, V + 1, dtype=np.float64) ** -s
    return rng.permutation(V)[rng.choice(V, size=shape, p=p / p.sum())]


def bert_batch(rng, B, S, device):
    """A pretraining batch: Zipf-distributed tokens, lengths S/2..S with
    [PAD] (id 0) after each (a quarter of the ids), ~15% MLM positions."""
    V = 30522
    lengths = rng.integers(S // 2, S + 1, B)
    am = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    mlm = np.full(B * S, -1, np.int64)
    pos = (rng.random(B * S) < 0.15) & (am.reshape(-1) > 0)
    mlm[pos] = zipf_tokens(rng, V, pos.sum())
    arrays = {"input_ids": np.where(am > 0, zipf_tokens(rng, V, (B, S)), 0),
              "token_type_ids": (np.arange(S)[None, :]
                                 >= (lengths[:, None] // 2)).astype(np.int64),
              "attention_mask": am, "mlm_labels": mlm,
              "nsp_labels": rng.integers(0, 2, B)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


class RouteCount:
    """The launches of one flash kernel by one route
    (``flash_attention.route_launches``) behind the wrappers' ``launches``
    attribute, so that a path zeroes and reads them with the others."""

    def __init__(self, fa, kernel, route):
        self.counts, self.key = fa.route_launches, (kernel, route)

    @property
    def launches(self):
        return self.counts[self.key]

    @launches.setter
    def launches(self, n):
        self.counts[self.key] = n


# the routes a flash launch takes (flash_attention.flash_route): the wgmma
# forward, dQ and dK/dV kernels of the main paths, the mma.sync and
# plain-FMA kernels of the other shapes
ROUTES = {"flash_fwd_wgmma": ("fwd", "wgmma"),
          "flash_bwd_dq_wgmma": ("dq", "wgmma"),
          "flash_bwd_dkv_wgmma": ("dkv", "wgmma"),
          "flash_fwd_mma": ("fwd", "mma"), "flash_fwd_simt": ("fwd", "simt"),
          "flash_bwd_dq_mma": ("dq", "mma"),
          "flash_bwd_dq_simt": ("dq", "simt"),
          "flash_bwd_dkv_mma": ("dkv", "mma"),
          "flash_bwd_dkv_simt": ("dkv", "simt")}


def counters(fa, ce, sd, md):
    """The launch counters of the paths' kernels and of the flash routes."""
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "flash_attention_block_fwd": fa.flash_attention_block,
            "flash_attention_block_bwd_dq": fa.flash_attention_block_bwd_dq,
            "flash_attention_block_bwd_dkv":
                fa.flash_attention_block_bwd_dkv,
            "softmax_ce_fwd": ce.softmax_ce_fwd,
            "softmax_ce_bwd": ce.softmax_ce_bwd,
            "pack_write": sd.pack_write_kernel,
            "row_gather": md.row_gather_kernel,
            **{name: RouteCount(fa, *key) for name, key in ROUTES.items()}}


# the kernels of the {"kernels": [...]} line: the ten of the TPU kernels'
# entry points, then the three wgmma kernels of this port
KERNEL_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
                "flash_attention_bwd_dkv", "flash_attention_block_fwd",
                "flash_attention_block_bwd_dq",
                "flash_attention_block_bwd_dkv", "softmax_ce_fwd",
                "softmax_ce_bwd", "pack_write", "row_gather",
                "flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                "flash_bwd_dkv_wgmma")
COUNTER_NAMES = KERNEL_NAMES + tuple(n for n in ROUTES
                                     if n not in KERNEL_NAMES)


def expect_launches(**per_run):
    """Expected launches of every counter: the named ones, 0 for the rest."""
    return {name: per_run.get(name, 0) for name in COUNTER_NAMES}


def flash_launches(n, block=False, bwd=True, routes=WGMMA):
    """Counts of ``n`` launches of the flash forward (and, with ``bwd``, of
    dQ and dK/dV) through the self-attention or the blockwise entry points,
    each on its route of ``routes`` (as ``WGMMA``): keywords for
    ``expect_launches``."""
    pre = "flash_attention_block" if block else "flash_attention"
    out = {f"{pre}_fwd": n, f"flash_fwd_{routes['fwd']}": n}
    if bwd:
        out.update({f"{pre}_bwd_dq": n, f"flash_bwd_dq_{routes['dq']}": n,
                    f"{pre}_bwd_dkv": n,
                    f"flash_bwd_dkv_{routes['dkv']}": n})
    return out


def timed_window(step, fns, steps):
    """``steps`` back-to-back steps timed by CUDA events, the launch
    counters zeroed just before and read just after: (losses, ms over the
    window, launches)."""
    for fn in fns.values():
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step() for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    return (losses, start.elapsed_time(end),
            {name: fn.launches for name, fn in fns.items()})


def report_path(label, losses, ms, launches, expect, steps, B, unit, peak,
                resident):
    """Log a path's timed steps (``ms`` a step, ``peak`` and ``resident``
    bytes) and check its losses finite and its launches as expected."""
    log(f"{label}: {ms:.3f} ms/step, {1000.0 / ms:.2f} steps/s, "
        f"{B * 1000.0 / ms:.1f} {unit}/s, peak memory {peak / 2**30:.2f} "
        f"GiB (resident between steps {resident / 2**30:.2f} GiB), "
        f"launches {launches} over {steps} steps")
    log(f"{label}: losses {' '.join(f'{v:.6f}' for v in losses)}")
    require(f"{label}: {len(losses)} losses finite",
            all(math.isfinite(v) for v in losses))
    require(f"{label}: launch counts {expect}", launches == expect)


def run_path(label, step, fns, steps, B, expect, warmup=3, unit="samples"):
    """``warmup`` steps, then ``steps`` timed steps with the launch counters
    zeroed just before and read just after; returns (losses of every step,
    ms/step, launches).  ``B`` counts the ``unit``s of a step."""
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    timed, ms, launches = timed_window(step, fns, steps)
    losses = [float(v) for v in losses + timed]
    ms /= steps
    report_path(label, losses, ms, launches, expect, steps, B, unit,
                torch.cuda.max_memory_allocated(), resident)
    return losses, ms, launches


# the CUDA functions of the counters checked against a trace
# (``traced_launches``): each flash route's kernel, and the other kernels
TRACED = {**{name: re.compile(rf"\b{name}\b") for name in ROUTES},
          "softmax_ce_fwd": re.compile(r"\b_ce_fwd_kernel\b"),
          "softmax_ce_bwd": re.compile(r"\b_ce_bwd_kernel\b"),
          "pack_write": re.compile(r"\bpack_write_kernel\b"),
          "row_gather": re.compile(r"\brow_gather_kernel\b")}


def traced_launches(kernels, counted):
    """The launches of each checked kernel in a trace's ``kernels`` beside
    the counters' ``counted`` over the same window: {name: (traced,
    counted)} for every kernel either saw.  The entry points' counters
    (``flash_attention_fwd`` and the block forward, dQ, dK/dV) launch the
    same CUDA functions, so each pair is held to the sum of its routes'
    kernels."""
    traced = {name: sum(e.count for e in kernels if pat.search(e.key))
              for name, pat in TRACED.items()}
    for part in ("fwd", "bwd_dq", "bwd_dkv"):
        traced[f"flash_attention_{part} + block"] = sum(
            traced[r] for r in ROUTES if r.startswith(f"flash_{part}_"))
        counted = dict(counted, **{
            f"flash_attention_{part} + block":
                counted[f"flash_attention_{part}"]
                + counted[f"flash_attention_block_{part}"]})
    return {name: (n, counted.get(name, 0)) for name, n in traced.items()
            if n or counted.get(name, 0)}


# the record_function ranges of the serving engine (no kernel time)
RANGES = ("serve_prefill", "serve_decode")


def profile_steps(label, step, steps=2, top=12, fns=None, cpu=True):
    """Where a path's step time goes: device time by kernel under
    torch.profiler (the kernels of a replayed CUDA graph each show), and
    the device's idle share of the traced window.  The busy time (the
    union of the device records' intervals: on Hopper a kernel may start
    before the one ahead of it ends, so their summed times can exceed
    the window) and the window (from the start of its first record to
    the end of its last) are read off the trace's one clock; CUDA events
    take the window's wall time beside it.  A window in which the
    profiler recorded no device time (it now and then drops a window's
    device records) is traced again, up to 3 times, and logged.  Returns
    {"wall_ms", "busy_ms", "idle", "launches"} a step (None if no window
    recorded any), and with the launch counters ``fns`` (zeroed just
    before the window, read just after) "kernels": ``traced_launches`` of
    the window; ``top=0`` logs the totals only; ``cpu=False`` traces the
    card's activity only, so that the host's own work is not slowed by
    tracing."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(3):
        torch.cuda.synchronize()
        for fn in (fns or {}).values():
            fn.launches = 0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU] * cpu
                     + [ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(steps):
                step()
            end.record()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name not in RANGES]
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in device)
        busy_us, reach = 0.0, float("-inf")
        for lo, hi in spans:
            busy_us += max(0.0, hi - max(lo, reach))
            reach = max(reach, hi)
        if busy_us > 0:
            break
        log(f"profile {label}: the profiler saw no device time; traced "
            f"again ({attempt + 1} of 3)")
    else:
        return None
    wall_us = start.elapsed_time(end) * 1e3
    window_us = reach - spans[0][0]
    summed_us = sum(hi - lo for lo, hi in spans)
    # busy time counts kernels, copies and fills: a range (a
    # record_function annotation) counted with them would fill its whole
    # span and hide the idle time
    ranges = sorted({e.name for e in device if e.is_user_annotation})
    require(f"profile {label}: the busy time ({busy_us:.1f} us of a "
            f"{window_us:.1f} us window; the records' times sum to "
            f"{summed_us:.1f}) counts no annotated range"
            + (f" (counts {ranges})" if ranges else ""), not ranges)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in RANGES]
    out = {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy_us / steps / 1e3,
           "idle": 1 - busy_us / window_us,
           "launches": sum(e.count for e in kernels) // steps}
    if fns:
        out["kernels"] = traced_launches(
            kernels, {name: fn.launches for name, fn in fns.items()})
    log(f"profile {label}: {steps} steps, {out['wall_ms']:.3f} "
        f"ms/step wall (traced, CUDA events; {window_us / steps / 1e3:.3f} "
        f"from the first record to the last), device busy "
        f"{out['busy_ms']:.3f} ms/step, "
        f"idle share {out['idle']:.3f}, "
        f"{out['launches']} kernel launches/step"
        + (f", kernels (traced, counted) {out['kernels']}" if fns else ""))
    if not top:
        return out
    # kernel classes by name: the seven kernels, the id sort, cuDNN's
    # convolution kernels (its FFT algorithm's complex products among
    # them), cuBLAS GEMMs (on ResNet also cuDNN's GEMM-based
    # convolutions), reductions (layer-norm and batch-norm moments, means,
    # sums), copies and casts, other elementwise
    # (the block kernels are the same CUDA functions as the flash ones)
    classes = (("pack_write", ("pack_write_kernel",)),
               ("row_gather", ("row_gather_kernel",)),
               ("sort (cub radix)", ("Radix", "radix")),
               ("flash fwd (+ block)", ("flash_fwd",)),
               ("flash dQ (+ block)", ("flash_bwd_dq",)),
               ("flash dK/dV (+ block)", ("flash_bwd_dkv",)),
               ("softmax_ce_fwd", ("_ce_fwd_kernel",)),
               ("softmax_ce_bwd", ("_ce_bwd_kernel",)),
               ("conv wgrad", ("wgrad",)),
               ("conv dgrad", ("dgrad",)),
               ("conv fwd", ("fprop", "convolve", "conv2d", "winograd")),
               ("conv fft (+ its complex gemm)", ("fft2d", "cf32")),
               ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
               ("reduce", ("reduce_kernel",)),
               ("copy/cast", ("copy_kernel",)),
               ("elementwise", ("elementwise",)))
    by_class = {}
    for e in kernels:
        cls = next((c for c, keys in classes
                    if any(k in e.key for k in keys)), "other")
        ms, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (ms + e.self_device_time_total / steps / 1e3,
                         n + e.count // steps)
    for cls, (ms, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        log(f"  class {cls}: {ms:.3f} ms/step, {n} launches/step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"{e.self_device_time_total / busy_us:6.1%} x{e.count // steps:<4d}"
            f" {e.key.replace('void at::native::', '')[:140]}")
    return out


def _np_bits(a):
    a = np.ascontiguousarray(a)
    return a.view(f"u{a.itemsize}")


def checkpoint_tensors(ex):
    """The tensors of ``ex``'s checkpoint: params, then each optimizer's
    step and slots."""
    out = list(ex.params.values())
    for st in ex.opt_state.values():
        out.append(st["step"])
        out += [t for slots in st["slots"].values() for t in slots.values()]
    return out


def checkpoint_diff(ex, ck):
    """The entries of ``ex``'s state that differ in bits from ``ck``, a
    ``state_dict()`` of the same executor: every param, each optimizer's
    step and slots (read to the host one at a time), the generator state
    and the step count; [] when the checkpoint ``ex`` would write equals
    ``ck``."""
    bad = []
    pairs = [(("param", k), v, ck["params"][k]) for k, v in ex.params.items()]
    for name, st in ex.opt_state.items():
        sv = ck["opt_state"][name]
        pairs.append((("step", name), st["step"], sv["step"]))
        pairs += [(("slot", var, k), t, sv["slots"][var][k])
                  for var, slots in st["slots"].items()
                  for k, t in slots.items()]
    for key, t, want in pairs:
        got = t.detach().float() if t.dtype == torch.bfloat16 else t.detach()
        got = got.cpu().numpy()
        if got.shape != want.shape or not np.array_equal(_np_bits(got),
                                                         _np_bits(want)):
            bad.append(key)
    if not np.array_equal(ex.generator.get_state().numpy(),
                          ck["generator_state"]):
        bad.append("generator_state")
    if ex._global_step != ck["global_step"]:
        bad.append("global_step")
    return bad


def _same_bits(xs, ys):
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        for x, y in zip(xs, ys))


def capture_phase(ht, label, ex, name, feed, fns, n=5, rs=20, turn=5,
                  kernels=True):
    """Phase 3f on one path's executor: its step captured in a CUDA graph
    against the same step run eagerly (``disable_capture()``).  (1) ``n``
    eager and ``n`` captured steps from the same state: the losses and the
    checkpoint after them bitwise equal, generator state included; (2)
    ``run_steps(rs)`` against ``rs`` ``run()`` calls from the same state:
    the last loss and the checkpoint bitwise equal; (3) eager and captured
    ms/step in alternating turns of ``turn`` steps (eager, captured,
    captured, eager, twice), CUDA events; peak memory (eager: the most
    allocated; captured: the most allocated plus the graph pool the
    capture reserved), and traced windows of each in turns: busy time,
    idle share, launches, and each hand-written kernel's launches in the
    trace against the launch counters ``fns`` over the window (a replay
    adds the counts its capture took: the trace shows that the graph
    launched those kernels; with ``kernels=False``, a path that launches
    none, each window must show none and count none).  Returns the
    summary."""
    sub = ex.subexecutor[name]
    run = lambda: ex.run(name, feed_dict=feed)[0]  # noqa: E731
    torch.cuda.synchronize()
    start = ex.state_dict()
    with ht.disable_capture():
        eager = [run() for _ in range(n)]
    ck = ex.state_dict()
    ex.load_state_dict(start)
    captured = [run() for _ in range(n)]
    torch.cuda.synchronize()
    diff = checkpoint_diff(ex, ck)
    worst = max(abs(float(a) - float(b)) for a, b in zip(eager, captured))
    same = _same_bits(eager, captured) and not diff
    require(f"{label}: {n} captured steps against {n} eager steps from the "
            "same state, bitwise: losses (largest |diff| "
            f"{worst:.3e}) and the checkpoint after them, params, optimizer "
            "state, generator state and step count"
            + (f" (differ: {diff[:6]}, {len(diff)} in all)" if diff else ""),
            same)
    del ck
    ex.load_state_dict(start)
    last = [run() for _ in range(rs)][-1]
    ck = ex.state_dict()
    ex.load_state_dict(start)
    del start
    last_rs = ex.run_steps(name, feed, rs)[0]
    torch.cuda.synchronize()
    diff_rs = checkpoint_diff(ex, ck)
    same_rs = _same_bits([last], [last_rs]) and not diff_rs
    require(f"{label}: run_steps({rs}) against {rs} run() calls from the "
            "same state, bitwise: the last loss and the checkpoint"
            + (f" (differ: {diff_rs[:6]})" if diff_rs else ""), same_rs)
    del ck
    modes = {m: {"turns": [], "peak": 0} for m in ("eager", "captured")}
    for mode in ("eager", "captured", "captured", "eager") * 2:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with (ht.disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            _, ms, _ = timed_window(run, {}, turn)
        m = modes[mode]
        m["turns"].append(ms / turn)
        m["peak"] = max(m["peak"], torch.cuda.max_memory_allocated())
    pool = sum(s.graph_bytes for s in ex.subexecutor.values())
    modes["captured"]["peak"] += pool
    # traced windows of ~200 ms of captured steps (a sub-ms step's trace
    # is mostly the profiler's own start and stop), in turns (eager,
    # captured, captured, eager); a window with under 90% of the most
    # launches seen, or whose kernels' traced launches differ from the
    # counted ones, is traced again, up to 3 times: the profiler now and
    # then drops a window's device records (a third of them, once)
    n_prof = max(1, min(20, round(200 / min(modes["captured"]["turns"]))))
    traces, most, unmatched = {"eager": [], "captured": []}, 0, []
    for mode in ("eager", "captured", "captured", "eager"):
        for attempt in range(3):
            with (ht.disable_capture() if mode == "eager"
                  else contextlib.nullcontext()):
                t = profile_steps(f"{label} {mode}", run, steps=n_prof,
                                  top=0, fns=fns)
            bad = {k: v for k, v in (t or {}).get("kernels", {}).items()
                   if v[0] != v[1]}
            if t and t["launches"] >= 0.9 * most and not bad:
                break
            log(f"capture {label}: a traced {mode} window shows "
                f"{t and t['launches']} launches a step of {most}, kernels "
                f"(traced, counted) differing: {bad}; traced again "
                f"({attempt + 1} of 3)")
        if t is None or bad or bool(t["kernels"]) != kernels:
            unmatched.append((mode, bad if t else "no trace"))
        if t:
            most = max(most, t["launches"])
            traces[mode].append(t)
    require(f"{label}: each traced window's launches of the hand-written "
            "kernels equal the launch counters over it (eager and captured "
            "windows, 2 each" + ("" if kernels else "; none of either")
            + ")" + (f" (not: {unmatched})" if unmatched else ""),
            not unmatched)
    for mode, ts in traces.items():
        ts = [t for t in ts if t["launches"] >= 0.9 * most]
        if ts:
            modes[mode].update({k: sum(t[k] for t in ts) / len(ts)
                                for k in ("busy_ms", "idle", "wall_ms")},
                               launches=ts[0]["launches"],
                               kernels=ts[0]["kernels"],
                               busy_turns=[t["busy_ms"] for t in ts])
    out = {"path": label, "bitwise": same, "run_steps_bitwise": same_rs,
           "graph_pool_gib": pool / 2**30, "signatures": len(sub._sigs)}
    for mode, m in modes.items():
        out[mode] = {"ms_per_step": sum(m["turns"]) / len(m["turns"]),
                     "turns_ms": m["turns"], "peak_gib": m["peak"] / 2**30,
                     **{k: m[k] for k in ("busy_ms", "busy_turns", "idle",
                                          "wall_ms", "launches", "kernels")
                        if k in m}}
    e, c = out["eager"], out["captured"]
    log(f"capture {label}: eager {e['ms_per_step']:.3f} ms/step, captured "
        f"{c['ms_per_step']:.3f} (turns of {turn}: eager "
        + " ".join(f"{t:.3f}" for t in e["turns_ms"]) + ", captured "
        + " ".join(f"{t:.3f}" for t in c["turns_ms"])
        + f"); busy {e.get('busy_ms', 0):.3f} / {c.get('busy_ms', 0):.3f} "
        f"ms, traced wall (CUDA events) {e.get('wall_ms', 0):.3f} / "
        f"{c.get('wall_ms', 0):.3f} ms, idle {e.get('idle', 0):.3f} / "
        f"{c.get('idle', 0):.3f}, "
        f"launches {e.get('launches')} / {c.get('launches')} a step (busy "
        f"in turns: eager {e.get('busy_turns')}, captured "
        f"{c.get('busy_turns')}); peak "
        f"{e['peak_gib']:.2f} / {c['peak_gib']:.2f} GiB (graph pool "
        f"{pool / 2**30:.2f} GiB)")
    if "busy_ms" in e and "busy_ms" in c:
        log(f"capture {label}: captured busy time / eager "
            f"{c['busy_ms'] / e['busy_ms']:.4f}")
    return out


def capture_negative_check(ht):
    """Phase 3f: a step that reads a tensor on the host runs eagerly on
    its first call and raises ``CaptureError`` naming the op on the next
    (the capture), never running eagerly by itself; under
    ``disable_capture()`` it runs."""
    class HostRead(ht.Op):
        def _compute(self, input_vals, ctx):
            (x,) = input_vals
            return x * float(x.sum())  # a host read inside the step

    x = ht.placeholder_op("host_read_x", (4, 4))
    ex = ht.Executor([HostRead(x, name="host_read_op")], device="cuda")
    feed = {x: torch.ones(4, 4, device="cuda")}
    first = ex.run(feed)[0]
    try:
        ex.run(feed)
        raised = "no error"
    except ht.CaptureError as e:
        raised = str(e)
    log(f"capture of a host read: {raised[:300]}")
    with ht.disable_capture():
        again = ex.run(feed)[0]
    require("a step that reads a tensor on the host raises CaptureError "
            "naming the op when captured, and runs under disable_capture()",
            "host_read_op" in raised and torch.equal(again, first))
    ex.close()
    free_memory("after the capture negative check")


def backward_ms(f, inputs, cotangent):
    """The backward alone of the library call ``f(*inputs)`` (the
    gradients of every input), its forward run once before the capture:
    ``graph_ms``."""
    def forward():
        xs = [t.detach().requires_grad_() for t in inputs]
        return f(*xs), xs
    return graph_ms(lambda fx: torch.autograd.grad(
        fx[0], fx[1], cotangent, retain_graph=True), prep=forward)


def yardstick_floor(name, ms, ops):
    """A library call's ``graph_ms`` reading below the least time of its
    bf16 products would mean that some of its kernels ran outside the
    captured graph."""
    least = ops / PEAK_OPS[torch.bfloat16] * 1e3
    require(f"{name} {ms:.4f} ms is no less than its products' least time "
            f"{least:.4f} ms (every kernel inside the graph)", ms >= least)


def kernel_times(rng, fa, ce, B, S):
    """Each kernel at the paths' shapes: ms, bound, plain ms, library ms
    (kernels and library calls each captured in a CUDA graph,
    ``graph_ms``: back-to-back events timed an sdpa backward's host, and
    the profiler's device time, ``device_ms``, dropped kernels of these
    calls); BERT's dQ and dK/dV also at keep 1, like for like with sdpa's
    backward."""
    H, D = 12, 64
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(B, H, S, D, device="cuda", dtype=bf)
                   for _ in range(4))
    mask = bert_mask(rng, B, S, "cuda")
    seed = seed_tensor(rng)
    n = q.numel()
    out = {}
    fwd = lambda keep: fa.flash_attention_fwd(  # noqa: E731
        q, k, v, mask=mask, dropout_keep=keep, seed=seed)
    t_fwd = graph_ms(lambda: fwd(0.9))
    t_fwd_eval = graph_ms(lambda: fwd(1.0))
    t_plain = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, mask=mask, dropout_keep=0.9, seed=seed), 3)
    mask_bf16 = mask.to(bf)
    t_lib = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_bf16))
    out["flash_attention_fwd"] = dict(
        ms=t_fwd, plain_ms=t_plain, library_ms=t_lib,
        bound=bound(4 * n * 2 + mask.numel() * 4 + B * H * S * 4,
                    4 * B * H * S * S * D, bf))
    log(f"kernel flash_attention_fwd [64,12,512,64] bf16: keep 0.9 "
        f"{t_fwd:.4f} ms, keep 1.0 {t_fwd_eval:.4f} ms")

    bwd = {}  # keep -> (dQ ms, dK/dV ms)
    for keep in (0.9, 1.0):
        o, lse = fwd(keep)
        dsum = (do.float() * o.float()).sum(-1)
        kw = dict(mask=mask, dropout_keep=keep, seed=seed)
        bwd[keep] = (
            graph_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, dsum, **kw)),
            graph_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, dsum, **kw)))
    log(f"kernel flash_attention_bwd [64,12,512,64] bf16: keep 0.9 dQ "
        f"{bwd[0.9][0]:.4f} ms, dK/dV {bwd[0.9][1]:.4f} ms; keep 1.0 dQ "
        f"{bwd[1.0][0]:.4f} ms, dK/dV {bwd[1.0][1]:.4f} ms (like for like "
        "with scaled_dot_product_attention's backward, which drops nothing)")
    t_dq, t_dkv = bwd[0.9]
    o, lse = fwd(0.9)
    dsum = (do.float() * o.float()).sum(-1)
    t_bwd_plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, mask=mask, dropout_keep=0.9, seed=seed), 3)
    t_bwd_lib = backward_ms(lambda *x: F.scaled_dot_product_attention(
        *x, attn_mask=mask_bf16), (q, k, v), do)
    # the forward's two products; the backward's five (QK^T again, dO V^T,
    # P^T dO, dS K, dS^T Q)
    yardstick_floor(f"sdpa [{B},{H},{S},{D}]", t_lib, 4 * B * H * S * S * D)
    yardstick_floor(f"sdpa backward [{B},{H},{S},{D}]", t_bwd_lib,
                    10 * B * H * S * S * D)
    small = B * H * S * 4 * 2 + mask.numel() * 4  # lse, D, mask
    out["flash_attention_bwd_dq"] = dict(
        ms=t_dq, plain_ms=t_bwd_plain, library_ms=t_bwd_lib,
        bound=bound(5 * n * 2 + small, 6 * B * H * S * S * D, bf))
    out["flash_attention_bwd_dkv"] = dict(
        ms=t_dkv, plain_ms=t_bwd_plain, library_ms=t_bwd_lib,
        bound=bound(6 * n * 2 + small, 8 * B * H * S * S * D, bf))
    del q, k, v, do, o, lse, dsum

    out.update(ce_times(rng, ce, B * S // 4, 30522, sweep=True))
    library = {"flash_attention_fwd": "scaled_dot_product_attention",
               "flash_attention_bwd_dq": "scaled_dot_product_attention "
                                         "backward (dq, dk, dv; no dropout)",
               "flash_attention_bwd_dkv": "scaled_dot_product_attention "
                                          "backward (dq, dk, dv; no dropout)"}
    for name, lib in library.items():
        r = out[name]
        log(f"kernel {name} [64,12,512,64] bf16 keep 0.9: {r['ms']:.4f} ms, "
            f"bound {r['bound'][0]:.4f} ms ({r['bound'][1]}), plain "
            f"{r['plain_ms']:.4f} ms, {lib} {r['library_ms']:.4f} ms")
    return out


def ce_times(rng, ce, N, V, sweep=False):
    """The CE forward and backward kernels at [N, V] bf16 (~15% ignored
    rows): ms, bound (one read of the logits, and one write of dx for the
    backward), plain ms and ``cross_entropy`` and its backward as the
    yardstick (each captured in a CUDA graph, ``graph_ms``); with
    ``sweep``, also the forward's launch sweep."""
    bf = torch.bfloat16
    out = {}
    logits = torch.randn(N, V, device="cuda", dtype=bf) * 3
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).cuda()
    labels[torch.from_numpy(rng.random(N) < 0.15).cuda()] = -1
    labels64 = labels.long()
    g = torch.randn(N, device="cuda")
    t_ce = graph_ms(lambda: ce.softmax_ce_fwd(logits, labels))
    t_ce_plain = time_ms(lambda: ce.softmax_ce_plain(logits, labels), 5)
    t_ce_lib = graph_ms(lambda: F.cross_entropy(
        logits, labels64, reduction="none", ignore_index=-1))
    out["softmax_ce_fwd"] = dict(
        ms=t_ce, plain_ms=t_ce_plain, library_ms=t_ce_lib,
        # max, subtract, exp, add per element (f32 vector)
        bound=bound(logits.numel() * 2 + N * 4 + 2 * N * 4, 4 * N * V,
                    torch.float32))
    if sweep:
        ce_sweep(ce, logits, labels, out["softmax_ce_fwd"]["bound"][0], t_ce)
    _, lse = ce.softmax_ce_fwd(logits, labels)
    t_ceb = graph_ms(lambda: ce.softmax_ce_bwd(logits, labels, lse, g))
    t_ceb_plain = time_ms(lambda: ce.softmax_ce_bwd_plain(
        logits, labels, lse, g), 5)
    t_ceb_lib = backward_ms(lambda x: F.cross_entropy(
        x, labels64, reduction="none", ignore_index=-1), (logits,), g)
    out["softmax_ce_bwd"] = dict(
        ms=t_ceb, plain_ms=t_ceb_plain, library_ms=t_ceb_lib,
        # subtract, exp, subtract, multiply per element (f32 vector)
        bound=bound(2 * logits.numel() * 2 + 3 * N * 4, 4 * N * V,
                    torch.float32))
    del logits
    for name, lib in (("softmax_ce_fwd", "cross_entropy"),
                      ("softmax_ce_bwd", "cross_entropy backward")):
        r = out[name]
        log(f"kernel {name} [{N},{V}] bf16: {r['ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), "
            f"{r['bound'][0] / r['ms']:.1%} of it, plain "
            f"{r['plain_ms']:.4f} ms, {lib} {r['library_ms']:.4f} ms")
    return out


def ce_sweep(ce, logits, labels, bound_ms, t_fixed):
    """The CE forward's launch parameters at the BERT MLM bucket: each
    (rows a program, chunk width, warps, pipeline stages) whose per-lane
    state fits 64 elements a thread, timed back to back with CUDA events
    and checked against the fixed launch's loss; logs each beside its
    share of the bound, and the fastest.  The module fixes its launch
    (``softmax_ce._FWD``) from this sweep."""
    want, _ = ce.softmax_ce_fwd(logits, labels)
    best = None
    for rows in (1, 2):
        for block_v in (2048, 4096, 8192):
            for warps in (4, 8, 16):
                if rows * block_v > 64 * 32 * warps or block_v < 32 * warps:
                    continue
                for stages in (1, 3):
                    cfg = dict(rows=rows, block_v=block_v, num_warps=warps,
                               num_stages=stages)
                    loss, _ = ce.launch_fwd(logits, labels, -1, **cfg)
                    t = time_ms(lambda: ce.launch_fwd(logits, labels, -1,
                                                      **cfg), 20)
                    err = (loss - want).abs().max().item()
                    log(f"ce sweep {cfg}: {t:.4f} ms, {bound_ms / t:.1%} of "
                        f"its bound, max |loss - fixed launch's| {err:.2e}")
                    require(f"ce sweep {cfg}: loss within 2e-4 of the fixed "
                            "launch's (f32 sums in another order)",
                            err <= 2e-4)
                    if best is None or t < best[0]:
                        best = (t, cfg)
    log(f"ce sweep: fastest {best[1]} {best[0]:.4f} ms; the module's launch "
        f"{ce._FWD} {t_fixed:.4f} ms, {bound_ms / t_fixed:.1%} of its bound "
        f"{bound_ms:.4f} ms")


def causal_flash_times(rng, fa, B, H, S, D, keep, routes):
    """The flash forward, dQ and dK/dV kernels at a causal [B,H,S,D] bf16
    shape and dropout keep, each on its route of ``routes`` ({"fwd": ...,
    "dq": ..., "dkv": ...}): ms, bound (the causal (row, key) pairs'
    products, or the bytes; dropout adds neither), plain ms (at the same
    keep) and scaled_dot_product_attention (causal, no dropout) and its
    backward as the yardstick (each captured in a CUDA graph,
    ``graph_ms``).  Returns {"flash_fwd_<route>", "flash_bwd_dq_<route>",
    "flash_bwd_dkv_<route>": {...}}."""
    bf = torch.bfloat16
    got = {kern: fa.flash_route(kern, bf, D, S, S) for kern in routes}
    require(f"timed flash kernels at [{B},{H},{S},{D}] bf16 take the routes "
            f"{routes} ({got})", got == routes)
    q, k, v, do = (torch.randn(B, H, S, D, device="cuda", dtype=bf)
                   for _ in range(4))
    kw = dict(causal=True, dropout_keep=keep,
              seed=seed_tensor(rng) if keep < 1.0 else None)
    n, pairs = q.numel(), B * H * S * (S + 1) // 2
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    t_bwd_plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), 3)
    dsum = (do.float() * o.float()).sum(-1)
    t_lib = graph_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    t_bwd_lib = backward_ms(lambda *x: F.scaled_dot_product_attention(
        *x, is_causal=True), (q, k, v), do)
    yardstick_floor(f"sdpa causal [{B},{H},{S},{D}]", t_lib, 4 * pairs * D)
    yardstick_floor(f"sdpa causal backward [{B},{H},{S},{D}]", t_bwd_lib,
                    10 * pairs * D)
    out = {
        f"flash_fwd_{routes['fwd']}": dict(
            ms=graph_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw)),
            plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                             3),
            library_ms=t_lib,
            bound=bound(4 * n * 2 + B * H * S * 4, 4 * pairs * D, bf)),
        f"flash_bwd_dq_{routes['dq']}": dict(
            ms=graph_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, dsum, **kw)),
            plain_ms=t_bwd_plain, library_ms=t_bwd_lib,
            bound=bound(5 * n * 2 + 2 * B * H * S * 4, 6 * pairs * D, bf)),
        f"flash_bwd_dkv_{routes['dkv']}": dict(
            ms=graph_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, dsum, **kw)),
            plain_ms=t_bwd_plain, library_ms=t_bwd_lib,
            bound=bound(6 * n * 2 + 2 * B * H * S * 4, 8 * pairs * D, bf))}
    for name, r in out.items():
        log(f"kernel {name} [{B},{H},{S},{D}] bf16 causal keep {keep}: "
            f"{r['ms']:.4f} ms, bound {r['bound'][0]:.4f} ms "
            f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.1%} of it, plain "
            f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention"
            f"{'' if 'fwd' in name else ' backward'} (causal, no dropout) "
            f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x)")
    fwd, dq, dkv = (r["ms"] for r in out.values())
    log(f"kernel flash {'/'.join(routes.values())} [{B},{H},{S},{D}] causal "
        f"keep {keep}: dQ + dK/dV {dq + dkv:.4f} ms against "
        f"scaled_dot_product_attention's "
        f"backward {t_bwd_lib:.4f} ms ({(dq + dkv) / t_bwd_lib:.2f}x); "
        f"forward {fwd / t_lib:.2f}x")
    return out


def cross_device(ht, models, rng, seed):
    """One f32 training step of BERT (batch 2, 2 layers, full widths,
    dropout off) from the same params on the card and on the CPU."""
    S = 512
    loss = build_bert(ht, models, 2, S, 2, dropout=0.0)
    xs = ht.graph_variables([loss], trainable_only=True)
    grads = ht.gradients(loss, xs)
    opt = ht.AdamWOptimizer(learning_rate=1e-4, weight_decay=0.01)
    train_op = opt.apply_gradients(list(zip(grads, xs)))
    nodes = {"train": [loss, train_op, *grads]}
    ex_gpu = ht.Executor(nodes, device="cuda", seed=seed + 1)
    ex_cpu = ht.Executor(nodes, device="cpu", seed=seed + 2)
    ex_cpu.load_state_dict(ex_gpu.state_dict())
    feed = bert_batch(rng, 2, S, "cpu")
    out_gpu = ex_gpu.run("train", feed_dict=feed)
    out_cpu = ex_cpu.run("train", feed_dict=feed)
    torch.cuda.synchronize()
    check("cross-device f32 BERT train loss (card kernels vs CPU plain)",
          out_gpu[0].cpu(), out_cpu[0], 1e-3,
          "f32 on both sides; attention, layer norm and the 30522-way "
          "logsumexp sum in another order")
    # atol scaled by the largest gradient of the model: the attention key
    # biases' gradient is zero in exact arithmetic (softmax ignores a
    # constant added to a row), so both sides hold only rounding noise
    scale = max(g.abs().max().item() for g in out_cpu[2:])
    worst, bad = (0.0, None), []
    for x, g_gpu, g_cpu in zip(xs, out_gpu[2:], out_cpu[2:]):
        diff = (g_gpu.cpu() - g_cpu).abs()
        err = diff.max().item()
        if err > worst[0]:
            worst = (err, x.name)
        if not (diff - 1e-3 * g_cpu.abs()).max().item() <= 1e-5 * scale:
            bad.append(x.name)
    log(f"check cross-device f32 gradients of {len(xs)} params: worst "
        f"max_abs_err={worst[0]:.3e} ({worst[1]}) tol=1e-5*{scale:.3e} + "
        "1e-3*|g| (f32 on both sides; sums over 1024 tokens, 512 keys and "
        "30522 classes in another order) "
        f"{'FAIL ' + str(bad) if bad else 'ok'}")
    if bad:
        failures.append("cross-device gradients")
    params_gpu = {k: v.cpu() for k, v in ex_gpu.params.items()}
    err = max((params_gpu[k].float() - v.float()).abs().max().item()
              for k, v in ex_cpu.params.items())
    require(f"cross-device params after one AdamW step: max_abs_err="
            f"{err:.3e} tol=2e-4 (2 lr: at step 1 the update is "
            "lr*g/(|g|+eps), whose sign flips where |g| is at noise level)",
            err <= 2e-4)


def build_ctr(ht, models, cls, rows):
    """A CTR model on the packed table at batch 128 (examples/ctr
    train_ctr.py ``build()``): returns (model, loss, logit, placeholders)."""
    ph = ht.placeholder_op
    feeds = (ph("dense", (CTR_BATCH, 13)),
             ph("sparse", (CTR_BATCH, 26), dtype=np.int32),
             ph("labels", (CTR_BATCH,)))
    model = cls(rows, embedding_dim=16, packed_embedding=True)
    return model, model.loss(*feeds), model(*feeds[:2]), feeds


def ctr_batch(rng, rows, feeds, device):
    """Dense features, uniform sparse ids and 0/1 labels, as bench_wdl
    draws them, keyed by placeholder."""
    arrays = (rng.standard_normal((CTR_BATCH, 13)).astype(np.float32),
              rng.integers(0, rows, (CTR_BATCH, 26)).astype(np.int32),
              rng.integers(0, 2, CTR_BATCH).astype(np.float32))
    return {p: torch.from_numpy(a).to(device) for p, a in zip(feeds, arrays)}


def ctr_executor(ht, models, cls, rng, rows, seed):
    """``Executor({"train": [loss, Adam(0.01).minimize(loss)], "predict":
    [logit]})`` on the card, its feeds on the card, and a step that
    returns the loss."""
    model, loss, logit, feeds = build_ctr(ht, models, cls, rows)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, ht.AdamOptimizer(0.01).minimize(loss)],
                      "predict": [logit]}, device="cuda", seed=seed)
    torch.cuda.synchronize()
    table = ex.params[model.emb.table.name]
    log(f"{cls.__name__} packed: {rows} rows -> table "
        f"{list(table.shape)} f32 ({table.numel() * 4 / 1e9:.2f} GB), "
        f"{sum(p.numel() for p in ex.params.values())} params, init "
        f"{time.perf_counter() - t0:.1f} s")
    feed = ctr_batch(rng, rows, feeds, "cuda")

    def step():
        val, none = ex.run("train", feed_dict=feed)
        if none is not None:
            raise RuntimeError("run('train') must return [loss, None]")
        return val
    return ex, feed, step


def ctr_paths(ht, models, fns, rng, steps, seed, captures):
    """Phase 3c: W&D packed at both table sizes (each with phase 3f's
    captured-against-eager checks, appended to ``captures``), then one
    step each of DeepFM, DCN and DLRM; returns {rows: (ms/step,
    launches)}."""
    out = {}
    for rows in (WDL_ROWS, CRITEO_ROWS):
        ex, feed, step = ctr_executor(ht, models, models.WDL, rng, rows, seed)
        label = f"wdl path {rows} rows"
        _, ms, launches = run_path(label, step, fns, steps, CTR_BATCH,
                                   expect_launches(pack_write=steps))
        out[rows] = ms, launches
        profile_steps(label, step, steps=2)
        captures.append(capture_phase(ht, label, ex, "train", feed, fns))
        # a step writes the params and the optimizer state in place:
        # checksums of each, before and after the predict runs (the first
        # eager, the second captured)
        sums = lambda: torch.stack(  # noqa: E731
            [t.double().sum() for t in checkpoint_tensors(ex)])
        before = sums()
        logits = [ex.run("predict", feed_dict=feed)[0] for _ in range(2)]
        torch.cuda.synchronize()
        require(f"{label}: predict gives {CTR_BATCH} finite logits, the "
                "same from its eager and its captured run, and changes no "
                "param nor optimizer state",
                all(tuple(lg.shape) == (CTR_BATCH,)
                    and bool(torch.isfinite(lg).all()) for lg in logits)
                and _same_bits(logits[:1], logits[1:])
                and torch.equal(before, sums()))
        ex.close()
        del ex, feed, step, logits
        free_memory(f"after the {label}")
    for cls in (models.DeepFM, models.DCN, models.DLRM):
        ex, _, step = ctr_executor(ht, models, cls, rng, WDL_ROWS, seed)
        for fn in fns.values():
            fn.launches = 0
        loss = float(step())
        launches = {name: fn.launches for name, fn in fns.items()}
        log(f"{cls.__name__} packed {WDL_ROWS} rows: one step, loss "
            f"{loss:.6f}, launches {launches}")
        require(f"{cls.__name__}: finite loss and 1 pack_write launch",
                math.isfinite(loss)
                and launches == expect_launches(pack_write=1))
        ex.close()
        del ex, step
    free_memory("after DeepFM, DCN and DLRM")
    return out


def checkpoint_roundtrip(ht, models, rng, seed):
    """W&D (337,000 rows) on the card: two steps, ``save`` to a temporary
    file, a fresh executor over a rebuilt graph (its optimizer named anew,
    its params from another seed) ``load``s it.  Its Adam step and moments
    and its CUDA generator state must equal the saved executor's, and one
    more step of each on the same batch gives the same loss (the same
    kernels on the same inputs on one card: rtol 1e-6, bitwise logged)."""
    ex, feed, step = ctr_executor(ht, models, models.WDL, rng, WDL_ROWS,
                                  seed)
    for _ in range(2):
        step()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wdl.ckpt")
        ex.save(path)
        size = os.path.getsize(path)
        fresh, _, _ = ctr_executor(ht, models, models.WDL, rng, WDL_ROWS,
                                   seed + 7)
        fresh.load(path)
    pairs = list(zip(ex.opt_state.values(), fresh.opt_state.values()))
    same_opt = len(pairs) == 1 and all(
        torch.equal(a["step"], b["step"])
        and all(torch.equal(a["slots"][v][k], b["slots"][v][k])
                for v in a["slots"] for k in a["slots"][v])
        for a, b in pairs)
    require(f"checkpoint round trip on the card ({size / 1e6:.1f} MB file): "
            f"Adam step ({int(pairs[0][1]['step'])}) and moments equal",
            same_opt)
    require("checkpoint round trip: the CUDA generator state and the step "
            "count equal",
            fresh.generator.device.type == "cuda"
            and torch.equal(ex.generator.get_state(),
                            fresh.generator.get_state())
            and fresh._global_step == ex._global_step)
    want = step()
    got = fresh.run("train", feed_dict={p.name: v for p, v in feed.items()})[0]
    torch.cuda.synchronize()
    err = abs(float(got) - float(want))
    same_params = all(torch.equal(ex.params[k], fresh.params[k])
                      for k in ex.params)
    require(f"checkpoint round trip: the resumed step's loss {float(got):.6f} "
            f"is finite and within 1e-6*|loss| of the saved executor's "
            f"next step ({float(want):.6f}; |diff| {err:.3e}, bitwise "
            f"{torch.equal(got, want)}, params after the step bitwise "
            f"{same_params}; the same kernels on the same inputs on one "
            "card)", math.isfinite(float(got))
            and err <= 1e-6 * abs(float(want)))
    ex.close()
    fresh.close()
    free_memory("after the checkpoint round trip")


def pack_write_times(rng, sd):
    """pack_write at the main path's M = 3328 for both tables, uniform ids:
    the kernel alone, the whole function (sort + zero fill + kernel) and
    its parts, the plain versions (``pack_write_ordered``, the kernel's
    order, and ``pack_write_plain``), and ``index_add_`` alone and after a
    zero fill.  Each is timed on the card's clock (``device_ms``; a launch
    here costs the host more than the kernel takes the card) and, for the
    whole calls, also back to back with CUDA events (the rate the host
    sustains).  Then the kernel and ``index_add_`` under Zipf ids at the
    337,000-row table, M = 3328 and 65,536, in turns.  Returns {rows:
    times} of the uniform case."""
    out = {}
    m = CTR_BATCH * 26
    for rows in (WDL_ROWS, CRITEO_ROWS):
        p_rows = sd.packed_rows(rows, 16)
        ids = torch.from_numpy(ctr_ids(rng, "uniform", m, p_rows)).cuda()
        lines = torch.randn(m, 128, device="cuda")
        ids_sorted, order = torch.sort(ids, stable=True)
        buf, pieces, counters = sd.kernel_buffers(m, p_rows, "cuda")
        ids64 = ids.long()
        unique = int(ids.unique().numel())
        calls = dict(
            ms=lambda: sd.pack_write_kernel(ids_sorted, order, lines, buf,
                                            pieces, counters),
            fn_ms=lambda: sd.pack_write(ids, lines, p_rows),
            sort_ms=lambda: torch.sort(ids, stable=True),
            zeros_ms=lambda: torch.zeros(p_rows, 128, device="cuda"),
            plain_ms=lambda: sd.pack_write_ordered(ids, lines, p_rows),
            scatter_ms=lambda: sd.pack_write_plain(ids, lines, p_rows),
            library_ms=lambda: buf.index_add_(0, ids64, lines),
            library_fn_ms=lambda: torch.zeros(
                p_rows, 128, device="cuda").index_add_(0, ids64, lines))
        t = {key: device_ms(fn, 20 if key == "plain_ms" else 100)
             for key, fn in calls.items()}
        events = {key: time_ms(calls[key], 50)
                  for key in ("ms", "fn_ms", "scatter_ms", "library_ms")}
        t.update(
            # read each id and line once, write each unique line once;
            # one f32 add per lane of each line
            bound=bound(m * (4 + 512) + unique * 512, m * 128,
                        torch.float32),
            fn_bound=bound(m * (4 + 512) + p_rows * 512, m * 128,
                           torch.float32))
        log(f"kernel pack_write M={m} p_rows={p_rows} ({unique} unique "
            f"lines), device time: kernel {t['ms']:.4f} ms, bound "
            f"{t['bound'][0]:.4f} ms ({t['bound'][1]}); whole function "
            f"{t['fn_ms']:.4f} ms (sort {t['sort_ms']:.4f}, zero fill "
            f"{t['zeros_ms']:.4f}), bound {t['fn_bound'][0]:.4f} ms; plain "
            f"(pack_write_ordered) {t['plain_ms']:.4f} ms, scatter-add "
            f"(pack_write_plain) {t['scatter_ms']:.4f} ms; index_add_ "
            f"{t['library_ms']:.4f} ms, zero fill + index_add_ "
            f"{t['library_fn_ms']:.4f} ms")
        log(f"kernel pack_write M={m} p_rows={p_rows}, back-to-back calls "
            f"(CUDA events): kernel {events['ms']:.4f} ms, whole function "
            f"{events['fn_ms']:.4f} ms, scatter-add "
            f"{events['scatter_ms']:.4f} ms, index_add_ "
            f"{events['library_ms']:.4f} ms")
        require(f"pack_write timings at p_rows={p_rows} saw device time",
                min(t[k] for k in calls) > 0)
        out[rows] = t
        del buf, pieces, counters
    # skew: a hot id's run spans many leaves of the summation tree
    p_rows = sd.packed_rows(WDL_ROWS, 16)
    for m in (3328, 65536):
        ids_np = ctr_ids(rng, "zipf", m, p_rows)
        ids = torch.from_numpy(ids_np).cuda()
        lines = torch.randn(m, 128, device="cuda")
        ids_sorted, order = torch.sort(ids, stable=True)
        buf, pieces, counters = sd.kernel_buffers(m, p_rows, "cuda")
        ids64 = ids.long()
        counts = np.bincount(ids_np, minlength=p_rows)
        unique = int((counts > 0).sum())
        kern = lambda: sd.pack_write_kernel(  # noqa: E731
            ids_sorted, order, lines, buf, pieces, counters)
        lib = lambda: buf.index_add_(0, ids64, lines)  # noqa: E731
        turns = {"kernel": [], "index_add_": []}
        for key in ("kernel", "index_add_", "index_add_", "kernel"):
            turns[key].append(device_ms(kern if key == "kernel" else lib))
        b = bound(m * (4 + 512) + unique * 512, m * 128, torch.float32)
        t_k, t_lib = min(turns["kernel"]), min(turns["index_add_"])
        log(f"kernel pack_write zipf s=1.05 M={m} p_rows={p_rows} ({unique} "
            f"unique lines, largest run {int(counts.max())}), device time in "
            f"turns kernel/index_add_/index_add_/kernel: kernel "
            f"{turns['kernel'][0]:.4f}, {turns['kernel'][1]:.4f} ms, "
            f"index_add_ {turns['index_add_'][0]:.4f}, "
            f"{turns['index_add_'][1]:.4f} ms; bound {b[0]:.4f} ms "
            f"({b[1]}); kernel/index_add_ {t_k / t_lib:.3f}")
        require(f"pack_write zipf M={m} timings saw device time",
                min(turns["kernel"] + turns["index_add_"]) > 0)
        del buf, pieces, counters
    torch.cuda.empty_cache()
    return out


def cross_device_ctr(ht, models, rng, seed):
    """One f32 W&D training step (packed table, 337,000 rows) from the same
    params on the card (pack_write kernel) and on the CPU (plain)."""
    model, loss, _, feeds = build_ctr(ht, models, models.WDL, WDL_ROWS)
    xs = ht.graph_variables([loss], trainable_only=True)
    grads = ht.gradients(loss, xs)
    train_op = ht.AdamOptimizer(0.01).apply_gradients(list(zip(grads, xs)))
    nodes = {"train": [loss, train_op, *grads]}
    ex_gpu = ht.Executor(nodes, device="cuda", seed=seed + 3)
    ex_cpu = ht.Executor(nodes, device="cpu", seed=seed + 4)
    ex_cpu.load_state_dict(ex_gpu.state_dict())
    # copies: a step writes the params in place
    init = {k: v.clone() for k, v in ex_cpu.params.items()}
    feed = ctr_batch(rng, WDL_ROWS, feeds, "cpu")
    out_gpu = ex_gpu.run("train", feed_dict=feed)
    out_cpu = ex_cpu.run("train", feed_dict=feed)
    torch.cuda.synchronize()
    check("cross-device f32 W&D train loss (card kernel vs CPU plain)",
          out_gpu[0].cpu(), out_cpu[0], 1e-5,
          "f32 on both sides; the 429-wide products and the mean over 128 "
          "sum in another order")
    scale = max(g.abs().max().item() for g in out_cpu[2:])
    bad = [x.name for x, g_gpu, g_cpu in zip(xs, out_gpu[2:], out_cpu[2:])
           if not ((g_gpu.cpu() - g_cpu).abs() - 1e-3 * g_cpu.abs()).max()
           .item() <= 1e-5 * scale]
    worst = max((g_gpu.cpu() - g_cpu).abs().max().item()
                for g_gpu, g_cpu in zip(out_gpu[2:], out_cpu[2:]))
    require(f"cross-device f32 W&D gradients of {len(xs)} params, the "
            f"packed table's among them: max_abs_err={worst:.3e} "
            f"tol=1e-5*{scale:.3e} + 1e-3*|g| (f32 on both sides; the "
            "products' sums run in another order) "
            f"{'bad: ' + str(bad) if bad else ''}", not bad)
    # Adam's first step moves an entry by lr*g/(|g|+eps), ~lr: compare each
    # param's change; untouched table lines have a zero gradient on both
    # sides and must not move at all
    errs = {}
    for name, before in init.items():
        change_cpu = ex_cpu.params[name] - before
        change_gpu = ex_gpu.params[name].cpu() - before
        errs[name] = ((change_gpu - change_cpu).norm()
                      / change_cpu.norm()).item()
    name = max(errs, key=errs.get)
    require(f"cross-device W&D params after one Adam step: worst change "
            f"error {errs[name]:.3e} ({name}) in the 2-norm, relative, "
            "tol 1e-4 (f32 update from gradients within the tolerance "
            "above)", errs[name] <= 1e-4)
    table = model.emb.table.name
    touched = torch.zeros(init[table].shape[0], dtype=torch.bool)
    touched[(feed[feeds[1]].reshape(-1).long() // 8)] = True
    require("cross-device W&D: untouched table lines unchanged on the card",
            torch.equal(ex_gpu.params[table].cpu()[~touched],
                        init[table][~touched]))


def build_moe(ht, layers, moe):
    """bench_moe's loss at the shapes of ``moe``: mse(moe(x), y) + 0.01
    aux; returns (loss, x, y)."""
    B, S, H = moe["B"], moe["S"], moe["H"]
    x = ht.placeholder_op("moe_x", (B, S, H))
    y = ht.placeholder_op("moe_y", (B, S, H))
    layer = layers.MoELayer(H, moe["F"], num_experts=moe["E"], k=moe["k"],
                            capacity_factor=moe["cf"],
                            expert_act=moe["act"])
    loss = ht.mse_loss_op(layer(x), y) + layer.aux_loss() * 0.01
    return loss, x, y


def moe_executor(ht, layers, rng, moe, seed):
    """``Executor({"train": [loss, Adam(1e-3).minimize(loss)]})`` on the
    card, bench_moe's feeds (x normal, y zeros) on the card, and a step
    that returns the loss: (ex, step, init seconds, feed)."""
    with ht.name_scope():
        loss, x, y = build_moe(ht, layers, moe)
        train_op = ht.AdamOptimizer(1e-3).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, device="cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = (moe["B"], moe["S"], moe["H"])
    feed = {x: randn(rng, shape, torch.float32),
            y: torch.zeros(shape, device="cuda")}

    def step():
        val, none = ex.run("train", feed_dict=feed)
        if none is not None:
            raise RuntimeError("run('train') must return [loss, None]")
        return val
    return ex, step, init_s, feed


def moe_paths(ht, layers, fns, rng, steps, seed, captures):
    """Phase 3d: bench_moe's training step at full size, its determinism,
    and the Mixtral-width layer, each with phase 3f's captured-against-
    eager checks (appended to ``captures``); returns (ms/step, launches)
    of bench_moe."""
    m = MOE
    tokens = m["B"] * m["S"]
    ex, step, init_s, feed = moe_executor(ht, layers, rng, m, seed)
    log(f"moe path: MoELayer({m['H']}, {m['F']}, {m['E']} experts, top-"
        f"{m['k']}, capacity {m['cf']}, {m['act']}) B={m['B']} S={m['S']} "
        f"f32, Adam(1e-3), {sum(p.numel() for p in ex.params.values())} "
        f"params, init {init_s:.1f} s")
    label = "moe path"
    _, ms, launches = run_path(
        label, step, fns, steps, tokens,
        expect_launches(row_gather=3 * steps), unit="tokens")
    log(f"moe path: moe_top2_8expert_train_tokens_per_sec "
        f"{tokens * 1000.0 / ms:.1f} ({ms:.3f} ms/step, "
        f"{launches['row_gather'] / steps:g} row_gather launches/step)")
    profile_steps(label, step, steps=1)
    captures.append(capture_phase(ht, label, ex, "train", feed, fns))
    ex.close()
    del ex, step, feed
    # the same 3 steps twice from the same params (the seed's init): the
    # losses and the params after them must be bitwise equal
    runs = []
    for _ in range(2):
        ex, step, _, _ = moe_executor(
            ht, layers, np.random.default_rng(seed + 5), m, seed)
        runs.append(([float(step()) for _ in range(3)],
                     {k: v.clone() for k, v in ex.params.items()}))
        ex.close()
        del ex, step
    (l1, p1), (l2, p2) = runs
    log(f"moe path determinism: losses {l1} and {l2}")
    require("moe path: 3 steps from the same params twice give bitwise "
            "equal losses and params",
            l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1))
    del runs, p1, p2
    free_memory("after the moe path")

    mx = MIXTRAL
    ex, step, init_s, feed = moe_executor(ht, layers, rng, mx, seed)
    log(f"mixtral moe layer: MoELayer({mx['H']}, {mx['F']}, {mx['E']} "
        f"experts, top-{mx['k']}, capacity {mx['cf']}, {mx['act']}) "
        f"B={mx['B']} S={mx['S']} f32, Adam(1e-3), "
        f"{sum(p.numel() for p in ex.params.values())} params, init "
        f"{init_s:.1f} s")
    run_path("mixtral moe layer", step, fns, 3, mx["B"] * mx["S"],
             expect_launches(row_gather=9), warmup=2, unit="tokens")
    captures.append(capture_phase(ht, "mixtral moe layer", ex, "train",
                                  feed, fns, n=3, turn=2))
    ex.close()
    del ex, step, feed
    free_memory("after the mixtral moe layer")
    return ms, launches


def l2_yardsticks(parts):
    """Whether a cold reading can beat a bytes bound: for each (read,
    written) byte count of ``parts``, a read-only pass (a sum) over the
    read bytes and a write-only pass (a fill) over the written ones, each
    timed as ``device_ms(cold=True)`` times a kernel, beside its bytes
    bound.  A read cannot beat HBM; stores that still sit in the 50 MB L2
    when the kernel ends can."""
    a = torch.randn(max(r for r, _ in parts) // 4, device="cuda")
    b = torch.empty(max(w for _, w in parts) // 4, device="cuda")
    tot = {"read": 0.0, "write": 0.0, "read_bound": 0.0, "write_bound": 0.0}
    for r, w in parts:
        ra, wb = a[:r // 4], b[:w // 4]
        t = {"read": device_ms(lambda: ra.sum(), 50, cold=True),
             "write": device_ms(lambda: wb.fill_(1.0), 50, cold=True),
             "read_bound": r / HBM_BYTES_PER_S * 1e3,
             "write_bound": w / HBM_BYTES_PER_S * 1e3}
        log(f"L2 yardsticks, L2 cold: a sum of {r / 1e6:.1f} MB "
            f"{t['read']:.4f} ms (bound {t['read_bound']:.4f}), a fill of "
            f"{w / 1e6:.1f} MB {t['write']:.4f} ms (bound "
            f"{t['write_bound']:.4f})")
        for k in tot:
            tot[k] += t[k]
    log(f"L2 yardsticks, the gathers' reads and writes summed: reads "
        f"{tot['read']:.4f} ms against {tot['read_bound']:.4f}, writes "
        f"{tot['write']:.4f} ms against {tot['write_bound']:.4f}: the "
        f"writes {'beat' if tot['write'] < tot['write_bound'] else 'do not beat'}"
        " their bound")
    del a, b


def row_gather_times(rng, md):
    """row_gather at the bench_moe path's three gathers (the dispatch, two
    combines) on the layer's routing: the kernel, the plain version and
    ``index_select`` of the clamped index (the library yardstick; it leaves
    out the zero fill), each on the card's clock (``device_ms``) with the
    L2 cache cold and warm, and back to back with CUDA events.  Returns the
    cold times, summed over one step's three launches."""
    T, C, disp, combs = moe_routing(rng, MOE)
    H, E = MOE["H"], MOE["E"]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0)
    gathers, parts = [], []
    for name, n, idx in (("dispatch", T, disp), ("combine 0", E * C,
                                                 combs[0]),
                         ("combine 1", E * C, combs[1])):
        src = torch.randn(n, H, device="cuda")
        m = idx.numel()
        in_range = idx[(idx >= 0) & (idx < n)]
        rows = int(torch.unique(in_range).numel())
        clamped = idx.clamp(0, n - 1)
        calls = dict(ms=lambda: md.row_gather_kernel(src, idx),
                     plain_ms=lambda: md.row_gather_plain(src, idx),
                     library_ms=lambda: src.index_select(0, clamped))
        t = {key: device_ms(fn, 50, cold=True) for key, fn in calls.items()}
        warm = {key: device_ms(fn) for key, fn in calls.items()}
        events = {key: time_ms(fn, 50) for key, fn in calls.items()}
        # read each source row that an in-range index names once (a token
        # in two slots is read once), write every output row once, read
        # the m int32 indices
        n_bytes = rows * H * 4 + m * H * 4 + m * 4
        parts.append((rows * H * 4 + m * 4, m * H * 4))
        b = bound(n_bytes, 0, torch.float32)
        log(f"kernel row_gather {name} [{n},{H}] f32 by {m} "
            f"({in_range.numel()} in range, {rows} distinct rows), device "
            f"time, L2 cold: kernel {t['ms']:.4f} ms, bound {b[0]:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB), plain {t['plain_ms']:.4f} ms, "
            f"index_select {t['library_ms']:.4f} ms; L2 warm: kernel "
            f"{warm['ms']:.4f} ms, plain {warm['plain_ms']:.4f}, "
            f"index_select {warm['library_ms']:.4f}; back to back (CUDA "
            f"events): kernel {events['ms']:.4f} ms, plain "
            f"{events['plain_ms']:.4f}, index_select "
            f"{events['library_ms']:.4f}")
        require(f"row_gather {name} timings saw device time",
                min(t.values()) > 0 and min(warm.values()) > 0)
        for key in ("ms", "plain_ms", "library_ms"):
            tot[key] += t[key]
        tot["bytes"] += n_bytes
        gathers.append((src, idx, clamped))
    tot["bound"] = bound(tot["bytes"], 0, torch.float32)
    l2_yardsticks(parts)
    log(f"kernel row_gather, one bench_moe step's 3 launches, L2 cold: "
        f"kernel {tot['ms']:.4f} ms, bound {tot['bound'][0]:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, index_select {tot['library_ms']:.4f} ms")
    # the step's three launches against index_select's, in alternating
    # turns (K L L K K L L K), each turn L2 cold and summed over the three
    turns = {"kernel": [], "index_select": []}
    for key in ("kernel", "index_select", "index_select", "kernel") * 2:
        turns[key].append(sum(
            device_ms((lambda s=src, i=idx: md.row_gather_kernel(s, i))
                      if key == "kernel" else
                      (lambda s=src, c=clamped: s.index_select(0, c)),
                      50, cold=True)
            for src, idx, clamped in gathers))
    k_lo, k_hi = min(turns["kernel"]), max(turns["kernel"])
    l_lo, l_hi = min(turns["index_select"]), max(turns["index_select"])
    verdict = ("loses by more than the spread" if k_lo > l_hi else
               "wins by more than the spread" if k_hi < l_lo else
               "inside the spread")
    log(f"kernel row_gather, one bench_moe step's 3 launches, L2 cold, "
        f"alternating turns: kernel {', '.join(f'{t:.4f}' for t in turns['kernel'])}"
        f" ms (spread {k_lo:.4f}-{k_hi:.4f}); index_select "
        f"{', '.join(f'{t:.4f}' for t in turns['index_select'])} ms (spread "
        f"{l_lo:.4f}-{l_hi:.4f}): the kernel {verdict}")
    del gathers
    return tot


def cross_device_moe(ht, layers, md, rng, seed):
    """One f32 training step of a small MoE graph (H=128, F=256, 4 experts,
    T=64) from the same params on the card (row_gather kernel) and on the
    CPU (plain): loss, gradients and each param's change."""
    small = dict(B=2, S=32, H=128, F=256, E=4, k=2, cf=1.25, act="gelu")
    with ht.name_scope():
        loss, x, y = build_moe(ht, layers, small)
        xs = ht.graph_variables([loss], trainable_only=True)
        grads = ht.gradients(loss, xs)
        train_op = ht.AdamOptimizer(1e-3).apply_gradients(
            list(zip(grads, xs)))
    nodes = {"train": [loss, train_op, *grads]}
    ex_gpu = ht.Executor(nodes, device="cuda", seed=seed + 6)
    ex_cpu = ht.Executor(nodes, device="cpu", seed=seed + 7)
    ex_cpu.load_state_dict(ex_gpu.state_dict())
    # copies: a step writes the params in place
    init = {k: v.clone() for k, v in ex_cpu.params.items()}
    shape = (2, 32, 128)
    feed = {x: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)), y: torch.zeros(shape)}
    before = md.row_gather_kernel.launches
    out_gpu = ex_gpu.run("train", feed_dict=feed)
    launches = md.row_gather_kernel.launches - before
    out_cpu = ex_cpu.run("train", feed_dict=feed)
    torch.cuda.synchronize()
    require(f"cross-device MoE: the card's step launched row_gather "
            f"({launches})", launches == 3)
    check("cross-device f32 MoE train loss (card kernel vs CPU plain)",
          out_gpu[0].cpu(), out_cpu[0], 1e-6,
          "f32 on both sides; the expert products and the mean over 8192 "
          "elements sum in another order")
    scale = max(g.abs().max().item() for g in out_cpu[2:])
    bad = [v.name for v, g_gpu, g_cpu in zip(xs, out_gpu[2:], out_cpu[2:])
           if not ((g_gpu.cpu() - g_cpu).abs() - 1e-3 * g_cpu.abs()).max()
           .item() <= 1e-5 * scale]
    worst = max((g_gpu.cpu() - g_cpu).abs().max().item()
                for g_gpu, g_cpu in zip(out_gpu[2:], out_cpu[2:]))
    require(f"cross-device f32 MoE gradients of {len(xs)} params: "
            f"max_abs_err={worst:.3e} tol=1e-5*{scale:.3e} + 1e-3*|g| (f32 "
            "on both sides; the products' sums run in another order) "
            f"{'bad: ' + str(bad) if bad else ''}", not bad)
    errs = {}
    for name, before in init.items():
        change_cpu = ex_cpu.params[name] - before
        change_gpu = ex_gpu.params[name].cpu() - before
        errs[name] = ((change_gpu - change_cpu).norm()
                      / change_cpu.norm()).item()
    name = max(errs, key=errs.get)
    require(f"cross-device MoE params after one Adam step: worst change "
            f"error {errs[name]:.3e} ({name}) in the 2-norm, relative, tol "
            "1e-4 (f32 update from gradients within the tolerance above)",
            errs[name] <= 1e-4)


# -- the context-parallel Llama (slice F1) ------------------------------------

def ring_checks(rng, fa, ht_parallel, cp=4):
    """Phase 2e: ``ring_attention`` over a cp-position mesh on the card (the
    blockwise kernels, one launch a ring step) against the single-device
    flash kernel on the global sequence, causal: the output and the three
    gradients through autograd, from the same q, k, v and cotangent."""
    mesh = ht_parallel.make_mesh({"cp": cp},
                                 devices=[torch.device("cuda", 0)] * cp)
    # bf16 gradients: the ring rounds each step's part to bf16 (half an
    # ulp, at most 2^-9 of the part) before its f32 sum, the single kernel
    # its f32 total once; parts may cancel, so the bound scales with the
    # sum of their sizes: 2^-8 sum_r |part_r| (a factor 2 for dS roundings
    # that flip inside a part) beside BWD_TOL's rounding of dS and P~
    tol = {torch.bfloat16: (
        (1e-2, "each ring step's o is rounded to bf16 before the f32 "
         "logaddexp combine, then the sum once more: two roundings of "
         "2^-9 relative beside the single kernel's one, with P in bf16 in "
         "both", 2.0 ** -6), None),
        torch.float32: (
        (1e-5, "f32 throughout; the ring sums its blocks' softmax in "
         "another order", 1e-5),
        (1e-4, "f32 throughout; the ring sums over blocks in another "
         "order", 1e-4))}
    for (B, H, S, D), dtype in (((2, 12, 1024, 64), torch.bfloat16),
                                ((1, 4, 1024, 128), torch.float32)):
        q, k, v, g = (randn(rng, (B, H, S, D), dtype) for _ in range(4))
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
        o_ring = ht_parallel.ring_attention(mesh, qr, kr, vr, causal=True)
        grads_ring = torch.autograd.grad(o_ring, (qr, kr, vr), g)
        qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
        o_flash = fa.flash_attention(qf, kf, vf, causal=True)
        grads_flash = torch.autograd.grad(o_flash, (qf, kf, vf), g)
        torch.cuda.synchronize()
        name = f"ring cp={cp} [{B},{H},{S},{D}] {_name(dtype)} vs flash"
        (fa_, fwhy, frt), bwd_tol = tol[dtype]
        check(f"{name} o", o_ring, o_flash, fa_, fwhy, rtol=frt)
        if bwd_tol is not None:
            for gname, got, want in zip(("dq", "dk", "dv"), grads_ring,
                                        grads_flash):
                check(f"{name} {gname}", got, want, *bwd_tol)
            continue
        # the parts each ring step adds, from the single kernel's (o, lse)
        o_f, lse_f = fa.flash_attention_fwd(q, k, v, causal=True)
        dsum = (g.float() * o_f.float()).sum(-1)
        parts = [fa.flash_attention_block_bwd(q, k, v, o_f, lse_f, g, 0, 0,
                                              ring=(cp, r), dsum=dsum)
                 for r in range(cp)]
        atol, _, rtol = BWD_TOL[dtype]
        for i, (gname, got, want) in enumerate(zip(
                ("dq", "dk", "dv"), grads_ring, grads_flash)):
            check_spread(f"{name} {gname}", got, want, atol, rtol,
                         sum(p[i].float().abs() for p in parts),
                         "spread = sum_r |part_r|: each step's part rounds "
                         "to bf16 before the f32 sum, the single kernel's "
                         "total once")


# bench_llama's model (bench.py:346-405): vocab 32000, hidden 768, 12
# layers, 12 heads, 4 KV heads, FFN 2048, B=8 S=1024, bf16 over f32 masters,
# AdamW(1e-4, wd 0.01); here under a 4-position cp mesh on one card
LLAMA = dict(V=32000, H=768, L=12, heads=12, kv=4, F=2048, B=8, S=1024, cp=4)
# Mistral-7B's published widths (LLAMA_CONFIGS["mistral-7b"]), 2 of its 32
# layers: hidden 4096, 32 heads, 8 KV heads (d=128), FFN 14336
MISTRAL = dict(V=32000, H=4096, L=2, heads=32, kv=8, F=14336, B=1, S=8192,
               cp=4)


def build_llama(ht, models, c):
    """bench_llama's loss graph at the widths of ``c``: (loss, ids,
    labels)."""
    ids = ht.placeholder_op("lm_ids", (c["B"], c["S"]), dtype=np.int32)
    labels = ht.placeholder_op("lm_labels", (c["B"], c["S"]), dtype=np.int32)
    cfg = models.LlamaConfig(vocab_size=c["V"], hidden_size=c["H"],
                             num_layers=c["L"], num_heads=c["heads"],
                             num_kv_heads=c["kv"], intermediate_size=c["F"],
                             seq_len=c["S"])
    return models.LlamaForCausalLM(cfg).loss(ids, labels), ids, labels


def lm_executor(ht, build, rng, c, seed, mesh=None):
    """``Executor({"train": [loss, AdamW(1e-4, wd 0.01).minimize(loss)]},
    mesh=mesh, compute_dtype=bfloat16)`` on the card over the causal LM
    that ``build()`` makes, (loss, ids, labels), a feed of Zipf-distributed
    ids (``zipf_tokens``; the ids rolled by one as labels) and a step
    returning the loss: (ex, step, init seconds, feed)."""
    with ht.name_scope():
        loss, ids, labels = build()
        train_op = ht.AdamWOptimizer(learning_rate=1e-4,
                                     weight_decay=0.01).minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]}, device="cuda", seed=seed,
                     mesh=mesh, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids_v = zipf_tokens(rng, c["V"], (c["B"], c["S"]))
    feed = {ids: torch.from_numpy(ids_v.astype(np.int32)).cuda(),
            labels: torch.from_numpy(np.roll(ids_v, -1, 1).astype(
                np.int32)).cuda()}

    def step():
        val, none = ex.run("train", feed_dict=feed)
        if none is not None:
            raise RuntimeError("run('train') must return [loss, None]")
        return val
    return ex, step, init_s, feed


def llama_paths(ht, models, ht_parallel, fns, rng, steps, seed, captures):
    """Phase 3e: bench_llama's Llama trained under a 4-position cp mesh on
    the card (the flash ring: 4 block launches of each kernel a layer)
    and without a mesh (the single-device flash kernels), from the same
    params, timed in turns; then 2 layers at Mistral-7B's widths at S=8192
    under cp=4; each with phase 3f's captured-against-eager checks
    (appended to ``captures``).  Returns {label: (ms/step, launches, first
    loss)}."""
    out = {}
    c = LLAMA
    tokens = c["B"] * c["S"]
    cuda = torch.device("cuda", 0)
    mesh = ht_parallel.make_mesh({"cp": c["cp"]}, devices=[cuda] * c["cp"])
    L = c["L"]
    # the step is host-bound and its time moves from window to window, so
    # the two paths are timed in turns (cp, mesh-less, mesh-less, cp, ...),
    # both executors resident
    turn = max(1, steps // 4)
    timed = 4 * turn
    paths = {}
    for label, m, expect in (
            ("llama cp=4 path", mesh, expect_launches(
                **flash_launches(L * c["cp"] * timed, block=True),
                softmax_ce_fwd=timed, softmax_ce_bwd=timed)),
            ("llama mesh-less path", None, expect_launches(
                **flash_launches(L * timed), softmax_ce_fwd=timed,
                softmax_ce_bwd=timed))):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        # the same seed gives both executors the same params and batch
        ex, step, init_s, feed = lm_executor(
            ht, lambda: build_llama(ht, models, c),
            np.random.default_rng(seed + 9), c, seed, m)
        log(f"{label}: Llama V={c['V']} H={c['H']} L={L} heads "
            f"{c['heads']}/{c['kv']} FFN {c['F']} B={c['B']} S={c['S']}, "
            f"bf16 over f32 masters, AdamW(1e-4, wd 0.01), mesh "
            f"{m.shape if m is not None else None}, "
            f"{sum(p.numel() for p in ex.params.values())} params, init "
            f"{init_s:.1f} s")
        losses = [step() for _ in range(3)]
        torch.cuda.synchronize()
        paths[label] = dict(ex=ex, step=step, feed=feed, expect=expect,
                            losses=losses,
                            resident=torch.cuda.memory_allocated() - before,
                            turns=[], peak=0,
                            launches=dict.fromkeys(COUNTER_NAMES, 0))
    order = list(paths) + list(paths)[::-1]
    for label in order * 2:
        p = paths[label]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, ms, launches = timed_window(p["step"], fns, turn)
        p["peak"] = max(p["peak"], torch.cuda.max_memory_allocated() - base)
        p["losses"] += losses
        p["turns"].append(ms / turn)
        for name, n in launches.items():
            p["launches"][name] += n
    for label, p in paths.items():
        ms = sum(p["turns"]) / len(p["turns"])
        losses = [float(v) for v in p["losses"]]
        log(f"{label}: in turns of {turn} steps, ms/step "
            + " ".join(f"{t:.3f}" for t in p["turns"]))
        report_path(label, losses, ms, p["launches"], p["expect"], timed,
                    tokens, "tokens", p["resident"] + p["peak"],
                    p["resident"])
        profile_steps(label, p["step"], steps=1)
        out[label] = (ms, p["launches"], losses[0])
    for label, p in paths.items():
        captures.append(capture_phase(ht, label, p["ex"], "train",
                                      p["feed"], fns))
    for p in paths.values():
        p["ex"].close()
    del paths, p
    free_memory("after the llama paths")
    (ms_cp, _, first_cp), (ms_sd, _, first_sd) = out.values()
    log(f"llama paths: cp=4 {ms_cp:.3f} ms/step ({tokens * 1000 / ms_cp:.1f}"
        f" tokens/s), mesh-less {ms_sd:.3f} ms/step "
        f"({tokens * 1000 / ms_sd:.1f} tokens/s), ratio "
        f"{ms_cp / ms_sd:.3f}; first losses {first_cp:.6f} (cp) and "
        f"{first_sd:.6f}")
    check("llama first-step loss, cp=4 ring vs mesh-less (same params and "
          "batch)", torch.tensor(first_cp), torch.tensor(first_sd), 2e-2,
          "bf16 activations; the ring's attention rounds in other places "
          "than the single-device kernel")

    w = MISTRAL
    mesh = ht_parallel.make_mesh({"cp": w["cp"]}, devices=[cuda] * w["cp"])
    ex, step, init_s, feed = lm_executor(
        ht, lambda: build_llama(ht, models, w), rng, w, seed, mesh)
    log(f"mistral-width witness: H={w['H']} heads {w['heads']}/{w['kv']} "
        f"(d={w['H'] // w['heads']}) FFN {w['F']} V={w['V']}, {w['L']} of "
        f"32 layers, B={w['B']} S={w['S']} cp={w['cp']} (local "
        f"{w['S'] // w['cp']}), bf16 over f32 masters, AdamW, "
        f"{sum(p.numel() for p in ex.params.values())} params, init "
        f"{init_s:.1f} s")
    n = w["L"] * w["cp"] * 3
    _, ms_w, _ = run_path(
        "mistral-width witness", step, fns, 3, w["B"] * w["S"],
        expect_launches(**flash_launches(n, block=True), softmax_ce_fwd=3,
                        softmax_ce_bwd=3), warmup=2, unit="tokens")
    profile_steps("mistral-width witness", step, steps=1)
    captures.append(capture_phase(ht, "mistral-width witness", ex, "train",
                                  feed, fns, n=3, turn=2))
    out["mistral-width witness"] = (ms_w, None, None)
    ex.close()
    del ex, step, feed
    free_memory("after the mistral-width witness")
    return out


def block_bound(name, B, H, D, blocks, dtype):
    """(ms, "bytes" or "operations") of one launch of the block kernel
    ``name`` over ``blocks``, each rank's (query rows, keys, live (row,
    key) pairs) in the launch.  Every rank's outputs are written once; its
    inputs count only where its block has a live pair, since an empty
    block's outputs are constants (o = 0 and lse = -1e30; dq = 0; dk = dv
    = 0).  Operations: 4 d a live pair forward (QK^T, PV), 6 d for dQ
    (QK^T, dO V^T, dS K), 8 d for dK/dV (QK^T, dO V^T, P^T dO, dS^T Q)."""
    e = torch.finfo(dtype).bits // 8
    n_bytes = ops = 0
    for sq, sk, pairs in blocks:
        live = pairs > 0
        if name == "flash_attention_block_fwd":
            n_bytes += live * (sq + 2 * sk) * D * e + sq * D * e + 4 * sq
            ops += 4 * pairs * D
        elif name == "flash_attention_block_bwd_dq":
            n_bytes += live * ((2 * sq + 2 * sk) * D * e + 8 * sq) + sq * D * e
            ops += 6 * pairs * D
        else:
            n_bytes += (live * ((2 * sq + 2 * sk) * D * e + 8 * sq)
                        + 2 * sk * D * e)
            ops += 8 * pairs * D
    return bound(B * H * n_bytes, B * H * ops, dtype)


def block_times(rng, fa):
    """The blockwise kernels at the witness's block shape, q [1,32,2048,128]
    bf16 against K/V of the same shape, for the full, diagonal and empty
    blocks: each kernel, its plain version, its bound (``block_bound``)
    and one PyTorch library call (the yardstick;
    nothing on the path calls it): scaled_dot_product_attention non-causal
    for the full block, causal for the diagonal, and its backward.  Then
    the main path's ring-step launch, [8,12,1024,64] over 4 ranks, and its
    bound, averaged over the 4 steps.  The empty blocks and the ring steps
    are timed by their kernels' device time (``device_ms``), the rest in
    CUDA graphs (``graph_ms``).  Returns {case: {kernel: times}}."""
    B, H, S, D = 1, 32, 2048, 128
    bf = torch.bfloat16
    q, k, v, do = (torch.randn(B, H, S, D, device="cuda", dtype=bf)
                   for _ in range(4))
    pairs = {"full": S * S, "diagonal": S * (S + 1) // 2, "empty": 0}
    offsets = {"full": (S, 0), "diagonal": (0, 0), "empty": (0, S)}
    out = {}
    for case, (q_off, k_off) in offsets.items():
        fwd = lambda: fa.flash_attention_block(  # noqa: E731
            q, k, v, q_off, k_off)
        o, lse = fwd()
        dsum = (do.float() * o.float()).sum(-1)
        # the backward takes a live lse for every row (an empty block's
        # rows take the diagonal's, as the ring's combined lse would)
        if case == "empty":
            lse = fa.flash_attention_block(q, k, v, 0, 0)[1]
        calls = {
            "flash_attention_block_fwd": (fwd, lambda: (
                fa.flash_attention_block_plain(q, k, v, q_off, k_off))),
            "flash_attention_block_bwd_dq": (
                lambda: fa.flash_attention_block_bwd_dq(
                    q, k, v, do, lse, dsum, q_off, k_off),
                lambda: fa.flash_attention_block_bwd_plain(
                    q, k, v, do, lse, dsum, q_off, k_off)),
            "flash_attention_block_bwd_dkv": (
                lambda: fa.flash_attention_block_bwd_dkv(
                    q, k, v, do, lse, dsum, q_off, k_off),
                lambda: fa.flash_attention_block_bwd_plain(
                    q, k, v, do, lse, dsum, q_off, k_off))}
        lib = {}
        if case != "empty":
            causal = case == "diagonal"
            lib["fwd"] = graph_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            lib["bwd"] = backward_ms(
                lambda *x: F.scaled_dot_product_attention(
                    *x, is_causal=causal), (q, k, v), do)
            live = B * H * pairs[case] * D
            yardstick_floor(f"sdpa {case} block", lib["fwd"], 4 * live)
            yardstick_floor(f"sdpa backward {case} block", lib["bwd"],
                            10 * live)
        blocks = [(S, S, pairs[case])]
        bounds = {name: block_bound(name, B, H, D, blocks, bf)
                  for name in calls}
        out[case] = {}
        for name, (kern, plain) in calls.items():
            # an empty block's launch takes the card less time than the
            # host needs to make it: its kernels' device time
            ms = device_ms(kern, 50) if case == "empty" else graph_ms(kern)
            r = dict(ms=ms, plain_ms=time_ms(plain, 3),
                     bound=bounds[name],
                     library_ms=lib.get("fwd" if name.endswith("fwd")
                                        else "bwd"))
            out[case][name] = r
            lib_s = ("null" if r["library_ms"] is None
                     else f"{r['library_ms']:.4f} ms")
            log(f"kernel {name} {case} block q [{B},{H},{S},{D}] bf16 at "
                f"({q_off},{k_off}): {r['ms']:.4f} ms, bound "
                f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), plain "
                f"{r['plain_ms']:.4f} ms, scaled_dot_product_attention"
                f"{'' if name.endswith('fwd') else ' backward'} "
                f"{'(causal) ' if case == 'diagonal' else ''}{lib_s}")
        del o, lse, dsum
    del q, k, v, do

    # the main path's launches: one ring step over 4 ranks each
    c = LLAMA
    shape = (c["B"], c["heads"], c["S"], c["H"] // c["heads"])
    q, k, v, do = (torch.randn(*shape, device="cuda", dtype=bf)
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    dsum = (do.float() * o.float()).sum(-1)
    n, lc = c["cp"], c["S"] // c["cp"]
    ring = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    ring_bound = dict.fromkeys(ring, 0.0)
    for r in range(n):
        kw = dict(ring=(n, r))
        # step r: rank g's rows see the K/V block of rank (g - r) mod n,
        # its own diagonal at r = 0, a full block for g >= r > 0, else none
        blocks = [(lc, lc, lc * (lc + 1) // 2 if r == 0
                   else lc * lc if g >= r else 0) for g in range(n)]
        for key, name in (("fwd", "flash_attention_block_fwd"),
                          ("dq", "flash_attention_block_bwd_dq"),
                          ("dkv", "flash_attention_block_bwd_dkv")):
            ring_bound[key] += block_bound(name, shape[0], shape[1],
                                           shape[3], blocks, bf)[0] / n
        # ~0.03-0.09 ms launches, near the host's time per call: their
        # kernels' device time
        ring["fwd"] += device_ms(lambda: fa.flash_attention_block(
            q, k, v, 0, 0, **kw), 50) / n
        ring["dq"] += device_ms(lambda: fa.flash_attention_block_bwd_dq(
            q, k, v, do, lse, dsum, 0, 0, **kw), 50) / n
        ring["dkv"] += device_ms(lambda: fa.flash_attention_block_bwd_dkv(
            q, k, v, do, lse, dsum, 0, 0, **kw), 50) / n
    log(f"kernel block ring-step launch {list(shape)} bf16 cp={n}, mean "
        f"over the {n} steps: "
        + ", ".join(f"{key} {ring[key]:.4f} ms (bound {ring_bound[key]:.4f})"
                    for key in ring)
        + " (a step's 4 ranks together; the causal work of all steps is one "
        "causal attention of the global sequence)")
    out["ring step"] = ring
    return out


def cross_device_lm(ht, label, build, c, fns, rng, seed, expect, why,
                    meshes=(None, None)):
    """One f32 training step of a small causal LM, ``build()`` = (loss, ids,
    labels) at vocab ``c["V"]`` and [``c["B"]``, ``c["S"]``] ids, uniform,
    from the same params on the card (the kernels) and
    on the CPU (their plain versions), under ``meshes`` (the card's, the
    CPU's): the card's launches against ``expect`` ((counts, what they
    are)), then the loss, every gradient and each param's change against
    the CPU's.  ``why``: (the loss's tolerance reason, the sums that
    differ in order)."""
    with ht.name_scope():
        loss, ids, labels = build()
        xs = ht.graph_variables([loss], trainable_only=True)
        grads = ht.gradients(loss, xs)
        train_op = ht.AdamWOptimizer(learning_rate=1e-4, weight_decay=0.01
                                     ).apply_gradients(list(zip(grads, xs)))
    nodes = {"train": [loss, train_op, *grads]}
    ex_gpu = ht.Executor(nodes, device="cuda", seed=seed, mesh=meshes[0])
    ex_cpu = ht.Executor(nodes, device="cpu", seed=seed + 1, mesh=meshes[1])
    ex_cpu.load_state_dict(ex_gpu.state_dict())
    # copies: a step writes the params in place
    init = {k: v.clone() for k, v in ex_cpu.params.items()}
    ids_v = rng.integers(0, c["V"], (c["B"], c["S"]))
    feed = {ids: torch.from_numpy(ids_v.astype(np.int32)),
            labels: torch.from_numpy(np.roll(ids_v, -1, 1).astype(np.int32))}
    before = {name: fn.launches for name, fn in fns.items()}
    out_gpu = ex_gpu.run("train", feed_dict=feed)
    launches = {name: fn.launches - before[name] for name, fn in fns.items()}
    out_cpu = ex_cpu.run("train", feed_dict=feed)
    torch.cuda.synchronize()
    require(f"cross-device {label}: the card's step launched {expect[1]} "
            f"({launches})", launches == expect[0])
    check(f"cross-device f32 {label} train loss (card kernels vs CPU "
          "plain)", out_gpu[0].cpu(), out_cpu[0], 1e-5, why[0])
    scale = max(g.abs().max().item() for g in out_cpu[2:])
    bad = [v.name for v, g_gpu, g_cpu in zip(xs, out_gpu[2:], out_cpu[2:])
           if not ((g_gpu.cpu() - g_cpu).abs() - 1e-3 * g_cpu.abs()).max()
           .item() <= 1e-5 * scale]
    worst = max((g_gpu.cpu() - g_cpu).abs().max().item()
                for g_gpu, g_cpu in zip(out_gpu[2:], out_cpu[2:]))
    require(f"cross-device f32 {label} gradients of {len(xs)} params: "
            f"max_abs_err={worst:.3e} tol=1e-5*{scale:.3e} + 1e-3*|g| (f32 "
            f"on both sides; {why[1]} sum in another order) "
            f"{'bad: ' + str(bad) if bad else ''}", not bad)
    adamw_change_checks(f"cross-device {label}", xs, init, ex_gpu, ex_cpu,
                        out_gpu[2:], out_cpu[2:], lr=1e-4, eps=1e-7)
    ex_gpu.close()


def cross_device_llama(ht, models, ht_parallel, fns, rng, seed):
    """One f32 training step of a small Llama (2 layers, hidden 256, 4
    heads, 2 KV heads, V=32000, B=2, S=1024) under cp=4 from the same
    params on the card (the blockwise kernels, the CE kernels) and on the
    CPU (their plain versions): loss, gradients and each param's change."""
    c = dict(V=32000, H=256, L=2, heads=4, kv=2, F=512, B=2, S=1024)
    cross_device_lm(
        ht, "Llama cp=4", lambda: build_llama(ht, models, c), c, fns, rng,
        seed + 10, (expect_launches(
            **flash_launches(8, block=True, routes=SIMT),
            softmax_ce_fwd=1, softmax_ce_bwd=1),
            "the block kernels 8/8/8, f32 on the plain-FMA route"),
        ("f32 on both sides; a loss of ~10.4 whose 32000-way logsumexp "
         "and mean over 2048 tokens sum in another order (1e-6 relative)",
         "the ring, the GEMMs and the CE"),
        meshes=(ht_parallel.make_mesh({"cp": 4}, devices=[
            torch.device("cuda", 0)] * 4),
            ht_parallel.make_mesh({"cp": 4}, devices=["cpu"] * 4)))


# -- phase 3g: ResNet-18 --------------------------------------------------

def build_resnet(ht, models, B, channels_last=False):
    """bench_resnet's graph at batch ``B``: ``resnet18(10)``, the mean
    sparse CE, ``MomentumOptimizer(0.1, 0.9).minimize(loss)``; returns
    ({"train": [loss, train_op], "validate": [logits]}, x, y)."""
    r = RESNET
    with ht.name_scope():
        shape = ((B, r["HW"], r["HW"], r["C"]) if channels_last
                 else (B, r["C"], r["HW"], r["HW"]))
        x = ht.placeholder_op("rn_x", shape)
        y = ht.placeholder_op("rn_y", (B,), dtype=np.int32)
        logits = models.resnet18(num_classes=r["classes"],
                                 channels_last=channels_last)(x)
        loss = ht.reduce_mean_op(
            ht.softmax_cross_entropy_sparse_op(logits, y))
        train_op = ht.MomentumOptimizer(r["lr"], r["momentum"]).minimize(
            loss)
    return {"train": [loss, train_op], "validate": [logits]}, x, y


def resnet_arrays(rng, B):
    """x ~ N(0, 1) [B, 3, 32, 32] f32 and y uniform in [0, 10), as
    bench_resnet draws them."""
    r = RESNET
    return (torch.from_numpy(rng.standard_normal(
                (B, r["C"], r["HW"], r["HW"])).astype(np.float32)),
            torch.from_numpy(rng.integers(0, r["classes"], B).astype(
                np.int32)))


RELU_FLIPS = ("a ReLU's mask flips where a pre-activation lies within f32 "
              "rounding of 0, which moves that entry's gradient by its full"
              " size; at B=8 a layer-4 weight sums 128 positions, so one "
              "flip moves its gradient by ~1/128 of it")


def rel_errors(pairs):
    """{name: |a - b| / |b|} in the 2-norm for {name: (a, b)}."""
    return {k: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for k, (a, b) in pairs.items()}


def change_checks(label, ex_a, ex_b, init, tol, why):
    """Each param's change from ``init`` (on the CPU) in executor ``a``
    against its change in ``b``: the trainable params' (-lr g in a first
    Momentum step) within ``tol`` relative in the 2-norm (``why``), the
    running stats' (a forward quantity) entry by entry within 1e-3 of
    their size + 1e-5 of the largest."""
    changes = {k: (ex_a.params[k].cpu() - p0, ex_b.params[k].cpu() - p0)
               for k, p0 in init.items()}
    errs = rel_errors({k: v for k, v in changes.items()
                       if "_running_" not in k})
    name = max(errs, key=errs.get)
    require(f"{label}: each param's change in one Momentum step, worst "
            f"{errs[name]:.3e} ({name}) in the 2-norm, relative, tol {tol:g}"
            f" ({why})", errs[name] <= tol)
    stats = {k: v for k, v in changes.items() if "_running_" in k}
    scale = max(b.abs().max().item() for _, b in stats.values())
    diff = {k: (a - b).abs() for k, (a, b) in stats.items()}
    bad = [k for k, (a, b) in stats.items()
           if not (diff[k] - 1e-3 * b.abs()).max().item() <= 1e-5 * scale]
    worst = max(d.max().item() for d in diff.values())
    require(f"{label}: the {len(stats)} running stats' change, "
            f"max_abs_err={worst:.3e} tol=1e-5*{scale:.3e} + 1e-3*|change| "
            "(f32 batch means and variances summed in another order)"
            f"{' bad: ' + str(bad) if bad else ''}", not bad)


def resnet_paths(ht, models, fns, rng, steps, seed, captures):
    """Phase 3g: bench_resnet's training step at full size (B=2048, f32,
    Momentum), no hand-written kernel launched (the CE at 10 classes is
    below its kernel's gate, as in JAX), the running stats moving and a
    ``validate`` run that changes no param; its breakdown and phase 3f's
    captured-against-eager checks (appended to ``captures``).  Returns
    (ms/step, launches)."""
    r = RESNET
    B = r["B"]
    nodes, x, y = build_resnet(ht, models, B)
    t0 = time.perf_counter()
    ex = ht.Executor(nodes, device="cuda", seed=seed)
    torch.cuda.synchronize()
    stats = [k for k in ex.params if "_running_" in k]
    log(f"resnet18 path: resnet18(10) B={B} 3x32x32 f32, Momentum("
        f"{r['lr']}, {r['momentum']}), "
        f"{sum(v.numel() for k, v in ex.params.items() if k not in stats)} "
        f"params and {len(stats)} running stats, init "
        f"{time.perf_counter() - t0:.1f} s")
    X, Y = resnet_arrays(rng, B)
    feed = {x: X.cuda(), y: Y.cuda()}
    init_stats = {k: ex.params[k].clone() for k in stats}

    def step():
        val, none = ex.run("train", feed_dict=feed)
        if none is not None:
            raise RuntimeError("run('train') must return [loss, None]")
        return val

    label = "resnet18 path"
    _, ms, launches = run_path(label, step, fns, steps, B, expect_launches())
    log(f"resnet18 path: resnet18_cifar_train_samples_per_sec "
        f"{B * 1000.0 / ms:.1f} ({ms:.3f} ms/step)")
    moved = sum(not torch.equal(ex.params[k], init_stats[k]) for k in stats)
    require(f"{label}: every running stat moved ({moved} of {len(stats)})",
            moved == len(stats))
    before = {k: v.clone() for k, v in ex.params.items()}
    logits = ex.run("validate", feed_dict={x: feed[x]})[0]
    torch.cuda.synchronize()
    require(f"{label}: validate gives finite {list(logits.shape)} logits "
            "and changes no param, running stats included",
            tuple(logits.shape) == (B, r["classes"])
            and bool(torch.isfinite(logits).all())
            and all(torch.equal(before[k], v) for k, v in ex.params.items()))
    del before, init_stats
    profile_steps(label, step, steps=1, top=16, fns=fns)
    captures.append(capture_phase(ht, label, ex, "train", feed, fns,
                                  kernels=False))
    ex.close()
    del ex, step, feed
    free_memory("after the resnet18 path")
    return ms, launches


def resnet_layouts(ht, models, rng, seed, turn=3):
    """Phase 3g: ``channels_last=True`` (NHWC activations) against the
    NCHW model with the same weights on the card: one step each on the
    same batch (loss, and each param's change, running stats included),
    then both captured, ms/step in turns of ``turn`` steps (NCHW, NHWC,
    NHWC, NCHW)."""
    B = RESNET["B"]
    exs = {}
    for layout in ("nchw", "nhwc"):
        nodes, x, y = build_resnet(ht, models, B,
                                   channels_last=layout == "nhwc")
        exs[layout] = (ht.Executor(nodes, device="cuda", seed=seed), x, y)
    ref = exs["nchw"][0]
    exs["nhwc"][0].load_params({k: v.cpu().numpy()
                                for k, v in ref.params.items()})
    init = {k: v.cpu().clone() for k, v in ref.params.items()}
    X, Y = resnet_arrays(rng, B)
    X = X.cuda()
    feeds = {"nchw": {exs["nchw"][1]: X, exs["nchw"][2]: Y.cuda()},
             "nhwc": {exs["nhwc"][1]: X.permute(0, 2, 3, 1).contiguous(),
                      exs["nhwc"][2]: Y.cuda()}}
    losses = {k: ex.run("train", feed_dict=feeds[k])[0]
              for k, (ex, _, _) in exs.items()}
    torch.cuda.synchronize()
    check("resnet18 channels_last vs NCHW, first-step loss (same params "
          "and batch, on the card)", losses["nhwc"].cpu(),
          losses["nchw"].cpu(), 0.0,
          "f32; cuDNN sums each convolution in another order in the two "
          "memory formats", rtol=1e-5)
    change_checks("resnet18 channels_last vs NCHW", exs["nhwc"][0], ref,
                  init, 1e-2, "f32; cuDNN sums in another order in each "
                  "memory format, and " + RELU_FLIPS + "; at B=2048 the "
                  "flips' share is ~sqrt(256) times smaller")
    del init
    turns = {k: [] for k in exs}
    for k, (ex, _, _) in exs.items():
        for _ in range(2):  # the capture
            ex.run("train", feed_dict=feeds[k])
    for k in ("nchw", "nhwc", "nhwc", "nchw"):
        ex = exs[k][0]
        _, ms, _ = timed_window(
            lambda: ex.run("train", feed_dict=feeds[k])[0], {}, turn)
        turns[k].append(ms / turn)
    for k, t in turns.items():
        log(f"resnet18 layout {k}: captured {sum(t) / len(t):.3f} ms/step "
            f"(turns of {turn}: " + " ".join(f"{v:.3f}" for v in t) + ")")
    for ex, _, _ in exs.values():
        ex.close()
    del exs, feeds
    free_memory("after the resnet18 layouts")


def conv_times(turn=2):
    """ResNet-18's convolutions at B=2048, f32 (TF32 off), as one step
    runs them: the forward, dgrad (not for the stem) and wgrad, each
    direction timed alone, under the port's cuDNN setting (deterministic
    algorithms, benchmark off) and under cuDNN's default choice
    (benchmark off), in turns (deterministic, default, default,
    deterministic), beside the step's convolution FLOPs and their bound
    at the f32 rate."""
    B = RESNET["B"]
    cases, flop = [], 0
    for ci, co, k, stride, hw, count in RESNET_CONVS:
        x = torch.randn(B, ci, hw, hw, device="cuda")
        w = torch.randn(co, ci, k, k, device="cuda") * 0.05
        out = F.conv2d(x, w, None, stride, k // 2)
        g = torch.randn_like(out)
        dx = ci != RESNET["C"]
        flop += count * 2 * out.numel() * ci * k * k * (3 if dx else 2)
        cases.append((x, w, g, stride, k // 2, count, dx))
        del out

    def run(direction):
        for x, w, g, stride, pad, count, dx in cases:
            for _ in range(count):
                if direction == "fwd":
                    F.conv2d(x, w, None, stride, pad)
                elif direction == "wgrad" or dx:
                    torch.ops.aten.convolution_backward(
                        g, x, w, None, [stride] * 2, [pad] * 2, [1, 1],
                        False, [0, 0], 1,
                        [direction == "dgrad", direction == "wgrad", False])

    dirs = ("fwd", "dgrad", "wgrad")
    turns = {(det, d): [] for det in (True, False) for d in dirs}
    for det in (True, False, False, True):
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=det, allow_tf32=False):
            for d in dirs:
                turns[det, d].append(time_ms(lambda: run(d), turn, warmup=1))
    ms = {key: sum(t) / len(t) for key, t in turns.items()}
    total = {det: sum(ms[det, d] for d in dirs) for det in (True, False)}
    log(f"resnet18 convolutions a step (B={B}, f32): {flop / 1e12:.3f} "
        f"TFLOP, bound {flop / PEAK_OPS[torch.float32] * 1e3:.3f} ms at "
        f"{PEAK_OPS[torch.float32] / 1e12:g} TFLOP/s; cuDNN deterministic "
        f"(the port's) {total[True]:.3f} ms, default {total[False]:.3f} ms,"
        f" deterministic / default {total[True] / total[False]:.4f}; by "
        "direction, deterministic / default ms (turns): "
        + "; ".join(f"{d} {ms[True, d]:.3f} / {ms[False, d]:.3f} ("
                    + " ".join(f"{t:.3f}" for t in turns[True, d]) + " / "
                    + " ".join(f"{t:.3f}" for t in turns[False, d]) + ")"
                    for d in dirs))
    del cases
    free_memory("after the convolution timings")


def cross_device_resnet(ht, models, rng, seed):
    """One f32 training step of resnet18 at B=8 (32x32) from the same
    params on the card (cuDNN) and on the CPU: loss, every gradient, and
    each param's change, running stats included."""
    B = 8
    with ht.name_scope():
        x = ht.placeholder_op("rn_x", (B, 3, 32, 32))
        y = ht.placeholder_op("rn_y", (B,), dtype=np.int32)
        logits = models.resnet18(num_classes=10)(x)
        loss = ht.reduce_mean_op(
            ht.softmax_cross_entropy_sparse_op(logits, y))
        xs = ht.graph_variables([loss], trainable_only=True)
        grads = ht.gradients(loss, xs)
        train_op = ht.MomentumOptimizer(0.1, 0.9).apply_gradients(
            list(zip(grads, xs)))
    nodes = {"train": [loss, train_op, *grads]}
    ex_gpu = ht.Executor(nodes, device="cuda", seed=seed + 12)
    ex_cpu = ht.Executor(nodes, device="cpu", seed=seed + 13)
    ex_cpu.load_params({k: v.cpu().numpy() for k, v in ex_gpu.params.items()})
    init = {k: v.clone() for k, v in ex_cpu.params.items()}
    X, Y = resnet_arrays(rng, B)
    feed = {x: X, y: Y}
    out_gpu = ex_gpu.run("train", feed_dict=feed)
    out_cpu = ex_cpu.run("train", feed_dict=feed)
    torch.cuda.synchronize()
    check("cross-device f32 resnet18 train loss (cuDNN vs CPU)",
          out_gpu[0].cpu(), out_cpu[0], 1e-5,
          "f32 on both sides; the convolutions and batch-norm means sum in "
          "another order")
    errs = rel_errors({v.name: (g_gpu.cpu(), g_cpu) for v, g_gpu, g_cpu
                       in zip(xs, out_gpu[2:], out_cpu[2:])})
    name = max(errs, key=errs.get)
    require(f"cross-device f32 resnet18 gradients of {len(xs)} params: worst"
            f" {errs[name]:.3e} ({name}) in the 2-norm, relative, tol 5e-2 "
            "(f32 on both sides, summed in another order; " + RELU_FLIPS
            + ")", errs[name] <= 5e-2)
    change_checks("cross-device resnet18", ex_gpu, ex_cpu, init, 5e-2,
                  "the change is -0.1 g: as the gradients")
    ex_gpu.close()


# -- path h: the continuous-batching Llama serving engine ----------------------

# bench.py --serve's slot engine (bench.py:1602-1614) at Mistral-7B's
# published widths and full depth, bf16 weights; the trace is
# ``_serve_trace``'s form (bench.py:1539-1554) at 64 requests
SERVE = dict(config="mistral-7b", n_slots=16, max_len=1024, max_prompt=512,
             prefill_budget=2, requests=64, p_lo=64, p_hi=512, new_lo=32,
             new_hi=256, mean_gap=0.6, trace_seed=0)
# the card-vs-CPU check's f32 config
SERVE_SMALL = dict(vocab_size=1024, hidden_size=256, num_layers=2,
                   num_heads=8, num_kv_heads=2, intermediate_size=512)


def serve_trace(seed, n_requests, vocab, p_lo, p_hi, new_lo, new_hi,
                mean_gap=0.6):
    """bench.py's ``_serve_trace``: Poisson arrivals measured in scheduler
    iterations (exponential gaps of mean ``mean_gap``), prompts of uniform
    ids and lengths in [p_lo, p_hi], output budgets in [new_lo, new_hi]:
    [(arrival iteration, prompt, max_new)]."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_gap, n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(np.int64)
    trace = []
    for i in range(n_requests):
        p_len = int(rng.integers(p_lo, p_hi + 1))
        trace.append((int(arrivals[i]),
                      rng.integers(1, vocab, (p_len,)).astype(np.int32),
                      int(rng.integers(new_lo, new_hi + 1))))
    return trace


def serve_replay(engine, trace):
    """bench.py's ``_serve_replay``: drive the engine through the trace
    (the arrival clock is the iteration index); the requests, wall
    seconds, iterations and ``stream_sha`` (every request's tokens in
    trace order)."""
    import hashlib
    engine.reset_stats()
    t0 = time.perf_counter()
    submitted, it, reqs = 0, 0, []
    while submitted < len(trace) or not engine.scheduler.idle:
        while submitted < len(trace) and trace[submitted][0] <= it:
            _, prompt, max_new = trace[submitted]
            reqs.append(engine.submit(prompt, max_new))
            submitted += 1
        engine.step()
        it += 1
    wall = time.perf_counter() - t0
    sha = hashlib.sha256()
    for r in reqs:
        sha.update(np.asarray(r.tokens, np.int32).tobytes())
    return {"reqs": reqs, "wall_s": wall, "iterations": it,
            "tokens": sum(len(r.tokens) for r in reqs),
            "sha": sha.hexdigest()[:16], "stats": engine.stats()}


def served_llama(ht, models, config, name, seed, dtype, device="cuda"):
    """A LlamaForCausalLM's executor (a forward subgraph, never run) with
    its params cast to ``dtype`` — what a user serves."""
    model = models.LlamaForCausalLM(config, name=name)
    ids = ht.placeholder_op(f"{name}_ids", (1, 4), dtype=np.int32)
    ex = ht.Executor([model(ids)], device=device, seed=seed)
    ex.cast_params(dtype)
    return ex, model


def decode_turns(ht, eng, fns, turn=10):
    """Decode ms/step of ``eng.step()`` with every slot decoding and no
    admission, eager (``disable_capture()``) against captured in turns of
    ``turn`` steps (captured, eager, eager, captured), CUDA events; then
    traced windows of each (captured, eager): busy time, idle share, and
    no hand-written kernel traced or counted."""
    modes = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        with (ht.disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            _, ms, launches = timed_window(eng.step, fns, turn)
        require(f"serving decode {mode} turn: no hand-written kernel "
                "launched", not any(launches.values()))
        modes[mode].append(ms / turn)
    traces = {}
    for mode in ("captured", "eager"):
        with (ht.disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            t = profile_steps(f"serving decode {mode}", eng.step, steps=turn,
                              top=12 if mode == "captured" else 0, fns=fns,
                              cpu=False)
        require(f"serving decode {mode}: the traced window shows and the "
                "counters count no hand-written kernel",
                t is not None and not t["kernels"])
        traces[mode] = t
    return modes, traces


def serving_paths(ht, models, fns, rng, seed, captures):
    """Phase 3h: the slot serving engine at Mistral-7B's widths with its 32
    layers, bf16, on a seeded 64-request Poisson trace; its gang twin, its
    eager run, decode and prefill against their bounds, traced prefill and
    decode windows, peak memory, and ``greedy_generate`` against a one-request
    engine.  Returns the summary (also appended to ``captures``)."""
    from hetu_tpu_torch.metrics import request_latency_summary
    from hetu_tpu_torch.models.llama_decode import greedy_generate
    from hetu_tpu_torch.serving import InferenceEngine
    s = SERVE
    c = models.LlamaConfig(**models.LLAMA_CONFIGS[s["config"]])
    name = "mistral"
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with ht.name_scope():
        ex, model = served_llama(ht, models, c, name, seed, torch.bfloat16)
    free_memory("after the served executor's cast to bf16")
    n_params = sum(t.numel() for t in ex.params.values())
    param_bytes = sum(t.numel() * t.element_size()
                      for t in ex.params.values())
    log(f"serving path: {s['config']} (hidden {c.hidden_size}, "
        f"{c.num_layers} layers, heads {c.num_heads}/{c.num_kv_heads}, FFN "
        f"{c.intermediate_size}, vocab {c.vocab_size}), {n_params} params, "
        f"{param_bytes / 1e9:.3f} GB bf16, init and cast "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(n_slots=s["n_slots"], max_len=s["max_len"],
              max_prompt_len=s["max_prompt"],
              prefill_budget=s["prefill_budget"], name=name, seed=seed)
    trace = serve_trace(s["trace_seed"], s["requests"], c.vocab_size,
                        s["p_lo"], s["p_hi"], s["new_lo"], s["new_hi"],
                        s["mean_gap"])

    def engine(**more):
        eng = InferenceEngine(ex, model, **kw, **more)
        # warm-up: two requests, so that each program runs eagerly once
        # and is captured at its second call
        eng.generate_many([trace[0][1][:64], trace[1][1][:64]], 3)
        return eng

    eng = engine()
    pool_bytes = eng.cache.nbytes
    require(f"serving path: trace_counts after warm-up {eng.trace_counts}",
            eng.trace_counts == {"prefill": 1, "step": 1})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for fn in fns.values():
        fn.launches = 0
    res = serve_replay(eng, trace)
    launches = {k: fn.launches for k, fn in fns.items() if fn.launches}
    peak = torch.cuda.max_memory_allocated()
    graphs = eng.graph_bytes
    st, reqs = res["stats"], res["reqs"]
    lat = request_latency_summary(eng.records)
    tps = res["tokens"] / res["wall_s"]
    log(f"serving path: {len(reqs)} requests, {res['tokens']} tokens in "
        f"{res['wall_s']:.3f} s ({res['iterations']} iterations, "
        f"{st['decode_steps']} decode steps, {st['prefills']} prefills): "
        f"mistral7b_serve_output_tokens_per_sec {tps:.1f}, mean occupancy "
        f"{st['mean_occupancy']}, peak active {st['peak_active']}, stream "
        f"sha {res['sha']}")
    for key in ("ttft", "tpot", "queue_wait"):
        log(f"serving path: {key} p50 {lat[key]['p50'] * 1e3:.3f} ms, p99 "
            f"{lat[key]['p99'] * 1e3:.3f} ms, mean "
            f"{lat[key]['mean'] * 1e3:.3f} ms")
    peak -= base
    log(f"serving path: peak allocated {peak / 2**30:.3f} GiB (resident "
        f"{(resident - base) / 2**30:.3f} GiB; both less the "
        f"{base / 2**30:.3f} GiB allocated before the path) beside params "
        f"{param_bytes / 2**30:.3f}"
        f" + pool {pool_bytes / 2**30:.3f} = "
        f"{(param_bytes + pool_bytes) / 2**30:.3f} GiB; graph pools "
        f"prefill {graphs['prefill'] / 2**30:.3f} GiB, step "
        f"{graphs['step'] / 2**30:.3f} GiB")
    require("serving path: every request finished, "
            + f"{sum(r.finish_reason == 'max_new' for r in reqs)} of "
            f"{len(reqs)} at max_new",
            all(r.finished and r.finish_reason == "max_new" for r in reqs))
    require(f"serving path: trace_counts after the replay {eng.trace_counts}",
            eng.trace_counts == {"prefill": 1, "step": 1})
    require(f"serving path: no hand-written kernel launched ({launches})",
            not launches)
    require("serving path: each graph's pool is smaller than the KV pool "
            f"({pool_bytes / 2**30:.3f} GiB): no program holds a second copy",
            max(graphs.values()) < pool_bytes)

    # why bits need equal shapes: one row of the first layer's q product
    # at 1, 16 and 512 rows
    x = torch.randn(512, c.hidden_size, device="cuda",
                    dtype=torch.bfloat16)
    w = ex.params[f"{name}_layer0_attn_q_weight"]
    rows = {n: (x[:n] @ w)[:1] for n in (1, 16, 512)}
    log("serving path: one row of the q product at 1 / 16 / 512 rows, "
        "bitwise equal to 16 rows': "
        + ", ".join(f"{n}: {torch.equal(r, rows[16])}"
                    for n, r in rows.items()))
    del x, rows

    # the trace's first requests again, eagerly, on the same engine: a
    # request's stream does not depend on its co-tenants, so each equals
    # its captured stream above
    n_eager = s["n_slots"]
    with ht.disable_capture():
        res_e = serve_replay(eng, trace[:n_eager])
    eager_same = ([r.tokens for r in res_e["reqs"]]
                  == [r.tokens for r in reqs[:n_eager]])
    require(f"serving path: the eager replay of the trace's first {n_eager} "
            f"requests ({res_e['tokens']} tokens, {res_e['wall_s']:.3f} s) "
            "gives each the captured replay's stream bitwise", eager_same)

    # prefill at P = 512: one request of max_new 1 is one prefill an
    # iteration and no decode step
    prompt = trace[0][1]
    long_prompt = np.resize(prompt, s["max_prompt"])
    pre = {"captured": [], "eager": []}
    for mode in ("captured", "eager", "eager", "captured"):
        with (ht.disable_capture() if mode == "eager"
              else contextlib.nullcontext()):
            for _ in range(3):
                eng.submit(long_prompt, 1)
                t = time.perf_counter()
                eng.step()
                pre[mode].append((time.perf_counter() - t) * 1e3)
    pre_bound = 2 * n_params * s["max_prompt"] / PEAK_OPS[torch.bfloat16]
    pre_ms = {m: min(v) for m, v in pre.items()}

    def prefill_only():
        eng.submit(long_prompt, 1)
        eng.step()

    pre_trace = profile_steps("serving prefill captured", prefill_only,
                              steps=3, fns=fns, cpu=False)
    require("serving prefill captured: the traced window shows and the "
            "counters count no hand-written kernel",
            pre_trace is not None and not pre_trace["kernels"])
    log(f"serving prefill P={s['max_prompt']}: captured "
        f"{pre_ms['captured']:.3f} ms, eager {pre_ms['eager']:.3f} ms (best "
        f"of 6 in turns; all: {pre}), bound {pre_bound * 1e3:.3f} ms "
        f"(operations: 2 x {n_params} params x {s['max_prompt']} tokens at "
        f"989 TFLOP/s)")

    # decode ms/step with every slot decoding
    full = [eng.submit(np.resize(trace[i][1], s["max_prompt"]),
                       s["max_len"] - s["max_prompt"])
            for i in range(s["n_slots"])]
    while eng.scheduler.queue:
        eng.step()
    modes, traces = decode_turns(ht, eng, fns)
    dec_bound = (param_bytes + pool_bytes) / HBM_BYTES_PER_S
    dec = {m: sum(v) / len(v) for m, v in modes.items()}
    log(f"serving decode, {s['n_slots']} slots active: captured "
        f"{dec['captured']:.3f} ms/step, eager {dec['eager']:.3f} (turns: "
        f"{modes}), bound {dec_bound * 1e3:.3f} ms (bytes: params "
        f"{param_bytes / 1e9:.3f} GB + KV pool {pool_bytes / 1e9:.3f} GB at "
        f"3.35 TB/s)")
    for r in full:
        eng.cancel(r.rid)
    require("serving path: trace_counts after the timing "
            f"{eng.trace_counts}", eng.trace_counts == {"prefill": 1,
                                                         "step": 1})

    # the gang twin: the same programs, static batching
    del eng
    free_memory("after the continuous engine")
    gang = engine(gang=True)
    res_g = serve_replay(gang, trace)
    require(f"serving path: the gang twin's streams equal the continuous "
            f"engine's bitwise (sha {res_g['sha']} / {res['sha']}; "
            f"{res_g['stats']['decode_steps']} decode steps against "
            f"{st['decode_steps']}, {res_g['tokens'] / res_g['wall_s']:.1f} "
            "tokens/s)", res_g["sha"] == res["sha"])
    del gang
    free_memory("after the gang twin")

    # greedy_generate against an engine serving the one request alone, on
    # its own geometry (one slot, its prompt's length, its total length):
    # cuBLAS picks a product's kernel by its row count, so a row's bits
    # are the same only between products of the same shape
    p, m = trace[0][1], trace[0][2]
    one = InferenceEngine(ex, model, n_slots=1, max_len=len(p) + m,
                          max_prompt_len=len(p), name=name, seed=seed)
    alone = one.generate_many([p], m)[0]
    del one
    want = greedy_generate(ex, model, p[None], m, name=name)[0, len(p):]
    in_trace = np.asarray(reqs[0].tokens)
    agree = int(np.argmin(np.append(in_trace == want, False)))
    require(f"serving path: greedy_generate gives the one-request engine's "
            f"stream ({m} tokens, prompt {len(p)}) bitwise",
            np.array_equal(alone, want))
    log(f"serving path: the 16-slot engine's stream of that request agrees "
        f"with greedy_generate's for its first {agree} of {m} tokens")
    ex.close()
    del ex, model
    free_memory("after the serving path")
    out = {"path": "serving (mistral-7b, 32 layers)", "bitwise":
           eager_same, "gang_bitwise":
           res_g["sha"] == res["sha"], "tokens_per_sec": tps,
           "latency_s": {k: {q: lat[k][q] for q in ("p50", "p99")}
                         for k in lat},
           "mean_occupancy": st["mean_occupancy"],
           "decode_ms": dec, "decode_bound_ms": dec_bound * 1e3,
           "prefill_ms": pre_ms, "prefill_bound_ms": pre_bound * 1e3,
           "peak_gib": peak / 2**30,
           "params_plus_pool_gib": (param_bytes + pool_bytes) / 2**30,
           "graph_pool_gib": {k: v / 2**30 for k, v in graphs.items()},
           "trace_counts": {"prefill": 1, "step": 1},
           **{f"{m}_trace": {k: t[k] for k in ("busy_ms", "idle",
                                               "wall_ms", "launches")}
              for m, t in traces.items() if t},
           "prefill_trace": {k: pre_trace[k] for k in ("busy_ms", "idle",
                                                       "wall_ms",
                                                       "launches")}}
    captures.append(out)
    return out


def cross_device_serving(ht, models, seed):
    """The small f32 Llama (2 layers, hidden 256, 8/2 heads, vocab 1024)
    served on the card and on the CPU from the same params (TF32 off):
    the slot adapter's prefill and teacher-forced decode logits, and the
    engines' streams on a seeded trace."""
    from hetu_tpu_torch.serving import InferenceEngine, LlamaSlotAdapter
    c = models.LlamaConfig(seq_len=64, **SERVE_SMALL)
    with ht.name_scope():
        ex_g, model_g = served_llama(ht, models, c, "small", seed,
                                     torch.float32)
    with ht.name_scope():
        ex_c, model_c = served_llama(ht, models, c, "small", seed,
                                     torch.float32, device="cpu")
    ex_c.load_params({k: v.cpu().numpy() for k, v in ex_g.params.items()})
    trace = serve_trace(seed + 1, 12, c.vocab_size, 8, 32, 8, 24)
    streams = {}
    for dev, ex, model in (("cuda", ex_g, model_g), ("cpu", ex_c, model_c)):
        eng = InferenceEngine(ex, model, n_slots=4, max_len=64,
                              max_prompt_len=32, name="small", device=dev)
        streams[dev] = [r.tokens for r in serve_replay(eng, trace)["reqs"]]
    # logits: a prompt's prefill, then each stream token teacher-forced
    prompt, toks = trace[0][1], streams["cpu"][0]
    logits = {}
    for dev, ex in (("cuda", ex_g), ("cpu", ex_c)):
        ad = LlamaSlotAdapter(c, "small")
        k = torch.zeros(c.num_layers, 1, c.num_kv_heads, 64,
                        c.hidden_size // c.num_heads, device=dev)
        v = torch.zeros_like(k)
        with torch.no_grad():
            out = [ad.prefill(ex.params, torch.as_tensor(
                prompt[None], device=dev), k, v,
                torch.zeros(1, dtype=torch.long, device=dev))]
            for i, tok in enumerate(toks[:-1]):
                out.append(ad.decode(
                    ex.params, torch.tensor([tok], device=dev),
                    torch.tensor([len(prompt) + i], device=dev), k, v))
        logits[dev] = torch.cat([o.cpu() for o in out])
    check("cross-device f32 serving logits (prefill rows and teacher-forced "
          "decode steps)", logits["cuda"], logits["cpu"], 5e-5,
          "f32 on both sides (TF32 off), products and softmax sums in "
          "another order")
    require(f"cross-device f32 serving: the card's streams equal the CPU's "
            f"({sum(map(len, streams['cpu']))} tokens)",
            streams["cuda"] == streams["cpu"])
    ex_g.close()
    free_memory("after the cross-device serving check")


# -- phase 3i: GPT training ------------------------------------------------

# bench_gpt_e2e (bench.py:303-345): GPT-small (GPT_CONFIGS["gpt-small"]:
# hidden 768, 12 layers, 12 heads of 64), V=50257, B=8 S=1024; nothing cut
GPT_SMALL = dict(preset="gpt-small", L=12, B=8, S=1024, V=50257,
                 routes=WGMMA)
# GPT-3 2.7B's published widths (GPT_CONFIGS["gpt-2.7b"]; Brown et al. 2020,
# Table 2.1: d_model 2560, 32 heads of 80, context 2048) at bench_gpt_layer's
# B=2 S=2048 (bench.py:198); 8 of its 32 layers: the whole model's f32
# masters, gradients, Adam moments, update temporaries and bf16 copy take
# ~34 bytes a param, ~90 GB for 2.65 B params, more than the card holds
GPT_27B = dict(preset="gpt-2.7b", L=8, B=2, S=2048, V=50257,
               routes=WGMMA)


def gpt_attention_shape(models, c):
    """(B, heads, S, d) of the attention of the GPT path ``c``."""
    w = models.GPT_CONFIGS[c["preset"]]
    return (c["B"], w["num_heads"], c["S"],
            w["hidden_size"] // w["num_heads"])


def build_gpt(ht, models, c, dropout):
    """bench_gpt_e2e's loss graph, ``GPTLMHeadModel(...).loss(ids,
    labels)``, at the widths of the preset ``c["preset"]`` (or ``c["H"]``
    and ``c["heads"]``), ``c["L"]`` layers, vocab ``c["V"]``, context
    ``c["S"]``: (loss, ids, labels)."""
    widths = (models.GPT_CONFIGS[c["preset"]] if "preset" in c else
              dict(hidden_size=c["H"], num_heads=c["heads"]))
    cfg = models.GPTConfig(vocab_size=c["V"], hidden_size=widths[
        "hidden_size"], num_layers=c["L"], num_heads=widths["num_heads"],
        seq_len=c["S"], dropout_prob=dropout)
    ids = ht.placeholder_op("gpt_ids", (c["B"], c["S"]), dtype=np.int32)
    labels = ht.placeholder_op("gpt_labels", (c["B"], c["S"]),
                               dtype=np.int32)
    return models.GPTLMHeadModel(cfg).loss(ids, labels), ids, labels


def gpt_paths(ht, models, fns, rng, steps, seed, captures):
    """Phase 3i: GPT causal-LM training through ``Executor({"train": [loss,
    AdamW(1e-4, wd 0.01).minimize(loss)]}, compute_dtype=bfloat16)`` over
    f32 masters, dropout 0.1 (hidden and attention, in the flash kernels),
    Zipf ids with the ids rolled by one as labels: GPT-small at
    bench_gpt_e2e's full size and GPT-3 2.7B's widths, depth cut (d =
    80), both on the wgmma flash kernels; each with
    phase 3f's captured-against-eager checks (appended to ``captures``).
    Returns {label: (ms/step, launches)}."""
    out = {}
    for label, c, n, warmup, phase_f in (
            ("gpt-small path", GPT_SMALL, steps, 3, {}),
            ("gpt-2.7b-width path", GPT_27B, 3, 2, dict(n=3, rs=5, turn=2))):
        ex, step, init_s, feed = lm_executor(
            ht, lambda: build_gpt(ht, models, c, dropout=0.1), rng, c, seed)
        w = models.GPT_CONFIGS[c["preset"]]
        h, heads = w["hidden_size"], w["num_heads"]
        log(f"{label}: GPT {c['preset']} widths (hidden {h}, {heads} heads "
            f"of {h // heads}, FFN {4 * h}), {c['L']} of {w['num_layers']} "
            "layers, "
            f"V={c['V']} B={c['B']} S={c['S']}, dropout 0.1, AdamW(1e-4, wd "
            f"0.01) over f32 masters, bf16 compute, "
            f"{sum(p.numel() for p in ex.params.values())} params, init "
            f"{init_s:.1f} s")
        _, ms, launches = run_path(
            label, step, fns, n, c["B"], expect_launches(
                **flash_launches(c["L"] * n, routes=c["routes"]),
                softmax_ce_fwd=n, softmax_ce_bwd=n), warmup=warmup)
        log(f"{label}: {c['B'] * c['S'] * 1000 / ms:.1f} tokens/s, "
            f"{c['B'] * 1000 / ms:.3f} samples/s, {ms:.3f} ms/step")
        profile_steps(label, step, steps=1)
        captures.append(capture_phase(ht, label, ex, "train", feed, fns,
                                      **phase_f))
        e, cap = captures[-1]["eager"], captures[-1]["captured"]
        log(f"{label}: peak memory {e['peak_gib']:.2f} GiB eager, "
            f"{cap['peak_gib']:.2f} GiB captured with its graph pool")
        out[label] = (ms, launches)
        ex.close()
        del ex, step, feed
        free_memory(f"after the {label}")
    return out


def cross_device_gpt(ht, models, fns, rng, seed):
    """One f32 training step of a small GPT (2 layers, hidden 256, 4 heads
    of 64, V=1024, B=2, S=256, dropout off) from the same params on the
    card (the flash kernels, f32 on the plain-FMA route, and the CE
    kernels, both admitted by their gates at these shapes) and on the CPU
    (the plain composition and plain versions): loss, every gradient (the
    tied table's from the lookup and the head together) and each param's
    change in one AdamW step."""
    c = dict(H=256, heads=4, L=2, B=2, S=256, V=1024)
    cross_device_lm(
        ht, "GPT", lambda: build_gpt(ht, models, c, dropout=0.0), c, fns,
        rng,
        seed + 12, (expect_launches(
            **flash_launches(2, routes=SIMT), softmax_ce_fwd=1,
            softmax_ce_bwd=1), "the flash kernels 2/2/2 (f32: the "
            "plain-FMA route) and the CE kernels 1/1"),
        ("f32 on both sides; a loss of ~7 whose 1024-way logsumexp and "
         "mean over 512 tokens sum in another order (1e-6 relative)",
         "the flash kernels, the GEMMs, the lookup's sums and the CE"))


def adamw_change_checks(label, xs, init, ex_gpu, ex_cpu, g_gpu, g_cpu, lr,
                        eps):
    """Each param's change in a first AdamW step, card against CPU.  The
    step moves an entry by lr (g / (|g| + eps) + wd p), whose slope in g,
    lr eps / (|g| + eps)^2, reaches lr / eps at g = 0: a gradient
    difference inside its tolerance moves the update of an entry with |g|
    near eps by a large share of lr.  So entries whose |g| exceeds 100 eps
    on both sides are held to slice E's 1e-4 relative in the 2-norm, a
    param at a time; the others each to the mean-value bound of that slope
    between the two gradients, lr |g_gpu - g_cpu| eps / (m + eps)^2 (m the
    smaller |g|, 0 where the signs differ), plus an ulp of the param and
    1e-6 lr of f32 rounding.  Logs the count and |g| of the small
    entries and the error they add to the whole-param reading."""
    worst, small_all, whole = {}, [], {}
    bad_small = []
    for x, gg, gc in zip(xs, g_gpu, g_cpu):
        p0 = init[x.name]
        gg = gg.cpu()
        change_cpu = ex_cpu.params[x.name] - p0
        change_gpu = ex_gpu.params[x.name].cpu() - p0
        diff = (change_gpu - change_cpu).abs()
        big = (gg.abs() > 100 * eps) & (gc.abs() > 100 * eps)
        if big.any():
            worst[x.name] = (diff[big].norm()
                             / change_cpu[big].norm()).item()
        whole[x.name] = (diff.norm() / change_cpu.norm()).item()
        small = ~big
        if small.any():
            m = torch.where(gg * gc > 0, torch.minimum(gg.abs(), gc.abs()),
                            torch.zeros_like(gc))
            tol = (lr * (gg - gc).abs() * eps / (m + eps) ** 2
                   + torch.finfo(torch.float32).eps * p0.abs() + 1e-6 * lr)
            if not (diff[small] <= tol[small]).all():
                bad_small.append(x.name)
            small_all.append((x.name, int(small.sum()),
                              gc[small].abs().max().item(),
                              diff[small].max().item(),
                              (diff[small] / tol[small]).max().item()))
    name = max(worst, key=worst.get)
    wname = max(whole, key=whole.get)
    log(f"{label}: whole-param change error {whole[wname]:.3e} ({wname}) in "
        f"the 2-norm, relative, {worst.get(wname, 0.0):.3e} over its entries "
        f"with |g| > {100 * eps:g}; entries with |g| <= {100 * eps:g}: "
        + ("; ".join(f"{n} {c} entries, max |g| {g:.3e}, max |diff| "
                     f"{d:.3e} ({r:.3f} of its bound)"
                     for n, c, g, d, r in small_all) or "none"))
    require(f"{label} params after one AdamW step, entries with |g| > "
            f"{100 * eps:g} on both sides: worst change error "
            f"{worst[name]:.3e} ({name}) in the 2-norm, relative, tol 1e-4 "
            "(f32 update from gradients within the tolerance above)",
            worst[name] <= 1e-4)
    require(f"{label} params after one AdamW step, entries with |g| <= "
            f"{100 * eps:g}: each within lr |dg| eps / (m + eps)^2 + ulp(p) "
            f"+ 1e-6 lr {'bad: ' + str(bad_small) if bad_small else ''}",
            not bad_small)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import hetu_tpu_torch as ht
    import hetu_tpu_torch.layers as layers
    import hetu_tpu_torch.models as models
    import hetu_tpu_torch.parallel as htp
    from hetu_tpu_torch.ops.kernels import build
    from hetu_tpu_torch.ops.kernels import flash_attention as fa
    from hetu_tpu_torch.ops.kernels import softmax_ce as ce
    from hetu_tpu_torch.ops.kernels import moe_dispatch as md
    from hetu_tpu_torch.ops.kernels import sparse_densify as sd

    # -- phase 1: card and build -------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels(build, ce)

    # -- phase 2: kernels against their plain versions ----------------------
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    dropout_checks(rng, fa)
    kernel_dropout_checks(rng, fa)
    # the d = 80 checks draw from a generator of their own, so that the
    # other checks keep the inputs they had before them
    rng80 = np.random.default_rng((args.seed, 80))
    flash_repeat_checks(rng, fa, rng80)
    fwd_err = flash_fwd_checks(rng, fa, rng80)
    bwd_err = flash_bwd_checks(rng, fa, rng80)
    block_err = block_checks(rng, fa, rng80)
    ring_checks(rng, fa, htp)
    ce_err, ce_bwd_err = ce_checks(rng, ce)
    pw_err = pack_write_checks(rng, sd)
    packed_lookup_checks(rng, sd)
    rg_err = row_gather_checks(rng, md)
    torch.cuda.empty_cache()
    if failures:
        log(f"FAILED checks: {failures}")
        return 1

    # -- phase 3: the main paths --------------------------------------------
    fns = counters(fa, ce, sd, md)
    capture_negative_check(ht)
    B, S, L = 64, 512, 12
    steps = args.steps
    loss = build_bert(ht, models, B, S, L)
    t0 = time.perf_counter()
    ex = ht.Executor({"validate": [loss]}, compute_dtype=torch.bfloat16,
                     device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    log(f"eval path: BERT-base B={B} S={S} L={L}, "
        f"{sum(p.numel() for p in ex.params.values())} params, init "
        f"{time.perf_counter() - t0:.1f} s")
    feed = bert_batch(rng, B, S, "cuda")
    eval_step = lambda: ex.run("validate", feed_dict=feed)[0]  # noqa: E731
    run_path("eval path", eval_step, fns, steps, B,
             expect_launches(**flash_launches(L * steps, bwd=False),
                             softmax_ce_fwd=steps))
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps("eval path", eval_step)
    captures = [capture_phase(ht, "eval path", ex, "validate", feed, fns)]
    ex.close()  # frees params now: the executor is in a reference cycle
    del ex, eval_step
    free_memory("after the eval path")

    loss = build_bert(ht, models, B, S, L, dropout=0.1)
    opt = ht.AdamWOptimizer(learning_rate=1e-4, weight_decay=0.01)
    train_op = opt.minimize(loss)
    t0 = time.perf_counter()
    ex = ht.Executor({"train": [loss, train_op]},
                     compute_dtype=torch.bfloat16, device="cuda",
                     seed=args.seed, rng_impl="rbg")
    torch.cuda.synchronize()
    log(f"train path: BERT-base B={B} S={S} L={L} dropout 0.1, AdamW(1e-4, "
        f"wd 0.01) over f32 masters, bf16 compute, init "
        f"{time.perf_counter() - t0:.1f} s")

    def train_step():
        val, none = ex.run("train", feed_dict=feed)
        if none is not None:
            raise RuntimeError("run('train') must return [loss, None]")
        return val

    _, train_ms, train_launches = run_path(
        "train path", train_step, fns, steps, B,
        expect_launches(**flash_launches(L * steps), softmax_ce_fwd=steps,
                        softmax_ce_bwd=steps))
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps("train path", train_step, steps=1)
    captures.append(capture_phase(ht, "train path", ex, "train", feed, fns))
    ex.close()
    del ex, feed, train_step
    free_memory("after the train path")

    ctr = ctr_paths(ht, models, fns, rng, steps, args.seed, captures)
    checkpoint_roundtrip(ht, models, rng, args.seed)
    if failures:
        log(f"FAILED: {failures}")
        return 1
    moe_ms, moe_launches = moe_paths(ht, layers, fns, rng, steps, args.seed,
                                     captures)
    if failures:
        log(f"FAILED: {failures}")
        return 1
    llama = llama_paths(ht, models, htp, fns, rng, steps, args.seed,
                        captures)
    if failures:
        log(f"FAILED: {failures}")
        return 1
    resnet_ms, _ = resnet_paths(ht, models, fns, rng, steps, args.seed,
                                captures)
    resnet_layouts(ht, models, rng, args.seed)
    conv_times()
    if failures:
        log(f"FAILED: {failures}")
        return 1
    serving = serving_paths(ht, models, fns, rng, args.seed, captures)
    if failures:
        log(f"FAILED: {failures}")
        return 1
    gpt = gpt_paths(ht, models, fns, rng, steps, args.seed, captures)
    if failures:
        log(f"FAILED: {failures}")
        return 1

    times = kernel_times(rng, fa, ce, B, S)
    torch.cuda.empty_cache()
    pw_times = pack_write_times(rng, sd)
    times["row_gather"] = row_gather_times(rng, md)
    cross_device(ht, models, rng, args.seed)
    cross_device_ctr(ht, models, rng, args.seed)
    cross_device_moe(ht, layers, md, rng, args.seed)
    blocks = block_times(rng, fa)
    times.update(blocks["full"])
    c = LLAMA
    times.update(causal_flash_times(rng, fa, c["B"], c["heads"], c["S"],
                                    c["H"] // c["heads"], 1.0, WGMMA))
    # GPT's attention: GPT-small's heads with dropout and GPT-3 2.7B's
    # d = 80, on the wgmma kernels; GPT's LM-head CE
    gpt_times = [causal_flash_times(rng, fa, b, h, s, d, keep, routes)
                 for (b, h, s, d), keep, routes in GPT_FLASH]
    ce_times(rng, ce, GPT_SMALL["B"] * GPT_SMALL["S"], GPT_SMALL["V"])
    cross_device_llama(ht, models, htp, fns, rng, args.seed)
    cross_device_resnet(ht, models, rng, args.seed)
    cross_device_serving(ht, models, args.seed)
    cross_device_gpt(ht, models, fns, rng, args.seed)
    if failures:
        log(f"FAILED: {failures}")
        return 1

    # -- phase 4: result ----------------------------------------------------
    src = "hetu_tpu_torch/"
    rows = [
        ("flash_attention_fwd", "cuda", src + "csrc/flash_attention_fwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:266",
         fwd_err[torch.bfloat16, 0.9]),
        ("flash_attention_bwd_dq", "cuda", src + "csrc/flash_attention_bwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:448", bwd_err["dq"]),
        ("flash_attention_bwd_dkv", "cuda",
         src + "csrc/flash_attention_bwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:463", bwd_err["dkv"]),
        ("flash_attention_block_fwd", "cuda",
         src + "csrc/flash_attention_fwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:551", block_err["fwd"]),
        ("flash_attention_block_bwd_dq", "cuda",
         src + "csrc/flash_attention_bwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:568", block_err["dq"]),
        ("flash_attention_block_bwd_dkv", "cuda",
         src + "csrc/flash_attention_bwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:568", block_err["dkv"]),
        ("softmax_ce_fwd", "triton", src + "ops/kernels/softmax_ce.py",
         "hetu_tpu/ops/pallas/softmax_ce.py:109", ce_err),
        ("softmax_ce_bwd", "triton", src + "ops/kernels/softmax_ce.py",
         "hetu_tpu/ops/pallas/softmax_ce.py:140", ce_bwd_err),
        ("pack_write", "cuda", src + "csrc/pack_write.cu",
         "hetu_tpu/ops/pallas/sparse_densify.py:152", pw_err),
        ("row_gather", "cuda", src + "csrc/row_gather.cu",
         "hetu_tpu/ops/pallas/moe_dispatch.py:124", rg_err),
        ("flash_fwd_wgmma", "cuda", src + "csrc/flash_attention_fwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:266", WGMMA_ERR["fwd"]),
        ("flash_bwd_dq_wgmma", "cuda", src + "csrc/flash_attention_bwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:448", WGMMA_ERR["dq"]),
        ("flash_bwd_dkv_wgmma", "cuda", src + "csrc/flash_attention_bwd.cu",
         "hetu_tpu/ops/pallas/flash_attention.py:463", WGMMA_ERR["dkv"]),
    ]
    # launches: each kernel's own training path (BERT, W&D at 337,000 rows
    # for pack_write, bench_moe for row_gather, the cp=4 Llama for the block
    # kernels, the mesh-less Llama for the wgmma kernels, which the BERT and
    # cp=4 paths run too), with path i's GPT-small and GPT-3 2.7B-width
    # steps added to the flash and CE kernels' and to the three wgmma
    # kernels'; row_gather's
    # times are the sums over one bench_moe step's three launches; the block
    # kernels' times are the full block's at the witness's block shape, the
    # wgmma kernels' at the mesh-less Llama's causal shape
    cp_launches = llama["llama cp=4 path"][1]
    meshless = llama["llama mesh-less path"][1]
    gpt_launches = [v[1] for v in gpt.values()]
    launches = dict(
        {name: train_launches[name] + sum(g[name] for g in gpt_launches)
         for name in KERNEL_NAMES[:3] + ("softmax_ce_fwd", "softmax_ce_bwd")},
        pack_write=ctr[WDL_ROWS][1]["pack_write"],
        row_gather=moe_launches["row_gather"],
        **{name: cp_launches[name] for name in KERNEL_NAMES
           if name.startswith("flash_attention_block")},
        **{name: meshless[name] + sum(g[name] for g in gpt_launches)
           for name in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                        "flash_bwd_dkv_wgmma")})
    times["pack_write"] = pw_times[WDL_ROWS]
    kernels = [{"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": err, "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound"][0],
                "bound_by": times[name]["bound"][1],
                "library_ms": times[name]["library_ms"]}
               for name, route, source, replaces, err in rows]
    log(f"train path: {train_ms:.3f} ms/step; wdl path: "
        + ", ".join(f"{rows} rows {ms:.3f} ms/step"
                    for rows, (ms, _) in ctr.items())
        + f"; moe path: {moe_ms:.3f} ms/step; "
        + "; ".join(f"{label}: {v[0]:.3f} ms/step"
                    for label, v in llama.items())
        + f"; resnet18 path: {resnet_ms:.3f} ms/step; serving path: "
        f"{serving['tokens_per_sec']:.1f} tokens/s, decode "
        f"{serving['decode_ms']['captured']:.3f} ms/step; "
        + "; ".join(f"{label}: {v[0]:.3f} ms/step"
                    for label, v in gpt.items()))
    # path i's flash kernels at its own shapes and routes, beside the
    # kernels line, whose flash_attention_* entries sum launches over both
    # routes and carry BERT's wgmma times: launches are those of the path
    # that runs the shape (i1 and i2, each on the wgmma kernels) at its
    # attention dropout, keep 0.9; none at keep 1
    gpt_paths_by_shape = {gpt_attention_shape(models, GPT_SMALL):
                          "gpt-small path",
                          gpt_attention_shape(models, GPT_27B):
                          "gpt-2.7b-width path"}
    gpt_flash = [
        {"name": name, "route": "cuda", "shape": list(shape),
         "causal": True, "keep": keep,
         "path": gpt_paths_by_shape[shape] if keep < 1.0 else None,
         "launches": (gpt[gpt_paths_by_shape[shape]][1][name]
                      if keep < 1.0 else 0),
         "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"]}
        for (shape, keep, _), t in zip(GPT_FLASH, gpt_times)
        for name, r in t.items()]
    log(f"run: {time.perf_counter() - T0:.1f} s from the start to the "
        "result")
    log(json.dumps({"gpt_flash": gpt_flash}))
    log(json.dumps({"capture": captures}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
