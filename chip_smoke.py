#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hetu_tpu_torch) end to end on one card.

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each fatal on failure (exit 1, no result lines):

1. Card and build: the card's name and power limit, and the build of every
   kernel of the paths from the sources in this checkout: one nvcc per CUDA
   source (flash-attention forward with dropout; dQ and dK/dV backward; the
   packed-gradient write; the MoE row gather), all started together, then
   Triton's compiler for the softmax-CE forward and backward.
2. Kernels against their plain PyTorch versions on the card, on the same
   inputs: the dropout keep bits bitwise; the flash forward (with and
   without dropout), dQ, dK/dV and the CE forward and backward at the main
   paths' shapes and at ragged, causal, fully-masked, wide-head and f32
   ones; ``pack_write`` at the W&D shapes (uniform, Zipf-skewed, negative
   and tail-line ids, Criteo's table, no ids), bitwise on lines with one
   contributor and against itself across two runs; the packed lookup's
   forward on the card against the CPU, with a NaN and an Inf row and
   negative ids; ``row_gather`` bitwise at the MoE dispatch and combine
   shapes of bench_moe and of the Mixtral layer, f32 and bf16, with
   out-of-range indices, and one backward through ``RowGatherFn``.  Each
   check prints its max |error| beside its stated tolerance.
3. Main paths, each driven with the seven launch counters set to 0 just
   before its timed steps and read just after:
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
   d. bench_moe's training step (BASELINE config 5): ``MoELayer(512, 2048,
      num_experts=8, k=2, capacity_factor=1.25)``, gelu experts, loss
      ``mse_loss_op(moe(x), y) + 0.01 * moe.aux_loss()`` under
      ``Executor({"train": [loss, AdamOptimizer(1e-3).minimize(loss)]})``
      at B=8 S=1024, f32: 3 warm-up and ``--steps`` timed steps, 3
      ``row_gather`` launches per step (the dispatch and two combines; the
      backward is a scatter-add), every loss finite, tokens/s; then the
      same 3 steps twice from the same params, bitwise equal.  Then the
      Mixtral-8x7B MoE layer (hidden 4096, FFN 14336, 8 swiglu experts,
      top-2, capacity 4.0) at B=1 S=2048, f32, Adam: 1 warm-up and 3
      timed steps, 3 ``row_gather`` launches per step.
   Each path's step is broken down by kernel class under torch.profiler.
   Then each kernel is timed at the paths' shapes beside its bound, its
   plain version and one PyTorch library call (a yardstick only; the port
   never calls it), and one f32 training step of BERT (batch 2, 2 layers,
   full widths, dropout off), one of W&D (337,000 rows) and one of a small
   MoE layer (H=128, F=256, 4 experts, 64 tokens) run from the same params
   on the card (kernels) and on the CPU (plain versions): loss, every
   gradient and every updated param are compared.
4. Result: a {"kernels": [...]} JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import subprocess
import sys
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

failures = []


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


def require(name, ok):
    log(f"check {name}: {'ok' if ok else 'FAIL'}")
    if not ok:
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


def device_ms(fn, iters=100, cold=False):
    """Device time of ``fn`` in ms per call: the time of the kernels it
    launches, summed under torch.profiler over ``iters`` calls.  For calls
    whose launch costs the host longer than their kernels take the card,
    where back-to-back CUDA events time the host.  ``cold``: each call
    finds the 50 MB L2 cache holding none of its inputs (a 256 MB pass
    over another buffer runs before it and is left out of the sum)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda") \
        if cold else None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if cold:
                flush.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not (cold and "bitwise_not" in e.key)) / iters / 1e3


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

def build_kernels(build, ce):
    """One nvcc per CUDA source, all at once; then the Triton kernels."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        libs = dict(zip(CUDA_SOURCES, pool.map(build.build, CUDA_SOURCES)))
    log(f"build: nvcc {' '.join(CUDA_SOURCES)} in parallel "
        f"{time.perf_counter() - t0:.1f} s")
    for source, lib in libs.items():
        with open(lib + ".log") as f:
            for line in f:
                if "Used" in line or "spill" in line.lower():
                    log(f"  {source}: " + line.strip())
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


def flash_fwd_checks(rng, fa):
    """Phase 2b: the CUDA flash forward against its plain version."""
    def case(label, B, H, S, D, dtype, mask=None, causal=False, keep=1.0):
        q, k, v = (randn(rng, (B, H, S, D), dtype) for _ in range(3))
        seed = seed_tensor(rng) if keep < 1.0 else None
        o, lse = fa.flash_attention_fwd(q, k, v, mask=mask, causal=causal,
                                        dropout_keep=keep, seed=seed)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask,
                                              causal=causal,
                                              dropout_keep=keep, seed=seed)
        name = f"flash fwd {label} {str(dtype).split('.')[-1]}"
        err = check(f"{name} o", o, o_p, *FWD_TOL[dtype])
        check(f"{name} lse", lse, lse_p, *LSE_TOL)
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
        case("[1,2,256,128] head-128", 1, 2, 256, 128, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"))
        case("[1,2,256,256] wide-head", 1, 2, 256, 256, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"))
        case("[1,2,256,512] widest-head causal", 1, 2, 256, 512, dtype,
             causal=True)
        # more (batch, head) pairs than the 65535 blocks of a grid's y axis
        case("[4100,16,128,32] many-heads", 4100, 16, 128, 32, dtype,
             mask=bert_mask(rng, 4100, 128, "cuda"))
    return errs


def flash_bwd_checks(rng, fa):
    """Phase 2c: the dQ and dK/dV kernels against the plain backward, from
    the same forward outputs (o, lse) and cotangent."""
    def case(label, B, H, S, D, dtype, mask=None, causal=False, keep=1.0):
        q, k, v, do = (randn(rng, (B, H, S, D), dtype) for _ in range(4))
        seed = seed_tensor(rng) if keep < 1.0 else None
        o, lse = fa.flash_attention_fwd(q, k, v, mask=mask, causal=causal,
                                        dropout_keep=keep, seed=seed)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do, mask=mask,
                                       causal=causal, dropout_keep=keep,
                                       seed=seed)
        torch.cuda.synchronize()
        plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, mask=mask,
                                             causal=causal,
                                             dropout_keep=keep, seed=seed)
        name = f"flash bwd {label} {str(dtype).split('.')[-1]}"
        errs = [check(f"{name} {g}", got, want, *BWD_TOL[dtype])
                for g, got, want in zip(("dq", "dk", "dv"), grads, plain)]
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
        case("[1,2,256,128] head-128 keep 0.9", 1, 2, 256, 128, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"), keep=0.9)
        case("[1,2,256,256] wide-head causal keep 0.9", 1, 2, 256, 256,
             dtype, causal=True, keep=0.9)
        case("[1,2,256,512] widest-head", 1, 2, 256, 512, dtype,
             mask=bert_mask(rng, 1, 256, "cuda"))
    return errs


def ce_checks(rng, ce):
    """Phase 2d: the Triton CE forward and backward against their plain
    versions, ~15% ignored labels."""
    why = "f32 online max/sum-exp over the same upcast values; order differs"
    bwd_tol = {torch.bfloat16: (1e-6, "the same f32 formula on both sides; "
                                "exp may differ in its last f32 bit, which "
                                "can flip the bf16 rounding (one ulp)",
                                2.0 ** -7),
               torch.float32: (1e-6, "the same f32 formula; exp may differ "
                               "in its last bits", 1e-5)}

    def case(N, V, dtype):
        x = randn(rng, (N, V), torch.float32).mul_(3.0).to(dtype)
        labels = rng.integers(0, V, N)
        labels[rng.random(N) < 0.15] = -1
        labels = torch.from_numpy(labels.astype(np.int32)).cuda()
        g = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).cuda()
        loss, lse = ce.softmax_ce_fwd(x, labels)
        dx = ce.softmax_ce_bwd(x, labels, lse, g)
        torch.cuda.synchronize()
        loss_p, lse_p = ce.softmax_ce_plain(x, labels)
        dx_p = ce.softmax_ce_bwd_plain(x, labels, lse, g)
        name = f"ce [{N},{V}] {str(dtype).split('.')[-1]}"
        err = check(f"{name} loss", loss, loss_p, 2e-4, why)
        check(f"{name} lse", lse, lse_p, 2e-4, why)
        err_bwd = check(f"{name} dx", dx, dx_p, *bwd_tol[dtype])
        require(f"{name} dx zero on ignored rows and in the logits' dtype",
                bool((dx[labels == -1] == 0).all()) and dx.dtype == dtype)
        return err, err_bwd

    errs = case(8192, 30522, torch.bfloat16)
    case(300, 3000, torch.bfloat16)
    case(300, 3000, torch.float32)
    return errs


def ctr_ids(rng, kind, m, n):
    """m ids in [0, n) of one kind: uniform, Zipf-skewed (s = 1.05, a few
    ids take most of the draws), 30% negative (padding), or half of them
    on the last id."""
    ids = rng.integers(0, n, m)
    if kind == "zipf":
        ids = np.minimum(rng.zipf(1.05, m) - 1, n - 1)
    elif kind == "negative":
        ids[rng.random(m) < 0.3] = -1
    elif kind == "tail":
        ids[rng.random(m) < 0.5] = n - 1
    return ids.astype(np.int32)


def pack_write_checks(rng, sd):
    """Phase 2e: the pack_write kernel against ``pack_write_plain`` on the
    card (scatter-add with atomics) and on the CPU (sequential); returns
    the max |error| at the main path's shape."""
    p337 = sd.packed_rows(WDL_ROWS, 16)
    cases = (("uniform (main path)", "uniform", 3328, p337),
             ("zipf", "zipf", 3328, p337), ("zipf", "zipf", 65536, p337),
             ("30% negative", "negative", 3328, p337),
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
        abs_sum = sd.pack_write_plain(ids, lines.abs(), p_rows)
        torch.cuda.synchronize()
        name = f"pack_write {label} M={m} p_rows={p_rows}"
        counts = torch.from_numpy(np.bincount(
            ids_np[ids_np >= 0], minlength=p_rows)[:p_rows]).cuda()
        single, merged = counts == 1, counts > 1
        # both sides add the same k terms, each in its own order: two
        # recursive sums differ by at most 2 k 2^-24 sum|term|
        diff = (got - plain).abs()
        tol = 2.0 * counts[:, None].float() * 2.0 ** -24 * abs_sum
        err = diff.max().item() if m else 0.0
        log(f"check {name}: {int(single.sum())} single and "
            f"{int(merged.sum())} merged lines (largest run "
            f"{int(counts.max())}), max_abs_err={err:.3e} vs the card's "
            "index_add_, tol 0 on single lines and 2*k*2^-24*sum|term| on "
            "merged ones (atomics add in another order)")
        require(f"{name}: two runs bitwise equal", torch.equal(got, again))
        require(f"{name}: single lines bitwise equal to plain",
                torch.equal(got[single], plain[single]))
        require(f"{name}: merged lines within tolerance",
                bool((diff <= tol).all()))
        require(f"{name}: lines with no id stay zero",
                bool((got[counts == 0] == 0).all()))
        cpu = sd.pack_write_plain(ids.cpu(), lines.cpu(), p_rows)
        n_diff = int((got.cpu() != cpu).any(dim=1).sum())
        require(f"{name}: bitwise equal to the CPU's sequential index_add_ "
                f"(the stable sort keeps each run in input order; "
                f"{n_diff} lines differ)", n_diff == 0)
        if main_err is None:
            main_err = err
        del got, again, plain, abs_sum, diff, tol, cpu
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


def bert_batch(rng, B, S, device):
    """A pretraining batch: random ids, ~15% MLM positions, padding."""
    V = 30522
    lengths = rng.integers(S // 2, S + 1, B)
    am = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    mlm = np.full(B * S, -1, np.int64)
    pos = (rng.random(B * S) < 0.15) & (am.reshape(-1) > 0)
    mlm[pos] = rng.integers(0, V, pos.sum())
    arrays = {"input_ids": rng.integers(0, V, (B, S)),
              "token_type_ids": (np.arange(S)[None, :]
                                 >= (lengths[:, None] // 2)).astype(np.int64),
              "attention_mask": am, "mlm_labels": mlm,
              "nsp_labels": rng.integers(0, 2, B)}
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def counters(fa, ce, sd, md):
    """The seven launch counters of the paths' kernels."""
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "softmax_ce_fwd": ce.softmax_ce_fwd,
            "softmax_ce_bwd": ce.softmax_ce_bwd,
            "pack_write": sd.pack_write_kernel,
            "row_gather": md.row_gather_kernel}


def expect_launches(**per_run):
    """Expected launches of every counter: the named ones, 0 for the rest."""
    names = ("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv", "softmax_ce_fwd", "softmax_ce_bwd",
             "pack_write", "row_gather")
    return {name: per_run.get(name, 0) for name in names}


def run_path(label, step, fns, steps, B, expect, warmup=3, unit="samples"):
    """``warmup`` steps, then ``steps`` timed steps with the launch counters
    zeroed just before and read just after; returns (losses of every step,
    ms/step, launches).  ``B`` counts the ``unit``s of a step."""
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for fn in fns.values():
        fn.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        losses.append(step())
    end.record()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    ms = start.elapsed_time(end) / steps
    losses = [float(v) for v in losses]
    log(f"{label}: {ms:.3f} ms/step, {1000.0 / ms:.2f} steps/s, "
        f"{B * 1000.0 / ms:.1f} {unit}/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (resident "
        f"between steps {resident / 2**30:.2f} GiB), launches {launches} "
        f"over {steps} steps")
    log(f"{label}: losses {' '.join(f'{v:.6f}' for v in losses)}")
    require(f"{label}: {len(losses)} losses finite",
            all(math.isfinite(v) for v in losses))
    require(f"{label}: launch counts {expect}", launches == expect)
    return losses, ms, launches


def profile_steps(label, step, steps=2, top=12):
    """Where a path's step time goes: device time by kernel under
    torch.profiler, and the device's idle share of the traced window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log(f"profile {label}: the profiler saw no device time")
        return
    log(f"profile {label}: {steps} steps, {wall_us / steps / 1e3:.3f} "
        f"ms/step wall (traced), device busy {busy_us / steps / 1e3:.3f} "
        f"ms/step, idle share {max(0.0, 1 - busy_us / wall_us):.3f}, "
        f"{sum(e.count for e in kernels) // steps} kernel launches/step")
    # kernel classes by name: the seven kernels, the id sort, cuBLAS GEMMs,
    # reductions (layer-norm moments, means, sums), copies and casts, other
    # elementwise
    classes = (("pack_write", ("pack_write_kernel",)),
               ("row_gather", ("row_gather_kernel",)),
               ("sort (cub radix)", ("Radix", "radix")),
               ("flash_attention_fwd", ("flash_fwd",)),
               ("flash_attention_bwd_dq", ("flash_bwd_dq",)),
               ("flash_attention_bwd_dkv", ("flash_bwd_dkv",)),
               ("softmax_ce_fwd", ("_ce_fwd_kernel",)),
               ("softmax_ce_bwd", ("_ce_bwd_kernel",)),
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


def kernel_times(rng, fa, ce, B, S):
    """Each kernel at the paths' shapes: ms, bound, plain ms, library ms."""
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
    t_fwd = time_ms(lambda: fwd(0.9), 20)
    t_fwd_eval = time_ms(lambda: fwd(1.0), 20)
    t_plain = time_ms(lambda: fa.flash_attention_plain(
        q, k, v, mask=mask, dropout_keep=0.9, seed=seed), 3)
    mask_bf16 = mask.to(bf)
    t_lib = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_bf16), 20)
    out["flash_attention_fwd"] = dict(
        ms=t_fwd, plain_ms=t_plain, library_ms=t_lib,
        bound=bound(4 * n * 2 + mask.numel() * 4 + B * H * S * 4,
                    4 * B * H * S * S * D, bf))
    log(f"kernel flash_attention_fwd [64,12,512,64] bf16: keep 0.9 "
        f"{t_fwd:.4f} ms, keep 1.0 {t_fwd_eval:.4f} ms")

    o, lse = fwd(0.9)
    dsum = (do.float() * o.float()).sum(-1)
    t_dq = time_ms(lambda: fa.flash_attention_bwd_dq(
        q, k, v, do, lse, dsum, mask=mask, dropout_keep=0.9, seed=seed), 20)
    t_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv(
        q, k, v, do, lse, dsum, mask=mask, dropout_keep=0.9, seed=seed), 20)
    t_bwd_plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, mask=mask, dropout_keep=0.9, seed=seed), 3)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask_bf16)
    t_bwd_lib = time_ms(lambda: torch.autograd.grad(
        o_lib, (qg, kg, vg), do, retain_graph=True), 20)
    small = B * H * S * 4 * 2 + mask.numel() * 4  # lse, D, mask
    out["flash_attention_bwd_dq"] = dict(
        ms=t_dq, plain_ms=t_bwd_plain, library_ms=t_bwd_lib,
        bound=bound(5 * n * 2 + small, 6 * B * H * S * S * D, bf))
    out["flash_attention_bwd_dkv"] = dict(
        ms=t_dkv, plain_ms=t_bwd_plain, library_ms=t_bwd_lib,
        bound=bound(6 * n * 2 + small, 8 * B * H * S * S * D, bf))
    del q, k, v, do, o, lse, dsum, qg, kg, vg, o_lib

    N, V = B * S // 4, 30522
    logits = torch.randn(N, V, device="cuda", dtype=bf) * 3
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).cuda()
    labels[torch.from_numpy(rng.random(N) < 0.15).cuda()] = -1
    labels64 = labels.long()
    g = torch.randn(N, device="cuda")
    t_ce = time_ms(lambda: ce.softmax_ce_fwd(logits, labels), 20)
    t_ce_plain = time_ms(lambda: ce.softmax_ce_plain(logits, labels), 5)
    t_ce_lib = time_ms(lambda: F.cross_entropy(
        logits, labels64, reduction="none", ignore_index=-1), 20)
    out["softmax_ce_fwd"] = dict(
        ms=t_ce, plain_ms=t_ce_plain, library_ms=t_ce_lib,
        # max, subtract, exp, add per element (f32 vector)
        bound=bound(logits.numel() * 2 + N * 4 + 2 * N * 4, 4 * N * V,
                    torch.float32))
    _, lse = ce.softmax_ce_fwd(logits, labels)
    t_ceb = time_ms(lambda: ce.softmax_ce_bwd(logits, labels, lse, g), 20)
    t_ceb_plain = time_ms(lambda: ce.softmax_ce_bwd_plain(
        logits, labels, lse, g), 5)
    xg = logits.detach().requires_grad_()
    l_lib = F.cross_entropy(xg, labels64, reduction="none", ignore_index=-1)
    t_ceb_lib = time_ms(lambda: torch.autograd.grad(
        l_lib, xg, g, retain_graph=True), 20)
    out["softmax_ce_bwd"] = dict(
        ms=t_ceb, plain_ms=t_ceb_plain, library_ms=t_ceb_lib,
        # subtract, exp, subtract, multiply per element (f32 vector)
        bound=bound(2 * logits.numel() * 2 + 3 * N * 4, 4 * N * V,
                    torch.float32))
    del logits, xg, l_lib
    shapes = {"flash_attention_fwd": "[64,12,512,64] bf16 keep 0.9",
              "flash_attention_bwd_dq": "[64,12,512,64] bf16 keep 0.9",
              "flash_attention_bwd_dkv": "[64,12,512,64] bf16 keep 0.9",
              "softmax_ce_fwd": f"[{N},{V}] bf16",
              "softmax_ce_bwd": f"[{N},{V}] bf16"}
    library = {"flash_attention_fwd": "scaled_dot_product_attention",
               "flash_attention_bwd_dq": "scaled_dot_product_attention "
                                         "backward (dq, dk, dv; no dropout)",
               "flash_attention_bwd_dkv": "scaled_dot_product_attention "
                                          "backward (dq, dk, dv; no dropout)",
               "softmax_ce_fwd": "cross_entropy",
               "softmax_ce_bwd": "cross_entropy backward"}
    for name, r in out.items():
        log(f"kernel {name} {shapes[name]}: {r['ms']:.4f} ms, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), plain "
            f"{r['plain_ms']:.4f} ms, {library[name]} {r['library_ms']:.4f} "
            "ms")
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


def ctr_paths(ht, models, fns, rng, steps, seed):
    """Phase 3c: W&D packed at both table sizes, then one step each of
    DeepFM, DCN and DLRM; returns {rows: (ms/step, launches)}."""
    out = {}
    for rows in (WDL_ROWS, CRITEO_ROWS):
        ex, feed, step = ctr_executor(ht, models, models.WDL, rng, rows, seed)
        label = f"wdl path {rows} rows"
        _, ms, launches = run_path(label, step, fns, steps, CTR_BATCH,
                                   expect_launches(pack_write=steps))
        out[rows] = ms, launches
        profile_steps(label, step, steps=2)
        params, state = dict(ex.params), dict(ex.opt_state)
        (logit,) = ex.run("predict", feed_dict=feed)
        torch.cuda.synchronize()
        require(f"{label}: predict gives {CTR_BATCH} finite logits and "
                "changes no param nor optimizer state",
                tuple(logit.shape) == (CTR_BATCH,)
                and bool(torch.isfinite(logit).all())
                and all(ex.params[k] is v for k, v in params.items())
                and all(ex.opt_state[k] is v for k, v in state.items()))
        ex.close()
        del ex, feed, step, params, state
        torch.cuda.empty_cache()
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
    torch.cuda.empty_cache()
    return out


def pack_write_times(rng, sd):
    """pack_write at the main path's M = 3328 for both tables: the kernel
    alone, the whole function (sort + zero fill + kernel) and its parts,
    the plain version, and ``index_add_`` alone and after a zero fill.
    Each is timed on the card's clock (``device_ms``; a launch here costs
    the host more than the kernel takes the card) and, for the whole
    calls, also back to back with CUDA events (the rate the host
    sustains)."""
    out = {}
    m = CTR_BATCH * 26
    for rows in (WDL_ROWS, CRITEO_ROWS):
        p_rows = sd.packed_rows(rows, 16)
        ids = torch.from_numpy(ctr_ids(rng, "uniform", m, p_rows)).cuda()
        lines = torch.randn(m, 128, device="cuda")
        ids_sorted, order = torch.sort(ids, stable=True)
        buf = torch.zeros(p_rows, 128, device="cuda")
        ids64 = ids.long()
        unique = int(ids.unique().numel())
        calls = dict(
            ms=lambda: sd.pack_write_kernel(ids_sorted, order, lines, buf),
            fn_ms=lambda: sd.pack_write(ids, lines, p_rows),
            sort_ms=lambda: torch.sort(ids, stable=True),
            zeros_ms=lambda: torch.zeros(p_rows, 128, device="cuda"),
            plain_ms=lambda: sd.pack_write_plain(ids, lines, p_rows),
            library_ms=lambda: buf.index_add_(0, ids64, lines),
            library_fn_ms=lambda: torch.zeros(
                p_rows, 128, device="cuda").index_add_(0, ids64, lines))
        t = {key: device_ms(fn) for key, fn in calls.items()}
        events = {key: time_ms(calls[key], 50)
                  for key in ("ms", "fn_ms", "plain_ms", "library_ms")}
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
            f"{t['plain_ms']:.4f} ms; index_add_ {t['library_ms']:.4f} ms, "
            f"zero fill + index_add_ {t['library_fn_ms']:.4f} ms")
        log(f"kernel pack_write M={m} p_rows={p_rows}, back-to-back calls "
            f"(CUDA events): kernel {events['ms']:.4f} ms, whole function "
            f"{events['fn_ms']:.4f} ms, plain {events['plain_ms']:.4f} ms, "
            f"index_add_ {events['library_ms']:.4f} ms")
        require(f"pack_write timings at p_rows={p_rows} saw device time",
                min(t[k] for k in calls) > 0)
        out[rows] = t
        del buf
    # skew: one warp sums each run, so a hot id's run is the kernel's tail
    p_rows = sd.packed_rows(WDL_ROWS, 16)
    for m in (3328, 65536):
        ids = torch.from_numpy(ctr_ids(rng, "zipf", m, p_rows)).cuda()
        lines = torch.randn(m, 128, device="cuda")
        ids_sorted, order = torch.sort(ids, stable=True)
        buf = torch.zeros(p_rows, 128, device="cuda")
        ids64 = ids.long()
        run = int(torch.bincount(ids).max())
        t_k = device_ms(lambda: sd.pack_write_kernel(ids_sorted, order, lines,
                                                     buf))
        t_lib = device_ms(lambda: buf.index_add_(0, ids64, lines))
        log(f"kernel pack_write zipf s=1.05 M={m} p_rows={p_rows} (largest "
            f"run {run}), device time: kernel {t_k:.4f} ms, index_add_ "
            f"{t_lib:.4f} ms")
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
    init = {k: v.cpu() for k, v in ex_cpu.params.items()}
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
    that returns the loss."""
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
    return ex, step, init_s


def moe_paths(ht, layers, fns, rng, steps, seed):
    """Phase 3d: bench_moe's training step at full size, its determinism,
    and the Mixtral-width layer; returns (ms/step, launches) of bench_moe."""
    m = MOE
    tokens = m["B"] * m["S"]
    ex, step, init_s = moe_executor(ht, layers, rng, m, seed)
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
    ex.close()
    del ex, step
    # the same 3 steps twice from the same params (the seed's init): the
    # losses and the params after them must be bitwise equal
    runs = []
    for _ in range(2):
        ex, step, _ = moe_executor(ht, layers,
                                   np.random.default_rng(seed + 5), m, seed)
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
    torch.cuda.empty_cache()

    mx = MIXTRAL
    ex, step, init_s = moe_executor(ht, layers, rng, mx, seed)
    log(f"mixtral moe layer: MoELayer({mx['H']}, {mx['F']}, {mx['E']} "
        f"experts, top-{mx['k']}, capacity {mx['cf']}, {mx['act']}) "
        f"B={mx['B']} S={mx['S']} f32, Adam(1e-3), "
        f"{sum(p.numel() for p in ex.params.values())} params, init "
        f"{init_s:.1f} s")
    run_path("mixtral moe layer", step, fns, 3, mx["B"] * mx["S"],
             expect_launches(row_gather=9), warmup=1, unit="tokens")
    ex.close()
    del ex, step
    torch.cuda.empty_cache()
    return ms, launches


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
        del src
    tot["bound"] = bound(tot["bytes"], 0, torch.float32)
    log(f"kernel row_gather, one bench_moe step's 3 launches, L2 cold: "
        f"kernel {tot['ms']:.4f} ms, bound {tot['bound'][0]:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, index_select {tot['library_ms']:.4f} ms")
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
    init = {k: v.cpu() for k, v in ex_cpu.params.items()}
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
    fwd_err = flash_fwd_checks(rng, fa)
    bwd_err = flash_bwd_checks(rng, fa)
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
             expect_launches(flash_attention_fwd=L * steps,
                             softmax_ce_fwd=steps))
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps("eval path", eval_step)
    ex.close()  # frees params now: the executor is in a reference cycle
    del ex, eval_step
    torch.cuda.empty_cache()

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
        expect_launches(flash_attention_fwd=L * steps,
                        flash_attention_bwd_dq=L * steps,
                        flash_attention_bwd_dkv=L * steps,
                        softmax_ce_fwd=steps, softmax_ce_bwd=steps))
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps("train path", train_step, steps=1)
    ex.close()
    del ex, feed, train_step
    torch.cuda.empty_cache()

    ctr = ctr_paths(ht, models, fns, rng, steps, args.seed)
    if failures:
        log(f"FAILED: {failures}")
        return 1
    moe_ms, moe_launches = moe_paths(ht, layers, fns, rng, steps, args.seed)
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
        ("softmax_ce_fwd", "triton", src + "ops/kernels/softmax_ce.py",
         "hetu_tpu/ops/pallas/softmax_ce.py:109", ce_err),
        ("softmax_ce_bwd", "triton", src + "ops/kernels/softmax_ce.py",
         "hetu_tpu/ops/pallas/softmax_ce.py:140", ce_bwd_err),
        ("pack_write", "cuda", src + "csrc/pack_write.cu",
         "hetu_tpu/ops/pallas/sparse_densify.py:152", pw_err),
        ("row_gather", "cuda", src + "csrc/row_gather.cu",
         "hetu_tpu/ops/pallas/moe_dispatch.py:124", rg_err),
    ]
    # launches: each kernel's own training path (BERT, W&D at 337,000 rows
    # for pack_write, bench_moe for row_gather); row_gather's times are the
    # sums over one bench_moe step's three launches
    launches = dict(train_launches, pack_write=ctr[WDL_ROWS][1]["pack_write"],
                    row_gather=moe_launches["row_gather"])
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
        + f"; moe path: {moe_ms:.3f} ms/step")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
