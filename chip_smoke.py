#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hetu_tpu_torch) end to end on one card.

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each fatal on failure (exit 1, no result lines):

1. Card and build: the card's name and power limit, and the build of every
   kernel of the paths from the sources in this checkout: one nvcc per CUDA
   source (flash-attention forward with dropout; dQ and dK/dV backward),
   all started together, then Triton's compiler for the softmax-CE forward
   and backward.
2. Kernels against their plain PyTorch versions on the card, on the same
   inputs: the dropout keep bits bitwise; the flash forward (with and
   without dropout), dQ, dK/dV and the CE forward and backward at the main
   paths' shapes and at ragged, causal, fully-masked, wide-head and f32
   ones.  Each check prints its max |error| beside its stated tolerance.
3. Main paths, each driven with the five launch counters set to 0 just
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
   Each path's step is broken down by kernel class under torch.profiler.
   Then each kernel is timed at the paths' shapes beside its bound, its
   plain version and one PyTorch library call (a yardstick only; the port
   never calls it), and one f32 training step of BERT (batch 2, 2 layers,
   full widths, dropout off) runs from the same params on the card
   (kernels) and on the CPU (plain versions): loss, every gradient and
   every updated param are compared.
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
CUDA_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu")

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


def counters(fa, ce):
    """The five launch counters of the paths' kernels."""
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "softmax_ce_fwd": ce.softmax_ce_fwd,
            "softmax_ce_bwd": ce.softmax_ce_bwd}


def run_path(label, step, fa, ce, steps, B, expect):
    """3 warm-up steps, then ``steps`` timed steps with the launch counters
    zeroed just before and read just after; returns (losses of every step,
    ms/step, launches)."""
    losses = [step() for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters(fa, ce)
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
    log(f"{label}: {ms:.3f} ms/step, {B * 1000.0 / ms:.1f} samples/s, peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches} over {steps} steps")
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
    # kernel classes by name: the five kernels, cuBLAS GEMMs, reductions
    # (layer-norm moments, means, sums), copies and casts, other elementwise
    classes = (("flash_attention_fwd", ("flash_fwd",)),
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as models
    from hetu_tpu_torch.ops.kernels import build
    from hetu_tpu_torch.ops.kernels import flash_attention as fa
    from hetu_tpu_torch.ops.kernels import softmax_ce as ce

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
    torch.cuda.empty_cache()
    if failures:
        log(f"FAILED checks: {failures}")
        return 1

    # -- phase 3: the main paths --------------------------------------------
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
    run_path("eval path", eval_step, fa, ce, steps, B,
             {"flash_attention_fwd": L * steps, "flash_attention_bwd_dq": 0,
              "flash_attention_bwd_dkv": 0, "softmax_ce_fwd": steps,
              "softmax_ce_bwd": 0})
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps("eval path", eval_step)
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
        "train path", train_step, fa, ce, steps, B,
        {"flash_attention_fwd": L * steps, "flash_attention_bwd_dq": L * steps,
         "flash_attention_bwd_dkv": L * steps, "softmax_ce_fwd": steps,
         "softmax_ce_bwd": steps})
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps("train path", train_step, steps=1)
    del ex, feed, train_step
    torch.cuda.empty_cache()

    times = kernel_times(rng, fa, ce, B, S)
    torch.cuda.empty_cache()
    cross_device(ht, models, rng, args.seed)
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
    ]
    kernels = [{"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": train_launches[name],
                "max_abs_err": err, "ms": times[name]["ms"],
                "plain_ms": times[name]["plain_ms"],
                "bound_ms": times[name]["bound"][0],
                "bound_by": times[name]["bound"][1],
                "library_ms": times[name]["library_ms"]}
               for name, route, source, replaces, err in rows]
    log(f"train path: {train_ms:.3f} ms/step")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
