#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hetu_tpu_torch) end to end on one card.

    python3 chip_smoke.py [--seed N] [--steps N]

Phases, each fatal on failure (exit 1, no result lines):

1. Card and build: the card's name and power limit, and the build of every
   kernel of the path from the sources in this checkout (nvcc for the CUDA
   flash-attention forward, Triton's compiler for the softmax-CE forward).
2. Kernels against their plain PyTorch versions on the card, on the same
   inputs: at the main path's shapes and at ragged, causal and fully-masked
   ones.  Each check prints its max |error| beside its stated tolerance.
3. Main path: BERT-base (vocab 30522, hidden 768, 12 layers, 12 heads,
   FFN 3072, seq 512, MLM bucket 0.25 -> 8192 rows) evaluated through
   ``Executor({"validate": [loss]}, compute_dtype=bfloat16)`` at batch 64
   with random weights from ``--seed``.  The launch counters are zeroed just
   before the timed steps and read just after: 12 flash launches and 1 CE
   launch per step.  Then each kernel is timed at the path's shapes beside
   its bound, its plain version and one PyTorch library call (a yardstick
   only; the port never calls it), and the same weights are evaluated at
   f32 on the card and on the CPU (batch 2, 2 layers) and compared.
4. Result: a {"kernels": [...]} JSON line, the nvidia-smi line, and last
   {"ok": true, "device": {...}}.

Exits non-zero, printing no result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
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


def bert_mask(rng, B, S, device):
    """Additive BERT key mask [B,1,1,S]: -10000 on padding, each sequence
    keeping between S/2 and S tokens."""
    lengths = rng.integers(S // 2, S + 1, B)
    keep = np.arange(S)[None, :] < lengths[:, None]
    mask = np.where(keep, 0.0, -10000.0).astype(np.float32)
    return torch.from_numpy(mask).reshape(B, 1, 1, S).to(device)


def flash_checks(rng, fa):
    """Phase 2a: the CUDA flash kernel against its plain version."""
    dev = "cuda"
    # (atol, reason, rtol)
    tol = {torch.bfloat16: (1e-2, "the kernel rounds P to bf16 before the "
                            "P.V product (2^-9 relative, |v| <= ~5), and "
                            "both sides round o to bf16 (one ulp, 2^-7 "
                            "relative)", 2.0 ** -7),
           torch.float32: (1e-4, "f32 throughout; the order of the sums "
                           "over d and over keys differs", 0.0)}
    lse_tol, lse_why = 1e-3, "f32 scores and sums; summation order differs"

    def case(label, B, H, S, D, dtype, mask=None, causal=False):
        if B * H * S * D > 1 << 26:   # large inputs: drawn on the card
            gen = torch.Generator(dev).manual_seed(int(rng.integers(1 << 31)))
            q, k, v = (torch.randn(B, H, S, D, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
        else:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (B, H, S, D)).astype(np.float32)).to(dev, dtype)
                for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, mask=mask, causal=causal)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask,
                                              causal=causal)
        name = f"flash {label} {str(dtype).split('.')[-1]}"
        err = check(f"{name} o", o, o_p, *tol[dtype])
        check(f"{name} lse", lse, lse_p, lse_tol, lse_why)
        return q, k, v, o, lse, err

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        mask = bert_mask(rng, 64, 512, dev)
        errs[dtype] = case("[64,12,512,64] bert-mask", 64, 12, 512, 64,
                           dtype, mask=mask)[-1]
        case("[2,4,512,64] causal", 2, 4, 512, 64, dtype, causal=True)
        case("[2,4,512,64] causal+mask", 2, 4, 512, 64, dtype,
             mask=bert_mask(rng, 2, 512, dev), causal=True)
        empty = bert_mask(rng, 2, 256, dev) * 1e26   # -1e30 on padding
        empty[1] = -1e30                              # every key of batch 1
        *_, o, lse, _ = case("[2,4,256,64] fully-masked", 2, 4, 256, 64,
                             dtype, mask=empty)
        if not (bool((o[1] == 0).all()) and bool((lse[1] == 1e30).all())):
            log("check flash fully-masked rows: o != 0 or lse != 1e30 FAIL")
            failures.append("flash fully-masked rows")
        case("[2,3,200,40] padded+mask", 2, 3, 200, 40, dtype,
             mask=bert_mask(rng, 2, 200, dev))
        case("[2,3,200,40] padded causal", 2, 3, 200, 40, dtype, causal=True)
        case("[1,2,256,128] head-128", 1, 2, 256, 128, dtype,
             mask=bert_mask(rng, 1, 256, dev))
        case("[1,2,256,256] wide-head", 1, 2, 256, 256, dtype,
             mask=bert_mask(rng, 1, 256, dev))
        case("[1,2,256,512] widest-head causal", 1, 2, 256, 512, dtype,
             causal=True)
        # more (batch, head) pairs than the 65535 blocks of a grid's y axis
        case("[4100,16,128,32] many-heads", 4100, 16, 128, 32, dtype,
             mask=bert_mask(rng, 4100, 128, dev))
    return errs


def ce_checks(rng, ce):
    """Phase 2b: the Triton CE kernel against its plain version."""
    why = "f32 online max/sum-exp over the same upcast values; order differs"

    def case(N, V, dtype):
        x = torch.from_numpy(
            (3.0 * rng.standard_normal((N, V))).astype(np.float32)).to(
                "cuda", dtype)
        labels = rng.integers(0, V, N)
        labels[rng.random(N) < 0.15] = -1
        labels = torch.from_numpy(labels.astype(np.int32)).cuda()
        loss, lse = ce.softmax_ce_fwd(x, labels)
        torch.cuda.synchronize()
        loss_p, lse_p = ce.softmax_ce_plain(x, labels)
        name = f"ce [{N},{V}] {str(dtype).split('.')[-1]}"
        err = check(f"{name} loss", loss, loss_p, 2e-4, why)
        check(f"{name} lse", lse, lse_p, 2e-4, why)
        return err

    err = case(8192, 30522, torch.bfloat16)
    case(300, 3000, torch.bfloat16)
    case(300, 3000, torch.float32)
    return err


def build_bert(ht, models, B, S, L):
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


def profile_steps(ex, feed, steps=2, top=12):
    """Where a main-path step's time goes: device time by kernel under
    torch.profiler, and the device's idle share of the traced window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            ex.run("validate", feed_dict=feed)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us <= 0:
        log("profile: the profiler saw no device time")
        return
    log(f"profile: {steps} steps, {wall_us / steps / 1e3:.3f} ms/step wall "
        f"(traced), device busy {busy_us / steps / 1e3:.3f} ms/step, "
        f"idle share {max(0.0, 1 - busy_us / wall_us):.3f}, "
        f"{sum(e.count for e in kernels) // steps} kernel launches/step")
    # kernel classes by name: our two kernels, cuBLAS GEMMs, reductions
    # (layer-norm moments, means), copies and casts, other elementwise
    classes = (("flash_attention_fwd", ("flash_fwd",)),
               ("softmax_ce_fwd", ("_ce_fwd_kernel",)),
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
    t0 = time.perf_counter()
    lib = build.build("flash_attention_fwd.cu")
    log(f"build: nvcc flash_attention_fwd.cu {time.perf_counter() - t0:.1f} s")
    with open(lib + ".log") as f:
        for line in f:
            if "Used" in line or "spill" in line.lower():
                log("  " + line.strip())
    t0 = time.perf_counter()
    probe = torch.zeros(8, 1024, device="cuda", dtype=torch.bfloat16)
    ce.softmax_ce_fwd(probe, torch.zeros(8, dtype=torch.int32,
                                         device="cuda"))
    torch.cuda.synchronize()
    log(f"build: triton softmax_ce_fwd {time.perf_counter() - t0:.1f} s")

    # -- phase 2: kernels against their plain versions ----------------------
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    flash_err = flash_checks(rng, fa)
    ce_err = ce_checks(rng, ce)
    if failures:
        log(f"FAILED checks: {failures}")
        return 1

    # -- phase 3: the main path ---------------------------------------------
    B, S, L = 64, 512, 12
    loss = build_bert(ht, models, B, S, L)
    t0 = time.perf_counter()
    ex = ht.Executor({"validate": [loss]}, compute_dtype=torch.bfloat16,
                     device="cuda", seed=args.seed)
    torch.cuda.synchronize()
    log(f"main path: BERT-base B={B} S={S} L={L}, "
        f"{sum(p.numel() for p in ex.params.values())} params, init "
        f"{time.perf_counter() - t0:.1f} s")
    feed = bert_batch(rng, B, S, "cuda")
    for _ in range(3):
        ex.run("validate", feed_dict=feed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    ce.softmax_ce_fwd.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        (val,) = ex.run("validate", feed_dict=feed)
    end.record()
    torch.cuda.synchronize()
    launches = {"flash_attention_fwd": fa.flash_attention_fwd.launches,
                "softmax_ce_fwd": ce.softmax_ce_fwd.launches}
    ms = start.elapsed_time(end) / args.steps
    loss_val = val.item()
    log(f"main path: loss {loss_val:.6f}, {ms:.3f} ms/step, "
        f"{B * 1000.0 / ms:.1f} samples/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
        f"launches {launches} over {args.steps} steps")
    if not math.isfinite(loss_val):
        failures.append("main path loss not finite")
    if launches != {"flash_attention_fwd": L * args.steps,
                    "softmax_ce_fwd": args.steps}:
        failures.append("main path launch counts")
    if failures:
        log(f"FAILED: {failures}")
        return 1
    profile_steps(ex, feed)
    del ex, feed
    torch.cuda.empty_cache()

    # per-kernel times at the path's shapes
    H, D = 12, 64
    q, k, v = (torch.randn(B, H, S, D, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    mask = bert_mask(rng, B, S, "cuda")
    flash_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, mask=mask), 20)
    flash_plain_ms = time_ms(
        lambda: fa.flash_attention_plain(q, k, v, mask=mask), 5)
    mask_bf16 = mask.to(torch.bfloat16)
    flash_lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask_bf16), 20)
    flash_bytes = 4 * q.numel() * 2 + mask.numel() * 4 + B * H * S * 4
    flash_ops = 4 * B * H * S * S * D
    flash_bound = max(flash_bytes / HBM_BYTES_PER_S,
                      flash_ops / PEAK_OPS[torch.bfloat16]) * 1e3
    flash_by = ("bytes" if flash_bytes / HBM_BYTES_PER_S
                >= flash_ops / PEAK_OPS[torch.bfloat16] else "operations")
    del q, k, v

    N, V = 8192, 30522
    logits = torch.randn(N, V, device="cuda", dtype=torch.bfloat16) * 3
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).cuda()
    labels[torch.from_numpy(rng.random(N) < 0.15).cuda()] = -1
    labels64 = labels.long()
    ce_ms = time_ms(lambda: ce.softmax_ce_fwd(logits, labels), 20)
    ce_plain_ms = time_ms(lambda: ce.softmax_ce_plain(logits, labels), 5)
    ce_lib_ms = time_ms(lambda: F.cross_entropy(
        logits, labels64, reduction="none", ignore_index=-1), 20)
    ce_bytes = logits.numel() * 2 + N * 4 + 2 * N * 4
    ce_ops = 4 * N * V   # max, subtract, exp, add per element (f32 vector)
    ce_bound = max(ce_bytes / HBM_BYTES_PER_S,
                   ce_ops / PEAK_OPS[torch.float32]) * 1e3
    ce_by = ("bytes" if ce_bytes / HBM_BYTES_PER_S
             >= ce_ops / PEAK_OPS[torch.float32] else "operations")
    del logits
    log(f"kernel flash_attention_fwd [64,12,512,64] bf16: {flash_ms:.4f} ms, "
        f"bound {flash_bound:.4f} ms ({flash_by}), plain {flash_plain_ms:.4f} "
        f"ms, scaled_dot_product_attention {flash_lib_ms:.4f} ms")
    log(f"kernel softmax_ce_fwd [8192,30522] bf16: {ce_ms:.4f} ms, bound "
        f"{ce_bound:.4f} ms ({ce_by}), plain {ce_plain_ms:.4f} ms, "
        f"cross_entropy {ce_lib_ms:.4f} ms")

    # the same weights at f32 on the card and on the CPU
    small = build_bert(ht, models, 2, S, 2)
    ex_gpu = ht.Executor({"validate": [small]}, device="cuda",
                         seed=args.seed + 1)
    ex_cpu = ht.Executor({"validate": [small]}, device="cpu",
                         seed=args.seed + 2)
    ex_cpu.load_state_dict(ex_gpu.state_dict())
    feed_small = bert_batch(rng, 2, S, "cpu")
    (l_gpu,) = ex_gpu.run("validate", feed_dict=feed_small)
    (l_cpu,) = ex_cpu.run("validate", feed_dict=feed_small)
    check("cross-device f32 BERT loss (card flash+CE kernels vs CPU "
          "composition+plain CE)", l_gpu.cpu(), l_cpu, 1e-3,
          "f32 on both sides; attention, layer norm and the 30522-way "
          "logsumexp sum in another order")
    if failures:
        log(f"FAILED: {failures}")
        return 1

    # -- phase 4: result ----------------------------------------------------
    kernels = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "hetu_tpu_torch/csrc/flash_attention_fwd.cu",
         "replaces": "hetu_tpu/ops/pallas/flash_attention.py:266",
         "launches": launches["flash_attention_fwd"],
         "max_abs_err": flash_err[torch.bfloat16], "ms": flash_ms,
         "plain_ms": flash_plain_ms, "bound_ms": flash_bound,
         "bound_by": flash_by, "library_ms": flash_lib_ms},
        {"name": "softmax_ce_fwd", "route": "triton",
         "source": "hetu_tpu_torch/ops/kernels/softmax_ce.py",
         "replaces": "hetu_tpu/ops/pallas/softmax_ce.py:109",
         "launches": launches["softmax_ce_fwd"], "max_abs_err": ce_err,
         "ms": ce_ms, "plain_ms": ce_plain_ms, "bound_ms": ce_bound,
         "bound_by": ce_by, "library_ms": ce_lib_ms},
    ]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
