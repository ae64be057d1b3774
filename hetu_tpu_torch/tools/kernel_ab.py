"""Time the flash-attention forward, dQ and dK/dV kernels of two checkouts
on one card.

    python3 -m hetu_tpu_torch.tools.kernel_ab OLD_DIR NEW_DIR

Each directory is the root of a checkout holding ``hetu_tpu_torch/``.  The
kernels of each are built from that checkout's sources, both checkouts'
first, and one run of the new checkout is discarded, so that no timed run
finds the card cooled by idle seconds (on an H100, a run right after a
build read up to 15% faster than the same code a few runs later).  Then
each checkout is timed in its own process, in the order old, new, new,
old, on the same seeded inputs, through the public wrappers (so each
checkout takes its own route for a shape), at the main paths' shapes,
bf16:

- BERT-base, [64,12,512,64] with a BERT key mask: the forward at keep 1
  and keep 0.9, dQ and dK/dV at keep 0.9;
- the mesh-less Llama, causal [8,12,1024,64]: the forward, dQ and dK/dV;
- the cp=4 ring step at [8,12,1024,64]: the blockwise forward, dQ and
  dK/dV, the mean over the 4 steps;
- the Mistral-width witness's block, q and K/V [1,32,2048,128]: the full
  block (q at 2048, K/V at 0), the diagonal one and the empty one (K/V at
  2048, the backward from the diagonal's lse), forward, dQ and dK/dV;
- GPT-3 2.7B's heads (path i2 of chip_smoke.py), causal [2,32,2048,80]:
  the forward, dQ and dK/dV at keep 1 and at keep 0.9;
- the host's time per call (microseconds, not ms) of the forward, dQ and
  dK/dV wrappers at [1,1,128,64], where the card outruns the host.

Each run prints, per case, the median over 5 windows of 20 calls of the
device time of the call's kernels (torch.profiler), or the host's mean
over 2000 calls; the script ends with one JSON line of all runs.  A comparison of two versions is
meaningful only within one such call: the card's clocks and power limit
differ between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, statistics, torch
from hetu_tpu_torch.ops.kernels import flash_attention as fa
bf = torch.bfloat16
g = torch.Generator("cuda").manual_seed(0)
def rand(*shape):
    return torch.randn(*shape, generator=g, device="cuda").to(bf)
def median_ms(fn):
    # the device time of the call's kernels under torch.profiler (the
    # short launches take the card less time than the host needs to make
    # them, where back-to-back CUDA events would time the host); a window
    # the profiler recorded no kernel of is profiled again
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    windows = []
    for _ in range(15):
        if len(windows) == 5:
            break
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            windows.append(us / 20 / 1e3)
    if not windows:
        raise RuntimeError("torch.profiler recorded no device time")
    return statistics.median(windows)
out = {}
# BERT-base
B, H, S, D = 64, 12, 512, 64
q, k, v, do = (rand(B, H, S, D) for _ in range(4))
keep = torch.arange(S, device="cuda")[None, :] < torch.randint(
    S // 2, S + 1, (B, 1), generator=g, device="cuda")
mask = torch.where(keep, 0.0, -10000.0).reshape(B, 1, 1, S)
seed = torch.tensor([1234], dtype=torch.int32, device="cuda")
kw = dict(mask=mask, dropout_keep=0.9, seed=seed)
out["bert fwd keep 1"] = median_ms(
    lambda: fa.flash_attention_fwd(q, k, v, mask=mask))
out["bert fwd keep 0.9"] = median_ms(lambda: fa.flash_attention_fwd(
    q, k, v, **kw))
o, lse = fa.flash_attention_fwd(q, k, v, **kw)
dsum = (do.float() * o.float()).sum(-1)
out["bert dq keep 0.9"] = median_ms(lambda: fa.flash_attention_bwd_dq(
    q, k, v, do, lse, dsum, **kw))
out["bert dkv keep 0.9"] = median_ms(lambda: fa.flash_attention_bwd_dkv(
    q, k, v, do, lse, dsum, **kw))
# the mesh-less Llama, and the cp=4 ring step over the same tensors
B, H, S, D = 8, 12, 1024, 64
q, k, v, do = (rand(B, H, S, D) for _ in range(4))
out["llama causal fwd"] = median_ms(
    lambda: fa.flash_attention_fwd(q, k, v, causal=True))
o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
dsum = (do.float() * o.float()).sum(-1)
out["llama causal dq"] = median_ms(lambda: fa.flash_attention_bwd_dq(
    q, k, v, do, lse, dsum, causal=True))
out["llama causal dkv"] = median_ms(lambda: fa.flash_attention_bwd_dkv(
    q, k, v, do, lse, dsum, causal=True))
out["ring step fwd"] = sum(median_ms(
    lambda: fa.flash_attention_block(q, k, v, 0, 0, ring=(4, r)))
    for r in range(4)) / 4
out["ring step dq"] = sum(median_ms(
    lambda: fa.flash_attention_block_bwd_dq(q, k, v, do, lse, dsum, 0, 0,
                                            ring=(4, r)))
    for r in range(4)) / 4
out["ring step dkv"] = sum(median_ms(
    lambda: fa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum, 0, 0,
                                             ring=(4, r)))
    for r in range(4)) / 4
# the witness's block
B, H, S, D = 1, 32, 2048, 128
q, k, v, do = (rand(B, H, S, D) for _ in range(4))
lse = fa.flash_attention_block(q, k, v, 0, 0)[1]
for case, q_off, k_off in (("full", S, 0), ("diagonal", 0, 0),
                           ("empty", 0, S)):
    out[f"d128 {case} block fwd"] = median_ms(
        lambda: fa.flash_attention_block(q, k, v, q_off, k_off))
    o = fa.flash_attention_block(q, k, v, q_off, k_off)[0]
    dsum = (do.float() * o.float()).sum(-1)
    out[f"d128 {case} block dq"] = median_ms(
        lambda: fa.flash_attention_block_bwd_dq(q, k, v, do, lse, dsum,
                                                q_off, k_off))
    out[f"d128 {case} block dkv"] = median_ms(
        lambda: fa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum,
                                                 q_off, k_off))
# GPT-3 2.7B's heads, causal, without and with attention dropout
B, H, S, D = 2, 32, 2048, 80
q, k, v, do = (rand(B, H, S, D) for _ in range(4))
for keep in (1.0, 0.9):
    kw = dict(causal=True, dropout_keep=keep,
              seed=seed if keep < 1.0 else None)
    out[f"d80 causal fwd keep {keep:g}"] = median_ms(
        lambda: fa.flash_attention_fwd(q, k, v, **kw))
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    dsum = (do.float() * o.float()).sum(-1)
    out[f"d80 causal dq keep {keep:g}"] = median_ms(
        lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum, **kw))
    out[f"d80 causal dkv keep {keep:g}"] = median_ms(
        lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, **kw))
# host time of a call, at a shape whose kernels take the card less time
# than the host needs to launch them: the wrapper, its argument checks and
# (wgmma) the tensor maps' encoding, the launch
import time
q, k, v, do = (rand(1, 1, 128, 64) for _ in range(4))
o, lse = fa.flash_attention_fwd(q, k, v)
dsum = (do.float() * o.float()).sum(-1)
for name, fn in (
        ("host us fwd [1,1,128,64]", lambda: fa.flash_attention_fwd(q, k, v)),
        ("host us dq [1,1,128,64]",
         lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum)),
        ("host us dkv [1,1,128,64]",
         lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum))):
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        fn()
    out[name] = (time.perf_counter() - t0) / 2000 * 1e6
    torch.cuda.synchronize()
print(json.dumps(out))
"""


_BUILD = ("from hetu_tpu_torch.ops.kernels import build\n"
          "for source in ('flash_attention_fwd.cu', 'flash_attention_bwd.cu'):"
          "\n    build.build(source)\n")


def python(root, script):
    """The standard output of ``script`` run in a new process in ``root``."""
    return subprocess.run([sys.executable, "-c", script], cwd=root,
                          capture_output=True, text=True, check=True,
                          env=dict(os.environ, PYTHONPATH=root)).stdout


def run_one(root):
    return json.loads(python(root, _CHILD).strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    for label in ("old", "new"):
        python(os.path.abspath(getattr(args, label)), _BUILD)
    run_one(os.path.abspath(args.new))  # warms the card, not kept
    runs = []
    for label in ("old", "new", "new", "old"):
        res = run_one(os.path.abspath(getattr(args, label)))
        runs.append({"tree": label, "results": res})
        print(f"{label}: " + ", ".join(f"{case} {t:.4f}"
                                       for case, t in res.items()),
              flush=True)
    for case in runs[0]["results"]:
        old = sorted(r["results"][case] for r in runs if r["tree"] == "old")
        new = sorted(r["results"][case] for r in runs if r["tree"] == "new")
        unit = "us" if case.startswith("host") else "ms"
        print(f"{case}: old {old[0]:.4f} {old[1]:.4f} {unit}, new "
              f"{new[0]:.4f} {new[1]:.4f} {unit}, new/old "
              f"{sum(new) / sum(old):.3f}", flush=True)
    print(json.dumps({"card": smi, "runs": runs}))


if __name__ == "__main__":
    main()
