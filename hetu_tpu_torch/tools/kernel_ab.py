"""Time the flash-attention forward kernel of two checkouts on one card.

    python3 -m hetu_tpu_torch.tools.kernel_ab OLD_DIR NEW_DIR

Each directory is the root of a checkout holding ``hetu_tpu_torch/``.  The
kernel of each is built from that checkout's sources and timed in its own
process, in the order old, new, new, old, twice over, at
the BERT-base slice shape [64,12,512,64] bf16 with a BERT key mask, on the
same seeded inputs.  Each run prints the median of 5 windows of 50
back-to-back launches (CUDA events), and the script ends with one JSON
line of all runs.  A comparison of two versions is meaningful only within
one such call: the card's clocks and power limit differ between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_CHILD = r"""
import json, statistics, sys, torch
from hetu_tpu_torch.ops.kernels import flash_attention as fa
g = torch.Generator("cuda").manual_seed(0)
B, H, S, D = 64, 12, 512, 64
q, k, v = (torch.randn(B, H, S, D, generator=g, device="cuda")
           .to(torch.bfloat16) for _ in range(3))
keep = torch.arange(S, device="cuda")[None, :] < torch.randint(
    S // 2, S + 1, (B, 1), generator=g, device="cuda")
mask = torch.where(keep, 0.0, -10000.0).reshape(B, 1, 1, S)
for _ in range(5):
    fa.flash_attention_fwd(q, k, v, mask=mask)
windows = []
for _ in range(5):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        fa.flash_attention_fwd(q, k, v, mask=mask)
    end.record()
    torch.cuda.synchronize()
    windows.append(start.elapsed_time(end) / 50)
print(json.dumps({"ms": statistics.median(windows), "windows": windows}))
"""


def run_one(root):
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                         capture_output=True, text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=root))
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args()
    runs = []
    for _ in range(2):
        for label in ("old", "new", "new", "old"):
            res = run_one(os.path.abspath(getattr(args, label)))
            runs.append({"tree": label, **res})
            print(f"{label}: flash_attention_fwd [64,12,512,64] bf16 "
                  f"{res['ms']:.4f} ms (median of 5 x 50 launches)",
                  flush=True)
    med = {t: sorted(r["ms"] for r in runs if r["tree"] == t)
           for t in ("old", "new")}
    print(json.dumps({"runs": runs, "sorted_ms": med}))


if __name__ == "__main__":
    main()
