"""Probe chip_smoke.py's flat bf16 tolerance on BERT's flash backward.

    python3 -m hetu_tpu_torch.tools.bwd_check_probe [OTHER_DIR] [--shared]
        [--seed N] [--draws N]

Run from the root of a checkout on one card.  The check "flash bwd
[64,12,512,64] bert-mask keep 0.9 bfloat16" of ``chip_smoke.py`` holds the
wgmma dQ and dK/dV kernels to their plain version within 2e-3 + 2^-7 |plain|
(``BWD_TOL``).  That bound assumes dS terms of ~1e-3; the rows of a draw
can hold terms of ~1, whose bf16 rounding the kernel and the plain version
may take one ulp apart.  This script:

- draws chip_smoke.py's phase 2 inputs in its order under ``--seed``
  (with ``--shared``, the d = 80 forward's checks draw from the seed's
  stream too, as they did before they had a generator of their own, which
  gives this check other inputs), runs that check's case and prints each
  entry of dQ, dK and dV over the bound, with its float64 reference (dS,
  dropout and the key mask in float64, nothing rounded) and the size of
  the row's terms;
- with OTHER_DIR (the root of another checkout), launches that
  checkout's dQ and dK/dV kernels on the same inputs and says whether
  they give the same bits;
- on ``--draws`` fresh draws at the same shape, prints the largest excess
  of |kernel - plain| over 2^-7 |plain| of dQ, dK and dV, beside the
  bound's 2e-3.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--shared", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--draws", type=int, default=8)
    args = ap.parse_args()
    import numpy as np
    import torch
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from hetu_tpu_torch.ops.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    bf, (B, H, S, D), keep = torch.bfloat16, (64, 12, 512, 64), 0.9
    atol, _, rtol = cs.BWD_TOL[bf]
    rng = np.random.default_rng(args.seed)
    torch.manual_seed(args.seed)
    rng80 = rng if args.shared else np.random.default_rng((args.seed, 80))
    cs.dropout_checks(rng, fa)
    cs.kernel_dropout_checks(rng, fa)
    cs.flash_repeat_checks(rng, fa, rng80)
    cs.flash_fwd_checks(rng, fa, rng80)

    def draw(gen):
        mask = cs.bert_mask(gen, B, S, "cuda")
        q, k, v, do = (cs.randn(gen, (B, H, S, D), bf) for _ in range(4))
        kw = dict(mask=mask, dropout_keep=keep, seed=cs.seed_tensor(gen))
        o, lse = fa.flash_attention_fwd(q, k, v, **kw)
        return (q, k, v, o, lse, do), kw

    ins, kw = draw(rng)
    grads = fa.flash_attention_bwd(*ins, **kw)
    plain = fa.flash_attention_bwd_plain(*ins, **kw)
    q, k, v, _, _, do = ins
    bits = fa.dropout_keep_mask_plain(kw["seed"], B * H, S, S, keep)
    for name, got, want in zip(("dq", "dk", "dv"), grads, plain):
        diff = (got.float() - want.float()).abs()
        over = (diff - rtol * want.float().abs() > atol).nonzero().tolist()
        print(f"{name}: max |kernel - plain| {diff.max().item():.3e}, "
              f"{len(over)} entries over the bound", flush=True)
        for b, h, i, c in over[:8]:
            qf, kf, vf, dof = (t[b, h].double() for t in (q, k, v, do))
            p = torch.softmax(qf @ kf.T * D ** -0.5
                              + kw["mask"][b, 0, 0].double(), -1)
            m = bits[b * H + h].double() / keep
            ds = p * ((dof @ vf.T) * m - (dof * ((p * m) @ vf)).sum(
                -1, keepdim=True))
            ref, terms = {
                "dq": lambda: ((ds @ kf)[i, c] * D ** -0.5,
                               (ds[i] * kf[:, c]).abs() * D ** -0.5),
                "dk": lambda: ((ds.T @ qf)[i, c] * D ** -0.5,
                               (ds[:, i] * qf[:, c]).abs() * D ** -0.5),
                "dv": lambda: (((p * m).T @ dof)[i, c],
                               ((p * m)[:, i] * dof[:, c]).abs())}[name]()
            g, w, r = got[b, h, i, c].item(), want[b, h, i, c].item(), \
                ref.item()
            print(f"  {name}[{b},{h},{i},{c}]: kernel {g:.6f}, plain "
                  f"{w:.6f}, float64 {r:.6f}; |kernel - float64| "
                  f"{abs(g - r):.3e}, |plain - float64| {abs(w - r):.3e}; "
                  f"terms: largest {terms.max().item():.3e}, sum "
                  f"{terms.sum().item():.3e}", flush=True)
    if args.other:
        path = os.path.join(args.other, "hetu_tpu_torch", "ops", "kernels",
                            "build.py")
        spec = importlib.util.spec_from_file_location("other_build", path)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        lib = ctypes.CDLL(other.build("flash_attention_bwd.cu"))
        saved = dict(fa._libs)
        for name in ("hetu_flash_attention_bwd_dq",
                     "hetu_flash_attention_bwd_dkv"):
            fa._libs[name] = fn = getattr(lib, name)
            fn.argtypes, fn.restype = fa._SIGNATURES[name][1], ctypes.c_int
        theirs = fa.flash_attention_bwd(*ins, **kw)
        fa._libs.clear()
        fa._libs.update(saved)
        print(f"{args.other}'s dQ and dK/dV kernels give the same bits "
              f"(dq, dk, dv): "
              f"{[torch.equal(a, b) for a, b in zip(theirs, grads)]}",
              flush=True)
    del ins, grads, plain, bits
    gen = np.random.default_rng((args.seed, 1))
    for n in range(args.draws):
        ins, kw = draw(gen)
        excess = [((g.float() - p.float()).abs()
                   - rtol * p.float().abs()).max().item()
                  for g, p in zip(fa.flash_attention_bwd(*ins, **kw),
                                  fa.flash_attention_bwd_plain(*ins, **kw))]
        print(f"fresh draw {n}: largest excess over 2^-7 |plain| (dq, dk, "
              f"dv) {', '.join(f'{x:.3e}' for x in excess)}; bound {atol}",
              flush=True)


if __name__ == "__main__":
    main()
