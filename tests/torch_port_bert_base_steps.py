"""BERT-base training steps through the JAX package and the port on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_port_bert_base_steps.py \\
        [--batch 8] [--seq 512] [--layers 12] [--steps 3] [--dtype bf16|f32]

Builds the BERT-base pretraining loss at its published widths (vocab 30522,
hidden 768, 12 heads, FFN 3072, 512 positions, MLM bucket 0.25 of the
tokens) with dropout 0 in both packages, carries the JAX executor's initial
params into the port (``Executor.load_params``), and runs
``AdamWOptimizer(1e-4, weight_decay=0.01).minimize(loss)`` in a ``train``
subgraph on one repeated numpy batch (seed 0: sequences padded to between
S/2 and S tokens, ~15% MLM positions), the optimizer and batch of the
slice's main path in ``chip_smoke.py``.  Prints both packages' loss after
each step, then one JSON line of both sequences.  Not a pytest module: at
B=8, S=512 it takes about 2 minutes and 12 GiB.
"""

import argparse
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np
import torch

import hetu_tpu as jt
import hetu_tpu.models as jm
import hetu_tpu_torch as pt
import hetu_tpu_torch.models as pm

V = 30522


def build(pkg, models, B, S, L):
    ph = pkg.placeholder_op
    feeds = (ph("input_ids", (B, S), dtype=np.int32),
             ph("token_type_ids", (B, S), dtype=np.int32),
             ph("attention_mask", (B, S)),
             ph("mlm_labels", (B * S,), dtype=np.int32),
             ph("nsp_labels", (B,), dtype=np.int32))
    cfg = models.BertConfig(vocab_size=V, hidden_size=768,
                            num_hidden_layers=L, num_attention_heads=12,
                            intermediate_size=3072,
                            max_position_embeddings=512, seq_len=S,
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0,
                            mlm_bucket_frac=0.25)
    with pkg.name_scope():
        loss = models.BertForPreTraining(cfg).loss(*feeds)
    train_op = pkg.AdamWOptimizer(learning_rate=1e-4,
                                  weight_decay=0.01).minimize(loss)
    return {"train": [loss, train_op]}


def batch(seed, B, S):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(S // 2, S + 1, B)
    am = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    mlm = np.full(B * S, -1, np.int32)
    pos = (rng.random(B * S) < 0.15) & (am.reshape(-1) > 0)
    mlm[pos] = rng.integers(0, V, pos.sum())
    tt = np.arange(S)[None, :] >= (lengths[:, None] // 2)
    return {"input_ids": rng.integers(0, V, (B, S)).astype(np.int32),
            "token_type_ids": tt.astype(np.int32),
            "attention_mask": am, "mlm_labels": mlm,
            "nsp_labels": rng.integers(0, 2, B).astype(np.int32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = ap.parse_args()
    bf16 = args.dtype == "bf16"
    B, S, L = args.batch, args.seq, args.layers
    jex = jt.Executor(build(jt, jm, B, S, L),
                      compute_dtype=jnp.bfloat16 if bf16 else None)
    tex = pt.Executor(build(pt, pm, B, S, L), device="cpu",
                      compute_dtype=torch.bfloat16 if bf16 else None)
    tex.load_params({k: np.asarray(v) for k, v in jex.params.items()})
    feed = batch(0, B, S)
    losses = {"jax": [], "port": []}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step in range(args.steps):
            for name, ex in (("jax", jex), ("port", tex)):
                out = ex.run("train", feed_dict=feed,
                             convert_to_numpy_ret_vals=True)
                losses[name].append(float(out[0]))
            print(f"step {step + 1}: jax {losses['jax'][-1]:.5f} "
                  f"port {losses['port'][-1]:.5f}", flush=True)
    print(json.dumps({"batch": B, "seq": S, "layers": L,
                      "dtype": args.dtype, **losses}))


if __name__ == "__main__":
    main()
