"""Time the row lookup's backward three ways on one card, alone and in
BERT-base's training step.

    python3 -m hetu_tpu_torch.tools.lookup_ab [--steps 10] [--seed 0]

The three backwards of ``table[ids]`` (``ops/embedding.py``):

- ``run_sums``: the port's (``_RowLookup``): the ids sorted, each run of
  equal ids summed in a fixed tree order (``_run_sums``), each row given
  its run's sum;
- ``index_add``: ``index_select``'s own backward, ``index_add_`` into
  zeros (float atomics: another order, so other bits, at every run);
- ``index_put``: ``index_put_(accumulate=True)`` into zeros (the ids
  sorted, each run summed one id after another).

Alone, each is captured in a CUDA graph (as a step runs it) and replayed:
the median over 5 windows of 20 replays (CUDA events), beside its bound
(the ids and gradient rows read once, the table's gradient written once,
over 3.35 TB/s), at the main paths' tables, bf16 gradient rows (the
compute dtype): BERT-base's word [30522, 768], position [512, 768] and
token-type [2, 768] tables at B=64 S=512 (32,768 ids), Llama's word
[32000, 768] at B=8 S=1024 (8,192 ids); with uniform ids, a BERT batch's
(Zipf tokens, s = 1.05, lengths S/2..S and [PAD] = 0 after each, as
``chip_smoke.py``'s ``bert_batch``) and Zipf tokens alone.

Then BERT-base training (B=64, S=512, 12 layers, bf16 over f32 masters,
dropout 0.1, AdamW), captured, on that BERT batch, with each backward in
turns (run_sums, index_add, index_put, then the reverse): ms/step by CUDA
events over ``--steps`` steps after 3. The script ends with one JSON line.
Compare the designs only within one call: the card's clocks and power
limit differ between machines.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import types

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12


def zipf_tokens(rng, V, shape, s=1.05):
    """Token ids with Zipf frequencies (exponent ``s``) over ``V`` ids, the
    ranks given to ids at random."""
    p = np.arange(1, V + 1, dtype=np.float64) ** -s
    return rng.permutation(V)[rng.choice(V, size=shape, p=p / p.sum())]


def bert_ids(rng, B, S, V=30522):
    """(input ids, token types, attention mask) of a BERT batch: Zipf
    tokens, lengths S/2..S, [PAD] = 0 after each."""
    lengths = rng.integers(S // 2, S + 1, B)
    am = np.arange(S)[None, :] < lengths[:, None]
    ids = np.where(am, zipf_tokens(rng, V, (B, S)), 0)
    types_ = (np.arange(S)[None, :] >= (lengths[:, None] // 2))
    return ids, types_.astype(np.int64), am.astype(np.float32)


def _zeros(ctx, g):
    return g.new_zeros((ctx.rows,) + tuple(g.shape[1:]))


def _index_add(ctx, g):
    (ids,) = ctx.saved_tensors
    return _zeros(ctx, g).index_add_(0, ids, g), None


def _index_put(ctx, g):
    (ids,) = ctx.saved_tensors
    return _zeros(ctx, g).index_put_((ids,), g, accumulate=True), None


def designs():
    from hetu_tpu_torch.ops import embedding
    return {"run_sums": embedding._RowLookup.backward,
            "index_add": _index_add, "index_put": _index_put}


def replay_ms(fn, windows=5, calls=20):
    """Median ms of one call of ``fn`` captured in a CUDA graph, over
    ``windows`` windows of ``calls`` replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[windows // 2]


def alone(rng):
    B, S = 64, 512
    ids, types_, _ = bert_ids(rng, B, S)
    cases = [
        ("bert word, uniform", 30522, rng.integers(0, 30522, (B, S))),
        ("bert word, bert batch", 30522, ids),
        ("bert word, zipf", 30522, zipf_tokens(rng, 30522, (B, S))),
        ("bert position", 512, np.tile(np.arange(S), (B, 1))),
        ("bert token type", 2, types_),
        ("llama word, uniform", 32000, rng.integers(0, 32000, (8, 1024))),
        ("llama word, zipf", 32000, zipf_tokens(rng, 32000, (8, 1024)))]
    out = []
    for label, rows, ids_np in cases:
        ids_t = torch.from_numpy(ids_np.reshape(-1)).cuda()
        D = 768
        g = torch.randn(len(ids_t), D, device="cuda").bfloat16()
        ctx = types.SimpleNamespace(saved_tensors=(ids_t,), rows=rows)
        n_bytes = ids_t.numel() * 8 + g.numel() * 2 + rows * D * 2
        row = {"case": label, "rows": rows, "ids": ids_t.numel(),
               "largest_run": int(np.bincount(ids_np.reshape(-1)).max()),
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        for name, fn in designs().items():
            row[name] = replay_ms(lambda fn=fn: fn(ctx, g))
        print(f"{label}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in row.items() if k != "case"), flush=True)
        out.append(row)
    return out


def bert_train(seed, steps):
    import hetu_tpu_torch as ht
    import hetu_tpu_torch.models as models
    from hetu_tpu_torch.ops import embedding
    rng = np.random.default_rng(seed)
    B, S, V = 64, 512, 30522
    ids, types_, am = bert_ids(rng, B, S)
    mlm = np.full(B * S, -1, np.int64)
    pos = (rng.random(B * S) < 0.15) & (am.reshape(-1) > 0)
    mlm[pos] = zipf_tokens(rng, V, pos.sum())
    arrays = {"input_ids": ids, "token_type_ids": types_,
              "attention_mask": am, "mlm_labels": mlm,
              "nsp_labels": rng.integers(0, 2, B)}
    feed = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    ph = ht.placeholder_op
    feeds = (ph("input_ids", (B, S), dtype=np.int32),
             ph("token_type_ids", (B, S), dtype=np.int32),
             ph("attention_mask", (B, S)),
             ph("mlm_labels", (B * S,), dtype=np.int32),
             ph("nsp_labels", (B,), dtype=np.int32))
    cfg = models.BertConfig(vocab_size=V, hidden_size=768,
                            num_hidden_layers=12, num_attention_heads=12,
                            intermediate_size=3072,
                            max_position_embeddings=512, seq_len=S,
                            hidden_dropout_prob=0.1,
                            attention_probs_dropout_prob=0.1,
                            mlm_bucket_frac=0.25)
    loss = models.BertForPreTraining(cfg).loss(*feeds)
    train_op = ht.AdamWOptimizer(learning_rate=1e-4,
                                 weight_decay=0.01).minimize(loss)
    ways = designs()
    turns = {}
    try:
        for name in ("run_sums", "index_add", "index_put", "index_put",
                     "index_add", "run_sums"):
            embedding._RowLookup.backward = staticmethod(ways[name])
            ex = ht.Executor({"train": [loss, train_op]},
                             compute_dtype=torch.bfloat16, device="cuda",
                             seed=seed, rng_impl="rbg")
            for _ in range(3):
                ex.run("train", feed_dict=feed)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(steps):
                ex.run("train", feed_dict=feed)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / steps
            print(f"bert train, {name}: {ms:.3f} ms/step", flush=True)
            turns.setdefault(name, []).append(ms)
            ex.close()
            del ex
            torch.cuda.empty_cache()
    finally:
        embedding._RowLookup.backward = staticmethod(ways["run_sums"])
    return {name: {"turns_ms": ts, "ms_per_step": sum(ts) / len(ts)}
            for name, ts in turns.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lookup_ab: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    out = {"card": smi, "alone": alone(rng),
           "bert_train": bert_train(args.seed, args.steps)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
