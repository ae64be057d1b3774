"""The route table of the port's flash-attention kernels (CPU).

``flash_route`` names the CUDA kernel a launch takes, a pure function of
dtype and shape: "wgmma" (the Hopper forward, dQ and dK/dV kernels:
TMA-fed stages, wgmma products), "mma" (mma.sync m16n8k16) or "simt"
(plain FMA).
Pinned here: the route at every main path's shape; that every shape the
kernels accepted before keeps its kernel or moves from "mma" to "wgmma"
exactly where the documented condition holds (at d = 80 too, for the
forward, dQ and dK/dV alike); and that a CPU tensor still takes the plain
version, counting no launch of any route.
"""

import itertools

import pytest
import torch

from hetu_tpu_torch.ops.kernels import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32


def _route_before(dtype, d):
    """The kernel every launch took before the wgmma kernels: the
    tensor-core kernel for bf16 heads with d % 8 == 0 and d <= 128, the
    plain-FMA kernel otherwise."""
    return "mma" if dtype == BF16 and d % 8 == 0 and d <= 128 else "simt"


# (name, kernel, dtype, d, Sq, Sk, ring groups): the launches of the main
# paths of chip_smoke.py
MAIN_PATHS = [
    # BERT-base training, [64,12,512,64] with a key mask and dropout
    ("bert fwd", "fwd", BF16, 64, 512, 512, 1),
    ("bert dq", "dq", BF16, 64, 512, 512, 1),
    ("bert dkv", "dkv", BF16, 64, 512, 512, 1),
    # bench_llama mesh-less and GPT-small (path i1), causal [8,12,1024,64]
    ("llama fwd", "fwd", BF16, 64, 1024, 1024, 1),
    ("llama dq", "dq", BF16, 64, 1024, 1024, 1),
    ("llama dkv", "dkv", BF16, 64, 1024, 1024, 1),
    # bench_llama under cp=4: one launch a ring step for the 4 ranks
    ("cp4 fwd", "fwd", BF16, 64, 1024, 1024, 4),
    ("cp4 dq", "dq", BF16, 64, 1024, 1024, 4),
    ("cp4 dkv", "dkv", BF16, 64, 1024, 1024, 4),
    # the Mistral-width witness, S=8192 under cp=4, d = 128
    ("witness fwd", "fwd", BF16, 128, 8192, 8192, 4),
    ("witness dq", "dq", BF16, 128, 8192, 8192, 4),
    ("witness dkv", "dkv", BF16, 128, 8192, 8192, 4),
    # the witness's block shape timed in chip_smoke.py, one block pair
    ("block fwd", "fwd", BF16, 128, 2048, 2048, 1),
    ("block dq", "dq", BF16, 128, 2048, 2048, 1),
    ("block dkv", "dkv", BF16, 128, 2048, 2048, 1),
]
# GPT-3 2.7B's widths (path i2), causal [2,32,2048,80] with dropout: the
# forward, dQ and dK/dV on the wgmma kernels
GPT_27B_PATH = [
    ("gpt-2.7b fwd", "fwd", BF16, 80, 2048, 2048, 1, "wgmma"),
    ("gpt-2.7b dq", "dq", BF16, 80, 2048, 2048, 1, "wgmma"),
    ("gpt-2.7b dkv", "dkv", BF16, 80, 2048, 2048, 1, "wgmma"),
]


@pytest.mark.parametrize(
    "case", [c + ("wgmma",) for c in MAIN_PATHS] + GPT_27B_PATH,
    ids=[c[0] for c in MAIN_PATHS + GPT_27B_PATH])
def test_main_path_routes(case):
    _, kernel, dtype, d, sq, sk, n, want = case
    assert fa.flash_route(kernel, dtype, d, sq, sk, n) == want


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_every_accepted_shape_keeps_its_kernel_or_moves_to_wgmma(kernel):
    """Every (dtype, d, S, ring) the wrappers accept: the kernel it took
    before, or "wgmma" in place of "mma" exactly on bf16 heads of d = 64,
    80 or 128 with Sq, Sk >= 128 whose ring
    groups hold whole 128-row tiles of the kernel's items: q rows for the
    forward and dQ, K/V rows for dK/dV (here Sq = Sk, so the two lengths
    agree)."""
    heads = (64, 80, 128)
    ds = [8, 16, 32, 40, 48, 64, 72, 80, 96, 120, 128, 136, 256, 264, 512]
    lengths = [128, 192, 200, 256, 384, 512, 1000, 1024, 2048]
    for dtype, d, s, n in itertools.product((BF16, F32), ds, lengths,
                                            (1, 2, 3, 4, 8)):
        if n > 1 and s % (64 * n):
            continue  # refused by the ring's check, before and after
        before = _route_before(dtype, d)
        got = fa.flash_route(kernel, dtype, d, s, s, n)
        group = s // n  # Sq / n for fwd and dq, Sk / n for dkv
        moves = (dtype == BF16 and d in heads
                 and (n == 1 or group % 128 == 0))
        assert got == ("wgmma" if moves else before), (dtype, d, s, n)


def test_short_blocks_keep_the_mma_kernel():
    # a 64-row group or block does not fill a 128-row q tile
    assert fa.flash_route("fwd", BF16, 64, 256, 256, 4) == "mma"
    assert fa.flash_route("dq", BF16, 128, 64, 64, 1) == "mma"
    assert fa.flash_route("fwd", BF16, 64, 128, 64, 1) == "mma"
    # d = 96 and f32 keep theirs
    assert fa.flash_route("fwd", BF16, 96, 1024, 1024) == "mma"
    assert fa.flash_route("dq", F32, 64, 1024, 1024) == "simt"


# (kernel, d, Sq, Sk, ring groups, route) at the edges of the d = 80 and
# d = 96 gates: the forward, dQ and dK/dV at d = 80 take the wgmma kernels
# under the rule of d = 64 and 128; 64- and 192-row ring groups, S < 128
# and every launch at d = 96 stay on mma.sync
HEAD_EDGES = [
    ("fwd", 80, 2048, 2048, 1, "wgmma"),
    ("fwd", 80, 1000, 1000, 1, "wgmma"),   # ragged S, masked in-kernel
    ("fwd", 80, 128, 128, 1, "wgmma"),     # one 128-row q tile
    ("fwd", 80, 8192, 8192, 4, "wgmma"),   # ring groups of 2048 rows
    ("fwd", 80, 512, 1024, 2, "wgmma"),    # 256-row q groups
    ("dq", 80, 2048, 2048, 1, "wgmma"),
    ("dkv", 80, 2048, 2048, 1, "wgmma"),
    ("dq", 80, 8192, 8192, 4, "wgmma"),    # ring groups of 2048 rows
    ("dkv", 80, 8192, 8192, 4, "wgmma"),
    ("dq", 80, 1000, 1000, 1, "wgmma"),    # ragged S, masked in-kernel
    ("dq", 80, 128, 128, 1, "wgmma"),      # one 128-row q tile
    ("dq", 80, 512, 1024, 2, "wgmma"),     # 256-row q groups
    ("dq", 80, 256, 256, 4, "mma"),        # 64-row ring groups
    ("dq", 80, 768, 768, 4, "mma"),        # 192-row groups: 1.5 q tiles
    ("dq", 80, 128, 256, 2, "mma"),        # 64-row q groups
    ("dq", 80, 127, 127, 1, "mma"),        # S below one q tile
    ("dq", 80, 128, 64, 1, "mma"),         # Sk below 128
    ("fwd", 80, 256, 256, 4, "mma"),       # 64-row ring groups
    ("fwd", 80, 768, 768, 4, "mma"),       # 192-row groups: 1.5 q tiles
    ("fwd", 80, 128, 256, 2, "mma"),       # 64-row q groups
    ("fwd", 80, 127, 127, 1, "mma"),       # S below one q tile
    ("fwd", 80, 128, 64, 1, "mma"),        # Sk below 128
    ("fwd", 96, 2048, 2048, 1, "mma"),
    ("dq", 96, 2048, 2048, 1, "mma"),
    ("dkv", 96, 2048, 2048, 1, "mma"),
    ("fwd", 96, 8192, 8192, 4, "mma"),
    ("fwd", 96, 256, 256, 4, "mma"),
    ("fwd", 96, 127, 127, 1, "mma"),
]


@pytest.mark.parametrize("case", HEAD_EDGES,
                         ids=[f"{c[0]}-d{c[1]}-{c[2]}x{c[3]}-n{c[4]}"
                              for c in HEAD_EDGES])
def test_d80_and_d96_gate_edges(case):
    kernel, d, sq, sk, n, want = case
    assert fa.flash_route(kernel, BF16, d, sq, sk, n) == want
    # f32 at either head stays on plain FMA
    assert fa.flash_route(kernel, F32, d, sq, sk, n) == "simt"


# (dtype, d, Sq, Sk, ring groups, route) at the edges of the dK/dV gate
DKV_EDGES = [
    (BF16, 96, 1024, 1024, 1, "mma"),      # a head the wgmma kernel lacks
    (F32, 64, 1024, 1024, 1, "simt"),      # f32 stays on plain FMA
    (BF16, 64, 128, 127, 1, "mma"),        # Sk below one 128-key item
    (BF16, 64, 127, 128, 1, "mma"),        # Sq below 128
    (BF16, 64, 256, 256, 4, "mma"),        # 64-key ring groups
    (BF16, 128, 768, 768, 4, "mma"),       # 192-key groups: 1.5 items
    (BF16, 64, 256, 512, 2, "wgmma"),      # 256-key groups, 128-row q ones
    (BF16, 64, 128, 256, 2, "wgmma"),      # 64-row q groups: the gate
                                           # reads the K/V groups only
    (BF16, 64, 200, 200, 1, "wgmma"),      # ragged S, masked in-kernel
    (BF16, 128, 1000, 1000, 1, "wgmma"),
    # d = 80 (GPT-3 2.7B's heads) under the same rule
    (BF16, 80, 128, 127, 1, "mma"),        # Sk below one 128-key item
    (BF16, 80, 127, 128, 1, "mma"),        # Sq below 128
    (BF16, 80, 256, 256, 4, "mma"),        # 64-key ring groups
    (BF16, 80, 768, 768, 4, "mma"),        # 192-key groups: 1.5 items
    (BF16, 80, 128, 256, 2, "wgmma"),      # 64-row q groups, 128-key K/V
    (BF16, 80, 1000, 1000, 1, "wgmma"),    # ragged S, masked in-kernel
]


@pytest.mark.parametrize("case", DKV_EDGES,
                         ids=[f"{str(c[0])[6:]}-d{c[1]}-{c[2]}x{c[3]}-n{c[4]}"
                              for c in DKV_EDGES])
def test_dkv_gate_edges(case):
    dtype, d, sq, sk, n, want = case
    assert fa.flash_route("dkv", dtype, d, sq, sk, n) == want


def test_forward_and_dq_gate_reads_the_q_groups():
    # the forward's and dQ's items are q tiles: 64-row q groups stay on
    # mma.sync even where the K/V groups hold whole 128-key tiles
    assert fa.flash_route("fwd", BF16, 64, 128, 256, 2) == "mma"
    assert fa.flash_route("dq", BF16, 64, 128, 256, 2) == "mma"
    assert fa.flash_route("dkv", BF16, 64, 128, 256, 2) == "wgmma"
    # the same at d = 80
    assert fa.flash_route("fwd", BF16, 80, 128, 256, 2) == "mma"
    assert fa.flash_route("dq", BF16, 80, 128, 256, 2) == "mma"
    assert fa.flash_route("dkv", BF16, 80, 128, 256, 2) == "wgmma"


def _rand(*shape, dtype=F32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cpu_tensors_take_the_plain_version(dtype):
    """On CPU tensors every wrapper returns its plain version's result,
    bitwise, and counts no launch of any route."""
    q, k, v, do = (_rand(2, 2, 256, 64, dtype=dtype, seed=i)
                   for i in range(4))
    mask = torch.zeros(2, 1, 1, 256)
    mask[1, ..., 200:] = -10000.0
    seed = torch.tensor([7], dtype=torch.int32)
    before = dict(fa.route_launches)
    counts = [f.launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv, fa.flash_attention_block,
        fa.flash_attention_block_bwd_dq, fa.flash_attention_block_bwd_dkv)]

    o, lse = fa.flash_attention_fwd(q, k, v, mask=mask, dropout_keep=0.9,
                                    seed=seed)
    o_p, lse_p = fa.flash_attention_plain(q, k, v, mask=mask,
                                          dropout_keep=0.9, seed=seed)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    dsum = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, dsum, mask=mask,
                                   dropout_keep=0.9, seed=seed)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, dsum, mask=mask,
                                        dropout_keep=0.9, seed=seed)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, mask=mask,
                                         dropout_keep=0.9, seed=seed)
    for got, want in zip((dq, dk, dv), plain):
        assert torch.equal(got, want)

    ob, lseb = fa.flash_attention_block(q, k, v, 0, 0, ring=(2, 1))
    ob_p, lseb_p = fa.flash_attention_block_plain(q, k, v, 0, 0, ring=(2, 1))
    assert torch.equal(ob, ob_p) and torch.equal(lseb, lseb_p)
    gb = (fa.flash_attention_block_bwd_dq(q, k, v, do, lse, dsum, 0, 0,
                                          ring=(2, 1)),
          *fa.flash_attention_block_bwd_dkv(q, k, v, do, lse, dsum, 0, 0,
                                            ring=(2, 1)))
    gb_p = fa.flash_attention_block_bwd_plain(q, k, v, do, lse, dsum, 0, 0,
                                              ring=(2, 1))
    for got, want in zip(gb, gb_p):
        assert torch.equal(got, want)

    assert dict(fa.route_launches) == before
    assert counts == [f.launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
        fa.flash_attention_bwd_dkv, fa.flash_attention_block,
        fa.flash_attention_block_bwd_dq, fa.flash_attention_block_bwd_dkv)]


def test_route_codes_match_the_c_dispatch():
    # csrc/flash_attention_{fwd,bwd}.cu `dispatch`: 0 plain FMA, 1
    # mma.sync, 2 wgmma; each C entry point takes the route before its
    # stream
    assert fa._ROUTE_CODE == {"simt": 0, "mma": 1, "wgmma": 2}
    for name, (_, argtypes) in fa._SIGNATURES.items():
        if name != "hetu_dropout_keep_mask":
            assert argtypes[-2] is fa._I and argtypes[-3] is fa._I, name
