// pack_write: the packed embedding table's gradient write on Hopper.
//
// Replaces the Pallas TPU kernel of hetu_tpu/ops/pallas/sparse_densify.py
// `pack_write` (`_make_kernel`, `pl.pallas_call` at line 152) together with
// the duplicate merge that feeds it (`_merge_duplicate_lines`, a cumsum
// difference over the sorted lines).  Its function:
//
//   out[p] = sum of lines[i] over every i with pack_ids[i] == p,
//
// 128 f32 lanes per line, ids < 0 (padding) and ids >= p_rows skipped, and
// out left as the caller's zero fill where no id lands.  The caller sorts
// the ids (torch.sort, stable: XLA's argsort outside the TPU kernel) and
// passes the sorted ids with the permutation; the zero fill is torch.zeros
// (the TPU kernel aliases XLA's zero broadcast into its output).
//
// Summation order, fixed by design: a tree over the sorted positions.  A
// leaf is 32 consecutive positions; a node of level l >= 1 holds 32
// consecutive nodes of level l - 1 (32^(l+1) positions).  A leaf sums the
// lines of each run of equal ids that it holds in sorted order, starting
// from 0; a node sums, from 0 and in order, the pieces of each run that its
// children hold.  A run's total is its piece at the first node that holds
// it whole.  `pack_write_ordered` in ops/kernels/sparse_densify.py computes
// the same tree in plain PyTorch, and the kernel equals it bitwise.
//
// Design.  One block per leaf.  Its warps read the leaf's 32 ids and
// permutation entries (coalesced), and each owns the run ends in a slice of
// the leaf: it copies the lines of those runs from their start in the leaf
// into shared memory (cp.async, a 512-byte line a warp instruction, every
// copy before the first add), then adds each run in order and writes the
// runs that lie whole in the leaf to out at once.  A run that starts in the
// leaf and ends inside the next one is finished here (the last warp loads
// its continuation too; the next leaf skips it): 0 + A + B is the tree's
// value for a run over two leaves at any level.  The pieces of a longer run
// climb the tree (one warp of the leaf): the warp stores its piece in a
// scratch slot, fences, and counts itself in at the parent node with an
// integer atomic; the warp that arrives last reads its siblings' pieces
// (L2, past L1) and sums them in child order, then climbs on, until the
// node holds the run whole.  A run's extent inside a node is read off the
// sorted ids at the children's borders (one id pair per lane).  No warp
// waits for another's climb, every output line has exactly one writer, and
// no float is added atomically: two launches on the same inputs give the
// same bits.  The arriving warp resets its counter, so the counters are
// zero after the launch as before it.  Offsets are 64-bit.  A launch of few
// leaves (the W&D step's 104) gives each 16 warps, so that each warp's
// chain of dependent instructions is short; a launch of many gives each 4,
// so that more leaves fit on an SM at once.  Neither changes the order.
//
// What bounds it on the H100: the bytes.  The function reads each id,
// permutation entry and line once (M * (4 + 8 + 512) bytes; the bound
// chip_smoke.py states counts the ids and lines) and writes each unique
// line once; at the W&D main path (M = 3,328) that is ~1 us at 3.35 TB/s,
// below a launch.  Under skew a run of k equal ids is read by k / 32
// blocks at once and combined in ceil(log32(k)) levels, each a few
// dependent L2 round trips.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFan = 32;           // positions a leaf, children a node
// warps a leaf (a block): more shorten each warp's chain of dependent
// instructions, which bounds a launch of few leaves; fewer fit more leaves
// on an SM at once, which bounds a launch of many
constexpr int kWarpsFew = 16;
constexpr int kWarpsMany = 4;
constexpr int64_t kFewLeaves = 512;  // a wave of 512-thread blocks (H100)
constexpr int kMore = 8;           // continuation lines loaded a batch

// A leaf's staging buffer in shared memory: its lines (later the pieces a
// climb combines; a line that two warps need is copied by both, with the
// same bytes), a batch of continuation lines, and the sums of the runs at
// its ends that climb; each lane copies and reads back its own 16 bytes of
// every line.
struct Stage {
  float4 line[kFan][32];
  float4 more[kMore][32];
  float4 sum[2][32];
};

struct Args {
  const int32_t* __restrict__ ids;    // [m] sorted ascending
  const int64_t* __restrict__ order;  // [m], lines row of each position
  const float4* __restrict__ lines;   // [*, 32] (128 f32 a row)
  float4* __restrict__ out;           // [p_rows, 32], zero-filled
  float4* __restrict__ pieces;        // [slots, 32] scratch
  int* __restrict__ counters;         // [slots], zero on entry and exit
  int64_t m;
  int64_t p_rows;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

__device__ __forceinline__ void copy_async(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ bool valid_id(const Args& a, int32_t id) {
  return id >= 0 && id < a.p_rows;
}

// Whether the run of `id` covers the border before position p: positions
// p - 1 and p both hold it.
__device__ __forceinline__ bool covers(const Args& a, int64_t p, int32_t id) {
  return p > 0 && p < a.m && __ldg(a.ids + p - 1) == id &&
         __ldg(a.ids + p) == id;
}

// Climbs the piece of run `id` held by leaf `k` up the tree, until a node
// holds the run whole (then writes out) or another warp is still to arrive
// at a node (then returns; that warp carries the sum on).  `slot` is 0 if
// the run entered the leaf across its left border, 1 if it starts there.
// Warp-uniform.
__device__ void climb(const Args& a, Stage& st, int32_t id, int64_t k,
                      float4 piece, int slot, int lane) {
  int64_t span = kFan;  // positions under one child
  int64_t base = 0;     // first scratch slot of the children's level
  for (;;) {
    const int64_t node = k / kFan;
    const int kk = (int)(k % kFan);
    const int64_t first = node * kFan;  // the node's first child
    // the piece is stored before the run's extent in the node is known,
    // so that the store and the fence overlap the border loads
    __stcg(&a.pieces[(base + 2 * k + slot) * 32 + lane], piece);
    // lane j: does the run cover child j's left border?
    const bool cov_lane = covers(a, (first + lane) * span, id);
    const bool cov_right = covers(a, (first + kFan) * span, id);
    __syncwarp();      // every lane's store is before lane 0's count,
    __threadfence();   // and visible to the warp that arrives last
    const unsigned cov = __ballot_sync(~0u, cov_lane);
    const unsigned upto = kk == kFan - 1 ? ~0u : (2u << kk) - 1u;
    const unsigned gap_left = ~cov & upto & ~1u;
    const int f = gap_left ? 31 - __clz(gap_left) : 0;  // first child
    const unsigned gap_right = ~cov & ~upto;
    const int l = gap_right ? __ffs(gap_right) - 2 : kFan - 1;  // last
    const bool enters = f == 0 && (cov & 1u);
    const bool leaves = l == kFan - 1 && cov_right;
    if (l > f) {
      int* counter = a.counters + base + 2 * (first + f) + (enters ? 0 : 1);
      int arrived = 0;
      if (lane == 0) arrived = atomicAdd(counter, 1);
      arrived = __shfl_sync(~0u, arrived, 0);
      if (arrived != l - f) return;
      __threadfence();  // the other children's pieces are visible
      __syncwarp();
      if (lane == 0) *counter = 0;
      // slot 0: the run entered the child across its left border; 1: it
      // starts in the child
      for (int c = f; c <= l; ++c) {
        const int s = (c == f && !enters) ? 1 : 0;
        copy_async(&st.line[c][lane],
                   &a.pieces[(base + 2 * (first + c) + s) * 32 + lane]);
      }
      copy_wait();
      float4 acc = zero4();
#pragma unroll 8
      for (int c = f; c <= l; ++c) add4(acc, st.line[c][lane]);
      piece = acc;
    }
    if (!enters && !leaves) {
      a.out[(int64_t)id * 32 + lane] = piece;
      return;
    }
    base += 2 * ((a.m + span - 1) / span);
    k = node;
    slot = enters ? 0 : 1;
    span *= kFan;
  }
}

template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
pack_write_kernel(const Args a) {
  constexpr int kSlice = kFan / kWarps;  // positions whose run ends a
                                         // warp owns
  __shared__ Stage st;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t leaf = blockIdx.x;
  const int64_t base = leaf * kFan;
  const int n = (int)min((int64_t)kFan, a.m - base);
  // one round of loads (each warp the same; L1 serves the others): the
  // leaf's ids and permutation, the next leaf's, and the ids just before
  // and after that the runs at the ends need
  const int64_t nxt = base + kFan + lane;  // the next leaf's positions
  const int32_t id = lane < n ? a.ids[base + lane] : 0;
  const int64_t ord = lane < n ? a.order[base + lane] : 0;
  const int32_t id_next = nxt < a.m ? a.ids[nxt] : 0;
  const int64_t ord_next = nxt < a.m ? a.order[nxt] : 0;
  const int32_t id_prev = base > 0 ? a.ids[base - 1] : 0;
  const int32_t id_prev2 = base > kFan ? a.ids[base - kFan - 1] : 0;
  const int32_t id_prev1 = base > kFan ? a.ids[base - kFan] : 0;
  const int32_t id_after = base + 2 * kFan < a.m ? a.ids[base + 2 * kFan] : 0;

  const int32_t id_up = __shfl_up_sync(~0u, id, 1);
  const bool start =
      lane < n && (lane == 0 ? base == 0 || id_prev != id : id_up != id);
  const unsigned starts = __ballot_sync(~0u, start);
  const int32_t head_id = __shfl_sync(~0u, id, 0);
  const int32_t tail_id = __shfl_sync(~0u, id, n - 1);
  // the run at the leaf's end continues over `cont` positions of the next
  // leaf (32: through all of it)
  const unsigned same_next =
      __ballot_sync(~0u, nxt < a.m && id_next == tail_id);
  const bool tail_crosses = n == kFan && (same_next & 1u);
  const int cont = !tail_crosses ? 0
                   : same_next == ~0u ? kFan
                                      : __ffs(~same_next) - 1;
  const bool ends_in_next =
      cont < kFan || !(base + 2 * kFan < a.m && id_after == tail_id);
  // a run starting here and ending in the next leaf is this leaf's whole
  const bool tail_pair = tail_crosses && starts != 0 && ends_in_next;
  const bool tail_climbs = tail_crosses && starts != 0 && !tail_pair;
  // the run at the leaf's start entered from the previous leaf; if it
  // started in that leaf and ends in this one, that leaf sums it
  const bool head_in = !(starts & 1u);
  const int head_len = starts ? __ffs(starts) - 1 : n;
  const bool head_ends_here = starts != 0 || !tail_crosses;
  const bool head_from_prev =
      base <= kFan || !(id_prev2 == head_id && id_prev1 == head_id);
  const bool head_pair = head_in && head_ends_here && head_from_prev;
  // per position: its line is loaded; a run ends there
  const unsigned loaded = __ballot_sync(
      ~0u, lane < n && valid_id(a, id) && !(head_pair && lane < head_len));
  const unsigned ends = __ballot_sync(
      ~0u, lane < n && (lane == n - 1 || (lane < kFan - 1 &&
                                          ((starts >> (lane + 1)) & 1u))));
  const bool pair_valid = tail_pair && valid_id(a, tail_id);

  // each warp sums, in sorted order from 0, the runs that end in its
  // slice of the leaf, from their start in the leaf.  It loads their lines
  // itself (a line that two warps need is copied by both, with the same
  // bytes), so it waits for its own copies only; the last warp also loads
  // the run that continues into the next leaf.
  const int q0 = warp * kSlice;
  const unsigned mine = ends & (((1u << kSlice) - 1u) << q0);
  const bool pair_here = warp == kWarps - 1 && pair_valid;
  if (mine) {
    const unsigned upto_q0 = (2u << q0) - 1u;
    const int from = (starts & upto_q0) ? 31 - __clz(starts & upto_q0) : 0;
    const int to = 32 - __clz(mine);  // past the slice's last run end
#pragma unroll 4
    for (int j = from; j < to; ++j) {
      const int64_t oj = __shfl_sync(~0u, ord, j);
      if ((loaded >> j) & 1u)
        copy_async(&st.line[j][lane], &a.lines[oj * 32 + lane]);
    }
    if (pair_here) {
#pragma unroll
      for (int u = 0; u < kMore; ++u) {
        const int64_t ou = __shfl_sync(~0u, ord_next, u);
        if (u < cont)
          copy_async(&st.more[u][lane], &a.lines[ou * 32 + lane]);
      }
    }
    copy_wait();
    // no run ends in [from, q0): the run holding q0 starts at from
    float4 acc = zero4();
#pragma unroll 8
    for (int j = from; j < q0; ++j)
      if ((loaded >> j) & 1u) add4(acc, st.line[j][lane]);
#pragma unroll
    for (int u = 0; u < kSlice; ++u) {
      const int j = q0 + u;
      const int32_t idj = __shfl_sync(~0u, id, j);
      if (j < to) {
        if ((loaded >> j) & 1u) add4(acc, st.line[j][lane]);
        if ((mine >> j) & 1u) {
          const unsigned upto = j == kFan - 1 ? ~0u : (2u << j) - 1u;
          if ((starts & upto) == 0) {
            st.sum[0][lane] = acc;  // entered from the left
          } else if (j == n - 1 && tail_crosses) {
            st.sum[1][lane] = acc;
          } else if (valid_id(a, idj)) {
            a.out[(int64_t)idj * 32 + lane] = acc;
          }
          acc = zero4();
        }
      }
    }
  }
  if (pair_here) {
    float4 rest = zero4();  // the continuation, from 0 in sorted order
    for (int c0 = 0; c0 < cont; c0 += kMore) {
      if (c0 > 0) {
        for (int u = 0; u < kMore && c0 + u < cont; ++u)
          copy_async(&st.more[u][lane],
                     &a.lines[__shfl_sync(~0u, ord_next, c0 + u) * 32 +
                              lane]);
        copy_wait();
      }
      for (int u = 0; u < kMore && c0 + u < cont; ++u)
        add4(rest, st.more[u][lane]);
    }
    float4 sum = zero4();
    add4(sum, st.sum[1][lane]);
    add4(sum, rest);
    a.out[(int64_t)tail_id * 32 + lane] = sum;
  }
  const bool head_climbs = head_in && !head_pair && valid_id(a, head_id);
  const bool tail_valid = tail_climbs && valid_id(a, tail_id);
  if (!head_climbs && !tail_valid) return;
  __syncthreads();
  if (warp == 0) {
    if (head_climbs) climb(a, st, head_id, leaf, st.sum[0][lane], 0, lane);
    if (tail_valid) climb(a, st, tail_id, leaf, st.sum[1][lane], 1, lane);
  }
}

}  // namespace

// ids_sorted: [m] int32 sorted ascending; order: [m] int64 with
// ids_sorted[k] = ids[order[k]]; lines: [*, 128] f32, 16-byte aligned;
// out: [p_rows, 128] f32, zero-filled; pieces: [slots, 128] f32 and
// counters: [slots] int32, zero, where slots is two for each node of every
// tree level that has more than one (`tree_slots` in sparse_densify.py).
// Returns a cudaError_t (0 = launched; m = 0 launches nothing).
extern "C" int hetu_pack_write(const int32_t* ids_sorted, const int64_t* order,
                               const float* lines, float* out, float* pieces,
                               int* counters, int64_t m, int64_t p_rows,
                               void* stream) {
  if (m < 0 || p_rows < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const int64_t blocks = (m + kFan - 1) / kFan;  // one a leaf
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Args a{ids_sorted, order, reinterpret_cast<const float4*>(lines),
               reinterpret_cast<float4*>(out),
               reinterpret_cast<float4*>(pieces), counters, m, p_rows};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks <= kFewLeaves)
    pack_write_kernel<kWarpsFew><<<(unsigned)blocks, kWarpsFew * 32, 0, s>>>(a);
  else
    pack_write_kernel<kWarpsMany><<<(unsigned)blocks, kWarpsMany * 32, 0, s>>>(
        a);
  return (int)cudaGetLastError();
}
