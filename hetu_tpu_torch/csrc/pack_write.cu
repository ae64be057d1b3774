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
// Design.  One warp per sorted position; the warp that holds the first
// position of a run of equal ids owns that run and the others exit at once.
// The owner finds the run's end 32 ids at a time (a coalesced load and a
// ballot), then adds the run's lines in sorted order, which the stable sort
// makes the input order, each lane holding 4 of the 128 lanes as a float4.
// Loads are issued kUnroll lines ahead of the adds, so a long run keeps
// several 512-byte rows in flight while its sum stays in one fixed order.
// Each output line has exactly one writer, as in the TPU kernel ("unique
// pack ids make the write-only kernel race-free"): no atomics, so two runs
// on the same inputs give the same bits.  Offsets are 64-bit.
//
// What bounds it on the H100: the bytes.  The function reads each id and
// each line once (M * (4 + 512) bytes) and writes each unique line once
// (512 bytes each); at the W&D main path (M = 3,328) that is ~3.4 MB, about
// 1 us at 3.35 TB/s, so a launch costs more than the work.  A run of k
// equal ids is summed by one warp, k dependent adds long: under heavy skew
// one hot line serialises, the price of a fixed summation order without
// atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kUnroll = 8;

__device__ __forceinline__ void add4(float4& acc, const float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// ids_sorted: [m] int32 ascending; order: [m] int64, lines row of each
// sorted position; lines: [*, 128] f32 as float4 [*, 32]; out: [p_rows, 128]
// f32 as float4 [p_rows, 32], zero-filled by the caller.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
pack_write_kernel(const int32_t* __restrict__ ids_sorted,
                  const int64_t* __restrict__ order,
                  const float4* __restrict__ lines, float4* __restrict__ out,
                  int64_t m, int64_t p_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= m) return;
  const int32_t id = ids_sorted[i];
  if (id < 0 || id >= p_rows) return;
  if (i > 0 && ids_sorted[i - 1] == id) return;  // not the head of its run

  // the run's end: the first position past i whose id differs
  int64_t end = i + 1;
  while (true) {
    const int64_t k = end + lane;
    const bool same = k < m && ids_sorted[k] == id;
    const unsigned ballot = __ballot_sync(0xffffffffu, same);
    if (ballot != 0xffffffffu) {
      end += __ffs(~ballot) - 1;
      break;
    }
    end += 32;
  }

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int64_t j = i;
  for (; j + kUnroll <= end; j += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = lines[order[j + u] * 32 + lane];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add4(acc, v[u]);
  }
  for (; j < end; ++j) add4(acc, lines[order[j] * 32 + lane]);
  out[(int64_t)id * 32 + lane] = acc;
}

}  // namespace

// ids_sorted: [m] int32 sorted ascending; order: [m] int64 with
// ids_sorted[k] = ids[order[k]]; lines: [m, 128] f32, 16-byte aligned;
// out: [p_rows, 128] f32, zero-filled.  Returns a cudaError_t (0 =
// launched; m = 0 launches nothing).
extern "C" int hetu_pack_write(const int32_t* ids_sorted, const int64_t* order,
                               const float* lines, float* out, int64_t m,
                               int64_t p_rows, void* stream) {
  if (m < 0 || p_rows < 0) return (int)cudaErrorInvalidValue;
  if (m == 0) return 0;
  const int64_t blocks = (m + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  pack_write_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      ids_sorted, order, reinterpret_cast<const float4*>(lines),
      reinterpret_cast<float4*>(out), m, p_rows);
  return (int)cudaGetLastError();
}
