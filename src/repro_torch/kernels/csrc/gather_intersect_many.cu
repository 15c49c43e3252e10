// Batched sparse gather-intersect for Hopper, sm_90a.
//
// Replaces the TPU kernel gather_intersect_many_kernel
// (src/repro/kernels/gather_intersect/kernel.py, body _many_kernel).
//
//   counts[b, e] = sum_s bit(exts[b, e], tids[b, s])
//
// tids [B, S] int32 (-1 = padded lane), exts [B, E, W] int32 read as
// uint32, counts [B, E] int32. A tid is a bit position: word t >> 5, bit
// t & 31. A tid past the last word reads the last word, as the plain
// version's clamp does.
//
// What bounds it on an H100: scattered 32-byte sectors. Every valid
// (b, e, s) reads one extension word at a data-dependent address, and the
// memory system moves whole 32-byte sectors, so the kernel moves at most
// B*E*S sectors, fewer where neighbouring tids share one. The design
// exploits exactly that: a block stages tids[b] in shared memory (in
// chunks when S is large) and each warp walks one extension row, lane l
// testing tids l, l+32, ...; since a request's tids are sorted, the 32
// loads of one warp step fall on few sectors. The loop body is branch-free
// (a padded lane loads word 0 and adds 0), so unrolled steps keep several
// independent loads in flight. The TPU kernel's word-major transpose of
// exts and its E tile are not carried over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // one extension row per warp
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 4096;           // 16 KiB of tids in smem

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gather_intersect_many_kernel(const int32_t* __restrict__ tids,
                             const uint32_t* __restrict__ exts,
                             int32_t* __restrict__ out, int E, int S,
                             int W) {
  __shared__ int32_t s_tids[kChunk];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  const int32_t* trow = tids + (size_t)b * S;
  const uint32_t* erow = exts + ((size_t)b * E + (e < E ? e : 0)) * W;
  int acc = 0;
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int n = min(kChunk, S - s0);
    __syncthreads();                   // the previous chunk is consumed
    for (int i = threadIdx.x; i < n; i += kThreads) s_tids[i] = trow[s0 + i];
    __syncthreads();
    if (e < E) {
#pragma unroll 8
      for (int i = lane; i < n; i += 32) {
        const int t = s_tids[i];
        const bool valid = t >= 0;
        const int w = valid ? min(t >> 5, W - 1) : 0;
        const uint32_t bit = (__ldg(erow + w) >> (t & 31)) & 1u;
        acc += valid ? static_cast<int>(bit) : 0;
      }
    }
  }
  acc = warp_sum(acc);
  if (e < E && lane == 0) out[(size_t)b * E + e] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes: B in [1, 65535], E >= 1, S >= 1, W >= 1.
extern "C" int gather_intersect_many(const void* tids, const void* exts,
                                     void* out, int B, int E, int S, int W,
                                     void* stream) {
  const dim3 grid((E + kWarps - 1) / kWarps, B);
  gather_intersect_many_kernel<<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tids), static_cast<const uint32_t*>(exts),
      static_cast<int32_t*>(out), E, S, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_intersect_many_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
