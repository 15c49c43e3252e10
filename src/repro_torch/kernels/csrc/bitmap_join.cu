// Single-prefix bitmap join (AND + popcount) for Hopper, sm_90a.
//
// Replaces the TPU kernel bitmap_join_kernel
// (src/repro/kernels/bitmap_join/kernel.py, body _kernel).
//
//   counts[e] = sum_w popcount(prefix[w] & exts[e, w])
//
// prefix [W], exts [E, W] and counts [E] are int32 tensors; the words are
// read as uint32. Any E, W is taken; zero words count nothing.
//
// What bounds it on an H100: the bytes of exts. Each extension word is
// read once and feeds one AND, one popcount and one add, about 1 integer
// op per byte, far below the card's ops-per-byte balance. So the design
// streams exts at the memory rate and keeps the prefix out of device
// memory after its first read: a block stages a chunk of the prefix row in
// shared memory once (the TPU kernel's VMEM-resident prefix tile) and
// reuses it for its 8 extension rows, one warp per row; a warp counts bits
// with __popc and sums across its lanes with shuffles. The W loop runs
// inside the block, in shared-memory chunks when W is very wide, so no
// block needs another's partial sum: no second pass, no atomics. The TPU
// kernel's E/W tiles and its grid-carried accumulator are not carried
// over.
//
// Rows need not start on a 16-byte boundary (W % 4 != 0, as at the
// T10I4D100K width W = 3,125): each warp reads its row's first words up
// to the boundary one by one, the body as 128-bit loads, and the last
// words one by one. Its prefix words then come from shared memory as
// four 32-bit reads for each 128-bit load.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;              // one extension row per warp
constexpr int kThreads = kWarps * 32;
constexpr int kChunkWords = 12288;     // 48 KiB of prefix words in smem

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads)
bitmap_join_kernel(const uint32_t* __restrict__ prefix,
                   const uint32_t* __restrict__ exts,
                   int32_t* __restrict__ out, int E, int W) {
  extern __shared__ __align__(16) uint32_t s_prefix[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  const uint32_t* erow = exts + (size_t)(e < E ? e : 0) * W;
  // words before the row's first 16-byte boundary (kChunkWords is a
  // multiple of 4, so every chunk of the row starts the same way)
  const int head =
      (int)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(erow) & 15u)) &
             15u) >> 2);
  int acc = 0;
  for (int w0 = 0; w0 < W; w0 += kChunkWords) {
    const int n = min(kChunkWords, W - w0);
    __syncthreads();                   // the previous chunk is consumed
    for (int i = threadIdx.x; i < n; i += kThreads)
      s_prefix[i] = prefix[w0 + i];
    __syncthreads();
    if (e >= E) continue;
    const uint32_t* ec = erow + w0;
    const int h = min(head, n);
    if (lane < h) acc += __popc(__ldg(ec + lane) & s_prefix[lane]);
    const int n4 = (n - h) >> 2;
    const uint4* ev = reinterpret_cast<const uint4*>(ec + h);
    if (h == 0) {
      const uint4* pv = reinterpret_cast<const uint4*>(s_prefix);
#pragma unroll 4
      for (int i = lane; i < n4; i += 32) {
        const uint4 x = __ldg(ev + i);
        const uint4 p = pv[i];
        acc += __popc(x.x & p.x) + __popc(x.y & p.y) + __popc(x.z & p.z) +
               __popc(x.w & p.w);
      }
    } else {
      const uint32_t* ps = s_prefix + h;
#pragma unroll 4
      for (int i = lane; i < n4; i += 32) {
        const uint4 x = __ldg(ev + i);
        const uint32_t* p = ps + 4 * i;
        acc += __popc(x.x & p[0]) + __popc(x.y & p[1]) +
               __popc(x.z & p[2]) + __popc(x.w & p[3]);
      }
    }
    for (int i = h + 4 * n4 + lane; i < n; i += 32)
      acc += __popc(__ldg(ec + i) & s_prefix[i]);
  }
  acc = warp_sum(acc);
  if (e < E && lane == 0) out[e] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes (E >= 1, W >= 1) and that the inputs are
// contiguous int32 tensors, so every word is 4-byte aligned.
extern "C" int bitmap_join(const void* prefix, const void* exts, void* out,
                           int E, int W, void* stream) {
  const dim3 grid((E + kWarps - 1) / kWarps);
  const size_t smem = (size_t)(W < kChunkWords ? W : kChunkWords) * 4;
  bitmap_join_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(prefix),
      static_cast<const uint32_t*>(exts), static_cast<int32_t*>(out), E, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitmap_join_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
