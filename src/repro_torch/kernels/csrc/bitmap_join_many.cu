// Batched bitmap join (AND + popcount) for Hopper, sm_90a.
//
// Replaces the TPU kernel bitmap_join_many_kernel
// (src/repro/kernels/bitmap_join/kernel.py, body _many_kernel).
//
//   counts[b, e] = sum_w popcount(prefixes[b, w] & exts[b, e, w])
//
// prefixes [B, W], exts [B, E, W] and counts [B, E] are int32 tensors;
// the words are read as uint32. Any B, E, W is taken; zero words count
// nothing.
//
// What bounds it on an H100: the bytes of exts. Each extension word is
// read once and feeds one AND, one popcount and one add, about 1 integer
// op per byte, far below the card's ops-per-byte balance. So the design
// streams exts at the memory rate and keeps everything else out of device
// memory: a block keeps its request's prefix row in shared memory for its
// whole sweep over E (the TPU kernel's VMEM-resident prefix tile), each
// warp walks one extension row with 128-bit loads, counts bits with
// __popc and sums across the warp with shuffles. The TPU kernel's E/W
// tiles and its grid-carried accumulator are not carried over: a block
// loops over W itself, in shared-memory chunks when W is very wide.

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

// kVec: W % 4 == 0 and both inputs 16-byte aligned, so every row starts
// on a 16-byte boundary and is read as uint4.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bitmap_join_many_kernel(const uint32_t* __restrict__ prefixes,
                        const uint32_t* __restrict__ exts,
                        int32_t* __restrict__ out, int E, int W) {
  extern __shared__ __align__(16) uint32_t s_prefix[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + warp;
  const uint32_t* prow = prefixes + (size_t)b * W;
  const uint32_t* erow = exts + ((size_t)b * E + (e < E ? e : 0)) * W;
  int acc = 0;
  for (int w0 = 0; w0 < W; w0 += kChunkWords) {
    const int n = min(kChunkWords, W - w0);
    __syncthreads();                   // the previous chunk is consumed
    for (int i = threadIdx.x; i < n; i += kThreads) s_prefix[i] = prow[w0 + i];
    __syncthreads();
    if (e < E) {
      if (kVec) {
        const uint4* ev = reinterpret_cast<const uint4*>(erow + w0);
        const uint4* pv = reinterpret_cast<const uint4*>(s_prefix);
        const int n4 = n >> 2;
#pragma unroll 4
        for (int i = lane; i < n4; i += 32) {
          const uint4 x = __ldg(ev + i);
          const uint4 p = pv[i];
          acc += __popc(x.x & p.x) + __popc(x.y & p.y) + __popc(x.z & p.z) +
                 __popc(x.w & p.w);
        }
      } else {
#pragma unroll 4
        for (int i = lane; i < n; i += 32)
          acc += __popc(__ldg(erow + w0 + i) & s_prefix[i]);
      }
    }
  }
  acc = warp_sum(acc);
  if (e < E && lane == 0) out[(size_t)b * E + e] = acc;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes: B in [1, 65535], E >= 1, W >= 0.
extern "C" int bitmap_join_many(const void* prefixes, const void* exts,
                                void* out, int B, int E, int W,
                                void* stream) {
  const dim3 grid((E + kWarps - 1) / kWarps, B);
  const size_t smem = (size_t)(W < kChunkWords ? W : kChunkWords) * 4;
  const bool vec = W % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(prefixes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(exts) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(prefixes);
  const uint32_t* x = static_cast<const uint32_t*>(exts);
  int32_t* o = static_cast<int32_t*>(out);
  if (vec)
    bitmap_join_many_kernel<true><<<grid, kThreads, smem, s>>>(p, x, o, E, W);
  else
    bitmap_join_many_kernel<false><<<grid, kThreads, smem, s>>>(p, x, o, E, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitmap_join_many_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
