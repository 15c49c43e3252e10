// Batched sparse gather-intersect over indexed rows, for Hopper, sm_90a.
//
// Replaces the TPU kernel gather_intersect_many_kernel
// (src/repro/kernels/gather_intersect/kernel.py, body _many_kernel).
//
//   counts[b, e] = #{s < lens[b] : tids[b, s] >= 0 and
//                    bit tids[b, s] of ext_rows[eidx[b, e]] is set}
//
// tids [B, S] int32 (-1 = padded lane), lens [B] int32 (the request's
// real tid count), ext_rows an int32 row store read as uint32 (rows
// ext_stride words apart; on the mining path the arena's device mirror),
// eidx [B, E] int32 row indices (-1 = pad lane: reads nothing, count 0),
// counts [B, E] int32. A tid is a bit position: word t >> 5, bit t & 31;
// a tid past the row's first n_words words reads word n_words - 1, as
// the plain version's clamp does.
//
// What bounds it on an H100: scattered 32-byte sectors. Every valid
// (b, e, s) reads one word at a data-dependent address and the memory
// system moves whole sectors, so the work is the distinct (row, sector)
// pairs the tids touch; a request's tids are sorted, so neighbouring
// tids share sectors. A grid of one warp per row, each walking all S
// tids alone, covered 32 of 132 SMs at the mining path's main shape
// (B = 4, S = 1,024, E = 64) and kept one dependent load chain per warp:
// latency set the time. This design turns the loop inside out:
//   - one thread per tid: a block of 256 tids holds each tid's word and
//     bit in registers and sweeps a tile of 8 rows, issuing 8 independent
//     loads per thread, so 2,048 loads per block are in flight at once;
//     a warp's 32 sorted tids fall on few sectors of each row;
//   - a warp's count for a row is __popc(__ballot_sync(...)); the block
//     sums its 8 warps in shared memory and adds its per-row total to
//     counts with one integer atomicAdd (counts are zeroed by
//     cudaMemsetAsync on the same stream first; exact and order-free);
//   - grid (tid tiles, row tiles, B): 4 x 8 x 4 = 128 blocks at the main
//     shape; a tile past lens[b] and a tile of pad lanes exit before any
//     load, so padding costs no memory traffic.
// Rows are read by index from the store, so no gathered [B, E, W] copy
// precedes a launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // tids per block, one each
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // extension rows per block

__global__ void __launch_bounds__(kThreads)
gather_intersect_many_kernel(const int32_t* __restrict__ tids,
                             const int32_t* __restrict__ lens,
                             const uint32_t* __restrict__ ext_rows,
                             const int32_t* __restrict__ eidx,
                             int32_t* __restrict__ out, int E, int S,
                             int n_words, long long ext_stride) {
  __shared__ int s_counts[kRows][kWarps];
  const int b = blockIdx.z;
  const int len = min(lens[b], S);
  const int s0 = blockIdx.x * kThreads;
  if (s0 >= len) return;                  // past the request's tids
  const int e0 = blockIdx.y * kRows;
  int rows[kRows];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    rows[r] = e0 + r < E ? eidx[(size_t)b * E + e0 + r] : -1;
    any |= rows[r] >= 0;
  }
  if (!any) return;                       // a tile of pad lanes
  const int s = s0 + threadIdx.x;
  const int t = s < len ? tids[(size_t)b * S + s] : -1;
  const bool valid = t >= 0;
  const int word = valid ? min(t >> 5, n_words - 1) : 0;
  uint32_t w[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    w[r] = valid && rows[r] >= 0
               ? __ldg(ext_rows + (size_t)rows[r] * ext_stride + word)
               : 0u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t bit = (uint32_t)t & 31u;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const unsigned m = __ballot_sync(0xffffffffu, (w[r] >> bit) & 1u);
    if (lane == 0) s_counts[r][warp] = __popc(m);
  }
  __syncthreads();
  // a pad lane's words are 0, so its sum is 0 and it adds nothing
  if (threadIdx.x < kRows && e0 + (int)threadIdx.x < E) {
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) sum += s_counts[threadIdx.x][i];
    if (sum) atomicAdd(out + (size_t)b * E + e0 + threadIdx.x, sum);
  }
}

}  // namespace

// Zeroes counts and launches on `stream`; returns the first CUDA error
// (0 = launched). The caller checks shapes and indices: B in [1, 65535],
// E in [1, 8 * 65535], S >= 1, 1 <= n_words <= the store's row width,
// every index -1 or a row of the store.
extern "C" int gather_intersect_many(const void* tids, const void* lens,
                                     const void* ext_rows, const void* eidx,
                                     void* out, int B, int E, int S,
                                     int n_words, long long ext_stride,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * E * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kThreads - 1) / kThreads, (E + kRows - 1) / kRows,
                  B);
  gather_intersect_many_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int32_t*>(tids), static_cast<const int32_t*>(lens),
      static_cast<const uint32_t*>(ext_rows),
      static_cast<const int32_t*>(eidx), static_cast<int32_t*>(out), E, S,
      n_words, ext_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gather_intersect_many_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
