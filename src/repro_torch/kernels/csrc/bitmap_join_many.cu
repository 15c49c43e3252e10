// Batched bitmap join (AND + popcount) over indexed rows, for Hopper,
// sm_90a.
//
// Replaces the TPU kernel bitmap_join_many_kernel
// (src/repro/kernels/bitmap_join/kernel.py, body _many_kernel).
//
//   counts[b, e] = sum_{w < n_words} popcount(P_b[w]
//                                             & ext_rows[eidx[b, e]][w])
//   P_b = AND_{j < L_b} prefix_rows[pidx[b, j]]
//
// prefix_rows and ext_rows are int32 row stores (rows prefix_stride and
// ext_stride words apart; on the mining path both are the arena's device
// mirror of one transaction segment), read as uint32; pidx [B, L] and
// eidx [B, E] are int32 row indices, counts [B, E] int32. Request b's
// prefix is the AND of its tuple pidx[b, 0..L_b), which ends at the
// first -1 past j = 0 (the streaming engine's delta and query sweeps
// name a tuple of base-item rows; every other sweep has L = 1, one row).
// An index of -1 at pidx[b, 0] or in eidx marks a pad request or a pad
// lane: it reads nothing and its count is 0. Only the first n_words
// words of a row are read, so a mirror's zero tail beyond the data's
// width costs nothing.
//
// What bounds it on an H100: the bytes of the extension rows. Each word
// is read once and feeds one AND, one popcount and one add, about 1
// integer op per byte, far below the card's ops-per-byte balance. At the
// shapes the mining path launches (B = 1..8 requests, E = 64..256 lanes,
// 3,125 words) a grid of one warp per row covered only 32 of 132 SMs and
// each warp streamed its row alone, so load latency, not bytes, set the
// time. This design:
//   - splits the word axis into chunks, so B x ceil(E/8) x chunks blocks
//     fill the card (about two blocks per SM, each warp issuing at least
//     four 16-byte loads per lane); the chunks' partial counts meet in
//     integer atomicAdds into counts, which the C entry zeroes with
//     cudaMemsetAsync on the same stream first (exact and order-free);
//   - keeps a block's prefix chunk in shared memory for its 8 rows, one
//     warp per row; a tuple prefix is ANDed into that chunk as it is
//     loaded (L - 1 more coalesced row reads per block), so no prefix
//     intersection is built in device memory before the launch;
//   - reads each row's 16-byte-aligned body as uint4 and its head and
//     tail words one by one, so rows off the 16-byte grid (a store whose
//     stride is odd, such as 3,125) still stream with 128-bit loads;
//   - exits a block whose request or whose 8 lanes are all padding
//     before it loads anything.
// Rows are read by index from the store, so no gathered [B, E, W] copy
// precedes a launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // rows per block, one per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxChunkWords = 12288;     // 48 KiB of prefix in smem
constexpr int kMinChunkWords = 512;       // >= 4 uint4 loads per lane
constexpr int kBlocksPerSm = 2;           // the grid's target fill

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// grid (chunks, ceil(E / kWarps), B); chunk_words is a multiple of 4,
// so every chunk of a row starts at the same offset mod 16 bytes.
__global__ void __launch_bounds__(kThreads)
bitmap_join_many_kernel(const uint32_t* __restrict__ prefix_rows,
                        const int32_t* __restrict__ pidx,
                        const uint32_t* __restrict__ ext_rows,
                        const int32_t* __restrict__ eidx,
                        int32_t* __restrict__ out, int E, int n_words,
                        int L, long long prefix_stride,
                        long long ext_stride, int chunk_words) {
  extern __shared__ __align__(16) uint32_t s_prefix[];
  const int b = blockIdx.z;
  const int32_t* tuple = pidx + (size_t)b * L;
  const int p = tuple[0];
  if (p < 0) return;                      // pad request: counts stay 0
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.y * kWarps + warp;
  const int row = e < E ? eidx[(size_t)b * E + e] : -1;
  if (!__syncthreads_or(row >= 0)) return;  // all 8 lanes are padding
  const int w0 = blockIdx.x * chunk_words;
  const int n = min(chunk_words, n_words - w0);
  const uint32_t* prow = prefix_rows + (size_t)p * prefix_stride + w0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    uint32_t v = prow[i];
    for (int j = 1; j < L; ++j) {         // L = 1: one row, no loop
      const int q = tuple[j];
      if (q < 0) break;                   // the tuple ends
      v &= prefix_rows[(size_t)q * prefix_stride + w0 + i];
    }
    s_prefix[i] = v;
  }
  __syncthreads();
  if (row < 0) return;
  const uint32_t* ec = ext_rows + (size_t)row * ext_stride + w0;
  // words before the row's first 16-byte boundary
  const int h = min(
      (int)(((16u - (uint32_t)(reinterpret_cast<uintptr_t>(ec) & 15u)) &
             15u) >> 2),
      n);
  int acc = 0;
  if (lane < h) acc += __popc(__ldg(ec + lane) & s_prefix[lane]);
  const int n4 = (n - h) >> 2;
  const uint4* ev = reinterpret_cast<const uint4*>(ec + h);
  if (h == 0) {
    const uint4* pv = reinterpret_cast<const uint4*>(s_prefix);
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) {
      const uint4 x = __ldg(ev + i);
      const uint4 q = pv[i];
      acc += __popc(x.x & q.x) + __popc(x.y & q.y) + __popc(x.z & q.z) +
             __popc(x.w & q.w);
    }
  } else {
    const uint32_t* ps = s_prefix + h;
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) {
      const uint4 x = __ldg(ev + i);
      const uint32_t* q = ps + 4 * i;
      acc += __popc(x.x & q[0]) + __popc(x.y & q[1]) + __popc(x.z & q[2]) +
             __popc(x.w & q[3]);
    }
  }
  for (int i = h + 4 * n4 + lane; i < n; i += 32)
    acc += __popc(__ldg(ec + i) & s_prefix[i]);
  acc = warp_sum(acc);
  if (lane == 0 && acc) atomicAdd(out + (size_t)b * E + e, acc);
}

}  // namespace

// Zeroes counts and launches on `stream`; returns the first CUDA error
// (0 = launched). The caller checks shapes and indices: B in [1, 65535],
// E in [1, 8 * 65535], L >= 1, 1 <= n_words <= each store's row width,
// every index -1 or a row of its store, int32 words 4-byte aligned.
extern "C" int bitmap_join_many(const void* prefix_rows, const void* pidx,
                                const void* ext_rows, const void* eidx,
                                void* out, int B, int E, int n_words,
                                int L, long long prefix_stride,
                                long long ext_stride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)B * E * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  // as many word chunks as fill the card, none narrower than
  // kMinChunkWords (unless the row is), none wider than shared memory
  const long long row_blocks = (long long)((E + kWarps - 1) / kWarps) * B;
  const long long want = ((long long)sms * kBlocksPerSm + row_blocks - 1) /
                         row_blocks;
  long long chunks = want < n_words / kMinChunkWords
                         ? want : n_words / kMinChunkWords;
  const long long fit = (n_words + kMaxChunkWords - 1) / kMaxChunkWords;
  if (chunks < fit) chunks = fit;
  if (chunks < 1) chunks = 1;
  int chunk_words = (int)((n_words + chunks - 1) / chunks);
  chunk_words = (chunk_words + 3) & ~3;
  chunks = (n_words + chunk_words - 1) / chunk_words;
  const dim3 grid((unsigned)chunks, (E + kWarps - 1) / kWarps, B);
  bitmap_join_many_kernel<<<grid, kThreads,
                            (size_t)chunk_words * sizeof(uint32_t), s>>>(
      static_cast<const uint32_t*>(prefix_rows),
      static_cast<const int32_t*>(pidx),
      static_cast<const uint32_t*>(ext_rows),
      static_cast<const int32_t*>(eidx), static_cast<int32_t*>(out), E,
      n_words, L, prefix_stride, ext_stride, chunk_words);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* bitmap_join_many_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
