// Shared by the time scans (K4, scan_transposed.cu; K5, cumsum_time.cu):
// the wrap-exact widening of int16/int32 elements, and the middle pass of
// their three-pass scans.
//
// Both scans split time into segments so that every (chunk, segment) is a
// block of its own: pass A writes each segment's per-channel totals to a
// (n_batch, n_seg, C) uint32 scratch tensor, seg_prefix_kernel below turns
// them in place into exclusive prefixes over the segment axis, and pass C
// scans each segment seeded with its prefix. Integer adds wrap and are
// associative, so the split is exact modulo 2^16 or 2^32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ uint32_t widen(T v) {
  // Sign-extend, then wrap: exact modulo the element width.
  return static_cast<uint32_t>(static_cast<int32_t>(v));
}

template <typename T>
__device__ __forceinline__ T narrow(uint32_t v);

template <>
__device__ __forceinline__ int16_t narrow<int16_t>(uint32_t v) {
  return static_cast<int16_t>(static_cast<uint16_t>(v));
}

template <>
__device__ __forceinline__ int32_t narrow<int32_t>(uint32_t v) {
  return static_cast<int32_t>(v);
}

constexpr int kPrefixWarps = 32;

// In-place exclusive prefix over the segment axis of totals (n_batch,
// n_seg, C). A block owns 32 channels of one chunk (lane = channel, so a
// warp reads one 128-byte run per segment); its 32 warps split the
// segments into 32 ranges, sum their own range, exchange the range sums
// through shared memory and walk their range again writing the prefixes.
__global__ void __launch_bounds__(kPrefixWarps * 32)
seg_prefix_kernel(uint32_t* __restrict__ totals, int n_seg, int C,
                  int n_ctiles) {
  __shared__ uint32_t part[kPrefixWarps][32];
  const int b = blockIdx.x / n_ctiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = (blockIdx.x % n_ctiles) * 32 + lane;
  const int per = (n_seg + kPrefixWarps - 1) / kPrefixWarps;
  const int s0 = min(warp * per, n_seg);
  const int s1 = min(s0 + per, n_seg);
  uint32_t* col = totals + static_cast<size_t>(b) * n_seg * C + c;
  uint32_t sum = 0;
  if (c < C) {
#pragma unroll 8
    for (int s = s0; s < s1; ++s) sum += col[static_cast<size_t>(s) * C];
  }
  part[warp][lane] = sum;
  __syncthreads();
  uint32_t run = 0;
  for (int w = 0; w < warp; ++w) run += part[w][lane];
  if (c < C) {
    // Eight loads ahead of the stores that overwrite them.
    for (int s = s0; s < s1; s += 8) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = s + j < s1 ? col[static_cast<size_t>(s + j) * C] : 0u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s + j < s1) col[static_cast<size_t>(s + j) * C] = run;
        run += v[j];
      }
    }
  }
}

inline cudaError_t launch_seg_prefix(uint32_t* totals, int n_batch, int n_seg,
                                     int C, cudaStream_t stream) {
  const int n_ctiles = (C + 31) / 32;
  seg_prefix_kernel<<<static_cast<unsigned>(n_batch) * n_ctiles,
                      kPrefixWarps * 32, 0, stream>>>(totals, n_seg, C,
                                                      n_ctiles);
  return cudaGetLastError();
}

}  // namespace
