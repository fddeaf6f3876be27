// K4: transpose + time scan of channel-major integers for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mtscomp_tpu/ops/device_delta.py::
// _cumsum_t_kernel (entry cumsum_time_transposed). Input: (B, C, T_in)
// int16 or int32 elements, one row per channel (an F-order chunk's
// diffs); output: the (B, T, C) time-integrated samples,
//   inclusive:  out[b, t, c] = sum_{i <= t} in[b, c, i]
//   exclusive:  out[b, t, c] = head[b, c] + sum_{i < t} in[b, c, i]
// modulo 2^16 or 2^32 (the element width). The exclusive form seeded by
// the verbatim first samples puts the head at t = 0 with no concatenation
// pass. The output is written at its final shape for any T and C: no
// 128-padding of time or channels, no trim pass.
//
// The TPU computed each 128 x 128 tile's prefix with byte-split matmuls
// on its matrix unit (its vector unit has no fast lane scan) and carried
// the sums across a sequential grid axis. Here integer adds wrap
// natively, and blocks run in no order, so a block owns 32 channels of
// one chunk and walks time itself in tiles of 128 steps, carrying each
// channel's running sum in a register. Each tile: coalesced loads along
// time into a shared (c, t) tile (rows padded to 129 words so the
// column walks below are bank-conflict free); 8 warps each scan a 16-step
// segment for all 32 channels (lane = channel), combining segment totals
// through shared memory; the results land transposed in a shared (t, c)
// tile that is written out as contiguous 32-channel runs per time step.
//
// What bounds it on the H100: bytes (one element read and one written,
// once); the scan is a few integer ops per element. The time walk per
// block limits parallelism to ceil(C / 32) x B blocks (13 x B at 385
// channels), which under-fills 132 SMs at small batches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCt = 32;                  // channels per block
constexpr int kTt = 128;                 // time steps per tile
constexpr int kThreads = 256;
constexpr int kSegs = kThreads / kCt;    // 8 time segments per tile
constexpr int kSeg = kTt / kSegs;        // 16 steps per segment

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

template <typename T, bool kExclusive>
__global__ void __launch_bounds__(kThreads)
scan_transposed_kernel(const T* __restrict__ in, long long in_bstride,
                       long long in_cstride, const T* __restrict__ head,
                       T* __restrict__ out, int C, int T_out, int t_in) {
  __shared__ uint32_t tile[kCt][kTt + 1];
  __shared__ uint32_t otile[kTt][kCt + 1];
  __shared__ uint32_t segtot[kSegs][kCt];

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCt;
  const int tid = threadIdx.x;
  const int c = tid & (kCt - 1);          // scan role: channel
  const int sg = tid >> 5;                // scan role: time segment
  const int cg = c0 + c;
  uint32_t carry = 0;
  if (kExclusive && cg < C) carry = widen(head[static_cast<size_t>(b) * C + cg]);
  const T* src = in + b * in_bstride;

  for (int t0 = 0; t0 < T_out; t0 += kTt) {
    // Load: a warp reads 32 consecutive steps of one channel.
#pragma unroll 4
    for (int k = 0; k < (kCt * kTt) / kThreads; ++k) {
      const int idx = tid + k * kThreads;
      const int lc = idx / kTt;
      const int tt = idx % kTt;
      const int ch = c0 + lc;
      const int t = t0 + tt;
      tile[lc][tt] = (ch < C && t < t_in)
                         ? widen(src[ch * in_cstride + t]) : 0u;
    }
    __syncthreads();

    // Pass 1: segment totals.
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < kSeg; ++q) sum += tile[c][sg * kSeg + q];
    segtot[sg][c] = sum;
    __syncthreads();

    // Pass 2: prefix within the segment, transposed into otile.
    uint32_t run = carry, tile_total = 0;
#pragma unroll
    for (int s = 0; s < kSegs; ++s) {
      const uint32_t v = segtot[s][c];
      run += s < sg ? v : 0u;
      tile_total += v;
    }
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      const int tt = sg * kSeg + q;
      const uint32_t v = tile[c][tt];
      if (kExclusive) {
        otile[tt][c] = run;
        run += v;
      } else {
        run += v;
        otile[tt][c] = run;
      }
    }
    carry += tile_total;
    __syncthreads();

    // Store: one time step's 32 channels per warp instruction.
#pragma unroll 4
    for (int k = 0; k < (kTt * kCt) / kThreads; ++k) {
      const int e = tid + k * kThreads;
      const int tt = e >> 5;
      const int lc = e & (kCt - 1);
      const int t = t0 + tt;
      if (t < T_out && c0 + lc < C) {
        out[(static_cast<size_t>(b) * T_out + t) * C + c0 + lc] =
            narrow<T>(otile[tt][lc]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* in, long long bstride, long long cstride,
                   const void* head, void* out, int n_batch, int C, int T_out,
                   int t_in, cudaStream_t stream) {
  if (n_batch > 0 && C > 0 && T_out > 0) {
    const dim3 grid((C + kCt - 1) / kCt, n_batch);
    if (head != nullptr) {
      scan_transposed_kernel<T, true><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(in), bstride, cstride,
          static_cast<const T*>(head), static_cast<T*>(out), C, T_out, t_in);
    } else {
      scan_transposed_kernel<T, false><<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(in), bstride, cstride, nullptr,
          static_cast<T*>(out), C, T_out, t_in);
    }
  }
  return cudaGetLastError();
}

}  // namespace

// elem_bytes: 2 (int16) or 4 (int32). head: null for the inclusive scan,
// else (B, C) elements seeding the exclusive one. Strides in elements.
extern "C" int mts_scan_transposed(int device, const void* in,
                                   long long bstride, long long cstride,
                                   const void* head, void* out, int n_batch,
                                   int C, int T_out, int t_in, int elem_bytes,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    e = launch<int16_t>(in, bstride, cstride, head, out, n_batch, C, T_out,
                        t_in, st);
  } else if (elem_bytes == 4) {
    e = launch<int32_t>(in, bstride, cstride, head, out, n_batch, C, T_out,
                        t_in, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
