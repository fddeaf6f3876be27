// K5: carried time cumsum of (B, T, C) integers for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mtscomp_tpu/ops/device_delta.py::
// _cumsum_kernel (entry cumsum_time_pallas, dispatched by cumsum_time):
//   out[b, t, c] = sum_{i <= t} in[b, i, c]   modulo 2^16 or 2^32,
// for int16 and int32 elements. The decode runs it after the samples
// are laid out time-major: the second pass of a second-order time diff,
// C-order chunks, spatially differenced chunks and 1-byte dtypes (widened
// to int16 by the caller).
//
// The TPU computed each (256 t, 128 c) tile's prefix with byte-split
// matmuls and carried the sums across a sequential grid axis. Here one
// thread owns one (b, c) column and walks time, so a warp's loads and
// stores cover 32 neighbouring channels of one time step (coalesced), and
// integer adds wrap natively. Loads are issued kUnroll steps ahead of the
// adds so that each thread keeps several reads in flight.
//
// What bounds it on the H100: bytes (one element read and one written),
// but the serial walk gives only B x C threads (3,080 at B = 8, 385
// channels), too few to keep HBM busy; a later version can split time
// across threads with a second pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cumsum_time_kernel(const T* __restrict__ in, T* __restrict__ out,
                   int n_batch, int T_len, int C) {
  const long long col =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= static_cast<long long>(n_batch) * C) return;
  const long long b = col / C;
  const long long c = col % C;
  const size_t base = static_cast<size_t>(b) * T_len * C + c;
  const T* src = in + base;
  T* dst = out + base;
  uint32_t run = 0;
  int t = 0;
  for (; t + kUnroll <= T_len; t += kUnroll) {
    T v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      v[j] = src[static_cast<size_t>(t + j) * C];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      run += static_cast<uint32_t>(static_cast<int32_t>(v[j]));
      dst[static_cast<size_t>(t + j) * C] = narrow<T>(run);
    }
  }
  for (; t < T_len; ++t) {
    run += static_cast<uint32_t>(
        static_cast<int32_t>(src[static_cast<size_t>(t) * C]));
    dst[static_cast<size_t>(t) * C] = narrow<T>(run);
  }
}

template <typename T>
cudaError_t launch(const void* in, void* out, int n_batch, int T_len, int C,
                   cudaStream_t stream) {
  const long long cols = static_cast<long long>(n_batch) * C;
  if (cols > 0 && T_len > 0) {
    const unsigned blocks =
        static_cast<unsigned>((cols + kThreads - 1) / kThreads);
    cumsum_time_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(in), static_cast<T*>(out), n_batch, T_len, C);
  }
  return cudaGetLastError();
}

}  // namespace

// Contiguous (B, T, C) in and out; elem_bytes 2 (int16) or 4 (int32).
extern "C" int mts_cumsum_time(int device, const void* in, void* out,
                               int n_batch, int T_len, int C, int elem_bytes,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    e = launch<int16_t>(in, out, n_batch, T_len, C, st);
  } else if (elem_bytes == 4) {
    e = launch<int32_t>(in, out, n_batch, T_len, C, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
