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
// matmuls and carried the sums across a sequential grid axis. Here blocks
// run in no order and integer adds wrap natively, so time is split across
// blocks instead of carried (scan_common.cuh):
//   pass A  each (chunk, segment of n_steps time steps) block sums its
//           segment per channel into the scratch totals;
//   pass B  seg_prefix_kernel: exclusive prefixes over the segments;
//   pass C  each block scans its segment seeded with its prefix.
// A segment of one chunk, all channels, is ONE contiguous span of
// n_steps * C elements. A block copies it into shared memory with 16-byte
// loads (the span's ragged ends, off the 16-byte grid, by element loads;
// the span sits in shared memory at the same offset from a 16-byte
// boundary as in device memory), threads take channels and walk the
// steps in shared memory, and pass C copies the scanned span out with
// 16-byte stores. A chunk with one segment runs pass C alone.
//
// Where one time step's row exceeds the tile (tens of thousands of
// channels), the caller tiles the channels: the block's rows are then
// copied one by one with element loads. The same element copies serve an
// input whose base is at another 16-byte offset than the output's.
//
// What bounds it on the H100: bytes. The three passes read the tensor
// twice and write it once (pass C's read may hit L2 for small batches)
// against the bound's one read and one write; every (chunk, segment) is a
// block, so B = 2 chunks of 30,000 steps already give ~900 blocks.

#include <algorithm>

#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 512;

// Block (b, seg, ct) of the grid: channels [c0, c0 + cw) and time steps
// [t0, t0 + rows) of chunk b.
struct Tile {
  size_t base;    // element offset of (b, t0, c0) in the (B, T, C) tensor
  int b, seg, c0, cw, rows;
};

__device__ __forceinline__ Tile block_tile(int T_len, int C, int n_steps,
                                           int c_tile, int n_seg, int n_ct) {
  Tile t;
  const int ct = blockIdx.x % n_ct;
  const int bs = blockIdx.x / n_ct;
  t.seg = bs % n_seg;
  t.b = bs / n_seg;
  t.c0 = ct * c_tile;
  t.cw = min(c_tile, C - t.c0);
  const int t0 = t.seg * n_steps;
  t.rows = min(n_steps, T_len - t0);
  t.base = (static_cast<size_t>(t.b) * T_len + t0) * C + t.c0;
  return t;
}

// Elements between p and the next 16-byte boundary.
template <typename T>
__device__ __forceinline__ int to_boundary(const T* p) {
  return static_cast<int>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) /
         static_cast<int>(sizeof(T));
}

// Copy of the block's tile between device memory (g[r * C + c]) and
// shared memory (s[r * cw + c]), into shared memory or back out. wide: the
// tile is one contiguous run (cw == C) and s, g share their offset from a
// 16-byte boundary: 16-byte copies between the run's ragged ends.
template <bool kToShared, typename T>
__device__ __forceinline__ void copy_tile(T* s, T* g, const Tile& t, int C,
                                          bool wide) {
  const int n = t.rows * t.cw;
  if (wide) {
    constexpr int kPer = 16 / sizeof(T);
    const int head = min(to_boundary(g), n);
    const int body = (n - head) / kPer;
    uint4* g4 = reinterpret_cast<uint4*>(g + head);
    uint4* s4 = reinterpret_cast<uint4*>(s + head);
    for (int i = threadIdx.x; i < body; i += blockDim.x) {
      if (kToShared) s4[i] = g4[i]; else g4[i] = s4[i];
    }
    const int done = head + body * kPer;
    for (int i = threadIdx.x; i < head + n - done; i += blockDim.x) {
      const int e = i < head ? i : done + i - head;
      if (kToShared) s[e] = g[e]; else g[e] = s[e];
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / t.cw;
      T* ge = g + static_cast<size_t>(r) * C + (i - r * t.cw);
      if (kToShared) s[i] = *ge; else *ge = s[i];
    }
  }
}

// The tile's place in shared memory: at the global span's own offset from
// a 16-byte boundary when wide, so that both sides of a 16-byte copy are
// aligned.
template <typename T>
__device__ __forceinline__ T* tile_in_smem(uint4* smem, const T* g,
                                           bool wide) {
  T* s = reinterpret_cast<T*>(smem);
  if (wide) {
    s += (reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T);
  }
  return s;
}

// Pass A: totals[b, seg, c] = sum over the segment's steps of in[b, t, c].
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cumsum_time_totals_kernel(const T* __restrict__ in,
                          uint32_t* __restrict__ totals, int T_len, int C,
                          int n_steps, int c_tile, int n_seg, int n_ct,
                          int wide) {
  extern __shared__ uint4 smem[];
  const Tile t = block_tile(T_len, C, n_steps, c_tile, n_seg, n_ct);
  T* g = const_cast<T*>(in) + t.base;     // read only
  T* s = tile_in_smem(smem, g, wide);
  copy_tile<true>(s, g, t, C, wide);
  __syncthreads();
  for (int c = threadIdx.x; c < t.cw; c += blockDim.x) {
    uint32_t sum = 0;
#pragma unroll 8
    for (int r = 0; r < t.rows; ++r) sum += widen(s[r * t.cw + c]);
    totals[(static_cast<size_t>(t.b) * n_seg + t.seg) * C + t.c0 + c] = sum;
  }
}

// Pass C: the segment's inclusive scan, seeded with its prefix (null for a
// chunk of one segment).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
cumsum_time_scan_kernel(const T* __restrict__ in, T* __restrict__ out,
                        const uint32_t* __restrict__ prefix, int T_len, int C,
                        int n_steps, int c_tile, int n_seg, int n_ct,
                        int wide) {
  extern __shared__ uint4 smem[];
  const Tile t = block_tile(T_len, C, n_steps, c_tile, n_seg, n_ct);
  T* g = const_cast<T*>(in) + t.base;     // read only
  T* s = tile_in_smem(smem, g, wide);
  copy_tile<true>(s, g, t, C, wide);
  __syncthreads();
  for (int c = threadIdx.x; c < t.cw; c += blockDim.x) {
    uint32_t run = 0;
    if (prefix != nullptr) {
      run = prefix[(static_cast<size_t>(t.b) * n_seg + t.seg) * C + t.c0 + c];
    }
    T* col = s + c;
    int r = 0;
    for (; r + 8 <= t.rows; r += 8) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = widen(col[(r + j) * t.cw]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        run += v[j];
        col[(r + j) * t.cw] = narrow<T>(run);
      }
    }
    for (; r < t.rows; ++r) {
      run += widen(col[r * t.cw]);
      col[r * t.cw] = narrow<T>(run);
    }
  }
  __syncthreads();
  copy_tile<false>(s, out + t.base, t, C, wide);
}

// Dynamic shared memory of a block: its tile, and the slack that lets
// the tile sit at the global span's offset from a 16-byte boundary.
int smem_bytes(int n_steps, int c_tile, int C, int elem_bytes) {
  return n_steps * std::min(c_tile, C) * elem_bytes + 16;
}

template <typename T>
cudaError_t launch(const void* in_v, void* out_v, void* scratch, int n_batch,
                   int T_len, int C, int n_steps, int c_tile,
                   cudaStream_t stream) {
  if (n_batch <= 0 || T_len <= 0 || C <= 0) return cudaSuccess;
  if (n_steps <= 0 || c_tile <= 0) return cudaErrorInvalidValue;
  const T* in = static_cast<const T*>(in_v);
  T* out = static_cast<T*>(out_v);
  const int n_seg = (T_len + n_steps - 1) / n_steps;
  const int n_ct = (C + c_tile - 1) / c_tile;
  if (n_seg > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(n_batch) * n_seg * n_ct;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int wide =
      n_ct == 1 && ((reinterpret_cast<uintptr_t>(in) & 15) ==
                    (reinterpret_cast<uintptr_t>(out) & 15));
  const int cw = std::min(c_tile, C);
  const int threads =
      std::min(kMaxThreads, std::max(128, (cw + 31) / 32 * 32));
  const int smem = smem_bytes(n_steps, c_tile, C, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      cumsum_time_totals_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(cumsum_time_scan_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  uint32_t* totals = static_cast<uint32_t*>(scratch);
  if (n_seg > 1) {
    cumsum_time_totals_kernel<T><<<static_cast<unsigned>(blocks), threads,
                                   smem, stream>>>(
        in, totals, T_len, C, n_steps, c_tile, n_seg, n_ct, wide);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_seg_prefix(totals, n_batch, n_seg, C, stream);
    if (e != cudaSuccess) return e;
  }
  cumsum_time_scan_kernel<T><<<static_cast<unsigned>(blocks), threads, smem,
                               stream>>>(
      in, out, n_seg > 1 ? totals : nullptr, T_len, C, n_steps, c_tile, n_seg,
      n_ct, wide);
  return cudaGetLastError();
}

}  // namespace

// Contiguous (B, T, C) in and out (no overlap); elem_bytes 2 (int16) or 4
// (int32). Time is cut into segments of n_steps and channels into tiles of
// c_tile (>= C: no tiling); n_steps * min(c_tile, C) elements + 16 bytes
// must fit a block's shared memory. scratch: (B, ceil(T / n_steps), C)
// uint32, needed when T > n_steps.
extern "C" int mts_cumsum_time(int device, const void* in, void* out,
                               void* scratch, int n_batch, int T_len, int C,
                               int n_steps, int c_tile, int elem_bytes,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    e = launch<int16_t>(in, out, scratch, n_batch, T_len, C, n_steps, c_tile,
                        st);
  } else if (elem_bytes == 4) {
    e = launch<int32_t>(in, out, scratch, n_batch, T_len, C, n_steps, c_tile,
                        st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Dynamic shared memory of a block, in bytes (for reports).
extern "C" int mts_cumsum_time_smem_bytes(int C, int n_steps, int c_tile,
                                          int elem_bytes) {
  return smem_bytes(n_steps, c_tile, C, elem_bytes);
}
