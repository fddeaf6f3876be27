// K1's decode tables for Hopper (sm_90a), built on the card from each
// segment row's 256-entry frequency table.
//
// Replaces no TPU kernel: the JAX package packs these tables on the host
// (mtscomp_tpu/ops/pallas_rans.py::pack_device_tables) and uploads them,
// and so did the port until the packing became the host's largest cost in
// a bulk read (about 100-170 us of small NumPy operations a table, a dozen
// tables a chunk). Here the host uploads each container's frequency
// tables once (512 B each) and one int32 index a segment row; this kernel
// writes, for each row, exactly the arrays pack_device_tables gives an
// 8-aligned table (what this codec's quantize_freqs writes):
// - dense (256 int32): value << 24 | freq << 12 | cum for the i-th present
//   symbol at entry i, then zeros;
// - octet (128 int32): the dense id of each 8-slot octet, four per int32,
//   little-endian: searchsorted(upper, 8 * o, side='right') over the
//   present symbols' upper bounds, OR-ed into the word unmasked as NumPy
//   does.
// A row whose index is -1 (no segment) is written as zeros; so is one
// whose index lies outside the stack (the word audit of K1 then fails).
//
// Layout. One block of 256 threads writes one row, thread t owning symbol
// t. Two block scans (frequency and presence, by warp shuffles and eight
// warp totals) give each symbol its cum and dense id; the dense entries
// and the present symbols' upper bounds are compacted in shared memory.
// Threads 0-127 then each write one octet word: four binary searches of
// nine steps over the upper bounds.
//
// What bounds it on the H100: bytes. A row reads 512 B of table and writes
// 1.5 KB; a bulk LFP read writes about 20,000 rows (30 MB, 9 us at 3.35
// TB/s). The work a row is a few hundred instructions a thread, the
// writes are whole coalesced rows, and the table reads hit L2 (a table
// serves every row of its plane), so the kernel is a short launch the
// host no longer waits on.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSyms = 256;
constexpr int kWarps = kSyms / 32;
constexpr int kOctetWords = 128;  // 512 octets of 4096 slots, 4 a word
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t warp_inclusive_sum(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t n = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kSyms)
    decode_tables_kernel(const uint16_t* __restrict__ freqs,
                         const int32_t* __restrict__ rows,
                         uint32_t* __restrict__ octet,
                         uint32_t* __restrict__ dense, int n_tables) {
  __shared__ uint32_t warp_f[kWarps], warp_p[kWarps];
  __shared__ uint32_t upper[kSyms];    // present symbols' upper bounds
  __shared__ uint32_t entries[kSyms];  // present symbols' dense entries
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int64_t row = blockIdx.x;
  uint32_t* d_out = dense + row * kSyms;
  uint32_t* o_out = octet + row * kOctetWords;
  const int u = rows[row];
  if (u < 0 || u >= n_tables) {  // the whole block leaves together
    d_out[t] = 0u;
    if (t < kOctetWords) o_out[t] = 0u;
    return;
  }
  const uint32_t f = freqs[static_cast<int64_t>(u) * kSyms + t];
  const uint32_t p = f != 0u;
  uint32_t inc_f = warp_inclusive_sum(f, lane);
  uint32_t inc_p = warp_inclusive_sum(p, lane);
  if (lane == 31) {
    warp_f[warp] = inc_f;
    warp_p[warp] = inc_p;
  }
  __syncthreads();
  uint32_t n_present = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      inc_f += warp_f[w];
      inc_p += warp_p[w];
    }
    n_present += warp_p[w];
  }
  if (p) {
    const uint32_t rank = inc_p - 1;
    upper[rank] = inc_f;
    entries[rank] = (static_cast<uint32_t>(t) << 24) | (f << 12) | (inc_f - f);
  }
  __syncthreads();
  d_out[t] = static_cast<uint32_t>(t) < n_present ? entries[t] : 0u;
  if (t < kOctetWords) {
    uint32_t word = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t v = 8u * static_cast<uint32_t>(4 * t + j);
      // How many upper bounds are <= v (they rise strictly): binary
      // lifting over at most 256 entries.
      uint32_t pos = 0;
#pragma unroll
      for (uint32_t step = kSyms; step > 0; step >>= 1) {
        if (pos + step <= n_present && upper[pos + step - 1] <= v) pos += step;
      }
      word |= pos << (8 * j);
    }
    o_out[t] = word;
  }
}

}  // namespace

// freqs: (n_tables, 256) uint16; rows: (n_rows,) int32 indices into freqs,
// -1 for a row without a segment; octet: (n_rows, 128) int32; dense:
// (n_rows, 256) int32.
extern "C" int mts_decode_tables(int device, const void* freqs,
                                 const void* rows, void* octet, void* dense,
                                 void* stream, int n_rows, int n_tables) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_rows > 0) {
    decode_tables_kernel<<<n_rows, kSyms, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint16_t*>(freqs),
        static_cast<const int32_t*>(rows), static_cast<uint32_t*>(octet),
        static_cast<uint32_t*>(dense), n_tables);
  }
  return static_cast<int>(cudaGetLastError());
}
