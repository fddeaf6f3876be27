// K6: grouped interleaved-rANS encode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// mtscomp_tpu/ops/pallas_rans_enc.py::_enc_kernel (entry
// encode_groups_pallas). Normative semantics:
// mtscomp_tpu_torch/models/rans.py::rans_encode_group -- the final states,
// the merged word stream and its word count must match it bit for bit.
//
// Layout. One block encodes one group: 32 segment rows x 128 lanes of rANS
// states that share one merged 16-bit renorm word stream. 1024 threads:
// warp w owns row w, and each thread owns 4 adjacent lanes, whose symbols
// it reads with one 32-bit load per step. The row's encoder tables (per
// symbol the packed rcp_shift << 25 | cmpl << 12 | cum word and the
// round-up reciprocal, models/rans.py encoder_tables) sit in shared
// memory: 2 x 32 x 256 words, 64 KB, above the 48 KB default, hence the
// opt-in below (K1's coarse form does the same).
//
// The walk. Steps run backward, from ceil(max(counts) / 128) - 1 down to
// 0; a lane is live while s * 128 + lane < counts[row]. A live lane first
// renormalizes (emits x & 0xFFFF and shifts x by 16 when (x >> 20) >= f,
// i.e. when the update would overflow 32 bits), then divides with the
// round-up reciprocal, q = x / f exactly:
//   t = umulhi(x, rcp); q = (((x - t) >> 1) + t) >> rcp_shift,
// and updates x += cum + q * (4096 - f).
//
// The stream. The decoder reads step 0's words first, each step's in
// row-major (row, lane) order, so a word's place is only known from the
// stream's END: the kernel writes the stream right-anchored in the
// group's region of `cap` words. A warp shuffle scan of the per-thread
// emit counts gives ranks within a row; each warp scans the 32 row
// totals (published in shared memory, double-buffered by step parity so
// ONE barrier per step suffices, as in K1) for its row offset and the
// step's total ks. Word k of the step goes to cap - epos - ks + k, where
// epos counts the words of the steps already encoded. The TPU kernel's
// MXU prefix matmuls, butterfly lane compaction, one-hot scatter matmuls
// and float divide with its fixup have no counterpart here: a scalar
// store per word and one multiply-high per symbol do their work.
//
// Capacity. At most one word per live symbol, so a region of the group's
// symbol count always holds its stream (the caller provisions that); a
// word that would land left of the region is dropped while the count goes
// on, so a wrong caller cannot write out of bounds and the wrapper's
// count check raises.
//
// What bounds it on the H100: like K1, the recurrence is sequential per
// lane, so a block runs S dependent steps, each with a block barrier and
// the shared-table lookups; throughput comes from many groups in flight.
// The bench geometry has 4 groups per chunk (7 with two coded planes), so
// a batch of 8 chunks launches 32 (56) blocks on 132 SMs: latency bound
// and under-occupied, accepted in this first version (simple and exact
// first).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;
constexpr int kLanesPerThread = 4;
constexpr int kThreads = kRows * 32;
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  uint32_t pk[kRows][256];   // rcp_shift << 25 | cmpl << 12 | cum
  uint32_t rcp[kRows][256];  // low 32 bits of ceil(2^(32+shift) / f)
  int tot[2][kRows];         // emitted words per row, by step parity
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
rans_encode_groups_kernel(const uint8_t* __restrict__ syms,
                          const uint32_t* __restrict__ pk,
                          const uint32_t* __restrict__ rcp,
                          const int32_t* __restrict__ counts,
                          uint32_t* __restrict__ states,
                          uint16_t* __restrict__ words,
                          int32_t* __restrict__ n_words, int n_steps,
                          long long cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int g = blockIdx.x;
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t grow = static_cast<size_t>(g) * kRows + row;

  // This warp's row tables (only this warp reads them).
  const uint4* psrc = reinterpret_cast<const uint4*>(pk + grow * 256);
  const uint4* rsrc = reinterpret_cast<const uint4*>(rcp + grow * 256);
  reinterpret_cast<uint4*>(sm.pk[row])[lane] = psrc[lane];
  reinterpret_cast<uint4*>(sm.pk[row])[lane + 32] = psrc[lane + 32];
  reinterpret_cast<uint4*>(sm.rcp[row])[lane] = rsrc[lane];
  reinterpret_cast<uint4*>(sm.rcp[row])[lane + 32] = rsrc[lane + 32];
  __syncwarp();

  const int my_count = counts[grow];
  // Per-group step count: the longest row's, never past the input width.
  const int max_count =
      __reduce_max_sync(kFull, counts[static_cast<size_t>(g) * kRows + lane]);
  const int steps = min((max(max_count, 0) + kLanes - 1) / kLanes, n_steps);

  uint32_t x[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) x[j] = kRansL;
  const uint8_t* in_row = syms + grow * static_cast<size_t>(n_steps) * kLanes;
  uint16_t* gw = words + static_cast<size_t>(g) * static_cast<size_t>(cap);
  const int lane0 = lane * kLanesPerThread;
  long long epos = 0;  // words emitted by the steps above s

  for (int s = steps - 1; s >= 0; --s) {
    const int col0 = s * kLanes + lane0;
    const uint32_t sy4 = *reinterpret_cast<const uint32_t*>(in_row + col0);
    uint32_t w[kLanesPerThread];
    int emit = 0, cnt = 0;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      w[j] = 0;
      if (col0 + j < my_count) {
        const uint32_t sym = (sy4 >> (8 * j)) & 255u;
        const uint32_t p = sm.pk[row][sym];
        const uint32_t cmpl = (p >> 12) & 8191u;
        if ((x[j] >> 20) >= 4096u - cmpl) {
          w[j] = x[j] & 0xFFFFu;
          x[j] >>= 16;
          emit |= 1 << j;
          ++cnt;
        }
        const uint32_t t = __umulhi(x[j], sm.rcp[row][sym]);
        const uint32_t q = (((x[j] - t) >> 1) + t) >> (p >> 25);
        x[j] += (p & 4095u) + q * cmpl;
      }
    }

    const int incl = warp_inclusive_scan(cnt, lane);
    int* tot = sm.tot[s & 1];
    if (lane == 31) tot[row] = incl;
    __syncthreads();
    const int t = tot[lane];
    const int tincl = warp_inclusive_scan(t, lane);
    const int row_off = __shfl_sync(kFull, tincl - t, row);
    const int ks = __shfl_sync(kFull, tincl, 31);

    long long idx = cap - epos - ks + row_off + (incl - cnt);
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      if (emit & (1 << j)) {
        if (idx >= 0) gw[idx] = static_cast<uint16_t>(w[j]);
        ++idx;
      }
    }
    epos += ks;
  }
  reinterpret_cast<uint4*>(states + grow * kLanes)[lane] =
      make_uint4(x[0], x[1], x[2], x[3]);
  if (threadIdx.x == 0) n_words[g] = static_cast<int32_t>(epos);
}

}  // namespace

// syms (N, 32, n_steps * 128) u8; pk, rcp (N, 32, 256) u32; counts (N, 32)
// i32 -> states (N, 32, 128) u32, words (N, cap) u16 (group n's stream is
// words[n, cap - n_words[n]:]), n_words (N,) i32.
extern "C" int mts_rans_encode_groups(int device, const void* syms,
                                      const void* pk, const void* rcp,
                                      const void* counts, void* states,
                                      void* words, void* n_words,
                                      void* stream, int n_groups, int n_steps,
                                      long long cap) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = static_cast<int>(sizeof(Smem));
  e = cudaFuncSetAttribute(rans_encode_groups_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n_groups > 0) {
    rans_encode_groups_kernel<<<n_groups, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(syms), static_cast<const uint32_t*>(pk),
        static_cast<const uint32_t*>(rcp), static_cast<const int32_t*>(counts),
        static_cast<uint32_t*>(states), static_cast<uint16_t*>(words),
        static_cast<int32_t*>(n_words), n_steps, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
