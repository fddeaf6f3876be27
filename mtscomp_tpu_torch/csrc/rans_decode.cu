// K1: grouped interleaved-rANS decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mtscomp_tpu/ops/pallas_rans.py::_kernel
// (entry decode_groups_pallas), in both of its slot-lookup forms. Normative
// semantics: mtscomp_tpu/models/rans.py::rans_decode_group -- every live
// symbol and the per-group word count must match it bit for bit.
//
// Layout. One block decodes one group: 32 segment rows x 128 lanes of
// rANS states sharing one merged 16-bit renorm word stream. 1024 threads:
// warp w owns row w, and each thread owns 4 adjacent lanes, so a warp's
// 4-lane groups cover the row's 128 lanes in order. Per step every lane
// maps its slot (x & 4095) to a dense symbol id through the row's lookup
// table, then to value<<24 | f<<12 | cum through the row's dense table
// (both staged in shared memory), and writes the symbol to the
// row-linear output (row r's symbol s*128 + j). Lanes whose state fell
// below 2^16 pull one word each from the stream in row-major (row, lane)
// order: a warp shuffle scan of the per-thread renorm counts gives in-row
// ranks, and each warp scans the 32 row totals (published in shared
// memory, double-buffered by step parity so ONE barrier per step
// suffices) to get its row offset. Each lane then reads its word directly.
//
// The lookup is a template parameter (kFixups):
// - 0, octet: 8-aligned tables (every table this codec's writer emits);
//   one byte per 8-slot octet holds the dense id (512 B per row).
// - 1 or 2, coarse/fixup: tables from other writers, whose boundaries sit
//   anywhere on the 4096-slot grid (min frequency 8). A 256-entry coarse
//   table gives each 16-slot bucket its first dense id and the two next
//   boundaries, ((up1-1) << 20) | ((up0-1) << 8) | id0; the id is then
//   fixed up by one compare-increment, or two when some bucket of the
//   batch holds three symbols (pack_device_tables' needs_second_fixup).
//   Coarse and dense tables take 64 KB of shared memory per block, above
//   the 48 KB default, hence the opt-in below.
//
// What bounds it on the H100: the rANS recurrence is sequential per lane,
// so a block runs S dependent steps, each with a block barrier and a
// dependent global word load (L1/L2 latency). Throughput comes from many
// groups in flight. The fuse8 bench geometry has only 4 groups per chunk,
// so a batch of 8 chunks launches 32 blocks on 132 SMs (two coded byte
// planes: 7 groups, 56 blocks) -- the kernel is latency bound and
// under-occupied there; this first version accepts that (simple and
// exact first).
//
// Corrupt input: reads past the group's word region return 0 and the
// word count keeps counting, so the host-side audit (used != stored
// length) raises; no read ever leaves the group's region, and a dense id
// from a malformed table is masked to the table's 256 entries.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;
constexpr int kLanesPerThread = 4;
constexpr int kThreads = kRows * 32;
constexpr unsigned kScaleBits = 12;
constexpr unsigned kFull = 0xffffffffu;

template <int kFixups>
struct Smem {
  // Octet: 512 dense-id bytes, 4 per word. Coarse: 256 bucket entries.
  uint32_t lookup[kRows][kFixups == 0 ? 128 : 256];
  uint32_t dense[kRows][256];  // value << 24 | freq << 12 | cum
  int tot[2][kRows];           // renorm words per row, by step parity
};

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

template <int kFixups>
__device__ __forceinline__ uint32_t dense_id(const uint32_t* lookup,
                                             uint32_t slot) {
  if constexpr (kFixups == 0) {
    return reinterpret_cast<const uint8_t*>(lookup)[slot >> 3];
  } else {
    const uint32_t cp = lookup[slot >> 4];
    uint32_t did = (cp & 255u) + (slot > ((cp >> 8) & 4095u) ? 1u : 0u);
    if constexpr (kFixups == 2) did += slot > (cp >> 20) ? 1u : 0u;
    return did & 255u;
  }
}

template <int kFixups>
__global__ void __launch_bounds__(kThreads, 1)
rans_decode_groups_kernel(const uint32_t* __restrict__ states,
                          const uint16_t* __restrict__ words,
                          const uint32_t* __restrict__ lookup_pk,
                          const uint32_t* __restrict__ dense_pk,
                          const int32_t* __restrict__ counts,
                          uint8_t* __restrict__ syms,
                          int32_t* __restrict__ used,
                          int n_words, int n_steps) {
  constexpr int kLookupWords = kFixups == 0 ? 128 : 256;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<kFixups>& sm = *reinterpret_cast<Smem<kFixups>*>(smem_raw);
  const int g = blockIdx.x;
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t grow = static_cast<size_t>(g) * kRows + row;

  // This warp's row tables (only this warp reads them).
  const uint4* lsrc =
      reinterpret_cast<const uint4*>(lookup_pk + grow * kLookupWords);
#pragma unroll
  for (int i = 0; i < kLookupWords / 128; ++i) {
    reinterpret_cast<uint4*>(sm.lookup[row])[lane + 32 * i] =
        lsrc[lane + 32 * i];
  }
  const uint4* dsrc = reinterpret_cast<const uint4*>(dense_pk + grow * 256);
  reinterpret_cast<uint4*>(sm.dense[row])[lane] = dsrc[lane];
  reinterpret_cast<uint4*>(sm.dense[row])[lane + 32] = dsrc[lane + 32];
  __syncwarp();

  const int my_count = counts[grow];
  // Per-group step count: the longest row's, never past the output width.
  const int max_count =
      __reduce_max_sync(kFull, counts[static_cast<size_t>(g) * kRows + lane]);
  const int steps = min((max(max_count, 0) + kLanes - 1) / kLanes, n_steps);

  uint32_t x[kLanesPerThread];
  {
    const uint4 s4 =
        reinterpret_cast<const uint4*>(states + grow * kLanes)[lane];
    x[0] = s4.x; x[1] = s4.y; x[2] = s4.z; x[3] = s4.w;
  }
  const uint16_t* gw = words + static_cast<size_t>(g) * n_words;
  uint8_t* out_row = syms + grow * static_cast<size_t>(n_steps) * kLanes;
  const int lane0 = lane * kLanesPerThread;
  int pos = 0;

  for (int s = 0; s < steps; ++s) {
    const int col0 = s * kLanes + lane0;
    uint32_t vals = 0;
    int need = 0, cnt = 0;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const uint32_t slot = x[j] & 4095u;
      const uint32_t pk =
          sm.dense[row][dense_id<kFixups>(sm.lookup[row], slot)];
      vals |= (pk >> 24) << (8 * j);
      if (col0 + j < my_count) {
        x[j] = ((pk >> 12) & 4095u) * (x[j] >> kScaleBits) + slot
               - (pk & 4095u);
        if (x[j] < (1u << 16)) {
          need |= 1 << j;
          ++cnt;
        }
      }
    }
    *reinterpret_cast<uint32_t*>(out_row + col0) = vals;

    const int incl = warp_inclusive_scan(cnt, lane);
    int* tot = sm.tot[s & 1];
    if (lane == 31) tot[row] = incl;
    __syncthreads();
    const int t = tot[lane];
    const int tincl = warp_inclusive_scan(t, lane);
    const int row_off = __shfl_sync(kFull, tincl - t, row);
    const int step_total = __shfl_sync(kFull, tincl, 31);

    int idx = pos + row_off + (incl - cnt);
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      if (need & (1 << j)) {
        const uint32_t w = idx < n_words ? gw[idx] : 0u;
        x[j] = (x[j] << 16) | w;
        ++idx;
      }
    }
    pos += step_total;
  }
  if (threadIdx.x == 0) used[g] = pos;
}

template <int kFixups>
cudaError_t launch(const void* states, const void* words, const void* lookup,
                   const void* dense, const void* counts, void* syms,
                   void* used, cudaStream_t stream, int n_groups, int n_words,
                   int n_steps) {
  const int smem = static_cast<int>(sizeof(Smem<kFixups>));
  cudaError_t e = cudaFuncSetAttribute(
      rans_decode_groups_kernel<kFixups>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (n_groups > 0) {
    rans_decode_groups_kernel<kFixups><<<n_groups, kThreads, smem, stream>>>(
        static_cast<const uint32_t*>(states),
        static_cast<const uint16_t*>(words),
        static_cast<const uint32_t*>(lookup),
        static_cast<const uint32_t*>(dense),
        static_cast<const int32_t*>(counts), static_cast<uint8_t*>(syms),
        static_cast<int32_t*>(used), n_words, n_steps);
  }
  return cudaGetLastError();
}

}  // namespace

// fixups: 0 = octet lookup tables (N, 32, 128) int32; 1 or 2 = coarse
// tables (N, 32, 256) int32 with that many compare-increments.
extern "C" int mts_rans_decode_groups(int device, const void* states,
                                      const void* words, const void* lookup,
                                      const void* dense_pk, const void* counts,
                                      void* syms, void* used, void* stream,
                                      int n_groups, int n_words, int n_steps,
                                      int fixups) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fixups) {
    case 0:
      e = launch<0>(states, words, lookup, dense_pk, counts, syms, used, st,
                    n_groups, n_words, n_steps);
      break;
    case 1:
      e = launch<1>(states, words, lookup, dense_pk, counts, syms, used, st,
                    n_groups, n_words, n_steps);
      break;
    case 2:
      e = launch<2>(states, words, lookup, dense_pk, counts, syms, used, st,
                    n_groups, n_words, n_steps);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

extern "C" const char* mts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
