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
// memory side by side, one 64-bit read a lane and step.
//
// The recurrence. Steps run backward, from ceil(max(counts) / 128) - 1
// down to 0; a lane is live while s * 128 + lane < counts[row]. A live
// lane first renormalizes (emits x & 0xFFFF and shifts x by 16 when
// (x >> 20) >= f, i.e. when the update would overflow 32 bits), then
// divides with the round-up reciprocal, q = x / f exactly:
//   t = umulhi(x, rcp); q = (((x - t) >> 1) + t) >> rcp_shift,
// and updates x += cum + q * (4096 - f).
//
// The stream. The decoder reads step 0's words first, each step's in
// row-major (row, lane) order, so a word's place is known only from the
// stream's END: the kernel writes the stream right-anchored in the
// group's region of `cap` words. The recurrence itself never needs a
// word's place, only the placement does; so the kernel walks the steps
// in windows of kWindow, top window first, with two block barriers a
// window and none a step:
// 1. each warp runs its row's recurrence over the window, ranks the
//    row's words of a step by ballots and stages them in shared memory
//    at stage[step][row][rank] (at most 128 a row and step), and the
//    row's count at cnt[step][row];
// 2. barrier; one warp scans the window's counts in decoder order
//    (steps ascending, rows ascending) into off[step][row] and the
//    window's total K; barrier;
// 3. each warp copies its row's staged words, word k of (step, row) to
//    cap - epos - K + off[step][row] + k, where epos counts the words of
//    the windows above; the copy is coalesced, 32 words a warp store.
// A warp reads and writes only its own row's staging, so the next
// window's recurrence needs no barrier after the copy. With no barrier
// in the step loop, each thread loads the symbols of kPrefetch steps at
// once, ahead of their use; the step itself is branch free (every lane
// computes, selects keep or drop). The TPU kernel's MXU prefix matmuls,
// butterfly lane compaction, one-hot scatter matmuls and float divide
// with its fixup have no counterpart here.
//
// Capacity. At most one word per live symbol, so a region of the group's
// symbol count always holds its stream (the caller provisions that); a
// word that would land left of the region is dropped while the count goes
// on, so a wrong caller cannot write out of bounds and the wrapper's
// count check raises.
//
// What bounds it on the H100: the recurrence is sequential per lane, so
// a block walks S dependent steps; the batches of the main path have
// 32-56 groups on 132 SMs. Without the per-step barrier the 32 warps of
// a block run their rows' chains independently, and the limit is the
// SM's instruction issue and shared-memory traffic over those chains:
// ~2,000 cycles a step, 75 % of it the recurrence and staging, the copy
// ~18 %, the scan and barriers ~5 % (1.08-1.15 ms at B=8 on an H100 at
// 700 W, against 1.73-1.87 with one barrier a step; cycles from clock64()
// stamps of the step). A variant that ran the recurrence twice a window
// (count, then place) instead of staging took 1.56-1.65 ms. More SMs per
// group (a cluster of blocks splitting the rows, the window counts
// shared through distributed shared memory) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 32;
constexpr int kLanesPerThread = 4;
constexpr int kThreads = kRows * 32;
constexpr int kWindow = 16;    // steps a window
constexpr int kPrefetch = 8;   // steps whose symbols load at once
constexpr uint32_t kRansL = 1u << 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanPerLane = kWindow * kRows / 32;  // counts a lane scans
static_assert(kScanPerLane % 4 == 0, "the scan reads 4 counts a word");

struct Smem {
  uint2 tab[kRows][256];                   // {pk, rcp} of each symbol
  uint16_t stage[kWindow][kRows][kLanes];  // the window's words
  int off[kWindow][kRows];                 // window-relative place
  uint8_t cnt[kWindow][kRows];             // words of (step, row)
  int total;                               // the window's words
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
  for (int i = lane; i < 256; i += 32)
    sm.tab[row][i] = make_uint2(pk[grow * 256 + i], rcp[grow * 256 + i]);
  __syncwarp();

  const int my_count = counts[grow];
  // Per-group step count: the longest row's, never past the input width.
  const int max_count =
      __reduce_max_sync(kFull, counts[static_cast<size_t>(g) * kRows + lane]);
  const int steps = min((max(max_count, 0) + kLanes - 1) / kLanes, n_steps);

  uint32_t x[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) x[j] = kRansL;
  const int lane0 = lane * kLanesPerThread;
  const uint32_t lanes_before = (1u << lane) - 1u;
  const uint8_t* in_row =
      syms + grow * static_cast<size_t>(n_steps) * kLanes + lane0;
  uint16_t* gw = words + static_cast<size_t>(g) * static_cast<size_t>(cap);
  long long epos = 0;  // words of the windows above this one

  for (int hi = steps - 1; hi >= 0; hi -= kWindow) {
    const int lo = max(hi - kWindow + 1, 0);
    if (lane == 0) {
      for (int ls = hi - lo + 1; ls < kWindow; ++ls) sm.cnt[ls][row] = 0;
    }
    // 1. The recurrence over the window, words staged.
    for (int s0 = hi; s0 >= lo; s0 -= kPrefetch) {
      uint32_t sy[kPrefetch];
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int s = s0 - k;
        sy[k] = s >= lo ? __ldg(reinterpret_cast<const unsigned int*>(
                              in_row + s * kLanes))
                        : 0u;
      }
#pragma unroll
      for (int k = 0; k < kPrefetch; ++k) {
        const int s = s0 - k;
        if (s < lo) break;
        const int live = min(max(my_count - (s * kLanes + lane0), 0),
                             kLanesPerThread);
        uint32_t w[kLanesPerThread];
        uint32_t emit = 0;
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j) {
          const uint2 t2 = sm.tab[row][__byte_perm(sy[k], 0u, 0x4440u | j)];
          const uint32_t p = t2.x;
          const uint32_t cmpl = (p >> 12) & 8191u;
          const bool on = j < live;
          const bool e = on && (x[j] >> 20) >= 4096u - cmpl;
          w[j] = x[j];
          const uint32_t xs = e ? x[j] >> 16 : x[j];
          const uint32_t t = __umulhi(xs, t2.y);
          const uint32_t q = (((xs - t) >> 1) + t) >> (p >> 25);
          const uint32_t xn = xs + (p & 4095u) + q * cmpl;
          x[j] = on ? xn : x[j];
          emit |= e ? 1u << j : 0u;
        }
        int at = 0;
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j)
          at += __popc(__ballot_sync(kFull, (emit >> j) & 1u)
                       & lanes_before);
        uint16_t* st = sm.stage[s - lo][row];
#pragma unroll
        for (int j = 0; j < kLanesPerThread; ++j) {
          const bool e = (emit >> j) & 1u;
          if (e) st[at] = static_cast<uint16_t>(w[j]);
          at += e;
        }
        if (lane == 31) sm.cnt[s - lo][row] = static_cast<uint8_t>(at);
      }
    }
    __syncthreads();

    // 2. Warp 0 scans the window's counts in decoder order (index
    // step * 32 + row), kScanPerLane a lane.
    if (row == 0) {
      const uint32_t* cw = reinterpret_cast<const uint32_t*>(&sm.cnt[0][0])
                           + lane * (kScanPerLane / 4);
      uint32_t packed[kScanPerLane / 4];
      unsigned mine = 0;
#pragma unroll
      for (int i = 0; i < kScanPerLane / 4; ++i) {
        packed[i] = cw[i];
        mine = __dp4a(packed[i], 0x01010101u, mine);
      }
      const int incl = warp_inclusive_scan(static_cast<int>(mine), lane);
      int o = incl - static_cast<int>(mine);
      int* ob = &sm.off[0][0] + lane * kScanPerLane;
#pragma unroll
      for (int i = 0; i < kScanPerLane; ++i) {
        ob[i] = o;
        o += (packed[i / 4] >> (8 * (i % 4))) & 255u;
      }
      if (lane == 31) sm.total = o;
    }
    __syncthreads();

    // 3. The window's words go to [cap - epos - total, cap - epos); those
    // left of the region (a region too small: a caller's fault) drop.
    const int total = sm.total;
    const long long first = cap - epos - total;
    for (int ls = 0; ls <= hi - lo; ++ls) {
      const int c = sm.cnt[ls][row];
      const long long base = first + sm.off[ls][row];
      for (int k = lane; k < c; k += 32) {
        if (base + k >= 0) gw[base + k] = sm.stage[ls][row][k];
      }
    }
    __syncwarp();
    epos += total;
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

// Dynamic shared memory of a block, in bytes (for reports).
extern "C" int mts_rans_encode_smem_bytes() {
  return static_cast<int>(sizeof(Smem));
}
