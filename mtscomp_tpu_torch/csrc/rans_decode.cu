// K1: grouped interleaved-rANS decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel mtscomp_tpu/ops/pallas_rans.py::_kernel
// (entry decode_groups_pallas), in both of its slot-lookup forms. Normative
// semantics: mtscomp_tpu/models/rans.py::rans_decode_group -- every live
// symbol and the per-group word count must match it bit for bit.
//
// Layout. One block decodes one group: 32 segment rows x 128 lanes of
// rANS states sharing one merged 16-bit renorm word stream. One warp
// decodes one row, each thread 4 adjacent lanes of it, in order.
// Per step every lane maps its slot (x & 4095) to a dense symbol id
// through the row's lookup table, then to value<<24 | f<<12 | cum through
// the row's dense table (both staged in shared memory), and writes the
// symbol to the row-linear output (row r's symbol s*128 + j). Lanes whose
// state fell below 2^16 pull one word each from the stream in row-major
// (row, lane) order.
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
//
// What bounds it on the H100. The recurrence is sequential per lane, so
// a block walks S dependent steps (940 for a 1-s chunk), and the row
// offsets of a step depend on every row's renorm count at that step: one
// block barrier a step is inherent. The batches of the main path have
// 32-56 groups on 132 SMs, so the time is S times the cost of one step,
// and the step must stay short: a renorm word read from global memory
// would be a dependent L2 or HBM round trip every step (its address is
// known only after the barrier), and shuffle scans around the barrier
// add two more dependent chains. So:
// - The word stream sits in shared memory. A group reads its words in
//   order, at most 4096 a step (one a lane), so a ring of kSlots slots of
//   4096 words (32 KB) holds every word a step can need. One thread
//   refills the slots ahead of the read position with 1-D bulk copies
//   (cp.async.bulk, the TMA) that complete on one mbarrier per slot; a
//   step's word read is then a shared-memory read. A region start or end
//   off the 16-byte grid (a W not a multiple of 8) is loaded with plain
//   loads; a read past the region still returns 0.
// - In-row ranks come from one __ballot_sync per lane slot of a thread
//   and __popc, and after the barrier the row offset and the step total
//   are two independent __reduce_add_sync over the 32 published row
//   totals (double-buffered by step parity, so ONE barrier a step
//   suffices).
// - The step is branch free: every lane computes, selects keep or drop,
//   and (x << 16) | word is one byte permute.
// What bounds it now: the 32 warps of one group share one SM, and a step
// costs ~2,000 cycles (0.93-0.95 ms for 940 steps on an H100 at 700 W,
// against 1.47-1.51 before): ~180 instructions a warp and step issued by
// 32 warps, the bank-conflicted table reads (8,192 random shared-memory
// reads a step), and the barrier. clock64() stamps of the step put ~35 %
// in the table reads and update, ~25 % in the barrier and the reductions
// after it, ~15 % in the ranks and ~15 % in the ring reads. 512 threads
// x 8 lanes (a cheaper barrier, more work a thread) ran ~10 % slower. The
// next step is more SMs per group: the rows split over a cluster of
// blocks, the row totals exchanged through distributed shared memory.
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
constexpr int kThreads = kRows * 32;  // one warp a row
constexpr unsigned kScaleBits = 12;
constexpr unsigned kFull = 0xffffffffu;
// The word ring: slot k holds the words [k * 4096, (k + 1) * 4096) of the
// group's region (counted from the 16-byte boundary at or before its
// start), at ring slot k % kSlots.
constexpr int kSlotLog2 = 12;
constexpr int kSlotWords = 1 << kSlotLog2;
constexpr int kSlots = 4;
constexpr int kRingWords = kSlots * kSlotWords;
static_assert(kSlotWords >= kRows * kLanes, "a step reads at most one slot");
static_assert(kSlots >= 3, "a refill must not touch the two slots in use");
static_assert(kLanesPerThread * 32 == kLanes, "one warp a row");

template <int kFixups>
struct Smem {
  uint16_t ring[kRingWords];  // first: the bulk copies need 16-byte alignment
  // Octet: 512 dense-id bytes, 4 per word. Coarse: 256 bucket entries.
  uint32_t lookup[kRows][kFixups == 0 ? 128 : 256];
  uint32_t dense[kRows][256];  // value << 24 | freq << 12 | cum
  uint64_t full[kSlots];       // one mbarrier per ring slot
  int tot[2][kRows];           // renorm words per row, by step parity
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Waits for the phase `parity` of a slot's mbarrier to complete. A fill
// that never lands (a fault) traps after 2^26 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 26)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Starts the fill of stream slot k (one thread): the words of the slot
// that lie in the region, [shift, shift + n_words) counted from the
// 16-byte aligned `abase`. The 16-byte aligned middle goes by one bulk
// copy that completes on the slot's mbarrier (expecting 0 bytes when
// there is none, so every fill completes one phase); the few words
// before and after it by plain loads, which the readers see after the
// block barriers that separate a fill from the first read of its slot.
template <int kFixups>
__device__ void fill_slot(Smem<kFixups>& sm, const uint16_t* abase,
                          int shift, int n_words, int k) {
  const int lo = max(k * kSlotWords, shift);
  const int hi = min((k + 1) * kSlotWords, shift + n_words);
  uint64_t* bar = &sm.full[k & (kSlots - 1)];
  int a = 0, bytes = 0;
  if (hi > lo) {
    a = (lo + 7) & ~7;
    const int b = hi & ~7;
    bytes = b > a ? 2 * (b - a) : 0;
    for (int u = lo; u < min(a, hi); ++u)
      sm.ring[u & (kRingWords - 1)] = abase[u];
    for (int u = max(a, b); u < hi; ++u)
      sm.ring[u & (kRingWords - 1)] = abase[u];
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  if (bytes) {
    // Order the block's earlier reads of this ring slot (generic proxy)
    // before the copy's writes (async proxy).
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(&sm.ring[a & (kRingWords - 1)])), "l"(abase + a),
        "r"(bytes), "r"(smem_addr(bar))
        : "memory");
  }
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
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem<kFixups>& sm = *reinterpret_cast<Smem<kFixups>*>(smem_raw);
  const int g = blockIdx.x;
  const int row = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t grow = static_cast<size_t>(g) * kRows + row;

  // The group's region, from the 16-byte boundary at or before its start.
  const uint16_t* gw = words + static_cast<size_t>(g) * n_words;
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(gw) & 15u)
                                     >> 1);
  const uint16_t* abase = gw - shift;
  int issued = kSlots;  // the next stream slot to fill (thread 0's count)
  if (threadIdx.x == 0) {
    for (int i = 0; i < kSlots; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   ::"r"(smem_addr(&sm.full[i]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int k = 0; k < kSlots; ++k) fill_slot(sm, abase, shift, n_words, k);
  }

  // The group's tables, staged by the whole block.
  {
    const uint4* lsrc = reinterpret_cast<const uint4*>(
        lookup_pk + static_cast<size_t>(g) * kRows * kLookupWords);
    uint4* ldst = reinterpret_cast<uint4*>(&sm.lookup[0][0]);
    for (int i = threadIdx.x; i < kRows * kLookupWords / 4; i += kThreads)
      ldst[i] = lsrc[i];
    const uint4* dsrc = reinterpret_cast<const uint4*>(
        dense_pk + static_cast<size_t>(g) * kRows * 256);
    uint4* ddst = reinterpret_cast<uint4*>(&sm.dense[0][0]);
    for (int i = threadIdx.x; i < kRows * 256 / 4; i += kThreads)
      ddst[i] = dsrc[i];
  }
  __syncthreads();

  const int my_count = counts[grow];
  // Per-group step count: the longest row's, never past the output width.
  const int max_count =
      __reduce_max_sync(kFull, counts[static_cast<size_t>(g) * kRows + lane]);
  const int steps = min((max(max_count, 0) + kLanes - 1) / kLanes, n_steps);

  const int lane0 = lane * kLanesPerThread;
  const uint4 s4 = *reinterpret_cast<const uint4*>(states + grow * kLanes
                                                   + lane0);
  uint32_t x[kLanesPerThread] = {s4.x, s4.y, s4.z, s4.w};
  uint8_t* out = syms + grow * static_cast<size_t>(n_steps) * kLanes + lane0;
  const uint32_t lanes_before = (1u << lane) - 1u;
  int ready = -1;  // the last stream slot every thread has waited for

  // Stream positions count from the region's 16-byte boundary: rpos is
  // the step's first word, rend the region's end.
  int rpos = shift;
  const int rend = shift + n_words;
  for (int s = 0; s < steps; ++s) {
    const int col0 = s * kLanes + lane0;
    // Lanes j < live are live (the row's count may end in this step). The
    // step is branch free: every lane computes, selects keep or drop.
    const int live = min(max(my_count - col0, 0), kLanesPerThread);
    uint32_t pk[kLanesPerThread];
    uint32_t need = 0;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const uint32_t slot = x[j] & 4095u;
      pk[j] = sm.dense[row][dense_id<kFixups>(sm.lookup[row], slot)];
      const uint32_t xn = ((pk[j] >> 12) & 4095u) * (x[j] >> kScaleBits)
                          + slot - (pk[j] & 4095u);
      const bool on = j < live;
      x[j] = on ? xn : x[j];
      need |= (on && xn < (1u << 16)) ? 1u << j : 0u;
    }
    // The symbols are the tables' top bytes, four to a 32-bit store.
    *reinterpret_cast<uint32_t*>(out) =
        __byte_perm(__byte_perm(pk[0], pk[1], 0x73),
                    __byte_perm(pk[2], pk[3], 0x73), 0x5410);
    out += kLanes;

    // In-row exclusive rank of this thread's first word: one ballot per
    // lane slot. The row's last thread publishes the row's words.
    int rank = 0;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j)
      rank += __popc(__ballot_sync(kFull, (need >> j) & 1u) & lanes_before);
    int* tot = sm.tot[s & 1];
    if (lane == 31) tot[row] = rank + __popc(need);
    __syncthreads();

    // Every earlier slot's reads are done: refill the ring ahead of rpos.
    if (threadIdx.x == 0) {
      const int cur = rpos >> kSlotLog2;
      while (issued < cur + kSlots) fill_slot(sm, abase, shift, n_words,
                                             issued++);
    }
    const int t = tot[lane];
    const int row_off = __reduce_add_sync(kFull, lane < row ? t : 0);
    const int step_words = __reduce_add_sync(kFull, t);
    if (step_words > 0) {
      const int last = (rpos + step_words - 1) >> kSlotLog2;
      while (ready < last) {
        ++ready;
        mbar_wait(&sm.full[ready & (kSlots - 1)], (ready / kSlots) & 1);
      }
    }

    // x < 2^16 where a word is needed: (x << 16) | w is one byte permute.
    int idx = rpos + row_off + rank;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const bool nj = (need >> j) & 1u;
      const uint32_t w =
          nj && idx < rend ? sm.ring[idx & (kRingWords - 1)] : 0u;
      x[j] = nj ? __byte_perm(w, x[j], 0x5410) : x[j];
      idx += nj;
    }
    rpos += step_words;
  }
  const int pos = rpos - shift;
  if (threadIdx.x == 0) {
    used[g] = pos;
    // No bulk copy may still be writing when the block's memory is freed.
    for (int k = ready + 1; k < issued; ++k)
      mbar_wait(&sm.full[k & (kSlots - 1)], (k / kSlots) & 1);
  }
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

// Dynamic shared memory of a form's block, in bytes (for reports).
extern "C" int mts_rans_decode_smem_bytes(int fixups) {
  switch (fixups) {
    case 0: return static_cast<int>(sizeof(Smem<0>));
    case 1: return static_cast<int>(sizeof(Smem<1>));
    case 2: return static_cast<int>(sizeof(Smem<2>));
    default: return -1;
  }
}

extern "C" const char* mts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
