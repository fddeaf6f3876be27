// K4, K2 and K3: transpose + time scan of channel-major integers for
// Hopper (sm_90a), one kernel family.
//
// Replaces the Pallas TPU kernels mtscomp_tpu/ops/device_delta.py::
// _cumsum_t_kernel (K4, entry cumsum_time_transposed), _cumsum_t8_kernel
// (K2, entry cumsum_time_transposed_u8) and _cumsum_t8_tail_kernel (K3,
// entry cumsum_time_transposed_u8_tail). Input: (B, C, T_in)
// int16, int32 or int64 elements, one row per channel (an F-order chunk's
// diffs); output: the (B, T, C) time-integrated samples,
//   inclusive:  out[b, t, c] = sum_{i <= t} in[b, c, i]
//   exclusive:  out[b, t, c] = head[b, c] + sum_{i < t} in[b, c, i]
// modulo 2^16, 2^32 or 2^64 (the element width). The exclusive form seeded by
// the verbatim first samples puts the head at t = 0 with no concatenation
// pass. The output is written at its final shape for any T and C: no
// 128-padding of time or channels, no trim pass.
//
// Three load stages feed the same kernel bodies:
//   element form  reads the elements themselves: int16, int32 and, where
//                 the TPU kernel had no form (JAX without x64 has no int64
//                 tensor), int64, summed in 64-bit accumulators
//                 (scan_common.cuh) in tile rows of 17 8-byte words;
//   plane form    (2-byte elements) reads the element's two byte planes,
//                 each a u8 (B, C, T_in) tensor with free batch and
//                 channel strides (K1's rows or a RAW plane, viewed in
//                 place) or one constant per chunk (a CONST plane),
//                 combines them (lo | hi << 8) and undoes the zigzag in
//                 unsigned 16 bits. It is the TPU's _cumsum_t8_kernel
//                 (constant high byte) extended to two coded planes: the
//                 generic decode of 2-byte data needs no torch pass
//                 between K1 and this kernel.
//   finalize form (K2, K3: the fuse8 decode) is the plane form with a
//                 CONST high plane, the zigzag and a head, and the low
//                 plane in up to two channel blocks: channel c < ca reads
//                 the bulk block (K1's rows in place), the others the
//                 tail block (K3: the 385th channel's ragged tail,
//                 gathered apart). The TPU needed a second kernel for
//                 the tail because a second HBM buffer cannot be merged
//                 cheaply inside a TPU tile; here it is a second pointer
//                 chosen per channel row, a template parameter so that
//                 K2 pays nothing for it. The high plane costs no memory
//                 read and no registers for its bytes.
//
// The TPU computed each 128 x 128 tile's prefix with byte-split matmuls
// and carried the sums across a sequential grid axis. Here blocks run in
// no order and integer adds wrap natively, so time is split across blocks
// instead of carried (scan_common.cuh): a block owns (chunk, time segment
// of 128 bytes a channel: 64 int16, 32 int32 or 16 int64 steps, tile of
// c_tile channels).
//   pass A  a warp per channel row sums the segment's elements (lanes
//           along time, a shuffle reduction) into the scratch totals;
//   pass B  seg_prefix_kernel: exclusive prefixes over the segments;
//   pass C  warps load channel rows (lanes along time: coalesced) into a
//           shared (channel, time) tile whose rows are an odd number of
//           words long (33 4-byte words; 17 8-byte words for int64, so
//           that every element keeps its 8-byte alignment); then thread =
//           channel walks its row, seeded with
//           head + prefix, and stores each step straight to the output:
//           a warp's store is 32 neighbouring channels of one time step,
//           the block's a run of c_tile channels (>= 128 bytes).
// An output of one segment runs pass C alone.
//
// What bounds it on the H100: bytes. The passes read the input twice and
// write the output once against the bound's one read and one write;
// B x ceil(T / 64) x ceil(C / c_tile) blocks (7,504 for 8 chunks of
// 30,000 x 385 int16) keep every SM busy at any batch. The stores are
// runs of 64 bytes a warp: output rows off the 32-byte sector grid (385
// channels: 770 bytes) cost about a third more time than rows on it.

#include <algorithm>

#include "scan_common.cuh"

namespace {

constexpr int kMaxThreads = 256;          // = the largest channel tile
constexpr int kSegBytes = 128;            // a channel row's bytes a segment
// A tile row in 4-byte words: odd, so that the channel walk (a thread a
// row) is free of bank conflicts.
constexpr int kRowWords = kSegBytes / 4 + 1;

// Time steps a segment: 64 of int16, 32 of int32, 16 of int64.
template <typename T>
constexpr int kSteps = kSegBytes / static_cast<int>(sizeof(T));
// A tile row in elements: 33 words of 4 bytes for 2- and 4-byte elements,
// 17 words of 8 bytes for 8-byte ones (a row of 33 4-byte words would put
// every other row's 8-byte elements off their alignment). Odd either way:
// the channel walk is free of bank conflicts.
template <typename T>
constexpr int kRowElems = sizeof(T) == 8
                              ? kSteps<T> + 1
                              : kRowWords * 4 / static_cast<int>(sizeof(T));

constexpr int kItemsAhead = 4;            // 16-step loads a thread issues

// Load stage of the element form: elements (B, C, T_in), time stride 1.
template <typename T>
struct ElemLoad {
  using Acc = acc_t<T>;

  const T* in;
  long long bstride, cstride;

  // No 16-step loads: its rows start anywhere on the element grid.
  static constexpr bool kVector = false;
  static constexpr int kSegSteps = kSteps<T>;
  // Channel rows whose loads a warp issues before it uses any (measured
  // on an H100 at 385 channels: int16 is fastest at 8; int32 at 16; int64
  // at 16, against 8 and 32).
  static constexpr int kRowsAhead = sizeof(T) == 2 ? 8 : 16;

  __device__ __forceinline__ void bind(int b) { in += b * bstride; }
  __device__ __forceinline__ Acc operator()(int c, int t) const {
    return widen(in[c * cstride + t]);
  }
};

// One byte plane: rows (B, C, T_in) u8 with time stride 1, or (rows null)
// one constant per chunk.
struct Plane {
  const uint8_t* rows;
  long long bstride, cstride;
  const uint8_t* consts;
};

// Load stage of the plane form: int16 elements from two byte planes.
// Where every plane row starts on the 16-byte grid (K1's rows do), a
// thread loads 16 steps of a plane at once: one byte a lane keeps too few
// bytes in flight to fill the memory pipe.
struct PlaneLoad {
  using Acc = uint32_t;
  static constexpr bool kVector = true;
  static constexpr int kSegSteps = kSteps<int16_t>;
  static constexpr int kRowsAhead = 8;     // for rows off the 16-byte grid

  Plane lo, hi;
  int zigzag;
  uint32_t lo_const, hi_const;

  __device__ __forceinline__ void bind(int b) {
    if (lo.rows != nullptr) lo.rows += b * lo.bstride;
    if (hi.rows != nullptr) hi.rows += b * hi.bstride;
    lo_const = lo.rows == nullptr ? lo.consts[b] : 0u;
    hi_const = hi.rows == nullptr ? hi.consts[b] : 0u;
  }
  __device__ __forceinline__ uint32_t operator()(int c, int t) const {
    const uint32_t l =
        lo.rows != nullptr ? lo.rows[c * lo.cstride + t] : lo_const;
    const uint32_t h =
        hi.rows != nullptr ? hi.rows[c * hi.cstride + t] : hi_const;
    uint32_t z = l | (h << 8);                 // unsigned 16 bits
    if (zigzag) z = ((z >> 1) ^ (0u - (z & 1u))) & 0xffffu;
    return widen(static_cast<int16_t>(static_cast<uint16_t>(z)));
  }
  // The 16 bytes of each plane for steps [t, t + 16) of channel c.
  __device__ __forceinline__ void load16(int c, int t, uint4& l,
                                         uint4& h) const {
    const uint32_t lc = lo_const * 0x01010101u;
    const uint32_t hc = hi_const * 0x01010101u;
    l = lo.rows != nullptr
            ? *reinterpret_cast<const uint4*>(lo.rows + c * lo.cstride + t)
            : make_uint4(lc, lc, lc, lc);
    h = hi.rows != nullptr
            ? *reinterpret_cast<const uint4*>(hi.rows + c * hi.cstride + t)
            : make_uint4(hc, hc, hc, hc);
  }
  // Two elements in one word: combined, and unzigzagged in each half.
  __device__ __forceinline__ uint32_t pair(uint32_t z2) const {
    if (!zigzag) return z2;
    return ((z2 >> 1) & 0x7fff7fffu) ^ ((z2 & 0x00010001u) * 0xffffu);
  }
  // load16's bytes -> 8 words of two decoded int16 elements, in step order.
  __device__ __forceinline__ void decode16(const uint4& l, const uint4& h,
                                           uint32_t* w) const {
    const uint32_t lw[4] = {l.x, l.y, l.z, l.w};
    const uint32_t hw[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[2 * i] = pair(__byte_perm(lw[i], hw[i], 0x5140));      // l0 h0 l1 h1
      w[2 * i + 1] = pair(__byte_perm(lw[i], hw[i], 0x7362));  // l2 h2 l3 h3
    }
  }
};

// One channel block of a byte plane: rows (B, channels, T_in) u8 with time
// stride 1 and free batch and channel strides, in bytes.
struct Rows {
  const uint8_t* p;
  long long bstride, cstride;
};

// Load stage of the finalize form: int16 elements from the low plane's
// rows, in one or (kTail) two channel blocks, under one high byte a chunk;
// always zigzagged. The 16-step loads need every row of both blocks on
// the 16-byte grid (K1's rows are, and a freshly gathered tail block).
template <bool kTail>
struct FinalizeLoad {
  using Acc = uint32_t;
  static constexpr bool kVector = true;
  static constexpr int kSegSteps = kSteps<int16_t>;
  static constexpr int kRowsAhead = 8;     // for rows off the 16-byte grid

  Rows bulk, tail;                         // channels [0, ca) and [ca, C)
  int ca;
  const uint8_t* hi;                       // (B,) the chunks' high bytes
  uint32_t hi4;                            // bound: the byte, four times

  __device__ __forceinline__ void bind(int b) {
    bulk.p += b * bulk.bstride;
    if (kTail) tail.p += b * tail.bstride;
    hi4 = hi[b] * 0x01010101u;
  }
  __device__ __forceinline__ const uint8_t* row(int c) const {
    if (kTail && c >= ca) return tail.p + (c - ca) * tail.cstride;
    return bulk.p + c * bulk.cstride;
  }
  __device__ __forceinline__ uint32_t operator()(int c, int t) const {
    const uint32_t z = row(c)[t] | (hi4 & 0xff00u);   // unsigned 16 bits
    const uint32_t d = ((z >> 1) ^ (0u - (z & 1u))) & 0xffffu;
    return widen(static_cast<int16_t>(static_cast<uint16_t>(d)));
  }
  // The low plane's 16 bytes for steps [t, t + 16) of channel c; the high
  // plane takes no load (h stays unused).
  __device__ __forceinline__ void load16(int c, int t, uint4& l,
                                         uint4&) const {
    l = *reinterpret_cast<const uint4*>(row(c) + t);
  }
  // load16's bytes -> 8 words of two decoded int16 elements, in step order.
  __device__ __forceinline__ void decode16(const uint4& l, const uint4&,
                                           uint32_t* w) const {
    const uint32_t lw[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // l0 h l1 h, then l2 h l3 h: combined, unzigzagged in each half.
      const uint32_t z2 =
          __byte_perm(lw[i >> 1], hi4, (i & 1) ? 0x7362 : 0x5140);
      w[i] = ((z2 >> 1) & 0x7fff7fffu) ^ ((z2 & 0x00010001u) * 0xffffu);
    }
  }
};

// Sum of the two sign-extended int16 halves of a word.
__device__ __forceinline__ uint32_t pair_sum(uint32_t w) {
  return static_cast<uint32_t>(
      static_cast<int32_t>(static_cast<int16_t>(w & 0xffffu)) +
      (static_cast<int32_t>(w) >> 16));
}

// Block (b, seg, ct) of the grid.
struct Tile {
  int b, seg, c0, rows, t0;
};

__device__ __forceinline__ Tile block_tile(int C, int n_steps, int c_tile,
                                           int n_seg, int n_ct) {
  Tile t;
  const int ct = blockIdx.x % n_ct;
  const int bs = blockIdx.x / n_ct;
  t.seg = bs % n_seg;
  t.b = bs / n_seg;
  t.c0 = ct * c_tile;
  t.rows = min(c_tile, C - t.c0);
  t.t0 = t.seg * n_steps;
  return t;
}

// Pass A, a warp a channel row (lanes along time), kRowsAhead rows at a
// time so that their loads are issued before any is used.
template <typename Load>
__device__ __forceinline__ void row_totals(const Load& load, const Tile& t,
                                           int n_read,
                                           typename Load::Acc* dst) {
  constexpr int kAhead = Load::kRowsAhead;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r0 = threadIdx.x >> 5; r0 < t.rows; r0 += kAhead * n_warps) {
    typename Load::Acc sum[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) sum[j] = 0;
    for (int k = lane; k < n_read; k += 32) {
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int r = r0 + j * n_warps;
        if (r < t.rows) sum[j] += load(t.c0 + r, t.t0 + k);
      }
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      const int r = r0 + j * n_warps;
      typename Load::Acc v = sum[j];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      if (lane == 0 && r < t.rows) dst[r] = v;
    }
  }
}

// Pass A with 16-step loads (int16 elements). Item i = 16 steps of a row:
// the 4 neighbouring lanes of a row add up by shuffles. Every thread of a
// warp runs every iteration (the shuffles need them all).
template <typename Load>
__device__ __forceinline__ void vector_totals(const Load& load, const Tile& t,
                                              int n_read, uint32_t* dst) {
  constexpr int per_row = kSteps<int16_t> / 16;
  const int items = t.rows * per_row;
  const int tid = threadIdx.x;
  for (int base = 0; base < items; base += kItemsAhead * blockDim.x) {
    uint4 l[kItemsAhead], h[kItemsAhead];
#pragma unroll
    for (int j = 0; j < kItemsAhead; ++j) {
      const int i = base + tid + j * blockDim.x;
      const int k0 = (i % per_row) << 4;
      if (i < items && k0 + 16 <= n_read) {
        load.load16(t.c0 + i / per_row, t.t0 + k0, l[j], h[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kItemsAhead; ++j) {
      const int i = base + tid + j * blockDim.x;
      const int r = i / per_row;
      const int k0 = (i % per_row) << 4;
      uint32_t sum = 0;
      if (i < items && k0 + 16 <= n_read) {
        uint32_t w[8];
        load.decode16(l[j], h[j], w);
#pragma unroll
        for (int q = 0; q < 8; ++q) sum += pair_sum(w[q]);
      } else if (i < items) {             // the segment's ragged end
        for (int k = k0; k < min(k0 + 16, n_read); ++k) {
          sum += load(t.c0 + r, t.t0 + k);
        }
      }
#pragma unroll
      for (int d = per_row >> 1; d > 0; d >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, d);
      }
      if (i < items && i % per_row == 0) dst[r] = sum;
    }
  }
}

// Pass A: totals[b, seg, c] = sum of the segment's elements of channel c.
template <typename Load>
__global__ void __launch_bounds__(kMaxThreads)
scan_transposed_totals_kernel(Load load,
                              typename Load::Acc* __restrict__ totals,
                              int C, int t_in, int c_tile, int n_seg,
                              int n_ct, int vec) {
  constexpr int n_steps = Load::kSegSteps;
  const Tile t = block_tile(C, n_steps, c_tile, n_seg, n_ct);
  load.bind(t.b);
  const int n_read = min(n_steps, t_in - t.t0);
  typename Load::Acc* dst =
      totals + (static_cast<size_t>(t.b) * n_seg + t.seg) * C + t.c0;
  if constexpr (Load::kVector) {
    if (vec) {
      vector_totals(load, t, n_read, dst);
      return;
    }
  }
  row_totals(load, t, n_read, dst);
}

// Pass C's tile fill, a warp a channel row: tile[r][k] = element k of the
// segment's row r, 0 beyond the input's end (n_read may be <= 0).
template <typename T, typename Load>
__device__ __forceinline__ void row_fill(const Load& load, const Tile& t,
                                         int n_read, int n_out, T* tile) {
  constexpr int row_elems = kRowElems<T>;
  constexpr int kAhead = Load::kRowsAhead;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int r0 = threadIdx.x >> 5; r0 < t.rows; r0 += kAhead * n_warps) {
    for (int k = lane; k < n_out; k += 32) {
      typename Load::Acc v[kAhead];
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int r = r0 + j * n_warps;
        v[j] = (r < t.rows && k < n_read) ? load(t.c0 + r, t.t0 + k) : 0u;
      }
#pragma unroll
      for (int j = 0; j < kAhead; ++j) {
        const int r = r0 + j * n_warps;
        if (r < t.rows) tile[r * row_elems + k] = narrow<T>(v[j]);
      }
    }
  }
}

// The tile fill with 16-step loads: item i = 16 steps of a row, stored as
// 8 words of two int16 elements.
template <typename Load>
__device__ __forceinline__ void vector_fill(const Load& load, const Tile& t,
                                            int n_read, int n_out,
                                            uint32_t* tile32) {
  constexpr int per_row = kSteps<int16_t> / 16;
  constexpr int row_words = kRowWords;
  const int items = t.rows * per_row;
  int16_t* tile = reinterpret_cast<int16_t*>(tile32);
  for (int i0 = threadIdx.x; i0 < items; i0 += kItemsAhead * blockDim.x) {
    uint4 l[kItemsAhead], h[kItemsAhead];
#pragma unroll
    for (int j = 0; j < kItemsAhead; ++j) {
      const int i = i0 + j * blockDim.x;
      const int k0 = (i % per_row) << 4;
      if (i < items && k0 + 16 <= n_read) {
        load.load16(t.c0 + i / per_row, t.t0 + k0, l[j], h[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kItemsAhead; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i >= items) continue;
      const int r = i / per_row;
      const int k0 = (i % per_row) << 4;
      if (k0 + 16 <= n_read) {
        uint32_t w[8];
        load.decode16(l[j], h[j], w);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          tile32[r * row_words + (k0 >> 1) + q] = w[q];
        }
      } else {                            // the segment's ragged end
        for (int k = k0; k < min(k0 + 16, n_out); ++k) {
          tile[r * 2 * row_words + k] =
              k < n_read ? narrow<int16_t>(load(t.c0 + r, t.t0 + k))
                         : int16_t(0);
        }
      }
    }
  }
}

// Pass C: the segment's scan, seeded with head (null: 0) + prefix (null
// for an output of one segment), transposed to (B, T_out, C).
template <typename T, typename Load>
__global__ void __launch_bounds__(kMaxThreads)
scan_transposed_kernel(Load load, const T* __restrict__ head,
                       const acc_t<T>* __restrict__ prefix,
                       T* __restrict__ out, int C, int T_out, int t_in,
                       int c_tile, int n_seg, int n_ct, int exclusive,
                       int vec) {
  extern __shared__ uint32_t smem[];
  T* tile = reinterpret_cast<T*>(smem);
  constexpr int n_steps = kSteps<T>;
  constexpr int row_elems = kRowElems<T>;
  const Tile t = block_tile(C, n_steps, c_tile, n_seg, n_ct);
  load.bind(t.b);
  const int n_read = min(n_steps, t_in - t.t0);
  const int n_out = min(n_steps, T_out - t.t0);
  if constexpr (Load::kVector) {
    if (vec) {
      vector_fill(load, t, n_read, n_out, smem);
    } else {
      row_fill(load, t, n_read, n_out, tile);
    }
  } else {
    row_fill(load, t, n_read, n_out, tile);
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= t.rows) return;
  const int cg = t.c0 + c;
  acc_t<T> run = 0;
  if (head != nullptr) run = widen(head[static_cast<size_t>(t.b) * C + cg]);
  if (prefix != nullptr) {
    run += prefix[(static_cast<size_t>(t.b) * n_seg + t.seg) * C + cg];
  }
  const T* row = tile + c * row_elems;
  T* dst = out + (static_cast<size_t>(t.b) * T_out + t.t0) * C + cg;
#pragma unroll 8
  for (int k = 0; k < n_out; ++k) {
    const acc_t<T> next = run + widen(row[k]);
    dst[static_cast<size_t>(k) * C] = narrow<T>(exclusive ? run : next);
    run = next;
  }
}

// Threads of a block: one a channel of the tile.
int block_threads(int c_tile, int C) {
  return std::min(c_tile, (C + 31) / 32 * 32);
}

// Dynamic shared memory of a pass C block: a tile row a thread.
template <typename T>
int scan_smem_bytes(int c_tile, int C) {
  return block_threads(c_tile, C) * kRowElems<T> *
         static_cast<int>(sizeof(T));
}

template <typename T, typename Load>
cudaError_t launch(const Load& load, bool aligned16, const void* head,
                   void* out, void* scratch, int n_batch, int C, int T_out,
                   int t_in, int n_steps, int c_tile, cudaStream_t stream) {
  static_assert(std::is_same_v<typename Load::Acc, acc_t<T>>,
                "the load stage sums in the element's accumulator");
  if (n_batch <= 0 || C <= 0 || T_out <= 0) return cudaSuccess;
  // The caller sized the scratch for its n_steps: it must be the kernels'.
  if (n_steps != kSteps<T> || c_tile <= 0 || c_tile > kMaxThreads ||
      c_tile % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  const int n_seg = (T_out + n_steps - 1) / n_steps;
  const int n_ct = (C + c_tile - 1) / c_tile;
  if (n_seg > 1 && scratch == nullptr) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(n_batch) * n_seg * n_ct;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int threads = block_threads(c_tile, C);
  const int vec = Load::kVector && aligned16;   // 16-step loads
  acc_t<T>* totals = static_cast<acc_t<T>*>(scratch);
  cudaError_t e;
  if (n_seg > 1) {
    scan_transposed_totals_kernel<Load>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            load, totals, C, t_in, c_tile, n_seg, n_ct, vec);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    e = launch_seg_prefix(totals, n_batch, n_seg, C, stream);
    if (e != cudaSuccess) return e;
  }
  const int smem = scan_smem_bytes<T>(c_tile, C);
  scan_transposed_kernel<T, Load>
      <<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
          load, static_cast<const T*>(head), n_seg > 1 ? totals : nullptr,
          static_cast<T*>(out), C, T_out, t_in, c_tile, n_seg, n_ct,
          head != nullptr, vec);
  return cudaGetLastError();
}

}  // namespace

// Element form. elem_bytes: 2 (int16), 4 (int32) or 8 (int64). head: null
// for the inclusive scan, else (B, C) elements seeding the exclusive one.
// Strides in elements. Time is cut into segments of n_steps = 128 /
// elem_bytes (what the caller sized the scratch for; any other value is
// refused) and channels into tiles of c_tile (a multiple of 32, at most
// 256). scratch: (B, ceil(T_out / n_steps), C) uint32 (uint64 for 8-byte
// elements), needed when T_out > n_steps.
extern "C" int mts_scan_transposed(int device, const void* in,
                                   long long bstride, long long cstride,
                                   const void* head, void* out, void* scratch,
                                   int n_batch, int C, int T_out, int t_in,
                                   int n_steps, int c_tile, int elem_bytes,
                                   void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 2) {
    const ElemLoad<int16_t> load{static_cast<const int16_t*>(in), bstride,
                                 cstride};
    e = launch<int16_t>(load, false, head, out, scratch, n_batch, C, T_out,
                        t_in, n_steps, c_tile, st);
  } else if (elem_bytes == 4) {
    const ElemLoad<int32_t> load{static_cast<const int32_t*>(in), bstride,
                                 cstride};
    e = launch<int32_t>(load, false, head, out, scratch, n_batch, C, T_out,
                        t_in, n_steps, c_tile, st);
  } else if (elem_bytes == 8) {
    const ElemLoad<int64_t> load{static_cast<const int64_t*>(in), bstride,
                                 cstride};
    e = launch<int64_t>(load, false, head, out, scratch, n_batch, C, T_out,
                        t_in, n_steps, c_tile, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Plane form: int16 elements lo | hi << 8 from two byte planes, the inverse
// zigzag where zigzag is set, then the element form's scan. A plane is
// rows (B, C, T_in) u8 with strides in bytes and time stride 1, or, with
// rows null, consts (B,) u8. head, out, scratch, n_steps and c_tile as for
// the element form.
extern "C" int mts_scan_transposed_planes(
    int device, const void* lo_rows, long long lo_bstride,
    long long lo_cstride, const void* lo_consts, const void* hi_rows,
    long long hi_bstride, long long hi_cstride, const void* hi_consts,
    int zigzag, const void* head, void* out, void* scratch, int n_batch,
    int C, int T_out, int t_in, int n_steps, int c_tile, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if ((lo_rows == nullptr && lo_consts == nullptr) ||
      (hi_rows == nullptr && hi_consts == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PlaneLoad load{
      {static_cast<const uint8_t*>(lo_rows), lo_bstride, lo_cstride,
       static_cast<const uint8_t*>(lo_consts)},
      {static_cast<const uint8_t*>(hi_rows), hi_bstride, hi_cstride,
       static_cast<const uint8_t*>(hi_consts)},
      zigzag, 0u, 0u};
  const auto on_grid = [](const void* rows, long long bs, long long cs) {
    return rows == nullptr ||
           ((reinterpret_cast<uintptr_t>(rows) | bs | cs) & 15) == 0;
  };
  return static_cast<int>(launch<int16_t>(
      load,
      on_grid(lo_rows, lo_bstride, lo_cstride) &&
          on_grid(hi_rows, hi_bstride, hi_cstride),
      head, out, scratch, n_batch, C, T_out, t_in, n_steps, c_tile,
      static_cast<cudaStream_t>(stream)));
}

// Finalize form (K2, K3): int16 elements lo | hi[b] << 8 from the low
// plane's rows and one high byte a chunk, the inverse zigzag, then the
// exclusive scan seeded by head (B, C) int16. bulk holds the rows of
// channels [0, ca), tail (null: none, ca = C) those of [ca, C); each a
// (B, channels, T_in) u8 block with strides in bytes and time stride 1.
// Rows off the 16-byte grid (a base or a stride of either block) only
// slow it: the loads are then one byte a lane. out, scratch, n_steps and
// c_tile as for the element form.
extern "C" int mts_finalize_u8(int device, const void* bulk,
                               long long bulk_bstride, long long bulk_cstride,
                               int ca, const void* tail,
                               long long tail_bstride, long long tail_cstride,
                               const void* head, const void* hi, void* out,
                               void* scratch, int n_batch, int C, int T_out,
                               int t_in, int n_steps, int c_tile,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  // No coded step (t_in = 0: the heads alone) reads no row.
  if ((bulk == nullptr && t_in > 0) || head == nullptr || hi == nullptr ||
      (tail != nullptr && (ca < 0 || ca > C))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Rows b{static_cast<const uint8_t*>(bulk), bulk_bstride, bulk_cstride};
  const Rows t{static_cast<const uint8_t*>(tail), tail_bstride, tail_cstride};
  const auto on_grid = [](const Rows& r) {
    return r.p == nullptr ||
           ((reinterpret_cast<uintptr_t>(r.p) | r.bstride | r.cstride) &
            15) == 0;
  };
  const bool aligned16 = on_grid(b) && on_grid(t);
  const uint8_t* his = static_cast<const uint8_t*>(hi);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tail != nullptr) {
    e = launch<int16_t>(FinalizeLoad<true>{b, t, ca, his, 0u}, aligned16,
                        head, out, scratch, n_batch, C, T_out, t_in, n_steps,
                        c_tile, st);
  } else {
    e = launch<int16_t>(FinalizeLoad<false>{b, t, C, his, 0u}, aligned16,
                        head, out, scratch, n_batch, C, T_out, t_in, n_steps,
                        c_tile, st);
  }
  return static_cast<int>(e);
}

// Dynamic shared memory of a pass C block, in bytes (for reports); the
// finalize and plane forms scan int16 (elem_bytes 2).
extern "C" int mts_scan_transposed_smem_bytes(int C, int c_tile,
                                              int elem_bytes) {
  switch (elem_bytes) {
    case 2: return scan_smem_bytes<int16_t>(c_tile, C);
    case 4: return scan_smem_bytes<int32_t>(c_tile, C);
    case 8: return scan_smem_bytes<int64_t>(c_tile, C);
    default: return -1;
  }
}
