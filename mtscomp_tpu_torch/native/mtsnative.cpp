// libmtsnative: first-party native runtime for mtscomp_tpu.
//
// Batch zlib deflate/inflate with a C++ worker-thread pool. This replaces
// the reference's Python ThreadPool driving zlib one chunk per call
// (reference behavior: mtscomp.py:399-423, 645-650) with a native batch
// loop: Python hands over N chunk buffers in one FFI call and worker
// threads stream through them with zero GIL involvement.
//
// The produced streams are byte-identical to CPython's zlib.compress()
// defaults (same zlib, Z_DEFAULT_COMPRESSION, 15-bit window).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

namespace {

// ---- grouped interleaved rANS encoder (normative spec: models/rans.py) ----
//
// Encodes one group: R segment rows x 128 lanes, shared merged word
// stream in decoder read order. Backward pass over steps; per (step,
// lane) at most one 16-bit word is emitted before the state update; the
// final stream is the step-ascending, row-major concatenation.

constexpr int kLanes = 128;
constexpr uint32_t kScaleBits = 12;
constexpr uint64_t kRansL = 1ull << 16;

#if defined(__x86_64__)
static bool cpu_has_avx512();
#endif

struct GroupTask {
  const uint8_t* const* rows;   // R pointers
  const int* counts;            // R
  const uint16_t* const* freqs; // R pointers to 256-entry tables
  int n_rows;
  uint32_t* states_out;         // R * 128
  uint16_t* words_out;          // capacity >= total symbols
  size_t words_cap;
  size_t words_len;             // result
  int error;
};

// Per-symbol packed encoder tables (the same division-free reciprocal
// scheme as models/rans.py encoder_tables and the Pallas encode
// kernel): pk = rcp_shift << 25 | cmpl << 12 | cum with cmpl =
// 4096 - f, and rcp the 32 low bits of ceil(2^(32+shift)/f) - 2^32;
// q = ((x - mulhi(x, rcp)) >> 1 + mulhi(x, rcp)) >> rcp_shift == x/f
// exactly for all 32-bit x. The state update becomes
// x + cum + q * cmpl — no vector division anywhere.
static void build_enc_tables(const uint16_t* freq, uint32_t* pk,
                             uint32_t* rcp) {
  uint32_t c = 0;
  for (int sym = 0; sym < 256; ++sym) {
    const uint32_t f = freq[sym];
    uint32_t shift = 0, r = 0;
    if (f >= 2) {
      while ((1u << shift) < f) ++shift;
      const uint64_t m =
          ((1ull << (32 + shift)) + f - 1) / f;        // in [2^32, 2^33)
      r = static_cast<uint32_t>(m - (1ull << 32));
    }
    const uint32_t rcp_shift = shift > 0 ? shift - 1 : 0;
    pk[sym] = (rcp_shift << 25) | ((4096u - f) << 12) | c;
    rcp[sym] = r;
    c += f;
  }
}

#if defined(__x86_64__)
__attribute__((target("avx512f,avx512bw,avx512dq,avx512vl")))
static int encode_span_avx512(uint32_t* xr, const uint32_t* pk,
                              const uint32_t* rcp, const uint8_t* syms,
                              int jmax, uint16_t* scratch) {
  // Backward-pass step body for one row: emit (pre-update, ascending
  // lane order via compress-store) then the reciprocal state update.
  int emitted = 0;
  int j = 0;
  const __m512i m4095 = _mm512_set1_epi32(4095);
  const __m512i m16 = _mm512_set1_epi32(0xFFFF);
  const __m512i lo32 = _mm512_set1_epi64(0xFFFFFFFFll);
  for (; j + 16 <= jmax; j += 16) {
    __m512i x = _mm512_loadu_si512(reinterpret_cast<const void*>(xr + j));
    __m512i sym = _mm512_cvtepu8_epi32(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(syms + j)));
    __m512i e = _mm512_i32gather_epi32(sym, pk, 4);
    __m512i r = _mm512_i32gather_epi32(sym, rcp, 4);
    __m512i cmpl = _mm512_and_epi32(_mm512_srli_epi32(e, 12),
                                    _mm512_set1_epi32(0x1FFF));
    __m512i f = _mm512_sub_epi32(_mm512_set1_epi32(4096), cmpl);
    // Emit where x >= f << 20 (u32 compare; f << 20 <= 4088 << 20 < 2^32).
    __m512i thr = _mm512_slli_epi32(f, 20);
    __mmask16 emit = _mm512_cmpge_epu32_mask(x, thr);
    const int cnt = __builtin_popcount(static_cast<unsigned>(emit));
    if (cnt) {
      __m512i low = _mm512_maskz_compress_epi32(
          emit, _mm512_and_epi32(x, m16));
      __m256i w16 = _mm512_cvtepi32_epi16(low);
      _mm256_mask_storeu_epi16(scratch + emitted,
                               static_cast<__mmask16>((1u << cnt) - 1),
                               w16);
      emitted += cnt;
      x = _mm512_mask_srli_epi32(x, emit, x, 16);
    }
    // q = x / f via round-up reciprocal; mulhi32 from two 64-bit muls.
    __m512i prod_e = _mm512_mul_epu32(x, r);
    __m512i prod_o = _mm512_mul_epu32(_mm512_srli_epi64(x, 32),
                                      _mm512_srli_epi64(r, 32));
    __m512i hi_e = _mm512_srli_epi64(prod_e, 32);
    __m512i hi = _mm512_mask_blend_epi32(
        0xAAAA, hi_e, _mm512_andnot_epi64(lo32, prod_o));
    __m512i xmt = _mm512_srli_epi32(_mm512_sub_epi32(x, hi), 1);
    __m512i shift = _mm512_srli_epi32(e, 25);
    __m512i q = _mm512_srlv_epi32(_mm512_add_epi32(xmt, hi), shift);
    __m512i cum = _mm512_and_epi32(e, m4095);
    x = _mm512_add_epi32(x, _mm512_add_epi32(
            cum, _mm512_mullo_epi32(q, cmpl)));
    _mm512_storeu_si512(reinterpret_cast<void*>(xr + j), x);
  }
  for (; j < jmax; ++j) {
    const uint8_t sym = syms[j];
    const uint32_t e = pk[sym];
    const uint32_t cmpl = (e >> 12) & 0x1FFF;
    const uint32_t f = 4096u - cmpl;
    uint32_t xx = xr[j];
    if (xx >= (f << 20)) {
      scratch[emitted++] = static_cast<uint16_t>(xx & 0xFFFF);
      xx >>= 16;
    }
    const uint32_t hi =
        static_cast<uint32_t>((static_cast<uint64_t>(xx) * rcp[sym]) >> 32);
    const uint32_t q = (((xx - hi) >> 1) + hi) >> (e >> 25);
    xx = xx + (e & 4095u) + q * cmpl;
    xr[j] = xx;
  }
  return emitted;
}
#endif  // __x86_64__

void encode_group(GroupTask& t) {
  const int R = t.n_rows;
  int S = 0;
  for (int r = 0; r < R; ++r) {
    int s = (t.counts[r] + kLanes - 1) / kLanes;
    if (s > S) S = s;
  }
  std::vector<uint32_t> x(static_cast<size_t>(R) * kLanes,
                          static_cast<uint32_t>(kRansL));
  std::vector<uint32_t> cum(static_cast<size_t>(R) * 256);
#if defined(__x86_64__)
  const bool use_avx512 = cpu_has_avx512();
  std::vector<uint32_t> pk, rcp;
  if (use_avx512) {
    pk.resize(static_cast<size_t>(R) * 256);
    rcp.resize(static_cast<size_t>(R) * 256);
    for (int r = 0; r < R; ++r)
      build_enc_tables(t.freqs[r], &pk[r * 256], &rcp[r * 256]);
  }
#endif
  for (int r = 0; r < R; ++r) {
    uint32_t c = 0;
    for (int sym = 0; sym < 256; ++sym) {
      cum[r * 256 + sym] = c;
      c += t.freqs[r][sym];
    }
  }
  // Assemble the stream right-to-left directly in the caller's output
  // buffer: steps are processed descending but laid out ascending, so
  // step s's words go immediately before the already-written words of
  // step s+1; one final memmove left-aligns the stream.
  uint16_t* big = t.words_out;
  size_t wpos = t.words_cap;
  std::vector<uint16_t> scratch(static_cast<size_t>(R) * kLanes);
  for (int s = S - 1; s >= 0; --s) {
    size_t step_n = 0;
    for (int r = 0; r < R; ++r) {
      const int base = s * kLanes;
      const int hi = t.counts[r] - base;
      if (hi <= 0) continue;
      const int jmax = hi < kLanes ? hi : kLanes;
      const uint8_t* row = t.rows[r] + base;
      uint32_t* xr = &x[static_cast<size_t>(r) * kLanes];
#if defined(__x86_64__)
      if (use_avx512) {
        step_n += encode_span_avx512(xr, &pk[r * 256], &rcp[r * 256],
                                     row, jmax, scratch.data() + step_n);
        continue;
      }
#endif
      const uint16_t* freq = t.freqs[r];
      const uint32_t* cumr = &cum[r * 256];
      for (int j = 0; j < jmax; ++j) {
        const uint8_t sym = row[j];
        const uint32_t f = freq[sym];
        uint32_t xx = xr[j];
        if (xx >= (f << 20)) {
          scratch[step_n++] = static_cast<uint16_t>(xx & 0xFFFF);
          xx >>= 16;
        }
        xr[j] = (xx / f) * (1u << kScaleBits) + (xx % f) + cumr[sym];
      }
    }
    if (step_n > wpos) {  // stream exceeds caller capacity
      t.error = 1;
      return;
    }
    wpos -= step_n;
    std::memcpy(big + wpos, scratch.data(), step_n * sizeof(uint16_t));
  }
  t.words_len = t.words_cap - wpos;
  std::memmove(t.words_out, big + wpos, t.words_len * sizeof(uint16_t));
  for (size_t i = 0; i < x.size(); ++i) t.states_out[i] = x[i];
  t.error = 0;
}

// ---- grouped interleaved rANS decoder (mirror of encode_group) ------------

struct DecodeTask {
  const uint32_t* states;        // R * 128
  const uint16_t* words;
  size_t n_words;
  const uint16_t* const* freqs;  // R pointers to 256-entry tables
  const int* counts;             // R
  int n_rows;
  uint8_t* const* rows_out;      // R pointers (counts[r] bytes each)
  size_t words_used;             // result
  int error;
};

// Packed per-slot decode entry: sym << 24 | freq << 12 | cum. One L1
// lookup yields everything the state update needs. freq fits 12 bits
// because present symbols cap at SCALE - MIN_FREQ = 4088 (>= 2 present
// symbols whenever a plane is RANS-coded).
//
// States fit uint32: the invariant keeps x < 2^32, and the update
// f * (x >> 12) + (slot - cum) <= 4088 * (2^20 - 1) + 4095 < 2^32.

#if defined(__x86_64__)
__attribute__((target("avx512f,avx512bw,avx512dq,avx512vl")))
static int decode_span_avx512(uint32_t* xr, const uint32_t* table,
                              uint8_t* out, int jmax,
                              const uint16_t* words, size_t n_words,
                              size_t* pos_io) {
  // 16 lanes per vector; lane order == scalar order, and vpexpandd
  // hands the next words to needy lanes in ascending-lane order —
  // exactly the decoder-order merged stream contract.
  size_t pos = *pos_io;
  const __m512i m4095 = _mm512_set1_epi32(4095);
  int j = 0;
  for (; j + 16 <= jmax; j += 16) {
    __m512i x = _mm512_loadu_si512(reinterpret_cast<const void*>(xr + j));
    __m512i slot = _mm512_and_epi32(x, m4095);
    __m512i e = _mm512_i32gather_epi32(slot, table, 4);
    __m128i syms = _mm512_cvtepi32_epi8(_mm512_srli_epi32(e, 24));
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + j), syms);
    __m512i f = _mm512_and_epi32(_mm512_srli_epi32(e, 12), m4095);
    __m512i cum = _mm512_and_epi32(e, m4095);
    x = _mm512_add_epi32(_mm512_sub_epi32(slot, cum),
                         _mm512_mullo_epi32(f, _mm512_srli_epi32(x, 12)));
    __mmask16 need =
        _mm512_cmplt_epu32_mask(x, _mm512_set1_epi32(65536));
    const int cnt = __builtin_popcount(static_cast<unsigned>(need));
    if (cnt) {
      if (pos + static_cast<size_t>(cnt) > n_words) return 2;
      __m256i w16;
      if (pos + 16 <= n_words) {
        w16 = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(words + pos));
      } else {
        alignas(32) uint16_t tmp[16] = {0};
        std::memcpy(tmp, words + pos, (n_words - pos) * sizeof(uint16_t));
        w16 = _mm256_load_si256(reinterpret_cast<const __m256i*>(tmp));
      }
      __m512i w32 = _mm512_cvtepu16_epi32(w16);
      __m512i wexp = _mm512_maskz_expand_epi32(need, w32);
      __m512i xre = _mm512_or_epi32(_mm512_slli_epi32(x, 16), wexp);
      x = _mm512_mask_mov_epi32(x, need, xre);
      pos += cnt;
    }
    _mm512_storeu_si512(reinterpret_cast<void*>(xr + j), x);
  }
  *pos_io = pos;
  // Scalar tail lanes (jmax not a multiple of 16).
  for (; j < jmax; ++j) {
    uint32_t xx = xr[j];
    const uint32_t slot = xx & 4095u;
    const uint32_t e = table[slot];
    out[j] = static_cast<uint8_t>(e >> 24);
    xx = ((e >> 12) & 4095u) * (xx >> kScaleBits) + slot - (e & 4095u);
    if (xx < kRansL) {
      if (*pos_io >= n_words) return 2;
      xx = (xx << 16) | words[(*pos_io)++];
    }
    xr[j] = xx;
  }
  return 0;
}

static bool cpu_has_avx512() {
  static const bool v = __builtin_cpu_supports("avx512f") &&
                        __builtin_cpu_supports("avx512bw") &&
                        __builtin_cpu_supports("avx512dq") &&
                        __builtin_cpu_supports("avx512vl");
  return v;
}
#endif  // __x86_64__

void decode_group(DecodeTask& t) {
  const int R = t.n_rows;
  int S = 0;
  for (int r = 0; r < R; ++r) {
    int s = (t.counts[r] + kLanes - 1) / kLanes;
    if (s > S) S = s;
  }
  // Per-row packed slot tables (4096 x u32: sym | freq | cum).
  std::vector<uint32_t> table(static_cast<size_t>(R) * 4096);
  for (int r = 0; r < R; ++r) {
    uint32_t c = 0;
    uint32_t* tb = &table[static_cast<size_t>(r) * 4096];
    for (int sym = 0; sym < 256; ++sym) {
      const uint32_t f = t.freqs[r][sym];
      if (c + f > (1u << kScaleBits) || f > 4095u) {  // corrupt table
        t.error = 3;
        return;
      }
      const uint32_t e = (static_cast<uint32_t>(sym) << 24) | (f << 12) | c;
      for (uint32_t k = 0; k < f; ++k) tb[c + k] = e;
      c += f;
    }
    if (c != (1u << kScaleBits)) { t.error = 3; return; }
  }
#if defined(__x86_64__)
  const bool use_avx512 = cpu_has_avx512();
#endif
  std::vector<uint32_t> x(t.states, t.states + static_cast<size_t>(R) * kLanes);
  size_t pos = 0;
  for (int s = 0; s < S; ++s) {
    const int base = s * kLanes;
    for (int r = 0; r < R; ++r) {
      const int hi = t.counts[r] - base;
      if (hi <= 0) continue;
      const int jmax = hi < kLanes ? hi : kLanes;
      const uint32_t* tb = &table[static_cast<size_t>(r) * 4096];
      uint32_t* xr = &x[static_cast<size_t>(r) * kLanes];
      uint8_t* out = t.rows_out[r] + base;
#if defined(__x86_64__)
      if (use_avx512) {
        const int rc = decode_span_avx512(xr, tb, out, jmax, t.words,
                                          t.n_words, &pos);
        if (rc) { t.error = rc; return; }
        continue;
      }
#endif
      for (int j = 0; j < jmax; ++j) {
        uint32_t xx = xr[j];
        const uint32_t slot = xx & 4095u;
        const uint32_t e = tb[slot];
        out[j] = static_cast<uint8_t>(e >> 24);
        xx = ((e >> 12) & 4095u) * (xx >> kScaleBits) + slot - (e & 4095u);
        if (xx < kRansL) {
          if (pos >= t.n_words) { t.error = 2; return; }
          xx = (xx << 16) | t.words[pos++];
        }
        xr[j] = xx;
      }
    }
  }
  t.words_used = pos;
  t.error = 0;
}

}  // namespace

extern "C" {

// Decode n_groups groups in parallel (mirror of mts_rans_encode_batch).
// words_used[g] receives the consumed word count (callers verify it
// equals the group's stream length — the corruption check).
int mts_rans_decode_batch(
    int n_groups, const int* group_row_offsets,
    const uint32_t* const* states, const uint16_t* const* words,
    const size_t* n_words, const uint16_t* const* row_freqs,
    const int* row_counts, uint8_t* const* row_out, size_t* words_used,
    int n_threads) {
  if (n_groups <= 0) return 0;
  std::vector<DecodeTask> tasks(n_groups);
  for (int g = 0; g < n_groups; ++g) {
    int r0 = group_row_offsets[g], r1 = group_row_offsets[g + 1];
    tasks[g] = DecodeTask{states[g],      words[g], n_words[g],
                          row_freqs + r0, row_counts + r0,
                          r1 - r0,        row_out + r0,
                          0,              0};
  }
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      int g = next.fetch_add(1);
      if (g >= n_groups || err.load()) return;
      decode_group(tasks[g]);
      if (tasks[g].error) err.store(tasks[g].error);
    }
  };
  int t = n_threads < 1 ? 1 : (n_threads < n_groups ? n_threads : n_groups);
  if (t <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(t);
    for (int k = 0; k < t; ++k) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  if (err.load()) return err.load();
  for (int g = 0; g < n_groups; ++g) words_used[g] = tasks[g].words_used;
  return 0;
}

// Encode n_groups groups in parallel. Flat row arrays are split per
// group by group_row_offsets (n_groups + 1 prefix offsets).
int mts_rans_encode_batch(
    int n_groups, const int* group_row_offsets,
    const uint8_t* const* row_ptrs, const int* row_counts,
    const uint16_t* const* row_freqs,
    uint32_t* const* states_out, uint16_t* const* words_out,
    const size_t* words_cap, size_t* words_len, int n_threads) {
  if (n_groups <= 0) return 0;
  std::vector<GroupTask> tasks(n_groups);
  for (int g = 0; g < n_groups; ++g) {
    int r0 = group_row_offsets[g], r1 = group_row_offsets[g + 1];
    tasks[g] = GroupTask{row_ptrs + r0, row_counts + r0, row_freqs + r0,
                         r1 - r0,       states_out[g],  words_out[g],
                         words_cap[g],  0,              0};
  }
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      int g = next.fetch_add(1);
      if (g >= n_groups || err.load()) return;
      encode_group(tasks[g]);
      if (tasks[g].error) err.store(tasks[g].error);
    }
  };
  int t = n_threads < 1 ? 1 : (n_threads < n_groups ? n_threads : n_groups);
  if (t <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(t);
    for (int k = 0; k < t; ++k) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  if (err.load()) return err.load();
  for (int g = 0; g < n_groups; ++g) words_len[g] = tasks[g].words_len;
  return 0;
}

size_t mts_deflate_bound(size_t n) { return compressBound(n); }

// Compress n buffers. out_len[i] receives the produced size.
// Returns 0 on success, nonzero on the first error encountered.
int mts_deflate_batch(int n, const uint8_t** in, const size_t* in_len,
                      uint8_t** out, size_t* out_cap, size_t* out_len,
                      int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load()) return;
      uLongf dest_len = static_cast<uLongf>(out_cap[i]);
      int rc = compress2(out[i], &dest_len, in[i],
                         static_cast<uLong>(in_len[i]),
                         Z_DEFAULT_COMPRESSION);
      if (rc != Z_OK) { err.store(rc ? rc : -1); return; }
      out_len[i] = static_cast<size_t>(dest_len);
    }
  };
  int t = n_threads < n ? n_threads : n;
  if (t <= 1) { worker(); return err.load(); }
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return err.load();
}

// Decompress n buffers into exact-size outputs (sizes known from the
// chunk geometry). Returns 0 on success.
int mts_inflate_batch(int n, const uint8_t** in, const size_t* in_len,
                      uint8_t** out, const size_t* out_size, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || err.load()) return;
      uLongf dest_len = static_cast<uLongf>(out_size[i]);
      int rc = uncompress(out[i], &dest_len, in[i],
                          static_cast<uLong>(in_len[i]));
      if (rc != Z_OK || dest_len != static_cast<uLongf>(out_size[i])) {
        err.store(rc ? rc : -1);
        return;
      }
    }
  };
  int t = n_threads < n ? n_threads : n;
  if (t <= 1) { worker(); return err.load(); }
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return err.load();
}

}  // extern "C"

// In-place cumulative sum along axis 0 of a C-contiguous (ns, nc)
// integer array: row t += row t-1, walking memory row-major (NumPy's
// cumsum reduces column-by-column with a huge stride here, which is
// cache-hostile on wide channel counts; this loop vectorizes and runs
// memory-bound). Unsigned arithmetic gives the defined mod-2^bits
// wraparound the format's exactness contract requires — bit-identical
// to NumPy's same-dtype cumsum.
template <typename T>
static void cumsum_axis0(T* buf, size_t ns, size_t nc) {
  for (size_t t = 1; t < ns; ++t) {
    T* prev = buf + (t - 1) * nc;
    T* cur = buf + t * nc;
    for (size_t c = 0; c < nc; ++c) cur[c] = (T)(cur[c] + prev[c]);
  }
}

// Fused finalize for the standard 2-byte aligned container: combine the
// two byte planes, invert zigzag and transpose channel-major plane
// streams into the (time, channel) output — one blocked pass instead of
// NumPy's plane-scatter + view-join + 4-temporary zigzag + F-order
// reshape copy (the host analogue of the device pipeline's fused u8
// finalize kernel). Plane kinds: 0 = padded channel-major (C, tp)
// stream (RANS), 1 = unpadded channel-major (C, tcs) bytes (RAW),
// 2 = constant byte. ``out`` points at chunk row 1 (the caller writes
// the verbatim head row); rows are C int16 each.
template <int LK, int HK>
static void fuse2_core(const uint8_t* lo, int lo_const, const uint8_t* hi,
                       int hi_const, size_t C, size_t tp, size_t tcs,
                       int16_t* out, size_t tr0, size_t tr1, size_t cr0,
                       size_t cr1) {
  const size_t lstride = LK == 1 ? tcs : tp;
  const size_t hstride = HK == 1 ? tcs : tp;
  const size_t TB = 128, CB = 128;   // L1-resident transpose tiles
  for (size_t t0 = tr0; t0 < tr1; t0 += TB) {
    size_t t1 = t0 + TB < tr1 ? t0 + TB : tr1;
    for (size_t c0 = cr0; c0 < cr1; c0 += CB) {
      size_t c1 = c0 + CB < cr1 ? c0 + CB : cr1;
      for (size_t t = t0; t < t1; ++t) {
        int16_t* orow = out + t * C;
        for (size_t c = c0; c < c1; ++c) {
          const uint16_t lv = LK == 2 ? static_cast<uint16_t>(lo_const)
                                      : lo[c * lstride + t];
          const uint16_t hv = HK == 2 ? static_cast<uint16_t>(hi_const)
                                      : hi[c * hstride + t];
          const uint16_t u = static_cast<uint16_t>(lv | (hv << 8));
          const uint16_t sgn = static_cast<uint16_t>(-(u & 1));
          orow[c] = static_cast<int16_t>(
              static_cast<uint16_t>((u >> 1) ^ sgn));
        }
      }
    }
  }
}

template <int LK>
static void fuse2_dispatch_hi(int hk, const uint8_t* lo, int lo_const,
                              const uint8_t* hi, int hi_const, size_t C,
                              size_t tp, size_t tcs, int16_t* out,
                              size_t tr0, size_t tr1, size_t cr0,
                              size_t cr1) {
  if (hk == 0)
    fuse2_core<LK, 0>(lo, lo_const, hi, hi_const, C, tp, tcs, out, tr0,
                      tr1, cr0, cr1);
  else if (hk == 1)
    fuse2_core<LK, 1>(lo, lo_const, hi, hi_const, C, tp, tcs, out, tr0,
                      tr1, cr0, cr1);
  else
    fuse2_core<LK, 2>(lo, lo_const, hi, hi_const, C, tp, tcs, out, tr0,
                      tr1, cr0, cr1);
}

// Vectorized range dispatch (ISA clones; flatten inlines the template
// instantiations so each clone vectorizes the inner loops).
__attribute__((flatten, target_clones("default", "avx2", "arch=x86-64-v4")))
static void fuse2_generic(const uint8_t* lo, int lo_kind, int lo_const,
                          const uint8_t* hi, int hi_kind, int hi_const,
                          size_t C, size_t tp, size_t tcs, int16_t* out,
                          size_t tr0, size_t tr1, size_t cr0, size_t cr1) {
  if (tr0 >= tr1 || cr0 >= cr1) return;
  if (lo_kind == 0)
    fuse2_dispatch_hi<0>(hi_kind, lo, lo_const, hi, hi_const, C, tp, tcs,
                         out, tr0, tr1, cr0, cr1);
  else if (lo_kind == 1)
    fuse2_dispatch_hi<1>(hi_kind, lo, lo_const, hi, hi_const, C, tp, tcs,
                         out, tr0, tr1, cr0, cr1);
  else
    fuse2_dispatch_hi<2>(hi_kind, lo, lo_const, hi, hi_const, C, tp, tcs,
                         out, tr0, tr1, cr0, cr1);
}

#if defined(__x86_64__)
// 16x16 uint16 transpose: the classic AVX2 unpack tree (epi16 pairs,
// epi32 stride-2, epi64 j/j+4, then cross-lane permute).
__attribute__((target("avx2"), always_inline)) inline
static void transpose16x16_u16(const __m256i in[16], __m256i out[16]) {
  __m256i a[16], b[16], c[16];
  for (int i = 0; i < 8; ++i) {
    a[2 * i] = _mm256_unpacklo_epi16(in[2 * i], in[2 * i + 1]);
    a[2 * i + 1] = _mm256_unpackhi_epi16(in[2 * i], in[2 * i + 1]);
  }
  for (int k = 0; k < 4; ++k) {
    b[4 * k + 0] = _mm256_unpacklo_epi32(a[4 * k + 0], a[4 * k + 2]);
    b[4 * k + 1] = _mm256_unpackhi_epi32(a[4 * k + 0], a[4 * k + 2]);
    b[4 * k + 2] = _mm256_unpacklo_epi32(a[4 * k + 1], a[4 * k + 3]);
    b[4 * k + 3] = _mm256_unpackhi_epi32(a[4 * k + 1], a[4 * k + 3]);
  }
  for (int k = 0; k < 2; ++k) {
    for (int j = 0; j < 4; ++j) {
      c[8 * k + 2 * j + 0] =
          _mm256_unpacklo_epi64(b[8 * k + j], b[8 * k + j + 4]);
      c[8 * k + 2 * j + 1] =
          _mm256_unpackhi_epi64(b[8 * k + j], b[8 * k + j + 4]);
    }
  }
  for (int j = 0; j < 8; ++j) {
    out[j] = _mm256_permute2x128_si256(c[j], c[j + 8], 0x20);
    out[j + 8] = _mm256_permute2x128_si256(c[j], c[j + 8], 0x31);
  }
}

// SIMD bulk of the finalize: combine + inverse zigzag on channel-major
// rows, 16x16 transpose in registers, contiguous stores into the
// (time, channel) output. Handles full 16x16 blocks only; the caller
// covers the edge strips with the scalar core. NULL plane pointer
// means a constant plane.
__attribute__((target("avx2")))
static void fuse2_avx2(const uint8_t* lo, size_t lstride, int lo_const,
                       const uint8_t* hi, size_t hstride, int hi_const,
                       size_t C, size_t tcs, int16_t* out, size_t T16,
                       size_t C16) {
  __m256i in[16], tr[16];
  const __m256i one = _mm256_set1_epi16(1);
  const __m256i zero = _mm256_setzero_si256();
  const __m256i lconst = _mm256_set1_epi16(static_cast<short>(lo_const));
  const __m256i hconst = _mm256_set1_epi16(static_cast<short>(hi_const));
  for (size_t t0 = 0; t0 < T16; t0 += 16) {
    for (size_t c0 = 0; c0 < C16; c0 += 16) {
      for (int c = 0; c < 16; ++c) {
        __m256i lv = lo == nullptr
            ? lconst
            : _mm256_cvtepu8_epi16(_mm_loadu_si128(
                  reinterpret_cast<const __m128i*>(
                      lo + (c0 + c) * lstride + t0)));
        __m256i hv = hi == nullptr
            ? hconst
            : _mm256_cvtepu8_epi16(_mm_loadu_si128(
                  reinterpret_cast<const __m128i*>(
                      hi + (c0 + c) * hstride + t0)));
        __m256i u = _mm256_or_si256(lv, _mm256_slli_epi16(hv, 8));
        __m256i sgn = _mm256_sub_epi16(zero, _mm256_and_si256(u, one));
        in[c] = _mm256_xor_si256(_mm256_srli_epi16(u, 1), sgn);
      }
      transpose16x16_u16(in, tr);
      for (int t = 0; t < 16; ++t)
        _mm256_storeu_si256(
            reinterpret_cast<__m256i*>(out + (t0 + t) * C + c0), tr[t]);
    }
  }
}

static bool cpu_has_avx2() {
  static const bool v = __builtin_cpu_supports("avx2");
  return v;
}
#endif  // __x86_64__

extern "C" int mts_fuse2_i16(
    const uint8_t* lo, int lo_kind, int lo_const,
    const uint8_t* hi, int hi_kind, int hi_const,
    size_t C, size_t tp, size_t tcs, int16_t* out) {
#if defined(__x86_64__)
  if (cpu_has_avx2() && tcs >= 16 && C >= 16) {
    const size_t T16 = tcs & ~static_cast<size_t>(15);
    const size_t C16 = C & ~static_cast<size_t>(15);
    fuse2_avx2(lo_kind == 2 ? nullptr : lo,
               lo_kind == 1 ? tcs : tp, lo_const,
               hi_kind == 2 ? nullptr : hi,
               hi_kind == 1 ? tcs : tp, hi_const, C, tcs, out, T16, C16);
    // Edge strips: trailing channels over all times, then trailing
    // times over the SIMD-covered channels.
    fuse2_generic(lo, lo_kind, lo_const, hi, hi_kind, hi_const, C, tp,
                  tcs, out, 0, tcs, C16, C);
    fuse2_generic(lo, lo_kind, lo_const, hi, hi_kind, hi_const, C, tp,
                  tcs, out, T16, tcs, 0, C16);
    return 0;
  }
#endif
  fuse2_generic(lo, lo_kind, lo_const, hi, hi_kind, hi_const, C, tp, tcs,
                out, 0, tcs, 0, C);
  return 0;
}

// Encode-side mirror of mts_fuse2_i16: read the chunk body (tcs, C)
// int16 time-major, optionally apply the time diff on the fly
// (``do_diff``: the input is then the RAW chunk whose row 0 is the
// verbatim head, and body(t,c) = raw[t+1,c] - raw[t,c] mod 2^16 —
// bit-identical to np.diff's same-dtype wraparound), zigzag, split
// bytes, and transpose into the two padded channel-major (C, tp) plane
// streams while accumulating histograms — one blocked pass replacing
// the np.diff + F-order ravel + zigzag + plane-split + pad-copy + two
// bincounts chain.
//
// Histogram modes (both count DATA symbols only; pads are accounted by
// the caller, matching the host codec's counts/scounts split):
//   k == 0, hist_lo != null : per-plane 256-bin totals into hist_*
//   k > 0,  seg_lo  != null : per-segment hists into seg_* — segment =
//                             k consecutive channels of the padded
//                             stream (the channel-aligned geometry:
//                             seg bytes = k * tp), ceil(C/k) rows of
//                             256. Replaces the separate
//                             mts_hist_u8_segments DRAM re-read.
//   neither                 : no histogram pass.
// Counting runs rowwise per channel block after its transpose (rows
// then still cache-resident), with 8 banks per plane — histogramming
// is RMW-chain-bound, not bandwidth-bound, and skewed diff planes
// (most symbols near zero) serialize on hot counters unless the banks
// split them. The lo/hi/hist buffers must arrive zeroed.
#if defined(__x86_64__)
// SIMD bulk of the encode prep's transform stage for one channel block:
// (optional) time diff + zigzag on the natural time-major rows (where
// loads are contiguous — 16 consecutive channels per row), 16x16
// register transpose, then lo/hi byte split with contiguous 16-byte
// stores into the channel-major plane rows. Bit-identical to the
// scalar sweep (same mod-2^16 arithmetic); handles full 16x16 tiles,
// the caller's scalar core covers time tails and leftover channels.
// The diff reads each input row once: a rolling `cur` register carries
// row t into the next step's subtraction.
__attribute__((target("avx2")))
static void prep2_block_avx2(const int16_t* chunk, size_t C, size_t tp,
                             size_t tcs, int do_diff, uint8_t* lo,
                             uint8_t* hi, size_t c0, size_t c1) {
  const __m256i ff = _mm256_set1_epi16(0xFF);
  const size_t T16 = tcs & ~static_cast<size_t>(15);
  __m256i in[16], tr[16];
  for (size_t cc = c0; cc + 16 <= c1; cc += 16) {
    __m256i cur = _mm256_loadu_si256(
        reinterpret_cast<const __m256i*>(chunk + cc));
    for (size_t t0 = 0; t0 < T16; t0 += 16) {
      for (int j = 0; j < 16; ++j) {
        const __m256i nxt = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(
                chunk + (t0 + j + (do_diff ? 1 : 0)) * C + cc));
        __m256i v = nxt;
        if (do_diff) {
          v = _mm256_sub_epi16(nxt, cur);
          cur = nxt;
        }
        // zigzag: (v << 1) ^ (0 or 0xFFFF by sign) — srai_epi16
        // broadcasts the sign bit exactly like -(v >> 15) on u16.
        in[j] = _mm256_xor_si256(_mm256_slli_epi16(v, 1),
                                 _mm256_srai_epi16(v, 15));
      }
      transpose16x16_u16(in, tr);
      for (int j = 0; j < 16; ++j) {
        const __m256i lo16 = _mm256_and_si256(tr[j], ff);
        const __m256i hi16 = _mm256_srli_epi16(tr[j], 8);
        // packus on values <= 255 is a pure narrowing (no saturation).
        const __m128i lo8 = _mm_packus_epi16(
            _mm256_castsi256_si128(lo16),
            _mm256_extracti128_si256(lo16, 1));
        const __m128i hi8 = _mm_packus_epi16(
            _mm256_castsi256_si128(hi16),
            _mm256_extracti128_si256(hi16, 1));
        _mm_storeu_si128(
            reinterpret_cast<__m128i*>(lo + (cc + j) * tp + t0), lo8);
        _mm_storeu_si128(
            reinterpret_cast<__m128i*>(hi + (cc + j) * tp + t0), hi8);
      }
    }
  }
}
#endif

static int prepare2_core(const int16_t* chunk, size_t C, size_t tp,
                         size_t tcs, int do_diff, uint8_t* lo, uint8_t* hi,
                         size_t k, uint32_t* hist_lo, uint32_t* hist_hi,
                         uint32_t* seg_lo, uint32_t* seg_hi) {
  const bool want_seg = k > 0 && seg_lo != nullptr;
  const bool want_hist = want_seg || hist_lo != nullptr;
  const size_t keff = want_seg ? k : C;
  uint32_t* out_lo = want_seg ? seg_lo : hist_lo;
  uint32_t* out_hi = want_seg ? seg_hi : hist_hi;
  std::vector<uint32_t> banks(want_hist ? 16 * 256 : 0, 0);
  uint32_t* bl = banks.data();
  uint32_t* bh = banks.data() + 8 * 256;
  size_t cur_seg = 0;
  auto flush = [&](size_t s) {
    uint32_t* ol = out_lo + s * 256;
    uint32_t* oh = out_hi + s * 256;
    for (int sym = 0; sym < 256; ++sym) {
      uint32_t al = 0, ah = 0;
      for (int b = 0; b < 8; ++b) {
        al += bl[b * 256 + sym];
        ah += bh[b * 256 + sym];
      }
      ol[sym] += al;
      oh[sym] += ah;
    }
    std::fill(banks.begin(), banks.end(), 0);
  };
  const size_t TB = 256, CB = 64;
  for (size_t c0 = 0; c0 < C; c0 += CB) {
    size_t c1 = c0 + CB < C ? c0 + CB : C;
    // Zero the per-channel pad tails ([tcs, tp)) here rather than
    // requiring pre-zeroed buffers: every data byte is written below,
    // so callers can hand over reused (dirty) scratch buffers and skip
    // the ~page-faulted 2x C*tp fresh allocation per chunk.
    if (tp > tcs) {
      for (size_t c = c0; c < c1; ++c) {
        std::memset(lo + c * tp + tcs, 0, tp - tcs);
        std::memset(hi + c * tp + tcs, 0, tp - tcs);
      }
    }
    // SIMD bulk (full 16-channel x 16-time tiles), scalar edges.
    size_t c_simd = c0;   // end of the SIMD-covered channel range
    size_t t_simd = 0;    // end of the SIMD-covered time range
#if defined(__x86_64__)
    if (cpu_has_avx2() && tcs >= 16 && c1 - c0 >= 16) {
      prep2_block_avx2(chunk, C, tp, tcs, do_diff, lo, hi, c0, c1);
      c_simd = c0 + ((c1 - c0) & ~static_cast<size_t>(15));
      t_simd = tcs & ~static_cast<size_t>(15);
    }
#endif
    auto scalar_sweep = [&](size_t cA, size_t cB, size_t tA, size_t tB) {
      for (size_t t0 = tA; t0 < tB; t0 += TB) {
        size_t t1 = t0 + TB < tB ? t0 + TB : tB;
        for (size_t c = cA; c < cB; ++c) {
          const int16_t* col = chunk + c;
          uint8_t* lrow = lo + c * tp;
          uint8_t* hrow = hi + c * tp;
          if (do_diff) {
            for (size_t t = t0; t < t1; ++t) {
              const uint16_t v = static_cast<uint16_t>(
                  static_cast<uint16_t>(col[(t + 1) * C]) -
                  static_cast<uint16_t>(col[t * C]));
              const uint16_t u = static_cast<uint16_t>(
                  (v << 1) ^ static_cast<uint16_t>(
                                 -static_cast<uint16_t>(v >> 15)));
              lrow[t] = static_cast<uint8_t>(u);
              hrow[t] = static_cast<uint8_t>(u >> 8);
            }
          } else {
            for (size_t t = t0; t < t1; ++t) {
              const uint16_t v = static_cast<uint16_t>(col[t * C]);
              const uint16_t u = static_cast<uint16_t>(
                  (v << 1) ^ static_cast<uint16_t>(
                                 -static_cast<uint16_t>(v >> 15)));
              lrow[t] = static_cast<uint8_t>(u);
              hrow[t] = static_cast<uint8_t>(u >> 8);
            }
          }
        }
      }
    };
    scalar_sweep(c0, c_simd, t_simd, tcs);   // time tail of SIMD channels
    scalar_sweep(c_simd, c1, 0, tcs);        // leftover channels, all times
    if (want_hist) {
      // Rowwise count over the block just transposed (L2-resident —
      // the RMW chain, not the re-read, bounds this pass).
      for (size_t c = c0; c < c1; ++c) {
        const size_t s = c / keff;
        if (s != cur_seg) {
          flush(cur_seg);
          cur_seg = s;
        }
        const uint8_t* lrow = lo + c * tp;
        const uint8_t* hrow = hi + c * tp;
        size_t t = 0;
        for (; t + 8 <= tcs; t += 8) {
          ++bl[0 * 256 + lrow[t]];
          ++bl[1 * 256 + lrow[t + 1]];
          ++bl[2 * 256 + lrow[t + 2]];
          ++bl[3 * 256 + lrow[t + 3]];
          ++bl[4 * 256 + lrow[t + 4]];
          ++bl[5 * 256 + lrow[t + 5]];
          ++bl[6 * 256 + lrow[t + 6]];
          ++bl[7 * 256 + lrow[t + 7]];
        }
        for (; t < tcs; ++t) ++bl[lrow[t]];
        // Hi-plane run fast path: skewed diff data leaves the high
        // byte in long runs (almost all zeros), so 64 equal bytes
        // collapse to one += 64 (bit-identical counts). The lo plane
        // rarely runs — the check measured as a net loss there.
        t = 0;
        for (; t + 64 <= tcs; t += 64) {
          uint64_t v0;
          std::memcpy(&v0, hrow + t, 8);
          const uint64_t splat = (v0 & 0xFF) * 0x0101010101010101ULL;
          uint64_t diff = v0 ^ splat;
          for (int j = 8; j < 64; j += 8) {
            uint64_t vj;
            std::memcpy(&vj, hrow + t + j, 8);
            diff |= vj ^ splat;
          }
          if (diff == 0) {
            bh[0 * 256 + (v0 & 0xFF)] += 64;
            continue;
          }
          for (int j = 0; j < 64; j += 8) {
            ++bh[0 * 256 + hrow[t + j]];
            ++bh[1 * 256 + hrow[t + j + 1]];
            ++bh[2 * 256 + hrow[t + j + 2]];
            ++bh[3 * 256 + hrow[t + j + 3]];
            ++bh[4 * 256 + hrow[t + j + 4]];
            ++bh[5 * 256 + hrow[t + j + 5]];
            ++bh[6 * 256 + hrow[t + j + 6]];
            ++bh[7 * 256 + hrow[t + j + 7]];
          }
        }
        for (; t < tcs; ++t) ++bh[hrow[t]];
      }
    }
  }
  if (want_hist) flush(cur_seg);
  return 0;
}

extern "C"
__attribute__((flatten, target_clones("default", "avx2", "arch=x86-64-v4")))
int mts_prepare2_i16(const int16_t* chunk, size_t C, size_t tp,
                                size_t tcs, uint8_t* lo, uint8_t* hi,
                                uint32_t* hist_lo, uint32_t* hist_hi) {
  return prepare2_core(chunk, C, tp, tcs, 0, lo, hi, 0, hist_lo, hist_hi,
                       nullptr, nullptr);
}

extern "C"
__attribute__((flatten, target_clones("default", "avx2", "arch=x86-64-v4")))
int mts_prepare2d_i16(const int16_t* chunk, size_t C, size_t tp,
                      size_t tcs, int do_diff, uint8_t* lo, uint8_t* hi,
                      size_t k, uint32_t* hist_lo, uint32_t* hist_hi,
                      uint32_t* seg_lo, uint32_t* seg_hi) {
  return prepare2_core(chunk, C, tp, tcs, do_diff, lo, hi, k, hist_lo,
                       hist_hi, seg_lo, seg_hi);
}

// Per-segment symbol histograms of a u8 stream: out[s*256 + sym] counts
// symbol occurrences in segment s ([s*seg, min((s+1)*seg, n))). Four
// count banks break the store-forwarding RMW chain (same trick as the
// prepare2 pass above); segments are tens of KB, so the per-segment
// bank reset/reduce is noise. Feeds the segment-table clustering
// (codec/ans.py decide_plane) — counting only, bit-trivially equal to
// numpy bincount per slice.
extern "C"
__attribute__((flatten, target_clones("default", "avx2", "arch=x86-64-v4")))
int mts_hist_u8_segments(const uint8_t* p, size_t n, size_t seg,
                         uint32_t* out) {
  if (seg == 0) return -1;
  const size_t n_segs = (n + seg - 1) / seg;
  std::vector<uint32_t> banks(4 * 256);
  for (size_t s = 0; s < n_segs; ++s) {
    std::fill(banks.begin(), banks.end(), 0);
    const uint8_t* q = p + s * seg;
    const size_t m = (s + 1) * seg <= n ? seg : n - s * seg;
    size_t t = 0;
    for (; t + 4 <= m; t += 4) {
      ++banks[0 * 256 + q[t]];
      ++banks[1 * 256 + q[t + 1]];
      ++banks[2 * 256 + q[t + 2]];
      ++banks[3 * 256 + q[t + 3]];
    }
    for (; t < m; ++t) ++banks[q[t]];
    uint32_t* o = out + s * 256;
    for (int sym = 0; sym < 256; ++sym)
      o[sym] = banks[sym] + banks[256 + sym] + banks[512 + sym] +
               banks[768 + sym];
  }
  return 0;
}

// ---- CRC32 (zlib polynomial) ------------------------------------------
//
// The container appends a zlib-compatible CRC32 to every chunk (codec/
// ans.py _append_crc / _verify), so CRC sits on both the encode and the
// decode hot path. zlib's slice-by-N tables run ~1-2 GB/s; 4x128-bit
// PCLMULQDQ folding (Intel's "Fast CRC Computation for Generic
// Polynomials Using PCLMULQDQ") measures ~12 GB/s on this class of
// host. The final 128->32 reduction feeds the 16 residual bytes through
// the scalar table with a zero register — exact, and sidesteps the
// Barrett-constant subtleties. Byte-identical to zlib.crc32 for every
// (seed, length, alignment); tests assert it.

static uint32_t g_crc_table[8][256];
static void crc_init_table() {
  for (int i = 0; i < 256; i++) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
    g_crc_table[0][i] = c;
  }
  for (int i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      g_crc_table[s][i] = (g_crc_table[s - 1][i] >> 8) ^
                          g_crc_table[0][g_crc_table[s - 1][i] & 0xFF];
}

// Raw-register update: no init/final inversion (callers handle the
// zlib ~crc convention).
static uint32_t crc32_raw(uint32_t reg, const uint8_t* p, size_t n) {
  while (n >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    v ^= reg;
    reg = g_crc_table[7][v & 0xFF] ^ g_crc_table[6][(v >> 8) & 0xFF] ^
          g_crc_table[5][(v >> 16) & 0xFF] ^ g_crc_table[4][(v >> 24) & 0xFF] ^
          g_crc_table[3][(v >> 32) & 0xFF] ^ g_crc_table[2][(v >> 40) & 0xFF] ^
          g_crc_table[1][(v >> 48) & 0xFF] ^ g_crc_table[0][(v >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) reg = (reg >> 8) ^ g_crc_table[0][(reg ^ *p++) & 0xFF];
  return reg;
}

#if defined(__x86_64__)
__attribute__((target("pclmul,sse4.1")))
static uint32_t crc32_pclmul_raw(uint32_t reg, const uint8_t* buf,
                                 size_t len) {
  // Preconditions: len >= 64 and len % 16 == 0. Raw register in/out.
  const __m128i k1k2 =
      _mm_set_epi64x(0x00000001c6e41596LL, 0x0000000154442bd4LL);
  const __m128i k3k4 =
      _mm_set_epi64x(0x00000000ccaa009eLL, 0x00000001751997d0LL);
  __m128i x0 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf));
  __m128i x1 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 16));
  __m128i x2 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 32));
  __m128i x3 = _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 48));
  x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128(static_cast<int>(reg)));
  buf += 64;
  len -= 64;
  __m128i t;
  while (len >= 64) {
    t = _mm_clmulepi64_si128(x0, k1k2, 0x00);
    x0 = _mm_clmulepi64_si128(x0, k1k2, 0x11);
    x0 = _mm_xor_si128(
        _mm_xor_si128(x0, t),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf)));
    t = _mm_clmulepi64_si128(x1, k1k2, 0x00);
    x1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
    x1 = _mm_xor_si128(
        _mm_xor_si128(x1, t),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 16)));
    t = _mm_clmulepi64_si128(x2, k1k2, 0x00);
    x2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
    x2 = _mm_xor_si128(
        _mm_xor_si128(x2, t),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 32)));
    t = _mm_clmulepi64_si128(x3, k1k2, 0x00);
    x3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
    x3 = _mm_xor_si128(
        _mm_xor_si128(x3, t),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf + 48)));
    buf += 64;
    len -= 64;
  }
  t = _mm_clmulepi64_si128(x0, k3k4, 0x00);
  x0 = _mm_clmulepi64_si128(x0, k3k4, 0x11);
  x1 = _mm_xor_si128(_mm_xor_si128(x1, t), x0);
  t = _mm_clmulepi64_si128(x1, k3k4, 0x00);
  x1 = _mm_clmulepi64_si128(x1, k3k4, 0x11);
  x2 = _mm_xor_si128(_mm_xor_si128(x2, t), x1);
  t = _mm_clmulepi64_si128(x2, k3k4, 0x00);
  x2 = _mm_clmulepi64_si128(x2, k3k4, 0x11);
  x3 = _mm_xor_si128(_mm_xor_si128(x3, t), x2);
  __m128i x = x3;
  while (len >= 16) {
    t = _mm_clmulepi64_si128(x, k3k4, 0x00);
    x = _mm_clmulepi64_si128(x, k3k4, 0x11);
    x = _mm_xor_si128(
        _mm_xor_si128(x, t),
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(buf)));
    buf += 16;
    len -= 16;
  }
  uint8_t residual[16];
  _mm_storeu_si128(reinterpret_cast<__m128i*>(residual), x);
  return crc32_raw(0, residual, 16);
}
#endif  // __x86_64__

extern "C" uint32_t mts_crc32(uint32_t crc, const uint8_t* p, size_t n) {
  static const bool init = [] {
    crc_init_table();
    return true;
  }();
  (void)init;
#if defined(__x86_64__)
  static const bool has_pclmul = __builtin_cpu_supports("pclmul") &&
                                 __builtin_cpu_supports("sse4.1");
  if (has_pclmul && n >= 64) {
    const size_t body = n & ~static_cast<size_t>(15);
    const uint32_t reg = crc32_pclmul_raw(~crc, p, body);
    return ~crc32_raw(reg, p + body, n - body);
  }
#endif
  return ~crc32_raw(~crc, p, n);
}

extern "C"
__attribute__((flatten, target_clones("default", "avx2", "arch=x86-64-v4")))
int mts_cumsum_axis0(void* buf, size_t ns, size_t nc,
                                int itemsize) {
  switch (itemsize) {
    case 1: cumsum_axis0(static_cast<uint8_t*>(buf), ns, nc); return 0;
    case 2: cumsum_axis0(static_cast<uint16_t*>(buf), ns, nc); return 0;
    case 4: cumsum_axis0(static_cast<uint32_t*>(buf), ns, nc); return 0;
    case 8: cumsum_axis0(static_cast<uint64_t*>(buf), ns, nc); return 0;
    default: return -1;
  }
}

// Row-batched frequency quantization, bit-identical to the normative
// models/rans.py quantize_freqs (largest-remainder apportionment in
// min_freq units, then one-unit steals from the repeated first-index
// maximum). Exists because the segment-table clustering (codec/ans.py
// cluster_segment_tables) quantizes many small candidate stacks per
// Lloyd iteration and the vectorized NumPy form is per-call-overhead
// bound there (~25 array ops per call at K <= 16). The float64
// arithmetic mirrors NumPy exactly: counts * q stays in int64, the
// division is one IEEE double op, fractions compare bitwise equal.
// Unlike the Python closed-form steal, the scalar loop here IS the
// reference loop — identity by construction.
// counts: (K, 256) int64, every row with >= 2 present symbols and a
// positive total. out: (K, 256) uint16. Returns 0, or -1 on a row the
// contract excludes (caller falls back to the NumPy path).
extern "C" int mts_quantize_freqs_batch(const int64_t* counts, size_t K,
                                        uint32_t scale, uint32_t min_freq,
                                        uint16_t* out) {
  if (scale == 0 || min_freq == 0 || scale % min_freq != 0) return -1;
  const int64_t q = scale / min_freq;
  for (size_t row = 0; row < K; ++row) {
    const int64_t* c = counts + row * 256;
    uint16_t* o = out + row * 256;
    int64_t total = 0;
    int n_present = 0;
    for (int i = 0; i < 256; ++i) {
      if (c[i] < 0) return -1;
      total += c[i];
      n_present += c[i] > 0;
    }
    if (total <= 0 || n_present < 2 ||
        static_cast<int64_t>(n_present) * min_freq >
            static_cast<int64_t>(scale))
      return -1;
    int64_t f[256];
    double frac[256];
    int64_t fsum = 0;
    const double dtot = static_cast<double>(total);
    for (int i = 0; i < 256; ++i) {
      if (c[i] > 0) {
        const double ideal = static_cast<double>(c[i] * q) / dtot;
        const double fl = std::floor(ideal);
        int64_t v = static_cast<int64_t>(fl);
        frac[i] = ideal - fl;
        if (v < 1) v = 1;
        f[i] = v;
      } else {
        f[i] = 0;
        frac[i] = -1.0;
      }
      fsum += f[i];
    }
    const int64_t remainder = q - fsum;
    if (remainder > 0) {
      // First `remainder` indices in stable descending-fraction order
      // (ties by index — matches np.argsort(-frac, kind='stable')).
      int idx[256];
      for (int i = 0; i < 256; ++i) idx[i] = i;
      std::stable_sort(idx, idx + 256,
                       [&](int a, int b) { return frac[a] > frac[b]; });
      for (int64_t r = 0; r < remainder && r < 256; ++r) ++f[idx[r]];
      fsum += remainder < 256 ? remainder : 256;
    }
    while (fsum > q) {
      int k = 0;
      for (int i = 1; i < 256; ++i)
        if (f[i] > f[k]) k = i;             // first-index argmax
      if (f[k] <= 1) return -1;             // cannot rebalance
      --f[k];
      --fsum;
    }
    for (int i = 0; i < 256; ++i)
      o[i] = static_cast<uint16_t>(f[i] * min_freq);
  }
  return 0;
}
