// Native host entropy decoder for rocjpeg_tpu.
//
// TPU-native equivalent of the reference's native CPU front-end: rocJPEG
// parses on the CPU (src/rocjpeg_parser.cpp) and entropy-decodes in the VCN
// ASIC; here baseline Huffman decode runs on host cores, parallelized over
// restart-interval segments (the DC predictor resets at every RSTn marker,
// making segments independent — the same property the reference forwards to
// hardware via slice_parameter_buffer.restart_interval, parser.cpp:374-390).
//
// Contract: bit-exact with the Python oracle in rocjpeg_tpu/core/entropy.py
// (same 16-bit-window LUT walk, same EXTEND semantics, natural-order int16
// output planes). Exposed as a C ABI consumed via ctypes from
// rocjpeg_tpu/runtime/native.py.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see csrc/build.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxComponents = 3;
constexpr int kMaxTables = 4;
// Byte lengths for comparing {dc_bits, dc_values, ac_bits, ac_values}
// table buffers: DC value lists hold at most 12 symbols (T.81 B.2.4.2) —
// comparing 162 would read past the 12-byte allocation.
constexpr size_t kTblCmpLen[4] = {16, 12, 16, 162};

// Natural index of the k-th zigzag coefficient (ITU-T T.81 Figure 5).
constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct DecodeLut {
  // Indexed by the next 16 scan bits: symbol + code length (0 = invalid).
  std::vector<uint8_t> sym;
  std::vector<uint8_t> len;

  int build(const uint8_t* bits, const uint8_t* values) {
    sym.assign(1u << 16, 0);
    len.assign(1u << 16, 0);
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < bits[length - 1]; ++i) {
        if (code >= (1u << length)) return -1;  // overlong code
        uint32_t lo = code << (16 - length);
        uint32_t hi = lo + (1u << (16 - length));
        std::memset(sym.data() + lo, values[k], hi - lo);
        std::memset(len.data() + lo, length, hi - lo);
        ++code;
        ++k;
      }
      code <<= 1;
    }
    return 0;
  }
};

// MSB-first bit reader over stuffed entropy data: 0xFF00 yields a literal
// 0xFF; 0xFF followed by anything else ends the segment (marker).
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;
  int bits = 0;
  long overrun = 0;  // bytes of zero padding shifted in past the end

  BitReader(const uint8_t* data, size_t n) : p(data), end(data + n) {}

  inline void refill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (p < end) {
        b = *p++;
        if (b == 0xFF) {
          if (p < end && *p == 0x00) {
            ++p;  // stuffed byte
          } else {
            // Marker: stop consuming; feed zeros (decode should be done).
            --p;
            b = 0;
            ++overrun;
          }
        }
      } else {
        ++overrun;
      }
      acc = (acc << 8) | b;
      bits += 8;
    }
  }

  inline uint32_t peek16() {
    refill();
    return (uint32_t)((acc >> (bits - 16)) & 0xFFFF);
  }

  inline void skip(int n) { bits -= n; }

  inline int32_t get_bits(int n) {
    refill();
    bits -= n;
    return (int32_t)((acc >> bits) & ((1u << n) - 1));
  }
};

inline int32_t extend(int32_t v, int s) {
  // T.81 F.2.2.1 EXTEND.
  return (v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

}  // namespace

extern "C" {

// One scan-decode job; caller (Python) fills pointers from parsed params and
// preallocated output arrays. All geometry is precomputed host-side.
struct RjtScanJob {
  const uint8_t* scan;
  long scan_len;
  int restart_interval;
  int num_components;   // components in the scan
  int interleaved;      // 0 => single-component raster (MCU = 1 block)
  int mcus_w;
  int total_mcus;
  // Per scan component:
  int h_samp[kMaxComponents];
  int v_samp[kMaxComponents];
  int dc_table[kMaxComponents];
  int ac_table[kMaxComponents];
  // Huffman table data per table id (bits: 16 entries; values: <=162):
  const uint8_t* dc_bits[kMaxTables];
  const uint8_t* dc_values[kMaxTables];
  const uint8_t* ac_bits[kMaxTables];
  const uint8_t* ac_values[kMaxTables];
  // Output planes, natural-order int16, shape (out_bh, out_bw, 64):
  int16_t* out[kMaxComponents];
  int out_bw[kMaxComponents];
  int num_threads;
};

// Error codes (mapped to Status.BAD_JPEG on the Python side).
enum {
  RJT_OK = 0,
  RJT_BAD_HUFFMAN_TABLE = 1,
  RJT_INVALID_CODE = 2,
  RJT_AC_OVERFLOW = 3,
  RJT_SCAN_EXHAUSTED = 4,
  RJT_BAD_SEGMENTS = 5,
};

namespace {

struct BlockPlanEntry {
  int comp;
  int dy;  // block row offset within MCU
  int dx;  // block col offset within MCU
  const DecodeLut* dc;
  const DecodeLut* ac;
};

// Decode MCUs [mcu_begin, mcu_end) from one entropy segment.
int decode_segment(const RjtScanJob& job,
                   const std::vector<BlockPlanEntry>& plan,
                   const uint8_t* seg, size_t seg_len, int mcu_begin,
                   int mcu_end) {
  BitReader br(seg, seg_len);
  int32_t dc_pred[kMaxComponents] = {0, 0, 0};
  for (int m = mcu_begin; m < mcu_end; ++m) {
    int my = m / job.mcus_w;
    int mx = m % job.mcus_w;
    for (const auto& pe : plan) {
      int ci = pe.comp;
      int vs = job.interleaved ? job.v_samp[ci] : 1;
      int hs = job.interleaved ? job.h_samp[ci] : 1;
      int by = my * vs + pe.dy;
      int bx = mx * hs + pe.dx;
      int16_t* out = job.out[ci] + ((long)by * job.out_bw[ci] + bx) * 64;
      std::memset(out, 0, 64 * sizeof(int16_t));

      // DC coefficient.
      uint32_t w = br.peek16();
      int s = pe.dc->sym[w];
      int length = pe.dc->len[w];
      if (length == 0) return RJT_INVALID_CODE;
      br.skip(length);
      int32_t diff = s ? extend(br.get_bits(s), s) : 0;
      dc_pred[ci] += diff;
      out[0] = (int16_t)dc_pred[ci];

      // AC coefficients.
      int k = 1;
      while (k < 64) {
        w = br.peek16();
        int rs = pe.ac->sym[w];
        length = pe.ac->len[w];
        if (length == 0) return RJT_INVALID_CODE;
        br.skip(length);
        int r = rs >> 4;
        int size = rs & 15;
        if (size == 0) {
          if (r != 15) break;  // EOB
          k += 16;             // ZRL
        } else {
          k += r;
          if (k > 63) return RJT_AC_OVERFLOW;
          out[kZigzag[k]] = (int16_t)extend(br.get_bits(size), size);
          ++k;
        }
      }
      if (br.overrun > 8) return RJT_SCAN_EXHAUSTED;
    }
  }
  return RJT_OK;
}

}  // namespace

int rjt_decode_scan(const RjtScanJob* jobp) {
  const RjtScanJob& job = *jobp;

  // Compile Huffman LUTs for the table ids used by the scan.
  DecodeLut dc_luts[kMaxTables], ac_luts[kMaxTables];
  bool built[kMaxTables] = {false, false, false, false};
  for (int c = 0; c < job.num_components; ++c) {
    for (int which = 0; which < 2; ++which) {
      int tid = which ? job.ac_table[c] : job.dc_table[c];
      if (tid < 0 || tid >= kMaxTables) return RJT_BAD_HUFFMAN_TABLE;
      if (!built[tid]) {
        if (!job.dc_bits[tid] || !job.ac_bits[tid])
          return RJT_BAD_HUFFMAN_TABLE;
        if (dc_luts[tid].build(job.dc_bits[tid], job.dc_values[tid]) ||
            ac_luts[tid].build(job.ac_bits[tid], job.ac_values[tid]))
          return RJT_BAD_HUFFMAN_TABLE;
        built[tid] = true;
      }
    }
  }

  // Block plan for one MCU.
  std::vector<BlockPlanEntry> plan;
  if (job.interleaved) {
    for (int c = 0; c < job.num_components; ++c)
      for (int v = 0; v < job.v_samp[c]; ++v)
        for (int u = 0; u < job.h_samp[c]; ++u)
          plan.push_back({c, v, u, &dc_luts[job.dc_table[c]],
                          &ac_luts[job.ac_table[c]]});
  } else {
    plan.push_back(
        {0, 0, 0, &dc_luts[job.dc_table[0]], &ac_luts[job.ac_table[0]]});
  }

  // Split the scan at RSTn markers (0xFFD0..0xFFD7). 0xFF00 is data.
  struct Seg {
    const uint8_t* p;
    size_t len;
  };
  std::vector<Seg> segs;
  {
    const uint8_t* s = job.scan;
    const uint8_t* end = s + job.scan_len;
    const uint8_t* seg_start = s;
    while (s + 1 < end) {
      if (s[0] == 0xFF && s[1] >= 0xD0 && s[1] <= 0xD7) {
        segs.push_back({seg_start, (size_t)(s - seg_start)});
        s += 2;
        seg_start = s;
      } else {
        ++s;
      }
    }
    segs.push_back({seg_start, (size_t)(end - seg_start)});
  }

  int ri = job.restart_interval > 0 ? job.restart_interval : job.total_mcus;
  int needed = ri > 0 ? (job.total_mcus + ri - 1) / ri : 1;
  if (needed <= 0) needed = 1;
  if ((int)segs.size() < needed) return RJT_BAD_SEGMENTS;

  // Decode segments in parallel; segment i covers MCUs [i*ri, min(...)).
  int nthreads = job.num_threads > 0 ? job.num_threads : 1;
  if (nthreads > needed) nthreads = needed;
  std::atomic<int> next(0);
  std::atomic<int> status(RJT_OK);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= needed || status.load() != RJT_OK) return;
      int mcu_begin = i * ri;
      int mcu_end = std::min((i + 1) * ri, job.total_mcus);
      int rc = decode_segment(job, plan, segs[i].p, segs[i].len, mcu_begin,
                              mcu_end);
      if (rc != RJT_OK) status.store(rc);
    }
  };
  if (nthreads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return status.load();
}

// ---------------------------------------------------------------------------
// Native segment packer for the on-device wave entropy decoder
// (rocjpeg_tpu/ops/device_entropy.py). Splits a scan at RSTn markers,
// removes byte stuffing, and writes each segment's bytes into the TPU-ready
// (R, n_words, 128)-uint32 transposed word matrix: lane l = r*128 + li,
// byte i of the lane lands in word i>>2 at big-endian byte position within
// the little-endian uint32 — i.e. byte offset
//   (((r*n_words + (i>>2)) * 128 + li) * 4) + (3 - (i&3)).
// ---------------------------------------------------------------------------

// Phase 1: clean (unstuffed) byte length of each restart segment.
// Returns the number of segments found; lengths beyond max_segs are counted
// but not stored. Scans with memchr: runs between 0xFF bytes are counted in
// one step (JPEG entropy data is overwhelmingly non-0xFF).
long rjt_seg_lens(const uint8_t* data, long n, int* seg_lens, long max_segs) {
  const uint8_t* s = data;
  const uint8_t* end = data + n;
  long nseg = 0;
  long cur = 0;
  while (s < end) {
    const uint8_t* ff =
        (const uint8_t*)memchr(s, 0xFF, (size_t)(end - s));
    if (!ff) {
      cur += end - s;
      break;
    }
    cur += ff - s;
    s = ff;
    if (s + 1 < end) {
      uint8_t nx = s[1];
      if (nx == 0x00) {
        ++cur;  // stuffed 0xFF
        s += 2;
        continue;
      }
      if (nx >= 0xD0 && nx <= 0xD7) {
        if (nseg < max_segs) seg_lens[nseg] = (int)cur;
        ++nseg;
        cur = 0;
        s += 2;
        continue;
      }
    }
    ++cur;  // lone/terminal 0xFF copied as data
    ++s;
  }
  if (nseg < max_segs) seg_lens[nseg] = (int)cur;
  ++nseg;
  return nseg;
}

// Variant of rjt_seg_lens that also records each segment's RAW byte offset
// within the (stuffed) scan — the entry point for ROI-selective packing:
// byte stuffing is context-free, so a packer can start at any segment's
// raw offset without touching the bytes before it (the reference decodes
// only the crop in hardware on MI300, vaapi_decoder.cpp:640-658; here the
// analog is packing only the ROI-intersecting restart segments).
long rjt_seg_offsets(const uint8_t* data, long n, int* seg_lens,
                     int64_t* seg_raw_off, long max_segs) {
  const uint8_t* s = data;
  const uint8_t* end = data + n;
  long nseg = 0;
  long cur = 0;
  const uint8_t* seg_start = data;
  while (s < end) {
    const uint8_t* ff =
        (const uint8_t*)memchr(s, 0xFF, (size_t)(end - s));
    if (!ff) {
      cur += end - s;
      break;
    }
    cur += ff - s;
    s = ff;
    if (s + 1 < end) {
      uint8_t nx = s[1];
      if (nx == 0x00) {
        ++cur;
        s += 2;
        continue;
      }
      if (nx >= 0xD0 && nx <= 0xD7) {
        if (nseg < max_segs) {
          seg_lens[nseg] = (int)cur;
          seg_raw_off[nseg] = seg_start - data;
        }
        ++nseg;
        cur = 0;
        s += 2;
        seg_start = s;
        continue;
      }
    }
    ++cur;
    ++s;
  }
  if (nseg < max_segs) {
    seg_lens[nseg] = (int)cur;
    seg_raw_off[nseg] = seg_start - data;
  }
  ++nseg;
  return nseg;
}

// Phase 2: write up to max_segs segments into the transposed word buffer,
// starting at global lane lane0. Returns segments written.
//
// Fast path: memchr finds the next 0xFF; the clean run before it is copied
// with big-endian word-composed 32-bit stores into the lane's strided
// column (word j of lane (r,li) lives at byte offset ((r*n_words+j)*128
// + li)*4 of the little-endian uint32 tensor).
long rjt_pack_rows(const uint8_t* data, long n, uint8_t* out, long lane0,
                   long n_words, long max_segs) {
  const uint8_t* s = data;
  const uint8_t* end = data + n;
  long seg = 0;
  long i = 0;  // clean byte index within current segment
  long lane = lane0;
  long r = lane >> 7, li = lane & 127;
  uint8_t* lane_base = out + ((r * n_words) * 128 + li) * 4;
  const long max_bytes = n_words * 4;

  auto emit = [&](uint8_t b) {
    if (i < max_bytes)
      lane_base[(i >> 2) * 512 + (3 - (i & 3))] = b;
    ++i;
  };
  auto emit_run = [&](const uint8_t* p, long len) {
    // Align to a word boundary of the clean index.
    while (len > 0 && (i & 3)) { emit(*p++); --len; }
    while (len >= 4 && i + 4 <= max_bytes) {
      uint32_t w = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                   ((uint32_t)p[2] << 8) | (uint32_t)p[3];
      std::memcpy(lane_base + (i >> 2) * 512, &w, 4);
      p += 4;
      i += 4;
      len -= 4;
    }
    while (len > 0) { emit(*p++); --len; }
  };
  while (s < end && seg < max_segs) {
    const uint8_t* ff =
        (const uint8_t*)memchr(s, 0xFF, (size_t)(end - s));
    if (!ff) {
      emit_run(s, end - s);
      break;
    }
    if (ff > s) emit_run(s, ff - s);
    s = ff;
    if (s + 1 < end) {
      uint8_t nx = s[1];
      if (nx == 0x00) {
        emit(0xFF);
        s += 2;
        continue;
      }
      if (nx >= 0xD0 && nx <= 0xD7) {
        ++seg;
        ++lane;
        r = lane >> 7;
        li = lane & 127;
        lane_base = out + ((r * n_words) * 128 + li) * 4;
        i = 0;
        s += 2;
        continue;
      }
    }
    emit(0xFF);
    ++s;
  }
  return seg < max_segs ? seg + 1 : seg;
}

// Dense variant of rjt_pack_rows: write up to max_segs segments into a
// DENSE big-endian word stream — segment k's bytes start at word
// word_off[k] (a precomputed exclusive prefix sum of ceil(len/4), so each
// segment is word-aligned and the stream carries no per-lane padding).
// The H2D payload this produces is the true entropy-coded size (~2x
// smaller than the lane-padded tensor, whose word count is bucketed to the
// LONGEST segment); the padded (R, n_words, 128) layout the wave kernel
// wants is reconstructed on-device by a gather (ops/device_entropy.py
// _expand_words). Returns segments written.
long rjt_pack_dense(const uint8_t* data, long n, uint8_t* out,
                    const int32_t* word_off, long max_segs) {
  const uint8_t* s = data;
  const uint8_t* end = data + n;
  long seg = 0;
  long i = 0;  // clean byte index within current segment
  uint8_t* seg_base = out + (long)word_off[0] * 4;

  auto emit = [&](uint8_t b) {
    seg_base[(i & ~3L) + (3 - (i & 3))] = b;
    ++i;
  };
  auto emit_run = [&](const uint8_t* p, long len) {
    while (len > 0 && (i & 3)) { emit(*p++); --len; }
    while (len >= 4) {
      uint32_t w = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
                   ((uint32_t)p[2] << 8) | (uint32_t)p[3];
      std::memcpy(seg_base + i, &w, 4);
      p += 4;
      i += 4;
      len -= 4;
    }
    while (len > 0) { emit(*p++); --len; }
  };
  while (s < end && seg < max_segs) {
    const uint8_t* ff =
        (const uint8_t*)memchr(s, 0xFF, (size_t)(end - s));
    if (!ff) {
      emit_run(s, end - s);
      break;
    }
    if (ff > s) emit_run(s, ff - s);
    s = ff;
    if (s + 1 < end) {
      uint8_t nx = s[1];
      if (nx == 0x00) {
        emit(0xFF);
        s += 2;
        continue;
      }
      if (nx >= 0xD0 && nx <= 0xD7) {
        ++seg;
        if (seg < max_segs) seg_base = out + (long)word_off[seg] * 4;
        i = 0;
        s += 2;
        continue;
      }
    }
    emit(0xFF);
    ++s;
  }
  return seg < max_segs ? seg + 1 : seg;
}

// ---------------------------------------------------------------------------
// Index scan: virtual restart points for DRI=0 streams.
//
// The reference's realistic corpora (data/images/mug_*.jpg) carry NO restart
// markers, so the scan is one entropy segment and the wave kernel has no
// lane parallelism to exploit. This pass manufactures it: a light LUT walk
// over the Huffman symbol stream (no coefficient output — only DC predictor
// tracking and bit-position bookkeeping) records the exact bit offset and
// DC predictor values at every `record_every`-th MCU boundary. Those records
// are "virtual RSTn markers": the TPU wave decodes the segments between them
// in parallel, and a cheap on-device fixup adds the recorded DC predictor to
// each lane's DC coefficients (DC is cumulative, so a lane decoded with
// predictor 0 is off by exactly its entry predictor).
//
// This walk is the only part of a DRI=0 decode that is inherently
// sequential; everything downstream rides the same wave path as
// restart-marked streams.
// ---------------------------------------------------------------------------

namespace {

// Fused decode LUT for the index walk, two-level. The flat 64K-entry
// sym/len pair (DecodeLut) puts an L2-latency load on the symbol-to-symbol
// dependency chain (the 16-bit window is content-random, so accesses spray
// across 128 KiB). Level 1 is 4096 x uint16 = 8 KiB — L1-resident — and
// resolves every code of length <= 12 (virtually all symbols in practice);
// the full 16-bit table only backs the rare long codes.
//
// The entry directly encodes everything the branchless walker needs:
//   bits 0..4   total bits to consume (code length + magnitude bits)
//   bits 5..11  k advance: DC = 1; AC = run+1, ZRL = 16, EOB = 64
//   bits 12..15 magnitude size (DC only — the walker tracks DC predictors)
// 0 = invalid code / resolve via level 2.
// Level-1 LUT width for the index walkers: codes with length <= RJT_L1_BITS
// resolve in one gather; longer codes fall back to the 16-bit table. The
// level-1 working set is 4 banks x (1 << RJT_L1_BITS) x 2 bytes — it must
// share the 32 KiB L1D with the 16 streaming refill windows.
#ifndef RJT_L1_BITS
#define RJT_L1_BITS 12
#endif

struct FusedIdxLut {
  std::vector<uint16_t> t12;
  std::vector<uint16_t> t16;

  int build(const uint8_t* bits, const uint8_t* values, bool is_dc) {
    t12.assign(1u << RJT_L1_BITS, 0);
    t16.assign(1u << 16, 0);
    uint32_t code = 0;
    int k = 0;
    for (int length = 1; length <= 16; ++length) {
      for (int i = 0; i < bits[length - 1]; ++i) {
        if (code >= (1u << length)) return -1;  // overlong code
        int rs = values[k];
        int run = rs >> 4, size = rs & 15;
        uint16_t ent;
        if (is_dc) {
          if (size > 11) return -1;  // DC magnitude cap (T.81 F.1.2.1.1)
          ent = (uint16_t)((length + size) | (1u << 5) | (size << 12));
        } else {
          if (size > 10) return -1;  // AC magnitude cap (T.81 F.1.2.2.1)
          int k_adv = size ? run + 1 : (run == 15 ? 16 : 64);
          ent = (uint16_t)((length + size) | (k_adv << 5));
        }
        uint32_t lo16 = code << (16 - length);
        uint32_t hi16 = lo16 + (1u << (16 - length));
        for (uint32_t w = lo16; w < hi16; ++w) t16[w] = ent;
        if (length <= RJT_L1_BITS) {
          uint32_t lo12 = code << (RJT_L1_BITS - length);
          uint32_t hi12 = lo12 + (1u << (RJT_L1_BITS - length));
          for (uint32_t w = lo12; w < hi12; ++w) t12[w] = ent;
        }
        ++code;
        ++k;
      }
      code <<= 1;
    }
    return 0;
  }
};

// Unstuff a scan into `clean` (size >= scan_len). Returns the clean length,
// or -1 if a non-stuffing marker (e.g. a real RSTn) is embedded — the index
// pass only serves DRI=0 scans, where segment structure must not appear.
long unstuff_scan(const uint8_t* data, long n, uint8_t* clean) {
  const uint8_t* s = data;
  const uint8_t* end = data + n;
  long out = 0;
  while (s < end) {
    const uint8_t* ff = (const uint8_t*)memchr(s, 0xFF, (size_t)(end - s));
    if (!ff) {
      std::memcpy(clean + out, s, end - s);
      out += end - s;
      break;
    }
    if (ff > s) {
      std::memcpy(clean + out, s, ff - s);
      out += ff - s;
    }
    s = ff;
    if (s + 1 < end) {
      uint8_t nx = s[1];
      if (nx == 0x00) {
        clean[out++] = 0xFF;
        s += 2;
        continue;
      }
      if (nx >= 0xD0 && nx <= 0xD7) return -1;  // restart marker: not ours
    }
    clean[out++] = 0xFF;  // lone/terminal 0xFF copied as data
    ++s;
  }
  // Zero the 8-byte slack the walkers' clamped refill reads past the end,
  // so callers may hand in POOLED (dirty) buffers instead of fresh zeros.
  std::memset(clean + out, 0, 8);
  return out;
}

}  // namespace


// One index-scan job. Geometry/tables mirror RjtScanJob; outputs are the
// clean stream plus per-record (MCU index, bit offset, DC predictors).
// Records are SYMBOL-BALANCED: one at MCU 0, then at the first MCU
// boundary after every >= min_symbols decoded symbols. Balanced lanes keep
// the wave kernel's VMEM tile and emission buffers bounded by the record
// interval instead of by the densest fixed-MCU window (a real photo's
// dense regions can be ~16x the average), and equalize per-lane work.
struct RjtIndexJob {
  const uint8_t* scan;
  long scan_len;
  int num_components;
  int interleaved;
  int total_mcus;
  int min_symbols;
  int h_samp[kMaxComponents];
  int v_samp[kMaxComponents];
  int dc_table[kMaxComponents];
  int ac_table[kMaxComponents];
  const uint8_t* dc_bits[kMaxTables];
  const uint8_t* dc_values[kMaxTables];
  const uint8_t* ac_bits[kMaxTables];
  const uint8_t* ac_values[kMaxTables];
  uint8_t* clean;     // out: caller-allocated, scan_len + 8 zero-slack bytes
  int64_t* bit_off;   // out: capacity n_records
  int32_t* dc_out;    // out: capacity n_records * 3 (component-major)
  int32_t* mcu_idx;   // out: capacity n_records (record r starts this MCU)
  int32_t* sym_count; // out: capacity n_records (symbols in lane r — EXACT,
                      //      so the wave sizes its emission buffers tight)
  long n_records;     // in: capacity of the record arrays
  long n_found;       // out: records written
};


namespace {

// Per-slot walk tables: [slot*2 + is_dc] raw LUT pointers (a struct
// indirection would put a data-pointer load on the critical path).
struct IdxTabs {
  std::vector<const uint16_t*> p12;  // [slot*2 + is_dc]
  std::vector<const uint16_t*> p16;
  std::vector<int> comp_of;
  int nslots = 0;
};

// Flattened walker state: ONE symbol loop, no per-block inner loop — block
// and MCU transitions are conditional moves, so the only branches left are
// the loop condition, the rare level-2 LUT fallback, and the per-MCU
// bookkeeping. (The blocked formulation pays a pipeline flush at every
// block's loop-exit mispredict, which also defeats dual-stream overlap.)
struct IdxState {
  const uint8_t* clean;
  long n;            // clean length (buffer has >= 8 bytes of zero slack)
  uint64_t acc = 0;  // top-justified bit window
  int bits = 0;
  long pos = 0;      // next byte to load
  int m = 0;         // MCUs completed
  int s = 0;         // slot within MCU
  int k = 0;         // 0 = next symbol is DC
  long syms = 0;     // symbols since the last record
  long rec = 0;
  int32_t dc_pred[kMaxComponents] = {0, 0, 0};

  inline int64_t bit_offset() const { return (int64_t)pos * 8 - bits; }
};

// Build LUTs + per-slot tables for one job. `built` tracks which table
// slots already hold compiled LUTs (pass the same arrays across jobs
// sharing LUT storage — already-built slots are reused, never rebuilt).
// LUT slot layout: [0..3] DC tables, [4..7] AC tables.
int build_idx_tabs(const RjtIndexJob& job, FusedIdxLut* luts, bool* built,
                   IdxTabs& tb) {
  for (int c = 0; c < job.num_components; ++c) {
    int dtid = job.dc_table[c], atid = job.ac_table[c];
    if (dtid < 0 || dtid >= kMaxTables || atid < 0 || atid >= kMaxTables)
      return -RJT_BAD_HUFFMAN_TABLE;
    if (!built[dtid]) {
      if (!job.dc_bits[dtid]) return -RJT_BAD_HUFFMAN_TABLE;
      if (luts[dtid].build(job.dc_bits[dtid], job.dc_values[dtid], true))
        return -RJT_BAD_HUFFMAN_TABLE;
      built[dtid] = true;
    }
    if (!built[4 + atid]) {
      if (!job.ac_bits[atid]) return -RJT_BAD_HUFFMAN_TABLE;
      if (luts[4 + atid].build(job.ac_bits[atid], job.ac_values[atid],
                               false))
        return -RJT_BAD_HUFFMAN_TABLE;
      built[4 + atid] = true;
    }
  }
  auto add_slot = [&](int c) {
    tb.p12.push_back(luts[4 + job.ac_table[c]].t12.data());  // is_dc = 0
    tb.p12.push_back(luts[job.dc_table[c]].t12.data());      // is_dc = 1
    tb.p16.push_back(luts[4 + job.ac_table[c]].t16.data());
    tb.p16.push_back(luts[job.dc_table[c]].t16.data());
    tb.comp_of.push_back(c);
  };
  if (job.interleaved) {
    for (int c = 0; c < job.num_components; ++c) {
      int nb = job.v_samp[c] * job.h_samp[c];
      for (int b = 0; b < nb; ++b) add_slot(c);
    }
  } else {
    add_slot(0);
  }
  tb.nslots = (int)tb.comp_of.size();
  return 0;
}

inline int idx_record(IdxState& st, const RjtIndexJob& job) {
  if (st.rec >= job.n_records) return -RJT_BAD_SEGMENTS;
  if (st.rec > 0) job.sym_count[st.rec - 1] = (int32_t)st.syms;
  job.bit_off[st.rec] = st.bit_offset();
  job.mcu_idx[st.rec] = st.m;
  job.dc_out[st.rec * 3 + 0] = st.dc_pred[0];
  job.dc_out[st.rec * 3 + 1] = st.dc_pred[1];
  job.dc_out[st.rec * 3 + 2] = st.dc_pred[2];
  ++st.rec;
  st.syms = 0;
  return 0;
}

// One symbol, branchless. Returns -err, 0, or 1 (finished an MCU).
inline int idx_step(IdxState& st, const uint16_t* const* p12,
                    const uint16_t* const* p16, const int* comp_of,
                    int nslots) {
  // Branchless refill: the load runs every step (address depends only on
  // the previous step, so it issues early); the OR is predicated by cmov.
  uint32_t wl;
  long rp = st.pos < st.n ? st.pos : st.n;  // clamp into the zero slack
  std::memcpy(&wl, st.clean + rp, 4);
  wl = __builtin_bswap32(wl);
  bool need = st.bits <= 32;
  uint64_t add = (uint64_t)wl << ((32 - st.bits) & 63);
  st.acc |= need ? add : 0ull;
  st.bits += (int)need << 5;
  st.pos += (long)need << 2;

  bool is_dc = (st.k == 0);
  int tsel = st.s * 2 + (int)is_dc;
  uint32_t w16 = (uint32_t)(st.acc >> 48);
  uint32_t ent = p12[tsel][w16 >> (16 - RJT_L1_BITS)];
  if (__builtin_expect(ent == 0, 0)) {
    ent = p16[tsel][w16];
    if (ent == 0) return -RJT_INVALID_CODE;
  }
  uint32_t skip = ent & 31;
  uint32_t adv = (ent >> 5) & 127;
  uint32_t size = ent >> 12;

  // DC predictor update (the magnitude bits are the LAST `size` bits of
  // the skip window; AC entries carry size 0, so e collapses to 0).
  uint32_t w32 = (uint32_t)(st.acc >> 32);
  uint32_t mag = (w32 >> (32 - skip)) & ((1u << size) - 1);
  int32_t half = (int32_t)((1u << size) >> 1);
  int32_t e = (int32_t)mag -
              (((int32_t)mag < half) ? (int32_t)((1u << size) - 1) : 0);
  int c = comp_of[st.s];
  st.dc_pred[c] += is_dc ? e : 0;

  st.acc <<= skip;
  st.bits -= (int)skip;
  st.k += (int)adv;
  bool bd = st.k >= 64;
  st.k = bd ? 0 : st.k;
  st.s += (int)bd;
  bool md = st.s >= nslots;
  st.s = md ? 0 : st.s;
  st.m += (int)md;
  ++st.syms;
  return (int)md;
}

}  // namespace

// Returns the clean byte length (>= 0) on success, or -errcode.
long rjt_index_scan(RjtIndexJob* jobp) {
  const RjtIndexJob& job = *jobp;

  FusedIdxLut luts[2 * kMaxTables];
  bool built[2 * kMaxTables] = {};
  IdxTabs tb;
  int rc = build_idx_tabs(job, luts, built, tb);
  if (rc) return rc;

  long clean_len = unstuff_scan(job.scan, job.scan_len, job.clean);
  if (clean_len < 0) return -RJT_BAD_SEGMENTS;

  IdxState st;
  st.clean = job.clean;
  st.n = clean_len;
  const int64_t bit_limit = (int64_t)clean_len * 8 + 56;
  const long S = job.min_symbols > 0 ? job.min_symbols : (1L << 60);
  const uint16_t* const* p12 = tb.p12.data();
  const uint16_t* const* p16 = tb.p16.data();
  const int* comp_of = tb.comp_of.data();
  const int nslots = tb.nslots;

  if ((rc = idx_record(st, job))) return rc;  // record at MCU 0
  while (st.m < job.total_mcus) {
    int r = idx_step(st, p12, p16, comp_of, nslots);
    if (__builtin_expect(r < 0, 0)) return r;
    if (r) {  // finished an MCU: bounds + record bookkeeping
      if (st.bit_offset() > bit_limit) return -RJT_SCAN_EXHAUSTED;
      if (st.syms >= S && st.m < job.total_mcus) {
        if ((rc = idx_record(st, job))) return rc;
      }
    }
  }
  if (st.rec > 0) job.sym_count[st.rec - 1] = (int32_t)st.syms;
  jobp->n_found = st.rec;
  return clean_len;
}

// Dual-stream index scan: walks TWO same-geometry jobs symbol-interleaved
// in one call, so the out-of-order core overlaps the two independent
// symbol-dependency chains (the single-stream walk is latency-bound on its
// peek -> LUT -> shift chain, not on execution throughput — and the
// flattened walker has no per-block mispredict flush to serialize them).
// Jobs grouped by Huffman digest share one L1-resident LUT set.
// Returns 0 on success (clean lengths via *clean_len_a/b), or -err.
long rjt_index_scan2(RjtIndexJob* ja, RjtIndexJob* jb,
                     long* clean_len_a, long* clean_len_b) {
  const RjtIndexJob& a = *ja;
  const RjtIndexJob& b = *jb;
  if (a.total_mcus != b.total_mcus || a.min_symbols != b.min_symbols ||
      a.interleaved != b.interleaved)
    return -RJT_BAD_SEGMENTS;

  // Share one LUT set when both jobs carry identical Huffman tables (the
  // caller groups streams by table digest, so this is the common case) —
  // two independent t12 sets would crowd the 48 KiB L1.
  bool shared = true;
  for (int t = 0; t < kMaxTables && shared; ++t) {
    const uint8_t* pa[4] = {a.dc_bits[t], a.dc_values[t], a.ac_bits[t],
                            a.ac_values[t]};
    const uint8_t* pb[4] = {b.dc_bits[t], b.dc_values[t], b.ac_bits[t],
                            b.ac_values[t]};
    for (int j = 0; j < 4 && shared; ++j) {
      if ((pa[j] == nullptr) != (pb[j] == nullptr)) shared = false;
      else if (pa[j] && pa[j] != pb[j] &&
               std::memcmp(pa[j], pb[j], kTblCmpLen[j]) != 0)
        shared = false;
    }
  }

  FusedIdxLut luts_a[2 * kMaxTables], luts_b[2 * kMaxTables];
  bool built_a[2 * kMaxTables] = {}, built_b[2 * kMaxTables] = {};
  IdxTabs ta, tbb;
  int rc = build_idx_tabs(a, luts_a, built_a, ta);
  if (rc) return rc;
  rc = shared ? build_idx_tabs(b, luts_a, built_a, tbb)
              : build_idx_tabs(b, luts_b, built_b, tbb);
  if (rc) return rc;
  if (ta.nslots != tbb.nslots) return -RJT_BAD_SEGMENTS;

  long ca = unstuff_scan(a.scan, a.scan_len, a.clean);
  long cb = unstuff_scan(b.scan, b.scan_len, b.clean);
  if (ca < 0 || cb < 0) return -RJT_BAD_SEGMENTS;

  IdxState sa, sb;
  sa.clean = a.clean;
  sa.n = ca;
  sb.clean = b.clean;
  sb.n = cb;
  const int64_t lim_a = (int64_t)ca * 8 + 56;
  const int64_t lim_b = (int64_t)cb * 8 + 56;
  const long S = a.min_symbols > 0 ? a.min_symbols : (1L << 60);
  const int total = a.total_mcus;
  const int nslots = ta.nslots;
  const uint16_t* const* pa12 = ta.p12.data();
  const uint16_t* const* pa16 = ta.p16.data();
  const int* ca_of = ta.comp_of.data();
  const uint16_t* const* pb12 = tbb.p12.data();
  const uint16_t* const* pb16 = tbb.p16.data();
  const int* cb_of = tbb.comp_of.data();

  if ((rc = idx_record(sa, a)) || (rc = idx_record(sb, b))) return rc;

  // Main interleaved loop: both streams advance one symbol per iteration;
  // the two chains share no state, so they retire in parallel.
  while (sa.m < total && sb.m < total) {
    int r1 = idx_step(sa, pa12, pa16, ca_of, nslots);
    int r2 = idx_step(sb, pb12, pb16, cb_of, nslots);
    if (__builtin_expect((r1 | r2) < 0, 0)) return r1 < 0 ? r1 : r2;
    if (r1) {
      if (sa.bit_offset() > lim_a) return -RJT_SCAN_EXHAUSTED;
      if (sa.syms >= S && sa.m < total && (rc = idx_record(sa, a)))
        return rc;
    }
    if (r2) {
      if (sb.bit_offset() > lim_b) return -RJT_SCAN_EXHAUSTED;
      if (sb.syms >= S && sb.m < total && (rc = idx_record(sb, b)))
        return rc;
    }
  }
  // Drain whichever stream still has MCUs left.
  for (IdxState* st : {&sa, &sb}) {
    const bool isa = (st == &sa);
    const RjtIndexJob& j = isa ? a : b;
    const int64_t lim = isa ? lim_a : lim_b;
    const uint16_t* const* q12 = isa ? pa12 : pb12;
    const uint16_t* const* q16 = isa ? pa16 : pb16;
    const int* q_of = isa ? ca_of : cb_of;
    while (st->m < total) {
      int r = idx_step(*st, q12, q16, q_of, nslots);
      if (r < 0) return r;
      if (r) {
        if (st->bit_offset() > lim) return -RJT_SCAN_EXHAUSTED;
        if (st->syms >= S && st->m < total && (rc = idx_record(*st, j)))
          return rc;
      }
    }
  }
  if (sa.rec > 0) a.sym_count[sa.rec - 1] = (int32_t)sa.syms;
  if (sb.rec > 0) b.sym_count[sb.rec - 1] = (int32_t)sb.syms;
  ja->n_found = sa.rec;
  jb->n_found = sb.rec;
  *clean_len_a = ca;
  *clean_len_b = cb;
  return 0;
}

// ---------------------------------------------------------------------------
// AVX2 8-stream index walk — the wave kernel's design brought to the host.
//
// The scalar walk is latency-bound on its peek -> LUT -> shift chain
// (~15 cycles/symbol); the dual-stream interleave only recovers ~1.1x
// because two chains still share one load port's latency. This walker runs
// EIGHT same-geometry streams in SIMD lanes: every per-symbol operation is
// one 8-lane vector op, and the chain's LUT load becomes one VPGATHERDD
// whose latency is paid once per eight symbols. Streams at different block
// phases never branch — DC/AC/EOB/block/MCU transitions are masked blends,
// exactly like the TPU wave's lane transitions. Rare events (records,
// level-2 LUT fallback, lane completion) drop to scalar per-lane fixups.
// ---------------------------------------------------------------------------

#if defined(__x86_64__)
#include <immintrin.h>

#pragma GCC push_options
#pragma GCC target("avx2")

namespace {

struct IdxBanks {
  // Fused LUT banks, contiguous for gathers: bank b level-1 at
  // t12[b << RJT_L1_BITS], level-2 at t16[b*65536]. sel[slot*2+is_dc]=bank.
  std::vector<uint16_t> t12;
  std::vector<uint16_t> t16;
  std::vector<int32_t> sel;
  std::vector<int32_t> comp_of;
  int nslots = 0;

  int build(const RjtIndexJob& job) {
    struct Key {
      bool is_dc;
      int tid;
    };
    std::vector<Key> banks;
    auto bank_of = [&](bool is_dc, int tid) {
      for (size_t i = 0; i < banks.size(); ++i)
        if (banks[i].is_dc == is_dc && banks[i].tid == tid) return (int)i;
      banks.push_back({is_dc, tid});
      return (int)banks.size() - 1;
    };
    auto add_slot = [&](int c) {
      sel.push_back(bank_of(false, job.ac_table[c]));  // is_dc = 0
      sel.push_back(bank_of(true, job.dc_table[c]));   // is_dc = 1
      comp_of.push_back(c);
    };
    if (job.interleaved) {
      for (int c = 0; c < job.num_components; ++c) {
        int nb = job.v_samp[c] * job.h_samp[c];
        for (int b = 0; b < nb; ++b) add_slot(c);
      }
    } else {
      add_slot(0);
    }
    nslots = (int)comp_of.size();

    t12.assign((banks.size() << RJT_L1_BITS) + 4, 0);  // +4: 64-bit gather
    t16.assign(banks.size() * 65536 + 2, 0);
    FusedIdxLut lut;
    for (size_t b = 0; b < banks.size(); ++b) {
      int tid = banks[b].tid;
      if (tid < 0 || tid >= kMaxTables) return -RJT_BAD_HUFFMAN_TABLE;
      const uint8_t* bits =
          banks[b].is_dc ? job.dc_bits[tid] : job.ac_bits[tid];
      const uint8_t* vals =
          banks[b].is_dc ? job.dc_values[tid] : job.ac_values[tid];
      if (!bits) return -RJT_BAD_HUFFMAN_TABLE;
      if (lut.build(bits, vals, banks[b].is_dc))
        return -RJT_BAD_HUFFMAN_TABLE;
      std::memcpy(t12.data() + (b << RJT_L1_BITS), lut.t12.data(),
                  (size_t)2 << RJT_L1_BITS);
      std::memcpy(t16.data() + b * 65536, lut.t16.data(), 65536 * 2);
    }
    return 0;
  }
};

// Per-lane scalar view of the SIMD state (for rare-event fixups).
struct Lane8 {
  RjtIndexJob* job;
  const uint8_t* base;
  long clean_len;
  long rec = 0;
  bool done = false;
};

inline __m256i min_epu64(__m256i a, __m256i b) {
  // Addresses are < 2^63, so a signed compare is fine.
  __m256i gt = _mm256_cmpgt_epi64(a, b);
  return _mm256_blendv_epi8(a, b, gt);
}

// One iteration decodes one symbol in each of 8 lanes.
// State vectors: acc (2 x 4 u64, top-justified), bits/k/s/m/syms (8 x i32),
// pos (2 x 4 u64 ABSOLUTE addresses), dc[3] (8 x i32), active (8 x i32).
long idx_walk8(RjtIndexJob** jobs, const IdxBanks& tb,
               long* clean_lens_out) {
  const int total = jobs[0]->total_mcus;
  const long S = jobs[0]->min_symbols > 0 ? jobs[0]->min_symbols : (1L << 60);
  const int nslots = tb.nslots;

  Lane8 lanes[8];
  alignas(32) int64_t base_a[8], end_a[8];
  long clean_lens[8];
  for (int l = 0; l < 8; ++l) {
    RjtIndexJob& j = *jobs[l];
    long cl = unstuff_scan(j.scan, j.scan_len, j.clean);
    if (cl < 0) return -RJT_BAD_SEGMENTS;
    clean_lens[l] = cl;
    clean_lens_out[l] = cl;
    lanes[l] = Lane8{&j, j.clean, cl, 0, false};
    base_a[l] = (int64_t)(uintptr_t)j.clean;
    end_a[l] = base_a[l] + cl;  // clamp target; buffer has 8B zero slack
    // Record at MCU 0.
    j.bit_off[0] = 0;
    j.mcu_idx[0] = 0;
    j.dc_out[0] = j.dc_out[1] = j.dc_out[2] = 0;
    lanes[l].rec = 1;
  }

  __m256i acc_lo = _mm256_setzero_si256();   // lanes 0..3
  __m256i acc_hi = _mm256_setzero_si256();   // lanes 4..7
  __m256i pos_lo = _mm256_load_si256((const __m256i*)base_a);
  __m256i pos_hi = _mm256_load_si256((const __m256i*)(base_a + 4));
  const __m256i end_lo = _mm256_load_si256((const __m256i*)end_a);
  const __m256i end_hi = _mm256_load_si256((const __m256i*)(end_a + 4));
  __m256i bits = _mm256_setzero_si256();
  __m256i k = _mm256_setzero_si256();
  __m256i s = _mm256_setzero_si256();
  __m256i m = _mm256_setzero_si256();
  __m256i syms = _mm256_setzero_si256();
  __m256i dc[3] = {_mm256_setzero_si256(), _mm256_setzero_si256(),
                   _mm256_setzero_si256()};
  __m256i active = _mm256_set1_epi32(-1);

  const __m256i c32 = _mm256_set1_epi32(32);
  const __m256i c63 = _mm256_set1_epi32(63);
  const __m256i c1 = _mm256_set1_epi32(1);
  const __m256i vtotal = _mm256_set1_epi32(total);
  const __m256i vnslots = _mm256_set1_epi32(nslots);
  // bswap32 shuffle (within each 128-bit half).
  const __m256i bsw = _mm256_setr_epi8(
      3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12,
      3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12);

  // Register-resident sel/comp tables for the common nslots <= 8 case
  // (every standard subsampling: 420 has 6 slots, 411 6, 444 3, 400 1):
  // two VPERMD + a blend replace the per-symbol sel gather, one VPERMD
  // the comp gather. Exotic streams with more slots keep the gathers.
  const bool use_perm = nslots <= 8;
  alignas(32) int32_t sel_a[16] = {0};
  alignas(32) int32_t comp_a[8] = {0};
  if (use_perm) {
    for (size_t i = 0; i < tb.sel.size() && i < 16; ++i) sel_a[i] = tb.sel[i];
    for (int i = 0; i < nslots; ++i) comp_a[i] = tb.comp_of[i];
  }
  const __m256i sel_lo = _mm256_load_si256((const __m256i*)sel_a);
  const __m256i sel_hi = _mm256_load_si256((const __m256i*)(sel_a + 8));
  const __m256i comp_tbl = _mm256_load_si256((const __m256i*)comp_a);
  const __m256i c7 = _mm256_set1_epi32(7);

  auto widen_lo = [](__m256i v32) {  // lanes 0..3 of 8 x i32 -> 4 x i64
    return _mm256_cvtepi32_epi64(_mm256_castsi256_si128(v32));
  };
  auto widen_hi = [](__m256i v32) {
    return _mm256_cvtepi32_epi64(_mm256_extracti128_si256(v32, 1));
  };
  // ZERO-extending widen: the refill word must not drag sign bits into
  // acc's valid region when shifted by < 32.
  auto widenu_lo = [](__m256i v32) {
    return _mm256_cvtepu32_epi64(_mm256_castsi256_si128(v32));
  };
  auto widenu_hi = [](__m256i v32) {
    return _mm256_cvtepu32_epi64(_mm256_extracti128_si256(v32, 1));
  };
  auto narrow = [](__m256i lo64, __m256i hi64) {
    // take low 32 bits of each 64-bit lane -> 8 x i32
    __m256i lo = _mm256_shuffle_epi32(lo64, 0x08);  // [0,2,-,-] per half
    __m256i hi = _mm256_shuffle_epi32(hi64, 0x08);
    __m256i a = _mm256_permute4x64_epi64(lo, 0x08);  // compact to low 128
    __m256i b = _mm256_permute4x64_epi64(hi, 0x08);
    return _mm256_inserti128_si256(a, _mm256_castsi256_si128(b), 1);
  };

  int iter_since_check = 0;
  for (;;) {
    int live = _mm256_movemask_ps(_mm256_castsi256_ps(active));
    if (!live) break;

    // ---- branchless refill: one 32-bit gather per half (absolute
    // addresses, clamped into each stream's zero slack). ----
    __m256i need = _mm256_cmpgt_epi32(_mm256_set1_epi32(33), bits);
    need = _mm256_and_si256(need, active);
    __m256i rp_lo = min_epu64(pos_lo, end_lo);
    __m256i rp_hi = min_epu64(pos_hi, end_hi);
    __m128i wlo = _mm256_i64gather_epi32((const int*)0, rp_lo, 1);
    __m128i whi = _mm256_i64gather_epi32((const int*)0, rp_hi, 1);
    __m256i w = _mm256_inserti128_si256(_mm256_castsi128_si256(wlo), whi, 1);
    w = _mm256_shuffle_epi8(w, bsw);
    // add = (u64)w << (32 - bits)
    __m256i sh32 = _mm256_and_si256(_mm256_sub_epi32(c32, bits), c63);
    __m256i add_lo = _mm256_sllv_epi64(widenu_lo(w), widen_lo(sh32));
    __m256i add_hi = _mm256_sllv_epi64(widenu_hi(w), widen_hi(sh32));
    __m256i need_lo = widen_lo(need);
    need_lo = _mm256_or_si256(need_lo, _mm256_slli_epi64(need_lo, 32));
    __m256i need_hi = widen_hi(need);
    need_hi = _mm256_or_si256(need_hi, _mm256_slli_epi64(need_hi, 32));
    acc_lo = _mm256_or_si256(acc_lo, _mm256_and_si256(add_lo, need_lo));
    acc_hi = _mm256_or_si256(acc_hi, _mm256_and_si256(add_hi, need_hi));
    bits = _mm256_add_epi32(bits, _mm256_and_si256(need, c32));
    pos_lo = _mm256_add_epi64(
        pos_lo, _mm256_and_si256(need_lo, _mm256_set1_epi64x(4)));
    pos_hi = _mm256_add_epi64(
        pos_hi, _mm256_and_si256(need_hi, _mm256_set1_epi64x(4)));

    // ---- peek16 + fused LUT gather ----
    __m256i w16 = narrow(_mm256_srli_epi64(acc_lo, 48),
                         _mm256_srli_epi64(acc_hi, 48));
    __m256i is_dc = _mm256_cmpeq_epi32(k, _mm256_setzero_si256());
    __m256i selidx = _mm256_sub_epi32(
        _mm256_add_epi32(s, s), is_dc);  // s*2 + (k==0 ? 1 : 0)
    __m256i bank;
    if (use_perm) {
      __m256i lo = _mm256_permutevar8x32_epi32(sel_lo, selidx);
      __m256i hi = _mm256_permutevar8x32_epi32(sel_hi, selidx);
      bank = _mm256_blendv_epi8(lo, hi, _mm256_cmpgt_epi32(selidx, c7));
    } else {
      bank = _mm256_i32gather_epi32(tb.sel.data(), selidx, 4);
    }
    __m256i entidx = _mm256_add_epi32(
        _mm256_slli_epi32(bank, RJT_L1_BITS),
        _mm256_srli_epi32(w16, 16 - RJT_L1_BITS));
    __m256i ent = _mm256_i32gather_epi32((const int*)tb.t12.data(),
                                         entidx, 2);
    ent = _mm256_and_si256(ent, _mm256_set1_epi32(0xFFFF));

    // Level-2 fallback / invalid code: rare -> scalar per lane.
    __m256i miss =
        _mm256_and_si256(_mm256_cmpeq_epi32(ent, _mm256_setzero_si256()),
                         active);
    int missbits = _mm256_movemask_ps(_mm256_castsi256_ps(miss));
    if (__builtin_expect(missbits, 0)) {
      alignas(32) int32_t w16_a[8], bank_a[8], ent_a[8];
      _mm256_store_si256((__m256i*)w16_a, w16);
      _mm256_store_si256((__m256i*)bank_a, bank);
      _mm256_store_si256((__m256i*)ent_a, ent);
      for (int l = 0; l < 8; ++l) {
        if (!(missbits & (1 << l))) continue;
        uint32_t e2 = tb.t16[(size_t)bank_a[l] * 65536 + (uint32_t)w16_a[l]];
        if (e2 == 0) return -RJT_INVALID_CODE;
        ent_a[l] = (int32_t)e2;
      }
      ent = _mm256_load_si256((const __m256i*)ent_a);
    }

    __m256i skip = _mm256_and_si256(ent, _mm256_set1_epi32(31));
    __m256i adv = _mm256_and_si256(_mm256_srli_epi32(ent, 5),
                                   _mm256_set1_epi32(127));
    __m256i size = _mm256_srli_epi32(ent, 12);
    skip = _mm256_and_si256(skip, active);
    adv = _mm256_and_si256(adv, active);

    // ---- DC predictor update (masked; AC lanes have size == 0) ----
    __m256i w32 = narrow(_mm256_srli_epi64(acc_lo, 32),
                         _mm256_srli_epi64(acc_hi, 32));
    __m256i mag = _mm256_srlv_epi32(w32, _mm256_sub_epi32(c32, skip));
    __m256i szmask = _mm256_sub_epi32(
        _mm256_sllv_epi32(c1, size), c1);       // (1<<size)-1
    mag = _mm256_and_si256(mag, szmask);
    __m256i half = _mm256_srli_epi32(_mm256_add_epi32(szmask, c1), 1);
    __m256i neg = _mm256_cmpgt_epi32(half, mag);  // mag < half
    __m256i e = _mm256_sub_epi32(mag, _mm256_and_si256(neg, szmask));
    e = _mm256_and_si256(_mm256_and_si256(e, is_dc), active);
    __m256i comp = use_perm
        ? _mm256_permutevar8x32_epi32(comp_tbl, s)
        : _mm256_i32gather_epi32(tb.comp_of.data(), s, 4);
    for (int c = 0; c < 3; ++c) {
      __m256i cm = _mm256_cmpeq_epi32(comp, _mm256_set1_epi32(c));
      dc[c] = _mm256_add_epi32(dc[c], _mm256_and_si256(e, cm));
    }

    // ---- consume bits ----
    acc_lo = _mm256_sllv_epi64(acc_lo, widen_lo(skip));
    acc_hi = _mm256_sllv_epi64(acc_hi, widen_hi(skip));
    bits = _mm256_sub_epi32(bits, skip);

    // ---- state transitions (all masked blends) ----
    __m256i kn = _mm256_add_epi32(k, adv);
    __m256i bd = _mm256_cmpgt_epi32(kn, c63);  // k >= 64
    k = _mm256_andnot_si256(bd, kn);
    s = _mm256_add_epi32(s, _mm256_and_si256(bd, c1));
    __m256i md = _mm256_cmpgt_epi32(s, _mm256_sub_epi32(vnslots, c1));
    s = _mm256_andnot_si256(md, s);
    m = _mm256_add_epi32(m, _mm256_and_si256(md, c1));
    syms = _mm256_add_epi32(syms, _mm256_and_si256(active, c1));

    // ---- rare events: record / completion / bounds (scalar per lane) ----
    __m256i fin = _mm256_and_si256(
        md, _mm256_cmpgt_epi32(_mm256_add_epi32(m, c1), vtotal));  // m>=total
    __m256i want_rec = _mm256_and_si256(
        md, _mm256_cmpgt_epi32(_mm256_add_epi32(syms, c1),
                               _mm256_set1_epi32((int)std::min(
                                   S, (long)INT32_MAX))));  // syms >= S
    __m256i event = _mm256_and_si256(_mm256_or_si256(fin, want_rec), active);
    int evbits = _mm256_movemask_ps(_mm256_castsi256_ps(event));
    if (__builtin_expect(evbits || ++iter_since_check >= 4096, 0)) {
      iter_since_check = 0;
      alignas(32) int32_t m_a[8], syms_a[8], bits_a[8], dc_a[3][8];
      alignas(32) int64_t pos_a[8];
      _mm256_store_si256((__m256i*)m_a, m);
      _mm256_store_si256((__m256i*)syms_a, syms);
      _mm256_store_si256((__m256i*)bits_a, bits);
      for (int c = 0; c < 3; ++c)
        _mm256_store_si256((__m256i*)dc_a[c], dc[c]);
      _mm256_store_si256((__m256i*)pos_a, pos_lo);
      _mm256_store_si256((__m256i*)(pos_a + 4), pos_hi);
      bool any_change = false;
      alignas(32) int32_t syms_new[8];
      _mm256_store_si256((__m256i*)syms_new, syms);
      int deact = 0;
      for (int l = 0; l < 8; ++l) {
        if (lanes[l].done) continue;
        int64_t bit_off = (pos_a[l] - base_a[l]) * 8 - bits_a[l];
        if (bit_off > clean_lens[l] * 8 + 56) return -RJT_SCAN_EXHAUSTED;
        if (m_a[l] >= total) {
          RjtIndexJob& j = *lanes[l].job;
          j.sym_count[lanes[l].rec - 1] = syms_a[l];
          j.n_found = lanes[l].rec;
          lanes[l].done = true;
          deact |= 1 << l;
          any_change = true;
        } else if ((evbits & (1 << l)) && syms_a[l] >= S) {
          RjtIndexJob& j = *lanes[l].job;
          if (lanes[l].rec >= j.n_records) return -RJT_BAD_SEGMENTS;
          j.sym_count[lanes[l].rec - 1] = syms_a[l];
          j.bit_off[lanes[l].rec] = bit_off;
          j.mcu_idx[lanes[l].rec] = m_a[l];
          j.dc_out[lanes[l].rec * 3 + 0] = dc_a[0][l];
          j.dc_out[lanes[l].rec * 3 + 1] = dc_a[1][l];
          j.dc_out[lanes[l].rec * 3 + 2] = dc_a[2][l];
          ++lanes[l].rec;
          syms_new[l] = 0;
          any_change = true;
        }
      }
      if (any_change) {
        syms = _mm256_load_si256((const __m256i*)syms_new);
        if (deact) {
          alignas(32) int32_t act_a[8];
          _mm256_store_si256((__m256i*)act_a, active);
          for (int l = 0; l < 8; ++l)
            if (deact & (1 << l)) act_a[l] = 0;
          active = _mm256_load_si256((const __m256i*)act_a);
        }
      }
    }
  }
  return 0;
}

}  // namespace

#pragma GCC pop_options

// ---------------------------------------------------------------------------
// AVX-512 16-stream index walk — the same design at twice the lane count.
//
// The 8-stream walker's inner loop is gather-latency/throughput bound (five
// gathers serve eight lanes); the 512-bit version serves SIXTEEN lanes with
// six gathers (2 refill halves + sel + t12; comp_of becomes a register-
// resident VPERMD since T.81 caps sum(h*v) at 10 slots), and every masked
// blend becomes a mask-register op. Same rare-event scalar fixups.
// ---------------------------------------------------------------------------

#pragma GCC push_options
#pragma GCC target("avx512f,avx512bw,avx512dq,avx512vl,avx2")

namespace {

struct Lane16 {
  RjtIndexJob* job;
  long rec = 0;
  bool done = false;
};

// Read-only per-call tables/constants shared by every group of 16 lanes.
struct W16Shared {
  const uint16_t* t12;
  const uint16_t* t16;
  __m512i comp_tbl, sel_lo, sel_hi;
  __m512i vtotal, vnslots1, vS;
  __m512i zero, c1, c32, c63, bsw;
  int total;
  long S;

  void init(const IdxBanks& tb, int total_, long S_) {
    t12 = tb.t12.data();
    t16 = tb.t16.data();
    total = total_;
    S = S_;
    zero = _mm512_setzero_si512();
    c1 = _mm512_set1_epi32(1);
    c32 = _mm512_set1_epi32(32);
    c63 = _mm512_set1_epi32(63);
    vtotal = _mm512_set1_epi32(total_);
    vnslots1 = _mm512_set1_epi32(tb.nslots - 1);
    vS = _mm512_set1_epi32((int)std::min(S_, (long)INT32_MAX));
    bsw = _mm512_broadcast_i32x4(
        _mm_setr_epi8(3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8, 15, 14, 13, 12));
    // comp_of fits one register (T.81: sum of h*v sampling factors <= 10).
    alignas(64) int32_t comp_tbl_a[16] = {0};
    for (int i = 0; i < tb.nslots && i < 16; ++i)
      comp_tbl_a[i] = tb.comp_of[i];
    comp_tbl = _mm512_load_si512((const void*)comp_tbl_a);
    // sel (bank per slot*2+is_dc, <= 32 entries for nslots <= 16) lives in
    // two registers: a VPERMT2D replaces a 16-lane gather per symbol.
    alignas(64) int32_t sel_tbl_a[32] = {0};
    for (size_t i = 0; i < tb.sel.size() && i < 32; ++i)
      sel_tbl_a[i] = tb.sel[i];
    sel_lo = _mm512_load_si512((const void*)sel_tbl_a);
    sel_hi = _mm512_load_si512((const void*)(sel_tbl_a + 16));
  }
};

// One SIMD group: 16 streams walked in lockstep. The hot state lives in
// __m512i members that GCC registerizes when the group is a local whose
// address never escapes (step() and the event block are fully inlined).
//
// Stream positions are u32 OFFSETS from one shared base pointer (init
// verifies every clean buffer lands within 4 GiB of the lowest — true for
// any one allocator arena; callers fall back to the pair walker when not):
// one 16-lane VPGATHERDD serves the refill instead of two 8-lane VPGATHERQD
// plus an insert, and pos/end take one register each instead of two.
struct W16Group {
  __m512i acc_lo, acc_hi;        // u64 top-justified bit windows
  __m512i spos;                  // u32 offset (from base) of the word in
                                 // `stage` = next word to append to acc
  __m512i end;                   // u32 clamp (8B zero slack beyond)
  __m512i stage;                 // pre-gathered (bswapped) word at spos:
                                 // loaded one iteration AHEAD so the
                                 // gather latency sits off the acc chain
  __m512i bits, k, s, m, syms;
  __m512i dc[3];
  __mmask16 active;
  const uint8_t* base;
  Lane16 lanes[16];
  alignas(64) uint32_t base_a[16];
  long clean_lens[16];
  int iter_since_check;

  int init(RjtIndexJob** jobs, long* clean_lens_out) {
    alignas(64) uint32_t end_a[16];
    const uint8_t* lo = jobs[0]->clean;
    for (int l = 1; l < 16; ++l)
      if (jobs[l]->clean < lo) lo = jobs[l]->clean;
    base = lo;
    for (int l = 0; l < 16; ++l) {
      RjtIndexJob& j = *jobs[l];
      long cl = unstuff_scan(j.scan, j.scan_len, j.clean);
      if (cl < 0) return -RJT_BAD_SEGMENTS;
      // u32 offsets must reach the buffer end plus the 4-byte slack load.
      if ((uintptr_t)(j.clean - base) + cl + 8 > 0xFFFFFFFFull)
        return -RJT_BAD_SEGMENTS;  // callers fall back to the pair walker
      clean_lens[l] = cl;
      clean_lens_out[l] = cl;
      lanes[l] = Lane16{&j, 1, false};
      base_a[l] = (uint32_t)(j.clean - base);
      end_a[l] = base_a[l] + (uint32_t)cl;
      j.bit_off[0] = 0;
      j.mcu_idx[0] = 0;
      j.dc_out[0] = j.dc_out[1] = j.dc_out[2] = 0;
    }
    acc_lo = acc_hi = _mm512_setzero_si512();
    spos = _mm512_load_si512((const void*)base_a);
    end = _mm512_load_si512((const void*)end_a);
    const __m512i bsw = _mm512_broadcast_i32x4(
        _mm_setr_epi8(3, 2, 1, 0, 7, 6, 5, 4, 11, 10, 9, 8,
                      15, 14, 13, 12));
    stage = _mm512_shuffle_epi8(
        _mm512_i32gather_epi32(_mm512_min_epu32(spos, end), base, 1), bsw);
    bits = k = s = m = syms = _mm512_setzero_si512();
    dc[0] = dc[1] = dc[2] = _mm512_setzero_si512();
    active = 0xFFFF;
    iter_since_check = 0;
    return 0;
  }

  // One symbol in each active lane. Returns 0, or -err.
  __attribute__((always_inline)) inline int step(const W16Shared& sh) {
    auto widen_lo = [](__m512i v32) {
      return _mm512_cvtepi32_epi64(_mm512_castsi512_si256(v32));
    };
    auto widen_hi = [](__m512i v32) {
      return _mm512_cvtepi32_epi64(_mm512_extracti64x4_epi64(v32, 1));
    };
    auto widenu_lo = [](__m256i v32) { return _mm512_cvtepu32_epi64(v32); };
    auto narrow = [](__m512i lo64, __m512i hi64) {
      __m256i a = _mm512_cvtepi64_epi32(lo64);
      __m256i b = _mm512_cvtepi64_epi32(hi64);
      return _mm512_inserti64x4(_mm512_castsi256_si512(a), b, 1);
    };

    // ---- decoupled refill: append the PRE-GATHERED `stage` word (only
    // shifts/ors on the acc chain), then re-gather the next stage word at
    // the bottom — its ~25-cycle load latency overlaps this iteration's
    // decode instead of serializing ahead of the peek. ----
    __mmask16 need = _mm512_mask_cmplt_epi32_mask(
        active, bits, _mm512_set1_epi32(33));
    __mmask8 need_lo = (__mmask8)(need & 0xFF);
    __mmask8 need_hi = (__mmask8)(need >> 8);
    __m512i sh32 = _mm512_and_si512(_mm512_sub_epi32(sh.c32, bits), sh.c63);
    __m512i add_lo = _mm512_sllv_epi64(
        widenu_lo(_mm512_castsi512_si256(stage)), widen_lo(sh32));
    __m512i add_hi = _mm512_sllv_epi64(
        widenu_lo(_mm512_extracti64x4_epi64(stage, 1)), widen_hi(sh32));
    acc_lo = _mm512_mask_or_epi64(acc_lo, need_lo, acc_lo, add_lo);
    acc_hi = _mm512_mask_or_epi64(acc_hi, need_hi, acc_hi, add_hi);
    bits = _mm512_mask_add_epi32(bits, need, bits, sh.c32);
    spos = _mm512_mask_add_epi32(spos, need, spos, _mm512_set1_epi32(4));
    // Reload stage for every lane (non-consuming lanes re-fetch the same
    // word — identical value, so no merge mask is needed).
    __m512i rp = _mm512_min_epu32(spos, end);
    stage = _mm512_shuffle_epi8(_mm512_i32gather_epi32(rp, base, 1),
                                sh.bsw);

    // ---- peek + fused LUT gather (w16/entidx both derive from ONE
    // narrow of the accs' top 32 bits; a 64-bit-index VPGATHERQQ variant
    // that skips the narrow measured SLOWER — two 8-lane gathers cost
    // more throughput than the narrow costs latency) ----
    __m512i w32 = narrow(_mm512_srli_epi64(acc_lo, 32),
                         _mm512_srli_epi64(acc_hi, 32));
    __mmask16 is_dc = _mm512_cmpeq_epi32_mask(k, sh.zero);
    __m512i selidx = _mm512_mask_add_epi32(
        _mm512_add_epi32(s, s), is_dc, _mm512_add_epi32(s, s), sh.c1);
    __m512i bank = _mm512_permutex2var_epi32(sh.sel_lo, selidx, sh.sel_hi);
    __m512i entidx = _mm512_add_epi32(
        _mm512_slli_epi32(bank, RJT_L1_BITS),
        _mm512_srli_epi32(w32, 32 - RJT_L1_BITS));
    __m512i ent = _mm512_i32gather_epi32(entidx, sh.t12, 2);
    ent = _mm512_and_si512(ent, _mm512_set1_epi32(0xFFFF));

    // Level-2 fallback (code length > RJT_L1_BITS) / invalid code: rare,
    // and vectorized — one masked gather into the 16-bit table instead of
    // a scalar per-lane loop, so a miss costs ~one L2 load, not a flush.
    __mmask16 miss = _mm512_mask_cmpeq_epi32_mask(active, ent, sh.zero);
    if (__builtin_expect(miss, 0)) {
      __m512i idx2 = _mm512_add_epi32(_mm512_slli_epi32(bank, 16),
                                      _mm512_srli_epi32(w32, 16));
      ent = _mm512_mask_i32gather_epi32(ent, miss, idx2, sh.t16, 2);
      ent = _mm512_and_si512(ent, _mm512_set1_epi32(0xFFFF));
      if (_mm512_mask_cmpeq_epi32_mask(miss, ent, sh.zero))
        return -RJT_INVALID_CODE;
    }

    __m512i skip = _mm512_maskz_and_epi32(active, ent,
                                          _mm512_set1_epi32(31));
    __m512i adv = _mm512_maskz_and_epi32(
        active, _mm512_srli_epi32(ent, 5), _mm512_set1_epi32(127));
    __m512i size = _mm512_srli_epi32(ent, 12);

    // ---- DC predictor update (masked; AC lanes have size == 0) ----
    __m512i mag = _mm512_srlv_epi32(w32, _mm512_sub_epi32(sh.c32, skip));
    __m512i szmask = _mm512_sub_epi32(_mm512_sllv_epi32(sh.c1, size), sh.c1);
    mag = _mm512_and_si512(mag, szmask);
    __m512i half = _mm512_srli_epi32(_mm512_add_epi32(szmask, sh.c1), 1);
    __mmask16 neg = _mm512_cmplt_epi32_mask(mag, half);
    __m512i e = _mm512_mask_sub_epi32(mag, neg, mag, szmask);
    __mmask16 dcm = (__mmask16)(is_dc & active);
    __m512i comp = _mm512_permutexvar_epi32(s, sh.comp_tbl);
    for (int c = 0; c < 3; ++c) {
      __mmask16 cm = _mm512_mask_cmpeq_epi32_mask(
          dcm, comp, _mm512_set1_epi32(c));
      dc[c] = _mm512_mask_add_epi32(dc[c], cm, dc[c], e);
    }

    // ---- consume bits ----
    acc_lo = _mm512_sllv_epi64(acc_lo, widen_lo(skip));
    acc_hi = _mm512_sllv_epi64(acc_hi, widen_hi(skip));
    bits = _mm512_sub_epi32(bits, skip);

    // ---- state transitions (mask ops) ----
    __m512i kn = _mm512_add_epi32(k, adv);
    __mmask16 bd = _mm512_cmpgt_epi32_mask(kn, sh.c63);
    k = _mm512_maskz_mov_epi32(~bd, kn);
    s = _mm512_mask_add_epi32(s, bd, s, sh.c1);
    __mmask16 md = _mm512_cmpgt_epi32_mask(s, sh.vnslots1);
    s = _mm512_maskz_mov_epi32(~md, s);
    m = _mm512_mask_add_epi32(m, md, m, sh.c1);
    syms = _mm512_mask_add_epi32(syms, active, syms, sh.c1);

    // ---- rare events: record / completion / bounds (scalar) ----
    __mmask16 fin = _mm512_mask_cmp_epi32_mask(md, m, sh.vtotal,
                                               _MM_CMPINT_NLT);  // m>=total
    __mmask16 want_rec = _mm512_mask_cmp_epi32_mask(md, syms, sh.vS,
                                                    _MM_CMPINT_NLT);
    unsigned evbits = (unsigned)((fin | want_rec) & active);
    if (__builtin_expect(evbits || ++iter_since_check >= 4096, 0)) {
      iter_since_check = 0;
      alignas(64) int32_t m_a[16], syms_a[16], bits_a[16], dc_a[3][16];
      alignas(64) uint32_t pos_a[16];
      _mm512_store_si512((void*)m_a, m);
      _mm512_store_si512((void*)syms_a, syms);
      _mm512_store_si512((void*)bits_a, bits);
      for (int c = 0; c < 3; ++c) _mm512_store_si512((void*)dc_a[c], dc[c]);
      _mm512_store_si512((void*)pos_a, spos);
      bool any_change = false;
      alignas(64) int32_t syms_new[16];
      _mm512_store_si512((void*)syms_new, syms);
      for (int l = 0; l < 16; ++l) {
        if (lanes[l].done) continue;
        int64_t bit_off =
            ((int64_t)pos_a[l] - base_a[l]) * 8 - bits_a[l];
        if (bit_off > clean_lens[l] * 8 + 56) return -RJT_SCAN_EXHAUSTED;
        if (m_a[l] >= sh.total) {
          RjtIndexJob& j = *lanes[l].job;
          j.sym_count[lanes[l].rec - 1] = syms_a[l];
          j.n_found = lanes[l].rec;
          lanes[l].done = true;
          active = (__mmask16)(active & ~(1u << l));
          any_change = true;
        } else if ((evbits & (1u << l)) && syms_a[l] >= sh.S) {
          RjtIndexJob& j = *lanes[l].job;
          if (lanes[l].rec >= j.n_records) return -RJT_BAD_SEGMENTS;
          j.sym_count[lanes[l].rec - 1] = syms_a[l];
          j.bit_off[lanes[l].rec] = bit_off;
          j.mcu_idx[lanes[l].rec] = m_a[l];
          j.dc_out[lanes[l].rec * 3 + 0] = dc_a[0][l];
          j.dc_out[lanes[l].rec * 3 + 1] = dc_a[1][l];
          j.dc_out[lanes[l].rec * 3 + 2] = dc_a[2][l];
          ++lanes[l].rec;
          syms_new[l] = 0;
          any_change = true;
        }
      }
      if (any_change)
        syms = _mm512_load_si512((const void*)syms_new);
    }
    return 0;
  }
};

long idx_walk16(RjtIndexJob** jobs, const IdxBanks& tb,
                long* clean_lens_out) {
  const long S = jobs[0]->min_symbols > 0 ? jobs[0]->min_symbols : (1L << 60);
  W16Shared sh;
  sh.init(tb, jobs[0]->total_mcus, S);
  W16Group g;
  int rc = g.init(jobs, clean_lens_out);
  if (rc) return rc;
  while (g.active) {
    if ((rc = g.step(sh))) return rc;
  }
  return 0;
}

// TWO groups of 16 interleaved on one core: the per-step critical chain
// (acc -> window -> LUT gather -> skip -> acc) is ~40+ cycles of latency
// that one group cannot fill; issuing a second independent group's chain
// into the same out-of-order window overlaps them (measured ~1.5x one
// group's 32-stream aggregate on Skylake-SP; see docs/performance.md).
long idx_walk16x2(RjtIndexJob** jobs_a, RjtIndexJob** jobs_b,
                  const IdxBanks& tb, long* clean_a, long* clean_b) {
  const long S =
      jobs_a[0]->min_symbols > 0 ? jobs_a[0]->min_symbols : (1L << 60);
  W16Shared sh;
  sh.init(tb, jobs_a[0]->total_mcus, S);
  W16Group ga, gb;
  int rc = ga.init(jobs_a, clean_a);
  if (rc) return rc;
  rc = gb.init(jobs_b, clean_b);
  if (rc) return rc;
  while (ga.active | gb.active) {
    // Both groups active is the overwhelmingly common case (same-content
    // streams finish within ~1 symbol of each other); the tails drain solo.
    if (ga.active && (rc = ga.step(sh))) return rc;
    if (gb.active && (rc = gb.step(sh))) return rc;
  }
  return 0;
}

}  // namespace

#pragma GCC pop_options

// Walk up to 16 same-geometry, same-table jobs in AVX-512 lockstep; the
// 16-lane sibling of rjt_index_scan8 (same output contract). Returns
// -RJT_BAD_SEGMENTS when AVX-512 is unavailable or jobs are not uniform —
// callers then fall back to the 8-lane walker / scalar pair walker.
namespace {

// Jobs may share one SIMD walk only when they are fully uniform: same
// geometry, same per-component table ASSIGNMENTS and sampling factors
// (not just same table contents per id — two streams whose id->contents
// match but whose component->id mapping differs would silently walk with
// job 0's bank mapping), and same table contents per id.
bool jobs_uniform(const RjtIndexJob& a, const RjtIndexJob& b) {
  if (a.total_mcus != b.total_mcus || a.min_symbols != b.min_symbols ||
      a.interleaved != b.interleaved ||
      a.num_components != b.num_components)
    return false;
  for (int c = 0; c < a.num_components; ++c) {
    if (a.h_samp[c] != b.h_samp[c] || a.v_samp[c] != b.v_samp[c] ||
        a.dc_table[c] != b.dc_table[c] || a.ac_table[c] != b.ac_table[c])
      return false;
  }
  for (int t = 0; t < kMaxTables; ++t) {
    const uint8_t* pa[4] = {a.dc_bits[t], a.dc_values[t], a.ac_bits[t],
                            a.ac_values[t]};
    const uint8_t* pb[4] = {b.dc_bits[t], b.dc_values[t], b.ac_bits[t],
                            b.ac_values[t]};
    for (int j = 0; j < 4; ++j) {
      if ((pa[j] == nullptr) != (pb[j] == nullptr)) return false;
      if (pa[j] && pa[j] != pb[j] &&
          std::memcmp(pa[j], pb[j], kTblCmpLen[j]) != 0)
        return false;
    }
  }
  return true;
}

bool avx512_ok() {
  return __builtin_cpu_supports("avx512f") &&
         __builtin_cpu_supports("avx512bw") &&
         __builtin_cpu_supports("avx512dq") &&
         __builtin_cpu_supports("avx512vl");
}

}  // namespace

long rjt_index_scan16(RjtIndexJob** jobs, long n_jobs,
                      long* clean_lens_out) {
  if (n_jobs != 16) return -RJT_BAD_SEGMENTS;
  if (!avx512_ok()) return -RJT_BAD_SEGMENTS;
  const RjtIndexJob& a = *jobs[0];
  for (int l = 1; l < 16; ++l)
    if (!jobs_uniform(a, *jobs[l])) return -RJT_BAD_SEGMENTS;
  IdxBanks tb;
  int rc = tb.build(a);
  if (rc) return rc;
  // idx_walk16's slot->component map is a 16-entry register permute; a
  // stream with more scan slots (malformed sampling factors past T.81's
  // sum(h*v) <= 10 cap can parse that way) must fall back rather than
  // silently wrap the permute index.
  if (tb.nslots > 16) return -RJT_BAD_SEGMENTS;
  return idx_walk16(jobs, tb, clean_lens_out);
}

// 32-stream walk: two 16-lane AVX-512 groups interleaved on ONE core, so
// the second group's gather chain fills the first's latency stalls. Same
// contract and uniformity rules as rjt_index_scan16.
long rjt_index_scan32(RjtIndexJob** jobs, long n_jobs,
                      long* clean_lens_out) {
  if (n_jobs != 32) return -RJT_BAD_SEGMENTS;
  if (!avx512_ok()) return -RJT_BAD_SEGMENTS;
  const RjtIndexJob& a = *jobs[0];
  for (int l = 1; l < 32; ++l)
    if (!jobs_uniform(a, *jobs[l])) return -RJT_BAD_SEGMENTS;
  IdxBanks tb;
  int rc = tb.build(a);
  if (rc) return rc;
  if (tb.nslots > 16) return -RJT_BAD_SEGMENTS;
  return idx_walk16x2(jobs, jobs + 16, tb, clean_lens_out,
                      clean_lens_out + 16);
}

// Static CPU capability probe for the 16-lane walker, so callers can pick
// their chunk width once instead of building 16 jobs per batch only to be
// told -RJT_BAD_SEGMENTS on hosts without AVX-512.
long rjt_index_scan16_available(void) {
  return __builtin_cpu_supports("avx512f") &&
         __builtin_cpu_supports("avx512bw") &&
         __builtin_cpu_supports("avx512dq") &&
         __builtin_cpu_supports("avx512vl");
}

// Walk up to 8 same-geometry, same-table jobs in SIMD lockstep. Fills each
// job's outputs exactly like rjt_index_scan (n_found, clean via job.clean;
// per-job clean lengths via clean_lens_out). Jobs beyond the first must
// carry identical Huffman tables (callers group by digest). Returns 0 or
// -err; returns -RJT_BAD_SEGMENTS when AVX2 is unavailable or the jobs are
// not uniform — callers then fall back to the scalar pair walker.
long rjt_index_scan8(RjtIndexJob** jobs, long n_jobs,
                     long* clean_lens_out) {
  if (n_jobs != 8) return -RJT_BAD_SEGMENTS;
  if (!__builtin_cpu_supports("avx2")) return -RJT_BAD_SEGMENTS;
  const RjtIndexJob& a = *jobs[0];
  for (int l = 1; l < 8; ++l)
    if (!jobs_uniform(a, *jobs[l])) return -RJT_BAD_SEGMENTS;
  IdxBanks tb;
  int rc = tb.build(a);
  if (rc) return rc;
  return idx_walk8(jobs, tb, clean_lens_out);
}

#else  // !__x86_64__

long rjt_index_scan8(RjtIndexJob** jobs, long n_jobs,
                     long* clean_lens_out) {
  (void)jobs;
  (void)n_jobs;
  (void)clean_lens_out;
  return -RJT_BAD_SEGMENTS;  // caller falls back to the scalar pair walker
}

long rjt_index_scan16(RjtIndexJob** jobs, long n_jobs,
                      long* clean_lens_out) {
  (void)jobs;
  (void)n_jobs;
  (void)clean_lens_out;
  return -RJT_BAD_SEGMENTS;
}

long rjt_index_scan16_available(void) { return 0; }

long rjt_index_scan32(RjtIndexJob** jobs, long n_jobs,
                      long* clean_lens_out) {
  (void)jobs;
  (void)n_jobs;
  (void)clean_lens_out;
  return -RJT_BAD_SEGMENTS;
}

#endif  // __x86_64__

// Pack per-lane BIT ranges of a clean stream into the dense uint32 word
// stream (bit_start lands at bit 31 of the lane's first word — the wave
// kernel then needs no skip-bits support; alignment costs one bswap+shift
// per word here). word_off[l] is the lane's first word in `out` (exclusive
// prefix sum of ceil((bit_end-bit_start)/32), as for rjt_pack_dense).
//
// Scalar reference path; rjt_pack_bits dispatches to the AVX-512 version
// below when the host has it (the scalar byte loop was 85 ms/batch on the
// 32x4K mug leg — the second-largest host CPU term after the index walk).
static void pack_bits_scalar(const uint8_t* clean, long clean_len,
                             uint8_t* out, const int32_t* word_off,
                             const int64_t* bit_start, const int64_t* bit_end,
                             long n_lanes) {
  for (long l = 0; l < n_lanes; ++l) {
    int64_t s = bit_start[l];
    int64_t e = bit_end[l];
    long nw = (long)((e - s + 31) / 32);
    uint8_t* dst = out + (long)word_off[l] * 4;
    for (long j = 0; j < nw; ++j) {
      int64_t bit = s + (int64_t)j * 32;
      long byte = (long)(bit >> 3);
      int sh = (int)(bit & 7);
      uint64_t w8;
      if (byte + 8 <= clean_len) {
        std::memcpy(&w8, clean + byte, 8);
        w8 = __builtin_bswap64(w8);
      } else {
        w8 = 0;
        for (int b = 0; b < 8; ++b)
          w8 = (w8 << 8) | (uint64_t)(byte + b < clean_len ? clean[byte + b] : 0);
      }
      uint32_t w = (uint32_t)(w8 >> (32 - sh));
      std::memcpy(dst + j * 4, &w, 4);
    }
  }
}

#if defined(__x86_64__)
// AVX-512 pack: 16 output words per iteration. For a lane starting at bit
// s, word j is bits [s+32j, s+32j+32) big-endian — i.e. a byte-shifted
// big-endian window: w_j = (be32(b0+4j) << sh) | (be32(b0+4j+4) >> (32-sh))
// with b0 = s>>3, sh = s&7 constant per lane. Two unaligned 64-byte loads,
// one in-dword byte reverse (VPSHUFB), two shifts, one OR.
__attribute__((target("avx512f,avx512bw")))
static void pack_bits_avx512(const uint8_t* clean, long clean_len,
                             uint8_t* out, const int32_t* word_off,
                             const int64_t* bit_start, const int64_t* bit_end,
                             long n_lanes) {
  const __m512i bswap32 = _mm512_broadcast_i32x4(
      _mm_set_epi8(12, 13, 14, 15, 8, 9, 10, 11, 4, 5, 6, 7, 0, 1, 2, 3));
  for (long l = 0; l < n_lanes; ++l) {
    const int64_t s = bit_start[l];
    const int64_t e = bit_end[l];
    const long nw = (long)((e - s + 31) / 32);
    uint8_t* dst = out + (long)word_off[l] * 4;
    const long b0 = (long)(s >> 3);
    const int sh = (int)(s & 7);
    long j = 0;
    // Vector body: iteration j reads clean[b0+4j .. b0+4j+71]; the clean
    // buffer carries 8 zero slack bytes, so stop once the window passes
    // clean_len (the scalar tail handles the zero-padded end exactly).
    for (; j + 16 <= nw && b0 + 4 * j + 64 <= clean_len; j += 16) {
      __m512i v0 = _mm512_loadu_si512((const void*)(clean + b0 + 4 * j));
      __m512i v1 = _mm512_loadu_si512((const void*)(clean + b0 + 4 * j + 4));
      v0 = _mm512_shuffle_epi8(v0, bswap32);
      v1 = _mm512_shuffle_epi8(v1, bswap32);
      __m512i w = sh == 0 ? v0
                          : _mm512_or_si512(_mm512_slli_epi32(v0, sh),
                                            _mm512_srli_epi32(v1, 32 - sh));
      _mm512_storeu_si512((void*)(dst + 4 * j), w);
    }
    for (; j < nw; ++j) {
      int64_t bit = s + (int64_t)j * 32;
      long byte = (long)(bit >> 3);
      uint64_t w8;
      if (byte + 8 <= clean_len) {
        std::memcpy(&w8, clean + byte, 8);
        w8 = __builtin_bswap64(w8);
      } else {
        w8 = 0;
        for (int b = 0; b < 8; ++b)
          w8 = (w8 << 8) | (uint64_t)(byte + b < clean_len ? clean[byte + b] : 0);
      }
      uint32_t w = (uint32_t)(w8 >> (32 - sh));
      std::memcpy(dst + j * 4, &w, 4);
    }
  }
}
#endif  // __x86_64__

void rjt_pack_bits(const uint8_t* clean, long clean_len, uint8_t* out,
                   const int32_t* word_off, const int64_t* bit_start,
                   const int64_t* bit_end, long n_lanes) {
#if defined(__x86_64__)
  static const bool avx512 = __builtin_cpu_supports("avx512f") &&
                             __builtin_cpu_supports("avx512bw");
  if (avx512) {
    pack_bits_avx512(clean, clean_len, out, word_off, bit_start, bit_end,
                     n_lanes);
    return;
  }
#endif
  pack_bits_scalar(clean, clean_len, out, word_off, bit_start, bit_end,
                   n_lanes);
}

// Per-image record set for the lane-geometry pass below: pointers into the
// index walkers' record buffers (bit_off/dc/mcu_idx/sym_count slices), plus
// the end markers and destination lane range. Mirrors the tuple the Python
// packer used to iterate per image (ops/device_entropy.py
// pack_virtual_segments) — moved native so the per-batch bookkeeping
// releases the GIL instead of serializing the submit threads.
struct RjtGeomJob {
  const int64_t* bo;   // record bit offsets (n_rec)
  const int32_t* dc;   // entry DC predictors (n_rec, 3), component-major
  const int32_t* mi;   // record MCU indices (n_rec)
  const int32_t* sc;   // record symbol counts (n_rec)
  int64_t n_rec;
  int64_t end_bit;     // bit bound of the LAST record's lane
  int32_t end_mcu;     // MCU bound of the LAST record's lane
  int32_t lane_start;  // global lane index of record 0
  int32_t img_base;    // local_image * total_blocks (wave scatter base)
  int32_t bank;        // Huffman table bank serving this image's lanes
  int32_t img_row;     // row of lane_of_mcu this image fills
  int32_t _pad;
};

// Pass 1 of the native lane bookkeeping: max lane bit-span and max lane
// symbol count across all kept records — the packer sizes the dense word
// budget and the wave's emission buffers from these BEFORE allocating the
// geometry arrays.
void rjt_record_maxes(const RjtGeomJob* jobs, long n_jobs,
                      int64_t* max_bits_out, int64_t* max_syms_out) {
  int64_t mb = 0, ms = 0;
  for (long i = 0; i < n_jobs; ++i) {
    const RjtGeomJob& j = jobs[i];
    for (int64_t r = 0; r < j.n_rec; ++r) {
      int64_t e = (r + 1 < j.n_rec) ? j.bo[r + 1] : j.end_bit;
      int64_t d = e - j.bo[r];
      if (d > mb) mb = d;
      if ((int64_t)j.sc[r] > ms) ms = j.sc[r];
    }
  }
  *max_bits_out = mb;
  *max_syms_out = ms;
}

// Pass 2: fill the per-lane geometry arrays (all pre-allocated to the
// padded lane count and zeroed by the caller) and the lane_of_mcu gather
// key (row-major (B, total_mcus); row r covers exactly the MCU spans of
// its kept records — dropped ROI tails stay 0, as the Python loop left
// them). Byte-for-byte the same values the Python bookkeeping produced;
// tests/test_device_entropy.py pins the packed output.
void rjt_lane_geometry(const RjtGeomJob* jobs, long n_jobs,
                       int64_t* lane_words, int64_t* bit_starts,
                       int64_t* bit_ends, int32_t* img_base,
                       int32_t* mcu_start, int32_t* mcu_count,
                       int32_t* lane_bank, int32_t* dc_flat,
                       int32_t* lane_of_mcu, int64_t total_mcus) {
  for (long i = 0; i < n_jobs; ++i) {
    const RjtGeomJob& j = jobs[i];
    const long l0 = j.lane_start;
    int32_t* row = lane_of_mcu + (int64_t)j.img_row * total_mcus;
    for (int64_t r = 0; r < j.n_rec; ++r) {
      const long l = l0 + (long)r;
      const int64_t s = j.bo[r];
      const int64_t e = (r + 1 < j.n_rec) ? j.bo[r + 1] : j.end_bit;
      bit_starts[l] = s;
      bit_ends[l] = e;
      lane_words[l] = (e - s + 31) / 32;
      img_base[l] = j.img_base;
      const int32_t m0 = j.mi[r];
      const int32_t m1 = (r + 1 < j.n_rec) ? j.mi[r + 1] : j.end_mcu;
      mcu_start[l] = m0;
      mcu_count[l] = m1 - m0;
      lane_bank[l] = j.bank;
      dc_flat[l * 3 + 0] = j.dc[r * 3 + 0];
      dc_flat[l * 3 + 1] = j.dc[r * 3 + 1];
      dc_flat[l * 3 + 2] = j.dc[r * 3 + 2];
      for (int32_t m = m0; m < m1; ++m) row[m] = (int32_t)l;
    }
  }
}

// Standalone unstuff for the device-sync entropy path (the self-
// synchronizing wave needs only the clean byte stream on device — chunk
// lanes start at clean byte offsets, so there is no host index walk and no
// bit-aligned repack). Returns the clean length, or -1 when a real RSTn
// marker is embedded (DRI=0 streams must carry none).
long rjt_unstuff(const uint8_t* scan, long n, uint8_t* clean) {
  return unstuff_scan(scan, n, clean);
}

// ---------------------------------------------------------------------------
// Native JPEG header parser — the C++ front-end mirroring the reference's
// RocJpegStreamParser (src/rocjpeg_parser.cpp:43-470) and bit-for-bit
// equivalent to the Python parser (rocjpeg_tpu/core/bitstream.py), which
// remains the portable fallback and oracle.
// ---------------------------------------------------------------------------

struct RjtParsedHeader {
  int32_t width, height, num_components;
  int32_t comp_id[4], h_samp[4], v_samp[4], quant_sel[4];
  uint8_t qtab[4][64];
  uint8_t load_qtab[4];
  uint8_t dc_bits[2][16], dc_vals[2][12];
  uint8_t ac_bits[2][16], ac_vals[2][162];
  uint8_t load_huff[2];
  int32_t num_scan_components;
  int32_t scan_comp_sel[4], scan_dc[4], scan_ac[4];
  int32_t restart_interval;
  int64_t scan_offset, scan_end;  // [scan_offset, scan_end) of the input
  int32_t subsampling;            // ChromaSubsampling enum value
  int64_t num_mcus;
};

namespace {

// ChromaSubsampling enum values (rocjpeg_tpu/types.py, mirroring
// api/rocjpeg.h:86-94 ordering). kCssUnknown MUST be -1 — it is the wire
// value ChromaSubsampling(...) constructs on the Python side, and UNKNOWN
// is a parse *result*, not a parse error (parser.cpp:432-470 classifies and
// lets the decoder reject later).
enum {
  kCss444 = 0, kCss440 = 1, kCss422 = 2, kCss420 = 3,
  kCss411 = 4, kCss400 = 5, kCssUnknown = -1,
};

int classify_css(int c1h, int c2h, int c3h, int c1v, int c2v, int c3v) {
  auto is = [&](int a, int b, int c, int d, int e, int f) {
    return c1h == a && c2h == b && c3h == c && c1v == d && c2v == e &&
           c3v == f;
  };
  if (is(1, 1, 1, 1, 1, 1) || is(2, 2, 2, 2, 2, 2) || is(4, 4, 4, 4, 4, 4))
    return kCss444;
  if (is(1, 1, 1, 2, 1, 1)) return kCss440;
  if (is(2, 1, 1, 1, 1, 1) || is(2, 1, 1, 2, 2, 2) || is(2, 2, 2, 2, 1, 1))
    return kCss422;
  if (is(2, 1, 1, 2, 1, 1)) return kCss420;
  if (is(4, 1, 1, 1, 1, 1)) return kCss411;
  if (c2h == 0 && c3h == 0 && c2v == 0 && c3v == 0 && c1h > 0 && c1v > 0)
    return kCss400;
  return kCssUnknown;
}

inline uint32_t be16(const uint8_t* p) {
  return ((uint32_t)p[0] << 8) | p[1];
}

}  // namespace

// Returns 0 on success, else a BAD_JPEG reason code (>0).
enum {
  RJT_PARSE_OK = 0,
  RJT_PARSE_NO_SOI = 10,
  RJT_PARSE_TRUNCATED = 11,
  RJT_PARSE_BAD_COMPONENTS = 12,
  RJT_PARSE_BAD_QTABLE = 13,
  RJT_PARSE_QTABLE_16BIT = 14,
  RJT_PARSE_BAD_HUFF = 15,
  RJT_PARSE_NO_DHT = 16,
  RJT_PARSE_NO_DQT = 17,
  RJT_PARSE_NO_SOS = 18,
  RJT_PARSE_BAD_SAMPLING = 19,
  RJT_PARSE_BAD_DRI = 20,
  RJT_PARSE_SOS_MISMATCH = 21,
};

int rjt_parse(const uint8_t* buf, long n, RjtParsedHeader* out) {
  std::memset(out, 0, sizeof(*out));
  out->subsampling = kCssUnknown;
  if (n < 4 || buf[0] != 0xFF || buf[1] != 0xD8) return RJT_PARSE_NO_SOI;

  long pos = 2;
  bool sos_found = false, dht_found = false, dqt_found = false;
  long scan_start = 0;

  while (!sos_found && pos < n) {
    while (pos < n && buf[pos] == 0xFF) ++pos;  // fill bytes
    if (pos >= n) break;
    uint8_t marker = buf[pos];
    ++pos;
    if (pos + 2 > n) break;
    long chunk_len = (long)be16(buf + pos);
    long next_chunk = pos + chunk_len;

    if (marker == 0xC0) {  // SOF0 (baseline only, parser.cpp:160)
      if (pos + 8 > n) return RJT_PARSE_TRUNCATED;
      out->height = (int32_t)be16(buf + pos + 3);
      out->width = (int32_t)be16(buf + pos + 5);
      out->num_components = buf[pos + 7];
      if (out->num_components > 3) return RJT_PARSE_BAD_COMPONENTS;
      long q = pos + 8;
      if (q + 3L * out->num_components > n) return RJT_PARSE_TRUNCATED;
      for (int i = 0; i < out->num_components; ++i) {
        out->comp_id[i] = buf[q];
        out->h_samp[i] = buf[q + 1] >> 4;
        out->v_samp[i] = buf[q + 1] & 0xF;
        out->quant_sel[i] = buf[q + 2];
        if (out->quant_sel[i] >= 4) return RJT_PARSE_BAD_QTABLE;
        q += 3;
      }
      int h0 = out->h_samp[0], v0 = out->v_samp[0];
      if (h0 == 0 || v0 == 0) return RJT_PARSE_BAD_SAMPLING;
      out->num_mcus = (long)((out->width + h0 * 8 - 1) / (h0 * 8)) *
                      ((out->height + v0 * 8 - 1) / (v0 * 8));
      int nc = out->num_components;
      out->subsampling = classify_css(
          out->h_samp[0], nc > 1 ? out->h_samp[1] : 0,
          nc > 2 ? out->h_samp[2] : 0, out->v_samp[0],
          nc > 1 ? out->v_samp[1] : 0, nc > 2 ? out->v_samp[2] : 0);
    } else if (marker == 0xC4) {  // DHT (parser.cpp:256)
      long length = chunk_len - 2;
      long q = pos + 2;
      while (length > 0) {
        if (q + 17 > n) return RJT_PARSE_TRUNCATED;
        uint8_t index = buf[q];
        ++q;
        bool is_ac = (index & 0xF0) != 0;
        int tid = index & 0x0F;
        if (tid >= 2) return RJT_PARSE_BAD_HUFF;
        long count = 0;
        for (int i = 0; i < 16; ++i) count += buf[q + i];
        if (q + 16 + count > n) return RJT_PARSE_TRUNCATED;
        if (is_ac) {
          if (count > 162) return RJT_PARSE_BAD_HUFF;
          std::memcpy(out->ac_bits[tid], buf + q, 16);
          std::memcpy(out->ac_vals[tid], buf + q + 16, count);
        } else {
          if (count > 12) return RJT_PARSE_BAD_HUFF;
          std::memcpy(out->dc_bits[tid], buf + q, 16);
          std::memcpy(out->dc_vals[tid], buf + q + 16, count);
        }
        out->load_huff[tid] = 1;
        q += 16 + count;
        length -= 1 + 16 + count;
      }
      dht_found = true;
    } else if (marker == 0xDB) {  // DQT (parser.cpp:217)
      long end = pos + chunk_len;
      long q = pos + 2;
      while (q < end) {
        if (q + 1 + 64 > n) return RJT_PARSE_TRUNCATED;
        uint8_t index = buf[q];
        ++q;
        if (index >> 4) return RJT_PARSE_QTABLE_16BIT;
        if (index >= 4) return RJT_PARSE_BAD_QTABLE;
        std::memcpy(out->qtab[index & 0x0F], buf + q, 64);
        out->load_qtab[index & 0x0F] = 1;
        q += 64;
      }
      dqt_found = true;
    } else if (marker == 0xDD) {  // DRI (parser.cpp:374)
      if (chunk_len != 4 || pos + 4 > n) return RJT_PARSE_BAD_DRI;
      out->restart_interval = (int32_t)be16(buf + pos + 2);
    } else if (marker == 0xDA) {  // SOS (parser.cpp:324)
      if (pos + 3 > n) return RJT_PARSE_TRUNCATED;
      int nsc = buf[pos + 2];
      if (nsc > 3) return RJT_PARSE_BAD_COMPONENTS;
      long q = pos + 3;
      if (q + 2L * nsc + 3 > n) return RJT_PARSE_TRUNCATED;
      out->num_scan_components = nsc;
      for (int i = 0; i < nsc; ++i) {
        int cid = buf[q];
        int table = buf[q + 1];
        q += 2;
        out->scan_comp_sel[i] = cid;
        out->scan_dc[i] = (table >> 4) & 0x0F;
        out->scan_ac[i] = table & 0x0F;
        if (out->scan_dc[i] >= 4 || out->scan_ac[i] >= 4)
          return RJT_PARSE_BAD_HUFF;
        if (i >= out->num_components || cid != out->comp_id[i])
          return RJT_PARSE_SOS_MISMATCH;
      }
      scan_start = q + 3;  // skip Ss, Se, Ah/Al
      sos_found = true;
    }
    pos = next_chunk;
  }

  if (!dht_found) return RJT_PARSE_NO_DHT;
  if (!dqt_found) return RJT_PARSE_NO_DQT;
  if (!sos_found) return RJT_PARSE_NO_SOS;

  // ParseEOI: slice data = [scan_start .. 0xFFD9) or rest of buffer.
  long end = n;
  for (const uint8_t* s = buf + scan_start;;) {
    const uint8_t* ff = (const uint8_t*)memchr(
        s, 0xFF, (size_t)(buf + n - s));
    if (!ff || ff + 1 >= buf + n) break;
    if (ff[1] == 0xD9) {
      end = ff - buf;
      break;
    }
    s = ff + 1;
  }
  out->scan_offset = scan_start;
  out->scan_end = end;
  return RJT_PARSE_OK;
}

int rjt_version() { return 4; }

}  // extern "C"
