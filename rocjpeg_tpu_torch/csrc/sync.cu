// K0 — the DRI=0 sync: the virtual lanes of a scan, found on the card.
//
// Replaces no TPU kernel. It replaces the host index walk
// (csrc/host/rocjpeg_entropy.cpp rjt_index_scan and its 8-, 16- and
// 32-stream walkers, driven by ops/pack.py index_walk and
// pack_virtual_segments), which Huffman-decoded every symbol of every DRI=0
// stream on the host only to find restart points for K1. The host now
// stages each stream unstuffed (ops/pack.py stage_clean_streams) and this
// file computes the lane table K1 and K2 read (kernels/sync.py lists it).
//
// Method: the self-synchronising Huffman decode of Weissenberger and
// Schmidt ("Massively Parallel Huffman Decoding on GPUs", ICPP 2018;
// "Accelerating JPEG Decompression on GPUs", 2021), for baseline JPEG.
//  - An image's clean stream is cut into subsequences of S bits, one
//    thread each. The state of the decode at a symbol start is (bit
//    position, block slot within the MCU, coefficient index); a thread
//    decodes from an entry state until the first symbol start at or past
//    its subsequence's end, which is its exit state. Subsequence 0 enters
//    at the stream's start; any other first guesses (t * S, slot 0, k 0).
//  - A thread whose entry is not its left neighbour's exit takes that exit
//    and decodes again, until no entry changes: first within a block of
//    128 subsequences, through shared memory, then across blocks, in
//    rounds of one cooperative grid, with no wait on the host. Since the
//    first subsequence's entry is exact, the fixed point is the sequential
//    decode, by induction; a wrong guess usually meets the true symbol
//    boundaries within a few codes, so few threads decode twice.
//  - Where the block slots' tables repeat with a period shorter than the
//    MCU (an encoder may give every component the same tables), a guessed
//    decode finds the bit boundaries and the coefficient index but never
//    which block of the MCU it is in. The fixed point is then sought on
//    (bit position, slot modulo that period, coefficient index), which
//    decodes the same symbols; a per-image scan of the blocks each
//    subsequence completed gives every entry its true slot
//    (sync_phase_kernel), and one more decode a subsequence from there
//    makes its records (sync_record_kernel).
//  - Each thread's last decode also records the MCUs it completed (those
//    ending at most 56 bits past the stream, the host walk's limit, apart),
//    the DC differences it summed, and its first MCU boundary with the DC
//    differences before it. Per-image scans (sync_finalize_kernel) turn
//    these into each lane's first MCU, MCU count, entering DC predictors,
//    error flag and words; sync_copy_kernel realigns each lane's bits
//    word-aligned into the dense stream and fills lane_of_mcu.
//
// What bounds it: like K1, the serial chain of symbols within a thread
// (each code's length decides where the next starts), not bytes. Its
// bytes are the clean streams read about twice and the dense words
// written once (about 2.5 bytes a stream byte); the symbols of a
// subsequence are decoded in a chain of some hundreds of dependent steps,
// each a table lookup in shared memory and a shift. S trades that chain's
// length against K1's lane count (ops/pack.py SUBSEQ_BITS).
//
// Decoding follows K1 (csrc/wave.cu) exactly: its tables, its first-level
// table of 9 bits built by the same rule, its treatment of a table slot
// or bank outside the group, an invalid code as a code no length matches,
// and bits past a stream read as zero.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstring>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSyncThreads = 128;  // subsequences a block handles at once
constexpr int kFinThreads = 512;
constexpr int kCopyThreads = 256;
constexpr int kMaxSlots = 10;
constexpr int kMaxBanks = 4;
constexpr int kValWords = 89;
constexpr int kValTotal = 356;
constexpr int kLutBits = 9;
constexpr int kLutSize = 1 << kLutBits;
constexpr int kLaneTailBits = 128;  // ops/pack.py LANE_TAIL_BITS
constexpr int kLimitBits = 56;      // the host walk's slack past a stream
#ifndef RJT_SYNC_WARM  // bits decoded ahead of a subsequence for its first
#define RJT_SYNC_WARM 2048  // entry; 0: the plain guess (t * S, 0, 0)
#endif
constexpr long long kWarmBits = RJT_SYNC_WARM;
constexpr unsigned long long kStuck = ~0ull;  // exit after an invalid code

// Columns of the per-image table (ops/pack.py SYNC_IMG_COLS).
enum { I_CLEAN, I_BYTES, I_BANK, I_SUB, I_NSUB, I_DENSE, I_CAP, I_COLS = 8 };
// Columns of a subsequence's record of its last decode.
enum { R_M, R_ML, R_ERRM, R_NB, R_DC, R_BDC = R_DC + 3, R_COLS = R_BDC + 3 };

struct SyncArgs {
  const uint32_t* clean;
  const int32_t* img;
  int n_img, n_sub, n_pad;
  const uint32_t* lentab;
  const uint32_t* values;
  int n_banks, nslots;
  int period;  // a decode's slot wraps here: nslots, or the tables' period
  int dc_slot[kMaxSlots], ac_slot[kMaxSlots], comp[kMaxSlots];
  int subseq_bits, total_mcus, total_blocks, mcu_lo, mcu_hi;
  // scratch (rjt_sync_scratch_bytes)
  unsigned long long* ent;  // entry state of each subsequence's last decode
  unsigned long long* ex;   // its exit state
  int32_t* rec;             // (n_sub, R_COLS)
  long long* bpos;          // first MCU boundary of the decode, or -1
  long long* lane_end;      // bit where a lane's words end
  int32_t* img_used;        // dense words each image's lanes use
  int32_t* flags;           // 3 change counters of the rounds
  // outputs
  int32_t *word_off, *img_base, *mcu_start, *mcu_count, *lane_bank, *dc_flat;
  uint8_t* lane_err;
  int32_t* rejected;  // 1 where any image's scan is rejected, else 0
  int32_t* lane_of_mcu;
  uint32_t* dense;
  long long n_dense;
  int32_t* rounds;  // (most global rounds, most passes within a block)
};

__device__ __forceinline__ unsigned long long pack_state(long long p, int s,
                                                         int k) {
  return (static_cast<unsigned long long>(p) << 16) |
         static_cast<unsigned long long>(s << 8) |
         static_cast<unsigned long long>(k);
}

// The symbol byte of value index (code + base) in table slot `tin` of
// `bank`: K1's symbol_byte.
__device__ __forceinline__ int symbol_byte(const uint32_t* values, int n_banks,
                                           int bank, int tin, int code,
                                           int base) {
  const int sym_idx = (code + base) & 0x7FFF;
  const int toff = tin == 0 ? 0 : (tin == 1 ? 16 : (tin == 2 ? 32 : 194));
  int flat_sym = toff + sym_idx;
  flat_sym = flat_sym < 0 ? 0 : (flat_sym > kValTotal - 1 ? kValTotal - 1
                                                          : flat_sym);
  const int widx = (flat_sym >> 2) + kValWords * bank;
  const uint32_t vword =
      (widx >= 0 && widx < n_banks * kValWords) ? values[widx] : 0u;
  return static_cast<int>((vword >> ((flat_sym & 3) * 8)) & 0xFF);
}

// One image's clean stream: words as staged (bytes in stream order), zero
// past its bytes.
struct Stream {
  const uint32_t* words;
  long long nvalid;  // words holding stream bytes (the rest of the last
                     // one is the unstuffer's zero slack)
  __device__ __forceinline__ uint32_t word(long long i) const {
    return i < nvalid ? __byte_perm(__ldg(words + i), 0, 0x0123) : 0u;
  }
};

struct Tabs {
  const uint16_t* lut;  // [bank * 4 + tin][kLutSize]
  const uint32_t* ub;   // [row][16]: prefix maxima of (maxcode + 1) << (15 - li)
  const uint32_t* lentab;
  const uint32_t* values;
  int n_banks;
};

// K1's decode of the symbol at the top of `win`: n = code length + size.
// Returns false for an invalid code. K1 takes the first length li whose
// code (the window's top li + 1 bits) is below maxcode + 1; that is the
// first li whose (maxcode + 1) << (15 - li) exceeds the window's top 16
// bits, and so the count of the prefix maxima of those bounds that do not
// (tb.ub): a sum of compares in place of K1's loop, so that a warp whose
// threads meet codes of different lengths does not wait on the longest.
__device__ __forceinline__ bool decode_symbol(const Tabs& tb, int bank,
                                              int tin, uint32_t win, int& n,
                                              int& sym) {
  const bool row_ok =
      tin >= 0 && tin < 4 && bank >= 0 && bank < tb.n_banks;
  const uint32_t w16 = win >> 16;
  int trow, li;
  if (row_ok) {
    trow = bank * 4 + tin;
    const uint32_t e = tb.lut[trow * kLutSize + (win >> (32 - kLutBits))];
    if (e) {
      n = static_cast<int>(e >> 8);
      sym = static_cast<int>(e & 0xFF);
      return true;
    }
    // No code of kLutBits bits or fewer: the first length is past them.
    const uint32_t* ub = tb.ub + trow * 16;
    li = kLutBits;
#pragma unroll
    for (int j = kLutBits; j < 16; ++j) li += w16 >= ub[j];
  } else {
    const int nrows = 4 * tb.n_banks;
    const int tslot = tin + 4 * bank;
    trow = (tslot >= 0 && tslot < nrows) ? tslot : nrows - 1;
    const uint32_t* ub = tb.ub + trow * 16;
    li = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) li += w16 >= ub[j];
  }
  if (li >= 16) return false;
  const uint32_t ent = tb.lentab[trow * 16 + li];
  sym = symbol_byte(tb.values, tb.n_banks, bank, tin,
                    static_cast<int>(win >> (31 - li)),
                    static_cast<int>(ent & 0x7FFF));
  n = li + 1 + (sym & 15);
  return true;
}

struct Sub {  // the subsequence a thread handles
  Stream st;
  int bank;
  long long local;  // index within its image
  long long end;    // decode symbols that start before this bit
  long long limit;  // an MCU ending past this bit ends past the stream
  unsigned long long guess;
};

// The image of subsequence t: the last image whose first subsequence is
// at or before t.
__device__ __forceinline__ int image_of(const int32_t* img, int n_img,
                                        int t) {
  int lo = 0, hi = n_img - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (img[mid * I_COLS + I_SUB] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ Sub sub_of(const SyncArgs& a, int t) {
  const int i = image_of(a.img, a.n_img, t);
  const int32_t* r = a.img + i * I_COLS;
  Sub u;
  u.st.words = a.clean + r[I_CLEAN];
  const long long nbytes = r[I_BYTES];
  u.st.nvalid = (nbytes + 3) >> 2;
  u.bank = r[I_BANK];
  u.local = t - r[I_SUB];
  const long long nsub = r[I_NSUB];
  const long long S = a.subseq_bits;
  u.limit = nbytes * 8 + kLimitBits;
  // The last subsequence runs on to every symbol that starts within the
  // walk's limit: whatever MCU completes there is counted.
  u.end = u.local + 1 < nsub ? (u.local + 1) * S
                             : max(nsub * S, u.limit + 1);
  u.guess = pack_state(u.local * S, 0, 0);
  return u;
}

// Decode from `ent` to the first symbol start at or past `end`. Returns
// that state, kStuck after an invalid code. With kRecord, records the
// decode in row `t` of the records.
template <bool kRecord>
__device__ unsigned long long decode_run(const SyncArgs& a, const Tabs& tb,
                                         const int (*geo)[kMaxSlots],
                                         const Sub& u, unsigned long long ent,
                                         long long end, int t) {
  long long p = static_cast<long long>(ent >> 16);
  int s = static_cast<int>((ent >> 8) & 0xFF);
  int k = static_cast<int>(ent & 0xFF);
  long long bpos = (s == 0 && k == 0) ? p : -1;
  int m = 0, ml = 0, nb = 0, errm = INT_MAX;
  uint32_t dc0 = 0, dc1 = 0, dc2 = 0, bdc0 = 0, bdc1 = 0, bdc2 = 0;
  long long wi = p >> 5;
  const int r = static_cast<int>(p & 31);
  uint64_t acc = ((static_cast<uint64_t>(u.st.word(wi)) << 32) |
                  u.st.word(wi + 1))
                 << r;
  int navail = 64 - r;
  wi += 2;
  uint32_t next_w = u.st.word(wi);  // one refill ahead of its use
  unsigned long long exit_state;
  for (;;) {
    if (p >= end) {
      exit_state = pack_state(p, s, k);
      break;
    }
    if (navail <= 32) {
      acc |= static_cast<uint64_t>(next_w) << (32 - navail);
      navail += 32;
      next_w = u.st.word(++wi);
    }
    const uint32_t win = static_cast<uint32_t>(acc >> 32);
    const bool is_dc = k == 0;
    int n = 0, sym = 0;
    if (!decode_symbol(tb, u.bank, is_dc ? geo[0][s] : geo[1][s], win, n,
                       sym)) {
      errm = m;
      exit_state = kStuck;
      break;
    }
    const int size = sym & 15;
    if (is_dc) {
      if (kRecord) {
        const uint32_t mask = (1u << size) - 1u;
        const uint32_t ext = (win >> (32 - n)) & mask;
        const uint32_t val = ext - (ext < ((1u << size) >> 1) ? mask : 0u);
        const int c = geo[2][s];
        dc0 += c == 0 ? val : 0u;
        dc1 += c == 1 ? val : 0u;
        dc2 += c == 2 ? val : 0u;
      }
      k = 1;
    } else {
      const int run = sym >> 4;
      k = size ? k + run + 1 : (run == 15 ? k + 16 : 64);
    }
    acc <<= n;
    navail -= n;
    p += n;
    if (k >= 64) {
      k = 0;
      ++nb;
      if (++s == a.period) {
        s = 0;
        if (kRecord) {
          ++m;
          if (p <= u.limit) ++ml;
          if (bpos < 0 && p < end) {
            bpos = p;
            bdc0 = dc0;
            bdc1 = dc1;
            bdc2 = dc2;
          }
        }
      }
    }
  }
  if (kRecord) {
    int32_t* rec = a.rec + static_cast<long long>(t) * R_COLS;
    rec[R_M] = m;
    rec[R_ML] = ml;
    rec[R_ERRM] = errm;
    rec[R_NB] = nb;
    rec[R_DC] = static_cast<int32_t>(dc0);
    rec[R_DC + 1] = static_cast<int32_t>(dc1);
    rec[R_DC + 2] = static_cast<int32_t>(dc2);
    rec[R_BDC] = static_cast<int32_t>(bdc0);
    rec[R_BDC + 1] = static_cast<int32_t>(bdc1);
    rec[R_BDC + 2] = static_cast<int32_t>(bdc2);
    a.bpos[t] = bpos;
  }
  return exit_state;
}

// A subsequence's decode and record, from `ent` to its end.
__device__ __forceinline__ unsigned long long decode_sub(
    const SyncArgs& a, const Tabs& tb, const int (*geo)[kMaxSlots],
    const Sub& u, unsigned long long ent, int t) {
  return decode_run<true>(a, tb, geo, u, ent, u.end, t);
}

// A subsequence's first entry: the state at the first symbol start at or
// past its start of a decode begun kWarmBits earlier (at the stream's
// start, exactly, where that is closer), which has usually met the true
// symbol boundaries and MCU positions by then; the plain guess after an
// invalid code.
__device__ __forceinline__ unsigned long long first_entry(
    const SyncArgs& a, const Tabs& tb, const int (*geo)[kMaxSlots],
    const Sub& u) {
  if (u.local == 0) return 0ull;
  const long long begin = u.local * a.subseq_bits;
  if (kWarmBits == 0) return u.guess;
  const long long from = begin > kWarmBits ? begin - kWarmBits : 0;
  const unsigned long long ent = decode_run<false>(
      a, tb, geo, u, pack_state(from, 0, 0), begin, 0);
  return ent == kStuck ? u.guess : ent;
}

// K1's tables and the slots' geometry into shared memory (`s_mem`: the
// dynamic shared memory rjt_sync_lanes gives each block of sync_kernel and
// sync_record_kernel), with the first-level table by K1's rule
// (csrc/wave.cu wave_prologue_kernel).
__device__ Tabs load_tables(const SyncArgs& a, uint32_t* s_mem,
                            int (*s_geo)[kMaxSlots]) {
  uint32_t* const s_lentab = s_mem;
  uint32_t* const s_values = s_lentab + 4 * kMaxBanks * 16;
  uint16_t* const s_lut =
      reinterpret_cast<uint16_t*>(s_values + kMaxBanks * kValWords);
  uint32_t* const s_ub =
      reinterpret_cast<uint32_t*>(s_lut + a.n_banks * 4 * kLutSize);
  const int tid = threadIdx.x;
  for (int i = tid; i < 4 * a.n_banks * 16; i += kSyncThreads)
    s_lentab[i] = a.lentab[i];
  for (int i = tid; i < a.n_banks * kValWords; i += kSyncThreads)
    s_values[i] = a.values[i];
  for (int i = tid; i < kMaxSlots; i += kSyncThreads) {
    s_geo[0][i] = a.dc_slot[i];
    s_geo[1][i] = a.ac_slot[i];
    s_geo[2][i] = a.comp[i];
  }
  for (int e = tid; e < a.n_banks * 4 * kLutSize; e += kSyncThreads) {
    const int row = e / kLutSize;
    const int prefix = e % kLutSize;
    uint16_t entry = 0;
    for (int li = 0; li < kLutBits; ++li) {
      const int cand = prefix >> (kLutBits - 1 - li);
      const uint32_t ent = a.lentab[row * 16 + li];
      if (cand < static_cast<int>(ent >> 15)) {
        const int sym = symbol_byte(a.values, a.n_banks, row >> 2, row & 3,
                                    cand, static_cast<int>(ent & 0x7FFF));
        entry = static_cast<uint16_t>(((li + 1 + (sym & 15)) << 8) | sym);
        break;
      }
    }
    s_lut[e] = entry;
  }
  for (int row = tid; row < 4 * a.n_banks; row += kSyncThreads) {
    uint32_t most = 0;
    for (int li = 0; li < 16; ++li) {
      const uint32_t b = (a.lentab[row * 16 + li] >> 15) << (15 - li);
      most = b > most ? b : most;
      s_ub[row * 16 + li] = most;
    }
  }
  __syncthreads();
  return Tabs{s_lut, s_ub, s_lentab, s_values, a.n_banks};
}

// The fixed point of every subsequence's entry, in rounds of the whole
// grid (a cooperative launch: every block is resident).
__global__ void __launch_bounds__(kSyncThreads) sync_kernel(SyncArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ uint32_t s_mem[];
  __shared__ unsigned long long s_ex[kSyncThreads];
  __shared__ int s_geo[3][kMaxSlots];
  const int tid = threadIdx.x;
  const Tabs tb = load_tables(a, s_mem, s_geo);

  const int n_tiles = (a.n_sub + kSyncThreads - 1) / kSyncThreads;
  int most_passes = 0;
  for (int round = 0;; ++round) {
    int changed = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int t = tile * kSyncThreads + tid;
      const bool valid = t < a.n_sub;
      Sub u{};
      unsigned long long ent = 0, ex = kStuck;
      if (valid) {
        u = sub_of(a, t);
        if (round == 0) {
          ent = first_entry(a, tb, s_geo, u);
          ex = decode_sub(a, tb, s_geo, u, ent, t);
          __stcg(a.ent + t, ent);
          __stcg(a.ex + t, ex);
          changed = 1;
        } else {
          ent = __ldcg(a.ent + t);
          ex = __ldcg(a.ex + t);
        }
      }
      s_ex[tid] = ex;
      for (int pass = 1;; ++pass) {
        __syncthreads();
        unsigned long long want = ent;
        if (valid && u.local > 0) {
          const unsigned long long left =
              tid > 0 ? s_ex[tid - 1] : __ldcg(a.ex + t - 1);
          want = left == kStuck ? u.guess : left;
        }
        const bool ch = want != ent;
        __syncthreads();  // every read of s_ex before any write
        if (ch) {
          ent = want;
          ex = decode_sub(a, tb, s_geo, u, ent, t);
          __stcg(a.ent + t, ent);
          __stcg(a.ex + t, ex);
          s_ex[tid] = ex;
          changed = 1;
        }
        if (!__syncthreads_or(ch)) {
          most_passes = max(most_passes, pass);
          break;
        }
      }
    }
    // Round r counts its changes in flags[r % 3] and clears the counter
    // round r + 1 will use, which every thread read before round r began.
    const int block_changed = __syncthreads_or(changed);
    if (tid == 0) {
      if (block_changed) atomicAdd(&a.flags[round % 3], 1);
      if (blockIdx.x == 0) a.flags[(round + 1) % 3] = 0;
    }
    grid.sync();
    if (__ldcg(&a.flags[round % 3]) == 0) {
      if (tid == 0) {
        if (blockIdx.x == 0) atomicMax(&a.rounds[0], round + 1);
        atomicMax(&a.rounds[1], most_passes);
      }
      break;
    }
  }
}

// Block-wide exclusive sums of four int32 (wrapping) over kFinThreads.
struct Sum4 {
  uint32_t v[4];
};

__device__ __forceinline__ Sum4 block_scan4(Sum4 x, Sum4& total,
                                            Sum4* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Sum4 incl = x;
  for (int d = 1; d < 32; d <<= 1)
    for (int j = 0; j < 4; ++j) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl.v[j], d);
      if (lane >= d) incl.v[j] += y;
    }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  Sum4 before{}, all{};
  for (int w = 0; w < kFinThreads / 32; ++w)
    for (int j = 0; j < 4; ++j) {
      if (w < warp) before.v[j] += s_warp[w].v[j];
      all.v[j] += s_warp[w].v[j];
    }
  __syncthreads();  // s_warp is free for the next scan
  Sum4 excl;
  for (int j = 0; j < 4; ++j) excl.v[j] = before.v[j] + incl.v[j] - x.v[j];
  total = all;
  return excl;
}

// Where the slots' tables repeat within the MCU (a.period < a.nslots), one
// block an image: each subsequence's entry gets its true slot, the blocks
// its image's earlier subsequences completed modulo the MCU's slots.
__global__ void __launch_bounds__(kFinThreads) sync_phase_kernel(SyncArgs a) {
  __shared__ Sum4 s_warp[kFinThreads / 32];
  const int32_t* r = a.img + blockIdx.x * I_COLS;
  const int f = r[I_SUB], T = r[I_NSUB];
  uint32_t carry = 0;  // blocks of an image stay below 2^32
  for (int c0 = 0; c0 < T; c0 += kFinThreads) {
    const int t = f + c0 + static_cast<int>(threadIdx.x);
    const bool valid = c0 + static_cast<int>(threadIdx.x) < T;
    Sum4 x{}, tot;
    if (valid)
      x.v[0] = static_cast<uint32_t>(
          a.rec[static_cast<long long>(t) * R_COLS + R_NB]);
    const Sum4 ex = block_scan4(x, tot, s_warp);
    if (valid) {
      const unsigned long long s = (carry + ex.v[0]) % a.nslots;
      a.ent[t] = (a.ent[t] & ~0xFF00ull) | (s << 8);
    }
    carry += tot.v[0];
  }
}

// Each subsequence's records, decoded once from its exact entry.
__global__ void __launch_bounds__(kSyncThreads) sync_record_kernel(
    SyncArgs a) {
  extern __shared__ uint32_t s_mem[];
  __shared__ int s_geo[3][kMaxSlots];
  const Tabs tb = load_tables(a, s_mem, s_geo);
  const int t = blockIdx.x * kSyncThreads + threadIdx.x;
  if (t < a.n_sub) decode_sub(a, tb, s_geo, sub_of(a, t), a.ent[t], t);
}

// One block an image (the last block: the padding lanes). Pass 1 scans the
// MCUs and DC differences of the image's subsequences into each lane's
// first MCU and entering predictors and decides the image's error; pass 2
// gives each lane its MCU count, its bits and its first dense word.
__global__ void __launch_bounds__(kFinThreads) sync_finalize_kernel(
    SyncArgs a) {
  __shared__ Sum4 s_warp[kFinThreads / 32];
  __shared__ int s_err;
  __shared__ unsigned long long s_ml;
  const int tid = threadIdx.x;
  if (blockIdx.x == a.n_img) {
    for (int t = a.n_sub + tid; t < a.n_pad; t += kFinThreads) {
      a.word_off[t] = 0;
      a.img_base[t] = 0;
      a.mcu_start[t] = 0;
      a.mcu_count[t] = 0;
      a.lane_bank[t] = 0;
      a.dc_flat[t * 3] = a.dc_flat[t * 3 + 1] = a.dc_flat[t * 3 + 2] = 0;
      a.lane_err[t] = 0;
    }
    return;
  }
  const int i = blockIdx.x;
  const int32_t* r = a.img + i * I_COLS;
  const int f = r[I_SUB], T = r[I_NSUB];
  const long long nbits = static_cast<long long>(r[I_BYTES]) * 8;
  const long long total = a.total_mcus;
  if (tid == 0) {
    s_err = 0;
    s_ml = 0;
  }
  __syncthreads();

  // Pass 1: G (MCUs before each entry) and D (DC sums before it).
  Sum4 carry{};
  long long ml = 0;
  bool err = false;
  for (int c0 = 0; c0 < T; c0 += kFinThreads) {
    const int t = f + c0 + tid;
    const bool valid = c0 + tid < T;
    const int32_t* rec = a.rec + static_cast<long long>(t) * R_COLS;
    Sum4 x{};
    if (valid) {
      x.v[0] = static_cast<uint32_t>(rec[R_M]);
      for (int c = 0; c < 3; ++c) x.v[1 + c] = static_cast<uint32_t>(rec[R_DC + c]);
    }
    Sum4 tot;
    const Sum4 ex = block_scan4(x, tot, s_warp);
    if (valid) {
      const long long g = static_cast<long long>(carry.v[0]) + ex.v[0];
      const unsigned long long ent = a.ent[t];
      const long long start = g + ((ent & 0xFFFFull) == 0 ? 0 : 1);
      a.mcu_start[t] = static_cast<int32_t>(start < total ? start : total);
      const int errm = rec[R_ERRM];
      if (errm != INT_MAX && g + errm < total) err = true;
      ml += rec[R_ML];
      for (int c = 0; c < 3; ++c)
        a.dc_flat[t * 3 + c] = static_cast<int32_t>(
            carry.v[1 + c] + ex.v[1 + c] + static_cast<uint32_t>(rec[R_BDC + c]));
    }
    for (int j = 0; j < 4; ++j) carry.v[j] += tot.v[j];
  }
  // G never wraps: the MCUs of all subsequences stay below 2^31 (a
  // subsequence completes at most S MCUs; a stream has fewer than 2^31
  // bits). The walk's limit: fewer than `total` MCUs ending within it.
  atomicAdd(&s_ml, static_cast<unsigned long long>(ml));
  if (err) s_err = 1;
  __syncthreads();
  err = s_err || static_cast<long long>(s_ml) < total;

  // Pass 2: MCU counts, lane bits, words.
  const int dense0 = r[I_DENSE];
  uint32_t wcarry = 0;
  for (int c0 = 0; c0 < T; c0 += kFinThreads) {
    const int t = f + c0 + tid;
    const bool valid = c0 + tid < T;
    int count = 0;
    long long b = 0, e = 0;
    if (valid && !err) {
      const int start = a.mcu_start[t];
      const int nxt = c0 + tid + 1 < T ? a.mcu_start[t + 1]
                                        : static_cast<int>(total);
      count = nxt > start ? nxt - start : 0;
      if (count > 0) {
        b = a.bpos[t];
        if (nxt >= total) {
          e = nbits + kLaneTailBits;
        } else {
          // The lane that starts at MCU nxt: the last one starting at or
          // before it.
          int lo = t + 1, hi = f + T - 1;
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (a.mcu_start[mid] <= nxt) lo = mid; else hi = mid - 1;
          }
          e = a.bpos[lo];
        }
        if (b < 0 || e < b) count = 0;  // not a consistent decode
        if (start >= a.mcu_hi || start + count <= a.mcu_lo) count = 0;
      }
    }
    Sum4 x{}, tot;
    x.v[0] = count > 0 ? static_cast<uint32_t>((e - b + 31) >> 5) : 0u;
    const Sum4 ex = block_scan4(x, tot, s_warp);
    if (valid) {
      a.word_off[t] = dense0 + static_cast<int32_t>(wcarry + ex.v[0]);
      a.img_base[t] = i * a.total_blocks;
      a.lane_bank[t] = r[I_BANK];
      a.mcu_count[t] = count;
      a.lane_err[t] = err ? 1 : 0;
      a.lane_end[t] = e;  // read with bpos only where count > 0
      if (count == 0)
        a.dc_flat[t * 3] = a.dc_flat[t * 3 + 1] = a.dc_flat[t * 3 + 2] = 0;
    }
    wcarry += tot.v[0];
  }
  if (err) {
    __syncthreads();  // every read of mcu_start done
    for (int t = f + tid; t < f + T; t += kFinThreads) a.mcu_start[t] = 0;
    if (tid == 0) a.rejected[0] = 1;
  }
  if (tid == 0) a.img_used[i] = static_cast<int32_t>(wcarry);
}

// Each lane's bits into the dense stream, a warp a lane; the words no lane
// uses set to zero; then lane_of_mcu.
__global__ void __launch_bounds__(kCopyThreads) sync_copy_kernel(SyncArgs a) {
  const int lane_id = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kCopyThreads + threadIdx.x) >> 5;
  const long long n_warps =
      static_cast<long long>(gridDim.x) * kCopyThreads >> 5;
  for (long long t = warp; t < a.n_sub; t += n_warps) {
    if (a.mcu_count[t] <= 0) continue;
    const int i = image_of(a.img, a.n_img, static_cast<int>(t));
    const int32_t* r = a.img + i * I_COLS;
    Stream st{a.clean + r[I_CLEAN], (static_cast<long long>(r[I_BYTES]) + 3) >> 2};
    const long long b = a.bpos[t], e = a.lane_end[t];
    const long long n = (e - b + 31) >> 5;
    uint32_t* out = a.dense + a.word_off[t];
    for (long long j = lane_id; j < n; j += 32) {
      const long long bit = b + 32 * j;
      const long long wi = bit >> 5;
      const int sh = static_cast<int>(bit & 31);
      const uint32_t hi = st.word(wi);
      uint32_t v = sh ? (hi << sh) | (st.word(wi + 1) >> (32 - sh)) : hi;
      const long long rem = e - bit;
      if (rem < 32) v &= ~0u << (32 - rem);
      out[j] = v;
    }
  }
  // Unused words: each image's past its lanes', and the zero tail.
  for (long long i = warp; i <= a.n_img; i += n_warps) {
    long long lo, hi;
    if (i < a.n_img) {
      const int32_t* r = a.img + i * I_COLS;
      lo = static_cast<long long>(r[I_DENSE]) + a.img_used[i];
      hi = static_cast<long long>(r[I_DENSE]) + r[I_CAP];
    } else {
      const int32_t* r = a.img + (a.n_img - 1) * I_COLS;
      lo = static_cast<long long>(r[I_DENSE]) + r[I_CAP];
      hi = a.n_dense;
    }
    for (long long w = lo + lane_id; w < hi; w += 32) a.dense[w] = 0u;
  }
  // lane_of_mcu[i, m]: the last lane of image i starting at or before m.
  const long long n_cells = static_cast<long long>(a.n_img) * a.total_mcus;
  for (long long c = static_cast<long long>(blockIdx.x) * kCopyThreads +
                     threadIdx.x;
       c < n_cells; c += static_cast<long long>(gridDim.x) * kCopyThreads) {
    const int i = static_cast<int>(c / a.total_mcus);
    const int m = static_cast<int>(c - static_cast<long long>(i) * a.total_mcus);
    const int32_t* r = a.img + i * I_COLS;
    int lo = r[I_SUB], hi = r[I_SUB] + r[I_NSUB] - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (a.mcu_start[mid] <= m) lo = mid; else hi = mid - 1;
    }
    a.lane_of_mcu[c] = lo;
  }
}

// Bytes of scratch for n_sub subsequences and n_img images, each piece at
// a 256-byte offset.
size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

size_t scratch_layout(int n_sub, int n_img, SyncArgs* a, char* base) {
  const size_t ns = static_cast<size_t>(n_sub > 0 ? n_sub : 1);
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  char* ent = take(ns * 8);
  char* ex = take(ns * 8);
  char* rec = take(ns * R_COLS * 4);
  char* bpos = take(ns * 8);
  char* lane_end = take(ns * 8);
  char* used = take(static_cast<size_t>(n_img) * 4);
  char* flags = take(3 * 4);
  if (a) {
    a->ent = reinterpret_cast<unsigned long long*>(ent);
    a->ex = reinterpret_cast<unsigned long long*>(ex);
    a->rec = reinterpret_cast<int32_t*>(rec);
    a->bpos = reinterpret_cast<long long*>(bpos);
    a->lane_end = reinterpret_cast<long long*>(lane_end);
    a->img_used = reinterpret_cast<int32_t*>(used);
    a->flags = reinterpret_cast<int32_t*>(flags);
  }
  return off;
}

// Per device and table banks, (blocks of sync_kernel resident at once,
// SMs), asked of the runtime once: 0 until then.
constexpr int kMaxDevices = 64;
std::atomic<int> g_resident[kMaxDevices][kMaxBanks + 1];
std::atomic<int> g_sms[kMaxDevices];

// Blocks of sync_kernel resident at once on the current device, for its
// dynamic shared memory at n_banks, and the device's SMs.
int resident_blocks(int n_banks, size_t smem, int* resident, int* sms) {
  int device = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && g_resident[device][n_banks].load() > 0) {
    *resident = g_resident[device][n_banks].load();
    *sms = g_sms[device].load();
    return 0;
  }
  int per_sm = 0;
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sync_kernel,
                                                       kSyncThreads, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *resident = per_sm * *sms;
  if (cached && *resident > 0) {
    g_sms[device].store(*sms);
    g_resident[device][n_banks].store(*resident);
  }
  return 0;
}

}  // namespace

// Scratch bytes rjt_sync_lanes needs for n_sub subsequences of n_img
// images.
extern "C" int rjt_sync_scratch_bytes(int n_sub, int n_img) {
  return static_cast<int>(scratch_layout(n_sub, n_img, nullptr, nullptr));
}

// The lane table of one DRI=0 group (kernels/sync.py). geom_tab: host
// int32 [3][nslots] (dc slot, ac slot, component of each block slot).
// Launches sync_kernel cooperatively, then the finalize and copy kernels,
// all on `stream`. Returns cudaGetLastError() or the launch's error.
extern "C" int rjt_sync_lanes(
    const void* clean, int64_t n_clean, const void* img, int n_img,
    int n_sub, int n_pad, const void* lentab, const void* values,
    int n_banks, const void* geom_tab, int nslots, int period,
    int subseq_bits,
    int total_mcus, int total_blocks, int mcu_lo, int mcu_hi, void* scratch,
    void* word_off, void* img_base, void* mcu_start, void* mcu_count,
    void* lane_bank, void* dc_flat, void* lane_err, void* rejected,
    void* lane_of_mcu, void* dense, int64_t n_dense, void* rounds,
    void* stream) {
  if (n_img < 1 || n_sub < n_img || n_pad < n_sub || nslots < 1 ||
      nslots > kMaxSlots || period < 1 || nslots % period != 0 ||
      n_banks < 1 || n_banks > kMaxBanks ||
      subseq_bits < 32 || total_mcus < 1 || n_clean < 1 || n_dense < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SyncArgs a;
  std::memset(&a, 0, sizeof(a));
  a.clean = static_cast<const uint32_t*>(clean);
  a.img = static_cast<const int32_t*>(img);
  a.n_img = n_img;
  a.n_sub = n_sub;
  a.n_pad = n_pad;
  a.lentab = static_cast<const uint32_t*>(lentab);
  a.values = static_cast<const uint32_t*>(values);
  a.n_banks = n_banks;
  a.nslots = nslots;
  a.period = period;
  const int32_t* tab = static_cast<const int32_t*>(geom_tab);
  for (int s = 0; s < nslots; ++s) {
    a.dc_slot[s] = tab[s];
    a.ac_slot[s] = tab[nslots + s];
    a.comp[s] = tab[2 * nslots + s];
  }
  a.subseq_bits = subseq_bits;
  a.total_mcus = total_mcus;
  a.total_blocks = total_blocks;
  a.mcu_lo = mcu_lo;
  a.mcu_hi = mcu_hi;
  scratch_layout(n_sub, n_img, &a, static_cast<char*>(scratch));
  a.word_off = static_cast<int32_t*>(word_off);
  a.img_base = static_cast<int32_t*>(img_base);
  a.mcu_start = static_cast<int32_t*>(mcu_start);
  a.mcu_count = static_cast<int32_t*>(mcu_count);
  a.lane_bank = static_cast<int32_t*>(lane_bank);
  a.dc_flat = static_cast<int32_t*>(dc_flat);
  a.lane_err = static_cast<uint8_t*>(lane_err);
  a.rejected = static_cast<int32_t*>(rejected);
  a.lane_of_mcu = static_cast<int32_t*>(lane_of_mcu);
  a.dense = static_cast<uint32_t*>(dense);
  a.n_dense = n_dense;
  a.rounds = static_cast<int32_t*>(rounds);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // Exits read before their subsequence's first decode read as "stuck";
  // round 0 counts its changes in flags[0].
  cudaError_t rc = cudaMemsetAsync(a.ex, 0xFF, static_cast<size_t>(n_sub) * 8, st);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(a.flags, 0, 3 * 4, st);
  if (rc == cudaSuccess) rc = cudaMemsetAsync(a.rejected, 0, 4, st);
  if (rc != cudaSuccess) return static_cast<int>(rc);

  const size_t smem =
      (4 * kMaxBanks * 16 + kMaxBanks * kValWords) * sizeof(uint32_t) +
      static_cast<size_t>(n_banks) * 4 *
          (kLutSize * sizeof(uint16_t) + 16 * sizeof(uint32_t));
  int resident = 0, sms = 0;
  const int err = resident_blocks(n_banks, smem, &resident, &sms);
  if (err != 0) return err;
  const int n_tiles = (n_sub + kSyncThreads - 1) / kSyncThreads;
  const int grid = n_tiles < resident ? n_tiles : resident;
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  void* args[] = {&a};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sync_kernel),
                                   dim3(grid), dim3(kSyncThreads), args, smem,
                                   st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (period < nslots) {
    sync_phase_kernel<<<n_img, kFinThreads, 0, st>>>(a);
    a.period = nslots;
    sync_record_kernel<<<n_tiles, kSyncThreads, smem, st>>>(a);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }

  sync_finalize_kernel<<<n_img + 1, kFinThreads, 0, st>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);

  const long long warps = n_sub > n_img + 1 ? n_sub : n_img + 1;
  long long blocks = (warps * 32 + kCopyThreads - 1) / kCopyThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  sync_copy_kernel<<<static_cast<int>(blocks), kCopyThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
