// K1 — wave entropy decode on Hopper.
//
// Replaces the TPU kernel rocjpeg_tpu/kernels/wave_pallas.py
// (build_wave_kernel, with refill / consume / decode_symbol of
// kernels/wave_common.py), and absorbs the two XLA programs around it:
// the lane-major word expansion (ops/device_entropy.py _expand_words) and
// the scatter of the emission buffers (_scatter_epilogue).
//
// What bounds it: bytes. The function reads the dense word stream, five
// int32 per lane and the tables once, and writes every int16 coefficient
// of the group once: out_size * 2 + n_dense * 4 + n_lanes * 21 bytes. For
// 8 frames of 3840x2160 4:2:0 that is 199.07 MB of output beside about
// 8 MB of scan and 1.4 MB of lane arrays, 0.062 ms at 3.35 TB/s. The
// arithmetic (about 5 symbols a block) is small beside that. What keeps a
// kernel away from the bound is the serial chain inside a lane (each
// symbol's length decides where the next one starts) and, with one thread
// a lane, how few warps a group gives the card: 2,032 for 65,024 restart
// lanes (15 a SM), 288 for 9,216 virtual lanes (2 a SM). A step is some
// hundreds of instructions once every branch that some lane of the warp
// takes is counted, and a scheduler that holds one warp waits out each of
// them. So each step has to be short, and the output has to cross DRAM
// once.
//
// Design:
//  - One thread per lane; lane state (64-bit bit window, MCU walk, DC
//    predictors) in registers. Threads per block follow the lane count so
//    that a small group still reaches every SM (rjt_wave_decode).
//  - The kernel owns the zeroes. A thread assembles its current 8x8 block
//    in a 128-byte tile of shared memory (chunks XOR-swizzled by thread so
//    that neither the 2-byte writes nor the 16-byte reads pile onto one
//    bank). When the block ends the tile goes out as one full 128-byte
//    row with 16-byte stores and is zeroed again. The output is allocated
//    uninitialised: no separate fill, no partial-sector stores into it.
//    Two flushes, chosen from the lane count (rjt_wave_decode): in a group
//    that fills the card the warp shares the work, eight threads a block,
//    so neighbouring threads write neighbouring addresses; in a group of
//    few lanes, where a scheduler holds one warp and every instruction of
//    a step is waited for, each thread stores its own tile, which takes
//    neither a vote nor a warp barrier.
//    Blocks no lane decodes stay right all the same: a lane that stops on
//    an error or at max_steps flushes its partial block as it stands and
//    zero-fills the rest of its MCUs; and a prologue kernel sums the
//    lanes' MCU counts and zero-fills the whole output when they do not
//    cover every MCU of the group (an ROI pack) or when the caller says
//    the scan does not hold every component (expected_mcus < 0). Lanes own
//    disjoint MCU ranges; that is the packer's contract.
//  - One lookup for the common codes. The prologue kernel builds, from
//    lentab and values and by the very rule of the search below, a table
//    indexed by (table row, top RJT_WAVE_LUT_BITS bits of the window) that
//    gives (code length + size, symbol byte); blocks copy it to shared
//    memory. A prefix with no code that short falls through to the search,
//    which then starts at the first length the table does not cover; a
//    table slot outside 0..3 or a bank outside the group takes the whole
//    16-step search.
//  - The words of a lane travel ahead of their use: the next one waits in
//    a register, the two after it are on their way by cp.async into a
//    small ring in shared memory (RJT_WAVE_PREFETCH 2). A lane's words are
//    consecutive, so the 32-byte sector a copy brings serves the lane's
//    next copies from L1.
//  - What a step needs of its block (its place in the output, its
//    component, its table rows) is loaded when the block begins, not at
//    every step.
//  - TMA and wgmma have no use here: there is no tile of a matrix to copy
//    and no product to take.
//
// The RJT_WAVE_* macros exist so that each of these steps can be timed
// alone against the first version of this kernel (kernels/k1_steps.py of
// the package builds the variants); their defaults are the fastest
// combination measured and the only one the package builds.
//
// Semantics kept from the TPU kernel, so error flags and outputs agree:
//  - words at or past n_words read as zero; words before it are
//    dense[clamp(word_off + j, 0, W - 1)];
//  - the bit window is 64 bits wide, so no 32-bit shift by >= 32 occurs:
//    a refill ors the word in at 32 - navail, a consume shifts by 1..31;
//  - the written DC value is the int32 predictor truncated to int16;
//  - at most max_steps symbols per lane; at exit err |= MCUs left; a lane
//    stops once it errs or runs out of MCUs (the symbol that errs is still
//    written and advanced, as on the TPU);
//  - an invalid code decodes as length 1, code 0, base 0;
//  - a table slot outside the group's rows reads the last row;
//  - a block whose first index falls outside the output is dropped.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#ifndef RJT_WAVE_FLUSH     // 0: scatter 2-byte stores into a zero-filled
#define RJT_WAVE_FLUSH 3   //    output; 1: each thread flushes its own
#endif                     //    tile; 2: the warp flushes together; 3: 2 for
                           //    a group that fills the card, else 1
#ifndef RJT_WAVE_LUT_BITS  // 0: no first-level table
#define RJT_WAVE_LUT_BITS 9
#endif
#ifndef RJT_WAVE_PREFETCH  // 0: load each word when the window needs it;
#define RJT_WAVE_PREFETCH 2  // 1: one word ahead, into a register; 2: one
#endif                       //    there and two more on their way by cp.async
#ifndef RJT_WAVE_THREADS   // 0: from the lane count; else 32, 64 or 128
#define RJT_WAVE_THREADS 0
#endif
#ifndef RJT_WAVE_BLOCK_AHEAD  // 1: what a step needs of its block is loaded
#define RJT_WAVE_BLOCK_AHEAD 1  //    when the block begins; 0: at every step
#endif

namespace {

constexpr int kMaxThreads = 128;
constexpr int kMaxSlots = 10;  // baseline JPEG: sum of H*V per MCU <= 10
constexpr int kMaxBanks = 4;
constexpr int kValWords = 89;
constexpr int kValTotal = 356;
constexpr int kLutBits = RJT_WAVE_LUT_BITS;
constexpr int kLutSize = kLutBits ? (1 << kLutBits) : 0;
constexpr int kPrologueThreads = 1024;
constexpr int kRing = RJT_WAVE_PREFETCH == 2 ? 4 : 0;  // words per lane
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
// From this many warps a SM on, the warp's shared flush: where the two
// flushes were measured to cross (kernels/k1_steps.py).
constexpr int kWarpFlushWarpsPerSm = 8;

enum { G_FLAT, G_ROW, G_COL, G_DC, G_AC, G_COMP, G_FIELDS };

struct WaveGeom {
  int nslots;
  int mcus_w;
  int tab[G_FIELDS][kMaxSlots];
};

__constant__ int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// The symbol byte of value index (code + base) in table slot `tin` of
// `bank`, from a packed value table of n_banks banks.
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

// Before the wave: the first-level code table, and the zeroes of an output
// the lanes will not cover.
__global__ void __launch_bounds__(kPrologueThreads) wave_prologue_kernel(
    const int32_t* __restrict__ mcu_count, int n_lanes, long long expected_mcus,
    const uint32_t* __restrict__ lentab, const uint32_t* __restrict__ values,
    int n_banks, uint16_t* __restrict__ lut, uint4* __restrict__ out16,
    long long n_out16) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nthreads = static_cast<long long>(gridDim.x) * blockDim.x;

#if RJT_WAVE_LUT_BITS
  // ((code length + size) << 8 | symbol) of the code that starts each
  // kLutBits-bit prefix, 0 where no code is that short.
  for (long long e = tid; e < static_cast<long long>(n_banks) * 4 * kLutSize;
       e += nthreads) {
    const int row = static_cast<int>(e / kLutSize);
    const int prefix = static_cast<int>(e % kLutSize);
    uint16_t entry = 0;
    for (int li = 0; li < kLutBits; ++li) {
      const int cand = prefix >> (kLutBits - 1 - li);
      const uint32_t ent = lentab[row * 16 + li];
      if (cand < static_cast<int>(ent >> 15)) {
        const int sym = symbol_byte(values, n_banks, row >> 2, row & 3, cand,
                                    static_cast<int>(ent & 0x7FFF));
        entry = static_cast<uint16_t>(((li + 1 + (sym & 15)) << 8) | sym);
        break;
      }
    }
    lut[e] = entry;
  }
#endif

  // Every block sums the lanes' MCU counts for itself: no second launch
  // and no wait between blocks.
  bool fill = expected_mcus < 0;
  if (!fill) {
    __shared__ long long s_part[kPrologueThreads / 32];
    long long sum = 0;
    for (int l = threadIdx.x; l < n_lanes; l += blockDim.x)
      sum += max(mcu_count[l], 0);
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_down_sync(kFullWarp, sum, d);
    if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = sum;
    __syncthreads();
    long long total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w)
      total += s_part[w];
    fill = total != expected_mcus;
  }
  if (fill) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (long long i = tid; i < n_out16; i += nthreads) out16[i] = zero;
  }
}

// threadIdx.x, read once: the compiler would rather read the special
// register again at every use than keep it, and that read is slow.
__device__ __forceinline__ int thread_in_block() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

template <int kFlush>  // how coefficients reach the output: RJT_WAVE_FLUSH
__global__ void __launch_bounds__(kMaxThreads) wave_kernel(
    const uint32_t* __restrict__ dense, int64_t n_dense,
    const int32_t* __restrict__ word_off, const int32_t* __restrict__ img_base,
    const int32_t* __restrict__ mcu_start,
    const int32_t* __restrict__ mcu_count,
    const int32_t* __restrict__ lane_bank, int n_lanes,
    const uint32_t* __restrict__ lentab, const uint32_t* __restrict__ values,
    const uint16_t* __restrict__ lut, int n_banks, WaveGeom g, int n_words,
    int max_steps, int64_t out_size, int16_t* __restrict__ out,
    uint8_t* __restrict__ err_out) {
  // Dynamic shared memory, in this order (rjt_wave_decode sizes it): one
  // 128-byte tile per thread, one (tile, block) pair per thread for the
  // warp's flush, the ring of words on their way ([slot][thread]), the
  // first-level table, then the fixed-size tables.
  extern __shared__ uint4 s_mem[];
  const int tid = thread_in_block();
  const int nthreads = blockDim.x;
  uint4* const s_tile = s_mem;
  int2* const s_src = reinterpret_cast<int2*>(s_tile + nthreads * 8);
  uint32_t* const s_ring = reinterpret_cast<uint32_t*>(s_src + nthreads);
  uint16_t* const s_lut =
      reinterpret_cast<uint16_t*>(s_ring + kRing * nthreads);
  uint32_t* const s_lentab =
      reinterpret_cast<uint32_t*>(s_lut + n_banks * 4 * kLutSize);
  uint32_t* const s_values = s_lentab + 4 * kMaxBanks * 16;
  int* const s_zig = reinterpret_cast<int*>(s_values + kMaxBanks * kValWords);
  int(*const s_geo)[kMaxSlots] =
      reinterpret_cast<int(*)[kMaxSlots]>(s_zig + 64);
  // Byte offset into s_lut of the table row of slot s, for its DC symbol
  // ([s]) and its AC symbols ([kMaxSlots + s]); far below zero for a table
  // slot outside 0..3.
  int* const s_lutrow = &s_geo[G_FIELDS][0];
  constexpr int kNoRow = -(1 << 28);

  for (int i = tid; i < 4 * n_banks * 16; i += nthreads)
    s_lentab[i] = lentab[i];
  for (int i = tid; i < n_banks * kValWords; i += nthreads)
    s_values[i] = values[i];
  for (int i = tid; i < 64; i += nthreads) s_zig[i] = kZigzag[i];
  for (int i = tid; i < G_FIELDS * kMaxSlots; i += nthreads)
    s_geo[i / kMaxSlots][i % kMaxSlots] = g.tab[i / kMaxSlots][i % kMaxSlots];
  for (int i = tid; i < 2 * kMaxSlots; i += nthreads) {
    const int tin = g.tab[i < kMaxSlots ? G_DC : G_AC][i % kMaxSlots];
    s_lutrow[i] = (tin >= 0 && tin < 4) ? tin * kLutSize * 2 : kNoRow;
  }
  // n_banks * 4 * kLutSize uint16 is a whole number of uint4.
  for (int i = tid; i < n_banks * 4 * kLutSize / 8; i += nthreads)
    reinterpret_cast<uint4*>(s_lut)[i] =
        reinterpret_cast<const uint4*>(lut)[i];
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  uint4* const tile = s_tile + tid * 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) tile[i] = zero4;
  __syncthreads();

  // Logical 16-byte chunk c of a thread's tile sits at chunk c ^ swz, so
  // coefficient z (natural order) sits at int16 index z ^ (swz << 3).
  const int swz = tid & 7;
  int16_t* const tile16 = reinterpret_cast<int16_t*>(tile);
  uint4* const out16 = reinterpret_cast<uint4*>(out);
  // A block's first index is in range iff it is below this, as uint32.
  const uint32_t out_limit = static_cast<uint32_t>(
      out_size < (int64_t{1} << 31) ? out_size : (int64_t{1} << 31));

  // Threads past the last lane own nothing; they stay for the warp's votes.
  const int l = blockIdx.x * nthreads + tid;
  const bool has_lane = l < n_lanes;
  const int nrows = 4 * n_banks;
  const int bank = (has_lane && lane_bank) ? lane_bank[l] : 0;
  const int bank_row =
      (bank >= 0 && bank < n_banks) ? bank * 4 * kLutSize * 2 : kNoRow;
  const uint32_t base_img = has_lane ? static_cast<uint32_t>(img_base[l]) : 0u;
  const int ms = has_lane ? mcu_start[l] : 0;
  int mcu_rem = has_lane ? mcu_count[l] : 0;
  int mx = ms % g.mcus_w;
  int my = ms / g.mcus_w;

  // Word j of the lane is dense[clamp(word_off + j, 0, W - 1)], which is
  // dense[woff + clamp(j, j_lo, j_hi)]: two 32-bit min/max a word. A start
  // below -2^30 clamps every word to 0 just as -2^30 does (j < 2^30).
  const int64_t woff = has_lane ? max(word_off[l], -(1 << 30)) : 0;
  const int j_lo = static_cast<int>(-woff);
  const int64_t last = n_dense - 1 - woff;
  const int j_hi = last < 0x7FFFFFFF ? static_cast<int>(last) : 0x7FFFFFFF;
  const uintptr_t lane_words =
      reinterpret_cast<uintptr_t>(dense) + static_cast<uintptr_t>(woff * 4);
  auto word_at = [&](int j) -> const uint32_t* {
    return reinterpret_cast<const uint32_t*>(
        lane_words + static_cast<int64_t>(min(max(j, j_lo), j_hi)) * 4);
  };
  auto load_word = [&](int j) -> uint32_t {
    return j < n_words ? *word_at(j) : 0u;
  };
#if RJT_WAVE_PREFETCH == 2
  // Word j travels to slot j % kRing of the lane's ring as one cp.async
  // group. A load that a register waits for would stall the whole warp at
  // the next refill of any of its lanes (and some lane refills at almost
  // every step); an asynchronous copy is waited for by group, and the
  // group a refill needs was started three refills earlier.
  uint32_t* const ring = s_ring + tid;
  auto fetch_word = [&](int j) {
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(ring + (j & (kRing - 1)) * nthreads));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 "cp.async.commit_group;\n" ::"r"(dst),
                 "l"(word_at(j))
                 : "memory");
  };
#endif

  uint64_t acc = 0;  // bit window, MSB-first
  int navail = 0;    // valid bits in the window
  int wcur = 0;      // next word of the lane
  int slot = 0, k = 0;
  int dc0 = 0, dc1 = 0, dc2 = 0;
  bool err = false;

  // Offset of the current block in 16-byte units, or -1 outside the output.
  auto block_at = [&]() -> int {
    const uint32_t block_flat =
        base_img + static_cast<uint32_t>(s_geo[G_FLAT][slot]) +
        static_cast<uint32_t>(my) * static_cast<uint32_t>(s_geo[G_ROW][slot]) +
        static_cast<uint32_t>(mx) * static_cast<uint32_t>(s_geo[G_COL][slot]);
    const uint32_t idx = block_flat * 64u;
    return idx < out_limit ? static_cast<int>(idx >> 3) : -1;
  };
#if RJT_WAVE_BLOCK_AHEAD
  // What a step needs of its block is loaded when the block begins, a
  // block's length ahead of its use: the block's place in the output, its
  // component, and its rows of the first-level table.
  int cur16 = -1, comp = 0, dc_row = kNoRow, ac_row = kNoRow;
  auto load_slot = [&]() {
    cur16 = block_at();
    comp = s_geo[G_COMP][slot];
    dc_row = s_lutrow[slot] + bank_row;
    ac_row = s_lutrow[kMaxSlots + slot] + bank_row;
  };
  load_slot();
#endif
  auto next_block = [&]() {
    if (++slot >= g.nslots) {
      slot = 0;
      --mcu_rem;
      if (++mx >= g.mcus_w) {
        mx = 0;
        ++my;
      }
    }
#if RJT_WAVE_BLOCK_AHEAD
    load_slot();
#endif
  };
  // For the warp's flush: this thread's chunk of every block it moves, the
  // warp's list of finished blocks, and this thread's tile as the flush
  // finds it (its byte offset in s_tile, with the swizzle in the bits a
  // 128-byte tile leaves free).
  const int chunk = tid & 7;
  int2* const src = s_src + (tid & ~31);
  const int tile_key = tid * 128 + swz * 16;
  uint4* const out_chunk = out16 + chunk;
  // Tiles of finished blocks (block_done, at offset done16) go out as
  // whole 128-byte rows and are zeroed again. Every thread of the warp
  // calls this together.
  auto flush = [&](bool block_done, int done16) {
    if constexpr (kFlush == 1) {
      if (block_done) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const uint4 v = tile[c ^ swz];
          tile[c ^ swz] = zero4;
          if (done16 >= 0) out16[done16 + c] = v;
        }
      }
    } else if constexpr (kFlush == 2) {
      // The warp shares the work: thread j of an 8-thread group moves chunk
      // j of one block, four blocks a pass.
      const unsigned done_mask = __ballot_sync(kFullWarp, block_done);
      if (done_mask) {
        if (block_done)
          src[__popc(done_mask & ((1u << (tid & 31)) - 1u))] =
              make_int2(tile_key, done16);
        __syncwarp();  // tiles and the list are written
        const int n_done = __popc(done_mask);
        for (int r = (tid & 31) >> 3; r < n_done; r += 4) {
          const int2 sb = src[r];
          uint4* const from = reinterpret_cast<uint4*>(
              reinterpret_cast<char*>(s_tile) + (sb.x ^ (chunk << 4)));
          const uint4 v = *from;
          *from = zero4;
          if (sb.y >= 0) out_chunk[sb.y] = v;
        }
        __syncwarp();  // tiles are zero again before their owners go on
      }
    }
  };

#if RJT_WAVE_PREFETCH == 1
  uint32_t next_w = (has_lane && mcu_rem > 0) ? load_word(0) : 0u;
#elif RJT_WAVE_PREFETCH == 2
  // The next word waits in a register, the two after it are on their way.
  uint32_t next_w = 0u;
  if (has_lane && mcu_rem > 0) {
    for (int j = 0; j < kRing - 1; ++j) fetch_word(j);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    next_w = 0 < n_words ? ring[0] : 0u;
  }
#endif

  for (int step = 0; step < max_steps; ++step) {
    const bool active = mcu_rem > 0 && !err;
    if constexpr (kFlush == 2) {
      if (!__any_sync(kFullWarp, active)) break;
    } else {
      if (!active) break;
    }
    int done16 = -1;        // the block this step completed, if any
    bool block_done = false;
    if (active) {
      // ---- refill: one 32-bit word when <= 32 bits remain ----
      if (navail <= 32) {
#if RJT_WAVE_PREFETCH == 1
        const uint32_t w = next_w;
        next_w = load_word(wcur + 1);
#elif RJT_WAVE_PREFETCH == 2
        // Words wcur + 1 and wcur + 2 are on their way. The first is waited
        // for and read into the register, to be used one refill on; word
        // wcur + 3 goes to the slot that the refill before last read.
        const uint32_t w = next_w;
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 3) : "memory");
        next_w = wcur + 1 < n_words
                     ? ring[((wcur + 1) & (kRing - 1)) * nthreads]
                     : 0u;
        fetch_word(wcur + kRing - 1);
#else
        const uint32_t w = load_word(wcur);
#endif
        acc |= static_cast<uint64_t>(w) << (32 - navail);
        navail += 32;
        ++wcur;
      }

      // ---- the symbol, and n = code length + size ----
      const uint32_t win = static_cast<uint32_t>(acc >> 32);
      const bool is_dc = (k == 0);
      int n = 0, symbol = 0;
      bool found = true;
#if RJT_WAVE_LUT_BITS
#if RJT_WAVE_BLOCK_AHEAD
      const int row = is_dc ? dc_row : ac_row;
#else
      const int row = s_lutrow[is_dc ? slot : kMaxSlots + slot] + bank_row;
#endif
      if (row >= 0) {
        const uint32_t e = *reinterpret_cast<const uint16_t*>(
            reinterpret_cast<const char*>(s_lut) + row +
            ((win >> (32 - kLutBits)) << 1));
        n = static_cast<int>(e >> 8);
        symbol = static_cast<int>(e & 0xFF);
      }
#endif
      if (n == 0) {
        // first of 16 lengths whose code < maxcode+1
        const int tin = is_dc ? s_geo[G_DC][slot] : s_geo[G_AC][slot];
        const int tslot = tin + 4 * bank;
        const int trow = (tslot >= 0 && tslot < nrows) ? tslot : nrows - 1;
        int code = 0, base = 0, codelen = 1;
        found = false;
#if RJT_WAVE_LUT_BITS
        // The table has ruled out every length it covers.
#pragma unroll 1
        for (int li = row >= 0 ? kLutBits : 0; li < 16; ++li) {
#else
#pragma unroll
        for (int li = 0; li < 16; ++li) {
#endif
          const int cand = static_cast<int>(win >> (31 - li));
          const uint32_t ent = s_lentab[trow * 16 + li];
          if (cand < static_cast<int>(ent >> 15)) {
            codelen = li + 1;
            code = cand;
            base = static_cast<int>(ent & 0x7FFF);
            found = true;
            break;
          }
        }
        symbol = symbol_byte(s_values, n_banks, bank, tin, code, base);
        n = codelen + (symbol & 15);
      }
      const int run = symbol >> 4;
      const int size = symbol & 15;

      // ---- extend bits right after the code (n <= 31) ----
      const uint32_t mask = (1u << size) - 1u;
      const uint32_t ext = (win >> (32 - n)) & mask;
      const int val = static_cast<int>(ext) -
                      (ext < ((1u << size) >> 1) ? static_cast<int>(mask) : 0);

      // ---- DC predictor (int32, wraps as XLA does) ----
#if !RJT_WAVE_BLOCK_AHEAD
      const int comp = s_geo[G_COMP][slot];
#endif
      const int dc_cur =
          comp == 0 ? dc0 : (comp == 1 ? dc1 : (comp == 2 ? dc2 : 0));
      const int dc_new = static_cast<int>(static_cast<uint32_t>(dc_cur) +
                                          static_cast<uint32_t>(val));
      if (is_dc) {
        if (comp == 0) dc0 = dc_new;
        if (comp == 1) dc1 = dc_new;
        if (comp == 2) dc2 = dc_new;
      }

      // ---- AC bookkeeping + the coefficient write ----
      const int kk = k + run;
      const bool ac_value = !is_dc && size != 0;
      const bool overrun = ac_value && kk > 63;
      err = !found || overrun;
      if (is_dc || (ac_value && !overrun)) {
        const int16_t wv =
            static_cast<int16_t>(static_cast<uint16_t>(is_dc ? dc_new : val));
        const int z = s_zig[is_dc ? 0 : kk];
        if constexpr (kFlush == 0) {
#if RJT_WAVE_BLOCK_AHEAD
          const int b16 = cur16;
#else
          const int b16 = block_at();
#endif
          if (b16 >= 0) out[(static_cast<int64_t>(b16) << 3) + z] = wv;
        } else {
          tile16[z ^ (swz << 3)] = wv;
        }
      }

      // ---- advance within block / MCU / MCU row ----
      // DC -> 1; a value -> past it; ZRL -> 16 on; EOB -> the block's end.
      k = is_dc ? 1 : (size != 0 ? kk + 1 : (run == 15 ? k + 16 : 64));
      if (k >= 64) {
        k = 0;
        block_done = true;
#if RJT_WAVE_BLOCK_AHEAD
        done16 = cur16;
#else
        done16 = block_at();
#endif
        next_block();
      }

      // ---- consume n bits (1..31) ----
      acc <<= n;
      navail -= n;
    }

    flush(block_done, done16);
  }

  if (has_lane) err_out[l] = (err || mcu_rem > 0) ? 1 : 0;

  // A lane that stopped early: its partial block goes out as it stands and
  // the rest of its MCUs are zero.
  if constexpr (kFlush != 0) {
    while (__any_sync(kFullWarp, mcu_rem > 0)) {
      const bool more = mcu_rem > 0;
#if RJT_WAVE_BLOCK_AHEAD
      const int left16 = cur16;
#else
      const int left16 = block_at();
#endif
      if (more) next_block();
      flush(more, left16);
    }
  }
}

}  // namespace

// geom_tab: host int32 [G_FIELDS][nslots] (flat_off, row_step, col_step,
// dc_slot, ac_slot, comp_of_slot). lut: scratch of n_banks * 4 *
// rjt_wave_lut_size() uint16. out need not be initialised: expected_mcus is
// the MCU count of the whole group when every block of the output belongs
// to an MCU of the scan, and the output is then zero-filled only if the
// lanes cover fewer; pass -1 to have it zero-filled always. Returns
// cudaGetLastError().
extern "C" int rjt_wave_decode(
    const void* dense, int64_t n_dense, const void* word_off,
    const void* img_base, const void* mcu_start, const void* mcu_count,
    const void* lane_bank, int n_lanes, const void* lentab,
    const void* values, int n_banks, const void* geom_tab, int nslots,
    int mcus_w, int n_words, int max_steps, int64_t expected_mcus,
    int64_t out_size, void* out, void* err, void* lut, void* stream) {
  if (nslots < 1 || nslots > kMaxSlots || n_banks < 1 ||
      n_banks > kMaxBanks || mcus_w < 1 || out_size % 64 != 0 ||
      n_dense < 1 || n_words < 0 || n_words >= (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  WaveGeom g;
  std::memset(&g, 0, sizeof(g));
  g.nslots = nslots;
  g.mcus_w = mcus_w;
  const int32_t* tab = static_cast<const int32_t*>(geom_tab);
  for (int f = 0; f < G_FIELDS; ++f)
    for (int s = 0; s < nslots; ++s) g.tab[f][s] = tab[f * nslots + s];
  if (n_lanes <= 0) return static_cast<int>(cudaGetLastError());

  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  // Fewer threads a block while that is what it takes to give every SM
  // two blocks: a group of few lanes is spread over the whole card.
  int threads = RJT_WAVE_THREADS ? RJT_WAVE_THREADS : kMaxThreads;
  if (!RJT_WAVE_THREADS)
    while (threads > 32 && (n_lanes + threads - 1) / threads < 2 * sms)
      threads >>= 1;
  const int blocks = (n_lanes + threads - 1) / threads;
  // The warp's shared flush makes the tidiest stores, and costs two warp
  // barriers and a list in shared memory at every step. It pays where many
  // warps a scheduler hide that; a group of few lanes flushes each tile
  // from its own thread.
  const int flush =
      RJT_WAVE_FLUSH != 3
          ? RJT_WAVE_FLUSH
          : (static_cast<int64_t>(blocks) * threads >=
                     static_cast<int64_t>(kWarpFlushWarpsPerSm) * 32 * sms
                 ? 2
                 : 1);
  if (flush == 0) expected_mcus = -1;  // scattered stores need the zeroes

  wave_prologue_kernel<<<sms, kPrologueThreads, 0, st>>>(
      static_cast<const int32_t*>(mcu_count), n_lanes, expected_mcus,
      static_cast<const uint32_t*>(lentab),
      static_cast<const uint32_t*>(values), n_banks,
      static_cast<uint16_t*>(lut), static_cast<uint4*>(out), out_size / 8);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);

  const size_t shared =
      static_cast<size_t>(threads) *
          (128 + sizeof(int2) + kRing * sizeof(uint32_t)) +
      static_cast<size_t>(n_banks) * 4 * kLutSize * sizeof(uint16_t) +
      (4 * kMaxBanks * 16 + kMaxBanks * kValWords + 64 +
       (G_FIELDS + 2) * kMaxSlots) * sizeof(int32_t);
  const auto kernel = flush == 0   ? wave_kernel<0>
                      : flush == 1 ? wave_kernel<1>
                                   : wave_kernel<2>;
  kernel<<<blocks, threads, shared, st>>>(
      static_cast<const uint32_t*>(dense), n_dense,
      static_cast<const int32_t*>(word_off),
      static_cast<const int32_t*>(img_base),
      static_cast<const int32_t*>(mcu_start),
      static_cast<const int32_t*>(mcu_count),
      static_cast<const int32_t*>(lane_bank), n_lanes,
      static_cast<const uint32_t*>(lentab),
      static_cast<const uint32_t*>(values),
      static_cast<const uint16_t*>(lut), n_banks, g, n_words, max_steps,
      out_size, static_cast<int16_t*>(out), static_cast<uint8_t*>(err));
  return static_cast<int>(cudaGetLastError());
}

// Entries per table row of the first-level table (0: none).
extern "C" int rjt_wave_lut_size() { return kLutSize; }
