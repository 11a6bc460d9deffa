// K1 — wave entropy decode on Hopper.
//
// Replaces the TPU kernel rocjpeg_tpu/kernels/wave_pallas.py
// (build_wave_kernel, with refill / consume / decode_symbol of
// kernels/wave_common.py), and absorbs the two XLA programs around it:
// the lane-major word expansion (ops/device_entropy.py _expand_words) and
// the scatter of the emission buffers (_scatter_epilogue).
//
// Design: one thread per lane (a real or virtual restart segment), 128
// threads per block. Lane state (64-bit bit window, MCU walk, DC
// predictors) lives in registers; the Huffman tables (at most 4 banks,
// ~2.4 KB), the zigzag order and the slot geometry sit in shared memory.
// A lane reads its words straight from the dense stream and writes every
// coefficient straight into the zero-initialised int16 output at
// block_flat * 64 + zigzag[k] — lanes own disjoint blocks, so there are no
// emission buffers and no scatter pass.
//
// What bounds it on the card: the serial bit dependency inside a lane
// (each symbol's code length decides where the next symbol starts) and
// warp divergence (lanes of a warp sit at different symbols, take
// different branches and finish at different steps); the DRAM traffic is
// small next to that. This first version is simple on purpose: it is the
// correct baseline later work makes fast.
//
// Semantics kept from the TPU kernel, so error flags and outputs agree:
//  - words at or past n_words read as zero; words before it are
//    dense[min(word_off + j, W - 1)];
//  - shift guards: CUDA leaves a 32-bit shift by >= 32 undefined, XLA
//    defines it, so the refill special-cases navail == 0 / 32 and the
//    consume shifts the low word as (acc1 >> 1) >> (31 - n);
//  - the written DC value is the int32 predictor truncated to int16;
//  - at most max_steps symbols per lane; at exit err |= MCUs left; a lane
//    stops once it errs or runs out of MCUs (the symbol that errs is still
//    written and advanced, as on the TPU);
//  - an invalid code decodes as length 1, code 0, base 0.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlots = 10;  // baseline JPEG: sum of H*V per MCU <= 10
constexpr int kMaxBanks = 4;
constexpr int kValWords = 89;
constexpr int kValTotal = 356;

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

__global__ void __launch_bounds__(kThreads) wave_kernel(
    const uint32_t* __restrict__ dense, int64_t n_dense,
    const int32_t* __restrict__ word_off, const int32_t* __restrict__ img_base,
    const int32_t* __restrict__ mcu_start,
    const int32_t* __restrict__ mcu_count,
    const int32_t* __restrict__ lane_bank, int n_lanes,
    const uint32_t* __restrict__ lentab, const uint32_t* __restrict__ values,
    int n_banks, WaveGeom g, int n_words, int max_steps, int64_t out_size,
    int16_t* __restrict__ out, uint8_t* __restrict__ err_out) {
  __shared__ uint32_t s_lentab[4 * kMaxBanks * 16];
  __shared__ uint32_t s_values[kMaxBanks * kValWords];
  __shared__ int s_zig[64];
  __shared__ int s_geo[G_FIELDS][kMaxSlots];
  for (int i = threadIdx.x; i < 4 * n_banks * 16; i += blockDim.x)
    s_lentab[i] = lentab[i];
  for (int i = threadIdx.x; i < n_banks * kValWords; i += blockDim.x)
    s_values[i] = values[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_zig[i] = kZigzag[i];
  for (int i = threadIdx.x; i < G_FIELDS * kMaxSlots; i += blockDim.x)
    s_geo[i / kMaxSlots][i % kMaxSlots] = g.tab[i / kMaxSlots][i % kMaxSlots];
  __syncthreads();

  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= n_lanes) return;

  const int nrows = 4 * n_banks;
  const int bank = lane_bank ? lane_bank[l] : 0;
  const int64_t woff = word_off[l];
  const uint32_t base_img = static_cast<uint32_t>(img_base[l]);
  const int ms = mcu_start[l];
  int mcu_rem = mcu_count[l];
  int mx = ms % g.mcus_w;
  int my = ms / g.mcus_w;

  uint32_t acc0 = 0, acc1 = 0;  // 64-bit window, MSB-first
  int navail = 0;               // valid bits in the window
  int wcur = 0;                 // next word of the lane
  int slot = 0, k = 0;
  int dc0 = 0, dc1 = 0, dc2 = 0;
  bool err = false;

  for (int step = 0; step < max_steps && mcu_rem > 0 && !err; ++step) {
    // ---- refill: one 32-bit word when <= 32 bits remain ----
    if (navail <= 32) {
      uint32_t w = 0;
      if (wcur < n_words) {
        int64_t j = woff + wcur;
        j = j < 0 ? 0 : (j >= n_dense ? n_dense - 1 : j);
        w = dense[j];
      }
      if (navail < 32) acc0 |= w >> navail;
      if (navail == 32) {
        acc1 |= w;
      } else if (navail != 0) {
        acc1 |= w << (32 - navail);
      }
      navail += 32;
      ++wcur;
    }

    // ---- code length: first of 16 lengths whose code < maxcode+1 ----
    const uint32_t win = acc0;
    const bool is_dc = (k == 0);
    const int tslot =
        (is_dc ? s_geo[G_DC][slot] : s_geo[G_AC][slot]) + 4 * bank;
    const int trow = (tslot >= 0 && tslot < nrows) ? tslot : nrows - 1;
    int codelen = 1, code = 0, base = 0;
    bool found = false;
#pragma unroll
    for (int li = 0; li < 16; ++li) {
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

    // ---- symbol byte from the packed value table ----
    const int sym_idx = (code + base) & 0x7FFF;
    const int tin = tslot - 4 * bank;
    const int toff = tin == 0 ? 0 : (tin == 1 ? 16 : (tin == 2 ? 32 : 194));
    int flat_sym = toff + sym_idx;
    flat_sym = flat_sym < 0 ? 0 : (flat_sym > kValTotal - 1 ? kValTotal - 1
                                                            : flat_sym);
    const int widx = (flat_sym >> 2) + kValWords * bank;
    const uint32_t vword =
        (widx >= 0 && widx < n_banks * kValWords) ? s_values[widx] : 0u;
    const int symbol = static_cast<int>((vword >> ((flat_sym & 3) * 8)) & 0xFF);
    const int run = symbol >> 4;
    const int size = symbol & 15;

    // ---- extend bits right after the code (codelen + size <= 31) ----
    const uint32_t ext =
        (win >> (32 - codelen - size)) & ((1u << size) - 1u);
    int val = 0;
    if (size != 0) {
      const int half = 1 << (size - 1);
      val = static_cast<int>(ext) < half
                ? static_cast<int>(ext) - (half << 1) + 1
                : static_cast<int>(ext);
    }

    // ---- DC predictor (int32, wraps as XLA does) ----
    const int comp = s_geo[G_COMP][slot];
    const int dc_cur = comp == 0 ? dc0 : (comp == 1 ? dc1 : (comp == 2 ? dc2 : 0));
    const int dc_new = static_cast<int>(static_cast<uint32_t>(dc_cur) +
                                        static_cast<uint32_t>(val));
    if (is_dc) {
      if (comp == 0) dc0 = dc_new;
      if (comp == 1) dc1 = dc_new;
      if (comp == 2) dc2 = dc_new;
    }

    // ---- AC bookkeeping + the coefficient write ----
    const bool is_eob = !is_dc && size == 0 && run != 15;
    const bool is_zrl = !is_dc && size == 0 && run == 15;
    const int k_coeff = is_dc ? 0 : min(k + run, 63);
    const bool overrun = !is_dc && size > 0 && k + run > 63;
    const bool writes = is_dc || (size > 0 && !overrun);
    err = !found || overrun;
    if (writes) {
      const uint32_t block_flat =
          base_img + static_cast<uint32_t>(s_geo[G_FLAT][slot]) +
          static_cast<uint32_t>(my) * static_cast<uint32_t>(s_geo[G_ROW][slot]) +
          static_cast<uint32_t>(mx) * static_cast<uint32_t>(s_geo[G_COL][slot]);
      const int32_t idx = static_cast<int32_t>(
          block_flat * 64u + static_cast<uint32_t>(s_zig[k_coeff]));
      if (idx >= 0 && static_cast<int64_t>(idx) < out_size) {
        const int wv = is_dc ? dc_new : val;
        out[idx] = static_cast<int16_t>(static_cast<uint16_t>(wv));
      }
    }

    // ---- advance within block / MCU / MCU row ----
    int k_next = is_dc ? 1 : (is_eob ? 64 : (is_zrl ? k + 16 : k + run + 1));
    if (k_next >= 64) {
      k_next = 0;
      if (++slot >= g.nslots) {
        slot = 0;
        --mcu_rem;
        if (++mx >= g.mcus_w) {
          mx = 0;
          ++my;
        }
      }
    }
    k = k_next;

    // ---- consume codelen + size bits (1..31) ----
    const uint32_t n = static_cast<uint32_t>(codelen + size);
    acc0 = (acc0 << n) | ((acc1 >> 1) >> (31u - n));
    acc1 <<= n;
    navail -= static_cast<int>(n);
  }
  err_out[l] = (err || mcu_rem > 0) ? 1 : 0;
}

}  // namespace

// geom_tab: host int32 [G_FIELDS][nslots] (flat_off, row_step, col_step,
// dc_slot, ac_slot, comp_of_slot). Returns cudaGetLastError().
extern "C" int rjt_wave_decode(
    const void* dense, int64_t n_dense, const void* word_off,
    const void* img_base, const void* mcu_start, const void* mcu_count,
    const void* lane_bank, int n_lanes, const void* lentab,
    const void* values, int n_banks, const void* geom_tab, int nslots,
    int mcus_w, int n_words, int max_steps, int64_t out_size, void* out,
    void* err, void* stream) {
  if (nslots < 1 || nslots > kMaxSlots || n_banks < 1 ||
      n_banks > kMaxBanks || mcus_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  WaveGeom g;
  std::memset(&g, 0, sizeof(g));
  g.nslots = nslots;
  g.mcus_w = mcus_w;
  const int32_t* tab = static_cast<const int32_t*>(geom_tab);
  for (int f = 0; f < G_FIELDS; ++f)
    for (int s = 0; s < nslots; ++s) g.tab[f][s] = tab[f * nslots + s];
  if (n_lanes > 0) {
    const int blocks = (n_lanes + kThreads - 1) / kThreads;
    wave_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(dense), n_dense,
        static_cast<const int32_t*>(word_off),
        static_cast<const int32_t*>(img_base),
        static_cast<const int32_t*>(mcu_start),
        static_cast<const int32_t*>(mcu_count),
        static_cast<const int32_t*>(lane_bank), n_lanes,
        static_cast<const uint32_t*>(lentab),
        static_cast<const uint32_t*>(values), n_banks, g, n_words, max_steps,
        out_size, static_cast<int16_t*>(out), static_cast<uint8_t*>(err));
  }
  return static_cast<int>(cudaGetLastError());
}
