// K2 — DC fixup + dequantisation + 8x8 islow IDCT + block -> plane on Hopper.
//
// Replaces the XLA device program rocjpeg_tpu/pipeline.py
// _transform_from_flat (with ops/idct.py dequant_idct_8x8 and
// ops/layout.py blocks_to_plane): the JAX package leaves this stage to XLA
// fusion; on the GPU it is a kernel written by hand.
//
// Design: one thread per 8x8 block over (image, component, by, bx). The
// thread loads the block's 64 int16 coefficients (eight 16-byte loads),
// for virtual-restart lanes adds the lane's entry DC predictor to
// coefficient 0 with int16 wraparound, dequantises by the natural-order
// quant table, runs pass 1 over columns and pass 2 over rows exactly as
// ops/idct.py does, adds 128, clamps, and stores 8 rows of 8 bytes into
// the component's (B, bh*8, bw*8) uint8 plane.
//
// What bounds it on the card: DRAM bytes — 128 bytes of coefficients in
// and 64 bytes of samples out per block, against a few hundred integer
// operations. This first version is simple on purpose (no shared-memory
// staging, no vectorised cross-thread stores); later work makes it fast.
//
// Arithmetic: numpy and XLA wrap int32 on overflow, and coeff * quant *
// FIX_* does overflow for extreme coefficients. Signed overflow is
// undefined in C++ (and so is a left shift of a negative value), so every
// product, sum and << CONST_BITS is done in uint32_t, which wraps, and the
// bits are reinterpreted as int32_t only for the arithmetic right shift of
// the descale. nvcc compiles >> on a signed integer as an arithmetic
// (sign-propagating) shift.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxComp = 3;
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;

struct CompTab {
  int ncomp;
  int base[kMaxComp];   // first block of the component within an image
  int bh[kMaxComp];
  int bw[kMaxComp];
  int hs[kMaxComp];     // blocks per MCU, horizontally / vertically
  int vs[kMaxComp];
  uint8_t* out[kMaxComp];
};

__device__ __forceinline__ int32_t descale(uint32_t x, int n) {
  return static_cast<int32_t>(x + (1u << (n - 1))) >> n;
}

// One 8-point 1-D IDCT (ops/idct.py _idct8); in/out are int32 bit patterns.
__device__ __forceinline__ void idct8(const uint32_t in[8], int32_t out[8],
                                      int shift) {
  uint32_t z2 = in[2], z3 = in[6];
  uint32_t z1 = (z2 + z3) * 4433u;                      // FIX_0_541196100
  const uint32_t tmp2 = z1 + z3 * static_cast<uint32_t>(-15137);
  const uint32_t tmp3 = z1 + z2 * 6270u;                // FIX_0_765366865
  z2 = in[0];
  z3 = in[4];
  const uint32_t tmp0 = (z2 + z3) << kConstBits;
  const uint32_t tmp1 = (z2 - z3) << kConstBits;
  const uint32_t tmp10 = tmp0 + tmp3;
  const uint32_t tmp13 = tmp0 - tmp3;
  const uint32_t tmp11 = tmp1 + tmp2;
  const uint32_t tmp12 = tmp1 - tmp2;

  uint32_t t0 = in[7], t1 = in[5], t2 = in[3], t3 = in[1];
  z1 = t0 + t3;
  z2 = t1 + t2;
  z3 = t0 + t2;
  uint32_t z4 = t1 + t3;
  const uint32_t z5 = (z3 + z4) * 9633u;                // FIX_1_175875602
  t0 = t0 * 2446u;                                      // FIX_0_298631336
  t1 = t1 * 16819u;                                     // FIX_2_053119869
  t2 = t2 * 25172u;                                     // FIX_3_072711026
  t3 = t3 * 12299u;                                     // FIX_1_501321110
  z1 = z1 * static_cast<uint32_t>(-7373);               // FIX_0_899976223
  z2 = z2 * static_cast<uint32_t>(-20995);              // FIX_2_562915447
  z3 = z3 * static_cast<uint32_t>(-16069) + z5;         // FIX_1_961570560
  z4 = z4 * static_cast<uint32_t>(-3196) + z5;          // FIX_0_390180644
  t0 = t0 + z1 + z3;
  t1 = t1 + z2 + z4;
  t2 = t2 + z2 + z3;
  t3 = t3 + z1 + z4;

  out[0] = descale(tmp10 + t3, shift);
  out[1] = descale(tmp11 + t2, shift);
  out[2] = descale(tmp12 + t1, shift);
  out[3] = descale(tmp13 + t0, shift);
  out[4] = descale(tmp13 - t0, shift);
  out[5] = descale(tmp12 - t1, shift);
  out[6] = descale(tmp11 - t2, shift);
  out[7] = descale(tmp10 - t3, shift);
}

__global__ void __launch_bounds__(kThreads) transform_kernel(
    const int16_t* __restrict__ coeffs, const int32_t* __restrict__ quant,
    const int32_t* __restrict__ dc_flat,
    const int32_t* __restrict__ lane_of_mcu, int64_t lom_stride,
    int n_dc_lanes, int64_t n_blocks, int64_t total_blocks, int mcus_w, CompTab ct) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (gid >= n_blocks) return;
  const int64_t b = gid / total_blocks;
  const int blk = static_cast<int>(gid - b * total_blocks);
  int c = 0;
  while (c + 1 < ct.ncomp && blk >= ct.base[c + 1]) ++c;
  const int local = blk - ct.base[c];
  const int bw = ct.bw[c];
  const int by = local / bw;
  const int bx = local - by * bw;

  // Coefficients: 128 contiguous, 16-byte aligned bytes.
  __align__(16) int16_t co[64];
  const int4* src = reinterpret_cast<const int4*>(coeffs + gid * 64);
#pragma unroll
  for (int i = 0; i < 8; ++i) *reinterpret_cast<int4*>(&co[i * 8]) = src[i];

  if (dc_flat != nullptr) {
    // The wrapper checks every MCU index against lom_stride; a lane index
    // outside dc_flat (malformed input) adds nothing instead of faulting.
    const int mcu = (by / ct.vs[c]) * mcus_w + bx / ct.hs[c];
    const int lane = lane_of_mcu[b * lom_stride + mcu];
    if (lane >= 0 && lane < n_dc_lanes) {
      const uint16_t fix = static_cast<uint16_t>(dc_flat[lane * 3 + c]);
      co[0] = static_cast<int16_t>(
          static_cast<uint16_t>(static_cast<uint16_t>(co[0]) + fix));
    }
  }

  const int32_t* q = quant + (b * 3 + c) * 64;
  uint32_t x[64];
#pragma unroll
  for (int i = 0; i < 64; ++i)
    x[i] = static_cast<uint32_t>(static_cast<int32_t>(co[i])) *
           static_cast<uint32_t>(q[i]);

  // Pass 1: columns (1-D IDCT along the frequency-row axis).
  int32_t ws[64];
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    uint32_t in[8];
    int32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) in[i] = x[i * 8 + v];
    idct8(in, o, kConstBits - kPass1Bits);
#pragma unroll
    for (int r = 0; r < 8; ++r) ws[r * 8 + v] = o[r];
  }

  // Pass 2: rows, level shift, clamp, store one 8-byte row at a time.
  const int64_t pw = static_cast<int64_t>(bw) * 8;
  uint8_t* plane = ct.out[c] + b * (static_cast<int64_t>(ct.bh[c]) * 8 * pw);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t in[8];
    int32_t o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) in[i] = static_cast<uint32_t>(ws[r * 8 + i]);
    idct8(in, o, kConstBits + kPass1Bits + 3);
    __align__(8) uint8_t px[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int32_t s = static_cast<int32_t>(static_cast<uint32_t>(o[i]) + 128u);
      px[i] = static_cast<uint8_t>(s < 0 ? 0 : (s > 255 ? 255 : s));
    }
    *reinterpret_cast<uint2*>(plane + (static_cast<int64_t>(by) * 8 + r) * pw +
                              static_cast<int64_t>(bx) * 8) =
        *reinterpret_cast<const uint2*>(px);
  }
}

}  // namespace

// comp_tab: host int32 [5][ncomp] (base, bh, bw, hs, vs); out_ptrs: host
// int64 [ncomp] device plane pointers. dc_flat (n_dc_lanes, 3) /
// lane_of_mcu (batch, lom_stride) may be null (no DC fixup). Returns
// cudaGetLastError().
extern "C" int rjt_transform(const void* coeffs, const void* quant,
                             const void* dc_flat, const void* lane_of_mcu,
                             int batch, const void* comp_tab,
                             const void* out_ptrs, int ncomp,
                             int64_t total_blocks, int mcus_w,
                             int64_t lom_stride, int n_dc_lanes,
                             void* stream) {
  if (ncomp < 1 || ncomp > kMaxComp || mcus_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CompTab ct = {};
  ct.ncomp = ncomp;
  const int32_t* tab = static_cast<const int32_t*>(comp_tab);
  const int64_t* ptrs = static_cast<const int64_t*>(out_ptrs);
  for (int c = 0; c < ncomp; ++c) {
    ct.base[c] = tab[0 * ncomp + c];
    ct.bh[c] = tab[1 * ncomp + c];
    ct.bw[c] = tab[2 * ncomp + c];
    ct.hs[c] = tab[3 * ncomp + c];
    ct.vs[c] = tab[4 * ncomp + c];
    ct.out[c] = reinterpret_cast<uint8_t*>(ptrs[c]);
  }
  const int64_t n_blocks = static_cast<int64_t>(batch) * total_blocks;
  if (n_blocks > 0) {
    const int64_t grid = (n_blocks + kThreads - 1) / kThreads;
    transform_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int16_t*>(coeffs),
        static_cast<const int32_t*>(quant),
        static_cast<const int32_t*>(dc_flat),
        static_cast<const int32_t*>(lane_of_mcu), lom_stride, n_dc_lanes,
        n_blocks, total_blocks, mcus_w, ct);
  }
  return static_cast<int>(cudaGetLastError());
}
