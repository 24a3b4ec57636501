// K3 on Hopper: the fused BasicBlock tail.
//
// Replaces the TPU kernel subspace_reg_tpu/ops/pallas/conv_fused.py::
// block_tail (body _tail_kernel).  The plain PyTorch version with the same
// operands and outputs is subspace_reg_tpu_torch/ops/conv_fused.py::
// block_tail_plain; the wrapper there validates operands, makes the launch
// plan (k3_plan) and counts launches.
//
// Function.  y3 (raw conv3 output) and r (raw downsample output) are NHWC
// bf16 (B, H, W, C); a3, b3, ad, bd are per-channel f32 folded BN affines,
// rounded to bf16.  Per element, every step rounding to bf16 (no FMA):
//   o = lrelu(bf16(bf16(bf16(y3*a3) + b3) + bf16(bf16(r*ad) + bd)))
// with lrelu(o) = max(o, bf16(o*bf16(0.1))).  The output is the 2x2 stride-2
// max-pool of o (B, H/2, W/2, C) and an int8 record per pooled element:
// bits 0-1 the winner (row*2 + col, the FIRST maximum in window order, by
// strict comparisons), bit 2 set when the winner is >= 0 (lrelu'(0) = 1).
//
// What bounds it on the card: bytes.  Per pooled element it reads 8 bf16
// values and writes one bf16 and one int8 value, with two dozen bf16
// operations: at batch 64 the stage-1 tail moves 137 MB (41 us at 3.35
// TB/s), the stage-2 tail 86 MB (26 us).  A pass that spends ~100
// instructions for every 2 bytes it writes (scalar 2-byte loads, a 64-bit
// div/mod decode and the affines loaded per element) is bound by
// instruction issue instead; the design below cuts the instructions per
// byte until the bytes bound.
//
// Design.
// * Vector width.  A thread owns V consecutive channels of one pooled
//   pixel (V = 8, 4, 2 or 1: the largest that divides C and the pointers'
//   alignment, chosen by the plan) and issues its eight loads (four window
//   positions of y3 and of r) as V-wide vectors, 16 bytes at V = 8, before
//   any arithmetic.  It stores its V pooled values as one vector and its V
//   records as one vector (8 bytes at V = 8).
// * Blocks of (channel groups) x (pixels): threadIdx.x is the channel
//   group, threadIdx.y the pixel of the tile.  A thread's channels change
//   only with the group tile (never when C/V <= 256, as at every shape of
//   the fused step), so its affines are rounded to bf16 once and stay in
//   registers while the block walks its tiles.
// * Decode in 32 bits: per thread and tile, one division for the tile's
//   group and pixel tiles and one by W/2 for the pixel, which is 32-bit
//   whenever the pixel's index is below 2^32 (every call with C > 1 that
//   fits the card) and 64-bit beyond.  Pooled row q = b*H/2 + ph of the
//   batch reads input rows 2q and 2q + 1, since b*H + 2*ph = 2q; addresses
//   are 64-bit wide multiply-adds.  One launch covers any call.
// * A persistent grid (SMs x resident blocks, from the plan) walks the
//   tiles.
// * Cache policy: y3 and r, read once, are loaded as streaming
//   (evict-first, ld.global.cs) and the record, which only the backward
//   reads, is stored so (st.global.cs); the pooled map keeps the default
//   policy, so the next stage's conv can find it in L2.
// * Arithmetic in bf16x2 with round-to-nearest products and sums
//   (__hmul2_rn, __hadd2_rn): a product of two bf16 values is exact in f32
//   and a sum of two bf16 values rounds to the same bf16 once or through
//   f32, so each operation equals the f32 operation of the plain version
//   followed by its rounding.  No FMA contraction.  The LeakyReLU and the
//   pooling select with strict-greater masks (__hmax2 differs on NaN).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace {

// threads a block may have (channel groups x pixels), and the resident
// blocks per SM the register budget must allow (ops/conv_fused.py:
// K3_THREADS, K3_MIN_BLOCKS)
constexpr int NT = 256;
constexpr int MIN_BLOCKS = 4;

// a thread's V inputs of one window position, and its V records
template <int V> struct Io;
template <> struct Io<8> { using In = uint4; using Rec = uint2; };
template <> struct Io<4> { using In = uint2; using Rec = unsigned; };
template <> struct Io<2> { using In = unsigned; using Rec = unsigned short; };
template <> struct Io<1> {
  using In = unsigned short;
  using Rec = unsigned char;
};

__device__ __forceinline__ __nv_bfloat162 bf2(unsigned u) {
  __nv_bfloat162 v;
  memcpy(&v, &u, 4);
  return v;
}

__device__ __forceinline__ unsigned u32(__nv_bfloat162 v) {
  unsigned u;
  memcpy(&u, &v, 4);
  return u;
}

// per 16-bit half: a where the mask is set, else b
__device__ __forceinline__ unsigned sel(unsigned mask, unsigned a,
                                        unsigned b) {
  return (a & mask) | (b & ~mask);
}

__device__ __forceinline__ unsigned gt(unsigned a, unsigned b) {
  return __hgt2_mask(bf2(a), bf2(b));
}

// V bf16 values as (V + 1) / 2 words of two channels (V = 1: high half 0)
template <int V>
__device__ __forceinline__ void unpack(typename Io<V>::In v,
                                       unsigned (&w)[(V + 1) / 2]) {
  if constexpr (V == 1) {
    w[0] = v;
  } else {
    memcpy(w, &v, sizeof v);
  }
}

template <int V>
__device__ __forceinline__ typename Io<V>::In pack(
    const unsigned (&w)[(V + 1) / 2]) {
  typename Io<V>::In v;
  if constexpr (V == 1) {
    v = (unsigned short)w[0];
  } else {
    memcpy(&v, w, sizeof v);
  }
  return v;
}

// records held one per 16-bit half (bits 0-2 of bytes 0 and 2) -> V bytes
template <int V>
__device__ __forceinline__ typename Io<V>::Rec pack_rec(
    const unsigned (&w)[(V + 1) / 2]) {
  if constexpr (V == 8) {
    return make_uint2(__byte_perm(w[0], w[1], 0x6420),
                      __byte_perm(w[2], w[3], 0x6420));
  } else if constexpr (V == 4) {
    return __byte_perm(w[0], w[1], 0x6420);
  } else if constexpr (V == 2) {
    return (unsigned short)__byte_perm(w[0], 0, 0x0020);
  } else {
    return (unsigned char)w[0];
  }
}

// two channels' pre-pool value: lrelu(bf16(t + u)), t = bf16(bf16(y*a3)+b3),
// u = bf16(bf16(r*ad)+bd), lrelu(o) = max(o, bf16(o*0.1)) by a strict select
__device__ __forceinline__ unsigned tail2(unsigned y, unsigned r,
                                          __nv_bfloat162 a3,
                                          __nv_bfloat162 b3,
                                          __nv_bfloat162 ad,
                                          __nv_bfloat162 bd,
                                          __nv_bfloat162 slope) {
  const __nv_bfloat162 t = __hadd2_rn(__hmul2_rn(bf2(y), a3), b3);
  const __nv_bfloat162 u = __hadd2_rn(__hmul2_rn(bf2(r), ad), bd);
  const unsigned o = u32(__hadd2_rn(t, u));
  const unsigned m = u32(__hmul2_rn(bf2(o), slope));
  return sel(gt(m, o), m, o);
}

__device__ __forceinline__ __nv_bfloat162 affine2(const float* __restrict__ v,
                                                  unsigned c, bool pair) {
  return __floats2bfloat162_rn(v[c], pair ? v[c + 1] : 0.0f);
}

// n_pix pooled pixels in rows of wo, C channels in groups of V; blocks of
// (gx, py) = (channel groups, pixels) walk the tiles t = group tile *
// pix_tiles + pixel tile
template <int V>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
block_tail_kernel(const __nv_bfloat16* __restrict__ y3,
                  const __nv_bfloat16* __restrict__ r,
                  const float* __restrict__ a3, const float* __restrict__ b3,
                  const float* __restrict__ ad, const float* __restrict__ bd,
                  __nv_bfloat16* __restrict__ out, int8_t* __restrict__ idx,
                  unsigned long long n_pix, unsigned wo, unsigned c,
                  unsigned pix_tiles, unsigned tiles) {
  using In = typename Io<V>::In;
  using Rec = typename Io<V>::Rec;
  constexpr int NW = (V + 1) / 2;
  const unsigned groups = c / V;
  const size_t row_in = 2ull * wo * c;  // one input row, W*C elements
  const __nv_bfloat162 slope = __float2bfloat162_rn(0.1f);
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.0f);
  __nv_bfloat162 fa3[NW], fb3[NW], fad[NW], fbd[NW];
  unsigned cur_gt = ~0u;
  for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
    const unsigned gtile = t / pix_tiles;
    const unsigned g = gtile * blockDim.x + threadIdx.x;
    const unsigned long long p =
        (unsigned long long)(t - gtile * pix_tiles) * blockDim.y + threadIdx.y;
    const unsigned ch = g * V;
    if (gtile != cur_gt) {  // the thread's channels changed
      cur_gt = gtile;
      if (g < groups) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          fa3[j] = affine2(a3, ch + 2 * j, V > 1);
          fb3[j] = affine2(b3, ch + 2 * j, V > 1);
          fad[j] = affine2(ad, ch + 2 * j, V > 1);
          fbd[j] = affine2(bd, ch + 2 * j, V > 1);
        }
      }
    }
    if (g >= groups || p >= n_pix) continue;
    const unsigned long long q = p >> 32 ? p / wo : (unsigned)p / wo;
    const unsigned pw = (unsigned)(p - q * wo);
    const size_t base = 2 * q * row_in + (size_t)(2 * pw) * c + ch;
    const size_t offs[4] = {0, c, row_in, row_in + c};
    In yv[4], rv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      yv[k] = __ldcs(reinterpret_cast<const In*>(y3 + base + offs[k]));
      rv[k] = __ldcs(reinterpret_cast<const In*>(r + base + offs[k]));
    }
    unsigned v[4][NW];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned yw[NW], rw[NW];
      unpack<V>(yv[k], yw);
      unpack<V>(rv[k], rw);
#pragma unroll
      for (int j = 0; j < NW; ++j)
        v[k][j] = tail2(yw[j], rw[j], fa3[j], fb3[j], fad[j], fbd[j], slope);
    }
    unsigned mx[NW], rec[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      const unsigned t01 = gt(v[1][j], v[0][j]);
      const unsigned t23 = gt(v[3][j], v[2][j]);
      const unsigned m01 = sel(t01, v[1][j], v[0][j]);
      const unsigned m23 = sel(t23, v[3][j], v[2][j]);
      const unsigned tm = gt(m23, m01);
      mx[j] = sel(tm, m23, m01);
      const unsigned ge = __hge2_mask(bf2(mx[j]), zero);
      rec[j] = (tm & 0x00020002u) | (sel(tm, t23, t01) & 0x00010001u) |
               (ge & 0x00040004u);
    }
    const size_t po = (size_t)p * c + ch;
    *reinterpret_cast<In*>(out + po) = pack<V>(mx);
    __stcs(reinterpret_cast<Rec*>(idx + po), pack_rec<V>(rec));
  }
}

template <int V>
int launch(const void* y3, const void* r, const void* a3, const void* b3,
           const void* ad, const void* bd, void* out, void* idx,
           unsigned long long n_pix, unsigned wo, unsigned c, unsigned gx,
           unsigned py, unsigned grid, cudaStream_t stream) {
  const uintptr_t wide = (uintptr_t)y3 | (uintptr_t)r | (uintptr_t)out;
  if (c % V || wide % (2 * V) || (uintptr_t)idx % V)
    return (int)cudaErrorMisalignedAddress;
  // the tile loop counts in 32 bits, up to the last tile plus the grid
  const unsigned long long pix_tiles = (n_pix + py - 1) / py;
  const unsigned long long tiles = pix_tiles * ((c / V + gx - 1) / gx);
  if (tiles + grid > 0xffffffffull) return (int)cudaErrorInvalidValue;
  block_tail_kernel<V><<<grid, dim3(gx, py), 0, stream>>>(
      static_cast<const __nv_bfloat16*>(y3),
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(a3),
      static_cast<const float*>(b3), static_cast<const float*>(ad),
      static_cast<const float*>(bd), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(idx), n_pix, wo, c, (unsigned)pix_tiles,
      (unsigned)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// y3, r (b, 2 ho, 2 wo, c) bf16 NHWC; a3, b3, ad, bd (c,) f32; out
// (b, ho, wo, c) bf16 and idx (b, ho, wo, c) int8.  v, gx, py, grid from
// the wrapper's k3_plan.  Returns the first CUDA error (0 on success).
extern "C" int k3_block_tail(const void* y3, const void* r, const void* a3,
                             const void* b3, const void* ad, const void* bd,
                             void* out, void* idx, int b, int ho, int wo,
                             int c, int v, int gx, int py, int grid,
                             void* stream) {
  if (b <= 0 || ho <= 0 || wo <= 0 || c <= 0 || gx <= 0 || py <= 0 ||
      grid <= 0 || gx * py > NT)
    return (int)cudaErrorInvalidValue;
  const unsigned long long n_pix = (unsigned long long)b * ho * wo;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 8:
      return launch<8>(y3, r, a3, b3, ad, bd, out, idx, n_pix, wo, c, gx, py,
                       grid, s);
    case 4:
      return launch<4>(y3, r, a3, b3, ad, bd, out, idx, n_pix, wo, c, gx, py,
                       grid, s);
    case 2:
      return launch<2>(y3, r, a3, b3, ad, bd, out, idx, n_pix, wo, c, gx, py,
                       grid, s);
    case 1:
      return launch<1>(y3, r, a3, b3, ad, bd, out, idx, n_pix, wo, c, gx, py,
                       grid, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
