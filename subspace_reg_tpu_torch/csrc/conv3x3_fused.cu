// K2 on Hopper: 3x3 convolution (stride 1, padding 1, no bias) with the
// previous BatchNorm's folded affine + LeakyReLU(0.1) in the prologue and
// the output's per-channel batch-statistic sums in the epilogue.
//
// Replaces the TPU kernel subspace_reg_tpu/ops/pallas/conv_fused.py::
// conv3x3_pair (body _conv_pair_kernel).  The plain PyTorch version with the
// same operands and outputs is subspace_reg_tpu_torch/ops/conv_fused.py::
// conv3x3_fused_plain; the wrapper there validates operands, casts the
// weights to bf16 as (9, Cout, Cin) and counts launches.
//
// Function.  x is NHWC bf16 (B, H, W, Cin).  The prologue computes, for every
// input element inside the image, z = bf16(bf16(x*a) + b) with a and b the
// per-channel affine rounded to bf16, then (relu_in) max(z, bf16(z*bf16(0.1)));
// the zero halo is applied AFTER the activation.  y = conv(z, W) accumulates
// in f32 and rounds once to bf16.  The epilogue sums y and y*y per channel
// over the ROUNDED output into per-block partials; a second kernel reduces
// the partials in a fixed order (no atomics), so a rerun is bit-identical.
//
// What bounds it on the card.  At batch 64 the stage-1 64->64 conv is
// 33.3 GFLOP against ~116 MB of input + output (35 us at 989 TFLOP/s dense
// bf16, the larger of the two), the stage-2 160->160 conv 52.0 GFLOP
// (53 us): the convolutions are bound by tensor-core operations.  This
// design is an implicit GEMM on mma.sync m16n8k16 (bf16 in, f32
// accumulate): one block of 8 warps owns an 8x16 tile of output pixels x ALL
// output channels (up to 160).  Each warp owns 2 output rows (two 16-pixel
// mma row tiles) x half of the output channels, so every B fragment it loads
// from shared memory feeds two MMAs.  The input halo tile (10x18 pixels x
// Cin) is staged ONCE in shared memory with cp.async (every thread keeps its
// 16-byte copies in flight; the zero halo comes from zero-filled copies),
// and the prologue is then applied in place, so the affine + activation
// never costs a pass over device memory.  The weights of one tap (Cout x
// Cin) are staged per tap the same way.  Rows of both shared tiles are
// padded by 8 bf16 so the 32-bit fragment loads of a warp hit 32 distinct
// banks.  wgmma, TMA and a pipelined producer/consumer split are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;              // output rows per block
constexpr int TW = 16;             // output cols per block = the mma's M
constexpr int NWARP = 8;           // 4 row pairs x 2 channel halves
constexpr int NT = NWARP * 32;     // threads per block
constexpr int HH = TH + 2;         // halo rows
constexpr int HW = TW + 2;         // halo cols
constexpr int MAX_NTILES = 20;     // Cout <= 160 (host side: MAX_COUT)
constexpr int RED_T = 256;         // threads of the partials reduction
constexpr int CPAD = 8;            // smem row padding, bf16 elements

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte global -> shared copy in flight; with fill=false the 16 bytes
// are zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// prologue on one input value: bf16(bf16(v*a) + b), then LeakyReLU as
// max(z, bf16(z*0.1)); every step rounds to bf16, none contracts into FMA
__device__ __forceinline__ float prologue(float z, float a, float b,
                                          bool aff, bool relu, float slope) {
  if (aff) z = rbf(__fadd_rn(rbf(__fmul_rn(z, a)), b));
  if (relu) {
    const float m = rbf(__fmul_rn(z, slope));
    z = m > z ? m : z;
  }
  return z;
}

// one tap's (Cout, Cin) weights -> wsm rows of stride cs, zero in the
// channel padding
__device__ __forceinline__ void stage_weights(__nv_bfloat16* wsm,
                                              const __nv_bfloat16* wtap,
                                              int Cout, int Cin, int cin_pad,
                                              int cs, int tid) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  if ((Cin & 7) == 0) {
    const int cv = Cin >> 3;
    for (int e = tid; e < Cout * cv; e += NT) {
      const int n = e / cv, c8 = (e - n * cv) << 3;
      cp_async16(wsm + n * cs + c8, wtap + (size_t)n * Cin + c8, true);
    }
    for (int e = tid; e < Cout * (cin_pad - Cin); e += NT) {
      const int n = e / (cin_pad - Cin);
      wsm[n * cs + Cin + (e - n * (cin_pad - Cin))] = zero;
    }
    cp_async_wait_all();
  } else {
    for (int e = tid; e < Cout * cin_pad; e += NT) {
      const int n = e / cin_pad, c = e - n * cin_pad;
      wsm[n * cs + c] = c < Cin ? wtap[(size_t)n * Cin + c] : zero;
    }
  }
}

// NTW: the most n8-tiles one warp owns (half of the block's, rounded up).
// Two blocks per SM: unbounded, the 160-channel instance takes 146
// registers, one block fits an SM, and it runs ~25% slower than held to
// 128 registers (a few bytes spill) with two blocks resident.
template <int NTW>
__global__ void __launch_bounds__(NT, 2)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ aff_a,
               const float* __restrict__ aff_b,
               __nv_bfloat16* __restrict__ y, float* __restrict__ partials,
               int H, int W, int Cin, int Cout, int cin_pad, int relu_in,
               int tiles_w, int n_blk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = cin_pad + CPAD;            // smem row stride, bf16
  const int ntiles = Cout / 8;
  const int nhalf = (ntiles + 1) / 2;       // n-tiles of channel half 0
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* wsm = halo + HH * HW * cs;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rp = warp >> 1;                 // rows 2rp, 2rp+1 of the tile
  const int j0 = (warp & 1) * nhalf;        // first n-tile of this warp
  const int img = blockIdx.y;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const bool aff = aff_a != nullptr;
  const bool relu = relu_in != 0;
  const float slope = rbf(0.1f);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // ---- halo tile (zeros outside the image and in the channel padding),
  //      then the prologue on the pixels inside the image ----------------
  const __nv_bfloat16* ximg = x + (size_t)img * H * W * Cin;
  if ((Cin & 7) == 0) {
    const int cv = Cin >> 3;                 // 16-byte vectors per pixel
    for (int e = tid; e < HH * HW * cv; e += NT) {
      const int p = e / cv, c8 = (e - p * cv) << 3;
      const int hh = p / HW, ww = p - hh * HW;
      const int gh = h0 + hh - 1, gw = w0 + ww - 1;
      const bool inside = gh >= 0 && gh < H && gw >= 0 && gw < W;
      const __nv_bfloat16* src =
          inside ? ximg + ((size_t)gh * W + gw) * Cin + c8 : x;
      cp_async16(halo + p * cs + c8, src, inside);
    }
    for (int e = tid; e < HH * HW * (cin_pad - Cin); e += NT) {
      const int p = e / (cin_pad - Cin);
      halo[p * cs + Cin + (e - p * (cin_pad - Cin))] = zero;
    }
    cp_async_wait_all();
    if (aff || relu) {
      __syncthreads();
      const int c2n = Cin >> 1;              // bf16 pairs per pixel
      for (int e = tid; e < HH * HW * c2n; e += NT) {
        const int p = e / c2n, c = (e - p * c2n) << 1;
        const int hh = p / HW, ww = p - hh * HW;
        const int gh = h0 + hh - 1, gw = w0 + ww - 1;
        if (gh < 0 || gh >= H || gw < 0 || gw >= W) continue;
        __nv_bfloat162* q =
            reinterpret_cast<__nv_bfloat162*>(halo + p * cs + c);
        const __nv_bfloat162 v = *q;
        const float lo = prologue(__low2float(v),
                                  aff ? rbf(aff_a[c]) : 1.0f,
                                  aff ? rbf(aff_b[c]) : 0.0f, aff, relu,
                                  slope);
        const float hi = prologue(__high2float(v),
                                  aff ? rbf(aff_a[c + 1]) : 1.0f,
                                  aff ? rbf(aff_b[c + 1]) : 0.0f, aff, relu,
                                  slope);
        *q = __floats2bfloat162_rn(lo, hi);
      }
    }
  } else {
    for (int e = tid; e < HH * HW * cin_pad; e += NT) {
      const int p = e / cin_pad, c = e - p * cin_pad;
      const int hh = p / HW, ww = p - hh * HW;
      const int gh = h0 + hh - 1, gw = w0 + ww - 1;
      __nv_bfloat16 v = zero;
      if (c < Cin && gh >= 0 && gh < H && gw >= 0 && gw < W) {
        v = ximg[((size_t)gh * W + gw) * Cin + c];
        if (aff || relu)
          v = __float2bfloat16_rn(prologue(
              __bfloat162float(v), aff ? rbf(aff_a[c]) : 1.0f,
              aff ? rbf(aff_b[c]) : 0.0f, aff, relu, slope));
      }
      halo[p * cs + c] = v;
    }
  }

  // ---- implicit GEMM over the 9 taps ------------------------------------
  float acc[2][NTW][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[r][j][0] = acc[r][j][1] = acc[r][j][2] = acc[r][j][3] = 0.0f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();     // the halo is ready / the last tap's reads done
    stage_weights(wsm, w + (size_t)tap * Cout * Cin, Cout, Cin, cin_pad, cs,
                  tid);
    __syncthreads();
    const int kh = tap / 3, kw = tap - kh * 3;
    // A rows: output pixel (h0 + 2rp + r, w0 + m) reads halo
    // (2rp + r + kh, m + kw)
    const __nv_bfloat16* a00 =
        halo + ((2 * rp + kh) * HW + g + kw) * cs + 2 * t4;
    const __nv_bfloat16* a10 = a00 + HW * cs;          // the second row
    const __nv_bfloat16* brow = wsm + (j0 * 8 + g) * cs + 2 * t4;
    for (int k0 = 0; k0 < cin_pad; k0 += 16) {
      const uint32_t x0 = ld32(a00 + k0), x1 = ld32(a00 + 8 * cs + k0);
      const uint32_t x2 = ld32(a00 + k0 + 8);
      const uint32_t x3 = ld32(a00 + 8 * cs + k0 + 8);
      const uint32_t y0 = ld32(a10 + k0), y1 = ld32(a10 + 8 * cs + k0);
      const uint32_t y2 = ld32(a10 + k0 + 8);
      const uint32_t y3 = ld32(a10 + 8 * cs + k0 + 8);
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        if (j0 + j < ntiles && (j0 == 0 ? j < nhalf : true)) {
          const __nv_bfloat16* bp = brow + j * 8 * cs + k0;
          const uint32_t b0 = ld32(bp), b1 = ld32(bp + 8);
          mma_bf16(acc[0][j], x0, x1, x2, x3, b0, b1);
          mma_bf16(acc[1][j], y0, y1, y2, y3, b0, b1);
        }
      }
    }
  }

  // ---- epilogue: round, store, per-channel sums of the rounded output ---
  __syncthreads();                 // the halo's space is reused for sums
  float* red = reinterpret_cast<float*>(smem_raw);   // (TH/2, 2, Cout)
  const int ow0 = w0 + g, ow1 = w0 + g + 8;
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    if (j0 + j < ntiles && (j0 == 0 ? j < nhalf : true)) {
      const int c = (j0 + j) * 8 + 2 * t4;
      float s0 = 0.0f, s1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int oh = h0 + 2 * rp + r;
        const bool v0 = oh < H && ow0 < W, v1 = oh < H && ow1 < W;
        __nv_bfloat16* yrow = y + ((size_t)img * H + oh) * W * Cout;
        const __nv_bfloat162 p0 =
            __floats2bfloat162_rn(acc[r][j][0], acc[r][j][1]);
        const __nv_bfloat162 p1 =
            __floats2bfloat162_rn(acc[r][j][2], acc[r][j][3]);
        if (v0)
          *reinterpret_cast<__nv_bfloat162*>(yrow + (size_t)ow0 * Cout + c) =
              p0;
        if (v1)
          *reinterpret_cast<__nv_bfloat162*>(yrow + (size_t)ow1 * Cout + c) =
              p1;
        const float f00 = v0 ? __low2float(p0) : 0.0f;
        const float f01 = v0 ? __high2float(p0) : 0.0f;
        const float f10 = v1 ? __low2float(p1) : 0.0f;
        const float f11 = v1 ? __high2float(p1) : 0.0f;
        s0 += f00 + f10;
        s1 += f01 + f11;
        q0 += f00 * f00 + f10 * f10;
        q1 += f01 * f01 + f11 * f11;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      if (g == 0) {
        red[(rp * 2 + 0) * Cout + c] = s0;
        red[(rp * 2 + 0) * Cout + c + 1] = s1;
        red[(rp * 2 + 1) * Cout + c] = q0;
        red[(rp * 2 + 1) * Cout + c + 1] = q1;
      }
    }
  }
  __syncthreads();
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  for (int e = tid; e < 2 * Cout; e += NT) {
    const int which = e / Cout, c = e - which * Cout;
    float s = 0.0f;
    for (int ri = 0; ri < TH / 2; ++ri) s += red[(ri * 2 + which) * Cout + c];
    partials[((size_t)which * Cout + c) * n_blk + blk] = s;
  }
}

// (2, Cout, n_blk) partials -> (2, Cout) sums: one block per (stat,
// channel), strided sums then a shared-memory tree, all in a fixed order
__global__ void __launch_bounds__(RED_T)
reduce_partials(const float* __restrict__ partials, float* __restrict__ out,
                int n_blk) {
  __shared__ float sh[RED_T];
  const float* row = partials + (size_t)blockIdx.x * n_blk;
  float s = 0.0f;
  for (int i = threadIdx.x; i < n_blk; i += RED_T) s += row[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int off = RED_T / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sh[0];
}

template <int NTW>
cudaError_t launch_conv(dim3 grid, size_t smem, cudaStream_t s,
                        const __nv_bfloat16* x, const __nv_bfloat16* w,
                        const float* a, const float* b, __nv_bfloat16* y,
                        float* partials, int H, int W, int Cin, int Cout,
                        int cin_pad, int relu_in, int tiles_w, int n_blk) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<NTW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<NTW><<<grid, NT, smem, s>>>(
      x, w, a, b, y, partials, H, W, Cin, Cout, cin_pad, relu_in, tiles_w,
      n_blk);
  return cudaGetLastError();
}

}  // namespace

// x (B,H,W,Cin) bf16; w (9,Cout,Cin) bf16; a, b (Cin,) f32 or null;
// y (B,H,W,Cout) bf16; partials (2,Cout,n_blk) f32; stats (2,Cout) f32.
// Returns the first CUDA error (0 on success).
extern "C" int k2_conv3x3_fused(const void* x, const void* w, const void* a,
                                const void* b, void* y, void* partials,
                                void* stats, int B, int H, int W, int Cin,
                                int Cout, int relu_in, int n_blk,
                                void* stream) {
  if (Cout <= 0 || Cout % 8 != 0 || Cout > MAX_NTILES * 8 || Cin <= 0 ||
      Cin > MAX_NTILES * 8 || (a == nullptr) != (b == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  if (n_blk != B * tiles_h * tiles_w) return (int)cudaErrorInvalidValue;
  const int cin_pad = (Cin + 15) / 16 * 16;
  const int cs = cin_pad + CPAD;
  size_t smem = (size_t)(HH * HW + Cout) * cs * sizeof(__nv_bfloat16);
  const size_t red = (size_t)TH * Cout * sizeof(float);
  if (red > smem) smem = red;
  const dim3 grid(tiles_h * tiles_w, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  auto* pp = static_cast<float*>(partials);
  cudaError_t err;
  if (Cout <= 64)
    err = launch_conv<4>(grid, smem, s, xp, wp, ap, bp, yp, pp, H, W, Cin,
                         Cout, cin_pad, relu_in, tiles_w, n_blk);
  else
    err = launch_conv<MAX_NTILES / 2>(grid, smem, s, xp, wp, ap, bp, yp, pp,
                                      H, W, Cin, Cout, cin_pad, relu_in,
                                      tiles_w, n_blk);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<2 * Cout, RED_T, 0, s>>>(pp, static_cast<float*>(stats),
                                             n_blk);
  return (int)cudaGetLastError();
}
