// K3 on Hopper: the fused BasicBlock tail.
//
// Replaces the TPU kernel subspace_reg_tpu/ops/pallas/conv_fused.py::
// block_tail (body _tail_kernel).  The plain PyTorch version with the same
// operands and outputs is subspace_reg_tpu_torch/ops/conv_fused.py::
// block_tail_plain; the wrapper there validates operands and counts
// launches.
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
// What bounds it on the card.  Per pooled element it reads 8 bf16 values and
// writes one bf16 and one int8 value, with a few dozen flops: at batch 64 the
// stage-1 tail moves 137 MB (41 us at 3.35 TB/s), the stage-2 tail 86 MB
// (26 us) -- bound by bytes.  One thread per pooled element, consecutive
// threads on consecutive channels, so every load and store of a warp is one
// contiguous run; the record is written beside the output in the same pass,
// so the backward needs no select-and-scatter.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float tail_value(__nv_bfloat16 yv,
                                            __nv_bfloat16 rv, float a3,
                                            float b3, float ad, float bd,
                                            float slope) {
  const float t = rbf(__fadd_rn(rbf(__fmul_rn(__bfloat162float(yv), a3)), b3));
  const float u = rbf(__fadd_rn(rbf(__fmul_rn(__bfloat162float(rv), ad)), bd));
  const float o = rbf(__fadd_rn(t, u));
  const float m = rbf(__fmul_rn(o, slope));
  return m > o ? m : o;
}

__global__ void __launch_bounds__(NT)
block_tail_kernel(const __nv_bfloat16* __restrict__ y3,
                  const __nv_bfloat16* __restrict__ r,
                  const float* __restrict__ a3, const float* __restrict__ b3,
                  const float* __restrict__ ad, const float* __restrict__ bd,
                  __nv_bfloat16* __restrict__ out, int8_t* __restrict__ idx,
                  int B, int H, int W, int C) {
  const int Ho = H / 2, Wo = W / 2;
  const size_t n = (size_t)B * Ho * Wo * C;
  const float slope = rbf(0.1f);
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NT) {
    const int c = (int)(e % C);
    size_t q = e / C;
    const int pw = (int)(q % Wo);
    q /= Wo;
    const int ph = (int)(q % Ho);
    const size_t b = q / Ho;
    const size_t base = ((b * H + 2 * ph) * W + 2 * pw) * C + c;
    const size_t offs[4] = {0, (size_t)C, (size_t)W * C, (size_t)W * C + C};
    const float fa3 = rbf(a3[c]), fb3 = rbf(b3[c]);
    const float fad = rbf(ad[c]), fbd = rbf(bd[c]);
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = tail_value(y3[base + offs[k]], r[base + offs[k]], fa3, fb3, fad,
                        fbd, slope);
    const bool t01 = v[1] > v[0], t23 = v[3] > v[2];
    const float m01 = t01 ? v[1] : v[0];
    const float m23 = t23 ? v[3] : v[2];
    const bool tm = m23 > m01;
    const float mx = tm ? m23 : m01;
    const int low = tm ? 2 + (int)t23 : (int)t01;
    out[e] = __float2bfloat16_rn(mx);
    idx[e] = (int8_t)(low + (mx >= 0.0f ? 4 : 0));
  }
}

}  // namespace

// y3, r (B,H,W,C) bf16; a3, b3, ad, bd (C,) f32; out (B,H/2,W/2,C) bf16;
// idx (B,H/2,W/2,C) int8.  Returns the first CUDA error (0 on success).
extern "C" int k3_block_tail(const void* y3, const void* r, const void* a3,
                             const void* b3, const void* ad, const void* bd,
                             void* out, void* idx, int B, int H, int W, int C,
                             void* stream) {
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || (H & 1) || (W & 1))
    return (int)cudaErrorInvalidValue;
  const size_t n = (size_t)B * (H / 2) * (W / 2) * C;
  size_t blocks = (n + NT - 1) / NT;
  if (blocks > 132 * 64) blocks = 132 * 64;
  block_tail_kernel<<<(unsigned)blocks, NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(y3),
      static_cast<const __nv_bfloat16*>(r), static_cast<const float*>(a3),
      static_cast<const float*>(b3), static_cast<const float*>(ad),
      static_cast<const float*>(bd), static_cast<__nv_bfloat16*>(out),
      static_cast<int8_t*>(idx), B, H, W, C);
  return (int)cudaGetLastError();
}
