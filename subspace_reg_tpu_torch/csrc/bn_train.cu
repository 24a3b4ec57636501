// K5 on Hopper: train-mode BatchNorm, optionally followed by
// LeakyReLU(0.1), on bf16 activations, forward and backward.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm to XLA, which
// fuses the train-mode chain (subspace_reg_tpu/models/layers.py).  Eager
// PyTorch runs that chain as ~26 launches forward and ~45 backward for
// each of resnet18's 22 BatchNorms, so the bf16 pretraining step waits on
// the host's launches.  The plain PyTorch versions with the same operands
// and outputs are subspace_reg_tpu_torch/ops/bn_train.py::bn_train_plain
// (the forward, today's op chain) and bn_train_backward_plain (autograd's
// backward of that chain, op for op); the wrapper there validates
// operands, makes the plan (k5_plan), runs the statistics' sums between
// the launches, holds the autograd function and counts launches.
//
// Function.  x is bf16 (B, C, H, W), n = B*H*W per channel.  The wrapper
// takes the per-channel sums with torch's own reductions, between this
// file's two launches of a direction, on the tensors the eager chain
// reduces: mean = mean(f32(x)) (torch's reduction of x to f32, which sums
// in the order of its f32 copy's), e2 = mean(f32(x)^2) forward, and
// DB = bf16(sum g), DA = bf16(sum bf16(g*x)) backward (g the gradient at
// the BatchNorm's output z).  So the sums, and everything after them, are
// the eager chain's bit for bit: the single-pass variance e2 - mean^2
// cancels on inputs whose mean dwarfs their spread, where another order of
// the sums moves a bf16 scale by an ulp and the step by far more.
//   Forward: var_raw = e2 - mean*mean, var = max(var_raw, 0) (NaN kept),
//   inv = rsqrtf(var + eps), a = bf16(inv*w), b = bf16(bias -
//   (mean*inv)*w), z = bf16(bf16(x*a) + b), y = z or, through the
//   LeakyReLU, z >= 0 ? z : bf16(z*bf16(0.1)).  running_mean =
//   f32(keep*rm) + f32(mom*mean), running_var = f32(keep*rv) +
//   f32(mom*f32(var*ratio)).
//   Backward (autograd's chain replayed): g = dy, or dy where z >= 0 and
//   bf16(dy*bf16(0.1)) elsewhere; per channel dmi = -DB*w, dmean =
//   (dmi*inv + t) + t with t = -dvar*mean, dinv = DA*w + dmi*mean, dvar =
//   (-0.5*dinv)*(inv*inv*inv) where var_raw >= 0 (else 0), dweight =
//   DA*inv + (-DB)*(mean*inv), dbias = DB; per element u = (dvar*rn)*f32(x),
//   dx = bf16(bf16(g*a) + bf16((u + u) + dmean*rn)), rn = 1/f32(n) (torch
//   divides by a CPU scalar through its reciprocal on the card).  Every
//   step is one f32 operation rounded once (__fmul_rn, __fadd_rn: nothing
//   is contracted into an FMA).
//
// What bounds it on the card: bytes.  The bound of the whole BatchNorm
// (x read and y written; x and dy read and dx written): resnet18's 22 at
// batch 64 and 84 px hold 279.8 M activations, 2.80 GB a step, 0.835 ms at
// 3.35 TB/s.  Handing the sums to torch's reductions costs x read again,
// f32(x)^2 written and read back (10 bytes an element) and g and
// bf16(g*x) written and read back (8 more), about 4.5x the bound.
//
// Design.  Two launches a direction, no atomics: a rerun is bit-identical.
// * Launch 1 forward (k5_square): f32(x)^2, elementwise in memory order, 8
//   elements a thread.  Launch 1 backward (mode GRAD):
//   g (only through the LeakyReLU) and bf16(g*x).  Launch 2 (modes APPLY,
//   DX): y, or dx.
// * The per-channel constants (a, b; dx's three) are made in the launch
//   that uses them, by every block for the channels it touches, in shared
//   memory; block 0 (channels_last) or batch slice 0 (NCHW) also writes the
//   running statistics, or dweight and dbias.
// * Layouts.  Channels_last (C contiguous: the first stage's maps): a
//   thread owns V = 8, 4, 2 or 1 consecutive channels (the largest that
//   divides C and the pointers' alignment) of every (THREADS / (C/V))-th
//   row of its block's contiguous range of rows, and loads UNROLL rows
//   before it computes.  NCHW-contiguous (every map after a dropout, whose
//   mask is NCHW): a block owns one channel and one of S slices of the
//   batch; a warp walks its slice's planes, the lanes a plane's H*W values.
//   The wrapper refuses other strides.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
// bf16(0.1), the LeakyReLU's slope as jax.nn.leaky_relu multiplies by it
constexpr float SLOPE = 0.10009765625f;

enum Mode { APPLY = 0, GRAD = 1, DX = 2 };

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float rb(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int V> struct Vec;
template <> struct Vec<8> { using T = uint4; };
template <> struct Vec<4> { using T = uint2; };
template <> struct Vec<2> { using T = unsigned; };
template <> struct Vec<1> { using T = unsigned short; };

template <int V>
__device__ __forceinline__ typename Vec<V>::T ld(const bf16* p) {
  return *reinterpret_cast<const typename Vec<V>::T*>(p);
}

template <int V>
__device__ __forceinline__ void unpack(typename Vec<V>::T raw,
                                       float (&f)[V]) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int v = 0; v < V; ++v) f[v] = __bfloat162float(h[v]);
}

template <int V>
__device__ __forceinline__ void st(bf16* p, const float (&f)[V]) {
  typename Vec<V>::T raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = __float2bfloat16_rn(f[v]);
  *reinterpret_cast<typename Vec<V>::T*>(p) = raw;
}

struct Args {
  const bf16* x;
  const bf16* dy;      // GRAD, DX
  bf16* out;           // y (APPLY), bf16(g*x) (GRAD), dx (DX)
  bf16* g;             // GRAD through the LeakyReLU: g
  const float* w;
  const float* bias;
  const float* mean;   // (C,) f32: mean(f32(x))
  const float* e2;     // (C,) f32: mean(f32(x)^2)
  float* rm;           // APPLY: running statistics, updated
  float* rv;
  const bf16* da;      // DX: bf16(sum bf16(g*x)), bf16(sum g)
  const bf16* db;
  float* dwb;          // DX: (2C) dweight, dbias
  long long outer;     // channels_last: rows B*H*W; NCHW: B
  int C;
  int inner;           // NCHW: H*W
  int leaky;
  float eps, mom, keep, ratio, rn;
};

// a channel's constants: a and b of the forward, and dx's per-channel
// factors of u and of the mean's term
struct K {
  float a, b, c1, c2;
};

template <int MODE>
__device__ __forceinline__ K channel(const Args& A, int c, bool owner) {
  const float mean = A.mean[c], w = A.w[c];
  const float var_raw = __fsub_rn(A.e2[c], __fmul_rn(mean, mean));
  // torch.clamp_min(var, 0): NaN stays NaN
  const float var = var_raw < 0.f ? 0.f : var_raw;
  const float inv = rsqrtf(__fadd_rn(var, A.eps));
  const float mi = __fmul_rn(mean, inv);
  K k;
  k.a = rb(__fmul_rn(inv, w));
  k.b = rb(__fsub_rn(A.bias[c], __fmul_rn(mi, w)));
  k.c1 = k.c2 = 0.f;
  if (MODE == APPLY && owner) {
    A.rm[c] = __fadd_rn(__fmul_rn(A.keep, A.rm[c]), __fmul_rn(A.mom, mean));
    A.rv[c] = __fadd_rn(__fmul_rn(A.keep, A.rv[c]),
                        __fmul_rn(A.mom, __fmul_rn(var, A.ratio)));
  }
  if (MODE == DX) {
    const float da = __bfloat162float(A.da[c]);
    const float db = __bfloat162float(A.db[c]);
    const float dmiw = -db;
    const float dmi = __fmul_rn(dmiw, w);
    const float dinv = __fadd_rn(__fmul_rn(da, w), __fmul_rn(dmi, mean));
    const float dve = __fmul_rn(__fmul_rn(-0.5f, dinv),
                                __fmul_rn(__fmul_rn(inv, inv), inv));
    // clamp_min's gradient: where(var_raw >= 0, grad, 0)
    const float dvar = var_raw >= 0.f ? dve : 0.f;
    const float t = __fmul_rn(-dvar, mean);
    const float dmean = __fadd_rn(__fadd_rn(__fmul_rn(dmi, inv), t), t);
    k.c1 = __fmul_rn(dvar, A.rn);
    k.c2 = __fmul_rn(dmean, A.rn);
    if (owner) {
      A.dwb[c] = __fadd_rn(__fmul_rn(da, inv), __fmul_rn(dmiw, mi));
      A.dwb[A.C + c] = db;
    }
  }
  return k;
}

// z = bf16(bf16(x*a) + b)
__device__ __forceinline__ float pre(float x, const K& k) {
  return rb(__fadd_rn(rb(__fmul_rn(x, k.a)), k.b));
}

// the gradient at z: the LeakyReLU's where() backward, z recomputed
__device__ __forceinline__ float grad_z(float x, float dy, const K& k,
                                        bool leaky) {
  if (!leaky) return dy;
  return pre(x, k) >= 0.f ? dy : rb(__fmul_rn(dy, SLOPE));
}

// One element: x (and dy) in, the mode's outputs out (o2: GRAD's g).
template <int MODE>
__device__ __forceinline__ void element(float x, float dy, const K& k,
                                        bool leaky, float& o1, float& o2) {
  if (MODE == APPLY) {
    const float z = pre(x, k);
    o1 = (leaky && !(z >= 0.f)) ? rb(__fmul_rn(z, SLOPE)) : z;
  } else if (MODE == GRAD) {
    o2 = grad_z(x, dy, k, leaky);
    o1 = rb(__fmul_rn(o2, x));
  } else {
    const float g = grad_z(x, dy, k, leaky);
    const float u = __fmul_rn(k.c1, x);
    const float dxs = __fadd_rn(__fadd_rn(u, u), k.c2);
    o1 = rb(__fadd_rn(rb(__fmul_rn(g, k.a)), rb(dxs)));
  }
}

// this block's contiguous range [r0, r1) of `outer` items in `parts`
__device__ __forceinline__ void range_of(long long outer, int parts,
                                         int part, long long& r0,
                                         long long& r1) {
  const long long per = (outer + parts - 1) / parts;
  r0 = per * part;
  r1 = r0 + per < outer ? r0 + per : outer;
}

// ---------------------------------------------------------------- launch 1f

// f32(x)^2 (exact: a bf16 square fits f32's mantissa), in memory order;
// V = 8 (x 16-byte aligned, sq 32-byte aligned: two float4 stores) or 1.
template <int V>
__global__ void __launch_bounds__(THREADS) k5_square(const bf16* x,
                                                     float* sq, long long n) {
  const long long stride = (long long)gridDim.x * THREADS * V;
  for (long long i = ((long long)blockIdx.x * THREADS + threadIdx.x) * V;
       i < n; i += stride) {
    float f[V];
    unpack<V>(ld<V>(x + i), f);
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = __fmul_rn(f[v], f[v]);
    if constexpr (V == 8) {
      float4* o = reinterpret_cast<float4*>(sq + i);
      o[0] = make_float4(f[0], f[1], f[2], f[3]);
      o[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
      sq[i] = f[0];
    }
  }
}

// ---------------------------------------------------------------- channels_last

// Dynamic shared memory: C constants.
template <int MODE, int V>
__global__ void __launch_bounds__(THREADS) k5_cl(Args A) {
  extern __shared__ K ks[];
  const int C = A.C;
  for (int c = threadIdx.x; c < C; c += THREADS)
    ks[c] = channel<MODE>(A, c, blockIdx.x == 0);
  __syncthreads();
  const int tpr = C / V, rpi = THREADS / tpr;
  const int cg = threadIdx.x % tpr, rr = threadIdx.x / tpr;
  if (rr >= rpi) return;
  K kr[V];
#pragma unroll
  for (int v = 0; v < V; ++v) kr[v] = ks[cg * V + v];
  long long r0, r1;
  range_of(A.outer, gridDim.x, blockIdx.x, r0, r1);
  const bool leaky = A.leaky != 0;
  constexpr int U = MODE == APPLY ? UNROLL : UNROLL / 2;
  for (long long r = r0 + rr; r < r1; r += (long long)U * rpi) {
    typename Vec<V>::T xr[U], gr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long ru = r + (long long)u * rpi;
      if (ru < r1) {
        xr[u] = ld<V>(A.x + ru * C + cg * V);
        if (MODE != APPLY) gr[u] = ld<V>(A.dy + ru * C + cg * V);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long ru = r + (long long)u * rpi;
      if (ru < r1) {
        float xv[V], dv[V], o1[V], o2[V];
        unpack<V>(xr[u], xv);
        if (MODE != APPLY) unpack<V>(gr[u], dv);
#pragma unroll
        for (int v = 0; v < V; ++v)
          element<MODE>(xv[v], MODE != APPLY ? dv[v] : 0.f, kr[v], leaky,
                        o1[v], o2[v]);
        const long long off = ru * C + cg * V;
        st<V>(A.out + off, o1);
        if (MODE == GRAD && leaky) st<V>(A.g + off, o2);
      }
    }
  }
}

// ---------------------------------------------------------------- NCHW

// Block (c, s): channel c over batch slice s.
template <int MODE>
__global__ void __launch_bounds__(THREADS) k5_nchw(Args A) {
  __shared__ K kc;
  const int c = blockIdx.x, HW = A.inner;
  if (threadIdx.x == 0) kc = channel<MODE>(A, c, blockIdx.y == 0);
  __syncthreads();
  const K k = kc;
  long long b0, b1;
  range_of(A.outer, gridDim.y, blockIdx.y, b0, b1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool leaky = A.leaky != 0;
  for (long long b = b0 + warp; b < b1; b += WARPS) {
    const size_t base = ((size_t)b * A.C + c) * HW;
    for (int i = lane; i < HW; i += 32 * UNROLL) {
      unsigned short xr[UNROLL], gr[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int iu = i + 32 * u;
        if (iu < HW) {
          xr[u] = ld<1>(A.x + base + iu);
          if (MODE != APPLY) gr[u] = ld<1>(A.dy + base + iu);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int iu = i + 32 * u;
        if (iu < HW) {
          float xv[1], dv[1] = {0.f}, o1[1], o2[1];
          unpack<1>(xr[u], xv);
          if (MODE != APPLY) unpack<1>(gr[u], dv);
          element<MODE>(xv[0], dv[0], k, leaky, o1[0], o2[0]);
          st<1>(A.out + base + iu, o1);
          if (MODE == GRAD && leaky) st<1>(A.g + base + iu, o2);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- dispatch

template <int MODE>
int launch(const Args& A, int layout, int V, int parts, cudaStream_t s) {
  if (A.C <= 0 || A.C > 1024 || A.outer <= 0 || parts <= 0 || A.inner <= 0)
    return (int)cudaErrorInvalidValue;
  if (layout == 1) {
    if (parts > 65535) return (int)cudaErrorInvalidValue;
    k5_nchw<MODE><<<dim3(A.C, parts), THREADS, 0, s>>>(A);
    return (int)cudaGetLastError();
  }
  if (layout != 0 || A.inner != 1 || A.C % V != 0 || A.C / V > THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = A.C * sizeof(K);
  switch (V) {
    case 8: k5_cl<MODE, 8><<<parts, THREADS, smem, s>>>(A); break;
    case 4: k5_cl<MODE, 4><<<parts, THREADS, smem, s>>>(A); break;
    case 2: k5_cl<MODE, 2><<<parts, THREADS, smem, s>>>(A); break;
    case 1: k5_cl<MODE, 1><<<parts, THREADS, smem, s>>>(A); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

Args args(const void* x, const void* w, const void* bias, const void* mean,
          const void* e2, long long outer, int C, int inner, int leaky,
          float eps) {
  Args A{};
  A.x = static_cast<const bf16*>(x);
  A.w = static_cast<const float*>(w);
  A.bias = static_cast<const float*>(bias);
  A.mean = static_cast<const float*>(mean);
  A.e2 = static_cast<const float*>(e2);
  A.outer = outer;
  A.C = C;
  A.inner = inner;
  A.leaky = leaky;
  A.eps = eps;
  return A;
}

}  // namespace

// Forward launch 1 on `stream`: sq = f32(x)^2, n elements in memory
// order; vec8 = 1 where n is a multiple of 8, x is 16-byte aligned and sq
// 32-byte aligned.  Returns a cudaError_t.
extern "C" int k5_bn_square(const void* x, void* sq, long long n, int vec8,
                            int grid, void* stream) {
  if (n <= 0 || grid <= 0 || (vec8 && n % 8)) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  auto* qf = static_cast<float*>(sq);
  if (vec8)
    k5_square<8><<<grid, THREADS, 0, s>>>(xb, qf, n);
  else
    k5_square<1><<<grid, THREADS, 0, s>>>(xb, qf, n);
  return (int)cudaGetLastError();
}

// Forward launch 2: y (bf16, x's layout) from x and the sums' means, the
// running statistics updated in place.  layout 0: channels_last, outer =
// B*H*W rows, inner = 1, `parts` blocks, V channels a thread; layout 1:
// NCHW-contiguous, outer = B, inner = H*W, `parts` batch slices.
extern "C" int k5_bn_apply(const void* x, void* y, const void* w,
                           const void* bias, const void* mean,
                           const void* e2, void* running_mean,
                           void* running_var, int layout, long long outer,
                           int C, int inner, int V, int parts, int leaky,
                           float eps, float mom, float keep, float ratio,
                           void* stream) {
  Args A = args(x, w, bias, mean, e2, outer, C, inner, leaky, eps);
  A.out = static_cast<bf16*>(y);
  A.rm = static_cast<float*>(running_mean);
  A.rv = static_cast<float*>(running_var);
  A.mom = mom;
  A.keep = keep;
  A.ratio = ratio;
  return launch<APPLY>(A, layout, V, parts, static_cast<cudaStream_t>(stream));
}

// Backward launch 1: gx = bf16(g*x) and, through the LeakyReLU, g (bf16,
// x's layout) from x, dy and the forward's means.  Arguments as
// k5_bn_apply's.
extern "C" int k5_bn_grad(const void* x, const void* dy, void* gx, void* g,
                          const void* w, const void* bias, const void* mean,
                          const void* e2, int layout, long long outer, int C,
                          int inner, int V, int parts, int leaky, float eps,
                          void* stream) {
  Args A = args(x, w, bias, mean, e2, outer, C, inner, leaky, eps);
  A.dy = static_cast<const bf16*>(dy);
  A.out = static_cast<bf16*>(gx);
  A.g = static_cast<bf16*>(g);
  return launch<GRAD>(A, layout, V, parts, static_cast<cudaStream_t>(stream));
}

// Backward launch 2: dx (bf16, x's layout) and dwb (2C f32: dweight,
// dbias) from x, dy, the forward's means and the sums da = bf16(sum gx),
// db = bf16(sum g) (C bf16 each); rn = 1/f32(n).
extern "C" int k5_bn_dx(const void* x, const void* dy, void* dx,
                        const void* w, const void* bias, const void* mean,
                        const void* e2, const void* da, const void* db,
                        void* dwb, int layout, long long outer, int C,
                        int inner, int V, int parts, int leaky, float eps,
                        float rn, void* stream) {
  Args A = args(x, w, bias, mean, e2, outer, C, inner, leaky, eps);
  A.dy = static_cast<const bf16*>(dy);
  A.out = static_cast<bf16*>(dx);
  A.da = static_cast<const bf16*>(da);
  A.db = static_cast<const bf16*>(db);
  A.dwb = static_cast<float*>(dwb);
  A.rn = rn;
  return launch<DX>(A, layout, V, parts, static_cast<cudaStream_t>(stream));
}
