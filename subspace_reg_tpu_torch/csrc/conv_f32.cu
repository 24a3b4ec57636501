// K4 on Hopper: the backbone's f32 convolution, as a direct implicit GEMM
// on FFMA.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA
// (subspace_reg_tpu/models/resnet.py).  The port's evaluation forwards
// resnet18 in f32 with TF32 off, and its convolutions are ~80% of an
// evaluation's device time, so they get a kernel of their own.  The plain
// PyTorch version with the same operands and outputs is
// subspace_reg_tpu_torch/ops/conv_f32.py::conv_f32_plain; the wrapper
// there validates operands, lays out the weights, picks the tile shape
// (conv_f32_plan) and counts launches.
//
// Function.  y = conv2d(x, w), stride 1, padding R/2, no bias, R = 3 or 1.
// x is NHWC f32 (M = B*H*W pixel rows of C channels, C a multiple of 4),
// wt is the weight laid out K-major: row (r*R + s)*C + c holds w[n][c][r][s]
// for the N output channels (N a multiple of 4), each aligned group of
// four channels stored rotated by one, as (1, 2, 3, 0); y is NHWC f32 (M
// rows of N).  As a GEMM: y[m][n] = sum_k A[m][k] wt[k][n], with
// A[m][(r*R + s)*C + c] = x[b, h + r - R/2, w + s - R/2, c] (zero outside
// the image).  Every product and sum is an f32 FFMA (fma.rn.f32): no TF32,
// no half precision, no FFT or Winograd transform.  Each output is summed
// in k order within one thread, so a rerun is bit-identical.
//
// What bounds it on the card: operations.  A resnet18 forward at 84 px is
// 8.12 GFLOP a row, 121 us a row at 67 TFLOP/s (FP32 outside the tensor
// cores); a 3x3 convolution of 64 -> 64 channels at 84 x 84 does ~140 FLOP
// per byte it must move and 320 -> 320 at 10 x 10 ~700, against the card's
// f32 balance point of 20.  So the kernel has to keep the FFMA pipes busy:
// issue FFMAs, and as few other instructions as it can, in every cycle.
//
// Design.
// * Tiles of BM pixel rows x BN output channels (BM = 64 WM, BN = 32 WN),
//   WM x WN warps; a warp holds 64 x 32 outputs as 8 x 4 lanes, each lane
//   an 8 x 8 register micro-tile: rows tm + 8i of its warp's 64 (i < 8),
//   columns 4tn..4tn+3 and 16 + 4tn..16 + 4tn + 3 of its 32.  Per 4 k, a
//   lane loads 8 float4 of A and 8 float4 of B from shared memory for 256
//   FFMAs, double-buffered in registers: the next 4 k's A and the next k's
//   B are loaded while the current ones are multiplied.  The lanes of a
//   quarter warp read two adjacent A rows (banks 16 apart) and 64
//   contiguous bytes of B: no bank conflict.
//   The rotated weight columns put each accumulator and its B operand in
//   registers of different parity (the accumulators must sit in aligned
//   quads for the float4 stores, the B operands for the float4 loads).
// * K runs in tiles of BK channels of one tap (BK = 16; 4 where C is not a
//   multiple of 16, as for the first layer's 3 channels padded to 4).  The
//   A tile of a k tile is then a box of the (M, C) activation matrix: BM
//   rows from m0 + (r - R/2) W + (s - R/2), BK channels.  One thread copies
//   it, and the weight tile, with the Tensor Memory Accelerator (TMA, one
//   cp.async.bulk.tensor each, completion counted in bytes on the stage's
//   mbarrier), so the warps that multiply issue no load instructions.
//   Rows past either end of the matrix come in as zeros; rows whose tap
//   falls outside their own image (the halo) are zeroed in shared memory
//   by the thread that owns the row, from a per-row bit mask of the taps
//   inside the image, made once a tile.
// * Three stages of A and B tiles in dynamic shared memory: the copies for
//   k tile t + 2 are in flight while t is computed; one __syncthreads per
//   k tile.
// * Persistent blocks: a grid of at most (SMs x resident blocks) walks the
//   tiles, N fastest, so blocks that run together share their A rows in
//   L2.  A block issues the next tile's first two k tiles before it
//   stores the finished tile from registers, so the stores overlap the
//   copies.
// * The instance (tile shape) is picked per call from the layer's shape by
//   the wrapper (conv_f32_plan).  32-bit offsets: the wrapper refuses
//   operands of 2^31 elements or more.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// waits for the phase of the given parity to complete; a wait that lasts
// seconds can only be a fault, and traps instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 24)) __trap();
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// a 2-D box of `map` at (c0, c1), innermost first, into shared memory;
// completion counted in bytes on `bar`; coordinates outside the tensor
// read as zeros
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int KK>
__device__ __forceinline__ float part(const float4& v) {
  return KK == 0 ? v.x : KK == 1 ? v.y : KK == 2 ? v.z : v.w;
}

template <int WM, int WN, int BK>
struct Tile {
  static constexpr int BM = 64 * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int A_FLOATS = BM * BK;
  static constexpr int B_FLOATS = BK * BN;
  static constexpr int STAGE_BYTES = (A_FLOATS + B_FLOATS) * 4;
  // the stages, then one mbarrier per stage
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + STAGES * 8;
  // A rows a thread owns for zeroing the halo: tid, tid + THREADS, ...
  static constexpr int ROWS = (BM + THREADS - 1) / THREADS;
  static_assert((A_FLOATS * 4) % 128 == 0 && (B_FLOATS * 4) % 128 == 0,
                "TMA destinations are 128-byte aligned");
};

// acc[i][.] += a_i * b for one k: b0, b1 hold columns (1, 2, 3, 0) and
// (5, 6, 7, 4) of the lane's eight
template <int KK>
__device__ __forceinline__ void fma_k(float (&acc)[8][8],
                                      const float4 (&a)[8], const float4& b0,
                                      const float4& b1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float av = part<KK>(a[i]);
    acc[i][1] = fmaf(av, b0.x, acc[i][1]);
    acc[i][2] = fmaf(av, b0.y, acc[i][2]);
    acc[i][3] = fmaf(av, b0.z, acc[i][3]);
    acc[i][0] = fmaf(av, b0.w, acc[i][0]);
    acc[i][5] = fmaf(av, b1.x, acc[i][5]);
    acc[i][6] = fmaf(av, b1.y, acc[i][6]);
    acc[i][7] = fmaf(av, b1.z, acc[i][7]);
    acc[i][4] = fmaf(av, b1.w, acc[i][4]);
  }
}

// The k tile that a counter walks, in k order: channel offset and tap.
struct KPos {
  int c0 = 0, r = 0, s = 0;
  __device__ __forceinline__ void next(int bk, int C, int R) {
    c0 += bk;
    if (c0 == C) {
      c0 = 0;
      if (++s == R) {
        s = 0;
        ++r;
      }
    }
  }
};

template <int WM, int WN, int BK, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
    conv_f32_igemm(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   float* __restrict__ y, int M, int H, int W, int C, int N,
                   int R, int tiles_n, int tiles) {
  using T = Tile<WM, WN, BK>;
  constexpr int BM = T::BM, BN = T::BN;
  extern __shared__ __align__(128) float4 smem4[];
  float* const As = reinterpret_cast<float*>(smem4);  // [STAGES][BM][BK]
  float* const Bs = As + STAGES * T::A_FLOATS;        // [STAGES][BK][BN]
  const uint32_t bar0 = smem_u32(Bs + STAGES * T::B_FLOATS);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int tm = lane >> 2, tn = lane & 3;
  const int pad = R >> 1;
  const int kt_count = R * R * (C / BK);

  int tile = blockIdx.x;
  if (tile >= tiles) return;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(bar0 + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 copies k tile `kt` of `tile` into stage `st`
  KPos ld;
  auto load_tile = [&](int st, int kt, int tile_) {
    const int m0 = (tile_ / tiles_n) * BM, n0 = (tile_ % tiles_n) * BN;
    const uint32_t bar = bar0 + 8 * st;
    mbar_expect(bar, T::STAGE_BYTES);
    tma_load(smem_u32(As + st * T::A_FLOATS), map_x, ld.c0,
             m0 + (ld.r - pad) * W + (ld.s - pad), bar);
    tma_load(smem_u32(Bs + st * T::B_FLOATS), map_w, n0, kt * BK, bar);
    ld.next(BK, C, R);
  };
  auto prologue = [&](int tile_, int it0) {
    if (tid != 0) return;
    ld = KPos();
    for (int j = 0; j < STAGES - 1 && j < kt_count; ++j)
      load_tile((it0 + j) % STAGES, j, tile_);
  };

  prologue(tile, 0);
  int it = 0;  // k tiles consumed by this block: stage it % STAGES
  float acc[8][8];
  while (true) {
    const int m0 = (tile / tiles_n) * BM;
    const int n0 = (tile % tiles_n) * BN;
    // the taps whose source pixel lies inside the image of each A row this
    // thread owns; rows past M read zeros from the copy itself
    unsigned taps[T::ROWS];
#pragma unroll
    for (int j = 0; j < T::ROWS; ++j) {
      const int row = tid + j * T::THREADS;
      taps[j] = ~0u;
      if (row < BM && m0 + row < M) {
        const int p = (m0 + row) % (H * W);
        const int h = p / W, w = p - (p / W) * W;
        taps[j] = 0u;
        for (int r = 0; r < R; ++r)
          for (int s = 0; s < R; ++s)
            if ((unsigned)(h + r - pad) < (unsigned)H &&
                (unsigned)(w + s - pad) < (unsigned)W)
              taps[j] |= 1u << (r * R + s);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    KPos cs;
    for (int kt = 0; kt < kt_count; ++kt, ++it) {
      const int stage = it % STAGES;
      mbar_wait(bar0 + 8 * stage, (it / STAGES) & 1);
      bool zeroed = false;
#pragma unroll
      for (int j = 0; j < T::ROWS; ++j) {
        if (!((taps[j] >> (cs.r * R + cs.s)) & 1u)) {
          float4* row = reinterpret_cast<float4*>(
              As + stage * T::A_FLOATS + (tid + j * T::THREADS) * BK);
#pragma unroll
          for (int q = 0; q < BK / 4; ++q) row[q] = make_float4(0, 0, 0, 0);
          zeroed = true;
        }
      }
      // the next copy into this stage comes from the async proxy
      if (zeroed) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cs.next(BK, C, R);
      // the halo is zeroed, and every warp is done with stage it - 1
      __syncthreads();
      if (tid == 0 && kt + STAGES - 1 < kt_count)
        load_tile((it + STAGES - 1) % STAGES, kt + STAGES - 1, tile);

      const float* as = As + stage * T::A_FLOATS + (wm * 64 + tm) * BK;
      const float* bs = Bs + stage * T::B_FLOATS + wn * 32 + tn * 4;
      float4 a[2][8], b[2][2];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[0][i] = lds4(as + i * 8 * BK);
      b[0][0] = lds4(bs);
      b[0][1] = lds4(bs + 16);
#pragma unroll
      for (int kq = 0; kq < BK / 4; ++kq) {
        const int cur = kq & 1;
        if (kq + 1 < BK / 4) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a[cur ^ 1][i] = lds4(as + i * 8 * BK + (kq + 1) * 4);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int k = kq * 4 + kk, bc = k & 1;
          if (k + 1 < BK) {
            b[bc ^ 1][0] = lds4(bs + (k + 1) * BN);
            b[bc ^ 1][1] = lds4(bs + (k + 1) * BN + 16);
          }
          if (kk == 0) fma_k<0>(acc, a[cur], b[bc][0], b[bc][1]);
          if (kk == 1) fma_k<1>(acc, a[cur], b[bc][0], b[bc][1]);
          if (kk == 2) fma_k<2>(acc, a[cur], b[bc][0], b[bc][1]);
          if (kk == 3) fma_k<3>(acc, a[cur], b[bc][0], b[bc][1]);
        }
      }
    }

    // every warp is done with this tile's stages: start the next tile's
    // copies, then store this one from registers
    const int next = tile + gridDim.x;
    __syncthreads();
    if (next < tiles) prologue(next, it);
    const int n = n0 + wn * 32 + tn * 4;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + wm * 64 + tm + 8 * i;
      if (m < M) {
        float* dst = y + (m * N + n);
        if (n < N)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (n + 16 < N)
          *reinterpret_cast<float4*>(dst + 16) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    if (next >= tiles) break;
    tile = next;
  }
}

template <int WM, int WN, int BK, int MINB>
int set_smem() {
  return (int)cudaFuncSetAttribute(
      conv_f32_igemm<WM, WN, BK, MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<WM, WN, BK>::SMEM_BYTES);
}

template <int WM, int WN, int BK, int MINB>
int occupancy(int* blocks) {
  using T = Tile<WM, WN, BK>;
  const int e = set_smem<WM, WN, BK, MINB>();
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, conv_f32_igemm<WM, WN, BK, MINB>, T::THREADS, T::SMEM_BYTES);
}

// cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint, so the
// library links against the CUDA runtime alone
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the map of a row-major (rows, cols) f32 matrix read in boxes of
// (box_rows, box_cols)
bool encode(CUtensorMap* map, const void* base, int rows, int cols,
            int box_rows, int box_cols) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WM, int WN, int BK, int MINB>
int launch(const float* x, const float* wt, float* y, int M, int H, int W,
           int C, int N, int R, int grid, cudaStream_t stream) {
  using T = Tile<WM, WN, BK>;
  if (C % BK != 0) return (int)cudaErrorInvalidValue;
  const int tiles_n = (N + T::BN - 1) / T::BN;
  const int tiles = ((M + T::BM - 1) / T::BM) * tiles_n;
  if (grid <= 0 || grid > tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w;
  if (!encode(&map_x, x, M, C, T::BM, BK) ||
      !encode(&map_w, wt, R * R * C, N, BK, T::BN))
    return (int)cudaErrorInvalidValue;
  const int e = set_smem<WM, WN, BK, MINB>();
  if (e != 0) return e;
  conv_f32_igemm<WM, WN, BK, MINB><<<grid, T::THREADS, T::SMEM_BYTES,
                                     stream>>>(map_x, map_w, y, M, H, W, C,
                                               N, R, tiles_n, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// The instances, in the order of ops/conv_f32.py::K4_CONFIGS: (id, WM, WN,
// BK, blocks an SM must hold) with the tile (64 WM) x (32 WN).
#define K4_INSTANCES(X) \
  X(0, 2, 2, 16, 4)     \
  X(1, 4, 1, 16, 3)     \
  X(2, 2, 2, 4, 4)

// Blocks of instance `config` resident on one SM (sets the kernel's
// dynamic shared memory limit first).  Returns a cudaError_t.
extern "C" int k4_conv_f32_occupancy(int config, int* blocks) {
  switch (config) {
#define K4_OCC(id, wm, wn, bk, minb) \
  case id:                           \
    return occupancy<wm, wn, bk, minb>(blocks);
    K4_INSTANCES(K4_OCC)
#undef K4_OCC
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// One launch of instance `config` on `stream`: x (M, C) NHWC, wt (R*R*C,
// N) with its column groups rotated, y (M, N), all f32 and 16-byte
// aligned; `grid` persistent blocks.  Returns a cudaError_t (the launch's,
// from cudaGetLastError; cudaErrorInvalidValue also where the tensor maps
// cannot be made).
extern "C" int k4_conv_f32(int config, const void* x, const void* wt,
                           void* y, int M, int H, int W, int C, int N, int R,
                           int grid, void* stream) {
  if (M <= 0 || H <= 0 || W <= 0 || C <= 0 || N <= 0 || C % 4 != 0 ||
      N % 4 != 0 || (R != 1 && R != 3))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(wt);
  auto* yf = static_cast<float*>(y);
  switch (config) {
#define K4_LAUNCH(id, wm, wn, bk, minb) \
  case id:                              \
    return launch<wm, wn, bk, minb>(xf, wf, yf, M, H, W, C, N, R, grid, s);
    K4_INSTANCES(K4_LAUNCH)
#undef K4_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}
