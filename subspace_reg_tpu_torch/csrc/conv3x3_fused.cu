// K2 on Hopper: 3x3 convolution (stride 1, padding 1, no bias) with the
// previous BatchNorm's folded affine + LeakyReLU(0.1) in the prologue and
// the output's per-channel batch-statistic sums in the epilogue.
//
// Replaces the TPU kernel subspace_reg_tpu/ops/pallas/conv_fused.py::
// conv3x3_pair (body _conv_pair_kernel).  The plain PyTorch version with the
// same operands and outputs is subspace_reg_tpu_torch/ops/conv_fused.py::
// conv3x3_fused_plain; the wrapper there validates operands, packs the
// weights (pack_k2_weights), chooses the launch plan (k2_plan) and counts
// launches.
//
// Function.  x is NHWC bf16 (B, H, W, Cin).  The prologue computes, for every
// input element inside the image, z = bf16(bf16(x*a) + b) with a and b the
// per-channel affine rounded to bf16, then (relu_in) max(z, bf16(z*bf16(0.1)));
// the zero halo is applied AFTER the activation.  y = conv(z, W) accumulates
// in f32 and rounds once to bf16.  The epilogue sums y and y*y per channel
// over the ROUNDED output into per-block partials; a second kernel reduces
// the partials in a fixed order (no atomics), so a rerun is bit-identical.
//
// What bounds it on the card (batch 64, the fused step's shapes; bf16 at
// 989 TFLOP/s dense, HBM at 3.35 TB/s): 3->64 at 84 px is bound by bytes
// (18 us: its 57.8 MB output), 64->64 at 84 px by bytes (35 us, its
// operations 34 us), 64->160 at 42 px (21 us) and 160->160 at 42 px (53 us)
// by tensor-core operations.
//
// Design (v3): an implicit GEMM on wgmma in persistent, warp-specialized
// blocks.
// * Tile.  The image is read as if its rows were W+2 wide (the padded
//   width): output pixel (h, w) is flat position p = h*(W+2) + w, and tap
//   (kh, kw) reads the zero-padded input at p + kh*(W+2) + kw, so every tap
//   is the same halo shifted by a constant.  A tile is nc*64 consecutive
//   flat positions of one image (nc consumer warpgroups of 64 rows: 3 at
//   64 output channels, 2 at 160) x all output channels; only the two pad
//   columns and the last tile's tail are thrown away (2-9% at 84 and 42
//   px, against v2's 16-23% for 8x16-pixel tiles).  One block per SM walks
//   the tiles blockIdx.x, blockIdx.x + gridDim.x, ...
// * MMA (consumer warpgroups).  wgmma.mma_async m64nNk16, N = 64 or 160
//   (Cout padded with zero weights; the epilogue keeps c < Cout): A (64
//   pixels x 16 input channels) from registers, loaded with ldmatrix.x4 in
//   which each lane passes its own row address, so a tap's shift costs
//   nothing (halo rows padded by CPAD so the eight rows of a matrix hit
//   distinct banks); B (the tap's N x 16 weights, K-major) from shared
//   memory through a matrix descriptor.  A warpgroup loads the A
//   fragments of up to KG = 5 K chunks and then issues their wgmmas back
//   to back: no A register is written while a wgmma is in flight, which
//   would serialize them.  Each tap is accumulated afresh by the tensor
//   cores and added to the sum in f32 round-to-nearest: over all 9*Cin
//   terms the tensor cores' own accumulation moves ~6x more outputs by a
//   bf16 ulp (0.099% against 0.016% at 160->160, on the card).
// * Weights (producer warp).  The wrapper packs them as the shared-memory
//   image of the wgmma B operand (core matrices of 8 rows x 16 bytes, no
//   swizzle: K-adjacent core matrices LBO = 128 bytes apart, N-adjacent
//   SBO = 256, one K chunk of 16 after another), so one cp.async.bulk per
//   unit (up to KG chunks of one tap) brings it in as it is, with no tensor
//   map, through a ring of slots with full/empty mbarriers; where all units
//   fit (the 64-wide convolutions) they are loaded once for the block's
//   life.
// * Halo (7 producer warps).  The next tile's halo (nc*64 + 2(W+2) + 2
//   pixels) is staged into the second of two buffers while the consumers
//   compute on the first: 16-byte cp.async copies zero-filled outside the
//   image, then the prologue applied in place, 8 channels at a time in
//   bf16x2 arithmetic that rounds as the f32 version does (the zero halo
//   stays zero after the activation); the buffers change hands through
//   mbarriers.  Many warps, because staging is a chain of dependent steps
//   per thread; registers move from the producers to the consumers with
//   setmaxnreg.
// * Epilogue.  The wgmma accumulator has mma.sync's per-8-column fragment
//   pattern: round to bf16, store the pixels inside the image, and sum the
//   rounded values per channel with an exchange butterfly over the warp (4
//   shuffles per 8 columns), per warpgroup in a fixed order; the per-(tile,
//   warpgroup) partials are reduced by a second kernel in a fixed order,
//   so a rerun is bit-identical.
// v2 (mma.sync fed by 32-bit shared loads, a block-wide stall per tap,
// 8x16-pixel tiles re-reading every tap's weights from L2, the halo and
// prologue not overlapped with anything) is replaced throughout.  What is
// left on the table: the 160-wide weights stream from L2 for every tile
// (bound by the L2 rate, not the tensor cores), and the epilogue does not
// overlap the same warpgroup's MMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CPAD = 8;            // halo row padding, bf16 elements
constexpr int KG = 5;              // K chunks of 16 per wgmma batch
constexpr int RED_T = 256;         // threads of the partials reduction
constexpr int SMEM_MAX = 232448;   // dynamic shared memory of one block
constexpr uint32_t LBO = 128;      // bytes between K-adjacent core matrices
constexpr uint32_t SBO = 256;      // bytes between N-adjacent core matrices

__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy in flight; with fill=false the 16 bytes
// are zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool fill) {
  const int n = fill ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.b32 %0, 1, 0, P1;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// waits for the phase of the given parity to complete; a wait that lasts
// seconds can only be a fault, and traps instead of holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n == (1u << 22)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" :: "r"(bar) : "memory");
}

// one unit of packed weights (bytes) -> its ring slot by the bulk-copy
// engine, completion counted in bytes on the slot's full barrier
__device__ __forceinline__ void load_tap(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
               : "memory");
}

// no-swizzle K-major descriptor of a B tile starting at smem address addr
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)(LBO >> 4) << 16) | ((uint64_t)(SBO >> 4) << 32);
}

#define K2_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define K2_F16(i) K2_F4(i), K2_F4(i + 4), K2_F4(i + 8), K2_F4(i + 12)

// d (64 x N, f32) = A (64 x 16, bf16 registers) * B (16 x N, descriptor)
// + (scale_d ? d : 0)
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_k16<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : K2_F16(0), K2_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_k16<160>(float (&d)[80],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : K2_F16(0), K2_F16(16), K2_F16(32), K2_F16(48), K2_F16(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
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

// the same on two values at once.  A product or a sum of two bf16 values
// rounded once to bf16 equals the f32 result rounded to bf16 (the product
// is exact in f32; a sum that f32 cannot hold lies within an f32 ulp of a
// bf16 value), so this is bit-identical to prologue(); the _rn forms are
// never contracted into an FMA
__device__ __forceinline__ __nv_bfloat162 prologue2(__nv_bfloat162 z,
                                                    __nv_bfloat162 a,
                                                    __nv_bfloat162 b,
                                                    bool aff, bool relu,
                                                    __nv_bfloat162 slope) {
  if (aff) z = __hadd2_rn(__hmul2_rn(z, a), b);
  if (relu) z = __hmax2(z, __hmul2_rn(z, slope));
  return z;
}

// NCH consecutive K chunks of one tap for a consumer warpgroup: the A
// fragments of all NCH chunks are loaded first (ldmatrix at a_addr + 32
// bytes per chunk), then the NCH wgmmas are issued back to back on B at
// b_addr (N/8 core matrices further per chunk) and retired together; with
// first, the first one starts the accumulator afresh.  No A register is
// written while a wgmma is in flight (which would serialize them); the
// other warpgroups of the block keep the tensor cores busy while this one
// loads.
template <int N, int NCH>
__device__ __forceinline__ void mma_group(float (&d)[N / 2],
                                          uint32_t (&a)[KG][4],
                                          uint32_t a_addr, uint32_t b_addr,
                                          bool first) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) ldmatrix_x4(a[i], a_addr + i * 32);
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < NCH; ++i)
    wgmma_k16<N>(d, a[i], b_desc(b_addr + i * (N / 8) * SBO),
                 (first && i == 0) ? 0 : 1);
  wgmma_commit();
  wgmma_wait<0>();
}

// Shared memory of one block (ops/conv_fused.py::k2_smem_bytes mirrors
// it): the weight ring (stages slots of one unit: up to KG K chunks of one
// tap), nbuf halo buffers, the bf16 affine table (a then b, cin_pad each),
// the statistics scratch (2 x N floats per consumer warp), then the
// mbarriers: full and empty for each ring slot and for each halo buffer.
struct Layout {
  uint32_t slot, halo, halo_bytes, aff, red, bars, total;
};

__host__ __device__ __forceinline__ Layout layout(int n_pad, int cin_pad,
                                                  int stages, int nc,
                                                  int nbuf, int W) {
  const int kch = cin_pad / 16;
  Layout L;
  L.slot = (uint32_t)(kch < KG ? kch : KG) * 16 * n_pad * 2;
  L.halo = stages * L.slot;
  L.halo_bytes = (uint32_t)(nc * 64 + 2 * (W + 2) + 2) * (cin_pad + CPAD) * 2;
  L.aff = L.halo + nbuf * L.halo_bytes;
  L.red = L.aff + cin_pad * 4;
  L.bars = L.red + nc * 4 * 2 * n_pad * 4;
  L.total = L.bars + (2 * stages + 4) * 8;
  return L;
}

struct Args {
  const __nv_bfloat16* x;
  const unsigned char* w;       // packed weights (pack_k2_weights)
  const float* aff_a;           // (Cin,) or null
  const float* aff_b;
  __nv_bfloat16* y;
  float* partials;              // (2, Cout, total * nc)
  int H, W, Cin, Cout, cin_pad, relu, nc, stages, nbuf, tiles, total;
};

constexpr int STAGERS = 224;    // threads that stage halos: 7 warps
constexpr int STAGE_BAR = 4;    // their named barrier (1-3: consumers)

// the halo of tile gt with the prologue applied: flat positions p0 ..
// p0+hq-1 of image gt / tiles' zero-padded input, zero outside the image
// (after the activation).  Cin a multiple of 8: 16-byte cp.async copies,
// then the prologue in place on the pixels inside the image, 8 channels at
// a time (prologue2).  Otherwise element by element, loads batched ahead
// of the stores, the prologue on the way.  The channel padding is never
// written here (it was zeroed once).
__device__ __forceinline__ void stage_halo(const Args& p, __nv_bfloat16* halo,
                                           const __nv_bfloat16* ab, int gt,
                                           int m_tile, int hq, int cs, int wp,
                                           int st) {
  const int img = gt / p.tiles;
  const int p0 = (gt - img * p.tiles) * m_tile;
  const __nv_bfloat16* ximg = p.x + (size_t)img * p.H * p.W * p.Cin;
  const bool aff = p.aff_a != nullptr, relu = p.relu != 0;
  if ((p.Cin & 7) == 0) {
    // thread st owns channels c8 .. c8+7 of pixels i0, i0 + step, ...:
    // the pixel's row and column advance without a division.  Every
    // 16-byte vector is a cp.async copy, zero-filled outside the image,
    // all in flight at once.
    const int cv = p.Cin >> 3, step = STAGERS / cv;
    const bool active = st < step * cv;
    const int c8 = (st % cv) << 3, i0 = st / cv;
    const int pr0 = (p0 + i0) / wp, pc0 = p0 + i0 - pr0 * wp;
    if (active) {
      int pr = pr0, pc = pc0;
      for (int i = i0; i < hq; i += step) {
        const bool inside = pr >= 1 && pr <= p.H && pc >= 1 && pc <= p.W;
        const __nv_bfloat16* src =
            inside ? ximg + ((size_t)(pr - 1) * p.W + (pc - 1)) * p.Cin + c8
                   : p.x;
        cp_async16(halo + i * cs + c8, src, inside);
        for (pc += step; pc >= wp; pc -= wp) ++pr;
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
    if (!(aff || relu)) return;
    // every stager's copies have landed before any applies the prologue
    asm volatile("bar.sync %0, %1;\n" :: "n"(STAGE_BAR), "n"(STAGERS)
                 : "memory");
    if (!active) return;
    const __nv_bfloat162* ab2 = reinterpret_cast<const __nv_bfloat162*>(ab);
    const __nv_bfloat162 slope = __float2bfloat162_rn(0.1f);
    __nv_bfloat162 ca[4], cb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ca[j] = ab2[(c8 >> 1) + j];
      cb[j] = ab2[(p.cin_pad >> 1) + (c8 >> 1) + j];
    }
    // PU pixels a step, all loaded before any is stored back
    constexpr int PU = 2;
    int pr = pr0, pc = pc0;
    for (int i = i0; i < hq; i += PU * step) {
      uint4 val[PU];
      int off[PU];
#pragma unroll
      for (int k = 0; k < PU; ++k) {
        const bool in = i + k * step < hq && pr >= 1 && pr <= p.H &&
                        pc >= 1 && pc <= p.W;
        off[k] = in ? (i + k * step) * cs + c8 : -1;
        if (in) val[k] = *reinterpret_cast<const uint4*>(halo + off[k]);
        for (pc += step; pc >= wp; pc -= wp) ++pr;
      }
#pragma unroll
      for (int k = 0; k < PU; ++k) {
        if (off[k] < 0) continue;
        __nv_bfloat162* z = reinterpret_cast<__nv_bfloat162*>(&val[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          z[j] = prologue2(z[j], ca[j], cb[j], aff, relu, slope);
        *reinterpret_cast<uint4*>(halo + off[k]) = val[k];
      }
    }
  } else {
    constexpr int SB = 8;
    const float slope = rbf(0.1f);
    const int n = hq * p.Cin;
    for (int e0 = st; e0 < n; e0 += SB * STAGERS) {
      __nv_bfloat16 v[SB];
      int off[SB], ch[SB];
      bool inside[SB];
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        const int e = e0 + k * STAGERS;
        const int i = e / p.Cin, c = e - i * p.Cin;
        const int q = p0 + i, pr = q / wp, pc = q - pr * wp;
        inside[k] = e < n && pr >= 1 && pr <= p.H && pc >= 1 && pc <= p.W;
        v[k] = inside[k]
                   ? ximg[((size_t)(pr - 1) * p.W + (pc - 1)) * p.Cin + c]
                   : __float2bfloat16_rn(0.0f);
        off[k] = e < n ? i * cs + c : -1;
        ch[k] = c;
      }
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        if (off[k] < 0) continue;
        __nv_bfloat16 z = v[k];
        if (inside[k] && (aff || relu))
          z = __float2bfloat16_rn(prologue(
              __bfloat162float(z), __bfloat162float(ab[ch[k]]),
              __bfloat162float(ab[p.cin_pad + ch[k]]), aff, relu, slope));
        halo[off[k]] = z;
      }
    }
  }
}

// the 128 threads of consumer warpgroup wg
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// the per-channel sums of 8 columns over the 8 rows (lanes g = lane/4) a
// warp's fragment holds: (s0, s1) sums and (q0, q1) sums of squares of
// columns 2*t4, 2*t4+1.  An exchange butterfly: at each step a lane keeps
// half of its values and sends the other half, so three steps take 4
// shuffles, not 12.  Returns the full sum that lanes with bit 2 clear
// hold: of squares if lane bit 4 is set, else of values, of column
// 2*t4 + (lane bit 3).  A fixed order: a rerun is bit-identical.
__device__ __forceinline__ float col_sums(float s0, float s1, float q0,
                                          float q1, int lane) {
  const bool b4 = lane & 16, b3 = lane & 8;
  const float k0 = (b4 ? q0 : s0)
                   + __shfl_xor_sync(0xffffffffu, b4 ? s0 : q0, 16);
  const float k1 = (b4 ? q1 : s1)
                   + __shfl_xor_sync(0xffffffffu, b4 ? s1 : q1, 16);
  const float m = (b3 ? k1 : k0)
                  + __shfl_xor_sync(0xffffffffu, b3 ? k0 : k1, 8);
  return m + __shfl_xor_sync(0xffffffffu, m, 4);
}

template <int N> struct Inst;
// Threads: nc consumer warpgroups, then two producer warpgroups (their
// first warp: the weights; the other 7: the halos, whose staging is a
// chain of dependent steps per thread and wants many warps).  64 output
// channels: three consumer warpgroups (192 flat positions); 160: two, each
// consumer thread holding 160 accumulator registers (a per-tap
// accumulator beside the sum).  setmaxnreg moves registers from the
// producers to the consumers, whole warpgroups at a time, and a block's
// increases draw only on what its own decreases released: from the entry
// count R (65536 / threads, rounded down to 8: 96 at 640 threads, 128 at
// 512), consumers x (inc - R) <= producers x (R - dec).
template <> struct Inst<64> {
  static constexpr int MAX_NC = 3, PRODUCER_REGS = 56, CONSUMER_REGS = 120;
};
template <> struct Inst<160> {
  static constexpr int MAX_NC = 2, PRODUCER_REGS = 48, CONSUMER_REGS = 208;
};
constexpr int PRODUCER_THREADS = 256;

// One persistent block walks the tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...; tile gt is flat positions (gt % tiles) * nc*64 ... of image
// gt / tiles.  KCH: input channels / 16 (padded).
template <int N, int KCH>
__global__ void __launch_bounds__(Inst<N>::MAX_NC * 128 + PRODUCER_THREADS,
                                  1)
conv3x3_kernel(const Args p) {
  constexpr int KGN = KCH < KG ? KCH : KG;         // chunks per full unit
  constexpr int NGRP = (KCH + KGN - 1) / KGN;      // units per tap
  constexpr int LAST = KCH - (NGRP - 1) * KGN;     // chunks of the last
  constexpr int UNITS = 9 * NGRP;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(N, p.cin_pad, p.stages, p.nc, p.nbuf, p.W);
  const int cs = p.cin_pad + CPAD;                 // halo row stride, bf16
  const int wp = p.W + 2;                          // padded row width
  const int m_tile = p.nc * 64;
  const int hq = m_tile + 2 * wp + 2;              // halo pixels
  const bool resident = p.stages >= UNITS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full0 = smem_u32(smem + L.bars);
  const uint32_t empty0 = full0 + 8 * p.stages;
  const uint32_t hfull0 = empty0 + 8 * p.stages;   // 2 halo buffers
  const uint32_t hempty0 = hfull0 + 16;
  __nv_bfloat16* ab = reinterpret_cast<__nv_bfloat16*>(smem + L.aff);

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, p.nc * 4);   // lane 0 of every consumer warp
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(hfull0 + 8 * b, STAGERS);
      mbar_init(hempty0 + 8 * b, p.nc * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the affine table, rounded to bf16 (a = 1, b = 0 without an affine),
  // and the halo buffers' channel padding, which staging never writes
  for (int c = tid; c < p.cin_pad; c += blockDim.x) {
    const bool on = p.aff_a != nullptr && c < p.Cin;
    ab[c] = __float2bfloat16_rn(on ? p.aff_a[c] : 1.0f);
    ab[p.cin_pad + c] = __float2bfloat16_rn(on ? p.aff_b[c] : 0.0f);
  }
  if (p.cin_pad > p.Cin) {
    const int pad = p.cin_pad - p.Cin;
    __nv_bfloat16* h0 = reinterpret_cast<__nv_bfloat16*>(smem + L.halo);
    for (int e = tid; e < p.nbuf * hq * pad; e += blockDim.x) {
      const int i = e / pad;
      h0[i * cs + p.Cin + (e - i * pad)] = __float2bfloat16_rn(0.0f);
    }
  }
  __syncthreads();

  if (warp >= p.nc * 4) {
    // ---- producer warpgroups -------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(Inst<N>::PRODUCER_REGS));
    if (warp == p.nc * 4) {
      // the weight units, each into the slot its consumers have released;
      // where all units fit, once for the block's life
      if (lane == 0) {
        const int my_tiles = (p.total - 1 - (int)blockIdx.x) / gridDim.x + 1;
        const int n_units = resident ? UNITS : my_tiles * UNITS;
        for (int seq = 0; seq < n_units; ++seq) {
          const int u = seq % UNITS, t = u / NGRP, k0 = (u - t * NGRP) * KGN;
          const int nch = KCH - k0 < KGN ? KCH - k0 : KGN;
          const int s = resident ? u : seq % p.stages;
          if (!resident)
            mbar_wait(empty0 + 8 * s, ((seq / p.stages) & 1) ^ 1);
          load_tap(ring + s * L.slot,
                   p.w + (size_t)(t * KCH + k0) * 16 * N * 2,
                   nch * 16 * N * 2, full0 + 8 * s);
        }
      }
    } else {
      // the halos, each into the buffer its consumers have released
      const int st = tid - (p.nc * 4 + 1) * 32;
      int it = 0;
      for (int gt = blockIdx.x; gt < p.total; gt += gridDim.x, ++it) {
        const int buf = it % p.nbuf, round = it / p.nbuf;
        mbar_wait(hempty0 + 8 * buf, (round & 1) ^ 1);
        stage_halo(p, reinterpret_cast<__nv_bfloat16*>(
                          smem + L.halo + buf * L.halo_bytes),
                   ab, gt, m_tile, hq, cs, wp, st);
        mbar_arrive(hfull0 + 8 * buf);
      }
    }
    return;
  }

  // ---- consumers --------------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(Inst<N>::CONSUMER_REGS));
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix.x4 row of this lane: matrices 0/1 are rows 0-7/8-15 at
  // channels 0-7, matrices 2/3 the same rows at channels 8-15 (the A
  // fragment's a0..a3)
  const int arow = wg * 64 + wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t a_off = (arow * cs + (lane >> 4) * 8) * 2;
  float* red = reinterpret_cast<float*>(smem + L.red);
  float d[N / 2], pt[N / 2];
  uint32_t a[KG][4];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pt[i] = 0.0f;

  int it = 0;
  for (int gt = blockIdx.x; gt < p.total; gt += gridDim.x, ++it) {
    const int buf = it % p.nbuf, round = it / p.nbuf;
    mbar_wait(hfull0 + 8 * buf, round & 1);

    // ---- 9 taps: each accumulated afresh in pt by wgmma, then added to
    //      d in f32 round-to-nearest (the tensor cores' own accumulation
    //      over all 9*Cin terms moves ~6x more outputs by a bf16 ulp) -----
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[i] = 0.0f;
    const uint32_t a_base =
        smem_u32(smem + L.halo + buf * L.halo_bytes) + a_off;
    for (int t = 0; t < 9; ++t) {
      const int kh = t / 3, kw = t - kh * 3;
      const uint32_t a_tap = a_base + (kh * wp + kw) * cs * 2;
#pragma unroll
      for (int grp = 0; grp < NGRP; ++grp) {
        const int u = t * NGRP + grp;
        const int seq = it * UNITS + u;
        const int s = resident ? u : seq % p.stages;
        mbar_wait(full0 + 8 * s, resident ? 0 : (seq / p.stages) & 1);
        if (grp < NGRP - 1)
          mma_group<N, KGN>(pt, a, a_tap + grp * KGN * 32, ring + s * L.slot,
                            grp == 0);
        else
          mma_group<N, LAST>(pt, a, a_tap + grp * KGN * 32, ring + s * L.slot,
                             grp == 0);
        if (!resident && lane == 0) mbar_arrive(empty0 + 8 * s);
      }
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] = __fadd_rn(d[i], pt[i]);
    }
    // the halo buffer is free for the tile after next
    if (lane == 0) mbar_arrive(hempty0 + 8 * buf);

    // ---- epilogue: round, store, per-channel sums of the rounded output -
    const int img = gt / p.tiles;
    const int p0 = (gt - img * p.tiles) * m_tile;
    const int pa = p0 + wg * 64 + wq * 16 + g, pb = pa + 8;
    const int ha = pa / wp, wa = pa - ha * wp;
    const int hb = pb / wp, wb = pb - hb * wp;
    const bool va = ha < p.H && wa < p.W, vb = hb < p.H && wb < p.W;
    __nv_bfloat16* ya = p.y + (((size_t)img * p.H + ha) * p.W + wa) * p.Cout;
    __nv_bfloat16* yb = p.y + (((size_t)img * p.H + hb) * p.W + wb) * p.Cout;
    float* wred = red + warp * 2 * N;          // (2, N) of this warp
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (j * 8 < p.Cout) {
        const int c = j * 8 + 2 * t4;
        const __nv_bfloat162 r0 =
            __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
        const __nv_bfloat162 r1 =
            __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
        if (va) *reinterpret_cast<__nv_bfloat162*>(ya + c) = r0;
        if (vb) *reinterpret_cast<__nv_bfloat162*>(yb + c) = r1;
        const float f00 = va ? __low2float(r0) : 0.0f;
        const float f01 = va ? __high2float(r0) : 0.0f;
        const float f10 = vb ? __low2float(r1) : 0.0f;
        const float f11 = vb ? __high2float(r1) : 0.0f;
        const float sum = col_sums(f00 + f10, f01 + f11,
                                   f00 * f00 + f10 * f10,
                                   f01 * f01 + f11 * f11, lane);
        if ((lane & 4) == 0)
          wred[((lane >> 4) & 1) * N + c + ((lane >> 3) & 1)] = sum;
      }
    }
    // this warpgroup's partials of this tile: its 4 warps in order
    warpgroup_sync(wg);
    const int n_part = p.total * p.nc;
    for (int e = tid - wg * 128; e < 2 * p.Cout; e += 128) {
      const int which = e / p.Cout, c = e - which * p.Cout;
      float s = 0.0f;
      for (int wi = wg * 4; wi < wg * 4 + 4; ++wi)
        s += red[(wi * 2 + which) * N + c];
      p.partials[((size_t)which * p.Cout + c) * n_part + gt * p.nc + wg] = s;
    }
    warpgroup_sync(wg);            // the scratch is free for the next tile
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

template <int N, int KCH>
cudaError_t launch_conv(const Args& p, int grid, size_t smem,
                        cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<N, KCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  conv3x3_kernel<N, KCH><<<grid, p.nc * 128 + PRODUCER_THREADS, smem, s>>>(
      p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const Args& p, int grid, size_t smem, cudaStream_t s) {
  switch (p.cin_pad / 16) {
    case 1: return launch_conv<N, 1>(p, grid, smem, s);
    case 2: return launch_conv<N, 2>(p, grid, smem, s);
    case 3: return launch_conv<N, 3>(p, grid, smem, s);
    case 4: return launch_conv<N, 4>(p, grid, smem, s);
    case 5: return launch_conv<N, 5>(p, grid, smem, s);
    case 6: return launch_conv<N, 6>(p, grid, smem, s);
    case 7: return launch_conv<N, 7>(p, grid, smem, s);
    case 8: return launch_conv<N, 8>(p, grid, smem, s);
    case 9: return launch_conv<N, 9>(p, grid, smem, s);
    case 10: return launch_conv<N, 10>(p, grid, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (B,H,W,Cin) bf16; w the packed weights (9, Cin/16 chunks, N/8, 2, 8, 8)
// bf16 with N = 64 for Cout <= 64, else 160 (ops/conv_fused.py::
// pack_k2_weights); a, b (Cin,) f32 or null; y (B,H,W,Cout) bf16; partials
// (2,Cout,n_blk*nc) f32 with n_blk = B * tiles (one per tile and consumer
// warpgroup); stats (2,Cout) f32.  The plan
// (ops/conv_fused.py::k2_plan): nc consumer warpgroups of 64 flat positions
// per block, stages weight slots, nbuf halo buffers, grid persistent
// blocks.  Returns the first CUDA error (0 on success).
extern "C" int k2_conv3x3_fused(const void* x, const void* w, const void* a,
                                const void* b, void* y, void* partials,
                                void* stats, int B, int H, int W, int Cin,
                                int Cout, int relu_in, int nc, int stages,
                                int nbuf, int grid, int n_blk, void* stream) {
  const int n_pad = Cout <= 64 ? 64 : 160;
  const int max_nc = n_pad == 64 ? Inst<64>::MAX_NC : Inst<160>::MAX_NC;
  if (Cout <= 0 || Cout % 8 != 0 || Cout > 160 || Cin <= 0 || Cin > 160 ||
      (a == nullptr) != (b == nullptr) || nc < 1 || nc > max_nc ||
      stages < 1 || nbuf < 1 || nbuf > 2 || (nbuf == 2 && Cin % 8 != 0) ||
      B <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const int cin_pad = (Cin + 15) / 16 * 16;
  const int kch = cin_pad / 16, kgn = kch < KG ? kch : KG;
  if (stages > 9 * ((kch + kgn - 1) / kgn)) return (int)cudaErrorInvalidValue;
  const int tiles = (H * (W + 2) + nc * 64 - 1) / (nc * 64);
  if (n_blk != B * tiles || grid < 1 || grid > n_blk)
    return (int)cudaErrorInvalidValue;
  const size_t smem = layout(n_pad, cin_pad, stages, nc, nbuf, W).total;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  Args p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const unsigned char*>(w);
  p.aff_a = static_cast<const float*>(a);
  p.aff_b = static_cast<const float*>(b);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.partials = static_cast<float*>(partials);
  p.H = H; p.W = W; p.Cin = Cin; p.Cout = Cout; p.cin_pad = cin_pad;
  p.relu = relu_in; p.nc = nc; p.stages = stages; p.nbuf = nbuf;
  p.tiles = tiles; p.total = n_blk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = n_pad == 64 ? launch_n<64>(p, grid, smem, s)
                                      : launch_n<160>(p, grid, smem, s);
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<2 * Cout, RED_T, 0, s>>>(p.partials,
                                             static_cast<float*>(stats),
                                             n_blk * nc);
  return (int)cudaGetLastError();
}
