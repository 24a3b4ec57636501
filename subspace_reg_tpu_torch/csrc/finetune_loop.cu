// K1 on Hopper: the whole FSCIL head fine-tune loop (epochs 2..N) in one
// launch, run by a persistent cooperative grid across the card's SMs.
//
// Replaces the TPU kernel subspace_reg_tpu/ops/pallas/finetune.py::
// finetune_loop_pallas (body _make_kernel).  The plain PyTorch twin with the
// same operands and outputs is subspace_reg_tpu_torch/ops/finetune.py::
// finetune_loop_plain; the wrapper there validates operands, pads the
// feature axis to a multiple of 4, makes the launch plan (k1_plan: the
// same integers this file checks), allocates every scratch buffer and
// counts launches.
//
// Each epoch computes, on features cached by the caller:
//   support CE (+ masked replay CE averaged over the valid rows), the
//   un-squared base anchor lmbd*||W[:base]-W0|| with a zero subgradient at 0
//   (its bias column squared), the previous-novel anchor, the subspace pull
//   gamma*||cur*M||^2 or the semantic pull to a constant target, coupled
//   weight decay, SGD-momentum or Adam (b1^t by recurrence), the
//   stable/target/max-epoch stop, and one (loss, acc1, acc5) trace row.
//
// What bounds it on the card.  Per epoch at the golden geometry (185
// support rows, up to 175 valid replay rows, 100 classes, D=640) the work
// is ~2*2*360*100*640 + 2*5*640*640 ~ 96 MFLOP of FP32 that depends on the
// previous epoch's weights, so epochs are strictly serial; the operands
// (~5 MB with M) stay in the 50 MB L2.  The card-wide FP32 bound is
// ~1.44 us/epoch.  One SM alone reaches ~1/132 of it, so the epoch is
// spread over P blocks (at most one per SM, all resident: the launch is
// cooperative).  What is left per epoch is two grid barriers and the
// longest work item of each phase; neither the FP32 rate nor HBM bounds
// those items, but L2: a logits tile streams all of W (256 KB) through
// its SM's L2 port, and every load that many SMs make of the same lines
// at once (the partial sums, dlog, the current rows) waits in line.
// chip_smoke.py phase 3 prints each part's time from the kernel's own
// clocks (Clock below).
//
// One epoch, two phases, a grid barrier after each:
//   A (reads W_e)  work items dealt round-robin, item i to block i % P:
//      - logits tiles of TR support/replay rows x all active classes: F's
//        rows in shared memory, W streamed from L2 into registers; one warp
//        per row then takes the softmax, the top-1/top-5 rank and the loss,
//        and writes dlog (scratch, stride ldl) -- a block owns whole rows,
//        so nothing crosses blocks;
//      - column chunks of the subspace pull V = cur*M: M's columns (bias
//        row zeroed) and the current rows staged with cp.async.
//      Each block writes its phase-A partial sums to its own slots.
//   B  every block reduces all slots in one fixed order, so every block
//      holds the same bits of the loss, the inverse anchor norms, the
//      accuracies and the stop decision, with no broadcast.  Then each
//      update tile (TC classes x TJ columns, tile u to block u % P)
//      computes G = dlog^T F over all rows (staged with cp.async; rows
//      split over the warps, summed across warps in a fixed order) and, in
//      the same epilogue, the full gradient and the optimizer update of W,
//      mom and nu for that tile in place: no block reads another block's
//      tile of W in phase B.  The epilogue holds the new W, W0, reserved
//      and the target in registers, so it also sums the next epoch's anchor
//      terms ||W-W0||^2 (bias column apart), ||W-R||^2 and ||W-T||^2; they
//      go to a second slot set, alternating by epoch parity (the prologue
//      sums epoch 2's).  This is a third of phase A's work that needed
//      another pass over W from L2.
// The second barrier protects W_{e+1}, dlog and the slots.  The prologue
// (copies of w_in/mom_in/nu_in into the outputs, per update tile) ends at
// a barrier too.  A block that owns one phase-A item keeps that item's
// constant operand (its F rows or M columns) in shared memory for the
// whole launch; one that owns one update tile keeps its F columns.  With
// fewer blocks than items they are restaged each epoch.
//
// The grid barrier is a counter that the wrapper zeroes: one thread per
// block arrives with a fenced atomic add and spins on acquire loads of
// the counter until it reaches the barrier's target.  Data written by
// another block during the launch is read through L2 (ld.global.cg,
// cp.async.cg).  No float atomics: every sum runs in a fixed order, so a
// rerun is bit-identical.  All math is FP32 on the CUDA cores (no tensor
// cores, no TF32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// tiling; the wrapper's K1_* constants in ops/finetune.py follow these
constexpr int NT = 256;            // threads per block
constexpr int NWARPS = NT / 32;
constexpr int TR = 8;              // logits rows per tile: one warp each
constexpr int QC = 4;              // classes per warp pass of the logits
constexpr int KU = 5;              // float4 k-steps per lane in flight
constexpr int PULL_COLS = 8;       // pull output columns per chunk
constexpr int PULL_KS = NT / PULL_COLS;   // k-slices of a pull chunk
constexpr int VG = 8;              // pull rows per pass
constexpr int TC = 20;             // update tile: classes
constexpr int TJ = 32;             // update tile: feature columns (a lane each)
constexpr int EPT = (TC * TJ + NT - 1) / NT;   // update elements per thread
constexpr int SLOT_U = 5;          // slot loads per lane in flight (5*32>132)
static_assert(TR <= NWARPS, "one warp per logits row");
static_assert(QC * TR == 32, "the lane transpose-reduce takes 32 sums");
static_assert(TC % 4 == 0 && TJ == 32, "update tile");
static_assert(PULL_COLS % 4 == 0, "pull chunks stage float4s");
static_assert(NT % (VG * PULL_COLS) == 0 && (NT / (VG * PULL_COLS)) <= 32,
              "pull outputs split over neighbouring lanes");

// partial sums: phase A's (written in epoch e's phase A), then two sets
// of the anchor sums (epoch e's set is e % 2); quantity q of block b at
// slots[q * P + b], so a warp reads one quantity of 32 blocks in one go
enum { Q_LSUP = 0, Q_LMEM, Q_HIT1, Q_HIT5, Q_PULLV, NQ_A };
enum { A_BASE = 0, A_BIAS, A_NOV, A_SEM, NQ_ANCHOR };
constexpr int NQ = NQ_A + 2 * NQ_ANCHOR;
constexpr int NQ_EPOCH = NQ_A + NQ_ANCHOR;      // read per epoch
static_assert(NQ_EPOCH <= 2 * NWARPS, "two quantities per warp at most");

// flags (host side: ops/finetune.py::_F_*)
constexpr int F_MEMORY = 1;
constexpr int F_REGBASE = 2;
constexpr int F_REGNOVEL = 4;
constexpr int F_PULL_SUB = 8;
constexpr int F_PULL_SEM = 16;
constexpr int F_STABLE = 32;
constexpr int F_ADAM = 64;

// scalars layout (host side: ops/finetune.py::SCALARS)
enum {
  S_LR = 0, S_WD, S_MOMENTUM, S_LMBD_BASE, S_LMBD_NOVEL, S_GAMMA, S_EPS,
  S_TARGET, S_MIN_EPOCHS, S_MAX_EPOCHS, S_STABLE_TARGET, S_B1, S_B2,
  S_EPS_ADAM, S_PREV_LOSS0, S_STABLE0, S_ACC1_0, S_ACC5_0
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of one block, in floats (ops/finetune.py::k1_smem_bytes):
// the phase-A region (a logits tile's F rows + logits, or a pull chunk's
// M columns + current rows + k-slice partials), then the phase-B region
// (the update tile's F columns, then dlog's columns, which the per-warp
// partial sums of G overwrite).
__host__ __device__ constexpr int smem_a_floats(int d, int ldl) {
  return imax(TR * (d + ldl), (PULL_COLS + VG) * d + PULL_KS * VG * PULL_COLS);
}
__host__ __device__ constexpr int smem_bytes(int d, int ldl, int rows) {
  return 4 * (smem_a_floats(d, ldl) + rows * TJ
              + imax(rows * TC, NWARPS * TC * TJ));
}

struct Args {
  const float* f_sup; const int* y_sup; const float* f_mem; const int* y_mem;
  const float* w_in; const float* mom_in; const float* nu_in;
  const float* w0; const float* reserved; const float* pull_op;
  const float* pull_tgt; const float* scalars;
  float* w; float* mom; float* nu; float* stats; float* trace;
  float* dlog; float* pullv; float* slots; unsigned* bar;
  unsigned long long* prof;
  int c_pad, d, n_sup, mem_count, n_active, n_reserved, orig_base, n_ways,
      bias_col, flags, trace_rows, blocks, ldl, row_tiles, pull_chunks,
      class_tiles, col_tiles;
};

// loop state: every block holds the same copy (thread 0 writes it, the
// block reads it after a barrier)
struct State {
  float loss, prev_loss, stable, epoch, acc1, acc5, p1, p2;
  float inv_base, inv_novel;
  float tot[NQ_EPOCH];
  int stop;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block sums of N values per thread, each in a fixed order (warp
// butterfly, then the warps in ascending order), written to
// out[q * stride] for q < N.
template <int N>
__device__ __forceinline__ void block_sums_to(const float (&v)[N], float* red,
                                              float* out, int stride) {
  static_assert(N <= NQ_A, "red holds NQ_A sums per warp");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float s = warp_sum(v[q]);
    if (lane == 0) red[q * NWARPS + warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < NWARPS; ++w8) s += red[threadIdx.x * NWARPS + w8];
    out[threadIdx.x * stride] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;       // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Grid barrier over ``nblocks`` resident blocks.  ``target`` is thread 0's
// count of arrivals to wait for; it grows by nblocks per barrier, so the
// counter never needs resetting within a launch.  A wait of more than ~4 s
// (a block that never arrives) traps instead of holding the card.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target,
                                          unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += nblocks;
    __threadfence();                  // release this block's writes
    atomicAdd(bar, 1u);
    unsigned seen, spins = 0;
    unsigned long long t0 = 0;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(bar) : "memory");
      if (seen >= target) break;
      if ((++spins & 4095u) == 0) {
        const unsigned long long t = global_ns();
        if (t0 == 0) t0 = t;
        else if (t - t0 > 4000000000ull) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One step of the transpose-reduce of 32 sums over the 32 lanes: a lane
// keeps the half of its 2*O values that its bit O selects and adds the
// partner lane's copy of that half.  After the steps 16, 8, 4, 2, 1,
// v[0] of lane l is the sum over all lanes of value l.
template <int O>
__device__ __forceinline__ void transpose_step(float* v, int lane) {
  const bool hi = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = hi ? v[i] : v[i + O];
    const float keep = hi ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// Per-block phase clocks (thread 0's, only with a profile buffer): lap(i)
// adds the nanoseconds since the previous lap to slot i, after the whole
// block got there.  Slots (PROF_SLOTS per block): 0 phase A after the
// product, 1 barrier 1, 2 phase B after the update, 3 barrier 2, 4 phase
// A's product (a logits tile's F*W^T, a pull chunk's staging and cur*M),
// 5 phase B's slot reduction and loss, 6 phase B's G = dlog^T F with its
// staging, 7 phase B's update epilogue and anchor sums.
constexpr int PROF_SLOTS = 8;
struct Clock {
  bool on;
  unsigned long long last, acc[PROF_SLOTS];
  __device__ void lap(int i) {
    if (on) {
      __syncthreads();
      if (threadIdx.x == 0) {
        const unsigned long long t = global_ns();
        acc[i] += t - last;
        last = t;
      }
    }
  }
};

struct Ctx {
  const Args& a;
  int D, D4, rows, cur_lo, nov_lo, nov_hi, bc;
  bool memory_on, regbase, regnovel, pull_sub, pull_sem;
  __device__ const float* feat_row(int r) const {
    return r < a.n_sup ? a.f_sup + (size_t)r * D
                       : a.f_mem + (size_t)(r - a.n_sup) * D;
  }
};

// ---------------------------------------------------------------------------
// phase A items
// ---------------------------------------------------------------------------
// Logits of rows [r0, r0+TR) x the active classes, then the row softmax:
// dlog rows written to global, per-warp loss and hit sums accumulated in
// lane 0's registers.  ``stage``: copy the F rows into shared memory
// (else they are there from an earlier epoch).
__device__ __forceinline__ void logits_tile(const Ctx& x, Clock& clk, int r0,
                                            float* sm, bool stage,
                                            float inv_nsup,
                                            float inv_cnt, float& lsup,
                                            float& lmem, float& h1,
                                            float& h5) {
  const Args& a = x.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = x.D, D4 = x.D4, ldl = a.ldl, n_active = a.n_active;
  const int nr = min(TR, x.rows - r0);
  float* Fs = sm;                         // [TR][D]
  float* Ls = sm + TR * D;                // [TR][ldl]
  if (stage) {
    for (int e = tid; e < TR * D4; e += NT) {
      const int r = e / D4, k4 = e - r * D4;
      const bool ok = r < nr;
      cp_async16(Fs + r * D + 4 * k4,
                 ok ? x.feat_row(r0 + r) + 4 * k4 : a.f_sup, ok);
    }
    cp_async_wait_all();
  }
  __syncthreads();

  const float4* W4 = reinterpret_cast<const float4*>(a.w);
  const float4* F4 = reinterpret_cast<const float4*>(Fs);
  for (int c0 = warp * QC; c0 < n_active; c0 += NWARPS * QC) {
    float acc[QC][TR];
#pragma unroll
    for (int q = 0; q < QC; ++q)
#pragma unroll
      for (int r = 0; r < TR; ++r) acc[q][r] = 0.f;
    for (int kb = lane; kb < D4; kb += 32 * KU) {
      float4 wv[KU][QC];
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int q = 0; q < QC; ++q) {
          const int k4 = kb + 32 * u, c = c0 + q;
          wv[u][q] = (k4 < D4 && c < n_active)
                         ? __ldcg(W4 + (size_t)c * D4 + k4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        const int k4 = kb + 32 * u;
        if (k4 < D4) {
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float4 f = F4[r * D4 + k4];
#pragma unroll
            for (int q = 0; q < QC; ++q)
              acc[q][r] = dot4(wv[u][q], f, acc[q][r]);
          }
        }
      }
    }
    // transpose-reduce: lane l ends with sum index l = q*TR + r
    float v[32];
#pragma unroll
    for (int q = 0; q < QC; ++q)
#pragma unroll
      for (int r = 0; r < TR; ++r) v[q * TR + r] = acc[q][r];
    transpose_step<16>(v, lane);
    transpose_step<8>(v, lane);
    transpose_step<4>(v, lane);
    transpose_step<2>(v, lane);
    transpose_step<1>(v, lane);
    const int q = lane / TR, r = lane % TR;
    if (c0 + q < n_active) Ls[r * ldl + c0 + q] = v[0];
  }
  __syncthreads();
  clk.lap(4);

  // softmax CE of row r0 + warp: dlog = scale * (p - onehot), zero for the
  // inactive classes up to the stride
  if (warp < nr) {
    const int gr = r0 + warp;
    const float* row = Ls + warp * ldl;
    const bool sup = gr < a.n_sup;
    const int yr = sup ? a.y_sup[gr] : a.y_mem[gr - a.n_sup];
    const float scale = sup ? inv_nsup : inv_cnt;
    float m = -INFINITY;
    for (int c = lane; c < n_active; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float sum = 0.f;
    for (int c = lane; c < n_active; c += 32) sum += expf(row[c] - m);
    sum = warp_sum(sum);
    const float ly = row[yr];
    if (sup) {
      float beats = 0.f;
      for (int c = lane; c < n_active; c += 32) {
        const float v = row[c];
        beats += (v > ly || (v == ly && c < yr)) ? 1.f : 0.f;
      }
      beats = warp_sum(beats);
      if (lane == 0) {
        h1 += beats < 1.f ? 1.f : 0.f;
        h5 += beats < 5.f ? 1.f : 0.f;
      }
    }
    if (lane == 0) {
      if (sup) lsup += m + logf(sum) - ly;
      else lmem += m + logf(sum) - ly;
    }
    const float inv = 1.f / sum;
    float* out = a.dlog + (size_t)gr * ldl;
    for (int c = lane; c < ldl; c += 32) {
      float g = 0.f;
      if (c < n_active) {
        const float p = expf(row[c] - m) * inv;
        g = (p - (c == yr ? 1.f : 0.f)) * scale;
      }
      out[c] = g;
    }
  }
  __syncthreads();
}

// Subspace pull columns [j0, j0+PULL_COLS): V[:, cols] = cur * M[:, cols]
// over the n_ways current rows; V to pullv, its sum of squares into ``sq``.
// The bias row of M is staged as zeros: the pull never touches the bias.
// ``stage``: copy M's columns into shared memory (else they are there).
__device__ __forceinline__ void pull_chunk(const Ctx& x, Clock& clk, int j0,
                                           float* sm, bool stage, float& sq) {
  const Args& a = x.a;
  const int tid = threadIdx.x, D = x.D, D4 = x.D4;
  float* Ms = sm;                          // [D][PULL_COLS]
  float* cur = Ms + D * PULL_COLS;         // [VG][D]
  float* pr = cur + VG * D;                // [PULL_KS][VG][PULL_COLS]
  constexpr int Q4 = PULL_COLS / 4;
  if (stage) {
    for (int e = tid; e < D * Q4; e += NT) {
      const int k = e / Q4, q = e - k * Q4;
      const bool ok = j0 + 4 * q < D && k != x.bc;
      cp_async16(Ms + k * PULL_COLS + 4 * q,
                 ok ? a.pull_op + (size_t)k * D + j0 + 4 * q : a.pull_op, ok);
    }
  }
  const int jj = tid % PULL_COLS, ks = tid / PULL_COLS;
  for (int i0 = 0; i0 < a.n_ways; i0 += VG) {
    const int ni = min(VG, a.n_ways - i0);
    for (int e = tid; e < VG * D4; e += NT) {
      const int i = e / D4, k4 = e - i * D4;
      const bool ok = i < ni;
      cp_async16(cur + i * D + 4 * k4,
                 ok ? a.w + (size_t)(x.cur_lo + i0 + i) * D + 4 * k4 : a.w,
                 ok);
    }
    cp_async_wait_all();
    __syncthreads();
    float acc[VG];
#pragma unroll
    for (int i = 0; i < VG; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int k = ks; k < D; k += PULL_KS) {
      const float mv = Ms[k * PULL_COLS + jj];
#pragma unroll
      for (int i = 0; i < VG; ++i) acc[i] = fmaf(cur[i * D + k], mv, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < VG; ++i) pr[(ks * VG + i) * PULL_COLS + jj] = acc[i];
    __syncthreads();
    clk.lap(4);
    {
      // output (i, j) summed by 4 neighbouring lanes, a quarter of the
      // k-slices each, then across the 4 in a fixed order
      constexpr int SPLIT = NT / (VG * PULL_COLS), PER = PULL_KS / SPLIT;
      const int o = tid / SPLIT, part = tid % SPLIT;
      const int i = o / PULL_COLS, j = o % PULL_COLS;
      float v = 0.f;
#pragma unroll
      for (int s = part * PER; s < (part + 1) * PER; ++s)
        v += pr[(s * VG + i) * PULL_COLS + j];
#pragma unroll
      for (int m = 1; m < SPLIT; m <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, m);
      if (part == 0 && i < ni && j0 + j < D) {
        a.pullv[(size_t)(i0 + i) * D + j0 + j] = v;
        sq += v * v;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// phase B
// ---------------------------------------------------------------------------
// G = dlog^T F for the update tile at (c0, j0) over all rows: dlog's TC
// columns (and, with ``stage_f``, F's TJ columns) staged in shared memory;
// warp w sums rows w, w + NWARPS, ...; the per-warp partials [warp][class]
// [column] are left at ``dl``.
__device__ __forceinline__ void grad_tile(const Ctx& x, int c0, int j0,
                                          float* fb, float* dl,
                                          bool stage_f) {
  const Args& a = x.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = x.D, rows = x.rows;
  for (int e = tid; e < rows * (TC / 4); e += NT) {
    const int r = e / (TC / 4), q = e - r * (TC / 4);
    cp_async16(dl + r * TC + 4 * q, a.dlog + (size_t)r * a.ldl + c0 + 4 * q,
               true);
  }
  if (stage_f) {
    for (int e = tid; e < rows * (TJ / 4); e += NT) {
      const int r = e / (TJ / 4), q = e - r * (TJ / 4);
      const bool ok = j0 + 4 * q < D;
      cp_async16(fb + r * TJ + 4 * q,
                 ok ? x.feat_row(r) + j0 + 4 * q : a.f_sup, ok);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  float acc[TC];
#pragma unroll
  for (int c = 0; c < TC; ++c) acc[c] = 0.f;
#pragma unroll 4
  for (int r = warp; r < rows; r += NWARPS) {
    const float f = fb[r * TJ + lane];
    const float4* d4 = reinterpret_cast<const float4*>(dl + r * TC);
#pragma unroll
    for (int q = 0; q < TC / 4; ++q) {
      const float4 g = d4[q];
      acc[4 * q + 0] = fmaf(g.x, f, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(g.y, f, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(g.z, f, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(g.w, f, acc[4 * q + 3]);
    }
  }
  __syncthreads();          // every warp is done reading dl
#pragma unroll
  for (int c = 0; c < TC; ++c) dl[(warp * TC + c) * TJ + lane] = acc[c];
  __syncthreads();
}

// The anchor terms of one head element whose weight is ``wv``, added to
// the block's next-epoch sums an[A_*].
__device__ __forceinline__ void anchor_terms(const Ctx& x, int r, int col,
                                             float wv, float w0v, float rv,
                                             float tv, float (&an)[NQ_ANCHOR]) {
  if (x.regbase && r < x.a.orig_base) {
    const float df = wv - w0v;
    if (col == x.bc) an[A_BIAS] += df * df; else an[A_BASE] += df * df;
  }
  if (x.regnovel && r >= x.nov_lo && r < x.nov_hi) {
    const float df = wv - rv;
    an[A_NOV] += df * df;
  }
  if (x.pull_sem && r >= x.cur_lo && r < x.a.n_active && col != x.bc) {
    const float df = wv - tv;
    an[A_SEM] += df * df;
  }
}

__global__ void __launch_bounds__(NT, 1) finetune_loop_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ State st;
  __shared__ float red[NQ_A * NWARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, P = a.blocks;
  const int D = a.d, CP = a.c_pad;
  const float* sc = a.scalars;
  const bool memory_on = a.flags & F_MEMORY;
  const bool stable_mode = a.flags & F_STABLE;
  const bool adam = a.flags & F_ADAM;
  const Ctx x{a, D, D / 4, a.n_sup + (memory_on ? a.mem_count : 0),
              a.n_active - a.n_ways, a.orig_base,
              a.orig_base + a.n_reserved, a.bias_col, memory_on,
              (a.flags & F_REGBASE) != 0, (a.flags & F_REGNOVEL) != 0,
              (a.flags & F_PULL_SUB) != 0, (a.flags & F_PULL_SEM) != 0};
  float* sm_a = sm;
  float* fb = sm + smem_a_floats(D, a.ldl);      // [rows][TJ]
  float* dl = fb + x.rows * TJ;                  // [rows][TC], partials

  const float lr = sc[S_LR], wd = sc[S_WD], momentum = sc[S_MOMENTUM];
  const float lmbd_base = sc[S_LMBD_BASE], lmbd_novel = sc[S_LMBD_NOVEL];
  const float gamma = sc[S_GAMMA], eps = sc[S_EPS], target = sc[S_TARGET];
  const float min_epochs = sc[S_MIN_EPOCHS], max_epochs = sc[S_MAX_EPOCHS];
  const float stable_target = sc[S_STABLE_TARGET];
  const float b1 = sc[S_B1], b2 = sc[S_B2], eps_a = sc[S_EPS_ADAM];
  // scale constants rounded from double, as the reference's Python floats
  const float inv_nsup = (float)(1.0 / (double)a.n_sup);
  const float acc_scale = (float)(100.0 / (double)a.n_sup);
  const float inv_cnt = 1.f / fmaxf((float)a.mem_count, 1.f);
  const int n_items = a.row_tiles + a.pull_chunks;
  const int n_tiles = a.class_tiles * a.col_tiles;
  // a block with a single item (tile) keeps its constant operand resident
  const bool keep_a = blk < n_items && blk + P >= n_items;
  const bool keep_b = blk < n_tiles && blk + P >= n_tiles;
  float* my_slots = a.slots + blk;            // quantity q at q * P

  unsigned bar_target = 0;
  Clock clk{a.prof != nullptr, 0, {}};

  // ---- prologue: per update tile, private copies of the optimizer state
  // and epoch 2's anchor sums; the trace zeroed ----
  {
    float an[NQ_ANCHOR] = {0.f, 0.f, 0.f, 0.f};
    for (int u = blk; u < n_tiles; u += P) {
      const int c0 = (u / a.col_tiles) * TC, j0 = (u % a.col_tiles) * TJ;
      for (int e = tid; e < TC * TJ; e += NT) {
        const int r = c0 + e / TJ, col = j0 + e % TJ;
        if (r >= CP || col >= D) continue;
        const size_t ge = (size_t)r * D + col;
        const float wv = a.w_in[ge];
        a.w[ge] = wv;
        a.mom[ge] = a.mom_in[ge];
        if (adam) a.nu[ge] = a.nu_in[ge];
        anchor_terms(x, r, col, wv, x.regbase ? a.w0[ge] : 0.f,
                     x.regnovel ? a.reserved[ge] : 0.f,
                     x.pull_sem ? a.pull_tgt[ge] : 0.f, an);
      }
    }
    block_sums_to(an, red, my_slots + NQ_A * P, P);
    if (blk == 0)
      for (int e = tid; e < a.trace_rows * 3; e += NT) a.trace[e] = 0.f;
  }
  if (tid == 0) {
    // epoch 1 ran outside (train-mode features, one step): replay its stop
    const float prev0 = sc[S_PREV_LOSS0], stable0 = sc[S_STABLE0];
    bool stop = (1.f >= max_epochs) || (prev0 <= target && 1.f >= min_epochs + 1.f);
    if (stable_mode) stop = stop || (stable0 == stable_target);
    st.stop = stop;
    st.loss = prev0; st.prev_loss = prev0; st.stable = stable0; st.epoch = 1.f;
    st.acc1 = sc[S_ACC1_0]; st.acc5 = sc[S_ACC5_0]; st.p1 = b1; st.p2 = b2;
  }
  grid_sync(a.bar, bar_target, P);
  if (clk.on && tid == 0) clk.last = global_ns();

  int parity = 0;           // this epoch's anchor set (epoch 2: set 0)
  bool first = true;
  while (!st.stop) {
    // ---- phase A: logits + softmax, pull ----
    {
      float part[NQ_A] = {0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = blk; i < n_items; i += P) {
        if (i < a.row_tiles) {
          logits_tile(x, clk, i * TR, sm_a, first || !keep_a, inv_nsup,
                      inv_cnt,
                      part[Q_LSUP], part[Q_LMEM], part[Q_HIT1],
                      part[Q_HIT5]);
        } else {
          pull_chunk(x, clk, (i - a.row_tiles) * PULL_COLS, sm_a,
                     first || !keep_a, part[Q_PULLV]);
        }
      }
      block_sums_to(part, red, my_slots, P);
    }
    clk.lap(0);
    grid_sync(a.bar, bar_target, P);
    clk.lap(1);

    // ---- phase B: every block reduces every slot in the same order ----
    for (int k = warp; k < NQ_EPOCH; k += NWARPS) {
      const int q = k < NQ_A ? k : NQ_A + parity * NQ_ANCHOR + (k - NQ_A);
      float v = 0.f;
      for (int b0 = lane; b0 < P; b0 += 32 * SLOT_U) {
        float part[SLOT_U];       // the loads in flight together
#pragma unroll
        for (int i = 0; i < SLOT_U; ++i) {
          const int b = b0 + 32 * i;
          part[i] = b < P ? __ldcg(a.slots + q * P + b) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < SLOT_U; ++i) v += part[i];
      }
      v = warp_sum(v);
      if (lane == 0) st.tot[k] = v;
    }
    __syncthreads();
    if (tid == 0) {
      const float* an = st.tot + NQ_A;
      float loss = st.tot[Q_LSUP] * inv_nsup;
      if (memory_on) loss += st.tot[Q_LMEM] * inv_cnt;
      float inv_b = 0.f, inv_n = 0.f;
      if (x.regbase) {
        const float sb = an[A_BASE];
        const float nb = sb == 0.f ? 0.f : sqrtf(sb);
        loss += lmbd_base * nb;
        inv_b = nb == 0.f ? 0.f : 1.f / fmaxf(nb, 1e-30f);
        if (x.bc >= 0) loss += lmbd_base * an[A_BIAS];
      }
      if (x.regnovel) {
        const float sn = an[A_NOV];
        const float nn = sn == 0.f ? 0.f : sqrtf(sn);
        loss += lmbd_novel * nn;
        inv_n = nn == 0.f ? 0.f : 1.f / fmaxf(nn, 1e-30f);
      }
      if (x.pull_sub) loss += gamma * st.tot[Q_PULLV];
      else if (x.pull_sem) loss += gamma * an[A_SEM];
      st.loss = loss;
      st.inv_base = inv_b;
      st.inv_novel = inv_n;
      st.acc1 = st.tot[Q_HIT1] * acc_scale;
      st.acc5 = st.tot[Q_HIT5] * acc_scale;
      if (adam) { st.p1 *= b1; st.p2 *= b2; }
    }
    __syncthreads();
    clk.lap(5);

    // ---- phase B: G tiles, gradient assembly, coupled wd, update, and
    // the next epoch's anchor sums on the updated W ----
    {
      const float inv_b = st.inv_base, inv_n = st.inv_novel;
      const float bc1 = 1.f - st.p1, bc2 = 1.f - st.p2;
      float an[NQ_ANCHOR] = {0.f, 0.f, 0.f, 0.f};
      for (int u = blk; u < n_tiles; u += P) {
        const int c0 = (u / a.col_tiles) * TC, j0 = (u % a.col_tiles) * TJ;
        const bool gemm = c0 < a.n_active;
        if (gemm) grad_tile(x, c0, j0, fb, dl, first || !keep_b);
        clk.lap(6);
        // every load of the thread's elements first, then the arithmetic
        bool ok[EPT];
        int rr[EPT], cc[EPT];
        size_t ge[EPT];
        float wv[EPT], mv[EPT], nv[EPT], w0v[EPT], rv[EPT], tv[EPT];
#pragma unroll
        for (int t = 0; t < EPT; ++t) {
          const int e = tid + t * NT;
          const int r = c0 + e / TJ, col = j0 + e % TJ;
          ok[t] = e < TC * TJ && r < CP && col < D;
          rr[t] = r;
          cc[t] = col;
          ge[t] = ok[t] ? (size_t)r * D + col : 0;
          const bool cur = r >= x.cur_lo && r < a.n_active && col != x.bc;
          wv[t] = ok[t] ? __ldcg(a.w + ge[t]) : 0.f;
          mv[t] = ok[t] ? __ldcg(a.mom + ge[t]) : 0.f;
          nv[t] = ok[t] && adam ? __ldcg(a.nu + ge[t]) : 0.f;
          w0v[t] = ok[t] && x.regbase && r < a.orig_base ? a.w0[ge[t]] : 0.f;
          rv[t] = ok[t] && x.regnovel && r >= x.nov_lo && r < x.nov_hi
                      ? a.reserved[ge[t]] : 0.f;
          tv[t] = 0.f;
          if (ok[t] && cur && x.pull_sub)
            tv[t] = __ldcg(a.pullv + (size_t)(r - x.cur_lo) * D + col);
          else if (ok[t] && x.pull_sem)
            tv[t] = a.pull_tgt[ge[t]];
        }
#pragma unroll
        for (int t = 0; t < EPT; ++t) {
          if (!ok[t]) continue;
          const int r = rr[t], col = cc[t], c = r - c0, jj = col - j0;
          float g = 0.f;
          if (gemm && r < a.n_active) {
#pragma unroll
            for (int w8 = 0; w8 < NWARPS; ++w8) g += dl[(w8 * TC + c) * TJ + jj];
          }
          if (x.regbase && r < a.orig_base) {
            const float df = wv[t] - w0v[t];
            if (col == x.bc) g += 2.f * lmbd_base * df;
            else g += lmbd_base * df * inv_b;
          }
          if (x.regnovel && r >= x.nov_lo && r < x.nov_hi)
            g += lmbd_novel * (wv[t] - rv[t]) * inv_n;
          if (r >= x.cur_lo && r < a.n_active && col != x.bc) {
            if (x.pull_sub) g += 2.f * gamma * tv[t];
            else if (x.pull_sem) g += 2.f * gamma * (wv[t] - tv[t]);
          }
          g += wd * wv[t];
          float wn;
          if (adam) {
            const float m = b1 * mv[t] + (1.f - b1) * g;
            const float v = b2 * nv[t] + (1.f - b2) * g * g;
            a.mom[ge[t]] = m;
            a.nu[ge[t]] = v;
            wn = wv[t] - lr * (m / bc1) / (sqrtf(v / bc2) + eps_a);
          } else {
            const float m = momentum * mv[t] + g;
            a.mom[ge[t]] = m;
            wn = wv[t] - lr * m;
          }
          a.w[ge[t]] = wn;
          anchor_terms(x, r, col, wn, w0v[t], rv[t], tv[t], an);
        }
        __syncthreads();    // the next tile restages shared memory
      }
      block_sums_to(an, red, my_slots + (NQ_A + (parity ^ 1) * NQ_ANCHOR) * P,
                    P);
      clk.lap(7);
    }

    // ---- stop rule (every block alike) + trace row (block 0) ----
    if (tid == 0) {
      const float epoch = st.epoch + 1.f, loss = st.loss;
      bool stop = false;
      if (stable_mode) {
        st.stable = fabsf(loss - st.prev_loss) < eps ? st.stable + 1.f : 0.f;
        stop = st.stable == stable_target;
      }
      stop = stop || epoch >= max_epochs;
      stop = stop || (loss <= target && epoch >= min_epochs + 1.f);
      const int row = (int)epoch;
      if (blk == 0 && row < a.trace_rows) {
        a.trace[row * 3 + 0] = loss;
        a.trace[row * 3 + 1] = st.acc1;
        a.trace[row * 3 + 2] = st.acc5;
      }
      st.epoch = epoch;
      st.prev_loss = loss;
      st.stop = stop;
    }
    __syncthreads();
    clk.lap(2);
    if (!st.stop) {
      grid_sync(a.bar, bar_target, P);
      clk.lap(3);
    }
    parity ^= 1;
    first = false;
  }

  if (tid == 0) {
    if (blk == 0) {
      a.stats[0] = st.prev_loss;
      a.stats[1] = st.epoch;
      a.stats[2] = st.stable;
      a.stats[3] = st.acc1;
      a.stats[4] = st.acc5;
      a.stats[5] = a.stats[6] = a.stats[7] = 0.f;
    }
    if (clk.on)
      for (int i = 0; i < PROF_SLOTS; ++i)
        a.prof[blk * PROF_SLOTS + i] = clk.acc[i];
  }
}

// ``iters`` grid barriers and nothing else: the barrier's own cost.
__global__ void __launch_bounds__(NT, 1) barrier_probe_kernel(unsigned* bar,
                                                               int iters) {
  unsigned target = 0;
  for (int i = 0; i < iters; ++i) grid_sync(bar, target, gridDim.x);
}

// The card's ceiling on co-resident blocks of ``kernel``: one per SM at
// most (the design's assumption), none if a block does not fit an SM.
cudaError_t max_blocks(const void* kernel, int smem, int* out) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  *out = per_sm >= 1 ? sms : 0;
  return err;
}

}  // namespace

extern "C" cudaError_t k1_finetune_loop(
    const float* f_sup, const int* y_sup, const float* f_mem, const int* y_mem,
    const float* w_in, const float* mom_in, const float* nu_in,
    const float* w0, const float* reserved, const float* pull_op,
    const float* pull_tgt, const float* scalars,
    float* w, float* mom, float* nu, float* stats, float* trace,
    float* dlog, float* pullv, float* slots, unsigned* bar,
    unsigned long long* prof,
    int c_pad, int d, int n_sup, int mem_count, int n_active,
    int n_reserved, int orig_base, int n_ways, int bias_col, int flags,
    int trace_rows, int blocks, int ldl, int row_tiles, int pull_chunks,
    int class_tiles, int col_tiles, int smem, void* stream) {
  // the plan must be the one this file's tiling gives (ops/finetune.py::
  // k1_plan makes it from the same integers)
  const int rows = n_sup + ((flags & F_MEMORY) ? mem_count : 0);
  const bool pull = (flags & F_PULL_SUB) && n_ways > 0;
  if (d % 4 || rows < 1 || c_pad < 1 || ldl < c_pad || ldl % TC
      || row_tiles != cdiv(rows, TR)
      || pull_chunks != (pull ? cdiv(d, PULL_COLS) : 0)
      || class_tiles != cdiv(c_pad, TC) || col_tiles != cdiv(d, TJ)
      || smem != smem_bytes(d, ldl, rows) || blocks < 1)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = max_blocks((const void*)finetune_loop_kernel, smem,
                               &limit);
  if (err != cudaSuccess) return err;
  if (blocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  Args a{f_sup, y_sup, f_mem, y_mem, w_in, mom_in, nu_in, w0, reserved,
         pull_op, pull_tgt, scalars, w, mom, nu, stats, trace, dlog, pullv,
         slots, bar, prof, c_pad, d, n_sup, mem_count, n_active, n_reserved,
         orig_base, n_ways, bias_col, flags, trace_rows, blocks, ldl,
         row_tiles, pull_chunks, class_tiles, col_tiles};
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)finetune_loop_kernel,
                                    dim3(blocks), dim3(NT), params,
                                    (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

extern "C" cudaError_t k1_barrier_probe(unsigned* bar, int blocks, int iters,
                                        void* stream) {
  int limit = 0;
  cudaError_t err = max_blocks((const void*)barrier_probe_kernel, 0, &limit);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > limit) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {&bar, &iters};
  err = cudaLaunchCooperativeKernel((const void*)barrier_probe_kernel,
                                    dim3(blocks), dim3(NT), params, 0,
                                    static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}
