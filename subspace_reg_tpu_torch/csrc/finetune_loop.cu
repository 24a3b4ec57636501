// K1 on Hopper: the whole FSCIL head fine-tune loop (epochs 2..N) in one
// launch.
//
// Replaces the TPU kernel subspace_reg_tpu/ops/pallas/finetune.py::
// finetune_loop_pallas (body _make_kernel).  The plain PyTorch twin with the
// same operands and outputs is subspace_reg_tpu_torch/ops/finetune.py::
// finetune_loop_plain; the wrapper there validates operands and counts
// launches.
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
// support rows, up to 200 replay rows, 100 classes, D=640) the work is
// ~2*2*(185+200)*100*640 + 2*5*640*640 ~ 103 MFLOP of FP32 that depends on
// the previous epoch's weights, so epochs are strictly serial; the operands
// (~3.6 MB) fit in L2.  The card-wide FP32 bound is ~1.5 us/epoch, but this
// design runs the loop in ONE persistent thread block, i.e. on one SM, which
// reaches only ~1/132 of the card's FP32 peak (~200 us/epoch at best).  The
// block stays resident for the whole loop: no host round trip and no
// relaunch per epoch; W/momentum/nu live in global buffers that stay
// L2-resident.  The two products per epoch (logits = F W^T and the CE
// gradient dlog^T F) each run as ONE GEMM over the support and replay rows
// together, in 128x128x32 shared-memory tiles whose next slice is prefetched
// into registers while the current one is multiplied (4x8 outputs per
// thread); the subspace pull stages the n_ways current rows in shared
// memory and streams M once.  Every reduction runs in a fixed order (no
// atomics), so a run is deterministic.  Spreading the epoch's products over
// many SMs is later work.
//
// All math is FP32 on the CUDA cores (no tensor cores, no TF32).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;           // threads per block
constexpr int TM = 128;           // GEMM tile rows
constexpr int TN = 128;           // GEMM tile cols
constexpr int TK = 32;            // GEMM k-slice
constexpr int LDT = TM + 4;       // smem row stride (bank spread, float4-aligned)
constexpr int NWARPS = NT / 32;
constexpr int A_PER_T = TM * TK / NT;   // tile elements each thread stages
constexpr int B_PER_T = TN * TK / NT;
constexpr int VGROUP = 8;         // pull rows per pass
constexpr int MAX_PULL_D = 2 * NT;  // pull: two output columns per thread

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

struct Args {
  const float* f_sup; const int* y_sup; const float* f_mem; const int* y_mem;
  const float* w_in; const float* mom_in; const float* nu_in;
  const float* w0; const float* reserved; const float* pull_op;
  const float* pull_tgt; const float* scalars;
  float* w; float* mom; float* nu; float* stats; float* trace;
  float* logits; float* grad; float* pullv;
  int c_pad, d, n_sup, mem_count, n_active, n_reserved, orig_base, n_ways,
      bias_col, flags, trace_rows;
};

// 16-byte aligned: the GEMM inner loop reads the tiles as float4.  The pull
// reuses the tiles' storage for its staged rows.
struct __align__(16) Smem {
  union {
    struct {
      float As[TK][LDT];
      float Bs[TK][LDT];
    } g;
    float cur[VGROUP * MAX_PULL_D];
  } u;
  float red[NWARPS + 1];
  // loop state, written by thread 0 and read by all after a barrier
  float loss, prev_loss, stable, epoch, acc1, acc5, p1, p2;
  float inv_base, inv_novel;
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

// Sum of one value per thread, in a fixed order (deterministic).
__device__ float block_sum(float v, Smem& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float r = lane < NWARPS ? s.red[lane] : 0.f;
    r = warp_sum(r);
    if (lane == 0) s.red[NWARPS] = r;
  }
  __syncthreads();
  const float out = s.red[NWARPS];
  __syncthreads();
  return out;
}

// Thread -> tile element mapping of the staging loads.  An operand
// contiguous in k is read by each warp as 4 rows x 8 consecutive k (four
// full 32-byte sectors) and lands in As[k][row] on 32 distinct banks; an
// operand contiguous along its rows is read as 32 consecutive rows of one k.
template <bool KCONTIG, int ROWS>
__device__ __forceinline__ void tile_coord(int e, int& row, int& k) {
  if (KCONTIG) {
    const int lane = e & 31, grp = e >> 5;
    row = (grp >> 2) * 4 + (lane & 3);
    k = (grp & 3) * 8 + (lane >> 2);
  } else {
    k = e / ROWS;
    row = e % ROWS;
  }
}

// C[i*ldc + j] = sum_k A(i,k) * B(j,k) for i < M, j < N over k < K, with
// A(i,k) = la(i,k) and B(j,k) = lb(j,k).  AK/BK say whether the loaders'
// contiguous axis is k.  Thread (ty, tx) of a 32x16 grid owns rows
// 4ty..4ty+3 and columns 4tx..4tx+3, 64+4tx..64+4tx+3 of each 128x128 tile.
// The k-slice after the current one is loaded into registers while the
// current one is multiplied.  Sums run in ascending k: deterministic.
template <bool AK, bool BK, class LA, class LB>
__device__ void block_gemm(int M, int N, int K, LA la, LB lb, float* C,
                           int ldc, Smem& s) {
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  for (int i0 = 0; i0 < M; i0 += TM) {
    for (int j0 = 0; j0 < N; j0 += TN) {
      float acc[4][8];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
      float ra[A_PER_T], rb[B_PER_T];
      auto fetch = [&](int k0) {
#pragma unroll
        for (int t = 0; t < A_PER_T; ++t) {
          int i, k;
          tile_coord<AK, TM>(tid + t * NT, i, k);
          const int gi = i0 + i, gk = k0 + k;
          ra[t] = (gi < M && gk < K) ? la(gi, gk) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < B_PER_T; ++t) {
          int j, k;
          tile_coord<BK, TN>(tid + t * NT, j, k);
          const int gj = j0 + j, gk = k0 + k;
          rb[t] = (gj < N && gk < K) ? lb(gj, gk) : 0.f;
        }
      };
      fetch(0);
      for (int k0 = 0; k0 < K; k0 += TK) {
        __syncthreads();          // every thread is done with the last slice
#pragma unroll
        for (int t = 0; t < A_PER_T; ++t) {
          int i, k;
          tile_coord<AK, TM>(tid + t * NT, i, k);
          s.u.g.As[k][i] = ra[t];
        }
#pragma unroll
        for (int t = 0; t < B_PER_T; ++t) {
          int j, k;
          tile_coord<BK, TN>(tid + t * NT, j, k);
          s.u.g.Bs[k][j] = rb[t];
        }
        __syncthreads();
        if (k0 + TK < K) fetch(k0 + TK);
#pragma unroll
        for (int k = 0; k < TK; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(&s.u.g.As[k][ty * 4]);
          const float4 b0 = *reinterpret_cast<const float4*>(&s.u.g.Bs[k][tx * 4]);
          const float4 b1 = *reinterpret_cast<const float4*>(&s.u.g.Bs[k][64 + tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
        }
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int gi = i0 + ty * 4 + p;
        if (gi >= M) continue;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int gj = j0 + (q < 4 ? tx * 4 + q : 64 + tx * 4 + q - 4);
          if (gj < N) C[(size_t)gi * ldc + gj] = acc[p][q];
        }
      }
    }
  }
  __syncthreads();
}

// Row softmax over the active classes of the support rows [0, n_sup) and
// the replay rows [n_sup, rows) of L (stride c_pad): turns each row into
// scale*(p - onehot) in place (scale 1/n_sup or 1/mem_count) and returns,
// per thread, the partial sums of the row losses (m + log s - l_y) and,
// for support rows, the top-1/top-5 hit counts with the lower-index-wins
// tie rule.
__device__ void softmax_rows(float* L, int rows, int c_pad, int n_active,
                             int n_sup, const int* y_sup, const int* y_mem,
                             float inv_nsup, float inv_cnt, float& loss_sup,
                             float& loss_mem, float& hit1, float& hit5) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += NWARPS) {
    float* row = L + (size_t)r * c_pad;
    const bool sup = r < n_sup;
    const int yr = sup ? y_sup[r] : y_mem[r - n_sup];
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
        hit1 += beats < 1.f ? 1.f : 0.f;
        hit5 += beats < 5.f ? 1.f : 0.f;
      }
    }
    if (lane == 0) {
      if (sup) loss_sup += m + logf(sum) - ly;
      else loss_mem += m + logf(sum) - ly;
    }
    __syncwarp();
    const float inv = 1.f / sum;
    for (int c = lane; c < n_active; c += 32) {
      const float p = expf(row[c] - m) * inv;
      row[c] = (p - (c == yr ? 1.f : 0.f)) * scale;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(NT, 1) finetune_loop_kernel(Args a) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int D = a.d, CP = a.c_pad;
  const float* sc = a.scalars;
  const bool memory_on = a.flags & F_MEMORY;
  const bool regbase = a.flags & F_REGBASE;
  const bool regnovel = a.flags & F_REGNOVEL;
  const bool pull_sub = a.flags & F_PULL_SUB;
  const bool pull_sem = a.flags & F_PULL_SEM;
  const bool stable_mode = a.flags & F_STABLE;
  const bool adam = a.flags & F_ADAM;
  const int bc = a.bias_col;                 // -1: no bias column
  const int cur_lo = a.n_active - a.n_ways;  // rows the pull acts on
  const int nov_lo = a.orig_base, nov_hi = a.orig_base + a.n_reserved;

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
  const int n_el = CP * D;

  // ---- prologue: private copies of the optimizer state, zeroed trace ----
  for (int e = tid; e < n_el; e += NT) {
    a.w[e] = a.w_in[e];
    a.mom[e] = a.mom_in[e];
    if (adam) a.nu[e] = a.nu_in[e];
  }
  for (int e = tid; e < a.trace_rows * 3; e += NT) a.trace[e] = 0.f;
  if (tid == 0) {
    // epoch 1 ran outside (train-mode features, one step): replay its stop
    const float prev0 = sc[S_PREV_LOSS0], stable0 = sc[S_STABLE0];
    bool stop = (1.f >= max_epochs) || (prev0 <= target && 1.f >= min_epochs + 1.f);
    if (stable_mode) stop = stop || (stable0 == stable_target);
    s.stop = stop;
    s.loss = prev0; s.prev_loss = prev0; s.stable = stable0; s.epoch = 1.f;
    s.acc1 = sc[S_ACC1_0]; s.acc5 = sc[S_ACC5_0]; s.p1 = b1; s.p2 = b2;
  }
  __syncthreads();

  // support rows then replay rows, one row space for both products
  const int n_sup = a.n_sup;
  const int rows = n_sup + (memory_on ? a.mem_count : 0);
  const float* f_sup = a.f_sup;
  const float* f_mem = a.f_mem;
  const float* w = a.w;
  float* L = a.logits;
  auto feat_row = [=](int r) {
    return r < n_sup ? f_sup + (size_t)r * D : f_mem + (size_t)(r - n_sup) * D;
  };

  while (!s.stop) {
    // ---- logits over valid rows x active classes ----
    block_gemm<true, true>(
        rows, a.n_active, D,
        [=](int r, int k) { return feat_row(r)[k]; },
        [=](int c, int k) { return w[(size_t)c * D + k]; },
        L, CP, s);

    // ---- softmax CE, support accuracy, dlog in place ----
    float lsup = 0.f, lmem = 0.f, h1 = 0.f, h5 = 0.f;
    softmax_rows(L, rows, CP, a.n_active, n_sup, a.y_sup, a.y_mem, inv_nsup,
                 inv_cnt, lsup, lmem, h1, h5);
    __syncthreads();
    const float loss_sup = block_sum(lsup, s);
    const float loss_mem = block_sum(lmem, s);
    const float hits1 = block_sum(h1, s);
    const float hits5 = block_sum(h5, s);

    // ---- CE gradient G = dlog^T F over the active rows ----
    block_gemm<false, false>(
        a.n_active, D, rows,
        [=](int c, int r) { return L[(size_t)r * CP + c]; },
        [=](int j, int r) { return feat_row(r)[j]; },
        a.grad, D, s);

    // ---- subspace pull: V = cur * M over the n_ways current rows ----
    if (pull_sub) {
      for (int i0 = 0; i0 < a.n_ways; i0 += VGROUP) {
        const int ni = min(VGROUP, a.n_ways - i0);
        // stage the rows, bias column zeroed: the pull never touches bias
        for (int e = tid; e < VGROUP * D; e += NT) {
          const int i = e / D, k = e % D;
          s.u.cur[e] = (i < ni && k != bc)
                           ? a.w[(size_t)(cur_lo + i0 + i) * D + k] : 0.f;
        }
        __syncthreads();
        const int j0 = tid, j1 = tid + NT;
        const bool h0 = j0 < D, hh1 = j1 < D;
        float acc0[VGROUP], acc1[VGROUP];
#pragma unroll
        for (int i = 0; i < VGROUP; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll 16
        for (int k = 0; k < D; ++k) {
          const float* mrow = a.pull_op + (size_t)k * D;
          const float m0 = h0 ? mrow[j0] : 0.f;
          const float m1 = hh1 ? mrow[j1] : 0.f;
#pragma unroll
          for (int i = 0; i < VGROUP; ++i) {
            const float c = s.u.cur[i * D + k];
            acc0[i] = fmaf(c, m0, acc0[i]);
            acc1[i] = fmaf(c, m1, acc1[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < VGROUP; ++i) {
          if (i >= ni) continue;
          if (h0) a.pullv[(size_t)(i0 + i) * D + j0] = acc0[i];
          if (hh1) a.pullv[(size_t)(i0 + i) * D + j1] = acc1[i];
        }
        __syncthreads();
      }
    }

    // ---- regularizer sums ----
    float sq_base = 0.f, sq_bias = 0.f, sq_nov = 0.f, sq_pull = 0.f;
    if (regbase) {
      for (int e = tid; e < a.orig_base * D; e += NT) {
        const float df = a.w[e] - a.w0[e];
        if ((e % D) == bc) sq_bias += df * df; else sq_base += df * df;
      }
    }
    if (regnovel) {
      for (int e = nov_lo * D + tid; e < nov_hi * D; e += NT) {
        const float df = a.w[e] - a.reserved[e];
        sq_nov += df * df;
      }
    }
    if (pull_sub) {
      for (int e = tid; e < a.n_ways * D; e += NT) {
        const float v = a.pullv[e];
        sq_pull += v * v;
      }
    } else if (pull_sem) {
      for (int e = cur_lo * D + tid; e < a.n_active * D; e += NT) {
        if ((e % D) == bc) continue;
        const float df = a.w[e] - a.pull_tgt[e];
        sq_pull += df * df;
      }
    }
    sq_base = block_sum(sq_base, s);
    sq_bias = block_sum(sq_bias, s);
    sq_nov = block_sum(sq_nov, s);
    sq_pull = block_sum(sq_pull, s);

    if (tid == 0) {
      float loss = loss_sup * inv_nsup;
      if (memory_on) loss += loss_mem * inv_cnt;
      float inv_b = 0.f, inv_n = 0.f;
      if (regbase) {
        const float nb = sq_base == 0.f ? 0.f : sqrtf(sq_base);
        loss += lmbd_base * nb;
        inv_b = nb == 0.f ? 0.f : 1.f / fmaxf(nb, 1e-30f);
        if (bc >= 0) loss += lmbd_base * sq_bias;
      }
      if (regnovel) {
        const float nn = sq_nov == 0.f ? 0.f : sqrtf(sq_nov);
        loss += lmbd_novel * nn;
        inv_n = nn == 0.f ? 0.f : 1.f / fmaxf(nn, 1e-30f);
      }
      if (pull_sub || pull_sem) loss += gamma * sq_pull;
      s.loss = loss;
      s.inv_base = inv_b;
      s.inv_novel = inv_n;
      s.acc1 = hits1 * acc_scale;
      s.acc5 = hits5 * acc_scale;
      if (adam) { s.p1 *= b1; s.p2 *= b2; }
    }
    __syncthreads();

    // ---- gradient assembly + coupled wd + optimizer update ----
    // (element-wise; restrict-qualified so the unrolled iterations' loads
    // are issued together instead of one L2 round trip at a time)
    const float inv_b = s.inv_base, inv_n = s.inv_novel;
    const float bc1 = 1.f - s.p1, bc2 = 1.f - s.p2;
    float* __restrict__ wr = a.w;
    float* __restrict__ mr = a.mom;
    float* __restrict__ nr = a.nu;
    const float* __restrict__ gr = a.grad;
    const float* __restrict__ w0r = a.w0;
    const float* __restrict__ resr = a.reserved;
    const float* __restrict__ pvr = a.pullv;
    const float* __restrict__ tgr = a.pull_tgt;
#pragma unroll 4
    for (int e = tid; e < n_el; e += NT) {
      const int r = e / D, col = e % D;
      const float wv = wr[e];
      float g = r < a.n_active ? gr[e] : 0.f;
      if (regbase && r < a.orig_base) {
        const float df = wv - w0r[e];
        if (col == bc) g += 2.f * lmbd_base * df;
        else g += lmbd_base * df * inv_b;
      }
      if (regnovel && r >= nov_lo && r < nov_hi)
        g += lmbd_novel * (wv - resr[e]) * inv_n;
      if (r >= cur_lo && r < a.n_active && col != bc) {
        if (pull_sub) g += 2.f * gamma * pvr[(size_t)(r - cur_lo) * D + col];
        else if (pull_sem) g += 2.f * gamma * (wv - tgr[e]);
      }
      g += wd * wv;
      if (adam) {
        const float m = b1 * mr[e] + (1.f - b1) * g;
        const float v = b2 * nr[e] + (1.f - b2) * g * g;
        mr[e] = m;
        nr[e] = v;
        wr[e] = wv - lr * (m / bc1) / (sqrtf(v / bc2) + eps_a);
      } else {
        const float m = momentum * mr[e] + g;
        mr[e] = m;
        wr[e] = wv - lr * m;
      }
    }

    // ---- stop rule + trace row ----
    if (tid == 0) {
      const float epoch = s.epoch + 1.f, loss = s.loss;
      bool stop = false;
      if (stable_mode) {
        s.stable = fabsf(loss - s.prev_loss) < eps ? s.stable + 1.f : 0.f;
        stop = s.stable == stable_target;
      }
      stop = stop || epoch >= max_epochs;
      stop = stop || (loss <= target && epoch >= min_epochs + 1.f);
      const int row = (int)epoch;
      if (row < a.trace_rows) {
        a.trace[row * 3 + 0] = loss;
        a.trace[row * 3 + 1] = s.acc1;
        a.trace[row * 3 + 2] = s.acc5;
      }
      s.epoch = epoch;
      s.prev_loss = loss;
      s.stop = stop;
    }
    __syncthreads();
  }

  if (tid == 0) {
    a.stats[0] = s.prev_loss;
    a.stats[1] = s.epoch;
    a.stats[2] = s.stable;
    a.stats[3] = s.acc1;
    a.stats[4] = s.acc5;
    a.stats[5] = a.stats[6] = a.stats[7] = 0.f;
  }
}

}  // namespace

extern "C" cudaError_t k1_finetune_loop(
    const float* f_sup, const int* y_sup, const float* f_mem, const int* y_mem,
    const float* w_in, const float* mom_in, const float* nu_in,
    const float* w0, const float* reserved, const float* pull_op,
    const float* pull_tgt, const float* scalars,
    float* w, float* mom, float* nu, float* stats, float* trace,
    float* logits, float* grad, float* pullv,
    int c_pad, int d, int n_sup, int mem_count, int n_active,
    int n_reserved, int orig_base, int n_ways, int bias_col, int flags,
    int trace_rows, void* stream) {
  if ((flags & F_PULL_SUB) && d > MAX_PULL_D) return cudaErrorInvalidValue;
  Args a{f_sup, y_sup, f_mem, y_mem, w_in, mom_in, nu_in, w0, reserved,
         pull_op, pull_tgt, scalars, w, mom, nu, stats, trace, logits, grad,
         pullv, c_pad, d, n_sup, mem_count, n_active, n_reserved,
         orig_base, n_ways, bias_col, flags, trace_rows};
  finetune_loop_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
