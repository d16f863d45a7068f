// The recurrence of a projected LSTM with peepholes (Kaldi's
// fast-lstmp-layer: LstmNonlinearityComponent + the recurrent-projection
// affine), all T steps of one layer in one launch (Hopper, sm_90a).
//
//   gx [B, T, 4C] (the gates' input half x W_x + b, columns i, f, g, o),
//   W_r [R, 4C], peepholes [3, C] (w_ic, w_fc, w_oc), W_rp [C, OC],
//   b_rp [OC], scale s, float32  ->  out [B, T, OC], OC = R + P
//
// with c(-1) = r(-1) = 0 and r(t) = out[:, t, :R]:
//   g = gx(t) + (s r(t-1)) W_r
//   i = sig(g_i + w_ic s c(t-1)), f = sig(g_f + w_fc s c(t-1))
//   c(t) = f s c(t-1) + i tanh(g_g), o = sig(g_o + w_oc c(t))
//   m(t) = o tanh(c(t)), out(t) = m(t) W_rp + b_rp
//
// It replaces no TPU kernel: the JAX package has no recurrent layer.  It
// was added for the chain TDNN-LSTM, whose recurrence, stepped from the
// host, costs 8-10 launches a step (two matmuls, the gates, the cell) and
// 1,167 steps a layer for a 35 s utterance.  The port's plain version is
// am/lstm.py::lstm_recurrence_ref.
//
// What bounds it on the H100: neither bytes nor FLOPs.  A step is two
// small matrix products in a chain ([B, R] x [R, 4C], then [B, C] x [C, OC];
// 1.6 MFLOP a batch row at the published widths), so its time is the
// latency of a step times the steps.  Design: one cooperative grid of C / 8
// CTAs of 256 threads, each CTA owning 8 cells.  Its 32 gate columns of W_r
// and its share of W_rp's columns stay in shared memory for the whole
// launch, the cells' c in shared memory; a step is
//   A  s r(t-1) from the output rows into shared memory; the CTA's 16 x 32
//      gates (each thread 2 batch rows of one column over R); the cell
//      update of its 8 cells; m(t) written to a global [B, C] scratch;
//   -- grid barrier --
//   B  its output columns (a warp per 2 batch rows, lanes over C, a
//      butterfly reduction), written to out(t);
//   -- grid barrier --
// Each thread's gate inputs gx(t) are loaded ahead, while step t - 1's B
// runs, so that their latency (they are read once, from HBM) is hidden.
// A batch of more than 16 rows (a chunked BLSTM's windows, about 90 a
// batch) runs in the same launch, as the kernel's wide form: phase A
// takes the rows 32 at a time (each thread 4 rows of one column; s r(t-1)
// of up to kMaxPass rows loaded into shared memory at once, the cells'
// state of every row kept there), phase B gives each warp 4 rows at a time;
// still two grid barriers a step.  Up to 16 rows take the narrow form, the
// design above.  Every sum is taken by fixed threads in a fixed order, the
// same for a row in either form and whatever the batch: the output is
// bit-equal from run to run, and a row's output does not depend on the
// rows beside it.  Data written by other CTAs during the launch
// is read with ld.global.cg (L2), never through L1.  The barrier is an
// arrival counter in global memory (zeroed by the caller, never reset: the
// k-th barrier waits for k x gridDim.x arrivals); the cooperative launch
// refuses a grid that cannot be resident at once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 8;             // cells a CTA owns
constexpr int kCols = 4 * kCells;     // their gate columns
constexpr int kMaxPass = 128;         // rows of s r(t-1) held at once
constexpr int kMaxB = 1024;           // batch rows a launch
constexpr int kMaxOc = 8;             // projection columns a CTA

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ void grid_barrier(unsigned int* count,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    volatile unsigned int* v = count;
    while (*v < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// Phase A's gate inputs of rows 2q + 16h and 2q + 16h + 1 of the group of
// gn rows from row `first` at step t (a row past the group reads its last
// row, and is not used).
template <int kHalves>
__device__ __forceinline__ void load_gates(float (&gxv)[kHalves][2],
                                           const float* __restrict__ gx,
                                           int first, int gn, int t,
                                           int t_len, size_t g4, size_t acol,
                                           int aq) {
#pragma unroll
  for (int h = 0; h < kHalves; ++h) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = first + min(2 * aq + 16 * h + e, gn - 1);
      gxv[h][e] = __ldg(gx + (static_cast<size_t>(row) * t_len + t) * g4 +
                        acol);
    }
  }
}

// kGroup: rows of a phase-A group (16: narrow, 32: wide; each thread
// kGroup / 8 rows of one gate column); kRows: rows a phase-B warp takes at
// a time (2 or 4).
template <int kGroup, int kRows>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_kernel(const float* __restrict__ gx,
                           const float* __restrict__ w_r,
                           const float* __restrict__ peep,
                           const float* __restrict__ w_rp,
                           const float* __restrict__ b_rp, float* out,
                           float* m_buf, unsigned int* bar, int batch, int t_len,
                           int c_dim, int r_dim, int oc, int cols, float s) {
  constexpr int kHalves = kGroup / 16;  // 2-row sets a phase-A thread takes
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int pass = min(batch, kMaxPass);  // rows of s r(t-1) held at once
  const int held = (pass + kGroup - 1) / kGroup * kGroup;
  float* sw = smem;                     // [R][32] this CTA's W_r columns
  float* sr = sw + r_dim * kCols;       // [held][R] s r(t-1)
  float* sp = sr + held * r_dim;        // [cols][C] its W_rp columns
  float* sg = sp + cols * c_dim;        // [kGroup][32] one group's gates
  float* sc = sg + kGroup * kCols;      // [batch][8] c(t-1)
  const int tid = threadIdx.x;
  const int cell0 = blockIdx.x * kCells;
  const int col0 = blockIdx.x * cols;
  const int ncol = max(0, min(cols, oc - col0));
  const size_t g4 = 4 * static_cast<size_t>(c_dim);

  // Gate column j of the CTA: gate j / 8 of cell cell0 + j % 8.
  for (int i = tid; i < r_dim * kCols; i += kThreads) {
    const int k = i / kCols, j = i % kCols;
    sw[i] = w_r[k * g4 + (j / kCells) * c_dim + cell0 + j % kCells];
  }
  for (int i = tid; i < cols * c_dim; i += kThreads) {
    const int j = i / c_dim, k = i % c_dim;
    sp[i] = j < ncol ? w_rp[static_cast<size_t>(k) * oc + col0 + j] : 0.0f;
  }
  for (int i = tid; i < batch * kCells; i += kThreads) sc[i] = 0.0f;
  // The cell update's thread: row tid / 8 of a group, cell cell0 + tid % 8.
  const int ub = tid / kCells, ucell = cell0 + tid % kCells;
  const float w_ic = peep[ucell];
  const float w_fc = peep[c_dim + ucell];
  const float w_oc = peep[2 * c_dim + ucell];
  // Phase A's thread: gate column j, rows 2q + 16h and 2q + 16h + 1 of a
  // group, h < kHalves.
  const int aj = tid % kCols, aq = tid / kCols;
  const size_t acol = (aj / kCells) * c_dim + cell0 + aj % kCells;
  // Phase B's warp: rows kRows p .. kRows p + kRows - 1 for p = w, w + 8, ...
  const int warp = tid / 32, lane = tid % 32;
  const int sets = (batch + kRows - 1) / kRows;
  const unsigned int grid = gridDim.x;
  unsigned int arrivals = 0;
  __syncthreads();

  // Phase A's gate inputs, each group's loaded ahead of its use: the
  // first group's of a step during the previous step's phase B.
  float gxv[kHalves][2];
  load_gates<kHalves>(gxv, gx, 0, min(kGroup, pass), 0, t_len, g4, acol, aq);
  for (int t = 0; t < t_len; ++t) {
    for (int p0 = 0; p0 < batch; p0 += pass) {
      const int pn = min(pass, batch - p0);
      if (p0 > 0) {
        load_gates<kHalves>(gxv, gx, p0, min(kGroup, pn), t, t_len, g4, acol,
                            aq);
      }
      // s r(t-1) of rows p0 .. p0 + pn - 1 into shared memory (r(-1) = 0).
      const int r4 = r_dim / 4;
      for (int i = tid; i < pn * r4; i += kThreads) {
        const int b = i / r4, k4 = i % r4;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (t > 0) {
          v = __ldcg(reinterpret_cast<const float4*>(
                         out + (static_cast<size_t>(p0 + b) * t_len + t - 1) *
                                   oc) +
                     k4);
          v.x *= s;
          v.y *= s;
          v.z *= s;
          v.w *= s;
        }
        reinterpret_cast<float4*>(sr + b * r_dim)[k4] = v;
      }
      __syncthreads();

      for (int g0 = 0; g0 < pn; g0 += kGroup) {
        const int gn = min(kGroup, pn - g0);
        if (g0 > 0) {
          load_gates<kHalves>(gxv, gx, p0 + g0, gn, t, t_len, g4, acol, aq);
        }
        // A: the gates of rows p0 + g0 .. p0 + g0 + gn - 1.
        if (2 * aq < gn) {
          const float* x0[kHalves];
          const float* x1[kHalves];
          float a[kHalves][4];
#pragma unroll
          for (int h = 0; h < kHalves; ++h) {
            const int r0 = min(2 * aq + 16 * h, gn - 1);
            const int r1 = min(2 * aq + 16 * h + 1, gn - 1);
            x0[h] = sr + (g0 + r0) * r_dim;
            x1[h] = sr + (g0 + r1) * r_dim;
            a[h][0] = a[h][1] = a[h][2] = a[h][3] = 0.0f;
          }
#pragma unroll 4
          for (int k = 0; k < r_dim; k += 4) {
            const float w0 = sw[k * kCols + aj], w1 = sw[(k + 1) * kCols + aj];
            const float w2 = sw[(k + 2) * kCols + aj];
            const float w3 = sw[(k + 3) * kCols + aj];
#pragma unroll
            for (int h = 0; h < kHalves; ++h) {
              const float4 u = *reinterpret_cast<const float4*>(x0[h] + k);
              const float4 v = *reinterpret_cast<const float4*>(x1[h] + k);
              a[h][0] = fmaf(u.x, w0, a[h][0]);
              a[h][1] = fmaf(u.y, w1, a[h][1]);
              a[h][2] = fmaf(v.x, w0, a[h][2]);
              a[h][3] = fmaf(v.y, w1, a[h][3]);
              a[h][0] = fmaf(u.z, w2, a[h][0]);
              a[h][1] = fmaf(u.w, w3, a[h][1]);
              a[h][2] = fmaf(v.z, w2, a[h][2]);
              a[h][3] = fmaf(v.w, w3, a[h][3]);
            }
          }
#pragma unroll
          for (int h = 0; h < kHalves; ++h) {
            const int r0 = 2 * aq + 16 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (r0 + e < gn) {
                sg[(r0 + e) * kCols + aj] =
                    gxv[h][e] + (a[h][2 * e] + a[h][2 * e + 1]);
              }
            }
          }
        }
        __syncthreads();
        if (tid < gn * kCells) {
          const int row = p0 + g0 + ub;
          const float* g = sg + ub * kCols + tid % kCells;
          float* cell = sc + (p0 + g0) * kCells + tid;
          const float cp = s * *cell;
          const float gi = sigmoid(g[0] + w_ic * cp);
          const float gf = sigmoid(g[kCells] + w_fc * cp);
          const float cn = gf * cp + gi * tanhf(g[2 * kCells]);
          const float go = sigmoid(g[3 * kCells] + w_oc * cn);
          *cell = cn;
          m_buf[static_cast<size_t>(row) * c_dim + ucell] = go * tanhf(cn);
        }
        __syncthreads();
      }
    }
    arrivals += grid;
    grid_barrier(bar, arrivals);
    // The next step's first gate inputs, loaded while B runs (not before
    // the barrier: its fence would wait for them).
    if (t + 1 < t_len) {
      load_gates<kHalves>(gxv, gx, 0, min(kGroup, pass), t + 1, t_len, g4,
                          acol, aq);
    }

    // B: this CTA's output columns.
    for (int p = warp; p < sets && ncol > 0; p += kThreads / 32) {
      const float* m[kRows];
      float acc[kRows][kMaxOc];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        m[i] = m_buf +
               static_cast<size_t>(min(kRows * p + i, batch - 1)) * c_dim;
#pragma unroll
        for (int j = 0; j < kMaxOc; ++j) acc[i][j] = 0.0f;
      }
#pragma unroll 4
      for (int k = lane; k < c_dim; k += 32) {
        float x[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) x[i] = __ldcg(m[i] + k);
#pragma unroll
        for (int j = 0; j < kMaxOc; ++j) {
          if (j < cols) {
            const float w = sp[j * c_dim + k];
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(x[i], w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxOc; ++j) {
        if (j < cols) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
            }
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (kRows * p + i < batch) {
            float* o = out +
                       (static_cast<size_t>(kRows * p + i) * t_len + t) * oc +
                       col0;
#pragma unroll
            for (int j = 0; j < kMaxOc; ++j) {
              if (j < ncol) o[j] = acc[i][j] + b_rp[col0 + j];
            }
          }
        }
      }
    }
    arrivals += grid;
    grid_barrier(bar, arrivals);
  }
}

template <int kGroup, int kRows>
int launch(const float* gx, const float* w_r, const float* peep,
           const float* w_rp, const float* b_rp, float* out, float* m_buf,
           unsigned int* bar, int batch, int t_len, int c_dim, int r_dim,
           int oc, int cols, float s, cudaStream_t stream) {
  const int pass = batch < kMaxPass ? batch : kMaxPass;
  const int held = (pass + kGroup - 1) / kGroup * kGroup;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(r_dim) * kCols +
                       static_cast<size_t>(held) * r_dim +
                       static_cast<size_t>(cols) * c_dim + kGroup * kCols +
                       static_cast<size_t>(batch) * kCells);
  auto kernel = lstm_recurrence_kernel<kGroup, kRows>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&gx,    &w_r,   &peep,  &w_rp,  &b_rp, &out,  &m_buf, &bar,
                  &batch, &t_len, &c_dim, &r_dim, &oc,   &cols, &s};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(c_dim / kCells), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int catears_lstm_recurrence(const void* gx, const void* w_r, const void* peep,
                            const void* w_rp, const void* b_rp, void* out,
                            void* m_buf, void* bar, int batch, int t_len,
                            int c_dim, int r_dim, int oc, float s,
                            void* stream) {
  if (batch < 1 || batch > kMaxB || c_dim % kCells || c_dim % 4 ||
      r_dim % 4 || oc % 4 || t_len < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ctas = c_dim / kCells;
  const int cols = (oc + ctas - 1) / ctas;
  if (cols > kMaxOc) return static_cast<int>(cudaErrorInvalidValue);
  auto run = batch <= 16 ? launch<16, 2> : launch<32, 4>;
  return run(static_cast<const float*>(gx), static_cast<const float*>(w_r),
             static_cast<const float*>(peep), static_cast<const float*>(w_rp),
             static_cast<const float*>(b_rp), static_cast<float*>(out),
             static_cast<float*>(m_buf), static_cast<unsigned int*>(bar),
             batch, t_len, c_dim, r_dim, oc, cols, s,
             static_cast<cudaStream_t>(stream));
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
