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
// Every sum is taken by fixed threads in a fixed order: the output is
// bit-equal from run to run.  Data written by other CTAs during the launch
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
constexpr int kMaxB = 16;             // batch rows a launch
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

__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_kernel(const float* __restrict__ gx,
                           const float* __restrict__ w_r,
                           const float* __restrict__ peep,
                           const float* __restrict__ w_rp,
                           const float* __restrict__ b_rp, float* out,
                           float* m_buf, unsigned int* bar, int batch, int t_len,
                           int c_dim, int r_dim, int oc, int cols, float s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sw = smem;                     // [R][32] this CTA's W_r columns
  float* sr = sw + r_dim * kCols;       // [16][R] s r(t-1)
  float* sp = sr + kMaxB * r_dim;       // [cols][C] its W_rp columns
  float* sg = sp + cols * c_dim;        // [16][32] gates
  float* sc = sg + kMaxB * kCols;       // [16][8] c(t-1)
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
  for (int i = tid; i < kMaxB * kCells; i += kThreads) sc[i] = 0.0f;
  // The cell update's thread: batch row tid / 8, cell cell0 + tid % 8.
  const int ub = tid / kCells, ucell = cell0 + tid % kCells;
  const bool updates = tid < batch * kCells;
  const float w_ic = updates ? peep[ucell] : 0.0f;
  const float w_fc = updates ? peep[c_dim + ucell] : 0.0f;
  const float w_oc = updates ? peep[2 * c_dim + ucell] : 0.0f;
  // Phase A's thread: gate column j, batch rows 2q and 2q + 1.
  const int aj = tid % kCols, aq = tid / kCols;
  const int ab0 = 2 * aq, ab1 = min(2 * aq + 1, batch - 1);
  const size_t acol = (aj / kCells) * c_dim + cell0 + aj % kCells;
  // Phase B's warp: batch rows 2 w and 2 w + 1.
  const int warp = tid / 32, lane = tid % 32;
  const int bb0 = 2 * warp, bb1 = min(2 * warp + 1, batch - 1);
  const unsigned int grid = gridDim.x;
  unsigned int arrivals = 0;
  __syncthreads();

  for (int t = 0; t < t_len; ++t) {
    // s r(t-1) into shared memory (r(-1) = 0).
    const int r4 = r_dim / 4;
    for (int i = tid; i < batch * r4; i += kThreads) {
      const int b = i / r4, k4 = i % r4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (t > 0) {
        v = __ldcg(reinterpret_cast<const float4*>(
                       out + (static_cast<size_t>(b) * t_len + t - 1) * oc) +
                   k4);
        v.x *= s;
        v.y *= s;
        v.z *= s;
        v.w *= s;
      }
      reinterpret_cast<float4*>(sr + b * r_dim)[k4] = v;
    }
    __syncthreads();

    // A: the gates.
    if (ab0 < batch) {
      const float* x0 = sr + ab0 * r_dim;
      const float* x1 = sr + ab1 * r_dim;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
      for (int k = 0; k < r_dim; k += 4) {
        const float4 u = *reinterpret_cast<const float4*>(x0 + k);
        const float4 v = *reinterpret_cast<const float4*>(x1 + k);
        const float w0 = sw[k * kCols + aj], w1 = sw[(k + 1) * kCols + aj];
        const float w2 = sw[(k + 2) * kCols + aj];
        const float w3 = sw[(k + 3) * kCols + aj];
        a0 = fmaf(u.x, w0, a0);
        a1 = fmaf(u.y, w1, a1);
        a2 = fmaf(v.x, w0, a2);
        a3 = fmaf(v.y, w1, a3);
        a0 = fmaf(u.z, w2, a0);
        a1 = fmaf(u.w, w3, a1);
        a2 = fmaf(v.z, w2, a2);
        a3 = fmaf(v.w, w3, a3);
      }
      const size_t row0 = (static_cast<size_t>(ab0) * t_len + t) * g4;
      sg[ab0 * kCols + aj] = __ldg(gx + row0 + acol) + (a0 + a1);
      if (2 * aq + 1 < batch) {
        const size_t row1 = (static_cast<size_t>(ab1) * t_len + t) * g4;
        sg[ab1 * kCols + aj] = __ldg(gx + row1 + acol) + (a2 + a3);
      }
    }
    __syncthreads();
    if (updates) {
      const float* g = sg + ub * kCols + tid % kCells;
      const float cp = s * sc[tid];
      const float gi = sigmoid(g[0] + w_ic * cp);
      const float gf = sigmoid(g[kCells] + w_fc * cp);
      const float cn = gf * cp + gi * tanhf(g[2 * kCells]);
      const float go = sigmoid(g[3 * kCells] + w_oc * cn);
      sc[tid] = cn;
      m_buf[static_cast<size_t>(ub) * c_dim + ucell] = go * tanhf(cn);
    }
    arrivals += grid;
    grid_barrier(bar, arrivals);

    // B: this CTA's output columns.
    if (bb0 < batch && ncol > 0) {
      const float* m0 = m_buf + static_cast<size_t>(bb0) * c_dim;
      const float* m1 = m_buf + static_cast<size_t>(bb1) * c_dim;
      float acc0[kMaxOc], acc1[kMaxOc];
#pragma unroll
      for (int j = 0; j < kMaxOc; ++j) acc0[j] = acc1[j] = 0.0f;
#pragma unroll 4
      for (int k = lane; k < c_dim; k += 32) {
        const float x0 = __ldcg(m0 + k), x1 = __ldcg(m1 + k);
#pragma unroll
        for (int j = 0; j < kMaxOc; ++j) {
          if (j < cols) {
            const float w = sp[j * c_dim + k];
            acc0[j] = fmaf(x0, w, acc0[j]);
            acc1[j] = fmaf(x1, w, acc1[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kMaxOc; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          acc0[j] += __shfl_xor_sync(0xffffffffu, acc0[j], off);
          acc1[j] += __shfl_xor_sync(0xffffffffu, acc1[j], off);
        }
      }
      if (lane == 0) {
        float* o0 = out + (static_cast<size_t>(bb0) * t_len + t) * oc + col0;
        float* o1 = out + (static_cast<size_t>(bb1) * t_len + t) * oc + col0;
        const bool second = 2 * warp + 1 < batch;
#pragma unroll
        for (int j = 0; j < kMaxOc; ++j) {
          if (j < ncol) {
            o0[j] = acc0[j] + b_rp[col0 + j];
            if (second) o1[j] = acc1[j] + b_rp[col0 + j];
          }
        }
      }
    }
    arrivals += grid;
    grid_barrier(bar, arrivals);
  }
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
  int cols = (oc + ctas - 1) / ctas;
  if (cols > kMaxOc) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(r_dim) * kCols + kMaxB * r_dim +
                       static_cast<size_t>(cols) * c_dim + kMaxB * kCols +
                       kMaxB * kCells);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* a_gx = static_cast<const float*>(gx);
  const float* a_wr = static_cast<const float*>(w_r);
  const float* a_peep = static_cast<const float*>(peep);
  const float* a_wrp = static_cast<const float*>(w_rp);
  const float* a_brp = static_cast<const float*>(b_rp);
  float* a_out = static_cast<float*>(out);
  float* a_m = static_cast<float*>(m_buf);
  unsigned int* a_bar = static_cast<unsigned int*>(bar);
  void* args[] = {&a_gx, &a_wr,  &a_peep, &a_wrp, &a_brp, &a_out, &a_m,
                  &a_bar, &batch, &t_len, &c_dim, &r_dim, &oc,    &cols,
                  &s};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(lstm_recurrence_kernel), dim3(ctas),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
