// The emitting expansion of an eps-removed frame with its acoustic term,
// in one launch (Hopper, sm_90a).
//
//   beam states, costs (, lms) [B, K] + the graph's emit_block rows and
//   over_packed CSR rows + logp [B, P] -> candidates [B, E]:
//   state (SENTINEL_STATE on dead lanes), cost (+inf on dead lanes), tok,
//   olabel, olab2 (, lm) (0 on dead lanes); overflow [B] (u8), needed [B];
//   with the hot/cold split, cold_over [B] (u8) and cold_needed [B].
//   E = K (self-loops) + K * G (each token's first-G block) + n_slots * Gc
//   (the CSR overflow slots), in that lane order.
//
// Replaces, for the emitting pass of an eps-removed graph, the JAX
// package's catears_tpu/decode/beam.py::_expand (:452; the compact row
// :489, the classic row with the hot/cold split :509-521, the CSR pass
// :576), _expand_csr (:347, slot ownership :381-391), _acoustic_lookup
// (:617) and the acoustic line of
// _eps_free_step (:717, cost = c.cost - am_scale * logp[pdf]).  It holds
// the port's plain version (decode/beam.py::expand_emitting_ref: _expand,
// _acoustic and _fms, some 90 launches) bit for bit, lane for lane.
//
// Grid: (ceil(E / kLanesPerBlock), B); one thread per output lane.
//   * self-loop lane t and block lane K + t*G + j read token t's emit row
//     (the compact 9-lane row of graph/device.py, or the classic
//     G*5 + 8 row);
//   * the hot/cold split (classic rows, DeviceFst.hot_rows > 0 and
//     cold_expand_size > 0): a token on a state below hot_rows (or an
//     empty slot) reads the state's emit_hot row; the first cap cold
//     tokens in slot order read emit_block; a cold token past those reads
//     emit_hot's row 0 (a wrong row, flagged by cold_over), as the plain
//     version's compaction of cold tokens into cap lanes gives.  Every
//     block counts the cold tokens before each slot (a block scan) and
//     keeps each token's row in shared memory;
//   * CSR lanes need each slot's owner: every block that holds CSR lanes
//     (and block 0 of each row, which writes needed / overflow) scans the
//     K tokens' span rows ceil(max(n_emit - G, 0) / Gc) into an inclusive
//     prefix sum in shared memory; slot s belongs to the first token whose
//     prefix sum exceeds s (a binary search), as JAX's scatter-max +
//     cummax and its searchsorted branch both give on the live slots.
//     Only the live slots are written as candidates: the two JAX branches
//     differ on the dead ones, which hold SENTINEL_STATE here.
//
// Rows whose frame is invalid (row_valid[row] == 0, given a row_valid) do
// no work: block 0 of the row writes a dead row's per-row outputs
// (overflow 0, needed 0; with the split cold_over 0, cold_needed 0), and
// every block of the row leaves before any scan, graph read, barrier or
// lane write; every block reads the same flag once, so the exit is
// uniform.  Such a row's [E] lanes are left as they were: the selection
// (frame_select.cu) leaves the same rows before it reads a lane, and the
// frame step throws their beam away.
//
// Bit-exactness: cost = fmaf(-am_scale, logp[b, pdf], tok_cost + w), the
// sum rounded once (__fadd_rn) and the FMA once (__fmaf_rn): XLA:CPU
// contracts JAX's `c - am_scale * l` into one FMA, which the plain version
// computes in float64 with round-to-odd.  A pdf outside [0, P) reads 0.0.
//
// What bounds it on the H100 (3.35 TB/s): bytes.  Per live token its emit
// row (36 B compact) and its state and cost (and lm), per used CSR slot
// one over_packed row (Gc * 20 B), per live lane one logp read, and 20-24
// B written per lane: about 1 MB a row at the bench's 16 x 38,912 lanes,
// ~5-8 us for the batch.  The rows and logp are gathers, mostly L2 hits.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesPerBlock = 8 * kThreads;
constexpr int kSentinel = 1 << 30;  // decode/beam.py SENTINEL_STATE

struct Expand {
  const int* states;  // [B, K]
  const float* costs;
  const int* lms;     // or null (LM off)
  const int* emit;    // [S, row_w]
  const int* over;    // [over_rows, Gc * 5]
  const float* logp;  // [B, P], rows ldp apart
  int* o_state;       // [B, E] each
  float* o_cost;
  int* o_tok;
  int* o_olabel;
  int* o_olab2;
  int* o_lm;  // or null
  unsigned char* overflow;  // [B]
  int* needed;              // [B]
  const int* emit_hot;      // [hot_rows, row_w], or null (no split)
  unsigned char* cold_over;  // [B] (the split only)
  int* cold_needed;          // [B] (the split only)
  const unsigned char* row_valid;  // [B] (bool), or null: every row
  int hot_rows, cold_cap;
  int k, e, g, row_w, compact, num_states, gc, over_rows, n_slots, csr, p;
  int ldp;  // logp's row stride
  float am_scale;
};

__device__ __forceinline__ int srl(int x, int n) {
  return static_cast<int>(static_cast<unsigned>(x) >> n);
}

__device__ __forceinline__ int clamp_state(const Expand& a, int s) {
  return s < 0 ? 0 : (s > a.num_states - 1 ? a.num_states - 1 : s);
}

// Token t's emit row: the state's emit_block row, or with the split the
// row the token's entry of `rows` names (>= 0: emit_block, < 0: emit_hot
// row -1 - v).
__device__ __forceinline__ const int* emit_row(const Expand& a,
                                               const int* rows, const int* st,
                                               int t) {
  if (!a.emit_hot)
    return a.emit + static_cast<size_t>(clamp_state(a, st[t])) * a.row_w;
  const int v = rows[t];
  return v >= 0 ? a.emit + static_cast<size_t>(v) * a.row_w
                : a.emit_hot + static_cast<size_t>(-1 - v) * a.row_w;
}

// The split's classes of a token: cold when live on a state >= hot_rows.
__device__ __forceinline__ bool is_cold(const Expand& a, int s) {
  return s >= 0 && clamp_state(a, s) >= a.hot_rows;
}

// Inclusive prefix sums of f(t) over the K tokens into cum[0, K); returns
// the total.  Block-wide: each thread sums a run of tokens, then a scan of
// the runs' totals.
template <class F>
__device__ int scan_tokens(int k, int* cum, int* warp_base, F f) {
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  __syncthreads();  // warp_base and cum may be in use
  const int per = (k + kThreads - 1) / kThreads;
  const int t0 = min(tid * per, k), t1 = min(t0 + per, k);
  int total = 0;
  for (int t = t0; t < t1; ++t) {
    const int v = f(t);
    cum[t] = v;
    total += v;
  }
  int incl = total;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane_id >= d) incl += v;
  }
  if (lane_id == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int c = lane_id < kWarps ? warp_base[lane_id] : 0;
    int w_incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, w_incl, d);
      if (lane_id >= d) w_incl += v;
    }
    __syncwarp();
    if (lane_id < kWarps) warp_base[lane_id] = w_incl - c;
  }
  __syncthreads();
  int run = warp_base[warp] + incl - total;
  for (int t = t0; t < t1; ++t) {
    run += cum[t];
    cum[t] = run;
  }
  __syncthreads();
  return cum[k - 1];
}

// The token's remaining emitting arcs (0 for an empty slot).
__device__ __forceinline__ int n_emit_of(const Expand& a, const int* row,
                                         bool live) {
  if (!live) return 0;
  return a.compact ? (srl(row[7], 13) & 0x3FF) : row[a.g * 5 + 3];
}

__device__ __forceinline__ int over_lo_of(const Expand& a, const int* row) {
  return a.compact ? row[8] : row[a.g * 5 + 2];
}

__device__ __forceinline__ int span_rows(const Expand& a, const int* rows,
                                         const int* st, int t) {
  const int n_arcs = n_emit_of(a, emit_row(a, rows, st, t), st[t] >= 0) - a.g;
  return n_arcs > 0 ? (n_arcs + a.gc - 1) / a.gc : 0;
}

// One candidate lane: a live arc, or a dead lane.
__device__ __forceinline__ void put(const Expand& a, size_t at, bool valid,
                                    int next, float tok_cost, int w_bits,
                                    int pdf, const float* lp, int tok,
                                    int olabel, int olab2, int lm) {
  if (valid) {
    const float c = __fadd_rn(tok_cost, __int_as_float(w_bits));
    const float l = (pdf >= 0 && pdf < a.p) ? __ldg(lp + pdf) : 0.0f;
    a.o_state[at] = next;
    a.o_cost[at] = __fmaf_rn(-a.am_scale, l, c);
    a.o_tok[at] = tok;
    a.o_olabel[at] = olabel;
    a.o_olab2[at] = olab2;
    if (a.o_lm) a.o_lm[at] = lm;
  } else {
    a.o_state[at] = kSentinel;
    a.o_cost[at] = INFINITY;
    a.o_tok[at] = 0;
    a.o_olabel[at] = 0;
    a.o_olab2[at] = 0;
    if (a.o_lm) a.o_lm[at] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    frame_expand_kernel(Expand a) {
  // [K] inclusive span-row sums (the CSR pass), then with the split [K]
  // each token's row.
  extern __shared__ int smem[];
  __shared__ int warp_base[kWarps];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * kLanesPerBlock;
  const int lane_end = min(lane0 + kLanesPerBlock, a.e);
  const int csr0 = a.k + a.k * a.g;
  const int* st = a.states + static_cast<size_t>(b) * a.k;
  const float* co = a.costs + static_cast<size_t>(b) * a.k;
  const int* lm = a.lms ? a.lms + static_cast<size_t>(b) * a.k : nullptr;
  const float* lp = a.logp + static_cast<size_t>(b) * a.ldp;
  const size_t out = static_cast<size_t>(b) * a.e;
  int* cum = smem;
  int* rows = smem + (a.csr ? a.k : 0);

  if (a.row_valid && !a.row_valid[b]) {  // a masked row: a dead row's flags
    if (blockIdx.x == 0 && tid == 0) {
      a.needed[b] = 0;
      a.overflow[b] = 0;
      if (a.emit_hot) {
        a.cold_needed[b] = 0;
        a.cold_over[b] = 0;
      }
    }
    return;
  }
  if (a.emit_hot) {  // each token's row, from the cold tokens before it
    const int cold = scan_tokens(a.k, rows, warp_base,
                                 [&](int t) { return is_cold(a, st[t]); });
    for (int t = tid; t < a.k; t += kThreads) {
      const int s = clamp_state(a, st[t]);
      const int before = rows[t] - is_cold(a, st[t]);
      rows[t] = s < a.hot_rows ? -1 - s
                               : (st[t] >= 0 && before < a.cold_cap ? s : -1);
    }
    __syncthreads();
    if (blockIdx.x == 0 && tid == 0) {
      a.cold_needed[b] = cold;
      a.cold_over[b] = cold > a.cold_cap ? 1 : 0;
    }
  }
  int rows_needed = 0;
  if (a.csr && (lane_end > csr0 || blockIdx.x == 0)) {
    rows_needed = scan_tokens(a.k, cum, warp_base, [&](int t) {
      return span_rows(a, rows, st, t);
    });
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.needed[b] = rows_needed * a.gc;
    a.overflow[b] = rows_needed > a.n_slots ? 1 : 0;
  }

  for (int i = lane0 + tid; i < lane_end; i += kThreads) {
    const size_t at = out + i;
    if (i < a.k) {  // the token's extracted self-loop
      const int s = st[i];
      const int* row = emit_row(a, rows, st, i);
      int has, olabel, w, pdf;
      if (a.compact) {
        has = srl(row[7], 12) & 1;
        olabel = 0;  // packable guarantees it
        w = row[6];
        pdf = row[7] & 0xFFF;
      } else {
        const int* sf = row + a.g * 5 + 4;
        has = sf[0];
        olabel = sf[1];
        w = sf[2];
        pdf = sf[3];
      }
      put(a, at, s >= 0 && has > 0, clamp_state(a, s), co[i], w, pdf, lp, i,
          olabel, 0, lm ? lm[i] : 0);
    } else if (i < csr0) {  // the token's first-G block
      const int t = (i - a.k) / a.g, j = (i - a.k) % a.g;
      const int s = st[t];
      const int* row = emit_row(a, rows, st, t);
      int next, olabel, w, pdf, l4;
      if (a.compact) {  // G == 2
        const int nw = row[2 * j];
        next = nw & 0xFFFFF;
        pdf = srl(nw, 20);
        w = row[2 * j + 1];
        olabel = j ? srl(row[4], 16) : (row[4] & 0xFFFF);
        l4 = j ? srl(row[5], 16) : (row[5] & 0xFFFF);
      } else {
        const int* arc = row + j * 5;
        next = arc[0];
        olabel = arc[1];
        w = arc[2];
        pdf = arc[3];
        l4 = arc[4];
      }
      put(a, at, j < n_emit_of(a, row, s >= 0), next, co[t], w, pdf, lp, t,
          olabel, l4, lm ? lm[t] : 0);
    } else {  // a CSR overflow slot's lane
      const int slot = (i - csr0) / a.gc, j = (i - csr0) % a.gc;
      bool valid = false;
      if (slot < rows_needed) {
        int lo = 0, hi = a.k - 1;  // the first token whose sum exceeds slot
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cum[mid] > slot) {
            hi = mid;
          } else {
            lo = mid + 1;
          }
        }
        const int t = lo;
        const int r = slot - (t ? cum[t - 1] : 0);
        const int s = st[t];
        const int* row = emit_row(a, rows, st, t);
        valid = r * a.gc + j < n_emit_of(a, row, s >= 0) - a.g;
        if (valid) {
          int ri = over_lo_of(a, row) + r;
          ri = ri < 0 ? 0 : (ri > a.over_rows - 1 ? a.over_rows - 1 : ri);
          const int* arc =
              a.over + static_cast<size_t>(ri) * a.gc * 5 + j * 5;
          put(a, at, true, arc[0], co[t], arc[2], arc[3], lp, t, arc[1],
              arc[4], lm ? lm[t] : 0);
        }
      }
      if (!valid) put(a, at, false, 0, 0.0f, 0, 0, lp, 0, 0, 0, 0);
    }
  }
}

}  // namespace

extern "C" {

// `csr` says whether the graph has a CSR pass (max_emit_fanout > G);
// n_slots = ceil(expand_size / Gc) is its slot count (E's last n_slots *
// Gc lanes).  overflow and needed report its demand, as JAX's.  emit_hot
// non-null runs the hot/cold split over its hot_rows rows with cold_cap =
// min(cold_expand_size, K) cold lanes (classic rows only).  row_valid
// non-null ([B] bool) masks rows: a masked row does no work and gets a
// dead row's per-row outputs; its lanes are not written.
int catears_frame_expand(const void* states, const void* costs,
                         const void* lms, const void* emit, const void* over,
                         const void* logp, void* o_state, void* o_cost,
                         void* o_tok, void* o_olabel, void* o_olab2,
                         void* o_lm, void* overflow, void* needed,
                         const void* emit_hot, void* cold_over,
                         void* cold_needed, const void* row_valid,
                         int hot_rows, int cold_cap,
                         int rows,
                         int k, int e, int g, int row_w, int compact,
                         int num_states, int gc, int over_rows, int n_slots,
                         int csr, int p, int ldp, float am_scale,
                         void* stream) {
  const Expand a{static_cast<const int*>(states),
                 static_cast<const float*>(costs),
                 static_cast<const int*>(lms),
                 static_cast<const int*>(emit),
                 static_cast<const int*>(over),
                 static_cast<const float*>(logp),
                 static_cast<int*>(o_state),
                 static_cast<float*>(o_cost),
                 static_cast<int*>(o_tok),
                 static_cast<int*>(o_olabel),
                 static_cast<int*>(o_olab2),
                 static_cast<int*>(o_lm),
                 static_cast<unsigned char*>(overflow),
                 static_cast<int*>(needed),
                 static_cast<const int*>(emit_hot),
                 static_cast<unsigned char*>(cold_over),
                 static_cast<int*>(cold_needed),
                 static_cast<const unsigned char*>(row_valid),
                 hot_rows,
                 cold_cap,
                 k, e, g, row_w, compact, num_states, gc, over_rows, n_slots,
                 csr, p, ldp, am_scale};
  const size_t smem = sizeof(int) * static_cast<size_t>(k) *
                      ((csr ? 1 : 0) + (emit_hot ? 1 : 0));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frame_expand_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((e + kLanesPerBlock - 1) / kLanesPerBlock, rows);
  frame_expand_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
