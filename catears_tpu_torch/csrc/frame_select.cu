// The eps-free frame's selection: exact dedup by (state, lm), exact top-K
// and the beam threshold, in one launch (Hopper, sm_90a).
//
//   candidates [B, E]: state, lm (or none: LM off), cost, the two walk
//   weights w1, w2 (or none), and the payloads tok, olab2, olabel ->
//   the new beam's states, lms, costs [B, K], prev_slot [B, K], words
//   [B, K, 2] (olab2, olabel: newest first), demand [B] (hiwater 3) and,
//   with select_compact, its overflow [B].
//
// Replaces the JAX package's catears_tpu/decode/beam.py::_select_best
// (:155, compact=True) with both of its selections: _select_sorts (:257,
// select_compact 0: a stable sort on (state, lm, cost), the group firsts,
// a stable sort by the firsts' costs, the first K) and _select_compacted
// (:186, select_compact > 0: the beam-threshold survivors compacted into
// c2 = max(select_compact, K) lanes in (state, lm) order, then a stable
// sort by cost and the first K, or at c2 == K no sort), and the beam
// threshold of _eps_free_step (:738-745).  It holds the port's plain
// version (decode/beam.py::select_beam_ref: those sorts in PyTorch, about
// 60 launches) bit for bit.
//
// The function, as the sorts define it:
//   * a lane's cost is (cost + w1) + w2, each sum rounded once;
//   * each (state, lm) group with state < SENTINEL_STATE has one winner:
//     the least cost, -0.0 equal to +0.0 and every NaN after +inf, the
//     earliest lane on ties;
//   * the survivors are the winners with a finite cost <= min + beam (min
//     over every lane's cost, the sum rounded once; a NaN lane makes it
//     NaN and leaves none); demand counts them;
//   * c2 = 0: the winners whose cost is below +inf are taken in (cost,
//     state, lm) order (unique among them: the prune sort's ties fall to
//     the dedup sort's (state, lm) order); the first K fill the slots;
//   * c2 > 0: the first c2 survivors in (state, lm) order; overflow when
//     there are more.  c2 > K: of those, the first K in (cost, state, lm)
//     order; c2 == K: all of them, in (state, lm) order;
//   * a slot keeps its winner when the cost is finite and <= the least
//     finite cost among the slots + beam; a slot whose finite winner fails
//     that holds state -1, cost +inf, tok 0, words 0 and the winner's lm;
//     any other slot holds lm 0 too.  The cost kept is the winner's own
//     bits (a -0.0 stays -0.0).
//
// One block of kThreads per row:
//   1. each lane with state < SENTINEL_STATE claims its group in an
//      open-addressing table (global scratch, [B, cap], L2-resident,
//      cleared by one memset a call) with a 64-bit CAS on the (state, lm)
//      key, then a 64-bit atomicMin on (order-preserving cost bits << 32 |
//      lane): a min, so the winner does not depend on the order of the
//      atomics.  A claim appends its table slot to the row's group list;
//      the lanes' costs are min-reduced on the way;
//   2. the winners below +inf (c2 = 0) or the survivors (c2 > 0) are
//      listed as 96-bit keys (cost bits, state, lm) with their lane;
//      demand is counted;
//   3. radix selects, 8 bits a pass from the most significant digit of a
//      key order, each ending as soon as its bucket holds exactly the rank
//      still wanted: with more than c2 survivors, the c2-th in (state, lm)
//      order; then, unless c2 == K, the K-th in (cost, state, lm) order
//      among the keys the first kept (usually after the four cost digits);
//   4. the K (or fewer) selected keys are bitonic-sorted in shared memory
//      and written out with the threshold applied.
//
// What bounds it on the H100 (3.35 TB/s): bytes.  Each lane's state, cost
// (and lm, w1, w2) read once, 8-20 B; the K winners' payloads and the [B,
// K] outputs: about 2.5 us at the bench's 16 x 38,912 lanes.  The table's
// memset (16 B a slot), its random atomics and the one block per row (16
// of the 132 SMs at B = 16) keep it well above that: the first things to
// widen if it shows in a profile.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSentinel = 1 << 30;  // decode/beam.py SENTINEL_STATE
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned kOrdPosInf = 0xFF800000u;  // ordered(+inf)

struct Select {
  const int* state;  // [B, E] each
  const int* lm;     // or null
  const float* cost;
  const float* w1;  // or null
  const float* w2;  // or null
  const int* tok;
  const int* olab2;
  const int* olabel;
  int* o_states;  // [B, K] each
  int* o_lms;
  float* o_costs;
  int* o_prev;
  int* o_words;  // [B, K, 2]
  int* demand;   // [B]
  unsigned char* overflow;    // [B], or null (c2 == 0)
  unsigned long long* table;  // [B, 2, cap]: keys, then winners
  int* groups;                // [B, E] claimed table slots
  uint4* cands;               // [B, E] (cost key, state, lm, lane)
  int e, k, c2, log2cap;
  float beam;
};

// A key order: the uint4 words (x cost, y state, z lm) most significant
// first.
struct Order {
  int w[3];
};
__device__ __forceinline__ Order by_cost() { return Order{{0, 1, 2}}; }
// (state, lm): unique among winners.
__device__ __forceinline__ Order by_group() { return Order{{1, 2, 0}}; }

// The keys a radix select kept: under `o`, those whose digits masked by
// m are at most p.  `on` false keeps every key.
struct Cut {
  unsigned p[3], m[3];
  Order o;
  bool on;
};

__device__ __forceinline__ unsigned word(const uint4& c, int w) {
  return w == 0 ? c.x : (w == 1 ? c.y : c.z);
}

// Order-preserving cost bits: -0.0 == +0.0, every NaN after +inf.
__device__ __forceinline__ unsigned ordered(float c) {
  unsigned u = __float_as_uint(c);
  if (c == 0.0f) u = 0u;
  if (c != c) u = 0x7FC00000u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ bool key_less(const uint4& x, const uint4& y,
                                         const Order& o) {
  for (int i = 0; i < 3; ++i) {
    const unsigned a = word(x, o.w[i]), b = word(y, o.w[i]);
    if (a != b) return a < b;
  }
  return false;
}

__device__ __forceinline__ bool within(const uint4& c, const Cut& f) {
  if (!f.on) return true;
  for (int i = 0; i < 2; ++i) {
    const unsigned a = word(c, f.o.w[i]) & f.m[i];
    if (a != f.p[i]) return a < f.p[i];
  }
  return (word(c, f.o.w[2]) & f.m[2]) <= f.p[2];
}

// Shared scratch of the radix select.
struct Radix {
  unsigned hist[256];
  unsigned pre[3], msk[3];
  int rank, done;
};

// The cut that keeps exactly the `want` least keys under `o` of the
// cands that `in` keeps (there are more than `want` of them, and their
// keys under `o` are unique).  Block-wide; every thread gets the cut.
__device__ Cut radix_select(const uint4* cands, int nc, int want,
                            const Order& o, const Cut& in, Radix& r) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    r.pre[0] = r.pre[1] = r.pre[2] = r.msk[0] = r.msk[1] = r.msk[2] = 0u;
    r.rank = want;
    r.done = 0;
  }
  __syncthreads();
  for (int d = 0; d < 12; ++d) {
    if (r.done) break;  // block-uniform: read after a barrier
    const int w = d >> 2, shift = 24 - 8 * (d & 3);
    for (int i = tid; i < 256; i += kThreads) r.hist[i] = 0u;
    __syncthreads();
    Cut cur;
    for (int i = 0; i < 3; ++i) {
      cur.p[i] = r.pre[i];
      cur.m[i] = r.msk[i];
    }
    for (int i = tid; i < nc; i += kThreads) {
      const uint4 c = cands[i];
      bool match = within(c, in);
      for (int j = 0; j < 3 && match; ++j)
        match = ((word(c, o.w[j]) ^ cur.p[j]) & cur.m[j]) == 0;
      if (match) atomicAdd(&r.hist[(word(c, o.w[w]) >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      int rank = r.rank;
      int bucket = 0;
      for (; bucket < 255; ++bucket) {
        if (static_cast<int>(r.hist[bucket]) >= rank) break;
        rank -= static_cast<int>(r.hist[bucket]);
      }
      r.pre[w] |= static_cast<unsigned>(bucket) << shift;
      r.msk[w] |= 0xFFu << shift;
      r.rank = rank;
      if (static_cast<int>(r.hist[bucket]) == rank) r.done = 1;
    }
    __syncthreads();
  }
  Cut out;
  for (int i = 0; i < 3; ++i) {
    out.p[i] = r.pre[i];
    out.m[i] = r.msk[i];
  }
  out.o = o;
  out.on = true;
  __syncthreads();  // before the scratch is used again
  return out;
}

__device__ __forceinline__ float lane_cost(const Select& a, size_t i) {
  float c = a.cost[i];
  if (a.w1) c = __fadd_rn(c, a.w1[i]);
  if (a.w2) c = __fadd_rn(c, a.w2[i]);
  return c;
}

// The block's min of v (NaN when any thread's `nan` is set), to every
// thread.
__device__ float block_min(float v, int nan, float* warp_min, int* warp_nan,
                           float* out) {
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  for (int d = 16; d > 0; d >>= 1) {
    v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
    nan |= __shfl_xor_sync(0xFFFFFFFFu, nan, d);
  }
  if (lane_id == 0) {
    warp_min[warp] = v;
    warp_nan[warp] = nan;
  }
  __syncthreads();
  if (warp == 0) {
    v = warp_min[lane_id];
    nan = warp_nan[lane_id];
    for (int d = 16; d > 0; d >>= 1) {
      v = fminf(v, __shfl_xor_sync(0xFFFFFFFFu, v, d));
      nan |= __shfl_xor_sync(0xFFFFFFFFu, nan, d);
    }
    if (lane_id == 0) *out = nan ? NAN : v;
  }
  __syncthreads();
  return *out;
}

__global__ void __launch_bounds__(kThreads, 1)
    frame_select_kernel(Select a) {
  extern __shared__ uint4 ent[];  // [next_pow2(K)] the selected keys
  __shared__ Radix radix;
  __shared__ float warp_min[kWarps];
  __shared__ int warp_nan[kWarps];
  __shared__ int n_groups, n_cand, n_sel, demand_s;
  __shared__ float min_s;
  const int tid = threadIdx.x, lane_id = tid & 31;
  const size_t row = blockIdx.x;
  const size_t base = row * a.e;
  const unsigned cap = 1u << a.log2cap;
  unsigned long long* keys = a.table + row * 2 * cap;
  unsigned long long* wins = keys + cap;
  int* groups = a.groups + base;
  uint4* cands = a.cands + base;
  if (tid == 0) n_groups = n_cand = n_sel = demand_s = 0;
  __syncthreads();

  // 1. Group winners; the min over every lane's cost.
  float mn = INFINITY;
  int nan = 0;
  for (int i = tid; i < a.e; i += kThreads) {
    const float c = lane_cost(a, base + i);
    if (c != c) {
      nan = 1;
    } else {
      mn = fminf(mn, c);
    }
    const int s = a.state[base + i];
    if (s >= kSentinel) continue;
    const unsigned l = a.lm ? static_cast<unsigned>(a.lm[base + i]) : 0u;
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<unsigned>(s) ^
                                         0x80000000u) << 32) | l;
    unsigned h = static_cast<unsigned>((key * 0x9E3779B97F4A7C15ull) >>
                                       (64 - a.log2cap));
    while (true) {
      const unsigned long long prev = atomicCAS(keys + h, kEmpty, key);
      if (prev == kEmpty) {
        groups[atomicAdd(&n_groups, 1)] = static_cast<int>(h);
        break;
      }
      if (prev == key) break;
      h = (h + 1) & (cap - 1);
    }
    atomicMin(wins + h,
              (static_cast<unsigned long long>(ordered(c)) << 32) |
                  static_cast<unsigned>(i));
  }
  const float min_all = block_min(mn, nan, warp_min, warp_nan, &min_s);

  // 2. The winners below +inf (c2 = 0) or the survivors as keys; demand.
  const float demand_cut = __fadd_rn(min_all, a.beam);
  int demand = 0;
  for (int gi = tid; gi < n_groups; gi += kThreads) {
    const unsigned h = static_cast<unsigned>(groups[gi]);
    const unsigned long long key = keys[h], win = wins[h];
    const unsigned ck = static_cast<unsigned>(win >> 32);
    const unsigned lane = static_cast<unsigned>(win);
    const float c = lane_cost(a, base + lane);
    const bool survives = isfinite(c) && c <= demand_cut;
    if (survives) ++demand;
    if (a.c2 ? survives : ck < kOrdPosInf) {
      cands[atomicAdd(&n_cand, 1)] =
          make_uint4(ck, static_cast<unsigned>(key >> 32),
                     static_cast<unsigned>(key) ^ 0x80000000u, lane);
    }
  }
  for (int d = 16; d > 0; d >>= 1)
    demand += __shfl_xor_sync(0xFFFFFFFFu, demand, d);
  if (lane_id == 0 && demand) atomicAdd(&demand_s, demand);
  __syncthreads();
  const int nc = n_cand;

  // 3. The radix selects: the first c2 survivors in (state, lm) order,
  // then the first K of those in (cost, state, lm) order.
  Cut first_c2, first_k;
  first_c2.on = first_k.on = false;
  int n_in = nc;
  if (a.c2 && nc > a.c2) {
    first_c2 = radix_select(cands, nc, a.c2, by_group(), first_c2, radix);
    n_in = a.c2;
  }
  const bool group_order = a.c2 && a.c2 <= a.k;  // c2 == K: no prune sort
  if (!group_order && n_in > a.k)
    first_k = radix_select(cands, nc, a.k, by_cost(), first_c2, radix);

  // 4. The selected keys, sorted.
  for (int i = tid; i < nc; i += kThreads) {
    const uint4 c = cands[i];
    if (within(c, first_c2) && within(c, first_k)) {
      const int at = atomicAdd(&n_sel, 1);
      if (at < a.k) ent[at] = c;
    }
  }
  __syncthreads();
  const int ns = min(n_sel, a.k);
  const Order order = group_order ? by_group() : by_cost();
  int n2 = 1;
  while (n2 < ns) n2 <<= 1;
  for (int i = ns + tid; i < n2; i += kThreads)
    ent[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
  __syncthreads();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < n2; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const uint4 x = ent[i], y = ent[j];
          const bool up = (i & size) == 0;
          if (up ? key_less(y, x, order) : key_less(x, y, order)) {
            ent[i] = y;
            ent[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // 5. The beam threshold over the slots' least finite cost, and the
  // outputs.
  float slot_min = INFINITY;
  for (int j = tid; j < ns; j += kThreads) {
    const float c = lane_cost(a, base + ent[j].w);
    if (isfinite(c)) slot_min = fminf(slot_min, c);
  }
  slot_min = block_min(slot_min, 0, warp_min, warp_nan, &min_s);
  const bool any_finite = slot_min < INFINITY;
  const float cutoff = any_finite ? __fadd_rn(slot_min, a.beam) : 0.0f;
  const size_t out = row * a.k;
  for (int j = tid; j < a.k; j += kThreads) {
    int state = -1, lm = 0, prev = 0, w0 = 0, w1 = 0;
    float cost = INFINITY;
    if (j < ns) {
      const size_t i = base + ent[j].w;
      const float c = lane_cost(a, i);
      const bool valid = isfinite(c);
      if (valid && a.lm) lm = a.lm[i];
      if (valid && any_finite && c <= cutoff) {
        state = a.state[i];
        cost = c;
        prev = a.tok[i];
        w0 = a.olab2[i];
        w1 = a.olabel[i];
      }
    }
    a.o_states[out + j] = state;
    a.o_lms[out + j] = lm;
    a.o_costs[out + j] = cost;
    a.o_prev[out + j] = prev;
    a.o_words[2 * (out + j)] = w0;
    a.o_words[2 * (out + j) + 1] = w1;
  }
  if (tid == 0) {
    a.demand[row] = demand_s;
    if (a.overflow) a.overflow[row] = demand_s > a.c2 ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// table: rows * 2 * (1 << log2cap) uint64 (set to all ones here, with one
// memset on the stream), groups: rows * e int32, cands: rows * e * 4
// int32; 1 <= k <= 8192, (1 << log2cap) > e; c2 = 0 (the classic sorts)
// or K <= c2 < e (select_compact), and then overflow is rows bytes.
int catears_frame_select(const void* state, const void* lm, const void* cost,
                         const void* w1, const void* w2, const void* tok,
                         const void* olab2, const void* olabel,
                         void* o_states, void* o_lms, void* o_costs,
                         void* o_prev, void* o_words, void* demand,
                         void* overflow, void* table, void* groups,
                         void* cands, int rows, int e, int k, int c2,
                         int log2cap, float beam, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t table_bytes = sizeof(unsigned long long) * 2 *
                             static_cast<size_t>(rows) * (size_t{1} << log2cap);
  cudaError_t err = cudaMemsetAsync(table, 0xFF, table_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int kp = 1;
  while (kp < k) kp <<= 1;
  const size_t smem = sizeof(uint4) * static_cast<size_t>(kp);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(frame_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Select a{static_cast<const int*>(state),
                 static_cast<const int*>(lm),
                 static_cast<const float*>(cost),
                 static_cast<const float*>(w1),
                 static_cast<const float*>(w2),
                 static_cast<const int*>(tok),
                 static_cast<const int*>(olab2),
                 static_cast<const int*>(olabel),
                 static_cast<int*>(o_states),
                 static_cast<int*>(o_lms),
                 static_cast<float*>(o_costs),
                 static_cast<int*>(o_prev),
                 static_cast<int*>(o_words),
                 static_cast<int*>(demand),
                 static_cast<unsigned char*>(overflow),
                 static_cast<unsigned long long*>(table),
                 static_cast<int*>(groups),
                 static_cast<uint4*>(cands),
                 e, k, c2, log2cap, beam};
  frame_select_kernel<<<rows, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
