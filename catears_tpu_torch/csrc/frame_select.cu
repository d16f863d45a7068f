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
// One thread-block cluster of C CTAs (8, or 16 where the table needs it)
// per row; CTA r of a cluster owns a contiguous 1/C of the row's lanes and
// a 1/C slice of the row's group table, an open-addressing table of cap =
// 2^log2cap 16-byte slots (key (state, lm), winner): slot h lives in CTA
// h >> (log2cap - log2C).  Every reduction across the cluster is a
// partial in each CTA's shared memory that the peers read over
// distributed shared memory (DSMEM) after a cluster.sync():
//   1. each CTA clears its own table slice;
//   2. each CTA streams its lanes once (coalesced): the min over every
//      lane's cost (carrying NaN), and each lane with state <
//      SENTINEL_STATE is routed to the CTA that owns its group's home
//      slot: (lane, cost bits) stored into that CTA's inbox over DSMEM,
//      at a place this CTA counts itself (no remote atomic).  Then each
//      CTA claims the lanes routed to it: a 64-bit CAS on the key, then
//      the winner lowered to (order-preserving cost bits << 32 | lane) by
//      64-bit CASes: a min, so the winner does not depend on the order of
//      the atomics.  Linear probing runs on from one CTA's slice into the
//      next (and wraps), over DSMEM, so a row whose keys all hash into one
//      slice still finds room: the table has more slots than lanes; a
//      lane whose inbox segment is full is claimed the same way by the
//      CTA that streamed it.  (Measured on the H100: a 64-bit atomicMin
//      through DSMEM loses updates, so none is used; and remote atomics
//      cost a DSMEM round trip each, local ones far less, hence the
//      routing.)
//   3. each CTA compacts its slice's candidates (the winners below +inf,
//      c2 = 0; the survivors, c2 > 0) in place into a dense list of keys
//      (cost bits, state, lm, lane), counts demand (the survivors), and
//      takes the AND and the OR of the keys' words;
//   4. radix selects, 8 bits a pass from the most significant digit of a
//      key order: with more than c2 survivors, the c2-th in (state, lm)
//      order; then, unless c2 == K, the K-th in (cost, state, lm) order
//      among the keys the first kept.  Each select starts past the digits
//      that every candidate shares (where the AND and the OR agree: the
//      common prefix of the least and the greatest key, which every key
//      between them has), so a beam's cost select starts where its costs
//      differ.  Each pass: every CTA histograms its own list (one shared
//      atomicAdd per distinct digit of a warp, __match_any_sync), the C
//      histograms are summed over DSMEM (four bins a load), and every CTA
//      picks the same bucket with one warp's prefix scan; a select ends as
//      soon as its bucket holds exactly the rank still wanted;
//   5. each CTA compacts its selected keys, their words in the final key
//      order, and sorts them in shared memory (each warp's 32 in
//      registers, then merged by rank; past 1,024 keys, a bitonic sort);
//   6. a key's output slot is its local rank plus, for every peer, the
//      count of the peer's keys below it: a binary search in the peer's
//      sorted list (copied into this CTA's shared memory when there is
//      room, else read over DSMEM; C lanes of a warp per key, one per
//      peer).  Each CTA writes its slots with the threshold applied (the
//      least finite slot cost is a cluster min), and a share of the slots
//      past the selection.  A last cluster.sync keeps every list alive
//      until the peers are done with it.
//
// Table storage, a function of the shape alone (decode/beam.py::
// select_geometry): a slice of at most kSliceBytes = 128 KiB (cap <=
// 65,536 slots at C = 8, cap <= 131,072 at C = 16, i.e. E up to about 98k
// lanes) lives in the CTA's shared memory beside a 64 KiB inbox; a
// larger table keeps the same slices in global scratch ([B, cap] slots,
// cleared by the kernel itself, no memset; every lane claims there at
// once with global atomics), and the sort then runs in a shared buffer of
// next_pow2(min(K, slice)) keys.  There a row's table is sized to the row
// (decode/beam.py::select_row_log2cap): each CTA first counts its live
// lanes (state < SENTINEL_STATE), one cluster barrier sums them, and the
// row clears, probes, compacts and selects over the least power of two
// above 4/3 of that count (at least C slots, at most the shape's cap), the
// first slots of its [cap] row.  Where the groups land changes with the
// table's size; the winners, and so the outputs, do not.
//
// Rows whose frame is invalid (row_valid[row] == 0, given a row_valid)
// do no work: the cluster writes the outputs of a row whose every lane is
// dead (states -1, lms 0, costs +inf, prev_slot 0, words 0, demand 0,
// overflow 0) and leaves before any barrier or DSMEM access; every CTA of
// the cluster reads the same flag, so the exit is uniform.
//
// What bounds it on the H100 (3.35 TB/s): bytes.  Each lane's state, cost
// (and lm, w1, w2) read once, 8-20 B; the K winners' payloads and the [B,
// K] outputs: about 2.5 us at the bench's 16 x 38,912 lanes.  At B = 16
// and C = 8 the 128 clusters' CTAs cover 128 of the 132 SMs; what is left
// above the bound is latency: the claims' CAS chains, about ten cluster
// barriers a launch, a cluster barrier and a DSMEM read per radix pass.
//
// With a stamp buffer ([B, kStamps] int64), CTA 0 of each cluster writes
// %globaltimer at the start and after each phase (clear, after the live
// lanes' count on the global path; route, its barrier, claim; compaction
// of the candidates; selects; compaction of the selected keys; sort; the
// cluster's counts with the peers' lists copied; rank and write), then
// its candidates, its selected keys, the row's table slots (0 for a row
// whose frame is invalid: its phases take no time) and, last, the radix
// passes the row ran; the main path passes none.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "a warp reads the block's per-warp counts");
constexpr int kBatch = 4;  // lanes a thread loads before it claims them
constexpr int kSentinel = 1 << 30;  // decode/beam.py SENTINEL_STATE
constexpr int kMaxCluster = 16;
constexpr int kStamps = 16;
constexpr int kSliceBytes = 128 * 1024;  // the largest shared table slice
constexpr int kInboxBytes = 64 * 1024;  // a CTA's inbox: 2^13 routed lanes
constexpr int kMaxDynamicSmem = kSliceBytes + kInboxBytes;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned kOrdPosInf = 0xFF800000u;  // ordered(+inf)
constexpr unsigned kOrdNegInf = 0x007FFFFFu;  // ordered(-inf)
constexpr unsigned kSign = 0x80000000u;

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
  unsigned char* overflow;  // [B], or null (c2 == 0)
  ulonglong2* table;        // [B, cap] (key, winner) slots, or null (shared)
  long long* stamps;        // [B, kStamps], or null
  const unsigned char* row_valid;  // [B] bools, or null (every row valid)
  int e, k, c2, log2cap, log2c;
  float beam;
};

// A candidate's key is the uint4 (x cost bits, y state, z lm, w lane).
// Its words under a key order, most significant first: (cost, state, lm),
// or with kGroup (state, lm, cost): (state, lm) is unique among winners.
template <bool kGroup>
__device__ __forceinline__ uint3 in_order(const uint4& c) {
  return kGroup ? make_uint3(c.y, c.z, c.x) : make_uint3(c.x, c.y, c.z);
}

__device__ __forceinline__ unsigned word(const uint3& c, int i) {
  return i == 0 ? c.x : (i == 1 ? c.y : c.z);
}

// The keys a radix select kept: under its order, those whose words masked
// by m are at most p.  `on` false keeps every key.
struct Cut {
  unsigned p[3], m[3];
  bool on;
};

template <bool kGroup>
__device__ __forceinline__ bool within(const uint4& c, const Cut& f) {
  if (!f.on) return true;
  const uint3 o = in_order<kGroup>(c);
  unsigned a = o.x & f.m[0];
  if (a != f.p[0]) return a < f.p[0];
  a = o.y & f.m[1];
  if (a != f.p[1]) return a < f.p[1];
  return (o.z & f.m[2]) <= f.p[2];
}

// Lexicographic order of the sorted lists' entries (words already in the
// final key order, the lane last and not compared).
__device__ __forceinline__ bool less3(const uint4& x, const uint4& y) {
  if (x.x != y.x) return x.x < y.x;
  if (x.y != y.y) return x.y < y.y;
  return x.z < y.z;
}

// Order-preserving cost bits: -0.0 == +0.0, every NaN after +inf.
__device__ __forceinline__ unsigned ordered(float c) {
  unsigned u = __float_as_uint(c);
  if (c == 0.0f) u = 0u;
  if (c != c) u = 0x7FC00000u;
  return (u & kSign) ? ~u : (u | kSign);
}

// The float of ordered bits (a -0.0 comes back as +0.0).
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & kSign) ? (u & ~kSign) : ~u);
}

__device__ __forceinline__ bool finite_key(unsigned ck) {
  return ck > kOrdNegInf && ck < kOrdPosInf;
}

// A slot's candidate key: (cost bits, state, lm, lane).
__device__ __forceinline__ uint4 slot_key(const ulonglong2& s) {
  return make_uint4(static_cast<unsigned>(s.y >> 32),
                    static_cast<unsigned>(s.x >> 32),
                    static_cast<unsigned>(s.x) ^ kSign,
                    static_cast<unsigned>(s.y));
}

// Slot i of this CTA's slice as (key, winner).  A slice in global memory
// is read past L1: the peers' claims were made at L2.
template <bool kShared>
__device__ __forceinline__ ulonglong2 load_slot(const ulonglong2* slots,
                                                int i) {
  if constexpr (kShared) {
    return slots[i];
  } else {
    return __ldcg(slots + i);
  }
}

// What each CTA publishes to its peers (read over DSMEM after a
// cluster.sync); each field is written before one barrier and read after
// it, never written again.
struct Partials {
  int n_live;        // live lanes in the CTA's range (global table only)
  unsigned min_ord;  // the least ordered lane cost (NaN lanes aside)
  int nan;           // a lane's cost is NaN
  int demand;        // survivors in the slice
  int n_cand;        // candidates in the slice
  unsigned and_w[2][3], or_w[2][3];  // of the candidates' key words (x, y,
                                     // z), before and after the c2 select
  int n_local;       // selected keys in the sorted list
  unsigned slot_min;  // the least finite ordered cost among them
};

struct Shared {
  Partials part;
  alignas(16) unsigned hist[2][256];  // by pass parity: a peer may still
                                      // read the other
  alignas(16) unsigned tot[256];
  unsigned cursor[kMaxCluster];  // lanes routed to each CTA's inbox
  int in_start[kMaxCluster];  // where each CTA's lanes start among those
                              // routed to this one
  int n_routed;               // lanes routed to this CTA
  unsigned wsum[2][kWarps];
  int n_of[kMaxCluster];  // each CTA's n_local
  int at_of[kMaxCluster];  // where a peer's list is copied to
  unsigned pre[3], msk[3];
  int d0, rank, done, passes;
  // cluster totals
  unsigned min_ord, slot_min, and_w[3], or_w[3];
  int n_live, nan, demand, n_cand, n_sel;
};

// CTA 0's time after a phase that ends in a cluster.sync (or, with the
// barrier taken only when stamping, in this CTA's own threads).
__device__ __forceinline__ void stamp(const Select& a, size_t row, int at,
                                      bool leader) {
  if (a.stamps && leader) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[row * kStamps + at] = static_cast<long long>(t);
  }
}

// Output slot j (of [B, K]) empty: state -1, lm 0, cost +inf, words 0.
__device__ __forceinline__ void empty_slot(const Select& a, size_t j) {
  a.o_states[j] = -1;
  a.o_lms[j] = 0;
  a.o_costs[j] = INFINITY;
  a.o_prev[j] = 0;
  a.o_words[2 * j] = 0;
  a.o_words[2 * j + 1] = 0;
}

__device__ __forceinline__ float lane_cost(const Select& a, size_t i) {
  float c = a.cost[i];
  if (a.w1) c = __fadd_rn(c, a.w1[i]);
  if (a.w2) c = __fadd_rn(c, a.w2[i]);
  return c;
}

// Is a winner of ordered cost ck a survivor: finite and <= min + beam?
// cut_ord: ordered(min + beam); cut_nan: it is NaN.
__device__ __forceinline__ bool survives(unsigned ck, unsigned cut_ord,
                                         bool cut_nan) {
  return !cut_nan && finite_key(ck) && ck <= cut_ord;
}

// A 64-bit CAS at a shared::cta (local) or shared::cluster address;
// returns what it held.  Explicit state spaces: through a generic pointer
// the compiler's shared-memory atomics ran an order of magnitude slower.
__device__ __forceinline__ unsigned long long cas_local(
    unsigned addr, unsigned long long expect, unsigned long long value) {
  unsigned long long seen;
  asm volatile("atom.shared::cta.cas.b64 %0, [%1], %2, %3;"
               : "=l"(seen)
               : "r"(addr), "l"(expect), "l"(value)
               : "memory");
  return seen;
}

__device__ __forceinline__ unsigned long long cas_cluster(
    unsigned addr, unsigned long long expect, unsigned long long value) {
  unsigned long long seen;
  asm volatile(
      "atom.relaxed.cluster.shared::cluster.cas.b64 %0, [%1], %2, %3;"
      : "=l"(seen)
      : "r"(addr), "l"(expect), "l"(value)
      : "memory");
  return seen;
}

// The claim of group `key` with winner candidate v, from home slot h of
// the cluster's shared table, by CTA r: a 64-bit CAS on the key of each
// slot of the probe (in this CTA's slice a local atomic; in a peer's
// through the shared::cluster address of the same offset there: the
// probe runs on into the next CTA's slice and round the table), then the
// winner lowered to v by a loop of 64-bit CASes.  (A 64-bit atomic min
// on DSMEM loses updates on the H100, so none is used.)  own_base: the
// shared::cta address of this CTA's slice.
__device__ __forceinline__ void claim_shared(unsigned own_base, int r,
                                             int shift_owner, int slice,
                                             unsigned long long cap,
                                             unsigned long long h,
                                             unsigned long long key,
                                             unsigned long long v) {
  while (true) {
    const int q = static_cast<int>(h >> shift_owner);
    unsigned addr = own_base + 16u * static_cast<unsigned>(h & (slice - 1));
    const bool local = q == r;
    if (!local) {
      asm("mapa.shared::cluster.u32 %0, %1, %2;"
          : "=r"(addr)
          : "r"(addr), "r"(static_cast<unsigned>(q)));
    }
    const unsigned long long prev = local ? cas_local(addr, kEmpty, key)
                                          : cas_cluster(addr, kEmpty, key);
    if (prev == kEmpty || prev == key) {
      unsigned long long old = kEmpty;  // the winner's first value
      while (v < old) {
        const unsigned long long seen =
            local ? cas_local(addr + 8u, old, v)
                  : cas_cluster(addr + 8u, old, v);
        if (seen == old) return;
        old = seen;
      }
      return;
    }
    h = (h + 1) & (cap - 1);
  }
}

// Warp 0 folds the C peers' AND and OR (`which`: before or after the c2
// select) into sh.and_w / sh.or_w.  Call after a cluster.sync; a
// __syncthreads follows.
__device__ void gather_and_or(cg::cluster_group& cluster, Shared& sh,
                              int which, int nc) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    unsigned an[3] = {~0u, ~0u, ~0u}, on[3] = {0u, 0u, 0u};
    if (lane < nc) {
      const Partials* p = cluster.map_shared_rank(&sh.part, lane);
      for (int w = 0; w < 3; ++w) {
        an[w] = p->and_w[which][w];
        on[w] = p->or_w[which][w];
      }
    }
    for (int w = 0; w < 3; ++w) {
      an[w] = __reduce_and_sync(0xFFFFFFFFu, an[w]);
      on[w] = __reduce_or_sync(0xFFFFFFFFu, on[w]);
    }
    if (lane == 0) {
      for (int w = 0; w < 3; ++w) {
        sh.and_w[w] = an[w];
        sh.or_w[w] = on[w];
      }
    }
  }
}

// Entry i of a CTA's dense candidate list (in place over its slice).  In
// global memory it is read past L1, as the slots are.
template <bool kShared>
__device__ __forceinline__ uint4 load_key(const uint4* list, int i) {
  if constexpr (kShared) {
    return list[i];
  } else {
    return __ldcg(list + i);
  }
}

// Block-wide, for one chunk of a compaction in order: this thread's place
// among the chunk's selected entries (`sel`), and their count (`total`).
// wsum: the chunk's per-warp counts; chunks alternate two buffers, so
// that one barrier a chunk does, and the barrier also ends every read of
// the chunk before any of its entries is written.
__device__ __forceinline__ int chunk_place(bool sel, unsigned* wsum,
                                           int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, sel);
  if (lane == 0) wsum[warp] = __popc(ballot);
  __syncthreads();
  const unsigned n_w = wsum[lane];  // kWarps == 32: one count a lane
  total = static_cast<int>(__reduce_add_sync(0xFFFFFFFFu, n_w));
  return static_cast<int>(
             __reduce_add_sync(0xFFFFFFFFu, lane < warp ? n_w : 0u)) +
         __popc(ballot & ((1u << lane) - 1u));
}

// The CTA's AND and OR of the key words of its candidates that cut `in`
// (group order) keeps, folded into this CTA's partials p_and / p_or.
template <bool kShared>
__device__ void and_or(const uint4* cand, int n_c, const Cut& in,
                       unsigned* p_and, unsigned* p_or) {
  unsigned an[3] = {~0u, ~0u, ~0u}, on[3] = {0u, 0u, 0u};
  for (int i = threadIdx.x; i < n_c; i += kThreads) {
    const uint4 c = load_key<kShared>(cand, i);
    if (!within<true>(c, in)) continue;
    an[0] &= c.x;
    an[1] &= c.y;
    an[2] &= c.z;
    on[0] |= c.x;
    on[1] |= c.y;
    on[2] |= c.z;
  }
  for (int w = 0; w < 3; ++w) {
    an[w] = __reduce_and_sync(0xFFFFFFFFu, an[w]);
    on[w] = __reduce_or_sync(0xFFFFFFFFu, on[w]);
  }
  if ((threadIdx.x & 31) == 0) {
    for (int w = 0; w < 3; ++w) {
      atomicAnd(p_and + w, an[w]);
      atomicOr(p_or + w, on[w]);
    }
  }
}

// The cut that keeps exactly the `want` least keys, under the order
// kGroup picks, of the candidates that cut `in` (group order) keeps
// (there are more than `want` of them, and their keys under the order
// are unique; sh.and_w / or_w hold their AND and OR).  Each CTA reads its
// dense candidate list cand[0, n_c).  Cluster-wide; every thread of
// every CTA gets the cut.
template <bool kShared, bool kGroup>
__device__ Cut radix_select(cg::cluster_group& cluster, Shared& sh,
                            const uint4* cand, int n_c, int nc, int want,
                            const Cut& in) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    // The digits every candidate shares: fixed before the first pass.
    const uint3 an = in_order<kGroup>(
        make_uint4(sh.and_w[0], sh.and_w[1], sh.and_w[2], 0u));
    const uint3 on = in_order<kGroup>(
        make_uint4(sh.or_w[0], sh.or_w[1], sh.or_w[2], 0u));
    int d = 0;
    for (int i = 0; i < 3; ++i) sh.pre[i] = sh.msk[i] = 0u;
    for (; d < 12; ++d) {
      const int i = d >> 2, shift = 24 - 8 * (d & 3);
      if (((word(an, i) ^ word(on, i)) >> shift) & 0xFFu) break;
      sh.pre[i] |= word(an, i) & (0xFFu << shift);
      sh.msk[i] |= 0xFFu << shift;
    }
    sh.rank = want;
    sh.d0 = d;  // the first digit to search (< 12: the keys differ)
    sh.done = 0;
  }
  __syncthreads();
  for (int d = sh.d0; d < 12; ++d) {
    const int i = d >> 2, shift = 24 - 8 * (d & 3);
    const int buf = sh.passes & 1;
    const unsigned p0 = sh.pre[0], p1 = sh.pre[1], p2 = sh.pre[2];
    const unsigned m0 = sh.msk[0], m1 = sh.msk[1], m2 = sh.msk[2];
    for (int b0 = 0; b0 < n_c; b0 += kThreads) {
      const int s = b0 + tid;
      int digit = -1;
      if (s < n_c) {
        const uint4 c = load_key<kShared>(cand, s);
        const uint3 o = in_order<kGroup>(c);
        if (((o.x ^ p0) & m0) == 0 && ((o.y ^ p1) & m1) == 0 &&
            ((o.z ^ p2) & m2) == 0 && within<true>(c, in))
          digit = static_cast<int>((word(o, i) >> shift) & 0xFFu);
      }
      const unsigned same = __match_any_sync(0xFFFFFFFFu, digit);
      if (digit >= 0 && (tid & 31) == __ffs(same) - 1)
        atomicAdd(&sh.hist[buf][digit], __popc(same));
    }
    cluster.sync();
    if (tid < 64) {  // four bins a load
      uint4 t = make_uint4(0u, 0u, 0u, 0u);
      for (int p = 0; p < nc; ++p) {
        const uint4 h = reinterpret_cast<const uint4*>(
            cluster.map_shared_rank(&sh.hist[buf][0], p))[tid];
        t = make_uint4(t.x + h.x, t.y + h.y, t.z + h.z, t.w + h.w);
      }
      reinterpret_cast<uint4*>(sh.tot)[tid] = t;
    }
    // Every peer read the other buffer before this pass's barrier.
    if (tid < 256) sh.hist[buf ^ 1][tid] = 0u;
    __syncthreads();
    if (tid < 32) {
      unsigned v[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = sh.tot[8 * tid + j];
        s += v[j];
      }
      unsigned incl = s;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned up = __shfl_up_sync(0xFFFFFFFFu, incl, off);
        if (tid >= off) incl += up;
      }
      const unsigned rank = static_cast<unsigned>(sh.rank);
      const unsigned hit = __ballot_sync(0xFFFFFFFFu, incl >= rank);
      if (tid == __ffs(hit) - 1) {
        unsigned r = rank - (incl - s), held = 0u;
        int bucket = 0;
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // the first bin that holds rank r
          if (!found) {
            if (v[j] >= r) {
              bucket = j;
              held = v[j];
              found = true;
            } else {
              r -= v[j];
            }
          }
        }
        sh.pre[i] |= static_cast<unsigned>(8 * tid + bucket) << shift;
        sh.msk[i] |= 0xFFu << shift;
        sh.rank = static_cast<int>(r);
        sh.done = held == r;
      }
      if (tid == 0) ++sh.passes;
    }
    __syncthreads();
    if (sh.done) break;  // block-uniform: read after a barrier
  }
  Cut out;
  for (int j = 0; j < 3; ++j) {
    out.p[j] = sh.pre[j];
    out.m[j] = sh.msk[j];
  }
  out.on = true;
  __syncthreads();  // before the scratch is used again
  return out;
}

// The count of entries below x in a sorted list of n (x is not in it).
__device__ __forceinline__ int lower_bound(const uint4* list, int n,
                                           const uint4& x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (less3(list[mid], x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Sorts list[0, n) in place, n <= kThreads: thread i takes entry i; each
// warp sorts its 32 in registers (a bitonic network of shuffles); then
// an entry's place is the sum over the warps' sorted runs of the run's
// entries below it (each other run read across the warp's lanes and
// searched by shuffles).
__device__ void sort_by_runs(uint4* list, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int runs = (n + 31) >> 5;
  if (warp >= runs) {  // no entry: only the barriers
    __syncthreads();
    __syncthreads();
    __syncthreads();
    return;
  }
  uint4 x = tid < n ? list[tid] : make_uint4(~0u, ~0u, ~0u, ~0u);
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      uint4 y;
      y.x = __shfl_xor_sync(0xFFFFFFFFu, x.x, stride);
      y.y = __shfl_xor_sync(0xFFFFFFFFu, x.y, stride);
      y.z = __shfl_xor_sync(0xFFFFFFFFu, x.z, stride);
      y.w = __shfl_xor_sync(0xFFFFFFFFu, x.w, stride);
      // The lower lane of a pair keeps the lesser entry in an ascending
      // run ((lane & size) == 0), the greater in a descending one.
      const bool keep_less = ((lane & stride) == 0) == ((lane & size) == 0);
      if (keep_less ? less3(y, x) : less3(x, y)) x = y;
    }
  }
  if (tid < n) list[tid] = x;  // the warp's sorted run
  __syncthreads();
  int place = lane;
  for (int w = 0; w < runs; ++w) {
    if (w == warp) continue;
    // Run w across the warp's lanes (pads last); the count of its entries
    // below x by a binary search of shuffles.
    const uint4 y = 32 * w + lane < n ? list[32 * w + lane]
                                      : make_uint4(~0u, ~0u, ~0u, ~0u);
    int below = 0;
    for (int step = 16; step > 0; step >>= 1) {
      const int at = below + step - 1;
      const uint4 v = make_uint4(__shfl_sync(0xFFFFFFFFu, y.x, at),
                                 __shfl_sync(0xFFFFFFFFu, y.y, at),
                                 __shfl_sync(0xFFFFFFFFu, y.z, at), 0u);
      if (less3(v, x)) below += step;
    }
    const uint4 v = make_uint4(__shfl_sync(0xFFFFFFFFu, y.x, below),
                               __shfl_sync(0xFFFFFFFFu, y.y, below),
                               __shfl_sync(0xFFFFFFFFu, y.z, below), 0u);
    place += below + (less3(v, x) ? 1 : 0);
  }
  __syncthreads();
  if (tid < n) list[place] = x;
  __syncthreads();
}

template <bool kSharedTable>
__global__ void __launch_bounds__(kThreads, 1)
    frame_select_kernel(Select a) {
  // The table slice (kSharedTable), later the sorted list in place and
  // the peers' lists; or the sort buffer alone.
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const int nc = 1 << a.log2c;
  const int r = static_cast<int>(cluster.block_rank());
  const size_t row = blockIdx.x >> a.log2c;
  const bool leader = r == 0 && tid == 0;
  const size_t base = row * a.e;
  const size_t out = row * a.k;
  // This CTA's lanes.
  const int per = (a.e + nc - 1) / nc;
  const int lo = min(a.e, r * per), hi = min(a.e, lo + per);
  stamp(a, row, 0, leader);

  // 0. A row whose frame is invalid: a dead row's outputs, and out.
  if (a.row_valid && !a.row_valid[row]) {
    for (int j = r * kThreads + tid; j < a.k; j += nc * kThreads)
      empty_slot(a, out + j);
    if (leader) {
      a.demand[row] = 0;
      if (a.overflow) a.overflow[row] = 0;
      for (int at = 1; at <= 10; ++at) stamp(a, row, at, true);
      if (a.stamps) {
        a.stamps[row * kStamps + 11] = 0;
        a.stamps[row * kStamps + 12] = 0;
        a.stamps[row * kStamps + 13] = 0;
        a.stamps[row * kStamps + kStamps - 1] = 0;
      }
    }
    return;
  }

  // The row's table: the shape's, or on the global path the least power
  // of two above 4/3 of the row's live lanes (at least C slots, at most
  // the shape's cap: decode/beam.py::select_row_log2cap).
  int log2cap = a.log2cap;
  if (!kSharedTable) {
    int n = 0;
    for (int i = lo + tid; i < hi; i += kThreads)
      n += a.state[base + i] < kSentinel;
    n = __reduce_add_sync(0xFFFFFFFFu, n);
    if (lane_id == 0) sh.wsum[0][warp] = static_cast<unsigned>(n);
    __syncthreads();
    if (tid < 32) {
      n = static_cast<int>(
          __reduce_add_sync(0xFFFFFFFFu, sh.wsum[0][lane_id]));
      if (lane_id == 0) sh.part.n_live = n;
    }
    cluster.sync();
    if (tid < 32) {
      n = lane_id < nc ? cluster.map_shared_rank(&sh.part, lane_id)->n_live
                       : 0;
      n = __reduce_add_sync(0xFFFFFFFFu, n);
      if (lane_id == 0) sh.n_live = n;
    }
    __syncthreads();
    const int need = sh.n_live + sh.n_live / 3;  // < 2^31: e < 2^30
    log2cap = min(a.log2cap, max(a.log2c, 32 - __clz(need)));
  }
  const unsigned long long cap = 1ull << log2cap;
  const int shift_owner = log2cap - a.log2c;
  const int slice = 1 << shift_owner;
  ulonglong2* const own_smem = reinterpret_cast<ulonglong2*>(dyn);
  // The row's global table (its first cap of the shape's slots).
  ulonglong2* const row_table =
      kSharedTable ? nullptr : a.table + (row << a.log2cap);
  ulonglong2* const own =
      kSharedTable ? own_smem : row_table + static_cast<size_t>(r) * slice;
  const unsigned own_base =
      static_cast<unsigned>(__cvta_generic_to_shared(own_smem));
  uint4* const list = reinterpret_cast<uint4*>(dyn);
  // The shared path's inbox, behind the slice: C segments of `seg` lanes
  // (lane, cost bits), segment p filled by CTA p.
  const int log2seg = 13 - a.log2c;  // kInboxBytes / 8 = 2^13 lanes
  const int seg = 1 << log2seg;
  uint2* const inbox = reinterpret_cast<uint2*>(dyn + 16 * slice);
  // The entries the dynamic shared memory holds: on the global path the
  // sort buffer, sized by the launch from the shape's slice.
  int list_room = slice + kInboxBytes / 16;
  const int shape_slice = 1 << (a.log2cap - a.log2c);
  if (!kSharedTable) {
    list_room = 1;
    while (list_room < min(a.k, shape_slice)) list_room <<= 1;
  }

  // 1. Clear the slice, the histograms and the partials.
  for (int i = tid; i < slice; i += kThreads)
    own[i] = make_ulonglong2(kEmpty, kEmpty);
  for (int i = tid; i < 512; i += kThreads) (&sh.hist[0][0])[i] = 0u;
  if (tid == 0) {
    sh.part.min_ord = kOrdPosInf;
    sh.part.nan = sh.part.demand = sh.part.n_cand = sh.part.n_local = 0;
    sh.part.slot_min = kOrdPosInf;
    for (int j = 0; j < 2; ++j) {
      for (int w = 0; w < 3; ++w) {
        sh.part.and_w[j][w] = ~0u;
        sh.part.or_w[j][w] = 0u;
      }
    }
    sh.passes = 0;
  }
  if (tid < kMaxCluster) sh.cursor[tid] = 0u;
  cluster.sync();
  stamp(a, row, 1, leader);

  // 2. Stream this CTA's lanes, kBatch a thread at a time (their loads in
  // flight together): the min over their costs, and each live lane's
  // claim.  Shared table: a lane is routed to the CTA that owns its home
  // slot, written into that CTA's inbox (segment r, at a place counted
  // here: DSMEM stores, no remote atomics), and that CTA claims it in its
  // own slice; a lane that finds its segment full is claimed at once by
  // this CTA.  Global table: every lane is claimed at once.
  {
    unsigned mn = kOrdPosInf;
    int nan = 0;
    for (int b0 = lo; b0 < hi; b0 += kBatch * kThreads) {
      float c[kBatch];
      int s[kBatch];
      unsigned l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = b0 + tid + u * kThreads;
        s[u] = kSentinel;
        c[u] = INFINITY;
        l[u] = 0u;
        if (i < hi) {
          c[u] = lane_cost(a, base + i);
          s[u] = a.state[base + i];
          if (a.lm) l[u] = static_cast<unsigned>(a.lm[base + i]);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned lane = static_cast<unsigned>(b0 + tid + u * kThreads);
        const unsigned ck = ordered(c[u]);
        if (c[u] != c[u]) {
          nan = 1;
        } else {
          mn = min(mn, ck);
        }
        const bool live = s[u] < kSentinel;
        const unsigned long long key =
            (static_cast<unsigned long long>(static_cast<unsigned>(s[u]) ^
                                             kSign) << 32) | l[u];
        const unsigned long long v =
            (static_cast<unsigned long long>(ck) << 32) | lane;
        unsigned long long h =
            (key * 0x9E3779B97F4A7C15ull) >> (64 - log2cap);
        if (kSharedTable) {
          const int q = live ? static_cast<int>(h >> shift_owner) : -1;
          const unsigned same = __match_any_sync(0xFFFFFFFFu, q);
          const int first = __ffs(same) - 1;
          unsigned at = 0u;
          if (q >= 0 && lane_id == first) at = atomicAdd(&sh.cursor[q],
                                                         __popc(same));
          at = __shfl_sync(0xFFFFFFFFu, at, first) +
               __popc(same & ((1u << lane_id) - 1u));
          if (live) {
            if (at < static_cast<unsigned>(seg)) {
              cluster.map_shared_rank(inbox, q)[r * seg + at] =
                  make_uint2(lane, ck);
            } else {
              claim_shared(own_base, r, shift_owner, slice, cap, h, key, v);
            }
          }
        } else if (live) {
          ulonglong2* slot;
          while (true) {
            slot = row_table + h;
            const unsigned long long prev = atomicCAS(&slot->x, kEmpty, key);
            if (prev == kEmpty || prev == key) break;
            h = (h + 1) & (cap - 1);
          }
          atomicMin(&slot->y, v);
        }
      }
    }
    mn = __reduce_min_sync(0xFFFFFFFFu, mn);
    nan = __reduce_or_sync(0xFFFFFFFFu, nan);
    if (lane_id == 0) {
      atomicMin(&sh.part.min_ord, mn);
      if (nan) atomicOr(&sh.part.nan, 1);
    }
  }
  if (a.stamps) __syncthreads();
  stamp(a, row, 2, leader);
  cluster.sync();
  stamp(a, row, 3, leader);
  if (kSharedTable) {
    // This CTA's inbox: the lanes each CTA routed here, claimed in this
    // slice (a probe may run on into the next CTA's).
    if (tid < 32) {  // each segment's lanes, and where they start
      const int n = lane_id < nc
          ? min(seg, static_cast<int>(
                cluster.map_shared_rank(sh.cursor, lane_id)[r]))
          : 0;
      int at = n;
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xFFFFFFFFu, at, off);
        if (lane_id >= off) at += up;
      }
      if (lane_id < nc) sh.in_start[lane_id] = at - n;
      if (lane_id == 31) sh.n_routed = at;
    }
    __syncthreads();
    const int n_routed = sh.n_routed;
    for (int b0 = 0; b0 < n_routed; b0 += kBatch * kThreads) {
      uint2 in[kBatch];
      int s[kBatch];
      unsigned l[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = b0 + tid + u * kThreads;  // the j-th lane routed here
        s[u] = kSentinel;
        l[u] = 0u;
        if (j < n_routed) {
          int p = 0;
          for (int q = 1; q < nc; ++q)
            if (sh.in_start[q] <= j) p = q;
          in[u] = inbox[(p << log2seg) + j - sh.in_start[p]];
          s[u] = a.state[base + in[u].x];
          if (a.lm) l[u] = static_cast<unsigned>(a.lm[base + in[u].x]);
        }
      }
      unsigned long long key[kBatch], home[kBatch], v[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        live[u] = s[u] < kSentinel;
        key[u] = (static_cast<unsigned long long>(static_cast<unsigned>(s[u]) ^
                                                  kSign) << 32) | l[u];
        home[u] = (key[u] * 0x9E3779B97F4A7C15ull) >> (64 - log2cap);
        v[u] = (static_cast<unsigned long long>(in[u].y) << 32) | in[u].x;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (live[u])
          claim_shared(own_base, r, shift_owner, slice, cap, home[u], key[u],
                       v[u]);
      }
    }
    cluster.sync();
  }
  stamp(a, row, 4, leader);

  // 3. The cut min + beam; this slice's demand, candidates, AND and OR.
  if (tid < 32) {
    unsigned mn = kOrdPosInf;
    int nan = 0;
    if (lane_id < nc) {
      const Partials* p = cluster.map_shared_rank(&sh.part, lane_id);
      mn = p->min_ord;
      nan = p->nan;
    }
    mn = __reduce_min_sync(0xFFFFFFFFu, mn);
    nan = __reduce_or_sync(0xFFFFFFFFu, nan);
    if (lane_id == 0) {
      sh.min_ord = mn;
      sh.nan = nan;
    }
  }
  __syncthreads();
  const float demand_cut =
      sh.nan ? NAN : __fadd_rn(unordered(sh.min_ord), a.beam);
  const bool cut_nan = demand_cut != demand_cut;
  const unsigned cut_ord = ordered(demand_cut);
  const int c2 = a.c2;
  // This slice's candidates compacted in slot order into a dense list of
  // keys in place at its start (a key moves to a place at or below its
  // slot; chunk_place ends a chunk's reads before its writes).
  uint4* const cand = reinterpret_cast<uint4*>(own);
  int n_c = 0;
  {
    int demand = 0;
    unsigned an[3] = {~0u, ~0u, ~0u}, on[3] = {0u, 0u, 0u};
    for (int b0 = 0, chunk = 0; b0 < slice; b0 += kThreads, ++chunk) {
      const int i = b0 + tid;
      bool take = false;
      uint4 c = make_uint4(0u, 0u, 0u, 0u);
      if (i < slice) {
        const ulonglong2 s = load_slot<kSharedTable>(own, i);
        if (s.x != kEmpty) {
          c = slot_key(s);
          const bool kept = survives(c.x, cut_ord, cut_nan);
          demand += kept;
          take = c2 ? kept : c.x < kOrdPosInf;
        }
      }
      if (take) {
        an[0] &= c.x;
        an[1] &= c.y;
        an[2] &= c.z;
        on[0] |= c.x;
        on[1] |= c.y;
        on[2] |= c.z;
      }
      int total;
      const int at = chunk_place(take, sh.wsum[chunk & 1], total);
      if (take) cand[n_c + at] = c;
      n_c += total;
    }
    demand = __reduce_add_sync(0xFFFFFFFFu, demand);
    for (int w = 0; w < 3; ++w) {
      an[w] = __reduce_and_sync(0xFFFFFFFFu, an[w]);
      on[w] = __reduce_or_sync(0xFFFFFFFFu, on[w]);
    }
    if (lane_id == 0) {
      if (demand) atomicAdd(&sh.part.demand, demand);
      for (int w = 0; w < 3; ++w) {
        atomicAnd(&sh.part.and_w[0][w], an[w]);
        atomicOr(&sh.part.or_w[0][w], on[w]);
      }
    }
    if (tid == 0) sh.part.n_cand = n_c;
  }
  cluster.sync();
  if (tid < 32) {
    int demand = 0, n_cand = 0;
    if (lane_id < nc) {
      const Partials* p = cluster.map_shared_rank(&sh.part, lane_id);
      demand = p->demand;
      n_cand = p->n_cand;
    }
    demand = __reduce_add_sync(0xFFFFFFFFu, demand);
    n_cand = __reduce_add_sync(0xFFFFFFFFu, n_cand);
    if (lane_id == 0) {
      sh.demand = demand;
      sh.n_cand = n_cand;
    }
  }
  gather_and_or(cluster, sh, 0, nc);
  __syncthreads();
  stamp(a, row, 5, leader);

  // 4. The radix selects: the first c2 survivors in (state, lm) order,
  // then the first K of those in (cost, state, lm) order.
  Cut first_c2, first_k;
  first_c2.on = first_k.on = false;
  const int n_cand = sh.n_cand;
  int n_in = n_cand;
  if (c2 && n_cand > c2) {
    first_c2 = radix_select<kSharedTable, true>(cluster, sh, cand, n_c, nc,
                                                c2, first_c2);
    n_in = c2;
  }
  const bool group_order = c2 && c2 <= a.k;  // c2 == K: no prune sort
  if (!group_order && n_in > a.k) {
    if (first_c2.on) {  // the AND and OR of the keys the first select kept
      and_or<kSharedTable>(cand, n_c, first_c2, sh.part.and_w[1],
                           sh.part.or_w[1]);
      cluster.sync();
      gather_and_or(cluster, sh, 1, nc);
      __syncthreads();
    }
    first_k = radix_select<kSharedTable, false>(cluster, sh, cand, n_c, nc,
                                                a.k, first_c2);
  }
  stamp(a, row, 6, leader);

  // 5. This CTA's selected keys, compacted in order with their words in
  // the final key order (in place over the candidate list, or into the
  // sort buffer), then sorted.
  const int list_cap = kSharedTable ? slice : min(a.k, shape_slice);
  int n_local = 0;
  unsigned slot_min = kOrdPosInf;
  for (int b0 = 0, chunk = 0; b0 < n_c; b0 += kThreads, ++chunk) {
    const int i = b0 + tid;
    bool sel = false;
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    if (i < n_c) {
      c = load_key<kSharedTable>(cand, i);
      sel = within<true>(c, first_c2) && within<false>(c, first_k);
    }
    int total;
    const int at = n_local + chunk_place(sel, sh.wsum[chunk & 1], total);
    if (sel) {
      if (finite_key(c.x)) slot_min = min(slot_min, c.x);
      const uint3 o = group_order ? in_order<true>(c) : in_order<false>(c);
      if (at < list_cap) list[at] = make_uint4(o.x, o.y, o.z, c.w);
    }
    n_local += total;
  }
  n_local = min(n_local, list_cap);
  slot_min = __reduce_min_sync(0xFFFFFFFFu, slot_min);
  if (lane_id == 0 && slot_min != kOrdPosInf)
    atomicMin(&sh.part.slot_min, slot_min);
  __syncthreads();
  stamp(a, row, 7, leader);
  int n2 = 1;
  while (n2 < n_local) n2 <<= 1;
  if (n_local <= kThreads) {
    sort_by_runs(list, n_local);
  } else {  // more keys than threads (K > 1,024 in few CTAs): bitonic
    for (int i = n_local + tid; i < n2; i += kThreads)
      list[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
    __syncthreads();
    for (int size = 2; size <= n2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < n2; i += kThreads) {
          const int j = i ^ stride;
          if (j > i) {
            const uint4 x = list[i], y = list[j];
            if (((i & size) == 0) == less3(y, x)) {
              list[i] = y;
              list[j] = x;
            }
          }
        }
        __syncthreads();
      }
    }
  }
  if (tid == 0) sh.part.n_local = n_local;
  stamp(a, row, 8, leader);
  cluster.sync();
  if (tid < 32) {
    int n = 0;
    unsigned m = kOrdPosInf;
    if (lane_id < nc) {
      const Partials* p = cluster.map_shared_rank(&sh.part, lane_id);
      n = p->n_local;
      m = p->slot_min;
      sh.n_of[lane_id] = n;
    }
    // Where each peer's list goes behind this CTA's: n2 + the peers'
    // keys before it.
    int at = lane_id == r ? 0 : n;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, at, off);
      if (lane_id >= off) at += up;
    }
    if (lane_id < nc) sh.at_of[lane_id] = n2 + at - (lane_id == r ? 0 : n);
    n = __reduce_add_sync(0xFFFFFFFFu, n);
    m = __reduce_min_sync(0xFFFFFFFFu, m);
    if (lane_id == 0) {
      sh.n_sel = n;
      sh.slot_min = m;
    }
  }
  __syncthreads();

  // The peers' sorted lists, copied behind this CTA's when they fit, so
  // that the searches below read local shared memory; else searched over
  // DSMEM.
  const int n_sel = sh.n_sel;
  const bool copied = n2 + n_sel - n_local <= list_room;
  if (copied) {
    for (int i = n2 + tid; i < n2 + n_sel - n_local; i += kThreads) {
      int p = 0;
      for (int q = 0; q < nc; ++q)  // the last peer whose copy starts by i
        if (q != r && sh.at_of[q] <= i) p = q;
      list[i] = cluster.map_shared_rank(list, p)[i - sh.at_of[p]];
    }
    __syncthreads();
  }
  stamp(a, row, 9, leader);

  // 6. Each key's slot: its local rank + the peers' keys below it (the C
  // lanes of a group, one per peer); the outputs with the threshold.
  const bool any_finite = sh.slot_min != kOrdPosInf;
  const float cutoff =
      any_finite ? __fadd_rn(unordered(sh.slot_min), a.beam) : 0.0f;
  const int group = 32 / nc, gid = lane_id / nc, peer = lane_id % nc;
  for (int k0 = warp * group; k0 < n_local; k0 += kWarps * group) {
    const int i = k0 + gid;
    const bool has = i < n_local;
    int cnt = 0;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (has) {
      x = list[i];
      if (peer == r) {
        cnt = i;
      } else {
        cnt = lower_bound(copied ? list + sh.at_of[peer]
                                 : cluster.map_shared_rank(list, peer),
                          sh.n_of[peer], x);
      }
    }
    for (int off = nc >> 1; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, off);
    if (has && peer == 0 && cnt < a.k) {
      const size_t li = base + x.w;
      const float c = lane_cost(a, li);
      const bool valid = isfinite(c);
      int state = -1, lm = 0, prev = 0, w0 = 0, w1 = 0;
      float cost = INFINITY;
      if (valid && a.lm) lm = a.lm[li];
      if (valid && any_finite && c <= cutoff) {
        state = a.state[li];
        cost = c;
        prev = a.tok[li];
        w0 = a.olab2[li];
        w1 = a.olabel[li];
      }
      const size_t j = out + cnt;
      a.o_states[j] = state;
      a.o_lms[j] = lm;
      a.o_costs[j] = cost;
      a.o_prev[j] = prev;
      a.o_words[2 * j] = w0;
      a.o_words[2 * j + 1] = w1;
    }
  }
  for (int j = n_sel + r * kThreads + tid; j < a.k; j += nc * kThreads)
    empty_slot(a, out + j);
  if (leader) {
    a.demand[row] = sh.demand;
    if (a.overflow) a.overflow[row] = sh.demand > c2 ? 1 : 0;
  }
  cluster.sync();  // no CTA leaves while a peer still reads its list
  stamp(a, row, 10, leader);
  if (leader && a.stamps) {
    a.stamps[row * kStamps + 11] = n_c;      // CTA 0's candidates
    a.stamps[row * kStamps + 12] = n_local;  // and its selected keys
    a.stamps[row * kStamps + 13] = static_cast<long long>(cap);
    a.stamps[row * kStamps + kStamps - 1] = sh.passes;
  }
}

// The launch attributes, set once per device and library load (not per
// call, so that a launch can be captured in a CUDA graph).
std::mutex attr_mutex;
bool attr_done[64];

cudaError_t configure() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(attr_mutex);
  if (attr_done[dev]) return cudaSuccess;
  const void* kernels[2] = {
      reinterpret_cast<const void*>(frame_select_kernel<true>),
      reinterpret_cast<const void*>(frame_select_kernel<false>)};
  for (const void* fn : kernels) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr_done[dev] = true;
  return cudaSuccess;
}

// The dynamic shared memory of a launch: the slice and the inbox, or on
// the global path the sort buffer of next_pow2(min(k, slice)) keys.
long long launch_smem(int k, int log2cap, int log2c, int shared) {
  const long long slice = 1ll << (log2cap - log2c);
  if (shared) return 16 * slice + kInboxBytes;
  long long keys = 1;
  while (keys < std::min<long long>(k, slice)) keys <<= 1;
  return 16 * keys;
}

cudaLaunchConfig_t launch_config(int rows, int k, int log2cap, int log2c,
                                 int shared, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows) << log2c);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes =
      static_cast<size_t>(launch_smem(k, log2cap, log2c, shared));
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << log2c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// rows clusters of 2^log2c CTAs (log2c <= 4; log2c <= log2cap, (1 <<
// log2cap) > e); shared != 0: the table's slices in shared memory
// ((1 << (log2cap - log2c)) * 16 <= kSliceBytes) and table null; else
// table is rows * (1 << log2cap) slots of 16 B in global memory (cleared
// by the kernel, a row's first slots as its live lanes need them) and
// min(k, slice) keys fit the sort buffer.  1 <= k <= 8192; c2 = 0 (the
// classic sorts) or K <= c2 < e (select_compact), and then overflow is
// rows bytes.  stamps: null, or rows * kStamps int64.  row_valid: null,
// or rows bools (a row whose byte is 0 gets a dead row's outputs).
int catears_frame_select(const void* state, const void* lm, const void* cost,
                         const void* w1, const void* w2, const void* tok,
                         const void* olab2, const void* olabel,
                         void* o_states, void* o_lms, void* o_costs,
                         void* o_prev, void* o_words, void* demand,
                         void* overflow, void* table, void* stamps,
                         const void* row_valid, int rows, int e, int k,
                         int c2, int log2cap, int log2c, int shared,
                         float beam, void* stream) {
  if (log2c < 0 || log2c > 4 || log2cap < log2c ||
      log2cap - log2c > 30 ||
      (!shared && !table))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (launch_smem(k, log2cap, log2c, shared) > kMaxDynamicSmem)
    return static_cast<int>(cudaErrorInvalidValue);
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
                 static_cast<ulonglong2*>(shared ? nullptr : table),
                 static_cast<long long*>(stamps),
                 static_cast<const unsigned char*>(row_valid),
                 e, k, c2, log2cap, log2c, beam};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(rows, k, log2cap, log2c, shared,
                    static_cast<cudaStream_t>(stream), attr);
  err = shared ? cudaLaunchKernelEx(&cfg, frame_select_kernel<true>, a)
               : cudaLaunchKernelEx(&cfg, frame_select_kernel<false>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Into *clusters: how many of the launch's clusters the card holds at
// once (cudaOccupancyMaxActiveClusters), i.e. the rows one wave takes.
int catears_frame_select_clusters(int k, int log2cap, int log2c, int shared,
                                  void* clusters) {
  if (log2c < 0 || log2c > 4 || log2cap < log2c || log2cap - log2c > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(1, k, log2cap, log2c, shared, nullptr, attr);
  err = cudaOccupancyMaxActiveClusters(
      static_cast<int*>(clusters),
      shared ? reinterpret_cast<const void*>(frame_select_kernel<true>)
             : reinterpret_cast<const void*>(frame_select_kernel<false>),
      &cfg);
  return static_cast<int>(err);
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
