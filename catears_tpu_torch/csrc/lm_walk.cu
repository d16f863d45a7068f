// The delta-LM backoff walk over the word-emitting lanes of an expansion,
// capped and compacted, in one launch (Hopper, sm_90a).
//
//   states, labels: [rows, E] int32 -> next_states [rows, E] int32,
//   delta_weights [rows, E] f32, needed [rows] int32
//
// Replaces the JAX package's device-side loop
// catears_tpu/graph/device.py::lm_propagate_capped (compact_mask, then
// lm_propagate's jax.lax.while_loop, which runs until no lane is active,
// then a scatter back), and holds the port's plain version
// (graph/device.py::lm_propagate_capped_ref) bit for bit.  That version
// runs the loop as 2 * (max_backoff + 1) static masked iterations of ~90
// tiny launches each (~1,660 launches a walk), because a PyTorch loop
// cannot end on a device value without reading the device.  Here every
// lane's loop ends on its own.
//
// One block per row:
//   1. compaction, in lane order: tiles of blockDim lanes; a warp ballot
//      ranks each active (label > 0) lane in its warp, one warp scans the
//      warp counts, and the running total carries across tiles.  The first
//      `cap` active lanes (every active lane when uncapped) are listed in
//      `lanes` (global scratch [rows, cap]); every other lane is written
//      back at once with its own state and weight 0, as in the plain
//      version.  needed[row] = the total.
//   2. the walk: one thread per listed lane runs JAX's state machine (hash
//      probe, second-choice probe on the bucket's overflow bit, backoff
//      hop, failure on a missing backoff arc or past max_backoff) to its
//      own end, at most `iters` = 2 * (max_backoff + 1) probes, the bound
//      the plain version is proved to reach.
//   3. write-back: found -> (state', weight - small_lm[label]); failed or
//      unfinished -> (state, 0).
//
// Bit-exactness: the weight is the same sequence of float32 additions in
// round-to-nearest (__fadd_rn), then one __fsub_rn; a probe's matched next
// state and weight are the wrapping integer sums of the matching slots,
// the weight then reinterpreted as a float, as the plain version sums
// them.  There is no multiply, so nothing can contract into an FMA.
//
// What bounds it on the H100 (3.35 TB/s): the bytes of the compaction and
// the write-back, 16 B a lane (two int32 read, two written), 8.4 MB at the
// bench's 16 x 32,768 lanes (2.5 us), plus 64 B a probe and 8 B a hop for
// each walked lane.  The walk itself is a latency chain: at most
// 2 * (max_backoff + 1) = 18 dependent gathers (hash row, backoff row) a
// lane.  A block per row uses only `rows` SMs for the streaming part; that
// is the first thing to widen if the kernel shows up in a profile.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

struct Lm {
  const int4* hash_tab;   // [buckets, 16] int32 as 4 x int4 a row
  const int2* state_tab;  // [S] (backoff next or -1, backoff weight bits)
  const float* small_lm;  // [n_small] unigram costs to subtract
  const int* uni_next;    // [n_uni] state-0 next (-1 = no arc)
  const float* uni_weight;
  int n_small, n_uni, n_state;
  uint32_t seed1, seed2, mask;
  int max_backoff, iters;
};

__device__ __forceinline__ int clampi(int x, int hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// graph/device.py::_lm_hash in native uint32 arithmetic.
__device__ __forceinline__ uint32_t lm_hash(int s, int l, uint32_t seed,
                                            uint32_t mask) {
  uint32_t h = (static_cast<uint32_t>(s) * 0x9E3779B1u) ^
               (static_cast<uint32_t>(l) * 0x85EBCA77u) ^ seed;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 13;
  return h & mask;
}

// One lane's walk from `state` on `label` (> 0).  Returns true on success
// with *out_state, *out_w set to the plain version's values.
__device__ bool walk(const Lm& lm, int state, int label, int* out_state,
                     float* out_w) {
  const int lu = clampi(label, lm.n_uni - 1);
  const int uni_nxt = __ldg(lm.uni_next + lu);
  const float uni_w = __ldg(lm.uni_weight + lu);
  int cur = state;
  float weight = 0.0f;
  bool phase2 = false;
  int bo_it = 0;
  for (int it = 0; it < lm.iters; ++it) {
    bool hit, need2 = false;
    int nxt;
    float w;
    if (cur == 0) {  // state 0 resolves from the dense table
      hit = uni_nxt >= 0;
      nxt = uni_nxt;
      w = uni_w;
    } else {
      const uint32_t h =
          lm_hash(cur, label, phase2 ? lm.seed2 : lm.seed1, lm.mask);
      const int4* row = lm.hash_tab + 4 * static_cast<size_t>(h);
      const int4 s4 = __ldg(row), l4 = __ldg(row + 1);
      const int4 n4 = __ldg(row + 2), w4 = __ldg(row + 3);
      const bool ov = l4.x < 0;  // the overflow bit rides l0's sign
      const bool m0 = s4.x == cur && (l4.x & 0x7FFFFFFF) == label;
      const bool m1 = s4.y == cur && (l4.y & 0x7FFFFFFF) == label;
      const bool m2 = s4.z == cur && (l4.z & 0x7FFFFFFF) == label;
      const bool m3 = s4.w == cur && (l4.w & 0x7FFFFFFF) == label;
      hit = m0 || m1 || m2 || m3;
      // Wrapping sums of the matching slots, in slot order.
      const uint32_t n_sum =
          (m0 ? static_cast<uint32_t>(n4.x) : 0u) +
          (m1 ? static_cast<uint32_t>(n4.y) : 0u) +
          (m2 ? static_cast<uint32_t>(n4.z) : 0u) +
          (m3 ? static_cast<uint32_t>(n4.w) : 0u);
      const uint32_t w_sum =
          (m0 ? static_cast<uint32_t>(w4.x) : 0u) +
          (m1 ? static_cast<uint32_t>(w4.y) : 0u) +
          (m2 ? static_cast<uint32_t>(w4.z) : 0u) +
          (m3 ? static_cast<uint32_t>(w4.w) : 0u);
      nxt = static_cast<int>(n_sum);
      w = __int_as_float(static_cast<int>(w_sum));
      need2 = !hit && ov && !phase2;
    }
    if (hit) {
      *out_state = nxt;
      *out_w = __fsub_rn(__fadd_rn(weight, w),
                         __ldg(lm.small_lm + clampi(label, lm.n_small - 1)));
      return true;
    }
    if (need2) {  // probe the second-choice bucket next
      phase2 = true;
      continue;
    }
    // A miss follows the state's backoff arc, if it has one.
    const int2 bo = __ldg(lm.state_tab + clampi(cur, lm.n_state - 1));
    if (bo.x < 0 || bo_it >= lm.max_backoff) return false;
    cur = bo.x;
    weight = __fadd_rn(weight, __int_as_float(bo.y));
    ++bo_it;
    phase2 = false;
  }
  return false;  // past the static bound: unfinished, as the plain loop
}

__global__ void __launch_bounds__(kThreads, 1)
    lm_walk_kernel(const int* __restrict__ states,
                   const int* __restrict__ labels, Lm lm,
                   int* __restrict__ out_states, float* __restrict__ out_w,
                   int* __restrict__ needed, int* lanes, int e, int cap) {
  __shared__ int warp_count[kWarps];
  __shared__ int warp_base[kWarps];
  __shared__ int total_s;
  const size_t row = blockIdx.x;
  const int* st = states + row * e;
  const int* lb = labels + row * e;
  int* os = out_states + row * e;
  float* ow = out_w + row * e;
  int* list = lanes + row * static_cast<size_t>(cap);
  const int tid = threadIdx.x, warp = tid >> 5, lane_id = tid & 31;
  const unsigned below = (1u << lane_id) - 1u;
  if (tid == 0) total_s = 0;
  __syncthreads();

  // 1. Order-preserving compaction, one tile of kThreads lanes at a time.
  for (int base = 0; base < e; base += kThreads) {
    const int i = base + tid;
    const bool in = i < e;
    const int s = in ? st[i] : 0;
    const bool active = in && lb[i] > 0;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, active);
    if (lane_id == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the warp counts
      const int running = total_s;
      const int c = warp_count[lane_id];
      int incl = c;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        if (lane_id >= d) incl += v;
      }
      warp_base[lane_id] = running + incl - c;
      __syncwarp();  // every lane has read total_s
      if (lane_id == 31) total_s = running + incl;
    }
    __syncthreads();
    const int rank = warp_base[warp] + __popc(ballot & below);
    if (active && rank < cap) {
      list[rank] = i;
    } else if (in) {
      os[i] = s;
      ow[i] = 0.0f;
    }
    __syncthreads();  // warp_count / warp_base are reused by the next tile
  }
  const int total = total_s;
  if (tid == 0) needed[row] = total;

  // 2-3. One thread per listed lane walks to its own end.
  const int n_walk = total < cap ? total : cap;
  for (int j = tid; j < n_walk; j += kThreads) {
    const int i = list[j];
    const int s = st[i];
    int ns;
    float w;
    if (walk(lm, s, lb[i], &ns, &w)) {
      os[i] = ns;
      ow[i] = w;
    } else {
      os[i] = s;
      ow[i] = 0.0f;
    }
  }
}

}  // namespace

extern "C" {

// `cap` is the walk's capacity per row, already resolved by the caller to
// E when uncapped; `lanes` is scratch of rows * cap int32.
int catears_lm_walk(const void* states, const void* labels,
                    const void* hash_tab, const void* state_tab,
                    const void* small_lm, const void* uni_next,
                    const void* uni_weight, void* out_states, void* out_w,
                    void* needed, void* lanes, int rows, int e, int cap,
                    int n_small, int n_uni, int n_state, unsigned seed1,
                    unsigned seed2, unsigned mask, int max_backoff, int iters,
                    void* stream) {
  const Lm lm{static_cast<const int4*>(hash_tab),
              static_cast<const int2*>(state_tab),
              static_cast<const float*>(small_lm),
              static_cast<const int*>(uni_next),
              static_cast<const float*>(uni_weight),
              n_small, n_uni, n_state, seed1, seed2, mask, max_backoff,
              iters};
  lm_walk_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(states), static_cast<const int*>(labels), lm,
      static_cast<int*>(out_states), static_cast<float*>(out_w),
      static_cast<int*>(needed), static_cast<int*>(lanes), e, cap);
  return static_cast<int>(cudaGetLastError());
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
