// The device backtrace: backpointer chase over T frames for each utterance,
// in one launch (Hopper, sm_90a).
//
//   prev_slot [T, B, K] int32, words [T, B, K, W] int32, best_slots [B]
//   int32 -> out [B, T, W] int32
//
// Replaces the JAX package's device-side loop
// catears_tpu/decode/beam.py::backtrace_device (jax.vmap over a
// jax.lax.scan(..., reverse=True), one program per batch) and holds the
// port's plain version (decode/beam.py::backtrace_device_ref, a Python loop
// of T steps of 4 launches each) bit for bit.  One thread per utterance b
// starts at max(best_slots[b], 0) and runs JAX's scan step for f = T-1 ... 0:
//   out[b, f, :] = active ? words[f, b, slot, :] : 0
//   nxt = prev_slot[f, b, slot]; step = active && nxt >= 0
//   slot = step ? nxt : slot; active = step
// Once inactive, the rest of its frames are zeros, written without a load.
// Slots past K clamp to K - 1, as a JAX gather clamps its index.
//
// What bounds it on the H100: its bytes are small (a word row and a
// backpointer a frame, the [B, T, W] output); the walk is a chain of T
// dependent loads, so its time is about T device-memory latencies (~998 x
// ~0.6 us for the smoke's traces, which outgrow the 50 MB L2), whatever
// the bandwidth.  The word loads are off the chain and overlap it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;

__global__ void backtrace_kernel(const int* __restrict__ prev,
                                 const int* __restrict__ words,
                                 const int* __restrict__ best,
                                 int* __restrict__ out, int t, int b, int k,
                                 int w) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= b) return;
  int slot = max(best[u], 0);
  bool active = true;
  int* row = out + static_cast<size_t>(u) * t * w;
  for (int f = t - 1; f >= 0; --f) {
    int* o = row + static_cast<size_t>(f) * w;
    if (!active) {
      for (int j = 0; j < w; ++j) o[j] = 0;
      continue;
    }
    const size_t at = (static_cast<size_t>(f) * b + u) * k + min(slot, k - 1);
    const int nxt = __ldg(prev + at);
    const int* src = words + at * w;
    for (int j = 0; j < w; ++j) o[j] = __ldg(src + j);
    active = nxt >= 0;
    if (active) slot = nxt;
  }
}

}  // namespace

extern "C" {

int catears_backtrace(const void* prev, const void* words, const void* best,
                      void* out, int t, int b, int k, int w, void* stream) {
  backtrace_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(prev), static_cast<const int*>(words),
      static_cast<const int*>(best), static_cast<int*>(out), t, b, k, w);
  return static_cast<int>(cudaGetLastError());
}

const char* catears_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
