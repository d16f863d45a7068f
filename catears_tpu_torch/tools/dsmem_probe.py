"""Probe the thread-block-cluster primitives csrc/frame_select.cu is built
on, on one NVIDIA Hopper card:

    python -m catears_tpu_torch.tools.dsmem_probe

Builds a small CUDA source with nvcc (into catears_tpu_torch/_build/) and
runs it in 16 clusters of 8 CTAs of 1,024 threads, each CTA with 128 KiB
of dynamic shared memory, as the select kernel runs at the bench's 16
rows.  Prints one JSON line:

* `atomic_min_u64_dsmem`: every thread of a cluster takes a 64-bit
  atomicMin of a distinct value into CTA 0's shared memory over DSMEM;
  `ok` says whether the least value survived (it is also checked against
  a 64-bit atomicMin into the CTA's own shared memory);
* microseconds, per CTA (median over the 128 CTAs, %globaltimer), of 100
  cluster.sync() and 100 __syncthreads(), and of 8 dependent operations a
  thread on random 16-byte slots: 64-bit CAS and loads over DSMEM, 64-bit
  stores over DSMEM, 64-bit CAS in the CTA's own shared memory.

Exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__device__ unsigned long long now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out[cta * 3]: the DSMEM min, the local min, the expected min.
__global__ void __cluster_dims__(8, 1, 1) mins(unsigned long long* out) {
  __shared__ unsigned long long m[2];
  auto cl = cg::this_cluster();
  if (threadIdx.x < 2) m[threadIdx.x] = ~0ull;
  cl.sync();
  const unsigned long long v = 5ull + blockIdx.x * 1024 + threadIdx.x;
  atomicMin(cl.map_shared_rank(m, 0), v);
  atomicMin(m + 1, v);
  cl.sync();
  if (threadIdx.x == 0) {
    out[3 * blockIdx.x] = cl.block_rank() == 0 ? m[0] : 0;
    out[3 * blockIdx.x + 1] = m[1];
    out[3 * blockIdx.x + 2] = 5ull + blockIdx.x * 1024;
  }
}

__global__ void __cluster_dims__(8, 1, 1) __launch_bounds__(1024, 1)
    timed(long long* out, int mode) {
  extern __shared__ unsigned long long tab[];  // 8,192 slots of 16 B
  auto cl = cg::this_cluster();
  for (int i = threadIdx.x; i < 16384; i += 1024) tab[i] = 0;
  cl.sync();
  unsigned rng = blockIdx.x * 1024 + threadIdx.x;
  unsigned long long acc = 0;
  const unsigned long long t0 = now();
  for (int i = 0; i < (mode < 2 ? 100 : 8); ++i) {
    rng = rng * 1664525u + 1013904223u + static_cast<unsigned>(acc);
    unsigned long long* peer =
        cl.map_shared_rank(tab, (rng >> 28) & 7) + 2 * ((rng >> 8) & 8191);
    if (mode == 0) cl.sync();
    if (mode == 1) __syncthreads();
    if (mode == 2) acc += atomicCAS(peer, acc, rng);
    if (mode == 3) acc += *reinterpret_cast<volatile unsigned long long*>(peer);
    if (mode == 4) *peer = rng;
    if (mode == 5) acc += atomicCAS(tab + 2 * ((rng >> 8) & 8191), acc, rng);
  }
  __syncthreads();
  const unsigned long long t1 = now();
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = (t1 - t0) + (acc & 1);
}

extern "C" int run_mins(void* out) {
  mins<<<128, 1024>>>(static_cast<unsigned long long*>(out));
  return cudaDeviceSynchronize();
}

extern "C" int run_timed(void* out, int mode) {
  cudaError_t e = cudaFuncSetAttribute(
      timed, cudaFuncAttributeMaxDynamicSharedMemorySize, 131072);
  if (e != cudaSuccess) return e;
  timed<<<128, 1024, 131072>>>(static_cast<long long*>(out), mode);
  return cudaDeviceSynchronize();
}
"""

MODES = ("cluster_sync_x100", "syncthreads_x100", "dsmem_cas64_x8",
         "dsmem_load64_x8", "dsmem_store64_x8", "local_cas64_x8")


def main() -> int:
    import torch

    from catears_tpu_torch.kernels import BUILD_DIR, NVCC_FLAGS, nvcc_path

    if not torch.cuda.is_available():
        print("dsmem_probe: no CUDA card", file=sys.stderr)
        return 1
    os.makedirs(BUILD_DIR, exist_ok=True)
    src = os.path.join(BUILD_DIR, "dsmem_probe.cu")
    lib_path = os.path.join(BUILD_DIR, f"libdsmem_probe-{os.getpid()}.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", lib_path, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.run_mins.argtypes = [ctypes.c_void_p]
    lib.run_timed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = torch.zeros(128 * 3, dtype=torch.int64, device="cuda")
    if lib.run_mins(out.data_ptr()):
        print("dsmem_probe: the min kernel failed", file=sys.stderr)
        return 1
    m = out.view(128, 3).cpu().numpy()
    ranks0 = m[::8]  # CTA 0 of each cluster
    result = {"card": torch.cuda.get_device_name(0),
              "atomic_min_u64_dsmem": {
                  "ok": bool((ranks0[:, 0] == ranks0[:, 2]).all()),
                  "got_first": int(ranks0[0, 0]),
                  "want_first": int(ranks0[0, 2]),
                  "local_ok": bool((m[:, 1] == m[:, 2]).all())}}
    times = torch.zeros(128, dtype=torch.int64, device="cuda")
    for mode, name in enumerate(MODES):
        for _ in range(3):  # the last run is kept
            if lib.run_timed(times.data_ptr(), mode):
                print(f"dsmem_probe: {name} failed", file=sys.stderr)
                return 1
        result[f"{name}_us"] = float(times.median()) / 1e3
    os.remove(lib_path)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
