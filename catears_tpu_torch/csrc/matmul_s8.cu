// Int8 GEMM with exact int32 accumulation for Hopper (sm_90a): wgmma fed by
// TMA through a 4-stage mbarrier ring, with two epilogues from one template.
//
//   C = A @ W     A: [rows, K] int8 (rows = batch * M)   W: [K, N] int8
//
// Replaces the TPU kernel catears_tpu/am/quant.py::matmul_s8 (its one
// pl.pallas_call, body _matmul_s8_kernel): 256 x 256 output tiles with all
// of K in VMEM, inputs zero-padded on the host, the f32 dequant epilogue
// left to its caller `qmatmul`.  Here the epilogue is a template parameter:
//   * int32 (`matmul_s8`): C stored exactly, the TPU kernel's function;
//   * fused (`qmatmul`): the f32 dequantized linear, computed in registers
//     in exactly the plain version's order, with no contraction into FMAs:
//       out = (sA[u]*sB) * (((f32(dot) + cB*rowsumA[r]) + cA[u]*colsumB[c])
//             + (K*cA[u])*cB) + bias[c],   u = r / M (per utterance) or 0.
//
// What bounds it on the H100 (1,979 int8 TOP/s dense, 3.35 TB/s), at the
// quantized TDNN-1024's three linears with 8 utterances of ~1636 frames,
// counting A and W read once and the 4-byte output written once:
//   8x1638 x 120 x 1024    3.2 GOP   55 MB   16.5 us, HBM       (~58 op/B)
//   8x1636 x 3072 x 1024  82.3 GOP   97 MB   41.6 us, tensor cores (849)
//   8x1636 x 1024 x 3600  96.5 GOP  206 MB   61.4 us, HBM        (469)
// so two of the three sit under the card's ~590 op/byte ridge, and the
// output write (4 bytes per element) is most of their bytes.  The design:
//   * int8 wgmma (m64nBNk32, both operands K-major from shared memory) is
//     the only way to Hopper's int8 rate, so W comes in transposed, as
//     Wt [N, Kp] (made once per weight), and both operands have K
//     innermost; Kp is K rounded up to 16 bytes (the TMA stride rule), the
//     pad is zeros in A and Wt, so it adds nothing to the dot;
//   * one producer warp issues TMA loads of 128 x 128 A tiles and BN x 128
//     Wt tiles, 128-byte swizzled, into 4 stages with full/empty
//     mbarriers; the ragged M, N and K edges are TMA's zero fill;
//   * two consumer warpgroups each own 64 x BN of the 128 x BN tile and
//     keep one wgmma group in flight while the next stage lands;
//     setmaxnreg moves registers from the producer to them;
//   * the grid is persistent (one block per SM, tiles dealt round-robin,
//     N fastest so that neighbours share A rows): the producer loads the
//     next tile's k-tiles while the consumers run this tile's epilogue;
//   * the fused epilogue turns 48 bytes of f32 traffic per output element
//     (the int32 store, its conversion and five elementwise passes) into
//     one 4-byte store; the row sums of A it needs are taken from the A
//     tiles already in shared memory (dp4a), not from a pass over A; and
//     an interior tile (every tile at the AM's shapes) stores without a
//     per-element mask, whose branches cost more than the epilogue's math.
// Not done yet: an epilogue that overlaps the next tile's wgmma (a TMA
// store from shared memory, or ping-pong consumers) and cluster multicast
// of A.
//
// Host side: plain C entry points (below) that return cudaError_t, called
// through ctypes.  They encode the tensor maps (cached per pointer and
// shape), launch on the caller's stream, never synchronise and allocate
// nothing.  `bn` is the tile width, 128, 240 or 256 (`quant.tile_width`
// picks it from N).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

constexpr int BM = 128;       // output tile rows: two warpgroups of 64
constexpr int BK = 128;       // k-tile: 128 int8 = one 128-byte swizzle row
constexpr int STAGES = 4;     // shared-memory ring depth
constexpr int THREADS = 384;  // consumer warpgroups 0-1, producer 2
constexpr int A_TILE = BM * BK;

template <int BN>
struct Tile {
  static constexpr int B_TILE = BN * BK;
  static constexpr int STAGE = A_TILE + B_TILE;  // a multiple of 1024
  // + 1024 to align the ring to the 128-byte swizzle's 1024-byte atom,
  // + the 2 x STAGES mbarriers.
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

// The fused epilogue's operands (device pointers), passed by value.
struct Epilogue {
  const float* colsum;    // [N] column sums of W
  const float* bias;      // [N], or null
  const float* sa;        // activation scale, per utterance or one
  const int32_t* zpa;     // activation zero point, same shape
  const float* sb;        // weight scale (one)
  const int32_t* zpb;     // weight zero point (one)
  float k;                // the true K
  int m_utt;              // rows per utterance
  int utt_stride;         // 1: per utterance, 0: one scale for all rows
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the barrier's phase with the given parity to complete.  A
// pipeline that never completes (a fault in this file) traps after about
// ten seconds, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile written by TMA with the
// 128-byte swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the
// stride byte offset); the leading byte offset is unused for swizzled
// K-major tiles; layout type 1 = SWIZZLE_128B.  Stepping k by 32 bytes
// inside the 128-byte row moves the start address only.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ int sum4x4(uint4 v, int acc) {
  acc = __dp4a(static_cast<int>(v.x), 0x01010101, acc);
  acc = __dp4a(static_cast<int>(v.y), 0x01010101, acc);
  acc = __dp4a(static_cast<int>(v.z), 0x01010101, acc);
  return __dp4a(static_cast<int>(v.w), 0x01010101, acc);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x BN] += A[64 x 32] * B[32 x BN], int8 in, int32 accumulate; the
// accumulator fragment of thread t (warp w = t / 32 of the warpgroup,
// lane l): d[4j + 2h + c] is row 16w + l/4 + 8h, column 8j + 2(l%4) + c.
template <int BN>
struct Wgmma;

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<240> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[120], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %122, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n240k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119"
      "}, %120, %121, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119])
      : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(uint32_t (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
  }
};

// The epilogue of one consumer thread: its accumulator fragment (rows r0
// and r0 + 8, whose A row sums are rowsum[0..1]; columns c0 + 8j + {0, 1})
// stored as int32, or as the fused f32 linear.  MASKED masks the ragged M
// and N edges and stores one word at a time; an interior tile (every
// column inside N, N even) takes the unmasked path, with no per-element
// branch.  The row terms are computed once per tile, and each column's
// operands are read once for both rows.
template <int BN, bool FUSED, bool MASKED, bool BIAS>
__device__ __forceinline__ void store_tile(const uint32_t (&acc)[BN / 2],
                                           void* out, int rows, int n, int r0,
                                           int c0, const int (&rowsum)[2],
                                           const Epilogue& ep) {
  // Per row h: cB*rowsumA, (K*cA)*cB, cA and sA*sB.
  float t1[2] = {0.f, 0.f}, kcc[2] = {0.f, 0.f}, ca[2] = {0.f, 0.f},
        s[2] = {0.f, 0.f};
  if constexpr (FUSED) {
    const float cb = __int2float_rn(128 - __ldg(ep.zpb));
    const float sb = __ldg(ep.sb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(r0 + 8 * h, rows - 1);  // a row past M is not stored
      const int u = (r / ep.m_utt) * ep.utt_stride;
      ca[h] = __int2float_rn(128 - __ldg(ep.zpa + u));
      t1[h] = __fmul_rn(cb, __int2float_rn(rowsum[h]));
      kcc[h] = __fmul_rn(__fmul_rn(ep.k, ca[h]), cb);
      s[h] = __fmul_rn(__ldg(ep.sa + u), sb);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = c0 + 8 * j;
    if (MASKED && c >= n) continue;
    float colsum[2] = {0.f, 0.f}, bias[2] = {0.f, 0.f};
    if constexpr (FUSED) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (!MASKED || c + q < n) {
          colsum[q] = __ldg(ep.colsum + c + q);
          if (BIAS) bias[q] = __ldg(ep.bias + c + q);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (MASKED && r >= rows) continue;
      uint32_t w[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
      if constexpr (FUSED) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float t = __fadd_rn(__int2float_rn(static_cast<int32_t>(w[q])),
                              t1[h]);
          t = __fadd_rn(t, __fmul_rn(ca[h], colsum[q]));
          t = __fmul_rn(s[h], __fadd_rn(t, kcc[h]));
          w[q] = __float_as_uint(BIAS ? __fadd_rn(t, bias[q]) : t);
        }
      }
      uint32_t* dst = static_cast<uint32_t*>(out) + static_cast<size_t>(r) * n + c;
      if constexpr (MASKED) {
        dst[0] = w[0];
        if (c + 1 < n) dst[1] = w[1];
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
      }
    }
  }
}

template <int BN, bool FUSED>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_s8_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   void* __restrict__ out, int rows, int n, int num_k,
                   Epilogue ep) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * Tile<BN>::STAGE;
  const uint32_t empty0 = full0 + STAGES * 8;
  const int tid = threadIdx.x;
  const int n_tiles = (n + BN - 1) / BN;
  const int num_tiles = n_tiles * ((rows + BM - 1) / BM);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's expect_tx arrival
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // Producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < num_k; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          const uint32_t full = full0 + 8 * stage;
          const uint32_t dst = base + stage * Tile<BN>::STAGE;
          mbar_expect_tx(full, Tile<BN>::STAGE);
          tma_load(dst, &map_a, full, kt * BK, m0);
          tma_load(dst + A_TILE, &map_b, full, kt * BK, n0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // Consumer warpgroups 0 and 1: rows [64 wg, 64 wg + 64) of each tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = tid & 31;
    const int warp = (tid & 127) >> 5;  // this warp's 16 rows of the 64
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    uint32_t acc[BN / 2];
    for (int tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
      fence_acc(acc);
      // Fused: partial row sums of A; part[i] covers row 16 warp + 4 i +
      // lane / 8, 16-byte chunk lane % 8 of each k-tile (the swizzle only
      // permutes a row's chunks, which a sum ignores).
      int part[4] = {0, 0, 0, 0};
      for (int kt = 0; kt < num_k; ++kt) {
        mbar_wait(full0 + 8 * stage, phase);
        const uint32_t a_s = base + stage * Tile<BN>::STAGE + wg * 64 * BK;
        const uint32_t b_s = base + stage * Tile<BN>::STAGE + A_TILE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          Wgmma<BN>::mma(acc, sw128_desc(a_s + 32 * kk),
                         sw128_desc(b_s + 32 * kk));
        wgmma_commit();
        if constexpr (FUSED) {
          const uint32_t row = a_s + (warp * 16 + (lane >> 3)) * BK +
                               (lane & 7) * 16;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            part[i] = sum4x4(lds128(row + 4 * i * BK), part[i]);
        }
        // One group stays in flight: the previous k-tile's is done, so its
        // stage goes back to the producer.
        wgmma_wait<1>();
        fence_acc(acc);
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      // This thread's rows are 16 warp + lane / 4 (+ 8): their sums sit,
      // after the 8-lane reduction, in part[lane / 16] (part[2 + lane /
      // 16]) of lane 8 ((lane / 4) % 4).
      int rowsum[2] = {0, 0};
      if constexpr (FUSED) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 1; d < 8; d <<= 1)
            part[i] += __shfl_xor_sync(0xffffffffu, part[i], d);
        const int src = 8 * ((lane >> 2) & 3);
        int got[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          got[i] = __shfl_sync(0xffffffffu, part[i], src);
        rowsum[0] = (lane >> 4) ? got[1] : got[0];
        rowsum[1] = (lane >> 4) ? got[3] : got[2];
      }
      const int m0 = (tile / n_tiles) * BM, n0 = (tile % n_tiles) * BN;
      const int r0 = m0 + wg * 64 + warp * 16 + (lane >> 2);
      const int c0 = n0 + 2 * (lane & 3);
      const bool bias = FUSED && ep.bias;  // the int32 epilogue has none
      if (m0 + BM <= rows && n0 + BN <= n && n % 2 == 0) {
        if (bias)
          store_tile<BN, FUSED, false, true>(acc, out, rows, n, r0, c0,
                                             rowsum, ep);
        else
          store_tile<BN, FUSED, false, false>(acc, out, rows, n, r0, c0,
                                              rowsum, ep);
      } else if (bias) {
        store_tile<BN, FUSED, true, true>(acc, out, rows, n, r0, c0, rowsum,
                                          ep);
      } else {
        store_tile<BN, FUSED, true, false>(acc, out, rows, n, r0, c0, rowsum,
                                           ep);
      }
    }
  }
}

// -- host side ---------------------------------------------------------------

constexpr int kErrEncode = -1;  // cuTensorMapEncodeTiled failed or missing
constexpr int kErrTile = -2;    // unsupported tile width

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda that the CUDA runtime loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 2-D int8 tensor map over a row-major [rows, kp] matrix, box 128 x
// box_rows, 128-byte swizzle, zero fill outside.  Maps are cached by
// (pointer, rows, kp, box_rows): the weights' maps are made once.
struct MapEntry {
  const void* ptr;
  int rows, kp, box_rows;
  CUtensorMap map;
};
constexpr int kCache = 64;
MapEntry g_cache[kCache];
int g_cache_next = 0;
std::mutex g_cache_mu;

bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int kp,
                int box_rows) {
  std::lock_guard<std::mutex> lock(g_cache_mu);
  for (const MapEntry& e : g_cache) {
    if (e.ptr == ptr && e.rows == rows && e.kp == kp &&
        e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  EncodeTiled encode = encoder();
  if (!encode) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp)};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  MapEntry& slot = g_cache[g_cache_next];
  g_cache_next = (g_cache_next + 1) % kCache;
  slot = MapEntry{ptr, rows, kp, box_rows, *map};
  return true;
}

template <int BN, bool FUSED>
int launch(const void* a, const void* bt, void* out, int rows, int n, int kp,
           const Epilogue& ep, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!tensor_map(&map_a, a, rows, kp, BM) ||
      !tensor_map(&map_b, bt, n, kp, BN))
    return kErrEncode;
  auto kernel = gemm_s8_kernel<BN, FUSED>;
  // Per device, once: the shared-memory attribute and the SM count (a
  // repeated first call by two threads sets the same values).
  constexpr int kDevices = 64;
  static int sm_count[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sm_count[device];
  if (sms == 0) {
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             Tile<BN>::SMEM)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return static_cast<int>(err);
    sm_count[device] = sms;
  }
  const long long tiles = static_cast<long long>((n + BN - 1) / BN) *
                          ((rows + BM - 1) / BM);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, Tile<BN>::SMEM, stream>>>(
      map_a, map_b, out, rows, n, (kp + BK - 1) / BK, ep);
  return static_cast<int>(cudaGetLastError());
}

template <bool FUSED>
int dispatch(int bn, const void* a, const void* bt, void* out, int rows,
             int n, int kp, const Epilogue& ep, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bn) {
    case 128:
      return launch<128, FUSED>(a, bt, out, rows, n, kp, ep, s);
    case 240:
      return launch<240, FUSED>(a, bt, out, rows, n, kp, ep, s);
    case 256:
      return launch<256, FUSED>(a, bt, out, rows, n, kp, ep, s);
    default:
      return kErrTile;
  }
}

}  // namespace

extern "C" {

// C[rows, n] int32 = A[rows, kp] @ Wt[n, kp]^T, exact.
int catears_matmul_s8(const void* a, const void* bt, void* c, int rows, int n,
                      int kp, int bn, void* stream) {
  Epilogue ep;
  std::memset(&ep, 0, sizeof(ep));
  return dispatch<false>(bn, a, bt, c, rows, n, kp, ep, stream);
}

// out[rows, n] f32 = the dequantized linear of A and Wt (see the header).
int catears_qmatmul(const void* a, const void* bt, void* out, int rows, int n,
                    int kp, int bn, const void* colsum, const void* bias,
                    const void* sa, const void* zpa, const void* sb,
                    const void* zpb, float k, int m_utt, int utt_stride,
                    void* stream) {
  const Epilogue ep{static_cast<const float*>(colsum),
                    static_cast<const float*>(bias),
                    static_cast<const float*>(sa),
                    static_cast<const int32_t*>(zpa),
                    static_cast<const float*>(sb),
                    static_cast<const int32_t*>(zpb),
                    k,
                    m_utt,
                    utt_stride};
  return dispatch<true>(bn, a, bt, out, rows, n, kp, ep, stream);
}

const char* catears_error_string(int code) {
  if (code == kErrEncode) return "cuTensorMapEncodeTiled failed";
  if (code == kErrTile) return "unsupported tile width";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
