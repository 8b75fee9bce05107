// Shared device code of the fused edge-block kernels (K1 forward in
// fused_block_fwd.cu; K2 remat and K3 stream backward in fused_block_bwd.cu).
//
// The backward routes the max/min cotangent to the edges whose e2 equals the
// saved extremum exactly (the TPU kernel's tie_tol = 0).  That compare holds
// only if K2 recomputes, and K3 reconstructs, e2 bit for bit as K1 computed
// it.  So the whole forward chain lives here, once: the tile products (same
// fragment order; K2's and K3's half-tile products keep each element's
// chain), the rounding points of each epilogue, and the LayerNorm
// statistics (same per-lane order, same warp_sum butterfly, explicit
// __fmaf_rn / __fmul_rn so that no compiler contraction can differ between
// the kernels).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hgn {

constexpr int TILE = 64;      // edges per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 1e30f;
constexpr float LN_EPS = 1e-5f;
constexpr int MAX_DEVICES = 64;  // device ordinals the per-device launch state covers

using bf16 = __nv_bfloat16;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr int PAD = 4;  // keeps rows 16-byte aligned
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Num<bf16> {
  static constexpr int PAD = 8;
  static __device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf16 from_f(float x) { return __float2bfloat16_rn(x); }
};

// x rounded to the compute type T and back
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Num<T>::to_f(Num<T>::from_f(x));
}

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// N consecutive elements, stored as one vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// A CTA runs one or more teams of THREADS threads, each on its own tile (K1,
// K2, K3 and K7's compute CTAs run two).  The tile code indexes threads and warps
// within its team and synchronizes only its team.
__device__ __forceinline__ int team_tid() { return threadIdx.x & (THREADS - 1); }

// Barrier of the calling thread's team (named barrier 1 + team).
__device__ __forceinline__ void team_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + (int)(threadIdx.x / THREADS)), "n"(THREADS)
               : "memory");
}

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async, cached in L2 only); lands by cp_async_wait_all.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies have landed (a barrier then shows every thread's).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// This thread's copies but those of its last committed group have landed.
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Store `rows` rows of a shared tile (row stride LD) to rows ts .. of `dst`.
template <typename T, int L, int LD>
__device__ __forceinline__ void store_tile(T* dst, const T* tile, int ts, int rows) {
  constexpr int CH = int(L * sizeof(T) / 16);
  for (int i = team_tid(); i < rows * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    reinterpret_cast<int4*>(dst + (size_t)(ts + r) * L)[c] =
        reinterpret_cast<const int4*>(tile + r * LD)[c];
  }
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two 8x8 bf16 matrices, transposed on the way: lanes 0-7 name the rows of
// the first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// Two 8x8 bf16 matrices: lanes 0-7 name the rows of the first, lanes 8-15
// those of the second.
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(a));
}

// Four 8x8 bf16 matrices, transposed on the way: lanes 8i .. 8i+7 name the
// rows of the i-th.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// Four 8x8 bf16 matrices: lanes 8i .. 8i+7 name the rows of the i-th.
__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a));
}

// out[r][c] = sum_k A[r][k] * W[c][k] (A @ W^T, the forward products of an
// [out][in] weight) for the TILE x L tile on tensor cores, k in the same
// order for every call.  A and W are shared, row stride L + 8.  Warp
// (wm, wn) of the team owns rows 16*wm .. +16 and columns wn*L/2 .. +L/2.
// Calls epi(r, c, acc) once for each output element, or, for an epi that
// takes two values, epi(r, c, acc_c, acc_c1) once for each pair of
// neighbouring columns (c even): the same values, for an epilogue that
// reads and writes its row's two elements at once.  Fragments load by
// ldmatrix (one instruction for A's 16 x 16 and one for two n-tiles of W):
// the same registers as four and two 32-bit loads, so the same sums.  K2's
// half-tile products (fused_block_bwd.cu) keep each element's chain.
template <int L, class Epi>
__device__ __forceinline__ void tile_matmul_bf16(const bf16* A, const bf16* W, Epi epi) {
  constexpr int LD = L + 8;
  constexpr int NT = L / 16;  // 8-column n-tiles per warp
  static_assert(NT % 2 == 0, "n-tiles are loaded in pairs");
  const int warp = team_tid() >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wm * 16 + g;
  const int nbase = wn * (L / 2);
  // ldmatrix rows: A's four 8x8 blocks (rows +0/+8, k +0/+8), W's two n-tiles
  // (k +0/+8 of n-tile j, then of j + 1)
  const bf16* const a_row = A + (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  const bf16* const w_row = W + (nbase + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < L; k0 += 16) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, a_row + k0);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b[0], b[1], b[2], b[3], w_row + 8 * j * LD + k0);
      mma16816(acc[j], a0, a1, a2, a3, b[0], b[1]);
      mma16816(acc[j + 1], a0, a1, a2, a3, b[2], b[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = nbase + 8 * j + 2 * t;
    if constexpr (std::is_invocable_v<Epi, int, int, float, float>) {
      epi(r0, c, acc[j][0], acc[j][1]);
      epi(r0 + 8, c, acc[j][2], acc[j][3]);
    } else {
      epi(r0, c, acc[j][0]);
      epi(r0, c + 1, acc[j][1]);
      epi(r0 + 8, c, acc[j][2]);
      epi(r0 + 8, c + 1, acc[j][3]);
    }
  }
}

// float32 variant: thread (ty, tx) of a 16 x 16 layout owns rows
// 4*ty .. +4 and columns tx + 16*j; k runs in order.  W is the [out][in]
// weight in device memory, read through the read-only cache.
template <int L, class Epi>
__device__ __forceinline__ void tile_matmul_f32(const float* A, const float* W, Epi epi) {
  constexpr int LD = L + Num<float>::PAD;
  constexpr int TN = L / 16;
  const int tx = team_tid() & 15, ty = team_tid() >> 4;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < L; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 16 * j;
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)c * L + k));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, w.x, s);
        s = fmaf(a[i].y, w.y, s);
        s = fmaf(a[i].z, w.z, s);
        s = fmaf(a[i].w, w.w, s);
        acc[i][j] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) epi(ty * 4 + i, tx + 16 * j, acc[i][j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- the forward chain, one definition for K1, K2 and K3 -----------------

// h = ((acc + SP[snd]) + RP[rcv]) + b1, each add rounded; b1 already rounded
template <typename T>
__device__ __forceinline__ float layer1_value(float acc, float sp, float rp, float b1) {
  float h = rnd<T>(acc);
  h = rnd<T>(h + sp);
  h = rnd<T>(h + rp);
  return rnd<T>(h + b1);
}

// rnd(acc) + b before its final rounding (layers 2 and 3); b already
// rounded.  The caller rounds once, to store it (from_f) or to use it (rnd):
// both give the same value.
template <typename T>
__device__ __forceinline__ float bias_sum(float acc, float b) {
  return rnd<T>(acc) + b;
}

// LayerNorm statistics of one row: lane owns CPL columns of z (float32).
template <int L, int CPL>
__device__ __forceinline__ void ln_row_stats(const float (&z)[CPL], float& mu, float& isg) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < CPL; ++q) s = __fadd_rn(s, z[q]);
  mu = __fmul_rn(warp_sum(s), 1.f / L);
  float v = 0.f;
#pragma unroll
  for (int q = 0; q < CPL; ++q) {
    const float d = __fsub_rn(z[q], mu);
    v = __fmaf_rn(d, d, v);
  }
  isg = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(v), 1.f / L), LN_EPS));
}

__device__ __forceinline__ float ln_xhat(float z, float mu, float isg) {
  return __fmul_rn(__fsub_rn(z, mu), isg);
}

// e2 = e + rnd(xhat * scale + bias) before its final rounding (as bias_sum)
template <typename T>
__device__ __forceinline__ float e2_sum(float e, float xhat, float scale, float bias) {
  return e + rnd<T>(__fmaf_rn(xhat, scale, bias));
}

}  // namespace hgn
