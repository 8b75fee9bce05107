// Shared device code of the fused edge-block kernels (K1 forward in
// fused_block_fwd.cu; K2 remat and K3 stream backward in fused_block_bwd.cu).
//
// The backward routes the max/min cotangent to the edges whose e2 equals the
// saved extremum exactly (the TPU kernel's tie_tol = 0).  That compare holds
// only if K2 recomputes, and K3 reconstructs, e2 bit for bit as K1 computed
// it.  So the whole forward chain lives here, once: the tile products (same
// k order; K2's and K3's half-tile products keep each element's chain:
// mma.sync m16n8k16 in bf16, an ordered fmaf chain in float32), the
// rounding points of each epilogue, and the LayerNorm statistics (same
// per-lane order, same warp_sum butterfly, explicit __fmaf_rn / __fmul_rn
// so that no compiler contraction can differ between the kernels).

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
// K2, K3 and K7's compute CTAs run two in bf16, one in float32: float32
// weights fill the shared memory a second team's tiles would need).  The
// tile code indexes threads and warps within its team and synchronizes only
// its team.
__device__ __forceinline__ int team_tid() { return threadIdx.x & (THREADS - 1); }

template <typename T>
constexpr int nteam = sizeof(T) == 2 ? 2 : 1;

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

// ---- float32 products on the CUDA cores, weights in shared memory ---------
//
// Every float32 product of K1, K2 and K3 sums each element in one fmaf chain
// over k in order 0 .. L-1 (the order of the TPU kernel's and the plain
// version's float32 dot product), so K2's and K3's recompute of a1, a2 and
// z3 is K1's bit for bit whichever thread holds the element.  A thread owns
// 4 rows x TN columns: lane (rg = lane & 3, cg = lane >> 2) of warp (wr, wc)
// holds rows 16*wr + 4*i + rg and, for a forward product (out = A @ W^T),
// columns wc*WC + cg + 8*j; for a transposed one (out = A @ W), columns
// wc*WC + 32*(j / 4) + 4*cg + j % 4 (TN of 4 or more; else wc*WC + TN*cg +
// j).  Each 4-k step loads a float4 of A per row and of W per column
// (forward: W's row c; transposed: four neighbouring columns of W's rows k
// .. k + 3), from shared memory without bank conflicts (A rows padded by 4;
// W swizzled by wswz): 4 + TN loads for 16 TN fmaf, eight steps unrolled.
// On an H100 the products ran at about half the FMA pipes' rate with two
// warps a scheduler; neither loading the next step's operands under this
// one's fmaf nor four warps with 8 x 8 tiles (the other four idle) was
// faster (PERF.md).

// A staged float32 weight keeps its [out][in] rows unpadded, the 16-byte
// chunks of row r permuted within each 32 columns: column c sits at
// c ^ wswz(r).  The 8 column groups' chunks of a forward product (rows c,
// c & 7 = cg) and the 8 neighbouring chunks of a row of a transposed one
// then fall on 32 different banks.
__device__ __forceinline__ int wswz(int r) { return ((r & 3) << 3) | (r & 4); }

// The columns of a lane of warp column wc0: tile_matmul_f32's layout
template <int TN, bool TRANS>
__device__ __forceinline__ int prod_col(int wc0, int cg, int j) {
  if constexpr (!TRANS) return wc0 + cg + 8 * j;
  if constexpr (TN >= 4) return wc0 + 32 * (j / 4) + 4 * cg + j % 4;
  return wc0 + TN * cg + j;
}

// out = A @ W^T (TRANS false) or A @ W (TRANS true) for ROWS x L of a
// float32 tile A (row stride L + 4) in the layout above.  W: wts.slab(h)
// returns slab h of the product (its columns h*KS .. +KS for a forward
// product, rows KS floats apart; the whole layer, rows L floats apart, for
// a transposed one: KS = L), waiting for it; wts.done() after the last.
// epi(r, c, acc) for each element, rows i then columns j; with SUM it
// returns the value stored, summed over the rows below `rows` into cs[j].
template <int L, int ROWS, bool TRANS, bool SUM, class Weights, class Epi>
__device__ __forceinline__ void tile_matmul_f32(const float* A, Weights& wts, int rows, Epi epi, float* cs) {
  constexpr int LD = L + Num<float>::PAD;
  constexpr int WR = ROWS / 16, WC = L / (WARPS / WR), TN = WC / 8;
  constexpr int KS = Weights::KS, NH = L / KS;
  static_assert(WR * (WARPS / WR) == WARPS && TN >= 1 && KS % 4 == 0, "the warps' tiles");
  static_assert(!TRANS || KS == L, "a transposed product reads the whole layer");
  static_assert(!TRANS || TN < 4 || TN % 4 == 0, "transposed columns come four at a time");
  const int warp = team_tid() >> 5, lane = threadIdx.x & 31;
  const int wr = warp % WR, wc0 = (warp / WR) * WC;
  const int rg = lane & 3, cg = lane >> 2;
  const int r0 = 16 * wr + rg;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int h = 0; h < NH; ++h) {
    const float* const W = wts.slab(h);
#pragma unroll 8
    for (int kk = 0; kk < KS; kk += 4) {
      const int k = h * KS + kk;
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (r0 + 4 * i) * LD + k);
      if constexpr (TRANS) {
        float w[4][TN];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* row = W + (k + q) * L;
          const int sw = wswz(k + q);
          if constexpr (TN >= 4) {
#pragma unroll
            for (int j = 0; j < TN; j += 4) {
              const float4 v = *reinterpret_cast<const float4*>(row + (prod_col<TN, true>(wc0, cg, j) ^ sw));
              w[q][j] = v.x;
              w[q][j + 1] = v.y;
              w[q][j + 2] = v.z;
              w[q][j + 3] = v.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < TN; ++j) w[q][j] = row[prod_col<TN, true>(wc0, cg, j) ^ sw];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float s = acc[i][j];
            s = fmaf(a[i].x, w[0][j], s);
            s = fmaf(a[i].y, w[1][j], s);
            s = fmaf(a[i].z, w[2][j], s);
            s = fmaf(a[i].w, w[3][j], s);
            acc[i][j] = s;
          }
      } else {
        float4 w[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = prod_col<TN, false>(wc0, cg, j);
          w[j] = *reinterpret_cast<const float4*>(W + c * KS + (kk ^ wswz(c)));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float s = acc[i][j];
            s = fmaf(a[i].x, w[j].x, s);
            s = fmaf(a[i].y, w[j].y, s);
            s = fmaf(a[i].z, w[j].z, s);
            s = fmaf(a[i].w, w[j].w, s);
            acc[i][j] = s;
          }
      }
    }
  }
  wts.done();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + 4 * i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = prod_col<TN, TRANS>(wc0, cg, j);
      if constexpr (SUM) {
        const float v = epi(r, c, acc[i][j]);
        if (r < rows) cs[j] += v;
      } else {
        epi(r, c, acc[i][j]);
      }
    }
  }
}

// ---- mbarriers for the float32 weights' cp.async copies -------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Arrive on bar once this thread's cp.async copies issued so far have
// landed (the barrier's count includes this arrival).
__device__ __forceinline__ void cp_async_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Copy rows of a float32 [out][in] weight (row stride L in device memory)
// into shared memory as the products read it: columns c0 .. c0 + KS of
// every row, row stride KS, swizzled by wswz; every thread of the team.
template <int L, int KS>
__device__ __forceinline__ void stage_weight_cols(float* dst, const float* w, int c0) {
  constexpr int CH = KS / 4;  // 16-byte chunks a row
  for (int i = team_tid(); i < L * CH; i += THREADS) {
    const int r = i / CH, c = (i - r * CH) * 4;
    cp_async16(dst + r * KS + (c ^ wswz(r)), w + (size_t)r * L + c0 + c);
  }
}

// Phase probe of a kernel built with its probe define (never the main
// path's build; ON false: no code): thread 0 of each team reads clock64 at
// the team barriers that end a tile's phases, adds each phase's cycles and
// its tile count, and at the end adds them into `out` (NP + 1 device
// counters) that the kernel's C reader returns and clears.
template <int NP, bool ON>
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void tile() {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

template <int NP>
struct PhaseClock<NP, true> {
  unsigned long long acc[NP];
  unsigned long long tiles;
  long long last;
  __device__ __forceinline__ void start() {
    for (int p = 0; p < NP; ++p) acc[p] = 0;
    tiles = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
  __device__ __forceinline__ void tile() { ++tiles; }
  __device__ __forceinline__ void flush(unsigned long long* out) {
    if (team_tid() != 0) return;
    for (int p = 0; p < NP; ++p) atomicAdd(&out[p], acc[p]);
    atomicAdd(&out[NP], tiles);
  }
};

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
