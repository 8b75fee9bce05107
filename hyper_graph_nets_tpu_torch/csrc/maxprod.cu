// (max, x) semiring product for Hopper (sm_90a): K5.
//
// Replaces hyper_graph_nets_tpu/ops/pallas/maxprod.py::_maxprod_kernel (with
// its wrapper's padding and clamp).  For float32 x [N, K] and y [K, M], both
// non-negative, row-major and contiguous:
//
//   out[i, j] = max(0, max_k x[i, k] * y[k, j])
//
// Each product is one rounded multiply and max does not depend on order, so
// the result equals any other evaluation of the same products bit for bit
// (the plain version in ops/maxprod.py, the JAX package's maxprod).
//
// What bounds it.  The work is N * K * M products, each a multiply and a
// max: two float32 instructions outside the tensor cores (which cannot take
// a max in place of the sum).  At N = K = M = 1,600 (the balanced-Forman
// curvature of the 40 x 40 flag) that is 8.19e9 instructions, about 0.245 ms
// at the H100 SXM's 33.5e12 float32 instructions/s (the 67 TFLOP/s of its
// data sheet count a fused multiply-add as two operations); the 30.7 MB the
// function reads and writes take about 9 us.  So it is bound by issuing
// instructions: every instruction that is not a multiply or a max (shared
// loads, address arithmetic, barriers) and every cycle a warp waits on a
// load is time above the bound.
//
// Design.
// - One 256-thread block per 64 x 64 tile of out.  Each thread owns a 4 x 4
//   register tile: rows ty + 16 i (i < 4), columns 4 tx .. 4 tx + 3 (ty,
//   tx < 16).  Per four steps of k a thread issues 4 + 4 128-bit shared
//   loads for 128 float instructions.
// - The x tile is stored row-major ([64][BK + 4]), so a 16-byte load gives
//   one row's four k; a warp's x loads name two rows 1 apart (the padded
//   stride puts them in different banks) and are broadcasts.  The y tile is
//   row-major ([BK][64]); a quarter warp reads 128 consecutive bytes.
// - Both tiles arrive by cp.async (16 bytes, .cg) into two stages: step s+1's
//   copies are in flight while step s computes, and no value passes through
//   registers.  Shapes whose rows are not 16-byte aligned (K or M not a
//   multiple of 4) take 4-byte copies instead; copies past the edges of x or
//   y are zero-filled, and a product with 0 cannot change max(0, .): the
//   accumulator starts at 0, which is the clamp.
// - The grid: K is not split.  At N = M = 1,600 the 625 blocks run three to
//   an SM (about 80 registers a thread, 35 KB of shared memory; 24 warps),
//   1.58 waves over 132 SMs.  A sweep of layouts on the card found this one
//   the fastest: the same tile with 8 x 4 registers a thread runs as one
//   even wave of 5 blocks an SM (20 warps) and is slower, and splitting K
//   over 3 or 5 blocks that merge by atomicMax on the float bits (exact:
//   the products are non-negative) evens the waves but gains nothing.  So
//   the rate a warp slot issues at, not the balance of the waves, sets the
//   pace.
// - __fmul_rn keeps every product a single rounded multiply.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;    // rows of out per block
constexpr int BN = 64;    // columns of out per block
constexpr int BK = 32;    // k per stage
constexpr int THREADS = 256;
constexpr int TM = 4;     // rows per thread (stride NTY)
constexpr int TN = 4;     // consecutive columns per thread
constexpr int NTX = BN / TN;  // threads along a row of the tile
constexpr int NTY = BM / TM;  // threads along a column of the tile
constexpr int XLD = BK + 4;  // x tile row stride (floats): 16-byte rows, rows 1 apart in other banks
constexpr int MIN_BLOCKS = 3;  // per SM (about 80 registers a thread)
static_assert(NTX * NTY == THREADS, "one thread per 4 x 4 register tile");

struct Stage {
  float x[BM][XLD];
  float y[BK][BN];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Start the copies of the x tile (rows row0.., k k0..) and the y tile (k
// k0.., columns col0..) into st.  VEC: 16-byte copies (K and M multiples of
// 4, 16-byte aligned bases) or 4-byte ones.  Out of range: zero-filled, from
// a valid address.
template <bool VEC>
__device__ __forceinline__ void load_stage(Stage& st, const float* x, const float* y, int N, int K,
                                           int M, int row0, int col0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
#pragma unroll
    for (int p = 0; p < BM * BK / 4 / THREADS; ++p) {  // 2 per thread
      const int idx = tid + p * THREADS;
      const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
      const int gi = row0 + r, gk = k0 + c;
      const bool in = gi < N && gk < K;
      cp_async16(&st.x[r][c], in ? x + (size_t)gi * K + gk : x, in);
    }
#pragma unroll
    for (int p = 0; p < BK * BN / 4 / THREADS; ++p) {  // 2 per thread
      const int idx = tid + p * THREADS;
      const int r = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
      const int gk = k0 + r, gj = col0 + c;
      const bool in = gk < K && gj < M;
      cp_async16(&st.y[r][c], in ? y + (size_t)gk * M + gj : y, in);
    }
  } else {
#pragma unroll 4
    for (int p = 0; p < BM * BK / THREADS; ++p) {  // 8 per thread
      const int idx = tid + p * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gi = row0 + r, gk = k0 + c;
      const bool in = gi < N && gk < K;
      cp_async4(&st.x[r][c], in ? x + (size_t)gi * K + gk : x, in);
    }
#pragma unroll 4
    for (int p = 0; p < BK * BN / THREADS; ++p) {  // 8 per thread
      const int idx = tid + p * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gj = col0 + c;
      const bool in = gk < K && gj < M;
      cp_async4(&st.y[r][c], in ? y + (size_t)gk * M + gj : y, in);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
maxprod_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
               int N, int K, int M) {
  __shared__ __align__(16) Stage stages[2];
  const int tx = threadIdx.x % NTX, ty = threadIdx.x / NTX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;  // the clamp at 0

  const int steps = (K + BK - 1) / BK;
  if (steps > 0) load_stage<VEC>(stages[0], x, y, N, K, M, row0, col0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) load_stage<VEC>(stages[(s + 1) & 1], x, y, N, K, M, row0, col0, (s + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // step s's copies (this thread's) have landed
    __syncthreads();     // and every thread's
    const Stage& st = stages[s & 1];
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = *reinterpret_cast<const float4*>(&st.x[ty + NTY * i][k]);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b = *reinterpret_cast<const float4*>(&st.y[k + q][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float v = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaxf(acc[i][0], __fmul_rn(v, b.x));
          acc[i][1] = fmaxf(acc[i][1], __fmul_rn(v, b.y));
          acc[i][2] = fmaxf(acc[i][2], __fmul_rn(v, b.z));
          acc[i][3] = fmaxf(acc[i][3], __fmul_rn(v, b.w));
        }
      }
    }
    __syncthreads();  // stage s & 1 is free for step s + 2's copies
  }

  const int gj = col0 + tx * TN;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty + NTY * i;
    if (gi >= N) continue;
    float* o = out + (size_t)gi * M + gj;
    if (VEC && gj + TN <= M) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (gj + j < M) o[j] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x [N, K], y [K, M], out [N, M]: float32, row-major, contiguous.  Returns 0
// or a cudaError_t code.
int hgn_maxprod(const float* x, const float* y, float* out, int N, int K, int M, void* stream) {
  if (N == 0 || M == 0) return 0;
  const dim3 grid((M + BN - 1) / BN, (N + BM - 1) / BM);
  const bool vec = K % 4 == 0 && M % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    maxprod_kernel<true><<<grid, THREADS, 0, s>>>(x, y, out, N, K, M);
  } else {
    maxprod_kernel<false><<<grid, THREADS, 0, s>>>(x, y, out, N, K, M);
  }
  return (int)cudaGetLastError();
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
