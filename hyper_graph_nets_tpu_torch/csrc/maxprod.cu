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
// function reads and writes take about 9 us.  So it is bound by operations.
//
// Design (simple and right first).  One 256-thread block per 64 x 64 tile of
// out; it walks K in steps of 16, staging a 64 x 16 tile of x (transposed,
// padded against bank conflicts) and a 16 x 64 tile of y in shared memory.
// Each thread owns a 4 x 4 register tile at a stride of 16 rows and columns,
// so a warp's shared loads are broadcasts or consecutive words.  The
// accumulator starts at -inf; loads past the edges of x or y give 0, whose
// products cannot change max(0, .); the store clamps at 0 and skips what
// lies outside out.  __fmul_rn keeps every product a single rounded
// multiply.  Later work: wider register tiles, vector shared loads and a
// double-buffered (cp.async) staging of the next K step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;   // rows of out per block
constexpr int BN = 64;   // columns of out per block
constexpr int BK = 16;   // K per staged step
constexpr int THREADS = 256;
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int STRIDE = 16;  // THREADS = (BM / TM) * (BN / TN), 16 x 16

__global__ void __launch_bounds__(THREADS)
maxprod_kernel(const float* __restrict__ x, const float* __restrict__ y, float* __restrict__ out,
               int N, int K, int M) {
  __shared__ float xs[BK][BM + 1];
  __shared__ float ys[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % STRIDE, ty = tid / STRIDE;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = -INFINITY;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: consecutive threads read consecutive k of one row
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gi = row0 + m, gk = k0 + k;
      xs[k][m] = (gi < N && gk < K) ? x[(size_t)gi * K + gk] : 0.f;
    }
    // y tile: consecutive threads read consecutive columns of one row
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gj = col0 + n;
      ys[k][n] = (gk < K && gj < M) ? y[(size_t)gk * M + gj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * STRIDE];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ys[k][tx + j * STRIDE];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaxf(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ty + i * STRIDE;
    if (gi >= N) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = col0 + tx + j * STRIDE;
      if (gj < M) out[(size_t)gi * M + gj] = fmaxf(acc[i][j], 0.f);
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
  maxprod_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, y, out, N, K, M);
  return (int)cudaGetLastError();
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
