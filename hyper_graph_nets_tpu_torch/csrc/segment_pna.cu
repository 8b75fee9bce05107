// Receiver-sorted pna aggregation for Hopper (sm_90a): forward (K4f) and
// backward (K4b), the aggregation of agg_vjp: sorted.
//
// Replaces hyper_graph_nets_tpu/ops/pallas/segment_pna.py::_fwd_kernel (K4f)
// and ::_bwd_kernel with its cotangent preparation in _pna_sorted_bwd (K4b).
// The valid edges (mask > 0) are non-decreasing in receiver; the host gives
// each receiver n a CSR range row_ptr[n]:row_ptr[n+1] that holds all its
// valid edges and may hold masked ones (a padded tail, or mesh edges the
// graph balancer removed); the edges [span, E) lie in no range.
//
//   K4f  out[b, n] = [sum | sum / max(cnt, 1) | max | min] over the valid
//        edges of the range, with sum = f32 sum of d * mask in edge order,
//        cnt = f32 sum of the mask, max/min over those edges; 0 for a
//        receiver without one; one rounding to the data's type.
//   K4b  ge[b, e] = ((g_sum + g_mean * inv) + [d == max] g_max
//                    + [d == min] g_min) * mask, in f32, one rounding to the
//        data's type, for a valid edge; inv = 1 / max(deg, 1), deg = the
//        count of the range's valid edges; the tie test compares the stored
//        edge value with the stored (rounded) max or min exactly, so every
//        tied edge gets the full cotangent.  Masked edges get 0.
//
// What bounds them.  Both are memory-bound: a handful of adds per element
// read.  At the flag main-path shapes (B = 21, E = 9,282, N = 1,600,
// L = 128, bf16) K4f reads 49.9 MB of edges and writes 34.4 MB, about
// 25 us at 3.35 TB/s; K4b reads 49.9 MB of edges, 34.4 MB of node
// cotangent and 17.2 MB of saved max/min and writes 49.9 MB, about 45 us.
// At B = 1 (rollout) K4f moves about 4 MB, about 1.2 us, and launch cost
// sets its time.
//
// Design (simple and right first).  None of the TPU kernel's devices carry
// over (one-hot MXU selection, segmented roll scans, chunk-transposed
// index layouts, aligned chunk reads with read-modify-write): a warp owns
// one (batch row, receiver) and walks that receiver's range, so a segment
// of any length lives in one warp, no scan depth is needed, and there are
// no atomics: runs repeat bit for bit.  Each lane owns VEC = 4 columns per
// 128-column stripe and reads them in one 8-byte (bf16) or 16-byte (f32)
// load, so a warp reads a 256-byte bf16 row at L = 128 in one transaction.
// Masked edges inside a range are skipped by a warp-uniform branch on the
// mask (K4f reads none of their rows; K4b writes them 0 and counts the valid
// edges first, one per lane, summed across the warp).  K4b reads its
// receiver's cotangent row and saved max/min once and writes each edge's
// row; the warps past B * N zero the edges past the span.  The f32
// steps use __fadd_rn / __fmul_rn so nvcc contracts nothing into an FMA,
// and the division is IEEE (no fast math).
// Later work: several receivers per warp at small L, prefetch of the next
// edge rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;
constexpr float BIG = 1e30f;

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load(const float* p, float v[VEC]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[VEC]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float v[VEC]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    v[0] = __low2float(lo);
    v[1] = __high2float(lo);
    v[2] = __low2float(hi);
    v[3] = __high2float(hi);
  }
  static __device__ __forceinline__ void store(bf16* p, const float v[VEC]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned int*>(&lo);
    raw.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS) pna_fwd_kernel(const T* __restrict__ data,
                                                          const int* __restrict__ row_ptr,
                                                          const float* __restrict__ mask,
                                                          T* __restrict__ out, int B, int E,
                                                          int N, int L) {
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long long)B * N) return;
  const int lane = threadIdx.x & 31;
  const int b = int(w / N), n = int(w - (long long)b * N);
  const int e0 = row_ptr[n], e1 = row_ptr[n + 1];
  const T* db = data + (size_t)b * E * L;
  T* ob = out + ((size_t)b * N + n) * 4 * L;
  for (int c = lane * VEC; c < L; c += 32 * VEC) {
    float sm[VEC], mx[VEC], mn[VEC], cnt = 0.f;
    bool any = false;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      sm[q] = 0.f;
      mx[q] = -BIG;
      mn[q] = BIG;
    }
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      const float m = mask ? mask[e] : 1.f;
      if (!(m > 0.f)) continue;  // the same for every lane
      any = true;
      float v[VEC];
      Io<T>::load(db + (size_t)e * L + c, v);
      cnt = __fadd_rn(cnt, m);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        sm[q] = __fadd_rn(sm[q], __fmul_rn(v[q], m));
        mx[q] = fmaxf(mx[q], v[q]);
        mn[q] = fminf(mn[q], v[q]);
      }
    }
    const float den = fmaxf(cnt, 1.f);
    float mean[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      mean[q] = __fdiv_rn(sm[q], den);
      if (!any) mx[q] = mn[q] = 0.f;
    }
    Io<T>::store(ob + c, sm);
    Io<T>::store(ob + L + c, mean);
    Io<T>::store(ob + 2 * L + c, mx);
    Io<T>::store(ob + 3 * L + c, mn);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) pna_bwd_kernel(
    const T* __restrict__ g, const T* __restrict__ out, const T* __restrict__ data,
    const int* __restrict__ row_ptr, const float* __restrict__ mask, T* __restrict__ ge, int B,
    int E, int N, int L, int span) {
  const int items = N + (E - span);  // receivers, then the edges past the span
  const long long w = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= (long long)B * items) return;
  const int lane = threadIdx.x & 31;
  const int b = int(w / items), i = int(w - (long long)b * items);
  T* geb = ge + (size_t)b * E * L;
  if (i >= N) {  // an edge of no receiver: its cotangent is 0
    const float zero[VEC] = {0.f, 0.f, 0.f, 0.f};
    T* row = geb + (size_t)(span + i - N) * L;
    for (int c = lane * VEC; c < L; c += 32 * VEC) Io<T>::store(row + c, zero);
    return;
  }
  const int e0 = row_ptr[i], e1 = row_ptr[i + 1];
  if (e0 == e1) return;
  int deg = 0;
  for (int e = e0 + lane; e < e1; e += 32) deg += (mask ? mask[e] > 0.f : true) ? 1 : 0;
  deg = __reduce_add_sync(0xffffffffu, deg);
  const float inv = __fdiv_rn(1.f, fmaxf(float(deg), 1.f));
  const T* gr = g + ((size_t)b * N + i) * 4 * L;
  const T* orow = out + ((size_t)b * N + i) * 4 * L;
  const T* db = data + (size_t)b * E * L;
  for (int c = lane * VEC; c < L; c += 32 * VEC) {
    float gs[VEC], gm[VEC], gmx[VEC], gmn[VEC], mx[VEC], mn[VEC], g1[VEC];
    Io<T>::load(gr + c, gs);
    Io<T>::load(gr + L + c, gm);
    Io<T>::load(gr + 2 * L + c, gmx);
    Io<T>::load(gr + 3 * L + c, gmn);
    Io<T>::load(orow + 2 * L + c, mx);
    Io<T>::load(orow + 3 * L + c, mn);
#pragma unroll
    for (int q = 0; q < VEC; ++q) g1[q] = __fadd_rn(gs[q], __fmul_rn(gm[q], inv));
#pragma unroll 4
    for (int e = e0; e < e1; ++e) {
      float d[VEC], v[VEC];
      const float m = mask ? mask[e] : 1.f;
      if (!(m > 0.f)) {  // a masked edge inside the range: 0
        const float zero[VEC] = {0.f, 0.f, 0.f, 0.f};
        Io<T>::store(geb + (size_t)e * L + c, zero);
        continue;
      }
      Io<T>::load(db + (size_t)e * L + c, d);
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        float x = __fadd_rn(g1[q], d[q] == mx[q] ? gmx[q] : 0.f);
        x = __fadd_rn(x, d[q] == mn[q] ? gmn[q] : 0.f);
        v[q] = mask ? __fmul_rn(x, m) : x;
      }
      Io<T>::store(geb + (size_t)e * L + c, v);
    }
  }
}

inline int blocks_for(long long warps) { return int((warps + WARPS - 1) / WARPS); }

template <typename T>
int launch_fwd(const void* data, const int* row_ptr, const float* mask, void* out, int B, int E,
               int N, int L, cudaStream_t s) {
  const long long warps = (long long)B * N;
  if (warps == 0) return 0;
  pna_fwd_kernel<T><<<blocks_for(warps), THREADS, 0, s>>>(
      static_cast<const T*>(data), row_ptr, mask, static_cast<T*>(out), B, E, N, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* out, const void* data, const int* row_ptr,
               const float* mask, void* ge, int B, int E, int N, int L, int span,
               cudaStream_t s) {
  const long long warps = (long long)B * (N + E - span);
  if (warps == 0) return 0;
  pna_bwd_kernel<T><<<blocks_for(warps), THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(out), static_cast<const T*>(data), row_ptr,
      mask, static_cast<T*>(ge), B, E, N, L, span);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; L a multiple of 4, every pointer
// 16-byte aligned; mask may be null (all valid).  Each returns 0, a
// cudaError_t code, or -1 for a dtype the kernels do not take.
int hgn_pna_sorted_fwd(int dtype, const void* data, const int* row_ptr, const float* mask,
                       void* out, int B, int E, int N, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(data, row_ptr, mask, out, B, E, N, L, s);
  if (dtype == 1) return launch_fwd<bf16>(data, row_ptr, mask, out, B, E, N, L, s);
  return -1;
}

int hgn_pna_sorted_bwd(int dtype, const void* g, const void* out, const void* data,
                       const int* row_ptr, const float* mask, void* ge, int B, int E, int N,
                       int L, int span, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(g, out, data, row_ptr, mask, ge, B, E, N, L, span, s);
  if (dtype == 1)
    return launch_bwd<bf16>(g, out, data, row_ptr, mask, ge, B, E, N, L, span, s);
  return -1;
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
