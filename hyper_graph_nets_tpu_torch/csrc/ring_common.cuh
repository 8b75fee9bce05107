// The ring protocol shared by K6 (ring.cu) and K7 (fused_overlap.cu).
//
// A rank group lives in one process; each rank has its own stream (and, on a
// node with several cards, its own card).  Every rank owns, per sub-ring:
// two comm slots (a region of its [2][P] float32 slot buffer) and a row of
// FLAG_WORDS flags in device memory: ready[2] ("your slot q holds hop s"),
// credit[2] ("you may write my slot q again") and two barrier words.  A rank
// writes into its right neighbour's slots with plain stores and publishes
// them with a release store on the neighbour's flag (st.release.sys: right
// across NVLink, and on one card where the "remote" slot is local memory).
//
// Hop schedule, the TPU kernel's (ops/pallas/ring.py:60-132): out = x_r; at
// step s = 0 .. n-2 rank r sends what it holds (x_r at step 0, then the
// slot it received at step s-1) to rank r+1 and folds the partial of rank
// r-1-s into out.  Every rank therefore folds in the order x_r, x_{r-1},
// ..., x_{r-n+1}, exactly as the JAX ring does on that device.
//
// Flags never reset.  Each call passes an epoch (the group's host counter,
// the same on every rank); a wait compares against epoch * STEP_SPAN + step,
// so a signal of an earlier call can never satisfy a later one.  The
// barrier (each rank tells both neighbours it has started this epoch, and
// waits for its right neighbour) keeps a rank from writing a neighbour's
// slots while that neighbour may still read them in the previous call.
// Every spin is bounded (SPIN_NS); on expiry the waiting thread writes what
// it waited for into a host-mapped error word and traps, so a launch that
// runs without its neighbours (serialized kernels) fails instead of hanging.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hgn_ring {

using u64 = unsigned long long;

constexpr int FLAG_WORDS = 8;  // flag row of one sub-ring
constexpr int READY = 0;       // [2]
constexpr int CREDIT = 2;      // [2]
constexpr int BAR_LEFT = 4;    // my left neighbour has started epoch e
constexpr int BAR_RIGHT = 5;   // my right neighbour has started epoch e
constexpr u64 STEP_SPAN = 256;  // more than the steps of a ring (n <= 255)
constexpr u64 SPIN_NS = 2000000000ull;

enum Op { KEEP = -1, SUM = 0, MAX = 1, MIN = 2 };
enum WaitKind { W_BARRIER = 1, W_CREDIT = 2, W_READY = 3, W_BAND = 4 };

// One CTA's sub-ring.
struct Ring {
  u64* mine;          // my flag row
  u64* left;          // the left neighbour's row of this sub-ring
  u64* right;         // the right neighbour's row
  float* slot_mine;   // my slot buffer [2][P]
  float* slot_right;  // the right neighbour's
  size_t P;           // floats per slot
  int n, rank, sub;
  u64 epoch;
  int* err;  // host-mapped [4]: what timed out, rank, step, sub-ring
};

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __noinline__ void fail(int* err, int kind, int rank, int step, int sub) {
  volatile int* e = err;
  e[1] = rank;
  e[2] = step;
  e[3] = sub;
  __threadfence_system();
  e[0] = kind;
  __threadfence_system();
  __trap();
}

// One thread waits until *p >= target, at most SPIN_NS.
template <typename W>
__device__ __forceinline__ void wait_ge(const W* p, W target, const Ring& R, int kind, int step) {
  if (ld_acquire(p) >= target) return;
  const u64 t0 = now_ns();
  while (ld_acquire(p) < target) {
    if (now_ns() - t0 > SPIN_NS) fail(R.err, kind, R.rank, step, R.sub);
    __nanosleep(64);
  }
}

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == SUM) return __fadd_rn(a, b);
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);  // NaN, as jnp.maximum gives
  if (op == MAX) return fmaxf(a, b);
  if (op == MIN) return fminf(a, b);
  return a;
}

// Tell both neighbours this sub-ring has started the epoch; wait until the
// right neighbour has too.  All threads call it; it ends in a barrier.
__device__ __forceinline__ void ring_barrier(const Ring& R) {
  if (threadIdx.x == 0) {
    st_release(R.right + BAR_LEFT, R.epoch);
    st_release(R.left + BAR_RIGHT, R.epoch);
    wait_ge<u64>(R.mine + BAR_RIGHT, R.epoch, R, W_BARRIER, -1);
  }
  __syncthreads();
}

// dst[v] = src[v] for vectors v in [v0, v1), this thread's share, UNROLL
// loads in flight before their stores (one CTA has to keep many bytes in
// flight to move them at a useful rate).
constexpr int UNROLL = 4;

template <typename V>
__device__ __forceinline__ void copy_range(V* dst, const V* src, size_t v0, size_t v1) {
  for (size_t v = v0 + threadIdx.x; v < v1; v += UNROLL * blockDim.x) {
    V t[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * blockDim.x < v1) t[u] = __ldcg(src + v + u * blockDim.x);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * blockDim.x < v1) __stcg(dst + v + u * blockDim.x, t[u]);
  }
}

__device__ __forceinline__ void combine_into(int op, float& a, float b) { a = combine(op, a, b); }

__device__ __forceinline__ void combine_into(int op, float4& a, const float4& b) {
  a.x = combine(op, a.x, b.x);
  a.y = combine(op, a.y, b.y);
  a.z = combine(op, a.z, b.z);
  a.w = combine(op, a.w, b.w);
}

// The n-1 hops over floats [e0, e1) of the payload (VEC floats at a time;
// e0, e1 and the buffers aligned to VEC): src0 is what step 0 sends, out
// the accumulator (already holding x_r), op_of(e) the combine of float e
// (the same for the VEC floats from e).  All threads call it.
template <int VEC, class OpOf>
__device__ __forceinline__ void ring_steps(const Ring& R, const float* src0, float* out, size_t e0,
                                           size_t e1, OpOf op_of) {
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  const u64 base = R.epoch * STEP_SPAN;
  const size_t v0 = e0 / VEC, v1 = e1 / VEC, PV = R.P / VEC;
  for (int s = 0; s + 1 < R.n; ++s) {
    const int send = s & 1, recv = (s + 1) & 1;
    const V* src = reinterpret_cast<const V*>(s == 0 ? src0 : R.slot_mine) + (s == 0 ? 0 : send * PV);
    V* dst = reinterpret_cast<V*>(R.slot_right) + recv * PV;
    if (s >= 1) {  // the right neighbour forwarded what it held in that slot
      if (threadIdx.x == 0) wait_ge<u64>(R.mine + CREDIT + recv, base + s - 1, R, W_CREDIT, s);
      __syncthreads();
    }
    copy_range(dst, src, v0, v1);
    __syncthreads();
    if (threadIdx.x == 0) {
      // the CTA's stores (ordered before this thread by the barrier), then
      // the flag: the release is cumulative
      __threadfence_system();
      st_release(R.right + READY + recv, base + s);
      // my slot `send` is read (forwarded, and folded at step s-1): the left
      // neighbour may write it at its step s+1
      if (s + 3 <= R.n) st_release(R.left + CREDIT + send, base + s);
      wait_ge<u64>(R.mine + READY + recv, base + s, R, W_READY, s);
    }
    __syncthreads();
    const V* in = reinterpret_cast<const V*>(R.slot_mine) + recv * PV;
    V* acc = reinterpret_cast<V*>(out);
    for (size_t v = v0 + threadIdx.x; v < v1; v += UNROLL * blockDim.x) {
      V a[UNROLL], b[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (v + u * blockDim.x < v1) {
          a[u] = __ldcg(acc + v + u * blockDim.x);
          b[u] = __ldcg(in + v + u * blockDim.x);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const size_t w = v + u * blockDim.x;
        if (w < v1) {
          const int op = op_of(w * VEC);
          if (op == KEEP) continue;
          combine_into(op, a[u], b[u]);
          __stcg(acc + w, a[u]);
        }
      }
    }
  }
}

}  // namespace hgn_ring
