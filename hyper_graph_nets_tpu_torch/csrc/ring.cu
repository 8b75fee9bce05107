// Ring all-reduce with per-row-segment combine (K6), for Hopper (sm_90a).
//
// Replaces hyper_graph_nets_tpu/ops/pallas/ring.py::ring_all_reduce_segments
// (its kernel at :60, pallas_call at :134).  Every rank of a group holds a
// float32 partial x_r [R, C]; each row segment (lo, hi, op) is combined
// over the ranks with sum, max or min, rows outside every segment keep
// x_r.  One launch per rank, on that rank's stream, all n enqueued before
// any host synchronization; the protocol is ring_common.cuh's.  Each rank
// folds x_r, x_{r-1}, ..., x_{r-n+1} in that order, as the JAX ring does, so
// the result equals the plain version (ops/ring.py) bit for bit.
//
// What bounds it.  At the halo forward's payload ([4N, L] = [6,400, 128],
// 3.28 MB per rank) the work is data movement: the function reads n
// partials and writes n results; the ring as built moves, per rank, x read
// and out written (2P) and at each of the n-1 hops P read and written to
// the neighbour, P read back and out read and written (5P).  On one card the
// n ranks share its memory rate.
//
// Design (simple and right first).
// - The rows are split into `grid` contiguous blocks, one CTA each; CTA c
//   of every rank runs its own sub-ring over its rows with its own flag
//   row, so no CTA waits for another CTA of its rank.
// - Each rank's grid is at most SMs / (ranks on the card): every CTA of
//   every rank can be resident at once, which the spinning needs.
// - Copies and folds go through L2 (__ldcg / __stcg): slots are written by
//   another SM or another card.
// Later work: TMA bulk copies, fewer fences, a fold fused into the copy.

#include <cuda_runtime.h>

#include "ring_common.cuh"

namespace {

using namespace hgn_ring;

constexpr int THREADS = 256;
constexpr int MAX_SEGMENTS = 8;

struct RingArgs {
  const float* x;  // [R][C] my partial
  float* out;      // [R][C] my result
  int R, C;
  int nseg;
  int seg_lo[MAX_SEGMENTS], seg_hi[MAX_SEGMENTS], seg_op[MAX_SEGMENTS];
  u64* flags_mine;  // [grid][FLAG_WORDS]
  u64* flags_left;
  u64* flags_right;
  float* slot_mine;  // [2][R * C]
  float* slot_right;
  int n, rank;
  u64 epoch;
  int* err;
};

template <int VEC>
__global__ void __launch_bounds__(THREADS) ring_kernel(const RingArgs a) {
  const int sub = blockIdx.x, subs = gridDim.x;
  const int r0 = (int)((long long)a.R * sub / subs), r1 = (int)((long long)a.R * (sub + 1) / subs);
  const size_t e0 = (size_t)r0 * a.C, e1 = (size_t)r1 * a.C;
  using V = typename std::conditional<VEC == 4, float4, float>::type;
  copy_range(reinterpret_cast<V*>(a.out), reinterpret_cast<const V*>(a.x), e0 / VEC, e1 / VEC);
  if (a.n < 2) return;
  const size_t off = (size_t)sub * FLAG_WORDS;
  const Ring R{a.flags_mine + off, a.flags_left + off, a.flags_right + off, a.slot_mine,
               a.slot_right, (size_t)a.R * a.C, a.n, a.rank, sub, a.epoch, a.err};
  ring_barrier(R);
  const int C = a.C;
  ring_steps<VEC>(R, a.x, a.out, e0, e1, [&](size_t e) {
    const int row = (int)(e / C);
    for (int k = 0; k < a.nseg; ++k)
      if (row >= a.seg_lo[k] && row < a.seg_hi[k]) return a.seg_op[k];
    return (int)KEEP;
  });
}

}  // namespace

extern "C" {

// seg: nseg (lo, hi, op) triples on the host, op 0 sum, 1 max, 2 min.
// Returns 0, a cudaError_t code, or -1 for arguments the kernel does not take.
int hgn_ring_all_reduce(const float* x, float* out, int R, int C, int nseg, const int* seg,
                        void* flags_mine, void* flags_left, void* flags_right, float* slot_mine,
                        float* slot_right, int n, int rank, unsigned long long epoch, int* err,
                        int grid, void* stream) {
  if (nseg < 0 || nseg > MAX_SEGMENTS || grid < 1 || n < 1 || n >= (int)STEP_SPAN) return -1;
  RingArgs a{};
  a.x = x;
  a.out = out;
  a.R = R;
  a.C = C;
  a.nseg = nseg;
  for (int k = 0; k < nseg; ++k) {
    a.seg_lo[k] = seg[3 * k];
    a.seg_hi[k] = seg[3 * k + 1];
    a.seg_op[k] = seg[3 * k + 2];
  }
  a.flags_mine = static_cast<u64*>(flags_mine);
  a.flags_left = static_cast<u64*>(flags_left);
  a.flags_right = static_cast<u64*>(flags_right);
  a.slot_mine = slot_mine;
  a.slot_right = slot_right;
  a.n = n;
  a.rank = rank;
  a.epoch = epoch;
  a.err = err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(slot_mine) |
                                  reinterpret_cast<uintptr_t>(slot_right)) % 16 == 0;
  if (vec)
    ring_kernel<4><<<grid, THREADS, 0, s>>>(a);
  else
    ring_kernel<1><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Let `dev` write into `peer`'s memory (a rank group over several cards).
int hgn_enable_peer_access(int dev, int peer) {
  int prev = 0, can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return -1;
  if ((err = cudaGetDevice(&prev)) != cudaSuccess) return (int)err;
  if ((err = cudaSetDevice(dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return (int)err;
}

// The device address of page-locked host memory (the ring's error word).
int hgn_host_device_pointer(void* host, void** device) {
  return (int)cudaHostGetDevicePointer(device, host, 0);
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
