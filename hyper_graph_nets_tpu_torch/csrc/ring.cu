// Ring all-reduce with per-row-segment combine (K6), for Hopper (sm_90a).
//
// Replaces hyper_graph_nets_tpu/ops/pallas/ring.py::ring_all_reduce_segments
// (its kernel at :60, pallas_call at :134).  Every rank of a group holds a
// float32 partial x_r [R, C]; each row segment (lo, hi, op) is combined
// over the ranks with sum, max or min, rows outside every segment keep
// x_r.  One C call launches every rank's kernel, each on that rank's stream
// and card, so the ranks start within microseconds of each other; the
// protocol is ring_common.cuh's.  Each rank folds x_r, x_{r-1}, ...,
// x_{r-n+1} in that order, as the JAX ring does, so the result equals the
// plain version (ops/ring.py) bit for bit.
//
// Along one axis of a 2-D group (the JAX package's mesh_axes): the call
// launches every rank of the group, and each rank's entry names its
// neighbours on its sub-ring (the ranks that share the other coordinate,
// ring_n of them); the sub-rings run side by side, each with its own flag
// rows, and each is the 1-D protocol over its ranks.
//
// What bounds it.  At the halo forward's payload ([4N, L] = [6,400, 128],
// P = 3.28 MB per rank) the work is data movement: the function reads n
// partials and writes n results (2nP over the group); the hop schedule
// moves, per rank, x read and out written and n-1 messages each written
// once and read once, 2nP again.  On one card the n ranks share its memory
// rate.
//
// Design.
// - The payload's float4s are split into `grid` contiguous sub-rings, one
//   CTA each; CTA c of every rank runs its own ring over its floats with its
//   own flag row, so no CTA waits for another CTA of its rank.  Sub-ring
//   bounds need not fall on rows: the op is looked up per float (per float4
//   when C % 4 == 0).
// - ring_run (ring_common.cuh): the accumulator in shared memory, a chunk
//   at a time signalled on its own, TMA bulk copies for x, the own slot and
//   out, one pass that folds each received chunk and forwards it.  Chunks
//   are at most CHUNK floats, made equal; a window is as many as SMEM holds.
//   Fewer, larger chunks won: each chunk costs the control thread a flag
//   round trip (tools/torch_port/ring_sweep.py times 16 KB against 64 KB).
// - Each rank's grid is at most SMs / (ranks on the card), one CTA per SM:
//   every CTA of every rank can be resident at once, which the spinning
//   needs.
// - The wrapper hands 16-byte aligned buffers whose float count is a
//   multiple of 4 (it pads an odd payload).

#include <cuda_runtime.h>

#include "ring_common.cuh"

namespace {

using namespace hgn_ring;

constexpr int THREADS = 512;            // the control warp and 15 worker warps
#ifndef HGN_RING_CHUNK  // a tuning build's (tools/torch_port/ring_sweep.py)
#define HGN_RING_CHUNK 16384
#endif
constexpr int CHUNK = HGN_RING_CHUNK;  // floats per chunk at most (64 KB)
constexpr size_t SMEM = 200 * 1024;     // stages and accumulators of one sub-ring
constexpr int MAX_SEGMENTS = 8;
constexpr int MAX_DEVICES = 64;

struct RingArgs {
  const float* x;  // [R][C] (padded to a multiple of 4 floats) my partial
  float* out;      // [R][C] my result
  int R, C;
  int nseg;
  int seg_lo[MAX_SEGMENTS], seg_hi[MAX_SEGMENTS], seg_op[MAX_SEGMENTS];
  u64* flags_mine;  // [grid][FLAG_WORDS]
  u64* flags_left;
  u64* flags_right;
  float* slot_mine;  // [2][P]
  float* slot_right;
  size_t P;  // floats per slot: R * C rounded up to 4
  int n, rank;  // ranks on my sub-ring; my rank in the group (for the error word)
  u64 epoch;
  int* err;
  bool sys;  // the ranks span several cards
};

template <int VEC>
__global__ void __launch_bounds__(THREADS, 1) ring_kernel(const RingArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int sub = blockIdx.x, subs = gridDim.x;
  const size_t nv = a.P / 4;
  const size_t e0 = 4 * (nv * sub / subs), e1 = 4 * (nv * (sub + 1) / subs);
  const size_t off = (size_t)sub * FLAG_WORDS;
  const Ring R{a.flags_mine + off, a.flags_left + off, a.flags_right + off, a.slot_mine,
               a.slot_right, a.P, a.n, a.rank, sub, a.epoch, a.err, a.sys};
  const int C = a.C;
  ring_run<VEC>(R, smem, SMEM, a.x, a.out, e0, e1, 4, CHUNK, [&](size_t e) {
    const int row = (int)(e / C);
    for (int k = 0; k < a.nseg; ++k)
      if (row >= a.seg_lo[k] && row < a.seg_hi[k]) return a.seg_op[k];
    return (int)KEEP;
  }, NoFinalize{}, NoWait{});
}

// The kernels' shared memory, set once per device ordinal.
int prepare(int dev) {
  static bool done[MAX_DEVICES] = {};
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (done[dev]) return 0;
  cudaError_t err = cudaFuncSetAttribute(ring_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ring_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  done[dev] = true;
  return 0;
}

}  // namespace

extern "C" {

// One rank's buffers and neighbours (ops/ring.py builds one per rank, in
// rank order).
struct RingRank {
  const float* x;
  float* out;
  void* flags_mine;
  void* flags_left;
  void* flags_right;
  float* slot_mine;
  float* slot_right;
  int device;
  void* stream;
};

// Launch every rank's K6, rank 0 first, each on its device and stream; n
// ranks in all, on sub-rings of ring_n (n a multiple of ring_n; each entry
// names its sub-ring neighbours).
// seg: nseg (lo, hi, op) triples on the host, op 0 sum, 1 max, 2 min;
// P: floats per payload, a multiple of 4 (R * C rounded up).  Returns 0, a
// cudaError_t code, or -1 for arguments the kernel does not take.  A failed
// launch stops the loop: the ranks launched before it then fail through the
// error word.
int hgn_ring_all_reduce_group(int n, int ring_n, const RingRank* ranks, int R, int C, unsigned long long P,
                              int nseg, const int* seg, unsigned long long epoch, int* err, int grid) {
  if (nseg < 0 || nseg > MAX_SEGMENTS || grid < 1 || n < 1 || ring_n < 1 || n % ring_n || P % 4 ||
      P < (unsigned long long)R * C)
    return -1;
  RingArgs a{};
  a.R = R;
  a.C = C;
  a.nseg = nseg;
  for (int k = 0; k < nseg; ++k) {
    a.seg_lo[k] = seg[3 * k];
    a.seg_hi[k] = seg[3 * k + 1];
    a.seg_op[k] = seg[3 * k + 2];
  }
  a.P = P;
  a.n = ring_n;
  a.epoch = epoch;
  a.err = err;
  a.sys = FORCE_SYS;
  for (int r = 0; r < n; ++r) a.sys |= ranks[r].device != ranks[0].device;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  int rc = 0;
  for (int r = 0; r < n && rc == 0; ++r) {
    const RingRank& k = ranks[r];
    if ((reinterpret_cast<uintptr_t>(k.x) | reinterpret_cast<uintptr_t>(k.out) |
         reinterpret_cast<uintptr_t>(k.slot_mine) | reinterpret_cast<uintptr_t>(k.slot_right)) % 16) {
      rc = -1;
      break;
    }
    if ((e = cudaSetDevice(k.device)) != cudaSuccess || (rc = prepare(k.device)) != 0) {
      rc = rc ? rc : (int)e;
      break;
    }
    a.x = k.x;
    a.out = k.out;
    a.flags_mine = static_cast<u64*>(k.flags_mine);
    a.flags_left = static_cast<u64*>(k.flags_left);
    a.flags_right = static_cast<u64*>(k.flags_right);
    a.slot_mine = k.slot_mine;
    a.slot_right = k.slot_right;
    a.rank = r;
    cudaStream_t s = static_cast<cudaStream_t>(k.stream);
    if (C % 4 == 0)
      ring_kernel<4><<<grid, THREADS, SMEM, s>>>(a);
    else
      ring_kernel<1><<<grid, THREADS, SMEM, s>>>(a);
    rc = (int)cudaGetLastError();
  }
  cudaSetDevice(prev);
  return rc;
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
