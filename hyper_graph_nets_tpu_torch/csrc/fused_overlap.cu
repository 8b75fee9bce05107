// Fused edge block with a compute-overlapped banded ring (K7), for Hopper
// (sm_90a).
//
// Replaces hyper_graph_nets_tpu/ops/pallas/fused_overlap.py::_overlap_kernel
// (pallas_call at :390).  One launch per rank of a group, on the rank's
// stream, over the rank's edge shard (one frame): it computes the shard's e2
// as K1 does (the same fwd_item, fused_block_fwd.cuh), its raw pna partials,
// and combines them over the ranks while later groups still compute, then
// finalizes: agg = [sum | sum / max(cnt, 1) | max | min], 0 where no rank
// has a valid edge.  e2 equals K1's on the same shard bit for bit; agg
// equals K1 raw + the plain all-reduce + finalize up to the float32 sum
// order of the raw partials (the ring folds the ranks in the JAX order).
//
// What bounds it.  Per rank at the main path's shard (2,560 edges, N =
// 1,600, L = 128, bf16): K1's traffic for the shard (e, SP, RP in, e2 and
// the [N, 4L] float32 partials out, about 5.3 MB) plus the ring's (ring.cu)
// on 3.28 MB; the three L x L products are 0.25 GFLOP.  Bound by memory;
// on one card the ranks share its memory rate.
//
// Design.
// - The node rows are split into nb bands of rb rows (the wrapper splits
//   each of the plan's bands into sub-bands, so that about half a rank's
//   CTAs ring).  CTAs 0 .. nb-1 are the band rings, the others compute: persistent CTAs over the shard's
//   groups (whole receiver segments, in receiver order).  A compute CTA
//   that finishes a group adds one to the counter of every band the group's
//   rows touch; with the round-robin edge layout every rank's groups span
//   all rows, so early bands complete while later groups compute.
// - Band b's CTA signals its barrier at once, counts the groups that touch
//   its rows, waits until the counter reaches that count (and resets it for
//   the next call), then runs the ring of ring_common.cuh over its rows
//   (columns [0, 2L) sum, [2L, 3L) max, [3L, 4L) min) and finalizes them.
// - Every CTA of every rank must be resident together (the band rings spin
//   on their neighbours): the wrapper keeps a rank's grid at most SMs /
//   (ranks on the card).  K1's shared memory means one CTA per SM.
// - Copies, folds and the finalize keep UNROLL 16-byte loads in flight per
//   thread: a ring CTA alone has to move its band at a useful rate.
// Later work: pipelining hops of different bands, TMA bulk copies.

#include "fused_block_fwd.cuh"
#include "ring_common.cuh"

namespace {

using namespace hgn;
using namespace hgn_ring;

struct OvArgs {
  int nb, rb;          // bands, rows per band
  u64* flags_mine;     // [nb][FLAG_WORDS]
  u64* flags_left;
  u64* flags_right;
  float* slot_mine;    // [2][N * 4L]
  float* slot_right;
  unsigned* counters;  // [nb] groups finished per band
  int n, rank;
  u64 epoch;
  int* err;
};

template <typename T, int L>
__device__ void band_ring(const FwdArgs& args, const OvArgs& ov) {
  const int b = blockIdx.x;
  const int lo = b * ov.rb, hi = min(args.N, lo + ov.rb);
  if (lo >= hi) return;  // the same on every rank
  const size_t off = (size_t)b * FLAG_WORDS;
  const Ring R{ov.flags_mine + off, ov.flags_left + off, ov.flags_right + off, ov.slot_mine,
               ov.slot_right, (size_t)args.N * 4 * L, ov.n, ov.rank, b, ov.epoch, ov.err};
  if (ov.n > 1) ring_barrier(R);
  if (threadIdx.x == 0) {
    unsigned want = 0;
    for (int g = 0; g < args.G; ++g) want += args.groups[g] < hi && args.groups[g + 1] > lo;
    wait_ge<unsigned>(ov.counters + b, want, R, W_BAND, -1);
    *reinterpret_cast<volatile unsigned*>(ov.counters + b) = 0u;  // every increment is in
  }
  __syncthreads();
  const size_t e0 = (size_t)lo * 4 * L, e1 = (size_t)hi * 4 * L;
  ring_steps<4>(R, args.agg, args.agg, e0, e1, [](size_t e) {
    const int c = (int)(e % (4 * L));
    return c < 2 * L ? (int)SUM : (c < 3 * L ? (int)MAX : (int)MIN);
  });
  __syncthreads();
  // finalize, four floats at a time: the count columns become the mean,
  // empty extrema 0
  float4* agg4 = reinterpret_cast<float4*>(args.agg);
  const size_t v0 = e0 / 4, v1 = e1 / 4;  // a row is L float4s
  for (size_t v = v0 + threadIdx.x; v < v1; v += UNROLL * blockDim.x) {
    float4 x[UNROLL], sm[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t w = v + u * blockDim.x;
      const int c = (int)(w % L) * 4;  // column of the vector's first float
      if (w < v1 && c >= L) x[u] = __ldcg(agg4 + w);
      if (w < v1 && c >= L && c < 2 * L) sm[u] = __ldcg(agg4 + w - L / 4);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t w = v + u * blockDim.x;
      const int c = (int)(w % L) * 4;
      if (w >= v1 || c < L) continue;
      float4 o = x[u];
      if (c < 2 * L) {
        o = make_float4(sm[u].x / fmaxf(o.x, 1.f), sm[u].y / fmaxf(o.y, 1.f),
                        sm[u].z / fmaxf(o.z, 1.f), sm[u].w / fmaxf(o.w, 1.f));
      } else if (c < 3 * L) {
        o = make_float4(o.x <= -BIG / 2 ? 0.f : o.x, o.y <= -BIG / 2 ? 0.f : o.y,
                        o.z <= -BIG / 2 ? 0.f : o.z, o.w <= -BIG / 2 ? 0.f : o.w);
      } else {
        o = make_float4(o.x >= BIG / 2 ? 0.f : o.x, o.y >= BIG / 2 ? 0.f : o.y,
                        o.z >= BIG / 2 ? 0.f : o.z, o.w >= BIG / 2 ? 0.f : o.w);
      }
      __stcg(agg4 + w, o);
    }
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) fused_overlap_kernel(const FwdArgs args,
                                                                   const OvArgs ov) {
  if ((int)blockIdx.x < ov.nb) {
    band_ring<T, L>(args, ov);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const FwdSmem<T> s = fwd_setup<T, L>(args, smem);
  const int stride = gridDim.x - ov.nb;
  for (int g = blockIdx.x - ov.nb; g < args.G; g += stride) {
    fwd_item<T, L>(args, s, 0, g);
    __threadfence();  // this CTA's e2 and partials, before the count
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n0 = args.groups[g], n1 = args.groups[g + 1];
      for (int b = n0 / ov.rb; b <= (n1 - 1) / ov.rb && b < ov.nb; ++b) atomicAdd(ov.counters + b, 1u);
    }
  }
}

template <typename T, int L>
int launch(const FwdArgs& a, const OvArgs& ov, int grid, cudaStream_t stream) {
  const int cap = fwd_grid_cap<T, L>(fused_overlap_kernel<T, L>);
  if (cap < 0) return -cap;
  if (grid <= ov.nb || grid > cap) return -1;
  fused_overlap_kernel<T, L><<<grid, THREADS, FwdLayout<T, L>::total, stream>>>(a, ov);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(int L, const FwdArgs& a, const OvArgs& ov, int grid, cudaStream_t s) {
  switch (L) {
    case 32: return launch<T, 32>(a, ov, grid, s);
    case 128: return launch<T, 128>(a, ov, grid, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// One frame (B = 1) of the rank's shard; dtype 0 = float32, 1 = bfloat16.
// grid = nb band CTAs + the compute CTAs.  Returns 0, a cudaError_t code,
// or -1 for arguments the kernel does not take.
int hgn_fused_overlap(int dtype, int L, const void* e, const void* sp, const void* rp,
                      const void* we, const void* w2, const void* w3, const float* b1,
                      const float* b2, const float* b3, const float* lns, const float* lnb,
                      const int* senders, const int* receivers, const float* mask,
                      const int* row_ptr, const int* groups, void* e2, float* agg, int E, int N,
                      int G, int nb, int rb, void* flags_mine, void* flags_left,
                      void* flags_right, float* slot_mine, float* slot_right, unsigned* counters,
                      int n, int rank, unsigned long long epoch, int* err, int grid,
                      void* stream) {
  if (nb < 1 || rb < 1 || (long long)nb * rb < N || n < 1 || n >= (int)STEP_SPAN) return -1;
  FwdArgs a{e,       sp,      rp,     we, w2,  w3,      b1,      b2,      b3, lns, lnb, senders,
            receivers, mask,  row_ptr, groups, e2, agg, nullptr, nullptr, nullptr, nullptr,
            1,       E,       N,      G,  1};
  OvArgs ov{nb,
            rb,
            static_cast<u64*>(flags_mine),
            static_cast<u64*>(flags_left),
            static_cast<u64*>(flags_right),
            slot_mine,
            slot_right,
            counters,
            n,
            rank,
            epoch,
            err};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_width<float>(L, a, ov, grid, s);
  if (dtype == 1) return dispatch_width<bf16>(L, a, ov, grid, s);
  return -1;
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
