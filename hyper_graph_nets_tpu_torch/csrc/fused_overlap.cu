// Fused edge block with a compute-overlapped banded ring (K7), for Hopper
// (sm_90a).
//
// Replaces hyper_graph_nets_tpu/ops/pallas/fused_overlap.py::_overlap_kernel
// (pallas_call at :390).  One kernel per rank of a group, each on the
// rank's stream and card, all launched by one C call, over the rank's edge
// shard of B frames: it computes the shard's e2 as K1 does (the same
// fwd_teams and fwd_tile, fused_block_fwd.cuh), its raw pna partials, and
// combines them over the ranks band by band while later work items still
// compute, then finalizes: agg = [sum | sum / max(cnt, 1) | max | min], 0
// where no rank has a valid edge.  Each frame (batch row) rings on its own,
// one pass after another with an epoch each, as the JAX kernel's grid
// (B, G) runs one ring pass per batch row; the compute teams walk the
// frames in order, so frame b's bands ring while frame b+1 computes.  On a
// 2-D group every sub-ring (the ranks that share a data coordinate) rings
// on its own, all launched by the one call.  e2 equals K1's on the same
// shard bit for bit; agg equals K1 raw + the plain all-reduce + finalize up to the
// float32 sum order of the raw partials (the ring folds the ranks in the
// JAX order).
//
// What bounds it.  Per rank at the main path's shard (2,560 edges, N =
// 1,600, L = 128, bf16): K1's traffic for the shard (e, SP, RP in, e2 and
// the [N, 4L] float32 partials out, about 5.3 MB) plus the ring's 2nP on
// P = 3.28 MB; the three L x L products are 0.25 GFLOP.  Bound by memory;
// on one card the ranks share its memory rate.
//
// Design.
// - The node rows are split into nb bands of rb rows (the wrapper splits
//   each of the plan's bands into sub-bands, so that about half a rank's
//   CTAs ring).  CTAs 0 .. nb-1 are the band rings; the others compute.
// - Compute CTAs run K1's teams (two of 8 warps sharing the staged weights
//   in bf16, one with the streamed weights in float32: fwd_teams), persistent over the work list the wrapper builds: the
//   groups of the shard's valid prefix (whole receiver segments, in receiver
//   order), then the padded tail (the trailing edges with mask 0) as e2-only
//   items of at most TILE edges with no receivers.  So the tail's padding
//   edges, all at receiver N-1, are no longer one team's serial chain in
//   front of the last band: receiver N-1's aggregate comes from its valid
//   edges alone (the same value bit for bit: masked edges are skipped, not
//   added as 0).  A team that finishes a group adds one to the counter of
//   every band the group's rows touch; with the round-robin edge layout
//   every rank's groups span all rows, so early bands complete while later
//   items compute.
// - Band b's CTA counts the groups that touch its rows, waits until its
//   counter reaches that count (and resets it for the next call), then runs
//   ring_run (ring_common.cuh) over its rows (columns [0, 2L) sum, [2L, 3L)
//   max, [3L, 4L) min), in chunks of whole rows held in the kernel's shared
//   memory, and finalizes each chunk there before its TMA copy to agg.  A
//   ring CTA computes nothing and uses all its threads for the ring.
// - Every CTA of every rank must be resident together (the band rings spin
//   on their neighbours): the wrapper keeps a rank's grid at most SMs /
//   (ranks on the card), ring CTAs included.  K1's shared memory means one
//   CTA per SM.

#include "fused_block_fwd.cuh"
#include "ring_common.cuh"

namespace {

using namespace hgn;
using namespace hgn_ring;

#ifndef HGN_RING_CHUNK  // a tuning build's (tools/torch_port/ring_sweep.py)
#define HGN_RING_CHUNK 16384
#endif
constexpr int CHUNK = HGN_RING_CHUNK;  // ring chunk: floats at most (64 KB)

struct OvArgs {
  int nb, rb;          // bands, rows per band (per frame)
  u64* flags_mine;     // [nb][FLAG_WORDS]
  u64* flags_left;
  u64* flags_right;
  float* slot_mine;    // [2][N * 4L]
  float* slot_right;
  unsigned* counters;  // [B][nb] groups finished per frame and band
  int n, rank;         // ranks on my sub-ring; my global rank (for the error word)
  u64 epoch;           // frame b's pass rings with epoch + b
  int* err;
  bool sys;  // the ranks span several cards or processes
};

// The finalize of a chunk of whole [N, 4L] rows in shared memory, by the
// ring's workers: the count columns become the mean, empty extrema 0; four
// floats a time, a row is L float4s.
template <int L>
struct Finalize {
  static constexpr bool active = true;
  __device__ void operator()(float* acc, size_t, int cnt, int wt, int nwk) const {
    float4* a4 = reinterpret_cast<float4*>(acc);
    for (int v = wt; v < cnt / 4; v += nwk) {
      const int c = (v % L) * 4;  // column of the vector's first float
      if (c < L) continue;
      float4 o = a4[v];
      if (c < 2 * L) {
        const float4 sm = a4[v - L / 4];
        o = make_float4(sm.x / fmaxf(o.x, 1.f), sm.y / fmaxf(o.y, 1.f), sm.z / fmaxf(o.z, 1.f),
                        sm.w / fmaxf(o.w, 1.f));
      } else if (c < 3 * L) {
        o = make_float4(o.x <= -BIG / 2 ? 0.f : o.x, o.y <= -BIG / 2 ? 0.f : o.y,
                        o.z <= -BIG / 2 ? 0.f : o.z, o.w <= -BIG / 2 ? 0.f : o.w);
      } else {
        o = make_float4(o.x >= BIG / 2 ? 0.f : o.x, o.y >= BIG / 2 ? 0.f : o.y,
                        o.z >= BIG / 2 ? 0.f : o.z, o.w >= BIG / 2 ? 0.f : o.w);
      }
      a4[v] = o;
    }
  }
};

template <typename T, int L>
__device__ void band_ring_row(const FwdArgs& args, const OvArgs& ov, unsigned char* smem, int b, int lo, int hi,
                              size_t off, int row, unsigned want) {
  const Ring R{ov.flags_mine + off, ov.flags_left + off, ov.flags_right + off, ov.slot_mine,
               ov.slot_right, (size_t)args.N * 4 * L, ov.n, ov.rank, b, ov.epoch + row, ov.err, ov.sys};
  unsigned* counter = ov.counters + (size_t)row * ov.nb + b;
  float* agg = args.agg + (size_t)row * args.N * 4 * L;
  // the band's compute in this frame: every group that touches its rows has counted
  auto wait_band = [&](RingClock& clk) {
    wait_ge<unsigned>(counter, want, R, W_BAND, -1);
    *reinterpret_cast<volatile unsigned*>(counter) = 0u;  // every increment is in
    clk.mark(P_BAND);
  };
  // chunks of whole rows: at most CHUNK floats, and NSTAGE stages and one
  // accumulator within the compute CTAs' shared memory
  constexpr size_t SMEM = FwdLayout<T, L, nteam<T>>::total;
  constexpr int ROW = 4 * L;
  constexpr int FIT = (int)((SMEM - BAR_BYTES) / sizeof(float) / (NSTAGE + 1)) / ROW * ROW;
  static_assert(FIT >= ROW, "a ring chunk of one row must fit beside the stages");
  constexpr int CAP = CHUNK < ROW ? ROW : CHUNK / ROW * ROW;
  constexpr int MAX_CHUNK = CAP < FIT ? CAP : FIT;
  const size_t e0 = (size_t)lo * ROW, e1 = (size_t)max(lo, hi) * ROW;
  ring_run<4>(R, smem, SMEM, agg, agg, e0, e1, ROW, MAX_CHUNK,
              [](size_t e) {
                const int c = (int)(e % ROW);
                return c < 2 * L ? (int)SUM : (c < 3 * L ? (int)MAX : (int)MIN);
              },
              Finalize<L>{}, wait_band);
}

template <typename T, int L>
__device__ void band_ring(const FwdArgs& args, const OvArgs& ov, unsigned char* smem) {
  const int b = blockIdx.x;
  const int lo = b * ov.rb, hi = min(args.N, lo + ov.rb);
  const size_t off = (size_t)b * FLAG_WORDS;
  unsigned want = 0;  // the groups that touch the band's rows, the same in every frame
  for (int g = 0; g < args.G; ++g) want += args.groups[g] < hi && args.groups[g + 1] > lo;
  for (int row = 0; row < args.B; ++row) {
    if (row > 0 && lo < hi) {  // the last pass's mbarriers, invalidated before ring_run initializes them again
      __syncthreads();
      if (threadIdx.x == 0) ring_smem_release(smem);
      __syncthreads();
    }
    band_ring_row<T, L>(args, ov, smem, b, lo, hi, off, row, want);
  }
}

template <typename T, int L>
__global__ void __launch_bounds__(nteam<T> * THREADS, 1) fused_overlap_kernel(const FwdArgs args,
                                                                              const OvArgs ov) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NTEAM = nteam<T>;
  if ((int)blockIdx.x < ov.nb) {
    band_ring<T, L>(args, ov, smem);
    return;
  }
  const int c = blockIdx.x - ov.nb, nc = gridDim.x - ov.nb;
  const long long t0 = compute_clock();
  unsigned items = 0;
  fwd_teams<T, L, NTEAM>(args, smem, c + (int)(threadIdx.x / THREADS) * nc, NTEAM * nc, [&](const Item& it) {
    ++items;
    if (it.n1 <= it.n0) return;  // a tail item: e2 only, no band
    __threadfence();             // this team's e2 and partials, before the count
    team_sync();
    if (team_tid() == 0)
      for (int b = it.n0 / ov.rb; b <= (it.n1 - 1) / ov.rb && b < ov.nb; ++b)
        atomicAdd(ov.counters + (size_t)it.b * ov.nb + b, 1u);
  });
  if (team_tid() == 0) compute_done(t0, items);
}

}  // namespace

// One rank's shard, buffers and neighbours (ops/fused_overlap.py builds one
// per rank of this process, in rank order; a neighbour in another process
// by the pointers its IPC handle opened on this rank's card, ring.cu).
// groups / group_edges are K7's work list (the valid prefix's groups, then
// the tail items), row_ptr the valid prefix's.
struct OvRank {
  const void* e;
  const void* sp;
  const void* rp;
  const void* we;
  const void* w2;
  const void* w3;
  const float* b1;
  const float* b2;
  const float* b3;
  const float* lns;
  const float* lnb;
  const int* senders;
  const int* receivers;
  const float* mask;
  const int* row_ptr;
  const int* groups;
  const int* group_edges;
  void* e2;
  float* agg;
  int E, G, grid;
  void* flags_mine;
  void* flags_left;
  void* flags_right;
  float* slot_mine;
  float* slot_right;
  unsigned* counters;
  int device;
  int rank;  // global rank, for the error word
  void* stream;
};

namespace {

template <typename T, int L>
int launch_group(int n, int ring_n, int B, const OvRank* ranks, int N, int nb, int rb, unsigned long long epoch,
                 int* err, bool sys) {
  int rc = 0;
  for (int r = 0; r < n && rc == 0; ++r) {
    const OvRank& k = ranks[r];
    cudaError_t e = cudaSetDevice(k.device);
    if (e != cudaSuccess) return (int)e;
    constexpr int NTEAM = nteam<T>;
    const int cap = fwd_grid_cap<T, L, NTEAM>(fused_overlap_kernel<T, L>);
    if (cap < 0) return -cap;
    if (k.grid <= nb || k.grid > cap) return -1;
    // B frames, raw partials, no streams
    const FwdArgs a{k.e, k.sp, k.rp, k.we, k.w2, k.w3, k.b1, k.b2, k.b3, k.lns, k.lnb, k.senders,
                    k.receivers, k.mask, k.row_ptr, k.groups, k.e2, k.agg, nullptr, nullptr, nullptr,
                    nullptr, B, k.E, N, k.G, 1, k.group_edges};
    const OvArgs ov{nb, rb, static_cast<u64*>(k.flags_mine), static_cast<u64*>(k.flags_left),
                    static_cast<u64*>(k.flags_right), k.slot_mine, k.slot_right, k.counters, ring_n, k.rank, epoch,
                    err, sys};
    fused_overlap_kernel<T, L>
        <<<k.grid, NTEAM * THREADS, FwdLayout<T, L, NTEAM>::total, static_cast<cudaStream_t>(k.stream)>>>(a, ov);
    rc = (int)cudaGetLastError();
  }
  return rc;
}

template <typename T>
int dispatch_width(int L, int n, int ring_n, int B, const OvRank* ranks, int N, int nb, int rb,
                   unsigned long long epoch, int* err, bool sys) {
  switch (L) {
    case 32: return launch_group<T, 32>(n, ring_n, B, ranks, N, nb, rb, epoch, err, sys);
    case 128: return launch_group<T, 128>(n, ring_n, B, ranks, N, nb, rb, epoch, err, sys);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Launch this process's ranks' K7 (B frames, [B][E][L]), the first entry
// first, each on its device and stream; n entries, each on a sub-ring of
// ring_n ranks (which may span processes; each entry names its sub-ring
// neighbours); dtype 0 = float32, 1 = bfloat16; sys: flags at system scope
// (the ranks span several cards or processes).  A rank's grid = nb band
// CTAs + its compute CTAs; its counters hold B * nb zeros; frame b rings
// with epoch + b.  Returns 0, a cudaError_t code, or -1 for arguments the
// kernel does not take.  A failed launch stops the loop: the ranks
// launched before it then fail through the error word.
int hgn_fused_overlap_group(int dtype, int L, int n, int ring_n, int B, const OvRank* ranks, int N, int nb,
                            int rb, unsigned long long epoch, int* err, int sys) {
  if (nb < 1 || rb < 1 || (long long)nb * rb < N || n < 1 || ring_n < 1 || B < 1) return -1;
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  int rc = -1;
  const bool scope = FORCE_SYS || sys != 0;
  if (dtype == 0) rc = dispatch_width<float>(L, n, ring_n, B, ranks, N, nb, rb, epoch, err, scope);
  if (dtype == 1) rc = dispatch_width<bf16>(L, n, ring_n, B, ranks, N, nb, rb, epoch, err, scope);
  cudaSetDevice(prev);
  return rc;
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
