// Fused MeshGraphNets edge block, forward (K1), for Hopper (sm_90a).
//
// Replaces hyper_graph_nets_tpu/ops/pallas/fused_block.py::_fwd_kernel
// (called through _fwd_call / fused_edge_block).  For receiver-sorted edges
// it computes, per batch element b:
//
//   h   = ((e @ We + SP[snd]) + RP[rcv]) + b1          (each add rounded)
//   z3  = relu(relu(h) @ W2 + b2) @ W3 + b3
//   e2  = e + LayerNorm(z3)                           (float32 statistics)
//   agg = [sum | sum / max(cnt, 1) | max | min] of e2 over each receiver's
//         valid edges, float32, 0 for a receiver with none
//
// with the rounding points of the TPU kernel: every product accumulates in
// float32 and is rounded to the compute type, bias adds run in the compute
// type, and the aggregate sums the rounded e2 in float32.  Masked edges get
// e2 and add nothing to any aggregate.  Optionally (save_streams, for the
// stream backward K3) it also writes a1 = relu(h), a2 = relu(z2) in the
// compute type and the LayerNorm mean and inverse sigma of each edge.  In
// raw mode (the TPU kernel's finalize=False, for an edge shard of the halo
// forward) agg holds [sum | cnt | max | min] with -BIG / +BIG where a
// receiver has no valid edge.
//
// What bounds it.  At the flag main-path shapes (E = 9,282 edges, N = 1,600
// nodes, L = 128, bf16) one frame reads e, SP, RP and writes e2 and agg:
// about 8.9 MB, 2.7 us at 3.35 TB/s (with the streams, 4.8 MB more); its
// three L x L products are 0.91 GFLOP, 0.9 us at 989 TFLOP/s.  So the
// kernel is bound by memory traffic.  The design keeps every intermediate
// (gathered rows, h, a1, a2, z3) in shared memory, so device memory sees
// each input once and each output once.
//
// Design.
// - The host splits the receivers into groups of whole segments holding at
//   most TILE edges and GROUP_NODES receivers each (a receiver with more
//   edges forms its own group and spans several tiles).  One work item is
//   (batch element, group); a plan over a valid prefix (the cluster-tier
//   sets) ends in groups of masked edges and no receiver, which get e2
//   only.  Because one team owns a group's segments, the
//   aggregate needs no atomics and no second pass, and the result does not
//   depend on scheduling.
// - bf16: two teams of 8 warps per CTA, one CTA per SM.  What sets K1's pace is
//   the chain of one tile's phases, each ended by a barrier (gather, three
//   products with their epilogues, LayerNorm, pna): with one team of 8
//   warps an SM sat idle through each phase's tail and each load's latency
//   (about 15 us a tile on an H100; a cp.async second buffer for one team
//   did not help, so the gather was not the cause).  Two teams share the staged
//   weights (104 KB in bf16 at L = 128) and each has its own tile buffers
//   (3 x 17 KB) and segment carry, 219 KB in all; each synchronizes only
//   itself (named barriers, team_sync), so one team's barrier waits, copies
//   and pna overlap the other's products.  Teams are persistent and stride
//   over work items; at 512 threads a thread has 128 registers.
// - Each team loads its next tile's indices while its tile computes and
//   copies the next tile's rows by cp.async (16 bytes, L2 only) into each
//   buffer as soon as it is free: RP rows into rT after the third product,
//   SP rows into xT after the LayerNorm, e rows into eT after the pna; the
//   next work item's edge range (the plan's group_edges) is read a tile
//   earlier still.  The prologue issues the
//   staged weights and both teams' first tiles together.
// - The grid: one CTA per SM, fewer when the work is small (ceil(work / 2)
//   CTAs), so that a frame (B = 1, about 150 items) runs each item on its
//   own team.
// - bf16: the products run on tensor cores with mma.sync m16n8k16 (bf16 in,
//   float32 accumulate) from the staged weights ([out][in], rows padded by
//   8), fragments by ldmatrix.  float32: on the CUDA cores, each element
//   one fmaf chain over k in order (the plain version's and the TPU
//   kernel's float32 order, kept bit for bit: tensor cores at float32
//   accuracy, 3xTF32, moved e2 by a few units in the last place from the
//   plain version's, and a long segment's float32 sum past the aggregate's
//   tolerance; PERF.md), 4 x 8 outputs a thread, operands by float4 from
//   shared memory (tile_matmul_f32, fused_block_common.cuh); one team a
//   CTA, its weights streamed through a ring of six 16 KB column slabs
//   (FwdWeights<float>, fused_block_fwd.cuh: 96 KB beside the team's 3 x
//   33 KB tiles, where the three layers' 192 KB would not fit), each slab
//   issued by cp.async when the product before frees its slot and waited
//   for by an mbarrier.  What bounds it: the 3 x 2 x B x E x L^2 operations
//   at the float32 FMA rate (257 us at cylinder's B = 16 on an H100).
// - The pna gives each receiver a half warp (16 receivers of a team at a
//   time) and loads four edges' rows before summing them in edge order.
// - The chain h -> a1 -> a2 -> z3 -> LayerNorm -> e2 is the shared code of
//   fused_block_common.cuh, which the backward kernels recompute with; a
//   tile is fwd_tile in fused_block_fwd.cuh, which K7 (fused_overlap.cu)
//   runs too.  So e2 is the same bit for bit in K1, K2's recompute and K7.
// - A segment that crosses a tile boundary carries its partial aggregate in
//   the team's shared memory (two slots, alternating by tile parity).
// Later work: wgmma (with K2/K3, whose recompute must stay bit for bit),
// TMA, a long segment's tiles spread over teams.
//
// Phase probe: -DHGN_FWD_PHASES builds a library of its own whose teams add
// each phase's cycles (fused_block_fwd.cuh) for hgn_fused_block_fwd_phases.

#include "fused_block_fwd.cuh"

namespace {

using namespace hgn;

template <typename T, int L>
__global__ void __launch_bounds__(nteam<T> * THREADS, 1) fused_block_fwd_kernel(const FwdArgs args) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NTEAM = nteam<T>;
  fwd_teams<T, L, NTEAM>(args, smem, blockIdx.x + (int)(threadIdx.x / THREADS) * gridDim.x, NTEAM * gridDim.x);
}

template <typename T, int L>
int launch(const FwdArgs& a, cudaStream_t stream) {
  constexpr int NTEAM = nteam<T>;  // teams of THREADS threads per CTA, each on its own tile
  const int grid_cap = fwd_grid_cap<T, L, NTEAM>(fused_block_fwd_kernel<T, L>);
  if (grid_cap < 0) return -grid_cap;
  const long long work = (long long)a.G * a.B;
  if (work == 0) return 0;
  if (work > 0x7fffffff || a.group_edges == nullptr) return -1;
  const int grid = (int)(work < (long long)NTEAM * grid_cap ? (work + NTEAM - 1) / NTEAM : grid_cap);
  fused_block_fwd_kernel<T, L>
      <<<grid, NTEAM * THREADS, FwdLayout<T, L, NTEAM>::total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(int L, const FwdArgs& a, cudaStream_t s) {
  switch (L) {
    case 32: return launch<T, 32>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  a1, a2, mu, isg are all null (no
// streams) or all set.  group_edges [G + 1] = row_ptr[groups].  Returns 0, a
// cudaError_t code, or -1 for arguments the kernel does not take.  raw = 1
// writes the unfinalized partials [sum | cnt | max (-BIG if none) | min
// (+BIG if none)].
int hgn_fused_block_fwd(int dtype, int L, const void* e, const void* sp, const void* rp,
                        const void* we, const void* w2, const void* w3, const float* b1,
                        const float* b2, const float* b3, const float* lns, const float* lnb,
                        const int* senders, const int* receivers, const float* mask,
                        const int* row_ptr, const int* groups, const int* group_edges, void* e2,
                        float* agg, void* a1, void* a2, float* mu, float* isg, int B, int E,
                        int N, int G, int raw, void* stream) {
  FwdArgs a{e,       sp,      rp,     we,  w2,  w3, b1, b2,  b3, lns, lnb, senders, receivers,
            mask,    row_ptr, groups, e2,  agg, a1, a2, mu,  isg, B, E,  N,   G,       raw,
            group_edges};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_width<float>(L, a, s);
  if (dtype == 1) return dispatch_width<bf16>(L, a, s);
  return -1;
}

// Phase probe: with HGN_FWD_PHASES, writes the cycles of each phase summed
// over every team's tiles since the last call, then the tile count, into
// out[0 .. n), clears them and returns the number of phases; without it, -1.
int hgn_fused_block_fwd_phases(unsigned long long* out, int n) {
#ifdef HGN_FWD_PHASES
  if (n < FWD_NPHASE + 1) return -1;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, hgn_fwd_phase_cycles, sizeof(unsigned long long) * (FWD_NPHASE + 1));
  const unsigned long long zero[FWD_NPHASE + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(hgn_fwd_phase_cycles, zero, sizeof(zero));
  return err == cudaSuccess ? FWD_NPHASE : -(int)err;
#else
  (void)out;
  (void)n;
  return -1;
#endif
}

// The probe's phase names, comma-separated (empty without the probe).
const char* hgn_fused_block_fwd_phase_names() {
#ifdef HGN_FWD_PHASES
  return HGN_FWD_PHASE_NAMES;
#else
  return "";
#endif
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
