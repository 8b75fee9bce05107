// Fused MeshGraphNets edge block, backward, for Hopper (sm_90a):
// K2 (remat) and K3 (stream).
//
// Replaces hyper_graph_nets_tpu/ops/pallas/fused_block.py::_bwd_kernel (K2)
// and ::_bwd_stream_kernel (K3), with their helpers _route_agg_cotangent,
// _ln_mlp_backward, _accumulate_node_cotangents and _accumulate_dpar.  Per
// batch element and receiver-sorted edge, given the cotangent de2 of e2
// (compute type) and drhs = [g_sum + g_mean/deg | max | g_max | min | g_min]
// per receiver (float32, the saved finalized aggregate beside its
// cotangent):
//
//   K2 recomputes h, a1, a2, z3 and the LayerNorm statistics with K1's own
//   code (fused_block_common.cuh), so e2 is bit for bit K1's; K3 reads K1's
//   saved a1, a2, mu, isg and recomputes only z3 = a2 @ W3 + b3.  Then
//   route = g1 + (e2 ~ max ? g_max : 0) + (e2 ~ min ? g_min : 0)
//           on valid edges (every tied edge gets the full cotangent), else 0,
//           where a ~ m is a == m or |a - m| <= tie_tol * |m| + tie_tol
//           (_route_agg_cotangent): tie_tol 0, the exact compare, after K1;
//           above 0 after a forward that was not this recompute (the
//           hybrid's unfused forward, whose e2 differs in the last ulps)
//   do    = de2 + route                                   (float32)
//   dz3   = ((do*s - mean(do*s) - xhat*mean(do*s*xhat)) * isg)  -> compute type
//   dz2   = [a2 > 0] * rnd(dz3 @ W3)                      (W in [out][in])
//   dh    = [a1 > 0] * rnd(dz2 @ W2)
//   de    = rnd(do + dh @ We)
//   drp[n] = sum of dh over the valid edges received by n       (float32)
//   dsp[n] = sum of dh over the valid edges sent by n           (float32)
//   dpar  = column sums over all edges of dh, dz2, dz3, do*xhat, do
// and writes the streams de, dh, dz2, dz3 (and, K2, a1, a2) in the compute
// type, from which the caller takes the weight gradients e^T dh, a1^T dz2,
// a2^T dz3.
//
// What bounds it.  At the flag main path (E = 9,282, N = 1,600, L = 128,
// bf16) one frame of K2 reads e, de2, SP, RP and drhs and writes six edge
// streams and dsp, drp: about 25.6 MB, 7.6 us at 3.35 TB/s, against six
// L x L products, 1.8 GFLOP, 1.8 us at 989 TFLOP/s; K3 reads a1, a2 and the
// statistics instead of SP, RP and writes four streams.  Both are bound by
// memory traffic; every intermediate stays in shared memory.
//
// Design.
// - Work items as in K1: one (batch element, group of whole receiver
//   segments) per team at a time, so gathering drhs and summing drp need no
//   atomics; a segment longer than a half tile carries its partial drp
//   across half tiles (and, for a receiver of more than 64 edges, across
//   the tiles of its item).  Empty groups are skipped; the sender-sum
//   kernel writes the zero drp rows of receivers without edges.  A plan
//   over a valid prefix (the cluster-tier sets) ends in receiver-less
//   groups of masked edges, from row_ptr[N] on: they get their edge
//   streams and no drp row, and read no drhs row.
// - Two teams of 8 warps per CTA, one CTA per SM, sharing the staged
//   weights (104 KB in bf16 at L = 128), each on its own work item with its
//   own buffers, synchronizing by named barriers (team_sync): a tile is a
//   chain of barrier-separated phases, and one team of 8 warps an SM left
//   the SM idle through each phase's latency (with one team and 64-row
//   tiles the phase probe below put 36% of a tile in the row pass, a
//   device-memory round trip per row, and 28% in serial column sums;
//   PERF.md).  A team walks its item in 32-row half
//   tiles so that two teams fit: per team three compute-type tiles (e / dz3,
//   SP / a1 / dh, RP / a2 / dz2; 8.5 KB each), one float32 tile of do whose
//   rows hold z3 and de2 side by side until the row pass turns them into do
//   (bf16; 16.5 KB), the drhs rows of the half tile's first RS receivers (7
//   at L = 128 in bf16, 17.5 KB; a flag half tile spans 5-9), indices and
//   the drp carry: 61 KB, 227 KB in all.  At 512 threads a thread has 128
//   registers: ptxas (CUDA 12.8) uses all 128 for bf16 at L = 128 and
//   spills 8 bytes.
// - Each half tile's rows arrive by cp.async in two groups: e and the SP/RP
//   gather (or K3's a1, a2), which the products wait for, then de2 and the
//   drhs rows, which land under the forward products; the next half tile's
//   indices are read into registers during this one.  So the row pass
//   reads only shared memory (a row whose receiver lies past the staged
//   ones reads drhs from device memory).
// - The products: mma.sync m16n8k16 (bf16 in, float32 accumulate) over the
//   half tile, warp (wm, wn) owning 16 rows and L/4 columns, fragments by
//   ldmatrix; float32: ordered fmaf, thread (warp, lane) owning 4 rows and
//   L/32 columns.  Each element sums over k in the same order, with the same
//   epilogue rounding (layer1_value, bias_sum, rnd), as K1's tile code, so
//   K2's recomputed a1, a2, z3 and e2 are K1's bit for bit whichever warp
//   computes them: K2 routes by exact compares with e2.  The backward
//   products likewise sum each element over k in order, so de, dh, dz2,
//   dz3 do not depend on the warp layout either.
// - dpar is folded into the passes that hold the values: the row pass keeps
//   per-lane partials of dz3, do*xhat and do; the dz2 and dh epilogues sum
//   their warp's rows and reduce-scatter over the lanes, leaving one column
//   a lane.  At the end a CTA adds its teams' and warps' partials in a fixed
//   order into one row of dpar_part, and a third kernel adds the rows in
//   order: deterministic for a given grid.
// - drp: one warp per run of equal receivers in the half tile (a ballot over
//   its 32 rows), summing dh in edge order.  dsp: a second kernel sums the
//   dh stream over a host-built sender CSR, one warp per (batch element,
//   node), in edge order.
// - Rows of a partial half tile past its end hold stale data; every product
//   is row-wise, and no such row is stored or summed.
// Later work: wgmma for the backward products (not bound to K1's chain),
// TMA, the next half tile's rows in flight under this one's backward (the
// probe's load phase).

#include <type_traits>

#include "fused_block_common.cuh"

namespace {

using namespace hgn;

constexpr int NTEAM = 2;           // teams of THREADS threads per CTA, each on its own work item
constexpr int HT = 32;             // rows of a half tile
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a CTA may use on sm_90
static_assert(THREADS == 8 * HT, "eight threads per row in a half tile's loads");
static_assert(HT == 32, "the drp pass finds a half tile's receiver runs by one ballot");

struct BwdArgs {
  const void* e;       // [B][E][L] compute type
  const void* sp;      // [B][N][L] (K2)
  const void* rp;      // [B][N][L] (K2)
  const void* a1_in;   // [B][E][L] (K3)
  const void* a2_in;   // [B][E][L] (K3)
  const float* mu_in;  // [B][E] (K3)
  const float* isg_in;  // [B][E] (K3)
  const void* we;      // [L][L] compute type, [out][in]
  const void* w2;
  const void* w3;
  const float* b1;  // [L]
  const float* b2;
  const float* b3;
  const float* lns;
  const float* lnb;
  const void* de2;     // [B][E][L] compute type
  const float* drhs;   // [B][N][5L]
  const int* senders;    // [E]
  const int* receivers;  // [E], non-decreasing
  const float* mask;     // [E] or null
  const int* row_ptr;      // [N + 1]
  const int* group_edges;  // [G + 1] edge boundaries of the work groups
  const int* snd_perm;   // [E] edge ids ordered by sender
  const int* snd_ptr;    // [N + 1] into snd_perm
  void* de;              // [B][E][L] compute type
  void* dh;
  void* dz2;
  void* dz3;
  void* a1_out;          // [B][E][L] (K2)
  void* a2_out;          // (K2)
  float* dsp;            // [B][N][L]
  float* drp;            // [B][N][L]
  float* dpar;           // [5][L]
  float* dpar_part;      // [grid][5][L] scratch
  int B, E, N, G;
  float tie_tol;         // max/min winners within tie_tol * |m| + tie_tol of m
};

// Whether e2 value a wins the extremum m: equal, or within the tolerance,
// each operation rounded on its own (no contraction), as the plain version
// computes it.
__device__ __forceinline__ bool ties(float a, float m, float tol) {
  return a == m || fabsf(__fsub_rn(a, m)) <= __fadd_rn(__fmul_rn(tol, fabsf(m)), tol);
}

// Phase probe (HGN_BWD_PHASES, never set by the main path's build): thread 0
// of each team reads clock64 at the team barriers that end a half tile's
// phases and adds each phase's cycles, and its half-tile count, into a
// device array that hgn_fused_block_bwd_phases reads and clears.  With the
// probe, the wait for de2 and the drhs rows after the forward products
// ("wait") and the tail's drp pass and stores get barriers of their own;
// "end" is a team's wait for the other at the CTA's last barrier.
#ifdef HGN_BWD_PHASES
#define HGN_BWD_PHASE_NAMES "load,fwd,wait,row,bwd,drp,store,de,end"
constexpr int NPHASE = 9;
__device__ unsigned long long hgn_bwd_phase_cycles[NPHASE + 1];
struct PhaseClock {
  unsigned long long acc[NPHASE];
  unsigned long long tiles;
  long long last;
  __device__ __forceinline__ void start() {
    for (int p = 0; p < NPHASE; ++p) acc[p] = 0;
    tiles = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
  __device__ __forceinline__ void tile() { ++tiles; }
  __device__ __forceinline__ void flush() {
    if (team_tid() != 0) return;
    for (int p = 0; p < NPHASE; ++p) atomicAdd(&hgn_bwd_phase_cycles[p], acc[p]);
    atomicAdd(&hgn_bwd_phase_cycles[NPHASE], tiles);
  }
};
#define PROBE_SPLIT() team_sync()
#else
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void tile() {}
  __device__ __forceinline__ void flush() {}
};
#define PROBE_SPLIT() ((void)0)
#endif

// Shared memory: the staged weights (bf16) and parameters, shared by the
// teams, then each team's buffers.
template <typename T, int L>
struct BwdLayout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LDT = L + Num<T>::PAD;  // compute-type tile row stride
  static constexpr int LDF = L + 4;            // float32 tile row stride
  // z3 (and, bf16, de2 beside it) live in the rows of the do tile: row
  // stride in compute-type elements
  static constexpr int LDZ = LDF * int(sizeof(float) / sizeof(T));
  static constexpr int LDW = L + 8;
  static constexpr size_t w_bytes = kBf16 ? align16(size_t(3) * L * LDW * sizeof(bf16)) : 0;
  static constexpr size_t prm_bytes = align16(size_t(5) * L * sizeof(float));
  static constexpr size_t tile_bytes = align16(size_t(HT) * LDT * sizeof(T));
  static constexpr size_t ftile_bytes = align16(size_t(HT) * LDF * sizeof(float));
  static constexpr size_t d2_bytes = kBf16 ? 0 : ftile_bytes;  // float32: de2 has its own tile
  static constexpr size_t idx_bytes = align16(size_t(5) * HT * sizeof(int));
  static constexpr size_t carry_bytes = align16(size_t(2) * L * sizeof(float));
  static constexpr size_t fixed_bytes =
      3 * tile_bytes + ftile_bytes + d2_bytes + idx_bytes + carry_bytes;
  static constexpr size_t drhs_row = size_t(5) * L * sizeof(float);
  static constexpr size_t spare = SMEM_MAX - w_bytes - prm_bytes - NTEAM * fixed_bytes;
  // receivers of a half tile whose drhs rows are staged
  static constexpr int RS = spare / NTEAM / drhs_row < HT ? int(spare / NTEAM / drhs_row) : HT;
  static constexpr size_t team_bytes = fixed_bytes + RS * drhs_row;
  static constexpr size_t total = w_bytes + prm_bytes + NTEAM * team_bytes;
  // the dpar partials of every team and warp, combined at the end over the
  // teams' buffers
  static constexpr int SLOTS = NTEAM * WARPS;
  static_assert(RS >= 1 && total <= size_t(SMEM_MAX), "two teams must fit");
  static_assert(size_t(5) * SLOTS * L * sizeof(float) <= NTEAM * team_bytes,
                "the dpar partials must fit in the teams' buffers");
};

// One team's view of the CTA's shared arrays.
template <typename T>
struct BwdSmem {
  bf16* Ws;      // staged weights (bf16 only), shared by the teams
  float* prm;    // b1 b2 b3 (rounded), lns, lnb, shared by the teams
  T* eT;         // e, then dz3
  T* xT;         // SP rows (K2) or a1 (K3), a1, then dh
  T* rT;         // RP rows (K2) or a2 (K3), a2, then dz2
  float* doT;    // do = de2 + route; before the row pass its rows hold z3 (zT)
  T* zT;         // z3, row stride LDZ, inside doT's rows
  T* d2T;        // de2, row stride LDZ (bf16: beside z3 in doT's rows)
  float* drhsT;  // drhs rows of receivers n_lo .. n_lo + RS
  int* snd_s;
  int* rcv_s;
  float* val_s;
  float* mu_s;   // K3's saved statistics
  float* isg_s;
  float* carry;  // 2 x [drp partial L]
};

template <typename T, int L>
__device__ __forceinline__ BwdSmem<T> bwd_carve(unsigned char* smem, int team) {
  using Lay = BwdLayout<T, L>;
  BwdSmem<T> s;
  s.Ws = reinterpret_cast<bf16*>(smem);
  s.prm = reinterpret_cast<float*>(smem + Lay::w_bytes);
  unsigned char* g = smem + Lay::w_bytes + Lay::prm_bytes + team * Lay::team_bytes;
  s.eT = reinterpret_cast<T*>(g);
  s.xT = reinterpret_cast<T*>(g + Lay::tile_bytes);
  s.rT = reinterpret_cast<T*>(g + 2 * Lay::tile_bytes);
  g += 3 * Lay::tile_bytes;
  s.doT = reinterpret_cast<float*>(g);
  s.zT = reinterpret_cast<T*>(g);
  s.d2T = Lay::kBf16 ? s.zT + L : reinterpret_cast<T*>(g + Lay::ftile_bytes);
  g += Lay::ftile_bytes + Lay::d2_bytes;
  s.snd_s = reinterpret_cast<int*>(g);
  s.rcv_s = s.snd_s + HT;
  s.val_s = reinterpret_cast<float*>(s.rcv_s + HT);
  s.mu_s = s.val_s + HT;
  s.isg_s = s.mu_s + HT;
  g += Lay::idx_bytes;
  s.carry = reinterpret_cast<float*>(g);
  s.drhsT = reinterpret_cast<float*>(g + Lay::carry_bytes);
  return s;
}

// A half tile: edges ts .. te of work item w (batch element b, edges e0 ..
// e1), w < 0 when there is none; the receivers of edges ts - 1 and te within
// the item (else -1), of ts and te - 1; and this thread's row of it (row
// team_tid() / 8): its sender, receiver, mask and (K3) saved statistics.
struct Half {
  int w, b, e0, e1, ts, te;
  int r_prev, r_next, n_lo, n_hi;
  int snd, rcv;
  float val, mu, isg;
};

template <bool STREAM>
__device__ __forceinline__ Half load_half(const BwdArgs& a, int w, int b, int e0, int e1, int ts) {
  Half h;
  h.w = w;
  h.b = b;
  h.e0 = e0;
  h.e1 = e1;
  h.ts = ts;
  h.te = min(ts + HT, e1);
  h.r_prev = ts > e0 ? a.receivers[ts - 1] : -1;
  h.r_next = h.te < e1 ? a.receivers[h.te] : -1;
  h.n_lo = a.receivers[ts];
  h.n_hi = a.receivers[h.te - 1];
  const int edge = ts + (team_tid() >> 3);
  h.snd = h.rcv = 0;
  h.val = h.mu = h.isg = 0.f;
  if (edge < h.te) {
    h.snd = a.senders[edge];
    h.rcv = a.receivers[edge];
    h.val = a.mask ? a.mask[edge] : 1.f;
    if constexpr (STREAM) {
      h.mu = a.mu_in[(size_t)b * a.E + edge];
      h.isg = a.isg_in[(size_t)b * a.E + edge];
    }
  }
  return h;
}

// The first half tile of the first work item from w on (stride apart) that
// has edges.
template <bool STREAM>
__device__ __forceinline__ Half first_half(const BwdArgs& a, int w, int work, int stride) {
  for (; w < work; w += stride) {
    const int b = w / a.G, g = w - b * a.G;
    const int e0 = a.group_edges[g], e1 = a.group_edges[g + 1];
    if (e1 > e0) return load_half<STREAM>(a, w, b, e0, e1, e0);
  }
  Half none;
  none.w = -1;
  return none;
}

template <bool STREAM>
__device__ __forceinline__ Half next_half(const BwdArgs& a, const Half& h, int work, int stride) {
  if (h.te < h.e1) return load_half<STREAM>(a, h.w, h.b, h.e0, h.e1, h.te);
  return first_half<STREAM>(a, h.w + stride, work, stride);
}

// Issue the copies of half tile h into the team's buffers in two groups:
// its indices (plain stores), e and the SP/RP gather (K2) or a1, a2 (K3);
// then de2 and the drhs rows of receivers n_lo .. n_lo + RS.
template <typename T, int L, bool STREAM>
__device__ __forceinline__ void stage_half(const BwdArgs& a, const Half& h, const BwdSmem<T>& s) {
  using Lay = BwdLayout<T, L>;
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VPR = L / EPV;         // vectors per row
  const int r = team_tid() >> 3, sub = team_tid() & 7;
  const bool row = h.ts + r < h.te;
  const size_t eo = (size_t)h.b * a.E;
  if (row) {
    if (sub == 0) {
      s.snd_s[r] = h.snd;
      s.rcv_s[r] = h.rcv;
      s.val_s[r] = h.val;
      if constexpr (STREAM) {
        s.mu_s[r] = h.mu;
        s.isg_s[r] = h.isg;
      }
    }
    const T* erow = static_cast<const T*>(a.e) + (eo + h.ts + r) * L;
    const T* xrow;
    const T* yrow;
    if constexpr (STREAM) {
      xrow = static_cast<const T*>(a.a1_in) + (eo + h.ts + r) * L;
      yrow = static_cast<const T*>(a.a2_in) + (eo + h.ts + r) * L;
    } else {
      xrow = static_cast<const T*>(a.sp) + ((size_t)h.b * a.N + h.snd) * L;
      yrow = static_cast<const T*>(a.rp) + ((size_t)h.b * a.N + h.rcv) * L;
    }
    for (int v = sub; v < VPR; v += 8) {
      cp_async16(s.eT + r * Lay::LDT + v * EPV, erow + v * EPV);
      cp_async16(s.xT + r * Lay::LDT + v * EPV, xrow + v * EPV);
      cp_async16(s.rT + r * Lay::LDT + v * EPV, yrow + v * EPV);
    }
  }
  cp_async_commit();
  if (row) {
    const T* drow = static_cast<const T*>(a.de2) + (eo + h.ts + r) * L;
    for (int v = sub; v < VPR; v += 8) cp_async16(s.d2T + r * Lay::LDZ + v * EPV, drow + v * EPV);
  }
  const int staged = min(h.n_hi - h.n_lo + 1, Lay::RS);
  const float* g = a.drhs + ((size_t)h.b * a.N + h.n_lo) * 5 * L;
  for (int i = team_tid(); i < staged * (5 * L / 4); i += THREADS)
    cp_async16(s.drhsT + 4 * i, g + 4 * i);
  cp_async_commit();
}

// Per-thread column partials of a product's output over the half tiles a
// thread has seen, and the column each belongs to.  bf16 (the mma layout):
// after the reduce-scatter over a warp's rows, one column a lane, held by
// the lanes of one g-class (owners); float32: thread (warp, lane) holds
// columns lane + 32 m.
template <typename T, int L>
struct ColSums {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int NV = L / 16;                 // bf16: values per lane before the scatter
  static constexpr int STEPS = NV >= 8 ? 3 : (NV >= 4 ? 2 : (NV >= 2 ? 1 : 0));
  static constexpr int N = kBf16 ? 1 : L / 32;
  static __device__ __forceinline__ int col(int m) {
    const int lane = threadIdx.x & 31, warp = team_tid() >> 5;
    if constexpr (kBf16) {
      const int g = lane >> 2, t = lane & 3;
      const int i = g >> (3 - STEPS);
      return (warp >> 1) * (L / 4) + 8 * (i >> 1) + 2 * t + (i & 1);
    } else {
      return lane + 32 * m;
    }
  }
  static __device__ __forceinline__ bool owner() {
    if constexpr (kBf16) return (((threadIdx.x & 31) >> 2) & ((1 << (3 - STEPS)) - 1)) == 0;
    return true;
  }
};

// One step of a reduce-scatter of n values a lane over the lanes that
// differ in lane bit `off`: the lane keeps the half its bit picks and adds
// the partner's copy of it.  Once one value remains (n <= 1) the step sums
// it outright.
template <int n, int off>
__device__ __forceinline__ void scatter_step(float* v, int lane) {
  if constexpr (n > 1) {
    const bool up = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? v[i] : v[i + n / 2];
      const float keep = up ? v[i + n / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  } else {
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
}

// out[r][c] = sum_k A[r][k] * B(k, c) over a HT x L half tile on tensor
// cores.  TRANS = false: B(k, c) = W[c][k] (A @ W^T, the forward products of
// an [out][in] weight); TRANS = true: B(k, c) = W[k][c] (A @ W).  A and W
// are shared, row stride L + 8.  Warp (wm, wn) of the team owns rows
// 16*wm .. +16 and columns wn*L/4 .. +L/4.  Every element is the same
// mma.sync chain, k0 in the same order, as in tile_matmul_bf16 (K1), so the
// same sum whichever warp computes it.  Calls epi(r, c, acc_c, acc_c1) for
// each pair of neighbouring columns (c even); with SUM it returns the pair
// of values stored, and their sum over the rows below `rows` is added into
// cs[0] (this lane's column, ColSums).
template <int L, bool TRANS, bool SUM, class Epi>
__device__ __forceinline__ void half_matmul_bf16(const bf16* A, const bf16* W, int rows, Epi epi,
                                                 float* cs) {
  constexpr int LD = L + 8;
  constexpr int WC = L / 4;  // columns per warp
  constexpr int NT = WC / 8;  // 8-column n-tiles per warp
  static_assert(NT == 1 || NT % 2 == 0, "n-tiles are loaded one or two at a time");
  const int warp = team_tid() >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 1, wn = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wm * 16 + g;
  const int nbase = wn * WC;
  const bf16* const a_row = A + (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  [[maybe_unused]] const bf16* const w_row =
      W + (nbase + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  [[maybe_unused]] const bf16* const wt_row = W + (lane & 15) * LD + nbase + (lane >> 4) * 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < L; k0 += 16) {
    uint32_t a0, a1, a2, a3;
    ldsm_x4(a0, a1, a2, a3, a_row + k0);
    if constexpr (NT == 1) {
      uint32_t b0, b1;
      if constexpr (TRANS) {
        ldsm_x2_trans(b0, b1, wt_row + k0 * LD);
      } else {
        ldsm_x2(b0, b1, w_row + k0);
      }
      mma16816(acc[0], a0, a1, a2, a3, b0, b1);
    } else {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        if constexpr (TRANS) {
          ldsm_x4_trans(b[0], b[1], b[2], b[3], wt_row + k0 * LD + 8 * j);
        } else {
          ldsm_x4(b[0], b[1], b[2], b[3], w_row + 8 * j * LD + k0);
        }
        mma16816(acc[j], a0, a1, a2, a3, b[0], b[1]);
        mma16816(acc[j + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
  }
  [[maybe_unused]] float v[2 * NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = nbase + 8 * j + 2 * t;
    if constexpr (SUM) {
      const float2 p = epi(r0, c, acc[j][0], acc[j][1]);
      const float2 q = epi(r0 + 8, c, acc[j][2], acc[j][3]);
      v[2 * j] = (r0 < rows ? p.x : 0.f) + (r0 + 8 < rows ? q.x : 0.f);
      v[2 * j + 1] = (r0 < rows ? p.y : 0.f) + (r0 + 8 < rows ? q.y : 0.f);
    } else {
      epi(r0, c, acc[j][0], acc[j][1]);
      epi(r0 + 8, c, acc[j][2], acc[j][3]);
    }
  }
  if constexpr (SUM) {
    // reduce-scatter over g (lane bits 4, 3, 2)
    scatter_step<2 * NT, 16>(v, lane);
    scatter_step<NT, 8>(v, lane);
    scatter_step<NT / 2, 4>(v, lane);
    cs[0] += v[0];
  }
}

// float32 variant: thread (warp, lane) of the team owns rows 4*warp .. +4
// and columns lane + 32*m; k runs in order with fmaf, as tile_matmul_f32
// (K1).  W is the [out][in] weight in device memory, read through the
// read-only cache.  epi(r, c, acc) for each element; with SUM it returns the
// value stored, summed over the rows below `rows` into cs[m].
template <int L, bool TRANS, bool SUM, class Epi>
__device__ __forceinline__ void half_matmul_f32(const float* A, const float* W, int rows, Epi epi,
                                                float* cs) {
  constexpr int LD = L + Num<float>::PAD;
  constexpr int TN = L / 32;
  const int tx = threadIdx.x & 31, ty = team_tid() >> 5;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < L; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty * 4 + i) * LD + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 32 * j;
      float4 w;
      if constexpr (TRANS) {
        w = make_float4(__ldg(W + (size_t)k * L + c), __ldg(W + (size_t)(k + 1) * L + c),
                        __ldg(W + (size_t)(k + 2) * L + c), __ldg(W + (size_t)(k + 3) * L + c));
      } else {
        w = __ldg(reinterpret_cast<const float4*>(W + (size_t)c * L + k));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j];
        s = fmaf(a[i].x, w.x, s);
        s = fmaf(a[i].y, w.y, s);
        s = fmaf(a[i].z, w.z, s);
        s = fmaf(a[i].w, w.w, s);
        acc[i][j] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if constexpr (SUM) {
        const float val = epi(r, tx + 32 * j, acc[i][j]);
        if (r < rows) cs[j] += val;
      } else {
        epi(r, tx + 32 * j, acc[i][j]);
      }
    }
  }
}

template <int L>
__device__ __forceinline__ void stage_weights_async(bf16* Ws, const BwdArgs& a) {
  constexpr int CH = L * int(sizeof(bf16)) / 16;  // vectors per weight row
  for (int i = threadIdx.x; i < 3 * L * CH; i += blockDim.x) {
    const int m = i / (L * CH), rem = i - m * L * CH;
    const int r = rem / CH, c = rem - r * CH;
    const bf16* w = static_cast<const bf16*>(m == 0 ? a.we : (m == 1 ? a.w2 : a.w3));
    cp_async16(Ws + (m * L + r) * (L + 8) + c * 8, w + (size_t)r * L + c * 8);
  }
}

template <typename T, int L, bool STREAM>
__global__ void __launch_bounds__(NTEAM * THREADS, 1) fused_block_bwd_kernel(const BwdArgs args) {
  using Nm = Num<T>;
  using Lay = BwdLayout<T, L>;
  using CS = ColSums<T, L>;
  constexpr int LDT = Lay::LDT, LDF = Lay::LDF, LDZ = Lay::LDZ;
  constexpr int CPL = L / 32;  // columns per lane in the row passes

  extern __shared__ __align__(16) unsigned char smem[];
  const int team = threadIdx.x / THREADS;
  const BwdSmem<T> s = bwd_carve<T, L>(smem, team);
  T* const eT = s.eT;
  T* const xT = s.xT;
  T* const rT = s.rT;
  float* const doT = s.doT;
  T* const zT = s.zT;
  const T* const d2T = s.d2T;
  const float* const prm = s.prm;
  const int E = args.E, N = args.N;
  const int work = args.G * args.B, stride = NTEAM * gridDim.x;

  // prologue: the weights, the parameters and each team's first half tile
  if constexpr (Lay::kBf16) stage_weights_async<L>(s.Ws, args);
  Half cur = first_half<STREAM>(args, blockIdx.x + team * gridDim.x, work, stride);
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    s.prm[c] = STREAM ? 0.f : rnd<T>(args.b1[c]);
    s.prm[L + c] = STREAM ? 0.f : rnd<T>(args.b2[c]);
    s.prm[2 * L + c] = rnd<T>(args.b3[c]);
    s.prm[3 * L + c] = args.lns[c];
    s.prm[4 * L + c] = args.lnb[c];
  }
  if (cur.w >= 0) stage_half<T, L, STREAM>(args, cur, s);
  cp_async_wait_all();
  __syncthreads();

  // A @ W^T (forward products) or A @ W (backward products) of layer `layer`
  auto matmul = [&](auto trans, auto sum, const T* A, int layer, int rows, float* cs, auto epi) {
    constexpr bool TR = decltype(trans)::value, SUM = decltype(sum)::value;
    if constexpr (Lay::kBf16) {
      half_matmul_bf16<L, TR, SUM>(reinterpret_cast<const bf16*>(A), s.Ws + layer * L * (L + 8),
                                   rows, epi, cs);
    } else {
      const void* w = layer == 0 ? args.we : (layer == 1 ? args.w2 : args.w3);
      half_matmul_f32<L, TR, SUM>(reinterpret_cast<const float*>(A), static_cast<const float*>(w),
                                  rows, epi, cs);
    }
  };
  using Fwd = std::integral_constant<bool, false>;
  using Bwd = std::integral_constant<bool, true>;
  using NoSum = std::integral_constant<bool, false>;
  using Sum = std::integral_constant<bool, true>;

  // the epilogues' values, one definition for the pair (bf16) and
  // element (float32) forms
  auto a1_value = [&](float acc, int c, T x, T r) {
    return Nm::from_f(fmaxf(layer1_value<T>(acc, Nm::to_f(x), Nm::to_f(r), prm[c]), 0.f));
  };
  auto a2_value = [&](float acc, int c) {
    return Nm::from_f(fmaxf(rnd<T>(bias_sum<T>(acc, prm[L + c])), 0.f));
  };
  auto z3_value = [&](float acc, int c) { return Nm::from_f(bias_sum<T>(acc, prm[2 * L + c])); };
  // a backward epilogue: out = [gate > 0] * rnd(acc), in place over the gate
  auto gated = [](float acc, T gate) { return Nm::to_f(gate) > 0.f ? rnd<T>(acc) : 0.f; };

  // column partials: dh, dz2 (product layout), dz3, do*xhat, do (row layout)
  float cs_dh[CS::N], cs_dz2[CS::N], cs_row[3][CPL];
#pragma unroll
  for (int m = 0; m < CS::N; ++m) cs_dh[m] = cs_dz2[m] = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int q = 0; q < CPL; ++q) cs_row[k][q] = 0.f;

  const int warp = team_tid() >> 5, lane = threadIdx.x & 31;
  const int seg_end = args.row_ptr[N];  // the segments' end: E but for a masked tail
  PhaseClock clk;
  clk.start();
  for (int hp = 0; cur.w >= 0; ++hp) {
    if (hp > 0) {  // the prologue staged the first half tile
      stage_half<T, L, STREAM>(args, cur, s);
      cp_async_wait_but_last();
      team_sync();
    }
    clk.mark(0);
    clk.tile();
    const Half nxt = next_half<STREAM>(args, cur, work, stride);  // indices, a half tile early
    const int rows = cur.te - cur.ts;
    const size_t eo = (size_t)cur.b * E * L;  // this element's offset in an edge stream

    if constexpr (!STREAM) {  // K1's layers 1 and 2: a1 -> xT, a2 -> rT
      if constexpr (Lay::kBf16) {
        matmul(Fwd{}, NoSum{}, eT, 0, rows, nullptr, [&](int r, int c, float acc0, float acc1) {
          Vec<T, 2>* xp = reinterpret_cast<Vec<T, 2>*>(xT + r * LDT + c);
          const Vec<T, 2> x = *xp;
          const Vec<T, 2> rr = *reinterpret_cast<const Vec<T, 2>*>(rT + r * LDT + c);
          *xp = Vec<T, 2>{{a1_value(acc0, c, x.v[0], rr.v[0]), a1_value(acc1, c + 1, x.v[1], rr.v[1])}};
        });
      } else {
        matmul(Fwd{}, NoSum{}, eT, 0, rows, nullptr, [&](int r, int c, float acc) {
          xT[r * LDT + c] = a1_value(acc, c, xT[r * LDT + c], rT[r * LDT + c]);
        });
      }
      team_sync();
      if constexpr (Lay::kBf16) {
        matmul(Fwd{}, NoSum{}, xT, 1, rows, nullptr, [&](int r, int c, float acc0, float acc1) {
          *reinterpret_cast<Vec<T, 2>*>(rT + r * LDT + c) =
              Vec<T, 2>{{a2_value(acc0, c), a2_value(acc1, c + 1)}};
        });
      } else {
        matmul(Fwd{}, NoSum{}, xT, 1, rows, nullptr,
               [&](int r, int c, float acc) { rT[r * LDT + c] = a2_value(acc, c); });
      }
      team_sync();
    }
    // K1's layer 3: z3 -> zT (in doT's rows)
    if constexpr (Lay::kBf16) {
      matmul(Fwd{}, NoSum{}, rT, 2, rows, nullptr, [&](int r, int c, float acc0, float acc1) {
        *reinterpret_cast<Vec<T, 2>*>(zT + r * LDZ + c) =
            Vec<T, 2>{{z3_value(acc0, c), z3_value(acc1, c + 1)}};
      });
    } else {
      matmul(Fwd{}, NoSum{}, rT, 2, rows, nullptr,
             [&](int r, int c, float acc) { zT[r * LDZ + c] = z3_value(acc, c); });
    }
    PROBE_SPLIT();
    clk.mark(1);
    cp_async_wait_all();  // de2 and the drhs rows
    team_sync();
    clk.mark(2);

    // The row pass, one warp per edge row, RPW rows of a warp side by side:
    // LayerNorm statistics (K2) or the saved ones (K3), e2 as K1 made it,
    // the routed cotangent, the LayerNorm backward; do -> doT (over z3 and
    // de2), dz3 -> eT (over e); the partials of dz3, do*xhat, do.
    {
      constexpr int RPW = 2;
      const float* drhsb = args.drhs + (size_t)cur.b * N * 5 * L;
      for (int r0 = warp; r0 < rows; r0 += RPW * WARPS) {
        float z[RPW][CPL], ev[RPW][CPL], d2[RPW][CPL];
#pragma unroll
        for (int u = 0; u < RPW; ++u) {  // rows past `rows` hold stale values and are not stored
          const int r = r0 + u * WARPS;
          const Vec<T, CPL> zv = *reinterpret_cast<const Vec<T, CPL>*>(zT + r * LDZ + lane * CPL);
          const Vec<T, CPL> evv = *reinterpret_cast<const Vec<T, CPL>*>(eT + r * LDT + lane * CPL);
          const Vec<T, CPL> d2v = *reinterpret_cast<const Vec<T, CPL>*>(d2T + r * LDZ + lane * CPL);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            z[u][q] = Nm::to_f(zv.v[q]);
            ev[u][q] = Nm::to_f(evv.v[q]);
            d2[u][q] = Nm::to_f(d2v.v[q]);
          }
        }
        __syncwarp();  // every lane has read its z3 and de2 before any writes do over them
#pragma unroll
        for (int u = 0; u < RPW; ++u) {
          const int r = r0 + u * WARPS;
          if (r >= rows) break;
          float mu, isg;
          if constexpr (STREAM) {
            mu = s.mu_s[r];
            isg = s.isg_s[r];
          } else {
            ln_row_stats<L, CPL>(z[u], mu, isg);
          }
          const bool valid = s.val_s[r] > 0.f;
          // a masked edge reads no drhs row: the masked tail of a valid-prefix
          // plan may name its receivers in any order, outside the staged rows
          Vec<float, CPL> gv[5] = {};
          if (valid) {
            const int n = s.rcv_s[r], slot = n - cur.n_lo;
            const float* g = (slot < Lay::RS ? s.drhsT + slot * 5 * L : drhsb + (size_t)n * 5 * L) +
                             lane * CPL;
#pragma unroll
            for (int k = 0; k < 5; ++k) gv[k] = *reinterpret_cast<const Vec<float, CPL>*>(g + k * L);
          }
          float xh[CPL], dx[CPL], dov[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int c = lane * CPL + q;
            xh[q] = ln_xhat(z[u][q], mu, isg);
            const float e2v = rnd<T>(e2_sum<T>(ev[u][q], xh[q], prm[3 * L + c], prm[4 * L + c]));
            float route = 0.f;
            if (valid) {
              route = rnd<T>(gv[0].v[q]);
              route += ties(e2v, rnd<T>(gv[1].v[q]), args.tie_tol) ? rnd<T>(gv[2].v[q]) : 0.f;
              route += ties(e2v, rnd<T>(gv[3].v[q]), args.tie_tol) ? rnd<T>(gv[4].v[q]) : 0.f;
            }
            dov[q] = d2[u][q] + route;
            dx[q] = dov[q] * prm[3 * L + c];
            s1 += dx[q];
            s2 += dx[q] * xh[q];
          }
          const float m1 = warp_sum(s1) * (1.f / L);
          const float m2 = warp_sum(s2) * (1.f / L);
          Vec<T, CPL> dz3;
          Vec<float, CPL> dvo;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            dz3.v[q] = Nm::from_f((dx[q] - m1 - xh[q] * m2) * isg);
            dvo.v[q] = dov[q];
            cs_row[0][q] += Nm::to_f(dz3.v[q]);
            cs_row[1][q] += dov[q] * xh[q];
            cs_row[2][q] += dov[q];
          }
          *reinterpret_cast<Vec<T, CPL>*>(eT + r * LDT + lane * CPL) = dz3;
          *reinterpret_cast<Vec<float, CPL>*>(doT + r * LDF + lane * CPL) = dvo;
        }
      }
    }
    if constexpr (!STREAM) {
      store_tile<T, L, LDT>(static_cast<T*>(args.a1_out) + eo, xT, cur.ts, rows);
      store_tile<T, L, LDT>(static_cast<T*>(args.a2_out) + eo, rT, cur.ts, rows);
    }
    team_sync();
    clk.mark(3);

    // dz2 = [a2 > 0] * rnd(dz3 @ W3) -> rT (over a2); dh = [a1 > 0] *
    // rnd(dz2 @ W2) -> xT (over a1); their column partials
    if constexpr (Lay::kBf16) {
      matmul(Bwd{}, Sum{}, eT, 2, rows, cs_dz2, [&](int r, int c, float acc0, float acc1) {
        Vec<T, 2>* p = reinterpret_cast<Vec<T, 2>*>(rT + r * LDT + c);
        const Vec<T, 2> gate = *p;
        const float2 out = make_float2(gated(acc0, gate.v[0]), gated(acc1, gate.v[1]));
        *p = Vec<T, 2>{{Nm::from_f(out.x), Nm::from_f(out.y)}};
        return out;
      });
      team_sync();
      matmul(Bwd{}, Sum{}, rT, 1, rows, cs_dh, [&](int r, int c, float acc0, float acc1) {
        Vec<T, 2>* p = reinterpret_cast<Vec<T, 2>*>(xT + r * LDT + c);
        const Vec<T, 2> gate = *p;
        const float2 out = make_float2(gated(acc0, gate.v[0]), gated(acc1, gate.v[1]));
        *p = Vec<T, 2>{{Nm::from_f(out.x), Nm::from_f(out.y)}};
        return out;
      });
    } else {
      matmul(Bwd{}, Sum{}, eT, 2, rows, cs_dz2, [&](int r, int c, float acc) {
        const float out = gated(acc, rT[r * LDT + c]);
        rT[r * LDT + c] = Nm::from_f(out);
        return out;
      });
      team_sync();
      matmul(Bwd{}, Sum{}, rT, 1, rows, cs_dh, [&](int r, int c, float acc) {
        const float out = gated(acc, xT[r * LDT + c]);
        xT[r * LDT + c] = Nm::from_f(out);
        return out;
      });
    }
    team_sync();
    clk.mark(4);

    // drp: one warp per run of equal receivers among the half tile's rows,
    // dh summed over its valid edges in edge order, carried from and to the
    // neighbouring half tiles of the item; none in a valid-prefix plan's
    // masked tail (edges from row_ptr[N] on), whose receivers' rows belong
    // to the prefix's items or to the sender-sum kernel
    if (cur.ts < seg_end) {
      float* drpb = args.drp + (size_t)cur.b * N * L;
      const unsigned starts =
          __ballot_sync(0xffffffffu, lane < rows && (lane == 0 || s.rcv_s[lane] != s.rcv_s[lane - 1]));
      const int runs = __popc(starts);
      for (int k = warp; k < runs; k += WARPS) {
        unsigned m = starts;
        for (int i = 0; i < k; ++i) m &= m - 1;
        const int lo = __ffs(m) - 1;
        m &= m - 1;
        const int hi = m ? __ffs(m) - 1 : rows;
        const int n = s.rcv_s[lo];
        const bool from_prev = lo == 0 && n == cur.r_prev;
        const bool to_next = hi == rows && n == cur.r_next;
        float sm[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q) sm[q] = from_prev ? s.carry[((hp + 1) & 1) * L + lane * CPL + q] : 0.f;
        for (int i = lo; i < hi; ++i) {
          if (!(s.val_s[i] > 0.f)) continue;
#pragma unroll
          for (int q = 0; q < CPL; ++q) sm[q] += Nm::to_f(xT[i * LDT + lane * CPL + q]);
        }
        if (to_next) {
#pragma unroll
          for (int q = 0; q < CPL; ++q) s.carry[(hp & 1) * L + lane * CPL + q] = sm[q];
        } else {
          Vec<float, CPL> o;
#pragma unroll
          for (int q = 0; q < CPL; ++q) o.v[q] = sm[q];
          *reinterpret_cast<Vec<float, CPL>*>(drpb + (size_t)n * L + lane * CPL) = o;
        }
      }
    }
    PROBE_SPLIT();
    clk.mark(5);
    store_tile<T, L, LDT>(static_cast<T*>(args.dh) + eo, xT, cur.ts, rows);
    store_tile<T, L, LDT>(static_cast<T*>(args.dz2) + eo, rT, cur.ts, rows);
    store_tile<T, L, LDT>(static_cast<T*>(args.dz3) + eo, eT, cur.ts, rows);
    PROBE_SPLIT();
    clk.mark(6);
    // de = rnd(do + dh @ We), from the fragments to device memory
    {
      T* deb = static_cast<T*>(args.de) + eo + (size_t)cur.ts * L;
      if constexpr (Lay::kBf16) {
        matmul(Bwd{}, NoSum{}, xT, 0, rows, nullptr, [&](int r, int c, float acc0, float acc1) {
          if (r < rows) {
            const float2 d = *reinterpret_cast<const float2*>(doT + r * LDF + c);
            *reinterpret_cast<Vec<T, 2>*>(deb + (size_t)r * L + c) =
                Vec<T, 2>{{Nm::from_f(d.x + acc0), Nm::from_f(d.y + acc1)}};
          }
        });
      } else {
        matmul(Bwd{}, NoSum{}, xT, 0, rows, nullptr, [&](int r, int c, float acc) {
          if (r < rows) deb[(size_t)r * L + c] = Nm::from_f(doT[r * LDF + c] + acc);
        });
      }
    }
    team_sync();  // the buffers are free for the next half tile
    clk.mark(7);
    cur = nxt;
  }

  // this CTA's column sums: every team's and warp's partials, in order
  __syncthreads();
  clk.mark(8);
  clk.flush();
  float* part = reinterpret_cast<float*>(smem + Lay::w_bytes + Lay::prm_bytes);  // [5][SLOTS][L]
  for (int i = threadIdx.x; i < 5 * Lay::SLOTS * L; i += blockDim.x) part[i] = 0.f;
  __syncthreads();
  const int slot = team * WARPS + warp;
  auto put = [&](int k, int c, float v) { part[(k * Lay::SLOTS + slot) * L + c] = v; };
  if (CS::owner()) {
#pragma unroll
    for (int m = 0; m < CS::N; ++m) {
      put(0, CS::col(m), cs_dh[m]);
      put(1, CS::col(m), cs_dz2[m]);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int q = 0; q < CPL; ++q) put(2 + k, lane * CPL + q, cs_row[k][q]);
  __syncthreads();
  for (int i = threadIdx.x; i < 5 * L; i += blockDim.x) {
    const int k = i / L, c = i - k * L;
    float sum = 0.f;
    for (int j = 0; j < Lay::SLOTS; ++j) sum += part[(k * Lay::SLOTS + j) * L + c];
    args.dpar_part[(size_t)blockIdx.x * 5 * L + i] = sum;
  }
}

// dsp[b][n] = sum of dh[b][e] over the valid edges e sent by n, in edge
// order; one warp per (b, n).  It also writes the zero drp row of a node
// that receives no edge (the main kernel skips empty groups and writes
// only receivers with edges).
template <typename T, int L>
__global__ void __launch_bounds__(THREADS) sender_sum_kernel(const BwdArgs args) {
  constexpr int CPL = L / 32;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= (long long)args.B * args.N) return;
  const int b = int(gw / args.N), n = int(gw - (long long)b * args.N);
  const T* dhb = static_cast<const T*>(args.dh) + (size_t)b * args.E * L;
  float acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
  for (int j = args.snd_ptr[n]; j < args.snd_ptr[n + 1]; ++j) {
    const int e = args.snd_perm[j];
    if (args.mask && !(args.mask[e] > 0.f)) continue;
    const Vec<T, CPL> v = *reinterpret_cast<const Vec<T, CPL>*>(dhb + (size_t)e * L + lane * CPL);
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] += Num<T>::to_f(v.v[q]);
  }
  Vec<float, CPL> o;
#pragma unroll
  for (int q = 0; q < CPL; ++q) o.v[q] = acc[q];
  const size_t row = ((size_t)b * args.N + n) * L + lane * CPL;
  *reinterpret_cast<Vec<float, CPL>*>(args.dsp + row) = o;
  if (args.row_ptr[n] == args.row_ptr[n + 1])
    *reinterpret_cast<Vec<float, CPL>*>(args.drp + row) = Vec<float, CPL>{};
}

// dpar[i] = sum over the CTAs' partial rows, in order
__global__ void dpar_reduce_kernel(const float* part, float* dpar, int parts, int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= width) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s += part[(size_t)p * width + i];
  dpar[i] = s;
}

// CTAs that fit on the current device at once.  The shared-memory attribute
// is set per device, so both it and the count are kept per device ordinal.
template <typename T, int L, bool STREAM>
int grid_cap() {
  static int cap[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    using Lay = BwdLayout<T, L>;
    err = cudaFuncSetAttribute(fused_block_bwd_kernel<T, L, STREAM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Lay::total);
    if (err != cudaSuccess) return -(int)err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return -(int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fused_block_bwd_kernel<T, L, STREAM>, NTEAM * THREADS, Lay::total)) != cudaSuccess)
      return -(int)err;
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

template <typename T, int L, bool STREAM>
int launch(const BwdArgs& a, cudaStream_t stream) {
  const int cap = grid_cap<T, L, STREAM>();
  if (cap < 0) return -cap;
  const long long work = (long long)a.G * a.B;
  if (work > 0x7fffffff || a.group_edges == nullptr) return -1;
  // one CTA per SM, fewer when the work is small: each item on its own team
  const int grid = (int)(work < (long long)NTEAM * cap ? (work + NTEAM - 1) / NTEAM : cap);
  if (grid > 0) {
    fused_block_bwd_kernel<T, L, STREAM>
        <<<grid, NTEAM * THREADS, BwdLayout<T, L>::total, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long warps = (long long)a.B * a.N;
  if (warps > 0) {
    sender_sum_kernel<T, L><<<(int)((warps + WARPS - 1) / WARPS), THREADS, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dpar_reduce_kernel<<<(5 * L + 127) / 128, 128, 0, stream>>>(a.dpar_part, a.dpar, grid, 5 * L);
  return (int)cudaGetLastError();
}

template <typename T, bool STREAM>
int dispatch_width(int L, const BwdArgs& a, cudaStream_t s) {
  switch (L) {
    case 32: return launch<T, 32, STREAM>(a, s);
    case 128: return launch<T, 128, STREAM>(a, s);
    default: return -1;
  }
}

template <bool STREAM>
int dispatch(int dtype, int L, const BwdArgs& a, cudaStream_t s) {
  if (dtype == 0) return dispatch_width<float, STREAM>(L, a, s);
  if (dtype == 1) return dispatch_width<bf16, STREAM>(L, a, s);
  return -1;
}

template <bool STREAM>
int cap_of(int dtype, int L) {
  if (dtype == 0 && L == 32) return grid_cap<float, 32, STREAM>();
  if (dtype == 0 && L == 128) return grid_cap<float, 128, STREAM>();
  if (dtype == 1 && L == 32) return grid_cap<bf16, 32, STREAM>();
  if (dtype == 1 && L == 128) return grid_cap<bf16, 128, STREAM>();
  return 0;
}

}  // namespace

extern "C" {

// Rows of the dpar_part scratch a launch may write: > 0, or 0 for a
// (dtype, L) the kernels do not take, or minus a cudaError_t code.
int hgn_fused_block_bwd_ctas(int dtype, int L, int stream_mode) {
  return stream_mode ? cap_of<true>(dtype, L) : cap_of<false>(dtype, L);
}

// stream_mode 0: K2 (reads sp, rp; writes a1_out, a2_out); 1: K3 (reads
// a1_in, a2_in, mu_in, isg_in).  Pointers a mode does not use may be null.
// dtype: 0 = float32, 1 = bfloat16.  group_edges [G + 1] = row_ptr[groups]
// of the plan's work groups.
// Returns 0, a cudaError_t code, or -1 for arguments the kernels do not
// take.
int hgn_fused_block_bwd(int dtype, int L, int stream_mode, const void* e, const void* sp,
                        const void* rp, const void* a1_in, const void* a2_in,
                        const float* mu_in, const float* isg_in, const void* we, const void* w2,
                        const void* w3, const float* b1, const float* b2, const float* b3,
                        const float* lns, const float* lnb, const void* de2, const float* drhs,
                        const int* senders, const int* receivers, const float* mask,
                        const int* row_ptr, const int* group_edges, const int* snd_perm,
                        const int* snd_ptr, void* de, void* dh, void* dz2, void* dz3,
                        void* a1_out, void* a2_out, float* dsp, float* drp, float* dpar,
                        float* dpar_part, int B, int E, int N, int G, float tie_tol,
                        void* stream) {
  BwdArgs a{e,         sp,      rp,          a1_in,    a2_in,   mu_in, isg_in, we,   w2,
            w3,        b1,      b2,          b3,       lns,     lnb,   de2,    drhs, senders,
            receivers, mask,    row_ptr,     group_edges, snd_perm, snd_ptr, de,  dh,   dz2,
            dz3,       a1_out,  a2_out,      dsp,      drp,     dpar,  dpar_part, B, E,
            N,         G,       tie_tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stream_mode ? dispatch<true>(dtype, L, a, s) : dispatch<false>(dtype, L, a, s);
}

// Phase probe: with HGN_BWD_PHASES, writes the cycles of each phase summed
// over every team's half tiles since the last call, then the half-tile
// count, into out[0 .. n), clears them and returns the number of phases;
// without it, -1.
int hgn_fused_block_bwd_phases(unsigned long long* out, int n) {
#ifdef HGN_BWD_PHASES
  if (n < NPHASE + 1) return -1;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, hgn_bwd_phase_cycles, sizeof(unsigned long long) * (NPHASE + 1));
  const unsigned long long zero[NPHASE + 1] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(hgn_bwd_phase_cycles, zero, sizeof(zero));
  return err == cudaSuccess ? NPHASE : -(int)err;
#else
  (void)out;
  (void)n;
  return -1;
#endif
}

// The probe's phase names, comma-separated (empty without the probe).
const char* hgn_fused_block_bwd_phase_names() {
#ifdef HGN_BWD_PHASES
  return HGN_BWD_PHASE_NAMES;
#else
  return "";
#endif
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
