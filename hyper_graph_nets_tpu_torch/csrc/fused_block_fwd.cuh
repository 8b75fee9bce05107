// The fused edge-block forward of one tile of edges, and the loop of a CTA's
// teams over work items, shared by K1 (fused_block_fwd.cu) and K7's compute
// CTAs (fused_overlap.cu): two teams of a CTA on two tiles at once.
//
// A work item is (batch element, group): a group is a run of whole receiver
// segments holding at most TILE edges (a receiver with more edges forms its
// own group and spans several tiles).  For each tile of the group's edges it
// computes
//
//   h   = ((e @ We + SP[snd]) + RP[rcv]) + b1          (each add rounded)
//   z3  = relu(relu(h) @ W2 + b2) @ W3 + b3
//   e2  = e + LayerNorm(z3)                           (float32 statistics)
//
// and, when a receiver's segment closes, its aggregate over the valid edges:
// finalized [sum | sum / max(cnt, 1) | max | min] (0 for a receiver with
// none), or with `raw` the partials [sum | cnt | max | min] with -BIG / +BIG
// for a receiver with no valid edge, which an edge-sharded caller combines
// across ranks before finalizing (the TPU kernel's finalize=False).
//
// The rounding points are the TPU kernel's: every product accumulates in
// float32 and is rounded to the compute type, bias adds run in the compute
// type, and the aggregate sums the rounded e2 in float32, one sequential sum
// per receiver and column in edge order.  Each e2 row depends only on its
// own edge, so how tiles are staged or scheduled does not change it.

#pragma once

#include "fused_block_common.cuh"

namespace hgn {

struct FwdArgs {
  const void* e;    // [B][E][L] compute type
  const void* sp;   // [B][N][L] sender node parts
  const void* rp;   // [B][N][L] receiver node parts
  const void* we;   // [L][L] compute type, [out][in]
  const void* w2;
  const void* w3;
  const float* b1;  // [L]
  const float* b2;
  const float* b3;
  const float* lns;
  const float* lnb;
  const int* senders;    // [E]
  const int* receivers;  // [E], non-decreasing
  const float* mask;     // [E] or null (all valid)
  const int* row_ptr;    // [N + 1]
  const int* groups;     // [G + 1] node boundaries of the work groups
  void* e2;              // [B][E][L] compute type
  float* agg;            // [B][N][4L]
  void* a1;              // [B][E][L] compute type, or null: no streams
  void* a2;              // [B][E][L] compute type (with a1)
  float* mu;             // [B][E] (with a1)
  float* isg;            // [B][E] (with a1)
  int B, E, N, G;
  int raw;                 // 1: write the unfinalized partials
  const int* group_edges;  // [G + 1] edge boundaries of the groups (K1's pipeline)
};

// N consecutive elements from shared memory, in 16-byte (or smaller) loads:
// a row of the tile is 16-byte aligned, not more.
template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* p) {
  if constexpr (sizeof(T) * N <= 16) {
    return *reinterpret_cast<const Vec<T, N>*>(p);
  } else {
    constexpr int H = 16 / sizeof(T);
    Vec<T, N> v;
#pragma unroll
    for (int h = 0; h < N; h += H) {
      const Vec<T, H> x = *reinterpret_cast<const Vec<T, H>*>(p + h);
#pragma unroll
      for (int q = 0; q < H; ++q) v.v[h + q] = x.v[q];
    }
    return v;
  }
}

// A CTA runs NTEAM teams of THREADS threads, each on its own tiles, with its
// own tile buffers and segment carry: K1 and K7 two (one team's loads and
// barrier waits overlap the other's products).  The weights and parameters
// are staged once per CTA and shared.
template <typename T, int L, int NTEAM = 1>
struct FwdLayout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LDT = L + Num<T>::PAD;  // tile row stride (elements)
  static constexpr int LDW = L + 8;            // staged weight row stride (bf16)
  static constexpr size_t w_bytes = kBf16 ? align16(size_t(3) * L * LDW * sizeof(bf16)) : 0;
  static constexpr size_t tile_bytes = align16(size_t(TILE) * LDT * sizeof(T));
  static constexpr size_t prm_bytes = align16(size_t(5) * L * sizeof(float));
  static constexpr size_t carry_bytes = align16(size_t(2) * (3 * L + 1) * sizeof(float));
  static constexpr size_t idx_bytes = align16(size_t(3) * TILE * sizeof(int));
  static constexpr size_t team_bytes = 3 * tile_bytes + idx_bytes + carry_bytes;
  static constexpr size_t total = w_bytes + prm_bytes + NTEAM * team_bytes;
};

// One team's view of the CTA's shared arrays.
template <typename T>
struct FwdSmem {
  bf16* Ws;      // staged weights (bf16 only), shared by the teams
  float* prm;    // b1 b2 b3 (rounded), lns, lnb, shared by the teams
  T* eT;         // e, then e2
  T* xT;         // SP rows, then a1, then z3
  T* rT;         // RP rows, then a2
  int* snd_s;    // the tile's senders and receivers
  int* rcv_s;
  float* val_s;  // the tile's mask
  float* carry;  // 2 x [sum L | max L | min L | cnt]
};

template <typename T, int L, int NTEAM>
__device__ __forceinline__ FwdSmem<T> fwd_carve(unsigned char* smem, int team) {
  using Lay = FwdLayout<T, L, NTEAM>;
  FwdSmem<T> s;
  s.Ws = reinterpret_cast<bf16*>(smem);
  s.prm = reinterpret_cast<float*>(smem + Lay::w_bytes);
  unsigned char* g = smem + Lay::w_bytes + Lay::prm_bytes + team * Lay::team_bytes;
  s.eT = reinterpret_cast<T*>(g);
  s.xT = reinterpret_cast<T*>(g + Lay::tile_bytes);
  s.rT = reinterpret_cast<T*>(g + 2 * Lay::tile_bytes);
  s.snd_s = reinterpret_cast<int*>(g + 3 * Lay::tile_bytes);
  s.rcv_s = s.snd_s + TILE;
  s.val_s = reinterpret_cast<float*>(s.rcv_s + TILE);
  s.carry = reinterpret_cast<float*>(g + 3 * Lay::tile_bytes + Lay::idx_bytes);
  return s;
}

// The rounded biases and the LayerNorm parameters into shared memory (all
// threads of the CTA).
template <typename T, int L>
__device__ __forceinline__ void fwd_params(const FwdArgs& args, float* prm) {
  for (int c = threadIdx.x; c < L; c += blockDim.x) {
    prm[c] = rnd<T>(args.b1[c]);
    prm[L + c] = rnd<T>(args.b2[c]);
    prm[2 * L + c] = rnd<T>(args.b3[c]);
    prm[3 * L + c] = args.lns[c];
    prm[4 * L + c] = args.lnb[c];
  }
}

// One tile of work item (b, n0 .. n1): edges ts .. te, the item's t-th
// tile, whose rows (and mask) are staged in s.  Every thread of the team
// calls it; it ends in the team's barrier.  hook(0) runs first, hook(1)
// once rT is free (after the third product) and hook(2) once xT is free
// (after the LayerNorm): K1 loads its next tile's indices at 0 and starts
// the copies of its RP rows at 1 and of its SP rows at 2, so that they land
// while this tile finishes.
template <typename T, int L, class Hook>
__device__ __forceinline__ void fwd_tile(const FwdArgs& args, const FwdSmem<T>& s, int b, int n0,
                                         int n1, int t, int ts, int te, Hook hook) {
  using Nm = Num<T>;
  using Lay = FwdLayout<T, L>;
  constexpr int LDT = Lay::LDT;
  constexpr int CPL = L / 32;  // columns per lane in the row phases
  T* const eT = s.eT;
  T* const xT = s.xT;
  T* const rT = s.rT;
  const float* const prm = s.prm;
  float* const carry = s.carry;

  auto matmul = [&](const T* A, int layer, auto epi) {
    if constexpr (Lay::kBf16) {
      tile_matmul_bf16<L>(reinterpret_cast<const bf16*>(A), s.Ws + layer * L * (L + 8), epi);
    } else {
      const void* w = layer == 0 ? args.we : (layer == 1 ? args.w2 : args.w3);
      tile_matmul_f32<L>(reinterpret_cast<const float*>(A), static_cast<const float*>(w),
                                epi);
    }
  };

  const bool streams = args.a1 != nullptr;
  const bool raw = args.raw != 0;
  const int E = args.E, N = args.N;
  const int warp = team_tid() >> 5, lane = threadIdx.x & 31;
  const int rows = te - ts;
  T* e2b = static_cast<T*>(args.e2) + (size_t)b * E * L;
  float* aggb = args.agg + (size_t)b * N * 4 * L;

  // pna: a half warp per receiver (PNA_PER receivers of the team at a
  // time), lane hl of it owns columns hl * PCL .. +PCL.  The half warp's
  // first receiver's segment is in flight through the products.
  constexpr int PCL = L / 16;
  constexpr int PNA_PER = 2 * WARPS;
  const int hl = lane & 15;
  int n = n0 + 2 * warp + (lane >> 4);
  int ns_next = 0, ne_next = 0;
  if (n < n1) {
    ns_next = args.row_ptr[n];
    ne_next = args.row_ptr[n + 1];
  }

  // the epilogues' values, one definition for the one- and two-column forms
  auto a1_value = [&](float acc, int c, T x, T r) {
    return Nm::from_f(fmaxf(layer1_value<T>(acc, Nm::to_f(x), Nm::to_f(r), prm[c]), 0.f));
  };
  auto a2_value = [&](float acc, int c) {
    return Nm::from_f(fmaxf(rnd<T>(bias_sum<T>(acc, prm[L + c])), 0.f));
  };
  auto z3_value = [&](float acc, int c) { return Nm::from_f(bias_sum<T>(acc, prm[2 * L + c])); };

  hook(0);
  if (rows > 0) {
    // layer 1 (factored): h = ((e@We + SP[snd]) + RP[rcv]) + b1; a1 -> xT
    if constexpr (Lay::kBf16) {
      matmul(eT, 0, [&](int r, int c, float acc0, float acc1) {
        Vec<T, 2>* xp = reinterpret_cast<Vec<T, 2>*>(xT + r * LDT + c);
        const Vec<T, 2> x = *xp;
        const Vec<T, 2> rr = *reinterpret_cast<const Vec<T, 2>*>(rT + r * LDT + c);
        *xp = Vec<T, 2>{{a1_value(acc0, c, x.v[0], rr.v[0]), a1_value(acc1, c + 1, x.v[1], rr.v[1])}};
      });
    } else {
      matmul(eT, 0, [&](int r, int c, float acc) {
        xT[r * LDT + c] = a1_value(acc, c, xT[r * LDT + c], rT[r * LDT + c]);
      });
    }
    team_sync();
    // layer 2: a2 = relu(a1@W2 + b2) -> rT
    if constexpr (Lay::kBf16) {
      matmul(xT, 1, [&](int r, int c, float acc0, float acc1) {
        *reinterpret_cast<Vec<T, 2>*>(rT + r * LDT + c) =
            Vec<T, 2>{{a2_value(acc0, c), a2_value(acc1, c + 1)}};
      });
    } else {
      matmul(xT, 1, [&](int r, int c, float acc) { rT[r * LDT + c] = a2_value(acc, c); });
    }
    team_sync();
    if (streams) {  // a1 leaves before layer 3 overwrites it
      const size_t o = (size_t)b * E * L;
      store_tile<T, L, LDT>(static_cast<T*>(args.a1) + o, xT, ts, rows);
      store_tile<T, L, LDT>(static_cast<T*>(args.a2) + o, rT, ts, rows);
      team_sync();
    }
    // layer 3: z3 = a2@W3 + b3 -> xT
    if constexpr (Lay::kBf16) {
      matmul(rT, 2, [&](int r, int c, float acc0, float acc1) {
        *reinterpret_cast<Vec<T, 2>*>(xT + r * LDT + c) =
            Vec<T, 2>{{z3_value(acc0, c), z3_value(acc1, c + 1)}};
      });
    } else {
      matmul(rT, 2, [&](int r, int c, float acc) { xT[r * LDT + c] = z3_value(acc, c); });
    }
    team_sync();
    hook(1);

    // LayerNorm with float32 statistics, residual in the compute type; one
    // warp per edge row, RPW rows of a warp side by side so that their
    // shuffle chains overlap.  e2 goes to device memory and to eT.
    constexpr int RPW = TILE / WARPS / 2;  // 4 rows per warp at a time
    for (int r0 = warp; r0 < rows; r0 += RPW * WARPS) {
      float z[RPW][CPL], mu[RPW], isg[RPW];
      Vec<T, CPL> ev[RPW];
#pragma unroll
      for (int u = 0; u < RPW; ++u) {  // rows past `rows` hold stale values and are not stored
        const int r = r0 + u * WARPS;
        const Vec<T, CPL> zv = *reinterpret_cast<const Vec<T, CPL>*>(xT + r * LDT + lane * CPL);
        ev[u] = *reinterpret_cast<const Vec<T, CPL>*>(eT + r * LDT + lane * CPL);
#pragma unroll
        for (int q = 0; q < CPL; ++q) z[u][q] = Nm::to_f(zv.v[q]);
      }
#pragma unroll
      for (int u = 0; u < RPW; ++u) ln_row_stats<L, CPL>(z[u], mu[u], isg[u]);
#pragma unroll
      for (int u = 0; u < RPW; ++u) {
        const int r = r0 + u * WARPS;
        if (r >= rows) break;
        Vec<T, CPL> out;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane * CPL + q;
          out.v[q] = Nm::from_f(e2_sum<T>(Nm::to_f(ev[u].v[q]), ln_xhat(z[u][q], mu[u], isg[u]),
                                          prm[3 * L + c], prm[4 * L + c]));
        }
        *reinterpret_cast<Vec<T, CPL>*>(eT + r * LDT + lane * CPL) = out;
        *reinterpret_cast<Vec<T, CPL>*>(e2b + (size_t)(ts + r) * L + lane * CPL) = out;
        if (streams && lane == 0) {
          args.mu[(size_t)b * E + ts + r] = mu[u];
          args.isg[(size_t)b * E + ts + r] = isg[u];
        }
      }
    }
    team_sync();
    hook(2);
  } else {
    hook(1);
    hook(2);
  }

  // pna over the receivers of this group that have edges in this tile, one
  // sequential float32 sum per receiver and column in edge order; the next
  // receiver's segment bounds are loaded while this one sums.
  for (; n < n1; n += PNA_PER) {
    const int ns = ns_next, ne = ne_next;
    if (n + PNA_PER < n1) {
      ns_next = args.row_ptr[n + PNA_PER];
      ne_next = args.row_ptr[n + PNA_PER + 1];
    }
    // lane's PCL columns of part k of the output row
    auto part = [&](int k) {
      return reinterpret_cast<Vec<float, PCL>*>(aggb + (size_t)n * 4 * L + k * L + hl * PCL);
    };
    auto put = [&](int k, const float (&v)[PCL]) {
      Vec<float, PCL> o;
#pragma unroll
      for (int q = 0; q < PCL; ++q) o.v[q] = v[q];
      *part(k) = o;
    };
    if (ns == ne) {
      if (t == 0) {
        float zero[PCL], lo[PCL], hi[PCL];
#pragma unroll
        for (int q = 0; q < PCL; ++q) {
          zero[q] = 0.f;
          lo[q] = raw ? -BIG : 0.f;
          hi[q] = raw ? BIG : 0.f;
        }
        put(0, zero);
        put(1, zero);
        put(2, lo);
        put(3, hi);
      }
      continue;
    }
    const int lo = max(ns, ts), hi = min(ne, te);
    if (lo >= hi) continue;
    float sm[PCL], mx[PCL], mn[PCL], cnt;
    if (ns >= ts) {
#pragma unroll
      for (int q = 0; q < PCL; ++q) {
        sm[q] = 0.f;
        mx[q] = -BIG;
        mn[q] = BIG;
      }
      cnt = 0.f;
    } else {  // continues a segment from the previous tile
      const float* cin = carry + ((t + 1) & 1) * (3 * L + 1);
#pragma unroll
      for (int q = 0; q < PCL; ++q) {
        const int c = hl * PCL + q;
        sm[q] = cin[c];
        mx[q] = cin[L + c];
        mn[q] = cin[2 * L + c];
      }
      cnt = cin[3 * L];
    }
    // UNR edges' rows and masks loaded together, then summed in edge order
    constexpr int UNR = 4;
    for (int i0 = lo; i0 < hi; i0 += UNR) {
      Vec<T, PCL> ev[UNR];
      float val[UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int i = i0 + u;
        val[u] = i < hi ? s.val_s[i - ts] : 0.f;
        if (i < hi) ev[u] = load_vec<T, PCL>(eT + (i - ts) * LDT + hl * PCL);
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        if (!(val[u] > 0.f)) continue;
        cnt += 1.f;
#pragma unroll
        for (int q = 0; q < PCL; ++q) {
          const float v = Nm::to_f(ev[u].v[q]);
          sm[q] += v;
          mx[q] = fmaxf(mx[q], v);
          mn[q] = fminf(mn[q], v);
        }
      }
    }
    if (ne <= te) {
      const float den = fmaxf(cnt, 1.f);
      const bool any = cnt > 0.f;
      float o_mid[PCL];
#pragma unroll
      for (int q = 0; q < PCL; ++q) {
        o_mid[q] = raw ? cnt : sm[q] / den;
        if (!(raw || any)) mx[q] = mn[q] = 0.f;
      }
      put(0, sm);
      put(1, o_mid);
      put(2, mx);
      put(3, mn);
    } else {
      float* cout = carry + (t & 1) * (3 * L + 1);
#pragma unroll
      for (int q = 0; q < PCL; ++q) {
        const int c = hl * PCL + q;
        cout[c] = sm[q];
        cout[L + c] = mx[q];
        cout[2 * L + c] = mn[q];
      }
      if (hl == 0) cout[3 * L] = cnt;
    }
  }
  team_sync();
}

static_assert(THREADS == 4 * TILE, "a quarter row of a tile per thread");

// A work item (batch element b, receivers n0 .. n1, edges e0 .. e1); w < 0
// when there is none.  A K7 tail item (padding edges) has n0 == n1: it
// writes e2 and no aggregate row.
struct Item {
  int w, b, n0, n1, e0, e1;
};

__device__ __forceinline__ Item load_item(const FwdArgs& a, int w, int work) {
  if (w >= work) return Item{-1, 0, 0, 0, 0, 0};
  const int b = w / a.G, g = w - b * a.G;
  return Item{w, b, a.groups[g], a.groups[g + 1], a.group_edges[g], a.group_edges[g + 1]};
}

__device__ __forceinline__ int item_tiles(const Item& it) {
  return it.e1 > it.e0 ? (it.e1 - it.e0 + TILE - 1) / TILE : 1;
}

// The team's tile after tile t of `it`: the item's next tile, or the first
// of the team's next item (`stride` items on).
__device__ __forceinline__ void next_tile(const FwdArgs& a, const Item& it, int t, int work,
                                          int stride, Item& nit, int& nt) {
  if (it.w >= 0 && t + 1 < item_tiles(it)) {
    nit = it;
    nt = t + 1;
  } else {
    nit = it.w < 0 ? it : load_item(a, it.w + stride, work);
    nt = 0;
  }
}

// This thread's share of one tile's loads: row team_tid() / 4 of the tile,
// quarter team_tid() % 4 of its vectors.
struct RowLoad {
  int b, edge, snd, rcv;  // edge < 0: no row
  float valid;
};

__device__ __forceinline__ RowLoad load_indices(const FwdArgs& a, const Item& it, int t) {
  RowLoad rl{0, -1, 0, 0, 0.f};
  if (it.w < 0) return rl;
  const int ts = it.e0 + t * TILE;
  const int r = team_tid() >> 2;
  if (ts + r < min(ts + TILE, it.e1)) {
    rl.b = it.b;
    rl.edge = ts + r;
    rl.snd = a.senders[rl.edge];
    rl.rcv = a.receivers[rl.edge];
    rl.valid = a.mask ? a.mask[rl.edge] : 1.f;
  }
  return rl;
}

// Issue the copies of this thread's share of one of a tile's row arrays
// into the team's buffers (0: e, with the mask; 1: SP[snd]; 2: RP[rcv]),
// and commit them as a group.
template <typename T, int L>
__device__ __forceinline__ void load_rows_async(const FwdArgs& a, const RowLoad& rl,
                                                const FwdSmem<T>& s, int which) {
  constexpr int LDT = FwdLayout<T, L>::LDT;
  constexpr int EPV = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int CPT = L / EPV / 4;           // vectors per thread and array
  static_assert(L % (4 * EPV) == 0, "a row's vectors must split over four threads");
  if (rl.edge >= 0) {
    const int r = team_tid() >> 2, c0 = (team_tid() & 3) * CPT * EPV;
    const T* src;
    T* dst;
    if (which == 0) {
      src = static_cast<const T*>(a.e) + ((size_t)rl.b * a.E + rl.edge) * L;
      dst = s.eT;
      if ((team_tid() & 3) == 0) s.val_s[r] = rl.valid;
    } else {
      src = static_cast<const T*>(which == 1 ? a.sp : a.rp) +
            ((size_t)rl.b * a.N + (which == 1 ? rl.snd : rl.rcv)) * L;
      dst = which == 1 ? s.xT : s.rT;
    }
#pragma unroll
    for (int j = 0; j < CPT; ++j) cp_async16(dst + r * LDT + c0 + j * EPV, src + c0 + j * EPV);
  }
  cp_async_commit();
}

// The three weights into shared memory by every thread of the CTA.
template <int L>
__device__ __forceinline__ void stage_weights_async(bf16* Ws, const FwdArgs& a) {
  constexpr int CH = L * int(sizeof(bf16)) / 16;  // vectors per weight row
  for (int i = threadIdx.x; i < 3 * L * CH; i += blockDim.x) {
    const int m = i / (L * CH), rem = i - m * L * CH;
    const int r = rem / CH, c = rem - r * CH;
    const bf16* w = static_cast<const bf16*>(m == 0 ? a.we : (m == 1 ? a.w2 : a.w3));
    cp_async16(Ws + (m * L + r) * (L + 8) + c * 8, w + (size_t)r * L + c * 8);
  }
}

// The teams' loop of a CTA (K1's kernel, and K7's compute CTAs): NTEAM teams,
// each starting at work item `first` (the caller gives each team its own)
// and striding by `stride` items.  The prologue issues the
// staged weights and each team's first tile together; then each team loads
// its next tile's indices while its tile computes and copies the next tile's
// rows by cp.async into each buffer as soon as it is free (RP rows into rT
// after the third product, SP rows into xT after the LayerNorm, e rows into
// eT after the pna), and reads the next work item's edge range a tile
// earlier still.  item_done(it) runs, by every thread of the team, after
// an item's last tile (K7 counts its bands there).  Every thread of the CTA
// calls it.
struct NoItemDone {
  __device__ void operator()(const Item&) const {}
};

template <typename T, int L, int NTEAM, class ItemDone = NoItemDone>
__device__ __forceinline__ void fwd_teams(const FwdArgs& args, unsigned char* smem, int first, int stride,
                                          ItemDone item_done = {}) {
  const int team = threadIdx.x / THREADS;
  const FwdSmem<T> s = fwd_carve<T, L, NTEAM>(smem, team);
  const int work = args.G * args.B;

  // prologue: the weights and each team's first tile in flight together
  if constexpr (FwdLayout<T, L>::kBf16) stage_weights_async<L>(s.Ws, args);
  fwd_params<T, L>(args, s.prm);
  Item cur = load_item(args, first, work);
  int t = 0;
  RowLoad rl = load_indices(args, cur, 0);
  for (int which = 0; which < 3; ++which) load_rows_async<T, L>(args, rl, s, which);
  Item nxt;
  int nt;
  next_tile(args, cur, 0, work, stride, nxt, nt);
  cp_async_wait_all();
  __syncthreads();  // weights, parameters and every team's first tile have landed

  while (cur.w >= 0) {
    Item after;
    int at;
    next_tile(args, nxt, nt, work, stride, after, at);  // its edge range, a tile early
    const int ts = cur.e0 + t * TILE, te = min(ts + TILE, cur.e1);
    fwd_tile<T, L>(args, s, cur.b, cur.n0, cur.n1, t, ts, te, [&](int stage) {
      if (stage == 0) {
        rl = load_indices(args, nxt, nt);
      } else {
        load_rows_async<T, L>(args, rl, s, 3 - stage);  // RP rows into rT, then SP rows into xT
      }
    });
    if constexpr (!std::is_same<ItemDone, NoItemDone>::value) {
      if (t + 1 == item_tiles(cur)) item_done(cur);
    }
    load_rows_async<T, L>(args, rl, s, 0);  // fwd_tile ended in the team's barrier
    cp_async_wait_all();
    team_sync();
    cur = nxt;
    t = nt;
    nxt = after;
    nt = at;
  }
}

// Set the kernel's dynamic shared memory (NTEAM teams of THREADS threads)
// on the current device and return how many of its CTAs fit there at once
// (negated error code on failure).  The attribute is per device, so the
// state is kept per device ordinal (and per instantiation).
template <typename T, int L, int NTEAM = 1, class Kernel>
int fwd_grid_cap(Kernel kernel) {
  static int cap[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    const int bytes = (int)FwdLayout<T, L, NTEAM>::total;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return -(int)err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return -(int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTEAM * THREADS, bytes)) !=
        cudaSuccess)
      return -(int)err;
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

}  // namespace hgn
