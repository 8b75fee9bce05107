// The fused edge-block forward of one work item, shared by K1
// (fused_block_fwd.cu) and K7 (fused_overlap.cu).
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
// type, and the aggregate sums the rounded e2 in float32.

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
  int raw;  // 1: write the unfinalized partials
};

template <typename T, int L>
struct FwdLayout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LDT = L + Num<T>::PAD;  // tile row stride (elements)
  static constexpr int LDW = L + 8;            // staged weight row stride (bf16)
  static constexpr size_t w_bytes = kBf16 ? align16(size_t(3) * L * LDW * sizeof(bf16)) : 0;
  static constexpr size_t tile_bytes = align16(size_t(TILE) * LDT * sizeof(T));
  static constexpr size_t prm_bytes = align16(size_t(5) * L * sizeof(float));
  static constexpr size_t carry_bytes = align16(size_t(2) * (3 * L + 1) * sizeof(float));
  static constexpr size_t idx_bytes = align16(size_t(3) * TILE * sizeof(int));
  static constexpr size_t total = w_bytes + 3 * tile_bytes + prm_bytes + carry_bytes + idx_bytes;
};

// A CTA's shared arrays.
template <typename T>
struct FwdSmem {
  bf16* Ws;      // staged weights (bf16 only)
  T* eT;         // e, then e2
  T* xT;         // SP rows, then a1, then z3
  T* rT;         // RP rows, then a2
  float* prm;    // b1 b2 b3 (rounded), lns, lnb
  float* carry;  // 2 x [sum L | max L | min L | cnt]
  int* snd_s;
  int* rcv_s;
  float* val_s;
};

// Carve the shared arrays and stage the weights; once per CTA, ends in a
// barrier.
template <typename T, int L>
__device__ __forceinline__ FwdSmem<T> fwd_setup(const FwdArgs& args, unsigned char* smem) {
  using Lay = FwdLayout<T, L>;
  FwdSmem<T> s;
  size_t off = 0;
  s.Ws = reinterpret_cast<bf16*>(smem + off);
  off += Lay::w_bytes;
  s.eT = reinterpret_cast<T*>(smem + off);
  off += Lay::tile_bytes;
  s.xT = reinterpret_cast<T*>(smem + off);
  off += Lay::tile_bytes;
  s.rT = reinterpret_cast<T*>(smem + off);
  off += Lay::tile_bytes;
  s.prm = reinterpret_cast<float*>(smem + off);
  off += Lay::prm_bytes;
  s.carry = reinterpret_cast<float*>(smem + off);
  off += Lay::carry_bytes;
  s.snd_s = reinterpret_cast<int*>(smem + off);
  s.rcv_s = s.snd_s + TILE;
  s.val_s = reinterpret_cast<float*>(s.rcv_s + TILE);

  if constexpr (Lay::kBf16) {
    load_rows<bf16, L, L + 8>(s.Ws, static_cast<const bf16*>(args.we));
    load_rows<bf16, L, L + 8>(s.Ws + L * (L + 8), static_cast<const bf16*>(args.w2));
    load_rows<bf16, L, L + 8>(s.Ws + 2 * L * (L + 8), static_cast<const bf16*>(args.w3));
  }
  for (int c = threadIdx.x; c < L; c += THREADS) {
    s.prm[c] = rnd<T>(args.b1[c]);
    s.prm[L + c] = rnd<T>(args.b2[c]);
    s.prm[2 * L + c] = rnd<T>(args.b3[c]);
    s.prm[3 * L + c] = args.lns[c];
    s.prm[4 * L + c] = args.lnb[c];
  }
  __syncthreads();
  return s;
}

// One work item: batch element b, group grp.  Every thread of the CTA
// calls it; it ends in a barrier.
template <typename T, int L>
__device__ __forceinline__ void fwd_item(const FwdArgs& args, const FwdSmem<T>& s, int b,
                                         int grp) {
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
      tile_matmul_bf16<L, false>(reinterpret_cast<const bf16*>(A), s.Ws + layer * L * (L + 8), epi);
    } else {
      const void* w = layer == 0 ? args.we : (layer == 1 ? args.w2 : args.w3);
      tile_matmul_f32<L, false>(reinterpret_cast<const float*>(A), static_cast<const float*>(w),
                                epi);
    }
  };

  const bool streams = args.a1 != nullptr;
  const bool raw = args.raw != 0;
  const int E = args.E, N = args.N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = args.groups[grp], n1 = args.groups[grp + 1];
  const int e0 = args.row_ptr[n0], e1 = args.row_ptr[n1];
  const int ntiles = e1 > e0 ? (e1 - e0 + TILE - 1) / TILE : 1;
  const T* eb = static_cast<const T*>(args.e) + (size_t)b * E * L;
  const T* spb = static_cast<const T*>(args.sp) + (size_t)b * N * L;
  const T* rpb = static_cast<const T*>(args.rp) + (size_t)b * N * L;
  T* e2b = static_cast<T*>(args.e2) + (size_t)b * E * L;
  float* aggb = args.agg + (size_t)b * N * 4 * L;

  for (int t = 0; t < ntiles; ++t) {
    const int ts = e0 + t * TILE;
    const int te = min(ts + TILE, e1);
    const int rows = te - ts;
    if (rows > 0) {
      for (int i = threadIdx.x; i < rows; i += THREADS) {
        s.snd_s[i] = args.senders[ts + i];
        s.rcv_s[i] = args.receivers[ts + i];
        s.val_s[i] = args.mask ? args.mask[ts + i] : 1.f;
      }
      __syncthreads();
      load_tile<T, L, LDT, true>(eT, xT, rT, eb, spb, rpb, s.snd_s, s.rcv_s, ts, rows);
      __syncthreads();

      // layer 1 (factored): h = ((e@We + SP[snd]) + RP[rcv]) + b1; a1 -> xT
      matmul(eT, 0, [&](int r, int c, float acc) {
        const float h = layer1_value<T>(acc, Nm::to_f(xT[r * LDT + c]),
                                        Nm::to_f(rT[r * LDT + c]), prm[c]);
        xT[r * LDT + c] = Nm::from_f(fmaxf(h, 0.f));
      });
      __syncthreads();
      // layer 2: a2 = relu(a1@W2 + b2) -> rT
      matmul(xT, 1, [&](int r, int c, float acc) {
        rT[r * LDT + c] = Nm::from_f(fmaxf(rnd<T>(bias_sum<T>(acc, prm[L + c])), 0.f));
      });
      __syncthreads();
      if (streams) {  // a1 leaves before layer 3 overwrites it
        const size_t o = (size_t)b * E * L;
        store_tile<T, L, LDT>(static_cast<T*>(args.a1) + o, xT, ts, rows);
        store_tile<T, L, LDT>(static_cast<T*>(args.a2) + o, rT, ts, rows);
        __syncthreads();
      }
      // layer 3: z3 = a2@W3 + b3 -> xT
      matmul(rT, 2, [&](int r, int c, float acc) {
        xT[r * LDT + c] = Nm::from_f(bias_sum<T>(acc, prm[2 * L + c]));
      });
      __syncthreads();

      // LayerNorm with float32 statistics, residual in the compute type;
      // one warp per edge row.  e2 goes to device memory and to eT.
      for (int r = warp; r < rows; r += WARPS) {
        float z[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q) z[q] = Nm::to_f(xT[r * LDT + lane * CPL + q]);
        float mu, isg;
        ln_row_stats<L, CPL>(z, mu, isg);
        Vec<T, CPL> out;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane * CPL + q;
          out.v[q] = Nm::from_f(e2_sum<T>(Nm::to_f(eT[r * LDT + c]), ln_xhat(z[q], mu, isg),
                                          prm[3 * L + c], prm[4 * L + c]));
          eT[r * LDT + c] = out.v[q];
        }
        *reinterpret_cast<Vec<T, CPL>*>(e2b + (size_t)(ts + r) * L + lane * CPL) = out;
        if (streams && lane == 0) {
          args.mu[(size_t)b * E + ts + r] = mu;
          args.isg[(size_t)b * E + ts + r] = isg;
        }
      }
      __syncthreads();
    }

    // pna over the receivers of this group that have edges in this tile;
    // one warp per receiver, lane owns CPL columns.
    for (int n = n0 + warp; n < n1; n += WARPS) {
      const int ns = args.row_ptr[n], ne = args.row_ptr[n + 1];
      // lane's CPL columns of part k of the output row
      auto part = [&](int k) {
        return reinterpret_cast<Vec<float, CPL>*>(aggb + (size_t)n * 4 * L + k * L + lane * CPL);
      };
      if (ns == ne) {
        if (t == 0) {
          Vec<float, CPL> zero{}, lo, hi;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            lo.v[q] = raw ? -BIG : 0.f;
            hi.v[q] = raw ? BIG : 0.f;
          }
          *part(0) = zero;
          *part(1) = zero;
          *part(2) = lo;
          *part(3) = hi;
        }
        continue;
      }
      const int lo = max(ns, ts), hi = min(ne, te);
      if (lo >= hi) continue;
      float sm[CPL], mx[CPL], mn[CPL], cnt;
      if (ns >= ts) {
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          sm[q] = 0.f;
          mx[q] = -BIG;
          mn[q] = BIG;
        }
        cnt = 0.f;
      } else {  // continues a segment from the previous tile
        const float* cin = carry + ((t + 1) & 1) * (3 * L + 1);
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane * CPL + q;
          sm[q] = cin[c];
          mx[q] = cin[L + c];
          mn[q] = cin[2 * L + c];
        }
        cnt = cin[3 * L];
      }
      for (int i = lo; i < hi; ++i) {
        if (!(s.val_s[i - ts] > 0.f)) continue;
        cnt += 1.f;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const float v = Nm::to_f(eT[(i - ts) * LDT + lane * CPL + q]);
          sm[q] += v;
          mx[q] = fmaxf(mx[q], v);
          mn[q] = fminf(mn[q], v);
        }
      }
      if (ne <= te) {
        const float den = fmaxf(cnt, 1.f);
        const bool any = cnt > 0.f;
        Vec<float, CPL> o_sum, o_mid, o_max, o_min;
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          o_sum.v[q] = sm[q];
          o_mid.v[q] = raw ? cnt : sm[q] / den;
          o_max.v[q] = (raw || any) ? mx[q] : 0.f;
          o_min.v[q] = (raw || any) ? mn[q] : 0.f;
        }
        *part(0) = o_sum;
        *part(1) = o_mid;
        *part(2) = o_max;
        *part(3) = o_min;
      } else {
        float* cout = carry + (t & 1) * (3 * L + 1);
#pragma unroll
        for (int q = 0; q < CPL; ++q) {
          const int c = lane * CPL + q;
          cout[c] = sm[q];
          cout[L + c] = mx[q];
          cout[2 * L + c] = mn[q];
        }
        if (lane == 0) cout[3 * L] = cnt;
      }
    }
    __syncthreads();
  }
}

// Set the kernel's dynamic shared memory on the current device and return
// how many of its CTAs fit there at once (negated error code on failure).
// The attribute is per device, so the state is kept per device ordinal.
template <typename T, int L, class Kernel>
int fwd_grid_cap(Kernel kernel) {
  static int cap[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (cap[dev] == 0) {
    const int bytes = (int)FwdLayout<T, L>::total;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return -(int)err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return -(int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, bytes)) !=
        cudaSuccess)
      return -(int)err;
    cap[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return cap[dev];
}

}  // namespace hgn
