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
//   route = g1 + (e2 == max ? g_max : 0) + (e2 == min ? g_min : 0)
//           on valid edges (every tied edge gets the full cotangent), else 0
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
// Design (simple and right first).
// - Work items, tiles and the receiver side as in K1: one CTA owns whole
//   receiver segments, so gathering drhs and summing drp need no atomics; a
//   segment longer than a tile carries its partial drp across tiles.
// - The sender side needs a sum over edges in sender order: a second
//   kernel sums the dh stream (compute type, in float32) over a host-built
//   sender CSR, one warp per (batch element, node).  Deterministic.
// - dpar: each CTA sums its tiles' columns in a fixed order into shared
//   memory and writes one partial row; a third kernel adds the partials in
//   order.  Deterministic for a given grid.
// - bf16 products on tensor cores (mma.sync); the backward products read
//   the same staged [out][in] weights transposed (ldmatrix.trans), so three
//   matrices serve both directions.  Shared memory at L = 128, bf16:
//   weights 104 KB + four compute-type tiles 68 KB + a float32 tile of do
//   33 KB + small, 210 KB: one CTA per SM.  float32: weights read through
//   the read-only cache.
// - Rows of a partial tile past its end hold stale data; every product is
//   row-wise, and no such row is stored or summed.
// Later work: wgmma, TMA, overlap of one tile's loads with the last one's
// math, a 32-row tile for two CTAs per SM.

#include <type_traits>

#include "fused_block_common.cuh"

namespace {

using namespace hgn;

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
  const int* row_ptr;    // [N + 1]
  const int* groups;     // [G + 1]
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
};

template <typename T, int L>
struct BwdLayout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int LDT = L + Num<T>::PAD;  // compute-type tile row stride
  static constexpr int LDF = L + 4;            // float32 tile row stride
  static constexpr int LDW = L + 8;
  static constexpr size_t w_bytes = kBf16 ? align16(size_t(3) * L * LDW * sizeof(bf16)) : 0;
  static constexpr size_t tile_bytes = align16(size_t(TILE) * LDT * sizeof(T));
  static constexpr size_t ftile_bytes = align16(size_t(TILE) * LDF * sizeof(float));
  static constexpr size_t prm_bytes = align16(size_t(5) * L * sizeof(float));
  static constexpr size_t carry_bytes = align16(size_t(2) * L * sizeof(float));
  static constexpr size_t idx_bytes = align16(size_t(5) * TILE * sizeof(int));
  static constexpr size_t dpar_bytes = align16(size_t(5) * L * sizeof(float));
  static constexpr size_t total = w_bytes + 4 * tile_bytes + ftile_bytes + prm_bytes +
                                  carry_bytes + idx_bytes + dpar_bytes;
};

template <typename T, int L, bool STREAM>
__global__ void __launch_bounds__(THREADS, 1) fused_block_bwd_kernel(const BwdArgs args) {
  using Nm = Num<T>;
  using Lay = BwdLayout<T, L>;
  constexpr int LDT = Lay::LDT, LDF = Lay::LDF;
  constexpr int CPL = L / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  size_t off = 0;
  bf16* Ws = reinterpret_cast<bf16*>(smem + off);
  off += Lay::w_bytes;
  T* eT = reinterpret_cast<T*>(smem + off);  // e, then dz3
  off += Lay::tile_bytes;
  T* xT = reinterpret_cast<T*>(smem + off);  // SP rows (K2), a1, then dh
  off += Lay::tile_bytes;
  T* rT = reinterpret_cast<T*>(smem + off);  // RP rows (K2), a2, then dz2
  off += Lay::tile_bytes;
  T* zT = reinterpret_cast<T*>(smem + off);  // z3, then de
  off += Lay::tile_bytes;
  float* doT = reinterpret_cast<float*>(smem + off);  // do = de2 + route
  off += Lay::ftile_bytes;
  float* prm = reinterpret_cast<float*>(smem + off);  // b1 b2 b3 (rounded), lns, lnb
  off += Lay::prm_bytes;
  float* carry = reinterpret_cast<float*>(smem + off);  // 2 x [drp partial L]
  off += Lay::carry_bytes;
  int* snd_s = reinterpret_cast<int*>(smem + off);
  int* rcv_s = snd_s + TILE;
  float* val_s = reinterpret_cast<float*>(rcv_s + TILE);
  float* mu_s = val_s + TILE;
  float* isg_s = mu_s + TILE;
  off += Lay::idx_bytes;
  float* dpar_s = reinterpret_cast<float*>(smem + off);  // [5][L] this CTA's sums

  const int E = args.E, N = args.N, G = args.G;

  if constexpr (Lay::kBf16) {
    load_rows<bf16, L, L + 8>(Ws, static_cast<const bf16*>(args.we));
    load_rows<bf16, L, L + 8>(Ws + L * (L + 8), static_cast<const bf16*>(args.w2));
    load_rows<bf16, L, L + 8>(Ws + 2 * L * (L + 8), static_cast<const bf16*>(args.w3));
  }
  for (int c = threadIdx.x; c < L; c += THREADS) {
    prm[c] = STREAM ? 0.f : rnd<T>(args.b1[c]);
    prm[L + c] = STREAM ? 0.f : rnd<T>(args.b2[c]);
    prm[2 * L + c] = rnd<T>(args.b3[c]);
    prm[3 * L + c] = args.lns[c];
    prm[4 * L + c] = args.lnb[c];
  }
  for (int i = threadIdx.x; i < 5 * L; i += THREADS) dpar_s[i] = 0.f;
  __syncthreads();

  // A @ W^T (forward products) or A @ W (backward products) of layer `layer`
  auto matmul = [&](auto trans, const T* A, int layer, auto epi) {
    constexpr bool TR = decltype(trans)::value;
    if constexpr (Lay::kBf16) {
      tile_matmul_bf16<L, TR>(reinterpret_cast<const bf16*>(A), Ws + layer * L * (L + 8), epi);
    } else {
      const void* w = layer == 0 ? args.we : (layer == 1 ? args.w2 : args.w3);
      tile_matmul_f32<L, TR>(reinterpret_cast<const float*>(A), static_cast<const float*>(w),
                             epi);
    }
  };
  using Fwd = std::integral_constant<bool, false>;
  using Bwd = std::integral_constant<bool, true>;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long work = (long long)G * args.B;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const int b = int(w / G), grp = int(w - (long long)b * G);
    const int n0 = args.groups[grp], n1 = args.groups[grp + 1];
    const int e0 = args.row_ptr[n0], e1 = args.row_ptr[n1];
    const int ntiles = e1 > e0 ? (e1 - e0 + TILE - 1) / TILE : 1;
    const size_t eo = (size_t)b * E * L;  // this element's offset in an edge stream
    const T* de2b = static_cast<const T*>(args.de2) + eo;
    const float* drhsb = args.drhs + (size_t)b * N * 5 * L;
    float* drpb = args.drp + (size_t)b * N * L;

    for (int t = 0; t < ntiles; ++t) {
      const int ts = e0 + t * TILE;
      const int te = min(ts + TILE, e1);
      const int rows = te - ts;
      if (rows > 0) {
        for (int i = threadIdx.x; i < rows; i += THREADS) {
          snd_s[i] = args.senders[ts + i];
          rcv_s[i] = args.receivers[ts + i];
          val_s[i] = args.mask ? args.mask[ts + i] : 1.f;
          if constexpr (STREAM) {
            mu_s[i] = args.mu_in[(size_t)b * E + ts + i];
            isg_s[i] = args.isg_in[(size_t)b * E + ts + i];
          }
        }
        __syncthreads();
        const T* eb = static_cast<const T*>(args.e) + eo;
        if constexpr (STREAM) {
          load_tile<T, L, LDT, false>(eT, xT, rT, eb, static_cast<const T*>(args.a1_in) + eo,
                               static_cast<const T*>(args.a2_in) + eo, nullptr, nullptr, ts,
                               rows);
        } else {
          load_tile<T, L, LDT, true>(eT, xT, rT, eb, static_cast<const T*>(args.sp) + (size_t)b * N * L,
                               static_cast<const T*>(args.rp) + (size_t)b * N * L, snd_s, rcv_s,
                               ts, rows);
        }
        __syncthreads();

        if constexpr (!STREAM) {  // K1's layers 1 and 2: a1 -> xT, a2 -> rT
          matmul(Fwd{}, eT, 0, [&](int r, int c, float acc) {
            const float h = layer1_value<T>(acc, Nm::to_f(xT[r * LDT + c]),
                                            Nm::to_f(rT[r * LDT + c]), prm[c]);
            xT[r * LDT + c] = Nm::from_f(fmaxf(h, 0.f));
          });
          __syncthreads();
          matmul(Fwd{}, xT, 1, [&](int r, int c, float acc) {
            rT[r * LDT + c] = Nm::from_f(fmaxf(rnd<T>(bias_sum<T>(acc, prm[L + c])), 0.f));
          });
          __syncthreads();
        }
        // K1's layer 3: z3 -> zT
        matmul(Fwd{}, rT, 2, [&](int r, int c, float acc) {
          zT[r * LDT + c] = Nm::from_f(bias_sum<T>(acc, prm[2 * L + c]));
        });
        __syncthreads();

        // one warp per edge row: LayerNorm statistics (K2) or the saved ones
        // (K3), e2 as K1 made it, the routed cotangent, the LayerNorm
        // backward; do -> doT, dz3 -> eT (over e, which is no longer needed)
        for (int r = warp; r < rows; r += WARPS) {
          float z[CPL];
#pragma unroll
          for (int q = 0; q < CPL; ++q) z[q] = Nm::to_f(zT[r * LDT + lane * CPL + q]);
          float mu, isg;
          if constexpr (STREAM) {
            mu = mu_s[r];
            isg = isg_s[r];
          } else {
            ln_row_stats<L, CPL>(z, mu, isg);
            if (lane == 0) {
              mu_s[r] = mu;
              isg_s[r] = isg;
            }
          }
          const bool valid = val_s[r] > 0.f;
          const float* g = drhsb + (size_t)rcv_s[r] * 5 * L + lane * CPL;
          const Vec<T, CPL> d2 =
              *reinterpret_cast<const Vec<T, CPL>*>(de2b + (size_t)(ts + r) * L + lane * CPL);
          float xh[CPL], dx[CPL], s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int c = lane * CPL + q;
            xh[q] = ln_xhat(z[q], mu, isg);
            const float ev = rnd<T>(e2_sum<T>(Nm::to_f(eT[r * LDT + c]), xh[q], prm[3 * L + c],
                                              prm[4 * L + c]));
            float route = 0.f;
            if (valid) {
              route = rnd<T>(g[q]);
              route += ev == rnd<T>(g[L + q]) ? rnd<T>(g[2 * L + q]) : 0.f;
              route += ev == rnd<T>(g[3 * L + q]) ? rnd<T>(g[4 * L + q]) : 0.f;
            }
            const float dov = Nm::to_f(d2.v[q]) + route;
            doT[r * LDF + c] = dov;
            dx[q] = dov * prm[3 * L + c];
            s1 += dx[q];
            s2 += dx[q] * xh[q];
          }
          const float m1 = warp_sum(s1) * (1.f / L);
          const float m2 = warp_sum(s2) * (1.f / L);
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int c = lane * CPL + q;
            eT[r * LDT + c] = Nm::from_f((dx[q] - m1 - xh[q] * m2) * isg);
          }
        }
        if constexpr (!STREAM) {
          store_tile<T, L, LDT>(static_cast<T*>(args.a1_out) + eo, xT, ts, rows);
          store_tile<T, L, LDT>(static_cast<T*>(args.a2_out) + eo, rT, ts, rows);
        }
        __syncthreads();

        // dz2 = [a2 > 0] * rnd(dz3 @ W3) -> rT (over a2, element by element)
        matmul(Bwd{}, eT, 2, [&](int r, int c, float acc) {
          const bool on = Nm::to_f(rT[r * LDT + c]) > 0.f;
          rT[r * LDT + c] = Nm::from_f(on ? rnd<T>(acc) : 0.f);
        });
        __syncthreads();
        // dh = [a1 > 0] * rnd(dz2 @ W2) -> xT
        matmul(Bwd{}, rT, 1, [&](int r, int c, float acc) {
          const bool on = Nm::to_f(xT[r * LDT + c]) > 0.f;
          xT[r * LDT + c] = Nm::from_f(on ? rnd<T>(acc) : 0.f);
        });
        __syncthreads();

        // this tile's column sums into dpar_s, rows in order
        for (int i = threadIdx.x; i < 5 * L; i += THREADS) {
          const int k = i / L, c = i - k * L;
          float s = 0.f;
          for (int r = 0; r < rows; ++r) {
            float v;
            switch (k) {
              case 0: v = Nm::to_f(xT[r * LDT + c]); break;
              case 1: v = Nm::to_f(rT[r * LDT + c]); break;
              case 2: v = Nm::to_f(eT[r * LDT + c]); break;
              case 3:
                v = doT[r * LDF + c] * ln_xhat(Nm::to_f(zT[r * LDT + c]), mu_s[r], isg_s[r]);
                break;
              default: v = doT[r * LDF + c]; break;
            }
            s += v;
          }
          dpar_s[i] += s;
        }
      }

      // drp: per receiver of this group, the sum of dh over its valid edges
      // in this tile, carried across tiles; one warp per receiver
      for (int n = n0 + warp; n < n1; n += WARPS) {
        const int ns = args.row_ptr[n], ne = args.row_ptr[n + 1];
        Vec<float, CPL>* out = reinterpret_cast<Vec<float, CPL>*>(drpb + (size_t)n * L + lane * CPL);
        if (ns == ne) {
          if (t == 0) *out = Vec<float, CPL>{};
          continue;
        }
        const int lo = max(ns, ts), hi = min(ne, te);
        if (lo >= hi) continue;
        float sm[CPL];
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          sm[q] = ns >= ts ? 0.f : carry[((t + 1) & 1) * L + lane * CPL + q];
        for (int i = lo; i < hi; ++i) {
          if (!(val_s[i - ts] > 0.f)) continue;
#pragma unroll
          for (int q = 0; q < CPL; ++q) sm[q] += Nm::to_f(xT[(i - ts) * LDT + lane * CPL + q]);
        }
        if (ne <= te) {
          Vec<float, CPL> o;
#pragma unroll
          for (int q = 0; q < CPL; ++q) o.v[q] = sm[q];
          *out = o;
        } else {
#pragma unroll
          for (int q = 0; q < CPL; ++q) carry[(t & 1) * L + lane * CPL + q] = sm[q];
        }
      }
      __syncthreads();

      if (rows > 0) {
        // de = rnd(do + dh @ We) -> zT (over z3, summed above)
        matmul(Bwd{}, xT, 0, [&](int r, int c, float acc) {
          zT[r * LDT + c] = Nm::from_f(doT[r * LDF + c] + acc);
        });
        __syncthreads();
        store_tile<T, L, LDT>(static_cast<T*>(args.de) + eo, zT, ts, rows);
        store_tile<T, L, LDT>(static_cast<T*>(args.dh) + eo, xT, ts, rows);
        store_tile<T, L, LDT>(static_cast<T*>(args.dz2) + eo, rT, ts, rows);
        store_tile<T, L, LDT>(static_cast<T*>(args.dz3) + eo, eT, ts, rows);
        __syncthreads();
      }
    }
  }
  for (int i = threadIdx.x; i < 5 * L; i += THREADS)
    args.dpar_part[(size_t)blockIdx.x * 5 * L + i] = dpar_s[i];
}

// dsp[b][n] = sum of dh[b][e] over the valid edges e sent by n, in edge
// order; one warp per (b, n).
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
  *reinterpret_cast<Vec<float, CPL>*>(args.dsp + ((size_t)b * args.N + n) * L + lane * CPL) = o;
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
             &per_sm, fused_block_bwd_kernel<T, L, STREAM>, THREADS, Lay::total)) != cudaSuccess)
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
  const int grid = (int)(work < cap ? work : cap);
  if (grid > 0) {
    fused_block_bwd_kernel<T, L, STREAM>
        <<<grid, THREADS, BwdLayout<T, L>::total, stream>>>(a);
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
// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t code, or -1
// for a (dtype, L) the kernels do not take.
int hgn_fused_block_bwd(int dtype, int L, int stream_mode, const void* e, const void* sp,
                        const void* rp, const void* a1_in, const void* a2_in,
                        const float* mu_in, const float* isg_in, const void* we, const void* w2,
                        const void* w3, const float* b1, const float* b2, const float* b3,
                        const float* lns, const float* lnb, const void* de2, const float* drhs,
                        const int* senders, const int* receivers, const float* mask,
                        const int* row_ptr, const int* groups, const int* snd_perm,
                        const int* snd_ptr, void* de, void* dh, void* dz2, void* dz3,
                        void* a1_out, void* a2_out, float* dsp, float* drp, float* dpar,
                        float* dpar_part, int B, int E, int N, int G, void* stream) {
  BwdArgs a{e,         sp,      rp,      a1_in,   a2_in,     mu_in, isg_in, we,   w2,
            w3,        b1,      b2,      b3,      lns,       lnb,   de2,    drhs, senders,
            receivers, mask,    row_ptr, groups,  snd_perm,  snd_ptr, de,   dh,   dz2,
            dz3,       a1_out,  a2_out,  dsp,     drp,       dpar,  dpar_part, B, E,
            N,         G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stream_mode ? dispatch<true>(dtype, L, a, s) : dispatch<false>(dtype, L, a, s);
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
