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
// compute type and the LayerNorm mean and inverse sigma of each edge.
//
// What bounds it.  At the flag main-path shapes (E = 9,282 edges, N = 1,600
// nodes, L = 128, bf16) one frame reads e, SP, RP and writes e2 and agg:
// about 8.9 MB, 2.7 us at 3.35 TB/s (with the streams, 4.8 MB more); its
// three L x L products are 0.91 GFLOP, 0.9 us at 989 TFLOP/s.  So the
// kernel is bound by memory traffic.  The design keeps every intermediate
// (gathered rows, h, a1, a2, z3) in shared memory, so device memory sees
// each input once and each output once.
//
// Design (simple and right first).
// - The host splits the receivers into groups of whole segments holding at
//   most TILE edges each (a receiver with more edges forms its own group and
//   spans several tiles).  One work item is (batch element, group); CTAs are
//   persistent and stride over work items.  Because a CTA owns whole
//   segments, the aggregate needs no atomics and no second pass, and the
//   result does not depend on scheduling.
// - bf16: the three weight matrices are staged once per CTA in shared
//   memory ([out][in], rows padded by 8 so the fragment loads of one warp
//   hit 32 distinct banks), and the products run on tensor cores with
//   mma.sync m16n8k16 (bf16 in, float32 accumulate).  float32: the
//   products are float32 FMA in the same tile loop, weights read through
//   the read-only cache.
// - The chain h -> a1 -> a2 -> z3 -> LayerNorm -> e2 is the shared code of
//   fused_block_common.cuh, which the backward kernels recompute with.
// - A segment that crosses a tile boundary carries its partial aggregate in
//   shared memory (two slots, alternating by tile parity).
// - A tile's rows are gathered by index with up to 12 16-byte loads in
//   flight per thread; e2 and agg leave as vector stores.
// Later work: wgmma, TMA, warp specialisation, more than one CTA per SM.

#include "fused_block_common.cuh"

namespace {

using namespace hgn;

struct Args {
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
};

template <typename T, int L>
struct Layout {
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

template <typename T, int L>
__global__ void __launch_bounds__(THREADS, 1) fused_block_fwd_kernel(const Args args) {
  using Nm = Num<T>;
  using Lay = Layout<T, L>;
  constexpr int LDT = Lay::LDT;
  constexpr int CPL = L / 32;  // columns per lane in the row phases

  extern __shared__ __align__(16) unsigned char smem[];
  size_t off = 0;
  bf16* Ws = reinterpret_cast<bf16*>(smem + off);
  off += Lay::w_bytes;
  T* eT = reinterpret_cast<T*>(smem + off);  // e, then e2
  off += Lay::tile_bytes;
  T* xT = reinterpret_cast<T*>(smem + off);  // SP rows, then a1, then z3
  off += Lay::tile_bytes;
  T* rT = reinterpret_cast<T*>(smem + off);  // RP rows, then a2
  off += Lay::tile_bytes;
  float* prm = reinterpret_cast<float*>(smem + off);  // b1 b2 b3 (rounded), lns, lnb
  off += Lay::prm_bytes;
  float* carry = reinterpret_cast<float*>(smem + off);  // 2 x [sum L | max L | min L | cnt]
  off += Lay::carry_bytes;
  int* snd_s = reinterpret_cast<int*>(smem + off);
  int* rcv_s = snd_s + TILE;
  float* val_s = reinterpret_cast<float*>(rcv_s + TILE);

  const T* e = static_cast<const T*>(args.e);
  const T* sp = static_cast<const T*>(args.sp);
  const T* rp = static_cast<const T*>(args.rp);
  T* e2 = static_cast<T*>(args.e2);
  const bool streams = args.a1 != nullptr;
  const int E = args.E, N = args.N, G = args.G;

  if constexpr (Lay::kBf16) {
    load_rows<bf16, L, L + 8>(Ws, static_cast<const bf16*>(args.we));
    load_rows<bf16, L, L + 8>(Ws + L * (L + 8), static_cast<const bf16*>(args.w2));
    load_rows<bf16, L, L + 8>(Ws + 2 * L * (L + 8), static_cast<const bf16*>(args.w3));
  }
  for (int c = threadIdx.x; c < L; c += THREADS) {
    prm[c] = rnd<T>(args.b1[c]);
    prm[L + c] = rnd<T>(args.b2[c]);
    prm[2 * L + c] = rnd<T>(args.b3[c]);
    prm[3 * L + c] = args.lns[c];
    prm[4 * L + c] = args.lnb[c];
  }
  __syncthreads();

  auto matmul = [&](const T* A, int layer, auto epi) {
    if constexpr (Lay::kBf16) {
      tile_matmul_bf16<L, false>(reinterpret_cast<const bf16*>(A), Ws + layer * L * (L + 8), epi);
    } else {
      const void* w = layer == 0 ? args.we : (layer == 1 ? args.w2 : args.w3);
      tile_matmul_f32<L, false>(reinterpret_cast<const float*>(A), static_cast<const float*>(w),
                                epi);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long work = (long long)G * args.B;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const int b = int(w / G), grp = int(w - (long long)b * G);
    const int n0 = args.groups[grp], n1 = args.groups[grp + 1];
    const int e0 = args.row_ptr[n0], e1 = args.row_ptr[n1];
    const int ntiles = e1 > e0 ? (e1 - e0 + TILE - 1) / TILE : 1;
    const T* eb = e + (size_t)b * E * L;
    const T* spb = sp + (size_t)b * N * L;
    const T* rpb = rp + (size_t)b * N * L;
    T* e2b = e2 + (size_t)b * E * L;
    float* aggb = args.agg + (size_t)b * N * 4 * L;

    for (int t = 0; t < ntiles; ++t) {
      const int ts = e0 + t * TILE;
      const int te = min(ts + TILE, e1);
      const int rows = te - ts;
      if (rows > 0) {
        for (int i = threadIdx.x; i < rows; i += THREADS) {
          snd_s[i] = args.senders[ts + i];
          rcv_s[i] = args.receivers[ts + i];
          val_s[i] = args.mask ? args.mask[ts + i] : 1.f;
        }
        __syncthreads();
        load_tile<T, L, LDT, true>(eT, xT, rT, eb, spb, rpb, snd_s, rcv_s, ts, rows);
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
        // lane's CPL columns of part k (sum, mean, max, min) of the output row
        auto part = [&](int k) {
          return reinterpret_cast<Vec<float, CPL>*>(aggb + (size_t)n * 4 * L + k * L + lane * CPL);
        };
        if (ns == ne) {
          if (t == 0) {
            const Vec<float, CPL> zero{};
#pragma unroll
            for (int k = 0; k < 4; ++k) *part(k) = zero;
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
          if (!(val_s[i - ts] > 0.f)) continue;
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
          Vec<float, CPL> o_sum, o_mean, o_max, o_min;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            o_sum.v[q] = sm[q];
            o_mean.v[q] = sm[q] / den;
            o_max.v[q] = any ? mx[q] : 0.f;
            o_min.v[q] = any ? mn[q] : 0.f;
          }
          *part(0) = o_sum;
          *part(1) = o_mean;
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
}

template <typename T, int L>
int launch(const Args& a, cudaStream_t stream) {
  using Lay = Layout<T, L>;
  static int grid_cap = 0;  // CTAs that fit on the card at once
  if (grid_cap == 0) {
    cudaError_t err = cudaFuncSetAttribute(fused_block_fwd_kernel<T, L>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)Lay::total);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fused_block_fwd_kernel<T, L>, THREADS, Lay::total)) != cudaSuccess)
      return (int)err;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long work = (long long)a.G * a.B;
  if (work == 0) return 0;
  const int grid = (int)(work < grid_cap ? work : grid_cap);
  fused_block_fwd_kernel<T, L><<<grid, THREADS, Lay::total, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_width(int L, const Args& a, cudaStream_t s) {
  switch (L) {
    case 32: return launch<T, 32>(a, s);
    case 128: return launch<T, 128>(a, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  a1, a2, mu, isg are all null (no
// streams) or all set.  Returns 0, a cudaError_t code, or -1 for a
// (dtype, L) the kernel does not take.
int hgn_fused_block_fwd(int dtype, int L, const void* e, const void* sp, const void* rp,
                        const void* we, const void* w2, const void* w3, const float* b1,
                        const float* b2, const float* b3, const float* lns, const float* lnb,
                        const int* senders, const int* receivers, const float* mask,
                        const int* row_ptr, const int* groups, void* e2, float* agg, void* a1,
                        void* a2, float* mu, float* isg, int B, int E, int N, int G,
                        void* stream) {
  Args a{e,       sp,        rp,   we,      w2,     w3, b1,  b2, b3, lns, lnb, senders, receivers,
         mask,    row_ptr,   groups, e2,    agg,    a1, a2,  mu, isg, B,  E,   N,   G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_width<float>(L, a, s);
  if (dtype == 1) return dispatch_width<bf16>(L, a, s);
  return -1;
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
