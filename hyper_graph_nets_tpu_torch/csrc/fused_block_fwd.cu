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
// e2 and add nothing to any aggregate.
//
// What bounds it.  At the flag main-path shapes (E = 9,282 edges, N = 1,600
// nodes, L = 128, bf16) one frame reads e, SP, RP and writes e2 and agg:
// about 8.9 MB, 2.7 us at 3.35 TB/s; its three L x L products are 0.91
// GFLOP, 0.9 us at 989 TFLOP/s.  So the kernel is bound by memory traffic.
// The design keeps every intermediate (gathered rows, h, a1, a2, z3) in
// shared memory, so device memory sees each input once and each output
// once.
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
// - A segment that crosses a tile boundary carries its partial aggregate in
//   shared memory (two slots, alternating by tile parity).
// - A tile's rows are gathered by index with up to 12 16-byte loads in
//   flight per thread; e2 and agg leave as vector stores.
// Later work: wgmma, TMA, warp specialisation, more than one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // edges per tile
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr float BIG = 1e30f;

using bf16 = __nv_bfloat16;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static constexpr int PAD = 4;  // keeps rows 16-byte aligned
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
};

template <>
struct Num<bf16> {
  static constexpr int PAD = 8;
  static __device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ bf16 from_f(float x) { return __float2bfloat16_rn(x); }
};

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
  int B, E, N, G;
};

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

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

// Copy L consecutive rows of L elements (16-byte vectors) into a shared
// tile of row stride LD (the staged weights).
template <typename T, int L, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src) {
  constexpr int CH = int(L * sizeof(T) / 16);
  for (int i = threadIdx.x; i < L * CH; i += THREADS) {
    const int r = i / CH, c = i - r * CH;
    reinterpret_cast<int4*>(dst + (size_t)r * LD)[c] =
        __ldg(reinterpret_cast<const int4*>(src + (size_t)r * L) + c);
  }
}

// Gather one tile: edge rows [ts, ts + rows) of e, and the SP rows of their
// senders and the RP rows of their receivers, into the shared tiles.  Each
// thread issues up to 12 of its 16-byte loads before its first shared
// store, so they are in flight together (a loop that stores after each load
// waits out one memory latency per load); 12 caps the registers it holds.
template <typename T, int L, int LD>
__device__ __forceinline__ void load_tile(T* eT, T* xT, T* rT, const T* eb, const T* spb,
                                          const T* rpb, const int* snd_s, const int* rcv_s,
                                          int ts, int rows) {
  constexpr int CH = int(L * sizeof(T) / 16);
  constexpr int PER = TILE * CH / THREADS;  // vectors per thread and array
  constexpr int STEP = PER < 4 ? PER : 4;   // of those, in flight at once
  static_assert(TILE * CH % THREADS == 0 && PER % STEP == 0,
                "a tile's vectors must split evenly over the threads");
#pragma unroll
  for (int p0 = 0; p0 < PER; p0 += STEP) {
    int4 v[3][STEP];
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = threadIdx.x + (p0 + s) * THREADS;
      const int r = i / CH, c = i - r * CH;
      if (r < rows) {
        v[0][s] = __ldg(reinterpret_cast<const int4*>(eb + (size_t)(ts + r) * L) + c);
        v[1][s] = __ldg(reinterpret_cast<const int4*>(spb + (size_t)snd_s[r] * L) + c);
        v[2][s] = __ldg(reinterpret_cast<const int4*>(rpb + (size_t)rcv_s[r] * L) + c);
      }
    }
#pragma unroll
    for (int s = 0; s < STEP; ++s) {
      const int i = threadIdx.x + (p0 + s) * THREADS;
      const int r = i / CH, c = i - r * CH;
      if (r < rows) {
        reinterpret_cast<int4*>(eT + r * LD)[c] = v[0][s];
        reinterpret_cast<int4*>(xT + r * LD)[c] = v[1][s];
        reinterpret_cast<int4*>(rT + r * LD)[c] = v[2][s];
      }
    }
  }
}

// N consecutive elements, stored as one vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out[r][c] = sum_k A[r][k] * W[c][k] for the TILE x L tile on tensor cores.
// Warp (wm, wn) owns rows 16*wm .. +16 and columns wn*L/2 .. +L/2.  Calls
// epi(r, c, acc) once for each output element.
template <int L, class Epi>
__device__ __forceinline__ void tile_matmul_bf16(const bf16* A, const bf16* W, Epi epi) {
  constexpr int LD = L + 8;
  constexpr int NT = L / 16;  // 8-column n-tiles per warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wm * 16 + g;
  const int nbase = wn * (L / 2);
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < L; k0 += 16) {
    const uint32_t a0 = ld32(A + r0 * LD + k0 + 2 * t);
    const uint32_t a1 = ld32(A + (r0 + 8) * LD + k0 + 2 * t);
    const uint32_t a2 = ld32(A + r0 * LD + k0 + 2 * t + 8);
    const uint32_t a3 = ld32(A + (r0 + 8) * LD + k0 + 2 * t + 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = nbase + 8 * j + g;
      const uint32_t b0 = ld32(W + n * LD + k0 + 2 * t);
      const uint32_t b1 = ld32(W + n * LD + k0 + 2 * t + 8);
      mma16816(acc[j], a0, a1, a2, a3, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = nbase + 8 * j + 2 * t;
    epi(r0, c, acc[j][0]);
    epi(r0, c + 1, acc[j][1]);
    epi(r0 + 8, c, acc[j][2]);
    epi(r0 + 8, c + 1, acc[j][3]);
  }
}

// float32 variant: thread (ty, tx) of a 16 x 16 layout owns rows
// 4*ty .. +4 and columns tx + 16*j; k runs in order.
template <int L, class Epi>
__device__ __forceinline__ void tile_matmul_f32(const float* A, const float* W, Epi epi) {
  constexpr int LD = L + Num<float>::PAD;
  constexpr int TN = L / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
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
      const float4 w = __ldg(reinterpret_cast<const float4*>(W + (size_t)(tx + 16 * j) * L + k));
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
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) epi(ty * 4 + i, tx + 16 * j, acc[i][j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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
  const int E = args.E, N = args.N, G = args.G;

  if constexpr (Lay::kBf16) {
    load_rows<bf16, L, L + 8>(Ws, static_cast<const bf16*>(args.we));
    load_rows<bf16, L, L + 8>(Ws + L * (L + 8), static_cast<const bf16*>(args.w2));
    load_rows<bf16, L, L + 8>(Ws + 2 * L * (L + 8), static_cast<const bf16*>(args.w3));
  }
  for (int c = threadIdx.x; c < L; c += THREADS) {
    prm[c] = Nm::to_f(Nm::from_f(args.b1[c]));
    prm[L + c] = Nm::to_f(Nm::from_f(args.b2[c]));
    prm[2 * L + c] = Nm::to_f(Nm::from_f(args.b3[c]));
    prm[3 * L + c] = args.lns[c];
    prm[4 * L + c] = args.lnb[c];
  }
  __syncthreads();

  auto matmul = [&](const T* A, int layer, auto epi) {
    if constexpr (Lay::kBf16) {
      tile_matmul_bf16<L>(reinterpret_cast<const bf16*>(A), Ws + layer * L * (L + 8), epi);
    } else {
      const void* w = layer == 0 ? args.we : (layer == 1 ? args.w2 : args.w3);
      tile_matmul_f32<L>(reinterpret_cast<const float*>(A), static_cast<const float*>(w), epi);
    }
  };
  auto rnd = [](float v) { return Nm::to_f(Nm::from_f(v)); };

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
        load_tile<T, L, LDT>(eT, xT, rT, eb, spb, rpb, snd_s, rcv_s, ts, rows);
        __syncthreads();

        // layer 1 (factored): h = ((e@We + SP[snd]) + RP[rcv]) + b1; a1 -> xT
        matmul(eT, 0, [&](int r, int c, float acc) {
          float h = rnd(acc);
          h = rnd(h + Nm::to_f(xT[r * LDT + c]));
          h = rnd(h + Nm::to_f(rT[r * LDT + c]));
          h = rnd(h + prm[c]);
          xT[r * LDT + c] = Nm::from_f(fmaxf(h, 0.f));
        });
        __syncthreads();
        // layer 2: a2 = relu(a1@W2 + b2) -> rT
        matmul(xT, 1, [&](int r, int c, float acc) {
          const float z = rnd(rnd(acc) + prm[L + c]);
          rT[r * LDT + c] = Nm::from_f(fmaxf(z, 0.f));
        });
        __syncthreads();
        // layer 3: z3 = a2@W3 + b3 -> xT
        matmul(rT, 2, [&](int r, int c, float acc) {
          xT[r * LDT + c] = Nm::from_f(rnd(acc) + prm[2 * L + c]);
        });
        __syncthreads();

        // LayerNorm with float32 statistics, residual in the compute type;
        // one warp per edge row.  e2 goes to device memory and to eT.
        for (int r = warp; r < rows; r += WARPS) {
          float z[CPL];
          float s = 0.f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            z[q] = Nm::to_f(xT[r * LDT + lane * CPL + q]);
            s += z[q];
          }
          const float mu = warp_sum(s) * (1.f / L);
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const float d = z[q] - mu;
            v += d * d;
          }
          const float isg = rsqrtf(warp_sum(v) * (1.f / L) + 1e-5f);
          Vec<T, CPL> out;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int c = lane * CPL + q;
            const float o = (z[q] - mu) * isg * prm[3 * L + c] + prm[4 * L + c];
            out.v[q] = Nm::from_f(Nm::to_f(eT[r * LDT + c]) + rnd(o));
            eT[r * LDT + c] = out.v[q];
          }
          *reinterpret_cast<Vec<T, CPL>*>(e2b + (size_t)(ts + r) * L + lane * CPL) = out;
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

// dtype: 0 = float32, 1 = bfloat16.  Returns 0, a cudaError_t code, or -1
// for a (dtype, L) the kernel does not take.
int hgn_fused_block_fwd(int dtype, int L, const void* e, const void* sp, const void* rp,
                        const void* we, const void* w2, const void* w3, const float* b1,
                        const float* b2, const float* b3, const float* lns, const float* lnb,
                        const int* senders, const int* receivers, const float* mask,
                        const int* row_ptr, const int* groups, void* e2, float* agg, int B,
                        int E, int N, int G, void* stream) {
  Args a{e,       sp,        rp,   we,      w2,     w3, b1,  b2, b3, lns, lnb,
         senders, receivers, mask, row_ptr, groups, e2, agg, B,  E,  N,   G};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_width<float>(L, a, s);
  if (dtype == 1) return dispatch_width<bf16>(L, a, s);
  return -1;
}

const char* hgn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
