// The ring protocol shared by K6 (ring.cu) and K7 (fused_overlap.cu), for
// Hopper (sm_90a).
//
// Each rank has its own stream (and, on a node with several cards, its own
// card); the ranks of a sub-ring lie in one process, or in several
// processes of one node (a pod), each process launching its own.  Every rank
// owns, per sub-ring: two comm slots (a region of its [2][P] float32 slot
// buffer) and a row of FLAG_WORDS flags in device memory: READY (the
// messages delivered into my slots this call), CREDIT (the messages my
// right neighbour has consumed) and two barrier words.  A neighbour in
// another process reaches them through a CUDA IPC mapping.  A rank writes
// into its right neighbour's slots with plain stores and publishes them
// with a release store on the neighbour's flag: st.release.sys when the
// ranks span several cards (right across NVLink) or processes,
// st.release.gpu when every rank is on one card in one process.
//
// Hop schedule, the TPU kernel's (ops/pallas/ring.py:60-132): out = x_r; at
// hop s = 0 .. n-2 rank r sends what it holds (x_r at hop 0, then what it
// received at hop s-1) to rank r+1 and folds the partial of rank r-1-s into
// out.  Every rank therefore folds in the order x_r, x_{r-1}, ...,
// x_{r-n+1}, exactly as the JAX ring does on that device.
//
// How a sub-ring runs (ring_run).  Its floats [e0, e1) are cut into chunks
// of whole units (K6: 4 floats; K7: a row), a window of chunks at a time
// whose accumulators fit in shared memory.  For a window:
// - x_r's chunks land in the accumulators by one TMA bulk copy; hop 0 sends
//   each chunk from there (message (0, k));
// - at hop s, chunk k's message (s, k) lands in a stage buffer by a TMA bulk
//   copy, and one pass over the stage folds it into the accumulator and, while
//   hops remain, writes it on to the right neighbour's slot as message
//   (s + 1, k): each received partial is read once;
// - the last hop's pass leaves chunk k final (K7 finalizes it in shared
//   memory), and a TMA bulk copy writes it to out.
// So a rank moves 2nP bytes per call (x read, n-1 messages sent, n-1
// received, out written), and each chunk is signalled on its own: a
// neighbour folds and forwards chunk k while chunk k+1 is still landing.
//
// Roles.  Lane 0 of warp 0 is the control thread: it does every wait on a
// neighbour (the barrier, READY, CREDIT; K7's band counter), issues the TMA
// copies, and after each pass fences and publishes the flags.  It polls what
// it waits for, so a pass is published as soon as its workers are done
// while the next message's copy is already in flight (NSTAGE stage
// buffers).  The other warps are the workers: they wait on the stage's
// mbarrier, fold and forward, and arrive on the pass's mbarrier.
//
// Messages are numbered per call in the order every rank sends them
// (window by window, hop-major within a window); READY holds epoch *
// STEP_SPAN + the number of the last message delivered, CREDIT epoch *
// STEP_SPAN + the number of the last message consumed.  Message (s, k)
// lands in slot s % 2 at the chunk's offset, so before a rank writes
// (s + 1, k) for s + 1 >= 2 it waits for its right neighbour to have
// consumed (s - 1, k).
//
// Flags never reset.  Each call passes an epoch (the group's host counter,
// the same on every rank); a wait compares against epoch * STEP_SPAN + m,
// so a signal of an earlier call can never satisfy a later one.  The
// barrier (each rank tells both neighbours it has started this epoch, and
// waits for its right neighbour) keeps a rank from writing a neighbour's
// slots while that neighbour may still read them in the previous call.
// Every spin is bounded (SPIN_NS); on expiry the control thread writes what
// it waited for into a host-mapped error word and traps, so a launch that
// runs without its neighbours (serialized kernels) fails instead of hanging.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hgn_ring {

using u64 = unsigned long long;

constexpr int FLAG_WORDS = 8;  // flag row of one sub-ring
constexpr int READY = 0;       // messages delivered into my slots
constexpr int CREDIT = 1;      // messages my right neighbour has consumed
constexpr int BAR_LEFT = 2;    // my left neighbour has started epoch e
constexpr int BAR_RIGHT = 3;   // my right neighbour has started epoch e
constexpr u64 STEP_SPAN = 1ull << 32;  // more than the messages of one call
constexpr u64 SPIN_NS = 2000000000ull;
constexpr int NSTAGE = 2;         // stage buffers: messages in flight per sub-ring
constexpr size_t BAR_BYTES = 64;  // the mbarriers, ahead of the stage buffers
constexpr int CONTROL = 32;       // threads of the control warp (lane 0 works)

enum Op { KEEP = -1, SUM = 0, MAX = 1, MIN = 2 };
enum WaitKind { W_BARRIER = 1, W_CREDIT = 2, W_READY = 3, W_BAND = 4 };

// Phase probe (HGN_RING_PHASES, never set by the main path's build): the
// control thread reads clock64 as it goes and adds each stretch to what it
// did or waited for (a waiting stretch goes to what held it up: a neighbour's
// READY or CREDIT, x_r's copy, or the workers' pass), with its CTA count,
// into a device array; K7's compute teams add their cycles and work items.
// hgn_ring_phases reads and clears it.
enum Phase { P_BARRIER, P_BAND, P_LOAD, P_READY, P_CREDIT, P_FOLD, P_ISSUE, P_SIGNAL, P_STORE, P_END };
#define HGN_RING_PHASE_NAMES "barrier,band,load,ready,credit,fold,issue,signal,store,end"
#ifdef HGN_RING_PHASES
constexpr int RING_NPHASE = 10;
__device__ unsigned long long hgn_ring_phase_cycles[RING_NPHASE + 3];
struct RingClock {
  unsigned long long acc[RING_NPHASE];
  long long last;
  __device__ __forceinline__ void start() {
    for (int p = 0; p < RING_NPHASE; ++p) acc[p] = 0;
    last = clock64();
  }
  __device__ __forceinline__ void mark(int p) {
    const long long now = clock64();
    acc[p] += now - last;
    last = now;
  }
  __device__ __forceinline__ void flush() {
    for (int p = 0; p < RING_NPHASE; ++p)
      if (acc[p]) atomicAdd(&hgn_ring_phase_cycles[p], acc[p]);
    atomicAdd(&hgn_ring_phase_cycles[RING_NPHASE], 1ull);
  }
};
__device__ __forceinline__ long long compute_clock() { return clock64(); }
__device__ __forceinline__ void compute_done(long long t0, unsigned items) {
  atomicAdd(&hgn_ring_phase_cycles[RING_NPHASE + 1], (unsigned long long)(clock64() - t0));
  atomicAdd(&hgn_ring_phase_cycles[RING_NPHASE + 2], (unsigned long long)items);
}
#else
struct RingClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush() {}
};
__device__ __forceinline__ long long compute_clock() { return 0; }
__device__ __forceinline__ void compute_done(long long, unsigned) {}
#endif

// One CTA's sub-ring.
struct Ring {
  u64* mine;          // my flag row
  u64* left;          // the left neighbour's row of this sub-ring
  u64* right;         // the right neighbour's row
  float* slot_mine;   // my slot buffer [2][P]
  float* slot_right;  // the right neighbour's
  size_t P;           // floats per slot
  int n, rank, sub;
  u64 epoch;
  int* err;  // host-mapped [4]: what timed out, global rank, step, sub-ring
  bool sys;  // flags at system scope (ranks on several cards or processes), else card scope
};

// A flag's scope: the card (every rank of the group on one card, in one
// process) or the system (ranks on several cards, across NVLink, or in
// several processes).  On one card a
// system-scope release costs several times a card-scope one, and the ring
// makes one per chunk.  HGN_RING_SYS_SCOPE (a tuning build of
// tools/torch_port/ring_sweep.py, never the main path's) keeps the system
// scope on one card too.
#ifdef HGN_RING_SYS_SCOPE
constexpr bool FORCE_SYS = true;
#else
constexpr bool FORCE_SYS = false;
#endif

__device__ __forceinline__ u64 ld_acquire(const u64* p, bool sys) {
  u64 v;
  if (sys)
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  else
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p, bool) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v, bool sys) {
  if (sys)
    asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
  else
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 now_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __noinline__ void fail(int* err, int kind, int rank, int step, int sub) {
  volatile int* e = err;
  e[1] = rank;
  e[2] = step;
  e[3] = sub;
  __threadfence_system();
  e[0] = kind;
  __threadfence_system();
  __trap();
}

// One thread waits until *p >= target, at most SPIN_NS.
template <typename W>
__device__ __forceinline__ void wait_ge(const W* p, W target, const Ring& R, int kind, int step) {
  if (ld_acquire(p, R.sys) >= target) return;
  const u64 t0 = now_ns();
  while (ld_acquire(p, R.sys) < target) {
    if (now_ns() - t0 > SPIN_NS) fail(R.err, kind, R.rank, step, R.sub);
    __nanosleep(32);
  }
}

// -- mbarriers and TMA bulk copies (1-D, 16-byte aligned, multiples of 16 bytes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_inval(u64* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Has the barrier completed the phase of this parity?
__device__ __forceinline__ bool mbar_test(u64* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Writes of the generic proxy (another SM's stores, acquired through a
// flag) before reads of the async proxy (a TMA copy), and back.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async;" ::: "memory"); }

__device__ __forceinline__ size_t lesser(size_t a, size_t b) { return a < b ? a : b; }

__device__ __forceinline__ float combine(int op, float a, float b) {
  if (op == SUM) return __fadd_rn(a, b);
  if (isnan(a) || isnan(b)) return __fadd_rn(a, b);  // NaN, as jnp.maximum gives
  if (op == MAX) return fmaxf(a, b);
  if (op == MIN) return fminf(a, b);
  return a;
}

// Fold four floats at payload offset e: one op for the four (VEC 4: the
// units of a row share it), or one each (VEC 1: a row of C % 4 != 0 floats
// may end inside the vector).
template <int VEC, class OpOf>
__device__ __forceinline__ void fold4(float4& a, const float4& b, size_t e, OpOf op_of) {
  if (VEC == 4) {
    const int op = op_of(e);
    if (op == KEEP) return;
    a.x = combine(op, a.x, b.x);
    a.y = combine(op, a.y, b.y);
    a.z = combine(op, a.z, b.z);
    a.w = combine(op, a.w, b.w);
  } else {
    int op = op_of(e);
    if (op != KEEP) a.x = combine(op, a.x, b.x);
    if ((op = op_of(e + 1)) != KEEP) a.y = combine(op, a.y, b.y);
    if ((op = op_of(e + 2)) != KEEP) a.z = combine(op, a.z, b.z);
    if ((op = op_of(e + 3)) != KEEP) a.w = combine(op, a.w, b.w);
  }
}

// No finalize (K6) and no wait before x_r is read (K6: x_r is the caller's).
struct NoFinalize {
  static constexpr bool active = false;
  __device__ void operator()(float*, size_t, int, int, int) const {}
};
struct NoWait {
  __device__ void operator()(RingClock&) const {}
};

// The worker warps' barrier (named barrier 1).
__device__ __forceinline__ void workers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"((int)blockDim.x - CONTROL) : "memory");
}

// Floats per chunk for a sub-ring of `len` floats in units of `unit`: as
// many chunks as max_chunk allows, made equal.
__device__ __forceinline__ int chunk_floats(size_t len, int unit, int max_chunk) {
  const size_t units = len / unit, per = max_chunk / unit;
  const size_t chunks = (units + per - 1) / per;
  return (int)((units + chunks - 1) / chunks) * unit;
}

// Invalidate ring_run's mbarriers (by one thread, after every thread of the
// CTA has left ring_run), so that a later ring_run on the same shared
// memory may initialize them again (K7's next frame).
__device__ __forceinline__ void ring_smem_release(unsigned char* smem) {
  u64* bars = reinterpret_cast<u64*>(smem);
  for (int j = 0; j < 2 * NSTAGE + 1; ++j) mbar_inval(bars + j);
}

// The sub-ring of floats [e0, e1) (multiples of `unit`, itself a multiple
// of 4): out = the fold of every rank's x over it.  smem holds `smem_bytes`
// (the mbarriers, NSTAGE stages and at least one accumulator of max_chunk
// floats); before x_r is read the control thread calls wait_x (K7: the
// band's compute), and the last hop's pass calls fin on the chunk in shared
// memory (K7: the finalize) after every worker has folded it.  Every thread
// of the CTA calls it (blockDim.x a multiple of 32, more than CONTROL).
template <int VEC, class OpOf, class Fin, class WaitX>
__device__ void ring_run(const Ring& R, unsigned char* smem, size_t smem_bytes, const float* x, float* out,
                         size_t e0, size_t e1, int unit, int max_chunk, OpOf op_of, Fin fin, WaitX wait_x) {
  if (e0 >= e1) return;  // the same on every rank
  const int n = R.n;
  const u64 base = R.epoch * STEP_SPAN;
  const int ch = chunk_floats(e1 - e0, unit, max_chunk);
  const int nch = (int)((e1 - e0 + ch - 1) / ch);
  const int W = (int)((smem_bytes - BAR_BYTES) / (sizeof(float) * ch)) - NSTAGE;  // chunks per window
  u64* full = reinterpret_cast<u64*>(smem);  // [NSTAGE] stage landed (control's arrival + bytes)
  u64* done = full + NSTAGE;                 // [NSTAGE] pass done (one arrival per worker warp)
  u64* xbar = done + NSTAGE;                 // x_r's window landed
  float* stage = reinterpret_cast<float*>(smem + BAR_BYTES);
  float* acc = stage + (size_t)NSTAGE * ch;
  const int nwk = blockDim.x - CONTROL;
  if (threadIdx.x == 0) {
    for (int j = 0; j < NSTAGE; ++j) {
      mbar_init(full + j, 1);
      mbar_init(done + j, nwk / 32);
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // a pass p of a window of K chunks: p < K is chunk p's own pass (hop 0's
  // send, or with n == 1 its finalize); then K + s K + k folds message (s, k)
  auto chunk_of = [&](int p, int K, int& s, int& k) {
    if (p < K) {
      s = -1;
      k = p;
    } else {
      s = (p - K) / K;
      k = (p - K) % K;
    }
  };

  if (threadIdx.x < CONTROL) {
    if (threadIdx.x != 0) return;
    RingClock clk;
    clk.start();
    if (n > 1) {
      st_release(R.right + BAR_LEFT, R.epoch, R.sys);
      st_release(R.left + BAR_RIGHT, R.epoch, R.sys);
    }
    wait_x(clk);
    bool started = n < 2;
    u64 M = 0, seen_ready = 0, seen_credit = 0;  // messages before this window
    long long g0 = 0;                             // passes before this window
    for (int k0 = 0, w = 0; k0 < nch; k0 += W, ++w) {
      const int K = min(W, nch - k0);
      const size_t we0 = e0 + (size_t)k0 * ch, we1 = lesser(e1, we0 + (size_t)K * ch);
      if (w > 0) {
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // out copies left acc
        clk.mark(P_STORE);
      }
      fence_proxy_async();
      mbar_arrive_expect_tx(xbar, (unsigned)((we1 - we0) * sizeof(float)));
      bulk_load(acc, x + we0, (unsigned)((we1 - we0) * sizeof(float)), xbar);
      if (!started) {
        wait_ge<u64>(R.mine + BAR_RIGHT, R.epoch, R, W_BARRIER, -1);
        started = true;
        clk.mark(P_BARRIER);
      }
      const int NP = n * K;
      int iss = 0, sig = 0;
      u64 t_last = now_ns();
      while (sig < NP) {
        bool moved = false;
        int stall = P_FOLD;
        if (iss < NP && iss < sig + NSTAGE) {
          const int j = (int)((g0 + iss) % NSTAGE);
          int s, k;
          chunk_of(iss, K, s, k);
          if (s < 0) {  // x_r's chunk, in the accumulator
            if (mbar_test(xbar, w & 1)) {
              mbar_arrive(full + j);
              ++iss;
              moved = true;
            } else {
              stall = P_LOAD;
            }
          } else {
            const int q = iss - K;
            const u64 need = base + M + q + 1;
            if (seen_ready < need) seen_ready = ld_acquire(R.mine + READY, R.sys);
            bool ok = seen_ready >= need;
            if (!ok) stall = P_READY;
            if (ok && s >= 1 && s + 1 <= n - 2) {  // it forwards into a slot used before
              const u64 needc = base + M + q - K + 1;
              if (seen_credit < needc) seen_credit = ld_acquire(R.mine + CREDIT, R.sys);
              ok = seen_credit >= needc;
              if (!ok) stall = P_CREDIT;
            }
            if (ok) {
              const size_t ce = we0 + (size_t)k * ch;
              const unsigned bytes = (unsigned)(lesser(ch, we1 - ce) * sizeof(float));
              fence_proxy_async();
              mbar_arrive_expect_tx(full + j, bytes);
              bulk_load(stage + (size_t)j * ch, R.slot_mine + (s & 1) * R.P + ce, bytes, full + j);
              ++iss;
              moved = true;
            }
          }
          if (moved) clk.mark(P_ISSUE);
        }
        if (sig < iss) {
          const long long g = g0 + sig;
          if (mbar_test(done + (int)(g % NSTAGE), (unsigned)((g / NSTAGE) & 1))) {
            clk.mark(P_FOLD);
            int s, k;
            chunk_of(sig, K, s, k);
            const bool forwards = n >= 2 && s + 1 <= n - 2;
            const bool last = s < 0 ? n == 1 : s == n - 2;
            if (forwards) {
              // the workers' stores are ordered before this thread by the
              // pass's mbarrier (release by their arrivals, acquire by the
              // test), and the release is cumulative: no fence before it
              st_release(R.right + READY, base + M + sig + 1, R.sys);
              // message (s, k) has left my slot: the left neighbour's (s + 2, k)
              // may land there (a forwarding pass; it is the last wait of it)
              if (s >= 0 && s + 4 <= n) st_release(R.left + CREDIT, base + M + sig - K + 1, R.sys);
            }
            clk.mark(P_SIGNAL);
            if (last) {
              const size_t ce = we0 + (size_t)k * ch;
              bulk_store(out + ce, acc + (size_t)k * ch, (unsigned)(lesser(ch, we1 - ce) * sizeof(float)));
              clk.mark(P_STORE);
            }
            ++sig;
            moved = true;
          }
        }
        if (moved) {
          t_last = now_ns();
        } else {
          clk.mark(stall);
          if (now_ns() - t_last > SPIN_NS)
            fail(R.err, stall == P_CREDIT ? W_CREDIT : W_READY, R.rank, sig, R.sub);
        }
      }
      M += (u64)(n - 1) * K;
      g0 += NP;
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    clk.mark(P_END);
    clk.flush();
    return;
  }

  // workers
  const int wt = threadIdx.x - CONTROL;
  long long g0 = 0;
  for (int k0 = 0, w = 0; k0 < nch; k0 += W, ++w) {
    const int K = min(W, nch - k0);
    const size_t we0 = e0 + (size_t)k0 * ch, we1 = lesser(e1, we0 + (size_t)K * ch);
    mbar_wait(xbar, w & 1);
    const int NP = n * K;
    for (int p = 0; p < NP; ++p) {
      const long long g = g0 + p;
      const int j = (int)(g % NSTAGE);
      mbar_wait(full + j, (unsigned)((g / NSTAGE) & 1));
      int s, k;
      chunk_of(p, K, s, k);
      const size_t ce = we0 + (size_t)k * ch;
      const int nv = (int)(lesser(ch, we1 - ce) / 4);
      float4* a = reinterpret_cast<float4*>(acc + (size_t)k * ch);
      if (s < 0) {
        if (n >= 2) {  // hop 0: send x_r's chunk as message (0, k)
          float4* dst = reinterpret_cast<float4*>(R.slot_right + ce);
          for (int v = wt; v < nv; v += nwk) __stcg(dst + v, a[v]);
        }
      } else {  // fold message (s, k); forward it as (s + 1, k) while hops remain
        const float4* in = reinterpret_cast<const float4*>(stage + (size_t)j * ch);
        float4* dst = s + 1 <= n - 2 ? reinterpret_cast<float4*>(R.slot_right + ((s + 1) & 1) * R.P + ce)
                                     : nullptr;
        for (int v = wt; v < nv; v += nwk) {
          const float4 b = in[v];
          float4 c = a[v];
          fold4<VEC>(c, b, ce + 4 * (size_t)v, op_of);
          a[v] = c;
          if (dst) __stcg(dst + v, b);
        }
      }
      if (s < 0 ? n == 1 : s == n - 2) {  // chunk k is final
        if (Fin::active) {
          workers_sync();
          fin(acc + (size_t)k * ch, ce, 4 * nv, wt, nwk);
        }
        fence_proxy_async();  // the accumulator's writes, before the TMA copy reads them
      }
      __syncwarp();
      if ((threadIdx.x & 31) == 0) mbar_arrive(done + j);
    }
    g0 += NP;
  }
}

}  // namespace hgn_ring

extern "C" {

// Phase probe: with HGN_RING_PHASES, writes the cycles of each phase summed
// over every ring CTA since the last call, then the ring CTAs' count, the
// compute teams' cycles and their work items, into out[0 .. n), clears
// them and returns the number of phases; without it, -1.
int hgn_ring_phases(unsigned long long* out, int n) {
#ifdef HGN_RING_PHASES
  using namespace hgn_ring;
  constexpr int W = RING_NPHASE + 3;
  if (n < W) return -1;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, hgn_ring_phase_cycles, sizeof(unsigned long long) * W);
  const unsigned long long zero[W] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(hgn_ring_phase_cycles, zero, sizeof(zero));
  return err == cudaSuccess ? RING_NPHASE : -(int)err;
#else
  (void)out;
  (void)n;
  return -1;
#endif
}

// The probe's phase names, comma-separated (empty without the probe).
const char* hgn_ring_phase_names() {
#ifdef HGN_RING_PHASES
  return HGN_RING_PHASE_NAMES;
#else
  return "";
#endif
}

}  // extern "C"
