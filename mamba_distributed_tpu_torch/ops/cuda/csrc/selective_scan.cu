// Selective scan (the Mamba-1 SSM recurrence), forward and backward,
// hand-written for Hopper (sm_90a): three kernels, the counterparts of the
// TPU kernels of mamba_distributed_tpu/ops/pallas/scan_kernels.py:
//
//   m1_scan_kernel          replaces _m1_scan_kernel (:64, launched by
//                           _m1_pallas_fwd at :138): the forward,
//                             h_i = h_{i-1} e_i + dt_i u_i B_i,
//                             e_i = exp(A dt_i),  y_i = <C_i, h_i>,
//                           from h0 (or zeros), and the final state hT;
//   m1_entry_states_kernel  replaces _m1_entry_states_kernel (:178,
//                           launched at :324): the same recurrence,
//                           writing the state ENTERING each time tile;
//   m1_bwd_kernel           replaces _m1_bwd_kernel (:201, launched at
//                           :348): per tile, in reverse, the tile's
//                           states and decays are rebuilt from its entry
//                           state into registers, then a reverse sweep with the
//                           state cotangent gh (seeded by the final-state
//                           cotangent, or zeros) gives
//                             gh  += C_i dy_i,
//                             du_i = dt_i <B_i, gh>,
//                             ddt_i = <gh, h_{i-1} A e_i + u_i B_i>,
//                             dB_i = sum_d gh dt_i u_i,  dC_i = sum_d h_i dy_i,
//                             dA  += gh e_i h_{i-1} dt_i,  gh *= e_i,
//                           and gh after step 0 is the initial-state
//                           gradient dh0.
//
// Layouts: u, dt, y, du, ddt, dy (b, t, d); A (d, n); B, C (b, t, n);
// h0, hT, dfinal, dh0 and the per-batch dA partial (b, d, n); entry states
// (b, nt, d, n) with nt = ceil(t / kTB); dB and dC partials (b, nd, t, n),
// one row per CTA of kernel 6 (nd = ceil(d / kBwdChannels)).  All fp32,
// contiguous, as the TPU kernels' state math.  The public (b, d, n) state
// layout is used directly (the TPU kernel transposes to (n, d) for its
// 128-lane vregs), and a ragged t or d is bounds-checked, never padded:
// steps past t load u = dt = dy = 0 and B = C = 0, which leave h, gh and
// dA unchanged (e = 1, no input), and their outputs are not written;
// channels past d hold zeros and write nothing.  The three sums over
// batch or CTA (dA over b, dB and dC over the nd CTAs) run in PyTorch, as
// the JAX package sums its partials in XLA: no atomics, so every result
// is the same run to run.
//
// exp: e = 2^(A (dt log2(e))) by ex2.approx.ftz.f32, one MUFU.EX2
// instruction (2 ulp; results below 2^-126 flush to zero, where the state
// they scale has decayed by 38 orders of magnitude).  Rounding dt log2(e)
// adds a relative error of about |A dt| * 2^-24 to e, under 1e-6 at
// |A dt| <= 16, two orders below the 1e-4 the kernels are held to.
//
// Design.  The time loop runs inside the thread, a tile of steps at a
// time, and B_i, C_i (n floats per step, shared by every channel) are
// staged in shared memory per tile.  Kernel 4: CTAs of kScanThreads = 64
// threads, four a channel (kSQ = 4 states each, the decays evaluated once
// per cell), 16 channels, so the serving chunk (b 1, d 1536) runs 96 CTAs
// and the train layer (b 32) 3,072 of two warps.  Tiles of kScanTB = 16
// steps of (u, dt) pairs, B and C are copied by cp.async into a second
// buffer while the current tile computes (8 KB of shared memory a CTA),
// so neither the loads nor a stage of B and C sit between the tiles'
// arithmetic.  y_i is the quad's sum of the four lanes' partials <C_i,
// h_i> over their states: every four steps a reduce-scatter (an xor-2,
// then an xor-1 shuffle round) leaves each lane y of one of the four
// steps, (p0 + p2) + (p1 + p3) in a fixed order, which it writes.  A is
// scaled by log2(e) once, so a step's exponent is one multiply.  Per
// step a warp issues about 34 instructions (SASS) beside its 4 MUFU.EX2,
// which take 32 cycles of its quadrant's SFU: issue and the SFU are the
// two limits.  Kernel 5: one thread per channel,
// its n = 16 states in registers; CTAs of one warp (32 channels) per
// (channel block, batch row), tiles of kTB steps whose u and dt are
// loaded into registers up front (coalesced along d), B staged between
// two barriers.  Kernel 6: CTAs of 256 threads, four a channel (kSQ = 4
// states each), 64 channels, tiles of kTB = 8 steps.  A thread rebuilds
// its tile's states h_{i-1} and decays e_i = exp(A dt_i) into registers
// (2 x 8 x 4 floats), so each exp is evaluated once and no state passes
// through shared memory; the sums over n (du, ddt) take two quad
// shuffles.  The tile's u, dt, dy rows are staged in shared memory by the
// whole CTA (coalesced along d), and each step's dB_i and dC_i terms go to
// a shared stage [step][state][channel] (rows padded to 68 floats), which
// at the end of the tile 256 threads sum, one (step, state) row each, over
// the CTA's 64 channels in a fixed order: one partial per 64 channels.
// The next tile's rows and entry states are copied by cp.async into a
// second buffer while the current tile computes: the kernel waits on
// latency more than it issues.  About 92 KB of shared memory and at most
// 128 registers a thread (launch bound): two CTAs, 16 warps, an SM.
//
// Bound on the H100.  At one layer of the mamba1-280m train step (b 32,
// t 1024, d 1536, n 16) kernel 4 moves about 0.61 GB (u, dt in, y out;
// 0.18 ms at 3.35 TB/s) and evaluates b t d n = 805 M exponentials (0.19
// ms at the SFU's 16 per SM and clock, 132 SMs, 1.98 GHz); kernel 6's
// own inputs and outputs (u, dt, dy in; du, ddt out; B, C, dB, dC; the
// entry states at the TPU kernel's 128-step tile) are about 1.04 GB (0.31
// ms), beside the same 805 M exponentials.  Both sit near the balance of
// bytes and exps, so neither tensor cores nor fusion beyond this move the
// bound; kernel 5 recomputes the exps of the forward.  This layout moves
// more than the bound counts: the entry states at kTB-step tiles add 0.38
// GB (written by 5, read by 6) and the per-CTA dB/dC partials 0.1 GB.  At
// the serving chunk (b 1, t 256) kernel 4 moves 3.1 MB (under a
// microsecond) and runs 96 CTAs on 132 SMs: latency-bound by the 256
// sequential steps, not by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 16;                       // states per channel (Mamba-1 d_state)
constexpr int kScanTB = 16;                  // time steps per tile, kernel 4
constexpr int kTB = 8;                       // time steps per tile, kernels 5 and 6
constexpr int kEntryChannels = 32;           // channels per CTA (one thread each), kernel 5
constexpr int kScanChannels = 16;            // channels per CTA, kernel 4
constexpr int kBwdChannels = 64;             // channels per CTA, kernel 6
constexpr int kQ = 4;                        // threads per channel, kernels 4 and 6
constexpr int kSQ = kN / kQ;                 // states per thread, kernels 4 and 6
constexpr int kScanThreads = kQ * kScanChannels;
constexpr int kScanRowFloats = kScanTB * kScanChannels;  // a tile's (u, dt) pairs
constexpr int kScanTileFloats = 2 * kScanRowFloats + 2 * kScanTB * kN;  // (u, dt), B, C
constexpr int kBwdThreads = kQ * kBwdChannels;
constexpr int kRowPad = kBwdChannels + 4;    // a dB/dC row of kernel 6's stage, padded
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU: one MUFU.EX2, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load_state(const float* __restrict__ src, bool live,
                                           float (&h)[kN]) {
#pragma unroll
  for (int q = 0; q < kN / 4; ++q) {
    const float4 v = live && src ? reinterpret_cast<const float4*>(src)[q]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    h[4 * q] = v.x; h[4 * q + 1] = v.y; h[4 * q + 2] = v.z; h[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void store_state(float* __restrict__ dst, const float (&h)[kN]) {
#pragma unroll
  for (int q = 0; q < kN / 4; ++q)
    reinterpret_cast<float4*>(dst)[q] =
        make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
}

// B_i (and C_i) of the TB steps from t0 into shared memory [step][state];
// zeros past t.
template <int TB>
__device__ __forceinline__ void stage_rows(const float* __restrict__ src, float* __restrict__ dst,
                                           int t0, int t, int tid, int nthr) {
  for (int k = tid; k < TB * kN; k += nthr) {
    const int s = t0 + k / kN;
    dst[k] = s < t ? src[size_t(s) * kN + k % kN] : 0.f;
  }
}

// The value of one channel at step s of a (t, d) slab; zero past t or for
// a dead channel.
__device__ __forceinline__ float load_at(const float* __restrict__ src, int s, int t, int d,
                                         int ch, bool live) {
  return live && s < t ? src[size_t(s) * d + ch] : 0.f;
}

struct ScanParams {
  const float *u, *dt, *A, *B, *C, *h0;
  float *y, *hT, *states;  // y/hT: kernel 4; states: kernel 5
  int t, d;
};

// Kernel 5: grid (ceil(d / 32), b), one thread a channel with its n
// states in registers, tiles of kTB steps (the entry states' tile).
__global__ void __launch_bounds__(kEntryChannels) m1_entry_states_kernel(ScanParams p) {
  __shared__ __align__(16) float Bs[kTB * kN];
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int ch = blockIdx.x * kEntryChannels + tid;
  const bool live = ch < p.d;
  const int t = p.t, d = p.d, nt = (t + kTB - 1) / kTB;
  float a[kN], h[kN];
  load_state(p.A + size_t(ch) * kN, live, a);
  load_state(p.h0 ? p.h0 + (size_t(bi) * d + ch) * kN : nullptr, live, h);
  const float* u = p.u + size_t(bi) * t * d;
  const float* dt = p.dt + size_t(bi) * t * d;
  for (int k = 0; k < nt; ++k) {
    const int t0 = k * kTB;
    if (live) store_state(p.states + ((size_t(bi) * nt + k) * d + ch) * kN, h);
    float ur[kTB], dr[kTB];
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      ur[i] = load_at(u, t0 + i, t, d, ch, live);
      dr[i] = load_at(dt, t0 + i, t, d, ch, live);
    }
    __syncthreads();  // the previous tile's reads of Bs are done
    stage_rows<kTB>(p.B + size_t(bi) * t * kN, Bs, t0, t, tid, kEntryChannels);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      const float dtl = dr[i] * kLog2e, dtu = dr[i] * ur[i];
#pragma unroll
      for (int n = 0; n < kN; ++n) h[n] = fmaf(h[n], ex2(a[n] * dtl), dtu * Bs[i * kN + n]);
    }
  }
}

struct BwdParams {
  const float *u, *dt, *A, *B, *C, *states, *dy, *dfinal;
  float *du, *ddt, *dA_part, *dB_part, *dC_part, *dh0;
  int t, d, nd;
};

// one tile's inputs in kernel 6's shared memory: its u, dt, dy rows
// [step][channel], its B, C rows [step][state], and the CTA's entry states
// [channel][state]
constexpr int kRowFloats = kTB * kBwdChannels;
constexpr int kTileFloats = 3 * kRowFloats + 2 * kTB * kN + kBwdChannels * kN;

constexpr int bwd_smem_floats() {
  return 2 * kTileFloats               // two tiles: the one in use, the next in flight
         + kTB * 2 * kN * kRowPad;     // the stage: [step][dB n, dC n][channel]
}

// kSQ consecutive floats of a per-channel state row; zeros for a dead
// channel or a null source
__device__ __forceinline__ void load_part(const float* __restrict__ src, bool live,
                                          float (&h)[kSQ]) {
  static_assert(kSQ == 4, "one float4 a thread");
  const float4 v = live && src ? *reinterpret_cast<const float4*>(src)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
  h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
}

__device__ __forceinline__ void store_part(float* __restrict__ dst, const float (&h)[kSQ]) {
  *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
}

// an asynchronous copy of `bytes` (4 or 16) from src to shared dst, or
// zeros when !live (src is then not read)
template <int bytes>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 16u : 0u) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(live ? 4u : 0u) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// start the copies of kernel 4's tile k into `buf`: (u, dt) pairs
// [step][channel][2] (zeros past t, past d), then B and C rows
// [step][state] (zeros past t), 16 bytes a copy
__device__ __forceinline__ void fetch_scan_tile(const ScanParams& p, float* buf, int k, int cb,
                                                int bi, int tid) {
  const int t = p.t, d = p.d, t0 = k * kScanTB;
  const size_t slab = size_t(bi) * t * d;
  for (int e = tid; e < kScanRowFloats; e += kScanThreads) {
    const int s = t0 + e / kScanChannels, c = cb * kScanChannels + e % kScanChannels;
    const bool ok = s < t && c < d;
    const size_t o = ok ? slab + size_t(s) * d + c : 0;
    cp_async<4>(buf + 2 * e, p.u + o, ok);
    cp_async<4>(buf + 2 * e + 1, p.dt + o, ok);
  }
  constexpr int kVecs = kScanTB * kN / 4;  // float4s of a tile's B (or C) rows
  for (int e = tid; e < 2 * kVecs; e += kScanThreads) {  // B rows, then C rows
    const int r = e % kVecs, s = t0 + r / (kN / 4);
    const bool ok = s < t;
    const float* src =
        (e < kVecs ? p.B : p.C) + (ok ? (size_t(bi) * t + s) * kN + 4 * (r % (kN / 4)) : 0);
    cp_async<16>(buf + 2 * kScanRowFloats + 4 * e, src, ok);
  }
  cp_async_commit();
}

// Kernel 4: grid (scan_ctas(d), b), kScanThreads threads, kQ a channel
// with kSQ states each (its states, and A pre-scaled by log2(e), in
// registers).  Tile k + 1 is copied by cp.async into the other buffer
// while tile k computes.  Every kQ = 4 steps the quad turns its lanes'
// partials <C_i, h_i> of the four steps into the four y_i by a
// reduce-scatter, an xor-2 then an xor-1 shuffle round: lane q ends with
// y of step q, (p0 + p2) + (p1 + p3) in every lane's order, and writes it.
__global__ void __launch_bounds__(kScanThreads) m1_scan_kernel(ScanParams p) {
  static_assert(kQ == 4 && kScanTB % kQ == 0, "a reduce-scatter of 4 steps over 4 lanes");
  __shared__ __align__(16) float tiles[2][kScanTileFloats];
  const int tid = threadIdx.x, q = tid % kQ, cl = tid / kQ;
  const int bi = blockIdx.y, cb = blockIdx.x;
  const int ch = cb * kScanChannels + cl;
  const bool live = ch < p.d;
  const int t = p.t, d = p.d, nt = (t + kScanTB - 1) / kScanTB;
  const int row = ch * kN + q * kSQ;  // this thread's states in a (d, n) row
  float a[kSQ], h[kSQ];
  load_part(p.A + row, live, a);
  load_part(p.h0 ? p.h0 + size_t(bi) * d * kN + row : nullptr, live, h);
#pragma unroll
  for (int s = 0; s < kSQ; ++s) a[s] *= kLog2e;  // e = 2^(a dt)
  float* y = p.y + size_t(bi) * t * d + ch;
  const bool hi = q >> 1, lo = q & 1;
  fetch_scan_tile(p, tiles[0], 0, cb, bi, tid);
  for (int k = 0, cur = 0; k < nt; ++k, cur ^= 1) {
    const int t0 = k * kScanTB;
    cp_async_wait_all();
    __syncthreads();  // tile k has landed; every read of the other buffer is done
    if (k + 1 < nt) fetch_scan_tile(p, tiles[cur ^ 1], k + 1, cb, bi, tid);
    const float* ud = tiles[cur];                       // [kScanTB][kScanChannels][2]
    const float* Bs = ud + 2 * kScanRowFloats;          // [kScanTB][kN]
    const float* Cs = Bs + kScanTB * kN;
#pragma unroll
    for (int i0 = 0; i0 < kScanTB; i0 += kQ) {
      float part[kQ];  // this lane's <C_i, h_i> over its states, steps i0 .. i0 + 3
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        const int i = i0 + j;
        const float2 uv = *reinterpret_cast<const float2*>(ud + 2 * (i * kScanChannels + cl));
        const float dtu = uv.y * uv.x;
        const float4 bv = *reinterpret_cast<const float4*>(Bs + i * kN + q * kSQ);
        const float4 cv = *reinterpret_cast<const float4*>(Cs + i * kN + q * kSQ);
        const float b4[kSQ] = {bv.x, bv.y, bv.z, bv.w}, c4[kSQ] = {cv.x, cv.y, cv.z, cv.w};
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < kSQ; ++s) {
          h[s] = fmaf(h[s], ex2(a[s] * uv.y), dtu * b4[s]);
          acc = fmaf(h[s], c4[s], acc);
        }
        part[j] = acc;
      }
      // lanes q and q ^ 2 sum steps 2 hi and 2 hi + 1; then lanes q and q ^ 1 step q
      const float s0 = (hi ? part[2] : part[0]) +
                       __shfl_xor_sync(0xffffffffu, hi ? part[0] : part[2], 2);
      const float s1 = (hi ? part[3] : part[1]) +
                       __shfl_xor_sync(0xffffffffu, hi ? part[1] : part[3], 2);
      const float yv = (lo ? s1 : s0) + __shfl_xor_sync(0xffffffffu, lo ? s0 : s1, 1);
      const int s = t0 + i0 + q;
      if (live && s < t) y[size_t(s) * d] = yv;
    }
  }
  if (live) store_part(p.hT + size_t(bi) * d * kN + row, h);
}

// start the copies of tile k's inputs into `buf` (zeros past t, past d)
__device__ __forceinline__ void fetch_tile(const BwdParams& p, float* buf, int k, int cb, int bi,
                                           int tid) {
  const int t = p.t, d = p.d, t0 = k * kTB, nt = (t + kTB - 1) / kTB;
  const size_t slab = size_t(bi) * t * d;
  for (int e = tid; e < kRowFloats; e += kBwdThreads) {
    const int s = t0 + e / kBwdChannels, c = cb * kBwdChannels + e % kBwdChannels;
    const bool ok = s < t && c < d;
    const size_t o = ok ? slab + size_t(s) * d + c : 0;
    cp_async<4>(buf + e, p.u + o, ok);
    cp_async<4>(buf + kRowFloats + e, p.dt + o, ok);
    cp_async<4>(buf + 2 * kRowFloats + e, p.dy + o, ok);
  }
  for (int e = tid; e < 2 * kTB * kN; e += kBwdThreads) {  // B rows, then C rows
    const int r = e % (kTB * kN), s = t0 + r / kN;
    const float* src = e < kTB * kN ? p.B : p.C;
    const bool ok = s < t;
    cp_async<4>(buf + 3 * kRowFloats + e, src + (ok ? size_t(bi) * t * kN + size_t(s) * kN + r % kN : 0),
                ok);
  }
  // the entry states, one float4 a thread: [channel][state]
  const int cl = tid / kQ, q = tid % kQ, c = cb * kBwdChannels + cl;
  const bool ok = c < d;
  cp_async<16>(buf + 3 * kRowFloats + 2 * kTB * kN + cl * kN + q * kSQ,
               p.states + (ok ? ((size_t(bi) * nt + k) * d + c) * kN + q * kSQ : 0), ok);
  cp_async_commit();
}

// Kernel 6: grid (ceil(d / 64), b), 256 threads (4 a channel, kSQ states
// each), bwd_smem_floats() of dynamic shared memory.
__global__ void __launch_bounds__(kBwdThreads, 2) m1_bwd_kernel(BwdParams p) {
  static_assert(kBwdThreads == kTB * 2 * kN, "one (step, dB/dC state) row a thread");
  static_assert(kBwdThreads == kBwdChannels * kQ, "one float4 of entry state a thread");
  extern __shared__ __align__(16) float smem[];
  float* stage = smem + 2 * kTileFloats;       // [kTB][2 kN][kRowPad]
  const int tid = threadIdx.x, q = tid % kQ, cl = tid / kQ;
  const int bi = blockIdx.y, cb = blockIdx.x;
  const int ch = cb * kBwdChannels + cl;
  const bool live = ch < p.d;
  const int t = p.t, d = p.d, nt = (t + kTB - 1) / kTB;
  const int row = ch * kN + q * kSQ;  // this thread's states in a (d, n) row
  float a[kSQ], gh[kSQ], dA[kSQ];
  load_part(p.A + row, live, a);
  load_part(p.dfinal ? p.dfinal + size_t(bi) * d * kN + row : nullptr, live, gh);
#pragma unroll
  for (int s = 0; s < kSQ; ++s) dA[s] = 0.f;
  fetch_tile(p, smem, nt - 1, cb, bi, tid);
  for (int k = nt - 1, cur = 0; k >= 0; --k, cur ^= 1) {
    const int t0 = k * kTB;
    const float* buf = smem + cur * kTileFloats;
    const float* us = buf;                                  // [kTB][kBwdChannels]
    const float* dts = us + kRowFloats;
    const float* dys = dts + kRowFloats;
    const float* Bs = dys + kRowFloats;                     // [kTB][kN]
    const float* Cs = Bs + kTB * kN;
    const float* hs = Cs + kTB * kN;                        // [kBwdChannels][kN]
    cp_async_wait_all();
    __syncthreads();  // tile k has landed; every read of the other buffer and the stage is done
    if (k > 0) fetch_tile(p, smem + (cur ^ 1) * kTileFloats, k - 1, cb, bi, tid);
    // rebuild the tile: the state entering each step and its decay, kept
    // in registers (one exp per cell)
    float h[kSQ], hp[kTB][kSQ], ev[kTB][kSQ];
    {
      const float4 hv = *reinterpret_cast<const float4*>(hs + cl * kN + q * kSQ);
      h[0] = hv.x; h[1] = hv.y; h[2] = hv.z; h[3] = hv.w;
    }
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      const float dtv = dts[i * kBwdChannels + cl];
      const float dtl = dtv * kLog2e, dtu = dtv * us[i * kBwdChannels + cl];
      const float4 bv = *reinterpret_cast<const float4*>(Bs + i * kN + q * kSQ);
      const float b4[kSQ] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int s = 0; s < kSQ; ++s) {
        hp[i][s] = h[s];
        ev[i][s] = ex2(a[s] * dtl);
        h[s] = fmaf(h[s], ev[i][s], dtu * b4[s]);
      }
    }
    // reverse sweep
#pragma unroll
    for (int i = kTB - 1; i >= 0; --i) {
      const float dtv = dts[i * kBwdChannels + cl], uv = us[i * kBwdChannels + cl];
      const float dyv = dys[i * kBwdChannels + cl];
      const float dtu = dtv * uv;
      const float4 bv = *reinterpret_cast<const float4*>(Bs + i * kN + q * kSQ);
      const float4 cv = *reinterpret_cast<const float4*>(Cs + i * kN + q * kSQ);
      const float b4[kSQ] = {bv.x, bv.y, bv.z, bv.w}, c4[kSQ] = {cv.x, cv.y, cv.z, cv.w};
      float* st = stage + (i * 2 * kN + q * kSQ) * kRowPad + cl;
      float sdu = 0.f, sddt = 0.f;
#pragma unroll
      for (int s = 0; s < kSQ; ++s) {
        const float hps = hp[i][s], e = ev[i][s], bn = b4[s];
        gh[s] = fmaf(c4[s], dyv, gh[s]);
        st[s * kRowPad] = gh[s] * dtu;                                // dB_i term
        st[(kN + s) * kRowPad] = fmaf(hps, e, dtu * bn) * dyv;        // dC_i term
        sddt = fmaf(gh[s], fmaf(hps * a[s], e, uv * bn), sddt);
        sdu = fmaf(gh[s], bn, sdu);
        const float ghe = gh[s] * e;
        dA[s] = fmaf(ghe * hps, dtv, dA[s]);
        gh[s] = ghe;
      }
      // the channel's sums over its 4 threads' states (the 4 lanes of a quad)
      sdu += __shfl_xor_sync(0xffffffffu, sdu, 1);
      sdu += __shfl_xor_sync(0xffffffffu, sdu, 2);
      sddt += __shfl_xor_sync(0xffffffffu, sddt, 1);
      sddt += __shfl_xor_sync(0xffffffffu, sddt, 2);
      if (q == 0 && live && t0 + i < t) {
        const size_t o = (size_t(bi) * t + t0 + i) * d + ch;
        p.du[o] = dtv * sdu;
        p.ddt[o] = sddt;
      }
    }
    __syncthreads();
    // the CTA's dB/dC rows of the tile: thread (step i, value v) sums the
    // stage row over the 64 channels in a fixed order
    const int i = tid / (2 * kN), v = tid % (2 * kN);
    if (t0 + i < t) {
      const float4* r = reinterpret_cast<const float4*>(stage + (i * 2 * kN + v) * kRowPad);
      float4 acc = r[0];
#pragma unroll
      for (int c = 1; c < kBwdChannels / 4; ++c) {
        const float4 x = r[c];
        acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
      }
      float* dst = v < kN ? p.dB_part : p.dC_part;
      dst[((size_t(bi) * p.nd + cb) * t + t0 + i) * kN + v % kN] = (acc.x + acc.y) + (acc.z + acc.w);
    }
  }
  if (live) {
    store_part(p.dh0 + size_t(bi) * d * kN + row, gh);
    store_part(p.dA_part + size_t(bi) * d * kN + row, dA);
  }
}

bool bad_dims(int b, int t, int d, int n) {
  return b < 1 || b > 65535 || t < 1 || d < 1 || n != kN;
}

// kernel 4's CTAs along d (its grid is (scan_ctas(d), b))
int scan_ctas(int d) { return (d + kScanChannels - 1) / kScanChannels; }

}  // namespace

// The layout constants the wrapper needs: states per channel, time steps
// per tile (the entry states' tile axis), channels per kernel-6 CTA (the
// dB/dC partials' block axis); and kernel 4's geometry: channels per CTA,
// threads per channel, and its CTAs at (b, d).
extern "C" int mdt_m1_state_size() { return kN; }
extern "C" int mdt_m1_tile() { return kTB; }
extern "C" int mdt_m1_bwd_channels() { return kBwdChannels; }
extern "C" int mdt_m1_scan_channels() { return kScanChannels; }
extern "C" int mdt_m1_scan_lanes() { return kQ; }
extern "C" int mdt_m1_scan_ctas(int b, int d) { return b * scan_ctas(d); }

// Each returns a cudaError_t (0 on success).  h0 and dfinal may be null
// (zeros).
extern "C" int mdt_m1_scan(const float* u, const float* dt, const float* A, const float* B,
                           const float* C, const float* h0, float* y, float* hT, int b, int t,
                           int d, int n, void* stream) {
  if (bad_dims(b, t, d, n)) return (int)cudaErrorInvalidValue;
  ScanParams p{u, dt, A, B, C, h0, y, hT, nullptr, t, d};
  m1_scan_kernel<<<dim3(scan_ctas(d), b), kScanThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mdt_m1_entry_states(const float* u, const float* dt, const float* A,
                                   const float* B, const float* h0, float* states, int b,
                                   int t, int d, int n, void* stream) {
  if (bad_dims(b, t, d, n)) return (int)cudaErrorInvalidValue;
  ScanParams p{u, dt, A, B, nullptr, h0, nullptr, nullptr, states, t, d};
  const dim3 grid((d + kEntryChannels - 1) / kEntryChannels, b);
  m1_entry_states_kernel<<<grid, kEntryChannels, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mdt_m1_bwd(const float* u, const float* dt, const float* A, const float* B,
                          const float* C, const float* states, const float* dy,
                          const float* dfinal, float* du, float* ddt, float* dA_part,
                          float* dB_part, float* dC_part, float* dh0, int b, int t, int d, int n,
                          void* stream) {
  if (bad_dims(b, t, d, n)) return (int)cudaErrorInvalidValue;
  const int nd = (d + kBwdChannels - 1) / kBwdChannels;
  BwdParams p{u, dt, A, B, C, states, dy, dfinal, du, ddt, dA_part, dB_part, dC_part, dh0,
              t, d, nd};
  const int smem = bwd_smem_floats() * int(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(m1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  m1_bwd_kernel<<<dim3(nd, b), kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
