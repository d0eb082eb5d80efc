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
//                           states are rebuilt from its entry state into
//                           shared memory, then a reverse sweep with the
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
// one row per CTA of kernel 6 (nd = ceil(d / kBwdThreads)).  All fp32,
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
// Design.  One thread per channel, its n = 16 states in registers, so
// the sums over n (y, du, ddt) need no communication.  The time loop runs
// inside the thread, a tile of steps at a time, and B_i, C_i (n floats
// per step, shared by every channel) are staged in shared memory per
// tile.  Kernels 4 and 5: CTAs of one warp (32 channels) per (channel
// block, batch row); kernel 4 loads a tile of kFwdTB = 16 steps of u and
// dt into registers up front (coalesced along d), so the tile's loads are
// in flight together.  Kernel 6: CTAs of two warps (64 channels), tiles of
// kTB = 8 steps; the states h_{i-1} of the tile (kTB x 16 per channel, too
// many for registers) and the tile's u, dt and dy live in shared memory
// ([step][state][channel], so a warp's accesses fall in 32 banks), 41 KB
// a CTA, five CTAs per SM.  Keeping them out of registers keeps the
// thread under 255 registers with no spills: 16-step tiles of u, dt and
// dy held in registers spill 1.5 KB a thread and run 4.4x slower.  dB_i
// and dC_i (32 sums over channels per step) reduce within a warp by a
// reduce-scatter of 31 shuffles (after it lane j holds the warp's sum of
// value j), then over the two warps through shared memory at the end of
// the tile.
//
// Bound on the H100.  At one layer of the mamba1-280m train step (b 32,
// t 1024, d 1536, n 16) kernel 4 moves about 0.61 GB (u, dt in, y out;
// 0.18 ms at 3.35 TB/s) and evaluates b t d n = 805 M exponentials (0.19
// ms at the SFU's 16 per SM and clock, 132 SMs, 1.98 GHz); kernel 6's
// own inputs and outputs (u, dt, dy in; du, ddt out; B, C, dB, dC; the
// entry states at the TPU kernel's 128-step tile) are about 1.04 GB (0.31
// ms), beside the same 805 M exponentials.  Both sit near the balance of
// bytes and exps, so neither tensor cores nor fusion beyond this move the
// bound; the kernels recompute e in kernels 5 and 6 (twice in 6), which
// costs SFU time above the bound.  This layout moves more than the bound
// counts: the entry states at kTB-step tiles add 0.38 GB (written by 5,
// read by 6) and the per-CTA dB/dC partials 0.1 GB.  At the serving
// chunk (b 1, t 256) kernel 4 runs d / 32 = 48 one-warp CTAs on 132 SMs:
// latency-bound by the 256 sequential steps, not by bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kN = 16;                       // states per channel (Mamba-1 d_state)
constexpr int kFwdTB = 16;                   // time steps per tile, kernel 4
constexpr int kTB = 8;                       // time steps per tile, kernels 5 and 6
constexpr int kFwdThreads = 32;              // channels per CTA, kernels 4 and 5
constexpr int kBwdWarps = 2;
constexpr int kBwdThreads = 32 * kBwdWarps;  // channels per CTA, kernel 6
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

// One halving step of a warp reduce-scatter: lanes with bit W set keep the
// upper W of the 2W live values, the others the lower W, and add the
// partner lane's (lane ^ W) copy of the kept half.
template <int W>
__device__ __forceinline__ void halve(float (&v)[2 * kN], int lane) {
  const bool hi = lane & W;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = hi ? v[j] : v[j + W];
    const float keep = hi ? v[j + W] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Warp reduce-scatter of 32 values: afterwards lane j holds the sum over
// the warp's 32 lanes of v[j] (31 shuffles where 32 all-reduces take 160).
__device__ __forceinline__ float reduce_scatter32(float (&v)[2 * kN], int lane) {
  static_assert(2 * kN == 32, "one value per lane");
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

struct ScanParams {
  const float *u, *dt, *A, *B, *C, *h0;
  float *y, *hT, *states;  // y/hT: kernel 4; states: kernel 5
  int t, d;
};

// Kernels 4 (kStates false, tiles of kFwdTB) and 5 (kStates true, tiles
// of kTB, the entry states' tile): grid (ceil(d / 32), b).
template <bool kStates>
__global__ void __launch_bounds__(kFwdThreads) m1_fwd_kernel(ScanParams p) {
  constexpr int TB = kStates ? kTB : kFwdTB;
  __shared__ __align__(16) float Bs[TB * kN], Cs[TB * kN];
  const int tid = threadIdx.x, bi = blockIdx.y;
  const int ch = blockIdx.x * kFwdThreads + tid;
  const bool live = ch < p.d;
  const int t = p.t, d = p.d, nt = (t + TB - 1) / TB;
  float a[kN], h[kN];
  load_state(p.A + size_t(ch) * kN, live, a);
  load_state(p.h0 ? p.h0 + (size_t(bi) * d + ch) * kN : nullptr, live, h);
  const float* u = p.u + size_t(bi) * t * d;
  const float* dt = p.dt + size_t(bi) * t * d;
  for (int k = 0; k < nt; ++k) {
    const int t0 = k * TB;
    if (kStates && live) store_state(p.states + ((size_t(bi) * nt + k) * d + ch) * kN, h);
    float ur[TB], dr[TB];
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      ur[i] = load_at(u, t0 + i, t, d, ch, live);
      dr[i] = load_at(dt, t0 + i, t, d, ch, live);
    }
    __syncthreads();  // the previous tile's reads of Bs, Cs are done
    stage_rows<TB>(p.B + size_t(bi) * t * kN, Bs, t0, t, tid, kFwdThreads);
    if (!kStates) stage_rows<TB>(p.C + size_t(bi) * t * kN, Cs, t0, t, tid, kFwdThreads);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TB; ++i) {
      const float dtl = dr[i] * kLog2e, dtu = dr[i] * ur[i];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = fmaf(h[n], ex2(a[n] * dtl), dtu * Bs[i * kN + n]);
        if (!kStates) acc = fmaf(h[n], Cs[i * kN + n], acc);
      }
      if (!kStates && live && t0 + i < t) p.y[(size_t(bi) * t + t0 + i) * d + ch] = acc;
    }
  }
  if (!kStates && live) store_state(p.hT + (size_t(bi) * d + ch) * kN, h);
}

struct BwdParams {
  const float *u, *dt, *A, *B, *C, *states, *dy, *dfinal;
  float *du, *ddt, *dA_part, *dB_part, *dC_part, *dh0;
  int t, d, nd;
};

constexpr int bwd_smem_floats() {
  return kTB * kN * kBwdThreads          // hbuf: h_{i-1} of the tile
         + 3 * kTB * kBwdThreads         // u, dt, dy of the tile
         + 2 * kTB * kN                  // B, C rows of the tile
         + kTB * kBwdWarps * 2 * kN;     // per-warp dB/dC sums of the tile
}

// Kernel 6: grid (ceil(d / 64), b), 64 threads, bwd_smem_floats() of
// dynamic shared memory.
__global__ void __launch_bounds__(kBwdThreads) m1_bwd_kernel(BwdParams p) {
  extern __shared__ float smem[];
  float* hbuf = smem;                          // [kTB][kN][kBwdThreads]
  float* us = hbuf + kTB * kN * kBwdThreads;   // [kTB][kBwdThreads]
  float* dts = us + kTB * kBwdThreads;         // [kTB][kBwdThreads]
  float* dys = dts + kTB * kBwdThreads;        // [kTB][kBwdThreads]
  float* Bs = dys + kTB * kBwdThreads;         // [kTB][kN]
  float* Cs = Bs + kTB * kN;                   // [kTB][kN]
  float* red = Cs + kTB * kN;                  // [kTB][kBwdWarps][2 kN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.y, cb = blockIdx.x;
  const int ch = cb * kBwdThreads + tid;
  const bool live = ch < p.d;
  const int t = p.t, d = p.d, nt = (t + kTB - 1) / kTB;
  float a[kN], gh[kN], dA[kN];
  load_state(p.A + size_t(ch) * kN, live, a);
#pragma unroll
  for (int n = 0; n < kN; ++n) dA[n] = 0.f;
  load_state(p.dfinal ? p.dfinal + (size_t(bi) * d + ch) * kN : nullptr, live, gh);
  const size_t slab = size_t(bi) * t * d;
  for (int k = nt - 1; k >= 0; --k) {
    const int t0 = k * kTB;
    __syncthreads();  // the previous tile's reads of Bs, Cs, red are done
#pragma unroll
    for (int i = 0; i < kTB; ++i) {
      us[i * kBwdThreads + tid] = load_at(p.u + slab, t0 + i, t, d, ch, live);
      dts[i * kBwdThreads + tid] = load_at(p.dt + slab, t0 + i, t, d, ch, live);
      dys[i * kBwdThreads + tid] = load_at(p.dy + slab, t0 + i, t, d, ch, live);
    }
    stage_rows<kTB>(p.B + size_t(bi) * t * kN, Bs, t0, t, tid, kBwdThreads);
    stage_rows<kTB>(p.C + size_t(bi) * t * kN, Cs, t0, t, tid, kBwdThreads);
    float h[kN];
    load_state(p.states + ((size_t(bi) * nt + k) * d + ch) * kN, live, h);
    __syncthreads();
    // forward recompute: hbuf[i] = the state entering step i
#pragma unroll 1
    for (int i = 0; i < kTB; ++i) {
      const float dtv = dts[i * kBwdThreads + tid];
      const float dtl = dtv * kLog2e, dtu = dtv * us[i * kBwdThreads + tid];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        hbuf[(i * kN + n) * kBwdThreads + tid] = h[n];
        h[n] = fmaf(h[n], ex2(a[n] * dtl), dtu * Bs[i * kN + n]);
      }
    }
    // reverse sweep
#pragma unroll 1
    for (int i = kTB - 1; i >= 0; --i) {
      const float dtv = dts[i * kBwdThreads + tid], uv = us[i * kBwdThreads + tid];
      const float dyv = dys[i * kBwdThreads + tid];
      const float dtl = dtv * kLog2e, dtu = dtv * uv;
      float v[2 * kN];  // v[n]: this channel's dB_i[n] term, v[kN + n]: its dC_i[n] term
      float sdu = 0.f, sddt = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float hp = hbuf[(i * kN + n) * kBwdThreads + tid];
        const float bn = Bs[i * kN + n];
        const float e = ex2(a[n] * dtl);
        gh[n] = fmaf(Cs[i * kN + n], dyv, gh[n]);
        v[kN + n] = fmaf(hp, e, dtu * bn) * dyv;
        v[n] = gh[n] * dtu;
        sddt = fmaf(gh[n], fmaf(hp * a[n], e, uv * bn), sddt);
        sdu = fmaf(gh[n], bn, sdu);
        const float ghe = gh[n] * e;
        dA[n] = fmaf(ghe * hp, dtv, dA[n]);
        gh[n] = ghe;
      }
      if (live && t0 + i < t) {
        const size_t o = slab + size_t(t0 + i) * d + ch;
        p.du[o] = dtv * sdu;
        p.ddt[o] = sddt;
      }
      red[(i * kBwdWarps + warp) * 2 * kN + lane] = reduce_scatter32(v, lane);
    }
    __syncthreads();
    // the CTA's dB/dC rows of the tile: sum the warps' rows
    for (int q = tid; q < kTB * 2 * kN; q += kBwdThreads) {
      const int i = q / (2 * kN), j = q % (2 * kN);
      if (t0 + i >= t) continue;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) s += red[(i * kBwdWarps + w) * 2 * kN + j];
      float* dst = j < kN ? p.dB_part : p.dC_part;
      dst[((size_t(bi) * p.nd + cb) * t + t0 + i) * kN + j % kN] = s;
    }
  }
  if (live) {
    store_state(p.dh0 + (size_t(bi) * d + ch) * kN, gh);
    store_state(p.dA_part + (size_t(bi) * d + ch) * kN, dA);
  }
}

bool bad_dims(int b, int t, int d, int n) {
  return b < 1 || b > 65535 || t < 1 || d < 1 || n != kN;
}

}  // namespace

// The layout constants the wrapper needs: states per channel, time steps
// per tile (the entry states' tile axis), channels per kernel-6 CTA (the
// dB/dC partials' block axis).
extern "C" int mdt_m1_state_size() { return kN; }
extern "C" int mdt_m1_tile() { return kTB; }
extern "C" int mdt_m1_bwd_channels() { return kBwdThreads; }

// Each returns a cudaError_t (0 on success).  h0 and dfinal may be null
// (zeros).
extern "C" int mdt_m1_scan(const float* u, const float* dt, const float* A, const float* B,
                           const float* C, const float* h0, float* y, float* hT, int b, int t,
                           int d, int n, void* stream) {
  if (bad_dims(b, t, d, n)) return (int)cudaErrorInvalidValue;
  ScanParams p{u, dt, A, B, C, h0, y, hT, nullptr, t, d};
  const dim3 grid((d + kFwdThreads - 1) / kFwdThreads, b);
  m1_fwd_kernel<false><<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mdt_m1_entry_states(const float* u, const float* dt, const float* A,
                                   const float* B, const float* h0, float* states, int b,
                                   int t, int d, int n, void* stream) {
  if (bad_dims(b, t, d, n)) return (int)cudaErrorInvalidValue;
  ScanParams p{u, dt, A, B, nullptr, h0, nullptr, nullptr, states, t, d};
  const dim3 grid((d + kFwdThreads - 1) / kFwdThreads, b);
  m1_fwd_kernel<true><<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int mdt_m1_bwd(const float* u, const float* dt, const float* A, const float* B,
                          const float* C, const float* states, const float* dy,
                          const float* dfinal, float* du, float* ddt, float* dA_part,
                          float* dB_part, float* dC_part, float* dh0, int b, int t, int d, int n,
                          void* stream) {
  if (bad_dims(b, t, d, n)) return (int)cudaErrorInvalidValue;
  const int nd = (d + kBwdThreads - 1) / kBwdThreads;
  BwdParams p{u, dt, A, B, C, states, dy, dfinal, du, ddt, dA_part, dB_part, dC_part, dh0,
              t, d, nd};
  const int smem = bwd_smem_floats() * int(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(m1_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  m1_bwd_kernel<<<dim3(nd, b), kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
