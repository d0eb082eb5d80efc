// SSD (Mamba-2 chunked scan) backward, hand-written for Hopper (sm_90a).
//
// The counterparts of the two TPU kernels of the SSD backward in
// mamba_distributed_tpu/ops/pallas/ssd_kernels.py:
//
//   chunk states       replaces _chunk_states_kernel (:61, launched at
//                      :456): per (batch, chunk, head) the state summary
//                      S[p, n] = sum_j round(x_j)[p] round(B_j w_j)[n],
//                      w_j = dt_j e^(a_L - a_j).  The backward recomputes
//                      these (remat) instead of saving them.
//   ssd_bwd            replaces _ssd_fused_bwd_kernel (:299, launched at
//                      :490): the chunks' cell gradients, with the state
//                      cotangent gP (p x n fp32) walked over the chunks in
//                      reverse, seeded from the final-state cotangent or
//                      zeros.  Per chunk, with
//                      u = x dt, G = C B^T, L[i,j] = e^(a_i - a_j) (i >= j),
//                      M = G .* L, P the state entering the chunk and
//                      dS = gP (the cotangent of the state leaving it):
//                        dM = dy u^T, du = M^T dy + d .* (B dS^T),
//                        da = rowsum(dM.*M) - colsum(dM.*M) + e .* rowsum((dy P).*C)
//                             - d .* rowsum(u .* (B dS^T)), plus the total
//                             of the last term at the last row,
//                        dB = (dM.*L)^T C + round(u .* d) dS,
//                        dC = (dM.*L) B + e .* (dy P),
//                        dx = dt du, ddt_direct = rowsum(x .* du),
//                        dgamma = <dS, P>,  gP <- dy^T (e .* C) + e^(a_L) gP,
//                      and gP after chunk 0 is the initial-state gradient.
//
// The in-chunk log-decay a = cumsum(dt A) comes in precomputed (fp32,
// (b, t, h), as the JAX package's _chunked_inputs hands it to the TPU
// kernels); the plain epilogue (ssd_kernels.py:521-538: da through the
// cumsum chain, the group sums of dB and dC) runs in PyTorch.  Every
// product rounds its operands to the compute dtype (= the input dtype
// here) where the TPU kernel casts with .astype(compute_dtype), and sums
// in fp32.
//
// Two designs of each; one rule picks between them for the chunk states
// and the backward alike (uses_tc here, ssd_kernels.
// ssd_bwd_uses_tensor_cores in the wrappers): bf16 with p = 64, n = 64 or
// 128 and a chunk that is a multiple of 64 (the presets' (64, 128) at l
// 256 among them) runs the tensor-core kernels, every other call (fp32,
// other shapes, a ragged chunk) the CUDA-core kernels.
//
// Chunk states.  The work is small: at mamba2-280m's training layer (b
// 32, t 1024, l 256, 24 heads) 12.9 GFLOP against 0.22 GB (x and the fp32
// S, 0.1 GB each, plus B, dt and a), about 60 operations per byte, so the
// bytes bound it (0.064 ms).
// * Tensor cores (ssd_states_tc_kernel): one CTA per (head, chunk,
//   batch), a consumer warpgroup and a producer warp; the (B_j, x_j)
//   64-row tiles come by TMA through the two-stage ring, B_j is scaled in
//   place into round(B_j w) and S += round(x_j)^T round(B_j w) runs as
//   wgmma with both operands MN-major (the state product of
//   ssd_fwd_tc_kernel); S is written from registers with 16-byte stores.
//   Small shared memory (about 50 KB) puts four CTAs on an SM, so the
//   copies of some overlap the products and stores of others.
// * CUDA cores (ssd_states_kernel): one CTA of 256 threads per (head,
//   chunk, batch), fp32 tiles of x and round(B w) in shared memory from
//   plain loads, a 16 x 16 thread grid of fp32 FMAs.
//
// Backward:
// * Tensor cores (hopper.cuh's building blocks), two launches.  The only
//   value carried from one chunk to the next is the p x n state cotangent,
//   so it is split out:
//   - ssd_bwd_ds_tc_kernel, one CTA per (head, batch), walks the chunks in
//     reverse with gP in the consumers' registers as the fp32 accumulator
//     of gP <- e^(a_L) gP + round(dy)^T round(e C) (wgmma, both operands
//     MN-major, dy and C by TMA in 64-row tiles); before each chunk's step
//     it writes round(dS_c) and round(P_c) as bf16 tiles for the second
//     kernel, and dgamma_c = <dS_c, P_c> (a fixed-order sum).  Its product
//     is about 8% of the counted multiply-adds, over b h CTAs.
//   - ssd_bwd_tc_kernel, one work item per (64-row block I, head, batch
//     x chunk), in parallel over the chunks (12,288 items at b 32, l 256),
//     two items a CTA, each one warpgroup with its own shared memory and
//     named barrier: the column phase's accumulators need 254 registers,
//     so a CTA is two warpgroups and no producer warp, 256 threads that
//     fill the SM's register file with two items in flight.  The
//     warpgroup's thread 0 copies, by TMA over strided 4-D maps,
//     the item's own C_I, B_I, dy_I, x_I, then through a two-stage
//     mbarrier ring round(P_c), B_J and x_J for J < I, round(dS_c), C_I'
//     and dy_I' for I' > I, each stage once the warpgroup is done with the
//     one it replaces.  The row phase builds
//     dC_I = e .* (dy_I round(P)) + sum_{J <= I} round(dM .* L) B_J and the
//     row sums of dM .* M from G = C_I B_J^T and dM = dy_I round(x_J dt)^T;
//     the column phase builds du_I and dB_I from the transposed blocks
//     G^T = B_I C_I'^T and dM^T = round(x_I dt) dy_I'^T over I' >= I, with
//     round(M)^T and round(dM .* L)^T as register A operands, after the
//     state terms dw = B_I round(dS)^T and round(u d) round(dS).  So each
//     item does nrb + 1 steps of 64-row blocks whatever its I, and G and dM
//     are computed twice (once per phase) on the tensor cores rather than
//     transposed in registers.  L = e^(a_i - a_j) is evaluated only where
//     i >= j (mask before the exp), the rounded operands are written into
//     swizzled tiles (Tile::chunk_offset) or kept as register fragments,
//     and every output row is written by the one item that owns it, so no
//     atomics: the block's share of the last row's total (sum_j d_j
//     rowsum(u .* dw)_j) goes to a (b, nc, h, l/64) array that the wrapper
//     adds in block order.
// * CUDA cores (ssd_bwd_kernel): one CTA of 256 threads (a 16 x 16 grid)
//   per (batch, head) walks the chunks in REVERSE with gP in shared memory;
//   the l x l blocks (l up to 256) are tiled into RB x RB blocks (RB = 64,
//   or 32 at headdim 128 to fit shared memory), fp32 tiles from plain
//   loads and fp32 FMAs; sums down the columns (du, dB, the column sum of
//   da) accumulate over the row blocks I >= J for one column block J at a
//   time (pass B), sums along the rows (dC, the row sum of da) over the
//   column blocks J <= I (pass A), each pass recomputing G and dM.
//
// Bound on the H100.  At mamba2-280m's training layer (b 32, t 1024, l
// 256, 24 heads, p 64, n 128, bf16) the work is 155 GFLOP (the causal
// halves of G, dM, du, dB and dC and four l x p x n state products) against
// 1.26 GB moved, 0.81 GB of it the per-head fp32 dB and dC (b, t, h, n)
// the TPU kernel emits: about 123 operations per byte, below the card's
// ~295 bf16 tensor-core operations per byte, so the least time is set by
// the bytes (0.377 ms).  The tensor-core route does more than that: G and
// dM twice (about 1.3x the counted products), the bf16 round(P) and
// round(dS) through device memory (0.1 GB each way), and every item reads
// its chunk's tiles again from L2.  A grouped in-kernel sum of dB and dC
// over a group's heads would cut the largest item of the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kMaxChunk = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// round an fp32 value to the compute dtype T and back
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// sum over the 16 lanes that share a row of the 16 x 16 thread grid
// (tid = 16 * ty + tx: the xor partners of offsets < 16 keep ty)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ------------------------------------------------------------ chunk states

struct StatesParams {
  const void* x;
  const float* dt;
  const float* acum;  // (b, t, h) contiguous
  const void* B;
  float* out;  // (b, nc, h, p, n) contiguous
  int batch, seqlen, nheads, ngroups, chunk;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg;
};

constexpr int kStatesRows = 64;

template <int P, int N>
constexpr size_t states_smem_floats() {
  return size_t(kStatesRows) * (P + 1) + size_t(kStatesRows) * (N + 1) + kStatesRows;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_states_kernel(const StatesParams prm) {
  static_assert(P % 16 == 0 && N % 16 == 0, "p and n must be multiples of 16");
  constexpr int SP = P + 1, SN = N + 1;
  constexpr int RP = P / 16, RN = N / 16;
  extern __shared__ float smem[];
  float* xs = smem;                    // kStatesRows x SP
  float* bs = xs + kStatesRows * SP;   // kStatesRows x SN, round(B w)
  float* ws = bs + kStatesRows * SN;   // kStatesRows

  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int grp = h * prm.ngroups / prm.nheads;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int l = prm.chunk, nc = prm.seqlen / l, H = prm.nheads;
  const long long t0 = (long long)c * l;
  const T* X = static_cast<const T*>(prm.x) + bi * prm.x_sb + h * prm.x_sh;
  const T* Bp = static_cast<const T*>(prm.B) + bi * prm.b_sb + grp * prm.b_sg;
  const float* DT = prm.dt + bi * prm.dt_sb + h * prm.dt_sh;
  const float* AC = prm.acum + (long long)bi * prm.seqlen * H + h;
  const float a_last = AC[(t0 + l - 1) * H];

  float acc[RP][RN];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) acc[r][q] = 0.f;

  for (int j0 = 0; j0 < l; j0 += kStatesRows) {
    __syncthreads();
    if (tid < kStatesRows) {
      const int j = j0 + tid;
      ws[tid] = j < l ? DT[(t0 + j) * prm.dt_st] * expf(a_last - AC[(t0 + j) * H]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < kStatesRows * P; e += kThreads) {
      const int r = e / P, pi = e % P, j = j0 + r;
      xs[r * SP + pi] = j < l ? to_f<T>(X[(t0 + j) * prm.x_st + pi]) : 0.f;
    }
    for (int e = tid; e < kStatesRows * N; e += kThreads) {
      const int r = e / N, k = e % N, j = j0 + r;
      bs[r * SN + k] = j < l ? rnd<T>(to_f<T>(Bp[(t0 + j) * prm.b_st + k]) * ws[r]) : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kStatesRows; ++jj) {
      float xv[RP], bv[RN];
#pragma unroll
      for (int r = 0; r < RP; ++r) xv[r] = xs[jj * SP + ty + 16 * r];
#pragma unroll
      for (int q = 0; q < RN; ++q) bv[q] = bs[jj * SN + tx + 16 * q];
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) acc[r][q] += xv[r] * bv[q];
    }
  }

  float* out = prm.out + (((long long)bi * nc + c) * H + h) * P * N;
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int q = 0; q < RN; ++q) out[(ty + 16 * r) * N + tx + 16 * q] = acc[r][q];
}

// ------------------------------------------------------------ fused backward

struct BwdParams {
  const void* x;
  const float* dt;
  const float* acum;   // (b, t, h) contiguous
  const void* B;
  const void* C;
  const float* prev;   // (b, nc, h, p, n) contiguous: state entering each chunk
  const void* dy;      // (b, t, h, p) contiguous
  const float* dfin;   // (b, h, p, n) contiguous or null (zeros)
  void* dx;            // (b, t, h, p) contiguous
  float* ddt;          // (b, t, h)
  float* da;           // (b, t, h)
  float* dB;           // (b, t, h, n)
  float* dC;           // (b, t, h, n)
  float* dgamma;       // (b, nc, h)
  float* dinit;        // (b, h, p, n)
  int batch, seqlen, nheads, ngroups, chunk;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

template <int P, int N, int RB>
constexpr size_t bwd_smem_floats() {
  return size_t(P) * (N + 1)              // gP
         + 2 * size_t(RB) * (N + 1)       // C rows, B rows
         + 2 * size_t(RB) * (P + 1)       // dy rows, u (or w) rows
         + 2 * size_t(RB) * (RB + 1)      // two RB x RB blocks
         + 4 * kMaxChunk                  // a, dt, da, ddd
         + 8;                             // warp partials
}

template <typename T, int P, int N, int RB>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_kernel(const BwdParams prm) {
  static_assert(P % 16 == 0 && N % 16 == 0 && RB % 16 == 0, "tile sizes");
  constexpr int R = RB / 16;  // rows, and block columns, per thread
  constexpr int RP = P / 16, RN = N / 16;
  constexpr int SN = N + 1, SP = P + 1, SB = RB + 1;  // padded strides

  extern __shared__ float smem[];
  float* gP = smem;             // P x SN: the state cotangent
  float* tC = gP + P * SN;      // RB x SN
  float* tB = tC + RB * SN;     // RB x SN
  float* tY = tB + RB * SN;     // RB x SP: dy rows
  float* tU = tY + RB * SP;     // RB x SP: round(u) rows, later round(u d)
  float* b1 = tU + RB * SP;     // RB x SB
  float* b2 = b1 + RB * SB;     // RB x SB
  float* as_ = b2 + RB * SB;    // kMaxChunk: a
  float* dts = as_ + kMaxChunk; // dt
  float* das = dts + kMaxChunk; // da accumulators
  float* dds = das + kMaxChunk; // the last-row terms d .* rowsum(u .* dw)
  float* red = dds + kMaxChunk; // 8 warp partials

  const int h = blockIdx.x, bi = blockIdx.y;
  const int grp = h * prm.ngroups / prm.nheads;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = prm.chunk, nc = prm.seqlen / l, H = prm.nheads;

  const T* X = static_cast<const T*>(prm.x) + bi * prm.x_sb + h * prm.x_sh;
  const T* Bp = static_cast<const T*>(prm.B) + bi * prm.b_sb + grp * prm.b_sg;
  const T* Cp = static_cast<const T*>(prm.C) + bi * prm.c_sb + grp * prm.c_sg;
  const float* DT = prm.dt + bi * prm.dt_sb + h * prm.dt_sh;
  const long long row0 = (long long)bi * prm.seqlen * H + h;  // (b, t, h) offset of t = 0
  const float* AC = prm.acum + row0;
  const T* DY = static_cast<const T*>(prm.dy) + row0 * P;
  T* DX = static_cast<T*>(prm.dx) + row0 * P;
  float* DDT = prm.ddt + row0;
  float* DA = prm.da + row0;
  float* DBo = prm.dB + row0 * N;
  float* DCo = prm.dC + row0 * N;
  const long long hp = (long long)H * P, hn = (long long)H * N;
  const long long st_off = ((long long)bi * H + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads)
    gP[(e / N) * SN + e % N] = prm.dfin ? prm.dfin[st_off + e] : 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const long long t0 = (long long)c * l;
    const float* Pc = prm.prev + (((long long)bi * nc + c) * H + h) * P * N;
    __syncthreads();
    for (int i = tid; i < l; i += kThreads) {
      as_[i] = AC[(t0 + i) * H];
      dts[i] = DT[(t0 + i) * prm.dt_st];
      das[i] = 0.f;
      dds[i] = 0.f;
    }
    __syncthreads();
    const float a_last = as_[l - 1];

    // ---- pass A, one row block I at a time: dC and the row sums of da
    for (int i0 = 0; i0 < l; i0 += RB) {
      __syncthreads();
      for (int e = tid; e < RB * N; e += kThreads) {
        const int r = e / N, k = e % N, i = i0 + r;
        tC[r * SN + k] = i < l ? to_f<T>(Cp[(t0 + i) * prm.c_st + k]) : 0.f;
      }
      for (int e = tid; e < RB * P; e += kThreads) {
        const int r = e / P, pi = e % P, i = i0 + r;
        tY[r * SP + pi] = i < l ? to_f<T>(DY[(t0 + i) * hp + pi]) : 0.f;
      }
      float accC[R][RN];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) accC[r][q] = 0.f;

      for (int j0 = 0; j0 <= i0; j0 += RB) {
        __syncthreads();
        for (int e = tid; e < RB * N; e += kThreads) {
          const int r = e / N, k = e % N, j = j0 + r;
          tB[r * SN + k] = j < l ? to_f<T>(Bp[(t0 + j) * prm.b_st + k]) : 0.f;
        }
        for (int e = tid; e < RB * P; e += kThreads) {
          const int r = e / P, pi = e % P, j = j0 + r;
          tU[r * SP + pi] = j < l ? rnd<T>(to_f<T>(X[(t0 + j) * prm.x_st + pi]) * dts[j]) : 0.f;
        }
        __syncthreads();
        float g[R][R], dm[R][R];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < R; ++q) g[r][q] = dm[r][q] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[R], bv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) cv[r] = tC[(ty + 16 * r) * SN + k];
#pragma unroll
          for (int q = 0; q < R; ++q) bv[q] = tB[(tx + 16 * q) * SN + k];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q = 0; q < R; ++q) g[r][q] += cv[r] * bv[q];
        }
        for (int k = 0; k < P; ++k) {
          float yv[R], uv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) yv[r] = tY[(ty + 16 * r) * SP + k];
#pragma unroll
          for (int q = 0; q < R; ++q) uv[q] = tU[(tx + 16 * q) * SP + k];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q = 0; q < R; ++q) dm[r][q] += yv[r] * uv[q];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = i0 + ty + 16 * r;
          float rs = 0.f;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int j = j0 + tx + 16 * q;
            float dg = 0.f;
            if (i < l && j <= i) {  // mask before the exp
              const float L = expf(as_[i] - as_[j]);
              dg = dm[r][q] * L;
              rs += dm[r][q] * (g[r][q] * L);
            }
            b1[(ty + 16 * r) * SB + tx + 16 * q] = rnd<T>(dg);
          }
          rs = sum16(rs);
          if (tx == 0 && i < l) das[i] += rs;
        }
        __syncthreads();
        // dC_I += round(dG) round(B_J)
        for (int jj = 0; jj < RB; ++jj) {
          float dv[R], bv[RN];
#pragma unroll
          for (int r = 0; r < R; ++r) dv[r] = b1[(ty + 16 * r) * SB + jj];
#pragma unroll
          for (int q = 0; q < RN; ++q) bv[q] = tB[jj * SN + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q = 0; q < RN; ++q) accC[r][q] += dv[r] * bv[q];
        }
      }

      // off-diagonal term: Tm = round(dy_I) round(P), dC += e Tm, da += e rowsum(Tm C)
      float tm[R][RN];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q) tm[r][q] = 0.f;
      for (int k = 0; k < P; ++k) {
        float yv[R], pv[RN];
#pragma unroll
        for (int r = 0; r < R; ++r) yv[r] = tY[(ty + 16 * r) * SP + k];
#pragma unroll
        for (int q = 0; q < RN; ++q) pv[q] = rnd<T>(Pc[k * N + tx + 16 * q]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) tm[r][q] += yv[r] * pv[q];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + ty + 16 * r;
        const bool ok = i < l;
        const float ei = ok ? expf(as_[i]) : 0.f;
        float de = 0.f;
#pragma unroll
        for (int q = 0; q < RN; ++q) {
          const int k = tx + 16 * q;
          de += tm[r][q] * tC[(ty + 16 * r) * SN + k];
          if (ok) DCo[(t0 + i) * hn + k] = accC[r][q] + ei * tm[r][q];
        }
        de = sum16(de);
        if (tx == 0 && ok) das[i] += de * ei;
      }
    }

    // ---- pass B, one column block J at a time: dx, ddt, dB, column sums of da
    for (int j0 = 0; j0 < l; j0 += RB) {
      __syncthreads();
      for (int e = tid; e < RB * N; e += kThreads) {
        const int r = e / N, k = e % N, j = j0 + r;
        tB[r * SN + k] = j < l ? to_f<T>(Bp[(t0 + j) * prm.b_st + k]) : 0.f;
      }
      for (int e = tid; e < RB * P; e += kThreads) {
        const int r = e / P, pi = e % P, j = j0 + r;
        tU[r * SP + pi] = j < l ? rnd<T>(to_f<T>(X[(t0 + j) * prm.x_st + pi]) * dts[j]) : 0.f;
      }
      float adu[R][RP], adb[R][RN];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int q = 0; q < RP; ++q) adu[r][q] = 0.f;
#pragma unroll
        for (int q = 0; q < RN; ++q) adb[r][q] = 0.f;
      }

      for (int i0 = j0; i0 < l; i0 += RB) {
        __syncthreads();
        for (int e = tid; e < RB * N; e += kThreads) {
          const int r = e / N, k = e % N, i = i0 + r;
          tC[r * SN + k] = i < l ? to_f<T>(Cp[(t0 + i) * prm.c_st + k]) : 0.f;
        }
        for (int e = tid; e < RB * P; e += kThreads) {
          const int r = e / P, pi = e % P, i = i0 + r;
          tY[r * SP + pi] = i < l ? to_f<T>(DY[(t0 + i) * hp + pi]) : 0.f;
        }
        __syncthreads();
        // transposed ownership: this thread's rows are j, its columns i
        float g[R][R], dm[R][R];
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < R; ++q) g[r][q] = dm[r][q] = 0.f;
        for (int k = 0; k < N; ++k) {
          float bv[R], cv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) bv[r] = tB[(ty + 16 * r) * SN + k];
#pragma unroll
          for (int q = 0; q < R; ++q) cv[q] = tC[(tx + 16 * q) * SN + k];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q = 0; q < R; ++q) g[r][q] += bv[r] * cv[q];
        }
        for (int k = 0; k < P; ++k) {
          float uv[R], yv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) uv[r] = tU[(ty + 16 * r) * SP + k];
#pragma unroll
          for (int q = 0; q < R; ++q) yv[q] = tY[(tx + 16 * q) * SP + k];
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int q = 0; q < R; ++q) dm[r][q] += uv[r] * yv[q];
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = j0 + ty + 16 * r;
          float cs = 0.f;
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int i = i0 + tx + 16 * q;
            float m = 0.f, dg = 0.f;
            if (i < l && j <= i) {  // mask before the exp
              const float L = expf(as_[i] - as_[j]);
              m = g[r][q] * L;
              dg = dm[r][q] * L;
              cs += dm[r][q] * m;
            }
            b1[(ty + 16 * r) * SB + tx + 16 * q] = rnd<T>(m);
            b2[(ty + 16 * r) * SB + tx + 16 * q] = rnd<T>(dg);
          }
          cs = sum16(cs);
          if (tx == 0 && j < l) das[j] -= cs;
        }
        __syncthreads();
        // du_J += round(M)^T round(dy_I),  dB_J += round(dG)^T round(C_I)
        for (int ii = 0; ii < RB; ++ii) {
          float mv[R], gv[R], yv[RP], cv[RN];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            mv[r] = b1[(ty + 16 * r) * SB + ii];
            gv[r] = b2[(ty + 16 * r) * SB + ii];
          }
#pragma unroll
          for (int q = 0; q < RP; ++q) yv[q] = tY[ii * SP + tx + 16 * q];
#pragma unroll
          for (int q = 0; q < RN; ++q) cv[q] = tC[ii * SN + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int q = 0; q < RP; ++q) adu[r][q] += mv[r] * yv[q];
#pragma unroll
            for (int q = 0; q < RN; ++q) adb[r][q] += gv[r] * cv[q];
          }
        }
      }

      // state-summary terms of rows J: dw = round(B_J) round(dS)^T
      float dw[R][RP];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int q = 0; q < RP; ++q) dw[r][q] = 0.f;
      for (int k = 0; k < N; ++k) {
        float bv[R], sv[RP];
#pragma unroll
        for (int r = 0; r < R; ++r) bv[r] = tB[(ty + 16 * r) * SN + k];
#pragma unroll
        for (int q = 0; q < RP; ++q) sv[q] = rnd<T>(gP[(tx + 16 * q) * SN + k]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) dw[r][q] += bv[r] * sv[q];
      }
      __syncthreads();  // every read of round(u) is done: tU now takes round(u d)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + ty + 16 * r;
        const bool ok = j < l;
        const float dtj = ok ? dts[j] : 0.f;
        const float dj = ok ? expf(a_last - as_[j]) : 0.f;
        float dd = 0.f, ddt = 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) {
          const int pi = tx + 16 * q;
          const float xv = ok ? to_f<T>(X[(t0 + j) * prm.x_st + pi]) : 0.f;
          const float u = xv * dtj;
          const float du = adu[r][q] + dj * dw[r][q];
          dd += u * dw[r][q];
          ddt += xv * du;
          if (ok) DX[(t0 + j) * hp + pi] = from_f<T>(dtj * du);
          tU[(ty + 16 * r) * SP + pi] = rnd<T>(u * dj);
        }
        dd = sum16(dd);
        ddt = sum16(ddt);
        if (tx == 0 && ok) {
          const float ddd = dd * dj;
          das[j] -= ddd;
          dds[j] = ddd;
          DDT[(t0 + j) * H] = ddt;
        }
      }
      __syncthreads();
      // dB_J += round(u d) round(dS)
      for (int k = 0; k < P; ++k) {
        float wv[R], sv[RN];
#pragma unroll
        for (int r = 0; r < R; ++r) wv[r] = tU[(ty + 16 * r) * SP + k];
#pragma unroll
        for (int q = 0; q < RN; ++q) sv[q] = rnd<T>(gP[k * SN + tx + 16 * q]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) adb[r][q] += wv[r] * sv[q];
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = j0 + ty + 16 * r;
        if (j < l) {
#pragma unroll
          for (int q = 0; q < RN; ++q) DBo[(t0 + j) * hn + tx + 16 * q] = adb[r][q];
        }
      }
    }
    __syncthreads();

    // ---- whole-chunk terms: the last-row total, da out, dgamma
    if (warp == 0) {
      float s = 0.f;
      for (int i = lane; i < l; i += 32) s += dds[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) das[l - 1] += s;
    }
    float part = 0.f;
    for (int e = tid; e < P * N; e += kThreads) part += gP[(e / N) * SN + e % N] * Pc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    for (int i = tid; i < l; i += kThreads) DA[(t0 + i) * H] = das[i];
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) s += red[w];
      prm.dgamma[((long long)bi * nc + c) * H + h] = s;
    }

    // ---- gP <- round(dy)^T round(e C) + e^(a_L) gP
    float ap[RP][RN];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) ap[r][q] = 0.f;
    for (int i0 = 0; i0 < l; i0 += RB) {
      __syncthreads();
      for (int e = tid; e < RB * N; e += kThreads) {
        const int r = e / N, k = e % N, i = i0 + r;
        tC[r * SN + k] = i < l ? rnd<T>(to_f<T>(Cp[(t0 + i) * prm.c_st + k]) * expf(as_[i])) : 0.f;
      }
      for (int e = tid; e < RB * P; e += kThreads) {
        const int r = e / P, pi = e % P, i = i0 + r;
        tY[r * SP + pi] = i < l ? to_f<T>(DY[(t0 + i) * hp + pi]) : 0.f;
      }
      __syncthreads();
      for (int ii = 0; ii < RB; ++ii) {
        float yv[RP], cv[RN];
#pragma unroll
        for (int r = 0; r < RP; ++r) yv[r] = tY[ii * SP + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < RN; ++q) cv[q] = tC[ii * SN + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) ap[r][q] += yv[r] * cv[q];
      }
    }
    __syncthreads();
    const float gamma = expf(a_last);
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float* s = &gP[(ty + 16 * r) * SN + tx + 16 * q];
        *s = ap[r][q] + gamma * *s;
      }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kThreads) prm.dinit[st_off + e] = gP[(e / N) * SN + e % N];
}

// ============================================= tensor-core kernels (bf16)

// The one dispatch rule, here and in the Python wrappers
// (ssd_kernels.ssd_bwd_uses_tensor_cores): bf16 with headdim 64, d_state 64
// or 128 and a chunk that is a multiple of 64 runs the tensor-core chunk
// states and the two tensor-core backward kernels; every other call the
// CUDA-core ssd_states_kernel and ssd_bwd_kernel.
bool uses_tc(int dtype, int p, int n, int chunk) {
  return dtype == 1 && p == 64 && (n == 64 || n == 128) && chunk % kWgRows == 0;
}

constexpr int kTcP = 64;  // headdim of the tensor-core kernels

struct TcMaps {
  CUtensorMap x, B, C, dy, P, S;  // P, S: round(P_c), round(dS_c) as (n, p, h, b nc)
};

// the tensor-core route's workspaces, from the wrapper
struct TcWork {
  __nv_bfloat16* Pb;  // (b, nc, h, p, n): round(P_c), the state entering chunk c
  __nv_bfloat16* Sb;  // (b, nc, h, p, n): round(dS_c), the cotangent of the state leaving it
  float* tail;        // (b, nc, h, l / 64): each row block's sum of d .* rowsum(u .* dw)
};

// ------------------------------------------------ chunk states, tensor cores

struct StatesMaps {
  CUtensorMap x, B;
};

template <int N> struct StatesTcLayout {
  using CT = Tile<N, kWgRows>;     // B_j rows, scaled in place into round(B_j w)
  using XT = Tile<kTcP, kWgRows>;  // x_j rows
  static constexpr int STAGE = CT::BYTES + XT::BYTES;
  static constexpr int ARR = kStages * STAGE;               // w of the chunk
  static constexpr int BARS = ARR + kMaxChunk * 4;          // full[], empty[]
  static constexpr int BYTES = BARS + 8 * 2 * kStages + 1024;  // + alignment slack
};

// The chunk states on the tensor cores, one CTA per (head, chunk, batch):
// the producer warp copies the chunk's (B_j, x_j) 64-row tiles by TMA
// through the two-stage ring; the consumer warpgroup scales each B_j tile
// in place into round(B_j w) (fp32 product, one round to bf16) and runs
//   S += round(x_j)^T round(B_j w)     (wgmma, both operands MN-major)
// with S (p x n, fp32) in its registers; then writes S with 16-byte
// stores, each quad's lane pairs swapping halves so that a lane holds four
// consecutive columns.  No scratch tile: about 50 KB of shared memory at
// n 128, four CTAs an SM, so other CTAs' copies run during one's product.
template <int N>
__global__ void __launch_bounds__(kTcThreads)
    ssd_states_tc_kernel(const __grid_constant__ StatesMaps maps, const StatesParams prm) {
  using L = StatesTcLayout<N>;
  using CT = typename L::CT;
  using XT = typename L::XT;
  constexpr int P = kTcP;
  extern __shared__ float smem[];  // as the CUDA-core kernels declare it
  uint8_t* base = align1024(reinterpret_cast<uint8_t*>(smem));
  uint8_t* ring = base;
  float* ws = reinterpret_cast<float*>(base + L::ARR);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + kStages;

  const int h = blockIdx.x, c = blockIdx.y, bi = blockIdx.z;
  const int l = prm.chunk, nc = prm.seqlen / l, nrb = l / kWgRows, H = prm.nheads;
  const int grp = h * prm.ngroups / prm.nheads;
  const int t0 = c * l;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      for (int j = 0; j < nrb; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty + s, (j / kStages - 1) & 1);
        uint8_t* st = ring + s * L::STAGE;
        mbar_expect_tx(full + s, L::STAGE);
        for (int q = 0; q < CT::NP; ++q)
          tma_load(st + q * CT::PANEL_B, &maps.B, full + s, q * CT::PW, t0 + j * kWgRows, grp, bi);
        tma_load(st + CT::BYTES, &maps.x, full + s, 0, t0 + j * kWgRows, h, bi);
      }
    }
    return;
  }

  // consumers: this thread holds rows r0 and r0 + 8 (p) of S, columns
  // 8 j + c0 + {0, 1} (n)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const float* AC = prm.acum + (long long)bi * prm.seqlen * H + h;
  const float* DT = prm.dt + bi * prm.dt_sb + h * prm.dt_sh;
  const float a_last = AC[(long long)(t0 + l - 1) * H];
  for (int r = tid; r < l; r += 128)
    ws[r] = DT[(long long)(t0 + r) * prm.dt_st] * expf(a_last - AC[(long long)(t0 + r) * H]);
  wg_bar();

  float S[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) S[i] = 0.f;
  for (int j = 0; j < nrb; ++j) {
    const int s = j % kStages;
    uint8_t* st = ring + s * L::STAGE;
    mbar_wait(full + s, (j / kStages) & 1);
    for (int e = tid; e < kWgRows * N / 8; e += 128) {  // B_j -> round(B_j w), in place
      const int row = e / (N / 8), col = 8 * (e % (N / 8));
      const int off = CT::chunk_offset(row, col);
      scale_chunk(st + off, st + off, ws[j * kWgRows + row]);
    }
    fence_async_smem();
    wg_bar();  // every warp's share of round(B_j w) is written
    fence_regs(S);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk)
      wgmma_ss_mn<N>(S, XT::mnmajor(smem_u32(st + CT::BYTES), kk), CT::mnmajor(smem_u32(st), kk));
    wg_commit();
    wg_wait0();
    fence_regs(S);
    mbar_arrive(empty + s);  // the stage is read no more
  }

  // out (p rows x n) of this (b, c, h): lanes 2k and 2k + 1 of a quad swap
  // halves, so the even lane holds columns [8 j + c0, + 4) of block j and
  // the odd lane [8 (j + 1) + c0 - 2, + 4) of block j + 1
  float* out = prm.out + (((long long)bi * nc + c) * H + h) * P * N;
  const bool odd = lane & 1;
#pragma unroll
  for (int j = 0; j < N / 8; j += 2)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int x0 = 4 * j + 2 * i, x1 = x0 + 4;  // block j's pair, block j + 1's pair
      const float g0 = __shfl_xor_sync(0xffffffffu, odd ? S[x0] : S[x1], 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, odd ? S[x0 + 1] : S[x1 + 1], 1);
      const float4 v = odd ? make_float4(g0, g1, S[x1], S[x1 + 1])
                           : make_float4(S[x0], S[x0 + 1], g0, g1);
      const int col = odd ? 8 * (j + 1) + c0 - 2 : 8 * j + c0;
      *reinterpret_cast<float4*>(out + (r0 + 8 * i) * N + col) = v;
    }
}

template <int N> struct DsLayout {
  using CT = Tile<N, kWgRows>;     // C_j rows, round(e C_j)
  using XT = Tile<kTcP, kWgRows>;  // dy_j rows
  static constexpr int STAGE = CT::BYTES + XT::BYTES;
  static constexpr int SCR = kStages * STAGE;
  static constexpr int ARR = SCR + CT::BYTES;              // e^a of the chunk; 4 warp partials
  static constexpr int BARS = ARR + (kMaxChunk + 4) * 4;   // full[], empty[]
  static constexpr int BYTES = BARS + 8 * 2 * kStages + 1024;
};

// The state cotangent, one CTA per (head, batch): the chunks in reverse
// with gP (p x n, fp32) in the consumers' registers as the accumulator of
//   gP <- e^(a_L) gP + round(dy_c)^T round(e C_c)     (wgmma, both MN-major)
// Before chunk c's update gP is dS_c: written rounded to Sb, with round(P_c)
// to Pb and dgamma_c = <dS_c, P_c> (a fixed-order sum); gP after chunk 0
// is dinit.  dy_c and C_c arrive by TMA in 64-row tiles through the ring.
template <int N>
__global__ void __launch_bounds__(kTcThreads)
    ssd_bwd_ds_tc_kernel(const __grid_constant__ TcMaps maps, const BwdParams prm,
                         const TcWork ws) {
  using L = DsLayout<N>;
  using CT = typename L::CT;
  using XT = typename L::XT;
  constexpr int P = kTcP;
  extern __shared__ float smem[];  // as the CUDA-core kernels declare it
  uint8_t* base = align1024(reinterpret_cast<uint8_t*>(smem));
  uint8_t* ring = base;
  uint8_t* scr = base + L::SCR;
  float* es = reinterpret_cast<float*>(base + L::ARR);
  float* part = es + kMaxChunk;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* empty = full + kStages;

  const int l = prm.chunk, nc = prm.seqlen / l, nrb = l / kWgRows, H = prm.nheads;
  const int h = blockIdx.x, bi = blockIdx.y;
  const int grp = h * prm.ngroups / prm.nheads;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      int n = 0;
      for (int c = nc - 1; c >= 0; --c)
        for (int j = 0; j < nrb; ++j, ++n) {
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(empty + s, (n / kStages - 1) & 1);
          uint8_t* st = ring + s * L::STAGE;
          const int row = c * l + j * kWgRows;
          mbar_expect_tx(full + s, L::STAGE);
          for (int q = 0; q < CT::NP; ++q)
            tma_load(st + q * CT::PANEL_B, &maps.C, full + s, q * CT::PW, row, grp, bi);
          tma_load(st + CT::BYTES, &maps.dy, full + s, 0, row, h, bi);
        }
    }
    return;
  }

  // consumers: this thread holds rows r0 and r0 + 8 (p) of each fragment,
  // columns 8 j + c0 + {0, 1} (n)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const long long st_off = ((long long)bi * H + h) * P * N;
  const float* AC = prm.acum + (long long)bi * prm.seqlen * H + h;
  const uint32_t scr_addr = smem_u32(scr);

  float g[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        g[4 * j + 2 * i + e] = prm.dfin ? prm.dfin[st_off + (r0 + 8 * i) * N + 8 * j + c0 + e] : 0.f;

  int n = 0;  // ring tiles consumed
  for (int c = nc - 1; c >= 0; --c) {
    const long long t0 = (long long)c * l;
    const long long cell = ((long long)bi * nc + c) * H + h;  // (b, nc, h)
    wg_bar();  // the previous chunk's reads of es and part are done
    for (int r = tid; r < l; r += 128) es[r] = expf(AC[(t0 + r) * H]);
    const float* Pc = prm.prev + cell * P * N;
    __nv_bfloat16* Pb = ws.Pb + cell * P * N;
    __nv_bfloat16* Sb = ws.Sb + cell * P * N;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = (r0 + 8 * i) * N + 8 * j + c0;
        const float2 pv = *reinterpret_cast<const float2*>(Pc + o);
        const float s0 = g[4 * j + 2 * i], s1 = g[4 * j + 2 * i + 1];
        dot += s0 * pv.x;
        dot += s1 * pv.y;
        *reinterpret_cast<__nv_bfloat162*>(Pb + o) = __floats2bfloat162_rn(pv.x, pv.y);
        *reinterpret_cast<__nv_bfloat162*>(Sb + o) = __floats2bfloat162_rn(s0, s1);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) part[warp] = dot;
    wg_bar();  // es and the partials are written
    if (tid == 0) prm.dgamma[cell] = (part[0] + part[1]) + (part[2] + part[3]);
    const float gamma = es[l - 1];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) g[i] *= gamma;
    for (int j = 0; j < nrb; ++j, ++n) {
      const int s = n % kStages;
      uint8_t* st = ring + s * L::STAGE;
      mbar_wait(full + s, (n / kStages) & 1);
      for (int e = tid; e < kWgRows * N / 8; e += 128) {
        const int row = e / (N / 8), col = 8 * (e % (N / 8));
        const int off = CT::chunk_offset(row, col);
        scale_chunk(scr + off, st + off, es[j * kWgRows + row]);
      }
      fence_async_smem();
      wg_bar();
      fence_regs(g);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
        wgmma_ss_mn<N>(g, XT::mnmajor(smem_u32(st + CT::BYTES), kk), CT::mnmajor(scr_addr, kk));
      wg_commit();
      wg_wait0();
      fence_regs(g);
      mbar_arrive(empty + s);  // C_j and dy_j are read no more
      wg_bar();                // every warp's product has read the scratch
    }
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        prm.dinit[st_off + (r0 + 8 * i) * N + 8 * j + c0 + e] = g[4 * j + 2 * i + e];
}

// work items of ssd_bwd_tc_kernel a CTA, one warpgroup each (its thread 0
// issues its TMA copies): two items share an SM with no register cap
constexpr int kSlots = 2;
constexpr int kBwdTcThreads = kSlots * 128;

template <int N> struct BwdTcLayout {
  using CT = Tile<N, kWgRows>;     // C, B rows; round(P), round(dS) (p rows x n)
  using XT = Tile<kTcP, kWgRows>;  // x, dy, round(x dt) rows
  static constexpr int OWN_C = 0;  // the item's own block: C_I, B_I, dy_I, x_I, round(x_I dt)
  static constexpr int OWN_B = CT::BYTES;
  static constexpr int OWN_DY = 2 * CT::BYTES;
  static constexpr int OWN_X = OWN_DY + XT::BYTES;
  static constexpr int RU = OWN_X + XT::BYTES;
  static constexpr int RING = RU + XT::BYTES;
  static constexpr int STAGE = CT::BYTES + XT::BYTES;
  static constexpr int ARR = RING + kStages * STAGE;             // a, dt of the chunk; partials
  static constexpr int BARS = ARR + (2 * kMaxChunk + 4) * 4;     // own, full[]
  static constexpr int SLOT = (BARS + 8 * (1 + kStages) + 1023) / 1024 * 1024;
  static constexpr int BYTES = kSlots * SLOT + 1024;             // + alignment slack
};

// read the bf16 pair at (row, 8 j + c0) of a swizzled tile as floats
template <typename T>
__device__ __forceinline__ float2 tile_pair(const uint8_t* tile, int row, int j, int c0) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(tile + T::chunk_offset(row, 8 * j) + 2 * c0));
}

// Stage n of a work item's ring: round(P_c) (n = 0); B_J and x_J for J < I
// (n = J + 1); round(dS_c) (n = I + 1); C_I' and dy_I' for I' > I (n = I').
template <int N>
__device__ __forceinline__ void bwd_issue(const TcMaps& maps, uint8_t* ring, uint64_t* full, int n,
                                          int ib, int row0, int h, int grp, int bi, int cell) {
  using L = BwdTcLayout<N>;
  using CT = typename L::CT;
  const int s = n % kStages;
  uint8_t* st = ring + s * L::STAGE;
  if (n == 0 || n == ib + 1) {
    const CUtensorMap* map = n == 0 ? &maps.P : &maps.S;
    mbar_expect_tx(full + s, CT::BYTES);
    for (int q = 0; q < CT::NP; ++q)
      tma_load(st + q * CT::PANEL_B, map, full + s, q * CT::PW, 0, h, cell);
  } else {
    const bool rows = n <= ib;
    const int row = row0 + (n - 1) * kWgRows;
    mbar_expect_tx(full + s, L::STAGE);
    for (int q = 0; q < CT::NP; ++q)
      tma_load(st + q * CT::PANEL_B, rows ? &maps.B : &maps.C, full + s, q * CT::PW, row, grp, bi);
    tma_load(st + CT::BYTES, rows ? &maps.x : &maps.dy, full + s, 0, row, h, bi);
  }
}

// The chunk's cell gradients, one work item per (64-row block I, head,
// batch x chunk), kSlots items a CTA, each with its own warpgroup, shared
// memory, barriers and named warpgroup barrier; see the header for the
// design.  The warpgroup's thread 0 copies the item's own block, then its
// nrb + 1 ring stages (bwd_issue), each once every thread is done with the
// stage it replaces.
template <int N>
__global__ void __launch_bounds__(kBwdTcThreads, 1)
    ssd_bwd_tc_kernel(const __grid_constant__ TcMaps maps, const BwdParams prm, const TcWork ws) {
  using L = BwdTcLayout<N>;
  using CT = typename L::CT;
  using XT = typename L::XT;
  constexpr int P = kTcP;
  extern __shared__ float smem[];
  const int l = prm.chunk, nc = prm.seqlen / l, nrb = l / kWgRows, H = prm.nheads;
  const int w = threadIdx.x / 128;
  const int item = blockIdx.x * kSlots + w;  // (ib, h, bi * nc + c), ib fastest
  if (item >= nrb * H * prm.batch * nc) return;
  const int ib = item % nrb, h = (item / nrb) % H, bi = item / (nrb * H) / nc,
            c = item / (nrb * H) % nc;
  uint8_t* base = align1024(reinterpret_cast<uint8_t*>(smem)) + w * L::SLOT;
  uint8_t* own_c = base + L::OWN_C;
  uint8_t* own_b = base + L::OWN_B;
  uint8_t* own_dy = base + L::OWN_DY;
  uint8_t* own_x = base + L::OWN_X;
  uint8_t* ru = base + L::RU;
  uint8_t* ring = base + L::RING;
  float* as = reinterpret_cast<float*>(base + L::ARR);
  float* dts = as + kMaxChunk;
  float* part = dts + kMaxChunk;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* full = own_full + 1;
  const int grp = h * prm.ngroups / prm.nheads;
  const int t0 = c * l, i0 = ib * kWgRows;
  const int stages = nrb + 1;
  const int tid = threadIdx.x % 128;

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
    mbar_expect_tx(own_full, 2 * CT::BYTES + 2 * XT::BYTES);
    for (int q = 0; q < CT::NP; ++q) {
      tma_load(own_c + q * CT::PANEL_B, &maps.C, own_full, q * CT::PW, t0 + i0, grp, bi);
      tma_load(own_b + q * CT::PANEL_B, &maps.B, own_full, q * CT::PW, t0 + i0, grp, bi);
    }
    tma_load(own_dy, &maps.dy, own_full, 0, t0 + i0, h, bi);
    tma_load(own_x, &maps.x, own_full, 0, t0 + i0, h, bi);
    for (int n = 0; n < kStages && n < stages; ++n)
      bwd_issue<N>(maps, ring, full, n, ib, t0, h, grp, bi, bi * nc + c);
  }
  // stage n is read no more: refill its slot with stage n + kStages
  auto release = [&](int n) {
    wg_bar(w);
    if (tid == 0 && n + kStages < stages)
      bwd_issue<N>(maps, ring, full, n + kStages, ib, t0, h, grp, bi, bi * nc + c);
  };

  // this thread holds rows r0 and r0 + 8 of each 64-row fragment, columns
  // 8 j + c0 + {0, 1}
  const int lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const float* AC = prm.acum + (long long)bi * prm.seqlen * H + h;
  const float* DT = prm.dt + bi * prm.dt_sb + h * prm.dt_sh;
  for (int r = tid; r < l; r += 128) {
    as[r] = AC[(long long)(t0 + r) * H];
    dts[r] = DT[(long long)(t0 + r) * prm.dt_st];
  }
  wg_bar(w);
  const float a_last = as[l - 1];
  float arow[2], erow[2], drow[2], dtrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i0 + r0 + 8 * i;
    arow[i] = as[row];
    erow[i] = expf(arow[i]);
    drow[i] = expf(a_last - arow[i]);
    dtrow[i] = dts[row];
  }
  const uint32_t c_addr = smem_u32(own_c), b_addr = smem_u32(own_b);
  const uint32_t dy_addr = smem_u32(own_dy), ru_addr = smem_u32(ru);

  mbar_wait(own_full, 0);
  for (int e = tid; e < kWgRows * P / 8; e += 128) {  // round(x_I dt)
    const int row = e / (P / 8), col = 8 * (e % (P / 8));
    const int off = XT::chunk_offset(row, col);
    scale_chunk(ru + off, own_x + off, dts[i0 + row]);
  }
  fence_async_smem();
  wg_bar(w);
  int n = 0;  // ring tiles consumed

  // ---- rows I: dC = e .* (dy round(P)) + sum_J round(dM .* L) B_J, and
  // the row sums of da
  float acc[N / 2];
  {
    const int s = n % kStages;
    uint8_t* st = ring + s * L::STAGE;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    mbar_wait(full + s, (n / kStages) & 1);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss_kn<N>(acc, XT::kmajor(dy_addr, kk), CT::mnmajor(smem_u32(st), kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    release(n);
    ++n;
  }
  float tc[2] = {0.f, 0.f};  // rowsum(T .* C)
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 cv = tile_pair<CT>(own_c, r0 + 8 * i, j, c0);
      tc[i] += acc[4 * j + 2 * i] * cv.x;
      tc[i] += acc[4 * j + 2 * i + 1] * cv.y;
      acc[4 * j + 2 * i] *= erow[i];
      acc[4 * j + 2 * i + 1] *= erow[i];
    }
  float rs[2] = {0.f, 0.f};  // rowsum(dM .* M)
  for (int J = 0; J <= ib; ++J) {
    const int s = n % kStages;
    uint8_t* bj = own_b;
    uint8_t* xj = ru;
    if (J < ib) {
      uint8_t* st = ring + s * L::STAGE;
      mbar_wait(full + s, (n / kStages) & 1);
      bj = st;
      xj = st + CT::BYTES;
      for (int e = tid; e < kWgRows * P / 8; e += 128) {  // x_J -> round(x_J dt), in place
        const int row = e / (P / 8), col = 8 * (e % (P / 8));
        const int off = XT::chunk_offset(row, col);
        scale_chunk(xj + off, xj + off, dts[J * kWgRows + row]);
      }
      fence_async_smem();
      wg_bar(w);
    }
    float g[kWgRows / 2], dm[kWgRows / 2];
#pragma unroll
    for (int i = 0; i < kWgRows / 2; ++i) g[i] = dm[i] = 0.f;
    fence_regs(g);
    fence_regs(dm);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<kWgRows>(g, CT::kmajor(c_addr, kk), CT::kmajor(smem_u32(bj), kk));
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss<kWgRows>(dm, XT::kmajor(dy_addr, kk), XT::kmajor(smem_u32(xj), kk));
    wg_commit();
    wg_wait0();
    fence_regs(g);
    fence_regs(dm);
#pragma unroll
    for (int x = 0; x < kWgRows / 2; ++x) {
      const int i = (x / 2) % 2;
      const int col = 8 * (x / 4) + c0 + x % 2;
      float dg = 0.f;
      if (J < ib || col <= r0 + 8 * i) {  // mask before the exp
        const float Lv = expf(arow[i] - as[J * kWgRows + col]);
        rs[i] += dm[x] * (g[x] * Lv);
        dg = dm[x] * Lv;
      }
      g[x] = dg;
    }
    uint32_t df[kWgRows / 16][4];
    to_a_frags<kWgRows>(df, g);
    fence_regs(acc);
    fence_regs(df);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) wgmma_rs<N>(acc, df[kk], CT::mnmajor(smem_u32(bj), kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    fence_regs(df);
    if (J < ib) {
      release(n);
      ++n;
    }
  }
  const long long row0 = (long long)bi * prm.seqlen + t0 + i0;  // (b, t) of the block's row 0
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* dst = prm.dC + ((row0 + r0 + 8 * i) * H + h) * N + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }

  // ---- columns J = I: du = d .* dw + sum_I' round(M)^T dy_I', dB =
  // round(u d) round(dS) + sum_I' round(dM .* L)^T C_I', the column sums of
  // da, the state terms dw = B round(dS)^T
  float du[P / 2], db[N / 2];
  float ddd[2] = {0.f, 0.f};  // rowsum(u .* dw)
  {
    const int s = n % kStages;
    uint8_t* st = ring + s * L::STAGE;
#pragma unroll
    for (int i = 0; i < P / 2; ++i) du[i] = 0.f;
    mbar_wait(full + s, (n / kStages) & 1);
    fence_regs(du);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<P>(du, CT::kmajor(b_addr, kk), CT::kmajor(smem_u32(st), kk));
    wg_commit();
    wg_wait0();
    fence_regs(du);
    float w[P / 2];  // u .* d, rounded below into the A operand
#pragma unroll
    for (int j = 0; j < P / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 xv = tile_pair<XT>(own_x, r0 + 8 * i, j, c0);
        const float u0 = xv.x * dtrow[i], u1 = xv.y * dtrow[i];
        const int x = 4 * j + 2 * i;
        ddd[i] += u0 * du[x];
        ddd[i] += u1 * du[x + 1];
        w[x] = u0 * drow[i];
        w[x + 1] = u1 * drow[i];
        du[x] *= drow[i];
        du[x + 1] *= drow[i];
      }
    uint32_t wf[P / 16][4];
    to_a_frags<P>(wf, w);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) db[i] = 0.f;
    fence_regs(db);
    fence_regs(wf);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk) wgmma_rs<N>(db, wf[kk], CT::mnmajor(smem_u32(st), kk));
    wg_commit();
    wg_wait0();
    fence_regs(db);
    fence_regs(wf);
    release(n);
    ++n;
  }
  float cs[2] = {0.f, 0.f};  // colsum(dM .* M)
  for (int I2 = ib; I2 < nrb; ++I2) {
    const int s = n % kStages;
    uint8_t* ci = own_c;
    uint8_t* yi = own_dy;
    if (I2 > ib) {
      uint8_t* st = ring + s * L::STAGE;
      mbar_wait(full + s, (n / kStages) & 1);
      ci = st;
      yi = st + CT::BYTES;
    }
    // the transposed blocks: rows j of block I, columns i of block I2
    float g[kWgRows / 2], dm[kWgRows / 2];
#pragma unroll
    for (int i = 0; i < kWgRows / 2; ++i) g[i] = dm[i] = 0.f;
    fence_regs(g);
    fence_regs(dm);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<kWgRows>(g, CT::kmajor(b_addr, kk), CT::kmajor(smem_u32(ci), kk));
#pragma unroll
    for (int kk = 0; kk < P / 16; ++kk)
      wgmma_ss<kWgRows>(dm, XT::kmajor(ru_addr, kk), XT::kmajor(smem_u32(yi), kk));
    wg_commit();
    wg_wait0();
    fence_regs(g);
    fence_regs(dm);
#pragma unroll
    for (int x = 0; x < kWgRows / 2; ++x) {
      const int i = (x / 2) % 2;
      const int col = 8 * (x / 4) + c0 + x % 2;
      float m = 0.f, dg = 0.f;
      if (I2 > ib || col >= r0 + 8 * i) {  // mask before the exp
        const float Lv = expf(as[I2 * kWgRows + col] - arow[i]);
        m = g[x] * Lv;
        cs[i] += dm[x] * m;
        dg = dm[x] * Lv;
      }
      g[x] = m;
      dm[x] = dg;
    }
    uint32_t mf[kWgRows / 16][4], df[kWgRows / 16][4];
    to_a_frags<kWgRows>(mf, g);
    to_a_frags<kWgRows>(df, dm);
    fence_regs(du);
    fence_regs(db);
    fence_regs(mf);
    fence_regs(df);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) wgmma_rs<P>(du, mf[kk], XT::mnmajor(smem_u32(yi), kk));
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) wgmma_rs<N>(db, df[kk], CT::mnmajor(smem_u32(ci), kk));
    wg_commit();
    wg_wait0();
    fence_regs(du);
    fence_regs(db);
    fence_regs(mf);
    fence_regs(df);
    if (I2 > ib) {
      release(n);
      ++n;
    }
  }

  // ---- the rows' outputs: dx, ddt, dB, da; the block's share of the
  // last-row total
  float ddt[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long r = (row0 + r0 + 8 * i) * H + h;
    __nv_bfloat16* dx = static_cast<__nv_bfloat16*>(prm.dx) + r * P + c0;
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
      const float2 xv = tile_pair<XT>(own_x, r0 + 8 * i, j, c0);
      const float d0 = du[4 * j + 2 * i], d1 = du[4 * j + 2 * i + 1];
      ddt[i] += xv.x * d0;
      ddt[i] += xv.y * d1;
      *reinterpret_cast<__nv_bfloat162*>(dx + 8 * j) =
          __floats2bfloat162_rn(dtrow[i] * d0, dtrow[i] * d1);
    }
    float* dst = prm.dB + r * N + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(db[4 * j + 2 * i], db[4 * j + 2 * i + 1]);
  }
  float tail = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float dd = quad_sum(ddd[i]) * drow[i];
    const float da = ((quad_sum(rs[i]) - quad_sum(cs[i])) + quad_sum(tc[i]) * erow[i]) - dd;
    const float dtt = quad_sum(ddt[i]);
    tail += dd;
    if (lane % 4 == 0) {
      const long long r = (row0 + r0 + 8 * i) * H + h;
      prm.da[r] = da;
      prm.ddt[r] = dtt;
    }
  }
  // every lane of a quad holds its two rows' sum: add the warp's 8 quads
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) tail += __shfl_xor_sync(0xffffffffu, tail, off);
  if (lane == 0) part[warp] = tail;
  wg_bar(w);
  if (tid == 0)
    ws.tail[(((long long)bi * nc + c) * H + h) * nrb + ib] = (part[0] + part[1]) + (part[2] + part[3]);
}

template <int N>
cudaError_t launch_bwd_tc(const BwdParams& prm, const TcWork& ws, cudaStream_t stream) {
  using L = BwdTcLayout<N>;
  using D = DsLayout<N>;
  using CT = typename L::CT;
  using XT = typename L::XT;
  const long long H = prm.nheads, T = prm.seqlen;
  const int nc = prm.seqlen / prm.chunk;
  // make_map takes (outer, head, row) element strides
  const long long xs[3] = {prm.x_sb, prm.x_sh, prm.x_st};
  const long long bs[3] = {prm.b_sb, prm.b_sg, prm.b_st};
  const long long cs[3] = {prm.c_sb, prm.c_sg, prm.c_st};
  const long long ys[3] = {T * H * kTcP, kTcP, H * kTcP};  // dy (b, t, h, p) contiguous
  const long long ss[3] = {H * kTcP * N, kTcP * N, N};     // (b nc, h, p) of (b, nc, h, p, n)
  TcMaps maps{};
  if (!make_map(&maps.x, prm.x, kTcP, int(T), int(H), prm.batch, xs, XT::PW, kWgRows) ||
      !make_map(&maps.B, prm.B, N, int(T), prm.ngroups, prm.batch, bs, CT::PW, kWgRows) ||
      !make_map(&maps.C, prm.C, N, int(T), prm.ngroups, prm.batch, cs, CT::PW, kWgRows) ||
      !make_map(&maps.dy, prm.dy, kTcP, int(T), int(H), prm.batch, ys, XT::PW, kWgRows) ||
      !make_map(&maps.P, ws.Pb, N, kTcP, int(H), prm.batch * nc, ss, CT::PW, kWgRows) ||
      !make_map(&maps.S, ws.Sb, N, kTcP, int(H), prm.batch * nc, ss, CT::PW, kWgRows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_ds_tc_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, D::BYTES);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_bwd_tc_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::BYTES);
  if (err != cudaSuccess) return err;
  ssd_bwd_ds_tc_kernel<N><<<dim3(prm.nheads, prm.batch), kTcThreads, D::BYTES, stream>>>(maps, prm,
                                                                                         ws);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long items = (long long)(prm.chunk / kWgRows) * prm.nheads * prm.batch * nc;
  ssd_bwd_tc_kernel<N><<<unsigned((items + kSlots - 1) / kSlots), kBwdTcThreads, L::BYTES,
                         stream>>>(maps, prm, ws);
  return cudaGetLastError();
}

// ------------------------------------------------------------ launchers

template <int N>
cudaError_t launch_states_tc(const StatesParams& prm, cudaStream_t stream) {
  using L = StatesTcLayout<N>;
  // make_map takes (outer, head, row) element strides
  const long long xs[3] = {prm.x_sb, prm.x_sh, prm.x_st};
  const long long bs[3] = {prm.b_sb, prm.b_sg, prm.b_st};
  StatesMaps maps{};
  if (!make_map(&maps.x, prm.x, kTcP, prm.seqlen, prm.nheads, prm.batch, xs, L::XT::PW,
                kWgRows) ||
      !make_map(&maps.B, prm.B, N, prm.seqlen, prm.ngroups, prm.batch, bs, L::CT::PW, kWgRows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_states_tc_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(prm.nheads, prm.seqlen / prm.chunk, prm.batch);
  ssd_states_tc_kernel<N><<<grid, kTcThreads, L::BYTES, stream>>>(maps, prm);
  return cudaGetLastError();
}

template <typename T, int P, int N>
cudaError_t launch_states(const StatesParams& prm, cudaStream_t stream) {
  const int smem = int(states_smem_floats<P, N>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_states_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(prm.nheads, prm.seqlen / prm.chunk, prm.batch);
  ssd_states_kernel<T, P, N><<<grid, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T, int P, int N>
cudaError_t launch_bwd(const BwdParams& prm, cudaStream_t stream) {
  constexpr int RB = P > 64 ? 32 : 64;  // shared memory: gP grows with P
  const int smem = int(bwd_smem_floats<P, N, RB>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, P, N, RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_bwd_kernel<T, P, N, RB><<<dim3(prm.nheads, prm.batch), kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t states_pn(const StatesParams& prm, int p, int n, cudaStream_t s) {
  if (p == 64 && n == 128) return launch_states<T, 64, 128>(prm, s);
  if (p == 64 && n == 64) return launch_states<T, 64, 64>(prm, s);
  if (p == 32 && n == 64) return launch_states<T, 32, 64>(prm, s);
  if (p == 32 && n == 128) return launch_states<T, 32, 128>(prm, s);
  if (p == 128 && n == 128) return launch_states<T, 128, 128>(prm, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t bwd_pn(const BwdParams& prm, int p, int n, cudaStream_t s) {
  if (p == 64 && n == 128) return launch_bwd<T, 64, 128>(prm, s);
  if (p == 64 && n == 64) return launch_bwd<T, 64, 64>(prm, s);
  if (p == 32 && n == 64) return launch_bwd<T, 32, 64>(prm, s);
  if (p == 32 && n == 128) return launch_bwd<T, 32, 128>(prm, s);
  if (p == 128 && n == 128) return launch_bwd<T, 128, 128>(prm, s);
  return cudaErrorInvalidValue;
}

bool bad_shape(int seqlen, int nheads, int ngroups, int chunk) {
  return chunk < 1 || chunk > kMaxChunk || seqlen % chunk != 0 || nheads % ngroups != 0;
}

}  // namespace

// (headdim, d_state) pairs the library is built for (those of ssd_fwd);
// the Python wrappers check against the same list before they launch.
extern "C" int mdt_ssd_bwd_supports(int p, int n) {
  return (p == 64 && (n == 128 || n == 64)) || (p == 32 && (n == 64 || n == 128)) ||
         (p == 128 && n == 128);
}

// 1 when the chunk states and the backward of the dtype code, headdim,
// d_state and chunk run the tensor-core kernels (the wrappers'
// ssd_bwd_uses_tensor_cores is held to it)
extern "C" int mdt_ssd_bwd_uses_tc(int dtype, int p, int n, int chunk) {
  return uses_tc(dtype, p, n, chunk);
}

// Both return a cudaError_t (0 on success).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int mdt_ssd_chunk_states(const void* x, const float* dt, const float* acum,
                                    const void* B, float* out, int batch, int seqlen,
                                    int nheads, int headdim, int ngroups, int dstate,
                                    int chunk, long long x_sb, long long x_st, long long x_sh,
                                    long long dt_sb, long long dt_st, long long dt_sh,
                                    long long b_sb, long long b_st, long long b_sg,
                                    int dtype, void* stream) {
  if (bad_shape(seqlen, nheads, ngroups, chunk)) return (int)cudaErrorInvalidValue;
  StatesParams prm{x,     dt,    acum,  B,     out,   batch, seqlen, nheads,
                   ngroups, chunk, x_sb, x_st, x_sh,  dt_sb, dt_st, dt_sh,
                   b_sb,  b_st,  b_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uses_tc(dtype, headdim, dstate, chunk))
    return (int)(dstate == 128 ? launch_states_tc<128>(prm, s) : launch_states_tc<64>(prm, s));
  return (int)(dtype == 1 ? states_pn<__nv_bfloat16>(prm, headdim, dstate, s)
                          : states_pn<float>(prm, headdim, dstate, s));
}

// ws_p, ws_s (b, nc, h, p, n) bf16 and ws_tail (b, nc, h, chunk / 64) fp32
// are the tensor-core route's workspaces (null on the other route); on it
// da still lacks the last row's total, which the wrapper adds from ws_tail
extern "C" int mdt_ssd_bwd(const void* x, const float* dt, const float* acum, const void* B,
                           const void* C, const float* prev, const void* dy,
                           const float* dfin, void* dx, float* ddt, float* da, float* dB,
                           float* dC, float* dgamma, float* dinit, int batch, int seqlen,
                           int nheads, int headdim, int ngroups, int dstate, int chunk,
                           long long x_sb, long long x_st, long long x_sh, long long dt_sb,
                           long long dt_st, long long dt_sh, long long b_sb, long long b_st,
                           long long b_sg, long long c_sb, long long c_st, long long c_sg,
                           void* ws_p, void* ws_s, float* ws_tail, int dtype, void* stream) {
  if (bad_shape(seqlen, nheads, ngroups, chunk)) return (int)cudaErrorInvalidValue;
  BwdParams prm{x,     dt,    acum,  B,     C,     prev,  dy,    dfin,  dx,    ddt,
                da,    dB,    dC,    dgamma, dinit, batch, seqlen, nheads, ngroups, chunk,
                x_sb,  x_st,  x_sh,  dt_sb, dt_st, dt_sh, b_sb,  b_st,  b_sg,  c_sb,
                c_st,  c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (uses_tc(dtype, headdim, dstate, chunk)) {
    if (ws_p == nullptr || ws_s == nullptr || ws_tail == nullptr)
      return (int)cudaErrorInvalidValue;
    const TcWork ws{static_cast<__nv_bfloat16*>(ws_p), static_cast<__nv_bfloat16*>(ws_s),
                    ws_tail};
    return (int)(dstate == 128 ? launch_bwd_tc<128>(prm, ws, s) : launch_bwd_tc<64>(prm, ws, s));
  }
  return (int)(dtype == 1 ? bwd_pn<__nv_bfloat16>(prm, headdim, dstate, s)
                          : bwd_pn<float>(prm, headdim, dstate, s));
}
