// SSD (Mamba-2 chunked scan) backward, hand-written for Hopper (sm_90a).
//
// Two kernels, the counterparts of the TPU kernels of the SSD backward in
// mamba_distributed_tpu/ops/pallas/ssd_kernels.py:
//
//   ssd_states_kernel  replaces _chunk_states_kernel (:61, launched at
//                      :456): per (batch, chunk, head) the state summary
//                      S[p, n] = sum_j round(x_j)[p] round(B_j w_j)[n],
//                      w_j = dt_j e^(a_L - a_j).  The backward recomputes
//                      these (remat) instead of saving them.
//   ssd_bwd_kernel     replaces _ssd_fused_bwd_kernel (:299, launched at
//                      :490): per (batch, head) the chunks are walked in
//                      REVERSE with the state cotangent gP (p x n fp32)
//                      in shared memory, seeded from the final-state
//                      cotangent or zeros.  Per chunk, with
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
// Design.  One CTA of 256 threads (a 16 x 16 grid) per (batch, head) for
// the backward, one per (batch, chunk, head) for the states.  The l x l
// blocks (l up to 256) are tiled into RB x RB blocks (RB = 64, or 32 at
// headdim 128 to fit shared memory), and e^(a_i - a_j) is evaluated only
// where i >= j.  Sums down the columns of the l x l blocks (du, dB, the
// column sum of da) accumulate over the row blocks I >= J for one column
// block J at a time (pass B); sums along the rows (dC, the row sum of
// da) over the column blocks J <= I for one row block I (pass A).  Each
// pass recomputes G and dM, which doubles their multiply-adds but keeps
// every accumulator to one RB-row block in registers.  The terms that
// reduce over the whole chunk (the last-row total, dgamma, the gP update)
// run after both passes.  gP lives in shared memory for the whole walk;
// P is read from device memory (L2) where it is used.
//
// Bound on the H100.  At mamba2-280m's training shapes (b 8, t 1024, l 256,
// 24 heads, p 64, n 128, bf16) the work is about 39 GFLOP against about
// 310 MB moved, two thirds of it the per-head fp32 dB and dC (b, t, h, n)
// the TPU kernel emits: about 125 operations per byte, below the card's
// ~295 bf16 tensor-core operations per byte, so the least time is set by
// the bytes (about 0.09 ms).  This first version multiplies with
// CUDA-core fp32 FMAs, not tensor cores, on batch * nheads CTAs, and
// recomputes G and dM once; wgmma on the rounded operands, a grouped
// in-kernel sum of dB and dC and a chunk split across CTAs come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// ------------------------------------------------------------ launchers

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
  return (int)(dtype == 1 ? states_pn<__nv_bfloat16>(prm, headdim, dstate, s)
                          : states_pn<float>(prm, headdim, dstate, s));
}

extern "C" int mdt_ssd_bwd(const void* x, const float* dt, const float* acum, const void* B,
                           const void* C, const float* prev, const void* dy,
                           const float* dfin, void* dx, float* ddt, float* da, float* dB,
                           float* dC, float* dgamma, float* dinit, int batch, int seqlen,
                           int nheads, int headdim, int ngroups, int dstate, int chunk,
                           long long x_sb, long long x_st, long long x_sh, long long dt_sb,
                           long long dt_st, long long dt_sh, long long b_sb, long long b_st,
                           long long b_sg, long long c_sb, long long c_st, long long c_sg,
                           int dtype, void* stream) {
  if (bad_shape(seqlen, nheads, ngroups, chunk)) return (int)cudaErrorInvalidValue;
  BwdParams prm{x,     dt,    acum,  B,     C,     prev,  dy,    dfin,  dx,    ddt,
                da,    dB,    dC,    dgamma, dinit, batch, seqlen, nheads, ngroups, chunk,
                x_sb,  x_st,  x_sh,  dt_sb, dt_st, dt_sh, b_sb,  b_st,  b_sg,  c_sb,
                c_st,  c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? bwd_pn<__nv_bfloat16>(prm, headdim, dstate, s)
                          : bwd_pn<float>(prm, headdim, dstate, s));
}
