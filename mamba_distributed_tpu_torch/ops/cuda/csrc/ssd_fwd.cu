// SSD (Mamba-2 chunked scan) forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel _ssd_fused_fwd_kernel
// (mamba_distributed_tpu/ops/pallas/ssd_kernels.py:164, launched by
// _ssd_pallas_fwd_impl at :254).  Same contract: per (batch, head), walk
// the chunks of length l in order with the fp32 state S (p x n) kept
// on-chip, and per chunk
//
//   a   = cumsum(dt * A)                                  (fp32)
//   y   = ((C B^T) .* L) (dt x) + (C .* e^a) S^T,  L[i,j] = e^(a_i - a_j), i >= j
//   S  <- e^(a_L) S + x^T (B .* dt e^(a_L - a))
//
// D is added outside (the wrapper, as _add_D in the JAX package).  y is
// written in x's dtype, the final state in fp32.  Inputs are rounded to
// the compute dtype (= the input dtype here) at the places the JAX kernel
// rounds them: C and B for the Gram matrix, x*dt, the masked decay-weighted
// Gram matrix M, C*e^a, the carried state, x and B*w.  Products of two
// rounded values are exact in fp32 and every sum is taken in fp32, so a
// bf16 result differs from the JAX kernel's only by summation order.
//
// Design.  One CTA of 256 threads per (batch, head); the chunk loop runs
// inside the CTA, so the carried state never leaves shared memory (the
// TPU kernel's sequential grid axis becomes this loop).  The l x l
// product is tiled into 64-row blocks so one CTA fits in shared memory
// at l = 256 (about 131 KB at p = 64, n = 128).  The exponent of L is
// evaluated only where i >= j: e^(a_i - a_j) with i < j may overflow, and
// inf * 0 would be NaN.  Heads read the B and C rows of their group
// (group h * g / nheads) in place, with no repeat in memory; x, B and C
// are read through their batch/time/head strides, so slices of the conv
// output need no copy.
//
// Bound on the H100.  Per chunk and head the work is about
// l^2 (n + p) / 2 + 2 l p n multiply-adds against l (p + 2n) input and
// l p output elements: at l = 256 in bf16 about 150 operations per byte,
// below the card's ~295 bf16 tensor-core operations per byte, so the
// least time is set by the bytes (about 1 us for one 256-token chunk of
// all 24 heads of mamba2-280m).  This first version is far from it: it
// multiplies with CUDA-core fp32 FMAs (one code path for fp32 and bf16),
// not tensor cores, and launches only batch * nheads CTAs (24 for one
// prompt, on 132 SMs).  wgmma on the same rounded values and a chunk
// axis split across CTAs are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kRows = 64;      // row block of the l x l product
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

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* h0;  // (b, h, p, n) fp32 or null (zeros)
  void* y;          // (b, t, h, p) contiguous
  float* hT;        // (b, h, p, n) fp32 contiguous
  int batch, seqlen, nheads, ngroups, chunk;
  long long x_sb, x_st, x_sh;
  long long dt_sb, dt_st, dt_sh;
  long long b_sb, b_st, b_sg;
  long long c_sb, c_st, c_sg;
};

template <int P, int N>
constexpr size_t smem_floats() {
  return size_t(P) * (N + 1)           // S
         + 2 * size_t(kRows) * (N + 1)  // C rows, B rows
         + size_t(kRows) * (P + 1)      // x rows
         + size_t(kRows) * (kRows + 1)  // M block
         + 2 * kMaxChunk                // a, dt
         + 8;                           // scan partials
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const Params prm) {
  static_assert(P % 16 == 0 && N % 16 == 0, "p and n must be multiples of 16");
  constexpr int SP = N + 1;  // padded strides: no bank conflicts on columns
  constexpr int XP = P + 1;
  constexpr int MP = kRows + 1;
  constexpr int RP = P / 16;  // per-thread columns of a (rows x p) tile
  constexpr int RN = N / 16;

  extern __shared__ float smem[];
  float* S = smem;
  float* cs = S + P * SP;
  float* bs = cs + kRows * SP;
  float* xs = bs + kRows * SP;
  float* ms = xs + kRows * XP;
  float* as = ms + kRows * MP;
  float* dts = as + kMaxChunk;
  float* wsum = dts + kMaxChunk;

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int grp = h * prm.ngroups / prm.nheads;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int l = prm.chunk;
  const int nc = prm.seqlen / l;
  const float A = prm.A[h];

  const T* X = static_cast<const T*>(prm.x) + bi * prm.x_sb + h * prm.x_sh;
  const T* Bp = static_cast<const T*>(prm.B) + bi * prm.b_sb + grp * prm.b_sg;
  const T* Cp = static_cast<const T*>(prm.C) + bi * prm.c_sb + grp * prm.c_sg;
  const float* DT = prm.dt + bi * prm.dt_sb + h * prm.dt_sh;
  T* Y = static_cast<T*>(prm.y) + ((long long)bi * prm.seqlen * prm.nheads + h) * P;
  const long long y_st = (long long)prm.nheads * P;
  const long long st_off = ((long long)bi * prm.nheads + h) * P * N;

  for (int e = tid; e < P * N; e += kThreads) {
    const int pi = e / N, ni = e % N;
    S[pi * SP + ni] = prm.h0 ? prm.h0[st_off + e] : 0.f;
  }

  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * l;

    // --- dt and the in-chunk cumulative log-decay a (block inclusive scan)
    float v = 0.f;
    if (tid < l) {
      const float d = DT[(t0 + tid) * prm.dt_st];
      dts[tid] = d;
      v = d * A;
    }
    for (int off = 1; off < 32; off <<= 1) {
      const float nb = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += nb;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float s = lane < 8 ? wsum[lane] : 0.f;
      for (int off = 1; off < 8; off <<= 1) {
        const float nb = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += nb;
      }
      if (lane < 8) wsum[lane] = s;
    }
    __syncthreads();
    if (warp > 0) v += wsum[warp - 1];
    if (tid < l) as[tid] = v;
    __syncthreads();
    const float a_last = as[l - 1];

    // --- outputs, one block of kRows rows at a time
    for (int i0 = 0; i0 < l; i0 += kRows) {
      for (int e = tid; e < kRows * N; e += kThreads) {
        const int r = e / N, k = e % N, i = i0 + r;
        cs[r * SP + k] = i < l ? to_f<T>(Cp[(t0 + i) * prm.c_st + k]) : 0.f;
      }
      __syncthreads();

      float acc[4][RP];
      float ea[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        ea[r] = i < l ? expf(as[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) acc[r][q] = 0.f;
      }
      // carried state: round(C_i e^{a_i}) . round(S_p)
      for (int k = 0; k < N; ++k) {
        float cv[4], sv[RP];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = rnd<T>(cs[(ty + 16 * r) * SP + k] * ea[r]);
#pragma unroll
        for (int q = 0; q < RP; ++q) sv[q] = rnd<T>(S[(tx + 16 * q) * SP + k]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) acc[r][q] += cv[r] * sv[q];
      }

      // intra-chunk: column blocks j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kRows) {
        for (int e = tid; e < kRows * N; e += kThreads) {
          const int r = e / N, k = e % N, j = j0 + r;
          bs[r * SP + k] = j < l ? rnd<T>(to_f<T>(Bp[(t0 + j) * prm.b_st + k])) : 0.f;
        }
        for (int e = tid; e < kRows * P; e += kThreads) {
          const int r = e / P, pi = e % P, j = j0 + r;
          xs[r * XP + pi] =
              j < l ? rnd<T>(to_f<T>(X[(t0 + j) * prm.x_st + pi]) * dts[j]) : 0.f;
        }
        __syncthreads();

        float gacc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) gacc[r][q] = 0.f;
        for (int k = 0; k < N; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = rnd<T>(cs[(ty + 16 * r) * SP + k]);
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = bs[(tx + 16 * q) * SP + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) gacc[r][q] += cv[r] * bv[q];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty + 16 * r;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            float m = 0.f;
            if (i < l && j <= i) m = rnd<T>(gacc[r][q] * expf(as[i] - as[j]));  // mask before exp
            ms[(ty + 16 * r) * MP + tx + 16 * q] = m;
          }
        }
        __syncthreads();

        for (int kk = 0; kk < kRows; ++kk) {
          float mv[4], xv[RP];
#pragma unroll
          for (int r = 0; r < 4; ++r) mv[r] = ms[(ty + 16 * r) * MP + kk];
#pragma unroll
          for (int q = 0; q < RP; ++q) xv[q] = xs[kk * XP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < RP; ++q) acc[r][q] += mv[r] * xv[q];
        }
        __syncthreads();
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < l) {
#pragma unroll
          for (int q = 0; q < RP; ++q)
            Y[(t0 + i) * y_st + tx + 16 * q] = from_f<T>(acc[r][q]);
        }
      }
      __syncthreads();
    }

    // --- state update: S <- e^{a_L} S + round(x)^T round(B dt e^{a_L - a})
    float sacc[RP][RN];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) sacc[r][q] = 0.f;
    for (int j0 = 0; j0 < l; j0 += kRows) {
      for (int e = tid; e < kRows * N; e += kThreads) {
        const int r = e / N, k = e % N, j = j0 + r;
        float w = 0.f;
        if (j < l) w = to_f<T>(Bp[(t0 + j) * prm.b_st + k]) * (dts[j] * expf(a_last - as[j]));
        bs[r * SP + k] = rnd<T>(w);
      }
      for (int e = tid; e < kRows * P; e += kThreads) {
        const int r = e / P, pi = e % P, j = j0 + r;
        xs[r * XP + pi] = j < l ? to_f<T>(X[(t0 + j) * prm.x_st + pi]) : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < kRows; ++jj) {
        float xv[RP], bv[RN];
#pragma unroll
        for (int r = 0; r < RP; ++r) xv[r] = xs[jj * XP + ty + 16 * r];
#pragma unroll
        for (int q = 0; q < RN; ++q) bv[q] = bs[jj * SP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) sacc[r][q] += xv[r] * bv[q];
      }
      __syncthreads();
    }
    const float gamma = expf(a_last);
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float* s = &S[(ty + 16 * r) * SP + tx + 16 * q];
        *s = gamma * *s + sacc[r][q];
      }
    __syncthreads();
  }

  for (int e = tid; e < P * N; e += kThreads) {
    const int pi = e / N, ni = e % N;
    prm.hT[st_off + e] = S[pi * SP + ni];
  }
}

template <typename T, int P, int N>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const int smem = int(smem_floats<P, N>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_fwd_kernel<T, P, N><<<dim3(prm.nheads, prm.batch), kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_pn(const Params& prm, int p, int n, cudaStream_t stream) {
  if (p == 64 && n == 128) return launch<T, 64, 128>(prm, stream);
  if (p == 64 && n == 64) return launch<T, 64, 64>(prm, stream);
  if (p == 32 && n == 64) return launch<T, 32, 64>(prm, stream);
  if (p == 32 && n == 128) return launch<T, 32, 128>(prm, stream);
  if (p == 128 && n == 128) return launch<T, 128, 128>(prm, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// (headdim, d_state) pairs the library is built for; the Python wrapper
// checks against the same list before it launches.
extern "C" int mdt_ssd_fwd_supports(int p, int n) {
  return (p == 64 && (n == 128 || n == 64)) || (p == 32 && (n == 64 || n == 128)) ||
         (p == 128 && n == 128);
}

// Returns a cudaError_t (0 on success).  dtype: 0 = float32, 1 = bfloat16.
extern "C" int mdt_ssd_fwd(const void* x, const float* dt, const float* A, const void* B,
                           const void* C, const float* h0, void* y, float* hT, int batch,
                           int seqlen, int nheads, int headdim, int ngroups, int dstate,
                           int chunk, long long x_sb, long long x_st, long long x_sh,
                           long long dt_sb, long long dt_st, long long dt_sh, long long b_sb,
                           long long b_st, long long b_sg, long long c_sb, long long c_st,
                           long long c_sg, int dtype, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || seqlen % chunk != 0 || nheads % ngroups != 0)
    return (int)cudaErrorInvalidValue;
  Params prm{x,     dt,    A,     B,     C,     h0,    y,     hT,    batch, seqlen,
             nheads, ngroups, chunk, x_sb,  x_st,  x_sh,  dt_sb, dt_st, dt_sh, b_sb,
             b_st,  b_sg,  c_sb,  c_st,  c_sg};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_pn<__nv_bfloat16>(prm, headdim, dstate, s)
                               : launch_pn<float>(prm, headdim, dstate, s);
  return (int)err;
}
