// Causal GQA flash attention, forward and backward, hand-written for Hopper
// (sm_90a): three kernels, the counterparts of the TPU kernels of
// mamba_distributed_tpu/ops/pallas/attention_kernels.py:
//
//   flash_fwd_kernel      replaces _fa_fwd_kernel (:65, launched by
//                         _fa_fwd_impl at :240): o and the row
//                         log-sum-exp, online softmax over kv blocks,
//                         fully-future blocks skipped;
//   flash_bwd_dq_kernel   replaces _fa_bwd_dq_kernel (:127, launched by
//                         _fa_bwd_dq_call at :285): dq accumulated over
//                         the kv blocks of one q block;
//   flash_bwd_dkv_kernel  replaces _fa_bwd_dkv_kernel (:171, launched by
//                         _fa_bwd_dkv_call at :319): dk and dv of one kv
//                         block, accumulated over the q blocks and over
//                         the GQA group's query heads (the TPU kernel
//                         writes per-query-head partials that XLA sums).
//
// Layouts: q and dO (b, nh, tq, hd), k and v (b, nkv, tk, hd), each read
// through its (batch, head, time) strides with a contiguous head dim, so
// slices of the qkv projection go in uncopied; o, dq, dk and dv are
// written through strides the wrapper gives; lse and delta are
// contiguous (b, nh, tq) fp32.  Query head h reads KV head h / rep.
// Query row i sits at position i + offset and sees key j iff
// j <= i + offset and j < tk_valid.
//
// Numerics follow the TPU kernels: s = (q.k in fp32) * sm_scale; the
// forward's online softmax keeps (m, den, acc) per row in fp32, with both
// exps guarded where m or s is -inf; p is rounded to V's dtype for the PV
// product while den sums the unrounded p; o = acc / max(den, 1e-30); lse
// = m + log(den), or +inf for a row that saw no key, so its backward is
// zero.  The backward recomputes p = exp(s - lse), ds = p (dO.v - delta);
// dq sums round(ds).k, dv round(p)^T.dO, dk round(ds)^T.q, each product
// in fp32 from operands rounded to the input dtype (a bf16 product is
// exact in fp32).  dq and dk take sm_scale once at the end where the TPU
// kernels scale each block's product: the same function, rounded in a
// different place by at most an fp32 ulp.
//
// Design.  Blocks of 64 query rows and 64 keys.  One CTA of 256 threads
// (a 16 x 16 grid) per (q block, query head, batch) for the forward and
// dq, one per (kv block, KV head, batch) for dk/dv, looping over the
// group's rep query heads and the q blocks from the first that reaches
// the block's keys; no atomics, so every result is the same run to run.
// Tiles live in shared memory as fp32, rows padded to hd + 1 floats so
// that neither a row walk nor a column walk has bank conflicts; each
// thread holds a 4 x 4 tile of the 64 x 64 score block and a 4 x hd/16
// tile of its accumulators in registers (rows ty + 16 i, columns tx +
// 16 j), and the row statistics reduce over the 16 threads of a row with
// shuffles.  The products are CUDA-core fp32 FMAs.
//
// Bound on the H100.  At one attention layer of the hybrid-280m train
// step (b 32, t 1024, 12 query / 4 KV heads, hd 64, bf16) the forward does
// about 52 GFLOP of causal work against about 136 MB, dq about 77 GFLOP
// and dk/dv about 103 GFLOP against a few hundred MB: several hundred
// operations per byte, above the card's ~295 bf16 tensor-core operations
// per byte, so the least time is the operations over 989 TFLOP/s (about
// 0.05, 0.08 and 0.10 ms).  This first version runs on CUDA cores (67
// TFLOP/s fp32 peak, and the shared-memory operand reads halve that), so
// it stays one to two orders of magnitude above the bound; wgmma on bf16
// tiles with TMA loads comes later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kB = 64;         // query rows and keys per block
constexpr int kSp = kB + 1;    // padded row of a 64 x 64 score block

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

// round an fp32 value to T and back (the operand casts of the products)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

struct Params {
  const void *q, *k, *v, *dout;  // dout: the output cotangent (backward)
  const float *lse, *delta;      // (b, nh, tq); lse is written by the forward
  void* o;                       // forward: o; dq kernel: dq (fp32); dkv: dk (fp32)
  float* lse_out;                // forward only
  float* dv;                     // dkv kernel only
  int nh, nkv, tq, tk, offset, tk_valid;
  // (batch, head, time) strides in elements
  long long q_s[3], k_s[3], v_s[3], do_s[3], o_s[3], dv_s[3];
  float sm_scale;
};

// rows [r0, r0 + 64) of a (time, hd) slab at `base` into a padded fp32
// tile; rows at or past `rows` are zeros
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ base,
                                          long long st, int r0, int rows) {
  for (int e = threadIdx.x; e < kB * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    tile[r * (HD + 1) + d] = r0 + r < rows ? to_f<T>(base[(long long)(r0 + r) * st + d]) : 0.f;
  }
}

// max and sum over the 16 threads of one row (lanes that differ in tx)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// s[i][j] = A[ty + 16 i] . B[tx + 16 j] over hd, both padded fp32 tiles
template <int HD>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A, const float* B,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// acc[i][j] += sum_c W[ty + 16 i][c] * X[c][tx + 16 j]: W a padded 64 x 64
// block, X a padded (64, hd) tile
template <int HD>
__device__ __forceinline__ void tile_mma(float (&acc)[4][HD / 16], const float* W,
                                         const float* X, int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[(ty + 16 * i) * kSp + c];
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const float x = X[c * (HD + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(w[i], x, acc[i][j]);
    }
  }
}

template <int HD> __host__ __device__ constexpr int fwd_smem_floats() {
  return 3 * kB * (HD + 1) + kB * kSp;
}
template <int HD> __host__ __device__ constexpr int dq_smem_floats() {
  return 4 * kB * (HD + 1) + kB * kSp;
}
template <int HD> __host__ __device__ constexpr int dkv_smem_floats() {
  return 4 * kB * (HD + 1) + 2 * kB * kSp + 2 * kB;
}

// ---------------------------------------------------------------- forward
// grid (q blocks, nh, b)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kB * (HD + 1);
  float* Vs = Ks + kB * (HD + 1);
  float* Ps = Vs + kB * (HD + 1);
  const int q0 = blockIdx.x * kB, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (p.nh / p.nkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_s[0] + h * p.q_s[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.k_s[0] + g * p.k_s[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.v_s[0] + g * p.v_s[1];
  const int nr = min(kB, p.tq - q0);
  load_tile<T, HD>(Qs, q, p.q_s[2], q0, p.tq);

  float acc[4][HD / 16], m[4], den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    den[i] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }
  // keys past the block's last row position are fully future: skipped
  const int kend = min(min(p.tk_valid, p.tk), q0 + nr + p.offset);
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();  // the previous block's reads of Ks, Vs, Ps are done
    load_tile<T, HD>(Ks, k, p.k_s[2], k0, p.tk);
    load_tile<T, HD>(Vs, v, p.v_s[2], k0, p.tk);
    __syncthreads();
    float s[4][4];
    tile_dots<HD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + p.offset;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        s[i][j] = (kpos <= qpos && kpos < p.tk_valid) ? s[i][j] * p.sm_scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float sc = m[i] > -CUDART_INF_F ? expf(m[i] - m_new) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = s[i][j] > -CUDART_INF_F ? expf(s[i][j] - m_new) : 0.f;
        sum += pij;
        Ps[(ty + 16 * i) * kSp + tx + 16 * j] = rnd<T>(pij);
      }
      den[i] = den[i] * sc + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) acc[i][j] *= sc;
    }
    __syncthreads();
    tile_mma<HD>(acc, Ps, Vs, ty, tx);
  }

  T* o = static_cast<T*>(p.o) + bi * p.o_s[0] + h * p.o_s[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nr) continue;
    const float inv = 1.f / fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      o[(long long)(q0 + r) * p.o_s[2] + tx + 16 * j] = from_f<T>(acc[i][j] * inv);
    if (tx == 0)
      p.lse_out[((long long)bi * p.nh + h) * p.tq + q0 + r] =
          den[i] > 0.f ? m[i] + logf(fmaxf(den[i], 1e-30f)) : CUDART_INF_F;
  }
}

// --------------------------------------------------------------------- dq
// grid (q blocks, nh, b)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kB * (HD + 1);
  float* Ks = dOs + kB * (HD + 1);
  float* Vs = Ks + kB * (HD + 1);
  float* dSs = Vs + kB * (HD + 1);
  const int q0 = blockIdx.x * kB, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (p.nh / p.nkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* q = static_cast<const T*>(p.q) + bi * p.q_s[0] + h * p.q_s[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.do_s[0] + h * p.do_s[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.k_s[0] + g * p.k_s[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.v_s[0] + g * p.v_s[1];
  const int nr = min(kB, p.tq - q0);
  load_tile<T, HD>(Qs, q, p.q_s[2], q0, p.tq);
  load_tile<T, HD>(dOs, dout, p.do_s[2], q0, p.tq);
  const long long row0 = ((long long)bi * p.nh + h) * p.tq + q0;
  float lse[4], dlt[4], acc[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    lse[i] = r < nr ? p.lse[row0 + r] : CUDART_INF_F;
    dlt[i] = r < nr ? p.delta[row0 + r] : 0.f;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) acc[i][j] = 0.f;
  }
  const int kend = min(min(p.tk_valid, p.tk), q0 + nr + p.offset);
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();
    load_tile<T, HD>(Ks, k, p.k_s[2], k0, p.tk);
    load_tile<T, HD>(Vs, v, p.v_s[2], k0, p.tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<HD>(s, Qs, Ks, ty, tx);
    tile_dots<HD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i + p.offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        // a masked key, or a row with lse = +inf, gives p = 0
        const float pij = (kpos <= qpos && kpos < p.tk_valid)
                              ? expf(s[i][j] * p.sm_scale - lse[i]) : 0.f;
        dSs[(ty + 16 * i) * kSp + tx + 16 * j] = rnd<T>(pij * (dp[i][j] - dlt[i]));
      }
    }
    __syncthreads();
    tile_mma<HD>(acc, dSs, Ks, ty, tx);
  }
  float* dq = static_cast<float*>(p.o) + bi * p.o_s[0] + h * p.o_s[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j)
      dq[(long long)(q0 + r) * p.o_s[2] + tx + 16 * j] = acc[i][j] * p.sm_scale;
  }
}

// ------------------------------------------------------------------ dk, dv
// grid (kv blocks, nkv, b)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * (HD + 1);
  float* Qs = Vs + kB * (HD + 1);
  float* dOs = Qs + kB * (HD + 1);
  float* Pt = dOs + kB * (HD + 1);  // round(p)^T: (key, query row)
  float* dSt = Pt + kB * kSp;       // round(ds)^T
  float* lse_s = dSt + kB * kSp;
  float* dlt_s = lse_s + kB;
  const int k0 = blockIdx.x * kB, g = blockIdx.y, bi = blockIdx.z;
  const int rep = p.nh / p.nkv;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* k = static_cast<const T*>(p.k) + bi * p.k_s[0] + g * p.k_s[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.v_s[0] + g * p.v_s[1];
  load_tile<T, HD>(Ks, k, p.k_s[2], k0, p.tk);
  load_tile<T, HD>(Vs, v, p.v_s[2], k0, p.tk);
  float dk[4][HD / 16], dv[4][HD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  // the first query row that sees key k0 is k0 - offset; blocks before
  // the one holding it are fully future for every key of this block
  const int first = max(k0 - p.offset, 0);
  const int qstart = k0 < min(p.tk_valid, p.tk) ? first / kB * kB : p.tq;
  for (int e = 0; e < rep; ++e) {
    const int h = g * rep + e;
    const T* q = static_cast<const T*>(p.q) + bi * p.q_s[0] + h * p.q_s[1];
    const T* dout = static_cast<const T*>(p.dout) + bi * p.do_s[0] + h * p.do_s[1];
    const long long rows = ((long long)bi * p.nh + h) * p.tq;
    for (int q0 = qstart; q0 < p.tq; q0 += kB) {
      __syncthreads();  // the previous block's reads are done
      load_tile<T, HD>(Qs, q, p.q_s[2], q0, p.tq);
      load_tile<T, HD>(dOs, dout, p.do_s[2], q0, p.tq);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        lse_s[r] = q0 + r < p.tq ? p.lse[rows + q0 + r] : CUDART_INF_F;
        dlt_s[r] = q0 + r < p.tq ? p.delta[rows + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];  // transposed: (key ty + 16 i, query row tx + 16 j)
      tile_dots<HD>(s, Ks, Qs, ty, tx);
      tile_dots<HD>(dp, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qpos = q0 + r + p.offset;
          const float pij = (kpos <= qpos && kpos < p.tk_valid)
                                ? expf(s[i][j] * p.sm_scale - lse_s[r]) : 0.f;
          Pt[(ty + 16 * i) * kSp + r] = rnd<T>(pij);
          dSt[(ty + 16 * i) * kSp + r] = rnd<T>(pij * (dp[i][j] - dlt_s[r]));
        }
      }
      __syncthreads();
      tile_mma<HD>(dv, Pt, dOs, ty, tx);
      tile_mma<HD>(dk, dSt, Qs, ty, tx);
    }
  }
  float* dko = static_cast<float*>(p.o) + bi * p.o_s[0] + g * p.o_s[1];
  float* dvo = p.dv + bi * p.dv_s[0] + g * p.dv_s[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= p.tk) continue;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      dko[(long long)c * p.o_s[2] + tx + 16 * j] = dk[i][j] * p.sm_scale;
      dvo[(long long)c * p.dv_s[2] + tx + 16 * j] = dv[i][j];
    }
  }
}

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int smem_floats, const Params& p, cudaStream_t stream) {
  const int smem = smem_floats * int(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int HD>
cudaError_t dispatch(Which which, const Params& p, int b, cudaStream_t s) {
  const dim3 qgrid((p.tq + kB - 1) / kB, p.nh, b), kgrid((p.tk + kB - 1) / kB, p.nkv, b);
  switch (which) {
    case kFwd: return launch(flash_fwd_kernel<T, HD>, qgrid, fwd_smem_floats<HD>(), p, s);
    case kDq: return launch(flash_bwd_dq_kernel<T, HD>, qgrid, dq_smem_floats<HD>(), p, s);
    default: return launch(flash_bwd_dkv_kernel<T, HD>, kgrid, dkv_smem_floats<HD>(), p, s);
  }
}

template <typename T>
cudaError_t by_head_dim(Which which, const Params& p, int b, int hd, cudaStream_t s) {
  switch (hd) {
    case 32: return dispatch<T, 32>(which, p, b, s);
    case 64: return dispatch<T, 64>(which, p, b, s);
    case 128: return dispatch<T, 128>(which, p, b, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(Which which, Params& p, int b, int hd, int dtype, void* stream) {
  if (b < 1 || p.nkv < 1 || p.nh % p.nkv != 0 || p.tq < 1 || p.tk < 1 || b > 65535 ||
      p.nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(dtype == 1 ? by_head_dim<__nv_bfloat16>(which, p, b, hd, s)
                          : by_head_dim<float>(which, p, b, hd, s));
}

void set3(long long (&dst)[3], const long long* src) {
  for (int i = 0; i < 3; ++i) dst[i] = src[i];
}

}  // namespace

// The head dims the library is built for; the wrapper checks first.
extern "C" int mdt_flash_supports(int hd) { return hd == 32 || hd == 64 || hd == 128; }

// Each returns a cudaError_t (0 on success).  dtype: 0 = float32,
// 1 = bfloat16.  Every *_s argument points at three (batch, head, time)
// strides in elements.
extern "C" int mdt_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                             int b, int nh, int nkv, int tq, int tk, int hd, int offset,
                             int tk_valid, const long long* q_s, const long long* k_s,
                             const long long* v_s, const long long* o_s, float sm_scale,
                             int dtype, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse_out = lse;
  p.nh = nh; p.nkv = nkv; p.tq = tq; p.tk = tk; p.offset = offset; p.tk_valid = tk_valid;
  set3(p.q_s, q_s); set3(p.k_s, k_s); set3(p.v_s, v_s); set3(p.o_s, o_s);
  p.sm_scale = sm_scale;
  return run(kFwd, p, b, hd, dtype, stream);
}

extern "C" int mdt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, float* dq, int b, int nh,
                                int nkv, int tq, int tk, int hd, int offset, int tk_valid,
                                const long long* q_s, const long long* k_s,
                                const long long* v_s, const long long* do_s,
                                const long long* dq_s, float sm_scale, int dtype,
                                void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta; p.o = dq;
  p.nh = nh; p.nkv = nkv; p.tq = tq; p.tk = tk; p.offset = offset; p.tk_valid = tk_valid;
  set3(p.q_s, q_s); set3(p.k_s, k_s); set3(p.v_s, v_s); set3(p.do_s, do_s);
  set3(p.o_s, dq_s);
  p.sm_scale = sm_scale;
  return run(kDq, p, b, hd, dtype, stream);
}

extern "C" int mdt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const float* lse, const float* delta, float* dk, float* dv,
                                 int b, int nh, int nkv, int tq, int tk, int hd, int offset,
                                 int tk_valid, const long long* q_s, const long long* k_s,
                                 const long long* v_s, const long long* do_s,
                                 const long long* dk_s, const long long* dv_s, float sm_scale,
                                 int dtype, void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse; p.delta = delta; p.o = dk; p.dv = dv;
  p.nh = nh; p.nkv = nkv; p.tq = tq; p.tk = tk; p.offset = offset; p.tk_valid = tk_valid;
  set3(p.q_s, q_s); set3(p.k_s, k_s); set3(p.v_s, v_s); set3(p.do_s, do_s);
  set3(p.o_s, dk_s); set3(p.dv_s, dv_s);
  p.sm_scale = sm_scale;
  return run(kDkv, p, b, hd, dtype, stream);
}
