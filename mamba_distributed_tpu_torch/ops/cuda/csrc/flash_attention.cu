// Causal GQA flash attention, forward and backward, hand-written for Hopper
// (sm_90a): three kernels, the counterparts of the TPU kernels of
// mamba_distributed_tpu/ops/pallas/attention_kernels.py:
//
//   forward   flash_fwd_tc_kernel (bf16) and flash_fwd_kernel (fp32)
//             replace _fa_fwd_kernel (:65, launched by _fa_fwd_impl at
//             :240): o and the row log-sum-exp, online softmax over kv
//             blocks, fully-future blocks skipped;
//   dq        flash_bwd_dq_kernel (both dtypes) replaces
//             _fa_bwd_dq_kernel (:127, launched by _fa_bwd_dq_call at
//             :285): dq accumulated over the kv blocks of one q block;
//   dk/dv     flash_bwd_dkv_tc_kernel (bf16) and flash_bwd_dkv_kernel
//             (fp32) replace _fa_bwd_dkv_kernel (:171, launched by
//             _fa_bwd_dkv_call at :319): dk and dv of one kv block,
//             accumulated over the q blocks and over the GQA group's
//             query heads (the TPU kernel writes per-query-head partials
//             that XLA sums).
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
// different place by at most an fp32 ulp.  No kernel uses atomics, so
// every result is the same bit for bit from run to run.
//
// Two designs:
//
// * Tensor cores: the bf16 forward (flash_fwd_tc_kernel) and dk/dv
//   (flash_bwd_dkv_tc_kernel).  A CTA is one consumer warpgroup (64 rows:
//   query rows for the forward, keys for dk/dv) and one producer warp.
//   Q, K, V and dO stay bf16 in shared memory, in the swizzled layout
//   that both TMA and the wgmma descriptors use (128-byte swizzle for hd
//   64 and 128, as 64-column panels; 64-byte for hd 32).  The producer's
//   lane 0 issues TMA copies over 4-D tensor maps (hd, time, head, batch)
//   built per call on the host, so strided views go in as they are and
//   rows past tq or tk arrive as zeros (the mask still decides which keys
//   count).  Tiles stream through a two-stage ring of mbarriers (full:
//   TMA bytes landed; empty: the warpgroup's products are done), so the
//   next tile's copy is in flight during this tile's math.  The forward
//   streams K/V tiles of 64 keys: S = Q K^T is a wgmma with both operands
//   in shared memory (K-major); the fp32 S fragment is masked only on
//   tiles that straddle the diagonal or tk_valid; the online softmax
//   runs in registers, a row's statistics reduced over the 4 lanes that
//   hold it; P is rounded to bf16 in place as the register A-operand of
//   O += P V (V MN-major, the transpose bit set).  dk/dv keeps K and V
//   resident and streams (Q, dO, lse, delta) tiles of 64 query rows (32
//   at hd 128, to stay inside 255 registers): S^T = K Q^T and dP^T =
//   V dO^T in shared memory, P^T and dS^T in registers, then dV +=
//   round(P^T) dO and dK += round(dS^T) Q with the rounded fragments as
//   register A-operands; P and dS never touch shared memory.  64-row
//   forward tiles keep a batch-1, 512-token prefill at 96 CTAs on 132
//   SMs; several CTAs share an SM, so one CTA's softmax overlaps
//   another's products.
// * CUDA cores: the fp32 forward and dk/dv (fp32 on the tensor cores
//   would be TF32, which the fp32 checks do not allow), and dq in both
//   dtypes.  Blocks of 64 query rows and 64 keys, one CTA of 256
//   threads (a 16 x 16 grid) per (q block, query head, batch) for the
//   forward and dq, one per (kv block, KV head, batch) for dk/dv.  Tiles
//   live in shared memory as fp32, rows padded to hd + 1 floats; each
//   thread holds a 4 x 4 tile of the 64 x 64 score block and a 4 x hd/16
//   tile of its accumulators; the products are fp32 FMAs.
//
// Bound on the H100.  At one attention layer of the hybrid-280m train
// step (b 32, t 1024, 12 query / 4 KV heads, hd 64, bf16) the forward does
// about 52 GFLOP of causal work against about 136 MB, dq about 77 GFLOP
// and dk/dv about 103 GFLOP against a few hundred MB: several hundred
// operations per byte, above the card's ~295 bf16 tensor-core operations
// per byte, so the least time is the operations over 989 TFLOP/s (about
// 0.05, 0.08 and 0.10 ms).  On an H100 at 700 W the tensor-core forward
// and dk/dv reach about 14% and 16% of that bound (0.37 and 0.64 ms,
// PERF.md): besides the products, every score costs an exp and about
// fifteen other instructions in the softmax, and each 64-row tile reads
// its K/V (or Q/dO) tiles from L2 on its own.  Overlapping a tile's
// softmax with the next tile's S inside the warpgroup did not help (the
// extra registers cost a resident CTA, and other CTAs on the SM already
// fill that wait).  Left for later: a second consumer warpgroup sharing
// the K/V tiles, fewer instructions per score, and dq, which still runs
// on CUDA cores (67 TFLOP/s fp32 peak, halved by the shared-memory
// operand reads), one to two orders of magnitude above its bound; it is
// the next to move to these tiles and this ring.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

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

// ----------------------------------------------------- forward, fp32
// grid (q blocks, nh, b)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_fwd_tc_kernel");
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

// ------------------------------------------------------- dk, dv, fp32
// grid (kv blocks, nkv, b)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  static_assert(std::is_same<T, float>::value, "bf16 runs flash_bwd_dkv_tc_kernel");
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

// ============================================= tensor-core kernels (bf16)
//
// Shared memory holds bf16 tiles in the swizzled layout that wgmma
// descriptors read and that TMA writes: a tile of R rows and HD columns is
// HD / PW panels of R rows x PW columns (PW = 64, a 128-byte row with the
// 128-byte swizzle, for hd 64 and 128; PW = 32, a 64-byte row with the
// 64-byte swizzle, for hd 32), each panel 1024-byte aligned.

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive once and expect `bytes` more from TMA copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// failed polls after which a wait traps: a failed try_wait may suspend
// the thread up to a system-dependent time limit, and even at a few tens
// of cycles a poll 2^26 polls last about a second, far longer than any
// healthy wait (a tile's TMA load or math, microseconds); a preempted
// thread does not poll, so time slicing of the card cannot trip it
constexpr uint32_t kMaxFailedPolls = 1u << 26;

// wait until the phase of parity `parity` has completed; a wait that
// outlasts kMaxFailedPolls polls can only be a broken protocol, and traps
// (the launch fails) rather than holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == kMaxFailedPolls) __trap();
  }
}

// one TMA copy of the box at (column c0, time c1, head c2, batch c3) of a
// 4-D map into shared memory; rows past the tensor's end arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma operand
// registers across the asynchronous product
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R> __device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets in 16-byte units, swizzle mode (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo & 0x3FFF) << 16) |
         (uint64_t(sbo & 0x3FFF) << 32) | (uint64_t(mode) << 62);
}

// geometry of a swizzled bf16 tile of ROWS rows and HD columns
template <int HD, int ROWS> struct Tile {
  static constexpr int PW = HD < 64 ? HD : 64;  // columns per panel
  static constexpr int NP = HD / PW;            // panels
  static constexpr int ROW_B = PW * 2;          // bytes of a panel row = the swizzle span
  static constexpr int PANEL_B = ROWS * ROW_B;
  static constexpr int BYTES = NP * PANEL_B;
  static constexpr uint32_t MODE = ROW_B == 128 ? 1 : 2;
  static constexpr uint32_t SBO = 8 * ROW_B / 16;  // next group of 8 rows
  static_assert(PANEL_B % 1024 == 0, "panels must stay 1024-byte aligned");
  // the tile as a K-major operand (hd is the reduction): k-step kk reads
  // columns [16 kk, 16 kk + 16) of every row
  __device__ static uint64_t kmajor(uint32_t base, int kk) {
    const int col = 16 * kk;
    return gmma_desc(base + (col / PW) * PANEL_B + (col % PW) * 2, 1, SBO, MODE);
  }
  // the tile as an MN-major operand (its rows are the reduction, hd the
  // output columns): k-step kk reads rows [16 kk, 16 kk + 16); the panels
  // are the 64-column (or 32-column) atoms along hd, PANEL_B apart
  __device__ static uint64_t mnmajor(uint32_t base, int kk) {
    return gmma_desc(base + 16 * kk * ROW_B, PANEL_B / 16, SBO, MODE);
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// the fp32 accumulator of a 64 x N product, rounded to bf16 in place as the
// register A-operand of the next product (K = N): k-step kk takes columns
// [16 kk, 16 kk + 16), in the fragment order wgmma reads
template <int N>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[N / 16][4], const float (&d)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = pack_bf16(d[8 * kk + 2 * x], d[8 * kk + 2 * x + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// D (64 x N, fp32) += A B, A and B both in shared memory, both K-major
template <int N> __device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db);
template <> __device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, "
      "0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x N, fp32) += A B, A in registers (bf16 fragments), B in shared
// memory MN-major (the transpose bit set)
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);
template <> __device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4],
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, "
      "%19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4],
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
      "1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4],
                                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

constexpr int kWgRows = 64;              // rows of one warpgroup's wgmma tile
constexpr int kStages = 2;               // depth of the TMA ring
constexpr int kTcThreads = 128 + 32;     // one consumer warpgroup + one producer warp
// dk/dv: query rows per streamed tile (the dK, dV, S^T and dP^T fragments
// of hd 128 would not fit 255 registers at 64)
template <int HD> constexpr int dkv_q_rows() { return HD == 128 ? 32 : 64; }

struct TmaMaps {
  CUtensorMap q, k, v, dout;
};

template <int HD> struct FwdLayout {
  using QT = Tile<HD, kWgRows>;
  using KT = Tile<HD, kWgRows>;
  static constexpr int KV = QT::BYTES;                      // stage s: K, then V
  static constexpr int BARS = KV + kStages * 2 * KT::BYTES;  // q_full, kv_full[], kv_empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// ---------------------------------------------------- forward, tensor cores
// grid (q blocks, nh, b); 64 query rows per CTA (the last block first, as
// it has the most keys).  The producer warp's lane 0 copies Q once and K, V
// tiles of 64 keys through a two-stage ring; the consumer warpgroup runs
// S = Q K^T (both operands in shared memory, K-major), the masked online
// softmax in registers, then O += round(P) V (P the register A-operand, V
// MN-major), releasing the stage when both products are done.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc_kernel(const __grid_constant__ TmaMaps maps, const Params p) {
  using L = FwdLayout<HD>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + L::KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgRows, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (p.nh / p.nkv);
  const int nr = min(kWgRows, p.tq - q0);
  // keys past the block's last row position are fully future: skipped
  const int kend = min(min(p.tk_valid, p.tk), q0 + nr + p.offset);
  const int ntiles = kend > 0 ? (kend + kWgRows - 1) / kWgRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full + s, 1);
      mbar_init(kv_empty + s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128 && ntiles > 0) {
      mbar_expect_tx(q_full, QT::BYTES);
      for (int c = 0; c < QT::NP; ++c)
        tma_load(Qs + c * QT::PANEL_B, &maps.q, q_full, c * QT::PW, q0, h, bi);
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % kStages;
        if (n >= kStages) mbar_wait(kv_empty + s, (n / kStages - 1) & 1);
        uint8_t* Ks = KVs + s * 2 * KT::BYTES;
        mbar_expect_tx(kv_full + s, 2 * KT::BYTES);
        for (int c = 0; c < KT::NP; ++c) {
          tma_load(Ks + c * KT::PANEL_B, &maps.k, kv_full + s, c * KT::PW, n * kWgRows, g, bi);
          tma_load(Ks + KT::BYTES + c * KT::PANEL_B, &maps.v, kv_full + s, c * KT::PW,
                   n * kWgRows, g, bi);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r0 and r0 + 8 of the tile,
  // columns 8 j + 2 (lane % 4) + {0, 1} of each 8-column block j
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c0 = 2 * (lane % 4);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, den[2] = {0.f, 0.f};
  if (ntiles > 0) mbar_wait(q_full, 0);
  const uint32_t q_addr = smem_u32(Qs);
  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kStages, k0 = n * kWgRows;
    mbar_wait(kv_full + s, (n / kStages) & 1);
    __syncwarp();
    const uint32_t k_addr = smem_u32(KVs + s * 2 * KT::BYTES), v_addr = k_addr + KT::BYTES;
    float sc[kWgRows / 2];
#pragma unroll
    for (int i = 0; i < kWgRows / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<kWgRows>(sc, QT::kmajor(q_addr, kk), KT::kmajor(k_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    // s = (q.k) * sm_scale; only tiles that straddle the diagonal or
    // tk_valid are masked
    const bool full = k0 + kWgRows - 1 <= q0 + p.offset && k0 + kWgRows <= p.tk_valid;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int r = 0; r < kWgRows / 2; ++r) {
      const int i = (r / 2) % 2;
      float v = sc[r] * p.sm_scale;
      if (!full) {
        const int qpos = q0 + r0 + 8 * i + p.offset;
        const int kpos = k0 + 8 * (r / 4) + c0 + r % 2;
        if (!(kpos <= qpos && kpos < p.tk_valid)) v = -CUDART_INF_F;
      }
      sc[r] = v;
      mx[i] = fmaxf(mx[i], v);
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = m[i] > -CUDART_INF_F ? expf(m[i] - m_new) : 0.f;
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kWgRows / 2; ++r) {
      const int i = (r / 2) % 2;
      const float pij = sc[r] > -CUDART_INF_F ? expf(sc[r] - m[i]) : 0.f;
      sum[i] += pij;  // den sums the unrounded p
      sc[r] = pij;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) den[i] = den[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int r = 0; r < HD / 2; ++r) acc[r] *= alpha[(r / 2) % 2];
    uint32_t pa[kWgRows / 16][4];
    to_a_frags<kWgRows>(pa, sc);  // p rounded to V's dtype

    fence_regs(acc);
    fence_regs(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) wgmma_rs<HD>(acc, pa[kk], KT::mnmajor(v_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(kv_empty + s);
  }

  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_s[0] + h * p.o_s[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= nr) continue;
    const float inv = 1.f / fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + (long long)(q0 + r) * p.o_s[2] + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
    if (lane % 4 == 0)
      p.lse_out[((long long)bi * p.nh + h) * p.tq + q0 + r] =
          den[i] > 0.f ? m[i] + logf(fmaxf(den[i], 1e-30f)) : CUDART_INF_F;
  }
}

template <int HD> struct DkvLayout {
  static constexpr int BQ = dkv_q_rows<HD>();
  using KT = Tile<HD, kWgRows>;
  using QT = Tile<HD, BQ>;
  static constexpr int V = KT::BYTES;
  static constexpr int STAGES = 2 * KT::BYTES;  // stage s: Q, then dO
  static constexpr int ROWS = STAGES + kStages * 2 * QT::BYTES;  // lse[s][BQ], delta[s][BQ]
  static constexpr int BARS = ROWS + 2 * kStages * BQ * 4;       // kv_full, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * kStages) + 1024;
};

// ------------------------------------------------ dk, dv, tensor cores
// grid (kv blocks of 64 keys, nkv, b).  K and V stay in shared memory;
// the producer warp streams Q, dO and their lse/delta rows, for each of
// the group's query heads and each q tile from the first that reaches the
// block's keys, through a two-stage ring.  Per tile the consumer
// warpgroup runs S^T = K Q^T and dP^T = V dO^T (shared-memory operands,
// K-major), P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) in
// registers, then dV += round(P^T) dO and dK += round(dS^T) Q (register
// A-operands, dO and Q MN-major); dK takes sm_scale once at the end.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ TmaMaps maps, const Params p) {
  using L = DkvLayout<HD>;
  using KT = typename L::KT;
  using QT = typename L::QT;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Ks = smem;
  uint8_t* Vs = smem + L::V;
  uint8_t* stages = smem + L::STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::ROWS);
  float* dlt_s = lse_s + kStages * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kWgRows, g = blockIdx.y, bi = blockIdx.z;
  const int rep = p.nh / p.nkv;
  // the first query row that sees key k0 is k0 - offset; tiles before the
  // one holding it are fully future for every key of this block
  const int first = max(k0 - p.offset, 0);
  const int qstart = k0 < min(p.tk_valid, p.tk) ? first / BQ * BQ : p.tq;
  const int nq = qstart < p.tq ? (p.tq - qstart + BQ - 1) / BQ : 0;
  const int items = rep * nq;  // (query head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 32);
      mbar_init(empty + s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp: lane 0 copies, all 32 fill the rows
    const int lane = threadIdx.x - 128;
    if (items == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * KT::BYTES);
      for (int c = 0; c < KT::NP; ++c) {
        tma_load(Ks + c * KT::PANEL_B, &maps.k, kv_full, c * KT::PW, k0, g, bi);
        tma_load(Vs + c * KT::PANEL_B, &maps.v, kv_full, c * KT::PW, k0, g, bi);
      }
    }
    for (int u = 0; u < items; ++u) {
      const int s = u % kStages, h = g * rep + u / nq, q0 = qstart + (u % nq) * BQ;
      if (u >= kStages) mbar_wait(empty + s, (u / kStages - 1) & 1);
      const long long rows = ((long long)bi * p.nh + h) * p.tq;
      for (int r = lane; r < BQ; r += 32) {
        const bool in = q0 + r < p.tq;
        lse_s[s * BQ + r] = in ? p.lse[rows + q0 + r] : CUDART_INF_F;  // p = 0 past tq
        dlt_s[s * BQ + r] = in ? p.delta[rows + q0 + r] : 0.f;
      }
      if (lane == 0) {
        uint8_t* Qs = stages + s * 2 * QT::BYTES;
        mbar_expect_tx(full + s, 2 * QT::BYTES);
        for (int c = 0; c < QT::NP; ++c) {
          tma_load(Qs + c * QT::PANEL_B, &maps.q, full + s, c * QT::PW, q0, h, bi);
          tma_load(Qs + QT::BYTES + c * QT::PANEL_B, &maps.dout, full + s, c * QT::PW, q0, h, bi);
        }
      } else {
        mbar_arrive(full + s);
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds keys k0 + r0 and k0 + r0 + 8,
  // query columns 8 j + c0 + {0, 1} of each 8-column block j
  const int lane = threadIdx.x % 32;
  const int r0 = 16 * (threadIdx.x / 32) + lane / 4, c0 = 2 * (lane % 4);
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  if (items > 0) mbar_wait(kv_full, 0);
  const uint32_t k_addr = smem_u32(Ks), v_addr = smem_u32(Vs);
  for (int u = 0; u < items; ++u) {
    const int s = u % kStages, q0 = qstart + (u % nq) * BQ;
    mbar_wait(full + s, (u / kStages) & 1);
    __syncwarp();
    const uint32_t q_addr = smem_u32(stages + s * 2 * QT::BYTES), do_addr = q_addr + QT::BYTES;
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BQ>(st, KT::kmajor(k_addr, kk), QT::kmajor(q_addr, kk));
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<BQ>(dpt, KT::kmajor(v_addr, kk), QT::kmajor(do_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(st);
    fence_regs(dpt);

    const bool full_tile = k0 + kWgRows - 1 <= q0 + p.offset && k0 + kWgRows <= p.tk_valid;
    const float* lse = lse_s + s * BQ;
    const float* dlt = dlt_s + s * BQ;
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) {
      const int col = 8 * (r / 4) + c0 + r % 2;
      bool keep = true;
      if (!full_tile) {
        const int kpos = k0 + r0 + 8 * ((r / 2) % 2);
        keep = kpos <= q0 + col + p.offset && kpos < p.tk_valid;
      }
      // a masked key, or a row with lse = +inf, gives p = 0
      const float pij = keep ? expf(st[r] * p.sm_scale - lse[col]) : 0.f;
      st[r] = pij;
      dpt[r] = pij * (dpt[r] - dlt[col]);
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_a_frags<BQ>(pa, st);
    to_a_frags<BQ>(da, dpt);

    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<HD>(dv, pa[kk], QT::mnmajor(do_addr, kk));
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) wgmma_rs<HD>(dk, da[kk], QT::mnmajor(q_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(empty + s);
  }

  float* dko = static_cast<float*>(p.o) + bi * p.o_s[0] + g * p.o_s[1];
  float* dvo = p.dv + bi * p.dv_s[0] + g * p.dv_s[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = k0 + r0 + 8 * i;
    if (c >= p.tk) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(dko + (long long)c * p.o_s[2] + 8 * j + c0) =
          make_float2(dk[4 * j + 2 * i] * p.sm_scale, dk[4 * j + 2 * i + 1] * p.sm_scale);
      *reinterpret_cast<float2*>(dvo + (long long)c * p.dv_s[2] + 8 * j + c0) =
          make_float2(dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// --------------------------------------------------- host side of the TMA
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that
// the library needs no link against libcuda
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(ptr)
               : nullptr;
  }();
  return fn;
}

// a 4-D map (hd, time, head, batch) over a bf16 tensor read through its
// (batch, head, time) element strides `st`, boxes of (pw, rows, 1, 1);
// a dimension of extent 1 is never stepped, so its stride is replaced by
// a legal one
bool make_map(CUtensorMap* map, const void* base, int hd, int t, int heads, int b,
              const long long* st, int pw, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(hd), cuuint64_t(t), cuuint64_t(heads), cuuint64_t(b)};
  cuuint64_t strides[3] = {cuuint64_t(st[2]) * 2, cuuint64_t(st[1]) * 2, cuuint64_t(st[0]) * 2};
  cuuint64_t widest = cuuint64_t(hd) * 2;
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] > 1 && strides[i] > widest) widest = strides[i];
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = widest;
  const cuuint32_t box[4] = {cuuint32_t(pw), cuuint32_t(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t launch_tc(K kernel, dim3 grid, int smem, const TmaMaps& maps, const Params& p,
                      cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kTcThreads, smem, stream>>>(maps, p);
  return cudaGetLastError();
}

template <int HD> cudaError_t fwd_tc(const Params& p, int b, cudaStream_t s) {
  using QT = typename FwdLayout<HD>::QT;
  TmaMaps maps{};
  if (!make_map(&maps.q, p.q, HD, p.tq, p.nh, b, p.q_s, QT::PW, kWgRows) ||
      !make_map(&maps.k, p.k, HD, p.tk, p.nkv, b, p.k_s, QT::PW, kWgRows) ||
      !make_map(&maps.v, p.v, HD, p.tk, p.nkv, b, p.v_s, QT::PW, kWgRows))
    return cudaErrorInvalidValue;
  const dim3 grid((p.tq + kWgRows - 1) / kWgRows, p.nh, b);
  return launch_tc(flash_fwd_tc_kernel<HD>, grid, FwdLayout<HD>::BYTES, maps, p, s);
}

template <int HD> cudaError_t dkv_tc(const Params& p, int b, cudaStream_t s) {
  using L = DkvLayout<HD>;
  TmaMaps maps{};
  if (!make_map(&maps.q, p.q, HD, p.tq, p.nh, b, p.q_s, L::QT::PW, L::BQ) ||
      !make_map(&maps.dout, p.dout, HD, p.tq, p.nh, b, p.do_s, L::QT::PW, L::BQ) ||
      !make_map(&maps.k, p.k, HD, p.tk, p.nkv, b, p.k_s, L::KT::PW, kWgRows) ||
      !make_map(&maps.v, p.v, HD, p.tk, p.nkv, b, p.v_s, L::KT::PW, kWgRows))
    return cudaErrorInvalidValue;
  const dim3 grid((p.tk + kWgRows - 1) / kWgRows, p.nkv, b);
  return launch_tc(flash_bwd_dkv_tc_kernel<HD>, grid, L::BYTES, maps, p, s);
}

// ------------------------------------------------------------- dispatch

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
  if (which == kDq) return launch(flash_bwd_dq_kernel<T, HD>, qgrid, dq_smem_floats<HD>(), p, s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return which == kFwd ? fwd_tc<HD>(p, b, s) : dkv_tc<HD>(p, b, s);
  } else {
    return which == kFwd ? launch(flash_fwd_kernel<T, HD>, qgrid, fwd_smem_floats<HD>(), p, s)
                         : launch(flash_bwd_dkv_kernel<T, HD>, kgrid, dkv_smem_floats<HD>(), p, s);
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
