// Ragged paged attention over the head-major KV page pool, hand-written for
// Hopper (sm_90a): the decode step (rpa_fwd) and the fused chunk write +
// chunk prefill (rpp_fwd), whose attend runs on the tensor cores for bf16
// q (rpp_attend_tc_kernel) and on CUDA cores otherwise.
//
// rpa_fwd replaces the TPU kernel _rpa_kernel
// (mamba_distributed_tpu/ops/pallas/attention_kernels.py:525, launched by
// ragged_paged_decode_attention at :675); rpp_fwd replaces _rpp_kernel
// (:722, launched by ragged_paged_prefill_attention at :969).  Both take
// bf16 or fp32 pages in q's dtype, or int8 pages with one fp32 scale per
// (physical page, KV head): the int8 branches of the TPU kernels (:538-541,
// :561-575, :587-598 and :738-741, :782-808, :826-827).
//
// Layouts (the JAX package's): pages (P, nkv, pg, hd), page 0 the trash
// page; page_table (b, W) int32; per-row lengths int32.  Query head
// g * rep + e reads KV head g (rep = nh / nkv).
//
// Decode, per (slot s, KV head g): the rep query rows attend keys
// [0, kv_len[s]) read through page_table[s, j] for j < ceil(kv_len / pg).
// Prefill, per row r with pad = c - chunk_real[r], ln = lengths[r] and
// total = ln + chunk_real[r]: chunk row i >= pad is written to absolute
// position ln + i - pad, then query i (position max(ln + i - pad, 0))
// attends keys kpos <= qpos with kpos < total, as the pool holds them
// after the write.  A page written by one CTA must not be read by another
// in the same launch, so the write and the attend are two kernels, launched
// in that order on one stream.  The write touches only the pages the row's
// table names for its real tokens (never page 0, never another row's page:
// row tables are disjoint by the allocator's invariant).
//
// Numerics follow the TPU kernels: scores q.k^T * (1/sqrt(hd)) in fp32;
// online softmax (m, den, acc) in fp32, with the exp and the rescale
// guarded where m = -inf; p rounded to V's dtype before the PV product;
// out = acc / max(den, 1e-30), so a row with nothing to read emits zeros.
// Products of two bf16 values are exact in fp32, so a bf16 result differs
// from the plain PyTorch version only by summation order.
//
// Int8 pages (q, the chunk K/V and the output stay bf16 or fp32):
//   decode   score = dot(q, k_int8) * (ks[phys, g] * sm_scale), the scalar
//            product first (:565-570); each block's PV product is
//            multiplied by vs[phys, g] before it joins the rescaled
//            accumulator (:588-593); p is NOT rounded (fp32 throughout).
//   prefill  the write rewrites EVERY row of each write-window page (a page
//            j with j*pg + pg > ln, j*pg < total, chunk_real > 0): a row at
//            ln <= kpos < total gets kv_quantize(fresh row, ksn) =
//            clip(rint(x / ksn), +-127); any other row gets kv_requant(old,
//            r) = clip(rint(old * r), +-127), r = (ln > j*pg) ? kso / ksn :
//            0, which wipes a recycled page's stale rows.  One CTA owns a
//            page and a thread reads each element before it writes it.  The
//            CUDA-core attend reads the written pages dequantized as q8 *
//            ksn (and * vsn), with q in fp32 and p NOT rounded; the
//            tensor-core attend scales the tile instead (see Design).  The
//            new scales (ksn, vsn) are planned outside
//            (models/attention._chunk_page_scales); the kernels only read
//            the four scale arrays.
//   Rounding is rintf (half to even, as torch.round and jnp.round), division
//   is IEEE `/` (this file is built without fast math), so the written pages
//   and scales are bit-identical to the plain version's.
//
// Design.  The decode, the write kernels and the CUDA-core attend: one CTA
// of 256 threads per (slot, KV head) for decode, per (row, KV head, tile of
// 64 query rows) for the prefill attend (query rows are the (chunk
// position, GQA rep) pairs in the TPU kernel's order i * rep + e).  The
// page walk reads keys in blocks of at most 64 tokens that never cross a
// page; each block's K and V land in shared memory as fp32 (rows padded to
// hd + 1 floats, so neither the score nor the PV loop has bank conflicts),
// and the walk stops at the tile's own largest query position.  Scores,
// row statistics and the accumulator stay in shared memory; the products
// are CUDA-core fp32 FMAs.
//
// The tensor-core attend (rpp_attend_tc_kernel, bf16 q with bf16 or int8
// pages) keeps that grid and walk and takes the design of
// flash_attention.cu's bf16 forward (hopper.cuh): one consumer warpgroup
// of 64 query rows and one producer warp per CTA.  The consumers gather
// the Q tile once through q's strides into the swizzled bf16 layout (with
// rep = 3 a 64-row tile is no TMA box).  The producer's lane 0 reads the
// row's page table and copies each 64-key tile by TMA over a 4-D map of
// the pool (hd, pg, nkv, P) at (0, t0, g, page_table[r, j]): the
// indirection becomes the copy's coordinate, and pages a multiple of 64
// tokens keep every tile inside one page.  Tiles stream through a
// two-stage mbarrier ring; S = Q K^T from shared memory, the online
// softmax in registers, O += round(P) V with P the register A-operand.
// Int8 pages land as rows of codes that the consumer warpgroup converts
// into a bf16 tile of the ring before it releases the stage (codes of
// magnitude <= 127 are exact in bf16); the consumers do it because they
// would otherwise wait for the tile, and the producer stays one lane that
// only issues copies.  A tile never crosses a page, so one k_scale_new *
// sm_scale multiplies the tile's fp32 scores and one v_scale_new is
// folded into P before P is rounded to bf16.  The plain version and the
// CUDA-core int8 attend keep that p in fp32; rounding p * v_scale to bf16
// moves each PV term by at most 2^-9 relative, inside the bf16 tolerance
// of 3e-2.  The rule between the two attends is the one of uses_tc().
//
// Bound on the H100.  Decode reads each live K/V token once (2 * nkv * hd
// elements) for 4 * nh * hd operations: about 3 operations per byte in
// bf16, far below the card's ~295, so the least time is the live pages'
// bytes over 3.35 TB/s.  An int8 decode reads 2 * live_tokens * nkv * hd
// bytes of pages, half the bf16 bytes, plus 2 * live_pages * nkv * 4
// bytes of scales: about 6 operations per byte, still bytes-bound.  A
// 256-token prefill chunk at hybrid-280m does about 4 * nh * hd *
// sum(qpos + 1) operations (0.25 GFLOP after 188 tokens) against the
// pages it reads: a few hundred operations per byte, near the ridge, and
// under a microsecond either way.  What is left is latency: a batch-1
// chunk is 48 attend CTAs on 132 SMs, each a walk of at most 7 tiles, and
// the write kernel before it (PERF.md: about 0.02 ms of device time a
// call in bf16, 0.04 in int8, against 0.21-0.23 on CUDA cores).  The
// decode uses no tensor cores, and one CTA per (slot, KV head) walks
// every page of a decode row alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // query rows per prefill CTA
constexpr int kKeys = 64;      // keys per block of the page walk
constexpr int kMaxHeadDim = 128;
constexpr int kMaxRep = 64;    // query heads per KV head (decode rows per CTA)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t v) {
  return static_cast<float>(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

// round an fp32 value to T and back (p is rounded to V's dtype for PV)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// ops/quant.py's kv_quantize and kv_requant: rint (half to even), IEEE
// division, clip to +-127
__device__ __forceinline__ float clip_q8(float v) { return fminf(fmaxf(v, -127.f), 127.f); }
__device__ __forceinline__ int8_t kv_quantize(float x, float scale) {
  return static_cast<int8_t>(clip_q8(rintf(x / scale)));
}
__device__ __forceinline__ int8_t kv_requant(int8_t q, float ratio) {
  return static_cast<int8_t>(clip_q8(rintf(static_cast<float>(q) * ratio)));
}

// bytes of dynamic shared memory for `rows` query rows of head dim hd
__host__ __device__ inline size_t smem_bytes(int rows, int hd) {
  const size_t hp = size_t(hd) + 1;
  return size_t(rows) * (2 * sizeof(long long) + sizeof(int)) +
         sizeof(float) * (rows * hp + 2 * kKeys * hp + size_t(rows) * kKeys +
                          size_t(rows) * hd + 3 * size_t(rows));
}

struct Smem {
  long long* q_off;  // element offset of each query row in q
  long long* o_off;  // element offset of each output row
  int* qpos;         // absolute position of each query row
  float *Q, *K, *V, *S, *acc, *m, *den, *scale;
};

__device__ inline Smem carve(char* base, int rows, int hd) {
  Smem sm;
  const int hp = hd + 1;
  sm.q_off = reinterpret_cast<long long*>(base);
  sm.o_off = sm.q_off + rows;
  sm.qpos = reinterpret_cast<int*>(sm.o_off + rows);
  sm.Q = reinterpret_cast<float*>(sm.qpos + rows);
  sm.K = sm.Q + rows * hp;
  sm.V = sm.K + kKeys * hp;
  sm.S = sm.V + kKeys * hp;
  sm.acc = sm.S + rows * kKeys;
  sm.m = sm.acc + rows * hd;
  sm.den = sm.m + rows;
  sm.scale = sm.den + rows;
  return sm;
}

// The shared body: `nrows` query rows (offsets and positions already in
// sm) of KV head `g` attend keys [0, walk_end) of one row's pages,
// masked to kpos <= qpos and kpos < n_keys.  PT is the page type: T, or
// int8_t with the (P, nkv) scales k_scale and v_scale.  kFold (decode)
// folds the K scale into the score scale and applies the V scale to
// each block's PV product; otherwise (prefill) an int8 block is
// dequantized as it is loaded.
template <typename T, typename PT, bool kFold>
__device__ void attend(const Smem& sm, int nrows, const T* __restrict__ q, T* __restrict__ out,
                       const PT* __restrict__ k_pages, const PT* __restrict__ v_pages,
                       const float* __restrict__ k_scale, const float* __restrict__ v_scale,
                       const int* __restrict__ tbl_row, int nkv, int g, int pg, int hd,
                       int n_keys, int walk_end, float sm_scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hp = hd + 1;
  for (int e = tid; e < nrows * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    sm.Q[r * hp + d] = to_f<T>(q[sm.q_off[r] + d]);
    sm.acc[r * hd + d] = 0.f;
  }
  for (int r = tid; r < nrows; r += kThreads) {
    sm.m[r] = -CUDART_INF_F;
    sm.den[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = 0; k0 < walk_end;) {
    // one block of keys inside one page
    const int j = k0 / pg, t0 = k0 % pg;
    const int nk = min(kKeys, min(pg - t0, walk_end - k0));
    const long long cell = (long long)tbl_row[j] * nkv + g;
    const long long base = cell * pg * hd + (long long)t0 * hd;
    // the block's score scale and V scale (1 where no scale applies)
    [[maybe_unused]] float kmul = sm_scale, vmul = 1.f, kdq = 1.f, vdq = 1.f;
    if constexpr (kQuant) {
      if constexpr (kFold) {
        kmul = k_scale[cell] * sm_scale;
        vmul = v_scale[cell];
      } else {
        kdq = k_scale[cell];
        vdq = v_scale[cell];
      }
    }
    for (int e = tid; e < nk * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      if constexpr (kQuant && !kFold) {
        sm.K[t * hp + d] = to_f<PT>(k_pages[base + e]) * kdq;
        sm.V[t * hp + d] = to_f<PT>(v_pages[base + e]) * vdq;
      } else {
        sm.K[t * hp + d] = to_f<PT>(k_pages[base + e]);
        sm.V[t * hp + d] = to_f<PT>(v_pages[base + e]);
      }
    }
    __syncthreads();

    for (int e = tid; e < nrows * nk; e += kThreads) {
      const int r = e / nk, t = e % nk;
      const int kpos = k0 + t;
      float s = -CUDART_INF_F;
      if (kpos <= sm.qpos[r] && kpos < n_keys) {
        const float* qr = sm.Q + r * hp;
        const float* kt = sm.K + t * hp;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kt[d], dot);
        s = dot * kmul;
      }
      sm.S[r * kKeys + t] = s;
    }
    __syncthreads();

    // online softmax statistics, one warp per row
    for (int r = warp; r < nrows; r += kThreads / 32) {
      float* srow = sm.S + r * kKeys;
      float mx = -CUDART_INF_F;
      for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, srow[t]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = sm.m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nk; t += 32) {
        const float s = srow[t];
        const float p = s > -CUDART_INF_F ? expf(s - m_new) : 0.f;
        srow[t] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float sc = m_prev > -CUDART_INF_F ? expf(m_prev - m_new) : 0.f;
        sm.scale[r] = sc;
        sm.den[r] = sm.den[r] * sc + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    for (int e = tid; e < nrows * hd; e += kThreads) {
      const int r = e / hd, d = e % hd;
      const float* prow = sm.S + r * kKeys;
      if constexpr (!kQuant) {
        float a = sm.acc[e] * sm.scale[r];
        for (int t = 0; t < nk; ++t) a = fmaf(rnd<T>(prow[t]), sm.V[t * hp + d], a);
        sm.acc[e] = a;
      } else if constexpr (kFold) {
        float pv = 0.f;
        for (int t = 0; t < nk; ++t) pv = fmaf(prow[t], sm.V[t * hp + d], pv);
        sm.acc[e] = sm.acc[e] * sm.scale[r] + pv * vmul;
      } else {
        float a = sm.acc[e] * sm.scale[r];
        for (int t = 0; t < nk; ++t) a = fmaf(prow[t], sm.V[t * hp + d], a);
        sm.acc[e] = a;
      }
    }
    __syncthreads();
    k0 += nk;
  }

  for (int e = tid; e < nrows * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    out[sm.o_off[r] + d] = from_f<T>(sm.acc[e] / fmaxf(sm.den[r], 1e-30f));
  }
}

struct DecodeParams {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  const int* kv_len;
  void* out;
  int nh, nkv, hd, pg, W;
  long long q_ss, q_sh;
  float sm_scale;
  const float* k_scale;  // int8 pages: (P, nkv) scales; null otherwise
  const float* v_scale;
};

template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads) rpa_fwd_kernel(DecodeParams p) {
  extern __shared__ __align__(16) char smem_raw[];
  const int g = blockIdx.x, s = blockIdx.y;
  const int rep = p.nh / p.nkv;
  const Smem sm = carve(smem_raw, rep, p.hd);
  const int kv_len = min(p.kv_len[s], p.W * p.pg);
  for (int e = threadIdx.x; e < rep; e += kThreads) {
    const int head = g * rep + e;
    sm.q_off[e] = s * p.q_ss + head * p.q_sh;
    sm.o_off[e] = ((long long)s * p.nh + head) * p.hd;
    sm.qpos[e] = kv_len - 1;
  }
  __syncthreads();
  attend<T, PT, true>(sm, rep, static_cast<const T*>(p.q), static_cast<T*>(p.out),
                      static_cast<const PT*>(p.k_pages), static_cast<const PT*>(p.v_pages),
                      p.k_scale, p.v_scale, p.table + (long long)s * p.W, p.nkv, g, p.pg,
                      p.hd, kv_len, max(kv_len, 0), p.sm_scale);
}

struct PrefillParams {
  const void* q;
  const void* k_chunk;
  const void* v_chunk;
  void* k_pages;
  void* v_pages;
  const int* table;
  const int* lengths;
  const int* chunk_real;
  void* out;
  int c, nh, nkv, hd, pg, W, P;
  long long q_sb, q_st, q_sh, kc_sb, kc_st, kc_sh, vc_sb, vc_st, vc_sh;
  float sm_scale;
  // int8 pages: the (P, nkv) scales before and after this chunk; null otherwise
  const float* k_scale_old;
  const float* k_scale_new;
  const float* v_scale_old;
  const float* v_scale_new;
};

// the fused write: chunk row i of row r (grid (c, b)) into its page cell
template <typename T>
__global__ void __launch_bounds__(kThreads) rpp_write_kernel(PrefillParams p) {
  const int i = blockIdx.x, r = blockIdx.y;
  const int pad = p.c - p.chunk_real[r];
  if (i < pad) return;  // left pad: never written
  const int pos = p.lengths[r] + i - pad;
  if (pos >= p.W * p.pg) return;  // past the row's table: no page owns it
  const int phys = p.table[(long long)r * p.W + pos / p.pg];
  if (phys <= 0 || phys >= p.P) return;  // trash or outside the pool
  const int off = pos % p.pg;
  const T* kc = static_cast<const T*>(p.k_chunk) + r * p.kc_sb + i * p.kc_st;
  const T* vc = static_cast<const T*>(p.v_chunk) + r * p.vc_sb + i * p.vc_st;
  T* kp = static_cast<T*>(p.k_pages);
  T* vp = static_cast<T*>(p.v_pages);
  for (int e = threadIdx.x; e < p.nkv * p.hd; e += kThreads) {
    const int h = e / p.hd, d = e % p.hd;
    const long long dst = (((long long)phys * p.nkv + h) * p.pg + off) * p.hd + d;
    kp[dst] = kc[h * p.kc_sh + d];
    vp[dst] = vc[h * p.vc_sh + d];
  }
}

// the int8 write: grid (window pages, nkv, b); block x is logical page
// lengths[r] / pg + x of row r, rewritten whole (see the header)
template <typename T>
__global__ void __launch_bounds__(kThreads) rpp_write_q8_kernel(PrefillParams p) {
  const int g = blockIdx.y, r = blockIdx.z;
  const int ln = p.lengths[r], creal = p.chunk_real[r];
  const int total = ln + creal, pad = p.c - creal;
  const int j = ln / p.pg + blockIdx.x;
  // a window page: j*pg + pg > ln holds by construction of j
  if (creal <= 0 || j >= p.W || j * p.pg >= total) return;
  const int phys = p.table[(long long)r * p.W + j];
  if (phys <= 0 || phys >= p.P) return;  // trash or outside the pool
  const long long cell = (long long)phys * p.nkv + g;
  const float ksn = p.k_scale_new[cell], vsn = p.v_scale_new[cell];
  const bool has_prior = ln > j * p.pg;
  const float rk = has_prior ? p.k_scale_old[cell] / ksn : 0.f;
  const float rv = has_prior ? p.v_scale_old[cell] / vsn : 0.f;
  int8_t* kp = static_cast<int8_t*>(p.k_pages) + cell * p.pg * p.hd;
  int8_t* vp = static_cast<int8_t*>(p.v_pages) + cell * p.pg * p.hd;
  const T* kc = static_cast<const T*>(p.k_chunk) + r * p.kc_sb + g * p.kc_sh;
  const T* vc = static_cast<const T*>(p.v_chunk) + r * p.vc_sb + g * p.vc_sh;
  for (int e = threadIdx.x; e < p.pg * p.hd; e += kThreads) {
    const int kpos = j * p.pg + e / p.hd, d = e % p.hd;
    if (kpos >= ln && kpos < total) {
      const int i = kpos - ln + pad;
      kp[e] = kv_quantize(to_f<T>(kc[i * p.kc_st + d]), ksn);
      vp[e] = kv_quantize(to_f<T>(vc[i * p.vc_st + d]), vsn);
    } else {
      kp[e] = kv_requant(kp[e], rk);
      vp[e] = kv_requant(vp[e], rv);
    }
  }
}

// the attend: grid (query tiles, nkv, b); int8 pages read with the new scales
template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads) rpp_attend_kernel(PrefillParams p) {
  extern __shared__ __align__(16) char smem_raw[];
  const int tile = blockIdx.x, g = blockIdx.y, r = blockIdx.z;
  const int rep = p.nh / p.nkv;
  const Smem sm = carve(smem_raw, kRows, p.hd);
  const int ln = p.lengths[r], creal = p.chunk_real[r];
  const int pad = p.c - creal;
  const int total = min(ln + creal, p.W * p.pg);
  const int s0 = tile * kRows;
  const int nrows = min(kRows, p.c * rep - s0);
  for (int k = threadIdx.x; k < nrows; k += kThreads) {
    const int srow = s0 + k, i = srow / rep, head = g * rep + srow % rep;
    sm.q_off[k] = r * p.q_sb + i * p.q_st + head * p.q_sh;
    sm.o_off[k] = (((long long)r * p.c + i) * p.nh + head) * p.hd;
    sm.qpos[k] = max(ln + i - pad, 0);
  }
  __syncthreads();
  // this tile's page walk stops at its own largest query position
  const int qpos_max = max(ln + (s0 + nrows - 1) / rep - pad, 0);
  const int walk_end = min(total, qpos_max + 1);
  attend<T, PT, false>(sm, nrows, static_cast<const T*>(p.q), static_cast<T*>(p.out),
                       static_cast<const PT*>(p.k_pages), static_cast<const PT*>(p.v_pages),
                       p.k_scale_new, p.v_scale_new, p.table + (long long)r * p.W, p.nkv, g,
                       p.pg, p.hd, total, walk_end, p.sm_scale);
}

// ------------------------------------------- the attend on tensor cores
// The one dispatch rule, here and in the Python wrapper
// (attention_kernels.rpp_uses_tensor_cores): bf16 q with a head dim of 32,
// 64 or 128 and pages a multiple of 64 tokens take rpp_attend_tc_kernel;
// every other shape the limits accept (fp32 q, other head dims, other
// page sizes) takes rpp_attend_kernel on CUDA cores.
bool uses_tc(int dtype, int hd, int pg) {
  return dtype == 1 && (hd == 32 || hd == 64 || hd == 128) && pg % kWgRows == 0;
}

struct PoolMaps {
  CUtensorMap k, v;
};

template <typename PT, int HD> struct RppLayout {
  static constexpr bool Q8 = std::is_same<PT, int8_t>::value;
  using T = Tile<HD, kWgRows>;
  static constexpr int KV = T::BYTES;                      // Q, then stage s: K, then V (bf16)
  static constexpr int RAW = KV + kStages * 2 * T::BYTES;  // int8: stage s: K, then V codes
  static constexpr int RAW_B = kWgRows * HD;               // bytes of one tile of codes
  static constexpr int BARS = RAW + (Q8 ? kStages * 2 * RAW_B : 0);  // full[], empty[]
  static constexpr int BYTES = BARS + 8 * 2 * kStages + 1024;
};

// grid (tiles of 64 query rows, nkv, b), query rows in the order i * rep
// + e.  The consumer warpgroup gathers the Q tile once through q's strides
// into the swizzled layout (rows past nrows are zeros); the producer warp's
// lane 0 reads the row's page table and copies each 64-key tile of the
// walk, inside one page, by TMA at (0, t0, g, page_table[r, j]) through a
// two-stage ring.  bf16 pages land as swizzled bf16 tiles; int8 pages land
// as rows of codes that the consumers convert to bf16 tiles (exact, |code|
// <= 127) before releasing the stage.  Per tile: S = Q K^T (shared-memory
// operands, K-major) times sm_scale (int8: k_scale_new[page, g] *
// sm_scale), masked only on tiles that straddle a query position or the
// row's total, the online softmax in registers, then O += round(P) V
// (int8: round(P * v_scale_new[page, g]) V), P the register A-operand and
// V MN-major.
template <typename PT, int HD>
__global__ void __launch_bounds__(kTcThreads)
    rpp_attend_tc_kernel(const __grid_constant__ PoolMaps maps, const PrefillParams p) {
  using L = RppLayout<PT, HD>;
  using KT = typename L::T;
  constexpr bool kQuant = L::Q8;
  extern __shared__ __align__(16) char smem_raw[];  // as the CUDA-core kernels declare it
  uint8_t* smem = align1024(reinterpret_cast<uint8_t*>(smem_raw));
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + L::KV;
  uint8_t* raw = smem + L::RAW;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* empty = full + kStages;

  const int g = blockIdx.y, r = blockIdx.z;
  const int rep = p.nh / p.nkv;
  const int ln = p.lengths[r], creal = p.chunk_real[r];
  const int pad = p.c - creal;
  const int total = min(ln + creal, p.W * p.pg);
  const int s0 = blockIdx.x * kWgRows;
  const int nrows = min(kWgRows, p.c * rep - s0);
  // query positions never fall along the row order: the walk stops at the
  // last row's position, and the first row's decides which tiles are full
  const int qpos_min = max(ln + s0 / rep - pad, 0);
  const int walk_end = min(total, max(ln + (s0 + nrows - 1) / rep - pad, 0) + 1);
  const int ntiles = walk_end > 0 ? (walk_end + kWgRows - 1) / kWgRows : 0;
  const int* tbl = p.table + (long long)r * p.W;

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
      for (int n = 0; n < ntiles; ++n) {
        const int s = n % kStages, k0 = n * kWgRows;
        if (n >= kStages) mbar_wait(empty + s, (n / kStages - 1) & 1);
        const int phys = tbl[k0 / p.pg], t0 = k0 % p.pg;
        if constexpr (kQuant) {
          uint8_t* dst = raw + s * 2 * L::RAW_B;
          mbar_expect_tx(full + s, 2 * L::RAW_B);
          tma_load(dst, &maps.k, full + s, 0, t0, g, phys);
          tma_load(dst + L::RAW_B, &maps.v, full + s, 0, t0, g, phys);
        } else {
          uint8_t* dst = KVs + s * 2 * KT::BYTES;
          mbar_expect_tx(full + s, 2 * KT::BYTES);
          for (int c = 0; c < KT::NP; ++c) {
            tma_load(dst + c * KT::PANEL_B, &maps.k, full + s, c * KT::PW, t0, g, phys);
            tma_load(dst + KT::BYTES + c * KT::PANEL_B, &maps.v, full + s, c * KT::PW, t0, g,
                     phys);
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r0 and r0 + 8 of the tile,
  // columns 8 j + 2 (lane % 4) + {0, 1} of each 8-column block j
  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = 16 * (tid / 32) + lane / 4, c0 = 2 * (lane % 4);
  const unsigned short* q = static_cast<const unsigned short*>(p.q);
  for (int e = tid; e < kWgRows * HD / 8; e += 128) {
    const int row = e / (HD / 8), col = 8 * (e % (HD / 8));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < nrows) {
      const int srow = s0 + row, head = g * rep + srow % rep;
      const unsigned short* src = q + r * p.q_sb + (srow / rep) * p.q_st + head * p.q_sh + col;
#pragma unroll
      for (int x = 0; x < 4; ++x)
        w[x] = uint32_t(__ldg(src + 2 * x)) | uint32_t(__ldg(src + 2 * x + 1)) << 16;
    }
    *reinterpret_cast<uint4*>(Qs + KT::chunk_offset(row, col)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  fence_async_smem();  // the gathered Q is read by wgmma
  wg_bar();

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = max(ln + (s0 + r0 + 8 * i) / rep - pad, 0);
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, den[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(Qs);
  for (int n = 0; n < ntiles; ++n) {
    const int s = n % kStages, k0 = n * kWgRows;
    uint8_t* kv = KVs + s * 2 * KT::BYTES;
    mbar_wait(full + s, (n / kStages) & 1);
    [[maybe_unused]] float kmul = p.sm_scale, vmul = 1.f;
    if constexpr (kQuant) {
      const long long cell = (long long)tbl[k0 / p.pg] * p.nkv + g;
      kmul = p.k_scale_new[cell] * p.sm_scale;
      vmul = p.v_scale_new[cell];
      // codes -> bf16 tiles: slot s was last read by tile n - 2's products,
      // which every warp finished before tile n - 1's barrier
      const uint8_t* src = raw + s * 2 * L::RAW_B;
      for (int e = tid; e < 2 * kWgRows * HD / 8; e += 128) {
        const int half = e / (kWgRows * HD / 8), rem = e % (kWgRows * HD / 8);
        const int row = rem / (HD / 8), col = 8 * (rem % (HD / 8));
        const uint2 w = *reinterpret_cast<const uint2*>(src + half * L::RAW_B + row * HD + col);
        const int8_t* c8 = reinterpret_cast<const int8_t*>(&w);
        *reinterpret_cast<uint4*>(kv + half * KT::BYTES + KT::chunk_offset(row, col)) =
            make_uint4(pack_bf16(c8[0], c8[1]), pack_bf16(c8[2], c8[3]),
                       pack_bf16(c8[4], c8[5]), pack_bf16(c8[6], c8[7]));
      }
      fence_async_smem();
      wg_bar();
      mbar_arrive(empty + s);  // the codes are no longer read
    } else {
      __syncwarp();
    }
    const uint32_t k_addr = smem_u32(kv), v_addr = k_addr + KT::BYTES;
    float sc[kWgRows / 2];
#pragma unroll
    for (int i = 0; i < kWgRows / 2; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<kWgRows>(sc, KT::kmajor(q_addr, kk), KT::kmajor(k_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(sc);

    const bool full_tile = k0 + kWgRows - 1 <= qpos_min && k0 + kWgRows <= total;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int x = 0; x < kWgRows / 2; ++x) {
      const int i = (x / 2) % 2;
      float v = sc[x] * kmul;
      if (!full_tile) {
        const int kpos = k0 + 8 * (x / 4) + c0 + x % 2;
        if (!(kpos <= qpos[i] && kpos < total)) v = -CUDART_INF_F;
      }
      sc[x] = v;
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
    for (int x = 0; x < kWgRows / 2; ++x) {
      const int i = (x / 2) % 2;
      const float pij = sc[x] > -CUDART_INF_F ? expf(sc[x] - m[i]) : 0.f;
      sum[i] += pij;  // den sums the unrounded p
      if constexpr (kQuant) {
        sc[x] = pij * vmul;  // the page's V scale, folded in before the rounding
      } else {
        sc[x] = pij;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) den[i] = den[i] * alpha[i] + quad_sum(sum[i]);
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] *= alpha[(x / 2) % 2];
    uint32_t pa[kWgRows / 16][4];
    to_a_frags<kWgRows>(pa, sc);

    fence_regs(acc);
    fence_regs(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kWgRows / 16; ++kk) wgmma_rs<HD>(acc, pa[kk], KT::mnmajor(v_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    fence_regs(pa);
    if constexpr (!kQuant) mbar_arrive(empty + s);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= nrows) continue;
    const int srow = s0 + row, head = g * rep + srow % rep;
    __nv_bfloat16* o = out + (((long long)r * p.c + srow / rep) * p.nh + head) * HD;
    const float inv = 1.f / fmaxf(den[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
  }
}

// the attend on tensor cores: TMA maps over the (P, nkv, pg, hd) pools
template <typename PT, int HD>
cudaError_t launch_attend_tc(const PrefillParams& p, int b, cudaStream_t stream) {
  using L = RppLayout<PT, HD>;
  const long long st[3] = {(long long)p.nkv * p.pg * HD, (long long)p.pg * HD, HD};
  const int pw = L::Q8 ? HD : L::T::PW;
  PoolMaps maps{};
  if (!make_map(&maps.k, p.k_pages, HD, p.pg, p.nkv, p.P, st, pw, kWgRows, L::Q8) ||
      !make_map(&maps.v, p.v_pages, HD, p.pg, p.nkv, p.P, st, pw, kWgRows, L::Q8))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(rpp_attend_tc_kernel<PT, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const int tiles = (p.c * (p.nh / p.nkv) + kWgRows - 1) / kWgRows;
  rpp_attend_tc_kernel<PT, HD><<<dim3(tiles, p.nkv, b), kTcThreads, L::BYTES, stream>>>(maps, p);
  return cudaGetLastError();
}

template <typename PT>
cudaError_t attend_tc(const PrefillParams& p, int b, cudaStream_t stream) {
  switch (p.hd) {
    case 32: return launch_attend_tc<PT, 32>(p, b, stream);
    case 64: return launch_attend_tc<PT, 64>(p, b, stream);
    case 128: return launch_attend_tc<PT, 128>(p, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename PT>
cudaError_t launch_decode(const DecodeParams& p, int S, cudaStream_t stream) {
  const int rep = p.nh / p.nkv;
  const size_t smem = smem_bytes(rep, p.hd);
  cudaError_t err = cudaFuncSetAttribute(
      rpa_fwd_kernel<T, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  rpa_fwd_kernel<T, PT><<<dim3(p.nkv, S), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename PT>
cudaError_t launch_prefill(const PrefillParams& p, int b, cudaStream_t stream) {
  const int rep = p.nh / p.nkv;
  if constexpr (std::is_same<PT, int8_t>::value) {
    // a row's write window spans at most ceil(c / pg) + 1 pages
    const int window = min(p.W, (p.c + p.pg - 1) / p.pg + 1);
    rpp_write_q8_kernel<T><<<dim3(window, p.nkv, b), kThreads, 0, stream>>>(p);
  } else {
    rpp_write_kernel<T><<<dim3(p.c, b), kThreads, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (uses_tc(1, p.hd, p.pg)) return attend_tc<PT>(p, b, stream);
  }
  const size_t smem = smem_bytes(kRows, p.hd);
  err = cudaFuncSetAttribute(rpp_attend_kernel<T, PT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (p.c * rep + kRows - 1) / kRows;
  rpp_attend_kernel<T, PT><<<dim3(tiles, p.nkv, b), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, chunk K/V, output); the pages
// are q's dtype, or 2 = int8 with scales.  Dispatches launch_decode or
// launch_prefill on (T, PT).
template <template <typename, typename> class Launch, typename Params>
cudaError_t dispatch(const Params& p, int n, int dtype, int page_dtype, bool scales,
                     cudaStream_t s) {
  if (page_dtype == 2 && scales)
    return dtype == 1 ? Launch<__nv_bfloat16, int8_t>::run(p, n, s)
                      : Launch<float, int8_t>::run(p, n, s);
  if (page_dtype == dtype && !scales)
    return dtype == 1 ? Launch<__nv_bfloat16, __nv_bfloat16>::run(p, n, s)
                      : Launch<float, float>::run(p, n, s);
  return cudaErrorInvalidValue;
}

template <typename T, typename PT> struct Decode {
  static cudaError_t run(const DecodeParams& p, int S, cudaStream_t s) {
    return launch_decode<T, PT>(p, S, s);
  }
};
template <typename T, typename PT> struct Prefill {
  static cudaError_t run(const PrefillParams& p, int b, cudaStream_t s) {
    return launch_prefill<T, PT>(p, b, s);
  }
};

bool shape_ok(int nh, int nkv, int hd, int pg) {
  return nkv > 0 && nh % nkv == 0 && nh / nkv <= kMaxRep && hd > 0 && hd <= kMaxHeadDim &&
         pg > 0;
}

}  // namespace

// Limits the library is built for; the Python wrapper checks the same
// ones (attention_kernels.MAX_REP, MAX_HEAD_DIM) first and names the shape
// it refuses.
extern "C" int mdt_rpa_max_rep() { return kMaxRep; }
extern "C" int mdt_rpa_max_head_dim() { return kMaxHeadDim; }
// 1 when a prefill of q's dtype code, head dim and page size runs the
// tensor-core attend (the wrapper's rpp_uses_tensor_cores is held to it)
extern "C" int mdt_rpp_uses_tc(int dtype, int hd, int pg) { return uses_tc(dtype, hd, pg); }

// Both return a cudaError_t (0 on success).  dtype: 0 = float32, 1 =
// bfloat16 (q, chunk K/V, output); page_dtype: the same code as dtype, or
// 2 = int8, which takes the scale pointers (null for the other pages).
extern "C" int mdt_rpa_fwd(const void* q, const void* k_pages, const void* v_pages,
                           const int* table, const int* kv_len, const float* k_scale,
                           const float* v_scale, void* out, int S, int nh, int nkv, int hd,
                           int pg, int W, long long q_ss, long long q_sh, float sm_scale,
                           int dtype, int page_dtype, void* stream) {
  if (!shape_ok(nh, nkv, hd, pg) || S < 1 || W < 1 || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  DecodeParams p{q,  k_pages, v_pages, table, kv_len,   out,     nh,     nkv, hd,
                 pg, W,       q_ss,    q_sh,  sm_scale, k_scale, v_scale};
  return (int)dispatch<Decode>(p, S, dtype, page_dtype, k_scale != nullptr,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int mdt_rpp_fwd(const void* q, const void* k_chunk, const void* v_chunk,
                           void* k_pages, void* v_pages, const int* table, const int* lengths,
                           const int* chunk_real, const float* k_scale_old,
                           const float* k_scale_new, const float* v_scale_old,
                           const float* v_scale_new, void* out, int b, int c, int nh, int nkv,
                           int hd, int pg, int W, int P, long long q_sb, long long q_st,
                           long long q_sh, long long kc_sb, long long kc_st, long long kc_sh,
                           long long vc_sb, long long vc_st, long long vc_sh, float sm_scale,
                           int dtype, int page_dtype, void* stream) {
  const int n_scales = (k_scale_old != nullptr) + (k_scale_new != nullptr) +
                       (v_scale_old != nullptr) + (v_scale_new != nullptr);
  if (!shape_ok(nh, nkv, hd, pg) || b < 1 || c < 1 || W < 1 || P < 1 ||
      (n_scales != 0 && n_scales != 4))
    return (int)cudaErrorInvalidValue;
  PrefillParams p{q,           k_chunk,     v_chunk,     k_pages,    v_pages, table, lengths,
                  chunk_real,  out,         c,           nh,         nkv,     hd,    pg,
                  W,           P,           q_sb,        q_st,       q_sh,    kc_sb, kc_st,
                  kc_sh,       vc_sb,       vc_st,       vc_sh,      sm_scale, k_scale_old,
                  k_scale_new, v_scale_old, v_scale_new};
  return (int)dispatch<Prefill>(p, b, dtype, page_dtype, n_scales == 4,
                                static_cast<cudaStream_t>(stream));
}
