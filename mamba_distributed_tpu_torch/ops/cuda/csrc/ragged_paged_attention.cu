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
// from the plain PyTorch version only by summation order and, in the
// decode, by where p is rounded: the TPU kernel rounds exp(s - m) with m
// the running maximum over whole pages of the row; the split decode
// rounds it with m the running maximum of the steps its warp has walked
// in its page range (see Design), and the merges rescale each warp's and
// each range's fp32 sums by exp(m_part - m_all).  That moves each PV term by at most a
// bf16 rounding (2^-9 relative), inside the bf16 tolerance of 3e-2
// (tests/test_torch_decode_split.py holds a plain model of it against the
// JAX kernel).
//
// Int8 pages (q, the chunk K/V and the output stay bf16 or fp32):
//   decode   score = dot(q, k_int8) * (ks[phys, g] * sm_scale), the scalar
//            product first (:565-570); p (NOT rounded, fp32 throughout)
//            times vs[phys, g] multiplies each V code before it joins the
//            rescaled accumulator, where the TPU kernel multiplies each
//            page's PV sum by vs (:588-593): the same sum, rounded in fp32
//            at other places.  Splits and steps never cross a page, so one
//            (ks, vs) pair holds for every key of a step.
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
// Design.  The decode (rpa_split_kernel) is split-K over each row's pages:
// the grid covers (split, KV head, slot), a split being a range of whole
// pages (rpa_splits: enough ranges for about two CTAs per SM, never more
// than W), one CTA of four warps each.  The warps take the range's steps
// in turn; a step is 4 G keys that never cross a page: G = 32 / Lk groups
// of Lk lanes, each group one key, each lane a 16-byte vector of it (8
// bytes of int8 codes; at hd 64 in bf16 a key is 8 lanes x 16 B).  A warp
// keeps its rep query rows (up to four at a time) in registers; the scores
// are dot products reduced by shuffles over the Lk lanes, the step's
// maximum over the groups by shuffles too, so every group of a warp
// rescales alike; each warp's next step's K and V loads are in flight
// during this step's math; the range's page entries are read once, a page
// per lane, before the walk.  The CTA merges its warps' (m, den, acc) in
// warp order in shared memory and writes the range's partial in fp32 to a
// workspace; a range with no key writes m = -inf (and zeros) and adds
// nothing.  A second small kernel (rpa_combine_kernel, one CTA per (slot,
// KV head)) combines the ranges in their order, so two launches give the
// same bits; with one range the walk writes the output itself.  Tried
// first and measured slower (PERF.md, Findings): a warp per range, whose
// walk waited on the table at every step, and a ticketed combine in the
// last warp to finish, which waited on a fence, an atomic and dependent
// reads of the other SMs' partials.  This stays on the CUDA cores: with rep = 3
// query rows per KV head (hybrid-280m: 12/4 heads) a 64-row wgmma tile
// would sit about 95% idle.
//
// The write kernels and the CUDA-core attend: one CTA of 256 threads per
// (row, KV head, tile of 64 query rows) for the prefill attend (query rows
// are the (chunk position, GQA rep) pairs in the TPU kernel's order i * rep
// + e).  The page walk reads keys in blocks of at most 64 tokens that
// never cross a page; each block's K and V land in shared memory as fp32 (rows padded to
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
// decode is latency-bound too: eight slots of a few thousand live tokens
// are about 3 MB, under a microsecond of bytes, so the split count and the
// loads in flight per warp decide its time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <cstring>
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

// The CUDA-core prefill attend's body: `nrows` query rows (offsets and
// positions already in sm) of KV head `g` attend keys [0, walk_end) of one
// row's pages, masked to kpos <= qpos and kpos < n_keys.  PT is the page
// type: T, or int8_t with the (P, nkv) scales k_scale and v_scale, by
// which an int8 block is dequantized as it is loaded.
template <typename T, typename PT>
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
    // the block's dequantization scales (1 where no scale applies)
    [[maybe_unused]] float kdq = 1.f, vdq = 1.f;
    if constexpr (kQuant) {
      kdq = k_scale[cell];
      vdq = v_scale[cell];
    }
    for (int e = tid; e < nk * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      if constexpr (kQuant) {
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
        s = dot * sm_scale;
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

// ------------------------------------------------- the split-K decode
// The one split rule, here and in the Python wrapper
// (attention_kernels.rpa_splits): a row's W pages are cut into ranges of
// `pps` whole pages, enough ranges that S * nkv * splits reaches about two
// CTAs on each of the H100's 132 SMs (what their registers let run at
// once), and never more ranges than pages.
constexpr int kSplitTargetCtas = 2 * 132;
__host__ __device__ inline int rpa_split_pages(int S, int nkv, int W) {
  const int items = S * nkv;
  const int splits = max(1, min(W, (kSplitTargetCtas + items - 1) / items));
  return (W + splits - 1) / splits;
}
__host__ __device__ inline int rpa_splits(int S, int nkv, int W) {
  const int pps = rpa_split_pages(S, nkv, W);
  return (W + pps - 1) / pps;
}

constexpr int kDecWarps = 4;  // warps per split (a CTA)
constexpr int kKeysPerLane = 4;  // keys a lane group takes per step

// a lane's share of a K or V row: Vec<PT>::N elements read as one vector
// (16 bytes; 8 for int8 codes)
template <typename PT> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
};
template <> struct Vec<float> {
  static constexpr int N = 4;
  using Raw = uint4;
};
template <> struct Vec<int8_t> {
  static constexpr int N = 8;
  using Raw = uint2;
};

// elements [d0, d0 + N) of a row (zeros past hd), as one vector load when
// the rows are vector-aligned
template <typename PT>
__device__ __forceinline__ typename Vec<PT>::Raw load_vec(const PT* __restrict__ row, int d0,
                                                         int hd, bool vec_ok) {
  using Raw = typename Vec<PT>::Raw;
  Raw r{};
  if (d0 >= hd) return r;
  if (vec_ok) return __ldg(reinterpret_cast<const Raw*>(row + d0));
  PT tmp[Vec<PT>::N];
  memset(tmp, 0, sizeof(tmp));
#pragma unroll
  for (int i = 0; i < Vec<PT>::N; ++i)
    if (d0 + i < hd) tmp[i] = row[d0 + i];
  memcpy(&r, tmp, sizeof(r));
  return r;
}

template <typename PT>
__device__ __forceinline__ void unpack(float (&f)[Vec<PT>::N], const typename Vec<PT>::Raw& r) {
  PT tmp[Vec<PT>::N];
  memcpy(tmp, &r, sizeof(r));
#pragma unroll
  for (int i = 0; i < Vec<PT>::N; ++i) f[i] = to_f<PT>(tmp[i]);
}

struct DecodeParams {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  const int* kv_len;
  void* out;
  int S, nh, nkv, hd, pg, W;
  long long q_ss, q_sh;
  float sm_scale;
  const float* k_scale;  // int8 pages: (P, nkv) scales; null otherwise
  const float* v_scale;
  float* part;  // per split: m[rep], den[rep], acc[rep][hd]
  int pps, splits;
};

// One CTA of kDecWarps warps per (split, KV head g, slot s): RG of the rep
// query rows at a time, in registers, walk the split's pages in steps of
// kKeysPerLane * G keys inside one page (G = 32 / Lk lane groups of Lk
// lanes, each group one key, each lane Vec::N elements of it), warp w
// taking steps w, w + kDecWarps, ..., each warp's next step's K and V
// loads in flight during this step's math.  Scores: the Lk-lane dot
// product reduced by shuffles; each warp's running max m is taken over
// each of its steps' keys (shuffles across the groups), so every group
// rescales alike and den and acc stay per group until the walk ends.  The
// split's page entries (and int8 scales) are read once, a page per lane,
// and handed out by shuffles, so no step waits on a table read.  The CTA
// merges its warps' (m, den, acc) in warp order in shared memory and
// writes the split's partial to the workspace for rpa_combine_kernel; with
// one split it writes the output itself.
template <typename T, typename PT, int RG>
__global__ void __launch_bounds__(32 * kDecWarps, 1) rpa_split_kernel(DecodeParams p) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int VN = Vec<PT>::N;
  using Raw = typename Vec<PT>::Raw;
  __shared__ float sh_m[kDecWarps][RG], sh_den[kDecWarps][RG];
  __shared__ float sh_acc[kDecWarps][RG][kMaxHeadDim];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int split = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int item = (s * p.nkv + g) * p.splits + split;
  const int rep = p.nh / p.nkv, hd = p.hd, pg = p.pg;

  int Lk = 1;  // lanes per key: a power of two covering hd
  while (Lk * VN < hd) Lk *= 2;
  const int G = 32 / Lk, grp = lane / Lk, d0 = (lane % Lk) * VN;
  const int kstep = kKeysPerLane * G, spp = (pg + kstep - 1) / kstep;
  const int j0 = split * p.pps;  // the split's first page
  const int key_lo = j0 * pg;
  // the split's pages, one a lane (a split of more than 32 pages reads the
  // table at each step), read before the row's length is known: a table's
  // entries always name pages of the pool
  const int np = min(p.pps, p.W - j0);
  const bool pre = np <= 32;
  const int* tbl = p.table + (long long)s * p.W;
  int my_phys = 0;
  [[maybe_unused]] float my_km = 0.f, my_vm = 0.f;
  if (pre && lane < np) {
    my_phys = tbl[j0 + lane];
    if constexpr (kQuant) {
      const long long cell = (long long)my_phys * p.nkv + g;
      my_km = p.k_scale[cell] * p.sm_scale;
      my_vm = p.v_scale[cell];
    }
  }
  const int kv_len = min(p.kv_len[s], p.W * pg);
  const int key_hi = min(key_lo + p.pps * pg, kv_len);
  int n_steps = 0;
  if (key_hi > key_lo) {
    const int jl = (key_hi - 1) / pg;
    n_steps = (jl - j0) * spp + (key_hi - 1 - jl * pg) / kstep + 1;
  }
  const PT* kp = static_cast<const PT*>(p.k_pages);
  const PT* vp = static_cast<const PT*>(p.v_pages);
  const bool vec_ok = hd % VN == 0 &&
                      (reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) %
                              sizeof(Raw) == 0;
  const int stride = rep * (hd + 2);
  float* wm = p.part + (long long)item * stride;
  float* wden = wm + rep;
  float* wacc = wden + rep;

  for (int r0 = 0; r0 < rep; r0 += RG) {
    float q[RG][VN], acc[RG][VN], m[RG], den[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      const T* qr = static_cast<const T*>(p.q) + s * p.q_ss + (g * rep + r0 + r) * p.q_sh;
#pragma unroll
      for (int i = 0; i < VN; ++i) {
        q[r][i] = r0 + r < rep && d0 + i < hd ? to_f<T>(qr[d0 + i]) : 0.f;
        acc[r][i] = 0.f;
      }
      m[r] = -CUDART_INF_F;
      den[r] = 0.f;
    }

    // step t: page j0 + t / spp, keys off + u G + grp of it (u < kKeysPerLane)
    Raw kr[kKeysPerLane], vr[kKeysPerLane];
    float kmul = p.sm_scale, vmul = 1.f;
    auto issue = [&](int t, Raw (&kn)[kKeysPerLane], Raw (&vn)[kKeysPerLane], float& km,
                     float& vm) {
      const int jj = t / spp, off = (t % spp) * kstep;
      const int phys = pre ? __shfl_sync(0xffffffffu, my_phys, jj) : tbl[j0 + jj];
      const long long cell = (long long)phys * p.nkv + g;
      if constexpr (kQuant) {
        km = pre ? __shfl_sync(0xffffffffu, my_km, jj) : p.k_scale[cell] * p.sm_scale;
        vm = pre ? __shfl_sync(0xffffffffu, my_vm, jj) : p.v_scale[cell];
      }
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int kin = off + u * G + grp;  // key index inside the page
        const long long row = (cell * pg + kin) * hd;
        // any key of the page (past the row's length too: the math masks it)
        kn[u] = kin < pg ? load_vec<PT>(kp + row, d0, hd, vec_ok) : Raw{};
        vn[u] = kin < pg ? load_vec<PT>(vp + row, d0, hd, vec_ok) : Raw{};
      }
    };
    // the first step is read before the row's length is known
    if (warp < np * spp) issue(warp, kr, vr, kmul, vmul);
    for (int t = warp; t < n_steps; t += kDecWarps) {
      Raw kn[kKeysPerLane], vn[kKeysPerLane];
      float kmn = p.sm_scale, vmn = 1.f;
      if (t + kDecWarps < n_steps) issue(t + kDecWarps, kn, vn, kmn, vmn);
      const int j = j0 + t / spp, off = (t % spp) * kstep;
      float sc[kKeysPerLane][RG];
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        float kf[VN];
        unpack<PT>(kf, kr[u]);
        const int kin = off + u * G + grp;
        const bool ok = kin < pg && j * pg + kin < key_hi;
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < VN; ++i) dot = fmaf(q[r][i], kf[i], dot);
          for (int o = 1; o < Lk; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
          sc[u][r] = ok ? dot * kmul : -CUDART_INF_F;
        }
      }
#pragma unroll
      for (int r = 0; r < RG; ++r) {
        float mx = sc[0][r];
#pragma unroll
        for (int u = 1; u < kKeysPerLane; ++u) mx = fmaxf(mx, sc[u][r]);
        for (int o = Lk; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = m[r] > -CUDART_INF_F ? expf(m[r] - m_new) : 0.f;
        m[r] = m_new;
        den[r] *= alpha;
#pragma unroll
        for (int i = 0; i < VN; ++i) acc[r][i] *= alpha;
#pragma unroll
        for (int u = 0; u < kKeysPerLane; ++u) {
          const float pu = sc[u][r] > -CUDART_INF_F ? expf(sc[u][r] - m_new) : 0.f;
          den[r] += pu;  // den sums the unrounded p
          // bf16 pages: p rounded to V's dtype; int8: p unrounded, times
          // the page's V scale
          float pv = pu * vmul;
          if constexpr (!kQuant) pv = rnd<PT>(pu);
          float vf[VN];
          unpack<PT>(vf, vr[u]);
#pragma unroll
          for (int i = 0; i < VN; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i]);
        }
      }
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        kr[u] = kn[u];
        vr[u] = vn[u];
      }
      kmul = kmn;
      vmul = vmn;
    }

    // the warp's partial: den and acc summed over the lane groups
#pragma unroll
    for (int r = 0; r < RG; ++r) {
      for (int o = Lk; o < 32; o <<= 1) {
        den[r] += __shfl_xor_sync(0xffffffffu, den[r], o);
#pragma unroll
        for (int i = 0; i < VN; ++i) acc[r][i] += __shfl_xor_sync(0xffffffffu, acc[r][i], o);
      }
      if (lane == 0) {
        sh_m[warp][r] = m[r];
        sh_den[warp][r] = den[r];
      }
      if (grp == 0) {
#pragma unroll
        for (int i = 0; i < VN; ++i)
          if (d0 + i < hd) sh_acc[warp][r][d0 + i] = acc[r][i];
      }
    }
    __syncthreads();
    // the split's partial: the warps merged in order (a warp with no key
    // has m = -inf and adds nothing); with one split, the output
    for (int e = threadIdx.x; e < RG * hd; e += 32 * kDecWarps) {
      const int r = e / hd, d = e % hd;
      if (r0 + r >= rep) continue;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sh_m[w][r]);
      float dsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float f = sh_m[w][r] > -CUDART_INF_F ? expf(sh_m[w][r] - mx) : 0.f;
        dsum = fmaf(sh_den[w][r], f, dsum);
        a = fmaf(sh_acc[w][r][d], f, a);
      }
      if (p.splits == 1) {
        static_cast<T*>(p.out)[((long long)s * p.nh + g * rep + r0 + r) * hd + d] =
            from_f<T>(a / fmaxf(dsum, 1e-30f));
        continue;
      }
      if (d == 0) {
        wm[r0 + r] = mx;
        wden[r0 + r] = dsum;
      }
      wacc[(r0 + r) * hd + d] = a;  // zeros for a split with no key
    }
    __syncthreads();  // the shared partials are read before the next rows overwrite them
  }
}

// The combine: one CTA per (slot s, KV head g), a thread per (query row,
// hd element) at a time.  The row's maximum over the splits, then den and
// acc summed over the splits in order with weights exp(m_split - m_row)
// (a split with no key has m = -inf and weight 0); out = acc / max(den,
// 1e-30).  Every load of a split is independent of the others.
constexpr int kCombineRegs = 16;  // splits the combine holds in registers at once
template <typename T>
__global__ void __launch_bounds__(kThreads) rpa_combine_kernel(DecodeParams p) {
  const int g = blockIdx.x, s = blockIdx.y;
  const int rep = p.nh / p.nkv, hd = p.hd;
  const int stride = rep * (hd + 2);
  const float* part0 = p.part + ((long long)s * p.nkv + g) * p.splits * stride;
  T* out = static_cast<T*>(p.out) + ((long long)s * p.nh + g * rep) * hd;
  for (int e = threadIdx.x; e < rep * hd; e += kThreads) {
    const int r = e / hd;
    if (p.splits <= kCombineRegs) {  // every split's (m, den, acc) read in one round
      float mv[kCombineRegs], dv[kCombineRegs], av[kCombineRegs];
#pragma unroll
      for (int sp = 0; sp < kCombineRegs; ++sp) {
        const float* w = part0 + sp * stride;
        mv[sp] = sp < p.splits ? __ldg(w + r) : -CUDART_INF_F;
        dv[sp] = sp < p.splits ? __ldg(w + rep + r) : 0.f;
        av[sp] = sp < p.splits ? __ldg(w + 2 * rep + e) : 0.f;
      }
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int sp = 0; sp < kCombineRegs; ++sp) mx = fmaxf(mx, mv[sp]);
      float dsum = 0.f, a = 0.f;
#pragma unroll
      for (int sp = 0; sp < kCombineRegs; ++sp) {
        const float f = mv[sp] > -CUDART_INF_F ? expf(mv[sp] - mx) : 0.f;
        dsum = fmaf(dv[sp], f, dsum);
        a = fmaf(av[sp], f, a);
      }
      out[e] = from_f<T>(a / fmaxf(dsum, 1e-30f));
      continue;
    }
    float mx = -CUDART_INF_F;
#pragma unroll 8
    for (int sp = 0; sp < p.splits; ++sp) mx = fmaxf(mx, __ldg(part0 + sp * stride + r));
    float dsum = 0.f, a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < p.splits; ++sp) {
      const float* w = part0 + sp * stride;
      const float ms = __ldg(w + r);
      const float f = ms > -CUDART_INF_F ? expf(ms - mx) : 0.f;
      dsum = fmaf(__ldg(w + rep + r), f, dsum);
      a = fmaf(__ldg(w + 2 * rep + e), f, a);
    }
    out[e] = from_f<T>(a / fmaxf(dsum, 1e-30f));
  }
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
  attend<T, PT>(sm, nrows, static_cast<const T*>(p.q), static_cast<T*>(p.out),
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
  const dim3 grid(p.splits, p.nkv, S);
  switch (min(rep, 4)) {  // query rows held in registers at a time
    case 1: rpa_split_kernel<T, PT, 1><<<grid, 32 * kDecWarps, 0, stream>>>(p); break;
    case 2: rpa_split_kernel<T, PT, 2><<<grid, 32 * kDecWarps, 0, stream>>>(p); break;
    case 3: rpa_split_kernel<T, PT, 3><<<grid, 32 * kDecWarps, 0, stream>>>(p); break;
    default: rpa_split_kernel<T, PT, 4><<<grid, 32 * kDecWarps, 0, stream>>>(p); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  rpa_combine_kernel<T><<<dim3(p.nkv, S), kThreads, 0, stream>>>(p);
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
// the decode's split count for S slots, nkv KV heads and W pages a slot
// (the wrapper's rpa_splits is held to it)
extern "C" int mdt_rpa_splits(int S, int nkv, int W) { return rpa_splits(S, nkv, W); }

// Both return a cudaError_t (0 on success).  dtype: 0 = float32, 1 =
// bfloat16 (q, chunk K/V, output); page_dtype: the same code as dtype, or
// 2 = int8, which takes the scale pointers (null for the other pages).
// The decode also takes its fp32 workspace, splits * S * nh * (hd + 2)
// floats (unused with one split), and the split count it was sized for:
// the rule's (mdt_rpa_splits) for S rows, or for another row count (the
// serving engine's compacted tick passes its capacity's, so each row of a
// narrow launch is split, and so summed, as in the full one).  It is
// refused unless it cuts the W pages into ranges of whole pages with none
// empty.  It launches the walk, then, with more than one split, the
// combine.
extern "C" int mdt_rpa_fwd(const void* q, const void* k_pages, const void* v_pages,
                           const int* table, const int* kv_len, const float* k_scale,
                           const float* v_scale, void* out, float* part, int S,
                           int nh, int nkv, int hd, int pg, int W, int splits, long long q_ss,
                           long long q_sh, float sm_scale, int dtype, int page_dtype,
                           void* stream) {
  const int pps = splits > 0 ? (W + splits - 1) / splits : 0;  // pages a range
  if (!shape_ok(nh, nkv, hd, pg) || S < 1 || W < 1 ||
      (k_scale == nullptr) != (v_scale == nullptr) || splits < 1 || splits > W ||
      (W + pps - 1) / pps != splits)
    return (int)cudaErrorInvalidValue;
  DecodeParams p{q,        k_pages, v_pages, table, kv_len,  out,   S,    nh,
                 nkv,      hd,      pg,      W,     q_ss,    q_sh,  sm_scale,
                 k_scale,  v_scale, part,    pps,   splits};
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
