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
// bf16 result differs from the JAX kernel's only by summation order.  The
// exponent of L is evaluated only where i >= j: e^(a_i - a_j) with i < j
// may overflow, and inf * 0 would be NaN.  Heads read the B and C rows of
// their group (group h * g / nheads) in place, with no repeat in memory;
// x, B and C are read through their batch/time/head strides, so slices of
// the conv output need no copy.
//
// Two designs; one rule picks between them (uses_tc here,
// ssd_kernels.ssd_uses_tensor_cores in the wrapper): bf16 with p = 64 and
// n = 64 or 128 (the presets' (64, 128) among them) runs the tensor-core
// kernel, every other call (fp32, other shapes) the CUDA-core kernel.
//
// * Tensor cores (ssd_fwd_tc_kernel, hopper.cuh's building blocks).  Grid
//   (row blocks, heads, batch): a CTA owns one 64-row block i of every
//   chunk's output, so a 256-token chunk runs on four CTAs per (batch,
//   head): 96 CTAs for one mamba2-280m prompt, 3,072 at the trainer's
//   batch of 32.  A CTA is one consumer warpgroup and one producer warp
//   whose lane 0 copies, by TMA over strided 4-D maps of x, B and C, the
//   block's C tile once per chunk and the chunk's (B_j, x_j) tiles of 64
//   rows through a two-stage mbarrier ring.  Per chunk the consumers
//   compute a, e^a and w = dt e^(a_L - a) into shared memory, then
//     y_i  = round(C_i e^a) round(S)^T           wgmma, both from shared memory
//     for each row block j (all of them):
//       j <= i:  G = C_i B_j^T                   wgmma, both from shared memory
//                M = round(mask(G e^(a_r - a_c)))  registers, mask before exp
//                y_i += M round(x_j dt)          M the register A operand
//       S += round(x_j)^T round(B_j w)           wgmma, both operands MN-major
//   with S scaled by e^(a_L) before the first j.  The rounded products
//   (C e^a, x dt, B w, round(S)) are written by the consumers into one
//   swizzled scratch tile (Tile::chunk_offset, fence.proxy.async, the
//   warpgroup barrier) in turn.  S lives in the consumers' registers as
//   the fp32 accumulator of its product, so it never leaves the chip.
//   Every CTA of a (batch, head) computes the whole state itself, the same
//   instructions on the same data, so all hold it bit for bit alike and
//   no CTA waits for another; row block 0 writes the final state.  Tiles
//   that reach past the chunk (l not a multiple of 64) or past t (zeros
//   from TMA) meet zeros in x dt and B w, and their output rows are not
//   written.
// * CUDA cores (ssd_fwd_kernel): one CTA of 256 threads per (batch, head)
//   with the chunk loop inside; the l x l product tiled into 64-row blocks
//   in shared memory as fp32 (about 131 KB at p = 64, n = 128), fp32 FMAs.
//
// Bound on the H100.  Per chunk and head the work is about
// l^2 (n + p) / 2 + 2 l p n multiply-adds against l (p + 2n) input and
// l p output elements: at l = 256 in bf16 about 150 operations per byte,
// below the card's ~295 bf16 tensor-core operations per byte, so the
// least time is set by the bytes (about 1 us for one 256-token chunk of
// all 24 heads of mamba2-280m, 0.07 ms at the trainer's batch of 32).
// The tensor-core kernel does more than that minimum: each CTA recomputes
// the whole state product (4x at l = 256) and reads every (B_j, x_j) tile
// of its chunk from L2, and the warpgroup waits on each product before the
// next (PERF.md has its times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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


// ============================================= tensor-core kernel (bf16)

// The one dispatch rule, here and in the Python wrapper
// (ssd_kernels.ssd_uses_tensor_cores): bf16 with headdim 64 and d_state 64
// or 128 runs ssd_fwd_tc_kernel; every other call the CUDA-core kernel.
bool uses_tc(int dtype, int p, int n) { return dtype == 1 && p == 64 && (n == 64 || n == 128); }

struct TcMaps {
  CUtensorMap x, B, C;
};

constexpr int kTcP = 64;  // headdim of the tensor-core kernel

template <int N> struct TcLayout {
  using CT = Tile<N, kWgRows>;     // 64 rows x n: C_i, B_j, C e^a, B w, and round(S) (p rows)
  using XT = Tile<kTcP, kWgRows>;  // 64 rows x p: x_j, x_j dt
  static constexpr int RING = CT::BYTES;                  // C_i, then stage s: B_j, x_j
  static constexpr int STAGE = CT::BYTES + XT::BYTES;
  static constexpr int SCR = RING + kStages * STAGE;      // the consumers' scratch tile
  static constexpr int SB = SCR + CT::BYTES;              // round(S)
  static constexpr int ARR = SB + CT::BYTES;              // a, dt, e^a, w; scan partials
  static constexpr int BARS = ARR + (4 * kMaxChunk + 8) * 4;  // c_full, c_empty, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (2 + 2 * kStages) + 1024;  // + alignment slack
};

// round(S) from the accumulator fragments (rows r0 + 8 i, columns 8 j + c0
// + {0, 1}) into the swizzled tile at sb
template <int N>
__device__ __forceinline__ void store_state_bf16(uint8_t* sb, const float (&S)[N / 2], int r0,
                                                 int c0) {
  using CT = Tile<N, kWgRows>;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<uint32_t*>(sb + CT::chunk_offset(r0 + 8 * i, 8 * j) + 2 * c0) =
          pack_bf16(S[4 * j + 2 * i], S[4 * j + 2 * i + 1]);
  fence_async_smem();  // read by the next chunk's wgmma
}

// grid (row blocks, heads, batch), the last row block first (it has the
// most column blocks); see the header for the design
template <int N>
__global__ void __launch_bounds__(kTcThreads)
    ssd_fwd_tc_kernel(const __grid_constant__ TcMaps maps, const Params prm) {
  using L = TcLayout<N>;
  using CT = typename L::CT;
  using XT = typename L::XT;
  constexpr int P = kTcP;
  extern __shared__ float smem[];  // as the CUDA-core kernel declares it
  uint8_t* base = align1024(reinterpret_cast<uint8_t*>(smem));
  uint8_t* Cs = base;
  uint8_t* ring = base + L::RING;
  uint8_t* scr = base + L::SCR;
  uint8_t* Sb = base + L::SB;
  float* as = reinterpret_cast<float*>(base + L::ARR);
  float* dts = as + kMaxChunk;
  float* es = dts + kMaxChunk;
  float* ws = es + kMaxChunk;
  float* part = ws + kMaxChunk;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + L::BARS);
  uint64_t* c_empty = c_full + 1;
  uint64_t* full = c_empty + 1;
  uint64_t* empty = full + kStages;

  const int l = prm.chunk, nc = prm.seqlen / l;
  const int nrb = (l + kWgRows - 1) / kWgRows;
  const int ib = nrb - 1 - blockIdx.x;  // this CTA's row block
  const int h = blockIdx.y, bi = blockIdx.z;
  const int grp = h * prm.ngroups / prm.nheads;

  if (threadIdx.x == 0) {
    mbar_init(c_full, 1);
    mbar_init(c_empty, 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      int n = 0;  // ring tiles issued
      for (int c = 0; c < nc; ++c) {
        const int t0 = c * l;
        if (c > 0) mbar_wait(c_empty, (c - 1) & 1);
        mbar_expect_tx(c_full, CT::BYTES);
        for (int q = 0; q < CT::NP; ++q)
          tma_load(Cs + q * CT::PANEL_B, &maps.C, c_full, q * CT::PW, t0 + ib * kWgRows, grp, bi);
        for (int j = 0; j < nrb; ++j, ++n) {
          const int s = n % kStages;
          if (n >= kStages) mbar_wait(empty + s, (n / kStages - 1) & 1);
          uint8_t* st = ring + s * L::STAGE;
          mbar_expect_tx(full + s, L::STAGE);
          for (int q = 0; q < CT::NP; ++q)
            tma_load(st + q * CT::PANEL_B, &maps.B, full + s, q * CT::PW, t0 + j * kWgRows, grp,
                     bi);
          tma_load(st + CT::BYTES, &maps.x, full + s, 0, t0 + j * kWgRows, h, bi);
        }
      }
    }
    return;
  }

  // consumer warpgroup: this thread holds rows r0 and r0 + 8 of each 64-row
  // fragment, columns 8 j + c0 + {0, 1} of each 8-column block j
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  const float A = prm.A[h];
  const float* DT = prm.dt + bi * prm.dt_sb + h * prm.dt_sh;
  __nv_bfloat16* Y =
      static_cast<__nv_bfloat16*>(prm.y) + ((long long)bi * prm.seqlen * prm.nheads + h) * P;
  const long long y_st = (long long)prm.nheads * P;
  const long long st_off = ((long long)bi * prm.nheads + h) * P * N;
  const uint32_t c_addr = smem_u32(Cs), scr_addr = smem_u32(scr), sb_addr = smem_u32(Sb);

  // the carried state (p rows x n), fp32: the accumulator of S += x^T (B w)
  float S[N / 2];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        S[4 * j + 2 * i + e] =
            prm.h0 ? prm.h0[st_off + (r0 + 8 * i) * N + 8 * j + c0 + e] : 0.f;
  store_state_bf16<N>(Sb, S, r0, c0);

  int n = 0;  // ring tiles consumed
  for (int c = 0; c < nc; ++c) {
    const long long t0 = (long long)c * l;
    // dt and a = cumsum(dt A) over the chunk, two rows a thread; rows past
    // l get dt 0, so a stays flat there and w is 0
    const int ra = 2 * tid, rb = ra + 1;
    const float d0 = ra < l ? DT[(t0 + ra) * prm.dt_st] : 0.f;
    const float d1 = rb < l ? DT[(t0 + rb) * prm.dt_st] : 0.f;
    const float v0 = d0 * A, v1 = d1 * A;
    float incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float nb = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += nb;
    }
    wg_bar();  // the previous chunk's reads of the arrays are done
    if (lane == 31) part[warp] = incl;
    wg_bar();
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int w = 0; w < warp; ++w) excl += part[w];
    as[ra] = excl + v0;
    as[rb] = excl + v0 + v1;
    dts[ra] = d0;
    dts[rb] = d1;
    wg_bar();
    const float a_last = as[l - 1];
    es[ra] = expf(as[ra]);
    es[rb] = expf(as[rb]);
    ws[ra] = d0 * expf(a_last - as[ra]);
    ws[rb] = d1 * expf(a_last - as[rb]);
    wg_bar();

    // y = round(C_i e^a) round(S)^T
    mbar_wait(c_full, c & 1);
    for (int e = tid; e < kWgRows * N / 8; e += 128) {
      const int row = e / (N / 8), col = 8 * (e % (N / 8));
      const int off = CT::chunk_offset(row, col);
      scale_chunk(scr + off, Cs + off, es[ib * kWgRows + row]);
    }
    fence_async_smem();
    wg_bar();
    float y[P / 2];
#pragma unroll
    for (int i = 0; i < P / 2; ++i) y[i] = 0.f;
    fence_regs(y);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      wgmma_ss<P>(y, CT::kmajor(scr_addr, kk), CT::kmajor(sb_addr, kk));
    wg_commit();
    wg_wait0();
    fence_regs(y);
    const float gamma = expf(a_last);
#pragma unroll
    for (int i = 0; i < N / 2; ++i) S[i] *= gamma;
    wg_bar();  // every warp's product has read the scratch

    const float arow[2] = {as[ib * kWgRows + r0], as[ib * kWgRows + r0 + 8]};
    for (int j = 0; j < nrb; ++j, ++n) {
      const int s = n % kStages;
      uint8_t* Bs = ring + s * L::STAGE;
      uint8_t* Xs = Bs + CT::BYTES;
      mbar_wait(full + s, (n / kStages) & 1);
      if (j <= ib) {
        // G = C_i B_j^T, in flight while x_j dt is written
        float g[kWgRows / 2];
#pragma unroll
        for (int i = 0; i < kWgRows / 2; ++i) g[i] = 0.f;
        fence_regs(g);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
          wgmma_ss<kWgRows>(g, CT::kmajor(c_addr, kk), CT::kmajor(smem_u32(Bs), kk));
        wg_commit();
        for (int e = tid; e < kWgRows * P / 8; e += 128) {
          const int row = e / (P / 8), col = 8 * (e % (P / 8));
          const int off = XT::chunk_offset(row, col);
          scale_chunk(scr + off, Xs + off, dts[j * kWgRows + row]);  // 0 past l
        }
        fence_async_smem();
        wg_wait0();
        fence_regs(g);
        if (j == ib) mbar_arrive(c_empty);  // C_i is read no more this chunk
        // M = round(mask(G e^(a_row - a_col))): only the diagonal block is
        // masked (rows past l give output rows that are not written)
#pragma unroll
        for (int x = 0; x < kWgRows / 2; ++x) {
          const int i = (x / 2) % 2;
          const int col = 8 * (x / 4) + c0 + x % 2;
          float mv = 0.f;
          if (j < ib || col <= r0 + 8 * i) mv = g[x] * expf(arow[i] - as[j * kWgRows + col]);
          g[x] = mv;
        }
        uint32_t mf[kWgRows / 16][4];
        to_a_frags<kWgRows>(mf, g);
        wg_bar();  // every warp's x_j dt is written
        fence_regs(y);
        fence_regs(mf);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kWgRows / 16; ++kk) wgmma_rs<P>(y, mf[kk], XT::mnmajor(scr_addr, kk));
        wg_commit();
        wg_wait0();
        fence_regs(y);
        fence_regs(mf);
        wg_bar();  // every warp's product has read the scratch
      }
      // S += round(x_j)^T round(B_j w)
      for (int e = tid; e < kWgRows * N / 8; e += 128) {
        const int row = e / (N / 8), col = 8 * (e % (N / 8));
        const int off = CT::chunk_offset(row, col);
        scale_chunk(scr + off, Bs + off, ws[j * kWgRows + row]);  // 0 past l
      }
      fence_async_smem();
      wg_bar();
      fence_regs(S);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kWgRows / 16; ++kk)
        wgmma_ss_mn<N>(S, XT::mnmajor(smem_u32(Xs), kk), CT::mnmajor(scr_addr, kk));
      wg_commit();
      wg_wait0();
      fence_regs(S);
      mbar_arrive(empty + s);  // B_j and x_j are read no more
      wg_bar();                // every warp's product has read the scratch
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = ib * kWgRows + r0 + 8 * i;
      if (row >= l) continue;
#pragma unroll
      for (int j = 0; j < P / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(Y + (t0 + row) * y_st + 8 * j + c0) =
            __floats2bfloat162_rn(y[4 * j + 2 * i], y[4 * j + 2 * i + 1]);
    }
    store_state_bf16<N>(Sb, S, r0, c0);
  }

  if (ib == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          prm.hT[st_off + (r0 + 8 * i) * N + 8 * j + c0 + e] = S[4 * j + 2 * i + e];
  }
}

template <int N>
cudaError_t launch_tc(const Params& prm, cudaStream_t stream) {
  using L = TcLayout<N>;
  using CT = typename L::CT;
  // make_map takes (outer, head, row) element strides
  const long long xs[3] = {prm.x_sb, prm.x_sh, prm.x_st};
  const long long bs[3] = {prm.b_sb, prm.b_sg, prm.b_st};
  const long long cs[3] = {prm.c_sb, prm.c_sg, prm.c_st};
  TcMaps maps{};
  if (!make_map(&maps.x, prm.x, kTcP, prm.seqlen, prm.nheads, prm.batch, xs, L::XT::PW,
                kWgRows) ||
      !make_map(&maps.B, prm.B, N, prm.seqlen, prm.ngroups, prm.batch, bs, CT::PW, kWgRows) ||
      !make_map(&maps.C, prm.C, N, prm.seqlen, prm.ngroups, prm.batch, cs, CT::PW, kWgRows))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_tc_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  const int nrb = (prm.chunk + kWgRows - 1) / kWgRows;
  ssd_fwd_tc_kernel<N><<<dim3(nrb, prm.nheads, prm.batch), kTcThreads, L::BYTES, stream>>>(maps,
                                                                                          prm);
  return cudaGetLastError();
}

}  // namespace

// (headdim, d_state) pairs the library is built for; the Python wrapper
// checks against the same list before it launches.
extern "C" int mdt_ssd_fwd_supports(int p, int n) {
  return (p == 64 && (n == 128 || n == 64)) || (p == 32 && (n == 64 || n == 128)) ||
         (p == 128 && n == 128);
}

// 1 when a call of the dtype code, headdim and d_state runs the
// tensor-core kernel (the wrapper's ssd_uses_tensor_cores is held to it)
extern "C" int mdt_ssd_uses_tc(int dtype, int p, int n) { return uses_tc(dtype, p, n); }

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
  if (uses_tc(dtype, headdim, dstate))
    return (int)(dstate == 128 ? launch_tc<128>(prm, s) : launch_tc<64>(prm, s));
  cudaError_t err = dtype == 1 ? launch_pn<__nv_bfloat16>(prm, headdim, dstate, s)
                               : launch_pn<float>(prm, headdim, dstate, s);
  return (int)err;
}
