// RMSNorm kernels of the port whose reduction order does not depend on the
// row count: the residual add + RMSNorm (``add_rms_norm``, and
// ``rms_norm`` with no residual) and the gated RMSNorm (``rms_norm_gated``)
// of ops/norm.py, and the sum of squares of a gated row's part that a
// serving mesh's model rank holds (``rms_norm_gated_sumsq``).
//
// Replaces no TPU kernel: the JAX package leaves these norms to XLA
// (mamba_distributed_tpu/ops/norm.py).  They were added because PyTorch's
// own row reductions pick their thread layout from the number of rows, so
// a row's statistics, and with them its bf16 output, could change with
// the batch it rode in: a compacted decode tick (fewer lanes) then parted
// from the full-width tick by one bf16 ulp on some rows.  Here every row
// (for the gated norm: every (row, group)) is one CTA of ``kThreads``
// threads; thread i sums the squares of elements i, i + kThreads, ... in
// index order, a fixed xor butterfly reduces each warp, and warp 0 reduces
// the warps' partials the same way.  No launch parameter depends on the
// row count, so a row's output is a function of that row alone.
//
// Bound: bytes.  Each input is read once and each output written once
// (the second pass re-reads the row, which a CTA finds in L1/L2); a few
// flops an element are far below the card's rate.  A simple kernel: one
// element a thread a step, no vector loads.
//
// Types: inputs and outputs are fp32 or bf16 (a dtype code per pointer),
// the weight fp32, statistics fp32.  Inputs are (rows, d) with a row
// stride (a contiguous last axis); outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load(const void* p, int64_t i, int code) {
  return code == kF32 ? static_cast<const float*>(p)[i]
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// the value ``v`` takes when stored in the type ``code`` (x.to(dtype))
__device__ __forceinline__ float round_to(float v, int code) {
  return code == kF32 ? v : __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(void* p, int64_t i, float v, int code) {
  if (code == kF32) {
    static_cast<float*>(p)[i] = v;
  } else {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  }
}

// Sum of ``v`` over the CTA in a fixed order: an xor butterfly in each
// warp (every lane ends with the same bits), then warp 0 reduces the
// kWarps partials by the same butterfly.
__device__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? smem[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) smem[kWarps] = s;
  }
  __syncthreads();
  return smem[kWarps];
}

// r = x.to(r_code) (+ residual.to(r_code)), rounded to r_code: the
// residual stream of ops/norm.add_rms_norm
__device__ __forceinline__ float residual_at(const void* x, int64_t xi, int x_code,
                                             const void* res, int64_t ri, int res_code,
                                             int r_code) {
  float r = round_to(load(x, xi, x_code), r_code);
  if (res != nullptr) r = round_to(r + round_to(load(res, ri, res_code), r_code), r_code);
  return r;
}

// One CTA a row: out = (rms_norm(r) * w).to(r_code).to(out_code) and, when
// ``res_out`` is given, res_out = r.
__global__ void __launch_bounds__(kThreads)
add_rms_norm_kernel(const void* __restrict__ x, int64_t x_stride, int x_code,
                    const void* __restrict__ res, int64_t res_stride, int res_code,
                    const float* __restrict__ w, void* __restrict__ out, int out_code,
                    void* __restrict__ res_out, int r_code, int d, float eps) {
  __shared__ float smem[kWarps + 1];
  const int64_t row = blockIdx.x;
  const int64_t xo = row * x_stride, ro = row * res_stride, oo = row * static_cast<int64_t>(d);
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float r = residual_at(x, xo + i, x_code, res, ro + i, res_code, r_code);
    if (res_out != nullptr) store(res_out, oo + i, r, r_code);
    ss += r * r;
  }
  const float rstd = rsqrtf(block_sum(ss, smem) / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float r = residual_at(x, xo + i, x_code, res, ro + i, res_code, r_code);
    store(out, oo + i, round_to((r * rstd) * w[i], r_code), out_code);
  }
}

__device__ __forceinline__ float gated(const void* x, int64_t xi, int x_code, const void* z,
                                       int64_t zi, int z_code) {
  const float zf = load(z, zi, z_code);
  return load(x, xi, x_code) * (zf / (1.f + expf(-zf)));
}

// One CTA a (row, group): out = (rms_norm(x * silu(z)) over the group's
// ``group`` channels * w).to(out_code)
__global__ void __launch_bounds__(kThreads)
rms_norm_gated_kernel(const void* __restrict__ x, int64_t x_stride, int x_code,
                      const void* __restrict__ z, int64_t z_stride, int z_code,
                      const float* __restrict__ w, void* __restrict__ out, int out_code,
                      int d, int group, float eps) {
  __shared__ float smem[kWarps + 1];
  const int groups = d / group;
  const int64_t row = blockIdx.x / groups;
  const int c0 = static_cast<int>(blockIdx.x % groups) * group;
  const int64_t xo = row * x_stride + c0, zo = row * z_stride + c0;
  const int64_t oo = row * static_cast<int64_t>(d) + c0;
  float ss = 0.f;
  for (int i = threadIdx.x; i < group; i += kThreads) {
    const float v = gated(x, xo + i, x_code, z, zo + i, z_code);
    ss += v * v;
  }
  const float rstd = rsqrtf(block_sum(ss, smem) / static_cast<float>(group) + eps);
  for (int i = threadIdx.x; i < group; i += kThreads) {
    const float v = gated(x, xo + i, x_code, z, zo + i, z_code);
    store(out, oo + i, (v * rstd) * w[c0 + i], out_code);
  }
}

// The gated norm of a row that a serving mesh's model ranks hold a part
// each (ops/norm.gated_sum_squares): one CTA a row sums the squares of its
// part, ss[row] = sum_i (x * silu(z))_i^2, in the order above; the sum over
// the model group rides the row-parallel out_proj's (models/common).
__global__ void __launch_bounds__(kThreads)
rms_norm_gated_sumsq_kernel(const void* __restrict__ x, int64_t x_stride, int x_code,
                            const void* __restrict__ z, int64_t z_stride, int z_code,
                            float* __restrict__ ss_out, int d) {
  __shared__ float smem[kWarps + 1];
  const int64_t row = blockIdx.x;
  const int64_t xo = row * x_stride, zo = row * z_stride;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = gated(x, xo + i, x_code, z, zo + i, z_code);
    ss += v * v;
  }
  const float total = block_sum(ss, smem);
  if (threadIdx.x == 0) ss_out[row] = total;
}

bool bad_code(int code) { return code != kF32 && code != kBF16; }

}  // namespace

extern "C" {

int mdt_rms_norm_threads() { return kThreads; }

// Returns a cudaError_t (0 on success); refuses bad arguments with
// cudaErrorInvalidValue before launching.
int mdt_add_rms_norm(const void* x, long long x_stride, int x_code, const void* res,
                     long long res_stride, int res_code, const void* w, void* out, int out_code,
                     void* res_out, int r_code, long long rows, int d, float eps,
                     void* stream) {
  if (rows < 1 || d < 1 || bad_code(x_code) || bad_code(out_code) || bad_code(r_code)
      || (res != nullptr && bad_code(res_code)) || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  add_rms_norm_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, x_code, res, res_stride, res_code, static_cast<const float*>(w), out, out_code,
      res_out, r_code, d, eps);
  return cudaGetLastError();
}

int mdt_rms_norm_gated(const void* x, long long x_stride, int x_code, const void* z,
                       long long z_stride, int z_code, const void* w, void* out, int out_code,
                       long long rows, int d, int group, float eps, void* stream) {
  if (rows < 1 || d < 1 || group < 1 || d % group || bad_code(x_code) || bad_code(z_code)
      || bad_code(out_code) || rows * (d / group) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  rms_norm_gated_kernel<<<static_cast<unsigned>(rows * (d / group)), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, x_code, z, z_stride, z_code, static_cast<const float*>(w), out, out_code, d,
      group, eps);
  return cudaGetLastError();
}

int mdt_rms_norm_gated_sumsq(const void* x, long long x_stride, int x_code, const void* z,
                             long long z_stride, int z_code, void* ss, long long rows, int d,
                             void* stream) {
  if (rows < 1 || d < 1 || bad_code(x_code) || bad_code(z_code) || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  rms_norm_gated_sumsq_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      x, x_stride, x_code, z, z_stride, z_code, static_cast<float*>(ss), d);
  return cudaGetLastError();
}

}  // extern "C"
