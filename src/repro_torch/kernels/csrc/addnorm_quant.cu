// Fused residual add + bias + LayerNorm/RMSNorm + int8 requantization.
//
// Replaces src/repro/kernels/addnorm_quant.py:addnorm_quant (the Pallas
// _kernel). Per row of D:
//   h = x * x_in_scale + residual + bias        (written out: the residual)
//   y = layernorm(h) * gamma + beta   or   rmsnorm(h) * gamma   (eps 1e-6)
//   q = clip(rint(y / x_scale), -128, 127)      (feeds the next quant GEMM)
// x arrives as float32 or as int8 codes (dequantized by x_in_scale).
//
// Bound on the H100: bytes. Per element it reads x and the residual and
// writes h and q (13 bytes for float x) against some ten operations.
//
// Design: one block of 256 threads per row. The row's h lives in shared
// memory between the passes, so device memory sees each input once: pass 1
// forms h and its sum, pass 2 the sum of squared deviations from the mean
// (the two-pass variance the JAX kernel computes, in float32), pass 3 the
// normalized, requantized codes. 1/sqrtf is correctly rounded here (no fast
// math), which can differ from XLA's rsqrt in the last ulp; that moves a few
// codes at rounding ties, inside the kernel's stated budget.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Every thread returns the same block sum (the per-warp partials are added
// in one fixed order by all threads).
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

__global__ void __launch_bounds__(kThreads)
addnorm_quant_kernel(const float* __restrict__ x_f32,
                     const int8_t* __restrict__ x_i8,
                     const float* __restrict__ residual,
                     const float* __restrict__ bias,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ x_scale,
                     const float* __restrict__ x_in_scale,
                     float* __restrict__ h_out, int8_t* __restrict__ q_out,
                     int D, int rms, float eps) {
  extern __shared__ float hs[];   // D floats of h, then the reduction words
  float* red = hs + D;
  const long long base = (long long)blockIdx.x * D;
  const float xs_in = x_in_scale != nullptr ? *x_in_scale : 1.0f;

  float part = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float xv = x_i8 != nullptr ? (float)x_i8[base + i] : x_f32[base + i];
    const float h = (xv * xs_in + residual[base + i]) + bias[i];
    hs[i] = h;
    h_out[base + i] = h;
    part += rms ? h * h : h;
  }
  float mu = 0.0f, var;
  if (rms) {
    var = block_sum(part, red) / (float)D;
  } else {
    mu = block_sum(part, red) / (float)D;
    float sq = 0.0f;
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float d = hs[i] - mu;
      sq += d * d;
    }
    var = block_sum(sq, red) / (float)D;
  }
  const float r = 1.0f / sqrtf(var + eps);
  const float s = *x_scale;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float y;
    if (rms) {
      y = (hs[i] * r) * gamma[i];
    } else {
      y = ((hs[i] - mu) * r) * gamma[i] + (beta != nullptr ? beta[i] : 0.0f);
    }
    const float c = fminf(fmaxf(rintf(y / s), -128.0f), 127.0f);
    q_out[base + i] = (int8_t)(int)c;
  }
}

}  // namespace

// x: (M, D) float32 (x_is_int8 = 0) or int8 (x_is_int8 = 1); residual, h:
// (M, D) float32; bias, gamma: (D,); beta: (D,) or null; x_scale: device
// scalar; x_in_scale: device scalar or null (1.0); q: (M, D) int8.
extern "C" int samp_addnorm_quant(const void* x, int x_is_int8,
                                  const void* residual, const void* bias,
                                  const void* gamma, const void* beta,
                                  const void* x_scale, const void* x_in_scale,
                                  void* h, void* q, int M, int D, int rms,
                                  float eps, void* stream) {
  if (M > 0 && D > 0) {
    const size_t smem = (size_t)D * sizeof(float) + (kThreads / 32) * sizeof(float);
    addnorm_quant_kernel<<<M, kThreads, smem, (cudaStream_t)stream>>>(
        x_is_int8 ? nullptr : (const float*)x,
        x_is_int8 ? (const int8_t*)x : nullptr, (const float*)residual,
        (const float*)bias, (const float*)gamma, (const float*)beta,
        (const float*)x_scale, (const float*)x_in_scale, (float*)h,
        (int8_t*)q, D, rms, eps);
  }
  return (int)cudaGetLastError();
}
