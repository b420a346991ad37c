// W8A8 GEMM with int32 accumulation and a fused epilogue.
//
// Replaces src/repro/kernels/quant_linear.py:quant_linear (the Pallas
// _kernel): y = act(acc * (x_scale * w_scale) + bias) with
// acc = x_q (M, K) int8 @ w_q (K, N) int8 in int32, written as float32, or
// requantized to int8 as clip(rint(y / out_scale)) when out_scale is given.
// x_scale is one scalar (static per-tensor) or one per row (per-token, from
// dynamic_quant); act is none / silu / tanh-GELU / relu.
//
// Bound on the H100: at the serving shapes (M = batch x length up to a few
// thousand, K, N in {768, 3072}) the int8 operations (2MNK over 1979 TOP/s)
// and the bytes (M*K + K*N in, 4*M*N out, over 3.35 TB/s) give bounds of the
// same order, a few microseconds. This first kernel is far from both: it
// runs on the CUDA cores with __dp4a, not on the int8 tensor cores (wgmma
// s8 -> s32 is the later, fast version).
//
// Design: a 64 x 64 output tile per block of 256 threads, each thread
// owning a 4 x 4 register tile of int32 sums. The TPU kernel carried the
// sum across a sequential K grid axis in VMEM scratch; a CUDA grid has no
// sequential axis, so each block loops over K itself, staging 64 x 32 byte
// tiles of x and w in shared memory. w is transposed on the way in so that
// four consecutive k of one column pack into one 32-bit word, the operand
// layout __dp4a needs. The epilogue applies dequantization, bias and the
// activation in registers before the single write, in the JAX kernel's
// order: acc * (x_scale * w_scale), then + bias, then act. Division and
// tanhf are IEEE / full precision (no fast math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;            // bytes of K per stage
constexpr int kKW = kBK / 4;       // packed 32-bit words per tile row
constexpr int kThreads = 256;

__device__ __forceinline__ float activation(float y, int act) {
  switch (act) {
    case 1:  // silu: x * sigmoid(x)
      return y * (1.0f / (1.0f + expf(-y)));
    case 2: {  // tanh-approximate GELU, as jax.nn.gelu(approximate=True)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      const float cube = (y * y) * y;
      const float cdf = 0.5f * (1.0f + tanhf(k * (y + 0.044715f * cube)));
      return y * cdf;
    }
    case 3:  // relu
      return fmaxf(y, 0.0f);
    default:
      return y;
  }
}

__device__ __forceinline__ unsigned pack4(const int8_t* p) {
  return (unsigned)(uint8_t)p[0] | ((unsigned)(uint8_t)p[1] << 8) |
         ((unsigned)(uint8_t)p[2] << 16) | ((unsigned)(uint8_t)p[3] << 24);
}

__global__ void __launch_bounds__(kThreads)
quant_linear_kernel(const int8_t* __restrict__ xq,
                    const int8_t* __restrict__ wq,
                    const float* __restrict__ w_scale,
                    const float* __restrict__ x_scale, int xs_stride,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_scale,
                    float* __restrict__ out_f, int8_t* __restrict__ out_q,
                    int M, int N, int K, int act, int vec_x) {
  __shared__ int As[kBM][kKW + 1];   // +1 word: no bank conflicts by row
  __shared__ int Bs[kBN][kKW + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // loader roles: 8 bytes of one x row, 8 k of one w column per thread
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 8;
  const int b_col = tid & 63;
  const int b_k = (tid >> 6) * 8;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {
      const int m = m0 + a_row;
      const int k = k0 + a_k;
      unsigned w0 = 0u, w1 = 0u;
      if (m < M) {
        const int8_t* src = xq + (long long)m * K + k;
        if (vec_x && k < K) {
          const int2 v = *reinterpret_cast<const int2*>(src);
          w0 = (unsigned)v.x;
          w1 = (unsigned)v.y;
        } else if (!vec_x) {
          int8_t b[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b[e] = (k + e < K) ? src[e] : (int8_t)0;
          w0 = pack4(b);
          w1 = pack4(b + 4);
        }
      }
      As[a_row][a_k / 4] = (int)w0;
      As[a_row][a_k / 4 + 1] = (int)w1;
    }
    {
      const int n = n0 + b_col;
      const int k = k0 + b_k;
      int8_t b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        b[e] = (n < N && k + e < K) ? wq[(long long)(k + e) * N + n] : (int8_t)0;
      Bs[b_col][b_k / 4] = (int)pack4(b);
      Bs[b_col][b_k / 4 + 1] = (int)pack4(b + 4);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKW; ++kk) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float os = out_q != nullptr ? *out_scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float xs = x_scale[(long long)m * xs_stride];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float y = (float)acc[i][j] * (xs * w_scale[n]);
      y = y + (bias != nullptr ? bias[n] : 0.0f);
      y = activation(y, act);
      if (out_q != nullptr) {
        const float c = fminf(fmaxf(rintf(y / os), -128.0f), 127.0f);
        out_q[(long long)m * N + n] = (int8_t)(int)c;
      } else {
        out_f[(long long)m * N + n] = y;
      }
    }
  }
}

}  // namespace

// x_q (M, K), w_q (K, N) int8; w_scale (N,) float32; x_scale: 1 value
// (xs_stride 0) or M values (xs_stride 1); bias (N,) or null; out_scale a
// device scalar or null. Exactly one of out_f (M, N) float32 / out_q (M, N)
// int8 is non-null. act: 0 none, 1 silu, 2 gelu (tanh), 3 relu. vec_x: x_q
// rows may be read 8 bytes at a time (K % 8 == 0 and x_q 8-byte aligned).
extern "C" int samp_quant_linear(const void* x_q, const void* w_q,
                                 const void* w_scale, const void* x_scale,
                                 int xs_stride, const void* bias,
                                 const void* out_scale, void* out_f,
                                 void* out_q, int M, int N, int K, int act,
                                 int vec_x, void* stream) {
  if (M > 0 && N > 0) {
    const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    quant_linear_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x_q, (const int8_t*)w_q, (const float*)w_scale,
        (const float*)x_scale, xs_stride, (const float*)bias,
        (const float*)out_scale, (float*)out_f, (int8_t*)out_q, M, N, K, act,
        vec_x);
  }
  return (int)cudaGetLastError();
}
