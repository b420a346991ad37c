// W8A8 GEMM with int32 accumulation and a fused epilogue, on the H100's
// int8 tensor cores.
//
// Replaces src/repro/kernels/quant_linear.py:quant_linear (the Pallas
// _kernel): y = act(acc * (x_scale * w_scale) + bias) with
// acc = x_q (M, K) int8 @ w_q (K, N) int8 in int32, written as float32, or
// requantized to int8 as clip(rint(y / out_scale)) when out_scale is given.
// x_scale is one scalar (static per-tensor) or one per row (per-token, from
// dynamic_quant); act is none / silu / tanh-GELU / relu.
//
// Bound on the H100: at decode (M = 8) the weight bytes, K * N over 3.35
// TB/s (1.3 us for 896 x 4864); at the encoder's M = 1024 the int8
// operations and the bytes are of the same order, a few microseconds
// (2 M N K over 1979 TOP/s; M K + K N in, 4 M N out).
//
// Design: int8_mma.cuh, shared with the routed expert GEMM
// (quant_expert_gemm.cu): mma.sync.m16n8k32 fed by 16-byte cp.async rings,
// w transposed in registers with __byte_perm; for M <= 32 the product runs
// transposed, y^T = w^T x^T, as a weight stream split over K with int32
// atomics and one epilogue by the last block of a column tile; above, 128 x
// 128 or 64 x 64 output tiles with the epilogue on whole rows.
#include "int8_mma.cuh"

// names this file's kernels in a profile (int8_gemm_small<quant_linear_kernel,
// ...>, int8_gemm_large<...>) and says whether they run a routed stack
struct quant_linear_kernel {
  static constexpr bool routed = false;
};

// Blocks over K the kernel takes for (M, N, K); 1 when M > 32 (the
// large-M kernel does not split). The wrapper passes this count, with an
// int32 workspace of M * N + ceil(N / 64) zeros (the partial sums, then
// one counter a 64-column tile) when it is over 1.
extern "C" int samp_quant_linear_splits(int M, int N, int K) {
  int per;
  return split_plan(M, N, K, 1, per);
}

// x_q (M, K), w_q (K, N) int8; w_scale (N,) float32; x_scale: 1 value
// (xs_stride 0) or M values (xs_stride 1); bias (N,) or null; out_scale a
// device scalar or null. Exactly one of out_f (M, N) float32 / out_q (M, N)
// int8 is non-null. act: 0 none, 1 silu, 2 gelu (tanh), 3 relu. splits:
// samp_quant_linear_splits(M, N, K); work: M * N + ceil(N / 64) int32
// zeros when splits > 1, else unused.
extern "C" int samp_quant_linear(const void* x_q, const void* w_q,
                                 const void* w_scale, const void* x_scale,
                                 int xs_stride, const void* bias,
                                 const void* out_scale, void* out_f,
                                 void* out_q, void* work, int M, int N, int K,
                                 int act, int splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  // one product: no experts, row m at row m
  const Epilogue<false> ep{
      (const float*)w_scale, (const float*)x_scale, xs_stride,
      (const float*)bias,    (const float*)out_scale,
      (float*)out_f,         (int8_t*)out_q,
      M,                     N,
      act,                   Routing{0, 1},
      0,                     0,
      nullptr};
  const int vec = K % 16 == 0 && N % 16 == 0 &&
                  ((uintptr_t)x_q | (uintptr_t)w_q) % 16 == 0;
  return int8_gemm<quant_linear_kernel>(
      (const int8_t*)x_q, (const int8_t*)w_q, ep, K, 1, splits, (int*)work,
      vec, (cudaStream_t)stream);
}

// The accumulator mode: acc (M, N) int32 = x_q (M, K) @ w_q (K, N), with no
// epilogue. A tensor-parallel mesh splits a row-parallel GEMM's K over its
// ranks; each rank's partial accumulator is summed across them (integer
// sums are exact) before the epilogue runs, so the sharded layer equals the
// whole one bit for bit. splits and work as samp_quant_linear's.
extern "C" int samp_quant_linear_acc(const void* x_q, const void* w_q,
                                     void* acc, void* work, int M, int N,
                                     int K, int splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  const Epilogue<false> ep{
      nullptr, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
      M,       N,       0, Routing{0, 1},   0,       0,
      (int*)acc};
  const int vec = K % 16 == 0 && N % 16 == 0 &&
                  ((uintptr_t)x_q | (uintptr_t)w_q) % 16 == 0;
  return int8_gemm<quant_linear_kernel>(
      (const int8_t*)x_q, (const int8_t*)w_q, ep, K, 1, splits, (int*)work,
      vec, (cudaStream_t)stream);
}
