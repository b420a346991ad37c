// Routed MoE expert GEMM: one launch for all experts of a W8A8 stack, on
// the H100's int8 tensor cores.
//
// Replaces src/repro/kernels/ops.py:quant_expert_gemm, a Python loop over
// the E experts of the Pallas quant_linear kernel
// (src/repro/kernels/quant_linear.py:quant_linear). For each expert e,
// the G x C routed rows of the int8 codes (G, E, C, D), row (g, c) at
// offset ((g E + e) C + c) D, are multiplied by w_q[e] (D, F) int8 with
// int32 sums, and the epilogue writes acc * (x_scale * w_scale[e, n]) as
// float32 (G, E, C, F): quant_linear's epilogue, in its order. x_scale is
// per expert (E,) (static scales; a scalar plan scale arrives broadcast)
// or per row (G E C,) (per-token scales from dynamic_quant, which quantized
// the whole routed buffer in one launch before this one, as the JAX
// wrapper quantizes it in one op).
//
// Bound on the H100: at decode (8 slots: G = 1, C = 3, E = 8) the int8
// weight stack, E D F bytes (805 MB for mixtral-8x22b's 6144 x 16384
// experts), over 3.35 TB/s: about 0.24 ms a GEMM; the operations (2 G C D F
// E int8) are 100x below that. At a (4, 128) forward (C = 160) the bytes
// still bound it.
//
// Design: the stack is int8_mma.cuh's GEMM with the expert on blockIdx.z
// and the routed row map, so one launch covers it. At G C <= 32 (decode)
// the weight stream: the product runs transposed, y^T = w[e]^T x^T, with
// mma.sync.m16n8k32 s8, w read once in 16-byte cp.async copies into a ring
// of 4 stages of 64 x 64 bytes, 3 in flight a block, transposed in
// registers with __byte_perm on XOR-swizzled stages; a block takes one
// expert's 64 columns and a range of D. At the served stacks the experts'
// column tiles alone make 768 (16384 x 6144) and 2048 (6144 x 16384)
// blocks, 6-16 a SM, so D is not split there; a narrow stack splits D into
// int32 atomics in a workspace, and the last block of a tile applies the
// epilogue once. Past 32 rows (a forward's capacity) each expert runs the
// tiled kernel, w read once per 128 (or 64) rows.
#include "int8_mma.cuh"

// names this file's kernels in a profile
// (int8_gemm_small<quant_expert_gemm_kernel, ...>, int8_gemm_large<...>)
// and says whether they run a routed stack
struct quant_expert_gemm_kernel {
  static constexpr bool routed = true;
};

// Blocks over D the kernel takes for E stacked (G C, D) @ (D, F) products.
// The wrapper passes this count, with an int32 workspace of
// E (G C F + ceil(F / 64)) zeros when it is over 1.
extern "C" int samp_quant_expert_gemm_splits(int rows, int F, int D, int E) {
  int per;
  return split_plan(rows, F, D, E, per);
}

// x_q (G, E, C, D) int8; w_q (E, D, F) int8; w_scale (E, F) float32;
// x_scale (E,) float32 (xs_per_row 0) or (G E C,) (xs_per_row 1); out
// (G, E, C, F) float32; splits: samp_quant_expert_gemm_splits(G C, F, D,
// E), work its workspace (or null at 1 split).
extern "C" int samp_quant_expert_gemm(const void* x_q, const void* w_q,
                                      const void* w_scale,
                                      const void* x_scale, int xs_per_row,
                                      void* out, void* work, int G, int E,
                                      int C, int D, int F, int splits,
                                      void* stream) {
  if (G <= 0 || E <= 0 || C <= 0 || F <= 0) return (int)cudaGetLastError();
  const Epilogue<true> ep{
      (const float*)w_scale, (const float*)x_scale, xs_per_row,
      nullptr,               nullptr,
      (float*)out,           nullptr,
      G * C,                 F,
      0,                     Routing{C, E},
      !xs_per_row,           0};
  const int vec = D % 16 == 0 && F % 16 == 0 &&
                  ((uintptr_t)x_q | (uintptr_t)w_q) % 16 == 0;
  return int8_gemm<quant_expert_gemm_kernel>(
      (const int8_t*)x_q, (const int8_t*)w_q, ep, D, E, splits, (int*)work,
      vec, (cudaStream_t)stream);
}

// The accumulator mode: acc (G, E, C, F) int32 = x_q (G, E, C, D) @ w_q[e]
// for each expert, with no epilogue. Per-expert tensor parallelism splits
// a row-parallel stack's D (the hidden units of wd) over its ranks; each
// rank's partial accumulator is summed across them (integer sums are
// exact) before the dequantizing epilogue runs, so the sharded stack equals
// the whole one bit for bit. splits and work as samp_quant_expert_gemm's.
extern "C" int samp_quant_expert_gemm_acc(const void* x_q, const void* w_q,
                                          void* acc, void* work, int G, int E,
                                          int C, int D, int F, int splits,
                                          void* stream) {
  if (G <= 0 || E <= 0 || C <= 0 || F <= 0) return (int)cudaGetLastError();
  const Epilogue<true> ep{
      nullptr, nullptr, 0, nullptr, nullptr, nullptr, nullptr,
      G * C,   F,       0, Routing{C, E},   0,       0,
      (int*)acc};
  const int vec = D % 16 == 0 && F % 16 == 0 &&
                  ((uintptr_t)x_q | (uintptr_t)w_q) % 16 == 0;
  return int8_gemm<quant_expert_gemm_kernel>(
      (const int8_t*)x_q, (const int8_t*)w_q, ep, D, E, splits, (int*)work,
      vec, (cudaStream_t)stream);
}
