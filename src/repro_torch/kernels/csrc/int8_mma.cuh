// The int8 tensor-core GEMM shared by quant_linear.cu and
// quant_expert_gemm.cu: y = act(acc * (x_scale * w_scale) + bias), acc =
// x_q (M, K) int8 @ w_q (K, N) int8 in int32, written as float32, or
// requantized to int8 as clip(rint(y / out_scale)). x_scale is one scalar or
// one value per row; act is none / silu / tanh-GELU / relu.
//
// A routed stack (quant_expert_gemm) runs expert e on blockIdx.z: w_q is
// (E, K, N), w_scale (E, N), and the M = G C rows of expert e are rows
// (g, c) of the (G, E, C, K) codes, at flat row (g E + e) C + c (the
// Routing below). A plain GEMM is one product (Epilogue<false>), compiled
// without the experts' arithmetic.
//
// Every integer sum is exact (|acc| <= 16384 * 128 * 128 < 2^31), so any
// order and any split of K, int32 atomics included, give the same int32
// accumulator, and the epilogue is the only float arithmetic: the output
// cannot depend on the tiling.
//
// Both paths run mma.sync.m16n8k32 (s8 x s8 -> s32) and stream x and w
// through a ring of shared memory filled by 16-byte cp.async copies
// (zero-filled past M, N and K). The tensor cores want w K-major and w is
// (K, N) with N contiguous, so a lane reads four 32-bit words of w, the
// same 4 columns in 4 consecutive rows k, and transposes the 4 x 4 bytes
// with __byte_perm into the K-major words of 4 columns. Those 4 columns
// become the n index of 4 different mma tiles (column 4 g + c of a 32-
// column group is row g of tile c), and the output is written back through
// the same map. The stage's 16-byte chunks are XOR-swizzled by row so that
// those reads, and the ldmatrix reads of x, hit 32 distinct banks.
//  * M > 32 (prefill, encoder buckets, a forward's expert capacity):
//    128 x 128 output tiles (8 warps of 64 x 32) where they make two blocks
//    for each of the 132 SMs, else 64 x 64 (4 warps of 32 x 32: the
//    encoder's M = 1024 with N = 768 has 48 tiles of 128 x 128 and 192 of
//    64 x 64); K in stages of 64 bytes, 4 stages in flight; x fragments by
//    ldmatrix. The int32 tile goes out through shared memory, so the
//    epilogue writes whole rows. K is not split here: the M N atomics of
//    each split cost more than the blocks they add (1.4-3.4x slower at
//    M = 1024 on an H100, by tools/torch_gemm_ab.py).
//  * M <= 32 (decode, the MoE attention GEMMs, the served expert stacks):
//    the weight stream is the work. The product runs transposed,
//    y^T = w^T x^T, so the M rows are the mma's 8-wide n side (padded to 8,
//    16 or 32 in registers only) and w fills its 16-row side. A block of 4
//    warps takes 64 columns of one expert and a range of K (split-K only
//    where the experts' column tiles leave fewer than about 2 blocks per
//    SM), 4 stages of 64 x 64 bytes deep; its partial sums are added across
//    the block in shared memory, then into an int32 workspace with atomics,
//    and the last block of a column tile (a counter in the workspace)
//    applies the epilogue once.
// The epilogue applies dequantization, bias and the activation in the JAX
// kernel's order: acc * (x_scale * w_scale), then + bias, then act.
// Division and tanhf are IEEE / full precision (no fast math).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSmallM = 32;        // M <= kSmallM: the split-K stream
constexpr int kSMs = 132;

// large M: WM x WN warps, each MT m16 tiles by one 32-column group; a ring
// of 4 stages of 64 bytes of K
constexpr int LBK = 64, LST = 4;

template <int WM, int WN, int MT>
struct Large {
  static constexpr int BM = WM * MT * 16, BN = WN * 32;
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int X_BYTES = BM * LBK;   // x stage: BM rows of 64 bytes
  static constexpr int W_BYTES = LBK * BN;   // w stage: 64 rows of BN bytes
  static constexpr int RING = LST * (X_BYTES + W_BYTES);
  static constexpr int TILE = BM * (BN + 4) * 4;    // the int32 output tile
  static constexpr int SMEM = RING > TILE ? RING : TILE;
  static constexpr int X_LOADS = BM * (LBK / 16) / THREADS;  // per thread
  static_assert(BM * (LBK / 16) % THREADS == 0, "x chunks per thread");
};

// small M
constexpr int SBN = 64, SBK = 64, SST = 4, STHREADS = 128;
constexpr int SX_ROW = SBK + 16;         // padded x row: distinct banks
constexpr int SW_BYTES = SBK * SBN;      // w stage: 64 rows of 64 bytes

// Row m of expert e's product lives at memory row ((m / C) E + e) C + m % C
// of x and of the output: the (G, E, C) routed buffer.
struct Routing {
  int C, E;
  __device__ __forceinline__ long long row(int m, int e) const {
    return ((long long)(m / C) * E + e) * C + m % C;
  }
};

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

// The epilogue of one expert (e) of the product: w_scale and bias of its N
// columns, x_scale one value (xs_stride 0, or one an expert: the pointer
// is moved by e) or one per memory row (xs_stride 1). ROUTED: a stack of
// experts under `rt` (quant_expert_gemm); else one product, row m at row m,
// and the code is the plain GEMM's with no expert arithmetic.
template <bool ROUTED>
struct Epilogue {
  const float* w_scale;
  const float* x_scale;
  int xs_stride;
  const float* bias;
  const float* out_scale;
  float* out_f;
  int8_t* out_q;
  int M, N, act;
  Routing rt;
  int xs_per_expert;
  int e;
  // non-null: write the int32 accumulator here (M, N) and no epilogue (the
  // row-parallel GEMM of a tensor-parallel mesh sums it across ranks first)
  int* out_acc;

  // this epilogue for expert e (blockIdx.z)
  __device__ __forceinline__ Epilogue bind(int expert) const {
    Epilogue b = *this;
    if constexpr (ROUTED) {
      b.e = expert;
      if (w_scale != nullptr) b.w_scale += (long long)expert * N;
      if (xs_per_expert) b.x_scale += expert;
    }
    return b;
  }

  // the memory row of row m of the product
  __device__ __forceinline__ long long row(int m) const {
    if constexpr (ROUTED) return rt.row(m, e);
    return m;
  }

  __device__ __forceinline__ void store(int m, int n, int acc) const {
    if (m >= M || n >= N) return;
    const long long r = row(m);
    if (out_acc != nullptr) {
      out_acc[r * N + n] = acc;
      return;
    }
    const float y = value(x_scale[r * xs_stride], n, acc);
    if (out_q != nullptr) {
      const float c = fminf(fmaxf(rintf(y / *out_scale), -128.0f), 127.0f);
      out_q[r * N + n] = (int8_t)(int)c;
    } else {
      out_f[r * N + n] = y;
    }
  }

  __device__ __forceinline__ float value(float xs, int n, int acc) const {
    float y = (float)acc * (xs * w_scale[n]);
    y = y + (bias != nullptr ? bias[n] : 0.0f);
    return activation(y, act);
  }

  // columns n..n+3 of row m; vec: N % 16 == 0, so a row's 4 columns are
  // whole and 16-byte (float) / 4-byte (int8) aligned
  __device__ __forceinline__ void store4(int m, int n, int4 acc,
                                         bool vec) const {
    if (m >= M) return;
    if (!vec || n + 4 > N) {
      store(m, n, acc.x);
      store(m, n + 1, acc.y);
      store(m, n + 2, acc.z);
      store(m, n + 3, acc.w);
      return;
    }
    const long long r = row(m);
    if (out_acc != nullptr) {
      *reinterpret_cast<int4*>(out_acc + r * N + n) = acc;
      return;
    }
    const float xs = x_scale[r * xs_stride];
    const float y0 = value(xs, n, acc.x), y1 = value(xs, n + 1, acc.y);
    const float y2 = value(xs, n + 2, acc.z), y3 = value(xs, n + 3, acc.w);
    if (out_q != nullptr) {
      const float os = *out_scale;
      char4 q;
      q.x = (signed char)(int)fminf(fmaxf(rintf(y0 / os), -128.0f), 127.0f);
      q.y = (signed char)(int)fminf(fmaxf(rintf(y1 / os), -128.0f), 127.0f);
      q.z = (signed char)(int)fminf(fmaxf(rintf(y2 / os), -128.0f), 127.0f);
      q.w = (signed char)(int)fminf(fmaxf(rintf(y3 / os), -128.0f), 127.0f);
      *reinterpret_cast<char4*>(out_q + r * N + n) = q;
    } else {
      *reinterpret_cast<float4*>(out_f + r * N + n) =
          make_float4(y0, y1, y2, y3);
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes of row `row` of a (rows, ld) int8 matrix, from column col, into
// shared memory; zero past `rows` and past `cols`. The row is read at
// memory row `mem` (row itself but for routed x). vec: 16-byte cp.async
// (cols and ld multiples of 16, base aligned); else byte loads.
__device__ __forceinline__ void copy16(void* dst, const int8_t* base,
                                       int row, int rows, long long mem,
                                       int col, int cols, int ld, bool vec) {
  if (vec) {
    const bool ok = row < rows && col < cols;
    const int8_t* src = ok ? base + mem * ld + col : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (row < rows) {
      const int8_t* src = base + mem * ld;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < cols)
          w[e >> 2] |= (uint32_t)(uint8_t)src[col + e] << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Byte offset of 16-byte chunk c of row r in a w stage of RB-byte rows,
// seen as 128-byte lines whose chunks are XOR-swizzled by (r / 4) % 4: the
// words a warp's lanes (g, t) read at rows 4 t + i fall in distinct banks.
template <int RB>
__device__ __forceinline__ int w_off(int r, int c) {
  const int lin = r * RB + c * 16;
  const int pos = ((lin >> 4) & 7) ^ (((r >> 2) & 3) << 1);
  return (lin & ~127) | (pos << 4);
}

// The 4 x 4 byte transpose: byte i of o[c] is byte c of r[i].
__device__ __forceinline__ void transpose_4x4(const uint32_t (&r)[4],
                                              uint32_t (&o)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// The K-major words of columns 4 cw + c (c = 0..3) over rows kr..kr+3: four
// 32-bit reads of 4 columns each, transposed 4 x 4 bytes.
template <int RB>
__device__ __forceinline__ void w_quad(const unsigned char* st, int kr,
                                       int cw, uint32_t (&o)[4]) {
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r[i] = *reinterpret_cast<const uint32_t*>(
        st + w_off<RB>(kr + i, cw >> 2) + 4 * (cw & 3));
  transpose_4x4(r, o);
}

// x stage of the large-M kernel: 64-byte rows, chunks swizzled by
// (r / 2) % 4 so that the 8 rows of an ldmatrix fall in distinct banks
__device__ __forceinline__ int x_off(int r, int c) {
  return r * LBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// ---------------------------------------------------------------------------
// large M: 128 x 128 or 64 x 64 tiles; expert blockIdx.z
// ---------------------------------------------------------------------------

template <class Name, int WM, int WN, int MT>
__global__ void __launch_bounds__(Large<WM, WN, MT>::THREADS)
int8_gemm_large(const int8_t* __restrict__ xq,
                const int8_t* __restrict__ wq,
                Epilogue<Name::routed> ep0, int K, int vec) {
  using L = Large<WM, WN, MT>;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* xs = smem;
  unsigned char* ws = smem + LST * L::X_BYTES;
  const int e = blockIdx.z;
  const auto ep = ep0.bind(e);
  const int M = ep.M, N = ep.N;
  if constexpr (Name::routed) wq += (long long)e * K * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int ktiles = (K + LBK - 1) / LBK;
  long long xmem[L::X_LOADS];          // memory rows of this thread's x rows
#pragma unroll
  for (int u = 0; u < L::X_LOADS; ++u)
    xmem[u] = ep.row(m0 + ((tid + u * L::THREADS) >> 2));

  auto load = [&](int stage, int kt) {
    const int k0 = kt * LBK;
    unsigned char* xd = xs + stage * L::X_BYTES;
    unsigned char* wd = ws + stage * L::W_BYTES;
#pragma unroll
    for (int u = 0; u < L::X_LOADS; ++u) {
      const int i = tid + u * L::THREADS;
      const int r = i >> 2, c = i & 3;
      copy16(xd + x_off(r, c), xq, m0 + r, M, xmem[u], k0 + 16 * c, K, K,
             vec);
    }
    for (int i = tid; i < LBK * (L::BN / 16); i += L::THREADS) {
      const int r = i / (L::BN / 16), c = i % (L::BN / 16);
      copy16(wd + w_off<L::BN>(r, c), wq, k0 + r, K, k0 + r, n0 + 16 * c, N,
             N, vec);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

#pragma unroll
  for (int s = 0; s < LST - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<LST - 2>();
    __syncthreads();                // tile kt landed; kt - 1 is consumed
    if (kt + LST - 1 < ktiles) load((kt + LST - 1) % LST, kt + LST - 1);
    cp_async_commit();
    const unsigned char* xd = xs + (kt % LST) * L::X_BYTES;
    const unsigned char* wd = ws + (kt % LST) * L::W_BYTES;
#pragma unroll
    for (int ks = 0; ks < LBK / 32; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xd + x_off(wm * MT * 16 + mt * 16 + (lane & 7)
                                          + ((lane >> 3) & 1) * 8,
                                      ks * 2 + (lane >> 4)));
      uint32_t b[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        w_quad<L::BN>(wd, ks * 32 + h * 16 + 4 * t, wn * 8 + g, b[h]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mma_s8(acc[mt][c], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b[0][c],
                 b[1][c]);
    }
  }

  // the int32 tile through shared memory (the ring is free), then the
  // epilogue on whole rows: coalesced 16-byte stores of 4 columns. Tile c's
  // column 2t + j is w column 8 t + 4 j + c of the warp's group.
  cp_async_wait<0>();
  __syncthreads();
  int* tile = reinterpret_cast<int*>(smem);        // BM x (BN + 4)
  constexpr int TS = L::BN + 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = wm * MT * 16 + mt * 16 + g;
      const int n = wn * 32 + 8 * t + c;
      tile[r * TS + n] = acc[mt][c][0];
      tile[r * TS + n + 4] = acc[mt][c][1];
      tile[(r + 8) * TS + n] = acc[mt][c][2];
      tile[(r + 8) * TS + n + 4] = acc[mt][c][3];
    }
  __syncthreads();
  for (int i = tid; i < L::BM * L::BN / 4; i += L::THREADS) {
    const int r = i / (L::BN / 4), c4 = (i % (L::BN / 4)) * 4;
    const int4 v = *reinterpret_cast<const int4*>(&tile[r * TS + c4]);
    ep.store4(m0 + r, n0 + c4, v, vec);
  }
}

template <class Name, int WM, int WN, int MT>
int launch_large(const int8_t* xq, const int8_t* wq,
                 const Epilogue<Name::routed>& ep,
                 int K, int E, int vec, cudaStream_t st) {
  using L = Large<WM, WN, MT>;
  auto kernel = int8_gemm_large<Name, WM, WN, MT>;
  if (L::SMEM > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) {
      cudaGetLastError();            // a refused attribute must not linger
      return (int)err;
    }
  }
  const dim3 grid((ep.N + L::BN - 1) / L::BN, (ep.M + L::BM - 1) / L::BM, E);
  kernel<<<grid, L::THREADS, L::SMEM, st>>>(xq, wq, ep, K, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// small M: w^T x^T, split-K; expert blockIdx.z
// ---------------------------------------------------------------------------

template <class Name, int MT>   // 8-row tiles of x: M <= 8 MT
__global__ void __launch_bounds__(STHREADS)
int8_gemm_small(const int8_t* __restrict__ xq,
                const int8_t* __restrict__ wq,
                Epilogue<Name::routed> ep0, int K, int per, int splits,
                int* __restrict__ work, int vec) {
  constexpr int SX_BYTES = MT * 8 * SX_ROW;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ws = smem;
  unsigned char* xs = smem + SST * SW_BYTES;
  __shared__ int last;
  const int e = blockIdx.z;
  const auto ep = ep0.bind(e);
  const int M = ep.M, N = ep.N;
  if constexpr (Name::routed) wq += (long long)e * K * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cg = warp & 1;           // 32-column group of the tile
  const int kh = warp >> 1;          // 32-byte half of each stage's K
  const int n0 = blockIdx.x * SBN;
  const int ktiles = (K + SBK - 1) / SBK;
  const int kt0 = blockIdx.y * per;
  const int kt1 = min(ktiles, kt0 + per);
  // the x chunk this thread loads (MT * 8 rows of 4 chunks: one a thread
  // at most) and its memory row
  const int xr = tid >> 2, xc = tid & 3;
  const long long xmem = ep.row(xr);

  auto load = [&](int stage, int kt) {
    const int k0 = kt * SBK;
    unsigned char* wd = ws + stage * SW_BYTES;
    unsigned char* xd = xs + stage * SX_BYTES;
    for (int i = tid; i < SBK * (SBN / 16); i += STHREADS) {
      const int r = i >> 2, c = i & 3;
      copy16(wd + w_off<SBN>(r, c), wq, k0 + r, K, k0 + r, n0 + 16 * c, N,
             N, vec);
    }
    if (tid < MT * 8 * (SBK / 16))
      copy16(xd + xr * SX_ROW + 16 * xc, xq, xr, M, xmem, k0 + 16 * xc, K, K,
             vec);
  };

  int acc[2][MT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[p][mt][c] = 0;

#pragma unroll
  for (int s = 0; s < SST - 1; ++s) {
    if (kt0 + s < kt1) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0;
    cp_async_wait<SST - 2>();
    __syncthreads();
    if (kt + SST - 1 < kt1) load((i + SST - 1) % SST, kt + SST - 1);
    cp_async_commit();
    const unsigned char* wd = ws + (i % SST) * SW_BYTES;
    const unsigned char* xd = xs + (i % SST) * SX_BYTES;
    uint32_t w[2][4];                 // [k half][column 4 g + c]
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w_quad<SBN>(wd, kh * 32 + h * 16 + 4 * t, cg * 8 + g, w[h]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const unsigned char* xp = xd + (mt * 8 + g) * SX_ROW + kh * 32 + 4 * t;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xp + 16);
      // tile p: its row g is w column 4 g + 2 p, row g + 8 column 4 g + 2p+1
#pragma unroll
      for (int p = 0; p < 2; ++p)
        mma_s8(acc[p][mt], w[0][2 * p], w[0][2 * p + 1], w[1][2 * p],
               w[1][2 * p + 1], b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                    // the ring is free: reuse it

  // add the two K halves of each column group in shared memory
  int* red = reinterpret_cast<int*>(smem);
  constexpr int PER_WARP = 2 * MT * 4 * 32;
  if (kh == 1) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[cg * PER_WARP + ((p * MT + mt) * 4 + c) * 32 + lane] =
              acc[p][mt][c];
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[p][mt][c] += red[cg * PER_WARP + ((p * MT + mt) * 4 + c) * 32
                             + lane];

  // tile p's element (row g + 8 h, column 2 t + j) is y[m = 8 mt + 2 t + j]
  // [n = n0 + 32 cg + 4 g + 2 p + h]
  const int nb = n0 + cg * 32 + 4 * g;
  if (splits == 1) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          ep.store(mt * 8 + 2 * t + (c & 1), nb + 2 * p + (c >> 1),
                   acc[p][mt][c]);
    return;
  }
  // expert e's workspace: M N partial sums, then a counter a column tile
  if constexpr (Name::routed)
    work += (long long)e * ((long long)M * N + gridDim.x);
  int* counter = work + (long long)M * N;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = mt * 8 + 2 * t + (c & 1);
        const int n = nb + 2 * p + (c >> 1);
        if (m < M && n < N) atomicAdd(work + (long long)m * N + n,
                                      acc[p][mt][c]);
      }
  __threadfence();
  // the 64 threads left (warps 0 and 1) agree on the last block
  asm volatile("bar.sync 1, 64;\n" ::);
  if (tid == 0) last = atomicAdd(counter + blockIdx.x, 1) == splits - 1;
  asm volatile("bar.sync 1, 64;\n" ::);
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = mt * 8 + 2 * t + (c & 1);
        const int n = nb + 2 * p + (c >> 1);
        if (m < M && n < N)
          ep.store(m, n, __ldcg(work + (long long)m * N + n));
      }
}

// The small-M kernel's split of K for E stacked (M, N, K) products:
// ceil(K / 64) stages dealt out `per` to a block, over enough blocks that
// about two stream w on each of the 132 SMs. 1 split when M > 32 (the
// large-M kernel).
int split_plan(int M, int N, int K, int E, int& per) {
  const int ktiles = (K + SBK - 1) / SBK;
  per = ktiles > 0 ? ktiles : 1;
  if (M > kSmallM || M <= 0 || N <= 0 || E <= 0 || ktiles <= 1) return 1;
  const long long tiles = (long long)((N + SBN - 1) / SBN) * E;
  const long long want = (2 * kSMs + tiles - 1) / tiles;
  if (want <= 1) return 1;
  per = ktiles / want > 0 ? ktiles / (int)want : 1;
  return (ktiles + per - 1) / per;
}

template <class Name, int MT>
int launch_small(const int8_t* xq, const int8_t* wq,
                 const Epilogue<Name::routed>& ep,
                 int K, int E, int per, int splits, int* work, int vec,
                 cudaStream_t st) {
  const int bytes = SST * (SW_BYTES + MT * 8 * SX_ROW);    // <= 26 KB
  const dim3 grid((ep.N + SBN - 1) / SBN, splits, E);
  int8_gemm_small<Name, MT><<<grid, STHREADS, bytes, st>>>(
      xq, wq, ep, K, per, splits, work, vec);
  return (int)cudaGetLastError();
}

// E stacked products of M rows (one launch): the small-M stream for
// M <= 32, else the tiled kernel. splits must be split_plan(M, N, K, E);
// work E (M N + ceil(N / 64)) int32 zeros when it is over 1. Name, a type
// of the caller's, names the kernels in a profile (each .cu its own).
template <class Name>
int int8_gemm(const int8_t* xq, const int8_t* wq,
              const Epilogue<Name::routed>& ep, int K,
              int E, int splits, int* work, int vec, cudaStream_t st) {
  const int M = ep.M, N = ep.N;
  if (M <= 0 || N <= 0 || E <= 0) return (int)cudaGetLastError();
  int per;
  if (splits != split_plan(M, N, K, E, per) || (splits > 1 && !work))
    return (int)cudaErrorInvalidValue;
  if (M <= kSmallM) {
    if (M <= 8)
      return launch_small<Name, 1>(xq, wq, ep, K, E, per, splits, work, vec,
                                   st);
    if (M <= 16)
      return launch_small<Name, 2>(xq, wq, ep, K, E, per, splits, work, vec,
                                   st);
    return launch_small<Name, 4>(xq, wq, ep, K, E, per, splits, work, vec, st);
  }
  // 128 x 128 tiles where they give two blocks for each SM, else 64 x 64
  const long long big = (long long)((N + 127) / 128) * ((M + 127) / 128) * E;
  if (big >= 2 * kSMs)
    return launch_large<Name, 2, 4, 4>(xq, wq, ep, K, E, vec, st);
  return launch_large<Name, 2, 2, 2>(xq, wq, ep, K, E, vec, st);
}

}  // namespace
