// Float online-softmax attention (flash attention) for long-context prefill,
// with its products on the H100's tensor cores.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// _kernel). For one (batch, query head h) and query row i, over keys j with
// positions arange(Sq) and arange(Sk) (both from 0):
//   s[j] = sum_d (q[i][d] * scale) * k[j][d]               float32
//   s[j] = tanh(s[j] / cap) * cap                          optional softcap
//   s[j] = NEG_INF where causal and j > i, or window and j <= i - window
//   online softmax over the key blocks that run:
//     m' = max(m, max_j s); a = exp(m - m'); p[j] = exp(s[j] - m')
//     l = l * a + sum_j p[j];  acc[d] = acc[d] * a + sum_j p[j] v[j][d]
//   out = acc / max(l, 1e-30), cast to q's dtype (round to nearest even)
// GQA: query head h reads KV head h / (Hq / Hkv). NEG_INF is finite
// (-0.7 FLT_MAX), and m starts at NEG_INF, as in the JAX kernel.
//
// Which key blocks run is part of the result. The JAX grid skips a whole
// logical (bq x bk) block when causal and k_lo > q_lo + bq - 1, or with a
// window when k_lo + bk - 1 <= q_lo - window. For a row i those rules leave
// one contiguous range of keys [lo(i), hi(i)) whose blocks run; a key
// outside it is absent (-INFINITY: it adds nothing, not even to the max,
// since m starts at the finite NEG_INF), a masked key inside it is NEG_INF.
// So a row with no valid key returns 0 where none of its blocks runs, and
// the mean of v over the run blocks' keys where some do (exp(NEG_INF -
// NEG_INF) = 1), never NaN. A row with a valid key loses nothing when a
// tile of masked keys is skipped: such an entry adds exp(NEG_INF - m) = 0
// after its first valid key and is washed out by a = exp(NEG_INF - m') = 0
// before it. So each warp runs only the tiles that hold a key its rows need
// (the valid keys, or the whole run range of a row that has none).
//
// Bound on the H100: operations. At the long-context shapes (S = 32768) a
// call reads q, k and v once and writes out once, about 0.3 GB at d = 64,
// against 4 d operations per valid (query, key) pair: 1.9e12 for qwen2's
// causal 32k prefill, 1.9 ms at the 989 TFLOP/s of the 16-bit tensor cores
// (exact products, float32 sums), 11.7 ms for float32 at float32 accuracy
// (3xTF32 at 495 / 3 TFLOP/s beats the CUDA cores' 67).
//
// Design (FA2-style, mma.sync): one block of 4 warps per (batch x query
// head, tile of 64 query rows), the heaviest causal tiles first. Each warp
// owns 16 query rows as mma fragments: the scores of a 16 x BK tile and the
// 16 x D output accumulator live in registers, the softmax runs in float32
// on the fragment's rows (a row is spread over the 4 lanes of a quad: max
// by two shuffles; the sum l is kept per lane and added once at the end).
// K and V tiles of BK keys go through a ring of shared memory (3 stages
// for 16-bit inputs at d <= 64, else 2) filled by cp.async (16-byte copies,
// zero-filled past Sk and past d), so the next tiles' loads overlap this
// tile's products; one barrier a tile.
//  * bfloat16 / float16: m16n8k16 with float32 sums. Q.K^T is exact in the
//    products (16 x 16 bits fit in float32); scale multiplies the float32
//    score. P.V splits P = P_hi + P_lo into two 16-bit values and runs two
//    products into one accumulator (about 2^-17 relative instead of the
//    2^-9 of one rounding, which breaks the 2e-4 budget on rows whose
//    output cancels near 0). Fragments come from ldmatrix (.trans for V).
//  * float32: 3xTF32 on m16n8k8: a = a_hi + a_lo, each cvt.rna.tf32, and
//    a.b = a_hi b_hi + a_hi b_lo + a_lo b_hi (plain TF32 keeps 10 bits and
//    fails 2e-4). q is scaled in float32 first, as the JAX kernel does.
//    P.V keeps P in the score registers: the fragment's columns (2t, 2t+1)
//    are read as the A columns (t, t + 4), and V's rows are taken in the
//    same order, which permutes the sum's terms and nothing else.
// The softmax runs in the log2 domain, t = s * scale * log2 e and p =
// 2^(t - m) (the MUFU ex2, about 2^-22 relative: far inside 2e-4); a tile
// whose keys are valid in all 16 rows of a warp skips the masks and folds
// the scaling into the exponent's fmaf.
// Head dims 16, 32, 64, 128 and 256 are instantiated; a dim in between is
// zero-padded up to the next, and a dim over 256 runs the wide kernel at
// the end of this file. tanh is tanhf, division IEEE; the build's
// -fmad=false keeps every multiply and add separately rounded.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the Python constant -0.7 * float32 max, rounded once to float
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;            // query rows of a block

// keys of a K/V tile: 64, or 32 where the accumulator is 256 wide or a
// float32 tile would take too much shared memory
template <typename T, int D>
struct Tile {
  static constexpr int BK = (D >= 256 || (sizeof(T) == 4 && D >= 128)) ? 32
                                                                       : 64;
  // row stride in elements: 16 bytes of padding, so the 8 rows an
  // ldmatrix or a fragment load reads fall in distinct banks
  static constexpr int ST = D + 16 / (int)sizeof(T);
  // stages of the K/V ring: 3 where three blocks still fit an SM
  static constexpr int NS = (sizeof(T) == 2 && D <= 64) ? 3 : 2;
};

template <bool B> struct Bool { static constexpr bool value = B; };

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)Tile<T, D>::ST *
         (kBQ + 2 * Tile<T, D>::NS * Tile<T, D>::BK);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), 16-bit inputs, float32 sums
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16<__nv_bfloat16>(float (&d)[4],
                                                     const uint32_t (&a)[4],
                                                     uint32_t b0,
                                                     uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16<__half>(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 inputs, float32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the MUFU (about 2^-22 relative; results under 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo, each rounded to TF32 (10 mantissa bits) to nearest, ties away
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// (x, y) = hi + lo, two 16-bit pairs (x in the low half), round to nearest
template <typename T>
__device__ __forceinline__ void split16(float x, float y, uint32_t& hi,
                                        uint32_t& lo);
template <>
__device__ __forceinline__ void split16<__nv_bfloat16>(float x, float y,
                                                       uint32_t& hi,
                                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x - __bfloat162float(h.x), y - __bfloat162float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
template <>
__device__ __forceinline__ void split16<__half>(float x, float y,
                                                uint32_t& hi, uint32_t& lo) {
  const __half2 h = __floats2half2_rn(x, y);
  const __half2 l = __floats2half2_rn(x - __half2float(h.x),
                                      y - __half2float(h.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The keys [lo, hi) whose logical (bq, bk) blocks run for query row i.
__device__ __forceinline__ void key_range(int i, int Sk, int bq, int bk,
                                          int causal, int use_window,
                                          int window, int& lo, int& hi) {
  const long long q_lo = (long long)(i / bq) * bq;
  long long l = 0, h = Sk;
  if (causal) {          // run iff k_lo <= q_lo + bq - 1
    const long long nb = (q_lo + bq - 1) / bk + 1;
    h = nb * bk < h ? nb * bk : h;
  }
  if (use_window) {      // run iff k_lo + bk - 1 > q_lo - window
    const long long t = q_lo - window - bk + 1;
    if (t >= 0) l = (t / bk + 1) * bk;
  }
  lo = (int)(l < Sk ? l : Sk);
  hi = (int)h;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Sq, int Sk, int d, int bq, int bk,
                       int causal, int use_window, int window, int use_cap,
                       float cap, float scale, int vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BK = Tile<T, D>::BK;
  constexpr int ST = Tile<T, D>::ST;
  constexpr int NS = Tile<T, D>::NS;
  constexpr int NT = BK / 8;                 // score n-tiles of a K tile
  constexpr int DT = D / 8;                  // output n-tiles
  constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte copy moves
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);        // kBQ x ST
  T* Ks = Qs + kBQ * ST;                     // NS stages x BK x ST
  T* Vs = Ks + NS * BK * ST;                 // NS stages x BK x ST
  __shared__ int red[2][kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const T* qg = q + (size_t)bh * Sq * d;
  const T* kg = k + ((size_t)b * Hkv + hk) * Sk * d;
  const T* vg = v + ((size_t)b * Hkv + hk) * Sk * d;
  T* og = out + (size_t)bh * Sq * d;

  // q in shared memory: float32 scaled as the JAX kernel scales it, 16-bit
  // as given (scale then multiplies the float32 score); padding is zero
  for (int x = tid; x < kBQ * D; x += kThreads) {
    const int r = x / D, e = x % D;
    float val = 0.0f;
    if (q0 + r < Sq && e < d) {
      val = to_f(qg[(size_t)(q0 + r) * d + e]);
      if (kF32) val = val * scale;
    }
    Qs[r * ST + e] = from_f<T>(val);
  }

  // this lane's two rows (g and g + 8 of the warp's 16): the run range
  // [lo, hi), the keys it needs [nlo, nhi), and the keys valid in every row
  // of the warp [flo, fhi), where a tile needs no mask
  int lo[2], hi[2];
  int wlo = 0x7fffffff, whi = 0, flo = 0, fhi = 0x7fffffff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + warp * 16 + g + 8 * i;
    lo[i] = hi[i] = 0;
    if (r < Sq) key_range(r, Sk, bq, bk, causal, use_window, window, lo[i],
                          hi[i]);
    long long vlo = lo[i], vhi = hi[i];
    if (use_window && (long long)r - window + 1 > vlo)
      vlo = (long long)r - window + 1;
    if (causal && (long long)r + 1 < vhi) vhi = (long long)r + 1;
    const int nlo = vlo < vhi ? (int)vlo : lo[i];
    const int nhi = vlo < vhi ? (int)vhi : hi[i];
    if (nlo < nhi) {
      wlo = min(wlo, nlo);
      whi = max(whi, nhi);
    }
    if (vlo < vhi) {
      flo = max(flo, (int)vlo);
      fhi = min(fhi, (int)vhi);
    } else {
      fhi = 0;
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, off));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, off));
    flo = max(flo, __shfl_xor_sync(0xffffffffu, flo, off));
    fhi = min(fhi, __shfl_xor_sync(0xffffffffu, fhi, off));
  }
  if (lane == 0) {
    red[0][warp] = wlo;
    red[1][warp] = whi;
  }
  __syncthreads();                  // also publishes Qs
  int blo = red[0][0], bhi = red[1][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    blo = min(blo, red[0][w]);
    bhi = max(bhi, red[1][w]);
  }
  // scores to the log2 domain: p = exp2(t - m) = exp(s' - m / log2 e);
  // float32 q already carries scale
  const float nat = kF32 ? 1.0f : scale;
  const float to_log2 = nat * kLog2e;

  float o[DT][4], m[2], l[2];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  // K and V rows [k0, k0 + BK) into a stage, zero past Sk and past d
  auto load = [&](int stage, int k0) {
    T* kd = Ks + stage * BK * ST;
    T* vd = Vs + stage * BK * ST;
    if (vec) {
      constexpr int CPR = D / EPC;          // 16-byte chunks of a row
      for (int x = tid; x < BK * CPR; x += kThreads) {
        const int c = x / CPR, e = (x % CPR) * EPC;
        const int j = k0 + c;
        const bool ok = j < Sk && e < d;
        const size_t off = ok ? (size_t)j * d + e : 0;
        cp_async16(kd + c * ST + e, kg + off, ok);
        cp_async16(vd + c * ST + e, vg + off, ok);
      }
    } else {
      for (int x = tid; x < BK * D; x += kThreads) {
        const int c = x / D, e = x % D;
        const int j = k0 + c;
        T kv = from_f<T>(0.0f), vv = from_f<T>(0.0f);
        if (j < Sk && e < d) {
          kv = kg[(size_t)j * d + e];
          vv = vg[(size_t)j * d + e];
        }
        kd[c * ST + e] = kv;
        vd[c * ST + e] = vv;
      }
    }
  };

  const int kt0 = blo / BK;
  const int kt1 = blo < bhi ? (bhi + BK - 1) / BK : kt0;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (kt0 + i < kt1) load(i, (kt0 + i) * BK);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) % NS;
    cp_async_wait<NS - 2>();
    __syncthreads();     // tile kt landed; every warp is done with kt - 1
    if (kt + NS - 1 < kt1)
      load((kt - kt0 + NS - 1) % NS, (kt + NS - 1) * BK);
    cp_async_commit();
    const int k0 = kt * BK;
    if (k0 < whi && k0 + BK > wlo) {        // a tile this warp needs
      const T* Kt = Ks + stage * BK * ST;
      const T* Vt = Vs + stage * BK * ST;
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.0f;

      // ---- scores: s = q . k^T over the warp's 16 rows and BK keys
      if constexpr (kF32) {
        const float* Qf = reinterpret_cast<const float*>(Qs);
        const float* Kf = reinterpret_cast<const float*>(Kt);
#pragma unroll 2
        for (int kk = 0; kk < D / 8; ++kk) {
          const float* qa = Qf + (warp * 16 + g) * ST + kk * 8 + t;
          uint32_t ah[4], al[4];
          split_tf32(qa[0], ah[0], al[0]);
          split_tf32(qa[8 * ST], ah[1], al[1]);
          split_tf32(qa[4], ah[2], al[2]);
          split_tf32(qa[8 * ST + 4], ah[3], al[3]);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* kb = Kf + (n * 8 + g) * ST + kk * 8 + t;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(kb[0], bh0, bl0);
            split_tf32(kb[4], bh1, bl1);
            mma_tf32(s[n], al, bh0, bh1);
            mma_tf32(s[n], ah, bl0, bl1);
            mma_tf32(s[n], ah, bh0, bh1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t a[4];
          ldmatrix_x4(a, Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * ST + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int n2 = 0; n2 < NT / 2; ++n2) {
            uint32_t bb[4];
            ldmatrix_x4(bb, Kt + (n2 * 16 + (lane >> 4) * 8 + (lane & 7)) * ST
                                + kk * 16 + ((lane >> 3) & 1) * 8);
            mma16<T>(s[2 * n2], a, bb[0], bb[1]);
            mma16<T>(s[2 * n2 + 1], a, bb[2], bb[3]);
          }
        }
      }

      // ---- mask and online softmax on the fragment's rows g and g + 8, in
      // the log2 domain (a masked score stays the finite NEG_INF). `plain`:
      // no mask and no softcap, so t = s * to_log2 folds into one fmaf
      auto softmax = [&](auto plain) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = q0 + warp * 16 + g + 8 * i;
          float mx = -INFINITY;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = s[n][2 * i + c];
              if (!decltype(plain)::value) {
                const int j = k0 + n * 8 + 2 * t + c;
                if (use_cap) {
                  x = x * nat;
                  x = tanhf(x / cap) * cap * kLog2e;
                } else {
                  x = x * to_log2;
                }
                if (j < lo[i] || j >= hi[i]) {
                  x = -INFINITY;       // its block does not run: absent
                } else if ((causal && j > r) ||
                           (use_window &&
                            (long long)j <= (long long)r - window)) {
                  x = kNegInf;
                }
                s[n][2 * i + c] = x;
              }
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          if (decltype(plain)::value) mx = mx * to_log2;   // to_log2 > 0
          const float m_new = fmaxf(m[i], mx);
          const float alpha = ex2(m[i] - m_new);
          float sum = 0.0f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float x = s[n][2 * i + c];
              const float p = decltype(plain)::value
                                  ? ex2(fmaf(x, to_log2, -m_new))
                                  : ex2(x - m_new);        // absent: 0
              s[n][2 * i + c] = p;
              sum += p;
            }
          l[i] = l[i] * alpha + sum;    // this lane's keys; quad sum at end
          m[i] = m_new;
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            o[n][2 * i] = o[n][2 * i] * alpha;
            o[n][2 * i + 1] = o[n][2 * i + 1] * alpha;
          }
        }
      };
      if (!use_cap && k0 >= flo && k0 + BK <= fhi) {  // all valid, no cap
        softmax(Bool<true>());
      } else {
        softmax(Bool<false>());
      }

      // ---- o += p . v
      if constexpr (kF32) {
        const float* Vf = reinterpret_cast<const float*>(Vt);
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          // A column t <- key 2t, column t + 4 <- key 2t + 1
          uint32_t ah[4], al[4];
          split_tf32(s[kk][0], ah[0], al[0]);
          split_tf32(s[kk][2], ah[1], al[1]);
          split_tf32(s[kk][1], ah[2], al[2]);
          split_tf32(s[kk][3], ah[3], al[3]);
          const float* vb = Vf + (kk * 8 + 2 * t) * ST + g;
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(vb[n * 8], bh0, bl0);
            split_tf32(vb[ST + n * 8], bh1, bl1);
            mma_tf32(o[n], al, bh0, bh1);
            mma_tf32(o[n], ah, bl0, bl1);
            mma_tf32(o[n], ah, bh0, bh1);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          uint32_t ph[4], pl[4];
          split16<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split16<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split16<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split16<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int n2 = 0; n2 < DT / 2; ++n2) {
            uint32_t bb[4];
            ldmatrix_x4_trans(
                bb, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ST
                        + n2 * 16 + (lane >> 4) * 8);
            mma16<T>(o[2 * n2], pl, bb[0], bb[1]);
            mma16<T>(o[2 * n2], ph, bb[0], bb[1]);
            mma16<T>(o[2 * n2 + 1], pl, bb[2], bb[3]);
            mma16<T>(o[2 * n2 + 1], ph, bb[2], bb[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = q0 + warp * 16 + g + 8 * i;
    if (r >= Sq) continue;
    const float den = fmaxf(li, 1e-30f);
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = n * 8 + 2 * t + c;
        if (e < d) og[(size_t)r * d + e] = from_f<T>(o[n][2 * i + c] / den);
      }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int d, int bq, int bk,
           int causal, int use_window, int window, int use_cap, float cap,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, D>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();            // a refused attribute must not linger
      return (int)err;
    }
  }
  // 16-byte copies need rows of whole 16-byte chunks and aligned bases
  const int vec = (d * (int)sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, d, bq,
      bk, causal, use_window, window, use_cap, cap, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dp, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int Sq, int Sk, int d, int bq, int bk,
             int causal, int use_window, int window, int use_cap, float cap,
             float scale, cudaStream_t stream) {
#define SAMP_FA_CASE(DIM)                                                   \
  case DIM:                                                                 \
    return launch<T, DIM>(q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq, bk,      \
                          causal, use_window, window, use_cap, cap, scale,  \
                          stream);
  switch (dp) {
    SAMP_FA_CASE(16)
    SAMP_FA_CASE(32)
    SAMP_FA_CASE(64)
    SAMP_FA_CASE(128)
    SAMP_FA_CASE(256)
  }
#undef SAMP_FA_CASE
  return (int)cudaErrorInvalidValue;
}

// the instantiated head dim a head dim d runs at (0: none, d > 256)
int padded_dim(int d) {
  for (int dp = 16; dp <= 256; dp *= 2)
    if (d <= dp) return dp;
  return 0;
}

// ---------------------------------------------------------------------------
// Head dims over 256: the wide kernel
// ---------------------------------------------------------------------------
// A simple kernel that takes any head dim d, where the tensor-core kernel's
// (16 x D) accumulator and D-wide tiles would not fit. One warp per query
// row, 4 rows a block; the output's columns are split into chunks of 256,
// a grid axis, and each chunk's block recomputes the row's scores and its
// softmax, so that a lane keeps 8 output columns in registers at any d.
// The keys run in tiles of 32 within each logical (bq x bk) block that the
// JAX grid runs for the row's query block (the same skipping rule): the
// warp takes each key's score in turn, lane l adding dims l, l + 32, ...
// (q scaled in float32 first, in shared memory; the K row read coalesced)
// and the lanes adding by shuffles, lane t keeping key t0 + t's; then the
// tile's max by shuffles, one rescale of (m, l, acc) a tile, and the
// tile's 32 P.V terms in key order, each p broadcast by a shuffle. A masked key in a run block is
// NEG_INF, a key of a skipped block is absent, as in the tensor-core
// kernel. It is held to the same 2e-4 budget against the float32 plain
// version: only the order of the sums differs.
constexpr int kWideRows = 4;              // query rows (warps) a block
constexpr int kWideCols = 256;            // output columns a block

template <typename T>
__global__ void __launch_bounds__(32 * kWideRows)
flash_attention_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ out,
                            int Hq, int Hkv, int Sq, int Sk, int d, int bq,
                            int bk, int causal, int use_window, int window,
                            int use_cap, float cap, float scale) {
  extern __shared__ float wide_q[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int i = blockIdx.y * kWideRows + warp;
  const int c0 = blockIdx.z * kWideCols + 8 * lane;   // the lane's columns
  const int b = bh / Hq;
  const int kvh = (bh - b * Hq) / (Hq / Hkv);
  float* qs = wide_q + (size_t)warp * d;
  if (i >= Sq) return;
  const T* qr = q + ((size_t)bh * Sq + i) * d;
  for (int e = lane; e < d; e += 32) qs[e] = to_f(qr[e]) * scale;
  __syncwarp();
  const T* kb = k + ((size_t)b * Hkv + kvh) * Sk * d;
  const T* vb = v + ((size_t)b * Hkv + kvh) * Sk * d;
  const int q_lo = i / bq * bq;
  float m = kNegInf, l = 0.0f, acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (int k_lo = 0; k_lo < Sk; k_lo += bk) {
    if (causal && k_lo > q_lo + bq - 1) break;
    if (use_window && k_lo + bk - 1 <= q_lo - window) continue;
    for (int t0 = k_lo; t0 < k_lo + bk; t0 += 32) {
      const int n = min(32, k_lo + bk - t0);
      const int j = t0 + lane;
      float s = -INFINITY;                  // absent: past the block
      for (int t = 0; t < n; ++t) {
        const T* kr = kb + (size_t)(t0 + t) * d;
        float x = 0.0f;
        for (int e = lane; e < d; e += 32) x += qs[e] * to_f(kr[e]);
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1)
          x += __shfl_xor_sync(0xffffffffu, x, o);
        if (lane == t) s = x;
      }
      if (lane < n) {
        if (use_cap) s = tanhf(s / cap) * cap;
        if ((causal && j > i) || (use_window && j <= i - window))
          s = kNegInf;
      }
      float mx = s;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m, mx);
      const float a = expf(m - m_new);
      const float p = lane < n ? expf(s - m_new) : 0.0f;
      float ps = p;
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l = l * a + ps;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] *= a;
      for (int t = 0; t < n; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const T* vr = vb + (size_t)(t0 + t) * d;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (c0 + e < d) acc[e] += pt * to_f(vr[c0 + e]);
      }
      m = m_new;
    }
  }
  const float den = fmaxf(l, 1e-30f);
  T* orow = out + ((size_t)bh * Sq + i) * d;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (c0 + e < d) orow[c0 + e] = from_f<T>(acc[e] / den);
}

template <typename T>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                int B, int Hq, int Hkv, int Sq, int Sk, int d, int bq, int bk,
                int causal, int use_window, int window, int use_cap,
                float cap, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)kWideRows * d;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wide_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();            // a refused attribute must not linger
      return (int)err;
    }
  }
  const dim3 grid(B * Hq, (Sq + kWideRows - 1) / kWideRows,
                  (d + kWideCols - 1) / kWideCols);
  flash_attention_wide_kernel<T><<<grid, 32 * kWideRows, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, d, bq,
      bk, causal, use_window, window, use_cap, cap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
long long smem_of(int dp) {
  switch (dp) {
    case 16: return (long long)smem_bytes<T, 16>();
    case 32: return (long long)smem_bytes<T, 32>();
    case 64: return (long long)smem_bytes<T, 64>();
    case 128: return (long long)smem_bytes<T, 128>();
    case 256: return (long long)smem_bytes<T, 256>();
  }
  return 0;
}

}  // namespace

// Bytes of dynamic shared memory one block takes at head dim d for dtype
// (0 float32, 1 bfloat16, 2 float16); 0 above 256 or for another dtype.
extern "C" long long samp_flash_attention_smem_of(int d, int dtype) {
  const int dp = padded_dim(d);
  switch (dtype) {
    case 0: return smem_of<float>(dp);
    case 1: return smem_of<__nv_bfloat16>(dp);
    case 2: return smem_of<__half>(dp);
  }
  return 0;
}

// The most any dtype's block takes at head dim d: float32's (0 above 256).
extern "C" long long samp_flash_attention_smem(int d) {
  return samp_flash_attention_smem_of(d, 0);
}

// q (B, Hq, Sq, d), k and v (B, Hkv, Sk, d), out (B, Hq, Sq, d): contiguous,
// all of one dtype (0 float32, 1 bfloat16, 2 float16), Hq % Hkv == 0,
// d >= 1 (over 256 the wide kernel), Sq % bq == 0 and Sk % bk == 0.
// use_window selects the window mask, use_cap the softcap; scale
// multiplies q . k.
extern "C" int samp_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int dtype,
                                    int B, int Hq, int Hkv, int Sq, int Sk,
                                    int d, int bq, int bk, int causal,
                                    int use_window, int window, int use_cap,
                                    float cap, float scale, void* stream) {
  if (d <= 0 || Hkv <= 0 || Hq % Hkv || bq <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  const int dp = padded_dim(d);
  if (dp == 0) {                     // over 256: the wide kernel
    switch (dtype) {
      case 0:
        return launch_wide<float>(q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq,
                                  bk, causal, use_window, window, use_cap,
                                  cap, scale, st);
      case 1:
        return launch_wide<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Sk,
                                          d, bq, bk, causal, use_window,
                                          window, use_cap, cap, scale, st);
      case 2:
        return launch_wide<__half>(q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq,
                                   bk, causal, use_window, window, use_cap,
                                   cap, scale, st);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (dtype) {
    case 0:
      return dispatch<float>(dp, q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq, bk,
                             causal, use_window, window, use_cap, cap, scale,
                             st);
    case 1:
      return dispatch<__nv_bfloat16>(dp, q, k, v, out, B, Hq, Hkv, Sq, Sk, d,
                                     bq, bk, causal, use_window, window,
                                     use_cap, cap, scale, st);
    case 2:
      return dispatch<__half>(dp, q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq, bk,
                              causal, use_window, window, use_cap, cap, scale,
                              st);
  }
  return (int)cudaErrorInvalidValue;
}
