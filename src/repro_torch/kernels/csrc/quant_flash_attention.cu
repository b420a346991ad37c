// Fully-int8 bidirectional (encoder) attention with the uint8 softmax
// epilogue, on the int8 tensor cores.
//
// Replaces src/repro/kernels/flash_attention.py:quant_flash_attention (the
// Pallas _quant_kernel). For one (batch, query head) and each query row:
//   s[j] = int32(q . k[j]) * (q_scale * k_scale)        int8 dot, exact
//   s[j] = tanh(s[j] / cap) * cap                        optional softcap
//   s[j] = NEG_INF where k_pos[b, j] < 0                  padding mask
//   p[j] = exp(s[j] - max s) / sum exp(s - max s)         exact f32 softmax
//   c[j] = clip(rint(p[j] / p_scale) - 128, -128, 127)    uint8 codes, zp -128
//   o[d] = (sum_j c[j] v[j][d] + 128 sum_j v[j][d]) * (p_scale * v_scale)
// written as float32, or requantized to int8 as clip(rint(o / o_scale)).
// GQA: query head h reads kv head h / (Hq / Hkv). NEG_INF is finite
// (-0.7 FLT_MAX), so a batch row that is all padding gets a uniform
// softmax, not NaN, as in the JAX kernel.
//
// Bound on the H100: bytes. At the serving buckets (Sk <= 512, d = 64) one
// call reads q, k, v once and writes o once, a few MB, against two int8
// products of 2 B H Sq Sk d operations each: about 130 operations per byte,
// under the int8 tensor cores' ridge of about 590. What the card spends its
// time on is issuing the exact float32 softmax, tens of instructions a
// score against 1/64 of an mma, and at the encoder buckets the latency of
// one round of small blocks.
//
// Both products run mma.sync.m16n8k32 s8 x s8 -> s32 on rows 16 at a time:
//  * S = Q K^T: a warp's 16 q rows are ldmatrix'ed once into A fragments
//    and stay in registers; K's (Sk, d) layout is the K-major B operand as
//    it is (ldmatrix, no transpose). A 32-key chunk of scores is 4 n-tiles:
//    lane (g, t) holds rows g and g + 8 at keys 8 n + 2 t + {0, 1}.
//  * P.V: a permutation of the keys leaves the exact int32 sum as it is, so
//    the score fragment is the code A fragment once the lane's codes are
//    taken as logical keys 4 t + i <-> keys 8 (i / 2) + 2 t + i % 2 (and
//    + 16). V's B fragment reads the same 4 key rows, 4 dims a word, and
//    transposes the 4 x 4 bytes with __byte_perm (int8_mma.cuh's
//    transpose_4x4): dim 32 G + 4 g + c of dim group G is column g of
//    n-tile c, and the int32 output of dim 32 G + 8 t + 4 j + c is lane
//    (g, t)'s element j of tile c.
//  * K and V reach shared memory by 16-byte cp.async (4-byte where a row of
//    hd bytes is not 16-byte aligned), zero-filled past Sk and from hd up
//    to DP, the head dim rounded up to 32, 64, 128 or 256 (the kernels'
//    template). Rows are DP + 16 bytes apart, an odd number of 16-byte
//    chunks, so the 8 rows of an ldmatrix and the 4 key rows x 8 words of
//    a V read fall in 32 distinct banks. A ring of tiles streams them, the
//    next ones in flight while one is used.
//  * The softmax is exact and in float32, with no online rescaling (that
//    would change the rounding of p): the row max first (an exact fmaxf),
//    then the sum of exp(s - max) in the order of the plain version
//    (softmax_sum: lane l of a warp adds keys l, l + 32, ... in turn, then a
//    butterfly over 16, 8, 4, 2, 1), which sets the last bit of p and so
//    the codes at ties. exp is expf (no fast math).
//  * The codes without the divides: the plain version takes clip(rint((e /
//    sum) / p_scale) - 128) with two IEEE divides, each a branch to a slow
//    path that the compiler cannot overlap with its neighbours. The kernels
//    take x = e * (1 / (sum * p_scale)), within 6 ulps of that quotient,
//    and round it half to even by adding 1.5 * 2^23; where x lies within
//    2^-12 of a half-integer (6 ulps of 256 are 9.2e-5) the rounding could
//    differ, and a warp with such a key redoes its chunk's flagged codes by
//    the divides. So the codes are the divides' bit for bit. The
//    requantizing epilogue, clip(rint(o / o_scale)), is taken the same way.
//    On the H100 the divides everywhere cost 25% at the (8, 128) bucket and
//    35% at 512 keys (PERF.md section 6).
//  * Padded keys (past Sk, zero-filled up to the k-step) add nothing to the
//    max or the sum (skipped), nor to P.V or the column sums (zero V rows).
//    The zero point is + 128 * vsum, the int32 column sums of V over all Sk
//    keys, masked ones included, as in the JAX kernel.
//
// Two kernels share that arithmetic and return the same bits. The long-key
// kernel alone would do for every length, but on the H100 it is 11-32%
// slower at the encoder buckets (PERF.md section 6) and ties at 512 keys:
//  * The row-block kernel, wherever its block fits shared memory (Sk <=
//    1408 at d = 64; every encoder bucket): a block of 8 warps (3 blocks an
//    SM at d <= 64, which caps them at 80 registers) takes 32 query rows of
//    one (batch, head), two row groups of 16, and splits each row group's
//    keys over 4 warps (warp k takes the 32-key chunks k, k + 4, ...), so
//    that a bucket of 128 rows runs 4 warps for every 16 rows, not one. K
//    streams through the ring in tiles of 128 keys; each warp writes its
//    chunk's scores to a float row buffer in shared memory (the rows of the
//    block over every key) and keeps its row maxima, which the warps then
//    combine (a ring of three tiles keeps two in flight, so that a one-tile
//    head gets K and V in one round trip). Each warp then takes 4 rows:
//    lane l turns keys l, l + 32, ... into exp(s - max) in place and sums
//    them in the plain version's order, the butterfly by shuffles. V
//    streams through the ring next: each warp reads its chunk's
//    exponentials back in the score fragment's places, takes their codes
//    as the A fragment, runs P.V over all dims, and adds its int32 partial
//    into the block's accumulator with shared-memory atomics (exact:
//    integer addition commutes); the threads also add the tile's V column
//    sums, a word of 4 dims at a time. The epilogue writes 4 dims a store
//    (float4, or char4 when requantized).
//  * The long-key kernel, past that (`tiled`): a block of 4 warps takes 64
//    query rows, 16 a warp, and streams K three times and V once in tiles
//    of 64 keys, recomputing S on the tensor cores in each sweep: the row
//    max, then the sum (the lane keeps the 8 partial sums of its keys'
//    places r = 8 n + 2 t + e in the warp order, adds chunk after chunk,
//    and the butterfly's pairs are its own n ^ 2 and n ^ 1, the lanes
//    t ^ 2 and t ^ 1, its own e ^ 1: float addition commutes, so every pair
//    adds the same two values), then the codes and P.V in registers; warp w
//    takes V's column sums of n-tile w of each dim group as one more mma
//    whose A is all ones.
// Both are instantiated at head dims up to 256 (DP); a head dim over 256
// runs a third, simple kernel at the end of this file, with the same bits.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "int8_mma.cuh"

namespace {

constexpr int kMaxDim = 256;
constexpr float kNegInf = -0.7f * FLT_MAX;

// the head dim the kernels run hd at: 32, 64, 128 or 256 (the instantiated
// ones; the next power of two above 256, for the size of a refused shape)
__host__ __device__ inline int padded_dim(int hd) {
  int dp = 32;
  while (dp < hd) dp *= 2;
  return dp;
}

// row-block kernel: 2 row groups of 16, 4 key warps each; tiles of 128 keys;
// 3 blocks an SM up to DP = 64 (80 registers: the 384 blocks of a (8, 128)
// bucket then run in one wave, not 1.45), 2 at 128, 1 at 256
constexpr int kRG = 2, kKW = 4;
__host__ __device__ constexpr int row_blocks_per_sm(int dp) {
  return dp <= 64 ? 3 : dp <= 128 ? 2 : 1;
}
constexpr int kRBThreads = 32 * kRG * kKW;
constexpr int kRBRows = 16 * kRG;
constexpr int kRBKeys = 32 * kKW;

// long-key kernel: 4 warps of 16 rows; tiles of 64 keys
constexpr int kLKWarps = 4;
constexpr int kLKThreads = 32 * kLKWarps;
constexpr int kLKRows = 16 * kLKWarps;
constexpr int kLKKeys = 64;

// Shared-memory layout of a row-block kernel's block, in bytes: q rows,
// the ring of three K / V tiles, the float score rows (8 floats longer than
// the padded key axis, which puts a half-warp's float2 writes on distinct
// banks), k_pos, the key warps' row maxima, the row sums, vsum, and the
// int32 accumulator (rows DP + 1 words apart, for the atomics' banks).
struct RowLayout {
  int rb, es, skp;
  size_t q_off, ring_off, e_off, kp_off, mx_off, sum_off, vsum_off, acc_off,
      bytes;
};

__host__ __device__ inline RowLayout row_layout(int Sk, int hd) {
  RowLayout L;
  const int dp = padded_dim(hd);
  L.rb = dp + 16;
  L.skp = (Sk + kRBKeys - 1) / kRBKeys * kRBKeys;
  L.es = L.skp + 8;
  size_t off = 0;
  L.q_off = off;    off += (size_t)kRBRows * L.rb;
  L.ring_off = off; off += (size_t)3 * kRBKeys * L.rb;
  L.e_off = off;    off += (size_t)kRBRows * L.es * 4;
  L.kp_off = off;   off += (size_t)L.skp * 4;
  L.mx_off = off;   off += (size_t)kKW * kRBRows * 4;
  L.sum_off = off;  off += (size_t)kRBRows * 4;
  L.vsum_off = off; off += (size_t)dp * 4;
  L.acc_off = off;  off += (size_t)kRBRows * (dp + 1) * 4;
  L.bytes = off;
  return L;
}

// Shared-memory layout of a long-key kernel's block, in bytes: q rows, the
// ring of two K and two V tiles, their k_pos, vsum.
struct KeyLayout {
  int rb;
  size_t q_off, k_off, v_off, kp_off, vsum_off, bytes;
};

__host__ __device__ inline KeyLayout key_layout(int hd) {
  KeyLayout L;
  const int dp = padded_dim(hd);
  L.rb = dp + 16;
  size_t off = 0;
  L.q_off = off;    off += (size_t)kLKRows * L.rb;
  L.k_off = off;    off += (size_t)2 * kLKKeys * L.rb;
  L.v_off = off;    off += (size_t)2 * kLKKeys * L.rb;
  L.kp_off = off;   off += (size_t)2 * kLKKeys * 4;
  L.vsum_off = off; off += (size_t)dp * 4;
  L.bytes = off;
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// rows [0, rows) of DP bytes into dst (DP + 16 bytes apart) from src (hd
// bytes apart) by NT threads; zero past `valid` rows and past hd. `safe` is
// read nowhere: the address a zero-filling copy names.
template <int DP, int NT>
__device__ __forceinline__ void stage(unsigned char* dst, const int8_t* src,
                                      int rows, int valid, int hd, bool vec,
                                      const void* safe) {
  constexpr int RB = DP + 16;
  if (vec) {
    constexpr int C = DP / 16;
    for (int i = threadIdx.x; i < rows * C; i += NT) {
      const int r = i / C, c = i - (i / C) * C;
      const bool ok = r < valid && 16 * c < hd;
      cp_async16(dst + r * RB + 16 * c,
                 ok ? (const void*)(src + (size_t)r * hd + 16 * c) : safe,
                 ok);
    }
  } else {
    constexpr int W = DP / 4;
    for (int i = threadIdx.x; i < rows * W; i += NT) {
      const int r = i / W, w = i - (i / W) * W;
      const bool ok = r < valid && 4 * w < hd;
      cp_async4(dst + r * RB + 4 * w,
                ok ? (const void*)(src + (size_t)r * hd + 4 * w) : safe, ok);
    }
  }
}

// the A fragments of 16 q rows (RB bytes apart), one per 32-byte k-step
template <int DP>
__device__ __forceinline__ void q_fragments(const unsigned char* qs, int lane,
                                            uint32_t (&qf)[DP / 32][4]) {
  constexpr int RB = DP + 16;
#pragma unroll
  for (int ks = 0; ks < DP / 32; ++ks)
    ldmatrix_x4(qf[ks], qs + ((lane & 7) + ((lane >> 3) & 1) * 8) * RB
                            + 16 * (2 * ks + (lane >> 4)));
}

// the int32 scores of the 32 keys whose K rows start at kb: sa[n][e] is row
// g + 8 (e / 2), key 8 n + 2 t + e % 2
template <int DP>
__device__ __forceinline__ void score_chunk(const unsigned char* kb,
                                            const uint32_t (&qf)[DP / 32][4],
                                            int lane, int (&sa)[4][4]) {
  constexpr int RB = DP + 16;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[n][e] = 0;
#pragma unroll
  for (int ks = 0; ks < DP / 32; ++ks)
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      uint32_t bb[4];
      ldmatrix_x4(bb, kb + (16 * pr + (lane & 7) + ((lane >> 4) << 3)) * RB
                          + 16 * (2 * ks + ((lane >> 3) & 1)));
      mma_s8(sa[2 * pr], qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3], bb[0],
             bb[1]);
      mma_s8(sa[2 * pr + 1], qf[ks][0], qf[ks][1], qf[ks][2], qf[ks][3],
             bb[2], bb[3]);
    }
}

// s = acc * (q_scale k_scale), the softcap (CAP), the mask. The caller
// picks CAP once outside its loop over a chunk (a test of a run-time flag
// at each score would put each in a branch of its own)
template <bool CAP>
__device__ __forceinline__ float score(int acc, float qk, float cap,
                                       bool masked) {
  float x = (float)acc * qk;
  if (CAP) x = tanhf(x / cap) * cap;
  return masked ? kNegInf : x;
}

// calls f with std::true_type when use_cap, else std::false_type
template <class F>
__device__ __forceinline__ void with_cap(int use_cap, F&& f) {
  if (use_cap)
    f(std::true_type{});
  else
    f(std::false_type{});
}

// V's B fragments of dim group gr over the 32 keys whose rows start at vb:
// bq[h][c] is n-tile c's b_h (key rows 16 h + 8 (i / 2) + 2 t + i % 2)
template <int DP>
__device__ __forceinline__ void v_fragments(const unsigned char* vb, int gr,
                                            int g, int t,
                                            uint32_t (&bq)[2][4]) {
  constexpr int RB = DP + 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(
          vb + (16 * h + 8 * (i >> 1) + 2 * t + (i & 1)) * RB + 32 * gr
          + 4 * g);
    transpose_4x4(r, bq[h]);
  }
}

// Rounding without the divides. x, a float within 6 ulps of the quotient
// q the plain version rounds (|x| <= 256: 6 ulps of 256 are 9.2e-5, under
// 2^-12 = 2.4e-4), gives rint(q) unless x lies within 2^-12 of a
// half-integer, where q may round the other way (`near`: the caller
// divides). x + 1.5 * 2^23 rounds x to an integer, half to even, in the
// low bits of the sum: two adds, no branch.
__device__ __forceinline__ int rint_near(float x, bool& near) {
  const float t = x + 12582912.0f;
  near = fabsf(x - (t - 12582912.0f)) >= 0.5f - 0x1p-12f;
  return __float_as_int(t) - 0x4B400000;
}

// The plain version's code of exponential e of a row whose sum is `sum`,
// by its two IEEE divides: out of line, for the rare near-ties
__device__ __noinline__ uint32_t code_divide(float e, float sum, float ps) {
  const float p = e / sum;
  const float f = rintf(p / ps) + (-128.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(f, -128.0f), 127.0f);
}

// The code of e as e * inv, inv = 1 / (sum * ps): within 6 ulps of the
// divides' quotient (3 from inv and the product, 2 from the divides);
// clipped at 256, where both clip to 127
__device__ __forceinline__ uint32_t code_fast(float e, float inv,
                                              bool& near) {
  const int c = rint_near(fminf(e * inv, 256.0f), near);
  return (uint32_t)min(c, 255) ^ 0x80u;       // c - 128 as a byte
}

// 1 / (sum * ps), and whether code_fast may use it (both normal)
__device__ __forceinline__ float code_inv(float sum, float ps, bool& fast) {
  const float sp = sum * ps;
  const float inv = 1.0f / sp;
  fast = sp >= FLT_MIN && sp <= FLT_MAX && inv >= FLT_MIN && inv <= FLT_MAX;
  return inv;
}

// the code of row g + 8 h, key 8 n + 2 t + e of the lane's chunk goes to
// byte 2 (n % 2) + e of A register h + 2 (n / 2): logical keys 4 t + i of
// a0 / a1 and 16 + 4 t + i of a2 / a3
__device__ __forceinline__ void put_code(uint32_t (&a)[4], int n, int h,
                                         int e, uint32_t c) {
  a[h + 2 * (n >> 1)] |= c << (8 * (2 * (n & 1) + e));
}

// The 16 codes of a lane's chunk into the P.V A fragment: ex[n][e] is the
// exponential of row g + 8 (e / 2), key 8 n + 2 t + e % 2; in[n][e % 2]
// whether the key is below Sk, rv[h] whether row h has a softmax (codes 0
// otherwise); inv[h] and fast[h] from code_inv. Products, with selects and
// no branch; where any lane met a near-tie (or a row whose 1 / (sum ps) is
// not normal), the warp redoes its flagged codes by the divides. Called by
// whole warps.
__device__ __forceinline__ void chunk_codes(const float (&ex)[4][4],
                                            const bool (&in)[4][2],
                                            const bool (&rv)[2],
                                            const float (&sum)[2],
                                            const float (&inv)[2],
                                            const bool (&fast)[2], float ps,
                                            uint32_t (&a)[4]) {
  bool redo = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0u;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool ok = rv[h] & in[n][e & 1];
      bool near;
      const uint32_t c = code_fast(ex[n][e], inv[h], near);
      put_code(a, n, h, e & 1, ok ? c : 0u);
      redo |= ok & (near | !fast[h]);
    }
  if (__any_sync(0xffffffffu, redo)) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = 0u;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        if (rv[h] && in[n][e & 1]) {
          bool near;
          uint32_t c = code_fast(ex[n][e], inv[h], near);
          if (near || !fast[h]) c = code_divide(ex[n][e], sum[h], ps);
          put_code(a, n, h, e & 1, c);
        }
      }
  }
}

__device__ __noinline__ signed char requant_divide(float o, float os) {
  return (signed char)(int)fminf(fmaxf(rintf(o / os), -128.0f), 127.0f);
}

// clip(rint(o / os)) as the plain version's IEEE divide gives it: from
// o * inv (inv = 1 / os, within 3 ulps of the quotient) where rint_near
// decides, else by the divide
__device__ __forceinline__ int requant(float o, float inv, bool& near) {
  const int c = rint_near(fminf(fmaxf(o * inv, -256.0f), 256.0f), near);
  return max(-128, min(127, c));
}

// 4 outputs at idx: float32, or int8 at os (inv = 1 / os, fast as
// code_inv decides it; a thread with a near-tie divides its 4)
__device__ __forceinline__ void store4(float* out_f, int8_t* out_q,
                                       size_t idx, const float (&o)[4],
                                       float os, float inv, bool fast) {
  if (out_q != nullptr) {
    int c[4];
    bool redo = !fast;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool near;
      c[i] = requant(o[i], inv, near);
      redo |= near;
    }
    if (redo) {
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = requant_divide(o[i], os);
    }
    char4 q;
    q.x = (signed char)c[0];
    q.y = (signed char)c[1];
    q.z = (signed char)c[2];
    q.w = (signed char)c[3];
    *reinterpret_cast<char4*>(out_q + idx) = q;
  } else {
    *reinterpret_cast<float4*>(out_f + idx) = make_float4(o[0], o[1], o[2],
                                                          o[3]);
  }
}

// ---------------------------------------------------------------------------
// the row-block kernel: 32 rows a block, each row group's keys over 4 warps
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kRBThreads, row_blocks_per_sm(DP))
quant_flash_attention_kernel(const int8_t* __restrict__ q,
                             const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v,
                             const int* __restrict__ k_pos,
                             const float* __restrict__ q_scale,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ p_scale,
                             const float* __restrict__ v_scale,
                             const float* __restrict__ o_scale,
                             float* __restrict__ out_f,
                             int8_t* __restrict__ out_q, int Hq, int Hkv,
                             int Sq, int Sk, int hd, int use_cap, float cap,
                             int vec) {
  constexpr int RB = DP + 16;
  constexpr int G = DP / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowLayout L = row_layout(Sk, hd);
  unsigned char* Qs = smem + L.q_off;
  unsigned char* ring = smem + L.ring_off;
  float* eb = reinterpret_cast<float*>(smem + L.e_off);
  int* kps = reinterpret_cast<int*>(smem + L.kp_off);
  float* mxb = reinterpret_cast<float*>(smem + L.mx_off);
  float* sums = reinterpret_cast<float*>(smem + L.sum_off);
  int* vsum = reinterpret_cast<int*>(smem + L.vsum_off);
  int* accb = reinterpret_cast<int*>(smem + L.acc_off);
  const int es = L.es;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp / kKW, kw = warp - rg * kKW;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.y * kRBRows;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Sk * hd;
  const int8_t* kg = k + kv_base;
  const int8_t* vg = v + kv_base;
  const int* kp = k_pos + (size_t)b * Sk;
  const int tiles = (Sk + kRBKeys - 1) / kRBKeys;

  // ring slot step % 3 takes K's tile `step`, then, from step `tiles`, V's;
  // one commit group a step (empty past the last)
  auto load = [&](int step) {
    if (step < 2 * tiles) {
      const int kt = step < tiles ? step : step - tiles;
      const int j0 = kt * kRBKeys;
      const int valid = min(kRBKeys, Sk - j0);
      // rows up to the chunk boundary: no chunk past Sk is read
      stage<DP, kRBThreads>(ring + (size_t)(step % 3) * kRBKeys * RB,
                            (step < tiles ? kg : vg) + (size_t)j0 * hd,
                            (valid + 31) & ~31, valid, hd, vec, k);
    }
    cp_async_commit();
  };
  // two tiles in flight while one is used (a one-tile head gets K and V in
  // one round trip): wait for this one, then load the one after next into
  // the slot the last step used
  auto next = [&](int step) {
    cp_async_wait<1>();
    __syncthreads();                         // this tile landed; last used
    load(step + 2);
    return ring + (size_t)(step % 3) * kRBKeys * RB;
  };
  stage<DP, kRBThreads>(Qs, q + ((size_t)bh * Sq + q0) * hd, kRBRows,
                        min(kRBRows, Sq - q0), hd, vec, q);
  for (int i = tid; i < L.skp; i += kRBThreads)
    cp_async4(kps + i, i < Sk ? kp + i : k_pos, i < Sk);
  load(0);
  load(1);
  for (int i = tid; i < kRBRows * (DP + 1); i += kRBThreads) accb[i] = 0;
  for (int i = tid; i < DP; i += kRBThreads) vsum[i] = 0;

  const float qk = *q_scale * *k_scale;
  const float ps = *p_scale;
  const float pv = ps * *v_scale;
  const bool live = q0 + 16 * rg < Sq;      // warp-uniform
  const int r0 = 16 * rg + g;                // the lane's rows r0, r0 + 8

  // K: each warp's chunks' scores, to the row buffer, and its row maxima
  {
    uint32_t qf[G][4];
    float mx[2] = {-FLT_MAX, -FLT_MAX};
    for (int kt = 0; kt < tiles; ++kt) {
      const unsigned char* tl = next(kt);
      if (kt == 0) q_fragments<DP>(Qs + 16 * rg * RB, lane, qf);
      const int jc = kt * kRBKeys + 32 * kw;
      if (!live || jc >= Sk) continue;
      int sa[4][4];
      score_chunk<DP>(tl + 32 * kw * RB, qf, lane, sa);
      with_cap(use_cap, [&](auto cap_on) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int j = jc + 8 * n + 2 * t;
            float x[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              x[e] = score<decltype(cap_on)::value>(sa[n][2 * h + e], qk, cap,
                                                    kps[j + e] < 0);
              mx[h] = fmaxf(mx[h], j + e < Sk ? x[e] : -FLT_MAX);
            }
            *reinterpret_cast<float2*>(eb + (r0 + 8 * h) * es + j) =
                make_float2(x[0], x[1]);
          }
      });
    }
    // the row max over the quad, then over the key warps
    if (live) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      if (t == 0) {
        mxb[kw * kRBRows + r0] = mx[0];
        mxb[kw * kRBRows + r0 + 8] = mx[1];
      }
    }
  }
  __syncthreads();

  // exp(s - max) in place and the row sums in the plain version's order:
  // warp w takes rows 4 w .. 4 w + 3 side by side (for the overlap), lane l
  // keys l, l + 32, ... of each in turn
  {
    constexpr int RPW = kRBRows / (kRG * kKW);
    const int rw = RPW * warp;
    const int nr = max(0, min(RPW, Sq - q0 - rw));     // warp-uniform
    if (nr > 0) {
      float m[RPW], part[RPW];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        m[rr] = mxb[rw + rr];
#pragma unroll
        for (int w = 1; w < kKW; ++w)
          m[rr] = fmaxf(m[rr], mxb[w * kRBRows + rw + rr]);
        part[rr] = 0.0f;
      }
      // all RPW rows side by side (a row past Sq only computes what
      // nothing reads: its buffer row is the block's own)
      for (int j = lane; j < Sk; j += 32) {
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr) {
          float* ej = eb + (rw + rr) * es + j;
          const float e = expf(*ej - m[rr]);
          *ej = e;
          part[rr] += e;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          part[rr] += __shfl_xor_sync(0xffffffffu, part[rr], off);
      if (lane < nr) {
#pragma unroll
        for (int rr = 0; rr < RPW; ++rr)
          if (rr == lane) sums[rw + rr] = part[rr];
      }
    }
  }

  // V: each warp's chunks' codes and P.V over every dim; V's column sums
  int acc[4 * G][4];
#pragma unroll
  for (int n = 0; n < 4 * G; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  const bool rv[2] = {q0 + r0 < Sq, q0 + r0 + 8 < Sq};
  float sum[2], inv[2];
  bool fast[2];
  for (int kt = 0; kt < tiles; ++kt) {
    const unsigned char* tl = next(tiles + kt);
    if (kt == 0) {                           // next's sync ordered the sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] = rv[h] ? sums[r0 + 8 * h] : 1.0f;
        inv[h] = code_inv(sum[h], ps, fast[h]);
      }
    }
    const int jc = kt * kRBKeys + 32 * kw;
    if (live && jc < Sk) {
      float ex[4][4];
      bool in[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = jc + 8 * n + 2 * t;
        in[n][0] = j < Sk;
        in[n][1] = j + 1 < Sk;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 ev =
              *reinterpret_cast<const float2*>(eb + (r0 + 8 * h) * es + j);
          ex[n][2 * h] = ev.x;
          ex[n][2 * h + 1] = ev.y;
        }
      }
      uint32_t a[4];
      chunk_codes(ex, in, rv, sum, inv, fast, ps, a);
      const unsigned char* vb = tl + 32 * kw * RB;
#pragma unroll
      for (int gr = 0; gr < G; ++gr) {
        uint32_t bq[2][4];
        v_fragments<DP>(vb, gr, g, t, bq);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mma_s8(acc[4 * gr + c], a[0], a[1], a[2], a[3], bq[0][c],
                 bq[1][c]);
      }
    }
    // V's column sums over this tile: a thread takes 4 dims (one word) of
    // a run of keys
    constexpr int COLS = DP / 4, SEGS = kRBThreads / COLS;
    constexpr int RUN = kRBKeys / SEGS;
    const int col = tid % COLS, seg = tid / COLS;
    const int run = min(RUN, Sk - kt * kRBKeys - seg * RUN);  // valid keys
    int cs[4] = {0, 0, 0, 0};
#pragma unroll 4
    for (int r = 0; r < run; ++r) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          tl + (seg * RUN + r) * RB + 4 * col);
#pragma unroll
      for (int c = 0; c < 4; ++c) cs[c] += (int)(int8_t)(w >> (8 * c));
    }
    if (run > 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c) atomicAdd(vsum + 4 * col + c, cs[c]);
    }
  }

  // the warps' int32 partials into the block's accumulator (exact); a warp
  // with no chunk (Sk <= 32 kw) holds zeros
  if (live && 32 * kw < Sk) {
#pragma unroll
    for (int gr = 0; gr < G; ++gr)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1);
          const int d = 32 * gr + 8 * t + 4 * (e & 1) + c;
          atomicAdd(accb + row * (DP + 1) + d, acc[4 * gr + c][e]);
        }
  }
  __syncthreads();

  const float os = out_q != nullptr ? *o_scale : 1.0f;
  const float inv_os = 1.0f / os;
  const bool fast_os = os >= FLT_MIN && inv_os <= FLT_MAX && inv_os >= FLT_MIN;
  const int hd4 = hd / 4;
  for (int i = tid; i < kRBRows * hd4; i += kRBThreads) {
    const int row = i / hd4, d0 = 4 * (i - row * hd4);
    if (q0 + row >= Sq) break;
    float o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)              // - zp * sum(v), zp = -128
      o[c] = (float)(accb[row * (DP + 1) + d0 + c] + 128 * vsum[d0 + c]) *
             pv;
    store4(out_f, out_q, ((size_t)bh * Sq + q0 + row) * hd + d0, o, os,
           inv_os, fast_os);
  }
}

// ---------------------------------------------------------------------------
// the long-key kernel: 64 rows a block, 16 a warp, three sweeps over the keys
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kLKThreads)
quant_flash_attention_tiled_kernel(const int8_t* __restrict__ q,
                                   const int8_t* __restrict__ k,
                                   const int8_t* __restrict__ v,
                                   const int* __restrict__ k_pos,
                                   const float* __restrict__ q_scale,
                                   const float* __restrict__ k_scale,
                                   const float* __restrict__ p_scale,
                                   const float* __restrict__ v_scale,
                                   const float* __restrict__ o_scale,
                                   float* __restrict__ out_f,
                                   int8_t* __restrict__ out_q, int Hq,
                                   int Hkv, int Sq, int Sk, int hd,
                                   int use_cap, float cap, int vec) {
  constexpr int RB = DP + 16;
  constexpr int G = DP / 32;          // k-steps of Q K^T; dim groups of P.V
  extern __shared__ __align__(128) unsigned char smem[];
  const KeyLayout L = key_layout(hd);
  unsigned char* Qs = smem + L.q_off;
  unsigned char* Ks = smem + L.k_off;
  unsigned char* Vs = smem + L.v_off;
  int* kps = reinterpret_cast<int*>(smem + L.kp_off);
  int* vsum = reinterpret_cast<int*>(smem + L.vsum_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.y * kLKRows;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Sk * hd;
  const int8_t* kg = k + kv_base;
  const int8_t* vg = v + kv_base;
  const int* kp = k_pos + (size_t)b * Sk;
  const int tiles = (Sk + kLKKeys - 1) / kLKKeys;
  const int steps = 3 * tiles;               // sweeps: max, sum, codes + P.V

  auto load_tile = [&](int kt, int slot, bool with_v) {
    const int j0 = kt * kLKKeys, valid = min(kLKKeys, Sk - j0);
    stage<DP, kLKThreads>(Ks + (size_t)slot * kLKKeys * RB,
                          kg + (size_t)j0 * hd, kLKKeys, valid, hd, vec, k);
    if (with_v)
      stage<DP, kLKThreads>(Vs + (size_t)slot * kLKKeys * RB,
                            vg + (size_t)j0 * hd, kLKKeys, valid, hd, vec, k);
    for (int i = tid; i < kLKKeys; i += kLKThreads)
      cp_async4(kps + slot * kLKKeys + i, i < valid ? kp + j0 + i : k_pos,
                i < valid);
  };

  stage<DP, kLKThreads>(Qs, q + ((size_t)bh * Sq + q0) * hd, kLKRows,
                        min(kLKRows, Sq - q0), hd, vec, q);
  load_tile(0, 0, false);
  cp_async_commit();

  const float qk = *q_scale * *k_scale;
  const float ps = *p_scale;
  const float pv = ps * *v_scale;
  const bool live = q0 + 16 * warp < Sq;     // warp-uniform
  const uint32_t ones = 0x01010101u;

  uint32_t qf[G][4];
  float mx[2] = {-FLT_MAX, -FLT_MAX};
  float sum[2] = {1.0f, 1.0f}, inv[2];
  bool fast[2] = {false, false};
  float part[2][4][2];                       // [row g / g + 8][n-tile][e]
  int acc[4 * G][4];
  int vs[G][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 4; ++n) part[h][n][0] = part[h][n][1] = 0.0f;
#pragma unroll
  for (int n = 0; n < 4 * G; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
#pragma unroll
  for (int n = 0; n < G; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) vs[n][e] = 0;

  for (int step = 0; step < steps; ++step) {
    const int sweep = step / tiles;
    const int kt = step - sweep * tiles;
    cp_async_wait<0>();
    __syncthreads();                         // this tile landed; last used
    if (step == 0) q_fragments<DP>(Qs + 16 * warp * RB, lane, qf);
    if (step + 1 < steps) {
      const int nsweep = (step + 1) / tiles;
      load_tile(step + 1 - nsweep * tiles, (step + 1) & 1, nsweep == 2);
      cp_async_commit();
    }
    const int slot = step & 1;
    const unsigned char* kt_s = Ks + (size_t)slot * kLKKeys * RB;
    const unsigned char* vt_s = Vs + (size_t)slot * kLKKeys * RB;
    const int* kp_s = kps + slot * kLKKeys;
    const int j0 = kt * kLKKeys;

#pragma unroll
    for (int ch = 0; ch < kLKKeys / 32; ++ch) {
      const int jc = j0 + 32 * ch;
      if (jc >= Sk) break;                   // block-uniform
      // the chunk's scores: s[n][e] is row g + 8 (e / 2), key
      // jc + 8 n + 2 t + e % 2
      float s[4][4];
      bool in[4][2];                         // key < Sk, by [n][e % 2]
      if (live) {
        int sa[4][4];
        score_chunk<DP>(kt_s + (size_t)(32 * ch) * RB, qf, lane, sa);
        with_cap(use_cap, [&](auto cap_on) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 32 * ch + 8 * n + 2 * t + (e & 1);  // in tile
              in[n][e & 1] = j0 + j < Sk;
              s[n][e] = score<decltype(cap_on)::value>(sa[n][e], qk, cap,
                                                       kp_s[j] < 0);
            }
        });
      }
      // keys past Sk add nothing: -FLT_MAX to the max, +0 to the sum
      if (sweep == 0) {
        if (live) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mx[e >> 1] = fmaxf(mx[e >> 1],
                                 in[n][e & 1] ? s[n][e] : -FLT_MAX);
        }
      } else if (sweep == 1) {
        if (live) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = expf(s[n][e] - mx[e >> 1]);
              part[e >> 1][n][e & 1] += in[n][e & 1] ? x : 0.0f;
            }
        }
      } else {
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        if (live) {
          float ex[4][4];
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              ex[n][e] = expf(s[n][e] - mx[e >> 1]);
          const bool rv[2] = {true, true};
          chunk_codes(ex, in, rv, sum, inv, fast, ps, a);
        }
        const unsigned char* vb = vt_s + (size_t)(32 * ch) * RB;
#pragma unroll
        for (int gr = 0; gr < G; ++gr) {
          uint32_t bq[2][4];
          v_fragments<DP>(vb, gr, g, t, bq);
          if (live) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              mma_s8(acc[4 * gr + c], a[0], a[1], a[2], a[3], bq[0][c],
                     bq[1][c]);
          }
          const uint32_t b0 = warp == 0 ? bq[0][0] : warp == 1 ? bq[0][1]
                            : warp == 2 ? bq[0][2] : bq[0][3];
          const uint32_t b1 = warp == 0 ? bq[1][0] : warp == 1 ? bq[1][1]
                            : warp == 2 ? bq[1][2] : bq[1][3];
          mma_s8(vs[gr], ones, ones, ones, ones, b0, b1);
        }
      }
    }

    if (kt == tiles - 1 && live) {
      if (sweep == 0) {                      // the row max over the quad
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        }
      } else if (sweep == 1) {               // the warp-order butterfly
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float r[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a0 = part[h][0][e] + part[h][2][e];   // lanes ^ 16
            const float a1 = part[h][1][e] + part[h][3][e];
            r[e] = a0 + a1;                                    // ^ 8
            r[e] += __shfl_xor_sync(0xffffffffu, r[e], 2);     // ^ 4
            r[e] += __shfl_xor_sync(0xffffffffu, r[e], 1);     // ^ 2
          }
          sum[h] = r[0] + r[1];                                // ^ 1
          inv[h] = code_inv(sum[h], ps, fast[h]);
        }
      }
    }
  }

  // vsum of tile `warp` of each dim group: its row g holds columns 2 t + j,
  // dims 32 G + 8 t + 4 j + warp
  if (g == 0) {
#pragma unroll
    for (int gr = 0; gr < G; ++gr) {
      vsum[32 * gr + 8 * t + warp] = vs[gr][0];
      vsum[32 * gr + 8 * t + 4 + warp] = vs[gr][1];
    }
  }
  __syncthreads();
  if (!live) return;

  const float os = out_q != nullptr ? *o_scale : 1.0f;
  const float inv_os = 1.0f / os;
  const bool fast_os = os >= FLT_MIN && inv_os <= FLT_MAX && inv_os >= FLT_MIN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= Sq) continue;
    const size_t base = ((size_t)bh * Sq + row) * hd;
#pragma unroll
    for (int gr = 0; gr < G; ++gr)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d0 = 32 * gr + 8 * t + 4 * j;
        if (d0 >= hd) continue;
        float o[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)          // - zp * sum(v), zp = -128
          o[c] = (float)(acc[4 * gr + c][2 * h + j] + 128 * vsum[d0 + c])
                 * pv;
        store4(out_f, out_q, base + d0, o, os, inv_os, fast_os);
      }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, const void* k_pos,
           const void* q_scale, const void* k_scale, const void* p_scale,
           const void* v_scale, const void* o_scale, void* out_f,
           void* out_q, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
           int use_cap, float cap, int tiled, int vec, cudaStream_t st) {
  auto kernel = tiled ? quant_flash_attention_tiled_kernel<DP>
                      : quant_flash_attention_kernel<DP>;
  const size_t bytes = tiled ? key_layout(hd).bytes : row_layout(Sk, hd).bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();                    // leave no sticky error
      return (int)err;
    }
  }
  const int rows = tiled ? kLKRows : kRBRows;
  const dim3 grid(B * Hq, (Sq + rows - 1) / rows);
  kernel<<<grid, tiled ? kLKThreads : kRBThreads, bytes, st>>>(
      (const int8_t*)q, (const int8_t*)k, (const int8_t*)v,
      (const int*)k_pos, (const float*)q_scale, (const float*)k_scale,
      (const float*)p_scale, (const float*)v_scale, (const float*)o_scale,
      (float*)out_f, (int8_t*)out_q, Hq, Hkv, Sq, Sk, hd, use_cap, cap, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Head dims over 256: the wide kernel
// ---------------------------------------------------------------------------
// A simple kernel that takes any head dim (a multiple of 4), where the
// tensor-core kernels' fragments of the whole head dim would not fit. One
// warp per query row, 4 rows a block; the output's columns are split into
// chunks of 256, a grid axis, and each chunk's block recomputes the row's
// scores and its softmax in the plain version's order, so the result is
// the plain version's bit for bit, as the tensor-core kernels' is. Lane l
// holds keys l, l + 32, ...: the warp takes a tile of 32 keys' int32 dots
// in turn, lane l adding the head dim's words l, l + 32, ... by __dp4a
// (the K row read coalesced) and the lanes adding by shuffles (exact, so
// the order needs no care), lane t keeping key t's. The warp sweeps the
// keys three times, recomputing the scores: the row max (an exact fmaxf),
// the sum of exp(s - max) in softmax_sum's order (lane l adds its keys in
// turn, then the butterfly over 16, 8, 4, 2, 1), and the codes by the IEEE
// divides, (e / sum) / p_scale. Each tile of 32 keys then
// broadcasts its codes plus 128 (the zero point folded in: sum (c + 128)
// v = sum c v + 128 vsum, exact in int32) and every lane adds them into
// its 8 columns' int32 sums.
constexpr int kWideRows = 4;              // query rows (warps) a block
constexpr int kWideCols = 256;            // output columns a block

__global__ void __launch_bounds__(32 * kWideRows)
quant_flash_attention_wide_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ k,
    const int8_t* __restrict__ v, const int* __restrict__ k_pos,
    const float* __restrict__ q_scale, const float* __restrict__ k_scale,
    const float* __restrict__ p_scale, const float* __restrict__ v_scale,
    const float* __restrict__ o_scale, float* __restrict__ out_f,
    int8_t* __restrict__ out_q, int Hq, int Hkv, int Sq, int Sk, int hd,
    int use_cap, float cap) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int row = blockIdx.y * kWideRows + warp;
  if (row >= Sq) return;
  const int c0 = blockIdx.z * kWideCols + 8 * lane;   // the lane's columns
  const int b = bh / Hq;
  const int kvh = (bh - b * Hq) / (Hq / Hkv);
  const int words = hd / 4;
  const int* qw = reinterpret_cast<const int*>(q + ((size_t)bh * Sq + row)
                                               * hd);
  const int8_t* kb = k + ((size_t)b * Hkv + kvh) * Sk * hd;
  const int8_t* vb = v + ((size_t)b * Hkv + kvh) * Sk * hd;
  const int* kp = k_pos + (size_t)b * Sk;
  const float qk = *q_scale * *k_scale;
  const float ps = *p_scale;
  const float pv = ps * *v_scale;
  // the score of key t0 + lane (lanes past Sk: unused), the warp's dots
  // one key after another
  auto score = [&](int t0) {
    const int n = min(32, Sk - t0);
    int dot = 0;
    for (int t = 0; t < n; ++t) {
      const int* kw = reinterpret_cast<const int*>(kb + (size_t)(t0 + t)
                                                   * hd);
      int x = 0;
      for (int w = lane; w < words; w += 32) x = __dp4a(qw[w], kw[w], x);
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == t) dot = x;
    }
    float s = (float)dot * qk;
    if (use_cap) s = tanhf(s / cap) * cap;
    return lane < n && kp[t0 + lane] < 0 ? kNegInf : s;
  };
  float mx = -INFINITY;
  for (int t0 = 0; t0 < Sk; t0 += 32) {
    const float s = score(t0);
    if (t0 + lane < Sk) mx = fmaxf(mx, s);
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
  for (int t0 = 0; t0 < Sk; t0 += 32) {
    const float e = expf(score(t0) - mx);
    if (t0 + lane < Sk) sum = t0 == 0 ? e : sum + e;
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1)
    sum = sum + __shfl_down_sync(0xffffffffu, sum, o);
  sum = __shfl_sync(0xffffffffu, sum, 0);
  int acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0;
  for (int t0 = 0; t0 < Sk; t0 += 32) {
    const float s = score(t0);
    int w = 0;                              // the code plus 128
    if (t0 + lane < Sk) {
      const float p = expf(s - mx) / sum;
      w = (int)fminf(fmaxf(rintf(p / ps), 0.0f), 255.0f);
    }
    const int n = min(32, Sk - t0);
    for (int t = 0; t < n; ++t) {
      const int wt = __shfl_sync(0xffffffffu, w, t);
      if (wt == 0) continue;
      const int8_t* vr = vb + (size_t)(t0 + t) * hd;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c0 + e < hd) acc[e] += wt * (int)vr[c0 + e];
    }
  }
  const size_t base = ((size_t)bh * Sq + row) * hd;
  const float os = out_q != nullptr ? *o_scale : 1.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (c0 + e >= hd) continue;
    const float o = (float)acc[e] * pv;
    if (out_q != nullptr)
      out_q[base + c0 + e] =
          (int8_t)fminf(fmaxf(rintf(o / os), -128.0f), 127.0f);
    else
      out_f[base + c0 + e] = o;
  }
}

int launch_wide(const void* q, const void* k, const void* v,
                const void* k_pos, const void* q_scale, const void* k_scale,
                const void* p_scale, const void* v_scale,
                const void* o_scale, void* out_f, void* out_q, int B, int Hq,
                int Hkv, int Sq, int Sk, int hd, int use_cap, float cap,
                cudaStream_t st) {
  const dim3 grid(B * Hq, (Sq + kWideRows - 1) / kWideRows,
                  (hd + kWideCols - 1) / kWideCols);
  quant_flash_attention_wide_kernel<<<grid, 32 * kWideRows, 0, st>>>(
      (const int8_t*)q, (const int8_t*)k, (const int8_t*)v,
      (const int*)k_pos, (const float*)q_scale, (const float*)k_scale,
      (const float*)p_scale, (const float*)v_scale, (const float*)o_scale,
      (float*)out_f, (int8_t*)out_q, Hq, Hkv, Sq, Sk, hd, use_cap, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block of the row-block kernel takes
// for Sk keys of dim hd (the long-key kernel's does not depend on Sk).
extern "C" long long samp_quant_flash_attention_smem(int Sk, int hd) {
  return (long long)row_layout(Sk, hd).bytes;
}

// q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd): int8, contiguous, hd % 4 == 0
// (over 256 the wide kernel, which ignores `tiled`), Hq % Hkv == 0; k_pos
// (B, Sk) int32; the five scales are device scalars (o_scale null for float
// output). Exactly one of out_f (B, Hq, Sq, hd) float32 / out_q int8 is
// non-null. use_cap selects the softcap cap; tiled selects the long-key
// kernel, for a key axis whose row-block kernel would overflow shared
// memory.
extern "C" int samp_quant_flash_attention(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_scale, const void* k_scale, const void* p_scale,
    const void* v_scale, const void* o_scale, void* out_f, void* out_q,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd, int use_cap, float cap,
    int tiled, void* stream) {
  if (B > 0 && Hq > 0 && Sq > 0 && Sk > 0) {
    if (hd <= 0 || hd % 4 || Hkv <= 0 || Hq % Hkv)
      return (int)cudaErrorInvalidValue;
    if (hd > kMaxDim)                     // over 256: the wide kernel
      return launch_wide(q, k, v, k_pos, q_scale, k_scale, p_scale, v_scale,
                         o_scale, out_f, out_q, B, Hq, Hkv, Sq, Sk, hd,
                         use_cap, cap, (cudaStream_t)stream);
    const int vec = hd % 16 == 0 && ((uintptr_t)q | (uintptr_t)k |
                                     (uintptr_t)v) % 16 == 0;
    auto* st = (cudaStream_t)stream;
#define SAMP_QFA_LAUNCH(DP)                                                  \
  return launch<DP>(q, k, v, k_pos, q_scale, k_scale, p_scale, v_scale,     \
                    o_scale, out_f, out_q, B, Hq, Hkv, Sq, Sk, hd, use_cap, \
                    cap, tiled, vec, st)
    switch (padded_dim(hd)) {
      case 32: SAMP_QFA_LAUNCH(32);
      case 64: SAMP_QFA_LAUNCH(64);
      case 128: SAMP_QFA_LAUNCH(128);
      default: SAMP_QFA_LAUNCH(256);
    }
#undef SAMP_QFA_LAUNCH
  }
  return (int)cudaGetLastError();
}
