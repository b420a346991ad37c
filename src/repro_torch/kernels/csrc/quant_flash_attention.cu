// Fully-int8 bidirectional (encoder) attention with the uint8 softmax
// epilogue.
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
// under the int8 tensor cores' ridge of about 590. This first kernel is far
// from the bound: it runs its products with __dp4a on the CUDA cores and
// restages K and V once per query tile.
//
// Design: one block of 8 warps per (batch x head, tile of 32 query rows).
// The block stages the head's K (key-major, a padded odd word stride) and V
// (transposed to dims x keys, so four keys of one dim pack into one word)
// as int8 in shared memory, plus the int32 column sums of V over all Sk
// keys (the zero-point correction, padded keys included, as in the JAX
// kernel). The whole key axis is resident, so at Sk = 512 the block needs
// about 90 KB and opts in to more than 48 KB of dynamic shared memory. Each
// warp then takes one query row at a time: lane l scores keys l, l + 32,
// ... into a per-warp row buffer, the row max is a warp butterfly, each lane
// sums its keys' exponentials in key order and the 32 partials are added in
// a butterfly (pairs 16 apart, then 8, 4, 2, 1) — the order the plain
// version (repro_torch.kernels.flash_attention) repeats, since it sets the
// last bit of p and so the codes at ties. The codes go to a per-warp int8
// row, and each lane forms P.V for its output dims with __dp4a. Division
// is IEEE, rounding is rintf (half to even) and exp is expf: no fast math.
//
// Past a block's shared memory (Sk > 1336 at d = 64) a second kernel
// streams K and V through shared memory in tiles of 256 keys, in three
// sweeps over the key axis: the row maxima, then the sums of the
// exponentials, then the codes and P.V. Each sweep recomputes the scores
// (an exact int8 dot and the same float scaling), each lane still visits
// keys l, l + 32, ... in order (a tile starts on a multiple of 32), and
// P.V and the column sums of V are exact int32 sums, so it returns what
// the resident kernel returns, bit for bit, at three times the score work.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kTQ = kWarps * kRowsPerWarp;   // query rows per block
constexpr float kNegInf = -0.7f * FLT_MAX;

// Shared-memory layout of one block, in 32-bit words. Odd row strides keep
// the lanes of a warp, which read one row each, on distinct banks.
struct Layout {
  int kw;          // words per K row (d / 4)
  int ks;          // K row stride in words
  int sw;          // words per V^T row (keys / 4, rounded up)
  int vs;          // V^T row stride in words
  size_t k_off, v_off, vsum_off, q_off, s_off, c_off, words;
};

__host__ __device__ inline Layout layout(int Sk, int hd) {
  Layout L;
  L.kw = hd / 4;
  L.ks = L.kw | 1;
  L.sw = (Sk + 3) / 4;
  L.vs = L.sw | 1;
  size_t off = 0;
  L.k_off = off;    off += (size_t)Sk * L.ks;
  L.v_off = off;    off += (size_t)hd * L.vs;
  L.vsum_off = off; off += (size_t)hd;
  L.q_off = off;    off += (size_t)kTQ * L.kw;
  L.s_off = off;    off += (size_t)kWarps * L.sw * 4;   // one f32 row a warp
  L.c_off = off;    off += (size_t)kWarps * L.sw;       // one code row a warp
  L.words = off;
  return L;
}

__global__ void __launch_bounds__(kThreads)
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
                             int Sq, int Sk, int hd, int use_cap, float cap) {
  extern __shared__ int smem[];
  const Layout L = layout(Sk, hd);
  int* Ks = smem + L.k_off;
  int* Vt = smem + L.v_off;
  int* vsum = smem + L.vsum_off;
  int* Qs = smem + L.q_off;
  int8_t* vt8 = reinterpret_cast<int8_t*>(Vt);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.y * kTQ;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Sk * hd;
  const int* kg = reinterpret_cast<const int*>(k + kv_base);
  const int* vg = reinterpret_cast<const int*>(v + kv_base);
  const int* qg = reinterpret_cast<const int*>(q + (size_t)bh * Sq * hd);
  const int* kp = k_pos + (size_t)b * Sk;

  // stage K (key-major) and V^T (byte [d][j]); zero V^T's ragged key tail
  const int nw = Sk * L.kw;
  for (int i = tid; i < nw; i += kThreads) {
    const int j = i / L.kw;
    const int w = i - j * L.kw;
    Ks[j * L.ks + w] = kg[i];
    const int word = vg[i];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      vt8[(size_t)(4 * w + e) * L.vs * 4 + j] = (int8_t)(word >> (8 * e));
  }
  const int pad = L.sw * 4 - Sk;
  for (int i = tid; i < hd * pad; i += kThreads) {
    const int d = i / pad;
    vt8[(size_t)d * L.vs * 4 + Sk + (i - d * pad)] = 0;
  }
  for (int i = tid; i < kTQ * L.kw; i += kThreads) {
    const int r = i / L.kw;
    Qs[i] = (q0 + r < Sq) ? qg[(size_t)q0 * L.kw + i] : 0;
  }
  __syncthreads();
  for (int d = tid; d < hd; d += kThreads) {
    const int* row = Vt + (size_t)d * L.vs;
    int acc = 0;
    for (int w = 0; w < L.sw; ++w) acc = __dp4a(row[w], 0x01010101, acc);
    vsum[d] = acc;
  }
  __syncthreads();

  const float qk = *q_scale * *k_scale;
  const float ps = *p_scale;
  const float pv = ps * *v_scale;
  const float os = out_q != nullptr ? *o_scale : 1.0f;
  float* srow = reinterpret_cast<float*>(smem + L.s_off) +
                (size_t)warp * L.sw * 4;
  int* crow = smem + L.c_off + (size_t)warp * L.sw;
  int8_t* crow8 = reinterpret_cast<int8_t*>(crow);

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int lr = warp + kWarps * r;          // row within the tile
    const int qi = q0 + lr;
    if (qi >= Sq) break;                       // warp-uniform
    const int* qr = Qs + lr * L.kw;

    float mx = -FLT_MAX;
    for (int j = lane; j < Sk; j += 32) {
      const int* kr = Ks + (size_t)j * L.ks;
      int acc = 0;
      for (int w = 0; w < L.kw; ++w) acc = __dp4a(qr[w], kr[w], acc);
      float s = (float)acc * qk;
      if (use_cap) s = tanhf(s / cap) * cap;
      if (kp[j] < 0) s = kNegInf;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    float sum = 0.0f;
    for (int j = lane; j < Sk; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);

    for (int j = lane; j < L.sw * 4; j += 32) {
      int8_t c = 0;                            // ragged tail: code 0
      if (j < Sk) {
        const float p = srow[j] / sum;
        const float f = rintf(p / ps) + (-128.0f);
        c = (int8_t)(int)fminf(fmaxf(f, -128.0f), 127.0f);
      }
      crow8[j] = c;
    }
    __syncwarp();

    for (int d = lane; d < hd; d += 32) {
      const int* vr = Vt + (size_t)d * L.vs;
      int acc = 0;
      for (int w = 0; w < L.sw; ++w) acc = __dp4a(crow[w], vr[w], acc);
      acc += 128 * vsum[d];                    // - zp * sum(v), zp = -128
      const float o = (float)acc * pv;
      const size_t idx = ((size_t)bh * Sq + qi) * hd + d;
      if (out_q != nullptr) {
        const float c = fminf(fmaxf(rintf(o / os), -128.0f), 127.0f);
        out_q[idx] = (int8_t)(int)c;
      } else {
        out_f[idx] = o;
      }
    }
    __syncwarp();                              // code row is rewritten next
  }
}

constexpr int kTK = 256;                       // keys a tile (tiled kernel)
constexpr int kMaxDimsPerLane = 8;             // hd <= 256 (tiled kernel)

// Shared-memory layout of the tiled kernel's block, in 32-bit words.
struct TiledLayout {
  int kw, ks, vs;
  size_t k_off, v_off, vsum_off, q_off, c_off, words;
};

__host__ __device__ inline TiledLayout tiled_layout(int hd) {
  TiledLayout L;
  L.kw = hd / 4;
  L.ks = L.kw | 1;
  L.vs = (kTK / 4) | 1;
  size_t off = 0;
  L.k_off = off;    off += (size_t)kTK * L.ks;
  L.v_off = off;    off += (size_t)hd * L.vs;
  L.vsum_off = off; off += (size_t)hd;
  L.q_off = off;    off += (size_t)kTQ * L.kw;
  L.c_off = off;    off += (size_t)kWarps * (kTK / 4);  // one code row a warp
  L.words = off;
  return L;
}

__global__ void __launch_bounds__(kThreads)
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
                                   int use_cap, float cap) {
  extern __shared__ int smem[];
  const TiledLayout L = tiled_layout(hd);
  int* Ks = smem + L.k_off;
  int* Vt = smem + L.v_off;
  int* vsum = smem + L.vsum_off;
  int* Qs = smem + L.q_off;
  int8_t* vt8 = reinterpret_cast<int8_t*>(Vt);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = blockIdx.y * kTQ;
  const size_t kv_base = ((size_t)b * Hkv + hk) * Sk * hd;
  const int* kg = reinterpret_cast<const int*>(k + kv_base);
  const int* vg = reinterpret_cast<const int*>(v + kv_base);
  const int* qg = reinterpret_cast<const int*>(q + (size_t)bh * Sq * hd);
  const int* kp = k_pos + (size_t)b * Sk;

  for (int i = tid; i < kTQ * L.kw; i += kThreads) {
    const int r = i / L.kw;
    Qs[i] = (q0 + r < Sq) ? qg[(size_t)q0 * L.kw + i] : 0;
  }
  for (int d = tid; d < hd; d += kThreads) vsum[d] = 0;

  const float qk = *q_scale * *k_scale;
  const float ps = *p_scale;
  const float pv = ps * *v_scale;
  const float os = out_q != nullptr ? *o_scale : 1.0f;
  int* crow = smem + L.c_off + (size_t)warp * (kTK / 4);
  int8_t* crow8 = reinterpret_cast<int8_t*>(crow);

  float mx[kRowsPerWarp], sum[kRowsPerWarp];
  int acc[kRowsPerWarp][kMaxDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    mx[r] = -FLT_MAX;
    sum[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < kMaxDimsPerLane; ++e) acc[r][e] = 0;
  }

  // sweep 0: row maxima; 1: sums of exp(s - max); 2: codes and P.V
  for (int sweep = 0; sweep < 3; ++sweep) {
    for (int k0 = 0; k0 < Sk; k0 += kTK) {
      const int n = min(kTK, Sk - k0);
      const int nw = (n + 3) / 4;              // words of a V^T tile row
      __syncthreads();                         // previous tile fully used
      for (int i = tid; i < n * L.kw; i += kThreads) {
        const int j = i / L.kw;
        const int w = i - j * L.kw;
        Ks[j * L.ks + w] = kg[(size_t)k0 * L.kw + i];
        if (sweep == 2) {
          const int word = vg[(size_t)k0 * L.kw + i];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vt8[(size_t)(4 * w + e) * L.vs * 4 + j] = (int8_t)(word >> (8 * e));
        }
      }
      if (sweep == 2) {
        const int pad = nw * 4 - n;
        for (int i = tid; i < hd * pad; i += kThreads) {
          const int d = i / pad;
          vt8[(size_t)d * L.vs * 4 + n + (i - d * pad)] = 0;
        }
      }
      __syncthreads();
      if (sweep == 2) {
        for (int d = tid; d < hd; d += kThreads) {
          const int* row = Vt + (size_t)d * L.vs;
          int a = vsum[d];
          for (int w = 0; w < nw; ++w) a = __dp4a(row[w], 0x01010101, a);
          vsum[d] = a;
        }
      }

#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int lr = warp + kWarps * r;      // row within the tile
        if (q0 + lr >= Sq) break;              // warp-uniform
        const int* qr = Qs + lr * L.kw;
        const int jn = sweep == 2 ? nw * 4 : n;
        for (int j = lane; j < jn; j += 32) {
          float s = 0.0f;
          if (j < n) {
            const int* kr = Ks + (size_t)j * L.ks;
            int a = 0;
            for (int w = 0; w < L.kw; ++w) a = __dp4a(qr[w], kr[w], a);
            s = (float)a * qk;
            if (use_cap) s = tanhf(s / cap) * cap;
            if (kp[k0 + j] < 0) s = kNegInf;
          }
          if (sweep == 0) {
            mx[r] = fmaxf(mx[r], s);
          } else if (sweep == 1) {
            sum[r] += expf(s - mx[r]);
          } else {
            int8_t c = 0;                      // ragged tail: code 0
            if (j < n) {
              const float p = expf(s - mx[r]) / sum[r];
              const float f = rintf(p / ps) + (-128.0f);
              c = (int8_t)(int)fminf(fmaxf(f, -128.0f), 127.0f);
            }
            crow8[j] = c;
          }
        }
        if (sweep == 2) {
          __syncwarp();
#pragma unroll
          for (int e = 0; e < kMaxDimsPerLane; ++e) {
            const int d = lane + 32 * e;
            if (d < hd) {
              const int* vr = Vt + (size_t)d * L.vs;
              int a = acc[r][e];
              for (int w = 0; w < nw; ++w) a = __dp4a(crow[w], vr[w], a);
              acc[r][e] = a;
            }
          }
          __syncwarp();                        // code row is rewritten next
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      for (int off = 16; off > 0; off >>= 1) {
        if (sweep == 0)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        else if (sweep == 1)
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
      }
    }
  }
  __syncthreads();                             // vsum complete

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp + kWarps * r;
    if (qi >= Sq) break;
#pragma unroll
    for (int e = 0; e < kMaxDimsPerLane; ++e) {
      const int d = lane + 32 * e;
      if (d >= hd) continue;
      const int a = acc[r][e] + 128 * vsum[d];  // - zp * sum(v), zp = -128
      const float o = (float)a * pv;
      const size_t idx = ((size_t)bh * Sq + qi) * hd + d;
      if (out_q != nullptr) {
        const float c = fminf(fmaxf(rintf(o / os), -128.0f), 127.0f);
        out_q[idx] = (int8_t)(int)c;
      } else {
        out_f[idx] = o;
      }
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory one block takes for Sk keys of dim hd.
extern "C" long long samp_quant_flash_attention_smem(int Sk, int hd) {
  return (long long)layout(Sk, hd).words * 4;
}

// q (B, Hq, Sq, hd), k and v (B, Hkv, Sk, hd): int8, contiguous, hd % 4 == 0,
// Hq % Hkv == 0; k_pos (B, Sk) int32; the five scales are device scalars
// (o_scale null for float output). Exactly one of out_f (B, Hq, Sq, hd)
// float32 / out_q int8 is non-null. use_cap selects the softcap cap; tiled
// selects the kernel that streams K and V (hd <= 256), for a key axis whose
// resident block would overflow shared memory.
extern "C" int samp_quant_flash_attention(
    const void* q, const void* k, const void* v, const void* k_pos,
    const void* q_scale, const void* k_scale, const void* p_scale,
    const void* v_scale, const void* o_scale, void* out_f, void* out_q,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd, int use_cap, float cap,
    int tiled, void* stream) {
  if (B > 0 && Hq > 0 && Sq > 0 && Sk > 0) {
    if (tiled && hd > 32 * kMaxDimsPerLane) return (int)cudaErrorInvalidValue;
    auto* kernel = tiled ? quant_flash_attention_tiled_kernel
                         : quant_flash_attention_kernel;
    const size_t bytes = tiled ? tiled_layout(hd).words * 4
                               : layout(Sk, hd).words * 4;
    if (bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) {
        cudaGetLastError();                    // leave no sticky error
        return (int)err;
      }
    }
    const dim3 grid(B * Hq, (Sq + kTQ - 1) / kTQ);
    kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const int8_t*)k, (const int8_t*)v,
        (const int*)k_pos, (const float*)q_scale, (const float*)k_scale,
        (const float*)p_scale, (const float*)v_scale, (const float*)o_scale,
        (float*)out_f, (int8_t*)out_q, Hq, Hkv, Sq, Sk, hd, use_cap, cap);
  }
  return (int)cudaGetLastError();
}
