// Fused token + position + segment embedding.
//
// Replaces src/repro/kernels/fused_embed.py:66, the Pallas _kernel of
// fused_embed, driven by scalar-prefetched ids: out[i] = tok[tokens[i]]
// + pos[positions[i]] + seg[segments[i]], in one pass instead of three
// gathers and two adds. (The TPU kernel's token-row scale has no caller:
// archs that scale embeddings do so after the sum.)
//
// Bound on the H100: bytes. Each output row reads three table rows and
// writes one (16 bytes per element in float32) with two adds per element;
// a BERT forward's 1024 rows of 768 move ~3 MB, a few microseconds, so one
// round trip to memory is most of the call.
//
// Design: a warp per output row (a part of one where a row has fewer than
// 32 float4s), several rows a block of 128 threads. Lane 0 of the row
// reads its three ids (the TPU kernel's scalar prefetch) and hands them to
// the row's other lanes by shuffle; then each lane issues all its token,
// position and segment loads (16-byte float4s, lane l on float4s l, l + 32,
// ...; up to 8 a table, so all of a row of up to 1024 values) before any
// add, so the row's reads are one round trip, and writes float4s. The sum
// is (tok + pos) + seg, as the plain version adds, so the output equals it
// bit for bit. 4-byte loads where D % 4 != 0 or a table is not 16-byte
// aligned. Ids are clamped into their tables, as the plain version clamps
// them, so a bad id cannot read outside a table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;       // loads a lane issues from each table at once

struct Args {
  const int* tokens;
  const int* positions;
  const int* segments;        // null with seg
  const float* tok;
  const float* pos;
  const float* seg;           // or null
  float* out;
  int N, D, V, P, S;
};

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// T: float4 (16-byte loads) or float (4-byte loads); tpr lanes a row
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_embed_kernel(const Args a, int tpr) {
  const int lr = threadIdx.x / tpr;          // row within the block
  const int tr = threadIdx.x % tpr;          // lane within the row
  const long long row = (long long)blockIdx.x * (kThreads / tpr) + lr;
  const bool live = row < a.N;
  int t = 0, p = 0, g = 0;
  if (tr == 0 && live) {
    t = clamp_index(a.tokens[row], a.V);
    p = clamp_index(a.positions[row], a.P);
    g = a.seg != nullptr ? clamp_index(a.segments[row], a.S) : 0;
  }
  t = __shfl_sync(0xffffffffu, t, 0, tpr);
  p = __shfl_sync(0xffffffffu, p, 0, tpr);
  g = __shfl_sync(0xffffffffu, g, 0, tpr);
  if (!live) return;
  constexpr int kPer = sizeof(T) / sizeof(float);
  const int n = a.D / kPer;                  // Ts a row
  const T* tk = reinterpret_cast<const T*>(a.tok + (long long)t * a.D);
  const T* pr = reinterpret_cast<const T*>(a.pos + (long long)p * a.D);
  const T* sr = a.seg != nullptr
                    ? reinterpret_cast<const T*>(a.seg + (long long)g * a.D)
                    : nullptr;
  T* o = reinterpret_cast<T*>(a.out + row * a.D);
  for (int first = tr; first < n; first += kVec * tpr) {
    T x[kVec], y[kVec], z[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = first + k * tpr;
      if (i < n) {
        x[k] = __ldg(tk + i);
        y[k] = __ldg(pr + i);
        if (sr != nullptr) z[k] = __ldg(sr + i);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = first + k * tpr;
      if (i < n) {
        if constexpr (kPer == 4)
          o[i] = sr != nullptr ? add4(add4(x[k], y[k]), z[k])
                               : add4(x[k], y[k]);
        else
          o[i] = sr != nullptr ? (x[k] + y[k]) + z[k] : x[k] + y[k];
      }
    }
  }
}

}  // namespace

// tokens, positions: (N,) int32; segments: (N,) int32 or null (with seg
// null); tok (V, D), pos (P, D), seg (S, D) float32; out (N, D) float32;
// vec4: D % 4 == 0 and every table and out 16-byte aligned.
extern "C" int samp_fused_embed(const void* tokens, const void* positions,
                                const void* segments, const void* tok,
                                const void* pos, const void* seg, void* out,
                                int N, int D, int V, int P, int S, int vec4,
                                void* stream) {
  if (N > 0 && D > 0) {
    const Args a{(const int*)tokens, (const int*)positions,
                 (const int*)segments, (const float*)tok, (const float*)pos,
                 (const float*)seg, (float*)out, N, D, V, P, S};
    const int n = vec4 ? D / 4 : D;
    int tpr = 1;                              // a warp, or a part of one
    while (tpr < 32 && tpr < n) tpr *= 2;
    const int blocks = (N + kThreads / tpr - 1) / (kThreads / tpr);
    auto* st = (cudaStream_t)stream;
    if (vec4)
      fused_embed_kernel<float4><<<blocks, kThreads, 0, st>>>(a, tpr);
    else
      fused_embed_kernel<float><<<blocks, kThreads, 0, st>>>(a, tpr);
  }
  return (int)cudaGetLastError();
}
