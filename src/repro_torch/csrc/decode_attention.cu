// One-token GQA decode attention over a KV cache, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py:
// decode_attention_pallas (body _decode_kernel). Same contract: q
// (B, Hkv, G, D) against the cache k, v (B, Hkv, S, D); the valid columns of
// row b are [max(len_b - window, 0), len_b) (all of [0, len_b) without a
// window); scores are scaled by `scale`, optionally soft-capped
// (softcap * tanh(s / softcap)); softmax and the weighted sum run in f32;
// the output is acc / max(l, 1e-30), in q's dtype.
//
// What bounds it on this card, and what the design does about it: the
// bytes of the valid cache rows. The group of G query heads that shares a
// KV head (G = 1, 2 or 5 on the served configs, far below a tensor-core
// tile) is handled by one block per (batch, KV head), so each cache row is
// read once for all G heads. The block's 8 warps each take a run of keys;
// per key, the 32 lanes split D into 4-element pieces (8- or 16-byte loads)
// and each warp keeps its own online-softmax state; the states are merged
// in shared memory at the end, warp by warp in a fixed order. Only the
// valid rows are read: the lengths stay on the device and are read by the
// kernel, so no host copy is needed, and rows outside the window are
// never touched. One block per (batch, KV head) leaves SMs idle at a small
// batch; splitting S across blocks is later work.
// Every launch returns cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef long long ll;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int UNROLL = 4;
constexpr int DMAX = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Four consecutive elements as one 16-byte (f32) or 8-byte (bf16) load.
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&o)[4]) {
  const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// GMAX >= G query heads per KV head; lane owns elements
// [4 (lane + 32 i), 4 (lane + 32 i) + 4) of D for i < NQ (D <= 128 NQ).
template <typename T, int GMAX, int NQ>
__global__ void __launch_bounds__(WARPS * 32)
decode_kernel(const T* __restrict__ q, ll sqb, ll sqh, ll sqg, ll sqd,
              const T* __restrict__ k, ll skb, ll skh, ll sks,
              const T* __restrict__ v, ll svb, ll svh, ll svs,
              const int* __restrict__ lengths, T* __restrict__ out,
              int H, int G, int S, int D, float scale, float softcap,
              int window) {
  __shared__ float accs[GMAX][DMAX];
  __shared__ float mw[WARPS][GMAX], lw[WARPS][GMAX];
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < GMAX * DMAX; i += WARPS * 32)
    accs[i / DMAX][i % DMAX] = 0.0f;

  const int len = min(lengths[b], S);
  const int start = window > 0 ? max(len - window, 0) : 0;

  float qr[GMAX][NQ][4], acc[GMAX][NQ][4], m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (lane + 32 * i) + e;
        qr[g][i][e] = (g < G && d < D)
            ? widen(q[b * sqb + h * sqh + g * sqg + d * sqd]) * scale : 0.0f;
        acc[g][i][e] = 0.0f;
      }
  }
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;

  for (int j0 = start + warp * UNROLL; j0 < len; j0 += WARPS * UNROLL) {
    float kr[UNROLL][NQ][4], vr[UNROLL][NQ][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int j = j0 + u, d0 = 4 * (lane + 32 * i);
        if (j < len && d0 < D) {
          load4(kb + j * sks + d0, kr[u][i]);
          load4(vb + j * svs + d0, vr[u][i]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) kr[u][i][e] = vr[u][i][e] = 0.0f;
        }
      }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (j0 + u >= len) break;                  // uniform across the warp
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s += qr[g][i][e] * kr[u][i][e];
        s = warp_sum(s);
        if (softcap > 0.0f) s = softcap * tanhf(s / softcap);
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new), p = expf(s - m_new);
        l[g] = alpha * l[g] + p;
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[g][i][e] = alpha * acc[g][i][e] + p * vr[u][i][e];
        m[g] = m_new;
      }
    }
  }

  // merge the warps' states: rescale to the block-wide max, add in order
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GMAX; ++g) { mw[warp][g] = m[g]; lw[warp][g] = l[g]; }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float mx = NEG_INF;
        for (int x = 0; x < WARPS; ++x) mx = fmaxf(mx, mw[x][g]);
        const float sc = expf(m[g] - mx);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = 4 * (lane + 32 * i) + e;
            if (d < D) accs[g][d] += sc * acc[g][i][e];
          }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < G * D; i += WARPS * 32) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF, lsum = 0.0f;
    for (int x = 0; x < WARPS; ++x) mx = fmaxf(mx, mw[x][g]);
    for (int x = 0; x < WARPS; ++x) lsum += lw[x][g] * expf(mw[x][g] - mx);
    put(out + ((ll)(b * H + h) * G + g) * D + d, accs[g][d] / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int GMAX>
void launch_g(const T* q, ll sqb, ll sqh, ll sqg, ll sqd, const T* k, ll skb,
              ll skh, ll sks, const T* v, ll svb, ll svh, ll svs,
              const int* lengths, T* out, int B, int H, int G, int S, int D,
              float scale, float softcap, int window, cudaStream_t s) {
  const dim3 grid(B * H);
  if (D <= 128)
    decode_kernel<T, GMAX, 1><<<grid, WARPS * 32, 0, s>>>(
        q, sqb, sqh, sqg, sqd, k, skb, skh, sks, v, svb, svh, svs, lengths,
        out, H, G, S, D, scale, softcap, window);
  else
    decode_kernel<T, GMAX, 2><<<grid, WARPS * 32, 0, s>>>(
        q, sqb, sqh, sqg, sqd, k, skb, skh, sks, v, svb, svh, svs, lengths,
        out, H, G, S, D, scale, softcap, window);
}

template <typename T>
int launch(const void* q, ll sqb, ll sqh, ll sqg, ll sqd, const void* k,
           ll skb, ll skh, ll sks, const void* v, ll svb, ll svh, ll svs,
           const int* lengths, void* out, int B, int H, int G, int S, int D,
           float scale, float softcap, int window, cudaStream_t s) {
  const T* qq = (const T*)q; const T* kk = (const T*)k; const T* vv = (const T*)v;
  T* oo = (T*)out;
  if (G <= 1) launch_g<T, 1>(qq, sqb, sqh, sqg, sqd, kk, skb, skh, sks, vv, svb, svh, svs, lengths, oo, B, H, G, S, D, scale, softcap, window, s);
  else if (G <= 2) launch_g<T, 2>(qq, sqb, sqh, sqg, sqd, kk, skb, skh, sks, vv, svb, svh, svs, lengths, oo, B, H, G, S, D, scale, softcap, window, s);
  else if (G <= 4) launch_g<T, 4>(qq, sqb, sqh, sqg, sqd, kk, skb, skh, sks, vv, svb, svh, svs, lengths, oo, B, H, G, S, D, scale, softcap, window, s);
  else if (G <= 8) launch_g<T, 8>(qq, sqb, sqh, sqg, sqd, kk, skb, skh, sks, vv, svb, svh, svs, lengths, oo, B, H, G, S, D, scale, softcap, window, s);
  else return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// dtype_code 0 f32, 1 bf16. k and v have unit D stride, their S stride a
// multiple of 4 and 16-byte-aligned rows; q takes any strides. softcap <= 0
// means none, window <= 0 means none. out is (B, H, G, D) contiguous.
extern "C" int decode_attention_launch(
    const void* q, ll sqb, ll sqh, ll sqg, ll sqd, const void* k, ll skb,
    ll skh, ll sks, const void* v, ll svb, ll svh, ll svs, const int* lengths,
    void* out, int B, int H, int G, int S, int D, int dtype_code, float scale,
    float softcap, int window, void* stream) {
  if (D > DMAX || D % 4 != 0) return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  int err = dtype_code == 0
      ? launch<float>(q, sqb, sqh, sqg, sqd, k, skb, skh, sks, v, svb, svh, svs, lengths, out, B, H, G, S, D, scale, softcap, window, s)
      : launch<bf16>(q, sqb, sqh, sqg, sqd, k, skb, skh, sks, v, svb, svh, svs, lengths, out, B, H, G, S, D, scale, softcap, window, s);
  if (err) return err;
  return (int)cudaGetLastError();
}
