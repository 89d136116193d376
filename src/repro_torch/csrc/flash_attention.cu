// Flash attention (prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel). Same contract: q (B, Hq, Sq,
// D) against k, v (B, Hkv, Skv, D), query head h reading KV head
// h / (Hq / Hkv); q is scaled by `scale` before the product; optional soft
// cap softcap * tanh(s / softcap); masks col < kv_len, causal col <= row
// and window col > row - window, where rows and columns both count from 0
// (top-left alignment when Sq != Skv, unlike the usual GPU convention);
// masked scores are the finite NEG_INF = -1e30; online softmax in f32;
// output acc / max(l, 1e-30) in q's dtype. Key tiles that no row of the
// query tile can see are skipped, as the TPU kernel skips blocks.
//
// What bounds it on this card, and what the design does about it: at the
// served prompt lengths attention is a small share of prefill, bound by
// operations (4 * D flop per visible (row, col) pair). This first kernel
// runs them on CUDA cores in f32: one block of 8 warps per 32-row query
// tile and head; the query tile (pre-scaled) and one 32-key tile of K and V
// sit in shared memory as f32 (D up to 256: 96 KB of the 227 KB), lane j
// of a warp scores key j for the warp's 4 rows, and the P @ V step spreads
// D over the lanes, so the (32, 256) f32 accumulator is 32 registers a
// thread. q, k and v are read through their strides: the transposed head
// views of the model arrive without a copy. Tensor cores (mma/wgmma) are
// later work.
// Every launch returns cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef long long ll;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int WARPS = 8;
constexpr int RPW = 4;               // query rows per warp
constexpr int BQ = WARPS * RPW;      // 32 query rows per block
constexpr int BK = 32;               // keys per tile, one per lane

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct Args {
  ll sqb, sqh, sqs, sqd, skb, skh, sks, skd, svb, svh, svs, svd;
  int Hq, group, Sq, Skv, D, kv_len, causal, window;
  float softcap, scale;
};

inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D);
}

// Lane owns output columns d = lane + 32 i, i < ND (D <= 32 ND).
template <typename T, int ND>
__global__ void __launch_bounds__(WARPS * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, Args a) {
  extern __shared__ __align__(16) float smem[];
  const int D = a.D;
  float* Qs = smem;                    // [BQ][D], pre-scaled
  float* Ks = Qs + BQ * D;             // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.group;
  const T* qp = q + b * a.sqb + h * a.sqh;
  const T* kp = k + b * a.skb + hk * a.skh;
  const T* vp = v + b * a.svb + hk * a.svh;

  for (int i = tid; i < BQ * D; i += WARPS * 32) {
    const int r = i / D, d = i % D, row = q0 + r;
    Qs[i] = row < a.Sq ? widen(qp[row * a.sqs + d * a.sqd]) * a.scale : 0.0f;
  }

  // columns any row of this tile can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  int hi = a.causal ? q_last + 1 : a.Skv;
  hi = min(hi, a.kv_len);

  float acc[RPW][ND], m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[r][i] = 0.0f;
  }
  const int row0 = q0 + warp * RPW;

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();
    for (int i = tid; i < BK * D; i += WARPS * 32) {
      const int j = i / D, d = i % D, col = k0 + j;
      const bool in = col < a.Skv;
      Ks[j * (D + 1) + d] = in ? widen(kp[col * a.sks + d * a.skd]) : 0.0f;
      Vs[j * D + d] = in ? widen(vp[col * a.svs + d * a.svd]) : 0.0f;
    }
    __syncthreads();

    // scores: lane = key
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.0f;
    const float* kr = Ks + lane * (D + 1);
    for (int d = 0; d < D; d += 4) {
      const float k0v = kr[d], k1v = kr[d + 1], k2v = kr[d + 2], k3v = kr[d + 3];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (warp * RPW + r) * D + d);
        s[r] += qv.x * k0v + qv.y * k1v + qv.z * k2v + qv.w * k3v;
      }
    }
    const int col = k0 + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = row0 + r;
      float sr = s[r];
      if (a.softcap > 0.0f) sr = a.softcap * tanhf(sr / a.softcap);
      bool ok = col < a.kv_len;
      if (a.causal) ok = ok && col <= row;
      if (a.window > 0) ok = ok && col > row - a.window;
      sr = ok ? sr : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p);
      m[r] = m_new;
      s[r] = p;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[r][i] *= alpha;
    }
    // acc += P @ V: broadcast p of key j from lane j
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        vj[i] = d < D ? Vs[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[r][i] += pj * vj[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + r;
    if (row >= a.Sq) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    T* op = out + (((ll)b * a.Hq + h) * a.Sq + row) * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = lane + 32 * i;
      if (d < D) put(op + d, acc[r][i] * inv);
    }
  }
}

template <typename T, int ND>
int launch_nd(const void* q, const void* k, const void* v, void* out, int B,
              const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(a.D);
  auto kern = flash_kernel<T, ND>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, B);
  kern<<<grid, WARPS * 32, bytes, s>>>((const T*)q, (const T*)k, (const T*)v,
                                       (T*)out, a);
  return 0;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           const Args& a, cudaStream_t s) {
  if (a.D <= 32) return launch_nd<T, 1>(q, k, v, out, B, a, s);
  if (a.D <= 64) return launch_nd<T, 2>(q, k, v, out, B, a, s);
  if (a.D <= 128) return launch_nd<T, 4>(q, k, v, out, B, a, s);
  return launch_nd<T, 8>(q, k, v, out, B, a, s);
}

}  // namespace

// dtype_code 0 f32, 1 bf16. q, k, v take any strides; out is (B, Hq, Sq, D)
// contiguous. D is a multiple of 4 up to 256. softcap <= 0 means none,
// window <= 0 means none.
extern "C" int flash_attention_launch(
    const void* q, ll sqb, ll sqh, ll sqs, ll sqd, const void* k, ll skb,
    ll skh, ll sks, ll skd, const void* v, ll svb, ll svh, ll svs, ll svd,
    void* out, int B, int Hq, int Hkv, int Sq, int Skv, int D, int kv_len,
    int causal, int window, float softcap, float scale, int dtype_code,
    void* stream) {
  if (D > 256 || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (B * Hq * Sq == 0) return (int)cudaGetLastError();
  const Args a{sqb, sqh, sqs, sqd, skb, skh, sks, skd, svb, svh, svs, svd,
               Hq, Hq / Hkv, Sq, Skv, D, kv_len, causal, window, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int err = dtype_code == 0 ? launch<float>(q, k, v, out, B, a, s)
                                  : launch<bf16>(q, k, v, out, B, a, s);
  if (err) return err;
  return (int)cudaGetLastError();
}
