// Flash attention (prefill) for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _flash_kernel). Same contract: q (B, Hq, Sq,
// D) against k, v (B, Hkv, Skv, D), query head h reading KV head
// h / (Hq / Hkv); scores scaled by `scale`; optional soft cap
// softcap * tanh(s / softcap) before the mask; masks col < kv_len, causal
// col <= row and window col > row - window, where rows and columns both
// count from 0 (top-left alignment when Sq != Skv, unlike the usual GPU
// convention); masked scores are the finite NEG_INF = -1e30; online softmax
// in f32; output acc / max(l, 1e-30) in q's dtype. Key tiles that no row of
// the query tile can see are skipped, as the TPU kernel skips blocks.
//
// What bounds it on this card: operations, 4 * D flop per visible (row,
// col) pair, at the tensor cores' rate for bf16 and the CUDA cores' for
// f32. Three variants, picked by
// the caller from the operands (never by failure) and checked again here:
//  * mma (bf16, D a multiple of 16 up to 256, D stride 1, every other
//    stride and each base 16-byte aligned): FA2-style on tensor cores. One
//    block of 8 warps per 64 query rows and head: 16 rows a warp, and two
//    sets of 4 warps that split every 64-key tile into halves, each set
//    with its own online softmax, merged once through shared memory at the
//    end (twice the warps of one set per row: the served grids are small,
//    gemma2 S=512 is 128 blocks). Q is copied to shared memory once; tiles
//    of K and V are double-buffered through cp.async (16 bytes a thread)
//    into rows padded by 16 bytes (conflict-free ldmatrix), so the copy of
//    tile j+1 overlaps the math on tile j. S = Q K^T runs on mma.sync
//    m16n8k16 bf16 -> f32 (Q and K fragments by ldmatrix); scale, soft cap,
//    mask and the online softmax stay in registers (row max over the quad
//    by shuffles; exp2 and tanh on the SFU's ex2.approx); P is rounded to
//    bf16 in registers and reused as the A fragments of O += P V (V by
//    ldmatrix.trans), O in f32 registers: (16, 256) a warp at D=256, 128
//    registers a thread. D is a template constant for 64, 80, 128 and 256.
//    The one rounding the f32 kernel does not make is P in bf16 before
//    P V: at most 2^-9 max|v|.
//  * sflash (f32, D stride 1, the other strides multiples of 16 bytes,
//    16-byte aligned bases): true f32 on the CUDA cores (67 TFLOP/s; tensor
//    cores would mean TF32), FA2-style: 64 query rows a block, tiles of K
//    and V refilled through cp.async as soon as read, S = Q K^T and O += P V as
//    register-tiled SIMT products with float4 shared reads, the online
//    softmax in exp2 with log2 e folded into the scale.
//  * simt (bf16 or f32 operands that mma and sflash do not take; the
//    earlier design of both): CUDA cores in f32, one block of 8
//    warps per 32-row query tile and head; the query tile (pre-scaled) and
//    one 32-key tile of K and V sit in shared memory as f32, lane j of a
//    warp scores key j for the warp's 4 rows, and the P @ V step spreads D
//    over the lanes. Any strides, D a multiple of 4 up to 256.
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

// ------------------------------------------------------- bf16 tensor cores
constexpr int MMA_WARPS = 8;           // two sets of 4 warps
constexpr int MMA_BQ = 64;              // query rows per block, 16 a warp
constexpr int MMA_BKV = 64;             // keys per tile
constexpr int MMA_HALF = MMA_BKV / 2;   // keys per tile and warp set
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                        uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                          uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x and tanh(x) by the SFU's ex2.approx (relative error about 2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.0f - __fdividef(2.0f, fast_exp2(2.0f * LOG2E * x) + 1.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts (mma.m16n8k16): lane = 4 g + t. An accumulator tile of 8
// columns holds (row g, cols 2t, 2t+1) in [0], [1] and (row g+8, same cols)
// in [2], [3]; so two neighbouring score tiles of P are exactly the A
// fragment of a 16-key step of P V.
//
// Warp w owns query rows 16 (w % 4) .. + 15 of the block and the half
// w / 4 of every 64-key tile: the two warp sets run their online softmax
// over disjoint keys, and are merged once at the end. D is a template
// constant (EXACT) for the served head sizes; other multiples of 16 run
// with DMAX as the bound and D read at run time.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(MMA_WARPS * 32)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, Args a) {
  constexpr int NT = MMA_HALF / 8;     // score tiles of 8 keys per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = EXACT ? DMAX : a.D;
  const int LD = D + 8;                // padded row: 16 bytes more
  const int nk = D / 16;               // 16-wide steps of D
  const int chunks = D / 8;            // 16-byte chunks of a row
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* Ks = Qs + MMA_BQ * LD;                     // [2][BKV][LD]
  bf16* Vs = Ks + 2 * MMA_BKV * LD;                // [2][BKV][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = warp % 4, half = warp / 4;
  // the longest causal tiles first: they finish last
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.group;
  const bf16* qp = q + b * a.sqb + h * a.sqh;
  const bf16* kp = k + b * a.skb + hk * a.skh;
  const bf16* vp = v + b * a.svb + hk * a.svh;

  for (int i = tid; i < MMA_BQ * chunks; i += MMA_WARPS * 32) {
    const int r = i / chunks, c = (i % chunks) * 8, row = q0 + r;
    const bool in = row < a.Sq;
    cp_async16(smem_u32(Qs + r * LD + c), qp + (in ? row * a.sqs + c : 0), in);
  }

  // columns any row of this tile can see
  const int q_last = min(q0 + MMA_BQ, a.Sq) - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  int hi = a.causal ? q_last + 1 : a.Skv;
  hi = min(hi, a.kv_len);
  const int kbase = (lo / MMA_BKV) * MMA_BKV;
  const int ntiles = hi > kbase ? (hi - kbase + MMA_BKV - 1) / MMA_BKV : 0;

  auto load_kv = [&](int it, int buf) {
    const int k0 = kbase + it * MMA_BKV;
    bf16* kd = Ks + buf * MMA_BKV * LD;
    bf16* vd = Vs + buf * MMA_BKV * LD;
    for (int i = tid; i < MMA_BKV * chunks; i += MMA_WARPS * 32) {
      const int r = i / chunks, c = (i % chunks) * 8, col = k0 + r;
      const bool in = col < a.Skv;
      cp_async16(smem_u32(kd + r * LD + c), kp + (in ? col * a.sks + c : 0), in);
      cp_async16(smem_u32(vd + r * LD + c), vp + (in ? col * a.svs + c : 0), in);
    }
  };
  if (ntiles > 0) load_kv(0, 0);
  cp_commit();                          // Q and the first K/V tile

  float o[DMAX / 8][4];
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  const int r0 = q0 + rg * 16;          // the warp's first row
  const int row_g[2] = {r0 + g, r0 + g + 8};
  // ldmatrix addresses: lane -> (row, col) of the four 8x8 matrices
  const int lm = lane >> 3, lr = lane & 7;
  const uint32_t q_addr = smem_u32(Qs + (rg * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_off = (half * MMA_HALF + lr + (lm >> 1) * 8) * LD + (lm & 1) * 8;
  const int v_off = (half * MMA_HALF + lr + (lm & 1) * 8) * LD + (lm >> 1) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < ntiles) load_kv(it + 1, buf ^ 1);
    cp_commit();
    cp_wait<1>();                       // all but the newest group landed
    __syncthreads();
    const int k0 = kbase + it * MMA_BKV + half * MMA_HALF;   // this warp's keys
    bool see = k0 < hi;                 // can any row of this warp see them?
    if (a.causal && k0 > r0 + 15) see = false;
    if (a.window > 0 && k0 + MMA_HALF - 1 <= r0 - a.window) see = false;
    if (see) {
      const uint32_t kb = smem_u32(Ks + buf * MMA_BKV * LD + k_off);
      const uint32_t vb = smem_u32(Vs + buf * MMA_BKV * LD + v_off);
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      // S = Q K^T
#pragma unroll
      for (int kk = 0; kk < DMAX / 16; ++kk) {
        if (EXACT || kk < nk) {
          uint32_t qa[4];
          ldsm_x4(q_addr + kk * 32, qa[0], qa[1], qa[2], qa[3]);
#pragma unroll
          for (int jj = 0; jj < NT / 2; ++jj) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4(kb + (jj * 16 * LD + kk * 16) * 2, b0, b1, b2, b3);
            mma16816(s[2 * jj], qa, b0, b1);
            mma16816(s[2 * jj + 1], qa, b2, b3);
          }
        }
      }
      // scale, soft cap, mask
      const bool full = k0 + MMA_HALF <= a.kv_len &&
                        (!a.causal || k0 + MMA_HALF - 1 <= r0) &&
                        (a.window <= 0 || k0 > r0 + 15 - a.window);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (a.softcap > 0.0f) x = a.softcap * fast_tanh(x / a.softcap);
          if (!full) {
            const int row = row_g[e >> 1], col = k0 + j * 8 + 2 * t4 + (e & 1);
            bool ok = col < a.kv_len;
            if (a.causal) ok = ok && col <= row;
            if (a.window > 0) ok = ok && col > row - a.window;
            x = ok ? x : NEG_INF;
          }
          s[j][e] = x;
        }
      // online softmax: rows g and g + 8, each spread over the quad
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m_r[i];
#pragma unroll
        for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = fast_exp2((m_r[i] - mx) * LOG2E);
        m_r[i] = mx;
      }
      uint32_t pa[NT / 2][4];           // P in bf16: A fragments of P V
      float ls[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = fast_exp2((s[j][e] - m_r[e >> 1]) * LOG2E);
        ls[0] += p[0] + p[1];
        ls[1] += p[2] + p[3];
        pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      l_r[0] = l_r[0] * alpha[0] + ls[0];
      l_r[1] = l_r[1] * alpha[1] + ls[1];
#pragma unroll
      for (int j = 0; j < DMAX / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
      // O += P V
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
        for (int dp = 0; dp < DMAX / 16; ++dp) {
          if (EXACT || dp < nk) {
            uint32_t b0, b1, b2, b3;
            ldsm_x4_t(vb + (kk * 16 * LD + dp * 16) * 2, b0, b1, b2, b3);
            mma16816(o[2 * dp], pa[kk], b0, b1);
            mma16816(o[2 * dp + 1], pa[kk], b2, b3);
          }
        }
    }
    __syncthreads();                    // the buffer is refilled next
  }
  cp_wait<0>();

  // merge the two warp sets through shared memory (the tiles are free now)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const int LO = D + 8;                 // f32 row of the exchange
  float* xo = reinterpret_cast<float*>(smem_raw);        // [BQ][LO]
  float* xm = xo + MMA_BQ * LO;                          // [BQ]
  float* xl = xm + MMA_BQ;                               // [BQ]
  __syncthreads();
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < DMAX / 8; ++j)
      if (EXACT || j < D / 8)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(xo + (rg * 16 + g + 8 * i) * LO + j * 8 + 2 * t4) =
              make_float2(o[j][2 * i], o[j][2 * i + 1]);
    if (t4 == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xm[rg * 16 + g + 8 * i] = m_r[i];
        xl[rg * 16 + g + 8 * i] = l_r[i];
      }
  }
  __syncthreads();
  if (half == 1) return;
  float a0[2], a1[2], inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rg * 16 + g + 8 * i;
    const float m1 = xm[r], mx = fmaxf(m_r[i], m1);
    a0[i] = fast_exp2((m_r[i] - mx) * LOG2E);
    a1[i] = fast_exp2((m1 - mx) * LOG2E);
    inv[i] = 1.0f / fmaxf(l_r[i] * a0[i] + xl[r] * a1[i], 1e-30f);
  }
  bf16* op = out + ((ll)b * a.Hq + h) * a.Sq * D;
#pragma unroll
  for (int j = 0; j < DMAX / 8; ++j) {
    if (EXACT || j < D / 8) {
      const int col = j * 8 + 2 * t4;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row_g[i] < a.Sq) {
          const float2 o1 = *reinterpret_cast<const float2*>(
              xo + (rg * 16 + g + 8 * i) * LO + col);
          *reinterpret_cast<__nv_bfloat162*>(op + (ll)row_g[i] * D + col) =
              __floats2bfloat162_rn((o[j][2 * i] * a0[i] + o1.x * a1[i]) * inv[i],
                                    (o[j][2 * i + 1] * a0[i] + o1.y * a1[i]) * inv[i]);
        }
    }
  }
}

template <int DMAX, bool EXACT>
int launch_mma_d(const void* q, const void* k, const void* v, void* out, int B,
                 const Args& a, cudaStream_t s) {
  const size_t tiles = sizeof(bf16) * (size_t)(a.D + 8) * (MMA_BQ + 4 * MMA_BKV);
  const size_t merge = sizeof(float) * (size_t)MMA_BQ * (a.D + 10);
  const size_t bytes = tiles > merge ? tiles : merge;
  auto kern = flash_mma_kernel<DMAX, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + MMA_BQ - 1) / MMA_BQ, a.Hq, B);
  kern<<<grid, MMA_WARPS * 32, bytes, s>>>((const bf16*)q, (const bf16*)k,
                                           (const bf16*)v, (bf16*)out, a);
  return 0;
}

int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               const Args& a, cudaStream_t s) {
  switch (a.D) {                        // the served head sizes
    case 64: return launch_mma_d<64, true>(q, k, v, out, B, a, s);
    case 80: return launch_mma_d<80, true>(q, k, v, out, B, a, s);
    case 128: return launch_mma_d<128, true>(q, k, v, out, B, a, s);
    case 256: return launch_mma_d<256, true>(q, k, v, out, B, a, s);
  }
  if (a.D <= 128) return launch_mma_d<128, false>(q, k, v, out, B, a, s);
  return launch_mma_d<256, false>(q, k, v, out, B, a, s);
}

// ------------------------------------------------------- f32 CUDA cores
// sflash: f32 with D stride 1, every other stride a multiple of 4 elements
// and each base 16-byte aligned (sflash_ok), D a multiple of 4 up to 256.
// True f32 on the CUDA cores. One block of 256 threads per 64 query rows
// and head, so that each tile of K and V serves 64 rows (twice simt's 32).
// Q is copied to shared memory once; 64-key tiles of K and of V each have
// one buffer, refilled by 16-byte cp.async as soon as the step that reads
// it is done: K's next tile loads during P V, V's during the next Q K^T,
// so every copy overlaps math and D = 256 takes 64-key tiles too. Rows
// are padded to an odd number of 16-byte chunks, so that 8
// consecutive rows read as float4 fall in distinct bank groups. S = Q K^T
// and O += P V are two register-tiled SIMT products: lane (tr, tk) = (tid
// / 16, tid % 16) keeps the scores of rows tr + 16 i (i < 4) and keys tk +
// 16 j, reading Q and K along D as float4 (the 16 lanes of a row share
// each Q read), and the sums of O of the same rows at the float4 chunks tk
// + 16 c of D; P goes through shared memory and is read as float4 along
// the keys. Chunks past the last multiple of 16 (D = 80: 4, D = 96: 8) are
// spread as (row, chunk) pairs over the 16 lanes, so no lane idles in
// P V. The online softmax runs in log2 units (scale * log2 e folded into
// the scores, exp2): a row's max goes across its 16 lanes (a half warp) by
// shuffles each tile, its sum stays a partial a lane until the end. The
// grid is (heads, batch, query tiles) with the longest causal tiles first,
// so the card starts every head's longest tile before any shorter one. D
// is a template constant for the served head sizes (64, 80, 96, 128, 256);
// any other multiple of 4 runs with D read at run time.
namespace sf {

constexpr int THREADS = 256;
constexpr int BQ = 64;                  // query rows a block
constexpr int BKV = 64;                 // keys a tile
constexpr int KS = BKV / 16;            // keys a lane
constexpr int LP = BKV + 16;            // a row of P: a warp's two rows in other banks

// A staged row: D plus 4 or 8 floats, an odd number of 16-byte chunks.
__host__ __device__ constexpr int ld_of(int D) { return D + (D % 8 == 0 ? 4 : 8); }

inline size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(BQ + 2 * BKV) * ld_of(D) + (size_t)BQ * LP);
}

__device__ __forceinline__ float pick4(const float (&x)[4], int i) {
  return i == 0 ? x[0] : i == 1 ? x[1] : i == 2 ? x[2] : x[3];
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ void fma4(float (&o)[4], float p, const float4& v) {
  o[0] = fmaf(p, v.x, o[0]);
  o[1] = fmaf(p, v.y, o[1]);
  o[2] = fmaf(p, v.z, o[2]);
  o[3] = fmaf(p, v.w, o[3]);
}

// EXACT: D == DMAX. Else D (<= DMAX, a multiple of 4) is read at run time
// and a lane's last chunk column may lie past it.
template <int DMAX, bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
sflash_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, Args a) {
  constexpr int CH = DMAX / 4;                       // float4 chunks of D
  constexpr int NF = EXACT ? CH / 16 : (CH + 15) / 16;   // chunk columns a lane
  constexpr int REM = EXACT ? CH - 16 * NF : 0;      // the chunks past them
  constexpr int PL = (4 * REM + 15) / 16;            // (row, chunk) pairs a lane
  constexpr int PLA = PL > 0 ? PL : 1;
  extern __shared__ __align__(16) float smem[];
  const int D = EXACT ? DMAX : a.D, LD = ld_of(D), chunks = D / 4;
  float* Qs = smem;                     // [BQ][LD]
  float* Ks = Qs + BQ * LD;             // [BKV][LD]
  float* Vs = Ks + BKV * LD;            // [BKV][LD]
  float* Ps = Vs + BKV * LD;            // [BQ][LP]
  const int tid = threadIdx.x, tr = tid / 16, tk = tid % 16;
  // blocks start in the order of their index, heads fastest: the longest
  // causal tiles (the last rows) first, they finish last
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.group;
  const float* qp = q + b * a.sqb + h * a.sqh;
  const float* kp = k + b * a.skb + hk * a.skh;
  const float* vp = v + b * a.svb + hk * a.svh;

  for (int i = tid; i < BQ * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * 4, row = q0 + r;
    const bool in = row < a.Sq;
    cp_async16(smem_u32(Qs + r * LD + c), qp + (in ? row * a.sqs + c : 0), in);
  }

  // columns any row of this tile can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  int hi = a.causal ? q_last + 1 : a.Skv;
  hi = min(hi, a.kv_len);
  const int kbase = (lo / BKV) * BKV;
  const int ntiles = hi > kbase ? (hi - kbase + BKV - 1) / BKV : 0;

  auto load = [&](float* dst, const float* src, ll stride, int it) {
    const int k0 = kbase + it * BKV;
    for (int i = tid; i < BKV * chunks; i += THREADS) {
      const int r = i / chunks, c = (i % chunks) * 4, col = k0 + r;
      const bool in = col < a.Skv;
      cp_async16(smem_u32(dst + r * LD + c), src + (in ? col * stride + c : 0), in);
    }
  };
  if (ntiles > 0) load(Ks, kp, a.sks, 0);
  cp_commit();                          // Q and K's first tile
  if (ntiles > 0) load(Vs, vp, a.svs, 0);
  cp_commit();                          // V's first tile

  float o[4][NF][4], oe[PLA][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NF; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.0f;
  // pair p of this lane: row tr + 16 pr[p], chunk pc[p]
  int pr[PLA], pc[PLA];
  bool pok[PLA];
#pragma unroll
  for (int p = 0; p < PLA; ++p) {
    const int x = tk + 16 * p;
    pok[p] = PL > 0 && x < 4 * REM;
    pr[p] = REM > 0 ? x / REM : 0;
    pc[p] = 16 * NF + (REM > 0 ? x % REM : 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) oe[p][e] = 0.0f;
  }
  float m_r[4], l_r[4];                 // l_r: this lane's keys only, until the end
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = NEG_INF;
    l_r[i] = 0.0f;
  }
  const bool capped = a.softcap > 0.0f;
  const float sl = a.scale * LOG2E;     // scores in log2 units
  const float cap_in = capped ? a.scale / a.softcap : 0.0f;
  const float cap_out = a.softcap * LOG2E;
  const bool last_ok = EXACT || tk + 16 * (NF - 1) < chunks;   // the lane's last column
  const float* qr = Qs + tr * LD;
  const float* kr = Ks + tk * LD;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<1>();                       // K's tile (and Q) landed; V's may be in flight
    __syncthreads();
    const int k0 = kbase + it * BKV;

    // S = Q K^T
    float s[4][KS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[KS];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(qr + 16 * i * LD + d);
#pragma unroll
      for (int j = 0; j < KS; ++j) kv[j] = *reinterpret_cast<const float4*>(kr + 16 * j * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KS; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          s[i][j] = fmaf(qv[i].w, kv[j].w, x);
        }
    }
    // scale, soft cap, mask
    const bool full = k0 + BKV <= a.kv_len && (!a.causal || k0 + BKV - 1 <= q0) &&
                      (a.window <= 0 || k0 > q0 + BQ - 1 - a.window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        float x = capped ? cap_out * tanhf(s[i][j] * cap_in) : s[i][j] * sl;
        if (!full) {
          const int row = q0 + tr + 16 * i, col = k0 + tk + 16 * j;
          bool ok = col < a.kv_len;
          if (a.causal) ok = ok && col <= row;
          if (a.window > 0) ok = ok && col > row - a.window;
          x = ok ? x : NEG_INF;
        }
        s[i][j] = x;
      }
    // online softmax, each row over its half warp; P to shared memory
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KS; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(m_r[i], mx);
      alpha[i] = exp2f(m_r[i] - mx);
      m_r[i] = mx;
      float ls = 0.0f;
#pragma unroll
      for (int j = 0; j < KS; ++j) {
        const float p = exp2f(s[i][j] - mx);
        ls += p;
        Ps[(tr + 16 * i) * LP + tk + 16 * j] = p;
      }
      l_r[i] = l_r[i] * alpha[i] + ls;
#pragma unroll
      for (int c = 0; c < NF; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha[i];
    }
#pragma unroll
    for (int p = 0; p < PL; ++p) {
      const float al = pick4(alpha, pr[p]);
#pragma unroll
      for (int e = 0; e < 4; ++e) oe[p][e] *= al;
    }
    cp_wait<0>();                       // V's tile landed
    __syncthreads();                    // P and V are in; K's tile is read
    if (it + 1 < ntiles) load(Ks, kp, a.sks, it + 1);
    cp_commit();
    // O += P V
#pragma unroll 2
    for (int kq = 0; kq < BKV / 4; ++kq) {
      float4 pv[4], pe[PLA];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (tr + 16 * i) * LP + kq * 4);
#pragma unroll
      for (int p = 0; p < PL; ++p)
        pe[p] = pok[p] ? *reinterpret_cast<const float4*>(Ps + (tr + 16 * pr[p]) * LP + kq * 4)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* vr = Vs + (kq * 4 + kk) * LD;
        float4 vv[NF], ve[PLA];
#pragma unroll
        for (int c = 0; c < NF; ++c)
          vv[c] = (c < NF - 1 || last_ok)
                      ? *reinterpret_cast<const float4*>(vr + (tk + 16 * c) * 4)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int p = 0; p < PL; ++p)
          ve[p] = pok[p] ? *reinterpret_cast<const float4*>(vr + pc[p] * 4)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NF; ++c) fma4(o[i][c], comp(pv[i], kk), vv[c]);
#pragma unroll
        for (int p = 0; p < PL; ++p) fma4(oe[p], comp(pe[p], kk), ve[p]);
      }
    }
    __syncthreads();                    // V's tile and P are read
    if (it + 1 < ntiles) load(Vs, vp, a.svs, it + 1);
    cp_commit();
  }
  cp_wait<0>();

  float* op = out + ((ll)b * a.Hq + h) * a.Sq * D;
  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_r[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    inv[i] = 1.0f / fmaxf(l, 1e-30f);
    const int row = q0 + tr + 16 * i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NF; ++c)
      if (c < NF - 1 || last_ok)
        *reinterpret_cast<float4*>(op + (ll)row * D + (tk + 16 * c) * 4) =
            make_float4(o[i][c][0] * inv[i], o[i][c][1] * inv[i], o[i][c][2] * inv[i],
                        o[i][c][3] * inv[i]);
  }
#pragma unroll
  for (int p = 0; p < PL; ++p) {
    const int row = q0 + tr + 16 * pr[p];
    const float iv = pick4(inv, pr[p]);
    if (pok[p] && row < a.Sq)
      *reinterpret_cast<float4*>(op + (ll)row * D + pc[p] * 4) =
          make_float4(oe[p][0] * iv, oe[p][1] * iv, oe[p][2] * iv, oe[p][3] * iv);
  }
}

template <int DMAX, bool EXACT>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes(a.D);
  auto kern = sflash_kernel<DMAX, EXACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Hq, B, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, bytes, s>>>((const float*)q, (const float*)k, (const float*)v,
                                    (float*)out, a);
  return 0;
}

int launch(const void* q, const void* k, const void* v, void* out, int B,
           const Args& a, cudaStream_t s) {
  switch (a.D) {                        // the served head sizes
    case 64: return launch_d<64, true>(q, k, v, out, B, a, s);
    case 80: return launch_d<80, true>(q, k, v, out, B, a, s);
    case 96: return launch_d<96, true>(q, k, v, out, B, a, s);
    case 128: return launch_d<128, true>(q, k, v, out, B, a, s);
    case 256: return launch_d<256, true>(q, k, v, out, B, a, s);
  }
  if (a.D <= 64) return launch_d<64, false>(q, k, v, out, B, a, s);
  if (a.D <= 128) return launch_d<128, false>(q, k, v, out, B, a, s);
  return launch_d<256, false>(q, k, v, out, B, a, s);
}

}  // namespace sf

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// What the sflash variant takes (flash_variant in kernel.py mirrors it).
bool sflash_ok(const void* q, const void* k, const void* v, const ll* st, int D,
               int dtype_code) {
  if (dtype_code != 0 || D % 4 != 0 || D > 256) return false;
  if (st[3] != 1 || st[7] != 1 || st[11] != 1) return false;
  for (int i = 0; i < 12; ++i)          // batch, head and row strides
    if (i % 4 != 3 && st[i] % 4 != 0) return false;
  return aligned16(q) && aligned16(k) && aligned16(v);
}

// What the mma variant takes (flash_variant in kernel.py mirrors it).
bool mma_ok(const void* q, const void* k, const void* v, const ll* st, int D,
            int dtype_code) {
  if (dtype_code != 1 || D % 16 != 0 || D > 256) return false;
  if (st[3] != 1 || st[7] != 1 || st[11] != 1) return false;
  for (int i = 0; i < 12; ++i)          // batch, head and row strides
    if (i % 4 != 3 && st[i] % 8 != 0) return false;
  return aligned16(q) && aligned16(k) && aligned16(v);
}

}  // namespace

// dtype_code 0 f32, 1 bf16; variant 0 simt, 1 mma, 2 sflash (refused with
// cudaErrorInvalidValue when the operands do not allow it). q, k, v take any
// strides (simt) or the mma or sflash layout; out is (B, Hq, Sq, D)
// contiguous. D is a multiple of 4 up to 256. softcap <= 0 means none,
// window <= 0 none.
extern "C" int flash_attention_launch(
    const void* q, ll sqb, ll sqh, ll sqs, ll sqd, const void* k, ll skb,
    ll skh, ll sks, ll skd, const void* v, ll svb, ll svh, ll svs, ll svd,
    void* out, int B, int Hq, int Hkv, int Sq, int Skv, int D, int kv_len,
    int causal, int window, float softcap, float scale, int dtype_code,
    int variant, void* stream) {
  if (D > 256 || D % 4 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const ll st[12] = {sqb, sqh, sqs, sqd, skb, skh, sks, skd, svb, svh, svs, svd};
  const bool ok = variant == 0 || (variant == 1 && mma_ok(q, k, v, st, D, dtype_code)) ||
                  (variant == 2 && sflash_ok(q, k, v, st, D, dtype_code));
  if (!ok) return (int)cudaErrorInvalidValue;
  if (B * Hq * Sq == 0) return (int)cudaGetLastError();
  const Args a{sqb, sqh, sqs, sqd, skb, skh, sks, skd, svb, svh, svs, svd,
               Hq, Hq / Hkv, Sq, Skv, D, kv_len, causal, window, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  if (variant == 1) err = launch_mma(q, k, v, out, B, a, s);
  else if (variant == 2) err = sf::launch(q, k, v, out, B, a, s);
  else if (dtype_code == 0) err = launch<float>(q, k, v, out, B, a, s);
  else err = launch<bf16>(q, k, v, out, B, a, s);
  if (err) return err;
  return (int)cudaGetLastError();
}
