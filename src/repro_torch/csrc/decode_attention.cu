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
// bytes of the valid cache rows, read once for all G query heads of a KV
// head (G <= 8 on the dense configs, far below a tensor-core tile). A
// batch of 4 has only 4 * Hkv (batch, KV head) pairs, so the cache's S
// axis is split across blocks as well (flash-decoding): the grid is
// (B * Hkv, splits), `splits` chosen by the caller from S, B * Hkv and the
// SM count (decode_splits in kernel.py), never from the lengths, which
// stay on the device. Split j owns keys [j * chunk, (j + 1) * chunk) with
// chunk = ceil(S / splits) rounded up to 32 keys; a split that holds no
// valid key writes the empty state (m = -1e30, l = 0) and returns.
// Inside a split, 4 warps walk tiles of K and V staged in shared memory by
// 16-byte cp.async, at least one tile in flight ahead of the arithmetic
// (rows padded by 16 bytes, so a lane per key reads its row without bank
// conflicts): 32-key tiles, three stages, for rows over 256 bytes, else
// 64-key tiles (two keys a lane), two stages. Scores: lanes are keys, warps
// split D, and their partial sums meet in shared memory once per tile, so
// no shuffle runs per key. Softmax: one warp per head takes the tile's max
// and rescales once per tile, in log2 units (scale and log2 e folded into
// q; exp2 and tanh on the SFU's ex2.approx). P V: threads split D into
// 16-byte pieces and the tile's keys into groups; the groups' sums meet in
// shared memory once per split.
// That kernel (the `narrow` variant) keeps every head's P V accumulators
// in each thread, so it takes G <= 8 and D <= 256. MLA's absorbed decode
// has one latent KV head for all query heads: G = 40, D = 288 (minicpm3-4b),
// where 40 heads x 8 f32 accumulators per 16-byte piece do not fit in
// registers. The `wide` variant (split_wide_kernel) takes any G <= 40 and
// D <= 288 whose rows are a multiple of 16 bytes: 8 warps walk 32-key
// tiles (one key a lane; three stages for bf16, two for f32), each warp
// scoring its heads (w, w + 8, ...) over the whole row, so no partial
// scores cross warps, and taking their softmax in registers; then each
// thread owns one 16-byte piece of D for a fixed set of heads (at most
// GH, a template parameter) and adds the tile's keys into registers. Each
// split reads its K and V tiles once for all G heads, and no accumulator
// is shared, so the partials go straight to the workspace. A simple CUDA-
// core design: the m16n8k16 tensor-core form (40 query rows against
// 288-wide key tiles, as in FlashMLA) is left for later.
// Merge: a second small kernel in the same call (merge_kernel), a block
// per (batch, KV head, query head), combines the splits' (m, l, acc)
// partials, kept in an f32 workspace the caller allocates, in split
// order. It was chosen over a last-arriving-block
// merge because it keeps no state between calls (no ticket counters to
// reset) and its order, hence every bit of the output, is fixed.
// Optionally the merge also writes each row's natural log-sum-exp of its
// scaled (and capped) scores, f32 (B, Hkv, G): (m + log2 l) ln 2 from the
// largest split max m and the rescaled sum l it already holds (the scores
// are in log2 units), -inf for a row with no valid key, whose output is 0;
// the output is then f32, unrounded, so that the ranks' partials merge
// and round once, as one device's output does (rounded to q's dtype it is
// the output without lse, bit for bit). A caller whose cache is sharded
// by sequence passes each rank's local lengths (the global length minus
// the slice's first position, unclamped: <= 0 leaves the slice empty, a
// window start past S too) and merges the ranks' (out, lse).
// Every launch returns cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef long long ll;
typedef __nv_bfloat16 bf16;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 128;
constexpr int NW = THREADS / 32;
constexpr int ALIGN = 32;       // a split's keys are a multiple of this
constexpr int DMAX = 256;       // the narrow variant's largest D
constexpr int GNARROW = 8;      // the narrow variant's largest G
constexpr int WDMAX = 288;      // the largest D (the wide variant's)
constexpr int GMAX = 40;        // the largest G (the wide variant's)
constexpr int WTHREADS = 256;   // the wide variant's block
constexpr int WNW = WTHREADS / 32;
constexpr int WGW = (GMAX + WNW - 1) / WNW;   // heads a wide warp scores
constexpr int WTK = 32;         // keys a wide tile: one a lane
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SPLITS = 256;   // splits a merge takes (its weights' room)
constexpr int MERGE_THREADS = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 bytes of T (shared or global memory, 16-byte aligned), widened to f32
__device__ __forceinline__ void lds16(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void lds16(const bf16* p, float (&o)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x; o[2 * i + 1] = f.y;
  }
}

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

// 2^x and tanh(x) by the SFU's ex2.approx (relative error about 2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.0f - __fdividef(2.0f, fast_exp2(2.0f * LOG2E * x) + 1.0f);
}

__host__ __device__ constexpr int split_chunk(int S, int splits) {
  return ((S + splits - 1) / splits + ALIGN - 1) / ALIGN * ALIGN;
}

// A tile is 32 KPL keys, KPL a lane: 2 where a cache row is at most 256
// bytes (bf16 D <= 128, f32 D <= 64), halving the tile's serial phases per
// key, else 1. Tiles in flight: STAGES - 1.
__host__ __device__ constexpr int stages(int kpl) { return kpl == 1 ? 3 : 2; }

// Shared memory of one block: the tile ring (or, after the last tile, the
// key groups' P V sums), q, the warps' partial scores, P and the rescales.
template <typename T, int KPL>
__host__ __device__ constexpr int ring_bytes(int D) {
  return stages(KPL) * 2 * 32 * KPL * (D * (int)sizeof(T) + 16);
}
template <typename T, int KPL>
__host__ __device__ constexpr int smem_bytes(int D, int G) {
  const int ce = 16 / (int)sizeof(T), groups = THREADS / (D / ce), tk = 32 * KPL;
  const int ring = ring_bytes<T, KPL>(D), red = groups * G * D * 4;
  return (ring > red ? ring : red) + G * D * 4 + NW * G * tk * 4 + G * tk * 4 + G * 4;
}

struct Args {
  const void* q; ll sqb, sqh, sqg, sqd;
  const void* k; ll skb, skh, sks;
  const void* v; ll svb, svh, svs;
  const int* lengths;
  float* ws;            // m (P, G), l (P, G), acc (P, G, D); P = B H splits
  int H, S, D, splits;
  float qscale;         // scale * log2 e, or scale / softcap with a soft cap
  float capl2;          // softcap * log2 e, or 0
  int window;
};

// One (batch, KV head, split): the split's (m, l, acc) into the workspace.
template <typename T, int G, int KPL>
__global__ void __launch_bounds__(THREADS)
split_kernel(Args a) {
  constexpr int CE = 16 / (int)sizeof(T);        // elements per 16 bytes
  constexpr int TK = 32 * KPL, STAGES = stages(KPL);
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, RS = D + 16 / (int)sizeof(T); // padded row, elements
  const int NCH = D / CE, KG = THREADS / NCH;     // 16-byte pieces of a row
  T* ring = reinterpret_cast<T*>(smem);
  const int rb = ring_bytes<T, KPL>(D), red_b = KG * G * D * 4;
  float* qs = reinterpret_cast<float*>(smem + (rb > red_b ? rb : red_b));
  float* sp = qs + G * D;                          // [NW][G][TK]
  float* ps = sp + NW * G * TK;                    // [G][TK]
  float* alph = ps + G * TK;                       // [G]

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // a length above S ends the row at S; the window starts from the length
  // itself, as in the reference
  const int len_b = a.lengths[b], len = min(len_b, a.S);
  const int start = a.window > 0 ? max(len_b - a.window, 0) : 0;
  const int chunk = split_chunk(a.S, a.splits);
  const int lo = max(start, split * chunk), hi = min(len, (split + 1) * chunk);
  const ll pi = (ll)bh * a.splits + split;         // this partial's index
  const ll P = (ll)gridDim.x * a.splits;
  if (lo >= hi) {                                  // no valid key here
    if (t < G) { a.ws[pi * G + t] = NEG_INF; a.ws[(P + pi) * G + t] = 0.0f; }
    return;
  }

  const T* kb = (const T*)a.k + b * a.skb + h * a.skh;
  const T* vb = (const T*)a.v + b * a.svb + h * a.svh;
  const int nt = (hi - lo + TK - 1) / TK;
  auto issue = [&](int tile) {
    if (tile < nt) {
      T* ks = ring + (tile % STAGES) * 2 * TK * RS;
      T* vs = ks + TK * RS;
      const int k0 = lo + tile * TK;
      for (int i = t; i < TK * NCH; i += THREADS) {
        const int r = i / NCH, c = (i % NCH) * CE, j = k0 + r;
        const bool in = j < hi;
        cp_async16(smem_u32(ks + r * RS + c), kb + (in ? j * a.sks + c : 0), in);
        cp_async16(smem_u32(vs + r * RS + c), vb + (in ? j * a.svs + c : 0), in);
      }
    }
    cp_commit();                                   // empty groups keep the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // q, scaled, into shared memory: every load of a thread in flight at once
  const T* qb = (const T*)a.q + b * a.sqb + h * a.sqh;
  constexpr int QU = (G * DMAX + THREADS - 1) / THREADS;
  float qv[QU];
#pragma unroll
  for (int u = 0; u < QU; ++u) {
    const int i = t + u * THREADS;
    qv[u] = i < G * D ? widen(qb[(i / D) * a.sqg + (i % D) * a.sqd]) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < QU; ++u)
    if (t + u * THREADS < G * D) qs[t + u * THREADS] = qv[u] * a.qscale;

  // softmax state: warp w owns heads w, w + NW (m uniform, l per lane)
  constexpr int HPW = (G + NW - 1) / NW;
  float m[HPW], l[HPW];
#pragma unroll
  for (int i = 0; i < HPW; ++i) { m[i] = NEG_INF; l[i] = 0.0f; }
  // P V: thread t owns piece c of D for the keys kg, kg + KG, ...
  const int pc = t % NCH, kg = t / NCH;
  const bool pv = kg < KG;
  float acc[G][CE];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[g][e] = 0.0f;

  for (int tile = 0; tile < nt; ++tile) {
    issue(tile + STAGES - 1);
    cp_wait<STAGES - 1>();
    __syncthreads();                               // tile's K, V and q visible
    const T* ks = ring + (tile % STAGES) * 2 * TK * RS;
    const T* vs = ks + TK * RS;

    // scores: lane = key (KPL of them), warp = a share of D's 16-byte pieces
    float part[KPL][G];
#pragma unroll
    for (int x = 0; x < KPL; ++x)
#pragma unroll
      for (int g = 0; g < G; ++g) part[x][g] = 0.0f;
    for (int c = warp; c < NCH; c += NW) {
      float kv[KPL][CE];
#pragma unroll
      for (int x = 0; x < KPL; ++x) lds16(ks + (lane + 32 * x) * RS + c * CE, kv[x]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qp = qs + g * D + c * CE;
#pragma unroll
        for (int e = 0; e < CE; e += 4) {
          const float4 qq = *reinterpret_cast<const float4*>(qp + e);
#pragma unroll
          for (int x = 0; x < KPL; ++x)
            part[x][g] += qq.x * kv[x][e] + qq.y * kv[x][e + 1] + qq.z * kv[x][e + 2] +
                          qq.w * kv[x][e + 3];
        }
      }
    }
#pragma unroll
    for (int x = 0; x < KPL; ++x)
#pragma unroll
      for (int g = 0; g < G; ++g) sp[(warp * G + g) * TK + lane + 32 * x] = part[x][g];
    __syncthreads();

    // softmax: one max and one rescale per head and tile
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int g = warp + NW * i;
      if (g < G) {
        float sc[KPL], mx = NEG_INF;
#pragma unroll
        for (int x = 0; x < KPL; ++x) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < NW; ++w) s += sp[(w * G + g) * TK + lane + 32 * x];
          if (a.capl2 > 0.0f) s = a.capl2 * fast_tanh(s);
          sc[x] = lo + tile * TK + lane + 32 * x < hi ? s : NEG_INF;
          mx = fmaxf(mx, sc[x]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = fast_exp2(m[i] - m_new);
        float psum = 0.0f;
#pragma unroll
        for (int x = 0; x < KPL; ++x) {
          const bool valid = lo + tile * TK + lane + 32 * x < hi;
          const float p = valid ? fast_exp2(sc[x] - m_new) : 0.0f;
          ps[g * TK + lane + 32 * x] = p;
          psum += p;
        }
        l[i] = alpha * l[i] + psum;
        m[i] = m_new;
        if (lane == 0) alph[g] = alpha;
      }
    }
    __syncthreads();

    // P V for this thread's piece of D and its keys of the tile
    if (pv) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float al = alph[g];
#pragma unroll
        for (int e = 0; e < CE; ++e) acc[g][e] *= al;
      }
      for (int r = kg; r < TK; r += KG) {
        float vv[CE];
        lds16(vs + r * RS + pc * CE, vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = ps[g * TK + r];
#pragma unroll
          for (int e = 0; e < CE; ++e) acc[g][e] += p * vv[e];
        }
      }
    }
    __syncthreads();                               // the stage may be refilled
  }
  cp_wait<0>();
  __syncthreads();

  // the key groups' sums meet in shared memory (over the ring), in order
  float* red = reinterpret_cast<float*>(smem);     // [KG][G][D]
  if (pv)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < CE; ++e) red[(kg * G + g) * D + pc * CE + e] = acc[g][e];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int g = warp + NW * i;
    float ls = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (g < G && lane == 0) { a.ws[pi * G + g] = m[i]; a.ws[(P + pi) * G + g] = ls; }
  }
  __syncthreads();
  float* wacc = a.ws + 2 * P * G + pi * G * D;
  for (int i = t; i < G * D; i += THREADS) {
    float s = 0.0f;
    for (int x = 0; x < KG; ++x) s += red[x * G * D + i];
    wacc[i] = s;
  }
}

// The wide variant: one (batch, KV head, split), any G <= GMAX, GH heads
// at most per P V thread. Its (m, l, acc) go to the workspace as the narrow
// variant's do.
template <typename T>
__host__ __device__ constexpr int wide_stages() { return sizeof(T) == 2 ? 3 : 2; }
template <typename T>
__host__ __device__ constexpr int wide_smem_bytes(int D, int G) {
  return wide_stages<T>() * 2 * WTK * (D * (int)sizeof(T) + 16) + G * D * 4 +
         G * WTK * 4 + G * 4;
}
// heads a P V thread owns: ceil(G / (WTHREADS / pieces of D)), rounded up
// to a power of two (the template instances)
__host__ __device__ constexpr int wide_gh(int D, int G, int esz) {
  const int kg = WTHREADS / (D * esz / 16), need = (G + kg - 1) / kg;
  int gh = 1;
  while (gh < need) gh *= 2;
  return gh;
}

template <typename T, int GH>
__global__ void __launch_bounds__(WTHREADS)
split_wide_kernel(Args a, int G) {
  constexpr int CE = 16 / (int)sizeof(T);        // elements per 16 bytes
  constexpr int STAGES = wide_stages<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, RS = D + CE;                  // padded row, elements
  const int NCH = D / CE, KG = WTHREADS / NCH;     // pieces, P V head groups
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + STAGES * 2 * WTK * RS * sizeof(T));
  float* ps = qs + G * D;                          // [G][WTK]
  float* alph = ps + G * WTK;                      // [G]

  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int len_b = a.lengths[b], len = min(len_b, a.S);
  const int start = a.window > 0 ? max(len_b - a.window, 0) : 0;
  const int chunk = split_chunk(a.S, a.splits);
  const int lo = max(start, split * chunk), hi = min(len, (split + 1) * chunk);
  const ll pi = (ll)bh * a.splits + split;
  const ll P = (ll)gridDim.x * a.splits;
  if (lo >= hi) {                                  // no valid key here
    if (t < G) { a.ws[pi * G + t] = NEG_INF; a.ws[(P + pi) * G + t] = 0.0f; }
    return;
  }

  const T* kb = (const T*)a.k + b * a.skb + h * a.skh;
  const T* vb = (const T*)a.v + b * a.svb + h * a.svh;
  const int nt = (hi - lo + WTK - 1) / WTK;
  auto issue = [&](int tile) {
    if (tile < nt) {
      T* ks = ring + (tile % STAGES) * 2 * WTK * RS;
      T* vs = ks + WTK * RS;
      const int k0 = lo + tile * WTK;
      for (int i = t; i < WTK * NCH; i += WTHREADS) {
        const int r = i / NCH, c = (i % NCH) * CE, j = k0 + r;
        const bool in = j < hi;
        cp_async16(smem_u32(ks + r * RS + c), kb + (in ? j * a.sks + c : 0), in);
        cp_async16(smem_u32(vs + r * RS + c), vb + (in ? j * a.svs + c : 0), in);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // q, scaled, into shared memory: 16 bytes a load where q's rows allow
  const T* qb = (const T*)a.q + b * a.sqb + h * a.sqh;
  if (a.sqd == 1 && a.sqg * (ll)sizeof(T) % 16 == 0 && (uintptr_t)qb % 16 == 0) {
#pragma unroll 4
    for (int i = t; i < G * NCH; i += WTHREADS) {
      const int g = i / NCH, c = (i % NCH) * CE;
      float qv[CE];
      lds16(qb + g * a.sqg + c, qv);
#pragma unroll
      for (int e = 0; e < CE; ++e) qs[g * D + c + e] = qv[e] * a.qscale;
    }
  } else {
#pragma unroll 4
    for (int i = t; i < G * D; i += WTHREADS)
      qs[i] = widen(qb[(i / D) * a.sqg + (i % D) * a.sqd]) * a.qscale;
  }

  // softmax state of the heads warp w scores: w + WNW * i (m uniform, l
  // per lane)
  float m[WGW], l[WGW];
#pragma unroll
  for (int i = 0; i < WGW; ++i) { m[i] = NEG_INF; l[i] = 0.0f; }
  // P V: thread t owns piece pc of D for the heads hg, hg + KG, ...
  const int pc = t % NCH, hg = t / NCH;
  const bool pv = hg < KG;
  float acc[GH][CE];
#pragma unroll
  for (int j = 0; j < GH; ++j)
#pragma unroll
    for (int e = 0; e < CE; ++e) acc[j][e] = 0.0f;

  for (int tile = 0; tile < nt; ++tile) {
    issue(tile + STAGES - 1);
    cp_wait<STAGES - 1>();
    __syncthreads();                               // tile's K, V and q visible
    const T* ks = ring + (tile % STAGES) * 2 * WTK * RS;
    const T* vs = ks + WTK * RS;

    // scores: lane = key, the warp's heads over the whole row
    float part[WGW];
#pragma unroll
    for (int i = 0; i < WGW; ++i) part[i] = 0.0f;
    const T* krow = ks + lane * RS;
#pragma unroll 4
    for (int c = 0; c < NCH; ++c) {
      float kv[CE];
      lds16(krow + c * CE, kv);
#pragma unroll
      for (int i = 0; i < WGW; ++i) {
        const int g = warp + WNW * i;
        if (g < G) {
          const float* qp = qs + g * D + c * CE;
#pragma unroll
          for (int e = 0; e < CE; e += 4) {
            const float4 qq = *reinterpret_cast<const float4*>(qp + e);
            part[i] += qq.x * kv[e] + qq.y * kv[e + 1] + qq.z * kv[e + 2] +
                       qq.w * kv[e + 3];
          }
        }
      }
    }
    // softmax: one max and one rescale per head and tile
    const bool valid = lo + tile * WTK + lane < hi;
#pragma unroll
    for (int i = 0; i < WGW; ++i) {
      const int g = warp + WNW * i;
      if (g < G) {
        float sc = part[i];
        if (a.capl2 > 0.0f) sc = a.capl2 * fast_tanh(sc);
        sc = valid ? sc : NEG_INF;
        float mx = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = fast_exp2(m[i] - m_new);
        const float p = valid ? fast_exp2(sc - m_new) : 0.0f;
        ps[g * WTK + lane] = p;
        l[i] = alpha * l[i] + p;
        m[i] = m_new;
        if (lane == 0) alph[g] = alpha;
      }
    }
    __syncthreads();

    // P V for this thread's piece of D and its heads, over the tile's keys
    if (pv) {
#pragma unroll
      for (int j = 0; j < GH; ++j) {
        const int g = hg + KG * j;
        const float al = g < G ? alph[g] : 1.0f;
#pragma unroll
        for (int e = 0; e < CE; ++e) acc[j][e] *= al;
      }
#pragma unroll 4
      for (int r = 0; r < WTK; ++r) {
        float vv[CE];
        lds16(vs + r * RS + pc * CE, vv);
#pragma unroll
        for (int j = 0; j < GH; ++j) {
          const int g = hg + KG * j;
          if (g < G) {
            const float p = ps[g * WTK + r];
#pragma unroll
            for (int e = 0; e < CE; ++e) acc[j][e] += p * vv[e];
          }
        }
      }
    }
    __syncthreads();                               // the stage may be refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < WGW; ++i) {
    const int g = warp + WNW * i;
    float ls = l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (g < G && lane == 0) { a.ws[pi * G + g] = m[i]; a.ws[(P + pi) * G + g] = ls; }
  }
  // each thread's CE floats of a head, a warp's stores contiguous: in
  // 16-byte stores where the accumulators start on 16 bytes (P * G even;
  // D * 4 bytes and a piece's offset are multiples of 16)
  float* wacc = a.ws + 2 * P * G + pi * G * D;
  const bool vec = ((uintptr_t)wacc & 15) == 0;
  if (pv)
#pragma unroll
    for (int j = 0; j < GH; ++j) {
      const int g = hg + KG * j;
      if (g < G) {
        float* w = wacc + g * D + pc * CE;
        if (vec) {
#pragma unroll
          for (int e = 0; e < CE; e += 4)
            *reinterpret_cast<float4*>(w + e) =
                make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < CE; ++e) w[e] = acc[j][e];
        }
      }
    }
}

// The splits of one (batch, KV head, query head), combined in split order:
// a block per head, so that MLA's 40 heads on one KV head spread over 40
// blocks (a block per KV head left 4 blocks to merge 1.5 MB each). First
// warp 0 finds the largest m and the sum of the rescaled l (lanes over
// splits, then a shuffle tree: a fixed order), and keeps each split's
// weight exp2(m_s - m) in shared memory, 0 for a split with l = 0 (it held
// no valid key, and its acc was never written); then each of the head's D
// outputs sums its splits with their loads in flight.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ ws, T* __restrict__ out,
             float* __restrict__ lse, int G, int D, int splits) {
  __shared__ float wgt[MAX_SPLITS], lsum;
  const int bh = blockIdx.x, g = blockIdx.y, t = threadIdx.x;
  const ll P = (ll)gridDim.x * splits;
  const float* wm = ws + (ll)bh * splits * G;
  const float* wl = ws + (P + (ll)bh * splits) * G;
  const float* wa = ws + 2 * P * G + (ll)bh * splits * G * D + (ll)g * D;
  if (t < 32) {
    float mx = NEG_INF;
    for (int s = t; s < splits; s += 32) mx = fmaxf(mx, __ldg(&wm[s * G + g]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ls = 0.0f;
    for (int s = t; s < splits; s += 32) {
      const float l = __ldg(&wl[s * G + g]);
      const float c = l > 0.0f ? fast_exp2(__ldg(&wm[s * G + g]) - mx) : 0.0f;
      wgt[s] = c;
      ls += c * l;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
    if (t == 0) {
      lsum = ls;
      if (lse != nullptr)
        lse[(ll)bh * G + g] = ls > 0.0f ? (mx + log2f(ls)) * LN2
                                        : __int_as_float((int)0xff800000u);
    }
  }
  __syncthreads();
  for (int i = t; i < D; i += MERGE_THREADS) {
    float o = 0.0f;
#pragma unroll 16
    for (int s = 0; s < splits; ++s) {
      const float c = wgt[s];
      o += c * (c > 0.0f ? __ldg(&wa[(ll)s * G * D + i]) : 0.0f);
    }
    put(out + ((ll)bh * G + g) * D + i, o / fmaxf(lsum, 1e-30f));
  }
}

// Raises the dynamic shared memory limit of an instantiation once per device.
template <typename T, int G, int KPL>
int launch_k(const Args& a, int BH, cudaStream_t s) {
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    // the most the instantiation takes: D up to DMAX, or 256 bytes a row
    constexpr int dmax = KPL == 1 ? DMAX : 256 / (int)sizeof(T);
    err = cudaFuncSetAttribute(split_kernel<T, G, KPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<T, KPL>(dmax, G));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  split_kernel<T, G, KPL><<<dim3(BH, a.splits), THREADS, smem_bytes<T, KPL>(a.D, G), s>>>(a);
  return 0;
}

template <typename T, int G>
int launch_g(const Args& a, int BH, cudaStream_t s) {
  return a.D * (int)sizeof(T) <= 256 ? launch_k<T, G, 2>(a, BH, s)
                                     : launch_k<T, G, 1>(a, BH, s);
}

template <typename T, int GH>
int launch_w(const Args& a, int BH, int G, cudaStream_t s) {
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(split_wide_kernel<T, GH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               wide_smem_bytes<T>(WDMAX, GMAX));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  split_wide_kernel<T, GH><<<dim3(BH, a.splits), WTHREADS,
                             wide_smem_bytes<T>(a.D, G), s>>>(a, G);
  return 0;
}

template <typename T>
int launch_wide(const Args& a, int BH, int G, cudaStream_t s) {
  switch (wide_gh(a.D, G, (int)sizeof(T))) {
    case 1: return launch_w<T, 1>(a, BH, G, s);
    case 2: return launch_w<T, 2>(a, BH, G, s);
    case 4: return launch_w<T, 4>(a, BH, G, s);
    case 8: return launch_w<T, 8>(a, BH, G, s);
    case 16:
      if constexpr (sizeof(T) == 4) return launch_w<T, 16>(a, BH, G, s);
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_narrow(const Args& a, int BH, int G, cudaStream_t s) {
  switch (G) {
    case 1: return launch_g<T, 1>(a, BH, s);
    case 2: return launch_g<T, 2>(a, BH, s);
    case 3: return launch_g<T, 3>(a, BH, s);
    case 4: return launch_g<T, 4>(a, BH, s);
    case 5: return launch_g<T, 5>(a, BH, s);
    case 6: return launch_g<T, 6>(a, BH, s);
    case 7: return launch_g<T, 7>(a, BH, s);
    case 8: return launch_g<T, 8>(a, BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const Args& a, void* out, float* lse, int BH, int G, bool wide,
           cudaStream_t s) {
  int err = wide ? launch_wide<T>(a, BH, G, s) : launch_narrow<T>(a, BH, G, s);
  if (err) return err;
  if (lse != nullptr)
    merge_kernel<float><<<dim3(BH, G), MERGE_THREADS, 0, s>>>(
        a.ws, (float*)out, lse, G, a.D, a.splits);
  else
    merge_kernel<T><<<dim3(BH, G), MERGE_THREADS, 0, s>>>(
        a.ws, (T*)out, nullptr, G, a.D, a.splits);
  return 0;
}

}  // namespace

// dtype_code 0 f32, 1 bf16. k and v have unit D stride and 16-byte-aligned
// rows (base and every stride a multiple of 16 bytes); q takes any strides.
// 1 <= G <= 40 and D up to 288 with rows of a multiple of 16 bytes; the
// narrow variant (variant 0) only G <= 8 and D <= 256, the wide one
// (variant 1) all of them. softcap <= 0 means none, window <= 0 means none.
// out is (B, H, G, D) contiguous; ws holds B * H * splits * G * (D + 2)
// floats; lse, where not null, is (B, H, G) f32 contiguous, and out f32. splits must leave no split without a key of [0, S), and be at
// most 256 (decode_splits in kernel.py); another value is refused.
extern "C" int decode_attention_launch(
    const void* q, ll sqb, ll sqh, ll sqg, ll sqd, const void* k, ll skb,
    ll skh, ll sks, const void* v, ll svb, ll svh, ll svs, const int* lengths,
    void* out, float* ws, float* lse, int B, int H, int G, int S, int D, int splits,
    int dtype_code, int variant, float scale, float softcap, int window,
    void* stream) {
  const int esz = dtype_code == 0 ? 4 : 2;
  if ((dtype_code != 0 && dtype_code != 1) || D > WDMAX || D <= 0 ||
      D * esz % 16 != 0 || G < 1 || G > GMAX)
    return (int)cudaErrorInvalidValue;
  if (variant != 1 && (variant != 0 || G > GNARROW || D > DMAX))
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS ||
      (ll)(splits - 1) * split_chunk(S, splits) >= (S > 1 ? S : 1))
    return (int)cudaErrorInvalidValue;
  if (B * H == 0) return (int)cudaGetLastError();
  const bool cap = softcap > 0.0f;
  const Args a{q, sqb, sqh, sqg, sqd, k, skb, skh, sks, v, svb, svh, svs,
               lengths, ws, H, S, D, splits,
               cap ? scale / softcap : scale * LOG2E, cap ? softcap * LOG2E : 0.0f,
               window};
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = variant == 1;
  const int err = dtype_code == 0 ? launch<float>(a, out, lse, B * H, G, wide, s)
                                  : launch<bf16>(a, out, lse, B * H, G, wide, s);
  if (err) return err;
  return (int)cudaGetLastError();
}
