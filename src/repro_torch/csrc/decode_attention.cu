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
// core design; for MLA in bf16 the `mla` variant below takes its place.
// The `mla` variant (split_mla_kernel, entry mla_decode_launch) is MLA's
// absorbed decode read from the latent cache itself: q (B, G, r + rope)
// against c (B, S, r) and kr (B, S, rope), V the first r columns of the
// same key rows, the output (B, G, r). It replaces the route the model
// took before (a cat of c and kr and a zero-padded copy of c, both over the
// whole capacity every layer, then `wide`, which read the latent bytes
// twice and ran 40 x 288 score and 40 x 288 P V products a key on the CUDA
// cores: its time was per-tile work, not bytes). What bounds it: the bytes
// of the valid latent rows, read once (at 4 x 32768 rows, 75.5 MB); the
// products, 64 x (288 + 2 x 256) a key, are far below the tensor cores'
// rate.
// The design: bf16 only, on wgmma (bf16 products, f32 sums), as FlashMLA
// does. A block takes one (batch, split) with its G <= 40 heads as the 64
// rows of wgmma's m64 tile (rows past G zero). Each 64-key tile arrives
// once in shared memory by TMA from its two sources (r columns of c, rope
// of kr), in a ring of four stages, laid out in 64-column blocks with the
// 128-byte swizzle, which wgmma reads straight from shared memory twice:
// K-major for the scores (S = Q K^T over all r + rope columns, Q staged
// once per block the same way) and, its first r columns, MN-major through
// the descriptor's transpose bit as V for O += P V. No V tensor exists and
// nothing is read twice from device memory. Two warpgroups take the two
// 32-key halves of every tile, each with its own online softmax and O,
// met once at the split's end, so that one's softmax runs while the
// other's products do. Softmax runs on the scores' registers in f32, in
// log2 units (one multiply by scale * log2 e: q is not rounded again), exp2
// on the SFU, one max and one rescale per row and tile; P stays in
// registers as the A operand of P V, in two bf16 parts (its rounding and
// what that drops), so the products carry P to about 2^-17 and the output
// rounds as the plain version's does. An mma.sync m16n8k16 form (two warps
// an m16 tile, fragments by ldmatrix, cp.async) and one warpgroup on wgmma
// fed by cp.async were slower at long caches: the loads and the products
// took turns. The split plan
// (mla_splits in kernel.py) gives a split at least 4 tiles where S allows
// and about one block an SM (one fits: 201 KB of shared memory), so the
// f32 partials are G x r per split, and the merge below combines them with
// D = r.
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
#include <cuda.h>            // CUtensorMap and its enums (types only)
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

// ------------------------------------------- the mla variant (tensor cores)
constexpr int MTK = 64;            // keys a tile: 32 for each consumer warpgroup
constexpr int MROWS = 64;          // query heads a block, padded: one wgmma's M
constexpr int MBLK = MTK * 128;    // 64 columns of 64 rows, 128-byte rows: 8 KB
constexpr int MDMAX = 288;         // r + rope at most
constexpr int MKS = MDMAX / 16;    // 16-wide steps of the scores' depth at most
constexpr int MRMAX = 256;         // r at most
constexpr int MSTAGES = 4;         // tiles of the ring
constexpr int MCONS = 2;           // consumer warpgroups: the two halves of a tile
constexpr int MTHREADS = MCONS * 128;

__host__ __device__ constexpr int mla_chunk(int S, int splits) {
  return ((S + splits - 1) / splits + MTK - 1) / MTK * MTK;
}
// 64-column blocks of a row: r / 64 of c, then rope's (zero past rope)
__host__ __device__ constexpr int mla_blocks(int R, int ROPE) { return R / 64 + (ROPE + 63) / 64; }
// the ring and Q, the barriers, and 1 KB to align the swizzle atoms
__host__ __device__ constexpr int mla_smem_bytes(int nb) {
  return (MSTAGES + 1) * nb * MBLK + (2 * MSTAGES + 1) * 8 + 1024;
}
// The operands the kernel takes (the wrapper's mla_takes checks the same):
// bf16, 1 <= G <= 40, r a multiple of 64 up to 256, rope a multiple of 16,
// at least 16, r + rope <= 288; unit column strides, every other stride a
// multiple of 16 bytes and 16-byte aligned bases.
__host__ __device__ constexpr bool mla_ok(int dtype_code, int G, int R, int ROPE) {
  return dtype_code == 1 && G >= 1 && G <= GMAX && R % 64 == 0 && R >= 64 &&
         R <= MRMAX && ROPE % 16 == 0 && ROPE >= 16 && R + ROPE <= MDMAX;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// the two halves of a packed pair, as f32 (a bf16 is the top of an f32)
__device__ __forceinline__ float lo_of(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_of(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// Until the phase of the given parity has completed. A wait of about a
// second (2^26 tries, each suspending the thread for up to a time-limit the
// hardware sets) traps: a copy that never lands ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, tries = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++tries == (1u << 26)) asm volatile("trap;\n");
  } while (!done);
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (as gemm.cu's).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across a wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// the 128 threads of consumer warpgroup h (named barrier 1 + h)
__device__ __forceinline__ void group_sync(int h) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + h) : "memory");
}

#define MLA_D16 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
  "+f"(d[14]), "+f"(d[15])
#define MLA_D32 MLA_D16, \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), \
  "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31])
#define MLA_L16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define MLA_L32 MLA_L16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"

// d (64x32 f32, the warpgroup's) += A (64x16, K-major, shared memory) *
// B (16x32, K-major, shared memory)
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" MLA_L16 "}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : MLA_D16 : "l"(da), "l"(db), "r"(1));
}
// d (64x64 f32) += A (64x16 bf16 in registers, mma.m16n8k16's A fragment
// for each warp's 16 rows) * B (16x64, MN-major, through the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MLA_L32 "}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : MLA_D32 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef MLA_D16
#undef MLA_D32
#undef MLA_L16
#undef MLA_L32

struct MlaArgs {
  const int* lengths;
  float* ws;                           // m (P, G), l (P, G), acc (P, G, r); P = B splits
  int G, S, R, ROPE, splits;
  float qscale;                        // scale * log2 e
};

// One (batch, split) of MLA's absorbed decode: its (m, l, acc) into the
// workspace, acc over the r columns. One thread brings q once and each
// 64-key tile into a ring of four stages by TMA (three-dimensional maps of
// q, c and kr: boxes of 64 columns and 64 rows, zero past the tensors'
// edges, 128-byte swizzle), each stage's arrival and release counted on
// mbarriers; it refills a stage once both consumer warpgroups have
// released it (a producer warp of its own would cut every thread's
// registers from 255 to 168: they are given out by whole warpgroups, so
// 288 threads cost what 384 do). Shared memory holds a tile (and q, 64
// rows, those past G zero) as 64-column blocks of 64 rows of 128 bytes,
// the layout wgmma's descriptors read: the scores read the tile K-major (k16 steps
// 32 bytes into a block), P V reads its first r / 64 blocks as V, MN-major
// through the transpose bit (k16 steps 16 rows, 2 KB, down a block).
// Consumer warpgroup h takes keys [32 h, 32 h + 32) of every tile with its
// own online softmax, P and O; the two meet in shared memory once, at the
// end of the split. Accumulators: warp w of a group holds rows 16 w + g and
// 16 w + g + 8 (lane = 4 g + t4), columns 8 j + 2 t4 and 8 j + 2 t4 + 1 of
// each 8-column tile j in d[4 j ..]. P is the scores' registers packed to
// bf16: the A fragments of the P V products, no trip through shared
// memory. A tile's rows past the split's last valid key are zeroed in V
// (TMA brings whatever the cache holds there) before P V reads them.
__global__ void __launch_bounds__(MTHREADS, 1)
split_mla_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tc,
                 const __grid_constant__ CUtensorMap tk, MlaArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;   // swizzle atoms
  const int R = a.R, nbr = R / 64, nbk = (a.ROPE + 63) / 64, nb = nbr + nbk;
  const int nks = (R + a.ROPE) / 16;
  const uint32_t stage_bytes = nb * MBLK;
  const uint32_t qbase = base + MSTAGES * stage_bytes;
  const uint32_t bars = qbase + nb * MBLK;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MSTAGES + s); };
  const uint32_t qfull = bars + 8 * 2 * MSTAGES;

  const int b = blockIdx.x, split = blockIdx.y;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  // a length above S ends the row at S; at most 0 leaves it empty
  const int len = min(a.lengths[b], a.S);
  const int chunk = mla_chunk(a.S, a.splits);
  const int lo = split * chunk, hi = min(len, lo + chunk);
  const ll pi = (ll)b * a.splits + split;          // this partial's index
  const ll P = (ll)gridDim.x * a.splits;
  if (lo >= hi) {                                  // no valid key here
    for (int i = t; i < a.G; i += MTHREADS) {
      a.ws[pi * a.G + i] = NEG_INF;
      a.ws[(P + pi) * a.G + i] = 0.0f;
    }
    return;
  }
  const int nt = (hi - lo + MTK - 1) / MTK;
  if (t == 0) {
    for (int s = 0; s < MSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), MCONS * 4);              // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load = [&](int tile) {                      // the tile into its stage
    const int s = tile % MSTAGES;
    const uint32_t st = base + s * stage_bytes;
    const int k0 = lo + tile * MTK;
    mbar_expect_tx(full(s), stage_bytes);
    for (int i = 0; i < nbr; ++i) tma_load_3d(st + i * MBLK, &tc, full(s), 64 * i, k0, b);
    for (int i = 0; i < nbk; ++i)
      tma_load_3d(st + (nbr + i) * MBLK, &tk, full(s), 64 * i, k0, b);
  };
  if (t == 0) {
    mbar_expect_tx(qfull, nb * MBLK);
    for (int i = 0; i < nb; ++i) tma_load_3d(qbase + i * MBLK, &tq, qfull, 64 * i, 0, b);
    for (int tile = 0; tile < min(nt, MSTAGES); ++tile) load(tile);
  }
  __syncwarp();

  const int h = warp / 4, wq = warp % 4;           // consumer group (key half), its warp
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = wq * 16 + g;                    // and row0 + 8
  float o[MRMAX / 64][32];                         // the r columns, 64 a block
#pragma unroll
  for (int n = 0; n < MRMAX / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.0f, 0.0f};
  mbar_wait(qfull, 0);

  for (int tile = 0; tile < nt; ++tile) {
    const int s = tile % MSTAGES;
    mbar_wait(full(s), (tile / MSTAGES) & 1);
    const uint32_t st = base + s * stage_bytes;
    const int k0 = lo + tile * MTK + 32 * h;       // this group's first key
    if (hi - k0 < 32) {
      // rows of this half past the last valid key: zero in V
      const int first = max(hi - k0, 0);
      for (int i = t % 128; i < (32 - first) * nbr * 8; i += 128) {
        const int r = 32 * h + first + i / (nbr * 8), c = i % (nbr * 8);
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n"
                     :: "r"(st + (c >> 3) * MBLK + r * 128 + (((c & 7) ^ (r & 7)) << 4)),
                        "r"(0) : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      group_sync(h);
    }

    // S = Q K^T over all r + rope columns, this group's 32 keys
    float sc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) sc[e] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < MKS; ++kk)
      if (kk < nks) {
        const uint32_t off = (kk >> 2) * MBLK + (kk & 3) * 32;
        wgmma_ss(sc, desc_sw128(qbase + off, 16, 1024),
                 desc_sw128(st + h * 4096 + off, 16, 1024));
      }
    wgmma_commit();
    wgmma_wait0();
    fence_acc(sc);

    // log2 units, keys past hi masked (p = 0); one max and one rescale a row
    const int kb = k0 + 2 * t4;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = kb + 8 * j + (e & 1) < hi ? sc[4 * j + e] * a.qscale : NEG_INF;
        sc[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_r[i], mx[i]);
      alpha[i] = fast_exp2(m_r[i] - m_new);      // 1 while the half has seen no key
      m_r[i] = m_new;
    }
    // P, packed to bf16 pairs: ph[kk] the A fragment of this group's keys
    // 16 kk .. 16 kk + 15, pl[kk] what bf16 dropped
    uint32_t ph[2][4], pl[2][4];
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = kb + 8 * j + (e & 1) < hi ? fast_exp2(sc[4 * j + e] - m_r[e >> 1]) : 0.0f;
      ls[0] += p[0] + p[1];
      ls[1] += p[2] + p[3];
      const uint32_t h01 = pack_bf16(p[0], p[1]), h23 = pack_bf16(p[2], p[3]);
      ph[j >> 1][(j & 1) * 2] = h01;
      ph[j >> 1][(j & 1) * 2 + 1] = h23;
      pl[j >> 1][(j & 1) * 2] = pack_bf16(p[0] - lo_of(h01), p[1] - hi_of(h01));
      pl[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2] - lo_of(h23), p[3] - hi_of(h23));
    }
    l_r[0] = alpha[0] * l_r[0] + ls[0];            // this thread's keys; met at the end
    l_r[1] = alpha[1] * l_r[1] + ls[1];
#pragma unroll
    for (int n = 0; n < MRMAX / 64; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[n][4 * j] *= alpha[0];
        o[n][4 * j + 1] *= alpha[0];
        o[n][4 * j + 2] *= alpha[1];
        o[n][4 * j + 3] *= alpha[1];
      }

    // O += P V: V the first r columns of this group's 32 rows of the tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int n = 0; n < MRMAX / 64; ++n)
        if (n < nbr) {
          const uint64_t dv = desc_sw128(st + n * MBLK + (2 * h + kk) * 2048, MBLK, 1024);
          wgmma_rs(o[n], ph[kk], dv);      // P's bf16 rounding, then what it dropped:
          wgmma_rs(o[n], pl[kk], dv);      // P carried to about 2^-17, not 2^-9
        }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int n = 0; n < MRMAX / 64; ++n) fence_acc(o[n]);
    if (lane == 0) mbar_arrive(empty(s));          // this warp is done with the stage
    if (t == 0 && tile + MSTAGES < nt) {           // both groups done: refill it
      mbar_wait(empty(s), (tile / MSTAGES) & 1);
      load(tile + MSTAGES);
    }
    __syncwarp();                      // the warp converged again for wgmma
  }

  // l over the quad, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  // the second half's (m, l, O) to the first through shared memory (the
  // ring: every tile has been read), then the first writes the split's
  float* xo = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  float* xm = xo + MROWS * MRMAX;                  // [MROWS] m, then [MROWS] l
  __syncthreads();                                 // every wgmma of the ring done
  if (h == 1) {
#pragma unroll
    for (int n = 0; n < MRMAX / 64; ++n)
      if (n < nbr)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
            *reinterpret_cast<float2*>(xo + (row0 + 8 * i) * MRMAX + 64 * n + 8 * j + 2 * t4) =
                make_float2(o[n][4 * j + 2 * i], o[n][4 * j + 2 * i + 1]);
    if (t4 == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xm[row0 + 8 * i] = m_r[i];
        xm[MROWS + row0 + 8 * i] = l_r[i];
      }
  }
  __syncthreads();
  if (h == 1) return;
  float c0[2], c1[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = xm[row0 + 8 * i], m = fmaxf(m_r[i], m1);
    c0[i] = fast_exp2(m_r[i] - m);
    c1[i] = fast_exp2(m1 - m);
    const int row = row0 + 8 * i;
    if (t4 == 0 && row < a.G) {
      a.ws[pi * a.G + row] = m;
      a.ws[(P + pi) * a.G + row] = c0[i] * l_r[i] + c1[i] * xm[MROWS + row];
    }
  }
  // the r columns of rows row0, row0 + 8 (float2 stores: every offset even)
  float* wacc = a.ws + 2 * P * a.G + pi * a.G * R;
#pragma unroll
  for (int n = 0; n < MRMAX / 64; ++n)
    if (n < nbr)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 8 * i, col = 64 * n + 8 * j + 2 * t4;
          const float2 x = *reinterpret_cast<const float2*>(xo + row * MRMAX + col);
          if (row < a.G)
            *reinterpret_cast<float2*>(wacc + row * R + col) =
                make_float2(c0[i] * o[n][4 * j + 2 * i] + c1[i] * x.x,
                            c0[i] * o[n][4 * j + 2 * i + 1] + c1[i] * x.y);
        }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), fetched through the
// runtime so the library needs no -lcuda (as gemm.cu does).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 tensor map of x (n2, n1, n0) with strides (s2, s1, 1)
// elements: boxes of 64 x 64 x 1, 128-byte swizzle, zero past the edges. A
// stride of a dimension of size 1 is never stepped: any multiple of 16
// bytes stands in for it.
bool make_map3(CUtensorMap* map, const void* x, ll n0, ll n1, ll n2, ll s1, ll s2) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n0, (cuuint64_t)n1, (cuuint64_t)n2};
  const cuuint64_t strides[2] = {(cuuint64_t)(n1 == 1 ? 16 : 2 * s1),
                                 (cuuint64_t)(n2 == 1 ? 16 : 2 * s2)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_mla(const CUtensorMap& tq, const CUtensorMap& tc, const CUtensorMap& tk,
               const MlaArgs& a, int B, cudaStream_t s) {
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(split_mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               mla_smem_bytes(mla_blocks(MRMAX, MDMAX - MRMAX)));
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  split_mla_kernel<<<dim3(B, a.splits), MTHREADS,
                     mla_smem_bytes(mla_blocks(a.R, a.ROPE)), s>>>(tq, tc, tk, a);
  return 0;
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

// MLA's absorbed decode on the `mla` variant: q (B, G, r + rope), c (B, S, r),
// kr (B, S, rope), each with a unit column stride, every other stride a
// multiple of 16 bytes and a 16-byte-aligned base; bf16 (dtype_code 1) and
// the shapes of mla_ok, else refused. out is (B, G, r) contiguous (f32 with
// lse); ws holds B * splits * G * (r + 2) floats; lse, where not null, is
// (B, G) f32. splits must leave no split of mla_chunk keys without a key of
// [0, S), and be at most 256 (mla_splits in kernel.py).
extern "C" int mla_decode_launch(
    const void* q, ll sqb, ll sqh, const void* c, ll scb, ll scs, const void* kr,
    ll skb, ll sks, const int* lengths, void* out, float* ws, float* lse, int B,
    int G, int S, int R, int ROPE, int splits, int dtype_code, float scale,
    void* stream) {
  if (!mla_ok(dtype_code, G, R, ROPE))
    return (int)cudaErrorInvalidValue;
  // every stride a multiple of 16 bytes, and above 0 where its dimension is
  // stepped (size-1 dimensions pass 0)
  const ll strides[6] = {sqb, sqh, scb, scs, skb, sks};
  const int sizes[6] = {B, G, B, S, B, S};
  for (int i = 0; i < 6; ++i)
    if (strides[i] % 8 != 0 || (sizes[i] > 1 && strides[i] <= 0))
      return (int)cudaErrorInvalidValue;
  if ((uintptr_t)q % 16 || (uintptr_t)c % 16 || (uintptr_t)kr % 16)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > MAX_SPLITS ||
      (ll)(splits - 1) * mla_chunk(S, splits) >= (S > 1 ? S : 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  CUtensorMap tq, tc, tk;
  if (!make_map3(&tq, q, R + ROPE, G, B, sqh, sqb) || !make_map3(&tc, c, R, S, B, scs, scb) ||
      !make_map3(&tk, kr, ROPE, S, B, sks, skb))
    return (int)cudaErrorInvalidValue;
  const MlaArgs a{lengths, ws, G, S, R, ROPE, splits, scale * LOG2E};
  cudaStream_t s = (cudaStream_t)stream;
  const int err = launch_mla(tq, tc, tk, a, B, s);
  if (err) return err;
  if (lse != nullptr)
    merge_kernel<float><<<dim3(B, G), MERGE_THREADS, 0, s>>>(ws, (float*)out, lse, G, R,
                                                            splits);
  else
    merge_kernel<bf16><<<dim3(B, G), MERGE_THREADS, 0, s>>>(ws, (bf16*)out, nullptr, G, R,
                                                           splits);
  return (int)cudaGetLastError();
}
