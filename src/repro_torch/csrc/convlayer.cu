// xmk4 fused conv layer for Hopper: conv(valid) -> maxpool 2x2/2 ->
// LeakyReLU -> cast, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/convlayer/kernel.py:
// conv_layer_pallas (body _convlayer_kernel). Same contract: x (C, H, W),
// f (F, C, KH, KW) -> out (F, (H-KH+1)/2, (W-KW+1)/2), in int8, int16,
// int32, f32 or bf16, the output of the input's kind. Integer sums wrap as
// the reference's int32 does (uint32 on CUDA cores, s32 without .satfinite
// on tensor cores); float sums are f32. The 2x2 max propagates NaN.
// LeakyReLU rounds slope * f32(v) half to even for integers; the cast to the
// output type wraps for integers and rounds to nearest even for bf16.
//
// What bounds it on this card, and what the design does about it. At the
// paper's sizes (3 x 256 x 256, one filter) the layer reads about 200 KB and
// does a few million MACs, far under a microsecond of either: latency sets
// its time, first that of the input tile's loads from device memory. With
// 64 filters (a first CNN layer) it is 87 M MACs. Two variants, picked by
// the caller (kernels/convlayer/kernel.py: conv_variant) and checked again
// here:
//  * mma (bf16 and int8): implicit GEMM on mma.sync tensor cores, M = the
//    block's conv outputs, N = its filters, K = C*KH*KW zero-padded to the
//    k-step (m16n8k16 bf16 -> f32, m16n8k32 s8 -> s32). A block of 4 warps
//    takes 2 x 16 pooled outputs (M = 128) for up to 64 filters (N), so a
//    3 x 226 x 226 layer is 392 blocks. Per block, once: the input tile is
//    copied by cp.async (16 bytes where the rows allow, else 8 or 4, else
//    through registers), the filters become B in shared memory (rows padded
//    by 16 bytes: conflict-free fragment loads), and a table maps each k to
//    its (c, di, dj) offset in the tile, so A fragments are gathered from
//    the tile without an im2col copy; padded k read a zero block. A warp
//    holds 8 pooled outputs in two m-tiles: top-left and top-right conv
//    outputs in rows g and g+8 of the first, bottom-left and bottom-right in
//    the same rows of the second, so the four under one pooled output sit in
//    one thread's accumulators and the 2x2 max is four registers. Results
//    go through shared memory, so each filter's outputs leave as runs of 16
//    along OW.
//  * simt (every type; int16, int32 and f32 always: the port's f32 is true
//    f32, never TF32): CUDA cores. A block of 256 threads takes 8 x 16
//    pooled outputs for up to 16 filters; two threads a pooled output, each
//    computing one conv row of it (two outputs), the 2x2 max taken across
//    the pair by a shuffle. The filters lie tap by tap with the filters
//    innermost, so one pair of 16-byte loads brings a tap's weights for the
//    thread's 8 filters, and each input value read from shared memory
//    serves them all: 4 shared loads per 16 MACs. With fewer than 4
//    filters a thread takes one at a time, 4 or 8 taps of a row at once:
//    5 (9) input values serve 4 (8) taps of both outputs. The float order
//    is the reference's (per tap, the channels summed first, then the taps
//    in order).
// Both stage what is not copied by cp.async, the input rows and the filter
// rows together, in batches of loads (rows to warps, columns to lanes, no
// division per element): each thread issues a batch's loads before its
// first store to shared memory, so a batch pays the device memory's
// latency once instead of once per element (simt: one batch for up to
// 3 channels of a 7x7 filter). The TPU kernel's overlapping pl.Element
// bands and padded rows have no counterpart: a block computes its own
// offsets and masks its own ragged edge. Every launch returns
// cudaGetLastError() to the caller.
#include "elem.cuh"

namespace {

constexpr int MAX_SMEM = 227 * 1024;
enum Variant { MMA = 0, SIMT = 1 };

template <typename T>
using Acc = typename std::conditional<elem::is_int<T>, uint32_t, float>::type;

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }

// The stored type S of a loaded T: the accumulator type (sign-extended,
// then mod 2^32, for integers), or T itself.
template <typename S, typename T>
__device__ __forceinline__ S widen(T v) {
  if constexpr (std::is_same<S, T>::value) return v;
  else if constexpr (elem::is_int<T>) return (S)(int32_t)v;
  else return elem::to_f32(v);
}

template <typename A>
__device__ __forceinline__ bool takes(A v, A m) {
  if constexpr (std::is_same<A, uint32_t>::value) return (int32_t)v > (int32_t)m;
  else return v != v || v > m;
}

// A float max m of values whose sign bits ANDed are `signs`, with +0 over
// -0 as jnp's max picks: where m is zero every value is <= 0, so m is -0
// only if every value's sign bit is set. One fix per pooled value, not a
// third test in every compare (which cost the short float kernels up to
// 12%). The mma variant's sums come from the tensor cores, whose zero
// signs IEEE does not fix, so its pool (pool4) takes the fix.
template <typename A>
__device__ __forceinline__ A zero_sign(A m, uint32_t signs) {
  if constexpr (std::is_same<A, uint32_t>::value) return m;
  else return m == 0.0f ? __uint_as_float(signs & 0x80000000u) : m;
}
template <typename A>
__device__ __forceinline__ uint32_t sign_bits(A v) {
  if constexpr (std::is_same<A, uint32_t>::value) return 0u;
  else return __float_as_uint(v);
}

// The 2x2 max in the reference's order (NaN propagates; +0 over -0).
template <typename A>
__device__ __forceinline__ A pool4(A a00, A a01, A a10, A a11) {
  A m = a00;
  if (takes(a01, m)) m = a01;
  if (takes(a10, m)) m = a10;
  if (takes(a11, m)) m = a11;
  return zero_sign(m, sign_bits(a00) & sign_bits(a01) & sign_bits(a10) & sign_bits(a11));
}

// LeakyReLU on the pooled accumulator, then the cast to O.
template <typename O, typename A>
__device__ __forceinline__ O activate(A pooled, float slope) {
  if constexpr (std::is_same<A, uint32_t>::value) {
    const int32_t v = (int32_t)pooled;
    const int32_t a = v >= 0 ? v : __float2int_rn(slope * __int2float_rn(v));
    return (O)a;                                     // wraps when narrowing
  } else {
    return elem::from_f32<O>(pooled >= 0.0f ? pooled : slope * pooled);
  }
}

// Rows to stage: the first `rows` rows of a copy go to p + q * ld, element
// j of a row to [j * step], `len` elements a row.
template <typename S>
struct Dst {
  S* p;
  int rows, ld, step, len;
};

// Where row q comes from: n valid elements at src, zeros after them.
template <typename T>
struct Src {
  const T* src;
  int n;
};

// Copies a.rows rows into a, then b.rows rows into b (row q of the whole
// from src_of(q)), widened to S. Warps take rows, lanes columns; each
// thread issues the loads of R rows before it stores any, so a batch is
// one round trip to memory.
template <int R, typename S, typename T, typename SrcOf>
__device__ __forceinline__ void stage_rows(Dst<S> a, Dst<S> b, SrcOf src_of,
                                           int warp, int warps, int lane) {
  const int rows = a.rows + b.rows;
  for (int col0 = 0; col0 < max(a.len, b.len); col0 += 64)
    for (int q0 = warp; q0 < rows; q0 += R * warps) {
      T v[R][2];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int q = q0 + i * warps;
        const Src<T> r = q < rows ? src_of(q) : Src<T>{nullptr, 0};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + lane + 32 * j;
          v[i][j] = col < r.n ? r.src[col] : elem::from_f32<T>(0.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int q = q0 + i * warps;
        // field by field: a reference to a or b would put both on the stack
        const bool in_a = q < a.rows;
        S* row = in_a ? a.p + q * a.ld : b.p + (q - a.rows) * b.ld;
        const int step = in_a ? a.step : b.step, len = in_a ? a.len : b.len;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = col0 + lane + 32 * j;
          if (q < rows && col < len) row[col * step] = widen<S>(v[i][j]);
        }
      }
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async of `bytes` (16, 8 or 4) bytes, zero-filled where !in.
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes, bool in) {
  const int n = in ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------------------------------ mma
namespace mma {

constexpr int PY = 2, PX = 16;        // pooled outputs of a block
constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int NT = 64;                // filters of a block: 8 n-tiles of 8
static_assert(WARPS * 8 == PY * PX, "a warp takes 8 pooled outputs");

template <typename T> struct Mma;
template <> struct Mma<bf16> {
  static constexpr int KS = 16;       // k of one m16n8k16
  typedef float Sum;
  static __device__ __forceinline__ void run(Sum (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Mma<int8_t> {
  static constexpr int KS = 32;       // k of one m16n8k32
  typedef int32_t Sum;
  static __device__ __forceinline__ void run(Sum (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Shared memory of one block, in elements and byte offsets: the input tile
// (C x TH rows of TWs, then a zero block that padded k read), the filters
// (NT rows of Kps), the k -> offset table (Kp ints), the pooled outputs.
struct Layout {
  int TH, TW, TWs, K, Kp, Kps, zero;
  int xs, fs, koff, os, bytes;
};

template <typename T, typename O>
__host__ __device__ Layout layout(int C, int KH, int KW) {
  constexpr int V = 16 / (int)sizeof(T);
  Layout L;
  L.TH = 2 * PY + KH - 1;
  L.TW = 2 * PX + KW - 1;
  L.TWs = round_up(L.TW, V);
  L.K = C * KH * KW;
  L.Kp = round_up(L.K, Mma<T>::KS);
  L.Kps = L.Kp + V;
  L.zero = C * L.TH * L.TWs;
  L.xs = 0;
  L.fs = round_up((L.zero + 2 * PY * L.TWs) * (int)sizeof(T), 16);
  L.koff = L.fs + NT * L.Kps * (int)sizeof(T);
  L.os = round_up(L.koff + L.Kp * 4, 16);
  L.bytes = L.os + NT * PY * PX * (int)sizeof(O);
  return L;
}

// chunk: bytes of one cp.async of the input tile (16, 8, 4), or 0 where
// the rows do not allow 4 (loads through registers).
template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
conv_mma_kernel(const T* __restrict__ x, const T* __restrict__ f,
                O* __restrict__ out, int C, int H, int W, int F, int KH, int KW,
                int OH, int OW, float slope, int chunk) {
  typedef Mma<T> M;
  typedef typename M::Sum Sum;
  typedef typename std::conditional<sizeof(T) == 2, uint16_t, uint8_t>::type Bits;
  constexpr int E = 4 / (int)sizeof(T);       // elements in a 32-bit register
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout<T, O>(C, KH, KW);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* fs = reinterpret_cast<T*>(smem + L.fs);
  int* koff = reinterpret_cast<int*>(smem + L.koff);
  O* os = reinterpret_cast<O*>(smem + L.os);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int oy0 = blockIdx.y * PY, ox0 = blockIdx.x * PX;
  const int y0 = 2 * oy0, x0 = 2 * ox0;
  const int f0 = blockIdx.z * NT, nf = min(NT, F - f0);
  const int TH = L.TH, TWs = L.TWs, K = L.K;

  // the input tile by cp.async where the rows allow it, else with the
  // filters as B (zero past K and past the block's filters), in one batch
  if (chunk) {
    const int V = chunk / (int)sizeof(T), per_row = TWs / V;
    for (int q = warp; q < C * TH; q += WARPS) {
      const int c = q / TH, y = y0 + q - c * TH;
      const T* src = x + ((ll)c * H + min(y, H - 1)) * W + x0;
      for (int j = lane; j < per_row; j += 32) {
        const bool in = y < H && x0 + j * V < W;
        cp_async(smem_u32(xs + q * TWs + j * V), in ? src + j * V : x, chunk, in);
      }
    }
  }
  const int xrows = chunk ? 0 : C * TH;
  stage_rows<8, T, T>(Dst<T>{xs, xrows, TWs, 1, TWs}, Dst<T>{fs, NT, L.Kps, 1, L.Kps},
                      [&](int q) {
    if (q < xrows) {
      const int c = q / TH, y = y0 + q - c * TH;
      return Src<T>{x + ((ll)c * H + y) * W + x0, y < H ? min(L.TW, W - x0) : 0};
    }
    const int n = q - xrows;
    return Src<T>{f + (ll)(f0 + n) * K, n < nf ? K : 0};
  }, warp, WARPS, lane);
  for (int i = threadIdx.x; i < 2 * PY * TWs; i += THREADS)
    xs[L.zero + i] = elem::from_f32<T>(0.0f);
  for (int k = threadIdx.x; k < L.Kp; k += THREADS) {
    int off = L.zero;                          // padded k: the zero block
    if (k < K) {
      const int c = k / (KH * KW), r = k - c * KH * KW, di = r / KW;
      off = (c * TH + di) * TWs + r - di * KW;
    }
    koff[k] = off;
  }
  if (chunk) cp_wait_all();
  __syncthreads();

  // warp: pooled outputs 8w .. 8w+7 of the tile; lane: g, t of the fragments
  const int g = lane / 4, t = lane % 4;
  const int p = warp * 8 + g, py = p / PX, px = p % PX;
  const int base = 2 * py * TWs + 2 * px;      // top-left conv output's window
  const Bits* xb = reinterpret_cast<const Bits*>(xs);
  const int ntiles = (nf + 7) / 8;
  Sum acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0;

  for (int kb = 0; kb < L.Kp; kb += M::KS) {
    int lo[E], hi[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      lo[e] = koff[kb + E * t + e];
      hi[e] = koff[kb + M::KS / 2 + E * t + e];
    }
    // A: quadrant q of the pooled output (TL, TR, BL, BR), k lo and hi
    uint32_t qa[4][2];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const Bits* xq = xb + base + (q / 2) * TWs + (q % 2);
      uint32_t rl = 0, rh = 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        rl |= (uint32_t)xq[lo[e]] << (8 * sizeof(T) * e);
        rh |= (uint32_t)xq[hi[e]] << (8 * sizeof(T) * e);
      }
      qa[q][0] = rl;
      qa[q][1] = rh;
    }
    // m-tile 0: rows g (TL) and g+8 (TR); m-tile 1: BL and BR
    const uint32_t a0[4] = {qa[0][0], qa[1][0], qa[0][1], qa[1][1]};
    const uint32_t a1[4] = {qa[2][0], qa[3][0], qa[2][1], qa[3][1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < ntiles) {
        const T* fb = fs + (j * 8 + g) * L.Kps + kb + E * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(fb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(fb + M::KS / 2);
        M::run(acc[0][j], a0, b0, b1);
        M::run(acc[1][j], a1, b0, b1);
      }
    }
  }

  // pool the four accumulators of each filter, activate, stage, store
  typedef Acc<T> A;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < ntiles) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const A m = pool4<A>((A)acc[0][j][e], (A)acc[0][j][2 + e],
                             (A)acc[1][j][e], (A)acc[1][j][2 + e]);
        os[((j * 8 + 2 * t + e) * PY + py) * PX + px] = activate<O>(m, slope);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nf * PY * PX; i += THREADS) {
    const int n = i / (PY * PX), oy = oy0 + (i / PX) % PY, ox = ox0 + i % PX;
    if (oy < OH && ox < OW) out[((ll)(f0 + n) * OH + oy) * OW + ox] = os[i];
  }
}

template <typename T, typename O>
int launch(const T* x, const T* f, O* out, int C, int H, int W, int F, int KH,
           int KW, int OH, int OW, float slope, cudaStream_t s) {
  const Layout L = layout<T, O>(C, KH, KW);
  if (L.bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (L.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_mma_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // the largest copy that every row start of the tile allows (x0 is a
  // multiple of 32 elements)
  int chunk = 0;
  for (int b = 16; b >= 4 && !chunk; b /= 2)
    if ((W * (int)sizeof(T)) % b == 0 && (uintptr_t)x % b == 0) chunk = b;
  const dim3 grid((OW + PX - 1) / PX, (OH + PY - 1) / PY, (F + NT - 1) / NT);
  conv_mma_kernel<T, O><<<grid, THREADS, L.bytes, s>>>(
      x, f, out, C, H, W, F, KH, KW, OH, OW, slope, chunk);
  return 0;
}

}  // namespace mma

// ----------------------------------------------------------------- simt
namespace simt {

constexpr int PY = 8, PX = 16;        // pooled outputs of a block
constexpr int THREADS = 2 * PY * PX;  // two a pooled output: its two conv rows
constexpr int WARPS = THREADS / 32;
constexpr int FB = 16;                // filters of a block
constexpr int R = 11;                 // rows a warp stages at once: 88 rows, the
                                      // 3 x 22 of a 7x7 filter's tile and 16 filters

template <typename A> __device__ __forceinline__ A from_bits(uint32_t u);
template <> __device__ __forceinline__ float from_bits<float>(uint32_t u) { return __uint_as_float(u); }
template <> __device__ __forceinline__ uint32_t from_bits<uint32_t>(uint32_t u) { return u; }

// The weights of FT filters at one tap: FT consecutive A, 16-byte aligned.
template <int FT, typename A>
__device__ __forceinline__ void load_w(A (&w)[FT], const A* p) {
  if constexpr (FT == 1) {
    w[0] = *p;
  } else {
#pragma unroll
    for (int i = 0; i < FT; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      w[i] = from_bits<A>(v.x);
      w[i + 1] = from_bits<A>(v.y);
      w[i + 2] = from_bits<A>(v.z);
      w[i + 3] = from_bits<A>(v.w);
    }
  }
}

// FT: filters a thread takes at once (1, or 8 from a 16-byte pair of
// loads); the block's filters lie tap by tap, filters innermost. DJ: taps
// of a row a one-filter thread takes at once.
template <typename T, typename O, int FT, int DJ>
__global__ void __launch_bounds__(THREADS)
conv_simt_kernel(const T* __restrict__ x, const T* __restrict__ f,
                 O* __restrict__ out, int C, int H, int W, int F, int KH,
                 int KW, int OH, int OW, float slope) {
  typedef Acc<T> A;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TH = 2 * PY + KH - 1, TW = 2 * PX + KW - 1, K = C * KH * KW;
  A* xs = reinterpret_cast<A*>(smem);                // C x TH x TW
  A* fs = xs + round_up(C * TH * TW, 4);             // K x FB, zero past nf
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int oy0 = blockIdx.y * PY, ox0 = blockIdx.x * PX;
  const int y0 = 2 * oy0, x0 = 2 * ox0;
  const int f0 = blockIdx.z * FB, nf = min(FB, F - f0);

  // the input tile and the filters, in one batch
  const int xrows = C * TH;
  stage_rows<R, A, T>(Dst<A>{xs, xrows, TW, 1, TW}, Dst<A>{fs, FB, 1, FB, K},
                      [&](int q) {
    if (q < xrows) {
      const int c = q / TH, y = y0 + q - c * TH;
      return Src<T>{x + ((ll)c * H + y) * W + x0, y < H ? min(TW, W - x0) : 0};
    }
    const int n = q - xrows;
    return Src<T>{f + (ll)(f0 + n) * K, n < nf ? K : 0};
  }, warp, WARPS, lane);
  __syncthreads();

  // lanes 0-15 of a warp: the top conv row of 16 pooled outputs, 16-31 the
  // bottom row of the same
  const int px = threadIdx.x % PX, half = (threadIdx.x / PX) % 2;
  const int py = threadIdx.x / (2 * PX);
  const A* xrow = xs + (2 * py + half) * TW + 2 * px;
  const int oy = oy0 + py, ox = ox0 + px;
  const bool store = half == 0 && oy < OH && ox < OW;
  for (int fg = 0; fg < nf; fg += FT) {
    A a[FT][2];
#pragma unroll
    for (int fi = 0; fi < FT; ++fi) a[fi][0] = a[fi][1] = 0;
    // per tap, the channels first (the reference's order for floats)
    if constexpr (FT == 1) {
      // one filter: DJ taps of a row at once, each input value serving two
      // of them, DJ independent sums in flight
      for (int di = 0; di < KH; ++di)
        for (int dj0 = 0; dj0 < KW; dj0 += DJ) {
          const int nj = min(DJ, KW - dj0);
          A s[2][DJ];
#pragma unroll
          for (int j = 0; j < DJ; ++j) s[0][j] = s[1][j] = 0;
          for (int c = 0; c < C; ++c) {
            const A* xp = xrow + (c * TH + di) * TW + dj0;
            const A* wp = fs + ((c * KH + di) * KW + dj0) * FB + fg;
            A xr[DJ + 1];
#pragma unroll
            for (int j = 0; j <= DJ; ++j)
              if (j <= nj) xr[j] = xp[j];
#pragma unroll
            for (int j = 0; j < DJ; ++j)
              if (j < nj) {
                const A w = wp[j * FB];
                s[0][j] += xr[j] * w;
                s[1][j] += xr[j + 1] * w;
              }
          }
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            if (j < nj) {
              a[0][0] += s[0][j];
              a[0][1] += s[1][j];
            }
        }
    } else {
      // FT filters: each input value serves them all, 2 FT sums in flight
      for (int di = 0; di < KH; ++di)
        for (int dj = 0; dj < KW; ++dj) {
          A s[FT][2];
#pragma unroll
          for (int fi = 0; fi < FT; ++fi) s[fi][0] = s[fi][1] = 0;
          const A* xp = xrow + di * TW + dj;
          const A* wp = fs + (di * KW + dj) * FB + fg;
          for (int c = 0; c < C; ++c) {
            const A x0v = xp[0], x1v = xp[1];
            A w[FT];
            load_w<FT>(w, wp);
#pragma unroll
            for (int fi = 0; fi < FT; ++fi) {
              s[fi][0] += x0v * w[fi];
              s[fi][1] += x1v * w[fi];
            }
            xp += TH * TW;
            wp += KH * KW * FB;
          }
#pragma unroll
          for (int fi = 0; fi < FT; ++fi) {
            a[fi][0] += s[fi][0];
            a[fi][1] += s[fi][1];
          }
        }
    }
#pragma unroll
    for (int fi = 0; fi < FT; ++fi) {
      // top: max(a00, a01), then the bottom's max(a10, a11) from lane + 16.
      // No zero sign fix here (pool4 has one): these sums start at +0 and
      // add in IEEE arithmetic, where +0 + -0 = +0, so no conv output of
      // this variant is -0 and the first of equal values is the max's bits.
      A m = takes(a[fi][1], a[fi][0]) ? a[fi][1] : a[fi][0];
      const A low = __shfl_xor_sync(0xffffffffu, m, PX);
      if (takes(low, m)) m = low;
      if (store && fg + fi < nf)
        out[((ll)(f0 + fg + fi) * OH + oy) * OW + ox] = activate<O>(m, slope);
    }
  }
}

template <typename T, typename O, int FT, int DJ>
int launch_ft(const T* x, const T* f, O* out, int C, int H, int W, int F,
              int KH, int KW, int OH, int OW, float slope, cudaStream_t s) {
  const int TH = 2 * PY + KH - 1, TW = 2 * PX + KW - 1;
  const size_t smem = sizeof(Acc<T>) *
      ((size_t)round_up(C * TH * TW, 4) + (size_t)FB * C * KH * KW);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv_simt_kernel<T, O, FT, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((OW + PX - 1) / PX, (OH + PY - 1) / PY, (F + FB - 1) / FB);
  conv_simt_kernel<T, O, FT, DJ><<<grid, THREADS, smem, s>>>(x, f, out, C, H, W, F,
                                                            KH, KW, OH, OW, slope);
  return 0;
}

// 8 filters a thread from 4 filters up (zero filters fill a group), else
// one, with 4 or 8 taps at once (the fewer that hold a filter row up to 8)
template <typename T, typename O>
int launch(const T* x, const T* f, O* out, int C, int H, int W, int F, int KH,
           int KW, int OH, int OW, float slope, cudaStream_t s) {
  if (F >= 4)
    return launch_ft<T, O, 8, 1>(x, f, out, C, H, W, F, KH, KW, OH, OW, slope, s);
  if (KW <= 4)
    return launch_ft<T, O, 1, 4>(x, f, out, C, H, W, F, KH, KW, OH, OW, slope, s);
  return launch_ft<T, O, 1, 8>(x, f, out, C, H, W, F, KH, KW, OH, OW, slope, s);
}

}  // namespace simt

template <typename T, typename O>
int launch(int variant, const void* x, const void* f, void* out, int C, int H,
           int W, int F, int KH, int KW, float slope, cudaStream_t s) {
  const int OH = (H - KH + 1) / 2, OW = (W - KW + 1) / 2;
  const T* xp = (const T*)x;
  const T* fp = (const T*)f;
  if (variant == MMA) {
    if constexpr (std::is_same<T, bf16>::value || std::is_same<T, int8_t>::value)
      return mma::launch<T, O>(xp, fp, (O*)out, C, H, W, F, KH, KW, OH, OW, slope, s);
    return (int)cudaErrorInvalidValue;           // mma takes bf16 and int8 only
  }
  return simt::launch<T, O>(xp, fp, (O*)out, C, H, W, F, KH, KW, OH, OW, slope, s);
}

// The output type of the input's kind: integer for integer, float for float.
template <typename T>
int launch_in(int variant, const void* x, const void* f, void* out, int C,
              int H, int W, int F, int KH, int KW, int out_code, float slope,
              cudaStream_t s) {
  if constexpr (elem::is_int<T>) {
    switch (out_code) {
      case elem::I8: return launch<T, int8_t>(variant, x, f, out, C, H, W, F, KH, KW, slope, s);
      case elem::I16: return launch<T, int16_t>(variant, x, f, out, C, H, W, F, KH, KW, slope, s);
      case elem::I32: return launch<T, int32_t>(variant, x, f, out, C, H, W, F, KH, KW, slope, s);
    }
  } else {
    switch (out_code) {
      case elem::F32: return launch<T, float>(variant, x, f, out, C, H, W, F, KH, KW, slope, s);
      case elem::BF16: return launch<T, bf16>(variant, x, f, out, C, H, W, F, KH, KW, slope, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The launch's parameters, laid out as kernels/convlayer/kernel.py: Params.
struct LayerParams {
  int C, H, W, F, KH, KW, in_code, out_code;
  float slope;
  int variant;
};

// x (C, H, W) and f (F, C, KH, KW) contiguous, of the type p->in_code; out
// (F, OH, OW) contiguous, of the type p->out_code (kernels/common.py
// ELEM_CODES): an integer type for an integer input, a float type for a
// float input. KH <= H and KW <= W with at least one pooled output.
// p->variant: 0 mma (bf16 or int8 only), 1 simt.
extern "C" int conv_layer_launch(const void* x, const void* f, void* out,
                                 const LayerParams* p, void* stream) {
  const int C = p->C, H = p->H, W = p->W, F = p->F, KH = p->KH, KW = p->KW;
  if (C < 1 || F < 1 || KH < 1 || KW < 1 || (H - KH + 1) / 2 < 1 ||
      (W - KW + 1) / 2 < 1 || (p->variant != MMA && p->variant != SIMT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  ELEM_DISPATCH(p->in_code, T,
    err = launch_in<T>(p->variant, x, f, out, C, H, W, F, KH, KW, p->out_code,
                       p->slope, s))
  if (err) return err;
  return (int)cudaGetLastError();
}
