// xmk2 MaxPool for Hopper: the 2D max of x (H, W) over win x win windows
// at `stride`, out (OH, OW) with OH = (H - win) / stride + 1 (the ragged
// tail is dropped), the same for the width.
//
// Replaces the TPU kernel src/repro/kernels/maxpool/kernel.py:
// maxpool_pallas (body _maxpool_kernel). Same contract, for int8, int16,
// int32, f32 and bf16: NaN propagates and +0 wins over -0, as jnp.maximum
// does (fmaxf would drop NaN), and the output keeps the input's elements
// bit for bit: a window's output is the element that a walk in row-major
// order (di, then dj) with elem::takes picks.
//
// What bounds it on this card: the bytes. Each input byte is read once and
// each output byte written once (win^2 compares per output, nothing to the
// card's rate). On a small map (the CNN layer's 224 x 224 and 254 x 254)
// that is one round trip to device memory; on a large one (tens of MB) the
// memory rate, which needs tens of KB of loads in flight on each SM and
// few load instructions per byte. A window's max takes one fmaxf an
// element where it holds no NaN and its max is not zero, the exact chain
// of elem::takes otherwise (window_max). The host's shape-only plan
// (kernels/maxpool/kernel.py: maxpool_plan), checked here, picks one of
// three variants:
//  * vector (2 x 2 windows at stride 2, rows a multiple of 16 bytes, x on
//    16 bytes): a thread takes V = 8 / sizeof(T) neighbouring outputs, so
//    each of its two input rows is one 16-byte load and its outputs one
//    8-byte store, both streamed (evict-first), straight from and to
//    device memory.
//  * band (overlapping windows, stride < win <= 4, on a map past one wave
//    of threads): row bands staged in shared memory by 16-byte cp.async,
//    the windows read from there, so rows and columns that neighbouring
//    windows share come from device memory once, and a thread walking a
//    column keeps the maxima of shared rows in registers (below).
//  * scalar (any window): a thread takes `per_thread` outputs, 128 apart
//    along the row (neighbouring threads on neighbouring outputs, so a
//    warp's loads of one window element share cache lines), with every
//    element of a window up to 4 x 4 loaded from device memory before the
//    compares: one output a thread on a map of at most one wave of
//    threads, where the time is one round trip, more on a larger one, to
//    keep more bytes in flight.
// band takes every window of 2 to 4 at stride <= win when named; on
// non-overlapping windows it measured slower than vector and scalar on
// the H100 (chip_smoke.py times every variant that takes a row). The TPU
// kernel's padding of a ragged last band (-inf / dtype-min rows) has no
// counterpart: threads past the map do nothing. Every launch returns
// cudaGetLastError() to the caller.
#include "elem.cuh"

// The launch's parameters, laid out as kernels/maxpool/kernel.py: Params.
struct Params {
  int h, w, win, stride, code;
  int variant;      // 0 vector, 1 scalar, 2 band
  int per_thread;   // outputs a thread (vector, scalar)
  int tile_rows, tile_cols;   // output rows and columns of a band tile
  int pitch;        // bytes of a staged row (band)
  int smem;         // shared memory of a band block, bytes
};

namespace {

constexpr int THREADS = 128;     // a block: outputs of one row
constexpr int MAX_GRID_Y = 65535;
constexpr int BAND_THREADS = 256;        // a band block
constexpr int BAND_SMEM_MAX = 48 * 1024; // a band block's tile, no opt-in
enum Variant { VECTOR = 0, SCALAR = 1, BAND = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ float as_value(float f, float) { return f; }
__device__ __forceinline__ bf16 as_value(float f, bf16) { return __float2bfloat16_rn(f); }

// The max of a window's elements v (row-major), the element a chain of
// elem::takes from v[0] picks. Integers: the largest. Floats: where no
// element is NaN and the largest is not zero (the common case), the
// largest by fmaxf, which is an element's value and, being nonzero, its
// bits (bf16 converts back exactly); else the chain itself (the last NaN;
// +0 over -0).
template <typename T, int N>
__device__ __forceinline__ T window_max(const T (&v)[N]) {
  if constexpr (elem::is_int<T>) {
    T m = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) m = v[i] > m ? v[i] : m;
    return m;
  } else {
    float mx = elem::to_f32(v[0]);
    bool nan = mx != mx;
#pragma unroll
    for (int i = 1; i < N; ++i) {
      const float f = elem::to_f32(v[i]);
      nan |= f != f;
      mx = fmaxf(mx, f);
    }
    if (!nan && mx != 0.0f) return as_value(mx, v[0]);
    T m = v[0];
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (elem::takes(v[i], m)) m = v[i];
    return m;
  }
}

// Scalar: outputs ox0 + k * THREADS (k < V) of each output row the block
// takes; WIN, the window, unrolled (0: any, a loop over win).
template <typename T, int WIN, int V>
__global__ void __launch_bounds__(THREADS)
maxpool_scalar_kernel(const T* __restrict__ x, T* __restrict__ out, int W,
                      int OH, int OW, int win, int stride) {
  const int ox0 = blockIdx.x * THREADS * V + threadIdx.x;
  if (ox0 >= OW) return;
  for (int oy = blockIdx.y; oy < OH; oy += gridDim.y) {
    const T* row = x + (ll)oy * stride * W;
    T* dst = out + (ll)oy * OW;
    if constexpr (WIN > 0) {
      T v[V][WIN][WIN];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int ox = ox0 + k * THREADS;
        if (ox < OW) {
          const T* p = row + (ll)ox * stride;
#pragma unroll
          for (int di = 0; di < WIN; ++di)
#pragma unroll
            for (int dj = 0; dj < WIN; ++dj) v[k][di][dj] = p[(ll)di * W + dj];
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int ox = ox0 + k * THREADS;
        if (ox < OW) {
          dst[ox] = window_max(reinterpret_cast<const T(&)[WIN * WIN]>(v[k]));
        }
      }
    } else {
      for (int k = 0; k < V; ++k) {
        const int ox = ox0 + k * THREADS;
        if (ox >= OW) break;
        const T* p = row + (ll)ox * stride;
        T m = p[0];
        for (int di = 0; di < win; ++di)
          for (int dj = 0; dj < win; ++dj) {
            const T v = p[(ll)di * W + dj];
            if (elem::takes(v, m)) m = v;
          }
        dst[ox] = m;
      }
    }
  }
}

// Vector: 2 x 2 windows at stride 2 over rows of a multiple of 16 bytes
// (so OW = W / 2 is a multiple of V), x on 16 bytes and out on 8: a
// thread's V outputs need 16 bytes of each of two input rows and give 8.
template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool_vector_kernel(const T* __restrict__ x, T* __restrict__ out, int W,
                      int OH, int OW) {
  constexpr int V = 8 / sizeof(T);
  const int ox0 = (blockIdx.x * THREADS + threadIdx.x) * V;
  if (ox0 >= OW) return;
  for (int oy = blockIdx.y; oy < OH; oy += gridDim.y) {
    // streamed (evict-first): each byte is read once
    const T* p = x + (ll)oy * 2 * W + 2 * ox0;
    const uint4 ra = __ldcs((const uint4*)p), rb = __ldcs((const uint4*)(p + W));
    const T* a = reinterpret_cast<const T*>(&ra);
    const T* b = reinterpret_cast<const T*>(&rb);
    uint2 ro;
    T* o = reinterpret_cast<T*>(&ro);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const T w[4] = {a[2 * k], a[2 * k + 1], b[2 * k], b[2 * k + 1]};
      o[k] = window_max(w);
    }
    __stcs((uint2*)(out + (ll)oy * OW + ox0), ro);
  }
}

// Band: a block pools tiles of TR output rows x TC output columns,
// stepping down the map by gridDim.y tiles. Row r of a tile's input,
// ic = (tc - 1) * STRIDE + WIN elements from element (oy0 * STRIDE + r,
// ox0 * STRIDE), is the byte range [a0, a1) of x. Its 16-byte-aligned
// middle is copied by cp.async (16 bytes, straight to shared memory), its
// unaligned head and tail (under 16 bytes each) by element loads, all
// issued before the first wait; staged row r begins at band + r * pitch at
// the offset a0 % 16, so that each copy keeps its alignment, and no byte
// outside the map is read. Thread j then walks output column j of the
// tile down its rows (a tile narrower than the block: its rows split among
// groups of threads), from shared memory: a window's max is the max of
// its rows' maxima, and the WIN - STRIDE rows that a window shares with
// the one above keep their maxima in registers, so each output reads
// STRIDE new rows of WIN elements (the first of a column, WIN rows). As in
// window_max, the maxima are fmaxf with a NaN flag, and a window with a
// NaN or a zero max takes the exact chain of elem::takes over its
// elements instead (the rows' order keeps the chain's pick: the last NaN,
// +0 over -0).
template <typename T, int WIN, int STRIDE>
__global__ void __launch_bounds__(BAND_THREADS)
maxpool_band_kernel(const T* __restrict__ x, T* __restrict__ out, int W, int OH,
                    int OW, int TR, int TC, int pitch) {
  extern __shared__ __align__(16) unsigned char band[];
  constexpr int S = sizeof(T);
  constexpr int EDGE = 32 / S;   // a row's elements outside its chunks: fewer
  using Acc = std::conditional_t<elem::is_int<T>, int, float>;
  const int tid = threadIdx.x;
  const int ox0 = blockIdx.x * TC;
  const int tc = min(TC, OW - ox0);
  const int ic = (tc - 1) * STRIDE + WIN;
  const int cpr = ic * S / 16;   // the most 16-byte chunks a row holds
  const ll row_bytes = (ll)W * S;
  for (int oy0 = blockIdx.y * TR; oy0 < OH; oy0 += gridDim.y * TR) {
    const int tr = min(TR, OH - oy0);
    const int ir = (tr - 1) * STRIDE + WIN;
    const uintptr_t t0 = (uintptr_t)x + ((ll)oy0 * STRIDE * W + (ll)ox0 * STRIDE) * S;
    for (int idx = tid; idx < ir * cpr; idx += BAND_THREADS) {
      const int r = idx / cpr, c = idx - r * cpr;
      const uintptr_t a0 = t0 + r * row_bytes;
      const uintptr_t src = ((a0 + 15) & ~(uintptr_t)15) + 16 * c;
      if (src + 16 <= a0 + (uintptr_t)ic * S)
        cp_async16(smem_u32(band + r * pitch + (src - (a0 & ~(uintptr_t)15))),
                   reinterpret_cast<const void*>(src));
    }
    for (int idx = tid; idx < ir * EDGE; idx += BAND_THREADS) {
      const int r = idx / EDGE, k = idx - r * EDGE;
      const uintptr_t a0 = t0 + r * row_bytes;
      const uintptr_t c0 = (a0 + 15) & ~(uintptr_t)15;
      const uintptr_t a1 = a0 + (uintptr_t)ic * S;
      const int chunks = c0 + 16 <= a1 ? (int)(((a1 & ~(uintptr_t)15) - c0) / 16) : 0;
      const int head = min(ic, (int)((c0 - a0) / S));
      const int e = k < head ? k : k + chunks * (16 / S);
      if (e < ic)
        *reinterpret_cast<T*>(band + r * pitch + (a0 & 15) + e * S) =
            __ldcs(reinterpret_cast<const T*>(a0) + e);
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const uintptr_t off0 = t0 & 15, step = (uintptr_t)row_bytes & 15;
    // a narrow tile's columns are walked by groups of its rows
    const int groups = max(1, BAND_THREADS / tc), rpg = (tr + groups - 1) / groups;
    for (int c = tid; c < tc * groups; c += BAND_THREADS) {
      const int g = c / tc, j = c - g * tc;
      // element (r, j * STRIDE + dj) of the staged tile
      auto at = [&](int r, int dj) {
        return *reinterpret_cast<const T*>(band + r * pitch + ((off0 + r * step) & 15) +
                                           (j * STRIDE + dj) * S);
      };
      Acc h[WIN];               // the maxima of the current window's rows
      bool has_nan[WIN] = {};   // and whether each holds a NaN
      for (int i = g * rpg; i < min(tr, (g + 1) * rpg); ++i) {
#pragma unroll
        for (int q = 0; q < WIN; ++q) {
          if (i > g * rpg && q < WIN - STRIDE) {
            h[q] = h[q + STRIDE];
            has_nan[q] = has_nan[q + STRIDE];
          } else {
            const int r = i * STRIDE + q;
            if constexpr (elem::is_int<T>) {
              h[q] = at(r, 0);
#pragma unroll
              for (int dj = 1; dj < WIN; ++dj) h[q] = max(h[q], (int)at(r, dj));
            } else {
              h[q] = elem::to_f32(at(r, 0));
              has_nan[q] = h[q] != h[q];
#pragma unroll
              for (int dj = 1; dj < WIN; ++dj) {
                const float f = elem::to_f32(at(r, dj));
                has_nan[q] |= f != f;
                h[q] = fmaxf(h[q], f);
              }
            }
          }
        }
        Acc mx = h[0];
        bool any_nan = has_nan[0];
#pragma unroll
        for (int q = 1; q < WIN; ++q) {
          if constexpr (elem::is_int<T>) mx = max(mx, h[q]);
          else mx = fmaxf(mx, h[q]);
          any_nan |= has_nan[q];
        }
        T m;
        if constexpr (elem::is_int<T>) {
          m = (T)mx;
        } else if (!any_nan && mx != 0.0f) {
          m = as_value(mx, T());
        } else {
          m = at(i * STRIDE, 0);
          for (int di = 0; di < WIN; ++di)
            for (int dj = 0; dj < WIN; ++dj) {
              const T v = at(i * STRIDE + di, dj);
              if (elem::takes(v, m)) m = v;
            }
        }
        __stcs(out + (ll)(oy0 + i) * OW + ox0 + j, m);
      }
    }
    __syncthreads();
  }
}

template <typename T, int WIN, int STRIDE>
int launch_band(const T* x, T* out, const Params& p, int OH, int OW, cudaStream_t s) {
  const int ir = (p.tile_rows - 1) * STRIDE + WIN;
  const int ic = (p.tile_cols - 1) * STRIDE + WIN;
  if (p.tile_rows < 1 || p.tile_cols < 1 || p.pitch % 16 != 0 ||
      p.pitch < ic * (int)sizeof(T) + 15 || p.smem != ir * p.pitch ||
      p.smem > BAND_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((OW + p.tile_cols - 1) / p.tile_cols,
                  min((OH + p.tile_rows - 1) / p.tile_rows, MAX_GRID_Y));
  maxpool_band_kernel<T, WIN, STRIDE><<<grid, BAND_THREADS, p.smem, s>>>(
      x, out, p.w, OH, OW, p.tile_rows, p.tile_cols, p.pitch);
  return 0;
}

template <typename T, int WIN, int V>
void launch_scalar(const T* x, T* out, const Params& p, int OH, int OW, cudaStream_t s) {
  const dim3 grid((OW + THREADS * V - 1) / (THREADS * V), min(OH, MAX_GRID_Y));
  maxpool_scalar_kernel<T, WIN, V><<<grid, THREADS, 0, s>>>(x, out, p.w, OH, OW,
                                                             p.win, p.stride);
}

template <typename T, int WIN>
int launch_scalar_v(const T* x, T* out, const Params& p, int OH, int OW, cudaStream_t s) {
  switch (p.per_thread) {
    case 1: launch_scalar<T, WIN, 1>(x, out, p, OH, OW, s); return 0;
    case 2: launch_scalar<T, WIN, 2>(x, out, p, OH, OW, s); return 0;
    case 4: launch_scalar<T, WIN, 4>(x, out, p, OH, OW, s); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* xv, void* outv, const Params& p, int OH, int OW,
           cudaStream_t s) {
  const T* x = (const T*)xv;
  T* out = (T*)outv;
  if (p.variant == VECTOR) {
    if (p.win != 2 || p.stride != 2 || ((ll)p.w * sizeof(T)) % 16 != 0 ||
        p.per_thread != 8 / (int)sizeof(T) || (uintptr_t)x % 16 != 0 ||
        (uintptr_t)out % 8 != 0)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((OW / p.per_thread + THREADS - 1) / THREADS, min(OH, MAX_GRID_Y));
    maxpool_vector_kernel<T><<<grid, THREADS, 0, s>>>(x, out, p.w, OH, OW);
    return 0;
  }
  if (p.variant == BAND) {     // windows of 2 to 4 at stride <= win
    switch (p.win * 8 + p.stride) {
      case 2 * 8 + 1: return launch_band<T, 2, 1>(x, out, p, OH, OW, s);
      case 2 * 8 + 2: return launch_band<T, 2, 2>(x, out, p, OH, OW, s);
      case 3 * 8 + 1: return launch_band<T, 3, 1>(x, out, p, OH, OW, s);
      case 3 * 8 + 2: return launch_band<T, 3, 2>(x, out, p, OH, OW, s);
      case 3 * 8 + 3: return launch_band<T, 3, 3>(x, out, p, OH, OW, s);
      case 4 * 8 + 1: return launch_band<T, 4, 1>(x, out, p, OH, OW, s);
      case 4 * 8 + 2: return launch_band<T, 4, 2>(x, out, p, OH, OW, s);
      case 4 * 8 + 3: return launch_band<T, 4, 3>(x, out, p, OH, OW, s);
      case 4 * 8 + 4: return launch_band<T, 4, 4>(x, out, p, OH, OW, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (p.variant != SCALAR) return (int)cudaErrorInvalidValue;
  switch (p.win) {
    case 2: return launch_scalar_v<T, 2>(x, out, p, OH, OW, s);
    case 3: return launch_scalar_v<T, 3>(x, out, p, OH, OW, s);
    case 4: return launch_scalar_v<T, 4>(x, out, p, OH, OW, s);
    default: return launch_scalar_v<T, 0>(x, out, p, OH, OW, s);
  }
}

}  // namespace

// x is (H, W) contiguous and out (OH, OW) contiguous, of the type p->code
// (kernels/common.py ELEM_CODES); 1 <= win <= H, W and stride >= 1; the
// plan (variant, outputs a thread, band tile) is kernel.py's maxpool_plan,
// with the vector variant only for x on 16 bytes and out on 8.
extern "C" int maxpool_launch(const void* x, void* out, const Params* p,
                              void* stream) {
  if (p->win < 1 || p->stride < 1 || p->win > p->h || p->win > p->w)
    return (int)cudaErrorInvalidValue;
  const int OH = (p->h - p->win) / p->stride + 1;
  const int OW = (p->w - p->win) / p->stride + 1;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  ELEM_DISPATCH(p->code, T, err = launch<T>(x, out, *p, OH, OW, s))
  if (err) return err;
  return (int)cudaGetLastError();
}
