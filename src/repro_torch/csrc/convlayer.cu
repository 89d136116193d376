// xmk4 fused conv layer for Hopper: conv(valid) -> maxpool 2x2/2 ->
// LeakyReLU -> cast, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/convlayer/kernel.py:
// conv_layer_pallas (body _convlayer_kernel). Same contract: x (C, H, W),
// f (F, C, KH, KW) -> out (F, (H-KH+1)/2, (W-KW+1)/2). The convolution is
// KH*KW shifted multiply-accumulates, each summed over the channels first
// (the reference's order), in an int32 accumulator for integer inputs (the
// MACs run in uint32, so overflow wraps as the reference's int32 does and
// is defined in C++) and in f32 for f32 and bf16. The 2x2 max propagates
// NaN. LeakyReLU rounds slope * f32(v) half to even for integers; the cast
// to the output type wraps for integers and rounds to nearest even for
// bf16.
//
// What bounds it on this card, and what the design does about it: at the
// paper's sizes (3 x 256 x 256, one filter) the layer reads about 200 KB and
// does a few million MACs, well under a microsecond of bytes or of
// operations, so the launch itself and the block's latency set its time;
// with many filters (64 on a first CNN layer) it is the CUDA cores'
// operations. One block of 8 x 16 threads takes an 8 x 16 tile of pooled
// outputs for up to FB filters: it stages the C x (16+KH-1) x (32+KW-1)
// input tile, zero-filled past the edge, and the FB filters in shared
// memory, widened to the accumulator type, once; each thread then computes
// the 2x2 conv outputs under its pooled output for each filter, takes their
// max, applies LeakyReLU and stores, so no intermediate leaves the block.
// The TPU kernel's overlapping pl.Element bands and padded rows have no
// counterpart: the block computes its own offsets and masks its own ragged
// edge. Simple first: no register blocking of the window, no tensor cores.
// Every launch returns cudaGetLastError() to the caller.
#include "elem.cuh"

namespace {

constexpr int TX = 16, TY = 8;        // pooled outputs of one block
constexpr int THREADS = TX * TY;
constexpr int FB = 8;                 // filters of one block
constexpr int MAX_SMEM = 227 * 1024;

template <typename T>
using Acc = typename std::conditional<elem::is_int<T>, uint32_t, float>::type;

template <typename A, typename T>
__device__ __forceinline__ A widen(T v) {
  if constexpr (elem::is_int<T>) return (A)(int32_t)v;   // sign-extend, then mod 2^32
  else return elem::to_f32(v);
}

template <typename A>
__device__ __forceinline__ bool takes(A v, A m) {
  if constexpr (std::is_same<A, uint32_t>::value) return (int32_t)v > (int32_t)m;
  else return v != v || v > m;
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

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
convlayer_kernel(const T* __restrict__ x, const T* __restrict__ f,
                 O* __restrict__ out, int C, int H, int W, int F, int KH,
                 int KW, int OH, int OW, float slope) {
  typedef Acc<T> A;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TH = 2 * TY + KH - 1, TW = 2 * TX + KW - 1;
  const int fsz = C * KH * KW;
  A* xs = reinterpret_cast<A*>(smem);                // C x TH x TW
  A* fs = xs + C * TH * TW;                          // FB x C x KH x KW
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;
  const int f0 = blockIdx.z * FB, nf = min(FB, F - f0);

  for (int i = threadIdx.x; i < C * TH * TW; i += THREADS) {
    const int c = i / (TH * TW), r = (i / TW) % TH, col = i % TW;
    const int y = 2 * oy0 + r, xx = 2 * ox0 + col;
    xs[i] = (y < H && xx < W) ? widen<A>(x[((ll)c * H + y) * W + xx]) : (A)0;
  }
  for (int i = threadIdx.x; i < nf * fsz; i += THREADS)
    fs[i] = widen<A>(f[(ll)f0 * fsz + i]);
  __syncthreads();

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int oy = oy0 + ty, ox = ox0 + tx;
  if (oy >= OH || ox >= OW) return;
  for (int fi = 0; fi < nf; ++fi) {
    const A* fp = fs + fi * fsz;
    A a00 = 0, a01 = 0, a10 = 0, a11 = 0;
    for (int di = 0; di < KH; ++di)
      for (int dj = 0; dj < KW; ++dj) {
        A s00 = 0, s01 = 0, s10 = 0, s11 = 0;
        for (int c = 0; c < C; ++c) {
          const A w = fp[(c * KH + di) * KW + dj];
          const A* xp = xs + (c * TH + 2 * ty + di) * TW + 2 * tx + dj;
          s00 += xp[0] * w;
          s01 += xp[1] * w;
          s10 += xp[TW] * w;
          s11 += xp[TW + 1] * w;
        }
        a00 += s00; a01 += s01; a10 += s10; a11 += s11;
      }
    A m = a00;
    if (takes(a01, m)) m = a01;
    if (takes(a10, m)) m = a10;
    if (takes(a11, m)) m = a11;
    out[((ll)(f0 + fi) * OH + oy) * OW + ox] = activate<O>(m, slope);
  }
}

template <typename T, typename O>
int launch(const void* x, const void* f, void* out, int C, int H, int W,
           int F, int KH, int KW, float slope, cudaStream_t s) {
  const int OH = (H - KH + 1) / 2, OW = (W - KW + 1) / 2;
  const size_t smem = sizeof(Acc<T>) *
      ((size_t)C * (2 * TY + KH - 1) * (2 * TX + KW - 1) + (size_t)FB * C * KH * KW);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        convlayer_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((OW + TX - 1) / TX, (OH + TY - 1) / TY, (F + FB - 1) / FB);
  convlayer_kernel<T, O><<<grid, THREADS, smem, s>>>(
      (const T*)x, (const T*)f, (O*)out, C, H, W, F, KH, KW, OH, OW, slope);
  return 0;
}

// The output type of the input's kind: integer for integer, float for float.
template <typename T>
int launch_in(const void* x, const void* f, void* out, int C, int H, int W,
              int F, int KH, int KW, int out_code, float slope, cudaStream_t s) {
  if constexpr (elem::is_int<T>) {
    switch (out_code) {
      case elem::I8: return launch<T, int8_t>(x, f, out, C, H, W, F, KH, KW, slope, s);
      case elem::I16: return launch<T, int16_t>(x, f, out, C, H, W, F, KH, KW, slope, s);
      case elem::I32: return launch<T, int32_t>(x, f, out, C, H, W, F, KH, KW, slope, s);
    }
  } else {
    switch (out_code) {
      case elem::F32: return launch<T, float>(x, f, out, C, H, W, F, KH, KW, slope, s);
      case elem::BF16: return launch<T, bf16>(x, f, out, C, H, W, F, KH, KW, slope, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (C, H, W) and f (F, C, KH, KW) contiguous, of the type in_code; out
// (F, OH, OW) contiguous, of the type out_code (kernels/common.py
// ELEM_CODES): an integer type for an integer input, a float type for a
// float input. KH <= H and KW <= W with at least one pooled output.
extern "C" int conv_layer_launch(const void* x, const void* f, void* out,
                                 int C, int H, int W, int F, int KH, int KW,
                                 int in_code, int out_code, float slope,
                                 void* stream) {
  if (C < 1 || F < 1 || KH < 1 || KW < 1 || (H - KH + 1) / 2 < 1 ||
      (W - KW + 1) / 2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = 0;
  ELEM_DISPATCH(in_code, T,
    err = launch_in<T>(x, f, out, C, H, W, F, KH, KW, out_code, slope, s))
  if (err) return err;
  return (int)cudaGetLastError();
}
