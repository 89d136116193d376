// xmk2 MaxPool for Hopper: the 2D max of x (H, W) over win x win windows
// at `stride`, out (OH, OW) with OH = (H - win) / stride + 1 (the ragged
// tail is dropped), the same for the width.
//
// Replaces the TPU kernel src/repro/kernels/maxpool/kernel.py:
// maxpool_pallas (body _maxpool_kernel). Same contract, for int8, int16,
// int32, f32 and bf16: NaN propagates, as jnp.maximum does (fmaxf would drop
// it), and the output keeps the input's elements bit for bit.
//
// What bounds it on this card, and what the design does about it: the bytes
// (each input element read once, each output written once; win^2 compares
// per output). One thread per output, neighbouring threads on neighbouring
// outputs of one row, so a warp's loads of one window row fall on
// `stride`-spaced addresses of a few cache lines; overlapping windows
// (stride < win) are read again from L1, not from device memory. The grid
// covers exactly the outputs, so there is no padding: the TPU kernel's
// -inf / dtype-min rows of a ragged last band have no counterpart.
// Every launch returns cudaGetLastError() to the caller.
#include "elem.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
maxpool_kernel(const T* __restrict__ x, T* __restrict__ out, int W, int OH,
               int OW, int win, int stride) {
  const ll i = (ll)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (ll)OH * OW) return;
  const int oy = (int)(i / OW), ox = (int)(i % OW);
  const T* p = x + (ll)oy * stride * W + (ll)ox * stride;
  T m = p[0];
  for (int di = 0; di < win; ++di)
    for (int dj = 0; dj < win; ++dj) {
      const T v = p[(ll)di * W + dj];
      if (elem::takes(v, m)) m = v;
    }
  out[i] = m;
}

}  // namespace

// x is (H, W) contiguous, out (OH, OW) contiguous, of the type `code`
// (kernels/common.py ELEM_CODES); 1 <= win <= H, W and stride >= 1.
extern "C" int maxpool_launch(const void* x, void* out, int H, int W, int win,
                              int stride, int code, void* stream) {
  if (win < 1 || stride < 1 || win > H || win > W)
    return (int)cudaErrorInvalidValue;
  const int OH = (H - win) / stride + 1, OW = (W - win) / stride + 1;
  const ll n = (ll)OH * OW;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  ELEM_DISPATCH(code, T,
    maxpool_kernel<T><<<blocks, THREADS, 0, s>>>((const T*)x, (T*)out, W, OH,
                                                 OW, win, stride))
  return (int)cudaGetLastError();
}
