// xmk1 LeakyReLU for Hopper: out = x >= 0 ? x : cast(slope * f32(x)).
//
// Replaces the TPU kernel src/repro/kernels/leakyrelu/kernel.py:
// leakyrelu_pallas (body _leakyrelu_kernel). Same contract, for int8, int16,
// int32, f32 and bf16: the product is taken in f32; for an integer dtype it
// is rounded half to even (__float2int_rn, as jnp.round; roundf would round
// -2.5 to -3), for bf16 to nearest even. NaN is not >= 0 and stays NaN.
//
// What bounds it on this card, and what the design does about it: the bytes
// (one read and one write of each element, one operation each). Each
// thread moves 16 bytes at a time (one uint4 of 16 int8 or 4 f32 elements)
// when the input is 16-byte aligned, and one element at a time otherwise; a
// grid-stride loop covers any length and the ragged tail. The TPU kernel's
// padding to (8, 128) blocks has no counterpart: the tensor is read flat.
// Every launch returns cudaGetLastError() to the caller.
#include "elem.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

template <typename T>
__device__ __forceinline__ T leaky(T x, float slope) {
  if constexpr (elem::is_int<T>) {
    return x >= 0 ? x : elem::from_f32<T>(slope * elem::to_f32(x));
  } else {
    const float v = elem::to_f32(x);
    return v >= 0.0f ? x : elem::from_f32<T>(slope * v);
  }
}

// VEC: 16-byte chunks (the input is 16-byte aligned), else single elements.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
leakyrelu_kernel(const T* __restrict__ x, T* __restrict__ out, ll n,
                 float slope) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  typedef typename std::conditional<VEC, uint4, T>::type Chunk;
  const ll tid = (ll)blockIdx.x * THREADS + threadIdx.x;
  const ll step = (ll)gridDim.x * THREADS;
  const ll nv = n / V;
  for (ll i = tid; i < nv; i += step) {
    Chunk raw = reinterpret_cast<const Chunk*>(x)[i];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = leaky(e[j], slope);
    reinterpret_cast<Chunk*>(out)[i] = raw;
  }
  for (ll i = nv * V + tid; i < n; i += step) out[i] = leaky(x[i], slope);
}

template <typename T>
void launch(const void* x, void* out, ll n, float slope, cudaStream_t s) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const ll chunks = vec ? n / (16 / sizeof(T)) : n;
  const int blocks = (int)std::min<ll>(std::max<ll>((chunks + THREADS - 1) / THREADS, 1),
                                       MAX_BLOCKS);
  if (vec)
    leakyrelu_kernel<T, true><<<blocks, THREADS, 0, s>>>((const T*)x, (T*)out, n, slope);
  else
    leakyrelu_kernel<T, false><<<blocks, THREADS, 0, s>>>((const T*)x, (T*)out, n, slope);
}

}  // namespace

// x and out hold n contiguous elements of the type `code` (kernels/common.py
// ELEM_CODES).
extern "C" int leakyrelu_launch(const void* x, void* out, ll n, int code,
                                float slope, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  ELEM_DISPATCH(code, T, launch<T>(x, out, n, slope, s))
  return (int)cudaGetLastError();
}
