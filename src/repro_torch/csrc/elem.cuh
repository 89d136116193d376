// Element types of the CNN-path kernels (convlayer.cu, maxpool.cu,
// leakyrelu.cu): the dtype codes shared with kernels/common.py ELEM_CODES,
// conversions that round as the reference does (integers to f32 and f32 to
// bf16 to nearest even, f32 to an integer half to even), and a max that
// picks as jnp.maximum does (NaN propagates, +0 over -0).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <algorithm>
#include <type_traits>

typedef long long ll;
typedef __nv_bfloat16 bf16;

namespace elem {

enum Code { F32 = 0, BF16 = 1, I8 = 2, I32 = 3, I16 = 4 };

template <typename T>
constexpr bool is_int = std::is_integral<T>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(int16_t x) { return (float)x; }
__device__ __forceinline__ float to_f32(int32_t x) { return __int2float_rn(x); }

// f32 to T: nearest even for bf16; for an integer type, nearest even to an
// int32, then the narrowing wraps.
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }
template <> __device__ __forceinline__ int8_t from_f32<int8_t>(float v) { return (int8_t)__float2int_rn(v); }
template <> __device__ __forceinline__ int16_t from_f32<int16_t>(float v) { return (int16_t)__float2int_rn(v); }
template <> __device__ __forceinline__ int32_t from_f32<int32_t>(float v) { return __float2int_rn(v); }

// Whether v replaces the running max m, as jnp.maximum(m, v) picks: larger,
// or NaN (the later of two NaNs), or +0 over -0 (for integers, larger).
// Once m is NaN nothing but another NaN replaces it.
template <typename T>
__device__ __forceinline__ bool takes(T v, T m) {
  if constexpr (is_int<T>) {
    return v > m;
  } else {
    const float a = to_f32(v), b = to_f32(m);
    return a != a || a > b || (a == b && __float_as_uint(a) < __float_as_uint(b));
  }
}

}  // namespace elem

// Runs BODY with T bound to the element type of `code`; an unknown code
// returns cudaErrorInvalidValue from the enclosing function.
#define ELEM_DISPATCH(code, T, ...)                                   \
  switch (code) {                                                     \
    case elem::F32: { typedef float T; __VA_ARGS__; } break;          \
    case elem::BF16: { typedef bf16 T; __VA_ARGS__; } break;          \
    case elem::I8: { typedef int8_t T; __VA_ARGS__; } break;          \
    case elem::I16: { typedef int16_t T; __VA_ARGS__; } break;        \
    case elem::I32: { typedef int32_t T; __VA_ARGS__; } break;        \
    default: return (int)cudaErrorInvalidValue;                       \
  }
