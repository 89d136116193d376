// xmk1 LeakyReLU for Hopper: out = x >= 0 ? x : cast(slope * f32(x)).
//
// Replaces the TPU kernel src/repro/kernels/leakyrelu/kernel.py:
// leakyrelu_pallas (body _leakyrelu_kernel). Same contract, for int8, int16,
// int32, f32 and bf16: the product is taken in f32; for an integer dtype it
// is rounded half to even (__float2int_rn, as jnp.round; roundf would round
// -2.5 to -3), for bf16 to nearest even. NaN is not >= 0 and stays NaN.
//
// What bounds it on this card, and what the design does about it: the bytes
// (one read and one write of each element, one operation each), and at the
// CNN layer's sizes (16 K to 800 K elements) the latency of device memory.
// A thread moves chunks of 16 bytes (16 int8 or 4 f32 elements) when input
// and output are 16-byte aligned, single elements otherwise. A tensor of up
// to one block of 128 threads an SM gets a chunk a thread, spread over as
// many SMs as it fills; a larger one gets U chunks a thread a round (4 for
// 4-byte types, 2 for 2-byte ones: 16 elements; int8 keeps one chunk, its
// 16 elements being the work), one grid apart, all U loads issued before
// the first store so that one round trip to memory covers them, on a grid
// of at most one wave of resident blocks (16 an SM). The ragged tail past
// the last whole chunk (under 16 bytes) is loaded by the first threads
// with their first chunks. The TPU kernel's padding to (8, 128) blocks has
// no counterpart: the tensor is read flat. Every launch returns
// cudaGetLastError() to the caller.
#include "elem.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int BLOCKS_PER_SM = 2048 / THREADS;

template <typename T>
__device__ __forceinline__ T leaky(T x, float slope) {
  if constexpr (elem::is_int<T>) {
    return x >= 0 ? x : elem::from_f32<T>(slope * elem::to_f32(x));
  } else {
    const float v = elem::to_f32(x);
    return v >= 0.0f ? x : elem::from_f32<T>(slope * v);
  }
}

// VEC: 16-byte chunks (input and output 16-byte aligned), else single
// elements; U: chunks a thread has in flight.
template <typename T, bool VEC, int U>
__global__ void __launch_bounds__(THREADS)
leakyrelu_kernel(const T* __restrict__ x, T* __restrict__ out, ll n,
                 float slope) {
  constexpr int V = VEC ? 16 / sizeof(T) : 1;
  typedef typename std::conditional<VEC, uint4, T>::type Chunk;
  const Chunk* xc = reinterpret_cast<const Chunk*>(x);
  Chunk* oc = reinterpret_cast<Chunk*>(out);
  const ll nv = n / V;
  const ll tid = (ll)blockIdx.x * THREADS + threadIdx.x;
  const ll threads = (ll)gridDim.x * THREADS;
  // the ragged tail (under V elements) past the last whole chunk: loaded
  // with the first round's chunks, so it costs no round trip of its own
  const bool tail = tid < n - nv * V;
  T tv;
  if (tail) tv = x[nv * V + tid];
  for (ll i0 = tid; i0 < nv; i0 += U * threads) {
    Chunk raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const ll i = i0 + u * threads;
      if (i < nv) raw[u] = xc[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const ll i = i0 + u * threads;
      if (i < nv) {
        T* e = reinterpret_cast<T*>(&raw[u]);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = leaky(e[j], slope);
        oc[i] = raw[u];
      }
    }
  }
  if (tail) out[nv * V + tid] = leaky(tv, slope);
}

template <typename T, bool VEC>
void launch_vec(const T* x, T* out, ll n, float slope, int sms, cudaStream_t s) {
  // Up to one block an SM, a chunk a thread; past that 16 bytes of elements
  // a thread a round for 2- and 4-byte types (U = 2, 4 chunks), up to one
  // wave. int8 keeps one chunk: its 16 elements a chunk are the work.
  constexpr int U = VEC ? (int)sizeof(T) : 1;
  const ll chunks = VEC ? n / (16 / sizeof(T)) : n;
  const ll one = (chunks + THREADS - 1) / THREADS;
  const ll blocks = one <= sms ? std::max<ll>(one, 1)
                               : std::max<ll>(sms, (one + U - 1) / U);
  const int grid = (int)std::min<ll>(blocks, (ll)sms * BLOCKS_PER_SM);
  if (one <= sms)
    leakyrelu_kernel<T, VEC, 1><<<grid, THREADS, 0, s>>>(x, out, n, slope);
  else
    leakyrelu_kernel<T, VEC, U><<<grid, THREADS, 0, s>>>(x, out, n, slope);
}

template <typename T>
void launch(const void* x, void* out, ll n, float slope, int sms, cudaStream_t s) {
  const bool vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (vec)
    launch_vec<T, true>((const T*)x, (T*)out, n, slope, sms, s);
  else
    launch_vec<T, false>((const T*)x, (T*)out, n, slope, sms, s);
}

}  // namespace

// The launch's parameters, laid out as kernels/leakyrelu/kernel.py: Params.
struct Params {
  ll n;          // elements of x and out
  int code;      // their type (kernels/common.py ELEM_CODES)
  float slope;
  int sms;       // the card's SM count, which sizes the grid
};

// x and out hold p->n contiguous elements of the type p->code.
extern "C" int leakyrelu_launch(const void* x, void* out, const Params* p,
                                void* stream) {
  if (p->sms < 1) return (int)cudaErrorInvalidValue;
  if (p->n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  ELEM_DISPATCH(p->code, T, launch<T>(x, out, p->n, p->slope, p->sms, s))
  return (int)cudaGetLastError();
}
