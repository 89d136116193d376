// xmk0 GeMM for Hopper: D = alpha * (A @ B) + beta * C.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py: gemm_pallas
// (body _gemm_kernel). Same contract: int8 inputs accumulate exactly in
// int32, bf16 and f32 inputs in f32 (true f32 FMA, never TF32); the epilogue
// works in f32, applies alpha, then beta * C, and rounds half-to-even only
// for an integer output when alpha != 1 or C is given.
//
// What bounds it on this card, and what the design does about it:
//  * Decode (M = live slots, 1..8) is bound by the bytes of B: every weight
//    is read once per step, at 2 flop per weight element and row of A. Two
//    GEMV-shaped kernels stream B at 16 bytes a thread with A staged in
//    shared memory as f32: gemv_n when B's N stride is 1 (a weight
//    matrix), gemv_t when its K stride is 1 (the unembed's transposed
//    table view, read in place: no copy of the 1.8 GB table). Ragged M, N
//    and K are masked in the kernel, so no weight is ever padded or copied.
//  * Prefill (M = prompt length) is bound by operations. bf16 goes through
//    tensor cores with WMMA 16x16x16 tiles (64x128 block tile, 8 warps);
//    f32 and int8 go through a register-blocked CUDA-core kernel. Both
//    are simple: no cp.async pipeline, no wgmma/TMA yet.
//  * C is read through its own strides, so a broadcast bias (M stride 0)
//    is never materialised.
// Every launch returns cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

typedef long long ll;
typedef __nv_bfloat16 bf16;

namespace {

enum Code { F32 = 0, BF16 = 1, I8 = 2, I32 = 3 };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ int widen(int8_t x) { return (int)x; }

__device__ __forceinline__ float load_any(const void* p, int code, ll i) {
  switch (code) {
    case F32: return ((const float*)p)[i];
    case BF16: return __bfloat162float(((const bf16*)p)[i]);
    case I8: return (float)((const int8_t*)p)[i];
    default: return (float)((const int*)p)[i];
  }
}

__device__ __forceinline__ void store_float(void* p, int code, ll i, float v) {
  switch (code) {
    case F32: ((float*)p)[i] = v; break;
    case BF16: ((bf16*)p)[i] = __float2bfloat16_rn(v); break;
    case I8: ((int8_t*)p)[i] = (int8_t)(int)v; break;
    default: ((int*)p)[i] = (int)v;
  }
}

__device__ __forceinline__ void store_int(void* p, int code, ll i, int v) {
  switch (code) {
    case F32: ((float*)p)[i] = (float)v; break;
    case BF16: ((bf16*)p)[i] = __float2bfloat16_rn((float)v); break;
    case I8: ((int8_t*)p)[i] = (int8_t)v; break;
    default: ((int*)p)[i] = v;
  }
}

struct Epi {
  const void* c;
  ll scm, scn;
  int c_code;
  void* d;        // (M, N) contiguous
  int out_code;
  int N;
  float alpha, beta;
  int has_c;
};

// The reference epilogue, element by element (separate mul and add, as the
// reference does them; no fused multiply-add).
template <typename AccT>
__device__ __forceinline__ void epilogue(const Epi& e, int m, int n, AccT acc) {
  const ll di = (ll)m * e.N + n;
  if (e.alpha == 1.0f && !e.has_c) {
    if constexpr (std::is_same<AccT, int>::value) store_int(e.d, e.out_code, di, acc);
    else store_float(e.d, e.out_code, di, acc);
    return;
  }
  float v = (float)acc;
  if (e.alpha != 1.0f) v = __fmul_rn(e.alpha, v);
  if (e.has_c)
    v = __fadd_rn(v, __fmul_rn(e.beta, load_any(e.c, e.c_code,
                                                (ll)m * e.scm + (ll)n * e.scn)));
  if (e.out_code == I8 || e.out_code == I32) v = rintf(v);
  store_float(e.d, e.out_code, di, v);
}

// V elements of T from global memory, as one 16- or 8-byte load when V > 1.
template <typename T, int V>
__device__ __forceinline__ void ldg_vec(const T* p, T (&out)[V]) {
  constexpr int BYTES = V * (int)sizeof(T);
  if constexpr (BYTES == 16) {
    *reinterpret_cast<uint4*>(out) = __ldg(reinterpret_cast<const uint4*>(p));
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(out) = __ldg(reinterpret_cast<const uint2*>(p));
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = p[v];
  }
}

// V accumulator-typed values from shared memory, 16 bytes at a time.
template <typename AccT, int V>
__device__ __forceinline__ void lds_vec(const AccT* p, AccT (&out)[V]) {
  if constexpr ((V * sizeof(AccT)) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < (int)(V * sizeof(AccT) / 16); ++i)
      reinterpret_cast<uint4*>(out)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = p[v];
  }
}

template <typename T, bool VEC>
__host__ __device__ constexpr int vec_width() {
  return VEC ? (16 / (int)sizeof(T) > 8 ? 8 : 16 / (int)sizeof(T)) : 1;
}

constexpr int THREADS = 256;
constexpr int KC = 512;      // K chunk of A staged in shared memory (GEMV)

// Stage rows [0, MMAX) x columns [k0, k0 + KC) of A into shared memory,
// widened to the accumulator type; rows >= M and columns >= K are zero.
template <typename T, typename AccT, int MMAX>
__device__ __forceinline__ void stage_a(AccT (*As)[KC], const T* a, ll sam,
                                        ll sak, int M, int K, int k0) {
  for (int i = threadIdx.x; i < MMAX * KC; i += THREADS) {
    const int m = i / KC, k = i % KC;
    As[m][k] = (m < M && k0 + k < K) ? widen(a[(ll)m * sam + (ll)(k0 + k) * sak])
                                     : AccT(0);
  }
}

// ---------------------------------------------------------------- gemv_n
// B's N stride is 1 (or general when !VEC). Four threads cover one row of a
// BN-column strip (16 bytes each); the block's 64 row groups walk K and are
// summed at the end, first by warp shuffles, then through shared memory.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemv_n_kernel(const T* __restrict__ a, ll sam, ll sak, const T* __restrict__ b,
              ll sbk, ll sbn, int M, int N, int K, Epi e) {
  using AccT = typename AccOf<T>::type;
  constexpr int V = vec_width<T, VEC>();
  constexpr int TPR = 4;
  constexpr int BN = TPR * V;
  constexpr int R = THREADS / TPR;
  __shared__ __align__(16) AccT As[MMAX][KC];
  __shared__ AccT red[THREADS / 32][MMAX][BN];
  const int t = threadIdx.x, cg = t % TPR, r = t / TPR;
  const int n0 = blockIdx.x * BN + cg * V;
  AccT acc[MMAX][V];
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = AccT(0);

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    stage_a<T, AccT, MMAX>(As, a, sam, sak, M, K, k0);
    __syncthreads();
#pragma unroll 4
    for (int k = r; k < kc; k += R) {
      alignas(16) T bv[V];
      const T* bp = b + (ll)(k0 + k) * sbk;
      if constexpr (VEC) {
        if (n0 < N) {
          ldg_vec<T, V>(bp + n0, bv);   // N % V == 0 here
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) bv[v] = T(0);
        }
      } else {
        bv[0] = n0 < N ? bp[(ll)n0 * sbn] : T(0);
      }
#pragma unroll
      for (int m = 0; m < MMAX; ++m) {
        const AccT av = As[m][k];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] += av * widen(bv[v]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int off = TPR; off < 32; off <<= 1)
        acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], off);
  const int warp = t / 32, lane = t % 32;
  if (lane < TPR)
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) red[warp][m][lane * V + v] = acc[m][v];
  __syncthreads();
  for (int i = t; i < M * BN; i += THREADS) {
    const int m = i / BN, j = i % BN, n = blockIdx.x * BN + j;
    AccT s = AccT(0);
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][m][j];
    if (n < N) epilogue(e, m, n, s);
  }
}

// ---------------------------------------------------------------- gemv_t
// B's K stride is 1: column n of B is a contiguous run of K elements (a row
// of the table behind a transposed view). Each warp owns CPW columns; its
// lanes read 16 bytes of each column per step and reduce by shuffles.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(THREADS)
gemv_t_kernel(const T* __restrict__ a, ll sam, ll sak, const T* __restrict__ b,
              ll sbn, int M, int N, int K, Epi e) {
  using AccT = typename AccOf<T>::type;
  constexpr int V = vec_width<T, VEC>();
  constexpr int CPW = 8;
  constexpr int BN = (THREADS / 32) * CPW;
  __shared__ __align__(16) AccT As[MMAX][KC];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int nb = blockIdx.x * BN + warp * CPW;
  AccT acc[MMAX][CPW];
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < CPW; ++c) acc[m][c] = AccT(0);

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();
    stage_a<T, AccT, MMAX>(As, a, sam, sak, M, K, k0);
    __syncthreads();
    for (int k = lane * V; k < kc; k += 32 * V) {   // K % V == 0 when VEC
      alignas(16) AccT av[MMAX][V];
#pragma unroll
      for (int m = 0; m < MMAX; ++m) lds_vec<AccT, V>(&As[m][k], av[m]);
#pragma unroll
      for (int c = 0; c < CPW; ++c) {
        const int n = nb + c;
        if (n >= N) break;
        alignas(16) T bv[V];
        ldg_vec<T, V>(b + (ll)n * sbn + k0 + k, bv);
#pragma unroll
        for (int m = 0; m < MMAX; ++m)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[m][c] += av[m][v] * widen(bv[v]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
  if (lane == 0)
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int m = 0; m < MMAX; ++m)
        if (m < M && nb + c < N) epilogue(e, m, nb + c, acc[m][c]);
}

// ------------------------------------------------------- CUDA-core tiles
// f32 and int8 at M > 8: a 64x64 block tile, K steps of 16, each thread a
// 4x4 register tile on a strided layout (conflict-free shared reads).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gemm_fma_kernel(const T* __restrict__ a, ll sam, ll sak, const T* __restrict__ b,
                ll sbk, ll sbn, int M, int N, int K, Epi e) {
  using AccT = typename AccOf<T>::type;
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ AccT As[BK][BM + 1];
  __shared__ AccT Bs[BK][BN];
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  AccT acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = AccT(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = t; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK, m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? widen(a[(ll)m * sam + (ll)k * sak]) : AccT(0);
    }
    for (int i = t; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN, k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < N) ? widen(b[(ll)k * sbk + (ll)n * sbn]) : AccT(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      AccT av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) epilogue(e, m, n, acc[i][j]);
    }
}

// ------------------------------------------------------------ bf16 WMMA
// bf16 at M > 8: tensor cores through WMMA 16x16x16 (f32 accumulate).
// Block tile 64x128, K steps of 32, 8 warps as 2x4, each a 32x32 warp tile.
// VA / VB: A's K stride / B's N stride is 1 and 16-byte aligned, so tiles
// load as 16-byte vectors; otherwise element by element through strides.
template <bool VA, bool VB>
__global__ void __launch_bounds__(THREADS)
gemm_wmma_bf16_kernel(const bf16* __restrict__ a, ll sam, ll sak,
                      const bf16* __restrict__ b, ll sbk, ll sbn, int M, int N,
                      int K, Epi e) {
  using namespace nvcuda;
  constexpr int BM = 64, BN = 128, BK = 32, LDA = BK + 8, LDB = BN + 8;
  __shared__ __align__(32) bf16 As[BM * LDA];
  __shared__ __align__(32) bf16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[THREADS / 32][16 * 16];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const bf16 zero = __float2bfloat16_rn(0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    if constexpr (VA) {
      const int row = t / 4, col = (t % 4) * 8, m = m0 + row, k = k0 + col;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m < M && k < K) val = __ldg(reinterpret_cast<const uint4*>(a + (ll)m * sam + k));
      *reinterpret_cast<uint4*>(&As[row * LDA + col]) = val;
    } else {
      for (int i = t; i < BM * BK; i += THREADS) {
        const int row = i / BK, col = i % BK, m = m0 + row, k = k0 + col;
        As[row * LDA + col] = (m < M && k < K) ? a[(ll)m * sam + (ll)k * sak] : zero;
      }
    }
    if constexpr (VB) {
      for (int c = t; c < BK * BN / 8; c += THREADS) {
        const int row = c / (BN / 8), col = (c % (BN / 8)) * 8;
        const int k = k0 + row, n = n0 + col;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k < K && n < N) val = __ldg(reinterpret_cast<const uint4*>(b + (ll)k * sbk + n));
        *reinterpret_cast<uint4*>(&Bs[row * LDB + col]) = val;
      }
    } else {
      for (int i = t; i < BK * BN; i += THREADS) {
        const int row = i / BN, col = i % BN, k = k0 + row, n = n0 + col;
        Bs[row * LDB + col] = (k < K && n < N) ? b[(ll)k * sbk + (ll)n * sbn] : zero;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Cs[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int x = lane; x < 256; x += 32) {
        const int m = m0 + wm * 32 + i * 16 + x / 16;
        const int n = n0 + wn * 32 + j * 16 + x % 16;
        if (m < M && n < N) epilogue(e, m, n, Cs[warp][x]);
      }
      __syncwarp();
    }
}

inline bool aligned(const void* p, ll bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int MMAX>
void launch_gemv(const T* a, ll sam, ll sak, const T* b, ll sbk, ll sbn,
                 int M, int N, int K, const Epi& e, cudaStream_t s) {
  constexpr int V = vec_width<T, true>();
  constexpr ll VB = V * sizeof(T);
  if (sbk == 1 && sbn != 1) {
    constexpr int BN = (THREADS / 32) * 8;
    const dim3 grid((N + BN - 1) / BN);
    if (K % V == 0 && aligned(b, VB) && (sbn * (ll)sizeof(T)) % VB == 0)
      gemv_t_kernel<T, MMAX, true><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbn, M, N, K, e);
    else
      gemv_t_kernel<T, MMAX, false><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbn, M, N, K, e);
  } else if (sbn == 1 && N % V == 0 && aligned(b, VB) && (sbk * (ll)sizeof(T)) % VB == 0) {
    const dim3 grid((N + 4 * V - 1) / (4 * V));
    gemv_n_kernel<T, MMAX, true><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
  } else {
    const dim3 grid((N + 3) / 4);
    gemv_n_kernel<T, MMAX, false><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
  }
}

template <typename T>
void launch_small_m(const T* a, ll sam, ll sak, const T* b, ll sbk, ll sbn,
                    int M, int N, int K, const Epi& e, cudaStream_t s) {
  if (M <= 1) launch_gemv<T, 1>(a, sam, sak, b, sbk, sbn, M, N, K, e, s);
  else if (M <= 4) launch_gemv<T, 4>(a, sam, sak, b, sbk, sbn, M, N, K, e, s);
  else launch_gemv<T, 8>(a, sam, sak, b, sbk, sbn, M, N, K, e, s);
}

template <typename T>
void launch_fma(const T* a, ll sam, ll sak, const T* b, ll sbk, ll sbn,
                int M, int N, int K, const Epi& e, cudaStream_t s) {
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  gemm_fma_kernel<T><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
}

void launch_wmma(const bf16* a, ll sam, ll sak, const bf16* b, ll sbk, ll sbn,
                 int M, int N, int K, const Epi& e, cudaStream_t s) {
  const dim3 grid((N + 127) / 128, (M + 63) / 64);
  const bool va = sak == 1 && K % 8 == 0 && sam % 8 == 0 && aligned(a, 16);
  const bool vb = sbn == 1 && N % 8 == 0 && sbk % 8 == 0 && aligned(b, 16);
  if (va && vb)
    gemm_wmma_bf16_kernel<true, true><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
  else if (va)
    gemm_wmma_bf16_kernel<true, false><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
  else if (vb)
    gemm_wmma_bf16_kernel<false, true><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
  else
    gemm_wmma_bf16_kernel<false, false><<<grid, THREADS, 0, s>>>(a, sam, sak, b, sbk, sbn, M, N, K, e);
}

}  // namespace

// Type codes: 0 f32, 1 bf16, 2 int8, 3 int32. c may be null (no epilogue
// term). d is (M, N) contiguous. Returns cudaGetLastError() after launch.
extern "C" int gemm_launch(const void* a, ll sam, ll sak, const void* b,
                           ll sbk, ll sbn, const void* c, ll scm, ll scn,
                           int c_code, void* d, int out_code, int M, int N,
                           int K, int in_code, float alpha, float beta,
                           void* stream) {
  const Epi e{c, scm, scn, c_code, d, out_code, N, alpha, beta, c != nullptr};
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  switch (in_code) {
    case F32:
      if (M <= 8) launch_small_m((const float*)a, sam, sak, (const float*)b, sbk, sbn, M, N, K, e, s);
      else launch_fma((const float*)a, sam, sak, (const float*)b, sbk, sbn, M, N, K, e, s);
      break;
    case BF16:
      if (M <= 8) launch_small_m((const bf16*)a, sam, sak, (const bf16*)b, sbk, sbn, M, N, K, e, s);
      else launch_wmma((const bf16*)a, sam, sak, (const bf16*)b, sbk, sbn, M, N, K, e, s);
      break;
    case I8:
      if (M <= 8) launch_small_m((const int8_t*)a, sam, sak, (const int8_t*)b, sbk, sbn, M, N, K, e, s);
      else launch_fma((const int8_t*)a, sam, sak, (const int8_t*)b, sbk, sbn, M, N, K, e, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
