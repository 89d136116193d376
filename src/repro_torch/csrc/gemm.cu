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
//    GEMV-shaped kernels stream B at 16 bytes a lane: gemv_n when B's N
//    stride is 1 (a weight matrix; 128-column strips, 256 contiguous bytes
//    of each bf16 row), gemv_t when its K stride is 1 (the unembed's
//    transposed table view, read in place: no copy of the 1.8 GB table; a
//    warp reads 512 contiguous bytes of a column). K is split across blocks
//    so that even a narrow projection (N = 1024) fills the card several
//    times over; each block stages its slice of A once and keeps 8 loads
//    of B in flight a lane with no barrier in its loop, and the splits'
//    sums meet in a workspace, added in a fixed order by the last block of
//    each strip. Ragged M, N and K are masked in the kernel, so no weight
//    is ever padded or copied.
//  * Prefill (M = prompt length) is bound by operations. bf16 with A
//    K-contiguous goes through Hopper's tensor cores: TMA loads into a
//    4-stage ring under mbarriers, one producer warp, two consumer
//    warpgroups on wgmma (128x128 block tile). B is taken in both layouts
//    that TMA can tile: N-contiguous (a weight), read through the wgmma
//    descriptor's transpose bit, and K-contiguous (the unembed's table.T
//    over a whole sequence), wgmma's native layout, tiled like A. Other
//    bf16 operands (rows that are not 16-byte aligned, a broadcast A) go
//    through WMMA 16x16x16 tiles.
//  * int8 at M > 8 with 16-byte rows goes through the integer tensor cores
//    (imma: mma.sync m16n8k32 s8 -> s32; a 4-stage cp.async ring; 64x64
//    block tiles, so that M = 512, N = 1024 fills 128 SMs). wgmma takes
//    8-bit operands only K-major, and a weight B (K, N) is N-contiguous;
//    mma.sync's B fragment is K-major too. The transpose is made while the
//    fragments are loaded: ldmatrix.trans moves 16-bit pairs of N, with
//    its row addresses picking the rows of K so that two 32-bit results
//    hold rows 4t..4t+3 of two columns, and two byte permutes (prmt) part
//    them into each column's fragment. The sums are int32, exact in any
//    order, so the output is bit for bit the CUDA-core kernel's. A
//    K-contiguous B (a transposed view) loads as A does.
//  * f32 at M > 8 with the same layouts (A K-contiguous, B N- or
//    K-contiguous, 16-byte rows) stays on the CUDA cores in true f32
//    (sgemm): 128x128 block tiles (128x64 for small grids), a 4-stage
//    cp.async ring, float4 shared reads that feed 4 FMAs a float, 8x8
//    register tiles a lane. f32 and int8 that sgemm and imma do not take
//    run on a register-blocked CUDA-core kernel (fma), their earlier design.
//  * The variant (gemv, wgmma, wmma, imma, sgemm, fma) is picked by the caller
//    from the operands (gemm_variant in kernel.py) and checked again here;
//    a variant that cannot take the operands is refused, never replaced.
//  * C is read through its own strides, so a broadcast bias (M stride 0)
//    is never materialised.
// Every launch returns cudaGetLastError() to the caller.
#include <cuda.h>            // CUtensorMap and its enums (types only)
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

// alpha * acc + beta * C, rounded half to even for an integer output
// (separate mul and add, as the reference does them; no fused multiply-add).
__device__ __forceinline__ float epi_scaled(const Epi& e, int m, int n, float v) {
  if (e.alpha != 1.0f) v = __fmul_rn(e.alpha, v);
  if (e.has_c)
    v = __fadd_rn(v, __fmul_rn(e.beta, load_any(e.c, e.c_code,
                                                (ll)m * e.scm + (ll)n * e.scn)));
  if (e.out_code == I8 || e.out_code == I32) v = rintf(v);
  return v;
}

// The reference epilogue, element by element.
template <typename AccT>
__device__ __forceinline__ void epilogue(const Epi& e, int m, int n, AccT acc) {
  const ll di = (ll)m * e.N + n;
  if (e.alpha == 1.0f && !e.has_c) {
    if constexpr (std::is_same<AccT, int>::value) store_int(e.d, e.out_code, di, acc);
    else store_float(e.d, e.out_code, di, acc);
    return;
  }
  store_float(e.d, e.out_code, di, epi_scaled(e, m, n, (float)acc));
}

// The same for columns n and n + 1 (n even): one 4-byte store for a bf16
// output and one 8-byte store for an f32 output with N even, else element
// by element with the N edge masked.
__device__ __forceinline__ void epilogue_pair(const Epi& e, int m, int n,
                                              float v0, float v1) {
  if ((e.out_code == BF16 || e.out_code == F32) && (e.N & 1) == 0 && n + 1 < e.N) {
    if (e.alpha != 1.0f || e.has_c) {
      v0 = epi_scaled(e, m, n, v0);
      v1 = epi_scaled(e, m, n + 1, v1);
    }
    const ll di = (ll)m * e.N + n;
    if (e.out_code == BF16)
      *reinterpret_cast<__nv_bfloat162*>((bf16*)e.d + di) = __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>((float*)e.d + di) = make_float2(v0, v1);
    return;
  }
  if (n < e.N) epilogue(e, m, n, v0);
  if (n + 1 < e.N) epilogue(e, m, n + 1, v1);
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

// Four 16-byte loads of read-only global memory in one statement, so that
// the compiler cannot spread them among the arithmetic that uses them: all
// four are in flight at once. Where ok[i] is false, r[i] keeps its value.
__device__ __forceinline__ void ldg16x4(uint4* r, const void* const* p, const bool* ok) {
  asm volatile(
      "{\n\t.reg .pred q0, q1, q2, q3;\n\t"
      "setp.ne.b32 q0, %20, 0;\n\tsetp.ne.b32 q1, %21, 0;\n\t"
      "setp.ne.b32 q2, %22, 0;\n\tsetp.ne.b32 q3, %23, 0;\n\t"
      "@q0 ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%16];\n\t"
      "@q1 ld.global.nc.v4.u32 {%4, %5, %6, %7}, [%17];\n\t"
      "@q2 ld.global.nc.v4.u32 {%8, %9, %10, %11}, [%18];\n\t"
      "@q3 ld.global.nc.v4.u32 {%12, %13, %14, %15}, [%19];\n\t}"
      : "+r"(r[0].x), "+r"(r[0].y), "+r"(r[0].z), "+r"(r[0].w),
        "+r"(r[1].x), "+r"(r[1].y), "+r"(r[1].z), "+r"(r[1].w),
        "+r"(r[2].x), "+r"(r[2].y), "+r"(r[2].z), "+r"(r[2].w),
        "+r"(r[3].x), "+r"(r[3].y), "+r"(r[3].z), "+r"(r[3].w)
      : "l"(p[0]), "l"(p[1]), "l"(p[2]), "l"(p[3]),
        "r"((int)ok[0]), "r"((int)ok[1]), "r"((int)ok[2]), "r"((int)ok[3]));
}

// Eight rows or columns of B, 16 bytes each (V elements of T), all in
// flight before the first is used; zeros where ok[i] is false.
template <typename T, int V>
__device__ __forceinline__ void ldg16x8(T (&out)[8][V], const T* const* p,
                                        const bool* ok) {
  static_assert(V * sizeof(T) == 16, "16-byte pieces");
  uint4 r[8];
  const void* q[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { r[i] = make_uint4(0u, 0u, 0u, 0u); q[i] = p[i]; }
  ldg16x4(r, q, ok);
  ldg16x4(r + 4, q + 4, ok + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) *reinterpret_cast<uint4*>(out[i]) = r[i];
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

// ------------------------------------------------------------------ GEMV
// M <= 8 (decode). The grid is (column strips, K splits): a block takes one
// strip of columns and `chunk` rows of K and streams its part of B with no
// barrier in the loop, eight 16-byte loads of B in flight a lane. gemv_n
// (B read along N) stages its (M, chunk) slice of A in shared memory once
// (f32, int32 for int8) and issues its loads of B as one group (ldg16x8);
// gemv_t (B read along K) reads A's pieces from global memory beside B's,
// so its chunk has no bound and the unembed's 8000 strips take K whole
// (on the H100, faster in bf16 than splits of K over a staged A). With one
// split the block applies the epilogue; with more, each block writes its
// partial sums to a workspace (f32, int32 for int8) and the last block of
// a strip to arrive (a ticket counter per strip, which that block resets
// to 0) adds the partials in split order and applies the epilogue once, to
// the full sum.
// Strips are narrow (128 columns along N, 32 along K), so that the splits a
// strip needs to fill the card, and the partials its last block reads, stay
// few. The split plan (splits, chunk) comes from gemv_plan in kernel.py and
// is checked in plan_ok.
namespace gv {

constexpr int NW = 4;              // warps of a gemv_n block
constexpr int NW_T = 4;            // warps of a gemv_t block
constexpr int KC = 1024;           // most rows of K a gemv_n block takes
constexpr int U = 8;               // pieces of B a lane has in flight
constexpr int CPW = U;             // columns a warp owns (gemv_t)
constexpr int TCOLS = NW_T * CPW;  // columns of a gemv_t strip

struct Args {
  const void* a; ll sam, sak;
  const void* b; ll sbk, sbn;
  int M, N, K, splits, chunk;
  void* ws;                  // (splits, M, N) partial sums when splits > 1
  unsigned* tickets;         // one zeroed counter per strip when splits > 1
  int a_vec;                 // A read 16 bytes at a time (a_vec_ok)
};

// Rows [0, MMAX) x columns [k0, k0 + chunk) of A, widened; zero past M, K.
// Each thread has SU loads in flight (16 bytes each when a_vec), so the
// block waits about one memory latency for A, once.
template <typename T, typename AccT, int MMAX, int NT>
__device__ __forceinline__ void stage_a(AccT* As, const Args& g, int k0) {
  constexpr int SU = 4;
  const T* a = (const T*)g.a;
  if (g.a_vec) {
    constexpr int AV = 16 / (int)sizeof(T);
    const int per_row = g.chunk / AV, total = MMAX * per_row;
    for (int i0 = threadIdx.x; i0 < total; i0 += NT * SU) {
      alignas(16) T v[SU][AV];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = i0 + u * NT, m = i / per_row, kk = (i % per_row) * AV;
        if (i < total && m < g.M && k0 + kk < g.K) {
          ldg_vec<T, AV>(a + (ll)m * g.sam + k0 + kk, v[u]);
        } else {
#pragma unroll
          for (int x = 0; x < AV; ++x) v[u][x] = T(0);
        }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = i0 + u * NT, m = i / per_row, kk = (i % per_row) * AV;
        if (i < total)
#pragma unroll
          for (int x = 0; x < AV; ++x) As[m * KC + kk + x] = widen(v[u][x]);
      }
    }
    return;
  }
  const int total = MMAX * g.chunk;
  for (int i0 = threadIdx.x; i0 < total; i0 += NT * SU) {
    AccT v[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int i = i0 + u * NT, m = i / g.chunk, k = k0 + i % g.chunk;
      v[u] = (i < total && m < g.M && k < g.K) ? widen(a[(ll)m * g.sam + (ll)k * g.sak])
                                               : AccT(0);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int i = i0 + u * NT;
      if (i < total) As[(i / g.chunk) * KC + i % g.chunk] = v[u];
    }
  }
}

// The strip's sums `sum(m, j)` (j < COLS, column n0 + j) reach the output:
// directly with one split, else through the workspace and the strip's last
// block, which keeps PER sums a thread and reads the splits in order with
// the loads of several splits in flight. Called by every thread.
template <typename AccT, int COLS, int MMAX, int NT, typename F>
__device__ __forceinline__ void finish(const Args& g, const Epi& e, int n0, F sum) {
  constexpr int PER = (MMAX * COLS + NT - 1) / NT;
  const int t = threadIdx.x;
  if (g.splits == 1) {
    for (int i = t; i < g.M * COLS; i += NT) {
      const int m = i / COLS, n = n0 + i % COLS;
      if (n < g.N) epilogue(e, m, n, sum(m, i % COLS));
    }
    return;
  }
  AccT* ws = (AccT*)g.ws;
  for (int i = t; i < g.M * COLS; i += NT) {
    const int m = i / COLS, n = n0 + i % COLS;
    if (n < g.N) ws[((ll)blockIdx.y * g.M + m) * g.N + n] = sum(m, i % COLS);
  }
  __shared__ unsigned ticket;
  __threadfence();
  __syncthreads();
  if (t == 0) ticket = atomicAdd(&g.tickets[blockIdx.x], 1u);
  __syncthreads();
  if (ticket != (unsigned)g.splits - 1) return;
  __threadfence();
  AccT s[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) s[r] = AccT(0);
#pragma unroll 8
  for (int sp = 0; sp < g.splits; ++sp)
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int i = t + r * NT, m = i / COLS, n = n0 + i % COLS;
      if (m < g.M && n < g.N) s[r] += __ldcg(&ws[((ll)sp * g.M + m) * g.N + n]);
    }
#pragma unroll
  for (int r = 0; r < PER; ++r) {
    const int i = t + r * NT, m = i / COLS, n = n0 + i % COLS;
    if (m < g.M && n < g.N) epilogue(e, m, n, s[r]);
  }
  if (t == 0) g.tickets[blockIdx.x] = 0u;
}

// B's N stride is 1 (or general when !VEC). A strip is 128 columns: LPR
// lanes span it (16 bytes a lane: 256 contiguous bytes of a bf16 row, 512
// of an f32 one), so a warp covers RPW rows at once. Each of the 4 warps
// takes a quarter of the chunk's rows; per step a lane takes U consecutive
// rows (the first step's loads in flight while A is staged), and the warps
// meet in shared memory at the end.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(NW * 32)
gemv_n_kernel(Args g, Epi e) {
  using AccT = typename AccOf<T>::type;
  constexpr int NT = NW * 32;
  constexpr int V = vec_width<T, VEC>();
  constexpr int BN = VEC ? 128 : 32;
  constexpr int LPR = BN / V;          // lanes across a row
  constexpr int RPW = 32 / LPR;        // rows a warp covers at once
  constexpr int STEP = RPW * U;        // rows a warp takes per step
  __shared__ __align__(16) AccT As[MMAX * KC];   // A, then the warps' sums
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int part = lane / LPR, col = lane % LPR;
  const int n0 = blockIdx.x * BN, n = n0 + col * V;
  const int k0 = blockIdx.y * g.chunk, sub = g.chunk / NW;   // sub % STEP == 0
  const T* b = (const T*)g.b;
  const int kend = min(g.K - k0, (warp + 1) * sub);
  // this lane's U rows of the step at kk (16-byte pieces issued as a group)
  auto load = [&](int kk, T (&bv)[U][V]) {
    const int r0 = kk + part * U;
    if constexpr (V * sizeof(T) == 16) {
      const T* ptr[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ok[u] = n < g.N && r0 + u < kend;
        ptr[u] = ok[u] ? b + (ll)(k0 + r0 + u) * g.sbk + n : b;
      }
      ldg16x8<T, V>(bv, ptr, ok);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (n < g.N && r0 + u < kend) {
          const T* bp = b + (ll)(k0 + r0 + u) * g.sbk;
          if constexpr (VEC) ldg_vec<T, V>(bp + n, bv[u]);   // N % V == 0 here
          else bv[u][0] = bp[(ll)n * g.sbn];
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) bv[u][v] = T(0);
        }
      }
    }
  };
  // the first step's loads are in flight while A is staged
  alignas(16) T bv[U][V];
  if (warp * sub < kend) load(warp * sub, bv);
  stage_a<T, AccT, MMAX, NT>(As, g, k0);
  __syncthreads();
  AccT acc[MMAX][V];
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = AccT(0);
  for (int kk = warp * sub; kk < kend; kk += STEP) {
    if (kk != warp * sub) load(kk, bv);
    const int r0 = kk + part * U;
#pragma unroll
    for (int m = 0; m < MMAX; ++m) {
      alignas(16) AccT av[U];
      lds_vec<AccT, U>(&As[m * KC + r0], av);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] += av[u] * widen(bv[u][v]);
    }
  }
  if constexpr (RPW == 2)
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], 16);
  __syncthreads();                                 // A is no longer read
  AccT* red = As;                                  // [NW][MMAX][V][LPR]
  if (lane < LPR)
#pragma unroll
    for (int m = 0; m < MMAX; ++m)
#pragma unroll
      for (int v = 0; v < V; ++v) red[((warp * MMAX + m) * V + v) * LPR + lane] = acc[m][v];
  __syncthreads();
  finish<AccT, BN, MMAX, NT>(g, e, n0, [&](int m, int j) {   // j = lane V + v
    AccT s = AccT(0);
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[((w * MMAX + m) * V + j % V) * LPR + j / V];
    return s;
  });
}

// B's K stride is 1: column n of B is a contiguous run of K elements (a row
// of the table behind a transposed view). Each of the 4 warps owns CPW
// columns; per step its lanes read 16 contiguous bytes of each of them (512
// bytes a warp and column) and the matching piece of each row of A, which
// they widen in registers: A is read straight from global memory (L1 and L2
// keep it), so a block takes any number of rows of K with no barrier. The
// warp reduces by shuffles once, at the end.
template <typename T, int MMAX, bool VEC>
__global__ void __launch_bounds__(NW_T * 32)
gemv_t_kernel(Args g, Epi e) {
  using AccT = typename AccOf<T>::type;
  constexpr int V = vec_width<T, VEC>();
  __shared__ AccT sums[MMAX][TCOLS];
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int n0 = blockIdx.x * TCOLS, nb = n0 + warp * CPW;
  const int k0 = blockIdx.y * g.chunk;
  const T* a = (const T*)g.a;
  const T* b = (const T*)g.b;
  const int kend = min(g.K - k0, g.chunk);         // K % V == 0 when VEC
  AccT acc[MMAX][CPW];
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < CPW; ++c) acc[m][c] = AccT(0);
  for (int kk = lane * V; kk < kend; kk += 32 * V) {
    alignas(16) T bv[CPW][V];
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      if (nb + c < g.N) {
        ldg_vec<T, V>(b + (ll)(nb + c) * g.sbn + k0 + kk, bv[c]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) bv[c][v] = T(0);
      }
    }
#pragma unroll
    for (int m = 0; m < MMAX; ++m) {
      if (m >= g.M) break;
      alignas(16) T av[V];
      if (VEC && g.a_vec) {
        ldg_vec<T, V>(a + (ll)m * g.sam + k0 + kk, av);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v)
          av[v] = k0 + kk + v < g.K ? a[(ll)m * g.sam + (ll)(k0 + kk + v) * g.sak] : T(0);
      }
#pragma unroll
      for (int c = 0; c < CPW; ++c)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][c] += widen(av[v]) * widen(bv[c][v]);
    }
  }
#pragma unroll
  for (int m = 0; m < MMAX; ++m)
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
      if (lane == 0) sums[m][warp * CPW + c] = acc[m][c];
    }
  __syncthreads();
  finish<AccT, TCOLS, MMAX, NW_T * 32>(g, e, n0, [&](int m, int j) { return sums[m][j]; });
}

inline bool aligned(const void* p, ll bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// B read along K (the unembed's table.T) or along N.
inline bool t_layout(const Args& g) { return g.sbk == 1 && g.sbn != 1; }

// The plan fits the kernels: chunk a multiple of the rows a block steps by
// (64 along N, 32 along K), up to KC rows along N (the slice of A staged),
// every split holding rows of K, and a workspace and counters when
// splits > 1.
inline bool plan_ok(const Args& g) {
  if (g.splits < 1 || g.splits > 65535 || g.chunk <= 0 || (!t_layout(g) && g.chunk > KC) ||
      g.chunk % (t_layout(g) ? 32 : NW * 16) != 0)
    return false;
  if ((ll)g.splits * g.chunk < g.K || (ll)(g.splits - 1) * g.chunk >= (g.K > 1 ? g.K : 1))
    return false;
  return g.splits == 1 || (g.ws != nullptr && g.tickets != nullptr);
}

template <typename T, int MMAX>
void launch_m(const Args& g, const Epi& e, cudaStream_t s) {
  constexpr int V = vec_width<T, true>();
  constexpr ll VB = V * sizeof(T);
  if (t_layout(g)) {
    const dim3 grid((g.N + TCOLS - 1) / TCOLS, g.splits);
    if (g.K % V == 0 && aligned(g.b, VB) && (g.sbn * (ll)sizeof(T)) % VB == 0)
      gemv_t_kernel<T, MMAX, true><<<grid, NW_T * 32, 0, s>>>(g, e);
    else
      gemv_t_kernel<T, MMAX, false><<<grid, NW_T * 32, 0, s>>>(g, e);
  } else if (g.sbn == 1 && g.N % V == 0 && aligned(g.b, VB) &&
             (g.sbk * (ll)sizeof(T)) % VB == 0) {
    gemv_n_kernel<T, MMAX, true><<<dim3((g.N + 127) / 128, g.splits), NW * 32, 0, s>>>(g, e);
  } else {
    gemv_n_kernel<T, MMAX, false><<<dim3((g.N + 31) / 32, g.splits), NW * 32, 0, s>>>(g, e);
  }
}

// A K-contiguous, 16-byte aligned rows, K a multiple of 16 bytes: A is
// staged 16 bytes at a time.
template <typename T>
bool a_vec_ok(const Args& g) {
  return g.sak == 1 && (g.K * (ll)sizeof(T)) % 16 == 0 && aligned(g.a, 16) &&
         (g.M == 1 || (g.sam * (ll)sizeof(T)) % 16 == 0);
}

template <typename T>
void launch(Args g, const Epi& e, cudaStream_t s) {
  g.a_vec = a_vec_ok<T>(g);
  if (g.M <= 1) launch_m<T, 1>(g, e, s);
  else if (g.M <= 4) launch_m<T, 4>(g, e, s);
  else launch_m<T, 8>(g, e, s);
}

}  // namespace gv

// ------------------------------------------------------- CUDA-core tiles
// f32 and int8 operands at M > 8 that sgemm and imma do not take: a 64x64 block
// tile, K steps of 16, each thread a 4x4 register tile on a strided layout
// (conflict-free shared reads).
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
// bf16 at M > 8 that wgmma does not take (rows not 16-byte aligned, a
// broadcast A): tensor cores through WMMA 16x16x16 (f32 accumulate).
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

// ------------------------------------------------------ bf16 wgmma + TMA
// bf16 at M > 8 with A K-contiguous and B N- or K-contiguous (rows and
// bases 16-byte aligned): a 128x128 block tile (128x64 where 128x128 tiles
// would fill at most half the SMs: gemma2 kv at M=512 is 64 such tiles, q
// at M <= 128 is 32), K steps of 64, a ring of STAGES
// stages in shared memory loaded by TMA with 128-byte swizzle under
// mbarriers. One producer warp keeps the loads in flight; two consumer
// warpgroups each run wgmma m64n128k16 (bf16 -> f32) on 64 rows of the
// tile, keeping one group of products in flight while the next stage is
// waited for. A is K-major for wgmma. B (K, N) N-contiguous (KB false) is
// MN-major, loaded as BN / 64 boxes of 64 columns and read through the
// descriptor's transpose bit; B K-contiguous (KB true: a transposed view,
// the unembed's table.T) is K-major like A, one box of BN rows of 64
// elements a stage, read with the same descriptor as A. TMA zero-fills
// past the ragged M, N and K edges (N is B's outer dimension when KB, so
// an odd vocab needs no padding) and the epilogue masks its stores, so no
// operand is padded or copied.
namespace wg {

constexpr int BM = 128, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                      // warpgroups of 64 rows
constexpr int THREADS = CONSUMERS * 128 + 32;     // + the producer warp
constexpr int A_BYTES = BM * BK * 2;              // 16 KB: 128 rows of 128 B
constexpr int B_ATOM = BK * 64 * 2;               // 8 KB: 64 rows of 64 columns
// Per block tile width BN (128, or 64 where 128-wide tiles leave SMs idle):
template <int BN> __host__ __device__ constexpr int stage_bytes() { return A_BYTES + BK * BN * 2; }
template <int BN> __host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<BN>() + 2 * STAGES * 8 + 1024;   // + barriers, alignment
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

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
// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across a wait.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64x128 f32, per warpgroup) += A (64x16, K-major) * B (16x128; TB 1:
// MN-major, read through the transpose bit; TB 0: K-major)
template <int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

// d (64x64 f32, per warpgroup) += A (64x16, K-major) * B (16x64, as above)
template <int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128k16<TB>(d, da, db);
  else wgmma_m64n64k16<TB>(d, da, db);
}

template <int BN, bool KB>
__global__ void __launch_bounds__(THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, int M, int N, int K,
                  Epi e) {
  constexpr int STAGE_BYTES = stage_bytes<BN>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle atoms
  const uint32_t bars = base + STAGES * STAGE_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + BK - 1) / BK;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS * 4);        // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {                    // producer
    if (lane == 0) {
      for (int kt = 0; kt < KT; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty(s), ((kt / STAGES) & 1) ^ 1);
        const uint32_t a_dst = base + s * STAGE_BYTES, b_dst = a_dst + A_BYTES;
        mbar_expect_tx(full(s), STAGE_BYTES);
        tma_load_2d(a_dst, &ta, full(s), kt * BK, m0);
        if constexpr (KB) {
          tma_load_2d(b_dst, &tb, full(s), kt * BK, n0);
        } else {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(b_dst + c * B_ATOM, &tb, full(s), n0 + 64 * c, kt * BK);
        }
      }
    }
    return;
  }

  const int wgi = warp / 4;                       // consumer warpgroup
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < KT; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    // A: this warpgroup's 64 rows of 128 B; 8-row atoms 1024 B apart, k16
    // steps 32 B into the swizzled row. B N-contiguous: 8-row (K) atoms
    // 1024 B apart, 64-column blocks 8 KB apart, k16 steps 2 KB; B
    // K-contiguous: BN rows of 128 B, as A.
    const uint32_t a_s = base + s * STAGE_BYTES + wgi * (64 * 128);
    const uint32_t b_s = base + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_tile<BN, KB ? 0 : 1>(acc, desc_sw128(a_s + kk * 32, 16, 1024),
                                 KB ? desc_sw128(b_s + kk * 32, 16, 1024)
                                    : desc_sw128(b_s + kk * 2048, B_ATOM, 1024));
    wgmma_commit();
    wgmma_wait<1>();                              // stage kt-1 is read
    if (kt > 0 && lane == 0) mbar_arrive(empty((kt - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator layout: warp w of the group holds rows 16w .. 16w+15; for
  // each 8-column tile j, acc[4j], acc[4j+1] at (row lane/4, cols
  // 8j + 2(lane%4) + 0, 1) and acc[4j+2], acc[4j+3] 8 rows below.
  const int row0 = m0 + wgi * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = row0 + 8 * i;
      if (m < M) epilogue_pair(e, m, n, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), fetched through the
// runtime so the library needs no -lcuda.
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

// A 2-D bf16 tensor map: `outer` rows of `inner` elements, rows `row_bytes`
// apart, boxes of box_inner x box_outer, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, ll inner, ll outer,
              ll row_bytes, uint32_t box_inner, uint32_t box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Per device, once: its SM count, and the dynamic shared memory each
// instantiation needs (a function attribute). A call then only encodes
// its two tensor maps.
constexpr int MAX_DEVICES = 64;

template <int BN, bool KB>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(gemm_wgmma_kernel<BN, KB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<BN>());
}

int device_sms(int* sms) {
  static int cached[MAX_DEVICES] = {};    // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = allow_smem<128, false>();
    if (err == cudaSuccess) err = allow_smem<64, false>();
    if (err == cudaSuccess) err = allow_smem<128, true>();
    if (err == cudaSuccess) err = allow_smem<64, true>();
    if (err != cudaSuccess) return (int)err;
    cached[dev] = n;
  }
  *sms = cached[dev];
  return 0;
}

template <int BN, bool KB>
void launch_bn(const CUtensorMap& ta, const CUtensorMap& tb, int M, int N,
               int K, const Epi& e, cudaStream_t s) {
  // M tiles vary fastest: the blocks that share a strip of B run together
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  gemm_wgmma_kernel<BN, KB><<<grid, THREADS, smem_bytes<BN>(), s>>>(ta, tb, M, N, K, e);
}

// kb: B is K-contiguous (rows of K elements, sbn apart), else N-contiguous
// (rows of N elements, sbk apart).
int launch(const bf16* a, ll sam, const bf16* b, ll sbk, ll sbn, bool kb, int M,
           int N, int K, const Epi& e, cudaStream_t s) {
  int sms = 0;
  const int err = device_sms(&sms);
  if (err) return err;
  // 64-wide tiles (twice the blocks) only where 128-wide ones would fill at
  // most half the SMs; with more tiles than that, the narrower tile's
  // extra reads of A cost more than the idle SMs (on the H100, gemma2 down
  // at M=512, 112 tiles, took half as long again at 64 wide)
  const ll tiles = (ll)((M + BM - 1) / BM) * ((N + 127) / 128);
  const int bn = 2 * tiles > sms ? 128 : 64;
  CUtensorMap ta, tb;
  if (!make_map(&ta, a, K, M, sam * 2, BK, BM) ||
      !(kb ? make_map(&tb, b, K, N, sbn * 2, BK, bn)
           : make_map(&tb, b, N, K, sbk * 2, 64, BK)))
    return (int)cudaErrorInvalidValue;
  if (bn == 128) {
    if (kb) launch_bn<128, true>(ta, tb, M, N, K, e, s);
    else launch_bn<128, false>(ta, tb, M, N, K, e, s);
  } else {
    if (kb) launch_bn<64, true>(ta, tb, M, N, K, e, s);
    else launch_bn<64, false>(ta, tb, M, N, K, e, s);
  }
  return 0;
}

}  // namespace wg

using gv::aligned;

// ------------------------------------------------------- int8 imma (mma.sync)
// int8 at M > 8, A K-contiguous with 16-byte rows, B N- or K-contiguous
// with 16-byte rows: a 64x64 block tile (M = 512, N = 1024 is 128 blocks on
// 132 SMs), K steps of 64 bytes, a ring of STAGES stages in shared memory
// filled by 16-byte cp.async (zero-filled past the ragged M, N and K
// edges), four warps of 32x32, each eight mma.sync m16n8k32 (s8 x s8 ->
// s32) a 32-deep step. A's fragments come from ldmatrix. B N-contiguous
// (NB true, a weight) is staged as it lies, rows of K, and its fragments
// are transposed as they load: ldmatrix.trans gives lane (g, t) 16-bit
// pairs of columns (2g, 2g + 1) from two rows of K, its row addresses
// ordered so that four matrices give rows 4t..4t+3 and 16 + 4t..4t+3, and
// prmt parts each pair of results into the fragments of column 2g and of
// column 2g + 1 (two n8 tiles, even and odd columns of a 16-column
// group). B K-contiguous is staged in rows of N and loads as A does. Rows
// of 64 bytes are swizzled by 16-byte chunks so that each ldmatrix reads
// eight distinct bank groups. The tile's int32 sums meet in shared memory
// and the epilogue writes 32 consecutive columns a warp. The sums are
// exact in any order: the output is the fma kernel's, bit for bit.
namespace im {

constexpr int BM = 64, BN = 64, BK = 64, STAGES = 4;
constexpr int THREADS = 128;                     // 2 x 2 warps of 32 x 32
constexpr int A_TILE = BM * BK, B_TILE = BN * BK;

// Byte offset of 16-byte chunk c of row r in a tile of 64-byte rows: A and a
// K-contiguous B (rows of M or N, ldmatrix reads 8 consecutive rows), and an
// N-contiguous B (rows of K, ldmatrix.trans reads rows r, r + 1, r + 4, r + 5
// ... of one 16-row group).
__device__ __forceinline__ int sw_rows(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }
__device__ __forceinline__ int sw_k(int r, int c) { return r * 64 + ((c ^ ((r >> 2) & 3)) << 4); }

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes of a 16-byte chunk that lie inside a row of `len` elements from `at`.
__device__ __forceinline__ int in_row(int at, int len) {
  return at >= len ? 0 : (len - at >= 16 ? 16 : len - at);
}

template <bool NB>
__global__ void __launch_bounds__(THREADS)
gemm_imma_kernel(const int8_t* __restrict__ a, ll sam, const int8_t* __restrict__ b,
                 ll sb, int M, int N, int K, Epi e) {
  // sb: B's row stride, along K (NB) or along N
  __shared__ __align__(128) int8_t As[STAGES][A_TILE];
  __shared__ __align__(128) int8_t Bs[STAGES][B_TILE];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int KT = (K + BK - 1) / BK;

  // each thread copies two 16-byte chunks of A and two of B a stage
  auto load = [&](int st, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = tid + i * THREADS, r = q / 4, c = q % 4;
      const int m = m0 + r, n = n0 + r;
      const int ab = m < M ? in_row(k0 + c * 16, K) : 0;
      cp16(wg::smem_u32(&As[st][sw_rows(r, c)]), ab ? a + (ll)m * sam + k0 + c * 16 : a, ab);
      if constexpr (NB) {                          // r: a row of K, c: 16 columns
        const int bb = k0 + r < K ? in_row(n0 + c * 16, N) : 0;
        cp16(wg::smem_u32(&Bs[st][sw_k(r, c)]), bb ? b + (ll)(k0 + r) * sb + n0 + c * 16 : b, bb);
      } else {                                     // r: a row of N (column of B)
        const int bb = n < N ? in_row(k0 + c * 16, K) : 0;
        cp16(wg::smem_u32(&Bs[st][sw_rows(r, c)]), bb ? b + (ll)n * sb + k0 + c * 16 : b, bb);
      }
    }
  };

  int acc[2][2][2][4];                             // [m16][n16 group][n8 tile][frag]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[i][j][q][x] = 0;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load(st, st);
    cp_commit();
  }
  // ldmatrix: lane l gives the address of row l % 8 of matrix l / 8
  const int li = lane % 8, lj = lane / 8;
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();                               // stage kt is in; kt - 1 is read
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();
    const int8_t* as = As[kt % STAGES];
    const int8_t* bs = Bs[kt % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)                  // matrices: rows +0/+8, k +0/+16
        ldsm_x4(af[i], wg::smem_u32(as + sw_rows(wm * 32 + i * 16 + (lj & 1) * 8 + li,
                                                 kk / 16 + (lj >> 1))));
      uint32_t bf[2][2][2];                        // [n16 group][n8 tile][k half]
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        if constexpr (NB) {
          // matrix lj: rows kk + 16 (lj >> 1) + {0,1,4,5,8,9,12,13} + 2 (lj & 1)
          const int kr = kk + (lj >> 1) * 16 + (li >> 1) * 4 + (li & 1) + (lj & 1) * 2;
          ldsm_x4_t(r, wg::smem_u32(bs + sw_k(kr, wn * 2 + j)));
          bf[j][0][0] = prmt(r[0], r[1], 0x6420);  // column 2g, k 4t..4t+3
          bf[j][1][0] = prmt(r[0], r[1], 0x7531);  // column 2g + 1
          bf[j][0][1] = prmt(r[2], r[3], 0x6420);  // the same, k 16 + 4t..
          bf[j][1][1] = prmt(r[2], r[3], 0x7531);
        } else {
          // matrices: columns +0 (k +0, +16), +8 (k +0, +16)
          ldsm_x4(r, wg::smem_u32(bs + sw_rows(wn * 32 + j * 16 + (lj >> 1) * 8 + li,
                                               kk / 16 + (lj & 1))));
          bf[j][0][0] = r[0];
          bf[j][0][1] = r[1];
          bf[j][1][0] = r[2];
          bf[j][1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 2; ++q) mma_s8(acc[i][j][q], af[i], bf[j][q][0], bf[j][q][1]);
    }
  }
  cp_wait<0>();
  __syncthreads();                                 // the ring is no longer read

  // The tile's sums meet in shared memory (A's ring: 64 x 64 int32), then
  // each thread applies the epilogue to every 128th of them, a warp to 32
  // consecutive columns. Fragment (i, j, q) holds rows g, g + 8 of its m16
  // tile at its columns 2t, 2t + 1; column x of n8 tile q of a 16-column
  // group is 8q + x (K-contiguous B) or 2x + q (N-contiguous B: even and
  // odd columns).
  int* sums = reinterpret_cast<int*>(&As[0][0]);
  static_assert(BM * BN * sizeof(int) <= sizeof(As), "the tile's sums fit A's ring");
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = wm * 32 + i * 16 + g + (x >> 1) * 8;
          const int col = 2 * t + (x & 1), c0 = wn * 32 + j * 16;
          sums[r * BN + (NB ? c0 + 2 * col + q : c0 + 8 * q + col)] = acc[i][j][q][x];
        }
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m < M && n < N) epilogue(e, m, n, sums[i]);
  }
}

// nb: B is N-contiguous (rows of N, sbk apart), else K-contiguous (rows of
// K, sbn apart).
void launch(const int8_t* a, ll sam, const int8_t* b, ll sbk, ll sbn, bool nb, int M,
            int N, int K, const Epi& e, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (nb) gemm_imma_kernel<true><<<grid, THREADS, 0, s>>>(a, sam, b, sbk, M, N, K, e);
  else gemm_imma_kernel<false><<<grid, THREADS, 0, s>>>(a, sam, b, sbn, M, N, K, e);
}

}  // namespace im

// ----------------------------------------------------- f32 SIMT (sgemm)
// f32 at M > 8, A K-contiguous with 16-byte rows, B N- or K-contiguous
// with 16-byte rows (mma_layout with 4-byte elements). True f32 FMA on the
// CUDA cores (67 TFLOP/s): tensor cores would mean TF32. A 128x128 block
// tile (128x64 where 128-wide tiles would fill at most half the SMs), K
// steps of 16, a ring of STAGES stages in dynamic shared memory filled by
// 16-byte cp.async (zero-filled past the ragged M, N and K edges), so that
// the next tiles load while this one is multiplied. 256 threads, 4 x 2
// warps of 32 rows x BN/2 columns, each lane 8 rows x BN/16 columns of
// register sums (64 at BN = 128; with B N-contiguous at most 128
// registers a thread, so that two blocks share an SM). A is staged as it
// lies (rows of K, 80
// bytes apart: the 4 rows a warp reads at once fall in distinct bank
// groups) and read 4 k at a time as float4, the 8 lanes of a row sharing
// each read; B N-contiguous is staged in rows of K and read as float4 along
// N (8 lanes, 128 contiguous bytes), B K-contiguous (a transposed view)
// like A, in rows of N. Each k-quad a lane makes 16 float4 reads for 256
// FMAs (BN = 128): 4 FMAs a shared float. With B K-contiguous a lane's
// columns are 8 apart, so the tile's sums leave through shared memory, a
// row of the output in one contiguous run. M tiles vary fastest, so the
// blocks that share a strip of B run together.
namespace sg {

constexpr int BM = 128, BK = 16, STAGES = 4, THREADS = 256;
constexpr int LD = BK + 4;                         // a staged row of K: 80 bytes

template <int BN, bool NB> struct Ring {
  static constexpr int A = BM * LD;                // floats of A a stage
  static constexpr int B = NB ? BK * BN : BN * LD; // of B
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = STAGES * STAGE * 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Bytes of a 16-byte chunk that lie inside a row of `len` floats from `at`.
__device__ __forceinline__ int in_row(int at, int len) {
  return at >= len ? 0 : (len - at >= 4 ? 16 : 4 * (len - at));
}

template <int BN, bool NB>
__global__ void __launch_bounds__(THREADS, NB ? 2 : 1)
sgemm_kernel(const float* __restrict__ a, ll sam, const float* __restrict__ b, ll sb,
             int M, int N, int K, Epi e) {
  // sb: B's row stride, along K (NB) or along N
  using R = Ring<BN, NB>;
  constexpr int TN = BN / 16, WN = BN / 2;         // columns a lane, a warp
  constexpr int BCH = NB ? BK * BN / 4 : BN * BK / 4;   // B's 16-byte chunks a stage
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2, ty = lane / 8, tx = lane % 8;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int KT = (K + BK - 1) / BK;

  auto load = [&](int st, int kt) {
    float* as = smem + st * R::STAGE;
    float* bs = as + R::A;
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < BM * BK / 4 / THREADS; ++i) {   // A: rows of M, 4 chunks
      const int q = tid + i * THREADS, r = q / 4, c = q % 4, m = m0 + r;
      const int ab = m < M ? in_row(k0 + c * 4, K) : 0;
      im::cp16(smem_u32(as + r * LD + c * 4), ab ? a + (ll)m * sam + k0 + c * 4 : a, ab);
    }
#pragma unroll
    for (int i = 0; i < BCH / THREADS; ++i) {
      const int q = tid + i * THREADS;
      if constexpr (NB) {                          // rows of K, BN / 4 chunks
        const int r = q / (BN / 4), c = q % (BN / 4);
        const int bb = k0 + r < K ? in_row(n0 + c * 4, N) : 0;
        im::cp16(smem_u32(bs + r * BN + c * 4), bb ? b + (ll)(k0 + r) * sb + n0 + c * 4 : b,
                 bb);
      } else {                                     // rows of N, 4 chunks
        const int r = q / 4, c = q % 4, n = n0 + r;
        const int bb = n < N ? in_row(k0 + c * 4, K) : 0;
        im::cp16(smem_u32(bs + r * LD + c * 4), bb ? b + (ll)n * sb + k0 + c * 4 : b, bb);
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) load(st, st);
    im::cp_commit();
  }
  const int arow = (wm * 32 + ty) * LD;            // the lane's first row of A
  const int bcol = NB ? wn * WN + tx * 4 : (wn * WN + tx) * LD;
  for (int kt = 0; kt < KT; ++kt) {
    im::cp_wait<STAGES - 2>();
    __syncthreads();                               // stage kt is in; kt - 1 is read
    if (kt + STAGES - 1 < KT) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    im::cp_commit();
    const float* as = smem + (kt % STAGES) * R::STAGE + arow;
    const float* bs = smem + (kt % STAGES) * R::STAGE + R::A + bcol;
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)                  // rows ty + 4 i of the warp's 32
        av[i] = *reinterpret_cast<const float4*>(as + 4 * i * LD + kq * 4);
      if constexpr (NB) {
        float4 bv[4][TN / 4];                      // 4 k x columns tx*4 + 32 j + 0..3
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < TN / 4; ++j)
            bv[kk][j] = *reinterpret_cast<const float4*>(bs + (kq * 4 + kk) * BN + 32 * j);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
            for (int j = 0; j < TN / 4; ++j) {
              acc[i][4 * j] = fmaf(x, bv[kk][j].x, acc[i][4 * j]);
              acc[i][4 * j + 1] = fmaf(x, bv[kk][j].y, acc[i][4 * j + 1]);
              acc[i][4 * j + 2] = fmaf(x, bv[kk][j].z, acc[i][4 * j + 2]);
              acc[i][4 * j + 3] = fmaf(x, bv[kk][j].w, acc[i][4 * j + 3]);
            }
          }
      } else {
        float4 bv[TN];                             // columns tx + 8 j, 4 k each
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + 8 * j * LD + kq * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            float s = acc[i][j];
            s = fmaf(av[i].x, bv[j].x, s);
            s = fmaf(av[i].y, bv[j].y, s);
            s = fmaf(av[i].z, bv[j].z, s);
            acc[i][j] = fmaf(av[i].w, bv[j].w, s);
          }
      }
    }
  }
  im::cp_wait<0>();
  if constexpr (NB) {
    // columns tx*4 + 32 (j / 4) + j % 4: pairs straight from the registers
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + wm * 32 + ty + 4 * i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; j += 2)
        epilogue_pair(e, m, n0 + wn * WN + tx * 4 + 32 * (j / 4) + j % 4, acc[i][j],
                      acc[i][j + 1]);
    }
  } else {
    // columns tx + 8 j: the tile's sums meet in shared memory (the ring:
    // BM rows of BN + 4), then a row's BN / 2 column pairs go to
    // consecutive threads, each output row in one contiguous run
    constexpr int LS = BN + 4;
    static_assert(BM * LS <= STAGES * R::STAGE, "the tile's sums fit the ring");
    float* sums = smem;
    __syncthreads();                               // the ring is no longer read
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        sums[(wm * 32 + ty + 4 * i) * LS + wn * WN + tx + 8 * j] = acc[i][j];
    __syncthreads();
    for (int i = tid; i < BM * BN / 2; i += THREADS) {
      const int r = i / (BN / 2), c = 2 * (i % (BN / 2)), m = m0 + r;
      if (m < M) epilogue_pair(e, m, n0 + c, sums[r * LS + c], sums[r * LS + c + 1]);
    }
  }
}

template <int BN, bool NB>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(sgemm_kernel<BN, NB>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Ring<BN, NB>::BYTES);
}

// Per device, once: its SM count, and the dynamic shared memory of each
// instantiation.
int setup(int* sms) {
  static int cached[wg::MAX_DEVICES] = {};         // 0: not set up yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= wg::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = allow_smem<128, true>();
    if (err == cudaSuccess) err = allow_smem<128, false>();
    if (err == cudaSuccess) err = allow_smem<64, true>();
    if (err == cudaSuccess) err = allow_smem<64, false>();
    if (err != cudaSuccess) return (int)err;
    cached[dev] = n;
  }
  *sms = cached[dev];
  return 0;
}

template <int BN, bool NB>
void launch_bn(const float* a, ll sam, const float* b, ll sb, int M, int N, int K,
               const Epi& e, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  sgemm_kernel<BN, NB><<<grid, THREADS, Ring<BN, NB>::BYTES, s>>>(a, sam, b, sb, M, N, K, e);
}

// nb: B is N-contiguous (rows of N, sbk apart), else K-contiguous (rows of
// K, sbn apart).
int launch(const float* a, ll sam, const float* b, ll sbk, ll sbn, bool nb, int M,
           int N, int K, const Epi& e, cudaStream_t s) {
  int sms = 0;
  const int err = setup(&sms);
  if (err) return err;
  const ll tiles = (ll)((M + BM - 1) / BM) * ((N + 127) / 128);
  if (2 * tiles > sms) {
    if (nb) launch_bn<128, true>(a, sam, b, sbk, M, N, K, e, s);
    else launch_bn<128, false>(a, sam, b, sbn, M, N, K, e, s);
  } else {
    if (nb) launch_bn<64, true>(a, sam, b, sbk, M, N, K, e, s);
    else launch_bn<64, false>(a, sam, b, sbn, M, N, K, e, s);
  }
  return 0;
}

}  // namespace sg

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

enum Variant { GEMV = 0, WGMMA = 1, WMMA = 2, FMA = 3, IMMA = 4, SGEMM = 5 };

// A 2-D operand whose rows a tensor map or 16-byte copies can tile: inner
// stride 1, rows a multiple of 16 bytes apart and no shorter than `inner`
// elements, base 16-byte aligned (_rows16 in kernel.py).
bool rows16(const void* p, ll rows, ll cols, ll inner, int elem) {
  return cols == 1 && (rows * elem) % 16 == 0 && rows >= inner && aligned(p, 16);
}

// B's layout for wgmma (bf16), imma (int8) and sgemm (f32) at M > 8, A's rows tiled
// (gemm_variant in kernel.py mirrors it): 1 N-contiguous, 2 K-contiguous,
// 0 neither (the variant is refused).
int mma_layout(const void* a, ll sam, ll sak, const void* b, ll sbk, ll sbn,
               int M, int N, int K, int elem) {
  if (M <= 8 || !rows16(a, sam, sak, K, elem)) return 0;
  if (rows16(b, sbk, sbn, N, elem)) return 1;
  if (rows16(b, sbn, sbk, K, elem)) return 2;
  return 0;
}

}  // namespace

// Type codes: 0 f32, 1 bf16, 2 int8, 3 int32. Variant: 0 gemv (M <= 8), 1
// wgmma (bf16, M > 8, mma_layout), 2 wmma (bf16, M > 8), 3 fma (f32 or
// int8, M > 8), 4 imma (int8, M > 8, mma_layout), 5 sgemm (f32, M > 8,
// mma_layout); a variant that cannot take the operands returns
// cudaErrorInvalidValue. c may be null
// (no epilogue term). d is (M, N) contiguous. gemv only: K is split into
// `splits` runs of `chunk` rows (gemv_plan in kernel.py); with splits > 1,
// ws holds splits * M * N partial sums (f32, int32 for int8) and tickets
// one zeroed counter per 32 columns of N, left zeroed again; launches that
// may overlap must not share them (kernel.py keeps a set per stream). A
// plan the kernels cannot take is refused. Returns cudaGetLastError() after the
// launch.
extern "C" int gemm_launch(const void* a, ll sam, ll sak, const void* b,
                           ll sbk, ll sbn, const void* c, ll scm, ll scn,
                           int c_code, void* d, int out_code, int M, int N,
                           int K, int in_code, float alpha, float beta,
                           int variant, int splits, int chunk, void* ws,
                           unsigned* tickets, void* stream) {
  const Epi e{c, scm, scn, c_code, d, out_code, N, alpha, beta, c != nullptr};
  const gv::Args g{a, sam, sak, b, sbk, sbn, M, N, K, splits, chunk, ws, tickets, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (in_code != F32 && in_code != BF16 && in_code != I8) return (int)cudaErrorInvalidValue;
  bool ok;
  const int elem = in_code == I8 ? 1 : in_code == BF16 ? 2 : 4;
  const int layout = mma_layout(a, sam, sak, b, sbk, sbn, M, N, K, elem);
  switch (variant) {
    case GEMV: ok = M <= 8 && gv::plan_ok(g); break;
    case WGMMA: ok = in_code == BF16 && layout != 0; break;
    case WMMA: ok = in_code == BF16 && M > 8; break;
    case FMA: ok = in_code != BF16 && M > 8; break;
    case IMMA: ok = in_code == I8 && layout != 0; break;
    case SGEMM: ok = in_code == F32 && layout != 0; break;
    default: ok = false;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0) return (int)cudaGetLastError();
  int err = 0;
  switch (variant) {
    case GEMV:
      if (in_code == F32) gv::launch<float>(g, e, s);
      else if (in_code == BF16) gv::launch<bf16>(g, e, s);
      else gv::launch<int8_t>(g, e, s);
      break;
    case WGMMA:
      err = wg::launch((const bf16*)a, sam, (const bf16*)b, sbk, sbn, layout == 2, M, N, K,
                       e, s);
      break;
    case WMMA:
      launch_wmma((const bf16*)a, sam, sak, (const bf16*)b, sbk, sbn, M, N, K, e, s);
      break;
    case IMMA:
      im::launch((const int8_t*)a, sam, (const int8_t*)b, sbk, sbn, layout == 1, M, N, K, e, s);
      break;
    case SGEMM:
      err = sg::launch((const float*)a, sam, (const float*)b, sbk, sbn, layout == 1, M, N, K,
                       e, s);
      break;
    default:
      if (in_code == F32) launch_fma((const float*)a, sam, sak, (const float*)b, sbk, sbn, M, N, K, e, s);
      else launch_fma((const int8_t*)a, sam, sak, (const int8_t*)b, sbk, sbn, M, N, K, e, s);
  }
  if (err) return err;
  return (int)cudaGetLastError();
}
