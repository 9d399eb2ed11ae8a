// Batched block GEMM for Hopper (sm_90a): C[t] = A[t] · B[t], f32 and bf16.
//
// Replaces the Pallas TPU kernel `block_gemm` (src/repro/kernels/block_gemm/
// block_gemm.py:40, body `_gemm_kernel` at :24), which the block executor
// reaches through `task_matmul` (ops.py:33) as the body of the GEMM update
// and of Cholesky's syrk and gemm trailing updates. There, vmap folds a
// wavefront's tasks into a leading grid dimension; here the batch is the
// grid's z dimension, so one launch covers all of a wavefront's tasks of
// one type.
//
// What it computes: C[t][m][n] = sum_k A[t][m][k] * B[t][k][n], accumulated
// in f32 in a fixed order over k, and written contiguous [T, M, N] in A's
// type. A and B come with their own (batch, row, column) strides, so the
// `l.mT` / `lj.mT` views of the Cholesky bodies need no transpose copy.
// Ragged edges are masked, so every M, N and K works (b = 4..16 in the
// tests, 512 and 1024 on the main path).
//
// What bounds it on this card (H100 SXM): at b = 512 one task is
// 2·b³ = 268 MFLOP over 3·b²·4 = 3 MiB, 85 FLOP per byte, far above the
// f32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 FLOP per byte: the f32 FMA
// rate of the CUDA cores bounds it. f32 must stay IEEE f32 (TF32 on the
// tensor cores keeps ~3 decimal digits and cannot meet the 2e-5 tolerance
// of the reference), so the tensor cores are out for f32. The tiny test
// blocks (b <= 16) have b/6 FLOP per byte: bytes, and in practice launch
// latency, bound them.
//
// What the design does about it: each block of 256 threads owns a
// BM x BN tile of one task's C (128 x 128, or 64 x 64 when M or N is
// smaller than 128) and walks K in steps of 8 through double-buffered
// shared-memory tiles of A and B (the loop inside the block takes the place
// of the TPU's sequential K grid axis, and registers hold the f32
// accumulator that the TPU kept in VMEM). Each thread keeps an 8 x 8
// (4 x 4) register micro-tile, so every shared-memory value read feeds 8
// (4) FMAs; A's rows are read as float4 broadcasts, B's columns at
// conflict-free unit stride, and both tiles are padded so the stores of
// either operand layout are conflict-free. Global reads let neighbouring
// threads walk the operand's unit-stride dimension, whichever it is, so
// A, A.mT, B and B.mT all load coalesced. No split-K and no atomics: a
// task's result does not depend on the batch it rides in, bit for bit.
// wgmma, TMA and a bf16 tensor-core path are left for later work.
//
// C entry points: block_gemm_f32 / block_gemm_bf16 launch on the given
// stream and return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int BK = 8;         // depth of one K step in shared memory
constexpr int PAD = 4;        // keeps shared stores conflict-free, rows 16 B aligned

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element e of an R x C operand tile, in the operand's own (row, col) index
// space. With `col_fast` neighbouring threads take neighbouring columns,
// else neighbouring rows: the caller picks whichever has unit stride.
template <int R, int C>
__device__ __forceinline__ void tile_coord(int e, bool col_fast, int& r,
                                           int& c) {
  if (col_fast) {
    r = e / C;
    c = e % C;
  } else {
    r = e % R;
    c = e / R;
  }
}

// Registers holding one thread's share of an R x C tile, read from global
// memory through strides (sr, sc) with everything outside rows x cols
// masked to zero.
template <typename T, int R, int C>
struct Tile {
  static constexpr int LOADS = R * C / THREADS;
  float v[LOADS];

  __device__ __forceinline__ void load(const T* __restrict__ p, long long sr,
                                       long long sc, int r0, int c0, int rows,
                                       int cols, bool col_fast) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      int r, c;
      tile_coord<R, C>(threadIdx.x + i * THREADS, col_fast, r, c);
      const int gr = r0 + r, gc = c0 + c;
      v[i] = (gr < rows && gc < cols) ? to_float(p[gr * sr + gc * sc]) : 0.f;
    }
  }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
    block_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      T* __restrict__ C, int batch, int M, int N, int K,
                      long long sab, long long sam, long long sak,
                      long long sbb, long long sbk, long long sbn) {
  constexpr int TM = BM / 16, TN = BN / 16;
  static_assert(TM % 4 == 0, "A rows are read as float4");
  // As[k][m]: A's tile stored k-major, so a thread's TM rows are contiguous
  // Bs[k][n]: B's tile as it is
  __shared__ __align__(16) float As[2][BK][BM + PAD];
  __shared__ __align__(16) float Bs[2][BK][BN + PAD];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_k_fast = (sak == 1);
  const bool b_n_fast = (sbn == 1);

  for (int t = blockIdx.z; t < batch; t += gridDim.z) {
    const T* a = A + t * sab;
    const T* b = B + t * sbb;
    Tile<T, BM, BK> ta;
    Tile<T, BK, BN> tb;

    auto stage = [&](int buf) {
#pragma unroll
      for (int i = 0; i < Tile<T, BM, BK>::LOADS; ++i) {
        int r, c;
        tile_coord<BM, BK>(threadIdx.x + i * THREADS, a_k_fast, r, c);
        As[buf][c][r] = ta.v[i];
      }
#pragma unroll
      for (int i = 0; i < Tile<T, BK, BN>::LOADS; ++i) {
        int r, c;
        tile_coord<BK, BN>(threadIdx.x + i * THREADS, b_n_fast, r, c);
        Bs[buf][r][c] = tb.v[i];
      }
    };

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    ta.load(a, sam, sak, m0, 0, M, K, a_k_fast);
    tb.load(b, sbk, sbn, 0, n0, K, N, b_n_fast);
    stage(0);
    __syncthreads();

    int buf = 0;
    for (int k0 = 0; k0 < K; k0 += BK) {
      const bool more = k0 + BK < K;
      if (more) {  // the next K step's loads are in flight during this one
        ta.load(a, sam, sak, m0, k0 + BK, M, K, a_k_fast);
        tb.load(b, sbk, sbn, k0 + BK, n0, K, N, b_n_fast);
      }
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float ra[TM], rb[TN];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(&As[buf][kk][ty * TM + i]);
          ra[i] = x.x;
          ra[i + 1] = x.y;
          ra[i + 2] = x.z;
          ra[i + 3] = x.w;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) rb[j] = Bs[buf][kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(ra[i], rb[j], acc[i][j]);
      }
      if (more) stage(buf ^ 1);  // buf ^ 1 was last read before the sync below
      __syncthreads();
      buf ^= 1;
    }

    T* c = C + (long long)t * M * N;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = m0 + ty * TM + i;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col < N) store_as(&c[(long long)row * N + col], acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int batch, int m, int n,
           int k, long long sab, long long sam, long long sak, long long sbb,
           long long sbk, long long sbn, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int z = batch < 65535 ? batch : 65535;  // the kernel loops past it
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (m >= 128 && n >= 128) {
    const dim3 grid((n + 127) / 128, (m + 127) / 128, z);
    block_gemm_kernel<T, 128, 128><<<grid, THREADS, 0, s>>>(
        pa, pb, pc, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn);
  } else {
    const dim3 grid((n + 63) / 64, (m + 63) / 64, z);
    block_gemm_kernel<T, 64, 64><<<grid, THREADS, 0, s>>>(
        pa, pb, pc, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int block_gemm_f32(const void* a, const void* b, void* c,
                              int batch, int m, int n, int k, long long sab,
                              long long sam, long long sak, long long sbb,
                              long long sbk, long long sbn, void* stream) {
  return launch<float>(a, b, c, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn,
                       stream);
}

extern "C" int block_gemm_bf16(const void* a, const void* b, void* c,
                               int batch, int m, int n, int k, long long sab,
                               long long sam, long long sak, long long sbb,
                               long long sbk, long long sbn, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, batch, m, n, k, sab, sam, sak, sbb,
                               sbk, sbn, stream);
}
