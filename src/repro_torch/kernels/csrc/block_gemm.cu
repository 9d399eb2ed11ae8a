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
// in f32 in a fixed order over k (ascending), and written contiguous
// [T, M, N] in A's type. A and B come with their own (batch, row, column)
// strides, so the `l.mT` / `lj.mT` views of the Cholesky bodies need no
// transpose copy. Ragged edges are masked, so every M, N and K works
// (b = 4..16 in the tests, 512 and 1024 on the main path).
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
// What the design does about it (f32, sgemm_ring): each block of 256
// threads owns a 128 x 128 tile of one task's C and walks K in steps of
// BK = 16 through a STAGES = 4 deep ring of shared-memory tiles that
// cp.async fills straight from device memory (no registers hold staged
// tiles; one barrier per K step). cp.async cannot transpose, so each
// operand's shared tile keeps the operand's own contiguous dimension, and
// the host picks one of four instantiations from the strides: A k- or
// m-contiguous, B n- or k-contiguous (Cholesky's `l @ l.mT` is (k, k), the
// row-major GEMM update (k, n)). Aligned operands are copied 16 bytes at a
// time; ragged or unaligned ones element by element (4-byte cp.async,
// zero-filled outside the matrix), through the same ring. The 8 warps
// split the tile 4 x 2 into 32 x 64 warp tiles and each thread keeps an
// 8 x 8 register tile; every shared read runs along the tile's contiguous
// dimension (float4s of 4 rows or columns; float2s of 2 k values of one
// row, which feed two rank-1 updates), and lanes share A rows and B
// columns (broadcasts). k-contiguous tiles are padded to 20 floats a row,
// so those reads are free of bank conflicts. __launch_bounds__(256, 2)
// keeps two blocks (16 warps) on an SM within 128 registers and no spills,
// so each group of KR k values is read and used before the next is read.
// No split-K and no atomics: a task's result does not depend on the batch
// it rides in, bit for bit.
//
// bf16 (off the main path) keeps the first design (block_gemm_staged):
// tiles staged through registers, one K step of 8 ahead, widened to f32 in
// shared memory; f32 arithmetic on the CUDA cores.
//
// C entry points: block_gemm_f32 / block_gemm_bf16 launch on the given
// stream and return cudaGetLastError() (0 on success); block_gemm_info
// reports the f32 instantiations' occupancy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid of threads (bf16 kernel)
constexpr int BK = 8;         // depth of one K step in shared memory (bf16)
constexpr int PAD = 4;        // keeps shared stores conflict-free, rows 16 B aligned

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
    block_gemm_staged(const T* __restrict__ A, const T* __restrict__ B,
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

int launch_staged(const void* a, const void* b, void* c, int batch, int m,
                  int n, int k, long long sab, long long sam, long long sak,
                  long long sbb, long long sbk, long long sbn, void* stream) {
  using T = __nv_bfloat16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int z = batch < 65535 ? batch : 65535;  // the kernel loops past it
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (m >= 128 && n >= 128) {
    const dim3 grid((n + 127) / 128, (m + 127) / 128, z);
    block_gemm_staged<T, 128, 128><<<grid, THREADS, 0, s>>>(
        pa, pb, pc, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn);
  } else {
    const dim3 grid((n + 63) / 64, (m + 63) / 64, z);
    block_gemm_staged<T, 64, 64><<<grid, THREADS, 0, s>>>(
        pa, pb, pc, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ f32: the pipelined SGEMM

namespace ring {

constexpr int THREADS = 256;      // 8 warps, 4 (m) x 2 (n) warp tiles
constexpr int BM = 128, BN = 128; // a block's tile of C
constexpr int BK = 16;            // depth of one K step
constexpr int STAGES = 4;         // K steps in the shared ring
constexpr int KP = BK + 4;        // padded row of a k-contiguous tile
constexpr int KR = 2;             // k values of one k-contiguous read
constexpr int TILE = BM * KP;     // floats of one operand in one stage
constexpr int SMEM = STAGES * 2 * TILE * 4;   // bytes
static_assert(BK * BM <= TILE && BK * BN <= TILE, "stage holds either layout");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, or zeros where !live (src-size
// 0: nothing read).
__device__ __forceinline__ void cp16(float* dst, const float* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

// KR = 2 consecutive floats of a k-contiguous row, in one shared read.
__device__ __forceinline__ void read_k(float* x, const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}

// Eight floats of a row in two reads, p[0..3] and p[GAP..GAP + 3]: A's rows
// 4 lm + i % 4 + 16 (i / 4) (GAP 16), B's columns 4 ln + j % 4 + 32 (j / 4)
// (GAP 32).
template <int GAP>
__device__ __forceinline__ void read8(float* x, const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + GAP);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = lo.z;
  x[3] = lo.w;
  x[4] = hi.x;
  x[5] = hi.y;
  x[6] = hi.z;
  x[7] = hi.w;
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One operand's R x BK tile at (r0, k0) of a rows x K matrix, element (r, k)
// at p[r * sr + k * sk], into `dst`: [R][KP] when KF (k-contiguous), else
// [BK][R]. vec: 16-byte copies along the contiguous dimension (its stride
// 1, its extent and the other strides multiples of 4, p 16-byte aligned).
template <bool KF, int R>
__device__ __forceinline__ void load_tile(float* dst, const float* p,
                                          long long sr, long long sk, int r0,
                                          int k0, int rows, int K, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int CHUNKS = R * BK / 4;
    static_assert(CHUNKS % THREADS == 0, "tile copy shape");
#pragma unroll
    for (int i = 0; i < CHUNKS / THREADS; ++i) {
      const int e = tid + THREADS * i;
      if (KF) {   // a row's BK / 4 chunks along k
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int gr = r0 + r, gk = k0 + c;
        const bool live = gr < rows && gk < K;
        cp16(dst + r * KP + c, live ? p + gr * sr + gk : p, live);
      } else {    // a k row's R / 4 chunks along r
        const int kk = e / (R / 4), c = (e % (R / 4)) * 4;
        const int gr = r0 + c, gk = k0 + kk;
        const bool live = gr < rows && gk < K;
        cp16(dst + kk * R + c, live ? p + gk * sk + gr : p, live);
      }
    }
  } else {
    static_assert(R * BK % THREADS == 0, "tile copy shape");
#pragma unroll 1   // ragged or unaligned only: no offsets held in registers
    for (int i = 0; i < R * BK / THREADS; ++i) {
      const int e = tid + THREADS * i;   // neighbours along the fast dim
      const int r = KF ? e / BK : e % R, kk = KF ? e % BK : e / R;
      const int gr = r0 + r, gk = k0 + kk;
      const bool live = gr < rows && gk < K;
      cp4(KF ? dst + r * KP + kk : dst + kk * R + r,
          live ? p + gr * sr + gk * sk : p, live);
    }
  }
}

}  // namespace ring

// AK: A's tile k-contiguous (As[m][k]), else m-contiguous (As[k][m]).
// BNF: B's tile n-contiguous (Bs[k][n]), else k-contiguous (Bs[n][k]).
// Warp w owns rows [32 (w / 2), +32) and columns [64 (w % 2), +64) of the
// block's tile; lane (lm, ln) = (lane / 8, lane % 8) owns 8 of the rows and
// 8 of the columns, chosen so its float4 reads run along the tile's
// contiguous dimension: rows lm + 4i (AK) or 4 lm + i % 4 + 16 (i / 4);
// columns 4 ln + j % 4 + 32 (j / 4) (BNF) or ln + 8j.
template <bool AK, bool BNF>
__global__ void __launch_bounds__(ring::THREADS, 2)
    sgemm_ring(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ C, int batch, int M, int N, int K,
               long long sab, long long sam, long long sak, long long sbb,
               long long sbk, long long sbn, int vec_a, int vec_b) {
  using ring::BK;
  using ring::BM;
  using ring::BN;
  using ring::KP;
  using ring::KR;
  using ring::STAGES;
  using ring::TILE;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lm = lane >> 3, ln = lane & 7;
  const int wm0 = (warp >> 1) * 32, wn0 = (warp & 1) * 64;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;

  for (int t = blockIdx.z; t < batch; t += gridDim.z) {
    const float* a = A + t * sab;
    const float* b = B + t * sbb;
    auto load = [&](int kt, int stage) {
      float* as = smem + stage * 2 * TILE;
      ring::load_tile<AK, BM>(as, a, sam, sak, m0, kt * BK, M, K, vec_a);
      ring::load_tile<!BNF, BN>(as + TILE, b, sbn, sbk, n0, kt * BK, N, K,
                                vec_b);
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_k) load(st, st);
      ring::commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      ring::wait<STAGES - 2>();   // this thread's copies of step kt landed
      __syncthreads();            // everyone's, and step kt - 1 is read
      {
        const int next = kt + STAGES - 1;   // into the stage kt - 1 held
        if (next < n_k) load(next, next % STAGES);
        ring::commit();
      }
      const float* as = smem + (kt % STAGES) * 2 * TILE;
      const float* bs = as + TILE;
#pragma unroll 1   // one group of KR k at a time: bounds live registers
      for (int kg = 0; kg < BK; kg += KR) {
        float af[8][KR];   // A[row i][kg + u]
        float bf[KR][8];   // B[kg + u][column j]
#pragma unroll
        for (int i = 0; i < 8; ++i)   // k-contiguous: KR values a read
          if (AK) ring::read_k(af[i], as + (wm0 + lm + 4 * i) * KP + kg);
#pragma unroll
        for (int u = 0; u < KR; ++u) {  // m-contiguous: 8 rows in 2 reads
          float x[8];
          if (!AK) {
            ring::read8<16>(x, as + (kg + u) * BM + wm0 + 4 * lm);
#pragma unroll
            for (int i = 0; i < 8; ++i) af[i][u] = x[i];
          }
          if (BNF) ring::read8<32>(bf[u], bs + (kg + u) * BN + wn0 + 4 * ln);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x[KR];
          if (!BNF) {
            ring::read_k(x, bs + (wn0 + ln + 8 * j) * KP + kg);
#pragma unroll
            for (int u = 0; u < KR; ++u) bf[u][j] = x[u];
          }
        }
#pragma unroll
        for (int u = 0; u < KR; ++u)   // rank-1 update by k = kg + u
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(af[i][u], bf[u][j], acc[i][j]);
      }
    }
    ring::wait<0>();
    __syncthreads();   // the ring is free for the next task

    float* c = C + (long long)t * M * N;
    const bool c4 = BNF && (N & 3) == 0;   // float4 stores of 4 columns
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row =
          m0 + (AK ? wm0 + lm + 4 * i : wm0 + 4 * lm + (i & 3) + 16 * (i >> 2));
      if (row >= M) continue;
      float* cr = c + (long long)row * N;
      if (c4) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + wn0 + 4 * ln + 32 * h;
          if (col < N)
            *reinterpret_cast<float4*>(cr + col) =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + (BNF ? wn0 + 4 * ln + (j & 3) + 32 * (j >> 2)
                                    : wn0 + ln + 8 * j);
          if (col < N) cr[col] = acc[i][j];
        }
      }
    }
  }
}

template <bool AK, bool BNF>
int launch_ring_l(const float* a, const float* b, float* c, int batch, int m,
                  int n, int k, long long sab, long long sam, long long sak,
                  long long sbb, long long sbk, long long sbn, bool vec_a,
                  bool vec_b, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      sgemm_ring<AK, BNF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int z = batch < 65535 ? batch : 65535;  // the kernel loops past it
  const dim3 grid((n + ring::BN - 1) / ring::BN, (m + ring::BM - 1) / ring::BM,
                  z);
  sgemm_ring<AK, BNF><<<grid, ring::THREADS, ring::SMEM, s>>>(
      a, b, c, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

long long iabs(long long x) { return x < 0 ? -x : x; }

// Whether an operand's contiguous dimension (stride 1, extent `extent`) may
// be copied 16 bytes at a time: its other strides keep every chunk
// 16-byte aligned.
bool vec_ok(const void* p, long long unit, int extent, long long s_other,
            long long s_batch, int batch) {
  return unit == 1 && extent % 4 == 0 && s_other % 4 == 0 &&
         (batch == 1 || s_batch % 4 == 0) &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_ring(const void* a, const void* b, void* c, int batch, int m,
                int n, int k, long long sab, long long sam, long long sak,
                long long sbb, long long sbk, long long sbn, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  float* pc = static_cast<float*>(c);
  // each operand's tile keeps the dimension with the smaller stride
  // contiguous (k unless m, or n, is unit-stride and k is not)
  const bool ak = sak == 1 || (sam != 1 && iabs(sak) <= iabs(sam));
  const bool bn = sbn == 1 || (sbk != 1 && iabs(sbn) <= iabs(sbk));
  const bool va = ak ? vec_ok(a, sak, k, sam, sab, batch)
                     : vec_ok(a, sam, m, sak, sab, batch);
  const bool vb = bn ? vec_ok(b, sbn, n, sbk, sbb, batch)
                     : vec_ok(b, sbk, k, sbn, sbb, batch);
  if (ak && bn)
    return launch_ring_l<true, true>(pa, pb, pc, batch, m, n, k, sab, sam,
                                     sak, sbb, sbk, sbn, va, vb, s);
  if (ak)
    return launch_ring_l<true, false>(pa, pb, pc, batch, m, n, k, sab, sam,
                                      sak, sbb, sbk, sbn, va, vb, s);
  if (bn)
    return launch_ring_l<false, true>(pa, pb, pc, batch, m, n, k, sab, sam,
                                      sak, sbb, sbk, sbn, va, vb, s);
  return launch_ring_l<false, false>(pa, pb, pc, batch, m, n, k, sab, sam,
                                     sak, sbb, sbk, sbn, va, vb, s);
}

template <bool AK, bool BNF>
int info_l(int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      sgemm_ring<AK, BNF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ring::SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        info, sgemm_ring<AK, BNF>, ring::THREADS, ring::SMEM);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, sgemm_ring<AK, BNF>);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = ring::SMEM;
  info[4] = ring::BK;
  info[5] = ring::STAGES;
  return 0;
}

}  // namespace

extern "C" int block_gemm_f32(const void* a, const void* b, void* c,
                              int batch, int m, int n, int k, long long sab,
                              long long sam, long long sak, long long sbb,
                              long long sbk, long long sbn, void* stream) {
  return launch_ring(a, b, c, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn,
                     stream);
}

extern "C" int block_gemm_bf16(const void* a, const void* b, void* c,
                               int batch, int m, int n, int k, long long sab,
                               long long sam, long long sak, long long sbb,
                               long long sbk, long long sbn, void* stream) {
  return launch_staged(a, b, c, batch, m, n, k, sab, sam, sak, sbb, sbk, sbn,
                       stream);
}

// info[6] of the f32 instantiation for (A k-contiguous, B n-contiguous):
// resident blocks per SM, registers and spill bytes per thread (CUDA
// runtime), dynamic shared memory bytes, BK, stages. Returns a CUDA error
// code (0 on success).
extern "C" int block_gemm_info(int a_k, int b_n, int* info) {
  if (a_k && b_n) return info_l<true, true>(info);
  if (a_k) return info_l<true, false>(info);
  if (b_n) return info_l<false, true>(info);
  return info_l<false, false>(info);
}
