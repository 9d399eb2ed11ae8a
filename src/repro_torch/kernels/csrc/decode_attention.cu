// Single-token GQA decode attention over a KV cache, split-S flash-decoding,
// for Hopper (sm_90a); f32 and bf16.
//
// Replaces the Pallas TPU kernel `decode_attention` (src/repro/kernels/
// decode_attention/decode_attention.py:65, body `_decode_kernel` at :26).
// There the grid is (B·Hkv, S/bs) with the cache axis sequential and the
// online-softmax state (m, l, acc) of the q-head group carried in VMEM
// scratch across it. Blocks on Hopper run in no order and share nothing,
// and one block per (batch, KV head) would leave most of the 132 SMs idle
// (yi-6b at batch 8 has 32 such rows). So the cache axis is cut into
// n_split ranges: block (row, split) walks its own range with (m, l, acc)
// in f32 and writes them as a partial to an f32 workspace, and a second,
// small kernel merges the partials of each (batch, q head).
//
// What it computes: o = softmax(q Kᵀ · D^-0.5) V for each (batch, q head),
// q head h reading cache head h / (Hq / Hkv), positions at or past
// kv_len[b] dead (kv_len read from device memory and clamped to S; none
// means S); the result in q's dtype. Dead positions are never read: a tile
// loads zeros past the end of its range and gives them probability 0, and
// a block whose range starts at or past kv_len writes an empty partial
// (m = -inf, l = 0) and reads nothing. The merge reads only the live
// partials. Precondition: kv_len >= 1, so split 0 is live and every live
// range holds a live position (kv_len = 0 gives 0/0 = NaN, as the
// reference gives NaN). Softmax state and sums are f32, as in
// `_decode_kernel`.
//
// What bounds it on this card (H100 SXM): yi-6b's decode layer at batch 8
// over a 32 768-position bf16 cache reads 537 MB of K and V per launch for
// 2.1 GFLOP, 4 FLOP per byte, far below either ridge (f32 67 TFLOP/s or
// bf16 989 TFLOP/s over 3.35 TB/s): the memory rate bounds it, 0.160 ms.
// So the design aims at keeping K and V streaming at the memory rate.
//
// Two partials kernels, chosen on the host from the operands:
//
// bf16 rows the tensor cores can read (d-stride 1, d % 16 == 0, 16-byte
// aligned rows), the model's decode path: decode_partial_ring. K and V
// tiles of 128 positions go from device memory straight into a 2-stage
// ring in shared memory by cp.async 16-byte copies (64 KB of K and V in
// flight on each SM while the other stage is computed; no widening to
// f32). 8 warps take 16 positions of a tile each: S = Q·Kᵀ and acc += P·V
// run on mma.sync.m16n8k16 (bf16 in, f32 accumulate; ldmatrix, .trans for
// V). The q-head group (8 heads for yi-6b) pads to the mma's 16 A rows;
// the score accumulator of two n8 tiles is P's A fragment, so P stays in
// registers (FlashAttention-2's layout). P is rounded to bf16 for P·V, the
// one rounding this kernel adds to `_decode_kernel`'s f32 p·v (measured on
// the CPU by scripts/torch_decode_rounding.py: well inside 2e-2). Each
// warp keeps its own online softmax (m, l) in f32 on its fragments (quad
// shuffles); the warps' states merge in shared memory at the end. mma.sync
// and not wgmma: wgmma needs 64 A rows (heads), and at 4 FLOP per byte the
// tensor cores' rate does not matter, only that they take the products off
// the CUDA cores. The tile, the stages and the warps were chosen by timing
// variants (scripts/torch_kernel_variants.py): deeper rings and more,
// smaller blocks were slower.
//
// Everything else (f32 always, and bf16 layouts the ring cannot read):
// decode_partial, IEEE f32 on the CUDA cores. Each block of 256 threads
// keeps the next 64-position K and V tiles in flight in registers (16-byte
// loads where the layout allows) while it computes on the current ones in
// shared memory, widened to f32. The q-head group (up to 8 heads) rides
// along as an [8, D] tile. Scores: 4 threads per position, float4 shared
// reads of rows padded by 4 floats; softmax: one warp per head; P·V: one
// thread per output column and every other head. About 73 KB of shared
// memory at D = 128.
//
// The host picks n_split so that the grid is one wave of resident blocks
// (decode_attention_info_* reports how many fit on an SM and the tile).
//
// C entry points: decode_attention_f32 / decode_attention_bf16 (CUDA-core
// kernel) and decode_attention_bf16_ring launch the partials kernel and the
// merge on the given stream and return cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 64;    // cache positions per tile
constexpr int GMAX = 8;   // q heads per block
constexpr int SG = THREADS / TS;  // threads per position in the scores

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T, held as raw bits in a uint4.
template <typename T>
struct Raw;

template <>
struct Raw<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  // The first n elements at p, p + sd, ..., zero after them.
  __device__ static uint4 gather(const float* p, long long sd, int n) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = i < n ? __float_as_uint(p[i * sd]) : 0u;
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Raw<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 gather(const __nv_bfloat16* p, long long sd, int n) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 2 * i < n ? __bfloat16_as_ushort(p[2 * i * sd]) : 0u;
      const uint32_t hi =
          2 * i + 1 < n ? __bfloat16_as_ushort(p[(2 * i + 1) * sd]) : 0u;
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Registers of one [TS, DMAX] tile: each thread's 16-byte pieces.
template <typename T, int DMAX>
struct Tile {
  static constexpr int N = Raw<T>::N;               // elements per piece
  static constexpr int CPR = DMAX / N;              // pieces per row
  static constexpr int CPT = TS * CPR / THREADS;    // pieces per thread
  static_assert(CPT >= 1 && TS * CPR % THREADS == 0, "tile shape");
};

// Load rows [t0, t0 + TS) of one head's [S, d] cache (strides ss, sd) into
// registers, zeros at rows >= end and columns >= d. VEC: one 16-byte load
// per piece (d-stride 1, d % N == 0, 16-byte aligned rows).
template <typename T, int DMAX, bool VEC>
__device__ __forceinline__ void fetch(uint4* r, const T* __restrict__ base,
                                      long long ss, long long sd, int t0,
                                      int end, int d) {
  using Tl = Tile<T, DMAX>;
#pragma unroll
  for (int i = 0; i < Tl::CPT; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int row = e / Tl::CPR, c0 = (e - row * Tl::CPR) * Tl::N;
    const int pos = t0 + row;
    if (pos >= end || c0 >= d) {
      r[i] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    const T* p = base + pos * ss + c0 * sd;
    if (VEC)
      r[i] = *reinterpret_cast<const uint4*>(p);
    else
      r[i] = Raw<T>::gather(p, sd, min(Tl::N, d - c0));
  }
}

// Store the registers of fetch() as f32 rows of a shared tile (row stride
// `stride` floats, a multiple of 4).
template <typename T, int DMAX>
__device__ __forceinline__ void stash(float* dst, int stride,
                                      const uint4* r) {
  using Tl = Tile<T, DMAX>;
#pragma unroll
  for (int i = 0; i < Tl::CPT; ++i) {
    const int e = threadIdx.x + THREADS * i;
    const int row = e / Tl::CPR, c0 = (e - row * Tl::CPR) * Tl::N;
    float f[Tl::N];
    Raw<T>::unpack(r[i], f);
#pragma unroll
    for (int u = 0; u < Tl::N; u += 4)
      *reinterpret_cast<float4*>(dst + row * stride + c0 + u) =
          make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
  }
}

template <int DMAX>
constexpr int smem_floats() {
  // Qs [GMAX][DMAX+4], Ks [TS][DMAX+4], Vs [TS][DMAX], Ps [GMAX][TS],
  // running max, sum and this tile's rescale [GMAX] each
  return GMAX * (DMAX + 4) + TS * (DMAX + 4) + TS * DMAX + GMAX * TS +
         3 * GMAX;
}

// One partial per (batch, KV head, group slice) row and cache range.
// ws_acc: [B·Hq, n_split, d] unnormalised outputs; ws_ml: [B·Hq, n_split, 2]
// the running max and sum.
template <typename T, int DMAX, bool VEC>
__global__ void __launch_bounds__(THREADS)
    decode_partial(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_len,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                   int hq, int hkv, int group, int n_sub, int s, int d,
                   int chunk, float scale, long long sqb, long long sqh,
                   long long sqd, long long skb, long long skh, long long sks,
                   long long skd, long long svb, long long svh, long long svs,
                   long long svd) {
  constexpr int DP = DMAX + 4;           // padded row of Qs and Ks
  constexpr int R = THREADS / DMAX;      // threads per column in P·V
  constexpr int GPT = GMAX / R;          // heads per thread in P·V
  constexpr int HPT = GMAX / SG;         // heads per thread in the scores
  using Tl = Tile<T, DMAX>;
  static_assert(TS == 64 && GMAX == WARPS, "softmax: a warp per head, "
                                           "two positions per lane");

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + GMAX * DP;
  float* Vs = Ks + TS * DP;
  float* Ps = Vs + TS * DMAX;
  float* Ms = Ps + GMAX * TS;
  float* Ls = Ms + GMAX;
  float* As = Ls + GMAX;

  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int sub = row % n_sub, bk = row / n_sub;
  const int b = bk / hkv, hk = bk - b * hkv;
  const int gs = min(GMAX, group - sub * GMAX);   // heads of this block
  const int h0 = hk * group + sub * GMAX;         // its first q head
  const int split = blockIdx.y, n_split = gridDim.y;
  const int len = min(kv_len ? kv_len[b] : s, s);
  const int begin = split * chunk;
  const int end = min(begin + chunk, len);
  const long long part0 = (long long)(b * hq + h0) * n_split + split;

  if (begin >= end) {  // past kv_len: an empty partial, nothing read
    if (tid < gs) {
      ws_ml[2 * (part0 + (long long)tid * n_split)] = minus_inf();
      ws_ml[2 * (part0 + (long long)tid * n_split) + 1] = 0.f;
    }
    return;
  }

  const T* kp = k + b * skb + hk * skh;
  const T* vp = v + b * svb + hk * svh;
  uint4 kr[Tl::CPT], vr[Tl::CPT];
  fetch<T, DMAX, VEC>(kr, kp, sks, skd, begin, end, d);
  fetch<T, DMAX, VEC>(vr, vp, svs, svd, begin, end, d);

  const T* qp = q + b * sqb + h0 * sqh;
  for (int e = tid; e < GMAX * DP; e += THREADS) {
    const int g = e / DP, c = e - g * DP;
    Qs[e] = (g < gs && c < d) ? to_float(qp[g * sqh + c * sqd]) : 0.f;
  }
  if (tid < GMAX) {
    Ms[tid] = minus_inf();
    Ls[tid] = 0.f;
  }

  const int sj = tid % TS, sg = tid / TS;   // scores: position, first head
  const int col = tid % DMAX, pg = tid / DMAX;  // P·V: column, first head
  const int warp = tid >> 5, lane = tid & 31;
  float acc[GPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) acc[i] = 0.f;

  const int n_tiles = (end - begin + TS - 1) / TS;
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = begin + t * TS;
    __syncthreads();  // the previous tile is no longer read
    stash<T, DMAX>(Ks, DP, kr);
    stash<T, DMAX>(Vs, DMAX, vr);
    __syncthreads();
    if (t + 1 < n_tiles) {  // the next tile's loads fly during this one
      fetch<T, DMAX, VEC>(kr, kp, sks, skd, t0 + TS, end, d);
      fetch<T, DMAX, VEC>(vr, vp, svs, svd, t0 + TS, end, d);
    }

    // Scores of position sj for heads sg, sg + SG, ...
    {
      float sc[HPT];
#pragma unroll
      for (int i = 0; i < HPT; ++i) sc[i] = 0.f;
      const float* kk = Ks + sj * DP;
#pragma unroll 4
      for (int dd = 0; dd < DMAX; dd += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kk + dd);
#pragma unroll
        for (int i = 0; i < HPT; ++i) {
          if (sg + SG * i < gs) {  // uniform across the warp
            const float4 q4 = *reinterpret_cast<const float4*>(
                Qs + (sg + SG * i) * DP + dd);
            sc[i] = fmaf(q4.x, k4.x, sc[i]);
            sc[i] = fmaf(q4.y, k4.y, sc[i]);
            sc[i] = fmaf(q4.z, k4.z, sc[i]);
            sc[i] = fmaf(q4.w, k4.w, sc[i]);
          }
        }
      }
      const bool live = t0 + sj < end;
#pragma unroll
      for (int i = 0; i < HPT; ++i)
        if (sg + SG * i < gs)
          Ps[(sg + SG * i) * TS + sj] = live ? sc[i] * scale : minus_inf();
    }
    __syncthreads();

    // Online softmax, one warp per head; the tile holds a live position,
    // so the new max is finite.
    if (warp < gs) {
      float* pr = Ps + warp * TS;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = Ms[warp];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        As[warp] = alpha;
        Ls[warp] = alpha * Ls[warp] + sum;
        Ms[warp] = m_new;
      }
    }
    __syncthreads();

    // acc[g][col] = alpha_g acc[g][col] + sum_j p[g][j] V[j][col]
    {
      const float* vc = Vs + col;
#pragma unroll
      for (int i = 0; i < GPT; ++i)
        if (pg + R * i < gs) acc[i] *= As[pg + R * i];
#pragma unroll 4
      for (int j = 0; j < TS; j += 4) {
        const float v0 = vc[j * DMAX], v1 = vc[(j + 1) * DMAX];
        const float v2 = vc[(j + 2) * DMAX], v3 = vc[(j + 3) * DMAX];
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          if (pg + R * i < gs) {  // uniform across the warp
            const float4 p4 = *reinterpret_cast<const float4*>(
                Ps + (pg + R * i) * TS + j);
            acc[i] = fmaf(p4.x, v0, acc[i]);
            acc[i] = fmaf(p4.y, v1, acc[i]);
            acc[i] = fmaf(p4.z, v2, acc[i]);
            acc[i] = fmaf(p4.w, v3, acc[i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int g = pg + R * i;
    if (g < gs && col < d)
      ws_acc[(part0 + (long long)g * n_split) * d + col] = acc[i];
  }
  if (tid < gs) {
    ws_ml[2 * (part0 + (long long)tid * n_split)] = Ms[tid];
    ws_ml[2 * (part0 + (long long)tid * n_split) + 1] = Ls[tid];
  }
}

// out[b, h, :] from the live partials of (b, h): one block of 128 threads
// (one per column) per (batch, q head).
template <typename T>
__global__ void __launch_bounds__(128)
    decode_combine(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml,
                   const int* __restrict__ kv_len, T* __restrict__ out,
                   int hq, int s, int d, int chunk, int n_split) {
  const int bh = blockIdx.x, b = bh / hq;
  const int len = min(kv_len ? kv_len[b] : s, s);
  const int n_live = len > 0 ? min(n_split, (len + chunk - 1) / chunk) : 0;
  const float* ml = ws_ml + 2LL * bh * n_split;
  float m = minus_inf();
  for (int i = 0; i < n_live; ++i) m = fmaxf(m, ml[2 * i]);
  const int c = threadIdx.x;
  if (c >= d) return;
  const float* acc = ws_acc + (long long)bh * n_split * d + c;
  float l = 0.f, o = 0.f;
  for (int i = 0; i < n_live; ++i) {
    const float w = expf(ml[2 * i] - m);
    l = fmaf(ml[2 * i + 1], w, l);
    o = fmaf(acc[(long long)i * d], w, o);
  }
  store_as(out + (long long)bh * d + c, o / l);
}

// ------------------------------------------- bf16: tensor cores, cp.async ring

namespace ring {

constexpr int THREADS = 256;      // 8 warps, 16 positions of each tile apiece
constexpr int WARPS = THREADS / 32;
constexpr int TS = 128;           // cache positions per tile
constexpr int STAGES = 2;         // tiles of K and V in the shared ring
constexpr int ROWS = 16;          // q heads per block: the mma's 16 A rows
constexpr int PAD = 8;            // bf16 per tile row: ldmatrix conflict-free

template <int DMAX>
__host__ __device__ constexpr int stage_elems() {     // K then V, [TS][DMAX + PAD] bf16 each
  return 2 * TS * (DMAX + PAD);
}

template <int DMAX>
__host__ __device__ constexpr int smem_bytes() {
  // the ring, then (reused after the last tile) each warp's (m, l, acc)
  return 2 * STAGES * stage_elems<DMAX>() > 4 * WARPS * ROWS * (DMAX + 2)
             ? 2 * STAGES * stage_elems<DMAX>()
             : 4 * WARPS * ROWS * (DMAX + 2);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !live (no
// global read then: src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c[16x8] += a[16x16] · b[16x8], bf16 in, f32 accumulate (HMMA).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as a bf16 pair, `lo` in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

}  // namespace ring

// The bf16 partials kernel: one (batch, KV head, slice of up to 16 q heads)
// row and one cache range per block, the same partials as decode_partial.
// K and V tiles go from device memory straight into a STAGES-deep shared
// ring by cp.async (zero-filled past `end` and past d, nothing read there);
// warp w computes positions [16w, 16w + 16) of each tile: S = Q·Kᵀ as two
// m16n8k16 tiles per 16 columns of D (Q's A fragments held in registers
// for the whole walk, K's B fragments by ldmatrix), its own online softmax
// over its positions on the S fragments (row max and sum over the quad),
// then acc += P·V with P's A fragment repacked from S in registers and
// V's B fragments by ldmatrix.trans. The warps' (m, l, acc) are merged in
// shared memory at the end. Layout the host guarantees: K and V rows with
// unit d-stride, d % 16 == 0, 16-byte aligned rows and base.
template <int DMAX>
__global__ void __launch_bounds__(ring::THREADS)
    decode_partial_ring(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                        int hq, int hkv, int group, int n_sub, int s, int d,
                        int chunk, float scale, long long sqb, long long sqh,
                        long long sqd, long long skb, long long skh,
                        long long sks, long long svb, long long svh,
                        long long svs) {
  // ring's names, declared here so they hide the CUDA-core kernel's
  constexpr int THREADS = ring::THREADS, WARPS = ring::WARPS, TS = ring::TS;
  constexpr int STAGES = ring::STAGES, ROWS = ring::ROWS, PAD = ring::PAD;
  constexpr int STAGE = ring::stage_elems<DMAX>();
  using ring::cp_async16;
  using ring::cp_async_commit;
  using ring::cp_async_wait;
  using ring::ldsm_x4;
  using ring::ldsm_x4_t;
  using ring::mma_bf16;
  using ring::pack_bf16;
  constexpr int RP = DMAX + PAD;    // padded tile row, bf16
  constexpr int KSTEPS = DMAX / 16; // k16 steps of Q·Kᵀ
  constexpr int NT = DMAX / 8;      // n8 tiles of the output
  constexpr int CPR = DMAX / 8;     // 16-byte chunks per tile row
  static_assert(TS == 16 * WARPS, "16 positions of a tile per warp");
  static_assert(TS * CPR % THREADS == 0, "tile copy shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // fragment row, column pair
  const int row = blockIdx.x;
  const int sub = row % n_sub, bk = row / n_sub;
  const int b = bk / hkv, hk = bk - b * hkv;
  const int gs = min(ROWS, group - sub * ROWS);   // heads of this block
  const int h0 = hk * group + sub * ROWS;         // its first q head
  const int split = blockIdx.y, n_split = gridDim.y;
  const int len = min(kv_len ? kv_len[b] : s, s);
  const int begin = split * chunk;
  const int end = min(begin + chunk, len);
  const long long part0 = (long long)(b * hq + h0) * n_split + split;

  if (begin >= end) {  // past kv_len: an empty partial, nothing read
    if (tid < gs) {
      ws_ml[2 * (part0 + (long long)tid * n_split)] = minus_inf();
      ws_ml[2 * (part0 + (long long)tid * n_split) + 1] = 0.f;
    }
    return;
  }

  const __nv_bfloat16* kp = k + b * skb + hk * skh;
  const __nv_bfloat16* vp = v + b * svb + hk * svh;
  const int n_tiles = (end - begin + TS - 1) / TS;

  auto load_tile = [&](int tile, int stage) {
    __nv_bfloat16* ks = ring_s + stage * STAGE;
    __nv_bfloat16* vs = ks + TS * RP;
    const int t0 = begin + tile * TS;
#pragma unroll
    for (int i = 0; i < TS * CPR / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / CPR, c = (e - r * CPR) * 8;
      const int pos = t0 + r;
      const bool live = pos < end && c < d;
      cp_async16(ks + r * RP + c, live ? kp + pos * sks + c : kp, live);
      cp_async16(vs + r * RP + c, live ? vp + pos * svs + c : vp, live);
    }
  };

  // The ring's first STAGES - 1 tiles fly while Q is read.
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    cp_async_commit();
  }

  // Q's A fragments (rows: heads h0 + g and h0 + g + 8, zero past gs and d)
  const __nv_bfloat16* qp = q + b * sqb + h0 * sqh;
  auto qbits = [&](int r, int c) -> uint32_t {
    return (r < gs && c < d)
               ? static_cast<uint32_t>(__bfloat16_as_ushort(qp[r * sqh + c * sqd]))
               : 0u;
  };
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int c = 16 * ks + 2 * t4;
    qf[ks][0] = qbits(g, c) | qbits(g, c + 1) << 16;
    qf[ks][1] = qbits(g + 8, c) | qbits(g + 8, c + 1) << 16;
    qf[ks][2] = qbits(g, c + 8) | qbits(g, c + 9) << 16;
    qf[ks][3] = qbits(g + 8, c + 8) | qbits(g + 8, c + 9) << 16;
  }

  // This warp's state for rows g (index 0) and g + 8 (index 1); l is this
  // thread's share of the sum, reduced over the quad at the end.
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {minus_inf(), minus_inf()}, l_r[2] = {0.f, 0.f};
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix, row

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile t landed
    __syncthreads();               // everyone's, and tile t - 1 is read
    {
      const int next = t + STAGES - 1;   // into the stage tile t - 1 held
      if (next < n_tiles) load_tile(next, next % STAGES);
      cp_async_commit();
    }
    const __nv_bfloat16* ks = ring_s + (t % STAGES) * STAGE;
    const __nv_bfloat16* vs = ks + TS * RP;

    // S = Q·Kᵀ over this warp's 16 positions: sc[n8 tile][fragment]
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kstep = 0; kstep < KSTEPS; ++kstep) {
      uint32_t kb[4];   // (positions 0-7, d lo), (0-7, hi), (8-15, lo), (8-15, hi)
      ldsm_x4(kb, ks + (16 * warp + 8 * (mi >> 1) + r8) * RP + 16 * kstep +
                      8 * (mi & 1));
      mma_bf16(sc[0], qf[kstep], kb[0], kb[1]);
      mma_bf16(sc[1], qf[kstep], kb[2], kb[3]);
    }

    // Online softmax: scale, dead positions at -inf, row max over the quad
    const int p0 = begin + t * TS + 16 * warp;
    float mx[2] = {minus_inf(), minus_inf()};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = p0 + 8 * nt + 2 * t4 + (e & 1);
        const float x = pos < end ? sc[nt][e] * scale : minus_inf();
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      // a warp that has seen no live position yet keeps m = -inf, p = 0
      base[r] = m_new == minus_inf() ? 0.f : m_new;
      const float alpha = expf(m_r[r] - base[r]);
      m_r[r] = m_new;
      l_r[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[nt][e] - base[e >> 1]);
        sc[nt][e] = p;
        l_r[e >> 1] += p;
      }

    // acc += P·V, P's A fragment from the S fragments (bf16, in registers)
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      uint32_t vb[4];   // (positions 0-7, d lo), (8-15, lo), (0-7, hi), (8-15, hi)
      ldsm_x4_t(vb, vs + (16 * warp + 8 * (mi & 1) + r8) * RP + 16 * j +
                        8 * (mi >> 1));
      mma_bf16(acc[2 * j], pa, vb[0], vb[1]);
      mma_bf16(acc[2 * j + 1], pa, vb[2], vb[3]);
    }
  }

  cp_async_wait<0>();
  __syncthreads();   // the ring is free: each warp's state goes there

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  float* ms = reinterpret_cast<float*>(smem_raw);   // [WARPS][ROWS]
  float* ls = ms + WARPS * ROWS;                     // [WARPS][ROWS]
  float* as = ls + WARPS * ROWS;                     // [WARPS][ROWS][DMAX]
  if (t4 == 0) {
    ms[warp * ROWS + g] = m_r[0];
    ms[warp * ROWS + g + 8] = m_r[1];
    ls[warp * ROWS + g] = l_r[0];
    ls[warp * ROWS + g + 8] = l_r[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* a0 = as + (warp * ROWS + g) * DMAX + 8 * n + 2 * t4;
    *reinterpret_cast<float2*>(a0) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(a0 + 8 * DMAX) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();

  // The block's partial: the warps' states merged by their maxima (the
  // range holds a live position, so the largest is finite)
  for (int e = tid; e < gs * d; e += THREADS) {
    const int h = e / d, c = e - h * d;
    float m = minus_inf();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, ms[w * ROWS + h]);
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      o = fmaf(as[(w * ROWS + h) * DMAX + c], expf(ms[w * ROWS + h] - m), o);
    ws_acc[(part0 + (long long)h * n_split) * d + c] = o;
  }
  if (tid < gs) {
    float m = minus_inf(), l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, ms[w * ROWS + tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      l = fmaf(ls[w * ROWS + tid], expf(ms[w * ROWS + tid] - m), l);
    ws_ml[2 * (part0 + (long long)tid * n_split)] = m;
    ws_ml[2 * (part0 + (long long)tid * n_split) + 1] = l;
  }
}

// Lets decode_partial<T, DMAX, VEC> take its dynamic shared memory.
template <typename T, int DMAX, bool VEC>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(decode_partial<T, DMAX, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              4 * smem_floats<DMAX>());
}

// info: resident blocks per SM, registers per thread, local (spill) bytes
// per thread of the first kernel's instantiation for (T, d, vec).
template <typename T, int DMAX, bool VEC>
int info_d(int* info) {
  cudaError_t err = allow_smem<T, DMAX, VEC>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        info, decode_partial<T, DMAX, VEC>, THREADS, 4 * smem_floats<DMAX>());
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, decode_partial<T, DMAX, VEC>);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = 4 * smem_floats<DMAX>();
  info[4] = TS;
  info[5] = 2;   // the tile in registers and the one in shared memory
  return 0;
}

template <typename T, bool VEC>
int info_vec(int d, int* info) {
  if (d <= 32) return info_d<T, 32, VEC>(info);
  if (d <= 64) return info_d<T, 64, VEC>(info);
  if (d <= 128) return info_d<T, 128, VEC>(info);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DMAX, bool VEC>
int launch_d(const T* q, const T* k, const T* v, const int* kv_len,
             float* ws_acc, float* ws_ml, T* out, int batch, int hq, int hkv,
             int s, int d, int chunk, int n_split, float scale,
             const long long* st, cudaStream_t stream) {
  constexpr int smem = 4 * smem_floats<DMAX>();
  cudaError_t err = allow_smem<T, DMAX, VEC>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = hq / hkv;
  const int n_sub = (group + GMAX - 1) / GMAX;
  const dim3 grid(batch * hkv * n_sub, n_split);
  decode_partial<T, DMAX, VEC><<<grid, THREADS, smem, stream>>>(
      q, k, v, kv_len, ws_acc, ws_ml, hq, hkv, group, n_sub, s, d, chunk,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T><<<batch * hq, 128, 0, stream>>>(ws_acc, ws_ml, kv_len,
                                                    out, hq, s, d, chunk,
                                                    n_split);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_vec(const T* q, const T* k, const T* v, const int* kv_len,
               float* ws_acc, float* ws_ml, T* out, int batch, int hq,
               int hkv, int s, int d, int chunk, int n_split, float scale,
               const long long* st, cudaStream_t stream) {
  if (d <= 32)
    return launch_d<T, 32, VEC>(q, k, v, kv_len, ws_acc, ws_ml, out, batch,
                                hq, hkv, s, d, chunk, n_split, scale, st,
                                stream);
  if (d <= 64)
    return launch_d<T, 64, VEC>(q, k, v, kv_len, ws_acc, ws_ml, out, batch,
                                hq, hkv, s, d, chunk, n_split, scale, st,
                                stream);
  if (d <= 128)
    return launch_d<T, 128, VEC>(q, k, v, kv_len, ws_acc, ws_ml, out, batch,
                                 hq, hkv, s, d, chunk, n_split, scale, st,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* ws_acc, void* ws_ml, void* out, int batch, int hq, int hkv,
           int s, int d, int chunk, int n_split, int vec, float scale,
           const long long* strides, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* pq = static_cast<const T*>(q);
  const T* pk = static_cast<const T*>(k);
  const T* pv = static_cast<const T*>(v);
  const int* pl = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(ws_acc);
  float* pm = static_cast<float*>(ws_ml);
  T* po = static_cast<T*>(out);
  if (vec)
    return launch_vec<T, true>(pq, pk, pv, pl, pa, pm, po, batch, hq, hkv, s,
                               d, chunk, n_split, scale, strides, st);
  return launch_vec<T, false>(pq, pk, pv, pl, pa, pm, po, batch, hq, hkv, s,
                              d, chunk, n_split, scale, strides, st);
}

template <int DMAX>
cudaError_t ring_allow_smem() {
  return cudaFuncSetAttribute(decode_partial_ring<DMAX>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              ring::smem_bytes<DMAX>());
}

template <int DMAX>
int ring_info_d(int* info) {
  cudaError_t err = ring_allow_smem<DMAX>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        info, decode_partial_ring<DMAX>, ring::THREADS,
        ring::smem_bytes<DMAX>());
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, decode_partial_ring<DMAX>);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = ring::smem_bytes<DMAX>();
  info[4] = ring::TS;
  info[5] = ring::STAGES;
  return 0;
}

template <int DMAX>
int ring_launch_d(const void* q, const void* k, const void* v,
                  const void* kv_len, void* ws_acc, void* ws_ml, void* out,
                  int batch, int hq, int hkv, int s, int d, int chunk,
                  int n_split, float scale, const long long* st,
                  cudaStream_t stream) {
  cudaError_t err = ring_allow_smem<DMAX>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = hq / hkv;
  const int n_sub = (group + ring::ROWS - 1) / ring::ROWS;
  const dim3 grid(batch * hkv * n_sub, n_split);
  const int* pl = static_cast<const int*>(kv_len);
  float* pa = static_cast<float*>(ws_acc);
  float* pm = static_cast<float*>(ws_ml);
  decode_partial_ring<DMAX>
      <<<grid, ring::THREADS, ring::smem_bytes<DMAX>(), stream>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), pl, pa, pm, hq, hkv, group,
          n_sub, s, d, chunk, scale, st[0], st[1], st[2], st[3], st[4],
          st[5], st[7], st[8], st[9]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<__nv_bfloat16><<<batch * hq, 128, 0, stream>>>(
      pa, pm, pl, static_cast<__nv_bfloat16*>(out), hq, s, d, chunk,
      n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: q (b, h, d), k (b, h, s, d), v (b, h, s, d), 11 in all. kv_len:
// int32 [batch] on the device, or null for s. ws_acc: f32 [batch·hq,
// n_split, d]; ws_ml: f32 [batch·hq, n_split, 2]. out: [batch, hq, d]
// contiguous. vec: K and V may be read 16 bytes at a time (d-stride 1,
// d a multiple of 16 bytes, rows 16-byte aligned).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* kv_len,
                                    void* ws_acc, void* ws_ml, void* out,
                                    int batch, int hq, int hkv, int s, int d,
                                    int chunk, int n_split, int vec,
                                    float scale, const long long* strides,
                                    void* stream) {
  return launch<float>(q, k, v, kv_len, ws_acc, ws_ml, out, batch, hq, hkv, s,
                       d, chunk, n_split, vec, scale, strides, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* ws_acc, void* ws_ml, void* out,
                                     int batch, int hq, int hkv, int s, int d,
                                     int chunk, int n_split, int vec,
                                     float scale, const long long* strides,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, ws_acc, ws_ml, out, batch, hq,
                               hkv, s, d, chunk, n_split, vec, scale, strides,
                               stream);
}

// The bf16 ring kernel pair (decode_partial_ring, then decode_combine), for
// K and V rows the ring can read: d-stride 1, d % 16 == 0 (d <= 128), rows
// and base 16-byte aligned. Arguments as decode_attention_bf16's, without
// vec.
extern "C" int decode_attention_bf16_ring(const void* q, const void* k,
                                          const void* v, const void* kv_len,
                                          void* ws_acc, void* ws_ml,
                                          void* out, int batch, int hq,
                                          int hkv, int s, int d, int chunk,
                                          int n_split, float scale,
                                          const long long* strides,
                                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 16 != 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 64)
    return ring_launch_d<64>(q, k, v, kv_len, ws_acc, ws_ml, out, batch, hq,
                             hkv, s, d, chunk, n_split, scale, strides, st);
  return ring_launch_d<128>(q, k, v, kv_len, ws_acc, ws_ml, out, batch, hq,
                            hkv, s, d, chunk, n_split, scale, strides, st);
}

// info[6] for the instantiation that decode_attention_{f32,bf16} launches at
// head dim d with vec (or decode_attention_bf16_ring): resident blocks per
// SM of the first kernel (the host's split plan aims at one wave of them),
// registers per thread, spill bytes per thread, dynamic shared memory bytes,
// cache positions per tile, tiles held at once. Returns a CUDA error code
// (0 on success).
extern "C" int decode_attention_info_f32(int d, int vec, int* info) {
  return vec ? info_vec<float, true>(d, info)
             : info_vec<float, false>(d, info);
}

extern "C" int decode_attention_info_bf16(int d, int vec, int* info) {
  return vec ? info_vec<__nv_bfloat16, true>(d, info)
             : info_vec<__nv_bfloat16, false>(d, info);
}

extern "C" int decode_attention_info_bf16_ring(int d, int* info) {
  if (d % 16 != 0 || d > 128) return static_cast<int>(cudaErrorInvalidValue);
  return d <= 64 ? ring_info_d<64>(info) : ring_info_d<128>(info);
}
