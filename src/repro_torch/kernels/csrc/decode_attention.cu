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
// tile holds a live position (kv_len = 0 gives 0/0 = NaN, as the reference
// gives NaN). bf16 operands are loaded as bf16 and all arithmetic is f32
// (IEEE, on the CUDA cores), as in `_decode_kernel`.
//
// What bounds it on this card (H100 SXM): yi-6b's decode layer at batch 8
// over a 32 768-position bf16 cache reads 537 MB of K and V for 2.1 GFLOP,
// 4 FLOP per byte, far below the f32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20): the memory rate bounds it, 0.160 ms.
//
// What the design does about it: the host picks n_split so that the grid
// is one wave of resident blocks (decode_attention_info_* reports how many
// fit on an SM); each block of 256 threads keeps the next 64-position K
// and V tiles in flight in registers (16-byte loads where the layout
// allows) while it computes on the current ones in shared memory.
// The q-head group (up to 8 heads; a larger group is split over blocks)
// rides along as an [8, D] tile, so each K and V element read feeds every
// head of its group. Scores: 4 threads per position, each a dot product
// over D with float4 shared-memory reads (rows padded by 4 floats, so the
// K reads across lanes are conflict-free). Softmax: one warp per head.
// P·V: one thread per output column and every other head. About 73 KB of
// shared memory at D = 128, so at most three blocks fit on an SM. wgmma,
// TMA and a deeper pipeline are left for later work.
//
// C entry points: decode_attention_f32 / decode_attention_bf16 launch both
// kernels on the given stream and return cudaGetLastError() (0 on success).

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

// info[3] for the instantiation that decode_attention_{f32,bf16} launches at
// head dim d with vec: resident blocks per SM of the first kernel (the
// host's split plan aims at one wave of them), registers per thread, spill
// bytes per thread. Returns a CUDA error code (0 on success).
extern "C" int decode_attention_info_f32(int d, int vec, int* info) {
  return vec ? info_vec<float, true>(d, info)
             : info_vec<float, false>(d, info);
}

extern "C" int decode_attention_info_bf16(int d, int vec, int* info) {
  return vec ? info_vec<__nv_bfloat16, true>(d, info)
             : info_vec<__nv_bfloat16, false>(d, info);
}
