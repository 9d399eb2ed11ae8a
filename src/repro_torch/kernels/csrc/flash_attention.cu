// Causal or full GQA flash attention, forward, for Hopper (sm_90a); f32 and
// bf16.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention/flash_attention.py:76, body `_fa_kernel` at :30), which
// the block executor reaches through `task_attention` (ops.py:22) as the
// body of the attention-chain PTG. There the grid is (B·Hq, Lq/bq, Lk/bk)
// and the online-softmax state (m, l, acc) rides in VMEM scratch across the
// sequential KV axis. Blocks on Hopper run in no order and share nothing,
// so here one block owns one (batch·q-head, q-tile) and walks the KV tiles
// in a loop of its own, with m, l and acc in registers.
//
// What it computes: O = softmax(Q Kᵀ · D^-0.5 + mask) V per (batch,
// q-head), the KV head being h // (Hq / Hkv). Queries are the trailing Lq
// positions of the Lk-long sequence; with `causal` a logit whose key lies
// after its
// query is -1e30 (the reference's value: -inf would give (-inf) - (-inf) =
// NaN in a row whose tile is all masked). The loop stops at the block's
// causal bound, so fully masked KV tiles are never read. Keys past Lk and
// queries past Lq (ragged edges) are masked. bf16 operands are loaded as
// bf16 and all arithmetic is f32, as in `_fa_kernel`; f32 is IEEE f32 on
// the CUDA cores. Q, K and V come with their own four strides, so the
// executor's [T, L, D] task form is read as B = T, H = 1 with no copy.
//
// What bounds it on this card (H100 SXM): one causal attention-chain task
// at L = 4096, D = 128 is 2·2·L²·D/2 = 4.3 GFLOP over 4·L·D·4 = 8 MiB, 512
// FLOP per byte, far above the f32 ridge (67 TFLOP/s over 3.35 TB/s = 20):
// the f32 FMA rate bounds it. bf16 could use the tensor cores (989 TFLOP/s)
// but this kernel does its math in f32 on the CUDA cores as the reference
// does, so f32 FMAs bound both types.
//
// What the design does about it: 256 threads own a 64-query tile; the Q
// tile stays in shared memory for the whole KV walk, and one shared buffer
// takes each 64-key K tile and then its V tile (82 KB at D = 128, so two
// blocks fit on an SM). Each thread keeps a 4 x 4 register tile of the
// logits (every shared value read feeds 4 FMAs) and a 4 x D/16 tile of the
// output; a row's max and sum are reduced over the 16 threads that hold it
// with warp shuffles. Row strides are padded by one float so the K reads
// across lanes are conflict-free. q-tiles are issued latest first, so the
// longest causal walks start first. Tensor cores (wgmma for bf16), TMA and
// double buffering are left for later work.
//
// C entry points: flash_attention_f32 / flash_attention_bf16 launch on the
// given stream with the given dynamic shared memory and return
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 row groups x 16 columns
constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per KV tile
constexpr float NEG = -1e30f;

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

// Copy rows [r0, r0 + R) of an [rows, d] operand (strides sr, sd) into a
// shared [R][dp] f32 tile, zero past `rows`.
template <typename T, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long sr, long long sd, int r0,
                                          int rows, int d, int dp) {
  for (int e = threadIdx.x; e < R * d; e += THREADS) {
    const int r = e / d, c = e - r * d;
    const int gr = r0 + r;
    dst[r * dp + c] = gr < rows ? to_float(src[gr * sr + c * sd]) : 0.f;
  }
}

// KD = columns of D per thread / 16 (D <= 16 * KD).
template <typename T, int KD>
__global__ void __launch_bounds__(THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
              int lq, int lk, int d, int causal, float scale, long long sqb,
              long long sqh, long long sql, long long sqd, long long skb,
              long long skh, long long skl, long long skd, long long svb,
              long long svh, long long svl, long long svd) {
  extern __shared__ float smem[];
  const int dp = d + 1;      // padded row stride of the Q and K/V tiles
  constexpr int PS = BK + 1;  // padded row stride of the probabilities
  float* Qs = smem;           // [BQ][dp]
  float* KVs = Qs + BQ * dp;  // [BK][dp], K then V of one KV tile
  float* Ps = KVs + BK * dp;  // [BQ][PS]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // latest tiles first
  const int offset = lk - lq;  // absolute position of query 0

  const T* qp = q + b * sqb + h * sqh;
  const T* kp = k + b * skb + hk * skh;
  const T* vp = v + b * svb + hk * svh;

  load_tile<T, BQ>(Qs, qp, sql, sqd, q0, lq, d, dp);

  float m[4], l[4], acc[4][KD];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < KD; ++c) acc[a][c] = 0.f;
  }

  int kv_end = lk;
  if (causal) {
    const int last_q = min(q0 + BQ, lq) - 1 + offset;
    kv_end = max(0, min(lk, last_q + 1));
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's V and P are no longer read
    load_tile<T, BK>(KVs, kp, skl, skd, k0, lk, d, dp);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty * 4 + a) * dp + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = KVs[(tx + 16 * j) * dp + dd];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qa[a], kb[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qpos = q0 + ty * 4 + a + offset;
      float mx = minus_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[a][j] * scale;
        if (causal && kpos > qpos) x = NEG;
        if (kpos >= lk) x = minus_inf();  // past the keys: probability 0
        s[a][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 threads
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - m_new);
        rs += p;
        Ps[(ty * 4 + a) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = alpha * l[a] + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < KD; ++c) acc[a][c] *= alpha;
    }

    __syncthreads();  // K is no longer read; P is complete
    load_tile<T, BK>(KVs, vp, svl, svd, k0, lk, d, dp);
    __syncthreads();

    const int jn = min(BK, lk - k0);
    for (int j = 0; j < jn; ++j) {
      float pa[4], vb[KD];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = Ps[(ty * 4 + a) * PS + j];
#pragma unroll
      for (int c = 0; c < KD; ++c) vb[c] = KVs[j * dp + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < KD; ++c) acc[a][c] = fmaf(pa[a], vb[c], acc[a][c]);
    }
  }

  T* op = o + ((long long)bh * lq) * d;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty * 4 + a;
    if (row >= lq) continue;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int col = tx + 16 * c;
      if (col < d) store_as(&op[(long long)row * d + col], acc[a][c] / l[a]);
    }
  }
}

template <typename T, int KD>
int launch_kd(const T* q, const T* k, const T* v, T* o, int batch, int hq,
              int hkv, int lq, int lk, int d, int causal, float scale,
              const long long* st, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * hq, (lq + BQ - 1) / BQ);
  fa_kernel<T, KD><<<grid, THREADS, smem, s>>>(
      q, k, v, o, hq, hkv, lq, lk, d, causal, scale, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int lq, int lk, int d, int causal, float scale,
           const long long* strides, int smem, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* pq = static_cast<const T*>(q);
  const T* pk = static_cast<const T*>(k);
  const T* pv = static_cast<const T*>(v);
  T* po = static_cast<T*>(o);
  if (d <= 16)
    return launch_kd<T, 1>(pq, pk, pv, po, batch, hq, hkv, lq, lk, d, causal,
                           scale, strides, smem, s);
  if (d <= 32)
    return launch_kd<T, 2>(pq, pk, pv, po, batch, hq, hkv, lq, lk, d, causal,
                           scale, strides, smem, s);
  if (d <= 64)
    return launch_kd<T, 4>(pq, pk, pv, po, batch, hq, hkv, lq, lk, d, causal,
                           scale, strides, smem, s);
  if (d <= 128)
    return launch_kd<T, 8>(pq, pk, pv, po, batch, hq, hkv, lq, lk, d, causal,
                           scale, strides, smem, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides: q (b, h, l, d), k (b, h, l, d), v (b, h, l, d), 12 in all.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int batch, int hq,
                                   int hkv, int lq, int lk, int d, int causal,
                                   float scale, const long long* strides,
                                   int smem, void* stream) {
  return launch<float>(q, k, v, o, batch, hq, hkv, lq, lk, d, causal, scale,
                       strides, smem, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch, int hq,
                                    int hkv, int lq, int lk, int d,
                                    int causal, float scale,
                                    const long long* strides, int smem,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, hq, hkv, lq, lk, d, causal,
                               scale, strides, smem, stream);
}
