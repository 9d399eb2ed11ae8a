// Causal or full GQA flash attention, forward, for Hopper (sm_90a): a
// tensor-core path for bf16 and an IEEE-f32 path on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` (src/repro/kernels/
// flash_attention/flash_attention.py:76, body `_fa_kernel` at :30), which
// the block executor reaches through `task_attention` (ops.py:22) as the
// body of the attention-chain PTG and the dense models reach in prefill.
// There the grid is (B·Hq, Lq/bq, Lk/bk) and the online-softmax state (m,
// l, acc) rides in VMEM scratch across the sequential KV axis. Blocks on
// Hopper run in no order and share nothing, so a block walks its KV tiles
// in a loop of its own, with m, l and acc in registers.
//
// What it computes: O = softmax(Q Kᵀ · D^-0.5 + mask) V per (batch,
// q-head), the KV head being h // (Hq / Hkv). Queries are the trailing Lq
// positions of the Lk-long sequence; with `causal` a logit whose key lies
// after its query is -1e30 (the reference's -inf would give (-inf) - (-inf)
// = NaN in a row whose tile is all masked), with a sliding `window` > 0 so
// is a logit whose key lies `window` or more positions before its query
// (kpos <= qpos - window, as the JAX package's chunked_attention masks),
// and keys past Lk have probability 0 (-inf). Tiles past a block's causal
// bound, and tiles wholly before the window of its first query, are never
// read. A row whose first tiles are all masked sums exp(0) = 1 for them
// until its first live key, whose running max then scales that sum and
// its output by exp(-1e30 - max) = 0: with `causal` every row's own key is
// live, so every row ends with its live keys only.
// Q, K and V come with their own four strides, so the executor's [T, L, D]
// task form is read as B = T, H = 1 with no copy.
//
// bf16 path. What bounds it: yi-6b's prefill layer (q [1, 32, 4096, 128],
// kv [1, 4, 4096, 128], causal) is 137 GFLOP over 42 MB, 3 300 FLOP per
// byte, far above the bf16 ridge (989 TFLOP/s over 3.35 TB/s = 295): the
// tensor cores bound it, 0.139 ms. What the design does: both products run
// on the tensor cores through `wgmma` (m64nNk16, bf16 in, f32 accumulate).
// A block of three warpgroups owns 128 queries: one producer warp keeps a
// two-stage ring of 128-key K and V tiles filled with TMA (tensor maps
// built on the host with cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links against the runtime only;
// 128-byte swizzle, the same in the wgmma descriptors; out-of-bounds rows
// and columns arrive as zeros), and two consumer warpgroups of 64 query
// rows each run S = Q·Kᵀ (Q and K from shared memory, both K-major), the
// online softmax in registers, and O += P·V (P from registers, repacked
// from the f32 S fragment into bf16 A fragments as FlashAttention-3 does;
// V from shared memory, MN-major, with the transpose bit). `setmaxnreg`
// gives the consumers 240 registers and the producer 24. The causal mask
// is computed only on a warpgroup's diagonal tiles and the tile at Lk.
// Where P is rounded: S is exact products of bf16 values summed in f32, as
// the reference's f32 dots of bf16 inputs; P (f32, after the running max)
// is rounded to bf16 once before P·V, the one new rounding (the TPU's
// default-precision MXU does the same); l sums the unrounded f32 P, and O
// is rounded to bf16 once at the end.
//
// f32 path. What bounds it: one attention-chain task ([1, 1, 4096, 128]
// f32, causal) is 4.3 GFLOP over 8 MiB, 512 FLOP per byte, far above the
// f32 ridge (67 TFLOP/s over 3.35 TB/s = 20): the f32 FMA rate bounds it,
// 0.064 ms, and it must stay IEEE f32 on the CUDA cores (TF32 cannot meet
// 2e-5). Two things stand in the way: a block per query tile gives 32
// blocks on 132 SMs for one task, with causal walks of 2 to 64 tiles; and
// an FMA's operands come from shared memory, which delivers 32 floats a
// clock to the SM's 128 FMA lanes, so a thread must reuse each float it
// reads at least 4 times. What the design does: the host splits each query
// tile's KV walk into ranges (`split_plan` in the wrapper) so that one
// (batch, head) fills one wave of resident blocks; a block writes its
// range's f32 (m, l, acc) to a workspace and a second kernel merges the
// ranges of each query tile with weights exp(m - max) / sum, as B4 does (a
// query tile with one range writes its output directly). With a window a
// query tile's walk starts at the first tile its first row's window
// reaches. The plan depends only on (Lq, Lk, D, causal, window) and the
// card's resident blocks, never on the batch, so a task's result does not
// depend on the batch it rides in. A
// block of 256 threads owns 128 queries and walks 64-key tiles, K and V in
// separate double buffers filled with cp.async (16 bytes where rows allow
// it, 4 otherwise; zeros past the edges); P, transposed, goes over the K
// tile it came from. A thread holds an 8 x 4 tile of the logits (48 floats
// read per 128 FMAs) and an 8 x 8 tile of the output (16 per 64); every
// shared read is a float4, and the 8 lanes that read K rows in one phase
// hit distinct banks. A row's max and sum are reduced over its 16 lanes
// with warp shuffles. 203 KB of shared memory at D = 128: one block per
// SM.
//
// C entry points: flash_attention_bf16 / flash_attention_f32 launch on the
// given stream, computing their shared memory themselves, and return a
// CUDA error code (0 on success; ERR_* below for the tensor maps);
// flash_attention_info_{bf16,f32} report what the wrapper needs to know of
// the instantiation it launches (tiles, shared memory, occupancy).

#include <cuda.h>  // CUtensorMap and its enums (no driver calls)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float NEG = -1e30f;
// Errors beside the CUDA runtime's codes.
constexpr int ERR_NO_ENCODER = 20000;  // cuTensorMapEncodeTiled unreachable
constexpr int ERR_REGISTERS = 20001;   // compiled below the setmaxnreg budget
constexpr int ERR_ENCODE = 10000;      // + the CUresult of a failed encode

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element strides of q, k and v: (batch, head, row, column) each.
struct Strides {
  long long qb, qh, ql, qd, kb, kh, kl, kd, vb, vh, vl, vd;
};

// ================================================================ f32 path

namespace f32 {

constexpr int THREADS = 256;  // 16 row groups x 16 lanes
constexpr int BQ = 128;       // queries per block
constexpr int BK = 64;        // keys per KV tile
constexpr int PP = BQ + 4;    // row stride of the transposed P tile

__host__ __device__ inline int dpad_of(int d) { return (d + 3) & ~3; }
// Row stride of the Q, K and V tiles in floats: >= dpad, a multiple of 4
// (16-byte rows) and 4 mod 8, so 8 lanes reading one column of 8
// consecutive rows touch 8 distinct groups of 4 banks.
__host__ __device__ inline int dp_of(int d) { return (dpad_of(d) & ~7) + 4; }
// Floats of one K stage: the K tile, and then P transposed over it.
__host__ __device__ inline int kstage_of(int d) {
  return BK * (dp_of(d) > PP ? dp_of(d) : PP);
}
__host__ __device__ inline int smem_bytes(int d) {
  return 4 * (BQ * dp_of(d) + 2 * kstage_of(d) + 2 * BK * dp_of(d));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying rows [r0, r0 + R) of an [rows, d] operand (strides sr, sd)
// into a shared [R][dp] tile; zeros past `rows` and in columns [d, dpad).
template <int R, bool VEC>
__device__ __forceinline__ void load_async(float* dst,
                                           const float* __restrict__ src,
                                           long long sr, long long sd, int r0,
                                           int rows, int d, int dp) {
  const int dpad = dpad_of(d);
  if (VEC) {  // sd == 1, d % 4 == 0, rows 16-byte aligned
    const int c4 = dpad >> 2;
    for (int e = threadIdx.x; e < R * c4; e += THREADS) {
      const int r = e / c4, c = (e - r * c4) << 2;
      const bool ok = r0 + r < rows;
      cp_async16(dst + r * dp + c, ok ? src + (r0 + r) * sr + c : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * dpad; e += THREADS) {
      const int r = e / dpad, c = e - r * dpad;
      const bool ok = r0 + r < rows && c < d;
      cp_async4(dst + r * dp + c, ok ? src + (r0 + r) * sr + c * sd : src,
                ok ? 4 : 0);
    }
  }
}

// plan: items [n_items][3] (query tile, first KV tile, end KV tile), then
// query tiles [n_qt][2] (first item, number of items); a query tile's
// items are consecutive. Grid (B·Hq, n_items). Thread (ty, tx) = (tid /
// 16, tid % 16) owns rows ty·8 .. ty·8 + 7, keys tx + 16j (j < 4) of each
// tile and output columns tx·4 + 64c (c < KC; D <= 64·KC).
template <int KC, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
    partial_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ ws, float* __restrict__ ws_ml,
                   const int* __restrict__ plan, int n_items, int hq, int hkv,
                   int lq, int lk, int d, int causal, int window, float scale,
                   Strides st) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int dp = dp_of(d), dpad = dpad_of(d), ks = kstage_of(d);
  float* const Qs = smem;              // [BQ][dp]
  float* const Ks = Qs + BQ * dp;      // [2] stages: K [BK][dp], then P
  float* const Vs = Ks + 2 * ks;       // [2][BK][dp]

  const int bh = blockIdx.x, item = blockIdx.y;
  const int qt = plan[3 * item], t0 = plan[3 * item + 1],
            t1 = plan[3 * item + 2];
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ, offset = lk - lq;
  const int rw = (threadIdx.x >> 4) * 8;  // this thread's rows rw .. rw+7
  const int tx = threadIdx.x & 15;

  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + hk * st.kh;
  const float* vp = v + b * st.vb + hk * st.vh;

  load_async<BQ, VEC>(Qs, qp, st.ql, st.qd, q0, lq, d, dp);
  if (t0 < t1) {
    load_async<BK, VEC>(Ks, kp, st.kl, st.kd, t0 * BK, lk, d, dp);
    load_async<BK, VEC>(Vs, vp, st.vl, st.vd, t0 * BK, lk, d, dp);
  }
  cp_commit();

  float m[8], l[8], acc[8][4 * KC];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * KC; ++c) acc[a][c] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int buf = (t - t0) & 1;
    float* const Kb = Ks + buf * ks;
    const float* Vb = Vs + buf * BK * dp;
    cp_wait_all();    // this tile has landed
    __syncthreads();  // ... for every thread; the other stage is free
    if (t + 1 < t1) {  // the next tile's copies overlap this tile's math
      load_async<BK, VEC>(Ks + (buf ^ 1) * ks, kp, st.kl, st.kd,
                          (t + 1) * BK, lk, d, dp);
      load_async<BK, VEC>(Vs + (buf ^ 1) * BK * dp, vp, st.vl, st.vd,
                          (t + 1) * BK, lk, d, dp);
      cp_commit();
    }

    float s[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < dpad; dd += 4) {
      float4 kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kb[j] = *reinterpret_cast<const float4*>(Kb + (tx + 16 * j) * dp + dd);
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float4 qa =
            *reinterpret_cast<const float4*>(Qs + (rw + a) * dp + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[a][j] = fmaf(qa.x, kb[j].x, s[a][j]);
          s[a][j] = fmaf(qa.y, kb[j].y, s[a][j]);
          s[a][j] = fmaf(qa.z, kb[j].z, s[a][j]);
          s[a][j] = fmaf(qa.w, kb[j].w, s[a][j]);
        }
      }
    }
    __syncthreads();  // K is read: P goes over it

    const int k0 = t * BK;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int qpos = q0 + rw + a + offset;
      float mx = minus_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[a][j] * scale;
        if (causal && kpos > qpos) x = NEG;
        if (window && kpos <= qpos - window) x = NEG;
        if (kpos >= lk) x = minus_inf();  // past the keys: probability 0
        s[a][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float alpha = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[a][j] = expf(s[a][j] - m_new);
        rs += s[a][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = alpha * l[a] + rs;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * KC; ++c) acc[a][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* const pt = Kb + (tx + 16 * j) * PP + rw;
      *reinterpret_cast<float4*>(pt) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(pt + 4) =
          make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    __syncthreads();  // P is complete

    const int jn = min(BK, lk - k0);
    for (int j = 0; j < jn; ++j) {
      const float4 p0 = *reinterpret_cast<const float4*>(Kb + j * PP + rw);
      const float4 p1 =
          *reinterpret_cast<const float4*>(Kb + j * PP + rw + 4);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int col = tx * 4 + 64 * c;
        if (col >= dpad) break;
        const float4 vv =
            *reinterpret_cast<const float4*>(Vb + j * dp + col);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          acc[a][4 * c + 0] = fmaf(p[a], vv.x, acc[a][4 * c + 0]);
          acc[a][4 * c + 1] = fmaf(p[a], vv.y, acc[a][4 * c + 1]);
          acc[a][4 * c + 2] = fmaf(p[a], vv.z, acc[a][4 * c + 2]);
          acc[a][4 * c + 3] = fmaf(p[a], vv.w, acc[a][4 * c + 3]);
        }
      }
    }
  }

  const bool whole = plan[3 * n_items + 2 * qt + 1] == 1;  // one range
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = q0 + rw + a;
    if (row >= lq) continue;
    if (whole) {
      float* op = o + ((long long)bh * lq + row) * d;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int col = tx * 4 + 64 * c;
        if (VEC && col < d) {
          *reinterpret_cast<float4*>(op + col) =
              make_float4(acc[a][4 * c] / l[a], acc[a][4 * c + 1] / l[a],
                          acc[a][4 * c + 2] / l[a], acc[a][4 * c + 3] / l[a]);
        } else if (!VEC) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < d) op[col + e] = acc[a][4 * c + e] / l[a];
        }
      }
    } else {
      const long long r = ((long long)bh * n_items + item) * BQ + rw + a;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int col = tx * 4 + 64 * c;
        if (col < dpad)
          *reinterpret_cast<float4*>(ws + r * dpad + col) =
              make_float4(acc[a][4 * c], acc[a][4 * c + 1], acc[a][4 * c + 2],
                          acc[a][4 * c + 3]);
      }
      if (tx == 0) {
        ws_ml[2 * r] = m[a];
        ws_ml[2 * r + 1] = l[a];
      }
    }
  }
}

// Merge the ranges of each query tile that has more than one: grid (B·Hq,
// n_qt, BQ / MR), MR rows a block. The first MR threads turn each range's
// (m, l) into its weight for their row, exp(m - max) / sum, kept in
// shared memory [count][MR]; then every thread sums weighted float4s of
// the ranges' partial outputs.
constexpr int MR = 32;

__global__ void __launch_bounds__(THREADS)
    merge_kernel(const float* __restrict__ ws,
                 const float* __restrict__ ws_ml,
                 const int* __restrict__ plan, int n_items,
                 float* __restrict__ o, int lq, int d) {
  extern __shared__ float w[];
  const int bh = blockIdx.x, qt = blockIdx.y, r0 = blockIdx.z * MR;
  const int first = plan[3 * n_items + 2 * qt];
  const int count = plan[3 * n_items + 2 * qt + 1];
  const int q0 = qt * BQ;
  if (count < 2 || q0 + r0 >= lq) return;
  const long long base = (long long)bh * n_items + first;
  if (threadIdx.x < MR) {
    const int r = r0 + threadIdx.x;
    float mx = minus_inf();
    for (int i = 0; i < count; ++i)
      mx = fmaxf(mx, ws_ml[2 * ((base + i) * BQ + r)]);
    float den = 0.f;
    for (int i = 0; i < count; ++i) {
      const long long row = (base + i) * BQ + r;
      const float e = expf(ws_ml[2 * row] - mx);
      w[i * MR + threadIdx.x] = e;
      den = fmaf(e, ws_ml[2 * row + 1], den);
    }
    const float inv = 1.f / den;
    for (int i = 0; i < count; ++i) w[i * MR + threadIdx.x] *= inv;
  }
  __syncthreads();
  const int dpad = dpad_of(d), c4 = dpad >> 2;
  for (int e = threadIdx.x; e < MR * c4; e += THREADS) {
    const int rr = e / c4, c = (e - rr * c4) << 2;
    const int row = q0 + r0 + rr;
    if (row >= lq) break;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < count; ++i) {
      const float wi = w[i * MR + rr];
      const float4 a = *reinterpret_cast<const float4*>(
          ws + ((base + i) * BQ + r0 + rr) * dpad + c);
      sum.x = fmaf(wi, a.x, sum.x);
      sum.y = fmaf(wi, a.y, sum.y);
      sum.z = fmaf(wi, a.z, sum.z);
      sum.w = fmaf(wi, a.w, sum.w);
    }
    float* const op = o + ((long long)bh * lq + row) * d + c;
    if (!(d & 3)) {
      *reinterpret_cast<float4*>(op) = sum;
    } else {
      const float v4[4] = {sum.x, sum.y, sum.z, sum.w};
      for (int j = 0; j < 4 && c + j < d; ++j) op[j] = v4[j];
    }
  }
}

template <int KC, bool VEC>
int launch(const float* q, const float* k, const float* v, float* o,
           float* ws, float* ws_ml, const int* plan, int n_items, int n_qt,
           int max_count, int batch, int hq, int hkv, int lq, int lk, int d,
           int causal, int window, float scale, const Strides& st,
           cudaStream_t s) {
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel<KC, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  partial_kernel<KC, VEC><<<dim3(batch * hq, n_items), THREADS, smem, s>>>(
      q, k, v, o, ws, ws_ml, plan, n_items, hq, hkv, lq, lk, d, causal, window,
      scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess || max_count < 2) return static_cast<int>(err);
  const int wbytes = 4 * MR * max_count;
  err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wbytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<dim3(batch * hq, n_qt, BQ / MR), THREADS, wbytes, s>>>(
      ws, ws_ml, plan, n_items, o, lq, d);
  return static_cast<int>(cudaGetLastError());
}

template <int KC, bool VEC>
int info(int d, int* out) {
  const int smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      partial_kernel<KC, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, partial_kernel<KC, VEC>, THREADS, smem);
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, partial_kernel<KC, VEC>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = smem;
  out[4] = BQ;
  out[5] = BK;
  return 0;
}

}  // namespace f32

// =============================================================== bf16 path

namespace bf16 {

constexpr int THREADS = 384;  // a producer warpgroup and two consumers
constexpr int BQ = 128;       // queries per block, 64 per consumer
constexpr int BK = 128;       // keys per KV tile
constexpr int STAGES = 2;     // K and V tiles in flight
constexpr int BOX = 128 * 128;  // bytes of one [128 rows][64 columns] box
// The registers a thread is launched with (65 536 / 384, in steps of 8),
// and what setmaxnreg moves: 128 x (168 - 24) = 256 x (240 - 168).
constexpr int LAUNCH_REGS = 168;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// Shared memory of a block with NB 64-column blocks of D: Q [NB][BQ][64],
// K and V [STAGES][NB][BK][64] (each box 1024-byte aligned for the 128-byte
// swizzle), 9 mbarriers, and 1 KB of slack to align the dynamic base.
__host__ __device__ constexpr int smem_bytes(int nb) {
  return 1024 + (BQ + 2 * STAGES * BK) * nb * 128 + 8 * (1 + 4 * STAGES);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units. K-major (Q, K): the stride
// offset steps 8 rows (1024 B), the leading offset is unused. MN-major (V):
// the leading offset steps from one 64-column block to the next, the
// stride offset 8 rows along K.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

#define F8(i)                                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64] (+)= A · B, m64n128k16: A and B from shared memory (descriptors),
// both K-major; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24),
        F8(32), F8(40), F8(48), F8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64] += A · B, m64n128k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24),
        F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A · B, m64n64k16: A (bf16 pairs) from registers, B from
// shared memory, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef F8

// Grid (B·Hq, ceil(Lq / BQ)), query tiles issued latest first (the longest
// causal walks start first). NB: 64-column blocks of D (1: D <= 64, 2: D
// <= 128); columns past D arrive as zeros and are never stored.
template <int NB>
__global__ void __launch_bounds__(THREADS, 1)
    fa_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              __nv_bfloat16* __restrict__ o, int hq, int hkv, int lq, int lk,
              int d, int causal, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* const Ks = Qs + NB * BOX;           // [STAGES][NB] boxes
  uint8_t* const Vs = Ks + STAGES * NB * BOX;  // [STAGES][NB] boxes
  uint64_t* const bar = reinterpret_cast<uint64_t*>(Vs + STAGES * NB * BOX);
  uint64_t* const q_full = bar;
  uint64_t* const k_full = bar + 1;               // [STAGES]
  uint64_t* const k_empty = bar + 1 + STAGES;     // [STAGES]
  uint64_t* const v_full = bar + 1 + 2 * STAGES;  // [STAGES]
  uint64_t* const v_empty = bar + 1 + 3 * STAGES;

  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh - b * hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int offset = lk - lq;  // absolute position of query 0
  int kv_end = lk;
  if (causal) kv_end = max(0, min(lk, min(q0 + BQ, lq) + offset));
  const int t_end = (kv_end + BK - 1) / BK;
  // the first tile holding a key inside the window of the block's first row
  const int t_begin =
      window ? min(t_end, max(0, q0 + offset - window + 1) / BK) : 0;
  const int n_tiles = t_end - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);  // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {  // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, NB * BOX);
      for (int c = 0; c < NB; ++c)
        tma_load(Qs + c * BOX, &tq, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        mbar_wait(k_empty + s, free_parity);
        mbar_expect_tx(k_full + s, NB * BOX);
        for (int c = 0; c < NB; ++c)
          tma_load(Ks + (s * NB + c) * BOX, &tk, k_full + s, 64 * c,
                   (t_begin + i) * BK, hk, b);
        mbar_wait(v_empty + s, free_parity);
        mbar_expect_tx(v_full + s, NB * BOX);
        for (int c = 0; c < NB; ++c)
          tma_load(Vs + (s * NB + c) * BOX, &tv, v_full + s, 64 * c,
                   (t_begin + i) * BK, hk, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows cw·64 .. cw·64 + 63 of the tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int cw = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int r0 = cw * 64 + warp * 16 + (lane >> 2);  // rows r0 and r0 + 8
  const int c2 = (lane & 3) * 2;  // column pair in each group of 8
  const int pos0 = q0 + r0 + offset;              // position of row r0
  const int wg_first = q0 + cw * 64 + offset;     // the warpgroup's first
  const int ksteps = (d + 15) >> 4;               // k16 steps of Q·Kᵀ
  const uint32_t q_base = smem_u32(Qs) + cw * 64 * 128;

  float acc[32 * NB];  // O: [64 rows][64·NB columns] as the m64n(64·NB) D
#pragma unroll
  for (int j = 0; j < 32 * NB; ++j) acc[j] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t parity = (i / STAGES) & 1;
    const uint32_t kb = smem_u32(Ks) + s * NB * BOX;
    const uint32_t vb = smem_u32(Vs) + s * NB * BOX;

    // S = Q·Kᵀ: [64 rows][128 keys], f32
    float sc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.f;
    mbar_wait(k_full + s, parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NB; ++kk) {
      if (kk < ksteps) {
        const uint32_t step = (kk >> 2) * BOX + (kk & 3) * 32;
        wgmma_ss_n128(sc, desc(q_base + step, 1, 64), desc(kb + step, 1, 64),
                      kk);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_empty + s);

    // online softmax in the log2 domain; register j holds row r0 + 8·((j
    // >> 1) & 1), key k0 + 8·(j >> 2) + c2 + (j & 1)
    const int k0 = (t_begin + i) * BK;
    const bool edge = (causal && k0 + BK - 1 > wg_first) || k0 + BK > lk ||
                      (window && k0 <= wg_first + 63 - window);
    float mx0 = minus_inf(), mx1 = minus_inf();
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      float x = sc[j] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (j >> 2) + c2 + (j & 1);
        const int qpos = pos0 + 8 * ((j >> 1) & 1);
        if (causal && kpos > qpos) x = NEG;
        if (window && kpos <= qpos - window) x = NEG;
        if (kpos >= lk) x = minus_inf();
      }
      sc[j] = x;
      if ((j >> 1) & 1)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the row's 4 lanes
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      if ((j >> 1) & 1) {
        sc[j] = exp2f(sc[j] - mn1);
        rs1 += sc[j];
      } else {
        sc[j] = exp2f(sc[j] - mn0);
        rs0 += sc[j];
      }
    }
    l0 = l0 * al0 + rs0;  // this thread's share; summed over the 4 lanes
    l1 = l1 * al1 + rs1;  // at the end
#pragma unroll
    for (int j = 0; j < 32 * NB; ++j) acc[j] *= ((j >> 1) & 1) ? al1 : al0;
    // P as bf16 A fragments: k16 step kk is S registers 8kk .. 8kk + 7
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P·V: V [128 keys][64·NB columns], MN-major
    mbar_wait(v_full + s, parity);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(pa[kk][r])::"memory");
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = desc(vb + kk * 16 * 128, BOX >> 4, 64);
      if constexpr (NB == 2)
        wgmma_rs_n128(acc, pa[kk], dv);
      else
        wgmma_rs_n64(acc, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(v_empty + s);
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* const op = o + (long long)bh * lq * d;
#pragma unroll
  for (int j = 0; j < 32 * NB; j += 2) {
    const bool lower = (j >> 1) & 1;
    const int row = q0 + r0 + (lower ? 8 : 0);
    const int col = 8 * (j >> 2) + c2;
    const float inv = lower ? inv1 : inv0;
    if (row >= lq || col >= d) continue;
    __nv_bfloat16* const p = op + (long long)row * d + col;
    if (!(d & 1)) {
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc[j] * inv, acc[j + 1] * inv);
    } else {
      p[0] = __float2bfloat16(acc[j] * inv);
      if (col + 1 < d) p[1] = __float2bfloat16(acc[j + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Tensor map of a [B, H, L, D] bf16 operand with element strides st (st[3]
// == 1): boxes of [rows][64 columns], 128-byte swizzle, zeros out of
// bounds. A dimension of size 1 is never stepped, so its stride is set to
// one past every other extent (TMA wants each a multiple of 16 bytes).
int encode(CUtensorMap* map, const void* ptr, int b, int h, int l, int d,
           const long long* st, int rows) {
  const EncodeTiled fn = encoder();
  if (!fn) return ERR_NO_ENCODER;
  const long long size[3] = {l, h, b}, step[3] = {st[2], st[1], st[0]};
  long long extent = 16;
  for (int i = 0; i < 3; ++i)
    if (size[i] > 1) extent = std::max(extent, 2 * step[i] * size[i]);
  extent = (extent + 15) & ~15ll;
  cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(l),
      static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = static_cast<cuuint64_t>(size[i] > 1 ? 2 * step[i] : extent);
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(res);
}

template <int NB>
int prepare() {
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(NB));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fa_kernel<NB>);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg.inc would wait forever for registers the producer cannot free
  return attr.numRegs >= LAUNCH_REGS ? 0 : ERR_REGISTERS;
}

template <int NB>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int hq, int hkv, int lq, int lk, int d, int causal, int window,
           float scale, const long long* st, cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int err = prepare<NB>();
  if (!err) err = encode(&tq, q, batch, hq, lq, d, st, BQ);
  if (!err) err = encode(&tk, k, batch, hkv, lk, d, st + 4, BK);
  if (!err) err = encode(&tv, v, batch, hkv, lk, d, st + 8, BK);
  if (err) return err;
  const dim3 grid(batch * hq, (lq + BQ - 1) / BQ);
  fa_kernel<NB><<<grid, THREADS, smem_bytes(NB), s>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), hq, hkv, lq, lk, d, causal,
      window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int info(int* out) {
  int err = prepare<NB>();
  if (err) return err;
  cudaFuncAttributes attr;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fa_kernel<NB>, THREADS, smem_bytes(NB));
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fa_kernel<NB>);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = smem_bytes(NB);
  out[4] = BQ;
  out[5] = BK;
  return 0;
}

}  // namespace bf16

template <int KC>
int launch_f32(int vec, const float* q, const float* k, const float* v,
               float* o, float* ws, float* ws_ml, const int* plan,
               int n_items, int n_qt, int max_count, int batch, int hq,
               int hkv, int lq, int lk, int d, int causal, int window,
               float scale, const Strides& st, cudaStream_t s) {
  const auto run = vec ? &f32::launch<KC, true> : &f32::launch<KC, false>;
  return run(q, k, v, o, ws, ws_ml, plan, n_items, n_qt, max_count, batch,
             hq, hkv, lq, lk, d, causal, window, scale, st, s);
}

}  // namespace

// window: 0, or the sliding window (a key kpos <= qpos - window is masked).
// strides: q (b, h, l, d), k (b, h, l, d), v (b, h, l, d), 12 in all; for
// bf16 each d stride is 1 and the others are multiples of 8 elements, and
// every pointer is 16-byte aligned (the wrapper copies operands that are
// not: TMA reads no other layout).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch, int hq,
                                    int hkv, int lq, int lk, int d,
                                    int causal, int window, float scale,
                                    const long long* strides, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return bf16::launch<1>(q, k, v, o, batch, hq, hkv, lq, lk, d, causal,
                           window, scale, strides, s);
  if (d <= 128)
    return bf16::launch<2>(q, k, v, o, batch, hq, hkv, lq, lk, d, causal,
                           window, scale, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// plan: the wrapper's split plan on the device (see f32::partial_kernel);
// max_count: the most ranges of one query tile (> 1: the merge runs); ws
// [B·Hq][n_items][128][dpad] and ws_ml [B·Hq][n_items][128][2] f32, used
// only when max_count > 1; vec: every operand has unit d stride, d % 4 ==
// 0 and 16-byte aligned rows.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* ws,
                                   void* ws_ml, const void* plan, int n_items,
                                   int n_qt, int max_count, int batch, int hq,
                                   int hkv, int lq, int lk, int d, int causal,
                                   int window, float scale,
                                   const long long* strides, int vec,
                                   void* stream) {
  const Strides st = {strides[0], strides[1], strides[2],  strides[3],
                      strides[4], strides[5], strides[6],  strides[7],
                      strides[8], strides[9], strides[10], strides[11]};
  const auto run = d <= 64 ? &launch_f32<1> : &launch_f32<2>;
  if (d > 128) return static_cast<int>(cudaErrorInvalidValue);
  return run(vec, static_cast<const float*>(q), static_cast<const float*>(k),
             static_cast<const float*>(v), static_cast<float*>(o),
             static_cast<float*>(ws), static_cast<float*>(ws_ml),
             static_cast<const int*>(plan), n_items, n_qt, max_count, batch,
             hq, hkv, lq, lk, d, causal, window, scale, st,
             static_cast<cudaStream_t>(stream));
}

// info[6] of the instantiation launched at head dim d (f32: with 16-byte
// loads): resident blocks per SM, registers per thread, spill bytes per
// thread, dynamic shared memory bytes, queries per block, keys per KV
// tile. Returns an error code (0 on success).
extern "C" int flash_attention_info_bf16(int d, int* info) {
  if (d <= 64) return bf16::info<1>(info);
  if (d <= 128) return bf16::info<2>(info);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_attention_info_f32(int d, int* info) {
  if (d <= 64) return f32::info<1, true>(d, info);
  if (d <= 128) return f32::info<2, true>(d, info);
  return static_cast<int>(cudaErrorInvalidValue);
}
