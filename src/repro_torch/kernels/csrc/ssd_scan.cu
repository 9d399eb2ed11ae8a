// Mamba-2 SSD chunked scan for Hopper (sm_90a); f32 and bf16.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan/
// ssd_scan.py:68, body `_ssd_kernel` at :29), which the model reaches from
// `mamba2_forward` (src/repro/models/mamba2.py:71) through `ops.ssd`. There
// the grid is (B·H, L/Q) and the [N, P] state rides in VMEM scratch across
// the sequential chunk axis. Blocks on Hopper run in no order and share
// nothing, so here one block owns one (batch·head, 64-wide slice of P) and
// walks the chunks in a loop of its own, with the state in shared memory.
// Columns of P are independent (y[:, p] needs only x[:, p] and h[:, p]), so
// P wider than 64 is split across blocks.
//
// What it computes, per chunk of Q tokens, with da = dt·A, cum = the
// inclusive cumsum of da over the chunk and xdt = dt·x:
//   intra:  y  = ((C Bᵀ) ⊙ L) xdt      L_ij = exp(cum_i − cum_j), j <= i
//   inter:  y += exp(cum) ⊙ (C h)
//   skip:   y += x · D                  (outside the TPU kernel, :107-108)
//   state:  h  = exp(cum_Q) h + Bᵀ (xdt ⊙ exp(cum_Q − cum))
// L_ij is formed only for j <= i: for j > i its exponent is positive and
// overflows. Head h reads B and C of group h / (H / G) (ssd_scan.py:88-90).
// x, dt, B and C are read through their own strides in their [B, L, H, P] /
// [B, L, H] / [B, L, G, N] layouts (the model passes views of one
// projection), so neither the transpose copies of ssd_scan.py:80-83 nor a
// repeat of B and C over heads is made. dt·x and the skip are formed in f32
// from the stored operands and y is rounded once, as the plain version
// (`ssd_chunked_ref`) does; the TPU path rounds dt·x to the input type
// first, which only bf16 notices. A ragged last chunk (L not a multiple of
// Q) is masked: its missing rows carry dt = x = B = C = 0, which leaves the
// state and the cumsum unchanged.
//
// What bounds it on this card (H100 SXM): at mamba2-1.3b prefill (B 4,
// L 2048, H 64, P 64, N 128, Q 128, bf16) one call moves ~140 MB (x and y
// are 67 MB each) in 0.04 ms at 3.35 TB/s, and does 256 (b, h) x 16 chunks
// x ~7 MFLOP of chunk products (the causal half of C Bᵀ and of its product
// with xdt, plus C h and Bᵀ xdt) = 29 GFLOP, 0.43 ms at the 67 TFLOP/s of
// f32 on the CUDA cores: operations bound it. The tensor cores would lift
// that bound for bf16 (989 TFLOP/s); this first kernel does its math in
// f32 on the CUDA cores, as the reference does.
//
// What the design does about it: the chunk's B and C stay in shared memory
// in their input type (f32 tiles of B, C and the Q x Q scores at Q = N =
// 128 would not fit the 227 KB a block may use), with xdt and the state in
// f32: 210 KB for f32 and 146 KB for bf16 at the model's widths. The
// scores are formed 32 query rows at a time, only up to the causal bound,
// and consumed at once. Each thread keeps register tiles (4 x 4 scores,
// 4 x 2 outputs, 16 x 2 state entries), so each shared value read feeds
// several FMAs; B's and C's rows are padded so reads across lanes are
// conflict-free, and reads along a row are warp broadcasts. The chunk's
// cumsum is a warp-shuffle scan. Tensor cores (wgmma), TMA and overlap of
// the next chunk's loads are left for later work.
//
// C entry points: ssd_scan_f32 / ssd_scan_bf16 launch on the given stream
// with the given dynamic shared memory and return cudaGetLastError() (0 on
// success). y is written contiguous [B, L, H, P] in x's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int PT = 64;        // columns of P per block
constexpr int RT = 32;        // query rows of scores formed at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Row stride of the shared B and C tiles, in elements: odd in 32-bit words,
// so lanes reading one column of consecutive rows hit distinct banks.
template <typename T>
__host__ __device__ constexpr int bc_stride(int n) {
  return sizeof(T) == 4 ? n + 1 : n + 2;
}

// Scores of this warp's 4 rows against KC groups of 32 columns from jb:
// St[i][j] = (C_i · B_j) exp(cum_i - cum_j) for j <= i, else 0, for the
// columns j < jmax. Rows (row[], clamped into the chunk) are warp-uniform,
// so C is read as a broadcast; lanes take consecutive columns of B.
template <typename T, int KC>
__device__ __forceinline__ void scores(float* St, const T* Bs, const T* Cs,
                                       const float* cum, const int* row,
                                       int r0, int jb, int jmax, int nb,
                                       int sq, int N, int Q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int col[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) col[k] = min(jb + lane + 32 * k, Q - 1);
  float s[4][KC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < KC; ++k) s[i][k] = 0.f;
  for (int n = 0; n < N; ++n) {
    float ci[4], bj[KC];
#pragma unroll
    for (int i = 0; i < 4; ++i) ci[i] = to_float(Cs[row[i] * nb + n]);
#pragma unroll
    for (int k = 0; k < KC; ++k) bj[k] = to_float(Bs[col[k] * nb + n]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < KC; ++k) s[i][k] = fmaf(ci[i], bj[k], s[i][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ii = warp * 4 + i, gi = r0 + ii;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int j = jb + lane + 32 * k;
      if (j < jmax)
        St[ii * sq + j] =
            j <= gi ? s[i][k] * expf(cum[row[i]] - cum[j]) : 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ c, const float* __restrict__ dskip,
               T* __restrict__ y, int L, int H, int G, int P, int N, int Q,
               long long sxb, long long sxl, long long sxh, long long sxp,
               long long sdb, long long sdl, long long sdh, long long sbb,
               long long sbl, long long sbg, long long sbn, long long scb,
               long long scl, long long scg, long long scn) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = bc_stride<T>(N);
  const int sq = Q + 1;                   // row stride of the scores
  float* Xs = reinterpret_cast<float*>(smem_raw);  // [Q][PT]  dt·x
  float* Hs = Xs + Q * PT;                // [N][PT]  state
  float* St = Hs + N * PT;                // [RT][sq] scores
  float* cum = St + RT * sq;              // [Q]
  float* wsum = cum + Q;                  // [8] per-warp scan totals
  T* Bs = reinterpret_cast<T*>(wsum + 8);  // [Q][nb]
  T* Cs = Bs + Q * nb;                    // [Q][nb]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bi = blockIdx.x / H, h = blockIdx.x - bi * H;
  const int g = h / (H / G);
  const int p0 = blockIdx.y * PT;
  const int pt = min(PT, P - p0);
  const float ah = a[h];
  const float dh = dskip != nullptr ? dskip[h] : 0.f;
  const T* xb = x + bi * sxb + h * sxh + p0 * sxp;
  const T* db = dt + bi * sdb + h * sdh;
  const T* bb = b + bi * sbb + g * sbg;
  const T* cb = c + bi * scb + g * scg;
  T* yb = y + ((long long)bi * L * H + h) * P + p0;  // y[bi, t, h, p0 + p]
  const long long syl = (long long)H * P;

  for (int e = tid; e < N * PT; e += THREADS) Hs[e] = 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int qv = min(Q, L - t0);  // rows of this chunk inside L
    __syncthreads();  // the previous chunk's state update has read B and xdt

    for (int e = tid; e < Q * N; e += THREADS) {
      const int r = e / N, n = e - r * N;
      T bv = from_float<T>(0.f), cv = from_float<T>(0.f);
      if (r < qv) {
        bv = bb[(t0 + r) * sbl + n * sbn];
        cv = cb[(t0 + r) * scl + n * scn];
      }
      Bs[r * nb + n] = bv;
      Cs[r * nb + n] = cv;
    }
    for (int e = tid; e < Q * PT; e += THREADS) {
      const int r = e / PT, p = e - r * PT;
      float xv = 0.f;
      if (r < qv && p < pt)
        xv = to_float(xb[(t0 + r) * sxl + p * sxp]) *
             to_float(db[(t0 + r) * sdl]);
      Xs[e] = xv;
    }
    // inclusive cumsum of da over the chunk (Q <= THREADS)
    float da = tid < qv ? to_float(db[(t0 + tid) * sdl]) * ah : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, da, off);
      if (lane >= off) da += o;
    }
    if (lane == 31) wsum[warp] = da;
    __syncthreads();
    if (tid < Q) {
      for (int w = 0; w < warp; ++w) da += wsum[w];
      cum[tid] = da;
    }
    __syncthreads();

    for (int r0 = 0; r0 < qv; r0 += RT) {
      // this warp's rows of the tile, clamped into the chunk for reading
      int row[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) row[i] = min(r0 + warp * 4 + i, Q - 1);

      // (1) the scores of rows r0 .. r0 + RT - 1, for the columns j < jmax
      //     that they can need (j <= i)
      const int jmax = min(r0 + RT, qv);
      for (int jb = 0; jb < jmax; jb += 128) {
        const int kc = min(4, (jmax - jb + 31) / 32);  // column groups
        if (kc == 1)
          scores<T, 1>(St, Bs, Cs, cum, row, r0, jb, jmax, nb, sq, N, Q);
        else if (kc == 2)
          scores<T, 2>(St, Bs, Cs, cum, row, r0, jb, jmax, nb, sq, N, Q);
        else if (kc == 3)
          scores<T, 3>(St, Bs, Cs, cum, row, r0, jb, jmax, nb, sq, N, Q);
        else
          scores<T, 4>(St, Bs, Cs, cum, row, r0, jb, jmax, nb, sq, N, Q);
      }
      __syncthreads();

      // (2) y rows: intra-chunk from the scores, inter-chunk from the state
      float acc[4][2], inter[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 2; ++k) acc[i][k] = inter[i][k] = 0.f;
      const int jend = min(r0 + warp * 4 + 4, qv);  // scores vanish past i
      for (int j = 0; j < jend; ++j) {
        float si[4], xj[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) si[i] = St[(warp * 4 + i) * sq + j];
#pragma unroll
        for (int k = 0; k < 2; ++k) xj[k] = Xs[j * PT + lane + 32 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k) acc[i][k] = fmaf(si[i], xj[k], acc[i][k]);
      }
      for (int n = 0; n < N; ++n) {
        float ci[4], hn[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) ci[i] = to_float(Cs[row[i] * nb + n]);
#pragma unroll
        for (int k = 0; k < 2; ++k) hn[k] = Hs[n * PT + lane + 32 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            inter[i][k] = fmaf(ci[i], hn[k], inter[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gi = r0 + warp * 4 + i;
        if (gi >= qv) continue;
        const float e = expf(cum[gi]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int p = lane + 32 * k;
          if (p >= pt) continue;
          float out = fmaf(e, inter[i][k], acc[i][k]);
          if (dskip != nullptr)
            out = fmaf(to_float(xb[(t0 + gi) * sxl + p * sxp]), dh, out);
          yb[(t0 + gi) * syl + p] = from_float<T>(out);
        }
      }
      __syncthreads();  // St is rewritten by the next row tile
    }

    // state: h = exp(cum_last) h + Bᵀ (xdt ⊙ exp(cum_last - cum))
    const float clast = cum[qv - 1];
    for (int e = tid; e < qv * PT; e += THREADS)
      Xs[e] *= expf(clast - cum[e / PT]);
    __syncthreads();
    const float decay = expf(clast);
    for (int n0 = 0; n0 < N; n0 += 128) {
      int nrow[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) nrow[i] = min(n0 + warp + 8 * i, N - 1);
      float hacc[16][2];
#pragma unroll
      for (int i = 0; i < 16; ++i) hacc[i][0] = hacc[i][1] = 0.f;
      for (int j = 0; j < qv; ++j) {
        const float x0 = Xs[j * PT + lane], x1 = Xs[j * PT + lane + 32];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float bv = to_float(Bs[j * nb + nrow[i]]);
          hacc[i][0] = fmaf(bv, x0, hacc[i][0]);
          hacc[i][1] = fmaf(bv, x1, hacc[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = n0 + warp + 8 * i;
        if (n >= N) continue;
        float* hp = Hs + n * PT + lane;
        hp[0] = fmaf(decay, hp[0], hacc[i][0]);
        hp[32] = fmaf(decay, hp[32], hacc[i][1]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, const void* d, void* y, int batch, int L, int H,
           int G, int P, int N, int Q, const long long* st, int smem,
           void* stream) {
  if (Q < 1 || Q > THREADS || G < 1 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * H, (P + PT - 1) / PT);
  ssd_kernel<T><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d),
      static_cast<T*>(y), L, H, G, P, N, Q, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: x (b, l, h, p), dt (b, l, h), B (b, l, g, n), C (b, l, g, n),
// 15 in all. d may be null (no skip).
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* a,
                            const void* b, const void* c, const void* d,
                            void* y, int batch, int L, int H, int G, int P,
                            int N, int Q, const long long* strides, int smem,
                            void* stream) {
  return launch<float>(x, dt, a, b, c, d, y, batch, L, H, G, P, N, Q, strides,
                       smem, stream);
}

extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* a,
                             const void* b, const void* c, const void* d,
                             void* y, int batch, int L, int H, int G, int P,
                             int N, int Q, const long long* strides, int smem,
                             void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, b, c, d, y, batch, L, H, G, P, N, Q,
                               strides, smem, stream);
}
