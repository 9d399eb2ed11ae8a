// Mamba-2 SSD chunked scan for Hopper (sm_90a): chunk-parallel, bf16
// products on the tensor cores, f32 in IEEE f32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan/
// ssd_scan.py:68, body `_ssd_kernel` at :29), which the model reaches from
// `mamba2_forward` (src/repro/models/mamba2.py:71) through `ops.ssd`. There
// the grid is (B·H, L/Q) and the [N, P] state rides in VMEM scratch across
// the sequential chunk axis. Blocks on Hopper run in no order and share
// nothing, and one block per (batch, head) walking its chunks in series
// leaves the card waiting on latency (256 such blocks, 1.94 waves, at
// mamba2-1.3b's layer). So the chunks run in parallel, and only the walk of
// the state through the chunks is sequential, tile by tile of the state.
//
// What it computes, per chunk c of Q rows, with cum = the inclusive cumsum
// of dt·A over the chunk (cum_Q its last entry), H_c the state entering
// chunk c (H_0 = 0) and S_c the chunk's own end state:
//   y  = ((C Bᵀ) ⊙ L ⊙ dt_j) x + exp(cum_i) ⊙ (C H_c) + D x,
//        L_ij = exp(cum_i − cum_j) for j <= i, else 0
//   S_c = Bᵀ diag(dt ⊙ exp(cum_Q − cum)) x,   H_{c+1} = exp(cum_Q) H_c + S_c
// which is the reference's chunk step with dt·x split into its factors.
// Head h reads B and C of group h / (H / G) (ssd_scan.py:88-90), and the D
// skip of ssd_scan.py:107-108 is added in the same pass.
//
// Four kernels a call (three when the sequence is one chunk):
//   ssd_cumsum  per (batch, head, chunk), one warp: dt as f32 and cum into
//               scratch, padded to whole 64-row tiles (rows past the chunk
//               or past L carry dt = 0, which leaves cum unchanged);
//   ssd_cb      per (batch, group, chunk, 64 x 64 tile on or below the
//               diagonal): C Bᵀ in f32, once per group and not per head;
//   ssd_state   per (batch, head, 64 x 64 tile of [N, P]): the chunks but
//               the last in order, each chunk's rows in 64-row tiles. The
//               tile of the state lives in the block's accumulators: at a
//               chunk's start it is scaled by exp(cum_Q), then S_c is summed
//               into it on the tensor cores, and H_{c+1} is written in x's
//               type. So S_c never reaches device memory (126 MB of f32
//               at mamba2-1.3b's layer; a kernel writing it for an
//               elementwise hand-off pass was slower, PERF.md), and the
//               hand-off costs no pass of its own;
//   ssd_out     per (batch, head, chunk, 64 query rows, 64 columns of P):
//               the C H_c tiles over N, then the causal tiles of the
//               scores times x, then the skip; y written once.
// bf16: the four products (C Bᵀ; Bᵀ times the scaled x for S_c; C H_c;
// the scores times x) run on mma.sync.m16n8k16 (HMMA, bf16 in, f32
// accumulate), fragments by ldmatrix (.trans where a tile's contiguous
// dimension is the product's inner one). Operands that are bf16 in memory
// (B, C, x) go to the tensor cores as they are; each per-row factor is
// applied in f32 and the result rounded to bf16 once, where it becomes an
// operand. The roundings, beyond the one of y that every bf16 output has:
//   1. the scores (C Bᵀ) ⊙ L ⊙ dt_j (C Bᵀ itself is kept in f32);
//   2. x ⊙ dt_j ⊙ exp(cum_Q − cum_j), the B operand of S_c;
//   3. H_c, stored in bf16 by ssd_state as the B operand of C H_c (the
//      state carried from chunk to chunk stays f32).
// `ssd_bf16_operands_ref` (kernels/ssd_scan/ref.py) applies the same three,
// and scripts/torch_ssd_rounding.py measures them. exp is __expf there.
// f32: the same kernels with IEEE f32 FMAs on the CUDA cores (no TF32: the
// reference's tolerance is 2e-4), each thread an 8 x 4 register tile of
// the output, and expf.
//
// What bounds it on this card (H100 SXM): at mamba2-1.3b prefill (B 4,
// L 2048, H 64, P 64, G 1, N 128, Q 128, bf16) a call must move ~140 MB (x
// and y 67 MB each), 0.042 ms at 3.35 TB/s, and do 21.5 GFLOP (C Bᵀ once
// per group, the rest per head), 0.022 ms on the tensor cores: bytes bound
// it. The design adds its scratch: the states H entering chunks 1..15 in
// bf16 (4·64·15·128·64·2 B = 63 MB), C Bᵀ (4.2 MB) and dt and cum (2.1 MB
// each); H is written once and read by both 64-row tiles of a chunk (the
// second from L2), so ~0.13 GB beyond the call's own 0.14 GB: ~0.08 ms at
// 3.35 TB/s is this design's floor. C Bᵀ is read from L2 by every head of
// its group. In f32 the products are 21.5 GFLOP at 67 TFLOP/s, 0.32 ms.
//
// C entry points: ssd_scan_f32 / ssd_scan_bf16 launch the kernels on the
// given stream and return cudaGetLastError() (0 on success); the wrapper
// allocates the scratch and passes its pieces. ssd_scan_info_{f32,bf16}
// report each kernel's registers, spill bytes, resident blocks per SM and
// shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // rows and columns of every tile
constexpr int THREADS = 128;   // 4 warps; bf16: 16 rows of a tile a warp
constexpr int VEC_BYTES = 2 * TILE * 4;   // cum and dt of a 64-row tile
// Depth of each kernel's ring of shared tiles (scripts/torch_ssd_variants.py
// times rings of 3: slower, with fewer blocks resident per SM).
constexpr int CB_STAGES = 2;
constexpr int STATE_STAGES = 2;
constexpr int OUT_STAGES = 2;

// Row pitch of a shared tile, in elements: 8 of padding keeps rows 16-byte
// aligned for cp.async; in bf16 (16 bytes) ldmatrix then reads 8 rows
// conflict-free, in f32 (32 bytes) so do the float2 reads of 4 rows x 4
// lanes that build ssd_out's score fragments.
constexpr int PT = TILE + 8;
template <typename T>
__host__ __device__ constexpr int tile_bytes() {
  return TILE * PT * static_cast<int>(sizeof(T));
}
constexpr int FTILE = tile_bytes<float>();    // an f32 tile (C Bᵀ)

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of each kernel: its ring's stages (ssd_state's also hold
// the chunk's cum_Q), and ssd_out's rows' cum.
template <typename T>
__host__ __device__ constexpr int cb_smem() {
  return CB_STAGES * 2 * tile_bytes<T>();
}
template <typename T>
__host__ __device__ constexpr int state_stage() {
  return 2 * tile_bytes<T>() + VEC_BYTES + 16;
}
template <typename T>
__host__ __device__ constexpr int state_smem() {
  return STATE_STAGES * state_stage<T>() + tile_bytes<T>();
}
template <typename T>
__host__ __device__ constexpr int out_stage() {
  return imax(tile_bytes<T>(), FTILE) + tile_bytes<T>() + VEC_BYTES;
}
template <typename T>
__host__ __device__ constexpr int out_smem() {
  return OUT_STAGES * out_stage<T>() + TILE * 4;
}

template <typename T>
struct Params {
  const T* x;
  const T* dt;
  const float* a;
  const T* b;
  const T* c;
  const float* d;   // may be null: no skip
  T* y;             // contiguous [B, L, H, P]
  float* dtc;       // [B·H][nc][Qp]
  float* cum;       // [B·H][nc][Qp]
  float* cb;        // [B·G][nc][Qp][Qp]
  T* h;             // [B·H][nc - 1][Npd][Ppd], slot c holds H_{c+1}
  int batch, L, H, G, P, N, Q;
  int Qp, nc, Npd, Ppd;       // Q, N, P padded to whole tiles; chunks
  int vx, vb, vc;             // 16-byte copies of x, B, C
  long long sxb, sxl, sxh, sxp, sdb, sdl, sdh;
  long long sbb, sbl, sbg, sbn, scb, scl, scg, scn;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ float ex(float v) {
  if constexpr (sizeof(T) == 2) return __expf(v);
  else return expf(v);
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [0, vr) and columns [0, vc) of the 64 x 64 tile at `src` (row
// stride rs, column stride cs, in elements) into shared `dst`, the rest of
// the tile zero. vec: 16-byte cp.async (cs == 1, vc a multiple of 16 /
// sizeof(T), 16-byte aligned rows); else element loads. `safe` is a valid
// address for the zero-filling copies, which read nothing.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          long long cs, int vr, int vc,
                                          bool vec, const T* safe) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), CPR = TILE / E;
#pragma unroll
    for (int k = 0; k < TILE * CPR / THREADS; ++k) {
      const int e = threadIdx.x + THREADS * k;
      const int r = e / CPR, col = (e % CPR) * E;
      const bool live = r < vr && col < vc;
      cp_async16(dst + r * PT + col, live ? src + r * rs + col : safe, live);
    }
  } else {
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, col = e % TILE;
      dst[r * PT + col] = (r < vr && col < vc) ? src[r * rs + col * cs]
                                               : from_float<T>(0.f);
    }
  }
}

// A whole 64 x 64 tile of the scratch (row stride rs, 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_full(T* dst, const T* src,
                                          long long rs) {
  constexpr int E = 16 / sizeof(T), CPR = TILE / E;
#pragma unroll
  for (int k = 0; k < TILE * CPR / THREADS; ++k) {
    const int e = threadIdx.x + THREADS * k;
    const int r = e / CPR, col = (e % CPR) * E;
    cp_async16(dst + r * PT + col, src + r * rs + col, true);
  }
}

// cum and dt of a 64-row tile of the scratch into v[0, 64) and v[64, 128).
__device__ __forceinline__ void load_rows(float* v, const float* cum,
                                          const float* dtc) {
  const int t = threadIdx.x;
  if (t < 32)
    cp_async16(v + 4 * t, (t < 16 ? cum + 4 * t : dtc + 4 * (t - 16)), true);
}

// acc[8][4] += A · B over k in [0, kn), both 64 x 64 tiles in shared memory
// (row pitch PT). A is stored [m][k], or [k][m] with AT; B is stored
// [n][k], or [k][n] with BT. bf16: warp w owns rows [16w, 16w + 16),
// acc[n8 tile][mma fragment], kn a multiple of 16. f32: thread (ty, tx) =
// (tid / 16, tid % 16) owns rows ty + 8i and columns tx + 16e.
template <typename T, bool AT, bool BT>
__device__ __forceinline__ void tile_product(float (&acc)[8][4], const T* As,
                                             const T* Bs, int kn) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, mi = lane >> 3, r8 = lane & 7;
    const int m0 = 16 * (threadIdx.x >> 5);
    for (int k0 = 0; k0 < kn; k0 += 16) {
      uint32_t a[4];
      if constexpr (AT)
        ldsm_x4_t(a, As + (k0 + r8 + 8 * (mi >> 1)) * PT + m0 + 8 * (mi & 1));
      else
        ldsm_x4(a, As + (m0 + r8 + 8 * (mi & 1)) * PT + k0 + 8 * (mi >> 1));
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t b[4];
        if constexpr (BT)
          ldsm_x4_t(b, Bs + (k0 + r8 + 8 * (mi & 1)) * PT + 16 * nb +
                           8 * (mi >> 1));
        else
          ldsm_x4(b, Bs + (16 * nb + r8 + 8 * (mi >> 1)) * PT + k0 +
                         8 * (mi & 1));
        mma_bf16(acc[2 * nb], a, b[0], b[1]);
        mma_bf16(acc[2 * nb + 1], a, b[2], b[3]);
      }
    }
  } else {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    for (int k = 0; k < kn; ++k) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = AT ? As[k * PT + ty + 8 * i] : As[(ty + 8 * i) * PT + k];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        bv[e] = BT ? Bs[k * PT + tx + 16 * e] : Bs[(tx + 16 * e) * PT + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(av[i], bv[e], acc[i][e]);
    }
  }
}

// Row and column, within the 64 x 64 output tile, of acc[i][e].
template <typename T>
__device__ __forceinline__ int acc_row(int i, int e) {
  if constexpr (sizeof(T) == 2)
    return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
  else
    return (threadIdx.x >> 4) + 8 * i;
}
template <typename T>
__device__ __forceinline__ int acc_col(int i, int e) {
  if constexpr (sizeof(T) == 2)
    return 8 * i + 2 * (threadIdx.x & 3) + (e & 1);
  else
    return (threadIdx.x & 15) + 16 * e;
}

// Row rr (0..15) of the 16 rows of the output tile that warp w's
// fragments hold (bf16: 16w + rr; f32: 2w + rr % 2 + 8 (rr / 2)).
template <typename T>
__device__ __forceinline__ int warp_row(int w, int rr) {
  if constexpr (sizeof(T) == 2) return 16 * w + rr;
  else return 2 * w + (rr & 1) + 8 * (rr >> 1);
}

// acc, as T, into rows [0, vr) and columns [0, vc) of the 64 x 64 tile at
// `out` (row stride rs, in T). Each warp stages the rows its fragments hold
// in `stage` (a shared tile) and writes them out whole, 16 bytes a lane
// where `vec` (16-byte aligned rows, vc a multiple of 16 / sizeof(T)),
// else element by element; warps need not wait for one another.
template <typename T>
__device__ __forceinline__ void store_tile(T* out, long long rs,
                                           const float (&acc)[8][4],
                                           T* stage, int vr, int vc,
                                           bool vec) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if constexpr (sizeof(T) == 2) {
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<uint32_t*>(stage + acc_row<T>(i, e) * PT +
                                     acc_col<T>(i, e)) =
            pack_bf16(acc[i][e], acc[i][e + 1]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        stage[acc_row<T>(i, e) * PT + acc_col<T>(i, e)] = acc[i][e];
    }
  }
  __syncwarp();
  constexpr int E = 16 / sizeof(T), CPR = TILE / E;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = lane; k < 16 * CPR; k += 32) {
    const int r = warp_row<T>(w, k / CPR), col = (k % CPR) * E;
    if (r >= vr || col >= vc) continue;
    if (vec) {
      *reinterpret_cast<uint4*>(out + r * rs + col) =
          *reinterpret_cast<const uint4*>(stage + r * PT + col);
    } else {
      for (int q = 0; q < E && col + q < vc; ++q)
        out[r * rs + col + q] = stage[r * PT + col + q];
    }
  }
  __syncwarp();
}

// bf16, ssd_out: acc += scores · x over one 64-column tile of the scores
// for this warp's 16 rows. The scores' A fragments are formed in registers
// from the f32 C Bᵀ tile: (C Bᵀ)_ij exp(cum_i − cum_j) dt_j, rounded to bf16
// once, for j <= i (jr = j0 − r0 is the tile's column offset from its rows;
// 0 on the diagonal tile, where warp w needs only its first w + 1 k-steps);
// x's B fragments by ldmatrix.trans.
__device__ __forceinline__ void scores_times_x(float (&acc)[8][4],
                                               const float* cbs,
                                               const float* v,
                                               const float* cum_i,
                                               const __nv_bfloat16* xs,
                                               int jr) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int mi = lane >> 3, r8 = lane & 7, t2 = 2 * (lane & 3);
  const int ra = 16 * w + (lane >> 2), rb = ra + 8;
  const float ca = cum_i[ra], cb = cum_i[rb];
  const int la = ra - jr, lb = rb - jr;   // column j of the tile: j <= la
  const int ksteps = jr == 0 ? w + 1 : TILE / 16;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = 16 * ks + 8 * hf + t2;
      const float2 xa = *reinterpret_cast<const float2*>(cbs + ra * PT + j);
      const float2 xb = *reinterpret_cast<const float2*>(cbs + rb * PT + j);
      const float c0 = v[j], c1 = v[j + 1];
      const float d0 = v[TILE + j], d1 = v[TILE + j + 1];
      a[2 * hf] = pack_bf16(j <= la ? xa.x * __expf(ca - c0) * d0 : 0.f,
                            j + 1 <= la ? xa.y * __expf(ca - c1) * d1 : 0.f);
      a[2 * hf + 1] =
          pack_bf16(j <= lb ? xb.x * __expf(cb - c0) * d0 : 0.f,
                    j + 1 <= lb ? xb.y * __expf(cb - c1) * d1 : 0.f);
    }
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      uint32_t bf[4];
      ldsm_x4_t(bf, xs + (16 * ks + r8 + 8 * (mi & 1)) * PT + 16 * nb +
                        8 * (mi >> 1));
      mma_bf16(acc[2 * nb], a, bf[0], bf[1]);
      mma_bf16(acc[2 * nb + 1], a, bf[2], bf[3]);
    }
  }
}

// A ring of STAGES shared stages: issue(s, stage) starts the copies of
// step s, STAGES - 1 steps ahead of compute(s, stage), which uses them
// once they have landed. The barrier that closes step s frees its stage.
template <int STAGES, typename Issue, typename Compute>
__device__ __forceinline__ void ring(int steps, Issue issue, Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    if (s + STAGES - 1 < steps)
      issue(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    compute(s, s % STAGES);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- kernels

// dt (f32) and cum = the inclusive cumsum of dt·A over each chunk, one warp
// per (batch, head, chunk), in 32-row steps with a shuffle scan.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_cumsum(const Params<T> p) {
  const int item = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (item >= p.batch * p.H * p.nc) return;
  const int h = item % p.H, rest = item / p.H;
  const int c = rest % p.nc, b = rest / p.nc;
  const float ah = p.a[h];
  const long long o = ((long long)(b * p.H + h) * p.nc + c) * p.Qp;
  const int t0 = c * p.Q, qv = min(p.Q, p.L - t0);
  const T* dtp = p.dt + b * p.sdb + h * p.sdh;
  float carry = 0.f;
  for (int r0 = 0; r0 < p.Qp; r0 += 32) {
    const int r = r0 + lane;
    const float d = r < qv ? to_float(dtp[(long long)(t0 + r) * p.sdl]) : 0.f;
    float v = __fmul_rn(d, ah);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    p.dtc[o + r] = d;
    p.cum[o + r] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// C Bᵀ of one chunk and group, one 64 x 64 tile on or below the diagonal
// per block, in f32, the reduction over N in 64-wide tiles.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_cb(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nct = p.Qp / TILE;
  int idx = blockIdx.x;
  const int it = (idx % (nct * nct)) / nct, jt = idx % nct;
  idx /= nct * nct;
  const int c = idx % p.nc, bg = idx / p.nc;
  const int b = bg / p.G, g = bg % p.G;
  const int t0 = c * p.Q, qv = min(p.Q, p.L - t0);
  const int i0 = it * TILE, j0 = jt * TILE;
  if (jt > it || i0 >= qv) return;   // never read
  const int vi = min(TILE, qv - i0), vj = min(TILE, qv - j0);
  const T* cp = p.c + b * p.scb + g * p.scg + (long long)(t0 + i0) * p.scl;
  const T* bp = p.b + b * p.sbb + g * p.sbg + (long long)(t0 + j0) * p.sbl;
  T* st = reinterpret_cast<T*>(smem);
  constexpr int TE = tile_bytes<T>() / sizeof(T);
  float acc[8][4] = {};
  ring<CB_STAGES>(
      p.Npd / TILE,
      [&](int s, int stage) {
        T* cs = st + 2 * TE * stage;
        const int n0 = s * TILE;
        load_tile<T>(cs, cp + n0 * p.scn, p.scl, p.scn, vi, p.N - n0, p.vc,
                     p.c);
        load_tile<T>(cs + TE, bp + n0 * p.sbn, p.sbl, p.sbn, vj, p.N - n0,
                     p.vb, p.b);
      },
      [&](int, int stage) {
        const T* cs = st + 2 * TE * stage;
        tile_product<T, false, false>(acc, cs, cs + TE, TILE);
      });
  float* out = p.cb + ((long long)bg * p.nc + c) * p.Qp * p.Qp +
               (long long)i0 * p.Qp + j0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[acc_row<T>(i, e) * p.Qp + acc_col<T>(i, e)] = acc[i][e];
}

// The states entering chunks 1 .. nc - 1 for one 64 x 64 tile of [N, P]
// of one (batch, head): the chunks but the last in order, each walked in
// 64-row tiles of its rows. acc holds the tile of the state: at a chunk's
// start it is scaled by exp(cum_Q) of that chunk, then S_c = Bᵀ diag(dt ⊙
// exp(cum_Q − cum)) x is summed into it, and at the chunk's end it is
// H_{c+1}, written to slot c in x's type.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_state(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nnt = p.Npd / TILE, npt = p.Ppd / TILE, nct = p.Qp / TILE;
  int idx = blockIdx.x;
  const int nt = idx % nnt;
  idx /= nnt;
  const int pt = idx % npt, bh = idx / npt;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int n0 = nt * TILE, p0 = pt * TILE;
  const T* bp = p.b + b * p.sbb + g * p.sbg + n0 * p.sbn;
  const T* xp = p.x + b * p.sxb + h * p.sxh + p0 * p.sxp;
  const long long co = (long long)bh * p.nc * p.Qp;
  constexpr int TE = tile_bytes<T>() / sizeof(T);
  constexpr int STAGE = state_stage<T>();
  float acc[8][4] = {};
  ring<STATE_STAGES>(
      (p.nc - 1) * nct,
      [&](int s, int stage) {
        T* bs = reinterpret_cast<T*>(smem + STAGE * stage);
        float* v = reinterpret_cast<float*>(smem + STAGE * stage +
                                            2 * tile_bytes<T>());
        const int c = s / nct, j0 = (s % nct) * TILE;
        const long long t = (long long)c * p.Q + j0;
        const int vj = min(TILE, p.Q - j0);
        load_tile<T>(bs, bp + t * p.sbl, p.sbl, p.sbn, vj, p.N - n0, p.vb,
                     p.b);
        load_tile<T>(bs + TE, xp + t * p.sxl, p.sxl, p.sxp, vj, p.P - p0,
                     p.vx, p.x);
        const float* cum = p.cum + co + (long long)c * p.Qp;
        load_rows(v, cum + j0, p.dtc + co + (long long)c * p.Qp + j0);
        if (threadIdx.x == 32)   // cum_Q, the chunk's last entry, at v[131]
          cp_async16(v + 2 * TILE, cum + p.Qp - 4, true);
      },
      [&](int s, int stage) {
        T* bs = reinterpret_cast<T*>(smem + STAGE * stage);
        T* xs = bs + TE;
        const float* v = reinterpret_cast<const float*>(
            smem + STAGE * stage + 2 * tile_bytes<T>());
        const float clast = v[2 * TILE + 3];
        const int jt = s % nct;
        if (jt == 0) {   // H_c decays over this chunk
          const float dcy = ex<T>(clast);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] *= dcy;
        }
        // x row j times dt_j exp(cum_Q - cum_j), in f32, rounded once
        constexpr int E = 16 / sizeof(T), CPR = TILE / E;
#pragma unroll
        for (int k = 0; k < TILE * CPR / THREADS; ++k) {
          const int e = threadIdx.x + THREADS * k;
          const int r = e / CPR, col = (e % CPR) * E;
          const float w = v[TILE + r] * ex<T>(clast - v[r]);
#pragma unroll
          for (int q = 0; q < E; ++q)
            xs[r * PT + col + q] =
                from_float<T>(to_float(xs[r * PT + col + q]) * w);
        }
        __syncthreads();
        tile_product<T, true, true>(acc, bs, xs, TILE);
        if (jt == nct - 1) {   // acc is H_{c+1}
          T* out = p.h + (((long long)bh * (p.nc - 1) + s / nct) * p.Npd +
                          n0) * p.Ppd + p0;
          store_tile<T>(out, p.Ppd, acc,
                        reinterpret_cast<T*>(smem + STATE_STAGES * STAGE),
                        TILE, TILE, true);
        }
      });
}

// y for 64 query rows and 64 columns of P of one chunk: acc = C H_c over
// N (chunks after the first), scaled by exp(cum_i); then the causal tiles
// of the scores (C Bᵀ ⊙ L ⊙ dt_j) times x; then the skip D x.
template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_out(const Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nct = p.Qp / TILE, npt = p.Ppd / TILE;
  int idx = blockIdx.x;
  const int rt = idx % nct;
  idx /= nct;
  const int pt = idx % npt;
  idx /= npt;
  const int c = idx % p.nc, bh = idx / p.nc;
  const int b = bh / p.H, h = bh % p.H, g = h / (p.H / p.G);
  const int t0 = c * p.Q, qv = min(p.Q, p.L - t0);
  const int r0 = rt * TILE, p0 = pt * TILE;
  if (r0 >= qv) return;
  const int vr = min(TILE, qv - r0);
  const long long co = ((long long)bh * p.nc + c) * p.Qp;
  constexpr int STAGE = out_stage<T>();
  constexpr int A_BYTES = imax(tile_bytes<T>(), FTILE);
  float* cum_i = reinterpret_cast<float*>(smem + OUT_STAGES * STAGE);

  const int n_inter = c > 0 ? p.Npd / TILE : 0;
  const int steps = n_inter + rt + 1;
  const T* cp = p.c + b * p.scb + g * p.scg + (long long)(t0 + r0) * p.scl;
  const T* hp = p.h + ((long long)bh * (p.nc - 1) + c - 1) * p.Npd * p.Ppd +
                p0;
  const float* cbp = p.cb + ((long long)(b * p.G + g) * p.nc + c) * p.Qp *
                                p.Qp + (long long)r0 * p.Qp;
  const T* xp = p.x + b * p.sxb + h * p.sxh + (long long)t0 * p.sxl +
                p0 * p.sxp;
  float acc[8][4] = {};
  ring<OUT_STAGES>(
      steps,
      [&](int s, int stage) {
        unsigned char* base = smem + STAGE * stage;
        T* bs = reinterpret_cast<T*>(base + A_BYTES);
        if (s == 0 && threadIdx.x >= 32 && threadIdx.x < 48)  // the rows' cum
          cp_async16(cum_i + 4 * (threadIdx.x - 32),
                     p.cum + co + r0 + 4 * (threadIdx.x - 32), true);
        if (s < n_inter) {
          const int n0 = s * TILE;
          load_tile<T>(reinterpret_cast<T*>(base), cp + n0 * p.scn, p.scl,
                       p.scn, vr, p.N - n0, p.vc, p.c);
          load_full<T>(bs, hp + (long long)n0 * p.Ppd, p.Ppd);
        } else {
          const int j0 = (s - n_inter) * TILE;
          load_full<float>(reinterpret_cast<float*>(base), cbp + j0, p.Qp);
          load_tile<T>(bs, xp + j0 * p.sxl, p.sxl, p.sxp, min(TILE, qv - j0),
                       p.P - p0, p.vx, p.x);
          load_rows(reinterpret_cast<float*>(base + A_BYTES + tile_bytes<T>()),
                    p.cum + co + j0, p.dtc + co + j0);
        }
      },
      [&](int s, int stage) {
        unsigned char* base = smem + STAGE * stage;
        const T* bs = reinterpret_cast<const T*>(base + A_BYTES);
        if (s < n_inter) {
          tile_product<T, false, true>(acc, reinterpret_cast<T*>(base), bs,
                                       TILE);
          return;
        }
        if (s == n_inter && n_inter > 0) {   // the C H_c part is complete
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][e] *= ex<T>(cum_i[acc_row<T>(i, e)]);
        }
        const int j0 = (s - n_inter) * TILE;
        float* cbs = reinterpret_cast<float*>(base);
        const float* v =
            reinterpret_cast<const float*>(base + A_BYTES + tile_bytes<T>());
        if constexpr (sizeof(T) == 2) {
          scores_times_x(acc, cbs, v, cum_i, bs, j0 - r0);
        } else {
          // scores_ij = (C Bᵀ)_ij exp(cum_i - cum_j) dt_j for j <= i, else
          // 0, in place
#pragma unroll 4
          for (int k = 0; k < TILE * TILE / 2 / THREADS; ++k) {
            const int e = threadIdx.x + THREADS * k;
            const int r = e >> 5, j = 2 * (e & 31);
            float2* cbv = reinterpret_cast<float2*>(cbs + r * PT + j);
            const float ci = cum_i[r];
            const int lim = r0 + r - j0;   // j <= i
            *cbv = make_float2(
                j <= lim ? cbv->x * expf(ci - v[j]) * v[TILE + j] : 0.f,
                j + 1 <= lim ? cbv->y * expf(ci - v[j + 1]) * v[TILE + j + 1]
                             : 0.f);
          }
          __syncthreads();
          tile_product<T, false, true>(acc, reinterpret_cast<T*>(cbs), bs,
                                       TILE);
        }
      });

  // the last step was the diagonal tile: its x rows are the query rows;
  // y is staged in the ring's other stage, free since the last step
  const T* xs = reinterpret_cast<const T*>(
      smem + STAGE * ((steps - 1) % OUT_STAGES) + A_BYTES);
  const float dh = p.d != nullptr ? p.d[h] : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[i][e] = fmaf(
          dh, to_float(xs[acc_row<T>(i, e) * PT + acc_col<T>(i, e)]),
          acc[i][e]);
  const long long syl = (long long)p.H * p.P;
  store_tile<T>(p.y + ((long long)b * p.L + t0 + r0) * syl +
                    (long long)h * p.P + p0,
                syl, acc,
                reinterpret_cast<T*>(smem + STAGE * (steps % OUT_STAGES)), vr,
                p.P - p0, p.P * sizeof(T) % 16 == 0);
}

template <typename T>
cudaError_t set_smem() {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_cb<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, cb_smem<T>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_state<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               state_smem<T>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_out<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem<T>());
  return err;
}

// ptrs: x, dt, a, b, c, d (or null), y, dtc, cum, cb, h. args: batch, L,
// H, G, P, N, Q, Qp, nc, Npd, Ppd, vx, vb, vc, then the strides of x (b, l,
// h, p), dt (b, l, h), B (b, l, g, n) and C (b, l, g, n).
template <typename T>
int launch(const void* const* ptrs, const long long* args, void* stream) {
  Params<T> p;
  p.x = static_cast<const T*>(ptrs[0]);
  p.dt = static_cast<const T*>(ptrs[1]);
  p.a = static_cast<const float*>(ptrs[2]);
  p.b = static_cast<const T*>(ptrs[3]);
  p.c = static_cast<const T*>(ptrs[4]);
  p.d = static_cast<const float*>(ptrs[5]);
  p.y = static_cast<T*>(const_cast<void*>(ptrs[6]));
  p.dtc = static_cast<float*>(const_cast<void*>(ptrs[7]));
  p.cum = static_cast<float*>(const_cast<void*>(ptrs[8]));
  p.cb = static_cast<float*>(const_cast<void*>(ptrs[9]));
  p.h = static_cast<T*>(const_cast<void*>(ptrs[10]));
  int* dims[] = {&p.batch, &p.L, &p.H, &p.G, &p.P, &p.N, &p.Q,
                 &p.Qp, &p.nc, &p.Npd, &p.Ppd, &p.vx, &p.vb, &p.vc};
  for (int i = 0; i < 14; ++i) *dims[i] = static_cast<int>(args[i]);
  long long* strides[] = {&p.sxb, &p.sxl, &p.sxh, &p.sxp, &p.sdb,
                          &p.sdl, &p.sdh, &p.sbb, &p.sbl, &p.sbg,
                          &p.sbn, &p.scb, &p.scl, &p.scg, &p.scn};
  for (int i = 0; i < 15; ++i) *strides[i] = args[14 + i];
  if (p.Q < 1 || p.G < 1 || p.H % p.G != 0 || p.Qp % TILE || p.Npd % TILE ||
      p.Ppd % TILE || p.nc < 1 || p.Qp < p.Q || p.Npd < p.N || p.Ppd < p.P)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bh = (long long)p.batch * p.H, nct = p.Qp / TILE;
  const long long grid[] = {(bh * p.nc * 32 + THREADS - 1) / THREADS,
                            nct * nct * p.batch * p.G * p.nc,
                            (p.Npd / TILE) * (p.Ppd / TILE) * bh,
                            nct * (p.Ppd / TILE) * p.nc * bh};
  for (long long blocks : grid)
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  ssd_cumsum<T><<<grid[0], THREADS, 0, st>>>(p);
  ssd_cb<T><<<grid[1], THREADS, cb_smem<T>(), st>>>(p);
  if (p.nc > 1) ssd_state<T><<<grid[2], THREADS, state_smem<T>(), st>>>(p);
  ssd_out<T><<<grid[3], THREADS, out_smem<T>(), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// For each of ssd_cumsum, ssd_cb, ssd_state, ssd_out: registers, spill
// (local) bytes per thread, resident blocks per SM, dynamic shared bytes;
// 16 ints.
template <typename T>
int info(int* out) {
  cudaError_t err = set_smem<T>();
  const void* fns[] = {reinterpret_cast<const void*>(ssd_cumsum<T>),
                       reinterpret_cast<const void*>(ssd_cb<T>),
                       reinterpret_cast<const void*>(ssd_state<T>),
                       reinterpret_cast<const void*>(ssd_out<T>)};
  const int smem[] = {0, cb_smem<T>(), state_smem<T>(), out_smem<T>()};
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    cudaFuncAttributes attr = {};
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, fns[k]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[k],
                                                          THREADS, smem[k]);
    out[4 * k] = attr.numRegs;
    out[4 * k + 1] = static_cast<int>(attr.localSizeBytes);
    out[4 * k + 2] = blocks;
    out[4 * k + 3] = smem[k];
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" int ssd_scan_f32(const void* const* ptrs, const long long* args,
                            void* stream) {
  return launch<float>(ptrs, args, stream);
}

extern "C" int ssd_scan_bf16(const void* const* ptrs, const long long* args,
                             void* stream) {
  return launch<__nv_bfloat16>(ptrs, args, stream);
}

extern "C" int ssd_scan_info_f32(int* out) { return info<float>(out); }

extern "C" int ssd_scan_info_bf16(int* out) {
  return info<__nv_bfloat16>(out);
}
