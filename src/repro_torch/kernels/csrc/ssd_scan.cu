// The Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 on the CUDA cores,
// with an initial state, as four passes that fill the card.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel (its
// pallas_call at :84), which computes what the reference's models compute in
// jnp (repro/models/mamba2.py:ssd_chunked, called from mamba2_block on every
// layer of every prefill and of the training loss). The Pallas kernel starts
// from a zero state; this one takes h0, as ssd_chunked does.
//
// Shapes (fp32, contiguous): u (B, T, H, P) dt-weighted inputs, loga
// (B, T, H) log decays (<= 0), Bm and Cm (B, T, N) shared by the heads
// (G = 1), h0 (B, H, N, P) or null for zeros. Outputs y (B, T, H, P) and the
// final state (B, H, N, P). T % Q == 0 for the chunk length Q <= 256, a
// runtime value (T < 256 gives a single chunk of any length); N <= 128; P a
// multiple of 16. ws is the wrapper's workspace (ssd_plan in ssd_scan.py):
// C B^T, C^T, the chunk states and the chunk decays.
//
// Per chunk of Q tokens, with cum the within-chunk prefix sum of loga:
//   y     = (C B^T * L) u + exp(cum) * (C h),  L[i, j] = exp(cum_i - cum_j)
//           for i >= j, else 0;
//   h'    = h * exp(cum[-1]) + B^T (u * exp(cum[-1] - cum)).
// Every exponent is <= 0, so every factor is <= 1.
//
// Bound: operations. At the mamba2-1.3b prefill shape (B 1, T 2048, H 64,
// P 64, N 128, Q 256) the chunked formulation needs 6.5 GFLOP (C B^T once
// per chunk and, for every head, the causal half of (C B^T * L) u, C h and
// B^T u) on about 72 MB of inputs and outputs, some 90 flops per byte:
// above the ~20 where the card's fp32 CUDA cores (67 TFLOP/s), not its
// memory, bind: 0.097 ms. The inputs are fp32 and the model's parity needs
// fp32 products (TF32 keeps about three digits), so every product is fp32
// FMAs on the CUDA cores.
//
// Design: the SSD decomposition that ref.ssd_scan_ref writes out, as four
// kernels on the caller's stream, each parallel over chunks where the
// algorithm allows (the TPU kernel instead walks the chunks in order on one
// core with the state in VMEM):
//  1. C B^T once per chunk for all heads (G = 1): one block per 64 x 64
//     tile of the chunk's (Q, Q) panel, the tiles above the diagonal and
//     past Q written as zeros; stored transposed, CBt[j][i] = C_i . B_j,
//     beside C^T, so that the later passes read 16-byte rows along i.
//  2. chunk summaries, one block per (P slice, head, chunk and b):
//     S_c = B^T (u * exp(cum_last - cum)), (N, P slice); also the chunk's
//     decay exp(cum_last) for pass 3.
//  3. state passing, the only sequential part and elementwise: one thread
//     per (b, head, n, p) walks the chunks, h <- h exp(cum_last_c) + S_c
//     from h0, writing the state entering each chunk over S_c and the
//     final state.
//  4. chunk output, one block per (P slice, head, chunk and b):
//     y = exp(cum) (C h_in) + (C B^T * L) u, the L mask and decay formed in
//     shared memory from CBt one 32-key tile at a time.
// Passes 2 and 4 are register-tiled fp32 products over operands staged in
// shared memory by cp.async into a double buffer (mm_tn: a thread owns an
// 8 x 8 block of outputs and reads its A and B values as float4 along the
// output's rows and columns; the A reads broadcast within a quarter-warp
// and the B reads are conflict-free, 16 wavefronts for 64 FMAs, which is
// what an SM's shared memory serves while its cores issue them). In pass 4
// a warp owns the 16-row strips w and 15 - w of the chunk, so that every
// warp does the same share of the causal triangle (9 of 16 strip-tiles at
// Q 256).
// Each block computes the within-chunk prefix sum of loga for its head with
// a warp scan. No atomics: every sum is in a fixed order, so calls and
// CUDA-graph replays are bit-identical.
// Known limits: C B^T and the state pass go through device memory (about
// 40 MB at the mamba2 shape, mostly from L2); fp32 FMAs only (no 3xTF32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;   // Q <= kThreads: one loga value a thread
constexpr int kTile = 64;        // pass 1: C B^T tile
constexpr int kKTile = 32;       // passes 2 and 4: k rows a stage
constexpr int kStrip = 16;       // pass 4: rows of a strip
constexpr unsigned kFull = 0xffffffffu;

// acc[i][j] += sum_k A[ty*4 + i][k] * B[tx + 16 j][k], 256 threads as
// 16 x 16 over 64 x 64 (pass 1)
template <int K>
__device__ __forceinline__ void mm_nt(float (&acc)[4][4], const float* A,
                                      int lda, const float* B, int ldb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a = A + ty * 4 * lda;
  const float* b = B + tx * ldb;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[16 * j * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// V (2 or 4) consecutive floats from shared memory into v.
template <int V>
__device__ __forceinline__ void lds(float* v, const float* p) {
  if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
}

// acc[g * RV + i][h * CV + j] += sum_k At[k][r[g] + i] * Bt[k][c0 + h * cs
// + j] over k in [k0, k1): one thread's block of a product whose operands
// are staged k-major, rows in RG groups of RV, columns in CG groups of CV
// (cs apart). The threads of a quarter-warp share their rows (one
// broadcast wavefront) and take consecutive column vectors (conflict-free),
// so an 8 x 8 block costs 16 wavefronts of shared memory for 64 FMAs.
template <int RG, int RV, int CG, int CV>
__device__ __forceinline__ void mm_tn(float (&acc)[RG * RV][CG * CV],
                                      const float* At, int lda,
                                      const int (&r)[RG], const float* Bt,
                                      int ldb, int c0, int cs, int k0,
                                      int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float a[RG * RV], b[CG * CV];
#pragma unroll
    for (int g = 0; g < RG; ++g) lds<RV>(a + g * RV, At + k * lda + r[g]);
#pragma unroll
    for (int h = 0; h < CG; ++h) lds<CV>(b + h * CV, Bt + k * ldb + c0 + h * cs);
#pragma unroll
    for (int i = 0; i < RG * RV; ++i)
#pragma unroll
      for (int j = 0; j < CG * CV; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The column split of a P slice over 8 threads: CG groups of CV columns,
// thread tx at columns tx * CV + h * (PS / CG).
template <int PS> struct Cols {
  static constexpr int kCV = PS >= 32 ? 4 : 2;
  static constexpr int kCG = PS / (8 * kCV);
  static constexpr int kStep = PS / kCG;
};

template <int R, int CJ>
__device__ __forceinline__ void zero(float (&acc)[R][CJ]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// kKTile rows of COLS floats from rows of stride ld at src into dst with
// row stride ldd, only the columns [c_from, c_to) (multiples of 4); rows at
// or past n_rows are zero-filled.
template <int COLS>
__device__ __forceinline__ void stage_rows(float* dst, int ldd,
                                           const float* src, long long ld,
                                           int n_rows, int c_from = 0,
                                           int c_to = COLS) {
  constexpr int kC4 = COLS / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kKTile * kC4; i += kThreads) {
    const int r = i / kC4, c = (i % kC4) * 4;
    if (c < c_from || c >= c_to) continue;
    const bool in = r < n_rows;
    cp_async16(dst + r * ldd + c, in ? src + r * ld + c : src, in);
  }
}

// The inclusive prefix sum of loga over the chunk's Q positions for one
// head (stride H) into cum_s[0, 256); positions past Q add zeros.
__device__ __forceinline__ void chunk_cumsum(float* cum_s, float* warp_s,
                                             const float* loga, int H,
                                             int Q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float x = static_cast<int>(threadIdx.x) < Q
      ? loga[(long long)threadIdx.x * H] : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += v;
  }
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += warp_s[w];
  cum_s[threadIdx.x] = x;
  __syncthreads();
}

// Workspace layout (floats), the wrapper's ssd_plan: CBt (B, nc, 256, 256),
// Ct (B, nc, NP, 256), the chunk states (B, nc, H, N, P), the chunk decays
// (B, nc, H). Every part is a multiple of 4 floats, so each starts 16-byte
// aligned.
struct Work {
  float* cbt;
  float* ct;
  float* states;
  float* decay;
};

Work carve(float* ws, int B, int nc, int H, int P, int N, int NP) {
  Work w;
  w.cbt = ws;
  w.ct = w.cbt + (long long)B * nc * kMaxChunk * kMaxChunk;
  w.states = w.ct + (long long)B * nc * NP * kMaxChunk;
  w.decay = w.states + (long long)B * nc * H * N * P;
  return w;
}

// ------------------------------------------------------------- pass 1 --
// One block per (64 x 64 tile (it, jt) of the chunk's (256, 256) panel, chunk
// and b): CBt[j][i] = C_i . B_j for j <= i < Q, zeros elsewhere; the tiles
// jt == 0 also write C^T rows [it*64, it*64 + 64) of Ct (NP rows, zeros at
// n >= N or i >= Q).
template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              Work w, int T, int N, int Q) {
  constexpr int LD = NP + 1;
  extern __shared__ float smem[];
  float* cs = smem;                   // [64][LD] C rows i of the tile
  float* bs = cs + kTile * LD;        // [64][LD] B rows j of the tile
  const int it = blockIdx.x / 4, jt = blockIdx.x % 4;
  const int nc = T / Q, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const int i0 = it * kTile, j0 = jt * kTile;
  const long long t0 = (long long)b * T + (long long)c * Q;
  float* cbt = w.cbt + ((long long)b * nc + c) * kMaxChunk * kMaxChunk;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const bool live = j0 <= i0 && i0 < Q;      // any j <= i < Q in the tile
  if (live || jt == 0) {
    for (int e = threadIdx.x; e < kTile * NP; e += kThreads) {
      const int r = e / NP, n = e % NP;
      cs[r * LD + n] = (i0 + r < Q && n < N) ? Cm[(t0 + i0 + r) * N + n] : 0.f;
      if (live)
        bs[r * LD + n] =
            (j0 + r < Q && n < N) ? Bm[(t0 + j0 + r) * N + n] : 0.f;
    }
    __syncthreads();
  }
  float acc[4][4];
  zero(acc);
  if (live) mm_nt<NP>(acc, bs, LD, cs, LD);   // rows j, columns i
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty * 4 + a;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = i0 + tx + 16 * q;
      cbt[(long long)j * kMaxChunk + i] =
          (live && j <= i && i < Q) ? acc[a][q] : 0.f;
    }
  }
  if (jt == 0) {
    float* ct = w.ct + ((long long)b * nc + c) * NP * kMaxChunk;
    for (int e = threadIdx.x; e < kTile * NP; e += kThreads) {
      const int n = e / kTile, r = e % kTile;
      ct[(long long)n * kMaxChunk + i0 + r] = cs[r * LD + n];
    }
  }
}

// ------------------------------------------------------------- pass 2 --
// One block per (P slice, head, chunk and b): S_c[n][p] = sum_k B[k][n]
// u[k][p] exp(cum_last - cum_k) into the chunk-state workspace. The block's
// two halves of 128 threads take the first and the second 16 keys of each
// 32-key tile, each thread an (RG x RV) x (CG x CV) block of the NP x PS
// outputs (8 x 8 at NP 128, PS 64); the second half's sums are then added
// to the first's, in that order. The block of P slice 0 also writes
// exp(cum_last).
template <int NP, int PS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_summary_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                   const float* __restrict__ Bm, Work w, int T, int H, int P,
                   int N, int Q) {
  using C = Cols<PS>;
  constexpr int RV = NP >= 64 ? 4 : 2, RG = NP / (16 * RV);
  constexpr int kRows = RG * RV, kColsT = C::kCG * C::kCV;
  constexpr int kStage = kKTile * (NP + PS);
  extern __shared__ __align__(16) float smem[];
  float* cum_s = smem;                 // [256]
  float* warp_s = cum_s + kMaxChunk;   // [32]
  float* wgt_s = warp_s + 32;          // [256] exp(cum_last - cum)
  float* stages = wgt_s + kMaxChunk;   // 2 x (B rows [32][NP], u [32][PS])

  const int p0 = blockIdx.x * PS, h = blockIdx.y;
  const int nc = T / Q, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P;
  const float* ub = u + t0 * hp + (long long)h * P + p0;
  const float* bb = Bm + t0 * N;
  const int n_kt = (Q + kKTile - 1) / kKTile;
  auto load = [&](int kt) {
    float* st = stages + (kt & 1) * kStage;
    const int k0 = kt * kKTile;
    for (int e = threadIdx.x; e < kKTile * NP; e += kThreads) {
      const int r = e / NP, n = e % NP;
      const bool in = k0 + r < Q && n < N;
      cp_async4(st + e, in ? bb + (long long)(k0 + r) * N + n : bb, in);
    }
    stage_rows<PS>(st + kKTile * NP, PS, ub + k0 * hp, hp, Q - k0);
  };
  load(0);
  cp_async_commit();

  chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);
  const float cum_last = cum_s[Q - 1];
  wgt_s[threadIdx.x] = static_cast<int>(threadIdx.x) < Q
      ? __expf(cum_last - cum_s[threadIdx.x]) : 0.f;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    w.decay[((long long)b * nc + c) * H + h] = __expf(cum_last);

  const int half = threadIdx.x >> 7, tx = threadIdx.x & 7;
  const int ty = (threadIdx.x >> 3) & 15;
  int r[RG];
#pragma unroll
  for (int g = 0; g < RG; ++g) r[g] = g * (NP / RG) + RV * ty;
  const int kh = half * (kKTile / 2);  // this half's keys of a tile
  float acc[kRows][kColsT];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* st = stages + (kt & 1) * kStage;
    float* us = st + kKTile * NP;
    // scale the u rows by their decay to the chunk's end
    for (int e = threadIdx.x; e < kKTile * PS; e += kThreads)
      us[e] *= wgt_s[kt * kKTile + e / PS];
    __syncthreads();
    mm_tn<RG, RV, C::kCG, C::kCV>(acc, st, NP, r, us, PS, C::kCV * tx,
                                  C::kStep, kh, kh + kKTile / 2);
    __syncthreads();                   // before the next load overwrites it
  }
  // the second half's sums onto the first's, through the idle stages
  float* red = stages + (threadIdx.x & 127) * kRows * kColsT;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kColsT; ++j) red[i * kColsT + j] = acc[i][j];
  }
  __syncthreads();
  if (half == 1) return;
  float* sc = w.states + (((long long)b * nc + c) * H + h) * N * P + p0;
#pragma unroll
  for (int g = 0; g < RG; ++g)
#pragma unroll
    for (int i = 0; i < RV; ++i) {
      const int n = r[g] + i;
      if (n >= N) continue;
#pragma unroll
      for (int q = 0; q < C::kCG; ++q)
#pragma unroll
        for (int j = 0; j < C::kCV; ++j) {
          const int ai = g * RV + i, aj = q * C::kCV + j;
          sc[(long long)n * P + C::kCV * tx + q * C::kStep + j] =
              acc[ai][aj] + red[ai * kColsT + aj];
        }
    }
}

// ------------------------------------------------------------- pass 3 --
// One thread per (b, head, n, p): the state entering each chunk over S_c,
// h <- h exp(cum_last_c) + S_c, and the final state.
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ h0, float* __restrict__ state_out,
                 Work w, int nc, int H, int NPe) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= NPe) return;
  const long long at = ((long long)b * H + h) * NPe + e;
  float x = h0 ? h0[at] : 0.f;
  const long long step = (long long)H * NPe;
  float* s = w.states + ((long long)b * nc * H + h) * NPe + e;
  const float* dc = w.decay + (long long)b * nc * H + h;
  // 8 chunks at a time: their loads all in flight before the first store
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float v[8], d[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      v[c] = c0 + c < nc ? s[(c0 + c) * step] : 0.f;
      d[c] = c0 + c < nc ? dc[(long long)(c0 + c) * H] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c0 + c < nc) {
        s[(c0 + c) * step] = x;
        x = fmaf(x, d[c], v[c]);
      }
    }
  }
  state_out[at] = x;
}

// ------------------------------------------------------------- pass 4 --
// One block per (P slice, head, chunk and b): y = exp(cum) (C h_in) +
// (C B^T * L) u over the chunk's rows. A warp w owns the strips w and
// 15 - w (16 rows each; a thread 4 rows of each, rows 16 s + 4 ry + [0, 4),
// and PS / 8 columns, Cols<PS>). The k loop runs first over
// the NP / 32 tiles of (C^T, h_in), then over the key tiles of (CBt, u),
// each tile of CBt turned into (C B^T * L)^T in shared memory before use;
// a strip skips the key tiles past its last row and the rows past Q.
template <int NP, int PS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_output_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                  float* __restrict__ y, Work w, int T, int H, int P, int N,
                  int Q) {
  constexpr int CJ = PS / 8;
  constexpr int kA = kKTile * kMaxChunk;         // a stage's A^T tile
  constexpr int kStage = kA + kKTile * PS;
  extern __shared__ __align__(16) float smem[];
  float* cum_s = smem;                 // [256]
  float* warp_s = cum_s + kMaxChunk;   // [32]
  float* stages = warp_s + 32;         // 2 x (A^T [32][256], B [32][PS])

  const int p0 = blockIdx.x * PS, h = blockIdx.y;
  const int nc = T / Q, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P;
  const long long bc = (long long)b * nc + c;
  const float* ub = u + t0 * hp + (long long)h * P + p0;
  const float* hin = w.states + (bc * H + h) * N * P + p0;
  const float* ct = w.ct + bc * NP * kMaxChunk;
  const float* cbt = w.cbt + bc * kMaxChunk * kMaxChunk;
  const int n_nt = NP / kKTile, n_kt = n_nt + (Q + kKTile - 1) / kKTile;
  // A^T rows are whole (256-float) rows, zero past Q; the strips that run
  // read the first Q columns rounded up to a whole strip
  const int a_cols = (Q + kStrip - 1) & ~(kStrip - 1);
  auto load = [&](int kt) {
    float* st = stages + (kt & 1) * kStage;
    if (kt < n_nt) {
      const int n0 = kt * kKTile;
      stage_rows<kMaxChunk>(st, kMaxChunk, ct + (long long)n0 * kMaxChunk,
                            kMaxChunk, kKTile, 0, a_cols);
      stage_rows<PS>(st + kA, PS, hin + (long long)n0 * P, P, N - n0);
    } else {
      // only the columns from the first strip that reaches key k0
      const int k0 = (kt - n_nt) * kKTile;
      stage_rows<kMaxChunk>(st, kMaxChunk, cbt + (long long)k0 * kMaxChunk,
                            kMaxChunk, kKTile, k0 & ~(kStrip - 1), a_cols);
      stage_rows<PS>(st + kA, PS, ub + k0 * hp, hp, Q - k0);
    }
  };
  load(0);
  cp_async_commit();
  chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);

  const int tx = threadIdx.x & 7, ry = (threadIdx.x >> 3) & 3;
  const int wp = threadIdx.x >> 5;
  const int s_lo = wp, s_hi = 15 - wp;
  const int r_lo = kStrip * s_lo + 4 * ry, r_hi = kStrip * s_hi + 4 * ry;
  const int rows[2] = {r_lo, r_hi}, row_lo[1] = {r_lo}, row_hi[1] = {r_hi};
  float acc[8][CJ];                    // rows r_lo + [0, 4), r_hi + [0, 4)
  zero(acc);
  auto& lo = *reinterpret_cast<float(*)[4][CJ]>(&acc[0][0]);
  auto& hi = *reinterpret_cast<float(*)[4][CJ]>(&acc[4][0]);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* at = stages + (kt & 1) * kStage;
    float* bt = at + kA;
    int k0 = 0;                        // first key of an intra tile
    if (kt >= n_nt) {
      k0 = (kt - n_nt) * kKTile;
      if (kt == n_nt) {                // C h_in done: times exp(cum_i)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float el = r_lo + i < Q ? __expf(cum_s[r_lo + i]) : 0.f;
          const float eh = r_hi + i < Q ? __expf(cum_s[r_hi + i]) : 0.f;
#pragma unroll
          for (int j = 0; j < CJ; ++j) {
            lo[i][j] *= el;
            hi[i][j] *= eh;
          }
        }
      }
      // (C B^T * L)^T in place, a thread a column i, for the columns from
      // the first strip that reaches key k0 (the rest is never read)
      const int i = threadIdx.x;
      if (i >= (k0 & ~(kStrip - 1)) && i < a_cols) {
        const float ci = cum_s[i];
#pragma unroll 8
        for (int r = 0; r < kKTile; ++r) {
          const int j = k0 + r;
          float* m = at + r * kMaxChunk + i;
          *m = (j <= i && i < Q) ? *m * __expf(ci - cum_s[j]) : 0.f;
        }
      }
      __syncthreads();
    }
    // strips past Q, or ending before the tile's first key, add nothing
    const bool act_lo = kStrip * s_lo < Q && kStrip * s_lo + kStrip > k0;
    const bool act_hi = kStrip * s_hi < Q && kStrip * s_hi + kStrip > k0;
    constexpr int CG = Cols<PS>::kCG, CV = Cols<PS>::kCV;
    const int c0 = CV * tx;
    if (act_lo && act_hi)              // one read of B for both strips
      mm_tn<2, 4, CG, CV>(acc, at, kMaxChunk, rows, bt, PS, c0,
                          Cols<PS>::kStep, 0, kKTile);
    else if (act_lo)
      mm_tn<1, 4, CG, CV>(lo, at, kMaxChunk, row_lo, bt, PS, c0,
                          Cols<PS>::kStep, 0, kKTile);
    else if (act_hi)
      mm_tn<1, 4, CG, CV>(hi, at, kMaxChunk, row_hi, bt, PS, c0,
                          Cols<PS>::kStep, 0, kKTile);
    __syncthreads();                   // before the next load overwrites it
  }
  float* yb = y + t0 * hp + (long long)h * P + p0 + Cols<PS>::kCV * tx;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? r_lo : r_hi) + i % 4;
    if (row >= Q) continue;
#pragma unroll
    for (int q = 0; q < Cols<PS>::kCG; ++q)
#pragma unroll
      for (int j = 0; j < Cols<PS>::kCV; ++j)
        yb[(long long)row * hp + q * Cols<PS>::kStep + j] =
            acc[i][q * Cols<PS>::kCV + j];
  }
}

// Dynamic shared memory of passes 1, 2 and 4 at padded state size np and
// P slice ps.
constexpr int cb_smem(int np) { return 2 * kTile * (np + 1) * 4; }
constexpr int summary_smem(int np, int ps) {
  return (2 * kMaxChunk + 32 + 2 * kKTile * (np + ps)) * 4;
}
constexpr int output_smem(int ps) {
  return (kMaxChunk + 32 + 2 * kKTile * (kMaxChunk + ps)) * 4;
}

// The attribute calls run once per instantiation (function-local statics),
// so that none falls inside a CUDA graph capture after the first launch.
template <int NP, int PS>
cudaError_t launch(const float* u, const float* loga, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* state,
                   float* ws, int B, int T, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  static const cudaError_t attr_c = cudaFuncSetAttribute(
      ssd_cb_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cb_smem(NP));
  static const cudaError_t attr_s = cudaFuncSetAttribute(
      ssd_summary_kernel<NP, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      summary_smem(NP, PS));
  static const cudaError_t attr_o = cudaFuncSetAttribute(
      ssd_output_kernel<NP, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      output_smem(PS));
  if (attr_c != cudaSuccess) return attr_c;
  if (attr_s != cudaSuccess) return attr_s;
  if (attr_o != cudaSuccess) return attr_o;
  const int nc = T / Q;
  const Work w = carve(ws, B, nc, H, P, N, NP);
  cudaError_t err;
  ssd_cb_kernel<NP><<<dim3(16, B * nc), kThreads, cb_smem(NP), stream>>>(
      Bm, Cm, w, T, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid(P / PS, H, B * nc);
  ssd_summary_kernel<NP, PS><<<grid, kThreads, summary_smem(NP, PS),
                               stream>>>(u, loga, Bm, w, T, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int npe = N * P;
  ssd_state_kernel<<<dim3((npe + kThreads - 1) / kThreads, H, B), kThreads, 0,
                     stream>>>(h0, state, w, nc, H, npe);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_output_kernel<NP, PS><<<grid, kThreads, output_smem(PS), stream>>>(
      u, loga, y, w, T, H, P, N, Q);
  return cudaGetLastError();
}

// The P slice: 64 columns where P allows, else 32 or 16 (ssd_plan).
template <int NP>
cudaError_t launch_ps(const float* u, const float* loga, const float* Bm,
                      const float* Cm, const float* h0, float* y, float* state,
                      float* ws, int B, int T, int H, int P, int N, int Q,
                      cudaStream_t s) {
  if (P % 64 == 0)
    return launch<NP, 64>(u, loga, Bm, Cm, h0, y, state, ws, B, T, H, P, N,
                          Q, s);
  if (P % 32 == 0)
    return launch<NP, 32>(u, loga, Bm, Cm, h0, y, state, ws, B, T, H, P, N,
                          Q, s);
  return launch<NP, 16>(u, loga, Bm, Cm, h0, y, state, ws, B, T, H, P, N, Q,
                        s);
}

}  // namespace

// Dynamic shared memory (bytes) that passes 1, 2 and 4 (pass) request at
// state size N and head dim P; 0 for pass 3, -1 for a shape not taken.
extern "C" int repro_ssd_smem(int N, int P, int pass) {
  if (N <= 0 || N > 128 || P <= 0 || P % 16) return -1;
  const int np = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int ps = P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;
  switch (pass) {
    case 1: return cb_smem(np);
    case 2: return summary_smem(np, ps);
    case 3: return 0;
    case 4: return output_smem(ps);
    default: return -1;
  }
}

// All pointers to contiguous fp32; h0 may be null (a zero initial state);
// ws is the workspace of ssd_plan's size. Launches the four passes on the
// stream in order; returns the first CUDA error (0 when all were accepted).
extern "C" int repro_ssd_scan(const float* u, const float* loga,
                              const float* Bm, const float* Cm,
                              const float* h0, float* y, float* state,
                              float* ws, int B, int T, int H, int P, int N,
                              int Q, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535 || P <= 0 || P % 16 || N <= 0 ||
      N > 128 || Q <= 0 || Q > kMaxChunk || T <= 0 || T % Q ||
      (long long)B * (T / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 32)
    err = launch_ps<32>(u, loga, Bm, Cm, h0, y, state, ws, B, T, H, P, N, Q, s);
  else if (N <= 64)
    err = launch_ps<64>(u, loga, Bm, Cm, h0, y, state, ws, B, T, H, P, N, Q, s);
  else
    err = launch_ps<128>(u, loga, Bm, Cm, h0, y, state, ws, B, T, H, P, N, Q,
                         s);
  return static_cast<int>(err);
}
