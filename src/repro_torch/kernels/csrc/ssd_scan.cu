// The Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 on the CUDA cores,
// with an initial state, as four passes that fill the card; and its
// backward, six more passes (below, after the forward's launch code).
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
                   float* chunk_states, float* ws, int B, int T, int H, int P,
                   int N, int Q, cudaStream_t stream) {
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
  Work w = carve(ws, B, nc, H, P, N, NP);
  if (chunk_states) w.states = chunk_states;
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
                      float* chunk_states, float* ws, int B, int T, int H,
                      int P, int N, int Q, cudaStream_t s) {
  if (P % 64 == 0)
    return launch<NP, 64>(u, loga, Bm, Cm, h0, y, state, chunk_states, ws, B,
                          T, H, P, N, Q, s);
  if (P % 32 == 0)
    return launch<NP, 32>(u, loga, Bm, Cm, h0, y, state, chunk_states, ws, B,
                          T, H, P, N, Q, s);
  return launch<NP, 16>(u, loga, Bm, Cm, h0, y, state, chunk_states, ws, B, T,
                        H, P, N, Q, s);
}

// ============================================================ backward ==
// The gradient of the scan, with dy (B, T, H, P) and dstate (B, H, N, P) or
// null, from the inputs and the states entering each chunk that the forward
// kept (chunk_states). Per chunk and head, with e_i = exp(cum_i),
// d_j = exp(cum_last - cum_j), h the state entering the chunk and g the
// gradient of the state leaving it (ref.ssd_scan_bwd_ref writes the same
// passes out in PyTorch):
//  b1. C B^T once per chunk (pass 1 again, into the backward's workspace);
//  b2. each chunk's sum_i e_i C_i (x) dy_i, the dual of pass 2, one block
//      per (64 x 64 tile of (N, P), head, chunk and b);
//  b3. the reverse state pass from dstate, the dual of pass 3: g leaving
//      each chunk over b2's sums, g_in = b2 + e_last g, and dh0;
//  b4. the panel: one block per (64 x 64 tile (it >= jt) of the chunk's
//      (Q, Q) panel, chunk and b) loops over the heads in order; each head's
//      tile of dy u^T times L is added to W = sum_h L_h * (dy_h u_h^T) in
//      registers, and times C B^T gives R, whose row and column sums (the
//      dcum terms of the intra-chunk product) go to the workspace per head
//      and tile, so that dloga sums them in a fixed order;
//  b5. one block per (head, chunk and b): du = M^T dy + d (B g) tile by
//      tile, the rows' e (dy . C h) and d (u . g^T B), <g, h>, then dcum and
//      its reverse prefix sum within the chunk, dloga;
//  b6. one block per (64-row tile, 64 columns of N, dC or dB, chunk and b):
//      dC = W B + sum_h e_h dy_h h_h^T and dB = W^T C + sum_h d_h u_h g_h^T,
//      the panel taken once per chunk before the heads' states: B and C
//      are shared by the heads, so the (Q, Q, N) products are not repeated.
// Bound: operations, about twice the forward's (at the mamba2-1.3b training
// shape, B 8, T 2048: 105 GFLOP of fp32 FMAs on 1.2 GB; the chip smoke
// computes it from the shapes). Every product is an fp32 FMA on the CUDA
// cores in a 64 x 64 register tile (4 x 4 a thread) over operands staged in
// shared memory 32 rows at a time. No atomics: every sum over heads, tiles
// and rows is taken in a fixed order, so calls and CUDA-graph replays are
// bit-identical.
constexpr int kK = 32;                     // staged rows a product step
constexpr int kLd = 68;                    // a staged row: 64 floats + pad
constexpr int kMaxTiles = kMaxChunk / 64;  // 64-row tiles of a chunk
constexpr int kStaged = kK * kLd;          // floats of one staged operand

// acc[a][b] += sum_k As[k][4 ty + a] * Bs[k][4 tx + b] over kK rows: 256
// threads as 16 x 16 over a 64 x 64 tile, 4 x 4 each.
__device__ __forceinline__ void mm64(float (&acc)[4][4], const float* As,
                                     const float* Bs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    float a[4], b[4];
    lds<4>(a, As + k * kLd + 4 * ty);
    lds<4>(b, Bs + k * kLd + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// dst[k][r] = f(k, r) for k < kK, r < 64. kKFast: consecutive threads take
// consecutive k (for a source contiguous along k), else consecutive r.
template <bool kKFast, class F>
__device__ __forceinline__ void stage(float* dst, F f) {
#pragma unroll
  for (int s = 0; s < kK * 64 / kThreads; ++s) {
    const int e = threadIdx.x + s * kThreads;
    const int k = kKFast ? e % kK : e / 64, r = kKFast ? e / kK : e % 64;
    dst[k * kLd + r] = f(k, r);
  }
}

// out[(4 ty + a) * ld + 4 tx + b] = acc[a][b] where the row is under rows and
// the column under cols.
__device__ __forceinline__ void store64(float* out, long long ld,
                                        const float (&acc)[4][4], int rows,
                                        int cols) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (4 * ty + a < rows && 4 * tx + b < cols)
        out[(4 * ty + a) * ld + 4 * tx + b] = acc[a][b];
}

// The sum of v over the 16 threads of a half-warp (the tx of a 4 x 4 tile
// row), in a fixed tree; every thread gets it.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The inclusive prefix sum of x over the block's threads in order.
__device__ __forceinline__ float block_scan(float x, float* warp_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += v;
  }
  if (lane == 31) warp_s[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) x += warp_s[w];
  __syncthreads();
  return x;
}

// Backward workspace layout (floats), ssd_bwd_plan in ssd_scan.py: C B^T
// and C^T as pass 1 writes them, the state gradients (B, nc, H, N, P), the
// panel W (B, nc, 256, 256), the row and column sums of each head's R per
// tile (B, nc, H, 4, 256) each, and the chunk decays (B, nc, H) last.
struct GradWork {
  float* cbt;
  float* ct;
  float* g;
  float* panel;
  float* rows;
  float* cols;
  float* decay;
};

GradWork carve_grad(float* ws, int B, int nc, int H, int P, int N, int NP) {
  GradWork w;
  const long long bc = (long long)B * nc;
  w.cbt = ws;
  w.ct = w.cbt + bc * kMaxChunk * kMaxChunk;
  w.g = w.ct + bc * NP * kMaxChunk;
  w.panel = w.g + bc * H * N * P;
  w.rows = w.panel + bc * kMaxChunk * kMaxChunk;
  w.cols = w.rows + bc * H * kMaxTiles * kMaxChunk;
  w.decay = w.cols + bc * H * kMaxTiles * kMaxChunk;
  return w;
}

// Shared memory (floats) of b2 and b4 to b6.
constexpr int grad_summary_smem() { return 2 * kMaxChunk + 32 + 2 * kStaged; }
constexpr int grad_panel_smem() { return kMaxChunk + 32 + 16 * 64 + 2 * kStaged; }
constexpr int grad_du_smem() { return 7 * kMaxChunk + 32 + 2 * kStaged; }
constexpr int grad_bc_smem() { return 2 * kMaxChunk + 32 + 2 * kStaged; }

// ------------------------------------------------------------ pass b2 --
// One block per (64 x 64 tile of the (N, P) state, head, chunk and b):
// Z[n][p] = sum_i exp(cum_i) C_i[n] dy_i[p] into w.g; the block at tile 0
// also writes the chunk's decay exp(cum_last).
__global__ void __launch_bounds__(kThreads)
ssd_grad_summary_kernel(const float* __restrict__ dy,
                        const float* __restrict__ loga,
                        const float* __restrict__ Cm, GradWork w, int T,
                        int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                    // [kK][kLd]
  float* bs = as + kStaged;            // [kK][kLd]
  float* cum_s = bs + kStaged;         // [256]
  float* e_s = cum_s + kMaxChunk;      // [256] exp(cum)
  float* warp_s = e_s + kMaxChunk;     // [32]
  const int tiles_n = (N + 63) / 64;
  const int n0 = (blockIdx.x % tiles_n) * 64, p0 = (blockIdx.x / tiles_n) * 64;
  const int h = blockIdx.y, nc = T / Q, c = blockIdx.z % nc,
            b = blockIdx.z / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P;
  const long long bch = ((long long)b * nc + c) * H + h;
  chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);
  e_s[threadIdx.x] = static_cast<int>(threadIdx.x) < Q
      ? __expf(cum_s[threadIdx.x]) : 0.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) w.decay[bch] = __expf(cum_s[Q - 1]);
  __syncthreads();
  const float* cb = Cm + t0 * N;
  const float* yb = dy + t0 * hp + (long long)h * P;
  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < Q; k0 += kK) {
    stage<false>(as, [&](int k, int r) {
      const int i = k0 + k, n = n0 + r;
      return i < Q && n < N ? e_s[i] * cb[(long long)i * N + n] : 0.f;
    });
    stage<false>(bs, [&](int k, int r) {
      const int i = k0 + k, p = p0 + r;
      return i < Q && p < P ? yb[i * hp + p] : 0.f;
    });
    __syncthreads();
    mm64(acc, as, bs);
    __syncthreads();
  }
  store64(w.g + (bch * N + n0) * P + p0, P, acc, N - n0, P - p0);
}

// ------------------------------------------------------------ pass b3 --
// One thread per (b, head, n, p): from dstate (zeros if null) back over the
// chunks, the gradient of the state leaving chunk c over its b2 sum Z_c,
// then x <- x exp(cum_last_c) + Z_c, the gradient of the state entering
// it; the last x is dh0.
__global__ void __launch_bounds__(kThreads)
ssd_grad_state_kernel(const float* __restrict__ dstate,
                      float* __restrict__ dh0, GradWork w, int nc, int H,
                      int NPe) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= NPe) return;
  const long long at = ((long long)b * H + h) * NPe + e;
  float x = dstate ? dstate[at] : 0.f;
  const long long step = (long long)H * NPe;
  float* s = w.g + ((long long)b * nc * H + h) * NPe + e;
  const float* dc = w.decay + (long long)b * nc * H + h;
  // 8 chunks at a time, last first: their loads all in flight before the
  // first store
  for (int c1 = nc; c1 > 0; c1 -= 8) {
    float z[8], d[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      z[c] = c1 - 1 - c >= 0 ? s[(c1 - 1 - c) * step] : 0.f;
      d[c] = c1 - 1 - c >= 0 ? dc[(long long)(c1 - 1 - c) * H] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c1 - 1 - c >= 0) {
        s[(c1 - 1 - c) * step] = x;
        x = fmaf(x, d[c], z[c]);
      }
    }
  }
  dh0[at] = x;
}

// ------------------------------------------------------------ pass b4 --
// One block per (tile (it, jt), it >= jt, of the chunk's (Q, Q) panel,
// chunk and b; x = it (it + 1) / 2 + jt), the heads in order: the tile of
// dy u^T (rows i, columns j) times L_ij = exp(cum_i - cum_j) (j <= i < Q)
// is added to the panel W, and times C B^T (held in registers) is R, whose
// row sums over the tile's j go to rows[head][jt][i] and column sums over
// its i to cols[head][it][j].
__global__ void __launch_bounds__(kThreads)
ssd_grad_panel_kernel(const float* __restrict__ u,
                      const float* __restrict__ loga,
                      const float* __restrict__ dy, GradWork w, int T, int H,
                      int P, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = as + kStaged;
  float* cum_s = bs + kStaged;         // [256]
  float* col_s = cum_s + kMaxChunk;    // [16][64] column sums by ty
  float* warp_s = col_s + 16 * 64;     // [32]
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= static_cast<int>(blockIdx.x)) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int i0 = 64 * it, j0 = 64 * jt;
  const int nc = T / Q, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P, bc = (long long)b * nc + c;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* cbt = w.cbt + bc * kMaxChunk * kMaxChunk;
  float cb[4][4], pan[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int q = 0; q < 4; ++q)        // CBt[j][i], zero but at j <= i < Q
      cb[a][q] = cbt[(long long)(j0 + 4 * tx + q) * kMaxChunk + i0 + 4 * ty + a];
  zero(pan);
  for (int h = 0; h < H; ++h) {
    chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);
    const float* yb = dy + t0 * hp + (long long)h * P;
    const float* ub = u + t0 * hp + (long long)h * P;
    float acc[4][4];
    zero(acc);
    for (int k0 = 0; k0 < P; k0 += kK) {
      stage<true>(as, [&](int k, int r) {
        const int i = i0 + r, p = k0 + k;
        return i < Q && p < P ? yb[i * hp + p] : 0.f;
      });
      stage<true>(bs, [&](int k, int r) {
        const int j = j0 + r, p = k0 + k;
        return j < Q && p < P ? ub[j * hp + p] : 0.f;
      });
      __syncthreads();
      mm64(acc, as, bs);
      __syncthreads();
    }
    float row[4] = {0.f, 0.f, 0.f, 0.f}, col[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + 4 * ty + a, j = j0 + 4 * tx + q;
        const float wv = j <= i && i < Q
            ? __expf(cum_s[i] - cum_s[j]) * acc[a][q] : 0.f;
        pan[a][q] += wv;
        const float r = cb[a][q] * wv;
        row[a] += r;
        col[q] += r;
      }
    const long long bh = (bc * H + h) * kMaxTiles;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float s = half_warp_sum(row[a]);
      const int i = i0 + 4 * ty + a;
      if (tx == 0 && i < Q) w.rows[(bh + jt) * kMaxChunk + i] = s;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) col_s[ty * 64 + 4 * tx + q] = col[q];
    __syncthreads();
    if (threadIdx.x < 64) {
      float s = 0.f;
      for (int y = 0; y < 16; ++y) s += col_s[y * 64 + threadIdx.x];
      const int j = j0 + threadIdx.x;
      if (j < Q) w.cols[(bh + it) * kMaxChunk + j] = s;
    }
    // the next head's chunk_cumsum syncs before col_s is written again
  }
  store64(w.panel + bc * kMaxChunk * kMaxChunk + (long long)i0 * kMaxChunk + j0,
          kMaxChunk, pan, Q - i0, Q - j0);
}

// ------------------------------------------------------------ pass b5 --
// One block per (head, chunk and b). For each 64-row tile of j and 64
// columns of P: (d B) g and (e C) h over N, whose rows dotted with u and dy
// give d_j (u_j . g^T B_j) and e_j (dy_j . C_j h); then du = (d B) g +
// sum_{i >= j} M_ij dy_i over the key tiles from the tile's own. Then <g, h>,
// dcum_k = rows - cols + e (dy . C h) - d (u . g^T B) (the last k adding
// e_last <g, h> + sum_j d_j (u_j . g^T B_j)) and dloga, its sum from k to
// the chunk's end.
__global__ void __launch_bounds__(kThreads)
ssd_grad_du_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ dy, const float* __restrict__ hin,
                   float* __restrict__ du, float* __restrict__ dloga,
                   GradWork w, int T, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = as + kStaged;
  float* cum_s = bs + kStaged;         // [256] each below
  float* e_s = cum_s + kMaxChunk;      // exp(cum)
  float* d_s = e_s + kMaxChunk;        // exp(cum_last - cum)
  float* ta_s = d_s + kMaxChunk;       // e (dy . C h)
  float* tb_s = ta_s + kMaxChunk;      // d (u . g^T B)
  float* dcum_s = tb_s + kMaxChunk;
  float* red_s = dcum_s + kMaxChunk;   // [256] <g, h> by thread
  float* warp_s = red_s + kMaxChunk;   // [32]
  const int h = blockIdx.x, nc = T / Q, c = blockIdx.y % nc,
            b = blockIdx.y / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P, bc = (long long)b * nc + c;
  const long long bch = bc * H + h;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);
  const float cum_last = cum_s[Q - 1];
  const bool in = static_cast<int>(threadIdx.x) < Q;
  e_s[threadIdx.x] = in ? __expf(cum_s[threadIdx.x]) : 0.f;
  d_s[threadIdx.x] = in ? __expf(cum_last - cum_s[threadIdx.x]) : 0.f;
  __syncthreads();
  const float* gs = w.g + bch * N * P;
  const float* hs = hin + bch * N * P;
  const float* yb = dy + t0 * hp + (long long)h * P;
  const float* ub = u + t0 * hp + (long long)h * P;
  const float* bb = Bm + t0 * N;
  const float* cb = Cm + t0 * N;
  const float* cbt = w.cbt + bc * kMaxChunk * kMaxChunk;
  for (int r0 = 0; r0 < Q; r0 += 64) {
    float ra[4] = {0.f, 0.f, 0.f, 0.f}, rb[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p0 = 0; p0 < P; p0 += 64) {
      float gb[4][4], ch[4][4];
      zero(gb);
      zero(ch);
      for (int n0 = 0; n0 < N; n0 += kK) {
        stage<true>(as, [&](int k, int r) {
          const int j = r0 + r, n = n0 + k;
          return j < Q && n < N ? d_s[j] * bb[(long long)j * N + n] : 0.f;
        });
        stage<false>(bs, [&](int k, int r) {
          const int n = n0 + k, p = p0 + r;
          return n < N && p < P ? gs[(long long)n * P + p] : 0.f;
        });
        __syncthreads();
        mm64(gb, as, bs);
        __syncthreads();
        stage<true>(as, [&](int k, int r) {
          const int j = r0 + r, n = n0 + k;
          return j < Q && n < N ? e_s[j] * cb[(long long)j * N + n] : 0.f;
        });
        stage<false>(bs, [&](int k, int r) {
          const int n = n0 + k, p = p0 + r;
          return n < N && p < P ? hs[(long long)n * P + p] : 0.f;
        });
        __syncthreads();
        mm64(ch, as, bs);
        __syncthreads();
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = r0 + 4 * ty + a, p = p0 + 4 * tx + q;
          if (j < Q && p < P) {
            rb[a] = fmaf(gb[a][q], ub[j * hp + p], rb[a]);
            ra[a] = fmaf(ch[a][q], yb[j * hp + p], ra[a]);
          }
        }
      for (int k0 = r0; k0 < Q; k0 += kK) {
        stage<true>(as, [&](int k, int r) {   // M^T: rows j, keys i >= j
          const int i = k0 + k, j = r0 + r;
          return j <= i && i < Q
              ? cbt[(long long)j * kMaxChunk + i] * __expf(cum_s[i] - cum_s[j])
              : 0.f;
        });
        stage<false>(bs, [&](int k, int r) {
          const int i = k0 + k, p = p0 + r;
          return i < Q && p < P ? yb[i * hp + p] : 0.f;
        });
        __syncthreads();
        mm64(gb, as, bs);
        __syncthreads();
      }
      store64(du + (t0 + r0) * hp + (long long)h * P + p0, hp, gb, Q - r0,
              P - p0);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float sa = half_warp_sum(ra[a]), sb = half_warp_sum(rb[a]);
      const int j = r0 + 4 * ty + a;
      if (tx == 0 && j < Q) {
        ta_s[j] = sa;
        tb_s[j] = sb;
      }
    }
  }
  // <g, h>: each thread's share, then summed in thread order by every thread
  float gh = 0.f;
  for (int e = threadIdx.x; e < N * P; e += kThreads) gh = fmaf(gs[e], hs[e], gh);
  red_s[threadIdx.x] = gh;
  __syncthreads();
  const int k = threadIdx.x;
  float dc = 0.f;
  if (in) {
    const long long bh = bch * kMaxTiles;
    const int tk = k / 64, nt = (Q + 63) / 64;
    dc = ta_s[k] - tb_s[k];
    for (int jt = 0; jt <= tk; ++jt) dc += w.rows[(bh + jt) * kMaxChunk + k];
    for (int it = tk; it < nt; ++it) dc -= w.cols[(bh + it) * kMaxChunk + k];
    if (k == Q - 1) {
      float s = 0.f, g_h = 0.f;
      for (int j = 0; j < Q; ++j) s += tb_s[j];
      for (int t = 0; t < kThreads; ++t) g_h += red_s[t];
      dc += __expf(cum_last) * g_h + s;
    }
  }
  dcum_s[k] = dc;
  __syncthreads();
  // dloga_m = sum_{k >= m} dcum_k: the prefix sum of dcum reversed
  const float x = block_scan(in ? dcum_s[Q - 1 - k] : 0.f, warp_s);
  if (in) dloga[(t0 + Q - 1 - k) * H + h] = x;
}

// ------------------------------------------------------------ pass b6 --
// One block per (64-row tile and 64 columns of N (x), dC or dB (y), chunk
// and b (z)): dC_i = sum_{j <= i} W_ij B_j + sum_h e_h,i (h_h dy_h,i) and
// dB_j = sum_{i >= j} W_ij C_i + sum_h d_h,j (g_h u_h,j), the heads in
// order.
__global__ void __launch_bounds__(kThreads)
ssd_grad_bc_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ dy, const float* __restrict__ hin,
                   float* __restrict__ dB, float* __restrict__ dC, GradWork w,
                   int T, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;
  float* bs = as + kStaged;
  float* cum_s = bs + kStaged;         // [256]
  float* s_s = cum_s + kMaxChunk;      // [256] the rows' decay factors
  float* warp_s = s_s + kMaxChunk;     // [32]
  const int tiles_n = (N + 63) / 64;
  const int r0 = (blockIdx.x / tiles_n) * 64, n0 = (blockIdx.x % tiles_n) * 64;
  const bool grad_c = blockIdx.y == 0;
  const int nc = T / Q, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P, bc = (long long)b * nc + c;
  const float* pan = w.panel + bc * kMaxChunk * kMaxChunk;
  const float* other = (grad_c ? Bm : Cm) + t0 * N;
  float acc[4][4];
  zero(acc);
  // the panel: dC takes W's rows i over j <= i, dB its columns j over i >= j
  const int k_from = grad_c ? 0 : r0;
  const int k_to = grad_c ? min(Q, r0 + 64) : Q;
  for (int k0 = k_from; k0 < k_to; k0 += kK) {
    if (grad_c)
      stage<true>(as, [&](int k, int r) {
        const int i = r0 + r, j = k0 + k;
        return i < Q && j < Q ? pan[(long long)i * kMaxChunk + j] : 0.f;
      });
    else
      stage<false>(as, [&](int k, int r) {
        const int i = k0 + k, j = r0 + r;
        return i < Q && j < Q ? pan[(long long)i * kMaxChunk + j] : 0.f;
      });
    stage<false>(bs, [&](int k, int r) {
      const int m = k0 + k, n = n0 + r;
      return m < Q && n < N ? other[(long long)m * N + n] : 0.f;
    });
    __syncthreads();
    mm64(acc, as, bs);
    __syncthreads();
  }
  // the states: dC with e dy against h, dB with d u against g
  const float* xs = grad_c ? dy : u;
  const float* st = grad_c ? hin : w.g;
  for (int h = 0; h < H; ++h) {
    chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);
    s_s[threadIdx.x] = static_cast<int>(threadIdx.x) < Q
        ? __expf(grad_c ? cum_s[threadIdx.x] : cum_s[Q - 1] - cum_s[threadIdx.x])
        : 0.f;
    __syncthreads();
    const float* xb = xs + t0 * hp + (long long)h * P;
    const float* sb = st + (bc * H + h) * N * P;
    for (int k0 = 0; k0 < P; k0 += kK) {
      stage<true>(as, [&](int k, int r) {
        const int i = r0 + r, p = k0 + k;
        return i < Q && p < P ? s_s[i] * xb[i * hp + p] : 0.f;
      });
      stage<true>(bs, [&](int k, int r) {
        const int n = n0 + r, p = k0 + k;
        return n < N && p < P ? sb[(long long)n * P + p] : 0.f;
      });
      __syncthreads();
      mm64(acc, as, bs);
      __syncthreads();
    }
  }
  store64((grad_c ? dC : dB) + (t0 + r0) * N + n0, N, acc, Q - r0, N - n0);
}

// The backward's passes on the stream in order (b1 is pass 1 at NP).
template <int NP>
cudaError_t launch_bwd(const float* u, const float* loga, const float* Bm,
                       const float* Cm, const float* hin, const float* dy,
                       const float* dstate, float* du, float* dloga, float* dB,
                       float* dC, float* dh0, float* ws, int B, int T, int H,
                       int P, int N, int Q, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_cb_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      cb_smem(NP));
  if (attr != cudaSuccess) return attr;
  const int nc = T / Q, bnc = B * nc;
  const GradWork w = carve_grad(ws, B, nc, H, P, N, NP);
  const int tn = (N + 63) / 64, tp = (P + 63) / 64, tq = (Q + 63) / 64;
  cudaError_t err;
  ssd_cb_kernel<NP><<<dim3(16, bnc), kThreads, cb_smem(NP), stream>>>(
      Bm, Cm, Work{w.cbt, w.ct, w.g, w.decay}, T, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_summary_kernel<<<dim3(tn * tp, H, bnc), kThreads,
                            grad_summary_smem() * 4, stream>>>(
      dy, loga, Cm, w, T, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_state_kernel<<<dim3((N * P + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, stream>>>(dstate, dh0, w, nc, H, N * P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_panel_kernel<<<dim3(tq * (tq + 1) / 2, bnc), kThreads,
                          grad_panel_smem() * 4, stream>>>(u, loga, dy, w, T,
                                                           H, P, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_du_kernel<<<dim3(H, bnc), kThreads, grad_du_smem() * 4, stream>>>(
      u, loga, Bm, Cm, dy, hin, du, dloga, w, T, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_bc_kernel<<<dim3(tq * tn, 2, bnc), kThreads, grad_bc_smem() * 4,
                       stream>>>(u, loga, Bm, Cm, dy, hin, dB, dC, w, T, H, P,
                                 N, Q);
  return cudaGetLastError();
}

bool shape_ok(int B, int T, int H, int P, int N, int Q) {
  return B > 0 && H > 0 && H <= 65535 && P > 0 && P % 16 == 0 && N > 0 &&
         N <= 128 && Q > 0 && Q <= kMaxChunk && T > 0 && T % Q == 0 &&
         (long long)B * (T / Q) <= 65535;
}

}  // namespace

// Dynamic shared memory (bytes) that a pass requests at state size N and
// head dim P: the forward's 1 to 4 (0 for pass 3), the backward's b1 to b6
// as 5 to 10 (b1 is pass 1; 0 for b3); -1 for a shape not taken.
extern "C" int repro_ssd_smem(int N, int P, int pass) {
  if (N <= 0 || N > 128 || P <= 0 || P % 16) return -1;
  const int np = N <= 32 ? 32 : N <= 64 ? 64 : 128;
  const int ps = P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16;
  switch (pass) {
    case 1: case 5: return cb_smem(np);
    case 2: return summary_smem(np, ps);
    case 3: case 7: return 0;
    case 4: return output_smem(ps);
    case 6: return grad_summary_smem() * 4;
    case 8: return grad_panel_smem() * 4;
    case 9: return grad_du_smem() * 4;
    case 10: return grad_bc_smem() * 4;
    default: return -1;
  }
}

// All pointers to contiguous fp32; h0 may be null (a zero initial state);
// chunk_states, (B, nc, H, N, P), receives the state entering each chunk
// (what the backward reads), or is null to keep them in ws, the workspace
// of ssd_plan's size. Launches the four passes on the stream in order;
// returns the first CUDA error (0 when all were accepted).
extern "C" int repro_ssd_scan(const float* u, const float* loga,
                              const float* Bm, const float* Cm,
                              const float* h0, float* y, float* state,
                              float* chunk_states, float* ws, int B, int T,
                              int H, int P, int N, int Q, void* stream) {
  if (!shape_ok(B, T, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 32)
    err = launch_ps<32>(u, loga, Bm, Cm, h0, y, state, chunk_states, ws, B,
                        T, H, P, N, Q, s);
  else if (N <= 64)
    err = launch_ps<64>(u, loga, Bm, Cm, h0, y, state, chunk_states, ws, B,
                        T, H, P, N, Q, s);
  else
    err = launch_ps<128>(u, loga, Bm, Cm, h0, y, state, chunk_states, ws, B,
                         T, H, P, N, Q, s);
  return static_cast<int>(err);
}

// The gradient of repro_ssd_scan: chunk_states (B, nc, H, N, P) as the
// forward wrote them, dy (B, T, H, P), dstate (B, H, N, P) or null for
// zeros; writes du, dloga, dBm, dCm and dh0 (the gradient of the state
// entering chunk 0), all contiguous fp32; ws is the workspace of
// ssd_bwd_plan's size. Launches passes b1 to b6 on the stream in order;
// returns the first CUDA error (0 when all were accepted).
extern "C" int repro_ssd_scan_bwd(const float* u, const float* loga,
                                  const float* Bm, const float* Cm,
                                  const float* chunk_states, const float* dy,
                                  const float* dstate, float* du, float* dloga,
                                  float* dBm, float* dCm, float* dh0,
                                  float* ws, int B, int T, int H, int P, int N,
                                  int Q, void* stream) {
  if (!shape_ok(B, T, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 32)
    err = launch_bwd<32>(u, loga, Bm, Cm, chunk_states, dy, dstate, du, dloga,
                         dBm, dCm, dh0, ws, B, T, H, P, N, Q, s);
  else if (N <= 64)
    err = launch_bwd<64>(u, loga, Bm, Cm, chunk_states, dy, dstate, du, dloga,
                         dBm, dCm, dh0, ws, B, T, H, P, N, Q, s);
  else
    err = launch_bwd<128>(u, loga, Bm, Cm, chunk_states, dy, dstate, du,
                          dloga, dBm, dCm, dh0, ws, B, T, H, P, N, Q, s);
  return static_cast<int>(err);
}
