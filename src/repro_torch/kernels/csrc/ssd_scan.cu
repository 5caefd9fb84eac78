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
// aligned. cum, the within-chunk prefix sums of loga (B, nc, H, 256), only
// in the backward's workspace (null in the forward's).
struct Work {
  float* cbt;
  float* ct;
  float* states;
  float* decay;
  float* cum;
};

Work carve(float* ws, int B, int nc, int H, int P, int N, int NP) {
  Work w;
  w.cbt = ws;
  w.ct = w.cbt + (long long)B * nc * kMaxChunk * kMaxChunk;
  w.states = w.ct + (long long)B * nc * NP * kMaxChunk;
  w.decay = w.states + (long long)B * nc * H * N * P;
  w.cum = nullptr;
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
// exp(cum_last). kGrad: the backward's pass b2, its dual, with C for B, dy
// for u and exp(cum_k) for the weight, Z_c = sum_k exp(cum_k) C_k (x) dy_k
// into the state gradients; the block of P slice 0 also writes the chunk's
// prefix sums of loga into w.cum for the passes after it
// (ssd_grad_summary_kernel, the same body under its own name).
template <int NP, int PS, bool kGrad>
__device__ __forceinline__ void summary_body(const float* __restrict__ u,
                                             const float* __restrict__ loga,
                                             const float* __restrict__ Bm,
                                             Work w, int T, int H, int P,
                                             int N, int Q) {
  using C = Cols<PS>;
  constexpr int RV = NP >= 64 ? 4 : 2, RG = NP / (16 * RV);
  constexpr int kRows = RG * RV, kColsT = C::kCG * C::kCV;
  constexpr int kStage = kKTile * (NP + PS);
  extern __shared__ __align__(16) float smem[];
  float* cum_s = smem;                 // [256]
  float* warp_s = cum_s + kMaxChunk;   // [32]
  float* wgt_s = warp_s + 32;          // [256] the rows' weights
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
  const float ck = cum_s[threadIdx.x];
  wgt_s[threadIdx.x] = static_cast<int>(threadIdx.x) < Q
      ? __expf(kGrad ? ck : cum_last - ck) : 0.f;
  const long long bch = ((long long)b * nc + c) * H + h;
  if (blockIdx.x == 0) {
    if (threadIdx.x == 0) w.decay[bch] = __expf(cum_last);
    if (kGrad) w.cum[bch * kMaxChunk + threadIdx.x] = ck;
  }

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

template <int NP, int PS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_summary_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                   const float* __restrict__ Bm, Work w, int T, int H, int P,
                   int N, int Q) {
  summary_body<NP, PS, false>(u, loga, Bm, w, T, H, P, N, Q);
}

template <int NP, int PS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_grad_summary_kernel(const float* __restrict__ dy,
                        const float* __restrict__ loga,
                        const float* __restrict__ Cm, Work w, int T, int H,
                        int P, int N, int Q) {
  summary_body<NP, PS, true>(dy, loga, Cm, w, T, H, P, N, Q);
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
//  b2. each chunk's sum_i e_i C_i (x) dy_i, the dual of pass 2 and pass 2's
//      body (ssd_grad_summary_kernel), which also writes each (chunk,
//      head)'s prefix sums of loga for b4 and b6;
//  b3. the reverse state pass from dstate, the dual of pass 3: g leaving
//      each chunk over b2's sums, g_in = b2 + e_last g, and dh0;
//  b4. the panel: one block of 64 threads per 64 x 64 tile (it >= jt) of
//      the chunk's (Q, Q) panel, chunk and b loops over the heads in order;
//      each head's tile of dy u^T times L is added to W = sum_h L_h *
//      (dy_h u_h^T) in registers, and times C B^T gives R, whose row and
//      column sums (the dcum terms of the intra-chunk product) go to the
//      workspace per head and tile, so that dloga sums them in a fixed
//      order; W is written transposed, W^T[j][i], and the tiles above the
//      diagonal as zeros;
//  b5. one block per (head, chunk and b), shaped as pass 4 (a warp owns the
//      16-row strips w and 15 - w of the chunk): C h and B g over N, whose
//      rows dotted with dy and u give e (dy . C h) and d (u . g^T B); du =
//      d (B g) + (C B^T * L)^T dy over the key tiles from each strip's own;
//      then <g, h>, dcum and its reverse prefix sum within the chunk, dloga;
//  b6. one block per (128-row tile, dC or dB, chunk and b) over all of N:
//      dC = W B + sum_h e_h dy_h h_h^T and dB = W^T C + sum_h d_h u_h g_h^T,
//      the panel taken once per chunk before the heads' states (B and C are
//      shared by the heads, so the (Q, Q, N) products are not repeated); the
//      heads' part is one product of depth H x P.
// Bound: operations, about twice the forward's (at the mamba2-1.3b training
// shape, B 8, T 2048: 105 GFLOP of fp32 FMAs on 1.2 GB; the chip smoke
// computes it from the shapes). Every product is an fp32 FMA on the CUDA
// cores with 8 x 8 outputs a thread over operands that cp.async brings into
// double-buffered shared memory 32 rows or columns of depth at a time while
// the stage before is computed; a factor (exp(cum) of a row, the decay and
// causal mask of C B^T) is applied in shared memory once a stage has
// landed. Three operand reads, each 16 wavefronts of shared memory for 64
// FMAs a thread as the forward's mm_tn: A and B both depth-major (mm_tn);
// A row-major, B depth-major (mm_rk); both row-major (mm_nt), B's rows
// swizzled so that the 8 threads of a quarter-warp read 8 rows from 8
// bank groups. No atomics: every sum over heads, tiles and rows is taken in
// a fixed order, so calls and CUDA-graph replays are bit-identical.
constexpr int kMaxTiles = kMaxChunk / 64;  // 64-row tiles of a chunk
constexpr int kALd = kKTile + 4;           // b5's A rows: 32 floats + pad

// acc[g * 4 + i][h * CV + j] += sum_k A[r[g] + i][k] * B[k][c0 + h * cs + j]
// over k in [0, K), two at a time: A row-major (row stride lda), B
// depth-major (row stride ldb). The threads of a quarter-warp share their
// rows (a broadcast read of A) and take consecutive column vectors of B
// (conflict-free); with lda 4 more than a multiple of 32 the two rows a
// half-warp reads fall in different banks, and two depths at a time keep
// the operands to 18 registers, so that b5 holds 128 without spilling.
template <int RG, int CG, int CV, int K>
__device__ __forceinline__ void mm_rk(float (&acc)[RG * 4][CG * CV],
                                      const float* A, int lda,
                                      const int (&r)[RG], const float* B,
                                      int ldb, int c0, int cs) {
#pragma unroll 1
  for (int k = 0; k < K; k += 2) {
    float b[2][CG * CV];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int h = 0; h < CG; ++h)
        lds<CV>(b[e] + h * CV, B + (k + e) * ldb + c0 + h * cs);
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a[2];
        lds<2>(a, A + (r[g] + i) * lda + k);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int j = 0; j < CG * CV; ++j)
            acc[g * 4 + i][j] = fmaf(a[e], b[e][j], acc[g * 4 + i][j]);
      }
  }
}

// The row-major stage of a product's B side: rows of 32 floats, the 16-byte
// chunk q of row c at chunk q ^ ((c >> 2) & 7), so that rows 4 apart sit
// in different bank groups.
__device__ __forceinline__ int swz(int c, int q) {
  return c * kKTile + 4 * (q ^ ((c >> 2) & 7));
}

// acc[g * 4 + i][h * 4 + j] += sum_k A[r[g] + i][k] * Bt[c0 + h * cs + j][k]
// over the 32 k of a stage: A row-major (row stride lda), Bt in the swizzled
// rows of swz. The threads of a quarter-warp share their rows and read the
// rows 4 tx + j of Bt, 8 different chunk positions.
template <int RG, int CG>
__device__ __forceinline__ void mm_nt(float (&acc)[RG * 4][CG * 4],
                                      const float* A, int lda,
                                      const int (&r)[RG], const float* Bt,
                                      int c0, int cs) {
#pragma unroll 1
  for (int q = 0; q < kKTile / 4; ++q) {
    float b[CG * 4][4];
#pragma unroll
    for (int h = 0; h < CG; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        lds<4>(b[h * 4 + j], Bt + swz(c0 + h * cs + j, q));
#pragma unroll
    for (int g = 0; g < RG; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float a[4];
        lds<4>(a, A + (r[g] + i) * lda + 4 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < CG * 4; ++j)
            acc[g * 4 + i][j] = fmaf(a[e], b[j][e], acc[g * 4 + i][j]);
      }
  }
}

// rows x (4 cpr) floats from rows of stride ld at src into dst (row stride
// ldd, or the swizzled 32-float rows of swz when kSwz) with 16-byte
// cp.async, by nthr threads from thread id; rows at or past nr and chunks
// at or past nq are zero-filled.
template <bool kSwz>
__device__ __forceinline__ void stage16(float* dst, int ldd, const float* src,
                                        long long ld, int rows, int cpr,
                                        int nr, int nq, int id, int nthr) {
  for (int e = id; e < rows * cpr; e += nthr) {
    const int r = e / cpr, q = e % cpr;
    const bool in = r < nr && q < nq;
    cp_async16(dst + (kSwz ? swz(r, q) : r * ldd + 4 * q),
               in ? src + r * ld + 4 * q : src, in);
  }
}

// The same with 4-byte copies of cols floats a row (rows of Bm and Cm,
// whose length N need not be a multiple of 4); columns at or past nc are
// zero-filled.
__device__ __forceinline__ void stage4(float* dst, int ldd, const float* src,
                                       long long ld, int rows, int cols,
                                       int nr, int nc, int id, int nthr) {
  for (int e = id; e < rows * cols; e += nthr) {
    const int r = e / cols, c = e % cols;
    const bool in = r < nr && c < nc;
    cp_async4(dst + r * ldd + c, in ? src + r * ld + c : src, in);
  }
}

// The sum of v over the 8 threads of a quarter-warp in a fixed tree; every
// thread gets it.
__device__ __forceinline__ float quarter_warp_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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
// panel W^T (B, nc, 256, 256), the row and column sums of each head's R per
// tile (B, nc, H, 4, 256) each, the prefix sums of loga (B, nc, H, 256),
// and the chunk decays (B, nc, H) last.
struct GradWork {
  float* cbt;
  float* ct;
  float* g;
  float* panel;
  float* rows;
  float* cols;
  float* cum;
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
  w.cum = w.cols + bc * H * kMaxTiles * kMaxChunk;
  w.decay = w.cum + bc * H * kMaxChunk;
  return w;
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
// One block of 64 threads per (tile (it, jt) of the chunk's (Q, Q) panel,
// x = it * tq + jt, chunk and b), the heads in order: the tile of dy u^T
// (rows i, columns j; an mm_nt product over P, dy's and u's rows staged
// as they lie) times L_ij = exp(cum_i - cum_j) (j <= i < Q) is added to the
// panel W, and times C B^T (the tile of CBt, staged once) is R, whose row
// sums over the tile's j go to rows[head][jt][i] and column sums over its i
// to cols[head][it][j]. A thread owns rows 4 ty + 32 g + [0, 4) and columns
// 4 tx + 32 h + [0, 4) of the tile. The tiles above the diagonal (it < jt)
// only write their zeros into W^T. Four blocks share an SM (255 registers a
// thread): capped at 204 for five, it spilled 460 bytes and ran 19% slower
// (H100).
constexpr int kPanelThreads = 64;
constexpr int kPanelStage = 2 * 64 * kKTile + 2 * 64;   // dy, u, cum_i, cum_j

__global__ void __launch_bounds__(kPanelThreads, 4)
ssd_grad_panel_kernel(const float* __restrict__ u,
                      const float* __restrict__ dy, GradWork w, int T, int H,
                      int P, int Q) {
  extern __shared__ __align__(16) float smem[];
  float* cb_s = smem;                  // [64 j][64 i] CBt, chunks swizzled
  float* col_s = cb_s + 64 * 64;       // [2][64] column sums by warp
  float* stages = col_s + 2 * 64;      // 2 x kPanelStage
  const int tq = (Q + 63) / 64;
  const int it = blockIdx.x / tq, jt = blockIdx.x % tq;
  const int i0 = 64 * it, j0 = 64 * jt;
  const int nc = T / Q, c = blockIdx.y % nc, b = blockIdx.y / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P, bc = (long long)b * nc + c;
  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;
  float* pan_t = w.panel + bc * kMaxChunk * kMaxChunk;   // W^T[j][i]
  if (it < jt) {                       // above the diagonal: zeros
    for (int e = t; e < 64 * 16; e += kPanelThreads)
      *reinterpret_cast<float4*>(pan_t + (long long)(j0 + e / 16) * kMaxChunk +
                                 i0 + 4 * (e % 16)) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  // CBt rows j, columns i of the tile: 16 chunks a row, chunk q at
  // q ^ ((j >> 2) & 7)
  const float* cbt = w.cbt + bc * kMaxChunk * kMaxChunk;
  for (int e = t; e < 64 * 16; e += kPanelThreads) {
    const int j = e / 16, q = e % 16;
    cp_async16(cb_s + j * 64 + 4 * (q ^ ((j >> 2) & 7)),
               cbt + (long long)(j0 + j) * kMaxChunk + i0 + 4 * q, true);
  }
  const int nps = (P + kKTile - 1) / kKTile, n_it = H * nps;
  const float* cum = w.cum + bc * H * kMaxChunk;
  auto load = [&](int s) {
    float* st = stages + (s & 1) * kPanelStage;
    const int h = s / nps, p0 = (s % nps) * kKTile;
    const int nq = min(kKTile, P - p0) / 4;
    const long long at = t0 * hp + (long long)h * P + p0;
    stage16<false>(st, kKTile, dy + at + i0 * hp, hp, 64, 8, Q - i0, nq, t,
                   kPanelThreads);
    stage16<true>(st + 64 * kKTile, kKTile, u + at + j0 * hp, hp, 64, 8,
                  Q - j0, nq, t, kPanelThreads);
    if (t < 32) {                      // cum rows i0.. and j0.. of head h
      const float* ch = cum + (long long)h * kMaxChunk;
      cp_async16(st + 2 * 64 * kKTile + 4 * t,
                 ch + (t < 16 ? i0 + 4 * t : j0 + 4 * (t - 16)), true);
    }
  };
  load(0);
  cp_async_commit();

  const int r[2] = {4 * ty, 32 + 4 * ty};
  const int c0 = 4 * tx;
  float acc[8][8], pan[8][8];
  zero(pan);
  for (int s = 0; s < n_it; ++s) {
    if (s + 1 < n_it) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = stages + (s & 1) * kPanelStage;
    const int h = s / nps;
    if (s % nps == 0) zero(acc);
    mm_nt<2, 2>(acc, st, kKTile, r, st + 64 * kKTile, c0, 32);
    if (s % nps == nps - 1) {          // the head's tile is complete
      const float* cum_i = st + 2 * 64 * kKTile;
      const float* cum_j = cum_i + 64;
      // L off the diagonal (every j < every i) as exp(cum_i - cum_i0) times
      // exp(cum_i0 - cum_j), both <= 1: 16 exps a thread instead of 64 (a
      // factor underflows only where L is below fp32's range anyway)
      const bool diag = it == jt;
      float fj[8], row[8], col[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        fj[k] = diag ? 0.f
                     : __expf(cum_i[0] - cum_j[c0 + 32 * (k >> 2) + (k & 3)]);
        row[k] = col[k] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float fi[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          fi[a] = diag ? 0.f : __expf(cum_i[r[g] + a] - cum_i[0]);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int jl = c0 + 32 * hh + jj, cj = hh * 4 + jj;
            float cbv[4];              // C_i . B_j for the 4 rows i
            lds<4>(cbv, cb_s + jl * 64 + 4 * ((r[g] >> 2) ^ ((jl >> 2) & 7)));
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int il = r[g] + a, ri = g * 4 + a;
              const int i = i0 + il, j = j0 + jl;
              const float wv = !(j <= i && i < Q) ? 0.f
                  : diag ? __expf(cum_i[il] - cum_j[jl]) * acc[ri][cj]
                         : fi[a] * fj[cj] * acc[ri][cj];
              pan[ri][cj] += wv;
              const float rv = cbv[a] * wv;
              row[ri] += rv;
              col[cj] += rv;
            }
          }
      }
      // rows: over the tile's j, the 8 tx of a quarter-warp; thread tx
      // writes row tx of its 8
      const long long bh = (bc * H + h) * kMaxTiles;
#pragma unroll
      for (int k = 0; k < 8; ++k) row[k] = quarter_warp_sum(row[k]);
      {
        float mine = row[0];
#pragma unroll
        for (int k = 1; k < 8; ++k) mine = tx == k ? row[k] : mine;
        const int i = i0 + r[tx >> 2] + (tx & 3);
        if (i < Q) w.rows[(bh + jt) * kMaxChunk + i] = mine;
      }
      // columns: over the tile's i, the 4 ty of a warp, then the 2 warps
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        col[k] += __shfl_xor_sync(kFull, col[k], 8);
        col[k] += __shfl_xor_sync(kFull, col[k], 16);
      }
      if ((t & 31) < 8) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            col_s[(t >> 5) * 64 + c0 + 32 * hh + jj] = col[hh * 4 + jj];
      }
      __syncthreads();
      const int j = j0 + t;
      if (j < Q) w.cols[(bh + it) * kMaxChunk + j] = col_s[t] + col_s[64 + t];
    }
    __syncthreads();                   // before the next load overwrites it
  }
  // W^T[j][i]: a float4 of the 4 rows i for each column j
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cj = hh * 4 + jj;
        *reinterpret_cast<float4*>(
            pan_t + (long long)(j0 + c0 + 32 * hh + jj) * kMaxChunk + i0 +
            r[g]) = make_float4(pan[g * 4][cj], pan[g * 4 + 1][cj],
                                pan[g * 4 + 2][cj], pan[g * 4 + 3][cj]);
      }
}

// ------------------------------------------------------------ pass b5 --
// One block per (head, chunk and b), for each P slice of PS columns: a warp
// w owns the strips w and 15 - w (16 rows each; a thread 4 rows of each and
// PS / 8 columns, Cols<PS>), as pass 4. The depth steps of 32 run over the
// N tiles of (C, h), then of (B, g), then over the key tiles of (CBt, dy),
// all mm_rk with A's rows staged as they lie: C h done, its rows dotted
// with dy give e (dy . C h); B g done, its rows dotted with u give d (u .
// g^T B), and B g times d is du's first term; each key tile of CBt is
// turned into (C B^T * L)^T in shared memory and adds M^T dy, a strip
// taking the key tiles from its own rows. Then <g, h>, dcum_k = rows - cols
// + e (dy . C h) - d (u . g^T B) (the last k adding e_last <g, h> +
// sum_j d_j (u_j . g^T B_j)) and dloga, its sum from k to the chunk's end.
template <int NP, int PS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_grad_du_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                   const float* __restrict__ Bm, const float* __restrict__ Cm,
                   const float* __restrict__ dy, const float* __restrict__ hin,
                   float* __restrict__ du, float* __restrict__ dloga,
                   GradWork w, int T, int H, int P, int N, int Q) {
  using Cl = Cols<PS>;
  constexpr int CG = Cl::kCG, CV = Cl::kCV, kCols = CG * CV;
  constexpr int kA = kMaxChunk * kALd;          // A rows [256][32 + 4]
  constexpr int kStage = kA + kKTile * PS;      // + B [32][PS]
  extern __shared__ __align__(16) float smem[];
  float* cum_s = smem;                 // [256] each below
  float* ta_s = cum_s + kMaxChunk;     // e (dy . C h)
  float* tb_s = ta_s + kMaxChunk;      // d (u . g^T B)
  float* dcum_s = tb_s + kMaxChunk;
  float* red_s = dcum_s + kMaxChunk;   // [256] <g, h> by thread
  float* warp_s = red_s + kMaxChunk;   // [32]
  float* stages = warp_s + 32;         // 2 x kStage
  const int h = blockIdx.x, nc = T / Q, c = blockIdx.y % nc,
            b = blockIdx.y / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P, bc = (long long)b * nc + c;
  const long long bch = bc * H + h;
  const float* gs = w.g + bch * N * P;
  const float* hs = hin + bch * N * P;
  const float* yb = dy + t0 * hp + (long long)h * P;
  const float* ub = u + t0 * hp + (long long)h * P;
  const float* cbt = w.cbt + bc * kMaxChunk * kMaxChunk;
  const int n_nt = (N + kKTile - 1) / kKTile, n_kt = 2 * n_nt +
                   (Q + kKTile - 1) / kKTile;
  const int q_rows = (Q + kStrip - 1) & ~(kStrip - 1);   // whole strips
  // the staged rows of A at step kt: the chunk's rows, for a key tile only
  // those of the strips that reach it
  auto a_rows = [&](int kt) {
    return kt < 2 * n_nt ? q_rows
        : min(q_rows, ((kt - 2 * n_nt) * kKTile + kKTile + kStrip - 1) &
                      ~(kStrip - 1));
  };
  const int n_steps = (P / PS) * n_kt;
  // step s: slice p0 = (s / n_kt) PS, depth step kt = s % n_kt
  auto load = [&](int s) {
    const int kt = s % n_kt, p0 = s / n_kt * PS;
    float* st = stages + (s & 1) * kStage;
    float* bs = st + kA;
    if (kt < 2 * n_nt) {
      const int n0 = (kt % n_nt) * kKTile;
      const float* x = (kt < n_nt ? Cm : Bm) + t0 * N + n0;
      if (N % 4 == 0)
        stage16<false>(st, kALd, x, N, a_rows(kt), kKTile / 4, Q,
                       (N - n0) / 4, threadIdx.x, kThreads);
      else
        stage4(st, kALd, x, N, a_rows(kt), kKTile, Q, N - n0, threadIdx.x,
               kThreads);
      stage16<false>(bs, PS, (kt < n_nt ? hs : gs) + (long long)n0 * P + p0,
                     P, kKTile, PS / 4, N - n0, PS / 4, threadIdx.x,
                     kThreads);
    } else {
      const int i0 = (kt - 2 * n_nt) * kKTile;
      stage16<false>(st, kALd, cbt + i0, kMaxChunk, a_rows(kt), kKTile / 4,
                     Q, kKTile / 4, threadIdx.x, kThreads);
      stage16<false>(bs, PS, yb + i0 * hp + p0, hp, kKTile, PS / 4, Q - i0,
                     PS / 4, threadIdx.x, kThreads);
    }
  };
  load(0);
  cp_async_commit();
  chunk_cumsum(cum_s, warp_s, loga + t0 * H + h, H, Q);
  const float cum_last = cum_s[Q - 1];
  const bool in = static_cast<int>(threadIdx.x) < Q;
  ta_s[threadIdx.x] = 0.f;
  tb_s[threadIdx.x] = 0.f;

  const int tx = threadIdx.x & 7, ry = (threadIdx.x >> 3) & 3;
  const int wp = threadIdx.x >> 5;
  const int s_lo = wp, s_hi = 15 - wp;
  const int r_lo = kStrip * s_lo + 4 * ry, r_hi = kStrip * s_hi + 4 * ry;
  const int rows[2] = {r_lo, r_hi}, row_lo[1] = {r_lo}, row_hi[1] = {r_hi};
  const int c0 = CV * tx;
  float acc[8][kCols];                 // rows r_lo + [0, 4), r_hi + [0, 4)
  auto& lo = *reinterpret_cast<float(*)[4][kCols]>(&acc[0][0]);
  auto& hi = *reinterpret_cast<float(*)[4][kCols]>(&acc[4][0]);
  // this thread's row dots with x's rows (dy or u) over its columns of the
  // slice, summed over the quarter-warp, times f(row), added to t_s[row]
  auto row_dots = [&](const float* x, int p0, float* t_s, bool decay) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = rows[i >> 2] + (i & 3);
      float s = 0.f;
      if (row < Q) {
#pragma unroll
        for (int q = 0; q < CG; ++q) {
          float v[CV];
          const float* xp = x + (long long)row * hp + p0 + c0 + q * Cl::kStep;
#pragma unroll
          for (int j = 0; j < CV; ++j) v[j] = xp[j];
#pragma unroll
          for (int j = 0; j < CV; ++j) s = fmaf(acc[i][q * CV + j], v[j], s);
        }
      }
      s = quarter_warp_sum(s);
      if (tx == 0 && row < Q)
        t_s[row] += s * __expf(decay ? cum_last - cum_s[row] : cum_s[row]);
    }
  };

  for (int s = 0; s < n_steps; ++s) {
    const int kt = s % n_kt, p0 = s / n_kt * PS;
    if (kt == 0) zero(acc);
    if (s + 1 < n_steps) load(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* at = stages + (s & 1) * kStage;
    float* bt = at + kA;
    int lim = Q;                       // strips from this row on add nothing
    if (kt == n_nt) {                  // C h done: e (dy . C h)
      row_dots(yb, p0, ta_s, false);
      zero(acc);
    }
    if (kt >= 2 * n_nt) {
      const int k0 = (kt - 2 * n_nt) * kKTile;
      lim = min(Q, k0 + kKTile);       // a strip takes keys from its rows on
      if (kt == 2 * n_nt) {            // B g done: d (u . g^T B), then d B g
        row_dots(ub, p0, tb_s, true);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int row = rows[i >> 2] + (i & 3);
          const float d = row < Q ? __expf(cum_last - cum_s[row]) : 0.f;
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[i][j] *= d;
        }
      }
      // (C B^T * L)^T in place: row j, key i = k0 + k kept where
      // j <= i < Q, times exp(cum_i - cum_j)
      const int n4 = a_rows(kt) * (kKTile / 4);
      for (int e = threadIdx.x; e < n4; e += kThreads) {
        const int j = e >> 3, k = 4 * (e & 7);
        float4* m = reinterpret_cast<float4*>(at + j * kALd + k);
        float4 v = *m;
        const float cj = cum_s[j];
        float* x = &v.x;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = k0 + k + q;
          x[q] = j <= i && i < Q ? x[q] * __expf(cum_s[i] - cj) : 0.f;
        }
        *m = v;
      }
      __syncthreads();
    }
    const bool act_lo = kStrip * s_lo < lim, act_hi = kStrip * s_hi < lim;
    if (act_lo && act_hi)              // one read of B for both strips
      mm_rk<2, CG, CV, kKTile>(acc, at, kALd, rows, bt, PS, c0,
                                  Cl::kStep);
    else if (act_lo)
      mm_rk<1, CG, CV, kKTile>(lo, at, kALd, row_lo, bt, PS, c0,
                                  Cl::kStep);
    else if (act_hi)
      mm_rk<1, CG, CV, kKTile>(hi, at, kALd, row_hi, bt, PS, c0,
                                  Cl::kStep);
    __syncthreads();                   // before the next load overwrites it
    if (kt == n_kt - 1) {              // the slice's du
      float* db = du + t0 * hp + (long long)h * P + p0 + c0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = rows[i >> 2] + (i & 3);
        if (row >= Q) continue;
#pragma unroll
        for (int q = 0; q < CG; ++q)
#pragma unroll
          for (int j = 0; j < CV; ++j)
            db[(long long)row * hp + q * Cl::kStep + j] = acc[i][q * CV + j];
      }
    }
  }
  cp_async_wait<0>();
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
// One block of 2 NP threads per (128-row tile (x), dC or dB (y), chunk and
// b (z)) over all NP columns of N: dC_i = sum_{j <= i} W_ij B_j + sum_h
// e_h,i (h_h dy_h,i) and dB_j = sum_{i >= j} W_ij C_i + sum_h d_h,j (g_h
// u_h,j). A thread owns rows 4 ty + 64 g + [0, 4) and columns 4 tx + NP / 2
// h + [0, 4) (8 x 8). The depth steps of 32: first the panel's, dC's an
// mm_tn of W^T's rows and B's rows, dB's an mm_nt of W^T's rows and C^T's;
// then, for each head in order, its P in steps of 32 as one product of
// depth H x P, mm_nt of dy's (or u's) rows, times the head's e (or d) in
// shared memory once staged, and h's (or g's) rows. At N 128 one block an
// SM (no register cap: 7% faster than two blocks with 48 bytes spilled, at
// mamba2-1.3b's training shape on an H100); its 256 blocks are two waves.
constexpr int kBcRows = 128;

template <int NP>
__global__ void __launch_bounds__(2 * NP, NP == 128 ? 1 : 4)
ssd_grad_bc_kernel(const float* __restrict__ u, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ dy,
                   const float* __restrict__ hin, float* __restrict__ dB,
                   float* __restrict__ dC, GradWork w, int T, int H, int P,
                   int N, int Q) {
  constexpr int kThr = 2 * NP;
  constexpr int kA = kBcRows * kKTile;              // A: 128 rows x 32
  constexpr int kStage = kA + NP * kKTile + kBcRows + 4;   // + B, cum
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                // 2 x kStage
  const int r0 = blockIdx.x * kBcRows;
  const bool grad_c = blockIdx.y == 0;
  const int nc = T / Q, c = blockIdx.z % nc, b = blockIdx.z / nc;
  const long long t0 = (long long)b * T + (long long)c * Q;
  const long long hp = (long long)H * P, bc = (long long)b * nc + c;
  const int t = threadIdx.x, tx = t % (NP / 8), ty = t / (NP / 8);
  const float* pan_t = w.panel + bc * kMaxChunk * kMaxChunk;   // W^T[j][i]
  // the panel's depth: dC over j < min(Q, r0 + 128), dB over i in [r0, Q)
  const int k_pan = grad_c ? min(Q, r0 + kBcRows) : Q - r0;
  const int n_pan = (k_pan + kKTile - 1) / kKTile;
  const int nps = (P + kKTile - 1) / kKTile, n_kt = n_pan + H * nps;
  const float* xs = grad_c ? dy : u;
  const float* ss = grad_c ? hin : w.g;
  auto load = [&](int kt) {
    float* st = stages + (kt & 1) * kStage;
    float* bs = st + kA;
    if (kt < n_pan) {
      const int k0 = kt * kKTile;
      if (grad_c) {                    // W^T rows j, B rows j (depth-major)
        stage16<false>(st, kBcRows, pan_t + (long long)k0 * kMaxChunk + r0,
                       kMaxChunk, kKTile, kBcRows / 4, Q - k0, kBcRows / 4, t,
                       kThr);
        stage4(bs, NP, Bm + (t0 + k0) * N, N, kKTile, NP, Q - k0, N, t, kThr);
      } else {                         // W^T rows j at i = r0 + k0, C^T rows
        stage16<false>(st, kKTile, pan_t + (long long)r0 * kMaxChunk + r0 + k0,
                       kMaxChunk, kBcRows, kKTile / 4, Q - r0, kKTile / 4, t,
                       kThr);
        stage16<true>(bs, kKTile, w.ct + bc * NP * kMaxChunk + r0 + k0,
                      kMaxChunk, NP, kKTile / 4, NP, kKTile / 4, t, kThr);
      }
    } else {
      const int h = (kt - n_pan) / nps, p0 = (kt - n_pan) % nps * kKTile;
      const int nq = min(kKTile, P - p0) / 4;
      stage16<false>(st, kKTile, xs + (t0 + r0) * hp + (long long)h * P + p0,
                     hp, kBcRows, kKTile / 4, Q - r0, nq, t, kThr);
      stage16<true>(bs, kKTile, ss + (bc * H + h) * N * P + p0, P, NP,
                    kKTile / 4, N, nq, t, kThr);
      // the head's cum over the tile's rows, and the 4 around cum_last
      const float* ch = w.cum + (bc * H + h) * kMaxChunk;
      if (t < kBcRows / 4 + 1)
        cp_async16(bs + NP * kKTile + 4 * t,
                   t < kBcRows / 4 ? ch + r0 + 4 * t : ch + ((Q - 1) & ~3),
                   true);
    }
  };
  load(0);
  cp_async_commit();

  const int r[2] = {4 * ty, 64 + 4 * ty};
  const int c0 = 4 * tx, cs = NP / 2;
  float acc[8][8];
  zero(acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load(kt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* st = stages + (kt & 1) * kStage;
    float* bs = st + kA;
    if (kt < n_pan) {
      if (grad_c)
        mm_tn<2, 4, 2, 4>(acc, st, kBcRows, r, bs, NP, c0, cs, 0, kKTile);
      else
        mm_nt<2, 2>(acc, st, kKTile, r, bs, c0, cs);
    } else {
      // the rows times the head's e_i (dC) or d_j (dB)
      const float* cum = bs + NP * kKTile;
      const float cum_last = cum[kBcRows + ((Q - 1) & 3)];
      for (int e = t; e < kBcRows * kKTile / 4; e += kThr) {
        const int row = e >> 3;
        float4* m = reinterpret_cast<float4*>(st + 4 * e);
        const float f = __expf(grad_c ? cum[row] : cum_last - cum[row]);
        float4 v = *m;
        v.x *= f; v.y *= f; v.z *= f; v.w *= f;
        *m = v;
      }
      __syncthreads();
      mm_nt<2, 2>(acc, st, kKTile, r, bs, c0, cs);
    }
    __syncthreads();                   // before the next load overwrites it
  }
  float* out = (grad_c ? dC : dB) + t0 * N;
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = r0 + r[g] + a;
      if (i >= Q) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int n = c0 + hh * cs + jj;
          if (n < N) out[(long long)i * N + n] = acc[g * 4 + a][hh * 4 + jj];
        }
    }
}

// Shared memory (floats) of b4 to b6 (b2 is pass 2's).
constexpr int grad_panel_smem() { return 64 * 64 + 2 * 64 + 2 * kPanelStage; }
constexpr int grad_du_smem(int ps) {
  return 5 * kMaxChunk + 32 + 2 * (kMaxChunk * kALd + kKTile * ps);
}
constexpr int grad_bc_smem(int np) {
  return 2 * (kBcRows * kKTile + np * kKTile + kBcRows + 4);
}

// The backward's passes on the stream in order (b1 is pass 1 at NP, b2
// pass 2's body in its gradient mode).
template <int NP, int PS>
cudaError_t launch_bwd(const float* u, const float* loga, const float* Bm,
                       const float* Cm, const float* hin, const float* dy,
                       const float* dstate, float* du, float* dloga, float* dB,
                       float* dC, float* dh0, float* ws, int B, int T, int H,
                       int P, int N, int Q, cudaStream_t stream) {
  static const cudaError_t attrs[] = {
      cudaFuncSetAttribute(ssd_cb_kernel<NP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           cb_smem(NP)),
      cudaFuncSetAttribute(ssd_grad_summary_kernel<NP, PS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           summary_smem(NP, PS)),
      cudaFuncSetAttribute(ssd_grad_panel_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           grad_panel_smem() * 4),
      cudaFuncSetAttribute(ssd_grad_du_kernel<NP, PS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           grad_du_smem(PS) * 4),
      cudaFuncSetAttribute(ssd_grad_bc_kernel<NP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           grad_bc_smem(NP) * 4)};
  for (cudaError_t a : attrs)
    if (a != cudaSuccess) return a;
  const int nc = T / Q, bnc = B * nc;
  const GradWork w = carve_grad(ws, B, nc, H, P, N, NP);
  const Work fw{w.cbt, w.ct, w.g, w.decay, w.cum};
  const int tq = (Q + 63) / 64;
  cudaError_t err;
  ssd_cb_kernel<NP><<<dim3(16, bnc), kThreads, cb_smem(NP), stream>>>(
      Bm, Cm, fw, T, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_summary_kernel<NP, PS><<<dim3(P / PS, H, bnc), kThreads,
                                    summary_smem(NP, PS), stream>>>(
      dy, loga, Cm, fw, T, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_state_kernel<<<dim3((N * P + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, stream>>>(dstate, dh0, w, nc, H, N * P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_panel_kernel<<<dim3(tq * tq, bnc), kPanelThreads,
                          grad_panel_smem() * 4, stream>>>(u, dy, w, T, H, P,
                                                           Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_du_kernel<NP, PS><<<dim3(H, bnc), kThreads, grad_du_smem(PS) * 4,
                               stream>>>(u, loga, Bm, Cm, dy, hin, du, dloga,
                                         w, T, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_grad_bc_kernel<NP><<<dim3((Q + kBcRows - 1) / kBcRows, 2, bnc), 2 * NP,
                           grad_bc_smem(NP) * 4, stream>>>(
      u, Bm, Cm, dy, hin, dB, dC, w, T, H, P, N, Q);
  return cudaGetLastError();
}

// The P slice of the backward's b2 and b5, as the forward's (ssd_plan).
template <int NP>
cudaError_t launch_bwd_ps(const float* u, const float* loga, const float* Bm,
                          const float* Cm, const float* hin, const float* dy,
                          const float* dstate, float* du, float* dloga,
                          float* dB, float* dC, float* dh0, float* ws, int B,
                          int T, int H, int P, int N, int Q, cudaStream_t s) {
  if (P % 64 == 0)
    return launch_bwd<NP, 64>(u, loga, Bm, Cm, hin, dy, dstate, du, dloga, dB,
                              dC, dh0, ws, B, T, H, P, N, Q, s);
  if (P % 32 == 0)
    return launch_bwd<NP, 32>(u, loga, Bm, Cm, hin, dy, dstate, du, dloga, dB,
                              dC, dh0, ws, B, T, H, P, N, Q, s);
  return launch_bwd<NP, 16>(u, loga, Bm, Cm, hin, dy, dstate, du, dloga, dB,
                            dC, dh0, ws, B, T, H, P, N, Q, s);
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
    case 2: case 6: return summary_smem(np, ps);
    case 3: case 7: return 0;
    case 4: return output_smem(ps);
    case 8: return grad_panel_smem() * 4;
    case 9: return grad_du_smem(ps) * 4;
    case 10: return grad_bc_smem(np) * 4;
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
    err = launch_bwd_ps<32>(u, loga, Bm, Cm, chunk_states, dy, dstate, du,
                            dloga, dBm, dCm, dh0, ws, B, T, H, P, N, Q, s);
  else if (N <= 64)
    err = launch_bwd_ps<64>(u, loga, Bm, Cm, chunk_states, dy, dstate, du,
                            dloga, dBm, dCm, dh0, ws, B, T, H, P, N, Q, s);
  else
    err = launch_bwd_ps<128>(u, loga, Bm, Cm, chunk_states, dy, dstate, du,
                             dloga, dBm, dCm, dh0, ws, B, T, H, P, N, Q, s);
  return static_cast<int>(err);
}
