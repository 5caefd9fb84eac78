// The Mamba2 SSD chunked scan for Hopper (sm_90a), fp32 on the CUDA cores,
// with an initial state.
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
// multiple of 16.
//
// Per chunk of Q tokens, with cum the within-chunk prefix sum of loga:
//   y     = (C B^T * L) u + exp(cum) * (C h),  L[i, j] = exp(cum_i - cum_j)
//           for i >= j, else 0;
//   h'    = h * exp(cum[-1]) + B^T (u * exp(cum[-1] - cum)).
// Every exponent is <= 0, so every factor is <= 1.
//
// Bound: operations. At the mamba2-1.3b prefill shape (B 1, T 2048, H 64,
// P 64, N 128, Q 256) the chunked formulation does about 8.7 GFLOP (C B^T
// once per chunk, the (Q, Q) x (Q, P) product, C h and B^T u for every
// head) on about 72 MB of inputs and outputs, some 120 flops per byte:
// above the ~20 where the card's fp32 CUDA cores (67 TFLOP/s), not its
// memory, bind. The inputs are fp32 and the model's parity needs fp32
// products (TF32 keeps about three digits), so the kernel runs fp32 FMAs.
//
// Design (simple first). The TPU grid runs the chunk axis in order and
// carries the (N, P) state in VMEM; here one block per (P slice, head,
// batch) loops over its chunks itself and carries its (N, PS) slice of the
// state in shared memory: the recurrence is independent across the P
// columns, so slicing P gives 2 blocks per head at P 64 (128 blocks for
// mamba2's 64 heads at B 1, on 132 SMs) at the price of recomputing C B^T
// for every slice. A (Q, Q) fp32 tile at Q 256 is 256 KB, over the 227 KB a
// block may have, so the chunk is walked in 64-row tiles: for each query
// tile I, C_I h, then for each key tile J <= I the 64 x 64 tile
// S = (C_I B_J^T) * L and S u_J; the last query tile visits every key tile,
// so it also accumulates the chunk's B^T (u * decay to the end) for the
// state update. 256 threads as 16 x 16, each owning 4 rows and the columns
// tx, tx + 16, ... of a tile (the flash kernel's fp32 layout), over shared
// tiles whose rows are padded to N + 1 floats so that reads are broadcast
// or conflict-free. The within-chunk prefix sum of loga is a warp scan.
// Known limits: C B^T is recomputed per head and per P slice (it is shared
// by the heads), tiles load synchronously, and at B 1 one block runs per SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 16 x 16
constexpr int kTile = 64;        // query and key rows per tile
constexpr int kMaxChunk = 256;   // Q <= kThreads: one loga value a thread
constexpr int kSLd = kTile + 1;  // padded row of the 64 x 64 S tile
constexpr unsigned kFull = 0xffffffffu;

template <int NP, int PS>
constexpr int smem_floats() {
  return kMaxChunk + kTile + 32 + 2 * kTile * (NP + 1) + kTile * PS +
         kTile * kSLd + NP * PS;
}

// acc[i][j] += sum_k A[ty*4 + i][k] * B[tx + 16 j][k]
template <int NJ, int K>
__device__ __forceinline__ void mm_nt(float (&acc)[4][NJ], const float* A,
                                      int lda, const float* B, int ldb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a = A + ty * 4 * lda;
  const float* b = B + tx * ldb;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[16 * j * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k A[ty*4 + i][k] * B[k][tx + 16 j]
template <int NJ, int K>
__device__ __forceinline__ void mm_nn(float (&acc)[4][NJ], const float* A,
                                      int lda, const float* B, int ldb) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* a = A + ty * 4 * lda;
  const float* b = B + tx;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[i * lda + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[k * ldb + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Rows [row0, row0 + 64) of a chunk's (Q, N) slice of Bm or Cm into
// dst[r * (NP + 1) + n]; rows at or past Q and columns at or past N are
// zeros, so they add nothing to any product.
template <int NP>
__device__ __forceinline__ void load_bc(float* dst, const float* src, int row0,
                                        int Q, int N) {
  for (int i = threadIdx.x; i < kTile * NP; i += kThreads) {
    const int r = i / NP, n = i % NP;
    dst[r * (NP + 1) + n] =
        (row0 + r < Q && n < N) ? src[(long long)(row0 + r) * N + n] : 0.f;
  }
}

template <int NP, int PS>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ u, const float* __restrict__ loga,
                const float* __restrict__ Bm, const float* __restrict__ Cm,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ state_out, int T, int H, int P, int N,
                int Q) {
  constexpr int LDN = NP + 1, NJ = PS / 16, NR = NP / 16;
  extern __shared__ float smem[];
  float* cum_s = smem;                  // [kMaxChunk] within-chunk cumsum
  float* w_s = cum_s + kMaxChunk;       // [kTile] decay to the chunk's end
  float* warp_s = w_s + kTile;          // [32] warp totals of the scan
  float* cs = warp_s + 32;              // [kTile][LDN] C rows of a query tile
  float* bs = cs + kTile * LDN;         // [kTile][LDN] B rows of a key tile
  float* us = bs + kTile * LDN;         // [kTile][PS]  u rows of a key tile
  float* ss = us + kTile * PS;          // [kTile][kSLd] (C B^T) * L
  float* hs = ss + kTile * kSLd;        // [NP][PS]     the carried state

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long hp = (long long)H * P;
  const float* h0b = h0 ? h0 + ((long long)b * H + h) * N * P + p0 : nullptr;

  for (int i = threadIdx.x; i < NP * PS; i += kThreads) {
    const int n = i / PS, c = i % PS;
    hs[i] = (h0b && n < N) ? h0b[(long long)n * P + c] : 0.f;
  }

  const int n_chunks = T / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const long long t0 = (long long)b * T + (long long)ch * Q;  // row of (B*T)
    __syncthreads();                 // the previous chunk's readers are done
    // inclusive prefix sum of the chunk's loga (rows past Q add zeros)
    float x = threadIdx.x < Q ? loga[(t0 + threadIdx.x) * H + h] : 0.f;
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
    const float cum_last = cum_s[Q - 1];

    const float* cb = Cm + t0 * N;
    const float* bb = Bm + t0 * N;
    const float* ub = u + t0 * hp + (long long)h * P + p0;
    float* yb = y + t0 * hp + (long long)h * P + p0;
    float hacc[NR][NJ];              // this chunk's B^T (u * decay to end)
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) hacc[i][j] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int i0 = it * kTile;
      const bool last = it == n_tiles - 1;
      __syncthreads();
      load_bc<NP>(cs, cb, i0, Q, N);
      __syncthreads();
      // the carried state's share: exp(cum_i) * (C_i h)
      float acc[4][NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      mm_nn<NJ, NP>(acc, cs, LDN, hs, PS);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        const float e = r < Q ? expf(cum_s[r]) : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] *= e;
      }

      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * kTile;
        __syncthreads();
        load_bc<NP>(bs, bb, j0, Q, N);
        for (int i = threadIdx.x; i < kTile * PS; i += kThreads) {
          const int r = i / PS, c = i % PS;
          us[i] = j0 + r < Q ? ub[(long long)(j0 + r) * hp + c] : 0.f;
        }
        if (last && threadIdx.x < kTile) {
          const int r = j0 + threadIdx.x;
          w_s[threadIdx.x] = r < Q ? expf(cum_last - cum_s[r]) : 0.f;
        }
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        mm_nt<4, NP>(s, cs, LDN, bs, LDN);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i0 + ty * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = j0 + tx + 16 * j;
            ss[(ty * 4 + i) * kSLd + tx + 16 * j] =
                (c <= r && r < Q) ? s[i][j] * expf(cum_s[r] - cum_s[c]) : 0.f;
          }
        }
        if (last) {
          // h' += B_J^T (u_J * w): rows n = ty * NR + i, columns tx + 16 j
          for (int k = 0; k < kTile; ++k) {
            const float wk = w_s[k];
            float uv[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) uv[j] = us[k * PS + tx + 16 * j] * wk;
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              const float bv = bs[k * LDN + ty * NR + i];
#pragma unroll
              for (int j = 0; j < NJ; ++j) hacc[i][j] = fmaf(bv, uv[j], hacc[i][j]);
            }
          }
        }
        __syncthreads();
        mm_nn<NJ, kTile>(acc, ss, kSLd, us, PS);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty * 4 + i;
        if (r < Q) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) yb[(long long)r * hp + tx + 16 * j] = acc[i][j];
        }
      }
    }

    // every reader of the old state (C_i h above) is past a barrier since
    const float decay = expf(cum_last);
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* e = hs + (ty * NR + i) * PS + tx + 16 * j;
        *e = *e * decay + hacc[i][j];
      }
  }
  __syncthreads();
  float* so = state_out + ((long long)b * H + h) * N * P + p0;
  for (int i = threadIdx.x; i < NP * PS; i += kThreads) {
    const int n = i / PS, c = i % PS;
    if (n < N) so[(long long)n * P + c] = hs[i];
  }
}

// The attribute call runs once per instantiation (a function-local static),
// so that none falls inside a CUDA graph capture after the first launch.
template <int NP, int PS>
cudaError_t launch(const float* u, const float* loga, const float* Bm,
                   const float* Cm, const float* h0, float* y, float* state,
                   int B, int T, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<NP, PS>() * 4;
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<NP, PS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(P / PS, H, B);
  ssd_scan_kernel<NP, PS><<<grid, kThreads, bytes, stream>>>(
      u, loga, Bm, Cm, h0, y, state, T, H, P, N, Q);
  return cudaGetLastError();
}

template <int NP>
cudaError_t launch_ps(const float* u, const float* loga, const float* Bm,
                      const float* Cm, const float* h0, float* y, float* state,
                      int B, int T, int H, int P, int N, int Q,
                      cudaStream_t s) {
  if (P % 32 == 0)
    return launch<NP, 32>(u, loga, Bm, Cm, h0, y, state, B, T, H, P, N, Q, s);
  return launch<NP, 16>(u, loga, Bm, Cm, h0, y, state, B, T, H, P, N, Q, s);
}

}  // namespace

// All pointers to contiguous fp32; h0 may be null (a zero initial state).
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_ssd_scan(const float* u, const float* loga,
                              const float* Bm, const float* Cm,
                              const float* h0, float* y, float* state, int B,
                              int T, int H, int P, int N, int Q,
                              void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || P <= 0 || P % 16 ||
      N <= 0 || N > 128 || Q <= 0 || Q > kMaxChunk || T <= 0 || T % Q)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N <= 16)
    err = launch_ps<16>(u, loga, Bm, Cm, h0, y, state, B, T, H, P, N, Q, s);
  else if (N <= 32)
    err = launch_ps<32>(u, loga, Bm, Cm, h0, y, state, B, T, H, P, N, Q, s);
  else if (N <= 64)
    err = launch_ps<64>(u, loga, Bm, Cm, h0, y, state, B, T, H, P, N, Q, s);
  else
    err = launch_ps<128>(u, loga, Bm, Cm, h0, y, state, B, T, H, P, N, Q, s);
  return static_cast<int>(err);
}
