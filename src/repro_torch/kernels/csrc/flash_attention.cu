// Flash attention for Hopper (sm_90a): blocked attention with an online
// softmax, causal or full, grouped-query heads (kv head = h / g), forward
// and backward. Causal takes a query offset q_off: query row r is position
// q_off + r and sees keys c <= q_off + r (q_off 0: the mask aligned at
// position 0; q_off > 0: rows [q_off, q_off + T) of a longer causal
// attention over S >= q_off + T keys, as a rank that owns those rows of the
// sequence computes them).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (called through repro.kernels.ops.flash_attention from the branch without
// a cache of repro/models/attention.py, on every layer of the training loss).
// The Pallas kernel is forward only: the reference differentiates its XLA
// fallback. Here the backward is kernels too (recomputing P from Q, K and
// the saved log-sum-exp), so that the train step runs on them.
//
// Shapes: q (B, T, Hq, hd); k, v (B, S, Hkv, hd); out, dout, dq (B, T, Hq,
// hd); dk, dv (B, S, Hkv, hd); all read and written through their batch,
// sequence and head strides, last dimension contiguous, rows 16-byte
// aligned. lse and delta (B, Hq, T) fp32, contiguous. bf16 or fp32; hd 32,
// 64, 80, 96, 112 or 128 (multiples of 16, so the wgmma k-steps, the
// panels and the 16-column thread tiles cover hd exactly); any T, S >= 1
// (ragged tails are masked); causal with q_off >= 0 and q_off + T <= S, full
// with q_off 0.
//
// Bound: operations. At the training shape of smollm-135m (B 8, T 2048,
// 9/3 heads, hd 64) the causal forward does 4 * B * Hq * hd * T^2 / 2 =
// 39 GFLOP on 88 MB of inputs and outputs, some 440 flops per byte, above
// the ~295 where the H100's tensor cores, not its memory, bind. The
// backward does 2.5 times the work on about twice the bytes.
//
// Design: two routes with the same masks and outputs.
// - bf16 at every head dim runs on Hopper's warpgroup MMA: the forward on
//   128-row query tiles over two warpgroups, K/V tiles in a 3-stage
//   cp.async ring, P from registers and V read untransposed (see "bf16
//   forward on wgmma"); the backward's dK/dV and dQ kernels on the same
//   ring and operand reads (see "bf16 backward on wgmma"). Tiles lie in
//   swizzled panels of 64 columns (128-byte swizzle) and, where hd is not a
//   multiple of 64, of 32 and 16 columns (64- and 32-byte swizzles), so
//   that no product reads padding (see "bf16 on wgmma: layout").
// - fp32 runs on the CUDA cores (fp32 FMAs, so that fp32 results hold to
//   1e-4): 256 threads as 16 x 16, a thread owning 4 consecutive rows and
//   the columns tx, tx + 16, ... of a tile; every product is "NT" (both
//   operands row-major) or "NN" (the second indexed [k][col]) over shared
//   memory with rows padded to hd + 1 floats, so that reads are broadcast
//   or conflict-free.
// The forwards: one block per query tile, q head and b carries (m, l, acc)
// in registers over the 64-key tiles; the causal loop stops at the diagonal
// tile and masks inside it (the Pallas grid instead visits every key block
// and skips the compute). Writes O in the input type and the per-row
// log-sum-exp of the scaled scores in fp32 for the backward.
// Backward: a pre-pass computes delta = rowsum(dO * O); the dK/dV kernel
// takes one block per (key tile, kv head, b) and loops over the g query
// heads of the group and the query tiles from the diagonal on, so the sum
// over the group stays in the block; the dQ kernel takes one block per
// (q tile, q head, b). No atomics: every gradient is summed in one fixed
// order, so a train step is bit-identical from run to run.
// Known limits: the wgmma kernels copy with cp.async from their compute
// warps (no TMA producer warp, no register split between producer and
// consumers) and wait for each product before the elementwise work on its
// result, overlapping the two only across warpgroups.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // query rows and keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPLd = kTile + 1;  // padded row of a 64 x 64 score tile
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, s, h;   // batch, sequence, head strides in elements
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;
  float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, T, S, Hq, Hkv, g, causal, q_off;
  float scale;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}


__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [row0, row0 + 64) of the (b, h) slice of a (B, L, H, HD) fp32
// tensor into dst[r * (HD + 1) + d] times mult; rows at or past L are
// zeros. 16-byte loads, the consecutive threads of a warp on consecutive
// rows, so that the stores into the padded rows do not conflict.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          Strides st, int b, int h, int row0,
                                          int L, float mult) {
  const float* src = base + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * HD / 4; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L)
      f = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * st.s + c);
    float* d = dst + r * (HD + 1) + c;
    d[0] = f.x * mult; d[1] = f.y * mult; d[2] = f.z * mult; d[3] = f.w * mult;
  }
}

// Writes a thread's 4 x NJ output tile (rows row0 + ty*4 + i, columns
// tx + 16 j) times mult into the (b, h) slice of a (B, L, H, hd) tensor.
template <int NJ>
__device__ __forceinline__ void store_tile(float* base, Strides st, int b, int h,
                                           int row0, int L,
                                           const float (&acc)[4][NJ],
                                           float mult) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* dst = base + b * st.b + h * st.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r < L) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dst[(long long)r * st.s + tx + 16 * j] = acc[i][j] * mult;
    }
  }
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

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[4][NJ]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

__device__ __forceinline__ bool visible(const Params& p, int r, int c) {
  return r < p.T && c < p.S && (!p.causal || r + p.q_off >= c);
}

// Key tiles that rows [row0, row0 + rows) attend to: up to the tile of the
// last row's diagonal (its position q_off + row) when causal, n_all else.
__device__ __forceinline__ int causal_tiles(const Params& p, int row0,
                                            int rows, int tile, int n_all) {
  return p.causal
      ? min(n_all, (min(row0 + rows - 1, p.T - 1) + p.q_off) / tile + 1)
      : n_all;
}

__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  return causal_tiles(p, q0, kTile, kTile, (p.S + kTile - 1) / kTile);
}

// The first query tile of `rows` rows that sees key k0 when causal: the row
// at position k0 is row k0 - q_off (every row sees a key below q_off).
__device__ __forceinline__ int first_query_tile(const Params& p, int k0,
                                                int rows) {
  return p.causal ? max(k0 - p.q_off, 0) / rows : 0;
}

template <int HD>
constexpr int fwd_smem() { return (3 * kTile * (HD + 1) + kTile * kPLd) * 4; }
template <int HD>
constexpr int dkdv_smem() {
  return (4 * kTile * (HD + 1) + 2 * kTile * kPLd + 2 * kTile) * 4;
}
template <int HD>
constexpr int dq_smem() {
  return (4 * kTile * (HD + 1) + kTile * kPLd + 2 * kTile) * 4;
}

// ------------------------------------------------------------- forward --
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_fwd_kernel(const Params p) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<HD>(qs, static_cast<const float*>(p.q), p.sq, b, h, q0, p.T,
                   p.scale);
  float m[4], l[4], o[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = kNegInf; l[i] = 0.f; }
  zero(o);

  const int n_kt = key_tiles(p, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                 // the previous tile's readers are done
    load_tile<HD>(ks, static_cast<const float*>(p.k), p.sk, b, hk, k0, p.S, 1.f);
    load_tile<HD>(vs, static_cast<const float*>(p.v), p.sv, b, hk, k0, p.S, 1.f);
    __syncthreads();
    float s[4][4];
    zero(s);
    mm_nt<4, HD>(s, qs, LD, ks, LD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!visible(p, r, k0 + tx + 16 * j) && r < p.T) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // every row sees key 0 in tile 0, so m is finite from then on; rows
      // past T are computed on zeros and never written
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = visible(p, r, k0 + tx + 16 * j)
                             ? expf(s[i][j] - m_new) : 0.f;
        sum += pv;
        ps[(ty * 4 + i) * kPLd + tx + 16 * j] = pv;
      }
      l[i] = l[i] * corr + sum;      // this thread's columns only
#pragma unroll
      for (int j = 0; j < NJ; ++j) o[i][j] *= corr;
      m[i] = m_new;
    }
    __syncthreads();
    mm_nn<NJ, kTile>(o, ps, kPLd, vs, LD);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsum = fmaxf(half_warp_sum(l[i]), 1e-30f);
    const int r = q0 + ty * 4 + i;
    if (tx == 0 && r < p.T)
      p.lse[((long long)b * p.Hq + h) * p.T + r] = m[i] + logf(lsum);
    l[i] = 1.f / lsum;
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[i][j] *= l[i];
  }
  store_tile<NJ>(static_cast<float*>(p.out), p.so, b, h, q0, p.T, o, 1.f);
}

// ------------------------------------------------------------ backward --
// delta[b, h, r] = sum_d dout[b, r, h, d] * out[b, r, h, d]: 8 threads a
// row with 16-byte loads (rows are 16-byte aligned), 4 rows a warp; bytes-
// bound, so what counts is that every load is a whole 16 bytes.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);     // elements a 16-byte load
  const long long row =
      ((long long)blockIdx.x * kThreads + threadIdx.x) / 8;
  const int lane = threadIdx.x % 8;
  const bool live = row < (long long)p.B * p.Hq * p.T;
  const int r = live ? row % p.T : 0;
  const int h = live ? (row / p.T) % p.Hq : 0;
  const int b = live ? row / ((long long)p.T * p.Hq) : 0;
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + r * p.so.s + h * p.so.h;
  const T* d = static_cast<const T*>(p.dout) + b * p.sdo.b + r * p.sdo.s +
               h * p.sdo.h;
  float acc = 0.f;
#pragma unroll
  for (int e = lane * kVec; e < HD; e += 8 * kVec) {
    if (!live) break;
    const uint4 uo = *reinterpret_cast<const uint4*>(o + e);
    const uint4 ud = *reinterpret_cast<const uint4*>(d + e);
    const T* xo = reinterpret_cast<const T*>(&uo);
    const T* xd = reinterpret_cast<const T*>(&ud);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      acc = fmaf(to_float(xo[i]), to_float(xd[i]), acc);
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (live && lane == 0) p.delta[row] = acc;
}

// Loads the (b, h) query tile at q0 for the backward: q (pre-scaled), dout,
// and the rows' lse and delta (0 past T, where every P is masked anyway).
template <int HD>
__device__ __forceinline__ void load_query_side(const Params& p, float* qs,
                                                float* dos, float* lse_s,
                                                float* delta_s, int b, int h,
                                                int q0) {
  load_tile<HD>(qs, static_cast<const float*>(p.q), p.sq, b, h, q0, p.T,
                   p.scale);
  load_tile<HD>(dos, static_cast<const float*>(p.dout), p.sdo, b, h, q0, p.T,
                   1.f);
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    const long long at = ((long long)b * p.Hq + h) * p.T + r;
    lse_s[threadIdx.x] = r < p.T ? p.lse[at] : 0.f;
    delta_s[threadIdx.x] = r < p.T ? p.delta[at] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_dkdv_kernel(const Params p) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* pt = dos + kTile * LD;      // P^T  [key][query]
  float* dst = pt + kTile * kPLd;    // dS^T [key][query]
  float* lse_s = dst + kTile * kPLd;
  float* delta_s = lse_s + kTile;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_tile<HD>(ks, static_cast<const float*>(p.k), p.sk, b, hk, k0, p.S, 1.f);
  load_tile<HD>(vs, static_cast<const float*>(p.v), p.sv, b, hk, k0, p.S, 1.f);
  float dk[4][NJ], dv[4][NJ];
  zero(dk);
  zero(dv);

  const int n_qt = (p.T + kTile - 1) / kTile;
  const int qt0 = first_query_tile(p, k0, kTile);
  for (int hh = 0; hh < p.g; ++hh) {
    const int h = hk * p.g + hh;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_query_side<HD>(p, qs, dos, lse_s, delta_s, b, h, q0);
      __syncthreads();
      float st[4][4], dpt[4][4];
      zero(st);
      zero(dpt);
      mm_nt<4, HD>(st, ks, LD, qs, LD);     // S^T  [key][query]
      mm_nt<4, HD>(dpt, vs, LD, dos, LD);   // dP^T [key][query]
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = tx + 16 * j;
          const float pv = visible(p, q0 + rr, c)
                               ? expf(st[i][j] - lse_s[rr]) : 0.f;
          pt[(ty * 4 + i) * kPLd + rr] = pv;
          dst[(ty * 4 + i) * kPLd + rr] = pv * (dpt[i][j] - delta_s[rr]);
        }
      }
      __syncthreads();
      mm_nn<NJ, kTile>(dv, pt, kPLd, dos, LD);   // dV += P^T dO
      mm_nn<NJ, kTile>(dk, dst, kPLd, qs, LD);   // dK += dS^T (q * scale)
    }
  }
  store_tile<NJ>(static_cast<float*>(p.dk), p.sdk, b, hk, k0, p.S, dk, 1.f);
  store_tile<NJ>(static_cast<float*>(p.dv), p.sdv, b, hk, k0, p.S, dv, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_dq_kernel(const Params p) {
  constexpr int LD = HD + 1, NJ = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* dss = vs + kTile * LD;      // dS [query][key]
  float* lse_s = dss + kTile * kPLd;
  float* delta_s = lse_s + kTile;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_query_side<HD>(p, qs, dos, lse_s, delta_s, b, h, q0);
  float dq[4][NJ];
  zero(dq);
  const int n_kt = key_tiles(p, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<HD>(ks, static_cast<const float*>(p.k), p.sk, b, hk, k0, p.S, 1.f);
    load_tile<HD>(vs, static_cast<const float*>(p.v), p.sv, b, hk, k0, p.S, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    mm_nt<4, HD>(s, qs, LD, ks, LD);
    mm_nt<4, HD>(dp, dos, LD, vs, LD);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float pv = visible(p, q0 + rr, c) ? expf(s[i][j] - lse_s[rr])
                                                : 0.f;
        dss[rr * kPLd + tx + 16 * j] = pv * (dp[i][j] - delta_s[rr]);
      }
    }
    __syncthreads();
    mm_nn<NJ, kTile>(dq, dss, kPLd, ks, LD);     // dQ += dS K
  }
  store_tile<NJ>(static_cast<float*>(p.dq), p.sdq, b, h, q0, p.T, dq, p.scale);
}

// ------------------------------------------------ bf16 on wgmma: layout --
// The bf16 kernels keep every tile in shared memory as wgmma reads it. A
// tile of R rows of hd bf16 columns is a run of panels: hd / 64 panels of
// 64 columns in the 128-byte swizzle, then the rest of hd (16, 32 or 48
// columns) as a panel of 32 columns in the 64-byte swizzle and/or one of 16
// in the 32-byte swizzle (hd 80: 64 + 16; 96: 64 + 32; 112: 64 + 32 + 16;
// 32: one panel of 32). A panel of w columns holds its R rows of 2w bytes
// one after another, 16-byte chunk c of row r at chunk c ^ ((2w r / 128) %
// (w / 8)): the layouts that TMA's SWIZZLE_128B, _64B and _32B write and a
// wgmma descriptor of the same mode reads. So no product reads padding:
// - over K = hd (S = Q K^T, dP = dO V^T and their transposes), both
//   operands K-major, one m64n64k16 a 16-column k-step, the k-step's
//   descriptor in its own panel (32 bytes further along a row per step);
// - with N = hd (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K), B read
//   MN-major (the transpose bit), one wgmma a panel with N its width (64,
//   32 or 16) into that panel's columns of the accumulator.
typedef __nv_bfloat16 bf16;

template <int HD> struct Panels {
  static constexpr int kFull = HD / 64;
  static constexpr bool kHas32 = HD % 64 >= 32;
  static constexpr bool kHas16 = HD % 32 == 16;
  static constexpr int kCount = kFull + kHas32 + kHas16;
  // first column and width (columns) of panel pn; the panel of column col
  __host__ __device__ static constexpr int col0(int pn) {
    return pn <= kFull ? 64 * pn : 64 * kFull + 32;
  }
  __host__ __device__ static constexpr int width(int pn) {
    return pn < kFull ? 64 : (pn == kFull && kHas32) ? 32 : 16;
  }
  __host__ __device__ static constexpr int of(int col) {
    return col < 64 * kFull ? col / 64
         : (kHas32 && col < 64 * kFull + 32) ? kFull : kCount - 1;
  }
};

// Byte offset of 16-byte chunk c (columns 8c..8c+7) of row r in an R-row
// tile. Every panel starts R * 2 * col0 bytes in: with R a multiple of 64,
// a multiple of the 1024, 512 or 256 bytes at which its swizzle repeats.
// Each branch has its panel width as a constant (c is known only at run
// time in the copy loops), so that a chunk of a 64-column panel costs what
// it did when every panel was one.
template <int HD, int R>
__device__ __forceinline__ uint32_t chunk_off(int r, int c) {
  using L = Panels<HD>;
  constexpr int c32 = 8 * L::kFull, c16 = c32 + 4 * L::kHas32;
  if (L::kFull == L::kCount || c < c32)           // 128-byte rows
    return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
  if (L::kHas32 && c < c16)                        // 64-byte rows
    return c32 * 16 * R + r * 64 + (((c - c32) ^ ((r >> 1) & 3)) << 4);
  return c16 * 16 * R + r * 32 + (((c - c16) ^ ((r >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------- bf16 forward on wgmma --
// The bf16 forward at every head dim, on Hopper's warpgroup MMA. One block
// per (128-row query tile, q head, b), the tiles issued in reverse (the
// heavy causal tiles first, the diagonal's short ones at the tail): two
// warpgroups of 64 rows each. All 256 threads copy Q once and K and V tiles
// of 64 keys with 16-byte cp.async into a ring of 3 stages, so that two
// tiles load while one is computed; no producer warp yet (a TMA producer
// warp is the next step). Each tile lands in the panels above:
// - S = Q K^T: wgmma m64n64k16, A = Q and B = K from shared memory, both
//   K-major, hd / 16 products a tile;
// - the online softmax in fp32 registers on exp2 of scale * log2(e) * S
//   (one FMA and one ex2 an element), with the mask of the other kernels
//   (`visible`) only on tiles that cross the diagonal or the end of S;
// - O += P V: wgmma with A = P from registers (the S accumulator rounded to
//   bf16 is the A fragment, as in FlashAttention-3) and B = V from shared
//   memory in its natural (key, d) layout, read MN-major, one product per
//   16 keys and panel: no transposed copy of V.
// O is one accumulator of hd / 2 floats a thread, laid out as a single
// m64n<hd> product's: a panel's wgmma writes its run of it. A warpgroup
// skips the tiles past its own diagonal. O is written in bf16 through its
// strides, lse as the natural log-sum-exp of the scaled scores. Up to hd 80
// two blocks share an SM (registers capped at 128 a thread), so that four
// warpgroups interleave their products and softmaxes; wider head dims run
// one block an SM.
constexpr int kWgThreads = 256;        // two warpgroups
constexpr int kWgRows = 64;            // query rows a warpgroup
constexpr int kQRows = 2 * kWgRows;    // query rows a block
constexpr int kKeys = 64;              // keys a stage: N of S = Q K^T
constexpr int kWgStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMinusInf = -__builtin_huge_valf();

template <int HD> struct WgLayout {
  static constexpr int kQBytes = kQRows * 2 * HD;     // Q, 128 rows
  static constexpr int kTileBytes = kKeys * 2 * HD;   // a K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  // + 1024: the dynamic shared memory is aligned up to 1024 bytes
  static constexpr int kSmem = kQBytes + kWgStages * kStageBytes + 1024;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + R) of the (b, h) slice of a (B, L, H, HD) bf16 tensor
// into the panels of an R-row tile at shared address dst; rows at or past L
// are zero-filled.
template <int HD, int R>
__device__ __forceinline__ void load_panels(uint32_t dst, const bf16* base,
                                            Strides st, int b, int h,
                                            int row0, int L) {
  constexpr int kC = HD / 8;                  // 16-byte chunks a row
  const bf16* src = base + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < R * kC; i += kWgThreads) {
    const int r = i / kC, c = i % kC;
    const bool in = row0 + r < L;
    const bf16* gp = in ? src + (long long)(row0 + r) * st.s + c * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst + chunk_off<HD, R>(r, c)), "l"(gp),
                    "r"(in ? 16 : 0) : "memory");
  }
}

// wgmma descriptor of an operand at shared address addr in a panel of w
// bytes a row (128, 64 or 32, the swizzle mode): 8-row groups 8 w bytes
// apart. The leading offset is unused (a K-major operand's k-step stays in
// its row; an MN-major one is read a panel, one swizzle atom, at a time);
// it is set to the same 8 w bytes. A shared address is below 2^18, so the
// start field is addr >> 4 with no carry into the fields above it, and a
// descriptor at a constant offset from a base is the base's plus a
// constant: one add a k-step.
__device__ __forceinline__ uint64_t panel_desc(uint32_t addr, int w) {
  const uint64_t mode = w == 128 ? 1 : w == 64 ? 2 : 3;
  return (uint64_t)(addr >> 4) + (((uint64_t)(8 * w >> 4) << 16) |
                                  ((uint64_t)(8 * w >> 4) << 32) |
                                  (mode << 62));
}

// 2^x in one MUFU instruction (ex2(-inf) = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 fp32) = A B (+ d when accumulate): A 64 x 16 and B 16 x 64
// from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N fp32) += A B: A 64 x 16 bf16 from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B 16 x N from shared memory, MN-major;
// N = 64, 32 or 16 (d: N / 2 floats from d0).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 16, "wgmma_rs: N is 64, 32 or 16");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
        "1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// d (64 x 64) = A B^T over K = HD, both operands K-major in the panels of
// their tiles: A rows a_row0.. of an RA-row tile at a_base, B the first 64
// rows of an RB-row tile at b_base; one wgmma a 16-column k-step.
template <int HD, int RA, int RB>
__device__ __forceinline__ void mma_over_hd(float (&d)[32], uint32_t a_base,
                                            int a_row0, uint32_t b_base) {
  using L = Panels<HD>;
  // A's first row in a panel of each width (128, 64, 32 bytes a row)
  const uint64_t da[3] = {(a_base + a_row0 * 128) >> 4,
                          (a_base + a_row0 * 64) >> 4,
                          (a_base + a_row0 * 32) >> 4};
  const uint64_t db = b_base >> 4;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int pn = L::of(16 * kk), w = 2 * L::width(pn);
    const int at = 2 * (16 * kk - L::col0(pn));     // bytes into the row
    wgmma_ss(d, da[w == 128 ? 0 : w == 64 ? 1 : 2] +
                    panel_desc(RA * 2 * L::col0(pn) + at, w),
             db + panel_desc(RB * 2 * L::col0(pn) + at, w),
             kk > 0);                 // the first k-step overwrites d
  }
}

// acc (64 x HD) += A B over 16 rows kk of an R-row tile at base, B read
// MN-major: one wgmma a panel, N its width, into its columns of acc.
template <int HD, int R, int PN = 0>
__device__ __forceinline__ void mma_into_hd(float (&acc)[HD / 2],
                                            const uint32_t (&a)[4],
                                            uint32_t base, int kk) {
  if constexpr (PN < Panels<HD>::kCount) {
    constexpr int w = Panels<HD>::width(PN), c0 = Panels<HD>::col0(PN);
    wgmma_rs<w>(acc + c0 / 2, a,
                (base >> 4) + panel_desc(R * 2 * c0 + kk * 16 * 2 * w, 2 * w));
    mma_into_hd<HD, R, PN + 1>(acc, a, base, kk);
  }
}

// The A fragments (m16n8k16 layout of each warp's 16 rows) of the four
// 16-column k-steps of a 64 x 64 accumulator, rounded to bf16:
// s[4 j + 2 hf + e] is row 8 hf + g, column 8 j + 2 t + e of the warp's rows.
__device__ __forceinline__ void acc_to_frags(uint32_t (&a)[4][4],
                                             const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// The head of each step of a cp.async ring: this thread's copies of the
// oldest stage in flight are done; make them visible to wgmma (the async
// proxy), then to every thread, which also frees the stage read last step.
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<kWgStages - 2>();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Writes a warpgroup's 64 x HD accumulator (rows r0 and r0 + 8 of this
// thread, acc[4 j + 2 hf + e] the row at r0 + 8 hf, column 8 j + 2 t + e,
// times mult[hf]) as bf16 pairs into rows of stride ld at dst; rows at or
// past L are not written.
template <int HD>
__device__ __forceinline__ void store_wg_acc(bf16* dst, long long ld, int r0,
                                             int L, const float (&acc)[HD / 2],
                                             const float (&mult)[2]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    if (r < L) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + (long long)r * ld + 8 * j + 2 * t) =
            pack_bf16(acc[4 * j + 2 * hf] * mult[hf],
                      acc[4 * j + 2 * hf + 1] * mult[hf]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, HD <= 80 ? 2 : 1)
flash_fwd_wgmma_kernel(const Params p) {
  using L = WgLayout<HD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t q_sm = (raw + 1023) & ~1023u;
  const uint32_t kv_sm = q_sm + L::kQBytes;

  const int n_qt = (p.T + kQRows - 1) / kQRows, hb = p.Hq * p.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x % hb) / p.Hq;
  const int q0 = qt * kQRows, hk = h / p.g;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row_wg = q0 + kWgRows * wg;   // the warpgroup's first row
  const int r0 = row_wg + 16 * w + g;     // this thread's rows: r0, r0 + 8

  // key tiles of the block and of this warpgroup (up to the diagonal)
  const int n_all = (p.S + kKeys - 1) / kKeys;
  const int n_kt = causal_tiles(p, q0, kQRows, kKeys, n_all);
  const int n_wg =
      row_wg >= p.T ? 0 : causal_tiles(p, row_wg, kWgRows, kKeys, n_all);

  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);
  load_panels<HD, kQRows>(q_sm, static_cast<const bf16*>(p.q), p.sq, b, h,
                          q0, p.T);
#pragma unroll
  for (int i = 0; i < kWgStages - 1; ++i) {
    if (i < n_kt) {
      const uint32_t st = kv_sm + i * L::kStageBytes;
      load_panels<HD, kKeys>(st, kg, p.sk, b, hk, i * kKeys, p.S);
      load_panels<HD, kKeys>(st + L::kTileBytes, vg, p.sv, b, hk, i * kKeys,
                             p.S);
    }
    cp_async_commit();
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, s[32], o[HD / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  const float sl2 = p.scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    ring_wait();
    const int nx = kt + kWgStages - 1;     // into the stage read at kt - 1
    if (nx < n_kt) {
      const uint32_t st = kv_sm + (nx % kWgStages) * L::kStageBytes;
      load_panels<HD, kKeys>(st, kg, p.sk, b, hk, nx * kKeys, p.S);
      load_panels<HD, kKeys>(st + L::kTileBytes, vg, p.sv, b, hk,
                             nx * kKeys, p.S);
    }
    cp_async_commit();
    if (kt >= n_wg) continue;              // uniform over the warpgroup

    const uint32_t ks = kv_sm + (kt % kWgStages) * L::kStageBytes;
    const uint32_t vs = ks + L::kTileBytes;
    const int k0 = kt * kKeys;
    wgmma_fence();
    mma_over_hd<HD, kQRows, kKeys>(s, q_sm, kWgRows * wg, ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);

    // s[4 j + 2 hf + e]: row r0 + 8 hf, key k0 + 8 j + 2 t + e. Only the
    // tiles that cross the diagonal or the end of S are masked (to -inf, so
    // that exp2 gives 0); m is kept in log2 units of the scaled scores, and
    // p = 2^(s * scale * log2(e) - m) is one FMA and one ex2 an element.
    if (!(k0 + kKeys <= p.S &&
          (!p.causal || k0 + kKeys - 1 <= row_wg + p.q_off))) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, r0 + 8 * ((i >> 1) & 1), k0 + 8 * (i >> 2) + 2 * t +
                                                     (i & 1)))
          s[i] = kMinusInf;
    }
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kMinusInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      // every row sees key 0 in tile 0, so m is finite from then on; a row
      // with no visible key yet keeps m = -1e30 and p = 0
      const float m_new = fmaxf(m[hf], mx * sl2);
      corr[hf] = ex2(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hf + e];
          x = ex2(fmaf(x, sl2, -m_new));
          sum += x;
        }
      l[hf] = l[hf] * corr[hf] + sum;      // this thread's columns only
      m[hf] = m_new;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    uint32_t a[4][4];                      // P as the A fragments of 16 keys
    acc_to_frags(a, s);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_into_hd<HD, kKeys>(o, a[kk], vs, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lsum = l[hf];
    lsum += __shfl_xor_sync(kFull, lsum, 1);
    lsum += __shfl_xor_sync(kFull, lsum, 2);
    lsum = fmaxf(lsum, 1e-30f);
    const int r = r0 + 8 * hf;
    if (t == 0 && r < p.T)
      p.lse[((long long)b * p.Hq + h) * p.T + r] =
          (m[hf] + log2f(lsum)) * kLn2;
    inv[hf] = 1.f / lsum;
  }
  store_wg_acc<HD>(static_cast<bf16*>(p.out) + b * p.so.b + h * p.so.h,
                   p.so.s, r0, p.T, o, inv);
}

// ------------------------------------------ bf16 backward on wgmma --
// The bf16 backward at every head dim, on the forward's machinery: tiles in
// the panels above, loaded with cp.async into a ring of kWgStages stages,
// wgmma with both operands from shared memory K-major over hd, and with A
// from registers (an accumulator rounded to bf16, acc_to_frags) and B read
// MN-major a panel at a time, so that no operand is ever copied transposed.
//
// dK/dV: one block per (128 keys, KV head, b), two warpgroups of 64 keys
// each (dK and dV of a warpgroup are 2 x 64 x hd fp32 accumulators: hd
// registers a thread). 128 keys rather than 64: the two warpgroups share
// each Q and dO tile the ring brings, which halves those loads, and still
// give 384 blocks at smollm-135m's training shape. The key blocks with the
// most query tiles under the causal mask are issued first. K and V stay in
// shared memory; the block walks the g query heads of its group and, for
// each, the 64-row query tiles from the diagonal on, streaming Q, dO and
// their rows of lse and delta through the ring. Per query tile and
// warpgroup:
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, A = K or V and B = Q or
//   dO, all K-major (rows along hd);
// - P^T = 2^(scale log2(e) S^T - log2(e) lse) with the mask only on tiles
//   that cross the diagonal or the end of T or S, dS^T = P^T (dP^T - delta),
//   fp32 in registers;
// - dV += P^T dO and dK += dS^T Q: A = P^T or dS^T from registers, B = dO or
//   Q read MN-major (the transpose bit, as the forward reads V), one product
//   per 16 queries and panel.
// dQ: one block per (128 query rows, q head, b), two warpgroups of 64 rows,
// heavy tiles first as in the forward. Q and dO stay in shared memory, K
// and V tiles of 64 keys stream through the ring: S = Q K^T and dP = dO V^T
// K-major, dS = P (dP - delta) in registers as the A operand of dQ += dS K,
// with K read MN-major. Up to hd 80 two blocks share an SM (registers
// capped at 128, a spill of 8 to 20 bytes), as in the forward: 10% off the
// whole backward against one block an SM at hd 64, 4% at hd 80, on an
// H100.
// Deterministic by design: FlashAttention-2 and -3 add dQ with atomics from
// the dK/dV loop; here a separate dQ kernel recomputes S and dP, so every
// gradient is summed in one fixed order and a train step is bit-identical
// from run to run. That is 7 products of 64 x 64 x hd a tile pair where the
// bound (2.5 x the forward) counts 5: at most 5/7 of the bound's rate.
constexpr int kBwdKeys = 2 * kWgRows;   // keys a dK/dV block
constexpr int kBwdRows = 64;            // query rows a stage of its ring

template <int HD> struct BwdLayout {
  static constexpr int kKBytes = kBwdKeys * 2 * HD;   // K or V, 128 keys
  static constexpr int kRowBytes = kBwdRows * 2 * HD; // Q or dO, 64 rows
  // Q, dO, then lse and delta (2 x 64 floats), padded so that every stage's
  // panels stay 1024-byte aligned
  static constexpr int kStageBytes = 2 * kRowBytes + 1024;
  static constexpr int kSmem = 2 * kKBytes + kWgStages * kStageBytes + 1024;
  // dQ: Q and dO of 128 rows resident, the forward's K/V stages
  static constexpr int kDqSmem = 2 * WgLayout<HD>::kQBytes +
                                 kWgStages * WgLayout<HD>::kStageBytes + 1024;
};

// Rows [row0, row0 + 64) of the (b, h) rows of lse and of delta into shared
// memory at dst (lse) and dst + 256 (delta), with 4-byte copies (a row of T
// floats need not be 16-byte aligned); rows at or past T are zero-filled.
__device__ __forceinline__ void load_row_stats(uint32_t dst, const Params& p,
                                               int b, int h, int row0) {
  const int i = threadIdx.x;
  if (i < 2 * kBwdRows) {
    const int r = row0 + i % kBwdRows;
    const float* src = (i < kBwdRows ? p.lse : p.delta) +
                       ((long long)b * p.Hq + h) * p.T;
    const bool in = r < p.T;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst + 4 * i), "l"(in ? src + r : src),
                    "r"(in ? 4 : 0) : "memory");
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_dkdv_wgmma_kernel(const Params p) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t k_sm = (raw + 1023) & ~1023u;
  const uint32_t v_sm = k_sm + L::kKBytes;
  const uint32_t ring = v_sm + L::kKBytes;

  const int hb = p.Hkv * p.B;
  const int k0 = static_cast<int>(blockIdx.x) / hb * kBwdKeys;
  const int hk = blockIdx.x % p.Hkv, b = (blockIdx.x % hb) / p.Hkv;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int key_wg = k0 + kWgRows * wg;   // the warpgroup's first key
  const int c0 = key_wg + 16 * w + g;     // this thread's keys: c0, c0 + 8

  // the (head, query tile) steps: for each head of the group, the query
  // tiles from the first that sees key k0 (causal) to the end of T
  const int n_qt = (p.T + kBwdRows - 1) / kBwdRows;
  const int qt0 = min(first_query_tile(p, k0, kBwdRows), n_qt);
  const int n_q = n_qt - qt0, n_it = p.g * n_q;
  const bf16* qg = static_cast<const bf16*>(p.q);
  const bf16* dog = static_cast<const bf16*>(p.dout);
  auto load_stage = [&](int it) {
    const uint32_t st = ring + (it % kWgStages) * L::kStageBytes;
    const int h = hk * p.g + it / n_q, q0 = (qt0 + it % n_q) * kBwdRows;
    load_panels<HD, kBwdRows>(st, qg, p.sq, b, h, q0, p.T);
    load_panels<HD, kBwdRows>(st + L::kRowBytes, dog, p.sdo, b, h, q0, p.T);
    load_row_stats(st + 2 * L::kRowBytes, p, b, h, q0);
  };

  load_panels<HD, kBwdKeys>(k_sm, static_cast<const bf16*>(p.k), p.sk, b, hk,
                            k0, p.S);
  load_panels<HD, kBwdKeys>(v_sm, static_cast<const bf16*>(p.v), p.sv, b, hk,
                            k0, p.S);
#pragma unroll
  for (int i = 0; i < kWgStages - 1; ++i) {   // K and V go with stage 0
    if (i < n_it) load_stage(i);
    cp_async_commit();
  }

  float dk[HD / 2], dv[HD / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = p.scale * kLog2e;

  for (int it = 0; it < n_it; ++it) {
    ring_wait();
    if (it + kWgStages - 1 < n_it) load_stage(it + kWgStages - 1);
    cp_async_commit();
    const int q0 = (qt0 + it % n_q) * kBwdRows;
    // uniform over the warpgroup: keys past S, or every query before them
    if (key_wg >= p.S || (p.causal && q0 + kBwdRows + p.q_off <= key_wg))
      continue;

    const uint32_t st = ring + (it % kWgStages) * L::kStageBytes;
    const float* lse_s = reinterpret_cast<const float*>(
        wg_smem + (st + 2 * L::kRowBytes - raw));
    const float* delta_s = lse_s + kBwdRows;
    wgmma_fence();
    mma_over_hd<HD, kBwdKeys, kBwdRows>(s, k_sm, kWgRows * wg, st);
    mma_over_hd<HD, kBwdKeys, kBwdRows>(dp, v_sm, kWgRows * wg,
                                        st + L::kRowBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    // s[4 j + 2 hf + e]: key c0 + 8 hf, query q0 + 8 j + 2 t + e
    if (!(q0 + kBwdRows <= p.T && key_wg + kWgRows <= p.S &&
          (!p.causal || q0 + p.q_off >= key_wg + kWgRows - 1))) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, q0 + 8 * (i >> 2) + 2 * t + (i & 1),
                     c0 + 8 * ((i >> 1) & 1)))
          s[i] = kMinusInf;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 ls = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
      const float2 dl =
          *reinterpret_cast<const float2*>(delta_s + 8 * j + 2 * t);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf;
        const float p0 = ex2(fmaf(s[i], sl2, -ls.x * kLog2e));
        const float p1 = ex2(fmaf(s[i + 1], sl2, -ls.y * kLog2e));
        s[i] = p0;
        s[i + 1] = p1;
        dp[i] = p0 * (dp[i] - dl.x);
        dp[i + 1] = p1 * (dp[i + 1] - dl.y);
      }
    }
    uint32_t ap[4][4], ads[4][4];        // P^T and dS^T, 16 queries a step
    acc_to_frags(ap, s);
    acc_to_frags(ads, dp);
    fence_acc(dv);
    fence_acc(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_into_hd<HD, kBwdRows>(dv, ap[kk], st + L::kRowBytes, kk);
      mma_into_hd<HD, kBwdRows>(dk, ads[kk], st, kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dv);
    fence_acc(dk);
  }
  cp_async_wait<0>();

  const float one[2] = {1.f, 1.f}, scale[2] = {p.scale, p.scale};
  store_wg_acc<HD>(static_cast<bf16*>(p.dk) + b * p.sdk.b + hk * p.sdk.h,
                   p.sdk.s, c0, p.S, dk, scale);
  store_wg_acc<HD>(static_cast<bf16*>(p.dv) + b * p.sdv.b + hk * p.sdv.h,
                   p.sdv.s, c0, p.S, dv, one);
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, HD <= 80 ? 2 : 1)
flash_dq_wgmma_kernel(const Params p) {
  using L = WgLayout<HD>;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t q_sm = (raw + 1023) & ~1023u;
  const uint32_t do_sm = q_sm + L::kQBytes;
  const uint32_t kv_sm = do_sm + L::kQBytes;

  const int n_qt = (p.T + kQRows - 1) / kQRows, hb = p.Hq * p.B;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = blockIdx.x % p.Hq, b = (blockIdx.x % hb) / p.Hq;
  const int q0 = qt * kQRows, hk = h / p.g;
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row_wg = q0 + kWgRows * wg;
  const int r0 = row_wg + 16 * w + g;     // this thread's rows: r0, r0 + 8

  const int n_all = (p.S + kKeys - 1) / kKeys;
  const int n_kt = causal_tiles(p, q0, kQRows, kKeys, n_all);
  const int n_wg =
      row_wg >= p.T ? 0 : causal_tiles(p, row_wg, kWgRows, kKeys, n_all);

  const bf16* kg = static_cast<const bf16*>(p.k);
  const bf16* vg = static_cast<const bf16*>(p.v);
  load_panels<HD, kQRows>(q_sm, static_cast<const bf16*>(p.q), p.sq, b, h,
                          q0, p.T);
  load_panels<HD, kQRows>(do_sm, static_cast<const bf16*>(p.dout), p.sdo, b,
                          h, q0, p.T);
#pragma unroll
  for (int i = 0; i < kWgStages - 1; ++i) {
    if (i < n_kt) {
      const uint32_t st = kv_sm + i * L::kStageBytes;
      load_panels<HD, kKeys>(st, kg, p.sk, b, hk, i * kKeys, p.S);
      load_panels<HD, kKeys>(st + L::kTileBytes, vg, p.sv, b, hk, i * kKeys,
                             p.S);
    }
    cp_async_commit();
  }

  // this thread's rows' lse (in log2 units) and delta; 0 past T
  float lse2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + 8 * hf;
    const long long at = ((long long)b * p.Hq + h) * p.T + r;
    lse2[hf] = r < p.T ? p.lse[at] * kLog2e : 0.f;
    dl[hf] = r < p.T ? p.delta[at] : 0.f;
  }
  float dq[HD / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  const float sl2 = p.scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    ring_wait();
    const int nx = kt + kWgStages - 1;
    if (nx < n_kt) {
      const uint32_t st = kv_sm + (nx % kWgStages) * L::kStageBytes;
      load_panels<HD, kKeys>(st, kg, p.sk, b, hk, nx * kKeys, p.S);
      load_panels<HD, kKeys>(st + L::kTileBytes, vg, p.sv, b, hk,
                             nx * kKeys, p.S);
    }
    cp_async_commit();
    if (kt >= n_wg) continue;              // uniform over the warpgroup

    const uint32_t ks = kv_sm + (kt % kWgStages) * L::kStageBytes;
    const int k0 = kt * kKeys;
    wgmma_fence();
    mma_over_hd<HD, kQRows, kKeys>(s, q_sm, kWgRows * wg, ks);
    mma_over_hd<HD, kQRows, kKeys>(dp, do_sm, kWgRows * wg,
                                   ks + L::kTileBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);

    // s[4 j + 2 hf + e]: row r0 + 8 hf, key k0 + 8 j + 2 t + e
    if (!(k0 + kKeys <= p.S &&
          (!p.causal || k0 + kKeys - 1 <= row_wg + p.q_off))) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (!visible(p, r0 + 8 * ((i >> 1) & 1), k0 + 8 * (i >> 2) + 2 * t +
                                                     (i & 1)))
          s[i] = kMinusInf;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], sl2, -lse2[hf])) * (dp[i] - dl[hf]);   // dS
    }
    uint32_t a[4][4];
    acc_to_frags(a, s);
    fence_acc(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_into_hd<HD, kKeys>(dq, a[kk], ks, kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(dq);
  }
  cp_async_wait<0>();

  const float scale[2] = {p.scale, p.scale};
  store_wg_acc<HD>(static_cast<bf16*>(p.dq) + b * p.sdq.b + h * p.sdq.h,
                   p.sdq.s, r0, p.T, dq, scale);
}

// --------------------------------------------------------------- launch --
// The attribute calls run once per instantiation (function-local statics),
// so that none falls inside a CUDA graph capture after the first launch.
template <int HD>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      fwd_smem<HD>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + kTile - 1) / kTile, p.Hq, p.B);
  flash_fwd_kernel<HD><<<grid, kThreads, fwd_smem<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_dkdv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dkdv_smem<HD>());
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_smem<HD>());
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  cudaError_t err;
  const long long rows = (long long)p.B * p.Hq * p.T;
  const int per = kThreads / 8;           // rows a block of the pre-pass
  flash_delta_kernel<float, HD><<<(unsigned)((rows + per - 1) / per),
                                  kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kTile - 1) / kTile, p.Hkv, p.B);
  flash_dkdv_kernel<HD><<<grid_kv, kThreads, dkdv_smem<HD>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((p.T + kTile - 1) / kTile, p.Hq, p.B);
  flash_dq_kernel<HD><<<grid_q, kThreads, dq_smem<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_wgmma(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WgLayout<HD>::kSmem);
  if (attr != cudaSuccess) return attr;
  const long long blocks =
      (long long)((p.T + kQRows - 1) / kQRows) * p.Hq * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<HD><<<(unsigned)blocks, kWgThreads,
                               WgLayout<HD>::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_wgmma(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_dkdv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdLayout<HD>::kSmem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_dq_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BwdLayout<HD>::kDqSmem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const long long blocks_kv =
      (long long)((p.S + kBwdKeys - 1) / kBwdKeys) * p.Hkv * p.B;
  const long long blocks_q =
      (long long)((p.T + kQRows - 1) / kQRows) * p.Hq * p.B;
  if (blocks_kv > 0x7fffffffLL || blocks_q > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err;
  const long long rows = (long long)p.B * p.Hq * p.T;
  const int per = kThreads / 8;           // rows a block of the pre-pass
  flash_delta_kernel<bf16, HD><<<(unsigned)((rows + per - 1) / per),
                                 kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_dkdv_wgmma_kernel<HD><<<(unsigned)blocks_kv, kWgThreads,
                                BwdLayout<HD>::kSmem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_dq_wgmma_kernel<HD><<<(unsigned)blocks_q, kWgThreads,
                              BwdLayout<HD>::kDqSmem, stream>>>(p);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores (wgmma) at every head
// dim, forward and backward.
template <int HD>
cudaError_t launch(bool backward, bool bf16_in, const Params& p,
                   cudaStream_t stream) {
  if (!bf16_in)
    return backward ? launch_bwd<HD>(p, stream) : launch_fwd<HD>(p, stream);
  return backward ? launch_bwd_wgmma<HD>(p, stream)
                  : launch_fwd_wgmma<HD>(p, stream);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

int run(bool backward, const Params& p, int hd, int dtype, void* stream) {
  if (p.B <= 0 || p.T <= 0 || p.S <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 ||
      p.B > 65535 || p.Hq > 65535 || p.q_off < 0 ||
      (p.q_off > 0 && (!p.causal || p.q_off + p.T > p.S)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 32: err = launch<32>(backward, dtype == 1, p, s); break;
    case 64: err = launch<64>(backward, dtype == 1, p, s); break;
    case 80: err = launch<80>(backward, dtype == 1, p, s); break;
    case 96: err = launch<96>(backward, dtype == 1, p, s); break;
    case 112: err = launch<112>(backward, dtype == 1, p, s); break;
    case 128: err = launch<128>(backward, dtype == 1, p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. q_off: the causal query offset (0 when full).
// strides: (batch, sequence, head) in elements of q, k, v, out. Returns the
// CUDA error of the launch (0 when accepted).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int T, int S,
                               int Hq, int Hkv, int hd, int dtype, int causal,
                               int q_off, const long long* st, float scale,
                               void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hkv = Hkv;
  p.g = Hkv > 0 ? Hq / Hkv : 0;
  p.causal = causal; p.q_off = q_off; p.scale = scale;
  p.sq = strides_at(st, 0); p.sk = strides_at(st, 1);
  p.sv = strides_at(st, 2); p.so = strides_at(st, 3);
  return run(false, p, hd, dtype, stream);
}

// The forward's route for dtype (0 = fp32, 1 = bf16) and head dim, as
// launch picks it: 0 = CUDA cores, 1 = wgmma.
extern "C" int repro_flash_fwd_route(int hd, int dtype) {
  (void)hd;
  return dtype == 1 ? 1 : 0;
}

// The backward's route, as launch picks it: the same codes.
extern "C" int repro_flash_bwd_route(int hd, int dtype) {
  (void)hd;
  return dtype == 1 ? 1 : 0;
}

namespace {
template <int HD> int wgmma_smem(int part) {
  return part == 0 ? BwdLayout<HD>::kSmem
       : part == 1 ? BwdLayout<HD>::kDqSmem : WgLayout<HD>::kSmem;
}
}  // namespace

// Dynamic shared memory (bytes) of the bf16 (wgmma) kernels at a head dim:
// part 0 the dK/dV kernel, 1 the dQ kernel, 2 the forward; -1 at a head dim
// not taken.
extern "C" int repro_flash_smem(int hd, int part) {
  switch (hd) {
    case 32: return wgmma_smem<32>(part);
    case 64: return wgmma_smem<64>(part);
    case 80: return wgmma_smem<80>(part);
    case 96: return wgmma_smem<96>(part);
    case 112: return wgmma_smem<112>(part);
    case 128: return wgmma_smem<128>(part);
    default: return -1;
  }
}

// strides: (batch, sequence, head) of q, k, v, out, dout, dq, dk, dv.
// delta is (B, Hq, T) fp32 scratch. Launches the delta pre-pass, the dK/dV
// and the dQ kernels in that order; returns the first error.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int T, int S,
                               int Hq, int Hkv, int hd, int dtype, int causal,
                               int q_off, const long long* st, float scale,
                               void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = out; p.dout = dout;
  p.lse = const_cast<float*>(lse); p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hkv = Hkv;
  p.g = Hkv > 0 ? Hq / Hkv : 0;
  p.causal = causal; p.q_off = q_off; p.scale = scale;
  p.sq = strides_at(st, 0); p.sk = strides_at(st, 1);
  p.sv = strides_at(st, 2); p.so = strides_at(st, 3);
  p.sdo = strides_at(st, 4); p.sdq = strides_at(st, 5);
  p.sdk = strides_at(st, 6); p.sdv = strides_at(st, 7);
  return run(true, p, hd, dtype, stream);
}
