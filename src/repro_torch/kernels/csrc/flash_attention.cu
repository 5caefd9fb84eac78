// Flash attention for Hopper (sm_90a): blocked attention with an online
// softmax, causal (qpos >= kpos, aligned at position 0) or full, grouped-
// query heads (kv head = h / g), forward and backward.
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
// 64, 80, 96, 112 or 128 (multiples of 16, so the m16n8k16 fragments and
// the 16-column thread tiles cover hd exactly); any T, S >= 1 (ragged
// tails are masked).
//
// Bound: operations. At the training shape of smollm-135m (B 8, T 2048,
// 9/3 heads, hd 64) the causal forward does 4 * B * Hq * hd * T^2 / 2 =
// 39 GFLOP on 88 MB of inputs and outputs, some 440 flops per byte, above
// the ~295 where the H100's tensor cores, not its memory, bind. The
// backward does 2.5 times the work on about twice the bytes.
//
// Design: two routes with the same blocking, masks and outputs.
// - bf16 (the training path) runs on the tensor cores: warp-level
//   mma.sync m16n8k16, bf16 in and fp32 accumulate, for every product;
//   4 warps own a 64-row tile, 16 rows each; see "bf16 on tensor cores".
// - fp32 runs on the CUDA cores (fp32 FMAs, so that fp32 results hold to
//   1e-4): 256 threads as 16 x 16, a thread owning 4 consecutive rows and
//   the columns tx, tx + 16, ... of a tile; every product is "NT" (both
//   operands row-major) or "NN" (the second indexed [k][col]) over shared
//   memory with rows padded to hd + 1 floats, so that reads are broadcast
//   or conflict-free.
// Both, forward: one block per (64-row q tile, q head, b) carries
// (m, l, acc) in registers over the 64-key tiles; the causal loop stops at
// the diagonal tile and masks inside it (the Pallas grid instead visits
// every key block and skips the compute). Writes O in the input type and
// the per-row log-sum-exp of the scaled scores in fp32 for the backward.
// Backward: a pre-pass computes delta = rowsum(dO * O); the dK/dV kernel
// takes one block per (key tile, kv head, b) and loops over the g query
// heads of the group and the query tiles from the diagonal on, so the sum
// over the group stays in the block; the dQ kernel takes one block per
// (q tile, q head, b). No atomics: every gradient is summed in one fixed
// order, so a train step is bit-identical from run to run.
// Known limits: mma.sync reaches a fraction of the card's bf16 rate (the
// full rate needs wgmma with TMA-fed shared memory and warp specialisation);
// tiles are loaded synchronously (no cp.async double buffering), and the
// causal work per block is uneven (diagonal tiles are cheap).
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
  int B, T, S, Hq, Hkv, g, causal;
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
  return r < p.T && c < p.S && (!p.causal || r >= c);
}

// Key tiles that rows [q0, q0 + 64) attend to: up to the diagonal tile when
// causal.
__device__ __forceinline__ int key_tiles(const Params& p, int q0) {
  int n = (p.S + kTile - 1) / kTile;
  if (p.causal) n = min(n, min(q0 + kTile - 1, p.T - 1) / kTile + 1);
  return n;
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
// delta[b, h, r] = sum_d dout[b, r, h, d] * out[b, r, h, d]: one warp a row.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_delta_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Hq * p.T) return;
  const int r = row % p.T;
  const int h = (row / p.T) % p.Hq;
  const int b = row / ((long long)p.T * p.Hq);
  const T* o = static_cast<const T*>(p.o) + b * p.so.b + r * p.so.s + h * p.so.h;
  const T* d = static_cast<const T*>(p.dout) + b * p.sdo.b + r * p.sdo.s +
               h * p.sdo.h;
  float acc = 0.f;
#pragma unroll
  for (int e = lane; e < HD; e += 32) acc = fmaf(to_float(o[e]), to_float(d[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) p.delta[row] = acc;
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
  // causal: the first query row that sees key k0 is row k0
  const int qt0 = p.causal ? k0 / kTile : 0;
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

// ------------------------------------------------- bf16 on tensor cores --
// The same three kernels for bf16 inputs with every product on the tensor
// cores: warp-level mma.sync m16n8k16 (bf16 in, fp32 accumulate). A block
// of 4 warps owns a 64-row tile, 16 rows a warp. Tiles stay bf16 in shared
// memory, row-major [row][hd + 8] and, where a product needs the other
// operand order, transposed [hd][64 + 8]; the pads put the 8 rows a
// fragment load touches on distinct banks. Scores, softmax statistics and
// gradients are fp32 in registers; P and dS are rounded to bf16 as the
// A operand of the next product (the score accumulator's layout is the
// A fragment's, so they never pass through shared memory).
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTLd = kTile + 8;     // transposed tile row: 64 keys + pad

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, rows row0.., columns k0..) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int row0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* r = tile + (row0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * ld);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * ld + 8);
}

// B fragment (16 x 8: k0.. by n0..) of B[k][n] = tile[n][k], a tile whose
// rows are the n index.
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* tile, int ld, int n0,
                                       int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* r = tile + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(r);
  b1 = ld32(r + 8);
}

// The A fragment of keys (or queries) 16 kk.. of a 16 x 64 accumulator
// held as 8 tiles of 16 x 8, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&s)[8][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// Rows [row0, row0 + 64) of the (b, h) slice of a (B, L, H, HD) bf16 tensor
// into rows[r][HD + 8] and/or cols[d][64 + 8] (either may be null); rows at
// or past L are zeros.
template <int HD>
__device__ __forceinline__ void load_bf16_tile(bf16* rows, bf16* cols,
                                               const bf16* base, Strides st,
                                               int b, int h, int row0, int L) {
  const bf16* src = base + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * HD / 8; i += kTcThreads) {
    const int r = i % kTile, c = (i / kTile) * 8;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (row0 + r < L)
      u = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st.s + c);
    if (rows) *reinterpret_cast<uint4*>(rows + r * (HD + 8) + c) = u;
    if (cols) {
      const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(c + j) * kTLd + r] = e[j];
    }
  }
}

// Writes a warp's 16 x HD accumulator (rows row0 + g, row0 + g + 8) times
// mult as bf16 pairs into the (b, h) slice of a (B, L, H, HD) tensor.
template <int HD>
__device__ __forceinline__ void store_bf16_acc(bf16* base, Strides st, int b,
                                               int h, int row0, int L,
                                               const float (&acc)[HD / 8][4],
                                               float mult) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  bf16* dst = base + b * st.b + h * st.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r < L) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<uint32_t*>(dst + (long long)r * st.s + 8 * n + 2 * t) =
            pack_bf16(acc[n][2 * half] * mult, acc[n][2 * half + 1] * mult);
    }
  }
}

template <int HD>
constexpr int tc_fwd_smem() { return (2 * kTile * (HD + 8) + HD * kTLd) * 2; }
template <int HD>
constexpr int tc_dkdv_smem() {
  return (4 * kTile * (HD + 8) + 2 * HD * kTLd) * 2 + 2 * kTile * 4;
}
template <int HD>
constexpr int tc_dq_smem() {
  return (4 * kTile * (HD + 8) + HD * kTLd) * 2 + 2 * kTile * 4;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const Params p) {
  constexpr int LD = HD + 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* ks = qs + kTile * LD;
  bf16* vt = ks + kTile * LD;           // V^T [d][key]
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int row_a = q0 + 16 * w + g;    // this thread's rows: row_a, +8

  load_bf16_tile<HD>(qs, nullptr, static_cast<const bf16*>(p.q), p.sq, b, h,
                     q0, p.T);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  const int n_kt = key_tiles(p, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_bf16_tile<HD>(ks, nullptr, static_cast<const bf16*>(p.k), p.sk, b,
                       hk, k0, p.S);
    load_bf16_tile<HD>(nullptr, vt, static_cast<const bf16*>(p.v), p.sv, b,
                       hk, k0, p.S);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      load_a(a, qs, LD, 16 * w, 16 * kk);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, LD, 8 * n, 16 * kk);
        mma_bf16(s[n], a, b0, b1);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row_a + 8 * half;
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = visible(p, r, k0 + 8 * n + 2 * t + e) ? x * p.scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      // every row sees key 0 in tile 0, so m is finite from then on
      const float m_new = fmaxf(m[half], mx);
      const float corr = __expf(m[half] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * half + e];
          x = x == kNegInf ? 0.f : __expf(x - m_new);
          sum += x;
        }
      l[half] = l[half] * corr + sum;   // this thread's columns only
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][2 * half] *= corr;
        o[n][2 * half + 1] *= corr;
      }
      m[half] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, vt, kTLd, 8 * n, 16 * kk);
        mma_bf16(o[n], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lsum = l[half];
    lsum += __shfl_xor_sync(kFull, lsum, 1);
    lsum += __shfl_xor_sync(kFull, lsum, 2);
    lsum = fmaxf(lsum, 1e-30f);
    const int r = row_a + 8 * half;
    if (t == 0 && r < p.T)
      p.lse[((long long)b * p.Hq + h) * p.T + r] = m[half] + __logf(lsum);
    const float inv = 1.f / lsum;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][2 * half] *= inv;
      o[n][2 * half + 1] *= inv;
    }
  }
  store_bf16_acc<HD>(static_cast<bf16*>(p.out), p.so, b, h, q0 + 16 * w,
                     p.T, o, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_dkdv_tc_kernel(const Params p) {
  constexpr int LD = HD + 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + kTile * LD;
  bf16* qs = vs + kTile * LD;
  bf16* dos = qs + kTile * LD;
  bf16* qt = dos + kTile * LD;          // Q^T  [d][query]
  bf16* dot = qt + HD * kTLd;           // dO^T [d][query]
  float* lse_s = reinterpret_cast<float*>(dot + HD * kTLd);
  float* delta_s = lse_s + kTile;
  const int k0 = blockIdx.x * kTile, hk = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;
  const int key_a = k0 + 16 * w + g;    // this thread's keys: key_a, +8

  load_bf16_tile<HD>(ks, nullptr, static_cast<const bf16*>(p.k), p.sk, b, hk,
                     k0, p.S);
  load_bf16_tile<HD>(vs, nullptr, static_cast<const bf16*>(p.v), p.sv, b, hk,
                     k0, p.S);
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  const int n_qt = (p.T + kTile - 1) / kTile;
  const int qt0 = p.causal ? k0 / kTile : 0;
  for (int hh = 0; hh < p.g; ++hh) {
    const int h = hk * p.g + hh;
    for (int qt_i = qt0; qt_i < n_qt; ++qt_i) {
      const int q0 = qt_i * kTile;
      __syncthreads();
      load_bf16_tile<HD>(qs, qt, static_cast<const bf16*>(p.q), p.sq, b, h,
                         q0, p.T);
      load_bf16_tile<HD>(dos, dot, static_cast<const bf16*>(p.dout), p.sdo,
                         b, h, q0, p.T);
      if (threadIdx.x < kTile) {
        const int r = q0 + threadIdx.x;
        const long long at = ((long long)b * p.Hq + h) * p.T + r;
        lse_s[threadIdx.x] = r < p.T ? p.lse[at] : 0.f;
        delta_s[threadIdx.x] = r < p.T ? p.delta[at] : 0.f;
      }
      __syncthreads();
      float st[8][4], dpt[8][4];     // S^T, dP^T: [key][query]
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, ks, LD, 16 * w, 16 * kk);
        load_a(av, vs, LD, 16 * w, 16 * kk);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, qs, LD, 8 * n, 16 * kk);
          mma_bf16(st[n], ak, b0, b1);
          load_b(b0, b1, dos, LD, 8 * n, 16 * kk);
          mma_bf16(dpt[n], av, b0, b1);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qq = 8 * n + 2 * t + (e & 1);     // query in the tile
          const int c = key_a + 8 * (e >> 1);
          const float pv = visible(p, q0 + qq, c)
                               ? __expf(st[n][e] * p.scale - lse_s[qq]) : 0.f;
          st[n][e] = pv;
          dpt[n][e] = pv * (dpt[n][e] - delta_s[qq]);
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ap[4], ads[4];
        acc_to_a(ap, st, kk);
        acc_to_a(ads, dpt, kk);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t b0, b1;
          load_b(b0, b1, dot, kTLd, 8 * n, 16 * kk);
          mma_bf16(dv[n], ap, b0, b1);       // dV += P^T dO
          load_b(b0, b1, qt, kTLd, 8 * n, 16 * kk);
          mma_bf16(dk[n], ads, b0, b1);      // dK += dS^T Q
        }
      }
    }
  }
  store_bf16_acc<HD>(static_cast<bf16*>(p.dk), p.sdk, b, hk, k0 + 16 * w,
                     p.S, dk, p.scale);
  store_bf16_acc<HD>(static_cast<bf16*>(p.dv), p.sdv, b, hk, k0 + 16 * w,
                     p.S, dv, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_tc_kernel(const Params p) {
  constexpr int LD = HD + 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + kTile * LD;
  bf16* ks = dos + kTile * LD;
  bf16* vs = ks + kTile * LD;
  bf16* kt_s = vs + kTile * LD;         // K^T [d][key]
  float* lse_s = reinterpret_cast<float*>(kt_s + HD * kTLd);
  float* delta_s = lse_s + kTile;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / p.g;
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2,
            t = threadIdx.x & 3;

  load_bf16_tile<HD>(qs, nullptr, static_cast<const bf16*>(p.q), p.sq, b, h,
                     q0, p.T);
  load_bf16_tile<HD>(dos, nullptr, static_cast<const bf16*>(p.dout), p.sdo, b,
                     h, q0, p.T);
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    const long long at = ((long long)b * p.Hq + h) * p.T + r;
    lse_s[threadIdx.x] = r < p.T ? p.lse[at] : 0.f;
    delta_s[threadIdx.x] = r < p.T ? p.delta[at] : 0.f;
  }
  __syncthreads();
  const int rl = 16 * w + g;            // this thread's rows in the tile
  const float lse_r[2] = {lse_s[rl], lse_s[rl + 8]};
  const float delta_r[2] = {delta_s[rl], delta_s[rl + 8]};
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int n_kt = key_tiles(p, q0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_bf16_tile<HD>(ks, kt_s, static_cast<const bf16*>(p.k), p.sk, b, hk,
                       k0, p.S);
    load_bf16_tile<HD>(vs, nullptr, static_cast<const bf16*>(p.v), p.sv, b,
                       hk, k0, p.S);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, qs, LD, 16 * w, 16 * kk);
      load_a(ado, dos, LD, 16 * w, 16 * kk);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, ks, LD, 8 * n, 16 * kk);
        mma_bf16(s[n], aq, b0, b1);
        load_b(b0, b1, vs, LD, 8 * n, 16 * kk);
        mma_bf16(dp[n], ado, b0, b1);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float pv = visible(p, q0 + rl + 8 * half,
                                 k0 + 8 * n + 2 * t + (e & 1))
                             ? __expf(s[n][e] * p.scale - lse_r[half]) : 0.f;
        s[n][e] = pv * (dp[n][e] - delta_r[half]);       // dS
      }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s, kk);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        uint32_t b0, b1;
        load_b(b0, b1, kt_s, kTLd, 8 * n, 16 * kk);
        mma_bf16(dq[n], a, b0, b1);          // dQ += dS K
      }
    }
  }
  store_bf16_acc<HD>(static_cast<bf16*>(p.dq), p.sdq, b, h, q0 + 16 * w, p.T,
                     dq, p.scale);
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
  const int warps = kThreads / 32;
  flash_delta_kernel<float, HD><<<(unsigned)((rows + warps - 1) / warps), kThreads,
                              0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kTile - 1) / kTile, p.Hkv, p.B);
  flash_dkdv_kernel<HD><<<grid_kv, kThreads, dkdv_smem<HD>(), stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((p.T + kTile - 1) / kTile, p.Hq, p.B);
  flash_dq_kernel<HD><<<grid_q, kThreads, dq_smem<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_fwd_tc(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_fwd_smem<HD>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.T + kTile - 1) / kTile, p.Hq, p.B);
  flash_fwd_tc_kernel<HD><<<grid, kTcThreads, tc_fwd_smem<HD>(), stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bwd_tc(const Params& p, cudaStream_t stream) {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_dkdv_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_dkdv_smem<HD>());
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_dq_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_dq_smem<HD>());
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  cudaError_t err;
  const long long rows = (long long)p.B * p.Hq * p.T;
  const int warps = kThreads / 32;
  flash_delta_kernel<bf16, HD><<<(unsigned)((rows + warps - 1) / warps),
                                 kThreads, 0, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_kv((p.S + kTile - 1) / kTile, p.Hkv, p.B);
  flash_dkdv_tc_kernel<HD><<<grid_kv, kTcThreads, tc_dkdv_smem<HD>(),
                             stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid_q((p.T + kTile - 1) / kTile, p.Hq, p.B);
  flash_dq_tc_kernel<HD><<<grid_q, kTcThreads, tc_dq_smem<HD>(), stream>>>(p);
  return cudaGetLastError();
}

// fp32 on the CUDA cores, bf16 on the tensor cores.
template <int HD>
cudaError_t launch(bool backward, bool bf16_in, const Params& p,
                   cudaStream_t stream) {
  if (bf16_in)
    return backward ? launch_bwd_tc<HD>(p, stream) : launch_fwd_tc<HD>(p, stream);
  return backward ? launch_bwd<HD>(p, stream) : launch_fwd<HD>(p, stream);
}

Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

int run(bool backward, const Params& p, int hd, int dtype, void* stream) {
  if (p.B <= 0 || p.T <= 0 || p.S <= 0 || p.Hkv <= 0 || p.Hq % p.Hkv != 0 ||
      p.B > 65535 || p.Hq > 65535)
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

// dtype: 0 = fp32, 1 = bf16. strides: (batch, sequence, head) in elements
// of q, k, v, out. Returns the CUDA error of the launch (0 when accepted).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* out, float* lse, int B, int T, int S,
                               int Hq, int Hkv, int hd, int dtype, int causal,
                               const long long* st, float scale,
                               void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hkv = Hkv;
  p.g = Hkv > 0 ? Hq / Hkv : 0;
  p.causal = causal; p.scale = scale;
  p.sq = strides_at(st, 0); p.sk = strides_at(st, 1);
  p.sv = strides_at(st, 2); p.so = strides_at(st, 3);
  return run(false, p, hd, dtype, stream);
}

// strides: (batch, sequence, head) of q, k, v, out, dout, dq, dk, dv.
// delta is (B, Hq, T) fp32 scratch. Launches the delta pre-pass, the dK/dV
// and the dQ kernels in that order; returns the first error.
extern "C" int repro_flash_bwd(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, int B, int T, int S,
                               int Hq, int Hkv, int hd, int dtype, int causal,
                               const long long* st, float scale,
                               void* stream) {
  Params p{};
  p.q = q; p.k = k; p.v = v; p.o = out; p.dout = dout;
  p.lse = const_cast<float*>(lse); p.delta = delta;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.B = B; p.T = T; p.S = S; p.Hq = Hq; p.Hkv = Hkv;
  p.g = Hkv > 0 ? Hq / Hkv : 0;
  p.causal = causal; p.scale = scale;
  p.sq = strides_at(st, 0); p.sk = strides_at(st, 1);
  p.sv = strides_at(st, 2); p.so = strides_at(st, 3);
  p.sdo = strides_at(st, 4); p.sdq = strides_at(st, 5);
  p.sdk = strides_at(st, 6); p.sdv = strides_at(st, 7);
  return run(true, p, hd, dtype, stream);
}
