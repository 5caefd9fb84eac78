// Decode attention for Hopper (sm_90a): one new token per sequence against a
// slot-contiguous KV cache, grouped-query heads, per-sequence valid lengths,
// online softmax with m, l and the accumulator in fp32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:_decode_kernel
// (called through repro.kernels.ops.decode_attention from
// repro/models/attention.py on every layer of every engine decode step).
//
// Shapes: q (B, Hq, hd); k, v (B, S, Hkv, hd), read through their batch,
// sequence and head strides (the layer's slice of the (L, B, S, Hkv, hd)
// cache, no copy), last dimension contiguous; lengths (B,) int32 on the
// device; out (B, Hq, hd) contiguous, allocated by the caller. Positions at
// or past min(length, S) are masked and not read; length == 0 gives zeros.
// Optionally lse (B, Hq) fp32: the natural log of sum_j exp(scale q.k_j)
// over the valid keys, -inf at length 0; with it the output is written in
// fp32 whatever the inputs' dtype, so that partials of one query over
// several blocks of the cache (the tensor-parallel "kv_seq" ranks) merge
// before any rounding. Without it (a null lse) the output is in the
// inputs' dtype and the launch is the served one.
// bf16 or fp32; hd 32, 64, 80, 96, 112 or 128 (the head dims of the repo's
// configs); a group g = Hq / Hkv of at most 8.
//
// Bound: the bytes it reads. A call must read the valid prefix of K and V
// once, sum_b min(len_b, S) * Hkv * hd * 2 * sizeof(T) bytes, beside which q,
// the lengths and the output are small. It does 4 * g flops per K/V element
// pair, about g flops per byte in bf16, far below the ~295 flops per byte
// where the H100's tensor cores would bind. At the served smollm-135m shape
// (B 8, 3 KV heads) the valid prefix is a few MB: the call is short, so it
// has to spread over every SM and keep many bytes in flight on each.
//
// Design: split-KV with pipelined loads and a combine in the same launch.
// - The grid is (splits, Hkv, B). Split s of (b, kv head) takes the 64-key
//   tiles [s * tps, (s + 1) * tps) of the sequence, tps and splits chosen by
//   the wrapper from S, B * Hkv and the SM count alone (the host does not know
//   the lengths): at least two blocks per SM where S allows. A block whose
//   range lies wholly past the length writes an empty partial and stops.
// - A block's 4 warps take 16 keys each of every tile. Its tiles stream into
//   a ring of 2 to 4 shared-memory stages of K and V with 16-byte cp.async
//   copies (zero-filled past the length), so that up to three tiles are in
//   flight while one is computed; rows are padded by 16 bytes, so the eight
//   lanes of a quarter warp reading eight rows hit distinct banks.
// - Scores: two lanes a key, each over half of hd, against the g query rows
//   held in shared memory in fp32, pre-scaled by scale * log2(e) so the
//   softmax runs on exp2. p.V: a lane owns one 16-byte column chunk of V for
//   a subset of the warp's keys, fp32 FMAs (arithmetic is not the limit).
// - Each warp keeps its own (m, l, acc); the block merges its warps in
//   shared memory and writes its partial (m, l, acc[g][hd]) in fp32 to the
//   workspace. Then it adds 1 to the (b, kv head) counter; the block that
//   arrives last merges every split's partial in split order 0, 1, 2, ...,
//   writes the output (and the log-sum-exp, M ln 2 + ln den from the merge's
//   maximum M, in log2 units, and denominator) and sets the counter back to
//   0. The order is fixed,
//   so a call's output is bit-identical from run to run, and no second
//   launch is needed. The wrapper owns the workspace and the counters (zeros
//   at rest), so a call allocates nothing and stays valid in a CUDA graph.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;                    // keys per pipeline stage
constexpr int kWarpKeys = kTile / kWarps;    // keys of a tile per warp
constexpr int kMaxGroup = 8;                 // query rows per KV head up to 8
constexpr int kMaxSplits = 256;              // the merge's (m, l, w) fit the ring
constexpr int kRingBudget = 72 * 1024;       // bytes for the stage ring
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte chunk unpacked to floats: 4 fp32 or 8 bf16 values.
template <typename T> struct Unpack;
template <> struct Unpack<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void run(uint4 u, float* f) {
    f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
  }
};
template <> struct Unpack<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void run(uint4 u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // little endian: element 2i in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Shared-memory layout of one instantiation.
template <typename T, int HD> struct Geom {
  static constexpr int kVec = Unpack<T>::kN;          // elements per chunk
  static constexpr int kChunks = HD / kVec;           // 16-byte chunks a row
  static constexpr int kRowBytes = HD * (int)sizeof(T) + 16;   // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K, then V
  static constexpr int kFit = kRingBudget / kStageBytes;
  static constexpr int kStages = kFit < 2 ? 2 : (kFit > 4 ? 4 : kFit);
  static constexpr int kKG = 32 / kChunks;            // key groups in p.V
  // after the loop the ring holds each warp's and key group's accumulator
  static constexpr int kRedBytes = kWarps * kKG * kMaxGroup * HD * 4;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kUnion = kRingBytes > kRedBytes ? kRingBytes : kRedBytes;
  static constexpr int kSmem =
      kUnion + (kMaxGroup * HD + 2 * kWarps * kMaxGroup) * 4 + 16;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        void* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml, int* __restrict__ counters,
                        int S, int g, int tps, long long q_sb, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale) {
  using G = Geom<T, HD>;
  constexpr int kVec = G::kVec, kC = G::kChunks, kKG = G::kKG;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + G::kUnion);   // [g][HD]
  float* m_w = q_s + kMaxGroup * HD;                          // [warp][g]
  float* l_w = m_w + kWarps * kMaxGroup;
  int* last = reinterpret_cast<int*>(l_w + kWarps * kMaxGroup);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x, Hkv = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = min(max(lengths[b], 0), S);
  const int t0 = split * tps;
  const int nt = max(0, min((len + kTile - 1) / kTile - t0, tps));
  const long long pidx = ((long long)b * Hkv + h) * splits + split;

  if (nt > 0) {
    const T* kb = k + b * k_sb + h * k_sh;
    const T* vb = v + b * v_sb + h * v_sh;
    // tile i of this block (keys (t0 + i) * 64 ...) into stage i % kStages
    auto issue = [&](int i) {
      unsigned char* stage = smem + (i % G::kStages) * G::kStageBytes;
      const int key0 = (t0 + i) * kTile;
      for (int c = tid; c < 2 * kTile * kC; c += kThreads) {
        const int which = c / (kTile * kC), rem = c % (kTile * kC);
        const int r = rem / kC, ch = rem % kC;
        const bool in = key0 + r < len;
        const T* base = which ? vb : kb;
        const T* src = in ? base + (key0 + r) * (which ? v_ss : k_ss) +
                                ch * kVec
                          : base;
        cp_async16(stage + which * G::kTileBytes + r * G::kRowBytes + ch * 16,
                   src, in ? 16 : 0);
      }
    };
#pragma unroll
    for (int i = 0; i < G::kStages - 1; ++i) {
      if (i < nt) issue(i);
      cp_async_commit();
    }
    for (int i = tid; i < g * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      q_s[i] = to_float(q[b * q_sb + (h * g + r) * q_sh + d]) * scale * kLog2e;
    }

    // scores: lane = 2 * key + half; p.V: lane = kg * kC + dc
    const int kl = lane >> 1, half = lane & 1;
    const int dc = lane % kC, kg = lane / kC;
    const bool pv_on = kg < kKG;
    float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kVec];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[r][e] = 0.f;
    }

    for (int i = 0; i < nt; ++i) {
      cp_async_wait<G::kStages - 2>();
      __syncthreads();     // tile i landed; every warp is done with tile i-1
      if (i + G::kStages - 1 < nt) issue(i + G::kStages - 1);
      cp_async_commit();
      const unsigned char* ks = smem + (i % G::kStages) * G::kStageBytes;
      const unsigned char* vs = ks + G::kTileBytes;
      const int wkey = warp * kWarpKeys;         // the warp's first key
      const bool valid = (t0 + i) * kTile + wkey + kl < len;

      float s[kMaxGroup];
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r) s[r] = 0.f;
      const unsigned char* krow =
          ks + (wkey + kl) * G::kRowBytes + half * (kC / 2) * 16;
      const float* qh = q_s + half * (kC / 2) * kVec;
#pragma unroll
      for (int c = 0; c < kC / 2; ++c) {
        float kf[kVec];
        Unpack<T>::run(*reinterpret_cast<const uint4*>(krow + c * 16), kf);
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r) {
          if (r < g) {
#pragma unroll
            for (int e4 = 0; e4 < kVec; e4 += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(
                  qh + r * HD + c * kVec + e4);
              s[r] = fmaf(qv.x, kf[e4], s[r]);
              s[r] = fmaf(qv.y, kf[e4 + 1], s[r]);
              s[r] = fmaf(qv.z, kf[e4 + 2], s[r]);
              s[r] = fmaf(qv.w, kf[e4 + 3], s[r]);
            }
          }
        }
      }
      float p[kMaxGroup];
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r) {
        p[r] = 0.f;
        if (r < g) {       // g is uniform over the block
          const float sr = s[r] + __shfl_xor_sync(kFull, s[r], 1);
          float mx = valid ? sr : kNegInf;
#pragma unroll
          for (int o = 2; o < 32; o <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
          const float m_new = fmaxf(m[r], mx);
          const float corr = exp2f(m[r] - m_new);
          p[r] = valid ? exp2f(sr - m_new) : 0.f;
          l[r] = l[r] * corr + (half ? 0.f : p[r]);   // each key counted once
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[r][e] *= corr;
          m[r] = m_new;
        }
      }
#pragma unroll
      for (int j = 0; j < (kWarpKeys + kKG - 1) / kKG; ++j) {
        const int kk = kg + j * kKG;             // the lane's key of the 16
        float pk[kMaxGroup];
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r)
          if (r < g)
            pk[r] = __shfl_sync(kFull, p[r], 2 * min(kk, kWarpKeys - 1));
        if (pv_on && kk < kWarpKeys) {
          float vf[kVec];
          Unpack<T>::run(*reinterpret_cast<const uint4*>(
                             vs + (wkey + kk) * G::kRowBytes + dc * 16), vf);
#pragma unroll
          for (int r = 0; r < kMaxGroup; ++r)
            if (r < g) {
#pragma unroll
              for (int e = 0; e < kVec; ++e)
                acc[r][e] = fmaf(pk[r], vf[e], acc[r][e]);
            }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();       // the ring is free: it now holds the warps' sums

    float* red = reinterpret_cast<float*>(smem);   // [warp][kg][g][HD]
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      if (r < g) {
        float lw = l[r];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) lw += __shfl_xor_sync(kFull, lw, o);
        if (lane == 0) {
          m_w[warp * kMaxGroup + r] = m[r];
          l_w[warp * kMaxGroup + r] = lw;
        }
        if (pv_on) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            red[((warp * kKG + kg) * kMaxGroup + r) * HD + dc * kVec + e] =
                acc[r][e];
        }
      }
    }
    __syncthreads();
    // the block's partial, in log2 units; warp 0 saw key t0 * 64, so M is
    // finite (a warp that saw no valid key has m = -1e30, l = 0, acc = 0)
    for (int i = tid; i < g * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      float M = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_w[w * kMaxGroup + r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = exp2f(m_w[w * kMaxGroup + r] - M);
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < kKG; ++j)
          a += red[((w * kKG + j) * kMaxGroup + r) * HD + d];
        num += a * c;
        den += l_w[w * kMaxGroup + r] * c;
      }
      part_acc[(pidx * g + r) * HD + d] = num;
      if (d == 0) {
        part_ml[(pidx * g + r) * 2] = M;
        part_ml[(pidx * g + r) * 2 + 1] = den;
      }
    }
  } else {
    for (int r = tid; r < g; r += kThreads) {    // an empty partial
      part_ml[(pidx * g + r) * 2] = kNegInf;
      part_ml[(pidx * g + r) * 2 + 1] = 0.f;
    }
  }

  // The last block of (b, kv head) to finish merges every split's partial.
  __threadfence();
  __syncthreads();
  int* counter = counters + b * Hkv + h;
  if (tid == 0) *last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // every split's (m, l) into shared memory at once (the ring is free), then
  // per row the weights exp2(m_s - M) of the splits, 0 for an empty one
  const long long base = ((long long)b * Hkv + h) * splits;
  float* ml_s = reinterpret_cast<float*>(smem);      // [split][g][2]
  float* w_s = ml_s + 2 * splits * g;                // [split][g]
  float* den_s = w_s + splits * g;                   // [g]
  for (int i = tid; i < 2 * splits * g; i += kThreads)
    ml_s[i] = __ldcg(part_ml + base * g * 2 + i);
  __syncthreads();
  if (tid < g) {
    float M = kNegInf, den = 0.f;
    for (int sp = 0; sp < splits; ++sp)
      if (ml_s[(sp * g + tid) * 2 + 1] > 0.f)
        M = fmaxf(M, ml_s[(sp * g + tid) * 2]);
    for (int sp = 0; sp < splits; ++sp) {    // in split order
      const float ls = ml_s[(sp * g + tid) * 2 + 1];
      const float c = ls > 0.f ? exp2f(ml_s[(sp * g + tid) * 2] - M) : 0.f;
      w_s[sp * g + tid] = c;
      den += ls * c;
    }
    den_s[tid] = den;
    if (lse != nullptr)
      lse[(long long)b * gridDim.y * g + h * g + tid] =
          den > 0.f ? M * kLn2 + logf(den) : __int_as_float(0xff800000u);
  }
  __syncthreads();
  for (int i = tid; i < g * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const float* acc_r = part_acc + (base * g + r) * HD + d;
    float num = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp)       // in split order
      num += __ldcg(acc_r + (long long)sp * g * HD) * w_s[sp * g + r];
    const float den = den_s[r];
    const float o = den > 0.f ? num / den : 0.f;
    const long long at = ((long long)b * gridDim.y * g + h * g + r) * HD + d;
    if (lse != nullptr)         // fp32 partials for a merge across blocks
      static_cast<float*>(out)[at] = o;
    else
      static_cast<T*>(out)[at] = from_float<T>(o);
  }
  if (tid == 0) *counter = 0;            // zero at rest for the next call
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* lse, float* ws,
                   int* counters,
                   int B, int Hkv, int S, int g, int splits, int tps,
                   const long long* st, float scale, cudaStream_t stream) {
  using G = Geom<T, HD>;
  // once per instantiation, so that none falls inside a CUDA graph capture
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
  if (attr != cudaSuccess) return attr;
  float* part_ml = ws + (long long)B * Hkv * splits * g * HD;
  const dim3 grid(splits, Hkv, B);
  decode_attention_kernel<T, HD><<<grid, kThreads, G::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, out, lse, ws, part_ml,
      counters, S, g, tps, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const int* lengths, void* out, float* lse, float* ws,
                      int* counters,
                      int B, int Hkv, int S, int g, int splits, int tps,
                      const long long* st, float scale, cudaStream_t stream) {
#define REPRO_DECODE_HD(HD)                                                  \
  case HD:                                                                   \
    return launch<T, HD>(q, k, v, lengths, out, lse, ws, counters, B, Hkv,  \
                         S, g, splits, tps, st, scale, stream);
  switch (hd) {
    REPRO_DECODE_HD(32)
    REPRO_DECODE_HD(64)
    REPRO_DECODE_HD(80)
    REPRO_DECODE_HD(96)
    REPRO_DECODE_HD(112)
    REPRO_DECODE_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_HD
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. out: (B, Hq, hd) in dtype, or fp32 where lse
// is not null; lse: null, or (B, Hq) fp32 for the log-sum-exp of each
// query's scaled scores. strides (in elements): q batch, q head,
// k batch, k seq, k head, v batch, v seq, v head. ws: fp32 workspace of
// B * Hkv * splits * g * (hd + 2) floats (partial accumulators, then (m, l)
// pairs); counters: B * Hkv int32, zero at rest and left zero by the call.
// Split s takes key tiles [s * tps, (s + 1) * tps) of 64 keys; splits * tps
// * 64 >= S. Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* lse, void* ws, void* counters, int B, int Hq, int Hkv,
    int S, int hd, int dtype, int splits, int tps, long long q_sb,
    long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || B <= 0 ||
      B > 65535 || Hkv > 65535 || S <= 0 || splits <= 0 || tps <= 0 ||
      splits > kMaxSplits ||
      (long long)splits * tps * kTile < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const int g = Hq / Hkv;
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  float* ls = static_cast<float*>(lse);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, k, v, len, out, ls, w, cnt, B, Hkv, S, g,
                           splits, tps, st, scale, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, len, out, ls, w, cnt, B, Hkv,
                                   S, g, splits, tps, st, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
