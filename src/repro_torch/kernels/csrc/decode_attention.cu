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
// or past min(length, S) are masked and tiles wholly past them are not
// read; length == 0 gives zeros. bf16 or fp32; hd 32, 64 or 128.
//
// Bound: the bytes it reads. A call must read the valid prefix of K and V
// once, sum_b min(len_b, S) * Hkv * hd * 2 * sizeof(T) bytes, beside which q,
// the lengths and the output are small. It does 4 * g flops per K/V element
// pair (g = Hq / Hkv query rows per KV head), about g flops per byte in
// bf16, far below the ~295 flops per byte where the H100's tensor cores
// would bind. So the design aims only to stream K and V once, from as many
// SMs as it can keep busy.
//
// Design (simple first): one block per (b, kv head) holds the g query rows
// of that head in shared memory. Its 8 warps stride over the valid prefix in
// tiles of 32 keys. In a tile each lane scores one key against the g rows
// (16-byte loads along hd), the warp updates its own (m, l, acc) and then
// accumulates p.V with each lane owning hd/32 output dimensions (coalesced
// V rows, 8 rows loaded together). The warps' partials are combined in
// shared memory at the end.
// Known limit: B * Hkv blocks (24 for smollm-135m at 8 slots) leave most of
// the 132 SMs idle, so this kernel cannot reach the bandwidth bound at small
// batch; splitting the sequence over blocks with a combine pass is the
// next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kTile = 32;       // keys per warp tile: one key per lane
constexpr int kMaxGroup = 8;    // query rows per KV head (Hq / Hkv) up to 8
constexpr int kChunk = 8;       // V rows loaded together in the p.V loop
constexpr float kNegInf = -1e30f;
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

// One 16-byte load unpacked to floats: 4 fp32 or 8 bf16 values.
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int S, int g, long long q_sb, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale) {
  constexpr int kVec = Unpack<T>::kN;   // elements per 16-byte load
  constexpr int kPerLane = HD / 32;     // output dimensions per lane
  __shared__ float q_s[kMaxGroup][HD];
  __shared__ float m_s[kWarps][kMaxGroup];
  __shared__ float l_s[kWarps][kMaxGroup];
  __shared__ float acc_s[kWarps][kMaxGroup][HD];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hq = gridDim.x * g;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = min(max(lengths[b], 0), S);

  for (int i = threadIdx.x; i < g * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    q_s[r][d] = to_float(q[b * q_sb + (h * g + r) * q_sh + d]) * scale;
  }
  __syncthreads();

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  float m[kMaxGroup], l[kMaxGroup], acc[kMaxGroup][kPerLane];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[r][e] = 0.f;
  }

  const int n_tiles = (len + kTile - 1) / kTile;
  for (int t = warp; t < n_tiles; t += kWarps) {
    const int j = t * kTile + lane;
    const bool valid = j < len;
    float s[kMaxGroup];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) s[r] = 0.f;
    if (valid) {
      const uint4* krow = reinterpret_cast<const uint4*>(kb + j * k_ss);
#pragma unroll
      for (int c = 0; c < HD / kVec; ++c) {
        float kf[kVec];
        Unpack<T>::run(krow[c], kf);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
#pragma unroll
          for (int r = 0; r < kMaxGroup; ++r)
            if (r < g) s[r] = fmaf(q_s[r][c * kVec + i], kf[i], s[r]);
        }
      }
    }
    float p[kMaxGroup];
#pragma unroll
    for (int r = 0; r < kMaxGroup; ++r) {
      p[r] = 0.f;
      if (r < g) {   // g is uniform over the block: every lane takes this
        const float sr = valid ? s[r] : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float corr = expf(m[r] - m_new);
        p[r] = valid ? expf(sr - m_new) : 0.f;
        l[r] = l[r] * corr + p[r];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) acc[r][e] *= corr;
        m[r] = m_new;
      }
    }
    // p.V over the tile's valid keys, kChunk V rows at a time: the chunk's
    // loads go out together, so a tile waits on memory a few times rather
    // than once per key.
    const int nk = min(kTile, len - t * kTile);
    for (int k0 = 0; k0 < nk; k0 += kChunk) {
      float vf[kChunk][kPerLane];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        // rows past the tile's valid keys read the last valid row (always
        // in bounds) and count as zero
        const bool in = k0 + c < nk;
        const T* vrow = vb + (t * kTile + min(k0 + c, nk - 1)) * v_ss;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) {
          const float x = to_float(vrow[lane + 32 * e]);
          vf[c][e] = in ? x : 0.f;
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int r = 0; r < kMaxGroup; ++r) {
          if (r < g) {
            const float pk = __shfl_sync(kFull, p[r], k0 + c);
#pragma unroll
            for (int e = 0; e < kPerLane; ++e)
              acc[r][e] = fmaf(pk, vf[c][e], acc[r][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    if (r < g) {
      const float lw = warp_sum(l[r]);
      if (lane == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = lw;
      }
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc_s[warp][r][lane + 32 * e] = acc[r][e];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < g * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][r]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][r] - mx);
      den += l_s[w][r] * c;
      num += acc_s[w][r][d] * c;
    }
    out[((long long)b * hq + h * g + r) * HD + d] =
        from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int Hkv, int S,
                   int g, const long long* st, float scale,
                   cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, HD><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, g, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const int* lengths, void* out, int B, int Hkv, int S,
                      int g, const long long* st, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, Hkv, S, g, st, scale, stream);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, Hkv, S, g, st, scale, stream);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, Hkv, S, g, st, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. strides (in elements): q batch, q head,
// k batch, k seq, k head, v batch, v seq, v head. Returns the CUDA error of
// the launch (0 when it was accepted).
extern "C" int repro_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int B, int Hq, int Hkv, int S, int hd, int dtype,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup)
    return cudaErrorInvalidValue;
  const long long st[8] = {q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  const int g = Hq / Hkv;
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_hd<float>(hd, q, k, v, len, out, B, Hkv, S, g, st, scale, s);
  else if (dtype == 1)
    err = launch_hd<__nv_bfloat16>(hd, q, k, v, len, out, B, Hkv, S, g, st, scale, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
