// A whole Gemini DF-ResNet stage for inference, BN folded (see
// wespeaker_tpu_torch/ops/inv_bottleneck.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/inv_bottleneck_pallas.py::fused_inv_bottleneck_stage.
//
// C interface: ws_inv_bottleneck_stage(...) issues, on the given stream,
// for each block i of the stage
//   expand GEMM (BN1-relu epilogue)                   x -> h (M, 4C)
//   -> depthwise 3x3, BN2, relu                       h -> g (M, 4C)
//   -> project GEMM (BN3 + residual + relu epilogue)  g -> out (M, C)
// with M = B*F*T channels-last positions; block 0 reads x, later blocks
// read and overwrite out. Returns the first CUDA error (0 on success).

#include <algorithm>

#include "common.cuh"

namespace ws {

// ---- the depthwise 3x3 on channels-last rows ----
//
// A thread owns 4 channels of one row r = b * F + f of the map and walks
// the frames of its t chunk. It keeps their nine taps and a 3 x 3 window of
// h (rows f-1, f, f+1 x frames t-1, t, t+1) in registers as f32, converted
// once per load and used by three frames; it loads each column (three
// loads of 4 channels) two frames ahead of its use, so that the loads are
// in flight while the frame before computes; and it sums the taps F offset
// outer, T offset inner, as JAX `_stage_kernel` sums them. Zeros stand
// beyond the map's ends (the conv's zero padding), so any F and T work. A
// warp reads 128 contiguous channels of one row; the rows f-1 and f+1 are
// the rows of its neighbouring warps in the block (L1 hits). The t chunks
// split T until the launch has a few waves of threads.

constexpr int kDwCh = 4;                      // channels a thread
constexpr int kDwVec = 32;                    // threads a row
constexpr int kDwRowsPerBlock = 8;
constexpr int kDwThreads = kDwVec * kDwRowsPerBlock;
constexpr int kDwMinChunk = 16;               // frames a thread walks, least

// 4 channels of T as loaded (16 or 8 bytes), and as f32.
template <typename T>
using Raw4 = typename std::conditional<std::is_same<T, float>::value, float4,
                                       uint2>::type;

template <typename T>
__device__ __forceinline__ Raw4<T> raw4(const T* p, bool valid) {
  return valid ? *reinterpret_cast<const Raw4<T>*>(p) : Raw4<T>{};
}
__device__ __forceinline__ void cvt4(const float4& v, float* out) {
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
__device__ __forceinline__ void cvt4(const uint2& v, float* out) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(e[i]);
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, bool valid, float* out) {
  cvt4(raw4(p, valid), out);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(kDwThreads)
    depthwise3x3_kernel(const T* __restrict__ h, const T* __restrict__ wdw,
                        const float* __restrict__ s2,
                        const float* __restrict__ t2, T* __restrict__ g,
                        int rows, int f, int t, int c4, int nc, int ntc,
                        int chunk) {
  unsigned idx = blockIdx.x;
  const int cc = idx % nc;
  idx /= nc;
  const int tc = idx % ntc;
  const int row = (int)(idx / ntc) * kDwRowsPerBlock + threadIdx.x / kDwVec;
  if (row >= rows) return;
  const int c = (cc * kDwVec + threadIdx.x % kDwVec) * kDwCh;
  const int fr = row % f;
  const bool valid_row[3] = {fr > 0, true, fr + 1 < f};
  const T* hr = h + (size_t)row * t * c4 + c;  // (row, frame 0)
  const long long row_step = (long long)t * c4;

  float w[9][kDwCh], sc[kDwCh], sh[kDwCh];
#pragma unroll
  for (int k = 0; k < 9; ++k) load4(wdw + (size_t)k * c4 + c, true, w[k]);
  load4(s2 + c, true, sc);
  load4(t2 + c, true, sh);

  const int t0 = tc * chunk, t1 = min(t, t0 + chunk);
  float win[3][3][kDwCh];  // [row f-1, f, f+1][frame t-1, t, t+1]
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      const int tq = t0 - 1 + dt;
      load4(hr + (dr - 1) * row_step + (long long)tq * c4,
            valid_row[dr] && tq >= 0 && tq < t, win[dr][dt]);
    }
  Raw4<T> ahead[3];  // frame t+1 as loaded
#pragma unroll
  for (int dr = 0; dr < 3; ++dr)
    ahead[dr] = raw4(hr + (dr - 1) * row_step + (long long)(t0 + 1) * c4,
                     valid_row[dr] && t0 + 1 < t);
  for (int tq = t0; tq < t1; ++tq) {
    const bool later = tq + 2 < t;
#pragma unroll
    for (int dr = 0; dr < 3; ++dr) {
      const Raw4<T> v = raw4(
          hr + (dr - 1) * row_step + (long long)(tq + 2) * c4,
          valid_row[dr] && later);
      cvt4(ahead[dr], win[dr][2]);
      ahead[dr] = v;
    }
    float acc[kDwCh];
#pragma unroll
    for (int e = 0; e < kDwCh; ++e) {
      acc[e] = 0.f;
#pragma unroll
      for (int df = 0; df < 3; ++df)
#pragma unroll
        for (int dt = 0; dt < 3; ++dt)
          acc[e] = fmaf(win[df][dt][e], w[df * 3 + dt][e], acc[e]);
      acc[e] = fmaxf(acc[e] * sc[e] + sh[e], 0.f);
    }
    store4(g + ((size_t)row * t + tq) * c4 + c, acc);
#pragma unroll
    for (int dr = 0; dr < 3; ++dr)
#pragma unroll
      for (int e = 0; e < kDwCh; ++e) {
        win[dr][0][e] = win[dr][1][e];
        win[dr][1][e] = win[dr][2][e];
      }
  }
}

template <typename T>
cudaError_t depthwise3x3(const T* h, const T* wdw, const float* s2,
                         const float* t2, T* g, int b, int f, int t, int c4,
                         cudaStream_t stream) {
  constexpr int kChunk = kDwVec * kDwCh;  // channels a block
  if (c4 % kChunk) return cudaErrorInvalidValue;
  const int nc = c4 / kChunk;
  const long long rows = (long long)b * f;
  const long long row_groups = (rows + kDwRowsPerBlock - 1) / kDwRowsPerBlock;
  // t chunks: enough threads for ~4 waves of 2,048 a SM on 132 SMs, each
  // chunk at least kDwMinChunk frames
  const long long threads = rows * nc * kDwVec;
  long long ntc = (4LL * 132 * 2048 + threads - 1) / threads;
  ntc = std::max(1LL, std::min(ntc, (long long)(t + kDwMinChunk - 1) /
                                        kDwMinChunk));
  const int chunk = (int)((t + ntc - 1) / ntc);
  ntc = (t + chunk - 1) / chunk;
  const long long blocks = row_groups * ntc * nc;
  if (rows > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  depthwise3x3_kernel<T><<<(unsigned)blocks, kDwThreads, 0, stream>>>(
      h, wdw, s2, t2, g, (int)rows, f, t, c4, nc, (int)ntc, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t inv_stage(const T* x, const T* w1, const float* s1,
                      const float* t1, const T* wdw, const float* s2,
                      const float* t2, const T* w2, const float* s3,
                      const float* t3, T* h, T* g, T* out, int b, int f,
                      int t, int c, int blocks, cudaStream_t stream) {
  const long long m = (long long)b * f * t;
  const int c4 = 4 * c;
  if (b < 1 || f < 1 || t < 1 || c % 32 || blocks < 1 || m > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaError_t err;
  for (int i = 0; i < blocks; ++i) {
    const T* xin = i == 0 ? x : out;
    // 1. h = relu((x @ w1[i]) * s1[i] + t1[i])
    GemmArgs p = gemm_args(xin, nullptr, nullptr, 1, c,
                           w1 + (size_t)i * c * c4, h, (int)m, c4, kNone);
    p.scale = s1 + (size_t)i * c4;
    p.shift = t1 + (size_t)i * c4;
    if ((err = gemm_affine_relu<T, kFormAffineRelu>(p, stream)) !=
        cudaSuccess)
      return err;
    // 2. g = relu(dw3x3(h) * s2[i] + t2[i])
    if ((err = depthwise3x3<T>(h, wdw + (size_t)i * 9 * c4,
                               s2 + (size_t)i * c4, t2 + (size_t)i * c4, g,
                               b, f, t, c4, stream)) != cudaSuccess)
      return err;
    // 3. out = relu((g @ w2[i]) * s3[i] + t3[i] + x), in place from block 1
    GemmArgs q = gemm_args(g, nullptr, nullptr, 1, c4,
                           w2 + (size_t)i * c4 * c, out, (int)m, c, kNone);
    q.scale = s3 + (size_t)i * c;
    q.shift = t3 + (size_t)i * c;
    q.res = xin;
    if ((err = gemm_affine_relu<T, kFormAffineResRelu>(q, stream)) !=
        cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

}  // namespace ws

extern "C" int ws_inv_bottleneck_stage(
    const void* x, const void* w1, const float* s1, const float* t1,
    const void* wdw, const float* s2, const float* t2, const void* w2,
    const float* s3, const float* t3, void* h, void* g, void* out, int b,
    int f, int t, int c, int blocks, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = __nv_bfloat16;
    return ws::inv_stage<B>(
        static_cast<const B*>(x), static_cast<const B*>(w1), s1, t1,
        static_cast<const B*>(wdw), s2, t2, static_cast<const B*>(w2), s3,
        t3, static_cast<B*>(h), static_cast<B*>(g), static_cast<B*>(out), b,
        f, t, c, blocks, s);
  }
  return ws::inv_stage<float>(
      static_cast<const float*>(x), static_cast<const float*>(w1), s1, t1,
      static_cast<const float*>(wdw), s2, t2, static_cast<const float*>(w2),
      s3, t3, static_cast<float*>(h), static_cast<float*>(g),
      static_cast<float*>(out), b, f, t, c, blocks, s);
}
