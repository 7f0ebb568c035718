// A whole CAM++ dense TDNN block for inference, BN folded (see
// wespeaker_tpu_torch/ops/cam_block.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/cam_block_pallas.py::fused_cam_dense_block.
//
// C interface: ws_cam_dense_block(...) copies x into the first C0 channels
// of the dense map `out` (B, T, C_end) and issues, on the given stream, for
// each layer i
//   bottleneck GEMM (BN1-relu prologue, BN2-relu epilogue) -> h
//   -> context means and the CAM gate per segment -> gate
//   -> k=3 dilated conv of h times the gate -> out[..., ci:ci+32]
// and returns the first CUDA error (0 on success).

#include "common.cuh"

namespace ws {

constexpr int kBn = 128;     // bottleneck width
constexpr int kHid = 64;     // CAM gate hidden width (bottleneck / 2)
constexpr int kGrowth = 32;  // channels each layer appends
constexpr int kTile = 64;    // frames per conv block

// One block per utterance, one thread per bottleneck channel. Pass 1: the
// masked f32 sum of h over T and its count. Pass 2, per segment of seg_len
// frames: the segment's masked mean, ctx = gmean + segmean rounded to T, the
// hidden layer relu(ctx @ wc1 + bc1) rounded to T, and the gate
// sigmoid(hidden @ wc2 + bc2) in f32 into gate[b, s, :]. Every frame of a
// segment has the same ctx, so the gate per segment is the gate per frame.
template <typename T>
__global__ void __launch_bounds__(kBn)
    cam_context_gate_kernel(const T* __restrict__ h,
                            const float* __restrict__ mask,
                            const T* __restrict__ wc1,
                            const float* __restrict__ bc1,
                            const T* __restrict__ wc2,
                            const float* __restrict__ bc2,
                            float* __restrict__ gate, int t, int seg_len,
                            int nseg) {
  __shared__ float ctx_s[kBn];
  __shared__ float hid_s[kHid];
  const int b = blockIdx.x, j = threadIdx.x;
  const T* hb = h + (size_t)b * t * kBn + j;
  const float* mb = mask ? mask + (size_t)b * t : nullptr;
  float s = 0.f, cnt = 0.f;
  for (int i = 0; i < t; ++i) {
    const float m = mb ? mb[i] : 1.f;
    s += to_f(hb[(size_t)i * kBn]) * m;
    cnt += m;
  }
  const float gmean = s / fmaxf(cnt, 1.f);
  for (int sg = 0; sg < nseg; ++sg) {
    const int lo = sg * seg_len, hi = min(t, lo + seg_len);
    float ss = 0.f, sc = 0.f;
    for (int i = lo; i < hi; ++i) {
      const float m = mb ? mb[i] : 1.f;
      ss += to_f(hb[(size_t)i * kBn]) * m;
      sc += m;
    }
    ctx_s[j] = to_f(from_f<T>(gmean + ss / fmaxf(sc, 1.f)));
    __syncthreads();
    if (j < kHid) {
      float a = bc1[j];
      for (int k = 0; k < kBn; ++k)
        a = fmaf(ctx_s[k], to_f(wc1[k * kHid + j]), a);
      hid_s[j] = to_f(from_f<T>(fmaxf(a, 0.f)));
    }
    __syncthreads();
    if (j < kGrowth) {
      float a = bc2[j];
      for (int k = 0; k < kHid; ++k)
        a = fmaf(hid_s[k], to_f(wc2[k * kGrowth + j]), a);
      gate[((size_t)b * nseg + sg) * kGrowth + j] = 1.f / (1.f + expf(-a));
    }
    __syncthreads();  // ctx_s and hid_s are rewritten by the next segment
  }
}

// ---- the k=3 dilated conv times the gate ----
//
// Block (tile, b): frames t0 = tile * kTile .. t0 + kTile of utterance b.
// Shared memory holds h for frames t0 - d .. t0 + kTile + d (zeros beyond
// the utterance's ends: the conv's zero padding) and the layer's (3, 128,
// 32) taps; output row r, tap k reads tile row r + k d. The f32 sum over
// the three taps is multiplied by gate[b, frame / seg_len] and rounded into
// out[b, frame, ci:ci+32] (row stride cend).

constexpr int kHLd = kBn + 16;       // bf16 row of the h tile: 288 bytes,
                                     // so every row start is 32-byte aligned
constexpr int kWLd = kGrowth + 8;    // bf16 row of the taps

// bf16 on the tensor cores: 4 warps, each 16 output frames x 32 channels.
__global__ void __launch_bounds__(128)
    cam_tap_conv_wmma_kernel(const __nv_bfloat16* __restrict__ h,
                             const __nv_bfloat16* __restrict__ w2,
                             const float* __restrict__ gate,
                             __nv_bfloat16* __restrict__ out, int t, int cend,
                             int ci, int d, int seg_len, int nseg) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* cs = reinterpret_cast<float*>(ws + 3 * kBn * kWLd);  // (4, 16*32)
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(cs + 4 * 16 * 32);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int rows = kTile + 2 * d;

  // taps: 384 rows x 4 chunks of 8 bf16
  for (int i = tid; i < 3 * kBn * 4; i += 128) {
    const int r = i / 4, ch = i % 4;
    *reinterpret_cast<uint4*>(&ws[r * kWLd + ch * 8]) =
        *reinterpret_cast<const uint4*>(w2 + (size_t)r * kGrowth + ch * 8);
  }
  // h tile: rows x 16 chunks of 8 bf16
  for (int i = tid; i < rows * 16; i += 128) {
    const int r = i / 16, ch = i % 16;
    const int tt = t0 - d + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (tt >= 0 && tt < t)
      v = *reinterpret_cast<const uint4*>(h + ((size_t)b * t + tt) * kBn +
                                          ch * 8);
    *reinterpret_cast<uint4*>(&hs[r * kHLd + ch * 8]) = v;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat16* a = hs + (k * d + warp * 16) * kHLd;
    const __nv_bfloat16* wk = ws + k * kBn * kWLd;
#pragma unroll
    for (int kk = 0; kk < kBn; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af;
      wmma::load_matrix_sync(af, a + kk, kHLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, wk + kk * kWLd + j * 16, kWLd);
        wmma::mma_sync(acc[j], af, bf, acc[j]);
      }
    }
  }
  float* c = cs + warp * 16 * 32;
  wmma::store_matrix_sync(c, acc[0], 32, wmma::mem_row_major);
  wmma::store_matrix_sync(c + 16, acc[1], 32, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * 32; e += 32) {
    const int tt = t0 + warp * 16 + e / 32, col = e % 32;
    if (tt >= t) continue;
    const float g = gate[((size_t)b * nseg + tt / seg_len) * kGrowth + col];
    out[((size_t)b * t + tt) * cend + ci + col] = __float2bfloat16(c[e] * g);
  }
}

// f32 on the CUDA cores (exact f32): 128 threads, each 4 frames x 4
// channels.
__global__ void __launch_bounds__(128)
    cam_tap_conv_fma_kernel(const float* __restrict__ h,
                            const float* __restrict__ w2,
                            const float* __restrict__ gate,
                            float* __restrict__ out, int t, int cend, int ci,
                            int d, int seg_len, int nseg) {
  constexpr int kLd = kBn + 1;  // padded row: no bank conflicts
  extern __shared__ __align__(16) float smem_f[];
  float* ws = smem_f;              // (3 * 128, 32)
  float* hs = smem_f + 3 * kBn * kGrowth;  // (kTile + 2d, kLd)
  const int tid = threadIdx.x;
  const int cg = tid % 8, rg = tid / 8;  // 8 groups of 4 channels, 16 of 4
                                         // frames
  const int b = blockIdx.y, t0 = blockIdx.x * kTile;
  const int rows = kTile + 2 * d;
  for (int i = tid; i < 3 * kBn * kGrowth; i += 128) ws[i] = w2[i];
  for (int i = tid; i < rows * kBn; i += 128) {
    const int r = i / kBn, col = i % kBn;
    const int tt = t0 - d + r;
    hs[r * kLd + col] =
        (tt >= 0 && tt < t) ? h[((size_t)b * t + tt) * kBn + col] : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  for (int k = 0; k < 3; ++k) {
    const float* wk = ws + k * kBn * kGrowth + cg * 4;
    const float* hk = hs + (k * d + rg * 4) * kLd;
#pragma unroll 8
    for (int j = 0; j < kBn; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(wk + j * kGrowth);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float a = hk[q * kLd + j];
        acc[q][0] = fmaf(a, wv.x, acc[q][0]);
        acc[q][1] = fmaf(a, wv.y, acc[q][1]);
        acc[q][2] = fmaf(a, wv.z, acc[q][2]);
        acc[q][3] = fmaf(a, wv.w, acc[q][3]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int tt = t0 + rg * 4 + q;
    if (tt >= t) continue;
    const float* g = gate + ((size_t)b * nseg + tt / seg_len) * kGrowth;
    float* o = out + ((size_t)b * t + tt) * cend + ci + cg * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = acc[q][e] * g[cg * 4 + e];
  }
}

inline size_t tap_conv_smem(bool bf16, int d) {
  if (bf16)
    return (size_t)3 * kBn * kWLd * 2 + 4 * 16 * 32 * 4 +
           (size_t)(kTile + 2 * d) * kHLd * 2;
  return ((size_t)3 * kBn * kGrowth + (size_t)(kTile + 2 * d) * (kBn + 1)) *
         4;
}

template <typename T>
cudaError_t tap_conv(const T* h, const T* w2, const float* gate, T* out,
                     int b, int t, int cend, int ci, int d, int seg_len,
                     int nseg, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const size_t smem = tap_conv_smem(kBf16, d);
  const dim3 grid((t + kTile - 1) / kTile, b);
  cudaError_t err;
  if constexpr (kBf16) {
    err = cudaFuncSetAttribute(cam_tap_conv_wmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    cam_tap_conv_wmma_kernel<<<grid, 128, smem, stream>>>(
        h, w2, gate, out, t, cend, ci, d, seg_len, nseg);
  } else {
    err = cudaFuncSetAttribute(cam_tap_conv_fma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    cam_tap_conv_fma_kernel<<<grid, 128, smem, stream>>>(
        h, w2, gate, out, t, cend, ci, d, seg_len, nseg);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t cam_block(const void* x, const float* mask, const float* s1,
                      const float* t1, const T* w1, const float* s2,
                      const float* t2, const T* w2, const T* wc1,
                      const float* bc1, const T* wc2, const float* bc2, T* h,
                      float* gate, T* out, int b, int t, int c0, int layers,
                      int d, int seg_len, cudaStream_t stream) {
  const int m = b * t, cend = c0 + kGrowth * layers;
  const int nseg = (t + seg_len - 1) / seg_len;
  if (c0 % 32 || layers < 1 || d < 0 || seg_len < 1 || m <= 0)
    return cudaErrorInvalidValue;
  // the dense map starts as x in its first C0 channels
  cudaError_t err = cudaMemcpy2DAsync(
      out, (size_t)cend * sizeof(T), x, (size_t)c0 * sizeof(T),
      (size_t)c0 * sizeof(T), (size_t)m, cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < layers; ++i) {
    const int ci = c0 + kGrowth * i;
    // 1. h = relu(bn2(relu(bn1(out[..., :ci])) @ w1[i, :ci])), in T
    GemmArgs p = gemm_args(out, nullptr, nullptr, 1, ci,
                           w1 + (size_t)i * cend * kBn, h, m, kBn, kRelu);
    p.lda = cend;
    p.a_scale = s1 + (size_t)i * cend;
    p.a_shift = t1 + (size_t)i * cend;
    p.bn_relu = 1;
    p.scale = s2 + (size_t)i * kBn;
    p.shift = t2 + (size_t)i * kBn;
    if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
    // 2. context means and the gate per segment
    cam_context_gate_kernel<T><<<b, kBn, 0, stream>>>(
        h, mask, wc1 + (size_t)i * kBn * kHid, bc1 + (size_t)i * kHid,
        wc2 + (size_t)i * kHid * kGrowth, bc2 + (size_t)i * kGrowth, gate, t,
        seg_len, nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // 3. y * gate into the next 32 channels
    if ((err = tap_conv<T>(h, w2 + (size_t)i * 3 * kBn * kGrowth, gate, out,
                           b, t, cend, ci, d, seg_len, nseg, stream)) !=
        cudaSuccess)
      return err;
  }
  return cudaSuccess;
}

}  // namespace ws

extern "C" int ws_cam_dense_block(const void* x, const float* mask,
                                  const float* s1, const float* t1,
                                  const void* w1, const float* s2,
                                  const float* t2, const void* w2,
                                  const void* wc1, const float* bc1,
                                  const void* wc2, const float* bc2, void* h,
                                  float* gate, void* out, int b, int t,
                                  int c0, int layers, int dilation,
                                  int seg_len, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = __nv_bfloat16;
    return ws::cam_block<B>(
        x, mask, s1, t1, static_cast<const B*>(w1), s2, t2,
        static_cast<const B*>(w2), static_cast<const B*>(wc1), bc1,
        static_cast<const B*>(wc2), bc2, static_cast<B*>(h), gate,
        static_cast<B*>(out), b, t, c0, layers, dilation, seg_len, s);
  }
  return ws::cam_block<float>(
      x, mask, s1, t1, static_cast<const float*>(w1), s2, t2,
      static_cast<const float*>(w2), static_cast<const float*>(wc1), bc1,
      static_cast<const float*>(wc2), bc2, static_cast<float*>(h), gate,
      static_cast<float*>(out), b, t, c0, layers, dilation, seg_len, s);
}
