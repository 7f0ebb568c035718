// The ECAPA SE-Res2 block for inference, BN folded (see
// wespeaker_tpu_torch/ops/se_block.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/se_block_pallas.py::fused_se_res2_block.
//
// C interface: ws_se_res2_block(...) issues, on the given stream,
//   pointwise GEMM -> Res2 chain -> pointwise GEMM -> SE squeeze ->
//   excitation GEMMs -> residual
// and returns the first CUDA error (0 on success). ws_res2_chain(...) issues
// the Res2 chain alone (ops/res2_chain.py; the Pallas kernel
// wespeaker_tpu/ops/res2_pallas.py::fused_res2_chain).

#include "common.cuh"

namespace ws {

// Res2 chain: one block per utterance walks the `nums` steps in order. Step
// s reads sp = y[group s-1] + h1[group s] (h1[group 0] at s = 0), rounded to
// T as the JAX kernel rounds it, over T tiles of kTT rows plus a halo of d
// rows on each side, and writes y[group s] = bn(relu(conv_k3_d(sp))). The
// step's (3, W, W) weights and the tile live in shared memory as f32. A
// __syncthreads() between steps makes the previous step's writes to y,
// including the halo rows other threads wrote, visible to the whole block.
// Each thread computes kRpt rows x 4 columns of the tile.
template <typename T, int W>
__global__ void __launch_bounds__(256)
    res2_chain_kernel(const T* __restrict__ h1, T* __restrict__ y,
                      const T* __restrict__ cw, const float* __restrict__ caff,
                      int t, int c, int nums, int d) {
  constexpr int kCg = W / 4;      // column groups of 4
  constexpr int kRg = 256 / kCg;  // row groups
  constexpr int kRpt = 4;         // rows per thread
  constexpr int kTT = kRg * kRpt;  // tile rows: 64 (W=64) or 32 (W=128)
  constexpr int kLd = W + 1;       // padded row: no bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // (3, W, W)
  float* sps = smem + 3 * W * W;  // (kTT + 2d, kLd)
  const int tid = threadIdx.x;
  const int cg = tid % kCg, rg = tid / kCg;
  const size_t base = (size_t)blockIdx.x * t * c;

  // passthrough group: y[..., nums*W:] = h1[..., nums*W:]
  for (int i = tid; i < t * W; i += 256) {
    const size_t off = base + (size_t)(i / W) * c + nums * W + i % W;
    y[off] = h1[off];
  }
  for (int s = 0; s < nums; ++s) {
    __syncthreads();
    for (int i = tid; i < 3 * W * W; i += 256)
      ws[i] = to_f(cw[(size_t)s * 3 * W * W + i]);
    const float* bias = caff + s * W;
    const float* scale = caff + (nums + s) * W;
    const float* shift = caff + (2 * nums + s) * W;
    for (int t0 = 0; t0 < t; t0 += kTT) {
      __syncthreads();
      const int rows = kTT + 2 * d;
      for (int i = tid; i < rows * W; i += 256) {
        const int r = i / W, col = i % W;
        const int tt = t0 - d + r;
        float v = 0.f;
        if (tt >= 0 && tt < t) {
          const size_t off = base + (size_t)tt * c;
          const float hv = to_f(h1[off + s * W + col]);
          v = s == 0 ? hv
                     : to_f(from_f<T>(to_f(y[off + (s - 1) * W + col]) + hv));
        }
        sps[r * kLd + col] = v;
      }
      __syncthreads();
      float acc[kRpt][4];
#pragma unroll
      for (int q = 0; q < kRpt; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
      for (int k = 0; k < 3; ++k) {
        const float* wk = ws + k * W * W + cg * 4;
        // tap k reads frame t + (k - 1) d: tile row r + k d of sps
        const float* spk = sps + (k * d + rg * kRpt) * kLd;
#pragma unroll 8
        for (int j = 0; j < W; ++j) {
          const float4 wv = *reinterpret_cast<const float4*>(wk + j * W);
#pragma unroll
          for (int q = 0; q < kRpt; ++q) {
            const float a = spk[q * kLd + j];
            acc[q][0] = fmaf(a, wv.x, acc[q][0]);
            acc[q][1] = fmaf(a, wv.y, acc[q][1]);
            acc[q][2] = fmaf(a, wv.z, acc[q][2]);
            acc[q][3] = fmaf(a, wv.w, acc[q][3]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRpt; ++q) {
        const int tt = t0 + rg * kRpt + q;
        if (tt >= t) continue;
        T* yo = y + base + (size_t)tt * c + s * W + cg * 4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = cg * 4 + e;
          const float v = fmaxf(acc[q][e] + bias[col], 0.f) * scale[col] +
                          shift[col];
          yo[e] = from_f<T>(v);
        }
      }
    }
  }
}

template <typename T, int W>
cudaError_t res2_chain(const T* h1, T* y, const T* cw, const float* caff,
                       int b, int t, int c, int nums, int d,
                       cudaStream_t stream) {
  constexpr int kTT = (256 / (W / 4)) * 4;
  const size_t smem = (size_t)(3 * W * W + (kTT + 2 * d) * (W + 1)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      res2_chain_kernel<T, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  res2_chain_kernel<T, W><<<b, 256, smem, stream>>>(h1, y, cw, caff, t, c,
                                                     nums, d);
  return cudaGetLastError();
}

// The chain at a group width of 64 or 128 (the widths it is compiled for).
template <typename T>
cudaError_t res2_chain_any(const T* h1, T* y, const T* cw, const float* caff,
                           int b, int t, int c, int width, int nums, int d,
                           cudaStream_t stream) {
  if (width == 64)
    return res2_chain<T, 64>(h1, y, cw, caff, b, t, c, nums, d, stream);
  if (width == 128)
    return res2_chain<T, 128>(h1, y, cw, caff, b, t, c, nums, d, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
__global__ void se_residual_kernel(const T* __restrict__ x,
                                   const T* __restrict__ h2,
                                   const float* __restrict__ g,
                                   T* __restrict__ out, size_t total,
                                   size_t tc, int c) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const float gv = g[(i / tc) * c + i % c];
    out[i] = from_f<T>(to_f(x[i]) + to_f(h2[i]) * gv);
  }
}

template <typename T>
cudaError_t se_block(const void* x, const float* mask, const void* w1,
                     const float* aff1, const void* cw, const float* caff,
                     const void* w2, const float* aff2, const void* sw1,
                     const float* sb1, const void* sw2, const float* sb2,
                     void* h1, void* y, void* h2, void* mean, void* z,
                     float* g, void* out, int b, int t, int c, int width,
                     int nums, int cb, int d, cudaStream_t stream) {
  const int m = b * t;
  cudaError_t err;
  // 1. h1 = bn1(relu(x @ w1 + b1)); aff rows are [bias, scale, shift]
  GemmArgs p = gemm_args(x, nullptr, nullptr, 1, c, w1, h1, m, c, kRelu);
  p.bias = aff1;
  p.scale = aff1 + c;
  p.shift = aff1 + 2 * c;
  if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
  // 2. Res2 chain
  if ((err = res2_chain_any<T>(static_cast<const T*>(h1), static_cast<T*>(y),
                               static_cast<const T*>(cw), caff, b, t, c,
                               width, nums, d, stream)) != cudaSuccess)
    return err;
  // 3. h2 = bn2(relu(y @ w2 + b2))
  p = gemm_args(y, nullptr, nullptr, 1, c, w2, h2, m, c, kRelu);
  p.bias = aff2;
  p.scale = aff2 + c;
  p.shift = aff2 + 2 * c;
  if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
  // 4. squeeze: masked mean of h2 over T, in T
  if ((err = col_stats<T>(static_cast<const T*>(h2), mask,
                          static_cast<T*>(mean), nullptr, b, t, c,
                          stream)) != cudaSuccess)
    return err;
  // 5./6. excitation: z = relu(mean @ sw1 + sb1) in T;
  //       g = sigmoid(z @ sw2 + sb2) in f32
  p = gemm_args(mean, nullptr, nullptr, 1, c, sw1, z, b, cb, kRelu);
  p.bias = sb1;
  if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
  p = gemm_args(z, nullptr, nullptr, 1, cb, sw2, g, b, c, kSigmoid);
  p.bias = sb2;
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 7. out = x + h2 * g
  const size_t total = (size_t)m * c;
  const int blocks = (int)((total + 255) / 256 < 65536 ? (total + 255) / 256
                                                       : 65536);
  se_residual_kernel<T><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(h2), g,
      static_cast<T*>(out), total, (size_t)t * c, c);
  return cudaGetLastError();
}

}  // namespace ws

extern "C" int ws_se_res2_block(
    const void* x, const float* mask, const void* w1, const float* aff1,
    const void* cw, const float* caff, const void* w2, const float* aff2,
    const void* sw1, const float* sb1, const void* sw2, const float* sb2,
    void* h1, void* y, void* h2, void* mean, void* z, float* g, void* out,
    int b, int t, int c, int width, int nums, int cb, int dilation, int bf16,
    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::se_block<__nv_bfloat16>(x, mask, w1, aff1, cw, caff, w2, aff2,
                                       sw1, sb1, sw2, sb2, h1, y, h2, mean, z,
                                       g, out, b, t, c, width, nums, cb,
                                       dilation, s);
  return ws::se_block<float>(x, mask, w1, aff1, cw, caff, w2, aff2, sw1, sb1,
                             sw2, sb2, h1, y, h2, mean, z, g, out, b, t, c,
                             width, nums, cb, dilation, s);
}

// The Res2 chain alone (the JAX package's fused_res2_chain): y (b, t, c) =
// the nums chain outputs of width `width` and the passthrough group of x.
extern "C" int ws_res2_chain(const void* x, const void* cw, const float* caff,
                             void* y, int b, int t, int c, int width,
                             int nums, int dilation, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c != (nums + 1) * width) return cudaErrorInvalidValue;
  if (bf16) {
    using T = __nv_bfloat16;
    return ws::res2_chain_any<T>(static_cast<const T*>(x), static_cast<T*>(y),
                                 static_cast<const T*>(cw), caff, b, t, c,
                                 width, nums, dilation, s);
  }
  return ws::res2_chain_any<float>(static_cast<const float*>(x),
                                   static_cast<float*>(y),
                                   static_cast<const float*>(cw), caff, b, t,
                                   c, width, nums, dilation, s);
}
