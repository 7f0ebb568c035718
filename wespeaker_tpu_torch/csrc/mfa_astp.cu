// ECAPA's MFA conv + attentive statistics pooling tail for inference (see
// wespeaker_tpu_torch/ops/mfa_astp.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/mfa_astp_pallas.py::fused_mfa_astp.
//
// C interface: ws_mfa_astp(...) issues, on the given stream,
//   MFA GEMM over the three block outputs -> context stats -> context GEMM
//   (glob) -> attention GEMM + tanh -> logits GEMM -> softmax stats
// and returns the first CUDA error (0 on success).

#include "common.cuh"

namespace ws {

template <typename T>
cudaError_t mfa_astp(const void* x2, const void* x3, const void* x4,
                     const float* mask, const void* wm, const float* bm,
                     const void* k1x, const void* k1ms, const float* b1,
                     const void* k2, const float* b2, void* h, void* cstats,
                     float* ctx, void* att, float* logits, float* out, int b,
                     int t, int c, int d, int a, int glob,
                     cudaStream_t stream) {
  const int m = b * t;
  cudaError_t err;
  // 1. h = relu(x2 @ wm[:C] + x3 @ wm[C:2C] + x4 @ wm[2C:] + bm), in T
  GemmArgs p = gemm_args(x2, x3, x4, 3, c, wm, h, m, d, kRelu);
  p.bias = bm;
  if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
  // 4. (prepared) tanh(h @ k1x + bias) with bias b1, or the per-utterance
  //    context bias
  GemmArgs att_p = gemm_args(h, nullptr, nullptr, 1, d, k1x, att, m, a,
                             kTanh);
  if (glob) {
    // 2. context mean and unbiased std of h over valid T, in T
    T* cmean = static_cast<T*>(cstats);
    T* cstd = cmean + (size_t)b * d;
    if ((err = col_stats<T>(static_cast<const T*>(h), mask, cmean, cstd, b,
                            t, d, stream)) != cudaSuccess)
      return err;
    // 3. ctx = cmean @ k1[D:2D] + cstd @ k1[2D:] + b1, in f32
    p = gemm_args(cmean, cstd, nullptr, 2, d, k1ms, ctx, b, a, kNone);
    p.bias = b1;
    if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
    att_p.row_bias = ctx;
    att_p.rows_per_group = t;
  } else {
    att_p.bias = b1;
  }
  if ((err = gemm<T, T>(att_p, stream)) != cudaSuccess) return err;
  // 5. logits = att @ k2 + b2, in f32
  p = gemm_args(att, nullptr, nullptr, 1, a, k2, logits, m, d, kNone);
  p.bias = b2;
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 6. softmax over T and weighted stats
  return softmax_stats<T>(logits, static_cast<const T*>(h), mask, out, b, t,
                          d, stream);
}

}  // namespace ws

extern "C" int ws_mfa_astp(const void* x2, const void* x3, const void* x4,
                           const float* mask, const void* wm, const float* bm,
                           const void* k1x, const void* k1ms, const float* b1,
                           const void* k2, const float* b2, void* h,
                           void* cstats, float* ctx, void* att, float* logits,
                           float* out, int b, int t, int c, int d, int a,
                           int glob, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::mfa_astp<__nv_bfloat16>(x2, x3, x4, mask, wm, bm, k1x, k1ms,
                                       b1, k2, b2, h, cstats, ctx, att,
                                       logits, out, b, t, c, d, a, glob, s);
  return ws::mfa_astp<float>(x2, x3, x4, mask, wm, bm, k1x, k1ms, b1, k2, b2,
                             h, cstats, ctx, att, logits, out, b, t, c, d, a,
                             glob, s);
}
