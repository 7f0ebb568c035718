// Statistics pooling over T (see wespeaker_tpu_torch/ops/pooling.py for the
// math, the bound and the design). Replaces the Pallas kernels
// wespeaker_tpu/ops/pooling_pallas.py::fused_softmax_stats
// (`_softmax_stats_kernel`) and ::fused_masked_stats
// (`_masked_stats_kernel`).
//
// C interface (out is one (b, 2d) f32 buffer, [mean | std]):
//   ws_softmax_stats(logits, x, mask, out, b, t, d, logits_bf16, x_bf16,
//                    stream): softmax over T of the logits, masked frames
//                    at -1e30, then the weighted mean and
//                    sqrt(max(E[x^2] - mean^2, 1e-7));
//   ws_masked_stats(x, mask, out, b, t, d, ddof, bf16, stream): masked mean
//                    and sqrt(sum((x - mean)^2 m) / max(count - ddof, 1)
//                    + 1e-7).
// mask is a (b, t) f32 frame mask or null. Each returns the launch's CUDA
// error (0 on success).

#include "common.cuh"

namespace ws {

template <typename T, typename TL>
cudaError_t softmax_stats_entry(const void* logits, const void* x,
                                const float* mask, float* out, int b, int t,
                                int d, cudaStream_t s) {
  return softmax_stats<T, TL>(static_cast<const TL*>(logits),
                              static_cast<const T*>(x), mask, out, b, t, d,
                              s);
}

template <typename T>
cudaError_t masked_stats_entry(const void* x, const float* mask, float* out,
                               int b, int t, int d, int ddof,
                               cudaStream_t s) {
  return col_stats<T, float>(static_cast<const T*>(x), mask, out, out + d, b,
                             t, d, s, ddof, 2 * d);
}

}  // namespace ws

extern "C" int ws_softmax_stats(const void* logits, const void* x,
                                const float* mask, float* out, int b, int t,
                                int d, int logits_bf16, int x_bf16,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return logits_bf16
               ? ws::softmax_stats_entry<bf16, bf16>(logits, x, mask, out, b,
                                                     t, d, s)
               : ws::softmax_stats_entry<bf16, float>(logits, x, mask, out, b,
                                                      t, d, s);
  return logits_bf16
             ? ws::softmax_stats_entry<float, bf16>(logits, x, mask, out, b,
                                                    t, d, s)
             : ws::softmax_stats_entry<float, float>(logits, x, mask, out, b,
                                                     t, d, s);
}

extern "C" int ws_masked_stats(const void* x, const float* mask, float* out,
                               int b, int t, int d, int ddof, int bf16,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::masked_stats_entry<__nv_bfloat16>(x, mask, out, b, t, d, ddof,
                                                 s);
  return ws::masked_stats_entry<float>(x, mask, out, b, t, d, ddof, s);
}
