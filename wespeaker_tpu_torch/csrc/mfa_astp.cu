// ECAPA's MFA conv + attentive statistics pooling tail for inference (see
// wespeaker_tpu_torch/ops/mfa_astp.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/mfa_astp_pallas.py::fused_mfa_astp.
//
// C interface: ws_mfa_astp(...) issues, on the given stream, the chain of
// mfa_astp_fwd.cuh (shared with the training forward):
//   MFA GEMM over the three block outputs -> context stats -> context GEMM
//   (glob) -> attention GEMM + tanh -> logits GEMM -> softmax stats
// and returns the first CUDA error (0 on success).

#include "mfa_astp_fwd.cuh"

// The weights as mfa_astp_fwd.cuh's TailFwd takes them for the type: bf16
// K-major (wm (D, 3C); k1x (A, ldk1) with the context rows after its first
// D columns; k2 (D, A); k1ms unused), f32 (K, N) row-major (wm (3C, D), k1x
// (D, A), k1ms (2D, A), k2 (A, D)). aff is (3, D): bm, then ones and zeros
// (the MFA GEMM's affine in gemm_sm90's post form; f32 reads bm alone).
// cstats holds (B, 2D) in the I/O type.
extern "C" int ws_mfa_astp(const void* x2, const void* x3, const void* x4,
                           const float* mask, const void* wm, const float* aff,
                           const void* k1x, int ldk1, const void* k1ms,
                           const float* b1, const void* k2, const float* b2,
                           void* h, void* cstats, float* ctx, void* att,
                           float* logits, float* out, int b, int t, int c,
                           int d, int a, int glob, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::tail_fwd(ws::tail_fwd_args<__nv_bfloat16>(
                            x2, x3, x4, mask, wm, aff, k1x, ldk1, k1ms, b1,
                            k2, b2, h, cstats, nullptr, ctx, att, logits, out,
                            b, t, c, d, a, glob),
                        s);
  return ws::tail_fwd(ws::tail_fwd_args<float>(
                          x2, x3, x4, mask, wm, aff, k1x, ldk1, k1ms, b1, k2,
                          b2, h, cstats, nullptr, ctx, att, logits, out, b, t,
                          c, d, a, glob),
                      s);
}

// gemm_sm90 in the tail's forms alone (ops/gemm_sm90.py::gemm_sm90_tail):
// form 0 the post form over parts = 3 A maps a0, a1, a2 of k / 3 columns
// each at row stride lda, with bias, scale and shift; with parts = 1 form 4
// the tanh form with row_bias (m / t, n) or bias, form 5 the f32 form, acc
// + bias, into out as f32. Returns cudaErrorInvalidValue for any other
// combination or a shape gemm_sm90 does not take.
extern "C" int ws_gemm_sm90_tail(const void* a0, const void* a1,
                                 const void* a2, int lda, const void* wt,
                                 int ldw, const float* bias,
                                 const float* scale, const float* shift,
                                 const float* row_bias, void* out, int m,
                                 int n, int k, int t, int form, int parts,
                                 void* stream) {
  ws::Sm90Args p{};
  p.m = m;
  p.n = n;
  p.k = k;
  p.bias = bias;
  p.scale = scale;
  p.shift = shift;
  p.row_bias = row_bias;
  p.t = t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == ws::kFormF32 && parts == 1) {
    p.out_f32 = static_cast<float*>(out);
    return ws::gemm_sm90<ws::kFormF32>(a0, lda, wt, ldw, p, s);
  }
  p.out = static_cast<__nv_bfloat16*>(out);
  if (form == ws::kFormTanh && parts == 1)
    return ws::gemm_sm90<ws::kFormTanh>(a0, lda, wt, ldw, p, s);
  if (form == ws::kFormPost && parts == 3)
    return ws::gemm_sm90_3<ws::kFormPost>(a0, a1, a2, lda, wt, ldw, p, s);
  return cudaErrorInvalidValue;
}

// The GEMM launches this library has made, by route (common.cuh's
// GemmRoute order: gemm_sm90, gemm_tn_sm90, WMMA, FMA), into out[4].
extern "C" void ws_gemm_route_counts(long long* out) {
  for (int i = 0; i < ws::kRoutes; ++i) out[i] = ws::gemm_route_counts()[i];
}
