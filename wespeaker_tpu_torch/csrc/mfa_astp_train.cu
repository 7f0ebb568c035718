// ECAPA's MFA conv + attentive statistics pooling tail for training: the
// forward that also emits the residuals of its backward, and the backward.
// See wespeaker_tpu_torch/ops/mfa_astp_vjp.py for the math.
//
// Replaces the Pallas kernels of wespeaker_tpu/ops/mfa_astp_vjp.py:
//   forward  `_fwd_values` (pallas_call at :166; `_train_kernel`,
//            `_tail_math_aux`);
//   backward `_bwd_pallas` (pallas_call at :350; `_bwd_kernel`).
//
// Bound on an H100 at B=256, T=200, C=512, D=1536, A=128, bf16 (989
// TFLOP/s, 3.35 TB/s): the forward is ~282 GFLOP (MFA 241.6, attention and
// logits 20.1 each), ~0.29 ms; the backward ~584 GFLOP (dx and dwm 241.6
// each, five products of 20.1), ~0.59 ms. Both are bound by operations:
// the bytes are ~0.33 GB and ~0.5 GB, 0.10-0.15 ms.
//
// Design. The TPU kernels held a batch tile of h (T, D) in VMEM and summed
// the weight gradients in accumulators resident across a sequential grid.
// Here blocks run in no order and h is 600 KB per utterance, so each
// kernel is a sequence of launches with intermediates in device memory:
//
// forward (ws_mfa_astp_train_fwd): the chain of mfa_astp_fwd.cuh, shared
//   with inference (in bf16 its four products on gemm_sm90, TMA + wgmma),
//   keeping h and att in the I/O type and the f32 context stats as the
//   backward's residuals;
// backward (ws_mfa_astp_train_bwd), given g = dL/dpooled:
//   1. logits recomputed from att (cheaper than keeping them: 315 MB f32);
//   2. per (utterance, channel), three passes over T: the softmax weights
//      w, then dlogits = w (dw - sum_T w dw) (rounded to the I/O type) and
//      dh_pool = w (gm_eff + 2 gv h), written over the logits;
//   3. datt = dlogits @ k2^T (f32);
//   4. dpre = datt (1 - att^2), rounded; dctx = sum_T dpre in f32;
//   5. (glob) [dcmean | dcstd] = dctx @ [k1m^T | k1s^T];
//   6. dh_att = dpre @ k1x^T (f32);
//   7. dacc = [h > 0] (dh_att + dh_pool + dh_ctx), rounded; per-utterance
//      f32 sums of dacc, then 8. dbm = their sum over the batch;
//   9. dx_i = dacc @ wm_i^T for i = 2, 3, 4 (three outputs);
//  10-12. the weight gradients dwm_i = x_i^T dacc, dk2 = att^T dlogits,
//      dk1x = h^T dpre as A^T B products over K = B*T rows, split-K with a
//      fixed-order second pass (common.cuh gemm_tn): their 12 to 48 output
//      tiles alone would leave most of the 132 SMs idle.
// The transposed weights (k2^T, k1x^T, [k1m|k1s]^T, wm_i^T) are made once
// per call by the wrapper. The backward's GEMMs run on WMMA for bf16 and
// CUDA-core FMA for exact f32. The backward on gemm_sm90 and keeping h and
// the logits on chip are later work.

#include "mfa_astp_fwd.cuh"

namespace ws {

// Backward of the weighted stats and the softmax over T, one thread per
// (utterance, channel). With var = std^2, gv = dL/dvar and gm_eff =
// dL/dmean - 2 gv mean, the gradient of the weights is dw = gm_eff h +
// gv h^2. Writes dlogits = w (dw - sum_T w dw) rounded to T into dl, and
// dh_pool = w (gm_eff + 2 gv h) over the logits.
template <typename T>
__global__ void softmax_bwd_kernel(float* __restrict__ logits,
                                   const T* __restrict__ h,
                                   const float* __restrict__ pooled,
                                   const float* __restrict__ g,
                                   T* __restrict__ dl, int t, int d) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const size_t r = (size_t)b * 2 * d + col;
  const float mean = pooled[r], sd = pooled[r + d];
  const float gm = g[r], gs = g[r + d];
  const float gv = sd * sd > 1e-7f ? gs * 0.5f / fmaxf(sd, 1e-12f) : 0.f;
  const float gme = gm - 2.f * gv * mean;
  float* lb = logits + (size_t)b * t * d + col;
  const T* hb = h + (size_t)b * t * d + col;
  T* db = dl + (size_t)b * t * d + col;
  float mx = -3.0e38f;
  for (int i = 0; i < t; ++i) mx = fmaxf(mx, lb[(size_t)i * d]);
  float s = 0.f, sw = 0.f;
  for (int i = 0; i < t; ++i) {
    const float e = expf(lb[(size_t)i * d] - mx);
    const float hv = to_f(hb[(size_t)i * d]);
    s += e;
    sw += e * (gme * hv + gv * hv * hv);
  }
  const float inv = 1.f / s;
  const float wdw = sw * inv;  // sum_T w dw
  for (int i = 0; i < t; ++i) {
    const size_t o = (size_t)i * d;
    const float w = expf(lb[o] - mx) * inv;
    const float hv = to_f(hb[o]);
    const float dw = gme * hv + gv * hv * hv;
    db[o] = from_f<T>(w * (dw - wdw));
    lb[o] = w * (gme + 2.f * gv * hv);
  }
}

// dpre = datt (1 - att^2) rounded to T, and dctx = sum_T dpre in f32 (and
// rounded to T for the context GEMM), one thread per (utterance, column).
template <typename T>
__global__ void dpre_kernel(const float* __restrict__ datt,
                            const T* __restrict__ att, T* __restrict__ dp,
                            float* __restrict__ dctx, T* __restrict__ dctx_io,
                            int t, int a) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a) return;
  const size_t base = (size_t)b * t * a + col;
  float s = 0.f;
  for (int i = 0; i < t; ++i) {
    const size_t o = base + (size_t)i * a;
    const float av = to_f(att[o]);
    const float v = datt[o] * (1.f - av * av);
    dp[o] = from_f<T>(v);
    s += v;
  }
  dctx[(size_t)b * a + col] = s;
  dctx_io[(size_t)b * a + col] = from_f<T>(s);
}

// dacc = [h > 0] (dh_att + dh_pool + dh_ctx) rounded to T, with (glob,
// dcms non-null) dh_ctx = 2/(T-1) (h - cmean) dcstd 0.5/cstd + dcmean/T;
// and the f32 sum over T of dacc per (utterance, channel).
template <typename T>
__global__ void dacc_kernel(const float* __restrict__ dh_att,
                            const float* __restrict__ dh_pool,
                            const T* __restrict__ h,
                            const float* __restrict__ cstats,
                            const float* __restrict__ dcms,
                            T* __restrict__ da, float* __restrict__ dbm_part,
                            int t, int d) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float cm = 0.f, k = 0.f, dcm_t = 0.f;
  if (dcms) {
    const size_t r = (size_t)b * 2 * d + col;
    cm = cstats[r];
    const float dcvar = dcms[r + d] * 0.5f / cstats[r + d];
    k = 2.f / fmaxf((float)t - 1.f, 1.f) * dcvar;
    dcm_t = dcms[r] / (float)t;
  }
  const size_t base = (size_t)b * t * d + col;
  float s = 0.f;
  for (int i = 0; i < t; ++i) {
    const size_t o = base + (size_t)i * d;
    const float hv = to_f(h[o]);
    float v = dh_att[o] + dh_pool[o];
    if (dcms) v += (hv - cm) * k + dcm_t;
    v = hv > 0.f ? v : 0.f;
    da[o] = from_f<T>(v);
    s += v;
  }
  dbm_part[(size_t)b * d + col] = s;
}

struct BwdArgs {
  // residuals of the forward and the incoming gradient
  const void *x2, *x3, *x4, *h, *att;
  const float *pooled, *cstats, *g;
  // weights in the I/O type: k2 (a, d), k2t (d, a), k1xt (a, d),
  // k1mst (a, 2d) or null, wmt[i] (d, c); b2 (d) f32
  const void *k2, *k2t, *k1xt, *k1mst, *wmt2, *wmt3, *wmt4;
  const float* b2;
  // outputs
  void *dx2, *dx3, *dx4;
  float *dwm, *dbm, *dk1x, *dctx, *dk2;
  // scratch
  float* logits;   // (b, t, d) f32, then dh_pool
  void* dl;        // (b, t, d) io
  float* datt;     // (b, t, a) f32
  void* dp;        // (b, t, a) io
  void* dctx_io;   // (b, a) io
  float* dcms;     // (b, 2d) f32, glob only
  float* dh;       // (b, t, d) f32
  void* da;        // (b, t, d) io
  float* dbm_part; // (b, d) f32
  float* work;     // split-K workspace
  size_t work_elems;
};

template <typename T>
cudaError_t train_bwd(const BwdArgs& q, int b, int t, int c, int d, int a,
                      int glob, cudaStream_t stream) {
  const int m = b * t;
  const dim3 grid_d((d + 127) / 128, b), grid_a((a + 127) / 128, b);
  cudaError_t err;
  // 1. logits
  GemmArgs p = gemm_args(q.att, nullptr, nullptr, 1, a, q.k2, q.logits, m, d,
                         kNone);
  p.bias = q.b2;
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 2. dlogits, dh_pool
  softmax_bwd_kernel<T><<<grid_d, 128, 0, stream>>>(
      q.logits, static_cast<const T*>(q.h), q.pooled, q.g,
      static_cast<T*>(q.dl), t, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 3. datt
  p = gemm_args(q.dl, nullptr, nullptr, 1, d, q.k2t, q.datt, m, a, kNone);
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 4. dpre, dctx
  dpre_kernel<T><<<grid_a, 128, 0, stream>>>(
      q.datt, static_cast<const T*>(q.att), static_cast<T*>(q.dp), q.dctx,
      static_cast<T*>(q.dctx_io), t, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5. [dcmean | dcstd]
  if (glob) {
    p = gemm_args(q.dctx_io, nullptr, nullptr, 1, a, q.k1mst, q.dcms, b,
                  2 * d, kNone);
    if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  }
  // 6. dh_att
  p = gemm_args(q.dp, nullptr, nullptr, 1, a, q.k1xt, q.dh, m, d, kNone);
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 7. dacc and its per-utterance sums, 8. dbm
  dacc_kernel<T><<<grid_d, 128, 0, stream>>>(
      q.dh, q.logits, static_cast<const T*>(q.h), q.cstats,
      glob ? q.dcms : nullptr, static_cast<T*>(q.da), q.dbm_part, t, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = col_sum(q.dbm_part, q.dbm, b, d, stream)) != cudaSuccess)
    return err;
  // 9. dx_i, 10. dwm_i
  const void* xs[3] = {q.x2, q.x3, q.x4};
  const void* wmt[3] = {q.wmt2, q.wmt3, q.wmt4};
  void* dxs[3] = {q.dx2, q.dx3, q.dx4};
  for (int i = 0; i < 3; ++i) {
    p = gemm_args(q.da, nullptr, nullptr, 1, d, wmt[i], dxs[i], m, c, kNone);
    if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
    if ((err = gemm_tn<T>(xs[i], q.da, q.dwm + (size_t)i * c * d, c, d, m,
                          q.work, q.work_elems, stream)) != cudaSuccess)
      return err;
  }
  // 11. dk2, 12. dk1x
  if ((err = gemm_tn<T>(q.att, q.dl, q.dk2, a, d, m, q.work, q.work_elems,
                        stream)) != cudaSuccess)
    return err;
  return gemm_tn<T>(q.h, q.dp, q.dk1x, d, a, m, q.work, q.work_elems, stream);
}

}  // namespace ws

// The weights as mfa_astp_fwd.cuh's TailFwd takes them for the type (see
// ws_mfa_astp); aff is (3, D): bm, then ones and zeros.
extern "C" int ws_mfa_astp_train_fwd(
    const void* x2, const void* x3, const void* x4, const void* wm,
    const float* aff, const void* k1x, int ldk1, const void* k1ms,
    const float* b1, const void* k2, const float* b2, void* h, void* att,
    float* cstats, void* cstats_io, float* ctx, float* logits, float* pooled,
    int b, int t, int c, int d, int a, int glob, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::tail_fwd(ws::tail_fwd_args<__nv_bfloat16>(
                            x2, x3, x4, nullptr, wm, aff, k1x, ldk1, k1ms, b1,
                            k2, b2, h, cstats_io, cstats, ctx, att, logits,
                            pooled, b, t, c, d, a, glob),
                        s);
  return ws::tail_fwd(ws::tail_fwd_args<float>(
                          x2, x3, x4, nullptr, wm, aff, k1x, ldk1, k1ms, b1,
                          k2, b2, h, cstats_io, cstats, ctx, att, logits,
                          pooled, b, t, c, d, a, glob),
                      s);
}

// f32 elements of split-K workspace the backward needs.
extern "C" long long ws_mfa_astp_train_bwd_workspace(int b, int t, int c,
                                                     int d, int a) {
  const int m = b * t;
  size_t n = ws::gemm_tn_workspace(c, d, m);
  const size_t n2 = ws::gemm_tn_workspace(a, d, m);
  const size_t n3 = ws::gemm_tn_workspace(d, a, m);
  if (n2 > n) n = n2;
  if (n3 > n) n = n3;
  return (long long)n;
}

extern "C" int ws_mfa_astp_train_bwd(
    const void* x2, const void* x3, const void* x4, const void* h,
    const void* att, const float* pooled, const float* cstats, const float* g,
    const void* k2, const void* k2t, const void* k1xt, const void* k1mst,
    const void* wmt2, const void* wmt3, const void* wmt4, const float* b2,
    void* dx2, void* dx3, void* dx4, float* dwm, float* dbm, float* dk1x,
    float* dctx, float* dk2, float* logits, void* dl, float* datt, void* dp,
    void* dctx_io, float* dcms, float* dh, void* da, float* dbm_part,
    float* wsp, long long ws_elems, int b, int t, int c, int d, int a,
    int glob, int bf16, void* stream) {
  ws::BwdArgs q{x2, x3, x4, h, att, pooled, cstats, g,
                k2, k2t, k1xt, k1mst, wmt2, wmt3, wmt4, b2,
                dx2, dx3, dx4, dwm, dbm, dk1x, dctx, dk2,
                logits, dl, datt, dp, dctx_io, dcms, dh, da, dbm_part,
                wsp, (size_t)ws_elems};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return ws::train_bwd<__nv_bfloat16>(q, b, t, c, d, a, glob, s);
  return ws::train_bwd<float>(q, b, t, c, d, a, glob, s);
}
