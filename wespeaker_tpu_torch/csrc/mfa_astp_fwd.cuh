// The forward chain of ECAPA's MFA conv + attentive statistics pooling
// tail, shared by inference (mfa_astp.cu, `ws_mfa_astp`: the Pallas kernel
// wespeaker_tpu/ops/mfa_astp_pallas.py::fused_mfa_astp) and the training
// forward (mfa_astp_train.cu, `ws_mfa_astp_train_fwd`: the Pallas kernel
// wespeaker_tpu/ops/mfa_astp_vjp.py::_fwd_values). Per call:
//
//   1. h = relu(x2 wm2 + x3 wm3 + x4 wm4 + bm), stored in T (the concat
//      never exists: three K-slices of one product);
//   2. (glob) the context mean and unbiased std of h over T, + 1e-7 under
//      the root: inference over the valid frames (col_stats with the mask),
//      training in f32 (the residual its backward reads) plus a copy in T
//      (ctx_stats_kernel); both rounded to T as [mean | std] (b, 2d);
//   3. (glob) ctx = [cmean | cstd] @ [k1m; k1s] + b1, f32: (b, 2d) x (2d, a),
//      0.4 GFLOP at B=512;
//   4. att = tanh(h @ k1x + ctx), or + b1 without the context, stored in T;
//   5. logits = att @ k2 + b2, f32;
//   6. softmax over T (masked frames at -1e30) and the weighted mean and
//      std: common.cuh's softmax_stats -> pooled (b, 2d) f32.
// The rounding points are the JAX kernel's and the plain `_tail_math`'s
// (ops/mfa_astp.py): h and att in T, the context stats rounded before
// their product, the logits in f32, every product accumulated in f32.
//
// bf16 runs the four products on gemm_sm90 (TMA + wgmma): the MFA conv
// with three A maps in the post form, scale 1 and shift 0 (relu(v) * 1 + 0
// is exact in f32); the context product in the f32 form, W the context
// columns of the same K-major k1 (common.cuh's WMMA GEMM, one CTA per 128
// utterances, took 0.146 ms for it at B=512 on an H100); att in the tanh
// form with the per-utterance row bias; the logits in the f32 form. f32
// runs them on common.cuh's CUDA-core FMA GEMM, exact f32 (TF32 would miss
// 1e-4), chosen by the type at compile time.
//
// Bound at B=512, T=200, C=512, D=1536, A=128 on an H100 (989 TFLOP/s
// bf16, 3.35 TB/s): the products are 564 GFLOP, 0.57 ms. The floor of this
// chain, the sum of each launch's own bound: the MFA GEMM 0.489 ms
// (operations), the context stats 0.094 (read h, 315 MB), the tanh GEMM
// 0.102 (read h, write att), the logits GEMM 0.196 (write 629 MB of f32
// logits), softmax_stats 0.282 (read the logits and h): ~1.17 ms
// (bin/kernel_bounds.py::mfa_astp_tail_floor). What this leaves: the f32
// logits' round trip through device memory (1.26 GB, ~0.38 ms of that
// floor) and the context stats' second read of h.

#pragma once

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace ws {

// Context statistics of h over T per (utterance, channel): mean and
// sqrt(sum (h - mean)^2 / max(T - 1, 1) + 1e-7), in f32 (cstats, the
// residual the backward reads) and rounded to T (cstats_io, the operand of
// the context GEMM). Both (b, 2d) as [mean | std].
template <typename T>
__global__ void ctx_stats_kernel(const T* __restrict__ h,
                                 float* __restrict__ cstats,
                                 T* __restrict__ cstats_io, int t, int d) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  const T* hb = h + (size_t)b * t * d + col;
  float s = 0.f;
  for (int i = 0; i < t; ++i) s += to_f(hb[(size_t)i * d]);
  const float mean = s / (float)t;
  float q = 0.f;
  for (int i = 0; i < t; ++i) {
    const float dv = to_f(hb[(size_t)i * d]) - mean;
    q += dv * dv;
  }
  const float sd = sqrtf(q / fmaxf((float)t - 1.f, 1.f) + 1e-7f);
  const size_t o = (size_t)b * 2 * d + col;
  cstats[o] = mean;
  cstats[o + d] = sd;
  cstats_io[o] = from_f<T>(mean);
  cstats_io[o + d] = from_f<T>(sd);
}

// The operands of one call. The weights in bf16 come K-major, as
// gemm_sm90 reads them: wm (d, 3c), the k=1 conv weight as the model holds
// it; k1 (a, ldk1) with k1x its first d columns and, with the context
// (ldk1 = 3d), [k1m | k1s] the next 2d; k2 (d, a); k1ms is unused. In f32
// they come as the FMA GEMM reads them, (K, N) row-major: wm (3c, d), k1
// = k1x (d, a), k1ms (2d, a), k2 (a, d).
template <typename T>
struct TailFwd {
  const T *x2, *x3, *x4;  // (b t, c) each
  const float* mask;      // (b, t) or null (inference only)
  const T* wm;
  const float* aff;  // (3, d): bm, ones, zeros
  const T* k1;
  int ldk1;
  const T* k1ms;
  const float* b1;  // (a)
  const T* k2;
  const float* b2;  // (d)
  T* h;             // (b t, d)
  T* cs_io;         // (b, 2d), glob only
  float* cs;  // (b, 2d) f32 [mean | std] (training; zeros without glob),
              // or null (inference)
  float* ctx;       // (b, a)
  T* att;           // (b t, a)
  float* logits;    // (b t, d)
  float* pooled;    // (b, 2d)
  int b, t, c, d, a, glob;
};

// A call's operands from the C entries' untyped pointers.
template <typename T>
TailFwd<T> tail_fwd_args(const void* x2, const void* x3, const void* x4,
                         const float* mask, const void* wm, const float* aff,
                         const void* k1, int ldk1, const void* k1ms,
                         const float* b1, const void* k2, const float* b2,
                         void* h, void* cs_io, float* cs, float* ctx,
                         void* att, float* logits, float* pooled, int b,
                         int t, int c, int d, int a, int glob) {
  return {static_cast<const T*>(x2), static_cast<const T*>(x3),
          static_cast<const T*>(x4), mask, static_cast<const T*>(wm), aff,
          static_cast<const T*>(k1), ldk1, static_cast<const T*>(k1ms), b1,
          static_cast<const T*>(k2), b2, static_cast<T*>(h),
          static_cast<T*>(cs_io), cs, ctx, static_cast<T*>(att), logits,
          pooled, b, t, c, d, a, glob};
}

template <typename T>
cudaError_t tail_fwd(const TailFwd<T>& q, cudaStream_t stream) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int m = q.b * q.t;
  cudaError_t err;
  // 1. h
  if constexpr (kBf16) {
    Sm90Args p{};
    p.m = m;
    p.n = q.d;
    p.k = 3 * q.c;
    p.bias = q.aff;
    p.scale = q.aff + q.d;
    p.shift = q.aff + 2 * q.d;
    p.out = q.h;
    err = gemm_sm90_3<kFormPost>(q.x2, q.x3, q.x4, q.c, q.wm, 3 * q.c, p,
                                 stream);
  } else {
    GemmArgs p = gemm_args(q.x2, q.x3, q.x4, 3, q.c, q.wm, q.h, m, q.d,
                           kRelu);
    p.bias = q.aff;
    err = gemm<T, T>(p, stream);
  }
  if (err != cudaSuccess) return err;
  if (q.glob) {
    // 2. context stats
    if (q.cs) {
      const dim3 grid((q.d + 127) / 128, q.b);
      ctx_stats_kernel<T><<<grid, 128, 0, stream>>>(q.h, q.cs, q.cs_io, q.t,
                                                    q.d);
      err = cudaGetLastError();
    } else {
      err = col_stats<T>(q.h, q.mask, q.cs_io, q.cs_io + q.d, q.b, q.t, q.d,
                         stream, 1, 2 * q.d);
    }
    if (err != cudaSuccess) return err;
    // 3. ctx
    if constexpr (kBf16) {
      Sm90Args p{};
      p.m = q.b;
      p.n = q.a;
      p.k = 2 * q.d;
      p.bias = q.b1;
      p.out_f32 = q.ctx;
      err = gemm_sm90<kFormF32>(q.cs_io, 2 * q.d, q.k1 + q.d, q.ldk1, p,
                                stream);
    } else {
      GemmArgs p = gemm_args(q.cs_io, nullptr, nullptr, 1, 2 * q.d, q.k1ms,
                             q.ctx, q.b, q.a, kNone);
      p.bias = q.b1;
      err = gemm<T, float>(p, stream);
    }
    if (err != cudaSuccess) return err;
  } else if (q.cs) {
    if ((err = cudaMemsetAsync(q.cs, 0, sizeof(float) * 2 * q.d * (size_t)q.b,
                               stream)) != cudaSuccess)
      return err;
  }
  // 4. att, 5. logits
  if constexpr (kBf16) {
    Sm90Args p{};
    p.m = m;
    p.n = q.a;
    p.k = q.d;
    p.t = q.t;
    p.out = q.att;
    if (q.glob)
      p.row_bias = q.ctx;
    else
      p.bias = q.b1;
    if ((err = gemm_sm90<kFormTanh>(q.h, q.d, q.k1, q.ldk1, p, stream)) !=
        cudaSuccess)
      return err;
    Sm90Args pl{};
    pl.m = m;
    pl.n = q.d;
    pl.k = q.a;
    pl.bias = q.b2;
    pl.out_f32 = q.logits;
    err = gemm_sm90<kFormF32>(q.att, q.a, q.k2, q.a, pl, stream);
  } else {
    GemmArgs p = gemm_args(q.h, nullptr, nullptr, 1, q.d, q.k1, q.att, m,
                           q.a, kTanh);
    if (q.glob) {
      p.row_bias = q.ctx;
      p.rows_per_group = q.t;
    } else {
      p.bias = q.b1;
    }
    if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
    p = gemm_args(q.att, nullptr, nullptr, 1, q.a, q.k2, q.logits, m, q.d,
                  kNone);
    p.bias = q.b2;
    err = gemm<T, float>(p, stream);
  }
  if (err != cudaSuccess) return err;
  // 6. pooled
  return softmax_stats<T>(q.logits, q.h, q.mask, q.pooled, q.b, q.t, q.d,
                          stream);
}

}  // namespace ws
