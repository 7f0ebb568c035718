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
// kernel is a sequence of launches with intermediates in device memory.
//
// forward (ws_mfa_astp_train_fwd): the chain of mfa_astp_fwd.cuh, shared
//   with inference (in bf16 its four products on gemm_sm90, TMA + wgmma),
//   keeping h and att in the I/O type and the f32 context stats as the
//   backward's residuals.
//
// backward in bf16 (ws_mfa_astp_train_bwd_sm90), given g = dL/dpooled, in
// the order of the JAX `_bwd_kernel` and with its roundings (dlogits, dpre
// and dacc to bf16; dctx and dbm summed from the f32 values):
//   1. logits = att k2 + b2 (recomputed: cheaper than keeping 315 MB of
//      f32), gemm_sm90's f32 form;
//   2. softmax_bwd_kernel: per (utterance, 64 channels) the logits and h
//      over T staged once in shared memory, the max and the sums taken
//      there, then dlogits = w (dw - sum_T w dw) (rounded) and dh_pool =
//      w (gm_eff + 2 gv h) written with 16-byte stores, dh_pool over the
//      logits (one read of each, 944 MB at B=256; T past the stage takes
//      more passes, see the kernel);
//   3. dpre = (dlogits k2^T) (1 - att^2) in gemm_sm90's tanh_grad form,
//      the f32 datt never stored; dctx = sum_T dpre from its fixed-order
//      partial sums (one segment an utterance), summed by
//      slot_sum_kernel, with a bf16 copy;
//   4. (glob) [dcmean | dcstd] = dctx [k1m | k1s]^T, the f32 form (M = B),
//      and ctx_coef_kernel's per-(utterance, channel) context terms;
//   5. dacc = [h > 0] (dpre k1x^T + dh_pool + dh_ctx) in the relu_grad
//      form, each row with its own utterance's context terms (128-row tiles
//      straddle utterances), rounded; dbm from its partial sums
//      (slot_total_kernel): the f32 dh_att never reaches memory;
//   6. dx = dacc wm^T as one launch over N = 3C in the plain form, column
//      tile n0 writing dx_{2 + n0 / C};
//   7. dwm = [x2 | x3 | x4]^T dacc, dk2 = att^T dlogits and dk1x = h^T dpre
//      in one launch of gemm_tn_sm90.cuh (wgmma on MN-major tiles, K split
//      by a cost model of waves and epilogues, a fixed-order sum of the
//      splits).
// Every weight is read as the wrapper receives it in the JAX layout (wm
// (3C, D), k1 (3D or D, A), k2 (A, D)) or, for the logits, k2^T: each is
// already K-major for the product that reads it. Eleven launches (nine
// without the global context), none on WMMA; the same bits every call.
//
// backward in f32 (ws_mfa_astp_train_bwd): the same math on common.cuh's
// exact FMA GEMMs (TF32 would miss 1e-4): the logits, softmax_bwd_kernel,
// datt, dpre_kernel, the context product, dh_att, dacc_kernel and col_sum,
// dx_i, and split-K gemm_tn for the weight gradients, with the transposed
// weights made by the wrapper.

#include "gemm_tn_sm90.cuh"
#include "mfa_astp_fwd.cuh"

namespace ws {

// ---- the softmax backward ----
//
// With var = std^2, gv = dL/dvar and gm_eff = dL/dmean - 2 gv mean, the
// gradient of the weights is dw = gm_eff h + gv h^2; dlogits = w (dw -
// sum_T w dw) and dh_pool = w (gm_eff + 2 gv h). A CTA of 256 threads owns
// (utterance, 64 channels): it stages up to `tc` frames of the logits and
// h in shared memory (rows padded by 16 bytes: the 32-byte reads of the
// write pass meet every bank equally) by cp.async, all of a thread's
// 16-byte copies in flight at once (no registers held, so two CTAs an SM
// keep ~150 KB in flight); thread (channel, part) takes the max and the
// sums of e = exp(l - max) and e dw over frames part, part + 4, ...
// (rescaling its sums by exp(m_old - m_new) where a later stage raises the
// max), and the four parts merge in order. The write pass computes 8
// channels of a frame a thread and stores dlogits (T) and dh_pool (f32,
// over the logits) with 16-byte stores. Where T <= tc (T = 200: tc = 246 in bf16) the logits and
// h are read once; otherwise the write pass stages each chunk again.
constexpr int kSbThreads = 256, kSbCh = 64;
constexpr int kSbSmem = 100 * 1024;  // two CTAs an SM

template <typename T>
__host__ __device__ constexpr int sb_row_bytes() {  // a staged frame
  return (kSbCh * 4 + 16) + (kSbCh * (int)sizeof(T) + 16);
}
template <typename T>
__host__ __device__ constexpr int sb_frames() {
  return kSbSmem / sb_row_bytes<T>();
}

// rows n of kChunks 16-byte chunks from src (row stride sld bytes) to dst
// (row stride dld bytes) by cp.async, every copy of the thread in flight
// at once; the caller waits (cp_async_wait_all) and syncs
template <int kChunks>
__device__ __forceinline__ void sb_stage(unsigned char* dst, int dld,
                                         const unsigned char* src,
                                         size_t sld, int n) {
  const int total = n * kChunks;
  const uint32_t d0 = smem_u32(dst);
  for (int q = threadIdx.x; q < total; q += kSbThreads)
    cp_async16(d0 + (q / kChunks) * dld + (q % kChunks) * 16,
               src + (size_t)(q / kChunks) * sld + (q % kChunks) * 16);
}

template <typename T>
__global__ void __launch_bounds__(kSbThreads, 2)
    softmax_bwd_kernel(float* __restrict__ logits, const T* __restrict__ h,
                       const float* __restrict__ pooled,
                       const float* __restrict__ g, T* __restrict__ dl,
                       int t, int d) {
  extern __shared__ __align__(16) unsigned char sb_smem[];
  constexpr int kLdL = kSbCh * 4 + 16;                 // bytes a row
  constexpr int kLdH = kSbCh * (int)sizeof(T) + 16;
  constexpr int kTc = sb_frames<T>();
  unsigned char* const ls = sb_smem;
  unsigned char* const hs = sb_smem + kTc * kLdL;
  __shared__ float c_gme[kSbCh], c_gv[kSbCh], c_m[kSbCh], c_inv[kSbCh],
      c_wdw[kSbCh];
  __shared__ float r_m[4][kSbCh], r_s[4][kSbCh], r_sw[4][kSbCh];
  const int nch = d / kSbCh;
  const int b = blockIdx.x / nch, c0 = (blockIdx.x % nch) * kSbCh;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * t * d + c0;
  if (tid < kSbCh) {
    const size_t r = (size_t)b * 2 * d + c0 + tid;
    const float mean = pooled[r], sd = pooled[r + d];
    const float gv = sd * sd > 1e-7f ? g[r + d] * 0.5f / fmaxf(sd, 1e-12f)
                                     : 0.f;
    c_gv[tid] = gv;
    c_gme[tid] = g[r] - 2.f * gv * mean;
  }
  auto stage = [&](int f0, int n) {
    sb_stage<kLdL / 16 - 1>(
        ls, kLdL,
        reinterpret_cast<const unsigned char*>(logits + base + (size_t)f0 * d),
        (size_t)d * 4, n);
    sb_stage<kLdH / 16 - 1>(
        hs, kLdH,
        reinterpret_cast<const unsigned char*>(h + base + (size_t)f0 * d),
        (size_t)d * sizeof(T), n);
    cp_async_wait_all();
  };
  auto lg = [&](int i, int c) {
    return reinterpret_cast<const float*>(ls + i * kLdL)[c];
  };
  auto hv = [&](int i, int c) {
    return to_f(reinterpret_cast<const T*>(hs + i * kLdH)[c]);
  };

  // the max and the sums: thread (ch, part) over frames part, part + 4, ...
  const int ch = tid % kSbCh, part = tid / kSbCh;
  float m = -3.0e38f, s = 0.f, sw = 0.f;
  for (int f0 = 0; f0 < t; f0 += kTc) {
    const int n = min(kTc, t - f0);
    __syncthreads();  // the last chunk's readers are done
    stage(f0, n);
    __syncthreads();
    const float gme = c_gme[ch], gv = c_gv[ch];
    float mx = m;
    for (int i = part; i < n; i += 4) mx = fmaxf(mx, lg(i, ch));
    const float sc = expf(m - mx);
    s *= sc;
    sw *= sc;
    m = mx;
    for (int i = part; i < n; i += 4) {
      const float e = expf(lg(i, ch) - m), x = hv(i, ch);
      s += e;
      sw += e * (gme * x + gv * x * x);
    }
  }
  r_m[part][ch] = m;
  r_s[part][ch] = s;
  r_sw[part][ch] = sw;
  __syncthreads();
  if (tid < kSbCh) {
    float mx = r_m[0][tid];
    for (int q = 1; q < 4; ++q) mx = fmaxf(mx, r_m[q][tid]);
    float ss = 0.f, ssw = 0.f;
    for (int q = 0; q < 4; ++q) {
      const float sc = expf(r_m[q][tid] - mx);
      ss += r_s[q][tid] * sc;
      ssw += r_sw[q][tid] * sc;
    }
    c_m[tid] = mx;
    c_inv[tid] = 1.f / ss;
    c_wdw[tid] = ssw / ss;  // sum_T w dw
  }
  __syncthreads();

  // the writes: thread q takes channels 8 (q % 8) .. + 7 of frame q / 8
  for (int f0 = 0; f0 < t; f0 += kTc) {
    const int n = min(kTc, t - f0);
    if (t > kTc) {
      __syncthreads();
      stage(f0, n);
      __syncthreads();
    }
    for (int q = tid; q < n * 8; q += kSbThreads) {
      const int i = q / 8, cc = (q % 8) * 8;
      float o_dl[8], o_dh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = cc + e;
        const float x = hv(i, c), gme = c_gme[c], gv = c_gv[c];
        const float w = expf(lg(i, c) - c_m[c]) * c_inv[c];
        o_dl[e] = w * (gme * x + gv * x * x - c_wdw[c]);
        o_dh[e] = w * (gme + 2.f * gv * x);
      }
      const size_t o = base + (size_t)(f0 + i) * d + cc;
      float4* dh = reinterpret_cast<float4*>(logits + o);
      dh[0] = make_float4(o_dh[0], o_dh[1], o_dh[2], o_dh[3]);
      dh[1] = make_float4(o_dh[4], o_dh[5], o_dh[6], o_dh[7]);
      if constexpr (std::is_same<T, float>::value) {
        float4* dv = reinterpret_cast<float4*>(dl + o);
        dv[0] = make_float4(o_dl[0], o_dl[1], o_dl[2], o_dl[3]);
        dv[1] = make_float4(o_dl[4], o_dl[5], o_dl[6], o_dl[7]);
      } else {
        *reinterpret_cast<uint4*>(dl + o) =
            make_uint4(pack2(o_dl[0], o_dl[1]), pack2(o_dl[2], o_dl[3]),
                       pack2(o_dl[4], o_dl[5]), pack2(o_dl[6], o_dl[7]));
      }
    }
  }
}

template <typename T>
cudaError_t softmax_bwd(float* logits, const T* h, const float* pooled,
                        const float* g, T* dl, int b, int t, int d,
                        cudaStream_t stream) {
  if (d % kSbCh || b <= 0 || t <= 0) return cudaErrorInvalidValue;
  const int smem = sb_frames<T>() * sb_row_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      softmax_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  softmax_bwd_kernel<T><<<(unsigned)((long long)b * (d / kSbCh)), kSbThreads,
                          smem, stream>>>(logits, h, pooled, g, dl, t, d);
  return cudaGetLastError();
}

// ---- sums of gemm_sm90's partial sums, one segment an utterance ----

// the 64-row units utterance bi's rows touch (its partial-sum slots)
__device__ __forceinline__ int utt_units(int bi, int t) {
  return (bi * t + t - 1) / 64 - (bi * t) / 64 + 1;
}

// out[bi, col] = the sum of utterance bi's slots of part (b, slots, n), in
// order; out_io its bf16 rounding. 128 threads; grid b * ceil(n / 128).
__global__ void slot_sum_kernel(const float* __restrict__ part,
                                float* __restrict__ out,
                                __nv_bfloat16* __restrict__ out_io, int t,
                                int slots, int n) {
  const int nb = (n + 127) / 128;
  const int bi = blockIdx.x / nb;
  const int col = (blockIdx.x % nb) * 128 + threadIdx.x;
  if (col >= n) return;
  const float* p = part + (size_t)bi * slots * n + col;
  float s = 0.f;
  for (int u = 0; u < utt_units(bi, t); ++u) s += p[(size_t)u * n];
  out[(size_t)bi * n + col] = s;
  out_io[(size_t)bi * n + col] = __float2bfloat16(s);
}

// out[col] = the sum over all b utterances of their slots: a block of 32 x
// 32 threads takes 32 columns, group j sums utterances j, j + 32, ... in
// order, and the 32 group sums add in order. grid ceil(n / 32).
__global__ void __launch_bounds__(1024)
    slot_total_kernel(const float* __restrict__ part,
                      float* __restrict__ out, int b, int t, int slots,
                      int n) {
  __shared__ float red[32][33];
  const int cl = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + cl;
  float s = 0.f;
  if (col < n)
    for (int bi = grp; bi < b; bi += 32) {
      const float* p = part + (size_t)bi * slots * n + col;
      for (int u = 0; u < utt_units(bi, t); ++u) s += p[(size_t)u * n];
    }
  red[grp][cl] = s;
  __syncthreads();
  if (grp == 0 && col < n) {
    float v = 0.f;
    for (int j = 0; j < 32; ++j) v += red[j][cl];
    out[col] = v;
  }
}

// The relu_grad form's context terms per (utterance, channel): with the
// context mean and std (cstats) and their gradients (dcms), both (b, 2d)
// [mean | std], dh_ctx = 2 / max(T - 1, 1) (h - cmean) dcstd 0.5 / cstd +
// dcmean / T = h k + c0: coef (b, 2d) = [k | c0 = dcmean / T - cmean k].
// One thread an element.
__global__ void ctx_coef_kernel(const float* __restrict__ cstats,
                                const float* __restrict__ dcms,
                                float* __restrict__ coef, int b, int t,
                                int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * d) return;
  const size_t r = (size_t)(i / d) * 2 * d + i % d;
  const float k = 2.f / fmaxf((float)t - 1.f, 1.f) * dcms[r + d] * 0.5f /
                  cstats[r + d];
  coef[r] = k;
  coef[r + d] = dcms[r] / (float)t - cstats[r] * k;
}

// ---- the bf16 backward ----

struct BwdSm90 {
  // residuals of the forward and the incoming gradient
  const __nv_bfloat16 *x2, *x3, *x4, *h, *att;
  const float *pooled, *cstats, *g;
  // weights, K-major for the products that read them: k2t (d, a) for the
  // logits, k2 (a, d) for datt, k1 (3d or d, a): k1x its first d rows for
  // dh_att and [k1m | k1s] the next 2d for dcms, wm (3c, d) for dx
  const __nv_bfloat16 *k2t, *k2, *k1, *wm;
  const float* b2;
  // outputs: dx_i (b t, c) bf16; wgrad [dwm (3c, d) | dk2 (a, d) | dk1x
  // (d, a)] f32; dbm (d), dctx (b, a) f32
  __nv_bfloat16 *dx2, *dx3, *dx4;
  float *wgrad, *dbm, *dctx;
  // scratch: logits (b t, d) f32, then dh_pool; dl (b t, d), dp (b t,
  // a), dctx_io (b, a), da (b t, d); with glob dcms and coef (b, 2d) f32;
  // part_ctx (b, slots, a), part_bm (b, slots, d)
  float* logits;
  __nv_bfloat16 *dl, *dp, *dctx_io, *da;
  float *dcms, *coef;
  float *part_ctx, *part_bm;
  int slots;
  float* work;  // gemm_tn_sm90's workspace
  size_t work_elems;
};

cudaError_t train_bwd_sm90(const BwdSm90& q, int b, int t, int c, int d,
                           int a, int glob, cudaStream_t stream) {
  const int m = b * t;
  cudaError_t err;
  // 1. logits
  Sm90Args p{};
  p.m = m;
  p.n = d;
  p.k = a;
  p.bias = q.b2;
  p.out_f32 = q.logits;
  if ((err = gemm_sm90<kFormF32>(q.att, a, q.k2t, a, p, stream)) !=
      cudaSuccess)
    return err;
  // 2. dlogits, dh_pool
  if ((err = softmax_bwd<__nv_bfloat16>(q.logits, q.h, q.pooled, q.g, q.dl,
                                        b, t, d, stream)) != cudaSuccess)
    return err;
  // 3. dpre, its partial sums; dctx
  p = Sm90Args{};
  p.m = m;
  p.n = a;
  p.k = d;
  p.aux = q.att;
  p.out = q.dp;
  p.part = q.part_ctx;
  p.t = t;
  p.seg_len = t;
  p.nseg = 1;
  p.slots = q.slots;
  if ((err = gemm_sm90<kFormTanhGrad>(q.dl, d, q.k2, d, p, stream)) !=
      cudaSuccess)
    return err;
  slot_sum_kernel<<<b * ((a + 127) / 128), 128, 0, stream>>>(
      q.part_ctx, q.dctx, q.dctx_io, t, q.slots, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 4. [dcmean | dcstd]
  if (glob) {
    p = Sm90Args{};
    p.m = b;
    p.n = 2 * d;
    p.k = a;
    p.out_f32 = q.dcms;
    if ((err = gemm_sm90<kFormF32>(q.dctx_io, a, q.k1 + (size_t)d * a, a, p,
                                   stream)) != cudaSuccess)
      return err;
    ctx_coef_kernel<<<(unsigned)(((long long)b * d + 255) / 256), 256, 0,
                      stream>>>(q.cstats, q.dcms, q.coef, b, t, d);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  // 5. dacc, its partial sums; dbm
  p = Sm90Args{};
  p.m = m;
  p.n = d;
  p.k = a;
  p.aux = q.h;
  p.aux_f32 = q.logits;
  p.coef = glob ? q.coef : nullptr;
  p.out = q.da;
  p.part = q.part_bm;
  p.t = t;
  p.seg_len = t;
  p.nseg = 1;
  p.slots = q.slots;
  if ((err = gemm_sm90<kFormReluGrad>(q.dp, a, q.k1, a, p, stream)) !=
      cudaSuccess)
    return err;
  slot_total_kernel<<<(d + 31) / 32, 1024, 0, stream>>>(q.part_bm, q.dbm, b,
                                                        t, q.slots, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 6. dx_i
  p = Sm90Args{};
  p.m = m;
  p.n = 3 * c;
  p.k = d;
  p.out = q.dx2;
  p.out1 = q.dx3;
  p.out2 = q.dx4;
  p.n_out = c;
  if ((err = gemm_sm90<kFormPlain>(q.da, d, q.wm, d, p, stream)) !=
      cudaSuccess)
    return err;
  // 7. dwm, dk2, dk1x
  const TnOperand ops[3] = {
      {{q.x2, q.x3, q.x4}, 3, c, q.da, d, q.wgrad},
      {{q.att, nullptr, nullptr}, 1, a, q.dl, d, q.wgrad + (size_t)3 * c * d},
      {{q.h, nullptr, nullptr}, 1, d, q.dp, a,
       q.wgrad + (size_t)3 * c * d + (size_t)a * d}};
  return gemm_tn_sm90(ops, 3, m, q.work, q.work_elems, stream);
}

// ---- the f32 backward ----

// dpre = datt (1 - att^2), and dctx = sum_T dpre, one thread per
// (utterance, column).
__global__ void dpre_kernel(const float* __restrict__ datt,
                            const float* __restrict__ att,
                            float* __restrict__ dp, float* __restrict__ dctx,
                            int t, int a) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= a) return;
  const size_t base = (size_t)b * t * a + col;
  float s = 0.f;
  for (int i = 0; i < t; ++i) {
    const size_t o = base + (size_t)i * a;
    const float av = att[o];
    const float v = datt[o] * (1.f - av * av);
    dp[o] = v;
    s += v;
  }
  dctx[(size_t)b * a + col] = s;
}

// dacc = [h > 0] (dh_att + dh_pool + dh_ctx), with (glob, dcms non-null)
// dh_ctx = 2/(T-1) (h - cmean) dcstd 0.5/cstd + dcmean/T; and the sum over
// T of dacc per (utterance, channel).
__global__ void dacc_kernel(const float* __restrict__ dh_att,
                            const float* __restrict__ dh_pool,
                            const float* __restrict__ h,
                            const float* __restrict__ cstats,
                            const float* __restrict__ dcms,
                            float* __restrict__ da,
                            float* __restrict__ dbm_part, int t, int d) {
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
    const float hv = h[o];
    float v = dh_att[o] + dh_pool[o];
    if (dcms) v += (hv - cm) * k + dcm_t;
    v = hv > 0.f ? v : 0.f;
    da[o] = v;
    s += v;
  }
  dbm_part[(size_t)b * d + col] = s;
}

struct BwdF32 {
  // residuals of the forward and the incoming gradient
  const float *x2, *x3, *x4, *h, *att;
  const float *pooled, *cstats, *g;
  // weights as (K, N) row-major: k2 (a, d), k2t (d, a), k1xt (a, d),
  // k1mst (a, 2d) or null, wmt[i] (d, c); b2 (d)
  const float *k2, *k2t, *k1xt, *k1mst, *wmt2, *wmt3, *wmt4;
  const float* b2;
  // outputs
  float *dx2, *dx3, *dx4;
  float *dwm, *dbm, *dk1x, *dctx, *dk2;
  // scratch
  float* logits;   // (b, t, d), then dh_pool
  float* dl;       // (b, t, d)
  float* datt;     // (b, t, a)
  float* dp;       // (b, t, a)
  float* dcms;     // (b, 2d), glob only
  float* dh;       // (b, t, d)
  float* da;       // (b, t, d)
  float* dbm_part; // (b, d)
  float* work;     // split-K workspace
  size_t work_elems;
};

cudaError_t train_bwd_f32(const BwdF32& q, int b, int t, int c, int d, int a,
                          int glob, cudaStream_t stream) {
  using T = float;
  const int m = b * t;
  const dim3 grid_d((d + 127) / 128, b), grid_a((a + 127) / 128, b);
  cudaError_t err;
  // 1. logits
  GemmArgs p = gemm_args(q.att, nullptr, nullptr, 1, a, q.k2, q.logits, m, d,
                         kNone);
  p.bias = q.b2;
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 2. dlogits, dh_pool
  if ((err = softmax_bwd<T>(q.logits, q.h, q.pooled, q.g, q.dl, b, t, d,
                            stream)) != cudaSuccess)
    return err;
  // 3. datt
  p = gemm_args(q.dl, nullptr, nullptr, 1, d, q.k2t, q.datt, m, a, kNone);
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 4. dpre, dctx
  dpre_kernel<<<grid_a, 128, 0, stream>>>(q.datt, q.att, q.dp, q.dctx, t, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5. [dcmean | dcstd]
  if (glob) {
    p = gemm_args(q.dctx, nullptr, nullptr, 1, a, q.k1mst, q.dcms, b, 2 * d,
                  kNone);
    if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  }
  // 6. dh_att
  p = gemm_args(q.dp, nullptr, nullptr, 1, a, q.k1xt, q.dh, m, d, kNone);
  if ((err = gemm<T, float>(p, stream)) != cudaSuccess) return err;
  // 7. dacc and its per-utterance sums, 8. dbm
  dacc_kernel<<<grid_d, 128, 0, stream>>>(q.dh, q.logits, q.h, q.cstats,
                                          glob ? q.dcms : nullptr, q.da,
                                          q.dbm_part, t, d);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = col_sum(q.dbm_part, q.dbm, b, d, stream)) != cudaSuccess)
    return err;
  // 9. dx_i, 10. dwm_i
  const float* xs[3] = {q.x2, q.x3, q.x4};
  const float* wmt[3] = {q.wmt2, q.wmt3, q.wmt4};
  float* dxs[3] = {q.dx2, q.dx3, q.dx4};
  for (int i = 0; i < 3; ++i) {
    p = gemm_args(q.da, nullptr, nullptr, 1, d, wmt[i], dxs[i], m, c, kNone);
    if ((err = gemm<T, T>(p, stream)) != cudaSuccess) return err;
    if ((err = gemm_tn(xs[i], q.da, q.dwm + (size_t)i * c * d, c, d, m,
                       q.work, q.work_elems, stream)) != cudaSuccess)
      return err;
  }
  // 11. dk2, 12. dk1x
  if ((err = gemm_tn(q.att, q.dl, q.dk2, a, d, m, q.work, q.work_elems,
                     stream)) != cudaSuccess)
    return err;
  return gemm_tn(q.h, q.dp, q.dk1x, d, a, m, q.work, q.work_elems, stream);
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

// f32 elements of split-K workspace the f32 backward needs.
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
    const float* x2, const float* x3, const float* x4, const float* h,
    const float* att, const float* pooled, const float* cstats,
    const float* g, const float* k2, const float* k2t, const float* k1xt,
    const float* k1mst, const float* wmt2, const float* wmt3,
    const float* wmt4, const float* b2, float* dx2, float* dx3, float* dx4,
    float* dwm, float* dbm, float* dk1x, float* dctx, float* dk2,
    float* logits, float* dl, float* datt, float* dp, float* dcms, float* dh,
    float* da, float* dbm_part, float* wsp, long long ws_elems, int b, int t,
    int c, int d, int a, int glob, void* stream) {
  ws::BwdF32 q{x2, x3, x4, h, att, pooled, cstats, g,
               k2, k2t, k1xt, k1mst, wmt2, wmt3, wmt4, b2,
               dx2, dx3, dx4, dwm, dbm, dk1x, dctx, dk2,
               logits, dl, datt, dp, dcms, dh, da, dbm_part,
               wsp, (size_t)ws_elems};
  return ws::train_bwd_f32(q, b, t, c, d, a, glob,
                           static_cast<cudaStream_t>(stream));
}

// f32 elements of gemm_tn_sm90's workspace the bf16 backward needs (its
// split count follows the card's SM count).
extern "C" long long ws_mfa_astp_train_bwd_sm90_workspace(int b, int t,
                                                          int c, int d,
                                                          int a) {
  const ws::TnOperand ops[3] = {{{nullptr}, 3, c, nullptr, d, nullptr},
                                {{nullptr}, 1, a, nullptr, d, nullptr},
                                {{nullptr}, 1, d, nullptr, a, nullptr}};
  return (long long)ws::gemm_tn_sm90_workspace(ops, 3, b * t);
}

// bf16 operands and outputs (void*), f32 where named float. wgrad is one
// f32 buffer [dwm (3c, d) | dk2 (a, d) | dk1x (d, a)]; dcms and coef are
// (b, 2d) f32 (null without glob); part_ctx and part_bm hold (b, slots, a)
// and (b, slots, d) f32 with slots = seg_slots(t, t).
extern "C" int ws_mfa_astp_train_bwd_sm90(
    const void* x2, const void* x3, const void* x4, const void* h,
    const void* att, const float* pooled, const float* cstats, const float* g,
    const void* k2t, const void* k2, const void* k1, const void* wm,
    const float* b2, void* dx2, void* dx3, void* dx4, float* wgrad,
    float* dbm, float* dctx, float* logits, void* dl, void* dp,
    void* dctx_io, void* da, float* dcms, float* coef, float* part_ctx,
    float* part_bm, int slots, float* wsp, long long ws_elems, int b, int t,
    int c, int d, int a, int glob, void* stream) {
  using bf = __nv_bfloat16;
  auto in = [](const void* v) { return static_cast<const bf*>(v); };
  auto out = [](void* v) { return static_cast<bf*>(v); };
  if (slots < ws::seg_slots(t, t)) return (int)cudaErrorInvalidValue;
  ws::BwdSm90 q{in(x2), in(x3), in(x4), in(h), in(att), pooled, cstats, g,
                in(k2t), in(k2), in(k1), in(wm), b2,
                out(dx2), out(dx3), out(dx4), wgrad, dbm, dctx,
                logits, out(dl), out(dp), out(dctx_io), out(da), dcms, coef,
                part_ctx, part_bm, slots, wsp, (size_t)ws_elems};
  return ws::train_bwd_sm90(q, b, t, c, d, a, glob,
                            static_cast<cudaStream_t>(stream));
}

// One A^T B product alone, for the card tests: out (m, n) f32 = a^T b with
// a (k, m) and b (k, n) bf16 row-major; m and n multiples of 128.
extern "C" long long ws_gemm_tn_sm90_workspace(int m, int n, int k) {
  const ws::TnOperand op{{nullptr}, 1, m, nullptr, n, nullptr};
  return (long long)ws::gemm_tn_sm90_workspace(&op, 1, k);
}

extern "C" int ws_gemm_tn_sm90(const void* a, const void* b, float* out,
                               int m, int n, int k, float* wsp,
                               long long ws_elems, void* stream) {
  const ws::TnOperand op{{a, nullptr, nullptr}, 1, m, b, n, out};
  return ws::gemm_tn_sm90(&op, 1, k, wsp, (size_t)ws_elems,
                          static_cast<cudaStream_t>(stream));
}

// The GEMM launches this library has made, by route (common.cuh's
// GemmRoute order: gemm_sm90, gemm_tn_sm90, WMMA, FMA), into out[4].
extern "C" void ws_gemm_route_counts(long long* out) {
  for (int i = 0; i < ws::kRoutes; ++i) out[i] = ws::gemm_route_counts()[i];
}
