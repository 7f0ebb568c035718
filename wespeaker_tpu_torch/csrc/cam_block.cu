// A whole CAM++ dense TDNN block for inference, BN folded (see
// wespeaker_tpu_torch/ops/cam_block.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/cam_block_pallas.py::fused_cam_dense_block.
//
// C interface: ws_cam_dense_block(...) copies x into the first C0 channels
// of the dense map `out` (B, T, C_end) and issues, on the given stream, for
// each layer i
// - bf16, two launches:
//   gemm_sm90 (TMA + wgmma; BN1-relu prologue, BN2-relu epilogue, the
//   masked partial sums of h per segment) -> h, part
//   -> cam_tap_gate_kernel: the CAM gate of the CTA's segments from the
//   partial sums, the k=3 dilated conv on wgmma, times the gate ->
//   out[..., ci:ci+32]
// - f32, three launches on the CUDA cores (exact f32; TF32 misses 1e-4):
//   the FMA GEMM -> h -> context means and gate per segment -> gate -> the
//   FMA k=3 conv times the gate -> out[..., ci:ci+32]
// and returns the first CUDA error (0 on success).

#include "gemm_sm90.cuh"

namespace ws {

constexpr int kBn = 128;     // bottleneck width
constexpr int kHid = 64;     // CAM gate hidden width (bottleneck / 2)
constexpr int kGrowth = 32;  // channels each layer appends
constexpr int kTile = 64;    // frames per f32 conv block

// The gate MLP of one segment, 128 threads, ctx (128 f32, rounded to T)
// in shared memory: hidden relu(ctx @ wc1 + bc1) rounded to T, then
// sigmoid(hidden @ wc2 + bc2) in f32 into gate[0..32). Each output's dot
// product is split over 2 (hidden) or 4 (gate) threads of 4 independent
// sums each, combined in a fixed order: the chains are short, since the
// MLP's latency, not its 10 K multiply-adds, is what a CTA waits on.
// Leaves ctx_s, hid_s and red free for the next segment.
template <typename T>
__device__ void gate_mlp(const float* ctx_s, float* hid_s, float* red,
                         const T* wc1, const float* bc1, const T* wc2,
                         const float* bc2, float* gate) {
  const int tid = threadIdx.x;
  __syncthreads();
  {
    const int j = tid % kHid, k0 = (tid / kHid) * (kBn / 2);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kBn / 2; k += 4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = fmaf(ctx_s[k0 + k + e], to_f(wc1[(k0 + k + e) * kHid + j]),
                    a[e]);
    red[tid] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  __syncthreads();
  if (tid < kHid)
    hid_s[tid] = to_f(from_f<T>(
        fmaxf(bc1[tid] + (red[tid] + red[tid + kHid]), 0.f)));
  __syncthreads();
  {
    const int j = tid % kGrowth, k0 = (tid / kGrowth) * (kHid / 4);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < kHid / 4; k += 4)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        a[e] = fmaf(hid_s[k0 + k + e],
                    to_f(wc2[(k0 + k + e) * kGrowth + j]), a[e]);
    red[kBn + tid] = (a[0] + a[1]) + (a[2] + a[3]);
  }
  __syncthreads();
  if (tid < kGrowth) {
    const float* r = red + kBn + tid;
    const float v = bc2[tid] + ((r[0] + r[kGrowth]) +
                                (r[2 * kGrowth] + r[3 * kGrowth]));
    gate[tid] = 1.f / (1.f + expf(-v));
  }
  __syncthreads();
}

// ---- f32 ----

// One block per utterance, one thread per bottleneck channel. Pass 1: the
// masked f32 sum of h over T and its count. Pass 2, per segment of seg_len
// frames: the segment's masked mean, ctx = gmean + segmean, and the gate
// MLP into gate[b, s, :]. Every frame of a segment has the same ctx, so
// the gate per segment is the gate per frame.
__global__ void __launch_bounds__(kBn)
    cam_context_gate_kernel(const float* __restrict__ h,
                            const float* __restrict__ mask,
                            const float* __restrict__ wc1,
                            const float* __restrict__ bc1,
                            const float* __restrict__ wc2,
                            const float* __restrict__ bc2,
                            float* __restrict__ gate, int t, int seg_len,
                            int nseg) {
  __shared__ float ctx_s[kBn];
  __shared__ float hid_s[kHid];
  __shared__ float red[2 * kBn];
  const int b = blockIdx.x, j = threadIdx.x;
  const float* hb = h + (size_t)b * t * kBn + j;
  const float* mb = mask ? mask + (size_t)b * t : nullptr;
  float s = 0.f, cnt = 0.f;
  for (int i = 0; i < t; ++i) {
    const float m = mb ? mb[i] : 1.f;
    s += hb[(size_t)i * kBn] * m;
    cnt += m;
  }
  const float gmean = s / fmaxf(cnt, 1.f);
  for (int sg = 0; sg < nseg; ++sg) {
    const int lo = sg * seg_len, hi = min(t, lo + seg_len);
    float ss = 0.f, sc = 0.f;
    for (int i = lo; i < hi; ++i) {
      const float m = mb ? mb[i] : 1.f;
      ss += hb[(size_t)i * kBn] * m;
      sc += m;
    }
    ctx_s[j] = gmean + ss / fmaxf(sc, 1.f);
    gate_mlp<float>(ctx_s, hid_s, red, wc1, bc1, wc2, bc2,
                    gate + ((size_t)b * nseg + sg) * kGrowth);
  }
}

// The k=3 dilated conv times the gate. Block (tile, b): frames t0 = tile *
// kTile .. t0 + kTile of utterance b. Shared memory holds h for frames
// t0 - d .. t0 + kTile + d (zeros beyond the utterance's ends: the conv's
// zero padding) and the layer's (3, 128, 32) taps; output row r, tap k
// reads tile row r + k d. The f32 sum over the three taps is multiplied by
// gate[b, frame / seg_len] into out[b, frame, ci:ci+32] (row stride cend).
// 128 threads, each 4 frames x 4 channels.
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

cudaError_t cam_block_f32(const float* mask, const float* s1, const float* t1,
                          const float* w1, const float* s2, const float* t2,
                          const float* w2, const float* wc1, const float* bc1,
                          const float* wc2, const float* bc2, float* h,
                          float* gate, float* out, int b, int t, int c0,
                          int layers, int d, int seg_len,
                          cudaStream_t stream) {
  const int m = b * t, cend = c0 + kGrowth * layers;
  const int nseg = (t + seg_len - 1) / seg_len;
  const size_t smem =
      ((size_t)3 * kBn * kGrowth + (size_t)(kTile + 2 * d) * (kBn + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      cam_tap_conv_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < layers; ++i) {
    const int ci = c0 + kGrowth * i;
    // 1. h = relu(bn2(relu(bn1(out[..., :ci])) @ w1[i, :ci]))
    GemmArgs p = gemm_args(out, nullptr, nullptr, 1, ci,
                           w1 + (size_t)i * cend * kBn, h, m, kBn, kRelu);
    p.lda = cend;
    p.a_scale = s1 + (size_t)i * cend;
    p.a_shift = t1 + (size_t)i * cend;
    p.bn_relu = 1;
    p.scale = s2 + (size_t)i * kBn;
    p.shift = t2 + (size_t)i * kBn;
    if ((err = gemm<float, float>(p, stream)) != cudaSuccess) return err;
    // 2. context means and the gate per segment
    cam_context_gate_kernel<<<b, kBn, 0, stream>>>(
        h, mask, wc1 + (size_t)i * kBn * kHid, bc1 + (size_t)i * kHid,
        wc2 + (size_t)i * kHid * kGrowth, bc2 + (size_t)i * kGrowth, gate, t,
        seg_len, nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // 3. y * gate into the next 32 channels
    cam_tap_conv_fma_kernel<<<dim3((t + kTile - 1) / kTile, b), 128, smem,
                              stream>>>(h, w2 + (size_t)i * 3 * kBn * kGrowth,
                                        gate, out, t, cend, ci, d, seg_len,
                                        nseg);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---- bf16: the gate from the GEMM's partial sums, the conv on wgmma ----
//
// A CTA of 128 threads (one warpgroup) takes kTapItems work items, each
// 128 frames t0 .. t0 + kTapRows of one utterance (the items of all
// utterances in order, ceil(T / 128) an utterance), so that the taps are
// loaded once for both. Thread 0 loads, by TMA under the 128-byte swizzle,
// the layer's taps (3 x 32 output rows of 128 input channels, two
// 64-channel slabs: the K-major B operand) and, for each item, h for
// frames t0 - d .. t0 + kTapRows + d (two slabs; TMA's zero fill past the
// utterance's ends is the conv's zero padding). Meanwhile the threads
// compute the gate of every segment an item touches: the utterance's sum
// of h and the segment's, each from the GEMM's partial sums summed in
// order, over their masked frame counts; ctx = gmean + segmean rounded to
// bf16; the gate MLP. Then, for each item's two 64-frame M-blocks, the
// conv is 3 x 8 wgmma m64n32k16: tap k is the A operand starting k d rows
// into the h tile (the swizzle follows the address). The f32 sum times the
// frame's gate is rounded into out[b, frame, ci:ci+32].
constexpr int kTapRows = 128;  // frames an item
constexpr int kTapItems = 2;   // items a CTA
constexpr int kTapSlab = 3 * kGrowth * 128;  // bytes of one taps slab

struct TapArgs {
  const float* part;  // gemm_sm90's partial sums of h, (b nseg, slots, 128)
  const float* mask;  // (b, t) or null
  const __nv_bfloat16* wc1;  // this layer's gate weights
  const float* bc1;
  const __nv_bfloat16* wc2;
  const float* bc2;
  __nv_bfloat16* out;  // (b, t, cend)
  int b, t, cend, ci, d, seg_len, nseg, slots, layer;
  int h_slab;  // bytes of one h slab, 1 KB-aligned
  int segs;    // gates an item holds: the most segments 128 frames touch
};

__global__ void __launch_bounds__(128)
    cam_tap_gate_kernel(const __grid_constant__ CUtensorMap tm_h,
                        const __grid_constant__ CUtensorMap tm_w2,
                        const TapArgs a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const uint32_t taps_s = base, h_s = base + 2 * kTapSlab;
  float* const ctx_s = reinterpret_cast<float*>(
      sm + 2 * kTapSlab + 2 * kTapItems * a.h_slab);
  float* const hid_s = ctx_s + kBn;
  float* const red = hid_s + kHid;                // 2 x 128
  const uint32_t bar = smem_u32(red + 2 * kBn);    // 8-byte aligned
  float* const gate_s = red + 2 * kBn + 2;  // (items, segs, 32)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t = a.t, d = a.d, seg_len = a.seg_len;
  const int rows = kTapRows + 2 * d;
  const int per_utt = (t + kTapRows - 1) / kTapRows;
  // the CTA's items: utterance, first frame, first segment; live if the
  // item exists (the last CTA may hold one)
  int ib[kTapItems], it0[kTapItems], is_lo[kTapItems];
  bool live[kTapItems];
#pragma unroll
  for (int i = 0; i < kTapItems; ++i) {
    const int w = blockIdx.x * kTapItems + i;
    live[i] = w < a.b * per_utt;
    ib[i] = w / per_utt;
    it0[i] = (w % per_utt) * kTapRows;
    is_lo[i] = it0[i] / seg_len;
  }

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 2 * kTapSlab +
                            (live[1] ? 2 : 1) * 2 * 64 * rows * 2);
    for (int sl = 0; sl < 2; ++sl)
      tma_load_4d(taps_s + sl * kTapSlab, &tm_w2, sl * 64, 0, 0, a.layer,
                  bar);
    for (int i = 0; i < kTapItems; ++i)
      for (int sl = 0; live[i] && sl < 2; ++sl)
        tma_load_4d(h_s + (2 * i + sl) * a.h_slab, &tm_h, sl * 64,
                    it0[i] - d, ib[i], 0, bar);
  }

  // ---- the gate of each segment an item touches ----
  for (int i = 0; i < kTapItems && live[i]; ++i) {
    const int bi = ib[i];
    const float* mb = a.mask ? a.mask + (size_t)bi * t : nullptr;
    const int s_hi = (min(it0[i] + kTapRows, t) - 1) / seg_len;
    auto frames = [&](int lo, int hi) {  // masked frames in [lo, hi)
      if (!mb) return (float)(hi - lo);
      float c = 0.f;
      for (int f = lo + tid; f < hi; f += 128) c += mb[f];
      return sum128(c, red);
    };
    auto seg_sum = [&](int s) {  // sum of h over segment s, channel tid
      const int r0 = bi * t + s * seg_len;
      const int r1 = bi * t + min((s + 1) * seg_len, t);
      const float* p =
          a.part + (size_t)(bi * a.nseg + s) * a.slots * kBn + tid;
      float v = 0.f;
      for (int u = 0; u <= (r1 - 1) / 64 - r0 / 64; ++u) v += p[u * kBn];
      return v;
    };
    float gsum = 0.f;
    for (int s = 0; s < a.nseg; ++s) gsum += seg_sum(s);
    const float gmean = gsum / fmaxf(frames(0, t), 1.f);
    for (int s = is_lo[i]; s <= s_hi; ++s) {
      const float cnt = frames(s * seg_len, min((s + 1) * seg_len, t));
      ctx_s[tid] = __bfloat162float(
          __float2bfloat16(gmean + seg_sum(s) / fmaxf(cnt, 1.f)));
      gate_mlp<__nv_bfloat16>(
          ctx_s, hid_s, red, a.wc1, a.bc1, a.wc2, a.bc2,
          gate_s + ((size_t)i * a.segs + s - is_lo[i]) * kGrowth);
    }
  }

  // ---- the conv: per item two M-blocks of 64 frames, taps as row
  // offsets ----
  mbar_wait(bar, 0);
  float acc[kTapItems][2][16];
  wgmma_fence();
#pragma unroll
  for (int i = 0; i < kTapItems; ++i) {
    if (!live[i]) continue;  // uniform across the warpgroup
#pragma unroll
    for (int mblk = 0; mblk < 2; ++mblk) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int ks = 0; ks < kBn / 16; ++ks) {
          const int sl = ks / 4, within = (ks % 4) * 32;
          const uint64_t da = wgmma_desc(
              h_s + (2 * i + sl) * a.h_slab + (mblk * 64 + k * d) * 128 +
                  within,
              16, 1024, 1);
          const uint64_t db = wgmma_desc(
              taps_s + sl * kTapSlab + k * kGrowth * 128 + within, 16, 1024,
              1);
          wgmma_m64k16_kk(acc[i][mblk], da, db, k > 0 || ks > 0);
        }
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kTapItems; ++i) {
    fence_regs(acc[i][0]);
    fence_regs(acc[i][1]);
  }

#pragma unroll
  for (int i = 0; i < kTapItems; ++i) {
    if (!live[i]) continue;
#pragma unroll
    for (int mblk = 0; mblk < 2; ++mblk) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int tt = it0[i] + mblk * 64 + 16 * warp + lane / 4 + 8 * hh;
        if (tt >= t) continue;
        const float* g =
            gate_s + ((size_t)i * a.segs + tt / seg_len - is_lo[i]) * kGrowth;
        __nv_bfloat16* o = a.out + ((size_t)ib[i] * t + tt) * a.cend + a.ci;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          *reinterpret_cast<uint32_t*>(o + col) =
              pack2(acc[i][mblk][4 * j + 2 * hh] * g[col],
                    acc[i][mblk][4 * j + 2 * hh + 1] * g[col + 1]);
        }
      }
    }
  }
}

// Shared memory of cam_tap_gate_kernel at dilation d and segment length
// seg_len (mirrored by ops/cam_block.py::tap_smem_bytes); *h_slab gets the
// bytes of an h slab and *segs the gates an item holds.
inline int tap_smem(int d, int seg_len, int nseg, int* h_slab, int* segs) {
  const int slab = round_up((kTapRows + 2 * d) * 128, 1024);
  int n = (kTapRows - 1) / seg_len + 2;
  if (n > nseg) n = nseg;
  if (h_slab) *h_slab = slab;
  if (segs) *segs = n;
  return 1024 + 2 * kTapSlab + 2 * kTapItems * slab +
         (kBn + kHid + 2 * kBn + 2) * 4 + kTapItems * n * kGrowth * 4;
}

// w1t (L, 128, C_end) and w2t (L, 3, 32, 128): the layers' weights K-major.
cudaError_t cam_block_bf16(const float* mask, const float* s1,
                           const float* t1, const __nv_bfloat16* w1t,
                           const float* s2, const float* t2,
                           const __nv_bfloat16* w2t,
                           const __nv_bfloat16* wc1, const float* bc1,
                           const __nv_bfloat16* wc2, const float* bc2,
                           __nv_bfloat16* h, float* part, __nv_bfloat16* out,
                           int b, int t, int c0, int layers, int d,
                           int seg_len, int slots, cudaStream_t stream) {
  const int m = b * t, cend = c0 + kGrowth * layers;
  const int nseg = (t + seg_len - 1) / seg_len;
  if (kTapRows + 2 * d > 256) return cudaErrorInvalidValue;  // TMA box rows
  CUtensorMap tm_h, tm_w2;
  if (!tensor_map_4d_bf16(&tm_h, h, kBn, t, b, 1, 64, kTapRows + 2 * d,
                          128) ||
      !tensor_map_4d_bf16(&tm_w2, w2t, kBn, kGrowth, 3, layers, 64, kGrowth,
                          128, 3))
    return cudaErrorInvalidValue;
  TapArgs ta{part, mask, nullptr, nullptr, nullptr, nullptr, out, b, t,
             cend, 0, d, seg_len, nseg, slots, 0, 0, 0};
  const int smem = tap_smem(d, seg_len, nseg, &ta.h_slab, &ta.segs);
  const int items = b * ((t + kTapRows - 1) / kTapRows);
  cudaError_t err = cudaFuncSetAttribute(
      cam_tap_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < layers; ++i) {
    const int ci = c0 + kGrowth * i;
    // 1. h = relu(bn2(relu(bn1(out[..., :ci])) @ w1[i, :ci])), and the
    //    partial sums of h per segment
    Sm90Args p{};
    p.m = m;
    p.n = kBn;
    p.k = ci;
    p.scale = s2 + (size_t)i * kBn;
    p.shift = t2 + (size_t)i * kBn;
    p.a_scale = s1 + (size_t)i * cend;
    p.a_shift = t1 + (size_t)i * cend;
    p.out = h;
    p.part = part;
    p.mask = mask;
    p.t = t;
    p.seg_len = seg_len;
    p.nseg = nseg;
    p.slots = slots;
    if ((err = gemm_sm90<kFormBnRelu>(out, cend, w1t + (size_t)i * kBn * cend,
                                      cend, p, stream)) != cudaSuccess)
      return err;
    // 2. the gate, and y * gate into the next 32 channels
    ta.ci = ci;
    ta.layer = i;
    ta.wc1 = wc1 + (size_t)i * kBn * kHid;
    ta.bc1 = bc1 + (size_t)i * kHid;
    ta.wc2 = wc2 + (size_t)i * kHid * kGrowth;
    ta.bc2 = bc2 + (size_t)i * kGrowth;
    cam_tap_gate_kernel<<<(items + kTapItems - 1) / kTapItems, 128, smem,
                          stream>>>(tm_h, tm_w2, ta);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace ws

// bf16: w1 is passed K-major as (L, 128, C_end) and w2 as (L, 3, 32, 128),
// `part` holds (B * ceil(T / seg_len), slots, 128) f32 and `gate` is
// unused. f32: w1 (L, C_end, 128) and w2 (L, 3, 128, 32) as the model
// stacks them, `gate` holds (B, ceil(T / seg_len), 32) f32 and `part` is
// unused.
extern "C" int ws_cam_dense_block(const void* x, const float* mask,
                                  const float* s1, const float* t1,
                                  const void* w1, const float* s2,
                                  const float* t2, const void* w2,
                                  const void* wc1, const float* bc1,
                                  const void* wc2, const float* bc2, void* h,
                                  float* gate, float* part, void* out, int b,
                                  int t, int c0, int layers, int dilation,
                                  int seg_len, int slots, int bf16,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c0 % 32 || layers < 1 || dilation < 0 || seg_len < 1 || b < 1 || t < 1)
    return cudaErrorInvalidValue;
  const size_t es = bf16 ? 2 : 4;
  const int cend = c0 + ws::kGrowth * layers;
  // the dense map starts as x in its first C0 channels
  cudaError_t err = cudaMemcpy2DAsync(out, (size_t)cend * es, x,
                                      (size_t)c0 * es, (size_t)c0 * es,
                                      (size_t)b * t,
                                      cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  if (bf16) {
    using B = __nv_bfloat16;
    return ws::cam_block_bf16(
        mask, s1, t1, static_cast<const B*>(w1), s2, t2,
        static_cast<const B*>(w2), static_cast<const B*>(wc1), bc1,
        static_cast<const B*>(wc2), bc2, static_cast<B*>(h), part,
        static_cast<B*>(out), b, t, c0, layers, dilation, seg_len, slots, s);
  }
  return ws::cam_block_f32(
      mask, s1, t1, static_cast<const float*>(w1), s2, t2,
      static_cast<const float*>(w2), static_cast<const float*>(wc1), bc1,
      static_cast<const float*>(wc2), bc2, static_cast<float*>(h), gate,
      static_cast<float*>(out), b, t, c0, layers, dilation, seg_len, s);
}
