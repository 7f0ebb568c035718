// The ECAPA SE-Res2 block for inference, BN folded (see
// wespeaker_tpu_torch/ops/se_block.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/se_block_pallas.py::fused_se_res2_block.
//
// C interface: ws_se_res2_block(...) issues, on the given stream,
//   pointwise GEMM -> Res2 chain -> pointwise GEMM -> SE squeeze ->
//   excitation GEMMs -> residual
// (bf16: the pointwise GEMMs on gemm_sm90, TMA + wgmma, the second one
// writing the squeeze's partial sums; the chain on wgmma; f32: CUDA-core
// FMA throughout, exact f32) and returns the first CUDA error (0 on
// success). ws_res2_chain(...) issues the Res2 chain alone
// (ops/res2_chain.py; the Pallas kernel
// wespeaker_tpu/ops/res2_pallas.py::fused_res2_chain).

#include "gemm_sm90.cuh"

namespace ws {

// ---- f32: the Res2 chain on the CUDA cores ----
//
// One block per utterance walks the `nums` steps in order. Step
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

// The f32 chain at a group width of 64 or 128.
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

// ---- bf16: the Res2 chain on the tensor cores ----
//
// CTA (utterance, tile) computes every step of the chain over a region of
// kR frames from fa = t0 - (nums - 1) d, and writes frames [t0, t0 + F) of
// each step's output, F = kR - 2 (nums - 1) d: step s's output is right on
// [fa + s d, fa + kR - s d), since the rows of sp past the region are not
// recomputed (ops/se_block.py::chain_plan, which also sizes the grid).
// Shared memory (1 KB-aligned, 64-channel slabs of 128-byte rows under the
// 128-byte swizzle, the layout wgmma reads K-major):
// - sp: the step's input for frames fa - d .. fa + kR + d (rows rounded up
//   to whole 128-row TMA boxes); step 0's is h1's group 0, loaded by TMA
//   (zeros past the utterance's ends: the conv's zero padding); step s + 1's
//   is written by step s's epilogue, y + h1's group s + 1 rounded to bf16
//   (zero for frames outside the utterance), as the JAX kernel rounds it;
// - the step's taps (3, W out, W in), K-major, one TMA box a slab;
// - h1's group s + 1 over the region, loaded by TMA one step ahead.
// Each of the kR / 64 warpgroups owns 64 rows of the region and issues,
// per step, 3 x W / 16 wgmma m64nWk16: tap k is the sp operand starting
// k d rows in (the swizzle follows the address; two warpgroups of two
// M-blocks, two CTAs an SM, spilled at the 128-register cap and were
// slower). The epilogue applies
// bias, relu and the BN affine in f32 to the accumulators, rounds to bf16,
// stores the tile's frames to y and writes the next step's sp. Thread 0
// issues every copy: the next step's taps once all warpgroups' wgmmas of
// this step are done (they overlap the epilogue), the group after next of
// h1 once the epilogue has read this one (it overlaps the next step).
template <int W>
struct ChainTc;
template <>
struct ChainTc<64> {
  static constexpr int kR = 256, kWG = 4;  // region frames, warpgroups
};
template <>
struct ChainTc<128> {
  static constexpr int kR = 128, kWG = 2;  // the taps are 96 KB
};

struct ChainTcArgs {
  const __nv_bfloat16* h1;  // (b, t, c), for the passthrough group
  __nv_bfloat16* y;         // (b, t, c)
  const float* caff;        // (3, nums, W): bias, BN scale, BN shift
  int t, c, nums, d;
  int f;        // output frames a tile
  int ntiles;   // tiles an utterance
  int sp_slab;  // bytes of an sp slab: whole 128-row boxes
};

template <int W>
__global__ void __launch_bounds__(128 * ChainTc<W>::kWG, 1)
    res2_chain_tc_kernel(const __grid_constant__ CUtensorMap tm_h1,
                         const __grid_constant__ CUtensorMap tm_cw,
                         const ChainTcArgs a) {
  constexpr int kR = ChainTc<W>::kR, kThreads = 128 * ChainTc<W>::kWG;
  constexpr int kSl = W / 64;
  constexpr int kMB = kR / 64 / ChainTc<W>::kWG;  // M-blocks a warpgroup
  constexpr int kTapsSlab = 3 * W * 128;  // 3 taps x W output rows
  constexpr int kHSlab = kR * 128;
  constexpr int kBox = 128 * 128;  // bytes of one 128-row TMA box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - raw);
  const int sp_off = 0, taps_off = kSl * a.sp_slab;
  const int hn_off = taps_off + kSl * kTapsSlab;
  const uint32_t bar_sp = base + hn_off + kSl * kHSlab;
  const uint32_t bar_taps = bar_sp + 8, bar_hn = bar_sp + 16;
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int bi = blockIdx.x / a.ntiles, t0 = (blockIdx.x % a.ntiles) * a.f;
  const int t = a.t, d = a.d, nums = a.nums;
  const int fa = t0 - (nums - 1) * d;  // the region's first frame
  const int t_end = min(t0 + a.f, t);  // the tile's frames: [t0, t_end)

  if (tid == 0) {
    mbar_init(bar_sp, 1);
    mbar_init(bar_taps, 1);
    mbar_init(bar_hn, 1);
    fence_mbar_init();
  }
  __syncthreads();
  auto load_taps = [&](int s) {
    mbar_expect_tx(bar_taps, kSl * kTapsSlab);
    for (int sl = 0; sl < kSl; ++sl)
      tma_load_4d(base + taps_off + sl * kTapsSlab, &tm_cw, sl * 64, 0, 0, s,
                  bar_taps);
  };
  auto load_hn = [&](int g) {  // h1's group g over the region
    mbar_expect_tx(bar_hn, kSl * kHSlab);
    for (int sl = 0; sl < kSl; ++sl)
      for (int r = 0; r < kR / 128; ++r)
        tma_load_4d(base + hn_off + sl * kHSlab + r * kBox, &tm_h1,
                    g * W + sl * 64, fa + r * 128, bi, 0, bar_hn);
  };
  if (tid == 0) {
    const int boxes = a.sp_slab / kBox;
    mbar_expect_tx(bar_sp, kSl * a.sp_slab);
    for (int sl = 0; sl < kSl; ++sl)
      for (int r = 0; r < boxes; ++r)
        tma_load_4d(base + sp_off + sl * a.sp_slab + r * kBox, &tm_h1,
                    sl * 64, fa - d + r * 128, bi, 0, bar_sp);
    load_taps(0);
    if (nums > 1) load_hn(1);
  }
  // the passthrough group: y[..., nums W:] = h1[..., nums W:]
  for (int i = tid; i < (t_end - t0) * (W / 8); i += kThreads) {
    const size_t off = ((size_t)bi * t + t0 + i / (W / 8)) * a.c + nums * W +
                       (i % (W / 8)) * 8;
    *reinterpret_cast<uint4*>(a.y + off) =
        *reinterpret_cast<const uint4*>(a.h1 + off);
  }

  mbar_wait(bar_sp, 0);
  float acc[kMB][W / 2];
  for (int s = 0; s < nums; ++s) {
    mbar_wait(bar_taps, s & 1);
    wgmma_fence();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
      const int row = (wg * kMB + mb) * 64;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int ks = 0; ks < W / 16; ++ks) {
          const int sl = ks / 4, within = (ks % 4) * 32;
          const uint64_t da = wgmma_desc(
              base + sp_off + sl * a.sp_slab + (row + k * d) * 128 + within,
              16, 1024, 1);
          const uint64_t db = wgmma_desc(
              base + taps_off + sl * kTapsSlab + k * W * 128 + within, 16,
              1024, 1);
          wgmma_m64k16_kk(acc[mb], da, db, k > 0 || ks > 0);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) fence_regs(acc[mb]);
    __syncthreads();  // every warpgroup is done reading sp and the taps
    const bool more = s + 1 < nums;
    if (tid == 0 && more) load_taps(s + 1);
    if (more) mbar_wait(bar_hn, s & 1);
    const float* bias = a.caff + s * W;
    const float* scale = a.caff + (nums + s) * W;
    const float* shift = a.caff + (2 * nums + s) * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
      const float2 sv = __ldg(reinterpret_cast<const float2*>(scale + col));
      const float2 hv = __ldg(reinterpret_cast<const float2*>(shift + col));
      const int sl = col / 64, cb = (col % 64) * 2;
#pragma unroll
      for (int q = 0; q < 2 * kMB; ++q) {  // (M-block, row half)
        const int mb = q / 2, h = q % 2;
        const int r = (wg * kMB + mb) * 64 + 16 * warp + lane / 4 + 8 * h;
        const int f = fa + r;
        const uint32_t yv = pack2(
            fmaxf(acc[mb][4 * j + 2 * h] + bv.x, 0.f) * sv.x + hv.x,
            fmaxf(acc[mb][4 * j + 2 * h + 1] + bv.y, 0.f) * sv.y + hv.y);
        if (f >= t0 && f < t_end)
          *reinterpret_cast<uint32_t*>(
              a.y + ((size_t)bi * t + f) * a.c + s * W + col) = yv;
        if (more) {
          float y0, y1, h0, h1;
          unpack2(yv, y0, y1);
          unpack2(*reinterpret_cast<const uint32_t*>(
                      sm + hn_off + sl * kHSlab + swz<128>(r * 128 + cb)),
                  h0, h1);
          *reinterpret_cast<uint32_t*>(
              sm + sp_off + sl * a.sp_slab + swz<128>((r + d) * 128 + cb)) =
              f >= 0 && f < t ? pack2(y0 + h0, y1 + h1) : 0u;
        }
      }
    }
    if (more) {
      fence_proxy_async();  // sp's writes, before the next wgmmas read it
      __syncthreads();
      if (tid == 0 && s + 2 < nums) load_hn(s + 2);
    }
  }
}

// Shared memory of res2_chain_tc_kernel<W> at dilation d (mirrored by
// ops/se_block.py::chain_plan); *sp_slab gets the bytes of an sp slab.
inline int chain_tc_smem(int w, int d, int* sp_slab) {
  const int r = w == 64 ? ChainTc<64>::kR : ChainTc<128>::kR;
  const int sl = w / 64;
  const int slab = round_up(r + 2 * d, 128) * 128;
  if (sp_slab) *sp_slab = slab;
  return 1024 + sl * (slab + 3 * w * 128 + r * 128) + 3 * 8;
}

// cwt (nums, 3, W out, W in): the steps' taps K-major.
template <int W>
cudaError_t res2_chain_tc(const __nv_bfloat16* h1, __nv_bfloat16* y,
                          const __nv_bfloat16* cwt, const float* caff, int b,
                          int t, int c, int nums, int d,
                          cudaStream_t stream) {
  constexpr int kR = ChainTc<W>::kR;
  const int f = kR - 2 * (nums - 1) * d;
  if (f < 1 || nums < 1 || d < 0 || c != (nums + 1) * W)
    return cudaErrorInvalidValue;
  ChainTcArgs a{h1, y, caff, t, c, nums, d, f, (t + f - 1) / f, 0};
  const int smem = chain_tc_smem(W, d, &a.sp_slab);
  CUtensorMap tm_h1, tm_cw;
  if (!tensor_map_4d_bf16(&tm_h1, h1, c, t, b, 1, 64, 128, 128) ||
      !tensor_map_4d_bf16(&tm_cw, cwt, W, W, 3, nums, 64, W, 128, 3))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      res2_chain_tc_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  res2_chain_tc_kernel<W><<<b * a.ntiles, 128 * ChainTc<W>::kWG, smem,
                            stream>>>(tm_h1, tm_cw, a);
  return cudaGetLastError();
}

inline cudaError_t res2_chain_tc_any(const __nv_bfloat16* h1,
                                     __nv_bfloat16* y,
                                     const __nv_bfloat16* cwt,
                                     const float* caff, int b, int t, int c,
                                     int width, int nums, int d,
                                     cudaStream_t stream) {
  if (width == 64)
    return res2_chain_tc<64>(h1, y, cwt, caff, b, t, c, nums, d, stream);
  if (width == 128)
    return res2_chain_tc<128>(h1, y, cwt, caff, b, t, c, nums, d, stream);
  return cudaErrorInvalidValue;
}

// ---- the squeeze and the residual ----

// bf16: mean[b, :] (rounded to bf16) from gemm_sm90's partial sums of h2
// (one segment an utterance: part (b, slots, c)), summed in order, over
// the utterance's masked frame count (T unmasked). 128 threads.
__global__ void __launch_bounds__(128)
    se_squeeze_kernel(const float* __restrict__ part,
                      const float* __restrict__ mask,
                      __nv_bfloat16* __restrict__ mean, int t, int c,
                      int slots) {
  __shared__ float red[4];
  const int bi = blockIdx.x;
  float cnt = (float)t;
  if (mask) {
    float v = 0.f;
    for (int i = threadIdx.x; i < t; i += 128) v += mask[(size_t)bi * t + i];
    cnt = fmaxf(sum128(v, red), 1.f);
  }
  const int units = ((bi * t + t - 1) / 64 - (bi * t) / 64) + 1;
  const float* p = part + (size_t)bi * slots * c;
  for (int col = threadIdx.x; col < c; col += 128) {
    float s = 0.f;
    for (int u = 0; u < units; ++u) s += p[(size_t)u * c + col];
    mean[(size_t)bi * c + col] = __float2bfloat16(s / cnt);
  }
}

// out = x + h2 * g[b], 16 bytes a thread: grid (chunks, b), c a power of
// two (the column of a vector is a mask, not a divide).
template <typename T>
__global__ void se_residual_kernel(const T* __restrict__ x,
                                   const T* __restrict__ h2,
                                   const float* __restrict__ g,
                                   T* __restrict__ out, int tc, int c) {
  constexpr int kV = 16 / sizeof(T);
  const size_t base = (size_t)blockIdx.y * tc;
  const float* gb = g + (size_t)blockIdx.y * c;
  for (int i = (blockIdx.x * blockDim.x + threadIdx.x) * kV; i < tc;
       i += gridDim.x * blockDim.x * kV) {
    const uint4 xv = *reinterpret_cast<const uint4*>(x + base + i);
    const uint4 hv = *reinterpret_cast<const uint4*>(h2 + base + i);
    const T* xe = reinterpret_cast<const T*>(&xv);
    const T* he = reinterpret_cast<const T*>(&hv);
    const float* gv = gb + (i & (c - 1));
    uint4 ov;
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < kV; ++e)
      oe[e] = from_f<T>(to_f(xe[e]) + to_f(he[e]) * gv[e]);
    *reinterpret_cast<uint4*>(out + base + i) = ov;
  }
}

template <typename T>
cudaError_t se_residual(const T* x, const T* h2, const float* g, T* out,
                        int b, int t, int c, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  if (c & (c - 1) || c % kV) return cudaErrorInvalidValue;
  const int tc = t * c;
  int blocks = (tc / kV + 255) / 256;
  if (blocks > 64) blocks = 64;  // a grid-stride loop over the utterance
  se_residual_kernel<T><<<dim3(blocks, b), 256, 0, stream>>>(x, h2, g, out,
                                                              tc, c);
  return cudaGetLastError();
}

// ---- the whole block ----

// f32: w1, w2 (c, c) and cw (nums, 3, W in, W out) as the model gives them.
cudaError_t se_block_f32(const float* x, const float* mask, const float* w1,
                         const float* aff1, const float* cw,
                         const float* caff, const float* w2,
                         const float* aff2, const float* sw1,
                         const float* sb1, const float* sw2,
                         const float* sb2, float* h1, float* y, float* h2,
                         float* mean, float* z, float* g, float* out, int b,
                         int t, int c, int width, int nums, int cb, int d,
                         cudaStream_t stream) {
  const int m = b * t;
  cudaError_t err;
  // 1. h1 = bn1(relu(x @ w1 + b1)); aff rows are [bias, scale, shift]
  GemmArgs p = gemm_args(x, nullptr, nullptr, 1, c, w1, h1, m, c, kRelu);
  p.bias = aff1;
  p.scale = aff1 + c;
  p.shift = aff1 + 2 * c;
  if ((err = gemm<float, float>(p, stream)) != cudaSuccess) return err;
  // 2. Res2 chain
  if ((err = res2_chain_any<float>(h1, y, cw, caff, b, t, c, width, nums, d,
                                   stream)) != cudaSuccess)
    return err;
  // 3. h2 = bn2(relu(y @ w2 + b2))
  p = gemm_args(y, nullptr, nullptr, 1, c, w2, h2, m, c, kRelu);
  p.bias = aff2;
  p.scale = aff2 + c;
  p.shift = aff2 + 2 * c;
  if ((err = gemm<float, float>(p, stream)) != cudaSuccess) return err;
  // 4. squeeze: masked mean of h2 over T
  if ((err = col_stats<float>(h2, mask, mean, nullptr, b, t, c, stream)) !=
      cudaSuccess)
    return err;
  // 5./6. excitation: z = relu(mean @ sw1 + sb1); g = sigmoid(z @ sw2 + sb2)
  p = gemm_args(mean, nullptr, nullptr, 1, c, sw1, z, b, cb, kRelu);
  p.bias = sb1;
  if ((err = gemm<float, float>(p, stream)) != cudaSuccess) return err;
  p = gemm_args(z, nullptr, nullptr, 1, cb, sw2, g, b, c, kSigmoid);
  p.bias = sb2;
  if ((err = gemm<float, float>(p, stream)) != cudaSuccess) return err;
  // 7. out = x + h2 * g
  return se_residual<float>(x, h2, g, out, b, t, c, stream);
}

// bf16: w1t, w2t (c out, c in) and cwt (nums, 3, W out, W in) K-major;
// part holds (b, slots, c) f32.
cudaError_t se_block_bf16(const __nv_bfloat16* x, const float* mask,
                          const __nv_bfloat16* w1t, const float* aff1,
                          const __nv_bfloat16* cwt, const float* caff,
                          const __nv_bfloat16* w2t, const float* aff2,
                          const __nv_bfloat16* sw1, const float* sb1,
                          const __nv_bfloat16* sw2, const float* sb2,
                          __nv_bfloat16* h1, __nv_bfloat16* y,
                          __nv_bfloat16* h2, __nv_bfloat16* mean,
                          __nv_bfloat16* z, float* g, float* part,
                          __nv_bfloat16* out, int b, int t, int c, int width,
                          int nums, int cb, int d, int slots,
                          cudaStream_t stream) {
  cudaError_t err;
  // 1. h1 = bn1(relu(x @ w1 + b1)); aff rows are [bias, scale, shift]
  Sm90Args p{};
  p.m = b * t;
  p.n = c;
  p.k = c;
  p.bias = aff1;
  p.scale = aff1 + c;
  p.shift = aff1 + 2 * c;
  p.out = h1;
  if ((err = gemm_sm90<kFormPost>(x, c, w1t, c, p, stream)) != cudaSuccess)
    return err;
  // 2. Res2 chain
  if ((err = res2_chain_tc_any(h1, y, cwt, caff, b, t, c, width, nums, d,
                               stream)) != cudaSuccess)
    return err;
  // 3. h2 = bn2(relu(y @ w2 + b2)), and the squeeze's partial sums
  p.bias = aff2;
  p.scale = aff2 + c;
  p.shift = aff2 + 2 * c;
  p.out = h2;
  p.part = part;
  p.mask = mask;
  p.t = t;
  p.seg_len = t;
  p.nseg = 1;
  p.slots = slots;
  if ((err = gemm_sm90<kFormPost>(y, c, w2t, c, p, stream)) != cudaSuccess)
    return err;
  // 4. squeeze: the masked mean of h2 over T, rounded
  se_squeeze_kernel<<<b, 128, 0, stream>>>(part, mask, mean, t, c, slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // 5./6. excitation: z = relu(mean @ sw1 + sb1) in bf16;
  //       g = sigmoid(z @ sw2 + sb2) in f32
  GemmArgs q = gemm_args(mean, nullptr, nullptr, 1, c, sw1, z, b, cb, kRelu);
  q.bias = sb1;
  using B = __nv_bfloat16;
  if ((err = gemm<B, B>(q, stream)) != cudaSuccess) return err;
  q = gemm_args(z, nullptr, nullptr, 1, cb, sw2, g, b, c, kSigmoid);
  q.bias = sb2;
  if ((err = gemm<B, float>(q, stream)) != cudaSuccess) return err;
  // 7. out = x + h2 * g
  return se_residual<B>(x, h2, g, out, b, t, c, stream);
}

}  // namespace ws

// bf16: w1, w2 are passed K-major as (C out, C in) and cw as (nums, 3,
// W out, W in); `part` holds (B, slots, C) f32. f32: w1, w2 (C in, C out)
// and cw (nums, 3, W in, W out) as the model gives them; `part` is unused.
extern "C" int ws_se_res2_block(
    const void* x, const float* mask, const void* w1, const float* aff1,
    const void* cw, const float* caff, const void* w2, const float* aff2,
    const void* sw1, const float* sb1, const void* sw2, const float* sb2,
    void* h1, void* y, void* h2, void* mean, void* z, float* g, float* part,
    void* out, int b, int t, int c, int width, int nums, int cb, int dilation,
    int slots, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using B = __nv_bfloat16;
    return ws::se_block_bf16(
        static_cast<const B*>(x), mask, static_cast<const B*>(w1), aff1,
        static_cast<const B*>(cw), caff, static_cast<const B*>(w2), aff2,
        static_cast<const B*>(sw1), sb1, static_cast<const B*>(sw2), sb2,
        static_cast<B*>(h1), static_cast<B*>(y), static_cast<B*>(h2),
        static_cast<B*>(mean), static_cast<B*>(z), g, part,
        static_cast<B*>(out), b, t, c, width, nums, cb, dilation, slots, s);
  }
  using F = float;
  return ws::se_block_f32(
      static_cast<const F*>(x), mask, static_cast<const F*>(w1), aff1,
      static_cast<const F*>(cw), caff, static_cast<const F*>(w2), aff2,
      static_cast<const F*>(sw1), sb1, static_cast<const F*>(sw2), sb2,
      static_cast<F*>(h1), static_cast<F*>(y), static_cast<F*>(h2),
      static_cast<F*>(mean), static_cast<F*>(z), g, static_cast<F*>(out), b,
      t, c, width, nums, cb, dilation, s);
}

// The Res2 chain alone (the JAX package's fused_res2_chain): y (b, t, c) =
// the nums chain outputs of width `width` and the passthrough group of x.
// bf16: cw is passed K-major as (nums, 3, W out, W in); f32: (nums, 3,
// W in, W out).
extern "C" int ws_res2_chain(const void* x, const void* cw, const float* caff,
                             void* y, int b, int t, int c, int width,
                             int nums, int dilation, int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c != (nums + 1) * width) return cudaErrorInvalidValue;
  if (bf16) {
    using B = __nv_bfloat16;
    return ws::res2_chain_tc_any(static_cast<const B*>(x), static_cast<B*>(y),
                                 static_cast<const B*>(cw), caff, b, t, c,
                                 width, nums, dilation, s);
  }
  return ws::res2_chain_any<float>(static_cast<const float*>(x),
                                   static_cast<float*>(y),
                                   static_cast<const float*>(cw), caff, b, t,
                                   c, width, nums, dilation, s);
}

// gemm_sm90 alone (ops/gemm_sm90.py), the GEMM of rows 1 and 8: out (m, n)
// bf16 from a (m, lda) with k live columns and wt (n, ldw) with k live
// columns; bn_relu selects the form; part != null adds the partial sums.
extern "C" int ws_gemm_sm90(const void* a, int lda, const void* wt, int ldw,
                            const float* bias, const float* scale,
                            const float* shift, const float* a_scale,
                            const float* a_shift, void* out, float* part,
                            const float* mask, int m, int n, int k, int t,
                            int seg_len, int slots, int bn_relu,
                            void* stream) {
  ws::Sm90Args p{};
  p.m = m;
  p.n = n;
  p.k = k;
  p.bias = bias;
  p.scale = scale;
  p.shift = shift;
  p.a_scale = a_scale;
  p.a_shift = a_shift;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.part = part;
  p.mask = mask;
  p.t = t;
  p.seg_len = seg_len;
  p.nseg = seg_len > 0 ? (t + seg_len - 1) / seg_len : 0;
  p.slots = slots;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn_relu) return ws::gemm_sm90<ws::kFormBnRelu>(a, lda, wt, ldw, p, s);
  return ws::gemm_sm90<ws::kFormPost>(a, lda, wt, ldw, p, s);
}
