// gemm_sm90: the bf16 GEMM of the CAM++ dense block's bottleneck, the
// SE-Res2 block's two pointwise convs and the MFA+ASTP tail's three large
// products on Hopper: TMA loads into a ring of shared-memory stages, wgmma
// on the tensor cores, the epilogue from registers.
//
//   out (m, n) = epilogue(A (m, k) @ W),  f32 accumulation
//
// A is row-major with a row stride lda >= k (the live prefix of a wider
// map); W is given K-major, as wt (n, k) row-major with row stride ldw.
// Both are read through 2-D tensor maps whose K extent is k exactly, so a
// box that reaches past k reads zeros and never the bits of the channels
// beyond it (the CAM++ dense map's channels past ci are not written yet).
// A may also be drawn from kParts = 3 tensor maps as K-slices of one
// product (the MFA conv over the three SE-Res2 block outputs, whose concat
// is never materialised): each map has a K extent of exactly k / 3, which
// must be a multiple of the 64-column K tile, and K tile kt reads map
// kt / (k / 192) at column (kt % (k / 192)) * 64; W is one map of extent k.
// Forms (template parameter):
// - kFormPost:   v = relu(acc + bias) * scale + shift       (the SE convs,
//                and the MFA conv with scale 1, shift 0)
// - kFormBnRelu: A's prologue relu(a * a_scale + a_shift), rounded to bf16,
//                per K column, then v = relu(acc * scale + shift) (CAM++)
// - kFormTanh:   v = tanh(acc + row_bias[r / t][col]), the row bias (m / t,
//                n) f32 one row an utterance of t rows (ASTP's context
//                bias; 128-row tiles straddle utterances, so each row looks
//                its own up), or v = tanh(acc + bias[col]) where row_bias is
//                null
// and v is rounded to bf16; or
// - kFormF32:    v = acc + bias, stored as f32 into out_f32 (ASTP's
//                logits), straight from the registers: a warp's store
//                covers 8 rows of 32 contiguous bytes, whole sectors, and
//                needs no staging tile.
// Optionally (part != null; the post and bn_relu forms) the epilogue also
// writes masked partial column sums of the stored (rounded) values for the
// segments of seg_len frames of each utterance of t frames (row r is
// frame r % t of utterance r / t): one f32 sum per (segment, 64-row unit
// of M that holds some of its rows, column), summed over the unit's rows
// in order, into part[(g * slots + u - u0(g)) * n + col] for segment g
// (utterance-major) whose first row lies in unit u0(g). A reader sums a
// segment's slots in order: the same input gives the same bits every call,
// with no atomics. `slots` must hold every unit a segment touches:
// (min(seg_len, t) + 62) / 64 + 1.
//
// Design: a persistent CTA an SM walks 128 x 128 output tiles, column
// tiles fastest (the CTAs that share an A tile run together and meet it in
// L2). One producer warp keeps a ring of kG9Stages (A, W) stages of 64 K
// columns in flight by TMA, each 2 x 16 KB of 128-byte rows under the
// 128-byte swizzle, completing on its `full` mbarrier; two consumer
// warpgroups each own 64 rows of the tile and issue wgmma m64n128k16 on
// both operands K-major from shared memory, retiring a stage (its `empty`
// mbarrier, one arrival a warp) once the next stage's wgmmas are issued.
// The bn_relu prologue cannot be done by TMA: each consumer warpgroup
// rewrites its own 64 rows of the A stage in place (relu(a * s + t), zero
// past k), fences the writes to the async proxy and syncs its 128 threads
// before its wgmmas read them (the SS form; no second buffer). The
// epilogue applies the form to the accumulators in registers, stages the
// bf16 tile in shared memory (a padded 272-byte row: conflict-free) and
// stores it as 16-byte vectors, rows past m masked; the partial sums read
// the staged tile one thread a column. While the consumers run the
// epilogue, the producer already loads the next tile's stages. Tried on
// the card and slower or no faster (PERF.md, section 6): two warpgroups taking
// whole tiles in turns so that one's epilogue overlaps the other's
// products (ping-pong); 256-row tiles, two M-blocks a warpgroup; the
// prologue in three warps of a producer warpgroup (too few threads for
// its throughput); 5-8 stages, 32-K stages, two CTAs an SM.

#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace ws {

constexpr int kG9M = 128, kG9N = 128, kG9K = 64, kG9Stages = 4;
constexpr int kG9Threads = 288;  // two consumer warpgroups + a producer warp
constexpr int kG9Half = kG9M * kG9K * 2;        // 16 KB: an A or W stage
constexpr int kG9Stage = 2 * kG9Half;           // 32 KB
constexpr int kG9StLd = kG9N * 2 + 16;          // staging row bytes
constexpr int kG9Staging = 2 * 64 * kG9StLd;    // 34,816
constexpr int kG9Bars = kG9Stages * kG9Stage + kG9Staging;
constexpr int kG9Smem = 1024 + kG9Bars + 2 * kG9Stages * 8;

// the forms beyond common.cuh's kFormPost and kFormBnRelu
constexpr int kFormTanh = 4;
constexpr int kFormF32 = 5;

struct Sm90Args {
  int m, n, k;
  const float* bias;   // kFormPost, kFormF32; kFormTanh without row_bias
  const float* scale;  // kFormPost and kFormBnRelu: the output's affine
  const float* shift;
  const float* a_scale;  // kFormBnRelu: A's affine, (k)
  const float* a_shift;
  __nv_bfloat16* out;  // (m, n), row stride n
  // partial sums of the stored values, or part = null
  float* part;
  const float* mask;  // (m) frame validity, or null: all valid
  int t, seg_len, nseg, slots;
  const float* row_bias;  // kFormTanh: (m / t, n), or null: bias
  float* out_f32;         // kFormF32: (m, n), row stride n
};

// The A operand's tensor maps: kParts K-slices of one product.
template <int kParts>
struct Sm90AMaps {
  CUtensorMap map[kParts];
};

// the partial sums' workspace slots a segment needs (see above)
__host__ __device__ inline int seg_slots(int t, int seg_len) {
  return ((seg_len < t ? seg_len : t) + 62) / 64 + 1;
}

// the sum of v over a 128-thread block (all its threads call it), in a
// fixed order
__device__ __forceinline__ float sum128(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red's last readers are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  return (red[0] + red[1]) + (red[2] + red[3]);
}

template <int kForm, int kParts>
__global__ void __launch_bounds__(kG9Threads, 1)
    gemm_sm90_kernel(const __grid_constant__ Sm90AMaps<kParts> tm_a,
                     const __grid_constant__ CUtensorMap tm_w,
                     const Sm90Args p) {
  static_assert(kForm == kFormPost || kForm == kFormBnRelu ||
                    kForm == kFormTanh || kForm == kFormF32,
                "a gemm form");
  static_assert(kParts == 1 || (kParts == 3 && kForm == kFormPost),
                "three A maps in the post form only");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  unsigned char* const sm = smem_raw + (base - raw);
  // full: the stage's copies landed; empty: both consumers are done with it
  const uint32_t bar_full = base + kG9Bars;
  const uint32_t bar_empty = bar_full + 8 * kG9Stages;
  const int tid = threadIdx.x;
  // the warpgroup index, shuffled so the compiler knows it is warp-uniform
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int ntn = p.n / kG9N;
  const int tiles = ((p.m + kG9M - 1) / kG9M) * ntn;
  const int ktiles = (p.k + kG9K - 1) / kG9K;

  if (tid == 0) {
    for (int s = 0; s < kG9Stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // a lane of each consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp: one thread issues every copy
    if (tid != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / ntn) * kG9M, n0 = (tile % ntn) * kG9N;
      for (int kt = 0; kt < ktiles; ++kt, ++it) {
        const int s = it % kG9Stages;
        if (it >= kG9Stages)
          mbar_wait(bar_empty + 8 * s, ((it / kG9Stages) - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_expect_tx(full, kG9Stage);
        // the A map of K tile kt and its column there (a select, not a
        // dynamic index into the parameter)
        const CUtensorMap* ma = &tm_a.map[0];
        int ka = kt * kG9K;
        if constexpr (kParts == 3) {
          const int kpt = p.k / (3 * kG9K), part = kt / kpt;
          ma = part == 0 ? &tm_a.map[0]
                         : (part == 1 ? &tm_a.map[1] : &tm_a.map[2]);
          ka = (kt - part * kpt) * kG9K;
        }
        tma_load_2d(base + s * kG9Stage, ma, ka, m0, full);
        tma_load_2d(base + s * kG9Stage + kG9Half, &tm_w, kt * kG9K, n0,
                    full);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
  const int wt = tid % 128, warp = wt / 32, lane = tid % 32;
  unsigned char* const stage_out =
      sm + kG9Stages * kG9Stage + wg * 64 * kG9StLd;
  float acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * kG9M, n0 = (tile % ntn) * kG9N;
    for (int kt = 0; kt < ktiles; ++kt, ++it) {
      const int s = it % kG9Stages;
      mbar_wait(bar_full + 8 * s, (it / kG9Stages) & 1);
      const uint32_t a_s = base + s * kG9Stage + wg * 64 * 128;
      const uint32_t w_s = base + s * kG9Stage + kG9Half;
      if constexpr (kForm == kFormBnRelu) {
        // this thread's four 16-byte chunks of the warpgroup's 64 rows: rows
        // wt / 8 + 16 i, physical chunk wt % 8, which holds K columns
        // 8 ((wt % 8) ^ (row % 8)) .. + 8 under the swizzle (row % 8 is
        // the same for all four)
        const int k = kt * kG9K + 8 * ((wt % 8) ^ ((wt / 8) % 8));
        float sc[8], sh[8];
        const bool live = k < p.k;  // k is a multiple of 8, as is p.k
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          const float4 a = live ? __ldg(reinterpret_cast<const float4*>(
                                      p.a_scale + k + e))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 b = live ? __ldg(reinterpret_cast<const float4*>(
                                      p.a_shift + k + e))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          sc[e] = a.x, sc[e + 1] = a.y, sc[e + 2] = a.z, sc[e + 3] = a.w;
          sh[e] = b.x, sh[e + 1] = b.y, sh[e + 2] = b.z, sh[e + 3] = b.w;
        }
        unsigned char* const a_g = sm + (a_s - base);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint4* q = reinterpret_cast<uint4*>(a_g + (wt / 8 + 16 * i) * 128 +
                                              (wt % 8) * 16);
          uint4 v = *q;
          uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x0, x1;
            unpack2(w[e], x0, x1);
            w[e] = pack2(fmaxf(x0 * sc[2 * e] + sh[2 * e], 0.f),
                         fmaxf(x1 * sc[2 * e + 1] + sh[2 * e + 1], 0.f));
          }
          *q = v;
        }
        fence_proxy_async();
        named_sync(1 + wg, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kG9K / 16; ++ks)
        wgmma_m64k16_kk(acc, wgmma_desc(a_s + ks * 32, 16, 1024, 1),
                        wgmma_desc(w_s + ks * 32, 16, 1024, 1),
                        kt > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas have retired
      fence_regs(acc);
      if (kt > 0)
        mbar_arrive_if(bar_empty + 8 * ((it - 1) % kG9Stages), lane == 0);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive_if(bar_empty + 8 * ((it - 1) % kG9Stages), lane == 0);

    const int r0 = 16 * warp + lane / 4;
    if constexpr (kForm == kFormF32) {
      // ---- epilogue: acc + bias, f32 straight from the registers ----
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        const float2 bi = __ldg(reinterpret_cast<const float2*>(p.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + 64 * wg + r0 + 8 * h;
          if (row < p.m)
            *reinterpret_cast<float2*>(p.out_f32 + (size_t)row * p.n + col) =
                make_float2(acc[4 * j + 2 * h] + bi.x,
                            acc[4 * j + 2 * h + 1] + bi.y);
        }
      }
      continue;
    }

    // ---- epilogue: the form in registers, bf16 into the staging tile ----
    named_sync(1 + wg, 128);  // the last tile's readers are done with it
    // kFormTanh: the bias rows of this thread's two rows (r0 and r0 + 8 of
    // the warpgroup's 64): its utterance's context bias, or the column bias;
    // a row past m reads row m - 1's and is not stored
    const float* rb[2] = {p.bias, p.bias};
    if constexpr (kForm == kFormTanh) {
      if (p.row_bias) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = min(m0 + 64 * wg + r0 + 8 * h, p.m - 1);
          rb[h] = p.row_bias + (size_t)(row / p.t) * p.n;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      float2 sc = make_float2(1.f, 1.f), sh = make_float2(0.f, 0.f);
      if constexpr (kForm == kFormPost || kForm == kFormBnRelu) {
        sc = __ldg(reinterpret_cast<const float2*>(p.scale + col));
        sh = __ldg(reinterpret_cast<const float2*>(p.shift + col));
      }
      float2 bi = make_float2(0.f, 0.f);
      if constexpr (kForm == kFormPost)
        bi = __ldg(reinterpret_cast<const float2*>(p.bias + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if constexpr (kForm == kFormPost) {
          v0 = fmaxf(v0 + bi.x, 0.f) * sc.x + sh.x;
          v1 = fmaxf(v1 + bi.y, 0.f) * sc.y + sh.y;
        } else if constexpr (kForm == kFormBnRelu) {
          v0 = fmaxf(v0 * sc.x + sh.x, 0.f);
          v1 = fmaxf(v1 * sc.y + sh.y, 0.f);
        } else {
          const float2 rv =
              __ldg(reinterpret_cast<const float2*>(rb[h] + col));
          v0 = tanhf(v0 + rv.x);
          v1 = tanhf(v1 + rv.y);
        }
        *reinterpret_cast<uint32_t*>(stage_out + (r0 + 8 * h) * kG9StLd +
                                     (8 * j + 2 * (lane % 4)) * 2) =
            pack2(v0, v1);
      }
    }
    named_sync(1 + wg, 128);
    const int row0 = m0 + 64 * wg;
    // 16-byte stores: a warp writes two whole 256-byte rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = wt + 128 * i, r = q / 16, ch = q % 16;
      if (row0 + r < p.m)
        *reinterpret_cast<uint4*>(p.out + (size_t)(row0 + r) * p.n + n0 +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(stage_out + r * kG9StLd + ch * 16);
    }
    if constexpr (kForm != kFormPost && kForm != kFormBnRelu) continue;
    if (p.part && row0 < p.m) {
      // column wt of the unit's rows, one run of rows a segment, in order
      const int unit = row0 / 64, rows = min(64, p.m - row0);
      int b = row0 / p.t, tt = row0 - b * p.t, sg = tt / p.seg_len;
      const __nv_bfloat16* col =
          reinterpret_cast<const __nv_bfloat16*>(stage_out) + wt;
      for (int r = 0; r < rows;) {
        const int run = min(rows - r, min((sg + 1) * p.seg_len, p.t) - tt);
        float sum = 0.f;
#pragma unroll 4
        for (int i = r; i < r + run; ++i)
          sum += __bfloat162float(col[i * (kG9StLd / 2)]) *
                 (p.mask ? __ldg(p.mask + row0 + i) : 1.f);
        const int u0 = (b * p.t + sg * p.seg_len) / 64;
        p.part[((size_t)(b * p.nseg + sg) * p.slots + unit - u0) * p.n + n0 +
               wt] = sum;
        r += run;
        tt += run;
        if (tt == p.t) {
          ++b;
          tt = 0;
          sg = 0;
        } else if (tt == (sg + 1) * p.seg_len) {
          ++sg;
        }
      }
    }
  }
}

inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

// One launch: A (m, k) at row stride lda, or (kParts = 3) A0, A1, A2 each
// (m, k / 3) at row stride lda; wt (n, k) at row stride ldw; all bf16 and
// 16-byte aligned. Requires n % 128 == 0, k % 8 == 0 (k % 192 == 0 for three
// maps: each a whole number of 64-column K tiles), lda and ldw multiples of
// 8 (16-byte rows), and the form's vectors (16-byte aligned) set: scale and
// shift, and bias in the post form, a_scale/a_shift in the bn_relu form;
// row_bias and t > 0, or bias, in the tanh form; bias and out_f32 in the f32
// form. A shape it does not take returns cudaErrorInvalidValue, and nothing
// is launched.
template <int kForm, int kParts>
cudaError_t gemm_sm90_maps(const void* const* a, int lda, const void* wt,
                           int ldw, const Sm90Args& p, cudaStream_t stream) {
  constexpr bool kAffine = kForm == kFormPost || kForm == kFormBnRelu;
  const int kp = p.k / kParts;
  if (p.m <= 0 || p.k <= 0 || p.n % kG9N || p.k % 8 || lda % 8 || ldw % 8 ||
      lda < kp || ldw < p.k ||
      (kParts > 1 && (p.k % kParts || kp % kG9K)) ||
      (kAffine && (!p.scale || !p.shift)) ||
      (kForm == kFormPost && !p.bias) ||
      (kForm == kFormBnRelu && (!p.a_scale || !p.a_shift)) ||
      (kForm == kFormTanh && !(p.row_bias ? p.t > 0 : p.bias != nullptr)) ||
      (kForm == kFormF32 && (!p.bias || !p.out_f32)) ||
      (kForm != kFormF32 && !p.out) ||
      (p.part && (!kAffine || p.t <= 0 || p.seg_len <= 0 ||
                  p.slots < seg_slots(p.t, p.seg_len))))
    return cudaErrorInvalidValue;
  Sm90AMaps<kParts> tm_a;
  CUtensorMap tm_w;
  for (int i = 0; i < kParts; ++i)
    if (!tensor_map_2d_bf16(&tm_a.map[i], a[i], kp, p.m,
                            (unsigned long long)lda * 2, kG9K, kG9M, 128))
      return cudaErrorInvalidValue;
  if (!tensor_map_2d_bf16(&tm_w, wt, p.k, p.n, (unsigned long long)ldw * 2,
                          kG9K, kG9N, 128))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gemm_sm90_kernel<kForm, kParts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kG9Smem);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.m + kG9M - 1) / kG9M) * (p.n / kG9N);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_sm90_kernel<kForm, kParts>
      <<<grid, kG9Threads, kG9Smem, stream>>>(tm_a, tm_w, p);
  return cudaGetLastError();
}

// One A map (every form).
template <int kForm>
cudaError_t gemm_sm90(const void* a, int lda, const void* wt, int ldw,
                      const Sm90Args& p, cudaStream_t stream) {
  return gemm_sm90_maps<kForm, 1>(&a, lda, wt, ldw, p, stream);
}

// Three A maps, K-slices of one product (the post form).
template <int kForm>
cudaError_t gemm_sm90_3(const void* a0, const void* a1, const void* a2,
                        int lda, const void* wt, int ldw, const Sm90Args& p,
                        cudaStream_t stream) {
  const void* a[3] = {a0, a1, a2};
  return gemm_sm90_maps<kForm, 3>(a, lda, wt, ldw, p, stream);
}

}  // namespace ws
