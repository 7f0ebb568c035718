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
// - kFormF32:    v = acc + bias (or acc where bias is null), stored as f32
//                into out_f32 (ASTP's logits), straight from the
//                registers: a warp's store covers 8 rows of 32 contiguous
//                bytes, whole sectors, and needs no staging tile.
// The training tail's backward (mfa_astp_train.cu) adds three, each
// rounded to bf16:
// - kFormTanhGrad: v = acc * (1 - aux^2), aux (m, n) bf16 read per element
//                (the tanh activations: dpre = datt (1 - att^2));
// - kFormReluGrad: v = [aux > 0] (acc + aux_f32 + aux k + c0), aux (m, n)
//                bf16 (h), aux_f32 (m, n) f32 (dh_pool), [k | c0] = coef
//                (m / t, 2n) f32 at each row's own utterance (as the tanh
//                form's row bias; the context terms, mfa_astp_train.cu's
//                ctx_coef_kernel), or v = [aux > 0] (acc + aux_f32) where
//                coef is null;
// - kFormPlain:  v = acc into three outputs side by side: the column tile
//                n0 writes out, out1 or out2 (n0 / n_out), each (m, n_out)
//                at row stride n_out (n_out % 128 == 0 keeps a tile inside
//                one), so one launch over N = 3 n_out makes three tensors.
// Optionally (part != null; the post, bn_relu, tanh_grad and relu_grad
// forms) the epilogue also writes masked partial column sums of the stored
// values (rounded in the post and bn_relu forms; the f32 values before
// their rounding in the two gradient forms, which stage f32) for the
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
constexpr int kG9StLdF = kG9N * 4 + 16;         // the same, f32 staging

// the forms beyond common.cuh's kFormPost and kFormBnRelu
constexpr int kFormTanh = 4;
constexpr int kFormF32 = 5;
constexpr int kFormTanhGrad = 6;
constexpr int kFormReluGrad = 7;
constexpr int kFormPlain = 8;

// the gradient forms stage f32 values (their partial sums are of those)
__host__ __device__ constexpr bool g9_stage_f32(int form) {
  return form == kFormTanhGrad || form == kFormReluGrad;
}
// the staging tile's bytes (34,816, or 67,584 for f32) and the dynamic
// shared memory of a form: the stages, the staging tile, the mbarriers
__host__ __device__ constexpr int g9_staging(int form) {
  return 2 * 64 * (g9_stage_f32(form) ? kG9StLdF : kG9StLd);
}
__host__ __device__ constexpr int g9_smem(int form) {
  return 1024 + kG9Stages * kG9Stage + g9_staging(form) + 2 * kG9Stages * 8;
}

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
  // kFormTanhGrad, kFormReluGrad: aux (m, n) bf16; kFormReluGrad: aux_f32
  // (m, n) f32, and coef (m / t, 2n) f32 or null
  const __nv_bfloat16* aux;
  const float* aux_f32;
  const float* coef;
  // kFormPlain: the outputs of column tiles n_out .. 2 n_out - 1 and
  // 2 n_out .. 3 n_out - 1 (out takes the first n_out columns)
  __nv_bfloat16 *out1, *out2;
  int n_out;
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
                    kForm == kFormTanh || kForm == kFormF32 ||
                    kForm == kFormTanhGrad || kForm == kFormReluGrad ||
                    kForm == kFormPlain,
                "a gemm form");
  constexpr bool kStageF32 = g9_stage_f32(kForm);
  constexpr int kStLd = kStageF32 ? kG9StLdF : kG9StLd;
  static_assert(kParts == 1 || (kParts == 3 && kForm == kFormPost),
                "three A maps in the post form only");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms aligned
  unsigned char* const sm = smem_raw + (base - raw);
  // full: the stage's copies landed; empty: both consumers are done with it
  const uint32_t bar_full = base + kG9Stages * kG9Stage + g9_staging(kForm);
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
      sm + kG9Stages * kG9Stage + wg * 64 * kStLd;
  float acc[64];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * kG9M, n0 = (tile % ntn) * kG9N;
    const int r0 = 16 * warp + lane / 4;
    // the gradient forms' per-element operands, fetched before the tile's
    // products so that their latency hides behind them: aux for this
    // thread's elements into registers and, for kFormReluGrad, the
    // warpgroup's 64 rows of aux_f32 into the staging tile by cp.async
    // (rows clamped past m; such rows are not stored)
    unsigned ar[16][2];
    if constexpr (kStageF32) {
      if constexpr (kForm == kFormReluGrad) {
        named_sync(1 + wg, 128);  // the last tile's readers are done
        const uint32_t st = smem_u32(stage_out);
#pragma unroll 4
        for (int q = wt; q < 64 * 32; q += 128) {
          const int row = min(m0 + 64 * wg + q / 32, p.m - 1);
          cp_async16(st + (q / 32) * kStLd + (q % 32) * 16,
                     p.aux_f32 + (size_t)row * p.n + n0 + (q % 32) * 4);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = min(m0 + 64 * wg + r0 + 8 * h, p.m - 1);
        const unsigned* a = reinterpret_cast<const unsigned*>(
            p.aux + (size_t)row * p.n + n0 + 2 * (lane % 4));
#pragma unroll
        for (int j = 0; j < 16; ++j) ar[j][h] = __ldg(a + 4 * j);
      }
    }
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

    if constexpr (kForm == kFormF32) {
      // ---- epilogue: acc + bias, f32 straight from the registers ----
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
        const float2 bi =
            p.bias ? __ldg(reinterpret_cast<const float2*>(p.bias + col))
                   : make_float2(0.f, 0.f);
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

    // ---- epilogue: the form in registers, into the staging tile (bf16,
    // or f32 for the gradient forms) ----
    if constexpr (kForm == kFormReluGrad) cp_async_wait_all();
    // the last tile's readers are done with the staging tile (and, for
    // kFormReluGrad, every thread's copies into it have landed)
    named_sync(1 + wg, 128);
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
    // the gradient forms, from the operands fetched before the products;
    // kFormReluGrad adds its rows' utterances' context coefficients and
    // writes v over aux_f32 in the staging tile (each element read and
    // written by the same thread)
    if constexpr (kStageF32) {
      const float* coef_row[2] = {nullptr, nullptr};
      if constexpr (kForm == kFormReluGrad) {
        if (p.coef) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            coef_row[h] = p.coef + (size_t)(min(m0 + 64 * wg + r0 + 8 * h,
                                                p.m - 1) /
                                            p.t) *
                                       2 * p.n;
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a0, a1;
          unpack2(ar[j][h], a0, a1);
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          float2* sv = reinterpret_cast<float2*>(
              stage_out + (r0 + 8 * h) * kStLd + (8 * j + 2 * (lane % 4)) *
                                                     4);
          if constexpr (kForm == kFormTanhGrad) {
            v0 *= 1.f - a0 * a0;
            v1 *= 1.f - a1 * a1;
          } else {
            const float2 dp = *sv;
            v0 += dp.x;
            v1 += dp.y;
            if (coef_row[h]) {
              const float2 k =
                  __ldg(reinterpret_cast<const float2*>(coef_row[h] + col));
              const float2 c = __ldg(
                  reinterpret_cast<const float2*>(coef_row[h] + p.n + col));
              v0 += a0 * k.x + c.x;
              v1 += a1 * k.y + c.y;
            }
            v0 = a0 > 0.f ? v0 : 0.f;
            v1 = a1 > 0.f ? v1 : 0.f;
          }
          *sv = make_float2(v0, v1);
        }
      }
    }
    if constexpr (!kStageF32) {
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
          } else if constexpr (kForm == kFormTanh) {
            const float2 rv =
                __ldg(reinterpret_cast<const float2*>(rb[h] + col));
            v0 = tanhf(v0 + rv.x);
            v1 = tanhf(v1 + rv.y);
          }
          *reinterpret_cast<uint32_t*>(stage_out + (r0 + 8 * h) * kStLd +
                                       (8 * j + 2 * (lane % 4)) * 2) =
              pack2(v0, v1);
        }
      }
    }
    named_sync(1 + wg, 128);
    const int row0 = m0 + 64 * wg;
    // the output of this column tile: kFormPlain picks one of three
    __nv_bfloat16* dst = p.out;
    int ldo = p.n, c0 = n0;
    if constexpr (kForm == kFormPlain) {
      const int o = n0 / p.n_out;
      dst = o == 0 ? p.out : (o == 1 ? p.out1 : p.out2);
      ldo = p.n_out;
      c0 = n0 - o * p.n_out;
    }
    // 16-byte stores: a warp writes two whole 256-byte rows
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = wt + 128 * i, r = q / 16, ch = q % 16;
      uint4 v;
      if constexpr (kStageF32) {
        const float4* f =
            reinterpret_cast<const float4*>(stage_out + r * kStLd + ch * 32);
        const float4 lo = f[0], hi = f[1];
        v = make_uint4(pack2(lo.x, lo.y), pack2(lo.z, lo.w), pack2(hi.x, hi.y),
                       pack2(hi.z, hi.w));
      } else {
        v = *reinterpret_cast<const uint4*>(stage_out + r * kStLd + ch * 16);
      }
      if (row0 + r < p.m)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * ldo + c0 +
                                  ch * 8) = v;
    }
    if constexpr (kForm != kFormPost && kForm != kFormBnRelu && !kStageF32)
      continue;
    if (p.part && row0 < p.m) {
      // column wt of the unit's rows, one run of rows a segment, in order
      const int unit = row0 / 64, rows = min(64, p.m - row0);
      int b = row0 / p.t, tt = row0 - b * p.t, sg = tt / p.seg_len;
      // the staged value of row i in column wt
      auto staged = [&](int i) {
        if constexpr (kStageF32)
          return reinterpret_cast<const float*>(stage_out + i * kStLd)[wt];
        else
          return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
              stage_out + i * kStLd)[wt]);
      };
      for (int r = 0; r < rows;) {
        const int run = min(rows - r, min((sg + 1) * p.seg_len, p.t) - tt);
        float sum = 0.f;
#pragma unroll 4
        for (int i = r; i < r + run; ++i)
          sum += staged(i) * (p.mask ? __ldg(p.mask + row0 + i) : 1.f);
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

// One launch: A (m, k) at row stride lda, or (kParts = 3) A0, A1, A2 each
// (m, k / 3) at row stride lda; wt (n, k) at row stride ldw; all bf16 and
// 16-byte aligned. Requires n % 128 == 0, k % 8 == 0 (k % 192 == 0 for three
// maps: each a whole number of 64-column K tiles), lda and ldw multiples of
// 8 (16-byte rows), and the form's vectors (16-byte aligned) set: scale and
// shift, and bias in the post form, a_scale/a_shift in the bn_relu form;
// row_bias and t > 0, or bias, in the tanh form; out_f32 in the f32 form;
// aux and t > 0 in the gradient forms, aux_f32 in the relu_grad form;
// out1, out2 and n = 3 n_out, n_out % 128 == 0, in the plain form. A shape
// it does not take returns cudaErrorInvalidValue, and nothing is launched.
template <int kForm, int kParts>
cudaError_t gemm_sm90_maps(const void* const* a, int lda, const void* wt,
                           int ldw, const Sm90Args& p, cudaStream_t stream) {
  constexpr bool kAffine = kForm == kFormPost || kForm == kFormBnRelu;
  constexpr bool kSums = kAffine || g9_stage_f32(kForm);
  const int kp = p.k / kParts;
  if (p.m <= 0 || p.k <= 0 || p.n % kG9N || p.k % 8 || lda % 8 || ldw % 8 ||
      lda < kp || ldw < p.k ||
      (kParts > 1 && (p.k % kParts || kp % kG9K)) ||
      (kAffine && (!p.scale || !p.shift)) ||
      (kForm == kFormPost && !p.bias) ||
      (kForm == kFormBnRelu && (!p.a_scale || !p.a_shift)) ||
      (kForm == kFormTanh && !(p.row_bias ? p.t > 0 : p.bias != nullptr)) ||
      (kForm == kFormF32 && !p.out_f32) ||
      (kForm != kFormF32 && !p.out) ||
      (g9_stage_f32(kForm) && (!p.aux || p.t <= 0)) ||
      (kForm == kFormReluGrad && !p.aux_f32) ||
      (kForm == kFormPlain &&
       (!p.out1 || !p.out2 || p.n_out <= 0 || p.n_out % kG9N ||
        p.n != 3 * p.n_out)) ||
      (p.part && (!kSums || p.t <= 0 || p.seg_len <= 0 ||
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
  constexpr int kSmem = g9_smem(kForm);
  cudaError_t err = cudaFuncSetAttribute(
      gemm_sm90_kernel<kForm, kParts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int tiles = ((p.m + kG9M - 1) / kG9M) * (p.n / kG9N);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_sm90_kernel<kForm, kParts>
      <<<grid, kG9Threads, kSmem, stream>>>(tm_a, tm_w, p);
  ++gemm_route_counts()[kRouteSm90];
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
