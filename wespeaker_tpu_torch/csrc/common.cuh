// Pieces shared by the SE-Res2 block, the MFA+ASTP tail, the CAM++ dense
// block and the Gemini stage kernels.
//
// - gemm: C[M, N] = epilogue(sum_p A_p[M, Kp] @ W[p*Kp:(p+1)*Kp, N]) with up
//   to three A operands read as K-slices of one product (a concat that is
//   never materialised), each with a row stride lda >= Kp (the live prefix
//   of a wider map). bf16 runs on the tensor cores through WMMA
//   (16x16x16 bf16 fragments, f32 accumulation); f32 runs on the CUDA cores
//   with FMA, so it stays exact f32 (no TF32). The epilogue adds a column
//   bias and/or a per-utterance row bias, applies relu/tanh/sigmoid and an
//   optional per-column affine (folded BatchNorm), and stores in the output
//   type. In the bn_relu form (the CAM++ bottleneck) A is turned into
//   relu(A * a_scale + a_shift) per K column, rounded to the operand type,
//   as it is loaded, and the epilogue applies the affine before the
//   activation: BatchNorm + relu on both sides of the product. Two more
//   forms serve the Gemini stage: relu(acc * scale + shift), and
//   relu(acc * scale + shift + res) with a residual res (m, n) in the output
//   type, which may be the output itself (each element is read, then
//   written, by the same thread). The form and the block's column count
//   (128, or 64 and 32 for narrow outputs) are template parameters, so no
//   GEMM compiles another's branches. The grid is one-dimensional, column
//   tiles fastest, so any m < 2^31 launches.
// - col_stats: masked mean (and ddof-adjusted std + 1e-7) over T of
//   (B, T, C), one thread per (utterance, channel), output in any type at
//   any row stride.
// - softmax_stats: ASTP's softmax over T and the weighted mean and std,
//   logits in f32 or bf16, in one streamed pass (row 6).
// - gemm_tn: C[M, N] = A^T B with A (K, M) and B (K, N) row-major f32, the
//   weight-gradient product whose reduction runs over K = B*T rows, on the
//   CUDA cores (bf16 runs on gemm_tn_sm90.cuh). K is split across blocks
//   (split-K); each split writes its f32 partial to a workspace and a
//   second pass sums the splits in a fixed order, so the result does not
//   depend on the order blocks run in (no float atomics).
// - col_sum: f32 column sums of a (rows, n) matrix, rows in order.
//
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each host launcher returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace ws {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

enum Act { kNone = 0, kRelu = 1, kTanh = 2, kSigmoid = 3 };

// Epilogue (and prologue) forms of gemm, template parameters of the kernels.
enum Form {
  kFormPost = 0,        // bias / row bias, activation, then the affine
  kFormBnRelu = 1,      // A prologue relu(A * a_scale + a_shift); affine, act
  kFormAffineRelu = 2,  // relu(acc * scale + shift)
  kFormAffineResRelu = 3,  // relu(acc * scale + shift + res)
};

struct GemmArgs {
  const void* a[3];  // A operands, each (m, kp) row-major with row stride lda
  int nparts;
  int kp;
  int lda;
  const void* w;  // (nparts * kp, n) row-major
  void* out;      // (m, n) row-major
  int m;
  int n;
  const float* bias;      // (n) or null
  const float* row_bias;  // (m / rows_per_group, n) or null
  int rows_per_group;
  int act;
  const float* scale;  // (n) or null; with shift: v * scale + shift
  const float* shift;
  // the bn_relu form: A's affine a_scale, a_shift (nparts * kp) and the
  // output's scale, shift are all set; bias is not
  int bn_relu;
  const float* a_scale;
  const float* a_shift;
  const void* res;  // kFormAffineResRelu: (m, n) in the output type
};

template <typename OutT, int kForm>
__device__ __forceinline__ float epilogue(const GemmArgs& p, int row, int col,
                                          float acc) {
  if constexpr (kForm == kFormAffineRelu || kForm == kFormAffineResRelu) {
    float v = acc * p.scale[col] + p.shift[col];
    if constexpr (kForm == kFormAffineResRelu)
      v += to_f(static_cast<const OutT*>(p.res)[(size_t)row * p.n + col]);
    return fmaxf(v, 0.f);
  }
  constexpr bool kBnRelu = kForm == kFormBnRelu;
  float v = acc;
  if (kBnRelu) v = v * p.scale[col] + p.shift[col];
  if (p.bias) v += p.bias[col];
  if (p.row_bias)
    v += p.row_bias[(size_t)(row / p.rows_per_group) * p.n + col];
  if (p.act == kRelu) {
    v = fmaxf(v, 0.f);
  } else if (p.act == kTanh) {
    v = tanhf(v);
  } else if (p.act == kSigmoid) {
    v = 1.f / (1.f + expf(-v));
  }
  if (!kBnRelu && p.scale) v = v * p.scale[col] + p.shift[col];
  return v;
}

// The bn_relu form's A prologue on 8 bf16 values of K columns k..k+7, one
// 16-byte vector: relu(a * a_scale + a_shift), rounded to bf16.
__device__ __forceinline__ uint4 prologue8(const GemmArgs& p, int k, uint4 v) {
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    e[i] = __float2bfloat16(
        fmaxf(__bfloat162float(e[i]) * p.a_scale[k + i] + p.a_shift[k + i],
              0.f));
  return v;
}

// A select, not a dynamic index into p.a, keeps the kernel argument out of
// local memory.
__device__ __forceinline__ const void* part_ptr(const GemmArgs& p, int part) {
  return part == 0 ? p.a[0] : (part == 1 ? p.a[1] : p.a[2]);
}

// ---- f32 GEMM on the CUDA cores: 128 x kBN block tile, 8 x kBN/16 per
//      thread ----

constexpr int kFBM = 128, kFBN = 128, kFBK = 16;

template <typename OutT, int kForm, int kBN>
__global__ void __launch_bounds__(256) gemm_fma_kernel(GemmArgs p) {
  constexpr bool kBnRelu = kForm == kFormBnRelu;
  constexpr int kTN = kBN / 16;  // columns per thread
  __shared__ float as[kFBK][kFBM + 4];
  __shared__ float bs[kFBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int ntn = p.n / kBN;
  const int row0 = (int)(blockIdx.x / ntn) * kFBM;
  const int col0 = (int)(blockIdx.x % ntn) * kBN;
  const int k_total = p.nparts * p.kp;
  const float* w = static_cast<const float*>(p.w);
  float acc[8][kTN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kFBK) {
    const int part = k0 / p.kp;
    const int kk0 = k0 - part * p.kp;
    const float* a = static_cast<const float*>(part_ptr(p, part));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * 256;
      const int r = idx / kFBK, kk = idx % kFBK;
      const int grow = row0 + r;
      float v = 0.f;
      if (grow < p.m) {
        v = a[(size_t)grow * p.lda + kk0 + kk];
        if (kBnRelu)
          v = fmaxf(v * p.a_scale[k0 + kk] + p.a_shift[k0 + kk], 0.f);
      }
      as[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < kTN; ++i) {
      const int idx = tid + i * 256;
      const int kk = idx / kBN, c = idx % kBN;
      bs[kk][c] = w[(size_t)(k0 + kk) * p.n + col0 + c];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float av[8], bv[kTN];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  OutT* out = static_cast<OutT*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = col0 + tx + 16 * j;
      out[(size_t)row * p.n + col] =
          from_f<OutT>(epilogue<OutT, kForm>(p, row, col, acc[i][j]));
    }
  }
}

// ---- bf16 GEMM on the tensor cores (WMMA): 128 x kBN x 32 block tile,
//      8 warps as 4 x 2, each warp 32 x kBN/2 = 2 x kBN/32 fragments ----

constexpr int kWBM = 128, kWBN = 128, kWBK = 32;
constexpr int kALd = kWBK + 8;  // bf16 elements; multiple of 8 for WMMA
constexpr int kBLd = kWBN + 8;

template <typename OutT, int kForm, int kBN>
__global__ void __launch_bounds__(256) gemm_wmma_kernel(GemmArgs p) {
  using namespace nvcuda;
  constexpr bool kBnRelu = kForm == kFormBnRelu;
  constexpr int kFN = kBN / 32;  // fragments per warp along N
  constexpr int kLd = kBN + 8;
  constexpr int kWChunks = kWBK * kBN / 8;  // 16-byte chunks of a W tile
  __shared__ __align__(32) __nv_bfloat16 as[kWBM * kALd];
  __shared__ __align__(32) __nv_bfloat16 bs[kWBK * kLd];
  __shared__ __align__(32) float cs[8][16 * 16];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp / 2, wc = warp % 2;
  const int ntn = p.n / kBN;
  const int row0 = (int)(blockIdx.x / ntn) * kWBM;
  const int col0 = (int)(blockIdx.x % ntn) * kBN;
  const int k_total = p.nparts * p.kp;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFN];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k_total; k0 += kWBK) {
    const int part = k0 / p.kp;
    const int kk0 = k0 - part * p.kp;
    const __nv_bfloat16* a =
        static_cast<const __nv_bfloat16*>(part_ptr(p, part));
    // A tile: 128 rows x 4 chunks of 8 bf16 (16 bytes)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * 256;
      const int r = idx / 4, ch = idx % 4;
      const int grow = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (grow < p.m) {
        v = *reinterpret_cast<const uint4*>(a + (size_t)grow * p.lda + kk0 +
                                            ch * 8);
        if (kBnRelu) v = prologue8(p, k0 + ch * 8, v);
      }
      *reinterpret_cast<uint4*>(&as[r * kALd + ch * 8]) = v;
    }
    // W tile: 32 rows x kBN/8 chunks of 8 bf16
#pragma unroll
    for (int i = 0; i < (kWChunks + 255) / 256; ++i) {
      const int idx = tid + i * 256;
      if (kWChunks % 256 == 0 || idx < kWChunks) {
        const int r = idx / (kBN / 8), ch = idx % (kBN / 8);
        *reinterpret_cast<uint4*>(&bs[r * kLd + ch * 8]) =
            *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * p.n +
                                            col0 + ch * 8);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[kFN];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], &as[(wr * 32 + i * 16) * kALd + kk],
                               kALd);
#pragma unroll
      for (int j = 0; j < kFN; ++j)
        wmma::load_matrix_sync(bf[j],
                               &bs[kk * kLd + wc * (kBN / 2) + j * 16], kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kFN; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  OutT* out = static_cast<OutT*>(p.out);
  float* c = cs[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < kFN; ++j) {
      wmma::store_matrix_sync(c, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = row0 + wr * 32 + i * 16 + e / 16;
        const int col = col0 + wc * (kBN / 2) + j * 16 + e % 16;
        if (row < p.m)
          out[(size_t)row * p.n + col] =
              from_f<OutT>(epilogue<OutT, kForm>(p, row, col, c[e]));
      }
      __syncwarp();
    }
  }
}

// The GEMM kernels launched so far in this library, counted on the host
// where each launch is made: [gemm_sm90, gemm_tn_sm90, WMMA, FMA]. Each
// library compiles its own copy; ws_gemm_route_counts reads it, so a test
// can tell which GEMM a call took without a profiler.
enum GemmRoute { kRouteSm90 = 0, kRouteTnSm90 = 1, kRouteWmma = 2,
                 kRouteFma = 3, kRoutes = 4 };
inline long long* gemm_route_counts() {
  static long long counts[kRoutes] = {0, 0, 0, 0};
  return counts;
}

// One launch of the GEMM kernel for operand type T in the given form and
// column tile; checks the sizes every form shares.
template <typename T, typename OutT, int kForm, int kBN>
cudaError_t gemm_launch(const GemmArgs& p, cudaStream_t stream) {
  if (p.n % kBN || p.kp % 32 || p.lda < p.kp || p.lda % 8 || p.m <= 0 ||
      p.nparts < 1 || p.nparts > 3)
    return cudaErrorInvalidValue;
  const long long blocks = (long long)((p.m + 127) / 128) * (p.n / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    gemm_wmma_kernel<OutT, kForm, kBN><<<grid, 256, 0, stream>>>(p);
    ++gemm_route_counts()[kRouteWmma];
  } else {
    static_assert(std::is_same<T, float>::value, "f32 or bf16 operands");
    gemm_fma_kernel<OutT, kForm, kBN><<<grid, 256, 0, stream>>>(p);
    ++gemm_route_counts()[kRouteFma];
  }
  return cudaGetLastError();
}

// T: operand type (float or __nv_bfloat16); OutT: output type. The post
// form, or the bn_relu form when p.bn_relu is set.
// Requires n % 128 == 0, kp % 32 == 0 and lda % 8 == 0 (checked here and by
// the Python wrappers, which only pass the model's widths).
template <typename T, typename OutT>
cudaError_t gemm(const GemmArgs& p, cudaStream_t stream) {
  if (p.bn_relu) return gemm_launch<T, OutT, kFormBnRelu, 128>(p, stream);
  return gemm_launch<T, OutT, kFormPost, 128>(p, stream);
}

// The affine-relu forms (kFormAffineRelu, kFormAffineResRelu), output in
// the operand type: relu(acc * scale + shift [+ res]). n a multiple of 32;
// the column tile is the widest of 128, 64 and 32 that divides n.
template <typename T, int kForm>
cudaError_t gemm_affine_relu(const GemmArgs& p, cudaStream_t stream) {
  static_assert(kForm == kFormAffineRelu || kForm == kFormAffineResRelu,
                "an affine-relu form");
  if (!p.scale || !p.shift || (kForm == kFormAffineResRelu && !p.res))
    return cudaErrorInvalidValue;
  if (p.n % 128 == 0) return gemm_launch<T, T, kForm, 128>(p, stream);
  if (p.n % 64 == 0) return gemm_launch<T, T, kForm, 64>(p, stream);
  return gemm_launch<T, T, kForm, 32>(p, stream);
}

inline GemmArgs gemm_args(const void* a0, const void* a1, const void* a2,
                          int nparts, int kp, const void* w, void* out, int m,
                          int n, int act) {
  GemmArgs p{};
  p.a[0] = a0;
  p.a[1] = a1;
  p.a[2] = a2;
  p.nparts = nparts;
  p.kp = kp;
  p.lda = kp;
  p.w = w;
  p.out = out;
  p.m = m;
  p.n = n;
  p.act = act;
  p.rows_per_group = 1;
  return p;
}

// ---- masked mean / std over T ----

// h: (b, t, c); mask: (b, t) f32 or null. Utterance i's mean starts at
// mean_out + i * ld and its std at std_out + i * ld (ld 0: c), in TO.
// mean = sum(h * m) / max(sum(m), 1)   (plain mean over t when unmasked)
// std  = sqrt(sum((h - mean)^2 * m) / max(count - ddof, 1) + 1e-7)
template <typename T, typename TO>
__global__ void col_stats_kernel(const T* __restrict__ h,
                                 const float* __restrict__ mask,
                                 TO* __restrict__ mean_out,
                                 TO* __restrict__ std_out, int t, int c,
                                 int ld, int ddof) {
  const int b = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  const T* hb = h + (size_t)b * t * c + col;
  const float* mb = mask ? mask + (size_t)b * t : nullptr;
  float s = 0.f, cnt = 0.f;
  for (int i = 0; i < t; ++i) {
    const float m = mb ? mb[i] : 1.f;
    s += to_f(hb[(size_t)i * c]) * m;
    cnt += m;
  }
  const float mean = s / (mb ? fmaxf(cnt, 1.f) : (float)t);
  mean_out[(size_t)b * ld + col] = from_f<TO>(mean);
  if (!std_out) return;
  float q = 0.f;
  for (int i = 0; i < t; ++i) {
    const float m = mb ? mb[i] : 1.f;
    const float dv = to_f(hb[(size_t)i * c]) - mean;
    q += dv * dv * m;
  }
  const float count = mb ? cnt : (float)t;
  std_out[(size_t)b * ld + col] =
      from_f<TO>(sqrtf(q / fmaxf(count - (float)ddof, 1.f) + 1e-7f));
}

// TO is deduced from mean_out alone, so std_out may be nullptr.
template <typename X>
struct non_deduced {
  using type = X;
};

template <typename T, typename TO>
cudaError_t col_stats(const T* h, const float* mask, TO* mean_out,
                      typename non_deduced<TO>::type* std_out, int b, int t,
                      int c, cudaStream_t stream, int ddof = 1, int ld = 0) {
  const dim3 grid((c + 127) / 128, b);
  col_stats_kernel<T, TO><<<grid, 128, 0, stream>>>(
      h, mask, mean_out, std_out, t, c, ld ? ld : c, ddof);
  return cudaGetLastError();
}

// ---- ASTP softmax over T and weighted stats (row 6) ----
//
// Softmax over T per (utterance, channel) of the logits (TL: f32, or bf16
// where the caller computed them in bf16) and the weighted mean and std of
// h, in one pass over T. A thread owns kC = 8 / sizeof(TL) channels of one
// utterance (4 with bf16 logits, 2 with f32) and reads them with one 8-byte
// load of logits and one of kC values of h a frame, streamed past L1 with
// a 256-byte L2 prefetch, kSmFrames frames in flight. It keeps an online
// softmax: a running max m and s = sum e, s1 = sum e h, s2 = sum e h^2 with
// e = exp(a - m), in base 2 (a = logit log2(e), e = exp2(a - m): one
// exp2 a value); each batch of frames takes its max first and rescales the
// three sums once by exp2(m_old - m_new), so the logits and h are read once.
// An item is (utterance, 32 consecutive kC-channel columns), so a warp
// reads 256 contiguous bytes of logits a frame; `tw` warps split an item's
// frames (warp j takes frames j, j + tw, ...) only where the items alone do
// not fill the card (as row 7's masked stats), and their (m, s, s1, s2)
// merge by the same rescaling in warp order, so the result does not depend
// on scheduling. The grid is 1-D: any b * ceil(d / (32 kC)) < 2^31. Masked
// frames (mask may be null) take the logit -1e30, as in the JAX kernel, so
// an utterance with no valid frame gets uniform weights. Any d: where d is
// no multiple of kC (or a base is not 16-byte aligned) each value is
// loaded alone. out: (b, 2d) f32 [mean | sqrt(max(E[h^2] - mean^2,
// 1e-7))], the raw sums as the JAX kernel takes them (no shift).
// ops/pooling.py::softmax_plan mirrors the item and warp split.
constexpr int kSmWarps = 8;
// frames a batch, in flight a thread (vector path). Timed on the H100 at
// ReDimNetB2's shape, batches of 16 took 0.240 ms against 0.258 with f32
// logits but 0.185 against 0.160 with bf16; one batch size for both keeps
// bf16 logits and their f32 copy to the same bits.
constexpr int kSmFrames = 8;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, typename TL, bool kAligned>
__global__ void __launch_bounds__(32 * kSmWarps)
    softmax_stats_kernel(const TL* __restrict__ logits,
                         const T* __restrict__ h,
                         const float* __restrict__ mask,
                         float* __restrict__ out, int b, int t, int d,
                         int chunks, int tw) {
  constexpr int kC = 8 / sizeof(TL);
  constexpr int kU = kAligned ? kSmFrames : 4;  // frames a batch
  __shared__ float parts[kSmWarps][4][kC][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * (kSmWarps / tw) + warp / tw;
  const int j = warp % tw;  // this warp's share of the item's frames
  const int bi = item / chunks;
  const int c0 = ((item % chunks) * 32 + lane) * kC;
  const bool live = bi < b && c0 < d;
  const size_t off = live ? (size_t)bi * t * d + c0 : 0;
  const TL* lb = logits + off;
  const T* hb = h + off;
  const float* mb = mask ? mask + (live ? (size_t)bi * t : 0) : nullptr;
  float m[kC], s[kC], s1[kC], s2[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    m[c] = -3.0e38f;  // below any logit, masked ones included
    s[c] = s1[c] = s2[c] = 0.f;
  }
  for (int f0 = j; f0 < t; f0 += tw * kU) {
    // a batch: frames f0 + u tw; a frame past t takes -3e38 (e = 0)
    float a[kU][kC], x[kU][kC];
    if constexpr (kAligned) {
      uint4 rl[kU], rx[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int f = f0 + u * tw;
        rl[u] = rx[u] = make_uint4(0u, 0u, 0u, 0u);
        if (live && f < t) {
          rl[u] = ld_stream<8>(lb + (size_t)f * d);
          rx[u] = ld_stream<(int)(kC * sizeof(T))>(hb + (size_t)f * d);
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int f = f0 + u * tw;
        const bool valid = f < t, masked = valid && mb && !(mb[f] > 0.f);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const float lv = to_f(reinterpret_cast<const TL*>(&rl[u])[c]);
          a[u][c] = valid ? (masked ? -1e30f : lv * kLog2e) : -3.0e38f;
          x[u][c] = to_f(reinterpret_cast<const T*>(&rx[u])[c]);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int f = f0 + u * tw;
        const bool valid = f < t, masked = valid && mb && !(mb[f] > 0.f);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const bool in = live && valid && c0 + c < d;
          const size_t o = (size_t)f * d + c;
          a[u][c] = valid ? (masked ? -1e30f
                                    : (in ? to_f(lb[o]) * kLog2e : 0.f))
                          : -3.0e38f;
          x[u][c] = in ? to_f(hb[o]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float mx = m[c];
#pragma unroll
      for (int u = 0; u < kU; ++u) mx = fmaxf(mx, a[u][c]);
      const float sc = exp2f(m[c] - mx);
      s[c] *= sc;
      s1[c] *= sc;
      s2[c] *= sc;
      m[c] = mx;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float e = exp2f(a[u][c] - mx), eh = e * x[u][c];
        s[c] += e;
        s1[c] += eh;
        s2[c] = fmaf(eh, x[u][c], s2[c]);
      }
    }
  }
  if (tw > 1) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      parts[warp][0][c][lane] = m[c];
      parts[warp][1][c][lane] = s[c];
      parts[warp][2][c][lane] = s1[c];
      parts[warp][3][c][lane] = s2[c];
    }
    __syncthreads();
    if (j != 0) return;
    // the item's tw parts, in warp order (a part with no frame has s = 0)
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      for (int q = 1; q < tw; ++q) {
        const float mq = parts[warp + q][0][c][lane];
        const float mx = fmaxf(m[c], mq);
        const float sa = exp2f(m[c] - mx), sb = exp2f(mq - mx);
        s[c] = s[c] * sa + parts[warp + q][1][c][lane] * sb;
        s1[c] = s1[c] * sa + parts[warp + q][2][c][lane] * sb;
        s2[c] = s2[c] * sa + parts[warp + q][3][c][lane] * sb;
        m[c] = mx;
      }
    }
  }
  if (!live) return;
  float* ob = out + (size_t)bi * 2 * d + c0;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (!kAligned && c0 + c >= d) break;
    const float mean = s1[c] / s[c];
    const float var = s2[c] / s[c] - mean * mean;
    ob[c] = mean;
    ob[d + c] = sqrtf(fmaxf(var, 1e-7f));
  }
}

// The current device's SMs, read once a device (132 on an H100 SXM, taken
// where the query fails): each launcher runs with its tensors' device
// current (ops/_build.py::on_device), so replicas on cards of two kinds
// each get their own count. device.py::sm_count gives the Python mirrors
// the same count.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int counts[kMaxDevices] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  if (counts[dev] == 0) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = v > 0 ? v : 132;
  }
  return counts[dev];
}

// tw, the warps an item's frames are split over: 1 where the items fill
// the card twice over (sms SMs x 32 warps x 2), else doubled until they do,
// up to kSmWarps, while a warp keeps more than one batch of frames.
inline int softmax_stats_tw(long long items, int t, int sms) {
  int tw = 1;
  while (tw < kSmWarps && items * tw < 2LL * sms * 32 && t > kSmFrames * tw)
    tw *= 2;
  return tw;
}

template <typename T, typename TL>
cudaError_t softmax_stats(const TL* logits, const T* h, const float* mask,
                          float* out, int b, int t, int d,
                          cudaStream_t stream) {
  constexpr int kC = 8 / sizeof(TL);
  if (b <= 0 || t <= 0 || d <= 0) return cudaErrorInvalidValue;
  const int chunks = ((d + kC - 1) / kC + 31) / 32;
  const long long items = (long long)b * chunks;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int tw = softmax_stats_tw(items, t, sm_count());
  const long long blocks = (items + kSmWarps / tw - 1) / (kSmWarps / tw);
  const bool aligned = d % kC == 0 &&
                       reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(h) % 16 == 0;
  auto launch = [&](auto kernel) {
    kernel<<<(unsigned)blocks, 32 * kSmWarps, 0, stream>>>(
        logits, h, mask, out, b, t, d, chunks, tw);
  };
  if (aligned)
    launch(softmax_stats_kernel<T, TL, true>);
  else
    launch(softmax_stats_kernel<T, TL, false>);
  return cudaGetLastError();
}

// ---- A^T B with split-K over the rows (weight gradients) ----

struct GemmTnArgs {
  const void* a;  // (k, m) row-major
  const void* b;  // (k, n) row-major
  float* work;    // (splits, m, n) f32 partial sums
  int m;
  int n;
  int k;
  int kc;  // rows of K per split, a multiple of 32
};

// f32 on the CUDA cores (exact f32, no TF32), 8x8 outputs per thread.
__global__ void __launch_bounds__(256) gemm_tn_fma_kernel(GemmTnArgs p) {
  __shared__ float as[kFBK][kFBM + 4];
  __shared__ float bs[kFBK][kFBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kFBM, col0 = blockIdx.x * kFBN;
  const int kbeg = blockIdx.z * p.kc;
  const int kend = min(kbeg + p.kc, p.k);
  const float* a = static_cast<const float*>(p.a);
  const float* b = static_cast<const float*>(p.b);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kFBK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * 256;
      const int kk = idx / kFBM, r = idx % kFBM;
      const int gk = k0 + kk;
      const bool in_k = gk < kend;
      as[kk][r] = (in_k && row0 + r < p.m)
                      ? a[(size_t)gk * p.m + row0 + r] : 0.f;
      bs[kk][r] = in_k ? b[(size_t)gk * p.n + col0 + r] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = p.work + (size_t)blockIdx.z * p.m * p.n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      out[(size_t)row * p.n + col0 + tx + 16 * j] = acc[i][j];
  }
}

// out[i] = sum over z of work[z][i], z in order: the same sum every run.
__global__ void splitk_reduce_kernel(const float* __restrict__ work,
                                     float* __restrict__ out, int splits,
                                     size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += work[(size_t)z * mn + i];
  out[i] = s;
}

// Splits of K: enough blocks for two per SM on 132 SMs, each split a
// multiple of the 32-row K tile. Writes the rows per split to *kc.
inline int gemm_tn_splits(int m, int n, int k, int* kc) {
  const int tiles = ((m + 127) / 128) * (n / 128);
  const int ktiles = (k + 31) / 32;
  int splits = (264 + tiles - 1) / tiles;
  if (splits > ktiles) splits = ktiles;
  if (splits < 1) splits = 1;
  const int rows = ((ktiles + splits - 1) / splits) * 32;
  if (kc) *kc = rows;
  return (k + rows - 1) / rows;
}

// f32 elements of workspace gemm_tn needs for these sizes.
inline size_t gemm_tn_workspace(int m, int n, int k) {
  return (size_t)gemm_tn_splits(m, n, k, nullptr) * m * n;
}

// out (m, n) f32 = a^T b, a (k, m) and b (k, n) f32. Requires n % 128 == 0
// and m % 8 == 0; work holds work_elems floats. (bf16 runs on
// gemm_tn_sm90.cuh.)
inline cudaError_t gemm_tn(const float* a, const float* b, float* out, int m,
                           int n, int k, float* work, size_t work_elems,
                           cudaStream_t stream) {
  if (n % 128 || m % 8 || m <= 0 || k <= 0) return cudaErrorInvalidValue;
  GemmTnArgs p{a, b, work, m, n, k, 0};
  const int splits = gemm_tn_splits(m, n, k, &p.kc);
  if ((size_t)splits * m * n > work_elems) return cudaErrorInvalidValue;
  const dim3 grid(n / 128, (m + 127) / 128, splits);
  gemm_tn_fma_kernel<<<grid, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t mn = (size_t)m * n;
  splitk_reduce_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      work, out, splits, mn);
  return cudaGetLastError();
}

// ---- column sums ----

__global__ void col_sum_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int rows, int n) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += x[(size_t)r * n + col];
  out[col] = s;
}

inline cudaError_t col_sum(const float* x, float* out, int rows, int n,
                           cudaStream_t stream) {
  col_sum_kernel<<<(n + 127) / 128, 128, 0, stream>>>(x, out, rows, n);
  return cudaGetLastError();
}

}  // namespace ws

extern "C" const char* ws_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
