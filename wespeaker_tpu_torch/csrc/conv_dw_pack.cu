// The filter gradient of a 3x3, stride-1, pad-1 conv, tap-packed (see
// wespeaker_tpu_torch/ops/conv_dw_pack.py for the math, the bound and the
// design). Replaces the Pallas kernel
// wespeaker_tpu/ops/conv_dw_pack.py::dw_pack (`_dw_pack_kernel`).
//
// With K = (b, h', w) and the packing
//   A[K, kh*Co + o] = dy[b, h' + 1 - kh, w, o]   (zero outside [0, H))
//   B[K, kw*Ci + i] = x[b, h', w + kw - 1, i]    (zero outside [0, W))
// all nine taps are one product P = A^T B of (3 Co, 3 Ci), and
// dW[o, i, kh, kw] = P[kh*Co + o, kw*Ci + i].
//
// C interface:
//   ws_dw_pack_workspace(b, h, w, ci, co): f32 elements of workspace needed;
//   ws_dw_pack(x, dy, work, work_elems, out, b, h, w, ci, co, bf16, out_bf16,
//              stream): issues the packed product and the fixed-order sum of
//              its splits on the stream; returns the first CUDA error.

#include <algorithm>

#include "common.cuh"

namespace ws {

constexpr int kDwMaxC = 64;    // Ci and Co the kernel takes
constexpr int kDwMaxWc = 112;  // positions of a row per w-chunk
constexpr int kDwSms = 132;    // H100 SXM; fixes the split count per shape

struct DwPackArgs {
  const void* x;   // (b, h, w, ci) row-major
  const void* dy;  // (b, h, w, co) row-major
  float* work;     // (splits, 3 cop, 3 cip) f32 partial products
  int b, h, w, ci, co;
  int cip, cop;  // ci, co rounded up to 16
  int wc;        // positions per w-chunk, a multiple of 16
  int rps;       // (b, h) rows per block
};

// Shared-memory row pitch in elements: a multiple of 16 (32-byte rows in
// bf16, so a WMMA tile may start at any row) with a pad against bank
// conflicts.
template <typename T>
__host__ __device__ constexpr int dw_pad() {
  return std::is_same<T, float>::value ? 4 : 16;
}

// dst[j][ch] (pitch ld, j < npos, ch < c) = src[(p0 + j) * c + ch] where
// src is a row of w positions and 0 <= p0 + j < w; zero elsewhere, and
// everywhere when src is null (a row outside the map). The padding columns
// [c, cp) are zeroed once when the kernel starts and never written. Each
// thread issues kStageBatch loads before it stores any of them (16-byte
// vectors where c allows them), so the loads of a row are in flight
// together.
constexpr int kStageBatch = 4;

template <typename T, typename V>
__device__ __forceinline__ void stage_units(T* dst, int ld,
                                            const T* __restrict__ src,
                                            int p0, int npos, int w, int c) {
  constexpr int kV = sizeof(V) / sizeof(T);
  const int units = c / kV, total = npos * units, nthreads = blockDim.x;
  for (int u0 = threadIdx.x; u0 < total; u0 += kStageBatch * nthreads) {
    V v[kStageBatch];
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int u = u0 + q * nthreads;
      const int p = p0 + u / units, ch = (u % units) * kV;
      if constexpr (std::is_same<V, uint4>::value)
        v[q] = make_uint4(0u, 0u, 0u, 0u);
      else
        v[q] = from_f<T>(0.f);
      if (u < total && src != nullptr && p >= 0 && p < w)
        v[q] = *reinterpret_cast<const V*>(src + (size_t)p * c + ch);
    }
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int u = u0 + q * nthreads;
      if (u < total)
        *reinterpret_cast<V*>(dst + (u / units) * ld + (u % units) * kV) =
            v[q];
    }
  }
}

template <typename T>
__device__ __forceinline__ void stage_row(T* dst, int ld, const T* src,
                                          int p0, int npos, int w, int c) {
  if (c % (16 / sizeof(T)) == 0)
    stage_units<T, uint4>(dst, ld, src, p0, npos, w, c);
  else
    stage_units<T, T>(dst, ld, src, p0, npos, w, c);
}

// One block owns rows [g0, g0 + rps) of the b*h rows (b, h') and walks them
// in order for each w-chunk, so the three dy rows h'+1, h', h'-1 that the kh
// taps read form a ring of three slots in shared memory (row r in slot
// r mod 3): each step stages one new dy row and one x row (plus its two edge
// columns); a new utterance or a new chunk restages the ring. The kw shift
// is a row offset into the staged x row, so neither shifted copy exists
// anywhere. Warps tile the (3 cop, 3 cip) product in 48 x 48 squares; the
// block's partial goes to work[blockIdx.x], summed by dw_reduce_kernel.
template <typename T>
__global__ void __launch_bounds__(512) dw_pack_kernel(DwPackArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int kPad = dw_pad<T>();
  T* ds = reinterpret_cast<T*>(smem_raw);  // 3 slots x (wc, ldd)
  const int ldd = p.cop + kPad, ldx = p.cip + kPad;
  T* xs = ds + 3 * p.wc * ldd;  // (wc + 2, ldx): x[w0 - 1 + j]
  const T* x = static_cast<const T*>(p.x);
  const T* dy = static_cast<const T*>(p.dy);
  const int mp = 3 * p.cop, np = 3 * p.cip;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wn = warp % (p.cip / 16), wm = warp / (p.cip / 16);
  const int rows = p.b * p.h;
  const int g0 = blockIdx.x * p.rps;
  const int g1 = min(g0 + p.rps, rows);
  // the warp's three 16-row and three 16-column fragments: the kh (kw)
  // tap and channel offset of each
  int kh[3], o0[3], kw[3], i0[3];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int m0 = wm * 48 + f * 16, n0 = wn * 48 + f * 16;
    kh[f] = m0 / p.cop;
    o0[f] = m0 % p.cop;
    kw[f] = n0 / p.cip;
    i0[f] = n0 % p.cip;
  }

  auto dy_row = [&](int bi, int r) -> const T* {
    return (r < 0 || r >= p.h) ? nullptr
                               : dy + (size_t)(bi * p.h + r) * p.w * p.co;
  };
  auto slot = [&](int r) { return ds + ((r + 3) % 3) * p.wc * ldd; };

  using namespace nvcuda;
  constexpr bool kWmma = std::is_same<T, __nv_bfloat16>::value;
  // bf16: 3 x 3 WMMA accumulators; f32: lane (rg, cg) owns rows
  // 16 f + rg + 8 e (f < 3, e < 2) and columns 16 f + cg + 4 e (e < 4) of
  // the warp's square
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kWmma ? 3 : 1]
                                                          [kWmma ? 3 : 1];
  float facc[kWmma ? 1 : 6][kWmma ? 1 : 12];
  if constexpr (kWmma) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 12; ++j) facc[i][j] = 0.f;
  }
  const int rg = lane / 4, cg = lane % 4;
  // zero the staging buffers once: their padding columns stay zero
  const int smem_elems = 3 * p.wc * ldd + (p.wc + 2) * ldx;
  for (int i = threadIdx.x; i < smem_elems; i += blockDim.x)
    ds[i] = from_f<T>(0.f);

  for (int w0 = 0; w0 < p.w; w0 += p.wc) {
    const int kend = min(p.wc, p.w - w0);
    for (int g = g0; g < g1; ++g) {
      const int bi = g / p.h, r = g % p.h;
      __syncthreads();  // the previous step's reads are done
      if (g == g0 || r == 0) {
        stage_row<T>(slot(r - 1), ldd, dy_row(bi, r - 1), w0, p.wc, p.w,
                     p.co);
        stage_row<T>(slot(r), ldd, dy_row(bi, r), w0, p.wc, p.w, p.co);
      }
      stage_row<T>(slot(r + 1), ldd, dy_row(bi, r + 1), w0, p.wc, p.w, p.co);
      stage_row<T>(xs, ldx, x + (size_t)g * p.w * p.ci, w0 - 1, p.wc + 2,
                   p.w, p.ci);
      __syncthreads();
      // tap kh reads dy row r + 1 - kh
      const T* as[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) as[f] = slot(r + 1 - kh[f]) + o0[f];
      if constexpr (kWmma) {
        for (int kk = 0; kk < kend; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              af[3];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf[3];
#pragma unroll
          for (int f = 0; f < 3; ++f) {
            wmma::load_matrix_sync(af[f], as[f] + kk * ldd, ldd);
            wmma::load_matrix_sync(bf[f], xs + (kk + kw[f]) * ldx + i0[f],
                                   ldx);
          }
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
              wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
        }
      } else {
        const T* bs[3];
#pragma unroll
        for (int f = 0; f < 3; ++f) bs[f] = xs + kw[f] * ldx + i0[f] + cg;
        for (int k = 0; k < kend; ++k) {
          float av[6], bv[12];
#pragma unroll
          for (int f = 0; f < 3; ++f) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              av[2 * f + e] = to_f(as[f][k * ldd + rg + 8 * e]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              bv[4 * f + e] = to_f(bs[f][k * ldx + 4 * e]);
          }
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j < 12; ++j)
              facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
        }
      }
    }
  }

  float* out = p.work + (size_t)blockIdx.x * mp * np;
  if constexpr (kWmma) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        wmma::store_matrix_sync(
            out + (size_t)(wm * 48 + i * 16) * np + wn * 48 + j * 16,
            acc[i][j], np, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int m = wm * 48 + 16 * (i / 2) + rg + 8 * (i % 2);
#pragma unroll
      for (int j = 0; j < 12; ++j)
        out[(size_t)m * np + wn * 48 + 16 * (j / 4) + cg + 4 * (j % 4)] =
            facc[i][j];
    }
  }
}

// out[o][i][kh][kw] = sum over z of work[z][kh*cop + o][kw*cip + i], in a
// fixed order: the same sum every run. A block takes 32 consecutive packed
// elements (coalesced reads) and kRedZ slices of z: thread (e, s) sums its
// slice in order, then thread (e, 0) sums the slices in order. Padded rows
// and columns are dropped.
constexpr int kRedZ = 16;

template <typename O>
__global__ void __launch_bounds__(32 * kRedZ)
    dw_reduce_kernel(const float* __restrict__ work, O* __restrict__ out,
                     int splits, int cop, int cip, int co, int ci) {
  __shared__ float part[kRedZ][32];
  const int mp = 3 * cop, np = 3 * cip;
  const int e = threadIdx.x % 32, zs = threadIdx.x / 32;
  const int idx = blockIdx.x * 32 + e;
  const int zc = (splits + kRedZ - 1) / kRedZ;
  float s = 0.f;
  if (idx < mp * np) {
    const int z1 = min(splits, (zs + 1) * zc);
    for (int z = zs * zc; z < z1; ++z) s += work[(size_t)z * mp * np + idx];
  }
  part[zs][e] = s;
  __syncthreads();
  if (zs != 0 || idx >= mp * np) return;
  for (int z = 1; z < kRedZ; ++z) s += part[z][e];
  const int m = idx / np, n = idx % np;
  const int kh = m / cop, o = m % cop, kw = n / cip, i = n % cip;
  if (o < co && i < ci) out[((o * ci + i) * 3 + kh) * 3 + kw] = from_f<O>(s);
}

inline int round16(int v) { return (v + 15) / 16 * 16; }

// The launch shape of dw_pack_kernel: w-chunk width, rows per block and
// block count. Blocks: about 16 warps' worth per SM on 132 SMs (warps per
// block = (cop / 16) (cip / 16)).
inline void dw_pack_shape(int b, int h, int w, int ci, int co, int* wc,
                          int* rps, int* splits) {
  const int warps = (round16(co) / 16) * (round16(ci) / 16);
  const int nchunks = (w + kDwMaxWc - 1) / kDwMaxWc;
  *wc = round16((w + nchunks - 1) / nchunks);
  const int per_sm = std::max(1, std::min(8, 16 / warps));
  const int rows = b * h;
  const int target = std::min(rows, kDwSms * per_sm);
  *rps = (rows + target - 1) / target;
  *splits = (rows + *rps - 1) / *rps;
}

template <typename T>
size_t dw_pack_smem(int wc, int ci, int co) {
  constexpr int kPad = dw_pad<T>();
  return (size_t)(3 * wc * (round16(co) + kPad) +
                  (wc + 2) * (round16(ci) + kPad)) *
         sizeof(T);
}

template <typename T>
cudaError_t dw_pack(const void* x, const void* dy, float* work,
                    size_t work_elems, void* out, int out_bf16, int b, int h,
                    int w, int ci, int co, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || ci > kDwMaxC ||
      co > kDwMaxC || (long long)b * h * w >= (1LL << 31))
    return cudaErrorInvalidValue;
  DwPackArgs p{x, dy, work, b, h, w, ci, co, round16(ci), round16(co), 0, 0};
  int splits;
  dw_pack_shape(b, h, w, ci, co, &p.wc, &p.rps, &splits);
  const size_t mpnp = (size_t)9 * p.cop * p.cip;
  if ((size_t)splits * mpnp > work_elems) return cudaErrorInvalidValue;
  const size_t smem = dw_pack_smem<T>(p.wc, ci, co);
  cudaError_t err = cudaFuncSetAttribute(
      dw_pack_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = 32 * (p.cop / 16) * (p.cip / 16);
  dw_pack_kernel<T><<<splits, threads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((mpnp + 31) / 32);
  if (out_bf16)
    dw_reduce_kernel<__nv_bfloat16><<<blocks, 32 * kRedZ, 0, stream>>>(
        work, static_cast<__nv_bfloat16*>(out), splits, p.cop, p.cip, co, ci);
  else
    dw_reduce_kernel<float><<<blocks, 32 * kRedZ, 0, stream>>>(
        work, static_cast<float*>(out), splits, p.cop, p.cip, co, ci);
  return cudaGetLastError();
}

}  // namespace ws

extern "C" long long ws_dw_pack_workspace(int b, int h, int w, int ci,
                                          int co) {
  int wc, rps, splits;
  ws::dw_pack_shape(b, h, w, ci, co, &wc, &rps, &splits);
  return (long long)splits * 9 * ws::round16(ci) * ws::round16(co);
}

extern "C" int ws_dw_pack(const void* x, const void* dy, float* work,
                          long long work_elems, void* out, int b, int h,
                          int w, int ci, int co, int bf16, int out_bf16,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::dw_pack<__nv_bfloat16>(x, dy, work, (size_t)work_elems, out,
                                      out_bf16, b, h, w, ci, co, s);
  return ws::dw_pack<float>(x, dy, work, (size_t)work_elems, out, out_bf16,
                            b, h, w, ci, co, s);
}
