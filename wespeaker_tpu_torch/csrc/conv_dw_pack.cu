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
// Three kernels compute P, each split over the rows (b, h') into a fixed
// number of blocks per shape whose partials a fixed-order pass sums:
// - bf16 with Ci and Co multiples of 8: dw_wgmma_kernel, a TMA ring on
//   mbarriers feeding wgmma from swizzled shared memory;
// - bf16 with Ci = 1 (a network's stem) and Co a multiple of 8:
//   dw_stem_kernel, CUDA-core FMA over 16-byte loads of dy;
// - f32 (exact, no TF32) and any other width: dw_pack_kernel, one staged
//   row at a time, WMMA in bf16 and FMA in f32.
//
// C interface:
//   ws_dw_pack_workspace(b, h, w, ci, co, bf16): f32 elements of workspace
//                                                needed;
//   ws_dw_pack(x, dy, work, work_elems, out, b, h, w, ci, co, bf16, out_bf16,
//              stream): issues the packed product and the fixed-order sum of
//              its splits on the stream; returns the first CUDA error.

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace ws {

constexpr int kDwMaxC = 64;    // Ci and Co the kernels take
constexpr int kDwMaxWc = 112;  // dw_pack_kernel: positions of a row per chunk
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

// ---- bf16, Ci and Co multiples of 8: a TMA ring feeding wgmma ----
//
// Work units are (w-chunk, row g = b*h + h') pairs, chunk-major; block z
// owns units [z ups, (z + 1) ups). It walks them as a sequence of stages,
// each of which stages one dy row-chunk (and, for a unit's main stage, one
// x row-chunk): a run of consecutive rows of one utterance and chunk
// starts with two stages that stage dy rows h'-1 and h' alone, then each
// main stage stages dy row h'+1 and x row h' and computes row h'.
//
// One producer thread issues every stage's copies as TMA boxes of
// Cp = 16, 32 or 64 >= C channels (channels, rows and positions outside
// the map arrive as zeros), up to `stages` stages ahead, each stage
// completing on its `full` mbarrier; the consumer warpgroups wait on it,
// run the stage's wgmmas and arrive on its `empty` mbarrier one stage
// later, when those wgmmas have retired; the producer waits on it before it
// reuses the stage's buffers. A box's 2 Cp-byte rows (one position each)
// are contiguous in device memory and land under the swizzle of that
// width, which is wgmma's MN-major layout of the same width (an atom of 8
// positions x Cp channels; SBO = 8 rows), so the tensor cores read shared
// memory without bank conflicts, and the swizzle follows the address, so
// an operand may start any whole number of rows into a box.
// The product is computed transposed, D = B^T A of (3 Cip, 3 Cop):
// - M (warpgroup mb's 64 rows) is (kw, i): x's row-chunk is one box of
//   kKS * 16 + 2 positions from w0 - 1, and the kw tap is the operand
//   starting kw rows in, so the three shifted copies are one box read at
//   three offsets (LBO = one row between the 64 / Cip taps of an M-block;
//   rows past 3 Cip read whatever follows and are never stored);
// - N is (kh, o): dy's rows sit in a ring of stages + 2 slots (one box
//   each), stage s in slot ns - 1 - s % ns, so rows h'+1, h', h'-1 (stages
//   s, s-1, s-2) are consecutive slots, three atoms one LBO apart; slots 0
//   and 1 are mirrored after the ring so a window never wraps. Slot
//   ns - 1 - s % ns is rewritten by stage s + ns, after compute stage
//   s + 2 = (s + ns) - stages, the last to read it, has been released.
// Per 16 positions each warpgroup issues one wgmma m64 n(3 Cop) k16.
constexpr int kDwMaxStages = 6;

__host__ __device__ constexpr int dw_cpad(int c) {
  return c <= 16 ? 16 : c <= 32 ? 32 : 64;
}
// wgmma layout type of an atom of rows of `bytes`
__host__ __device__ constexpr uint32_t dw_layout(int bytes) {
  return bytes == 128 ? 1u : bytes == 64 ? 2u : 3u;
}

struct DwWgmmaArgs {
  float* work;  // (splits, 3 cop, 3 cip)
  int b, h, w, ci, co;
  int cip, cop;  // channels as staged: 16, 32 or 64
  int stages;    // ring depth
  int ups;       // work units per block
  int nchunks;
  int x_rows;    // rows of an x buffer (the box, and rows past it)
};

struct DwWalk {  // one block's stages, in order
  int u, u1, k;  // unit, end, and 0/1 (pre-stages) or 2 (main stage)
  __device__ bool valid() const { return u < u1; }
  __device__ void next(int rows, int h) {
    if (k < 2) {
      ++k;
      return;
    }
    ++u;
    k = (u % rows) % h == 0 ? 0 : 2;
  }
};

// kN = 3 Cop; kKS = 16-position steps per chunk; kMB = M-blocks (consumer
// warpgroups) = ceil(3 Cip / 64). Two blocks an SM where one has at most
// two warpgroups of at most 48 accumulators.
__host__ __device__ constexpr int dw_blocks_per_sm(int n, int mb) {
  return mb <= 2 && n <= 96 ? 2 : 1;
}

template <int kN, int kKS, int kMB>
__global__ void __launch_bounds__(128 * kMB + 32, dw_blocks_per_sm(kN, kMB))
    dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_dy,
                    DwWgmmaArgs p) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int kR = kN / 2;  // accumulators a thread
  constexpr int kWc = kKS * 16;
  const int rbo = 2 * p.cop, rbi = 2 * p.cip;  // bytes per staged position
  const int slot_b = kWc * rbo;
  const int x_buf = (p.x_rows * rbi + 1023) / 1024 * 1024;
  const int ns = p.stages + 2;  // dy ring slots
  constexpr int nmb = kMB;
  const int taps_mb = 64 / p.cip;  // kw taps an M-block spans
  const uint32_t raw_s = smem_u32(smem_raw);
  const uint32_t x_s = (raw_s + 1023u) & ~1023u;  // swizzle atoms aligned
  const uint32_t dy_s = x_s + p.stages * x_buf;
  const uint32_t bar_s = dy_s + (ns + 2) * slot_b;  // full[], then empty[]
  const int tid = threadIdx.x;
  const int rows = p.b * p.h;
  const int units = p.nchunks * rows;
  const int u0 = blockIdx.x * p.ups;
  const int u1 = min(u0 + p.ups, units);

  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(bar_s + 8 * i, 1);
      mbar_init(bar_s + 8 * (p.stages + i), 4 * nmb);  // a lane a warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  // the warpgroup index, shuffled so the compiler knows it is warp-uniform:
  // a branch it cannot prove uniform makes it serialise the wgmmas
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == nmb) {  // the producer warp: one thread issues
    if (tid != 128 * nmb) return;
    DwWalk st{u0, u1, 0};
    for (int s = 0; st.valid(); ++s) {
      const int buf = s % p.stages;
      if (s >= p.stages)
        mbar_wait(bar_s + 8 * (p.stages + buf), ((s / p.stages) - 1) & 1);
      const int c = st.u / rows, g = st.u % rows;
      const int bi = g / p.h, r = g % p.h;
      const int w0 = c * kWc;
      const int slot = ns - 1 - s % ns;
      const bool main = st.k == 2;
      const uint32_t full = bar_s + 8 * buf;
      mbar_expect_tx(full, slot_b * (slot < 2 ? 2 : 1) +
                               (main ? (kWc + 2) * rbi : 0));
      const uint32_t dst = dy_s + slot * slot_b;
      tma_load_4d(dst, &tm_dy, 0, w0, r - 1 + st.k, bi, full);
      if (slot < 2)
        tma_load_4d(dst + ns * slot_b, &tm_dy, 0, w0, r - 1 + st.k, bi,
                    full);
      if (main)
        tma_load_4d(x_s + buf * x_buf, &tm_x, 0, w0 - 1, r, bi, full);
      st.next(rows, p.h);
    }
    return;
  }

  float acc[kR];
#pragma unroll
  for (int i = 0; i < kR; ++i) acc[i] = 0.f;
  const int mb = wg;
  const uint32_t lay_a = dw_layout(rbi), lay_b = dw_layout(rbo);
  auto release = [&](int s) {
    mbar_arrive_if(bar_s + 8 * (p.stages + s % p.stages), tid % 32 == 0);
  };
  int pending = -1;  // a stage whose wgmmas may still read its buffers
  DwWalk st{u0, u1, 0};
  for (int s = 0; st.valid(); ++s) {
    const int buf = s % p.stages;
    mbar_wait(bar_s + 8 * buf, (s / p.stages) & 1);
    if (st.k == 2) {
      const uint32_t a0 = x_s + buf * x_buf + mb * taps_mb * rbi;
      const uint32_t b0 = dy_s + (ns - 1 - s % ns) * slot_b;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const uint64_t da = wgmma_desc(a0 + ks * 16 * rbi, rbi, 8 * rbi, lay_a);
        const uint64_t db =
            wgmma_desc(b0 + ks * 16 * rbo, slot_b, 8 * rbo, lay_b);
        if constexpr (kN == 48)
          wgmma_m64n48k16_tt(acc, da, db);
        else if constexpr (kN == 96)
          wgmma_m64n96k16_tt(acc, da, db);
        else
          wgmma_m64n192k16_tt(acc, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's wgmmas have retired
      fence_regs(acc);
      if (pending >= 0) release(pending);
      pending = s;
    } else {
      wgmma_wait<0>();
      fence_regs(acc);
      if (pending >= 0) release(pending);
      pending = -1;
      release(s);
    }
    st.next(rows, p.h);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // D[(kw, i)][(kh, o)] is P[kh cop + o][kw cip + i]; rows past 3 cip are
  // not P's
  const int np = 3 * p.cip, mp = 3 * p.cop;
  float* out = p.work + (size_t)blockIdx.x * mp * np;
  const int wi = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = mb * 64 + wi * 16 + lane / 4 + 8 * hh;
    if (m >= np) continue;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      const int n = 8 * j + 2 * (lane % 4);
      out[(size_t)n * np + m] = acc[4 * j + 2 * hh];
      out[(size_t)(n + 1) * np + m] = acc[4 * j + 2 * hh + 1];
    }
  }
}

// ---- bf16, Ci = 1: CUDA-core FMA over 16-byte loads of dy ----
//
// dW[o, 0, kh, kw] = sum x[b, h + kh - 1, w + kw - 1] dy[b, h, w, o]: 9 Co
// outputs and a bound set by dy's bytes (x is 1/Co of them). Thread
// (position pl, channel group g) of a block owns x-chunk column
// w = c pw + pl and dy channels 8 g .. 8 g + 7, and walks rows h of its
// units (w-chunk, row) in groups of kStemU consecutive rows of one
// utterance, loading their dy vectors (streamed past L1) and the kStemU + 2
// x rows around them (through L1, which its neighbours share) before it
// uses any; 72 f32 accumulators. The block then sums its threads'
// accumulators in a fixed order through shared memory. (A TMA ring of dy
// rows feeding the same FMA loop timed slower on the H100 at ResNet34's
// stem while this was built.)
constexpr int kStemThreads = 256;
constexpr int kStemU = 4;

struct DwStemArgs {
  const __nv_bfloat16* x;   // (b, h, w, 1)
  const __nv_bfloat16* dy;  // (b, h, w, co)
  float* work;              // (splits, 3 co, 3)
  int b, h, w, co;
  int pw;  // positions per w-chunk
  int nchunks, ups;
};

__global__ void __launch_bounds__(kStemThreads, 2)
    dw_stem_kernel(DwStemArgs p) {
  __shared__ float red[kStemThreads][9];
  const int gp = p.co / 8, tid = threadIdx.x;
  const int g = tid % gp, pl = tid / gp;
  const int rows = p.b * p.h, units = p.nchunks * rows;
  const int u0 = blockIdx.x * p.ups, u1 = min(u0 + p.ups, units);
  float acc[3][3][8];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][j][c] = 0.f;

  for (int u = u0; u < u1;) {
    const int c = u / rows, gr = u % rows;
    const int bi = gr / p.h, r = gr % p.h;
    const int n = min(kStemU, min(u1 - u, p.h - r));
    const int wpos = c * p.pw + pl;
    const bool live = pl < p.pw && wpos < p.w;
    const size_t row0 = (size_t)bi * p.h;
    uint4 dv[kStemU];
#pragma unroll
    for (int k = 0; k < kStemU; ++k) {
      dv[k] = make_uint4(0u, 0u, 0u, 0u);
      if (live && k < n)
        dv[k] = ld_stream16(p.dy + ((row0 + r + k) * p.w + wpos) * p.co +
                            8 * g);
    }
    float xv[kStemU + 2][3];
#pragma unroll
    for (int k = 0; k < kStemU + 2; ++k) {
      const int rr = r - 1 + k;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int ww = wpos + kw - 1;
        xv[k][kw] = (live && k < n + 2 && rr >= 0 && rr < p.h && ww >= 0 &&
                     ww < p.w)
                        ? __bfloat162float(p.x[(row0 + rr) * p.w + ww])
                        : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kStemU; ++k) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&dv[k]);
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        const float d = __bfloat162float(e[cc]);
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            acc[kh][kw][cc] = fmaf(xv[k + kh][kw], d, acc[kh][kw][cc]);
      }
    }
    u += n;
  }

  // channel o = 8 g + cc: the sum over the block's positions, in order
  const int npos = kStemThreads / gp;
  float* out = p.work + (size_t)blockIdx.x * 9 * p.co;
#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) red[tid][kh * 3 + kw] = acc[kh][kw][cc];
    __syncthreads();
    if (tid < 9 * gp) {
      const int gg = tid % gp, tap = tid / gp;
      float s = 0.f;
      for (int q = 0; q < npos; ++q) s += red[q * gp + gg][tap];
      // P[kh co + o][kw] with o = 8 gg + cc
      out[((tap / 3) * p.co + 8 * gg + cc) * 3 + tap % 3] = s;
    }
    __syncthreads();
  }
}

// ---- which kernel, and its launch shape ----

enum DwPath { kDwOld = 0, kDwWgmma = 1, kDwStem = 2 };

struct DwPlan {
  int path;
  int splits;
  int cop, cip;  // P is (3 cop, 3 cip) per split
  // dw_pack_kernel
  int wc, rps;
  // dw_wgmma_kernel / dw_stem_kernel
  int stages, ups, nchunks, threads, pw, ks;
  size_t smem;
};

// 16-position steps per w-chunk, from those the kernel is built for: the
// fewest steps plus one a chunk (a stage's own cost)
constexpr int kDwSteps[] = {2, 7};

inline int dw_steps(int w) {
  const int need = (w + 15) / 16;
  int best = 0, cost = 1 << 30;
  for (int k : kDwSteps) {
    const int nch = (need + k - 1) / k;
    if (nch * (k + 1) <= cost) {
      cost = nch * (k + 1);
      best = k;
    }
  }
  return best;
}

// x buffers, the dy ring, the 1 KB alignment slack and 2 stages mbarriers
inline size_t dw_wgmma_smem(int ci, int co, int ks, int stages) {
  const int cop = dw_cpad(co), cip = dw_cpad(ci);
  const int x_buf = ((16 * ks + 4) * 2 * cip + 1023) / 1024 * 1024;
  return (size_t)stages * x_buf + (size_t)(stages + 4) * 16 * ks * 2 * cop +
         1024 + 16 * stages;
}

inline DwPlan dw_plan(int bf16, int b, int h, int w, int ci, int co) {
  DwPlan q{};
  const int rows = b * h;
  if (bf16 && ci % 8 == 0 && co % 8 == 0) {
    q.path = kDwWgmma;
    q.cop = dw_cpad(co);
    q.cip = dw_cpad(ci);
    q.ks = dw_steps(w);
    const int nmb = (3 * q.cip + 63) / 64;
    q.threads = 128 * nmb + 32;  // consumer warpgroups, a producer warp
    const int per_sm = dw_blocks_per_sm(3 * q.cop, nmb);
    const size_t budget = per_sm == 1 ? 232448 : 115712;
    q.stages = 2;
    while (q.stages < kDwMaxStages &&
           dw_wgmma_smem(ci, co, q.ks, q.stages + 1) <= budget)
      ++q.stages;
    q.smem = dw_wgmma_smem(ci, co, q.ks, q.stages);
    q.nchunks = (w + 16 * q.ks - 1) / (16 * q.ks);
    const long long units = (long long)q.nchunks * rows;
    const long long target = std::min(units, (long long)kDwSms * per_sm);
    q.ups = (int)((units + target - 1) / target);
    q.splits = (int)((units + q.ups - 1) / q.ups);
  } else if (bf16 && ci == 1 && co % 8 == 0) {
    q.path = kDwStem;
    q.cop = co;
    q.cip = 1;
    const int per_block = kStemThreads / (co / 8);
    q.nchunks = (w + per_block - 1) / per_block;
    q.pw = (w + q.nchunks - 1) / q.nchunks;
    const long long units = (long long)q.nchunks * rows;
    const long long target = std::min(units, (long long)kDwSms * 2);
    q.ups = (int)((units + target - 1) / target);
    q.splits = (int)((units + q.ups - 1) / q.ups);
  } else {
    q.path = kDwOld;
    q.cop = round16(co);
    q.cip = round16(ci);
    dw_pack_shape(b, h, w, ci, co, &q.wc, &q.rps, &q.splits);
  }
  return q;
}

template <int kN, int kKS, int kMB>
cudaError_t dw_wgmma_launch_one(const DwPlan& q, const CUtensorMap& tm_x,
                                const CUtensorMap& tm_dy,
                                const DwWgmmaArgs& a, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      dw_wgmma_kernel<kN, kKS, kMB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q.smem);
  if (e != cudaSuccess) return e;
  dw_wgmma_kernel<kN, kKS, kMB><<<q.splits, q.threads, q.smem, stream>>>(
      tm_x, tm_dy, a);
  return cudaSuccess;
}

template <int kN, int kKS>
cudaError_t dw_wgmma_launch_ks(const DwPlan& q, const CUtensorMap& tm_x,
                               const CUtensorMap& tm_dy, const DwWgmmaArgs& a,
                               cudaStream_t stream) {
  switch (q.cip) {
    case 16: return dw_wgmma_launch_one<kN, kKS, 1>(q, tm_x, tm_dy, a, stream);
    case 32: return dw_wgmma_launch_one<kN, kKS, 2>(q, tm_x, tm_dy, a, stream);
    default: return dw_wgmma_launch_one<kN, kKS, 3>(q, tm_x, tm_dy, a, stream);
  }
}

template <int kN>
cudaError_t dw_wgmma_launch_n(const DwPlan& q, const CUtensorMap& tm_x,
                              const CUtensorMap& tm_dy, const DwWgmmaArgs& a,
                              cudaStream_t stream) {
  return q.ks == 2 ? dw_wgmma_launch_ks<kN, 2>(q, tm_x, tm_dy, a, stream)
                   : dw_wgmma_launch_ks<kN, 7>(q, tm_x, tm_dy, a, stream);
}

inline cudaError_t dw_wgmma_launch(const DwPlan& q, const CUtensorMap& tm_x,
                                   const CUtensorMap& tm_dy,
                                   const DwWgmmaArgs& a, cudaStream_t stream) {
  switch (q.cop) {
    case 16: return dw_wgmma_launch_n<48>(q, tm_x, tm_dy, a, stream);
    case 32: return dw_wgmma_launch_n<96>(q, tm_x, tm_dy, a, stream);
    default: return dw_wgmma_launch_n<192>(q, tm_x, tm_dy, a, stream);
  }
}

template <typename T>
cudaError_t dw_pack(const void* x, const void* dy, float* work,
                    size_t work_elems, void* out, int out_bf16, int b, int h,
                    int w, int ci, int co, cudaStream_t stream) {
  if (b <= 0 || h <= 0 || w <= 0 || ci <= 0 || co <= 0 || ci > kDwMaxC ||
      co > kDwMaxC || (long long)b * h * w >= (1LL << 31))
    return cudaErrorInvalidValue;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const DwPlan q = dw_plan(kBf16, b, h, w, ci, co);
  const size_t mpnp = (size_t)9 * q.cop * q.cip;
  if ((size_t)q.splits * mpnp > work_elems) return cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (kBf16) {
    if (q.path == kDwWgmma) {
      CUtensorMap tm_x, tm_dy;
      if (!tensor_map_4d_bf16(&tm_x, x, ci, w, h, b, q.cip, 16 * q.ks + 2,
                              2 * q.cip) ||
          !tensor_map_4d_bf16(&tm_dy, dy, co, w, h, b, q.cop, 16 * q.ks,
                              2 * q.cop))
        return cudaErrorInvalidValue;
      const DwWgmmaArgs a{work,     b,     h,         w,
                          ci,       co,    q.cip,     q.cop,
                          q.stages, q.ups, q.nchunks, 16 * q.ks + 4};
      err = dw_wgmma_launch(q, tm_x, tm_dy, a, stream);
      if (err != cudaSuccess) return err;
    } else if (q.path == kDwStem) {
      const DwStemArgs a{static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(dy),
                         work, b, h, w, co, q.pw, q.nchunks, q.ups};
      dw_stem_kernel<<<q.splits, kStemThreads, 0, stream>>>(a);
    }
  }
  if (q.path == kDwOld) {
    DwPackArgs a{x, dy, work, b, h, w, ci, co, q.cip, q.cop, q.wc, q.rps};
    const size_t smem = dw_pack_smem<T>(q.wc, ci, co);
    err = cudaFuncSetAttribute(dw_pack_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    const int threads = 32 * (q.cop / 16) * (q.cip / 16);
    dw_pack_kernel<T><<<q.splits, threads, smem, stream>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((mpnp + 31) / 32);
  if (out_bf16)
    dw_reduce_kernel<__nv_bfloat16><<<blocks, 32 * kRedZ, 0, stream>>>(
        work, static_cast<__nv_bfloat16*>(out), q.splits, q.cop, q.cip, co,
        ci);
  else
    dw_reduce_kernel<float><<<blocks, 32 * kRedZ, 0, stream>>>(
        work, static_cast<float*>(out), q.splits, q.cop, q.cip, co, ci);
  return cudaGetLastError();
}

}  // namespace ws

extern "C" long long ws_dw_pack_workspace(int b, int h, int w, int ci,
                                          int co, int bf16) {
  const ws::DwPlan q = ws::dw_plan(bf16, b, h, w, ci, co);
  return (long long)q.splits * 9 * q.cop * q.cip;
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
