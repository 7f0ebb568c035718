// Statistics pooling over T (see wespeaker_tpu_torch/ops/pooling.py for the
// math, the bound and the design). Replaces the Pallas kernels
// wespeaker_tpu/ops/pooling_pallas.py::fused_softmax_stats
// (`_softmax_stats_kernel`) and ::fused_masked_stats
// (`_masked_stats_kernel`).
//
// C interface (out is one (b, 2d) f32 buffer, [mean | std]):
//   ws_softmax_stats(logits, x, mask, out, b, t, d, logits_bf16, x_bf16,
//                    stream): softmax over T of the logits, masked frames
//                    at -1e30, then the weighted mean and
//                    sqrt(max(E[x^2] - mean^2, 1e-7));
//   ws_masked_stats(x, mask, out, b, t, d, ddof, bf16, stream): masked mean
//                    and sqrt(sum((x - mean)^2 m) / max(count - ddof, 1)
//                    + 1e-7).
// mask is a (b, t) f32 frame mask or null. Each returns the launch's CUDA
// error (0 on success).

#include "common.cuh"
#include "hopper.cuh"

namespace ws {

template <typename T, typename TL>
cudaError_t softmax_stats_entry(const void* logits, const void* x,
                                const float* mask, float* out, int b, int t,
                                int d, cudaStream_t s) {
  return softmax_stats<T, TL>(static_cast<const TL*>(logits),
                              static_cast<const T*>(x), mask, out, b, t, d,
                              s);
}

// ---- masked mean and std in one pass over T (row 7) ----
//
// A thread owns kC = 8 / sizeof(T) channels of one utterance (4 in bf16, 2
// in f32) and reads them with one 8-byte load a frame, streamed past L1
// with a 256-byte L2 prefetch, keeping the loads of 16 frames in flight. An
// item is (utterance, 32 consecutive 8-byte columns), so a warp reads 256
// contiguous bytes of a frame; `tw` warps share an item and split its
// frames (warp j of the item takes frames j, j + tw, ...), and a block of
// kStatsWarps warps takes kStatsWarps / tw consecutive items. tw is 1 where
// the items alone fill the card twice over (ResNet34's TSTP at B = 512), 2
// at ReDimNetB2's ASTP (B = 512, T = 200), up to 8 for few utterances and
// long T. The grid is 1-D, so any
// b * ceil(d / (32 kC)) < 2^31 launches. (16-byte loads of 8 bf16 channels
// a thread timed slower on the H100 at both shapes while this was built:
// fewer, fatter threads kept fewer bytes in flight.)
//
// Each thread sums m (x - K) and m (x - K)^2 with the shift K = x at the
// utterance's first frame whose mask is non-zero: with K inside the data,
// the shifted sums do not cancel the way raw sums of x and x^2 do when
// |mean| >> std. A warp's part becomes (count, mean - K, M2); the tw parts
// of an item combine by Chan's formula in shared memory, in warp order, so
// the result does not depend on scheduling.
constexpr int kStatsWarps = 8;
constexpr int kStatsFrames = 16;  // loads in flight a thread (vector path)

template <typename T, bool kAligned, bool kMasked>
__global__ void __launch_bounds__(32 * kStatsWarps)
    masked_stats_kernel(const T* __restrict__ x,
                        const float* __restrict__ mask,
                        float* __restrict__ out, int b, int t, int d,
                        int chunks, int tw, int ddof) {
  constexpr int kC = 8 / sizeof(T);
  constexpr int kU = kAligned ? kStatsFrames : 4;  // frames in flight
  __shared__ float part_s1[kStatsWarps][kC][32];
  __shared__ float part_s2[kStatsWarps][kC][32];
  __shared__ float part_n[kStatsWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * (kStatsWarps / tw) + warp / tw;
  const int j = warp % tw;  // this warp's share of the item's frames
  const int bi = item / chunks;
  const int c0 = ((item % chunks) * 32 + lane) * kC;
  const bool live = bi < b && c0 < d;
  const T* xb = x + (size_t)(live ? bi : 0) * t * d + (live ? c0 : 0);
  const float* mb =
      kMasked && mask ? mask + (size_t)(live ? bi : 0) * t : nullptr;

  int f_shift = 0;  // the first frame with a non-zero mask (0 if none)
  if (mb) {
    for (int base = 0; base < t; base += 32) {
      const int f = base + lane;
      const unsigned nz = __ballot_sync(0xffffffffu, f < t && mb[f] != 0.f);
      if (nz) {
        f_shift = base + __ffs(nz) - 1;
        break;
      }
    }
  }
  float shift[kC], s1[kC], s2[kC], n = 0.f;
  if constexpr (kAligned) {
    uint2 raw = make_uint2(0u, 0u);
    if (live) raw = *reinterpret_cast<const uint2*>(xb + (size_t)f_shift * d);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int c = 0; c < kC; ++c) shift[c] = to_f(e[c]);
  } else {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      shift[c] = live && c0 + c < d ? to_f(xb[(size_t)f_shift * d + c]) : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) s1[c] = s2[c] = 0.f;

  for (int f0 = j; f0 < t; f0 += tw * kU) {
    float m[kU];
    uint2 raw[kAligned ? kU : 1];
    float sv[kAligned ? 1 : kU][kC];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int f = f0 + u * tw;
      m[u] = f < t ? (mb ? mb[f] : 1.f) : 0.f;
      if constexpr (kAligned) {
        raw[u] = make_uint2(0u, 0u);
        if (live && f < t) raw[u] = ld_stream8(xb + (size_t)f * d);
      } else {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          sv[u][c] = live && f < t && c0 + c < d
                         ? to_f(xb[(size_t)f * d + c])
                         : 0.f;
      }
    }
    // unmasked, a full batch of frames needs no weights
    auto accumulate = [&](auto weighted) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        n += m[u];
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          float v;
          if constexpr (kAligned)
            v = to_f(reinterpret_cast<const T*>(&raw[u])[c]);
          else
            v = sv[u][c];
          const float dv = v - shift[c];
          const float wd = decltype(weighted)::value ? m[u] * dv : dv;
          s1[c] += wd;
          s2[c] = fmaf(wd, dv, s2[c]);
        }
      }
    };
    if (!kMasked && f0 + (kU - 1) * tw < t)
      accumulate(std::false_type{});
    else
      accumulate(std::true_type{});
  }
  if (tw > 1) {
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      part_s1[warp][c][lane] = s1[c];
      part_s2[warp][c][lane] = s2[c];
    }
    if (lane == 0) part_n[warp] = n;
    __syncthreads();
  }
  if (j != 0 || !live) return;

  // Chan's combination of the item's (count, mean - K, M2), in warp order
  float na = 0.f, ma[kC], m2a[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) ma[c] = m2a[c] = 0.f;
  for (int q = 0; q < tw; ++q) {
    const float nb = tw > 1 ? part_n[warp + q] : n;
    if (nb == 0.f) continue;
    const float nab = na + nb, inv_nb = 1.f / nb;
    const float fb = nb / nab, fab = na * nb / nab;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float sb1 = tw > 1 ? part_s1[warp + q][c][lane] : s1[c];
      const float sb2 = tw > 1 ? part_s2[warp + q][c][lane] : s2[c];
      const float mbw = sb1 * inv_nb;
      const float m2b = sb2 - sb1 * mbw;
      const float delta = mbw - ma[c];
      ma[c] += delta * fb;
      m2a[c] += m2b + delta * delta * fab;
    }
    na = nab;
  }
  // mean = sum(x m) / max(count, 1); sum(m (x - mean)^2) moves by
  // count (mean_w - mean)^2 from M2 about the weighted mean mean_w
  float* ob = out + (size_t)bi * 2 * d + c0;
  const float denom = fmaxf(na - (float)ddof, 1.f);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (!kAligned && c0 + c >= d) break;
    const float mean_w = shift[c] + ma[c];
    const float mean = mean_w * (na / fmaxf(na, 1.f));
    const float off = mean_w - mean;
    ob[c] = mean;
    ob[d + c] = sqrtf((m2a[c] + na * off * off) / denom + 1e-7f);
  }
}

template <typename T>
cudaError_t masked_stats_entry(const void* x, const float* mask, float* out,
                               int b, int t, int d, int ddof,
                               cudaStream_t s) {
  constexpr int kC = 8 / sizeof(T);
  if (b <= 0 || t <= 0 || d <= 0) return cudaErrorInvalidValue;
  const int chunks = ((d + kC - 1) / kC + 31) / 32;
  // one warp an item where the items fill the card twice over (its SMs x
  // 32 warps x 2); below that, T is split until they do or a warp would
  // walk fewer than one batch of kStatsFrames frames
  int tw = 1;
  while (tw < kStatsWarps &&
         (long long)b * chunks * tw < 2LL * sm_count() * 32 &&
         t > kStatsFrames * tw)
    tw *= 2;
  const long long items = (long long)b * chunks;
  const long long blocks = (items + kStatsWarps / tw - 1) / (kStatsWarps / tw);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  auto launch = [&](auto kernel) {
    kernel<<<(unsigned)blocks, 32 * kStatsWarps, 0, s>>>(xt, mask, out, b, t,
                                                         d, chunks, tw, ddof);
  };
  if (d % kC == 0) {
    if (mask)
      launch(masked_stats_kernel<T, true, true>);
    else
      launch(masked_stats_kernel<T, true, false>);
  } else {
    launch(masked_stats_kernel<T, false, true>);  // scalar path: any mask
  }
  return cudaGetLastError();
}

}  // namespace ws

extern "C" int ws_softmax_stats(const void* logits, const void* x,
                                const float* mask, float* out, int b, int t,
                                int d, int logits_bf16, int x_bf16,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_bf16)
    return logits_bf16
               ? ws::softmax_stats_entry<bf16, bf16>(logits, x, mask, out, b,
                                                     t, d, s)
               : ws::softmax_stats_entry<bf16, float>(logits, x, mask, out, b,
                                                      t, d, s);
  return logits_bf16
             ? ws::softmax_stats_entry<float, bf16>(logits, x, mask, out, b,
                                                    t, d, s)
             : ws::softmax_stats_entry<float, float>(logits, x, mask, out, b,
                                                     t, d, s);
}

extern "C" int ws_masked_stats(const void* x, const float* mask, float* out,
                               int b, int t, int d, int ddof, int bf16,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return ws::masked_stats_entry<__nv_bfloat16>(x, mask, out, b, t, d, ddof,
                                                 s);
  return ws::masked_stats_entry<float>(x, mask, out, b, t, d, ddof, s);
}
