// Kernel K3: reduced classical volume integration of the final render pass,
// its first-order gradient, and the forward merged with the sample merge.
//
// Replaces the TPU kernel `_ray_march_kernel` / `ray_march_pallas` in
// tdgp/ops/pallas_kernels.py:86/136. For each ray it computes what the
// classical marcher (tdgp/rendering/renderer.py:62-105) followed by a sum of
// the weights computes, and writes only the per-ray results:
//   sigma_i = softplus(beta * x_i) / beta   or   max(x_i, 0)
//   delta_i = t_{i+1} - t_i,  delta_{S-1} = last_delta (1e10 or 1e-3)
//   alpha_i = 1 - exp(-delta_i * sigma_i)
//   T_i     = prod_{j<i} ((1 - alpha_j) + 1e-10)       (exclusive)
//   w_i     = alpha_i * T_i
//   rgb = sum_i w_i c_i, depth = sum_i w_i t_i, wsum = sum_i w_i,
//   ftrans = T_S; with last_back, w_{S-1} += 1 - sum_i w_i.
//
// Two forward entries share one march:
//  - ray_march_reduced_kernel takes one sample set per ray, sorted, [N, S]:
//    the forward of the differentiable march (training), any S.
//  - ray_march_merged_kernel takes the coarse and the fine set as the model
//    evaluated them, [N, S1] and [N, S2], each sorted per ray, S1 + S2 <= 128,
//    and marches their merge: what the sort-free merge
//    (tdgp/rendering/renderer.py:281 unify_samples_sorted, one-hot matmuls
//    there) followed by the march computes. Sample i of set 1 goes to
//    i + #{j : t2_j < t1_i}, sample j of set 2 to j + #{i : t1_i <= t2_j}: ties
//    go to set 1 first, and the positions are a permutation.
//
// What bounds it on an H100: device memory. It does ~20 flops per 20 bytes
// read; at the serving shape (batch 4 x 16,384 rays per chunk, S = 32 + 32,
// C = 3) one call reads 4*16384*64*(3+2)*4 B = 84 MB and writes 1.6 MB, about
// 25 us at 3.35 TB/s. The merge adds no device-memory traffic; as a step of
// its own (comparison masks, int64 ranks, concatenations, scatters) it moved
// ~0.9 GB per chunk.
//
// What the design does about it: a warp marches Q = 32 / L consecutive rays
// on L lanes each (L = 8 up to 64 samples a ray, 16 up to 128), with their
// samples in the warp's own slice of shared memory. It stages them there
// with cp.async: the Q rays' depths, densities and colours are one
// contiguous run each in device memory, copied 16 bytes a lane, every copy
// in flight at once and none held in registers (the first design read the
// colours at a 12-byte stride per lane and every depth twice). Lane li of a
// ray marches K = S / L consecutive samples (S = 64: 8li .. 8li + 7): it
// sums its weights relative to the transmittance in front of its first
// sample, one product scan over the ray's lanes (shuffles) gives that
// transmittance, and one multiply per sum scales them; the delta across
// lanes comes from the next lane by a shuffle. In the merged entry a lane
// finds where its K merged samples start with a merge-path search (the
// number of set-1 samples among the first li K merged ones, a binary search
// of 7 steps over the two sorted sets), then walks the merge K steps: the
// merge moves no sample and writes nothing. A shuffle reduction over the
// ray's lanes gives its totals; no [N, S] intermediate reaches device
// memory. The unmerged entry takes its one set in order and marches a ray
// longer than 128 samples in passes of 128, the transmittance carried over.
// The TPU kernel's exp-of-masked-matmul prefix product (a workaround for a
// missing cumprod) and the merge's one-hot matmuls (for a missing scatter)
// have no counterpart here.

// The merged entry and its cut entry are also instantiated with bf16 loads
// (tdgp_ray_march_merged_bf16, tdgp_ray_march_merged_cut_bf16), for the
// bf16 render views (generator.render_bf16): bf16 colours, bf16 or float32
// densities (float32 where a training render has added its density noise),
// float32 depths. The JAX package marches the same values in float32: its
// sort-free merge multiplies the bf16 colours and densities by float32
// one-hots, and its Pallas march casts bf16 inputs to float32 on entry
// (tdgp/ops/pallas_kernels.py:188-189). Here the bf16 values are staged by
// cp.async as they are, into the back half of their float32 arrays in shared
// memory, and widened to float32 (exactly) in place; the march is the
// float32 one, in the float32 entry's shared memory. At the served
// chunk [4, 16384, 32 + 32, 3] a call reads 4 + 2 C + 2 bytes a sample, 50.3
// MB, and writes 1.6 MB: 0.0155 ms at 3.35 TB/s, against 0.0255 ms in
// float32.

// The backward (ray_march_reduced_bwd_kernel) replaces the JAX package's
// analytic VJP `_ray_march_bwd` (tdgp/ops/pallas_kernels.py:251, written in
// jnp there). From the three saved inputs and the four cotangents it
// computes, per ray, with a_i = <c_i, g_rgb> + t_i g_depth + g_wsum:
//   g (uncorrected w_i) = a_i, or a_i - a_{S-1} (0 at S-1) with last_back
//   gf_i    = -g_i T_i + (sum_{k>i} g_k w_k + g_ftrans T_S) / ((1-alpha_i) + 1e-10)
//   g_x_i   = gf_i * (-delta_i e^{-delta_i sigma_i}) * dsigma_i/dx_i
//   g_c_i   = w'_i g_rgb        (w' with the last_back correction)
//   g_t_i   = w'_i g_depth - gd_i [i < S-1] + gd_{i-1} [i > 0],
//             gd_i = gf_i * (-sigma_i e^{-delta_i sigma_i})
// It is bound by memory like the forward: it reads the inputs twice (once
// for the ray's totals, once for the per-sample gradients) and writes the
// three gradients, 2*(S*(C+2)) + S*(C+2) floats per ray. The same
// warp-per-ray layout serves it: the transmittance is the forward's product
// scan, and sum_{k>i} is the ray total minus a shuffle prefix sum.

// The backward's own derivative (ray_march_reduced_bwd_bwd_kernel), for a
// gradient of a gradient through the march (the 3DGP model's path-length
// regularization, loss.pl_weight > 0). The JAX package gets it by
// differentiating its jnp marcher twice, or its analytic VJP
// `_ray_march_bwd` (tdgp/ops/pallas_kernels.py:251) once. Given the
// cotangents (U_c, U_x, U_t) of the backward's three outputs it returns
// those of its seven inputs, the reverse sweep of the backward's own
// computation, per ray (ops/ray_march.py `RayMarchReducedBackward` has the
// sweep's steps). Besides the forward's scans it takes the exclusive
// prefix sum of q_i = gf_i-bar / f_i (the derivative of the suffix sum
// sum_{k>i} g_k w_k is a prefix sum), and the suffix sum of T_i T_i-bar for
// the product's derivative; with last_back, one ray total more. Layout: a
// warp per ray, sample s = 32 r + lane in round r < K = ceil(S / 32) <= 4,
// every per-sample value of the sweep in registers; the scans carry from
// round to round. It reads the three inputs and three cotangents and
// writes three per-sample outputs, 2 (C + 2) + (C + 2) floats a sample.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "clamp_density.cuh"

namespace {

constexpr int kMaxChannels = 4;
constexpr int kRaysPerBlock = 8;   // the backward: one warp per ray
constexpr int kWarpsPerBlock = 4;  // the forwards
// The forwards give a ray kMinLanes lanes, or kWideLanes above kMinLanes x
// kMaxPerLane samples, and march at most kMaxChunk of its samples at once.
constexpr int kMinLanes = 8;
constexpr int kWideLanes = 2 * kMinLanes;
constexpr int kMaxPerLane = 8;
constexpr int kMaxChunk = kWideLanes * kMaxPerLane;
constexpr int kMaxMerged = 128;    // S1 + S2 of the merged forward
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kMaxMerged <= kMaxChunk, "the merged forward marches in one pass");

template <int N>
using Int = std::integral_constant<int, N>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Copies n floats into the warp's shared memory: 16 bytes a lane where both
// ends are 16-byte aligned, else (and for the tail) 4.
__device__ __forceinline__ void stage(float* dst, const float* src, int n, int lane) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)__cvta_generic_to_shared(dst)) & 15) == 0) {
    for (int i = 4 * lane; i + 4 <= n; i += 128) cp_async16(dst + i, src + i);
    done = n & ~3;
  }
  for (int i = done + lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

// Stages n bf16 values for the n floats at dst: copies them as they are
// into the second half of dst's 4n bytes, by cp.async, 16 bytes a lane where
// both ends are 16-byte aligned, else (and for the tail) one value a lane.
// `widen` then turns them into floats in place.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src, int n, int lane) {
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(dst) + n;
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)__cvta_generic_to_shared(raw)) & 15) == 0) {
    for (int i = 8 * lane; i + 8 <= n; i += 256) {
      const unsigned d = (unsigned)__cvta_generic_to_shared(raw + i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i)
                   : "memory");
    }
    done = n & ~7;
  }
  for (int i = done + lane; i < n; i += 32) raw[i] = src[i];
}

// Widens the n bf16 values that `stage` put behind the n floats at dst into
// those floats (exactly), in place: 32 at a time from the front, each lane
// reading its value before any lane writes. The floats of a step end below
// the bf16 values still to be read (float i covers the bf16 slots 2i - n and
// 2i - n + 1, below i + 32 where i < n - 31, and below n, all read, after).
__device__ __forceinline__ void widen(float* dst, int n, int lane) {
  const __nv_bfloat16* raw = reinterpret_cast<const __nv_bfloat16*>(dst) + n;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const float v = i0 + lane < n ? __bfloat162float(raw[i0 + lane]) : 0.f;
    __syncwarp();
    if (i0 + lane < n) dst[i0 + lane] = v;
    __syncwarp();
  }
}

// waits for this lane's copies, then makes every lane's visible to the warp
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

template <int C>
struct Sums {
  float carry = 1.f;  // transmittance in front of the next sample to march
  float w = 0.f, depth = 0.f, rgb[C] = {};
};

// The samples of one ray in a warp's staged copy, in marching order: sample
// i at offset first + i.
struct InOrder {
  int at;
  __device__ __forceinline__ InOrder(int first, int i0) : at(first + i0) {}
  // the offset of the next sample, its depth in t
  __device__ __forceinline__ int next(const float* ts, float& t) {
    t = ts[at];
    return at++;
  }
};

// The merge of two sorted sets of one ray in a warp's staged copy (n1
// depths at offset o1, n2 at o2), in merged order from merged position d
// on: ties go to set 1 first, as unify_samples_sorted has them. The start
// is a merge-path search: a, the number of set-1 samples among the first
// d merged ones, is the count of m with t1[m] <= t2[d - 1 - m], a prefix of
// the m in [max(0, d - n2), min(d, n1)), found in 7 steps whatever the data.
struct Merged {
  int o1, o2, n1, n2, a, b;
  float v1, v2;  // the depths of set-1 sample a and set-2 sample b
  __device__ __forceinline__ Merged(const float* ts, int o1_, int n1_, int o2_, int n2_, int d)
      : o1(o1_), o2(o2_), n1(n1_), n2(n2_) {
    const int lo = d > n2 ? d - n2 : 0, len = (d < n1 ? d : n1) - lo;
    int pos = 0;
#pragma unroll
    for (int step = kMaxMerged / 2; step > 0; step >>= 1) {
      const int m = lo + pos + step - 1;
      if (pos + step <= len && ts[o1 + m] <= ts[o2 + d - 1 - m]) pos += step;
    }
    a = lo + pos;
    b = d - a;
    v1 = a < n1 ? ts[o1 + a] : 0.f;
    v2 = b < n2 ? ts[o2 + b] : 0.f;
  }
  // One step, in selects: the same step as an if/else gave wrong sums with
  // 32 lanes x 4 samples a ray at ptxas -O1 and -O3 (right at -O0).
  __device__ __forceinline__ int next(const float* ts, float& t) {
    const bool first = a < n1 && (b >= n2 || v1 <= v2);
    t = first ? v1 : v2;
    const int at = first ? o1 + a : o2 + b;
    a += first;
    b += !first;
    const int j = first ? a : b, nj = first ? n1 : n2, oj = first ? o1 : o2;
    const float v = j < nj ? ts[oj + j] : 0.f;
    v1 = first ? v : v1;
    v2 = first ? v2 : v;
    return at;
  }
  // the offset of the ray's last merged sample
  __device__ __forceinline__ int last(const float* ts) const {
    return ts[o1 + n1 - 1] <= ts[o2 + n2 - 1] ? o2 + n2 - 1 : o1 + n1 - 1;
  }
};

// Marches one ray's samples [0, n) of a warp's staged copy (depths ts, raw
// densities xs, colours cs [., C], at the same offsets) on the L lanes of
// the ray (li: the lane's place among them), adding into `acc`; n <= L K.
// `Source` gives the samples' offsets in marching order (InOrder, Merged).
// With `Cut`, a clamped density below `thresh` is set to 0 before it is
// marched (the eval-time quantile cut; the threshold comes from outside).
// Lane li takes samples li K .. li K + K - 1: it sums w / T_front over them
// (its weights relative to the transmittance in front of its first
// sample), one product scan over the ray's lanes gives that transmittance,
// and one multiply per sum scales them. The last sample's delta is
// t_after - t where the ray goes on past these n samples (`more`), else
// last_delta.
template <int C, int L, int K, bool Cut = false, typename Source>
__device__ __forceinline__ void march(const float* ts, const float* xs, const float* cs,
                                      Source src, int n, bool more, float t_after,
                                      int clamp_mode, float beta, float last_delta, int li,
                                      Sums<C>& acc, float thresh = 0.f) {
  const int i0 = li * K;
  float t = 0.f;
  int at = i0 < n ? src.next(ts, t) : 0;
  const float t_right = __shfl_down_sync(kFullMask, t, 1, L);  // the next lane's first
  float prod = 1.f, w = 0.f, depth = 0.f, rgb[C] = {};
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = i0 + k;
    if (i < n) {
      float t_next = t_right;
      const int at_next = k + 1 < K && i + 1 < n ? src.next(ts, t_next) : at;
      const float delta = i + 1 < n ? t_next - t : (more ? t_after - t : last_delta);
      float sigma = clamp_density(xs[at], clamp_mode, beta);
      if constexpr (Cut) sigma = sigma < thresh ? 0.f : sigma;
      const float alpha = 1.f - expf(-delta * sigma);
      const float wk = alpha * prod;
      w += wk;
      depth += wk * t;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) rgb[ch] += wk * cs[at * C + ch];
      prod *= (1.f - alpha) + 1e-10f;
      at = at_next;
      t = t_next;
    }
  }
  float incl = prod;  // inclusive product scan over the ray's lanes
#pragma unroll
  for (int off = 1; off < L; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, incl, off, L);
    if (li >= off) incl *= up;
  }
  float front = __shfl_up_sync(kFullMask, incl, 1, L);
  front = acc.carry * (li == 0 ? 1.f : front);
  acc.w += front * w;
  acc.depth += front * depth;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc.rgb[ch] += front * rgb[ch];
  acc.carry *= __shfl_sync(kFullMask, incl, L - 1, L);
}

// Sums the partial sums over the ray's L lanes and, on its first lane and
// if the ray exists, writes its results; with last_back the ray's last
// sample (offset `last`) takes the weight that the others left.
template <int C, int L>
__device__ __forceinline__ void finish(Sums<C> acc, const float* ts, const float* cs, int last,
                                       int last_back, int li, bool exists, long long ray,
                                       float* rgb_out, float* depth_out, float* wsum_out,
                                       float* ftrans_out) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    acc.w += __shfl_xor_sync(kFullMask, acc.w, off);
    acc.depth += __shfl_xor_sync(kFullMask, acc.depth, off);
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc.rgb[ch] += __shfl_xor_sync(kFullMask, acc.rgb[ch], off);
  }
  if (li != 0 || !exists) return;
  float wsum = acc.w;
  if (last_back) {
    const float corr = 1.f - acc.w;
    acc.depth += corr * ts[last];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc.rgb[ch] += corr * cs[last * C + ch];
    wsum += corr;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) rgb_out[ray * C + ch] = acc.rgb[ch];
  depth_out[ray] = acc.depth;
  wsum_out[ray] = wsum;
  ftrans_out[ray] = acc.carry;
}

// A warp marches 32 / L consecutive rays, L lanes each. Shared memory, per
// warp: the depths, raw densities and colours of L K samples of each ray.
// A ray that fits in one pass (S <= L K) makes the warp's arrays one
// contiguous run each; a longer one is marched in passes of L K samples
// with the transmittance carried over.
template <int C, int L, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ray_march_reduced_kernel(const float* __restrict__ colors,     // [N, S, C]
                         const float* __restrict__ densities,  // [N, S]
                         const float* __restrict__ depths,     // [N, S]
                         float* __restrict__ rgb_out,          // [N, C]
                         float* __restrict__ depth_out,        // [N]
                         float* __restrict__ wsum_out,         // [N]
                         float* __restrict__ ftrans_out,       // [N]
                         long long n_rays, int n_steps, int clamp_mode, float sp_beta,
                         float last_delta, int last_back) {
  constexpr int Q = 32 / L, kChunk = L * K;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane / L, li = lane % L;
  const long long ray0 = ((long long)blockIdx.x * kWarpsPerBlock + warp) * Q;
  if (ray0 >= n_rays) return;  // the whole warp leaves together
  const int nq = (int)min((long long)Q, n_rays - ray0);  // rays of this warp
  float* ts = smem + warp * Q * kChunk * (C + 2);
  float* xs = ts + Q * kChunk;
  float* cs = xs + Q * kChunk;
  Sums<C> acc;
  int n = 0;
  for (int s0 = 0; s0 < n_steps; s0 += kChunk) {
    n = min(kChunk, n_steps - s0);
    __syncwarp();  // every lane has marched the pass before
    if (n == n_steps) {
      stage(ts, depths + ray0 * n, nq * n, lane);
      stage(xs, densities + ray0 * n, nq * n, lane);
      stage(cs, colors + ray0 * n * C, nq * n * C, lane);
    } else {
      for (int r = 0; r < nq; ++r) {
        const long long base = (ray0 + r) * n_steps + s0;
        stage(ts + r * n, depths + base, n, lane);
        stage(xs + r * n, densities + base, n, lane);
        stage(cs + r * n * C, colors + base * C, n * C, lane);
      }
    }
    staged();
    const bool more = s0 + n < n_steps;
    const float t_after = more && q < nq ? depths[(ray0 + q) * n_steps + s0 + n] : 0.f;
    march<C, L, K>(ts, xs, cs, InOrder(q * n, li * K), q < nq ? n : 0, more, t_after,
                   clamp_mode, sp_beta, last_delta, li, acc);
  }
  finish<C, L>(acc, ts, cs, q * n + n - 1, last_back, li, q < nq, ray0 + q, rgb_out,
               depth_out, wsum_out, ftrans_out);
}

// A warp marches 32 / L consecutive rays, L lanes each. Shared memory, per
// warp, for its Q rays: the depths (set 1 of every ray, then set 2), and the
// raw densities and colours at the same offsets, in float32 whatever their
// type in device memory (TC, TX: float or bf16). With `Cut`, the clamped
// densities below *thresh are marched as 0.
template <int C, int L, int K, bool Cut, typename TC = float, typename TX = float>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
ray_march_merged_kernel(const float* __restrict__ t1,  // [N, S1] depths, sorted per ray
                        const TC* __restrict__ c1,     // [N, S1, C] colours
                        const TX* __restrict__ x1,     // [N, S1] raw densities
                        const float* __restrict__ t2,  // [N, S2], sorted per ray
                        const TC* __restrict__ c2,     // [N, S2, C]
                        const TX* __restrict__ x2,     // [N, S2]
                        const float* __restrict__ thresh,  // [1] with Cut, else unused
                        float* __restrict__ rgb_out,   // [N, C]
                        float* __restrict__ depth_out, float* __restrict__ wsum_out,
                        float* __restrict__ ftrans_out,  // [N] each
                        long long n_rays, int s1, int s2, int clamp_mode, float sp_beta,
                        float last_delta, int last_back) {
  constexpr int Q = 32 / L;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane / L, li = lane % L;
  const long long ray0 = ((long long)blockIdx.x * kWarpsPerBlock + warp) * Q;
  if (ray0 >= n_rays) return;  // the whole warp leaves together
  const int nq = (int)min((long long)Q, n_rays - ray0);  // rays of this warp
  const int s = s1 + s2;
  float* ts = smem + warp * Q * s * (C + 2);
  float* xs = ts + Q * s;
  float* cs = xs + Q * s;
  // bf16 inputs are staged as they are (every copy in flight at once, as
  // cp.async stages the float32 ones), then widened in place
  constexpr bool kRawX = std::is_same<TX, __nv_bfloat16>::value;
  constexpr bool kRawC = std::is_same<TC, __nv_bfloat16>::value;
  stage(ts, t1 + ray0 * s1, nq * s1, lane);
  stage(ts + Q * s1, t2 + ray0 * s2, nq * s2, lane);
  stage(xs, x1 + ray0 * s1, nq * s1, lane);
  stage(xs + Q * s1, x2 + ray0 * s2, nq * s2, lane);
  stage(cs, c1 + ray0 * s1 * C, nq * s1 * C, lane);
  stage(cs + Q * s1 * C, c2 + ray0 * s2 * C, nq * s2 * C, lane);
  staged();
  if constexpr (kRawX) {
    widen(xs, nq * s1, lane);
    widen(xs + Q * s1, nq * s2, lane);
  }
  if constexpr (kRawC) {
    widen(cs, nq * s1 * C, lane);
    widen(cs + Q * s1 * C, nq * s2 * C, lane);
  }
  const int n = q < nq ? s : 0;
  const Merged merged(ts, q * s1, s1, Q * s1 + q * s2, s2, li * K < n ? li * K : 0);
  Sums<C> acc;
  if constexpr (Cut) {
    march<C, L, K, true>(ts, xs, cs, merged, n, false, 0.f, clamp_mode, sp_beta, last_delta, li,
                         acc, *thresh);
  } else {
    march<C, L, K>(ts, xs, cs, merged, n, false, 0.f, clamp_mode, sp_beta, last_delta, li, acc);
  }
  finish<C, L>(acc, ts, cs, n ? merged.last(ts) : 0, last_back, li, n > 0, ray0 + q, rgb_out,
               depth_out, wsum_out, ftrans_out);
}

// Calls launch(Int<C>{}, Int<L>{}, Int<K>{}) for c channels and a ray of
// `samples` samples (marched in passes of at most kMaxChunk): L = kMinLanes
// and the least power of two K with L K >= samples, or L = kWideLanes and
// K = kMaxPerLane.
template <typename Launch>
int with_widths(int c, int samples, Launch launch) {
  const int s = samples < kMaxChunk ? samples : kMaxChunk;
  auto with_c = [&](auto cc) {
    if (s > kMinLanes * 4) {
      if (s > kMinLanes * kMaxPerLane) return launch(cc, Int<kWideLanes>{}, Int<kMaxPerLane>{});
      return launch(cc, Int<kMinLanes>{}, Int<8>{});
    }
    if (s > kMinLanes * 2) return launch(cc, Int<kMinLanes>{}, Int<4>{});
    if (s > kMinLanes) return launch(cc, Int<kMinLanes>{}, Int<2>{});
    return launch(cc, Int<kMinLanes>{}, Int<1>{});
  };
  switch (c) {
    case 1: return with_c(Int<1>{});
    case 2: return with_c(Int<2>{});
    case 3: return with_c(Int<3>{});
    default: return with_c(Int<4>{});
  }
}

struct Sample {
  float t, delta, sigma, dsigma, e, alpha, factor;
};

__device__ __forceinline__ Sample load_sample(const float* densities, const float* depths,
                                              long long base, int s, int n_steps,
                                              int clamp_mode, float beta, float last_delta) {
  Sample r;
  r.t = depths[base + s];
  r.delta = (s + 1 < n_steps) ? depths[base + s + 1] - r.t : last_delta;
  const float x = densities[base + s];
  r.sigma = clamp_density(x, clamp_mode, beta);
  r.dsigma = clamp_mode == 0 ? 1.f / (1.f + expf(-beta * x)) : x > 0.f ? 1.f : 0.f;
  r.e = expf(-r.delta * r.sigma);
  r.alpha = 1.f - r.e;
  r.factor = (1.f - r.alpha) + 1e-10f;
  return r;
}

// inclusive product scan over the lanes; returns the exclusive one
__device__ __forceinline__ float exclusive_product(float factor, int lane, float* incl_out) {
  float incl = factor;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl *= up;
  }
  float excl = __shfl_up_sync(kFullMask, incl, 1);
  if (lane == 0) excl = 1.f;
  *incl_out = incl;
  return excl;
}

__global__ void __launch_bounds__(32 * kRaysPerBlock)
ray_march_reduced_bwd_kernel(const float* __restrict__ colors,     // [N, S, C]
                             const float* __restrict__ densities,  // [N, S]
                             const float* __restrict__ depths,     // [N, S]
                             const float* __restrict__ g_rgb,      // [N, C]
                             const float* __restrict__ g_depth,    // [N]
                             const float* __restrict__ g_wsum,     // [N]
                             const float* __restrict__ g_ftrans,   // [N]
                             float* __restrict__ g_colors,         // [N, S, C]
                             float* __restrict__ g_densities,      // [N, S]
                             float* __restrict__ g_depths,         // [N, S]
                             long long n_rays, int n_steps, int n_channels,
                             int clamp_mode, float sp_beta, float last_delta,
                             int last_back) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together
  const long long base = ray * n_steps;

  float grgb[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kMaxChannels; ++k)
    if (k < n_channels) grgb[k] = g_rgb[ray * n_channels + k];
  const float gdep = g_depth[ray], gws = g_wsum[ray], gft = g_ftrans[ray];

  auto cot = [&](long long s) {  // a_s
    float a = depths[base + s] * gdep + gws;
    const float* c = colors + (base + s) * n_channels;
#pragma unroll
    for (int k = 0; k < kMaxChannels; ++k)
      if (k < n_channels) a += c[k] * grgb[k];
    return a;
  };
  const float a_last = cot(n_steps - 1);

  // pass 1: the ray's totals: T_S, sum_i w_i and sum_i g_i w_i
  float carry = 1.f, acc_w = 0.f, acc_gw = 0.f;
  for (int s0 = 0; s0 < n_steps; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < n_steps;
    Sample p{0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 1.f};  // an empty lane: factor 1
    float g = 0.f;
    if (valid) {
      p = load_sample(densities, depths, base, s, n_steps, clamp_mode, sp_beta, last_delta);
      g = cot(s);
      if (last_back) g = (s == n_steps - 1) ? 0.f : g - a_last;
    }
    float incl;
    const float excl = exclusive_product(valid ? p.factor : 1.f, lane, &incl);
    const float w = valid ? p.alpha * carry * excl : 0.f;
    acc_w += w;
    acc_gw += g * w;
    carry *= __shfl_sync(kFullMask, incl, 31);
  }
  const float ftrans = carry;
  const float wsum = warp_sum(acc_w);
  const float gw_total = __shfl_sync(kFullMask, warp_sum(acc_gw), 0);
  const float corr = __shfl_sync(kFullMask, 1.f - wsum, 0);

  // pass 2: per-sample gradients
  carry = 1.f;
  float gw_before = 0.f;   // sum_{k < first sample of this round} g_k w_k
  float gd_prev = 0.f;     // gd of the sample before this round's first
  for (int s0 = 0; s0 < n_steps; s0 += 32) {
    const int s = s0 + lane;
    const bool valid = s < n_steps;
    Sample p{0.f, 0.f, 0.f, 0.f, 1.f, 0.f, 1.f};  // an empty lane: factor 1
    float g = 0.f;
    if (valid) {
      p = load_sample(densities, depths, base, s, n_steps, clamp_mode, sp_beta, last_delta);
      g = cot(s);
      if (last_back) g = (s == n_steps - 1) ? 0.f : g - a_last;
    }
    float incl;
    const float excl = exclusive_product(valid ? p.factor : 1.f, lane, &incl);
    const float t_excl = carry * excl;
    const float w = valid ? p.alpha * t_excl : 0.f;
    float gw_incl = g * w;  // inclusive prefix sum over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(kFullMask, gw_incl, off);
      if (lane >= off) gw_incl += up;
    }
    const float suffix = gw_total - (gw_before + gw_incl);
    const float gf = -g * t_excl + (suffix + gft * ftrans) / p.factor;
    const float gd = valid ? gf * (-p.sigma * p.e) : 0.f;
    float gd_left = __shfl_up_sync(kFullMask, gd, 1);
    if (lane == 0) gd_left = gd_prev;
    if (valid) {
      const float w_corr = (last_back && s == n_steps - 1) ? w + corr : w;
      g_densities[base + s] = gf * (-p.delta * p.e) * p.dsigma;
      float gt = w_corr * gdep + (s > 0 ? gd_left : 0.f);
      if (s < n_steps - 1) gt -= gd;
      g_depths[base + s] = gt;
      float* gc = g_colors + (base + s) * n_channels;
#pragma unroll
      for (int k = 0; k < kMaxChannels; ++k)
        if (k < n_channels) gc[k] = w_corr * grgb[k];
    }
    gw_before += __shfl_sync(kFullMask, gw_incl, 31);
    gd_prev = __shfl_sync(kFullMask, gd, 31);
    carry *= __shfl_sync(kFullMask, incl, 31);
  }
}

// Inclusive sum scan over the warp's lanes.
__device__ __forceinline__ float inclusive_sum(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// The backward's derivative (see the note at the top); u_* may be null
// (a zero cotangent). K rounds of 32 samples, K * 32 >= n_steps.
template <int K>
__global__ void __launch_bounds__(32 * kRaysPerBlock)
ray_march_reduced_bwd_bwd_kernel(const float* __restrict__ colors,     // [N, S, C]
                                 const float* __restrict__ densities,  // [N, S]
                                 const float* __restrict__ depths,     // [N, S]
                                 const float* __restrict__ g_rgb,      // [N, C]
                                 const float* __restrict__ g_depth,    // [N]
                                 const float* __restrict__ g_wsum,     // [N]
                                 const float* __restrict__ g_ftrans,   // [N]
                                 const float* __restrict__ u_colors,   // [N, S, C] or null
                                 const float* __restrict__ u_densities,  // [N, S] or null
                                 const float* __restrict__ u_depths,   // [N, S] or null
                                 float* __restrict__ b_colors,         // [N, S, C]
                                 float* __restrict__ b_densities,      // [N, S]
                                 float* __restrict__ b_depths,         // [N, S]
                                 float* __restrict__ b_rgb,            // [N, C]
                                 float* __restrict__ b_depth,          // [N]
                                 float* __restrict__ b_wsum,           // [N]
                                 float* __restrict__ b_ftrans,         // [N]
                                 long long n_rays, int n_steps, int n_channels,
                                 int clamp_mode, float sp_beta, float last_delta,
                                 int last_back) {
  const int lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * kRaysPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // the whole warp leaves together
  const long long base = ray * n_steps;
  const int last = n_steps - 1;

  float grgb[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < kMaxChannels; ++k)
    if (k < n_channels) grgb[k] = g_rgb[ray * n_channels + k];
  const float gdep = g_depth[ray], gws = g_wsum[ray], gft = g_ftrans[ray];
  auto cot = [&](int s) {  // a_s
    float a = depths[base + s] * gdep + gws;
    const float* c = colors + (base + s) * n_channels;
#pragma unroll
    for (int k = 0; k < kMaxChannels; ++k)
      if (k < n_channels) a += c[k] * grgb[k];
    return a;
  };
  const float a_last = cot(last);

  // the backward's values, sample 32 r + lane in slot r
  float t[K], dl[K], sg[K], ds[K], d2[K], e[K], al[K], f[K], T[K], w[K], g[K], gwp[K];
  float carry = 1.f, w_acc = 0.f, gw_before = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = 32 * r + lane;
    const bool valid = s < n_steps;
    t[r] = dl[r] = sg[r] = ds[r] = d2[r] = al[r] = g[r] = 0.f;
    e[r] = f[r] = 1.f;  // an empty slot: factor 1
    if (valid) {
      t[r] = depths[base + s];
      dl[r] = s < last ? depths[base + s + 1] - t[r] : last_delta;
      const float x = densities[base + s];
      sg[r] = clamp_density(x, clamp_mode, sp_beta);
      if (clamp_mode == 0) {
        const float sig = 1.f / (1.f + expf(-sp_beta * x));
        ds[r] = sig;
        d2[r] = sp_beta * sig * (1.f - sig);
      } else {
        ds[r] = x > 0.f ? 1.f : 0.f;
      }
      e[r] = expf(-dl[r] * sg[r]);
      al[r] = 1.f - e[r];
      f[r] = (1.f - al[r]) + 1e-10f;
      g[r] = cot(s);
      if (last_back) g[r] = s == last ? 0.f : g[r] - a_last;
    }
    float incl;
    const float excl = exclusive_product(f[r], lane, &incl);
    T[r] = carry * excl;
    w[r] = valid ? al[r] * T[r] : 0.f;
    w_acc += w[r];
    gwp[r] = gw_before + inclusive_sum(g[r] * w[r], lane);
    gw_before = __shfl_sync(kFullMask, gwp[r], 31);
    carry *= __shfl_sync(kFullMask, incl, 31);
  }
  const float t_s = carry, w_total = warp_allsum(w_acc), gw_total = gw_before;

  // the reverse sweep, part 1: from the outputs back to the suffix sums
  float b_sg[K], b_e[K], b_dl[K], b_ds[K], b_g[K], b_T[K], b_f[K], b_w[K];
  float bG[kMaxChannels] = {0.f, 0.f, 0.f, 0.f};
  float b_gdep = 0.f, b_gws = 0.f, b_ts = 0.f, b_gft = 0.f, q_before = 0.f, bwc_last = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = 32 * r + lane;
    const bool valid = s < n_steps;
    b_sg[r] = b_e[r] = b_dl[r] = b_ds[r] = b_g[r] = b_T[r] = b_f[r] = b_w[r] = 0.f;
    float q = 0.f;
    if (valid) {
      const float ux = u_densities ? u_densities[base + s] : 0.f;
      const float ut = u_depths ? u_depths[base + s] : 0.f;
      const float ut_next = u_depths && s < last ? u_depths[base + s + 1] : 0.f;
      const float wc = (last_back && s == last) ? w[r] + (1.f - w_total) : w[r];
      float bwc = ut * gdep;
      if (u_colors) {
        const float* uc = u_colors + (base + s) * n_channels;
#pragma unroll
        for (int k = 0; k < kMaxChannels; ++k)
          if (k < n_channels) {
            bwc += uc[k] * grgb[k];
            bG[k] += wc * uc[k];
          }
      }
      b_gdep += wc * ut;
      if (s == last) bwc_last = bwc;
      const float b_gd = s < last ? ut_next - ut : 0.f;
      const float suffix = gw_total - gwp[r];
      const float rest = suffix + gft * t_s;
      const float gf = -g[r] * T[r] + rest / f[r];
      const float b_gf = b_gd * (-sg[r] * e[r]) + ux * (-dl[r] * e[r] * ds[r]);
      b_sg[r] = b_gd * gf * (-e[r]);
      b_e[r] = b_gd * gf * (-sg[r]) + ux * gf * (-dl[r] * ds[r]);
      b_dl[r] = ux * gf * (-e[r] * ds[r]);
      b_ds[r] = ux * gf * (-dl[r] * e[r]);
      q = b_gf / f[r];
      b_g[r] = -b_gf * T[r];
      b_T[r] = -b_gf * g[r];
      b_gft += q * t_s;
      b_ts += q * gft;
      b_f[r] = -q * rest / f[r];
      b_w[r] = bwc;
    }
    const float q_incl = inclusive_sum(q, lane);
    const float p = q_before + q_incl - q;  // sum_{i < s} q_i
    b_g[r] += p * w[r];
    b_w[r] += p * g[r];
    q_before += __shfl_sync(kFullMask, q_incl, 31);
  }
  b_ts = warp_allsum(b_ts);
  const float b_wsum_all = last_back ? -__shfl_sync(kFullMask, bwc_last, last & 31) : 0.f;

  // part 2: the weights' cotangent complete, its share of the transmittance
  float bg_rest = 0.f, btt_acc = 0.f;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = 32 * r + lane;
    if (s < n_steps) {
      b_w[r] += b_wsum_all;
      if (s < last) bg_rest += b_g[r];
      b_T[r] += b_w[r] * al[r];
      btt_acc += b_T[r] * T[r];
    }
  }
  bg_rest = warp_allsum(bg_rest);
  const float btt_total = warp_allsum(btt_acc);

  // part 3: through a, the product and the clamp to the inputs
  float btt_before = 0.f, bdl_prev = 0.f;  // the delta cotangent of the round before's last
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int s = 32 * r + lane;
    const bool valid = s < n_steps;
    float bdl = 0.f;
    const float btt = valid ? b_T[r] * T[r] : 0.f;
    const float btt_incl = inclusive_sum(btt, lane);
    if (valid) {
      const float ba = last_back ? (s < last ? b_g[r] : -bg_rest) : b_g[r];
      const float* c = colors + (base + s) * n_channels;
      float* bc = b_colors + (base + s) * n_channels;
#pragma unroll
      for (int k = 0; k < kMaxChannels; ++k)
        if (k < n_channels) {
          bc[k] = ba * grgb[k];
          bG[k] += ba * c[k];
        }
      b_gdep += ba * t[r];
      b_gws += ba;
      const float suffix_tt = btt_total - (btt_before + btt_incl);  // sum_{i > s}
      const float bf = b_f[r] + (suffix_tt + b_ts * t_s) / f[r];
      const float balpha = b_w[r] * T[r] - bf;
      const float be = b_e[r] - balpha;
      bdl = b_dl[r] + be * (-sg[r] * e[r]);
      const float bsg = b_sg[r] + be * (-dl[r] * e[r]);
      b_densities[base + s] = bsg * ds[r] + b_ds[r] * d2[r];
      if (s == last) bdl = 0.f;  // the last delta is a constant
    }
    float bdl_left = __shfl_up_sync(kFullMask, bdl, 1);
    if (lane == 0) bdl_left = bdl_prev;
    if (valid) {
      const float ba = last_back ? (s < last ? b_g[r] : -bg_rest) : b_g[r];
      b_depths[base + s] = ba * gdep - bdl + (s > 0 ? bdl_left : 0.f);
    }
    btt_before += __shfl_sync(kFullMask, btt_incl, 31);
    bdl_prev = __shfl_sync(kFullMask, bdl, 31);
  }
#pragma unroll
  for (int k = 0; k < kMaxChannels; ++k) bG[k] = warp_allsum(bG[k]);
  b_gdep = warp_allsum(b_gdep);
  b_gws = warp_allsum(b_gws);
  b_gft = warp_allsum(b_gft);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kMaxChannels; ++k)
      if (k < n_channels) b_rgb[ray * n_channels + k] = bG[k];
    b_depth[ray] = b_gdep;
    b_wsum[ray] = b_gws;
    b_ftrans[ray] = b_gft;
  }
}

template <bool Cut, typename TC = float, typename TX = float>
int launch_merged(const float* t1, const TC* c1, const TX* x1, const float* t2,
                  const TC* c2, const TX* x2, const float* thresh, float* rgb,
                  float* depth, float* wsum, float* ftrans, long long n_rays, int s1, int s2,
                  int n_channels, int clamp_mode, float sp_beta, float last_delta,
                  int last_back, void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || s1 < 1 || s2 < 1 ||
      s1 + s2 > kMaxMerged || n_rays < 1 || (Cut && thresh == nullptr))
    return (int)cudaErrorInvalidValue;
  return with_widths(n_channels, s1 + s2, [&](auto cc, auto ll, auto kk) {
    constexpr int C = decltype(cc)::value, L = decltype(ll)::value, K = decltype(kk)::value;
    constexpr int kRaysPerBlockHere = kWarpsPerBlock * 32 / L;
    const long long blocks = (n_rays + kRaysPerBlockHere - 1) / kRaysPerBlockHere;
    const size_t smem = sizeof(float) * kRaysPerBlockHere * (s1 + s2) * (C + 2);
    ray_march_merged_kernel<C, L, K, Cut, TC, TX><<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                                                    (cudaStream_t)stream>>>(
        t1, c1, x1, t2, c2, x2, thresh, rgb, depth, wsum, ftrans, n_rays, s1, s2, clamp_mode,
        sp_beta, last_delta, last_back);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// clamp_mode: 0 = softplus, 1 = relu. Requires 1 <= n_channels <= 4, n_steps >= 1.
int tdgp_ray_march_reduced(const float* colors, const float* densities,
                           const float* depths, float* rgb, float* depth,
                           float* wsum, float* ftrans, long long n_rays,
                           int n_steps, int n_channels, int clamp_mode,
                           float sp_beta, float last_delta, int last_back,
                           void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_steps < 1 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  return with_widths(n_channels, n_steps, [&](auto cc, auto ll, auto kk) {
    constexpr int C = decltype(cc)::value, L = decltype(ll)::value, K = decltype(kk)::value;
    constexpr int kRaysPerBlockHere = kWarpsPerBlock * 32 / L;
    const long long blocks = (n_rays + kRaysPerBlockHere - 1) / kRaysPerBlockHere;
    const size_t smem = sizeof(float) * kRaysPerBlockHere * L * K * (C + 2);
    ray_march_reduced_kernel<C, L, K><<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                                        (cudaStream_t)stream>>>(
        colors, densities, depths, rgb, depth, wsum, ftrans, n_rays, n_steps, clamp_mode,
        sp_beta, last_delta, last_back);
    return (int)cudaGetLastError();
  });
}

// The forward over the merge of two per-ray sorted sample sets (depths t,
// colours c, raw densities x; s1 and s2 samples). Same return value and
// clamp modes; requires 1 <= n_channels <= 4, s1, s2 >= 1, s1 + s2 <= 128.
int tdgp_ray_march_merged(const float* t1, const float* c1, const float* x1,
                          const float* t2, const float* c2, const float* x2,
                          float* rgb, float* depth, float* wsum, float* ftrans,
                          long long n_rays, int s1, int s2, int n_channels, int clamp_mode,
                          float sp_beta, float last_delta, int last_back, void* stream) {
  return launch_merged<false>(t1, c1, x1, t2, c2, x2, nullptr, rgb, depth, wsum, ftrans, n_rays,
                              s1, s2, n_channels, clamp_mode, sp_beta, last_delta, last_back,
                              stream);
}

// The same with the quantile cut of the JAX package's eval renders
// (tdgp/rendering/renderer.py:54 _apply_cut_quantile, on its jnp marcher
// there): every clamped density below *thresh (device memory, one float:
// the quantile that the caller took over the clamped densities of both sets)
// is marched as 0. The cut adds one compare and one select per sample and
// a 4-byte read per warp to the forward's traffic.
int tdgp_ray_march_merged_cut(const float* t1, const float* c1, const float* x1,
                              const float* t2, const float* c2, const float* x2,
                              const float* thresh, float* rgb, float* depth, float* wsum,
                              float* ftrans, long long n_rays, int s1, int s2, int n_channels,
                              int clamp_mode, float sp_beta, float last_delta, int last_back,
                              void* stream) {
  return launch_merged<true>(t1, c1, x1, t2, c2, x2, thresh, rgb, depth, wsum, ftrans, n_rays,
                             s1, s2, n_channels, clamp_mode, sp_beta, last_delta, last_back,
                             stream);
}

// The merged forward and its cut with bf16 loads: colours c1, c2 bf16, raw
// densities x1, x2 bf16 where x_bf16 is not 0 and float32 where it is,
// depths and outputs float32. Same requirements and return value.
int tdgp_ray_march_merged_bf16(const float* t1, const __nv_bfloat16* c1, const void* x1,
                               const float* t2, const __nv_bfloat16* c2, const void* x2,
                               float* rgb, float* depth, float* wsum, float* ftrans,
                               long long n_rays, int s1, int s2, int n_channels, int clamp_mode,
                               float sp_beta, float last_delta, int last_back, int x_bf16,
                               void* stream) {
  if (x_bf16)
    return launch_merged<false>(t1, c1, static_cast<const __nv_bfloat16*>(x1), t2, c2,
                                static_cast<const __nv_bfloat16*>(x2), nullptr, rgb, depth, wsum,
                                ftrans, n_rays, s1, s2, n_channels, clamp_mode, sp_beta,
                                last_delta, last_back, stream);
  return launch_merged<false>(t1, c1, static_cast<const float*>(x1), t2, c2,
                              static_cast<const float*>(x2), nullptr, rgb, depth, wsum, ftrans,
                              n_rays, s1, s2, n_channels, clamp_mode, sp_beta, last_delta,
                              last_back, stream);
}

int tdgp_ray_march_merged_cut_bf16(const float* t1, const __nv_bfloat16* c1, const void* x1,
                                   const float* t2, const __nv_bfloat16* c2, const void* x2,
                                   const float* thresh, float* rgb, float* depth, float* wsum,
                                   float* ftrans, long long n_rays, int s1, int s2,
                                   int n_channels, int clamp_mode, float sp_beta,
                                   float last_delta, int last_back, int x_bf16, void* stream) {
  if (x_bf16)
    return launch_merged<true>(t1, c1, static_cast<const __nv_bfloat16*>(x1), t2, c2,
                               static_cast<const __nv_bfloat16*>(x2), thresh, rgb, depth, wsum,
                               ftrans, n_rays, s1, s2, n_channels, clamp_mode, sp_beta,
                               last_delta, last_back, stream);
  return launch_merged<true>(t1, c1, static_cast<const float*>(x1), t2, c2,
                             static_cast<const float*>(x2), thresh, rgb, depth, wsum, ftrans,
                             n_rays, s1, s2, n_channels, clamp_mode, sp_beta, last_delta,
                             last_back, stream);
}

// The backward. Same requirements and return value as the forward.
int tdgp_ray_march_reduced_bwd(const float* colors, const float* densities,
                               const float* depths, const float* g_rgb,
                               const float* g_depth, const float* g_wsum,
                               const float* g_ftrans, float* g_colors,
                               float* g_densities, float* g_depths, long long n_rays,
                               int n_steps, int n_channels, int clamp_mode,
                               float sp_beta, float last_delta, int last_back,
                               void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_steps < 1 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  ray_march_reduced_bwd_kernel<<<(unsigned)blocks, 32 * kRaysPerBlock, 0,
                                 (cudaStream_t)stream>>>(
      colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans, g_colors,
      g_densities, g_depths, n_rays, n_steps, n_channels, clamp_mode, sp_beta,
      last_delta, last_back);
  return (int)cudaGetLastError();
}

// The backward's derivative: the cotangents u_colors, u_densities, u_depths
// (any may be null, for zero) of the backward's outputs -> those of its
// inputs. Requires 1 <= n_channels <= 4 and 1 <= n_steps <= 128.
int tdgp_ray_march_reduced_bwd_bwd(const float* colors, const float* densities,
                                   const float* depths, const float* g_rgb, const float* g_depth,
                                   const float* g_wsum, const float* g_ftrans,
                                   const float* u_colors, const float* u_densities,
                                   const float* u_depths, float* b_colors, float* b_densities,
                                   float* b_depths, float* b_rgb, float* b_depth, float* b_wsum,
                                   float* b_ftrans, long long n_rays, int n_steps,
                                   int n_channels, int clamp_mode, float sp_beta,
                                   float last_delta, int last_back, void* stream) {
  if (n_channels < 1 || n_channels > kMaxChannels || n_steps < 1 || n_steps > 128 || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  auto launch = [&](auto kk) {
    constexpr int K = decltype(kk)::value;
    ray_march_reduced_bwd_bwd_kernel<K><<<(unsigned)blocks, 32 * kRaysPerBlock, 0,
                                          (cudaStream_t)stream>>>(
        colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans, u_colors, u_densities,
        u_depths, b_colors, b_densities, b_depths, b_rgb, b_depth, b_wsum, b_ftrans, n_rays,
        n_steps, n_channels, clamp_mode, sp_beta, last_delta, last_back);
    return (int)cudaGetLastError();
  };
  const int rounds = (n_steps + 31) / 32;
  if (rounds == 1) return launch(Int<1>{});
  if (rounds == 2) return launch(Int<2>{});
  if (rounds == 3) return launch(Int<3>{});
  return launch(Int<4>{});
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
