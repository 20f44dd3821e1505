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
// (tdgp/ops/pallas_kernels.py:188-189). At the served chunk [4, 16384,
// 32 + 32, 3] a call reads 4 + 2 C + 2 bytes a sample, 50.3 MB, and writes
// 1.6 MB: 0.0155 ms at 3.35 TB/s, against 0.0255 ms in float32.
//
// The merged kernel stages each array at its own type's size (bf16 values
// as bf16: a bf16 warp stages 61 % of the float32 entry's bytes) and the
// march widens a bf16 value in a register as it reads it (exact: the
// arithmetic is the float32 entry's). The first design staged bf16 values
// into float32-sized arrays and widened them in place, 32 a step with two
// warp barriers, before any merge: it held as few warps an SM as the
// float32 entry and took its time. Measured by parts (probe_kernels.py
// --only k3_merged_bf16): the march, not the loads, sets the time once the
// widen is gone; a ring of two stages a warp over a grid of one wave, which
// overlaps a warp's next loads with its march, gained nothing over one
// group a warp and was taken out.

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
// sweep's steps; tests/test_torch_ray_march_bwd_bwd.py this kernel's order).
// Besides the forward's scans it takes the exclusive prefix sum of
// q_i = gf_i-bar / f_i (the derivative of the suffix sum sum_{k>i} g_k w_k
// is a prefix sum), and the suffix sum of T_i T_i-bar for the product's
// derivative; with last_back, one ray total more. It reads the three
// inputs and three cotangents and writes three per-sample outputs,
// 2 (C + 2) + (C + 2) floats a sample: at PL's render [8, 4096, 64, 3],
// 119 MB, 0.0355 ms at 3.35 TB/s.
//
// Layout: one ray a warp, lane l of it K consecutive samples l K .. l K +
// K - 1 (K = 1, 2, 4 up to 32, 64, 128 samples; the forwards' 8 or 16 lanes
// a ray, whose lanes hold 8 or 4 samples in registers, measured slower).
// The warp stages every input and cotangent of its ray (one contiguous run
// each) by 16-byte cp.async, all in flight before any sum, and reads the
// colours once from there. Each lane runs its products and its prefix and
// suffix sums over its K samples serially; one scan over the ray's lanes
// turns each into the ray's. A sum over the samples behind one is a suffix
// sum, never the ray's total less a prefix: the sweep divides it by f_i,
// which falls as far as 1e-10 at the last sample of an infinite-depth ray,
// where the suffix is exactly 0 and a difference would leave its rounding.
// The sweep multiplies by 1 / f_i, taken once a
// sample, where it divides by f_i (a division is a branch to its slow
// path). The per-sample outputs go back through the cotangents' shared
// memory and out in contiguous 16-byte runs. The first design marched a
// sample a lane in rounds of 32, loading from device memory in three
// dependent waves (the colours at a 12-byte stride, read twice), with a
// set of scans in every round.

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

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// Copies n values of T (float or bf16) into the warp's shared memory by
// cp.async: 16 bytes a lane where both ends are 16-byte aligned, else (and
// for the tail) a float by a 4-byte cp.async, a bf16 by a plain copy.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n, int lane) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(src) | (uintptr_t)__cvta_generic_to_shared(dst)) & 15) == 0) {
    for (int i = V * lane; i + V <= n; i += 32 * V) cp_async16(dst + i, src + i);
    done = n & ~(V - 1);
  }
  for (int i = done + lane; i < n; i += 32) {
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst + i, src + i);
    } else {
      dst[i] = src[i];
    }
  }
}

// waits for this lane's copies, then makes every lane's visible to the warp
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Copies n floats from the warp's shared memory to device memory: 16 bytes
// a lane where both ends are 16-byte aligned, else (and for the tail) 4.
__device__ __forceinline__ void unstage(float* dst, const float* src, int n, int lane) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    for (int i = 4 * lane; i + 4 <= n; i += 128)
      *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(src + i);
    done = n & ~3;
  }
  for (int i = done + lane; i < n; i += 32) dst[i] = src[i];
}

__device__ __forceinline__ float widened(float v) { return v; }
__device__ __forceinline__ float widened(__nv_bfloat16 v) { return __bfloat162float(v); }

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

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
// densities xs, colours cs [., C], at the same offsets; xs and cs float32,
// or bf16 widened as they are read) on the L lanes of
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
template <int C, int L, int K, bool Cut = false, typename Source, typename TX, typename TC>
__device__ __forceinline__ void march(const float* ts, const TX* xs, const TC* cs,
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
      float sigma = clamp_density(widened(xs[at]), clamp_mode, beta);
      if constexpr (Cut) sigma = sigma < thresh ? 0.f : sigma;
      const float alpha = 1.f - expf(-delta * sigma);
      const float wk = alpha * prod;
      w += wk;
      depth += wk * t;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) rgb[ch] += wk * widened(cs[at * C + ch]);
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
template <int C, int L, typename TC>
__device__ __forceinline__ void finish(Sums<C> acc, const float* ts, const TC* cs, int last,
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
    for (int ch = 0; ch < C; ++ch) acc.rgb[ch] += corr * widened(cs[last * C + ch]);
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

// Bytes of one stage of the merged kernel: Q rays of s samples, their
// depths (float32), raw densities (TX) and colours (TC), each array from a
// 16-byte boundary.
template <int C, typename TC, typename TX>
__host__ __device__ constexpr int merged_stage_bytes(int q, int s) {
  return round16(4 * q * s) + round16((int)sizeof(TX) * q * s) +
         round16((int)sizeof(TC) * q * s * C);
}

// A warp marches Q = 32 / L consecutive rays, L lanes each. Shared memory,
// per warp, for its Q rays: the depths (set 1 of every ray, then set 2),
// and the raw densities and colours at the same offsets, each array at its
// type's size (TC, TX: float or bf16) from a 16-byte boundary. With `Cut`,
// the clamped densities below *thresh are marched as 0.
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
  unsigned char* mine =
      reinterpret_cast<unsigned char*>(smem) + warp * merged_stage_bytes<C, TC, TX>(Q, s);
  float* ts = reinterpret_cast<float*>(mine);
  TX* xs = reinterpret_cast<TX*>(mine + round16(4 * Q * s));
  TC* cs = reinterpret_cast<TC*>(mine + round16(4 * Q * s) + round16((int)sizeof(TX) * Q * s));
  stage(ts, t1 + ray0 * s1, nq * s1, lane);
  stage(ts + Q * s1, t2 + ray0 * s2, nq * s2, lane);
  stage(xs, x1 + ray0 * s1, nq * s1, lane);
  stage(xs + Q * s1, x2 + ray0 * s2, nq * s2, lane);
  stage(cs, c1 + ray0 * s1 * C, nq * s1 * C, lane);
  stage(cs + Q * s1 * C, c2 + ray0 * s2 * C, nq * s2 * C, lane);
  staged();
  const int n = q < nq ? s : 0;
  const Merged merged(ts, q * s1, s1, Q * s1 + q * s2, s2, li * K < n ? li * K : 0);
  Sums<C> acc;
  march<C, L, K, Cut>(ts, xs, cs, merged, n, false, 0.f, clamp_mode, sp_beta, last_delta, li,
                      acc, Cut ? *thresh : 0.f);
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

// Scans over a warp's lanes, which hold one ray (lane: its place).
__device__ __forceinline__ float lanes_product(float v, int lane) {  // inclusive
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v *= up;
  }
  return v;
}

__device__ __forceinline__ float lanes_sum(float v, int lane) {  // inclusive
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFullMask, v, off);
    if (lane >= off) v += up;
  }
  return v;
}

__device__ __forceinline__ float lanes_suffix_sum(float v, int lane) {  // inclusive, from the end
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float down = __shfl_down_sync(kFullMask, v, off);
    if (lane + off < 32) v += down;
  }
  return v;
}

__device__ __forceinline__ float lanes_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// the value of the lane before, `first` on lane 0
__device__ __forceinline__ float lane_before(float v, int lane, float first) {
  const float up = __shfl_up_sync(kFullMask, v, 1);
  return lane == 0 ? first : up;
}

// Floats of one warp's shared memory in the second order: a ray of s
// samples, the colours, densities, depths and their three cotangents, each
// array from a 16-byte boundary.
__host__ __device__ constexpr int bwd_bwd_warp_floats(int c, int s) {
  return 2 * round16(4 * s * c) / 4 + 4 * round16(4 * s) / 4;
}

// The backward's derivative (see the note at the top); u_* may be null (a
// zero cotangent). The warp's ray of n_steps <= 32 K samples; lane l holds
// samples l K + k, k < K, in registers.
template <int C, int K>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
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
                                 long long n_rays, int n_steps, int clamp_mode, float sp_beta,
                                 float last_delta, int last_back) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= n_rays) return;  // the whole warp leaves together
  const int S = n_steps, last = S - 1;
  const int pc = round16(4 * S * C) / 4, p1 = round16(4 * S) / 4;
  float* cs = smem + warp * bwd_bwd_warp_floats(C, S);
  float* xs = cs + pc;
  float* ts = xs + p1;
  float* ucs = ts + p1;  // the cotangents, then the outputs
  float* uxs = ucs + pc;
  float* uts = uxs + p1;
  stage(cs, colors + ray * S * C, S * C, lane);
  stage(xs, densities + ray * S, S, lane);
  stage(ts, depths + ray * S, S, lane);
  if (u_colors) stage(ucs, u_colors + ray * S * C, S * C, lane);
  if (u_densities) stage(uxs, u_densities + ray * S, S, lane);
  if (u_depths) stage(uts, u_depths + ray * S, S, lane);
  float grgb[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) grgb[ch] = g_rgb[ray * C + ch];
  const float gdep = g_depth[ray], gws = g_wsum[ray], gft = g_ftrans[ray];
  staged();
  auto cot = [&](int i) {  // a_i
    float a = ts[i] * gdep + gws;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) a += cs[i * C + ch] * grgb[ch];
    return a;
  };
  auto delta = [&](int i) { return i < last ? ts[i + 1] - ts[i] : last_delta; };
  auto u_weight = [&](int i) {  // the cotangent of the corrected weight w'_i
    float bwc = (u_depths ? uts[i] : 0.f) * gdep;
    if (u_colors) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) bwc += ucs[i * C + ch] * grgb[ch];
    }
    return bwc;
  };
  const float a_last = cot(last);

  // the backward's values: each lane's products and sums over its K samples,
  // relative to the transmittance in front of its first, then the ray's
  float sg[K], ds[K], e[K], inv_f[K], T[K], g[K], rest[K];  // inv_f: 1 / f
  float prod = 1.f, w_lane = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    sg[k] = ds[k] = g[k] = rest[k] = 0.f;
    e[k] = inv_f[k] = 1.f;  // an empty sample: factor 1
    T[k] = prod;
    if (i < S) {
      const float x = xs[i];
      sg[k] = clamp_density(x, clamp_mode, sp_beta);
      ds[k] = clamp_mode == 0 ? 1.f / (1.f + expf(-sp_beta * x)) : x > 0.f ? 1.f : 0.f;
      e[k] = expf(-delta(i) * sg[k]);
      const float f = (1.f - (1.f - e[k])) + 1e-10f;
      inv_f[k] = 1.f / f;
      g[k] = cot(i);
      if (last_back) g[k] = i == last ? 0.f : g[k] - a_last;
      const float w = (1.f - e[k]) * prod;
      w_lane += w;
      rest[k] = g[k] * w;
      prod *= f;
    }
  }
  float gw_after = 0.f;  // the lane's suffix of g w, exclusive: sum over its samples after
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const float gw = rest[k];
    rest[k] = gw_after;
    gw_after += gw;
  }
  const float incl = lanes_product(prod, lane);
  const float front = lane_before(incl, lane, 1.f);
  const float t_s = __shfl_sync(kFullMask, incl, 31);
  const float w_total = lanes_allsum(front * w_lane);
  // sum_{j>i} g w as a suffix sum: exactly 0 behind the last sample (see the note at the top)
  const float gw_beyond = __shfl_down_sync(kFullMask, lanes_suffix_sum(front * gw_after, lane), 1);
  const float gw_lanes_after = lane == 31 ? 0.f : gw_beyond;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    T[k] *= front;
    rest[k] = (gw_lanes_after + front * rest[k]) + gft * t_s;  // sum_{j>i} g w + gft T_S
  }

  // the reverse sweep, part 1: from the outputs back to the suffix sums
  float bG[C] = {}, b_gdep = 0.f, b_ts_lane = 0.f, b_gft = 0.f, q_lane = 0.f;
  float q_ex[K], b_gf[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    q_ex[k] = q_lane;  // sum of q over the lane's samples before this one
    b_gf[k] = 0.f;
    if (i < S) {
      const float ux = u_densities ? uxs[i] : 0.f;
      const float ut = u_depths ? uts[i] : 0.f;
      const float ut_next = u_depths && i < last ? uts[i + 1] : 0.f;
      const float w = (1.f - e[k]) * T[k];
      const float wc = (last_back && i == last) ? w + (1.f - w_total) : w;
      if (u_colors) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) bG[ch] += wc * ucs[i * C + ch];
      }
      b_gdep += wc * ut;
      const float b_gd = i < last ? ut_next - ut : 0.f;
      b_gf[k] = b_gd * (-sg[k] * e[k]) + ux * (-delta(i) * e[k] * ds[k]);
      const float qk = b_gf[k] * inv_f[k];
      b_gft += qk * t_s;
      b_ts_lane += qk * gft;
      q_lane += qk;
    }
  }
  const float q_before = lane_before(lanes_sum(q_lane, lane), lane, 0.f);
  const float b_ts = lanes_allsum(b_ts_lane);
  const float b_wsum_all = last_back ? -u_weight(last) : 0.f;

  // part 2: the weights' cotangent complete, its share of the transmittance
  float b_g[K], b_w[K], btt_after[K];
  float bg_rest_lane = 0.f, btt_lane = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    b_g[k] = b_w[k] = 0.f;
    if (i < S) {
      const float p = q_before + q_ex[k];  // sum_{j < i} q_j
      const float al = 1.f - e[k];
      b_g[k] = -b_gf[k] * T[k] + p * (al * T[k]);
      b_w[k] = (u_weight(i) + p * g[k]) + b_wsum_all;
      if (i < last) bg_rest_lane += b_g[k];
    }
  }
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {  // sum_{j > i} over the lane's samples
    const int i = lane * K + k;
    btt_after[k] = btt_lane;
    if (i < S) btt_lane += (-b_gf[k] * g[k] + b_w[k] * (1.f - e[k])) * T[k];
  }
  const float btt_beyond = __shfl_down_sync(kFullMask, lanes_suffix_sum(btt_lane, lane), 1);
  const float btt_lanes_after = lane == 31 ? 0.f : btt_beyond;
  const float bg_rest = lanes_allsum(bg_rest_lane);

  // part 3: through a, the product and the clamp to the inputs
  float out_x[K], out_t[K], ba[K], bdl[K];
  float b_gws = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    ba[k] = out_x[k] = bdl[k] = 0.f;
    if (i < S) {
      ba[k] = last_back ? (i < last ? b_g[k] : -bg_rest) : b_g[k];
      const float t = ts[i];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) bG[ch] += ba[k] * cs[i * C + ch];
      b_gdep += ba[k] * t;
      b_gws += ba[k];
      const float ux = u_densities ? uxs[i] : 0.f;
      const float ut = u_depths ? uts[i] : 0.f;
      const float ut_next = u_depths && i < last ? uts[i + 1] : 0.f;
      const float b_gd = i < last ? ut_next - ut : 0.f;
      const float dl = delta(i);
      const float gf = -g[k] * T[k] + rest[k] * inv_f[k];
      const float qk = b_gf[k] * inv_f[k];
      const float b_f = -qk * rest[k] * inv_f[k];
      const float bf = b_f + ((btt_lanes_after + btt_after[k]) + b_ts * t_s) * inv_f[k];
      const float balpha = b_w[k] * T[k] - bf;
      const float be = (b_gd * gf * (-sg[k]) + ux * gf * (-dl * ds[k])) - balpha;
      const float bsg = b_gd * gf * (-e[k]) + be * (-dl * e[k]);
      const float d2 = clamp_mode == 0 ? sp_beta * ds[k] * (1.f - ds[k]) : 0.f;
      out_x[k] = bsg * ds[k] + ux * gf * (-dl * e[k]) * d2;
      if (i < last) bdl[k] = ux * gf * (-e[k] * ds[k]) + be * (-sg[k] * e[k]);
    }
  }
  float left = lane_before(bdl[K - 1], lane, 0.f);  // the delta cotangent of the sample before
#pragma unroll
  for (int k = 0; k < K; ++k) {
    out_t[k] = ba[k] * gdep - bdl[k] + left;
    left = bdl[k];
  }
  __syncwarp();  // every lane has read the cotangents: their shared memory takes the outputs
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane * K + k;
    if (i < S) {
      uxs[i] = out_x[k];
      uts[i] = out_t[k];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) ucs[i * C + ch] = ba[k] * grgb[ch];
    }
  }
  __syncwarp();
  unstage(b_colors + ray * S * C, ucs, S * C, lane);
  unstage(b_densities + ray * S, uxs, S, lane);
  unstage(b_depths + ray * S, uts, S, lane);
#pragma unroll
  for (int ch = 0; ch < C; ++ch) bG[ch] = lanes_allsum(bG[ch]);
  b_gdep = lanes_allsum(b_gdep);
  b_gws = lanes_allsum(b_gws);
  b_gft = lanes_allsum(b_gft);
  if (lane == 0) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) b_rgb[ray * C + ch] = bG[ch];
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
    const size_t smem = (size_t)kWarpsPerBlock * merged_stage_bytes<C, TC, TX>(32 / L, s1 + s2);
    ray_march_merged_kernel<C, L, K, Cut, TC, TX><<<(unsigned)blocks, 32 * kWarpsPerBlock, smem,
                                                    (cudaStream_t)stream>>>(
        t1, c1, x1, t2, c2, x2, thresh, rgb, depth, wsum, ftrans, n_rays, s1, s2, clamp_mode,
        sp_beta, last_delta, last_back);
    return (int)cudaGetLastError();
  });
}

// Calls launch(Int<C>{}, Int<K>{}) for the second order of c channels and
// `samples` <= kMaxStepsBwdBwd samples a ray: the least power of two K with
// 32 K >= samples.
constexpr int kMaxStepsBwdBwd = 128;  // samples a ray (MAX_STEPS_BWD_BWD in ops/ray_march.py)
static_assert(32 * 4 >= kMaxStepsBwdBwd, "a ray fits the warp's lanes");
template <typename Launch>
int with_bwd_bwd_widths(int c, int samples, Launch launch) {
  auto with_c = [&](auto cc) {
    if (samples > 64) return launch(cc, Int<4>{});
    if (samples > 32) return launch(cc, Int<2>{});
    return launch(cc, Int<1>{});
  };
  switch (c) {
    case 1: return with_c(Int<1>{});
    case 2: return with_c(Int<2>{});
    case 3: return with_c(Int<3>{});
    default: return with_c(Int<4>{});
  }
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
  if (n_channels < 1 || n_channels > kMaxChannels || n_steps < 1 ||
      n_steps > kMaxStepsBwdBwd || n_rays < 1)
    return (int)cudaErrorInvalidValue;
  return with_bwd_bwd_widths(n_channels, n_steps, [&](auto cc, auto kk) {
    constexpr int C = decltype(cc)::value, K = decltype(kk)::value;
    auto kernel = ray_march_reduced_bwd_bwd_kernel<C, K>;
    const size_t smem = sizeof(float) * kWarpsPerBlock * bwd_bwd_warp_floats(C, n_steps);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    const long long blocks = (n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock;
    kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, smem, (cudaStream_t)stream>>>(
        colors, densities, depths, g_rgb, g_depth, g_wsum, g_ftrans, u_colors, u_densities,
        u_depths, b_colors, b_densities, b_depths, b_rgb, b_depth, b_wsum, b_ftrans, n_rays,
        n_steps, clamp_mode, sp_beta, last_delta, last_back);
    return (int)cudaGetLastError();
  });
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
