// The quantile threshold of K3's cut entry: a radix select.
//
// Replaces the `jnp.quantile` of the JAX package's eval-time quantile cut
// (tdgp/rendering/renderer.py:54 _apply_cut_quantile), which that package
// takes in XLA, as a sort, in both marches of a render with cut_quantile > 0
// (NFS's depth maps): the coarse march's (renderer.py:80) and the final
// march's over the merged samples (renderer.py:125). It computes what
// `quantile` (tdgp_torch/ops/ray_march.py) computes, jnp.quantile's default
// linear interpolation over all the values:
//   lo, hi = the order statistics of ranks low = floor(q (n - 1)) and
//            high = ceil(q (n - 1)) (weights w_low, w_high taken in float32
//            on the host, as the JAX package takes them)
//   out    = round(lo * w_low + hi * w_high), two rounded products and a
//            rounded sum (no FMA contraction), rounded once to the output's
//            dtype; NaN if any value is NaN.
// The values are the clamped densities of one or two arrays: float32 or bf16
// (widened exactly), clamped here by the marcher's own device function (raw
// densities of the final march: softplus or relu) or taken as they are (the
// coarse march's clamped densities). A zero threshold may differ from the
// sort's in the sign of the zero only: -0 and +0 are different keys here and
// equal values to a sort, which may put either first.
//
// What bounds it on an H100: device memory. It must read the values once:
// at the served chunk [4, 16384, 32 + 32] 4,194,304 float32 densities, 16.8
// MB, 5.0 us at 3.35 TB/s (the coarse march's 2,097,152, 8.4 MB). A sort
// moves the values and their indices through device memory several times
// (0.39 ms at the served chunk on the H100).
//
// What the design does about it: a select needs two order statistics, not
// an order. Each value becomes an order-preserving 32-bit key (the float's
// bits with the sign bit flipped for a positive value, all bits flipped for
// a negative one), and three passes find the keys of ranks low and high
// digit by digit: 11, 11 and 10 bits from the top. Pass 1 reads the values,
// clamps them, writes their keys (to scratch, 4 bytes a value, which stays
// in the 50 MB L2 for the next passes) and counts their top digits in a
// histogram of 2048 bins in shared memory; passes 2 and 3 read the keys and
// count the next digit of the keys that share the prefix found so far for
// rank low (and, where it differs, for rank high: a second histogram). A
// block adds its non-zero bins to device memory with atomics; the last
// block of a pass to finish (a ticket counter) scans the 2048 sums, finds
// the bin that holds each rank and leaves the prefix and the rank within it
// for the next pass; the last block of pass 3 writes the result. A warp
// whose values all fall in one bin adds them with one atomic (relu's zeros,
// or the many equal keys a prefix leaves). Each pass is one launch on the
// caller's stream, after one memset of the counters. On an H100
// (tdgp_torch/probe_kernels.py) the first pass counts about one value per
// SM cycle, whether or not the next loads are in flight and whether or not
// a warp aggregates equal bins first (__match_any_sync: slower), and each
// pass carries a chain of ~7 us (launch, the last atomics, the ticket, one
// block's scan): 0.048 ms warm at the served chunk, ~10x the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "clamp_density.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 2;
constexpr int kUnroll = 8;   // values a lane loads at once
constexpr int kPasses = 3;
constexpr int kBins = 2048;  // 2^11, the widest digit
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int digit_shift(int pass) { return pass == 0 ? 21 : pass == 1 ? 10 : 0; }
__host__ __device__ constexpr int digit_bits(int pass) { return pass == 2 ? 10 : 11; }

// The counters, in device memory, zeroed before pass 1.
struct State {
  unsigned hist[kPasses][2][kBins];  // per pass: the bins of rank low's prefix, of rank high's
  unsigned done[kPasses];            // blocks that have added their bins, per pass
  unsigned nan;                      // 1 if any value is NaN
  unsigned prefix[2];                // the key bits found so far of ranks low and high
  unsigned rank[2];                  // their ranks among the keys with that prefix
};

__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v);
  return b ^ ((b >> 31) ? kFullMask : 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : kFullMask));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// The marcher's clamp (clamp_density.cuh), or none (-1).
__device__ __forceinline__ float clamp_value(float x, int clamp_mode, float beta) {
  return clamp_mode < 0 ? x : clamp_density(x, clamp_mode, beta);
}

// Adds one to bin `bin` of `h` for every lane with `take`; the warp converged.
// Where every taking lane has the same bin, one atomic adds them all.
__device__ __forceinline__ void count(unsigned* h, bool take, unsigned bin, int lane) {
  const unsigned takers = __ballot_sync(kFullMask, take);
  if (takers == 0) return;
  const int leader = __ffs(takers) - 1;
  const unsigned first = __shfl_sync(kFullMask, bin, leader);
  if (__all_sync(kFullMask, !take || bin == first)) {
    if (lane == leader) atomicAdd(h + first, (unsigned)__popc(takers));
  } else if (take) {
    atomicAdd(h + bin, 1u);
  }
}

// Exclusive prefix sum over the block of one value a thread; `total` gets the sum.
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v, unsigned* warp_sums,
                                                        unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned up = __shfl_up_sync(kFullMask, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < kThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned up = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w += up;
    }
    warp_sums[lane] = w;  // inclusive over the warps
  }
  __syncthreads();
  total = warp_sums[kThreads / 32 - 1];
  const unsigned before = warp > 0 ? warp_sums[warp - 1] : 0u;
  __syncthreads();  // warp_sums is free again
  return before + incl - v;
}

struct Shared {
  unsigned hist[2][kBins];
  unsigned warp_sums[32];
  unsigned nan;
  bool last;
};

// The end of a pass: the block adds its bins to the pass's sums; the last
// block to do so finds, for rank low and rank high, the bin that holds it,
// and leaves the prefix and the rank within the bin in `st` (after pass 3:
// writes the result to `out`).
__device__ void finish_pass(Shared& sh, State* st, int pass, bool two, long long low,
                            long long high, float w_low, float w_high, void* out, int bf16_out) {
  __syncthreads();
  for (int t = 0; t < (two ? 2 : 1); ++t)
    for (int i = threadIdx.x; i < kBins; i += kThreads)
      if (sh.hist[t][i]) atomicAdd(&st->hist[pass][t][i], sh.hist[t][i]);
  if (pass == 0 && threadIdx.x == 0 && sh.nan) atomicOr(&st->nan, 1u);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(&st->done[pass], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  const int shift = digit_shift(pass);
  constexpr int kPerThread = kBins / kThreads;
  for (int t = 0; t < 2; ++t) {
    const unsigned* h = st->hist[pass][two ? t : 0];
    const unsigned r = pass == 0 ? (unsigned)(t ? high : low) : __ldcg(&st->rank[t]);
    unsigned mine[kPerThread], sum = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      mine[j] = __ldcg(h + threadIdx.x * kPerThread + j);
      sum += mine[j];
    }
    unsigned total;
    unsigned before = block_exclusive_sum(sum, sh.warp_sums, total);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (r >= before && r < before + mine[j]) {
        const unsigned digit = threadIdx.x * kPerThread + j;
        st->prefix[t] = (pass == 0 ? 0u : __ldcg(&st->prefix[t])) | (digit << shift);
        st->rank[t] = r - before;
      }
      before += mine[j];
    }
    __syncthreads();  // every thread has read rank[t] and prefix[t] before they change
  }
  if (pass != kPasses - 1 || threadIdx.x != 0) return;
  __threadfence();
  const float lo = value_of(__ldcg(&st->prefix[0])), hi = value_of(__ldcg(&st->prefix[1]));
  float v = __fadd_rn(__fmul_rn(lo, w_low), __fmul_rn(hi, w_high));
  if (__ldcg(&st->nan)) v = __uint_as_float(0x7fffffffu);
  if (bf16_out) *static_cast<__nv_bfloat16*>(out) = __float2bfloat16_rn(v);
  else *static_cast<float*>(out) = v;
}

// Pass 1: the values of a [na] then b [nb], clamped, to keys [na + nb];
// their top digits counted.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
quantile_keys_kernel(const T* __restrict__ a, long long na, const T* __restrict__ b,
                     long long nb, int clamp_mode, float beta, unsigned* __restrict__ keys,
                     State* st, long long low, long long high) {
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < kBins; i += kThreads) sh.hist[0][i] = 0;
  if (threadIdx.x == 0) sh.nan = 0;
  __syncthreads();
  const long long n = na + nb;
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  bool nan = false;
  for (long long i0 = ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31)) * kUnroll; i0 < n;
       i0 += step) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + 32 * u + lane;
      v[u] = i < na ? widen(a[i]) : i < n ? widen(b[i - na]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + 32 * u + lane;
      nan |= i < n && isnan(v[u]);
      const unsigned k = key_of(clamp_value(v[u], clamp_mode, beta));
      if (i < n) keys[i] = k;
      count(sh.hist[0], i < n, k >> digit_shift(0), lane);
    }
  }
  if (nan) sh.nan = 1;  // a benign race: every writer writes 1
  finish_pass(sh, st, 0, false, low, high, 0.f, 0.f, nullptr, 0);
}

// Passes 2 and 3: the next digit of the keys that share rank low's prefix
// (and rank high's, in a second histogram where the prefixes differ).
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
quantile_digit_kernel(const unsigned* __restrict__ keys, long long n, State* st, int pass,
                      float w_low, float w_high, void* out, int bf16_out) {
  __shared__ Shared sh;
  const int lane = threadIdx.x & 31;
  const unsigned p0 = st->prefix[0], p1 = st->prefix[1];
  const bool two = p0 != p1;
  for (int i = threadIdx.x; i < 2 * kBins; i += kThreads) sh.hist[i / kBins][i % kBins] = 0;
  __syncthreads();
  const int shift = digit_shift(pass);
  const unsigned above = kFullMask << (shift + digit_bits(pass)), mask = (1u << digit_bits(pass)) - 1;
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long i0 = ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31)) * kUnroll; i0 < n;
       i0 += step) {
    unsigned k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + 32 * u + lane;
      k[u] = i < n ? keys[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = i0 + 32 * u + lane < n;
      const unsigned top = k[u] & above, digit = (k[u] >> shift) & mask;
      count(sh.hist[0], valid && top == p0, digit, lane);
      if (two) count(sh.hist[1], valid && top == p1, digit, lane);
    }
  }
  finish_pass(sh, st, pass, two, 0, 0, w_low, w_high, out, bf16_out);
}

int n_blocks(long long n, int& err) {
  static int n_sms = 0;
  if (n_sms == 0) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) {
      n_sms = 0;
      err = (int)e;
      return 0;
    }
  }
  const long long per_block = (long long)kThreads * kUnroll;
  const long long want = (n + per_block - 1) / per_block, most = (long long)n_sms * kBlocksPerSm;
  return (int)(want < most ? want : most);
}

}  // namespace

extern "C" {

// Bytes of scratch the select needs for n values: the counters and the keys.
long long tdgp_quantile_scratch_bytes(long long n) {
  return (long long)((sizeof(State) + 255) / 256 * 256) + 4 * n;
}

// The quantile of the na + nb values of a and b (float32, or bf16 where
// bf16_in is not 0; b may be null with nb = 0), each clamped first (clamp
// mode 0 softplus(beta x) / beta, 1 relu, -1 none): the order statistics of
// ranks low and high (0 <= low <= high <= low + 1 < na + nb), weighted by
// w_low and w_high, written to out[0] (float32, or bf16 where bf16_out is
// not 0), NaN if any value is NaN. `scratch` holds
// tdgp_quantile_scratch_bytes(na + nb) bytes, 256-byte aligned. Launches
// on `stream` and returns the first CUDA error (0 on success).
int tdgp_quantile_select(const void* a, long long na, const void* b, long long nb, int bf16_in,
                         int clamp_mode, float beta, long long low, long long high, float w_low,
                         float w_high, void* out, int bf16_out, void* scratch, void* stream) {
  const long long n = na + nb;
  if (na < 0 || nb < 0 || n < 1 || n >= (1ll << 32) || low < 0 || high < low ||
      high > low + 1 || high >= n || clamp_mode < -1 || clamp_mode > 1 || (nb > 0 && !b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  State* st = static_cast<State*>(scratch);
  unsigned* keys = reinterpret_cast<unsigned*>(static_cast<char*>(scratch) +
                                               (sizeof(State) + 255) / 256 * 256);
  int err = 0;
  const int blocks = n_blocks(n, err);
  if (err) return err;
  cudaError_t e = cudaMemsetAsync(st, 0, sizeof(State), s);
  if (e != cudaSuccess) return (int)e;
  if (bf16_in)
    quantile_keys_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), na, static_cast<const __nv_bfloat16*>(b), nb,
        clamp_mode, beta, keys, st, low, high);
  else
    quantile_keys_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(a), na, static_cast<const float*>(b), nb, clamp_mode, beta,
        keys, st, low, high);
  e = cudaGetLastError();
  for (int pass = 1; pass < kPasses && e == cudaSuccess; ++pass) {
    quantile_digit_kernel<<<blocks, kThreads, 0, s>>>(keys, n, st, pass, w_low, w_high, out,
                                                     bf16_out);
    e = cudaGetLastError();
  }
  return (int)e;
}

const char* tdgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
