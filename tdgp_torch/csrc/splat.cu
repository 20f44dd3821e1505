// Kernel K1: the backward of tri-plane bilinear sampling, as a binned splat.
//
// Replaces the TPU kernel `_splat_kernel` (tdgp/ops/splat.py:258, launched
// by `_splat_table` :451) and its wide-window variant `_splat_kernel_wide`
// (:365, K2), which compute the same function. The forward, sampled in both
// packages outside any kernel, is
//   out[n,p,:] = 1/3 sum_k sum_c w_c(n,k,p) * planes[3n+k, y_c, x_c, :]
// over the planes k = xy, xz, yz and the 4 bilinear corners c of each
// (align_corners=True; a corner outside the plane has weight 0, as
// `_corner_meta` :153-175 masks it). Given the cotangent g[n,p,:] this
// kernel computes
//   g_planes[3n+k, y_c, x_c, :] = sum of w_c * g[n,p,:] / 3   (the splat)
//   g_coords[n,p,:]  from d out / d (gx, gy) of each plane, with the corner
//                    values of the planes (`_coords_grad` :973-999),
//                    chained through gx = (c/scale + 1)(W-1)/2.
//
// What bounds it on an H100: device memory, through gathers. The least it
// must move is the cotangent and the coordinates read once, each plane texel
// that some point's corners touch read once (for the coordinate gradient),
// and g_planes and g_coords written once. At batch 16, 64^2 x 32 samples per
// pass and planes 48 x 512^2 x 32 float32, g_planes alone is 1.61 GB
// (~0.5 ms at 3.35 TB/s). A warp per point with float32 atomics into a
// zeroed g_planes (the design before this one) adds the zero fill and the
// atomics' read and write-back of 25 M scattered 128-byte rows of a buffer
// 30 times the L2.
//
// What the design does about it: as the TPU kernel sorted its entries by
// window, this one bins them by strip, a STRIP_H x STRIP_W = 4 x 8 texel
// region of one plane, and gives each strip one warp, which sums the strip
// in its own shared memory and writes it to g_planes once, with 16-byte
// stores, empty strips included (they read nothing and write zeros). No
// zero fill, no global atomic into g_planes, and no texel written twice.
//  - Bins: a histogram kernel counts the entries of each strip and gives
//    each (entry, strip) its index in the strip, torch sums the counts into
//    offsets, and a light pass places the entries (`ops/splat.py` `_bins` is
//    the same arithmetic in torch). The histogram gathers a block's entries
//    by strip in a shared-memory table first, so that the samples of
//    neighbouring rays, which fall on the same strips, cost one global
//    atomic per strip and block, whose old value is the block's first index
//    in the strip.
//    An entry goes to the strip of its base corner (its home) and, where
//    its 2x2 footprint reaches into them, to the strips on the right, below
//    and diagonally below, so that every warp walks its own bin only (the
//    halo choice: copies of the edge entries, in place of a side buffer and
//    a second pass; `chip_smoke.py` prints how many).
//  - Why a warp per strip and not a block per 16 x 16 tile: a float
//    atomicAdd to shared memory is a compare-and-swap loop on this card, so
//    the warps of a block cannot share an accumulator cheaply; a block whose
//    warps own rows of a tile has to stage its bin chunk by chunk between
//    barriers and idles on the busiest warp; and a 17 x 17 x F halo of the
//    planes in shared memory (37 KB) costs more occupancy than the 5 x 9
//    texels a strip's entries read again and again cost through the L1.
//    Each of these was slower on the training step's points, and so were
//    strips of other shapes (2 x 16, 4 x 16, 8 x 8).
//  - The warp streams its bin 32 entries at a time, lane l computing entry
//    l's corners while the next 32 entries and their coordinates load; then
//    it walks them 8 at a time (the group walk, splat_group_kernel: F / 8
//    lanes an entry, 8 features a lane), every lane's cotangent row and,
//    for an entry whose home the strip is, its four corner rows in flight
//    before any sum. The entries with the same corners in a step (a run: the
//    samples of neighbouring rays on one texel) go in rounds, one entry of
//    each run a round, and a round adds its corners into the strip's
//    float32 accumulator one corner index at a time. A home entry's (dtx,
//    dty) reduce over its lanes; a second, small kernel combines each
//    point's three (dtx, dty) into g_coords. Without the coordinate
//    gradient nothing of `planes` is read. A step costs one round trip to
//    memory, where a walk of 4 entries a step that read a run's corners
//    when the run began waited once per 4 entries and once per run.
// The order of the bins' atomics changes from run to run, so the order of
// the float32 sums does too, and they change by rounding.
//
// The bf16 entry (tdgp_triplane_splat_bf16) is the backward of sampling bf16
// planes, the bf16 render views' (generator.render_bf16, in Gmain under
// training.gmain_render_bf16). It takes the same bins and strips, reading
// bf16 planes (for the coordinate gradient) and a bf16 cotangent, each row
// g / 3 rounded to bf16 as the plain version's bf16 division rounds it,
// summing in float32 as above, and storing g_planes in bf16, rounded once,
// or in float32; it may add a float32 addend (another pass's sum, read
// once) to each strip before the store. A render's fine pass stores its
// float32 sum, and its coarse pass adds it and rounds the total: one rounding for both
// passes, as the JAX package's TPU route rounds its merged coarse + fine
// table once (tdgp/ops/splat.py:1030-1033, merged_splat). Its least traffic
// on the training step's points is the float32 entry's with the cotangent
// and the touched texels in 2 bytes, the float32 addend read and g_planes
// written in 2 bytes (ops/splat.py and chip_smoke.py count it).

// Second order (a gradient of a gradient through the sampler: the 3DGP
// model's path-length regularization, loss.pl_weight > 0). The JAX package
// differentiates its sampler's backward again by autodiff; here the
// backward (g_planes, g_coords) = B(planes, coords, g) is differentiated by
// two entries, given the cotangents U_planes [3N, H, W, F] and U_coords
// [N, P, 3] of its outputs. With w_c the bilinear weights of an entry, m_c
// its corner masks, and (du, dv) = (U_coords on the plane's two axes) x
// (sx, sy):
//  - tdgp_triplane_splat_gather: per point, d/dg = 1/3 sum over the planes
//    of sum_c m_c (w_c U_planes[c] + (du dw_c/dtx + dv dw_c/dty) planes[c])
//    (a bilinear gather of U_planes, and one of the planes with the weights'
//    derivatives), and d/dcoords from d/dtx = <g/3, sum_c m_c dw_c/dtx
//    U_planes[c]> + dv X and d/dty = <g/3, sum_c m_c dw_c/dty U_planes[c]>
//    + du X, X = <g/3, v00 - v01 - v10 + v11> the weights' cross term
//    d^2/dtx dty (the terms in tx^2 and ty^2 are zero, the masks and floor
//    have no derivative). F / 4 lanes a point, 4 features a lane, every
//    row of the point in flight before the sums; without U_coords nothing
//    of `planes` is read.
//  - tdgp_triplane_splat_dcoords: d/dplanes = the scatter of g/3 with the
//    derivative weights du dw_c/dtx + dv dw_c/dty: K1's strip kernel on the
//    same bins, with those weights in place of w_c, float32 out (plane
//    gradients accumulate in float32). It is zero where U_coords is (as in
//    the path-length phase, whose coordinates do not depend on ws), and
//    then not launched.
// Both are bound by device memory, as K1 is: at PL's points (8 x 64^2 x 32 a
// pass, planes 24 x 512^2 x 32) the gather must read the touched texels of
// U_planes, g and the coordinates and write g's and the coordinates'
// cotangents (0.95 GB, 0.28 ms at 3.35 TB/s); the scatter writes the whole
// plane gradient once (0.96 GB). The gather reads each of its 12 corner rows
// per point through the L1 (neighbouring samples of a ray, in one warp,
// share texels); the scatter inherits K1's strips, which write each texel
// once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kStripH = 4, kStripW = 8;  // texels of a strip (ops/splat.py STRIP_H, STRIP_W)
constexpr int kWarps = 2;      // strips of a block, one warp each
constexpr unsigned kFullMask = 0xffffffffu;

struct Geometry {
  int points_per_batch, height, width, strips_y, tiles_x;
  float inv_scale;  // float32(1 / scale)
};

// The plane-pixel coordinates (gx, gy) of a point whose coordinates on the
// plane's two axes are (u, v), rounded step by step as ops/splat.py
// `_plane_coords` computes them with PyTorch on the card (it divides by the
// scalar scale as a product with its float32 reciprocal), so that the
// kernels and the plain versions see the same corners.
__device__ __forceinline__ float2 pixel_xy(float u, float v, const Geometry& geo) {
  const float gx = __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(u, geo.inv_scale), 1.f), 0.5f),
                             (float)(geo.width - 1));
  const float gy = __fmul_rn(__fmul_rn(__fadd_rn(__fmul_rn(v, geo.inv_scale), 1.f), 0.5f),
                             (float)(geo.height - 1));
  return make_float2(gx, gy);
}

// The same for point `row` of coords [., 3] on plane k (x/y, x/z, y/z).
__device__ __forceinline__ float2 plane_xy(const float* __restrict__ coords, long long row, int k,
                                           const Geometry& geo) {
  const float* c = coords + row * 3;
  return pixel_xy(c[k == 2 ? 1 : 0], c[k == 0 ? 1 : 2], geo);
}

// The bins of entry (plane, gx, gy), as ops/splat.py `_bins` keys them: its
// home strip, then the strips on the right, below and diagonally below where
// its footprint reaches into them; -1 for none.
__device__ __forceinline__ void entry_keys(float2 q, int plane, const Geometry& geo,
                                           int (&keys)[4]) {
  keys[0] = keys[1] = keys[2] = keys[3] = -1;
  if (!(q.x >= -1.f && q.x < (float)geo.width && q.y >= -1.f && q.y < (float)geo.height))
    return;  // no corner in the plane
  const int x0 = (int)floorf(q.x), y0 = (int)floorf(q.y);
  const int home =
      (plane * geo.strips_y + max(y0, 0) / kStripH) * geo.tiles_x + max(x0, 0) / kStripW;
  const bool cross_x = x0 >= 0 && x0 % kStripW == kStripW - 1 && x0 + 1 < geo.width;
  const bool cross_y = y0 >= 0 && y0 % kStripH == kStripH - 1 && y0 + 1 < geo.height;
  keys[0] = home;
  if (cross_x) keys[1] = home + 1;
  if (cross_y) keys[2] = home + geo.tiles_x;
  if (cross_x && cross_y) keys[3] = home + geo.tiles_x + 1;
}

__device__ __forceinline__ void keys_of(const float* __restrict__ coords, long long e,
                                        long long n_entries, const Geometry& geo,
                                        int (&keys)[4]) {
  keys[0] = keys[1] = keys[2] = keys[3] = -1;
  if (e >= n_entries) return;
  const int plane = (int)(e / geo.points_per_batch);
  const long long point = e - (long long)plane * geo.points_per_batch;
  entry_keys(plane_xy(coords, (long long)(plane / 3) * geo.points_per_batch + point, plane % 3,
                      geo),
             plane, geo, keys);
}

// A block's distinct bins in shared memory: open addressing over kSlots
// slots, each a bin and how many of the block's entries it holds. A block of
// kBinThreads entries has at most 4 kBinThreads keys, under kSlots, so the
// table never fills. Integer atomics in shared memory are native.
constexpr int kBinThreads = 256;
constexpr int kSlots = 2048;

struct BinTable {
  int key[kSlots], count[kSlots], base[kSlots];
};

__device__ __forceinline__ void clear(BinTable& t) {
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x) {
    t.key[i] = -1;
    t.count[i] = 0;
  }
}

// The slot of bin k, claimed if new.
__device__ __forceinline__ int slot_of(BinTable& t, int k) {
  int h = (int)(((unsigned)k * 2654435761u) >> 21) & (kSlots - 1);
  while (true) {
    const int prev = atomicCAS(&t.key[h], -1, k);
    if (prev == -1 || prev == k) return h;
    h = (h + 1) & (kSlots - 1);
  }
}

// For each key of the thread's entry: its slot and its rank among the
// block's entries of that bin. Lanes of a warp with the same key make one
// shared atomic (the samples of one ray often share a bin).
__device__ __forceinline__ void insert_keys(BinTable& t, const int (&keys)[4], int (&slot)[4],
                                            int (&rank)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned peers = __match_any_sync(kFullMask, keys[i]);
    const int leader = __ffs(peers) - 1;
    int s = 0, first = 0;
    if (keys[i] >= 0 && lane == leader) {
      s = slot_of(t, keys[i]);
      first = atomicAdd(&t.count[s], __popc(peers));
    }
    slot[i] = __shfl_sync(kFullMask, s, leader);
    rank[i] = __shfl_sync(kFullMask, first, leader) + __popc(peers & ((1u << lane) - 1u));
  }
}

// counts[b] = the entries of bin b, and ranks[e] = for each key of entry e
// its index among its bin's entries (-1 for none): the old value of the
// block's one global atomic per bin is the block's first index in the bin.
__global__ void __launch_bounds__(kBinThreads)
bin_rank_kernel(const float* __restrict__ coords, int* __restrict__ counts,
                int4* __restrict__ ranks, long long n_entries, Geometry geo) {
  __shared__ BinTable t;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  clear(t);
  __syncthreads();
  int keys[4], slot[4], rank[4];
  keys_of(coords, e, n_entries, geo, keys);
  insert_keys(t, keys, slot, rank);
  __syncthreads();
  for (int i = threadIdx.x; i < kSlots; i += blockDim.x)
    if (t.key[i] >= 0) t.base[i] = atomicAdd(counts + t.key[i], t.count[i]);
  __syncthreads();
  if (e >= n_entries) return;
  int r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = keys[i] >= 0 ? t.base[slot[i]] + rank[i] : -1;
  ranks[e] = make_int4(r[0], r[1], r[2], r[3]);
}

// entries[offsets[b] + rank] = e for every key b of entry e, its rank from
// bin_rank_kernel.
__global__ void bin_place_kernel(const float* __restrict__ coords, const int4* __restrict__ ranks,
                                 const int* __restrict__ offsets, int* __restrict__ entries,
                                 long long n_entries, Geometry geo) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_entries) return;
  int keys[4];
  keys_of(coords, e, n_entries, geo, keys);
  const int4 r4 = ranks[e];
  const int r[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (keys[i] >= 0) entries[offsets[keys[i]] + r[i]] = (int)e;
}

// An entry as the strip kernel sees it: its local corner (ly, lx), ly in
// [-1, kStripH), lx in [-1, kStripW), which of its four corners lie in the
// plane, and whether this strip is its home.
__device__ __forceinline__ int pack_entry(int ly, int lx, bool m00, bool m01, bool m10, bool m11,
                                          bool home) {
  return (ly + 1) | (lx + 1) << 6 | m00 << 12 | m01 << 13 | m10 << 14 | m11 << 15 | home << 16;
}

bool make_geometry(long long n_batch, long long points_per_batch, int height, int width,
                   float inv_scale, Geometry* geo, long long* n_bins) {
  if (n_batch < 1 || points_per_batch < 1 || height < 1 || width < 1 ||
      3 * n_batch * points_per_batch >= (1ll << 31))
    return false;
  geo->points_per_batch = (int)points_per_batch;
  geo->height = height;
  geo->width = width;
  geo->strips_y = (height + kStripH - 1) / kStripH;
  geo->tiles_x = (width + kStripW - 1) / kStripW;
  geo->inv_scale = inv_scale;
  *n_bins = 3 * n_batch * geo->strips_y * geo->tiles_x;
  return *n_bins < (1ll << 31);
}

// a cotangent value's share of one plane: g / 3 (1/3: as torch's g / 3 on the
// card), rounded to bf16 for bf16 planes
template <typename TP>
__device__ __forceinline__ float third_of(float g) {
  const float third = g * (1.f / 3.f);
  if constexpr (std::is_same<TP, float>::value) return third;
  else return __bfloat162float(__float2bfloat16_rn(third));
}

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

// Eight consecutive values of a row, kept as loaded (one 16-byte load of
// bf16, two of float32; the caller keeps the row 16-byte aligned) and read
// as float32: zero until loaded.
struct Row8Bf16 {
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ float operator[](int f) const {  // a bf16 is a float32's high half
    const unsigned w = f < 2 ? u.x : f < 4 ? u.y : f < 6 ? u.z : u.w;
    return __uint_as_float(f & 1 ? w & 0xffff0000u : w << 16);
  }
};
struct Row8F32 {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = make_float4(0.f, 0.f, 0.f, 0.f);
  __device__ __forceinline__ void load(const float* p) {
    a = __ldg(reinterpret_cast<const float4*>(p));
    b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ float operator[](int f) const {
    const float4& h = f < 4 ? a : b;
    const int i = f & 3;
    return i == 0 ? h.x : i == 1 ? h.y : i == 2 ? h.z : h.w;
  }
};
template <typename TP>
using Row8 = typename std::conditional<std::is_same<TP, float>::value, Row8F32, Row8Bf16>::type;

// Blocks of the group walk an SM holds at once, by the planes' type: its
// registers' cap (65536 / (64 x this) a thread), traded between the
// occupancy that hides a step's loads and spills. The fastest of 12, 16 and
// 20 for each (probe_kernels.py): bf16 16 (64 registers), float32 12 (85;
// its rows take twice the registers).
constexpr int kGroupBlocksPerSmBf16 = 16;
constexpr int kGroupBlocksPerSmF32 = 12;
template <typename TP>
constexpr int kGroupBlocksPerSm =
    std::is_same<TP, float>::value ? kGroupBlocksPerSmF32 : kGroupBlocksPerSmBf16;

// The group walk of every entry (K1, its bf16 entry, the second-order
// scatter; see the note at the top): a warp per strip, a group of kLanes =
// F / 8 lanes per entry, 8 features a lane, so a warp walks 32 / kLanes
// entries a step (8 at F = 32). Every lane issues its entry's cotangent row
// (16 bytes of bf16) and, for a home entry, its four corner rows before any
// sum: a step costs one round trip to memory. The runs of a step (its
// entries with the same corners, found by __match_any_sync) are added in
// rounds, one entry of each run a round, and each round adds its four
// corners one corner index at a time with a __syncwarp between: for one
// corner index, entries of two runs touch two texels, so the plain shared
// read-add-writes cannot collide (a float atomicAdd to shared memory is a
// compare-and-swap loop here, ATOMS.CAST.SPIN). A home entry's (dtx, dty),
// from the corner rows' differences feature by feature, reduce over its
// kLanes lanes (the dot products of g / 3 with each corner row, differenced
// after the sums, cancelled to 1.05e-5 of the largest on a training step's
// points).
template <int F, typename TP = float, typename TO = float, bool Deriv = false>
__global__ void __launch_bounds__(32 * kWarps, kGroupBlocksPerSm<TP>)
splat_group_kernel(const TP* __restrict__ planes, const TP* __restrict__ g,
                   const float* __restrict__ coords, const int* __restrict__ entries,
                   const int* __restrict__ offsets, const float* __restrict__ addend,
                   TO* __restrict__ g_planes, float2* __restrict__ d_plane, Geometry geo,
                   int n_bins, const float* __restrict__ u_coords = nullptr, float sx = 0.f,
                   float sy = 0.f) {
  static_assert(F % 8 == 0 && F <= 32, "8 features a lane");
  constexpr int kLanes = F / 8, kGroup = 32 / kLanes, kF4 = F / 4, kTexels = kStripH * kStripW;
  __shared__ __align__(16) float s_acc[kWarps][kTexels * F];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane % kLanes, slot = lane / kLanes;  // features [8q, 8q + 8) of entry `slot`
  const int bin = blockIdx.x * kWarps + warp;
  if (bin >= n_bins) return;  // the whole warp
  float* acc = s_acc[warp];
  const int height = geo.height, width = geo.width;
  const int plane = bin / (geo.strips_y * geo.tiles_x);
  const int t = bin - plane * geo.strips_y * geo.tiles_x;
  const int y_base = (t / geo.tiles_x) * kStripH, x_base = (t % geo.tiles_x) * kStripW;
  const int first = offsets[bin], last = offsets[bin + 1];
  const bool coords_grad = d_plane != nullptr;
  const long long batch_row =  // + entry: the point's row of coords and g
      (long long)(plane / 3) * geo.points_per_batch - (long long)plane * geo.points_per_batch;
  const int k = plane % 3, iu = k == 2 ? 1 : 0, iv = k == 0 ? 1 : 2;  // the plane's two axes
  const TP* plane_base = planes + (long long)plane * height * width * F + 8 * q;

  for (int i = lane; i < kTexels * kF4; i += 32)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  int next_e = 0;
  float next_u = 0.f, next_v = 0.f, next_du = 0.f, next_dv = 0.f;
  auto fetch = [&](int base) {
    if (base + lane < last) {
      next_e = entries[base + lane];
      const float* c = coords + (batch_row + next_e) * 3;
      next_u = c[iu];
      next_v = c[iv];
      if constexpr (Deriv) {
        const float* u = u_coords + (batch_row + next_e) * 3;
        next_du = u[iu] * sx;
        next_dv = u[iv] * sy;
      }
    }
  };
  __syncwarp();

  fetch(first);
  for (int base = first; base < last; base += 32) {
    const int count = min(32, last - base);
    // entry base + lane: its corners
    const int my_e = next_e;
    const float my_du = next_du, my_dv = next_dv;
    const float2 q_xy = pixel_xy(next_u, next_v, geo);
    fetch(base + 32);
    const float fx0 = floorf(q_xy.x), fy0 = floorf(q_xy.y);
    const int x0 = (int)fx0, y0 = (int)fy0;
    const int hy = max(y0, 0) - y_base, hx = max(x0, 0) - x_base;
    const int my_pos = pack_entry(y0 - y_base, x0 - x_base, y0 >= 0 && x0 >= 0,
                                  y0 >= 0 && x0 + 1 < width, y0 + 1 < height && x0 >= 0,
                                  y0 + 1 < height && x0 + 1 < width,
                                  coords_grad && hy >= 0 && hy < kStripH && hx >= 0 && hx < kStripW);
    const float my_tx = q_xy.x - fx0, my_ty = q_xy.y - fy0;

    for (int j = 0; j < count; j += kGroup) {
      const int src = (j + slot) & 31;
      const bool valid = j + slot < count;
      const int e = __shfl_sync(kFullMask, my_e, src);
      const int any_pos = __shfl_sync(kFullMask, my_pos, src);
      const int pos = valid ? any_pos : 0;
      const float tx = __shfl_sync(kFullMask, my_tx, src);
      const float ty = __shfl_sync(kFullMask, my_ty, src);
      float du = 0.f, dv = 0.f;
      if constexpr (Deriv) {
        du = __shfl_sync(kFullMask, my_du, src);
        dv = __shfl_sync(kFullMask, my_dv, src);
      }
      const bool home = valid && (pos >> 16 & 1);
      const int ly = (pos & 63) - 1, lx = (pos >> 6 & 63) - 1;
      // every load of the step before any sum
      Row8<TP> g_row, corner[4];  // the corner texels 00 01 10 11, at the entry's home
      if (valid) g_row.load(g + (batch_row + e) * F + 8 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (home && (pos >> (12 + c) & 1))
          corner[c].load(plane_base +
                         ((long long)(y_base + ly + (c >> 1)) * width + x_base + lx + (c & 1)) * F);
      float gv[8];
#pragma unroll
      for (int f = 0; f < 8; ++f) gv[f] = third_of<TP>(g_row[f]);
      if (coords_grad) {  // uniform: d_plane is the whole warp's
        float dx = 0.f, dy = 0.f;
        if (home) {
#pragma unroll
          for (int f = 0; f < 8; ++f) {
            const float v00 = corner[0][f], v01 = corner[1][f], v10 = corner[2][f],
                        v11 = corner[3][f];
            dx += gv[f] * ((1.f - ty) * (v01 - v00) + ty * (v11 - v10));
            dy += gv[f] * ((1.f - tx) * (v10 - v00) + tx * (v11 - v01));
          }
        }
#pragma unroll
        for (int o = kLanes / 2; o >= 1; o >>= 1) {
          dx += __shfl_xor_sync(kFullMask, dx, o);
          dy += __shfl_xor_sync(kFullMask, dy, o);
        }
        if (home && q == 0) d_plane[e] = make_float2(dx, dy);
      }
      float w[4];
      if constexpr (Deriv) {  // du dw/dtx + dv dw/dty of each corner
        w[0] = -du * (1.f - ty) - dv * (1.f - tx);
        w[1] = du * (1.f - ty) - dv * tx;
        w[2] = -du * ty + dv * (1.f - tx);
        w[3] = du * ty + dv * tx;
      } else {
        w[0] = (1.f - tx) * (1.f - ty);
        w[1] = tx * (1.f - ty);
        w[2] = (1.f - tx) * ty;
        w[3] = tx * ty;
      }
      // the step's runs: rank = how many entries of this entry's run come before it
      const unsigned peers = __match_any_sync(kFullMask, valid ? pos & 0xffff : -1 - slot);
      const int rank = __popc(peers & ((1u << lane) - 1u)) / kLanes;
      const int rounds = (int)__reduce_max_sync(kFullMask, (unsigned)(valid ? rank : 0)) + 1;
      for (int r = 0; r < rounds; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int cy = ly + (c >> 1), cx = lx + (c & 1);
          if (valid && rank == r && (pos >> (12 + c) & 1) && cy >= 0 && cy < kStripH && cx >= 0 &&
              cx < kStripW) {
            float4* a = reinterpret_cast<float4*>(acc + (cy * kStripW + cx) * F + 8 * q);
            float4 lo = a[0], hi = a[1];
            lo.x += w[c] * gv[0], lo.y += w[c] * gv[1], lo.z += w[c] * gv[2], lo.w += w[c] * gv[3];
            hi.x += w[c] * gv[4], hi.y += w[c] * gv[5], hi.z += w[c] * gv[6], hi.w += w[c] * gv[7];
            a[0] = lo, a[1] = hi;
          }
          __syncwarp();
        }
      }
    }
  }
  __syncwarp();

  const int rows = min(kStripH, height - y_base), cols = min(kStripW, width - x_base);
  const long long origin = (((long long)plane * height + y_base) * width + x_base) * F;
  for (int i = lane; i < rows * cols * kF4; i += 32) {
    const int r = i / (cols * kF4), rest = i - r * cols * kF4;
    const long long at = origin + ((long long)r * width * kF4 + rest) * 4;
    float4 v = reinterpret_cast<float4*>(acc)[r * kStripW * kF4 + rest];
    if (addend != nullptr) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(addend + at));
      v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
    }
    store4(g_planes + at, v);
  }
}

// g_coords[n, p] from the (dtx, dty) of the point's x/y, x/z and y/z entries.
__global__ void coords_grad_kernel(const float2* __restrict__ d_plane, float* __restrict__ g_coords,
                                   long long n_points, long long points_per_batch, float sx,
                                   float sy) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_points) return;
  const long long n = i / points_per_batch, point = i - n * points_per_batch;
  const long long e = 3 * n * points_per_batch + point;
  const float2 dxy = d_plane[e], dxz = d_plane[e + points_per_batch];
  const float2 dyz = d_plane[e + 2 * points_per_batch];
  g_coords[i * 3] = dxy.x * sx + dxz.x * sx;
  g_coords[i * 3 + 1] = dxy.y * sy + dyz.x * sx;
  g_coords[i * 3 + 2] = dxz.y * sy + dyz.y * sy;
}

// The second order's gather entry (see the note at the top). kLanes = F / 4
// lanes a point, 4 features a lane (16-byte loads and stores), so a warp
// takes 32 / kLanes consecutive points (4 at F = 32: the neighbouring
// samples of a ray, whose corners meet in the L1). Each lane issues the
// point's g row and its 12 corner rows of u_planes (and 12 of planes with
// u_coords) before any sum; the (dtx, dty) dot products reduce over the
// point's kLanes lanes. UP, UC: whether u_planes, u_coords are given (not
// zero); planes is read only with u_coords.
template <int F, bool UP, bool UC>
__global__ void __launch_bounds__(256)
splat_gather_kernel(const float* __restrict__ planes,    // [3N, H, W, F] or null
                    const float* __restrict__ coords,    // [N, P, 3]
                    const float* __restrict__ g,         // [N, P, F]
                    const float* __restrict__ u_planes,  // [3N, H, W, F] or null
                    const float* __restrict__ u_coords,  // [N, P, 3] or null
                    float* __restrict__ b_g,             // [N, P, F]
                    float* __restrict__ b_coords,        // [N, P, 3]
                    long long n_points, Geometry geo, float sx, float sy) {
  static_assert(F % 4 == 0 && F <= 32, "4 features a lane");
  constexpr int kLanes = F / 4, kPoints = 32 / kLanes;
  const int lane = threadIdx.x & 31, q = lane % kLanes;
  const long long point =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * kPoints + lane / kLanes;
  const bool valid = point < n_points;  // no early return: the lanes reduce together
  const long long at_point = valid ? point : n_points - 1;
  const int height = geo.height, width = geo.width;
  const long long n = at_point / geo.points_per_batch;
  auto row4 = [&](const float* base, long long texel) {
    return __ldg(reinterpret_cast<const float4*>(base + texel * F) + q);
  };
  // every load first: g's row, then per plane its corners' rows
  const float4 g4 = row4(g, at_point);
  float tx[3], ty[3], du[3] = {0.f, 0.f, 0.f}, dv[3] = {0.f, 0.f, 0.f};
  bool in[3][4];
  float4 u[3][4], v[3][4];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float2 p = plane_xy(coords, at_point, k, geo);
    const float fx0 = floorf(p.x), fy0 = floorf(p.y);
    const int x0 = (int)fx0, y0 = (int)fy0;
    tx[k] = p.x - fx0;
    ty[k] = p.y - fy0;
    const bool ys[2] = {y0 >= 0 && y0 < height, y0 + 1 >= 0 && y0 + 1 < height};
    const bool xs[2] = {x0 >= 0 && x0 < width, x0 + 1 >= 0 && x0 + 1 < width};
    const long long base = (3 * n + k) * (long long)height * width + (long long)y0 * width + x0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      in[k][c] = ys[c >> 1] && xs[c & 1];
      const long long texel = base + (long long)(c >> 1) * width + (c & 1);
      u[k][c] = UP && in[k][c] ? row4(u_planes, texel) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[k][c] = UC && in[k][c] ? row4(planes, texel) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    if constexpr (UC) {
      du[k] = u_coords[at_point * 3 + (k == 2 ? 1 : 0)] * sx;
      dv[k] = u_coords[at_point * 3 + (k == 0 ? 1 : 2)] * sy;
    }
  }
  const float gp[4] = {g4.x * (1.f / 3.f), g4.y * (1.f / 3.f), g4.z * (1.f / 3.f),
                       g4.w * (1.f / 3.f)};
  float bg[4] = {0.f, 0.f, 0.f, 0.f}, bt[6];  // bt: (dtx, dty) of each plane, this lane's share
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w[4] = {(1.f - tx[k]) * (1.f - ty[k]), tx[k] * (1.f - ty[k]),
                        (1.f - tx[k]) * ty[k], tx[k] * ty[k]};
    const float dwx[4] = {-(1.f - ty[k]), 1.f - ty[k], -ty[k], ty[k]};  // d w_c / d tx
    const float dwy[4] = {-(1.f - tx[k]), -tx[k], 1.f - tx[k], tx[k]};  // d w_c / d ty
    float ux[4] = {0.f, 0.f, 0.f, 0.f}, uy[4] = {0.f, 0.f, 0.f, 0.f}, cross[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!in[k][c]) continue;
      const float uc[4] = {u[k][c].x, u[k][c].y, u[k][c].z, u[k][c].w};
      const float vc[4] = {v[k][c].x, v[k][c].y, v[k][c].z, v[k][c].w};
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        if constexpr (UP) {
          bg[f] += w[c] * uc[f];
          ux[f] += dwx[c] * uc[f];
          uy[f] += dwy[c] * uc[f];
        }
        if constexpr (UC) {
          bg[f] += (du[k] * dwx[c] + dv[k] * dwy[c]) * vc[f];
          cross[f] += (c == 0 || c == 3 ? vc[f] : -vc[f]);
        }
      }
    }
    float btx = 0.f, bty = 0.f;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      btx += gp[f] * ux[f] + dv[k] * gp[f] * cross[f];
      bty += gp[f] * uy[f] + du[k] * gp[f] * cross[f];
    }
    bt[2 * k] = btx;
    bt[2 * k + 1] = bty;
  }
#pragma unroll
  for (int o = kLanes / 2; o >= 1; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) bt[i] += __shfl_xor_sync(kFullMask, bt[i], o);
  }
  if (!valid) return;
  reinterpret_cast<float4*>(b_g + point * F)[q] =
      make_float4(bg[0] * (1.f / 3.f), bg[1] * (1.f / 3.f), bg[2] * (1.f / 3.f),
                  bg[3] * (1.f / 3.f));
  if (q == 0) {  // x from the x/y and x/z planes' u, y from x/y's v and y/z's u, z from the v's
    b_coords[point * 3] = bt[0] * sx + bt[2] * sx;
    b_coords[point * 3 + 1] = bt[1] * sy + bt[4] * sx;
    b_coords[point * 3 + 2] = bt[3] * sy + bt[5] * sy;
  }
}

// The gather's instantiation for the cotangents given (null ones are zero).
template <int F>
int launch_gather(const float* planes, const float* coords, const float* g, const float* u_planes,
                  const float* u_coords, float* b_g, float* b_coords, long long n_points,
                  const Geometry& geo, float sx, float sy, cudaStream_t s) {
  auto kernel = u_planes != nullptr
                    ? (u_coords != nullptr ? splat_gather_kernel<F, true, true>
                                           : splat_gather_kernel<F, true, false>)
                    : (u_coords != nullptr ? splat_gather_kernel<F, false, true>
                                           : splat_gather_kernel<F, false, false>);
  constexpr long long kPerBlock = 8 * (32 / (F / 4));  // 8 warps of 32 / kLanes points
  kernel<<<(unsigned)((n_points + kPerBlock - 1) / kPerBlock), 256, 0, s>>>(
      planes, coords, g, u_planes, u_coords, b_g, b_coords, n_points, geo, sx, sy);
  return (int)cudaGetLastError();
}

template <int F, typename TP, typename TO>
int launch_strips(const TP* planes, const TP* g, const float* coords, const int* entries,
                  const int* offsets, const float* addend, TO* g_planes, float2* d_plane,
                  long long n_bins, const Geometry& geo, cudaStream_t s) {
  splat_group_kernel<F, TP, TO><<<(unsigned)((n_bins + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>(
      planes, g, coords, entries, offsets, addend, g_planes, d_plane, geo, (int)n_bins, nullptr,
      0.f, 0.f);
  return (int)cudaGetLastError();
}

// The splat of either entry, then the coordinate gradient.
template <typename TP, typename TO>
int splat(const TP* planes, const TP* g, const float* coords, const int* entries,
          const int* offsets, const float* addend, TO* g_planes, float* d_scratch,
          float* g_coords, long long n_batch, long long points_per_batch, int height, int width,
          int feats, float inv_scale, float sx, float sy, cudaStream_t s) {
  Geometry geo;
  long long n_bins;
  const bool coords_grad = g_coords != nullptr;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins) ||
      (coords_grad && (planes == nullptr || d_scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long n_entries = 3 * n_batch * points_per_batch;
  float2* d_plane = coords_grad ? reinterpret_cast<float2*>(d_scratch) : nullptr;
  if (coords_grad) {  // entries with no corner in their plane add nothing
    const cudaError_t err = cudaMemsetAsync(d_scratch, 0, n_entries * sizeof(float2), s);
    if (err != cudaSuccess) return (int)err;
  }
  int err;
  if (feats == 32)
    err = launch_strips<32>(planes, g, coords, entries, offsets, addend, g_planes, d_plane, n_bins,
                            geo, s);
  else if (feats == 16)
    err = launch_strips<16>(planes, g, coords, entries, offsets, addend, g_planes, d_plane, n_bins,
                            geo, s);
  else if (feats == 8)
    err = launch_strips<8>(planes, g, coords, entries, offsets, addend, g_planes, d_plane, n_bins,
                           geo, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || !coords_grad) return err;
  const long long n_points = n_batch * points_per_batch;
  coords_grad_kernel<<<(unsigned)((n_points + 255) / 256), 256, 0, s>>>(d_plane, g_coords,
                                                                        n_points, points_per_batch,
                                                                        sx, sy);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the first CUDA error (0 on success); so do the functions below.
// The bins' sizes and ranks: counts [n_bins] (zeroed here) and ranks
// [3N P] (int4: each key's index in its bin, -1 for none) for coords
// [N, P, 3].
int tdgp_splat_bin_ranks(const float* coords, int* counts, void* ranks, long long n_batch,
                         long long points_per_batch, int height, int width, float inv_scale,
                         void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counts, 0, n_bins * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  const long long n_entries = 3 * n_batch * points_per_batch;
  bin_rank_kernel<<<(unsigned)((n_entries + kBinThreads - 1) / kBinThreads), kBinThreads, 0, s>>>(
      coords, counts, static_cast<int4*>(ranks), n_entries, geo);
  return (int)cudaGetLastError();
}

// The bins' entries from the ranks of tdgp_splat_bin_ranks and the offsets
// [n_bins + 1] (the counts summed): entries [>= offsets[n_bins]] gets plane
// * P + point.
int tdgp_splat_bin_place(const float* coords, const void* ranks, const int* offsets, int* entries,
                         long long n_batch, long long points_per_batch, int height, int width,
                         float inv_scale, void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins))
    return (int)cudaErrorInvalidValue;
  const long long n_entries = 3 * n_batch * points_per_batch;
  bin_place_kernel<<<(unsigned)((n_entries + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      coords, static_cast<const int4*>(ranks), offsets, entries, n_entries, geo);
  return (int)cudaGetLastError();
}

// The splat over the bins of `tdgp_splat_bin_place`: g_planes [3N, H, W, F]
// (needs no zeroing) and, where g_coords is not null, g_coords [N, P, 3]
// through d_scratch [3N, P, 2]; planes is then read, and only then.
// sx = (W - 1) / (2 scale), sy = (H - 1) / (2 scale). F is 8, 16 or 32.
int tdgp_triplane_splat(const float* planes, const float* g, const float* coords,
                        const int* entries, const int* offsets, float* g_planes, float* d_scratch,
                        float* g_coords, long long n_batch, long long points_per_batch, int height,
                        int width, int feats, float inv_scale, float sx, float sy, void* stream) {
  return splat(planes, g, coords, entries, offsets, (const float*)nullptr, g_planes, d_scratch,
               g_coords, n_batch, points_per_batch, height, width, feats, inv_scale, sx, sy,
               (cudaStream_t)stream);
}

// The bf16 entry: planes and g bf16; addend float32 [3N, H, W, F] or null,
// added to each texel's sum; g_planes bf16 where out_bf16 is not 0, else
// float32. Otherwise as tdgp_triplane_splat.
int tdgp_triplane_splat_bf16(const __nv_bfloat16* planes, const __nv_bfloat16* g,
                             const float* coords, const int* entries, const int* offsets,
                             const float* addend, void* g_planes, float* d_scratch,
                             float* g_coords, long long n_batch, long long points_per_batch,
                             int height, int width, int feats, float inv_scale, float sx, float sy,
                             int out_bf16, void* stream) {
  if (out_bf16)
    return splat(planes, g, coords, entries, offsets, addend,
                 static_cast<__nv_bfloat16*>(g_planes), d_scratch, g_coords, n_batch,
                 points_per_batch, height, width, feats, inv_scale, sx, sy, (cudaStream_t)stream);
  return splat(planes, g, coords, entries, offsets, addend, static_cast<float*>(g_planes),
               d_scratch, g_coords, n_batch, points_per_batch, height, width, feats, inv_scale, sx,
               sy, (cudaStream_t)stream);
}

// The second order's gather entry: b_g [N, P, F] and b_coords [N, P, 3]
// from planes (read only with u_coords), coords [N, P, 3], g [N, P, F] and
// the cotangents u_planes [3N, H, W, F] and u_coords [N, P, 3] (either may be
// null, for zero). sx, sy as tdgp_triplane_splat's. F is 8, 16 or 32.
int tdgp_triplane_splat_gather(const float* planes, const float* coords, const float* g,
                               const float* u_planes, const float* u_coords, float* b_g,
                               float* b_coords, long long n_batch, long long points_per_batch,
                               int height, int width, int feats, float inv_scale, float sx,
                               float sy, void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins) ||
      (u_coords != nullptr && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long n_points = n_batch * points_per_batch;
  cudaStream_t s = (cudaStream_t)stream;
  if (feats == 32)
    return launch_gather<32>(planes, coords, g, u_planes, u_coords, b_g, b_coords, n_points, geo,
                             sx, sy, s);
  if (feats == 16)
    return launch_gather<16>(planes, coords, g, u_planes, u_coords, b_g, b_coords, n_points, geo,
                             sx, sy, s);
  if (feats == 8)
    return launch_gather<8>(planes, coords, g, u_planes, u_coords, b_g, b_coords, n_points, geo,
                            sx, sy, s);
  return (int)cudaErrorInvalidValue;
}

// The second order's scatter entry over the bins of tdgp_splat_bin_place:
// g_planes [3N, H, W, F] (float32, needs no zeroing) = the scatter of g / 3
// with the derivative weights of u_coords [N, P, 3]. F is 8, 16 or 32.
int tdgp_triplane_splat_dcoords(const float* g, const float* coords, const float* u_coords,
                                const int* entries, const int* offsets, float* g_planes,
                                long long n_batch, long long points_per_batch, int height,
                                int width, int feats, float inv_scale, float sx, float sy,
                                void* stream) {
  Geometry geo;
  long long n_bins;
  if (!make_geometry(n_batch, points_per_batch, height, width, inv_scale, &geo, &n_bins) ||
      u_coords == nullptr)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_bins + kWarps - 1) / kWarps);
  auto launch = [&](auto kernel) {
    kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        nullptr, g, coords, entries, offsets, nullptr, g_planes, nullptr, geo, (int)n_bins,
        u_coords, sx, sy);
    return (int)cudaGetLastError();
  };
  if (feats == 32) return launch(splat_group_kernel<32, float, float, true>);
  if (feats == 16) return launch(splat_group_kernel<16, float, float, true>);
  if (feats == 8) return launch(splat_group_kernel<8, float, float, true>);
  return (int)cudaErrorInvalidValue;
}

const char* tdgp_splat_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
