// K4: stage 1's exact Voronoi map, the index of the nearest valid feature at
// every voxel, built on the card with no distance tile in device memory, no
// sort and no host read.
//
// It computes what lrr_tpu_torch/ops/voronoi.py::voronoi_map_exact and
// ::voronoi_map_exact_blocked compute (its plain versions), bit for bit:
// int32 [D, H, W], -1 where no feature is valid.  It replaces no Pallas
// kernel: lrr_tpu builds the map with XLA ops (lrr_tpu/ops/voronoi.py, 32-voxel
// blocks), and the port's blocked builder ran the same search as a chain of
// eager kernels over [blocks, voxels, candidates] tiles in device memory.
//
// Arithmetic, the plain builds': a voxel's coordinate is origin[a] +
// float(global index) * spacing[a] (two roundings), the squared distance
// (dx*dx + dy*dy) + dz*dz, every step rounded on its own by the _rn
// intrinsics, so no contraction into an FMA moves a near-tie.  Masked
// features are never candidates.  Among equal distances the lowest feature
// index wins: every comparison is the lexicographic one on (distance,
// index), so the order in which candidates are visited changes no bit.  A
// voxel whose least distance is not below 1e30 reads -1, as in the plain
// builds.
//
// What bounds it on the card: the voxel-candidate pairs' fp32 instructions
// (a distance and a lexicographic select each; nothing of a pair leaves
// registers) and the two sweeps' reads from L2 (every block reads every
// valid feature twice: about 15 GB a map at 320 x 352 x 352 over 50k
// features, which by bytes is most of its time there).  Design:
//   * pack: the valid features, compacted (in any order) into float4
//     (x, y, z, index bits), 16 bytes a feature, read from L2 by every block;
//   * one block of 256 threads a 16^3 block of voxels; a thread holds one
//     x-row of 16 voxels (their x coordinates and best (distance, index) in
//     registers), so dy*dy and dz*dz are computed once a row: 4 fp32
//     operations a pair, not 8;
//   * sweep 1: the least squared distance m from the block's box to a valid
//     feature; r = sqrt(m) + the box's diagonal bounds the distance from any
//     of its voxels to its nearest feature (the triangle inequality through
//     the feature that gives m);
//   * sweep 2: the features within r of the box (with wider margins than
//     `_block_flags`, so the set holds the plain blocked build's: never
//     tighter) are compacted into a shared-memory tile; a full tile is
//     evaluated, then the sweep goes on;
//   * each warp holds a 16 x 8 x 4 sub-block and tests 32 candidates at a
//     time, one a lane, against its own box: a candidate farther from that
//     box than the worst best distance of the warp's voxels (with a margin
//     over the rounding of both distances) cannot win or tie at any of them
//     and is skipped, an exact shortcut that changes no bit; the ballot of
//     the rest is evaluated by every lane for its 16 voxels;
//   * ragged edges: voxels past the map are computed and not written, so
//     any D, H, W is one launch.
// The block edge changes the work, not a bit of the map.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEdge = 16;             // voxels a block edge
constexpr int kThreads = 256;         // an x-row of 16 voxels a thread
constexpr int kPerThread = 4;         // features a thread tests a round
constexpr int kRound = kThreads * kPerThread;
constexpr int kTile = 2 * kRound;     // candidates held in shared memory (32 KB)
constexpr float kBig = 1e30f;         // the plain builds' "no feature" distance

__device__ __forceinline__ float box_d2(float4 p, float3 lo, float3 hi) {
  const float ex = fmaxf(fmaxf(__fsub_rn(lo.x, p.x), __fsub_rn(p.x, hi.x)), 0.0f);
  const float ey = fmaxf(fmaxf(__fsub_rn(lo.y, p.y), __fsub_rn(p.y, hi.y)), 0.0f);
  const float ez = fmaxf(fmaxf(__fsub_rn(lo.z, p.z), __fsub_rn(p.z, hi.z)), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez));
}

__device__ __forceinline__ float coord(float o, float s, int g) {
  return __fadd_rn(o, __fmul_rn((float)g, s));
}

__global__ void __launch_bounds__(256)
pack_kernel(const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
            float4* __restrict__ packed, int* __restrict__ count, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool keep = i < n && mask[i] != 0;
  const unsigned b = __ballot_sync(kFull, keep);
  int base = 0;
  if (lane == 0 && b) base = atomicAdd(count, __popc(b));
  base = __shfl_sync(kFull, base, 0);
  if (keep)
    packed[base + __popc(b & ((1u << lane) - 1u))] =
        make_float4(xyz[3 * (size_t)i], xyz[3 * (size_t)i + 1], xyz[3 * (size_t)i + 2],
                    __int_as_float(i));
}

__global__ void __launch_bounds__(kThreads)
voronoi_kernel(const float4* __restrict__ feat, const int* __restrict__ count,
               const float* __restrict__ origin, const float* __restrict__ spacing,
               int* __restrict__ out, unsigned long long* __restrict__ stats,
               int D, int H, int W) {
  __shared__ float4 tile[kTile];
  __shared__ float red[kThreads / 32];
  __shared__ int tile_n;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nbx = (W + kEdge - 1) / kEdge, nby = (H + kEdge - 1) / kEdge;
  const int bx = blockIdx.x % nbx, by = (blockIdx.x / nbx) % nby, bz = blockIdx.x / (nbx * nby);
  const int nv = *count;
  const float ox = origin[0], oy = origin[1], oz = origin[2];
  const float sx = spacing[0], sy = spacing[1], sz = spacing[2];

  // the block's box and diagonal, as `_block_flags` forms them
  const float3 lo = make_float3(coord(ox, sx, bx * kEdge), coord(oy, sy, by * kEdge),
                                coord(oz, sz, bz * kEdge));
  const float ex = __fmul_rn((float)(kEdge - 1), sx), ey = __fmul_rn((float)(kEdge - 1), sy),
              ez = __fmul_rn((float)(kEdge - 1), sz);
  const float3 hi = make_float3(__fadd_rn(lo.x, ex), __fadd_rn(lo.y, ey), __fadd_rn(lo.z, ez));
  const float diam = __fsqrt_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)), __fmul_rn(ez, ez)));

  // this thread's row: y, z and the 16 x coordinates; the warp's box from
  // the coordinates of its first and last voxels (every voxel inside it)
  const int y0 = by * kEdge + 8 * (warp & 1), z0 = bz * kEdge + 4 * (warp >> 1);
  const int gy = y0 + (lane & 7), gz = z0 + (lane >> 3), gx0 = bx * kEdge;
  const float qy = coord(oy, sy, gy), qz = coord(oz, sz, gz);
  float qx[kEdge], bd[kEdge];
  int bi[kEdge];
#pragma unroll
  for (int j = 0; j < kEdge; ++j) {
    qx[j] = coord(ox, sx, gx0 + j);
    bd[j] = CUDART_INF_F;
    bi[j] = -1;
  }
  float3 wlo, whi;
  {
    const float ax = qx[0], bxx = qx[kEdge - 1];
    const float ay = coord(oy, sy, y0), byy = coord(oy, sy, y0 + 7);
    const float az = coord(oz, sz, z0), bzz = coord(oz, sz, z0 + 3);
    wlo = make_float3(fminf(ax, bxx), fminf(ay, byy), fminf(az, bzz));
    whi = make_float3(fmaxf(ax, bxx), fmaxf(ay, byy), fmaxf(az, bzz));
  }

  // sweep 1: the least squared distance from the block's box to a feature
  float m = CUDART_INF_F;
  for (int f = tid; f < nv; f += kThreads) m = fminf(m, box_d2(feat[f], lo, hi));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, o));
  if (lane == 0) red[warp] = m;
  if (tid == 0) tile_n = 0;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) m = fminf(m, red[w]);
  // `_block_flags` keeps sqrt(d2) <= r (1 + 1e-6) + 1e-3; the wider margins
  // here keep every feature it keeps (with no valid feature m is inf and
  // nothing is kept)
  const float reach = __fadd_rn(__fmul_rn(__fadd_rn(__fsqrt_rn(m), diam), 1.00001f), 1e-2f);
  const float reach2 = __fmul_rn(reach, reach);

  unsigned long long pairs = 0;
  // evaluate tile[0, c) for this thread's row, 32 candidates at a time
  auto evaluate = [&](int c) {
    for (int k0 = 0; k0 < c; k0 += 32) {
      float worst = bd[0];
#pragma unroll
      for (int j = 1; j < kEdge; ++j) worst = fmaxf(worst, bd[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) worst = fmaxf(worst, __shfl_xor_sync(kFull, worst, o));
      // a distance to the box above this cannot be a voxel's best or a tie
      // (both distances carry at most ~10 roundings of 2^-24 each)
      const float limit = __fadd_rn(__fmul_rn(worst, 1.00001f), 1e-20f);
      bool take = false;
      if (k0 + lane < c) take = !(box_d2(tile[k0 + lane], wlo, whi) > limit);
      unsigned want = __ballot_sync(kFull, take);
      if (stats != nullptr) pairs += (unsigned long long)__popc(want) * kEdge;
      while (want) {
        const int t = __ffs(want) - 1;
        want &= want - 1;
        const float4 p = tile[k0 + t];
        const int idx = __float_as_int(p.w);
        const float dy = __fsub_rn(qy, p.y), dz = __fsub_rn(qz, p.z);
        const float dy2 = __fmul_rn(dy, dy), dz2 = __fmul_rn(dz, dz);
#pragma unroll
        for (int j = 0; j < kEdge; ++j) {
          const float dx = __fsub_rn(qx[j], p.x);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), dy2), dz2);
          const bool better = d < bd[j] || (d == bd[j] && idx < bi[j]);
          bd[j] = better ? d : bd[j];
          bi[j] = better ? idx : bi[j];
        }
      }
    }
  };

  // sweep 2: the features within reach, a tile at a time
  unsigned long long kept = 0;
  for (int base = 0; base < nv; base += kRound) {
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int f = base + r * kThreads + tid;
      float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
      bool keep = false;
      if (f < nv) {
        p = feat[f];
        keep = box_d2(p, lo, hi) <= reach2;
      }
      const unsigned b = __ballot_sync(kFull, keep);
      int slot = 0;
      if (lane == 0 && b) slot = atomicAdd(&tile_n, __popc(b));
      slot = __shfl_sync(kFull, slot, 0);
      if (keep) tile[slot + __popc(b & ((1u << lane) - 1u))] = p;
    }
    __syncthreads();
    const int c = tile_n;
    __syncthreads();  // every thread has read the count before it moves again
    if (c > kTile - kRound) {
      evaluate(c);
      kept += c;
      __syncthreads();
      if (tid == 0) tile_n = 0;
      __syncthreads();
    }
  }
  __syncthreads();
  const int c = tile_n;
  evaluate(c);
  kept += c;

  if (gy < H && gz < D) {
    int* row = out + ((size_t)gz * H + gy) * W + gx0;
    const bool whole = gx0 + kEdge <= W && (W & 3) == 0;
    if (whole) {
#pragma unroll
      for (int j = 0; j < kEdge; j += 4)
        *reinterpret_cast<int4*>(row + j) =
            make_int4(bd[j] < kBig ? bi[j] : -1, bd[j + 1] < kBig ? bi[j + 1] : -1,
                      bd[j + 2] < kBig ? bi[j + 2] : -1, bd[j + 3] < kBig ? bi[j + 3] : -1);
    } else {
#pragma unroll
      for (int j = 0; j < kEdge; ++j)
        if (gx0 + j < W) row[j] = bd[j] < kBig ? bi[j] : -1;
    }
  }
  if (stats != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) pairs += __shfl_xor_sync(kFull, pairs, o);
    if (lane == 0) atomicAdd(&stats[0], pairs);
    if (tid == 0) atomicAdd(&stats[1], kept);
  }
}

}  // namespace

// xyz [n, 3] float32, mask [n] bool (one byte), origin [3] and spacing [3]
// float32 (x, y, z), all contiguous on the device; packed: scratch of n
// float4, count: scratch of one int; out [D, H, W] int32.  stats, when not
// null, two zeroed uint64: the voxel-candidate pairs evaluated (a voxel
// past a ragged edge counts too) and the candidates the blocks kept.
// Launches on `stream`, never synchronises.
extern "C" int lrr_voronoi_nearest(const void* xyz, const void* mask, const void* origin,
                                   const void* spacing, void* packed, void* count, void* out,
                                   void* stats, int n, int D, int H, int W, void* stream) {
  if (n < 0 || D <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (n > 0) {
    pack_kernel<<<(n + 255) / 256, 256, 0, s>>>((const float*)xyz, (const unsigned char*)mask,
                                                (float4*)packed, (int*)count, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (long long)((W + kEdge - 1) / kEdge) * ((H + kEdge - 1) / kEdge) *
                           ((D + kEdge - 1) / kEdge);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  voronoi_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      (const float4*)packed, (const int*)count, (const float*)origin, (const float*)spacing,
      (int*)out, (unsigned long long*)stats, D, H, W);
  return (int)cudaGetLastError();
}
