// K5: the ICP's match sampler, one direction of one iteration in one launch:
// each lane's cyclic window of its source permutation, the source rows under
// the lane's mask, the rows mapped through the lane's affine transform, their
// voxels in the target's Voronoi map, and the target rows found there.
//
// It computes what lrr_tpu_torch/estimation/icp.py::sample_matches_plain
// computes (its plain version), bit for bit: the matches' source and target
// rows src, dst [L, m, 8] (src column 7 the source tag under the lane's
// mask), the weight [L, m] (1 where the match is kept, else 0) and the mask
// [L, m].  It replaces no Pallas kernel: lrr_tpu samples with XLA gathers
// (lrr_tpu/estimation/icp.py::_sample_matches_packed, `_take_rows8`), and the
// port ran the same steps as ~50 eager launches a direction, two of them
// 32-byte row gathers (`rows[idx]`, `grid[ids]`) that PyTorch runs at a
// tenth of the card's random-sector rate.
//
// Arithmetic, the plain version's: x - c, then ((A0 xc0 + A1 xc1) + A2 xc2)
// + t a row, (q - origin) / spacing with an IEEE division, rounded half to
// even (rintf), converted toward zero with saturation (NaN reads 0, as the
// card's float-to-int conversion in PyTorch), each axis clamped into the map
// and the flat id ((z H + y) W + x).  Every step is a _rn intrinsic, so no
// contraction into an FMA moves a voxel.  The window index is torch's
// remainder (the sign of the divisor) on int64.
//
// What bounds it on the card: bytes.  A match reads its 8-byte permutation
// entry (coalesced along the window), a 32-byte source row and a mask byte
// from tables that stay in L2 (2 MB and 32 KB a lane at 65,536 features),
// then one random 32-byte row of the target grid (1.3 GB at copd512's map:
// one HBM sector that no other match of the wave is likely to share), and
// writes 16 floats, a weight and a mask byte.  Design:
//   * one thread a (lane, window position), 256 threads a block along one
//     lane's positions: the lane's 15 transform floats and its window
//     (start, length, limit) are loaded once a block into shared memory;
//   * the rows are read as two float4, the grid row as one 32-byte sector;
//   * the outputs are rows, the layout the ICP's ops after the sampler read
//     (views of them, as of the row gathers it replaces: a layout that sums
//     over the matches in another order would move the later results'
//     last bits), so thread j writes the two float4 of row j: every store
//     is coalesced;
//   * without a grid (a map above the baked-grid limit) the voxel's feature
//     index is read from the bare map and that feature's row from the target
//     rows, or the zero row for an empty voxel, in the same kernel.
// Nothing is allocated, sorted or read back on the host.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Lane {
  float a[9], t[3], c[3];
  long long start;  // offset mod the window's length
  long long len;    // max(valid count, 1)
  long long limit;  // min(number, valid count, cap)
};

// torch.remainder on int64: the result takes the sign of the divisor
__device__ __forceinline__ long long remainder(long long a, long long b) {
  const long long r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ int clamp_axis(int g, int n) { return min(max(g, 0), n - 1); }

__global__ void __launch_bounds__(kThreads)
sample_kernel(const long long* __restrict__ order, const float4* __restrict__ rows,
              const unsigned char* __restrict__ lane_mask, const long long* __restrict__ valid,
              const long long* __restrict__ offset, const long long* __restrict__ number,
              const float* __restrict__ A, const float* __restrict__ T,
              const float* __restrict__ C, const float* __restrict__ origin,
              const float* __restrict__ spacing, const float4* __restrict__ grid,
              const int* __restrict__ index_vol, const float4* __restrict__ dst_rows,
              float* __restrict__ src_out, float* __restrict__ dst_out,
              float* __restrict__ weight, unsigned char* __restrict__ mask,
              long long order_cols, long long mask_cols, int m, long long p0, long long cap,
              int D, int H, int W) {
  __shared__ Lane lane;
  const int l = blockIdx.y, tid = threadIdx.x;
  if (tid < 9) {
    lane.a[tid] = A[9 * (size_t)l + tid];
  } else if (tid < 12) {
    lane.t[tid - 9] = T[3 * (size_t)l + tid - 9];
  } else if (tid < 15) {
    lane.c[tid - 12] = C[3 * (size_t)l + tid - 12];
  } else if (tid == 15) {
    const long long n = valid[l], num = number[l];
    lane.len = n > 1 ? n : 1;
    lane.start = remainder(offset[l], lane.len);
    const long long lim = num < n ? num : n;
    lane.limit = lim < cap ? lim : cap;
  }
  __syncthreads();
  const int j = blockIdx.x * kThreads + tid;
  if (j >= m) return;

  // the source: window position p of the lane's permutation
  const long long p = p0 + j;
  const long long at = remainder(lane.start + p, lane.len);
  const long long i = order[(size_t)l * order_cols + at];
  const float4 s0 = rows[2 * i], s1 = rows[2 * i + 1];
  const float tag = lane_mask[(size_t)l * mask_cols + i] != 0 ? s1.w : 0.0f;
  const bool sel = p < lane.limit && tag > 0.5f;

  // the mapped point's voxel
  const float xc0 = __fsub_rn(s0.x, lane.c[0]), xc1 = __fsub_rn(s0.y, lane.c[1]),
              xc2 = __fsub_rn(s0.z, lane.c[2]);
  int g[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float q = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(lane.a[3 * r], xc0), __fmul_rn(lane.a[3 * r + 1], xc1)),
                  __fmul_rn(lane.a[3 * r + 2], xc2)),
        lane.t[r]);
    g[r] = __float2int_rz(rintf(__fdiv_rn(__fsub_rn(q, origin[r]), spacing[r])));
  }
  const long long id =
      ((long long)clamp_axis(g[2], D) * H + clamp_axis(g[1], H)) * W + clamp_axis(g[0], W);

  // the target row
  float4 d0 = make_float4(0.f, 0.f, 0.f, 0.f), d1 = d0;
  if (grid != nullptr) {
    d0 = grid[2 * id];
    d1 = grid[2 * id + 1];
  } else {
    const int nn = index_vol[id];
    if (nn >= 0) {
      d0 = dst_rows[2 * (long long)nn];
      d1 = dst_rows[2 * (long long)nn + 1];
    }
  }
  const bool ok = sel && d1.w > 0.5f;

  const size_t k = (size_t)l * m + j;
  float4* s = reinterpret_cast<float4*>(src_out) + 2 * k;
  float4* d = reinterpret_cast<float4*>(dst_out) + 2 * k;
  s[0] = s0;
  s[1] = make_float4(s1.x, s1.y, s1.z, tag);
  d[0] = d0;
  d[1] = d1;
  weight[k] = ok ? 1.0f : 0.0f;
  mask[k] = ok ? 1 : 0;
}

}  // namespace

// order [L, order_cols] int64, rows [*, 8] float32 (16-byte aligned),
// lane_mask [L, mask_cols] bool, valid, offset, number [L] int64, A [L, 3, 3],
// t [L, 3], center [L, 3], origin [3], spacing [3] float32; grid [D*H*W, 8]
// float32 (16-byte aligned), or null and then index_vol [D, H, W] int32 and
// dst_rows [*, 8] float32 (16-byte aligned); outputs src, dst [L, m, 8]
// float32 (16-byte aligned), weight [L, m] float32, mask [L, m] bool.  All
// contiguous on the device.  Window positions p0 .. p0 + m - 1; cap the
// window's capacity.
// Launches on `stream`, never synchronises.
extern "C" int lrr_sample_matches(const void* order, const void* rows, const void* lane_mask,
                                  const void* valid, const void* offset, const void* number,
                                  const void* A, const void* t, const void* center,
                                  const void* origin, const void* spacing, const void* grid,
                                  const void* index_vol, const void* dst_rows, void* src_out,
                                  void* dst_out, void* weight, void* mask, long long order_cols,
                                  long long mask_cols, int L, int m, long long p0,
                                  long long cap, int D, int H, int W, void* stream) {
  if (L < 0 || m < 0 || L > 65535 || order_cols <= 0 || D <= 0 || H <= 0 || W <= 0 ||
      (grid == nullptr && (index_vol == nullptr || dst_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (L == 0 || m == 0) return (int)cudaSuccess;
  const dim3 blocks((m + kThreads - 1) / kThreads, L);
  sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)order, (const float4*)rows, (const unsigned char*)lane_mask,
      (const long long*)valid, (const long long*)offset, (const long long*)number,
      (const float*)A, (const float*)t, (const float*)center, (const float*)origin,
      (const float*)spacing, (const float4*)grid, (const int*)index_vol,
      (const float4*)dst_rows, (float*)src_out, (float*)dst_out, (float*)weight,
      (unsigned char*)mask, order_cols, mask_cols, m, p0, cap, D, H, W);
  return (int)cudaGetLastError();
}
