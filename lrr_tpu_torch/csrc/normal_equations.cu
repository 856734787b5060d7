// K1: the symmetric Gauss-Newton normal equations of the affine ICP, both
// match directions and the coordinate normalisation in one launch.
//
// Replaces the TPU kernel lrr_tpu/ops/pallas_kernels.py::normal_equations_pallas
// (_neq_kernel), the XLA form the JAX hot loop actually runs,
// lrr_tpu/estimation/icp.py::_normal_equations_packed, and the elementwise
// work XLA fused into it there (lrr_tpu/estimation/icp.py::_estimate_ls_packed:
// normalisation of both point sets, the projector coefficients from the row
// tag, the concatenation of the two directions and the sum of their systems).
//
// Per lane, for each direction (forward, backward) and each match m with
// from-point x, to-point y, projector direction d, tag and weight w:
//   xn = (x - cm) / rm,  yn = (y - cf) / rf         (subtract, then divide)
//   h  = [xn - c; 1],    P = c1*I + c2*d d^T,  (c1, c2) from the tag
//   AtA[4k+l, 4k'+l'] += w Q[k,k'] h_l h_l',   Q = P^T P  (no idempotency assumed)
//   Atb[4k+l]         += w (P^T yn)_k h_l
// w <= 0 contributes nothing, as sqrt(max(w, 0)) does.  Q and h h^T are both
// symmetric, so AtA has 6 x 10 = 60 distinct sums (not 78); with the 12 of
// Atb a thread carries 72 accumulators.
//
// What bounds it on the card: bytes, by the count of the roofline.  A match
// is 11 floats per direction (3 + 3 + 3 + tag + w = 44 B), so 64 lanes x 4096
// matches x 2 directions read 23.1 MB (6.9 us at 3.35 TB/s); the output is
// 40 KB.  Its ~225 flop a match are 0.12 GFLOP (1.8 us at 67 TFLOP/s fp32),
// but they take ~230 issue slots a match, a third of them the six IEEE
// divisions of the normalisation, so on an H100 the kernel is held by
// the issue rate at low occupancy (72 accumulators a thread), not by
// memory: with its inputs already in L2 it is only a quarter faster.
// What the design does about it:
//   * each lane's matches are split over 4, 2 or 1 blocks per direction, as
//     many as keep the grid within two blocks an SM, all resident at once
//     (64 lanes: 2 directions x 2 splits = 256 blocks of 128 threads);
//   * with unit match stride and 16-byte alignment a thread reads four
//     consecutive matches as 11 independent float4 loads (176 B in flight
//     per thread), which is enough outstanding traffic to stream from HBM
//     without cp.async/TMA staging through shared memory: every byte is
//     used once, by one thread, so a shared-memory ring would only add a
//     copy (prefetching the next four matches into registers was tried and
//     lost to the registers it takes).  The ragged tail (M % 4) is read
//     match by match;
//   * inputs are addressed through (lane, component, match) strides, so the
//     row-gathered views the ICP produces ([L, M, 8] rows seen as [L, 3, M])
//     are read in place instead of being copied to a planar layout first;
//     a thread then reads one match, its three components as one float4
//     when the rows are 16-byte aligned, else value by value;
//   * the 2 x splits blocks of a lane form one thread-block cluster.  Each
//     block reduces its 72 sums in a fixed order (a halving shuffle tree of
//     81 shuffles a thread instead of 360, then the warps in order); block 0
//     of the cluster then adds the partial sums in rank order through
//     distributed shared memory and writes the full symmetric AtA [12, 12]
//     and Atb [12].  No atomics and no second launch: two runs give
//     identical bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 4;             // blocks per (lane, direction), at most
constexpr int kBlocksPerSM = 3;           // resident blocks the registers allow
constexpr int kGridPerSM = 2;             // blocks an SM the grid is sized to
constexpr int kPairs = 60;                // 6 (Q) x 10 (h h^T) distinct sums
constexpr int kAcc = kPairs + 12;         // + Atb

struct Direction {
  const float* from;  // [L, 3, M] by strides
  const float* to;
  const float* dir;
  const float* tag;   // [L, M]
  const float* w;
  long long from_s[3], to_s[3], dir_s[3];  // lane, component, match
  long long tag_s[2], w_s[2];              // lane, match
  int M;
};

struct Params {
  Direction d[2];
  const float* cm;      // [L, 3]
  const float* cf;      // [L, 3]
  const float* rm;      // [L]
  const float* rf;      // [L]
  const float* center;  // [L, 3]
  float* ata;           // [L, 12, 12]
  float* atb;           // [L, 12]
};

struct Frame {
  float cm[3], cf[3], c[3], rm, rf;
};

// index of the unordered pair (a, b), a <= b, among 3 or 4 symbols
__host__ __device__ constexpr int pair3(int a, int b) { return a * (5 - a) / 2 + b; }
__host__ __device__ constexpr int pair4(int a, int b) { return a * (7 - a) / 2 + b; }

__device__ __forceinline__ void accumulate(float (&acc)[kAcc], const Frame& f,
                                           const float (&x)[3], const float (&y)[3],
                                           const float (&d)[3], float tag, float w) {
  if (!(w > 0.f)) return;
  float h[3], q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h[i] = __fdiv_rn(x[i] - f.cm[i], f.rm) - f.c[i];
    q[i] = __fdiv_rn(y[i] - f.cf[i], f.rf);
  }
  const float sheet = (tag > 1.5f && tag < 2.5f) ? 1.f : 0.f;
  const float tube = (tag > 2.5f) ? 1.f : 0.f;
  const float c1 = 1.f - sheet;
  const float c2 = sheet - tube;
  // P = c1*I + c2*d d^T is symmetric: 6 distinct entries
  float P[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float bd = c2 * d[i];
#pragma unroll
    for (int k = i; k < 3; ++k) {
      P[i][k] = (i == k ? c1 : 0.f) + bd * d[k];
      P[k][i] = P[i][k];
    }
  }
  float wq[6];  // w * (P^T P)[k, k'], k <= k'
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int kk = k; kk < 3; ++kk)
      wq[pair3(k, kk)] = w * (P[0][k] * P[0][kk] + P[1][k] * P[1][kk] + P[2][k] * P[2][kk]);
  float hh[10];  // h_l h_l', l <= l', h_3 = 1
#pragma unroll
  for (int l = 0; l < 3; ++l) {
#pragma unroll
    for (int ll = l; ll < 3; ++ll) hh[pair4(l, ll)] = h[l] * h[ll];
    hh[pair4(l, 3)] = h[l];
  }
#pragma unroll
  for (int p = 0; p < 6; ++p) {
#pragma unroll
    for (int j = 0; j < 9; ++j) acc[p * 10 + j] = fmaf(wq[p], hh[j], acc[p * 10 + j]);
    acc[p * 10 + 9] += wq[p];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float wptq = w * (P[0][k] * q[0] + P[1][k] * q[1] + P[2][k] * q[2]);
#pragma unroll
    for (int l = 0; l < 3; ++l)
      acc[kPairs + 4 * k + l] = fmaf(wptq, h[l], acc[kPairs + 4 * k + l]);
    acc[kPairs + 4 * k + 3] += wptq;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float pick(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// one match read through the strides
__device__ __forceinline__ void one_match(float (&acc)[kAcc], const Frame& f,
                                          const Direction& dn, const float* px,
                                          const float* py, const float* pd,
                                          const float* pt, const float* pw, int m) {
  const long long mx = m * dn.from_s[2], my = m * dn.to_s[2], md = m * dn.dir_s[2];
  const float x[3] = {px[mx], px[dn.from_s[1] + mx], px[2 * dn.from_s[1] + mx]};
  const float y[3] = {py[my], py[dn.to_s[1] + my], py[2 * dn.to_s[1] + my]};
  const float d[3] = {pd[md], pd[dn.dir_s[1] + md], pd[2 * dn.dir_s[1] + md]};
  accumulate(acc, f, x, y, d, pt[m * dn.tag_s[1]], pw[m * dn.w_s[1]]);
}

// four consecutive matches of a planar direction
struct Group {
  float4 w, t, x[3], y[3], d[3];
  __device__ __forceinline__ void load(const float* px, const float* py, const float* pd,
                                       const float* pt, const float* pw,
                                       const Direction& dn, int m0) {
    w = ld4(pw + m0);
    t = ld4(pt + m0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = ld4(px + i * dn.from_s[1] + m0);
      y[i] = ld4(py + i * dn.to_s[1] + m0);
      d[i] = ld4(pd + i * dn.dir_s[1] + m0);
    }
  }
};

// How a sweep reads its matches: one value at a time through the strides,
// four consecutive matches as float4 (unit match stride), or one match's
// three components as a float4 (unit component stride, rows of 4k floats;
// the fourth value read lies in the same 16-byte granule and is ignored).
enum Mode { kScalar = 0, kPlanar = 1, kRows = 2 };

// one block's share of one direction of one lane
template <int kMode>
__device__ __forceinline__ void sweep(float (&acc)[kAcc], const Frame& f,
                                      const Direction& dn, int lane_id, int split,
                                      int splits, int tid) {
  const float* px = dn.from + lane_id * dn.from_s[0];
  const float* py = dn.to + lane_id * dn.to_s[0];
  const float* pd = dn.dir + lane_id * dn.dir_s[0];
  const float* pt = dn.tag + lane_id * dn.tag_s[0];
  const float* pw = dn.w + lane_id * dn.w_s[0];

  // whole groups of four matches, so a split starts 16-byte aligned
  const int M = dn.M;
  const int groups = (M + 3) / 4;
  const int per_split = (groups + splits - 1) / splits;
  const int g0 = split * per_split;
  const int g1 = min(groups, g0 + per_split);

  if (kMode == kPlanar) {
    for (int g = g0 + tid; g < g1; g += kThreads) {
      const int m0 = 4 * g;
      if (m0 + 3 < M) {
        Group v;
        v.load(px, py, pd, pt, pw, dn, m0);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x[3] = {pick(v.x[0], j), pick(v.x[1], j), pick(v.x[2], j)};
          const float y[3] = {pick(v.y[0], j), pick(v.y[1], j), pick(v.y[2], j)};
          const float d[3] = {pick(v.d[0], j), pick(v.d[1], j), pick(v.d[2], j)};
          accumulate(acc, f, x, y, d, pick(v.t, j), pick(v.w, j));
        }
      } else {  // the ragged tail
        for (int m = m0; m < M; ++m) one_match(acc, f, dn, px, py, pd, pt, pw, m);
      }
    }
  } else if (kMode == kRows) {
    const int m1 = min(M, 4 * g1);
    for (int m = 4 * g0 + tid; m < m1; m += kThreads) {
      const float4 x4 = ld4(px + m * dn.from_s[2]);
      const float4 y4 = ld4(py + m * dn.to_s[2]);
      const float4 d4 = ld4(pd + m * dn.dir_s[2]);
      const float x[3] = {x4.x, x4.y, x4.z}, y[3] = {y4.x, y4.y, y4.z};
      const float d[3] = {d4.x, d4.y, d4.z};
      accumulate(acc, f, x, y, d, pt[m * dn.tag_s[1]], pw[m * dn.w_s[1]]);
    }
  } else {
    const int m1 = min(M, 4 * g1);
    for (int m = 4 * g0 + tid; m < m1; m += kThreads)
      one_match(acc, f, dn, px, py, pd, pt, pw, m);
  }
}

// One halving step of the warp reduction: the lanes whose `bit` is 0 keep
// the lower half of the n live sums and the others the upper half; each adds
// what its partner (lane ^ off) held of that half.  n sums over 2j lanes
// become n/2 sums over j lanes, with n/2 shuffles instead of n.
template <int n>
__device__ __forceinline__ void halve(float (&a)[kAcc], bool bit, int off) {
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float send = bit ? a[i] : a[i + n / 2];
    const float keep = bit ? a[i + n / 2] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// Launched with one cluster of gridDim.x = 2 * splits blocks per lane.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
normal_equations_sym_kernel(const Params p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = blockIdx.x;  // the block's rank in its cluster
  const int splits = gridDim.x / 2;
  const int lane_id = blockIdx.y;
  const int tid = threadIdx.x;

  Frame f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.cm[i] = p.cm[lane_id * 3 + i];
    f.cf[i] = p.cf[lane_id * 3 + i];
    f.c[i] = p.center[lane_id * 3 + i];
  }
  f.rm = p.rm[lane_id];
  f.rf = p.rf[lane_id];

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // two copies of the sweep, so each addresses its direction's parameters
  // statically (indexing the parameter space by a run-time value would move
  // the struct to local memory)
  if (rank < splits)
    sweep<kMode>(acc, f, p.d[0], lane_id, rank, splits, tid);
  else
    sweep<kMode>(acc, f, p.d[1], lane_id, rank - splits, splits, tid);

  // the block's sums, in a fixed order: three halving steps leave each lane
  // with 9 of the 72 sums over 8 lanes, two butterfly steps finish them;
  // then the warps are added in order
  __shared__ float red[kWarps][kAcc];
  __shared__ float part[kAcc];
  __shared__ float total[kAcc];
  const int warp = tid >> 5;
  const int lane = tid & 31;
  halve<72>(acc, lane & 16, 16);
  halve<36>(acc, lane & 8, 8);
  halve<18>(acc, lane & 4, 4);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
  }
  if ((lane & 3) == 0) {
    const int first = (lane & 16 ? 36 : 0) + (lane & 8 ? 18 : 0) + (lane & 4 ? 9 : 0);
#pragma unroll
    for (int i = 0; i < 9; ++i) red[warp][first + i] = acc[i];
  }
  __syncthreads();
  if (tid < kAcc) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += red[wi][tid];
    part[tid] = s;
  }

  // the lane's sums: block 0 adds the cluster's partial sums in rank order
  cluster.sync();
  if (rank == 0) {
    if (tid < kAcc) {
      float s = 0.f;
      for (int r = 0; r < 2 * splits; ++r) s += cluster.map_shared_rank(part, r)[tid];
      total[tid] = s;
    }
    __syncthreads();
    for (int i = tid; i < 156; i += kThreads) {
      if (i < 144) {
        const int n = i / 12, nn = i % 12;
        const int k = n >> 2, l = n & 3, kk = nn >> 2, ll = nn & 3;
        const int pq = k <= kk ? pair3(k, kk) : pair3(kk, k);
        const int ph = l <= ll ? pair4(l, ll) : pair4(ll, l);
        p.ata[(size_t)lane_id * 144 + i] = total[pq * 10 + ph];
      } else {
        p.atb[(size_t)lane_id * 12 + (i - 144)] = total[kPairs + (i - 144)];
      }
    }
  }
  cluster.sync();  // no block leaves while block 0 may still read its sums
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// float4 reads need 16-byte aligned lanes for all five tensors of a
// direction, and either unit match stride with aligned components (four
// matches a read) or unit component stride with aligned rows (one match's
// three components a read)
Mode mode_of(const Direction& d) {
  if (d.M == 0) return kPlanar;  // nothing is read: fits either
  const bool lanes = d.from_s[0] % 4 == 0 && d.to_s[0] % 4 == 0 && d.dir_s[0] % 4 == 0 &&
                     aligned16(d.from) && aligned16(d.to) && aligned16(d.dir);
  if (!lanes) return kScalar;
  if (d.from_s[2] == 1 && d.to_s[2] == 1 && d.dir_s[2] == 1 && d.tag_s[1] == 1 &&
      d.w_s[1] == 1 && d.from_s[1] % 4 == 0 && d.to_s[1] % 4 == 0 && d.dir_s[1] % 4 == 0 &&
      d.tag_s[0] % 4 == 0 && d.w_s[0] % 4 == 0 && aligned16(d.tag) && aligned16(d.w))
    return kPlanar;
  if (d.from_s[1] == 1 && d.to_s[1] == 1 && d.dir_s[1] == 1 && d.from_s[2] % 4 == 0 &&
      d.to_s[2] % 4 == 0 && d.dir_s[2] % 4 == 0)
    return kRows;
  return kScalar;
}

}  // namespace

// ptrs (host array): per direction from, to, dir, tag, w (forward then
// backward), then cm, cf, rm, rf, center, ata, atb.  strides (host array, in
// elements): per direction from (lane, component, match), to, dir, then tag
// (lane, match), w.
extern "C" int lrr_normal_equations_sym(const void* const* ptrs, const long long* strides,
                                        int L, int Mf, int Mb, void* stream) {
  Params p;
  for (int k = 0; k < 2; ++k) {
    Direction& d = p.d[k];
    const void* const* q = ptrs + 5 * k;
    const long long* s = strides + 13 * k;
    d.from = (const float*)q[0];
    d.to = (const float*)q[1];
    d.dir = (const float*)q[2];
    d.tag = (const float*)q[3];
    d.w = (const float*)q[4];
    for (int i = 0; i < 3; ++i) {
      d.from_s[i] = s[i];
      d.to_s[i] = s[3 + i];
      d.dir_s[i] = s[6 + i];
    }
    for (int i = 0; i < 2; ++i) {
      d.tag_s[i] = s[9 + i];
      d.w_s[i] = s[11 + i];
    }
    d.M = k == 0 ? Mf : Mb;
  }
  p.cm = (const float*)ptrs[10];
  p.cf = (const float*)ptrs[11];
  p.rm = (const float*)ptrs[12];
  p.rf = (const float*)ptrs[13];
  p.center = (const float*)ptrs[14];
  p.ata = (float*)ptrs[15];
  p.atb = (float*)ptrs[16];
  // blocks per (lane, direction): 4, 2 or 1, as many as keep the grid within
  // two blocks an SM (measured on an H100 at 64 lanes: 2 beat both 3, in
  // clusters of 6, and 4, whose 512 blocks need a second, nearly empty wave)
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
  }
  int splits = kMaxSplits;
  while (splits > 1 && 2 * splits * L > kGridPerSM * sms) splits /= 2;

  Mode mode = mode_of(p.d[0]);
  const Mode other = mode_of(p.d[1]);
  if (p.d[0].M == 0) mode = other;
  if (p.d[1].M != 0 && other != mode) mode = kScalar;

  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 2 * splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * splits, L);
  config.blockDim = dim3(kThreads);
  config.stream = (cudaStream_t)stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  cudaError_t e;
  if (mode == kPlanar)
    e = cudaLaunchKernelEx(&config, normal_equations_sym_kernel<kPlanar>, p);
  else if (mode == kRows)
    e = cudaLaunchKernelEx(&config, normal_equations_sym_kernel<kRows>, p);
  else
    e = cudaLaunchKernelEx(&config, normal_equations_sym_kernel<kScalar>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
