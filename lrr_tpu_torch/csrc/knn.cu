// K2: exact k-nearest neighbours by squared L2, k <= 128.
//
// Replaces the TPU kernel lrr_tpu/ops/pallas_kernels.py::knn_pallas
// (_knn_kernel).  Contract: masked points never match; ties go to the lower
// point index; indices paired with +inf distances are unspecified (here -1).
//
// Distance form: sum_c (q_c - p_c)^2, computed directly, in component order,
// each difference, product and sum rounded to fp32 (no FMA contraction),
// which is exactly what the plain PyTorch version computes: the two agree
// bit for bit, so near-ties cannot order differently.  The TPU kernel used
// |q|^2 + |p|^2 - 2 q.p on the MXU, which cancels when the distance is small
// next to the norms; the direct form has no cancellation, and no tensor
// cores or TF32 are involved.
//
// What bounds it on the card: operations.  Q*N*D (subtract, multiply, add)
// triples: 128 x 128 x 195 is 9.6 MFLOP (0.14 us at 67 TFLOP/s fp32; its
// 200 KB of input is 0.06 us), 4096 x 4096 x 195 is 9.8 GFLOP (0.15 ms; its
// 6.4 MB of input is 2 us).  The 67 TFLOP/s count a fused multiply-add as
// two operations; this arithmetic may not fuse, so three issue slots carry
// three operations and half of that bound is the most the kernel can reach.
// At the small shape the launch is the practical floor.
// What the design does about it:
//   * register micro-tiles: a thread owns kMQ queries x kMP points and walks
//     the D components in order, so each value read from shared memory is
//     used kMP (or kMQ) times and the inner loop is bound by the fp32 pipe,
//     not by shared-memory reads (wide tiles: two 16-byte reads per 48
//     arithmetic operations);
//   * tiles are staged through a transposed [D, tile] shared-memory layout:
//     a row of 195 floats is not 16-byte aligned, so global reads are
//     coalesced 4-byte loads over the tile's contiguous span of rows, and the
//     16-byte reads happen where they are repeated, in shared memory (the
//     threads of a micro-tile column read consecutive points of one
//     component);
//   * the points are split over blocks as well as the queries (gridDim.y
//     splits of whole tiles), sized by the wrapper to fill the SMs; each
//     block keeps the top-k of its split, and a second small kernel merges
//     the splits in point order (lower split first), so ties stay with the
//     lower index.  With one split the blocks write the result directly;
//   * two tile shapes, chosen by the wrapper: wide (64 x 64, 4 x 4
//     micro-tiles, 256 threads) for all but the smallest problems, narrow
//     (16 x 16, 1 x 2, 128 threads) below that, so a 128 x 128 problem still
//     gives 64 blocks;
//   * k = 1 is a plain arg-min: each thread keeps the best (distance, index)
//     of its own points (strict <, points in rising order), then the threads
//     of a query combine by warp shuffles with the index as tie-break;
//   * k > 1 keeps each query's sorted top-k in shared memory; after a tile a
//     warp takes a query's list into registers (32 * R entries over the
//     lanes, R = ceil(k / 32)) and inserts the tile's candidates that beat
//     the current k-th distance one at a time in index order with ballots
//     and lane shuffles, which keeps ties stable.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Insert the warp's candidates (one per lane, in rising index order over
// the lanes) into a sorted top-k held as 32 * R entries over the lanes.
template <int R>
__device__ __forceinline__ void warp_insert(float (&vd)[R], int (&vi)[R], float d,
                                            int idx, int k, int lane) {
  const int kr = (k - 1) >> 5;  // register slot of the k-th entry
  const int kl = (k - 1) & 31;  // and its lane
  float kth = CUDART_INF_F;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r == kr) kth = vd[r];
  kth = __shfl_sync(kFull, kth, kl);
  unsigned want = __ballot_sync(kFull, d < kth);
  while (want) {
    const int c = __ffs(want) - 1;
    want &= want - 1;
    const float dc = __shfl_sync(kFull, d, c);
    const int ic = __shfl_sync(kFull, idx, c);
    float cur = CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r == kr) cur = vd[r];
    cur = __shfl_sync(kFull, cur, kl);
    if (!(dc < cur)) continue;  // warp-uniform
    // insertion point: entries <= dc stay ahead (lower index wins ties)
    int pos = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) pos += __popc(__ballot_sync(kFull, vd[r] <= dc));
#pragma unroll
    for (int r = R - 1; r >= 0; --r) {
      float up_d = __shfl_up_sync(kFull, vd[r], 1);
      int up_i = __shfl_up_sync(kFull, vi[r], 1);
      float carry_d = CUDART_INF_F;
      int carry_i = -1;
      if (r > 0) {
        carry_d = __shfl_sync(kFull, vd[r > 0 ? r - 1 : 0], 31);
        carry_i = __shfl_sync(kFull, vi[r > 0 ? r - 1 : 0], 31);
      }
      if (lane == 0) {
        up_d = carry_d;
        up_i = carry_i;
      }
      const int j = r * 32 + lane;
      if (j > pos) {
        vd[r] = up_d;
        vi[r] = up_i;
      } else if (j == pos) {
        vd[r] = dc;
        vi[r] = ic;
      }
      if (j >= k) {
        vd[r] = CUDART_INF_F;
        vi[r] = -1;
      }
    }
  }
}

// (distance, index) order with the lower index winning ties; an index of -1
// only ever comes with +inf and loses to any real entry of equal distance
__device__ __forceinline__ bool better(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i >= 0 && (bi < 0 || i < bi));
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

// rows [row0, row0 + kTile) of g [rows, D] into s[c * kPad + r], zeros
// beyond the last row; the span of rows is contiguous in g, so consecutive
// threads read consecutive addresses
template <int kTile, int kPad, int kThreads>
__device__ __forceinline__ void stage(float* s, const float* __restrict__ g, int row0,
                                      int rows, int D, int tid) {
  const size_t base = (size_t)row0 * D;
  const int live = min(kTile, rows - row0) * D;
  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    s[c * kPad + r] = i < live ? g[base + i] : 0.f;
  }
}

// One block: queries [q0, q0 + kTQ) against the point tiles of its split.
// Writes the split's top-k to part_d/part_i [Q, splits, k].
// kR = 0 is the k = 1 arg-min; kR >= 1 keeps 32 * kR sorted entries.
template <int kTQ, int kTP, int kMQ, int kMP, int kR>
__global__ void __launch_bounds__((kTQ / kMQ) * (kTP / kMP))
knn_kernel(const float* __restrict__ queries,        // [Q, D]
           const float* __restrict__ points,         // [N, D]
           const unsigned char* __restrict__ mask,   // [N]
           float* __restrict__ part_d,               // [Q, splits, k]
           int* __restrict__ part_i,                 // [Q, splits, k]
           int Q, int N, int D, int k, int tiles_per_split) {
  constexpr int kPG = kTP / kMP;  // threads along the points
  constexpr int kQG = kTQ / kMQ;  // threads along the queries
  constexpr int kThreads = kPG * kQG;
  constexpr int kQPad = kTQ + 4, kPPad = kTP + 4;  // keeps 16-byte alignment
  constexpr int kSlots = 32 * (kR > 0 ? kR : 1);
  static_assert(kPG <= 32 && (kPG & (kPG - 1)) == 0, "a query's threads share a warp");

  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                        // [D][kQPad]
  float* sp = sq + (size_t)D * kQPad;      // [D][kPPad]
  float* sdist = sp + (size_t)D * kPPad;   // [kTQ][kTP]      (k > 1)
  float* std_ = sdist + kTQ * kTP;         // [kTQ][kSlots]   (k > 1)
  int* sti = reinterpret_cast<int*>(std_ + kTQ * kSlots);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pg = tid % kPG, qg = tid / kPG;
  const int q0 = blockIdx.x * kTQ;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tiles = (N + kTP - 1) / kTP;
  const int t0 = split * tiles_per_split;
  const int t1 = min(tiles, t0 + tiles_per_split);

  stage<kTQ, kQPad, kThreads>(sq, queries, q0, Q, D, tid);
  if (kR > 0)
    for (int i = tid; i < kTQ * kSlots; i += kThreads) {
      std_[i] = CUDART_INF_F;
      sti[i] = -1;
    }

  float best_d[kMQ];
  int best_i[kMQ];
#pragma unroll
  for (int a = 0; a < kMQ; ++a) {
    best_d[a] = CUDART_INF_F;
    best_i[a] = -1;
  }

  for (int t = t0; t < t1; ++t) {
    const int p0 = t * kTP;
    __syncthreads();  // the previous tile is consumed
    stage<kTP, kPPad, kThreads>(sp, points, p0, N, D, tid);
    __syncthreads();

    float acc[kMQ][kMP];
#pragma unroll
    for (int a = 0; a < kMQ; ++a)
#pragma unroll
      for (int b = 0; b < kMP; ++b) acc[a][b] = 0.f;
    const float* aq = sq + qg * kMQ;
    const float* ap = sp + pg * kMP;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[kMQ], pv[kMP];
      load_vec<kMQ>(aq + c * kQPad, qv);
      load_vec<kMP>(ap + c * kPPad, pv);
#pragma unroll
      for (int a = 0; a < kMQ; ++a)
#pragma unroll
        for (int b = 0; b < kMP; ++b) {
          const float df = __fsub_rn(qv[a], pv[b]);
          acc[a][b] = __fadd_rn(acc[a][b], __fmul_rn(df, df));  // the plain version's bits
        }
    }

    if constexpr (kR == 0) {
#pragma unroll
      for (int b = 0; b < kMP; ++b) {
        const int p = p0 + pg * kMP + b;
        const bool live = p < N && mask[p];
#pragma unroll
        for (int a = 0; a < kMQ; ++a)
          if (live && acc[a][b] < best_d[a]) {  // strict: the first minimum stays
            best_d[a] = acc[a][b];
            best_i[a] = p;
          }
      }
    } else {
#pragma unroll
      for (int a = 0; a < kMQ; ++a)
#pragma unroll
        for (int b = 0; b < kMP; ++b)
          sdist[(qg * kMQ + a) * kTP + pg * kMP + b] = acc[a][b];
      __syncthreads();
      for (int qq = tid >> 5; qq < kTQ; qq += kThreads / 32) {
        float vd[kR];
        int vi[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          vd[r] = std_[qq * kSlots + r * 32 + lane];
          vi[r] = sti[qq * kSlots + r * 32 + lane];
        }
        for (int j = 0; j < kTP; j += 32) {
          const int pl = j + lane, p = p0 + pl;
          const bool live = pl < kTP && p < N && mask[p];
          warp_insert<kR>(vd, vi, live ? sdist[qq * kTP + pl] : CUDART_INF_F, p, k, lane);
        }
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          std_[qq * kSlots + r * 32 + lane] = vd[r];
          sti[qq * kSlots + r * 32 + lane] = vi[r];
        }
      }
    }
  }

  if constexpr (kR == 0) {
    // the threads of a query sit in one warp, kPG lanes side by side
#pragma unroll
    for (int a = 0; a < kMQ; ++a) {
#pragma unroll
      for (int off = kPG / 2; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, best_d[a], off);
        const int oi = __shfl_xor_sync(kFull, best_i[a], off);
        if (better(od, oi, best_d[a], best_i[a])) {
          best_d[a] = od;
          best_i[a] = oi;
        }
      }
      const int q = q0 + qg * kMQ + a;
      if (pg == 0 && q < Q) {
        part_d[(size_t)q * splits + split] = best_d[a];
        part_i[(size_t)q * splits + split] = best_i[a];
      }
    }
  } else {
    __syncthreads();
    for (int i = tid; i < kTQ * k; i += kThreads) {
      const int qq = i / k, j = i - qq * k;
      const int q = q0 + qq;
      if (q < Q) {
        part_d[((size_t)q * splits + split) * k + j] = std_[qq * kSlots + j];
        part_i[((size_t)q * splits + split) * k + j] = sti[qq * kSlots + j];
      }
    }
  }
}

// Merge the splits' lists [Q, splits, k] in split order into [Q, k]: one warp
// per query.  A later split holds higher indices, and the insertion keeps an
// equal distance behind what is already there, so ties stay stable.
template <int R>
__global__ void __launch_bounds__(128)
knn_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                 float* __restrict__ out_d, int* __restrict__ out_i, int Q, int splits,
                 int k) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // whole warps leave together
  float vd[R];
  int vi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    vd[r] = CUDART_INF_F;
    vi[r] = -1;
  }
  const size_t base = (size_t)q * splits * k;
  const int total = splits * k;  // split-major: already in merge order
  for (int j = 0; j < total; j += 32) {
    const int e = j + lane;
    const float d = e < total ? part_d[base + e] : CUDART_INF_F;
    const int i = e < total ? part_i[base + e] : -1;
    warp_insert<R>(vd, vi, d, i, k, lane);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = r * 32 + lane;
    if (j < k) {
      out_d[(size_t)q * k + j] = vd[r];
      out_i[(size_t)q * k + j] = vi[r];
    }
  }
}

template <int kTQ, int kTP, int kMQ, int kMP, int kR>
int launch_tiles(const float* q, const float* p, const unsigned char* mask, float* pd,
                 int* pi, int Q, int N, int D, int k, int splits, cudaStream_t stream) {
  constexpr int kThreads = (kTQ / kMQ) * (kTP / kMP);
  constexpr int kSlots = 32 * (kR > 0 ? kR : 1);
  size_t smem = (size_t)D * (kTQ + 4 + kTP + 4) * sizeof(float);
  if (kR > 0) smem += (size_t)kTQ * kTP * sizeof(float) + (size_t)kTQ * kSlots * 8;
  auto kernel = knn_kernel<kTQ, kTP, kMQ, kMP, kR>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (N + kTP - 1) / kTP;
  const int tiles_per_split = (tiles + splits - 1) / splits;
  const dim3 grid((Q + kTQ - 1) / kTQ, splits);
  kernel<<<grid, kThreads, smem, stream>>>(q, p, mask, pd, pi, Q, N, D, k, tiles_per_split);
  return (int)cudaGetLastError();
}

template <int kR>
int launch(const float* q, const float* p, const unsigned char* mask, float* out_d,
           int* out_i, float* part_d, int* part_i, int Q, int N, int D, int k, int wide,
           int splits, cudaStream_t stream) {
  float* pd = splits > 1 ? part_d : out_d;
  int* pi = splits > 1 ? part_i : out_i;
  const int err =
      wide ? launch_tiles<64, 64, 4, 4, kR>(q, p, mask, pd, pi, Q, N, D, k, splits, stream)
           : launch_tiles<16, 16, 1, 2, kR>(q, p, mask, pd, pi, Q, N, D, k, splits, stream);
  if (err != 0 || splits == 1) return err;
  knn_merge_kernel<(kR > 0 ? kR : 1)><<<(Q + 3) / 4, 128, 0, stream>>>(
      part_d, part_i, out_d, out_i, Q, splits, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block of the tile kernel takes, for the wrapper's checks
// and its choice of the number of splits.
extern "C" int lrr_knn_smem_bytes(int D, int k, int wide) {
  const int tq = wide ? 64 : 16, tp = wide ? 64 : 16;
  size_t smem = (size_t)D * (tq + 4 + tp + 4) * sizeof(float);
  if (k > 1) smem += (size_t)tq * tp * sizeof(float) + (size_t)tq * 32 * ((k + 31) / 32) * 8;
  return (int)smem;
}

// `splits` blocks share a query tile's points; with splits > 1 the scratch
// part_d / part_i [Q, splits, k] must be given.  `splits` must not exceed the
// number of point tiles (64 points wide, 16 narrow).
extern "C" int lrr_knn(const float* queries, const float* points,
                       const unsigned char* mask, float* out_d, int* out_i,
                       float* part_d, int* part_i, int Q, int N, int D, int k,
                       int wide, int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LRR_KNN_LAUNCH(R) \
  return launch<R>(queries, points, mask, out_d, out_i, part_d, part_i, Q, N, D, k, wide, splits, s)
  if (k == 1) LRR_KNN_LAUNCH(0);
  if (k <= 32) LRR_KNN_LAUNCH(1);
  if (k <= 64) LRR_KNN_LAUNCH(2);
  if (k <= 96) LRR_KNN_LAUNCH(3);
  LRR_KNN_LAUNCH(4);
#undef LRR_KNN_LAUNCH
}
