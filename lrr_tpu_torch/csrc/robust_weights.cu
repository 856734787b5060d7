// K6: the ICP's robust weighting of its matches, both directions of one
// iteration in one launch, and the weighted errors after the solve in
// another.
//
// It computes what lrr_tpu_torch/estimation/icp.py::robust_weights_plain
// (the RMS-scale branch of the symmetric estimate_LS's weighting, symmetric
// .txx:698-728) and icp.py::_weighted_error_packed compute, its plain
// versions.  It replaces no Pallas kernel: lrr_tpu leaves this chain to XLA,
// which fuses it inside its wave program; the port ran it as ~440 eager
// launches an iteration, each reading or writing [L, M] per-match tensors.
//
// Weights (`lrr_robust_weights`), per lane and direction k (0 forward under
// T, 1 backward under T^-1), over the matches m with mask b_m:
//   r2 = e^T P e, e = T(x) - y   (P = c1 I + c2 d d^T from the target's tag)
//   s  = max(sqrt(sum_b r2 / max(n, 1)), SCALE_FLOOR)           (RMS scale)
//   w  = b ? BT(r2 / s^2) / s^2 : 0                          (Beaton-Tukey)
//   g  = min(strength_x strength_y, 90000);  z = b & (w != 0)
//   w  = (z ? w g : w) / max(MAD(g | z), 1e-30)                 (strength)
//   the frame from the forward matches: cm, cf the means of x and y, rm, rf
//   the mean distances to them (at least 1e-6)
//   v  = 1 / (1 + falloff |(y - c) / r|^2), (c, r) = (cf, rf) forward,
//        (cm, rm) backward
//   w  = w v / max(MAD(v | b), 1e-30)                            (spatial)
//   w  = w >= WEIGHT_FLOOR ? w : 0
// with MAD(v | b) = 1.4826 (1 + 5 / max(n - 1, 1)) times the element at
// floor((n - 1) / 2) + 1 (clamped to M - 1) of |v| sorted ascending with
// float max in place of every entry outside b (`_mad_scale_dof`).
// Weighted error (`lrr_weighted_error`), per lane and direction:
// sum sqrt(r2) w' / max(sum w', 1e-30), w' = b ? w : 0, at the new transform.
//
// Arithmetic: every per-match value is the plain version's, step for step,
// with _rn intrinsics (no contraction into an FMA, IEEE division and square
// root), float32 throughout.  The order statistic is exact: a radix select
// over the bit patterns of |v| (non-negative floats order as their bits do;
// float max is 0x7f7fffff), four 8-bit digits from the top, the same element
// a sort would put there, float max included where n is 0 or 1.  Only the
// order of the sums differs from the plain version's: each thread adds its
// matches m = tid, tid + T, ... in turn, then a butterfly inside each warp
// and the warps in order.  That order depends on M alone, never on L: a
// lane gives the same bits in every bucket and every run.  No atomics but
// the select's integer histogram counts.
//
// What bounds it on the card: bytes and latency.  A match is read once,
// three float4 (the source row's x, y, z, strength; the target row's eight
// columns) and a mask byte, and its weight written once; the forward
// direction reads its source row's first float4 a second time for the
// frame's radius.  Everything [L, M]-sized in between stays in shared
// memory.  Design:
//   * one block of 512 threads a (lane, direction), the two blocks of a lane
//     one thread-block cluster: the backward block reads the forward block's
//     frame through distributed shared memory, after both have done their
//     Beaton-Tukey and strength weights;
//   * a block keeps r2 (then the weight), g (then v), the target point and
//     the mask / z flags of each match in shared memory, 21 bytes a match:
//     168 KB at 8,000 matches.  Past what one block's shared memory holds
//     the same arrays live in a global scratch the wrapper allocates;
//   * the select's histogram is 256 counters in shared memory; lanes of a
//     warp that fall in one bin add their count with one atomic
//     (__match_any_sync), then one warp scans the counters.
// Nothing is sorted, allocated or read back on the host.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kScaleFloor = 0.005f;   // icp.SCALE_FLOOR
constexpr float kWeightFloor = 1e-4f;   // icp.WEIGHT_FLOOR
constexpr float kStrengthCap = 90000.0f;
constexpr float kScaleMin = 1e-30f;
constexpr float kRadiusMin = 1e-6f;
constexpr unsigned kBigBits = 0x7f7fffffu;  // torch.finfo(float32).max
constexpr unsigned char kMask = 1, kNonzero = 2;
constexpr int kStaticSmem = 4096;  // a bound on the kernel's static shared memory
constexpr int kSmemLimit = 232448;  // what one block may take on sm_90

// a lane's transform y = A (x - c) + t, read through strides
struct Xform {
  float a[9], t[3], c[3];
};

struct Side {
  const float* src;  // (x, y, z, strength) of match m at src + lane * src_l + m * src_m
  const float* dst;  // (x, y, z, strength, d0, d1, d2, tag) at dst + lane * dst_l + m * dst_m
  const unsigned char* mask;  // mask + lane * mask_l + m
  const float* A;
  const float* t;
  const float* c;
  float* w;  // [L, M] out (weights) or in (weighted error, by w_l, w_m)
  long long src_l, src_m, dst_l, dst_m, mask_l, w_l, w_m;
  long long A_s[3], t_s[2], c_s[2];
  int M;
};

struct Params {
  Side d[2];
  float* cm;       // [L, 3] out: the frame
  float* cf;       // [L, 3]
  float* rm;       // [L]
  float* rf;       // [L]
  float* scales;   // [L, 2, 3] or null: RMS scale, strength MAD, spatial MAD
  float* scratch;  // per-match arrays in global memory, or null: in shared memory
  float* error;    // [2, L] weighted errors
  float falloff;
  int mmax;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);  // torch.clamp(min=): NaN stays NaN
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : (x > hi ? hi : x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ void load_xform(Xform& x, const Side& s, int lane, int tid) {
  if (tid < 9)
    x.a[tid] = s.A[lane * s.A_s[0] + (tid / 3) * s.A_s[1] + (tid % 3) * s.A_s[2]];
  else if (tid < 12)
    x.t[tid - 9] = s.t[lane * s.t_s[0] + (tid - 9) * s.t_s[1]];
  else if (tid < 15)
    x.c[tid - 12] = s.c[lane * s.c_s[0] + (tid - 12) * s.c_s[1]];
}

// e^T P e of one match (icp.py::_residual2_packed, step for step)
__device__ __forceinline__ float residual2(const Xform& x, float4 s, float4 y, float4 d) {
  const float xc[3] = {__fsub_rn(s.x, x.c[0]), __fsub_rn(s.y, x.c[1]), __fsub_rn(s.z, x.c[2])};
  const float yy[3] = {y.x, y.y, y.z};
  float e[3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
    e[r] = __fsub_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x.a[3 * r], xc[0]),
                                      __fmul_rn(x.a[3 * r + 1], xc[1])),
                            __fmul_rn(x.a[3 * r + 2], xc[2])),
                  x.t[r]),
        yy[r]);
  const float sheet = (d.w > 1.5f && d.w < 2.5f) ? 1.f : 0.f;
  const float tube = d.w > 2.5f ? 1.f : 0.f;
  const float c1 = __fsub_rn(1.f, sheet), c2 = __fsub_rn(sheet, tube);
  const float a = __fadd_rn(__fadd_rn(__fmul_rn(e[0], e[0]), __fmul_rn(e[1], e[1])),
                            __fmul_rn(e[2], e[2]));
  const float b = __fadd_rn(__fadd_rn(__fmul_rn(d.x, e[0]), __fmul_rn(d.y, e[1])),
                            __fmul_rn(d.z, e[2]));
  return clamp_min(__fadd_rn(__fmul_rn(c1, a), __fmul_rn(__fmul_rn(c2, b), b)), 0.f);
}

// The block's sums of v[0..N) (every thread's), in a fixed order: a
// butterfly inside each warp, then the warps in order.  Every thread gets
// them back in v.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float (*red)[8], float* out) {
  const int tid = threadIdx.x, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] = __fadd_rn(v[i], __shfl_xor_sync(~0u, v[i], off));
  if ((tid & 31) == 0)
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][i] = v[i];
  __syncthreads();
  if (tid < N) {
    float s = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) s = __fadd_rn(s, red[wi][tid]);
    out[tid] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = out[i];
  __syncthreads();  // out and red may be written again
}

// The bit pattern of the element `kth` (0-based) of the M keys sorted
// ascending: key j is |v[j]| where flags[j] has `bit`, float max elsewhere.
__device__ unsigned select_kth(const float* v, const unsigned char* flags, unsigned char bit,
                               int M, unsigned kth, unsigned* hist, unsigned* sel) {
  const int tid = threadIdx.x;
  unsigned prefix = 0, high = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    // every lane of a warp runs the same iterations: the match below takes
    // the whole warp
    for (int base = tid & ~31; base < M; base += kThreads) {
      const int j = base + (tid & 31);
      bool in = j < M;
      unsigned digit = 256u;
      if (in) {
        const unsigned key =
            (flags[j] & bit) ? (__float_as_uint(v[j]) & 0x7fffffffu) : kBigBits;
        in = (key & high) == prefix;
        if (in) digit = (key >> shift) & 255u;
      }
      const unsigned same = __match_any_sync(~0u, digit);
      if (in && (__ffs(same) - 1) == (tid & 31)) atomicAdd(&hist[digit], __popc(same));
    }
    __syncthreads();
    if (tid < 32) {
      unsigned c[8], s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[8 * tid + i];
        s += c[i];
      }
      unsigned incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(~0u, incl, off);
        if (tid >= off) incl += o;
      }
      unsigned run = incl - s;
      if (run <= kth && kth < incl) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (kth < run + c[i]) {
            sel[0] = 8 * tid + i;
            sel[1] = kth - run;
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= sel[0] << shift;
    high |= 255u << shift;
    kth = sel[1];
    __syncthreads();  // hist and sel are written again
  }
  return prefix;
}

// rrel_util_median_abs_dev_scale with dof = 1 (`_mad_scale_dof`): n of the
// M keys are in, `med` the element the select found
__device__ __forceinline__ unsigned mad_rank(int n, int M) {
  const int loc = n == 0 ? 0 : (n - 1) / 2 + 1;
  return (unsigned)min(loc, M - 1);
}

__device__ __forceinline__ float mad_scale(unsigned med, int n) {
  const float nf = (float)max(n - 1, 1);
  const float f = __fadd_rn(__fmul_rn(__fdiv_rn(1.f, nf), 5.f), 1.f);
  return __fmul_rn(__fmul_rn(f, 1.4826f), __uint_as_float(med));
}

struct Shared {
  float red[kWarps][8];
  float out[8];
  float frame[8];  // cm, cf, rm, rf: the forward block's, read by the backward block
  unsigned hist[256];
  unsigned sel[2];
  Xform x;
};

// the floats of one (lane, direction)'s per-match arrays: r, g, tx, ty, tz
// and the flag bytes
__host__ __device__ __forceinline__ long long lane_floats(int M) {
  return 5LL * M + (M + 3) / 4;
}

template <int K>
__device__ __forceinline__ void weights(const Params& p, Shared& sh, float* arrays, cg::cluster_group& cluster) {
  const Side& s = p.d[K];
  const int M = s.M, lane = blockIdx.y, tid = threadIdx.x;
  float* r = arrays;
  float* g = r + M;
  float* tx = g + M;
  float* ty = tx + M;
  float* tz = ty + M;
  unsigned char* fl = reinterpret_cast<unsigned char*>(tz + M);
  load_xform(sh.x, s, lane, tid);
  __syncthreads();
  const float* src = s.src + lane * s.src_l;
  const float* dst = s.dst + lane * s.dst_l;
  const unsigned char* mask = s.mask + lane * s.mask_l;

  // the rows, once: r2, g, the target point, the mask; the RMS sums and
  // (forward) the frame's
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
  for (int j = tid; j < M; j += kThreads) {
    const float4 a = ld4(src + j * s.src_m);
    const float4 y = ld4(dst + j * s.dst_m);
    const float4 d = ld4(dst + j * s.dst_m + 4);
    const bool b = mask[j] != 0;
    const float r2 = residual2(sh.x, a, y, d);
    r[j] = r2;
    g[j] = clamp_max(__fmul_rn(a.w, y.w), kStrengthCap);
    tx[j] = y.x;
    ty[j] = y.y;
    tz[j] = y.z;
    fl[j] = b ? kMask : 0;
    if (b) {
      acc[0] = __fadd_rn(acc[0], r2);
      acc[1] = __fadd_rn(acc[1], 1.f);
      if (K == 0) {
        acc[2] = __fadd_rn(acc[2], a.x);
        acc[3] = __fadd_rn(acc[3], a.y);
        acc[4] = __fadd_rn(acc[4], a.z);
        acc[5] = __fadd_rn(acc[5], y.x);
        acc[6] = __fadd_rn(acc[6], y.y);
        acc[7] = __fadd_rn(acc[7], y.z);
      }
    }
  }
  float n_b;  // matches in the mask
  float scale;
  if (K == 0) {
    block_sum<8>(acc, sh.red, sh.out);
  } else {
    float two[2] = {acc[0], acc[1]};
    block_sum<2>(two, sh.red, sh.out);
    acc[0] = two[0];
    acc[1] = two[1];
  }
  n_b = acc[1];
  const float n1 = n_b < 1.f ? 1.f : n_b;
  scale = clamp_min(__fsqrt_rn(__fdiv_rn(acc[0], n1)), kScaleFloor);
  const float s2 = __fmul_rn(scale, scale);

  if (K == 0) {  // the frame: means, then the mean distances to them
    const float cm[3] = {__fdiv_rn(acc[2], n1), __fdiv_rn(acc[3], n1), __fdiv_rn(acc[4], n1)};
    const float cf[3] = {__fdiv_rn(acc[5], n1), __fdiv_rn(acc[6], n1), __fdiv_rn(acc[7], n1)};
    float dist[2] = {0.f, 0.f};
    for (int j = tid; j < M; j += kThreads) {
      if (!(fl[j] & kMask)) continue;
      const float4 a = ld4(src + j * s.src_m);
      const float dm[3] = {__fsub_rn(a.x, cm[0]), __fsub_rn(a.y, cm[1]), __fsub_rn(a.z, cm[2])};
      const float df[3] = {__fsub_rn(tx[j], cf[0]), __fsub_rn(ty[j], cf[1]),
                           __fsub_rn(tz[j], cf[2])};
      dist[0] = __fadd_rn(dist[0], __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(dm[0], dm[0]), __fmul_rn(dm[1], dm[1])), __fmul_rn(dm[2], dm[2]))));
      dist[1] = __fadd_rn(dist[1], __fsqrt_rn(__fadd_rn(
          __fadd_rn(__fmul_rn(df[0], df[0]), __fmul_rn(df[1], df[1])), __fmul_rn(df[2], df[2]))));
    }
    block_sum<2>(dist, sh.red, sh.out);
    if (tid < 3) {
      sh.frame[tid] = cm[tid];
      sh.frame[3 + tid] = cf[tid];
    } else if (tid == 3) {
      sh.frame[6] = clamp_min(__fdiv_rn(dist[0], n1), kRadiusMin);
    } else if (tid == 4) {
      sh.frame[7] = clamp_min(__fdiv_rn(dist[1], n1), kRadiusMin);
    }
  }

  // Beaton-Tukey, then the strength weight's numerator and its flags
  float nz[1] = {0.f};
  for (int j = tid; j < M; j += kThreads) {
    const bool b = fl[j] & kMask;
    float w = 0.f;
    if (b) {
      const float u = __fdiv_rn(r[j], s2);
      const float v = __fsub_rn(1.f, __fmul_rn(u, 0.0625f));
      w = __fdiv_rn(u <= 16.f ? __fmul_rn(v, v) : 0.f, s2);
    }
    const bool z = b && w != 0.f;
    r[j] = z ? __fmul_rn(w, g[j]) : w;
    if (z) {
      fl[j] = kMask | kNonzero;
      nz[0] = __fadd_rn(nz[0], 1.f);
    }
  }
  block_sum<1>(nz, sh.red, sh.out);
  const int n_z = (int)nz[0];
  const float mad_g = mad_scale(select_kth(g, fl, kNonzero, M, mad_rank(n_z, M), sh.hist, sh.sel),
                                n_z);
  const float s_g = clamp_min(mad_g, kScaleMin);

  // the frame: the forward block's own, the backward block's through the
  // cluster
  cluster.sync();
  float c[3], rr;
  {
    const float* f = K == 0 ? sh.frame : cluster.map_shared_rank(sh.frame, 0);
    const int o = K == 0 ? 3 : 0;  // forward: (cf, rf); backward: (cm, rm)
    c[0] = f[o];
    c[1] = f[o + 1];
    c[2] = f[o + 2];
    rr = f[K == 0 ? 7 : 6];
  }
  if (K == 0 && tid < 3) {
    p.cm[lane * 3 + tid] = sh.frame[tid];
    p.cf[lane * 3 + tid] = sh.frame[3 + tid];
  } else if (K == 0 && tid == 3) {
    p.rm[lane] = sh.frame[6];
    p.rf[lane] = sh.frame[7];
  }

  // the spatial weight
  const float falloff = p.falloff;
  for (int j = tid; j < M; j += kThreads) {
    const float q0 = __fdiv_rn(__fsub_rn(tx[j], c[0]), rr);
    const float q1 = __fdiv_rn(__fsub_rn(ty[j], c[1]), rr);
    const float q2 = __fdiv_rn(__fsub_rn(tz[j], c[2]), rr);
    const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(q0, q0), __fmul_rn(q1, q1)), __fmul_rn(q2, q2));
    r[j] = __fdiv_rn(r[j], s_g);
    g[j] = __fdiv_rn(1.f, __fadd_rn(__fmul_rn(falloff, d2), 1.f));
  }
  __syncthreads();
  const int n_m = (int)n_b;
  const float mad_v = mad_scale(select_kth(g, fl, kMask, M, mad_rank(n_m, M), sh.hist, sh.sel),
                                n_m);
  const float s_v = clamp_min(mad_v, kScaleMin);

  float* out = s.w + (size_t)lane * M;
  for (int j = tid; j < M; j += kThreads) {
    const float w = __fdiv_rn(__fmul_rn(r[j], g[j]), s_v);
    out[j] = w >= kWeightFloor ? w : 0.f;
  }
  if (p.scales != nullptr && tid == 0) {
    float* sc = p.scales + ((size_t)lane * 2 + K) * 3;
    sc[0] = scale;
    sc[1] = mad_g;
    sc[2] = mad_v;
  }
}

__global__ void __launch_bounds__(kThreads) robust_weights_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int k = blockIdx.x;  // the block's rank in its cluster: the direction
  float* arrays = p.scratch == nullptr
                      ? reinterpret_cast<float*>(dyn)
                      : p.scratch + ((size_t)blockIdx.y * 2 + k) * lane_floats(p.mmax);
  if (k == 0)
    weights<0>(p, sh, arrays, cluster);
  else
    weights<1>(p, sh, arrays, cluster);
  cluster.sync();  // the forward block's frame stays until the backward block has read it
}

template <int K>
__device__ __forceinline__ void weighted_error(const Params& p, Shared& sh) {
  const Side& s = p.d[K];
  const int lane = blockIdx.y, tid = threadIdx.x;
  load_xform(sh.x, s, lane, tid);
  __syncthreads();
  const float* src = s.src + lane * s.src_l;
  const float* dst = s.dst + lane * s.dst_l;
  const unsigned char* mask = s.mask + lane * s.mask_l;
  const float* w = s.w + lane * s.w_l;
  float acc[2] = {0.f, 0.f};
#pragma unroll 2
  for (int j = tid; j < s.M; j += kThreads) {
    const float wj = mask[j] != 0 ? w[j * s.w_m] : 0.f;
    const float r2 = residual2(sh.x, ld4(src + j * s.src_m), ld4(dst + j * s.dst_m),
                               ld4(dst + j * s.dst_m + 4));
    acc[0] = __fadd_rn(acc[0], __fmul_rn(__fsqrt_rn(r2), wj));
    acc[1] = __fadd_rn(acc[1], wj);
  }
  block_sum<2>(acc, sh.red, sh.out);
  if (tid == 0)
    p.error[(size_t)K * gridDim.y + lane] = __fdiv_rn(acc[0], clamp_min(acc[1], kScaleMin));
}

__global__ void __launch_bounds__(kThreads) weighted_error_kernel(const Params p) {
  __shared__ Shared sh;
  if (blockIdx.x == 0)
    weighted_error<0>(p, sh);
  else
    weighted_error<1>(p, sh);
}

void read_sides(Params& p, const void* const* ptrs, const long long* strides, int Mf, int Mb) {
  for (int k = 0; k < 2; ++k) {
    Side& d = p.d[k];
    const void* const* q = ptrs + 7 * k;
    const long long* s = strides + 14 * k;
    d.src = (const float*)q[0];
    d.dst = (const float*)q[1];
    d.mask = (const unsigned char*)q[2];
    d.A = (const float*)q[3];
    d.t = (const float*)q[4];
    d.c = (const float*)q[5];
    d.w = (float*)q[6];
    d.src_l = s[0];
    d.src_m = s[1];
    d.dst_l = s[2];
    d.dst_m = s[3];
    d.mask_l = s[4];
    d.w_l = s[5];
    d.w_m = s[6];
    for (int i = 0; i < 3; ++i) d.A_s[i] = s[7 + i];
    for (int i = 0; i < 2; ++i) {
      d.t_s[i] = s[10 + i];
      d.c_s[i] = s[12 + i];
    }
    d.M = k == 0 ? Mf : Mb;
  }
}

long long dynamic_bytes(int mmax) { return 4 * lane_floats(mmax); }

}  // namespace

// Floats of global scratch `lrr_robust_weights` needs for L lanes at these
// match counts: 0 where a lane's per-match arrays fit one block's shared
// memory.
extern "C" long long lrr_robust_scratch_floats(int L, int Mf, int Mb) {
  const int mmax = Mf > Mb ? Mf : Mb;
  if (dynamic_bytes(mmax) + kStaticSmem <= kSmemLimit) return 0;
  return 2LL * L * lane_floats(mmax);
}

// ptrs (host array): per direction (forward, then backward) src, dst, mask,
// A, t, center, w (out), then cm [L, 3], cf [L, 3], rm [L], rf [L] (out),
// scales [L, 2, 3] (out, or null), scratch (`lrr_robust_scratch_floats`
// floats, or null where that is 0).  strides (host array, elements): per direction src (lane, match), dst
// (lane, match), mask lane, w (lane, match; unused), A (lane, row, column),
// t (lane, component), center (lane, component).  src and dst 16-byte
// aligned with lane and match strides multiples of 4; masks contiguous along
// the matches; w [L, M] contiguous.  Mf, Mb >= 1.  Launches on `stream`,
// never synchronises.
extern "C" int lrr_robust_weights(const void* const* ptrs, const long long* strides, int L,
                                  int Mf, int Mb, float falloff, void* stream) {
  if (L < 0 || L > 65535 || Mf < 1 || Mb < 1) return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaSuccess;
  Params p = {};
  read_sides(p, ptrs, strides, Mf, Mb);
  p.cm = (float*)ptrs[14];
  p.cf = (float*)ptrs[15];
  p.rm = (float*)ptrs[16];
  p.rf = (float*)ptrs[17];
  p.scales = (float*)ptrs[18];
  p.scratch = (float*)ptrs[19];
  p.falloff = falloff;
  p.mmax = Mf > Mb ? Mf : Mb;
  const bool shared = lrr_robust_scratch_floats(L, Mf, Mb) == 0;
  if (!shared && p.scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (shared) p.scratch = nullptr;
  // the shared-memory allowance, once a device (the first call, a graph's
  // warm-up, runs before any capture)
  static bool attribute_set[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64) return (int)cudaErrorInvalidDevice;
  if (!attribute_set[device]) {
    e = cudaFuncSetAttribute(robust_weights_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit - kStaticSmem);
    if (e != cudaSuccess) return (int)e;
    attribute_set[device] = true;
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 2;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2, L);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = shared ? (size_t)dynamic_bytes(p.mmax) : 0;
  config.stream = (cudaStream_t)stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, robust_weights_kernel, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// ptrs (host array): per direction src, dst, mask, A, t, center, w (in),
// then error [2, L] (out).  strides as `lrr_robust_weights`'s, w read
// through its (lane, match) strides.  Launches on `stream`, never
// synchronises.
extern "C" int lrr_weighted_error(const void* const* ptrs, const long long* strides, int L,
                                  int Mf, int Mb, void* stream) {
  if (L < 0 || L > 65535 || Mf < 1 || Mb < 1) return (int)cudaErrorInvalidValue;
  if (L == 0) return (int)cudaSuccess;
  Params p = {};
  read_sides(p, ptrs, strides, Mf, Mb);
  p.error = (float*)ptrs[14];
  weighted_error_kernel<<<dim3(2, L), kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
