// K3: the pseudo-inverse of a batch of small symmetric matrices, without a
// host round trip, so that the ICP's solve can run inside a captured CUDA
// graph.
//
// It computes jnp.linalg.pinv(a, hermitian=True) (the port's plain version:
// lrr_tpu_torch/models/affine.py::pinv_hermitian) for [L, n, n] float32
// matrices with n <= 12: the ICP's 12 x 12 affine system
// (lrr_tpu_torch/estimation/icp.py::_estimate_ls_packed and
// backward_covariance) and its 6 x 6 rigid one.  It has no Pallas
// counterpart: lrr_tpu leaves this solve to XLA's own eigensolver inside the
// wave's program.  torch.linalg.pinv(hermitian=True) on the card goes
// through a library eigensolver whose status PyTorch reads back on the host,
// which a graph cannot capture.
//
// Per matrix, one warp:
//   * the lower triangle is read and mirrored (eigh's UPLO='L'), widened to
//     float64 in shared memory; a matrix with a non-finite entry anywhere
//     gives all-NaN, as the plain version does;
//   * cyclic Jacobi (pairs (p, q) row by row) in float64 until a sweep
//     rotates nothing or MAX_SWEEPS sweeps ran; a pair is rotated when
//     |a_pq| > 1e-17 * ||A||_F (below that it moves no eigenvalue by more
//     than float64 rounding of the largest).  Each lane applies the rotation
//     to its own row j of A (a_jp, a_jq and their mirrors) and of V;
//     lane 0 writes the 2 x 2 block;
//   * eigenvalues |lambda_k| <= rtol * max |lambda| are cut, rtol = 10 n
//     eps_f32 (the plain version's rule), and the output
//     V diag(1/lambda) V^T is summed in float64 in k order and rounded once
//     to float32.  v_ik v_jk is the same product for (i, j) and (j, i), so
//     the output is exactly symmetric.
// Every decision is warp-uniform and every sum in a fixed order: two runs,
// eager or replayed from a graph, give identical bits.
//
// What bounds it on the card: neither bytes (2 x 576 B a 12 x 12 matrix)
// nor float64 operations (~170 a rotation, a few hundred rotations a
// matrix), but the dependent chain of rotations, each a float64 division
// and two square roots deep.  One warp a matrix keeps L <= 64 matrices on
// 16 blocks; the design spends nothing on throughput it cannot use.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NMAX = 12;
constexpr int WARPS = 4;  // matrices a block
constexpr int MAX_SWEEPS = 30;
constexpr double OFF_TOL = 1e-17;

__global__ void __launch_bounds__(WARPS * 32)
pinv_sym_kernel(const float* __restrict__ a, float* __restrict__ out,
                int* __restrict__ rotations, int L, int n, double rtol) {
  __shared__ double As[WARPS][NMAX][NMAX + 1];
  __shared__ double Vs[WARPS][NMAX][NMAX + 1];
  __shared__ double Inv[WARPS][NMAX];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int mat = blockIdx.x * WARPS + warp;
  if (mat >= L) return;  // the whole warp leaves together
  double(*A)[NMAX + 1] = As[warp];
  double(*V)[NMAX + 1] = Vs[warp];
  double* inv = Inv[warp];
  const int nn = n * n;
  const float* src = a + (size_t)mat * nn;
  float* dst = out + (size_t)mat * nn;

  bool finite = true;
  double sumsq = 0.0;
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    finite = finite && isfinite(src[e]);
    const double v = (double)src[i >= j ? e : j * n + i];
    A[i][j] = v;
    V[i][j] = i == j ? 1.0 : 0.0;
    sumsq += v * v;
  }
  if (!__all_sync(0xffffffffu, finite)) {
    for (int e = lane; e < nn; e += 32) dst[e] = __int_as_float(0x7fc00000);  // quiet NaN
    if (rotations != nullptr && lane == 0) rotations[mat] = 0;
    return;
  }
  for (int o = 16; o > 0; o >>= 1) sumsq += __shfl_xor_sync(0xffffffffu, sumsq, o);
  const double thresh = OFF_TOL * sqrt(sumsq);
  __syncwarp();

  int count = 0;
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) {
        const double apq = A[p][q];
        if (!(fabs(apq) > thresh)) continue;  // uniform: every lane reads the same
        const double app = A[p][p], aqq = A[q][q];
        const double theta = (aqq - app) / (2.0 * apq);
        double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
        if (theta < 0.0) t = -t;
        const double c = 1.0 / sqrt(t * t + 1.0);
        const double s = t * c;
        __syncwarp();  // every lane has read the 2 x 2 block
        if (lane < n) {
          if (lane != p && lane != q) {
            const double g = A[lane][p], h = A[lane][q];
            const double gp = c * g - s * h, hq = s * g + c * h;
            A[lane][p] = gp;
            A[p][lane] = gp;
            A[lane][q] = hq;
            A[q][lane] = hq;
          }
          const double g = V[lane][p], h = V[lane][q];
          V[lane][p] = c * g - s * h;
          V[lane][q] = s * g + c * h;
        }
        if (lane == 0) {
          A[p][p] = app - t * apq;
          A[q][q] = aqq + t * apq;
          A[p][q] = 0.0;
          A[q][p] = 0.0;
        }
        __syncwarp();
        rotated = true;
        ++count;
      }
    }
    if (!rotated) break;
  }

  double big = 0.0;
  for (int k = 0; k < n; ++k) big = fmax(big, fabs(A[k][k]));
  const double cut = rtol * big;
  if (lane < n) {
    const double d = A[lane][lane];
    inv[lane] = fabs(d) > cut ? 1.0 / d : 0.0;
  }
  __syncwarp();
  for (int e = lane; e < nn; e += 32) {
    const int i = e / n, j = e % n;
    double acc = 0.0;
    for (int k = 0; k < n; ++k) acc += (V[i][k] * V[j][k]) * inv[k];
    dst[e] = (float)acc;
  }
  if (rotations != nullptr && lane == 0) rotations[mat] = count;
}

}  // namespace

// a [L, n, n] and out [L, n, n] contiguous float32 on the device, rotations
// [L] int32 or null; 1 <= n <= 12.  Launches on `stream`, never synchronises.
extern "C" int lrr_pinv_sym(const void* a, void* out, void* rotations, int L, int n,
                            double rtol, void* stream) {
  if (n < 1 || n > NMAX || L < 0) return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  const int blocks = (L + WARPS - 1) / WARPS;
  pinv_sym_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)a, (float*)out, (int*)rotations, L, n, rtol);
  return (int)cudaGetLastError();
}
