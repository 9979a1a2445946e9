// The pose solve's fixed-iteration Levenberg-Marquardt loop (K4).
//
// Replaces no Pallas kernel: in the JAX package the LM loop
// (icm_slam_tpu/solver/gauss_newton.py, `lm_minimize`, vmapped over the
// problems of a sweep) and the default model's residuals and analytic
// Jacobians (icm_slam_tpu/core/energy.py, `one_sided_residuals`,
// `two_sided_residuals` and their Jacobians) are fused by XLA into the
// surrounding scan: one device loop.  In torch eager the same loop is
// ~1,300 small kernels a call one-sided and ~2,000 two-sided.
//
// Contract (ops/pose_lm.py, `pose_lm_plain`): for each of P problems, from
// x0, `iters` LM steps on the default cost, whose m rows are
//   one-sided  [r_kin (3), r_obs (x, y per beam), r_odo (3)]       m = 6 + 2B
//   two-sided  [r_kinf (3), r_odof (3), one-sided]                 m = 12 + 2B
// (the 6 forward rows zeroed where fold[p], the folded last frame; a
// masked beam's rows are the plain version's zeros), with Marquardt damping
// diag(max(diag H, 1e-12)), A = H + lam*damp + 1e-12*I, the cofactor 3x3
// solve, a strict f_new < fx to accept, lam times lam_down on accept and
// lam_up on reject.  The linearisation at the accepted point is the one
// evaluated there (JAX carries that point's residual; here its sums ride
// along).  wrap_angle is torch.remainder's (fmodf, then the divisor's sign).
//
// Bitwise the plain version on the card.  Every row is computed with the
// plain version's float operations in its order (IEEE sinf/cosf, no fast
// math, --fmad=false as every kernel here), and f = sum r^2, g = J^T r and
// the 6 of H = J^T J are summed over the rows in the order in which torch's
// CUDA reduction (ATen/native/cuda/Reduce.cuh) sums the plain version's
// (P, m), (P, m, 3) and (P, m, 3, 3) products over dim 1.  That order is a
// function of (P, m) that the host computes (ops/pose_lm.py::reduce_plan):
// V "virtual threads", each adding every V-th row into four interleaved
// accumulators (or, for f when m >= 128, four-float vector loads from a
// 16-byte-aligned row, with its unaligned head and tail), combined
// ((a0 + a1) + a2) + a3, then a halving tree over the V partials.
//
// What bounds it on the H100: latency.  A call is P independent problems
// of (iters + 1) dependent passes, each a few hundred flops a row; the
// bytes (the problems' fields, read once) and the flops are microseconds
// of the card at the main path's P = 916, B = 48.  The design: a block of
// one warp a problem; the lanes compute the m rows (r, J) of a pass into
// shared memory, a beam a lane, lane 0 the 6 or 12 frame rows; then the
// lanes take the sums' partials (one chain each) and the tree levels in
// turn, and every lane reads the same totals, solves the 3x3 and takes the
// accept test itself.  g and H are summed only at an accepted point.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// float32 of Python's 2*pi, pi and pi/2, as the port's torch code rounds
// them against a float32 tensor
constexpr float kTwoPi = 6.28318548202514648f;
constexpr float kPi = 3.14159274101257324f;
constexpr float kHalfPi = 1.57079637050628662f;
constexpr float kTiny = 1e-12f;

// The fields of a call, in this order (ops/pose_lm.py::_FIELDS); each
// field's rows lie `stride[f]` elements apart (0: one row for every
// problem, as a shared beam-angle row), a row's own elements contiguous.
enum Field {
  kDist,      // (P, B)
  kAng,       // (P, B)
  kMask,      // (P, B) torch bool
  kMatched,   // (P, B, 2)
  kXPrev,     // (P, 3)
  kUPrev,     // (P, 2)
  kOdoPrev,   // (P, 3)
  kOdoCur,    // (P, 3)
  kXNext,     // (P, 3), two-sided only
  kUCur,      // (P, 2), two-sided only
  kOdoNext,   // (P, 3), two-sided only
  kX0,        // (P, 3)
  kFold,      // (P,) torch bool, or null
  kFields
};

struct Problems {
  const void* field[kFields];
  long long stride[kFields];
  const float* sqrt_r;      // (3,)
  const float* sqrt_q;      // (2,)
  const float* sqrt_odom;   // ()
  float* x_out;             // (P, 3), contiguous
  int P, B, two_sided, iters;
  float deltat, lam0, lam_down, lam_up;
  // torch's sum order (see the top): f by vector loads (f_vec) or chains
  // over f_v virtual threads; g over g_v, H over h_v (chains)
  int f_vec, f_v, g_v, h_v;

  // problem p's row of field f
  template <typename T>
  __device__ const T* row(int f, int p) const {
    return static_cast<const T*>(field[f]) + p * stride[f];
  }
};

// core/geometry.py::wrap_angle: torch.remainder(a, 2 pi) takes the sign
// of the divisor, then (pi, 2 pi) moves down by 2 pi
__device__ __forceinline__ float wrap_angle(float a) {
  float m = fmodf(a, kTwoPi);
  if (m < 0.f) m += kTwoPi;
  return m > kPi ? m - kTwoPi : m;
}

// What a problem's rows other than the beams read, computed once: the
// weights, the kinematic prediction from x_prev and the odometry
// increments, each as core/energy.py rounds it.
struct Frame {
  float sr0, sr1, sr2, sq0, sq1, so, dt;
  float xp0, xp1, xp2;              // x_prev
  float kp0, kp1, kp2;              // g(x_prev, u_prev)
  float ca, sa;                     // cos, sin of x_prev's heading
  float om0, om1, omth;             // rot(odo_prev) (odo_cur - odo_prev)
  bool fold;                        // the 6 forward rows are zero
  float xn0, xn1, xn2, v, w;        // x_next, u_cur
  float fm0, fm1, fmth;             // rot(odo_cur) (odo_next - odo_cur)
};

__device__ Frame load_frame(const Problems& a, int p) {
  Frame fr;
  fr.sr0 = a.sqrt_r[0];
  fr.sr1 = a.sqrt_r[1];
  fr.sr2 = a.sqrt_r[2];
  fr.sq0 = a.sqrt_q[0];
  fr.sq1 = a.sqrt_q[1];
  fr.so = a.sqrt_odom[0];
  fr.dt = a.deltat;
  const float* xp = a.row<float>(kXPrev, p);
  const float* up = a.row<float>(kUPrev, p);
  fr.xp0 = xp[0];
  fr.xp1 = xp[1];
  fr.xp2 = xp[2];
  // geometry.py::unicycle_step: x + dt * [v cos th, v sin th, w]
  fr.kp0 = fr.xp0 + fr.dt * (up[0] * cosf(fr.xp2));
  fr.kp1 = fr.xp1 + fr.dt * (up[0] * sinf(fr.xp2));
  fr.kp2 = fr.xp2 + fr.dt * up[1];
  fr.ca = cosf(fr.xp2);
  fr.sa = sinf(fr.xp2);
  // energy.py::_odo_residual's measured half, odo0 = odo_prev, odo1 =
  // odo_cur
  const float* o0 = a.row<float>(kOdoPrev, p);
  const float* o1 = a.row<float>(kOdoCur, p);
  {
    const float c0 = cosf(o0[2]), s0 = sinf(o0[2]);
    const float d0 = o1[0] - o0[0], d1 = o1[1] - o0[1];
    fr.om0 = c0 * d0 + s0 * d1;
    fr.om1 = -s0 * d0 + c0 * d1;
    fr.omth = o1[2] - o0[2];
  }
  fr.fold = a.field[kFold] != nullptr && *a.row<unsigned char>(kFold, p);
  fr.xn0 = fr.xn1 = fr.xn2 = fr.v = fr.w = 0.f;
  fr.fm0 = fr.fm1 = fr.fmth = 0.f;
  if (a.two_sided) {
    const float* xn = a.row<float>(kXNext, p);
    const float* uc = a.row<float>(kUCur, p);
    const float* o2 = a.row<float>(kOdoNext, p);
    fr.xn0 = xn[0];
    fr.xn1 = xn[1];
    fr.xn2 = xn[2];
    fr.v = uc[0];
    fr.w = uc[1];
    const float c0 = cosf(o1[2]), s0 = sinf(o1[2]);
    const float d0 = o2[0] - o1[0], d1 = o2[1] - o1[1];
    fr.fm0 = c0 * d0 + s0 * d1;
    fr.fm1 = -s0 * d0 + c0 * d1;
    fr.fmth = o2[2] - o1[2];
  }
  return fr;
}

// A pass's rows in shared memory: r and the three Jacobian columns.
struct Rows {
  float *r, *j0, *j1, *j2;

  __device__ __forceinline__ void put(int k, float rk, float a, float b,
                                      float c) {
    r[k] = rk;
    j0[k] = a;
    j1[k] = b;
    j2[k] = c;
  }
};

// The problem's frame rows at x (lane 0 only): one-sided at 0 (kin) and
// m - 3 (odo); two-sided also 0 (kinf), 3 (odof), kin at 6.
__device__ void frame_rows(const Frame& fr, int two_sided, int m, float x0,
                           float x1, float x2, Rows& w) {
  const int kin = two_sided ? 6 : 0;
  // r_kin = sqrt_r * wrap_heading(x - g(x_prev, u_prev)); J = diag(sqrt_r)
  w.put(kin, fr.sr0 * (x0 - fr.kp0), fr.sr0, 0.f, 0.f);
  w.put(kin + 1, fr.sr1 * (x1 - fr.kp1), 0.f, fr.sr1, 0.f);
  w.put(kin + 2, fr.sr2 * wrap_angle(x2 - fr.kp2), 0.f, 0.f, fr.sr2);
  // r_odo, anchored at x_prev: J = sqrt_odom [[-c, -s, 0], [s, -c, 0],
  // [0, 0, -1]]
  {
    const float e0 = x0 - fr.xp0, e1 = x1 - fr.xp1, eth = x2 - fr.xp2;
    const float rx = fr.om0 - (fr.ca * e0 + fr.sa * e1);
    const float ry = fr.om1 - (-fr.sa * e0 + fr.ca * e1);
    const float rth = wrap_angle(fr.omth - eth);
    w.put(m - 3, fr.so * rx, fr.so * -fr.ca, fr.so * -fr.sa, fr.so * 0.f);
    w.put(m - 2, fr.so * ry, fr.so * fr.sa, fr.so * -fr.ca, fr.so * 0.f);
    w.put(m - 1, fr.so * rth, fr.so * 0.f, fr.so * 0.f, fr.so * -1.f);
  }
  if (!two_sided) return;
  if (fr.fold) {
    for (int k = 0; k < 6; ++k) w.put(k, 0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float c = cosf(x2), sn = sinf(x2);
  // r_kinf = sqrt_r * wrap_heading(g(x, u_cur) - x_next)
  {
    const float g0 = x0 + fr.dt * (fr.v * c);
    const float g1 = x1 + fr.dt * (fr.v * sn);
    const float g2 = x2 + fr.dt * fr.w;
    w.put(0, fr.sr0 * (g0 - fr.xn0), fr.sr0 * 1.f, fr.sr0 * 0.f,
          fr.sr0 * ((-fr.dt * fr.v) * sn));
    w.put(1, fr.sr1 * (g1 - fr.xn1), fr.sr1 * 0.f, fr.sr1 * 1.f,
          fr.sr1 * ((fr.dt * fr.v) * c));
    w.put(2, fr.sr2 * wrap_angle(g2 - fr.xn2), fr.sr2 * 0.f, fr.sr2 * 0.f,
          fr.sr2 * 1.f);
  }
  // r_odof, anchored at x: rxy = meas - R(th)(x_next - x)
  {
    const float dx = fr.xn0 - x0, dy = fr.xn1 - x1, dth = fr.xn2 - x2;
    const float rx = fr.fm0 - (c * dx + sn * dy);
    const float ry = fr.fm1 - (-sn * dx + c * dy);
    const float rth = wrap_angle(fr.fmth - dth);
    const float dRd0 = -sn * dx + c * dy;
    const float dRd1 = -c * dx - sn * dy;
    w.put(3, fr.so * rx, fr.so * c, fr.so * sn, fr.so * -dRd0);
    w.put(4, fr.so * ry, fr.so * -sn, fr.so * c, fr.so * -dRd1);
    w.put(5, fr.so * rth, fr.so * 0.f, fr.so * 0.f, fr.so * 1.f);
  }
}

// Beam b's two rows at x: r = (x_xy + dist [cos a, sin a] - matched) *
// sqrt_q with a = ang + th - pi/2, zero where masked; J as
// energy.py::one_sided_jacobian builds it, scaled by sqrt_q * mask.
__device__ __forceinline__ void beam_rows(const Problems& a, const Frame& fr,
                                          int p, int b, int k, float x0,
                                          float x1, float x2, Rows& w) {
  const float d = a.row<float>(kDist, p)[b];
  const float an = a.row<float>(kAng, p)[b];
  const bool live = a.row<unsigned char>(kMask, p)[b] != 0;
  const float* mt = a.row<float>(kMatched, p) + 2 * b;
  const float ang = (an + x2) - kHalfPi;
  const float c = cosf(ang), sn = sinf(ang);
  const float dsin = d * sn, dcos = d * c;
  const float mf = live ? 1.f : 0.f;
  const float s0 = fr.sq0 * mf, s1 = fr.sq1 * mf;
  const float rx = live ? ((x0 + dcos) - mt[0]) * fr.sq0 : 0.f;
  const float ry = live ? ((x1 + dsin) - mt[1]) * fr.sq1 : 0.f;
  w.put(k, rx, 1.f * s0, 0.f * s0, -dsin * s0);
  w.put(k + 1, ry, 0.f * s1, 1.f * s1, dcos * s1);
}

// torch's per-thread reduce over rows start, start + S, ... of a[k] * b[k]:
// four accumulators taking every fourth of them in turn, then
// ((a0 + a1) + a2) + a3
__device__ float chain(const float* a, const float* b, int m, int start,
                       int S) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int k = start;
  for (; k + 3 * S < m; k += 4 * S) {
    a0 += a[k] * b[k];
    a1 += a[k + S] * b[k + S];
    a2 += a[k + 2 * S] * b[k + 2 * S];
    a3 += a[k + 3 * S] * b[k + 3 * S];
  }
  if (k < m) a0 += a[k] * b[k];
  k += S;
  if (k < m) a1 += a[k] * b[k];
  k += S;
  if (k < m) a2 += a[k] * b[k];
  return ((a0 + a1) + a2) + a3;
}

// torch's vectorised per-thread reduce of r[k]^2 for lane x of V: the row
// starts s0 floats past a 16-byte boundary; lanes s0..3 take the head,
// then four-float vectors x, x + V, ... into four accumulators, the tail
// into the first
__device__ float vec_partial(const float* r, int m, int x, int V, int s0) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int base = 0, end = m;
  if (s0 > 0) {
    if (x >= s0 && x < 4) a0 += r[x - s0] * r[x - s0];
    base = 4 - s0;
    end = m - base;
  }
  for (int i = x; i * 4 + 3 < end; i += V) {
    const float* q = r + base + 4 * i;
    a0 += q[0] * q[0];
    a1 += q[1] * q[1];
    a2 += q[2] * q[2];
    a3 += q[3] * q[3];
  }
  const int e = end - end % 4 + x;
  if (e < end) a0 += r[base + e] * r[base + e];
  return ((a0 + a1) + a2) + a3;
}

// f = sum r^2 in torch's order; every lane returns it
__device__ float sum_f(const Problems& a, const Rows& w, float* part, int m,
                       int s0, int lane) {
  for (int v = lane; v < a.f_v; v += 32)
    part[v] = a.f_vec ? vec_partial(w.r, m, v, a.f_v, s0)
                      : chain(w.r, w.r, m, v, a.f_v);
  __syncwarp();
  for (int off = a.f_v >> 1; off > 0; off >>= 1) {
    for (int i = lane; i < off; i += 32) part[i] += part[i + off];
    __syncwarp();
  }
  const float f = part[0];
  __syncwarp();
  return f;
}

// g (3) and the 6 of H in torch's order, into s[0..8] (g0 g1 g2 h00 h01
// h02 h11 h12 h22) in every lane; output o's partials at part[o * vmax]
__device__ void sum_gh(const Problems& a, const Rows& w, float* part, int m,
                       int lane, float* s) {
  const float* ja[9] = {w.j0, w.j1, w.j2, w.j0, w.j0, w.j0, w.j1, w.j1, w.j2};
  const float* jb[9] = {w.r, w.r, w.r, w.j0, w.j1, w.j2, w.j1, w.j2, w.j2};
  const int vmax = a.g_v > a.h_v ? a.g_v : a.h_v;
  const int ng = 3 * a.g_v;
  for (int t = lane; t < ng + 6 * a.h_v; t += 32) {
    const bool g = t < ng;
    const int V = g ? a.g_v : a.h_v;
    const int u = g ? t : t - ng;
    const int o = (g ? 0 : 3) + u / V, v = u % V;
    part[o * vmax + v] = chain(ja[o], jb[o], m, v, V);
  }
  __syncwarp();
  for (int off = vmax >> 1; off > 0; off >>= 1) {
    for (int t = lane; t < 9 * off; t += 32) {
      const int o = t / off, i = t % off;
      if (off < (o < 3 ? a.g_v : a.h_v))
        part[o * vmax + i] += part[o * vmax + i + off];
    }
    __syncwarp();
  }
  for (int o = 0; o < 9; ++o) s[o] = part[o * vmax];
  __syncwarp();
}

// The rows of problem p at x into shared memory, a beam a lane.
__device__ void rows_at(const Problems& a, const Frame& fr, int p, int m,
                        int lane, float x0, float x1, float x2, Rows& w) {
  const int ob = a.two_sided ? 9 : 3;
  for (int b = lane; b < a.B; b += 32)
    beam_rows(a, fr, p, b, ob + 2 * b, x0, x1, x2, w);
  if (lane == 0) frame_rows(fr, a.two_sided, m, x0, x1, x2, w);
  __syncwarp();
}

__global__ void pose_lm_kernel(Problems a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int p = blockIdx.x;
  const int m = (a.two_sided ? 12 : 6) + 2 * a.B;
  // the plain version's r*r row p starts p*m floats into a 16-byte-aligned
  // (P, m) tensor
  const int s0 = static_cast<int>((static_cast<long long>(p) * m) % 4);
  Rows w = {smem, smem + m, smem + 2 * m, smem + 3 * m};
  float* part = smem + 4 * m;
  const Frame fr = load_frame(a, p);
  const float* start = a.row<float>(kX0, p);
  float x0 = start[0], x1 = start[1], x2 = start[2];
  rows_at(a, fr, p, m, lane, x0, x1, x2, w);
  float fx = sum_f(a, w, part, m, s0, lane);
  float s[9];
  sum_gh(a, w, part, m, lane, s);
  float lam = a.lam0;
  for (int it = 0; it < a.iters; ++it) {
    // A = H + lam diag(max(diag H, 1e-12)) + 1e-12 I, solved by cofactors
    // (solver/gauss_newton.py::_solve3) against -g
    const float a00 = (s[3] + lam * fmaxf(s[3], kTiny)) + kTiny;
    const float a11 = (s[6] + lam * fmaxf(s[6], kTiny)) + kTiny;
    const float a22 = (s[8] + lam * fmaxf(s[8], kTiny)) + kTiny;
    const float a01 = s[4], a02 = s[5], a12 = s[7];
    const float b0 = -s[0], b1 = -s[1], b2 = -s[2];
    const float c00 = a11 * a22 - a12 * a12;
    const float c01 = a12 * a02 - a01 * a22;
    const float c02 = a01 * a12 - a11 * a02;
    const float det = a00 * c00 + a01 * c01 + a02 * c02;
    const float c10 = a02 * a12 - a01 * a22;
    const float c11 = a00 * a22 - a02 * a02;
    const float c12 = a01 * a02 - a00 * a12;
    const float c20 = a01 * a12 - a02 * a11;
    const float c21 = a02 * a01 - a00 * a12;
    const float c22 = a00 * a11 - a01 * a01;
    const float n0 = x0 + (c00 * b0 + c10 * b1 + c20 * b2) / det;
    const float n1 = x1 + (c01 * b0 + c11 * b1 + c21 * b2) / det;
    const float n2 = x2 + (c02 * b0 + c12 * b1 + c22 * b2) / det;
    rows_at(a, fr, p, m, lane, n0, n1, n2, w);
    const float fn = sum_f(a, w, part, m, s0, lane);
    if (fn < fx) {
      x0 = n0;
      x1 = n1;
      x2 = n2;
      fx = fn;
      sum_gh(a, w, part, m, lane, s);
      lam = lam * a.lam_down;
    } else {
      lam = lam * a.lam_up;
    }
  }
  if (lane == 0) {
    a.x_out[3 * p] = x0;
    a.x_out[3 * p + 1] = x1;
    a.x_out[3 * p + 2] = x2;
  }
}

bool pow2_upto(int v, int hi) { return v >= 1 && v <= hi && !(v & (v - 1)); }

}  // namespace

// `fields` holds the kFields pointers of the Field order (float32; mask
// and fold torch bool), `strides` each field's row stride in elements (a
// row's own elements contiguous; 0 repeats one row for every problem);
// x_next, u_cur and odo_next are read only when two_sided, fold may be
// null; both arrays are read on the host, at the launch.  sqrt_r (3,),
// sqrt_q (2,) and sqrt_odom () are read from device memory, so the
// caller never syncs to pass them.  x_out is (P, 3) contiguous.  A block
// of one warp a problem, P blocks, `shmem` bytes of shared memory (4 m
// floats of rows and the partials, as ops/pose_lm.py::launch_plan makes
// it); f_vec, f_v, g_v, h_v the sum order of ops/pose_lm.py::reduce_plan.
// A plan that does not fit the call is refused with cudaErrorInvalidValue
// before anything is launched.
extern "C" int icm_pose_lm(
    const void* const* fields, const long long* strides, const float* sqrt_r,
    const float* sqrt_q, const float* sqrt_odom, int P, int B, int two_sided,
    int iters, float deltat, float lam0, float lam_down, float lam_up,
    int f_vec, int f_v, int g_v, int h_v, int shmem, float* x_out,
    cudaStream_t stream) {
  if (P == 0) return 0;
  const long long m = (two_sided ? 12 : 6) + 2LL * B;
  const int vmax = g_v > h_v ? g_v : h_v;
  const long long need =
      4 * (4 * m + (9 * vmax > f_v ? 9 * vmax : f_v));
  if (P < 0 || B < 0 || iters < 0 || !pow2_upto(f_v, 512) ||
      !pow2_upto(g_v, 256) || !pow2_upto(h_v, 256) || f_v > m ||
      g_v > m || h_v > m || (f_vec && (m < 128 || f_v < 4)) ||
      shmem < need || shmem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  Problems a;
  for (int f = 0; f < kFields; ++f) {
    if (strides[f] < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.field[f] = fields[f];
    a.stride[f] = strides[f];
  }
  a.sqrt_r = sqrt_r;
  a.sqrt_q = sqrt_q;
  a.sqrt_odom = sqrt_odom;
  a.x_out = x_out;
  a.P = P;
  a.B = B;
  a.two_sided = two_sided;
  a.iters = iters;
  a.deltat = deltat;
  a.lam0 = lam0;
  a.lam_down = lam_down;
  a.lam_up = lam_up;
  a.f_vec = f_vec;
  a.f_v = f_v;
  a.g_v = g_v;
  a.h_v = h_v;
  pose_lm_kernel<<<P, 32, shmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
