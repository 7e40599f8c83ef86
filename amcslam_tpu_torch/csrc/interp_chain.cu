// Fused WNOA GP-interpolation chain, one (pose-pair, camera-time) combo per
// thread, for NVIDIA Hopper (sm_90a).
//
// Replaces amcslam_tpu/ops/pallas_chain.py::_chain_kernel (the only Pallas
// kernel of the reference). Per combo it computes gp_pair_pack followed by
// gp_interp_pack (amcslam_tpu/factors/reprojection.py:254-367):
//   T12 = T1^-1 T2, xi12 = log T12, Jr^-1(xi12), nu2 = Jr^-1 v2,
//   A1 = -Jr^-1 Ad(T12)^-1, B1 = -1/2 ad(v2) A1, B2 = -1/2 ad(v2) Jr^-1,
//   the Hermite coefficients, dxi, Twb = T1 exp(dxi), Tbw = Twb^-1 and the
//   Jacobian right factor Q = [Q1 Q2 Q3 Q4] (6 x 24).
//
// What bounds it: at the local BA's ~1k combos it reads 0.2 MB, writes
// 1.4 MB (f32) and does a few MFLOP, so it is bound by launch latency. The
// design answers that with one launch for the whole chain (the plain PyTorch
// version is several hundred small launches): every intermediate lives in
// registers, no shared memory, no inter-thread communication.
//
// Design notes:
//   * every 6x6 in the chain (SE(3) Jacobians, adjoints, ad operators) is
//     block-upper-triangular [[P, Q], [0, R]] and is carried as three 3x3s,
//     so a 6x6 product costs three 3x3 products and one add;
//   * numerics follow amcslam_tpu/ops/lie.py: the same series thresholds
//     (squared angle 1e-4 in f64, 4e-2 in f32), the same branchless
//     quaternion log with a first-index tie rule, native atan2 (the Pallas
//     kernel's series atan existed only because Mosaic lacks inverse trig);
//   * adj(exp(-xi)) stands in for adj(exp(xi)^-1): equal to roundoff;
//   * inputs are read in the public row-major layout: T (S,4,4), v (S,6),
//     t (S,); outputs Twb/Tbw (S,4,4) and Q (S,6,24) row-major, with the
//     zero lower-left 3x3 of every Q block written explicitly.
//
// C interface (loaded with ctypes): one launcher per dtype. Each takes the
// device pointers, S and the cudaStream_t, launches on that stream without
// synchronising and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float small2() { return 4e-2f; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float sin_(float x) { return sinf(x); }
  static __device__ __forceinline__ float cos_(float x) { return cosf(x); }
  static __device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double small2() { return 1e-4; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
  static __device__ __forceinline__ double sin_(double x) { return sin(x); }
  static __device__ __forceinline__ double cos_(double x) { return cos(x); }
  static __device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
};

template <typename T> struct V3 { T v[3]; };
template <typename T> struct M3 { T m[9]; };       // row-major 3x3
template <typename T> struct UT { M3<T> P, Q, R; };  // [[P, Q], [0, R]]

template <typename T>
__device__ __forceinline__ M3<T> mm(const M3<T>& a, const M3<T>& b) {
  M3<T> o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      o.m[3 * i + j] = a.m[3 * i] * b.m[j] + a.m[3 * i + 1] * b.m[3 + j] +
                       a.m[3 * i + 2] * b.m[6 + j];
  return o;
}

template <typename T>
__device__ __forceinline__ V3<T> mv(const M3<T>& a, const V3<T>& x) {
  V3<T> o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o.v[i] = a.m[3 * i] * x.v[0] + a.m[3 * i + 1] * x.v[1] + a.m[3 * i + 2] * x.v[2];
  return o;
}

template <typename T>
__device__ __forceinline__ M3<T> mT(const M3<T>& a) {
  M3<T> o;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) o.m[3 * i + j] = a.m[3 * j + i];
  return o;
}

template <typename T>
__device__ __forceinline__ M3<T> madd(const M3<T>& a, const M3<T>& b) {
  M3<T> o;
#pragma unroll
  for (int k = 0; k < 9; ++k) o.m[k] = a.m[k] + b.m[k];
  return o;
}

template <typename T>
__device__ __forceinline__ M3<T> mscale(T c, const M3<T>& a) {
  M3<T> o;
#pragma unroll
  for (int k = 0; k < 9; ++k) o.m[k] = c * a.m[k];
  return o;
}

template <typename T>
__device__ __forceinline__ M3<T> hat(const V3<T>& w) {
  const T z = T(0);
  return M3<T>{{z, -w.v[2], w.v[1], w.v[2], z, -w.v[0], -w.v[1], w.v[0], z}};
}

template <typename T>
__device__ __forceinline__ M3<T> eye3() {
  return M3<T>{{T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)}};
}

template <typename T>
__device__ __forceinline__ T dot3(const V3<T>& a, const V3<T>& b) {
  return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2];
}

template <typename T>
__device__ __forceinline__ V3<T> neg(const V3<T>& a) {
  return V3<T>{{-a.v[0], -a.v[1], -a.v[2]}};
}

template <typename T>
__device__ __forceinline__ V3<T> vadd(const V3<T>& a, const V3<T>& b) {
  return V3<T>{{a.v[0] + b.v[0], a.v[1] + b.v[1], a.v[2] + b.v[2]}};
}

// ---- block-upper-triangular 6x6 algebra ----

template <typename T>
__device__ __forceinline__ UT<T> ut_mm(const UT<T>& a, const UT<T>& b) {
  return UT<T>{mm(a.P, b.P), madd(mm(a.P, b.Q), mm(a.Q, b.R)), mm(a.R, b.R)};
}

template <typename T>
__device__ __forceinline__ void ut_mv(const UT<T>& a, const V3<T>& x, const V3<T>& y,
                                      V3<T>& ox, V3<T>& oy) {
  ox = vadd(mv(a.P, x), mv(a.Q, y));
  oy = mv(a.R, y);
}

template <typename T>
__device__ __forceinline__ UT<T> ut_add(const UT<T>& a, const UT<T>& b) {
  return UT<T>{madd(a.P, b.P), madd(a.Q, b.Q), madd(a.R, b.R)};
}

template <typename T>
__device__ __forceinline__ UT<T> ut_scale(T c, const UT<T>& a) {
  return UT<T>{mscale(c, a.P), mscale(c, a.Q), mscale(c, a.R)};
}

// ---- Lie algebra (ops/lie.py) ----

// (A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), series-safe
template <typename T>
__device__ __forceinline__ void trig_coeffs(T theta2, T& A, T& B, T& C) {
  const bool small = theta2 < Num<T>::small2();
  const T safe2 = small ? T(1) : theta2;
  const T theta = Num<T>::sqrt_(safe2);
  const T s = Num<T>::sin_(theta), c = Num<T>::cos_(theta);
  const T t4 = theta2 * theta2;
  A = small ? T(1) - theta2 / T(6) + t4 / T(120) : s / theta;
  B = small ? T(0.5) - theta2 / T(24) + t4 / T(720) : (T(1) - c) / safe2;
  C = small ? T(1) / T(6) - theta2 / T(120) + t4 / T(5040) : (theta - s) / (safe2 * theta);
}

template <typename T>
__device__ __forceinline__ M3<T> exp_so3(const V3<T>& w) {
  T A, B, C;
  trig_coeffs(dot3(w, w), A, B, C);
  const M3<T> W = hat(w);
  return madd(madd(eye3<T>(), mscale(A, W)), mscale(B, mm(W, W)));
}

template <typename T>
__device__ __forceinline__ M3<T> jl_so3(const V3<T>& w) {
  T A, B, C;
  trig_coeffs(dot3(w, w), A, B, C);
  const M3<T> W = hat(w);
  return madd(madd(eye3<T>(), mscale(B, W)), mscale(C, mm(W, W)));
}

template <typename T>
__device__ __forceinline__ M3<T> jl_so3_inv(const V3<T>& w) {
  const T theta2 = dot3(w, w);
  const bool small = theta2 < Num<T>::small2();
  const T safe2 = small ? T(1) : theta2;
  const T theta = Num<T>::sqrt_(safe2);
  const T s = Num<T>::sin_(theta), c = Num<T>::cos_(theta);
  const T t4 = theta2 * theta2;
  const T D = small ? T(1) / T(12) + theta2 / T(720) + t4 / T(30240)
                    : T(1) / safe2 - (T(1) + c) / (T(2) * theta * s);
  const M3<T> W = hat(w);
  return madd(madd(eye3<T>(), mscale(T(-0.5), W)), mscale(D, mm(W, W)));
}

// branchless Shepperd quaternion + series-safe log (ops/lie.py:85-137)
template <typename T>
__device__ __forceinline__ V3<T> log_so3(const M3<T>& R) {
  const T m00 = R.m[0], m01 = R.m[1], m02 = R.m[2];
  const T m10 = R.m[3], m11 = R.m[4], m12 = R.m[5];
  const T m20 = R.m[6], m21 = R.m[7], m22 = R.m[8];
  const T tr = m00 + m11 + m22;
  const T p0 = T(1) + tr;
  const T p1 = T(1) + T(2) * m00 - tr;
  const T p2 = T(1) + T(2) * m11 - tr;
  const T p3 = T(1) + T(2) * m22 - tr;
  // first-index argmax over the four pivots (the jnp.argmax tie rule)
  int idx = 0;
  T best = p0;
  if (p1 > best) { idx = 1; best = p1; }
  if (p2 > best) { idx = 2; best = p2; }
  if (p3 > best) { idx = 3; best = p3; }
  const T d = T(2) * Num<T>::sqrt_(best > Num<T>::tiny() ? best : Num<T>::tiny());
  T q[4];
  if (idx == 0) {
    q[0] = p0 / d; q[1] = (m21 - m12) / d; q[2] = (m02 - m20) / d; q[3] = (m10 - m01) / d;
  } else if (idx == 1) {
    q[0] = (m21 - m12) / d; q[1] = p1 / d; q[2] = (m01 + m10) / d; q[3] = (m02 + m20) / d;
  } else if (idx == 2) {
    q[0] = (m02 - m20) / d; q[1] = (m01 + m10) / d; q[2] = p2 / d; q[3] = (m12 + m21) / d;
  } else {
    q[0] = (m10 - m01) / d; q[1] = (m02 + m20) / d; q[2] = (m12 + m21) / d; q[3] = p3 / d;
  }
  const T norm = Num<T>::sqrt_(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const T sgn = (q[0] / norm < T(0)) ? T(-1) : T(1);  // canonicalize to w >= 0
  const T w = sgn * (q[0] / norm);
  const V3<T> v{{sgn * (q[1] / norm), sgn * (q[2] / norm), sgn * (q[3] / norm)}};
  const T nv2 = dot3(v, v);
  const bool small = nv2 < Num<T>::small2() * T(0.25);
  const T nv = Num<T>::sqrt_(small ? T(1) : nv2);
  const T w_safe = w > T(1e-3) ? w : T(1e-3);
  const T factor = small ? T(2) / w_safe * (T(1) - nv2 / (T(3) * w_safe * w_safe))
                         : T(2) * Num<T>::atan2_(nv, w) / nv;
  return V3<T>{{factor * v.v[0], factor * v.v[1], factor * v.v[2]}};
}

// Barfoot's Q coupling block (ops/lie.py:270-321)
template <typename T>
__device__ __forceinline__ M3<T> pose3_Q(const V3<T>& rho, const V3<T>& w) {
  const M3<T> X = hat(w), Y = hat(rho);
  const M3<T> XY = mm(X, Y), YX = mm(Y, X);
  const M3<T> XYX = mm(X, YX);
  const T theta2 = dot3(w, w);
  const bool small = theta2 < Num<T>::small2();
  const T safe2 = small ? T(1) : theta2;
  const T theta = Num<T>::sqrt_(safe2);
  const T s = Num<T>::sin_(theta), c = Num<T>::cos_(theta);
  const T t3 = safe2 * theta, t4 = safe2 * safe2, t5 = t4 * theta;
  const T th4 = theta2 * theta2;
  const T cQ2 = small ? T(1) / T(6) - theta2 / T(120) + th4 / T(5040) : (theta - s) / t3;
  const T cQ3 = small ? T(-1) / T(24) + theta2 / T(720) - th4 / T(40320)
                      : (T(1) - T(0.5) * safe2 - c) / t4;
  const T cQ4 = small ? T(-1) / T(60) + theta2 / T(1260) - th4 / T(60480)
                      : cQ3 - T(3) * (theta - s - t3 / T(6)) / t5;
  M3<T> out = mscale(T(0.5), Y);
  out = madd(out, mscale(cQ2, madd(madd(XY, YX), XYX)));
  out = madd(out, mscale(-cQ3, madd(madd(mm(X, XY), mm(YX, X)), mscale(T(-3), XYX))));
  out = madd(out, mscale(T(-0.5) * cQ4, madd(mm(XYX, X), mm(X, XYX))));
  return out;
}

// [[Jl(w), Q(rho, w)], [0, Jl(w)]]
template <typename T>
__device__ __forceinline__ UT<T> jl_pose3(const V3<T>& rho, const V3<T>& w) {
  const M3<T> J = jl_so3(w);
  return UT<T>{J, pose3_Q(rho, w), J};
}

// [[Jl^-1, -Jl^-1 Q Jl^-1], [0, Jl^-1]]
template <typename T>
__device__ __forceinline__ UT<T> jl_pose3_inv(const V3<T>& rho, const V3<T>& w) {
  const M3<T> Ji = jl_so3_inv(w);
  return UT<T>{Ji, mscale(T(-1), mm(mm(Ji, pose3_Q(rho, w)), Ji)), Ji};
}

// exp_se3 -> (R, t)
template <typename T>
__device__ __forceinline__ void exp_se3(const V3<T>& rho, const V3<T>& w, M3<T>& R, V3<T>& t) {
  R = exp_so3(w);
  t = mv(jl_so3(w), rho);
}

template <typename T>
__device__ __forceinline__ void store_pose(T* out, const M3<T>& R, const V3<T>& t) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out[4 * r + 0] = R.m[3 * r + 0];
    out[4 * r + 1] = R.m[3 * r + 1];
    out[4 * r + 2] = R.m[3 * r + 2];
    out[4 * r + 3] = t.v[r];
  }
  out[12] = T(0); out[13] = T(0); out[14] = T(0); out[15] = T(1);
}

template <typename T>
__device__ __forceinline__ void store_ut(T* q, int col0, const UT<T>& B) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[24 * r + col0 + c] = B.P.m[3 * r + c];
      q[24 * r + col0 + 3 + c] = B.Q.m[3 * r + c];
      q[24 * (3 + r) + col0 + c] = T(0);
      q[24 * (3 + r) + col0 + 3 + c] = B.R.m[3 * r + c];
    }
}

template <typename T>
__global__ void __launch_bounds__(128)
chain_kernel(const T* __restrict__ T1, const T* __restrict__ v1, const T* __restrict__ T2,
             const T* __restrict__ v2, const T* __restrict__ t1, const T* __restrict__ t2,
             const T* __restrict__ tq, T* __restrict__ twb, T* __restrict__ tbw,
             T* __restrict__ q, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;

  const T* a = T1 + 16 * i;
  const T* b = T2 + 16 * i;
  const M3<T> R1{{a[0], a[1], a[2], a[4], a[5], a[6], a[8], a[9], a[10]}};
  const V3<T> t1v{{a[3], a[7], a[11]}};
  const M3<T> R2{{b[0], b[1], b[2], b[4], b[5], b[6], b[8], b[9], b[10]}};
  const V3<T> t2v{{b[3], b[7], b[11]}};
  const T* pv1 = v1 + 6 * i;
  const T* pv2 = v2 + 6 * i;
  const V3<T> v1r{{pv1[0], pv1[1], pv1[2]}}, v1w{{pv1[3], pv1[4], pv1[5]}};
  const V3<T> v2r{{pv2[0], pv2[1], pv2[2]}}, v2w{{pv2[3], pv2[4], pv2[5]}};
  const T tt1 = t1[i], tt2 = t2[i], tt = tq[i];

  // ---- gp_pair_pack ----
  const M3<T> R1T = mT(R1);
  const M3<T> R12 = mm(R1T, R2);
  const V3<T> t12 = mv(R1T, vadd(t2v, neg(t1v)));
  const V3<T> w12 = log_so3(R12);
  const V3<T> rho12 = mv(jl_so3_inv(w12), t12);
  const UT<T> Jri = jl_pose3_inv(neg(rho12), neg(w12));  // Jr^-1(xi12)
  V3<T> nu2r, nu2w;
  ut_mv(Jri, v2r, v2w, nu2r, nu2w);
  const UT<T> adv2{hat(v2w), hat(v2r), hat(v2w)};
  M3<T> Re;
  V3<T> te;
  exp_se3(neg(rho12), neg(w12), Re, te);
  const UT<T> adjE{Re, mm(hat(te), Re), Re};  // Ad(T12)^-1
  const UT<T> A1 = ut_scale(T(-1), ut_mm(Jri, adjE));
  const UT<T> B1 = ut_scale(T(-0.5), ut_mm(adv2, A1));
  const UT<T> B2 = ut_scale(T(-0.5), ut_mm(adv2, Jri));

  // ---- gp_interp_pack ----
  const T dt = tt2 - tt1;
  const T s = (tt - tt1) / dt;
  const T s2 = s * s;
  const T a12 = dt * s * (T(1) - s) * (T(1) - s);
  const T p11 = s2 * (T(3) - T(2) * s);
  const T p12 = dt * s2 * (s - T(1));
  V3<T> dr, dw;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    dr.v[k] = a12 * v1r.v[k] + p11 * rho12.v[k] + p12 * nu2r.v[k];
    dw.v[k] = a12 * v1w.v[k] + p11 * w12.v[k] + p12 * nu2w.v[k];
  }
  M3<T> Rd;
  V3<T> td;
  exp_se3(dr, dw, Rd, td);
  const M3<T> Rw = mm(R1, Rd);
  const V3<T> tw = vadd(mv(R1, td), t1v);
  const M3<T> RwT = mT(Rw);
  const V3<T> tb = neg(mv(RwT, tw));
  store_pose(twb + 16 * i, Rw, tw);
  store_pose(tbw + 16 * i, RwT, tb);

  M3<T> Rei;
  V3<T> tei;
  exp_se3(neg(dr), neg(dw), Rei, tei);
  const UT<T> Ad_dT{Rei, mm(hat(tei), Rei), Rei};  // Ad(dT^-1)
  const UT<T> Jr_dxi = jl_pose3(neg(dr), neg(dw));  // Jr(dxi)

  T* qo = q + 144 * i;
  store_ut(qo, 0, ut_add(ut_mm(Jr_dxi, ut_add(ut_scale(p11, A1), ut_scale(p12, B1))), Ad_dT));
  store_ut(qo, 6, ut_scale(a12, Jr_dxi));
  store_ut(qo, 12, ut_mm(Jr_dxi, ut_add(ut_scale(p11, Jri), ut_scale(p12, B2))));
  store_ut(qo, 18, ut_scale(p12, ut_mm(Jr_dxi, Jri)));
}

template <typename T>
int launch(const void* T1, const void* v1, const void* T2, const void* v2, const void* t1,
           const void* t2, const void* t, void* twb, void* tbw, void* q, int S, void* stream) {
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  const int blocks = (S + kThreads - 1) / kThreads;
  chain_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(T1), static_cast<const T*>(v1), static_cast<const T*>(T2),
      static_cast<const T*>(v2), static_cast<const T*>(t1), static_cast<const T*>(t2),
      static_cast<const T*>(t), static_cast<T*>(twb), static_cast<T*>(tbw),
      static_cast<T*>(q), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int interp_chain_f32(const void* T1, const void* v1, const void* T2, const void* v2,
                     const void* t1, const void* t2, const void* t, void* twb, void* tbw,
                     void* q, int S, void* stream) {
  return launch<float>(T1, v1, T2, v2, t1, t2, t, twb, tbw, q, S, stream);
}

int interp_chain_f64(const void* T1, const void* v1, const void* T2, const void* v2,
                     const void* t1, const void* t2, const void* t, void* twb, void* tbw,
                     void* q, int S, void* stream) {
  return launch<double>(T1, v1, T2, v2, t1, t2, t, twb, tbw, q, S, stream);
}

}  // extern "C"
