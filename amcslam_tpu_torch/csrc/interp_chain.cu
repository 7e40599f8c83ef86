// Fused WNOA GP-interpolation chain for NVIDIA Hopper (sm_90a): a block of
// four warps per group of 8 (pose-pair, camera-time) combos; the warps take
// the independent branches of each combo's chain, and four lanes of every
// warp carry one combo.
//
// Replaces amcslam_tpu/ops/pallas_chain.py::_chain_kernel (the only Pallas
// kernel of the reference). Per combo it computes gp_pair_pack followed by
// gp_interp_pack (amcslam_tpu/factors/reprojection.py:254-367):
//   T12 = T1^-1 T2, xi12 = log T12, Jr^-1(xi12), nu2 = Jr^-1 v2,
//   A1 = -Jr^-1 Ad(T12)^-1, B1 = -1/2 ad(v2) A1, B2 = -1/2 ad(v2) Jr^-1,
//   the Hermite coefficients, dxi, Twb = T1 exp(dxi), Tbw = Twb^-1 and the
//   Jacobian right factor Q = [Q1 Q2 Q3 Q4] (6 x 24).
//
// What bounds it. Per combo it needs 39 input values (the (R|t) rows and
// twists of both endpoints, three times; indices add two int64), writes 176
// and does about 2.7 kFLOP. At the sizes the System launches it (S = 6 for a
// tracked frame's pose solve, S = the local BA's combo bucket, S = 1,024 at
// the headline window) that is under 1 MB (f32) and a few MFLOP: well under
// a microsecond of the card's bandwidth or arithmetic at every size. The
// time is the latency of one combo's chain (~40 dependent 3x3 products, a
// quaternion log, square roots, sin/cos/atan2 and some 40 IEEE divisions,
// each of which is a branch region of ~230 cycles: fast path, range check,
// slow-path call) plus the launch. The design shortens that chain and keeps
// the memory traffic coalesced:
//   * the chain's independent branches run on different warps (different
//     schedulers of the SM), exchanging 3x3 blocks through shared memory at
//     a block barrier between stages (branches inside one warp would run one
//     after the other):
//       stage 1 (every warp, redundantly): R12, t12, log, the series
//               coefficients of |w12|, Jl^-1 -> rho12;
//       stage 2: warp 0 the coupling block of Jr^-1(xi12) (pose3_Q and two
//               products; the critical path), warp 1 Ad(T12)^-1, warp 2
//               the Hermite coefficients;
//       stage 3 (every warp: nu2, dxi, the coefficients of |dw|): warp 0 the
//               coupling block of Jr(dxi), warp 1 Ad(dT^-1) and Jl(-dw),
//               warp 2 Twb/Tbw and B2, warp 3 A1 and B1;
//       stage 4: one Q block per warp;
//   * four lanes of each warp carry one combo and split its batches of
//     independent divisions (the log's, the series coefficients') between
//     them, exchanging quotients with __shfl_sync (`divide`);
//   * a group's inputs are loaded into shared memory by the whole block with
//     all loads in flight at once, each pose row by consecutive threads and
//     through the combo's endpoint rows (no gathered copies beforehand); its
//     outputs are staged in shared memory in their own layout and written as
//     16-byte vectors by consecutive threads: each output of the group is one
//     contiguous span (Q is (S,6,24) row-major), zero lower-left blocks
//     included;
//   * 8 combos a block, so S = 1,024 runs on 128 of the 132 SMs;
//   * no tensor cores: every product is 3x3, far below a 64-row wgmma tile,
//     and one combo's chain is serial;
//   * every 6x6 of the chain (SE(3) Jacobians, adjoints, ad operators) is
//     block-upper-triangular [[P, Q], [0, R]] with R == P bit for bit, so it
//     is carried as (P, Q); values the chain needs twice from the same
//     inputs (the series coefficients of one angle, W^2 for +-w) are
//     computed once, which gives the same bits as computing them twice.
//
// Numerics follow amcslam_tpu/ops/lie.py: the same series thresholds (squared
// angle 1e-4 in f64, 4e-2 in f32), the same branchless quaternion log with a
// first-index tie rule, precise sqrt/sincos/atan2 and IEEE division (no
// fast-math); only the selected side of each series threshold is evaluated.
// adj(exp(-xi)) stands in for adj(exp(xi)^-1): equal to roundoff. A combo's
// result depends on its own inputs only, bit for bit.
//
// C interface (loaded with ctypes): one launcher per dtype, plus an empty
// kernel for the launch floor. An endpoint is a table (T (N,4,4), v (N,6),
// times (N,)) and a row per combo: rows[s] when an int64 index array is
// given, else s * step (step 1: row-aligned inputs; step 0: one shared row).
// An index outside [0, N) stops the kernel with a trap (a device-side assert,
// as PyTorch's own index kernels do). The output is one 16-byte aligned
// buffer [Twb (S,4,4) | Tbw (S,4,4) | Q (S,6,24)]. Each launcher launches on
// the given stream without synchronising and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cfloat>

namespace {

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float small2() { return 4e-2f; }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  static __device__ __forceinline__ void sincos_(float x, float* s, float* c) { sincosf(x, s, c); }
  static __device__ __forceinline__ float atan2_(float y, float x) { return atan2f(y, x); }
};
template <> struct Num<double> {
  static __device__ __forceinline__ double small2() { return 1e-4; }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  static __device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
  static __device__ __forceinline__ void sincos_(double x, double* s, double* c) { sincos(x, s, c); }
  static __device__ __forceinline__ double atan2_(double y, double x) { return atan2(y, x); }
};

template <typename T> struct V3 { T v[3]; };
template <typename T> struct M3 { T m[9]; };  // row-major 3x3

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

// ---- Lie algebra (ops/lie.py) ----

// ---- one combo on four lanes ----
//
// A block holds 8 combos. In every warp, lanes c, c + 8, c + 16 and c + 24
// carry combo c and compute its chain redundantly, except for batches of
// independent IEEE divisions: each division is a branch region of its own
// (fast path, range check, slow-path call) that does not overlap the next,
// so a batch of K is split over the combo's four lanes (lane group g takes
// k = g, g + 4, ...) and the quotients are exchanged with __shfl_sync. Each
// quotient is the same IEEE division on the same operands.
constexpr int kCombos = 8;
constexpr int kLanes = 4;

template <typename T, int K>
__device__ __forceinline__ void divide(const T (&num)[K], const T (&den)[K], T (&q)[K],
                                       unsigned mask) {
  const int lane = threadIdx.x & 31, g = lane / kCombos, c = lane % kCombos;
  constexpr int kRounds = (K + kLanes - 1) / kLanes;
  T mine[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    T n = T(0), d = T(1);
#pragma unroll
    for (int h = 0; h < kLanes; ++h)
      if (kLanes * j + h < K && h == g) {
        n = num[kLanes * j + h];
        d = den[kLanes * j + h];
      }
    mine[j] = n / d;
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    q[k] = __shfl_sync(mask, mine[k / kLanes], c + kCombos * (k % kLanes));
}

// The series-safe coefficients of one rotation angle, from theta^2:
//   A = sin t/t, B = (1-cos t)/t^2, C = (t-sin t)/t^3 (exp/Jl, and pose3_Q's
//   second coefficient), D (Jl^-1), Q3 and Q4 (pose3_Q's third and fourth).
template <typename T> struct Coeffs { T A, B, C, D, Q3, Q4; };

// Only the selected branch is evaluated (the reference's where() evaluates
// both and selects; the selected values are the same). `mask`: the lanes of
// the live combos, all of which call this.
template <typename T>
__device__ __forceinline__ Coeffs<T> coeffs(T theta2, unsigned mask) {
  const T t4 = theta2 * theta2;
  const bool small = theta2 < Num<T>::small2();
  const unsigned small_lanes = __ballot_sync(mask, small);
  Coeffs<T> k;
  if (small) {
    const T num[12] = {theta2, t4, theta2, t4, theta2, t4,
                       theta2, t4, theta2, t4, theta2, t4};
    const T den[12] = {T(6), T(120), T(24), T(720), T(120), T(5040),
                       T(720), T(30240), T(720), T(40320), T(1260), T(60480)};
    T q[12];
    divide(num, den, q, small_lanes);
    k.A = T(1) - q[0] + q[1];
    k.B = T(0.5) - q[2] + q[3];
    k.C = T(1) / T(6) - q[4] + q[5];
    k.D = T(1) / T(12) + q[6] + q[7];
    k.Q3 = T(-1) / T(24) + q[8] - q[9];
    k.Q4 = T(-1) / T(60) + q[10] - q[11];
  } else {
    const T theta = Num<T>::sqrt_(theta2);
    T s, c;
    Num<T>::sincos_(theta, &s, &c);
    const T t3 = theta2 * theta, t5 = t4 * theta;
    const T num[7] = {s, T(1) - c, theta - s, T(1), T(1) + c, T(1) - T(0.5) * theta2 - c, t3};
    const T den[7] = {theta, theta2, t3, theta2, T(2) * theta * s, t4, T(6)};
    T q[7];
    divide(num, den, q, mask & ~small_lanes);
    k.A = q[0];
    k.B = q[1];
    k.C = q[2];
    k.D = q[3] - q[4];
    k.Q3 = q[5];
    k.Q4 = k.Q3 - T(3) * (theta - s - q[6]) / t5;
  }
  return k;
}

// I + a hat(w) + b W2, where W2 = hat(w)^2 (the same bits for w and -w):
// exp_so3 is (A, B), jl_so3 (B, C), jl_so3_inv (-1/2, D)
template <typename T>
__device__ __forceinline__ M3<T> so3_series(const V3<T>& w, const M3<T>& W2, T a, T b) {
  return madd(madd(eye3<T>(), mscale(a, hat(w))), mscale(b, W2));
}

// branchless Shepperd quaternion + series-safe log (ops/lie.py:85-137);
// `mask` as for coeffs
template <typename T>
__device__ __forceinline__ V3<T> log_so3(const M3<T>& R, unsigned mask) {
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
  const T a = m21 - m12, b = m02 - m20, e = m10 - m01;  // the antisymmetric part
  const T f = m01 + m10, g = m02 + m20, h = m12 + m21;  // the symmetric part
  const T num[4] = {idx == 0 ? p0 : idx == 1 ? a : idx == 2 ? b : e,
                    idx == 0 ? a : idx == 1 ? p1 : idx == 2 ? f : g,
                    idx == 0 ? b : idx == 1 ? f : idx == 2 ? p2 : h,
                    idx == 0 ? e : idx == 1 ? g : idx == 2 ? h : p3};
  const T dd[4] = {d, d, d, d};
  T q[4];
  divide(num, dd, q, mask);
  const T norm = Num<T>::sqrt_(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const T nn[4] = {norm, norm, norm, norm};
  T qn[4];
  divide(q, nn, qn, mask);
  const T sgn = (qn[0] < T(0)) ? T(-1) : T(1);  // canonicalize to w >= 0
  const T w = sgn * qn[0];
  const V3<T> v{{sgn * qn[1], sgn * qn[2], sgn * qn[3]}};
  const T nv2 = dot3(v, v);
  const bool small = nv2 < Num<T>::small2() * T(0.25);
  const unsigned small_lanes = __ballot_sync(mask, small);
  T factor;
  if (small) {
    const T w_safe = w > T(1e-3) ? w : T(1e-3);
    const T fn[2] = {T(2), nv2}, fd[2] = {w_safe, T(3) * w_safe * w_safe};
    T fq[2];
    divide(fn, fd, fq, small_lanes);
    factor = fq[0] * (T(1) - fq[1]);
  } else {
    const T nv = Num<T>::sqrt_(nv2);
    factor = T(2) * Num<T>::atan2_(nv, w) / nv;
  }
  return V3<T>{{factor * v.v[0], factor * v.v[1], factor * v.v[2]}};
}

// Barfoot's Q coupling block (ops/lie.py:270-321); k = coeffs(|w|^2)
template <typename T>
__device__ __forceinline__ M3<T> pose3_Q(const V3<T>& rho, const V3<T>& w, const Coeffs<T>& k) {
  const M3<T> X = hat(w), Y = hat(rho);
  const M3<T> XY = mm(X, Y), YX = mm(Y, X);
  const M3<T> XYX = mm(X, YX);
  M3<T> out = mscale(T(0.5), Y);
  out = madd(out, mscale(k.C, madd(madd(XY, YX), XYX)));
  out = madd(out, mscale(-k.Q3, madd(madd(mm(X, XY), mm(YX, X)), mscale(T(-3), XYX))));
  out = madd(out, mscale(T(-0.5) * k.Q4, madd(mm(XYX, X), mm(X, XYX))));
  return out;
}

// ---- shared memory of one block ----

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Per-combo fields, stored field-major with a row of kCombos + 1 combos.
enum Field : int {
  F_R1 = 0, F_t1 = 9, F_R2 = 12, F_t2 = 21, F_v1 = 24, F_v2 = 30,
  F_ta = 36, F_tb = 37, F_tq = 38,
  F_JriQ = 39, F_Re = 48, F_adjEQ = 57,                 // stage 2 -> 3
  F_JrQ = 66, F_JrP = 75, F_Rei = 84, F_AdQ = 93,       // stage 3 -> 4
  F_MP = 102, F_MQ = 111, F_NP = 120, F_NQ = 129,
  F_a12 = 138, F_p11 = 139, F_p12 = 140,               // stage 2 -> 3
  kFields = 141,
};
// Output staging, combo-major in the output's own layout: Twb (16), Tbw (16),
// Q (144), at a stride of 180 values (16-byte aligned, and 8 lanes writing
// one entry each hit 8 different banks).
constexpr int kStageTwb = 0, kStageTbw = 16, kStageQ = 32, kStageLd = 180;

constexpr int kLd = kCombos + 1;
constexpr int kFieldsSize = (kFields * kLd + 3) / 4 * 4;  // keeps the staging 16-byte aligned

template <typename T>
struct Smem {
  T* f;      // kFields rows of kLd
  T* stage;  // kCombos rows of kStageLd, 16-byte aligned
  static constexpr int ld = kLd;
  __device__ T& at(int field, int c) const { return f[field * ld + c]; }
  __device__ M3<T> m3(int field, int c) const {
    M3<T> o;
#pragma unroll
    for (int k = 0; k < 9; ++k) o.m[k] = at(field + k, c);
    return o;
  }
  __device__ V3<T> v3(int field, int c) const {
    return V3<T>{{at(field, c), at(field + 1, c), at(field + 2, c)}};
  }
  __device__ void put(int field, int c, const M3<T>& a) const {
#pragma unroll
    for (int k = 0; k < 9; ++k) at(field + k, c) = a.m[k];
  }
  __device__ T* staged(int c) const { return stage + c * kStageLd; }
};

// One endpoint of every combo: a (T, v, time) table and a row per combo.
template <typename T>
struct End {
  const T* T_;
  const T* v;
  const T* time;
  const long long* idx;  // nullptr: row = s * step
  long long step;
  long long n;
};

// The row of combo s; an index outside the table sets `bad` (and reads row 0).
template <typename T>
__device__ __forceinline__ long long end_row(const End<T>& e, long long s, bool& bad) {
  if (e.idx == nullptr) return s * e.step;
  const long long r = e.idx[s];
  const bool out = r < 0 || r >= e.n;
  bad |= out;
  return out ? 0 : r;
}

// The block's inputs into shared memory. Per combo 39 values: the (R|t) rows
// of both endpoints (12 each, read by consecutive threads), their twists (6
// each), their times and the query time. A thread first finds all its
// addresses (the index loads overlap; one trap for any index out of range),
// then issues all its loads, then all its shared-memory stores, so that the
// loads' latencies overlap.
constexpr int kInputs = 39;

template <typename T>
__device__ __forceinline__ void load_inputs(const Smem<T>& sm, const End<T>& e1,
                                            const End<T>& e2, const T* __restrict__ tq,
                                            long long s0, int nc) {
  constexpr int kPer = (kInputs * kCombos + kThreads - 1) / kThreads;
  const T* srcs[kPer];
  int dst[kPer];
  bool bad = false;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    int k = threadIdx.x + u * kThreads;
    dst[u] = -1;
    if (k >= kInputs * nc) continue;
    int c, field;
    const T* src;
    if (k < 24 * nc) {  // (R|t), row-major 3x4
      const bool second = k >= 12 * nc;
      const End<T> e = second ? e2 : e1;
      k -= second ? 12 * nc : 0;
      c = k / 12;
      const int j = k - 12 * c, r = j >> 2, col = j & 3;
      src = e.T_ + 16 * end_row(e, s0 + c, bad) + j;
      field = col == 3 ? (second ? F_t2 : F_t1) + r : (second ? F_R2 : F_R1) + 3 * r + col;
    } else if (k < 36 * nc) {  // v
      k -= 24 * nc;
      const bool second = k >= 6 * nc;
      const End<T> e = second ? e2 : e1;
      k -= second ? 6 * nc : 0;
      c = k / 6;
      const int j = k - 6 * c;
      src = e.v + 6 * end_row(e, s0 + c, bad) + j;
      field = (second ? F_v2 : F_v1) + j;
    } else if (k < 38 * nc) {  // endpoint times
      k -= 36 * nc;
      const bool second = k >= nc;
      const End<T> e = second ? e2 : e1;
      c = second ? k - nc : k;
      src = e.time + end_row(e, s0 + c, bad);
      field = second ? F_tb : F_ta;
    } else {  // query time
      c = k - 38 * nc;
      src = tq + s0 + c;
      field = F_tq;
    }
    srcs[u] = src;
    dst[u] = field * sm.ld + c;
  }
  if (bad) __trap();
  T val[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (dst[u] >= 0) val[u] = *srcs[u];
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (dst[u] >= 0) sm.f[dst[u]] = val[u];
}

// (R|t) as a 4x4 with the last row [0 0 0 1]
template <typename T>
__device__ __forceinline__ void stage_pose(T* st, const M3<T>& R, const V3<T>& t) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    st[4 * r + 0] = R.m[3 * r + 0];
    st[4 * r + 1] = R.m[3 * r + 1];
    st[4 * r + 2] = R.m[3 * r + 2];
    st[4 * r + 3] = t.v[r];
  }
  st[12] = T(0); st[13] = T(0); st[14] = T(0); st[15] = T(1);
}

// Q block b = [[P, Qb], [0, P]] into columns 6b..6b+5 of the 6x24 Q
template <typename T>
__device__ __forceinline__ void stage_block(T* st, int b, const M3<T>& P, const M3<T>& Qb) {
  T* q = st + kStageQ + 6 * b;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      q[24 * r + j] = P.m[3 * r + j];
      q[24 * r + 3 + j] = Qb.m[3 * r + j];
      q[24 * (3 + r) + j] = T(0);
      q[24 * (3 + r) + 3 + j] = P.m[3 * r + j];
    }
}

// 16 bytes: the unit of the copy-out
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// n values per combo from the staging area (offset `from`) to `dst`, the
// group's contiguous span, 16 bytes a thread per step
template <typename T>
__device__ __forceinline__ void copy_out(const Smem<T>& sm, int from, int n, T* dst, int nc) {
  using V = typename Vec16<T>::type;
  constexpr int kV = 16 / sizeof(T);
  const int per = n / kV;
  for (int k = threadIdx.x; k < nc * per; k += kThreads) {
    const int c = k / per, j = k - per * c;
    reinterpret_cast<V*>(dst)[k] = reinterpret_cast<const V*>(sm.staged(c) + from)[j];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_kernel(End<T> e1, End<T> e2, const T* __restrict__ tq, T* __restrict__ out, int S) {
  __shared__ __align__(16) T smem[kFieldsSize + kStageLd * kCombos];
  const Smem<T> sm{smem, smem + kFieldsSize};
  const long long s0 = static_cast<long long>(blockIdx.x) * kCombos;
  const int nc = static_cast<int>(S - s0 < kCombos ? S - s0 : kCombos);
  const int warp = threadIdx.x >> 5;
  const int c = (threadIdx.x & 31) % kCombos;  // this lane's combo in the group
  const bool live = c < nc;
  const unsigned mask = 0x01010101u * ((1u << nc) - 1u);  // the live combos' lanes

  load_inputs(sm, e1, e2, tq, s0, nc);
  __syncthreads();

  // ---- stage 1 (every warp): the relative pose, its log and Jr^-1 blocks ----
  V3<T> w12{}, rho12{}, mw12{};
  M3<T> W2{}, Ji{};
  Coeffs<T> k12{};
  if (live) {
    const M3<T> R1T = mT(sm.m3(F_R1, c));
    const M3<T> R12 = mm(R1T, sm.m3(F_R2, c));
    const V3<T> t12 = mv(R1T, vadd(sm.v3(F_t2, c), neg(sm.v3(F_t1, c))));
    w12 = log_so3(R12, mask);
    mw12 = neg(w12);
    k12 = coeffs(dot3(w12, w12), mask);
    W2 = mm(hat(w12), hat(w12));
    rho12 = mv(so3_series(w12, W2, T(-0.5), k12.D), t12);
    Ji = so3_series(mw12, W2, T(-0.5), k12.D);  // Jr^-1(xi12) = [[Ji, JriQ], [0, Ji]]
  }

  // ---- stage 2: the coupling block of Jr^-1(xi12) | Ad(T12)^-1 ----
  if (live && warp == 0) {
    const M3<T> Qc = pose3_Q(neg(rho12), mw12, k12);
    sm.put(F_JriQ, c, mscale(T(-1), mm(mm(Ji, Qc), Ji)));
  } else if (live && warp == 1) {
    const M3<T> Re = so3_series(mw12, W2, k12.A, k12.B);  // exp(-xi12)
    const V3<T> te = mv(so3_series(mw12, W2, k12.B, k12.C), neg(rho12));
    sm.put(F_Re, c, Re);
    sm.put(F_adjEQ, c, mm(hat(te), Re));
  } else if (live && warp == 2) {  // the Hermite coefficients (times only)
    const T tt1 = sm.at(F_ta, c), tt2 = sm.at(F_tb, c), tt = sm.at(F_tq, c);
    const T dt = tt2 - tt1;
    const T s = (tt - tt1) / dt;
    const T s2 = s * s;
    sm.at(F_a12, c) = dt * s * (T(1) - s) * (T(1) - s);
    sm.at(F_p11, c) = s2 * (T(3) - T(2) * s);
    sm.at(F_p12, c) = dt * s2 * (s - T(1));
  }
  __syncthreads();

  // ---- stage 3 (every warp: nu2, dxi): the branches of dxi, and A1/B1/B2 ----
  M3<T> JriQ{};
  V3<T> dr{}, dw{};
  T a12 = T(0), p11 = T(0), p12 = T(0);
  Coeffs<T> kd{};
  M3<T> Wd2{};
  if (live) {
    JriQ = sm.m3(F_JriQ, c);
    const V3<T> v2r = sm.v3(F_v2, c), v2w = sm.v3(F_v2 + 3, c);
    const V3<T> nu2r = vadd(mv(Ji, v2r), mv(JriQ, v2w));
    const V3<T> nu2w = mv(Ji, v2w);
    a12 = sm.at(F_a12, c);
    p11 = sm.at(F_p11, c);
    p12 = sm.at(F_p12, c);
    const V3<T> v1r = sm.v3(F_v1, c), v1w = sm.v3(F_v1 + 3, c);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      dr.v[k] = a12 * v1r.v[k] + p11 * rho12.v[k] + p12 * nu2r.v[k];
      dw.v[k] = a12 * v1w.v[k] + p11 * w12.v[k] + p12 * nu2w.v[k];
    }
    kd = coeffs(dot3(dw, dw), mask);
    Wd2 = mm(hat(dw), hat(dw));
  }
  if (live && warp == 0) {
    sm.put(F_JrQ, c, pose3_Q(neg(dr), neg(dw), kd));  // Jr(dxi) = [[JrP, JrQ], [0, JrP]]
  } else if (live && warp == 1) {
    const V3<T> mdw = neg(dw);
    const M3<T> Rei = so3_series(mdw, Wd2, kd.A, kd.B);  // exp(-dxi)
    const M3<T> JrP = so3_series(mdw, Wd2, kd.B, kd.C);  // Jl(-dw) = Jr(dw)
    const V3<T> tei = mv(JrP, neg(dr));
    sm.put(F_Rei, c, Rei);
    sm.put(F_AdQ, c, mm(hat(tei), Rei));  // Ad(dT^-1) = [[Rei, AdQ], [0, Rei]]
    sm.put(F_JrP, c, JrP);
  } else if (live && warp == 2) {
    const M3<T> Rd = so3_series(dw, Wd2, kd.A, kd.B);
    const V3<T> td = mv(so3_series(dw, Wd2, kd.B, kd.C), dr);
    const M3<T> R1 = sm.m3(F_R1, c);
    const M3<T> Rw = mm(R1, Rd);
    const V3<T> tw = vadd(mv(R1, td), sm.v3(F_t1, c));
    const M3<T> RwT = mT(Rw);
    T* st = sm.staged(c);
    stage_pose(st + kStageTwb, Rw, tw);
    stage_pose(st + kStageTbw, RwT, neg(mv(RwT, tw)));
    // B2 = -1/2 ad(v2) Jr^-1;  M = p11 Jr^-1 + p12 B2
    const M3<T> Hw = hat(sm.v3(F_v2 + 3, c)), Hr = hat(sm.v3(F_v2, c));
    const M3<T> B2P = mscale(T(-0.5), mm(Hw, Ji));
    const M3<T> B2Q = mscale(T(-0.5), madd(mm(Hw, JriQ), mm(Hr, Ji)));
    sm.put(F_MP, c, madd(mscale(p11, Ji), mscale(p12, B2P)));
    sm.put(F_MQ, c, madd(mscale(p11, JriQ), mscale(p12, B2Q)));
  } else if (live && warp == 3) {
    // A1 = -Jr^-1 Ad(T12)^-1;  B1 = -1/2 ad(v2) A1;  N = p11 A1 + p12 B1
    const M3<T> Re = sm.m3(F_Re, c);
    const M3<T> A1P = mscale(T(-1), mm(Ji, Re));
    const M3<T> A1Q = mscale(T(-1), madd(mm(Ji, sm.m3(F_adjEQ, c)), mm(JriQ, Re)));
    const M3<T> Hw = hat(sm.v3(F_v2 + 3, c)), Hr = hat(sm.v3(F_v2, c));
    const M3<T> B1P = mscale(T(-0.5), mm(Hw, A1P));
    const M3<T> B1Q = mscale(T(-0.5), madd(mm(Hw, A1Q), mm(Hr, A1P)));
    sm.put(F_NP, c, madd(mscale(p11, A1P), mscale(p12, B1P)));
    sm.put(F_NQ, c, madd(mscale(p11, A1Q), mscale(p12, B1Q)));
  }
  __syncthreads();

  // ---- stage 4: one Q block per warp ----
  if (live) {
    const M3<T> JrP = sm.m3(F_JrP, c), JrQ = sm.m3(F_JrQ, c);
    T* st = sm.staged(c);
    if (warp == 0) {  // Q1 = Jr(dxi) N + Ad(dT^-1)
      const M3<T> NP = sm.m3(F_NP, c);
      stage_block(st, 0, madd(mm(JrP, NP), sm.m3(F_Rei, c)),
                  madd(madd(mm(JrP, sm.m3(F_NQ, c)), mm(JrQ, NP)), sm.m3(F_AdQ, c)));
    } else if (warp == 1) {  // Q2 = a12 Jr(dxi)
      stage_block(st, 1, mscale(a12, JrP), mscale(a12, JrQ));
    } else if (warp == 2) {  // Q3 = Jr(dxi) M
      const M3<T> MP = sm.m3(F_MP, c);
      stage_block(st, 2, mm(JrP, MP), madd(mm(JrP, sm.m3(F_MQ, c)), mm(JrQ, MP)));
    } else {  // Q4 = p12 Jr(dxi) Jr^-1
      stage_block(st, 3, mscale(p12, mm(JrP, Ji)),
                  mscale(p12, madd(mm(JrP, JriQ), mm(JrQ, Ji))));
    }
  }
  __syncthreads();

  // ---- the group's spans of Twb, Tbw and Q ----
  copy_out(sm, kStageTwb, 16, out + 16 * s0, nc);
  copy_out(sm, kStageTbw, 16, out + 16 * static_cast<long long>(S) + 16 * s0, nc);
  copy_out(sm, kStageQ, 144, out + 32 * static_cast<long long>(S) + 144 * s0, nc);
}

__global__ void empty_kernel() {}

template <typename T>
int launch(const void* T1, const void* v1, const void* t1, const void* i1, long long step1,
           long long n1, const void* T2, const void* v2, const void* t2, const void* i2,
           long long step2, long long n2, const void* t, void* out, int S, void* stream) {
  if (S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<unsigned long long>(out) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int blocks = (S + kCombos - 1) / kCombos;
  const End<T> e1{static_cast<const T*>(T1), static_cast<const T*>(v1),
                  static_cast<const T*>(t1), static_cast<const long long*>(i1), step1, n1};
  const End<T> e2{static_cast<const T*>(T2), static_cast<const T*>(v2),
                  static_cast<const T*>(t2), static_cast<const long long*>(i2), step2, n2};
  chain_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      e1, e2, static_cast<const T*>(t), static_cast<T*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int interp_chain_f32(const void* T1, const void* v1, const void* t1, const void* i1,
                     long long step1, long long n1, const void* T2, const void* v2,
                     const void* t2, const void* i2, long long step2, long long n2,
                     const void* t, void* out, int S, void* stream) {
  return launch<float>(T1, v1, t1, i1, step1, n1, T2, v2, t2, i2, step2, n2, t, out, S, stream);
}

int interp_chain_f64(const void* T1, const void* v1, const void* t1, const void* i1,
                     long long step1, long long n1, const void* T2, const void* v2,
                     const void* t2, const void* i2, long long step2, long long n2,
                     const void* t, void* out, int S, void* stream) {
  return launch<double>(T1, v1, t1, i1, step1, n1, T2, v2, t2, i2, step2, n2, t, out, S, stream);
}

// An empty kernel of the same block size: the floor that a launch reaches.
int interp_chain_empty(void* stream) {
  empty_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
