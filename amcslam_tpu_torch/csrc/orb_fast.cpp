// Native ORB extraction pipeline (the C++ host-runtime fast path of
// frontend/orb.py).
//
// The reference front-end (ORBextractor.cc:410-1160) is a hand-tuned C++
// pipeline: 8-level pyramid, per-cell FAST-9/16 with an initial/minimum
// threshold retry, quadtree redistribution (DistributeOctTree, :571),
// intensity-centroid orientation, 7x7 sigma-2 Gaussian blur, and
// rotated-BRIEF sampling. The Python rebuild in frontend/orb.py keeps the
// behavioral contract as vectorized NumPy; this extension is the same
// algorithm in C++ for production throughput (the NumPy path stays as the
// oracle and the no-toolchain fallback). CPython C-API on NumPy buffers,
// no pybind11 (Environment notes); the GIL is released around the compute.
//
// Exposed:
//   extract(img (H,W) uint8, n_levels, scale_factor, ini_th, min_th,
//           budgets (n_levels,) int32, pattern (256,4) int32,
//           patch_off (P,2) int32 /* (dy,dx) circular patch */)
//     -> (xy (N,2) float64 level-0 px, octave (N,) int32,
//         desc (N,32) uint8, angle (N,) float64)
//
// Rounding uses nearbyint (round-half-even) everywhere NumPy uses np.round,
// so outputs track the Python oracle bit-for-bit on integer-valued inputs.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cfenv>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

// Stage profiler (AMCSLAM_ORB_PROFILE=1): accumulated ms per stage,
// printed to stderr after each extract() call.
struct Prof {
  bool on = false;
  double ms[6] = {0, 0, 0, 0, 0, 0};  // resize fast nms quadtree blur brief
  static const char* names(int i) {
    static const char* n[6] = {"resize", "fast", "nms+cell", "quadtree",
                               "blur", "orient+brief"};
    return n[i];
  }
};
thread_local Prof g_prof;

struct StageTimer {
  int slot;
  std::chrono::steady_clock::time_point t0;
  explicit StageTimer(int s) : slot(s) {
    if (g_prof.on) t0 = std::chrono::steady_clock::now();
  }
  ~StageTimer() {
    if (g_prof.on)
      g_prof.ms[slot] +=
          std::chrono::duration<double, std::milli>(
              std::chrono::steady_clock::now() - t0)
              .count();
  }
};

constexpr int HALF_PATCH = 15;
constexpr int EDGE_THRESHOLD = 19;
constexpr int CELL_W = 35;

struct Buf {
  Py_buffer view{};
  bool ok = false;
  ~Buf() {
    if (ok) PyBuffer_Release(&view);
  }
  bool acquire(PyObject* obj, int flags = PyBUF_C_CONTIGUOUS) {
    if (PyObject_GetBuffer(obj, &view, flags) != 0) return false;
    ok = true;
    return true;
  }
};

// Bresenham circle of radius 3, clockwise from 12 o'clock (dx, dy).
constexpr int CIRCLE[16][2] = {
    {0, -3}, {1, -3}, {2, -2}, {3, -1}, {3, 0},   {3, 1},
    {2, 2},  {1, 3},  {0, 3},  {-1, 3}, {-2, 2},  {-3, 1},
    {-3, 0}, {-3, -1}, {-2, -2}, {-1, -3}};

// 65536-entry LUT: does any circular run of >= 9 consecutive set bits exist?
struct ArcLut {
  std::vector<uint8_t> lut;
  ArcLut() : lut(1 << 16) {
    for (uint32_t m = 0; m < (1u << 16); ++m) {
      uint32_t ext = (m << 16) | m;
      int run = 0, best = 0;
      for (int b = 0; b < 32; ++b) {
        run = (ext >> b) & 1 ? run + 1 : 0;
        best = std::max(best, run);
      }
      lut[m] = best >= 9;
    }
  }
};
const ArcLut ARC;

struct Image {
  std::vector<uint8_t> data;
  int h = 0, w = 0;
  uint8_t at(int y, int x) const { return data[(size_t)y * w + x]; }
};

// u8 -> f64 row conversion (SIMD where available)
inline void row_to_double(const uint8_t* src, double* dst, int n) {
  int x = 0;
#if defined(__AVX2__)
  for (; x + 4 <= n; x += 4) {
    __m128i b = _mm_cvtsi32_si128(*(const int32_t*)(src + x));
    _mm256_storeu_pd(dst + x, _mm256_cvtepi32_pd(_mm_cvtepu8_epi32(b)));
  }
#endif
  for (; x < n; ++x) dst[x] = src[x];
}

#if defined(__AVX2__)
// round-half-even, clip to [0,255], store 4 u8 — per-lane identical to the
// scalar nearbyint/min/max/cast sequence (default rounding mode)
inline void store4_u8(uint8_t* dst, __m256d v) {
  v = _mm256_round_pd(v, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
  v = _mm256_min_pd(_mm256_max_pd(v, _mm256_setzero_pd()),
                    _mm256_set1_pd(255.0));
  __m128i i32 = _mm256_cvtpd_epi32(v);
  __m128i i16 = _mm_packus_epi32(i32, i32);
  __m128i i8 = _mm_packus_epi16(i16, i16);
  *(int32_t*)dst = _mm_cvtsi128_si32(i8);
}
#endif

void resize_bilinear(const uint8_t* src, int H, int W, Image& out, int h,
                     int w) {
  out.h = h;
  out.w = w;
  out.data.resize((size_t)h * w);
  std::vector<int> y0(h), y1(h), x0(w), x1(w);
  std::vector<double> fy(h), fx(w);
  // fy/fx = clip(coord - clipped_floor, 0, 1), matching _resize_bilinear
  for (int i = 0; i < h; ++i) {
    double ys = (i + 0.5) * (double)H / h - 0.5;
    int a = (int)std::floor(ys);
    y0[i] = std::min(std::max(a, 0), H - 1);
    y1[i] = std::min(std::max(a + 1, 0), H - 1);
    fy[i] = std::min(std::max(ys - y0[i], 0.0), 1.0);
  }
  for (int j = 0; j < w; ++j) {
    double xs = (j + 0.5) * (double)W / w - 0.5;
    int a = (int)std::floor(xs);
    x0[j] = std::min(std::max(a, 0), W - 1);
    x1[j] = std::min(std::max(a + 1, 0), W - 1);
    fx[j] = std::min(std::max(xs - x0[j], 0.0), 1.0);
  }
#if defined(__AVX2__)
  // gather path: convert the two source rows to f64 once per output row,
  // then 4-wide gathers; term order matches the scalar/oracle expression
  // exactly (mul-then-add, left to right), so results are bit-identical.
  std::vector<int64_t> x0l(w), x1l(w);
  for (int j = 0; j < w; ++j) {
    x0l[j] = x0[j];
    x1l[j] = x1[j];
  }
  std::vector<double> r0d(W), r1d(W);
  int cached0 = -1, cached1 = -1;
  const __m256d vone = _mm256_set1_pd(1.0);
  for (int i = 0; i < h; ++i) {
    if (y0[i] != cached0) {
      row_to_double(src + (size_t)y0[i] * W, r0d.data(), W);
      cached0 = y0[i];
    }
    if (y1[i] != cached1) {
      if (y1[i] == y0[i])
        std::copy(r0d.begin(), r0d.end(), r1d.begin());
      else
        row_to_double(src + (size_t)y1[i] * W, r1d.data(), W);
      cached1 = y1[i];
    }
    double wy = fy[i];
    const __m256d vwy = _mm256_set1_pd(wy);
    const __m256d vowy = _mm256_set1_pd(1.0 - wy);
    uint8_t* dst = &out.data[(size_t)i * w];
    int j = 0;
    for (; j + 4 <= w; j += 4) {
      __m256i i0 = _mm256_loadu_si256((const __m256i*)(x0l.data() + j));
      __m256i i1 = _mm256_loadu_si256((const __m256i*)(x1l.data() + j));
      __m256d a00 = _mm256_i64gather_pd(r0d.data(), i0, 8);
      __m256d a01 = _mm256_i64gather_pd(r0d.data(), i1, 8);
      __m256d a10 = _mm256_i64gather_pd(r1d.data(), i0, 8);
      __m256d a11 = _mm256_i64gather_pd(r1d.data(), i1, 8);
      __m256d fxv = _mm256_loadu_pd(fx.data() + j);
      __m256d ofx = _mm256_sub_pd(vone, fxv);
      __m256d v = _mm256_mul_pd(_mm256_mul_pd(a00, vowy), ofx);
      v = _mm256_add_pd(v, _mm256_mul_pd(_mm256_mul_pd(a01, vowy), fxv));
      v = _mm256_add_pd(v, _mm256_mul_pd(_mm256_mul_pd(a10, vwy), ofx));
      v = _mm256_add_pd(v, _mm256_mul_pd(_mm256_mul_pd(a11, vwy), fxv));
      store4_u8(dst + j, v);
    }
    for (; j < w; ++j) {
      double v = r0d[x0[j]] * (1 - wy) * (1 - fx[j]) +
                 r0d[x1[j]] * (1 - wy) * fx[j] +
                 r1d[x0[j]] * wy * (1 - fx[j]) + r1d[x1[j]] * wy * fx[j];
      v = std::nearbyint(v);
      dst[j] = (uint8_t)std::min(std::max(v, 0.0), 255.0);
    }
  }
#else
  for (int i = 0; i < h; ++i) {
    const uint8_t* r0 = src + (size_t)y0[i] * W;
    const uint8_t* r1 = src + (size_t)y1[i] * W;
    double wy = fy[i];
    uint8_t* dst = &out.data[(size_t)i * w];
    for (int j = 0; j < w; ++j) {
      double v = r0[x0[j]] * (1 - wy) * (1 - fx[j]) +
                 r0[x1[j]] * (1 - wy) * fx[j] +
                 r1[x0[j]] * wy * (1 - fx[j]) + r1[x1[j]] * wy * fx[j];
      v = std::nearbyint(v);
      dst[j] = (uint8_t)std::min(std::max(v, 0.0), 255.0);
    }
  }
#endif
}

// Scalar full FAST test at one pixel: (is_corner, score at min_th).
// score = sum of |d|-min_th over samples with |d| > min_th, as the Python
// oracle computes it.
inline bool fast_full_test(const uint8_t* p, const std::ptrdiff_t* off,
                           int th, int32_t* resp_out, int min_th) {
  int c = *p;
  int d[16];
  uint32_t mb = 0, md = 0;
  for (int k = 0; k < 16; ++k) {
    d[k] = p[off[k]] - c;
    if (d[k] > th) mb |= 1u << k;
    if (d[k] < -th) md |= 1u << k;
  }
  if (resp_out) {
    int resp = 0;
    for (int k = 0; k < 16; ++k) {
      int a = std::abs(d[k]);
      if (a > min_th) resp += a - min_th;
    }
    *resp_out = resp;
  }
  return ARC.lut[mb] || ARC.lut[md];
}

// FAST-9/16 corner scan at min_th. Emits the masked score map (score at
// corner pixels, 0 elsewhere — exactly np.where(ok_min, score, 0)) and the
// raster-ordered corner list. The ini_th re-test happens per NMS survivor
// in the caller (ok_ini is only ever read there).
//
// The AVX2 path is branchless run counting: for each of 25 circle samples
// (16 + 9 - 1, covering every circular arc), run = cond ? run+1 : 0 and
// best = max(best, run), for bright and dark conditions on 32 pixels at a
// time. best >= 9 is bit-for-bit the same decision as the 65536-entry
// circular-run LUT used by the scalar path and the Python oracle.
void fast_detect_scan(const Image& im, int min_th,
                      std::vector<int32_t>& score,
                      std::vector<int32_t>& cand) {
  int H = im.h, W = im.w;
  score.assign((size_t)H * W, 0);
  cand.clear();
  if (H <= 6 || W <= 6) return;
  std::ptrdiff_t off[16];
  for (int k = 0; k < 16; ++k)
    off[k] = (std::ptrdiff_t)CIRCLE[k][1] * W + CIRCLE[k][0];
  const uint8_t* base = im.data.data();
#if defined(__AVX2__)
  if (W >= 40) {
    const __m256i vth = _mm256_set1_epi8((char)min_th);
    const __m256i vone = _mm256_set1_epi8(1);
    const __m256i veight = _mm256_set1_epi8(8);
    const __m256i vzero = _mm256_setzero_si256();
    for (int y = 3; y < H - 3; ++y) {
      const uint8_t* row = base + (size_t)y * W;
      int x = 3;
      while (x <= W - 4) {
        // clamp the tail chunk so loads stay within [3, W-4]
        if (x + 31 > W - 4) x = W - 4 - 31;
        const uint8_t* p = row + x;
        __m256i c = _mm256_loadu_si256((const __m256i*)p);
        __m256i cb = _mm256_adds_epu8(c, vth);   // brighter if px > cb
        __m256i cd = _mm256_subs_epu8(c, vth);   // darker  if px < cd
        // compass prescreen: a 9-run covers >= 2 of samples {0,4,8,12}
        // (they are 4 apart), so chunks where no pixel has 2 bright or 2
        // dark compass exceedances cannot contain a corner. Masks are
        // 0xFF == -1; the byte sum is -count.
        {
          __m256i sb = vzero, sd = vzero;
          for (int k = 0; k < 16; k += 4) {
            __m256i s = _mm256_loadu_si256((const __m256i*)(p + off[k]));
            sb = _mm256_add_epi8(
                sb, _mm256_cmpeq_epi8(_mm256_subs_epu8(s, cb), vzero));
            sd = _mm256_add_epi8(
                sd, _mm256_cmpeq_epi8(_mm256_subs_epu8(cd, s), vzero));
          }
          // cmpeq gives "not exceeding": count_exceed = 4 + sum. Pass if
          // count_exceed >= 2  <=>  sum >= -2  <=>  sum > -3.
          __m256i pass = _mm256_or_si256(
              _mm256_cmpgt_epi8(sb, _mm256_set1_epi8(-3)),
              _mm256_cmpgt_epi8(sd, _mm256_set1_epi8(-3)));
          if (_mm256_movemask_epi8(pass) == 0) {
            x += 32;
            continue;
          }
        }
        // stage-2 prescreen: a contiguous 9-arc covers at least 4 of the 8
        // even circle samples {0,2,...,14}, so require >= 4 bright or >= 4
        // dark even-sample exceedances before the 25-step run loop
        {
          __m256i sb = vzero, sd = vzero;
          for (int k = 0; k < 16; k += 2) {
            __m256i s = _mm256_loadu_si256((const __m256i*)(p + off[k]));
            sb = _mm256_add_epi8(
                sb, _mm256_cmpeq_epi8(_mm256_subs_epu8(s, cb), vzero));
            sd = _mm256_add_epi8(
                sd, _mm256_cmpeq_epi8(_mm256_subs_epu8(cd, s), vzero));
          }
          // count_exceed = 8 + sum (masks are -1); pass if >= 4 <=> sum > -5
          __m256i pass = _mm256_or_si256(
              _mm256_cmpgt_epi8(sb, _mm256_set1_epi8(-5)),
              _mm256_cmpgt_epi8(sd, _mm256_set1_epi8(-5)));
          if (_mm256_movemask_epi8(pass) == 0) {
            x += 32;
            continue;
          }
        }
        __m256i run_b = vzero, best_b = vzero;
        __m256i run_d = vzero, best_d = vzero;
        for (int k = 0; k < 25; ++k) {
          __m256i s =
              _mm256_loadu_si256((const __m256i*)(p + off[k & 15]));
          // bright: s > cb  <=>  subs_epu8(s, cb) != 0
          __m256i mb = _mm256_xor_si256(
              _mm256_cmpeq_epi8(_mm256_subs_epu8(s, cb), vzero),
              _mm256_set1_epi8((char)0xFF));
          run_b = _mm256_and_si256(_mm256_adds_epu8(run_b, vone), mb);
          best_b = _mm256_max_epu8(best_b, run_b);
          // dark: s < cd  <=>  subs_epu8(cd, s) != 0
          __m256i md = _mm256_xor_si256(
              _mm256_cmpeq_epi8(_mm256_subs_epu8(cd, s), vzero),
              _mm256_set1_epi8((char)0xFF));
          run_d = _mm256_and_si256(_mm256_adds_epu8(run_d, vone), md);
          best_d = _mm256_max_epu8(best_d, run_d);
        }
        // corner where best >= 9 on either polarity
        __m256i ge9 = _mm256_or_si256(
            _mm256_xor_si256(
                _mm256_cmpeq_epi8(_mm256_subs_epu8(best_b, veight), vzero),
                _mm256_set1_epi8((char)0xFF)),
            _mm256_xor_si256(
                _mm256_cmpeq_epi8(_mm256_subs_epu8(best_d, veight), vzero),
                _mm256_set1_epi8((char)0xFF)));
        uint32_t mask = (uint32_t)_mm256_movemask_epi8(ge9);
        while (mask) {
          int bit = __builtin_ctz(mask);
          mask &= mask - 1;
          size_t idx = (size_t)y * W + (x + bit);
          if (score[idx]) continue;  // tail-chunk overlap already done
          int32_t resp;
          fast_full_test(p + bit, off, min_th, &resp, min_th);
          score[idx] = resp;
          cand.push_back((int32_t)idx);
        }
        x += 32;
      }
    }
    // tail-chunk overlap can emit candidates out of raster order within a
    // row; restore raster order (stable, indices are unique)
    std::sort(cand.begin(), cand.end());
    return;
  }
#endif
  for (int y = 3; y < H - 3; ++y) {
    const uint8_t* row = base + (size_t)y * W;
    for (int x = 3; x < W - 3; ++x) {
      const uint8_t* p = row + x;
      int c = *p;
      // compass-point early exit: any 9-contiguous arc contains one of
      // {0, 8} and at least two of {0, 4, 8, 12}
      int d0 = p[off[0]] - c, d8 = p[off[8]] - c;
      int d4 = p[off[4]] - c, d12 = p[off[12]] - c;
      int nb = (d0 > min_th) + (d4 > min_th) + (d8 > min_th) + (d12 > min_th);
      int nd = (d0 < -min_th) + (d4 < -min_th) + (d8 < -min_th) +
               (d12 < -min_th);
      if (nb < 2 && nd < 2) continue;
      int32_t resp;
      if (!fast_full_test(p, off, min_th, &resp, min_th)) continue;
      size_t idx = (size_t)y * W + x;
      score[idx] = resp;
      cand.push_back((int32_t)idx);
    }
  }
}

struct Node {
  double x0, x1, y0, y1;
  std::vector<int> idx;
};

// DistributeOctTree semantics, matching frontend/orb.py distribute_quadtree.
std::vector<int> distribute_quadtree(const std::vector<double>& xs,
                                     const std::vector<double>& ys,
                                     const std::vector<int32_t>& resp,
                                     double min_x, double max_x, double min_y,
                                     double max_y, int budget) {
  int n = (int)xs.size();
  std::vector<int> out;
  if (n == 0) return out;
  if (n <= budget) {
    out.resize(n);
    for (int i = 0; i < n; ++i) out[i] = i;
    return out;
  }
  int n_ini = std::max(
      1, (int)std::nearbyint((max_x - min_x) / std::max(max_y - min_y, 1.0)));
  double hx = (max_x - min_x) / n_ini;
  std::vector<Node> nodes;
  for (int i = 0; i < n_ini; ++i) {
    Node nd{min_x + i * hx, min_x + (i + 1) * hx, min_y, max_y, {}};
    for (int k = 0; k < n; ++k)
      if (xs[k] >= nd.x0 && xs[k] < nd.x1) nd.idx.push_back(k);
    if (!nd.idx.empty()) nodes.push_back(std::move(nd));
  }
  while (true) {
    std::vector<int> splittable;
    for (int i = 0; i < (int)nodes.size(); ++i)
      if (nodes[i].idx.size() > 1) splittable.push_back(i);
    if (splittable.empty() || (int)nodes.size() >= budget) break;
    // most populated first (stable for ties, like Python list.sort)
    std::stable_sort(splittable.begin(), splittable.end(), [&](int a, int b) {
      return nodes[a].idx.size() > nodes[b].idx.size();
    });
    std::vector<char> is_split(nodes.size(), 0);
    for (int i : splittable) is_split[i] = 1;
    std::vector<Node> next;
    for (int i = 0; i < (int)nodes.size(); ++i)
      if (!is_split[i]) next.push_back(nodes[i]);
    for (size_t done = 0; done < splittable.size(); ++done) {
      const Node& nd = nodes[splittable[done]];
      double xm = 0.5 * (nd.x0 + nd.x1), ym = 0.5 * (nd.y0 + nd.y1);
      const double q[4][4] = {{nd.x0, xm, nd.y0, ym},
                              {xm, nd.x1, nd.y0, ym},
                              {nd.x0, xm, ym, nd.y1},
                              {xm, nd.x1, ym, nd.y1}};
      for (auto& qq : q) {
        Node child{qq[0], qq[1], qq[2], qq[3], {}};
        for (int k : nd.idx)
          if (xs[k] >= qq[0] && xs[k] < qq[1] && ys[k] >= qq[2] &&
              ys[k] < qq[3])
            child.idx.push_back(k);
        if (!child.idx.empty()) next.push_back(std::move(child));
      }
      if ((int)next.size() >= budget) {
        for (size_t r = done + 1; r < splittable.size(); ++r)
          next.push_back(nodes[splittable[r]]);
        break;
      }
    }
    // no-progress sweep: keep the OLD node list (matches the Python
    // `if len(new_nodes) == len(nodes): break` before reassignment)
    if (next.size() == nodes.size()) break;
    nodes = std::move(next);
  }
  std::vector<int> picks;
  picks.reserve(nodes.size());
  for (auto& nd : nodes) {
    int best = nd.idx[0];
    for (int k : nd.idx)
      if (resp[k] > resp[best]) best = k;  // first max, like np.argmax
    picks.push_back(best);
  }
  if ((int)picks.size() > budget) {
    std::stable_sort(picks.begin(), picks.end(),
                     [&](int a, int b) { return resp[a] > resp[b]; });
    picks.resize(budget);
  }
  return picks;
}

// 7x7 sigma-2 separable Gaussian with reflect-101 borders. `row_need`
// marks the output rows actually sampled by descriptors (nullptr = all);
// unneeded rows are skipped — the blur is only consumed at keypoint
// patches, so this is exact for every sampled pixel.
void gaussian_blur7(const Image& im, Image& out,
                    const std::vector<uint8_t>* row_need = nullptr) {
  const int r = 3;
  double k[7], sum = 0;
  for (int i = -r; i <= r; ++i) {
    k[i + r] = std::exp(-0.5 * (i / 2.0) * (i / 2.0));
    sum += k[i + r];
  }
  for (int i = 0; i < 7; ++i) k[i] /= sum;
  int H = im.h, W = im.w;
  out.h = H;
  out.w = W;
  // +3 pad: the BRIEF 4-byte gathers may read up to 3 bytes past the last
  // sampled pixel
  out.data.assign((size_t)H * W + 3, 0);
  auto refl = [](int i, int n) {  // reflect-101 (np.pad mode="reflect")
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
    return i;
  };
  // tmp rows are needed at +-r around every output row
  std::vector<uint8_t> tmp_need;
  if (row_need) {
    tmp_need.assign(H, 0);
    for (int y = 0; y < H; ++y)
      if ((*row_need)[y])
        for (int i = -r; i <= r; ++i) tmp_need[refl(y + i, H)] = 1;
  }
  std::vector<double> tmp((size_t)H * W);
  std::vector<double> rowd(W);
  for (int y = 0; y < H; ++y) {
    if (row_need && !tmp_need[y]) continue;
    const uint8_t* row = &im.data[(size_t)y * W];
    row_to_double(row, rowd.data(), W);
    double* t = &tmp[(size_t)y * W];
    for (int x = 0; x < r; ++x) {
      double v = 0;
      for (int i = -r; i <= r; ++i) v += k[i + r] * rowd[refl(x + i, W)];
      t[x] = v;
    }
    int x = r;
#if defined(__AVX2__)
    // accumulation order per lane matches the scalar loop (k0*p0 + k1*p1
    // + ...), so every t[x] is bit-identical
    for (; x + 4 <= W - r; x += 4) {
      __m256d v = _mm256_mul_pd(_mm256_set1_pd(k[0]),
                                _mm256_loadu_pd(rowd.data() + x - r));
      for (int i = 1; i < 7; ++i)
        v = _mm256_add_pd(
            v, _mm256_mul_pd(_mm256_set1_pd(k[i]),
                             _mm256_loadu_pd(rowd.data() + x - r + i)));
      _mm256_storeu_pd(t + x, v);
    }
#endif
    for (; x < W - r; ++x) {
      double v = 0;
      for (int i = -r; i <= r; ++i) v += k[i + r] * rowd[x + i];
      t[x] = v;
    }
    for (x = W - r; x < W; ++x) {
      double v = 0;
      for (int i = -r; i <= r; ++i) v += k[i + r] * rowd[refl(x + i, W)];
      t[x] = v;
    }
  }
  for (int y = 0; y < H; ++y) {
    if (row_need && !(*row_need)[y]) continue;
    uint8_t* o = &out.data[(size_t)y * W];
    const double* rows[7];
    for (int i = -r; i <= r; ++i)
      rows[i + r] = &tmp[(size_t)refl(y + i, H) * W];
    int x = 0;
#if defined(__AVX2__)
    for (; x + 4 <= W; x += 4) {
      __m256d v = _mm256_mul_pd(_mm256_set1_pd(k[0]),
                                _mm256_loadu_pd(rows[0] + x));
      for (int i = 1; i < 7; ++i)
        v = _mm256_add_pd(v, _mm256_mul_pd(_mm256_set1_pd(k[i]),
                                           _mm256_loadu_pd(rows[i] + x)));
      store4_u8(o + x, v);
    }
#endif
    for (; x < W; ++x) {
      double v = 0;
      for (int i = 0; i < 7; ++i) v += k[i] * rows[i][x];
      v = std::nearbyint(v);
      o[x] = (uint8_t)std::min(std::max(v, 0.0), 255.0);
    }
  }
}

struct LevelOut {
  std::vector<double> xy;     // (n, 2) level-0 coords
  std::vector<int32_t> oct;   // (n,)
  std::vector<uint8_t> desc;  // (n, 32)
  std::vector<double> ang;    // (n,)
};

void extract_level(const Image& im, int lv, double scale, int ini_th,
                   int min_th, int budget, const int32_t* pattern,
                   const int32_t* patch_off, int n_patch, LevelOut& out) {
  int b = EDGE_THRESHOLD - 3;
  int H = im.h, W = im.w;
  if (H <= 2 * b || W <= 2 * b) return;
  std::vector<int32_t> score;
  std::vector<int32_t> fast_cand;
  {
    StageTimer st(1);
    fast_detect_scan(im, min_th, score, fast_cand);
  }

  // 3x3 NMS on score where ok_min (raster-order tie rules), inside border
  std::vector<double> cxs, cys;
  std::vector<int32_t> cresp;
  std::vector<uint8_t> cini;
  std::vector<int64_t> ccell;
  int cells_x = (W - 2 * b) / CELL_W + 1;
  std::ptrdiff_t coff[16];
  for (int k = 0; k < 16; ++k)
    coff[k] = (std::ptrdiff_t)CIRCLE[k][1] * W + CIRCLE[k][0];
  std::vector<double> xs, ys;
  std::vector<int32_t> resp;
  {
  StageTimer nms_t(2);
  // NMS over the masked score map, visiting corner pixels only (the map is
  // 0 at non-corners and corner scores are >= 9 > 0, so comparing against
  // the raw map entries is exactly _nms3(np.where(ok_min, score, 0))).
  // Corners live in [3, H-3) x [3, W-3) and b > 4, so every neighbor
  // access below is in-bounds.
  cxs.reserve(fast_cand.size() / 4);
  cys.reserve(fast_cand.size() / 4);
  cresp.reserve(fast_cand.size() / 4);
  cini.reserve(fast_cand.size() / 4);
  ccell.reserve(fast_cand.size() / 4);
  const int32_t* S = score.data();
  // fast_cand is sorted, so track the row incrementally (no div/mod)
  int y = 0;
  int32_t row_end = W;
  for (int32_t ci : fast_cand) {
    while (ci >= row_end) {
      ++y;
      row_end += W;
    }
    int x = (int)(ci - (row_end - W));
    if (y < b || y >= H - b || x < b || x >= W - b) continue;
    size_t idx = (size_t)ci;
    int32_t s = S[idx];
    if (!(s > S[idx - W - 1] && s > S[idx - W] && s > S[idx - W + 1] &&
          s > S[idx - 1] && s >= S[idx + 1] && s >= S[idx + W - 1] &&
          s >= S[idx + W] && s >= S[idx + W + 1]))
      continue;
    cxs.push_back(x);
    cys.push_back(y);
    cresp.push_back(s);
    // ini_th re-test at survivors only (ini corners are a subset of min
    // corners; the per-cell retry below is the only reader)
    cini.push_back(
        fast_full_test(im.data.data() + idx, coff, ini_th, nullptr, 0));
    ccell.push_back((int64_t)((y - b) / CELL_W) * cells_x + (x - b) / CELL_W);
  }
  if (cxs.empty()) return;
  // per-cell ini/min retry: keep ini corners, plus everything in cells
  // that have no ini corner
  int64_t max_cell = *std::max_element(ccell.begin(), ccell.end());
  std::vector<uint8_t> has_ini((size_t)max_cell + 1, 0);
  for (size_t i = 0; i < ccell.size(); ++i)
    if (cini[i]) has_ini[ccell[i]] = 1;
  for (size_t i = 0; i < ccell.size(); ++i) {
    if (cini[i] || !has_ini[ccell[i]]) {
      xs.push_back(cxs[i]);
      ys.push_back(cys[i]);
      resp.push_back(cresp[i]);
    }
  }
  }  // nms_t

  std::vector<int> keep;
  {
    StageTimer st(3);
    keep = distribute_quadtree(xs, ys, resp, b - 0.0, W - b + 0.0, b - 0.0,
                               H - b + 0.0, budget);
  }
  // NOTE: python passes (EDGE_THRESHOLD-3, w-EDGE_THRESHOLD+3) == (b, W-b)
  if (keep.empty()) return;

  // rotated-BRIEF reach: pattern offsets are clipped to +-(HALF_PATCH-1);
  // a rotation stretches them to at most sqrt(2)*(HALF_PATCH-1) ~ 19.8,
  // +0.5 for rounding -> 21 covers every sampled row
  const int REACH = 21;
  std::vector<uint8_t> row_need(H, 0);
  for (int k : keep) {
    int y = (int)ys[k];
    for (int dy = -REACH; dy <= REACH; ++dy) {
      int yy = std::min(std::max(y + dy, 0), H - 1);
      row_need[yy] = 1;
    }
  }
  Image blur;
  {
    StageTimer st(4);
    gaussian_blur7(im, blur, &row_need);
  }

  StageTimer brief_t(5);
  size_t n0 = out.oct.size();
  size_t n = keep.size();
  out.xy.resize(2 * (n0 + n));
  out.oct.resize(n0 + n);
  out.desc.resize(32 * (n0 + n));
  out.ang.resize(n0 + n);
#if defined(__AVX2__)
  // Orientation row tables: the circular patch offsets arrive row-major
  // (dy runs, dx contiguous), so each row becomes one 32-byte window
  // [-16, 15] around x with i8 weights (0 outside the circle). maddubs/madd
  // keep everything in exact integer arithmetic, so m01/m10 equal the
  // scalar double sums bit-for-bit (|m| <= ~2.7e6 << 2^53).
  struct OrientRow {
    alignas(32) int8_t w1[32];
    alignas(32) int8_t wdx[32];
    int dy;
  };
  std::vector<OrientRow> orows;
  {
    bool fits = true;
    int p = 0;
    while (p < n_patch && fits) {
      int dy = patch_off[2 * p];
      OrientRow rowt;
      rowt.dy = dy;
      std::memset(rowt.w1, 0, 32);
      std::memset(rowt.wdx, 0, 32);
      while (p < n_patch && patch_off[2 * p] == dy) {
        int dx = patch_off[2 * p + 1];
        if (dx < -16 || dx > 15 || dy < -16 || dy > 16 || rowt.w1[dx + 16]) {
          fits = false;  // not the expected compact row-major circle
          break;
        }
        rowt.w1[dx + 16] = 1;
        rowt.wdx[dx + 16] = (int8_t)dx;
        ++p;
      }
      orows.push_back(rowt);
    }
    if (!fits) orows.clear();  // scalar fallback
  }
  // SoA f64 pattern for the 4-wide BRIEF rotation
  std::vector<double> ppx1(256), ppy1(256), ppx2(256), ppy2(256);
  for (int p = 0; p < 256; ++p) {
    ppx1[p] = pattern[4 * p];
    ppy1[p] = pattern[4 * p + 1];
    ppx2[p] = pattern[4 * p + 2];
    ppy2[p] = pattern[4 * p + 3];
  }
#endif
  for (size_t i = 0; i < n; ++i) {
    int k = keep[i];
    int x = (int)xs[k], y = (int)ys[k];
    // intensity-centroid orientation over the circular patch
    double m01 = 0, m10 = 0;
#if defined(__AVX2__)
    if (!orows.empty() && y >= HALF_PATCH && y < H - HALF_PATCH && x >= 16 &&
        x < W - 16) {
      const uint8_t* ctr = &im.data[(size_t)y * W + x];
      const __m256i ones = _mm256_set1_epi16(1);
      __m256i acc10 = _mm256_setzero_si256();
      __m256i acc01 = _mm256_setzero_si256();
      for (const OrientRow& rowt : orows) {
        __m256i v = _mm256_loadu_si256(
            (const __m256i*)(ctr + (std::ptrdiff_t)rowt.dy * W - 16));
        __m256i t10 = _mm256_maddubs_epi16(
            v, _mm256_load_si256((const __m256i*)rowt.wdx));
        __m256i t01 = _mm256_maddubs_epi16(
            v, _mm256_load_si256((const __m256i*)rowt.w1));
        acc10 = _mm256_add_epi32(acc10, _mm256_madd_epi16(t10, ones));
        acc01 = _mm256_add_epi32(
            acc01, _mm256_madd_epi16(t01, _mm256_set1_epi16((short)rowt.dy)));
      }
      auto hsum = [](__m256i a) -> int32_t {
        __m128i s = _mm_add_epi32(_mm256_castsi256_si128(a),
                                  _mm256_extracti128_si256(a, 1));
        s = _mm_add_epi32(s, _mm_shuffle_epi32(s, 0x4E));
        s = _mm_add_epi32(s, _mm_shuffle_epi32(s, 0xB1));
        return _mm_cvtsi128_si32(s);
      };
      m10 = (double)hsum(acc10);
      m01 = (double)hsum(acc01);
    } else
#endif
    if (y >= HALF_PATCH && y < H - HALF_PATCH && x >= HALF_PATCH &&
        x < W - HALF_PATCH) {
      const uint8_t* ctr = &im.data[(size_t)y * W + x];
      for (int p = 0; p < n_patch; ++p) {
        int dy = patch_off[2 * p], dx = patch_off[2 * p + 1];
        double v = ctr[(std::ptrdiff_t)dy * W + dx];
        m01 += v * dy;
        m10 += v * dx;
      }
    } else {
      for (int p = 0; p < n_patch; ++p) {
        int dy = patch_off[2 * p], dx = patch_off[2 * p + 1];
        int yy = std::min(std::max(y + dy, 0), H - 1);
        int xx = std::min(std::max(x + dx, 0), W - 1);
        double v = im.at(yy, xx);
        m01 += v * dy;
        m10 += v * dx;
      }
    }
    double ang = std::atan2(m01, m10);
    double ca = std::cos(ang), sa = std::sin(ang);
    uint8_t* d = &out.desc[32 * (n0 + i)];
    std::memset(d, 0, 32);
    bool interior = y >= REACH && y < H - REACH && x >= REACH && x < W - REACH;
    const uint8_t* bc = &blur.data[(size_t)y * W + x];
#if defined(__AVX2__)
    if (interior) {
      // 4 pairs per step: rotate in f64 with the oracle's exact op order
      // (mul, mul, sub/add — no FMA), cvtpd rounds half-to-even like
      // np.round/lrint, then byte gathers off bc (blur is padded by 3 so
      // the 4-byte gather loads stay in-bounds at the image tail).
      const __m256d vca = _mm256_set1_pd(ca), vsa = _mm256_set1_pd(sa);
      const __m128i vW = _mm_set1_epi32(W);
      const __m128i vmask = _mm_set1_epi32(0xFF);
      const int* bci = (const int*)bc;
      for (int p = 0; p < 256; p += 4) {
        __m256d x1 = _mm256_loadu_pd(&ppx1[p]), y1 = _mm256_loadu_pd(&ppy1[p]);
        __m256d x2 = _mm256_loadu_pd(&ppx2[p]), y2 = _mm256_loadu_pd(&ppy2[p]);
        __m128i xr1 = _mm256_cvtpd_epi32(
            _mm256_sub_pd(_mm256_mul_pd(vca, x1), _mm256_mul_pd(vsa, y1)));
        __m128i yr1 = _mm256_cvtpd_epi32(
            _mm256_add_pd(_mm256_mul_pd(vsa, x1), _mm256_mul_pd(vca, y1)));
        __m128i xr2 = _mm256_cvtpd_epi32(
            _mm256_sub_pd(_mm256_mul_pd(vca, x2), _mm256_mul_pd(vsa, y2)));
        __m128i yr2 = _mm256_cvtpd_epi32(
            _mm256_add_pd(_mm256_mul_pd(vsa, x2), _mm256_mul_pd(vca, y2)));
        __m128i o1 = _mm_add_epi32(_mm_mullo_epi32(yr1, vW), xr1);
        __m128i o2 = _mm_add_epi32(_mm_mullo_epi32(yr2, vW), xr2);
        __m128i s1 = _mm_and_si128(_mm_i32gather_epi32(bci, o1, 1), vmask);
        __m128i s2 = _mm_and_si128(_mm_i32gather_epi32(bci, o2, 1), vmask);
        int m = _mm_movemask_ps(_mm_castsi128_ps(_mm_cmpgt_epi32(s2, s1)));
        // movemask bit j = pair p+j; packbits order is MSB-first
        d[p >> 3] |= (uint8_t)(((m & 1) << 7 | (m & 2) << 5 | (m & 4) << 3 |
                                (m & 8) << 1) >>
                               (p & 7));
      }
      out.xy[2 * (n0 + i)] = xs[k] * scale;
      out.xy[2 * (n0 + i) + 1] = ys[k] * scale;
      out.oct[n0 + i] = lv;
      out.ang[n0 + i] = ang;
      continue;
    }
#endif
    for (int p = 0; p < 256; ++p) {
      int px1 = pattern[4 * p], py1 = pattern[4 * p + 1];
      int px2 = pattern[4 * p + 2], py2 = pattern[4 * p + 3];
      uint8_t s1, s2;
      if (interior) {
        // lrint uses the current FP rounding mode (to-nearest-even, same
        // as np.round) and compiles to one cvtsd2si
        std::ptrdiff_t o1 = (std::ptrdiff_t)std::lrint(sa * px1 + ca * py1) * W
                            + std::lrint(ca * px1 - sa * py1);
        std::ptrdiff_t o2 = (std::ptrdiff_t)std::lrint(sa * px2 + ca * py2) * W
                            + std::lrint(ca * px2 - sa * py2);
        s1 = bc[o1];
        s2 = bc[o2];
      } else {
        auto sample = [&](int px, int py) -> uint8_t {
          int xr = (int)std::lrint(ca * px - sa * py);
          int yr = (int)std::lrint(sa * px + ca * py);
          int xx = std::min(std::max(x + xr, 0), W - 1);
          int yy = std::min(std::max(y + yr, 0), H - 1);
          return blur.at(yy, xx);
        };
        s1 = sample(px1, py1);
        s2 = sample(px2, py2);
      }
      if (s1 < s2)
        d[p >> 3] |= (uint8_t)(0x80u >> (p & 7));  // np.packbits bit order
    }
    out.xy[2 * (n0 + i)] = xs[k] * scale;
    out.xy[2 * (n0 + i) + 1] = ys[k] * scale;
    out.oct[n0 + i] = lv;
    out.ang[n0 + i] = ang;
  }
}

PyObject* py_extract(PyObject*, PyObject* args) {
  PyObject *img_o, *budgets_o, *pattern_o, *patch_o;
  int n_levels, ini_th, min_th;
  double scale_factor;
  if (!PyArg_ParseTuple(args, "OidiiOOO", &img_o, &n_levels, &scale_factor,
                        &ini_th, &min_th, &budgets_o, &pattern_o, &patch_o))
    return nullptr;
  Buf img_b, bud_b, pat_b, off_b;
  if (!img_b.acquire(img_o) || !bud_b.acquire(budgets_o) ||
      !pat_b.acquire(pattern_o) || !off_b.acquire(patch_o)) {
    PyErr_SetString(PyExc_TypeError, "expected contiguous buffers");
    return nullptr;
  }
  if (img_b.view.ndim != 2 || img_b.view.itemsize != 1) {
    PyErr_SetString(PyExc_TypeError, "img must be (H,W) uint8");
    return nullptr;
  }
  int H = (int)img_b.view.shape[0], W = (int)img_b.view.shape[1];
  const uint8_t* img = (const uint8_t*)img_b.view.buf;
  const int32_t* budgets = (const int32_t*)bud_b.view.buf;
  const int32_t* pattern = (const int32_t*)pat_b.view.buf;
  const int32_t* patch_off = (const int32_t*)off_b.view.buf;
  int n_patch = (int)off_b.view.shape[0];

  LevelOut out;
  Py_BEGIN_ALLOW_THREADS;
  {
    const char* prof_env = std::getenv("AMCSLAM_ORB_PROFILE");
    g_prof.on = prof_env && prof_env[0] && prof_env[0] != '0';
    if (g_prof.on) std::memset(g_prof.ms, 0, sizeof(g_prof.ms));
    for (int lv = 0; lv < n_levels; ++lv) {
      double s = std::pow(scale_factor, lv);
      Image level;
      if (lv == 0) {
        level.h = H;
        level.w = W;
        level.data.assign(img, img + (size_t)H * W);
      } else {
        StageTimer st(0);
        int h = std::max((int)std::nearbyint(H / s), 8);
        int w = std::max((int)std::nearbyint(W / s), 8);
        resize_bilinear(img, H, W, level, h, w);
      }
      extract_level(level, lv, s, ini_th, min_th, budgets[lv], pattern,
                    patch_off, n_patch, out);
    }
    if (g_prof.on) {
      std::fprintf(stderr, "[orb_fast]");
      for (int i = 0; i < 6; ++i)
        std::fprintf(stderr, " %s=%.1fms", Prof::names(i), g_prof.ms[i]);
      std::fprintf(stderr, "\n");
    }
  }
  Py_END_ALLOW_THREADS;

  size_t n = out.oct.size();
  PyObject* xy = PyBytes_FromStringAndSize((const char*)out.xy.data(),
                                           (Py_ssize_t)(n * 2 * 8));
  PyObject* oc = PyBytes_FromStringAndSize((const char*)out.oct.data(),
                                           (Py_ssize_t)(n * 4));
  PyObject* de = PyBytes_FromStringAndSize((const char*)out.desc.data(),
                                           (Py_ssize_t)(n * 32));
  PyObject* an = PyBytes_FromStringAndSize((const char*)out.ang.data(),
                                           (Py_ssize_t)(n * 8));
  PyObject* tup = PyTuple_Pack(4, xy, oc, de, an);
  Py_XDECREF(xy);
  Py_XDECREF(oc);
  Py_XDECREF(de);
  Py_XDECREF(an);
  return tup;
}

PyMethodDef methods[] = {
    {"extract", py_extract, METH_VARARGS,
     "Full ORB pyramid extraction; see module docstring."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_orb_fast",
                         "Native ORB extraction pipeline", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__orb_fast(void) { return PyModule_Create(&moduledef); }
