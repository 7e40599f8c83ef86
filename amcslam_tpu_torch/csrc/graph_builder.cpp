// Native SoA graph builder (the C++ runtime component of the framework).
//
// The reference's problem construction is C++ loops over observations
// (Optimizer.cc:86-304, :857-1214). The TPU rebuild keeps construction on
// the host but moves the per-observation hot loops out of Python: given the
// map in SoA form (concatenated keyframe match tables + landmark registry),
// emit the padded edge arrays consumed by the jitted solvers. This is a
// plain CPython C-API extension (no pybind11 in the image; Environment
// notes) operating on NumPy buffers.
//
// Exposed functions:
//   build_obs_edges(matches (sum_Nk,) int64,   // mp id per global kp, -1
//                   kf_of_kp (sum_Nk,) int32,  // owning KF slot per kp
//                   cam_of_kp (sum_Nk,) int32, // camera per kp
//                   prev_slot (K,) int32,      // temporal-prev slot or -1
//                   lm_slot_keys (M,) int64, lm_slot_vals (M,) int32,
//                   // sorted map: map-point id -> landmark slot
//                   n_stereo_cam int)
//     -> (mono (Em, 5) float64 rows [i, j, lm, cam, kp_index],
//         stereo (Es, 3) float64 rows [pose, lm, kp_index])
//
//   hamming_matrix(a (N,32) uint8, b (M,32) uint8) -> (N,M) int32
//     host-side popcount table (used when the device round trip is not
//     worth it for tiny N*M).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

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

int64_t lookup(const int64_t* keys, const int32_t* vals, Py_ssize_t m,
               int64_t key) {
  Py_ssize_t lo = 0, hi = m;
  while (lo < hi) {
    Py_ssize_t mid = (lo + hi) / 2;
    if (keys[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo < m && keys[lo] == key) return vals[lo];
  return -1;
}

PyObject* build_obs_edges(PyObject*, PyObject* args) {
  PyObject *o_matches, *o_kf, *o_cam, *o_prev, *o_keys, *o_vals;
  int n_stereo_cam;
  if (!PyArg_ParseTuple(args, "OOOOOOi", &o_matches, &o_kf, &o_cam,
                        &o_prev, &o_keys, &o_vals, &n_stereo_cam))
    return nullptr;

  Buf b_matches, b_kf, b_cam, b_prev, b_keys, b_vals;
  if (!b_matches.acquire(o_matches) || !b_kf.acquire(o_kf) ||
      !b_cam.acquire(o_cam) ||
      !b_prev.acquire(o_prev) || !b_keys.acquire(o_keys) ||
      !b_vals.acquire(o_vals))
    return nullptr;

  const int64_t* matches = static_cast<const int64_t*>(b_matches.view.buf);
  const int32_t* kf_of = static_cast<const int32_t*>(b_kf.view.buf);
  const int32_t* cam_of = static_cast<const int32_t*>(b_cam.view.buf);
  const int32_t* prev_slot = static_cast<const int32_t*>(b_prev.view.buf);
  const int64_t* keys = static_cast<const int64_t*>(b_keys.view.buf);
  const int32_t* vals = static_cast<const int32_t*>(b_vals.view.buf);
  Py_ssize_t n_kp = b_matches.view.len / (Py_ssize_t)sizeof(int64_t);
  Py_ssize_t n_lm = b_keys.view.len / (Py_ssize_t)sizeof(int64_t);

  std::vector<double> mono, stereo;
  mono.reserve(n_kp * 5 / 4);
  stereo.reserve(n_kp * 3 / 2);

  for (Py_ssize_t g = 0; g < n_kp; ++g) {
    int64_t mp = matches[g];
    if (mp < 0) continue;
    int64_t lm = lookup(keys, vals, n_lm, mp);
    if (lm < 0) continue;
    int32_t s = kf_of[g];
    int32_t c = cam_of[g];
    if (c == n_stereo_cam) {
      stereo.push_back((double)s);
      stereo.push_back((double)lm);
      stereo.push_back((double)g);
    } else {
      int32_t p = prev_slot[s];
      if (p < 0) continue;
      mono.push_back((double)p);
      mono.push_back((double)s);
      mono.push_back((double)lm);
      mono.push_back((double)c);
      mono.push_back((double)g);
    }
  }

  // return as bytes; the Python wrapper re-views them as float64 arrays
  PyObject* mono_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(mono.data()),
      (Py_ssize_t)(mono.size() * sizeof(double)));
  PyObject* st_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(stereo.data()),
      (Py_ssize_t)(stereo.size() * sizeof(double)));
  PyObject* out = PyTuple_Pack(2, mono_b, st_b);
  Py_XDECREF(mono_b);
  Py_XDECREF(st_b);
  return out;
}

// Split [0, n) into roughly-equal thread blocks and run fn(lo, hi) on each.
// Small problems stay single-threaded (thread spawn ~10 us each).
template <typename F>
void parallel_rows(Py_ssize_t n, Py_ssize_t min_per_thread, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  Py_ssize_t want = n / std::max<Py_ssize_t>(min_per_thread, 1);
  Py_ssize_t nt = std::min<Py_ssize_t>(hw ? hw : 1, std::max<Py_ssize_t>(want, 1));
  if (nt <= 1) {
    fn((Py_ssize_t)0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve((size_t)nt);
  Py_ssize_t chunk = (n + nt - 1) / nt;
  for (Py_ssize_t t = 0; t < nt; ++t) {
    Py_ssize_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

PyObject* hamming_matrix(PyObject*, PyObject* args) {
  PyObject *o_a, *o_b;
  if (!PyArg_ParseTuple(args, "OO", &o_a, &o_b)) return nullptr;
  Buf a, b;
  if (!a.acquire(o_a) || !b.acquire(o_b)) return nullptr;
  Py_ssize_t n = a.view.len / 32, m = b.view.len / 32;
  const uint64_t* pa = static_cast<const uint64_t*>(a.view.buf);
  const uint64_t* pb = static_cast<const uint64_t*>(b.view.buf);

  std::vector<int32_t> out((size_t)n * (size_t)m);
  int32_t* po = out.data();
  Py_ssize_t min_rows = m > 0 ? (1 << 16) / m + 1 : n;
  parallel_rows(n, min_rows, [&](Py_ssize_t lo, Py_ssize_t hi) {
    for (Py_ssize_t i = lo; i < hi; ++i) {
      const uint64_t* da = pa + i * 4;
      for (Py_ssize_t j = 0; j < m; ++j) {
        const uint64_t* db = pb + j * 4;
        int32_t d = 0;
        for (int k = 0; k < 4; ++k) d += __builtin_popcountll(da[k] ^ db[k]);
        po[(size_t)i * m + j] = d;
      }
    }
  });
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(out.data()),
                                   (Py_ssize_t)(out.size() * sizeof(int32_t)));
}

// hamming_best(a (N,32) u8, b (M,32) u8) ->
//   (best_j (N,) i32, best_d (N,) i32, second_d (N,) i32)
// Fused nearest/second-nearest reduction: never materializes the (N,M)
// table, so pipeline-scale matching (4k x 4k global descriptor sets in
// SearchForTriangulation) costs O(N+M) memory and parallelizes over rows.
PyObject* hamming_best(PyObject*, PyObject* args) {
  PyObject *o_a, *o_b;
  if (!PyArg_ParseTuple(args, "OO", &o_a, &o_b)) return nullptr;
  Buf a, b;
  if (!a.acquire(o_a) || !b.acquire(o_b)) return nullptr;
  Py_ssize_t n = a.view.len / 32, m = b.view.len / 32;
  const uint64_t* pa = static_cast<const uint64_t*>(a.view.buf);
  const uint64_t* pb = static_cast<const uint64_t*>(b.view.buf);

  std::vector<int32_t> best_j((size_t)n, -1), best_d((size_t)n, 1 << 30),
      second_d((size_t)n, 1 << 30);
  Py_ssize_t min_rows = m > 0 ? (1 << 15) / m + 1 : n;
  parallel_rows(n, min_rows, [&](Py_ssize_t lo, Py_ssize_t hi) {
    for (Py_ssize_t i = lo; i < hi; ++i) {
      const uint64_t* da = pa + i * 4;
      int32_t b1 = 1 << 30, b2 = 1 << 30, bj = -1;
      for (Py_ssize_t j = 0; j < m; ++j) {
        const uint64_t* db = pb + j * 4;
        int32_t d = 0;
        for (int k = 0; k < 4; ++k) d += __builtin_popcountll(da[k] ^ db[k]);
        if (d < b1) {
          b2 = b1;
          b1 = d;
          bj = (int32_t)j;
        } else if (d < b2) {
          b2 = d;
        }
      }
      best_j[(size_t)i] = bj;
      best_d[(size_t)i] = b1;
      second_d[(size_t)i] = b2;
    }
  });
  PyObject* o_bj = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(best_j.data()),
      (Py_ssize_t)(best_j.size() * sizeof(int32_t)));
  PyObject* o_bd = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(best_d.data()),
      (Py_ssize_t)(best_d.size() * sizeof(int32_t)));
  PyObject* o_sd = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(second_d.data()),
      (Py_ssize_t)(second_d.size() * sizeof(int32_t)));
  PyObject* out = PyTuple_Pack(3, o_bj, o_bd, o_sd);
  Py_XDECREF(o_bj);
  Py_XDECREF(o_bd);
  Py_XDECREF(o_sd);
  return out;
}

// match_window: projection-window descriptor matching with a sorted-u
// keypoint index — the native form of ORBmatcher::SearchByProjection's
// grid-accelerated GetFeaturesInArea walk (ORBmatcher.cc:43-200, Frame grid
// at Frame.cc:1030ff). Replaces the O(M*N) NumPy window masks, which were
// the dominant per-frame host cost.
//
// match_window(u (M) f32, v (M) f32, valid (M) u8, r_pt (M) f32,
//              lvl_lo (M) i32, lvl_hi (M) i32, ur_pred (M) f32,
//              mp_desc (M,32) u8,
//              kp_u (N) f32, kp_v (N) f32, kp_oct (N) i32, kp_r (N) f32,
//              kp_ur (N) f32, kp_desc (N,32) u8,
//              max_dist i32, ratio f32, use_pt_radius i32, use_ur i32)
//   -> (best_j (M) i32 [-1 none], best_d (M) i32)
//
// Effective window for pair (i,j): r_pt[i] when use_pt_radius else kp_r[j].
// Octave gate: kp_oct[j] in [lvl_lo[i], lvl_hi[i]]. Stereo right-u gate
// applies when use_ur and kp_ur[j] > 0. ratio > 0 enables the Lowe test
// against the second-best candidate when both share an octave.
PyObject* match_window(PyObject*, PyObject* args) {
  PyObject *o_u, *o_v, *o_valid, *o_rpt, *o_lo, *o_hi, *o_urp, *o_md;
  PyObject *o_ku, *o_kv, *o_ko, *o_kr, *o_kur, *o_kd;
  int max_dist, use_pt_radius, use_ur;
  float ratio;
  if (!PyArg_ParseTuple(args, "OOOOOOOOOOOOOOifii", &o_u, &o_v, &o_valid,
                        &o_rpt, &o_lo, &o_hi, &o_urp, &o_md, &o_ku, &o_kv,
                        &o_ko, &o_kr, &o_kur, &o_kd, &max_dist, &ratio,
                        &use_pt_radius, &use_ur))
    return nullptr;
  Buf u, v, valid, rpt, lo, hi, urp, md, ku, kv, ko, kr, kur, kd;
  if (!u.acquire(o_u) || !v.acquire(o_v) || !valid.acquire(o_valid) ||
      !rpt.acquire(o_rpt) || !lo.acquire(o_lo) || !hi.acquire(o_hi) ||
      !urp.acquire(o_urp) || !md.acquire(o_md) || !ku.acquire(o_ku) ||
      !kv.acquire(o_kv) || !ko.acquire(o_ko) || !kr.acquire(o_kr) ||
      !kur.acquire(o_kur) || !kd.acquire(o_kd))
    return nullptr;
  Py_ssize_t M = u.view.len / 4, N = ku.view.len / 4;
  const float* pu = static_cast<const float*>(u.view.buf);
  const float* pv = static_cast<const float*>(v.view.buf);
  const uint8_t* pvalid = static_cast<const uint8_t*>(valid.view.buf);
  const float* prpt = static_cast<const float*>(rpt.view.buf);
  const int32_t* plo = static_cast<const int32_t*>(lo.view.buf);
  const int32_t* phi = static_cast<const int32_t*>(hi.view.buf);
  const float* purp = static_cast<const float*>(urp.view.buf);
  const uint64_t* pmd = static_cast<const uint64_t*>(md.view.buf);
  const float* pku = static_cast<const float*>(ku.view.buf);
  const float* pkv = static_cast<const float*>(kv.view.buf);
  const int32_t* pko = static_cast<const int32_t*>(ko.view.buf);
  const float* pkr = static_cast<const float*>(kr.view.buf);
  const float* pkur = static_cast<const float*>(kur.view.buf);
  const uint64_t* pkd = static_cast<const uint64_t*>(kd.view.buf);

  // sort keypoints by u once: O(N log N), then each point scans only its
  // u-window via binary search
  std::vector<int32_t> order((size_t)N);
  for (Py_ssize_t j = 0; j < N; ++j) order[(size_t)j] = (int32_t)j;
  std::sort(order.begin(), order.end(),
            [&](int32_t a2, int32_t b2) { return pku[a2] < pku[b2]; });
  std::vector<float> su((size_t)N);
  for (Py_ssize_t j = 0; j < N; ++j) su[(size_t)j] = pku[order[(size_t)j]];
  float rmax_kp = 0.0f;
  if (!use_pt_radius)
    for (Py_ssize_t j = 0; j < N; ++j) rmax_kp = std::max(rmax_kp, pkr[j]);

  std::vector<int32_t> best_j((size_t)M, -1), best_d((size_t)M, 1 << 30);
  parallel_rows(M, 256, [&](Py_ssize_t b_lo, Py_ssize_t b_hi) {
    for (Py_ssize_t i = b_lo; i < b_hi; ++i) {
      if (!pvalid[i]) continue;
      float ui = pu[i], vi = pv[i];
      float rwin = use_pt_radius ? prpt[i] : rmax_kp;
      auto it0 = std::lower_bound(su.begin(), su.end(), ui - rwin);
      auto it1 = std::upper_bound(su.begin(), su.end(), ui + rwin);
      int32_t b1 = 1 << 30, b2 = 1 << 30, bj = -1, o1 = -1, o2 = -1;
      const uint64_t* di = pmd + i * 4;
      for (auto it = it0; it != it1; ++it) {
        int32_t j = order[(size_t)(it - su.begin())];
        float r = use_pt_radius ? prpt[i] : pkr[j];
        if (pku[j] < ui - r || pku[j] > ui + r) continue;
        if (pkv[j] < vi - r || pkv[j] > vi + r) continue;
        int32_t oc = pko[j];
        if (oc < plo[i] || oc > phi[i]) continue;
        if (use_ur && pkur[j] > 0.0f) {
          float d_ur = purp[i] - pkur[j];
          if (d_ur < -r || d_ur > r) continue;
        }
        const uint64_t* dj = pkd + (Py_ssize_t)j * 4;
        int32_t d = 0;
        for (int k = 0; k < 4; ++k) d += __builtin_popcountll(di[k] ^ dj[k]);
        if (d < b1) {
          b2 = b1;
          o2 = o1;
          b1 = d;
          o1 = oc;
          bj = j;
        } else if (d < b2) {
          b2 = d;
          o2 = oc;
        }
      }
      if (bj < 0 || b1 > max_dist) continue;
      if (ratio > 0.0f && b2 < (1 << 30) && o1 == o2 &&
          (float)b1 > ratio * (float)b2)
        continue;
      best_j[(size_t)i] = bj;
      best_d[(size_t)i] = b1;
    }
  });

  PyObject* o_bj = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(best_j.data()),
      (Py_ssize_t)(best_j.size() * sizeof(int32_t)));
  PyObject* o_bd = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(best_d.data()),
      (Py_ssize_t)(best_d.size() * sizeof(int32_t)));
  PyObject* out = PyTuple_Pack(2, o_bj, o_bd);
  Py_XDECREF(o_bj);
  Py_XDECREF(o_bd);
  return out;
}

PyMethodDef methods[] = {
    {"build_obs_edges", build_obs_edges, METH_VARARGS,
     "SoA observation-edge extraction"},
    {"hamming_matrix", hamming_matrix, METH_VARARGS,
     "popcount Hamming distance table"},
    {"hamming_best", hamming_best, METH_VARARGS,
     "fused nearest/second-nearest Hamming reduction"},
    {"match_window", match_window, METH_VARARGS,
     "projection-window descriptor matching (sorted-u index)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_graph_builder",
    "native SoA graph builder for amcslam_tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__graph_builder(void) {
  return PyModule_Create(&moduledef);
}
