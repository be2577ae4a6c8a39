// Native line-mesh builder — this build's equivalent of the reference's
// per-frame CPU hot path: polyline normal/miter computation and ribbon
// attribute fill (`src/geom/line/index.js:73-117` + `polyline-normals`),
// which the reference re-runs per pointer-path per frame.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: `make -C native` → libtendrils_native.so

#include <cmath>
#include <cstdint>

namespace {

struct Vec2 {
  double x, y;
};

inline Vec2 sub(Vec2 a, Vec2 b) { return {a.x - b.x, a.y - b.y}; }
inline Vec2 add(Vec2 a, Vec2 b) { return {a.x + b.x, a.y + b.y}; }
inline double dot(Vec2 a, Vec2 b) { return a.x * b.x + a.y * b.y; }

inline Vec2 unit(Vec2 v) {
  double n = std::sqrt(dot(v, v));
  if (n < 1e-12) return {0.0, 0.0};
  return {v.x / n, v.y / n};
}

inline Vec2 normal_of(Vec2 d) { return {-d.y, d.x}; }

}  // namespace

extern "C" {

// Per-point unit normals and miter lengths of a polyline.
// path: [n, 2] doubles. normals_out: [n, 2] floats. miters_out: [n] floats.
// closed: 0 or 1. Matches npm `polyline-normals` semantics: open ends get
// the segment normal with miter 1; interior points get the angle-bisector
// normal with miter 1/dot(miter, segment_normal).
void tendrils_polyline_normals(const double* path, int64_t n, int closed,
                               float* normals_out, float* miters_out) {
  if (n <= 0) return;
  if (n == 1) {
    normals_out[0] = 0.0f;
    normals_out[1] = 1.0f;
    miters_out[0] = 1.0f;
    return;
  }

  auto pt = [&](int64_t i) -> Vec2 {
    int64_t j = i;
    if (closed) {
      j = ((i % n) + n) % n;
    }
    return {path[2 * j], path[2 * j + 1]};
  };

  auto seg_normal = [&](int64_t i) -> Vec2 {  // segment i -> i+1
    return normal_of(unit(sub(pt(i + 1), pt(i))));
  };

  for (int64_t j = 0; j < n; ++j) {
    Vec2 nrm;
    double miter = 1.0;
    if (!closed && j == 0) {
      nrm = seg_normal(0);
    } else if (!closed && j == n - 1) {
      nrm = seg_normal(n - 2);
    } else {
      Vec2 n0 = seg_normal(j - 1);
      Vec2 n1 = seg_normal(j);
      Vec2 m = unit(add(n0, n1));
      double d = dot(m, n1);
      miter = 1.0 / (d > 1e-6 ? d : 1e-6);
      nrm = m;
    }
    normals_out[2 * j] = static_cast<float>(nrm.x);
    normals_out[2 * j + 1] = static_cast<float>(nrm.y);
    miters_out[j] = static_cast<float>(miter);
  }
}

// Ribbon attribute fill: expand a path into 2 strip vertices per point
// (position ± normal*miter*rad, flipped odd miters like
// `geom/line/index.js:157-158`) and per-point velocities
// `(pos - prev) * speed / max(dt, 1)` (`flow-line/index.vert:28-31`).
// path: [n,2] doubles; times: [n] doubles.
// verts_out: [n*2, 2] floats; vels_out: [n, 2] floats.
void tendrils_fill_ribbon(const double* path, const double* times, int64_t n,
                          double rad, double speed, float* verts_out,
                          float* vels_out) {
  if (n <= 0) return;

  // Normals/miters (open path).
  float* normals = new float[2 * n];
  float* miters = new float[n];
  tendrils_polyline_normals(path, n, 0, normals, miters);

  for (int64_t j = 0; j < n; ++j) {
    const double px = path[2 * j], py = path[2 * j + 1];
    const double nx = normals[2 * j], ny = normals[2 * j + 1];
    const double m = miters[j];
    for (int v = 0; v < 2; ++v) {
      const int64_t i = 2 * j + v;
      const double flip = ((i % 2) * 2 - 1) * m;
      verts_out[2 * i] = static_cast<float>(px + nx * rad * flip);
      verts_out[2 * i + 1] = static_cast<float>(py + ny * rad * flip);
    }
    const int64_t prev = j > 0 ? j - 1 : 0;
    const double dt = times[j] - times[prev];
    const double rate = speed / (dt > 1.0 ? dt : 1.0);
    vels_out[2 * j] = static_cast<float>((px - path[2 * prev]) * rate);
    vels_out[2 * j + 1] = static_cast<float>((py - path[2 * prev + 1]) * rate);
  }

  delete[] normals;
  delete[] miters;
}

// Ring-buffer data log rotate + Euler rate (the `analyse` hot loop,
// `src/analyse/index.js:17-31`) for large spectra.
void tendrils_log_rates(const float* last, const float* current, int64_t n,
                        double dt, float* out) {
  const double inv = 1.0 / (dt != 0.0 ? dt : 1.0);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = static_cast<float>((current[i] - last[i]) * inv);
  }
}

}  // extern "C"
