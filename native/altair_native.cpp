// altair_native — compiled CPU engine tier.
//
// The reference's heavy lifting lived in compiled C++ (ROBAST's
// TraceNonSequential + the scalar detector-scoring loop,
// fluxAtObserverFast.C:1269-1341).  This library is the rebuild's native
// tier: an independent, OpenMP-parallel implementation of
//   (1) the Monte-Carlo bounce loop (Lambertian walls, reflectance
//       roulette, polar-cap exit port), and
//   (2) the trace-once detector-grid scorer (the [rays x positions]
//       plane/disk test),
// exposed with a C ABI for ctypes.  It serves as (a) a no-JAX CPU fallback
// and (b) an independent cross-validation oracle for the JAX path — two
// implementations of the same physics written against the same spec.
//
// RNG: xoshiro256++ (public-domain algorithm by Blackman/Vigna), seeded
// per ray via splitmix64 — counter-style reproducibility like the JAX
// path's folded keys (bit-identical streams across thread counts).

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct V3 {
  double x, y, z;
};

inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline double norm(V3 a) { return std::sqrt(dot(a, a)); }
inline V3 unit(V3 a) {
  double n = norm(a);
  return {a.x / n, a.y / n, a.z / n};
}

// -- xoshiro256++ ----------------------------------------------------------
struct Rng {
  uint64_t s[4];

  static uint64_t splitmix64(uint64_t& x) {
    x += 0x9E3779B97f4A7C15ULL;
    uint64_t z = x;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }

  explicit Rng(uint64_t seed) {
    for (auto& w : s) w = splitmix64(seed);
  }

  static uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }

  uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }

  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
};

// Orthonormal basis about a unit vector (Duff et al.), matching the JAX
// path's construction so azimuth conventions agree.
inline void basis(V3 n, V3& u, V3& v) {
  double sign = n.z >= 0 ? 1.0 : -1.0;
  double a = -1.0 / (sign + n.z);
  double b = n.x * n.y * a;
  u = {1.0 + sign * n.x * n.x * a, sign * b, -sign * n.x};
  v = {b, sign + n.y * n.y * a, -n.y};
}

inline V3 cosine_hemisphere(Rng& rng, V3 n) {
  double u1 = rng.uniform(), u2 = rng.uniform();
  double ct = std::sqrt(u1), st = std::sqrt(1.0 - u1);
  double ph = 2.0 * M_PI * u2;
  V3 t1, t2;
  basis(n, t1, t2);
  return unit(t1 * (st * std::cos(ph)) + t2 * (st * std::sin(ph)) + n * ct);
}

// distance from interior point p along unit d to sphere |q| = r
inline double sphere_exit_t(V3 p, V3 d, double r) {
  double b = dot(p, d);
  double c = dot(p, p) - r * r;
  double disc = b * b - c;
  if (disc < 0) disc = 0;
  double t = -b + std::sqrt(disc);
  return t > 0 ? t : 0;
}

inline double box_exit_t(V3 p, V3 d, double half) {
  auto axis = [&](double pc, double dc) {
    if (dc == 0) return 1e300;
    double face = dc >= 0 ? half : -half;
    return (face - pc) / dc;
  };
  double t = axis(p.x, d.x);
  double ty = axis(p.y, d.y);
  double tz = axis(p.z, d.z);
  if (ty < t) t = ty;
  if (tz < t) t = tz;
  return t;
}

}  // namespace

extern "C" {

// Status codes match altair_tpu.core.trace.
enum { RUNNING = 0, EXITED = 1, ABSORBED = 2, SUSPENDED = 3 };

namespace {

// Smallest positive crossing of the cone theta == theta_max (z<0 nappe)
// with radius within [r_lo, r_hi]; +inf if none.  cos2 = cos^2(theta_max).
inline double cone_crossing(V3 p, V3 d, double cos2, double r_lo,
                            double r_hi) {
  double A = d.z * d.z - cos2 * dot(d, d);
  double B = 2 * (p.z * d.z - cos2 * dot(p, d));
  double C = p.z * p.z - cos2 * dot(p, p);
  double best = 1e300;
  auto consider = [&](double s) {
    if (s <= 1e-9 || s >= best) return;
    V3 q = p + d * s;
    if (q.z >= 0) return;  // wrong nappe
    double r = norm(q);
    if (r >= r_lo - 1e-9 && r <= r_hi + 1e-9) best = s;
  };
  if (std::fabs(A) < 1e-300) {
    if (std::fabs(B) > 0) consider(-C / B);
  } else {
    double disc = B * B - 4 * A * C;
    if (disc >= 0) {
      double sd = std::sqrt(disc);
      consider((-B - sd) / (2 * A));
      consider((-B + sd) / (2 * A));
    }
  }
  return best;
}

// Smallest positive crossing of sphere |q| = r; +inf if none.
inline double sphere_crossing(V3 p, V3 d, double r) {
  double b = dot(p, d);
  double c = dot(p, p) - r * r;
  double disc = b * b - c;
  if (disc < 0) return 1e300;
  double sd = std::sqrt(disc);
  double s1 = -b - sd, s2 = -b + sd;
  if (s1 > 1e-9) return s1;
  if (s2 > 1e-9) return s2;
  return 1e300;
}

// Lambertian re-emission from a cone-face point into the hole side
// (normal = +theta_hat, the increasing-polar-angle direction).
inline V3 cone_face_normal(V3 p) {
  double r = norm(p);
  double rho = std::sqrt(p.x * p.x + p.y * p.y);
  if (rho < 1e-12) return {1, 0, 0};  // degenerate (apex) — arbitrary
  return {p.z / r * p.x / rho, p.z / r * p.y / rho, -rho / r};
}

}  // namespace

// Trace n rays.  Outputs (size n unless noted): status, last_point[3n],
// seg_start[3n], direction[3n], n_bounces.  Returns number of rays whose
// last point passed the exit-z test.
long long altair_trace_ex(
    long long n, uint64_t seed,
    // scene (altair_tpu.config.SphereScene semantics)
    double inner_radius, double outer_radius, double theta_max_deg,
    double reflectance, double world_half, double exit_port_z,
    long long max_bounces, int exact_rim,
    // source
    double sx, double sy, double sz, double dx, double dy, double dz,
    // outputs
    int32_t* status, double* last_point, double* seg_start,
    double* direction, int32_t* n_bounces) {
  const double theta_max = theta_max_deg * M_PI / 180.0;
  const double cos_cap = inner_radius * std::cos(theta_max);
  const double cos2 = std::cos(theta_max) * std::cos(theta_max);
  const V3 src{sx, sy, sz};
  const V3 sdir = unit({dx, dy, dz});
  long long n_exit = 0;

#pragma omp parallel for schedule(static) reduction(+ : n_exit)
  for (long long i = 0; i < n; ++i) {
    uint64_t mix = seed;
    Rng rng(Rng::splitmix64(mix) ^ (0x9E3779B97f4A7C15ULL * (uint64_t)(i + 1)));
    V3 p = src, d = sdir, prev = src;
    int st = RUNNING;
    int32_t bounces = 0;
    bool in_gap = false;  // true: position is in the hole/gap region
                          // (r in [r_in, r_out], theta > theta_max)
    for (long long k = 0; k < max_bounces && st == RUNNING; ++k) {
      if (!in_gap) {
        // --- interior of the sphere -----------------------------------
        double t = sphere_exit_t(p, d, inner_radius);
        V3 q = p + d * t;
        double rn = inner_radius / norm(q);
        q = q * rn;  // re-project (parity with the JAX kernels)
        if (q.z < cos_cap) {  // heading out through the port cap
          if (exact_rim) {
            // the escaping flight may clip the shell's conical rim face
            // (theta == theta_max, r in [r_in, r_out]) — ROBAST reflects
            // there (same mirror + border condition)
            double s = cone_crossing(q, d, cos2, inner_radius, outer_radius);
            if (s < 1e300) {
              V3 pc = q + d * s;
              ++bounces;
              if (rng.uniform() >= reflectance) {
                prev = p;
                p = pc;
                st = ABSORBED;
                break;
              }
              prev = p;
              p = pc;
              d = cosine_hemisphere(rng, cone_face_normal(pc));
              in_gap = true;
              continue;
            }
          }
          double tb = box_exit_t(p, d, world_half);
          prev = p;
          p = p + d * tb;
          st = EXITED;
          break;
        }
        ++bounces;
        if (rng.uniform() >= reflectance) {  // absorbed by roulette
          prev = p;
          p = q;
          st = ABSORBED;
          break;
        }
        V3 nrm = q * (-1.0 / inner_radius);
        prev = p;
        p = q;
        d = cosine_hemisphere(rng, nrm);
      } else {
        // --- gap/hole region (between the shell radii, theta>theta_max,
        // or outward past the rim) — nearest of: cone face (reflect),
        // inner sphere (re-enter the interior through the cap), outer
        // sphere (escape outward) ---------------------------------------
        double s_cone = cone_crossing(p, d, cos2, inner_radius, outer_radius);
        double s_in = sphere_crossing(p, d, inner_radius);
        double s_out = sphere_crossing(p, d, outer_radius);
        // sphere crossings on the shell side (theta <= theta_max) are
        // unreachable without passing the cone first, so no theta check
        // is needed when the cone is handled as a candidate.
        if (s_cone < s_in && s_cone < s_out) {
          V3 pc = p + d * s_cone;
          ++bounces;
          if (rng.uniform() >= reflectance) {
            prev = p;
            p = pc;
            st = ABSORBED;
            break;
          }
          prev = p;
          p = pc;
          d = cosine_hemisphere(rng, cone_face_normal(pc));
        } else if (s_in < s_out) {
          // re-enters the interior through the inner-cap hole
          V3 q = p + d * s_in;
          prev = p;
          p = q * (inner_radius / norm(q));
          in_gap = false;
        } else if (s_out < 1e300) {
          // escapes outward past the outer radius — free flight to the box
          double tb = box_exit_t(p, d, world_half);
          prev = p;
          p = p + d * tb;
          st = EXITED;
          break;
        } else {
          // numerically stuck (should not happen) — suspend
          break;
        }
      }
    }
    if (st == RUNNING) st = SUSPENDED;
    status[i] = st;
    n_bounces[i] = bounces;
    last_point[3 * i] = p.x;
    last_point[3 * i + 1] = p.y;
    last_point[3 * i + 2] = p.z;
    seg_start[3 * i] = prev.x;
    seg_start[3 * i + 1] = prev.y;
    seg_start[3 * i + 2] = prev.z;
    direction[3 * i] = d.x;
    direction[3 * i + 1] = d.y;
    direction[3 * i + 2] = d.z;
    if (st == EXITED && p.z < exit_port_z) ++n_exit;
  }
  return n_exit;
}

// Back-compat ABI: the original entry point without rim handling.
long long altair_trace(
    long long n, uint64_t seed,
    double inner_radius, double theta_max_deg, double reflectance,
    double world_half, double exit_port_z, long long max_bounces,
    double sx, double sy, double sz, double dx, double dy, double dz,
    int32_t* status, double* last_point, double* seg_start,
    double* direction, int32_t* n_bounces) {
  return altair_trace_ex(n, seed, inner_radius, inner_radius + 0.9,
                         theta_max_deg, reflectance, world_half, exit_port_z,
                         max_bounces, /*exact_rim=*/0, sx, sy, sz, dx, dy, dz,
                         status, last_point, seg_start, direction, n_bounces);
}

// Closed-form direct sampler — the native fp64 cross-check of the JAX
// path's default engine (altair_tpu/core/trace_direct.py).  Simple-mode
// Lambertian chain law: after the deterministic first flight, wall hits
// are i.i.d. uniform on the sphere (uniform pairwise form factor), so the
// whole bounce chain is Geometric(1 - (1-f)*rho) rounds plus an
// independent exit/absorb terminal event, and the final segment is
// (band-uniform point -> cap-uniform point).  Same output contract and
// per-lane case analysis as altair_trace; independent RNG (xoshiro256++)
// and arithmetic (fp64) from the JAX implementation.
long long altair_trace_direct(
    long long n, uint64_t seed,
    double inner_radius, double theta_max_deg, double reflectance,
    double world_half, double exit_port_z, long long max_bounces,
    double sx, double sy, double sz, double dx, double dy, double dz,
    int32_t* status, double* last_point, double* seg_start,
    double* direction, int32_t* n_bounces) {
  const double theta_max = theta_max_deg * M_PI / 180.0;
  const double cos_tm = std::cos(theta_max);
  const double cos_cap = inner_radius * cos_tm;
  const double f = 0.5 * (1.0 + cos_tm);           // cap area fraction
  const double s_cont = (1.0 - f) * reflectance;   // per-round continue
  const double pe_den = f + (1.0 - f) * (1.0 - reflectance);
  const double p_exit = pe_den > 0 ? f / pe_den : 1.0;
  const double log_s = std::log(std::max(s_cont, 1e-300));
  const V3 src{sx, sy, sz};
  const V3 sdir = unit({dx, dy, dz});
  long long n_exit = 0;

  auto zone_point = [&](double z_lo, double z_hi, double uz,
                        double uphi) -> V3 {
    // uniform on the spherical zone z/r in [z_lo, z_hi]
    double zf = z_lo + uz * (z_hi - z_lo);
    double rho = std::sqrt(std::max(1.0 - zf * zf, 0.0));
    double phi = 2.0 * M_PI * uphi;
    return {inner_radius * rho * std::cos(phi),
            inner_radius * rho * std::sin(phi), inner_radius * zf};
  };

#pragma omp parallel for schedule(static) reduction(+ : n_exit)
  for (long long i = 0; i < n; ++i) {
    uint64_t mix = seed;
    Rng rng(Rng::splitmix64(mix) ^
            (0xD1B54A32D192ED03ULL * (uint64_t)(i + 1)));
    // deterministic first flight (the only non-uniform step)
    double t1 = sphere_exit_t(src, sdir, inner_radius);
    V3 q1 = src + sdir * t1;
    q1 = q1 * (inner_radius / norm(q1));
    bool esc1 = q1.z < cos_cap;

    double u_s1 = rng.uniform(), u_g = rng.uniform(),
           u_term = rng.uniform(), u_pz = rng.uniform(),
           u_pphi = rng.uniform(), u_qz = rng.uniform(),
           u_qphi = rng.uniform();

    bool surv1 = u_s1 < reflectance;
    double ratio = (log_s == 0.0) ? 1e300 : std::log1p(-u_g) / log_s;
    long long G = (long long)std::floor(
        std::min(ratio, (double)max_bounces));
    bool term_exit = u_term < p_exit;
    bool susp = surv1 && !esc1 && ratio >= (double)max_bounces - 1.0;

    V3 b1 = zone_point(cos_tm, 1.0, u_pz, u_pphi);
    V3 b2 = zone_point(cos_tm, 1.0, u_qz, u_qphi);
    V3 qcap = zone_point(-1.0, cos_tm, u_qz, u_qphi);

    int st;
    int32_t bc;
    V3 seg, dir, last;
    if (esc1) {
      st = EXITED;
      bc = 0;
      seg = src;
      dir = sdir;
      last = src + sdir * box_exit_t(src, sdir, world_half);
    } else if (!surv1) {
      st = ABSORBED;
      bc = 1;
      seg = src;
      dir = sdir;
      last = q1;
    } else if (susp) {
      st = SUSPENDED;
      bc = (int32_t)max_bounces;
      seg = b1;
      dir = unit(b2 - b1);
      last = b2;
    } else {
      V3 p_late = (G == 0) ? q1 : b1;
      if (term_exit) {
        st = EXITED;
        bc = (int32_t)(1 + G);
        seg = p_late;
        dir = unit(qcap - p_late);
        last = p_late + dir * box_exit_t(p_late, dir, world_half);
      } else {
        st = ABSORBED;
        bc = (int32_t)(2 + G);
        seg = p_late;
        dir = unit(b2 - p_late);
        last = b2;
      }
    }
    status[i] = st;
    n_bounces[i] = bc;
    last_point[3 * i] = last.x;
    last_point[3 * i + 1] = last.y;
    last_point[3 * i + 2] = last.z;
    seg_start[3 * i] = seg.x;
    seg_start[3 * i + 1] = seg.y;
    seg_start[3 * i + 2] = seg.z;
    direction[3 * i] = dir.x;
    direction[3 * i + 1] = dir.y;
    direction[3 * i + 2] = dir.z;
    if (st == EXITED && last.z < exit_port_z) ++n_exit;
  }
  return n_exit;
}

// Trace-once detector-grid scorer: for each of the n_pos detectors
// (centers[3p], normals[3p]) count segments (point, dir) whose infinite line
// crosses the disk of radius half_width (Detector::checkIntersection,
// fluxAtObserver.C:70-107).  mask[i] != 0 selects scorable rays.
void altair_score_grid(
    long long n, const double* point, const double* dir, const uint8_t* mask,
    long long n_pos, const double* centers, const double* normals,
    double half_width, int32_t* counts) {
  const double r2max = half_width * half_width;
#pragma omp parallel for schedule(static)
  for (long long p = 0; p < n_pos; ++p) {
    const V3 c{centers[3 * p], centers[3 * p + 1], centers[3 * p + 2]};
    const V3 nn{normals[3 * p], normals[3 * p + 1], normals[3 * p + 2]};
    int32_t hits = 0;
    for (long long i = 0; i < n; ++i) {
      if (!mask[i]) continue;
      const V3 e{point[3 * i], point[3 * i + 1], point[3 * i + 2]};
      const V3 d{dir[3 * i], dir[3 * i + 1], dir[3 * i + 2]};
      double dn = dot(d, nn);
      if (std::fabs(dn) < 1e-10) continue;
      double t = -dot(e - c, nn) / dn;
      V3 r = (e + d * t) - c;
      V3 perp = cross(nn, r);
      if (dot(perp, perp) <= r2max) ++hits;
    }
    counts[p] = hits;
  }
}

// Detector placement with the reference's swapped-normal convention
// (fluxAtObserver.C:49-68) — kept native-side so the pure-C++ pipeline is
// self-contained.
void altair_detector_grid(
    long long n_theta, long long n_phi, double theta_lo, double theta_hi,
    double phi_lo, double phi_hi, double radius, double exit_port_z,
    double* centers, double* normals) {
  const double dth = (theta_hi - theta_lo) / n_theta;
  const double dph = (phi_hi - phi_lo) / n_phi;
  for (long long i = 0; i < n_theta; ++i) {
    double th = (theta_lo + (i + 0.5) * dth) * M_PI / 180.0;
    for (long long j = 0; j < n_phi; ++j) {
      double ph = (phi_lo + (j + 0.5) * dph) * M_PI / 180.0;
      long long p = i * n_phi + j;
      double cx = radius * std::sin(th) * std::cos(ph);
      double cy = radius * std::sin(th) * std::sin(ph);
      double cz = exit_port_z - radius * std::cos(th);
      double ddx = cx, ddy = cy, ddz = cz - exit_port_z;
      double mag = std::sqrt(ddx * ddx + ddy * ddy + ddz * ddz);
      centers[3 * p] = cx;
      centers[3 * p + 1] = cy;
      centers[3 * p + 2] = cz;
      normals[3 * p] = -ddy / mag;
      normals[3 * p + 1] = ddx / mag;
      normals[3 * p + 2] = ddz / mag;
    }
  }
}

int altair_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
