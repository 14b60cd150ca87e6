// osu_native: fast .osu beatmap parsing + datapoint featurization (C ABI).
//
// Native replacement for the data-loader hot path: parsing thousands of .osu
// text files and expanding hit objects into (T, 19) feature rows dominates
// host-side loading (the reference does this in Python DataLoader workers,
// reference data_loading.py:243-267). The semantics here match
// osu_diffusion_tpu_torch/data/featurize.py and osu_diffusion_tpu_torch/beatmap
// exactly (differentially tested against them over the toy fixtures),
// including the osu!lazer curve flattening used for slider end positions.
//
// Exposed C ABI (see osu_diffusion_tpu_torch/native/__init__.py for the
// ctypes wrapper; osu_diffusion_tpu_torch/native/build.py builds it):
//   int  osu_featurize_file(const char* path, float** out, int* rows);
//   int  osu_featurize_buffer(const char* text, long len, float** out, int* rows);
//   void osu_free(float* ptr);
// Returns 0 on success; rows*19 floats in row-major [x, y, time_ms, onehot16].

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <limits>
#include <string>
#include <vector>

namespace {

constexpr int kFeatureSize = 19;
constexpr double kBezierTolerance = 0.25;
constexpr int kCatmullDetail = 50;
constexpr double kCircularArcTolerance = 0.1;
// Robustness spec — mirrored EXACTLY by the Python parser
// (osu_diffusion_tpu_torch/beatmap/parser.py module docstring): load-bearing fields
// are strict (malformed/non-finite/out-of-range value -> reject the FILE);
// cosmetic fields are tolerant. Bounds shared with the Python side.
constexpr double kMaxCoord = 65536.0;
constexpr double kMaxTimeMs = 1e9;
constexpr double kMaxLength = 1e7;
constexpr int kMaxBezierSubdivisions = 65536;
constexpr int kMaxArcPoints = 32768;

struct Vec2 {
  double x = 0, y = 0;
  Vec2() = default;
  Vec2(double x_, double y_) : x(x_), y(y_) {}
  Vec2 operator+(const Vec2& o) const { return {x + o.x, y + o.y}; }
  Vec2 operator-(const Vec2& o) const { return {x - o.x, y - o.y}; }
  Vec2 operator*(double s) const { return {x * s, y * s}; }
  Vec2 operator/(double s) const { return {x / s, y / s}; }
  bool operator==(const Vec2& o) const { return x == o.x && y == o.y; }
  double norm() const { return std::sqrt(x * x + y * y); }
  double dot(const Vec2& o) const { return x * o.x + y * o.y; }
};

struct TimingPoint {
  double offset_ms = 0;
  double beat_length = 500;
  bool uninherited = true;
};

struct HitObjectRow {
  double x, y, time_ms;
  int type;  // datapoint type 0..15
};

// ---------------------------------------------------------------------------
// curve flattening (osu!lazer algorithms; parity with beatmap/curves.py)
// ---------------------------------------------------------------------------

bool BezierFlatEnough(const std::vector<Vec2>& cp) {
  for (size_t i = 1; i + 1 < cp.size(); ++i) {
    Vec2 second = cp[i - 1] - cp[i] * 2.0 + cp[i + 1];
    if (second.dot(second) > kBezierTolerance * kBezierTolerance * 4) return false;
  }
  return true;
}

void BezierSubdivide(const std::vector<Vec2>& cp, std::vector<Vec2>& left,
                     std::vector<Vec2>& right) {
  const size_t n = cp.size();
  std::vector<Vec2> mid = cp;
  left.resize(n);
  right.resize(n);
  for (size_t i = 0; i < n; ++i) {
    left[i] = mid[0];
    right[n - i - 1] = mid[n - i - 1];
    for (size_t j = 0; j + i + 1 < n; ++j) mid[j] = (mid[j] + mid[j + 1]) / 2.0;
  }
}

void BezierEmit(const std::vector<Vec2>& cp, std::vector<Vec2>& out) {
  const size_t n = cp.size();
  std::vector<Vec2> left, right;
  BezierSubdivide(cp, left, right);
  std::vector<Vec2> merged = left;
  merged.insert(merged.end(), right.begin() + 1, right.end());
  out.push_back(cp[0]);
  for (size_t i = 1; i + 1 < n; ++i) {
    const size_t idx = 2 * i;
    out.push_back((merged[idx - 1] + merged[idx] * 2.0 + merged[idx + 1]) * 0.25);
  }
}

std::vector<Vec2> ApproximateBezier(const std::vector<Vec2>& control_points) {
  std::vector<Vec2> out;
  if (control_points.empty()) return out;
  std::vector<std::vector<Vec2>> stack{control_points};
  int pops = 0;  // hard bound, identical LIFO order to the Python flattener
  while (!stack.empty()) {
    std::vector<Vec2> parent = std::move(stack.back());
    stack.pop_back();
    ++pops;
    if (pops > kMaxBezierSubdivisions || BezierFlatEnough(parent)) {
      BezierEmit(parent, out);
      continue;
    }
    std::vector<Vec2> left, right;
    BezierSubdivide(parent, left, right);
    stack.push_back(std::move(right));
    stack.push_back(std::move(left));
  }
  out.push_back(control_points.back());
  return out;
}

Vec2 CatmullPoint(const Vec2& v1, const Vec2& v2, const Vec2& v3, const Vec2& v4,
                  double t) {
  const double t2 = t * t, t3 = t2 * t;
  auto coord = [&](double a, double b, double c, double d) {
    return 0.5 * (2 * b + (-a + c) * t + (2 * a - 5 * b + 4 * c - d) * t2 +
                  (-a + 3 * b - 3 * c + d) * t3);
  };
  return {coord(v1.x, v2.x, v3.x, v4.x), coord(v1.y, v2.y, v3.y, v4.y)};
}

std::vector<Vec2> ApproximateCatmull(const std::vector<Vec2>& cp) {
  std::vector<Vec2> result;
  const int m = static_cast<int>(cp.size());
  for (int i = 0; i + 1 < m; ++i) {
    const Vec2 v1 = i > 0 ? cp[i - 1] : cp[i];
    const Vec2 v2 = cp[i];
    const Vec2 v3 = i < m - 1 ? cp[i + 1] : v2 + v2 - v1;
    const Vec2 v4 = i < m - 2 ? cp[i + 2] : v3 + v3 - v2;
    for (int c = 0; c < kCatmullDetail; ++c) {
      result.push_back(CatmullPoint(v1, v2, v3, v4, double(c) / kCatmullDetail));
      result.push_back(
          CatmullPoint(v1, v2, v3, v4, double(c + 1) / kCatmullDetail));
    }
  }
  return result;
}

bool NearZero(double v) { return std::abs(v) <= 1e-8 * std::max(1.0, std::abs(v)); }

std::vector<Vec2> ApproximateCircularArc(const std::vector<Vec2>& cp) {
  const Vec2 a = cp[0], b = cp[1], c = cp[2];
  if (!std::isfinite(a.x) || !std::isfinite(a.y) || !std::isfinite(b.x) ||
      !std::isfinite(b.y) || !std::isfinite(c.x) || !std::isfinite(c.y)) {
    return {};  // degenerate -> bezier fallback (which handles non-finite)
  }
  const double a_sq = (b - c).dot(b - c);
  const double b_sq = (a - c).dot(a - c);
  const double c_sq = (a - b).dot(a - b);
  if (NearZero(a_sq) || NearZero(b_sq) || NearZero(c_sq)) return {};
  const double s = a_sq * (b_sq + c_sq - a_sq);
  const double t = b_sq * (a_sq + c_sq - b_sq);
  const double u = c_sq * (a_sq + b_sq - c_sq);
  const double sum = s + t + u;
  if (NearZero(sum)) return {};
  const Vec2 centre = (a * s + b * t + c * u) / sum;
  const Vec2 d_a = a - centre;
  const Vec2 d_c = c - centre;
  const double r = d_a.norm();
  double theta_start = std::atan2(d_a.y, d_a.x);
  double theta_end = std::atan2(d_c.y, d_c.x);
  while (theta_end < theta_start) theta_end += 2 * M_PI;
  double direction = 1;
  double theta_range = theta_end - theta_start;
  Vec2 ortho{(c - a).y, -(c - a).x};
  if (ortho.dot(b - a) < 0) {
    direction = -1;
    theta_range = 2 * M_PI - theta_range;
  }
  // capped like the Python side: near-collinear points give astronomically
  // large radii; at the cap the arc is sub-pixel-indistinguishable from a line
  int n_points = 2;
  if (2 * r > kCircularArcTolerance) {
    const double raw = std::ceil(
        theta_range / (2 * std::acos(1 - kCircularArcTolerance / r)));
    // clamp in double BEFORE the int cast: near-collinear points give finite
    // raw far beyond INT_MAX, and (int)raw would be UB (and diverge from the
    // Python side's min(32768, int(raw)))
    n_points = (!std::isfinite(raw) || raw >= kMaxArcPoints)
                   ? kMaxArcPoints
                   : std::max(2, (int)raw);
  }
  std::vector<Vec2> out;
  out.reserve(n_points);
  for (int i = 0; i < n_points; ++i) {
    const double fract = double(i) / (n_points - 1);
    const double theta = theta_start + direction * fract * theta_range;
    out.push_back(centre + Vec2{std::cos(theta), std::sin(theta)} * r);
  }
  return out;
}

enum class PathType { kBezier, kLinear, kCatmull, kPerfect };

// Flattened path with cumulative lengths, trimmed/extended to expected length.
struct SliderPath {
  std::vector<Vec2> path;
  std::vector<double> cum_len;

  SliderPath(PathType type, const std::vector<Vec2>& control_points,
             double expected_distance, bool has_expected) {
    // split at duplicated anchors
    size_t start = 0;
    for (size_t i = 0; i < control_points.size(); ++i) {
      if (i + 1 == control_points.size() ||
          control_points[i] == control_points[i + 1]) {
        std::vector<Vec2> span(control_points.begin() + start,
                               control_points.begin() + i + 1);
        if (!span.empty()) {
          std::vector<Vec2> flat;
          switch (type) {
            case PathType::kLinear:
              flat = span;
              break;
            case PathType::kPerfect:
              if (control_points.size() != 3 || span.size() != 3) {
                flat = ApproximateBezier(span);
              } else {
                flat = ApproximateCircularArc(span);
                if (flat.empty()) flat = ApproximateBezier(span);
              }
              break;
            case PathType::kCatmull:
              flat = ApproximateCatmull(span);
              break;
            default:
              flat = ApproximateBezier(span);
          }
          for (const Vec2& p : flat) {
            if (path.empty() || !(path.back() == p)) path.push_back(p);
          }
        }
        start = i + 1;
      }
    }
    // cumulative lengths with trim/extend
    double length = 0;
    cum_len.push_back(0);
    for (size_t i = 0; i + 1 < path.size(); ++i) {
      const Vec2 diff = path[i + 1] - path[i];
      const double d = diff.norm();
      if (has_expected && expected_distance - length < d) {
        path[i + 1] = path[i] + diff * ((expected_distance - length) / d);
        path.resize(i + 2);
        length = expected_distance;
        cum_len.push_back(length);
        return;
      }
      length += d;
      cum_len.push_back(length);
    }
    if (has_expected && length < expected_distance && path.size() > 1) {
      const Vec2 diff = path.back() - path[path.size() - 2];
      const double d = diff.norm();
      if (d <= 0) return;
      path.back() =
          path.back() + diff * ((expected_distance - cum_len.back()) / d);
      cum_len.back() = expected_distance;
    }
  }

  double distance() const { return cum_len.empty() ? 0 : cum_len.back(); }

  Vec2 position_at(double progress) const {
    if (path.empty()) return {0, 0};
    const double d = std::clamp(progress, 0.0, 1.0) * distance();
    size_t i = std::lower_bound(cum_len.begin(), cum_len.end(), d) -
               cum_len.begin();
    if (i <= 0) return path.front();
    if (i >= path.size()) return path.back();
    const double d0 = cum_len[i - 1], d1 = cum_len[i];
    if (std::abs(d1 - d0) < 1e-12 * std::max(1.0, std::abs(d1))) return path[i - 1];
    const double w = (d - d0) / (d1 - d0);
    return path[i - 1] + (path[i] - path[i - 1]) * w;
  }
};

// ---------------------------------------------------------------------------
// .osu parsing (subset needed for featurization)
// ---------------------------------------------------------------------------

struct Parsed {
  double slider_multiplier = 1.4;
  std::vector<TimingPoint> timing_points;
  std::vector<HitObjectRow> rows;
};

std::vector<std::string> Split(const std::string& s, char delim) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    const size_t pos = s.find(delim, start);
    if (pos == std::string::npos) {
      out.push_back(s.substr(start));
      break;
    }
    out.push_back(s.substr(start, pos - start));
    start = pos + 1;
  }
  return out;
}

std::string Strip(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && std::isspace(static_cast<unsigned char>(s[b]))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(s[e - 1]))) --e;
  return s.substr(b, e - b);
}

double ToDouble(const std::string& s, double fallback = 0) {
  try {
    return std::stod(s);
  } catch (...) {
    return fallback;
  }
}

// strict full-token double, python float() semantics (hex rejected)
bool StrictDouble(const std::string& raw, double* out) {
  const std::string s = Strip(raw);
  if (s.empty() || s.find('x') != std::string::npos ||
      s.find('X') != std::string::npos) {
    return false;
  }
  try {
    size_t idx = 0;
    const double v = std::stod(s, &idx);
    if (idx != s.size()) return false;
    *out = v;
    return true;
  } catch (...) {
    return false;
  }
}

bool StrictFinite(const std::string& s, double* out) {
  return StrictDouble(s, out) && std::isfinite(*out);
}

// strict integer, python int() semantics; saturates instead of rejecting on
// overflow (python ints are unbounded; downstream range checks handle it)
bool StrictInt(const std::string& raw, long* out) {
  const std::string s = Strip(raw);
  size_t i = 0;
  if (i < s.size() && (s[i] == '+' || s[i] == '-')) ++i;
  if (i >= s.size()) return false;
  for (size_t j = i; j < s.size(); ++j) {
    if (!std::isdigit(static_cast<unsigned char>(s[j]))) return false;
  }
  errno = 0;
  long v = std::strtol(s.c_str(), nullptr, 10);
  if (errno == ERANGE) v = (s[0] == '-') ? std::numeric_limits<long>::min()
                                         : std::numeric_limits<long>::max();
  *out = v;
  return true;
}

bool ParseBoolToken(const std::string& s) {
  const std::string v = Strip(s);
  return v == "1" || v == "true" || v == "True";
}

// latest uninherited timing point with offset <= t (fallback: first uninherited)
double BeatLengthAt(const std::vector<TimingPoint>& tps, double t) {
  const TimingPoint* candidate = nullptr;
  for (const auto& tp : tps)
    if (tp.uninherited && tp.offset_ms <= t) candidate = &tp;
  if (!candidate)
    for (const auto& tp : tps)
      if (tp.uninherited) return tp.beat_length;
  return candidate ? candidate->beat_length : 500.0;
}

// latest timing point of any kind with offset <= t (fallback: first); the SV
// multiplier is -100/beat_length only for inherited negative points
double SvMultiplierAt(const std::vector<TimingPoint>& tps, double t) {
  const TimingPoint* candidate = nullptr;
  for (const auto& tp : tps)
    if (tp.offset_ms <= t) candidate = &tp;
  if (!candidate && !tps.empty()) candidate = &tps.front();
  if (candidate && !candidate->uninherited && candidate->beat_length < 0)
    return -100.0 / candidate->beat_length;
  return 1.0;
}

int RepeatType(long repeat) {
  if (repeat < 4) return static_cast<int>(repeat - 1);
  if (repeat % 2 == 0) return 3;
  return 4;
}

void AppendRow(std::vector<HitObjectRow>& rows, double time_ms, Vec2 pos,
               int type) {
  rows.push_back({pos.x, pos.y, time_ms, type});
}

// expand one slider into datapoint rows (parity: data_loading.py:65-109)
void ExpandSlider(std::vector<HitObjectRow>& rows, Vec2 head, double time_ms,
                  bool new_combo, PathType ptype, bool degraded_perfect,
                  const std::vector<Vec2>& points, long slides, double length,
                  double span_ms, double end_ms) {
  AppendRow(rows, time_ms, head, new_combo ? 5 : 4);
  const double duration = span_ms;  // one span
  const int n = static_cast<int>(points.size());

  if (ptype == PathType::kLinear) {
    for (int i = 1; i + 1 < n; ++i)
      AppendRow(rows, time_ms + double(i) / (n - 1) * duration, points[i], 9);
  } else if (ptype == PathType::kCatmull) {
    for (int i = 1; i + 1 < n; ++i)
      AppendRow(rows, time_ms + double(i) / (n - 1) * duration, points[i], 8);
  } else if (ptype == PathType::kPerfect && !degraded_perfect) {
    for (int i = 1; i + 1 < n; ++i)
      AppendRow(rows, time_ms + double(i) / (n - 1) * duration, points[i], 7);
  } else {  // (multi)bezier, incl. degraded perfect curves
    for (int i = 1; i + 1 < n; ++i) {
      const Vec2& pos = points[i];
      if (pos == points[i + 1]) {
        AppendRow(rows, time_ms + double(i) / (n - 1) * duration, pos, 9);
      } else if (!(pos == points[i - 1])) {
        AppendRow(rows, time_ms + double(i) / (n - 1) * duration, pos, 6);
      }
    }
  }

  AppendRow(rows, time_ms + duration, points.back(), 10);

  const PathType flatten_type = degraded_perfect ? PathType::kBezier : ptype;
  SliderPath path(flatten_type, points, length, /*has_expected=*/true);
  const Vec2 end_pos = path.position_at(1.0);
  AppendRow(rows, end_ms, end_pos, 11 + RepeatType(slides));
}

bool ParseBuffer(const char* data, size_t len, Parsed& out) {
  std::string text(data, len);
  std::string section;
  std::vector<std::string> hitobject_lines;

  size_t pos = 0;
  while (pos <= text.size()) {
    size_t eol = text.find('\n', pos);
    if (eol == std::string::npos) eol = text.size();
    std::string line = text.substr(pos, eol - pos);
    pos = eol + 1;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    const std::string stripped = Strip(line);
    if (stripped.empty() || stripped.rfind("//", 0) == 0) continue;
    if (stripped.front() == '[' && stripped.back() == ']') {
      section = stripped.substr(1, stripped.size() - 2);
      continue;
    }
    if (section == "Difficulty") {
      const size_t colon = stripped.find(':');
      if (colon != std::string::npos) {
        const std::string key = Strip(stripped.substr(0, colon));
        // strict: these scale every slider's duration (robustness spec);
        // other difficulty keys are cosmetic and ignored here
        if (key == "SliderMultiplier") {
          if (!StrictFinite(Strip(stripped.substr(colon + 1)),
                            &out.slider_multiplier)) {
            return false;
          }
        } else if (key == "SliderTickRate") {
          double tick_rate;  // unused by featurization; gate parity only
          if (!StrictFinite(Strip(stripped.substr(colon + 1)), &tick_rate)) {
            return false;
          }
        }
      }
    } else if (section == "TimingPoints") {
      auto parts = Split(stripped, ',');
      if (parts.size() < 2) continue;
      TimingPoint tp;
      // strict: offset/beat_length drive slider timing (robustness spec)
      if (!StrictFinite(parts[0], &tp.offset_ms) ||
          std::abs(tp.offset_ms) > kMaxTimeMs) {
        return false;
      }
      if (!StrictFinite(parts[1], &tp.beat_length) ||
          std::abs(tp.beat_length) > kMaxTimeMs) {
        return false;
      }
      tp.uninherited = parts.size() > 6 ? ParseBoolToken(parts[6])
                                        : tp.beat_length > 0;
      if (tp.uninherited && tp.beat_length <= 0) tp.uninherited = false;
      out.timing_points.push_back(tp);
    } else if (section == "HitObjects") {
      hitobject_lines.push_back(stripped);
    }
  }

  // sort-on-parse, in lockstep with the Python parser's _parse_timing_points
  // (shared robustness spec): stable so equal offsets keep file order. All
  // layers then agree on the governing timing point for out-of-order files.
  std::stable_sort(out.timing_points.begin(), out.timing_points.end(),
                   [](const TimingPoint& a, const TimingPoint& b) {
                     return a.offset_ms < b.offset_ms;
                   });

  for (const std::string& line : hitobject_lines) {
    auto parts = Split(line, ',');
    if (parts.size() < 5) continue;
    // strict fields -> reject the file on any malformed value, exactly like
    // the Python parser (robustness spec, file header comment)
    double x, y, time_ms;
    long type_long;
    if (!StrictFinite(parts[0], &x) || std::abs(x) > kMaxCoord) return false;
    if (!StrictFinite(parts[1], &y) || std::abs(y) > kMaxCoord) return false;
    if (!StrictFinite(parts[2], &time_ms) || std::abs(time_ms) > kMaxTimeMs)
      return false;
    if (!StrictInt(parts[3], &type_long)) return false;
    // two's-complement truncation to int32 via uint32 — the shared spec with
    // the Python side (parser.py _int32); a plain long->int narrowing of the
    // saturated value would be implementation-defined
    const int type_bits =
        static_cast<int32_t>(static_cast<uint32_t>(type_long));
    const bool new_combo = type_bits & 4;
    const Vec2 head{x, y};

    if (type_bits & 1) {  // circle
      AppendRow(out.rows, time_ms, head, new_combo ? 1 : 0);
    } else if (type_bits & 8) {  // spinner
      double end_time = time_ms;
      if (parts.size() > 5 &&
          (!StrictFinite(parts[5], &end_time) ||
           std::abs(end_time) > kMaxTimeMs)) {
        return false;
      }
      AppendRow(out.rows, time_ms, head, 2);
      AppendRow(out.rows, end_time, head, 3);
    } else if (type_bits & 2) {  // slider
      if (parts.size() < 6) return false;  // python: IndexError on parts[5]
      auto curve_parts = Split(parts[5], '|');
      const std::string kind = curve_parts.empty() ? "B" : curve_parts[0];
      std::vector<Vec2> points{head};
      for (size_t i = 1; i < curve_parts.size(); ++i) {
        if (curve_parts[i].empty()) continue;
        auto xy = Split(curve_parts[i], ':');
        double px, py;
        if (xy.size() != 2 || !StrictFinite(xy[0], &px) ||
            std::abs(px) > kMaxCoord || !StrictFinite(xy[1], &py) ||
            std::abs(py) > kMaxCoord) {
          return false;
        }
        points.push_back({px, py});
      }
      long slides = 1;
      if (parts.size() > 6 && !StrictInt(parts[6], &slides)) return false;
      if (slides < 1) return false;
      double length = 0;
      if (parts.size() > 7 &&
          (!StrictFinite(parts[7], &length) || length < 0 ||
           length > kMaxLength)) {
        return false;
      }

      // parity with data_loading.py:66 — very long sliders fall back to a
      // plain circle datapoint
      if (points.size() >= 100) {
        AppendRow(out.rows, time_ms, head, new_combo ? 1 : 0);
        continue;
      }

      // unknown curve kinds REJECT the file (shared spec: the Python side's
      // Curve.from_kind_and_points raises, objects.py:79-82 — silently
      // defaulting to bezier here would admit different training files on
      // machines with/without the native library)
      if (kind != "B" && kind != "L" && kind != "C" && kind != "P") return false;
      PathType ptype = PathType::kBezier;
      bool degraded_perfect = false;
      if (kind == "L")
        ptype = PathType::kLinear;
      else if (kind == "C")
        ptype = PathType::kCatmull;
      else if (kind == "P") {
        if (points.size() == 3) {
          ptype = PathType::kPerfect;
        } else {
          ptype = PathType::kBezier;  // osu! degrades non-3-point P to bezier
          degraded_perfect = false;   // handled as plain bezier
        }
      }

      const double beat_len = BeatLengthAt(out.timing_points, time_ms);
      const double sv = SvMultiplierAt(out.timing_points, time_ms);
      const double velocity = out.slider_multiplier * 100.0 * sv;  // px/beat
      const double span_ms = velocity > 0 ? length / velocity * beat_len : 0;
      const double end_ms = time_ms + span_ms * (double)slides;
      if (!std::isfinite(end_ms) || std::abs(end_ms) > kMaxTimeMs) return false;
      ExpandSlider(out.rows, head, time_ms, new_combo, ptype, degraded_perfect,
                   points, slides, length, span_ms, end_ms);
    }
  }
  return true;
}

}  // namespace

extern "C" {

int osu_featurize_buffer(const char* text, long len, float** out_data,
                         int* out_rows) {
  Parsed parsed;
  if (!ParseBuffer(text, static_cast<size_t>(len), parsed)) return 1;
  const int rows = static_cast<int>(parsed.rows.size());
  float* buf = static_cast<float*>(std::malloc(sizeof(float) * rows * kFeatureSize));
  if (!buf && rows > 0) return 2;
  std::memset(buf, 0, sizeof(float) * rows * kFeatureSize);
  for (int i = 0; i < rows; ++i) {
    const HitObjectRow& r = parsed.rows[i];
    float* row = buf + i * kFeatureSize;
    row[0] = static_cast<float>(r.x);
    row[1] = static_cast<float>(r.y);
    row[2] = static_cast<float>(r.time_ms);
    if (r.type >= 0 && r.type < 16) row[3 + r.type] = 1.0f;
  }
  *out_data = buf;
  *out_rows = rows;
  return 0;
}

int osu_featurize_file(const char* path, float** out_data, int* out_rows) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 3;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(static_cast<size_t>(size), '\0');
  const size_t read = std::fread(data.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  return osu_featurize_buffer(data.data(), static_cast<long>(read), out_data,
                              out_rows);
}

void osu_free(float* ptr) { std::free(ptr); }

}  // extern "C"
