"""Slider curve flattening and arc-length parameterization.

Independent numpy implementation of the osu!(lazer) path algorithms the game
itself uses (the reference ports the same algorithms in
export/path_approximator.py and export/slider_path.py — cited here for parity
checking, not copied):

- adaptive bezier subdivision with flatness tolerance 0.25
  (ref export/path_approximator.py:11-80,172-221)
- Catmull-Rom with 50 samples per segment (ref :83-96,224-253)
- circular arc through 3 points, tolerance 0.1, bezier fallback (ref :99-160)
- piecewise-linear (ref :163-169)
- arc-length tables with trim/extend to an expected pixel length
  (ref export/slider_path.py:143-184)

These run host-side (decode/export is not a hot path); they are load-bearing
for output parity, so the numerics match the lazer algorithms exactly.
"""
from __future__ import annotations

import numpy as np

BEZIER_TOLERANCE = 0.25
CATMULL_DETAIL = 50
CIRCULAR_ARC_TOLERANCE = 0.1
# hard bound on adaptive-subdivision work per span: pathological control
# points (huge magnitudes from fuzzed files or unclamped model outputs) must
# terminate, not hang a loader worker. Mirrored by native/osu_native.cpp —
# both implementations pop the same LIFO order, so outputs stay identical.
MAX_BEZIER_SUBDIVISIONS = 65536


# ---------------------------------------------------------------------------
# flatteners
# ---------------------------------------------------------------------------


def _bezier_flat_enough(cp: np.ndarray) -> bool:
    # second differences bounded by 4*tol^2 (lazer's flatness criterion).
    # NaNs compare False against the threshold and so count as FLAT — this
    # matches the native kernel's `if (dot > tol) return false` form and
    # guarantees termination on non-finite inputs.
    if len(cp) < 3:
        return True
    second = cp[:-2] - 2.0 * cp[1:-1] + cp[2:]
    return not bool(
        (np.einsum("ij,ij->i", second, second) > BEZIER_TOLERANCE**2 * 4).any()
    )


def _bezier_subdivide(cp: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """de Casteljau split at t=0.5 -> (left, right) halves."""
    n = len(cp)
    mid = cp.copy()
    left = np.empty_like(cp)
    right = np.empty_like(cp)
    for i in range(n):
        left[i] = mid[0]
        right[n - i - 1] = mid[n - i - 1]
        mid[: n - i - 1] = (mid[: n - i - 1] + mid[1 : n - i]) / 2.0
    return left, right


def _bezier_emit(cp: np.ndarray, out: list[np.ndarray]) -> None:
    """Emit the flat-enough segment's sample points (lazer's scheme: endpoints of
    the two half-curves' shared control polygon, averaged 1-2-1)."""
    n = len(cp)
    left, right = _bezier_subdivide(cp)
    merged = np.concatenate([left, right[1:]], axis=0)
    out.append(cp[0].copy())
    for i in range(1, n - 1):
        idx = 2 * i
        out.append(0.25 * (merged[idx - 1] + 2.0 * merged[idx] + merged[idx + 1]))


def approximate_bezier(control_points: np.ndarray) -> list[np.ndarray]:
    """Adaptive subdivision of one bezier span into a piecewise-linear path."""
    cp = np.asarray(control_points, dtype=float)
    n = len(cp) - 1
    if n < 0:
        return []
    output: list[np.ndarray] = []
    stack = [cp.copy()]
    pops = 0
    while stack:
        parent = stack.pop()
        pops += 1
        if pops > MAX_BEZIER_SUBDIVISIONS or _bezier_flat_enough(parent):
            _bezier_emit(parent, output)
            continue
        left, right = _bezier_subdivide(parent)
        stack.append(right)
        stack.append(left)
    output.append(cp[n].copy())
    return output


def approximate_catmull(control_points: np.ndarray) -> list[np.ndarray]:
    """Catmull-Rom spline, CATMULL_DETAIL samples per segment (each sample pair
    duplicated at segment boundaries, matching lazer)."""
    cp = np.asarray(control_points, dtype=float)
    result: list[np.ndarray] = []
    m = len(cp)
    for i in range(m - 1):
        v1 = cp[i - 1] if i > 0 else cp[i]
        v2 = cp[i]
        v3 = cp[i + 1] if i < m - 1 else v2 + v2 - v1
        v4 = cp[i + 2] if i < m - 2 else v3 + v3 - v2
        ts = np.arange(CATMULL_DETAIL + 1) / CATMULL_DETAIL
        pts = _catmull_points(v1, v2, v3, v4, ts)  # (detail+1, 2)
        for c in range(CATMULL_DETAIL):
            result.append(pts[c])
            result.append(pts[c + 1])
    return result


def _catmull_points(v1, v2, v3, v4, ts: np.ndarray) -> np.ndarray:
    t = ts[:, None]
    t2 = t * t
    t3 = t2 * t
    return 0.5 * (
        2.0 * v2
        + (-v1 + v3) * t
        + (2.0 * v1 - 5.0 * v2 + 4.0 * v3 - v4) * t2
        + (-v1 + 3.0 * v2 - 3.0 * v3 + v4) * t3
    )


def approximate_circular_arc(control_points: np.ndarray) -> list[np.ndarray]:
    """Arc through 3 points; empty list signals degenerate -> caller falls back
    to bezier (same contract as lazer / ref slider_path.py:103-111)."""
    a, b, c = (np.asarray(p, dtype=float) for p in control_points[:3])
    if not (np.isfinite(a).all() and np.isfinite(b).all() and np.isfinite(c).all()):
        return []  # degenerate -> bezier fallback (which handles non-finite)
    a_sq = float(np.dot(b - c, b - c))
    b_sq = float(np.dot(a - c, a - c))
    c_sq = float(np.dot(a - b, a - b))
    if np.isclose(a_sq, 0) or np.isclose(b_sq, 0) or np.isclose(c_sq, 0):
        return []
    s = a_sq * (b_sq + c_sq - a_sq)
    t = b_sq * (a_sq + c_sq - b_sq)
    u = c_sq * (a_sq + b_sq - c_sq)
    total = s + t + u
    if np.isclose(total, 0):
        return []
    centre = (s * a + t * b + u * c) / total
    d_a = a - centre
    d_c = c - centre
    r = float(np.linalg.norm(d_a))
    theta_start = np.arctan2(d_a[1], d_a[0])
    theta_end = np.arctan2(d_c[1], d_c[0])
    while theta_end < theta_start:
        theta_end += 2 * np.pi
    direction = 1.0
    theta_range = theta_end - theta_start
    ortho = np.array([(c - a)[1], -(c - a)[0]])
    if np.dot(ortho, b - a) < 0:
        direction = -1.0
        theta_range = 2 * np.pi - theta_range
    if 2 * r <= CIRCULAR_ARC_TOLERANCE:
        n_points = 2
    else:
        # capped: near-collinear points yield astronomically large radii and
        # the uncapped lazer formula would allocate millions of points; at the
        # cap the arc is sub-pixel-indistinguishable from a line anyway
        # (mirrored by native/osu_native.cpp)
        raw = np.ceil(theta_range / (2 * np.arccos(1 - CIRCULAR_ARC_TOLERANCE / r)))
        n_points = 32768 if not np.isfinite(raw) else max(2, min(32768, int(raw)))
    fracs = np.arange(n_points) / (n_points - 1)
    thetas = theta_start + direction * fracs * theta_range
    pts = centre + r * np.stack([np.cos(thetas), np.sin(thetas)], axis=-1)
    return [p for p in pts]


def approximate_linear(control_points: np.ndarray) -> list[np.ndarray]:
    return [np.array(p, dtype=float) for p in control_points]


# ---------------------------------------------------------------------------
# arc-length engine
# ---------------------------------------------------------------------------


class SliderPath:
    """Flattened slider path with a cumulative-length table.

    path_type in {"Bezier", "PerfectCurve", "Catmull", "Linear"}; control points
    may contain duplicated anchors, which split the path into sub-spans (the
    red-anchor convention). If `expected_distance` is given, the path is trimmed
    or linearly extended to exactly that pixel length (ref slider_path.py:143-184).
    """

    def __init__(
        self,
        path_type: str,
        control_points: np.ndarray,
        expected_distance: float | None = None,
    ) -> None:
        self.path_type = path_type
        self.control_points = np.asarray(control_points, dtype=float)
        self.expected_distance = expected_distance
        self.calculated_path: list[np.ndarray] = []
        self.cumulative_length: list[float] = []
        self._calculate_path()
        self._calculate_cumulative_length()

    # -- construction --------------------------------------------------------

    def _sub_spans(self):
        cp = self.control_points
        start = 0
        for i in range(len(cp)):
            if i == len(cp) - 1 or (cp[i] == cp[i + 1]).all():
                yield cp[start : i + 1]
                start = i + 1

    def _flatten_span(self, span: np.ndarray) -> list[np.ndarray]:
        if self.path_type == "Linear":
            return approximate_linear(span)
        if self.path_type == "PerfectCurve":
            if len(self.control_points) != 3 or len(span) != 3:
                return approximate_bezier(span)
            arc = approximate_circular_arc(span)
            return arc if arc else approximate_bezier(span)
        if self.path_type == "Catmull":
            return approximate_catmull(span)
        return approximate_bezier(span)

    def _calculate_path(self) -> None:
        self.calculated_path = []
        for span in self._sub_spans():
            if len(span) == 0:
                continue
            for pt in self._flatten_span(span):
                if not self.calculated_path or (self.calculated_path[-1] != pt).any():
                    self.calculated_path.append(np.asarray(pt, dtype=float))

    def _calculate_cumulative_length(self) -> None:
        length = 0.0
        self.cumulative_length = [length]
        path = self.calculated_path
        i = 0
        while i < len(path) - 1:
            diff = path[i + 1] - path[i]
            d = float(np.linalg.norm(diff))
            if self.expected_distance is not None and self.expected_distance - length < d:
                # trim: move the next vertex onto the expected end and drop the rest
                path[i + 1] = path[i] + diff * (self.expected_distance - length) / d
                del path[i + 2 :]
                length = float(self.expected_distance)
                self.cumulative_length.append(length)
                return
            length += d
            self.cumulative_length.append(length)
            i += 1
        if (
            self.expected_distance is not None
            and length < self.expected_distance
            and len(path) > 1
        ):
            # extend the last segment linearly to reach the expected length
            diff = path[-1] - path[-2]
            d = float(np.linalg.norm(diff))
            if d <= 0:
                return
            path[-1] = path[-1] + diff * (self.expected_distance - self.cumulative_length[-1]) / d
            self.cumulative_length[-1] = float(self.expected_distance)

    # -- queries -------------------------------------------------------------

    def get_distance(self) -> float:
        return 0.0 if not self.cumulative_length else self.cumulative_length[-1]

    def _progress_to_distance(self, progress: float) -> float:
        return float(np.clip(progress, 0, 1)) * self.get_distance()

    def _index_of_distance(self, d: float) -> int:
        return int(np.searchsorted(np.asarray(self.cumulative_length), d, side="left"))

    def _interpolate(self, i: int, d: float) -> np.ndarray:
        path = self.calculated_path
        if not path:
            return np.zeros(2)
        if i <= 0:
            return path[0]
        if i >= len(path):
            return path[-1]
        d0, d1 = self.cumulative_length[i - 1], self.cumulative_length[i]
        if np.isclose(d0, d1):
            return path[i - 1]
        w = (d - d0) / (d1 - d0)
        return path[i - 1] + (path[i] - path[i - 1]) * w

    def position_at(self, progress: float) -> np.ndarray:
        d = self._progress_to_distance(progress)
        return self._interpolate(self._index_of_distance(d), d)

    def get_path_to_progress(self, path: list, p0: float, p1: float) -> None:
        """Fill `path` with the vertices between progresses p0 and p1 (inclusive
        interpolated endpoints). Same contract as ref slider_path.py:61-79."""
        d0 = self._progress_to_distance(p0)
        d1 = self._progress_to_distance(p1)
        path.clear()
        i = 0
        while i < len(self.calculated_path) and self.cumulative_length[i] < d0:
            i += 1
        path.append(self._interpolate(i, d0))
        while i < len(self.calculated_path) and self.cumulative_length[i] < d1:
            path.append(self.calculated_path[i])
            i += 1
        path.append(self._interpolate(i, d1))
