"""Plain comparisons that decide `correct`, beside the reference's own.

- A written map against the samples it was decoded from: every circle's
  position is the sample's, scaled to the playfield and rounded.
- A map's featurized rows against the map file's hit objects, read here
  by a plain parse: each circle's row, each spinner's two rows and each
  slider head's row carry the file's position, time and type; a slider
  takes one row a control point between its ends (a bezier's repeated
  point once, as a red anchor; one equal to the point before it none) and
  two more, which need the curve and are not compared.
- The context the sampler conditions on, worked out from a map's rows.
- Train state compared by the worst leaf, or the median leaf.
- The numbers compared beside their limits, and whether all keep to them.
"""
from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from benchmarks.reference.model import FIRST_FREQ, PLAYFIELD, sinusoid

CENTER = (256.0, 192.0)


def hit_object_lines(text: str) -> list[list[str]]:
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.strip() == "[HitObjects]") + 1
    return [line.split(",") for line in lines[start:] if line.strip()]


def decode_mismatches(path: str, rows: np.ndarray, samples: np.ndarray) -> int:
    """Circles whose written position is not the sample's (a missing or an
    extra circle counts as one each)."""
    with open(path) as f:
        written = [(int(p[0]), int(p[1])) for p in hit_object_lines(f.read()) if int(p[3]) & 1]
    types = rows[:, 3:].argmax(axis=1)
    want = [(int(round(float(samples[j, 0] * np.float32(PLAYFIELD[0])))),
             int(round(float(samples[j, 1] * np.float32(PLAYFIELD[1])))))
            for j in range(len(rows)) if types[j] in (0, 1)]
    return sum(a != b for a, b in zip(written, want)) + abs(len(written) - len(want))


def _slider_interior(head: tuple[int, int], curve: str) -> int:
    kind, *cps = curve.split("|")
    points = [head] + [tuple(int(v) for v in cp.split(":")) for cp in cps]
    if kind != "B":
        return max(0, len(points) - 2)
    return sum(1 for i in range(1, len(points) - 1)
               if points[i] == points[i + 1] or points[i] != points[i - 1])


def expected_rows(text: str) -> tuple[list[tuple[int, tuple]], int]:
    """((row index, (x, y, time, type)) of each checkable row, rows in all)."""
    want, at = [], 0
    for p in hit_object_lines(text):
        x, y, t, bits = int(p[0]), int(p[1]), int(p[2]), int(p[3])
        combo = bool(bits & 4)
        if bits & 8:  # spinner
            want += [(at, (x, y, t, 2)), (at + 1, (x, y, int(p[5]), 3))]
            at += 2
        elif bits & 2:  # slider
            want.append((at, (x, y, t, 5 if combo else 4)))
            at += 1 + _slider_interior((x, y), p[5]) + 2
        else:
            want.append((at, (x, y, t, 1 if combo else 0)))
            at += 1
    return want, at


def featurize_mismatches(map_path: str, rows: np.ndarray) -> int:
    """Checkable rows whose position, time or type is not the file's, plus
    one if the map has fewer rows than were featurized."""
    with open(map_path) as f:
        want, total = expected_rows(f.read())
    bad = int(total < len(rows))
    for at, (x, y, t, kind) in want:
        if at >= len(rows):
            break
        r = rows[at]
        bad += (r[0] != x or r[1] != y or r[2] != t or int(r[3:].argmax()) != kind or r[3 + kind] != 1.0)
    return int(bad)


def sample_context(rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (T,), c (T, 144)) of a map's rows: ms from the first point; the
    128-wide sinusoid of each point's distance from the one before (the
    playfield's center before the first) beside the type one-hots."""
    xy = rows[:, :2]
    prev = torch.cat([torch.tensor([CENTER], dtype=rows.dtype, device=rows.device), xy[:-1]])
    dist = torch.sqrt(((xy - prev) ** 2).sum(dim=-1))
    return rows[:, 2] - rows[0, 2], torch.cat([sinusoid(dist, FIRST_FREQ), rows[:, 3:]], dim=-1)


PACKED = ("attn.in_proj_weight", "attn.in_proj_bias")  # [q | k | v] along the first axis


def leaf_norms(tensors: dict) -> dict:
    """Each leaf's norm; a packed attention projection's q, k and v parts
    count as leaves of their own (the key's bias has no gradient under the
    softmax, and moves under Adam by round-off alone)."""
    out = {}
    for name, t in tensors.items():
        t = t.detach().float()
        if name.endswith(PACKED):
            for part, chunk in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}[{part}]"] = float(chunk.norm())
        else:
            out[name] = float(t.norm())
    return out


def relative_gaps(diffs: dict, ref: dict, counted: list[str]) -> dict:
    """Each counted leaf's gap `diffs[leaf]` over the larger of the
    reference's norm of that leaf and the median leaf's."""
    med = statistics.median(ref[k] for k in counted)
    return {k: diffs[k] / max(ref[k], med, 1e-30) for k in counted}


def worst_of(gaps: dict) -> tuple[float, str]:
    """The largest gap and its leaf (inf where one is not finite)."""
    worst, name = 0.0, ""
    for k, gap in gaps.items():
        if not math.isfinite(gap):
            return math.inf, k
        if gap > worst:
            worst, name = gap, k
    return worst, name


def median_of(gaps: dict) -> tuple[float, str]:
    ordered = sorted((gap, k) for k, gap in gaps.items())
    return ordered[len(ordered) // 2]


def worst_leaf(prog: dict, ref: dict, counted: list[str]) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and the median leaf's."""
    return worst_of(relative_gaps({k: abs(prog[k] - ref[k]) for k in counted}, ref, counted))


def median_leaf(prog: dict, ref: dict, counted: list[str]) -> tuple[float, str]:
    """The median over leaves of the same gap as `worst_leaf`'s."""
    return median_of(relative_gaps({k: abs(prog[k] - ref[k]) for k in counted}, ref, counted))


def leaf_diffs(prog: dict, ref: dict) -> dict:
    """Each leaf's norm of `prog[leaf] - ref[leaf]`, the leaves split as
    `leaf_norms` splits them; a program's tensor is brought to the
    reference's device one leaf at a time."""
    out = {}
    for k, r in ref.items():
        out.update(leaf_norms({k: prog[k].to(r.device).float() - r.float()}))
    return out


def counted_leaves(ref_grad: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is at least `share` of the median
    leaf's: below it a leaf moves under Adam by round-off alone."""
    med = statistics.median(ref_grad.values())
    return [k for k, g in ref_grad.items() if g >= share * med]


def compare(found: dict, limits: dict) -> list[dict]:
    """Each number that `limits` names beside its limit (inf where the run
    read none)."""
    return [{"name": name, "value": float(found.get(name, math.inf)), "limit": float(limit)}
            for name, limit in limits.items()]


def keeps(compared: list[dict]) -> bool:
    """`correct`: something was compared and every number is within its
    limit (NaN is not)."""
    return bool(compared) and all(c["value"] <= c["limit"] for c in compared)
