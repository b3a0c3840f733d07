"""The request generators: a traffic file's parameters and a seed in, a
deterministic stream of server requests or demo sessions out.

Every random property is drawn in stratified blocks: each block holds the
stated mix exactly (sizes in their stated proportions, every attribute
once, the stated share of posed requests, each kind of key) and only the
order within a block comes from the seed.  So every seed offers the same
work, in another order, and the window's count of photos does not swing
with the seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class Request:
    index: int
    photos: np.ndarray  # indices into the photo pool: one contiguous run
    attribute: str
    value: np.ndarray  # (1 or n, input width) float32
    rotations: Optional[np.ndarray]  # (n, 3) float32 radians, or None for the encoder's pose

    @property
    def rows(self) -> slice:
        """The request's photos as a slice of the pool (a view, no copy)."""
        return slice(int(self.photos[0]), int(self.photos[-1]) + 1)


def _blocks(rng: np.random.Generator, block: Sequence[Any]) -> Iterator[Any]:
    """The items of ``block`` forever, each pass in a fresh order."""
    block = list(block)
    while True:
        for i in rng.permutation(len(block)):
            yield block[i]


def size_block(spec: Dict[str, Any]) -> List[int]:
    """One block of photos-per-request: ``{"values", "weights"}`` repeats
    each value its (whole) weight times; ``{"uniform": [lo, hi], "strata"}``
    takes the midpoint of each of ``strata`` equal slices of [lo, hi]."""
    if "values" in spec:
        return [int(v) for v, w in zip(spec["values"], spec["weights"]) for _ in range(int(w))]
    lo, hi = spec["uniform"]
    n = int(spec["strata"])
    return [int(round(lo + (hi - lo) * (i + 0.5) / n)) for i in range(n)]


def poses(rng: np.random.Generator, n: int, ranges_deg) -> np.ndarray:
    """Uniform head poses within ``ranges_deg`` ((lo, hi) per axis), radians."""
    ranges = np.asarray(ranges_deg, np.float64) * math.pi / 180.0
    u = rng.random((n, 3))
    return (ranges[:, 0] + u * (ranges[:, 1] - ranges[:, 0])).astype(np.float32)


def serve_requests(traffic: Dict[str, Any], input_widths: Dict[str, int],
                   seed: int) -> Iterator[Request]:
    """The serving requests of one run.  ``input_widths``: each face-model
    attribute's input width (the value row's width).  A request's photos are
    a contiguous run of the pool, as a batch job passes a slice of its
    data set (no gather on the host)."""
    order = np.random.default_rng([seed, 0])
    draws = np.random.default_rng([seed, 1])
    sizes = _blocks(order, size_block(traffic["photos_per_request"]))
    attributes = _blocks(order, sorted(input_widths))
    given, of = traffic["rotations_share"]
    posed = _blocks(order, [True] * int(given) + [False] * (int(of) - int(given)))
    per_photo = traffic["value_rows"] == "per_photo"
    pool = int(traffic["photo_pool"])
    index = 0
    while True:
        n, attribute, with_pose = next(sizes), next(attributes), next(posed)
        first = int(draws.integers(0, pool - n + 1))
        photos = np.arange(first, first + n)
        value = draws.standard_normal((n if per_photo else 1, input_widths[attribute]))
        rotations = poses(draws, n, traffic["pose_ranges_deg"]) if with_pose else None
        yield Request(index, photos, attribute, value.astype(np.float32), rotations)
        index += 1


def warm_requests(traffic: Dict[str, Any], input_widths: Dict[str, int]) -> List[Request]:
    """One request of each call shape the traffic sends: every attribute, on
    each pipeline it uses (broadcast rows: the encoder's pose and given
    poses; per-photo rows: one whole chunk)."""
    given, of = traffic["rotations_share"]
    pipelines = ([False] if int(given) < int(of) else []) + ([True] if int(given) > 0 else [])
    per_photo = traffic["value_rows"] == "per_photo"
    n = int(traffic["chunk"]) if per_photo else 1
    rng = np.random.default_rng(0)
    out = []
    for attribute in sorted(input_widths):
        for with_pose in pipelines:
            value = rng.standard_normal((n if per_photo else 1, input_widths[attribute]))
            rotations = poses(rng, n, traffic["pose_ranges_deg"]) if with_pose else None
            out.append(Request(-1, np.arange(n), attribute, value.astype(np.float32), rotations))
    return out


@dataclass
class Session:
    """One sitting at the demo: the photos of its grid (indices into the
    pool), its frame count, and the key pressed after each frame that has
    one: ``events[frame] = (kind, argument)`` with kind ``edit`` (a new
    value row for the controlled attribute), ``pose`` or ``gaze`` ((axis,
    sign) of a nudge) or ``cycle`` (+1 or -1 through the attributes)."""
    index: int
    photos: np.ndarray
    frames: int
    events: Dict[int, Any]
    checked: List[int]  # frames whose renders the reference checks

    def __len__(self) -> int:
        return len(self.photos)


def demo_sessions(traffic: Dict[str, Any], attributes: Dict[str, int], seed: int,
                  n_checked: int = 0) -> Iterator[Session]:
    """The demo sessions of one run.  ``attributes``: the attributes the
    demo cycles through (name: input width), in the demo's order.  Session
    sizes and key kinds come in stratified blocks, so every seed offers the
    same work; which photos, values, axes and signs come from the seed.
    ``n_checked`` frames of each session (its first among them) are marked
    for the check."""
    order = np.random.default_rng([seed, 0])
    draws = np.random.default_rng([seed, 1])
    sizes = _blocks(order, size_block(traffic["photos_per_session"]))
    kinds = _blocks(order, list(traffic["key_block"]))
    frames, every = int(traffic["frames_per_session"]), int(traffic["key_every"])
    names = list(attributes)
    index = 0
    while True:
        n = next(sizes)
        photos = draws.integers(0, int(traffic["photo_pool"]), n)
        events: Dict[int, Any] = {}
        attribute = 0
        for frame in range(every - 1, frames, every):
            kind = next(kinds)
            if kind == "edit":
                events[frame] = (kind, draws.standard_normal(
                    (1, attributes[names[attribute]])).astype(np.float32))
            elif kind in ("pose", "gaze"):
                events[frame] = (kind, (int(draws.integers(0, 2)), float(draws.choice([-1, 1]))))
            elif kind == "cycle":
                step = int(draws.choice([-1, 1]))
                attribute = (attribute + step) % len(names)
                events[frame] = (kind, step)
            else:
                raise ValueError(f"unknown key kind {kind!r}")
        later = draws.choice(np.arange(1, frames), max(n_checked - 1, 0), replace=False)
        checked = sorted([0] + later.tolist())[:n_checked]
        yield Session(index, photos, frames, events, checked)
        index += 1


class Reservoir:
    """A uniform sample of ``size`` finished requests, drawn from the seed
    (reservoir sampling), and the longest finished request beside it."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = np.random.default_rng([seed, 2])
        self.kept: Dict[int, Any] = {}
        self.longest: Optional[Any] = None
        self.seen = 0

    def offer(self, request: Request, output: np.ndarray) -> None:
        item = (request, output)
        if self.seen < self.size:
            self.kept[self.seen] = item
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1
        if self.longest is None or len(request.photos) > len(self.longest[0].photos):
            self.longest = item

    def sample(self) -> List[Any]:
        items = {r.index: (r, o) for r, o in self.kept.values()}
        if self.longest is not None:
            items[self.longest[0].index] = self.longest
        return [items[k] for k in sorted(items)]
