"""A seeded synthetic NTU raw tree for `python -m agcn_tpu_torch.data.gen
sgn-raw`: `.skeleton` text files and the five statistics tables
(`skes_available_name`, `label`, `performer`, `camera`,
`samples_with_missing_skeletons`).

The samples cycle through `SCENARIOS`, so that every decision of the SGN
denoising chain (data/gen/sgn_raw.py) is taken: one, two and three or
more bodies; frames with no body; a body of at most 11 frames (the length
filter) and a sample whose bodies are all that short (the longest is
kept); a body wider than 0.8 of its height on most frames (the spread
filter drops it) and one on a few frames (its motion is recomputed over
the rest); a body that leaves and comes back (the reference chains its
frames into one block); bodies one after another in time (packed into one
actor slot); two bodies of exactly equal motion (the order of first
appearance breaks the tie). Every body has its own ID. Subjects and
cameras put samples on both sides of the CS and CV splits; one listed
sample is named in `samples_with_missing_skeletons` and has no file.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

BODY_ID = 72057594037931101
SCENARIOS = ("one", "two", "three", "empty_frames", "short", "wide",
             "returns", "sequential", "all_short", "tie", "four")


def _body(rng: np.random.Generator, frames: int, wide: float = 0.0
          ) -> np.ndarray:
    """(frames, 25, 3) joints of a standing body that moves: x spread
    ~0.3 m, y spread ~1.2 m (narrower than tall), at depth ~3 m; on a
    `wide` share of its frames it is stretched along x (x spread > 0.8 y
    spread)."""
    pose = np.stack([rng.uniform(-0.15, 0.15, 25), rng.uniform(-0.6, 0.6, 25),
                     rng.uniform(-0.1, 0.1, 25)], -1)
    pose[:, 2] += 3.0 + rng.uniform(-0.5, 0.5)
    pose[:, 0] += rng.uniform(-1.0, 1.0)
    t = np.arange(frames)[:, None, None]
    phase = rng.uniform(0, 2 * np.pi, (1, 25, 3))
    joints = (pose[None] + 0.05 * np.sin(0.2 * t + phase)
              + 0.005 * rng.standard_normal((frames, 25, 3)))
    if wide:
        stretched = rng.random(frames) < wide
        joints[stretched, :, 0] *= 12.0
    return joints


def _frames(case: str, rng: np.random.Generator
            ) -> List[List[Tuple[int, np.ndarray]]]:
    """Per raw frame, its (body id, (25, 3) joints) list."""
    n = int(rng.integers(40, 121))
    tracks: Dict[int, Dict[int, np.ndarray]] = {}

    def put(bid: int, start: int, joints: np.ndarray,
            skip: Tuple[int, int] = (0, 0)) -> None:
        for i, j in enumerate(joints):
            if not skip[0] <= i < skip[1]:
                tracks.setdefault(start + i, {})[bid] = j

    if case == "one":
        put(0, 0, _body(rng, n))
    elif case in ("two", "four"):
        for b in range(2 if case == "two" else 4):
            start = int(rng.integers(0, 8))
            put(b, start, _body(rng, n - start))
    elif case == "three":
        put(0, 0, _body(rng, n))
        put(1, 5, _body(rng, n - 20))
        put(2, n // 2, _body(rng, n - n // 2))
    elif case == "empty_frames":  # none at the start, middle and end
        put(0, 3, _body(rng, n - 6), skip=(20, 24))
        put(1, 3, _body(rng, n - 6), skip=(20, 24))
    elif case == "short":
        put(0, 0, _body(rng, n))
        put(1, 20, _body(rng, int(rng.integers(3, 12))))
        put(2, 2, _body(rng, n - 4))
    elif case == "wide":
        put(0, 0, _body(rng, n, wide=0.9))
        put(1, 0, _body(rng, n, wide=0.2))
        put(2, 4, _body(rng, n - 4))
    elif case == "returns":
        put(0, 0, _body(rng, n))
        put(1, 0, _body(rng, n), skip=(n // 3, n // 3 + 12))
    elif case == "sequential":
        put(0, 0, _body(rng, n // 2 - 2))
        put(1, n // 2, _body(rng, n - n // 2))
        put(2, 0, _body(rng, n))
    elif case == "all_short":
        put(0, 0, _body(rng, 9))
        put(1, 9, _body(rng, 11))
    elif case == "tie":
        joints = _body(rng, n)
        put(0, 0, joints)
        # negation keeps every axis's variance bit for bit: equal motions
        put(1, 0, -joints)
        put(2, 0, _body(rng, n))
    frames = []
    last = max(tracks) + 1
    for f in range(last + int(case == "empty_frames") * 3):
        frames.append(sorted(tracks.get(f, {}).items()))
    return frames


def skeleton_text(frames: List[List[Tuple[int, np.ndarray]]],
                  id_base: int) -> str:
    """NTU `.skeleton` text: per frame its body count, then per body the
    ID line, 25, and 25 rows of x y z, depth xy, color xy, orientation
    and state."""
    lines = [str(len(frames))]
    for frame in frames:
        lines.append(str(len(frame)))
        for bid, joints in frame:
            lines += [f"{id_base + bid} 0 1 1 1 1 0 0.1 0.2 2", "25"]
            lines += [f"{x:.6f} {y:.6f} {z:.6f} 250.5 200.5 {x * 300:.4f} "
                      f"{y * 300:.4f} 0.1 0.2 0.3 0.9 2"
                      for x, y, z in joints]
    return "\n".join(lines) + "\n"


def write_sgn_raw_tree(root: str, samples: int = 48, seed: int = 0
                       ) -> Tuple[str, str, List[str]]:
    """Writes `root/statistics/*.txt` and `root/raw/*.skeleton`; returns
    (the statistics dir, the skeleton dir, the names of the samples kept:
    those not listed as missing)."""
    rng = np.random.default_rng(seed)
    stat_dir, raw_dir = (os.path.join(root, d)
                         for d in ("statistics", "raw"))
    os.makedirs(stat_dir, exist_ok=True)
    os.makedirs(raw_dir, exist_ok=True)
    names, labels, subjects, cameras = [], [], [], []
    for i in range(samples):
        camera = i % 3 + 1
        subject = (1, 2, 3, 4, 6, 7, 8, 9)[i % 8]
        label = i % 5 + 1
        name = (f"S{i // 16 + 1:03d}C{camera:03d}P{subject:03d}"
                f"R{i % 2 + 1:03d}A{label:03d}")
        names.append(name)
        labels.append(label)
        subjects.append(subject)
        cameras.append(camera)
    missing = names[-1]
    for i, name in enumerate(names[:-1]):
        case = SCENARIOS[i % len(SCENARIOS)]
        text = skeleton_text(_frames(case, rng), BODY_ID + 10 * i)
        with open(os.path.join(raw_dir, name + ".skeleton"), "w") as f:
            f.write(text)
    for fname, column in (("skes_available_name.txt", names),
                          ("label.txt", labels),
                          ("performer.txt", subjects),
                          ("camera.txt", cameras),
                          ("samples_with_missing_skeletons.txt", [missing])):
        with open(os.path.join(stat_dir, fname), "w") as f:
            f.write("".join(f"{v}\n" for v in column))
    return stat_dir, raw_dir, names[:-1]
