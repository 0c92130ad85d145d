"""Skeleton graph registry (copy of agcn_tpu/graph/skeletons.py).

Edges are stored as (child, parent) pairs in 0-indexed "inward"
orientation: the first joint is farther from the skeleton center, the
second is its neighbor toward the center. The port keeps its own copy so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

Edge = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Skeleton:
    """A named skeleton topology: V joints, inward edges, center joint."""

    name: str
    num_joints: int
    inward: Tuple[Edge, ...]
    center: int

    @property
    def outward(self) -> Tuple[Edge, ...]:
        return tuple((j, i) for (i, j) in self.inward)

    @property
    def neighbor(self) -> Tuple[Edge, ...]:
        return self.inward + self.outward

    @property
    def self_loops(self) -> Tuple[Edge, ...]:
        return tuple((i, i) for i in range(self.num_joints))


# NTU RGB+D joint layout (0-indexed):
#  0 base-spine, 1 mid-spine, 2 neck, 3 head, 4 l-shoulder, 5 l-elbow,
#  6 l-wrist, 7 l-hand, 8 r-shoulder, 9 r-elbow, 10 r-wrist, 11 r-hand,
# 12 l-hip, 13 l-knee, 14 l-ankle, 15 l-foot, 16 r-hip, 17 r-knee,
# 18 r-ankle, 19 r-foot, 20 shoulder-spine, 21 l-hand-tip, 22 l-thumb,
# 23 r-hand-tip, 24 r-thumb
NTU_RGBD_25 = Skeleton(
    name="ntu_rgb_d",
    num_joints=25,
    inward=(
        (0, 1), (1, 20), (2, 20), (3, 2), (4, 20), (5, 4), (6, 5), (7, 6),
        (8, 20), (9, 8), (10, 9), (11, 10), (12, 0), (13, 12), (14, 13),
        (15, 14), (16, 0), (17, 16), (18, 17), (19, 18), (21, 22), (22, 7),
        (23, 24), (24, 11),
    ),
    center=20,
)

# OpenPose 18-joint layout used by Kinetics-Skeleton
KINETICS_18 = Skeleton(
    name="kinetics",
    num_joints=18,
    inward=(
        (4, 3), (3, 2), (7, 6), (6, 5), (13, 12), (12, 11), (10, 9), (9, 8),
        (11, 5), (8, 2), (5, 1), (2, 1), (0, 1), (15, 0), (14, 0), (17, 15),
        (16, 14),
    ),
    center=1,
)

# Reduced 15-joint OpenPose BODY25 subset
OPENPOSE_B25_J15 = Skeleton(
    name="openpose_b25_j15",
    num_joints=15,
    inward=(
        (0, 1), (2, 1), (3, 2), (4, 3), (5, 1), (6, 5), (7, 6), (8, 1),
        (9, 8), (10, 9), (11, 10), (12, 8), (13, 12), (14, 13),
    ),
    center=1,
)

_REGISTRY: Dict[str, Skeleton] = {
    s.name: s for s in (NTU_RGBD_25, KINETICS_18, OPENPOSE_B25_J15)
}

# aliases matching the reference's dotted import paths
_ALIASES = {
    "graph.ntu_rgb_d.Graph": "ntu_rgb_d",
    "graph.kinetics.Graph": "kinetics",
    "graph.openpose_b25_j15.Graph": "openpose_b25_j15",
    "ntu": "ntu_rgb_d",
    "ntu25": "ntu_rgb_d",
    "kinetics18": "kinetics",
    "openpose15": "openpose_b25_j15",
}


def get_skeleton(name: str) -> Skeleton:
    key = _ALIASES.get(name, name)
    if key not in _REGISTRY:
        raise KeyError(
            f"Unknown skeleton {name!r}; available: {sorted(_REGISTRY)}")
    return _REGISTRY[key]


def available_skeletons() -> List[str]:
    return sorted(_REGISTRY)
