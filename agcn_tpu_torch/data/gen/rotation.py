"""Rodrigues rotations for skeleton pre-normalization
(copy of agcn_tpu/data/gen/rotation.py).

Parity target: reference data_gen/rotation.py (rotation_matrix :5-20,
unit_vector/angle_between :23-42).
"""

from __future__ import annotations

import math

import numpy as np


def rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rodrigues rotation about `axis` by `theta` radians."""
    if np.abs(axis).sum() < 1e-6 or abs(theta) < 1e-6:
        return np.eye(3)
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / math.sqrt(np.dot(axis, axis))
    a = math.cos(theta / 2.0)
    b, c, d = -axis * math.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([[aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
                     [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
                     [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


def angle_between(v1: np.ndarray, v2: np.ndarray) -> float:
    if np.abs(v1).sum() < 1e-6 or np.abs(v2).sum() < 1e-6:
        return 0.0
    u1 = v1 / np.linalg.norm(v1)
    u2 = v2 / np.linalg.norm(v2)
    return float(np.arccos(np.clip(np.dot(u1, u2), -1.0, 1.0)))


def align_rotation(vec: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Rotation matrix aligning `vec` with `target`."""
    axis = np.cross(vec, target)
    angle = angle_between(vec, target)
    return rotation_matrix(axis, angle)
