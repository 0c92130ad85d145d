"""Bone / motion stream generation (port of
agcn_tpu/data/gen/streams.py).

Parity target: reference data_gen/gen_bone_data.py (bone = joint - parent
over the pairs table :6-28), gen_motion_data.py (motion = frame t+1 - t),
merge_joint_bone_data.py (channel concat). Pairs come from the skeleton
registry instead of a hardcoded table, so all three skeletons work.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from agcn_tpu_torch.graph import get_skeleton


def bone_stream(joint: np.ndarray, skeleton_name: str = "ntu_rgb_d"
                ) -> np.ndarray:
    """(N, C, T, V, M) joints -> bones (joint minus parent; zero at root)."""
    sk = get_skeleton(skeleton_name)
    bones = np.zeros_like(joint)
    for j, p in sk.bone_pairs:
        bones[:, :, :, j, :] = joint[:, :, :, j, :] - joint[:, :, :, p, :]
    return bones


def motion_stream(data: np.ndarray) -> np.ndarray:
    """Temporal difference stream; last frame zero
    (reference gen_motion_data.py)."""
    motion = np.zeros_like(data)
    motion[:, :, :-1] = data[:, :, 1:] - data[:, :, :-1]
    return motion


def merge_joint_bone(joint: np.ndarray, bone: np.ndarray) -> np.ndarray:
    """Concatenate joint+bone on the channel axis."""
    return np.concatenate([joint, bone], axis=1)


def generate_streams(joint_path: str, skeleton_name: str = "ntu_rgb_d",
                     motion: bool = True, out_dir: Optional[str] = None):
    """Produce bone (and motion) npy files next to a joint npy file."""
    out_dir = out_dir or os.path.dirname(joint_path)
    joint = np.load(joint_path, mmap_mode="r")
    base = os.path.basename(joint_path).replace("_joint", "")
    joint = np.asarray(joint)
    bone = bone_stream(joint, skeleton_name)
    np.save(os.path.join(out_dir, base.replace("_data", "_data_bone")
                         if "_data" in base else f"bone_{base}"), bone)
    if motion:
        np.save(os.path.join(out_dir,
                             base.replace("_data", "_data_joint_motion")),
                motion_stream(joint))
        np.save(os.path.join(out_dir,
                             base.replace("_data", "_data_bone_motion")),
                motion_stream(bone))
