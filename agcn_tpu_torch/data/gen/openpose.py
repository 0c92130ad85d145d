"""OpenPose BODY25 -> 15-joint NTU variant generation (port of
agcn_tpu/data/gen/openpose.py).

Parity target: reference data_gen/openpose/extract_skel.py (joint remap
:19-35, 9-class label remap :38-48) and openpose_b25_j15_ntu_gendata.py:
NTU-format generation on the reduced 15-joint skeleton with an optional
action-class subset remap.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np

from agcn_tpu_torch.data.feeder import JOINT_MAPPING
from agcn_tpu_torch.data.gen.ntu import (MAX_FRAME, TRAINING_CAMERAS,
                                         TRAINING_SUBJECTS,
                                         parse_sample_name, read_xyz)
from agcn_tpu_torch.data.gen.preprocess import pre_normalization

# original NTU action id -> demo-subset label
# (reference extract_skel.py:38-48)
LABEL_MAPPING: Dict[int, int] = {
    1: 0, 2: 0, 8: 1, 9: 2, 27: 3, 31: 4, 43: 5, 56: 6, 59: 7, 60: 8,
}

NUM_JOINT_15 = 15


def remap_to_15_joints(data: np.ndarray) -> np.ndarray:
    """(C, T, 25, M) NTU joints -> (C, T, 15, M) OpenPose-15 layout.

    JOINT_MAPPING values are 1-indexed NTU ids (feeders/feeder.py:16-32).
    """
    c, t, _, m = data.shape
    out = np.zeros((c, t, NUM_JOINT_15, m), dtype=data.dtype)
    for new_id, ntu_id in JOINT_MAPPING.items():
        out[:, :, new_id] = data[:, :, ntu_id - 1]
    return out


def gendata(data_path: str,
            out_path: str,
            ignored_sample_path: Optional[str] = None,
            benchmark: str = "xview",
            part: str = "train",
            label_subset: Optional[Dict[int, int]] = None
            ) -> Tuple[np.ndarray, List[int]]:
    """Generate NTU-format (N, 3, 300, 15, 2) data on the 15-joint layout.

    With `label_subset` (e.g. LABEL_MAPPING), only those action classes
    are kept and labels are remapped to the subset ids.
    """
    ignored = set()
    if ignored_sample_path and os.path.exists(ignored_sample_path):
        with open(ignored_sample_path) as f:
            ignored = {line.strip() + ".skeleton" for line in f}

    names, labels = [], []
    for filename in sorted(os.listdir(data_path)):
        if not filename.endswith(".skeleton") or filename in ignored:
            continue
        subject, camera, action = parse_sample_name(filename)
        if label_subset is not None and action not in label_subset:
            continue
        if benchmark == "xview":
            istraining = camera in TRAINING_CAMERAS
        elif benchmark == "xsub":
            istraining = subject in TRAINING_SUBJECTS
        else:
            raise ValueError(benchmark)
        if (istraining if part == "train" else not istraining):
            names.append(filename)
            labels.append(label_subset[action] if label_subset is not None
                          else action - 1)

    data = np.zeros((len(names), 3, MAX_FRAME, NUM_JOINT_15, 2),
                    dtype=np.float32)
    for i, name in enumerate(names):
        sample = read_xyz(os.path.join(data_path, name))
        sample = remap_to_15_joints(sample)
        t = min(sample.shape[1], MAX_FRAME)
        data[i, :, :t] = sample[:, :t]

    # 15-joint layout: chest (1) is the center; hip->chest to z,
    # shoulders (2, 5) to x
    data = pre_normalization(data, zaxis=(8, 1), xaxis=(2, 5))
    os.makedirs(out_path, exist_ok=True)
    np.save(os.path.join(out_path, f"{part}_data_joint.npy"), data)
    with open(os.path.join(out_path, f"{part}_label.pkl"), "wb") as f:
        pickle.dump((names, labels), f)
    return data, labels
