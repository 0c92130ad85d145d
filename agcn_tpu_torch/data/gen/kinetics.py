"""Kinetics-Skeleton OpenPose JSON -> training tensors (port of
agcn_tpu/data/gen/kinetics.py).

Parity target: reference data_gen/kinetics_gendata.py (Feeder_kinetics
:15-132, gendata :134-182): per-frame pose/score parsing, centering to
[-0.5, 0.5] with flipped y, zeroing low-confidence joints, per-frame
person sort by total confidence, top-2 person selection, (N, 3, 300, 18,
2) output.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Tuple

import numpy as np

NUM_JOINT = 18
MAX_FRAME = 300
NUM_PERSON_IN = 5
NUM_PERSON_OUT = 2


def parse_sample(path: str,
                 num_person_in: int = NUM_PERSON_IN,
                 num_person_out: int = NUM_PERSON_OUT,
                 max_frame: int = MAX_FRAME
                 ) -> Tuple[np.ndarray, int]:
    """One OpenPose JSON -> ((3, T, V, M) array, label index)."""
    with open(path) as f:
        video_info = json.load(f)

    data = np.zeros((3, max_frame, NUM_JOINT, num_person_in),
                    dtype=np.float32)
    for frame_info in video_info["data"]:
        t = frame_info["frame_index"]
        if t >= max_frame:
            continue
        for m, skeleton_info in enumerate(frame_info["skeleton"]):
            if m >= num_person_in:
                break
            pose = skeleton_info["pose"]
            score = skeleton_info["score"]
            data[0, t, :, m] = pose[0::2]
            data[1, t, :, m] = pose[1::2]
            data[2, t, :, m] = score

    # center and flip y; zero out joints with no confidence
    data[0:2] -= 0.5
    data[1:2] = -data[1:2]
    data[0][data[2] == 0] = 0
    data[1][data[2] == 0] = 0

    # per-frame sort persons by descending total confidence
    sort_index = (-data[2].sum(axis=1)).argsort(axis=1)
    for t, order in enumerate(sort_index):
        data[:, t] = data[:, t, :, order].transpose(1, 2, 0)

    return data[:, :, :, :num_person_out], int(video_info["label_index"])


def gendata(data_path: str, label_path: str, out_dir: str, part: str):
    """Generate one split from a directory of JSONs + the label JSON."""
    with open(label_path) as f:
        label_info = json.load(f)

    sample_names = sorted(os.listdir(data_path))
    names, labels = [], []
    for name in sample_names:
        key = name.split(".")[0]
        info = label_info.get(key)
        if info is None or not info.get("has_skeleton", True):
            continue
        names.append(name)
        labels.append(int(info["label_index"]))

    data = np.zeros((len(names), 3, MAX_FRAME, NUM_JOINT, NUM_PERSON_OUT),
                    dtype=np.float32)
    for i, name in enumerate(names):
        sample, label = parse_sample(os.path.join(data_path, name))
        assert label == labels[i]
        data[i] = sample

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{part}_data_joint.npy"), data)
    with open(os.path.join(out_dir, f"{part}_label.pkl"), "wb") as f:
        pickle.dump((names, labels), f)
    return data, labels
