"""NTU RGB+D raw `.skeleton` -> training tensors
(port of agcn_tpu/data/gen/ntu.py).

Parity target: reference data_gen/ntu_gendata.py: text parsing
(read_skeleton_filter :43-81), 2-max-energy-body selection of up to 4
tracked bodies (get_nonzero_std :84-92, read_xyz :95-112), xsub/xview
split tables (:15-18), padding to (N, 3, 300, 25, 2), pre-normalization,
npy + pickle output.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

from agcn_tpu_torch.data.gen.preprocess import pre_normalization

TRAINING_SUBJECTS = (1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27,
                     28, 31, 34, 35, 38)
TRAINING_CAMERAS = (2, 3)
MAX_BODY_TRUE = 2
MAX_BODY_KINECT = 4
NUM_JOINT = 25
MAX_FRAME = 300


def read_skeleton(path: str) -> Tuple[np.ndarray, int]:
    """Parse one `.skeleton` file -> (bodies, frames, joints, 3) xyz."""
    with open(path) as f:
        num_frame = int(f.readline())
        data = np.zeros((MAX_BODY_KINECT, num_frame, NUM_JOINT, 3))
        for t in range(num_frame):
            num_body = int(f.readline())
            for b in range(num_body):
                f.readline()  # body meta line
                num_joint = int(f.readline())
                for j in range(num_joint):
                    vals = f.readline().split()
                    if b < MAX_BODY_KINECT and j < NUM_JOINT:
                        data[b, t, j] = [float(vals[0]), float(vals[1]),
                                         float(vals[2])]
    return data, num_frame


def nonzero_std(body: np.ndarray) -> float:
    """Energy score: sum of xyz stds over valid frames
    (reference ntu_gendata.py:84-92)."""
    valid = body.sum(-1).sum(-1) != 0
    body = body[valid]
    if len(body) == 0:
        return 0.0
    return float(body[:, :, 0].std() + body[:, :, 1].std()
                 + body[:, :, 2].std())


def read_xyz(path: str) -> np.ndarray:
    """Read and select the 2 max-energy bodies -> (3, T, V, M).

    Uses the C parser (agcn_tpu_torch/native/skelio.cpp) when g++ is
    there, as the JAX package does; else the Python parse above.
    """
    from agcn_tpu_torch import native

    if native.available():
        parsed, frames = native.parse_skeleton(
            path, MAX_BODY_KINECT, 10_000, NUM_JOINT)
        data = parsed[:, :max(frames, 1)]
    else:
        data, _ = read_skeleton(path)
    energy = np.array([nonzero_std(b) for b in data])
    order = energy.argsort()[::-1][:MAX_BODY_TRUE]
    return data[order].transpose(3, 1, 2, 0)


def parse_sample_name(name: str) -> Tuple[int, int, int]:
    """SsssCcccPpppRrrrAaaa -> (subject, camera, action)."""
    return (int(name[name.find("P") + 1:name.find("P") + 4]),
            int(name[name.find("C") + 1:name.find("C") + 4]),
            int(name[name.find("A") + 1:name.find("A") + 4]))


def gendata(data_path: str,
            out_path: str,
            ignored_sample_path: Optional[str] = None,
            benchmark: str = "xview",
            part: str = "eval") -> Tuple[np.ndarray, List[int]]:
    """Generate one split; writes {part}_data_joint.npy + {part}_label.pkl."""
    ignored = set()
    if ignored_sample_path and os.path.exists(ignored_sample_path):
        with open(ignored_sample_path) as f:
            ignored = {line.strip() + ".skeleton" for line in f}

    names, labels = [], []
    for filename in sorted(os.listdir(data_path)):
        if not filename.endswith(".skeleton") or filename in ignored:
            continue
        subject, camera, action = parse_sample_name(filename)
        if benchmark == "xview":
            istraining = camera in TRAINING_CAMERAS
        elif benchmark == "xsub":
            istraining = subject in TRAINING_SUBJECTS
        else:
            raise ValueError(benchmark)
        issample = istraining if part == "train" else not istraining
        if issample:
            names.append(filename)
            labels.append(action - 1)

    data = np.zeros((len(names), 3, MAX_FRAME, NUM_JOINT, MAX_BODY_TRUE),
                    dtype=np.float32)
    for i, name in enumerate(names):
        sample = read_xyz(os.path.join(data_path, name))
        t = min(sample.shape[1], MAX_FRAME)
        data[i, :, :t] = sample[:, :t]

    # pad=False matches the reference call (data_gen/ntu_gendata.py:172):
    # zero tails stay zero rather than being tiled with the valid prefix.
    data = pre_normalization(data, pad=False)
    os.makedirs(out_path, exist_ok=True)
    np.save(os.path.join(out_path, f"{part}_data_joint.npy"), data)
    with open(os.path.join(out_path, f"{part}_label.pkl"), "wb") as f:
        pickle.dump((names, labels), f)
    return data, labels
