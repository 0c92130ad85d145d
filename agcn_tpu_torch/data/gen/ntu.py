"""NTU RGB+D `.skeleton` reading and body energy (copy of the python
path of agcn_tpu/data/gen/ntu.py: read_skeleton, nonzero_std, read_xyz).

Parity target: reference data_gen/ntu_gendata.py (read_skeleton_filter
:43-81, get_nonzero_std :84-92, read_xyz :95-112). The native parser of
the JAX package (native/skelio.cpp) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

MAX_BODY_TRUE = 2
MAX_BODY_KINECT = 4
NUM_JOINT = 25


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
    """Read and select the 2 max-energy bodies -> (3, T, V, M)."""
    data, _ = read_skeleton(path)
    energy = np.array([nonzero_std(b) for b in data])
    order = energy.argsort()[::-1][:MAX_BODY_TRUE]
    return data[order].transpose(3, 1, 2, 0)
