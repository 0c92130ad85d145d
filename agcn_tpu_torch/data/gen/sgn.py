"""SGN-format data generation from dense tensors (port of
agcn_tpu/data/gen/sgn.py).

Functional-parity target: reference data_gen/sgn/
{get_raw_skes_data,get_raw_denoised_data,seq_transformation}.py: raw
skeletons -> per-body denoising -> translate to the first valid frame's
spine origin -> pad to 300 frames -> pickled (N, T, 2*25*3) arrays.

This implementation starts from the dense (N, 3, T, 25, 2) tensors
produced by agcn_tpu_torch.data.gen.ntu (which already performs the max-energy
body selection that subsumes most of the reference's denoising
heuristics) and applies the SGN-specific sequence transformation.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

MAX_FRAME = 300


def dense_to_sgn(data: np.ndarray,
                 center_joint: int = 1,
                 max_frame: int = MAX_FRAME) -> np.ndarray:
    """(N, C, T, V, M) dense tensors -> (N, max_frame, M*V*C) SGN arrays.

    Per sample: drop all-zero frames, translate every body by the first
    valid frame's center joint of the main body (reference
    seq_transformation.py's origin alignment), zero-pad the tail.
    """
    n, c, t, v, m = data.shape
    out = np.zeros((n, max_frame, m * v * c), dtype=np.float32)
    for i in range(n):
        sample = data[i]  # (C, T, V, M)
        frames = np.transpose(sample, (1, 3, 2, 0))  # (T, M, V, C)
        valid = frames.reshape(t, -1).any(axis=-1)
        frames = frames[valid]
        if len(frames) == 0:
            continue
        origin = frames[0, 0, center_joint].copy()  # (C,)
        mask = frames.reshape(len(frames), m, -1).any(axis=-1)  # (T', M)
        frames = frames - origin[None, None, None, :]
        frames = frames * mask[:, :, None, None]
        length = min(len(frames), max_frame)
        out[i, :length] = frames[:length].reshape(length, -1)
    return out


def gendata_from_dense(joint_npy: str, label_pkl: str, out_dir: str,
                       split: str, benchmark: str = "CV"):
    """Write NTU_{benchmark}_{split}.pkl + label pkl in the SGN contract."""
    data = np.asarray(np.load(joint_npy, mmap_mode="r"))
    with open(label_pkl, "rb") as f:
        try:
            _, labels = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            _, labels = pickle.load(f, encoding="latin1")
    sgn = dense_to_sgn(data)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"NTU_{benchmark}_{split}.pkl"),
              "wb") as f:
        pickle.dump(sgn, f)
    with open(os.path.join(out_dir, f"NTU_{benchmark}_{split}_label.pkl"),
              "wb") as f:
        pickle.dump(np.asarray(labels), f)
    return sgn
