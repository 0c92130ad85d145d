"""The dense skeleton dataset (copy of agcn_tpu/data/feeder.py:28-158).

Parity target: reference feeders/feeder.py (Feeder :35-227). On-disk
contract: `.npy` (N, C, T, V, M) plus pickled (names, labels), as the
AGCN recipes use. The per-item augmentation chain mirrors
feeder.py:185-222 with a per-item numpy Generator seeded from the
per-epoch seed, so the port and the JAX package draw the same numbers.
The SGN dataset waits for SGN (ROADMAP Queue 1: SGN family).
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np

from agcn_tpu_torch.data import transforms as T

# openpose-15 : ntu-25 joint remap (reference feeders/feeder.py:16-32,
# NTU ids are 1-indexed in the table)
JOINT_MAPPING = {
    0: 4, 1: 21, 2: 9, 3: 10, 4: 11, 5: 5, 6: 6, 7: 7, 8: 1, 9: 17,
    10: 18, 11: 19, 12: 13, 13: 14, 14: 15,
}


def rotation_theta_for(dataset: str) -> float:
    """Per-dataset rotation magnitude (reference feeder.py:212-219)."""
    if "NTU60" in dataset:
        return 0.3 if "CS" in dataset else 0.5
    return 0.3


class SkeletonDataset:
    """Dense-format dataset (N, C, T, V, M) with per-item augmentation."""

    def __init__(self,
                 data_path: str,
                 label_path: str,
                 dataset: str = "NTU60-CV",
                 joint_15: bool = False,
                 random_choose: bool = False,
                 random_shift: bool = False,
                 random_move: bool = False,
                 window_size: int = -1,
                 normalization: bool = False,
                 random_zaxis_flip: bool = False,
                 random_xaxis_scale: bool = False,
                 random_yaxis_scale: bool = False,
                 random_subsample: Optional[int] = None,
                 random_rotation: bool = False,
                 stretch: bool = False,
                 debug: bool = False,
                 use_mmap: bool = True):
        self.dataset = dataset
        self.joint_15 = joint_15
        self.random_choose = random_choose
        self.random_shift = random_shift
        self.random_move = random_move
        self.window_size = window_size
        self.normalization = normalization
        self.random_zaxis_flip = random_zaxis_flip
        self.random_xaxis_scale = random_xaxis_scale
        self.random_yaxis_scale = random_yaxis_scale
        self.random_subsample = random_subsample
        self.random_rotation = random_rotation
        self.stretch = stretch

        # the label file is a pickle this project (or the reference's
        # data_gen) wrote: unpickling runs code
        with open(label_path, "rb") as f:
            try:
                self.sample_name, self.label = pickle.load(f)
            except UnicodeDecodeError:
                f.seek(0)
                self.sample_name, self.label = pickle.load(
                    f, encoding="latin1")
        self.label = np.asarray(self.label)
        self.data = np.load(data_path, mmap_mode="r" if use_mmap else None)

        if joint_15:
            data = np.zeros((*self.data.shape[:3], 15, self.data.shape[-1]),
                            dtype=self.data.dtype)
            for new_id, old_id in JOINT_MAPPING.items():
                data[:, :, :, new_id, :] = self.data[:, :, :, old_id - 1, :]
            self.data = data

        if debug:
            self.label = self.label[:100]
            self.data = self.data[:100]
            self.sample_name = self.sample_name[:100]

        if normalization:
            self._compute_mean_map()

        self._seed = 0

    def _compute_mean_map(self):
        data = np.asarray(self.data)
        n, c, t, v, m = data.shape
        self.mean_map = data.mean(axis=2, keepdims=True).mean(
            axis=4, keepdims=True).mean(axis=0)
        self.std_map = data.transpose(0, 2, 4, 1, 3).reshape(
            n * t * m, c * v).std(axis=0).reshape(c, 1, v, 1)

    def seed(self, seed: int):
        self._seed = int(seed)

    def __len__(self):
        return len(self.label)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, int, int]:
        x = np.array(self.data[index], dtype=np.float32)
        label = int(self.label[index])
        # per-item stream derived from the per-epoch seed: thread-safe under
        # the pipeline's worker pool and independent of iteration order
        rng = np.random.default_rng((self._seed, index))

        if self.stretch:
            x = T.stretch_to_maximum_length(x)
        if self.normalization:
            x = (x - self.mean_map) / self.std_map
        if self.random_shift:
            x = T.random_shift(x, rng)
        if self.random_choose:
            x = T.random_choose(x, self.window_size, rng)
        elif self.window_size > 0:
            x = T.auto_pad(x, self.window_size)
        if self.random_move:
            x = T.random_move(x, rng)
        if self.random_zaxis_flip:
            x = T.random_flip(x, 2, rng)
        if self.random_xaxis_scale:
            x = T.random_axis_scale(x, 0, rng)
        if self.random_yaxis_scale:
            x = T.random_axis_scale(x, 1, rng)
        if self.random_subsample is not None:
            x = T.random_subsample(x, self.random_subsample, rng)
        if self.random_rotation:
            x = T.random_rotation(x, rotation_theta_for(self.dataset), rng)

        return x.astype(np.float32), label, index

    def top_k(self, score: np.ndarray, k: int) -> float:
        """Top-k accuracy of a (N, num_class) score matrix
        (reference feeder.py:224-227)."""
        rank = score.argsort()
        hits = [l in rank[i, -k:] for i, l in enumerate(self.label)]
        return sum(hits) / len(hits)
