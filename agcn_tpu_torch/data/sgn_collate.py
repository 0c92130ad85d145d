"""SGN segment sampling and collation (copy of agcn_tpu/data/sgn_collate.py).

Parity target: reference feeders/loader.py (NTUDataLoaders :33-358):
flatten persons into the time axis (turn_two_to_one :339-358), drop
all-zero frames, pad to `seg` frames, then sample one frame per segment
under one of five interval policies (equal / motion-AUC / kmeans-midvel /
center / tempshift, :234-320; the k-means one without scikit-learn,
`transforms.kmeans_labels`). Test mode draws `multi_test` independent
crops per sequence; train mode applies a batch 3D rotation. Every draw
comes from the caller's numpy Generator in the JAX package's order, so
both packages give the same batches bit for bit.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from agcn_tpu_torch.data import transforms as T
from agcn_tpu_torch.data.feeder import rotation_theta_for


class SegmentSampler:
    def __init__(self,
                 dataset: str = "NTU60-CV",
                 seg: int = 20,
                 multi_test: int = 5,
                 motion_sampler: int = 0,
                 motion_norm: int = 0,
                 center_sampler: float = 0.0,
                 midvel_sampler: int = 0,
                 tempshift_sampler: float = 0.0,
                 **_):
        self.dataset = dataset
        self.seg = seg
        self.multi_test = multi_test
        self.motion_sampler = motion_sampler
        self.motion_norm = motion_norm
        self.center_sampler = center_sampler
        self.midvel_sampler = midvel_sampler
        self.tempshift_sampler = tempshift_sampler

    # -- per-sequence pieces ------------------------------------------------

    def flatten_persons(self, seq: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(T, M*V*C) -> (T', V*C) with persons interleaved into time;
        returns (frames, subject ids). Reference loader.py:339-358."""
        frames: List[np.ndarray] = []
        subjects: List[List[float]] = []
        half = seq.shape[-1] // 2
        for row in seq:
            p0, p1 = row[:half], row[half:]
            z0 = not p0.any()
            z1 = not p1.any()
            if z0 and not z1:
                frames.append(p1)
                subjects.append([1.0])
            elif z1:
                frames.append(p0)
                subjects.append([0.0])
            else:
                frames.append(p0)
                frames.append(p1)
                subjects.append([0.0])
                subjects.append([1.0])
        return np.asarray(frames, np.float32), np.asarray(subjects,
                                                          np.float32)

    def pad(self, x: np.ndarray) -> np.ndarray:
        if x.shape[0] < self.seg:
            pad = np.zeros((self.seg - x.shape[0], x.shape[1]), np.float32)
            x = np.concatenate([x, pad], axis=0)
        return x

    def intervals(self, seq: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
        n = seq.shape[0]
        if self.midvel_sampler == 1:
            return T.split_idx_using_kmeans(seq, self.seg)
        if self.motion_sampler == 1:
            return T.split_idx_using_auc(seq, self.seg)
        if self.center_sampler > 0:
            return T.split_idx_center(n, self.seg, self.center_sampler)
        if self.tempshift_sampler > 0:
            return T.split_idx_tempshift(n, self.seg,
                                         self.tempshift_sampler, rng)
        return T.split_idx_equal(n, self.seg)

    def sample(self, seq: np.ndarray, subj: np.ndarray,
               rng: np.random.Generator, crops: int
               ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        bounds = self.intervals(seq, rng)
        lo, hi = bounds[:-1], np.maximum(bounds[1:], bounds[:-1] + 1)
        out_x, out_s = [], []
        for _ in range(crops):
            idxs = rng.integers(lo, hi)
            ske = seq[idxs]
            if self.motion_norm == 1:
                denom = T.cumulative_auc(ske, norm=True)[-1]
                if denom > 0:
                    ske = ske / denom
            out_x.append(ske)
            out_s.append(subj[idxs])
        return out_x, out_s

    # -- batch collation ----------------------------------------------------

    def collate(self, batch: Sequence[Tuple[np.ndarray, int, int]],
                rng: np.random.Generator,
                train: bool = False,
                multi_crop: bool = False
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Collate raw (T, M*V*C) items into fixed (B*, seg, V*C) segments.

        Returns (x, subjects, labels, indices); with multi_crop the crops
        of one sequence are consecutive along the batch axis. The persons
        are flattened by the C++ loop (agcn_tpu_torch/native) where it is
        built, else by `flatten_persons` on the nonzero frames.
        """
        from agcn_tpu_torch import native

        use_native = native.available()
        crops = self.multi_test if multi_crop else 1
        xs, ss, ys, idxs = [], [], [], []
        for seq, label, index in batch:
            if use_native:
                frames, subj = native.flatten_persons(seq)
            else:
                nz = seq.any(axis=-1)
                frames, subj = self.flatten_persons(seq[nz])
            frames = self.pad(frames)
            subj = self.pad(subj)
            cx, cs = self.sample(frames, subj, rng, crops)
            xs.extend(cx)
            ss.extend(cs)
            ys.extend([label] * crops)
            idxs.extend([index] * crops)
        x = np.stack(xs).astype(np.float32)
        s = np.stack(ss).astype(np.float32)
        if train:
            x = T.batch_rotation(x, rotation_theta_for(self.dataset), rng)
        return x, s, np.asarray(ys, np.int64), np.asarray(idxs, np.int64)
