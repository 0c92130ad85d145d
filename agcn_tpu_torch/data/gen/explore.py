"""Dataset exploration: split/class statistics and sample rendering
(port of agcn_tpu/data/gen/explore.py).

Parity target: reference data_gen/ntu_explore.py — a hand-run explorer
that walks the raw-skeleton corpus, filters by split and class subset,
and animates chosen samples (pre-normalized) in matplotlib. This version
is a library function + `python -m agcn_tpu_torch.data.gen explore`
subcommand that works on either a raw `.skeleton` directory or a
generated `(N, C, T, V, M)` .npy dataset. Rendering draws with
utils/visualization.py, which needs matplotlib.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from agcn_tpu_torch.data.gen.ntu import (MAX_FRAME, TRAINING_CAMERAS,
                                         TRAINING_SUBJECTS,
                                         parse_sample_name, read_xyz)


@dataclass
class ExploreReport:
    """Statistics over the selected samples."""

    n_samples: int
    class_counts: Dict[int, int]            # 0-based label -> count
    split_counts: Dict[str, int]            # 'train'/'val' -> count
    frame_lengths: List[int] = field(default_factory=list)
    body_counts: List[int] = field(default_factory=list)

    def summary_lines(self) -> List[str]:
        lines = [f"samples: {self.n_samples}"]
        for part in sorted(self.split_counts):
            lines.append(f"  {part}: {self.split_counts[part]}")
        if self.frame_lengths:
            fl = np.asarray(self.frame_lengths)
            lines.append(
                f"frames: min {fl.min()} / median {int(np.median(fl))} / "
                f"max {fl.max()}")
        if self.body_counts:
            bc = np.asarray(self.body_counts)
            for m in sorted(set(bc.tolist())):
                lines.append(f"  bodies={m}: {(bc == m).sum()}")
        lines.append("per-class counts (0-based label):")
        for cls in sorted(self.class_counts):
            lines.append(f"  A{cls + 1:03d}: {self.class_counts[cls]}")
        return lines


def explore_raw(data_path: str,
                benchmark: str = "xview",
                classes: Optional[Sequence[int]] = None,
                read_frames: bool = False) -> ExploreReport:
    """Scan a raw `.skeleton` directory.

    classes: optional 0-based label subset (the reference explorer's
    hardcoded `[8, 9]` 1-based filter, ntu_explore.py:75).
    read_frames: also parse each file for frame/body statistics (slow on
    the full 56k-file corpus; the filename scan alone is instant).
    """
    class_counts: Dict[int, int] = {}
    split_counts = {"train": 0, "val": 0}
    frame_lengths: List[int] = []
    body_counts: List[int] = []
    n = 0
    for filename in sorted(os.listdir(data_path)):
        if not filename.endswith(".skeleton"):
            continue
        subject, camera, action = parse_sample_name(filename)
        label = action - 1
        if classes is not None and label not in classes:
            continue
        if benchmark == "xview":
            istraining = camera in TRAINING_CAMERAS
        elif benchmark == "xsub":
            istraining = subject in TRAINING_SUBJECTS
        else:
            raise ValueError(benchmark)
        split_counts["train" if istraining else "val"] += 1
        class_counts[label] = class_counts.get(label, 0) + 1
        n += 1
        if read_frames:
            data = read_xyz(os.path.join(data_path, filename))  # (3,T,V,M)
            frame_lengths.append(int(data.shape[1]))
            body_counts.append(
                int((np.abs(data).sum(axis=(0, 1, 2)) > 0).sum()))
    return ExploreReport(n, class_counts, split_counts, frame_lengths,
                         body_counts)


def explore_npy(data_path: str,
                label_path: Optional[str] = None,
                classes: Optional[Sequence[int]] = None) -> ExploreReport:
    """Statistics over a generated (N, C, T, V, M) .npy dataset."""
    data = np.load(data_path, mmap_mode="r")
    labels: Optional[np.ndarray] = None
    if label_path:
        with open(label_path, "rb") as f:
            _, raw_labels = pickle.load(f)
        labels = np.asarray(raw_labels)
    idx = np.arange(data.shape[0])
    if classes is not None and labels is not None:
        idx = idx[np.isin(labels, np.asarray(list(classes)))]
    class_counts: Dict[int, int] = {}
    if labels is not None:
        for lbl in labels[idx]:
            class_counts[int(lbl)] = class_counts.get(int(lbl), 0) + 1
    frame_lengths, body_counts = [], []
    for i in idx:
        x = np.asarray(data[i])                      # (C, T, V, M)
        valid_t = np.abs(x).sum(axis=(0, 2, 3)) > 0
        frame_lengths.append(int(valid_t.sum()))
        body_counts.append(int((np.abs(x).sum(axis=(0, 1, 2)) > 0).sum()))
    return ExploreReport(len(idx), class_counts, {"all": len(idx)},
                         frame_lengths, body_counts)


def render_sample(data_path: str,
                  sample: str,
                  save_path: str,
                  pre_normalize: bool = True) -> str:
    """Animate one raw sample like the reference explorer: parse, pad to
    the canonical (1, 3, T <= 300, 25, 2), optionally pre-normalize, save
    (agcn_tpu/data/gen/explore.py:122-142).

    `sample` is a `.skeleton` filename inside data_path.
    """
    from agcn_tpu_torch.data.gen.preprocess import pre_normalization
    from agcn_tpu_torch.utils.visualization import visualize_skeleton

    xyz = read_xyz(os.path.join(data_path, sample))  # (3, T, V, M)
    t = min(xyz.shape[1], MAX_FRAME)
    batch = np.zeros((1, 3, t, 25, 2), dtype=np.float32)
    batch[0, :, :t] = xyz[:, :t]
    if pre_normalize:
        batch = pre_normalization(batch, pad=False)
    visualize_skeleton(batch, skeleton_name="ntu_rgb_d",
                       save_path=save_path)
    return save_path
