"""Streaming inference preprocessing: ring buffer + normalization
(port of agcn_tpu/infer/preprocess.py).

Parity target: reference infer/data_preprocess.py (DataPreprocessor
:6-83, DataPreprocessorV2 :85-127): a (max_person, T, V, C) ring buffer
fed one frame at a time with optional moving-average smoothing,
energy-based skeleton selection, and AAGCN pre-normalization and/or SGN
fixed-length segmentation before model input. Host-side numpy, as in the
JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from agcn_tpu_torch.data.gen.ntu import nonzero_std
from agcn_tpu_torch.data.gen.preprocess import pre_normalization
from agcn_tpu_torch.data.sgn_collate import SegmentSampler


class StreamBuffer:
    """Per-frame skeleton ring buffer (reference DataPreprocessor)."""

    def __init__(self,
                 num_joint: int = 25,
                 max_seq_length: int = 300,
                 max_person: int = 4,
                 moving_avg: int = 1):
        self.num_joint = num_joint
        self.max_seq_length = max_seq_length
        self.max_person = max_person
        self.moving_avg = moving_avg
        self.reset()

    def reset(self):
        self.data = np.zeros((self.max_person, self.max_seq_length,
                              self.num_joint, 3), dtype=np.float32)
        self.counter = 0

    def append(self, frame: np.ndarray):
        """Append one (M, 1, V, C) frame; shifts left once full."""
        m, t, v, c = frame.shape
        if self.counter < self.max_seq_length:
            self.data[:m, self.counter:self.counter + 1, :v, :c] = frame
            self.counter += 1
            if self.moving_avg > 1 and self.counter > self.moving_avg - 1:
                window = self.data[:, self.counter - self.moving_avg:
                                   self.counter]
                self.data[:, self.counter - 1:self.counter] = window.mean(
                    axis=1, keepdims=True)
        else:
            self.data[:, :-1] = self.data[:, 1:]
            self.data[:m, -1:, :v, :c] = frame
            if self.moving_avg > 1:
                window = self.data[:, -self.moving_avg:]
                self.data[:, -1:] = window.mean(axis=1, keepdims=True)

    def select_skeletons(self, num_skels: int = 2) -> np.ndarray:
        """Top-energy skeleton selection (reference ntu_gendata
        get_nonzero_std)."""
        energy = np.array([nonzero_std(b) for b in self.data])
        index = energy.argsort()[::-1][:num_skels]
        return self.data[index]  # (M', T, V, C)


class InferencePreprocessor(StreamBuffer):
    """StreamBuffer + AAGCN/SGN model-input preparation
    (reference DataPreprocessorV2)."""

    def __init__(self, num_joint=25, max_seq_length=300, max_person=4,
                 moving_avg=1, zaxis=(0, 1), xaxis=(8, 4),
                 sgn_sampler: Optional[SegmentSampler] = None):
        super().__init__(num_joint, max_seq_length, max_person, moving_avg)
        self.zaxis = tuple(zaxis) if zaxis is not None else None
        self.xaxis = tuple(xaxis) if xaxis is not None else None
        self.sgn_sampler = sgn_sampler

    def dense_input(self, num_skels: int = 2,
                    normalize: bool = True) -> np.ndarray:
        """(1, C, T, V, M) AAGCN/AGCN model input."""
        data = self.select_skeletons(num_skels)  # (M, T, V, C)
        data = np.transpose(data, (3, 1, 2, 0))[None]  # (1, C, T, V, M)
        if normalize:
            data = pre_normalization(data, zaxis=self.zaxis,
                                     xaxis=self.xaxis)
        return data.astype(np.float32)

    def sgn_input(self, num_skels: int = 2, normalize: bool = False,
                  multi_crop: bool = False,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """(crops, seg, V*C) SGN model input: the selected bodies as one
        (T, M*V*C) sequence through the sampler's test collate (persons
        flattened into time, segments sampled; `multi_test` crops with
        `multi_crop`), the draws from `rng` (default_rng(0) when None)."""
        if self.sgn_sampler is None:
            raise ValueError("sgn_input needs the preprocessor's sgn_sampler")
        rng = rng or np.random.default_rng(0)
        dense = self.dense_input(num_skels, normalize=normalize)
        # (1, C, T, V, M) -> (T, M*V*C)
        seq = np.transpose(dense[0], (1, 3, 2, 0)).reshape(
            dense.shape[2], -1)
        x, _, _, _ = self.sgn_sampler.collate(
            [(seq, 0, 0)], rng, train=False, multi_crop=multi_crop)
        return x
