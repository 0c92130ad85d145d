"""Real-time action recognition, one stream
(port of agcn_tpu/infer/realtime.py, dense models).

Parity target: reference infer/inference.py (ActionRecognition :47-113,
class-subset logit filtering :24-44): a streaming wrapper that appends
per-frame skeletons, prepares model input, runs the forward on the
model's device, and emits (label, probabilities).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from agcn_tpu_torch.infer.preprocess import InferencePreprocessor


def filter_logits(logits: np.ndarray,
                  allowed: Optional[Sequence[int]]) -> np.ndarray:
    """Mask logits outside an allowed class subset
    (reference inference.py:24-44)."""
    if not allowed:
        return logits
    mask = np.full(logits.shape[-1], -np.inf, dtype=logits.dtype)
    mask[list(allowed)] = 0.0
    return logits + mask


def softmax_answer(logits: np.ndarray,
                   allowed: Optional[Sequence[int]]) -> Tuple[int, np.ndarray]:
    """One stream's (label, probabilities) from its logits row."""
    li = filter_logits(logits, allowed)
    probs = np.exp(li - li.max())
    probs = probs / probs.sum()
    return int(probs.argmax()), probs


class ActionRecognition:
    """Streaming recognizer over the model's eval forward. The model is
    put in eval mode; inputs go to the device its parameters lie on."""

    def __init__(self,
                 model: torch.nn.Module,
                 num_joint: int = 25,
                 max_seq_length: int = 300,
                 max_person: int = 4,
                 moving_avg: int = 1,
                 num_skels: int = 2,
                 normalize: bool = True,
                 allowed_classes: Optional[Sequence[int]] = None):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.num_skels = num_skels
        self.normalize = normalize
        self.allowed_classes = allowed_classes
        self.preproc = InferencePreprocessor(
            num_joint=num_joint, max_seq_length=max_seq_length,
            max_person=max_person, moving_avg=moving_avg)
        self.last_latency_ms = 0.0

    def append_frame(self, frame: np.ndarray):
        """frame: (M, 1, V, C) joints for the current timestep."""
        self.preproc.append(frame)

    def predict(self) -> Tuple[int, np.ndarray]:
        """Run the model on the current buffer -> (label, probabilities)."""
        t0 = time.perf_counter()
        x = self.preproc.dense_input(self.num_skels,
                                     normalize=self.normalize)
        with torch.inference_mode():
            out = self.model(torch.from_numpy(x).to(self.device))
        logits = out.float().cpu().numpy()
        label, probs = softmax_answer(logits[0], self.allowed_classes)
        self.last_latency_ms = (time.perf_counter() - t0) * 1e3
        return label, probs
