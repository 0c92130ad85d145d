"""Real-time action recognition, one stream
(port of agcn_tpu/infer/realtime.py: dense models and, `kind="sgn"`, the
SGN family).

Parity target: reference infer/inference.py (ActionRecognition :47-113,
class-subset logit filtering :24-44, multi-crop averaging :103-106): a
streaming wrapper that appends per-frame skeletons, prepares model input,
runs the forward on the model's device, and emits (label,
probabilities); with `expose_attention` it also keeps each block's graph
of the last predict (`last_attention`, the reference live demo's G
heatmaps, infer/inference_220802.py:518-560).
"""

from __future__ import annotations

import contextlib
import inspect
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agcn_tpu_torch.data.sgn_collate import SegmentSampler
from agcn_tpu_torch.infer.preprocess import InferencePreprocessor
from agcn_tpu_torch.models.exposure import recording_graphs


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
    put in eval mode; inputs go to the device its parameters lie on. An
    SGN model (`kind="sgn"`) takes `multi_test` crops of the segments the
    recipe's `sgn_dataloader_args` set (their own `multi_test` yields to
    the argument), drawn from `default_rng(0)`, and averages their
    logits.

    `last_attention` is what the JAX recognizer keeps
    (agcn_tpu/infer/realtime.py:86-114), as float32 numpy: with
    `expose_attention`, the (K, V, V) graph a1 of each block that records
    one (models/exposure.py), of sample 0, in the order of JAX's sorted
    intermediates (l1, l10, l2, ..., l9 for the unrolled blocks; block
    order for `scan_blocks`); and for an SGN model, whether or not
    `expose_attention` is set, its G list (`aux["g"]`), each entry the
    whole batch's (B, T, V, V), as JAX takes `g[0]` of each (G, aux) pair
    of its list. `last_latency_ms` includes these host copies."""

    def __init__(self,
                 model: torch.nn.Module,
                 kind: str = "dense",
                 num_joint: int = 25,
                 max_seq_length: int = 300,
                 max_person: int = 4,
                 moving_avg: int = 1,
                 num_skels: int = 2,
                 normalize: bool = True,
                 multi_test: int = 1,
                 allowed_classes: Optional[Sequence[int]] = None,
                 sgn_dataloader_args: Optional[Dict] = None,
                 expose_attention: bool = False):
        if kind not in ("dense", "sgn"):
            raise ValueError(f"kind {kind!r}: 'dense' or 'sgn'")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.kind = kind
        self.num_skels = num_skels
        self.normalize = normalize
        self.multi_test = multi_test
        self.allowed_classes = allowed_classes
        sampler = None
        if kind == "sgn":
            extra = {k: v for k, v in (sgn_dataloader_args or {}).items()
                     if k != "multi_test"}
            sampler = SegmentSampler(multi_test=multi_test, **extra)
        self.preproc = InferencePreprocessor(
            num_joint=num_joint, max_seq_length=max_seq_length,
            max_person=max_person, moving_avg=moving_avg,
            sgn_sampler=sampler)
        self.rng = np.random.default_rng(0)
        self.expose_attention = expose_attention
        # JAX's SGN always returns (logits, aux); the port's returns its
        # aux only when asked
        params = inspect.signature(model.forward).parameters
        self._aux = {"return_aux": True} if "return_aux" in params else {}
        self.last_latency_ms = 0.0
        self.last_attention: Optional[List[np.ndarray]] = None

    def append_frame(self, frame: np.ndarray):
        """frame: (M, 1, V, C) joints for the current timestep."""
        self.preproc.append(frame)

    def predict(self) -> Tuple[int, np.ndarray]:
        """Run the model on the current buffer -> (label, probabilities)."""
        t0 = time.perf_counter()
        if self.kind == "sgn":
            x = self.preproc.sgn_input(self.num_skels,
                                       normalize=self.normalize,
                                       multi_crop=self.multi_test > 1,
                                       rng=self.rng)
        else:
            x = self.preproc.dense_input(self.num_skels,
                                         normalize=self.normalize)
        record = (recording_graphs(self.model) if self.expose_attention
                  else contextlib.nullcontext([]))
        with torch.inference_mode():
            with record as graphs:
                out = self.model(torch.from_numpy(x).to(self.device),
                                 **self._aux)
            if graphs:  # one (B, K, V, V) a block -> sample 0's
                self.last_attention = list(torch.stack(
                    [g[0] for g in graphs]).float().cpu().numpy())
        if isinstance(out, tuple):  # (logits, aux)
            out, aux = out[0], out[1]
            if isinstance(aux, dict) and aux.get("g"):
                self.last_attention = [g.float().cpu().numpy()
                                       for g in aux["g"]]
        logits = out.float().cpu().numpy()
        if self.multi_test > 1:
            logits = logits.reshape(-1, self.multi_test,
                                    logits.shape[-1]).mean(axis=1)
        label, probs = softmax_answer(logits[0], self.allowed_classes)
        self.last_latency_ms = (time.perf_counter() - t0) * 1e3
        return label, probs
