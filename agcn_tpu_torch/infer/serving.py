"""Multi-stream batched serving engine
(port of agcn_tpu/infer/serving.py, dense models).

N independent skeleton streams are multiplexed into ONE fixed-shape
forward per tick on the model's device.

Design rules (as in the JAX package):
- the batch dimension is STATIC (`max_streams`): one input shape
  regardless of how many streams are live; empty slots are zero-padded
  and their outputs discarded.
- per-stream state (ring buffer, smoothing, energy-based skeleton
  selection, normalization) stays on the host in numpy; the device only
  sees the batched tensor.
- per-stream semantics (class filtering, softmax) match
  `ActionRecognition.predict`; a batched tick over K live streams
  returns the same answers as K single-stream predicts.

On CUDA the batch is staged in page-locked host memory and copied with
`non_blocking=True`, so `predict_async` returns while the card computes:
the host preps tick t+1 while the card runs tick t. Two staging buffers
alternate, so the one being filled is never the one in flight.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from agcn_tpu_torch.data.gen.preprocess import pre_normalization
from agcn_tpu_torch.infer.preprocess import InferencePreprocessor
from agcn_tpu_torch.infer.realtime import softmax_answer


class BatchedStreamServer:
    """Serve many skeleton streams with one padded batched forward."""

    def __init__(self,
                 model: torch.nn.Module,
                 max_streams: int,
                 kind: str = "dense",
                 num_joint: int = 25,
                 max_seq_length: int = 300,
                 max_person: int = 4,
                 moving_avg: int = 1,
                 num_skels: int = 2,
                 normalize: bool = True,
                 allowed_classes: Optional[Sequence[int]] = None):
        if max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        if kind != "dense":
            raise NotImplementedError(
                f"kind {kind!r}: the port serves dense (AGCN) models; SGN "
                "serving waits for the SGN family (ROADMAP, Queue 1)")
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.max_streams = max_streams
        self.num_skels = num_skels
        self.normalize = normalize
        self.allowed_classes = allowed_classes
        self._pp_kwargs = dict(num_joint=num_joint,
                               max_seq_length=max_seq_length,
                               max_person=max_person,
                               moving_avg=moving_avg)
        self._streams: Dict[int, InferencePreprocessor] = {}
        self._next_id = 0
        self._bufs = [None, None]  # ping-pong staging buffers
        self._buf_i = 0
        self._pending = None  # in-flight (sids, logits) for async mode
        self.last_latency_ms = 0.0
        self.last_prep_ms = 0.0
        self.last_h2d_ms = 0.0

    # -- stream lifecycle --------------------------------------------

    def add_stream(self, stream_id: Optional[int] = None) -> int:
        if len(self._streams) >= self.max_streams:
            raise RuntimeError(
                f"server at capacity ({self.max_streams} streams)")
        sid = self._next_id if stream_id is None else stream_id
        if sid in self._streams:
            raise ValueError(f"stream {sid} already exists")
        self._next_id = max(self._next_id, sid) + 1
        self._streams[sid] = InferencePreprocessor(**self._pp_kwargs)
        return sid

    def remove_stream(self, stream_id: int) -> None:
        self._streams.pop(stream_id)

    def append_frame(self, stream_id: int, frame: np.ndarray) -> None:
        """frame: (M, 1, V, C) joints for the stream's current step."""
        self._streams[stream_id].append(frame)

    # -- inference ----------------------------------------------------

    def _prepare_dense_batched(self, sids):
        """Vectorized dense prep: ONE pass over all streams (stacked ring
        buffers, masked-moment energy, top-k selection, layout, batched
        pre_normalization). Energies use fp64 accumulators — ordering
        agrees with the per-stream fp32 std except for exact ties, where
        either body is equally valid."""
        pps = [self._streams[sid] for sid in sids]
        data = np.stack([pp.data for pp in pps])  # (S, M, T, V, C)
        v = data.shape[3]
        mask = (data.sum((-1, -2)) != 0)  # (S, M, T) valid frames
        w = mask[..., None, None]
        cnt = mask.sum(-1)[..., None].astype(np.float64) * v  # (S, M, 1)
        dm = data * w
        s1 = dm.sum((2, 3)).astype(np.float64)   # (S, M, C)
        s2 = (dm * data).sum((2, 3)).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            mean = s1 / cnt
            var = s2 / cnt - np.square(mean)
        std = np.sqrt(np.maximum(var, 0.0))
        energy = np.where(cnt[..., 0] > 0, std.sum(-1), 0.0)  # (S, M)
        order = np.argsort(energy, axis=1)[:, ::-1][:, :self.num_skels]
        sel = data[np.arange(len(sids))[:, None], order]  # (S, M', T, V, C)
        rows = np.ascontiguousarray(
            np.transpose(sel, (0, 4, 2, 3, 1)))  # (S, C, T, V, M')
        if self.normalize:
            rows = pre_normalization(rows, zaxis=pps[0].zaxis,
                                     xaxis=pps[0].xaxis)
        return rows.astype(np.float32)

    def _staging(self, shape) -> torch.Tensor:
        """The next ping-pong host buffer (page-locked for a CUDA model)."""
        self._buf_i ^= 1
        buf = self._bufs[self._buf_i]
        if buf is None or tuple(buf.shape) != shape:
            buf = torch.zeros(shape, dtype=torch.float32,
                              pin_memory=self.device.type == "cuda")
            self._bufs[self._buf_i] = buf
        return buf

    def _prepare(self):
        """Host phase: per-stream preprocessing + static-shape padding.
        Returns (sids, device_input) or None when no streams."""
        t0 = time.perf_counter()
        sids = sorted(self._streams)
        if not sids:
            return None
        if len(sids) > 4:
            rows = self._prepare_dense_batched(sids)
        else:
            rows = np.concatenate([
                self._streams[sid].dense_input(self.num_skels,
                                               normalize=self.normalize)
                for sid in sids])
        buf = self._staging((self.max_streams,) + rows.shape[1:])
        # stale rows of removed streams are harmless: eval has no
        # cross-row coupling and _finalize drops rows past len(sids)
        buf.numpy()[:len(sids)] = rows
        t1 = time.perf_counter()
        xd = buf.to(self.device, non_blocking=True)
        # the enqueue of the host->device copy, not its duration
        self.last_h2d_ms = (time.perf_counter() - t1) * 1e3
        self.last_prep_ms = (time.perf_counter() - t0) * 1e3
        return sids, xd

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(x)

    def _finalize(self, sids, out) -> Dict[int, Tuple[int, np.ndarray]]:
        """Host phase: device logits -> per-stream answers."""
        logits = out.float().cpu().numpy()[:len(sids)]
        return {sid: softmax_answer(logits[i], self.allowed_classes)
                for i, sid in enumerate(sids)}

    def predict(self) -> Dict[int, Tuple[int, np.ndarray]]:
        """One batched forward over all live streams ->
        {stream_id: (label, probabilities)}. Not interleavable with an
        in-flight predict_async() tick — drain with flush() first."""
        if self._pending is not None:
            raise RuntimeError(
                "a pipelined tick is in flight: call flush() before "
                "mixing predict() with predict_async()")
        t0 = time.perf_counter()
        prepped = self._prepare()
        if prepped is None:
            return {}
        sids, x = prepped
        results = self._finalize(sids, self._forward(x))
        self.last_latency_ms = (time.perf_counter() - t0) * 1e3
        return results

    def predict_async(self) -> Optional[Dict[int, Tuple[int, np.ndarray]]]:
        """Pipelined tick: prep + enqueue this tick, return the PREVIOUS
        tick's results (None before the first completes). Same per-tick
        answers as predict(), one tick later; flush() drains the last
        tick. Streams may be added/removed between ticks."""
        t0 = time.perf_counter()
        prepped = self._prepare()
        pending, self._pending = self._pending, None
        if prepped is not None:
            sids, x = prepped
            self._pending = (sids, self._forward(x))
        results = self._finalize(*pending) if pending else None
        self.last_latency_ms = (time.perf_counter() - t0) * 1e3
        return results

    def flush(self) -> Optional[Dict[int, Tuple[int, np.ndarray]]]:
        """Drain the in-flight pipelined tick (predict_async)."""
        pending, self._pending = self._pending, None
        return self._finalize(*pending) if pending else None
