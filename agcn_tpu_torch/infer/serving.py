"""Multi-stream batched serving engine
(port of agcn_tpu/infer/serving.py: dense models and, `kind="sgn"`, the
SGN family).

N independent skeleton streams are multiplexed into ONE fixed-shape
forward per tick on the model's device.

Design rules (as in the JAX package):
- the batch dimension is STATIC (`max_streams`): one input shape
  regardless of how many streams are live; empty slots are zero-padded
  and their outputs discarded.
- per-stream state (ring buffer, smoothing, energy-based skeleton
  selection, normalization) stays on the host in numpy; the device only
  sees the batched tensor.
- per-stream semantics (multi-crop averaging, class filtering,
  softmax) match `ActionRecognition.predict`; a batched tick over K live
  streams returns the same answers as K single-stream predicts.
- SGN (`kind="sgn"`): each stream's rows are its `multi_test` crops of
  `seg` segments (`InferencePreprocessor.sgn_input`), drawn from the
  stream's own `np.random.default_rng(stream_id)`, so a stream's crops do
  not depend on the other live streams; the first stream's rows fix the
  batch shape, and past 4 more streams a thread pool fills slabs of the
  others; the logits of a stream's crops are averaged.

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
from agcn_tpu_torch.data.sgn_collate import SegmentSampler
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
                 multi_test: int = 1,
                 allowed_classes: Optional[Sequence[int]] = None,
                 sgn_dataloader_args: Optional[Dict] = None):
        if max_streams < 1:
            raise ValueError("max_streams must be >= 1")
        if kind not in ("dense", "sgn"):
            raise ValueError(f"kind {kind!r}: 'dense' or 'sgn'")
        self.kind = kind
        self.multi_test = multi_test
        # the recipe's test_dataloader_args carry multi_test too: the
        # explicit parameter wins
        self._sgn_args = {k: v for k, v in (sgn_dataloader_args or {}).items()
                          if k != "multi_test"}
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
        self._rngs: Dict[int, np.random.Generator] = {}
        self._pool = None  # thread pool of the SGN per-stream rows
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
        sampler = (SegmentSampler(multi_test=self.multi_test,
                                  **self._sgn_args)
                   if self.kind == "sgn" else None)
        self._streams[sid] = InferencePreprocessor(sgn_sampler=sampler,
                                                   **self._pp_kwargs)
        self._rngs[sid] = np.random.default_rng(sid)
        return sid

    def remove_stream(self, stream_id: int) -> None:
        self._streams.pop(stream_id)
        self._rngs.pop(stream_id)

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

    def _sgn_rows(self, sid: int) -> np.ndarray:
        return self._streams[sid].sgn_input(
            self.num_skels, normalize=self.normalize,
            multi_crop=self.multi_test > 1, rng=self._rngs[sid])

    def _prepare_sgn(self, sids):
        """The SGN rows of every stream in a staging buffer: the first
        stream's rows fix the shape (crops, seg, V*C); past 4 more streams
        W = min(8, n) thread-pool tasks each fill every W-th stream's
        slice in place (numpy releases the GIL; the slices are
        disjoint)."""
        row0 = self._sgn_rows(sids[0])
        per = row0.shape[0]
        buf = self._staging((self.max_streams * per,) + row0.shape[1:])
        x = buf.numpy()
        x[:per] = row0
        rest = sids[1:]
        if len(rest) > 4:
            if self._pool is None:
                import concurrent.futures as cf
                self._pool = cf.ThreadPoolExecutor(
                    max_workers=min(8, self.max_streams))
            workers = min(8, len(rest))

            def slab(w):
                for j in range(1 + w, len(sids), workers):
                    x[j * per:(j + 1) * per] = self._sgn_rows(sids[j])

            list(self._pool.map(slab, range(workers)))
        else:
            for j, sid in enumerate(rest, start=1):
                x[j * per:(j + 1) * per] = self._sgn_rows(sid)
        return buf

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
        if self.kind == "sgn":
            buf = self._prepare_sgn(sids)
        else:
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
            out = self.model(x)
        # the logits of a model that returns (logits, aux)
        return out[0] if isinstance(out, tuple) else out

    def _finalize(self, sids, out) -> Dict[int, Tuple[int, np.ndarray]]:
        """Host phase: device logits -> per-stream answers, each stream's
        crops averaged (reference processor.py:546-548)."""
        per = out.shape[0] // self.max_streams
        logits = out.float().cpu().numpy()[:len(sids) * per]
        if per > 1:
            logits = logits.reshape(len(sids), per, -1).mean(axis=1)
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
