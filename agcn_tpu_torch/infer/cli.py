"""Streaming inference CLI of the port (port of the root infer.py).

    # the live demo: one recognizer, the recordings one after another
    python -m agcn_tpu_torch.infer --config configs/ntu60_xview/test_joint.yaml \
        --weights agcn_joint.pt --input recordings/ --timing \
        --save-attention attn/
    # multi-stream serving
    python -m agcn_tpu_torch.infer --config configs/ntu60_xview/test_joint.yaml \
        --weights agcn_joint.pt --input recordings/ --serve 16 --pipeline \
        --timing

Without `--serve` (the root infer.py's default mode, infer.py:353-406)
--input is one `.npy` / `.skeleton` recording or a directory of them,
streamed in mtime order (with `--follow`, new files as they appear) frame
by frame through one `ActionRecognition`, whose buffer runs on from one
file into the next; every --interval frames of a file it predicts and
prints `frame {i}: class {name} p={p:.3f}` (and ` ({ms:.1f} ms)` with
--timing), writes `{i},{label},{p:.6f}` to `--out-folder`/results.txt,
and with `--save-attention DIR` draws the first block's graph of the
prediction (`last_attention[0]`) into `DIR/{file}_f{i}_g0.png`
(utils/visualization.py; matplotlib, checked when the arguments are).

With `--serve N` each file in --input (a directory) is one live stream;
all streams advance in lock-step and every --interval frames ONE batched
forward answers all of them (infer/serving.py).

A model whose name holds "sgn" runs as the SGN family (`kind="sgn"`, as
the root infer.py decides): the recipe's `test_dataloader_args` set its
segments, `seg` sizes its frame table, and each prediction takes
`--multi-test` crops (the recipe's `multi_test` by default), whose logits
are averaged. Weights are a reference `.pt` state dict or the JAX
package's npz/pickle checkpoints (utils/weights.py). The model runs on
`--device`, `cuda` unless named.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import time
from typing import Optional

import numpy as np


def load_frames(path: str):
    """Load an input sequence -> iterator of (M, 1, V, C) frames."""
    if path.endswith(".skeleton"):
        from agcn_tpu_torch.data.gen.ntu import read_xyz

        seq = np.transpose(read_xyz(path), (3, 1, 2, 0))  # (M, T, V, C)
    elif path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 5:  # (N, C, T, V, M) -> first sample
            arr = arr[0]
        seq = np.transpose(arr, (3, 1, 2, 0))
    else:
        raise ValueError(f"unsupported input {path}")
    for t in range(seq.shape[1]):
        yield seq[:, t:t + 1]


def discover_weights(work_dir: str) -> str:
    """Newest checkpoint file under a work dir (.pt, or the JAX package's
    .npz)."""
    cands = []
    for root, _, files in os.walk(work_dir):
        for f in files:
            if f.endswith((".pt", ".npz")):
                path = os.path.join(root, f)
                cands.append((os.path.getmtime(path), path))
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {work_dir}")
    return sorted(cands)[-1][1]


def iter_stream_files(path: str, follow: bool, poll_s: float = 0.5,
                      max_idle_s: Optional[float] = None):
    """Yield input files: a single file, or every recording in a
    directory in mtime order; with `follow`, keep polling for new ones
    (the live demo loop), until `max_idle_s` seconds pass without one
    (None: forever)."""
    if os.path.isfile(path):
        yield path
        return
    seen = set()
    idle = 0.0
    while True:
        fresh = scan_new_files(path, seen)
        for e in fresh:
            idle = 0.0
            yield e
        if not follow:
            return
        if not fresh:
            idle += poll_s
            if max_idle_s is not None and idle >= max_idle_s:
                return
            time.sleep(poll_s)


def scan_new_files(path: str, seen: set):
    """Non-blocking mtime-ordered scan for unseen recordings; marks
    returned entries as seen. Files that vanish mid-scan are skipped."""
    fresh = []
    for name in os.listdir(path):
        if not name.endswith((".skeleton", ".npy")):
            continue
        e = os.path.join(path, name)
        if e in seen:
            continue
        try:
            fresh.append((os.path.getmtime(e), e))
        except OSError:
            continue  # vanished mid-scan; retry next poll
    fresh.sort()
    out = [e for _, e in fresh]
    seen.update(out)
    return out


def _serve(args, model, kind="dense", sgn_dataloader_args=None,
           labels=None):
    """Multi-stream serving loop (see the module docstring)."""
    from agcn_tpu_torch.infer.serving import BatchedStreamServer

    server = BatchedStreamServer(
        model, max_streams=args.serve, kind=kind, num_joint=args.num_joint,
        max_seq_length=args.max_frame, moving_avg=args.moving_avg,
        max_person=args.max_num_skeleton,
        num_skels=args.max_num_skeleton_true,
        normalize=args.aagcn_normalize, multi_test=args.multi_test,
        allowed_classes=args.allowed_classes,
        sgn_dataloader_args=sgn_dataloader_args)
    streams = {}
    tags = set()
    tag_by_sid = {}
    seen = set()
    backlog = []

    def attach(f):
        sid = server.add_stream()
        tag = os.path.splitext(os.path.basename(f))[0]
        if tag in tags:  # cam0.npy + cam0.skeleton must not clobber
            tag = f"{tag}_{sid}"
        tags.add(tag)
        tag_by_sid[sid] = tag
        streams[sid] = (tag, load_frames(f))
        print(f"++ stream [{tag}]", flush=True)

    def scan_new():
        backlog.extend(scan_new_files(args.input, seen))

    def fill_slots():
        while backlog and len(streams) < args.serve:
            f = backlog.pop(0)
            try:
                attach(f)
            except Exception as e:
                # a half-written or corrupt recording must not take the
                # whole multi-camera server down; drop it and move on
                print(f"!! skipping {os.path.basename(f)}: {e}",
                      flush=True)

    scan_new()
    if not backlog and not args.follow:
        raise FileNotFoundError(f"no input files under {args.input}")
    fill_slots()
    out_files = {}
    if args.out_folder:
        os.makedirs(args.out_folder, exist_ok=True)

    step = 0
    idle = 0.0
    poll_s = 0.5
    pending_step = 0

    def emit(results, at_step):
        for sid, (label, probs) in sorted(results.items()):
            tag = tag_by_sid.get(sid, str(sid))
            name = labels[label] if labels and label < len(labels) \
                else str(label)
            print(f"[{tag}] frame {at_step}: "
                  f"class {name} p={probs[label]:.3f}", flush=True)
            if args.out_folder:
                if sid not in out_files:
                    out_files[sid] = open(os.path.join(
                        args.out_folder, f"results_{tag}.txt"), "w")
                out_files[sid].write(
                    f"{at_step},{label},{probs[label]:.6f}\n")
        if args.timing:
            print(f"tick: {len(results)} streams in "
                  f"{server.last_latency_ms:.1f} ms", flush=True)

    try:
        while True:
            done = []
            for sid, (tag, frames) in streams.items():
                try:
                    frame = next(frames, None)
                except Exception as e:
                    # half-written/corrupt recording: end THIS stream,
                    # keep serving the others
                    print(f"!! stream [{tag}] read error: {e}", flush=True)
                    frame = None
                if frame is None:
                    done.append(sid)
                else:
                    server.append_frame(sid, frame.astype(np.float32))
            for sid in done:
                print(f"-- stream [{streams[sid][0]}] ended", flush=True)
                del streams[sid]
                server.remove_stream(sid)
            if backlog or done or (args.follow
                                   and step % args.interval == 0):
                if args.follow:
                    scan_new()
                fill_slots()
            if not streams:
                # no live stream can answer an in-flight pipelined tick
                # anymore — drain it now, not at loop exit
                if args.pipeline:
                    tail = server.flush()
                    if tail is not None:
                        emit(tail, pending_step)
                if not args.follow and not backlog:
                    break  # all recordings served
                if args.follow:
                    scan_new()
                    fill_slots()
                    if streams:
                        idle = 0.0
                        continue
                idle += poll_s
                if args.max_idle is not None and idle >= args.max_idle:
                    break
                time.sleep(poll_s)
                continue
            idle = 0.0
            step += 1
            if step % args.interval == 0:
                if args.pipeline:
                    # double-buffered: this call answers the PREVIOUS
                    # tick while the device computes this one
                    results = server.predict_async()
                    if results is not None:
                        emit(results, pending_step)
                    pending_step = step
                else:
                    emit(server.predict(), step)
        if args.pipeline:
            tail = server.flush()
            if tail is not None:
                emit(tail, pending_step)
    finally:
        for f in out_files.values():
            f.close()


def _single_stream(args, model, kind="dense", sgn_dataloader_args=None,
                   labels=None):
    """The live demo loop (see the module docstring)."""
    from agcn_tpu_torch.infer.realtime import ActionRecognition

    rec = ActionRecognition(
        model, kind=kind, num_joint=args.num_joint,
        max_seq_length=args.max_frame, moving_avg=args.moving_avg,
        max_person=args.max_num_skeleton,
        num_skels=args.max_num_skeleton_true,
        normalize=args.aagcn_normalize, multi_test=args.multi_test,
        allowed_classes=args.allowed_classes,
        sgn_dataloader_args=sgn_dataloader_args,
        expose_attention=bool(args.save_attention))
    out_f = None
    if args.out_folder:
        os.makedirs(args.out_folder, exist_ok=True)
        out_f = open(os.path.join(args.out_folder, "results.txt"), "w")
    if args.save_attention:
        from agcn_tpu_torch.utils.visualization import plot_attention

        os.makedirs(args.save_attention, exist_ok=True)
    try:
        for src in iter_stream_files(args.input, args.follow,
                                     max_idle_s=args.max_idle):
            tag = os.path.splitext(os.path.basename(src))[0]
            if os.path.isdir(args.input):
                print(f"== {src}", flush=True)
            for i, frame in enumerate(load_frames(src)):
                rec.append_frame(frame.astype(np.float32))
                if (i + 1) % args.interval:
                    continue
                label, probs = rec.predict()
                name = labels[label] if labels and label < len(labels) \
                    else str(label)
                line = f"frame {i + 1}: class {name} p={probs[label]:.3f}"
                if args.timing:
                    line += f" ({rec.last_latency_ms:.1f} ms)"
                print(line, flush=True)
                if out_f:
                    out_f.write(f"{i + 1},{label},{probs[label]:.6f}\n")
                if args.save_attention:
                    if not rec.last_attention:
                        raise RuntimeError(
                            f"--save-attention: {type(model).__name__} "
                            "exposes no graph to draw (no unit records "
                            "one, and no SGN G list)")
                    # the reference live demo's G heatmap
                    # (inference_220802.py:518-560)
                    plot_attention(rec.last_attention[0], save_path=(
                        os.path.join(args.save_attention,
                                     f"{tag}_f{i + 1}_g0.png")))
    finally:
        if out_f:
            out_f.close()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m agcn_tpu_torch.infer")
    p.add_argument("--config", required=True)
    p.add_argument("--weights", default=None,
                   help=".pt state dict, or a JAX npz/pickle checkpoint")
    p.add_argument("--weights-dir", default=None,
                   help="auto-discover the newest checkpoint under this "
                        "work dir")
    p.add_argument("--input", required=True,
                   help="a .skeleton/.npy recording, or a directory of "
                        "them")
    p.add_argument("--follow", action="store_true",
                   help="keep watching --input (a directory) for new "
                        "files")
    p.add_argument("--max-idle", type=float, default=None,
                   help="with --follow: exit after this many seconds "
                        "without new files (default: poll forever)")
    p.add_argument("--save-attention", type=str, default=None,
                   help="without --serve: draw each prediction's first "
                        "block graph as a png heatmap into this "
                        "directory (needs matplotlib)")
    p.add_argument("--interval", type=int, default=10,
                   help="predict every N frames")
    p.add_argument("--timing", action="store_true")
    p.add_argument("--moving-avg", type=int, default=1)
    p.add_argument("--max-frame", type=int, default=300)
    p.add_argument("--allowed-classes", type=int, nargs="*", default=None)
    p.add_argument("--num-joint", type=int, default=None,
                   help="override the model's joint count")
    p.add_argument("--max-num-skeleton", type=int, default=4,
                   help="ring-buffer person slots")
    p.add_argument("--max-num-skeleton-true", type=int, default=2,
                   help="skeletons fed to the model (energy-selected)")
    p.add_argument("--aagcn-normalize", type=lambda s: s.lower() in
                   ("1", "true", "yes"), default=True)
    p.add_argument("--multi-test", type=int, default=None,
                   help="SGN crops a stream (default: the recipe's "
                        "test_dataloader_args multi_test)")
    p.add_argument("--label-mapping-file", type=str, default=None,
                   help="text file: one class name per line")
    p.add_argument("--out-folder", type=str, default=None,
                   help="write per-frame predictions into this directory "
                        "(results.txt, or with --serve results_<stream>.txt)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    p.add_argument("--pipeline", action="store_true",
                   help="double-buffer host preprocessing "
                        "against device compute (predict_async) — each "
                        "tick prints the previous tick's answers")
    p.add_argument("--serve", type=int, default=0, metavar="N",
                   help="multi-stream mode: treat the files in --input "
                        "(a directory) as up to N concurrent streams, "
                        "served in lock-step by ONE batched forward per "
                        "tick")
    args = p.parse_args(argv)
    if not args.weights and not args.weights_dir:
        p.error("--weights or --weights-dir required")
    if args.serve and not os.path.isdir(args.input):
        p.error("--serve requires --input to be a directory")
    if args.save_attention:
        if args.serve:
            p.error("--save-attention draws the single-stream mode's "
                    "predictions; drop --serve")
        if importlib.util.find_spec("matplotlib") is None:
            p.error("--save-attention draws with matplotlib, which is not "
                    "installed")

    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.train.checkpoint import load_checkpoint
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    kind = "sgn" if "sgn" in cfg.model.lower() else "dense"
    sgn_args = cfg.test_dataloader_args if kind == "sgn" else None
    if args.multi_test is None:
        args.multi_test = (sgn_args.get("multi_test", 1) if kind == "sgn"
                           else 1)
    # the model's input length: the served window (--max-frame), or an
    # SGN model's segments (its one-hot frame table)
    num_frame = (sgn_args.get("seg", 20) if kind == "sgn"
                 else args.max_frame)
    model = build_model(cfg.model, cfg.model_args, device=args.device,
                        num_frame=num_frame)
    weights = args.weights or discover_weights(args.weights_dir)
    # the port trainer's own checkpoints, the JAX package's and reference
    # state dicts alike
    model.load_state_dict(load_checkpoint(weights, cfg.model,
                                          cfg.model_args)["model"],
                          strict=True)
    model.eval()
    if args.num_joint is None:
        args.num_joint = cfg.model_args.get("num_point", 25)
    labels = None
    if args.label_mapping_file:
        with open(args.label_mapping_file) as f:
            labels = [ln.strip() for ln in f if ln.strip()]
    run = _serve if args.serve else _single_stream
    return run(args, model, kind=kind, sgn_dataloader_args=sgn_args,
               labels=labels)
