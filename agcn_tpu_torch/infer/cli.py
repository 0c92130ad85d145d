"""Streaming inference CLI of the port (port of the root infer.py).

    python -m agcn_tpu_torch.infer --config configs/ntu60_xview/test_joint.yaml \
        --weights agcn_joint.pt --input recordings/ --serve 16 --pipeline \
        --timing

Each file in --input (a directory of `.npy` or `.skeleton` recordings) is
one live stream; all streams advance in lock-step and every --interval
frames ONE batched forward answers all of them (infer/serving.py). The
single-stream mode of the root infer.py is not ported yet (ROADMAP).
Weights are a reference `.pt` state dict or the JAX package's npz/pickle
checkpoints (utils/weights.py). The model runs on `--device`, `cuda`
unless named.
"""

from __future__ import annotations

import argparse
import os
import time

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


def _serve(args, model, labels=None):
    """Multi-stream serving loop (see the module docstring)."""
    from agcn_tpu_torch.infer.serving import BatchedStreamServer

    server = BatchedStreamServer(
        model, max_streams=args.serve, num_joint=args.num_joint,
        max_seq_length=args.max_frame, moving_avg=args.moving_avg,
        max_person=args.max_num_skeleton,
        num_skels=args.max_num_skeleton_true,
        normalize=args.aagcn_normalize,
        allowed_classes=args.allowed_classes)
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


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m agcn_tpu_torch.infer")
    p.add_argument("--config", required=True)
    p.add_argument("--weights", default=None,
                   help=".pt state dict, or a JAX npz/pickle checkpoint")
    p.add_argument("--weights-dir", default=None,
                   help="auto-discover the newest checkpoint under this "
                        "work dir")
    p.add_argument("--input", required=True,
                   help="a directory of .skeleton/.npy recordings")
    p.add_argument("--follow", action="store_true",
                   help="keep watching --input for new files")
    p.add_argument("--max-idle", type=float, default=None,
                   help="with --follow: exit after this many seconds "
                        "without new files (default: poll forever)")
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
    p.add_argument("--label-mapping-file", type=str, default=None,
                   help="text file: one class name per line")
    p.add_argument("--out-folder", type=str, default=None,
                   help="write per-frame predictions into this directory")
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
    if args.serve < 1:
        p.error("--serve N is required: the port serves multi-stream only")
    if not os.path.isdir(args.input):
        p.error("--serve requires --input to be a directory")

    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.train.checkpoint import load_checkpoint
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(args.config)
    model = build_model(cfg.model, cfg.model_args, device=args.device)
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
    return _serve(args, model, labels=labels)
