"""SGN raw data-generation chain: raw `.skeleton` text -> denoised,
translated, aligned (N, 300, 150) SGN arrays + CS/CV splits (port of
agcn_tpu/data/gen/sgn_raw.py, numpy only).

Functional-parity targets (same numbers, re-implemented with explicit
vectorized numpy and no global/logger state):
- body parsing + per-body tracking: reference
  data_gen/sgn/get_raw_skes_data.py:14-106
- denoising heuristics (length / x-y spread / motion ordering): reference
  data_gen/sgn/get_raw_denoised_data.py:21-175 with thresholds
  :442-447 (noise_len_thres=11, spread 0.8 / 0.69754)
- two-actor assembly with interval packing + missing-frame removal:
  get_raw_denoised_data.py:242-347,194-239
- sequence translation to the first valid frame's spine origin, frame
  alignment, and CS/CV splits: data_gen/sgn/seq_transformation.py:42-135,
  147-251.

The max-energy selection used by the dense NTU pipeline is NOT equivalent
to these heuristics (they decide differently on short/noisy bodies) —
this module reproduces the reference decisions exactly.

The parse stays in Python (each joint row read as float64, then cast to
float32), not the C++ `parse_skeleton`, which selects bodies its own way.
The train/val split draws scikit-learn's `train_test_split` permutation
with numpy alone (`split_train_val`), so the chain runs where
scikit-learn is not installed; pre-normalization is the port's
(`data/gen/preprocess.py`: the C++ host kernel where g++ exists, numpy
elsewhere).
"""

from __future__ import annotations

import math
import os
import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_BODY_LEN_THRES = 11          # noise_len_thres (:443)
SPREAD_RATIO_THRES = 0.8         # noise_spr_thres1 (:444)
SPREAD_FRAME_RATIO_THRES = 0.69754  # noise_spr_thres2 (:445)
MAX_FRAME = 300
NUM_JOINTS = 25


@dataclass
class Body:
    """One tracked bodyID's data across its frames."""
    joints: np.ndarray            # (F, 25, 3)
    colors: np.ndarray            # (F, 25, 2)
    interval: np.ndarray          # (F,) valid-frame indices (contiguous)
    motion: float = 0.0


@dataclass
class RawSkeleton:
    name: str
    bodies: Dict[str, Body] = field(default_factory=dict)
    num_frames: int = 0           # valid (non-empty) frames


def parse_skeleton_text(text: str, name: str = "") -> RawSkeleton:
    """Parse NTU `.skeleton` file text into per-bodyID tracks.

    Mirrors get_raw_bodies_data (get_raw_skes_data.py:14-106): frames with
    zero bodies are dropped; each bodyID accumulates joints/colors per
    valid frame; motion = sum of per-axis variance over all its joint
    rows, computed only when the sequence has >= 2 bodyIDs.
    """
    lines = text.splitlines()
    num_frames = int(lines[0])
    pos = 1
    valid = -1
    acc: Dict[str, dict] = {}
    dropped = 0
    for _ in range(num_frames):
        num_bodies = int(lines[pos]); pos += 1
        if num_bodies == 0:
            dropped += 1
            continue
        valid += 1
        for _ in range(num_bodies):
            body_id = lines[pos].split()[0]; pos += 1
            num_joints = int(lines[pos]); pos += 1
            rows = np.array(
                [lines[pos + j].split() for j in range(num_joints)],
                dtype=np.float64)
            pos += num_joints
            j3 = rows[:, :3].astype(np.float32)
            c2 = rows[:, 5:7].astype(np.float32)
            slot = acc.setdefault(body_id,
                                  {"joints": [], "colors": [],
                                   "interval": []})
            slot["joints"].append(j3)
            slot["colors"].append(c2)
            # bug-compatible: the reference chains interval indices as
            # previous+1 from first appearance (get_raw_skes_data.py:84-86)
            # rather than recording the true frame index, so a body that
            # skips frames is treated as one contiguous block
            slot["interval"].append(
                slot["interval"][-1] + 1 if slot["interval"] else valid)
    ske = RawSkeleton(name=name, num_frames=num_frames - dropped)
    for body_id, slot in acc.items():
        ske.bodies[body_id] = Body(
            joints=np.stack(slot["joints"]),
            colors=np.stack(slot["colors"]),
            interval=np.asarray(slot["interval"], np.int64))
    if len(ske.bodies) > 1:
        for b in ske.bodies.values():
            # reference stacks all frames' 25 joints into rows and takes
            # np.sum(np.var(joints, axis=0)) (get_raw_skes_data.py:101)
            flat = b.joints.reshape(-1, 3)
            b.motion = float(np.sum(np.var(flat, axis=0)))
    return ske


def parse_skeleton_file(path: str) -> RawSkeleton:
    with open(path) as f:
        return parse_skeleton_text(
            f.read(), os.path.basename(path).replace(".skeleton", ""))


# -- denoising -----------------------------------------------------------

def _spread_valid_frames(joints: np.ndarray) -> np.ndarray:
    """Frames whose x-range <= 0.8 * y-range are 'valid'
    (get_raw_denoised_data.py:45-60)."""
    x = joints[..., 0]
    y = joints[..., 1]
    return (x.max(-1) - x.min(-1)) <= SPREAD_RATIO_THRES * (y.max(-1)
                                                            - y.min(-1))


def denoise_bodies(ske: RawSkeleton) -> List[Tuple[str, Body]]:
    """Length filter -> spread filter -> sort by motion (descending).

    Reference denoising_bodies_data (get_raw_denoised_data.py:138-175);
    the motion-interval filter (:108-135) is dead code there and is not
    applied here either.
    """
    bodies = dict(ske.bodies)
    # step 1: frame-length filter (:21-42)
    bodies = {bid: b for bid, b in bodies.items()
              if len(b.interval) > MAX_BODY_LEN_THRES}
    if not bodies:
        # the reference would crash here; keep the longest body so the
        # sample survives (explicit, logged divergence)
        bid = max(ske.bodies, key=lambda k: len(ske.bodies[k].interval))
        return [(bid, ske.bodies[bid])]
    if len(bodies) == 1:
        return list(bodies.items())
    # step 2: x/y-spread filter (:63-105)
    bodies_after = dict(bodies)
    for bid, b in bodies.items():
        if len(bodies_after) == 1:
            break
        valid = _spread_valid_frames(b.joints)
        num_noise = int((~valid).sum())
        if num_noise == 0:
            continue
        ratio = num_noise / float(len(b.interval))
        if ratio >= SPREAD_FRAME_RATIO_THRES:
            del bodies_after[bid]
        else:
            flat = b.joints[valid].reshape(-1, 3)
            b.motion = min(b.motion, float(np.sum(np.var(flat, axis=0))))
    bodies = bodies_after
    if len(bodies) == 1:
        return list(bodies.items())
    # step 3: order by motion, largest first (:166-175)
    return sorted(bodies.items(), key=lambda kv: kv[1].motion,
                  reverse=True)


# -- actor assembly ------------------------------------------------------

def _one_actor_points(body: Body, num_frames: int) -> np.ndarray:
    """(num_frames, 75) with the body placed at its interval
    (get_raw_denoised_data.py:242-255)."""
    joints = np.zeros((num_frames, 75), np.float32)
    start, end = int(body.interval[0]), int(body.interval[-1])
    joints[start:end + 1] = body.joints.reshape(-1, 75)
    return joints


def assemble_actors(ske: RawSkeleton) -> np.ndarray:
    """Denoise and pack bodies into at most two actor slots.

    Returns (F, 75) for a single body or (F', 150) for multi-body
    sequences (after removing frames where every joint is zero), matching
    get_two_actors_points + remove_missing_frames
    (get_raw_denoised_data.py:268-347,194-239,388-397).
    """
    if len(ske.bodies) == 1:
        # single-bodyID sequences skip missing-frame removal
        # (get_raw_denoised_data.py:388-391)
        body = next(iter(ske.bodies.values()))
        return _one_actor_points(body, ske.num_frames)

    ordered = denoise_bodies(ske)
    if len(ordered) == 1:
        joints = _one_actor_points(ordered[0][1], ske.num_frames)
        return joints[joints.sum(axis=1) != 0]

    joints = np.zeros((ske.num_frames, 150), np.float32)
    _, actor1 = ordered[0]
    start1, end1 = int(actor1.interval[0]), int(actor1.interval[-1])
    joints[start1:end1 + 1, :75] = actor1.joints.reshape(-1, 75)
    start2, end2 = 0, 0  # virtual initial interval for actor2
    for _, actor in ordered[1:]:
        start, end = int(actor.interval[0]), int(actor.interval[-1])
        if min(end1, end) - max(start1, start) <= 0:   # no overlap w/ 1
            joints[start:end + 1, :75] = actor.joints.reshape(-1, 75)
            start1, end1 = min(start, start1), max(end, end1)
        elif min(end2, end) - max(start2, start) <= 0:  # no overlap w/ 2
            joints[start:end + 1, 75:] = actor.joints.reshape(-1, 75)
            start2, end2 = min(start, start2), max(end, end2)
        # else: dropped (no third slot)
    # remove frames where BOTH actors are all-zero (:224-232)
    keep = joints.sum(axis=1) != 0
    return joints[keep]


# -- sequence transformation --------------------------------------------

def seq_translation(seqs: List[np.ndarray]) -> List[np.ndarray]:
    """Translate each sequence by actor1's first-valid-frame spine-middle
    (joint 2) origin, preserving zero frames
    (seq_transformation.py:42-78)."""
    out = []
    for ske in seqs:
        ske = ske.copy()
        two = ske.shape[1] == 150
        nz = np.flatnonzero(ske[:, :75].any(axis=1))
        if nz.size == 0:
            out.append(ske)
            continue
        origin = ske[nz[0], 3:6].copy()  # joint-2 xyz
        if two:
            miss1 = ske[:, :75].sum(axis=1) == 0
            miss2 = ske[:, 75:].sum(axis=1) == 0
            ske -= np.tile(origin, 50)
            ske[miss1, :75] = 0.0
            ske[miss2, 75:] = 0.0
        else:
            miss = ske.sum(axis=1) == 0
            ske -= np.tile(origin, 25)
            ske[miss] = 0.0
        out.append(ske)
    return out


def align_frames(seqs: List[np.ndarray],
                 max_frame: int = MAX_FRAME) -> np.ndarray:
    """Zero-pad every sequence to (N, max_frame, 150)
    (seq_transformation.py:116-135)."""
    out = np.zeros((len(seqs), max_frame, 150), np.float32)
    for i, ske in enumerate(seqs):
        f = min(ske.shape[0], max_frame)
        if ske.shape[1] == 75:
            out[i, :f, :75] = ske[:f]
        else:
            out[i, :f] = ske[:f]
    return out


# -- splits + the whole chain --------------------------------------------

# single source of truth for the NTU split tables lives in gen/ntu.py
from agcn_tpu_torch.data.gen.ntu import (  # noqa: E402
    TRAINING_CAMERAS as CV_TRAIN_CAMERAS, TRAINING_SUBJECTS as CS_TRAIN_IDS)


def split_indices(performer: np.ndarray, camera: np.ndarray,
                  evaluation: str) -> Tuple[np.ndarray, np.ndarray]:
    """Train/test indices for CS (subjects) or CV (cameras)
    (seq_transformation.py:218-251; order-preserving per id group)."""
    if evaluation == "CS":
        test_ids = [i for i in range(1, 41) if i not in CS_TRAIN_IDS]
        train = np.concatenate([np.where(performer == i)[0]
                                for i in CS_TRAIN_IDS])
        test = np.concatenate([np.where(performer == i)[0]
                               for i in test_ids])
    else:
        train = np.concatenate([np.where(camera == i)[0]
                                for i in CV_TRAIN_CAMERAS])
        test = np.where(camera == 1)[0]
    return train.astype(int), test.astype(int)


def split_train_val(train_indices: np.ndarray, ratio: float = 0.05,
                    seed: int = 10000) -> Tuple[np.ndarray, np.ndarray]:
    """(train, val): sklearn's train_test_split(test_size=ratio,
    random_state=seed) (seq_transformation.py:147-166) without sklearn. Its
    ShuffleSplit draws one RandomState(seed) permutation p of the n
    indices; val takes p[:ceil(ratio n)], train the rest, in p's order."""
    train_indices = np.asarray(train_indices)
    n = len(train_indices)
    n_val = math.ceil(ratio * n)
    if n - n_val <= 0:  # sklearn's own refusal
        raise ValueError(f"With n_samples={n}, test_size={ratio} the "
                         "resulting train set will be empty")
    p = np.random.RandomState(seed).permutation(n)
    return train_indices[p[n_val:]], train_indices[p[:n_val]]


def gendata_from_raw(skeleton_paths: Sequence[str],
                     labels: np.ndarray,
                     performer: np.ndarray,
                     camera: np.ndarray,
                     out_dir: str,
                     evaluations: Sequence[str] = ("CS", "CV"),
                     max_frame: int = MAX_FRAME,
                     val_ratio: float = 0.05) -> np.ndarray:
    """Full raw -> SGN pkl pipeline (reference __main__ chains of
    get_raw_skes_data / get_raw_denoised_data / seq_transformation).

    Writes NTU_{eval}_{train,val,test}.pkl (+ *_label.pkl) into out_dir
    and returns the aligned (N, max_frame, 150) array.
    """
    from agcn_tpu_torch.data.gen.preprocess import pre_normalization

    seqs = [assemble_actors(parse_skeleton_file(p))
            for p in skeleton_paths]
    seqs = seq_translation(seqs)
    aligned = align_frames(seqs, max_frame)
    # (N, T, 150) -> (N, 3, T, 25, 2) for the shared pre-normalization
    n = aligned.shape[0]
    dense = aligned.reshape(n, max_frame, 2, NUM_JOINTS, 3)
    dense = np.transpose(dense, (0, 4, 1, 3, 2))
    dense = pre_normalization(dense, zaxis=(0, 1), xaxis=(8, 4),
                              pad=False, center=False)
    aligned = np.transpose(dense, (0, 2, 4, 3, 1)).reshape(
        n, max_frame, 150).astype(np.float32)

    os.makedirs(out_dir, exist_ok=True)
    labels = np.asarray(labels)
    for ev in evaluations:
        train, test = split_indices(np.asarray(performer),
                                    np.asarray(camera), ev)
        train, val = split_train_val(train, val_ratio)
        for split, idx in (("train", train), ("val", val), ("test", test)):
            with open(os.path.join(out_dir, f"NTU_{ev}_{split}.pkl"),
                      "wb") as f:
                pickle.dump(aligned[idx], f, pickle.HIGHEST_PROTOCOL)
            with open(os.path.join(out_dir,
                                   f"NTU_{ev}_{split}_label.pkl"),
                      "wb") as f:
                pickle.dump(labels[idx], f, pickle.HIGHEST_PROTOCOL)
    return aligned


def load_statistics(stat_dir: str,
                    skeleton_root: Optional[str] = None):
    """Read the reference's NTU metadata tables
    (data_gen/sgn/statistics/*.txt: skes_available_name, label,
    performer, camera, samples_with_missing_skeletons) and return
    (skeleton_paths, labels, performer, camera) ready for
    `gendata_from_raw` — samples listed as missing are filtered out.

    Labels in label.txt are 1-based (reference seq_transformation.py
    one-hots `labels - 1`); returned labels are 0-based.
    """
    def column(name):
        with open(os.path.join(stat_dir, name)) as f:
            return [ln.strip() for ln in f if ln.strip()]

    names = column("skes_available_name.txt")
    labels = np.asarray([int(x) for x in column("label.txt")]) - 1
    performer = np.asarray([int(x) for x in column("performer.txt")])
    camera = np.asarray([int(x) for x in column("camera.txt")])
    missing_file = os.path.join(stat_dir,
                                "samples_with_missing_skeletons.txt")
    missing = set()
    if os.path.exists(missing_file):
        with open(missing_file) as f:
            missing = {ln.strip() for ln in f if ln.strip()}
    keep = np.asarray([n not in missing for n in names])
    names = [n for n, k in zip(names, keep) if k]
    root = skeleton_root or ""
    paths = [os.path.join(root, n + ".skeleton") for n in names]
    return paths, labels[keep], performer[keep], camera[keep]
