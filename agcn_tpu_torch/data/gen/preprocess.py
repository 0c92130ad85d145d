"""Sequence pre-normalization (copy of the numpy path of
agcn_tpu/data/gen/preprocess.py `pre_normalization`).

Parity target: reference data_gen/preprocess.py:13-147: pad null frames
by repeating the leading frames, center on the main body's spine joint
(whole-sequence or first-valid-frame variants), then rotate so hip->spine
is parallel to z and the shoulder line parallel to x. The C++ host kernel
of the JAX package (native/skelio.cpp) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from agcn_tpu_torch.data.gen.rotation import align_rotation


def _pad_null_frames(person: np.ndarray) -> np.ndarray:
    """Shift leading zeros out and tile the valid prefix over the tail."""
    if person.sum() == 0:
        return person
    if person[0].sum() == 0:
        index = person.sum(-1).sum(-1) != 0
        tmp = person[index].copy()
        person = np.zeros_like(person)
        person[: len(tmp)] = tmp
    for i_f in range(1, len(person)):
        if person[i_f].sum() == 0:
            if person[i_f:].sum() == 0:
                rest = len(person) - i_f
                num = int(np.ceil(rest / i_f))
                pad = np.concatenate([person[:i_f]] * num, 0)[:rest]
                person[i_f:] = pad
                break
    return person


def pre_normalization(data: np.ndarray,
                      zaxis: Optional[Sequence[int]] = (0, 1),
                      xaxis: Optional[Sequence[int]] = (8, 4),
                      pad: bool = True,
                      center: bool = True,
                      center_firstframe: bool = False) -> np.ndarray:
    """Normalize (N, C, T, V, M) skeleton data into a new array."""
    if center or center_firstframe:
        assert center != center_firstframe
    n, c, t, v, m = data.shape
    s = np.transpose(data, (0, 4, 2, 3, 1)).copy()  # N, M, T, V, C

    for i_s in range(n):
        skeleton = s[i_s]
        if skeleton.sum() == 0:
            continue

        if pad:
            for i_p in range(m):
                skeleton[i_p] = _pad_null_frames(skeleton[i_p])

        if center or center_firstframe:
            if center:
                body_center = skeleton[0, :, 1:2, :].copy()  # (T, 1, C)
            else:
                i = 0
                while i < t and not np.any(skeleton[0, i]):
                    i += 1
                i = min(i, t - 1)
                body_center = skeleton[0, i:i + 1, 1:2, :].copy()  # (1,1,C)
            for i_p in range(m):
                person = skeleton[i_p]
                if person.sum() == 0:
                    continue
                mask = (person.sum(-1) != 0)[..., None]  # (T, V, 1)
                skeleton[i_p] = (person - body_center) * mask

        # z: bottom->top bone to the z axis; x: right->left shoulder line
        # to the x axis (reference preprocess.py:87-125; applied in order,
        # the x alignment sees the z-rotated skeleton)
        alignments = []
        if zaxis is not None:
            alignments.append((zaxis[0], zaxis[1],
                               np.array([0.0, 0.0, 1.0])))
        if xaxis is not None:
            alignments.append((xaxis[1], xaxis[0],
                               np.array([1.0, 0.0, 0.0])))
        for j_from, j_to, target in alignments:
            bone = skeleton[0, 0, j_to] - skeleton[0, 0, j_from]
            mat = align_rotation(bone, target)
            # apply to every valid frame of every person, vectorized
            for i_p in range(m):
                person = skeleton[i_p]
                if person.sum() == 0:
                    continue
                valid = person.sum((-1, -2)) != 0  # (T,)
                rotated = person @ mat.T
                skeleton[i_p] = np.where(valid[:, None, None], rotated,
                                         person)

        s[i_s] = skeleton

    return np.transpose(s, (0, 4, 2, 3, 1))
