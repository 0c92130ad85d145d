"""Skeleton sequence augmentations of the dense dataset (host-side numpy;
copy of agcn_tpu/data/transforms.py:22-194, the functions SkeletonDataset
uses).

Functional parity targets: reference feeders/tools.py (auto_pading :36-44,
random_choose :93-105, random_move :108-152, random_rotation :181-193,
random_shift :196-208, random_subsample :212-218, flips/scales :47-90,
stretch_to_maximum_length :221-231). Every op takes an explicit numpy
Generator, so the pipeline is reproducible without global RNG state and
draws the same numbers as the JAX package's. Layout is the on-disk
contract (C, T, V, M) per sample. The SGN batch and segment ops wait for
SGN (ROADMAP Queue 1: SGN family).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def auto_pad(x: np.ndarray, size: int, random_pad: bool = False,
             rng: Optional[np.random.Generator] = None) -> np.ndarray:
    c, t, v, m = x.shape
    if t >= size:
        return x
    begin = int(rng.integers(0, size - t + 1)) if random_pad and rng is not \
        None else 0
    out = np.zeros((c, size, v, m), dtype=x.dtype)
    out[:, begin:begin + t] = x
    return out


def random_choose(x: np.ndarray, size: int,
                  rng: np.random.Generator,
                  auto_pad_short: bool = True) -> np.ndarray:
    """Random temporal crop to `size` frames."""
    c, t, v, m = x.shape
    if t == size:
        return x
    if t < size:
        return auto_pad(x, size, random_pad=True, rng=rng) \
            if auto_pad_short else x
    begin = int(rng.integers(0, t - size + 1))
    return x[:, begin:begin + size]


def random_shift(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Re-place the valid span at a random temporal offset."""
    c, t, v, m = x.shape
    out = np.zeros_like(x)
    valid = (x != 0).sum(axis=(0, 2, 3)) > 0
    if not valid.any():
        return out
    begin = int(valid.argmax())
    end = int(len(valid) - valid[::-1].argmax())
    size = end - begin
    bias = int(rng.integers(0, t - size + 1))
    out[:, bias:bias + size] = x[:, begin:end]
    return out


def random_move(x: np.ndarray, rng: np.random.Generator,
                angle_candidate=(-10.0, -5.0, 0.0, 5.0, 10.0),
                scale_candidate=(0.9, 1.0, 1.1),
                transform_candidate=(-0.2, -0.1, 0.0, 0.1, 0.2),
                move_time_candidate=(1,)) -> np.ndarray:
    """Piecewise-linear 2D rotation/scale/translation over time."""
    x = x.copy()
    c, t, v, m = x.shape
    move_time = move_time_candidate[int(rng.integers(len(move_time_candidate)))]
    node = np.arange(0, t, t * 1.0 / move_time).round().astype(int)
    node = np.append(node, t)
    n = len(node)

    angles = rng.choice(angle_candidate, n)
    scales = rng.choice(scale_candidate, n)
    tx = rng.choice(transform_candidate, n)
    ty = rng.choice(transform_candidate, n)

    a = np.zeros(t)
    s = np.zeros(t)
    t_x = np.zeros(t)
    t_y = np.zeros(t)
    for i in range(n - 1):
        span = node[i + 1] - node[i]
        a[node[i]:node[i + 1]] = np.linspace(
            angles[i], angles[i + 1], span) * np.pi / 180
        s[node[i]:node[i + 1]] = np.linspace(scales[i], scales[i + 1], span)
        t_x[node[i]:node[i + 1]] = np.linspace(tx[i], tx[i + 1], span)
        t_y[node[i]:node[i + 1]] = np.linspace(ty[i], ty[i + 1], span)

    theta = np.array([[np.cos(a) * s, -np.sin(a) * s],
                      [np.sin(a) * s, np.cos(a) * s]])  # (2, 2, T)
    xy = x[0:2]  # (2, T, V, M)
    new_xy = np.einsum("ijt,jtvm->itvm", theta, xy)
    new_xy[0] += t_x[:, None, None]
    new_xy[1] += t_y[:, None, None]
    x[0:2] = new_xy
    return x


def rotation_matrices(rot: np.ndarray) -> np.ndarray:
    """(N, T, 3) euler angles -> (N, T, 3, 3) Rz @ Ry @ Rx matrices
    (reference feeders/tools.py:155-177 `_rot`)."""
    cos_r, sin_r = np.cos(rot), np.sin(rot)
    n, t, _ = rot.shape
    zeros = np.zeros((n, t))
    ones = np.ones((n, t))

    rx = np.stack([
        np.stack([ones, zeros, zeros], -1),
        np.stack([zeros, cos_r[..., 0], sin_r[..., 0]], -1),
        np.stack([zeros, -sin_r[..., 0], cos_r[..., 0]], -1),
    ], -2)
    ry = np.stack([
        np.stack([cos_r[..., 1], zeros, -sin_r[..., 1]], -1),
        np.stack([zeros, ones, zeros], -1),
        np.stack([sin_r[..., 1], zeros, cos_r[..., 1]], -1),
    ], -2)
    rz = np.stack([
        np.stack([cos_r[..., 2], sin_r[..., 2], zeros], -1),
        np.stack([-sin_r[..., 2], cos_r[..., 2], zeros], -1),
        np.stack([zeros, zeros, ones], -1),
    ], -2)
    return rz @ ry @ rx


def random_rotation(x: np.ndarray, theta: float,
                    rng: np.random.Generator) -> np.ndarray:
    """SGN-style 3D rotation with one angle triple per sample."""
    c, t, v, m = x.shape
    rot = rng.uniform(-theta, theta, (1, 3))
    rot = np.broadcast_to(rot[:, None, :], (1, t, 3))
    mats = rotation_matrices(rot)[0]  # (T, 3, 3)
    # x: (C=3, T, V, M) -> rotate each frame's joints
    pts = x.transpose(1, 0, 2, 3).reshape(t, c, v * m)  # (T, 3, VM)
    out = np.matmul(mats, pts)  # (T, 3, VM)
    return out.reshape(t, c, v, m).transpose(1, 0, 2, 3).astype(x.dtype)


def random_flip(x: np.ndarray, channel: int,
                rng: np.random.Generator) -> np.ndarray:
    if rng.random() > 0.5:
        x = x.copy()
        x[channel] = -x[channel]
    return x


def random_axis_scale(x: np.ndarray, channel: int, rng: np.random.Generator,
                      candidate=(0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2,
                                 1.3, 1.4, 1.5)) -> np.ndarray:
    """Scale the person-1-to-person-0 distance along an axis."""
    x = x.copy()
    s = rng.choice(candidate)
    distance = x[channel, :, :, 1] - x[channel, :, :, 0]
    x[channel, :, :, 1] = x[channel, :, :, 0] + distance * s
    return x


def random_subsample(x: np.ndarray, freq: int,
                     rng: np.random.Generator) -> np.ndarray:
    """One random frame per equal segment."""
    c, t, v, m = x.shape
    seg_len = t // freq
    offsets = np.arange(freq) * seg_len + rng.integers(seg_len, size=freq)
    return x[:, offsets]


def stretch_to_maximum_length(x: np.ndarray) -> np.ndarray:
    """Linearly resample the valid span to fill the padded length."""
    from scipy import interpolate

    c, t, v, m = x.shape
    nonzero = np.where(np.flip(x.sum((0, 2, 3))) != 0.0)[0]
    if len(nonzero) == 0:
        return x
    t_last = t - nonzero[0]
    flat = x[:, :t_last].transpose(0, 2, 3, 1).reshape(c * v * m, -1)
    f = interpolate.interp1d(np.arange(t_last), flat)
    out = f(np.linspace(0, t_last - 1, t))
    return out.reshape(c, v, m, t).transpose(0, 3, 1, 2).astype(x.dtype)
