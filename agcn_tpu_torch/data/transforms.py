"""Skeleton sequence augmentations (host-side numpy; copy of
agcn_tpu/data/transforms.py: the functions SkeletonDataset uses, :22-194,
the SGN batch rotation and segment splits, :142 and :199-275, and
openpose_match, :277; the k-means split without scikit-learn).

Functional parity targets: reference feeders/tools.py (auto_pading :36-44,
random_choose :93-105, random_move :108-152, random_rotation :181-193,
random_shift :196-208, random_subsample :212-218, flips/scales :47-90,
stretch_to_maximum_length :221-231, openpose_match :234-275, the batch
rotation :278-314, the AUC and k-means segment splits :317-398). Every op
takes an explicit numpy Generator, so the pipeline is reproducible without
global RNG state and draws the same numbers as the JAX package's. Layout
is the on-disk contract (C, T, V, M) per sample; the SGN batch ops act on
(N, T, M*V*C).
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


def batch_rotation(x: np.ndarray, theta: float,
                   rng: np.random.Generator) -> np.ndarray:
    """Train-time batch rotation for SGN segments
    (reference tools.py:302-314): x is (N, T, M*V*C), one angle triple per
    sample applied to every (V, 3) point."""
    n, t, d = x.shape
    pts = x.reshape(n, t, d // 3, 3)
    rot = rng.uniform(-theta, theta, (n, 3)).astype(x.dtype)
    rot = np.broadcast_to(rot[:, None, :], (n, t, 3))
    mats = rotation_matrices(rot)  # (N, T, 3, 3)
    out = np.einsum("ntij,ntpj->ntpi", mats, pts)
    return out.reshape(n, t, d).astype(x.dtype)


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


# --- segment-splitting policies for the SGN sampler -----------------------

def cumulative_auc(x: np.ndarray, norm: bool = False) -> np.ndarray:
    """Cumulative trapezoid AUC (reference tools.py:317-322)."""
    if norm:
        x = np.linalg.norm(x, axis=1)
    return (np.cumsum(x[:-1]) + np.cumsum(x[1:])) / 2


def split_idx_equal(length: int, num_segments: int) -> np.ndarray:
    avg = length / num_segments
    return (np.arange(num_segments + 1) * avg).round().astype(int)


def split_idx_using_auc(x: np.ndarray, num_segments: int) -> np.ndarray:
    """Motion-equal segmentation: segment bounds equalize the cumulative
    feature-norm AUC (reference tools.py:325-379, simplified repair pass).
    """
    n = x.shape[0]
    if n == num_segments:
        return np.arange(num_segments + 1)
    cum = cumulative_auc(x, norm=True)
    if cum[-1] <= 0:
        return split_idx_equal(n, num_segments)
    # target cumulative levels -> first index crossing each level
    levels = cum[-1] * np.arange(1, num_segments) / num_segments
    bounds = np.searchsorted(cum, levels) + 1
    bounds = np.concatenate([[0], bounds, [n]])
    # repair: enforce strictly increasing bounds with unit gaps
    for i in range(1, len(bounds)):
        if bounds[i] <= bounds[i - 1]:
            bounds[i] = bounds[i - 1] + 1
    overflow = bounds[-1] - n
    if overflow > 0:
        for i in range(len(bounds) - 1, 0, -1):
            bounds[i] = min(bounds[i], n - (len(bounds) - 1 - i))
        for i in range(1, len(bounds)):
            if bounds[i] <= bounds[i - 1]:
                bounds[i] = bounds[i - 1] + 1
    return bounds


# scikit-learn's k-means, step by step (sklearn/cluster/_kmeans.py and
# _k_means_{lloyd,common}.pyx of scikit-learn 1.9): KMeans(n_clusters,
# n_init=10, random_state=seed).fit(X).labels_ for X of one feature in
# float32 (float64 for any other type), the same sums in the same types

_KMEANS_INITS = 10
_KMEANS_MAX_ITER = 300
_KMEANS_CHUNK = 256  # the samples of one E/M chunk (CHUNK_SIZE)


def _sq_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Squared distances of a's rows to b's: -2 a.b + |a|^2 + |b|^2 summed
    in float64 and stored in a's type, clipped at 0
    (_euclidean_distances / _euclidean_distances_upcast)."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    d = -2 * (a64 @ b64.T)
    d += np.einsum("ij,ij->i", a64, a64)[:, None]
    d += np.einsum("ij,ij->i", b64, b64)[None, :]
    d = d.astype(a.dtype)
    return np.maximum(d, 0, out=d)


def _kmeans_plusplus(x: np.ndarray, k: int,
                     rs: np.random.RandomState) -> np.ndarray:
    """Greedy k-means++ seeding (_kmeans_plusplus): the first centre drawn
    uniformly, each next one the best of 2 + log(k) candidates drawn in
    proportion to the squared distance to the nearest centre."""
    n = x.shape[0]
    w = np.ones(n, x.dtype)
    trials = 2 + int(np.log(k))
    centers = np.empty((k, x.shape[1]), x.dtype)
    centers[0] = x[rs.choice(n, p=w / w.sum())]
    closest = _sq_distances(centers[0, np.newaxis], x)
    pot = closest @ w
    for c in range(1, k):
        cand = np.searchsorted(np.cumsum(w * closest),
                               rs.uniform(size=trials) * pot)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(x[cand], x)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ w.reshape(-1, 1)
        best = np.argmin(cand_pot)
        pot, closest = cand_pot[best], dist[best]
        centers[c] = x[cand[best]]
    return centers


def _nearest(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """The E step: each sample's nearest centre (the first of a tie), by
    |c|^2 - 2 x.c in the samples' type."""
    norms = np.einsum("ij,ij->i", centers, centers)
    d = norms[None, :] + x.dtype.type(-2) * (x @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _lloyd_step(x: np.ndarray, centers: np.ndarray
                ) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """One Lloyd iteration (lloyd_iter_chunked_dense): the labels, then
    each cluster's sum, chunk by chunk in sample order and the chunks'
    sums in chunk order (one thread a chunk), empty clusters taking the
    samples farthest from their centres (_relocate_empty_clusters_dense),
    the means as sum * float(1 / count) (_average_centers: an empty
    cluster at the heaviest one's place) and each centre's shift."""
    k = centers.shape[0]
    labels = _nearest(x, centers)
    sums = np.zeros_like(centers)
    for start in range(0, x.shape[0], _KMEANS_CHUNK):
        part = np.zeros_like(centers)
        np.add.at(part, labels[start:start + _KMEANS_CHUNK],
                  x[start:start + _KMEANS_CHUNK])
        sums += part
    counts = np.bincount(labels, minlength=k).astype(x.dtype)
    empty = np.where(counts == 0)[0]
    if empty.size:
        dist = ((x - centers[labels]) ** 2).sum(axis=1)
        if np.max(dist) != 0:
            far = np.argpartition(dist, -empty.size)[:-empty.size - 1:-1]
            for new, i in zip(empty, far):
                old = labels[i]
                sums[old] -= x[i]
                sums[new] = x[i]
                counts[new] = 1
                counts[old] -= 1
    heaviest = np.argmax(counts)
    for j in range(k):
        if counts[j] > 0:
            sums[j] *= x.dtype.type(1.0 / float(counts[j]))
        else:
            sums[j] = sums[heaviest]
    shift = np.sqrt(((sums - centers) ** 2).sum(axis=1))
    return labels, sums, shift


def _kmeans_single(x: np.ndarray, centers: np.ndarray, tol
                   ) -> "tuple[np.ndarray, float]":
    """One Lloyd run (_kmeans_single_lloyd): until the labels repeat (then
    as they are), the squared shift is within `tol` or 300 iterations
    (then the labels of the last centres); its labels and inertia."""
    labels_old = np.full(x.shape[0], -1, np.int32)
    strict = False
    for _ in range(_KMEANS_MAX_ITER):
        labels, centers, shift = _lloyd_step(x, centers)
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _nearest(x, centers)
    inertia = float(((x - centers[labels]).astype(np.float64) ** 2).sum())
    return labels, inertia


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    """a's labels are b's up to a renaming (_is_same_clustering)."""
    mapping = np.full(k, -1)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans_labels(x: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """scikit-learn's KMeans(n_clusters=k, n_init=10, random_state=seed)
    .fit(x).labels_ (KMeans.fit) for x (n, features): the features
    centred on their mean, one RandomState for all ten k-means++ inits,
    the tolerance 1e-4 of the mean variance, and the run of least inertia
    kept unless it is a relabelling of the best so far. Fewer than k
    samples raise ValueError, as there."""
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.shape[0] < k:
        raise ValueError(f"n_samples={x.shape[0]} should be >= "
                         f"n_clusters={k}.")
    tol = np.mean(np.var(x, axis=0)) * 1e-4
    x = x - x.mean(axis=0)
    rs = np.random.RandomState(seed)
    best_labels, best_inertia = None, None
    for _ in range(_KMEANS_INITS):
        labels, inertia = _kmeans_single(x, _kmeans_plusplus(x, k, rs), tol)
        if best_inertia is None or (
                inertia < best_inertia
                and not _same_clustering(labels, best_labels, k)):
            best_labels, best_inertia = labels, inertia
    return best_labels


def split_idx_using_kmeans(x: np.ndarray, num_segments: int,
                           seed: int = 0) -> np.ndarray:
    """Mid-velocity k-means segmentation (reference tools.py:382-398;
    agcn_tpu transforms.py:239-251): the frames' cumulative distance from
    the middle speed clustered into num_segments groups by `kmeans_labels`
    (scikit-learn's KMeans, which the JAX function calls); the bounds are
    each group's first frame, and the length."""
    vel = np.linalg.norm(x[1:] - x[:-1], axis=1)
    vel = np.abs(vel - (vel.max() - vel.min()) / 2)
    feat = np.cumsum(vel)[:, None]
    _, idxs = np.unique(kmeans_labels(feat, num_segments, seed),
                        return_index=True)
    idxs.sort()
    return np.append(idxs, x.shape[0])


def split_idx_center(length: int, num_segments: int,
                     center_factor: float) -> np.ndarray:
    """Center-focused segmentation (reference loader.py:268-284)."""
    avg = length / num_segments
    min_range = max(avg * center_factor, 1.0)
    slope = 2 * (avg - min_range) / max(num_segments / 2 - 1, 1)
    widths = [i * slope + min_range
              for j in (reversed(range(num_segments // 2)),
                        range(num_segments // 2))
              for i in j]
    return np.cumsum([0] + widths).round().astype(int)


def split_idx_tempshift(length: int, num_segments: int, shift: float,
                        rng: np.random.Generator) -> np.ndarray:
    """Temporally shifted equal segmentation (reference loader.py:287-299)."""
    bias = max(int(shift * length), 1)
    begin = int(rng.integers(0, bias))
    end = int(rng.integers(0, bias))
    avg = (length - begin - end) / num_segments
    return (np.arange(num_segments + 1) * avg + begin).round().astype(int)


def openpose_match(x: np.ndarray) -> np.ndarray:
    """Greedy nearest-neighbour pose tracking across frames.

    OpenPose detections are unordered per frame; this re-threads person
    slots so slot m holds one consistent identity over time, matching
    bodies frame-to-frame by squared joint distance, with the more
    confident body of each frame matched first, then sorts slots by total
    confidence. Parity: reference feeders/tools.py:234-275.

    Args:
      x: (3, T, V, M) with channel 2 = confidence score.
    Returns:
      (3, T, V, M) identity-threaded copy.
    """
    c, t, v, m = x.shape
    assert c == 3
    score = x[2].sum(axis=1)                      # (T, M)
    rank = (-score[: t - 1]).argsort(axis=1)      # (T-1, M)

    xy1 = x[0:2, : t - 1].reshape(2, t - 1, v, m, 1)
    xy2 = x[0:2, 1:t].reshape(2, t - 1, v, 1, m)
    distance = ((xy2 - xy1) ** 2).sum(axis=2).sum(axis=0)  # (T-1, M, M)

    forward_map = np.full((t, m), -1, dtype=int)
    forward_map[0] = np.arange(m)
    for rank_m in range(m):
        choose = rank == rank_m                   # (T-1, M) one per frame
        forward = distance[choose].argmin(axis=1)  # (T-1,)
        distance[np.arange(t - 1), :, forward] = np.inf  # claim matches
        forward_map[1:][choose] = forward
    assert np.all(forward_map >= 0)

    # compose maps so column m tracks the same identity end to end
    for f in range(t - 1):
        forward_map[f + 1] = forward_map[f + 1][forward_map[f]]

    out = np.zeros_like(x, dtype=x.dtype)
    for f in range(t):
        out[:, f] = x[:, f, :, forward_map[f]].transpose(1, 2, 0)

    trace_score = out[2].sum(axis=1).sum(axis=0)  # (M,)
    return out[:, :, :, (-trace_score).argsort()]
