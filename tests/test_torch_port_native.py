"""The port's native host kernels (agcn_tpu_torch/native: a copy of
skelio.cpp, built by g++ with the JAX package's flags) against the JAX
package's library and the numpy reference.

Tolerances: the port's C functions equal the JAX package's bit for bit
(the same source and flags); the C pre_normalization is within 1e-4 of
the output scale of the numpy version (`native_ok=False`), the serving
bar. The tests that need the library skip where there is no g++, as
tests/test_native.py does.
"""

import shutil

import numpy as np
import pytest
import torch

from agcn_tpu import native as jax_native
from agcn_tpu.data.gen.ntu import read_xyz as jax_read_xyz
from agcn_tpu.data.gen.preprocess import \
    pre_normalization as jax_pre_normalization
from agcn_tpu.infer.serving import BatchedStreamServer as JaxServer
from agcn_tpu_torch import native
from agcn_tpu_torch.data.gen.ntu import read_skeleton, read_xyz
from agcn_tpu_torch.data.gen.preprocess import pre_normalization
from agcn_tpu_torch.infer.serving import BatchedStreamServer
from tests.test_native import _write_skeleton
from tests.torch_port_threads import one_torch_thread  # noqa: F401

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++: the native kernels build "
                                      "with g++")


def _batch(v=25, t=40, seed=0):
    """Seeded (5, 3, T, V, 2) skeletons over the branches of the pad,
    center and rotate gates."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((5, 3, t, v, 2)).astype(np.float32) * 0.3
    data[:, :, :, :, 1] += np.array([1.0, 0.0, 0.5], np.float32)[:, None,
                                                                 None]
    data[0, :, :, :, 1] = 0.0     # the second body absent
    data[1, :, :5] = 0.0          # leading null frames
    data[2, :, t // 2:] = 0.0     # zero tail: pad tiles the valid prefix
    data[3] = 0.0                 # an all-zero sample
    data[4, :, 3:7, :, 0] = 0.0   # frames the first body misses
    return data


# (zaxis, xaxis, pad, center, center_firstframe, V)
_CASES = {
    "serving": ((0, 1), (8, 4), True, True, False, 25),
    "gen_no_pad": ((0, 1), (8, 4), False, True, False, 25),
    "center_firstframe": ((0, 1), (8, 4), True, False, True, 25),
    "no_zaxis": (None, (8, 4), True, True, False, 25),
    "no_xaxis": ((0, 1), None, False, False, True, 25),
    "no_center": ((0, 1), (8, 4), True, False, False, 25),
    "openpose_15": ((8, 1), (2, 5), True, True, False, 15),
}


@needs_gxx
@pytest.mark.parametrize("case", sorted(_CASES))
def test_pre_normalize_equals_jax_bit_for_bit(case):
    zaxis, xaxis, pad, center, firstframe, v = _CASES[case]
    data = _batch(v=v, seed=len(case))
    calls = native.pre_normalize.calls
    got = native.pre_normalize(data.copy(), zaxis, xaxis, pad, center,
                               firstframe)
    assert native.pre_normalize.calls == calls + 1
    want = jax_native.pre_normalize(data.copy(), zaxis, xaxis, pad, center,
                                    firstframe)
    assert got is not None and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # pre_normalization routes to it, and it stays within the serving bar
    # of the numpy reference
    routed = pre_normalization(data.copy(), zaxis, xaxis, pad, center,
                               firstframe)
    np.testing.assert_array_equal(routed, got)
    ref = pre_normalization(data.copy(), zaxis, xaxis, pad, center,
                            firstframe, native_ok=False)
    np.testing.assert_array_equal(
        ref, jax_pre_normalization(data.copy(), zaxis, xaxis, pad, center,
                                   firstframe, native_ok=False))
    scale = float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= 1e-4 * scale


@needs_gxx
@pytest.mark.parametrize("shape, zaxis, xaxis, numpy_raises", [
    ((2, 2, 10, 25, 2), None, None, False),     # C != 3
    ((2, 3, 10, 25, 2), (0, 25), (8, 4), True),  # a joint index >= V
    ((2, 3, 10, 25, 2), (0, 1), (-1, 4), False),  # numpy wraps -1
    ((2, 3, 10, 15, 2), (0, 1), (8, 20), True),  # the NTU axes at V = 15
])
def test_pre_normalize_declines_where_jax_does(shape, zaxis, xaxis,
                                               numpy_raises):
    """None in the C binding of both packages; pre_normalization then runs
    the numpy version, which raises where an index is past V."""
    data = np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)
    calls = native.pre_normalize.calls
    assert native.pre_normalize(data, zaxis, xaxis) is None
    assert jax_native.pre_normalize(data, zaxis, xaxis) is None
    assert native.pre_normalize.calls == calls
    if numpy_raises:
        with pytest.raises(IndexError):
            pre_normalization(data, zaxis, xaxis)
        return
    got = pre_normalization(data, zaxis, xaxis)
    np.testing.assert_array_equal(
        got, pre_normalization(data, zaxis, xaxis, native_ok=False))
    np.testing.assert_array_equal(got, jax_pre_normalization(data, zaxis,
                                                             xaxis))


@needs_gxx
@pytest.mark.parametrize("frames, bodies, max_frames", [
    (7, 1, 300), (12, 2, 300), (9, 5, 300), (12, 3, 8)])
def test_parse_skeleton_and_read_xyz_equal_jax(tmp_path, frames, bodies,
                                               max_frames):
    path = str(tmp_path / "S001C002P003R001A004.skeleton")
    vals = _write_skeleton(path, frames=frames, bodies=bodies,
                           seed=frames + bodies)
    calls = native.parse_skeleton.calls
    got, n = native.parse_skeleton(path, 4, max_frames, 25)
    assert native.parse_skeleton.calls == calls + 1
    want, n_jax = jax_native.parse_skeleton(path, 4, max_frames, 25)
    assert n == n_jax == min(frames, max_frames)
    np.testing.assert_array_equal(got, want)
    # the Python parser reads the same values (to the file's 6 digits)
    py, _ = read_skeleton(path)
    np.testing.assert_allclose(got[:, :n], py[:, :n], atol=1e-6)
    np.testing.assert_allclose(got[:min(bodies, 4), :n],
                               vals[:4, :n], atol=1e-6)
    xyz = read_xyz(path)
    assert xyz.shape == (3, frames, 25, 2) and xyz.dtype == np.float32
    np.testing.assert_array_equal(xyz, jax_read_xyz(path))


@needs_gxx
def test_batched_tick_rows_equal_jax():
    """`_prepare_dense_batched` of 16 streams (T = 300 ring, up to four
    bodies, some short of a full ring): the port's rows equal the JAX
    server's bit for bit, with one C pre_normalize call a tick."""
    kwargs = dict(max_streams=16, max_seq_length=300)
    port = BatchedStreamServer(torch.nn.Linear(1, 1), **kwargs)
    jax_server = JaxServer(None, None, **kwargs)
    rng = np.random.default_rng(5)
    for sid in range(16):
        port.add_stream()
        jax_server.add_stream()
        bodies = 1 + sid % 4
        frames = 300 if sid % 3 else 120 + 10 * sid
        base = rng.standard_normal((bodies, 1, 25, 3)) * 0.3
        for t in range(frames):
            frame = np.zeros((4, 1, 25, 3), np.float32)
            frame[:bodies] = base + 0.05 * np.sin(0.1 * t + sid) \
                + rng.standard_normal((bodies, 1, 25, 3)) * 0.01
            port.append_frame(sid, frame)
            jax_server.append_frame(sid, frame)
    sids = list(range(16))
    calls = native.pre_normalize.calls
    rows = port._prepare_dense_batched(sids)
    assert native.pre_normalize.calls == calls + 1
    assert rows.shape == (16, 3, 300, 25, 2)
    np.testing.assert_array_equal(rows,
                                  jax_server._prepare_dense_batched(sids))


@needs_gxx
def test_compiler_error_raises_with_gxx_output(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message; it never
    falls back to numpy."""
    bad = tmp_path / "skelio.cpp"
    bad.write_text('extern "C" int parse_skeleton( {\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ could not build") as e:
        native.available()
    assert "error" in str(e.value)
    with pytest.raises(RuntimeError):
        pre_normalization(_batch())
    assert not list((tmp_path / "build").glob("*.tmp"))
    # the library's name follows the source and the flags
    good = native.library_path()
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert native.library_path() != good


def test_without_gxx_the_callers_take_numpy(tmp_path, monkeypatch):
    """No g++ on the PATH and no library built: available() is False,
    pre_normalization is the numpy version, parse_skeleton the Python
    parser."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    calls = (native.pre_normalize.calls, native.parse_skeleton.calls)
    data = _batch()
    np.testing.assert_array_equal(
        pre_normalization(data), pre_normalization(data, native_ok=False))
    path = str(tmp_path / "S001C001P001R001A001.skeleton")
    _write_skeleton(path, frames=6, bodies=2)
    parsed, frames = native.parse_skeleton(path, 4, 10, 25)
    py, _ = read_skeleton(path)
    assert frames == 6
    np.testing.assert_array_equal(parsed[:, :6], py.astype(np.float32))
    assert read_xyz(path).shape == (3, 6, 25, 2)
    assert (native.pre_normalize.calls, native.parse_skeleton.calls) == calls
    assert not (tmp_path / "build").exists()
