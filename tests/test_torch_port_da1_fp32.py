"""The decomposition of the card's fp32 da1 kernel, emulated on the CPU.

On the card, gcn_bwd's fp32 da1 is `gcn_da1_fp32_kernel`
(agcn_tpu_torch/ops/csrc/gcn_bwd.cu), which sums in an order of its own:
each sample's frames in groups of whole tiles of 128 // V frames (5 at
V = 25, 7 at V = 18, 8 at V = 15; the library's `Da32Tile<V>::TT`); per
tile and 64-channel o chunk, p =
x W_k over input-channel chunks (16, or 4 for C <= 8), each of 256
threads adding into a 4 x 8 register tile (four rows 32 apart x two
column quads 32 channels apart), c in order; p stored into p_s, g staged
into g_s (zero past T and Co); then p g^T per frame in VT x VT register
tiles of (v, w), each owned by one thread of a slice (one frame x one
channel part of the chunk), the slices summed in slice order into one
fp32 (V, V) partial per (sample, subset, group), and the groups in group
order. `_emulated` does the same in numpy, with p_s filled with NaN
where no thread writes it (so that a read of an unwritten row would
show) and every (t, o, v, w) contribution counted: each must land
exactly once.

Held here against the JAX package's Pallas backward
(`_backward(..., interpret=True)[1]`, as tests/test_torch_port_bwd_exact.py
runs it) and the port's plain version `gcn_da1_plain`, in fp32: bit for
bit on integer inputs (x, W and g in [-1, 1]: every sum an integer below
2^24, exact in fp32 in any order), within bwd_check's fp32 bar (1e-4 of
the output's scale) on random ones. The card tests hold the kernel
itself against `gcn_da1_plain` (tests/test_torch_port_cuda.py).

Also `da1_groups` over the fp32 tiles, the fp32 bounds, and the
CPU-visible parts of the card check (`tools/bwd_check.py`) that read the
new kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops.pallas import gcn_fused as jfused
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.tools import bwd_check
from tests.torch_port_threads import one_torch_thread  # noqa: F401

THREADS, ROWS_P, CHUNK = 256, 128, 64

# (B, T, C, Co, V): T off the tile at every shape; C = 20 (a ragged
# 16-channel chunk), C = 3 (4-channel chunks), C = 36 (three chunks);
# Co = 37 (off the chunk and the 4-wide copies) and 96 (two chunks, the
# second ragged); V = 25, 18 and 15 (the 5 x 5 tile over 3 x 3 tiles,
# 144 of the 256 threads)
SHAPES = [(2, 13, 20, 37, 25), (2, 12, 3, 64, 25), (1, 11, 36, 96, 25),
          (2, 15, 20, 37, 18), (1, 16, 3, 96, 18), (2, 17, 20, 37, 15),
          (1, 12, 3, 96, 15)]


def _tiling(v):
    """Da32Tile<V> of gcn_bwd.cu: (frames of a tile, register-tile side,
    tiles along v, channel parts of a chunk)."""
    vt, parts = (6, 4) if v == 18 else (5, 2)
    return ROWS_P // v, vt, v // vt, parts


def _chunk(c):
    """The input-channel chunk launch_da1_fp32 takes: 4 for C <= 8."""
    return 4 if c <= 8 else 16


def _emulated(x, w, g):
    """gcn_da1_fp32_kernel and its ordered reduce in numpy: x (B,T,V,C),
    w (K,C,Co), g (B,T,V,Co) fp32 arrays. Returns da1 (B,K,V,V) as fp32
    and asserts that every (t, o, v, w) contribution landed exactly
    once."""
    b_n, t_n, v, c_n = x.shape
    k_n, _, co_n = w.shape
    tt, vt, nt, parts = _tiling(v)
    rows = tt * v
    assert rows <= ROWS_P
    tiles = math.ceil(t_n / tt)
    groups = tfused.da1_groups(b_n, t_n, tt)
    cc = _chunk(c_n)
    pq = CHUNK // 4 // parts  # o quads of a part
    slices = tt * parts

    tid = np.arange(THREADS)
    tx, ty = tid % 8, tid // 8
    rows_of = ty[:, None] + 32 * np.arange(4)                  # (256, 4)
    cols_of = 4 * tx[:, None] + np.r_[np.arange(4), 32 + np.arange(4)]
    workers = tid[:nt * nt * slices]
    tile_of, slice_of = workers % (nt * nt), workers // (nt * nt)
    f_of, po_of = slice_of // parts, (slice_of % parts) * pq * 4
    v0_of, w0_of = (tile_of // nt) * vt, (tile_of % nt) * vt
    owned = np.zeros((slices, v, v), np.int64)
    np.add.at(owned, (slice_of[:, None, None],
                      v0_of[:, None, None] + np.arange(vt)[None, :, None],
                      w0_of[:, None, None] + np.arange(vt)[None, None, :]),
              1)
    assert (owned == 1).all()  # each (slice, v, w) has one thread

    out = np.zeros((b_n, k_n, v, v), np.float32)
    landed = np.zeros((b_n, k_n, t_n, co_n, v, v), np.int64)
    for b in range(b_n):
        xb = x[b].reshape(-1, c_n)
        gb = g[b].reshape(-1, co_n)
        for k in range(k_n):
            total = np.float32(0)
            for grp in range(groups):
                da = np.zeros((slices, v, v), np.float32)
                for tile in range(tiles * grp // groups,
                                  tiles * (grp + 1) // groups):
                    t0 = tile * tt
                    t_ok = min(tt, t_n - t0)
                    rows_ok = t_ok * v
                    for o0 in range(0, co_n, CHUNK):
                        no = min(CHUNK, co_n - o0)
                        acc = np.zeros((THREADS, 4, 8), np.float32)
                        for c0 in range(0, c_n, cc):
                            nc = min(cc, c_n - c0)
                            x_s = np.zeros((ROWS_P, cc), np.float32)
                            x_s[:rows_ok, :nc] = xb[t0 * v:t0 * v + rows_ok,
                                                    c0:c0 + nc]
                            w_s = np.zeros((cc, CHUNK), np.float32)
                            w_s[:nc, :no] = w[k, c0:c0 + nc, o0:o0 + no]
                            for c in range(cc):  # c in order
                                acc = acc + (x_s[rows_of, c][:, :, None]
                                             * w_s[c, cols_of][:, None, :])
                        # p stored by row ty + 32 i < ROWS, each once
                        p_s = np.full((rows, CHUNK), np.nan, np.float32)
                        written = np.zeros(p_s.shape, np.int64)
                        keep = rows_of < rows
                        for j in range(8):
                            at = (rows_of[keep], np.broadcast_to(
                                cols_of[:, j:j + 1], rows_of.shape)[keep])
                            p_s[at] = acc[:, :, j][keep]
                            np.add.at(written, at, 1)
                        assert (written == 1).all()
                        # g staged into every row of the tile, zero past
                        # T and Co
                        g_s = np.full((rows, CHUNK), np.nan, np.float32)
                        g_s[:] = 0
                        g_s[:rows_ok, :no] = gb[t0 * v:t0 * v + rows_ok,
                                                o0:o0 + no]
                        adds = t0 + f_of < t_n
                        o_part = po_of[:, None] + np.arange(4 * pq)
                        pr = (f_of * v + v0_of)[:, None] + np.arange(vt)
                        gr = (f_of * v + w0_of)[:, None] + np.arange(vt)
                        pv = p_s[pr[:, :, None], o_part[:, None, :]]
                        gv = g_s[gr[:, :, None], o_part[:, None, :]]
                        contrib = np.einsum("wio,wjo->wij", pv, gv)
                        m = adds
                        da[slice_of[m][:, None, None],
                           v0_of[m][:, None, None] + np.arange(vt)[:, None],
                           w0_of[m][:, None, None] + np.arange(vt)] += \
                            contrib[m]
                        # every real (t, o, v, w) this tile and chunk adds
                        for wi in np.flatnonzero(m):
                            o = o0 + o_part[wi]
                            o = o[o < co_n]
                            landed[b, k, t0 + f_of[wi], o[:, None, None],
                                   v0_of[wi] + np.arange(vt)[:, None],
                                   w0_of[wi] + np.arange(vt)] += 1
                part = np.zeros((v, v), np.float32)
                for sl in range(slices):  # the slices, in order
                    part = part + da[sl]
                total = total + part       # the groups, in order
            out[b, k] = total
    assert (landed == 1).all()
    return out


def _integer_inputs(b, t, c, co, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, (b, t, v, c)).astype(np.float32),
            rng.standard_normal((b, 3, v, v)).astype(np.float32),
            rng.integers(-1, 2, (3, c, co)).astype(np.float32),
            rng.integers(-1, 2, (b, t, v, co)).astype(np.float32))


def _random_inputs(b, t, c, co, v, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, v, c)).astype(np.float32),
            rng.standard_normal((b, 3, v, v)).astype(np.float32),
            (rng.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(
                np.float32),
            rng.standard_normal((b, t, v, co)).astype(np.float32))


def _jax_da1(x, a1, w, g):
    return torch.from_numpy(np.array(jfused._backward(
        *(jnp.asarray(a) for a in (x, a1, w, g)), True)[1]))


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_emulation_equals_jax_and_plain_bit_for_bit(b, t, c, co, v):
    """Integer inputs: the kernel's decomposition gives the TPU kernel's
    and the plain version's da1 exactly, every contribution once."""
    x, a1, w, g = _integer_inputs(b, t, c, co, v)
    assert tfused.da1_groups(b, t, _tiling(v)[0]) > 1
    got = torch.from_numpy(_emulated(x, w, g))
    assert got.shape == (b, 3, v, v)
    assert torch.equal(got, _jax_da1(x, a1, w, g))
    assert torch.equal(got, tfused.gcn_da1_plain(
        *(torch.from_numpy(a) for a in (x, w, g))))


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_emulation_close_to_plain_and_jax_on_random_inputs(b, t, c, co, v):
    """Random fp32 inputs: within bwd_check's fp32 bar (1e-4 of the
    scale) of the plain version and of JAX's."""
    x, a1, w, g = _random_inputs(b, t, c, co, v)
    got = torch.from_numpy(_emulated(x, w, g))
    want = tfused.gcn_da1_plain(*(torch.from_numpy(a) for a in (x, w, g)))
    ok, err, scale = bwd_check.within_tol(got, want)
    assert ok, (err, scale)
    ok, err, scale = bwd_check.within_tol(got, _jax_da1(x, a1, w, g))
    assert ok, (err, scale)


def test_da1_fp32_groups_fill_the_card_within_the_tiles():
    """Over the fp32 kernel's 5- and 7-frame tiles, `da1_groups` gives
    about 2,112 blocks (8 per SM) at the training shapes, never more
    groups than tiles, fixed by (B, T, tile) alone."""
    assert (_tiling(25)[0], _tiling(18)[0]) == (5, 7)
    for t in (300, 150, 75):
        groups = tfused.da1_groups(128, t, 5)
        assert groups == 6 and 2112 <= 3 * 128 * groups < 2112 + 3 * 128
    assert tfused.da1_groups(2, 13, 5) == 3   # three tiles
    assert tfused.da1_groups(1, 4, 5) == 1    # one ragged tile
    assert tfused.da1_groups(2, 15, 7) == 3
    assert tfused.da1_groups(2, 300, 5) == 60


@pytest.mark.parametrize("b,t,v", [(128, 300, 25), (128, 75, 25),
                                   (2, 37, 18), (48, 13, 25), (1, 3, 18),
                                   (128, 300, 15), (2, 9, 15)])
def test_da1_fp32_groups_are_whole_tiles_within_t(b, t, v):
    """Each group is a non-empty range of whole tiles that starts inside
    T, and the groups cover every frame once, in order."""
    tt = _tiling(v)[0]
    tiles = math.ceil(t / tt)
    groups = tfused.da1_groups(b, t, tt)
    assert 1 <= groups <= tiles
    bounds = [tiles * grp // groups for grp in range(groups + 1)]
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert all(lo < hi and tt * lo < t for lo, hi in zip(bounds, bounds[1:]))


class _Tiling:
    """A stand-in for gcn_fused whose library answers `blocks` blocks an
    SM at V = `short_v` and two elsewhere."""

    def __init__(self, short_v=None, blocks=1):
        self.short_v, self.blocks, self.asked = short_v, blocks, []

    def da1_tiling(self, v, c, bf16):
        self.asked.append((v, c, bf16))
        frames = 4 if bf16 else ROWS_P // v
        return frames, 1000 * v + c, self.blocks if v == self.short_v else 2


@pytest.mark.parametrize("short_v", [None, 25, 18, 15])
def test_bwd_check_holds_the_library_tiling_to_two_blocks_an_sm(short_v):
    """`check_da1_tiling` asks the library at V = 25, 18 and 15, the narrow
    and the wide C chunk, in both types, reports its answers, and fails
    where an SM holds fewer than the two blocks both da1 kernels are
    built for."""
    lib = _Tiling(short_v)
    if short_v is None:
        got = bwd_check.check_da1_tiling(lib)
        assert sorted(lib.asked) == sorted(
            (v, c, bf16) for v in (25, 18, 15) for c in (3, 64)
            for bf16 in (False, True))
        assert {(r["kernel"], r["frames"]) for r in got} == {
            ("gcn_da1_fp32_kernel", 5), ("gcn_da1_fp32_kernel", 7),
            ("gcn_da1_fp32_kernel", 8), ("gcn_da1_mma_kernel", 4)}
        assert all(r["blocks_per_sm"] == 2 and r["smem"] ==
                   1000 * r["v"] + r["c"] for r in got)
    else:
        with pytest.raises(bwd_check.SmokeFailure, match=f"V={short_v}"):
            bwd_check.check_da1_tiling(lib)


# l1 (C = 3) and l5 / l8 (C < Co) take the narrower order in fp32
@pytest.mark.parametrize("tcc,n", bwd_check.LAYER_SHAPES)
def test_fp32_bounds_take_the_narrower_order(tcc, n):
    """In fp32 the intermediate's rounding is the identity, so dW, da1
    and gcn_fwd are bounded by the cheaper order of their two products:
    2 K B T V (C Co + V min(C, Co)); in bf16 by the order the rounding
    fixes (p and u on Co channels, the aggregate on C)."""
    t, c, co = tcc
    kbtv = 3 * 128 * t * 25
    p_form, narrow = kbtv * 2 * co * (c + 25), kbtv * 2 * (
        c * co + 25 * min(c, co))
    half32 = bwd_check.gcn_bwd_half_work(128, t, c, co, "float32")
    assert half32[0] == narrow <= p_form
    assert bwd_check.gcn_bwd_half_work(128, t, c, co, "bfloat16")[0] \
        == p_form
    assert bwd_check.gcn_bwd_work(128, t, c, co, "float32")[0] == 2 * narrow
    # dx is gcn_fwd on (g, a1^T, W^T): Co channels in, C out
    assert bwd_check.gcn_work(128, t, co, c, "float32")[0] == narrow
    assert bwd_check.gcn_work(128, t, co, c, "bfloat16")[0] \
        == kbtv * 2 * co * (25 + c)
    assert (narrow < p_form) == (c < co)


def test_fp32_entry_layer_da1_is_bound_by_bytes():
    """At l1 (C = 3) the narrower order leaves 12 flops per fp32 byte,
    under the fp32 ridge of 20: reading x and g bounds its da1."""
    ms, by = bwd_check.bound_ms(
        *bwd_check.gcn_bwd_half_work(128, 300, 3, 64, "float32"), "float32")
    assert by == "bytes"
    assert ms == pytest.approx((128 * 300 * 25 * 67 + 128 * 3 * 625
                                + 3 * 3 * 64) * 4 / 3.35e12 * 1e3)


def test_integer_check_sums_stay_below_2_24_at_the_training_shapes():
    """check_da1_fp32_exact's premise at batch 128: with x, W and g in
    [-1, 1], every |p| <= C and every da1 sum <= C T Co < 2^24."""
    assert max(c * t * co for (t, c, co), _ in bwd_check.LAYER_SHAPES) \
        < 2 ** 24


_PTXAS_ENTRY = (
    "ptxas info    : Compiling entry function '{0}' for 'sm_90a'\n"
    "ptxas info    : Function properties for {0}\n"
    "    0 bytes stack frame, {1} bytes spill stores, {2} bytes "
    "spill loads\n"
    "ptxas info    : Used {3} registers, used 1 barriers\n")
_DA1_FP32 = ("_ZN37_GLOBAL__N__d5461fc2_5_gcn_bwd_cu_08a9c0b519gcn_da1_fp32_"
             "kernelILi{0}ELi{1}EEEvPKfS2_S2_Pfiiiibbb")
_REDUCE = ("_ZN37_GLOBAL__N__d5461fc2_5_gcn_bwd_cu_08a9c0b521gcn_da1_reduce_"
           "kernelIfEEvPKfPT_iii")


def test_bwd_check_reports_the_fp32_da1_build():
    """ptxas' registers and spills of each gcn_da1_fp32_kernel
    instantiation, labelled with (V, CC); the reduce is not one of
    them."""
    log = (_PTXAS_ENTRY.format(_DA1_FP32.format(25, 16), 0, 0, 128)
           + _PTXAS_ENTRY.format(_REDUCE, 0, 0, 16)
           + _PTXAS_ENTRY.format(_DA1_FP32.format(18, 4), 0, 0, 123))
    got = bwd_check.report_da1_fp32_build(log)
    assert [r["label"] for r in got] == ["gcn_da1_fp32_kernel<25, 16>",
                                         "gcn_da1_fp32_kernel<18, 4>"]
    assert [r["registers"] for r in got] == [128, 123]
    assert [(r["spill_stores"], r["spill_loads"]) for r in got] == [(0, 0)] * 2


@pytest.mark.parametrize("v,cc", [(25, 16), (25, 4), (18, 16), (18, 4)])
def test_bwd_check_fails_on_spills_of_the_fp32_da1_kernel(v, cc):
    """`bwd_check.bwd_spills` (the check of bwd_check and chip_smoke's
    phase 2) reports a spill in any gcn_da1_fp32_kernel instantiation and
    ignores the reduce's."""
    name = _DA1_FP32.format(v, cc)
    clean = (_PTXAS_ENTRY.format(name, 0, 0, 128)
             + _PTXAS_ENTRY.format(_REDUCE, 8, 8, 16))
    assert bwd_check.bwd_spills(clean) == []
    assert bwd_check.bwd_spills(_PTXAS_ENTRY.format(name, 12, 20, 128)) \
        == [(name, 12, 20)]


def test_bwd_check_tables_the_fp32_da1_layers():
    """The per-layer fp32 da1 table reads each fp32 row's da1 numbers
    beside the groups and shared memory its launch took, and skips
    bf16."""
    def row(t, c, co, dtype, ms, groups, smem):
        return dict(t=t, c=c, co=co, layers=3, dtype=dtype, da1_ms=ms,
                    da1_library_ms=2 * ms, da1_plain_ms=3 * ms,
                    half_bound_ms=0.5, half_bound_by="bytes",
                    da1_groups=groups, da1_smem=smem)
    got = bwd_check.da1_fp32_layers(
        [row(300, 3, 64, "float32", 1.0, 6, 78240),
         row(300, 3, 64, "bfloat16", 9.0, 75, 50000),
         row(75, 256, 256, "float32", 4.0, 6, 96672)])
    assert [(r["ms"], r["library_ms"], r["plain_ms"], r["bound_ms"],
             r["bound_by"], r["groups"], r["smem"]) for r in got] == [
        (1.0, 2.0, 3.0, 0.5, "bytes", 6, 78240),
        (4.0, 8.0, 12.0, 0.5, "bytes", 6, 96672)]
