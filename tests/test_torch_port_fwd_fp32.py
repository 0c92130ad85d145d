"""The tiling of the card's CUDA-core forward kernel, emulated on the CPU.

On the card, gcn_fwd's fp32 calls (and bf16 x with fp32 a1) run
`gcn_fwd_fp32_kernel` (agcn_tpu_torch/ops/csrc/gcn_fwd.cu): one block of
256 threads per (sample, TT frames, OT output channels); per chunk of CC
input channels it stages x and W (zero past every edge), forms the
aggregate aggT_k[c][t V + w] once for the whole block in 4 x 4 (c, w)
items, and adds aggT_k[c][rows] x W_k[c][cols] into each thread's 8 x 8
(4 x 8 at OT = 8) register tile of two row quads and two column quads;
rows past T and columns past Co are never stored. `_emulated` does the
same block by block in numpy, with the tile of `fwd_check.fp32_tiling`
(the mirror of the source's `launch_fp32_tile` / `F32Tile`), unwritten
aggregate rows filled with NaN so that a mask that let one through would
show, and every output counted: each must be stored exactly once.

Held here against the port's plain version `gcn_fwd_plain` and the JAX
package's Pallas forward (`adaptive_gcn_pallas(..., interpret=True)`, as
tests/test_pallas_gcn.py runs it): bit for bit on integer inputs (x and
a1 in [-8, 8], W in [-2, 2]: every sum an integer below 2^24, exact in
fp32 in any order), within fwd_check's fp32 bar (1e-4 of the output's
scale) on random ones. The card tests hold the kernel itself against
`gcn_fwd_plain` (tests/test_torch_port_cuda.py).

Also the CPU-visible parts of the card check that read the new kernel:
the tiling mirror, ptxas' report and the per-layer table.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agcn_tpu.ops.pallas.gcn_fused import adaptive_gcn_pallas
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.tools import fwd_check
from agcn_tpu_torch.tools.bwd_check import within_tol
from tests.torch_port_threads import one_torch_thread  # noqa: F401

THREADS = 256
SMEM_SM = 233472  # shared memory of an H100 SM, bytes (1 KB a block reserved)

# (B, T, C, Co, V): every tile of the kernel (OT = 64, 128 and the
# 8-channel one; CC = 16 and 4; V = 25, 18 and 15) with ragged frame
# tiles, a ragged last C chunk and Co off the tile and off the 4-wide
# stores
SHAPES = [(2, 8, 16, 32, 25), (2, 23, 3, 64, 25), (2, 45, 64, 3, 25),
          (1, 15, 20, 37, 18), (1, 11, 36, 96, 25), (1, 9, 24, 200, 18),
          (1, 60, 7, 5, 18), (1, 19, 20, 37, 15), (1, 9, 24, 200, 15),
          (1, 70, 7, 5, 15)]


def _emulated(x, a1, w, round_agg=True, bf16=False):
    """gcn_fwd_fp32_kernel block by block in numpy: x (B,T,V,C), a1
    (B,K,V,V), w (K,C,Co) fp32 arrays (with `bf16`, values of bf16 x and
    W, the aggregate rounded to bf16 with round_agg and y rounded to bf16
    at the store). Returns y as fp32 and asserts that every output was
    stored exactly once."""
    b_n, t_n, v, c_n = x.shape
    co_n = w.shape[2]
    tl = fwd_check.fp32_tiling(v, c_n, co_n)
    ot, cc, tt, ry, rq, cx = (tl[k] for k in ("ot", "cc", "tt", "ry", "rq",
                                              "cx"))
    vp, lda, rows = tl["vp"], tl["lda"], tl["tt"] * v
    assert tl["rows_p"] <= lda and rows <= tl["rows_p"]
    wq_n, cq_n = vp // 4, cc // 4
    items = np.arange(3 * tt * cq_n * wq_n)
    wq, cq = items % wq_n, items // wq_n % cq_n
    it, ik = items // (wq_n * cq_n) % tt, items // (wq_n * cq_n * tt)
    tid = np.arange(THREADS)
    tx, ty = tid % cx, tid // cx
    a_idx = np.arange(4 * rq)
    rows_of = 4 * ty[:, None] + (a_idx // 4) * 4 * ry + a_idx % 4
    cols_of = 4 * tx[:, None] + (np.arange(8) // 4) * 4 * cx + np.arange(8) % 4
    four = np.arange(4)

    def rnd(a):
        if not bf16:
            return a
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    xf = x.reshape(-1, c_n)
    y = np.full((b_n * t_n * v, co_n), np.nan, np.float32)
    stores = np.zeros(y.shape, np.int64)
    for b in range(b_n):
        a_s = np.zeros((3, v, vp), np.float32)
        a_s[..., :v] = a1[b]
        for bt in range(-(-t_n // tt)):
            t0 = bt * tt
            t_ok = min(t_n - t0, tt)
            rows_ok, row0 = t_ok * v, (b * t_n + t0) * v
            for bo in range(-(-co_n // ot)):
                o0 = bo * ot
                acc = np.zeros((THREADS, 4 * rq, 8), np.float32)
                for c0 in range(0, c_n, cc):
                    nc, no = min(cc, c_n - c0), min(ot, co_n - o0)
                    x_s = np.zeros((rows, cc), np.float32)
                    x_s[:rows_ok, :nc] = xf[row0:row0 + rows_ok, c0:c0 + nc]
                    w_s = np.zeros((3, cc, ot), np.float32)
                    w_s[:, :nc, :no] = w[:, c0:c0 + nc, o0:o0 + no]
                    agg_s = np.full((3, cc, lda), np.nan, np.float32)
                    written = np.zeros(agg_s.shape, np.int64)
                    keep = it < t_ok
                    s = np.zeros((len(items), 4, 4), np.float32)
                    for vv in range(v):  # v in order from 0
                        xv = x_s[np.minimum(it * v + vv, rows - 1)[:, None],
                                 4 * cq[:, None] + four]
                        av = a_s[ik[:, None], vv, 4 * wq[:, None] + four]
                        s = s + xv[:, :, None] * av[:, None, :]
                    if round_agg:
                        s = rnd(s)
                    for c in range(4):
                        for j in range(4):
                            m = keep & (4 * wq + j < v)
                            at = (ik[m], 4 * cq[m] + c, it[m] * v + 4 * wq[m] + j)
                            agg_s[at] = s[m, c, j]
                            np.add.at(written, at, 1)
                    assert written.max() == 1
                    for k in range(3):
                        for c in range(cc):
                            av = agg_s[k, c][rows_of]
                            wv = w_s[k, c][cols_of]
                            acc = acc + av[:, :, None] * wv[:, None, :]
                r = rows_of[:, :, None].repeat(8, 2)
                o = o0 + cols_of[:, None, :].repeat(4 * rq, 1)
                m = (r < rows_ok) & (o < co_n)
                y[row0 + r[m], o[m]] = rnd(acc[m])
                np.add.at(stores, (row0 + r[m], o[m]), 1)
    assert (stores == 1).all()
    return y.reshape(b_n, t_n, v, co_n)


def _integer_inputs(b, t, c, co, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (b, t, v, c)).astype(np.float32),
            rng.integers(-8, 9, (b, 3, v, v)).astype(np.float32),
            rng.integers(-2, 3, (3, c, co)).astype(np.float32))


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_emulation_equals_plain_and_jax_bit_for_bit(b, t, c, co, v):
    """fp32 integer inputs: the kernel's tiling gives the plain version's
    and the TPU kernel's result exactly, with every output stored once."""
    x, a1, w = _integer_inputs(b, t, c, co, v)
    got = torch.from_numpy(_emulated(x, a1, w))
    want = tfused.gcn_fwd_plain(*(torch.from_numpy(a) for a in (x, a1, w)),
                                True)
    assert torch.equal(got, want)
    jax_y = np.array(adaptive_gcn_pallas(*(jnp.asarray(a) for a in
                                           (x, a1, w)), True))
    assert torch.equal(got, torch.from_numpy(jax_y))


@pytest.mark.parametrize("b,t,c,co,v", SHAPES[:4])
def test_emulation_close_to_plain_on_random_inputs(b, t, c, co, v):
    """Random fp32 inputs: within fwd_check's fp32 bar of the plain
    version, in both round_agg modes (one function in fp32)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, t, v, c)).astype(np.float32)
    a1 = rng.standard_normal((b, 3, v, v)).astype(np.float32) / 5
    w = (rng.standard_normal((3, c, co)) / np.sqrt(3 * c)).astype(np.float32)
    want = tfused.gcn_fwd_plain(*(torch.from_numpy(a) for a in (x, a1, w)),
                                True)
    for round_agg in (True, False):
        ok, err, scale = within_tol(
            torch.from_numpy(_emulated(x, a1, w, round_agg)), want)
        assert ok, (err, scale)


@pytest.mark.parametrize("round_agg", [True, False])
@pytest.mark.parametrize("b,t,c,co,v", [SHAPES[1], SHAPES[3]])
def test_emulation_of_bf16_x_with_fp32_a1(b, t, c, co, v, round_agg):
    """bf16 x and W with fp32 a1 (staged raw, converted where read): on
    integer inputs the kernel's arithmetic equals the plain version of
    each round_agg mode bit for bit."""
    x, a1, w = _integer_inputs(b, t, c, co, v, seed=2)
    tx, tw = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    want = tfused.gcn_fwd_plain(tx, torch.from_numpy(a1), tw, round_agg)
    got = _emulated(x, a1, w, round_agg, bf16=True)
    assert torch.equal(torch.from_numpy(got).to(torch.bfloat16), want)


@pytest.mark.parametrize("v", [25, 18, 15])
def test_fp32_tiles_fill_two_blocks_an_sm(v):
    """Every tile launch_fp32_tile takes, in both x types, leaves room for
    two blocks an SM (the kernel's __launch_bounds__(256, 2)); rows fill
    their tile to within one frame, and each thread's 8-column register
    tile spans the output tile."""
    for c, co in ((3, 64), (64, 64), (64, 128), (256, 256), (64, 3),
                  (3, 200)):
        tl = fwd_check.fp32_tiling(v, c, co)
        assert tl["rows_p"] - tl["tt"] * v < v
        assert tl["cx"] * 8 == tl["ot"] and tl["cx"] * tl["ry"] == THREADS
        for itemsize in (4, 2):
            smem = fwd_check.fp32_smem(itemsize, v, tl["ot"], tl["cc"])
            assert 2 * (smem + 1024) <= SMEM_SM, (c, co, smem)
    assert fwd_check.fp32_tiling(25, 64, 64)["tt"] == 10
    assert fwd_check.fp32_tiling(25, 128, 256)["tt"] == 5
    assert fwd_check.fp32_tiling(18, 64, 3)["ot"] == 8


def test_fwd_check_reports_the_fp32_kernels_build():
    """ptxas' registers and spills of each gcn_fwd_fp32_kernel
    instantiation, labelled with its template arguments, beside its
    dynamic shared memory."""
    f32 = "_ZN12_GLOBAL__N_119gcn_fwd_fp32_kernelIfLi25ELi64ELi16EEEvPKT_"
    b16 = ("_ZN12_GLOBAL__N_119gcn_fwd_fp32_kernelI13__nv_bfloat16Li18ELi8E"
           "Li4EEEvPKT_")
    entry = ("ptxas info    : Compiling entry function '{0}' for 'sm_90a'\n"
             "ptxas info    : Function properties for {0}\n"
             "    0 bytes stack frame, {1} bytes spill stores, {1} bytes "
             "spill loads\n"
             "ptxas info    : Used {2} registers, used 1 barriers\n")
    log = entry.format(f32, 0, 126) + entry.format(b16, 4, 128)
    got = fwd_check.report_fp32_build(log)
    assert [r["label"] for r in got] == [
        "gcn_fwd_fp32_kernel<float, 25, 64, 16>",
        "gcn_fwd_fp32_kernel<bf16, 18, 8, 4>"]
    assert [r["registers"] for r in got] == [126, 128]
    assert got[0]["smem"] == fwd_check.fp32_smem(4, 25, 64, 16) == 86608
    assert fwd_check.spilling(log) == [(b16, 4, 4)]


def test_fwd_check_tables_the_fp32_layers():
    """The per-layer fp32 table pairs each served layer with its dx call
    (C and Co swapped) and with the round_agg=0 row."""
    def row(t, c, co, dtype, round_agg, ms):
        return dict(t=t, c=c, co=co, layers=2, dtype=dtype,
                    round_agg=round_agg, ms=ms, library_ms=2 * ms,
                    plain_ms=3 * ms, flop_ms=0.5, byte_ms=0.25)
    rows = [row(300, 3, 64, "float32", True, 1.0),
            row(300, 3, 64, "float32", False, 1.5),
            row(300, 3, 64, "bfloat16", True, 9.0)]
    dx = [row(300, 64, 3, "float32", True, 4.0),
          row(300, 64, 3, "bfloat16", True, 9.0)]
    (got,) = fwd_check.fp32_layers(rows, dx)
    assert (got["ms"], got["ms_round_agg0"], got["dx_ms"],
            got["dx_library_ms"], got["bound_ms"]) == (1.0, 1.5, 4.0, 8.0,
                                                       0.5)
