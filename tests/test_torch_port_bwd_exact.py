"""The arithmetic of the card's bf16 da1 kernel, emulated on the CPU.

On the card, gcn_bwd's bf16 da1 is `gcn_da1_mma_kernel`
(agcn_tpu_torch/ops/csrc/gcn_bwd.cu), which sums in an order of its own:
each sample's frames in groups of whole 4-frame tiles, each frame in a
32-row slot (joints padded with zeros); per tile and 64-channel o chunk
p = x W_k rounded to bf16 once, then p g^T per frame into eight per-warp
fp32 accumulators (warp = channel half * 4 + frame) that are summed in
warp order into one fp32 (V, V) partial per (sample, subset, group); the
groups summed in group order and rounded to bf16 once.
`_da1_emulated` does the same in PyTorch. Here it is held against the
JAX package's Pallas backward (`_backward(..., interpret=True)`, as
tests/test_pallas_gcn.py runs it) and against the port's plain version
`gcn_bwd_plain`: bit for bit on integer inputs whose every sum is exact
in fp32 in any order, so that only the rounding points decide the result;
within the card tests' bf16 bar (2^-7 |ref| + 2^-10 of the scale: one
bf16 rounding of each output may land one ulp apart) of the plain
version on random inputs, and within 2^-6 of the scale of JAX's (the
bar of tests/test_torch_port_grad.py). The card tests hold the kernel
against `gcn_bwd_plain` (tests/test_torch_port_cuda.py).

Also `da1_groups`, which fixes the kernel's group count from the shapes,
and the CPU-visible parts of the card checks (`tools/bwd_check.py`,
`chip_smoke.py`) that read the new kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from agcn_tpu.ops.pallas import gcn_fused as jfused
from agcn_tpu_torch.ops.kernels import gcn_fused as tfused
from agcn_tpu_torch.tools import bwd_check, fwd_check
from tests.torch_port_threads import one_torch_thread  # noqa: F401

TILE, SLOT, CHUNK = 4, 32, 64  # frames per tile, rows per frame, o chunk
# (b, t, c, co, v): the integer case of tests/test_torch_port_grad.py; a
# ragged last tile (T = 13) at V = 18 with C and Co off the 8-wide loads
# and two o chunks; the C = 3 entry layer at a ragged T = 10
SHAPES = [(2, 8, 64, 16, 25), (2, 13, 20, 72, 18), (2, 10, 3, 64, 25)]


def _da1_emulated(x, w, g, groups, round_p=True):
    """gcn_da1_mma_kernel's decomposition of da1 in PyTorch (see the
    module docstring); `round_p=False` drops the rounding of p."""
    b, t, v, c = x.shape
    co = w.shape[-1]
    tiles = math.ceil(t / TILE)

    def slots(a):  # (B, T, V, n) -> (B, tiles, TILE, SLOT, n), zero-padded
        a = F.pad(a.float(), (0, 0, 0, SLOT - v, 0, tiles * TILE - t))
        return a.view(b, tiles, TILE, SLOT, a.shape[-1])

    xs, gs = slots(x), slots(g)
    out = []
    for k in range(w.shape[0]):
        total = None
        for grp in range(groups):
            acc = torch.zeros(2, TILE, b, SLOT, SLOT)  # [half][frame]
            for tile in range(tiles * grp // groups,
                              tiles * (grp + 1) // groups):
                for o0 in range(0, co, CHUNK):
                    p = xs[:, tile] @ w[k, :, o0:o0 + CHUNK].float()
                    if round_p:
                        p = p.to(x.dtype).float()
                    gt = gs[:, tile, ..., o0:o0 + CHUNK]
                    for h in range(2):
                        o = slice(32 * h, 32 * h + 32)
                        acc[h] += torch.einsum("bfvo,bfwo->fbvw", p[..., o],
                                               gt[..., o])
            part = acc[0, 0]
            for warp in range(1, 2 * TILE):
                part = part + acc[warp // TILE, warp % TILE]
            total = part if total is None else total + part
        out.append(total[:, :v, :v])
    return torch.stack(out, dim=1).to(x.dtype)


def _integer_inputs(b, t, c, co, v, seed=3):
    """bf16 integers (tests/test_torch_port_grad.py's ranges): p loses
    bits when rounded to bf16's 8, every sum stays far below 2^24."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-4, 5, (b, t, v, c)),
            rng.integers(-32, 33, (b, 3, v, v)),
            rng.integers(-32, 33, (3, c, co)),
            rng.integers(-32, 33, (b, t, v, co)))


def _random_inputs(b, t, c, co, v, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, v, c)),
            rng.standard_normal((b, 3, v, v)),
            rng.standard_normal((3, c, co)) / np.sqrt(3 * c),
            rng.standard_normal((b, t, v, co)))


def _both(arrs):
    """JAX's da1 (interpret mode) as fp32, and the inputs as bf16
    tensors."""
    want = jfused._backward(*(jnp.asarray(np.asarray(a, np.float32),
                                          jnp.bfloat16) for a in arrs),
                            True)[1]
    ref = torch.from_numpy(np.array(want.astype(jnp.float32)))
    return ref, [torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16) for a in arrs]


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_emulation_equals_jax_and_plain_bit_for_bit(b, t, c, co, v):
    ref, (x, a1, w, g) = _both(_integer_inputs(b, t, c, co, v))
    groups = tfused.da1_groups(b, t)
    assert groups > 1
    got = _da1_emulated(x, w, g, groups)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 3, v, v)
    assert torch.equal(got.float(), ref)
    assert torch.equal(got, tfused.gcn_bwd_plain(x, a1, w, g)[1])


def test_emulation_without_the_rounding_of_p_differs():
    """The bit-exact check sees where p is rounded: without it most
    outputs move."""
    ref, (x, _, w, g) = _both(_integer_inputs(*SHAPES[0]))
    got = _da1_emulated(x, w, g, tfused.da1_groups(2, 8), round_p=False)
    assert (got.float() != ref).float().mean() > 0.2


@pytest.mark.parametrize("b,t,c,co,v", SHAPES)
def test_emulation_close_to_plain_and_jax_on_random_inputs(b, t, c, co, v):
    ref, (x, a1, w, g) = _both(_random_inputs(b, t, c, co, v))
    got = _da1_emulated(x, w, g, tfused.da1_groups(b, t)).float()
    want = tfused.gcn_bwd_plain(x, a1, w, g)[1].float()
    diff, scale = (got - want).abs(), want.abs().max()
    assert bool((diff <= 2 ** -7 * want.abs() + 2 ** -10 * scale).all())
    assert (got - ref).abs().max() <= 2 ** -6 * ref.abs().max()


def test_da1_plain_is_gcn_bwd_plains_da1():
    """The halves of the plain version, as the card check times them."""
    _, (x, a1, w, g) = _both(_random_inputs(*SHAPES[1]))
    dw, da1 = tfused.gcn_bwd_plain(x, a1, w, g)
    assert torch.equal(tfused.gcn_da1_plain(x, w, g).to(a1.dtype), da1)
    assert torch.equal(tfused.gcn_dw_plain(x, a1, g).to(w.dtype), dw)


def test_da1_groups_fill_the_card_within_the_tiles():
    """The bf16 da1 kernel's frame groups: at least 2,112 blocks (8 waves
    of two blocks on 132 SMs) at the training shapes, never more groups
    than 4-frame tiles, fixed by (B, T) alone."""
    for t in (300, 150, 75):
        groups = tfused.da1_groups(128, t)
        assert groups == 6 and 3 * 128 * groups >= 2112
    assert tfused.da1_groups(2, 8) == 2    # two tiles
    assert tfused.da1_groups(1, 3) == 1    # one ragged tile
    assert tfused.da1_groups(2, 37) == 10  # ten tiles, the last ragged
    assert tfused.da1_groups(2, 300) == 75


@pytest.mark.parametrize("b,t", [(128, 300), (128, 75), (2, 37), (48, 13),
                                 (1, 3)])
def test_da1_groups_are_whole_tiles_within_t(b, t):
    """Each group is a non-empty range of whole tiles that starts inside
    T, and the groups cover every frame once, in order."""
    tiles = math.ceil(t / TILE)
    groups = tfused.da1_groups(b, t)
    bounds = [tiles * grp // groups for grp in range(groups + 1)]
    assert bounds[0] == 0 and bounds[-1] == tiles
    assert all(lo < hi and TILE * lo < t
               for lo, hi in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::gcn_da1_mma_kernel<25, 64>"
    "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
    "float*, int, int, int, int, bool, bool, bool)",
    "(anonymous namespace)::gcn_da1_reduce_kernel(float const*, "
    "__nv_bfloat16*, int, int, int)",
    "void (anonymous namespace)::gcn_da1_fp32_kernel<25, 16>(float const*, "
    "float const*, float const*, float*, int, int, int, int, bool, bool, "
    "bool)",
    "void (anonymous namespace)::gcn_da1_reduce_kernel<float>(float const*, "
    "float*, int, int, int)",
    "void (anonymous namespace)::gcn_dw_reduce_kernel<__nv_bfloat16>"
    "(float const*, __nv_bfloat16*, int, int)",
    "void (anonymous namespace)::gcn_dw_fp32_kernel<64, 8>(float const*, "
    "float const*, float*, int, int, int, int, bool, bool)",
    "void (anonymous namespace)::gcn_u_kernel<float, 25>(float const*, "
    "float const*, float*, int, int, int, bool)"])
def test_profile_groups_count_the_bwd_kernels_under_gcn_bwd(name):
    """chip_smoke's device-time breakdown puts every gcn_bwd kernel, the
    ordered reduces too, under gcn_bwd and not under "reductions"."""
    import chip_smoke

    assert chip_smoke.kernel_group(name) == \
        "gcn_bwd (the port's CUDA kernel)"
    assert chip_smoke.kernel_group(
        "void at::native::reduce_kernel<512, 1>(...)") == "reductions"


def test_bwd_check_entry_names_each_halfs_kernels():
    """The `kernels` entry of gcn_bwd keeps its keys, and dW and da1 each
    carry kernel / einsums / plain time and the CUDA kernels of their
    route in that dtype."""
    row = dict(t=75, c=256, co=256, layers=2, dtype="bfloat16",
               max_abs_err=0.5, err_dw=0.5, err_da1=0.25, ms=3.0,
               dw_ms=1.0, da1_ms=2.0, plain_ms=9.0, dw_plain_ms=4.0,
               da1_plain_ms=5.0, dw_library_ms=6.0, da1_library_ms=7.0,
               library_ms=13.0, flops=1e12, bytes=1e9)
    entry = bwd_check.bwd_entry([row], 10)
    assert {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"} <= set(entry)
    assert entry["route"] == "cuda" and entry["launches"] == 10
    assert (entry["da1"]["ms"], entry["da1"]["library_ms"],
            entry["da1"]["plain_ms"]) == (4.0, 14.0, 10.0)
    assert entry["da1"]["kernels"] == ["gcn_da1_mma_kernel",
                                       "gcn_da1_reduce_kernel"]
    assert "gcn_dw_mma_kernel" in entry["dw"]["kernels"]
    fp32 = bwd_check.bwd_entry([dict(row, dtype="float32")], 0, "float32")
    assert fp32["da1"]["kernels"] == ["gcn_da1_fp32_kernel",
                                      "gcn_da1_reduce_kernel"]
    assert fp32["dw"]["kernels"] == ["gcn_u_kernel", "gcn_dw_fp32_kernel",
                                      "gcn_dw_reduce_kernel"]
    # each dtype's entry reads its own rows' errors
    both = [row, dict(row, dtype="float32", max_abs_err=0.01, err_dw=0.01,
                      err_da1=0.005)]
    fp32 = bwd_check.bwd_entry(both, 0, "float32")
    assert (fp32["max_abs_err"], fp32["dw"]["max_abs_err"],
            fp32["da1"]["max_abs_err"]) == (0.01, 0.01, 0.005)
    assert bwd_check.bwd_entry(both, 0)["dw"]["max_abs_err"] == 0.5


def test_bwd_check_finds_spills_of_the_da1_kernel():
    """`spilling(..., kernel="gcn_da1_mma_kernel")` reads `nvcc -Xptxas
    -v`: the da1 kernel's spills are found, the other kernels' (here the
    fp32 da1 kernel's) ignored."""
    mma = ("_ZN12_GLOBAL__N_118gcn_da1_mma_kernelILi25ELi64EEEvPK13"
           "__nv_bfloat16S3_S3_Pfiiiibbb")
    other = ("_ZN12_GLOBAL__N_119gcn_da1_fp32_kernelILi25ELi16EEEvPKfS2_S2_"
             "Pfiiiibbb")
    entry = ("ptxas info    : Compiling entry function '{0}' for 'sm_90a'\n"
             "ptxas info    : Function properties for {0}\n"
             "    0 bytes stack frame, {1} bytes spill stores, {2} bytes "
             "spill loads\n"
             "ptxas info    : Used 128 registers, used 1 barriers\n")
    clean = entry.format(mma, 0, 0) + entry.format(other, 24, 24)
    assert fwd_check.spilling(clean, kernel="gcn_da1_mma_kernel") == []
    assert fwd_check.spilling(clean + entry.format(mma, 8, 8),
                              kernel="gcn_da1_mma_kernel") == [(mma, 8, 8)]


_PTXAS_ENTRY = (
    "ptxas info    : Compiling entry function '{0}' for 'sm_90a'\n"
    "ptxas info    : Function properties for {0}\n"
    "    0 bytes stack frame, {1} bytes spill stores, {2} bytes "
    "spill loads\n"
    "ptxas info    : Used 128 registers, used 1 barriers\n")


@pytest.mark.parametrize("name", [
    "_ZN12_GLOBAL__N_118gcn_dw_fp32_kernelILi64ELi8EEEvPKfS2_Pfiiiibb",
    "_ZN12_GLOBAL__N_118gcn_dw_fp32_kernelILi8ELi4EEEvPKfS2_Pfiiiibb",
    "_ZN12_GLOBAL__N_112gcn_u_kernelIfLi25EEEvPKT_S3_PS1_iiib",
    "_ZN12_GLOBAL__N_118gcn_da1_mma_kernelILi25ELi64EEEvPK13"
    "__nv_bfloat16S3_S3_Pfiiiibbb",
    "_ZN12_GLOBAL__N_119gcn_da1_fp32_kernelILi25ELi16EEEvPKfS2_S2_"
    "Pfiiiibbb"])
def test_bwd_check_fails_on_spills_of_the_fp32_dw_kernels(name):
    """`bwd_check.bwd_spills` (the check of bwd_check and chip_smoke's
    phase 2) reports a spill in the fp32 dW GEMM, in u's kernel and in
    both da1 kernels, and ignores the other kernels' (the da1 reduce
    here)."""
    other = "_ZN12_GLOBAL__N_121gcn_da1_reduce_kernelIfEEvPKfPT_iii"
    clean = _PTXAS_ENTRY.format(name, 0, 0) + _PTXAS_ENTRY.format(other, 24,
                                                                  24)
    assert bwd_check.bwd_spills(clean) == []
    assert bwd_check.bwd_spills(clean + _PTXAS_ENTRY.format(name, 8, 4)) \
        == [(name, 8, 4)]


@pytest.mark.parametrize("t", sorted({t for (t, _, _), _ in
                                      bwd_check.LAYER_SHAPES}))
def test_bwd_check_exact_dw_batch_keeps_the_sums_below_2_24(t):
    """The fp32 integer dW check's batch at each training T: at most the
    training batch (128), and B*T*V terms of at most |x| |u| = 2 * (2 *
    25) sum below 2^24, so every order of the sums is exact."""
    b = bwd_check.exact_dw_batch(t)
    assert 1 <= b <= 128
    assert b * t * 25 * 2 * 2 * 25 < 2 ** 24
    assert b == 128 or (b + 1) * t * 25 * 2 * 2 * 25 >= 2 ** 24
