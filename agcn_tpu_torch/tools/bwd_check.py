"""gcn_bwd on the card against its plain version, dW and da1 timed apart.

    python -m agcn_tpu_torch.tools.bwd_check [--out FILE]

The quick card check of `ops/csrc/gcn_bwd.cu`, about a minute: it builds
that source alone, then at each AGCN layer shape of a training step
(batch 64 x 2 persons = 128 samples, T=300), fp32 and bf16, holds
gcn_bwd against its plain version (`gcn_bwd_plain`) and two calls against
each other (bitwise), times dW and da1 apart, each beside its library
yardstick (the einsums of `ops.gcn.adaptive_gcn_bwd`) and its bound, and
on bf16 integer inputs holds the kernel bit for bit against the plain
version while dropping the rounding of u or of p changes the result; on
fp32 integer inputs whose dW sums are exact in any order (the batch cut
where needed) it holds fp32 dW bit for bit, and fp32 da1 at the full
batch (x, W and g in [-1, 1]). It fails if ptxas reports a spill in
`gcn_da1_mma_kernel` (bf16 da1 on the tensor cores),
`gcn_da1_fp32_kernel` (fp32 da1 on the CUDA cores), `gcn_dw_fp32_kernel`
(the fp32 dW GEMM) or `gcn_u_kernel` (u, both types), and prints each
`gcn_da1_fp32_kernel` instantiation's registers and spills (ptxas). It
asks the library what each da1 launch takes (`gcn_fused.da1_tiling`:
frames of a tile, dynamic shared memory, blocks an SM holds) and fails
if an SM holds fewer than the two blocks both da1 kernels are built for.
Last it prints the fp32 da1 rows layer by layer and the per-step sums
(ten layers), dW and da1 each as kernel / einsums / plain / bound.
`chip_smoke.py` phase 4 runs the same functions; the dx calls (gcn_fwd
on g, a1^T, W^T) are `fwd_check.py`'s.

Bounds: the larger of the bytes over 3.35 TB/s and the flops over the
type's peak. Each function here is a chain of a product over the V
joints and one over the channels; in bf16 the intermediate is rounded
(the aggregate, u, p), which fixes the order, while in fp32 the rounding
is the identity and the bound takes the cheaper order.

Tolerances (`within_tol`): fp32 (TF32 off) max err <= 1e-4 of the
output's scale (fp32 sums of up to B*T*V products in another order);
bf16 per element <= 2^-7 |ref| + 2^-10 of the scale (one bf16 rounding of
each output may land one ulp apart).

The card-check helpers here (`check`, `cuda_time_ms`, `within_tol`, the
published peaks and the layer shapes) are `fwd_check.py`'s and
`chip_smoke.py`'s too.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time

SEED = 0
TRAIN_BATCH = 64  # samples per step; 128 after folding the persons
PERSONS = 2
# (T, C, Co) of the ten GCN calls of one AGCN forward at T=300, with how
# many layers run each shape (l1; l2-l4; l5; l6-l7; l8; l9-l10)
LAYER_SHAPES = [((300, 3, 64), 1), ((300, 64, 64), 3), ((300, 64, 128), 1),
                ((150, 128, 128), 2), ((150, 128, 256), 1),
                ((75, 256, 256), 2)]
LAYERS = sum(n for _, n in LAYER_SHAPES)
# H100 SXM published peaks (dense): fp32 outside the tensor cores, bf16
# tensor cores, HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
SOURCE = "agcn_tpu_torch/ops/csrc/gcn_bwd.cu"
# the CUDA kernels of gcn_bwd's route in each dtype: (dW, da1)
ROUTE_KERNELS = {
    "bfloat16": (["gcn_u_kernel", "gcn_dw_mma_kernel",
                  "gcn_dw_reduce_kernel"],
                 ["gcn_da1_mma_kernel", "gcn_da1_reduce_kernel"]),
    "float32": (["gcn_u_kernel", "gcn_dw_fp32_kernel",
                 "gcn_dw_reduce_kernel"],
                ["gcn_da1_fp32_kernel", "gcn_da1_reduce_kernel"])}
DA1_FP32_KERNEL = "gcn_da1_fp32_kernel"
# the kernels of the source whose ptxas spills fail the card checks
SPILL_CHECKED = ("gcn_da1_mma_kernel", DA1_FP32_KERNEL, "gcn_dw_fp32_kernel",
                 "gcn_u_kernel")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def within_tol(got, want):
    """(ok, max abs err, output scale) of a kernel output against its
    plain version, at the tolerance stated in the module docstring."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    scale = ref.max().item()
    if want.element_size() == 4:
        # fp32 sums of up to K*V*C = 19,200 products in another order:
        # 1e-4 of the output's scale
        ok = diff.max().item() <= 1e-4 * scale
    else:
        # bf16: one rounding of each output may land one ulp apart:
        # 2^-7 relative plus 2^-10 of the scale
        ok = bool((diff <= 2 ** -7 * ref + 2 ** -10 * scale).all())
    return ok, diff.max().item(), scale


def bound_ms(flops, nbytes, dname):
    """(least time in ms, what bounds it) on the published peaks."""
    flop_ms = flops / PEAK_FLOPS[dname] * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return max(flop_ms, byte_ms), "operations" if flop_ms > byte_ms \
        else "bytes"


def chain_flops(b, t, c, co, inner, dtype_name, v=25, k=3):
    """Flops of sum_k over (b, t) of a product over the V joints on
    `inner` channels and a product over the channels, C in and Co out:
    2 K B T V (C Co + V inner). In fp32 the intermediate's rounding is
    the identity, so either order computes the function and the V
    product takes the narrower side, min(C, Co)."""
    if dtype_name == "float32":
        inner = min(c, co)
    return 2 * k * b * t * v * (c * co + v * inner)


def gcn_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) one gcn_fwd call needs: each input read once, the
    output written once; the aggregate over x's C channels, rounded in
    bf16."""
    size = 4 if dtype_name == "float32" else 2
    flops = chain_flops(b, t, c, co, c, dtype_name, v, k)
    nbytes = (b * t * v * (c + co) + b * k * v * v + k * c * co) * size
    return flops, nbytes


def gcn_bwd_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) one gcn_bwd call needs: x, g, a1 and W read once,
    dW and da1 written once; the flops of dW and of da1
    (`gcn_bwd_half_work`)."""
    size = 4 if dtype_name == "float32" else 2
    flops = 2 * gcn_bwd_half_work(b, t, c, co, dtype_name, v, k)[0]
    nbytes = (b * t * v * (c + co) + 2 * (b * k * v * v + k * c * co)) * size
    return flops, nbytes


def gcn_bwd_half_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) of dW alone, which are also those of da1 alone:
    x and g read once, a1 and W (one of them) read once, the gradient
    written once. In bf16 u = g a1^T (p = x W) is rounded on its Co
    channels and contracted with x (g); in fp32 dW may take x a1 and da1
    g W^T, the narrower where C < Co (`chain_flops`)."""
    size = 4 if dtype_name == "float32" else 2
    flops = chain_flops(b, t, c, co, co, dtype_name, v, k)
    nbytes = (b * t * v * (c + co) + b * k * v * v + k * c * co) * size
    return flops, nbytes


def library_dw(torch, x, a1, g):
    """dW as ops.gcn.adaptive_gcn_bwd computes it (the `agg` and `kco`
    einsums on cuBLAS; the yardstick, used nowhere in the port)."""
    agg = torch.einsum("btvc,bkvw->btwkc", x, a1)
    return torch.einsum("btwkc,btwo->kco", agg, g)


def library_da1(torch, x, w, g):
    """da1 as ops.gcn.adaptive_gcn_bwd computes it (the p product and the
    `bkvw` einsum)."""
    b, t, v, c = x.shape
    k, _, co = w.shape
    p = (x @ w.permute(1, 0, 2).reshape(c, k * co)).reshape(b, t, v, k, co)
    return torch.einsum("btvko,btwo->bkvw", p, g)


def bwd_spills(ptxas_log):
    """The spills that ptxas reports in the kernels of SPILL_CHECKED,
    each as (mangled name, store bytes, load bytes)."""
    from agcn_tpu_torch.tools.fwd_check import spilling

    return [s for k in SPILL_CHECKED for s in spilling(ptxas_log, kernel=k)]


def report_da1_fp32_build(ptxas_log):
    """Log each `gcn_da1_fp32_kernel<V, CC>` instantiation's registers
    and spills as ptxas reports them; returns them as dicts."""
    from agcn_tpu_torch.tools.fwd_check import ptxas_kernels

    out = []
    for r in ptxas_kernels(ptxas_log, (DA1_FP32_KERNEL,)):
        rest = r["name"][r["name"].index(DA1_FP32_KERNEL):]
        v, cc = (int(n) for n in re.findall(r"Li(\d+)E", rest)[:2])
        label = f"{DA1_FP32_KERNEL}<{v}, {cc}>"
        out.append(dict(r, label=label))
        log(f"  {label}: {r['registers']} registers, {r['spill_stores']} + "
            f"{r['spill_loads']} spill bytes")
    return out


def check_da1_tiling(gcn_fused):
    """What each da1 launch takes, from the library (`da1_tiling`) at
    V = 25 and 18, the C = 3 entry layer's chunk and the wide one, in
    both types, logged: an SM must hold the two blocks that both da1
    kernels are built for (`__launch_bounds__(256, 2)`). Returns the
    answers as dicts."""
    out = []
    for bf16 in (False, True):
        for v in (25, 18):
            for c in (3, 64):
                frames, smem, blocks = gcn_fused.da1_tiling(v, c, bf16)
                name = "gcn_da1_mma_kernel" if bf16 else DA1_FP32_KERNEL
                out.append(dict(kernel=name, v=v, c=c, frames=frames,
                                smem=smem, blocks_per_sm=blocks))
                log(f"  {name} V={v} C={c}: {frames}-frame tiles, {smem} B "
                    f"dynamic shared memory, {blocks} blocks an SM (the "
                    f"library's answer)")
                check(blocks >= 2, f"{name} V={v} C={c}: {blocks} blocks an "
                                   f"SM at {smem} B, built for 2")
    return out


def exact_dw_batch(t, v=25, batch=TRAIN_BATCH * PERSONS):
    """The batch (at most `batch`) of check_dw_fp32_exact at T frames:
    x and g in [-2, 2], a1 in [-1, 1] bound each term |x u| by 2 * 2V,
    so B*T*V of them sum below 2^24."""
    return min(batch, (2 ** 24 - 1) // (t * v * 2 * 2 * v))


def check_dw_fp32_exact(torch, np, gcn_fused, t, c, co):
    """fp32 integer inputs whose every dW sum is exact in fp32 in any
    order (sum |x| |u| < 2^24, checked): gcn_bwd's fp32 dW must equal its
    plain version bit for bit. Returns the batch."""
    b = exact_dw_batch(t)
    rng = np.random.default_rng(SEED + 11)
    x, a1, g = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        rng.integers(-2, 3, (b, t, 25, c)),
        rng.integers(-1, 2, (b, 3, 25, 25)),
        rng.integers(-2, 3, (b, t, 25, co))))
    w = torch.zeros(3, c, co, device="cuda")
    terms = gcn_fused.gcn_dw_plain(x.abs(), a1.abs(), g.abs())
    check(terms.max().item() < 2 ** 24,
          f"fp32 dW T={t} C={c} Co={co}: sum |terms| {terms.max().item()} "
          f"reaches 2^24")
    dw = gcn_fused.launch_gcn_bwd_dw(x, a1, w, g)
    check(torch.equal(dw, gcn_fused.gcn_dw_plain(x, a1, g)),
          f"fp32 dW T={t} C={c} Co={co} batch {b}: integer inputs differ "
          f"from the plain version")
    return b


def check_da1_fp32_exact(torch, gcn_fused, t, c, co,
                         b=TRAIN_BATCH * PERSONS):
    """fp32 x, W and g integers in [-1, 1] (a1 anything): every |p| <= C
    and every da1 sum of |p| |g| stays below 2^24 (checked), so the sums
    are exact in fp32 in any order and gcn_bwd's fp32 da1 must equal its
    plain version bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x, g = (torch.randint(-1, 2, shape, device="cuda",
                          generator=gen).float()
            for shape in ((b, t, 25, c), (b, t, 25, co)))
    w = torch.randint(-1, 2, (3, c, co), device="cuda",
                      generator=gen).float()
    a1 = torch.randn(b, 3, 25, 25, device="cuda", generator=gen)
    terms = gcn_fused.gcn_da1_plain(x.abs(), w.abs(), g.abs())
    check(terms.max().item() < 2 ** 24,
          f"fp32 da1 T={t} C={c} Co={co}: sum |terms| {terms.max().item()} "
          f"reaches 2^24")
    del terms
    da1 = gcn_fused.launch_gcn_bwd_da1(x, a1, w, g)
    check(torch.equal(da1, gcn_fused.gcn_da1_plain(x, w, g)),
          f"fp32 da1 T={t} C={c} Co={co} batch {b}: integer inputs differ "
          f"from the plain version")


def check_bwd_rounding(torch, np, gcn_fused, c, co):
    """bf16 integer inputs whose every sum is exact in fp32 in any order:
    gcn_bwd must equal its plain version bit for bit, and the same sums
    without the rounding of u (for dW) or of p (for da1) must differ."""
    rng = np.random.default_rng(SEED + 5)
    x, a1, w, g = (torch.from_numpy(a.astype(np.float32)).to(
        "cuda", torch.bfloat16) for a in (
        rng.integers(-4, 5, (2, 8, 25, c)),
        rng.integers(-32, 33, (2, 3, 25, 25)),
        rng.integers(-32, 33, (3, c, co)),
        rng.integers(-32, 33, (2, 8, 25, co))))
    dw, da1 = gcn_fused.launch_gcn_bwd(x, a1, w, g)
    want = gcn_fused.gcn_bwd_plain(x, a1, w, g)
    check(torch.equal(dw, want[0]) and torch.equal(da1, want[1]),
          f"gcn_bwd C={c} Co={co}: integer inputs differ from the plain "
          f"version")
    xf, gf = x.float(), g.float()
    dw_u = torch.stack([torch.einsum(
        "btvc,btvo->co", xf, torch.einsum("btwo,bvw->btvo", gf,
                                           a1[:, k].float()))
        for k in range(3)]).to(torch.bfloat16)
    da1_p = torch.stack([torch.einsum("btvo,btwo->bvw", xf @ w[k].float(),
                                      gf)
                         for k in range(3)], dim=1).to(torch.bfloat16)
    check(not torch.equal(dw, dw_u) and not torch.equal(da1, da1_p),
          f"gcn_bwd C={c} Co={co}: the rounding of u or p has no effect")


def phase_bwd_kernels(torch, np, gcn_fused):
    """gcn_bwd against its plain version at the training shapes (batch
    128 after folding the persons). Returns the rows."""
    b = TRAIN_BATCH * PERSONS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    check_da1_tiling(gcn_fused)
    rows = []
    for (t, c, co), mult in LAYER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            frames, smem, _ = gcn_fused.da1_tiling(
                25, c, dtype == torch.bfloat16)
            x = torch.randn(b, t, 25, c, device="cuda", generator=gen)
            a1 = torch.softmax(torch.randn(b, 3, 25, 25, device="cuda",
                                           generator=gen), dim=-2)
            a1 = a1 + 0.2 * torch.rand(3, 25, 25, device="cuda",
                                       generator=gen)
            w = torch.randn(3, c, co, device="cuda",
                            generator=gen) / math.sqrt(3 * c)
            g = torch.randn(b, t, 25, co, device="cuda", generator=gen)
            x, a1, w, g = (a.to(dtype) for a in (x, a1, w, g))
            dw, da1 = gcn_fused.gcn_backward(x, a1, w, g)
            again = gcn_fused.gcn_backward(x, a1, w, g)
            torch.cuda.synchronize()
            check(torch.equal(dw, again[0]) and torch.equal(da1, again[1]),
                  f"gcn_bwd {dname} T={t} C={c} Co={co}: two calls differ")
            want = gcn_fused.gcn_bwd_plain(x, a1, w, g)
            (ok_w, err_w, scale_w), (ok_a, err_a, scale_a) = (
                within_tol(dw, want[0]), within_tol(da1, want[1]))
            check(ok_w and ok_a,
                  f"gcn_bwd {dname} T={t} C={c} Co={co}: dW max err "
                  f"{err_w:.3e} (scale {scale_w:.3e}), da1 max err "
                  f"{err_a:.3e} (scale {scale_a:.3e})")
            del dw, da1, again, want
            flops, nbytes = gcn_bwd_work(b, t, c, co, dname)
            half = bound_ms(*gcn_bwd_half_work(b, t, c, co, dname), dname)
            row = dict(
                t=t, c=c, co=co, layers=mult, dtype=dname,
                max_abs_err=max(err_w, err_a), err_dw=err_w, err_da1=err_a,
                scale_dw=scale_w, scale_da1=scale_a,
                ms=cuda_time_ms(lambda: gcn_fused.gcn_backward(x, a1, w, g),
                                10),
                dw_ms=cuda_time_ms(
                    lambda: gcn_fused.launch_gcn_bwd_dw(x, a1, w, g), 10),
                da1_ms=cuda_time_ms(
                    lambda: gcn_fused.launch_gcn_bwd_da1(x, a1, w, g), 10),
                plain_ms=cuda_time_ms(
                    lambda: gcn_fused.gcn_bwd_plain(x, a1, w, g), 3),
                dw_plain_ms=cuda_time_ms(
                    lambda: gcn_fused.gcn_dw_plain(x, a1, g).to(dtype), 3),
                da1_plain_ms=cuda_time_ms(
                    lambda: gcn_fused.gcn_da1_plain(x, w, g).to(dtype), 3),
                dw_library_ms=cuda_time_ms(
                    lambda: library_dw(torch, x, a1, g), 3),
                da1_library_ms=cuda_time_ms(
                    lambda: library_da1(torch, x, w, g), 3),
                half_bound_ms=half[0],  # of dW alone, and of da1 alone
                half_bound_by=half[1],
                da1_groups=gcn_fused.da1_groups(b, t, frames),
                da1_smem=smem,
                flops=flops, bytes=nbytes,
                flop_ms=flops / PEAK_FLOPS[dname] * 1e3,
                byte_ms=nbytes / PEAK_BYTES * 1e3)
            row["library_ms"] = row["dw_library_ms"] + row["da1_library_ms"]
            rows.append(row)
            log(f"  gcn_bwd T={t:3d} C={c:3d} Co={co:3d} {dname:8s} "
                f"err={row['max_abs_err']:.2e} kernel={row['ms']:.4f} ms "
                f"plain={row['plain_ms']:.4f} ms einsum="
                f"{row['library_ms']:.4f} ms bound="
                f"{max(row['flop_ms'], row['byte_ms']):.4f} ms "
                f"({'ops' if row['flop_ms'] > row['byte_ms'] else 'bytes'})")
            for p in ("dw", "da1"):
                log(f"          {p:3s} {row[f'{p}_ms']:.4f} ms (einsums "
                    f"{row[f'{p}_library_ms']:.4f}, plain "
                    f"{row[f'{p}_plain_ms']:.4f}, bound {half[0]:.4f} "
                    f"{half[1]})")
            del x, a1, w, g
        if c >= 8:
            # at C=3, p = x W has too few bits for its rounding to show
            check_bwd_rounding(torch, np, gcn_fused, c, co)
            log(f"  gcn_bwd C={c:3d} Co={co:3d} bfloat16 integer inputs: "
                f"equal to the plain version; without the rounding of u or "
                f"p the result differs")
        exact_b = check_dw_fp32_exact(torch, np, gcn_fused, t, c, co)
        log(f"  gcn_bwd T={t:3d} C={c:3d} Co={co:3d} float32 dW on integer "
            f"inputs (batch {exact_b}): equal to the plain version")
        check_da1_fp32_exact(torch, gcn_fused, t, c, co)
        log(f"  gcn_bwd T={t:3d} C={c:3d} Co={co:3d} float32 da1 on integer "
            f"inputs (batch {b}): equal to the plain version")
    return rows


def da1_fp32_layers(rows):
    """The fp32 da1 rows layer by layer, logged: kernel ms beside the
    einsums, the plain version and the bound, with the frame groups and
    the shared memory of a block that the launch took; returns them as
    dicts."""
    out = []
    for r in rows:
        if r["dtype"] != "float32":
            continue
        row = dict(t=r["t"], c=r["c"], co=r["co"], layers=r["layers"],
                   ms=r["da1_ms"], library_ms=r["da1_library_ms"],
                   plain_ms=r["da1_plain_ms"], bound_ms=r["half_bound_ms"],
                   bound_by=r["half_bound_by"], groups=r["da1_groups"],
                   smem=r["da1_smem"])
        out.append(row)
        log(f"  fp32 da1 T={row['t']:3d} C={row['c']:3d} Co={row['co']:3d} "
            f"x{row['layers']}: {row['ms']:.4f} ms, einsums "
            f"{row['library_ms']:.4f}, plain {row['plain_ms']:.4f}, bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}); {row['groups']} "
            f"groups, {row['smem']} B shared memory a block")
    return out


def bwd_entry(rows, launches, dname="bfloat16"):
    """The `kernels` entry of gcn_bwd: per training step, the sum over the
    ten layers at batch 128 in `dname`, with dW and da1 apart."""
    sel = [r for r in rows if r["dtype"] == dname]
    tot = lambda key: sum(r[key] * r["layers"] for r in sel)  # noqa: E731
    whole = bound_ms(tot("flops"), tot("bytes"), dname)
    b = TRAIN_BATCH * PERSONS
    half = bound_ms(
        sum(gcn_bwd_half_work(b, r["t"], r["c"], r["co"], dname)[0]
            * r["layers"] for r in sel),
        sum(gcn_bwd_half_work(b, r["t"], r["c"], r["co"], dname)[1]
            * r["layers"] for r in sel), dname)
    parts = {p: {"ms": tot(f"{p}_ms"), "library_ms": tot(f"{p}_library_ms"),
                 "plain_ms": tot(f"{p}_plain_ms"),
                 "bound_ms": half[0], "bound_by": half[1],
                 "max_abs_err": max(r[f"err_{p}"] for r in sel)}
             for p in ("dw", "da1")}
    parts["dw"]["kernels"], parts["da1"]["kernels"] = ROUTE_KERNELS[dname]
    return {"name": "gcn_bwd (dW, da1)", "route": "cuda", "source": SOURCE,
            "replaces": "agcn_tpu/ops/pallas/gcn_fused.py:72",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in sel),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": whole[0], "bound_by": whole[1],
            "library_ms": tot("library_ms"), "dtype": dname,
            "per": "one training step (10 layers, 128 samples, T=300)",
            **parts}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from agcn_tpu_torch.ops.kernels import build, gcn_fused

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bwd_check: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"{torch.cuda.get_device_name(0)}: {smi}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all(["gcn_bwd"])["gcn_bwd"]
    log(f"built gcn_bwd in {time.perf_counter() - t0:.1f} s")
    for ln in built.log.splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            log(f"  {ln.strip()}")
    da1_build = report_da1_fp32_build(built.log)
    log("gcn_bwd vs its plain version at the training shapes (batch 128)")
    try:
        spills = bwd_spills(built.log)
        check(not spills, f"gcn_bwd kernels spill: {spills}")
        with torch.inference_mode():
            rows = phase_bwd_kernels(torch, np, gcn_fused)
    except SmokeFailure as e:
        print(f"bwd_check: FAILED: {e}", file=sys.stderr)
        return 1
    log("fp32 da1 per layer (gcn_da1_fp32_kernel, ms)")
    da1_layers = da1_fp32_layers(rows)
    entries = [bwd_entry(rows, 0, d) for d in ("float32", "bfloat16")]
    for e in entries:
        log(f"per step ({e['dtype']}): gcn_bwd {e['ms']:.3f} ms (plain "
            f"{e['plain_ms']:.3f}, einsums {e['library_ms']:.3f}, bound "
            f"{e['bound_ms']:.3f} {e['bound_by']}); "
            + "; ".join(f"{p} {e[p]['ms']:.3f} ms (einsums "
                        f"{e[p]['library_ms']:.3f}, plain "
                        f"{e[p]['plain_ms']:.3f}, bound "
                        f"{e[p]['bound_ms']:.3f} {e[p]['bound_by']})"
                        for p in ("dw", "da1")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "ptxas": built.log,
                       "da1_fp32_build": da1_build, "rows": rows,
                       "da1_fp32_layers": da1_layers, "per_step": entries},
                      f, indent=1)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
