"""gcn_fwd on the card against its plain version, served and as dx.

    python -m agcn_tpu_torch.tools.fwd_check [--out FILE] [--joints V ...]

The quick card check of `ops/csrc/gcn_fwd.cu`, a minute or two: it
builds that source alone (and fails if ptxas reports a spill in any
instantiation of `gcn_fwd_mma_kernel`, `gcn_fwd_fp32_kernel` or the
general `gcn_fwd_gen_kernel`, and prints each fp32 one's registers,
spills and shared memory), then

1. at each AGCN layer shape of the served batch (16 streams x 2 persons =
   32 samples, T=300), at each V of `--joints` (25, the NTU skeleton; 15,
   the OpenPose one; 31, the STGAT expanded graph, and 67, OpenPose
   BODY_25 with both hands, on the general kernel), fp32 and bf16, both
   aggregate-rounding modes,
   holds the kernel against its plain version (`gcn_fwd_plain`) and times
   it beside its library yardstick (one `torch.einsum`) and its bound. At
   each shape, on bf16 integer inputs where the two modes differ, each
   mode must match its own plain version and fail the other's;
2. at each layer shape of a training step (batch 64 x 2 persons = 128
   samples) the dx call, gcn_fwd on (g, a1^T, W^T) with C and Co
   swapped, the same way (bf16 and fp32, round_agg=1);
3. on small-integer inputs, bf16 and fp32 equal to the plain version bit
   for bit and two calls on the same inputs bitwise equal: both round_agg
   modes at every served shape (in bf16 the two modes' results must
   differ, in fp32 they are one function and must agree), round_agg=1 at
   every dx shape.

Last it prints the fp32 rows layer by layer, then the per-forward and
per-step sums. `chip_smoke.py` phase 3 runs the same functions.

Which kernel serves which call (the C entry `agcn_gcn_fwd`): bf16 x and
a1 go to `gcn_fwd_mma_kernel` on the tensor cores, round_agg=1 (the
aggregate rounded to bf16, `gcn_fused`'s `_fwd_kernel`) as it is,
round_agg=0 (the aggregate kept in fp32, `gcn_kernel`'s `_kernel`) with
each aggregate split into two bf16 parts, hi + lo, both projected; fp32
calls, and bf16 x with fp32 a1, go to `gcn_fwd_fp32_kernel` on the CUDA
cores (exact fp32 FMAs; its tiles are `fp32_tiling`'s). That is at the
tuned V = 15, 18 and 25; every other V goes to `gcn_fwd_gen_kernel`,
exact fp32 FMAs on the CUDA cores in every type combination.

Tolerances (`bwd_check.within_tol`): fp32 (TF32 off) max err <= 1e-4 of
the output's scale; bf16 per element <= 2^-7 |ref| + 2^-10 of the scale.
Bit-exact inputs: x and a1 integers in [-8, 8], W in [-2, 2], all exact in
bf16. Every aggregate (|agg| <= V * 64 <= 1,600) and every fp32 sum of
the projection (< 2^22) is an integer below 2^24, so it is exact in fp32
in any summation order; only the rounding points (the aggregate to bf16
with round_agg=1, y to bf16) decide the result, and in fp32 there are
none. With round_agg=0 each
aggregate, an integer below 2^17, is exactly the sum of its two bf16
parts, so the split projection adds the same integers.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
import time

from agcn_tpu_torch.tools.bwd_check import (
    JOINTS, JOINTS_CHECKED, JOINTS_GENERAL, LAYER_SHAPES, PEAK_BYTES,
    PEAK_FLOPS, PERSONS, SEED, TRAIN_BATCH, SmokeFailure, bound_ms, check,
    cuda_time_ms, gcn_work, log, nvidia_smi_line, within_tol)

SERVE_BATCH = 32  # 16 streams x 2 persons
SOURCE = "agcn_tpu_torch/ops/csrc/gcn_fwd.cu"
# the kernels of gcn_fwd.cu whose spills fail the build checks
SPILL_CHECKED = ("gcn_fwd_mma_kernel", "gcn_fwd_fp32_kernel",
                 "gcn_fwd_gen_kernel")
FP32_KERNEL = "gcn_fwd_fp32_kernel"
GEN_KERNEL = "gcn_fwd_gen_kernel"
# the general kernel's tile (gcn_fwd.cu G_*): frames, destination joints,
# source joints a slice, output and input channels, static shared memory
GEN_TILE = dict(tt=4, wt=32, vs=32, ot=64, cc=16,
                smem=(3 * 16 * (4 * 32 + 4) + 4 * 32 * 16 + 3 * 32 * 32) * 4)


def spilling(ptxas_log, kernel=SPILL_CHECKED):
    """The entry functions of `kernel` (a substring of the mangled name,
    or a tuple of them) for which `nvcc -Xptxas -v` reports spill stores
    or loads, each as (name, store bytes, load bytes)."""
    kernels = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    return [(r["name"], r["spill_stores"], r["spill_loads"])
            for r in ptxas_kernels(ptxas_log, kernels)
            if r["spill_stores"] or r["spill_loads"]]


def ptxas_kernels(ptxas_log, kernels):
    """Per entry function whose mangled name holds one of `kernels`, what
    `nvcc -Xptxas -v` reports: name, registers, spill store and load
    bytes, in the log's order."""
    out, cur = [], None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = None
            if any(k in m.group(1) for k in kernels):
                cur = dict(name=m.group(1), registers=None, spill_stores=0,
                           spill_loads=0)
                out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def fp32_tile(v, ot, cc):
    """`F32Tile<V, OT, CC>` of gcn_fwd.cu, mirrored: of a block's 256
    threads, those across the columns (cx) and rows (ry), row quads a
    thread (rq), rows a block with the pad rows (rows_p), frames a block
    (tt), a1's padded row (vp), the row stride of the staged aggregate
    (lda)."""
    cx = ot // 8
    ry = 256 // cx
    rq = 1 if ot == 8 else 2
    rows_p = 4 * ry * rq
    return dict(ot=ot, cc=cc, cx=cx, ry=ry, rq=rq, rows_p=rows_p,
                tt=rows_p // v, vp=(v + 3) // 4 * 4, lda=rows_p + 4)


def fp32_smem(itemsize, v, ot, cc):
    """`F32Layout<T, V, OT, CC>::BYTES`: the dynamic shared memory of a
    block of `gcn_fwd_fp32_kernel` with x, W of `itemsize` bytes."""
    t = fp32_tile(v, ot, cc)
    x_bytes = (t["tt"] * v * cc * itemsize + 15) // 16 * 16
    return (3 * v * t["vp"] * 4 + 3 * cc * t["lda"] * 4 + x_bytes
            + 3 * cc * ot * itemsize)


def fp32_tiling(v, c, co):
    """The tile `launch_fp32_tile` of gcn_fwd.cu picks for a call at a
    tuned V (15, 18, 25): 8 output channels a block when Co <= 8, else 64
    when Co <= 64, else 128; input-channel chunks of 4 when C <= 8 or Co
    <= 8, else 16. At any other V, `gcn_fwd_gen_kernel`'s one tile
    (`GEN_TILE`, whatever C and Co), with the kernel's name."""
    if v not in JOINTS:
        return dict(GEN_TILE, kernel=GEN_KERNEL)
    ot = 8 if co <= 8 else 64 if co <= 64 else 128
    return fp32_tile(v, ot, 4 if c <= 8 or co <= 8 else 16)


def kernel_label(name):
    """`gcn_fwd_fp32_kernel<float, 25, 64, 16>` of a mangled name."""
    for k in SPILL_CHECKED:
        at = name.find(k)
        if at >= 0:
            rest = name[at + len(k):]
            args = (["bf16" if rest.startswith("I13__nv_bfloat16") else
                     "float"] if k == FP32_KERNEL else [])
            args += [n for _, n in re.findall(r"L([ib])(\d+)E", rest)]
            return f"{k}<{', '.join(args)}>"
    return name


def report_fp32_build(ptxas_log):
    """Log each `gcn_fwd_fp32_kernel` instantiation's registers, spills and
    dynamic shared memory (`fp32_smem`); returns them as dicts."""
    out = []
    for r in ptxas_kernels(ptxas_log, (FP32_KERNEL,)):
        label = kernel_label(r["name"])
        args = label[label.index("<") + 1:-1].split(", ")
        smem = fp32_smem(2 if args[0] == "bf16" else 4,
                         *(int(a) for a in args[1:4]))
        out.append(dict(r, label=label, smem=smem))
        log(f"  {label}: {r['registers']} registers, "
            f"{r['spill_stores']} + {r['spill_loads']} spill bytes, "
            f"{smem} B dynamic shared memory")
    return out


def report_gen_build(ptxas_log):
    """Log the registers and spills of each general kernel (any V outside
    the tuned ones: `gcn_fwd_gen_kernel`, `gcn_u_gen_kernel`,
    `gcn_da1_gen_kernel`) in one source's ptxas log; returns them as
    dicts."""
    out = ptxas_kernels(ptxas_log, ("_gen_kernel",))
    for r in out:
        name = re.search(r"gcn_[a-z0-9]+_gen_kernel", r["name"]).group(0)
        # the template arguments, T (and A): float, bf16, or a
        # substitution of the bf16 named before (S1_)
        args = r["name"].split("_gen_kernelI", 1)[1].split("EE", 1)[0]
        kinds = []
        for k in re.findall(r"13__nv_bfloat16|S\d*_|f", args):
            kinds.append(kinds[-1] if k.startswith("S") else
                         "bf16" if k.startswith("13") else "float")
        r["label"] = f"{name}<{', '.join(kinds)}>"
        log(f"  {r['label']}: {r['registers']} registers, "
            f"{r['spill_stores']} + {r['spill_loads']} spill bytes")
    return out


def library_fwd(torch, x, a1, w):
    """The function as one torch.einsum (the yardstick, used nowhere in
    the port)."""
    return torch.einsum("btvc,bkvw,kco->btwo", x, a1, w)


def exact_inputs(torch, np, b, t, c, co, seed, dtype=None, v=25):
    """x, a1 and W on the card in `dtype` (bf16 by default) at V joints,
    small integers: every sum of the kernel is exact in fp32 in any order
    (module docstring)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(
        "cuda", dtype or torch.bfloat16) for a in (
        rng.integers(-8, 9, (b, t, v, c)),
        rng.integers(-8, 9, (b, 3, v, v)),
        rng.integers(-2, 3, (3, c, co))))


def check_exact(torch, np, gcn_fused, b, t, c, co, label, modes,
                dtype=None, v=25):
    """On integer inputs in `dtype` (bf16 by default), each round_agg mode
    of `modes` equals the plain version bit for bit, and two calls are
    bitwise equal; with both modes, their results differ in bf16 and
    agree in fp32 (where the aggregate's rounding is the identity)."""
    dtype = dtype or torch.bfloat16
    dname = "bf16" if dtype == torch.bfloat16 else "fp32"
    x, a1, w = exact_inputs(torch, np, b, t, c, co, SEED + 11, dtype, v)
    got = {}
    for r in modes:
        got[r] = gcn_fused.launch_gcn_fwd(x, a1, w, r)
        again = gcn_fused.launch_gcn_fwd(x, a1, w, r)
        torch.cuda.synchronize()
        want = gcn_fused.gcn_fwd_plain(x, a1, w, r)
        what = (f"{label} V={v} T={t} C={c} Co={co} {dname} "
                f"round_agg={int(r)}")
        check(torch.equal(got[r], again), f"{what}: two calls differ")
        check(torch.equal(got[r], want),
              f"{what}: integer inputs differ from the plain version "
              f"({(got[r] != want).sum().item()} elements, max "
              f"{(got[r].float() - want.float()).abs().max().item():.3e})")
    if len(got) == 2:
        differ = not torch.equal(got[True], got[False])
        check(differ == (dtype == torch.bfloat16),
              f"{label} V={v} T={t} C={c} Co={co} {dname}: the round_agg "
              f"modes "
              f"{'agree' if not differ else 'differ'} on integer inputs")


def check_rounding_modes(torch, np, wrappers, gcn_fused, b, t, c, co,
                         v=25):
    """bf16 inputs on which the two rounding modes differ beyond the
    tolerance: x and a1 signed integers in [-64, 64], exact in bf16, whose
    aggregates (17 significant bits, exact in fp32 in any order) lose 9
    bits when rounded to bf16. Each mode must match the plain version of
    its own mode and fail the other's, so a kernel that ignored or
    inverted round_agg fails here."""
    rng = np.random.default_rng(SEED + 2)
    x, a1, w = (torch.from_numpy(a.astype(np.float32)).to(
        "cuda", torch.bfloat16) for a in (
        rng.integers(-64, 65, (b, t, v, c)),
        rng.integers(-64, 65, (b, 3, v, v)),
        rng.standard_normal((3, c, co)) / np.sqrt(3 * c)))
    got = {r: wrappers[r](x, a1, w) for r in (True, False)}
    check(not torch.equal(got[True], got[False]),
          f"V={v} T={t} C={c} Co={co}: round_agg has no effect in bf16")
    for r in (True, False):
        own = within_tol(got[r], gcn_fused.gcn_fwd_plain(x, a1, w, r))
        other = within_tol(got[r], gcn_fused.gcn_fwd_plain(x, a1, w, not r))
        check(own[0] and not other[0],
              f"V={v} T={t} C={c} Co={co} round_agg={r}: max err "
              f"{own[1]:.3e} "
              f"against its own mode, {other[1]:.3e} against the other "
              f"(tolerance must pass the first and fail the second)")
    return own[2]


def _row(torch, kernel, plain, x, a1, w, label, t, c, co, mult, dname,
         round_agg, iters, slow_iters):
    """Hold one call against its plain version and time it (`iters`
    calls; the plain version and the einsum `slow_iters`); returns the
    row."""
    b, v = x.shape[0], x.shape[2]
    got = kernel()
    torch.cuda.synchronize()
    ok, err, scale = within_tol(got, plain())
    check(ok, f"{label} {dname} round_agg={round_agg} V={v} T={t} C={c} "
              f"Co={co}: max err {err:.3e} (scale {scale:.3e})")
    del got
    flops, nbytes = gcn_work(b, t, c, co, dname, v)
    row = dict(v=v, t=t, c=c, co=co, layers=mult, dtype=dname,
               round_agg=round_agg, max_abs_err=err, scale=scale,
               ms=cuda_time_ms(kernel, iters),
               plain_ms=cuda_time_ms(plain, slow_iters),
               library_ms=cuda_time_ms(lambda: library_fwd(torch, x, a1, w),
                                       slow_iters),
               flops=flops, bytes=nbytes,
               flop_ms=flops / PEAK_FLOPS[dname] * 1e3,
               byte_ms=nbytes / PEAK_BYTES * 1e3)
    log(f"  {label:7s} V={v} T={t:3d} C={c:3d} Co={co:3d} {dname:8s} "
        f"round_agg={int(round_agg)} err={err:.2e} kernel={row['ms']:.4f} "
        f"ms plain={row['plain_ms']:.4f} ms einsum={row['library_ms']:.4f} "
        f"ms bound={max(row['flop_ms'], row['byte_ms']):.4f} ms "
        f"({'ops' if row['flop_ms'] > row['byte_ms'] else 'bytes'})")
    return row


def phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel, v=25, iters=20,
                      slow_iters=5):
    """Each forward wrapper against its plain version at the served layer
    shapes with V joints (the wrappers' launch counts are reset before
    the main path); the kernel timed over `iters` calls, the plain
    version and the einsum over `slow_iters`."""
    wrappers = {True: gcn_fused.adaptive_gcn_pallas,
                False: gcn_kernel.fused_gcn}
    b = SERVE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (t, c, co), mult in LAYER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = torch.randn(b, t, v, c, device="cuda", generator=gen)
            a1 = torch.softmax(torch.randn(b, 3, v, v, device="cuda",
                                           generator=gen), dim=-2)
            a1 = a1 + 0.2 * torch.rand(3, v, v, device="cuda",
                                       generator=gen)
            w = torch.randn(3, c, co, device="cuda",
                            generator=gen) / math.sqrt(3 * c)
            x, a1, w = x.to(dtype), a1.to(dtype), w.to(dtype)
            for round_agg in (True, False):
                kernel = wrappers[round_agg]
                rows.append(_row(
                    torch, lambda: kernel(x, a1, w),
                    lambda: gcn_fused.gcn_fwd_plain(x, a1, w, round_agg),
                    x, a1, w, "served", t, c, co, mult, dname, round_agg,
                    iters, slow_iters))
            del x, a1, w
        scale = check_rounding_modes(torch, np, wrappers, gcn_fused, b, t,
                                     c, co, v)
        log(f"  V={v} T={t:3d} C={c:3d} Co={co:3d} bfloat16 integer inputs "
            f"(scale {scale:.3e}): each round_agg mode matches its own "
            f"plain version and fails the other's")
        check_exact(torch, np, gcn_fused, b, t, c, co, "served",
                    (True, False), v=v)
        check_exact(torch, np, gcn_fused, b, t, c, co, "served",
                    (True, False), torch.float32, v)
        log(f"  V={v} T={t:3d} C={c:3d} Co={co:3d} round_agg=1 and 0 on "
            f"integer "
            f"inputs: each equal to its plain version bit for bit in "
            f"bfloat16 (the two apart) and float32 (the two equal); two "
            f"calls bitwise equal")
    return rows


def phase_dx(torch, np, gcn_fused, v=25, iters=10, slow_iters=3):
    """The dx calls of a training step at batch 128 with V joints:
    gcn_fwd on (g, a1^T, W^T), the input and output channels swapped."""
    b = TRAIN_BATCH * PERSONS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for (t, c, co), mult in LAYER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            a1 = torch.softmax(torch.randn(b, 3, v, v, device="cuda",
                                           generator=gen), dim=-2)
            a1 = a1 + 0.2 * torch.rand(3, v, v, device="cuda",
                                       generator=gen)
            w = torch.randn(3, c, co, device="cuda",
                            generator=gen) / math.sqrt(3 * c)
            g = torch.randn(b, t, v, co, device="cuda", generator=gen)
            g, a1, w = g.to(dtype), a1.to(dtype), w.to(dtype)
            at = a1.transpose(2, 3).contiguous()
            wt = w.transpose(1, 2).contiguous()
            rows.append(_row(
                torch, lambda: gcn_fused.adaptive_gcn_pallas(g, at, wt),
                lambda: gcn_fused.gcn_fwd_plain(g, at, wt, True),
                g, at, wt, "dx", t, co, c, mult, dname, True, iters,
                slow_iters))
            del g, a1, w, at, wt
        for dtype in (torch.bfloat16, torch.float32):
            check_exact(torch, np, gcn_fused, b, t, co, c, "dx", (True,),
                        dtype, v)
        log(f"  dx V={v} T={t:3d} C={co:3d} Co={c:3d} bfloat16 and float32 "
            f"on "
            f"integer inputs: equal to the plain version bit for bit; two "
            f"calls bitwise equal")
    return rows


def _sums(rows, round_agg, dname):
    sel = [r for r in rows if r["round_agg"] == round_agg
           and r["dtype"] == dname]
    tot = lambda key: sum(r[key] * r["layers"] for r in sel)  # noqa: E731
    bound, by = bound_ms(tot("flops"), tot("bytes"), dname)
    return {"ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "library_ms": tot("library_ms"), "bound_ms": bound,
            "bound_by": by,
            "max_abs_err": max(r["max_abs_err"] for r in sel)}


def fwd_entry(rows, round_agg, dname, launches, name, replaces,
              dx_rows=None):
    """One `kernels` entry: per-forward totals over the ten layers at the
    served shapes, in `dname`; with `dx_rows`, the dx calls' per-step
    totals beside them under "dx"."""
    entry = {"name": name, "route": "cuda", "source": SOURCE,
             "replaces": replaces, "launches": launches,
             **_sums(rows, round_agg, dname), "dtype": dname,
             "per": "one served forward (10 layers, 32 samples, T=300)"}
    if dx_rows:
        entry["dx"] = dict(_sums(dx_rows, True, dname),
                           per="one training step (10 layers, 128 samples,"
                               " T=300)")
    return entry


def fp32_layers(rows, dx_rows):
    """The fp32 rows layer by layer, logged: served (round_agg=1 and 0)
    and dx kernel ms beside the einsum, the plain version and the bound;
    returns them as dicts."""
    out = []
    for r in rows:
        if r["dtype"] != "float32" or not r["round_agg"]:
            continue
        r0 = next(q for q in rows if q["dtype"] == "float32"
                  and not q["round_agg"] and (q["t"], q["c"], q["co"]) ==
                  (r["t"], r["c"], r["co"]))
        d = next(q for q in dx_rows if q["dtype"] == "float32"
                 and (q["t"], q["c"], q["co"]) == (r["t"], r["co"], r["c"]))
        bound = lambda q: max(q["flop_ms"], q["byte_ms"])  # noqa: E731
        row = dict(t=r["t"], c=r["c"], co=r["co"], layers=r["layers"],
                   ms=r["ms"], ms_round_agg0=r0["ms"],
                   library_ms=r["library_ms"], plain_ms=r["plain_ms"],
                   bound_ms=bound(r), dx_ms=d["ms"],
                   dx_library_ms=d["library_ms"], dx_plain_ms=d["plain_ms"],
                   dx_bound_ms=bound(d))
        out.append(row)
        log(f"  fp32 T={r['t']:3d} C={r['c']:3d} Co={r['co']:3d} "
            f"x{r['layers']}: served {row['ms']:.4f} / {row['ms_round_agg0']:.4f}"
            f" ms (round_agg 1 / 0), einsum {row['library_ms']:.4f}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f}; dx "
            f"{row['dx_ms']:.4f}, einsum {row['dx_library_ms']:.4f}, plain "
            f"{row['dx_plain_ms']:.4f}, bound {row['dx_bound_ms']:.4f}")
    return out


def _report(label, s):
    log(f"  {label}: {s['ms']:.3f} ms (plain {s['plain_ms']:.3f}, einsum "
        f"{s['library_ms']:.3f}, bound {s['bound_ms']:.3f} "
        f"{s['bound_by']})")


def main(argv=None) -> int:
    import numpy as np
    import torch

    from agcn_tpu_torch.ops.kernels import build, gcn_fused, gcn_kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--joints", type=int, nargs="+",
                    default=list(JOINTS_CHECKED + JOINTS_GENERAL),
                    help="V of the checks (any V >= 1)")
    args = ap.parse_args(argv)
    joints = tuple(args.joints)
    if not torch.cuda.is_available():
        print("fwd_check: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"{torch.cuda.get_device_name(0)}: {smi}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all(["gcn_fwd"])["gcn_fwd"]
    log(f"built gcn_fwd in {time.perf_counter() - t0:.1f} s")
    for ln in built.log.splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            log(f"  {ln.strip()}")
    fp32_build = report_fp32_build(built.log)
    rows, dx_rows = {}, {}
    try:
        spills = spilling(built.log)
        check(not spills, f"gcn_fwd kernels spill: {spills}")
        with torch.inference_mode():
            for v in joints:
                log(f"gcn_fwd vs its plain version at the served shapes "
                    f"(batch 32), V={v}")
                rows[v] = phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel,
                                            v)
                log(f"dx vs its plain version at the training shapes "
                    f"(batch 128), V={v}")
                dx_rows[v] = phase_dx(torch, np, gcn_fused, v)
    except SmokeFailure as e:
        print(f"fwd_check: FAILED: {e}", file=sys.stderr)
        return 1
    layers = {}
    for v in joints:
        log(f"fp32 per layer (ms), V={v}")
        layers[v] = fp32_layers(rows[v], dx_rows[v])
    sums = {}
    for v in joints:
        for dname in ("bfloat16", "float32"):
            for round_agg in (True, False):
                key = (f"V={v} served {dname} round_agg={int(round_agg)} "
                       f"per forward")
                sums[key] = _sums(rows[v], round_agg, dname)
                _report(key, sums[key])
            key = f"V={v} dx {dname} per training step"
            sums[key] = _sums(dx_rows[v], True, dname)
            _report(key, sums[key])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "ptxas": built.log,
                       "fp32_build": fp32_build,
                       "rows": [r for v in joints for r in rows[v]],
                       "dx_rows": [r for v in joints for r in dx_rows[v]],
                       "fp32_layers": layers,
                       "sums": sums},
                      f, indent=1)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
