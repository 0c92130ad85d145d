"""gcn_fwd on the card against its plain version, served and as dx.

    python -m agcn_tpu_torch.tools.fwd_check [--out FILE]

The quick card check of `ops/csrc/gcn_fwd.cu`, about a minute: it builds
that source alone (and fails if ptxas reports a spill in any
instantiation of `gcn_fwd_mma_kernel`), then

1. at each AGCN layer shape of the served batch (16 streams x 2 persons =
   32 samples, T=300), fp32 and bf16, both aggregate-rounding modes,
   holds the kernel against its plain version (`gcn_fwd_plain`) and times
   it beside its library yardstick (one `torch.einsum`) and its bound. At
   each shape, on bf16 integer inputs where the two modes differ, each
   mode must match its own plain version and fail the other's;
2. at each layer shape of a training step (batch 64 x 2 persons = 128
   samples) the dx call, gcn_fwd on (g, a1^T, W^T) with C and Co
   swapped, the same way (bf16 and fp32, round_agg=1);
3. on small-integer inputs, bf16 equal to the plain version bit for bit
   and two calls on the same inputs bitwise equal: both round_agg modes
   at every served shape (where the two modes' results must differ),
   round_agg=1 at every dx shape.

Last it prints the per-forward and per-step sums. `chip_smoke.py` phase 3
runs the same functions.

Which kernel serves which call (the C entry `agcn_gcn_fwd`): bf16 x and
a1 go to `gcn_fwd_mma_kernel` on the tensor cores, round_agg=1 (the
aggregate rounded to bf16, `gcn_fused`'s `_fwd_kernel`) as it is,
round_agg=0 (the aggregate kept in fp32, `gcn_kernel`'s `_kernel`) with
each aggregate split into two bf16 parts, hi + lo, both projected; fp32
calls, and bf16 x with fp32 a1, go to `gcn_fwd_kernel` on the CUDA
cores.

Tolerances (`bwd_check.within_tol`): fp32 (TF32 off) max err <= 1e-4 of
the output's scale; bf16 per element <= 2^-7 |ref| + 2^-10 of the scale.
Bit-exact inputs: x and a1 integers in [-8, 8], W in [-2, 2], all exact in
bf16. Every aggregate (|agg| <= 25 * 64 = 1,600) and every fp32 sum of
the projection (< 2^22) is an integer below 2^24, so it is exact in fp32
in any summation order; only the rounding points (the aggregate to bf16
with round_agg=1, y to bf16) decide the result. With round_agg=0 each
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
    LAYER_SHAPES, PEAK_BYTES, PEAK_FLOPS, PERSONS, SEED, TRAIN_BATCH,
    SmokeFailure, bound_ms, check, cuda_time_ms, gcn_work, log,
    nvidia_smi_line, within_tol)

SERVE_BATCH = 32  # 16 streams x 2 persons
SOURCE = "agcn_tpu_torch/ops/csrc/gcn_fwd.cu"


def spilling(ptxas_log, kernel="gcn_fwd_mma_kernel"):
    """The entry functions of `kernel` (a substring of the mangled name)
    for which `nvcc -Xptxas -v` reports spill stores or loads, each as
    (name, store bytes, load bytes)."""
    out, name = [], None
    for ln in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name and kernel in name and (int(m.group(1))
                                              or int(m.group(2))):
            out.append((name, int(m.group(1)), int(m.group(2))))
    return out


def library_fwd(torch, x, a1, w):
    """The function as one torch.einsum (the yardstick, used nowhere in
    the port)."""
    return torch.einsum("btvc,bkvw,kco->btwo", x, a1, w)


def exact_inputs(torch, np, b, t, c, co, seed):
    """bf16 x, a1 and W on the card, small integers: every sum of the
    kernel is exact in fp32 in any order (module docstring)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(
        "cuda", torch.bfloat16) for a in (
        rng.integers(-8, 9, (b, t, 25, c)),
        rng.integers(-8, 9, (b, 3, 25, 25)),
        rng.integers(-2, 3, (3, c, co))))


def check_exact(torch, np, gcn_fused, b, t, c, co, label, modes):
    """bf16 on integer inputs, in each round_agg mode of `modes`, equals
    the plain version bit for bit, and two calls are bitwise equal; with
    both modes, their results differ."""
    x, a1, w = exact_inputs(torch, np, b, t, c, co, SEED + 11)
    got = {}
    for r in modes:
        got[r] = gcn_fused.launch_gcn_fwd(x, a1, w, r)
        again = gcn_fused.launch_gcn_fwd(x, a1, w, r)
        torch.cuda.synchronize()
        want = gcn_fused.gcn_fwd_plain(x, a1, w, r)
        what = f"{label} T={t} C={c} Co={co} bf16 round_agg={int(r)}"
        check(torch.equal(got[r], again), f"{what}: two calls differ")
        check(torch.equal(got[r], want),
              f"{what}: integer inputs differ from the plain version "
              f"({(got[r] != want).sum().item()} elements, max "
              f"{(got[r].float() - want.float()).abs().max().item():.3e})")
    if len(got) == 2:
        check(not torch.equal(got[True], got[False]),
              f"{label} T={t} C={c} Co={co}: the round_agg modes agree on "
              f"integer inputs")


def check_rounding_modes(torch, np, wrappers, gcn_fused, b, t, c, co):
    """bf16 inputs on which the two rounding modes differ beyond the
    tolerance: x and a1 signed integers in [-64, 64], exact in bf16, whose
    aggregates (17 significant bits, exact in fp32 in any order) lose 9
    bits when rounded to bf16. Each mode must match the plain version of
    its own mode and fail the other's, so a kernel that ignored or
    inverted round_agg fails here."""
    rng = np.random.default_rng(SEED + 2)
    x, a1, w = (torch.from_numpy(a.astype(np.float32)).to(
        "cuda", torch.bfloat16) for a in (
        rng.integers(-64, 65, (b, t, 25, c)),
        rng.integers(-64, 65, (b, 3, 25, 25)),
        rng.standard_normal((3, c, co)) / np.sqrt(3 * c)))
    got = {r: wrappers[r](x, a1, w) for r in (True, False)}
    check(not torch.equal(got[True], got[False]),
          f"T={t} C={c} Co={co}: round_agg has no effect in bf16")
    for r in (True, False):
        own = within_tol(got[r], gcn_fused.gcn_fwd_plain(x, a1, w, r))
        other = within_tol(got[r], gcn_fused.gcn_fwd_plain(x, a1, w, not r))
        check(own[0] and not other[0],
              f"T={t} C={c} Co={co} round_agg={r}: max err {own[1]:.3e} "
              f"against its own mode, {other[1]:.3e} against the other "
              f"(tolerance must pass the first and fail the second)")
    return own[2]


def _row(torch, kernel, plain, x, a1, w, label, t, c, co, mult, dname,
         round_agg, iters, slow_iters):
    """Hold one call against its plain version and time it (`iters`
    calls; the plain version and the einsum `slow_iters`); returns the
    row."""
    b = x.shape[0]
    got = kernel()
    torch.cuda.synchronize()
    ok, err, scale = within_tol(got, plain())
    check(ok, f"{label} {dname} round_agg={round_agg} T={t} C={c} Co={co}: "
              f"max err {err:.3e} (scale {scale:.3e})")
    del got
    flops, nbytes = gcn_work(b, t, c, co, dname)
    row = dict(t=t, c=c, co=co, layers=mult, dtype=dname,
               round_agg=round_agg, max_abs_err=err, scale=scale,
               ms=cuda_time_ms(kernel, iters),
               plain_ms=cuda_time_ms(plain, slow_iters),
               library_ms=cuda_time_ms(lambda: library_fwd(torch, x, a1, w),
                                       slow_iters),
               flops=flops, bytes=nbytes,
               flop_ms=flops / PEAK_FLOPS[dname] * 1e3,
               byte_ms=nbytes / PEAK_BYTES * 1e3)
    log(f"  {label:7s} T={t:3d} C={c:3d} Co={co:3d} {dname:8s} "
        f"round_agg={int(round_agg)} err={err:.2e} kernel={row['ms']:.4f} "
        f"ms plain={row['plain_ms']:.4f} ms einsum={row['library_ms']:.4f} "
        f"ms bound={max(row['flop_ms'], row['byte_ms']):.4f} ms "
        f"({'ops' if row['flop_ms'] > row['byte_ms'] else 'bytes'})")
    return row


def phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel):
    """Each forward wrapper against its plain version at the served layer
    shapes (the wrappers' launch counts are reset before the main
    path)."""
    wrappers = {True: gcn_fused.adaptive_gcn_pallas,
                False: gcn_kernel.fused_gcn}
    b = SERVE_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    for (t, c, co), mult in LAYER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = torch.randn(b, t, 25, c, device="cuda", generator=gen)
            a1 = torch.softmax(torch.randn(b, 3, 25, 25, device="cuda",
                                           generator=gen), dim=-2)
            a1 = a1 + 0.2 * torch.rand(3, 25, 25, device="cuda",
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
                    20, 5))
            del x, a1, w
        scale = check_rounding_modes(torch, np, wrappers, gcn_fused, b, t,
                                     c, co)
        log(f"  T={t:3d} C={c:3d} Co={co:3d} bfloat16 integer inputs "
            f"(scale {scale:.3e}): each round_agg mode matches its own "
            f"plain version and fails the other's")
        check_exact(torch, np, gcn_fused, b, t, c, co, "served",
                    (True, False))
        log(f"  T={t:3d} C={c:3d} Co={co:3d} bfloat16 round_agg=1 and 0 on "
            f"integer inputs: each equal to its plain version bit for bit, "
            f"the two apart; two calls bitwise equal")
    return rows


def phase_dx(torch, np, gcn_fused):
    """The dx calls of a training step at batch 128: gcn_fwd on
    (g, a1^T, W^T), the input and output channels swapped."""
    b = TRAIN_BATCH * PERSONS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows = []
    for (t, c, co), mult in LAYER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            a1 = torch.softmax(torch.randn(b, 3, 25, 25, device="cuda",
                                           generator=gen), dim=-2)
            a1 = a1 + 0.2 * torch.rand(3, 25, 25, device="cuda",
                                       generator=gen)
            w = torch.randn(3, c, co, device="cuda",
                            generator=gen) / math.sqrt(3 * c)
            g = torch.randn(b, t, 25, co, device="cuda", generator=gen)
            g, a1, w = g.to(dtype), a1.to(dtype), w.to(dtype)
            at = a1.transpose(2, 3).contiguous()
            wt = w.transpose(1, 2).contiguous()
            rows.append(_row(
                torch, lambda: gcn_fused.adaptive_gcn_pallas(g, at, wt),
                lambda: gcn_fused.gcn_fwd_plain(g, at, wt, True),
                g, at, wt, "dx", t, co, c, mult, dname, True, 10, 3))
            del g, a1, w, at, wt
        check_exact(torch, np, gcn_fused, b, t, co, c, "dx", (True,))
        log(f"  dx T={t:3d} C={co:3d} Co={c:3d} bfloat16 on integer inputs: "
            f"equal to the plain version bit for bit; two calls bitwise "
            f"equal")
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
    args = ap.parse_args(argv)
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
    try:
        spills = spilling(built.log)
        check(not spills, f"gcn_fwd_mma_kernel spills: {spills}")
        with torch.inference_mode():
            log("gcn_fwd vs its plain version at the served shapes "
                "(batch 32)")
            rows = phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel)
            log("dx vs its plain version at the training shapes "
                "(batch 128)")
            dx_rows = phase_dx(torch, np, gcn_fused)
    except SmokeFailure as e:
        print(f"fwd_check: FAILED: {e}", file=sys.stderr)
        return 1
    sums = {}
    for dname in ("bfloat16", "float32"):
        for round_agg in (True, False):
            key = f"served {dname} round_agg={int(round_agg)} per forward"
            sums[key] = _sums(rows, round_agg, dname)
            _report(key, sums[key])
        key = f"dx {dname} per training step"
        sums[key] = _sums(dx_rows, True, dname)
        _report(key, sums[key])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "ptxas": built.log,
                       "rows": rows, "dx_rows": dx_rows, "sums": sums},
                      f, indent=1)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
