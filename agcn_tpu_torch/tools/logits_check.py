"""The attention-logits kernel on the card against its plain version.

    python -m agcn_tpu_torch.tools.logits_check [--out FILE] [--times-only]

The quick card check of `ops/csrc/logits.cu`, about a minute: it builds
that source alone and fails if ptxas reports a spill in any
instantiation of `logits_mma_kernel` (bf16, the tensor cores),
`logits_fp32_kernel` (fp32, the CUDA cores) or `logits_reduce_kernel`,
printing each one's registers and spills; then, at the ten layer shapes
of a served AAGCN forward (batch 32: 16 streams x 2 persons) and of a
training batch (128), fp32 and bf16, theta and phi as the strided views
of the fused (B, T, V, 2 K Ce) embedding that the models produce:

1. random inputs: within 1e-5 of the output's scale of the plain version
   (`attention_logits_plain`, the packed 128 x 128 product; fp32 sums of
   up to T Ce = 9,600 products in another order), two calls bitwise
   equal;
2. integer inputs in [-2, 2] (exact in bf16; every sum an integer below
   2^24, exact in fp32 in any order): with divisor 1 the kernel's sums
   equal the plain version's bit for bit, and with the layer's divisor
   its logits equal those sums each divided once (IEEE division, tensor
   by tensor). The plain version is not held bit for bit at the layer's
   divisor because on the card PyTorch divides a tensor by a Python
   number as a product with the fp32 reciprocal, one ulp off the
   quotient on some outputs;
3. each layer's row: kernel, plain and library (the models' 'transposed'
   form on the fp32 embedding: packing copies and one torch.matmul) in
   ms, the bound and the kernel's share of it, and the launch's plan
   (spans, chunk frames and width).

Last it prints the per-forward sums (ten layers) at batch 32 and 128 in
both dtypes. `chip_smoke.py` phase 5 runs the same functions.

Two times of the kernel: `ms`, CUDA events around calls made back to
back (`cuda_time_ms`, as every other kernel of chip_smoke is timed: what
a caller that calls it in a loop waits, the wrapper's host time
included), and `device_ms`, the same calls queued behind a sleep kernel
(`queued_time_ms`: the device's time alone), with the host's time a
call (`host_ms`). Where `ms` exceeds `device_ms`, the host holds the card
back. The plain and library times are `cuda_time_ms`.

`--times-only` skips the build's spill check, the plan and the integer
checks, and uses nothing of the kernel module but
`attention_logits_pallas` and `attention_logits_plain`: so the script,
run by its path with another checkout first on PYTHONPATH, times that
checkout's kernel the same way, e.g. for an A/B of two commits:

    PYTHONPATH=OTHER python3 agcn_tpu_torch/tools/logits_check.py --times-only
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from agcn_tpu_torch.tools.bwd_check import (
    PEAK_BYTES, PEAK_FLOPS, PERSONS, SEED, TRAIN_BATCH, SmokeFailure,
    bound_ms, check, cuda_time_ms, log, nvidia_smi_line)
from agcn_tpu_torch.tools.fwd_check import (SERVE_BATCH, ptxas_kernels,
                                            spilling)

SOURCE = "agcn_tpu_torch/ops/csrc/logits.cu"
# the kernels of logits.cu whose spills fail the build checks
SPILL_CHECKED = ("logits_mma_kernel", "logits_fp32_kernel",
                 "logits_reduce_kernel")
# (T, Ce) of the ten attention-logits calls of one AGCN / AAGCN forward
# (Ce = Co / 4; the stride-2 blocks shorten T after their GCN), with how
# many layers run each
LOGITS_SHAPES = [((300, 16), 4), ((300, 32), 1), ((150, 32), 2),
                 ((150, 64), 1), ((75, 64), 2)]
JOINTS, SUBSETS = 25, 3
# a sleep kernel of this many cycles (a few ms) holds the stream while
# the timed calls are queued
SLEEP_CYCLES = 10_000_000


def logits_work(b, t, ce, dname, v=JOINTS, k=SUBSETS):
    """(flops, bytes) one attention-logits call needs: theta and phi read
    once, the fp32 logits written once."""
    size = 4 if dname == "float32" else 2
    return (2 * b * k * v * v * t * ce,
            2 * b * t * v * k * ce * size + b * k * v * v * 4)


def logits_close(got, want):
    """(ok, max abs err, scale): the stated bar of the logits kernel,
    1e-5 of the output's scale (fp32 sums of up to T*Ce = 9,600 products
    in another order)."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    return err <= 1e-5 * scale, err, scale


def logits_spills(ptxas_log):
    """The logits.cu entry functions for which ptxas reports spills."""
    return spilling(ptxas_log, SPILL_CHECKED)


def report_build(ptxas_log):
    """Each logits.cu instantiation's registers and spills (ptxas),
    logged; returns them as dicts."""
    out = ptxas_kernels(ptxas_log, SPILL_CHECKED)
    for r in out:
        log(f"  {r['name']}: {r['registers']} registers, spill "
            f"{r['spill_stores']} / {r['spill_loads']} bytes")
    return out


def queued_time_ms(fn, iters, warmup=2):
    """(device ms a call, host ms a call) over `iters` calls queued behind
    a sleep kernel: the events time the device alone, back to back, as
    long as the host queues the calls within the sleep."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def embedding(torch, gen, b, t, ce, dtype, integers=False):
    """A fused (B, T, V, 2 K Ce) embedding on the card and its theta/phi
    views (B, T, V, K, Ce): normal, or integers in [-2, 2]."""
    shape = (b, t, JOINTS, 2 * SUBSETS * ce)
    if integers:
        emb = torch.randint(-2, 3, shape, device="cuda", generator=gen)
    else:
        emb = torch.randn(shape, device="cuda", generator=gen)
    emb = emb.to(dtype)
    e = emb.view(b, t, JOINTS, 2, SUBSETS, ce)
    return emb, e[..., 0, :, :], e[..., 1, :, :]


def check_exact(torch, logits_kernel, gen, b, t, ce, dtype, label):
    """Integer inputs: the kernel's sums equal the plain version's bit for
    bit, and its logits are those sums each divided once."""
    _, th, ph = embedding(torch, gen, b, t, ce, dtype, integers=True)
    sums = logits_kernel.attention_logits_pallas(th, ph, 1.0)
    want = logits_kernel.attention_logits_plain(th, ph, 1.0)
    check(torch.equal(sums, want),
          f"{label}: on integer inputs the sums differ from the plain "
          f"version's by {(sums - want).abs().max().item():.3e}")
    div = float(ce * t)
    got = logits_kernel.attention_logits_pallas(th, ph, div)
    check(torch.equal(got, sums / torch.full_like(sums, div)),
          f"{label}: the logits are not the sums divided once")


def phase_logits(torch, np, logits_kernel, times_only=False):
    """The attention-logits kernel against its plain version at the ten
    layer shapes of the served batch (32) and of the training batch
    (128), fp32 and bf16 inputs, theta/phi as the strided views of the
    fused embedding that the models produce; two calls bitwise equal;
    integer inputs bit for bit (not with `times_only`). Returns the
    rows."""
    from agcn_tpu_torch.ops import gcn as gcn_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    kernel = logits_kernel.attention_logits_pallas
    rows = []
    for b in (SERVE_BATCH, TRAIN_BATCH * PERSONS):
        for (t, ce), mult in LOGITS_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                label = f"logits B={b} T={t} Ce={ce} {dname}"
                emb, th, ph = embedding(torch, gen, b, t, ce, dtype)
                div = ce * t
                got = kernel(th, ph, div)
                again = kernel(th, ph, div)
                torch.cuda.synchronize()
                check(torch.equal(got, again), f"{label}: two calls differ")
                want = logits_kernel.attention_logits_plain(th, ph, div)
                ok, err, scale = logits_close(got, want)
                check(ok, f"{label}: max err {err:.3e} (scale "
                          f"{scale:.3e})")
                if not times_only:
                    check_exact(torch, logits_kernel, gen, b, t, ce, dtype,
                                label)
                flops, nbytes = logits_work(b, t, ce, dname)
                bound, by = bound_ms(flops, nbytes, dname)
                emb32 = emb.float()
                device_ms, host_ms = queued_time_ms(
                    lambda: kernel(th, ph, div), 20)
                row = dict(
                    b=b, t=t, ce=ce, layers=mult, dtype=dname,
                    max_abs_err=err, scale=scale,
                    ms=cuda_time_ms(lambda: kernel(th, ph, div), 20),
                    device_ms=device_ms, host_ms=host_ms,
                    plain_ms=cuda_time_ms(
                        lambda: logits_kernel.attention_logits_plain(
                            th, ph, div), 5),
                    # the yardstick: ops.gcn.attention_logits 'transposed'
                    # (the (T, Ce) packing copies and one torch.matmul) on
                    # the fp32 embedding
                    library_ms=cuda_time_ms(
                        lambda: gcn_ops.attention_logits(
                            emb32, SUBSETS, ce, "transposed"), 5),
                    flops=flops, bytes=nbytes, bound_ms=bound, bound_by=by,
                    flop_ms=flops / PEAK_FLOPS[dname] * 1e3,
                    byte_ms=nbytes / PEAK_BYTES * 1e3)
                plan = ""
                if not times_only:
                    p = logits_kernel.launch_plan(b, t, SUBSETS, ce, dtype)
                    row.update(spans=p["spans"], frames=p["frames"],
                               width=p["width"])
                    plan = (f"; {p['spans']} spans x {p['span_chunks']} "
                            f"chunks of {p['frames']} frames ({p['width']} "
                            f"columns)")
                rows.append(row)
                log(f"  {label:32s} err/scale={err / scale:.2e} "
                    f"kernel={row['ms']:.4f} ms ({100 * bound / row['ms']:.1f}"
                    f"% of bound), device={device_ms:.4f} ms ("
                    f"{100 * bound / device_ms:.1f}%), host={host_ms:.4f} "
                    f"ms/call plain={row['plain_ms']:.4f} transposed-matmul"
                    f"={row['library_ms']:.4f} bound={bound:.4f} ({by})"
                    + plan)
                del emb, emb32, th, ph, got, again, want
    return rows


def logits_sums(rows, b, dname):
    """The ten layers' sums at batch `b` in `dname`: kernel (back to back
    and device alone), plain and library ms, the bound (summed flops or
    bytes, the larger) and the worst error."""
    sel = [r for r in rows if r["dtype"] == dname and r["b"] == b]
    tot = lambda key: sum(r[key] * r["layers"] for r in sel)  # noqa: E731
    bound, by = bound_ms(tot("flops"), tot("bytes"), dname)
    return {"ms": tot("ms"), "device_ms": tot("device_ms"),
            "plain_ms": tot("plain_ms"), "library_ms": tot("library_ms"),
            "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(r["max_abs_err"] for r in sel)}


def logits_entry(rows, launches, dname="bfloat16"):
    """The `kernels` entry of the logits kernel: per served forward, the
    sum over the ten layers at batch 32 in `dname`; the error, the worst
    of every row (both batches, both dtypes)."""
    return {"name": "attention logits", "route": "cuda", "source": SOURCE,
            "replaces": "agcn_tpu/ops/pallas/logits_kernel.py:30",
            "launches": launches, **logits_sums(rows, SERVE_BATCH, dname),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "dtype": dname,
            "library_call": "ops.gcn.attention_logits(emb_fp32, 3, Ce, "
                            "'transposed') (torch.matmul)",
            "per": "one served forward (10 layers, 32 samples, T=300)"}


def report_sums(rows):
    """The per-forward sums at both batches in both dtypes, logged;
    returns them keyed by label."""
    out = {}
    for b in (SERVE_BATCH, TRAIN_BATCH * PERSONS):
        for dname in ("bfloat16", "float32"):
            s = logits_sums(rows, b, dname)
            key = f"B={b} {dname} per ten layers"
            out[key] = s
            share = 100 * s["bound_ms"] / s["ms"]
            log(f"  {key}: {s['ms']:.4f} ms ({share:.1f}% of the bound "
                f"{s['bound_ms']:.4f}, {s['bound_by']}), device alone "
                f"{s['device_ms']:.4f} ms ("
                f"{100 * s['bound_ms'] / s['device_ms']:.1f}%), plain "
                f"{s['plain_ms']:.4f}, transposed-matmul "
                f"{s['library_ms']:.4f}")
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    from agcn_tpu_torch.ops.kernels import build, logits_kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    ap.add_argument("--times-only", action="store_true",
                    help="time and hold against the plain version only "
                         "(for another checkout's kernel)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("logits_check: no CUDA GPU available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"{torch.cuda.get_device_name(0)}: {smi}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all(["logits"])["logits"]
    log(f"built logits in {time.perf_counter() - t0:.1f} s")
    ptxas = [] if args.times_only else report_build(built.log)
    log("attention logits vs the plain version at the served (32) and "
        "training (128) batch shapes")
    try:
        spills = [] if args.times_only else logits_spills(built.log)
        check(not spills, f"logits kernels spill: {spills}")
        with torch.inference_mode():
            rows = phase_logits(torch, np, logits_kernel, args.times_only)
    except SmokeFailure as e:
        print(f"logits_check: FAILED: {e}", file=sys.stderr)
        return 1
    log("per ten layers")
    sums = report_sums(rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "ptxas": built.log,
                       "build": ptxas, "rows": rows, "sums": sums}, f,
                      indent=1)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
