"""gcn_bwd on the card against its plain version, dW and da1 timed apart.

    python -m agcn_tpu_torch.tools.bwd_check [--out FILE]

The quick card check of `ops/csrc/gcn_bwd.cu`, about a minute: it builds
that source alone, then at each AGCN layer shape of a training step
(batch 64 x 2 persons = 128 samples, T=300), fp32 and bf16, holds
gcn_bwd against its plain version (`gcn_bwd_plain`) and two calls against
each other (bitwise), times dW and da1 apart, each beside its library
yardstick (the einsums of `ops.gcn.adaptive_gcn_bwd`) and its bound, and
on bf16 integer inputs holds the kernel bit for bit against the plain
version while dropping the rounding of u or of p changes the result.
Last it prints the per-step sums (ten layers). `chip_smoke.py` phase 4
runs the same functions; the dx calls (gcn_fwd on g, a1^T, W^T) are
`fwd_check.py`'s.

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


def gcn_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) one gcn_fwd call needs: each input read once, the
    output written once."""
    size = 4 if dtype_name == "float32" else 2
    flops = 2 * b * t * k * v * c * (v + co)
    nbytes = (b * t * v * (c + co) + b * k * v * v + k * c * co) * size
    return flops, nbytes


def gcn_bwd_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) one gcn_bwd call needs: x, g, a1 and W read once,
    dW and da1 written once; u = g a1^T and p = x W are formed and used
    (2 K B T V Co (V + C) flops each way)."""
    size = 4 if dtype_name == "float32" else 2
    flops = 4 * k * b * t * v * co * (v + c)
    nbytes = (b * t * v * (c + co) + 2 * (b * k * v * v + k * c * co)) * size
    return flops, nbytes


def gcn_bwd_half_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) of dW alone, which are also those of da1 alone:
    x and g read once, a1 and W (one of them) read once, the gradient
    written once; u (p) formed, 2 K B T V V Co flops, and contracted with
    x (g), 2 K B T V C Co."""
    size = 4 if dtype_name == "float32" else 2
    flops = 2 * k * b * t * v * co * (v + c)
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
                dw_library_ms=cuda_time_ms(
                    lambda: library_dw(torch, x, a1, g), 3),
                da1_library_ms=cuda_time_ms(
                    lambda: library_da1(torch, x, w, g), 3),
                half_bound_ms=half[0],  # of dW alone, and of da1 alone
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
            log(f"          dW  {row['dw_ms']:.4f} ms (einsums "
                f"{row['dw_library_ms']:.4f}, bound {half[0]:.4f} {half[1]})"
                f"; da1 {row['da1_ms']:.4f} ms (einsums "
                f"{row['da1_library_ms']:.4f}, bound {half[0]:.4f} "
                f"{half[1]})")
            del x, a1, w, g
        if c >= 8:
            # at C=3, p = x W has too few bits for its rounding to show
            check_bwd_rounding(torch, np, gcn_fused, c, co)
            log(f"  gcn_bwd C={c:3d} Co={co:3d} bfloat16 integer inputs: "
                f"equal to the plain version; without the rounding of u or "
                f"p the result differs")
    return rows


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
                 "bound_ms": half[0], "bound_by": half[1],
                 "max_abs_err": max(r[f"err_{p}"] for r in rows)}
             for p in ("dw", "da1")}
    return {"name": "gcn_bwd (dW, da1)", "route": "cuda", "source": SOURCE,
            "replaces": "agcn_tpu/ops/pallas/gcn_fused.py:72",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
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
    log("gcn_bwd vs its plain version at the training shapes (batch 128)")
    try:
        with torch.inference_mode():
            rows = phase_bwd_kernels(torch, np, gcn_fused)
    except SmokeFailure as e:
        print(f"bwd_check: FAILED: {e}", file=sys.stderr)
        return 1
    entries = [bwd_entry(rows, 0, d) for d in ("float32", "bfloat16")]
    for e in entries:
        log(f"per step ({e['dtype']}): gcn_bwd {e['ms']:.3f} ms (plain "
            f"{e['plain_ms']:.3f}, einsums {e['library_ms']:.3f}, bound "
            f"{e['bound_ms']:.3f} {e['bound_by']}); "
            + "; ".join(f"{p} {e[p]['ms']:.3f} ms (einsums "
                        f"{e[p]['library_ms']:.3f}, bound "
                        f"{e[p]['bound_ms']:.3f} {e[p]['bound_by']})"
                        for p in ("dw", "da1")))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": torch.cuda.get_device_name(0),
                       "nvidia_smi": smi, "rows": rows, "per_step": entries},
                      f, indent=1)
    log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
