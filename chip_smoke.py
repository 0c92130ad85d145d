#!/usr/bin/env python
"""Smoke run of the PyTorch port (agcn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port builds and serves on the card. Phases,
each of which fails the run (exit code 1, no result line) when it fails:

1. environment: a CUDA GPU is required; prints its name and power limit.
2. build: compiles every CUDA source of the port with nvcc (sm_90a), all
   started together, and prints the build time and ptxas' report.
3. kernels against their plain versions, on the card, at every AGCN
   layer shape of the served batch (16 streams x 2 persons = 32 samples),
   fp32 and bf16, both aggregate-rounding modes; prints max error, kernel
   / plain / library time and the roofline bound. At each shape, on bf16
   integer inputs where the two modes differ, each mode must match its
   own plain version and fail the other's.
4. main path: the NTU-60 AGCN of configs/ntu60_xview/test_joint.yaml with
   `formulation: pallas`, full width, T=300, seeded random weights,
   serving 16 live streams through BatchedStreamServer (predict, then
   predict_async + flush) in fp32 and bf16, and one tick with
   `use_pallas=True`; the kernels' launch counts must equal
   layers x forwards; the card's logits are held against the same model
   and weights run with device="cpu" (the plain versions).
5. device time of one served forward by kernel group (torch.profiler),
   on the main path's models and input, with the card's busy share.
6. the CLI: `python -m agcn_tpu_torch.infer --serve 16 --pipeline` on
   recordings written to a temporary directory.

The last lines of standard output are the `kernels` JSON line, the
card's `nvidia-smi` name and power limit, and
{"ok": true, "device": {...}}. Details go to build/chip_smoke.json.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "ntu60_xview", "test_joint.yaml")
STREAMS = 16
PERSONS = 2
SEQ = 300
TICK_FRAMES = 10
SEED = 0
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
SOURCE = "agcn_tpu_torch/ops/csrc/gcn_fwd.cu"


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


def gcn_work(b, t, c, co, dtype_name, v=25, k=3):
    """(flops, bytes) one gcn_fwd call needs: each input read once, the
    output written once."""
    size = 4 if dtype_name == "float32" else 2
    flops = 2 * b * t * k * v * c * (v + co)
    nbytes = (b * t * v * (c + co) + b * k * v * v + k * c * co) * size
    return flops, nbytes


def within_tol(got, want):
    """(ok, max abs err, output scale) of a kernel output against its
    plain version, at the tolerance stated in phase 3's header."""
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


def phase_kernels(torch, np, gcn_fused, gcn_kernel):
    """Each kernel wrapper against its plain version at the served layer
    shapes (the wrappers' launch counts are reset before the main
    path)."""
    wrappers = {True: gcn_fused.adaptive_gcn_pallas,
                False: gcn_kernel.fused_gcn}
    b = STREAMS * PERSONS
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
            flops, nbytes = gcn_work(b, t, c, co, dname)
            for round_agg in (True, False):
                kernel = wrappers[round_agg]
                got = kernel(x, a1, w)
                torch.cuda.synchronize()
                want = gcn_fused.gcn_fwd_plain(x, a1, w, round_agg)
                ok, err, scale = within_tol(got, want)
                check(ok, f"gcn_fwd {dname} round_agg={round_agg} "
                          f"T={t} C={c} Co={co}: max err "
                          f"{err:.3e} (scale {scale:.3e})")
                ms = cuda_time_ms(lambda: kernel(x, a1, w), 20)
                plain_ms = cuda_time_ms(
                    lambda: gcn_fused.gcn_fwd_plain(x, a1, w, round_agg), 5)
                lib_ms = cuda_time_ms(
                    lambda: torch.einsum("btvc,bkvw,kco->btwo", x, a1, w),
                    5)
                row = dict(t=t, c=c, co=co, layers=mult, dtype=dname,
                           round_agg=round_agg,
                           max_abs_err=err, scale=scale,
                           ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           flops=flops, bytes=nbytes,
                           flop_ms=flops / PEAK_FLOPS[dname] * 1e3,
                           byte_ms=nbytes / PEAK_BYTES * 1e3)
                rows.append(row)
                log(f"  T={t:3d} C={c:3d} Co={co:3d} {dname:8s} "
                    f"round_agg={int(round_agg)} err={row['max_abs_err']:.2e}"
                    f" kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
                    f"einsum={lib_ms:.4f} ms bound="
                    f"{max(row['flop_ms'], row['byte_ms']):.4f} ms "
                    f"({'ops' if row['flop_ms'] > row['byte_ms'] else 'bytes'})")
            del x, a1, w
        scale = check_rounding_modes(torch, np, wrappers, gcn_fused, b, t,
                                     c, co)
        log(f"  T={t:3d} C={c:3d} Co={co:3d} bfloat16 integer inputs "
            f"(scale {scale:.3e}): each round_agg mode matches its own "
            f"plain version and fails the other's")
    return rows


def kernel_entry(rows, round_agg, dname, launches, name, replaces):
    """One `kernels` entry: per-forward totals over the ten layers at
    the served shapes, in `dname`."""
    sel = [r for r in rows if r["round_agg"] == round_agg
           and r["dtype"] == dname]
    tot = lambda key: sum(r[key] * r["layers"] for r in sel)  # noqa: E731
    flop_ms = tot("flops") / PEAK_FLOPS[dname] * 1e3
    byte_ms = tot("bytes") / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["round_agg"] == round_agg),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms > byte_ms else "bytes",
            "library_ms": tot("library_ms"), "dtype": dname,
            "per": "one served forward (10 layers, 32 samples, T=300)"}


def make_streams(np):
    """Seeded synthetic skeleton streams: (S, frames, M, 1, V, C)."""
    rng = np.random.default_rng(SEED)
    frames = SEQ + 12 * TICK_FRAMES
    base = rng.standard_normal((STREAMS, 1, PERSONS, 1, 25, 3)) * 0.3
    base[:, :, 1] += np.array([1.0, 0.0, 0.5])  # second body beside
    phase = rng.uniform(0, 2 * np.pi, (STREAMS, 1, PERSONS, 1, 25, 3))
    tt = np.arange(frames)[None, :, None, None, None, None]
    motion = 0.1 * np.sin(tt * 0.15 + phase)
    noise = rng.standard_normal((STREAMS, frames, PERSONS, 1, 25, 3)) * 0.01
    return (base + motion + noise).astype(np.float32)


def randomize_eval_state(torch, model, seed):
    """Seeded BN statistics/affines and PA, so every layer's output
    (the GCN's too — its BN starts at scale 1e-6) reaches the logits."""
    from agcn_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
        for name, p in model.named_parameters():
            if name.endswith(".PA"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.01)


def serve_ticks(server, seq, start, ticks, pipelined):
    """Feed TICK_FRAMES frames per stream and tick; returns the answers
    of every tick, the wall time of the ticks and the mean host prep."""
    answers = []
    prep_ms = 0.0
    t0 = time.perf_counter()
    for i in range(ticks):
        lo = start + i * TICK_FRAMES
        for sid in range(STREAMS):
            for f in seq[sid, lo:lo + TICK_FRAMES]:
                server.append_frame(sid, f)
        r = server.predict_async() if pipelined else server.predict()
        prep_ms += server.last_prep_ms
        if r is not None:
            answers.append(r)
    if pipelined:
        answers.append(server.flush())
    return answers, time.perf_counter() - t0, prep_ms / ticks


def check_answers(np, answers, num_class):
    for res in answers:
        check(res is not None and sorted(res) == list(range(STREAMS)),
              "a tick did not answer every stream")
        for label, probs in res.values():
            check(probs.shape == (num_class,) and np.isfinite(probs).all()
                  and abs(probs.sum() - 1.0) < 1e-4
                  and 0 <= label < num_class, "malformed answer")


def phase_main_path(torch, np, summary):
    from agcn_tpu_torch.infer.preprocess import InferencePreprocessor
    from agcn_tpu_torch.infer.serving import BatchedStreamServer
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    args = dict(cfg.model_args, formulation="pallas")
    num_class = args["num_class"]
    seq = make_streams(np)
    models = {}
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.model, args, device="cuda",
                        dtype=getattr(torch, dname),
                        generator=torch.Generator().manual_seed(SEED))
        randomize_eval_state(torch, m, SEED + 1)
        models[dname] = m.eval()
    state = models["float32"].state_dict()
    up = build_model(cfg.model, dict(args, use_pallas=True), device="cuda")
    up.load_state_dict(state, strict=True)
    up.eval()

    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    forwards = {"pallas": 0, "use_pallas": 0}
    x_check = None
    card_logits = {}
    for dname, model in models.items():
        server = BatchedStreamServer(model, max_streams=STREAMS,
                                     max_seq_length=SEQ)
        shadows = []
        for sid in range(STREAMS):
            check(server.add_stream() == sid, "stream ids")
            shadows.append(InferencePreprocessor(max_seq_length=SEQ))
        for i in range(SEQ):
            for sid in range(STREAMS):
                server.append_frame(sid, seq[sid, i])
                shadows[sid].append(seq[sid, i])
        # warm-up tick (cuDNN, kernel attributes), not timed
        warm, _, _ = serve_ticks(server, seq, SEQ, 1, False)
        sync, sync_s, sync_prep = serve_ticks(server, seq,
                                              SEQ + TICK_FRAMES, 4, False)
        pipe, pipe_s, pipe_prep = serve_ticks(
            server, seq, SEQ + 5 * TICK_FRAMES, 4, True)
        forwards["pallas"] += 1 + 4 + 4
        check_answers(np, warm + sync + pipe, num_class)
        check(len(pipe) == 4, "pipelined ticks lost")
        # the same input as the last tick, through the model directly
        for sid in range(STREAMS):
            for f in seq[sid, SEQ:SEQ + 9 * TICK_FRAMES]:
                shadows[sid].append(f)
        x_check = np.concatenate([s.dense_input() for s in shadows])
        with torch.inference_mode():
            logits = model(torch.from_numpy(x_check).cuda()).float().cpu()
        forwards["pallas"] += 1
        card_logits[dname] = logits.numpy()
        probs = torch.softmax(logits, -1).numpy()
        last = pipe[-1]
        served = np.stack([last[sid][1] for sid in range(STREAMS)])
        perr = float(np.abs(served - probs).max())
        check(perr < 1e-4, f"{dname}: served probabilities differ from "
                           f"the model's on the same input by {perr:.2e}")
        tick_ms = {"sync": sync_s / 4 * 1e3, "pipelined": pipe_s / 4 * 1e3}
        prep_ms = {"sync": sync_prep, "pipelined": pipe_prep}
        summary[f"serve_{dname}"] = dict(
            tick_ms=tick_ms, prep_ms=prep_ms,
            preds_per_s={k: STREAMS / (v / 1e3) for k, v in tick_ms.items()})
        log(f"  {dname}: {STREAMS} streams, tick {tick_ms['sync']:.2f} ms "
            f"sync / {tick_ms['pipelined']:.2f} ms pipelined -> "
            f"{STREAMS / tick_ms['sync'] * 1e3:.1f} / "
            f"{STREAMS / tick_ms['pipelined'] * 1e3:.1f} preds/s "
            f"(mean host prep {sync_prep:.2f} / {pipe_prep:.2f} ms)")

    # one served tick with use_pallas=True (the gcn_kernel entry)
    server = BatchedStreamServer(up, max_streams=STREAMS, max_seq_length=SEQ)
    for sid in range(STREAMS):
        server.add_stream()
    for i in range(SEQ + 9 * TICK_FRAMES):
        for sid in range(STREAMS):
            server.append_frame(sid, seq[sid, i])
    up_ans = server.predict()
    forwards["use_pallas"] += 1
    check_answers(np, [up_ans], num_class)
    up_probs = np.stack([up_ans[sid][1] for sid in range(STREAMS)])
    ref_probs = torch.softmax(torch.from_numpy(card_logits["float32"]),
                              -1).numpy()
    uerr = float(np.abs(up_probs - ref_probs).max())
    check(uerr < 1e-4, f"use_pallas tick differs from the pallas "
                       f"formulation by {uerr:.2e} in probability")

    launches = {"adaptive_gcn_pallas": gcn_fused.adaptive_gcn_pallas.launches,
                "fused_gcn": gcn_kernel.fused_gcn.launches}
    log(f"  launches {launches} for forwards {forwards}")
    check(launches["adaptive_gcn_pallas"] == LAYERS * forwards["pallas"]
          and launches["fused_gcn"] == LAYERS * forwards["use_pallas"],
          f"launch counts {launches} != {LAYERS} layers x {forwards}")

    # the same weights and input through the plain versions on the CPU
    torch.set_num_threads(os.cpu_count() or 1)
    cpu = build_model(cfg.model, args, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in state.items()}, strict=True)
    cpu.eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(x_check)).numpy()
    cpu_s = time.perf_counter() - t0
    scale = float(np.abs(ref).max())
    errs = {d: float(np.abs(card_logits[d] - ref).max())
            for d in card_logits}
    top1 = {d: float((card_logits[d].argmax(-1) == ref.argmax(-1)).mean())
            for d in card_logits}
    log(f"  card vs cpu logits: max err {errs} (logit scale {scale:.3f}), "
        f"top-1 agreement {top1}, cpu forward {cpu_s:.1f} s")
    # fp32 (TF32 off): another summation order through ten layers;
    # bf16: ~3 significant digits per activation through ten layers
    check(errs["float32"] <= 1e-3 * max(scale, 1.0),
          f"fp32 card logits off the CPU reference by {errs['float32']:.3e}")
    check(errs["bfloat16"] <= 5e-2 * max(scale, 1.0),
          f"bf16 card logits off the CPU reference by {errs['bfloat16']:.3e}")
    summary.update(launches=launches, forwards=forwards,
                   card_vs_cpu_logit_err=errs, logit_scale=scale,
                   top1_agreement=top1)
    return launches, state, args, models, x_check


# kernel-name substrings -> group of the device-time breakdown, first
# match wins
KERNEL_GROUPS = (
    ("gcn_fwd_kernel", "gcn_fwd (the port's CUDA kernel)"),
    ("conv", "cuDNN convolution"), ("cudnn", "cuDNN convolution"),
    # cuDNN's FFT convolution algorithms (fp32 with TF32 off)
    ("fft", "cuDNN convolution"),
    ("pointwise_mult_and_sum_complex", "cuDNN convolution"),
    ("gemm", "GEMM (cuBLAS)"), ("sm90_xmma", "GEMM (cuBLAS)"),
    ("cutlass", "GEMM (cuBLAS)"), ("softmax", "softmax"),
    ("reduce", "reductions"), ("elementwise", "elementwise"),
    ("copy", "copies / layout"), ("Memcpy", "memcpy"))


def kernel_group(name):
    low = name.lower()
    for key, group in KERNEL_GROUPS:
        if key.lower() in low:
            return group
    return "other"


def phase_profile(torch, models, x_np, summary, iters=5):
    """Device time of one served forward by kernel group, under
    torch.profiler, on the main path's models and its last served input;
    the wall time per forward is taken with the profiler off."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(x_np).cuda()
    for dname, model in models.items():
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / iters
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    model(x)
                torch.cuda.synchronize()
        groups = {}
        for ev in prof.events():
            # device-side activities only: an aten op's own device time
            # repeats its kernels'
            if ev.device_type == DeviceType.CUDA:
                g = kernel_group(ev.name)
                groups[g] = groups.get(g, 0.0) + (
                    ev.device_time_total / 1e3 / iters)
        device_ms = sum(groups.values())
        check(device_ms > 0, f"{dname}: the profiler saw no device time")
        log(f"  {dname}: wall {wall_ms:.3f} ms per forward (profiler off), "
            f"device {device_ms:.3f} ms under the profiler (busy "
            f"{100 * device_ms / wall_ms:.1f}%)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {ms:9.3f} ms {100 * ms / device_ms:5.1f}%  {g}")
        summary[f"profile_{dname}"] = dict(wall_ms=wall_ms,
                                           device_ms=device_ms,
                                           groups=groups)


def phase_cli(torch, np, state, args):
    import yaml

    from agcn_tpu_torch.infer import cli
    from agcn_tpu_torch.ops.kernels import gcn_fused

    seq = make_streams(np)[:, :4 * TICK_FRAMES]  # 4 ticks per stream
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "recordings")
        os.makedirs(rec)
        for sid in range(STREAMS):
            # (C, T, V, M) recordings
            arr = np.transpose(seq[sid, :, :, 0], (3, 0, 2, 1))
            np.save(os.path.join(rec, f"cam{sid:02d}.npy"), arr)
        weights = os.path.join(tmp, "agcn.pt")
        torch.save({k: v.cpu() for k, v in state.items()}, weights)
        cfg_path = os.path.join(tmp, "serve.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"model": "agcn", "model_args": args}, f)
        gcn_fused.adaptive_gcn_pallas.launches = 0
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["--config", cfg_path, "--weights", weights,
                      "--input", rec, "--serve", str(STREAMS), "--pipeline",
                      "--timing", "--interval", str(TICK_FRAMES)])
        launches = gcn_fused.adaptive_gcn_pallas.launches
    lines = out.getvalue().splitlines()
    answers = [ln for ln in lines if ln.startswith("[cam")]
    ticks = [ln for ln in lines if ln.startswith("tick:")]
    log(f"  cli: {len(answers)} answers, {len(ticks)} ticks, "
        f"{launches} launches; last: {ticks[-1] if ticks else None}")
    check(len(answers) == STREAMS * 4 and launches == LAYERS * 4,
          f"cli served {len(answers)} answers with {launches} launches")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import numpy as np

        from agcn_tpu_torch.ops.kernels import build, gcn_fused, gcn_kernel
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from a checkout of the repository", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {}
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1/6] {kind}: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[2/6] built {sorted(built)} in {build_s:.1f} s")
    for res in built.values():
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"  {ln.strip()}")
    summary["build_s"] = build_s

    log("[3/6] gcn_fwd kernel vs plain version. Tolerances: fp32 (TF32 "
        "off) max err <= 1e-4 x output scale (another summation order "
        "over up to 19,200 products); bf16 per element <= 2^-7 |ref| + "
        "2^-10 x scale (loose: one bf16 rounding of each output may land "
        "one ulp apart), yet tight enough that each round_agg mode fails "
        "the other mode's plain version on integer inputs")
    with torch.inference_mode():
        rows = phase_kernels(torch, np, gcn_fused, gcn_kernel)
    summary["kernel_rows"] = rows

    log("[4/6] main path: 16 streams through BatchedStreamServer")
    launches, state, args, models, x_check = phase_main_path(torch, np,
                                                             summary)

    log("[5/6] device time of one served forward by kernel group")
    phase_profile(torch, models, x_check, summary)
    del models

    log("[6/6] CLI: python -m agcn_tpu_torch.infer --serve 16 --pipeline")
    summary["cli_launches"] = phase_cli(torch, np, state, args)

    kernels = [
        kernel_entry(rows, True, "bfloat16",
                     launches["adaptive_gcn_pallas"],
                     "gcn_fwd (aggregate rounded to x's type)",
                     "agcn_tpu/ops/pallas/gcn_fused.py:52"),
        kernel_entry(rows, False, "bfloat16", launches["fused_gcn"],
                     "gcn_fwd (fp32 aggregate)",
                     "agcn_tpu/ops/pallas/gcn_kernel.py:27"),
    ]
    summary.update(kernels=kernels, device=kind, nvidia_smi=smi)
    out_dir = os.path.join(REPO, "build")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
