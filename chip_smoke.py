#!/usr/bin/env python
"""Smoke run of the PyTorch port (agcn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

The quickest proof that the port builds, serves and trains on the card.
Phases, each of which fails the run (exit code 1, no result line) when it
fails:

1. environment: a CUDA GPU is required; prints its name and power limit.
2. build: compiles every CUDA source of the port with nvcc (sm_90a), all
   started together, and prints the build time and ptxas' report.
3. gcn_fwd against its plain version, on the card, at every AGCN layer
   shape of the served batch (16 streams x 2 persons = 32 samples), fp32
   and bf16, both aggregate-rounding modes, and as dx (gcn_fwd on g,
   a1^T, W^T) at the training batch (64 x 2 persons = 128 samples);
   prints max error, kernel / plain / library time and the roofline
   bound. At each served shape, on bf16 integer inputs where the two
   modes differ, each mode must match its own plain version and fail the
   other's; at every shape the bf16 round_agg=1 path (the tensor cores)
   equals its plain version bit for bit on small-integer inputs, and two
   calls are bitwise equal. The code is
   agcn_tpu_torch/tools/fwd_check.py, which runs it alone in about a
   minute: `python -m agcn_tpu_torch.tools.fwd_check`.
4. gcn_bwd (dW, da1) at the training batch, fp32 and bf16, against its
   plain version at every layer shape, two calls bitwise equal, and on
   bf16 integer inputs equal to the plain version while dropping either
   rounding point changes the result. Prints kernel / plain / library
   (the einsum backward) time and the bound, dW and da1 apart. The code
   is agcn_tpu_torch/tools/bwd_check.py, which runs it alone in about a
   minute: `python -m agcn_tpu_torch.tools.bwd_check`.
5. the attention-logits kernel against its plain version (the packed
   128 x 128 formulation) at the ten layer shapes of the served (32) and
   training (128) batches, fp32 and bf16, theta/phi as views of the
   fused embedding: 1e-5 of the output scale, two calls bitwise equal;
   kernel / plain / library (the 'transposed' form's torch.matmul in
   fp32) time and the bound.
6. AGCN serving main path: the NTU-60 AGCN of configs/ntu60_xview/
   test_joint.yaml with `formulation: pallas`, full width, T=300, seeded
   random weights, serving 16 live streams through BatchedStreamServer
   (predict, then predict_async + flush) in fp32 and bf16, and one tick
   with `use_pallas=True`; the kernels' launch counts must equal layers x
   forwards; the card's logits are held against the same model and
   weights run with device="cpu" (the plain versions).
7. AGCN: device time of one served forward by kernel group
   (torch.profiler); the serving CLI `python -m agcn_tpu_torch.infer
   --serve 16 --pipeline` on recordings written to a temporary directory.
8. AGCN training main path, configs/ntu60_xview/train_joint.yaml with
   `formulation: pallas`, full width, T=300: one step at batch 4 on the
   card against the same step with the kernels' plain versions on the
   card and against device="cpu" (fp32, TF32 off, the card replaying
   the CPU's ReLU masks: every gradient 1e-3 of its scale, loss 1e-4
   relative; bf16 loss 5e-2); 10 bf16 steps
   at batch 64 on one repeated batch, whose loss must fall, with exactly
   20 gcn_fwd and 10 gcn_bwd launches per step; ms per step, seq/s and
   peak memory of pallas, pallas_hybrid and agg_packed, and the device
   time of one pallas step by kernel group; then the entry point
   `python -m agcn_tpu_torch.main` in subprocesses on synthetic data in a
   temporary directory: train and evaluate one epoch at batch 64, save,
   resume for a second epoch, and `--phase test` on the last checkpoint,
   which must reproduce the run's last top-1.
9. AAGCN serving main path: configs/ntu60_xview/test_joint_aagcn.yaml
   (10 blocks, STC attention, adaptive) with `formulation` and
   `eval_formulation: pallas` (AAGCN serves on 'agg' otherwise), seeded
   weights with a live attention branch and BN statistics from a
   train-mode forward, 16 streams in fp32 and bf16: 10 gcn_fwd launches
   per forward, card against CPU as in 6. Then the attention-logits
   kernel's entry point on the theta/phi each layer of a served forward
   produced (fp32 and bf16), against ops.gcn.attention_logits
   'transposed' in fp32 at 1e-5 of the scale: 10 launches per forward.
10. AAGCN: device time of one served forward by kernel group; the
   serving CLI on the AAGCN config.
11. AAGCN training main path, train_joint_aagcn.yaml, as 8: the card
   step against the CPU with the attention branch live, 10 bf16 steps at
   batch 64 (20 gcn_fwd + 10 gcn_bwd launches each), the three
   formulations' speed, and the entry point: train and evaluate one
   epoch, then `--phase test`.

The last lines of standard output are the `kernels` JSON line, the
card's `nvidia-smi` name and power limit, and
{"ok": true, "device": {...}}. Details go to build/chip_smoke.json.
"""

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
try:
    # phases 3 and 4 and the card-check helpers shared with them
    from agcn_tpu_torch.tools.bwd_check import (
        LAYERS, PEAK_BYTES, PEAK_FLOPS, PERSONS, SEED, TRAIN_BATCH,
        bwd_entry, check, cuda_time_ms, log, nvidia_smi_line,
        phase_bwd_kernels)
    from agcn_tpu_torch.tools.bwd_check import SOURCE as BWD_SOURCE
    from agcn_tpu_torch.tools.fwd_check import (
        fwd_entry, phase_dx, phase_fwd_kernels)
    from agcn_tpu_torch.tools.fwd_check import SOURCE as FWD_SOURCE
except ImportError as e:
    print(f"chip_smoke: the port is not importable here ({e}); run from a "
          "checkout of the repository", file=sys.stderr)
    sys.exit(1)
CONFIG = os.path.join(REPO, "configs", "ntu60_xview", "test_joint.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                            "train_joint.yaml")
AAGCN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                            "test_joint_aagcn.yaml")
AAGCN_TRAIN_CONFIG = os.path.join(REPO, "configs", "ntu60_xview",
                                  "train_joint_aagcn.yaml")
TRAIN_STEPS = 10
STREAMS = 16
SEQ = 300
TICK_FRAMES = 10
# (T, Ce) of the ten attention-logits calls of one AGCN / AAGCN forward
# (Ce = Co / 4; the stride-2 blocks shorten T after their GCN)
LOGITS_SHAPES = [((300, 16), 4), ((300, 32), 1), ((150, 32), 2),
                 ((150, 64), 1), ((75, 64), 2)]
SOURCES = {"gcn_fwd": FWD_SOURCE,
           "gcn_bwd": BWD_SOURCE,
           "logits": "agcn_tpu_torch/ops/csrc/logits.cu"}


def logits_work(b, t, ce, dname, v=25, k=3):
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


def phase_logits(torch, np, logits_kernel):
    """The attention-logits kernel against its plain version at the ten
    layer shapes of the served batch (32) and of the training batch
    (128), fp32 and bf16 inputs, theta/phi as the strided views of the
    fused embedding that the models produce; two calls bitwise equal."""
    from agcn_tpu_torch.ops import gcn as gcn_ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rows = []
    for b in (STREAMS * PERSONS, TRAIN_BATCH * PERSONS):
        for (t, ce), mult in LOGITS_SHAPES:
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype).split(".")[-1]
                emb = torch.randn(b, t, 25, 6 * ce, device="cuda",
                                  generator=gen).to(dtype)
                e = emb.view(b, t, 25, 2, 3, ce)
                th, ph = e[..., 0, :, :], e[..., 1, :, :]
                div = ce * t
                got = logits_kernel.attention_logits_pallas(th, ph, div)
                again = logits_kernel.attention_logits_pallas(th, ph, div)
                torch.cuda.synchronize()
                check(torch.equal(got, again),
                      f"logits B={b} T={t} Ce={ce} {dname}: two calls "
                      f"differ")
                want = logits_kernel.attention_logits_plain(th, ph, div)
                ok, err, scale = logits_close(got, want)
                check(ok, f"logits B={b} T={t} Ce={ce} {dname}: max err "
                          f"{err:.3e} (scale {scale:.3e})")
                flops, nbytes = logits_work(b, t, ce, dname)
                emb32 = emb.float()
                row = dict(
                    b=b, t=t, ce=ce, layers=mult, dtype=dname,
                    max_abs_err=err, scale=scale,
                    ms=cuda_time_ms(lambda: logits_kernel
                                    .attention_logits_pallas(th, ph, div),
                                    20),
                    plain_ms=cuda_time_ms(lambda: logits_kernel
                                          .attention_logits_plain(th, ph,
                                                                  div), 5),
                    # the yardstick: ops.gcn.attention_logits 'transposed'
                    # (the (T, Ce) packing copies and one torch.matmul) on
                    # the fp32 embedding
                    library_ms=cuda_time_ms(lambda: gcn_ops.attention_logits(
                        emb32, 3, ce, "transposed"), 5),
                    flops=flops, bytes=nbytes,
                    flop_ms=flops / PEAK_FLOPS[dname] * 1e3,
                    byte_ms=nbytes / PEAK_BYTES * 1e3)
                rows.append(row)
                by = "ops" if row["flop_ms"] > row["byte_ms"] else "bytes"
                log(f"  logits B={b:3d} T={t:3d} Ce={ce:2d} {dname:8s} "
                    f"err/scale={err / scale:.2e} kernel={row['ms']:.4f} ms "
                    f"plain={row['plain_ms']:.4f} ms transposed-matmul="
                    f"{row['library_ms']:.4f} ms bound="
                    f"{max(row['flop_ms'], row['byte_ms']):.4f} ms ({by})")
                del emb, emb32, e, th, ph, got, again, want
    return rows


def logits_entry(rows, launches, dname="bfloat16"):
    """The `kernels` entry of the logits kernel: per served forward, the
    sum over the ten layers at batch 32 in `dname`."""
    sel = [r for r in rows if r["dtype"] == dname
           and r["b"] == STREAMS * PERSONS]
    tot = lambda key: sum(r[key] * r["layers"] for r in sel)  # noqa: E731
    flop_ms = tot("flops") / PEAK_FLOPS[dname] * 1e3
    byte_ms = tot("bytes") / PEAK_BYTES * 1e3
    return {"name": "attention logits", "route": "cuda",
            "source": SOURCES["logits"],
            "replaces": "agcn_tpu/ops/pallas/logits_kernel.py:30",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms > byte_ms else "bytes",
            "library_ms": tot("library_ms"), "dtype": dname,
            "library_call": "ops.gcn.attention_logits(emb_fp32, 3, Ce, "
                            "'transposed') (torch.matmul)",
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


def serve_streams(torch, np, models, summary, label, num_class):
    """Serve the 16 streams with each model (fp32, bf16) through
    BatchedStreamServer: a warm-up tick, 4 sync and 4 pipelined ticks,
    then the last tick's input through the model directly, whose
    probabilities the served ones must equal. Returns the forwards run,
    the card's logits per dtype, and that input."""
    from agcn_tpu_torch.infer.preprocess import InferencePreprocessor
    from agcn_tpu_torch.infer.serving import BatchedStreamServer

    seq = make_streams(np)
    forwards = 0
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
        forwards += 1 + 4 + 4
        check_answers(np, warm + sync + pipe, num_class)
        check(len(pipe) == 4, "pipelined ticks lost")
        # the same input as the last tick, through the model directly
        for sid in range(STREAMS):
            for f in seq[sid, SEQ:SEQ + 9 * TICK_FRAMES]:
                shadows[sid].append(f)
        x_check = np.concatenate([s.dense_input() for s in shadows])
        with torch.inference_mode():
            logits = model(torch.from_numpy(x_check).cuda()).float().cpu()
        forwards += 1
        card_logits[dname] = logits.numpy()
        probs = torch.softmax(logits, -1).numpy()
        last = pipe[-1]
        served = np.stack([last[sid][1] for sid in range(STREAMS)])
        perr = float(np.abs(served - probs).max())
        check(perr < 1e-4, f"{label} {dname}: served probabilities differ "
                           f"from the model's on the same input by "
                           f"{perr:.2e}")
        tick_ms = {"sync": sync_s / 4 * 1e3, "pipelined": pipe_s / 4 * 1e3}
        prep_ms = {"sync": sync_prep, "pipelined": pipe_prep}
        summary[f"{label}_serve_{dname}"] = dict(
            tick_ms=tick_ms, prep_ms=prep_ms,
            preds_per_s={k: STREAMS / (v / 1e3) for k, v in tick_ms.items()})
        log(f"  {label} {dname}: {STREAMS} streams, tick "
            f"{tick_ms['sync']:.2f} ms sync / {tick_ms['pipelined']:.2f} ms "
            f"pipelined -> {STREAMS / tick_ms['sync'] * 1e3:.1f} / "
            f"{STREAMS / tick_ms['pipelined'] * 1e3:.1f} preds/s "
            f"(mean host prep {sync_prep:.2f} / {pipe_prep:.2f} ms)")
    return forwards, card_logits, x_check


def check_against_cpu(torch, np, model_name, args, state, x_check,
                      card_logits, summary, label):
    """The same weights and input through the plain versions on the CPU:
    fp32 (TF32 off) within 1e-3 of the logit scale (another summation
    order through ten layers), bf16 within 5e-2 (~3 significant digits
    per activation through ten layers)."""
    from agcn_tpu_torch.models.registry import build_model

    torch.set_num_threads(os.cpu_count() or 1)
    cpu = build_model(model_name, args, device="cpu")
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
    log(f"  {label} card vs cpu logits: max err {errs} (logit scale "
        f"{scale:.3f}), top-1 agreement {top1}, cpu forward {cpu_s:.1f} s")
    check(errs["float32"] <= 1e-3 * max(scale, 1.0),
          f"{label} fp32 card logits off the CPU reference by "
          f"{errs['float32']:.3e}")
    check(errs["bfloat16"] <= 5e-2 * max(scale, 1.0),
          f"{label} bf16 card logits off the CPU reference by "
          f"{errs['bfloat16']:.3e}")
    summary[f"{label}_card_vs_cpu"] = dict(logit_err=errs, logit_scale=scale,
                                           top1_agreement=top1)


def phase_main_path(torch, np, summary):
    from agcn_tpu_torch.infer.serving import BatchedStreamServer
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(CONFIG)
    args = dict(cfg.model_args, formulation="pallas")
    num_class = args["num_class"]
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
    served, card_logits, x_check = serve_streams(torch, np, models, summary,
                                                 "agcn", num_class)
    forwards = {"pallas": served, "use_pallas": 0}

    # one served tick with use_pallas=True (the gcn_kernel entry)
    seq = make_streams(np)
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
    check_against_cpu(torch, np, cfg.model, args, state, x_check,
                      card_logits, summary, "agcn")
    summary.update(launches=launches, forwards=forwards)
    return launches, state, args, models, x_check


def dense_streams(np, frames):
    """The model input of the first `frames` frames of every stream, as
    the server prepares it."""
    from agcn_tpu_torch.infer.preprocess import InferencePreprocessor

    seq = make_streams(np)
    out = []
    for sid in range(STREAMS):
        pp = InferencePreprocessor(max_seq_length=SEQ)
        for f in seq[sid, :frames]:
            pp.append(f)
        out.append(pp.dense_input())
    return np.concatenate(out)


def prepare_aagcn_eval(torch, np, model, x, seed):
    """Seeded weights that exercise every branch of an AAGCN at eval: BN
    affines, PA about the graph, a live attention branch (alpha, conv_ta
    and fc2c start at zero), and every BN's running statistics set to its
    batch statistics in a train-mode forward, so that eval normalizes as
    training would (with random statistics the attention's x * (1 + se)
    grows the logits 1e5-fold over ten blocks). `x`: the model input
    (numpy) of that forward."""
    from agcn_tpu_torch.ops.norm import BatchNorm

    g = torch.Generator().manual_seed(seed)

    def draw(p, fn):
        p.copy_(fn(p.shape).to(p.device))

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in norms:
            draw(m.weight, lambda s: torch.rand(s, generator=g) + 0.5)
            draw(m.bias, lambda s: torch.randn(s, generator=g) * 0.1)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        for name, p in model.named_parameters():
            if name.endswith(".PA"):
                p.add_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))
            elif name.endswith(".alpha"):
                draw(p, lambda s: torch.rand(s, generator=g) * 0.5 + 0.5)
            elif ".conv_ta." in name or ".fc2c." in name:
                draw(p, lambda s: torch.randn(s, generator=g) * 0.1)
        model.train()(torch.from_numpy(x).to(next(model.parameters()).device))
        for m in norms:  # undo the momentum-0.1 update from (0, 1)
            m.running_mean.div_(0.1)
            m.running_var.sub_(0.9).div_(0.1).clamp_(min=1e-3)
    model.eval()


def capture_embeddings(torch, model, x):
    """The fused theta|phi embedding that each layer of one forward hands
    to ops.gcn.attention_logits, with (K, Ce)."""
    from agcn_tpu_torch.ops import gcn as gcn_ops

    seen = []
    plain = gcn_ops.attention_logits

    def keep(emb, k, ce, form="transposed"):
        seen.append((emb.detach().clone(), k, ce))
        return plain(emb, k, ce, form)

    gcn_ops.attention_logits = keep
    try:
        with torch.inference_mode():
            model(x)
    finally:
        gcn_ops.attention_logits = plain
    return seen


def phase_aagcn_serving(torch, np, summary):
    """AAGCN serving: test_joint_aagcn.yaml with formulation and
    eval_formulation pallas, 16 streams in fp32 and bf16, 10 gcn_fwd
    launches per forward, card against CPU; then the logits kernel's own
    entry point on the theta/phi each layer of a served forward produces,
    against attention_logits(emb, 'transposed') in fp32."""
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops import gcn as gcn_ops
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel
    from agcn_tpu_torch.ops.kernels import logits_kernel
    from agcn_tpu_torch.utils.config import load_config

    cfg = load_config(AAGCN_CONFIG)
    args = dict(cfg.model_args, formulation="pallas",
                eval_formulation="pallas")
    num_class = args["num_class"]
    ref = build_model(cfg.model, args, device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    # BN statistics from the streams' first 300 frames; the served ticks
    # then run on later frames
    prepare_aagcn_eval(torch, np, ref, dense_streams(np, SEQ), SEED + 1)
    state = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref
    models = {}
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.model, args, device="cuda",
                        dtype=getattr(torch, dname))
        m.load_state_dict(state, strict=True)
        models[dname] = m.eval()

    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    forwards, card_logits, x_check = serve_streams(torch, np, models,
                                                   summary, "aagcn",
                                                   num_class)
    launches = {"adaptive_gcn_pallas": gcn_fused.adaptive_gcn_pallas.launches,
                "fused_gcn": gcn_kernel.fused_gcn.launches}
    log(f"  aagcn launches {launches} for {forwards} forwards")
    check(launches == {"adaptive_gcn_pallas": LAYERS * forwards,
                       "fused_gcn": 0},
          f"aagcn launch counts {launches} != {LAYERS} layers x {forwards}")
    check_against_cpu(torch, np, cfg.model, args, state, x_check,
                      card_logits, summary, "aagcn")

    # the logits kernel's entry point on the served forward's embeddings
    x = torch.from_numpy(x_check).cuda()
    embs = {d: capture_embeddings(torch, m, x) for d, m in models.items()}
    logits_kernel.attention_logits_pallas.launches = 0
    worst = 0.0
    for dname, seen in embs.items():
        check(len(seen) == LAYERS, f"{dname}: {len(seen)} logits calls")
        for emb, k, ce in seen:
            b, t, v, _ = emb.shape
            e = emb.view(b, t, v, 2, k, ce)
            with torch.inference_mode():
                got = logits_kernel.attention_logits_pallas(
                    e[..., 0, :, :], e[..., 1, :, :], ce * t)
                want = gcn_ops.attention_logits(emb.float(), k, ce,
                                                "transposed")
            ok, err, scale = logits_close(got, want)
            check(ok, f"served {dname} T={t} Ce={ce}: logits kernel off "
                      f"the transposed form by {err:.3e} (scale "
                      f"{scale:.3e})")
            worst = max(worst, err / scale)
    logits_launches = logits_kernel.attention_logits_pallas.launches
    log(f"  logits kernel on the served embeddings of {len(embs)} forwards: "
        f"{logits_launches} launches, max err {worst:.2e} of the scale")
    check(logits_launches == LAYERS * len(embs),
          f"logits launches {logits_launches} != {LAYERS} x {len(embs)}")
    summary.update(aagcn_launches=launches, aagcn_forwards=forwards,
                   logits_served=dict(launches=logits_launches,
                                      max_err_over_scale=worst))
    return launches, logits_launches, state, args, models, x_check


# kernel-name substrings -> group of the device-time breakdown, first
# match wins
KERNEL_GROUPS = (
    ("gcn_fwd_", "gcn_fwd (the port's CUDA kernel)"),
    ("logits_", "attention logits (the port's CUDA kernel)"),
    ("gcn_dw_", "gcn_bwd (the port's CUDA kernel)"),
    ("gcn_u_kernel", "gcn_bwd (the port's CUDA kernel)"),
    ("gcn_da1_kernel", "gcn_bwd (the port's CUDA kernel)"),
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


def phase_profile(torch, models, x_np, summary, label, iters=5):
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
        log(f"  {label} {dname}: wall {wall_ms:.3f} ms per forward (profiler "
            f"off), "
            f"device {device_ms:.3f} ms under the profiler (busy "
            f"{100 * device_ms / wall_ms:.1f}%)")
        for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
            log(f"    {ms:9.3f} ms {100 * ms / device_ms:5.1f}%  {g}")
        summary[f"{label}_profile_{dname}"] = dict(
            wall_ms=wall_ms, device_ms=device_ms, groups=groups)


def phase_cli(torch, np, state, model_name, args, trainer_checkpoint=False):
    """The serving CLI on 16 recordings, its weights a bare state dict or,
    with `trainer_checkpoint`, a file of the port trainer's
    `save_checkpoint` (the model, optimizer state, step and epoch)."""
    import yaml

    from agcn_tpu_torch.infer import cli
    from agcn_tpu_torch.models.registry import build_model
    from agcn_tpu_torch.ops.kernels import gcn_fused
    from agcn_tpu_torch.train.checkpoint import save_checkpoint

    seq = make_streams(np)[:, :4 * TICK_FRAMES]  # 4 ticks per stream
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "recordings")
        os.makedirs(rec)
        for sid in range(STREAMS):
            # (C, T, V, M) recordings
            arr = np.transpose(seq[sid, :, :, 0], (3, 0, 2, 1))
            np.save(os.path.join(rec, f"cam{sid:02d}.npy"), arr)
        weights = os.path.join(tmp, f"{model_name}.pt")
        if trainer_checkpoint:
            model = build_model(model_name, args, device="cpu")
            model.load_state_dict({k: v.cpu() for k, v in state.items()},
                                  strict=True)
            save_checkpoint(weights, model, {}, step=1, epoch=1,
                            steps_per_epoch=1)
            del model
        else:
            torch.save({k: v.cpu() for k, v in state.items()}, weights)
        cfg_path = os.path.join(tmp, "serve.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"model": model_name, "model_args": args}, f)
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
    source = "trainer checkpoint" if trainer_checkpoint else "state dict"
    log(f"  {model_name} cli ({source}): {len(answers)} answers, "
        f"{len(ticks)} ticks, "
        f"{launches} launches; last: {ticks[-1] if ticks else None}")
    check(len(answers) == STREAMS * 4 and launches == LAYERS * 4,
          f"cli served {len(answers)} answers with {launches} launches")
    return launches


def train_model(torch, cfg, form, dname, device="cuda"):
    """The recipe's model at full width with `formulation: form`, seeded
    weights, parameters fp32 and compute in `dname`."""
    from agcn_tpu_torch.models.registry import build_model

    return build_model(cfg.model, dict(cfg.model_args, formulation=form),
                       device=device,
                       dtype=None if dname == "float32" else torch.bfloat16,
                       generator=torch.Generator().manual_seed(SEED))


def train_batch(np, n, seed, num_class=60):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3, SEQ, 25, PERSONS)).astype(np.float32)
    return x, rng.integers(0, num_class, n)


def make_step(torch, cfg, model, steps_per_epoch=1, keep=None):
    """The trainer's step: the recipe's loss and SGD chain (clip ->
    decay -> nesterov), with `keep` given the model's raw gradients."""
    from agcn_tpu_torch.train import losses, optim
    from agcn_tpu_torch.train.steps import make_train_step

    schedule = optim.build_schedule(cfg.scheduler, cfg.base_lr,
                                    steps_per_epoch, cfg.step,
                                    cfg.warm_up_epoch)
    opt = optim.build_optimizer(cfg.optimizer, model.parameters(), schedule,
                                cfg.weight_decay, cfg.nesterov,
                                grad_clip=cfg.grad_clip)
    loss_fn = losses.build_loss(cfg.loss, cfg.model_args["num_class"])
    return make_train_step(model, loss_fn, opt, grad_transform=keep)


def liven_attention(torch, model, seed):
    """AAGCN's attention branch away from its zero init: alpha in
    [0.5, 1), conv_ta and fc2c normal(0, 0.1) (a no-op on AGCN)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".alpha"):
                p.copy_((torch.rand(p.shape, generator=g) * 0.5 + 0.5)
                        .to(p.device))
            elif ".conv_ta." in name or ".fc2c." in name:
                p.copy_((torch.randn(p.shape, generator=g) * 0.1)
                        .to(p.device))


def phase_train_vs_cpu(torch, np, cfg, summary, label):
    """(a) One step at batch 4: the card with the kernels against the card
    with their plain versions (the kernels' own error) and against
    device="cpu" (the whole step).

    A ReLU input within rounding of zero may take either side in two fp32
    computations, and one such flip moves the gradients of its layer and
    of every layer below it by ~1% (agcn_tpu_torch/tools/grad_parity.py).
    So the CPU's step records its ReLU inputs and masks and the card's
    fp32 steps replay the masks: all three compute the same linear piece
    of the network. The card's ReLU inputs must lie within 1e-3 of their
    layer's mean |input| of the CPU's, so that the masks hide no fault."""
    from agcn_tpu_torch.tools.grad_parity import (
        ReluProbe, condition_bn, grad_errors, plain_versions_on_the_card,
        relu_probe)

    x, y = train_batch(np, 4, SEED + 4)
    ref = train_model(torch, cfg, "pallas", "float32")
    condition_bn(ref, SEED + 6)
    liven_attention(torch, ref, SEED + 12)
    state = {k: v.detach().cpu().clone() for k, v in ref.state_dict().items()}
    del ref
    out, probes = {}, {}
    torch.set_num_threads(os.cpu_count() or 1)
    runs = {"cpu fp32": ("cpu", "float32", False),
            "card fp32": ("cuda", "float32", False),
            "card fp32 plain": ("cuda", "float32", True),
            "card bf16": ("cuda", "bfloat16", False)}
    for run, (dev, dname, plain) in runs.items():
        model = train_model(torch, cfg, "pallas", dname, device=dev)
        model.load_state_dict(state, strict=True)
        grads = {}

        def keep(m):
            # a copy: the optimizer then clips the gradients in place
            grads.update((n, p.grad.double().cpu().clone())
                         for n, p in m.named_parameters())

        probes[run] = (
            ReluProbe(keep_inputs=True) if run == "cpu fp32"
            else ReluProbe(ref=probes["cpu fp32"]) if dname == "float32"
            else ReluProbe())
        t0 = time.perf_counter()
        with contextlib.ExitStack() as scopes:
            scopes.enter_context(relu_probe(probes[run]))
            if plain:
                scopes.enter_context(plain_versions_on_the_card())
            loss = make_step(torch, cfg, model, keep=keep)(
                torch.from_numpy(x).to(dev),
                torch.from_numpy(y).to(dev))["loss"].item()
        out[run] = (loss, grads, time.perf_counter() - t0)
        del model
    ref_loss, ref_grads, cpu_s = out["cpu fp32"]
    rel = {k: abs(v[0] - ref_loss) / abs(ref_loss) for k, v in out.items()}
    # fp32 (TF32 off), sums in another order: 1e-3 of each tensor's scale
    kern = grad_errors(out["card fp32"][1], out["card fp32 plain"][1], 1e-3)
    cpu = grad_errors(out["card fp32"][1], ref_grads, 1e-3)
    flips = {k: (probes[k].disagree, probes[k].input_diff)
             for k in ("card fp32", "card fp32 plain")}
    log(f"  {label} (a) batch 4: loss cpu fp32 {ref_loss:.6f}; relative to it "
        + ", ".join(f"{k} {out[k][0]:.6f} ({rel[k]:.2e})"
                    for k in runs if k != "cpu fp32")
        + f"; cpu step {cpu_s:.1f} s; ReLU signs off the cpu's masks: "
        + ", ".join(f"{k} {n} (inputs at most {m:.2e} of their layer's "
                    f"mean |input| from the cpu's)"
                    for k, (n, m) in flips.items()))
    for k, rows in (("kernels vs plain on the card", kern),
                    ("card vs cpu", cpu)):
        log(f"      {k}: worst gradients (err / bar, name, err, scale): "
            + "; ".join(f"{r:.2f} {n} {e:.3e} {sc:.3e}"
                        for r, n, e, sc in rows[:3]))
    check(all(m <= 1e-3 for _, m in flips.values()),
          f"{label}: the card's ReLU inputs lie far from the CPU's: {flips}")
    # bf16: ~3 digits per activation through ten layers, against the
    # fp32 reference
    check(rel["card fp32"] <= 1e-4 and rel["card fp32 plain"] <= 1e-4,
          f"{label}: fp32 card loss off the CPU's: {rel}")
    check(kern[0][0] <= 1.0, f"{label}: fp32 gradients with the kernels off "
                             f"those with their plain versions: {kern[0]}")
    check(cpu[0][0] <= 1.0,
          f"{label}: fp32 card gradients off the CPU's: {cpu[0]}")
    check(rel["card bf16"] <= 5e-2,
          f"{label}: bf16 card loss off the CPU's: {rel}")
    summary[f"{label}_train_vs_cpu"] = dict(
        loss={k: v[0] for k, v in out.items()}, loss_rel=rel,
        relu_sign_flips=flips,
        kernels_vs_plain=[list(r) for r in kern[:5]],
        card_vs_cpu=[list(r) for r in cpu[:5]])


def phase_train_main_path(torch, np, cfg, summary, label):
    """(c) Ten bf16 steps of the recipe's `pallas` model at batch 64 on
    one repeated batch: the loss must fall, and each step must launch
    gcn_fwd 20 times (10 forwards, 10 dx) and gcn_bwd 10 times."""
    from agcn_tpu_torch.ops.kernels import gcn_fused, gcn_kernel

    model = train_model(torch, cfg, "pallas", "bfloat16")
    step = make_step(torch, cfg, model)
    x, y = train_batch(np, TRAIN_BATCH, SEED + 7)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    gcn_fused.adaptive_gcn_pallas.launches = 0
    gcn_kernel.fused_gcn.launches = 0
    gcn_fused.gcn_backward.launches = 0
    losses = [step(x, y)["loss"] for _ in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    launches = {"gcn_fwd_round_agg": gcn_fused.adaptive_gcn_pallas.launches,
                "gcn_fwd_fp32_agg": gcn_kernel.fused_gcn.launches,
                "gcn_bwd": gcn_fused.gcn_backward.launches}
    log(f"  {label} (c) {TRAIN_STEPS} steps on one batch: loss "
        f"{' '.join(f'{v:.3f}' for v in losses)}; launches {launches}")
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(losses[-1] < losses[0],
          f"{label}: the loss did not fall on a repeated batch: {losses}")
    check(launches == {"gcn_fwd_round_agg": 2 * LAYERS * TRAIN_STEPS,
                       "gcn_fwd_fp32_agg": 0,
                       "gcn_bwd": LAYERS * TRAIN_STEPS},
          f"{label}: launch counts {launches} for {TRAIN_STEPS} steps")
    summary[f"{label}_train_losses"] = losses
    summary[f"{label}_train_launches"] = launches
    return launches


def phase_train_speed(torch, np, cfg, summary, label, iters=5):
    """(d) ms per step, seq/s and peak memory per formulation at batch
    64, bf16; the device time of one pallas step by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, y = train_batch(np, TRAIN_BATCH, SEED + 8)
    x, y = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    speed = {}
    for form in ("pallas", "pallas_hybrid", "agg_packed"):
        model = train_model(torch, cfg, form, "bfloat16")
        step = make_step(torch, cfg, model)
        for _ in range(2):
            step(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / iters
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        speed[form] = dict(ms_per_step=ms, seq_per_s=TRAIN_BATCH / ms * 1e3,
                           peak_gib=peak)
        log(f"  {label} (d) {form:13s} {ms:8.2f} ms/step "
            f"{TRAIN_BATCH / ms * 1e3:7.1f}"
            f" seq/s, peak {peak:.2f} GiB")
        if form == "pallas":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step(x, y)
                torch.cuda.synchronize()
            groups, ours = {}, {}
            for ev in prof.events():
                if ev.device_type == DeviceType.CUDA:
                    g = kernel_group(ev.name)
                    ms_ev = ev.device_time_total / 1e3
                    groups[g] = groups.get(g, 0.0) + ms_ev
                    mine = re.search(r"gcn_\w+_kernel", ev.name)
                    if mine:  # the port's kernels one by one
                        ours[mine[0]] = ours.get(mine[0], 0.0) + ms_ev
            device_ms = sum(groups.values())
            check(device_ms > 0, "the profiler saw no device time")
            log(f"      one pallas step: device {device_ms:.3f} ms; the "
                f"port's kernels: "
                + ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(
                    ours.items(), key=lambda kv: -kv[1])))
            for g, gms in sorted(groups.items(), key=lambda kv: -kv[1]):
                log(f"    {gms:9.3f} ms {100 * gms / device_ms:5.1f}%  {g}")
            speed[form].update(device_ms=device_ms, groups=groups,
                               kernels=ours)
        del model, step
    summary[f"{label}_train_speed"] = speed


def run_entry_point(args, timeout=600):
    """`python -m agcn_tpu_torch.main` in a subprocess; its output goes
    to this run's log, and a failure fails the phase."""
    proc = subprocess.run([sys.executable, "-m", "agcn_tpu_torch.main",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    tail = (proc.stdout + proc.stderr).splitlines()[-8:]
    for ln in tail:
        log(f"      {ln}")
    check(proc.returncode == 0,
          f"agcn_tpu_torch.main {' '.join(args)} exited {proc.returncode}")


def read_metrics(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def phase_train_cli(np, summary, config, label, resume=True,
                    **model_args):
    """(b) The entry point on a config derived from the recipe `config`:
    synthetic data, batch 64, T=300, bf16, `formulation: pallas` (and
    `model_args`). Train and evaluate one epoch and save; with `resume`,
    resume from that checkpoint for a second epoch; `--phase test` on the
    last checkpoint must reproduce the run's last top-1."""
    import pickle

    import yaml

    with open(config) as f:
        recipe = yaml.safe_load(f)
    epochs = 2 if resume else 1
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for split, n in (("train", 2 * TRAIN_BATCH), ("val", TRAIN_BATCH)):
            x, y = train_batch(np, n, SEED + 9 + n)
            paths[split] = (os.path.join(tmp, f"{split}_data.npy"),
                            os.path.join(tmp, f"{split}_label.pkl"))
            np.save(paths[split][0], x)
            with open(paths[split][1], "wb") as f:
                pickle.dump(([f"{split}{i}" for i in range(n)],
                             y.tolist()), f)
        work = os.path.join(tmp, "work")
        recipe.update(
            work_dir=work, batch_size=TRAIN_BATCH,
            test_batch_size=TRAIN_BATCH, num_epoch=1, num_worker=2,
            log_interval=1,
            save_interval=1, eval_interval=1, show_topk=[1, 5],
            model_args=dict(recipe["model_args"], formulation="pallas",
                            **model_args),
            train_feeder_args=dict(recipe["train_feeder_args"],
                                   data_path=paths["train"][0],
                                   label_path=paths["train"][1]),
            test_feeder_args=dict(recipe["test_feeder_args"],
                                  data_path=paths["val"][0],
                                  label_path=paths["val"][1]))
        cfg_path = os.path.join(tmp, "train.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump(recipe, f)
        ckpt = os.path.join(work, "checkpoints")
        log(f"  {label} (b) train + eval + save, epoch 1")
        run_entry_point(["--config", cfg_path])
        if resume:
            log("      resume from epoch_1 for epoch 2")
            run_entry_point(["--config", cfg_path, "--weights",
                             os.path.join(ckpt, "epoch_1.pt"),
                             "--start-epoch", "1", "--num-epoch", "2"])
        log(f"      --phase test on epoch_{epochs}")
        run_entry_point(["--config", cfg_path, "--phase", "test", "--weights",
                         os.path.join(ckpt, f"epoch_{epochs}.pt"),
                         "--work-dir", os.path.join(tmp, "test")])
        metrics = read_metrics(os.path.join(work, "metrics.jsonl"))
        test = read_metrics(os.path.join(tmp, "test", "metrics.jsonl"))
        with open(os.path.join(tmp, "test", "right.txt")) as f:
            right = len(f.readlines())
    trains = [m for m in metrics if m["kind"] == "train"]
    evals = [m for m in metrics if m["kind"] == "eval"]
    check([m["epoch"] for m in trains] == list(range(epochs))
          and [m["epoch"] for m in evals] == list(range(epochs)),
          f"{label} epochs trained / evaluated: {metrics}")
    for m in trains:
        check(math.isfinite(m["loss"]), f"non-finite loss: {m}")
        check(m["steps"] == 2 * (m["epoch"] + 1),
              f"optimizer steps after epoch {m['epoch']}: {m['steps']}")
        check(m["launches"] == {"gcn_fwd_round_agg": 2 * 2 * LAYERS,
                                "gcn_fwd_fp32_agg": 0,
                                "gcn_bwd": 2 * LAYERS},
              f"epoch {m['epoch']} launches {m['launches']} for 2 steps")
    check(test[-1]["top1"] == evals[-1]["top1"]
          and right == round(test[-1]["top1"] * TRAIN_BATCH),
          f"--phase test top-1 {test[-1]['top1']} != the run's "
          f"{evals[-1]['top1']}")
    log(f"      epochs {[round(m['loss'], 4) for m in trains]} loss, "
        f"{[round(m['seq_per_sec'], 1) for m in trains]} seq/s; eval top-1 "
        f"{evals[-1]['top1']:.4f}, --phase test top-1 "
        f"{test[-1]['top1']:.4f}")
    summary[f"{label}_train_cli"] = dict(train=trains, eval=evals, test=test)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    import numpy as np

    from agcn_tpu_torch.ops.kernels import (build, gcn_fused, gcn_kernel,
                                            logits_kernel)
    from agcn_tpu_torch.utils.config import load_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = {}
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()
    log(f"[1/11] {kind}: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[2/11] built {sorted(built)} in {build_s:.1f} s")
    for res in built.values():
        for ln in res.log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"  {ln.strip()}")
    summary["build_s"] = build_s

    log("[3/11] gcn_fwd kernel vs plain version at the served shapes "
        "(batch 32) and as dx at the training shapes (batch 128). "
        "Tolerances: fp32 (TF32 off) max err <= 1e-4 x output scale "
        "(another summation order over up to 19,200 products); bf16 per "
        "element <= 2^-7 |ref| + 2^-10 x scale (loose: one bf16 rounding "
        "of each output may land one ulp apart), yet tight enough that "
        "each round_agg mode fails the other mode's plain version on "
        "integer inputs; bf16 round_agg=1 bit for bit on small-integer "
        "inputs, two calls bitwise equal")
    with torch.inference_mode():
        rows = phase_fwd_kernels(torch, np, gcn_fused, gcn_kernel)
        dx_rows = phase_dx(torch, np, gcn_fused)
    summary.update(kernel_rows=rows, dx_rows=dx_rows)

    log("[4/11] gcn_bwd vs its plain version at the training shapes "
        "(batch 128), same tolerances")
    with torch.inference_mode():
        bwd_rows = phase_bwd_kernels(torch, np, gcn_fused)
    summary["bwd_rows"] = bwd_rows

    log("[5/11] attention-logits kernel vs plain version at the served "
        "(32) and training (128) batch shapes. Tolerance: max err <= 1e-5 "
        "x output scale (fp32 sums of up to 9,600 products in another "
        "order); two calls bitwise equal")
    with torch.inference_mode():
        logits_rows = phase_logits(torch, np, logits_kernel)
    summary["logits_rows"] = logits_rows

    log("[6/11] AGCN serving main path: 16 streams through "
        "BatchedStreamServer")
    launches, state, args, models, x_check = phase_main_path(torch, np,
                                                             summary)
    log("[7/11] AGCN: device time of one served forward by kernel group; "
        "the serving CLI (python -m agcn_tpu_torch.infer --serve 16 "
        "--pipeline)")
    phase_profile(torch, models, x_check, summary, "agcn")
    del models
    summary["agcn_cli_launches"] = phase_cli(torch, np, state, "agcn", args,
                                             trainer_checkpoint=True)

    log("[8/11] AGCN training main path: train_joint.yaml, formulation "
        "pallas, T=300")
    train_cfg = load_config(TRAIN_CONFIG)
    phase_train_vs_cpu(torch, np, train_cfg, summary, "agcn")
    train_launches = phase_train_main_path(torch, np, train_cfg, summary,
                                           "agcn")
    phase_train_speed(torch, np, train_cfg, summary, "agcn")
    phase_train_cli(np, summary, TRAIN_CONFIG, "agcn")

    log("[9/11] AAGCN serving main path: test_joint_aagcn.yaml, formulation "
        "and eval_formulation pallas, 16 streams; the logits kernel's entry "
        "point on the served forward's theta/phi")
    (aagcn_launches, logits_launches, aagcn_state, aagcn_args, aagcn_models,
     aagcn_x) = phase_aagcn_serving(torch, np, summary)
    log("[10/11] AAGCN: device time of one served forward by kernel group; "
        "the serving CLI")
    phase_profile(torch, aagcn_models, aagcn_x, summary, "aagcn")
    del aagcn_models
    summary["aagcn_cli_launches"] = phase_cli(torch, np, aagcn_state, "aagcn",
                                              aagcn_args)

    log("[11/11] AAGCN training main path: train_joint_aagcn.yaml, "
        "formulation pallas, T=300")
    aagcn_cfg = load_config(AAGCN_TRAIN_CONFIG)
    phase_train_vs_cpu(torch, np, aagcn_cfg, summary, "aagcn")
    aagcn_train_launches = phase_train_main_path(torch, np, aagcn_cfg,
                                                 summary, "aagcn")
    phase_train_speed(torch, np, aagcn_cfg, summary, "aagcn")
    phase_train_cli(np, summary, AAGCN_TRAIN_CONFIG, "aagcn", resume=False,
                    eval_formulation="pallas")

    fwd_launches = {
        "agcn_serve": launches["adaptive_gcn_pallas"],
        "agcn_train": train_launches["gcn_fwd_round_agg"],
        "aagcn_serve": aagcn_launches["adaptive_gcn_pallas"],
        "aagcn_train": aagcn_train_launches["gcn_fwd_round_agg"]}
    bwd_launches = {"agcn_train": train_launches["gcn_bwd"],
                    "aagcn_train": aagcn_train_launches["gcn_bwd"]}
    kernels = [
        fwd_entry(rows, True, "bfloat16", sum(fwd_launches.values()),
                  "gcn_fwd (aggregate rounded to x's type)",
                  "agcn_tpu/ops/pallas/gcn_fused.py:52", dx_rows),
        fwd_entry(rows, False, "bfloat16", launches["fused_gcn"],
                  "gcn_fwd (fp32 aggregate)",
                  "agcn_tpu/ops/pallas/gcn_kernel.py:27"),
        bwd_entry(bwd_rows, sum(bwd_launches.values())),
        logits_entry(logits_rows, logits_launches),
    ]
    kernels[0]["launches_by_path"] = fwd_launches
    kernels[2]["launches_by_path"] = bwd_launches
    summary.update(kernels=kernels, device=kind, nvidia_smi=smi,
                   seconds=time.perf_counter() - t_start)
    log(f"  all phases in {summary['seconds']:.1f} s")
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
