#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fira_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device   the card's name, count, and nvidia-smi's name and power limit;
2. build    every hand-written kernel compiled with nvcc for sm_90a from
            the sources in this checkout (registers, shared memory, spills);
3. kernels  each kernel against its plain PyTorch version on the card at
            the shapes the main path gives it, timed with CUDA events
            (L2 flushed between launches), beside its bound and its share
            of it: K1 (copy-score forward) at the decode step (T=1, its
            bytes-first kernel), the dev batch and the training batch
            (T=30, its tanh from one reciprocal a pair of elements; there
            also on inputs with entries of magnitude 15-60, where it
            leaves the identity, and bitwise equal over two launches), at
            a batch of 85 (the tile kernel's third tiling, 64 s a block)
            and in bf16; K2 (its backward, also on the inputs of
            magnitude 15-60);
4. train    the training path at fira-full width on a synthetic corpus with
            the paper's vocabulary sizes and random seeded weights: one
            epoch through the CLI (``fira_tpu_torch.cli train`` on cuda),
            then two epochs with the dev gate brought in (every 2 batches
            from epoch 0) through the library entry ``train.loop.train``;
            K2 must launch once per step and K1 once per step and per dev
            batch;
5. train plain  the same steps from the same weights and dropout seed with
            the plain copy score swapped in by this script (no entry point
            does): the per-step losses must agree;
6. main     the test path through the CLI entry point (``cli test`` on
            cuda), decoding the trained checkpoint; the K1 launch count of
            this run must match the path;
7. plain    the same decode with the plain copy score swapped in: the
            output file must be byte-identical; and on a small input the
            card's distributions must agree with the CPU's;
8. profile  one warm training step (plain copy score, then the kernels)
            and one decode batch under torch.profiler, with the copy-score
            kernels' device time in each.

The last three lines are the kernels' JSON record, nvidia-smi's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import sys
import time

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and f32
# operations/s outside the tensor cores (the copy score's tanh/add/mul)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
N_COMMITS = 720            # -> a test split of ~60 commits
WORD_VOCAB, AST_VOCAB = 24_650, 71   # the paper's vocabulary sizes
SEED = 0


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def ptxas_summary(log: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v`` output: its
    name and template arguments (from the mangled name), registers,
    shared memory and spills."""
    kernel, spills = "?", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            mangled = line.split()[-1]
            m = re.search(r"(?<=\d)(copy_score\w*?_kernel)I(13__nv_bfloat16|f)"
                          r"(?:Li(\d+)E)?", mangled)
            kernel = (f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'f32'}"
                      f"{', ' + m.group(3) if m.group(3) else ''}>"
                      if m else mangled)
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            yield f"{kernel}: {line.split(':', 1)[1].strip()}; {spills}"


def host_call_us(torch, fn, n: int = 200) -> float:
    """Host microseconds to queue one ``fn()`` (Python and launch cost,
    no synchronise inside; the device runs behind)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / n


def _bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def copy_score_bound_ms(B: int, T: int, S: int, D: int, itemsize: int):
    """Least time for the copy score on the H100: each input read once and
    the output written once, against the f32 operations (add, tanh, mul,
    accumulate per (b, t, s, d)); returns (ms, "bytes" | "operations")."""
    nbytes = (B * S * D + B * T * D + B * T * S) * itemsize + D * 4 + 4
    return _bound(nbytes, 4 * B * T * S * D)


def copy_score_bwd_bound_ms(B: int, T: int, S: int, D: int, itemsize: int):
    """Least time for the copy score's backward on the H100. Bytes: src,
    tgt and dout read once, dsrc and dtgt written once (w and dw are D
    values each). Operations: 8 f32 a (b, t, s, d) element: the add, the
    tanh, 1 - x^2 (one multiply-add), the product by w * dout, x * dout,
    and the accumulations of dsrc, dtgt and dw. At (170, 30, 370, 256) f32
    that is 147 MB (0.044 ms) against 3.87 G operations (0.058 ms): bound
    by operations. Returns (ms, "bytes" | "operations")."""
    nbytes = ((2 * B * S * D + 2 * B * T * D + B * T * S) * itemsize
              + 2 * D * 4)
    return _bound(nbytes, 8 * B * T * S * D)


def with_large(torch, x, frac: float, gen):
    """x with a share ``frac`` of its entries replaced by values of both
    signs at |value| 15-20 or 25-60 (half each): there the copy-score
    kernels leave their fast tanh."""
    mag = torch.where(
        torch.rand(x.shape, device="cuda", generator=gen) < 0.5,
        25 + 35 * torch.rand(x.shape, device="cuda", generator=gen),
        15 + 5 * torch.rand(x.shape, device="cuda", generator=gen))
    sign = torch.rand(x.shape, device="cuda", generator=gen) < 0.5
    pick = torch.rand(x.shape, device="cuda", generator=gen) < frac
    return torch.where(pick, torch.where(sign, mag, -mag), x)


def phase_kernels(torch, cs, cfg):
    """Copy score: kernel vs plain at the decode, dev and training shapes
    (f32, rtol/atol 1e-5: the kernel sums D in another order and, at T > 1,
    takes tanh from one reciprocal a pair of elements), at the training
    shape also with large magnitudes and over two launches (bitwise), at
    a batch of 85, and one bf16 case (1e-2: one bf16 rounding of the result). Returns the
    decode shape's numbers, with the dev and training shapes' under
    ``dev_*`` and ``train_*``."""
    from fira_tpu_torch.ops.timing import time_ms

    B, K = cfg.test_batch_size, cfg.beam_size
    S, D = cfg.sou_len + cfg.sub_token_len, cfg.embedding_dim
    cases = [("decode", (B * K, 1, S, D), torch.float32, 1e-5),
             ("dev", (B, cfg.tar_len, S, D), torch.float32, 1e-5),
             ("train", (cfg.batch_size, cfg.tar_len, S, D), torch.float32,
              1e-5),
             # the main path pads every batch to full size, so it gives the
             # tile kernel 128 s a block (train) and 32 (dev); a batch of
             # 85 takes the third tiling, 64 s a block and 2 slices of d
             ("batch85", (85, cfg.tar_len, S, D), torch.float32, 1e-5),
             ("decode_bf16", (B * K, 1, S, D), torch.bfloat16, 1e-2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = {}
    for name, (b, t, s, d), dtype, tol in cases:
        src = torch.randn((b, s, d), device="cuda", generator=gen).to(dtype)
        tgt = torch.randn((b, t, d), device="cuda", generator=gen).to(dtype)
        w = torch.randn((d, 1), device="cuda", generator=gen) * 0.1
        bias = torch.randn((1,), device="cuda", generator=gen)
        got = cs.copy_scores(src, tgt, w, bias)
        want = cs.copy_scores_reference(src, tgt, w, bias)
        torch.cuda.synchronize()
        check(got.shape == (b, t, s) and got.dtype == dtype,
              f"copy_score {name}: shape {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()),
              f"copy_score {name}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if name == "train":
            check(torch.equal(got, cs.copy_scores(src, tgt, w, bias)),
                  "copy_score train: two launches on the same inputs differ")
            big_src = with_large(torch, src, 0.05, gen)
            big_tgt = with_large(torch, tgt, 0.02, gen)
            big = cs.copy_scores(big_src, big_tgt, w, bias)
            big_want = cs.copy_scores_reference(big_src, big_tgt, w, bias)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(big).all()),
                  "copy_score train, large magnitudes: non-finite output")
            torch.testing.assert_close(big, big_want, rtol=tol, atol=tol)
            print(f"[kernels] copy_score train shape, large magnitudes "
                  f"(|src| or |tgt| 15-60 on 5 % / 2 % of entries): "
                  f"max_abs_err {(big - big_want).abs().max().item():.3e} "
                  f"(rtol/atol {tol}); bitwise equal over two launches",
                  flush=True)
            del big_src, big_tgt, big, big_want
        w32, out = w.reshape(-1).contiguous(), torch.empty_like(got)
        ms = time_ms(lambda: cs.launch(src, tgt, w32, out))
        wrapper_ms = time_ms(lambda: cs.copy_scores(src, tgt, w, bias))
        plain_ms = time_ms(
            lambda: cs.copy_scores_reference(src, tgt, w, bias), n=10)
        if name == "decode":
            host_us = {label: host_call_us(torch, f) for label, f in (
                ("wrapper", lambda: cs.copy_scores(src, tgt, w, bias)),
                ("launch", lambda: cs.launch(src, tgt, w32, out)),
                ("plain", lambda: cs.copy_scores_reference(src, tgt, w,
                                                           bias)))}
            print("[kernels] copy_score decode host time to queue one call: "
                  + ", ".join(f"{k} {v:.1f} us" for k, v in host_us.items()),
                  flush=True)
        bound, by = copy_score_bound_ms(b, t, s, d, src.element_size())
        print(f"[kernels] copy_score {name} ({b},{t},{s},{d}) {dtype}: "
              f"max_abs_err {err:.3e} (tol {tol}); kernel {ms:.4f} ms "
              f"(wrapper with bias add {wrapper_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"kernel at {100 * bound / ms:.1f}% of bound", flush=True)
        if name in ("decode", "dev", "train"):
            pre = "" if name == "decode" else f"{name}_"
            record.update({f"{pre}max_abs_err": err, f"{pre}ms": ms,
                           f"{pre}plain_ms": plain_ms,
                           f"{pre}bound_ms": bound, f"{pre}bound_by": by})
        del src, tgt, got, want
    return record


def phase_kernels_bwd(torch, cs, cfg):
    """Copy-score backward (K2) against the plain autograd backward at the
    training shape, f32, rtol 5e-4 / atol 5e-5 (the JAX package's gradient
    tolerance); the plain backward is timed on a retained graph, so it
    runs from the saved (B, T, S, D) intermediate, without the forward."""
    B, T = cfg.batch_size, cfg.tar_len
    S, D = cfg.sou_len + cfg.sub_token_len, cfg.embedding_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    src = torch.randn((B, S, D), device="cuda", generator=gen)
    tgt = torch.randn((B, T, D), device="cuda", generator=gen)
    w = torch.randn((D, 1), device="cuda", generator=gen) * 0.1
    dout = torch.randn((B, T, S), device="cuda", generator=gen)
    got = cs.copy_scores_backward(src, tgt, w, dout)
    leaves = [x.clone().requires_grad_() for x in (src, tgt, w)]
    out = cs.copy_scores_reference(*leaves, torch.zeros(1, device="cuda"))
    want = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    torch.cuda.synchronize()
    errs = {}
    for name, g, r in zip(("dsrc", "dtgt", "dw"), got, want):
        check(g.shape == r.shape and g.dtype == r.dtype,
              f"copy_score_bwd {name}: {tuple(g.shape)} {g.dtype}")
        check(bool(torch.isfinite(g).all()), f"copy_score_bwd {name}: "
              "non-finite")
        errs[name] = (g - r).abs().max().item()
        torch.testing.assert_close(g, r, rtol=5e-4, atol=5e-5)
    again = cs.copy_scores_backward(src, tgt, w, dout)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "copy_score_bwd: two runs on the same inputs differ")
    from fira_tpu_torch.ops.timing import time_ms

    w32 = w.reshape(-1).contiguous()
    ms = time_ms(lambda: cs.launch_backward(src, tgt, w32, dout))
    wrapper_ms = time_ms(lambda: cs.copy_scores_backward(src, tgt, w, dout))
    plain_ms = time_ms(lambda: torch.autograd.grad(
        out, leaves, dout, retain_graph=True), n=10)
    del out, leaves
    bound, by = copy_score_bwd_bound_ms(B, T, S, D, src.element_size())
    print(f"[kernels] copy_score_bwd train ({B},{T},{S},{D}) f32: max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol 5e-4, atol 5e-5), bitwise equal over two runs; kernel "
          f"(both launches) {ms:.4f} ms (wrapper with the dw sum "
          f"{wrapper_ms:.4f} ms), plain backward {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), kernel at {100 * bound / ms:.1f}% of "
          f"bound", flush=True)
    # large magnitudes beside ordinary values
    big = [with_large(torch, src, 0.05, gen), with_large(torch, tgt, 0.02, gen)]
    got = cs.copy_scores_backward(big[0], big[1], w, dout)
    want = cs.copy_scores_backward_reference(big[0], big[1], w, dout)
    torch.cuda.synchronize()
    big_errs = {}
    for name, g, r in zip(("dsrc", "dtgt", "dw"), got, want):
        check(bool(torch.isfinite(g).all()), f"copy_score_bwd large {name}: "
              "non-finite")
        big_errs[name] = (g - r).abs().max().item()
        torch.testing.assert_close(g, r, rtol=5e-4, atol=5e-5)
    print(f"[kernels] copy_score_bwd train shape, large magnitudes "
          f"(|src| or |tgt| 15-60 on 5 % / 2 % of entries): max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in big_errs.items())
          + " (rtol 5e-4, atol 5e-5)", flush=True)
    return dict(max_abs_err=max(errs.values()), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)


def write_corpus(data_dir: str) -> None:
    """Synthetic corpus with the vocabularies padded by filler tokens to
    the paper's sizes, so every width is fira-full's."""
    from fira_tpu_torch.data import synthetic

    synthetic.write_corpus_dir(data_dir, n_commits=N_COMMITS, seed=SEED)
    for fname, size in (("word_vocab.json", WORD_VOCAB),
                        ("ast_change_vocab.json", AST_VOCAB)):
        path = os.path.join(data_dir, fname)
        with open(path) as f:
            vocab = json.load(f)
        check(len(vocab) <= size, f"{fname} already holds {len(vocab)}")
        for i in range(size - len(vocab)):
            vocab[f"<filler_{i}>"] = len(vocab)
        with open(path, "w") as f:
            json.dump(vocab, f)


def phase_small_reference(torch, FiraModel, batch_to_device, make_batch,
                          ds, state_dict):
    """On two test commits, the card's encoder states, teacher-forced
    fused distribution (copy score at T=tar_len) and first cached step
    agree with the CPU's on the same weights: the largest difference is at
    most 1e-4 of the tensor's largest magnitude (f32 with TF32 off, through
    6 encoder rounds and 6 decoder layers whose sums run in another order
    on each device)."""
    cfg = ds.cfg
    host = make_batch(ds.splits["test"], list(range(2)), cfg, batch_size=2)
    outs = {}
    for dev in ("cpu", "cuda"):
        model = FiraModel(cfg, device=dev)
        model.load_state_dict(state_dict)
        model.eval()
        with torch.inference_mode():
            b = batch_to_device(host, torch.device(dev))
            states, mask = model.encode(b)
            msg = torch.from_numpy(host["msg"]).long().to(dev)
            fused = model.fused_probs(states, mask, msg, msg != 0)
            ck, cv, src = model.decode_init(states)
            L, H, T = cfg.num_layers, cfg.num_head, cfg.tar_len
            kc = torch.zeros((L, 2, H, T, cfg.embedding_dim // H), device=dev)
            valid = torch.zeros((2, 1, 1, T), dtype=torch.bool, device=dev)
            valid[..., 0] = True
            step, _, _ = model.fused_probs_step(mask, msg[:, :1], 0, kc,
                                                kc.clone(), ck, cv, src, valid)
        outs[dev] = [x.float().cpu() for x in (states, fused, step)]
    errs = []
    for name, a, b in zip(("states", "fused", "step"), outs["cpu"],
                          outs["cuda"]):
        check(bool(torch.isfinite(b).all()), f"{name}: non-finite on card")
        err = (a - b).abs().max().item()
        scale = a.abs().max().item()
        errs.append((name, err / scale))
        print(f"[plain] small input {name} {tuple(a.shape)}: card vs CPU "
              f"max_abs_err {err:.3e}, max |x| {scale:.3e}, ratio "
              f"{err / scale:.3e} (limit 1e-4)", flush=True)
    for name, ratio in errs:
        check(ratio <= 1e-4, f"small input {name}: card vs CPU {ratio:.3e}")


def device_mallocs(torch) -> int:
    """cudaMalloc calls made so far by PyTorch's caching allocator (a
    step that keeps allocating new blocks pays a device synchronisation
    for each)."""
    return int(torch.cuda.memory_stats().get("num_device_alloc", 0))


def profile_one(torch, label: str, fn, warm: int = 1) -> None:
    """``fn()`` once under torch.profiler after ``warm`` unprofiled runs:
    device time by kernel against the host-clock wall, so the share of the
    wall the card is idle shows how far the host holds it back."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only: the host ops that launched them carry the
    # same time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(r[1] for r in rows)
    check(device_us > 0, f"profile {label}: no device time traced")
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
          f"device busy {device_us / 1e3:.2f} ms = "
          f"{100 * device_us / wall_us:.1f}% (idle "
          f"{100 - 100 * device_us / wall_us:.1f}%), "
          f"{sum(r[2] for r in rows)} kernels and copies", flush=True)
    top = sorted(rows, key=lambda r: -r[1])
    for key, us, n in top[:8] + [r for r in top[8:] if "copy_score" in r[0]]:
        print(f"[profile]   {us / 1e3:8.3f} ms  x{n:<5d} "
              f"{100 * us / device_us:5.1f}%  {key[:90]}", flush=True)
    k1_us = sum(r[1] for r in rows if "copy_score_tile" in r[0]
                or "copy_score_row" in r[0])
    k2_us = sum(r[1] for r in rows if "copy_score_bwd" in r[0])
    if k1_us or k2_us:
        print(f"[profile] {label}: copy-score kernels K1 {k1_us / 1e3:.4f} "
              f"ms, K2 (both launches) {k2_us / 1e3:.4f} ms of "
              f"{device_us / 1e3:.2f} ms device time", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from fira_tpu_torch import cli
    from fira_tpu_torch.config import fira_full
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.decode.beam import beam_search_cached
    from fira_tpu_torch.decode.runner import (TRAIN_FIELDS, batch_to_device,
                                              run_test)
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.ops import build, copy_score as cs
    from fira_tpu_torch.ops.timing import smi_name_power
    from fira_tpu_torch.train import loop as train_loop
    from fira_tpu_torch.train.state import CheckpointManager, init_state
    from fira_tpu_torch.train.step import train_step

    cli.resolve_device("cuda")   # TF32 off, as the CLI runs
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_name_power()
    print(f"[device] {kind} x{count}; nvidia-smi: {smi}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    paths = build.build_all()
    print(f"[build] {len(paths)} kernel(s) in "
          f"{time.perf_counter() - t0:.1f} s -> "
          f"{', '.join(os.path.relpath(p, root) for p in paths.values())}",
          flush=True)
    for name, log in build.build_logs.items():
        for line in ptxas_summary(log):
            print(f"[build] {name}: {line}", flush=True)

    work = os.path.join(root, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data_dir, out_dir = os.path.join(work, "DataSet"), os.path.join(work, "out")
    write_corpus(data_dir)
    ds = FiraDataset(data_dir, fira_full())
    cfg = ds.cfg
    n_train, n_valid = len(ds.splits["train"]), len(ds.splits["valid"])
    n_test = len(ds.splits["test"])
    check(cfg.vocab_size == WORD_VOCAB and cfg.ast_change_vocab_size
          == AST_VOCAB and cfg.output_vocab_size == 25_020,
          f"widths {cfg.vocab_size}/{cfg.ast_change_vocab_size}")
    var_maps = cli._load_var_maps(data_dir)   # as the CLI passes them

    fwd_record = phase_kernels(torch, cs, cfg)
    bwd_record = phase_kernels_bwd(torch, cs, cfg)

    # --- main path, training: counts from zero around it only ---
    steps_per_epoch = math.ceil(n_train / cfg.batch_size)
    gated = cfg.replace(dev_start_epoch=0, dev_every_batches=2)
    ckpt_dir = os.path.join(work, "ckpt")
    cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mallocs = device_mallocs(torch)
    t0 = time.perf_counter()
    rc = cli.main(["train", "--config", "fira-full", "--data-dir", data_dir,
                   "--out-dir", os.path.join(work, "train_cli"), "--ckpt-dir",
                   os.path.join(work, "ckpt_cli"), "--epochs", "1"])
    check(rc == 0, f"cli train exited {rc}")
    cli_wall = time.perf_counter() - t0
    result = train_loop.train(ds, gated, device="cuda",
                              out_dir=os.path.join(work, "train"),
                              ckpt_dir=ckpt_dir, epochs=2, var_maps=var_maps,
                              resume=False)
    torch.cuda.synchronize()
    k1_train = cs.copy_scores.launches
    k2_train = cs.copy_scores_backward.launches
    train_peak = torch.cuda.max_memory_allocated()
    train_mallocs = device_mallocs(torch) - mallocs
    steps = steps_per_epoch + result.steps
    check(result.steps == 2 * steps_per_epoch,
          f"{result.steps} steps, expected {2 * steps_per_epoch}")
    check(k2_train == steps, f"copy_score_bwd launched {k2_train} times on "
          f"the train path, expected {steps} (one per step)")
    check(k1_train == steps + result.dev_batches,
          f"copy_score launched {k1_train} times on the train path, "
          f"expected {steps} steps + {result.dev_batches} dev batches")
    want_gates = 2 * math.ceil(steps_per_epoch / 2)
    check(result.gates == want_gates and result.dev_batches
          == want_gates * math.ceil(n_valid / cfg.test_batch_size),
          f"{result.gates} gates / {result.dev_batches} dev batches")
    check(all(math.isfinite(x) for x in result.losses),
          f"non-finite loss {result.losses}")
    with open(os.path.join(work, "train", "train_process")) as f:
        gate_lines = f.read().splitlines()
    check(len(gate_lines) == result.gates, f"{len(gate_lines)} gate lines")
    ckpt = CheckpointManager(ckpt_dir)
    check(ckpt.has(ckpt.LATEST), "no latest.pt after training")
    print(f"[train] cli train fira-full on {kind}: 1 epoch, "
          f"{steps_per_epoch} steps of batch {cfg.batch_size} over "
          f"{n_train} commits, wall {cli_wall:.2f} s incl. data load and "
          f"the first steps' set-up", flush=True)
    print(f"[train] train.loop.train with the gate (every 2 batches from "
          f"epoch 0): {result.steps} steps, {result.gates} gates x "
          f"{result.dev_batches // max(result.gates, 1)} dev batches "
          f"({n_valid} commits); steps/s {result.steps_per_sec:.3f}, "
          f"training commits/s {result.commits_per_sec:.2f} (dev gates, "
          f"checkpoint writes and the first interval excluded), feed share "
          f"{result.feed_stall_frac:.3f}; dev gates {result.dev_seconds:.2f} "
          f"s ({1e3 * result.dev_seconds / max(result.gates, 1):.0f} ms a "
          f"gate); best dev bleu {result.best_bleu:.4f}; losses "
          + " ".join(f"{x:.4f}" for x in result.losses), flush=True)
    print(f"[train] launches on the train path: copy_score {k1_train} "
          f"(expected {steps} steps + {result.dev_batches} dev batches), "
          f"copy_score_bwd {k2_train} (expected {steps}); peak device "
          f"memory {train_peak / 2**20:.1f} MiB; {train_mallocs} device "
          f"allocations by the caching allocator", flush=True)

    # --- the same steps with the plain copy score (this script's hook) ---
    state = init_state(gated, "cuda")
    state.model.copy_net.score_fn = cs.copy_scores_reference
    torch.cuda.reset_peak_memory_stats()
    mallocs = device_mallocs(torch)
    plain = train_loop.train(ds, gated.replace(dev_start_epoch=10**6),
                             device="cuda",
                             out_dir=os.path.join(work, "train_plain"),
                             ckpt_dir=os.path.join(work, "ckpt_plain"),
                             epochs=2, resume=False, state=state)
    plain_peak = torch.cuda.max_memory_allocated()
    plain_mallocs = device_mallocs(torch) - mallocs
    check(len(plain.losses) == len(result.losses), "plain step count")
    rel = max(abs(a - b) / abs(b) for a, b in zip(result.losses,
                                                  plain.losses))
    check(rel <= 1e-4, f"train losses kernel vs plain: largest relative "
          f"difference {rel:.3e} > 1e-4")
    print(f"[train plain] same steps, weights and dropout seed with the "
          f"plain copy score: losses agree to {rel:.3e} relative (limit "
          f"1e-4); steps/s {plain.steps_per_sec:.3f} (kernel "
          f"{result.steps_per_sec:.3f}), training commits/s "
          f"{plain.commits_per_sec:.2f} (kernel {result.commits_per_sec:.2f});"
          f" peak device memory {plain_peak / 2**20:.1f} MiB (kernel "
          f"{train_peak / 2**20:.1f}); {plain_mallocs} device allocations "
          f"in {plain.steps} steps (kernel path: {train_mallocs} in "
          f"{steps} steps and {result.gates} gates)", flush=True)

    # --- profile one warm training step, plain copy score then kernels ---
    host = make_batch(ds.splits["train"], list(range(cfg.batch_size)), cfg,
                      batch_size=cfg.batch_size)
    batch = batch_to_device(host, torch.device("cuda"), TRAIN_FIELDS)
    for label, fn in (("plain copy score", cs.copy_scores_reference),
                      ("kernels", cs.copy_scores)):
        state.model.copy_net.score_fn = fn
        profile_one(torch, f"one training step (batch {cfg.batch_size}, "
                    f"{label})", lambda: train_step(
                        state.model, state.optimizer, batch, state.generator))
    del state, batch

    # --- main path, test: the CLI decodes the trained checkpoint ---
    cs.copy_scores.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["test", "--config", "fira-full", "--data-dir", data_dir,
                   "--out-dir", out_dir, "--ckpt-dir", ckpt_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1_test = cs.copy_scores.launches
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"cli test exited {rc}")
    want = math.ceil(n_test / cfg.test_batch_size) * (cfg.tar_len - 1)
    check(k1_test == want, f"copy_score launched {k1_test} times on the "
          f"test path, expected {want}")
    out_file = os.path.join(out_dir, "output_fira")
    with open(out_file, "rb") as f:
        kernel_bytes = f.read()
    lines = kernel_bytes.decode().split("\n")[:-1]
    check(len(lines) == n_test, f"{len(lines)} output lines for {n_test}")
    check(sum(len(l.split()) for l in lines) > 0, "every prediction empty")
    print(f"[main] cli test fira-full on {kind}, trained checkpoint "
          f"({'best.pt' if ckpt.has(ckpt.BEST) else 'latest.pt'}): {n_test} "
          f"commits, {math.ceil(n_test / cfg.test_batch_size)} batches, "
          f"copy_score launches {k1_test} (expected {want}); wall "
          f"{wall:.2f} s incl. data and weight load = {n_test / wall:.2f} "
          f"commits/s; peak device memory {peak / 2**20:.1f} MiB", flush=True)

    # --- same decode, plain copy score swapped in by this script ---
    state_dict = (torch.load(ckpt.path(ckpt.BEST), weights_only=True)
                  if ckpt.has(ckpt.BEST) else ckpt.load_latest()["model"])
    model = FiraModel(cfg, device="cuda")
    model.load_state_dict(state_dict)
    rates = {"kernel": [], "plain": []}
    # in turns (kernel, plain, plain, kernel): the host clock drifts
    for label in ("kernel", "plain", "plain", "kernel"):
        model.copy_net.score_fn = (cs.copy_scores if label == "kernel"
                                   else cs.copy_scores_reference)
        out = os.path.join(work, f"out_{label}_{len(rates[label])}")
        t0 = time.perf_counter()
        run_test(model, ds, cfg, out_dir=out, var_maps=var_maps)
        torch.cuda.synchronize()
        rates[label].append(n_test / (time.perf_counter() - t0))
        with open(os.path.join(out, "output_fira"), "rb") as f:
            check(f.read() == kernel_bytes,
                  f"{label} decode output differs from the CLI's")
    print(f"[plain] decode with the plain copy score: output_fira "
          f"byte-identical to the kernel run ({len(kernel_bytes)} bytes); "
          f"decode loop commits/s, in turns kernel/plain/plain/kernel: "
          f"kernel {' '.join(f'{r:.2f}' for r in rates['kernel'])}, plain "
          f"{' '.join(f'{r:.2f}' for r in rates['plain'])}", flush=True)
    model.copy_net.score_fn = cs.copy_scores
    host = make_batch(ds.splits["test"], list(range(cfg.test_batch_size)),
                      cfg, batch_size=cfg.test_batch_size)
    batch = batch_to_device(host, torch.device("cuda"))
    profile_one(torch, f"one decode batch ({cfg.test_batch_size} commits, "
                f"{cfg.tar_len - 1} steps)",
                lambda: beam_search_cached(model, batch, cfg))
    del model, batch
    phase_small_reference(torch, FiraModel, batch_to_device, make_batch, ds,
                          state_dict)

    kernels = [
        dict(name="copy_score_fwd", route="cuda",
             source="fira_tpu_torch/ops/csrc/copy_score.cu",
             replaces="fira_tpu/ops/copy_score.py:119",
             launches=k1_train + k1_test, library_ms=None, **fwd_record),
        dict(name="copy_score_bwd", route="cuda",
             source="fira_tpu_torch/ops/csrc/copy_score_bwd.cu",
             replaces="fira_tpu/ops/copy_score.py:148",
             launches=k2_train, library_ms=None, **bwd_record)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
