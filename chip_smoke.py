#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fira_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device   the card's name, count, and nvidia-smi's name and power limit;
2. build    every hand-written kernel compiled with nvcc for sm_90a from
            the sources in this checkout (registers, shared memory, spills);
3. kernels  each kernel against its plain PyTorch version on the card at
            the shapes the main path gives it, timed with CUDA events
            (L2 flushed between launches), beside its bound;
4. main     the test path at fira-full width through the CLI entry point
            (``fira_tpu_torch.cli test`` on cuda) on a synthetic corpus with
            the paper's vocabulary sizes and random seeded weights; the
            kernel launch counts of this run must match the path;
5. plain    the same decode with the plain copy score swapped in by this
            script (the CLI never does): the output file must be
            byte-identical; and on a small input the card's distributions
            must agree with the CPU's.

The last three lines are the kernels' JSON record, nvidia-smi's name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA card, or
outside a checkout of the repository, it fails before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
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


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cold_ms(torch, fn, n: int = 50) -> float:
    """Median device time of ``fn()`` in ms over ``n`` launches, each
    after a 128 MB write that evicts the 50 MB L2 (the decode step finds
    the copy head's inputs cold: the decoder's weights and caches pass
    through L2 between two copy-score launches). A long matrix product
    queued first keeps the device busy while the host queues every launch,
    so the events time the device alone, not the host's launch overhead."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    hold = torch.ones((8192, 8192), device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    hold @ hold
    for _ in range(n):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[len(times) // 2]


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


def copy_score_bound_ms(B: int, T: int, S: int, D: int, itemsize: int):
    """Least time for the copy score on the H100: each input read once and
    the output written once, against the f32 operations (add, tanh, mul,
    accumulate per (b, t, s, d)); returns (ms, "bytes" | "operations")."""
    nbytes = (B * S * D + B * T * D + B * T * S) * itemsize + D * 4 + 4
    ops = 4 * B * T * S * D
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernels(torch, cs, cfg):
    """Copy score: kernel vs plain at the decode and training shapes (f32,
    rtol/atol 1e-5: the kernel sums D in another order) and one bf16 case
    (1e-2: one bf16 rounding of the result)."""
    B, K = cfg.test_batch_size, cfg.beam_size
    S, D = cfg.sou_len + cfg.sub_token_len, cfg.embedding_dim
    cases = [("decode", (B * K, 1, S, D), torch.float32, 1e-5),
             ("train", (cfg.batch_size, cfg.tar_len, S, D), torch.float32,
              1e-5),
             ("decode_bf16", (B * K, 1, S, D), torch.bfloat16, 1e-2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    record = None
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
        w32, out = w.reshape(-1).contiguous(), torch.empty_like(got)
        ms = time_cold_ms(torch, lambda: cs.launch(src, tgt, w32, out))
        wrapper_ms = time_cold_ms(torch,
                                  lambda: cs.copy_scores(src, tgt, w, bias))
        plain_ms = time_cold_ms(
            torch, lambda: cs.copy_scores_reference(src, tgt, w, bias), n=10)
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
        if name == "decode":
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by)
    return record


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


def phase_profile(torch, model, ds, make_batch, batch_to_device,
                  beam_search_cached):
    """One warm beam-decode batch under torch.profiler: device time by
    kernel against the host-clock wall, so the share of the wall the card
    is idle shows how far the host holds it back."""
    from torch.profiler import ProfilerActivity, profile

    cfg = ds.cfg
    host = make_batch(ds.splits["test"], list(range(cfg.test_batch_size)),
                      cfg, batch_size=cfg.test_batch_size)
    batch = batch_to_device(host, torch.device("cuda"))
    beam_search_cached(model, batch, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        beam_search_cached(model, batch, cfg)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # device-side events only: the host ops that launched them carry the
    # same time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(r[1] for r in rows)
    print(f"[profile] one decode batch ({cfg.test_batch_size} commits, "
          f"{cfg.tar_len - 1} steps): wall {wall_us / 1e3:.2f} ms (profiler "
          f"on), device busy {device_us / 1e3:.2f} ms = "
          f"{100 * device_us / wall_us:.1f}% (idle "
          f"{100 - 100 * device_us / wall_us:.1f}%), "
          f"{sum(r[2] for r in rows)} kernels and copies", flush=True)
    top = sorted(rows, key=lambda r: -r[1])
    for key, us, n in top[:8] + [r for r in top[8:] if "copy_score" in r[0]]:
        print(f"[profile]   {us / 1e3:8.3f} ms  x{n:<5d} {key[:90]}",
              flush=True)


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
    from fira_tpu_torch.decode.runner import batch_to_device, run_test
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.ops import build, copy_score as cs

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
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    work = os.path.join(root, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data_dir, out_dir = os.path.join(work, "DataSet"), os.path.join(work, "out")
    ckpt_dir = os.path.join(work, "ckpt")
    write_corpus(data_dir)
    ds = FiraDataset(data_dir, fira_full())
    cfg = ds.cfg
    n_test = len(ds.splits["test"])
    check(cfg.vocab_size == WORD_VOCAB and cfg.ast_change_vocab_size
          == AST_VOCAB and cfg.output_vocab_size == 25_020,
          f"widths {cfg.vocab_size}/{cfg.ast_change_vocab_size}")

    record = phase_kernels(torch, cs, cfg)

    model = FiraModel(cfg).init_parameters(
        torch.Generator().manual_seed(SEED))
    os.makedirs(ckpt_dir)
    state_dict = model.state_dict()
    torch.save(state_dict, os.path.join(ckpt_dir, "best.pt"))
    del model

    # --- main path: the CLI on cuda; counts from zero around it only ---
    cs.copy_scores.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["test", "--config", "fira-full", "--data-dir", data_dir,
                   "--out-dir", out_dir, "--ckpt-dir", ckpt_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cs.copy_scores.launches
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"cli test exited {rc}")
    want = math.ceil(n_test / cfg.test_batch_size) * (cfg.tar_len - 1)
    check(launches == want, f"copy_score launched {launches} times on the "
          f"main path, expected {want}")
    out_file = os.path.join(out_dir, "output_fira")
    with open(out_file, "rb") as f:
        kernel_bytes = f.read()
    lines = kernel_bytes.decode().split("\n")[:-1]
    check(len(lines) == n_test, f"{len(lines)} output lines for {n_test}")
    check(sum(len(l.split()) for l in lines) > 0, "every prediction empty")
    print(f"[main] cli test fira-full on {kind}: {n_test} commits, "
          f"{math.ceil(n_test / cfg.test_batch_size)} batches, copy_score "
          f"launches {launches} (expected {want}); wall {wall:.2f} s incl. "
          f"data and weight load = {n_test / wall:.2f} commits/s; peak "
          f"device memory {peak / 2**20:.1f} MiB", flush=True)

    # --- same decode, plain copy score swapped in by this script ---
    model = FiraModel(cfg, device="cuda")
    model.load_state_dict(state_dict)
    var_maps = cli._load_var_maps(data_dir)   # as the CLI passes them
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
    phase_profile(torch, model, ds, make_batch, batch_to_device,
                  beam_search_cached)
    del model
    phase_small_reference(torch, FiraModel, batch_to_device, make_batch, ds,
                          state_dict)

    kernels = [dict(
        name="copy_score_fwd", route="cuda",
        source="fira_tpu_torch/ops/csrc/copy_score.cu",
        replaces="fira_tpu/ops/copy_score.py:119", launches=launches,
        library_ms=None, **record)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
