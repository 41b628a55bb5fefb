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
            also on inputs with entries of magnitude 15-60 and bitwise
            equal over two launches), at a batch of 85 (the tile kernel's
            third tiling), and the three path shapes in bf16; K2 (its
            backward) at the training shape in f32 (also at magnitudes
            15-60) and in bf16;
4. train    for f32 and then bf16, the training path at fira-full width
            on a synthetic corpus with the paper's vocabulary sizes and
            random seeded weights, counts from zero around each: one epoch
            through ``cli train --dtype`` (f32 with ``--feeder-workers 0``,
            bf16 with 2), then two epochs with the dev gate (every 2
            batches from epoch 0) through ``train.loop.train`` with the
            Feeder's 2 workers; K2 must launch once per step and K1 once
            per step and per dev batch;
5. train plain  the same steps from the same weights and dropout seed with
            the plain copy score swapped in by this script (no entry point
            does): the per-step losses must agree (f32 1e-4; bf16 within
            the plain bf16 run's gap to the plain f32 run);
6. feed     the same training steps with the Feeder's 2 workers and with
            0 (the loop's own thread assembles), in turns;
7. dev gate ``dev_predict`` ids and ``dev_output`` under K1 against the
            plain copy score on the trained weights (f32 must be equal);
8. profile  one warm training step of each dtype under torch.profiler
            (f32 also with the plain copy score), device busy summed over
            kernels, memcpy and memset;
9. main     for f32 and then bf16, the test path through ``cli test
            --dtype``, decoding that dtype's trained checkpoint; the K1
            launch count must match the path; B-Norm BLEU, Penalty-BLEU
            and ROUGE-L of its output;
10. plain   the same decodes with the plain copy score: f32 byte-identical,
            bf16 lines that differ counted; one decode batch of each dtype
            profiled; on a small input the card's f32 distributions must
            agree with the CPU's.

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
# per-step losses of the kernel run against the plain run, f32: 1e-4
# relative. In bf16 a kernel's output may differ from its plain version's
# by one rounding of a score (2^-8 of its size), one of the roundings bf16
# makes everywhere in the model; so the bf16 runs are held to the gap
# between the plain bf16 and the plain f32 runs over the same steps (the
# largest per-step relative difference): a copy-score fault that moves
# training by more than all of bf16's roundings together fails
F32_LOSS_RTOL = 1e-4


def dname(dtype) -> str:
    """float32 / bfloat16 for a torch dtype."""
    return str(dtype).rsplit(".", 1)[-1]


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
    a batch of 85, and the same three shapes in bf16 (1e-2: one bf16
    rounding of the result). Returns the f32 and the bf16 record: the
    decode shape's numbers, with the dev and training shapes' under
    ``dev_*`` and ``train_*``."""
    from fira_tpu_torch.ops.timing import time_ms

    B, K = cfg.test_batch_size, cfg.beam_size
    S, D = cfg.sou_len + cfg.sub_token_len, cfg.embedding_dim
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("decode", (B * K, 1, S, D), f32, 1e-5),
             ("dev", (B, cfg.tar_len, S, D), f32, 1e-5),
             ("train", (cfg.batch_size, cfg.tar_len, S, D), f32, 1e-5),
             # the main path pads every batch to full size, so it gives the
             # tile kernel 128 s a block (train) and 32 (dev); a batch of
             # 85 takes the third tiling, 64 s a block and 2 slices of d
             ("batch85", (85, cfg.tar_len, S, D), f32, 1e-5),
             ("decode", (B * K, 1, S, D), bf16, 1e-2),
             ("dev", (B, cfg.tar_len, S, D), bf16, 1e-2),
             ("train", (cfg.batch_size, cfg.tar_len, S, D), bf16, 1e-2)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    records = {f32: {}, bf16: {}}
    for name, (b, t, s, d), dtype, tol in cases:
        src = torch.randn((b, s, d), device="cuda", generator=gen).to(dtype)
        tgt = torch.randn((b, t, d), device="cuda", generator=gen).to(dtype)
        w = torch.randn((d, 1), device="cuda", generator=gen) * 0.1
        bias = torch.randn((1,), device="cuda", generator=gen)
        got = cs.copy_scores(src, tgt, w, bias)
        want = cs.copy_scores_reference(src, tgt, w, bias)
        torch.cuda.synchronize()
        label = f"{name} {dname(dtype)}"
        check(got.shape == (b, t, s) and got.dtype == dtype,
              f"copy_score {label}: shape {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()),
              f"copy_score {label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if name == "train":
            check(torch.equal(got, cs.copy_scores(src, tgt, w, bias)),
                  f"copy_score {label}: two launches on the same inputs "
                  f"differ")
        if name == "train" and dtype == f32:
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
        if name == "decode" and dtype == f32:
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
              f"max_abs_err {err:.3e} (rtol/atol {tol}); kernel {ms:.4f} ms "
              f"(wrapper with bias add {wrapper_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"kernel at {100 * bound / ms:.1f}% of bound", flush=True)
        if name in ("decode", "dev", "train"):
            pre = "" if name == "decode" else f"{name}_"
            records[dtype].update({
                f"{pre}max_abs_err": err, f"{pre}ms": ms,
                f"{pre}plain_ms": plain_ms, f"{pre}bound_ms": bound,
                f"{pre}bound_by": by})
        del src, tgt, got, want
    return records[f32], records[bf16]


def phase_kernels_bwd(torch, cs, cfg, dtype):
    """Copy-score backward (K2) against the plain autograd backward at the
    training shape. f32: rtol 5e-4 / atol 5e-5 (the JAX package's gradient
    tolerance), also on inputs of magnitude 15-60. bf16: the plain f32
    autograd on the same bf16 values at 2e-2 (dsrc and dtgt round once to
    bf16). The plain backward is timed on a retained graph of the plain
    version on the same inputs, so it runs from the saved (B, T, S, D)
    intermediate, without the forward."""
    B, T = cfg.batch_size, cfg.tar_len
    S, D = cfg.sou_len + cfg.sub_token_len, cfg.embedding_dim
    bf16 = dtype == torch.bfloat16
    rtol, atol = (2e-2, 2e-2) if bf16 else (5e-4, 5e-5)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    src = torch.randn((B, S, D), device="cuda", generator=gen).to(dtype)
    tgt = torch.randn((B, T, D), device="cuda", generator=gen).to(dtype)
    w = torch.randn((D, 1), device="cuda", generator=gen) * 0.1
    dout = torch.randn((B, T, S), device="cuda", generator=gen).to(dtype)
    got = cs.copy_scores_backward(src, tgt, w, dout)
    want = cs.copy_scores_backward_reference(src.float(), tgt.float(), w,
                                             dout.float())
    torch.cuda.synchronize()
    errs = {}
    for name, g, r, want_dtype in zip(("dsrc", "dtgt", "dw"), got, want,
                                      (dtype, dtype, w.dtype)):
        check(g.shape == r.shape and g.dtype == want_dtype,
              f"copy_score_bwd {name}: {tuple(g.shape)} {g.dtype}")
        check(bool(torch.isfinite(g).all()), f"copy_score_bwd {name}: "
              "non-finite")
        errs[name] = (g.float() - r).abs().max().item()
        torch.testing.assert_close(g.float(), r, rtol=rtol, atol=atol)
    del want
    again = cs.copy_scores_backward(src, tgt, w, dout)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "copy_score_bwd: two runs on the same inputs differ")
    from fira_tpu_torch.ops.timing import time_ms

    w32 = w.reshape(-1).contiguous()
    ms = time_ms(lambda: cs.launch_backward(src, tgt, w32, dout))
    wrapper_ms = time_ms(lambda: cs.copy_scores_backward(src, tgt, w, dout))
    leaves = [x.clone().requires_grad_() for x in (src, tgt, w)]
    out = cs.copy_scores_reference(*leaves, torch.zeros(1, device="cuda"))
    plain_ms = time_ms(lambda: torch.autograd.grad(
        out, leaves, dout, retain_graph=True), n=10)
    del out, leaves
    bound, by = copy_score_bwd_bound_ms(B, T, S, D, src.element_size())
    print(f"[kernels] copy_score_bwd train ({B},{T},{S},{D}) "
          f"{dname(dtype)}: max_abs_err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {rtol}, atol {atol}), bitwise equal over two runs; "
          f"kernel (both launches) {ms:.4f} ms (wrapper with the dw sum "
          f"{wrapper_ms:.4f} ms), plain backward {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), kernel at {100 * bound / ms:.1f}% of "
          f"bound", flush=True)
    if not bf16:
        # large magnitudes beside ordinary values
        big = [with_large(torch, src, 0.05, gen),
               with_large(torch, tgt, 0.02, gen)]
        got = cs.copy_scores_backward(big[0], big[1], w, dout)
        want = cs.copy_scores_backward_reference(big[0], big[1], w, dout)
        torch.cuda.synchronize()
        big_errs = {}
        for name, g, r in zip(("dsrc", "dtgt", "dw"), got, want):
            check(bool(torch.isfinite(g).all()),
                  f"copy_score_bwd large {name}: non-finite")
            big_errs[name] = (g - r).abs().max().item()
            torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
        print(f"[kernels] copy_score_bwd train shape, large magnitudes "
              f"(|src| or |tgt| 15-60 on 5 % / 2 % of entries): max_abs_err "
              + ", ".join(f"{k} {v:.3e}" for k, v in big_errs.items())
              + f" (rtol {rtol}, atol {atol})", flush=True)
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


DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_ops(torch, prof):
    """(kept, dropped): the traced device events as (name, us) pairs,
    kernels, memcpy and memset kept, anything else (user ranges such as
    ``Optimizer.step#Adam.step``, which the trace also shows on the device
    and whose span covers kernels already counted) dropped. Where the
    events carry no activity type, user annotations are dropped."""
    kept, dropped = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        act = getattr(e, "activity_type", None)
        if act is not None and str(act) != "":
            keep = str(act) in DEVICE_ACTIVITIES
        else:
            keep = not getattr(e, "is_user_annotation", False)
        (kept if keep else dropped).append(
            (e.name, e.time_range.elapsed_us()))
    return kept, dropped


def profile_one(torch, label: str, fn, warm: int = 1) -> dict:
    """``fn()`` once under torch.profiler after ``warm`` unprofiled runs:
    device time by kernel against the host-clock wall, so the share of the
    wall the card is idle shows how far the host holds it back. Device
    busy sums kernels, memcpy and memset only (``device_ops``)."""
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
    kept, dropped = device_ops(torch, prof)
    by_name = {}
    for name, us in kept:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, n + 1)
    rows = [(k, us, n) for k, (us, n) in by_name.items()]
    device_us = sum(r[1] for r in rows)
    check(device_us > 0, f"profile {label}: no device time traced")
    print(f"[profile] {label}: wall {wall_us / 1e3:.2f} ms (profiler on), "
          f"device busy {device_us / 1e3:.2f} ms = "
          f"{100 * device_us / wall_us:.1f}% (idle "
          f"{100 - 100 * device_us / wall_us:.1f}%), "
          f"{len(kept)} kernels and copies; left out of the sum: "
          f"{len(dropped)} other device rows of "
          f"{sum(us for _, us in dropped) / 1e3:.2f} ms"
          + "".join(f" ({n[:40]} {us / 1e3:.2f} ms)"
                    for n, us in sorted(dropped, key=lambda r: -r[1])[:2]),
          flush=True)
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
    return dict(wall_ms=wall_us / 1e3, busy_ms=device_us / 1e3)


def write_ground_truth(ds, var_maps, path: str) -> None:
    """The test split's reference messages, one a line, de-anonymised as
    ``output_fira`` is (the reference's Metrics/ flow)."""
    from fira_tpu_torch.decode.text import deanonymize, reference_words

    split, idx = ds.splits["test"], ds.split_indices["test"]
    lines = []
    for i in range(len(split)):
        words = reference_words(split.arrays["msg"][i], ds.word_vocab)
        vm = var_maps[idx[i]] if var_maps is not None else None
        lines.append(" ".join(deanonymize(words, vm)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def paper_metrics(out_file: str, gt_file: str) -> str:
    """The port's B-Norm BLEU, Penalty-BLEU and ROUGE-L of a decode."""
    from fira_tpu_torch.eval import (bnorm_bleu_files, penalty_bleu_files,
                                     rouge_l_files)

    return (f"B-Norm BLEU {bnorm_bleu_files(out_file, gt_file)!r}, "
            f"Penalty-BLEU {penalty_bleu_files(out_file, gt_file)!r}, "
            f"ROUGE-L {rouge_l_files(out_file, gt_file)!r}")


def train_path(torch, ctx, dtype: str, cli_workers: int) -> dict:
    """One dtype's training path, counts from zero around it only: one
    epoch through ``cli train`` (``--feeder-workers cli_workers``), then
    two epochs with the dev gate (every 2 batches from epoch 0) through
    ``train.loop.train`` with the config's feeder (2 workers). K2 must
    launch once per step and K1 once per step and per dev batch."""
    from fira_tpu_torch import cli
    from fira_tpu_torch.train import loop as train_loop
    from fira_tpu_torch.train.state import CheckpointManager

    cs, ds, work, cfg = ctx["cs"], ctx["ds"], ctx["work"], ctx["cfg"]
    n_train, n_valid = len(ds.splits["train"]), len(ds.splits["valid"])
    steps_per_epoch = math.ceil(n_train / cfg.batch_size)
    gated = cfg.replace(dev_start_epoch=0, dev_every_batches=2,
                        compute_dtype=dtype)
    ckpt_dir = os.path.join(work, f"ckpt_{dtype}")
    cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    mallocs = device_mallocs(torch)
    t0 = time.perf_counter()
    rc = cli.main(["train", "--config", "fira-full", "--data-dir",
                   ctx["data_dir"], "--out-dir",
                   os.path.join(work, f"train_cli_{dtype}"), "--ckpt-dir",
                   os.path.join(work, f"ckpt_cli_{dtype}"), "--epochs", "1",
                   "--dtype", dtype, "--feeder-workers", str(cli_workers)])
    check(rc == 0, f"cli train --dtype {dtype} exited {rc}")
    cli_wall = time.perf_counter() - t0
    result = train_loop.train(ds, gated, device="cuda",
                              out_dir=os.path.join(work, f"train_{dtype}"),
                              ckpt_dir=ckpt_dir, epochs=2,
                              var_maps=ctx["var_maps"], resume=False)
    torch.cuda.synchronize()
    k1, k2 = cs.copy_scores.launches, cs.copy_scores_backward.launches
    peak = torch.cuda.max_memory_allocated()
    n_mallocs = device_mallocs(torch) - mallocs
    steps = steps_per_epoch + result.steps
    check(result.steps == 2 * steps_per_epoch,
          f"{dtype}: {result.steps} steps, expected {2 * steps_per_epoch}")
    check(k2 == steps, f"{dtype}: copy_score_bwd launched {k2} times on the "
          f"train path, expected {steps} (one per step)")
    check(k1 == steps + result.dev_batches,
          f"{dtype}: copy_score launched {k1} times on the train path, "
          f"expected {steps} steps + {result.dev_batches} dev batches")
    want_gates = 2 * math.ceil(steps_per_epoch / 2)
    check(result.gates == want_gates and result.dev_batches
          == want_gates * math.ceil(n_valid / cfg.test_batch_size),
          f"{dtype}: {result.gates} gates / {result.dev_batches} dev batches")
    check(all(math.isfinite(x) for x in result.losses),
          f"{dtype}: non-finite loss {result.losses}")
    with open(os.path.join(work, f"train_{dtype}", "train_process")) as f:
        gate_lines = f.read().splitlines()
    check(len(gate_lines) == result.gates, f"{len(gate_lines)} gate lines")
    ckpt = CheckpointManager(ckpt_dir)
    check(ckpt.has(ckpt.LATEST), "no latest.pt after training")
    sd = (torch.load(ckpt.path(ckpt.BEST), weights_only=True)
          if ckpt.has(ckpt.BEST) else ckpt.load_latest()["model"])
    check(all(v.dtype == torch.float32 for v in sd.values()),
          f"{dtype}: checkpoint not f32")
    fd = result.feeder
    print(f"[train {dtype}] cli train fira-full --dtype {dtype} "
          f"--feeder-workers {cli_workers} on {ctx['kind']}: 1 epoch, "
          f"{steps_per_epoch} steps of batch {cfg.batch_size} over {n_train} "
          f"commits, wall {cli_wall:.2f} s incl. data load and the first "
          f"steps' set-up (its feed share is on the CLI's own line above)",
          flush=True)
    print(f"[train {dtype}] train.loop.train with the gate (every 2 batches "
          f"from epoch 0), feeder workers {cfg.feeder_workers}: "
          f"{result.steps} steps, {result.gates} gates x "
          f"{result.dev_batches // max(result.gates, 1)} dev batches "
          f"({n_valid} commits); steps/s {result.steps_per_sec:.3f}, "
          f"training commits/s {result.commits_per_sec:.2f} (dev gates, "
          f"checkpoint writes and the first interval excluded), feed share "
          f"{result.feed_stall_frac:.4f} (queue depth mean "
          f"{fd['queue_depth_mean']:.2f}, min {fd['queue_depth_min']:.0f}); "
          f"dev gates {result.dev_seconds:.2f} s "
          f"({1e3 * result.dev_seconds / max(result.gates, 1):.0f} ms a "
          f"gate); best dev bleu {result.best_bleu:.4f}; losses "
          + " ".join(f"{x:.4f}" for x in result.losses), flush=True)
    print(f"[train {dtype}] launches on the train path: copy_score {k1} "
          f"(expected {steps} steps + {result.dev_batches} dev batches), "
          f"copy_score_bwd {k2} (expected {steps}); peak device memory "
          f"{peak / 2**20:.1f} MiB; {n_mallocs} device allocations by the "
          f"caching allocator", flush=True)
    return dict(result=result, gated=gated, k1=k1, k2=k2, peak=peak,
                steps=steps, ckpt_dir=ckpt_dir, mallocs=n_mallocs,
                state_dict=sd)


def max_rel(a, b) -> float:
    """Largest per-step relative difference of losses ``a`` from ``b``."""
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def train_plain(torch, ctx, run: dict, rtol=None, f32_plain=None) -> list:
    """The same steps from the same weights and dropout seed with the
    plain copy score swapped in by this script (no entry point does): the
    per-step losses must agree within ``rtol`` relative, or (bf16, ``rtol``
    None) within this plain run's gap to the plain f32 run's losses
    ``f32_plain``. Returns the plain run's losses."""
    from fira_tpu_torch.train import loop as train_loop
    from fira_tpu_torch.train.state import init_state

    cs, work, gated = ctx["cs"], ctx["work"], run["gated"]
    dtype, result = gated.compute_dtype, run["result"]
    state = init_state(gated, "cuda")
    state.model.copy_net.score_fn = cs.copy_scores_reference
    torch.cuda.reset_peak_memory_stats()
    mallocs = device_mallocs(torch)
    plain = train_loop.train(ctx["ds"], gated.replace(dev_start_epoch=10**6),
                             device="cuda",
                             out_dir=os.path.join(work, f"plain_{dtype}"),
                             ckpt_dir=os.path.join(work, f"ckptp_{dtype}"),
                             epochs=2, resume=False, state=state)
    peak = torch.cuda.max_memory_allocated()
    n_mallocs = device_mallocs(torch) - mallocs
    check(len(plain.losses) == len(result.losses), "plain step count")
    rel = max_rel(result.losses, plain.losses)
    limit = "fixed"
    if rtol is None:
        check(len(f32_plain) == len(plain.losses), "f32 plain step count")
        rtol = max_rel(plain.losses, f32_plain)
        limit = "the plain bf16 run's gap to the plain f32 run"
    check(rel <= rtol, f"{dtype} train losses kernel vs plain: largest "
          f"relative difference {rel:.3e} > {rtol:.3e} ({limit})")
    print(f"[train plain {dtype}] same steps, weights and dropout seed with "
          f"the plain copy score: losses agree to {rel:.3e} relative (limit "
          f"{rtol:.3e}, {limit}); steps/s {plain.steps_per_sec:.3f} (kernel "
          f"{result.steps_per_sec:.3f}), training commits/s "
          f"{plain.commits_per_sec:.2f} (kernel {result.commits_per_sec:.2f});"
          f" peak device memory {peak / 2**20:.1f} MiB (kernel "
          f"{run['peak'] / 2**20:.1f}); {n_mallocs} device allocations "
          f"in {plain.steps} steps (kernel path: {run['mallocs']} in "
          f"{run['steps']} steps and {result.gates} gates)", flush=True)
    return plain.losses


def feed_designs(torch, ctx, dtype: str) -> None:
    """The same training steps with the Feeder's 2 workers assembling (the
    path's design) and with 0 (the loop's own thread assembles), in turns
    a b b a; the loop issues the copies to the card in both. Each: 16
    steps (4 epochs of 4) after a warm epoch, host wall to a synchronise,
    and the share of it the loop spent in the Feeder."""
    from fira_tpu_torch.data.batching import epoch_index_chunks
    from fira_tpu_torch.data.feeder import (TRAIN_FIELDS, Feeder,
                                            assembly_tasks)
    from fira_tpu_torch.train.state import init_state
    from fira_tpu_torch.train.step import train_step

    ds, cfg = ctx["ds"], ctx["cfg"].replace(compute_dtype=dtype)
    split, dev = ds.splits["train"], torch.device("cuda")
    state = init_state(cfg, dev)

    def run(workers: int, epochs) -> tuple:
        stall = 0.0
        n = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for epoch in epochs:
            chunks = epoch_index_chunks(len(split), cfg, shuffle=True,
                                        seed=cfg.seed, epoch=epoch)
            with Feeder(assembly_tasks(split, chunks, cfg,
                                       batch_size=cfg.batch_size),
                        num_workers=workers, depth=cfg.feeder_depth,
                        device=dev, fields=TRAIN_FIELDS) as feed:
                for item in feed:
                    stall += item.stall_s
                    train_step(state.model, state.optimizer, item.device,
                               state.generator)
                    n += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return n / wall, stall / wall

    run(2, [0])   # warm: kernels built and launched, allocator filled
    got = {2: [], 0: []}
    for workers in (2, 0, 0, 2):
        got[workers].append(run(workers, [1, 2, 3, 4]))
    print(f"[feed {dtype}] the same 16 steps with 2 Feeder workers and with "
          f"0, in turns a b b a: "
          + "; ".join(f"workers {k}: steps/s "
                      + " ".join(f"{r[0]:.3f}" for r in v) + ", feed share "
                      + " ".join(f"{r[1]:.4f}" for r in v)
                      for k, v in got.items()), flush=True)
    del state


def test_path(torch, ctx, run: dict) -> dict:
    """One dtype's test path, counts from zero around it only: ``cli test
    --dtype`` decodes the checkpoint this dtype's training wrote; the K1
    launch count must match the path; the paper's metrics of the output."""
    from fira_tpu_torch import cli
    from fira_tpu_torch.train.state import CheckpointManager

    cs, ds, work, cfg = ctx["cs"], ctx["ds"], ctx["work"], ctx["cfg"]
    dtype = run["gated"].compute_dtype
    n_test = len(ds.splits["test"])
    out_dir = os.path.join(work, f"out_{dtype}")
    cs.copy_scores.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["test", "--config", "fira-full", "--data-dir",
                   ctx["data_dir"], "--out-dir", out_dir, "--ckpt-dir",
                   run["ckpt_dir"], "--dtype", dtype])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"cli test --dtype {dtype} exited {rc}")
    want = math.ceil(n_test / cfg.test_batch_size) * (cfg.tar_len - 1)
    check(k1 == want, f"{dtype}: copy_score launched {k1} times on the "
          f"test path, expected {want}")
    out_file = os.path.join(out_dir, "output_fira")
    with open(out_file, "rb") as f:
        out_bytes = f.read()
    lines = out_bytes.decode().split("\n")[:-1]
    check(len(lines) == n_test, f"{len(lines)} output lines for {n_test}")
    check(sum(len(l.split()) for l in lines) > 0, "every prediction empty")
    ckpt = CheckpointManager(run["ckpt_dir"])
    print(f"[main {dtype}] cli test fira-full --dtype {dtype} on "
          f"{ctx['kind']}, trained checkpoint "
          f"({'best.pt' if ckpt.has(ckpt.BEST) else 'latest.pt'}, f32): "
          f"{n_test} commits, {math.ceil(n_test / cfg.test_batch_size)} "
          f"batches, copy_score launches {k1} (expected {want}); wall "
          f"{wall:.2f} s incl. data and weight load = {n_test / wall:.2f} "
          f"commits/s; peak device memory {peak / 2**20:.1f} MiB", flush=True)
    print(f"[main {dtype}] metrics of output_fira: "
          f"{paper_metrics(out_file, ctx['gt_file'])}", flush=True)
    return dict(k1=k1, out_bytes=out_bytes, out_file=out_file)


def decode_plain(torch, ctx, run: dict, main: dict) -> None:
    """The same decode with the plain copy score swapped in, in turns
    kernel/plain/plain/kernel. f32: byte-identical to the CLI's output.
    bf16: the lines that differ are counted (a one-step bf16 rounding
    difference can flip a near-tie in the beam), and the plain decode's
    metrics printed."""
    from fira_tpu_torch.decode.runner import run_test
    from fira_tpu_torch.model.model import FiraModel

    cs, ds, work, cfg = ctx["cs"], ctx["ds"], ctx["work"], ctx["cfg"]
    dtype = run["gated"].compute_dtype
    n_test = len(ds.splits["test"])
    model = FiraModel(cfg, device="cuda", dtype=dtype)
    model.load_state_dict(run["state_dict"])
    rates = {"kernel": [], "plain": []}
    outs = {}
    for label in ("kernel", "plain", "plain", "kernel"):
        model.copy_net.score_fn = (cs.copy_scores if label == "kernel"
                                   else cs.copy_scores_reference)
        out = os.path.join(work, f"dec_{dtype}_{label}_{len(rates[label])}")
        t0 = time.perf_counter()
        run_test(model, ds, cfg.replace(compute_dtype=dtype), out_dir=out,
                 var_maps=ctx["var_maps"])
        torch.cuda.synchronize()
        rates[label].append(n_test / (time.perf_counter() - t0))
        with open(os.path.join(out, "output_fira"), "rb") as f:
            outs.setdefault(label, set()).add(f.read())
        outs.setdefault(f"{label}_file", os.path.join(out, "output_fira"))
    check(outs["kernel"] == {main["out_bytes"]},
          f"{dtype}: kernel decode output differs from the CLI's")
    check(len(outs["plain"]) == 1, f"{dtype}: two plain decodes differ")
    plain_bytes = next(iter(outs["plain"]))
    a = main["out_bytes"].decode().split("\n")
    b = plain_bytes.decode().split("\n")
    n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    if dtype == "float32":
        check(plain_bytes == main["out_bytes"],
              "f32 plain decode output differs from the kernel run")
    print(f"[plain {dtype}] decode with the plain copy score: "
          + ("output_fira byte-identical to the kernel run "
             f"({len(plain_bytes)} bytes)" if plain_bytes == main["out_bytes"]
             else f"{n_diff} of {n_test} lines of output_fira differ from the "
                  f"kernel run")
          + f"; decode loop commits/s, in turns kernel/plain/plain/kernel: "
          f"kernel {' '.join(f'{r:.2f}' for r in rates['kernel'])}, plain "
          f"{' '.join(f'{r:.2f}' for r in rates['plain'])}", flush=True)
    if plain_bytes != main["out_bytes"]:
        print(f"[plain {dtype}] metrics of the plain decode: "
              f"{paper_metrics(outs['plain_file'], ctx['gt_file'])}",
              flush=True)


def dev_gate_check(torch, ctx, run: dict) -> None:
    """The dev gate under K1 (T = tar_len, the tile kernel) against the
    plain copy score on the same weights: ``dev_predict`` ids of every dev
    batch and the gate's ``dev_output`` text. f32 must agree exactly; in
    bf16 the differing ids and lines are counted."""
    from fira_tpu_torch.data.batching import epoch_index_chunks, make_batch
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.train import loop as train_loop

    cs, ds, cfg = ctx["cs"], ctx["ds"], ctx["cfg"]
    dtype = run["gated"].compute_dtype
    model = FiraModel(cfg, device="cuda", dtype=dtype)
    model.load_state_dict(run["state_dict"])
    split = ds.splits["valid"]
    ids, texts = {}, {}
    for label, fn in (("kernel", cs.copy_scores),
                      ("plain", cs.copy_scores_reference)):
        model.copy_net.score_fn = fn
        got = []
        for chunk in epoch_index_chunks(len(split), cfg,
                                        batch_size=cfg.test_batch_size):
            host = make_batch(split, chunk, cfg.replace(compute_dtype=dtype),
                              batch_size=cfg.test_batch_size)
            b = batch_to_device(host, torch.device("cuda"), TRAIN_FIELDS)
            got.append(model.dev_predict(b)[host["valid"]].cpu())
        ids[label] = torch.cat(got)
        _, texts[label], _ = train_loop.run_dev(
            model, ds, cfg.replace(compute_dtype=dtype), ctx["var_maps"])
    n_ids = int((ids["kernel"] != ids["plain"]).sum())
    ka, pa = texts["kernel"].split("\n"), texts["plain"].split("\n")
    n_lines = sum(x != y for x, y in zip(ka, pa))
    print(f"[dev gate {dtype}] dev_predict under K1 vs the plain copy score "
          f"on the trained weights, {len(split)} commits x {cfg.tar_len} "
          f"positions: {n_ids} of {ids['kernel'].numel()} ids differ, "
          f"{n_lines} of {len(ka) - 1} dev_output lines differ", flush=True)
    if dtype == "float32":
        check(n_ids == 0 and texts["kernel"] == texts["plain"],
              f"f32 dev gate: {n_ids} ids, {n_lines} dev_output lines "
              f"differ between K1 and the plain copy score")


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
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
    from fira_tpu_torch.decode.beam import beam_search_cached
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.ops import build, copy_score as cs
    from fira_tpu_torch.ops.timing import smi_name_power
    from fira_tpu_torch.train.state import init_state
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
    data_dir = os.path.join(work, "DataSet")
    write_corpus(data_dir)
    ds = FiraDataset(data_dir, fira_full())
    cfg = ds.cfg
    check(cfg.vocab_size == WORD_VOCAB and cfg.ast_change_vocab_size
          == AST_VOCAB and cfg.output_vocab_size == 25_020,
          f"widths {cfg.vocab_size}/{cfg.ast_change_vocab_size}")
    var_maps = cli._load_var_maps(data_dir)   # as the CLI passes them
    gt_file = os.path.join(work, "ground_truth")
    write_ground_truth(ds, var_maps, gt_file)
    ctx = dict(cs=cs, ds=ds, cfg=cfg, work=work, data_dir=data_dir,
               var_maps=var_maps, kind=kind, gt_file=gt_file)

    fwd32, fwd16 = phase_kernels(torch, cs, cfg)
    bwd32 = phase_kernels_bwd(torch, cs, cfg, torch.float32)
    bwd16 = phase_kernels_bwd(torch, cs, cfg, torch.bfloat16)

    # --- the training paths: f32 (its CLI epoch on the loop's own thread,
    # feeder_workers=0), then bf16 (this slice's path, 2 workers) ---
    run32 = train_path(torch, ctx, "float32", cli_workers=0)
    plain32 = train_plain(torch, ctx, run32, F32_LOSS_RTOL)
    run16 = train_path(torch, ctx, "bfloat16", cli_workers=2)
    train_plain(torch, ctx, run16, f32_plain=plain32)
    r32, r16 = run32["result"], run16["result"]
    print(f"[train] bf16 beside f32 (train.loop.train, 2 feeder workers): "
          f"steps/s {r16.steps_per_sec:.3f} vs {r32.steps_per_sec:.3f}, "
          f"commits/s {r16.commits_per_sec:.2f} vs {r32.commits_per_sec:.2f}, "
          f"feed share {r16.feed_stall_frac:.4f} vs "
          f"{r32.feed_stall_frac:.4f}, peak memory "
          f"{run16['peak'] / 2**20:.1f} vs {run32['peak'] / 2**20:.1f} MiB",
          flush=True)
    for dtype in ("float32", "bfloat16"):
        feed_designs(torch, ctx, dtype)
    for run in (run32, run16):
        dev_gate_check(torch, ctx, run)

    # --- profile one warm training step: f32 plain copy score, f32
    # kernels, bf16 kernels ---
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        state = init_state(c, "cuda")
        host = make_batch(ds.splits["train"], list(range(cfg.batch_size)), c,
                          batch_size=cfg.batch_size)
        batch = batch_to_device(host, torch.device("cuda"), TRAIN_FIELDS)
        fns = ((("plain copy score", cs.copy_scores_reference),)
               if dtype == "float32" else ()) + (("kernels", cs.copy_scores),)
        for label, fn in fns:
            state.model.copy_net.score_fn = fn
            profile_one(torch, f"one training step (batch {cfg.batch_size}, "
                        f"{dtype}, {label})", lambda: train_step(
                            state.model, state.optimizer, batch,
                            state.generator))
        del state, batch

    # --- the test paths: each dtype's CLI decodes its trained checkpoint ---
    main32 = test_path(torch, ctx, run32)
    decode_plain(torch, ctx, run32, main32)
    main16 = test_path(torch, ctx, run16)
    decode_plain(torch, ctx, run16, main16)
    for run in (run32, run16):
        dtype = run["gated"].compute_dtype
        model = FiraModel(cfg, device="cuda", dtype=dtype).eval()
        model.load_state_dict(run["state_dict"])
        host = make_batch(ds.splits["test"], list(range(cfg.test_batch_size)),
                          cfg.replace(compute_dtype=dtype),
                          batch_size=cfg.test_batch_size)
        batch = batch_to_device(host, torch.device("cuda"))
        profile_one(torch, f"one decode batch ({cfg.test_batch_size} "
                    f"commits, {cfg.tar_len - 1} steps, {dtype})",
                    lambda: beam_search_cached(model, batch, cfg))
        del model, batch
    phase_small_reference(torch, FiraModel, batch_to_device, make_batch, ds,
                          run32["state_dict"])

    common = dict(route="cuda", library_ms=None)
    fwd = dict(source="fira_tpu_torch/ops/csrc/copy_score.cu",
               replaces="fira_tpu/ops/copy_score.py:119", **common)
    bwd = dict(source="fira_tpu_torch/ops/csrc/copy_score_bwd.cu",
               replaces="fira_tpu/ops/copy_score.py:148", **common)
    kernels = [
        dict(name="copy_score_fwd", dtype="float32",
             launches=run32["k1"] + main32["k1"], **fwd, **fwd32),
        dict(name="copy_score_fwd_bf16", dtype="bfloat16",
             launches=run16["k1"] + main16["k1"], **fwd, **fwd16),
        dict(name="copy_score_bwd", dtype="float32", launches=run32["k2"],
             **bwd, **bwd32),
        dict(name="copy_score_bwd_bf16", dtype="bfloat16",
             launches=run16["k2"],
             **bwd, **bwd16)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
