#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``fira_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line; any failure exits non-zero:

1. device   the card's name, count, and nvidia-smi's name and power limit;
2. build    every hand-written kernel compiled with nvcc for sm_90a from
            the sources in this checkout (registers, shared memory, spills);
3. buckets  the ``auto`` bucket tables of the train, valid and test splits
            (as ``cli --buckets auto`` chooses them), each bucket's commits
            and the padded-cost shares;
4. kernels  each kernel against its plain PyTorch version on the card at
            the shapes the main path gives it, timed with CUDA events
            (L2 flushed between launches), beside its bound and its share
            of it: K1 (copy-score forward) at the decode step (T=1, its
            bytes-first kernel), the dev batch and the training batch
            (T=30, its tanh from one reciprocal a pair of elements; there
            also on inputs with entries of magnitude 15-60 and bitwise
            equal over two launches), at a batch of 85 (the tile kernel's
            third tiling, and a data rank's rows on a mesh of 2), at a
            model rank's 128 features on a mesh of 2, at the bucketed
            training shape (T = the main
            train bucket's tar_len), at the full-prefix beam's shape
            (test batch x beam, tar_len), at the spec drafter's beam-0
            rows (20, 1), and those shapes but the mesh shards' and the
            drafter's in bf16; K2 (its backward) at the training shape
            in f32 (also at magnitudes 15-60) and in bf16, at the
            bucketed shape in both, and at the two mesh shards in f32;
5. train    for f32 and then bf16, the training path at fira-full width
            on a synthetic corpus with the paper's vocabulary sizes and
            random seeded weights, counts from zero around each: one epoch
            through ``cli train --dtype`` (f32 with ``--feeder-workers 0``,
            bf16 with 2), then two epochs with the dev gate (every 2
            batches from epoch 0) through ``train.loop.train`` with the
            Feeder's 2 workers; K2 must launch once per step and K1 once
            per step and per dev batch;
6. train plain  the same steps from the same weights and dropout seed with
            the plain copy score swapped in by this script (no entry point
            does): the per-step losses must agree (f32 1e-4; bf16 within
            the plain bf16 run's gap to the plain f32 run);
7. feed     the same training steps with the Feeder's 2 workers and with
            0 (the loop's own thread assembles), in turns;
8. dev gate ``dev_predict`` ids and ``dev_output`` under K1 against the
            plain copy score on the trained weights (f32 must be equal);
9. train buckets  for f32 and then bf16: one epoch through ``cli train
            --buckets auto``, then ``train.loop.train`` with the buckets and
            ``fused_steps=3`` (a group must form) and with ``accum_steps=2``
            (a tail padded with an all-invalid micro-batch); K2 must launch
            once a forward/backward, K1 also once a dev batch;
10. bucket checks  on one chunk, bucket geometry against full padding
            (f32 loss 1e-5, gradients 1e-4 of their norms); 3 fused steps
            against 3 steps (f32 losses 1e-6); accumulation over 2 x 85
            against one batch of 170 (loss 1e-5, weights rtol 5e-3 / atol
            1e-5); then full geometry, buckets and buckets with fused steps
            timed in turns;
11. profile one warm training step of each dtype under torch.profiler
            (f32 also with the plain copy score), and one at the main train
            bucket's geometry, device busy summed over kernels, memcpy and
            memset; one f32 step under typed edges and one under the
            segment adjacency beside the default step, with the kernels
            whose time grew;
12. main    for f32 and then bf16, the test path through ``cli test
            --dtype``, decoding that dtype's trained checkpoint; the K1
            launch count must match the path; B-Norm BLEU, Penalty-BLEU
            and ROUGE-L of its output;
13. plain   the same decodes with the plain copy score: f32 byte-identical,
            bf16 lines that differ counted; both again in log space
            (where no score underflows; f32 byte-identical); then ``cli
            test --buckets auto`` of the same checkpoint against the
            unbucketed decode (f32: at most one line may differ, and only
            at a near-tie of best-beam probabilities, 1e-5; bf16
            counted), both decodes timed in turns;
            one decode batch of each dtype profiled; on a small input the
            card's f32 distributions must agree with the CPU's;
14. encoder variants  for f32 and then bf16, one epoch of
            ``train.loop.train`` under ``encoder_buffer=split``,
            ``adjacency_impl=segment`` (edges sorted and not),
            ``flat_scatter`` and ``typed_edges``, K1 and K2 once a step;
            then one chunk of each against the default path from the same
            weights (f32: split and segment loss 1e-5, gradients 1e-4 of
            their norms; flat scatter's adjacency bit-identical; typed at
            init loss bit-equal with an ``edge_gain`` gradient), peak
            memory of each;
15. beam modes  for f32 and then bf16, the test split through every beam
            mode (cached and full-prefix, fused and factored, prob and log
            space, early exit off and on) on the trained checkpoint and
            (f32) on its copy biased toward <eos>, K1 once a step run;
            f32: early exit bitwise equal to the full scan (and stopping
            early on the biased weights), factored output bytes equal to
            fused and
            full-prefix within one near-tie line of cached, but for samples
            whose every prob-space score underflowed to zero (ties decide
            them); the beam loop's commits/s of each mode;
16. cli flags  ``cli test --beam-factored-topk --beam-early-exit`` of the
            f32 checkpoint (phase 15's bytes in that mode), ``cli train`` one
            epoch with ``--encoder-buffer split`` and with ``--adjacency
            segment``;
17. engine  the slot-refill engine on the f32 checkpoint: ``cli test
            --engine`` (``run_test`` for the full prefix, which has no
            flag) byte-identical to phase 15's batched decode in the four
            kv x factored modes, prob and log space, the arena paged and
            unpaged; ``--perf production`` byte-identical to the engine in
            its mode; ``--buckets auto --decode-tar-buckets`` with its
            decode table and B-Norm BLEU; the smallest <eos> bias that
            settles samples at 3 or more positions, with the histogram,
            the engine's bytes equal to the batched early exit's there (and
            at 8 and 64 slots the lines that differ); K1 once a
            micro-step, the block allocator healthy after every run; then,
            f32 and bf16, engine against batched early exit in turns a b b
            a (bf16: a b) on the trained and the mixed-depth weights
            (commits/s,
            occupancy, steps a commit, pool use, bytes a slot, peak memory
            above what was held, host syncs a dispatch) and one warm engine
            dispatch profiled. K1 (phase 4) also at the 64-slot step
            (192, 1, 370, 256);
18. serve   ``cli serve`` on one engine (20 slots, the f32 checkpoint,
            the 61 test commits, a replayed trace, the virtual clock):
            byte-identical to ``cli test --engine`` with the prefix cache
            off and on; a repeated mix (each sample twice, 122 requests)
            byte-identical to the cache-off run and to each sample's line,
            with prefills saved and followers coalesced; the test batches
            through the engine and again from its cache, every hit's
            (tokens, probs) bitwise equal to its cold prefill (reported:
            what other slots change in a sample's last bits); the serve
            output under K1 equal to the plain copy score's; wall-clock
            serving at 0.5x and 1.5x the engine's drain commits/s
            (offered, completed, shed,
            p50/p99 TTFT and end-to-end, occupancy, host syncs a dispatch,
            peak memory above held) and a 20-request serve profiled; four
            seeded faults through the CLI (a raising step retires the
            engine and sheds the rest with the reason, a raising assembly
            sheds one request, a corrupt one changes at most its own line,
            admission faults are absorbed by a retry), each exiting 0 with
            a valid ``serve_metrics.json``; K1 once a micro-step, counted;
19. preprocess  the astdiff library built (timed) from the checkout's
            C++ sources into build/astdiff/; ``cli preprocess`` as a
            subprocess on the raw streams of 720 synthetic commits, its
            graph streams and diffatt equal to ``process_commits`` in this
            process (hard check); commits/s, shards, degraded commits,
            CPU count;
20. message ``cli message`` (in this process) on 1 diff reconstructed from
            the test split (f32 checkpoint: exit 0, one line, the
            in-process message); ``one_shot_message`` on 8 in f32 and
            bf16 with K1 (once a beam step, 29 a message, counted) and
            with the plain copy score in turns (f32 messages equal); the
            ingest stages, beam and message latency, and the beam at 1
            row against the 20-row batch the path pads to;
21. serve-diffs  ``cli serve --input diffs`` on the test diffs of an
            extracted corpus (720 commits whose graphs come from the
            astdiff extraction, vocabularies padded to the paper's sizes;
            the f32 checkpoint, 20 slots, a replayed trace, the virtual
            clock): byte-identical to ``cli serve --input graphs`` on the
            same corpus with the ingest cache off and on and the parse
            stage on threads and on a spawned pool (whose processes map no
            torch and no CUDA library); the diffs twice (second pass
            reversed), each line its first pass's, with result-cache hits;
            three malformed diffs shed at exactly their positions; the
            ``ingest.parse`` raise and corrupt and ``ingest.cache`` corrupt
            faults (a line moves only where it is shed or its payload was
            scrambled); K1 once a micro-step, counted; the ingest stage
            times, stall, cache and memo meters; wall-clock serving at 1.5x
            the engine's drain rate over the split once, ingest and
            prefix caches off, threads and pool in turns;
22. fleet   the replicated engine fleet and recovery (the f32 checkpoint,
            ``--engine-slots 20`` over 2 or 4 replicas on the one card,
            the replayed trace): ``cli test --engine --engine-replicas 2``
            and ``4`` and ``cli serve --engine-replicas 2`` (cache off and
            on) byte-identical to ``cli test --engine``, every replica
            serving; a ``fleet.replica`` raise and a step hang past a 1 s
            watchdog each retire one replica mid-run and the survivor
            writes the clean bytes; ``--max-respawns 1`` respawns it,
            ``--engine-spares 1`` attaches the spare (clean bytes); a
            storm past the budget exits 0, each line clean or a recorded
            shed; a wall-clock serve in a child process killed with SIGKILL
            mid-run and ``cli serve --resume`` (the clean bytes, resumed =
            the recovered lines, nothing served twice; another rate exits
            2); K1 4 a step dispatch of every engine plus 4 a prewarm,
            counted; a replica's fresh build against a spare attach; wall
            clock at 1.5x the drain in turns, the journal on and off, and
            one engine against two replicas;
23. tiers   the serving tiers (the f32 checkpoint, 20 slots): ``cli test
            --engine --spec-decode copy|draft --spec-k 4`` and ``copy
            --spec-k 2`` byte-identical to ``cli test --engine``; on a
            copy-biased target-blind checkpoint both tiers at k = 8 its
            plain bytes, the copy tier accepting and needing fewer verify
            dispatches than the plain run's step dispatches; ``--kv-dtype
            bf16``, ``--serve-precision bf16`` and ``int8w`` each the same
            bytes twice (the bf16 arena half the bytes a slot), spec under
            bf16 KV and int8 weights that tier's plain bytes; each tier
            against f32 (lines, B-Norm BLEU, beam-score divergence); spec
            against plain in turns; ``cli serve --serve-tiers
            prefill-pool --prefill-workers 2`` byte-identical with no
            decode-side prefill, its workers mapping libcuda, under a
            seeded worker death and a transport corrupt too, no
            shared-memory segment left; disaggregated against in-process
            at 1.5x the drain in turns, and the card's memory in use with
            the workers; K1 as ``k1_formula`` of each run's counters;
24. mesh    the training mesh (``parallel/mesh.py``), f32: ``cli train
            --mesh 1x1`` (a one-rank NCCL group) one epoch, its
            ``latest.pt`` byte-identical to phase 5's ``cli train``;
            ``train.loop.train`` on a 1x1 mesh with the gate, every loss,
            ``best.pt`` and ``latest.pt`` bitwise equal to phase 5's f32
            run; two ranks sharing the card (gloo, collectives staged
            through host memory) at DP 2x1 and TP 1x2, 3 steps at batch
            170 from the seeded weights (losses within 2e-5 of one
            process), K1/K2 once a
            step on each rank at its shard's shape (phase 4 times K1 and
            K2 at (85, 30, 370, 256) and (170, 30, 370, 128) too), steps/s
            and peak memory a rank; TP with dropout on, one step
            (replicated parameters bit-identical across the ranks); ring
            attention at
            ``seq_shards=2`` on the two ranks against dense; out_fc's
            all-reduce timed; ``cli train --mesh 2x1`` exits 2.

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
import zlib

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and f32
# operations/s outside the tensor cores (the copy score's tanh/add/mul)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
N_COMMITS = 720            # -> a test split of ~60 commits
ENGINE_WIDE = 64           # the slot engine's wide arena (--engine-slots)
WALL_REPEATS = 1           # wall-clock serving: the test split once (61)
WORD_VOCAB, AST_VOCAB = 24_650, 71   # the paper's vocabulary sizes
SEED = 0
BF16_SEEDS = 4     # draws a shape on which bf16 K1 is held against plain
# per-step losses of the kernel run against the plain run, f32: 1e-4
# relative. In bf16 a kernel's output may differ from its plain version's
# by one rounding of a score (2^-8 of its size), one of the roundings bf16
# makes everywhere in the model; so the bf16 runs are held to the gap
# between the plain bf16 and the plain f32 runs over the same steps (the
# largest per-step relative difference): a copy-score fault that moves
# training by more than all of bf16's roundings together fails
F32_LOSS_RTOL = 1e-4
PROB_RTOL = 1e-5   # f32 beam probabilities, K1 against the plain copy score


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


def case_gen(torch, label: str, k: int = 0):
    """A generator on the card for draw ``k`` of the case ``label``, seeded
    from the label: a case's inputs do not depend on the cases before it."""
    seed = SEED + zlib.crc32(f"{label} {k}".encode())
    return torch.Generator(device="cuda").manual_seed(seed)


def k1_inputs(torch, gen, shape, dtype):
    """K1's src, tgt, w and bias at (B, T, S, D), the scores about 1 in
    size (w 0.1 a weight over D = 256 unit terms) and the bias a unit
    normal."""
    b, t, s, d = shape
    src = torch.randn((b, s, d), device="cuda", generator=gen).to(dtype)
    tgt = torch.randn((b, t, d), device="cuda", generator=gen).to(dtype)
    w = torch.randn((d, 1), device="cuda", generator=gen) * 0.1
    bias = torch.randn((1,), device="cuda", generator=gen)
    return src, tgt, w, bias


def bf16_ulp(torch, x):
    """One bf16 step at each |x| of the f64 tensor x: bf16 keeps 8
    significant bits, so 2^(e - 8) for x = m 2^e, 0.5 <= |m| < 1 (no less
    than 2^-133, the subnormal step)."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8).clamp(min=2.0 ** -133)


def copy_scores_f64(torch, src, tgt, w, rows: int = 8):
    """The copy score without its bias, in f64 from the given (rounded)
    inputs, ``rows`` batch rows at a time: the exact sum that a bf16
    result's roundings are measured from."""
    B, T, S = src.shape[0], tgt.shape[1], src.shape[1]
    w64 = w.reshape(-1).double()
    out = torch.empty((B, T, S), dtype=torch.float64, device=src.device)
    for i in range(0, B, rows):
        s, t = src[i:i + rows].double(), tgt[i:i + rows].double()
        out[i:i + rows] = torch.tanh(s[:, None] + t[:, :, None]) @ w64
    return out


def hold_bf16(torch, cs, label: str, src, tgt, w, bias, got, want):
    """bf16 K1 (``got``, with its bias) against its plain version
    (``want``), with limits from the roundings both make rather than a
    fixed share of the result. Both sum the D terms in f32, round the sum
    to bf16 and add the bias in bf16. An f32 sum of D terms, each at most
    |w_d| in size, errs by at most delta = (D + 8) u sum_d |w_d| (u =
    2^-24: (D - 1) u for the additions in any order, the rest for the
    kernel's tanh, a few u each). So (1) the kernel's score without its
    bias is within ulp(z) + delta of the exact f64 sum z (one of z's two
    bf16 neighbours, up to the f32 error), and (2) with the bias, kernel
    and plain differ by at most ulp(z) + 2 delta (their sums may round to
    either side of z) plus half a step of each result (the bias add):
    |got - want| <= ulp(z) + ulp(max(|got|, |want|)) + 2 delta. A fixed
    1e-2 of the result does not hold: where the bias cancels most of a
    sum of 2-4, the result is far smaller than that sum's step of 2^-6.
    Returns the largest |kernel - z| and |plain - z| over limit (1), the
    elements where the kernel's and the plain sums differ, the largest
    |got - want| over limit (2), and the elements that rtol/atol 1e-2
    would refuse."""
    pre_k = torch.empty_like(got)
    cs.launch(src, tgt, w.reshape(-1).contiguous(), pre_k)
    pre_p = cs.copy_scores_reference(src, tgt, w, torch.zeros_like(bias))
    z = copy_scores_f64(torch, src, tgt, w)
    ulp_z = bf16_ulp(torch, z)
    delta = (w.numel() + 8) * 2.0 ** -24 * w.double().abs().sum().item()
    k_over = ((pre_k.double() - z).abs() / (ulp_z + delta)).max().item()
    p_over = ((pre_p.double() - z).abs() / (ulp_z + delta)).max().item()
    g, v = got.double(), want.double()
    limit = ulp_z + bf16_ulp(torch, torch.maximum(g.abs(), v.abs())) \
        + 2 * delta
    over = ((g - v).abs() / limit).max().item()
    fixed = int(((g - v).abs() > 1e-2 + 1e-2 * v.abs()).sum().item())
    differ = int((pre_k != pre_p).sum().item())
    check(k_over <= 1.0, f"copy_score {label}: the kernel's bf16 score is "
          f"{k_over:.3f} of ulp(z) + delta from the f64 sum (limit 1)")
    check(over <= 1.0, f"copy_score {label}: kernel and plain differ by "
          f"{over:.3f} of ulp(z) + ulp(result) + 2 delta (limit 1)")
    return k_over, p_over, differ, over, fixed


def phase_kernels(torch, cs, cfg, bucket_t: int):
    """Copy score: kernel vs plain at the decode, dev and training shapes
    (f32, rtol/atol 1e-5: the kernel sums D in another order and, at T > 1,
    takes tanh from one reciprocal a pair of elements), at the training
    shape also with large magnitudes and over two launches (bitwise), at
    a batch of 85, at the bucketed training shape (T = the main train
    bucket's ``bucket_t``), at the full-prefix beam's (test batch x beam,
    tar_len), at the slot engine's step with 64 slots (192, 1), those
    shapes but 85 in bf16 (over ``BF16_SEEDS`` draws each, with the limits
    of ``hold_bf16``), a 10-slot replica's step (30, 1) and the spec
    drafter's beam-0 rows at 20 slots (20, 1) in f32. Each case draws its
    inputs from a generator of its own. Returns the f32 and the bf16
    record: the decode shape's numbers, with the dev, training, bucket,
    full-prefix beam, engine, replica and drafter shapes' under
    ``dev_*``, ``train_*``, ``bucket_*``, ``prefix_*``, ``engine_*``,
    ``replica_*`` and ``draft_*``, and a mesh rank's shards (85 rows of 2
    data ranks, 128 features of 2 model ranks) under ``dp_*`` and
    ``tp_*``."""
    from fira_tpu_torch.ops.timing import time_ms

    B, K = cfg.test_batch_size, cfg.beam_size
    S, D = cfg.sou_len + cfg.sub_token_len, cfg.embedding_dim
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("decode", (B * K, 1, S, D), f32, 1e-5),
             ("dev", (B, cfg.tar_len, S, D), f32, 1e-5),
             ("train", (cfg.batch_size, cfg.tar_len, S, D), f32, 1e-5),
             # the main path pads every batch to full size, so it gives the
             # tile kernel 128 s a block (train) and 32 (dev); a batch of
             # 85 takes the third tiling, 64 s a block and 2 slices of d:
             # it is also a rank's rows on a mesh of 2 data ranks
             ("dp", (85, cfg.tar_len, S, D), f32, 1e-5),
             # a rank's feature shard on a mesh of 2 model ranks
             ("tp", (cfg.batch_size, cfg.tar_len, S, D // 2), f32, 1e-5),
             # buckets keep S and the batch and shrink T: one partial tile
             ("bucket", (cfg.batch_size, bucket_t, S, D), f32, 1e-5),
             # the full-prefix beam (beam_kv_cache=False): every step
             # scores the whole prefix, beams folded into the batch
             ("prefix", (B * K, cfg.tar_len, S, D), f32, 1e-5),
             # the slot engine's step at --engine-slots 64
             ("engine", (ENGINE_WIDE * K, 1, S, D), f32, 1e-5),
             ("decode", (B * K, 1, S, D), bf16, None),
             ("dev", (B, cfg.tar_len, S, D), bf16, None),
             ("train", (cfg.batch_size, cfg.tar_len, S, D), bf16, None),
             ("bucket", (cfg.batch_size, bucket_t, S, D), bf16, None),
             ("prefix", (B * K, cfg.tar_len, S, D), bf16, None),
             ("engine", (ENGINE_WIDE * K, 1, S, D), bf16, None),
             # a replica's step in a fleet of 2 over the test batch's
             # slots (--engine-slots 20 --engine-replicas 2)
             ("replica", (B // 2 * K, 1, S, D), f32, 1e-5),
             # the spec drafter's call: each slot's beam-0 row at
             # --engine-slots 20 (the copy tier's and the draft tier's)
             ("draft", (B, 1, S, D), f32, 1e-5)]
    records = {f32: {}, bf16: {}}
    for name, (b, t, s, d), dtype, tol in cases:
        label = f"{name} {dname(dtype)}"
        gen = case_gen(torch, f"copy_score {label}")
        src, tgt, w, bias = k1_inputs(torch, gen, (b, t, s, d), dtype)
        got = cs.copy_scores(src, tgt, w, bias)
        want = cs.copy_scores_reference(src, tgt, w, bias)
        torch.cuda.synchronize()
        check(got.shape == (b, t, s) and got.dtype == dtype,
              f"copy_score {label}: shape {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()),
              f"copy_score {label}: non-finite output")
        err = (got.float() - want.float()).abs().max().item()
        if dtype == f32:
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
        else:
            reads = [hold_bf16(torch, cs, label, src, tgt, w, bias, got,
                               want)]
            for k in range(1, BF16_SEEDS):
                x = k1_inputs(torch, case_gen(torch, f"copy_score {label}",
                                              k), (b, t, s, d), dtype)
                reads.append(hold_bf16(
                    torch, cs, f"{label} draw {k}", *x, cs.copy_scores(*x),
                    cs.copy_scores_reference(*x)))
                del x
            k_st, p_st, differ, over, fixed = (
                max(r[i] for r in reads) for i in range(5))
            print(f"[kernels] copy_score {label} over {BF16_SEEDS} draws: "
                  f"|kernel - f64 sum| at most {k_st:.3f} of ulp + delta, "
                  f"plain {p_st:.3f}; the sums before the bias "
                  f"differ on up to {differ} elements a draw; |kernel - "
                  f"plain| at most {over:.3f} of its limit; rtol/atol 1e-2 "
                  f"would refuse up to {fixed} elements a draw", flush=True)
        if name in ("train", "bucket"):
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
              f"max_abs_err {err:.3e} ("
              f"{f'rtol/atol {tol}' if tol else 'limits of hold_bf16'}); "
              f"kernel {ms:.4f} ms "
              f"(wrapper with bias add {wrapper_ms:.4f} ms), plain "
              f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"kernel at {100 * bound / ms:.1f}% of bound", flush=True)
        if name in ("decode", "dev", "train", "bucket", "prefix", "engine",
                    "replica", "draft", "dp", "tp"):
            pre = "" if name == "decode" else f"{name}_"
            records[dtype].update({
                f"{pre}shape": [b, t, s, d], f"{pre}max_abs_err": err,
                f"{pre}ms": ms, f"{pre}plain_ms": plain_ms,
                f"{pre}bound_ms": bound, f"{pre}bound_by": by})
        del src, tgt, got, want
    return records[f32], records[bf16]


def phase_kernels_bwd(torch, cs, cfg, dtype, T=None, B=None, D=None):
    """Copy-score backward (K2) against the plain autograd backward at the
    training shape (``T``: default the full tar_len; the bucketed training
    shape passes its bucket's), the plain version run on the same values
    in f64: dw sums B x T x S terms of both signs, and the plain version
    in f32 rounds near-zero entries by more than the tolerance below (its
    f32 run's error against the f64 run is printed beside the kernel's).
    f32: rtol 5e-4 / atol 5e-5 (the JAX package's gradient tolerance), at
    the full T also on inputs of magnitude 15-60. bf16: 2e-2 (dsrc and
    dtgt round once to bf16). The
    plain backward is timed in the kernel's type on a retained graph of the
    plain version on the same inputs, so it runs from the saved (B, T, S,
    D) intermediate, without the forward. ``B`` and ``D`` (default the
    training batch and width) give a mesh rank's shards."""
    full_t = T is None
    label = ("train" if full_t else "bucket") if B is None and D is None \
        else "shard"
    B, T = B or cfg.batch_size, cfg.tar_len if full_t else T
    S, D = cfg.sou_len + cfg.sub_token_len, D or cfg.embedding_dim
    bf16 = dtype == torch.bfloat16
    rtol, atol = (2e-2, 2e-2) if bf16 else (5e-4, 5e-5)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    src = torch.randn((B, S, D), device="cuda", generator=gen).to(dtype)
    tgt = torch.randn((B, T, D), device="cuda", generator=gen).to(dtype)
    w = torch.randn((D, 1), device="cuda", generator=gen) * 0.1
    dout = torch.randn((B, T, S), device="cuda", generator=gen).to(dtype)
    got = cs.copy_scores_backward(src, tgt, w, dout)
    want = cs.copy_scores_backward_reference(
        *(x.double() for x in (src, tgt, w, dout)))
    plain32 = cs.copy_scores_backward_reference(src.float(), tgt.float(), w,
                                                dout.float())
    torch.cuda.synchronize()
    errs, plain_errs = {}, {}
    for name, g, r, p, want_dtype in zip(("dsrc", "dtgt", "dw"), got, want,
                                         plain32, (dtype, dtype, w.dtype)):
        check(g.shape == r.shape and g.dtype == want_dtype,
              f"copy_score_bwd {name}: {tuple(g.shape)} {g.dtype}")
        check(bool(torch.isfinite(g).all()), f"copy_score_bwd {name}: "
              "non-finite")
        errs[name] = (g.double() - r).abs().max().item()
        plain_errs[name] = (p.double() - r).abs().max().item()
        torch.testing.assert_close(g.double(), r, rtol=rtol, atol=atol)
    del want, plain32
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
    print(f"[kernels] copy_score_bwd {label} ({B},{T},{S},{D}) "
          f"{dname(dtype)}: max_abs_err against f64 "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (rtol {rtol}, atol {atol}; the plain f32 backward's: "
          + ", ".join(f"{k} {v:.3e}" for k, v in plain_errs.items())
          + "), bitwise equal over two runs; "
          f"kernel (both launches) {ms:.4f} ms (wrapper with the dw sum "
          f"{wrapper_ms:.4f} ms), plain backward {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), kernel at {100 * bound / ms:.1f}% of "
          f"bound", flush=True)
    if not bf16 and label == "train":
        # large magnitudes beside ordinary values
        big = [with_large(torch, src, 0.05, gen),
               with_large(torch, tgt, 0.02, gen)]
        got = cs.copy_scores_backward(big[0], big[1], w, dout)
        want = cs.copy_scores_backward_reference(
            *(x.double() for x in (*big, w, dout)))
        torch.cuda.synchronize()
        big_errs = {}
        for name, g, r in zip(("dsrc", "dtgt", "dw"), got, want):
            check(bool(torch.isfinite(g).all()),
                  f"copy_score_bwd large {name}: non-finite")
            big_errs[name] = (g.double() - r).abs().max().item()
            torch.testing.assert_close(g.double(), r, rtol=rtol, atol=atol)
        print(f"[kernels] copy_score_bwd train shape, large magnitudes "
              f"(|src| or |tgt| 15-60 on 5 % / 2 % of entries): max_abs_err "
              f"against f64 "
              + ", ".join(f"{k} {v:.3e}" for k, v in big_errs.items())
              + f" (rtol {rtol}, atol {atol})", flush=True)
    return dict(shape=[B, T, S, D], max_abs_err=max(errs.values()), ms=ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by)


def write_corpus(data_dir: str) -> None:
    """Synthetic corpus with the vocabularies padded by filler tokens to
    the paper's sizes, so every width is fira-full's."""
    from fira_tpu_torch.data import synthetic

    synthetic.write_corpus_dir(data_dir, n_commits=N_COMMITS, seed=SEED)
    pad_vocabs(data_dir)


def pad_vocabs(data_dir: str) -> None:
    """Pad a corpus' vocabularies with filler tokens to the paper's
    sizes."""
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
    return dict(wall_ms=wall_us / 1e3, busy_ms=device_us / 1e3,
                by_name=by_name)


def kernels_grown(label: str, got: dict, base: dict, n: int = 8) -> None:
    """The device rows (by kernel name) whose time grew most from the
    profile ``base`` to ``got``, with their launches in each."""
    names = set(got["by_name"]) | set(base["by_name"])
    rows = sorted(((got["by_name"].get(k, (0.0, 0)),
                    base["by_name"].get(k, (0.0, 0)), k) for k in names),
                  key=lambda r: r[1][0] - r[0][0])
    print(f"[profile] {label}: device busy {got['busy_ms']:.2f} ms against "
          f"{base['busy_ms']:.2f}; the rows that grew most:", flush=True)
    for (us, k), (us0, k0), name in rows[:n]:
        print(f"[profile]   +{(us - us0) / 1e3:8.3f} ms  {us / 1e3:8.3f} ms "
              f"x{k:<5d} (was {us0 / 1e3:.3f} ms x{k0})  {name[:90]}",
              flush=True)


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
    kernel/plain/plain/kernel; then both once in log space. f32:
    byte-identical to the CLI's output, and the two log-space outputs
    byte-identical. bf16: the lines that differ are counted (a one-step
    bf16 rounding difference can flip a near-tie in the beam), and the
    plain decode's metrics printed."""
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
    # log space: nothing underflows, so every position of every sample
    # ranks by the copy score (in prob space most samples' scores reach
    # zero before the last step, and from there ties decide)
    logs = {}
    for label in ("kernel", "plain"):
        model.copy_net.score_fn = (cs.copy_scores if label == "kernel"
                                   else cs.copy_scores_reference)
        out = os.path.join(work, f"dec_{dtype}_{label}_log")
        run_test(model, ds, cfg.replace(compute_dtype=dtype,
                                        beam_compat_prob_space=False),
                 out_dir=out, var_maps=ctx["var_maps"])
        with open(os.path.join(out, "output_fira"), "rb") as f:
            logs[label] = f.read()
    n_diff = len(n_lines_differ(logs["kernel"], logs["plain"]))
    if dtype == "float32":
        check(logs["kernel"] == logs["plain"], f"f32 log-space decode: "
              f"{n_diff} lines differ between K1 and the plain copy score")
    print(f"[plain {dtype}] log-space decode, K1 vs the plain copy score: "
          f"{n_diff} of {n_test} lines of output_fira differ", flush=True)


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


# gradients that are zero in exact arithmetic: a softmax ignores a constant
# shift of its logits, and these biases add one; their values are rounding
# noise, so they are held relative to the whole gradient's norm
SHIFT_ONLY = re.compile(r"(k_proj\.bias|^copy_net\.score\.bias)$")


def phase_buckets(ctx) -> dict:
    """The ``auto`` bucket tables of the three splits (as ``cli --buckets
    auto`` chooses them from the split it reads), each bucket's sample
    count and the padded-cost shares (the JAX package's analytic cost
    proxy, not a time): train as it trains (the train table, messages
    admitted), valid and test as they decode (the decode table, tar
    full)."""
    from fira_tpu_torch.data import buckets as B

    ds, cfg = ctx["ds"], ctx["cfg"]
    tables = {}
    for split in ("train", "valid", "test"):
        data = ds.splits[split]
        table = B.choose_buckets(data, cfg)
        c = cfg.replace(buckets=table)
        train = split == "train"
        geoms = B.bucket_table(c) if train else B.decode_table(c)
        rep = B.padding_report(data, c, geoms, use_msg=train)
        print(f"[buckets] {split} ({len(data)} commits): auto table "
              f"{' '.join(':'.join(map(str, g)) for g in table)} (+ full); "
              f"{'train' if train else 'decode'} geometries "
              + ", ".join(f"{r['geom']} n={r['n']}"
                          + (f" pad {r['padding_frac']}" if r["n"] else "")
                          for r in rep["buckets"])
              + f"; padded-cost share single {rep['padding_frac_single']} "
              f"-> bucketed {rep['padding_frac_bucketed']}, cost ratio "
              f"{rep['flops_ratio_bucketed_vs_single']}", flush=True)
        tables[split] = table
    check(len(tables["train"]) >= 1, "no train bucket chosen")
    table = B.bucket_table(cfg.replace(buckets=tables["train"]))
    counts = np.bincount(B.assign_buckets(
        B.sample_extents(ds.splits["train"], cfg), table),
        minlength=len(table))
    tables["main"] = table[int(np.argmax(counts))]
    check(tables["main"] != B.full_geom(cfg),
          "most train commits need the full geometry")
    return tables


def bucket_steps(cfg, split, fused: int = 1, accum: int = 1, epochs=(0,)):
    """The grouped plans of ``epochs`` for ``cfg`` (its buckets, seed and
    batch size), as ``train.loop.train`` walks them."""
    from fira_tpu_torch.data import grouping

    group = fused if fused > 1 else accum
    return [grouping.grouped_plan(split, cfg, group_size=group,
                                  accum=accum > 1, shuffle=True,
                                  seed=cfg.seed, epoch=e) for e in epochs]


def train_buckets(torch, ctx, dtype: str, tables: dict) -> dict:
    """One dtype's bucketed training paths, counts from zero around them
    only: one epoch through ``cli train --buckets auto``; then
    ``train.loop.train`` with the train table and ``fused_steps=3`` (gate
    every 3 batches from epoch 0), and with ``accum_steps=2`` (gate every 2
    batches): at least one fused group must form, and the accum plan must
    hold a tail padded with an all-invalid micro-batch. K2 must launch once
    a forward/backward (steps x micro-batches) and K1 once a
    forward/backward and once a dev batch."""
    from fira_tpu_torch import cli
    from fira_tpu_torch.train import loop as train_loop

    cs, ds, work, cfg = ctx["cs"], ctx["ds"], ctx["work"], ctx["cfg"]
    split = ds.splits["train"]
    bcfg = cfg.replace(buckets=tables["train"], compute_dtype=dtype)
    (cli_plan,) = bucket_steps(bcfg, split)
    cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["train", "--config", "fira-full", "--data-dir",
                   ctx["data_dir"], "--out-dir",
                   os.path.join(work, f"train_cli_buckets_{dtype}"),
                   "--epochs", "1", "--dtype", dtype, "--buckets", "auto"])
    check(rc == 0, f"cli train --buckets auto --dtype {dtype} exited {rc}")
    cli_wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    k1, k2 = cs.copy_scores.launches, cs.copy_scores_backward.launches
    check(k1 == k2 == len(cli_plan),
          f"{dtype} cli train --buckets: copy_score {k1}, copy_score_bwd "
          f"{k2} launches, expected {len(cli_plan)} steps (no gate)")
    print(f"[train buckets {dtype}] cli train fira-full --buckets auto "
          f"--dtype {dtype}: 1 epoch, {len(cli_plan)} steps ("
          + ", ".join(f"{sum(e.geom == g for e in cli_plan)} at "
                      f"{':'.join(map(str, g))}"
                      for g in dict.fromkeys(e.geom for e in cli_plan))
          + f"), wall {cli_wall:.2f} s incl. data load; launches copy_score "
          f"{k1}, copy_score_bwd {k2} (expected {len(cli_plan)}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
          f"MiB", flush=True)
    total = {"k1": k1, "k2": k2}
    runs = {}
    for label, knobs in (("fused", dict(fused_steps=3, dev_every_batches=3)),
                         ("accum", dict(accum_steps=2, dev_every_batches=2))):
        c = bcfg.replace(dev_start_epoch=0, **knobs)
        plans = bucket_steps(c, split, c.fused_steps, c.accum_steps,
                             epochs=(0, 1))
        entries = [e for p in plans for e in p]
        groups = sum(e.pad_to > 1 for e in entries)
        padded = sum(len(e.chunks) < e.pad_to for e in entries)
        check(groups > 0, f"{dtype} {label}: no group formed")
        if label == "accum":
            check(padded > 0, f"{dtype} accum: no tail padded with an "
                  f"all-invalid micro-batch")
        cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
        torch.cuda.reset_peak_memory_stats()
        r = train_loop.train(ds, c, device="cuda",
                             out_dir=os.path.join(work, f"{label}_{dtype}"),
                             epochs=2, var_maps=ctx["var_maps"], resume=False)
        torch.cuda.synchronize()
        k1, k2 = cs.copy_scores.launches, cs.copy_scores_backward.launches
        peak = torch.cuda.max_memory_allocated()
        want_batches = sum(e.pad_to for e in entries)
        check(r.groups == groups and r.batches == want_batches,
              f"{dtype} {label}: {r.groups} groups / {r.batches} batches, "
              f"expected {groups} / {want_batches}")
        check(k2 == r.batches, f"{dtype} {label}: copy_score_bwd launched "
              f"{k2} times, expected {r.batches} (steps x micro-batches)")
        check(k1 == r.batches + r.dev_batches,
              f"{dtype} {label}: copy_score launched {k1} times, expected "
              f"{r.batches} + {r.dev_batches} dev batches")
        check(all(math.isfinite(x) for x in r.losses),
              f"{dtype} {label}: non-finite loss {r.losses}")
        check(not r.warnings, f"{dtype} {label}: {r.warnings}")
        total["k1"] += k1
        total["k2"] += k2
        runs[label] = r
        print(f"[train buckets {dtype}] train.loop.train buckets + "
              f"{'fused_steps=3' if label == 'fused' else 'accum_steps=2'} "
              f"(gate every {c.dev_every_batches} batches from epoch 0), 2 "
              f"epochs: {len(entries)} dispatches, {groups} groups "
              f"({padded} padded with all-invalid micro-batches), "
              f"{r.steps} optimizer steps, {r.batches} forward/backward "
              f"passes; steps/s {r.steps_per_sec:.3f}, training commits/s "
              f"{r.commits_per_sec:.2f} (gates, checkpoints and the first "
              f"interval excluded), feed share {r.feed_stall_frac:.4f}; "
              f"{r.gates} gates x {r.dev_batches // max(r.gates, 1)} dev "
              f"batches; peak device memory {peak / 2**20:.1f} MiB; "
              f"launches copy_score {k1}, copy_score_bwd {k2}; losses "
              + " ".join(f"{x:.4f}" for x in r.losses), flush=True)
    return dict(total, runs=runs)


def _loss_grads(torch, model, batch):
    model.zero_grad(set_to_none=True)
    nll, cnt = model(batch)
    (nll / cnt.clamp(min=1)).backward()
    return (nll.item(), int(cnt),
            {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters()})


def grad_rel_err(torch, got: dict, want: dict) -> tuple:
    """(largest relative error of a gradient to its norm, its name); the
    ``SHIFT_ONLY`` gradients relative to the whole gradient's norm."""
    total = math.sqrt(sum(float((w.double() ** 2).sum())
                          for w in want.values()))
    worst = (0.0, "")
    for name, w in want.items():
        scale = total if SHIFT_ONLY.search(name) else float(w.norm())
        worst = max(worst, (float((got[name] - w).norm()) / scale, name))
    return worst


def bucket_checks(torch, ctx, tables: dict) -> None:
    """Hard checks of the bucketed and grouped steps on the card, f32 (bf16
    reported): one full chunk of the main train bucket at its geometry
    against full padding (same weights, dropout off: loss 1e-5 relative,
    each gradient 1e-4 of its norm); K = 3 fused steps against 3
    ``train_step`` calls from the same state and generator state (losses
    1e-6 relative); ``accum_step`` over two micro-batches of 85 against one
    step on the 170 (dropout off: loss 1e-5 relative, weights rtol 5e-3 /
    atol 1e-5)."""
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.train import step as step_lib
    from fira_tpu_torch.train.state import init_state

    ds, cfg = ctx["ds"], ctx["cfg"]
    split, geom, bs = ds.splits["train"], tables["main"], cfg.batch_size
    dev = torch.device("cuda")
    idx = np.where(B.sample_extents(split, cfg).admissible(geom))[0]
    check(len(idx) >= 3 * bs, f"main bucket holds {len(idx)} commits")

    def on_card(c, chunk, n=bs, g=geom):
        return batch_to_device(make_batch(split, chunk, c, batch_size=n,
                                          geom=g), dev, TRAIN_FIELDS)

    quiet = dict(dropout_rate=0.0, gcn_dropout_rate=0.0)
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype, **quiet)
        model = FiraModel(c, device=dev).init_parameters(
            torch.Generator().manual_seed(SEED)).eval()
        full = _loss_grads(torch, model, on_card(c, idx[:bs], g=None))
        buck = _loss_grads(torch, model, on_card(c, idx[:bs]))
        check(full[1] == buck[1], f"{dtype}: token counts {full[1]} vs "
              f"{buck[1]}")
        rel = abs(buck[0] - full[0]) / abs(full[0])
        g_err, g_name = grad_rel_err(torch, buck[2], full[2])
        f32 = dtype == "float32"
        if f32:
            check(rel <= 1e-5, f"bucket vs full padding loss {rel:.3e}")
            check(g_err <= 1e-4, f"bucket vs full padding gradient {g_name} "
                  f"{g_err:.3e}")
        print(f"[bucket checks {dtype}] one chunk of {bs} at "
              f"{':'.join(map(str, geom))} vs full padding, same weights, "
              f"dropout off: loss {buck[0]:.6f} vs {full[0]:.6f} ({rel:.3e} "
              f"relative{', limit 1e-5' if f32 else ', reported'}), worst "
              f"gradient {g_name} {g_err:.3e} of its norm"
              f"{' (limit 1e-4)' if f32 else ' (reported)'}", flush=True)
        del model, full, buck

    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        members = [on_card(c, idx[i * bs:(i + 1) * bs]) for i in range(3)]
        stacked = {k: torch.stack([m[k] for m in members])
                   for k in members[0]}
        a, b, again = (init_state(c, dev) for _ in range(3))
        fused = step_lib.multi_step(a.model, a.optimizer, stacked,
                                    a.generator).tolist()
        single = [step_lib.train_step(b.model, b.optimizer, m,
                                      b.generator).item() for m in members]
        for m in members:   # the per-step run once more: its own spread
            step_lib.train_step(again.model, again.optimizer, m,
                                again.generator)
        rel = max_rel(fused, single)
        same, twice = (all(torch.equal(p, q) for p, q in zip(
            x.model.parameters(), b.model.parameters())) for x in (a, again))
        if dtype == "float32":
            check(rel <= 1e-6, f"fused vs per-step losses {rel:.3e}")
        print(f"[bucket checks {dtype}] 3 fused steps vs 3 train_step calls "
              f"from the same state and generator state (dropout on): losses "
              f"{' '.join(f'{x:.6f}' for x in fused)} vs "
              f"{' '.join(f'{x:.6f}' for x in single)}, {rel:.3e} relative"
              f"{' (limit 1e-6)' if dtype == 'float32' else ' (reported)'}; "
              f"weights bitwise equal: {same} (per-step run twice: "
              f"{twice})", flush=True)
        del a, b, again, stacked, members

    c = cfg.replace(**quiet)
    half = bs // 2
    micro = [on_card(c, idx[:half], n=half),
             on_card(c, idx[half:2 * half], n=half)]
    big = on_card(c, idx[:2 * half], n=2 * half)
    a, b = init_state(c, dev), init_state(c, dev)
    got = step_lib.accum_step(a.model, a.optimizer,
                              {k: torch.stack([m[k] for m in micro])
                               for k in big}, a.generator).item()
    want = step_lib.train_step(b.model, b.optimizer, big, b.generator).item()
    rel = abs(got - want) / abs(want)
    check(rel <= 1e-5, f"accum vs one batch loss {rel:.3e}")
    worst = 0.0
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        excess = ((p - q).abs() - (1e-5 + 5e-3 * q.abs())).max().item()
        check(excess <= 0, f"accum vs one batch weight {name} beyond rtol "
              f"5e-3 / atol 1e-5 by {excess:.3e}")
        worst = max(worst, (p - q).abs().max().item())
    print(f"[bucket checks float32] accum_step over 2 micro-batches of {half} "
          f"vs one step on the {2 * half}, dropout off: loss {got:.6f} vs "
          f"{want:.6f} ({rel:.3e} relative, limit 1e-5); weights within rtol "
          f"5e-3 / atol 1e-5 (largest difference {worst:.3e})", flush=True)


def bucket_turns(torch, ctx, dtype: str, tables: dict) -> None:
    """``train.loop.train`` over the same two epochs at the full geometry
    one step a batch, with the train buckets one step a batch, and with the
    buckets and fused_steps=3, in turns a b c c b a on one state (no gate:
    the gates start past the run), after a warm epoch of each: its
    steps/s and commits/s (first interval and checkpoint writes out)."""
    from fira_tpu_torch.train import loop as train_loop
    from fira_tpu_torch.train.state import init_state

    ds, cfg = ctx["ds"], ctx["cfg"].replace(compute_dtype=dtype,
                                            dev_start_epoch=10**6)
    state = init_state(cfg, torch.device("cuda"))
    modes = {"single": cfg,
             "buckets": cfg.replace(buckets=tables["train"]),
             "fused3": cfg.replace(buckets=tables["train"], fused_steps=3)}

    def run(mode: str, epochs: int):
        r = train_loop.train(
            ds, modes[mode], device="cuda",
            out_dir=os.path.join(ctx["work"], f"turns_{dtype}_{mode}"),
            epochs=epochs, resume=False, state=state)
        check(r.gates == 0, f"turns {dtype} {mode}: {r.gates} gates ran")
        return r.steps_per_sec, r.commits_per_sec

    for mode in modes:
        run(mode, 1)
    got = {m: [] for m in modes}
    for mode in ("single", "buckets", "fused3", "fused3", "buckets",
                 "single"):
        got[mode].append(run(mode, 2))
    print(f"[turns {dtype}] train.loop.train, the same 2 epochs, in turns "
          f"a b c c b a: "
          + "; ".join(f"{m}: steps/s "
                      + " ".join(f"{r[0]:.3f}" for r in v)
                      + ", commits/s " + " ".join(f"{r[1]:.1f}" for r in v)
                      for m, v in got.items()), flush=True)
    del state


def decode_best_probs(torch, ctx, dtype: str, state_dict, positions,
                      cfg) -> dict:
    """Each test position's best-beam probability as ``run_test`` over
    ``cfg`` (buckets or not) computes it: the position's batch rebuilt as
    that run packs it and beam-decoded again."""
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import batch_to_device
    from fira_tpu_torch.decode.beam import beam_search_cached
    from fira_tpu_torch.model.model import FiraModel

    data, bs = ctx["ds"].splits["test"], cfg.test_batch_size
    plan = B.decode_plan(data, cfg)
    model = FiraModel(cfg, device="cuda", dtype=dtype).eval()
    model.load_state_dict(state_dict)
    out = {}
    for chunk, geom in plan:
        rows = [r for r, p in enumerate(chunk) if int(p) in positions]
        if not rows:
            continue
        batch = batch_to_device(make_batch(data, chunk, cfg, batch_size=bs,
                                           geom=geom), torch.device("cuda"))
        _, probs = beam_search_cached(model, batch, cfg)
        for r in rows:
            out[int(chunk[r])] = float(probs[r].max())
    return out


def test_buckets(torch, ctx, run: dict, main: dict) -> dict:
    """One dtype's bucketed test path, counts from zero around it only:
    ``cli test --buckets auto`` of the checkpoint the main path decoded,
    against that unbucketed decode. f32: each line that differs must be a
    near-tie (the two runs' best-beam probabilities for the sample within
    1e-5 relative), and at most 1 of them; bf16: the count is reported.
    Then the decode loop with and without buckets in turns, and the paper's
    metrics of both."""
    from fira_tpu_torch import cli
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.decode.runner import run_test
    from fira_tpu_torch.model.model import FiraModel

    cs, ds, work, cfg = ctx["cs"], ctx["ds"], ctx["work"], ctx["cfg"]
    dtype = run["gated"].compute_dtype
    data = ds.splits["test"]
    n_test = len(data)
    bcfg = cfg.replace(buckets=B.choose_buckets(data, cfg),
                       compute_dtype=dtype)
    plan = B.decode_plan(data, bcfg)
    out_dir = os.path.join(work, f"out_buckets_{dtype}")
    cs.copy_scores.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["test", "--config", "fira-full", "--data-dir",
                   ctx["data_dir"], "--out-dir", out_dir, "--ckpt-dir",
                   run["ckpt_dir"], "--dtype", dtype, "--buckets", "auto"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    check(rc == 0, f"cli test --buckets auto --dtype {dtype} exited {rc}")
    want = len(plan) * (cfg.tar_len - 1)
    check(k1 == want, f"{dtype}: copy_score launched {k1} times on the "
          f"bucketed test path, expected {want}")
    out_file = os.path.join(out_dir, "output_fira")
    with open(out_file, "rb") as f:
        out_bytes = f.read()
    a = main["out_bytes"].decode().split("\n")
    b = out_bytes.decode().split("\n")
    check(len(a) == len(b) == n_test + 1, f"{len(b) - 1} lines for {n_test}")
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    note = ""
    if diff:
        ties = [decode_best_probs(torch, ctx, dtype, run["state_dict"],
                                  set(diff), c)
                for c in (cfg.replace(compute_dtype=dtype), bcfg)]
        rels = [abs(ties[1][i] - ties[0][i]) / abs(ties[0][i]) for i in diff]
        note = (" (best-beam probabilities of those samples, unbucketed vs "
                "bucketed: " + ", ".join(
                    f"#{i} {ties[0][i]:.8g} vs {ties[1][i]:.8g}"
                    for i in diff) + ")")
        if dtype == "float32":
            check(len(diff) <= 1 and max(rels) <= 1e-5,
                  f"f32 bucketed decode: {len(diff)} lines differ{note}")
    print(f"[main buckets {dtype}] cli test --buckets auto --dtype {dtype}: "
          f"{len(plan)} batches at "
          + ", ".join(f"{sum(g == h for _, h in plan)} x "
                      f"{':'.join(map(str, g))}"
                      for g in dict.fromkeys(g for _, g in plan))
          + f"; copy_score launches {k1} (expected {want}); wall "
          f"{wall:.2f} s incl. data and weight load = {n_test / wall:.2f} "
          f"commits/s; {len(diff)} of {n_test} lines differ from the "
          f"unbucketed decode{note}", flush=True)
    model = FiraModel(cfg, device="cuda", dtype=dtype)
    model.load_state_dict(run["state_dict"])
    rates = {"unbucketed": [], "bucketed": []}
    for label in ("unbucketed", "bucketed", "bucketed", "unbucketed"):
        c = bcfg if label == "bucketed" else cfg.replace(compute_dtype=dtype)
        t0 = time.perf_counter()
        run_test(model, ds, c, out_dir=os.path.join(work, f"turn_{dtype}"),
                 var_maps=ctx["var_maps"])
        torch.cuda.synchronize()
        rates[label].append(n_test / (time.perf_counter() - t0))
    print(f"[main buckets {dtype}] decode loop commits/s in turns u b b u: "
          + "; ".join(f"{k} " + " ".join(f"{r:.2f}" for r in v)
                      for k, v in rates.items())
          + f"; metrics of the bucketed output_fira: "
          f"{paper_metrics(out_file, ctx['gt_file'])} (unbucketed: "
          f"{paper_metrics(main['out_file'], ctx['gt_file'])})", flush=True)
    return dict(k1=k1)


# (kv_cache, factored_topk, prob_space) of every beam mode
BEAM_MODES = [(kv, fac, prob) for kv in (True, False) for fac in (False, True)
              for prob in (True, False)]


def mode_name(kv, fac, prob, early) -> str:
    return (f"{'cached' if kv else 'prefix'}/{'factored' if fac else 'fused'}"
            f"/{'prob' if prob else 'log'}/{'early' if early else 'full'}")


def decode_split(torch, ctx, model, c, batches) -> dict:
    """The test split through ``make_beam_search(model, c)``: the beam loop
    alone timed over batches already on the card (host wall to a
    synchronise), K1's launches counted around it; then each sample's line
    cooked as ``run_test`` cooks it (``runner.sample_emitter``), in split
    order."""
    from types import SimpleNamespace

    from fira_tpu_torch.decode.beam import make_beam_search
    from fira_tpu_torch.decode.runner import sample_emitter

    cs, ds = ctx["cs"], ctx["ds"]
    search = make_beam_search(model, c, with_steps=True)
    cs.copy_scores.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [search(dev) for _, _, dev in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    lines = {}
    n = sum(int(h["valid"].sum()) for _, h, _ in batches)
    emit = sample_emitter(
        SimpleNamespace(add=lines.__setitem__, flush=lambda: None),
        vocab=ds.word_vocab, cfg=c, bleu_by_pos={}, n_total=n,
        var_maps=ctx["var_maps"], indices=ds.split_indices["test"])
    toks, probs, best = [], [], {}
    for (chunk, host, _), (t, p, _) in zip(batches, outs):
        t, p = t.cpu().numpy(), p.cpu().numpy()
        toks.append(t)
        probs.append(p)
        for i in np.flatnonzero(host["valid"]):
            emit(int(chunk[i]), host, i, t[i], p[i])
            best[int(chunk[i])] = float(p[i].max())
    return dict(toks=toks, probs=probs, steps=[o[2] for o in outs], k1=k1,
                rate=n / wall, best=best,
                out="".join(lines[i] for i in sorted(lines)).encode())


def n_lines_differ(a: bytes, b: bytes) -> list:
    return [i for i, (x, y) in enumerate(zip(a.decode().split("\n"),
                                             b.decode().split("\n")))
            if x != y]


def zero_score_lines(diff: list, a: dict, b: dict) -> list:
    """The differing lines whose best-beam score is zero in both decodes:
    every prob-space beam score of the sample underflowed (and was flushed
    to zero, as XLA flushes), so exact ties decide its tokens."""
    return [i for i in diff if a["best"][i] == 0 == b["best"][i]]


def beam_modes(torch, ctx, run: dict, main: dict) -> dict:
    """Every beam mode on one dtype's trained checkpoint and (f32) on its
    copy biased toward <eos> (``beam.eos_biased``, every beam finishes
    within a few positions): cached and full-prefix, fused and factored, prob and
    log space, each with early exit off and on, over the test split. K1
    must launch once a step run. Checks (f32; bf16 reported): early exit
    against the full scan, tokens and probabilities bitwise equal, fewer
    than tar_len - 1 steps on the biased weights; factored against fused,
    the same output bytes but for samples whose every prob-space score
    underflowed to zero (there the two modes tie-break over different
    candidate sets, in the JAX package too); full-prefix against cached,
    besides such samples at most one line differing, at a near-tie of
    best-beam scores (1e-5 relative). Both
    dtypes: the default mode's output is the ``cli test`` bytes. Log space
    against prob space: the lines that differ and B-Norm BLEU, reported."""
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import batch_to_device
    from fira_tpu_torch.decode.beam import eos_biased
    from fira_tpu_torch.eval import bnorm_bleu_files
    from fira_tpu_torch.model.model import FiraModel

    ds, cfg, work = ctx["ds"], ctx["cfg"], ctx["work"]
    dtype = run["gated"].compute_dtype
    f32 = dtype == "float32"
    c0 = cfg.replace(compute_dtype=dtype)
    data, bs, T = ds.splits["test"], cfg.test_batch_size, cfg.tar_len
    batches = []
    for chunk, geom in B.decode_plan(data, c0):
        host = make_batch(data, chunk, c0, batch_size=bs, geom=geom)
        batches.append((chunk, host, batch_to_device(host,
                                                     torch.device("cuda"))))
    model = FiraModel(c0, device="cuda", dtype=dtype).eval()
    got, k1, prefix_k1 = {}, 0, 0
    # bf16, whose checks are reported, runs the trained weights only (the
    # smoke's time limit; f32 holds the early exit on the biased ones)
    sets = [("trained", run["state_dict"])]
    if f32:
        sets.append(("eos-biased", eos_biased(run["state_dict"])))
    for weights, sd in sets:
        model.load_state_dict(sd)
        for kv, fac, prob in BEAM_MODES:
            for early in (False, True):
                c = c0.replace(beam_kv_cache=kv, beam_factored_topk=fac,
                               beam_compat_prob_space=prob,
                               beam_early_exit=early)
                r = decode_split(torch, ctx, model, c, batches)
                check(r["k1"] == sum(r["steps"]),
                      f"{dtype} {weights} {mode_name(kv, fac, prob, early)}"
                      f": copy_score launched {r['k1']} times for "
                      f"{sum(r['steps'])} beam steps")
                check(early or r["steps"] == [T - 1] * len(batches),
                      f"full scan ran {r['steps']} steps")
                k1 += r["k1"]
                prefix_k1 += 0 if kv else r["k1"]
                got[weights, kv, fac, prob, early] = r
        default = got[weights, True, False, True, False]
        if weights == "trained":
            check(default["out"] == main["out_bytes"],
                  f"{dtype}: the smoke's decode of the default mode differs "
                  f"from cli test's output_fira")
        for kv, fac, prob in BEAM_MODES:
            full, ee = (got[weights, kv, fac, prob, e] for e in (False, True))
            same = all(np.array_equal(a, b) for a, b in zip(
                full["toks"] + full["probs"], ee["toks"] + ee["probs"]))
            label = f"{dtype} {weights} {mode_name(kv, fac, prob, True)}"
            if f32:
                check(same, f"{label}: early exit differs from the full scan")
                check(weights == "trained" or max(ee["steps"]) < T - 1,
                      f"{label}: {ee['steps']} steps on the <eos>-biased "
                      f"weights")
            print(f"[beam modes {dtype}] {weights} "
                  f"{mode_name(kv, fac, prob, True)}: steps run "
                  f"{ee['steps']} of {T - 1} a batch, tokens and scores "
                  f"bitwise equal to the full scan: {same}; beam loop "
                  f"commits/s full {full['rate']:.2f}, early "
                  f"{ee['rate']:.2f}", flush=True)
        for kv, prob, early in ((kv, prob, early) for kv in (True, False)
                                for prob in (True, False)
                                for early in (False, True)):
            fused = got[weights, kv, False, prob, early]
            fac = got[weights, kv, True, prob, early]
            diff = n_lines_differ(fused["out"], fac["out"])
            tied = zero_score_lines(diff, fused, fac)
            name = mode_name(kv, True, prob, early)
            if f32:
                check(len(tied) == len(diff), f"{dtype} {weights} {name}: "
                      f"{len(diff) - len(tied)} lines with a nonzero best "
                      f"score differ from fused")
            print(f"[beam modes {dtype}] {weights} {name} vs fused: "
                  f"{len(diff)} of {len(data)} lines differ, {len(tied)} of "
                  f"them with every beam score underflowed to zero; beam "
                  f"loop commits/s factored {fac['rate']:.2f}, fused "
                  f"{fused['rate']:.2f}", flush=True)
        for fac, prob in ((f, p) for f in (False, True) for p in (True, False)):
            cached = got[weights, True, fac, prob, False]
            prefix = got[weights, False, fac, prob, False]
            diff = n_lines_differ(cached["out"], prefix["out"])
            tied = zero_score_lines(diff, cached, prefix)
            rest = [i for i in diff if i not in tied]
            rels = [abs(prefix["best"][i] - cached["best"][i])
                    / abs(cached["best"][i]) for i in rest]
            name = mode_name(False, fac, prob, False)
            note = ", ".join(f"#{i} {cached['best'][i]:.8g} vs "
                             f"{prefix['best'][i]:.8g}" for i in rest)
            if f32:
                check(len(rest) <= 1 and max(rels, default=0.0) <= 1e-5,
                      f"{dtype} {weights} {name}: {len(rest)} lines with a "
                      f"nonzero best score differ from cached ({note})")
            print(f"[beam modes {dtype}] {weights} {name} vs "
                  f"cached: {len(diff)} of {len(data)} lines differ, "
                  f"{len(tied)} of them with every beam score underflowed "
                  f"to zero"
                  + (f" (best-beam scores of the others, cached vs prefix: "
                     f"{note})" if rest else "")
                  + f"; beam loop commits/s prefix {prefix['rate']:.2f}, "
                  f"cached {cached['rate']:.2f}", flush=True)
        for kv, fac in ((k, f) for k in (True, False) for f in (False, True)):
            files = []
            for prob in (True, False):
                path = os.path.join(work, f"modes_{dtype}_{weights}_{kv}_"
                                          f"{fac}_{prob}")
                with open(path, "wb") as f:
                    f.write(got[weights, kv, fac, prob, False]["out"])
                files.append(path)
            diff = n_lines_differ(*(got[weights, kv, fac, p, False]["out"]
                                    for p in (True, False)))
            print(f"[beam modes {dtype}] {weights} "
                  f"{mode_name(kv, fac, False, False)} vs prob space: "
                  f"{len(diff)} of {len(data)} lines differ; B-Norm BLEU "
                  f"log {bnorm_bleu_files(files[1], ctx['gt_file'])!r}, "
                  f"prob {bnorm_bleu_files(files[0], ctx['gt_file'])!r}",
                  flush=True)
    # the cached modes a user picks between, on the trained weights, timed
    # in turns a b c d d c b a (one decode each is noisy on a shared host)
    model.load_state_dict(run["state_dict"])
    turns = {"fused": (False, False), "factored": (True, False),
             "fused+early": (False, True), "factored+early": (True, True)}
    rates = {name: [] for name in turns}
    for name in [*turns, *reversed(turns)]:
        fac, early = turns[name]
        r = decode_split(torch, ctx, model, c0.replace(
            beam_factored_topk=fac, beam_early_exit=early), batches)
        k1 += r["k1"]
        rates[name].append(r["rate"])
    print(f"[beam modes {dtype}] trained, cached, prob space, beam loop "
          f"commits/s in turns a b c d d c b a: "
          + "; ".join(f"{name} " + " ".join(f"{x:.2f}" for x in v)
                      for name, v in rates.items()), flush=True)
    print(f"[beam modes {dtype}] copy_score launches over the "
          f"{len(got) + 2 * len(turns)} decodes: {k1} ({prefix_k1} at the "
          f"full-prefix shape ({bs * cfg.beam_size}, {T}, {cfg.copy_len}, "
          f"{cfg.embedding_dim}))", flush=True)
    return dict(k1=k1, out={k: r["out"] for k, r in got.items()})


ENCODER_VARIANTS = {
    "default": {},
    "split": dict(encoder_buffer="split"),
    "segment": dict(adjacency_impl="segment"),
    "segment sorted": dict(adjacency_impl="segment", sort_edges=True),
    "flat": dict(flat_scatter=True),
    "typed": dict(typed_edges=True),
}


def encoder_variants(torch, ctx, dtype: str) -> dict:
    """One epoch of ``train.loop.train`` under each encoder variant (and
    the default path beside them), no gate, counts from zero around each:
    K1 and K2 must launch once a step; steps/s, commits/s and peak device
    memory of each, also less what was allocated before it started."""
    from fira_tpu_torch.train import loop as train_loop

    cs, ds, cfg, work = ctx["cs"], ctx["ds"], ctx["cfg"], ctx["work"]
    steps = math.ceil(len(ds.splits["train"]) / cfg.batch_size)
    total = {"k1": 0, "k2": 0}
    for name, knobs in ENCODER_VARIANTS.items():
        c = cfg.replace(compute_dtype=dtype, dev_start_epoch=10**6, **knobs)
        cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        r = train_loop.train(
            ds, c, device="cuda",
            out_dir=os.path.join(work, f"variant_{dtype}_{name}"),
            epochs=1, resume=False)
        torch.cuda.synchronize()
        k1, k2 = cs.copy_scores.launches, cs.copy_scores_backward.launches
        peak = torch.cuda.max_memory_allocated()
        check(r.steps == steps and k1 == k2 == steps,
              f"{dtype} {name}: {r.steps} steps, copy_score {k1}, "
              f"copy_score_bwd {k2} launches, expected {steps}")
        check(all(math.isfinite(x) for x in r.losses),
              f"{dtype} {name}: non-finite loss {r.losses}")
        total["k1"] += k1
        total["k2"] += k2
        print(f"[encoder variants {dtype}] train.loop.train {name} ("
              + (" ".join(f"{k}={v}" for k, v in knobs.items()) or "dense, "
                 "single buffer")
              + f"), 1 epoch: {r.steps} steps, steps/s {r.steps_per_sec:.3f}, "
              f"training commits/s {r.commits_per_sec:.2f} (first interval "
              f"and checkpoint writes excluded); launches copy_score {k1}, "
              f"copy_score_bwd {k2}; peak device memory "
              f"{peak / 2**20:.1f} MiB ({(peak - before) / 2**20:.1f} above "
              f"what was allocated before); losses "
              + " ".join(f"{x:.4f}" for x in r.losses), flush=True)
    return total


def encoder_checks(torch, ctx) -> None:
    """Each encoder variant on one chunk of the train split against the
    default path (dense adjacency, single buffer) from the same weights,
    dropout off. f32 (bf16 reported): split and segment, loss within 1e-5
    relative and each gradient within 1e-4 of its norm; flat scatter, the
    adjacency bit-identical; typed edges at init (gains 1), the loss
    bit-equal, and every ``edge_gain`` gradient finite, not all zero. The
    peak device memory of each forward/backward."""
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
    from fira_tpu_torch.model.model import FiraModel, dense_adjacency

    ds, cfg = ctx["ds"], ctx["cfg"]
    split, bs, dev = ds.splits["train"], cfg.batch_size, torch.device("cuda")
    chunk = np.arange(bs)

    def on_card(c):
        return batch_to_device(make_batch(split, chunk, c, batch_size=bs),
                               dev, TRAIN_FIELDS)

    def measured(model, batch):
        """The loss and gradients, and the peak memory of the forward and
        backward above what was allocated before them."""
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        out = _loss_grads(torch, model, batch)
        return out, (torch.cuda.max_memory_allocated() - before) / 2**20

    quiet = dict(dropout_rate=0.0, gcn_dropout_rate=0.0)
    for dtype in ("float32", "bfloat16"):
        f32 = dtype == "float32"
        c = cfg.replace(compute_dtype=dtype, **quiet)
        model = FiraModel(c, device=dev).init_parameters(
            torch.Generator().manual_seed(SEED)).eval()
        base, base_peak = measured(model, on_card(c))
        print(f"[encoder checks {dtype}] default path, one chunk of {bs}: "
              f"loss {base[0]!r}, forward/backward peak {base_peak:.1f} MiB "
              f"above the weights, batch and gradients held before it",
              flush=True)
        for name in ("split", "segment", "segment sorted", "typed"):
            cv = c.replace(**ENCODER_VARIANTS[name])
            mv = FiraModel(cv, device=dev).eval()
            mv.load_state_dict(model.state_dict(), strict=name != "typed")
            got, peak = measured(mv, on_card(cv))
            rel = abs(got[0] - base[0]) / abs(base[0])
            check(got[1] == base[1], f"{dtype} {name}: token counts")
            if name == "typed":
                g = got[2].pop("edge_gain")
                ok = bool(torch.isfinite(g).all()) and bool((g != 0).any())
                if f32:
                    check(got[0] == base[0], f"typed at init: loss "
                          f"{got[0]!r} vs {base[0]!r}")
                    check(ok, f"typed at init: edge_gain gradient {g}")
                equal = ("bit-equal" if got[0] == base[0]
                         else f"{rel:.3e} relative")
                what = (f"loss {got[0]!r} ({equal}), edge_gain gradient "
                        + " ".join(f"{x:.4g}" for x in g.tolist()))
            else:
                if name == "segment":
                    again, _ = measured(mv, on_card(cv))
                    repeat = (again[0] == got[0] and all(torch.equal(
                        again[2][k], v) for k, v in got[2].items()))
                    print(f"[encoder checks {dtype}] segment twice on the "
                          f"same chunk: loss and gradients bitwise equal: "
                          f"{repeat}", flush=True)
                    del again
                g_err, g_name = grad_rel_err(torch, got[2], base[2])
                if f32:
                    check(rel <= 1e-5, f"{name} loss {rel:.3e}")
                    check(g_err <= 1e-4, f"{name} gradient {g_name} "
                          f"{g_err:.3e}")
                what = (f"loss {got[0]!r} ({rel:.3e} relative"
                        f"{', limit 1e-5' if f32 else ''}), worst gradient "
                        f"{g_name} {g_err:.3e} of its norm"
                        f"{' (limit 1e-4)' if f32 else ''}")
            print(f"[encoder checks {dtype}] {name} vs default: {what}; "
                  f"forward/backward peak {peak:.1f} MiB", flush=True)
            del mv, got
        b = on_card(c.replace(flat_scatter=True))
        n = cfg.graph_len
        flat, nd = (dense_adjacency(b["senders"], b["receivers"], b["values"],
                                    n, out_dtype=model.dtype, flat=f)
                    for f in (True, False))
        same = torch.equal(flat, nd)
        check(same or not f32, "flat scatter: adjacency differs")
        print(f"[encoder checks {dtype}] flat scatter: ({bs}, {n}, {n}) "
              f"adjacency bit-identical to the N-D scatter: {same}",
              flush=True)
        del model, base, b, flat, nd


def cli_new_flags(torch, ctx, run: dict, modes: dict) -> dict:
    """The new flags through the entry points, counts from zero around
    each: ``cli test --beam-factored-topk --beam-early-exit`` of the f32
    checkpoint must write the bytes of ``beam_modes``' decode in that mode
    (which it held against the fused full scan); ``cli train`` one epoch
    with ``--encoder-buffer split`` and with ``--adjacency segment`` must
    launch K1 and K2 once a step."""
    from fira_tpu_torch import cli

    cs, ds, cfg, work = ctx["cs"], ctx["ds"], ctx["cfg"], ctx["work"]
    common = ["--config", "fira-full", "--data-dir", ctx["data_dir"],
              "--dtype", "float32"]
    out_dir = os.path.join(work, "out_factored_early")
    cs.copy_scores.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["test", *common, "--out-dir", out_dir, "--ckpt-dir",
                   run["ckpt_dir"], "--beam-factored-topk",
                   "--beam-early-exit"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    check(rc == 0, f"cli test --beam-factored-topk --beam-early-exit exited "
          f"{rc}")
    with open(os.path.join(out_dir, "output_fira"), "rb") as f:
        out = f.read()
    n_test = len(ds.splits["test"])
    most = math.ceil(n_test / cfg.test_batch_size) * (cfg.tar_len - 1)
    want = modes["out"]["trained", True, True, True, True]
    check(out == want, f"cli test --beam-factored-topk --beam-early-exit: "
          f"{len(n_lines_differ(out, want))} lines differ from the same "
          f"mode's decode")
    check(0 < k1 <= most, f"copy_score launched {k1} times (at most {most})")
    print(f"[cli flags] cli test --beam-factored-topk --beam-early-exit "
          f"--dtype float32: output_fira byte-identical to the beam modes' "
          f"decode in that mode; "
          f"copy_score launches {k1} (the full scan: {most}); wall "
          f"{wall:.2f} s incl. data and weight load = {n_test / wall:.2f} "
          f"commits/s", flush=True)
    total = {"k1": k1, "k2": 0}
    steps = math.ceil(len(ds.splits["train"]) / cfg.batch_size)
    for flags in (["--encoder-buffer", "split"], ["--adjacency", "segment"]):
        cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.main(["train", *common, "--out-dir",
                       os.path.join(work, f"train_cli_{flags[1]}"),
                       "--epochs", "1", "--no-resume", *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1, k2 = cs.copy_scores.launches, cs.copy_scores_backward.launches
        check(rc == 0, f"cli train {' '.join(flags)} exited {rc}")
        check(k1 == k2 == steps, f"cli train {' '.join(flags)}: copy_score "
              f"{k1}, copy_score_bwd {k2} launches, expected {steps}")
        total["k1"] += k1
        total["k2"] += k2
        print(f"[cli flags] cli train fira-full {' '.join(flags)} --dtype "
              f"float32: 1 epoch, {steps} steps, wall {wall:.2f} s incl. data "
              f"load; launches copy_score {k1}, copy_score_bwd {k2}; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
              f" MiB", flush=True)
    return total


def staged_batches(torch, ctx, c) -> list:
    """The test split's decode plan, each batch built on the host (with
    its rows' split positions) and copied to the card once."""
    from fira_tpu_torch.data import buckets as B
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import batch_to_device

    data, bs = ctx["ds"].splits["test"], c.test_batch_size
    out = []
    for chunk, geom in B.decode_plan(data, c):
        host = make_batch(data, chunk, c, batch_size=bs, geom=geom)
        host["_positions"] = B.positions_of(chunk, bs)
        out.append((chunk, host, batch_to_device(host, torch.device("cuda"))))
    return out


def settle_positions(r: dict) -> dict:
    """{split position: the position at which its last beam emitted
    <eos> (tar_len - 1 if one never did)} from a decode's tokens."""
    from fira_tpu_torch.data.vocab import EOS_ID

    out = {}
    for pos, toks in r["toks_by_pos"].items():
        ends = [int(np.argmax(row == EOS_ID)) if (row == EOS_ID).any()
                else row.shape[0] - 1 for row in toks]
        out[pos] = max(ends)
    return out


def with_positions(r: dict, batches: list) -> dict:
    """A ``decode_split`` result with its tokens keyed by split position."""
    r["toks_by_pos"] = {int(chunk[i]): t[i] for (chunk, host, _), t in
                        zip(batches, r["toks"])
                        for i in np.flatnonzero(host["valid"])}
    return r


def engine_decode(torch, ctx, model, c, batches, slots=None,
                  eng=None) -> dict:
    """The test split through a ``SlotEngine`` over batches already on the
    card (the engine's loop alone timed, host wall to a synchronise,
    after one prewarm, or on ``eng``, a warm engine), K1's launches
    counted around it (``k1_formula``), the peak device memory above what
    was allocated before it, the allocator's health after it; each
    settled sample cooked as ``run_test`` cooks it."""
    from types import SimpleNamespace

    from fira_tpu_torch.decode import engine
    from fira_tpu_torch.decode.runner import sample_emitter

    cs, ds = ctx["cs"], ctx["ds"]
    if eng is None:
        eng = engine.SlotEngine(model, c, slots=slots)
        eng.prewarm([batches[0][1]])
    else:   # a warm engine reused: this run's counts only
        eng.stats = engine.EngineStats(slots=eng.slots)
    feed = [SimpleNamespace(index=i, host=h, device=d)
            for i, (_, h, d) in enumerate(batches)]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cs.copy_scores.launches = 0
    t0 = time.perf_counter()
    items = list(eng.run(feed))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    peak = torch.cuda.max_memory_allocated() - held
    lines = {}
    emit = sample_emitter(
        SimpleNamespace(add=lines.__setitem__, flush=lambda: None),
        vocab=ds.word_vocab, cfg=c, bleu_by_pos={}, n_total=len(items),
        var_maps=ctx["var_maps"], indices=ds.split_indices["test"])
    for it in items:
        emit(it.position, it.host, it.row, it.tokens, it.probs)
    st = eng.stats.summary()
    R = max(1, c.engine_harvest_every)
    want, formula = k1_formula(dict(st, warm_step_dispatches=0), R,
                               c.engine_spec_k if c.spec_decode != "off"
                               else 0)
    check(k1 == want, f"engine: copy_score launched {k1} times, {want} = "
          f"{formula}")
    errs = eng.allocator_invariants()
    check(not errs, f"engine allocator after the run: {errs}")
    return dict(out="".join(lines[i] for i in sorted(lines)).encode(),
                rate=len(items) / wall, stats=st, k1=k1, peak=peak, eng=eng,
                best={it.position: float(it.probs.max()) for it in items},
                probs={it.position: it.probs for it in items})


def k1_formula(s: dict, R: int, k: int = 0) -> tuple:
    """K1's launches an engine run owes from its own counters: R a plain
    step dispatch and a prewarm, one a verify frame, k a draft (one a
    verify dispatch and one a prewarm when spec is on, ``k`` > 0);
    (count, the formula in words)."""
    plain = s["step_dispatches"] - s["verify_dispatches"]
    warm = s.get("warm_step_dispatches", 0)
    drafts = s["verify_dispatches"] + (warm if k else 0)
    want = R * (plain + warm) + s["spec_frames"] + k * drafts
    text = (f"{R} x ({plain} plain dispatches + {warm} prewarms) + "
            f"{s['spec_frames']} verify frames + {k} x {drafts} drafts")
    return want, text


def engine_cli(torch, ctx, run: dict, name: str, flags: list,
               spec_k: int = 0) -> dict:
    """``cli test --dtype float32`` with ``flags`` on the f32 checkpoint,
    counts from zero around it; its printed lines kept and echoed; K1
    must launch once a micro-step (prewarm's dispatch included), and
    under spec decode (``spec_k`` its draft length) as ``k1_formula``
    says."""
    import contextlib
    import io

    from fira_tpu_torch import cli

    cs = ctx["cs"]
    out_dir = os.path.join(ctx["work"], f"out_engine_{name}")
    buf = io.StringIO()
    cs.copy_scores.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["test", "--config", "fira-full", "--data-dir",
                       ctx["data_dir"], "--out-dir", out_dir, "--ckpt-dir",
                       run["ckpt_dir"], "--dtype", "float32", *flags])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    printed = buf.getvalue()
    check(rc == 0, f"cli test {' '.join(flags)} exited {rc}: {printed}")
    summary = None
    for line in printed.splitlines():
        if line.startswith("engine: "):
            summary = json.loads(line[len("engine: "):])
        elif line.startswith(("decode table", "buckets")):
            print(f"[engine] cli test {' '.join(flags)}: {line}", flush=True)
    formula = None
    if summary is not None:
        want, formula = k1_formula(summary, ctx["cfg"].engine_harvest_every,
                                   spec_k)
        check(k1 == want, f"cli test {' '.join(flags)}: copy_score launched "
              f"{k1} times, {want} = {formula}")
    path = os.path.join(out_dir, "output_fira")
    with open(path, "rb") as f:
        out = f.read()
    return dict(out=out, k1=k1, wall=wall, summary=summary, path=path,
                formula=formula)


def engine_run_test(torch, ctx, run: dict, name: str, knobs: dict) -> dict:
    """``run_test`` with the engine and ``knobs`` (the full-prefix beam has
    no CLI flag) on the f32 checkpoint's weights, counts from zero around
    it; K1 must launch once a micro-step (prewarm's dispatch included)."""
    from fira_tpu_torch.decode.runner import run_test
    from fira_tpu_torch.model.model import FiraModel

    cs = ctx["cs"]
    c = ctx["cfg"].replace(decode_engine=True, **knobs)
    model = FiraModel(c, device="cuda").eval()
    model.load_state_dict(run["state_dict"])
    out_dir = os.path.join(ctx["work"], f"out_engine_{name.replace('/', '_')}")
    cs.copy_scores.launches = 0
    t0 = time.perf_counter()
    m = run_test(model, ctx["ds"], c, out_dir=out_dir,
                 var_maps=ctx["var_maps"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = cs.copy_scores.launches
    s = m["engine"]
    want = c.engine_harvest_every * (s["step_dispatches"]
                                     + s["warm_step_dispatches"])
    check(k1 == want, f"run_test {name}: copy_score launched {k1} times, "
          f"{want} micro-steps")
    with open(m["output_path"], "rb") as f:
        out = f.read()
    return dict(out=out, k1=k1, wall=wall, summary=s,
                path=m["output_path"])


def engine_phase(torch, ctx, run32: dict, run16: dict, modes: dict) -> tuple:
    """The slot engine. Hard checks on the f32 trained checkpoint: ``cli
    test --engine`` writes the batched decode's bytes (``beam_modes``'
    full scans) in the four kv x factored modes, in prob and log space,
    with the arena paged and unpaged; on a copy biased toward <eos> so
    that samples settle at 3 or more positions, the engine's bytes equal
    the batched early exit's; ``--perf production`` writes the engine's
    bytes in its mode; the allocator is healthy after every run and K1
    launches once a micro-step. Reported: lines that differ at 8 and 64
    slots, ``--buckets auto --decode-tar-buckets`` and its B-Norm BLEU;
    then, f32 and bf16, the engine against the batched early exit beam in
    turns a b b a (commits/s, occupancy, steps per commit, pool use,
    bytes a slot, peak memory above what was held, host syncs a
    dispatch) on the trained and the mixed-depth weights, and one warm
    engine dispatch profiled. Returns K1's launches a dtype and the bytes of
    ``cli test --engine`` in the default mode (cached, fused, prob space,
    paged)."""
    from collections import Counter

    from fira_tpu_torch.decode.beam import eos_biased
    from fira_tpu_torch.eval import bnorm_bleu_files
    from fira_tpu_torch.model.model import FiraModel

    cfg, ds = ctx["cfg"], ctx["ds"]
    n_test = len(ds.splits["test"])
    k1 = {"float32": 0, "bfloat16": 0}
    engine_out = {}
    for kv, fac, prob in BEAM_MODES:
        for paged in ((True, False) if kv else (False,)):
            name = (mode_name(kv, fac, prob, False).replace("/full", "")
                    + ("/paged" if paged else "/unpaged" if kv else ""))
            flags = (["--engine"] + (["--beam-factored-topk"] if fac else [])
                     + ([] if prob else ["--beam-log-space"])
                     + ([] if paged else ["--kv-paged", "off"]))
            if not kv:
                # the full prefix: the named config caches; a flag cannot
                # turn it off, so run_test takes the config directly
                r = engine_run_test(torch, ctx, run32, name, dict(
                    beam_kv_cache=False, beam_factored_topk=fac,
                    beam_compat_prob_space=prob))
            else:
                r = engine_cli(torch, ctx, run32, name.replace("/", "_"),
                               flags)
            k1["float32"] += r["k1"]
            want = modes["out"]["trained", kv, fac, prob, False]
            diff = n_lines_differ(r["out"], want)
            check(not diff, f"engine {name}: {len(diff)} of {n_test} lines "
                  f"differ from the batched decode")
            engine_out[kv, fac, prob, paged] = r["out"]
            s = r["summary"]
            print(f"[engine] {name} f32, trained: output_fira byte-identical "
                  f"to the batched decode; copy_score launches {r['k1']} = "
                  f"4 x ({s['step_dispatches']} + "
                  f"{s['warm_step_dispatches']} warm) dispatches; steps "
                  f"{s['steps_run']}, occupancy {s['slot_occupancy']}, "
                  f"host syncs {s['host_syncs']}", flush=True)
    # --perf production: the engine with the cached, factored, early-exit
    # beam; its bytes are the engine's in that mode
    r = engine_cli(torch, ctx, run32, "production", ["--perf", "production"])
    k1["float32"] += r["k1"]
    check(r["out"] == engine_out[True, True, True, True],
          f"--perf production: {len(n_lines_differ(r['out'], engine_out[True, True, True, True]))} lines differ from the engine's decode in its mode")
    print(f"[engine] cli test --perf production (f32): byte-identical to "
          f"the engine's cached/factored/prob decode; copy_score launches "
          f"{r['k1']}; {r['summary']['steps_run']} micro-steps "
          f"(early exit), wall {r['wall']:.2f} s incl. data and weight load",
          flush=True)
    r = engine_cli(torch, ctx, run32, "tar_buckets",
                   ["--engine", "--buckets", "auto", "--decode-tar-buckets"])
    k1["float32"] += r["k1"]
    print(f"[engine] cli test --engine --buckets auto --decode-tar-buckets "
          f"(f32): {r['summary']['commits']} commits, "
          f"{r['summary']['steps_run']} micro-steps, pool "
          f"{r['summary']['pool_blocks']} blocks of "
          f"{r['summary']['kv_block_size']}, peak "
          f"{r['summary']['peak_blocks']}; B-Norm BLEU "
          f"{bnorm_bleu_files(r['path'], ctx['gt_file'])!r}", flush=True)

    for run in (run32, run16):
        dtype = run["gated"].compute_dtype
        f32 = dtype == "float32"
        c = cfg.replace(compute_dtype=dtype)
        batches = staged_batches(torch, ctx, c)
        model = FiraModel(c, device="cuda", dtype=dtype).eval()
        weights = {"trained": run["state_dict"]}
        if f32:
            # the smallest <eos> bias under which samples settle at three
            # or more positions (a strong one ends every beam at once)
            for delta in (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0):
                model.load_state_dict(eos_biased(run["state_dict"], delta))
                r = with_positions(decode_split(
                    torch, ctx, model, c.replace(beam_early_exit=True),
                    batches), batches)
                k1[dtype] += r["k1"]
                hist = Counter(settle_positions(r).values())
                if len(hist) >= 3:
                    break
            check(len(hist) >= 3, f"no <eos> bias up to {delta} settles "
                  f"samples at 3 positions: {dict(hist)}")
            ctx["eos_delta"] = delta
            print(f"[engine] mixed-depth weights: out_fc.bias[<eos>] += "
                  f"{delta}; the position of each sample's last <eos>, "
                  f"histogram {dict(sorted(hist.items()))}", flush=True)
        weights["mixed"] = eos_biased(run["state_dict"], ctx["eos_delta"])
        ce = c.replace(beam_early_exit=True)
        # bf16: one turn each (the smoke's time limit)
        order = (("batched", "engine", "engine", "batched") if f32
                 else ("batched", "engine"))
        for wname, sd in weights.items():
            model.load_state_dict(sd)
            got = {"batched": [], "engine": []}
            for which in order:
                if which == "batched":
                    torch.cuda.synchronize()
                    held = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    r = decode_split(torch, ctx, model, ce, batches)
                    r["peak"] = torch.cuda.max_memory_allocated() - held
                else:
                    r = engine_decode(torch, ctx, model, ce, batches)
                k1[dtype] += r["k1"]
                got[which].append(r)
            b, e = got["batched"][0], got["engine"][0]
            diff = n_lines_differ(e["out"], b["out"])
            if f32:
                check(not diff, f"engine, {wname} weights: {len(diff)} lines "
                      f"differ from the batched early exit")
            st = e["stats"]
            print(f"[engine {dtype}] {wname}: engine vs batched early exit "
                  f"(cached/fused/prob, {cfg.test_batch_size} slots), "
                  f"commits/s in turns {' '.join(w[0] for w in order)}: "
                  f"batched " + " ".join(f"{r['rate']:.2f}"
                                          for r in got["batched"])
                  + ", engine " + " ".join(f"{r['rate']:.2f}"
                                           for r in got["engine"])
                  + f"; {len(diff)} of "
                  f"{n_test} lines differ; occupancy {st['slot_occupancy']},"
                  f" steps/commit {st['steps_per_commit']} (batched: "
                  f"{sum(b['steps']) / n_test:.3f}), pool use "
                  f"{st['pool_utilization']}, "
                  f"kv bytes/slot {st['kv_bytes_per_slot']}, host syncs "
                  f"{st['host_syncs']} over {st['step_dispatches']} "
                  f"dispatches = {st['host_syncs'] / st['step_dispatches']:.3f}"
                  f"/dispatch; peak memory above held: engine "
                  f"{e['peak'] / 2**20:.1f} MiB, batched "
                  f"{b['peak'] / 2**20:.1f} MiB; on {ctx['kind']}, "
                  f"{ctx['smi']}", flush=True)
            if wname == "mixed":
                for slots in (8, ENGINE_WIDE):
                    r = engine_decode(torch, ctx, model, ce, batches,
                                      slots=slots)
                    k1[dtype] += r["k1"]
                    st = r["stats"]
                    print(f"[engine {dtype}] mixed, {slots} slots: "
                          f"{len(n_lines_differ(r['out'], b['out']))} of "
                          f"{n_test} lines differ from the batched decode; "
                          f"{r['rate']:.2f} commits/s, occupancy "
                          f"{st['slot_occupancy']}, steps/commit "
                          f"{st['steps_per_commit']}, peak memory above "
                          f"held {r['peak'] / 2**20:.1f} MiB", flush=True)
        # one warm engine dispatch (a step of every slot, then its
        # harvest) on a freshly filled arena, trained weights
        from fira_tpu_torch.decode import engine

        model.load_state_dict(run["state_dict"])
        eng = engine.SlotEngine(model, c)
        eng.prewarm([batches[0][1]])
        eng.admit(batches[0][1], 0, batches[0][2])
        eng.refill()
        profile_one(torch, f"one engine dispatch ({cfg.test_batch_size} "
                    f"slots x 4 micro-steps + harvest, {dtype})",
                    lambda: (eng.step_dispatch(), eng.harvest()))
        del model, eng, batches
    return k1, engine_out[True, False, True, True]


# seeded faults for the [serve] phase's 61 requests (robust/faults.py
# draws): feeder.assemble raise seed 0 at rate 0.02 fires at request 10
# only, corrupt seed 7 at request 3 only; serve.admit seed 1 at rate 0.05
# fires 5 times, never twice for one request (absorbed by one retry);
# engine.step hang seed 0 at rate 0.05 first fires at the 24th step
# dispatch, with requests in flight, and sleeps fault_hang_s (2 s) past
# the 1 s watchdog
SERVE_FAULTS = [
    ("step raise", ["--inject-faults", "engine.step:raise:1:0"]),
    ("step hang", ["--inject-faults", "engine.step:hang:0.05:0",
                   "--dispatch-watchdog-s", "1"]),
    ("assemble raise", ["--inject-faults", "feeder.assemble:raise:0.02:0",
                        "--robust-retries", "0"]),
    ("assemble corrupt", ["--inject-faults",
                          "feeder.assemble:corrupt:0.02:7"]),
    ("admit raise", ["--inject-faults", "serve.admit:raise:0.05:1",
                     "--robust-retries", "1"]),
]


def spawned_children() -> dict:
    """pid -> (libtorch mapped, a CUDA library mapped) for each live child
    of this process that multiprocessing's spawn started, read from
    /proc (nothing is reaped or signalled)."""
    out, me = {}, os.getpid()
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid != me:
                continue
            with open(f"/proc/{d}/cmdline", "rb") as f:
                if b"spawn_main" not in f.read():
                    continue
            with open(f"/proc/{d}/maps") as f:
                maps = f.read()
        except (OSError, IndexError, ValueError):
            continue
        out[int(d)] = ("libtorch" in maps,
                       "libcuda" in maps or "libcudart" in maps)
    return out


def watch_children(fn):
    """``fn()`` while a thread samples :func:`spawned_children` every
    50 ms; returns (fn's result, pid -> flags OR-ed over the samples)."""
    import threading

    seen, done = {}, threading.Event()

    def sample():
        while True:
            for pid, flags in spawned_children().items():
                old = seen.get(pid, (False, False))
                seen[pid] = (old[0] or flags[0], old[1] or flags[1])
            if done.wait(0.05):
                return
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        return fn(), seen
    finally:
        done.set()
        t.join(10.0)


def serve_cli(torch, ctx, run: dict, name: str, flags: list, *,
              data_dir=None, trace=None, sub="serve") -> dict:
    """``cli serve --dtype float32`` with ``flags`` on the f32 checkpoint
    (the phase's replayed trace and the virtual clock; ``data_dir`` and
    ``trace``, when given, in place of the smoke's corpus and the [serve]
    trace, the output under ``work/<sub>/<name>``), counts from zero
    around it; its summary lines kept; ``serve_metrics.json`` must be
    valid JSON with no ``.partial`` left, a dispatch the watchdog
    abandoned must return within ``fault_hang_s`` + 10 s, and K1 must
    launch once a micro-step of the counted dispatches (prewarm's
    included; an abandoned dispatch that woke and launched would add
    more)."""
    import contextlib
    import io
    import threading

    from fira_tpu_torch import cli

    cs = ctx["cs"]
    out_dir = os.path.join(ctx["work"], sub, name.replace(" ", "_"))
    buf = io.StringIO()
    cs.copy_scores.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["serve", "--config", "fira-full", "--data-dir",
                       data_dir or ctx["data_dir"], "--out-dir", out_dir,
                       "--ckpt-dir", run["ckpt_dir"], "--dtype", "float32",
                       "--serve-trace", trace or ctx["serve_trace"],
                       "--serve-clock", "virtual", *flags])
    abandoned = [t for t in threading.enumerate()
                 if t.name == "fira-dispatch-watchdog"]
    t0 = time.perf_counter()
    for t in abandoned:
        t.join(ctx["cfg"].fault_hang_s + 10.0)
    check(not any(t.is_alive() for t in abandoned),
          f"cli serve {name}: an abandoned dispatch is still running")
    woke_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    k1 = cs.copy_scores.launches
    printed = buf.getvalue()
    check(rc == 0, f"cli serve {name} exited {rc}: {printed}")
    mpath = os.path.join(out_dir, "serve_metrics.json")
    with open(mpath) as f:
        metrics = json.load(f)
    check(not os.path.exists(mpath + ".partial"),
          f"cli serve {name}: a .partial metrics file was left")
    s = metrics["engine"]
    want = ctx["cfg"].engine_harvest_every * (
        s["step_dispatches"] + s["warm_step_dispatches"])
    check(k1 == want, f"cli serve {name}: copy_score launched {k1} times, "
          f"{want} micro-steps")
    with open(os.path.join(out_dir, "output_fira"), "rb") as f:
        out = f.read()
    line = [x for x in printed.splitlines() if x.startswith("serve: ")]
    ingest = [x for x in printed.splitlines() if x.startswith("ingest: ")]
    return dict(out=out, metrics=metrics, k1=k1, abandoned=len(abandoned),
                woke_s=woke_s, line=line[0] if line else printed.strip(),
                ingest_line=ingest[0] if ingest else None)


def serve_bytes(m) -> bytes:
    with open(m["output_path"], "rb") as f:
        return f.read()


def serve_phase(torch, ctx, run32: dict, engine_bytes: bytes) -> int:
    """``cli serve`` on one engine (20 slots, the f32 trained checkpoint,
    the 61 test commits). Hard checks: on a replayed trace under the
    virtual clock the output is ``cli test --engine``'s bytes, prefix
    cache off and on; a repeated mix (each sample twice, 122 requests:
    the second pass arriving once the first is half done) writes every
    position's line of its sample, the cache-off run's bytes, with
    prefills saved and followers coalesced; the test batches twice in one
    stream through one engine (the second in reverse batch order), cache
    off and on, write every sample's cold output line, and with the cache
    on the engine's own dedup fans out (reported: which samples moved in
    their probabilities' last bits, with the slot each had cold and in
    the second pass); the engine over
    the test batches, then again from its cache, seats hits whose
    (tokens, probs) equal the cold prefill's bit for bit; the serve output
    under K1 equals it under the plain copy score; wall-clock serving
    writes each request its sample's line; the faults (a raising step
    retires the engine and sheds all with the reason; a step hanging past
    the watchdog retires it with requests in flight, sheds the rest with
    the WatchdogTimeout and its abandoned dispatch returns launching
    nothing; a raising assembly sheds its one request; a corrupt one
    changes at most its own line; admission faults are absorbed by one
    retry) all exit 0 with a valid serve_metrics.json; K1 launches once a
    micro-step. Reported: the engine's drain commits/s, then wall-clock
    serving of the split ``WALL_REPEATS`` times over, cache off, at 0.5x
    and 1.5x that rate (offered, completed, shed, p50/p99 TTFT and
    end-to-end latency, occupancy, host syncs a dispatch, peak memory
    above held), and the device idle share of a 20-request serve under
    the profiler. Returns K1's launches."""
    from types import SimpleNamespace

    from fira_tpu_torch.decode import engine as engine_lib
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.serve import (poisson_times, read_trace, serve_split,
                                      write_trace)

    cs, ds, cfg = ctx["cs"], ctx["ds"], ctx["cfg"]
    t_phase = time.perf_counter()
    n = len(ds.splits["test"])
    os.makedirs(os.path.join(ctx["work"], "serve"))
    ctx["serve_trace"] = os.path.join(ctx["work"], "serve", "trace.txt")
    write_trace(ctx["serve_trace"], poisson_times(n, rate=0.5, seed=3))
    want_lines = engine_bytes.decode().split("\n")
    k1 = 0
    for name, flags in (("cache off", ["--prefix-cache", "off"]),
                        ("cache on", [])):
        r = serve_cli(torch, ctx, run32, name, flags)
        k1 += r["k1"]
        e = r["metrics"]["engine"]
        check(r["out"] == engine_bytes,
              f"cli serve, {name}: "
              f"{len(n_lines_differ(r['out'], engine_bytes))} of {n} lines "
              f"differ from cli test --engine")
        print(f"[serve] cli serve --serve-clock virtual, {name}: output_fira "
              f"byte-identical to cli test --engine; {r['line']}; "
              f"prefills {e['prefills']}, cache misses {e['cache_misses']}, "
              f"copy_score launches {r['k1']}", flush=True)

    c = cfg.replace(decode_engine=True, compute_dtype="float32")
    con = c.replace(prefix_cache=True)
    model = FiraModel(c, device="cuda", dtype="float32").eval()
    model.load_state_dict(run32["state_dict"])
    work = os.path.join(ctx["work"], "serve")

    def serve(name, cc, times, mix=None, eng=None, clock="virtual"):
        return serve_split(model, ds, cc, arrival_times=times,
                           out_dir=os.path.join(work, name), clock=clock,
                           var_maps=ctx["var_maps"], request_mix=mix,
                           engine=eng)

    # --- the repeated mix: the second pass arrives at the first pass's
    # median completion (virtual clock), so its early samples hit the
    # cache and its late ones coalesce onto requests still in flight
    first = serve("pass1", con, np.zeros(n))
    mid = float(np.median([r["done_t"] for r in first["request_records"]]))
    mix = np.concatenate([np.arange(n), np.arange(n)])
    times = np.concatenate([np.zeros(n), np.full(n, mid)])
    cs.copy_scores.launches = 0
    on = serve("repeat_on", con, times, mix)
    k1 += cs.copy_scores.launches
    off = serve("repeat_off", c, times, mix)
    got = serve_bytes(on).decode().split("\n")
    check(got == [want_lines[j] for j in mix] + [""],
          "repeated mix: a line differs from its sample's engine line")
    check(serve_bytes(on) == serve_bytes(off),
          "repeated mix: cache on and off wrote different bytes")
    sv, e = on["serve"], on["engine"]
    check(e["prefills_saved"] > 0 and sv["dedup_coalesced"] > 0,
          f"repeated mix: prefills saved {e['prefills_saved']}, coalesced "
          f"{sv['dedup_coalesced']}")
    print(f"[serve] repeated mix (each of the {n} samples twice, the second "
          f"pass at t={mid}): bytes equal the cache-off run's and each "
          f"sample's engine line; prefills {e['prefills']} (cache off "
          f"{off['engine']['prefills']}), prefills saved "
          f"{e['prefills_saved']}, cache hits {e['cache_hits']} "
          f"(rate {e['cache_hit_rate']}), artifact bytes served "
          f"{e['cache_hbm_bytes_saved']}, coalesced {sv['dedup_coalesced']}"
          f" in {sv['dedup_groups']} groups (largest "
          f"{sv['dedup_fanout_max']}), engine dedup_fanout "
          f"{e['dedup_fanout']}", flush=True)

    # --- a cache hit against its cold prefill, bit for bit: the test
    # batches through a cold engine, then twice through a cached one
    batches = staged_batches(torch, ctx, c)
    feed1 = [SimpleNamespace(index=i, host=h, device=d)
             for i, (_, h, d) in enumerate(batches)]
    again = []
    for i, (_, h, d) in enumerate(batches):
        h2 = dict(h)
        h2["_positions"] = np.where(h["_positions"] >= 0,
                                    h["_positions"] + n, -1)
        again.append(SimpleNamespace(index=len(batches) + i, host=h2,
                                     device=d))
    def same(a, b) -> bool:
        return (np.array_equal(a.tokens, b.tokens)
                and a.probs.tobytes() == b.probs.tobytes())

    def best(it) -> np.ndarray:   # the tokens its output line is made of
        return it.tokens[int(np.argmax(it.probs))]

    def seated(eng) -> dict:
        """position -> the slot it was seated in, read after each refill
        (a coalesced follower has no seat of its own)."""
        where = {}
        refill = eng.refill

        def recording(*a, **k):
            refill(*a, **k)
            for slot, (pid, _h, _r) in eng._busy.items():
                where.setdefault(pid, slot)
        eng.refill = recording
        return where

    cold_eng = engine_lib.SlotEngine(model, c)
    cold_slot = seated(cold_eng)
    cold = {it.position: it for it in cold_eng.run(feed1)}

    def one_stream(name, cc) -> engine_lib.EngineStats:
        """The test batches twice in one stream through one fresh engine,
        the second pass in reverse batch order (its first batches repeat
        samples still in flight): the second pass sits in other slots
        than the cold run's, and with the cache on it is coalesced onto
        first-pass seats still in flight and seated from cache hits.
        Every sample's output tokens
        must equal the cold run's (hard); which samples moved in their
        probabilities' bits, and the slot each had in the cold run and in
        this pass, are printed."""
        eng = engine_lib.SlotEngine(model, cc)
        slot = seated(eng)
        got = {it.position: it for it in eng.run(feed1 + again[::-1])}
        check(all(np.array_equal(best(got[p]), best(cold[p]))
                  and np.array_equal(best(got[p + n]), best(cold[p]))
                  for p in cold),
              f"engine, {name}, the test batches twice in one stream: an "
              f"output line differs from the cold run's")
        first_moved = [p for p in cold if not same(got[p], cold[p])]
        moved, rows = [], []
        for p in cold:
            s0, s1 = cold_slot[p], slot.get(p + n)
            if not same(got[p + n], cold[p]):
                moved.append(p)
                rows.append(f"{p}: slot {s0} -> "
                            f"{'coalesced' if s1 is None else s1}, tokens "
                            f"{'equal' if np.array_equal(got[p + n].tokens, cold[p].tokens) else 'differ'}"
                            f", {float(np.abs(got[p + n].probs - cold[p].probs).max()):.3e}")
        reseated = [p for p in cold if slot.get(p + n) not in (None,
                                                                cold_slot[p])]
        kept = [p for p in cold if slot.get(p + n) == cold_slot[p]]
        st = eng.stats
        print(f"[serve] engine, {name}, the test batches twice in one "
              f"stream: output lines equal the cold run's; first pass "
              f"{len(first_moved)} of {n} samples differ from cold bit for "
              f"bit; second pass {len(moved)} of {n} differ: "
              f"{len([p for p in moved if p in reseated])} of the "
              f"{len(reseated)} seated in another slot, "
              f"{len([p for p in moved if p in kept])} of the {len(kept)} "
              f"in the same slot, "
              f"{len([p for p in moved if slot.get(p + n) is None])} of the "
              f"{n - len(reseated) - len(kept)} coalesced; cache hits "
              f"{st.cache_hits}, dedup_fanout {st.dedup_fanout}, prefills "
              f"{st.prefills}, prefills saved {st.prefills_saved}; moved "
              f"(position: cold slot -> this pass, tokens, largest "
              f"probability difference): {'; '.join(rows) or 'none'}",
              flush=True)
        return st

    one_stream("cache off", c)
    st = one_stream("cache on", con)
    # the engine's own dedup (the serve loop coalesces before it, so the
    # serve runs above leave it at 0)
    check(st.dedup_fanout > 0 and st.cache_hits > 0,
          f"engine, cache on, one stream: dedup_fanout {st.dedup_fanout}, "
          f"cache hits {st.cache_hits}")
    # the same batches twice through one cached engine, the second stream
    # after the first drained: every second-stream row is a cache hit,
    # seated by the schedule (and in the slots) of the cold stream
    warm_eng = engine_lib.SlotEngine(model, con)
    warm_slot = seated(warm_eng)
    cs.copy_scores.launches = 0
    first_pass = {it.position: it for it in warm_eng.run(feed1)}
    cold_misses = warm_eng.stats.cache_misses
    warm = {it.position: it for it in warm_eng.run(again)}
    k1 += cs.copy_scores.launches
    st = warm_eng.stats
    check(st.cache_hits == n and st.prefills_saved == len(batches),
          f"engine, batches twice: {st.cache_hits} hits, "
          f"{st.prefills_saved} prefills saved")
    for p, it in cold.items():
        check(same(first_pass[p], it) and same(warm[p + n], it),
              f"engine, batches twice: position {p} or {p + n} differs from "
              f"its cold prefill")
    print(f"[serve] engine over the test batches, then again with the "
          f"cache on: the {n} second-stream samples (cache hits) equal the "
          f"cold prefill's (tokens, probs) bit for bit, "
          f"{sum(warm_slot[p + n] == cold_slot[p] for p in cold)} of them "
          f"seated in their cold slot; cache misses "
          f"{cold_misses}, then hits {st.cache_hits}, prefills "
          f"{st.prefills} (cold {len(batches)}), prefills saved "
          f"{st.prefills_saved}, artifact bytes served "
          f"{st.cache_hbm_bytes_saved}, host syncs {st.host_syncs} over "
          f"{st.step_dispatches} dispatches", flush=True)

    # --- K1 against the plain copy score on the serve path
    cs.copy_scores.launches = 0
    with_k1 = serve("k1", con, read_trace(ctx["serve_trace"]))
    launched = cs.copy_scores.launches
    k1 += launched
    model.copy_net.score_fn = cs.copy_scores_reference
    plain = serve("plain", con, read_trace(ctx["serve_trace"]))
    model.copy_net.score_fn = cs.copy_scores
    check(cs.copy_scores.launches == launched,
          "the plain serve run launched K1")
    check(serve_bytes(with_k1) == serve_bytes(plain),
          f"serve, K1 vs plain copy score: "
          f"{len(n_lines_differ(serve_bytes(with_k1), serve_bytes(plain)))}"
          f" lines differ")
    print(f"[serve] serve_split (virtual clock, cache on) under K1 vs the "
          f"plain copy score: output_fira byte-identical; K1 launches "
          f"{launched}", flush=True)

    # --- wall-clock serving at 0.5x and 1.5x the engine's drain rate: the
    # split WALL_REPEATS times over, prefix cache off (repeats would hit)
    drain = engine_decode(torch, ctx, model, c, batches)
    k1 += drain["k1"]
    eng = engine_lib.SlotEngine(model, c)
    serve("warm", c, np.zeros(c.test_batch_size), eng=eng)
    wall_mix = np.tile(np.arange(n), WALL_REPEATS)
    for factor in (0.5, 1.5):
        rate = factor * drain["rate"]
        eng.stats = engine_lib.EngineStats(slots=eng.slots)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cs.copy_scores.launches = 0
        m = serve(f"wall_{factor}", c,
                  poisson_times(len(wall_mix), rate, seed=5), wall_mix,
                  eng=eng, clock="wall")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        k1 += cs.copy_scores.launches
        sv, e = m["serve"], m["engine"]
        check(sv["completed"] == sv["offered"] == len(wall_mix),
              f"wall clock {factor}x: {sv['completed']} of {len(wall_mix)} "
              f"completed")
        check(serve_bytes(m).decode().split("\n")
              == [want_lines[j] for j in wall_mix] + [""],
              f"wall clock {factor}x: a line differs from its sample's "
              f"engine line")
        shed = sv["shed_queue_full"] + sv["shed_deadline"] + sv["shed_error"]
        print(f"[serve] wall clock at {factor}x the drain rate "
              f"({drain['rate']:.2f} commits/s), cache off, each line its "
              f"sample's engine line: offered {rate:.2f} req/s "
              f"({sv['offered']} requests, measured "
              f"{sv['offered_rate_rps']}), completed {sv['completed']}, "
              f"shed {shed}; p50/p99 TTFT "
              f"{sv['p50_ttft_s']}/{sv['p99_ttft_s']} s, "
              f"p50/p99 e2e {sv['p50_e2e_s']}/{sv['p99_e2e_s']} s, "
              f"throughput {sv['throughput_rps']} req/s; occupancy "
              f"{e['slot_occupancy']}, host syncs "
              f"{e['host_syncs'] / max(e['step_dispatches'], 1):.3f}"
              f"/dispatch over {e['step_dispatches']} dispatches, "
              f"{sv['rounds']} rounds; peak memory above held "
              f"{peak / 2**20:.1f} MiB; on {ctx['kind']}, {ctx['smi']}",
              flush=True)
    last = {}

    def burst():
        last["m"] = serve("profiled", c, np.zeros(c.test_batch_size),
                          eng=eng)

    profile_one(torch, f"one serve run of {c.test_batch_size} requests "
                f"arriving together (20 slots, cache off)", burst)
    print(f"[serve] the profiled serve run took {last['m']['serve']['rounds']}"
          f" rounds", flush=True)

    # --- faults through the CLI. The step hang runs under a 1 s dispatch
    # watchdog: a full collection of this process's accumulated objects
    # inside a dispatch would count against it, so the objects alive now
    # are collected once and frozen out of later collections (timed)
    import gc

    t0 = time.perf_counter()
    gc.collect()
    gc_s = time.perf_counter() - t0
    n_obj = len(gc.get_objects())
    gc.freeze()
    print(f"[serve] before the fault runs: a full collection took "
          f"{gc_s:.3f} s over {n_obj} tracked objects, then frozen",
          flush=True)
    for name, flags in SERVE_FAULTS:
        r = serve_cli(torch, ctx, run32, name, flags)
        k1 += r["k1"]
        sv, f = r["metrics"]["serve"], r["metrics"].get("faults", {})
        recs = r["metrics"]["request_records"]
        lines = r["out"].decode().split("\n")
        check(len(lines) == n + 1 and len(recs) == n,
              f"cli serve {name}: {len(lines) - 1} lines, {len(recs)} records")
        shed = [r_["position"] for r_ in recs
                if r_["status"] == "shed_error"]
        if name == "step raise":
            check(sv["replica_retirements"] == 1 and sv["completed"] == 0
                  and sv["shed_error"] == n
                  and all("no live replicas" in r_["error"] for r_ in recs),
                  f"cli serve {name}: {sv}")
        elif name == "step hang":
            check(sv["replica_retirements"] == 1 and f == {"engine.step": 1}
                  and 0 < sv["completed"] < n
                  and sv["completed"] + sv["shed_error"] == n
                  and r["abandoned"] == 1
                  and all("no live replicas" in recs[p]["error"]
                          and "WatchdogTimeout" in recs[p]["error"]
                          for p in shed),
                  f"cli serve {name}: {sv}, fired {f}, abandoned "
                  f"{r['abandoned']}, first error "
                  f"{recs[0]['error'] if recs else None!r}")
        elif name == "assemble raise":
            check(shed == [10] and "feeder.assemble" in recs[10]["error"],
                  f"cli serve {name}: shed {shed}")
        elif name == "assemble corrupt":
            check(sv["completed"] == n and f == {"feeder.assemble": 1},
                  f"cli serve {name}: {sv['completed']} completed, {f}")
        else:
            check(sv["completed"] == n and sv["request_retries"] > 0,
                  f"cli serve {name}: {sv['completed']} completed, "
                  f"{sv['request_retries']} retries")
        differ = [i for i in range(n) if lines[i] != want_lines[i]]
        allowed = {"step raise": set(range(n)), "step hang": set(shed),
                   "assemble raise": {10}, "assemble corrupt": {3},
                   "admit raise": set()}[name]
        check(set(differ) <= allowed, f"cli serve {name}: lines {differ} "
              f"differ from cli test --engine")
        print(f"[serve] cli serve --inject-faults {flags[1]}: exit 0, valid "
              f"serve_metrics.json; fired {f}; {r['line'].split('  p50')[0]};"
              f" retries {sv['request_retries']}; lines differing from cli "
              f"test --engine: {differ if len(differ) < 8 else len(differ)}"
              f"; abandoned dispatches {r['abandoned']}, joined "
              f"{r['woke_s']:.2f} s after the run returned", flush=True)
    print(f"[serve] the phase: K1 launched {k1} times over its serve and "
          f"engine runs (each 4 a step dispatch, prewarm included), "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, eng, warm_eng, batches
    return k1


def phase_preprocess(ctx) -> None:
    """The port's preprocessing: its astdiff library built on this machine
    (timed), the raw streams of ``N_COMMITS`` ``generate_corpus`` commits,
    and ``python -m fira_tpu_torch.cli preprocess`` on them as a
    subprocess (its spawned pool as wide as the machine). Hard check: the
    six graph streams and ``diffatt.json`` equal ``process_commits`` run
    in this process. Printed: commits/s of the CLI (its wall, interpreter
    start included) and of ``process_commits`` on one core, shards,
    degraded commits and ``os.cpu_count()``."""
    import subprocess

    from fira_tpu_torch.data.synthetic import generate_corpus
    from fira_tpu_torch.preprocess import astdiff_binding as ad
    from fira_tpu_torch.preprocess.pipeline import (GRAPH_STREAMS,
                                                    derive_diffatt,
                                                    process_commits)

    # built here from the checkout's sources, whatever a copy brought
    lib, cli_bin = ad.artifact_paths()
    for path in (lib, cli_bin):
        path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    ad.load()
    build_s = time.perf_counter() - t0
    print(f"[preprocess] astdiff library and CLI built in {build_s:.2f} s "
          f"({ad.compiler()} {' '.join(ad.CXXFLAGS + ad.LIB_FLAGS)}, the two "
          f"compiles side by side) -> {os.path.relpath(lib, ctx['root'])}, "
          f"{cli_bin.name}", flush=True)
    data_dir = os.path.join(ctx["work"], "preprocess")
    os.makedirs(data_dir)
    corpus = generate_corpus(N_COMMITS, seed=SEED)
    for name in ("difftoken", "diffmark", "msg", "variable"):
        with open(os.path.join(data_dir, f"{name}.json"), "w") as f:
            json.dump(corpus.streams[name], f)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "fira_tpu_torch.cli",
                           "preprocess", "--data-dir", data_dir],
                          cwd=ctx["root"], capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli preprocess exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    m = re.search(r"preprocess: (\d+) commits, (\d+) shards \((\d+) "
                  r"already done\), (\d+) degraded commits", proc.stdout)
    check(m is not None and int(m.group(1)) == N_COMMITS
          and int(m.group(3)) == 0, f"cli preprocess said {proc.stdout!r}")
    t0 = time.perf_counter()
    streams, errors = process_commits(corpus.streams["difftoken"],
                                      corpus.streams["diffmark"], 0,
                                      N_COMMITS)
    one_core = N_COMMITS / (time.perf_counter() - t0)
    for name in GRAPH_STREAMS:
        with open(os.path.join(data_dir, f"{name}.json")) as f:
            check(json.load(f) == streams[name],
                  f"cli preprocess {name}.json differs from process_commits")
    with open(os.path.join(data_dir, "diffatt.json")) as f:
        check(json.load(f) == derive_diffatt(corpus.streams["difftoken"]),
              "cli preprocess diffatt.json differs")
    check(int(m.group(4)) == len(errors), f"{m.group(4)} degraded commits "
          f"reported, process_commits degraded {len(errors)}")
    n_ast = sum(map(len, streams["ast"]))
    n_change = sum(map(len, streams["change"]))
    print(f"[preprocess] cli preprocess of {N_COMMITS} commits: "
          f"{m.group(2)} shards, {m.group(4)} degraded commits, wall "
          f"{wall:.3f} s incl. interpreter start = {N_COMMITS / wall:.1f} "
          f"commits/s on os.cpu_count() = {os.cpu_count()}; "
          f"process_commits on one core {one_core:.1f} commits/s; the six "
          f"graph streams and diffatt.json equal process_commits' "
          f"({n_ast} AST and {n_change} change nodes); {ctx['smi']}",
          flush=True)


def phase_message(torch, ctx, run32: dict, run16: dict) -> dict:
    """``cli message``, one diff in, one message out. 8 diffs reconstructed
    from the test split; ``cli message`` (its ``main``, in this process)
    on 1 of them against the f32 trained checkpoint (exit 0, one
    non-empty line); then, for f32 and then
    bf16, ``one_shot_message`` on all 8 with K1, counts from zero around
    that pass only (K1 once a beam step), then with the plain copy score
    and K1 in turns; f32 also once each in log space. Hard checks: the
    CLI's lines equal this process's f32 K1 messages; the f32 K1 messages
    equal the plain ones and their beam probabilities agree within
    ``PROB_RTOL`` relative (atol the float32 normal minimum, below which
    the prob-space beam has no relative precision), in prob space and in
    log space (where nothing underflows); bf16's that differ are counted.
    Printed: the ingest stage times, the beam's and the message's wall
    time; the cost of the test_batch_size - 1 pad rows (the same messages
    at ``test_batch_size=1``, one pass each, and one message at each size
    under the profiler: kernels, device busy, idle share). Returns K1's
    launches a dtype."""
    from fira_tpu_torch.data.schema import Corpus
    from fira_tpu_torch.ingest.difftext import reconstruct_request
    from fira_tpu_torch.ingest.service import one_shot_message
    from fira_tpu_torch.model.model import FiraModel

    cs, ds, cfg = ctx["cs"], ctx["ds"], ctx["cfg"]
    corpus = Corpus.load(ctx["data_dir"])
    idx = [int(i) for i in ds.split_indices["test"][:8]]
    texts = [reconstruct_request(corpus.record(i)) for i in idx]
    work = os.path.join(ctx["work"], "message")
    os.makedirs(work)
    paths = []
    for i, text in zip(idx, texts):
        paths.append(os.path.join(work, f"commit_{i}.diff"))
        with open(paths[-1], "w") as f:
            f.write(text)
    cli_lines = []
    for path in paths[:1]:
        t0 = time.perf_counter()
        rc, out, err, _k1 = run_cli(torch, ctx, [
            "message", path, "--config", "fira-full", "--data-dir",
            ctx["data_dir"], "--ckpt-dir", run32["ckpt_dir"]])
        wall = time.perf_counter() - t0
        lines = out.splitlines()
        check(rc == 0 and len(lines) == 1 and lines[0].strip(),
              f"cli message {os.path.basename(path)}: exit {rc}, stdout "
              f"{out[-500:]!r}, stderr {err[-2000:]}")
        cli_lines.append(lines[0])
        print(f"[message] cli message {os.path.basename(path)} --config "
              f"fira-full (f32 trained checkpoint, in this process): "
              f"exit 0, {wall:.2f} s wall incl. data and weight "
              f"load; {lines[0]!r}", flush=True)

    def one_pass(model, c, fn):
        model.copy_net.score_fn = fn
        out, stats = [], []
        for text in texts:
            st = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(one_shot_message(model, ds.word_vocab,
                                        ds.ast_change_vocab, c, text,
                                        stats=st))
            st["latency_s"] = time.perf_counter() - t0
            stats.append(st)
        return out, stats

    def med(stats, key):
        return float(np.median([st[key] for st in stats]))

    def probs_gap(got, want, what):
        """Largest relative gap of the beams' probabilities ``got`` from
        ``want`` (entries under float32's normal minimum left out), and
        whether every entry is within PROB_RTOL of its counterpart."""
        a = np.stack([st["probs"] for st in got]).astype(np.float64)
        b = np.stack([st["probs"] for st in want]).astype(np.float64)
        tiny = float(np.finfo(np.float32).tiny)
        normal = np.abs(b) >= tiny
        rel = float((np.abs(a - b)[normal] / np.abs(b)[normal]).max(
            initial=0.0))
        best = b.max(axis=1)
        print(f"[message] {what}: beam probabilities K1 vs plain, largest "
              f"relative gap {rel:.3e} (limit {PROB_RTOL:g}, atol {tiny:.3e}"
              f"); best beam {best.min():.6e} .. {best.max():.6e}, "
              f"{int((~normal).sum())} of {b.size} entries under the normal "
              f"minimum", flush=True)
        return rel, bool(np.all(np.abs(a - b) <= tiny + PROB_RTOL * np.abs(b)))

    k1, stages = {}, ("lex_s", "parse_s", "assemble_s", "beam_s", "cook_s",
                      "latency_s")
    for run in (run32, run16):
        dtype = run["gated"].compute_dtype
        c = cfg.replace(compute_dtype=dtype)
        model = FiraModel(c, device="cuda", dtype=dtype).eval()
        model.load_state_dict(run["state_dict"])
        cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
        msgs, stats = one_pass(model, c, cs.copy_scores)
        k1[dtype] = cs.copy_scores.launches
        want = len(texts) * (c.tar_len - 1)
        check(k1[dtype] == want and cs.copy_scores_backward.launches == 0,
              f"{dtype}: copy_score launched {k1[dtype]} times on the "
              f"message path, expected {want} (one a beam step)")
        check(all(m.strip() for m in msgs), f"{dtype}: an empty message")
        lat = {"kernel": [med(stats, "latency_s")], "plain": []}
        plain = None
        for label in ("plain", "plain", "kernel"):
            got, st = one_pass(model, c, cs.copy_scores if label == "kernel"
                               else cs.copy_scores_reference)
            lat[label].append(med(st, "latency_s"))
            if label == "plain":
                check(plain is None or got == plain,
                      f"{dtype}: two plain passes differ")
                plain, plain_stats = got, st
            else:
                check(got == msgs, f"{dtype}: two K1 passes differ")
        n_diff = sum(a != b for a, b in zip(msgs, plain))
        rel, close = probs_gap(stats, plain_stats, f"{dtype} prob space")
        if dtype == "float32":
            check(msgs[:1] == cli_lines, "cli message printed other messages "
                  "than one_shot_message in this process")
            check(n_diff == 0, f"f32: {n_diff} of {len(texts)} messages "
                  f"differ between K1 and the plain copy score")
            check(close, f"f32: beam probabilities K1 vs plain {rel:.3e} "
                  f"relative, beyond {PROB_RTOL:g}")
            # log space: no beam's score underflows, so the probabilities
            # compare at every entry
            cl = c.replace(beam_compat_prob_space=False)
            k_msgs, k_st = one_pass(model, cl, cs.copy_scores)
            p_msgs, p_st = one_pass(model, cl, cs.copy_scores_reference)
            model.copy_net.score_fn = cs.copy_scores
            n_log = sum(a != b for a, b in zip(k_msgs, p_msgs))
            check(n_log == 0, f"f32 log space: {n_log} of {len(texts)} "
                  f"messages differ between K1 and the plain copy score")
            rel, close = probs_gap(k_st, p_st, "float32 log space")
            check(close, f"f32 log space: beam log-probabilities K1 vs "
                  f"plain {rel:.3e} relative, beyond {PROB_RTOL:g}")
        print(f"[message {dtype}] one_shot_message on {len(texts)} diffs "
              f"(fira-full, a {c.test_batch_size}-row beam batch, "
              f"{c.tar_len - 1} steps): copy_score launches {k1[dtype]} "
              f"(expected {want}); medians "
              + ", ".join(f"{k[:-2]} {1e3 * med(stats, k):.3f} ms"
                          for k in stages)
              + f" (first message {1e3 * stats[0]['latency_s']:.1f} ms); "
              f"message latency in turns K1/plain/plain/K1: K1 "
              f"{' '.join(f'{1e3 * x:.1f}' for x in lat['kernel'])} ms, "
              f"plain {' '.join(f'{1e3 * x:.1f}' for x in lat['plain'])} ms; "
              f"{n_diff} of {len(texts)} messages differ from the plain "
              f"copy score; truncated "
              f"{sum(bool(s['truncated']) for s in stats)}, degraded "
              f"{sum(bool(s['degraded']) for s in stats)}, OOV "
              f"words {sum(s['oov_words'] for s in stats)}, OOV AST labels "
              f"{sum(s['oov_ast'] for s in stats)}; on {ctx['smi']}",
              flush=True)
        if dtype == "float32":
            # what the test_batch_size - 1 pad rows cost one message
            one = c.replace(test_batch_size=1)
            beam = {c.test_batch_size: [], 1: []}
            outs = {}
            for cc in (c, one):
                got, st = one_pass(model, cc, cs.copy_scores)
                beam[cc.test_batch_size].append(med(st, "beam_s"))
                outs[cc.test_batch_size] = got
            n_same = sum(a == b for a, b in zip(outs[1], msgs))
            print(f"[message float32] pad rows: beam wall median "
                  f"{c.test_batch_size} rows / 1: "
                  + " / ".join(f"{1e3 * x:.1f}" for x in (
                      beam[c.test_batch_size][0], beam[1][0]))
                  + f" ms; {n_same} of {len(texts)} messages at 1 row equal "
                  f"the {c.test_batch_size}-row ones", flush=True)
            prof = {}
            for cc in (c, one):
                n = cc.test_batch_size
                prof[n] = profile_one(
                    torch, f"one message ({n}-row beam batch, "
                    f"{c.tar_len - 1} steps, float32, ingest and cook "
                    f"included)", lambda: one_shot_message(
                        model, ds.word_vocab, ds.ast_change_vocab, cc,
                        texts[0]))
            print(f"[message float32] pad rows under the profiler, one "
                  f"message: " + "; ".join(
                      f"{n}-row beam {sum(k for _, k in r['by_name'].values())} "
                      f"kernels and copies, device busy {r['busy_ms']:.2f} of "
                      f"{r['wall_ms']:.2f} ms wall (idle "
                      f"{100 - 100 * r['busy_ms'] / r['wall_ms']:.1f}%)"
                      for n, r in prof.items())
                  + f"; on {ctx['smi']}", flush=True)
        del model
    return k1


DIFF_FAULTS = [
    ("parse raise, cache corrupt",
     ["--inject-faults",
      "ingest.parse:raise:0.04:1,ingest.cache:corrupt:0.3:5",
      "--robust-retries", "0"]),
    ("parse corrupt", ["--inject-faults", "ingest.parse:corrupt:0.04:7"]),
]


def stage_ms(records, key: str) -> str:
    """Median and p99 of one ingest stage over the requests that ran it
    (cache hits replay their first computation's stamps: left out)."""
    vals = [r["ingest"][key] for r in records
            if r["ingest"] and not r["ingest"].get("cached")]
    if not vals:
        return f"{key[:-2]} -"
    return (f"{key[:-2]} {1e3 * float(np.median(vals)):.3f}/"
            f"{1e3 * float(np.percentile(vals, 99)):.3f}")


def ingest_report(m: dict) -> str:
    """The printed ingest meters of one serve run."""
    ing = m["serve"]["ingest"]
    cache = ing.get("cache") or {}
    return (f"ingest stages p50/p99 ms: "
            + ", ".join(stage_ms(m["request_records"], k)
                        for k in ("lex_s", "parse_s", "assemble_s"))
            + f"; stall_s {ing['stall_s']}, stall_frac {ing['stall_frac']}, "
            f"workers {ing['workers']}, pipeline_depth "
            f"{ing['pipeline_depth']}; cache hits {ing['cache_hits']} "
            f"(result cache {cache.get('hits', '-')} hits, "
            f"{cache.get('coalesced', '-')} coalesced, "
            f"{cache.get('integrity_drops', '-')} integrity drops), memo "
            f"hits/misses {ing['memo_hits']}/{ing['memo_misses']}")


def phase_serve_diffs(torch, ctx, run32: dict) -> int:
    """``cli serve --input diffs``: the ``[serve]`` phase's loop and engine
    (20 slots, R = 4, f32 trained checkpoint) fed raw diffs through the
    ingest path. An extracted corpus of ``N_COMMITS`` commits (graphs from
    the astdiff extraction, so a reconstructed diff ingests to its corpus
    row; vocabularies padded to the paper's sizes), its test diffs as a
    ``#! request`` trace, a replayed arrival trace, the virtual clock.
    Hard checks: (1) ``--input diffs`` with ``--ingest-cache off|on`` x
    ``--ingest-exec thread|process`` writes the bytes of ``--input
    graphs``, and the pool's processes map neither libtorch nor a CUDA
    library; (2) the diffs twice (second pass reversed), cache on: every
    line its first pass's, ``ingest.cache_hits`` at least the second-pass
    requests not coalesced in flight; (3) three malformed diffs are shed
    at exactly their positions with their errors and empty lines, every
    other line unchanged; (4) ``ingest.parse`` raise with
    ``ingest.cache`` corrupt, and ``ingest.parse`` corrupt, on the doubled
    trace: exit 0 with valid metrics, every line the clean run's, a
    recorded shed, or (corrupt) at a position whose payload the site's
    keyed draw scrambled; (5) K1 = 4 x (counted step dispatches +
    prewarm) a serve. Printed beside the card: the ingest stage times,
    stall, workers and depth, cache and memo meters; then wall-clock
    serving at 1.5x the engine's drain rate on this corpus over the split
    ``WALL_REPEATS`` times, ingest and prefix caches off, thread then
    process. Returns K1's launches."""
    from fira_tpu_torch.config import fira_full
    from fira_tpu_torch.data.dataset import FiraDataset
    from fira_tpu_torch.data.synthetic import write_extracted_corpus_dir
    from fira_tpu_torch.decode import engine as engine_lib
    from fira_tpu_torch.ingest.difftext import (reconstruct_request,
                                                write_diff_trace)
    from fira_tpu_torch.ingest.service import build_fast_path, serve_diffs
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.robust.faults import FaultInjector, parse_fault_specs
    from fira_tpu_torch.serve import poisson_times, write_trace

    cs = ctx["cs"]
    t_phase = time.perf_counter()
    work = os.path.join(ctx["work"], "serve_diffs")
    data_dir = os.path.join(work, "DataSet")
    t0 = time.perf_counter()
    corpus = write_extracted_corpus_dir(data_dir, N_COMMITS, seed=SEED)
    pad_vocabs(data_dir)
    ds = FiraDataset(data_dir, fira_full())
    cfg = ds.cfg
    check(cfg.vocab_size == WORD_VOCAB and cfg.ast_change_vocab_size
          == AST_VOCAB, f"extracted corpus widths {cfg.vocab_size}/"
          f"{cfg.ast_change_vocab_size}")
    texts = [reconstruct_request(corpus.record(int(i)))
             for i in ds.split_indices["test"]]
    n = len(texts)
    diffs = os.path.join(work, "diffs.trace")
    write_diff_trace(diffs, texts)
    trace = os.path.join(work, "trace.txt")
    times = poisson_times(n, rate=0.5, seed=3)
    write_trace(trace, times)
    twice = os.path.join(work, "diffs_twice.trace")
    write_diff_trace(twice, texts + texts[::-1])
    trace2 = os.path.join(work, "trace_twice.txt")
    write_trace(trace2, np.concatenate([times, times[-1] + 1.0 + times]))
    print(f"[serve-diffs] extracted corpus of {N_COMMITS} commits and its "
          f"{n} test diffs written in {time.perf_counter() - t0:.2f} s",
          flush=True)

    def run(name, flags, tr=trace, watch=False):
        fn = lambda: serve_cli(torch, ctx, run32, name, flags,  # noqa: E731
                               data_dir=data_dir, trace=tr,
                               sub="serve_diffs")
        if not watch:
            return fn()
        r, kids = watch_children(fn)
        check(kids and not any(t or c for t, c in kids.values()),
              f"cli serve {name}: the ingest pool's processes {kids} "
              f"(pid: libtorch, CUDA library mapped)")
        r["kids"] = kids
        return r

    k1 = 0
    graphs = run("graphs", [])
    k1 += graphs["k1"]
    ref = graphs["out"]
    ref_lines = ref.decode().split("\n")
    nonempty = sum(bool(x) for x in ref_lines[:n])
    print(f"[serve-diffs] cli serve --input graphs on the extracted corpus: "
          f"{graphs['line']}; {nonempty} of {n} lines not empty; "
          f"copy_score launches {graphs['k1']}", flush=True)
    for cache in ("off", "on"):
        for mode in ("thread", "process"):
            name = f"diffs cache {cache} {mode}"
            r = run(name, ["--input", "diffs", "--diff-trace", diffs,
                           "--ingest-cache", cache, "--ingest-exec", mode],
                    watch=mode == "process")
            k1 += r["k1"]
            m = r["metrics"]
            check(r["out"] == ref,
                  f"cli serve {name}: {len(n_lines_differ(r['out'], ref))} "
                  f"of {n} lines differ from --input graphs")
            check(m["serve"]["ingest"]["requests_ingested"] == n
                  and all(x["ingest"] for x in m["request_records"]),
                  f"cli serve {name}: ingest stamps missing")
            kids = (f"; pool processes {sorted(r['kids'])}, none with "
                    f"libtorch or a CUDA library mapped"
                    if "kids" in r else "")
            print(f"[serve-diffs] cli serve --input diffs, ingest cache "
                  f"{cache}, {mode}: output_fira byte-identical to --input "
                  f"graphs; {r['line'].split('  p50')[0]}; "
                  f"{ingest_report(m)}; copy_score launches {r['k1']}"
                  f"{kids}; on {ctx['smi']}", flush=True)

    # --- the diffs twice, the second pass reversed, cache on
    r = run("twice", ["--input", "diffs", "--diff-trace", twice], tr=trace2)
    k1 += r["k1"]
    twice_lines = r["out"].decode().split("\n")
    check(twice_lines[:n] == ref_lines[:n]
          and twice_lines[n:2 * n] == ref_lines[:n][::-1],
          "diffs twice: a line differs from its first pass's")
    ing = r["metrics"]["serve"]["ingest"]
    coalesced = ing["cache"]["coalesced"]
    check(ing["cache_hits"] >= n - coalesced,
          f"diffs twice: {ing['cache_hits']} cache hits, {n} repeats, "
          f"{coalesced} coalesced in flight")
    sv = r["metrics"]["serve"]
    print(f"[serve-diffs] the {n} diffs twice (second pass reversed), cache "
          f"on: every line its first pass's; ingest cache hits "
          f"{ing['cache_hits']} of {n} repeats ({coalesced} coalesced in "
          f"flight), prefix-cache coalesced {sv['dedup_coalesced']}, "
          f"prefills {r['metrics']['engine']['prefills']}; "
          f"{ingest_report(r['metrics'])}", flush=True)

    # --- malformed diffs
    bad = {7: "garbage that is not a diff\n",
           n // 2: "diff --git a/A.java b/A.java\n+int x = 1 ;\n",
           n - 3: "@@ -1,1 +1,1 @@ class A\n?int x ;\n"}
    broken = [bad.get(i, t) for i, t in enumerate(texts)]
    bpath = os.path.join(work, "diffs_malformed.trace")
    write_diff_trace(bpath, broken)
    r = run("malformed", ["--input", "diffs", "--diff-trace", bpath])
    k1 += r["k1"]
    recs = r["metrics"]["request_records"]
    lines = r["out"].decode().split("\n")
    shed = [x["position"] for x in recs if x["status"] == "shed_error"]
    check(shed == sorted(bad)
          and all("DiffParseError" in recs[p]["error"] and lines[p] == ""
                  for p in bad)
          and all(lines[i] == ref_lines[i] for i in range(n)
                  if i not in bad),
          f"malformed diffs: shed {shed}, expected {sorted(bad)}")
    print(f"[serve-diffs] {len(bad)} malformed diffs at {sorted(bad)}: "
          f"exactly those shed with their errors and empty lines, every "
          f"other line unchanged; e.g. {recs[sorted(bad)[0]]['error']!r}",
          flush=True)

    # --- the ingest fault sites, on the doubled trace
    for name, flags in DIFF_FAULTS:
        r = run(name, ["--input", "diffs", "--diff-trace", twice, *flags],
                tr=trace2)
        k1 += r["k1"]
        recs = r["metrics"]["request_records"]
        lines = r["out"].decode().split("\n")
        fired = r["metrics"].get("faults", {})
        shed = {x["position"] for x in recs if x["status"] == "shed_error"}
        scrambled = set()
        for spec in parse_fault_specs(flags[1]):
            if spec.site == "ingest.parse" and spec.kind == "corrupt":
                scrambled = {i for i in range(2 * n)
                             if FaultInjector._draw(spec, i)}
        moved = {i for i in range(2 * n) if lines[i] != twice_lines[i]}
        check(len(lines) == 2 * n + 1 and len(recs) == 2 * n,
              f"cli serve {name}: {len(lines) - 1} lines")
        check(moved <= shed | scrambled
              and all(lines[p] == "" and recs[p]["error"] for p in shed),
              f"cli serve {name}: lines {sorted(moved - shed - scrambled)} "
              f"moved without a shed or a scramble")
        cache = r["metrics"]["serve"]["ingest"]["cache"]
        if "ingest.cache" in flags[1]:
            check(cache["integrity_drops"] == fired.get("ingest.cache", 0)
                  > 0 and fired.get("ingest.parse", 0) > 0,
                  f"cli serve {name}: fired {fired}, cache {cache}")
        else:
            check(not shed and len(scrambled) == fired.get("ingest.parse"),
                  f"cli serve {name}: shed {sorted(shed)}, fired {fired}, "
                  f"{len(scrambled)} scrambled by the draw")
        print(f"[serve-diffs] cli serve --input diffs --inject-faults "
              f"{flags[1]} on the doubled trace: exit 0, valid "
              f"serve_metrics.json; fired {fired}; shed {sorted(shed)}; "
              f"scrambled payloads {sorted(scrambled)}; lines moved from the "
              f"clean run {sorted(moved)}; integrity drops "
              f"{cache['integrity_drops']}", flush=True)

    # --- wall clock at 1.5x the drain rate, ingest and prefix caches off,
    # the parse stage on threads and on the pool in turns
    c = cfg.replace(decode_engine=True, compute_dtype="float32",
                    prefix_cache=False, ingest_cache=False)
    model = FiraModel(c, device="cuda", dtype="float32").eval()
    model.load_state_dict(run32["state_dict"])
    from fira_tpu_torch.cli import _load_var_maps

    dctx = dict(ctx, ds=ds, var_maps=_load_var_maps(data_dir))
    drain = engine_decode(torch, dctx, model, c, staged_batches(torch, dctx,
                                                                c))
    k1 += drain["k1"]
    eng = engine_lib.SlotEngine(model, c)
    mix = np.tile(np.arange(n), WALL_REPEATS)
    wall_reqs = [texts[j] for j in mix]
    rate = 1.5 * drain["rate"]
    arrivals_w = poisson_times(len(mix), rate, seed=5)
    fast = {}
    try:
        for mode in ("thread", "process"):
            cm = c.replace(ingest_exec=mode)
            fast[mode] = build_fast_path(
                cm, context=(ds.word_vocab, ds.ast_change_vocab, cm, None))
            # warm the engine and the pool outside the timed runs
            serve_diffs(model, ds.word_vocab, ds.ast_change_vocab, cm,
                        requests=texts[:c.test_batch_size],
                        arrival_times=np.zeros(c.test_batch_size),
                        out_dir=os.path.join(work, f"warm_{mode}"),
                        engine=eng, fast_path=fast[mode])
        for i, mode in enumerate(("thread", "process")):
            cm = c.replace(ingest_exec=mode)
            eng.stats = engine_lib.EngineStats(slots=eng.slots)
            cs.copy_scores.launches = 0

            def wall_run():
                return serve_diffs(
                    model, ds.word_vocab, ds.ast_change_vocab, cm,
                    requests=wall_reqs, arrival_times=arrivals_w,
                    out_dir=os.path.join(work, f"wall_{i}_{mode}"),
                    clock="wall", engine=eng, fast_path=fast[mode])
            if mode == "process":
                m, kids = watch_children(wall_run)
                check(kids and not any(t or g for t, g in kids.values()),
                      f"wall {mode}: pool processes {kids}")
            else:
                m = wall_run()
            torch.cuda.synchronize()
            launched = cs.copy_scores.launches
            k1 += launched
            sv, e = m["serve"], m["engine"]
            check(launched == c.engine_harvest_every * e["step_dispatches"],
                  f"wall {mode}: copy_score launched {launched} times for "
                  f"{e['step_dispatches']} step dispatches")
            check(sv["completed"] == sv["offered"] == len(mix),
                  f"wall {mode}: {sv['completed']} of {len(mix)} completed")
            check(serve_bytes(m).decode().split("\n")
                  == [ref_lines[j] for j in mix] + [""],
                  f"wall {mode}: a line differs from its diff's graphs line")
            print(f"[serve-diffs] wall clock at 1.5x the drain rate "
                  f"({drain['rate']:.2f} commits/s on this corpus), ingest "
                  f"and prefix caches off, --ingest-exec {mode} (turn "
                  f"{i + 1} of 2): offered {rate:.2f} req/s ({sv['offered']} "
                  f"requests, measured {sv['offered_rate_rps']}), completed "
                  f"{sv['completed']} at {sv['throughput_rps']} req/s; p50/"
                  f"p99 TTFT {sv['p50_ttft_s']}/{sv['p99_ttft_s']} s, p50/"
                  f"p99 e2e {sv['p50_e2e_s']}/{sv['p99_e2e_s']} s; "
                  f"{ingest_report(m)}; each line its diff's graphs line; "
                  f"on {ctx['smi']}", flush=True)
    finally:
        for f in fast.values():
            if f[2] is not None:
                f[2].close()
    print(f"[serve-diffs] the phase: K1 launched {k1} times over its serve "
          f"runs and the drain (each 4 a step dispatch, prewarm included), "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, eng
    return k1


# seeded faults for the [fleet] phase's 61 requests on 2 replicas
# (robust/faults.py draws; a draw's key is its site's check count):
# fleet.replica seed 2715 at rate 0.002 fires at the 65th check only (of
# the first 3,000; one check a live replica a round: mid-run, requests in
# flight); engine.step seed 1249 at 0.002 fires at the 75th step dispatch
# only and sleeps fault_hang_s (2 s) past the 1 s watchdog; fleet.replica
# seed 24 at 0.05 fires at checks 31, 59, 67, 78, 86, 87, ...: more deaths
# than two lineages of one respawn each survive
FLEET = ["--engine-slots", "20", "--engine-replicas", "2"]
FLEET_FAULT = ["--inject-faults", "fleet.replica:raise:0.002:2715"]
FLEET_FAULTS = [
    ("replica raise", FLEET_FAULT),
    ("step hang", ["--inject-faults", "engine.step:hang:0.002:1249",
                   "--dispatch-watchdog-s", "1"]),
    ("respawn", FLEET_FAULT + ["--max-respawns", "1"]),
    ("spare", FLEET_FAULT + ["--max-respawns", "1", "--engine-spares", "1"]),
    ("storm", ["--inject-faults", "fleet.replica:raise:0.05:24",
               "--max-respawns", "1"]),
]
KILL_RATE = 10.0   # req/s of the killed wall-clock serve: ~6 s of arrivals
KILL_AT = 20       # requests done when the serve is killed


def run_cli(torch, ctx, args: list) -> tuple:
    """``cli.main(args)`` in this process, K1 counted from zero around it;
    (exit code, standard output, standard error, K1 launches)."""
    import contextlib
    import io

    from fira_tpu_torch import cli

    cs = ctx["cs"]
    out, err = io.StringIO(), io.StringIO()
    cs.copy_scores.launches = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(args)
    torch.cuda.synchronize()
    return rc, out.getvalue(), err.getvalue(), cs.copy_scores.launches


def journal_generations(path: str) -> list:
    """The journal's records split at each ``begin`` record."""
    gens = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "begin":
                gens.append([])
            gens[-1].append(rec)
    return gens


def phase_fleet(torch, ctx, run32: dict, engine_bytes: bytes) -> int:
    """The replicated engine fleet and recovery on the card: fira-full, the
    f32 trained checkpoint, ``--engine-slots 20`` as the fleet total, R =
    4, the [serve] phase's replayed trace under the virtual clock unless
    stated. Hard checks: (1) ``cli test --engine --engine-replicas 2`` and
    ``4`` (10 and 5 slots a replica) write ``cli test --engine``'s bytes
    (at 4, two replicas stage the split's 4 chunks and two stay idle);
    (2) ``cli serve --engine-replicas 2`` writes
    them with the prefix cache off and on, every replica serving; (3) a
    ``fleet.replica`` raise retires one replica mid-run (requests
    requeued) and a step hang past a 1 s watchdog retires one (its
    abandoned dispatch launching nothing when it wakes): the survivor
    writes the clean bytes; (4) with ``--max-respawns 1`` the retired
    replica is respawned, with ``--engine-spares 1`` the spare attaches, both writing
    the clean bytes; a storm that kills both lineages past their budget
    exits 0, every line the clean line or a recorded shed; (5) a
    wall-clock ``cli serve`` subprocess is killed with SIGKILL once
    ``KILL_AT`` requests are done (strictly mid-run), and ``cli serve
    --resume`` writes the clean bytes with ``resumed`` the recovered
    lines, no position served twice, no crash pair left; a resume at
    another rate exits 2 naming the digest mismatch; (6) in every run in
    this process K1 launches 4 a step dispatch of every engine of the
    roster plus 4 a prewarm of every engine built. Printed beside the
    card: a replica's replacement, a fresh build with its prewarm against
    a spare attach (median of 3); wall-clock serving at 1.5x the drain
    rate over the split ``WALL_REPEATS`` times, cache off, in turns: one
    engine of 20 slots with the journal on, off, then two replicas of 10
    with it off (the journal on/off, and one engine against two replicas
    with the journal off). Returns
    K1's launches."""
    import gc
    import signal
    import statistics
    import subprocess

    from fira_tpu_torch.decode import engine as engine_lib
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.parallel.fleet import EngineFleet
    from fira_tpu_torch.robust.recovery import read_journal, recover_output
    from fira_tpu_torch.serve import poisson_times, serve_split
    from fira_tpu_torch.serve.server import prepare_templates

    cs, ds, cfg = ctx["cs"], ctx["ds"], ctx["cfg"]
    t_phase = time.perf_counter()
    n = len(ds.splits["test"])
    want_lines = engine_bytes.decode().split("\n")
    work = os.path.join(ctx["work"], "fleet")
    os.makedirs(work)
    k1 = 0

    # --- (1) the drain fleet
    for reps in (2, 4):
        r = engine_cli(torch, ctx, run32, f"fleet{reps}",
                       ["--engine", "--engine-slots", "20",
                        "--engine-replicas", str(reps)])
        k1 += r["k1"]
        s = r["summary"]
        check(r["out"] == engine_bytes,
              f"cli test --engine-replicas {reps}: "
              f"{len(n_lines_differ(r['out'], engine_bytes))} of {n} lines "
              f"differ from the one engine's")
        # the test split is 4 chunks of up to 20 rows and a replica stages
        # up to 2 (engine_prefill_depth): at 4 replicas 2 of them take all
        check(s["replicas"] == reps and s["slots"] == 20
              and sum(s["per_replica_commits"]) == n
              and all(c > 0 for c in s["per_replica_commits"][:2])
              and s["warm_step_dispatches"] == reps,
              f"cli test --engine-replicas {reps}: {s}")
        print(f"[fleet] cli test --engine --engine-slots 20 "
              f"--engine-replicas {reps} ({20 // reps} slots a replica): "
              f"output_fira byte-identical to the one engine's; commits a "
              f"replica {s['per_replica_commits']}, step dispatches "
              f"{s['step_dispatches']}, occupancy {s['slot_occupancy']}; "
              f"K1 launches {r['k1']} = 4 x ({s['step_dispatches']} + "
              f"{s['warm_step_dispatches']} prewarm); {r['wall']:.2f} s",
              flush=True)

    # --- (2) the serve fleet
    for name, flags in (("cache off", ["--prefix-cache", "off"]),
                        ("cache on", [])):
        r = serve_cli(torch, ctx, run32, f"fleet {name}", FLEET + flags,
                      sub="fleet")
        k1 += r["k1"]
        sv, e = r["metrics"]["serve"], r["metrics"]["engine"]
        check(r["out"] == engine_bytes,
              f"cli serve --engine-replicas 2, {name}: "
              f"{len(n_lines_differ(r['out'], engine_bytes))} of {n} lines "
              f"differ from cli test --engine")
        check(sorted(sv["heartbeats"]) == ["r0", "r1"]
              and all(h["alive"] and h["rounds"] == sv["rounds"]
                      for h in sv["heartbeats"].values())
              and all(c > 0 for c in e["per_replica_commits"]),
              f"cli serve --engine-replicas 2, {name}: heartbeats "
              f"{sv['heartbeats']}, commits {e['per_replica_commits']}")
        print(f"[fleet] cli serve --engine-replicas 2, {name}: output_fira "
              f"byte-identical to cli test --engine; {r['line']}; commits a "
              f"replica {e['per_replica_commits']}, occupancy a replica "
              f"{e['per_replica_occupancy']}, admits {sv['admits']} (most "
              f"in a round {sv['max_admits_per_round']}); K1 launches "
              f"{r['k1']}", flush=True)

    # --- (3, 4) retirement and respawn, after one collection of the
    # objects alive now and a freeze (the step hang runs under a 1 s
    # watchdog, which a full collection inside a dispatch could outlast)
    t0 = time.perf_counter()
    gc.collect()
    gc_s = time.perf_counter() - t0
    gc.freeze()
    print(f"[fleet] before the fault runs: a full collection took "
          f"{gc_s:.3f} s, then frozen", flush=True)
    for name, flags in FLEET_FAULTS:
        r = serve_cli(torch, ctx, run32, f"fleet {name}", FLEET + flags,
                      sub="fleet")
        k1 += r["k1"]
        sv, e = r["metrics"]["serve"], r["metrics"]["engine"]
        f = r["metrics"].get("faults", {})
        recs = r["metrics"]["request_records"]
        lines = r["out"].decode().split("\n")
        check(len(lines) == n + 1 and len(recs) == n,
              f"cli serve {name}: {len(lines) - 1} lines, {len(recs)} "
              f"records")
        shed = {x["position"] for x in recs if x["status"] != "done"}
        alive = [a["alive"] for a in sv["replicas_alive_over_time"]]
        if name == "storm":
            check(sv["replica_retirements"] == 4 and sv["respawns"] == 2
                  and sv["shed_error"] > 0
                  and sv["completed"] + sv["shed_error"] == n
                  and all(lines[p] == ("" if p in shed else want_lines[p])
                          for p in range(n)),
                  f"cli serve {name}: {sv['replica_retirements']} "
                  f"retirements, {sv['respawns']} respawns, "
                  f"{sv['completed']} done, {sv['shed_error']} shed")
        else:
            check(r["out"] == engine_bytes and sv["completed"] == n,
                  f"cli serve {name}: {sv['completed']} done, "
                  f"{len(n_lines_differ(r['out'], engine_bytes))} lines "
                  f"differ from cli test --engine")
            check(sv["replica_retirements"] == 1
                  and sv["requeued_requests"] > 0,
                  f"cli serve {name}: {sv['replica_retirements']} "
                  f"retirements, {sv['requeued_requests']} requeued")
        if name == "replica raise":
            check(f == {"fleet.replica": 1} and sv["respawns"] == 0
                  and alive == [2, 1], f"cli serve {name}: {f}, {alive}")
        elif name == "step hang":
            # a hang raises nothing: the retirement is the watchdog's, and
            # K1's count (serve_cli) shows the woken dispatch launched none
            check(f == {"engine.step": 1} and alive == [2, 1],
                  f"cli serve {name}: fired {f}, alive {alive}")
        elif name == "respawn":
            check(f == {"fleet.replica": 1} and sv["respawns"] == 1
                  and sv["spare_attaches"] == 0 and alive == [2, 1, 2]
                  and sv["respawned_replicas"]
                  == [sv["retired_replicas"][0] + "~1"],
                  f"cli serve {name}: {sv['respawned_replicas']}, {alive}")
        elif name == "spare":
            check(sv["respawns"] == 1 and sv["spare_attaches"] == 1
                  and sv["respawned_replicas"] == ["sp0"]
                  and alive == [2, 1, 2],
                  f"cli serve {name}: {sv['respawned_replicas']}, {alive}")
        print(f"[fleet] cli serve --engine-replicas 2 {' '.join(flags)}: "
              f"exit 0; fired {f}; retired {sv['retired_replicas']}, "
              f"requeued {sv['requeued_requests']}, respawned "
              f"{sv['respawned_replicas']} (spares {sv['spare_attaches']}), "
              f"alive over time {alive}, paused rounds "
              f"{sv['admission_paused_rounds']}; {sv['completed']} done, "
              f"{sv['shed_error']} shed, every line "
              + ("the clean line or empty where shed" if shed
                 else "the clean line")
              + f"; K1 launches {r['k1']} = 4 x ({e['step_dispatches']} "
              f"dispatches of {e['replicas']} engines + "
              f"{e['warm_step_dispatches']} prewarms); abandoned "
              f"dispatches {r['abandoned']}", flush=True)

    # --- (5) kill and resume: a wall-clock serve in a child process,
    # killed with SIGKILL once KILL_AT requests are done
    kdir = os.path.join(work, "kill")
    out_path = os.path.join(kdir, "output_fira")
    jp = out_path + ".journal"
    kargs = ["serve", "--config", "fira-full", "--data-dir",
             ctx["data_dir"], "--out-dir", kdir, "--ckpt-dir",
             run32["ckpt_dir"], "--dtype", "float32", *FLEET]
    rate_args = ["--serve-rate", str(KILL_RATE)]
    os.makedirs(kdir)
    t0 = time.perf_counter()
    done_at_kill, t_kill = -1, None
    with open(os.path.join(kdir, "child.log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "fira_tpu_torch.cli", *kargs,
             *rate_args], cwd=ctx["root"], stdout=log,
            stderr=subprocess.STDOUT,
            env=dict(os.environ, PYTHONPATH=ctx["root"]))
        try:
            while proc.poll() is None and time.perf_counter() - t0 < 300:
                done = (len(read_journal(jp)[1]) if os.path.exists(jp)
                        else 0)
                if done >= KILL_AT:
                    proc.send_signal(signal.SIGKILL)
                    done_at_kill, t_kill = done, time.perf_counter() - t0
                    break
                time.sleep(0.05)
        finally:
            if proc.poll() is None and done_at_kill < 0:
                proc.kill()
            proc.wait()
    with open(os.path.join(kdir, "child.log")) as f:
        child_tail = f.read()[-2000:]
    check(proc.returncode == -signal.SIGKILL and 0 < done_at_kill < n,
          f"kill and resume: the child exited {proc.returncode} with "
          f"{done_at_kill} of {n} done at the kill (must be killed "
          f"mid-run): {child_tail}")
    recovered = recover_output(out_path, n)
    check(len(recovered) >= done_at_kill
          and os.path.exists(out_path + ".partial"),
          f"kill and resume: {len(recovered)} lines recovered, "
          f"{done_at_kill} done in the journal")
    rc, printed, err, launched = run_cli(torch, ctx,
                                         kargs + rate_args + ["--resume"])
    k1 += launched
    check(rc == 0, f"cli serve --resume exited {rc}: {err[-2000:]}")
    with open(os.path.join(kdir, "serve_metrics.json")) as f:
        metrics = json.load(f)
    sv, e = metrics["serve"], metrics["engine"]
    with open(out_path, "rb") as f:
        resumed_out = f.read()
    gens = journal_generations(jp)
    served = {x["pos"] for x in gens[-1] if x["kind"] in ("done", "shed")}
    check(resumed_out == engine_bytes and sv["resumed"] == len(recovered)
          and sv["completed"] == sv["offered"] == n - len(recovered)
          and served == set(range(n)) - set(recovered)
          and len(gens) == 2
          and not os.path.exists(out_path + ".partial")
          and not os.path.exists(out_path + ".partial.tail"),
          f"cli serve --resume: resumed {sv['resumed']} of "
          f"{len(recovered)} recovered, completed {sv['completed']}, "
          f"{len(n_lines_differ(resumed_out, engine_bytes))} lines differ "
          f"from cli test --engine")
    check(launched == 4 * (e["step_dispatches"] + e["warm_step_dispatches"]),
          f"cli serve --resume: K1 launched {launched} times")
    rc, _, err, mism = run_cli(torch, ctx, kargs + [
        "--serve-rate", str(KILL_RATE + 1), "--resume"])
    k1 += mism
    check(rc == 2 and "different arrival schedule (digest mismatch" in err
          and mism == 0,
          f"cli serve --resume at another rate exited {rc}: {err[-500:]}")
    print(f"[fleet] kill and resume: a wall-clock cli serve "
          f"--engine-replicas 2 at {KILL_RATE} req/s in a child process, "
          f"SIGKILL at {done_at_kill} of {n} done ({t_kill:.1f} s after "
          f"its start); {len(recovered)} lines recovered from the crash "
          f"pair; cli serve --resume exit 0, {sv['resumed']} resumed, "
          f"{sv['completed']} served again, output_fira byte-identical to "
          f"cli test --engine, no position served twice, no crash pair "
          f"left, K1 launches {launched}; a resume at "
          f"{KILL_RATE + 1} req/s exit 2 (digest mismatch)", flush=True)

    # --- replacing a replica: a fresh build with its prewarm, against a
    # spare attach
    c1 = cfg.replace(decode_engine=True, compute_dtype="float32")
    c2 = c1.replace(engine_slots=20, engine_replicas=2)
    model = FiraModel(c1, device="cuda", dtype="float32").eval()
    model.load_state_dict(run32["state_dict"])
    cs.copy_scores.launches = 0
    fleet = EngineFleet(model, c2, replicas=2)
    prepare_templates(fleet, ds.splits["test"], c2, None)
    dev = next(model.parameters()).device
    fresh, attach = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _eng, sp = fleet.replace_slot("r0", dev)
        torch.cuda.synchronize()
        fresh.append(time.perf_counter() - t0)
        fleet.build_spares(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _eng2, sp2 = fleet.replace_slot("r1", dev)
        torch.cuda.synchronize()
        attach.append(time.perf_counter() - t0)
        check(not sp and sp2, "replacement: a build or an attach mixed up")
    built = fleet.stats.summary()["warm_step_dispatches"]
    check(built == 8 and cs.copy_scores.launches == 4 * built,
          f"replacement: K1 launched {cs.copy_scores.launches} times for "
          f"{built} engines built")
    k1 += cs.copy_scores.launches
    print(f"[fleet] replacing a replica (10 slots, fira-full): a fresh "
          f"build with its prewarm {statistics.median(fresh):.4f} s "
          f"(median of 3: {', '.join(f'{x:.4f}' for x in fresh)}), a spare "
          f"attach {statistics.median(attach):.6f} s "
          f"({', '.join(f'{x:.6f}' for x in attach)}); on {ctx['kind']}, "
          f"{ctx['smi']}", flush=True)
    del fleet

    # --- the journal's cost and a second replica's, wall clock at 1.5x
    # the drain rate, cache off, in turns
    drain = engine_decode(torch, ctx, model, c1, staged_batches(torch, ctx,
                                                                  c1))
    k1 += drain["k1"]
    wall_mix = np.tile(np.arange(n), WALL_REPEATS)
    rate = 1.5 * drain["rate"]
    times = poisson_times(len(wall_mix), rate, seed=5)
    eng1 = engine_lib.SlotEngine(model, c1)
    eng2 = EngineFleet(model, c2, replicas=2)

    def wall(name, cc, eng, journal, warm=False):
        for x in getattr(eng, "engines", [eng]):
            x.stats = engine_lib.EngineStats(slots=x.slots)
        d = os.path.join(work, re.sub(r"\W+", "_", name))
        jpath = os.path.join(d, "output_fira.journal") if journal else None
        cs.copy_scores.launches = 0
        m = serve_split(model, ds, cc,
                        arrival_times=(np.zeros(cc.test_batch_size) if warm
                                       else times),
                        out_dir=d, clock="virtual" if warm else "wall",
                        var_maps=ctx["var_maps"],
                        request_mix=None if warm else wall_mix, engine=eng,
                        journal_path=jpath)
        torch.cuda.synchronize()
        launched = cs.copy_scores.launches
        sv, e = m["serve"], m["engine"]
        check(launched == 4 * e["step_dispatches"],
              f"wall {name}: K1 launched {launched} times, "
              f"{e['step_dispatches']} step dispatches")
        if warm:
            return launched
        check(sv["completed"] == sv["offered"] == len(wall_mix)
              and serve_bytes(m).decode().split("\n")
              == [want_lines[j] for j in wall_mix] + [""],
              f"wall {name}: {sv['completed']} of {len(wall_mix)} done, or "
              f"a line differs from its sample's engine line")
        jrec = jbytes = 0
        if journal:
            jbytes = os.path.getsize(jpath)
            with open(jpath) as f:
                jrec = sum(1 for _ in f)
        print(f"[fleet] wall clock, {name}: offered {rate:.2f} req/s (1.5x "
              f"the drain's {drain['rate']:.2f} commits/s, {sv['offered']} "
              f"requests), completed {sv['throughput_rps']} req/s, p50/p99 "
              f"TTFT {sv['p50_ttft_s']}/{sv['p99_ttft_s']} s, p50/p99 e2e "
              f"{sv['p50_e2e_s']}/{sv['p99_e2e_s']} s, {sv['rounds']} "
              f"rounds; journal {jrec} records, {jbytes} bytes; K1 "
              f"{launched}; on {ctx['kind']}, {ctx['smi']}", flush=True)
        return launched

    k1 += wall("warm_one", c1, eng1, False, warm=True)
    k1 += wall("warm_two", c2, eng2, False, warm=True)
    # one sequence of turns serves both comparisons: the journal on, off
    # (one engine), then one engine and two replicas (journal off)
    for i, (two, journal) in enumerate(((False, True), (False, False),
                                        (True, False))):
        k1 += wall(f"turn {i + 1}, "
                   f"{'two replicas of 10' if two else 'one engine of 20'} "
                   f"slots, journal {'on' if journal else 'off'}",
                   c2 if two else c1, eng2 if two else eng1, journal)
    print(f"[fleet] the phase: K1 launched {k1} times over its runs in this "
          f"process (the killed child's are not counted), "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, eng1, eng2
    torch.cuda.empty_cache()
    return k1


SPEC_RUNS = [("copy k4", ["--spec-decode", "copy", "--spec-k", "4"], 4),
             ("draft k4", ["--spec-decode", "draft", "--spec-k", "4"], 4),
             ("copy k2", ["--spec-decode", "copy", "--spec-k", "2"], 2)]
TIER_FLAGS = [("bf16kv", ["--kv-dtype", "bf16"]),
              ("bf16w", ["--serve-precision", "bf16"]),
              ("int8w", ["--serve-precision", "int8w"])]
TIERS_DISAGG = ["--serve-tiers", "prefill-pool", "--prefill-workers", "2"]
# a seeded death of prefill worker 0 (its draws fire at work items 0, 1
# and 2; worker 1's at none of the first 120) and a seeded transport
# corrupt (rows 1 and 2 of the third group), tests/test_torch_disagg.py's,
# armed together in one run
TIERS_FAULTS = ("disagg.worker:raise:0.05:73176,"
                "disagg.transport:corrupt:0.3:38")


def shm_segments() -> set:
    import glob

    return set(glob.glob("/dev/shm/psm_*"))


def device_used_sampler(torch):
    """(start, stop): a thread sampling the card's memory in use by every
    process (``cudaMemGetInfo``'s total - free) every 20 ms; ``stop()``
    returns the most seen, in bytes."""
    import threading

    peak, done = [0], threading.Event()

    def sample():
        while not done.is_set():
            free, total = torch.cuda.mem_get_info()
            peak[0] = max(peak[0], total - free)
            done.wait(0.02)
    t = threading.Thread(target=sample, daemon=True)

    def stop() -> int:
        done.set()
        t.join(5.0)
        return peak[0]
    t.start()
    return stop


def phase_tiers(torch, ctx, run32: dict, engine_bytes: bytes) -> int:
    """The serving tiers on the card: fira-full, the f32 trained
    checkpoint, 20 slots, R = 4, the [serve] phase's replayed trace under
    the virtual clock unless stated. Hard checks: (1) ``cli test --engine
    --spec-decode copy|draft --spec-k 4`` and ``copy --spec-k 2`` write
    ``cli test --engine``'s bytes; (2) on the checkpoint made
    ``copy_biased_params(delta=9, target_blind=True)`` the copy tier (k =
    8: a verify may pass a plain dispatch's 4 positions) writes that
    checkpoint's plain-engine bytes with accepted > 0, steps_saved > 0
    and fewer verify dispatches than the plain run's step dispatches;
    (3) ``--kv-dtype bf16``, ``--serve-precision bf16`` and ``int8w``
    each write the same bytes twice, the bf16 arena half the f32 bytes a
    slot, and spec under ``--kv-dtype bf16 --serve-precision int8w``
    writes that tier's plain bytes; (4) ``cli serve --serve-tiers
    prefill-pool --prefill-workers 2`` writes ``cli test --engine``'s
    bytes with no decode-side prefill, each worker mapping libcuda, and
    so does one run under a seeded worker death and a seeded transport
    corrupt (the tier's counters showing the death, the resubmits and
    the checksum catches); no shared-memory segment of a run is left
    after it; (5) K1's launches in
    each run equal ``k1_formula`` of its engines' counters. Printed beside
    the card: each spec tier's acceptance, verify frames and dispatches a
    commit against the plain engine on the trained and the biased
    checkpoints; spec against plain commits/s in turns s p p s;
    each tier against f32 (lines that differ, the B-Norm BLEU delta, the
    mean and p99 divergence of the beam scores); disaggregated against
    in-process req/s and p99 TTFT at 1.5x the drain, in 2 turns; the
    card's peak memory in use with the workers' contexts. Returns K1's
    launches in this process."""
    from fira_tpu_torch.decode import engine as engine_lib
    from fira_tpu_torch.decode import spec as spec_lib
    from fira_tpu_torch.eval import bnorm_bleu_files
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.serve import poisson_times, serve_split
    from fira_tpu_torch.serve.disagg import PrefillTier
    from fira_tpu_torch.serve.server import prepare_templates

    cs, ds, cfg = ctx["cs"], ctx["ds"], ctx["cfg"]
    t_phase = time.perf_counter()
    n = len(ds.splits["test"])
    R = cfg.engine_harvest_every
    want_lines = engine_bytes.decode().split("\n")
    work = os.path.join(ctx["work"], "tiers")
    os.makedirs(work)
    card = f"on {ctx['kind']}, {ctx['smi']}"
    k1 = 0
    free0, total = torch.cuda.mem_get_info()
    base_used = total - free0
    stop = device_used_sampler(torch)
    # the wall turns' prefill pool, started now so that its workers come
    # up while the runs below go on (a pool's start, torch's import in
    # each worker included, takes 15-30 s on the card's host)
    cc = cfg.replace(decode_engine=True, compute_dtype="float32",
                     prefix_cache=True)
    ct = cc.replace(serve_tiers="prefill-pool", prefill_workers=2)
    pool = PrefillTier(
        {k: v.detach().cpu().numpy() for k, v in run32["state_dict"].items()},
        ct, templates=prepare_templates(None, ds.splits["test"], ct, None,
                                        prewarm=False),
        device=f"cuda:{torch.cuda.current_device()}", dtype="float32")

    def per_commit(s):
        return s["step_dispatches"] / max(1, s["commits"])

    # --- (1) spec is exact on the trained checkpoint
    plain = engine_cli(torch, ctx, run32, "tiers_plain", ["--engine"])
    k1 += plain["k1"]
    check(plain["out"] == engine_bytes,
          "cli test --engine: not the engine phase's bytes")
    ps = plain["summary"]
    for name, flags, k in SPEC_RUNS:
        r = engine_cli(torch, ctx, run32, f"tiers_{name.replace(' ', '_')}",
                       ["--engine", *flags], spec_k=k)
        k1 += r["k1"]
        s = r["summary"]
        check(r["out"] == engine_bytes and s["verify_dispatches"] > 0,
              f"cli test --engine {' '.join(flags)}: "
              f"{len(n_lines_differ(r['out'], engine_bytes))} of {n} lines "
              f"differ from the plain engine's; {s}")
        print(f"[tiers] cli test --engine {' '.join(flags)} (trained "
              f"checkpoint): output_fira byte-identical to the plain "
              f"engine's; acceptance {s['acceptance_rate']} ({s['accepted']} "
              f"of {s['drafted']} drafted), verify dispatches "
              f"{s['verify_dispatches']} + {s['step_dispatches'] - s['verify_dispatches']} "
              f"plain, verify frames {s['spec_frames']}, steps saved "
              f"{s['steps_saved']}; dispatches a commit "
              f"{per_commit(s):.3f} against the plain engine's "
              f"{per_commit(ps):.3f}; host syncs {s['host_syncs']} vs "
              f"{ps['host_syncs']}; K1 {r['k1']} = {r['formula']}; "
              f"{r['wall']:.2f} s vs plain {plain['wall']:.2f} s", flush=True)

    laps = [("spec, trained", time.perf_counter() - t_phase)]
    # --- (2) spec advances on target-blind copy-biased weights
    bdir = os.path.join(work, "ckpt_biased")
    os.makedirs(bdir)
    biased = spec_lib.copy_biased_params(run32["state_dict"], delta=9.0,
                                         target_blind=True)
    torch.save(biased, os.path.join(bdir, "best.pt"))
    brun = dict(run32, ckpt_dir=bdir)
    bplain = engine_cli(torch, ctx, brun, "tiers_biased_plain", ["--engine"])
    k1 += bplain["k1"]
    bps = bplain["summary"]
    for tier in ("copy", "draft"):
        r = engine_cli(torch, ctx, brun, f"tiers_biased_{tier}",
                       ["--engine", "--spec-decode", tier, "--spec-k", "8"],
                       spec_k=8)
        k1 += r["k1"]
        s = r["summary"]
        check(r["out"] == bplain["out"],
              f"biased {tier} k8: {len(n_lines_differ(r['out'], bplain['out']))} "
              f"lines differ from the plain engine on the same weights")
        if tier == "copy":
            check(s["accepted"] > 0 and s["steps_saved"] > 0
                  and s["verify_dispatches"] < bps["step_dispatches"],
                  f"biased copy k8: accepted {s['accepted']}, steps saved "
                  f"{s['steps_saved']}, verify dispatches "
                  f"{s['verify_dispatches']} vs plain step dispatches "
                  f"{bps['step_dispatches']}")
        print(f"[tiers] cli test --engine --spec-decode {tier} --spec-k 8 "
              f"(copy-biased target-blind checkpoint): output_fira "
              f"byte-identical to its plain engine's; acceptance "
              f"{s['acceptance_rate']} ({s['accepted']} of {s['drafted']}), "
              f"verify dispatches {s['verify_dispatches']} (+ "
              f"{s['step_dispatches'] - s['verify_dispatches']} plain) vs "
              f"the plain run's {bps['step_dispatches']} step dispatches, "
              f"verify frames {s['spec_frames']}, steps saved "
              f"{s['steps_saved']}; dispatches a commit {per_commit(s):.3f} "
              f"vs {per_commit(bps):.3f}; K1 {r['k1']} = {r['formula']}; "
              f"{r['wall']:.2f} s vs plain {bplain['wall']:.2f} s",
              flush=True)

    laps.append(("spec, biased", time.perf_counter() - t_phase))
    # --- (3) each weight/KV tier is stable; spec exact within a tier
    outs = {}
    for name, flags in TIER_FLAGS:
        a = engine_cli(torch, ctx, run32, f"tiers_{name}_a",
                       ["--engine", *flags])
        b = engine_cli(torch, ctx, run32, f"tiers_{name}_b",
                       ["--engine", *flags])
        k1 += a["k1"] + b["k1"]
        s = a["summary"]
        check(a["out"] == b["out"],
              f"{name}: two runs differ in "
              f"{len(n_lines_differ(a['out'], b['out']))} lines")
        check(s["kv_dtype"] == ("bf16" if name == "bf16kv" else "f32")
              and s["serve_precision"] == {"bf16kv": "f32", "bf16w": "bf16",
                                           "int8w": "int8w"}[name],
              f"{name}: stamped {s['kv_dtype']}/{s['serve_precision']}")
        if name == "bf16kv":
            check(2 * s["kv_bytes_per_slot"] == ps["kv_bytes_per_slot"],
                  f"bf16kv: {s['kv_bytes_per_slot']} bytes a slot against "
                  f"f32's {ps['kv_bytes_per_slot']}")
        outs[name] = a
    combo = ["--kv-dtype", "bf16", "--serve-precision", "int8w"]
    cplain = engine_cli(torch, ctx, run32, "tiers_combo", ["--engine",
                                                           *combo])
    cspec = engine_cli(torch, ctx, run32, "tiers_combo_spec",
                       ["--engine", *combo, "--spec-decode", "copy",
                        "--spec-k", "4"], spec_k=4)
    k1 += cplain["k1"] + cspec["k1"]
    check(cspec["out"] == cplain["out"],
          f"spec under bf16kv.int8w: "
          f"{len(n_lines_differ(cspec['out'], cplain['out']))} lines differ "
          f"from that tier's plain engine")
    outs["bf16kv+int8w"] = cplain
    print(f"[tiers] each tier twice through cli test --engine: the same "
          f"bytes both times; kv_bytes_per_slot bf16 "
          f"{outs['bf16kv']['summary']['kv_bytes_per_slot']} vs f32 "
          f"{ps['kv_bytes_per_slot']}; spec copy k4 under --kv-dtype bf16 "
          f"--serve-precision int8w writes that tier's plain bytes "
          f"(acceptance {cspec['summary']['acceptance_rate']})", flush=True)

    laps.append(("tiers twice", time.perf_counter() - t_phase))
    # quality against f32, and the beam scores' divergence (in process)
    c1 = cfg.replace(decode_engine=True, compute_dtype="float32")
    model = FiraModel(c1, device="cuda", dtype="float32").eval()
    model.load_state_dict(run32["state_dict"])
    batches = staged_batches(torch, ctx, c1)
    ref = engine_decode(torch, ctx, model, c1, batches)
    k1 += ref["k1"]
    check(ref["out"] == engine_bytes, "in-process f32 engine: not the "
          "engine phase's bytes")
    f32_bleu = bnorm_bleu_files(plain["path"], ctx["gt_file"])
    for name, knobs in (("bf16kv", dict(kv_dtype="bf16")),
                        ("bf16w", dict(serve_precision="bf16")),
                        ("int8w", dict(serve_precision="int8w")),
                        ("bf16kv+int8w", dict(kv_dtype="bf16",
                                              serve_precision="int8w"))):
        r = engine_decode(torch, ctx, model, c1.replace(**knobs), batches)
        k1 += r["k1"]
        check(r["out"] == outs[name]["out"],
              f"{name}: in process, not the CLI's bytes")
        div = np.concatenate([np.abs(r["probs"][p].ravel()
                                     - ref["probs"][p].ravel())
                              for p in sorted(ref["probs"])])
        bleu = bnorm_bleu_files(outs[name]["path"], ctx["gt_file"])
        print(f"[tiers] {name} against f32: "
              f"{len(n_lines_differ(outs[name]['out'], engine_bytes))} of "
              f"{n} lines differ, B-Norm BLEU {bleu!r} vs {f32_bleu!r} "
              f"(delta {bleu - f32_bleu:+.4f}), beam-score divergence mean "
              f"{float(div.mean()):.3e} p99 "
              f"{float(np.percentile(div, 99)):.3e}; peak memory above "
              f"held {r['peak'] / 2**20:.1f} vs {ref['peak'] / 2**20:.1f} "
              f"MiB; {r['rate']:.2f} vs {ref['rate']:.2f} commits/s; "
              f"{card}", flush=True)

    laps.append(("quality", time.perf_counter() - t_phase))
    # spec against plain commits/s, in turns s p p s (warm engines)
    cspec1 = c1.replace(spec_decode="copy", engine_spec_k=4)
    e_plain = ref["eng"]
    e_spec = engine_lib.SlotEngine(model, cspec1)
    e_spec.prewarm([batches[0][1]])
    rates = {"plain": [], "spec": []}
    for i, which in enumerate(("spec", "plain", "plain", "spec")):
        c = cspec1 if which == "spec" else c1
        r = engine_decode(torch, ctx, model, c, batches,
                          eng=e_spec if which == "spec" else e_plain)
        k1 += r["k1"]
        check(r["out"] == engine_bytes, f"turn {i + 1} ({which}): bytes")
        rates[which].append(r["rate"])
    print(f"[tiers] commits/s in turns s p p s, copy k4 vs plain "
          f"(trained checkpoint, 20 slots): spec "
          f"{', '.join(f'{x:.2f}' for x in rates['spec'])}, plain "
          f"{', '.join(f'{x:.2f}' for x in rates['plain'])}; {card}",
          flush=True)
    del e_spec

    laps.append(("spec turns", time.perf_counter() - t_phase))
    # --- (4) the disaggregated prefill tier
    before = shm_segments()
    t0 = time.perf_counter()
    r, kids = watch_children(lambda: serve_cli(
        torch, ctx, run32, "tiers disagg", TIERS_DISAGG, sub="tiers"))
    call_s = time.perf_counter() - t0
    k1 += r["k1"]
    sv, e, tiers = (r["metrics"]["serve"], r["metrics"]["engine"],
                    r["metrics"]["serve"]["tiers"])
    check(r["out"] == engine_bytes and sv["completed"] == n,
          f"cli serve {' '.join(TIERS_DISAGG)}: "
          f"{len(n_lines_differ(r['out'], engine_bytes))} lines differ")
    check(e["prefills"] == 0 and e["cache_hits"] == tiers["rows_delivered"]
          and tiers["workers"] == 2 and tiers["workers_lost"] == 0
          and not tiers["fallback"],
          f"cli serve tiers: engine {e['prefills']} prefills, "
          f"{e['cache_hits']} hits; tiers {tiers}")
    check(len(kids) >= 2 and all(f[0] and f[1] for f in kids.values()),
          f"prefill workers: {kids} (pid -> libtorch, libcuda mapped)")
    check(shm_segments() <= before, "a shared-memory segment was left")
    print(f"[tiers] cli serve {' '.join(TIERS_DISAGG)}: output_fira "
          f"byte-identical to cli test --engine, decode-side prefills "
          f"{e['prefills']}, cache hits {e['cache_hits']}; {r['line']}; "
          f"tiers: groups {tiers['groups_submitted']}, rows "
          f"{tiers['rows_delivered']} by worker {tiers['rows_by_worker']}, "
          f"shm segments {tiers['shm_segments']}, artifact bytes "
          f"{tiers['artifact_bytes']}, peak in flight "
          f"{tiers['peak_inflight_bytes']}, prefill busy "
          f"{tiers['prefill_busy_s']:.3f} s; workers {sorted(kids)} each "
          f"mapping libtorch and libcuda; /dev/shm free "
          f"{shutil.disk_usage('/dev/shm').free / 2**20:.0f} MiB; K1 "
          f"{r['k1']}; the call {call_s:.2f} s", flush=True)
    before = shm_segments()
    t0 = time.perf_counter()
    r = serve_cli(torch, ctx, run32, "tiers faults",
                  TIERS_DISAGG + ["--inject-faults", TIERS_FAULTS],
                  sub="tiers")
    call_s = time.perf_counter() - t0
    k1 += r["k1"]
    sv, tiers = r["metrics"]["serve"], r["metrics"]["serve"]["tiers"]
    check(r["out"] == engine_bytes and sv["completed"] == n,
          f"cli serve tiers, faults: "
          f"{len(n_lines_differ(r['out'], engine_bytes))} lines differ")
    check(tiers["workers_lost"] == 1 and not tiers["fallback"]
          and tiers["transport_integrity_drops"] > 0
          and tiers["rows_resubmitted"] > tiers["transport_integrity_drops"],
          f"cli serve tiers, faults: {tiers}")
    check(shm_segments() <= before, "a shared-memory segment was left")
    print(f"[tiers] cli serve tiers, {TIERS_FAULTS}: output_fira "
          f"byte-identical; fired in this process {r['metrics'].get('faults')} "
          f"(a worker's own draws fire in it); workers lost "
          f"{tiers['workers_lost']}, rows resubmitted "
          f"{tiers['rows_resubmitted']}, checksum catches "
          f"{tiers['transport_integrity_drops']}, given up "
          f"{tiers['rows_given_up']}, fallback {tiers['fallback']}, "
          f"decode-side prefills {r['metrics']['engine']['prefills']}; K1 "
          f"{r['k1']}; the call {call_s:.2f} s", flush=True)
    laps.append(("disagg checks", time.perf_counter() - t_phase))
    # disaggregated against in-process, wall clock at 1.5x the drain, one
    # turn each on one warm engine and the pool started at the
    # phase's start, the prefix cache on (the tiers need it) and emptied
    # before each run
    check(pool.wait_ready(300.0), "the wall turns' prefill pool never "
          "came up")
    eng = engine_lib.SlotEngine(model, cc)
    eng.prewarm([batches[0][1]])
    rate = 1.5 * ref["rate"]
    times = poisson_times(n, rate, seed=5)
    walls = {"disagg": [], "in-process": []}
    for i, which in enumerate(("disagg", "in-process")):
        c = ct if which == "disagg" else cc
        eng.stats = engine_lib.EngineStats(slots=eng.slots)
        eng.cache_clear()
        cs.copy_scores.launches = 0
        t0 = time.perf_counter()
        m = serve_split(model, ds, c, arrival_times=times,
                        out_dir=os.path.join(work, f"wall_{i}"),
                        clock="wall", var_maps=ctx["var_maps"], engine=eng,
                        tier=pool if which == "disagg" else None)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launched = cs.copy_scores.launches
        k1 += launched
        sv, e = m["serve"], m["engine"]
        check(launched == R * e["step_dispatches"],
              f"wall {which}: K1 launched {launched} times")
        check(sv["completed"] == n and serve_bytes(m) == engine_bytes,
              f"wall {which}: {sv['completed']} of {n} done, or bytes")
        if which == "disagg":
            check(e["prefills"] == 0, f"wall disagg: {e['prefills']} "
                  f"decode-side prefills")
        walls[which].append((sv["throughput_rps"], sv["p99_ttft_s"]))
        print(f"[tiers] wall clock, turn {i + 1}, {which}: offered "
              f"{rate:.2f} req/s (1.5x the drain's {ref['rate']:.2f}), "
              f"completed {sv['throughput_rps']} req/s, p50/p99 TTFT "
              f"{sv['p50_ttft_s']}/{sv['p99_ttft_s']} s, p50/p99 e2e "
              f"{sv['p50_e2e_s']}/{sv['p99_e2e_s']} s, decode-side "
              f"prefills {e['prefills']}; K1 {launched}; the call "
              f"{call_s:.2f} s; {card}", flush=True)
    before = shm_segments()
    pool.close()
    check(shm_segments() <= before, "a shared-memory segment was left")
    peak_used = stop()
    laps.append(("wall turns", time.perf_counter() - t_phase))
    print(f"[tiers] the card's memory in use, every process: before the "
          f"phase {base_used / 2**30:.2f} GiB, most during it "
          f"{peak_used / 2**30:.2f} GiB (the prefill workers' CUDA contexts "
          f"and models included: the wall turns' 2 beside a serve's own 2); "
          f"{card}", flush=True)
    print(f"[tiers] the phase: K1 launched {k1} times in this process "
          f"(each run as k1_formula of its counters; the workers launch "
          f"none), {time.perf_counter() - t_phase:.1f} s (ends of its parts: "
          + ", ".join(f"{a} {b:.1f} s" for a, b in laps) + ")", flush=True)
    del model, eng, ref
    torch.cuda.empty_cache()
    return k1


MESH_STEPS = 3     # steps of each two-rank layout
MESH_RTOL = 2e-5   # a layout's loss against one process (the JAX package's
                   # mesh tolerance, tests/test_train_decode.py)
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-5   # a layout's first-batch gradients
                   # against one process, entry by entry (the JAX
                   # package's, tests/test_train_decode.py)


def grad_report(torch, got: dict, want: dict) -> dict:
    """A layout's gathered gradients ``got`` against one process' ``want``
    (name -> CPU tensor): the whole gradient's relative error in norm; the
    leaf furthest outside ``GRAD_RTOL``/``GRAD_ATOL`` (its excess, <= 0
    inside); and the leaf with the largest error against its own largest
    entry, with that entry: the key-projection biases and the copy
    score's scalar bias shift every softmax they feed by a constant, so
    their gradients are 0 but for rounding, and that ratio is large
    there."""
    check(sorted(got) == sorted(want), f"gradient names differ: "
          f"{sorted(set(got) ^ set(want))}")
    num = sum(float((got[k] - w).double().pow(2).sum())
              for k, w in want.items())
    den = sum(float(w.double().pow(2).sum()) for w in want.values())
    excess, ratio = {}, {}
    for k, w in want.items():
        d = (got[k] - w).abs()
        excess[k] = float((d - GRAD_RTOL * w.abs()).max()) - GRAD_ATOL
        ratio[k] = (float(d.max()), float(w.abs().max()))
    worst = max(excess, key=excess.get)
    odd = max(ratio, key=lambda k: ratio[k][0] / max(ratio[k][1], 1e-30))
    return {"norm_rel": (num / den) ** 0.5, "worst": worst,
            "excess": excess[worst], "odd": odd, "odd_err": ratio[odd][0],
            "odd_max": ratio[odd][1],
            "g_max": max(m for _, m in ratio.values())}


def file_bytes_equal(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_mesh(torch, ctx, run32: dict) -> dict:
    """The training mesh (``parallel/mesh.py``) on the one card, fira-full
    f32, counts from zero around each run:

    1. ``cli train --mesh 1x1`` (a one-rank NCCL group in this process),
       one epoch with ``--feeder-workers 0``: ``latest.pt`` byte-identical
       to the ``[train]`` phase's ``cli train`` of the same flags;
    2. ``train.loop.train`` on a 1x1 mesh with the gate, 2 epochs: every
       step's loss, ``best.pt`` and ``latest.pt`` bitwise equal to the
       ``[train]`` phase's f32 run;
    3. two ranks sharing the card through the library (``RankPool``,
       backend gloo, every collective staged through host memory; gloo's
       own all-reduce, broadcast and all-gather on CUDA tensors are
       checked too; its own send/recv ends the process, so it is not run):
       DP 2x1 and TP 1x2, ``MESH_STEPS`` steps at batch 170 from the
       seeded weights, dropout off: each step's loss within ``MESH_RTOL``
       of one process, the first batch's gradients gathered whole within
       ``GRAD_RTOL``/``GRAD_ATOL`` of one process' entry by entry and
       within ``GRAD_RTOL`` in norm (``grad_report``); K1 and K2 once a
       step on each rank at its shard's shape; steps/s and peak memory of
       each rank (two ranks on one card: not scaling);
    4. TP 1x2 with dropout on, one step: the replicated parameters
       bit-identical across the ranks, the loss within ``MESH_RTOL`` of
       one process drawing from the same seed;
    5. the ring: ``seq_shards=2`` on the 2x1 ranks, the loss of one batch
       within ``MESH_RTOL`` of dense cross-attention;
    6. out_fc's all-reduce of the (170 x 30, 24,650) f32 logits timed on
       the 1x1 NCCL group and the two gloo ranks;
    7. ``cli train --mesh 2x1`` exits 2 on the one card.

    Returns the K1/K2 launches of the 1x1 runs (full shapes) and of the
    ranks (shard shapes)."""
    import dataclasses

    import torch.distributed as dist

    from fira_tpu_torch import cli
    from fira_tpu_torch.data.batching import make_batch
    from fira_tpu_torch.data.feeder import TRAIN_FIELDS, batch_to_device
    from fira_tpu_torch.model.model import FiraModel
    from fira_tpu_torch.parallel import jobs, mesh as pm
    from fira_tpu_torch.train import loop as train_loop
    from fira_tpu_torch.train import state as st
    from fira_tpu_torch.train import step as sl

    cs, ds, work, cfg = ctx["cs"], ctx["ds"], ctx["work"], ctx["cfg"]
    mwork = os.path.join(work, "mesh")
    counts = {"k1": 0, "k2": 0}

    def counted(fn):
        cs.copy_scores.launches = cs.copy_scores_backward.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts["k1"] += cs.copy_scores.launches
        counts["k2"] += cs.copy_scores_backward.launches
        return out

    # 1. cli train --mesh 1x1 against the [train] phase's cli train
    t0 = time.perf_counter()
    rc = counted(lambda: cli.main([
        "train", "--config", "fira-full", "--data-dir", ctx["data_dir"],
        "--out-dir", os.path.join(mwork, "cli"), "--ckpt-dir",
        os.path.join(mwork, "ckpt_cli"), "--epochs", "1", "--dtype",
        "float32", "--feeder-workers", "0", "--mesh", "1x1"]))
    check(rc == 0, f"cli train --mesh 1x1 exited {rc}")
    check(not dist.is_initialized(), "cli train --mesh 1x1 left its group")
    same_cli = file_bytes_equal(
        os.path.join(mwork, "ckpt_cli", "latest.pt"),
        os.path.join(work, "ckpt_cli_float32", "latest.pt"))
    print(f"[mesh] cli train --mesh 1x1 (one-rank NCCL group), 1 epoch, "
          f"--feeder-workers 0: latest.pt byte-identical to cli train "
          f"without --mesh: {same_cli} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(same_cli, "cli train --mesh 1x1: latest.pt differs from the run "
          "without a mesh")

    # 2. train.loop.train on a 1x1 mesh against the [train] phase's run
    res = counted(lambda: train_loop.train(
        ds, run32["gated"], device="cuda", mesh=pm.make_mesh(1, 1),
        out_dir=os.path.join(mwork, "lib"),
        ckpt_dir=os.path.join(mwork, "ckpt_lib"), epochs=2,
        var_maps=ctx["var_maps"], resume=False))
    ref = run32["result"]
    same = {"losses": res.losses == ref.losses}
    for name in ("best.pt", "latest.pt"):
        a = os.path.join(mwork, "ckpt_lib", name)
        b = os.path.join(run32["ckpt_dir"], name)
        check(os.path.exists(a) and os.path.exists(b),
              f"1x1 mesh: {name} missing ({os.path.exists(a)}, "
              f"{os.path.exists(b)})")
        same[name] = file_bytes_equal(a, b)
    print(f"[mesh] train.loop.train on a 1x1 mesh, 2 epochs with the gate: "
          f"{len(res.losses)} step losses, {res.gates} gates; bitwise equal "
          f"to the run without a mesh: {same}; steps/s "
          f"{res.steps_per_sec:.3f} vs {ref.steps_per_sec:.3f}", flush=True)
    check(all(same.values()), f"1x1 mesh differs from no mesh: {same}")
    del res

    # 6a. out_fc's all-reduce on the one-rank NCCL group
    shape = (cfg.batch_size * cfg.tar_len, cfg.vocab_size)
    bound = pm.init_single(pm.make_mesh(1, 1), mwork)
    try:
        nccl_ar = jobs.all_reduce_job(bound, shape)
    finally:
        dist.destroy_process_group()

    # the one-process references: MESH_STEPS steps from the seeded weights
    split = ds.splits["train"]
    hosts = [make_batch(split, [(cfg.batch_size * i + j) % len(split)
                                for j in range(cfg.batch_size)], cfg,
                        batch_size=cfg.batch_size)
             for i in range(MESH_STEPS)]
    plain = cfg.replace(dropout_rate=0.0, gcn_dropout_rate=0.0)

    def single(c, n_steps=MESH_STEPS):
        state = st.init_state(c, "cuda")
        batches = [batch_to_device(h, torch.device("cuda"), TRAIN_FIELDS)
                   for h in hosts[:n_steps]]
        out = {"full": {k: v.detach().cpu().clone()
                        for k, v in state.model.state_dict().items()}}
        # the first batch's gradients, as jobs.step_job takes them
        state.model.train()
        sl.loss_fn(state.model, batches[0],
                   torch.Generator(device="cuda").manual_seed(0)).backward()
        out["grads"] = {k: p.grad.detach().cpu().clone()
                        for k, p in state.model.named_parameters()}
        state.optimizer.zero_grad(set_to_none=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        out["losses"] = [float(sl.train_step(state.model, state.optimizer, b,
                                             gen)) for b in batches]
        return out

    ref_plain = single(plain)
    ref_drop = single(cfg, n_steps=1)
    full = ref_plain["full"]
    torch.cuda.empty_cache()

    gloo = dict(devices=["cuda:0", "cuda:0"], backend="gloo")
    rank_counts = {}
    t0 = time.perf_counter()
    with pm.RankPool(pm.make_mesh(2, 1, **gloo), mwork,
                     timeout_s=600) as pool:
        up = time.perf_counter() - t0
        probe = pool.run(jobs.probe_job, ops=jobs.PROBE_OPS[:3])[0]
        probe.update(pool.run(jobs.probe_job, ops=("send_recv",),
                              modes=("staged",))[0])
        print(f"[mesh] two gloo ranks sharing the card up in {up:.1f} s; "
              f"collectives on CUDA tensors: {probe}", flush=True)
        check(all(v == "ok" for v in probe.values()),
              f"gloo collectives on the card: {probe}")
        for name, lay in (("dp", (2, 1)), ("tp", (1, 2))):
            got = pool.run(jobs.step_job, plain, full, hosts,
                           mesh=pm.make_mesh(*lay, **gloo))
            r0 = got[0]
            rel = max_rel(r0["losses"], ref_plain["losses"])
            gr = grad_report(torch, r0.pop("grads"), ref_plain["grads"])
            rank_counts[name] = {"k1": sum(r["k1"] for r in got),
                                 "k2": sum(r["k2"] for r in got)}
            print(f"[mesh] {name.upper()} {lay[0]}x{lay[1]} (two ranks on one "
                  f"card, not scaling): losses "
                  + " ".join(f"{x:.6f}" for x in r0["losses"])
                  + f" vs one process "
                  + " ".join(f"{x:.6f}" for x in ref_plain["losses"])
                  + f", max rel {rel:.3e} (rtol {MESH_RTOL}); first-batch "
                  f"gradients: {gr['norm_rel']:.3e} of the norm, every entry "
                  f"within rtol {GRAD_RTOL} / atol {GRAD_ATOL} (closest: "
                  f"{gr['worst']}, {gr['excess']:.3e} past it), largest "
                  f"entry {gr['g_max']:.3e}; the largest error against a "
                  f"leaf's own largest entry: {gr['odd']}, |err| "
                  f"{gr['odd_err']:.3e} at max |g| {gr['odd_max']:.3e} "
                  f"(0 but for rounding); K1/K2 a rank "
                  + ", ".join(f"{r['k1']}/{r['k2']}" for r in got)
                  + "; steps/s a rank "
                  + ", ".join(f"{MESH_STEPS / r['seconds']:.3f}" for r in got)
                  + "; peak memory a rank "
                  + ", ".join(f"{r['peak'] / 2**20:.0f} MiB" for r in got),
                  flush=True)
            check(rel <= MESH_RTOL, f"{name} loss off by {rel:.3e}")
            check(gr["excess"] <= 0 and gr["norm_rel"] <= GRAD_RTOL,
                  f"{name} gradients: {gr}")
            check(all(r["k1"] == r["k2"] == MESH_STEPS for r in got),
                  f"{name}: K1/K2 launches {[(r['k1'], r['k2']) for r in got]}"
                  f", expected {MESH_STEPS} each a rank")
        tp = pm.make_mesh(1, 2, **gloo)
        got = pool.run(jobs.step_job, cfg, full, hosts[:1], grads=False,
                       mesh=tp)
        rank_counts["tp"]["k1"] += sum(r["k1"] for r in got)
        rank_counts["tp"]["k2"] += sum(r["k2"] for r in got)
        rep = got[0]["replicated"]
        same_rep = all(torch.equal(v, got[1]["replicated"][k])
                       for k, v in rep.items())
        rel = max_rel(got[0]["losses"], ref_drop["losses"])
        print(f"[mesh] TP 1x2 with dropout on, one step: {len(rep)} "
              f"replicated parameters bit-identical across the ranks: "
              f"{same_rep}; loss rel {rel:.3e} from one process drawing the "
              f"same seed", flush=True)
        check(same_rep, "TP ranks' replicated parameters drifted apart")
        check(rel <= MESH_RTOL, f"TP dropout loss off by {rel:.3e}")
        gloo_ar = pool.run(jobs.all_reduce_job, shape, mesh=tp)
        print(f"[mesh] out_fc's all-reduce of {shape} f32 "
              f"({nccl_ar['bytes'] / 1e6:.1f} MB): {nccl_ar['ms']:.3f} ms on "
              f"the one-rank NCCL group (a copy), "
              + ", ".join(f"{r['ms']:.3f}" for r in gloo_ar)
              + " ms on the two gloo ranks (staged through host memory)",
              flush=True)
        ring_mesh = dataclasses.replace(pm.make_mesh(2, 1, **gloo),
                                        seq_shards=2)
        t0 = time.perf_counter()
        got = pool.run(jobs.model_job, plain.replace(seq_shards=2), full,
                       hosts[0], mesh=ring_mesh)
        ring_s = time.perf_counter() - t0
    model = FiraModel(plain, device="cuda").eval()
    model.load_state_dict(full)
    with torch.no_grad():
        nll, cnt = model(batch_to_device(hosts[0], torch.device("cuda"),
                                         TRAIN_FIELDS))
    ring_nll = sum(r["nll"] for r in got)
    rel = abs(ring_nll - float(nll)) / abs(float(nll))
    print(f"[mesh] ring attention, seq_shards=2 on the two ranks: nll "
          f"{ring_nll:.6f} vs dense {float(nll):.6f} (rel {rel:.3e}), count "
          f"{sum(r['count'] for r in got)} vs {int(cnt)}; {ring_s:.1f} s",
          flush=True)
    check(rel <= MESH_RTOL and sum(r["count"] for r in got) == int(cnt),
          f"ring loss off by {rel:.3e}")
    del model

    # 7. a mesh larger than the card
    rc, _out, err, _k1 = run_cli(torch, ctx, [
        "train", "--config", "fira-full", "--data-dir", ctx["data_dir"],
        "--out-dir", os.path.join(mwork, "too_big"), "--mesh", "2x1"])
    want = f"need 2 devices, have {torch.cuda.device_count()}"
    print(f"[mesh] cli train --mesh 2x1 on {torch.cuda.device_count()} "
          f"card(s): exit {rc}: {err.strip()}", flush=True)
    check(rc == 2 and want in err, f"--mesh 2x1: exit {rc}, {err!r}")
    return dict(full=counts, **rank_counts)


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
    t_smoke = time.perf_counter()

    def lap(what: str) -> None:
        """The smoke's clock at the end of a part (its time limit is
        fixed while it grows)."""
        print(f"[time] {what}: done {time.perf_counter() - t_smoke:.1f} s "
              f"into the smoke", flush=True)

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
               var_maps=var_maps, kind=kind, gt_file=gt_file, smi=smi,
               root=root)

    tables = phase_buckets(ctx)
    bucket_t = tables["main"].tar_len
    fwd32, fwd16 = phase_kernels(torch, cs, cfg, bucket_t)
    bwd32 = phase_kernels_bwd(torch, cs, cfg, torch.float32)
    bwd16 = phase_kernels_bwd(torch, cs, cfg, torch.bfloat16)
    # a mesh rank's shards: 85 rows of 2 data ranks, 128 features of 2
    # model ranks
    bwd_dp = phase_kernels_bwd(torch, cs, cfg, torch.float32, B=85)
    bwd_tp = phase_kernels_bwd(torch, cs, cfg, torch.float32,
                               D=cfg.embedding_dim // 2)
    for rec, dt in ((bwd32, torch.float32), (bwd16, torch.bfloat16)):
        rec.update({f"bucket_{k}": v for k, v in phase_kernels_bwd(
            torch, cs, cfg, dt, T=bucket_t).items()})
    lap("build, buckets, kernels")

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
    lap("train, train plain, feed, dev gate")

    # --- bucketed geometry and grouped steps ---
    tb32 = train_buckets(torch, ctx, "float32", tables)
    tb16 = train_buckets(torch, ctx, "bfloat16", tables)
    bucket_checks(torch, ctx, tables)
    for dtype in ("float32", "bfloat16"):
        bucket_turns(torch, ctx, dtype, tables)
    lap("train buckets, bucket checks, turns")


    # --- profile one warm training step: f32 plain copy score, f32
    # kernels, bf16 kernels; then one at the main train bucket's geometry
    # (a full chunk of its commits) in each dtype ---
    from fira_tpu_torch.data import buckets as B

    geom = tables["main"]
    in_bucket = np.where(B.sample_extents(ds.splits["train"], cfg)
                         .admissible(geom))[0][:cfg.batch_size]
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        state = init_state(c, "cuda")
        cases = [(None, list(range(cfg.batch_size)), "plain copy score",
                  cs.copy_scores_reference)] if dtype == "float32" else []
        cases += [(None, list(range(cfg.batch_size)), "kernels",
                   cs.copy_scores),
                  (geom, in_bucket, f"kernels, bucket "
                   f"{':'.join(map(str, geom))}", cs.copy_scores)]
        for g, chunk, label, fn in cases:
            host = make_batch(ds.splits["train"], chunk, c,
                              batch_size=cfg.batch_size, geom=g)
            batch = batch_to_device(host, torch.device("cuda"), TRAIN_FIELDS)
            state.model.copy_net.score_fn = fn
            profile_one(torch, f"one training step (batch {cfg.batch_size}, "
                        f"{dtype}, {label})", lambda: train_step(
                            state.model, state.optimizer, batch,
                            state.generator))
        del state, batch
    # --- one warm f32 step under typed edges and under the segment
    # adjacency beside the default path: the kernels that grew ---
    base = None
    for name in ("default", "typed", "segment"):
        c = cfg.replace(**ENCODER_VARIANTS[name])
        state = init_state(c, "cuda")
        host = make_batch(ds.splits["train"], list(range(cfg.batch_size)), c,
                          batch_size=cfg.batch_size)
        batch = batch_to_device(host, torch.device("cuda"), TRAIN_FIELDS)
        got = profile_one(torch, f"one training step (batch "
                          f"{cfg.batch_size}, float32, {name})",
                          lambda: train_step(state.model, state.optimizer,
                                             batch, state.generator))
        if base is None:
            base = got
        else:
            kernels_grown(f"{name} step vs default step (float32)", got, base)
        del state, batch

    # --- the test paths: each dtype's CLI decodes its trained checkpoint ---
    lap("profiles")
    main32 = test_path(torch, ctx, run32)
    decode_plain(torch, ctx, run32, main32)
    mb32 = test_buckets(torch, ctx, run32, main32)
    main16 = test_path(torch, ctx, run16)
    decode_plain(torch, ctx, run16, main16)
    mb16 = test_buckets(torch, ctx, run16, main16)
    # --- the encoder variants: split buffer, segment adjacency (sorted
    # edges or not), flat scatter, typed edges; every beam mode; then the
    # new flags through the entry points ---
    lap("main, plain, test buckets")
    ev32 = encoder_variants(torch, ctx, "float32")
    ev16 = encoder_variants(torch, ctx, "bfloat16")
    encoder_checks(torch, ctx)
    lap("encoder variants")
    modes32 = beam_modes(torch, ctx, run32, main32)
    modes16 = beam_modes(torch, ctx, run16, main16)
    lap("beam modes")
    flags32 = cli_new_flags(torch, ctx, run32, modes32)
    lap("cli flags")
    # --- the slot-refill engine: cli test --engine in every mode against
    # the batched bytes, --perf production, tar buckets, mixed depths,
    # engine vs batched in turns ---
    eng_k1, engine_bytes = engine_phase(torch, ctx, run32, run16, modes32)
    lap("engine")
    # --- cli serve on one engine: replayed traces against cli test
    # --engine, the prefix cache and dedup, wall-clock rates, faults ---
    serve_k1 = serve_phase(torch, ctx, run32, engine_bytes)
    lap("serve")
    # --- preprocessing and the one-shot raw-diff path, cli message ---
    phase_preprocess(ctx)
    msg_k1 = phase_message(torch, ctx, run32, run16)
    lap("preprocess, message")
    # --- cli serve --input diffs and the ingest fast path ---
    diffs_k1 = phase_serve_diffs(torch, ctx, run32)
    lap("serve-diffs")
    # --- the replicated fleet and recovery: replicas, retirement, respawn,
    # spares, kill and resume ---
    fleet_k1 = phase_fleet(torch, ctx, run32, engine_bytes)
    lap("fleet")
    # --- the serving tiers: spec decode, the low-precision tiers, the
    # disaggregated prefill tier ---
    tiers_k1 = phase_tiers(torch, ctx, run32, engine_bytes)
    lap("tiers")
    # --- the training mesh: 1x1 on NCCL bitwise against no mesh, two
    # gloo ranks sharing the card in DP and TP, the ring, the refusal ---
    mesh_k = phase_mesh(torch, ctx, run32)
    lap("mesh")
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
    lap("decode profiles, small reference")

    common = dict(route="cuda", library_ms=None)
    fwd = dict(source="fira_tpu_torch/ops/csrc/copy_score.cu",
               replaces="fira_tpu/ops/copy_score.py:119", **common)
    bwd = dict(source="fira_tpu_torch/ops/csrc/copy_score_bwd.cu",
               replaces="fira_tpu/ops/copy_score.py:148", **common)
    kernels = [
        dict(name="copy_score_fwd", dtype="float32",
             launches=sum(r["k1"] for r in (run32, main32, tb32, mb32, ev32,
                                            modes32, flags32))
             + eng_k1["float32"] + msg_k1["float32"] + serve_k1 + diffs_k1
             + fleet_k1 + tiers_k1 + mesh_k["full"]["k1"],
             **fwd,
             **fwd32),
        dict(name="copy_score_fwd_bf16", dtype="bfloat16",
             launches=sum(r["k1"] for r in (run16, main16, tb16, mb16, ev16,
                                            modes16)) + eng_k1["bfloat16"]
             + msg_k1["bfloat16"], **fwd, **fwd16),
        dict(name="copy_score_bwd", dtype="float32",
             launches=sum(r["k2"] for r in (run32, tb32, ev32, flags32))
             + mesh_k["full"]["k2"],
             **bwd, **bwd32),
        dict(name="copy_score_bwd_bf16", dtype="bfloat16",
             launches=sum(r["k2"] for r in (run16, tb16, ev16)),
             **bwd, **bwd16)]
    # the mesh ranks' shards (phase mesh; their launches counted in the
    # ranks)
    for part, what in (("dp", "85 rows of 2 data ranks"),
                       ("tp", "128 features of 2 model ranks")):
        kernels.append(dict(
            name=f"copy_score_fwd_{part}_shard", dtype="float32",
            shard=what, launches=mesh_k[part]["k1"], **fwd,
            **{k[len(part) + 1:]: v for k, v in fwd32.items()
               if k.startswith(f"{part}_")}))
        kernels.append(dict(
            name=f"copy_score_bwd_{part}_shard", dtype="float32",
            shard=what, launches=mesh_k[part]["k2"], **bwd,
            **(bwd_dp if part == "dp" else bwd_tp)))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
