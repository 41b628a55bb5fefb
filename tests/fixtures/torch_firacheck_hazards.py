"""Planted-hazard corpus for the port's firacheck, in torch idiom
(tests/test_torch_analysis.py), counterpart of firacheck_hazards.py.

NEVER imported — scanned as text under a VIRTUAL DRIVER PATH ending in
``fira_tpu_torch/decode/beam.py``: a driver module (its loops are hot),
whose step programs include ``beam_search``, inside a subpackage that
GEOMETRY-DRIFT covers. Every line carrying ``HAZARD[RULE-ID]`` (in a
plain comment or inside an allow-reason) must produce exactly that
finding; lines whose allow-reason says SILENCED must produce none. The
golden test derives the expected finding set from these markers, so
lines can move freely.

Directory walks skip ``fixtures/`` (engine.iter_py_files) — these hazards
are live on purpose and must not dirty the repo self-scan.
"""

import numpy as np
import torch

# firacheck: allow[DRIVER-REG] this corpus is a scanned-as-text test bed whose program builds ARE the planted hazards — it never dispatches anything, so driver registration would be noise (the earliest program build anchors the module-level finding here)
GRAPH = torch.cuda.CUDAGraph()  # control: built once, outside any loop


# --- HOST-SYNC: torch's read-backs inside hot regions --------------------

def drive(model, batches):
    for b in batches:
        loss = model(b)
        a = loss.item()  # HAZARD[HOST-SYNC] .item() every step
        c = loss.cpu().numpy()  # HAZARD[HOST-SYNC] one finding for the chain
        d = loss.tolist()  # HAZARD[HOST-SYNC] .tolist() every step
        e = loss.to("cpu")  # HAZARD[HOST-SYNC] .to("cpu") every step
        f = loss.to(device="cpu")  # HAZARD[HOST-SYNC] .to(device="cpu")
        torch.cuda.synchronize()  # HAZARD[HOST-SYNC] a full device wait
        b.ready.synchronize()  # HAZARD[HOST-SYNC] an event wait
        g = np.asarray(loss)  # HAZARD[HOST-SYNC] np.asarray of a tensor
        h = float(loss)  # HAZARD[HOST-SYNC] float() of a bare value
        if loss.isnan().any():  # HAZARD[HOST-SYNC] truth value of .any()
            break
        ok = bool(torch.equal(loss, b))  # HAZARD[HOST-SYNC] truth value of torch.equal
        moved = loss.to(b.device)  # control: a device-side move
        n = int(len(batches))  # control: a cast of a call result
        model.consume(a, c, d, e, f, g, h, ok, moved, n)


def beam_search(model, batch):
    finished = model(batch)
    if finished.all():  # HAZARD[HOST-SYNC] early-exit read inside a step program
        return finished
    return finished


def cold_helper(x):
    return x.item()  # control: not a hot region


def drive_waived(model, batches):
    for b in batches:
        # firacheck: allow[HOST-SYNC] SILENCED planted twin - the waiver must swallow exactly this rule on this line
        v = model(b).item()
        model.consume(v)


def drive_wrong_waiver(model, batches):
    for b in batches:
        v = int(b)  # firacheck: allow[DISCARDED-AT] HAZARD[HOST-SYNC] a DISCARDED-AT waiver must NOT silence HOST-SYNC
        model.consume(v)


# --- RETRACE: a program built in a loop or a hot region -------------------

def compile_in_loop(fn, batches):
    outs = []
    for b in batches:
        step = torch.compile(fn)  # HAZARD[RETRACE] fresh compile per iteration
        outs.append(step(b))
    return outs


def beam_search_cached(model, batch):
    with torch.cuda.graph(GRAPH):  # HAZARD[RETRACE] capture inside a step program
        out = model(batch)
    return out


def capture_once(fn):
    graph = torch.cuda.CUDAGraph()  # control: built once, outside loops
    step = torch.compile(fn)  # control: compiled once
    return graph, step


def compile_in_loop_waived(fn, batches):
    outs = []
    for b in batches:
        # firacheck: allow[RETRACE] SILENCED planted twin for the compile-in-loop hazard
        step = torch.compile(fn)
        outs.append(step(b))
    return outs


# --- PRNG-REUSE: draws from the process-global generator ------------------

def global_draws(x, shape):
    a = torch.rand(shape)  # HAZARD[PRNG-REUSE] no generator=
    b = torch.randint(0, 5, shape)  # HAZARD[PRNG-REUSE] no generator=
    perm = torch.randperm(8)  # HAZARD[PRNG-REUSE] no generator=
    keep = torch.bernoulli(x)  # HAZARD[PRNG-REUSE] no generator=
    x.normal_()  # HAZARD[PRNG-REUSE] in-place draw, no generator=
    np.random.shuffle(perm)  # HAZARD[PRNG-REUSE] numpy's global stream
    return a, b, keep


def seeded_draws(x, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.rand(shape, generator=gen)  # control: explicit generator
    x.normal_(generator=gen)  # control: explicit generator
    rng = np.random.default_rng(seed)  # control: builds a Generator
    perm = rng.permutation(8)  # control: draws from that Generator
    return a, perm


def global_draw_waived(shape):
    # firacheck: allow[PRNG-REUSE] SILENCED planted twin for the global-draw hazard
    return torch.randn(shape)


# --- DISCARDED-AT: an out-of-place update thrown away ---------------------

def discarded_updates(x, mask, idx, v):
    x.masked_fill(mask, 0.0)  # HAZARD[DISCARDED-AT] returns a new tensor
    x.index_put((idx,), v)  # HAZARD[DISCARDED-AT] returns a new tensor
    x.clamp(0.0, 1.0)  # HAZARD[DISCARDED-AT] returns a new tensor
    return x


def kept_updates(x, mask):
    x.masked_fill_(mask, 0.0)  # control: the in-place form
    y = x.clamp(0.0, 1.0)  # control: result assigned
    return y


# --- GEOMETRY-DRIFT (armed only under the test's virtual package path) ----

def geometry_drift(tokens):
    window = tokens[:650]  # HAZARD[GEOMETRY-DRIFT] re-typed graph_len
    msg = tokens[:30]  # HAZARD[GEOMETRY-DRIFT] re-typed tar_len
    return window, msg


def geometry_waived(tokens):
    # firacheck: allow[GEOMETRY-DRIFT] SILENCED planted twin for the literal-shape hazard
    return tokens[:210]


def geometry_ok(tokens, cfg):
    return tokens[: cfg.graph_len]  # control: named geometry referenced


# --- BAD-SUPPRESS: reason-less waiver (found by regex in the test) --------

def reasonless_waiver(x):
    # firacheck: allow[PRNG-REUSE]
    return x
