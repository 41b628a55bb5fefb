"""Speculative copy-head draft-and-verify decode for the slot engine
(counterpart of ``fira_tpu/decode/spec.py``).

The slot engine (decode/engine.py) runs one step dispatch per beam
position and round, and on the card that dispatch cadence is the serving
ceiling (the host issues, the card idles). FIRA's copy head makes commit
messages unusually draftable: much of a message is copied verbatim from
the diff. So a cheap drafter proposes ``k`` tokens a live slot, and one
verify dispatch advances up to k beam positions, accepting the longest
drafted prefix the real beam math agrees with (Leviathan et al., ICML
2023; Chen et al. 2023).

Exact by construction. The verify runs the engine's own ``_one_step``,
gated per row: frame 0 advances every live slot (exactly the plain step),
frame j+1 advances only the rows whose frame-j top-beam token
(beam.top_beam_token) equalled ``drafts[:, j]``. Every position the
verify advances ran the plain step's math, and every position it did not
is run by a later dispatch, so tokens, scores and the output file do not
depend on k, the acceptance pattern, the harvest cadence or the replica
count (tests/test_torch_spec.py holds them to the JAX engine's). A frozen
row's state is blended back (the plain step's inactive-row rule), its
paged table rows address the scratch block (no append, no permute) and its
unpaged cache rows take the identity permutation (engine._one_step's gated
branch): the one place the plain step's scribble on inactive rows would
corrupt a row that resumes.

The loop. The JAX package's verify is a ``lax.while_loop`` whose condition
reads the device. Here it is a Python loop of at most k frames that reads
that condition, any gated live row, before each frame (one host read a
frame, the batched beam's early exit's discipline, beam._run_steps). The
predicate is monotone (a frozen row never resumes inside one verify), so
stopping at the first false read is the while loop exactly: ``iters``
(``spec_frames``), ``tested``, ``matched`` and the state equal the JAX
package's, and a verify launches the kernels of ``iters`` plain
micro-steps, K1 among them once a frame, and no more. The tested and
matched counters stay on the device and ride back with the harvest's
done-mask read, so spec metering adds no host read beyond the loop's own.

Drafter tiers (``cfg.spec_decode``):

- ``copy``: the copy-head distribution alone, pointer scores from the
  cached source projections of each slot's beam-0 row against the raw
  target embedding (``FiraModel.copy_draft_scores``: embedding and
  position row, no decoder layer). K1 launches once a drafted token at
  (S, 1, S_src, D).
- ``draft``: a greedy argmax roll of the cached step on each slot's top
  beam only, against scratch copies of the beam-0 caches (the paged arena
  gathers the beam-0 lane dense, ``layers.gather_block_kv_beam``; the
  arena itself is never written by a drafter). K1 launches once a drafted
  token at (S, 1, S_src, D).

Both emit resolved vocabulary ids (``beam._resolve_copy``, the id space
the beam stores), so drafted and emitted tokens compare as plain ints.
The beam-0 rows (``src_proj[0::K]`` and the cross K/V lanes) are made
contiguous once a draft dispatch.

The low-precision tiers (decode/quant.py) compose with no code here: the
drafter runs on the engine's decode-side module, inside the engine's
dispatch-level dequantization; the unpaged scratch caches keep the arena's
storage type (``Decoder.decode_step_multi`` upcasts on read) and the paged
gather upcasts.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from fira_tpu_torch.config import FiraConfig
from fira_tpu_torch.decode import paging
from fira_tpu_torch.decode.beam import (_resolve_copy, scatter_token,
                                        step_valid_mask, top_beam_token)
from fira_tpu_torch.model.layers import gather_block_kv_beam

DRAFT_LABEL = "engine_draft"
VERIFY_LABEL = "engine_verify"

SPEC_TIERS = ("off", "copy", "draft")

# plain step dispatches run after a verify whose drafts all missed, before
# drafting again: a stalled drafter (a rare-token span) should not pay a
# draft and a verify a token. Scheduling only: the output does not depend
# on it.
STALL_COOLDOWN = 4


def spec_errors(cfg: FiraConfig) -> List[str]:
    """Parse-time validation of the speculative-decode knobs, in the JAX
    package's words: the tier name; spec needs the slot engine; and
    ``engine_spec_k`` must fit the smallest declared decode tar budget,
    1 <= k <= min(tar) - 1."""
    errs: List[str] = []
    if cfg.spec_decode not in SPEC_TIERS:
        errs.append(
            f"spec_decode {cfg.spec_decode!r} not in {set(SPEC_TIERS)}")
        return errs
    if cfg.spec_decode == "off":
        return errs
    if not cfg.decode_engine:
        errs.append(
            f"spec_decode={cfg.spec_decode!r} requires decode_engine: the "
            f"drafter/verify programs extend the slot engine's program "
            f"family (enable decode_engine or set spec_decode='off')")
    k = int(cfg.engine_spec_k)
    budget = min(paging.declared_decode_tars(cfg)) - 1
    if not 1 <= k <= budget:
        errs.append(
            f"engine_spec_k {k} outside [1, {budget}]: the verify window "
            f"must fit the smallest declared decode tar budget "
            f"({budget + 1} positions, decode_tar_buckets/tar_len) minus "
            f"the <start> column")
    return errs


def copy_biased_params(state_dict, delta: float = 6.0,
                       target_blind: bool = False):
    """A copy of ``state_dict`` whose generate/copy gate leans hard toward
    copying (gate bias -delta on the generate side, +delta on the copy
    side), so decoding emits mostly copied source tokens: the regime the
    ``copy`` drafter is for (the ``beam.eos_biased`` convention).
    ``target_blind``: also zero the copy head's target projection, so the
    pointer scores depend on the source projection alone; the drafter's
    raw-embedding proxy then scores exactly what the step scores, and the
    copy tier's acceptance saturates."""
    out = {k: v.clone() for k, v in state_dict.items()}
    bias = out["copy_net.gate.bias"]
    bias[0] -= delta
    bias[1] += delta
    if target_blind:
        out["copy_net.tgt_proj.weight"].zero_()
    return out


def make_drafter(model, cfg: FiraConfig, slots: int, paged: bool
                 ) -> Callable[[dict], torch.Tensor]:
    """The drafter of this engine's tier and arena: ``drafter(state)`` ->
    (S, k) resolved ids. It reads the arena and writes nothing of it (the
    ``draft`` tier's scratch caches are its own). ``model`` is the
    engine's decode-side module."""
    K, T = cfg.beam_size, cfg.tar_len
    L, H = cfg.num_layers, cfg.num_head
    d_head = cfg.embedding_dim // H
    V = cfg.vocab_size
    k = int(cfg.engine_spec_k)
    tier = cfg.spec_decode

    def resolve(choice, state):
        """Fused-space choice -> the resolved vocabulary id."""
        return _resolve_copy(choice[:, None], state["diff"],
                             state["sub_token"], cfg)[:, 0]

    def start(state):
        """Each slot's top beam (a scratch copy), its clamped position and
        its token there."""
        pos0 = state["pos"].clamp(max=T - 2)
        flat0 = state["tokens"][:, 0, :].clone()     # (S, T)
        return flat0, pos0, flat0.gather(1, pos0[:, None])[:, 0]

    if tier == "copy":

        def drafter(state):
            if cfg.beam_kv_cache:
                src_proj0 = state["src_proj"][0::K].contiguous()
            else:
                # the full-prefix arena holds encoder states: project the
                # beam-0 rows (one matmul, still no decoder layer)
                src_proj0 = model.copy_net.project_src(
                    state["states"][0::K])
            mask = state["src_mask"]
            _flat, p, tok = start(state)
            drafts = []
            for _ in range(k):
                scores = model.copy_draft_scores(mask, src_proj0,
                                                 tok[:, None], p)
                choice = V + scores[:, 0, :].argmax(-1)
                tok = resolve(choice, state)
                p = (p + 1).clamp(max=T - 2)
                drafts.append(tok)
            return torch.stack(drafts, dim=1)

        return drafter

    assert tier == "draft", tier

    if not cfg.beam_kv_cache:

        def drafter(state):
            states0 = state["states"][0::K].contiguous()
            mask = state["src_mask"]
            flat, p, _tok = start(state)
            rows = torch.arange(flat.shape[0], device=flat.device)
            drafts = []
            for _ in range(k):
                tar_mask = flat != 0
                tar_mask[:, 0] = True
                fused = model.fused_probs(states0, mask, flat, tar_mask)
                nxt = resolve(fused[rows, p].argmax(-1), state)
                p = (p + 1).clamp(max=T - 2)
                flat = scatter_token(flat, p, nxt)
                drafts.append(nxt)
            return torch.stack(drafts, dim=1)

        return drafter

    def drafter(state):
        mask = state["src_mask"]
        cross_k0 = state["cross_k"][:, 0::K].contiguous()
        cross_v0 = state["cross_v"][:, 0::K].contiguous()
        src_proj0 = state["src_proj"][0::K].contiguous()
        if paged:
            # a dense scratch view of each slot's beam-0 lane, in the
            # stable dtype; idle and settled slots' rows may name stale
            # blocks: garbage their drafts, which the verify masks out
            tab = state["block_tab"]
            k_sc = torch.stack([gather_block_kv_beam(state["k_pool"][i],
                                                     tab, 0)
                                for i in range(L)])
            v_sc = torch.stack([gather_block_kv_beam(state["v_pool"][i],
                                                     tab, 0)
                                for i in range(L)])
        else:
            S = state["pos"].shape[0]
            k_sc = state["k_cache"].reshape(L, S, K, H, T, d_head)[
                :, :, 0].clone()
            v_sc = state["v_cache"].reshape(L, S, K, H, T, d_head)[
                :, :, 0].clone()
        flat, p, _tok = start(state)
        drafts = []
        for _ in range(k):
            valid = step_valid_mask(flat, p, T)
            tok_in = flat.gather(1, p[:, None])
            fused, k_sc, v_sc = model.fused_probs_step_multi(
                mask, tok_in, p, k_sc, v_sc, cross_k0, cross_v0, src_proj0,
                valid[:, None, None, :])
            nxt = resolve(fused[:, 0, :].argmax(-1), state)
            p = (p + 1).clamp(max=T - 2)
            flat = scatter_token(flat, p, nxt)
            drafts.append(nxt)
        return torch.stack(drafts, dim=1)

    return drafter


def run_verify(step_gated, state, drafts, k: int, tar_len: int, read):
    """The draft-and-verify acceptance loop: up to ``k`` gated exact step
    frames.

    ``step_gated(gate)`` is the engine's ``_one_step`` on ``state`` (which
    it updates in place), returning the count of rows it advanced.
    ``read(flag)`` reads a device flag to the host. Before each frame the
    loop reads whether any live, unsettled row is still gated in; frame 0
    runs every live row (the gate starts all True: a verify never does
    less than a plain step), frame j+1 only rows whose frame-j top-beam
    token equalled ``drafts[:, j]``. A fully missed draft costs exactly
    one plain frame.

    Returns (occ_entry, counters, iters): the live rows at entry (the
    occupancy a verify dispatch owes), a device vector [tested, matched]
    (row-frames advanced, drafted tokens matched) and the frames run."""
    S = drafts.shape[0]
    dev = drafts.device
    occ_entry = (state["live"] & ~state["done"]).sum()
    gate = torch.ones(S, dtype=torch.bool, device=dev)
    tested = torch.zeros((), dtype=torch.long, device=dev)
    matched = torch.zeros((), dtype=torch.long, device=dev)
    iters = 0
    while iters < k:
        act = state["live"] & ~state["done"] & gate
        # firacheck: allow[HOST-SYNC] the verify loop's per-frame predicate read (one sync a frame, counted in host_syncs), where the JAX package's verify loop runs on the device; a CUDA-graph verify (ROADMAP.md A.5) must keep it there
        if not read(act.any()):
            break
        pos_c = state["pos"].clamp(max=tar_len - 2)
        occ = step_gated(gate)
        emitted = top_beam_token(state["tokens"], pos_c + 1)
        match = act & (emitted == drafts[:, iters])
        # rows not stepped this frame keep their gate: their fate was
        # already decided (or they are idle or settled and act-masked)
        gate = torch.where(act, match, gate)
        tested = tested + occ
        matched = matched + match.sum()
        iters += 1
    return occ_entry, torch.stack([tested, matched]), iters
