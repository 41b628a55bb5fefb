"""Typed configuration for the PyTorch port (counterpart of
``fira_tpu/config.py``).

``FiraConfig`` carries the same fields with the same defaults as the JAX
package's, so named configs, ablations and flags read alike in both. The
port runs a subset of the paths those knobs select; :func:`unsupported`
names every knob set to a path the port does not run, and the entry
points refuse such a config instead of quietly running something else.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class FiraConfig:
    # --- sequence geometry (reference run_model.py:31-35) ---
    sou_len: int = 210          # diff tokens incl. <start>/<eos>
    tar_len: int = 30           # message tokens incl. <start>/<eos>
    att_len: int = 25           # max sub-tokens per integral token
    ast_change_len: int = 280   # AST-type nodes + edit-op nodes
    sub_token_len: int = 160    # deduplicated sub-token nodes

    # --- model (reference run_model.py:37-39, gnn_transformer.py:41-43) ---
    embedding_dim: int = 256
    num_head: int = 8
    num_layers: int = 6         # shared by GCN stack and decoder
    dropout_rate: float = 0.1   # attention / FFN / combination dropout
    gcn_dropout_rate: float = 0.2  # GCN-layer dropout (gnn_transformer.py:43)
    ffn_mult: int = 4           # FFN hidden = 4 * d (gnn_transformer.py:166)

    # --- vocabulary (filled in from data; run_model.py:44-56) ---
    vocab_size: int = 0
    ast_change_vocab_size: int = 0

    # --- optimization (run_model.py:36,40-43,396) ---
    lr: float = 1e-4
    batch_size: int = 170
    test_batch_size: int = 20
    epochs: int = 150
    beam_size: int = 3
    seed: int = 0
    dev_start_epoch: int = 15
    dev_every_batches: int = 10

    # --- ablations (paper Table 3) ---
    use_edit: bool = True           # False => drop change nodes + change edges
    use_subtoken_copy: bool = True  # False => no sub-token copy labels/pointer span

    # --- data layout ---
    max_edges: int = 6144       # padded COO length per sample
    # "dense": one (B, N, N) scatter a batch, a bmm a GCN round;
    # "segment": A.x straight from the COO triplets (gather, scale,
    # scatter-add), O(edges)
    adjacency_impl: str = "dense"
    sort_edges: bool = False        # host-side (sender, receiver) edge sort
    flat_scatter: bool = False      # dense build as one linearized 1-D scatter
    # "single": one (B, N, d) node buffer; "split": [diff] and [sub||ast]
    # as two tensors, A.x as two column-slab bmms (dense adjacency only)
    encoder_buffer: str = "single"
    # Selects the copy head in the JAX package ("xla" or "pallas"). In the
    # port it selects nothing: ``ops.copy_score.copy_scores`` launches the
    # CUDA kernel on every CUDA tensor and runs its plain version only on
    # CPU tensors, whatever this field says.
    copy_head_impl: str = "xla"

    # --- precision: parameters, Adam state and checkpoints stay float32;
    # "bfloat16" runs the matmuls, the copy score and the stored
    # activations in bf16, with LayerNorm and the softmaxes in float32.
    # stable_residual=False also stores the post-LN residual stream in the
    # compute dtype (a no-op in float32) ---
    compute_dtype: str = "float32"
    stable_residual: bool = True
    # Selects whether the JAX package recomputes the copy head's
    # intermediate in the backward. In the port it selects nothing: K2
    # always recomputes it from the saved (src, tgt, w), whatever this
    # field says.
    copy_head_remat: bool = True

    # --- decode: the reference's probability space (False: log space),
    # the KV-cached beam (False: the full prefix re-decoded every step),
    # selection over the fused distribution (True: over the per-side top-k
    # of the unfused factors), all tar_len - 1 steps (True: stop one step
    # after every beam has finished) ---
    beam_compat_prob_space: bool = True
    beam_kv_cache: bool = True
    beam_factored_topk: bool = False
    beam_early_exit: bool = False

    # --- the slot-refill decode engine (decode/engine.py): test decodes
    # through an arena of engine_slots slots (0: test_batch_size), each
    # advanced engine_harvest_every positions a dispatch, with
    # engine_prefill_depth chunks prefilled ahead; its self-attention
    # caches paged into a pool of kv_pool_blocks (0: full residency)
    # blocks of kv_block_size positions (0: auto, decode/paging.py), or
    # whole-sequence stripes with engine_paged_kv=False.
    # decode_tar_buckets: decode buckets keep their own tar_len, which
    # caps each sample's generation in the engine ---
    decode_engine: bool = False
    engine_slots: int = 0
    engine_prefill_depth: int = 2
    engine_harvest_every: int = 4
    engine_paged_kv: bool = True
    kv_block_size: int = 0
    kv_pool_blocks: int = 0
    decode_tar_buckets: bool = False
    # --- serving (serve/server.py), the prefix cache and in-flight dedup
    # (decode/prefix_cache.py), raw-diff ingest and its fast path
    # (ingest/: ingest.service.ingest_errors checks the ingest_* knobs)
    # and degradation (robust/: fault injection, the dispatch watchdog,
    # the quarantine retries); beside them the knobs of JAX-package paths
    # the port does not run yet (fleet, recovery, spec decode, quant
    # tiers, the disaggregated tier), kept so configs read alike:
    # ``unsupported`` refuses each one that selects such a path ---
    prefix_cache: bool = False
    prefix_cache_entries: int = 256
    prefix_cache_bytes: int = 0
    engine_replicas: int = 1
    spec_decode: str = "off"
    engine_spec_k: int = 4
    kv_dtype: str = "f32"
    serve_precision: str = "f32"
    serve_rate: float = 0.0
    serve_prefill_budget: int = 1
    serve_deadline_steps: int = 0
    serve_queue_cap: int = 0
    serve_tiers: str = "off"
    prefill_workers: int = 2
    serve_artifact_budget_mb: int = 64
    ingest_workers: int = 0
    ingest_truncate: str = "clip"
    ingest_cache: bool = True
    ingest_cache_entries: int = 512
    ingest_cache_bytes: int = 0
    ingest_exec: str = "thread"
    inject_faults: str = ""
    dispatch_watchdog_s: float = 0.0
    robust_retries: int = 1
    fault_hang_s: float = 2.0
    max_respawns: int = 0
    engine_spares: int = 0
    respawn_backoff_s: float = 0.25
    typed_edges: bool = False
    # Selects the JAX package's dropout-stream generator. In the port it
    # selects nothing: dropout draws from a torch.Generator
    # (train/state.init_state), whatever this field says.
    rng_impl: str = "threefry"
    # train/loop.py: A > 1 accumulates A micro-batches of batch_size into
    # one optimizer step normalised over their summed token count
    # (train/step.accum_step; epoch tails pad to A with all-invalid
    # micro-batches). K > 1 runs K steps from one stacked copy to the
    # card (train/step.multi_step; tails of fewer than K run a step at a
    # time); the dev gate fires before a group, so pick K dividing
    # dev_every_batches. At most one of the two may exceed 1.
    accum_steps: int = 1
    fused_steps: int = 1
    # data/feeder.Feeder: threads assembling batches ahead of the train
    # loop, the dev gate and the test decode (0 = on the consumer thread),
    # and the most batches in flight
    feeder_workers: int = 2
    feeder_depth: int = 4
    # data/buckets.py: padding geometries (ast_change_len, max_edges,
    # tar_len), each at most the full values; the full geometry is the
    # implicit fallback. () = off: every batch at the full geometry.
    buckets: tuple = ()
    seq_shards: int = 0

    @property
    def graph_len(self) -> int:
        # 650 = 210 + 160 + 280 (paper §5.4 "up to 650 nodes")
        return self.sou_len + self.sub_token_len + self.ast_change_len

    @property
    def copy_len(self) -> int:
        # pointer span: diff positions + sub-token positions
        return self.sou_len + self.sub_token_len

    @property
    def output_vocab_size(self) -> int:
        # fused gen+copy distribution width (Model.py:81: 24650+210+160=25020)
        return self.vocab_size + self.sou_len + self.sub_token_len

    def replace(self, **kw) -> "FiraConfig":
        return dataclasses.replace(self, **kw)


def fira_full(**kw) -> FiraConfig:
    """Paper hyperparameters (reference run_model.py:30-46)."""
    return FiraConfig(**kw)


def fira_tiny(**kw) -> FiraConfig:
    """2-layer GNN, d=64 — CPU smoke config."""
    base = dict(
        embedding_dim=64,
        num_layers=2,
        num_head=4,
        sou_len=32,
        tar_len=12,
        att_len=6,
        ast_change_len=24,
        sub_token_len=24,
        batch_size=16,
        test_batch_size=8,
        epochs=30,
        dev_start_epoch=0,
        dev_every_batches=4,
        max_edges=512,
    )
    base.update(kw)
    return FiraConfig(**base)


def fira_large(**kw) -> FiraConfig:
    """8-layer, d=512, beam-8."""
    base = dict(
        embedding_dim=512,
        num_layers=8,
        beam_size=8,
    )
    base.update(kw)
    return FiraConfig(**base)


NAMED_CONFIGS = {
    "fira-tiny": fira_tiny,
    "fira-full": fira_full,
    "fira-large": fira_large,
}


def get_config(name: str, **kw) -> FiraConfig:
    if name not in NAMED_CONFIGS:
        raise KeyError(f"unknown config {name!r}; choose from {sorted(NAMED_CONFIGS)}")
    return NAMED_CONFIGS[name](**kw)


def apply_ablation(cfg: FiraConfig, ablation: Optional[str]) -> FiraConfig:
    """Map the paper's ablation names onto config switches.

    no_edit     -> drop edit (change) nodes and their edges (Table 3 row 2)
    no_subtoken -> drop the sub-token copy pointer span (Table 3 row 3)
    nothing     -> both (Table 3 row 4)
    """
    if ablation in (None, "", "none", "full"):
        return cfg
    if ablation == "no_edit":
        return cfg.replace(use_edit=False)
    if ablation == "no_subtoken":
        return cfg.replace(use_subtoken_copy=False)
    if ablation == "nothing":
        return cfg.replace(use_edit=False, use_subtoken_copy=False)
    raise KeyError(f"unknown ablation {ablation!r}")


# The JAX package's production knob sets (fira_tpu/config.py), which
# ``cli --perf production`` applies together. In the port ``rng_impl``
# and ``copy_head_remat`` select nothing; every other member runs.
PRODUCTION_PERF_KNOBS = {
    "rng_impl": "rbg",
    "fused_steps": 8,
    "sort_edges": True,
    "stable_residual": False,
    "copy_head_remat": False,
}

# The decode half: the KV-cached beam, factored top-k and early exit,
# decoded through the slot-refill engine (per sample bitwise equal to
# the batched beam).
DECODE_PERF_KNOBS = {
    "beam_kv_cache": True,
    "beam_factored_topk": True,
    "beam_early_exit": True,
    "decode_engine": True,
}


COMPUTE_DTYPES = ("float32", "bfloat16")
ENCODER_BUFFERS = ("single", "split")
ADJACENCY_IMPLS = ("dense", "segment")


def unsupported(cfg: FiraConfig) -> List[str]:
    """Knobs set to a path the port does not run, or to a value no path
    takes, one message each. The serving tiers are checked as the JAX
    CLI checks them (``quant_errors``, ``spec_errors``; ``disagg_errors``
    once ``serve_tiers`` leaves "off"), so a tier without the slot engine
    is refused in the JAX package's words wherever a model or an engine
    is built."""
    from fira_tpu_torch.decode.quant import quant_errors
    from fira_tpu_torch.decode.spec import spec_errors

    errs = quant_errors(cfg) + spec_errors(cfg)
    if cfg.serve_tiers != "off":
        from fira_tpu_torch.serve.disagg import disagg_errors

        errs += disagg_errors(cfg)
    # the JAX model's own refusals, in its words (fira_tpu/model/model.py)
    if cfg.encoder_buffer not in ENCODER_BUFFERS:
        errs.append(f"unknown encoder_buffer {cfg.encoder_buffer!r}; "
                    f"choose 'single' or 'split'")
    if cfg.adjacency_impl not in ADJACENCY_IMPLS:
        errs.append(f"adjacency_impl={cfg.adjacency_impl!r} not in "
                    f"{{'dense', 'segment'}}")
    elif cfg.adjacency_impl == "segment":
        if cfg.encoder_buffer == "split":
            errs.append("encoder_buffer='split' needs the dense adjacency "
                        "(its A.x runs as two column slabs); use "
                        "adjacency_impl='dense'")
        if cfg.flat_scatter:
            errs.append("flat_scatter applies to the dense adjacency "
                        "build; use adjacency_impl='dense'")
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        errs.append(f"compute_dtype={cfg.compute_dtype!r} (choose from "
                    f"{', '.join(COMPUTE_DTYPES)})")
    if cfg.feeder_workers < 0:
        errs.append(f"feeder_workers={cfg.feeder_workers} (must be >= 0; "
                    f"0 assembles batches on the consumer thread)")
    if cfg.feeder_depth < 1:
        errs.append(f"feeder_depth={cfg.feeder_depth} (must be >= 1)")
    if cfg.prefix_cache:
        from fira_tpu_torch.decode.paging import prefix_cache_errors

        errs += prefix_cache_errors(cfg)
    # the robustness knobs, every command (the watchdog also guards the
    # train loop's dev gate), in the JAX package's words; a fault site the
    # port does not wire names the ROADMAP item that brings it
    from fira_tpu_torch.robust.faults import robust_errors

    errs += robust_errors(cfg)
    for knob, least in (("engine_slots", 0), ("engine_prefill_depth", 1),
                        ("engine_harvest_every", 1)):
        if getattr(cfg, knob) < least:
            errs.append(f"{knob}={getattr(cfg, knob)} (must be >= {least})")
    # seq_shards > 1 runs ring attention under a training mesh; the
    # ranks it needs are checked where the mesh is known
    # (parallel/mesh.seq_shards_errors)
    if cfg.seq_shards < 0:
        errs.append(
            f"seq_shards {cfg.seq_shards} must be >= 0 (0/1 = dense "
            f"cross-attention, N > 1 ring-shards K/V over N devices)")
    for knob, what in (("fused_steps", "steps a stacked group"),
                       ("accum_steps", "micro-batches an optimizer step")):
        if getattr(cfg, knob) < 1:
            errs.append(f"{knob}={getattr(cfg, knob)} (must be >= 1: the "
                        f"{what}; 1 = one step a batch)")
    if cfg.fused_steps > 1 and cfg.accum_steps > 1:
        errs.append(f"fused_steps={cfg.fused_steps} and accum_steps="
                    f"{cfg.accum_steps} (mutually exclusive: one stacks "
                    f"steps, one accumulates gradients; set one to 1)")
    return errs
