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
    adjacency_impl: str = "dense"   # the port runs "dense" only
    sort_edges: bool = False        # host-side (sender, receiver) edge sort
    flat_scatter: bool = False
    encoder_buffer: str = "single"  # the port runs "single" only
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
    copy_head_remat: bool = True

    # --- decode (the port runs the cached, prob-space, fused, full-scan
    # beam: the defaults) ---
    beam_compat_prob_space: bool = True
    beam_kv_cache: bool = True
    beam_factored_topk: bool = False
    beam_early_exit: bool = False

    # --- knobs of JAX-package paths the port does not run yet (engine,
    # serving, ingest, fault injection, grouped and accumulated steps,
    # buckets, ring attention); kept so
    # configs read alike ---
    decode_engine: bool = False
    engine_slots: int = 0
    engine_prefill_depth: int = 2
    engine_harvest_every: int = 4
    engine_paged_kv: bool = True
    kv_block_size: int = 0
    kv_pool_blocks: int = 0
    decode_tar_buckets: bool = False
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
    accum_steps: int = 1
    fused_steps: int = 1
    # data/feeder.Feeder: threads assembling batches ahead of the train
    # loop, the dev gate and the test decode (0 = on the consumer thread),
    # and the most batches in flight
    feeder_workers: int = 2
    feeder_depth: int = 4
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


# knob -> the value of the one path the port runs
_PORTED_PATH = {
    "adjacency_impl": "dense",
    "flat_scatter": False,
    "encoder_buffer": "single",
    "beam_compat_prob_space": True,
    "beam_kv_cache": True,
    "beam_factored_topk": False,
    "beam_early_exit": False,
    "decode_engine": False,
    "typed_edges": False,
    "buckets": (),
    "kv_dtype": "f32",
    "serve_precision": "f32",
    "spec_decode": "off",
}


COMPUTE_DTYPES = ("float32", "bfloat16")


def unsupported(cfg: FiraConfig) -> List[str]:
    """Knobs set to a path the port does not run, or to a value no path
    takes, one message each."""
    errs = [f"{k}={getattr(cfg, k)!r} (the port runs {v!r} only)"
            for k, v in _PORTED_PATH.items() if getattr(cfg, k) != v]
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        errs.append(f"compute_dtype={cfg.compute_dtype!r} (choose from "
                    f"{', '.join(COMPUTE_DTYPES)})")
    if cfg.feeder_workers < 0:
        errs.append(f"feeder_workers={cfg.feeder_workers} (must be >= 0; "
                    f"0 assembles batches on the consumer thread)")
    if cfg.feeder_depth < 1:
        errs.append(f"feeder_depth={cfg.feeder_depth} (must be >= 1)")
    if cfg.seq_shards > 1:
        errs.append(f"seq_shards={cfg.seq_shards} (the port runs dense "
                    f"cross-attention only)")
    for knob in ("accum_steps", "fused_steps"):
        if getattr(cfg, knob) != 1:
            errs.append(f"{knob}={getattr(cfg, knob)} (the port runs one "
                        f"optimizer step per batch only)")
    return errs
