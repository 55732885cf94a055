"""Config system of the PyTorch port: the same frozen dataclasses as the
JAX package's ``repro.configs.base``, kept as the port's own copy so that
``repro_torch`` never imports ``repro``.

Every architecture is described by a :class:`ModelConfig`; the runtime
knobs live in :class:`RunConfig`.  Configs are frozen dataclasses so they
are hashable (usable as cache keys).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned arch."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # --- attention flavour ---
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None      # local-attention window size
    # layer pattern: "global" (all global attn), "local_global" (alternating,
    # gemma2-style), "griffin" (rec,rec,local-attn groups), "mamba" (all ssm)
    layer_pattern: str = "global"
    post_norms: bool = False                  # gemma2 post-layer norms

    # --- SSM (mamba1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0                      # 0 -> d_model // 16

    # --- RG-LRU (griffin / recurrentgemma) ---
    lru_width: int = 0                        # 0 -> d_model
    conv1d_width: int = 4

    # --- encoder-decoder ---
    n_enc_layers: int = 0                     # >0 => enc-dec model

    # --- modality frontend stubs (per spec: precomputed embeddings) ---
    frontend: Optional[str] = None            # None | "vision_stub" | "audio_stub"
    n_patches: int = 576                      # vision stub: patch tokens per image
    audio_downsample: int = 8                 # audio stub: frames = seq // ds

    # --- embeddings ---
    tie_embeddings: bool = True
    emb_scale_by_dim: bool = False            # gemma-style sqrt(d) embed scaling

    # --- numerics ---
    dtype: str = "bfloat16"                   # compute dtype
    param_dtype: str = "float32"              # master params
    rms_eps: float = 1e-6

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_kv_heads == 0 and self.n_heads:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.ssm_dt_rank == 0 and self.family == "ssm":
            object.__setattr__(self, "ssm_dt_rank", max(1, self.d_model // 16))
        if self.lru_width == 0 and self.family == "hybrid":
            object.__setattr__(self, "lru_width", self.d_model)

    # -- derived quantities ------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 so the vocab dim is
        shardable over any mesh axis (standard practice; ids >= vocab_size
        are never emitted by the pipeline)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def gqa_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        H, KV, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        mlp = 3 * D * F
        if self.family == "moe":
            mlp = self.n_experts * 3 * D * F + D * self.n_experts
        if self.family == "ssm":
            Di, N, R = self.d_inner, self.ssm_state, self.ssm_dt_rank
            per = (D * 2 * Di + self.ssm_conv * Di + Di          # in_proj, conv
                   + Di * (R + 2 * N) + R * Di + Di              # x_proj, dt_proj
                   + Di * N + Di                                 # A_log, D
                   + Di * D + D)                                 # out_proj, norm
            return n + L * per + D
        if self.family == "hybrid":
            Dr = self.lru_width
            rec = (2 * D * Dr + self.conv1d_width * Dr + Dr      # in projs + conv
                   + 2 * Dr + Dr * Dr // 8 * 0                   # lru params (a, gates)
                   + 2 * (Dr * Dr) // max(1, Dr // Dr)           # gates (approx)
                   + Dr * D)
            # griffin pattern: 1/3 layers are local attention
            n_attn = L // 3
            n_rec = L - n_attn
            return (n + n_rec * (rec + mlp + 2 * D)
                    + n_attn * (attn + mlp + 2 * D) + D)
        per_layer = attn + mlp + 2 * D * (2 if self.post_norms else 1)
        total_layers = L + self.n_enc_layers
        if self.n_enc_layers:
            per_dec = per_layer + attn + D  # + cross attention
            n += self.n_enc_layers * per_layer + L * per_dec
            return n + 2 * D
        return n + L * per_layer + D

    def active_param_count(self) -> int:
        """Params touched per token (MoE uses experts_per_token)."""
        if self.family != "moe":
            return self.param_count()
        D, F, L = self.d_model, self.d_ff, self.n_layers
        dense = self.param_count() - L * self.n_experts * 3 * D * F
        return dense + L * self.experts_per_token * 3 * D * F


# ---------------------------------------------------------------------------
# Input shapes (the 4 assigned shape cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def cache_len(self) -> int:
        return self.seq_len


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Run / parallelism configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ACESyncConfig:
    """Paper hyper-parameters (eqs. 3-9) + level ladder."""
    enabled: bool = True
    alpha: float = 0.5                 # eq (3) temporal/structural mix
    gamma: float = 1.0                 # eq (7) error-feedback strength
    beta: float = 0.02                 # eq (5) bandwidth->compression slope
    c_min: float = 0.01                # eq (5) min compression ratio kept
    c_max: float = 1.0                 # eq (5) max ratio kept (1.0 = full)
    topk_block: int = 1024             # kernel block for blockwise top-k
    replan_every: int = 100            # host-side knapsack cadence (steps)
    sync_interval_init: int = 4        # H: local steps per cross-pod sync
    sync_interval_max: int = 64
    div_low: float = 0.05              # eq (9) thresholds (relative)
    div_high: float = 0.25
    importance_hidden: int = 32        # attention estimator width
    importance_lr: float = 1e-3
    n_clusters: int = 4                # device clustering
    # two-tier exchange on hierarchical meshes (core/planexec.py):
    # 0 = roofline auto-picks the intra stage per rung, -1 = force flat,
    # 1/2 = force full-precision / INT8 intra aggregation (tests, benches)
    hier_mode: int = 0
    # ClusterState hysteresis: a device only migrates clusters when the
    # new centroid is at least this fraction closer than its current one
    # (repro/hierarchy — keeps assignments from flapping under jitter)
    cluster_hysteresis: float = 0.15
    # padded-size ladder of the retrace-free exchange (core/planexec.py):
    # adaptive plans round per-rung bucket sizes up to geometric classes so
    # steady-state replans reuse the compiled step.  Growth 2.0 = power-of-
    # two classes (fewest recompiles, up to 2x wire padding); 1.125 bounds
    # padding at 12.5%; 1.0 = exact sizes (every bucket-size change
    # recompiles).
    # base growth of the per-rung pad schedule (planexec.rung_growth):
    # big rungs take finer classes than this, tiny rungs coarser ones.
    bucket_pad_growth: float = 1.125
    # chunked ring exchange (planexec.ring_chunk_count): 0 = roofline
    # auto (ring DCN-bound rungs, one-shot all_gather otherwise),
    # -1 = force the one-shot path everywhere, K > 0 = force K chunks on
    # every ring-capable rung (benches/tests).
    ring_chunks: int = 0
    # bidirectional ring: circulate both DCN directions at once (two
    # half-rings of ceil((P-1)/2) hops — same ppermute count and wire
    # bytes, ~2x effective link bandwidth on full-duplex links).  False =
    # the single forward ring (benches compare the two).
    ring_bidir: bool = True
    # fractional bits of the deterministic fixed-point accumulation used
    # whenever >= 3 pods exchange (ring or one-shot): terms quantise to
    # round(x * 2^accum_bits) int32 and fold in exact integer arithmetic,
    # so per-pod aggregates are bit-identical in any fold order.  16 bits
    # = 2^-16 ABSOLUTE resolution over a +-2^15 aggregate range —
    # negligible next to the wire formats' own quantisation at unit
    # gradient scale, but terms below ~2^-17 round to zero: raise this
    # (e.g. 24 -> 6e-8 resolution, +-2^7 range) for regimes whose
    # gradients shrink far below unit scale.
    accum_bits: int = 16
    # rung-ordered optimizer apply: grad_sync applies AdamW to each
    # rung's bucket as soon as that rung's exchange lands instead of
    # barriering on the whole tree (core/sync.py apply_fn path).
    overlap_apply: bool = True
    # backward-interleaved sync: split the exchange into per-segment
    # pieces whose packs depend only on that segment's leaves, so each
    # piece's encode+collective issues as soon as the backward pass has
    # produced that leaf range's gradients instead of barriering on the
    # full grad tree (core/planexec.py segment schedule + core/sync.py
    # streaming path).  Bit-identical to the barriered exchange — every
    # codec is blockwise, so piece splitting never moves the numerics.
    overlap_backward: bool = True
    # number of backward segments: 0 = auto (planexec.auto_segments —
    # 2 on multi-leaf models), 1 = barriered (the pre-segmentation
    # exchange), K > 1 = force K segments.
    backward_segments: int = 0
    # level ladder: (name, keep_ratio, value_bits) - SKIP transmits nothing.
    # Each rung resolves to a registered repro/codecs wire format by
    # semantics: dense 8/4/1-bit -> int8 / packed int4 / sign-majority-vote.
    levels: Tuple[Tuple[str, float, int], ...] = (
        ("FULL", 1.0, 16),
        ("INT8", 1.0, 8),
        ("INT4", 1.0, 4),
        ("TOPK25_INT8", 0.25, 8),
        ("TOPK10_INT8", 0.10, 8),
        ("SIGN1", 1.0, 1),
        ("TOPK1_INT8", 0.01, 8),
        ("SKIP", 0.0, 0),
    )


def default_ckpt_dir() -> str:
    """``repro_ckpt`` in the temporary directory (``tempfile.gettempdir``:
    ``$TMPDIR``, else ``/tmp``)."""
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    multi_pod: bool = False
    # optimizer
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    # memory policy
    remat: str = "minimal"             # none | minimal | full
    # attention chunking
    q_chunk: int = 2048
    kv_chunk: int = 1024
    # ACE-Sync
    acesync: ACESyncConfig = field(default_factory=ACESyncConfig)
    # checkpointing (the reference's /tmp/repro_ckpt where the temporary
    # directory is /tmp; under $TMPDIR where that is set)
    ckpt_every: int = 200
    ckpt_dir: str = field(default_factory=default_ckpt_dir)
    seed: int = 0
    # deterministic kernels on the card (the port's own switch; the
    # reference's XLA replays without one): TrainSession sets
    # torch.use_deterministic_algorithms(True) and, where unset,
    # CUBLAS_WORKSPACE_CONFIG=:4096:8 before the model touches the card,
    # so that a restart replays the uninterrupted run bit for bit
    deterministic: bool = False

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
