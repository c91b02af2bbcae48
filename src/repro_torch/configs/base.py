"""Model configuration schema for the assigned architecture pool.

One ``ModelConfig`` fully determines a model: the family dispatches to the
right block implementation in ``repro_torch.models``; the numeric fields are the
exact published configs (sources in each ``configs/<id>.py``).

``reduced()`` produces a tiny same-family config for CPU smoke tests; the
full configs are only ever lowered via ShapeDtypeStructs in the dry-run.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# Families (dispatch keys for repro.models)
DENSE = "dense"
MOE = "moe"
HYBRID = "hybrid"  # Mamba2 + shared attention (zamba2)
SSM = "ssm"  # xLSTM
AUDIO = "audio"  # encoder-only transformer, audio frontend stub
VLM = "vlm"  # decoder LM + vision frontend stub


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    num_shared: int = 0  # always-on shared experts (deepseek-v3: 1)
    #: layers [0, first_dense) use a dense FFN instead of MoE (deepseek-v3: 3)
    first_dense: int = 0
    d_ff_dense: int = 0  # hidden size of those dense layers
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (deepseek-v3, arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block parameters."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # SSD head size P
    chunk: int = 256  # SSD chunk length for the training-time scan
    #: hybrid (zamba2): apply the shared attention block every k SSM blocks
    shared_block_every: int = 6


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM (arXiv:2405.04517): alternating mLSTM / sLSTM blocks."""

    proj_factor: float = 2.0  # mLSTM up-projection factor
    slstm_every: int = 2  # every k-th block is sLSTM (rest mLSTM)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # attention extras
    rope_theta: float = 10000.0
    sliding_window: int = 0  # gemma2 local layers / zamba2 long mode
    alt_local_global: bool = False  # gemma2: even layers local, odd global
    attn_softcap: float = 0.0  # gemma2: 50.0
    logit_softcap: float = 0.0  # gemma2: 30.0
    encoder_only: bool = False  # hubert: bidirectional, no decode
    tie_embeddings: bool = False
    # frontend stubs (per task spec: modality frontends are precomputed)
    frontend: str = "none"  # "none" | "audio" | "vision"
    frontend_dim: int = 0  # audio frame feature dim
    num_patches: int = 0  # vision patch count prepended to the text seq
    # family sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # bookkeeping
    source: str = ""  # provenance tag from the assignment table

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    # -- parameter counting (for MODEL_FLOPS = 6*N*D roofline terms) --------

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        return _count_params(self, active_only=True)

    # -- reductions for smoke tests -----------------------------------------

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: small widths, few layers/experts, small
        vocab. Keeps every structural feature (GQA ratio, MoE, MLA, softcaps,
        alternating windows, SSM, frontend stubs) so the smoke test exercises
        the same code path as the full config."""
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        if heads % kv:
            kv = 1
        layers = min(self.num_layers, 4)
        if self.family == HYBRID and self.ssm is not None:
            # keep >= one shared-block hit
            layers = max(layers, min(self.ssm.shared_block_every + 1, 4))
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 8),
                top_k=min(self.moe.top_k, 2),
                d_expert=64,
                d_ff_dense=128 if self.moe.first_dense else 0,
                first_dense=min(self.moe.first_dense, 1),
            )
        mla = None
        if self.mla is not None:
            mla = MLAConfig(
                q_lora_rank=32,
                kv_lora_rank=16,
                qk_nope_head_dim=16,
                qk_rope_head_dim=8,
                v_head_dim=16,
            )
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=16, shared_block_every=2
            )
        return dataclasses.replace(
            self,
            name=f"{self.name}-smoke",
            num_layers=layers,
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16 if self.head_dim else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            sliding_window=8 if self.sliding_window else 0,
            frontend_dim=32 if self.frontend == "audio" else 0,
            num_patches=4 if self.frontend == "vision" else 0,
            moe=moe,
            mla=mla,
            ssm=ssm,
        )


def _count_params(cfg: ModelConfig, *, active_only: bool) -> int:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    n = 0
    # embeddings (+ untied output head)
    n += cfg.vocab * d
    if not cfg.encoder_only and not cfg.tie_embeddings:
        n += cfg.vocab * d
    if cfg.frontend == "audio":
        n += cfg.frontend_dim * d
    per_layer = 0
    # attention
    if cfg.mla is not None:
        m = cfg.mla
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        per_attn = (
            d * m.q_lora_rank
            + m.q_lora_rank * cfg.num_heads * qk_head
            + d * (m.kv_lora_rank + m.qk_rope_head_dim)
            + m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            + cfg.num_heads * m.v_head_dim * d
        )
    else:
        per_attn = (
            d * cfg.num_heads * hd
            + 2 * d * cfg.num_kv_heads * hd
            + cfg.num_heads * hd * d
        )
    # ffn
    def swiglu(h: int) -> int:
        return 3 * d * h

    if cfg.family == SSM and cfg.xlstm is not None:
        d_in = int(d * cfg.xlstm.proj_factor)
        # mLSTM block: up/gate/down projections + qkv + gates
        per_layer = 2 * d * d_in + d_in * d + 3 * d * d_in + 3 * d_in
        n += cfg.num_layers * per_layer
        return n
    if cfg.family == HYBRID and cfg.ssm is not None:
        s = cfg.ssm
        d_in = s.expand * d
        nheads = d_in // s.head_dim
        # in_proj produces (z, x, B, C, dt): d -> 2*d_in + 2*d_state + nheads
        per_ssm = d * (2 * d_in + 2 * s.d_state + nheads) + d_in * d + d_in * s.d_conv
        # one shared attention+MLP block, reused across the depth (zamba2)
        shared = per_attn + swiglu(cfg.d_ff)
        n += cfg.num_layers * per_ssm + shared
        return n
    ffn = 0
    if cfg.moe is not None:
        mo = cfg.moe
        router = d * mo.num_experts
        experts = mo.top_k if active_only else mo.num_experts
        moe_layers = cfg.num_layers - mo.first_dense
        n += moe_layers * (router + experts * swiglu(mo.d_expert) + mo.num_shared * swiglu(mo.d_expert))
        n += mo.first_dense * swiglu(mo.d_ff_dense)
        n += cfg.num_layers * per_attn
        return n
    ffn = swiglu(cfg.d_ff) if cfg.d_ff else 0
    if cfg.encoder_only:
        ffn = 2 * d * cfg.d_ff  # standard (non-gated) MLP in hubert/w2v2
    n += cfg.num_layers * (per_attn + ffn)
    return n


# ---------------------------------------------------------------------------
# Input-shape grid (LM-family: seq_len x global_batch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524_288, 1, "decode"),
}

#: sub-quadratic families allowed to run long_500k (task spec)
LONG_OK_FAMILIES = (HYBRID, SSM)


def live_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The live cells of the 4-shape grid for one arch (skips per DESIGN.md
    4 'Shape-grid skips')."""
    out = ["train_4k", "prefill_32k"]
    if not cfg.encoder_only:
        out.append("decode_32k")
        if cfg.family in LONG_OK_FAMILIES:
            out.append("long_500k")
    return tuple(out)
