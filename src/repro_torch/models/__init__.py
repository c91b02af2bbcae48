"""The decoder LM of the serving path, the audio encoder, the hybrid LM
and the xLSTM LM (``lm``, ``blocks``, ``layers``, ``ssd``,
``xlstm_blocks``): dense or with routed experts, their parameter names and
shapes, random init and weight carry-across from the JAX package
(``params``), and ``build_model``.

``build_model(cfg)`` is the port's side of the JAX package's
``repro.models.build_model``: it returns :class:`~repro_torch.models.lm.DecoderLM`
for the dense family (llama3-8b, yi-34b, deepseek-coder-33b, gemma2-2b),
for the MoE family (dbrx-132b, and deepseek-v3-671b with its MLA
attention) and for the VLM family (internvl2-2b: the decoder with
precomputed patch embeddings before the tokens),
:class:`~repro_torch.models.lm.EncoderLM` for the audio family
(hubert-xlarge: a bidirectional encoder over precomputed frames, head_dim
80), :class:`~repro_torch.models.lm.HybridLM` for the hybrid family
(zamba2-2.7b: Mamba2 SSD blocks and a shared attention block at head_dim
80, with a ring-buffer window cache for decode) and
:class:`~repro_torch.models.lm.XLSTMLM` for the SSM family (xlstm-350m:
mLSTM and sLSTM blocks), and raises ``ValueError`` for a family it does not
know, as the JAX one does. ``check_trainable`` takes what ``build_model``
takes: every config of the registry is served and trained, deepseek-v3's
MLA attention included (its expanded form's backward on the tensor cores
at q/k 192, v 128 in bf16, and on the CUDA cores at the reduced config's
24/16), hubert's masked prediction, the hybrid's LM loss (its Mamba2
blocks recomputed in the backward) and the xLSTM's.
"""

from __future__ import annotations

from repro_torch.configs.base import AUDIO, DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models.lm import DecoderLM, EncoderLM, HybridLM, XLSTMLM

#: the families the port runs
FAMILIES = (DENSE, MOE, VLM, AUDIO, HYBRID, SSM)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless ``cfg``'s family is one the port runs:
    the dense and MoE families (routed experts, a shared expert, a dense
    prefix, MLA attention), the VLM family (its patches before the tokens),
    the audio family (the encoder; it has no decode path, so
    ``launch.serve`` refuses it as the JAX package's does), the hybrid
    family (Mamba2 blocks and a shared attention block) and the SSM family
    (the xLSTM blocks): every family of the registry."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless the port trains ``cfg``: what it runs
    (:func:`check_ported`), MLA attention, the VLM's patch offset in the
    loss and the encoder's masked prediction included, on every device."""
    check_ported(cfg)


def build_model(cfg: ModelConfig, **kw):
    """The model of ``cfg`` by its family, as the JAX package's
    ``build_model`` (``kw`` go to its constructor, e.g. the attention
    function of :class:`~repro_torch.models.lm.DecoderLM`,
    :class:`~repro_torch.models.lm.EncoderLM` or
    :class:`~repro_torch.models.lm.HybridLM`, the mLSTM form of
    :class:`~repro_torch.models.lm.XLSTMLM`)."""
    check_ported(cfg)
    if cfg.family == HYBRID:
        return HybridLM(cfg, **kw)
    if cfg.family == SSM:
        return XLSTMLM(cfg, **kw)
    return EncoderLM(cfg, **kw) if cfg.encoder_only else DecoderLM(cfg, **kw)
