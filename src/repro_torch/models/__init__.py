"""The decoder LM of the serving path (``lm``, ``blocks``, ``layers``):
dense or with routed experts, its parameter names and shapes, random init
and weight carry-across from the JAX package (``params``), and
``build_model``.

``build_model(cfg)`` is the port's side of the JAX package's
``repro.models.build_model``: it returns :class:`~repro_torch.models.lm.DecoderLM`
for the dense family (llama3-8b, yi-34b, deepseek-coder-33b, gemma2-2b),
for the MoE family (dbrx-132b, and deepseek-v3-671b with its MLA
attention) and for the VLM family (internvl2-2b: the decoder with
precomputed patch embeddings before the tokens), and raises
``NotImplementedError`` naming the slice of the port that each other
family waits for. ``check_trainable`` takes what
``build_model`` takes: every ported config is trained too, deepseek-v3's
MLA attention included (its expanded form's backward on the tensor cores
at q/k 192, v 128 in bf16, and on the CUDA cores at the reduced config's
24/16).
"""

from __future__ import annotations

from repro_torch.configs.base import AUDIO, DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models.lm import DecoderLM

#: what each family not ported yet waits for
WAITING = {
    HYBRID: "the hybrid slice (the Mamba2 SSD blocks)",
    SSM: "the SSM slice (the xLSTM blocks)",
    AUDIO: "the audio slice (the encoder and its frontend)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port serves ``cfg``: the
    dense and MoE families (routed experts, a shared expert, a dense
    prefix, MLA attention) and the VLM family (its patches before the
    tokens)."""
    if cfg.family not in (DENSE, MOE, VLM):
        what = WAITING.get(cfg.family, "its slice")
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family waits for {what} of the port")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port trains ``cfg``: what it
    serves (:func:`check_ported`), MLA attention and the VLM's patch
    offset in the loss included, on every device."""
    check_ported(cfg)


def build_model(cfg: ModelConfig, **kw):
    """The model of ``cfg`` (``kw`` go to its constructor, e.g. the
    attention function of :class:`~repro_torch.models.lm.DecoderLM`)."""
    check_ported(cfg)
    return DecoderLM(cfg, **kw)
