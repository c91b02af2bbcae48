"""The decoder LM of the serving path (``lm``, ``blocks``, ``layers``):
dense or with routed experts, its parameter names and shapes, random init
and weight carry-across from the JAX package (``params``), and
``build_model``.

``build_model(cfg)`` is the port's side of the JAX package's
``repro.models.build_model``: it returns :class:`~repro_torch.models.lm.DecoderLM`
for the dense family (llama3-8b, yi-34b, deepseek-coder-33b, gemma2-2b)
and for the MoE family without MLA (dbrx-132b), and raises
``NotImplementedError`` naming the slice of the port that each other
family, and MLA attention (deepseek-v3), waits for.
"""

from __future__ import annotations

from repro_torch.configs.base import AUDIO, DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models.lm import DecoderLM

#: what each family not ported yet waits for (for MoE: its configs with MLA)
WAITING = {
    MOE: "the MLA slice (deepseek-v3's multi-head latent attention)",
    VLM: "the VLM slice (the vision frontend)",
    HYBRID: "the hybrid slice (the Mamba2 SSD blocks)",
    SSM: "the SSM slice (the xLSTM blocks)",
    AUDIO: "the audio slice (the encoder and its frontend)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``: the dense
    and MoE families (routed experts, a shared expert, a dense prefix)
    without MLA."""
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention waits for {WAITING[MOE]} of the port")
    if cfg.family not in (DENSE, MOE):
        what = WAITING.get(cfg.family, "its slice")
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family waits for {what} of the port")


def build_model(cfg: ModelConfig, **kw):
    """The model of ``cfg`` (``kw`` go to its constructor, e.g. the
    attention function of :class:`~repro_torch.models.lm.DecoderLM`)."""
    check_ported(cfg)
    return DecoderLM(cfg, **kw)
