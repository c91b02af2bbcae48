"""The dense decoder LM of the serving path (``lm``, ``blocks``,
``layers``), its parameter names and shapes, random init and weight
carry-across from the JAX package (``params``), and ``build_model``.

``build_model(cfg)`` is the port's side of the JAX package's
``repro.models.build_model``: it returns :class:`~repro_torch.models.lm.DecoderLM`
for the dense family (llama3-8b, yi-34b, deepseek-coder-33b, gemma2-2b)
and raises ``NotImplementedError`` naming the slice of the port that each
other family waits for.
"""

from __future__ import annotations

from repro_torch.configs.base import AUDIO, DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models.lm import DecoderLM

#: what each family that is not ported yet waits for
WAITING = {
    MOE: "the MoE slice (routed experts; deepseek-v3's MLA with it)",
    VLM: "the VLM slice (the vision frontend)",
    HYBRID: "the hybrid slice (the Mamba2 SSD blocks)",
    SSM: "the SSM slice (the xLSTM blocks)",
    AUDIO: "the audio slice (the encoder and its frontend)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``: the dense
    family without MoE or MLA."""
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: MLA attention waits for the MoE slice of the port (deepseek-v3)")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: routed experts wait for {WAITING[MOE]}")
    if cfg.family != DENSE:
        what = WAITING.get(cfg.family, "its slice")
        raise NotImplementedError(f"{cfg.name}: the {cfg.family!r} family waits for {what} of the port")


def build_model(cfg: ModelConfig, **kw):
    """The model of ``cfg`` (``kw`` go to its constructor, e.g. the
    attention function of :class:`~repro_torch.models.lm.DecoderLM`)."""
    check_ported(cfg)
    return DecoderLM(cfg, **kw)
