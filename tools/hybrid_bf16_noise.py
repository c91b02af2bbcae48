#!/usr/bin/env python3
"""How far bf16 rounding alone moves the hybrid's logits and gradients.

A zamba2-2.7b narrowed to d_model 256 (4 heads of 64, SSD state 64 and
heads of 64, chunk 256 as published, d_ff 512, vocab 2048) at 6, 18 and
54 layers, random weights from a seed, the plain attention throughout, on
the host's CPU: no kernel runs. For each depth it prints one JSON line:

- ``served_vs_forward``: the logits of a served round (prefill of 260
  tokens, then 39 one-token decode steps: the chunked scan, then the
  one-step recurrence) against a teacher-forced forward of the same
  tokens (the chunked scan over all 300), in bf16 and in f32 (the same
  weights cast up);
- ``bf16_vs_f32``: the served round's and the forward's logits in bf16
  against the same in f32;
- ``p_in_bf16``: a served round whose attention rounds P to bf16 before
  P V (as the tensor-core forward does) against one with the plain
  attention, both in bf16: what an attention kernel's rounding alone does
  downstream;
- ``grad``: the worst tensors' relative L2 distance of a GRPO gradient
  (4 x 300 tokens) with bf16 weights against the same with f32 weights,
  and against the bf16 gradient whose forward rounds P to bf16.

Each distance is ``(max |difference|, mean |difference|)`` over the
logits, or a relative L2. Run from the root of a checkout:

    PYTHONPATH=src python3 tools/hybrid_bf16_noise.py [--layers 6 18 54]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models.params import init_params
from repro_torch.training.steps import make_grpo_loss_fn, value_and_grad

PROMPT, TOTAL = 260, 300


def p_in_bf16(q, k, v, **kw):
    """The plain attention with P rounded to bf16 before P V, its output
    rounded once to q's dtype."""
    kv_len = kw.get("kv_len") or k.shape[2]
    s, _, _ = fa._scores_plain(q, k, kw.get("causal", True), kw.get("softcap", 0.0), kw.get("q_offset", 0), kv_len,
                               kw.get("window", 0))
    b, hq, sq, _ = q.shape
    out = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, -1).to(torch.bfloat16).float(), v.float())
    return out.reshape(b, hq, sq, v.shape[3]).to(q.dtype)


class PInBf16(torch.autograd.Function):
    """``p_in_bf16`` forward, the plain attention's backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        return p_in_bf16(q, k, v, causal=True)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            return torch.autograd.grad(fa.attention_plain(q, k, v, causal=True), (q, k, v), dout)


def dist(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def served(model, params, toks):
    with torch.no_grad():
        logits, cache, n = model.prefill(params, {"tokens": toks[:, :PROMPT]}, max_len=TOTAL)
        out = [logits[:, -1]]
        for t in range(PROMPT, TOTAL - 1):
            logits, cache = model.decode(params, cache, toks[:, t : t + 1], t)
            out.append(logits[:, -1])
    return torch.stack(out, 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, nargs="+", default=[6, 18, 54])
    args = ap.parse_args(argv)
    full = get_config("zamba2-2.7b")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 2048, (4, TOTAL), generator=g)
    mask = torch.zeros((4, TOTAL - 1), dtype=torch.bool)
    mask[:, PROMPT - 1 :] = True
    batch = {"tokens": toks, "behavior_logprobs": torch.where(mask, -7.6, 0.0), "loss_mask": mask,
             "advantages": torch.randn(4, generator=g)}
    for layers in args.layers:
        cfg = dataclasses.replace(full, num_layers=layers, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                                  d_ff=512, vocab=2048)
        bf16 = {k: v.to(torch.bfloat16) for k, v in
                init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu").items()}
        f32 = {k: v.float() for k, v in bf16.items()}
        plain, rounded = build_model(cfg, attention=fa.attention_plain), build_model(cfg, attention=p_in_bf16)
        sb, s32 = served(plain, bf16, toks[:2]), served(plain, f32, toks[:2])
        with torch.no_grad():
            fb = plain.forward(bf16, {"tokens": toks[:2]})[:, PROMPT - 1 : TOTAL - 1]
            f32f = plain.forward(f32, {"tokens": toks[:2]})[:, PROMPT - 1 : TOTAL - 1]
        loss = make_grpo_loss_fn(plain)
        gb, _ = value_and_grad(loss, bf16, batch)
        gf, _ = value_and_grad(loss, f32, batch)
        gp, _ = value_and_grad(make_grpo_loss_fn(build_model(cfg, attention=lambda q, k, v, **kw: PInBf16.apply(q, k, v))),
                               bf16, batch)
        worst = lambda other: sorted(((rel_l2(gb[n], other[n]), n) for n in gb), reverse=True)[:3]  # noqa: E731
        print(json.dumps(dict(
            layers=layers, logit_abs_max_f32=float(f32f.abs().max()),
            served_vs_forward={"bfloat16": dist(sb, fb), "float32": dist(s32, f32f)},
            bf16_vs_f32={"served": dist(sb, s32), "forward": dist(fb, f32f)},
            p_in_bf16=dist(served(rounded, bf16, toks[:2]), sb),
            grad={"bf16_vs_f32": worst(gf), "p_in_bf16_vs_plain": worst(gp)})), flush=True)


if __name__ == "__main__":
    main()
