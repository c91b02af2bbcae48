#!/usr/bin/env python3
"""How far f32 rounding alone moves xlstm-350m's gradients.

xlstm-350m at its published widths (or narrowed by ``--d-model`` /
``--vocab``) with random weights from a seed, in f32, on one batch of
``--batch`` sequences of ``--seq`` tokens. The mLSTM runs in three forms
that compute the same function in exact arithmetic: the chunked form at the
published chunk of 256, the chunked form at a chunk of 128, and the
quadratic parallel form (``build_model(cfg, mlstm="parallel")``). For each
pair of forms it prints one JSON line with the relative L2 distance
``|a - b| / |b|`` of each tensor's gradient (the largest and the median
over the tensors) and the largest logit difference, for two losses:

- ``grpo``: phase 17's GRPO objective, on-policy behavior logprobs (every
  ratio 1), advantages normalised within groups of ``--group`` sequences
  from seeded uniform rewards, the loss over the last ``--response``
  positions: the advantages sum to zero in a group, so the gradient is a
  small difference of the sequences' gradients;
- ``lm``: the LM cross-entropy over every position (no such cancellation).

Run from the root of a checkout (the card by default; ``--device cpu`` with
a narrowed model on the host):

    PYTHONPATH=src python3 tools/xlstm_grad_noise.py [--layers 24] [--batch 16 --seq 576]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, xlstm_blocks
from repro_torch.models.params import init_params
from repro_torch.training import group_relative_advantages
from repro_torch.training.steps import make_grpo_loss_fn, make_loss_fn, value_and_grad


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--d-model", type=int, default=0, help="0: the published 1024")
    ap.add_argument("--vocab", type=int, default=0, help="0: the published 50304")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--group", type=int, default=4)
    ap.add_argument("--seq", type=int, default=576)
    ap.add_argument("--response", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = get_config("xlstm-350m")
    cfg = dataclasses.replace(cfg, num_layers=args.layers, d_model=args.d_model or cfg.d_model,
                              vocab=args.vocab or cfg.vocab)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), torch.float32, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.seq), generator=g, device=dev)
    mask = torch.zeros((args.batch, args.seq - 1), dtype=torch.bool, device=dev)
    mask[:, args.seq - 1 - args.response :] = True
    rewards = torch.from_numpy(np.random.default_rng(args.seed + 2).random(args.batch).astype(np.float32))
    adv = group_relative_advantages(rewards, args.group).to(dev)

    chunked = build_model(cfg)
    with torch.no_grad():
        logits = chunked.forward(params, {"tokens": tokens})
        lp = torch.log_softmax(logits[:, :-1], -1).gather(-1, tokens[:, 1:, None])[..., 0]
    grpo_batch = {"tokens": tokens, "behavior_logprobs": torch.where(mask, lp, 0.0), "advantages": adv,
                  "loss_mask": mask}
    del lp

    chunk = xlstm_blocks._mlstm_chunked.__kwdefaults__["chunk"]
    forms = {}
    for label, model, ch in (("chunked_256", chunked, chunk), ("chunked_128", chunked, 128),
                             ("parallel", build_model(cfg, mlstm="parallel"), chunk)):
        xlstm_blocks._mlstm_chunked.__kwdefaults__["chunk"] = ch
        try:
            with torch.no_grad():
                out = model.forward(params, {"tokens": tokens})
            grads = {"grpo": value_and_grad(make_grpo_loss_fn(model), params, grpo_batch),
                     "lm": value_and_grad(make_loss_fn(model, cfg), params, {"tokens": tokens})}
        finally:
            xlstm_blocks._mlstm_chunked.__kwdefaults__["chunk"] = chunk
        forms[label] = (out, grads)
    for a, b in (("chunked_256", "parallel"), ("chunked_128", "parallel"), ("chunked_256", "chunked_128")):
        (out_a, ga), (out_b, gb) = forms[a], forms[b]
        row = dict(config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, vocab=cfg.vocab, batch=args.batch,
                   seq=args.seq, device=str(dev), pair=[a, b], logit_max_abs_diff=float((out_a - out_b).abs().max()),
                   logit_mean_abs_diff=float((out_a - out_b).abs().double().mean()))
        for loss in ("grpo", "lm"):
            (grad_a, m_a), (grad_b, m_b) = ga[loss], gb[loss]
            errs = sorted(rel_l2(grad_a[n], grad_b[n]) for n in grad_b)
            row[loss] = dict(loss=[float(m_a["loss"]), float(m_b["loss"])], grad_rel_l2_max=errs[-1],
                             grad_rel_l2_median=errs[len(errs) // 2])
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
