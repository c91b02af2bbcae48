"""The dry run's traces on a fake process group, for ``tests/test_torch_dryrun.py``.

Run as ``python tests/torch_dryrun_worker.py <workdir> <part>``: a process
group of 256 fake ranks (``launch.dryrun.start_fake_world``) lives in this
process only, never in a pytest worker. The test starts the three parts
side by side; each writes ``<workdir>/<part>.json``. Part ``dense``
(llama3-8b's trips, the hand counts, the analytic prefill, the MLA decode
layer and the leaves), part ``gated`` (gemma2-2b's, dbrx's and
deepseek-v3's trips) and part ``all``:

* ``hand``: ``op_costs.analyze`` of three DTensor products and gathers on
  the 2x4 mesh of ranks 0-7 (fake tensors), for the hand counts;
* ``trips``: narrowed llama3-8b, gemma2-2b, dbrx and deepseek-v3 (its
  dense prefix layer before the MoE stack) in each kind, counted
  by ``analyze_cell`` (cut depths, extended) and by one trace at full
  depth, on the 2x4 mesh, the full depth past the deepest cut one;
* ``dense``: a narrowed dense prefill's per-device dot FLOPs on the 2x4
  mesh, beside its config, for the analytic formula;
* ``mla_decode``: one MLA decode layer's counts on the 2x4 mesh against a
  placed latent cache of 64 and of 256 slots;
* ``leaves``: every leaf of every live cell on the 16x16 mesh (built, not
  traced): its name, global shape and placements;
* ``all``: ``launch.dryrun.main(["--all", ...])`` over the registry's
  configs cut by ``reduced()`` (the families, their refusals and the
  shapes as the registry's, the widths small): its exit code and each
  cell's JSON record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time


def main(workdir: str, part: str) -> None:
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    dryrun.start_fake_world(256)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    if part == "dense":
        out = {"hand": _hand(mesh), "trips": _trips(mesh, ("llama3-8b",)), "dense": _dense(mesh), "leaves": _leaves(),
               "mla_decode": _mla_decode_layer(mesh)}
    elif part == "gated":
        out = {"trips": _trips(mesh, ("gemma2-2b", "dbrx-132b", "deepseek-v3-671b"))}
    else:
        out = {"all": _all(workdir)}
    with open(os.path.join(workdir, f"{part}.json"), "w") as fh:
        json.dump(out, fh)
    print("DRYRUN_WORKER_OK", part, flush=True)


def _hand(mesh) -> dict:
    """Three DTensor calls on fake tensors placed on the 2x4 mesh."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch import op_costs

    with FakeTensorMode(allow_non_fake_inputs=True):
        x, w = torch.empty(8, 16), torch.empty(16, 12)
        xs = distribute_tensor(x, mesh, [Shard(0), Replicate()])
        ws = distribute_tensor(w, mesh, [Replicate(), Shard(1)])
        xk = distribute_tensor(x, mesh, [Replicate(), Shard(1)])
        wk = distribute_tensor(w, mesh, [Replicate(), Shard(0)])
    return {
        "mm_sharded": op_costs.analyze(lambda a, b: a @ b, xs, ws).as_dict(),
        "mm_contracted": op_costs.analyze(lambda a, b: (a @ b).redistribute(mesh, [Replicate(), Replicate()]),
                                          xk, wk).as_dict(),
        "gather_rows": op_costs.analyze(lambda a: a.full_tensor(), xs).as_dict(),
    }


#: the narrowed configs of the trips: each deeper than its deepest cut trace
NARROW = {"llama3-8b": dict(num_layers=6), "gemma2-2b": dict(num_layers=8, sliding_window=16),
          "dbrx-132b": dict(num_layers=5), "deepseek-v3-671b": dict(num_layers=7)}


def _trips(mesh, archs) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import cells, op_costs

    cases = {"train_4k": ShapeCase("train_4k", 32, 8, "train"), "prefill_32k": ShapeCase("prefill_32k", 32, 4, "prefill"),
             "decode_32k": ShapeCase("decode_32k", 48, 8, "decode")}
    out = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch).reduced(), **NARROW[arch])
        for shape, case in cases.items():
            t0 = time.perf_counter()
            ext = op_costs.analyze_cell(arch, shape, mesh, cfg=cfg, case=case)
            full = cells.build_cell(arch, shape, mesh, cfg=cfg, case=case).trace(mesh)
            out[f"{arch}/{shape}"] = {"extended": ext["costs"].as_dict(), "full": full["costs"].as_dict(),
                                      "depths": ext["depths"], "layers": cfg.num_layers,
                                      "seconds": time.perf_counter() - t0}
    return out


def _dense(mesh) -> dict:
    """A narrowed dense prefill (every width divides the 4-way model axis)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import cells

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(), d_model=256, num_heads=8, num_kv_heads=4, head_dim=32,
                              d_ff=512, vocab=1024, num_layers=2)
    case = ShapeCase("prefill_32k", 64, 4, "prefill")
    rec = cells.build_cell("llama3-8b", "prefill_32k", mesh, cfg=cfg, case=case).trace(mesh)
    return {"costs": rec["costs"].as_dict(), "cfg": dataclasses.asdict(cfg), "batch": case.global_batch,
            "seq": case.seq_len}


#: the latent cache's slots of the MLA decode layer, two lengths
MLA_SLOTS = (64, 256)
#: its batch (over the 2-way data axis)
MLA_BATCH = 8


def _mla_decode_layer(mesh) -> dict:
    """``op_costs.analyze`` of one MLA decode layer (``blocks.mla_apply``
    with a cache, reduced deepseek-v3: 4 heads over the 4-way model axis)
    on fake bf16 blocks placed by ``SERVE_RULES`` on the 2x4 mesh: the
    layer's parameters, the step's input ``[B, 1, d_model]`` and the latent
    cache of ``MLA_SLOTS`` slots, the step at the last slot, its output
    placed as its input (DTensor leaves the output projection's sum
    partial until an op needs it); the latent attention through the
    kernel operator (its fake). By cache length:
    the counts, and the shapes the operator saw."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.kernels.mla_decode import mla_decode_op
    from repro_torch.launch import op_costs
    from repro_torch.models import blocks
    from repro_torch.models.lm import DecoderLM, mesh_scope
    from repro_torch.models.params import spec
    from repro_torch.sharding import SERVE_RULES, place_new

    cfg = get_config("deepseek-v3-671b").reduced()
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def block(shape):
        with fake:
            return torch.empty(shape, dtype=torch.bfloat16)

    out = {}
    for slots in MLA_SLOTS:
        params = place_new(blocks.mla_specs(cfg), SERVE_RULES, mesh, block)
        x = place_new(spec((MLA_BATCH, 1, cfg.d_model), ("batch", None, "act_embed")), SERVE_RULES, mesh, block)
        cache = place_new(DecoderLM(cfg)._attn_cache_spec(MLA_BATCH, slots), SERVE_RULES, mesh, block)
        seen = []

        def latent(q_abs, q_rope, ckv, krope, **kw):
            seen.append([list(q_abs.shape), list(ckv.shape)])
            return mla_decode_op(q_abs, q_rope, ckv, krope, **kw)

        def step(p, x, c):
            with mesh_scope(p):
                positions = slots - 1 + torch.arange(1, device=x.device)
                y, _ = blocks.mla_apply(cfg, p, x, positions=positions, attention=flash_attention_op,
                                        latent_attention=latent, cache=c, cache_len=slots - 1)
                return y.redistribute(mesh, x.placements)  # the residual stream as it came in

        costs = op_costs.analyze(step, params, x, cache)
        out[str(slots)] = {"costs": costs.as_dict(), "latent_calls": seen,
                           "cfg": {"d_model": cfg.d_model, "num_heads": cfg.num_heads,
                                   "kv_lora_rank": cfg.mla.kv_lora_rank}, "batch": MLA_BATCH}
    return out


def _leaves() -> dict:
    """Every leaf of every live cell on the 16x16 mesh (built, not traced)."""
    from repro_torch.launch import cells, dryrun

    prod = dryrun.device_mesh(dryrun.make_production_mesh())
    out = {}
    for arch, shape in cells.live_cells():
        cell = cells.build_cell(arch, shape, prod)
        args = cell.in_structs
        if cell.kind == "train":
            params, state, batch = args
            trees = {"params": params, "mu": state.mu, "nu": state.nu, "batch": batch}
        elif cell.kind == "prefill":
            trees = {"params": args[0], "batch": args[1]}
        else:
            trees = {"params": args[0], "cache": args[1], "batch": {"tokens": args[2]}}
        leaves = {}
        for tname, tree in trees.items():
            for name, t in _named(tree):
                leaves[f"{tname}/{name}"] = {"shape": list(t.shape), "placements": [str(p) for p in t.placements],
                                             "dtype": str(t.dtype)}
        out[f"{arch}/{shape}"] = {"kind": cell.kind, "leaves": leaves}
    return out


def _all(workdir: str) -> dict:
    """``dryrun.main(["--all", ...])`` with every config cut by ``reduced()``."""
    from repro_torch import configs
    from repro_torch.launch import cells, dryrun

    real = configs.get_config

    def reduced(arch):
        return real(arch).reduced()

    for mod in (configs, dryrun, cells):
        mod.get_config = reduced
    out_dir = os.path.join(workdir, "all")
    rc = dryrun.main(["--all", "--mesh", "single", "--out", out_dir])
    recs = {}
    for fn in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, fn)) as fh:
            recs[fn] = json.load(fh)
    return {"rc": rc, "cells": recs}


def _named(tree, prefix: str = ""):
    """``(name, tensor)`` of a tree of dicts and lists, names joined by
    ``/`` (list items by index)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
