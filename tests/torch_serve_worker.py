"""One rank of the port's sharded serving checks over gloo (CPU processes).

Run as ``python tests/torch_serve_worker.py <rank> <world> <workdir>``, one
process a rank; ``tests/test_torch_sharded_serve.py`` starts the eight. The
ranks meet through a ``FileStore`` in ``workdir``, which also holds the
inputs: ``serve.json`` (the cases: arch, H3, a ``long`` case's number of
steps and mesh) with ``serve_<case>.npz`` (the JAX init's weights by name, the
prompt tokens, a VLM's patches and the decode steps' tokens; an encoder's
frames). Each rank builds the ``("data", "model")`` 2x4 ``DeviceMesh``,
places the parameters by ``SERVE_RULES`` (``place_tree``) and the inputs
by their logical axes (``launch.cells._INPUT_AXES``), and runs the model's
``prefill`` (a cache of ``MAX_LEN`` slots after a VLM's patches, made
placed by the serve rules) and two ``decode`` steps (a MoE case's
``capacity_factor`` as the case gives it), or an encoder's
encode (``EncoderLM.forward``), under ``optimizations(mesh=...,
shardmap_moe=H3)``. A ``long`` case (batch 1) places the parameters by
``LONG_SERVE_RULES`` and decodes its steps one token at a time from
``init_cache(1, MAX_LEN, mesh=...)``: the hybrid over its ring cache
(``ring=True``, the reduced window of 8 slots sharded along its slots over
the data axis), with one more step, counted (``op_costs.count``), at a
window of 8 and of ``WIDE_WINDOW`` slots. A case may name another mesh
(``"mesh": "2x2x2"``: ``("pod", "data", "model")``, the ring's slots over
the pod and the data axes, as on the multi-pod mesh). Rank 0 writes ``serve.npz``:
each case's prefill logits and cache (a dense prefix's layers too) and
each step's logits and the cache after it, or its encode's logits,
gathered whole (``full_tensor``); every rank writes ``rank<r>.json``: the
placements and local block shapes of its cache, the shapes of the local
blocks the decode's attention (MLA: its latent attention; the ring: its
attention with the log-sum-exp, with its ``kv_len`` and step) and the
encode's attention saw, the counted ring steps' collectives, and the
pairs the MoE layers routed and dropped (``blocks.DROPPED``) and their
calls through the placed dispatch.
"""

from __future__ import annotations

import json
import os
import sys

#: the cache's slots past a VLM's patches: the prompt's and the two steps'
MAX_LEN = 16
#: the ring's window of the second counted ring step (the reduced config's is 8)
WIDE_WINDOW = 64


def cache_entries(cache) -> dict:
    """A cache's tensors by name: a decoder's stacked layers' by entry
    (``k``, ``v``; MLA's ``ckv``, ``krope``), a dense prefix's
    ``prefix<i>/<entry>``; the hybrid's and the xLSTM's ``<group>/<entry>``
    (``ssd/conv``, ``attn/k``, ``mlstm/c``, ``slstm/h``, ...)."""
    if "layers" not in cache:
        return {f"{g}/{k}": t for g, entries in cache.items() for k, t in entries.items()}
    out = dict(cache["layers"])
    for i, layer in enumerate(cache.get("prefix", [])):
        out.update({f"prefix{i}/{k}": t for k, t in layer.items()})
    return out


def main(rank: int, world: int, workdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_step_worker import _cfg

    from repro_torch.configs.base import HYBRID, SSM
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.launch.cells import _INPUT_AXES
    from repro_torch.models import blocks, build_model, optim
    from repro_torch.models.params import decoder_specs, from_numpy, spec
    from repro_torch.sharding import LONG_SERVE_RULES, SERVE_RULES, place_tree

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    meshes = {"2x4": init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model")),
              "2x2x2": init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))}
    out, info = {}, {}
    with open(os.path.join(workdir, "serve.json")) as fh:
        cases = json.load(fh)
    for case in cases:
        name = case["name"]
        mesh = meshes[case.get("mesh", "2x4")]
        cfg = _cfg(case)
        data = np.load(os.path.join(workdir, f"serve_{name}.npz"))
        named = {n[len("p/"):]: data[n] for n in data.files if n.startswith("p/")}
        if case.get("long"):
            params = place_tree(from_numpy(named, "cpu"), dict(decoder_specs(cfg)), LONG_SERVE_RULES, mesh)
            rec, info[name] = long_case(case, cfg, params, data, mesh)
            if rank == 0:
                out.update({f"{name}/{k}": v.numpy() for k, v in rec.items()})
            continue
        params = place_tree(from_numpy(named, "cpu"), dict(decoder_specs(cfg)), SERVE_RULES, mesh)
        batch = {}
        for k in ("tokens", "patches", "frames"):
            if k in data.files:
                t = torch.from_numpy(data[k])
                t = t.long() if k == "tokens" else t
                batch[k] = place_tree(t, spec(tuple(t.shape), _INPUT_AXES[k][: t.ndim]), SERVE_RULES, mesh)
        seen, latent = [], []

        def attention(q, k, v, **kw):
            if ("kv_len" in kw and kw.get("q_offset")) or not kw.get("causal", True):
                seen.append([list(q.shape), list(k.shape)])
            return flash_attention(q, k, v, **kw)

        def latent_attention(q_abs, q_rope, ckv, krope, **kw):
            latent.append([list(q_abs.shape), list(ckv.shape)])
            return mla_decode(q_abs, q_rope, ckv, krope, **kw)

        kw = {} if cfg.encoder_only or cfg.family == HYBRID else dict(latent_attention=latent_attention)
        model = build_model(cfg) if cfg.family == SSM else build_model(cfg, attention=attention, **kw)
        blocks.DROPPED.reset()
        with torch.no_grad(), optim.optimizations(mesh=mesh, shardmap_moe=case["h3"]):
            if cfg.encoder_only:  # the encoder's serving step: its encode
                rec = {f"{name}/encode/logits": model.forward(params, batch).full_tensor()}
                info[f"{name}/encode_attention"] = seen
                if rank == 0:
                    out.update({k: v.numpy() for k, v in rec.items()})
                continue
            logits, cache, n = model.prefill(params, batch, max_len=MAX_LEN + cfg.num_patches)
            rec = {f"{name}/prefill/logits": logits.full_tensor()}
            rec.update({f"{name}/prefill/{k}": t.full_tensor() for k, t in cache_entries(cache).items()})
            info[f"{name}/cache"] = {k: {"placements": [str(p) for p in t.placements],
                                         "local": list(t.to_local().shape), "global": list(t.shape)}
                                     for k, t in cache_entries(cache).items()}
            for step in range(2):
                tok = torch.from_numpy(data[f"step{step}"]).long()
                tok = place_tree(tok, spec(tuple(tok.shape), ("batch", None)), SERVE_RULES, mesh)
                logits, cache = model.decode(params, cache, tok, n + step)
                rec[f"{name}/step{step}/logits"] = logits.full_tensor()
                rec.update({f"{name}/step{step}/{k}": t.full_tensor() for k, t in cache_entries(cache).items()})
        info[f"{name}/decode_attention"] = seen
        info[f"{name}/decode_latent_attention"] = latent
        info[f"{name}/dropped"] = [blocks.DROPPED.routed, blocks.DROPPED.dropped, blocks.DROPPED.placed_calls]
        if rank == 0:
            out.update({k: v.numpy() for k, v in rec.items()})
    if rank == 0:
        np.savez(os.path.join(workdir, "serve.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank, flush=True)


def long_case(case, cfg, params, data, mesh):
    """A batch-1 case under ``LONG_SERVE_RULES``: ``case["steps"]`` decode
    steps from an empty placed cache (the hybrid's a ring), each step's
    logits and cache whole, and this rank's record: its cache's placements
    and blocks, its ring attention's calls (step, ``kv_len``, the local
    K's shape) and the collectives of one more step counted at the ring's
    window and at ``WIDE_WINDOW``."""
    import dataclasses

    import torch

    from repro_torch.configs.base import HYBRID
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import op_costs
    from repro_torch.models import build_model, optim

    calls, step = [], [0]

    def attention(q, k, v, **kw):
        if kw.get("with_lse"):
            calls.append([step[0], kw["kv_len"], list(k.shape)])
        return flash_attention(q, k, v, **kw)

    ring = cfg.family == HYBRID
    kw = dict(ring=True) if ring else {}
    model = build_model(cfg, attention=attention) if ring else build_model(cfg)
    rec, info = {}, {}
    with torch.no_grad(), optim.optimizations(mesh=mesh):
        cache = model.init_cache(1, MAX_LEN, torch.float32, "cpu", mesh=mesh, **kw)
        info["cache"] = {k: {"placements": [str(p) for p in t.placements], "local": list(t.to_local().shape),
                             "global": list(t.shape)} for k, t in cache_entries(cache).items()}
        for i in range(case["steps"]):
            step[0] = i
            tok = torch.from_numpy(data[f"step{i}"]).long()
            logits, cache = model.decode(params, cache, tok, i, **kw)
            rec[f"step{i}/logits"] = logits.full_tensor()
            rec.update({f"step{i}/{k}": t.full_tensor() for k, t in cache_entries(cache).items()})
        info["ring_calls"] = list(calls)
        if ring:  # one more step, its collectives counted, at the ring's window and at a wider one
            tok = torch.from_numpy(data["step0"]).long()
            info["ring_collectives"] = {}
            for window in (cfg.sliding_window, WIDE_WINDOW):
                wide = build_model(dataclasses.replace(cfg, sliding_window=window), attention=attention)
                c = wide.init_cache(1, window, torch.float32, "cpu", mesh=mesh, ring=True)
                costs, _ = op_costs.count(lambda: wide.decode(params, c, tok, window + 3, ring=True))
                info["ring_collectives"][str(window)] = {"counts": costs.collective_counts,
                                                         "bytes": costs.collective_bytes}
    return rec, info


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
