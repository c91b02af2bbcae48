"""One rank of the port's sharded serving checks over gloo (CPU processes).

Run as ``python tests/torch_serve_worker.py <rank> <world> <workdir>``, one
process a rank; ``tests/test_torch_sharded_serve.py`` starts the eight. The
ranks meet through a ``FileStore`` in ``workdir``, which also holds the
inputs: ``serve.json`` (the cases: arch, H3) with ``serve_<case>.npz`` (the
JAX init's weights by name, the prompt tokens and two decode steps'
tokens). Each rank builds the ``("data", "model")`` 2x4 ``DeviceMesh``,
places the parameters by ``SERVE_RULES`` (``place_tree``) and the prompt
by ``("batch", "seq")``, and runs ``DecoderLM.prefill`` (a cache of
``MAX_LEN`` slots, made placed by the serve rules) and two ``decode``
steps under ``optimizations(mesh=..., shardmap_moe=H3)``. Rank 0 writes
``serve.npz``: each case's prefill logits and cache and each step's
logits and the cache after it, gathered whole (``full_tensor``); every
rank writes ``rank<r>.json``: the placements and local block shapes of
its cache, and the shape of the local block the decode attention saw.
"""

from __future__ import annotations

import json
import os
import sys

#: the cache's slots: the prompt's and the two steps'
MAX_LEN = 16


def main(rank: int, world: int, workdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(__file__))
    from torch_step_worker import _cfg

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model, optim
    from repro_torch.models.params import decoder_specs, from_numpy, spec
    from repro_torch.sharding import SERVE_RULES, place_tree

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    out, info = {}, {}
    with open(os.path.join(workdir, "serve.json")) as fh:
        cases = json.load(fh)
    for case in cases:
        name = case["name"]
        cfg = _cfg(case)
        data = np.load(os.path.join(workdir, f"serve_{name}.npz"))
        named = {n[len("p/"):]: data[n] for n in data.files if n.startswith("p/")}
        params = place_tree(from_numpy(named, "cpu"), dict(decoder_specs(cfg)), SERVE_RULES, mesh)
        tokens = torch.from_numpy(data["tokens"]).long()
        tokens = place_tree(tokens, spec(tuple(tokens.shape), ("batch", "seq")), SERVE_RULES, mesh)
        seen = []

        def attention(q, k, v, **kw):
            if "kv_len" in kw and kw.get("q_offset"):
                seen.append([list(q.shape), list(k.shape)])
            return flash_attention(q, k, v, **kw)

        model = build_model(cfg, attention=attention)
        with torch.no_grad(), optim.optimizations(mesh=mesh, shardmap_moe=case["h3"]):
            logits, cache, n = model.prefill(params, {"tokens": tokens}, max_len=MAX_LEN)
            rec = {f"{name}/prefill/logits": logits.full_tensor()}
            rec.update({f"{name}/prefill/{k}": t.full_tensor() for k, t in cache["layers"].items()})
            info[f"{name}/cache"] = {k: {"placements": [str(p) for p in t.placements],
                                         "local": list(t.to_local().shape), "global": list(t.shape)}
                                     for k, t in cache["layers"].items()}
            for step in range(2):
                tok = torch.from_numpy(data[f"step{step}"]).long()
                tok = place_tree(tok, spec(tuple(tok.shape), ("batch", None)), SERVE_RULES, mesh)
                logits, cache = model.decode(params, cache, tok, n + step)
                rec[f"{name}/step{step}/logits"] = logits.full_tensor()
                rec.update({f"{name}/step{step}/{k}": t.full_tensor() for k, t in cache["layers"].items()})
        info[f"{name}/decode_attention"] = seen
        if rank == 0:
            out.update({k: v.numpy() for k, v in rec.items()})
    if rank == 0:
        np.savez(os.path.join(workdir, "serve.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
