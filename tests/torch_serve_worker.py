"""One rank of the port's sharded serving checks over gloo (CPU processes).

Run as ``python tests/torch_serve_worker.py <rank> <world> <workdir>``, one
process a rank; ``tests/test_torch_sharded_serve.py`` starts the eight. The
ranks meet through a ``FileStore`` in ``workdir``, which also holds the
inputs: ``serve.json`` (the cases: arch, H3) with ``serve_<case>.npz`` (the
JAX init's weights by name, the prompt tokens, a VLM's patches and two
decode steps' tokens; an encoder's frames). Each rank builds the
``("data", "model")`` 2x4 ``DeviceMesh``, places the parameters by
``SERVE_RULES`` (``place_tree``) and the inputs by their logical axes
(``launch.cells._INPUT_AXES``), and runs ``DecoderLM.prefill`` (a cache of
``MAX_LEN`` slots after a VLM's patches, made placed by the serve rules)
and two ``decode`` steps, or an encoder's encode (``EncoderLM.forward``),
under ``optimizations(mesh=..., shardmap_moe=H3)``. Rank 0 writes
``serve.npz``: each case's prefill logits and cache (a dense prefix's
layers too) and each step's logits and the cache after it, or its
encode's logits, gathered whole (``full_tensor``); every rank writes
``rank<r>.json``: the placements and local block shapes of its cache, and
the shapes of the local blocks the decode's attention (MLA: its latent
attention) and the encode's attention saw.
"""

from __future__ import annotations

import json
import os
import sys

#: the cache's slots past a VLM's patches: the prompt's and the two steps'
MAX_LEN = 16


def cache_entries(cache) -> dict:
    """A decoder cache's tensors by name: the stacked layers' by entry
    (``k``, ``v``; MLA's ``ckv``, ``krope``), a dense prefix's
    ``prefix<i>/<entry>``."""
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

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.launch.cells import _INPUT_AXES
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

        kw = {} if cfg.encoder_only else dict(latent_attention=latent_attention)
        model = build_model(cfg, attention=attention, **kw)
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
