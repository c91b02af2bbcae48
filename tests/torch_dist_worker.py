"""One rank of the port's 2x4 sharding checks over gloo (CPU processes).

Run as ``python tests/torch_dist_worker.py <rank> <world> <workdir>``, one
process a rank; ``tests/test_torch_moe_shardmap.py`` starts the eight.
The ranks meet through a ``FileStore`` in ``workdir``, which also holds
the inputs (``inputs.npz``: a reduced dbrx MoE layer and its input;
``cases.json``: the tensors to place). Each rank builds the ``("data",
"model")`` 2x4 ``DeviceMesh`` and writes ``rank<r>.npz``:

* ``place/<i>``: its local shard of case ``i`` (an ``arange`` tensor of the
  case's shape), placed by ``placements_for(spec_for(...))``;
* ``h3/<form>``: H3 (``moe_apply_shardmap``) of the layer with
  ``capacity_factor = num_experts``, from plain tensors and from DTensors
  placed by each rule table, beside the port's ``moe_dense_ref``;
* ``fallback/<case>``: H3 and ``moe_apply`` where the JAX code falls back;
* ``model/<form>``: a reduced dbrx forward with H3 on and off;

and ``rank<r>.json``: each case's spec and placements, and which fallback
cases were bit-equal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys


def main(rank: int, world: int, workdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.models import blocks, build_model, optim
    from repro_torch.models.params import init_params
    from repro_torch.sharding import LONG_SERVE_RULES, SERVE_RULES, TRAIN_RULES, placements_for, sharding_for, spec_for

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    tables = {"train": TRAIN_RULES, "serve": SERVE_RULES, "long_serve": LONG_SERVE_RULES}
    out, info = {}, {"cases": []}

    # the placements of each case's tensor
    with open(os.path.join(workdir, "cases.json")) as fh:
        cases = json.load(fh)
    for i, case in enumerate(cases):
        shape = tuple(case["shape"])
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        spec = spec_for(shape, tuple(case["axes"]), tables[case["table"]], mesh)
        placements = placements_for(spec, mesh)
        out[f"place/{i}"] = distribute_tensor(full, mesh, placements).to_local().numpy()
        info["cases"].append({"spec": [list(e) if isinstance(e, tuple) else e for e in spec],
                              "placements": [str(p) for p in placements]})

    # H3 against the dense oracle (nothing dropped), plain and placed
    data = np.load(os.path.join(workdir, "inputs.npz"))
    p = {n[len("p/"):]: torch.from_numpy(data[n]) for n in data.files if n.startswith("p/")}
    x = torch.from_numpy(data["x"])
    cfg = get_config("dbrx-132b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    specs = blocks.moe_specs(cfg)
    with torch.no_grad(), optim.optimizations(mesh=mesh, shardmap_moe=True):
        out["h3/plain"] = blocks.moe_apply_shardmap(cfg, p, x).numpy()
        for name in ("train", "serve"):
            rules = tables[name]
            placed = {n: distribute_tensor(t, mesh, sharding_for(specs[n], rules, mesh)) for n, t in p.items()}
            xd = distribute_tensor(x, mesh, placements_for(spec_for(x.shape, ("batch", "seq", "act_embed"), rules,
                                                                    mesh), mesh))
            y = blocks.moe_apply_shardmap(cfg, placed, xd)
            info[f"h3_{name}_placements"] = [str(q) for q in y.placements]
            info[f"h3_{name}_same_placements"] = y.placements == xd.placements
            out[f"h3/{name}"] = y.full_tensor().numpy()
        out["h3/dense_ref"] = blocks.moe_dense_ref(cfg, p, x).numpy()

    # where the JAX code falls back: bit-equal to moe_apply
    base = get_config("dbrx-132b").reduced()
    e6 = dataclasses.replace(base, moe=dataclasses.replace(base.moe, num_experts=6))
    p6 = {n: (t[:, :6] if n == "router" else t[:6] if n in ("w_gate", "w_up", "w_down") else t) for n, t in p.items()}
    fallbacks = {
        "experts_indivisible": (e6, p6, x, {}),
        "batch_indivisible": (base, p, x[:3], {}),
        "no_batch_axis": (base, p, x, {"batch_axes": ("pod",)}),
        "tp_1": (base, p, x, {"model_axis": "pod"}),
    }
    info["fallback_equal"] = {}
    with torch.no_grad():
        for case, (c, pp, xx, kw) in fallbacks.items():
            want = blocks.moe_apply(c, pp, xx)
            with optim.optimizations(mesh=mesh, shardmap_moe=True, **kw):
                got = blocks.moe_apply_shardmap(c, pp, xx)
            out[f"fallback/{case}"] = got.numpy()
            info["fallback_equal"][case] = bool(torch.equal(got, want))

    # DecoderLM's switch: a reduced dbrx forward with H3 on and off
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    model = build_model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (4, 12)))
    with torch.no_grad():
        out["model/off"] = model.forward(params, {"tokens": tokens}).numpy()
        with optim.optimizations(mesh=mesh, shardmap_moe=True):
            out["model/h3"] = model.forward(params, {"tokens": tokens}).numpy()

    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank, flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
