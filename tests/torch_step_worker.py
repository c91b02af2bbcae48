"""One rank of the port's sharded train step checks over gloo (CPU processes).

Run as ``python tests/torch_step_worker.py <rank> <world> <workdir>``, one
process a rank; ``tests/test_torch_sharded_step.py`` starts eight for each
group of its checks. The ranks meet through a ``FileStore`` in
``workdir``, which also holds the inputs: ``steps.json`` (``{"cases":
[...], "checks": [...]}``: the group's step cases, each its arch, head and
capacity overrides, whether the batch is placed, whether H3 is on,
``accum``, GRPO and its mesh, ``"2x4"`` by default or ``"2x2x2"``; and
which of the checks ``h1``, ``h3``, ``optim`` and ``moe_gathers`` the
group runs) with
``step_<case>.npz`` (the JAX init's weights by name and the batch: tokens,
a VLM's patches too, an encoder's frames, targets and mask), ``h1.npz`` (a reduced
llama3-8b of 8 query and 2 KV heads and its tokens), ``moe.npz`` (a
reduced dbrx MoE layer and its input) and ``optim.npz`` (tensors,
gradients and moments for AdamW). Each rank builds the ``("data",
"model")`` 2x4 ``DeviceMesh`` (and the ``("pod", "data", "model")`` 2x2x2
one) and writes ``rank<r>.npz``:

* ``step/<case>/loss``, ``step/<case>/g/<name>`` and (rank 0)
  ``step/<case>/p/<name>``: one ``make_train_step`` (or
  ``make_grpo_step``) on parameters and moments placed by ``TRAIN_RULES``
  (``place_tree``), the batch replicated or placed by its logical axes
  (``launch.cells._INPUT_AXES``): its loss, the gradients it hands the optimizer (placed like
  their parameters, gathered whole with ``full_tensor``) and the
  parameters after it;
* ``h1/logits``: the H1 forward (``shard_attn_heads``) on the placed
  parameters and batch, with the attention's local block shapes in the
  json;
* ``h3/<form>/<name>``: the gradients of ``sum(moe_apply_shardmap(...)**2)``
  from plain tensors and from DTensors placed by ``TRAIN_RULES``;
* ``optim/<what>``: ``global_norm`` and ``AdamW.update`` on DTensors and
  on the same plain tensors;
* (``moe_gathers``, in the json) one reduced dbrx MoE layer's counted
  collectives, forward and backward, at two batches;

and ``rank<r>.json``: the H1 blocks' shapes, the gradients' placements
and each step's MoE pairs routed and dropped (``blocks.DROPPED``) and its
calls through the placed dispatch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys


#: a GRPO batch's fields beside its tokens
GRPO_FIELDS = ("behavior_logprobs", "advantages", "loss_mask")


def _cfg(case: dict):
    from repro_torch.configs import get_config

    cfg = get_config(case["arch"]).reduced()
    if case.get("heads"):
        cfg = dataclasses.replace(cfg, num_heads=case["heads"][0], num_kv_heads=case["heads"][1])
    if cfg.moe is not None:
        factor = case.get("capacity_factor", float(cfg.moe.num_experts))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))
    return cfg


class Recording:
    """An optimizer that keeps the gradients a step hands it, whole on
    every rank, and then updates as ``opt`` does."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        from repro_torch.models.optim import is_dtensor

        self.grads = {n: g.full_tensor() if is_dtensor(g) else g for n, g in grads.items()}
        return self.opt.update(grads, state, params)


def main(rank: int, world: int, workdir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.cells import _INPUT_AXES
    from repro_torch.models import blocks, build_model, optim
    from repro_torch.models.params import decoder_specs, from_numpy
    from repro_torch.sharding import TRAIN_RULES, place_tree, placements_for, spec_for
    from repro_torch.training import AdamW, make_grpo_step, make_train_step

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    meshes = {"2x4": init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model")),
              "2x2x2": init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))}
    mesh = meshes["2x4"]
    out, info = {}, {}

    def load(name):
        data = np.load(os.path.join(workdir, name))
        return {n[len("p/"):]: data[n] for n in data.files if n.startswith("p/")}, data

    def batch_of(data, placed: bool, mesh=mesh):
        """The case's batch: its model inputs (tokens; a VLM's patches; an
        encoder's frames, targets and mask), each placed by its
        ``_INPUT_AXES`` where ``placed``, and a GRPO batch's other fields,
        plain."""
        batch = {k: torch.from_numpy(data[k]) for k in GRPO_FIELDS if k in data.files}
        for k, axes in _INPUT_AXES.items():
            if k not in data.files:
                continue
            t = torch.from_numpy(data[k])
            t = t.long() if k in ("tokens", "targets") else t
            if placed:
                spec = spec_for(tuple(t.shape), axes[: t.ndim], TRAIN_RULES, mesh)
                t = distribute_tensor(t, mesh, placements_for(spec, mesh))
            batch[k] = t
        return batch

    # the sharded step, one a case
    with open(os.path.join(workdir, "steps.json")) as fh:
        group = json.load(fh)
    for case in group["cases"]:
        cfg = _cfg(case)
        cmesh = meshes[case.get("mesh", "2x4")]
        named, data = load(f"step_{case['name']}.npz")
        params = place_tree(from_numpy(named, "cpu"), dict(decoder_specs(cfg)), TRAIN_RULES, cmesh)
        opt = Recording(AdamW(lr=1e-3, weight_decay=0.0))
        model = build_model(cfg)
        step = (make_grpo_step(model, cfg, opt) if case.get("grpo")
                else make_train_step(model, cfg, opt, accum=case.get("accum", 1)))
        blocks.DROPPED.reset()
        with optim.optimizations(mesh=cmesh, shardmap_moe=case["h3"]):
            _, state, metrics = step(params, opt.init(params), batch_of(data, case["placed"], cmesh))
        info[f"step/{case['name']}/dropped"] = [blocks.DROPPED.routed, blocks.DROPPED.dropped,
                                                blocks.DROPPED.placed_calls]
        out[f"step/{case['name']}/loss"] = metrics["loss"].numpy()
        for n, g in opt.grads.items():
            out[f"step/{case['name']}/g/{n}"] = g.numpy()
        info[f"step/{case['name']}/moment_placements_match"] = all(
            state.mu[n].placements == p.placements and state.nu[n].placements == p.placements
            for n, p in params.items())
        for n, p in params.items():
            full = p.full_tensor()
            if rank == 0:
                out[f"step/{case['name']}/p/{n}"] = full.numpy()

    if "h1" in group["checks"]:
        h1_check(mesh, load, batch_of, out, info)
    if "h3" in group["checks"]:
        h3_check(mesh, load, out, info)
    if "optim" in group["checks"]:
        optim_check(mesh, load, out, info)
    if "moe_gathers" in group["checks"]:
        moe_gathers_check(mesh, load, info)

    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(info, fh)
    dist.barrier()
    dist.destroy_process_group()
    print("RANK_OK", rank, flush=True)


def h1_check(mesh, load, batch_of, out, info):
    """H1: K/V broadcast to the query heads, the attention on each rank's heads."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model, optim
    from repro_torch.models.params import decoder_specs, from_numpy
    from repro_torch.sharding import TRAIN_RULES, place_tree

    cfg = _cfg({"arch": "llama3-8b", "heads": [8, 2]})
    named, data = load("h1.npz")
    params = place_tree(from_numpy(named, "cpu"), dict(decoder_specs(cfg)), TRAIN_RULES, mesh)
    seen = set()

    def attention(q, k, v, **kw):
        seen.add((tuple(q.shape), tuple(k.shape), tuple(v.shape)))
        return flash_attention(q, k, v, **kw)

    with torch.no_grad(), optim.optimizations(mesh=mesh, shard_attn_heads=True):
        logits = build_model(cfg, attention=attention).forward(params, batch_of(data, True))
    out["h1/logits"] = logits.full_tensor().numpy()
    info["h1_local_shapes"] = sorted(list(map(list, s)) for s in seen)


def h3_check(mesh, load, out, info):
    """H3's gradients, from plain tensors and from DTensors placed by TRAIN_RULES."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import blocks, optim
    from repro_torch.models.params import from_numpy
    from repro_torch.sharding import TRAIN_RULES, place_tree, placements_for, spec_for

    cfg = _cfg({"arch": "dbrx-132b"})
    named, data = load("moe.npz")
    specs = blocks.moe_specs(cfg)
    plain = from_numpy(named, "cpu")
    x = torch.from_numpy(data["x"])
    xspec = spec_for(tuple(x.shape), ("batch", "seq", "act_embed"), TRAIN_RULES, mesh)
    forms = {"plain": (plain, x),
             "train": (place_tree(plain, specs, TRAIN_RULES, mesh), distribute_tensor(x, mesh, placements_for(xspec, mesh)))}
    for form, (p, x) in forms.items():
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        xl = x.detach().requires_grad_()
        with optim.optimizations(mesh=mesh, shardmap_moe=True):
            y = blocks.moe_apply_shardmap(cfg, leaves, xl)
        grads = torch.autograd.grad((y * y).sum(), [*leaves.values(), xl])
        for n, g in zip([*leaves, "x"], grads):
            out[f"h3/{form}/{n}"] = (g.full_tensor() if optim.is_dtensor(g) else g).numpy()
        info[f"h3_{form}_grad_placements"] = [str(g.placements) if optim.is_dtensor(g) else "plain" for g in grads]


def optim_check(mesh, load, out, info):
    """``global_norm`` and AdamW on DTensors against the same plain tensors."""
    import torch

    from repro_torch.models.params import decoder_specs, from_numpy
    from repro_torch.sharding import TRAIN_RULES, place_tree
    from repro_torch.training import AdamW, AdamWState, global_norm

    named, data = load("optim.npz")
    cfg = _cfg({"arch": "llama3-8b"})
    specs = dict(decoder_specs(cfg))
    grads = {n: torch.from_numpy(data[f"g/{n}"]) for n in named}
    out["optim/norm_plain"] = global_norm(grads).numpy()
    out["optim/norm_dtensor"] = global_norm(place_tree(grads, specs, TRAIN_RULES, mesh)).numpy()
    moments = {k: {n: torch.from_numpy(data[f"{k}/{n}"]) for n in named} for k in ("mu", "nu")}
    for label, opt in (("clip", AdamW()), ("no_clip", AdamW(grad_clip=0.0))):
        plain = from_numpy(named, "cpu")
        placed = place_tree(from_numpy(named, "cpu"), specs, TRAIN_RULES, mesh)
        info["optim_init_placed_like_params"] = all(m.placements == placed[n].placements
                                                    for n, m in opt.init(placed).mu.items())
        state_p = AdamWState(0, *({n: t.clone() for n, t in moments[k].items()} for k in ("mu", "nu")))
        state_d = AdamWState(0, *(place_tree(moments[k], specs, TRAIN_RULES, mesh) for k in ("mu", "nu")))
        _, state_p = opt.update(grads, state_p, plain)
        _, state_d = opt.update(place_tree(grads, specs, TRAIN_RULES, mesh), state_d, placed)
        info[f"optim_{label}_bit_equal"] = all(
            torch.equal(placed[n].full_tensor(), plain[n]) and torch.equal(state_d.mu[n].full_tensor(), state_p.mu[n])
            and torch.equal(state_d.nu[n].full_tensor(), state_p.nu[n]) for n in named)
        info[f"optim_{label}_steps"] = [state_p.step, state_d.step]



def moe_gathers_check(mesh, load, info):
    """One reduced dbrx MoE layer (H3 off) on DTensors placed by
    ``TRAIN_RULES``, its forward and backward (of ``sum(y**2)``) counted
    (``op_costs.count``) at batches of 4 and of 8 (the layer's input twice
    over): each batch's collectives by kind, counts and bytes."""
    import numpy as np
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import op_costs
    from repro_torch.models import blocks, optim
    from repro_torch.models.lm import mesh_scope
    from repro_torch.models.params import from_numpy
    from repro_torch.sharding import TRAIN_RULES, place_tree, placements_for, spec_for

    cfg = _cfg({"arch": "dbrx-132b"})
    named, data = load("moe.npz")
    p = place_tree(from_numpy(named, "cpu"), blocks.moe_specs(cfg), TRAIN_RULES, mesh)
    info["moe_gathers"] = {}
    for b in (4, 8):
        x = torch.from_numpy(np.concatenate([data["x"]] * (b // data["x"].shape[0])))
        x = distribute_tensor(x, mesh, placements_for(spec_for(tuple(x.shape), ("batch", "seq", "act_embed"),
                                                                TRAIN_RULES, mesh), mesh))
        leaves = {n: t.detach().requires_grad_() for n, t in p.items()}
        xl = x.detach().requires_grad_()

        def layer():
            y = blocks.moe_apply(cfg, leaves, xl)
            return torch.autograd.grad((y * y).sum(), [*leaves.values(), xl])

        with optim.optimizations(mesh=mesh), mesh_scope(leaves):  # as the model runs it
            costs, _ = op_costs.count(layer)
        info["moe_gathers"][str(b)] = {"counts": costs.collective_counts, "bytes": costs.collective_bytes}


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
