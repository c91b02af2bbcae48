"""The dry run's traces on a fake process group, for ``tests/test_torch_dryrun.py``.

Run as ``python tests/torch_dryrun_worker.py <workdir> <part>``: a process
group of 512 fake ranks (``launch.dryrun.start_fake_world``) lives in this
process only, never in a pytest worker, and the xLSTM models this process
builds take an mLSTM chunk of ``MLSTM_CHUNK`` (``XLSTMLM``'s ``chunk``,
given by ``_cut_mlstm_chunk``, as ``reduced()`` cuts the hybrid's SSD
chunk), so that the xLSTM's length extension traces short lengths. The test starts the three parts
side by side; each writes ``<workdir>/<part>.json``. Part ``dense``
(llama3-8b's trips, the hand counts, the analytic prefill, the MLA decode
layer, the hybrid's ring decode layer, the xLSTM's length extension and
the leaves on the 16x16 mesh), part ``gated`` (gemma2-2b's, dbrx's and
deepseek-v3's trips, the leaves on the 2x16x16 mesh, the hybrid's shared
decode layer, the embedding lookup and its fallback), part ``pods`` (for
``tests/test_torch_train_pods.py``) and part ``all``:

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
* ``ring_decode``: one shared attention block of zamba2's ring decode on
  the 2x4 mesh under ``LONG_SERVE_RULES`` (batch 1, the ring sharded along
  its slots over the data axis) with rings of 64 and of 256 slots;
* ``seq_trips``: a narrowed xlstm-350m's train and prefill steps at
  ``SEQ_TRIP_TOKENS`` tokens on the 2x4 mesh, counted by ``analyze_cell``
  (traced at cut lengths, extended) and by one trace at the whole length;
* ``shared_decode``: one shared attention block of zamba2's decode over a
  plain cache on the 2x4 mesh under ``SERVE_RULES`` (its KV heads over the
  model axis), caches of 64 and of 256 slots;
* ``embed_lookup``: the embedding lookup of a table whose vocab lies over
  the model axis of the 2x4 mesh, at two vocabularies;
* ``lookup_fallback``: the placements of the lookup's result in five
  full-size cells on both production meshes, from DTensor's propagation
  and from the fallback taken where a release cannot propagate it;
* ``leaves``: every leaf of every live cell on the 16x16 and the 2x16x16
  meshes (built, not traced): its name, global shape and placements;
* ``pods``: a reduced zamba2-2.7b train step on ranks 0-7 as a 2x2x2
  ``("pod", "data", "model")`` mesh and as a 4x2 one, each one's counts;
* ``all``: ``launch.dryrun.main(["--all", ...])`` (``ALL_JOBS`` cells at
  once) over the registry's
  configs cut by ``reduced()`` (the families and the shapes as the
  registry's, the widths small): its exit code and each cell's JSON
  record.
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
    _cut_mlstm_chunk()
    dryrun.start_fake_world(512)
    mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
    if part == "dense":
        out = {"hand": _hand(mesh), "trips": _trips(mesh, ("llama3-8b",)), "dense": _dense(mesh),
               "leaves": {"single": _leaves(False)}, "mla_decode": _mla_decode_layer(mesh),
               "ring_decode": _ring_decode_layer(mesh), "seq_trips": _seq_trips(mesh)}
    elif part == "gated":
        out = {"trips": _trips(mesh, ("gemma2-2b", "dbrx-132b", "deepseek-v3-671b")),
               "leaves": {"multi": _leaves(True)}, "shared_decode": _shared_decode_layer(mesh),
               "embed_lookup": _embed_lookup(mesh), "lookup_fallback": _lookup_fallback()}
    elif part == "pods":
        out = {"pods": _pods()}
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


#: the ring's slots of the hybrid's ring decode layer, two lengths
RING_SLOTS = (64, 256)


def _ring_decode_layer(mesh) -> dict:
    """``op_costs.analyze`` of one shared attention block of zamba2's ring
    decode (``HybridLM._shared_block(..., ring=True)``, reduced zamba2: 4
    query and 4 KV heads of 16) on fake f32 blocks placed by
    ``LONG_SERVE_RULES`` on the 2x4 mesh: the block's parameters, the step's
    input ``[1, 1, d_model]`` and a ring of ``RING_SLOTS`` slots (its slots
    over the 2-way data axis, its KV heads over the 4-way model axis), the
    step past the ring's first turn, its output placed as its input; the
    attention through the kernel operator with the log-sum-exp (its fake).
    By ring length: the counts, and the calls the operator saw."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.launch import op_costs
    from repro_torch.models.lm import HybridLM, mesh_scope
    from repro_torch.models.params import decoder_specs, spec
    from repro_torch.sharding import LONG_SERVE_RULES, place_new

    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def block(shape):
        with fake:
            return torch.empty(shape, dtype=torch.float32)

    out = {}
    for slots in RING_SLOTS:
        cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(), sliding_window=slots)
        seen = []

        def attention(q, k, v, **kw):
            if kw.get("with_lse"):
                seen.append([list(q.shape), list(k.shape), kw["kv_len"]])
            return flash_attention_op(q, k, v, **kw)

        model = HybridLM(cfg, attention=attention)
        specs = {n: sp for n, sp in decoder_specs(cfg) if n.startswith(("shared_attn/", "shared_mlp/"))}
        params = place_new(specs, LONG_SERVE_RULES, mesh, block)
        x = place_new(spec((1, 1, cfg.d_model), ("batch", None, "act_embed")), LONG_SERVE_RULES, mesh, block)
        kv = spec((1, cfg.num_kv_heads, slots, cfg.resolved_head_dim), ("batch", "kv_heads", "seq", "head_dim"))
        cache = place_new({"k": kv, "v": kv}, LONG_SERVE_RULES, mesh, block)
        cache_len = 3 * slots + 5

        def step(p, x, c):
            with mesh_scope(p):
                positions = cache_len + torch.arange(1, device=x.device)
                y, _ = model._shared_block(model._shared(p), x, positions, cache=c, cache_len=cache_len, ring=True)
                return y.redistribute(mesh, x.placements)

        costs = op_costs.analyze(step, params, x, cache)
        out[str(slots)] = {"costs": costs.as_dict(), "calls": seen,
                           "placements": [str(p) for p in cache["k"].placements],
                           "cfg": {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
                                   "head_dim": cfg.resolved_head_dim}}
    return out


#: the cache's slots of the hybrid's shared decode layer, two lengths
SHARED_SLOTS = (64, 256)
#: its batch (over the 2-way data axis)
SHARED_BATCH = 8


def _shared_decode_layer(mesh) -> dict:
    """``op_costs.analyze`` of one shared attention block of zamba2's
    decode over a plain cache (``HybridLM._shared_block(..., ring=False)``,
    reduced zamba2: 4 query and 4 KV heads of 16) on fake bf16 blocks
    placed by ``SERVE_RULES`` on the 2x4 mesh: the block's parameters, the
    step's input ``[B, 1, d_model]`` and a cache of ``SHARED_SLOTS`` slots
    (its batch over the 2-way data axis, its KV heads over the 4-way model
    axis), the step at the last slot, its output placed as its input; the
    attention through the kernel operator (its fake). By cache length: the
    counts and the calls the operator saw."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_op
    from repro_torch.launch import op_costs
    from repro_torch.models.lm import HybridLM, mesh_scope
    from repro_torch.models.params import decoder_specs, spec
    from repro_torch.sharding import SERVE_RULES, place_new

    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def block(shape):
        with fake:
            return torch.empty(shape, dtype=torch.bfloat16)

    cfg = get_config("zamba2-2.7b").reduced()
    out = {}
    for slots in SHARED_SLOTS:
        seen = []

        def attention(q, k, v, **kw):
            seen.append([list(q.shape), list(k.shape)])
            return flash_attention_op(q, k, v, **kw)

        model = HybridLM(cfg, attention=attention)
        specs = {n: sp for n, sp in decoder_specs(cfg) if n.startswith(("shared_attn/", "shared_mlp/"))}
        params = place_new(specs, SERVE_RULES, mesh, block)
        x = place_new(spec((SHARED_BATCH, 1, cfg.d_model), ("batch", None, "act_embed")), SERVE_RULES, mesh, block)
        kv = spec((SHARED_BATCH, cfg.num_kv_heads, slots, cfg.resolved_head_dim),
                  ("batch", "kv_heads", "seq", "head_dim"))
        cache = place_new({"k": kv, "v": kv}, SERVE_RULES, mesh, block)

        def step(p, x, c):
            with mesh_scope(p):
                positions = slots - 1 + torch.arange(1, device=x.device)
                y, _ = model._shared_block(model._shared(p), x, positions, cache=c, cache_len=slots - 1)
                return y.redistribute(mesh, x.placements)

        costs = op_costs.analyze(step, params, x, cache)
        out[str(slots)] = {"costs": costs.as_dict(), "calls": seen,
                           "cfg": {"num_heads": cfg.num_heads, "num_kv_heads": cfg.num_kv_heads,
                                   "head_dim": cfg.resolved_head_dim, "d_model": cfg.d_model},
                           "batch": SHARED_BATCH}
    return out


#: the vocabularies of the embedding lookup, two sizes, and its tokens' batch and length
EMBED_VOCABS = (1024, 8192)
EMBED_TOKENS = (8, 4)


def _embed_lookup(mesh) -> dict:
    """``op_costs.analyze`` of the embedding lookup (``lm._embed_rows``) of
    a bf16 table ``[vocab, 64]`` placed by ``SERVE_RULES`` (its vocab over
    the 4-way model axis) on the 2x4 mesh, for tokens ``[8, 4]`` placed by
    ``("batch", "seq")``, at the vocabularies of ``EMBED_VOCABS``: the
    counts by vocabulary."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import op_costs
    from repro_torch.models.lm import _embed_rows, mesh_scope
    from repro_torch.models.params import spec
    from repro_torch.sharding import SERVE_RULES, place_new

    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def made(dtype):
        def block(shape):
            with fake:
                return torch.empty(shape, dtype=dtype)

        return block

    out = {}
    for vocab in EMBED_VOCABS:
        table = place_new(spec((vocab, 64), ("vocab", "embed")), SERVE_RULES, mesh, made(torch.bfloat16))
        tokens = place_new(spec(EMBED_TOKENS, ("batch", "seq")), SERVE_RULES, mesh, made(torch.int64))

        def lookup(t, tok):
            with mesh_scope({"embed": t}):
                return _embed_rows(t, tok)

        costs = op_costs.analyze(lookup, table, tokens)
        out[str(vocab)] = {"costs": costs.as_dict(), "placements": [str(p) for p in table.placements]}
    return out


#: full-size cells whose embedding lookup's placements are compared, both meshes
FALLBACK_CELLS = (("llama3-8b", "decode_32k"), ("llama3-8b", "train_4k"), ("gemma2-2b", "train_4k"),
                  ("zamba2-2.7b", "long_500k"), ("xlstm-350m", "prefill_32k"))


def _lookup_fallback() -> dict:
    """For each of ``FALLBACK_CELLS`` on the 16x16 and the 2x16x16 meshes
    (built at a cut depth, not traced): the placements
    ``lm._lookup_placements`` gives the lookup's result from DTensor's
    propagation, and those of its fallback (the propagation made to
    raise, as PyTorch 2.11's does on tokens split over two mesh
    dimensions)."""
    from unittest import mock

    from torch.distributed.tensor import DTensor

    from repro_torch.launch import cells, dryrun
    from repro_torch.models import lm

    out = {}
    for multi in (False, True):
        prod = dryrun.device_mesh(dryrun.make_production_mesh(multi_pod=multi))
        for arch, shape in FALLBACK_CELLS:
            cell = cells.build_cell(arch, shape, prod, layers={"zamba2-2.7b": 6, "xlstm-350m": 2}.get(arch, 1))
            table = cell.in_structs[0]["embed"]
            tokens = cell.in_structs[2] if cell.kind == "decode" else cell.in_structs[-1]["tokens"]
            probed = lm._lookup_placements(table, tokens)
            with mock.patch.object(DTensor, "__getitem__", side_effect=RuntimeError("propagation failed")):
                fallback = lm._lookup_placements(table, tokens)
            out[f"{arch}/{shape}/{'multi' if multi else 'single'}"] = [[str(p) for p in probed],
                                                                       [str(p) for p in fallback]]
    return out


#: the mLSTM's chunk of the xLSTM models this process builds (the JAX
#: package's is 256): the period of the xLSTM's length extension, so the
#: lengths traced stay short
MLSTM_CHUNK = 16


def _cut_mlstm_chunk() -> None:
    """Every xLSTM model this process builds (``models.build_model``, as
    ``launch.cells`` builds a cell's model) takes ``chunk=MLSTM_CHUNK``."""
    from repro_torch import models
    from repro_torch.configs.base import SSM

    build = models.build_model

    def cut(cfg, **kw):
        return build(cfg, **({"chunk": MLSTM_CHUNK, **kw} if cfg.family == SSM else kw))

    models.build_model = cut
#: the narrowed xlstm-350m of the length extension's trips, and its cases
SEQ_TRIP_LAYERS = 2
SEQ_TRIP_TOKENS = 10 * MLSTM_CHUNK


def _seq_trips(mesh) -> dict:
    """A narrowed xlstm-350m (one mLSTM and one sLSTM block) at
    ``SEQ_TRIP_TOKENS`` tokens, train and prefill, on the 2x4 mesh:
    ``analyze_cell``'s counts (cut lengths, extended) beside one trace at
    the whole length."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import cells, op_costs

    cfg = dataclasses.replace(get_config("xlstm-350m").reduced(), num_layers=SEQ_TRIP_LAYERS)
    out = {}
    for shape, case in (("prefill_32k", ShapeCase("prefill_32k", SEQ_TRIP_TOKENS, 4, "prefill")),
                        ("train_4k", ShapeCase("train_4k", SEQ_TRIP_TOKENS, 8, "train"))):
        t0 = time.perf_counter()
        ext = op_costs.analyze_cell("xlstm-350m", shape, mesh, cfg=cfg, case=case)
        full = cells.build_cell("xlstm-350m", shape, mesh, cfg=cfg, case=case).trace(mesh)
        out[shape] = {"extended": ext["costs"].as_dict(), "full": full["costs"].as_dict(),
                      "seq_lens": ext.get("seq_lens"), "seq_times": ext.get("seq_times"), "tokens": case.seq_len,
                      "seconds": time.perf_counter() - t0}
    return out


def _leaves(multi_pod: bool) -> dict:
    """Every leaf of every live cell on the 16x16 or the 2x16x16 mesh
    (built, not traced)."""
    from repro_torch.launch import cells, dryrun

    prod = dryrun.device_mesh(dryrun.make_production_mesh(multi_pod=multi_pod))
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


#: the multi-pod check's reduced arch and train step (batch, tokens)
PODS_ARCH, PODS_BATCH, PODS_SEQ = "zamba2-2.7b", 8, 32


def _pods() -> dict:
    """A reduced ``PODS_ARCH`` train step on fake ranks 0-7 laid out as a
    2x2x2 ``("pod", "data", "model")`` mesh and as a 4x2 ``("data",
    "model")`` one: each mesh's counts and trace seconds."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.launch import cells

    meshes = {"2x2x2": DeviceMesh("cpu", torch.arange(8).reshape(2, 2, 2), mesh_dim_names=("pod", "data", "model")),
              "4x2": DeviceMesh("cpu", torch.arange(8).reshape(4, 2), mesh_dim_names=("data", "model"))}
    case = ShapeCase("train_4k", PODS_SEQ, PODS_BATCH, "train")
    out = {}
    for name, mesh in meshes.items():
        t0 = time.perf_counter()
        rec = cells.build_cell(PODS_ARCH, "train_4k", mesh, cfg=get_config(PODS_ARCH).reduced(), case=case).trace(mesh)
        out[name] = {"costs": rec["costs"].as_dict(), "seconds": time.perf_counter() - t0}
    return out


#: the cells ``--all`` traces at once (forked processes)
ALL_JOBS = 2


def _all(workdir: str) -> dict:
    """``dryrun.main(["--all", ..., "--jobs", ALL_JOBS])`` with every config
    cut by ``reduced()``."""
    from repro_torch import configs
    from repro_torch.launch import cells, dryrun

    real = configs.get_config

    def reduced(arch):
        return real(arch).reduced()

    for mod in (configs, dryrun, cells):
        mod.get_config = reduced
    out_dir = os.path.join(workdir, "all")
    rc = dryrun.main(["--all", "--mesh", "single", "--out", out_dir, "--jobs", str(ALL_JOBS)])
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
