"""The port's sharded serving steps on a 2x4 mesh of eight gloo processes,
on the CPU.

The cases run in four groups (``GROUPS``), each in its own run of eight
processes (``tests/torch_serve_worker.py``, meeting through a ``FileStore``
in the group's own tmp dir, each at one thread) under its own deadline,
started the first time a test asks for one of the group's cases: a group
that fails errors its own tests only. Each case: ``DecoderLM.prefill`` over parameters placed by
``SERVE_RULES`` (``place_tree``) and a prompt placed by ``("batch",
"seq")``, the cache made placed by the serve rules, then two ``decode``
steps, for reduced llama3-8b, gemma2-2b (window, softcaps, tied head),
dbrx and deepseek-v3 (MLA against its latent cache, a dense prefix layer,
the shared expert) with H3 off and on (``capacity_factor =
num_experts``, so that H3's per-rank capacity drops nothing) and
internvl2-2b (its patches placed before the prompt), zamba2-2.7b (the
hybrid: Mamba2 scans on each rank's batch and heads, the shared block's
attention) and xlstm-350m (mLSTM and sLSTM recurrences on each rank's
batch and heads); and hubert-xlarge's encode (its serving step: the logits
of frames placed by ``("batch", "seq", None)``). Two ``long`` cases run
at batch 1 under ``LONG_SERVE_RULES`` from an empty placed cache:
zamba2-2.7b's ring decode, 12 steps over the reduced window of 8 slots
sharded along its slots over the 2-way data axis (4 a data rank: the
second rank's block holds no valid slot for the first 4 steps, every rank
writes, and the ring wraps), its steps merged by the ranks' log-sum-exp,
and the same on a 2x2x2 ``("pod", "data", "model")`` mesh (the slots over
pod and data, 2 a rank, merged one mesh dimension at a time: for the
first 2 steps both blocks of a pod merge are empty); and xlstm-350m's 4
steps. One more case serves llama3-8b at batch 2 on the 2x2x2 mesh: a
batch that divides the data axis but not pod x data, its cache's batch
over the data axis alone. Inputs are drawn with numpy from a seed;
weights are the JAX init's, carried across with the port's ``from_numpy``.
The prefill's logits and cache and each step's logits and cache (the
encode's logits) are held to the one-device port's (f32, 1e-5 relative
L2 a tensor) and to the JAX package's ``prefill``/``decode`` (the ring's
``decode(..., ring=True)``) on the same parameters (the parity contract's
2e-5 for f32, relative L2); the cache lies placed on every rank (each
holds its block, never the whole), the decode's attention saw each rank's
local block, and the ring decode's collectives are the same at a window
of 8 and of 64 slots: none gathers the ring.
"""

import functools
import json
import os
import re
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from procs import ProcSet  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sharded_step import _jax_cfg, _jax_tree, _rel_l2, _weights, once  # noqa: E402
from torch_serve_worker import MAX_LEN, cache_entries  # noqa: E402
from torch_step_worker import _cfg  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402

WORLD = 8
PORT_TOL = 1e-5  # relative L2 a tensor, against the one-device port
JAX_TOL = 2e-5  # the parity contract's f32 tolerance, relative L2, against the JAX package
B, PROMPT = 8, 12

CASES = [
    dict(name="llama3-8b", arch="llama3-8b", h3=False),
    dict(name="gemma2-2b", arch="gemma2-2b", h3=False),
    dict(name="dbrx-132b_h3_off", arch="dbrx-132b", h3=False),
    dict(name="dbrx-132b_h3_on", arch="dbrx-132b", h3=True),
    dict(name="deepseek-v3-671b_h3_off", arch="deepseek-v3-671b", h3=False),
    dict(name="deepseek-v3-671b_h3_on", arch="deepseek-v3-671b", h3=True),
    dict(name="internvl2-2b", arch="internvl2-2b", h3=False),
    dict(name="hubert-xlarge", arch="hubert-xlarge", h3=False),
    dict(name="zamba2-2.7b", arch="zamba2-2.7b", h3=False),
    dict(name="xlstm-350m", arch="xlstm-350m", h3=False),
    dict(name="zamba2-2.7b_long", arch="zamba2-2.7b", h3=False, long=True, steps=12),
    dict(name="zamba2-2.7b_long_pods", arch="zamba2-2.7b", h3=False, long=True, steps=12, mesh="2x2x2"),
    dict(name="llama3-8b_pods", arch="llama3-8b", h3=False, mesh="2x2x2", batch=2),
    dict(name="xlstm-350m_long", arch="xlstm-350m", h3=False, long=True, steps=4),
]
BY_NAME = {c["name"]: c for c in CASES}
#: the cases by group, each group's eight ranks run apart under the group's
#: own deadline, seconds: at least 300 s, about 6x the group's time alone on
#: an idle 8-core CPU (dense 83 s, with the 2x2x2 case; moe 19 s;
#: vlm_encoder_xlstm 14 s; hybrid_long 18 s). Under the full suite's 6
#: pytest workers the groups ran 2.4-3.1x their time alone (dense 233 s)
GROUPS = {
    "dense": (["llama3-8b", "gemma2-2b", "llama3-8b_pods"], 510.0),
    "moe": (["dbrx-132b_h3_off", "dbrx-132b_h3_on", "deepseek-v3-671b_h3_off", "deepseek-v3-671b_h3_on"], 300.0),
    "vlm_encoder_xlstm": (["internvl2-2b", "hubert-xlarge", "xlstm-350m"], 300.0),
    "hybrid_long": (["zamba2-2.7b", "zamba2-2.7b_long", "zamba2-2.7b_long_pods", "xlstm-350m_long"], 300.0),
}
GROUP_OF = {name: group for group, (names, _) in GROUPS.items() for name in names}
assert sorted(GROUP_OF) == sorted(BY_NAME)
WORKER = os.path.join(os.path.dirname(__file__), "torch_serve_worker.py")


def _inputs(case):
    """The prompt [B, PROMPT] (a VLM's after its patches [B, P, d_model])
    and two decode steps' tokens [B, 1]; an encoder's frames [B, PROMPT,
    frontend_dim]; a ``long`` case's steps' tokens [1, 1]."""
    rng = np.random.default_rng(11)
    cfg = get_config(case["arch"]).reduced()
    if case.get("long"):
        return {f"step{i}": rng.integers(0, cfg.vocab, size=(1, 1)).astype(np.int32) for i in range(case["steps"])}
    b = case.get("batch", B)
    if cfg.encoder_only:
        return {"frames": rng.standard_normal((b, PROMPT, cfg.frontend_dim)).astype(np.float32)}
    draw = lambda shape: rng.integers(0, cfg.vocab, size=shape).astype(np.int32)  # noqa: E731
    out = {"tokens": draw((b, PROMPT)), "step0": draw((b, 1)), "step1": draw((b, 1))}
    if cfg.num_patches:
        out["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def gloo_serve(tmp_path_factory):
    """``serve(name)``: the outputs of the eight ranks that ran case
    ``name``'s group, ``(rank 0's tensors, every rank's info)``; each group
    runs once, when a test first asks for one of its cases."""

    @once
    def run(group):
        names, deadline = GROUPS[group]
        return run_group(tmp_path_factory.mktemp(f"gloo_serve_{group}"), [BY_NAME[n] for n in names], deadline)

    return lambda name: run(GROUP_OF[name])


def run_group(work, cases, deadline):
    """One group's eight ranks serving ``cases`` (their weights and inputs
    written to ``work``): ``(rank 0's tensors, every rank's info)``."""
    for case in cases:
        named = _weights(case["arch"])
        np.savez(work / f"serve_{case['name']}.npz", **_inputs(case), **{f"p/{n}": v for n, v in named.items()})
    with open(work / "serve.json", "w") as fh:
        json.dump(cases, fh)
    with ProcSet(str(work / "logs")) as procs:
        ranks = [procs.spawn(f"rank{r}", [sys.executable, WORKER, str(r), str(WORLD), str(work)])
                 for r in range(WORLD)]
        end = time.monotonic() + deadline
        for rank in ranks:
            assert rank.wait(deadline=max(end - time.monotonic(), 1.0)) == 0, procs.failure_report()
    infos = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as fh:
            infos.append(json.load(fh))
    return dict(np.load(work / "serve.npz")), infos


def _reference(name, package):
    return reference(json.dumps(BY_NAME[name], sort_keys=True), package)


@functools.lru_cache(maxsize=None)
def reference(case_json, package):
    """``{"prefill/logits", "prefill/k", ..., "step1/v"}`` of one device: the
    port's or the JAX package's, from the case's (a serve case as JSON)
    weights and tokens."""
    case = json.loads(case_json)
    named = _weights(case["arch"])
    inp = _inputs(case)
    out = {}
    cfg = _cfg(case)
    max_len = MAX_LEN + cfg.num_patches
    if case.get("long"):
        return _long_reference(case, cfg, named, inp, package)
    if package == "port":
        model = build_model(cfg)
        params = from_numpy(named, "cpu")
        batch = {k: torch.from_numpy(inp[k]) for k in ("patches", "frames") if k in inp}
        with torch.no_grad():
            if cfg.encoder_only:
                return {"encode/logits": model.forward(params, batch).numpy()}
            batch["tokens"] = torch.from_numpy(inp["tokens"]).long()
            logits, cache, n = model.prefill(params, batch, max_len=max_len)
            out["prefill/logits"] = logits.numpy()
            out.update({f"prefill/{k}": t.numpy().copy() for k, t in cache_entries(cache).items()})
            for step in range(2):
                logits, cache = model.decode(params, cache, torch.from_numpy(inp[f"step{step}"]).long(), n + step)
                out[f"step{step}/logits"] = logits.numpy()
                out.update({f"step{step}/{k}": t.numpy().copy() for k, t in cache_entries(cache).items()})
        return out
    jm = jax_build_model(_jax_cfg(case))
    tree = _jax_tree(jm, named)
    batch = {k: jnp.asarray(inp[k]) for k in ("tokens", "patches", "frames") if k in inp}
    if cfg.encoder_only:
        return {"encode/logits": np.asarray(jax.jit(jm.forward)(tree, batch))}
    logits, cache, n = jax.jit(lambda p, b: jm.prefill(p, b, max_len=max_len))(tree, batch)
    out["prefill/logits"] = np.asarray(logits)
    out.update({f"prefill/{k}": np.asarray(t) for k, t in cache_entries(cache).items()})
    decode = jax.jit(jm.decode)
    for step in range(2):
        logits, cache = decode(tree, cache, jnp.asarray(inp[f"step{step}"]), jnp.asarray(n + step))
        out[f"step{step}/logits"] = np.asarray(logits)
        out.update({f"step{step}/{k}": np.asarray(t) for k, t in cache_entries(cache).items()})
    return out


def _long_reference(case, cfg, named, inp, package):
    """A ``long`` case's steps from an empty cache on one device (the
    hybrid's over its ring cache), by the port or the JAX package."""
    ring = cfg.family == "hybrid"
    kw = dict(ring=True) if ring else {}
    out = {}
    if package == "port":
        model = build_model(cfg)
        params = from_numpy(named, "cpu")
        with torch.no_grad():
            cache = model.init_cache(1, MAX_LEN, torch.float32, "cpu", **kw)
            for i in range(case["steps"]):
                logits, cache = model.decode(params, cache, torch.from_numpy(inp[f"step{i}"]).long(), i, **kw)
                out[f"step{i}/logits"] = logits.numpy()
                out.update({f"step{i}/{k}": t.numpy().copy() for k, t in cache_entries(cache).items()})
        return out
    jm = jax_build_model(_jax_cfg(case))
    tree = _jax_tree(jm, named)
    cache = jm.init_cache(1, MAX_LEN, jnp.float32, **kw)
    decode = jax.jit(functools.partial(jm.decode, **kw))
    for i in range(case["steps"]):
        logits, cache = decode(tree, cache, jnp.asarray(inp[f"step{i}"]), jnp.asarray(i))
        out[f"step{i}/logits"] = np.asarray(logits)
        out.update({f"step{i}/{k}": np.asarray(t) for k, t in cache_entries(cache).items()})
    return out


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("name", list(BY_NAME))
def test_sharded_prefill_and_decode_equal_one_device(gloo_serve, name, package):
    got, _ = gloo_serve(name)
    want = _reference(name, package)
    tol = PORT_TOL if package == "port" else JAX_TOL
    assert set(want) == {k[len(name) + 1:] for k in got if k.startswith(name + "/")}
    for key, w in want.items():
        g = got[f"{name}/{key}"]
        assert g.shape == w.shape, key
        assert np.linalg.norm(w) > 0, key
        assert _rel_l2(g, w) <= tol, (key, _rel_l2(g, w))


@pytest.mark.parametrize("name", [c["name"] for c in CASES if not get_config(c["arch"]).encoder_only
                                  and not c.get("long") and "mesh" not in c])
def test_the_cache_lies_placed_on_every_rank(gloo_serve, name):
    """Each rank holds its block of the cache, never the whole cache: a
    GQA cache's batch over the 2-way data axis and its KV heads or
    head_dim over the 4-way model axis; MLA's latent cache ([B, Smax, R]
    and [B, Smax, rd]: ``("batch", "seq", "kv_lora")``) its batch over the
    data axis, whole on every model rank. Each decode step's attention saw
    a rank's batch block and all of its slots, on the cache's own KV heads
    (the reduced configs' 4 over the 4-way model axis: one a rank, beside
    its query heads, H / 4); MLA's latent attention its block of the query
    heads (H / 4) beside it."""
    _, infos = gloo_serve(name)
    cfg = _cfg(BY_NAME[name])
    layers = cfg.num_layers - (cfg.moe.first_dense if cfg.moe else 0)
    for info in infos:
        entries = info[f"{name}/cache"]
        if cfg.family in ("hybrid", "ssm"):
            # the recurrent states' batch over the data axis, their heads (the conv rows' channels) over the model
            # axis; the hybrid's shared block decoded on each rank's batch block, every slot
            for key, entry in entries.items():
                assert entry["local"][0] == entry["global"][0], key  # the stacked layers whole
                assert np.prod(entry["local"]) * WORLD == np.prod(entry["global"]), (key, entry)
            calls = info[f"{name}/decode_attention"]
            assert len(calls) == (2 * cfg.num_layers // cfg.ssm.shared_block_every if cfg.ssm else 0)
            for q, k in calls:
                assert q[:3] == [B // 2, cfg.num_heads // 4, 1] and k[:3] == [B // 2, cfg.num_kv_heads // 4, MAX_LEN]
            continue
        if cfg.mla is None:
            assert set(entries) == {"k", "v"}
            for entry in entries.values():
                assert entry["global"] == [layers, B, cfg.num_kv_heads, MAX_LEN + cfg.num_patches,
                                           cfg.resolved_head_dim]
                assert np.prod(entry["local"]) * WORLD == np.prod(entry["global"]), entry
            calls = info[f"{name}/decode_attention"]
            assert len(calls) == 2 * cfg.num_layers
            for q, k in calls:
                assert q[:3] == [B // 2, cfg.num_heads // 4, 1]
                assert k[:3] == [B // 2, cfg.num_kv_heads // 4, MAX_LEN + cfg.num_patches]
            continue
        m = cfg.mla
        prefix = [f"prefix{i}/{n}" for i in range(cfg.moe.first_dense) for n in ("ckv", "krope")]
        assert set(entries) == {"ckv", "krope", *prefix}
        for key, entry in entries.items():
            width = m.kv_lora_rank if key.endswith("ckv") else m.qk_rope_head_dim
            assert entry["global"][-3:] == [B, MAX_LEN, width], key
            assert entry["global"][:-3] == ([] if key.startswith("prefix") else [layers]), key
            assert entry["local"] == [*entry["global"][:-3], B // 2, MAX_LEN, width], key
        assert info[f"{name}/decode_attention"] == []
        calls = info[f"{name}/decode_latent_attention"]
        assert len(calls) == 2 * cfg.num_layers
        for q, ckv in calls:
            assert q == [B // 2, cfg.num_heads // 4, 1, m.kv_lora_rank] and ckv == [B // 2, MAX_LEN, m.kv_lora_rank]


def test_the_encode_attends_on_each_ranks_batch_block(gloo_serve):
    """hubert's encode (its serving step) attends bidirectionally on each
    rank's block of the batch and of the heads (its 4 KV heads lie over the
    4-way model axis, one a rank, and the attention runs where they lie,
    as the JAX package's partitioner runs it), over every frame."""
    _, infos = gloo_serve("hubert-xlarge")
    cfg = _cfg(BY_NAME["hubert-xlarge"])
    for info in infos:
        calls = info["hubert-xlarge/encode_attention"]
        assert len(calls) == cfg.num_layers
        for q, k in calls:
            assert q == [B // 2, cfg.num_heads // 4, PROMPT, cfg.resolved_head_dim] and k == q


# -- batch 1 under LONG_SERVE_RULES ------------------------------------------------------------


def _sharded_dims(placements):
    """The tensor dimension each mesh dimension shards (None: replicated),
    from the placements' text (``Shard(dim=3)`` or ``S(3)`` by the
    release)."""
    return [int(re.search(r"\d+", p).group()) if p.startswith("S") else None for p in placements]


def test_the_ring_lies_sharded_along_its_slots_and_merges_by_log_sum_exp(gloo_serve):
    """zamba2's ring cache [groups, 1, Hkv, 8, hd] lies sharded along its
    slots over the data axis (4 slots a rank) and its KV heads over the
    model axis, on every rank. Each rank attended over the valid slots of
    its own block only: the first data rank (slots 0-3) at every step,
    ``min(step + 1, 4)`` of them; the second (slots 4-7) from step 4 on,
    ``min(step - 3, 4)``, and not at all before (its block held no valid
    slot: no launch, an lse of -inf in the merge). One more step counted at
    a window of 8 and of 64 slots issues the same collectives, kind for
    kind and byte for byte: nothing that grows with the ring crosses the
    ranks."""
    _, infos = gloo_serve("zamba2-2.7b_long")
    cfg = _cfg(BY_NAME["zamba2-2.7b_long"])
    hkv, hd, groups = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers // cfg.ssm.shared_block_every
    for rank, info in enumerate(infos):
        rec = info["zamba2-2.7b_long"]
        for key in ("attn/k", "attn/v"):
            entry = rec["cache"][key]
            assert entry["global"] == [groups, 1, hkv, 8, hd]
            assert _sharded_dims(entry["placements"]) == [3, 2], entry  # slots over data, KV heads over model
            assert entry["local"] == [groups, 1, hkv // 4, 4, hd]
        first = rank // 4 * 4  # the data rank's first slot
        want = [[i, min(i + 1 - first, 4), [1, hkv // 4, 4, hd]] for i in range(12) for _ in range(groups)
                if i + 1 > first]
        assert rec["ring_calls"] == want, (rank, rec["ring_calls"])
        counted = rec["ring_collectives"]
        assert counted["8"] == counted["64"], counted
        assert counted["8"]["counts"]["all-gather"] >= groups  # the merges' gathers of (out, lse)


def test_the_xlstm_long_states_lie_placed_by_their_heads(gloo_serve):
    """xlstm-350m at batch 1: each recurrent state's heads over the 4-way
    model axis (the batch of 1 whole), on every rank."""
    _, infos = gloo_serve("xlstm-350m_long")
    for info in infos:
        entries = info["xlstm-350m_long"]["cache"]
        assert set(entries) == {"mlstm/c", "mlstm/n", "mlstm/m", "slstm/h", "slstm/c", "slstm/n", "slstm/m"}
        for key, entry in entries.items():
            assert np.prod(entry["local"]) * 4 == np.prod(entry["global"]), (key, entry)
            heads = {"mlstm": 3, "slstm": 2}[key.split("/")[0]]  # past the stacked layers and the batch
            assert _sharded_dims(entry["placements"]) == [None, heads], (key, entry)


def test_the_ring_over_pod_and_data_merges_one_mesh_dimension_at_a_time(gloo_serve):
    """On the 2x2x2 ``("pod", "data", "model")`` mesh zamba2's ring cache
    [groups, 1, Hkv, 8, hd] lies sharded along its slots over the pod and
    the data axes (block ``2 * pod + data`` of 2 slots on each rank) and
    its KV heads over the model axis. Each rank attended over the valid
    slots of its own block only, none before the ring reached it. For the
    first 2 steps the pod merge of blocks 1 and 3 sees no valid slot at
    all, and the steps' logits still equal the one-device port's
    (``test_sharded_prefill_and_decode_equal_one_device``)."""
    _, infos = gloo_serve("zamba2-2.7b_long_pods")
    cfg = _cfg(BY_NAME["zamba2-2.7b_long_pods"])
    hkv, hd, groups = cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_layers // cfg.ssm.shared_block_every
    for rank, info in enumerate(infos):
        rec = info["zamba2-2.7b_long_pods"]
        for key in ("attn/k", "attn/v"):
            entry = rec["cache"][key]
            assert entry["global"] == [groups, 1, hkv, 8, hd]
            assert _sharded_dims(entry["placements"]) == [3, 3, 2], entry  # slots over pod and data
            assert entry["local"] == [groups, 1, hkv // 2, 2, hd]
        first = 2 * (2 * (rank // 4) + rank // 2 % 2)  # the block's first slot
        want = [[i, min(i + 1 - first, 2), [1, hkv // 2, 2, hd]] for i in range(12) for _ in range(groups)
                if i + 1 > first]
        assert rec["ring_calls"] == want, (rank, rec["ring_calls"])
        counted = rec["ring_collectives"]
        assert counted["8"] == counted["64"], counted


def test_a_batch_that_divides_data_but_not_pod_and_data_stays_where_it_lies(gloo_serve):
    """llama3-8b at batch 2 on the 2x2x2 ``("pod", "data", "model")`` mesh:
    the batch divides the 2-way data axis but not pod x data, so the rules
    put the cache's batch over the data axis alone (the JAX ``spec_for``'s
    fallback to the trailing axes) and its 4 KV heads over the 2-way model
    axis, each pod holding a copy. Each decode step's attention runs where
    the cache lies, on a rank's batch block of 1 and its 2 KV heads with
    their query heads, over every slot, and the steps' logits equal the
    one-device port's and the JAX package's
    (``test_sharded_prefill_and_decode_equal_one_device``)."""
    _, infos = gloo_serve("llama3-8b_pods")
    cfg = _cfg(BY_NAME["llama3-8b_pods"])
    for info in infos:
        for key, entry in info["llama3-8b_pods/cache"].items():
            assert entry["global"] == [cfg.num_layers, 2, cfg.num_kv_heads, MAX_LEN, cfg.resolved_head_dim], key
            assert entry["local"] == [cfg.num_layers, 1, cfg.num_kv_heads // 2, MAX_LEN, cfg.resolved_head_dim], key
            assert _sharded_dims(entry["placements"]) == [None, 1, 2], entry  # pod replicated, batch over data
        calls = info["llama3-8b_pods/decode_attention"]
        assert len(calls) == 2 * cfg.num_layers
        for q, k in calls:
            assert q == [1, cfg.num_heads // 2, 1, cfg.resolved_head_dim]
            assert k == [1, cfg.num_kv_heads // 2, MAX_LEN, cfg.resolved_head_dim]
