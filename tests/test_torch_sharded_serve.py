"""The port's sharded serving steps on a 2x4 mesh of eight gloo processes,
on the CPU.

One run of eight processes (``tests/torch_serve_worker.py``, meeting
through a ``FileStore`` under the module's tmp dir, each at one thread)
serves every case: ``DecoderLM.prefill`` over parameters placed by
``SERVE_RULES`` (``place_tree``) and a prompt placed by ``("batch",
"seq")``, the cache made placed by the serve rules, then two ``decode``
steps, for reduced llama3-8b, gemma2-2b (window, softcaps, tied head),
dbrx and deepseek-v3 (MLA against its latent cache, a dense prefix layer,
the shared expert) with H3 off and on (``capacity_factor =
num_experts``, so that H3's per-rank capacity drops nothing) and
internvl2-2b (its patches placed before the prompt); and hubert-xlarge's
encode (its serving step: the logits of frames placed by ``("batch",
"seq", None)``). Inputs are drawn with numpy from a seed;
weights are the JAX init's, carried across with the port's ``from_numpy``.
The prefill's logits and cache and each step's logits and cache (the
encode's logits) are held to the one-device port's (f32, 1e-5 relative
L2 a tensor) and to the JAX ``DecoderLM.prefill``/``decode`` on the same
parameters (the parity contract's 2e-5 for f32, relative L2); the cache
lies placed on every rank (each holds its block, never the whole), and
the decode's attention saw each rank's local block.

In this process, on the 1x1 gloo smoke mesh: the hybrid and the xLSTM
refuse DTensor parameters in their prefill and decode by name ("the
sharded serving and train steps").
"""

import functools
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from procs import ProcSet  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import decoder_specs, from_numpy  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sharded_step import _jax_cfg, _jax_tree, _rel_l2, _weights  # noqa: E402
from torch_serve_worker import MAX_LEN, cache_entries  # noqa: E402
from torch_step_worker import _cfg  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402

WORLD = 8
DEADLINE = 300.0
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
]
BY_NAME = {c["name"]: c for c in CASES}
WORKER = os.path.join(os.path.dirname(__file__), "torch_serve_worker.py")


def _inputs(case):
    """The prompt [B, PROMPT] (a VLM's after its patches [B, P, d_model])
    and two decode steps' tokens [B, 1]; an encoder's frames [B, PROMPT,
    frontend_dim]."""
    rng = np.random.default_rng(11)
    cfg = get_config(case["arch"]).reduced()
    if cfg.encoder_only:
        return {"frames": rng.standard_normal((B, PROMPT, cfg.frontend_dim)).astype(np.float32)}
    draw = lambda shape: rng.integers(0, cfg.vocab, size=shape).astype(np.int32)  # noqa: E731
    out = {"tokens": draw((B, PROMPT)), "step0": draw((B, 1)), "step1": draw((B, 1))}
    if cfg.num_patches:
        out["patches"] = rng.standard_normal((B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def gloo_serve(tmp_path_factory):
    """The eight ranks' outputs: ``(rank 0's tensors, every rank's info)``."""
    work = tmp_path_factory.mktemp("gloo_serve")
    for case in CASES:
        named = _weights(case["arch"])
        np.savez(work / f"serve_{case['name']}.npz", **_inputs(case), **{f"p/{n}": v for n, v in named.items()})
    with open(work / "serve.json", "w") as fh:
        json.dump(CASES, fh)
    with ProcSet(str(work / "logs")) as procs:
        ranks = [procs.spawn(f"rank{r}", [sys.executable, WORKER, str(r), str(WORLD), str(work)]) for r in range(WORLD)]
        for rank in ranks:
            assert rank.wait(deadline=DEADLINE) == 0, procs.failure_report()
    infos = []
    for r in range(WORLD):
        with open(work / f"rank{r}.json") as fh:
            infos.append(json.load(fh))
    return dict(np.load(work / "serve.npz")), infos


@functools.lru_cache(maxsize=None)
def _reference(name, package):
    """``{"prefill/logits", "prefill/k", ..., "step1/v"}`` of one device: the
    port's or the JAX package's, from the case's weights and tokens."""
    case = BY_NAME[name]
    named = _weights(case["arch"])
    inp = _inputs(case)
    out = {}
    cfg = _cfg(case)
    max_len = MAX_LEN + cfg.num_patches
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


@pytest.mark.parametrize("package", ["port", "jax"])
@pytest.mark.parametrize("name", list(BY_NAME))
def test_sharded_prefill_and_decode_equal_one_device(gloo_serve, name, package):
    got, _ = gloo_serve
    want = _reference(name, package)
    tol = PORT_TOL if package == "port" else JAX_TOL
    assert set(want) == {k[len(name) + 1:] for k in got if k.startswith(name + "/")}
    for key, w in want.items():
        g = got[f"{name}/{key}"]
        assert g.shape == w.shape, key
        assert np.linalg.norm(w) > 0, key
        assert _rel_l2(g, w) <= tol, (key, _rel_l2(g, w))


@pytest.mark.parametrize("name", [c["name"] for c in CASES if not get_config(c["arch"]).encoder_only])
def test_the_cache_lies_placed_on_every_rank(gloo_serve, name):
    """Each rank holds its block of the cache, never the whole cache: a
    GQA cache's batch over the 2-way data axis and its KV heads or
    head_dim over the 4-way model axis; MLA's latent cache ([B, Smax, R]
    and [B, Smax, rd]: ``("batch", "seq", "kv_lora")``) its batch over the
    data axis, whole on every model rank. Each decode step's attention saw
    a rank's batch block and all of its slots; MLA's latent attention its
    block of the query heads (H / 4) beside it."""
    _, infos = gloo_serve
    cfg = _cfg(BY_NAME[name])
    layers = cfg.num_layers - (cfg.moe.first_dense if cfg.moe else 0)
    for info in infos:
        entries = info[f"{name}/cache"]
        if cfg.mla is None:
            assert set(entries) == {"k", "v"}
            for entry in entries.values():
                assert entry["global"] == [layers, B, cfg.num_kv_heads, MAX_LEN + cfg.num_patches,
                                           cfg.resolved_head_dim]
                assert np.prod(entry["local"]) * WORLD == np.prod(entry["global"]), entry
            calls = info[f"{name}/decode_attention"]
            assert len(calls) == 2 * cfg.num_layers
            for q, k in calls:
                assert q[0] == B // 2 and k[0] == B // 2 and k[2] == MAX_LEN + cfg.num_patches
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
    rank's block of the batch, every head of it (the heads replicated over
    the model axis, as GSPMD runs a dense layer without H1), over every
    frame."""
    _, infos = gloo_serve
    cfg = _cfg(BY_NAME["hubert-xlarge"])
    for info in infos:
        calls = info["hubert-xlarge/encode_attention"]
        assert len(calls) == cfg.num_layers
        for q, k in calls:
            assert q == [B // 2, cfg.num_heads, PROMPT, cfg.resolved_head_dim] and k == q


# -- the families without a sharded path ----------------------------------------------------


@pytest.fixture()
def smoke_mesh():
    import torch.distributed as dist

    from repro_torch.launch import make_smoke_mesh

    mesh = make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch,family", [("zamba2-2.7b", "hybrid"), ("xlstm-350m", "ssm")])
def test_other_families_refuse_sharded_serving_by_name(smoke_mesh, arch, family):
    """Prefill and decode of DTensor parameters raise
    ``NotImplementedError`` naming the family and "the sharded serving and
    train steps"; with plain parameters they serve as before."""
    from repro_torch.models.params import init_params
    from repro_torch.sharding import SERVE_RULES, place_tree

    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    placed = place_tree(params, dict(decoder_specs(cfg)), SERVE_RULES, smoke_mesh)
    model = build_model(cfg)
    match = rf"{cfg.name} \({family} family.*the sharded serving and train steps"
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 8))}
    with torch.no_grad():
        with pytest.raises(NotImplementedError, match=match):
            model.prefill(placed, batch)
        logits, cache, n = model.prefill(params, batch, max_len=8 + 1)
        with pytest.raises(NotImplementedError, match=match):
            model.decode(placed, cache, torch.randint(0, cfg.vocab, (2, 1)), n)
        logits, _ = model.decode(params, cache, torch.randint(0, cfg.vocab, (2, 1)), n)
    assert torch.isfinite(logits).all()
