"""The port's serving path against the JAX package's, on the CPU.

A small llama3-style config with GQA 4:1 (2 layers, d_model 128, 8 query
and 2 KV heads of 16, d_ff 256, vocab 512, rope_theta 500000; not
``reduced()``, which would collapse the GQA ratio to 1) in f32. The JAX
parameters cross with ``named_tensors`` -> numpy -> ``from_numpy``; then
the port's ``forward``, ``prefill`` (logits and cache) and a chain of
``decode`` steps must match the JAX ``DecoderLM``'s, JAX-sampled tokens
teacher-forced through the port must give the JAX logprobs, and a
``RolloutWorker`` served from a TensorHub replica must match the JAX
forward on v0 and, after ``update``, on v1. Tolerance 2e-5 (f32, as
``tests/test_kernels.py``) relative and absolute, unless stated.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.rl.loop import sample_responses as jax_sample  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs.llama3_8b import CONFIG as PORT_LLAMA  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy, init_params  # noqa: E402
from repro_torch.rl.loop import RLConfig, RolloutWorker, sample_responses  # noqa: E402

SMALL = dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, d_ff=256, vocab=512)
TOL = 2e-5
JAX_CFG = dataclasses.replace(get_config("llama3-8b"), **SMALL)
PORT_CFG = dataclasses.replace(PORT_LLAMA, **SMALL)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol,
    )


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(JAX_CFG)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    # the rotary embedding must show in the outputs: zero-init norms and
    # N(0, 1/fan_in) weights keep it, and ln gammas get noise so 1 + gamma
    # is exercised too
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(7)
    for k in named:
        if k.endswith("ln"):
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    jp = jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(named[k]) for k in named_tensors(jp)])
    return jm, jp, named, DecoderLM(PORT_CFG), from_numpy(named, "cpu")


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], size=(b, s)).astype(np.int32)


def test_rope_theta_carried():
    assert PORT_LLAMA.rope_theta == get_config("llama3-8b").rope_theta == 500_000.0
    assert PORT_CFG.rope_theta == JAX_CFG.rope_theta


def test_shapes_are_the_jax_param_names():
    assert decoder_shapes(PORT_CFG) == [
        (n, tuple(s.shape)) for n, s in named_tensors(JaxLM(JAX_CFG).param_specs()).items()
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32) * 3
    g = rng.standard_normal(128).astype(np.float32) * 0.1
    tol = TOL if dtype == "float32" else 2e-2
    if dtype == "bfloat16":
        x, g = x.astype(ml_dtypes.bfloat16), g.astype(ml_dtypes.bfloat16)
    got = layers.rms_norm(from_numpy({"x": x}, "cpu")["x"], from_numpy({"g": g}, "cpu")["g"])
    _close(got, jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(g)), tol)


@pytest.mark.parametrize("offset", [0, 37, 511, 4096])
@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_rope_matches(offset, head_dim):
    rng = np.random.default_rng(offset + head_dim)
    x = rng.standard_normal((2, 4, 6, head_dim)).astype(np.float32)
    pos = np.arange(6) + offset
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    _close(got, want)


def test_swiglu_matches():
    rng = np.random.default_rng(3)
    x, wg, wu, wd = (rng.standard_normal(s).astype(np.float32) * 0.3 for s in ((3, 64), (64, 96), (64, 96), (96, 64)))
    got = layers.swiglu(*(torch.from_numpy(a) for a in (x, wg, wu, wd)))
    _close(got, jax_layers.swiglu(*(jnp.asarray(a) for a in (x, wg, wu, wd))))


def test_forward_matches_jax(models):
    jm, jp, _, pm, pp = models
    toks = _tokens(0, 2, 13)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 13, SMALL["vocab"]) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_matches_jax(models):
    jm, jp, _, pm, pp = models
    toks = _tokens(1, 3, 9)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=16)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=16)
    assert pn == int(jn) == 9
    _close(pl, jl)
    for n in ("k", "v"):
        assert tuple(pc["layers"][n].shape) == jc["layers"][n].shape == (2, 3, 2, 16, 16)
        _close(pc["layers"][n], jc["layers"][n])


def test_decode_chain_matches_jax(models):
    jm, jp, _, pm, pp = models
    toks = _tokens(2, 2, 7)
    nxt = _tokens(3, 2, 5)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=12)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=12)
    for t in range(5):
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, t : t + 1]), jn)
        jn = jn + 1
        pl, pc = pm.decode(pp, pc, torch.from_numpy(nxt[:, t : t + 1]).long(), pn)
        pn += 1
        _close(pl, jl)
    for n in ("k", "v"):
        _close(pc["layers"][n], jc["layers"][n])
    # decode's logits are forward's at the same positions
    full = pm.forward(pp, {"tokens": torch.from_numpy(np.concatenate([toks, nxt], 1)).long()})
    _close(pl[:, 0], full[:, -1])


def _teacher_forced_logprobs(model, params, seqs, plen):
    """The port's prefill + decode driven with given tokens: the logprob
    of each token after the prompt."""
    seqs = torch.from_numpy(np.array(seqs)).long()
    logits, cache, n = model.prefill(params, {"tokens": seqs[:, :plen]}, max_len=seqs.shape[1])
    out = []
    for t in range(plen, seqs.shape[1]):
        lp = torch.log_softmax(logits[:, -1], -1)
        out.append(lp.gather(-1, seqs[:, t : t + 1])[:, 0])
        logits, cache = model.decode(params, cache, seqs[:, t : t + 1], n)
        n += 1
    return torch.stack(out, 1)


def test_jax_samples_teacher_forced_through_the_port(models):
    jm, jp, _, pm, pp = models
    prompts = jnp.asarray(_tokens(4, 3, 6))
    seqs, lps = jax_sample(jm, jp, prompts, 6, jax.random.PRNGKey(5))
    got = _teacher_forced_logprobs(pm, pp, np.asarray(seqs), 6)
    _close(got, lps)


def _jax_logprobs(jm, params, seqs, plen):
    logits = jm.forward(params, {"tokens": jnp.asarray(seqs)})
    lp = jax.nn.log_softmax(logits[:, plen - 1 : -1], -1)
    return np.take_along_axis(np.asarray(lp), np.asarray(seqs)[:, plen:, None], -1)[..., 0]


def test_port_samples_score_as_the_jax_forward(models):
    jm, jp, _, pm, pp = models
    prompts = torch.from_numpy(_tokens(6, 4, 5)).long()
    gen = torch.Generator().manual_seed(0)
    seqs, lps, kept = sample_responses(pm, pp, prompts, 7, gen, return_logits=True)
    assert seqs.shape == (4, 12) and lps.shape == (4, 7) and kept.shape == (4, 7, SMALL["vocab"])
    assert torch.equal(seqs[:, :5], prompts)
    _close(lps, _jax_logprobs(jm, jp, seqs.numpy(), 5))
    _close(kept, jm.forward(jp, {"tokens": jnp.asarray(seqs.numpy())})[:, 4:-1])
    # the same generator seed draws the same tokens
    again, _ = sample_responses(pm, pp, prompts, 7, torch.Generator().manual_seed(0))
    assert torch.equal(again, seqs)


def _v1(named):
    """1/8 of each tensor's 256-element rows perturbed (norms included)."""
    rng = np.random.default_rng(11)
    out = {}
    for k, w in named.items():
        flat = w.reshape(-1).copy()
        for r in range(0, -(-flat.size // 256), 8):
            seg = slice(r * 256, min((r + 1) * 256, flat.size))
            flat[seg] += rng.standard_normal(flat[seg].size).astype(np.float32) * 0.05
        out[k] = flat.reshape(w.shape)
    return out


def _jax_params(jp, named):
    return jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(named[k]) for k in named_tensors(jp)])


def _publisher(named):
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pub = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    pub.register(from_numpy(named, "cpu"))
    pub.publish(0)
    return hub, pub


def _publish_v1(pub, v1):
    pub.unpublish()
    for k, t in pub.store.tensors().items():  # in place, as a trainer step writes
        t.copy_(torch.from_numpy(v1[k]))
    pub.publish(1)


@pytest.mark.parametrize("dc", ["dc0", "dc1"])
def test_rollout_worker_serves_v0_then_v1(models, dc):
    """A publisher registers the carried-across JAX params v0; the worker
    replicates, serves, updates to v1 and serves again, from the same
    buffers. Over the WAN (dc1) the replica is int8-coded, so it is held
    to the JAX forward on its own decoded bytes."""
    jm, jp, named, _, _ = models
    hub, pub = _publisher(named)
    cfg = RLConfig(prompt_len=5, response_len=4, num_prompts=2, group_size=2)
    out = []
    w = RolloutWorker("rollout-0", hub, cfg, PORT_CFG, PromptSet(SMALL["vocab"], 5), out,
                      threading.Event(), datacenter=dc)
    assert w.device == torch.device("cpu")
    assert w.connect(timeout=30) == 0
    buffers = {k: t.data_ptr() for k, t in w.params.items()}
    v1 = _v1(named)
    for version, weights in ((0, named), (1, v1)):
        if version:
            _publish_v1(pub, v1)
            assert w.pull_latest() and w.weights_version == 1
            assert {k: t.data_ptr() for k, t in w.params.items()} == buffers
        held = {k: t.numpy().copy() for k, t in w.params.items()}
        if dc == "dc0":
            for k in weights:
                np.testing.assert_array_equal(held[k], weights[k])
        rec = w.serve_batch(version)
        assert rec["version"] == version and rec["tokens"].shape == (4, 9)
        assert rec["rewards"].shape == (4,)
        _close(rec["behavior_logprobs"], _jax_logprobs(jm, _jax_params(jp, held), rec["tokens"].numpy(), 5))
    assert len(out) == 2 and not w.pull_latest()


def test_rollout_worker_thread_loop(models):
    """``run``: the worker loops serve / update on its own thread and
    picks up v1 between batches."""
    _, _, named, _, _ = models
    hub, pub = _publisher(named)
    cfg = RLConfig(prompt_len=4, response_len=3, num_prompts=1, group_size=2)
    out, stop = [], threading.Event()
    w = RolloutWorker("rollout-t", hub, cfg, PORT_CFG, PromptSet(SMALL["vocab"], 4), out, stop)
    w.start()
    deadline = time.monotonic() + 60
    while not out and time.monotonic() < deadline:
        time.sleep(0.01)
    assert out and out[0]["version"] == 0
    _publish_v1(pub, _v1(named))
    while not any(r["version"] == 1 for r in list(out)) and time.monotonic() < deadline:
        time.sleep(0.01)
    stop.set()
    w.join(timeout=60)
    assert not w.is_alive() and w.error is None
    assert any(r["version"] == 1 for r in out)


def test_cpu_path_launches_no_kernel(models):
    _, _, _, pm, pp = models
    before = fa.LAUNCHES.value
    sample_responses(pm, pp, torch.from_numpy(_tokens(8, 2, 4)).long(), 3, torch.Generator().manual_seed(1))
    assert fa.LAUNCHES.value == before == 0


def test_init_params_follows_init_tree():
    g = torch.Generator().manual_seed(0)
    big = dataclasses.replace(PORT_CFG, d_model=256, d_ff=512)
    p = init_params(big, g, torch.bfloat16, "cpu")
    assert [(n, tuple(t.shape)) for n, t in p.items()] == decoder_shapes(big)
    for n, t in p.items():
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
        if n.endswith("ln"):
            assert not t.any()
        else:
            std = float(t.float().std())
            assert abs(std * np.sqrt(t.shape[-2]) - 1) < 0.05, n
    again = init_params(big, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert all(torch.equal(p[n], again[n]) for n in p)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        init_params(PORT_CFG, torch.Generator())
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        serve(PORT_CFG, requests=1, prompt_len=2, gen_len=1, rounds=1)


def test_serve_entry_point_on_the_cpu(capsys):
    rows = serve(PORT_CFG, requests=2, prompt_len=4, gen_len=3, rounds=2, device="cpu", dtype=torch.float32)
    assert [r["round"] for r in rows] == [0, 1] and all(r["tokens"] == 6 for r in rows)
    assert "replicate:" in capsys.readouterr().out
