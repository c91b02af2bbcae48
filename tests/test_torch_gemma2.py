"""gemma2 in the port against the JAX package, on the CPU.

A small gemma2 (4 layers, d_model 128, 4 query and 2 KV heads of 32, d_ff
256, vocab 512, window 8, softcaps 50 and 30, tied embeddings, the
post-norms) in f32: the JAX parameters cross with ``named_tensors`` ->
numpy -> ``from_numpy`` (``ln`` gammas given noise so ``1 + gamma`` shows),
then the port's ``forward``, ``prefill`` and a decode chain of 24 steps,
longer than the window, must match the JAX ``DecoderLM``'s, and a
``RolloutWorker`` serving it from a TensorHub replica must give the JAX
forward's logprobs. The windowed attention: ``attention_plain`` and
``split_kv_plain`` against ``reference_attention``, ``chunked_attention``
and ``attention_ref`` (windows of 1, 8 and wider than Sk, with offsets,
``kv_len`` and the softcap), and ``attention_backward_plain`` and the
``FlashAttention`` Function against ``jax.grad`` of ``chunked_attention``
with q scaled so the softcap bites. A gemma2 replica's manifests and bytes
equal the JAX package's. Tolerance 2e-5 (f32, as ``tests/test_kernels.py``)
relative and absolute.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jax_core  # noqa: E402
import repro.transfer.codec as jax_codec  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.models.layers import chunked_attention, reference_attention  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy  # noqa: E402
from repro_torch.rl.loop import RLConfig, RolloutWorker  # noqa: E402

SMALL = dict(num_layers=4, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256, vocab=512,
             sliding_window=8)
TOL = 2e-5
JAX_CFG = dataclasses.replace(jax_get_config("gemma2-2b"), **SMALL)
PORT_CFG = dataclasses.replace(get_config("gemma2-2b"), **SMALL)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol,
    )


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jm = JaxLM(JAX_CFG)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(7)
    for k in named:
        if k.endswith("ln"):  # ln, post_ln and final_ln: 1 + gamma exercised
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    jp = jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(named[k]) for k in named_tensors(jp)])
    return jm, jp, named, build_model(PORT_CFG), from_numpy(named, "cpu")


def test_config_is_the_jax_gemma2():
    assert dataclasses.asdict(PORT_CFG) == dataclasses.asdict(JAX_CFG)
    assert PORT_CFG.tie_embeddings and PORT_CFG.alt_local_global
    assert (PORT_CFG.attn_softcap, PORT_CFG.logit_softcap) == (50.0, 30.0)


def test_param_names_follow_the_jax_specs(models):
    _, _, named, pm, pp = models
    assert list(pp) == list(named)
    assert decoder_shapes(PORT_CFG) == [(n, tuple(a.shape)) for n, a in named.items()]
    assert "head" not in pp and "layers/attn/post_ln" in pp and "layers/ffn/post_ln" in pp
    assert pm.windows == [8, 0, 8, 0]


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap_matches(cap):
    from repro.models.layers import softcap as jax_softcap

    x = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32) * 60
    _close(layers.softcap(torch.from_numpy(x), cap), jax_softcap(jnp.asarray(x), cap))


def test_forward_matches_jax(models):
    jm, jp, _, pm, pp = models
    toks = _tokens(0, 2, 21)  # longer than the window
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 21, SMALL["vocab"]) and got.dtype == torch.float32
    assert float(got.abs().max()) < 30.0  # the logit softcap
    _close(got, want)


def test_prefill_matches_jax(models):
    jm, jp, _, pm, pp = models
    toks = _tokens(1, 3, 13)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=20)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=20)
    assert pn == int(jn) == 13
    _close(pl, jl)
    for n in ("k", "v"):
        assert tuple(pc["layers"][n].shape) == jc["layers"][n].shape == (4, 3, 2, 20, 32)
        _close(pc["layers"][n], jc["layers"][n])


def test_decode_chain_across_the_window_matches_jax(models):
    """24 decode steps after a 6-token prompt: the even layers' window of 8
    slides past the prompt and past the first decoded tokens."""
    jm, jp, _, pm, pp = models
    toks = _tokens(2, 2, 6)
    nxt = _tokens(3, 2, 24)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=30)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=30)
    for t in range(24):
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, t : t + 1]), jn)
        jn = jn + 1
        pl, pc = pm.decode(pp, pc, torch.from_numpy(nxt[:, t : t + 1]).long(), pn)
        pn += 1
        _close(pl, jl)
    for n in ("k", "v"):
        _close(pc["layers"][n], jc["layers"][n])
    full = pm.forward(pp, {"tokens": torch.from_numpy(np.concatenate([toks, nxt], 1)).long()})
    _close(pl[:, 0], full[:, -1])


def test_rollout_worker_serves_gemma2_from_a_replica(models):
    jm, jp, named, _, _ = models
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pub = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    pub.register(from_numpy(named, "cpu"))
    pub.publish(0)
    cfg = RLConfig(prompt_len=5, response_len=12, num_prompts=2, group_size=2)
    w = RolloutWorker("rollout-0", hub, cfg, PORT_CFG, PromptSet(SMALL["vocab"], 5), [], threading.Event())
    assert w.connect(timeout=30) == 0
    for k, t in w.params.items():
        np.testing.assert_array_equal(t.numpy(), named[k])
    rec = w.serve_batch(0)
    seqs = rec["tokens"].numpy()
    logits = jm.forward(jp, {"tokens": jnp.asarray(seqs)})
    lp = jax.nn.log_softmax(logits[:, 4:-1], -1)
    want = np.take_along_axis(np.asarray(lp), seqs[:, 5:, None], -1)[..., 0]
    _close(rec["behavior_logprobs"], want)


# -- the windowed attention -------------------------------------------------------------

#: (b, hq, hkv, sq, sk, d, causal, q_offset, kv_len, window, softcap)
CASES = [
    (2, 4, 2, 40, 40, 16, True, 0, None, 1, 0.0),  # each row sees only itself
    (2, 4, 2, 40, 40, 16, True, 0, None, 8, 50.0),  # gemma2's reduced window, softcap
    (1, 8, 2, 33, 33, 32, True, 0, None, 100, 0.0),  # wider than Sk: unlimited
    (2, 4, 1, 16, 96, 32, True, 60, 76, 8, 0.0),  # offset chunk, kv_len < Sk
    (2, 4, 2, 1, 80, 16, True, 70, 71, 8, 30.0),  # a decode step
    (1, 4, 4, 24, 64, 16, False, 0, 50, 8, 0.0),  # not causal, kv_len
    (2, 8, 2, 20, 200, 64, True, 150, 170, 1, 0.0),  # window 1, offset chunk
    (1, 8, 4, 70, 70, 32, True, 0, None, 8, 5.0),  # softcap that bends, G 2
]
IDS = ["x".join(map(str, c)) for c in CASES]


def _inputs(case, seed=0, q_scale=1.0):
    b, hq, hkv, sq, sk, d, *_ = case
    rng = np.random.default_rng(seed + sq * 7 + d)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)))
    return q * np.float32(q_scale), k, v, do


def _kw(case):
    *_, causal, q_offset, kv_len, window, cap = case
    return dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=cap)


def _jax_kw(kw):
    return dict(causal=kw["causal"], window=kw["window"], q_offset=kw["q_offset"],
                kv_len=None if kw["kv_len"] is None else jnp.asarray(kw["kv_len"]), attn_softcap=kw["softcap"])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_attention_plain_matches_the_jax_oracles(case):
    q, k, v, _ = _inputs(case, q_scale=4.0)
    kw = _kw(case)
    got = fa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, reference_attention(jq, jk, jv, **_jax_kw(kw)))
    _close(got, chunked_attention(jq, jk, jv, block_k=16, **_jax_kw(kw)))
    if kw["q_offset"] == 0 and kw["kv_len"] is None:
        _close(got, attention_ref(jq, jk, jv, causal=kw["causal"], window=kw["window"], softcap=kw["softcap"]))


@pytest.mark.parametrize("keys_per_split", [None, 8, 64])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_split_kv_plain_matches_the_jax_oracle(case, keys_per_split):
    """The decode kernel's algorithm over [live_start, live_end): splits in
    which a row sees no key (a window's first ones) drop out of the merge."""
    q, k, v, _ = _inputs(case, seed=4, q_scale=4.0)
    kw = _kw(case)
    got = fa.split_kv_plain(*(torch.from_numpy(a) for a in (q, k, v)), keys_per_split=keys_per_split, **kw)
    _close(got, reference_attention(*(jnp.asarray(a) for a in (q, k, v)), **_jax_kw(kw)))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_backward_plain_matches_jax_grad_of_chunked_attention(case):
    q, k, v, dout = _inputs(case, seed=1, q_scale=8.0)  # scores well inside the softcap's bend
    kw = _kw(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = fa.attention_plain(tq, tk, tv, **kw)
    lse = fa.attention_lse_plain(tq, tk, **kw)
    got = fa.attention_backward_plain(tq, tk, tv, out, lse, tdo, **kw)

    def f(q, k, v):
        return jnp.sum(chunked_attention(q, k, v, block_k=16, **_jax_kw(kw)) * dout)

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_windowed_function_on_the_cpu_equals_autograd_of_plain(case):
    """The Function's CPU wiring as the model calls it, window included."""
    q, k, v, dout = _inputs(case, seed=2, q_scale=8.0)
    kw = _kw(case)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, torch.from_numpy(dout))
    for g, w in zip(got, want):
        _close(g, w)


def test_window_wider_than_the_keys_changes_nothing():
    q, k, v, _ = _inputs(CASES[2])
    t = [torch.from_numpy(a) for a in (q, k, v)]
    assert torch.equal(fa.attention_plain(*t, window=33), fa.attention_plain(*t))
    assert torch.equal(fa.attention_plain(*t, window=-1), fa.attention_plain(*t))


@pytest.mark.parametrize("q_offset,window,want", [(0, 0, 0), (0, 8, 0), (7, 8, 0), (8, 8, 1), (4607, 4096, 512),
                                                  (100, 1, 100), (5, -3, 0)])
def test_live_start(q_offset, window, want):
    assert fa.live_start(q_offset, window) == want


def test_split_plan_cuts_the_live_range_only():
    # a decode step at position 4671 with gemma2's window: 4096 live keys
    assert fa.split_plan(4672, 4 * 4, fa.live_start(4671, 4096)) == fa.split_plan(4096, 4 * 4)
    keys, nsplit = fa.split_plan(4672, 4 * 4, 576)
    assert (nsplit - 1) * keys < 4672 - 576 <= nsplit * keys


def test_a_window_that_leaves_a_row_no_key_is_refused():
    q, k = torch.zeros(1, 2, 4, 16), torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="no key"):
        fa.attention_plain(q, k, k, q_offset=40, kv_len=30, window=8)
    fa.attention_plain(q, k, k, q_offset=40, kv_len=37, window=8)  # the last row sees key 36


@pytest.mark.parametrize("dtype,d,route", [(torch.bfloat16, 128, "tensor_core"), (torch.bfloat16, 64, "tensor_core"),
                                           (torch.float32, 128, "cuda_core"), (torch.bfloat16, 32, "cuda_core")])
def test_the_tensor_core_backward_refuses_a_window(dtype, d, route):
    """Both backward routes take a window now: a windowed call passes the
    checks on its route (meta tensors take the CUDA branch) and stops only
    at the device check, through the Function and named."""
    q = torch.empty((2, 8, 64, d), dtype=dtype, device="meta")
    k = torch.empty((2, 2, 64, d), dtype=dtype, device="meta")
    assert fa._bwd_route(q) == route
    fa._check_backward(q)
    lse = torch.empty((2, 8, 64), device="meta")
    with pytest.raises(TypeError, match="unsupported device"):
        fa.launch_backward(q, k, k, q, lse, q, window=8, route=route)
    with pytest.raises(TypeError, match="unsupported device"):
        fa.flash_attention(q.requires_grad_(), k, k, window=8)


# -- the transfer path ---------------------------------------------------------------------


def _gemma2_weights():
    """bf16 v0 of a gemma2 at the test's widths (vocab 4096 so the tied
    embedding is a chunked unit of its own), by the JAX names."""
    cfg = dataclasses.replace(JAX_CFG, vocab=4096)
    rng = np.random.default_rng(0)
    return {n: (rng.standard_normal(s.shape) * 0.02).astype(ml_dtypes.bfloat16)
            for n, s in named_tensors(JaxLM(cfg).param_specs()).items()}


def _replicate(core, weights, make):
    server = core.ReferenceServer()
    hub = core.TensorHubClient(server, chunk_bytes=1 << 18, **({"device": "cpu"} if core is port_core else {}))
    trainer = hub.open("g", "trainer", 1, 0, datacenter="dc0")
    trainer.register(make(weights))
    trainer.publish(0)
    reps = {}
    for name, dc in (("rollout-0", "dc0"), ("rollout-1", "dc1")):
        h = hub.open("g", name, 1, 0, datacenter=dc)
        h.register(make({k: np.zeros_like(v) for k, v in weights.items()}))
        assert h.replicate(0, timeout=60) == 0
        reps[name] = h.store.tensors()
    manifests = {r: dataclasses.astuple(server.replica_manifest("g", 0, r, 0))
                 for r in ("trainer", "rollout-0", "rollout-1")}
    return manifests, reps, dict(hub.transport.wire_bytes)


def test_a_gemma2_replica_has_the_jax_manifests_and_bytes():
    weights = _gemma2_weights()
    assert list(weights) == [n for n, _ in decoder_shapes(dataclasses.replace(PORT_CFG, vocab=4096))]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_codec.Int8Codec, "_resolve_jax", lambda self: None)
    try:
        jm, jr, jw = _replicate(jax_core, weights, lambda w: {k: a.copy() for k, a in w.items()})
    finally:
        mp.undo()
    pm, pr, pw = _replicate(port_core, weights, lambda w: from_numpy(w, "cpu"))
    assert pm == jm and pw == jw
    for rep in ("rollout-0", "rollout-1"):
        for name, arr in jr[rep].items():
            got = pr[rep][name].reshape(-1).view(torch.uint8).numpy().tobytes()
            assert got == np.ascontiguousarray(arr).view(np.uint8).tobytes(), (rep, name)
