"""The routed-expert FFN and the MoE decoder in the port against the JAX
package, on the CPU.

``moe_apply`` against the JAX ``moe_apply`` on reduced dbrx (8 experts,
top-2, d_expert 64) at the default capacity factor 1.25 and at 0.1, where
most pairs overflow: the same output and the same set of dropped (token,
slot) pairs, which the port's ``dispatch`` and the JAX package's sort
(``jnp.argsort``, ``searchsorted``) each give; ``DROPPED`` counts them. Both
against ``moe_dense_ref`` at ``capacity_factor = num_experts``, where no
pair drops. Reduced dbrx and a config with a shared expert and a dense
prefix layer (deepseek-v3's ``reduced()`` without MLA) against the JAX
``DecoderLM``: parameter names, shapes and order (``named_tensors``),
forward, prefill and a decode chain. A reduced dbrx served by a
``RolloutWorker`` from a replica. ``init_params`` of 4-D stacks.

The JAX weights cross with ``named_tensors`` -> numpy -> ``from_numpy``,
norm gammas given noise so ``1 + gamma`` shows. Tolerance 2e-5 in f32
(``tests/test_kernels.py``'s), relative and absolute, unless stated.
``torch.topk`` and ``jax.lax.top_k`` may order tied probabilities apart;
the inputs are continuous random draws, which do not tie.
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as jax_blocks  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy, init_params  # noqa: E402
from repro_torch.rl.loop import RLConfig, RolloutWorker  # noqa: E402

TOL = 2e-5
DENSE_REF_TOL = 1e-4  # tests/test_blocks.py's bound of moe_apply against moe_dense_ref
#: reduced dbrx, and deepseek-v3's reduced config without MLA: one shared
#: expert, one dense prefix layer
CONFIGS = {"dbrx": ("dbrx-132b", {}), "shared_prefix": ("deepseek-v3-671b", dict(mla=None))}


def _cfgs(key, **extra):
    arch, rep = CONFIGS[key]
    return (dataclasses.replace(jax_get_config(arch).reduced(), **rep, **extra),
            dataclasses.replace(get_config(arch).reduced(), **rep, **extra))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32),
        np.asarray(want, np.float32), rtol=tol, atol=tol,
    )


def _weights(jcfg):
    """The JAX model's random weights with noisy norm gammas, by name."""
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(7)
    for k in named:
        if k.endswith("ln"):
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    jp = jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(named[k]) for k in named_tensors(jp)])
    return jm, jp, named


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    jcfg, pcfg = _cfgs(request.param)
    jm, jp, named = _weights(jcfg)
    return request.param, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


# -- the MoE FFN alone ------------------------------------------------------------------


def _moe_layer(cfg_key, capacity_factor, seed=0, t=(2, 48)):
    """One MoE layer's weights (layer 0 of the stack) and an input."""
    jcfg, pcfg = (dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=capacity_factor))
                  for c in _cfgs(cfg_key))
    _, _, named = _weights(jcfg)
    layer = {n.split("/")[-1]: a[0] for n, a in named.items() if n.startswith("layers/ffn/")}
    x = np.random.default_rng(seed).standard_normal((*t, jcfg.d_model)).astype(np.float32)
    return jcfg, pcfg, layer, x


def _jax_dropped(jcfg, layer, x):
    """The (token, slot) pairs the JAX package's ``moe_apply`` drops: its
    routing and its sort, line for line (``repro/models/blocks.py``)."""
    mo = jcfg.moe
    t = x.shape[0] * x.shape[1]
    cap = max(int(t * mo.top_k / mo.num_experts * mo.capacity_factor), 1)
    cap = (cap + 7) // 8 * 8
    h = jax_blocks.rms_norm(jnp.asarray(x), jnp.asarray(layer["ln"])).reshape(t, -1)
    probs = jax.nn.softmax((h @ jnp.asarray(layer["router"])).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, mo.top_k)
    e_flat = top_e.reshape(-1)
    order = jnp.argsort(e_flat)
    e_sorted = e_flat[order]
    group_start = jnp.searchsorted(e_sorted, jnp.arange(mo.num_experts, dtype=e_sorted.dtype))
    pos_in_e = jnp.arange(t * mo.top_k) - group_start[e_sorted]
    return set(np.asarray(order)[np.asarray(pos_in_e >= cap)].tolist()), cap, np.asarray(top_e)


def _port_dropped(pcfg, layer, x):
    t = x.shape[0] * x.shape[1]
    cap = blocks.capacity(pcfg, t)
    flat = blocks.rms_norm(torch.from_numpy(x), layer["ln"]).reshape(t, -1)
    _, top_e = blocks.route(pcfg, layer, flat)
    order, dest = blocks.dispatch(top_e, pcfg.moe.num_experts, cap)
    return set(order[dest == pcfg.moe.num_experts * cap].tolist()), cap, top_e.numpy()


@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
@pytest.mark.parametrize("cfg_key", list(CONFIGS))
def test_moe_apply_matches_jax_and_drops_the_same_pairs(cfg_key, capacity_factor):
    jcfg, pcfg, layer, x = _moe_layer(cfg_key, capacity_factor)
    player = from_numpy(layer, "cpu")
    want_drop, jcap, jtop = _jax_dropped(jcfg, layer, x)
    got_drop, pcap, ptop = _port_dropped(pcfg, player, x)
    assert pcap == jcap
    np.testing.assert_array_equal(ptop, jtop)  # the same experts, in the same slots
    assert got_drop == want_drop
    if capacity_factor == 0.1:
        assert len(want_drop) > x.shape[0] * x.shape[1]  # most pairs overflow
    blocks.DROPPED.reset()
    got = blocks.moe_apply(pcfg, player, torch.from_numpy(x))
    assert (blocks.DROPPED.calls, blocks.DROPPED.routed, blocks.DROPPED.dropped) == (
        1, x.shape[0] * x.shape[1] * pcfg.moe.top_k, len(want_drop))
    _close(got, jax_blocks.moe_apply(jcfg, {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x)))


@pytest.mark.parametrize("cfg_key", list(CONFIGS))
def test_moe_apply_without_drops_matches_the_dense_oracle(cfg_key):
    """At capacity_factor = num_experts no expert can overflow: the sorted
    dispatch equals every expert on every token, masked (1e-4, as
    tests/test_blocks.py), on both sides."""
    jcfg0, _ = _cfgs(cfg_key)
    jcfg, pcfg, layer, x = _moe_layer(cfg_key, float(jcfg0.moe.num_experts))
    player = from_numpy(layer, "cpu")
    assert _port_dropped(pcfg, player, x)[0] == set()
    got = blocks.moe_apply(pcfg, player, torch.from_numpy(x))
    ref = blocks.moe_dense_ref(pcfg, player, torch.from_numpy(x))
    _close(got, ref, DENSE_REF_TOL)
    _close(ref, jax_blocks.moe_dense_ref(jcfg, {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x)))


def test_the_combine_is_deterministic_and_sums_in_slot_order():
    """The same call twice gives the same bits, and each token's output is
    its k weighted expert outputs summed over the slots in order."""
    _, pcfg, layer, x = _moe_layer("dbrx", 8.0, seed=3)  # no expert overflows
    player = from_numpy(layer, "cpu")
    xt = torch.from_numpy(x)
    a, b = blocks.moe_apply(pcfg, player, xt), blocks.moe_apply(pcfg, player, xt)
    assert torch.equal(a, b)
    flat = blocks.rms_norm(xt, player["ln"]).reshape(-1, pcfg.d_model)
    top_p, top_e = blocks.route(pcfg, player, flat)
    _, dest = blocks.dispatch(top_e, pcfg.moe.num_experts, blocks.capacity(pcfg, flat.shape[0]))
    assert bool((dest < pcfg.moe.num_experts * blocks.capacity(pcfg, flat.shape[0])).all())  # nothing dropped
    want = torch.zeros_like(flat)
    for slot in range(pcfg.moe.top_k):
        for e in range(pcfg.moe.num_experts):
            rows = top_e[:, slot] == e
            y = blocks.swiglu(flat[rows], player["w_gate"][e], player["w_up"][e], player["w_down"][e])
            want[rows] += y * top_p[rows, slot, None]
    _close(a - xt, want.view_as(xt))


def test_route_renormalises_the_top_k_in_f32():
    _, pcfg, layer, x = _moe_layer("dbrx", 1.25)
    player = {k: v.to(torch.bfloat16) for k, v in from_numpy(layer, "cpu").items()}
    flat = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, pcfg.d_model)
    top_p, top_e = blocks.route(pcfg, player, flat)
    assert top_p.dtype == torch.float32 and top_e.shape == (flat.shape[0], pcfg.moe.top_k)
    _close(top_p.sum(-1), torch.ones(flat.shape[0]), 1e-6)
    assert bool((top_p[:, 0] >= top_p[:, 1]).all())


@pytest.mark.parametrize("tokens,cf,want", [(2048, 1.25, 640), (4, 1.25, 8), (2112, 1.25, 664), (2304, 1.25, 720),
                                            (96, 0.1, 8), (1, 1.25, 8)])
def test_capacity_is_the_jax_rule(tokens, cf, want):
    """dbrx's calls on the card: a 4 x 512 prefill, a decode step of 4, a
    teacher-forced forward of 4 x 528, a training batch of 4 x 576."""
    cfg = get_config("dbrx-132b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    assert blocks.capacity(cfg, tokens) == want


# -- the MoE decoder -----------------------------------------------------------------------


def test_param_names_and_order_are_jax_named_tensors(models):
    key, _, _, named, pm, pp = models
    _, pcfg = _cfgs(key)
    assert decoder_shapes(pcfg) == [(n, tuple(a.shape)) for n, a in named.items()]
    assert list(pp) == list(named)
    mo = pcfg.moe
    assert pp["layers/ffn/w_gate"].shape == (pm.n_scan, mo.num_experts, pcfg.d_model, mo.d_expert)
    assert pp["layers/ffn/w_down"].shape == (pm.n_scan, mo.num_experts, mo.d_expert, pcfg.d_model)
    assert pp["layers/ffn/router"].shape == (pm.n_scan, pcfg.d_model, mo.num_experts)
    if key == "shared_prefix":
        assert (mo.num_shared, mo.first_dense, pm.n_prefix, pm.n_scan) == (1, 1, 1, pcfg.num_layers - 1)
        assert pp["prefix/0/ffn/w_gate"].shape == (pcfg.d_model, mo.d_ff_dense)
        assert pp["layers/ffn/shared_gate"].shape == (pm.n_scan, pcfg.d_model, mo.d_expert)
        prefix = [f"prefix/0/{n}" for n in ("attn/ln", "attn/wk", "attn/wo", "attn/wq", "attn/wv",
                                            "ffn/ln", "ffn/w_down", "ffn/w_gate", "ffn/w_up")]
        assert list(pp)[-len(prefix):] == prefix  # after "layers", as JAX sorts the keys
    else:
        assert not any(n.startswith("prefix/") or "shared" in n for n in pp)


def test_forward_matches_jax(models):
    _, jm, jp, _, pm, pp = models
    toks = _tokens(0, 2, 21)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 21, 256) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_matches_jax(models):
    _, jm, jp, _, pm, pp = models
    toks = _tokens(1, 3, 13)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=20)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=20)
    assert pn == int(jn) == 13
    _close(pl, jl)
    assert set(pc) == set(jc)
    for n in ("k", "v"):
        assert tuple(pc["layers"][n].shape) == jc["layers"][n].shape
        _close(pc["layers"][n], jc["layers"][n])
        for i, c in enumerate(pc.get("prefix", [])):
            _close(c[n], jc["prefix"][i][n])


def test_decode_chain_matches_jax(models):
    """12 decode steps after a 6-token prompt, each step routing 2 tokens
    (capacity 8: nothing drops)."""
    _, jm, jp, _, pm, pp = models
    toks, nxt = _tokens(2, 2, 6), _tokens(3, 2, 12)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=18)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=18)
    for t in range(12):
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, t : t + 1]), jn)
        jn = jn + 1
        pl, pc = pm.decode(pp, pc, torch.from_numpy(nxt[:, t : t + 1]).long(), pn)
        pn += 1
        _close(pl, jl)
    for n in ("k", "v"):
        _close(pc["layers"][n], jc["layers"][n])
        for i, c in enumerate(pc.get("prefix", [])):
            _close(c[n], jc["prefix"][i][n])


def test_rollout_worker_serves_dbrx_from_a_replica():
    """A RolloutWorker replicates a reduced dbrx and serves it with no code
    of its own for MoE: its logprobs are those of the JAX ``DecoderLM``
    replaying the same calls (the prefill of the prompts, then one decode
    step a sampled token). A teacher-forced forward of the whole sequences
    is no reference here: an expert's capacity follows each call's token
    count (the 4 x 5 prefill gives 8 rows an expert, a forward of 4 x 13
    gives 16), so the two drop other pairs."""
    jcfg, pcfg = _cfgs("dbrx")
    jm, jp, named = _weights(jcfg)
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pub = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    pub.register(from_numpy(named, "cpu"))
    pub.publish(0)
    plen, rlen = 5, 8
    cfg = RLConfig(prompt_len=plen, response_len=rlen, num_prompts=2, group_size=2)
    w = RolloutWorker("rollout-0", hub, cfg, pcfg, PromptSet(256, plen), [], threading.Event())
    assert w.connect(timeout=30) == 0
    for k, t in w.params.items():
        np.testing.assert_array_equal(t.numpy(), named[k])
    blocks.DROPPED.reset()
    rec = w.serve_batch(0)
    assert blocks.DROPPED.calls == pcfg.num_layers * (1 + rlen)
    seqs = rec["tokens"].numpy().astype(np.int32)
    logits, cache, n = jm.prefill(jp, {"tokens": jnp.asarray(seqs[:, :plen])}, max_len=plen + rlen)
    want = []
    for t in range(rlen):
        lp = jax.nn.log_softmax(logits[:, -1], -1)
        want.append(np.take_along_axis(np.asarray(lp), seqs[:, plen + t, None], -1)[:, 0])
        logits, cache = jm.decode(jp, cache, jnp.asarray(seqs[:, plen + t : plen + t + 1]), n)
        n = n + 1
    _close(rec["behavior_logprobs"], np.stack(want, 1))


# -- init --------------------------------------------------------------------------------------


def test_init_params_draws_4d_stacks_one_expert_at_a_time():
    """Shapes in registration order; every expert matrix of a 4-D stack
    drawn with std 1/sqrt(fan-in) (its own draw: no two equal); norms zero."""
    _, pcfg = _cfgs("shared_prefix", d_model=128)
    params = init_params(pcfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    assert [(n, tuple(t.shape)) for n, t in params.items()] == decoder_shapes(pcfg)
    for name, t in params.items():
        if name.endswith("ln"):
            assert not t.any(), name
            continue
        mats = t.view(-1, *t.shape[-2:])
        std = float(t.std())
        assert abs(std * np.sqrt(t.shape[-2]) - 1) < 0.1, (name, std)
        if t.dim() == 4:
            assert len({float(m[0, 0]) for m in mats}) == mats.shape[0], name
            for m in mats:
                assert abs(float(m.std()) * np.sqrt(t.shape[-2]) - 1) < 0.15, name
    bf = init_params(pcfg, torch.Generator().manual_seed(0), torch.bfloat16, "cpu")
    assert all(torch.equal(bf[n], params[n].to(torch.bfloat16)) for n in params)


def test_route_follows_given_experts_with_its_own_probabilities():
    _, pcfg, layer, x = _moe_layer("dbrx", 1.25)
    player = from_numpy(layer, "cpu")
    flat = blocks.rms_norm(torch.from_numpy(x), player["ln"]).reshape(-1, pcfg.d_model)
    top_p, top_e = blocks.route(pcfg, player, flat)
    same = blocks.route(pcfg, player, flat, top_e)
    assert torch.equal(same[1], top_e) and torch.equal(same[0], top_p)
    other = top_e.flip(-1).roll(1, 0)  # another token's experts, slots swapped
    got_p, got_e = blocks.route(pcfg, player, flat, other)
    probs = torch.softmax((flat @ player["router"]).float(), -1).gather(-1, other)
    assert torch.equal(got_e, other)
    _close(got_p, probs / probs.sum(-1, keepdim=True))
