"""Multi-head latent attention (deepseek-v3) in the port against the JAX
package, on the CPU.

The reduced deepseek-v3 (q_lora 32, kv_lora 16, qk 16 + 8, v 16; 4 heads,
one dense prefix layer, 8 experts top-2), f32, its JAX parameters carried
across with ``named_tensors`` -> numpy -> ``from_numpy`` (norm gammas given
noise so ``1 + gamma`` shows). ``mla_apply`` in its expanded (prefill) and
absorbed (decode) forms against the JAX ``blocks.mla_apply``, and the two
forms against each other; the absorbed decode's attention
(``mla_decode_plain``) and the kernel's split-KV algorithm in plain PyTorch
(``mla_decode_split_plain``) against the JAX einsums; ``attention_plain``
with v narrower than q/k against ``chunked_attention``; the MLA
``DecoderLM`` (names, forward, prefill logits and cache, a decode chain)
against the JAX ``DecoderLM``; a ``RolloutWorker`` served from a replica
against a JAX replay of its calls; a reduced-deepseek replica pulled
between the packages raw and int8 with manifests and checksums equal.
Tolerance 2e-5 in f32 (``tests/test_kernels.py``'s), relative and
absolute, unless stated. Inputs come from numpy with a seed.
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
from repro.models.layers import chunked_attention  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mla_decode as md  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy  # noqa: E402
from repro_torch.rl.loop import RLConfig, RolloutWorker  # noqa: E402

import test_torch_moe_interop as interop  # noqa: E402  (its replica scenario, run here on deepseek-v3)

TOL = 2e-5
ARCH = "deepseek-v3-671b"


def _cfgs(**extra):
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **extra),
            dataclasses.replace(get_config(ARCH).reduced(), **extra))


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


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = _cfgs()
    jm, jp, named = _weights(jcfg)
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _tokens(seed, b, s, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s)).astype(np.int32)


def _attn_layer(named, where):
    """One MLA layer's weights: the stack's layer 0 or the dense prefix's."""
    if where == "stack":
        return {n.split("/")[-1]: a[0] for n, a in named.items() if n.startswith("layers/attn/")}
    return {n.split("/")[-1]: a for n, a in named.items() if n.startswith("prefix/0/attn/")}


def _port_apply(pcfg, layer, x, **kw):
    return blocks.mla_apply(pcfg, from_numpy(layer, "cpu"), torch.from_numpy(x), attention=fa.attention_plain,
                            latent_attention=md.mla_decode_plain, **kw)


def _jax_apply(jcfg, layer, x, **kw):
    return jax_blocks.mla_apply(jcfg, {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(x), **kw)


# -- the block ----------------------------------------------------------------------------


def test_mla_shapes_are_jax_mla_specs():
    jcfg, pcfg = _cfgs()
    got = {n: p.shape for n, p in blocks.mla_specs(pcfg).items()}
    assert got == {n: tuple(s.shape) for n, s in jax_blocks.mla_specs(jcfg).items()}
    full = {n: p.shape for n, p in blocks.mla_specs(get_config(ARCH)).items()}
    assert full["wq_b"] == (1536, 128 * 192) and full["wkv_a"] == (7168, 576) and full["wo"] == (128 * 128, 7168)


@pytest.mark.parametrize("where", ["stack", "prefix"])
def test_expanded_form_matches_jax(model, where):
    jcfg, pcfg, _, _, named, _, _ = model
    layer = _attn_layer(named, where)
    x = np.random.default_rng(1).standard_normal((2, 11, pcfg.d_model)).astype(np.float32)
    got, kv = _port_apply(pcfg, layer, x, positions=torch.arange(11))
    want, jkv = _jax_apply(jcfg, layer, x, positions=jnp.arange(11))
    _close(got, want)
    assert set(kv) == set(jkv) == {"ckv", "krope"}
    for n in kv:
        assert tuple(kv[n].shape) == jkv[n].shape
        _close(kv[n], jkv[n])


@pytest.mark.parametrize("cache_len", [1, 8, 13])
def test_absorbed_form_matches_jax(model, cache_len):
    """A decode step against a cache primed by the expanded form over
    ``cache_len`` tokens, three slots to spare (zeros, as the model's)."""
    jcfg, pcfg, _, _, named, _, _ = model
    layer = _attn_layer(named, "stack")
    x = np.random.default_rng(2).standard_normal((2, cache_len + 1, pcfg.d_model)).astype(np.float32)
    _, jkv = _jax_apply(jcfg, layer, x[:, :-1], positions=jnp.arange(cache_len))
    jcache = {n: jnp.pad(a, ((0, 0), (0, 3), (0, 0))) for n, a in jkv.items()}
    cache = {n: torch.from_numpy(np.array(a)) for n, a in jcache.items()}
    got, out_cache = _port_apply(pcfg, layer, x[:, -1:], positions=torch.tensor([cache_len]), cache=cache,
                                 cache_len=cache_len)
    want, jout = _jax_apply(jcfg, layer, x[:, -1:], positions=jnp.asarray([cache_len]), cache=jcache,
                            cache_len=jnp.asarray(cache_len))
    _close(got, want)
    assert out_cache is cache  # written in place
    for n in ("ckv", "krope"):
        _close(cache[n], jout[n])


def test_absorbed_decode_matches_expanded():
    """The port's two forms against each other, as tests/test_blocks.py
    holds the JAX package's: the last position of an expanded pass over 9
    tokens equals an absorbed step after a prefill of 8 (2e-5 here in f32;
    the JAX test's 2e-3 is loose)."""
    _, pcfg = _cfgs()
    jcfg, _ = _cfgs()
    _, _, named = _weights(jcfg)
    layer = from_numpy(_attn_layer(named, "stack"), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 9, pcfg.d_model)).astype(np.float32))
    kw = dict(attention=fa.attention_plain, latent_attention=md.mla_decode_plain)
    full, _ = blocks.mla_apply(pcfg, layer, x, positions=torch.arange(9), **kw)
    _, kv = blocks.mla_apply(pcfg, layer, x[:, :8], positions=torch.arange(8), **kw)
    cache = {n: torch.cat([t, torch.zeros_like(t[:, :2])], dim=1) for n, t in kv.items()}
    dec, _ = blocks.mla_apply(pcfg, layer, x[:, 8:], positions=torch.tensor([8]), cache=cache, cache_len=8, **kw)
    _close(dec[:, 0], full[:, -1])


def test_scale_is_the_jax_f32_scale():
    for arch_cfg in (_cfgs()[1], get_config(ARCH)):
        m = arch_cfg.mla
        want = np.float32(1.0) / np.sqrt(np.float32(m.qk_nope_head_dim + m.qk_rope_head_dim))
        assert np.float32(blocks.mla_scale(arch_cfg)) == want
    assert abs(blocks.mla_scale(get_config(ARCH)) - 192 ** -0.5) < 1e-8


# -- the absorbed decode's attention -------------------------------------------------------


def _latent_inputs(seed, b, h, smax, r=16, rd=8, s=1):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, s, r), (b, h, s, rd), (b, smax, r), (b, smax, rd))]


def _jax_latent(qa, qr, ckv, kr, kv_len, scale):
    """The JAX package's absorbed einsums (``blocks.py`` ``mla_apply``),
    with its mask ``t < kv_len`` and no causal term."""
    scores = (jnp.einsum("bhsr,btr->bhst", qa, ckv) + jnp.einsum("bhsd,btd->bhst", qr, kr)) * scale
    valid = jnp.arange(ckv.shape[1])[None, None, None, :] < kv_len
    probs = jax.nn.softmax(jnp.where(valid, scores, -1e30), axis=-1)
    return jnp.einsum("bhst,btr->bhsr", probs, ckv)


LATENT_CASES = [(2, 4, 20, 1), (2, 4, 20, 13), (2, 4, 20, 20), (1, 16, 70, 65), (3, 4, 100, 97), (2, 128, 40, 33)]


@pytest.mark.parametrize("b,h,smax,kv_len", LATENT_CASES, ids=lambda c: str(c))
def test_mla_decode_plain_matches_jax_einsums(b, h, smax, kv_len):
    ins = _latent_inputs(b * 100 + kv_len, b, h, smax)
    scale = 24 ** -0.5
    got = md.mla_decode_plain(*map(torch.from_numpy, ins), kv_len=kv_len, scale=scale)
    assert got.shape == (b, h, 1, 16) and got.dtype == torch.float32
    _close(got, _jax_latent(*ins, kv_len, scale))


@pytest.mark.parametrize("keys_per_split", [0, 32, 64])
@pytest.mark.parametrize("b,h,smax,kv_len", LATENT_CASES, ids=lambda c: str(c))
def test_split_kv_emulation_matches_jax_einsums(b, h, smax, kv_len, keys_per_split):
    """The kernel's algorithm (32-key tiles, one product over the latent
    and rope columns, P as bf16 hi + lo, splits, the ordered merge) at the
    kernel's widths where it matters (R 512, rd 64) and the reduced
    ones."""
    for r, rd in ((16, 8), (512, 64)):
        ins = _latent_inputs(kv_len + r, b, min(h, 16), smax, r, rd)
        scale = 192 ** -0.5
        got = md.mla_decode_split_plain(*map(torch.from_numpy, ins), kv_len=kv_len, scale=scale,
                                        keys_per_split=keys_per_split)
        _close(got, _jax_latent(*ins, kv_len, scale))


@pytest.mark.parametrize("b,h,smax,kv_len", [c for c in LATENT_CASES if c[3] > 1], ids=lambda c: str(c))
def test_split_p_lo_is_what_meets_the_f32_gate(b, h, smax, kv_len):
    """Why the kernel issues P.V twice: each f32 softmax weight as one bf16
    operand (``P_hi``) misses 2e-5 against the JAX einsums at R 512; with
    ``P_lo = bf16(p - P_hi)`` added into the same f32 sum it meets it."""
    ins = _latent_inputs(kv_len + 512, b, min(h, 16), smax, 512, 64)
    scale = 192 ** -0.5
    want = np.asarray(_jax_latent(*ins, kv_len, scale))
    hi_lo, hi = (md.mla_decode_split_plain(*map(torch.from_numpy, ins), kv_len=kv_len, scale=scale, p_lo=p_lo)
                 for p_lo in (True, False))
    _close(hi_lo, want)
    assert not np.allclose(hi.numpy(), want, rtol=TOL, atol=TOL)


def test_dead_slots_are_never_read():
    """NaN in the slots at or past kv_len (a cache's dead slots, which
    the kernel never loads) changes neither plain version."""
    ins = [torch.from_numpy(a) for a in _latent_inputs(5, 2, 4, 80, 512, 64)]
    want = md.mla_decode_plain(*ins, kv_len=45, scale=0.07)
    for t in ins[2:]:
        t[:, 45:] = float("nan")
    _close(md.mla_decode_plain(*ins, kv_len=45, scale=0.07), want)
    _close(md.mla_decode_split_plain(*ins, kv_len=45, scale=0.07, keys_per_split=32), want)


#: (kv_len, batch, heads) -> (keys_per_split, nsplit): the served step (4 x
#: 128 heads, 513 to 528 slots), one batch, 16 heads, the longest cache
PLANS = {(528, 4, 128): (64, 9), (513, 4, 128): (64, 9), (1, 4, 128): (32, 1), (65, 4, 128): (32, 3),
         (527, 1, 128): (32, 17), (528, 1, 16): (32, 17), (32, 1, 16): (32, 1), (4096, 4, 128): (256, 16),
         (100_000, 1, 16): (32 * 49, 64)}


@pytest.mark.parametrize("key", sorted(PLANS), ids=lambda k: "x".join(map(str, k)))
def test_split_plan(key):
    keys, nsplit = md.split_plan(*key)
    assert (keys, nsplit) == PLANS[key]
    kv_len = key[0]
    assert keys % md.TILE_KEYS == 0 and nsplit <= md.MAX_SPLITS and (nsplit - 1) * keys < kv_len <= nsplit * keys


def test_cpu_calls_launch_nothing_and_the_kernel_takes_only_its_shapes():
    ins = [torch.from_numpy(a) for a in _latent_inputs(6, 1, 4, 40, 512, 64)]
    before = md.LAUNCHES.value
    md.mla_decode(*ins, kv_len=30, scale=0.1)
    assert md.LAUNCHES.value == before
    bf = [t.to(torch.bfloat16) for t in ins]
    narrow = [torch.from_numpy(a).to(torch.bfloat16) for a in _latent_inputs(6, 1, 4, 40)]
    two = [torch.from_numpy(a).to(torch.bfloat16) for a in _latent_inputs(6, 1, 4, 40, 512, 64, s=2)]
    for args, err, match in ((ins, TypeError, "bfloat16"), (narrow, ValueError, "512"), (two, ValueError, "one query"),
                             (bf, TypeError, "unsupported device")):
        with pytest.raises(err, match=match):
            md.launch(*args, kv_len=30, scale=0.1)
    with pytest.raises(ValueError, match="kv_len"):
        md.mla_decode(*ins, kv_len=41, scale=0.1)
    assert md.LAUNCHES.value == before


# -- attention with v narrower than q/k ----------------------------------------------------


@pytest.mark.parametrize("case", [
    dict(sq=11, sk=11), dict(sq=5, sk=20, q_offset=15), dict(sq=7, sk=30, q_offset=3, kv_len=10),
    dict(sq=1, sk=17, q_offset=16, kv_len=17, causal=False),
], ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dims", [(24, 16), (192, 128)], ids=lambda d: "x".join(map(str, d)))
def test_attention_plain_with_narrow_v_matches_chunked_attention(case, dims):
    """MLA's expanded form: q/k of qk_nope + qk_rope, v of v_head_dim (the
    reduced config's 24/16, deepseek-v3's 192/128)."""
    d, dv = dims
    case = dict(case)
    sq, sk = case.pop("sq"), case.pop("sk")
    causal = case.pop("causal", True)
    rng = np.random.default_rng(sq * 31 + sk)
    q = rng.standard_normal((2, 4, sq, d)).astype(np.float32)
    k = rng.standard_normal((2, 4, sk, d)).astype(np.float32)
    v = rng.standard_normal((2, 4, sk, dv)).astype(np.float32)
    got = fa.attention_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, **case)
    assert got.shape == (2, 4, sq, dv)
    want = chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, block_k=8, **case)
    _close(got, want)
    _close(fa.split_kv_plain(*map(torch.from_numpy, (q, k, v)), causal=causal, keys_per_split=16, **case), want)


def test_attention_gradient_with_narrow_v_matches_jax_grad():
    """The attention Function's CPU backward (``attention_backward_plain``)
    at the reduced config's q/k 24, v 16 against ``jax.grad`` of
    ``chunked_attention``: what MLA training will differentiate (the card's
    backward refuses it until then)."""
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((2, 4, 13, 24)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 4, 13, 16)).astype(np.float32)
    w = rng.standard_normal((2, 4, 13, 16)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (fa.flash_attention(*leaves, causal=True) * torch.from_numpy(w)).sum().backward()

    def loss(q, k, v):
        return (chunked_attention(q, k, v, causal=True, block_k=8) * w).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip(leaves, want):
        _close(got.grad, ref)


# -- the MLA decoder -------------------------------------------------------------------------


def test_decoder_shapes_are_jax_named_tensors(model):
    _, pcfg, _, _, named, pm, pp = model
    assert decoder_shapes(pcfg) == [(n, tuple(a.shape)) for n, a in named.items()]
    assert list(pp) == list(named)
    assert pm.is_mla and pm.is_moe and (pm.n_prefix, pm.n_scan) == (1, pcfg.num_layers - 1)
    mla = [n for n in pp if n.startswith("prefix/0/attn/")]
    assert mla == [f"prefix/0/attn/{n}" for n in sorted(blocks.mla_specs(pcfg))]
    assert pp["layers/attn/wkv_b_k"].shape == (pm.n_scan, 16, 4 * 16)
    assert not any(n.endswith(("/wq", "/wk", "/wv")) for n in pp)


def test_forward_matches_jax(model):
    _, _, jm, jp, _, pm, pp = model
    toks = _tokens(0, 2, 21)
    want = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 21, 256) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_matches_jax(model):
    _, pcfg, jm, jp, _, pm, pp = model
    toks = _tokens(1, 3, 13)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=20)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=20)
    assert pn == int(jn) == 13
    _close(pl, jl)
    assert set(pc) == set(jc) == {"layers", "prefix"}
    m = pcfg.mla
    assert tuple(pc["layers"]["ckv"].shape) == (pm.n_scan, 3, 20, m.kv_lora_rank)
    assert tuple(pc["layers"]["krope"].shape) == (pm.n_scan, 3, 20, m.qk_rope_head_dim)
    for n in ("ckv", "krope"):
        assert tuple(pc["layers"][n].shape) == jc["layers"][n].shape
        _close(pc["layers"][n], jc["layers"][n])
        for i, c in enumerate(pc["prefix"]):
            _close(c[n], jc["prefix"][i][n])
        assert not pc["layers"][n][:, :, 13:].any()  # the slots to come, zeros


def test_decode_chain_matches_jax(model):
    """12 absorbed decode steps after a 6-token prompt (2 tokens a step:
    capacity 8, nothing drops)."""
    _, _, jm, jp, _, pm, pp = model
    toks, nxt = _tokens(2, 2, 6), _tokens(3, 2, 12)
    jl, jc, jn = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len=18)
    pl, pc, pn = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()}, max_len=18)
    for t in range(12):
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, t : t + 1]), jn)
        jn = jn + 1
        pl, pc = pm.decode(pp, pc, torch.from_numpy(nxt[:, t : t + 1]).long(), pn)
        pn += 1
        _close(pl, jl)
    for n in ("ckv", "krope"):
        _close(pc["layers"][n], jc["layers"][n])
        for i, c in enumerate(pc["prefix"]):
            _close(c[n], jc["prefix"][i][n])


def test_decode_calls_the_latent_attention_once_a_layer(model):
    """The absorbed form goes through ``latent_attention`` (the kernel's
    wrapper by default), the expanded one through ``attention``, each
    once a layer."""
    _, pcfg, _, _, _, _, pp = model
    calls = []

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    pm = build_model(pcfg, attention=counting("attention", fa.attention_plain),
                     latent_attention=counting("latent", md.mla_decode_plain))
    assert build_model(pcfg).latent_attention is md.mla_decode
    _, cache, n = pm.prefill(pp, {"tokens": torch.from_numpy(_tokens(4, 2, 5)).long()}, max_len=8)
    assert calls == ["attention"] * pcfg.num_layers
    calls.clear()
    pm.decode(pp, cache, torch.from_numpy(_tokens(5, 2, 1)).long(), n)
    assert calls == ["latent"] * pcfg.num_layers


def test_rollout_worker_serves_mla_from_a_replica():
    """A RolloutWorker replicates the reduced deepseek-v3 and serves it with
    no code of its own for MLA: its logprobs are those of the JAX
    ``DecoderLM`` replaying the same calls (the prefill of the prompts,
    then one absorbed decode step a sampled token)."""
    jcfg, pcfg = _cfgs()
    jm, jp, named = _weights(jcfg)
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pub = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    pub.register(from_numpy(named, "cpu"))
    pub.publish(0)
    plen, rlen = 5, 8
    cfg = RLConfig(prompt_len=plen, response_len=rlen, num_prompts=2, group_size=2)
    w = RolloutWorker("rollout-0", hub, cfg, pcfg, PromptSet(256, plen), [], threading.Event())
    assert w.connect(timeout=30) == 0 and w.model.is_mla
    for k, t in w.params.items():
        np.testing.assert_array_equal(t.numpy(), named[k])
    rec = w.serve_batch(0)
    seqs = rec["tokens"].numpy().astype(np.int32)
    logits, cache, n = jm.prefill(jp, {"tokens": jnp.asarray(seqs[:, :plen])}, max_len=plen + rlen)
    want = []
    for t in range(rlen):
        lp = jax.nn.log_softmax(logits[:, -1], -1)
        want.append(np.take_along_axis(np.asarray(lp), seqs[:, plen + t, None], -1)[:, 0])
        logits, cache = jm.decode(jp, cache, jnp.asarray(seqs[:, plen + t : plen + t + 1]), n)
        n = n + 1
    _close(rec["behavior_logprobs"], np.stack(want, 1))


# -- a replica between the packages -------------------------------------------------------------

@pytest.fixture()
def numpy_int8(monkeypatch):
    monkeypatch.setattr(interop.jax_codec.Int8Codec, "_resolve_jax", lambda self: None)


def _deepseek_weights(dtype: str, seed: int = 3):
    """v0 and v1 (1/8 of each tensor's 256-element rows perturbed) of the
    reduced deepseek-v3 at d_model 256, by the JAX package's names, in its
    order."""
    jcfg, pcfg = _cfgs(d_model=256)
    shapes = [(n, tuple(s.shape)) for n, s in named_tensors(JaxLM(jcfg).param_specs()).items()]
    assert shapes == decoder_shapes(pcfg)
    rng = np.random.default_rng(seed)
    v0, v1 = {}, {}
    for name, shape in shapes:
        w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        w1 = w.reshape(-1).copy()
        w1[: w1.size // 256 * 256].reshape(-1, 256)[::8] += 0.01
        v0[name] = w.astype(interop.DTYPES[dtype])
        v1[name] = w1.reshape(shape).astype(interop.DTYPES[dtype])
    return v0, v1


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("pub_name", ["jax", "port"])
def test_deepseek_replica_crosses_the_packages_bit_equal(pub_name, dtype, numpy_int8):
    """The MLA names (``wq_a``, ``q_ln``, ``wkv_b_k``, ...) and the unit
    schedule of a reduced deepseek-v3 replica, raw (dc0) and int8 (dc1),
    through a networked controller of the other package than the
    publisher's: every replica's bytes and every v1 manifest (units and
    checksums) equal the same scenario run through the JAX package alone."""
    pub_pkg = interop.PACKAGES[pub_name]
    read_pkg = interop.PORT if pub_pkg is interop.JAX else interop.JAX
    v0, v1 = _deepseek_weights(dtype)
    delta = pub_pkg is interop.PORT
    server = interop.jax_core.ReferenceServer()
    hub = interop.jax_core.TensorHubClient(server, chunk_bytes=interop.CHUNK)
    hs, want_v0 = interop._scenario(interop.JAX, interop.JAX, hub.open, lambda i: hub.open, v0, v1, delta)
    want = interop._final(server, hs)

    ctrl_server = read_pkg.core.ReferenceServer()
    http = read_pkg.httpd.ControlServer(read_pkg.service.ReferenceService(ctrl_server)).start()
    workers = [pkg.worker.NetWorker(wid, address=http.address, chunk_bytes=interop.CHUNK, rpc_timeout=20.0, **pkg.kw)
               for pkg, wid in ((pub_pkg, "pub"), (read_pkg, "reader0"), (read_pkg, "reader1"))]
    try:
        hs, got_v0 = interop._scenario(pub_pkg, read_pkg, workers[0].open, lambda i: workers[1 + i].open, v0, v1,
                                       delta)
        got = interop._final(ctrl_server, hs)
    finally:
        for w in workers:
            w.close()
        http.shutdown()
    assert got_v0 == want_v0 == {n: interop._bytes(a) for n, a in v0.items()}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key][0] == want[key][0], key
        assert got[key][1] == want[key][1], key
    assert got["r0"][0] == {n: interop._bytes(a) for n, a in v1.items()}
    units = got["trainer"][1][1]  # (index, name, nbytes, members, ...) a unit
    names = {n for u in units for n in (u[3] or (u[1],))}
    assert names == set(v0) and len(units) > 1
    assert {"layers/attn/wkv_b_k", "layers/attn/wq_b", "prefix/0/attn/kv_ln"} <= names
