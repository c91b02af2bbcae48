"""The port's training slice against the JAX package's, on the CPU.

Objectives, AdamW, the GRPO and LM train steps, the bigram stream and the
reduced config, each fed the same numpy inputs (made from a seed) on both
sides. The model is a small llama3-style config with GQA 4:1 (2 layers,
d_model 128, 8 query and 2 KV heads of 16, d_ff 256, vocab 512; not
``reduced()``, which collapses the GQA ratio to 1) in f32, its JAX
parameters carried across with ``from_numpy``. Tolerances, each stated
where it is used:

* losses and metrics: 2e-5 relative and absolute (``tests/test_kernels.py``'s f32);
* AdamW on identical gradients: 1e-6 relative and absolute on parameters
  and f32 moments (the same f32 operations in the same order, so a few
  ulps where XLA and PyTorch round ``b ** step`` or a square root apart);
  bf16 moments to one bf16 ulp (2^-8 relative), where an f32 ulp apart
  lands on either side of a bf16 rounding boundary;
* gradients of a whole model: max |port - JAX| <= 1e-4 x max |JAX| per
  tensor (two frameworks summing f32 products in other orders through
  two layers, attention and a 512-way log-softmax);
* a whole step (gradients, then AdamW): AdamW's first update is about
  ``lr * sign(g)``, so where the port's and JAX's g differ in sign, or
  are too small for the update to be sign(g), a rounding-level difference
  in g moves it by up to 2 lr. Those elements are counted (at most 5% of
  a tensor), not compared; every other element, exact zeros included, is
  held to 1e-6 relative and absolute. The optimizer itself is held on
  identical gradients above.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.data.synthetic import BigramStream as JaxStream  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.training import objectives as jobj  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs.llama3_8b import CONFIG as PORT_LLAMA  # noqa: E402
from repro_torch.data.synthetic import BigramStream  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.training import objectives as pobj  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

SMALL = dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, d_ff=256, vocab=512)
JAX_CFG = dataclasses.replace(get_config("llama3-8b"), **SMALL)
PORT_CFG = dataclasses.replace(PORT_LLAMA, **SMALL)
LOSS_TOL = 2e-5
OPT_TOL = 1e-6
GRAD_TOL = 1e-4
FLIP_FLOOR = 1e-5  # 1000 x AdamW's eps
FLIP_SHARE = 0.05


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# -- objectives -----------------------------------------------------------------------


def _logits(rng, b=3, s=9, v=37):
    return (rng.standard_normal((b, s, v)) * 3).astype(np.float32)


def test_lm_cross_entropy_matches():
    rng = np.random.default_rng(0)
    logits, toks = _logits(rng), rng.integers(0, 37, size=(3, 9)).astype(np.int32)
    toks[0, 1:] = np.argmax(logits[0, :-1], -1)  # some right answers for the accuracy
    got_l, got_m = pobj.lm_cross_entropy(torch.from_numpy(logits), torch.from_numpy(toks))
    want_l, want_m = jobj.lm_cross_entropy(jnp.asarray(logits), jnp.asarray(toks))
    _close(got_l, want_l, LOSS_TOL)
    assert set(got_m) == set(want_m)
    for k in want_m:
        _close(got_m[k], want_m[k], LOSS_TOL)


def test_masked_cross_entropy_matches():
    rng = np.random.default_rng(1)
    logits, tgt = _logits(rng), rng.integers(0, 37, size=(3, 9)).astype(np.int32)
    mask = rng.random((3, 9)) < 0.4
    got_l, got_m = pobj.masked_cross_entropy(*(torch.from_numpy(a) for a in (logits, tgt, mask)))
    want_l, want_m = jobj.masked_cross_entropy(*(jnp.asarray(a) for a in (logits, tgt, mask)))
    for k in want_m:
        _close(got_m[k], want_m[k], LOSS_TOL)
    # an empty mask: the denominator's floor of 1
    empty = np.zeros_like(mask)
    _close(pobj.masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(tgt), torch.from_numpy(empty))[0],
           jobj.masked_cross_entropy(jnp.asarray(logits), jnp.asarray(tgt), jnp.asarray(empty))[0], LOSS_TOL)


@pytest.mark.parametrize("clip_eps", [0.2, 0.05])
def test_grpo_loss_matches(clip_eps):
    rng = np.random.default_rng(2)
    b, s = 4, 9
    logits, toks = _logits(rng, b, s), rng.integers(0, 37, size=(b, s)).astype(np.int32)
    blp = (-3.0 + rng.standard_normal((b, s - 1))).astype(np.float32)  # ratios on both sides of the clip
    adv = rng.standard_normal(b).astype(np.float32)
    mask = np.zeros((b, s - 1), bool)
    mask[:, 4:] = True
    args = (logits, toks, blp, adv, mask)
    got_l, got_m = pobj.grpo_loss(*(torch.from_numpy(a) for a in args), clip_eps=clip_eps)
    want_l, want_m = jobj.grpo_loss(*(jnp.asarray(a) for a in args), clip_eps=clip_eps)
    assert set(got_m) == set(want_m) == {"loss", "mean_ratio", "mean_advantage"}
    for k in want_m:
        _close(got_m[k], want_m[k], LOSS_TOL)


@pytest.mark.parametrize("group", [1, 4])
def test_group_relative_advantages_match(group):
    rng = np.random.default_rng(3)
    rewards = rng.random(16).astype(np.float32)
    rewards[:4] = 0.5  # a group with no spread: the std floor
    got = pobj.group_relative_advantages(torch.from_numpy(rewards), group)
    _close(got, jobj.group_relative_advantages(jnp.asarray(rewards), group), LOSS_TOL)


# -- AdamW ------------------------------------------------------------------------------


def _shapes():
    return {"a": (7, 5), "b": (3, 4, 6), "c": (11,)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip,wd,sched", [(1.0, 0.1, False), (0.0, 0.0, False), (0.5, 0.01, True)])
def test_adamw_matches_on_identical_grads(state_dtype, clip, wd, sched):
    rng = np.random.default_rng(4)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in _shapes().items()}
    sdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[state_dtype]
    jo = jopt.AdamW(lr=1e-2, weight_decay=wd, grad_clip=clip, state_dtype=sdt[0],
                    schedule=jopt.cosine_schedule(2, 6) if sched else None)
    po = popt.AdamW(lr=1e-2, weight_decay=wd, grad_clip=clip, state_dtype=sdt[1],
                    schedule=popt.cosine_schedule(2, 6) if sched else None)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    pp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    js, ps = jo.init(jp), po.init(pp)
    for step in range(5):
        grads = {n: (rng.standard_normal(s) * (0.3 + step)).astype(np.float32) for n, s in _shapes().items()}
        jp, js = jo.update({n: jnp.asarray(g) for n, g in grads.items()}, js, jp)
        pp_out, ps = po.update({n: torch.from_numpy(g) for n, g in grads.items()}, ps, pp)
        assert pp_out is pp and ps.step == int(js.step) == step + 1
        for n in params:
            _close(pp[n], jp[n], OPT_TOL)
            for got, want in ((ps.mu[n], js.mu[n]), (ps.nu[n], js.nu[n])):
                assert got.dtype == sdt[1]
                if state_dtype == "float32":
                    _close(got, want, OPT_TOL)
                else:
                    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)), rtol=2.0**-8, atol=0)


def test_global_norm_and_cosine_schedule_match():
    rng = np.random.default_rng(5)
    tensors = {n: rng.standard_normal(s).astype(np.float32) for n, s in _shapes().items()}
    _close(popt.global_norm({n: torch.from_numpy(a) for n, a in tensors.items()}),
           jopt.global_norm({n: jnp.asarray(a) for n, a in tensors.items()}), LOSS_TOL)
    pf, jf = popt.cosine_schedule(10, 50), jopt.cosine_schedule(10, 50)
    for step in (0, 1, 5, 10, 11, 30, 50, 70):
        _close(pf(step), jf(jnp.asarray(step, jnp.int32)), 1e-7)


# -- whole steps on a small llama --------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jm = JaxLM(JAX_CFG)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(7)
    for k in named:  # nonzero norm gammas, so their gradients and 1 + gamma show
        if k.endswith("ln"):
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    return jm, named


def _jax_params(named):
    return {k: jnp.asarray(v) for k, v in named.items()}


def _jax_tree(jm, named):
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(named[k]) for k in named_tensors(template)])


def _grpo_batch(seed, b=4, s=14, prompt=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SMALL["vocab"], size=(b, s)).astype(np.int32)
    blp = np.zeros((b, s - 1), np.float32)
    blp[:, prompt - 1 :] = -6.2 + 0.3 * rng.standard_normal((b, s - prompt))
    mask = np.zeros((b, s - 1), bool)
    mask[:, prompt - 1 :] = True
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": toks, "behavior_logprobs": blp, "advantages": adv, "loss_mask": mask}


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v) for k, v in batch.items()}


def _grads_close(got, want):
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        err = float(np.max(np.abs(_np(got[n]) - w)))
        assert err <= GRAD_TOL * float(np.max(np.abs(w))), (n, err, float(np.max(np.abs(w))))
        assert float(np.max(np.abs(w))) > 0, n


def _step_close(port_params, port_state, jax_params, jax_state, jax_grads, port_grads):
    """New params and moments against the JAX step, apart from the
    elements where AdamW's first update ``g / (|g| + eps)`` is not
    ``sign(g)`` on both sides: the two gradients differ in sign, or the
    smaller is below ``FLIP_FLOOR`` (1000 x eps, where the update is
    within 1e-3 of sign(g) and a rounding-level change in g moves it).
    Those are counted (at most ``FLIP_SHARE`` of a tensor) and not
    compared; exact zeros on both sides (the embedding rows of tokens not
    in the batch) are compared."""
    for n, jg in jax_grads.items():
        jg, pg = np.asarray(jg, np.float32), _np(port_grads[n])
        both_zero = (jg == 0) & (pg == 0)
        keep = both_zero | ((np.sign(jg) == np.sign(pg)) & (np.minimum(np.abs(jg), np.abs(pg)) > FLIP_FLOOR))
        assert 1 - keep.mean() <= FLIP_SHARE, (n, "elements treated apart:", int((~keep).sum()), keep.size)
        for got, want in ((port_params[n], jax_params[n]), (port_state.mu[n], jax_state.mu[n]),
                          (port_state.nu[n], jax_state.nu[n])):
            np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep], rtol=OPT_TOL, atol=OPT_TOL)


def test_grpo_gradients_match_jax_grad(model):
    jm, named = model
    batch = _grpo_batch(11)

    def jloss(p):
        logits = jm.forward(p, {"tokens": jnp.asarray(batch["tokens"])})
        return jobj.grpo_loss(logits, *(jnp.asarray(batch[k]) for k in ("tokens", "behavior_logprobs",
                                                                             "advantages", "loss_mask")))

    (loss, jm_metrics), jg = jax.value_and_grad(jloss, has_aux=True)(_jax_tree(jm, named))
    pg, pm = psteps.value_and_grad(psteps.make_grpo_loss_fn(DecoderLM(PORT_CFG)), from_numpy(named, "cpu"),
                                   _port_batch(batch))
    _close(pm["loss"], loss, LOSS_TOL)
    _grads_close(pg, named_tensors(jg))


def test_grpo_step_matches_jax(model):
    jm, named = model
    batch = _grpo_batch(12)
    jopt_ = jopt.AdamW(lr=1e-3, weight_decay=0.0)
    jtree = _jax_tree(jm, named)
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_grpo_step(jm, JAX_CFG, jopt_))(
        jtree, jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    popt_ = popt.AdamW(lr=1e-3, weight_decay=0.0)
    params = from_numpy(named, "cpu")
    grads = {}
    state = popt_.init(params)
    new, state, metrics = psteps.make_grpo_step(DecoderLM(PORT_CFG), PORT_CFG, popt_, grads_out=grads)(
        params, state, _port_batch(batch))
    assert new is params and state.step == 1
    assert not any(p.requires_grad for p in params.values())
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)

    def jloss(p):
        logits = jm.forward(p, {"tokens": jnp.asarray(batch["tokens"])})
        return jobj.grpo_loss(logits, *(jnp.asarray(batch[k]) for k in ("tokens", "behavior_logprobs",
                                                                             "advantages", "loss_mask")))[0]

    jg = named_tensors(jax.grad(jloss)(jtree))
    _grads_close(grads, jg)
    jstate_named = jopt.AdamWState(step=jstate.step, mu=named_tensors(jstate.mu), nu=named_tensors(jstate.nu))
    _step_close(params, state, named_tensors(jnew), jstate_named, jg, grads)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(model, accum):
    jm, named = model
    stream = BigramStream(vocab=SMALL["vocab"], seq_len=12, batch=4, seed=3)
    batch = stream.next_batch()
    jopt_ = jopt.AdamW(lr=1e-3, weight_decay=0.01, schedule=jopt.cosine_schedule(10, 20))
    jtree = _jax_tree(jm, named)
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_train_step(jm, JAX_CFG, jopt_, accum=accum))(
        jtree, jstate, {"tokens": jnp.asarray(batch["tokens"])})

    popt_ = popt.AdamW(lr=1e-3, weight_decay=0.01, schedule=popt.cosine_schedule(10, 20))
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
    _, state, metrics = psteps.make_train_step(DecoderLM(PORT_CFG), PORT_CFG, popt_, accum=accum)(
        params, state, {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))})
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy"}
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)

    # the averaged gradient, held apart from the optimizer
    loss_fn = jsteps.make_loss_fn(jm, JAX_CFG)
    mb = 4 // accum
    jg = [named_tensors(jax.grad(lambda p: loss_fn(p, {"tokens": jnp.asarray(batch["tokens"][i * mb:(i + 1) * mb])})[0])(
        jtree)) for i in range(accum)]
    jg = {n: sum(np.asarray(g[n], np.float32) for g in jg) / accum for n in jg[0]}
    pl = psteps.make_loss_fn(DecoderLM(PORT_CFG), PORT_CFG)
    pg = [psteps.value_and_grad(pl, from_numpy(named, "cpu"),
                                {"tokens": torch.from_numpy(batch["tokens"][i * mb:(i + 1) * mb].astype(np.int64))})[0]
          for i in range(accum)]
    pg = {n: sum(g[n] for g in pg) / accum for n in pg[0]}
    _grads_close(pg, jg)
    jstate_named = jopt.AdamWState(step=jstate.step, mu=named_tensors(jstate.mu), nu=named_tensors(jstate.nu))
    _step_close(params, state, named_tensors(jnew), jstate_named, jg, pg)


def test_steps_refuse_other_families():
    """The steps take every family of the registry (the SSM family, the
    last one refused, since its slice); a config of a family the port does
    not know is refused by both, naming it."""
    ssm = port_get_config("xlstm-350m")
    assert ssm.family == "ssm"
    psteps.make_loss_fn(build_model(ssm), ssm)
    psteps.make_grpo_step(build_model(ssm), ssm, popt.AdamW())
    other = dataclasses.replace(PORT_CFG, family="rnn")
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        psteps.make_loss_fn(DecoderLM(PORT_CFG), other)
    with pytest.raises(ValueError, match="unknown family 'rnn'"):
        psteps.make_grpo_step(DecoderLM(PORT_CFG), other, popt.AdamW())



# -- data and configs -----------------------------------------------------------------------


@pytest.mark.parametrize("seed,offset", [(0, 0), (3, 0), (3, 17)])
def test_bigram_stream_matches(seed, offset):
    ours = BigramStream(vocab=300, seq_len=20, batch=5, seed=seed, offset=offset)
    theirs = JaxStream(vocab=300, seq_len=20, batch=5, seed=seed, offset=offset)
    for _ in range(3):
        a, b = ours.next_batch(), theirs.next_batch()
        assert a.keys() == b.keys() and np.array_equal(a["tokens"], b["tokens"])
        assert a["tokens"].dtype == b["tokens"].dtype
    assert ours.offset == theirs.offset == offset + 3


def test_reduced_config_matches_jax():
    got, want = PORT_LLAMA.reduced(), get_config("llama3-8b").reduced()
    for f in ("name", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff", "vocab", "rope_theta",
              "tie_embeddings", "resolved_head_dim"):
        assert getattr(got, f) == getattr(want, f), f
    assert want.head_dim == got.head_dim == 0 and got.sliding_window == want.sliding_window
    # the clamps, on configs the JAX rules reach differently
    for heads, kv in ((32, 8), (3, 2), (1, 1), (6, 4)):
        g = dataclasses.replace(PORT_LLAMA, num_heads=heads, num_kv_heads=kv).reduced()
        w = dataclasses.replace(get_config("llama3-8b"), num_heads=heads, num_kv_heads=kv).reduced()
        assert (g.num_heads, g.num_kv_heads) == (w.num_heads, w.num_kv_heads)
