"""Training the MoE decoder in the port against the JAX package, on the CPU.

Reduced dbrx (8 experts, top-2) and deepseek-v3's ``reduced()`` without
MLA (a shared expert and a dense prefix layer), f32, their JAX parameters
carried across with ``from_numpy``: the GRPO objective's and the LM
objective's gradients against ``jax.grad``, the GRPO step and the LM train
step (``accum`` 1 and 2) against the JAX steps, and ``TrainerWorker.train_on``
against the JAX trainer, all with no MoE code in the steps or the trainer:
the backward of the dispatch's gathers and scatters and of the expert
products is autograd's.

Tolerances are ``tests/test_torch_training.py``'s: losses and metrics 2e-5
relative and absolute; each tensor's gradient within 1e-4 of its max
|value|; a whole step's new parameters and moments within 1e-6 apart from
the elements where AdamW's first update ``~ lr * sign(g)`` turns on a
rounding-level difference in g (counted, at most 5% of a tensor), or, for
the GRPO step, every element at an AdamW eps where the update is smooth
in g (see the test).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jax_core  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.synthetic import BigramStream as JaxStream  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.rl.loop import RLConfig as JaxRLConfig  # noqa: E402
from repro.rl.loop import TrainerWorker as JaxTrainer  # noqa: E402
from repro.training import objectives as jobj  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import BigramStream  # noqa: E402
from repro_torch.models import blocks, build_model  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.rl import RLConfig, TrainerWorker  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

LOSS_TOL, GRAD_TOL, OPT_TOL = 2e-5, 1e-4, 1e-6
FLIP_FLOOR, FLIP_SHARE = 1e-5, 0.05
CONFIGS = {"dbrx": ("dbrx-132b", {}), "shared_prefix": ("deepseek-v3-671b", dict(mla=None))}
VOCAB = 256


def _cfgs(key):
    arch, rep = CONFIGS[key]
    return (dataclasses.replace(jax_get_config(arch).reduced(), **rep),
            dataclasses.replace(get_config(arch).reduced(), **rep))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    jcfg, pcfg = _cfgs(request.param)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(7)
    for k in named:  # nonzero norm gammas, so their gradients and 1 + gamma show
        if k.endswith("ln"):
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    return jcfg, pcfg, jm, named


def _jax_tree(jm, named):
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(named[k]) for k in named_tensors(template)])


def _grpo_batch(seed, b=4, s=14, prompt=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, VOCAB, size=(b, s)).astype(np.int32)
    blp = np.zeros((b, s - 1), np.float32)
    blp[:, prompt - 1 :] = -5.5 + 0.3 * rng.standard_normal((b, s - prompt))
    mask = np.zeros((b, s - 1), bool)
    mask[:, prompt - 1 :] = True
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": toks, "behavior_logprobs": blp, "advantages": adv, "loss_mask": mask}


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v) for k, v in batch.items()}


def _jax_grpo_loss(jm, batch):
    def loss(p):
        logits = jm.forward(p, {"tokens": jnp.asarray(batch["tokens"])})
        return jobj.grpo_loss(logits, *(jnp.asarray(batch[k]) for k in ("tokens", "behavior_logprobs",
                                                                          "advantages", "loss_mask")))
    return loss


def _grads_close(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        assert float(np.max(np.abs(w))) > 0, n
        err = float(np.max(np.abs(_np(got[n]) - w)))
        assert err <= GRAD_TOL * float(np.max(np.abs(w))), (n, err, float(np.max(np.abs(w))))


def _step_close(port_params, port_state, jax_params, jax_state, jax_grads, port_grads):
    """As ``tests/test_torch_training.py``: the elements where AdamW's first
    update is not ``sign(g)`` on both sides are counted, the rest held."""
    for n, jg in jax_grads.items():
        jg, pg = np.asarray(jg, np.float32), _np(port_grads[n])
        both_zero = (jg == 0) & (pg == 0)
        keep = both_zero | ((np.sign(jg) == np.sign(pg)) & (np.minimum(np.abs(jg), np.abs(pg)) > FLIP_FLOOR))
        assert 1 - keep.mean() <= FLIP_SHARE, (n, "elements treated apart:", int((~keep).sum()), keep.size)
        for got, want in ((port_params[n], jax_params[n]), (port_state.mu[n], jax_state.mu[n]),
                          (port_state.nu[n], jax_state.nu[n])):
            np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep], rtol=OPT_TOL, atol=OPT_TOL)


def test_grpo_gradients_match_jax_grad(model):
    jcfg, pcfg, jm, named = model
    batch = _grpo_batch(11)
    (loss, _), jg = jax.value_and_grad(_jax_grpo_loss(jm, batch), has_aux=True)(_jax_tree(jm, named))
    blocks.DROPPED.reset()
    pg, pm = psteps.value_and_grad(psteps.make_grpo_loss_fn(build_model(pcfg)), from_numpy(named, "cpu"),
                                   _port_batch(batch))
    assert blocks.DROPPED.calls == pcfg.num_layers - pcfg.moe.first_dense  # one MoE call a stacked layer
    _close(pm["loss"], loss, LOSS_TOL)
    _grads_close(pg, named_tensors(jg))


def test_lm_gradients_match_jax_grad(model):
    jcfg, pcfg, jm, named = model
    tokens = JaxStream(vocab=VOCAB, seq_len=12, batch=4, seed=5).next_batch()["tokens"]
    loss_fn = jsteps.make_loss_fn(jm, jcfg)
    (loss, _), jg = jax.value_and_grad(lambda p: loss_fn(p, {"tokens": jnp.asarray(tokens)}), has_aux=True)(
        _jax_tree(jm, named))
    pg, pm = psteps.value_and_grad(psteps.make_loss_fn(build_model(pcfg), pcfg), from_numpy(named, "cpu"),
                                   {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    _close(pm["loss"], loss, LOSS_TOL)
    _grads_close(pg, named_tensors(jg))


def test_grpo_step_matches_jax(model):
    """AdamW at eps 1e-2 on both sides: the router's GRPO gradients are
    mostly below the flip floor (the experts a token did not pick get none
    of its gradient), where AdamW's first update at eps 1e-8 turns on the
    last bits of g; at eps 1e-2 the update is smooth in g (it moves by at
    most lr / eps x the gradients' difference), so every element of every
    tensor is held to 1e-6."""
    jcfg, pcfg, jm, named = model
    batch = _grpo_batch(12)
    jopt_ = jopt.AdamW(lr=1e-3, eps=1e-2, weight_decay=0.0)
    jtree = _jax_tree(jm, named)
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_grpo_step(jm, jcfg, jopt_))(
        jtree, jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    popt_ = popt.AdamW(lr=1e-3, eps=1e-2, weight_decay=0.0)
    params = from_numpy(named, "cpu")
    grads = {}
    state = popt_.init(params)
    new, state, metrics = psteps.make_grpo_step(build_model(pcfg), pcfg, popt_, grads_out=grads)(
        params, state, _port_batch(batch))
    assert new is params and state.step == 1
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)
    jg = named_tensors(jax.grad(lambda p: _jax_grpo_loss(jm, batch)(p)[0])(jtree))
    _grads_close(grads, jg)
    jnew = named_tensors(jnew)
    for n in jg:
        for got, want in ((params[n], jnew[n]), (state.mu[n], named_tensors(jstate.mu)[n]),
                          (state.nu[n], named_tensors(jstate.nu)[n])):
            _close(got, want, OPT_TOL)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(model, accum):
    jcfg, pcfg, jm, named = model
    batch = BigramStream(vocab=VOCAB, seq_len=12, batch=4, seed=3).next_batch()
    jopt_ = jopt.AdamW(lr=1e-3, weight_decay=0.01, schedule=jopt.cosine_schedule(10, 20))
    jtree = _jax_tree(jm, named)
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_train_step(jm, jcfg, jopt_, accum=accum))(
        jtree, jstate, {"tokens": jnp.asarray(batch["tokens"])})

    popt_ = popt.AdamW(lr=1e-3, weight_decay=0.01, schedule=popt.cosine_schedule(10, 20))
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
    _, state, metrics = psteps.make_train_step(build_model(pcfg), pcfg, popt_, accum=accum)(
        params, state, {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))})
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)

    # the averaged gradient, held apart from the optimizer
    loss_fn = jsteps.make_loss_fn(jm, jcfg)
    mb = 4 // accum
    jg = [named_tensors(jax.grad(lambda p: loss_fn(p, {"tokens": jnp.asarray(batch["tokens"][i * mb:(i + 1) * mb])})[0])(
        jtree)) for i in range(accum)]
    jg = {n: sum(np.asarray(g[n], np.float32) for g in jg) / accum for n in jg[0]}
    pl = psteps.make_loss_fn(build_model(pcfg), pcfg)
    pg = [psteps.value_and_grad(pl, from_numpy(named, "cpu"),
                                {"tokens": torch.from_numpy(batch["tokens"][i * mb:(i + 1) * mb].astype(np.int64))})[0]
          for i in range(accum)]
    pg = {n: sum(g[n] for g in pg) / accum for n in pg[0]}
    _grads_close(pg, jg)
    jstate_named = jopt.AdamWState(step=jstate.step, mu=named_tensors(jstate.mu), nu=named_tensors(jstate.nu))
    _step_close(params, state, named_tensors(jnew), jstate_named, jg, pg)


def test_train_on_matches_the_jax_trainer_on_dbrx():
    """``TrainerWorker`` runs reduced dbrx with no MoE code of its own: its
    ``train_on`` gives the JAX trainer's metrics, gradients and v1."""
    jcfg, pcfg = _cfgs("dbrx")
    rl_kw = dict(prompt_len=5, response_len=7, num_prompts=2, group_size=4, lr=1e-3, seed=3)
    jt = JaxTrainer(jax_core.TensorHubClient(jax_core.ReferenceServer()), JaxRLConfig(**rl_kw), jcfg, [])
    v0 = {k: np.array(v) for k, v in named_tensors(jt.params).items()}
    rng = np.random.default_rng(9)
    rollouts = [{
        "tokens": rng.integers(0, VOCAB, size=(4, 12)).astype(np.int32),
        "behavior_logprobs": (-5.5 + 0.3 * rng.standard_normal((4, 7))).astype(np.float32),
        "rewards": rng.random(4).astype(np.float32),
    } for _ in range(2)]
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pt = TrainerWorker(hub, RLConfig(**rl_kw), pcfg, [], params=from_numpy(v0, "cpu"), keep_grads=True)
    batch = pt.batch_from(rollouts)
    got, want = pt.train_on(rollouts), jt.train_on(rollouts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def jloss(p):
        logits = jt.model.forward(p, {"tokens": jb["tokens"].astype(jnp.int32)})
        return jobj.grpo_loss(logits, jb["tokens"].astype(jnp.int32), jb["behavior_logprobs"], jb["advantages"],
                              jb["loss_mask"])[0]

    jg = {k: np.asarray(v) for k, v in named_tensors(jax.grad(jloss)(_jax_tree(jt.model, v0))).items()}
    _grads_close(pt.last_grads, jg)
    v1 = {k: np.asarray(v) for k, v in named_tensors(jt.params).items()}
    for n, g in jg.items():
        pg = pt.last_grads[n].numpy()
        keep = ((g == 0) & (pg == 0)) | ((np.sign(g) == np.sign(pg)) & (np.minimum(np.abs(g), np.abs(pg)) > FLIP_FLOOR))
        assert keep.mean() >= 1 - FLIP_SHARE, (n, int((~keep).sum()))
        np.testing.assert_allclose(pt.params[n].numpy()[keep], v1[n][keep], rtol=OPT_TOL, atol=OPT_TOL, err_msg=n)
    jt.close()
    pt.close()

