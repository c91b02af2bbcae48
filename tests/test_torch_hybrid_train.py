"""The hybrid family (zamba2-2.7b) trained in the port against the JAX
package, on the CPU.

The configs and carried-across parameters of ``tests/test_torch_hybrid.py``
(zamba2's ``reduced()``, and the same at head_dim 80; the norms and the
SSD's per-head vectors drawn away from their init values). ``make_grpo_step``
and ``make_train_step`` (one and two microbatches) against the JAX steps:
the metrics within 2e-5, every gradient within 1e-4 of its max |value|
(the shared block's summed over its calls), the new parameters and moments
within 1e-6 (the train step's apart from the elements where AdamW's first
update turns on a rounding-level difference in the gradient, at most 5% of
a tensor; the GRPO step's everywhere, at AdamW's eps 1e-2).
The JAX step runs once under ``jax.jit`` with its own AdamW handing the
gradients out beside the new parameters (``_Handing``), so one compile
gives its metrics, gradients and update. ``TrainerWorker.train_on`` against
the JAX trainer; ``launch.train --arch zamba2-2.7b`` against the JAX
``launch/train.py``'s printed losses; the backward recomputes each Mamba2
block (``torch.utils.checkpoint``) and its gradients are those of a
forward without the recompute.
"""

import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train_main  # noqa: E402
from repro.models.lm import HybridLM as JaxHybrid  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.training import objectives as jobj  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from test_torch_hybrid import ARCH, LOSS_TOL, _cfgs, _jax_params, _jax_tree, _np, _tokens  # noqa: E402
from repro_torch.data.synthetic import BigramStream  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import build_model, ssd  # noqa: E402
from repro_torch.models.lm import HybridLM  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.rl.loop import RLConfig, TrainerWorker  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

GRAD_TOL, OPT_TOL, FLIP_FLOOR, FLIP_SHARE = 1e-4, 1e-6, 1e-5, 0.05


@pytest.fixture(scope="module", params=["reduced", "head_dim_80"])
def model(request):
    jcfg, pcfg = _cfgs(request.param)
    jm, jp, named = _jax_params(jcfg)
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


class _Handing:
    """A JAX optimizer whose ``update`` returns ``(new params, the
    gradients)`` as its new parameters: the JAX step under ``jit`` then
    hands out the gradients it applied."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        new, state = self.opt.update(grads, state, params)
        return (new, grads), state


def _grads_close(got, want):
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        assert float(np.max(np.abs(w))) > 0, n
        err = float(np.max(np.abs(_np(got[n]) - w)))
        assert err <= GRAD_TOL * float(np.max(np.abs(w))), (n, err, float(np.max(np.abs(w))))


def _step_close(port_params, port_state, jax_params, jax_state, jax_grads, port_grads):
    for n, jg in jax_grads.items():
        jg, pg = np.asarray(jg, np.float32), _np(port_grads[n])
        keep = ((jg == 0) & (pg == 0)) | ((np.sign(jg) == np.sign(pg)) & (np.minimum(np.abs(jg), np.abs(pg)) > FLIP_FLOOR))
        assert 1 - keep.mean() <= FLIP_SHARE, (n, int((~keep).sum()), keep.size)
        for got, want in ((port_params[n], jax_params[n]), (port_state.mu[n], jax_state.mu[n]),
                          (port_state.nu[n], jax_state.nu[n])):
            np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep], rtol=OPT_TOL, atol=OPT_TOL)


def _jax_step(make, jm, jcfg, opt, jp, batch, **kw):
    """The JAX step (``make(jm, jcfg, opt)``) once under ``jit``: its new
    parameters, AdamW state and metrics, and the gradients it applied, by
    name."""
    step = make(jm, jcfg, _Handing(opt), **kw)
    (jnew, jg), jstate, jmetrics = jax.jit(step)(jp, opt.init(jp), batch)
    named_state = jopt.AdamWState(step=jstate.step, mu=named_tensors(jstate.mu), nu=named_tensors(jstate.nu))
    return named_tensors(jnew), named_state, jmetrics, named_tensors(jg)


def _grpo_batch(cfg, seed, b=4, s=20, prompt=6):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    blp = np.zeros((b, s - 1), np.float32)
    blp[:, prompt - 1 :] = -5.5 + 0.3 * rng.standard_normal((b, s - prompt))
    mask = np.zeros((b, s - 1), bool)
    mask[:, prompt - 1 :] = True
    adv = rng.standard_normal(b).astype(np.float32)
    return {"tokens": toks, "behavior_logprobs": blp, "advantages": adv, "loss_mask": mask}


def test_grpo_step_matches_jax(model):
    """``make_grpo_step`` on 4 x 20 tokens (longer than a chunk of 16): the
    metrics, every gradient and the new parameters and moments against the
    JAX step's. AdamW at eps 1e-2 on both sides, as
    ``tests/test_torch_moe_train.py``'s GRPO step: the GRPO gradients'
    global norm is clipped to 1, which leaves many elements near eps 1e-8,
    where AdamW's first update turns on their last bits; at eps 1e-2 the
    update is smooth in g, so every element of every tensor is held to
    1e-6."""
    jcfg, pcfg, jm, jp, named, pm, _ = model
    batch = _grpo_batch(pcfg, 12)
    jnew, jstate, jmetrics, jg = _jax_step(jsteps.make_grpo_step, jm, jcfg,
                                           jopt.AdamW(lr=1e-3, eps=1e-2, weight_decay=0.0), jp,
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    popt_ = popt.AdamW(lr=1e-3, eps=1e-2, weight_decay=0.0)
    params = from_numpy(named, "cpu")
    grads = {}
    state = popt_.init(params)
    pb = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v) for k, v in batch.items()}
    _, state, metrics = psteps.make_grpo_step(pm, pcfg, popt_, grads_out=grads)(params, state, pb)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jmetrics[k], np.float32), rtol=LOSS_TOL, atol=LOSS_TOL)
    _grads_close(grads, jg)
    for n in jg:
        for got, want in ((params[n], jnew[n]), (state.mu[n], jstate.mu[n]), (state.nu[n], jstate.nu[n])):
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=OPT_TOL, atol=OPT_TOL, err_msg=n)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(accum):
    """``make_train_step`` at the reduced config on 4 x 20 bigram tokens,
    in one step and in two microbatches (the halves' gradients averaged,
    the last one's metrics)."""
    jcfg, pcfg = _cfgs("reduced")
    jm, jp, named = _jax_params(jcfg)
    batch = BigramStream(vocab=pcfg.vocab, seq_len=20, batch=4, seed=3).next_batch()
    opt_kw = dict(lr=1e-3, weight_decay=0.01)
    jnew, jstate, jmetrics, jg = _jax_step(jsteps.make_train_step, jm, jcfg,
                                           jopt.AdamW(schedule=jopt.cosine_schedule(10, 20), **opt_kw), jp,
                                           {"tokens": jnp.asarray(batch["tokens"])}, accum=accum)
    popt_ = popt.AdamW(schedule=popt.cosine_schedule(10, 20), **opt_kw)
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
    pm = build_model(pcfg)
    _, state, metrics = psteps.make_train_step(pm, pcfg, popt_, accum=accum)(
        params, state, {"tokens": torch.from_numpy(batch["tokens"].astype(np.int64))})
    for k in jmetrics:
        np.testing.assert_allclose(_np(metrics[k]), np.asarray(jmetrics[k], np.float32), rtol=LOSS_TOL, atol=LOSS_TOL)
    mb = 4 // accum
    pl = psteps.make_loss_fn(pm, pcfg)
    pg = [psteps.value_and_grad(pl, from_numpy(named, "cpu"),
                                {"tokens": torch.from_numpy(batch["tokens"][i * mb:(i + 1) * mb].astype(np.int64))})[0]
          for i in range(accum)]
    pg = {n: sum(g[n] for g in pg) / accum for n in pg[0]}
    _grads_close(pg, jg)
    _step_close(params, state, jnew, jstate, jg, pg)


def test_forward_recomputes_the_ssd_blocks_in_the_backward(model, monkeypatch):
    """Under grad each Mamba2 block runs twice (the forward, then its
    recompute in the backward); the gradients are bit-equal to those of a
    forward without the recompute."""
    _, pcfg, _, _, _, pm, pp = model
    calls = []
    apply = ssd.ssd_block_apply

    def counted(*a, **kw):
        calls.append(1)
        return apply(*a, **kw)

    monkeypatch.setattr(ssd, "ssd_block_apply", counted)
    batch = {"tokens": torch.from_numpy(_tokens(pcfg, 2, 2, 11)).long()}
    loss_fn = psteps.make_loss_fn(pm, pcfg)
    grads, _ = psteps.value_and_grad(loss_fn, pp, batch)
    assert len(calls) == 2 * pcfg.num_layers
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", lambda fn, *a, **kw: fn(*a))
    plain, _ = psteps.value_and_grad(loss_fn, pp, batch)
    assert len(calls) == 3 * pcfg.num_layers
    for n, g in grads.items():
        assert torch.equal(g, plain[n]), n


def test_train_on_matches_the_jax_trainer():
    """``TrainerWorker`` runs the hybrid with no code of its own for it:
    ``train_on`` gives the JAX trainer's metrics and gradients."""
    from repro.core import ReferenceServer as JaxServer
    from repro.core import TensorHubClient as JaxHub
    from repro.rl.loop import RLConfig as JaxRLConfig
    from repro.rl.loop import TrainerWorker as JaxTrainer

    jcfg, pcfg = _cfgs("reduced")
    rl_kw = dict(prompt_len=5, response_len=7, num_prompts=2, group_size=4, lr=1e-3, seed=3)
    jt = JaxTrainer(JaxHub(JaxServer()), JaxRLConfig(**rl_kw), jcfg, [])
    v0 = {k: np.array(v) for k, v in named_tensors(jt.params).items()}
    rng = np.random.default_rng(9)
    rollouts = [{"tokens": rng.integers(0, pcfg.vocab, size=(4, 12)).astype(np.int32),
                 "behavior_logprobs": (-5.5 + 0.3 * rng.standard_normal((4, 7))).astype(np.float32),
                 "rewards": rng.random(4).astype(np.float32)} for _ in range(2)]
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pt = TrainerWorker(hub, RLConfig(**rl_kw), pcfg, [], params=from_numpy(v0, "cpu"), keep_grads=True)
    assert isinstance(pt.model, HybridLM)
    batch = pt.batch_from(rollouts)
    got, want = pt.train_on(rollouts), jt.train_on(rollouts)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}

    def jloss(p):
        logits = jt.model.forward(p, {"tokens": jb["tokens"].astype(jnp.int32)})
        return jobj.grpo_loss(logits, jb["tokens"].astype(jnp.int32), jb["behavior_logprobs"], jb["advantages"],
                              jb["loss_mask"])[0]

    _grads_close(pt.last_grads, named_tensors(jax.jit(jax.grad(jloss))(_jax_tree(jt.model, v0))))
    jt.close()
    pt.close()


def _losses(text):
    return [float(x) for x in re.findall(r"loss (\S+)", text)]


def test_launch_train_gives_the_jax_trainers_losses(monkeypatch, capsys):
    """``launch.train --arch zamba2-2.7b`` (the reduced config) for three
    steps on the CPU against the JAX ``launch/train.py`` (its ``main()``
    reads ``sys.argv``) from the same initial weights: the printed losses
    (steps 0 and 2) are the same."""
    argv = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "24", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train_main.main()
    want = _losses(capsys.readouterr().out)
    jcfg = jax_get_config(ARCH).reduced()
    init = {k: np.asarray(v) for k, v in named_tensors(JaxHybrid(jcfg).init(jax.random.PRNGKey(3), jnp.float32)).items()}
    monkeypatch.setattr(train_main, "init_params", lambda cfg, gen, dtype, dev: from_numpy(init, dev))
    train_main.main(argv + ["--device", "cpu"])
    got = _losses(capsys.readouterr().out)
    assert len(want) == 2 and all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)  # printed to 4 decimals
