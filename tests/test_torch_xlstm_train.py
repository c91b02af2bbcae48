"""The SSM family (xlstm-350m) trained in the port against the JAX package,
on the CPU.

The config and carried-across parameters of ``tests/test_torch_xlstm.py``
(xlstm-350m's ``reduced()``; the norms and gate biases drawn away from
zero). ``make_grpo_step`` and ``make_train_step`` (one and two
microbatches) against the JAX steps: the metrics within 2e-5, every
gradient within 1e-4 of its max |value|, the new parameters and moments
within 1e-6 (the train step's apart from the elements where AdamW's first
update turns on a rounding-level difference in the gradient, at most 5% of
a tensor, and the rounding-level zeros of the sLSTM's input-gate bias; the
GRPO step's everywhere, at AdamW's eps 1e-2). The JAX step
runs once under ``jax.jit`` with its own AdamW handing the gradients out
beside the new parameters (``_Handing``). The gradient through the chunk
padding (T = 300 at the default chunk of 256) is finite and the JAX one;
the model with its mLSTM on the parallel form gives the chunked form's
gradients. ``TrainerWorker.train_on`` against the JAX trainer;
``launch.train --arch xlstm-350m`` against the JAX ``launch/train.py``'s
printed losses.
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
from repro.models import xlstm_blocks as jxb  # noqa: E402
from repro.models.lm import XLSTMLM as JaxXLSTM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.training import objectives as jobj  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from test_torch_xlstm import ARCH, LOSS_TOL, _block_params, _cfgs, _jax_params, _jax_tree, _np, _tokens  # noqa: E402
from test_torch_hybrid_train import FLIP_FLOOR, FLIP_SHARE, GRAD_TOL, OPT_TOL, _Handing, _grpo_batch  # noqa: E402
from repro_torch.data.synthetic import BigramStream  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import build_model, xlstm_blocks as xb  # noqa: E402
from repro_torch.models.lm import XLSTMLM  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.rl.loop import RLConfig, TrainerWorker  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402


@pytest.fixture(scope="module")
def model():
    jcfg, pcfg = _cfgs()
    jm, jp, named = _jax_params(jcfg)
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _grads_close(got, want, tol=GRAD_TOL):
    assert set(got) == set(want)
    for n, w in want.items():
        w = np.asarray(w, np.float32)
        assert float(np.max(np.abs(w))) > 0, n
        assert np.isfinite(_np(got[n])).all(), n
        err = float(np.max(np.abs(_np(got[n]) - w)))
        assert err <= tol * float(np.max(np.abs(w))), (n, err, float(np.max(np.abs(w))))


#: a gradient element below this share of its tensor's max |value| in both
#: packages is a zero but for rounding
ROUNDING_ZERO = 1e-6


def _step_close(port_params, port_state, jax_params, jax_state, jax_grads, port_grads):
    """The new parameters and moments within 1e-6 where both gradients have
    one sign and are above ``FLIP_FLOOR``; at most ``FLIP_SHARE`` of the
    other elements are left out. Elements whose gradient is a zero but for
    rounding in both packages are left out and not counted: the sLSTM's
    state is a mean weighted by ``exp(i)``, unmoved by one shift of every
    step's input gate, so the input-gate part of ``b_gates`` has a zero
    gradient (~1e-10 where the other gates' are ~1e-2), and AdamW's first
    update turns the rounding's sign into a step of ``lr``."""
    for n, jg in jax_grads.items():
        jg, pg = np.asarray(jg, np.float32), _np(port_grads[n])
        zero = ((np.abs(jg) <= ROUNDING_ZERO * np.abs(jg).max()) & (np.abs(pg) <= ROUNDING_ZERO * np.abs(pg).max()))
        keep = ((jg == 0) & (pg == 0)) | ((np.sign(jg) == np.sign(pg)) & (np.minimum(np.abs(jg), np.abs(pg)) > FLIP_FLOOR))
        assert (~keep & ~zero).sum() <= FLIP_SHARE * (~zero).sum(), (n, int((~keep & ~zero).sum()), keep.size)
        for got, want in ((port_params[n], jax_params[n]), (port_state.mu[n], jax_state.mu[n]),
                          (port_state.nu[n], jax_state.nu[n])):
            np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep], rtol=OPT_TOL, atol=OPT_TOL)


def _jax_step(make, jm, jcfg, opt, jp, batch, **kw):
    step = make(jm, jcfg, _Handing(opt), **kw)
    (jnew, jg), jstate, jmetrics = jax.jit(step)(jp, opt.init(jp), batch)
    named_state = jopt.AdamWState(step=jstate.step, mu=named_tensors(jstate.mu), nu=named_tensors(jstate.nu))
    return named_tensors(jnew), named_state, jmetrics, named_tensors(jg)


def test_grpo_step_matches_jax(model):
    """``make_grpo_step`` on 4 x 20 tokens: the metrics, every gradient and
    the new parameters and moments against the JAX step's (AdamW at eps
    1e-2 on both sides, as ``tests/test_torch_hybrid_train.py``'s GRPO
    step, so every element is held to 1e-6)."""
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
def test_train_step_matches_jax(model, accum):
    """``make_train_step`` on 4 x 20 bigram tokens, in one step and in two
    microbatches (the halves' gradients averaged, the last one's
    metrics)."""
    jcfg, pcfg, jm, jp, named, pm, _ = model
    batch = BigramStream(vocab=pcfg.vocab, seq_len=20, batch=4, seed=3).next_batch()
    opt_kw = dict(lr=1e-3, weight_decay=0.01)
    jnew, jstate, jmetrics, jg = _jax_step(jsteps.make_train_step, jm, jcfg,
                                           jopt.AdamW(schedule=jopt.cosine_schedule(10, 20), **opt_kw), jp,
                                           {"tokens": jnp.asarray(batch["tokens"])}, accum=accum)
    popt_ = popt.AdamW(schedule=popt.cosine_schedule(10, 20), **opt_kw)
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
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


def test_gradient_through_the_chunk_padding_is_finite_and_jaxs():
    """One mLSTM block of the reduced config at T = 300 (two chunks of the
    default 256, 212 padded steps with ``i = -1e30``, ``f = +1e30``):
    ``jax.grad`` of the JAX block and the port's autograd, with respect to
    the input and every parameter, are finite and agree within 1e-4 of
    each gradient's max |value|; the port's parallel form gives the same."""
    jcfg, pcfg = _cfgs()
    _, _, named = _jax_params(jcfg)
    lp = _block_params(named, "pairs/mlstm/", (0, 0))
    x = np.random.default_rng(8).standard_normal((1, 300, pcfg.d_model)).astype(np.float32)
    names = sorted(lp)

    def jloss(p, x):
        return (jxb.mlstm_block_apply(jcfg, p, x)[0] ** 2).sum()

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))({n: jnp.asarray(v) for n, v in lp.items()}, jnp.asarray(x))
    want = {**{n: np.asarray(jgp[n]) for n in names}, "x": np.asarray(jgx)}
    for form in ("chunked", "parallel"):
        leaves = {n: torch.from_numpy(lp[n].copy()).requires_grad_() for n in names}
        xt = torch.from_numpy(x).requires_grad_()
        (out, _) = xb.mlstm_block_apply(pcfg, leaves, xt, form=form)
        grads = torch.autograd.grad((out**2).sum(), [leaves[n] for n in names] + [xt])
        _grads_close(dict(zip(names + ["x"], grads)), want)


def test_forward_forms_give_the_same_gradients(model):
    """The GRPO loss's gradients with the mLSTM on the chunked form (the
    default) and on the parallel form (``build_model(cfg, mlstm=
    "parallel")``, the reference ``chip_smoke.py`` phase 17 holds the
    chunked step to) agree within 1e-4 of each gradient's max |value|."""
    _, pcfg, _, _, _, pm, pp = model
    batch = {k: torch.from_numpy(v.astype(np.int64) if k == "tokens" else v)
             for k, v in _grpo_batch(pcfg, 13).items()}
    chunked, m1 = psteps.value_and_grad(psteps.make_grpo_loss_fn(pm), pp, batch)
    parallel, m2 = psteps.value_and_grad(psteps.make_grpo_loss_fn(build_model(pcfg, mlstm="parallel")), pp, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=LOSS_TOL, atol=LOSS_TOL)
    _grads_close(chunked, {n: _np(g) for n, g in parallel.items()})


def test_train_on_matches_the_jax_trainer():
    """``TrainerWorker`` runs the xLSTM with no code of its own for it:
    ``train_on`` gives the JAX trainer's metrics and gradients."""
    from repro.core import ReferenceServer as JaxServer
    from repro.core import TensorHubClient as JaxHub
    from repro.rl.loop import RLConfig as JaxRLConfig
    from repro.rl.loop import TrainerWorker as JaxTrainer

    jcfg, pcfg = _cfgs()
    rl_kw = dict(prompt_len=5, response_len=7, num_prompts=2, group_size=4, lr=1e-3, seed=3)
    jt = JaxTrainer(JaxHub(JaxServer()), JaxRLConfig(**rl_kw), jcfg, [])
    v0 = {k: np.array(v) for k, v in named_tensors(jt.params).items()}
    rng = np.random.default_rng(9)
    rollouts = [{"tokens": rng.integers(0, pcfg.vocab, size=(4, 12)).astype(np.int32),
                 "behavior_logprobs": (-5.5 + 0.3 * rng.standard_normal((4, 7))).astype(np.float32),
                 "rewards": rng.random(4).astype(np.float32)} for _ in range(2)]
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pt = TrainerWorker(hub, RLConfig(**rl_kw), pcfg, [], params=from_numpy(v0, "cpu"), keep_grads=True)
    assert isinstance(pt.model, XLSTMLM)
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
    """``launch.train --arch xlstm-350m`` (the reduced config) for three
    steps on the CPU against the JAX ``launch/train.py`` (its ``main()``
    reads ``sys.argv``) from the same initial weights: the printed losses
    (steps 0 and 2) are the same."""
    argv = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "24", "--seed", "3"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train_main.main()
    want = _losses(capsys.readouterr().out)
    jcfg = jax_get_config(ARCH).reduced()
    init = {k: np.asarray(v) for k, v in named_tensors(JaxXLSTM(jcfg).init(jax.random.PRNGKey(3), jnp.float32)).items()}
    monkeypatch.setattr(train_main, "init_params", lambda cfg, gen, dtype, dev: from_numpy(init, dev))
    train_main.main(argv + ["--device", "cpu"])
    got = _losses(capsys.readouterr().out)
    assert len(want) == 2 and all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)  # printed to 4 decimals


def test_launch_train_runs_the_published_widths_on_the_host(capsys, monkeypatch):
    """``launch.train --arch xlstm-350m --full-config`` takes the published
    config (24 layers, d_model 1024) to ``init_params`` and the step; here
    at 2 of its layers and vocab 512 so that the host's step is short: two
    finite losses."""
    import dataclasses

    real = train_main.get_config
    monkeypatch.setattr(train_main, "get_config",
                        lambda arch: dataclasses.replace(real(arch), num_layers=2, vocab=512))
    train_main.main(["--arch", ARCH, "--full-config", "--device", "cpu", "--steps", "2", "--batch", "1", "--seq",
                     "8"])
    losses = _losses(capsys.readouterr().out)
    assert len(losses) == 2 and all(np.isfinite(losses))
