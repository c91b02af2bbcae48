"""gemma2 trained in the port against the JAX package, on the CPU, at
gemma2's published head_dim of 256.

* The ``FlashAttention`` Function at head_dim 256 (on the CPU it runs
  ``attention_plain`` and ``attention_backward_plain``), windowed and
  softcapped, against ``jax.grad`` of the JAX package's
  ``chunked_attention`` and of ``attention_ref``.
* A small gemma2: ``reduced()`` with head_dim 256 and 4 query on 2 KV
  heads (gemma2's 2:1), window 8, sequences of 16-20 tokens so the window
  bites, softcaps 50 and 30, tied embeddings, in f32, its JAX parameters
  carried across with ``from_numpy``. Its ``make_train_step`` (loss,
  gradients, the AdamW step) against the JAX ``make_train_step``, and
  ``TrainerWorker.train_on`` against the JAX ``TrainerWorker``.
* ``launch.train --arch gemma2-2b`` at head_dim 256 (the registry's
  config patched to the small one) takes two steps on the CPU.

Tolerances, as ``tests/test_torch_training.py`` and
``tests/test_torch_rl_train.py`` state them: losses 2e-5 relative and
absolute (``tests/test_kernels.py``'s f32); the attention's gradients
within 2e-5 of each gradient's max |value| (``chip_smoke.py`` phase 2's
norm: at head_dim 256 a dK element sums 256-wide products over every row
that sees its key, and against a float64 truth both frameworks' f32 sums
are off by up to 2e-6 of |dK|'s max, ~4e-5 absolute where it reaches 20,
which no small element could meet absolutely); a whole model's
gradients within 1e-4 of each tensor's max |value|; the step's new
parameters and moments within 1e-6 apart from the elements where AdamW's
first update ``~ lr * sign(g)`` turns on a rounding-level difference in g
(counted, at most 5% of a tensor).
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jax_core  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention import attention_ref  # noqa: E402
from repro.models.layers import chunked_attention  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.rl.loop import RLConfig as JaxRLConfig  # noqa: E402
from repro.rl.loop import TrainerWorker as JaxTrainer  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import BigramStream  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.rl import RLConfig, TrainerWorker  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

SMALL = dict(head_dim=256, num_heads=4, num_kv_heads=2)
JAX_CFG = dataclasses.replace(jax_get_config("gemma2-2b").reduced(), **SMALL)
PORT_CFG = dataclasses.replace(get_config("gemma2-2b").reduced(), **SMALL)
TOL = LOSS_TOL = 2e-5
GRAD_TOL, OPT_TOL, FLIP_FLOOR, FLIP_SHARE = 1e-4, 1e-6, 1e-5, 0.05
JAX_METRIC_KEYS = {"loss", "mean_ratio", "mean_advantage", "mean_reward", "version"}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_config_is_gemma2_at_its_published_head_dim():
    assert PORT_CFG.resolved_head_dim == 256 and PORT_CFG.sliding_window == 8 and PORT_CFG.tie_embeddings
    assert PORT_CFG.attn_softcap == 50.0 and PORT_CFG.logit_softcap == 30.0
    assert {f.name: getattr(PORT_CFG, f.name) for f in dataclasses.fields(PORT_CFG)} == {
        f.name: getattr(JAX_CFG, f.name) for f in dataclasses.fields(JAX_CFG) if hasattr(PORT_CFG, f.name)}


# -- the attention's gradient at head_dim 256 -------------------------------------------

#: (b, hq, hkv, sq, window, softcap, q_scale): gemma2's 2:1 group and a
#: group of one, windows inside a row's keys and wider than them
GRAD_CASES = [
    (1, 4, 2, 20, 4, 50.0, 8.0),
    (2, 2, 2, 24, 8, 0.0, 1.0),
    (1, 4, 2, 17, 0, 50.0, 8.0),
    (1, 8, 4, 30, 64, 50.0, 8.0),
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_function_at_head_dim_256_matches_jax_grad(case):
    """The Function's gradient (the plain backward on the CPU) against
    jax.grad of chunked_attention and of attention_ref; q is scaled so
    the softcap's bend shows."""
    b, hq, hkv, sq, window, cap, q_scale = case
    rng = np.random.default_rng(sq + window)
    q, k, v, dout = (rng.standard_normal(s).astype(np.float32)
                     for s in ((b, hq, sq, 256), (b, hkv, sq, 256), (b, hkv, sq, 256), (b, hq, sq, 256)))
    q = q * np.float32(q_scale)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True, softcap=cap, window=window)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))

    def chunked(q, k, v):
        return jnp.sum(chunked_attention(q, k, v, causal=True, window=window, attn_softcap=cap, block_k=8) * dout)

    def ref(q, k, v):
        return jnp.sum(attention_ref(q, k, v, causal=True, window=window, softcap=cap) * dout)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for oracle in (chunked, ref):
        want = jax.grad(oracle, argnums=(0, 1, 2))(jq, jk, jv)
        for name, g, w in zip("qkv", got, want):
            w = np.asarray(w, np.float32)
            assert float(np.max(np.abs(_np(g) - w))) <= TOL * float(np.max(np.abs(w))), (name, oracle.__name__)


# -- a small gemma2's train step and train_on -------------------------------------------


@pytest.fixture(scope="module")
def model():
    jm = JaxLM(JAX_CFG)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(5)
    for k in named:
        if k.endswith("ln"):  # ln, post_ln and final_ln: 1 + gamma exercised
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    return jm, named


def _jax_tree(jm, named):
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    return jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(named[k]) for k in named_tensors(template)])


def test_train_step_matches_jax(model):
    """make_train_step on 4 sequences of 20 tokens (past the window of 8):
    loss and accuracy, the gradient of the loss and the step's new
    parameters and moments against the JAX step's."""
    jm, named = model
    batch = BigramStream(vocab=JAX_CFG.vocab, seq_len=20, batch=4, seed=3).next_batch()
    jopt_ = jopt.AdamW(lr=1e-3, weight_decay=0.01, schedule=jopt.cosine_schedule(10, 20))
    jtree = _jax_tree(jm, named)
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_train_step(jm, JAX_CFG, jopt_))(
        jtree, jstate, {"tokens": jnp.asarray(batch["tokens"])})

    popt_ = popt.AdamW(lr=1e-3, weight_decay=0.01, schedule=popt.cosine_schedule(10, 20))
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
    tokens = torch.from_numpy(batch["tokens"].astype(np.int64))
    _, state, metrics = psteps.make_train_step(build_model(PORT_CFG), PORT_CFG, popt_)(params, state,
                                                                                      {"tokens": tokens})
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy"}
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)

    jg = named_tensors(jax.grad(lambda p: jsteps.make_loss_fn(jm, JAX_CFG)(p, {"tokens": jnp.asarray(
        batch["tokens"])})[0])(jtree))
    pg, _ = psteps.value_and_grad(psteps.make_loss_fn(build_model(PORT_CFG), PORT_CFG), from_numpy(named, "cpu"),
                                  {"tokens": tokens})
    assert set(pg) == set(jg)
    for n, w in jg.items():
        w = np.asarray(w, np.float32)
        assert float(np.max(np.abs(w))) > 0, n
        assert float(np.max(np.abs(_np(pg[n]) - w))) <= GRAD_TOL * float(np.max(np.abs(w))), n
    jnew = named_tensors(jnew)
    jmu, jnu = named_tensors(jstate.mu), named_tensors(jstate.nu)
    for n, w in jg.items():
        w, g = np.asarray(w, np.float32), _np(pg[n])
        keep = ((w == 0) & (g == 0)) | ((np.sign(w) == np.sign(g)) & (np.minimum(np.abs(w), np.abs(g)) > FLIP_FLOOR))
        assert 1 - keep.mean() <= FLIP_SHARE, (n, int((~keep).sum()), keep.size)
        for got, want in ((params[n], jnew[n]), (state.mu[n], jmu[n]), (state.nu[n], jnu[n])):
            np.testing.assert_allclose(_np(got)[keep], np.asarray(want, np.float32)[keep], rtol=OPT_TOL, atol=OPT_TOL)


def _rollouts(seed, n_rec, per_rec, prompt_len, response_len, vocab):
    rng = np.random.default_rng(seed)
    return [{
        "tokens": rng.integers(0, vocab, size=(per_rec, prompt_len + response_len)).astype(np.int32),
        "behavior_logprobs": (-5.5 + 0.3 * rng.standard_normal((per_rec, response_len))).astype(np.float32),
        "rewards": rng.random(per_rec).astype(np.float32),
    } for _ in range(n_rec)]


def test_train_on_matches_the_jax_trainer():
    """One GRPO step of the port's TrainerWorker (prompts of 8 + responses
    of 8 tokens: past the window) against the JAX TrainerWorker's on the
    same rollouts from the same v0: metrics, gradients and new params."""
    rl_kw = dict(prompt_len=8, response_len=8, num_prompts=2, group_size=4, lr=1e-3, seed=3)
    jt = JaxTrainer(jax_core.TensorHubClient(jax_core.ReferenceServer()), JaxRLConfig(**rl_kw), JAX_CFG, [])
    v0 = {k: np.array(v) for k, v in named_tensors(jt.params).items()}
    rollouts = _rollouts(9, 2, 4, rl_kw["prompt_len"], rl_kw["response_len"], JAX_CFG.vocab)
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
    pt = TrainerWorker(hub, RLConfig(**rl_kw), PORT_CFG, [], params=from_numpy(v0, "cpu"), keep_grads=True)
    batch = pt.batch_from(rollouts)

    got = pt.train_on(rollouts)
    want = jt.train_on(rollouts)
    assert set(got) == set(want) == JAX_METRIC_KEYS
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)

    from repro.training import objectives as jobj

    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jbatch["tokens"] = jbatch["tokens"].astype(jnp.int32)
    template = jt.model.init(jax.random.PRNGKey(0), jnp.float32)
    jv0 = jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(v0[k]) for k in named_tensors(template)])

    def jloss(p):
        logits = jt.model.forward(p, {"tokens": jbatch["tokens"]})
        return jobj.grpo_loss(logits, jbatch["tokens"], jbatch["behavior_logprobs"], jbatch["advantages"],
                              jbatch["loss_mask"])[0]

    jg = {k: np.asarray(v) for k, v in named_tensors(jax.grad(jloss)(jv0)).items()}
    v1 = {k: np.asarray(v) for k, v in named_tensors(jt.params).items()}
    for n, g in jg.items():
        pg = pt.last_grads[n].numpy()
        assert np.max(np.abs(pg - g)) <= GRAD_TOL * np.max(np.abs(g)), n
        keep = ((g == 0) & (pg == 0)) | ((np.sign(g) == np.sign(pg)) & (np.minimum(np.abs(g), np.abs(pg)) > FLIP_FLOOR))
        assert keep.mean() >= 1 - FLIP_SHARE, (n, int((~keep).sum()))
        np.testing.assert_allclose(pt.params[n].numpy()[keep], v1[n][keep], rtol=OPT_TOL, atol=OPT_TOL, err_msg=n)
    jt.close()
    pt.close()


def test_train_entry_point_at_head_dim_256_on_the_cpu(monkeypatch, capsys):
    """launch.train --arch gemma2-2b with the registry's config patched to
    the small one at head_dim 256 (--full-config takes it as it is): two
    steps with finite losses, the attention's gradient through the
    Function on every layer."""
    monkeypatch.setattr(train_main, "get_config", lambda arch: PORT_CFG if arch == "gemma2-2b" else get_config(arch))
    calls = []
    apply = fa.FlashAttention.apply
    monkeypatch.setattr(fa.FlashAttention, "apply", lambda *a: calls.append(a[0].shape) or apply(*a))
    train_main.main(["--arch", "gemma2-2b", "--full-config", "--device", "cpu", "--steps", "2", "--batch", "2",
                     "--seq", "20"])
    losses = [float(x) for x in re.findall(r"loss (\S+)", capsys.readouterr().out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert calls == [(2, 4, 20, 256)] * (2 * PORT_CFG.num_layers)
