"""The VLM family (internvl2-2b) in the port against the JAX package, on
the CPU.

internvl2-2b's ``reduced()`` (4 layers, d_model 64, 4 query heads of 16,
vocab 256, 4 precomputed patches) in f32, as it stands (its KV heads
collapse to 4, a group of 1) and with 2 KV heads (the published config's
group of 2); its JAX parameters carried across with ``from_numpy``. The
patches (``[B, P, d_model]``, numpy from a seed) come before the tokens:
the port's ``forward``, ``prefill`` (logits, cache and its length ``P +
prompt_len``) and a decode chain from there must be within 2e-5 of the JAX
``DecoderLM``'s; the LM train step, whose loss starts after the patches
(``text_offset = num_patches``), within the training files' tolerances of
``jax.grad`` and the JAX step (2e-5 on the loss, 1e-4 of each gradient's
max |value|, 1e-6 on the new parameters and moments apart from the
elements where AdamW's first update turns on a rounding-level difference
in the gradient, at most 5% of a tensor); ``launch.train --arch
internvl2-2b`` on the CPU prints the JAX trainer's losses from the same
initial weights and patches (the port's stand-in patches, not the JAX
trainer's zeros: with zeros both packages' gradients overflow at 16
layers). ``check_ported`` takes the VLM family and still refuses
the audio, hybrid and SSM families by name.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_train_main  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import BigramStream  # noqa: E402
from repro_torch.launch import serve as serve_main  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import build_model, check_ported, check_trainable  # noqa: E402
from repro_torch.models.params import from_numpy  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

ARCH = "internvl2-2b"
TOL = LOSS_TOL = 2e-5
GRAD_TOL, OPT_TOL, FLIP_FLOOR, FLIP_SHARE = 1e-4, 1e-6, 1e-5, 0.05
#: the reduced config as it stands, and with the published group of 2
VARIANTS = {"reduced": {}, "reduced_g2": {"num_kv_heads": 2}}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, pcfg = _cfgs(request.param)
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    rng = np.random.default_rng(7)
    for k in named:
        if k.endswith("ln"):  # 1 + gamma exercised
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    jp = jax.tree.unflatten(jax.tree.structure(jp), [jnp.asarray(named[k]) for k in named_tensors(jp)])
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _inputs(cfg, seed, b, s):
    """numpy patches at the embedding's scale and tokens."""
    rng = np.random.default_rng(seed)
    patches = (rng.standard_normal((b, cfg.num_patches, cfg.d_model)) * 0.5).astype(np.float32)
    return patches, rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)


def _jb(patches, toks):
    return {"patches": jnp.asarray(patches), "tokens": jnp.asarray(toks)}


def _pb(patches, toks):
    return {"patches": torch.from_numpy(patches), "tokens": torch.from_numpy(toks).long()}


def test_reduced_config_is_the_vlm_family():
    jcfg, pcfg = _cfgs("reduced")
    assert pcfg.family == jcfg.family == "vlm" and pcfg.frontend == "vision" and pcfg.num_patches == 4
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab, full.num_patches, full.rope_theta, full.tie_embeddings) == (
        24, 2048, 16, 8, 128, 8192, 92553, 256, 1e6, False)


def test_forward_matches_jax(model):
    jcfg, pcfg, jm, jp, _, pm, pp = model
    patches, toks = _inputs(pcfg, 0, 2, 11)
    want = jm.forward(jp, _jb(patches, toks))
    got = pm.forward(pp, _pb(patches, toks))
    assert got.shape == (2, pcfg.num_patches + 11, pcfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_prefill_matches_jax(model):
    jcfg, pcfg, jm, jp, _, pm, pp = model
    patches, toks = _inputs(pcfg, 1, 3, 9)
    m = pcfg.num_patches + 9 + 4
    jl, jc, jn = jm.prefill(jp, _jb(patches, toks), max_len=m)
    pl, pc, pn = pm.prefill(pp, _pb(patches, toks), max_len=m)
    assert pn == int(jn) == pcfg.num_patches + 9
    _close(pl, jl)
    for n in ("k", "v"):
        assert tuple(pc["layers"][n].shape) == jc["layers"][n].shape
        _close(pc["layers"][n], jc["layers"][n])


def test_decode_chain_matches_jax(model):
    """Decode continues from ``P + prompt_len``; its logits are the
    teacher-forced forward's at the same positions."""
    jcfg, pcfg, jm, jp, _, pm, pp = model
    patches, toks = _inputs(pcfg, 2, 2, 7)
    nxt = np.random.default_rng(3).integers(0, pcfg.vocab, size=(2, 6)).astype(np.int32)
    m = pcfg.num_patches + 7 + 6
    jl, jc, jn = jm.prefill(jp, _jb(patches, toks), max_len=m)
    pl, pc, pn = pm.prefill(pp, _pb(patches, toks), max_len=m)
    for t in range(6):
        jl, jc = jm.decode(jp, jc, jnp.asarray(nxt[:, t : t + 1]), jn)
        jn = jn + 1
        pl, pc = pm.decode(pp, pc, torch.from_numpy(nxt[:, t : t + 1]).long(), pn)
        pn += 1
        _close(pl, jl)
    assert pn == m
    for n in ("k", "v"):
        _close(pc["layers"][n], jc["layers"][n])
    full = pm.forward(pp, _pb(patches, np.concatenate([toks, nxt], 1)))
    _close(pl[:, 0], full[:, -1])


def test_patches_take_the_activation_dtype(model):
    """f32 patches into a bf16 model are cast to bf16 before the layers,
    as the JAX package's ``astype(x.dtype)``: the same logits as patches
    given in bf16."""
    _, pcfg, _, _, named, pm, _ = model
    pp = {k: v.to(torch.bfloat16) for k, v in from_numpy(named, "cpu").items()}
    patches, toks = _inputs(pcfg, 4, 2, 5)
    b = _pb(patches, toks)
    got = pm.forward(pp, b)
    want = pm.forward(pp, dict(b, patches=b["patches"].to(torch.bfloat16)))
    assert torch.equal(got, want)


def test_train_step_matches_jax(model):
    """make_train_step on 4 sequences of 4 patches + 12 tokens: loss and
    accuracy over the text positions, the gradient and the step's new
    parameters and moments against the JAX step's."""
    jcfg, pcfg, jm, _, named, pm, _ = model
    patches, _ = _inputs(pcfg, 5, 4, 1)
    toks = BigramStream(vocab=pcfg.vocab, seq_len=12, batch=4, seed=3).next_batch()["tokens"]
    jopt_ = jopt.AdamW(lr=1e-3, weight_decay=0.01, schedule=jopt.cosine_schedule(10, 20))
    template = jm.init(jax.random.PRNGKey(0), jnp.float32)
    jtree = jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(named[k]) for k in named_tensors(template)])
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_train_step(jm, jcfg, jopt_))(jtree, jstate, _jb(patches, toks))

    popt_ = popt.AdamW(lr=1e-3, weight_decay=0.01, schedule=popt.cosine_schedule(10, 20))
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
    _, state, metrics = psteps.make_train_step(pm, pcfg, popt_)(params, state, _pb(patches, toks))
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy"}
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)
    jg = named_tensors(jax.grad(lambda p: jsteps.make_loss_fn(jm, jcfg)(p, _jb(patches, toks))[0])(jtree))
    pg, _ = psteps.value_and_grad(psteps.make_loss_fn(pm, pcfg), from_numpy(named, "cpu"), _pb(patches, toks))
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


def _losses(text):
    return [float(x) for x in re.findall(r"loss (\S+)", text)]


def test_launch_train_gives_the_jax_trainers_losses(monkeypatch, capsys):
    """``launch.train --arch internvl2-2b`` (the reduced config: stand-in
    patches, ``--seq`` less 4 tokens) for three steps on the CPU against
    the JAX ``launch/train.py`` from the same initial weights, the JAX
    trainer fed the port's stand-in patches where it builds its zeros: the
    printed losses are the same."""
    argv = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "16", "--seed", "3"]
    pcfg = get_config(ARCH).reduced()
    steps = iter(range(3))

    class StandInPatches:
        """The JAX trainer's ``jnp``, its patch zeros replaced by the port's patches."""

        def __getattr__(self, name):
            return getattr(jnp, name)

        def zeros(self, shape, dtype=None):
            if tuple(shape) == (2, pcfg.num_patches, pcfg.d_model):
                return jnp.asarray(train_main.stand_in_patches(pcfg, 2, 3, next(steps)))
            return jnp.zeros(shape, dtype)

    monkeypatch.setattr(jax_train_main, "jnp", StandInPatches())
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jax_train_main.main()
    want = _losses(capsys.readouterr().out)
    assert next(steps, None) is None  # every step took the port's patches
    jcfg = jax_get_config(ARCH).reduced()
    init = {k: np.asarray(v) for k, v in named_tensors(JaxLM(jcfg).init(jax.random.PRNGKey(3), jnp.float32)).items()}
    monkeypatch.setattr(train_main, "init_params", lambda cfg, gen, dtype, dev: from_numpy(init, dev))
    train_main.main(argv + ["--device", "cpu"])
    got = _losses(capsys.readouterr().out)
    assert len(want) == 2 and all(np.isfinite(want))  # steps 0 and 2 print
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)  # printed to 4 decimals


def test_zero_patches_overflow_in_both_packages_at_16_layers():
    """Why ``launch.train`` draws its stand-in patches: with the JAX
    package's zero patches an all-zero row's RMS norm passes its gradient
    on 1000-fold a layer (1/sqrt(eps)), and at 16 layers the weight
    gradients turn non-finite, the same tensors in both packages; the
    stand-in patches keep every gradient finite."""
    jcfg, pcfg = (dataclasses.replace(c, num_layers=16) for c in _cfgs("reduced"))
    jm = JaxLM(jcfg)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(jp).items()}
    toks = np.random.default_rng(0).integers(0, pcfg.vocab, size=(2, 12)).astype(np.int32)
    bad = {}
    for name, patches in (("zeros", np.zeros((2, pcfg.num_patches, pcfg.d_model), np.float32)),
                          ("stand-in", train_main.stand_in_patches(pcfg, 2, 0, 0))):
        jg = named_tensors(jax.grad(lambda p: jsteps.make_loss_fn(jm, jcfg)(p, _jb(patches, toks))[0])(jp))
        pg, _ = psteps.value_and_grad(psteps.make_loss_fn(build_model(pcfg), pcfg), from_numpy(named, "cpu"),
                                      _pb(patches, toks))
        bad[name] = (sorted(k for k, v in jg.items() if not np.isfinite(np.asarray(v)).all()),
                     sorted(k for k, v in pg.items() if not torch.isfinite(v).all()))
    assert bad["zeros"][0] == bad["zeros"][1] and "embed" in bad["zeros"][0]
    assert bad["stand-in"] == ([], [])


def test_check_ported_takes_the_vlm_and_refuses_the_rest():
    for arch in (ARCH,):
        for cfg in (get_config(arch), get_config(arch).reduced()):
            check_ported(cfg)
            check_trainable(cfg)
            assert build_model(cfg).cfg is cfg
    for arch, family in (("hubert-xlarge", "audio"), ("zamba2-2.7b", "hybrid"), ("xlstm-350m", "SSM")):
        cfg = get_config(arch)
        for fn in (check_ported, check_trainable, build_model):
            with pytest.raises(NotImplementedError, match=family):
                fn(cfg)


def test_serve_entry_point_refuses_a_vlm_before_allocating(monkeypatch, capsys):
    """``launch.serve``'s requests are token prompts (as the JAX package's):
    a VLM request carries patches, so the entry point exits naming it."""
    monkeypatch.setattr(serve_main, "init_params", lambda *a, **k: pytest.fail("allocated"))
    with pytest.raises(SystemExit) as exc:
        serve_main.main(["--arch", ARCH, "--device", "cpu"])
    assert exc.value.code == 2 and "patches" in capsys.readouterr().err
