"""The audio family (hubert-xlarge) in the port against the JAX package, on
the CPU.

hubert-xlarge's ``reduced()`` (4 layers, d_model 64, 4 heads of 16, d_ff
128, vocab 256, frames of 32) in f32, and the same at head_dim 80 (d_model
160, 2 heads of 80: the published head_dim, whose attention runs on the
card's head_dim-80 kernels); the JAX ``EncoderLM``'s parameters carried
across with ``from_numpy``, norms and biases drawn nonzero so every term
is exercised. The port's ``EncoderLM.forward`` (bidirectional attention,
rope, the tanh-form GELU MLP) must be within 2e-5 of the JAX one on the
same numpy frames; ``gelu_mlp`` within 1e-6 of the JAX one (the exact-erf
GELU would not be); ``audio_batch`` array-equal; one masked-prediction
train step within the training files' tolerances of ``jax.grad`` and the
JAX step (2e-5 on the loss, 1e-4 of each gradient's max |value|, 1e-6 on
the new parameters and moments apart from the elements where AdamW's first
update turns on a rounding-level difference in the gradient, at most 5% of
a tensor); ``launch.train --arch hubert-xlarge`` prints the JAX trainer's
losses, alone, with ``--publish`` and resumed from a checkpoint;
``launch.serve`` refuses it with the JAX package's words; the full
config's parameter names and shapes are the JAX ``param_specs()``'s; and a
hubert replica crosses between the packages bit-equal both ways.
"""

import dataclasses
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.launch import train as jax_train_main  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.lm import EncoderLM as JaxEncoder  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402

import test_torch_moe_interop as interop  # noqa: E402  (its replica scenario, run here on hubert)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import synthetic as port_synthetic  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import serve as serve_main  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import build_model, check_ported, check_trainable, layers  # noqa: E402
from repro_torch.models.lm import EncoderLM  # noqa: E402
from repro_torch.models.params import decoder_shapes, from_numpy, init_params  # noqa: E402
from repro_torch.training import optimizer as popt  # noqa: E402
from repro_torch.training import steps as psteps  # noqa: E402

ARCH = "hubert-xlarge"
TOL = LOSS_TOL = 2e-5
GRAD_TOL, OPT_TOL, FLIP_FLOOR, FLIP_SHARE = 1e-4, 1e-6, 1e-5, 0.05
GELU_TOL = 1e-6
#: the reduced config as it stands (head_dim 16), and at the published head_dim 80
VARIANTS = {"reduced": {}, "head_dim_80": {"d_model": 160, "num_heads": 2, "num_kv_heads": 2}}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(variant):
    kw = VARIANTS[variant]
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _jax_params(jcfg, seed: int = 0):
    """The JAX encoder's parameters as numpy by name, norms and biases
    drawn nonzero (``1 + gamma`` and the biases exercised), and the JAX
    tree holding them."""
    jm = JaxEncoder(jcfg)
    template = jm.init(jax.random.PRNGKey(seed), jnp.float32)
    named = {k: np.asarray(v) for k, v in named_tensors(template).items()}
    rng = np.random.default_rng(7)
    for k in named:
        if k.endswith(("ln", "b_up", "b_down")):
            named[k] = (rng.standard_normal(named[k].shape) * 0.1).astype(np.float32)
    tree = jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(named[k]) for k in named_tensors(template)])
    return jm, tree, named


@pytest.fixture(scope="module", params=list(VARIANTS))
def model(request):
    jcfg, pcfg = _cfgs(request.param)
    jm, jp, named = _jax_params(jcfg)
    return jcfg, pcfg, jm, jp, named, build_model(pcfg), from_numpy(named, "cpu")


def _frames(cfg, seed, b, s):
    return np.random.default_rng(seed).standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)


def test_reduced_and_full_configs_are_the_audio_family():
    jcfg, pcfg = _cfgs("head_dim_80")
    assert pcfg.family == jcfg.family == "audio" and pcfg.encoder_only and pcfg.resolved_head_dim == 80
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads, full.resolved_head_dim, full.d_ff,
            full.vocab, full.frontend_dim, full.rope_theta, full.encoder_only) == (
        48, 1280, 16, 16, 80, 5120, 504, 512, 1e4, True)
    assert full.param_count() == 945_018_880


@pytest.mark.parametrize("s", [77, 128])
def test_forward_matches_jax(model, s):
    jcfg, pcfg, jm, jp, _, pm, pp = model
    frames = _frames(pcfg, s, 2, s)
    want = jm.forward(jp, {"frames": jnp.asarray(frames)})
    got = pm.forward(pp, {"frames": torch.from_numpy(frames)})
    assert isinstance(pm, EncoderLM) and got.shape == (2, s, pcfg.vocab) and got.dtype == torch.float32
    _close(got, want)


def test_forward_is_bidirectional(model):
    """A frame changed at the end moves the logits of the first position
    (no causal mask), and every layer calls the attention with
    ``causal=False``."""
    _, pcfg, _, _, _, _, pp = model
    calls = []

    def attention(q, k, v, **kw):
        calls.append(kw)
        return fa.attention_plain(q, k, v, **kw)

    pm = build_model(pcfg, attention=attention)
    frames = _frames(pcfg, 5, 1, 20)
    a = pm.forward(pp, {"frames": torch.from_numpy(frames)})
    frames[:, -1] += 1.0
    b = pm.forward(pp, {"frames": torch.from_numpy(frames)})
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4
    assert len(calls) == 2 * pcfg.num_layers and all(kw["causal"] is False for kw in calls)


def test_gelu_mlp_is_the_tanh_form():
    """``gelu_mlp`` against the JAX one, pre-activations spread over +-6:
    within 1e-6; the exact-erf GELU misses that bound by orders of
    magnitude (the two forms part by up to ~5e-4 near |x| = 2)."""
    rng = np.random.default_rng(0)
    d, f = 16, 64
    x = rng.uniform(-1, 1, (3, 7, d)).astype(np.float32)
    w_up = (rng.standard_normal((d, f)) * 1.5).astype(np.float32)
    b_up = rng.uniform(-2, 2, f).astype(np.float32)
    w_down = (rng.standard_normal((f, d)) / 8).astype(np.float32)
    b_down = rng.standard_normal(d).astype(np.float32)
    pre = x @ w_up + b_up
    assert pre.min() < -5 and pre.max() > 5  # the inputs reach where the forms part
    args = (x, w_up, b_up, w_down, b_down)
    want = np.asarray(jax_layers.gelu_mlp(*(jnp.asarray(a) for a in args)))
    got = layers.gelu_mlp(*(torch.from_numpy(a) for a in args))
    _close(got, want, GELU_TOL)
    grid = torch.linspace(-6, 6, 1201)
    tanh_form = np.asarray(jax.nn.gelu(jnp.asarray(grid.numpy())))
    _close(torch.nn.functional.gelu(grid, approximate="tanh"), tanh_form, GELU_TOL)
    erf = torch.nn.functional.gelu(grid)  # torch's default, the exact form
    assert float(np.max(np.abs(erf.numpy() - tanh_form))) > 100 * GELU_TOL
    t = [torch.from_numpy(a) for a in args]
    exact = torch.nn.functional.gelu(t[0] @ t[1] + t[2]) @ t[3] + t[4]
    assert float(np.max(np.abs(exact.numpy() - want))) > GELU_TOL


@pytest.mark.parametrize("seed", [0, 1, 7, 100_003, 2**31 - 1])
def test_audio_batch_equals_jax(seed):
    got = port_synthetic.audio_batch(3, 41, 32, 504, seed)
    want = jax_synthetic.audio_batch(3, 41, 32, 504, seed)
    assert got.keys() == want.keys() == {"frames", "targets", "mask"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["mask"].any()


def _batches(cfg, seed, b, s):
    drawn = port_synthetic.audio_batch(b, s, cfg.frontend_dim, cfg.vocab, seed)
    return ({k: jnp.asarray(v) for k, v in drawn.items()}, {k: torch.from_numpy(v) for k, v in drawn.items()})


def test_train_step_matches_jax(model):
    """make_train_step on 4 x 40 frames with the masked-prediction loss:
    loss and accuracy, every gradient, and the step's new parameters and
    moments against the JAX step's."""
    jcfg, pcfg, jm, jtree, named, pm, _ = model
    jb, pb = _batches(pcfg, 11, 4, 40)
    jopt_ = jopt.AdamW(lr=1e-3, weight_decay=0.01, schedule=jopt.cosine_schedule(10, 20))
    jstate = jopt_.init(jtree)
    jnew, jstate, jmetrics = jax.jit(jsteps.make_train_step(jm, jcfg, jopt_))(jtree, jstate, jb)

    popt_ = popt.AdamW(lr=1e-3, weight_decay=0.01, schedule=popt.cosine_schedule(10, 20))
    params = from_numpy(named, "cpu")
    state = popt_.init(params)
    _, state, metrics = psteps.make_train_step(pm, pcfg, popt_)(params, state, pb)
    assert set(metrics) == set(jmetrics) == {"loss", "accuracy"}
    for k in jmetrics:
        _close(metrics[k], jmetrics[k], LOSS_TOL)
    jg = named_tensors(jax.grad(lambda p: jsteps.make_loss_fn(jm, jcfg)(p, jb)[0])(jtree))
    pg, _ = psteps.value_and_grad(psteps.make_loss_fn(pm, pcfg), from_numpy(named, "cpu"), pb)
    assert set(pg) == set(jg) == set(named)
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


def _jax_init(seed):
    jcfg = jax_get_config(ARCH).reduced()
    return {k: np.asarray(v) for k, v in named_tensors(JaxEncoder(jcfg).init(jax.random.PRNGKey(seed),
                                                                             jnp.float32)).items()}


#: ``launch.train``'s arguments: the reduced config, 2 x 16 frames a step
TRAIN_ARGV = ["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "16", "--seed", "3"]


@pytest.fixture(scope="module")
def jax_trainer_losses():
    """The JAX ``launch/train.py`` (its ``main()`` reads ``sys.argv``) for
    three steps: the losses it prints (steps 0 and 2)."""
    import contextlib
    import io

    argv, out = sys.argv, io.StringIO()
    sys.argv = ["train"] + TRAIN_ARGV
    try:
        with contextlib.redirect_stdout(out):
            jax_train_main.main()
    finally:
        sys.argv = argv
    return _losses(out.getvalue())


class _Crash(Exception):
    pass


def _trained(ck):
    """The (params, AdamW state) tree, step and metadata of the latest
    checkpoint in ``ck``."""
    from repro_torch import checkpoint as ckpt

    params = init_params(get_config(ARCH).reduced(), torch.Generator().manual_seed(9), torch.float32, "cpu")
    return ckpt.restore(ck, (params, popt.AdamW().init(params)))


@pytest.mark.parametrize("mode", ["alone", "publish", "resume"])
def test_launch_train_gives_the_jax_trainers_losses(mode, jax_trainer_losses, monkeypatch, capsys, tmp_path):
    """``launch.train --arch hubert-xlarge`` (the reduced config, masked
    prediction on ``audio_batch`` draws) for three steps on the CPU against
    the JAX ``launch/train.py`` from the same initial weights: the printed
    losses are the JAX trainer's (steps 0 and 2 print). With ``--publish``
    too, versions 0-3 published from the registered buffers, the last one
    the trained weights. Killed right after checkpointing step 2 and
    ``--resume``d, the losses and the final checkpoint are an uninterrupted
    run's, whose ``stream_offset`` stays 0 (the bigram stream is not read),
    as the JAX trainer's."""
    init = _jax_init(3)
    monkeypatch.setattr(train_main, "init_params", lambda cfg, gen, dtype, dev: from_numpy(init, dev))
    want = jax_trainer_losses
    assert len(want) == 2 and all(np.isfinite(want))
    argv = TRAIN_ARGV + ["--device", "cpu"]
    whole = str(tmp_path / "whole")
    if mode == "alone":
        train_main.main(argv)
        got = _losses(capsys.readouterr().out)
    elif mode == "publish":
        from repro_torch.core.client import ShardHandle

        published = []
        publish = ShardHandle.publish

        def recording(self, version):
            published.append((version, {n: t.clone() for n, t in self.store.tensors().items()}))
            return publish(self, version)

        monkeypatch.setattr(ShardHandle, "publish", recording)
        train_main.main(argv + ["--publish", "--ckpt-dir", whole, "--ckpt-every", "3"])
        got = _losses(capsys.readouterr().out)
        assert [v for v, _ in published] == [0, 1, 2, 3]
        (params, _), step, _ = _trained(whole)
        assert step == 3 and published[-1][1].keys() == params.keys()
        for n, t in published[-1][1].items():
            assert torch.equal(t, params[n]), n
    else:
        from repro_torch import checkpoint as ckpt

        cut = str(tmp_path / "cut")
        save = ckpt.save

        def crash_after_step_2(path, step, *a, **kw):
            out = save(path, step, *a, **kw)
            if path == cut and step == 2:
                raise _Crash
            return out

        monkeypatch.setattr(train_main.ckpt_lib, "save", crash_after_step_2)
        with pytest.raises(_Crash):
            train_main.main(argv + ["--ckpt-dir", cut, "--ckpt-every", "1"])
        first = _losses(capsys.readouterr().out)
        assert ckpt.latest_step(cut) == 2 and len(first) == 1
        train_main.main(argv + ["--ckpt-dir", cut, "--ckpt-every", "1", "--resume"])
        out = capsys.readouterr().out
        assert "resumed from step 2 (stream offset 0)" in out
        got = first + _losses(out)
        train_main.main(argv + ["--ckpt-dir", whole, "--ckpt-every", "1"])
        capsys.readouterr()
        (pa, sa), step_a, meta_a = _trained(cut)
        (pb, sb), step_b, meta_b = _trained(whole)
        assert step_a == step_b == 3 and meta_a == meta_b == {"stream_offset": 0}
        for n in pb:
            assert torch.equal(pa[n], pb[n]) and torch.equal(sa.mu[n], sb.mu[n]) and torch.equal(sa.nu[n], sb.nu[n])
    np.testing.assert_allclose(got, want, rtol=0, atol=1.5e-4)  # printed to 4 decimals


def test_launch_serve_exits_encoder_only(monkeypatch, capsys):
    """The JAX package's ``launch/serve.py`` exits with "is encoder-only: no
    decode path to serve"; so does the port's, before it allocates."""
    monkeypatch.setattr(serve_main, "init_params", lambda *a, **k: pytest.fail("allocated"))
    with pytest.raises(SystemExit) as exc:
        serve_main.main(["--arch", ARCH, "--device", "cpu"])
    assert exc.value.code == 2
    assert f"{ARCH} is encoder-only: no decode path to serve" in capsys.readouterr().err


@pytest.mark.parametrize("reduced", [False, True])
def test_parameter_names_and_shapes_are_the_jax_param_specs(reduced):
    """The full config's names, shapes and order (48 layers: no weight is
    allocated on either side) and the reduced one's, against the JAX
    ``EncoderLM.param_specs()`` flattened; ``init_params`` draws the norms
    and biases as zeros, as ``init_tree``."""
    got, want = get_config(ARCH), jax_get_config(ARCH)
    if reduced:
        got, want = got.reduced(), want.reduced()
    shapes = decoder_shapes(got)
    assert shapes == [(n, tuple(s.shape)) for n, s in named_tensors(JaxEncoder(want).param_specs()).items()]
    if not reduced:  # param_count() leaves out the norms and the biases (431,360 of them)
        assert sum(int(np.prod(s)) for _, s in shapes) == 945_450_240 == got.param_count() + 431_360
    if reduced:
        params = init_params(got, torch.Generator().manual_seed(0), torch.float32, "cpu")
        zero = {n for n, t in params.items() if not t.any()}
        assert zero == {n for n, _ in shapes if n.endswith(("ln", "b_up", "b_down"))}
        assert float(params["frame_proj"].std()) == pytest.approx(1 / np.sqrt(got.frontend_dim), rel=0.1)


def test_check_ported_takes_the_audio_family():
    for cfg in (get_config(ARCH), get_config(ARCH).reduced()):
        check_ported(cfg)
        check_trainable(cfg)
        model = build_model(cfg)
        assert isinstance(model, EncoderLM) and model.cfg is cfg
        assert not hasattr(model, "prefill") and not hasattr(model, "decode")


def _hubert_weights(dtype: str, seed: int = 5):
    """v0 and v1 (1/8 of each tensor's 256-element rows perturbed) of the
    hubert at head_dim 80, by the JAX package's names, in its order."""
    jcfg, pcfg = _cfgs("head_dim_80")
    shapes = [(n, tuple(s.shape)) for n, s in named_tensors(JaxEncoder(jcfg).param_specs()).items()]
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
def test_hubert_replica_crosses_the_packages_bit_equal(pub_name, dtype, monkeypatch):
    """hubert's names (``frame_proj``, the biases ``b_up``/``b_down``) and
    unit schedule, raw (dc0) and int8 (dc1), through a networked controller
    of the other package than the publisher's: every replica's bytes and
    every v1 manifest (units and checksums) equal the same scenario run
    through the JAX package alone."""
    monkeypatch.setattr(interop.jax_codec.Int8Codec, "_resolve_jax", lambda self: None)
    pub_pkg = interop.PACKAGES[pub_name]
    read_pkg = interop.PORT if pub_pkg is interop.JAX else interop.JAX
    v0, v1 = _hubert_weights(dtype)
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
    assert names == set(v0) and {"frame_proj", "layers/ffn/b_up", "layers/ffn/b_down", "head"} <= names
