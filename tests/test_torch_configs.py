"""The port's config registry against the JAX package's, on the CPU.

Every id of ``ARCH_IDS``: the port's ``get_config(id)`` equals the JAX
one field for field (nested sub-configs and ``source`` included), and so
do ``reduced()``, ``param_count()``, ``active_param_count()``,
``live_shapes()`` and the shape grid; for the four dense ids, full and
reduced, the port's parameter names, shapes and order are the JAX
``DecoderLM``'s, and so are dbrx-132b's (routed experts) and
deepseek-v3-671b's (MLA attention) and internvl2-2b's (the VLM family). A
family the port has no model for is refused with the slice it waits for,
by ``build_model`` and by both entry points (``launch.serve`` refuses
internvl2-2b too: its requests are token prompts); dbrx is built, trained by ``launch/train.py`` at its reduced
config and served by ``serve()`` at a reduced config (``serve.main``
refuses its 40 layers, which do not fit a device, before allocating
anything); deepseek-v3 is built, served and, its MLA attention included,
taken by every training entry point on the host (a step with a finite
loss, a registered trainer, ``launch/train.py`` printing finite losses).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import repro.configs as jax_configs  # noqa: E402
from repro.models.lm import DecoderLM as JaxLM  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402

import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402
from repro_torch.launch import serve as serve_main  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models import build_model, check_ported, check_trainable  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.models.params import decoder_shapes  # noqa: E402

DENSE_IDS = ("llama3-8b", "yi-34b", "deepseek-coder-33b", "gemma2-2b")
PORTED_IDS = DENSE_IDS + ("dbrx-132b",)
#: served and trained (internvl2-2b through ``DecoderLM`` with its patches)
SERVED_IDS = PORTED_IDS + ("deepseek-v3-671b", "internvl2-2b")
OTHER_IDS = tuple(a for a in jax_configs.ARCH_IDS if a not in SERVED_IDS)
#: what the refusal of each family names (the VLM's: ``launch.serve``'s)
WAITS_FOR = {"vlm": "patches", "hybrid": "hybrid", "ssm": "SSM", "audio": "audio"}
#: (entry point, arch) pairs each entry point refuses, and ``train`` with
#: internvl2-2b, which trains now (the case kept its name)
REFUSED = [(e, a) for e in ("serve", "train") for a in ("internvl2-2b",) + OTHER_IDS]
#: what the training entry points' refusal of MLA names


def test_registry_ids_equal():
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert list(port_configs.all_configs()) == list(jax_configs.all_configs())
    assert set(SERVED_IDS) | set(OTHER_IDS) == set(port_configs.ARCH_IDS)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("gemma2-9b")


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_config_equals_jax(arch):
    got, want = port_configs.get_config(arch), jax_configs.get_config(arch)
    assert type(got).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.source == want.source and got.resolved_head_dim == want.resolved_head_dim


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_reduced_equals_jax(arch):
    got, want = port_configs.get_config(arch).reduced(), jax_configs.get_config(arch).reduced()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_counts_and_live_shapes_equal_jax(arch):
    for got, want in ((port_configs.get_config(arch), jax_configs.get_config(arch)),
                      (port_configs.get_config(arch).reduced(), jax_configs.get_config(arch).reduced())):
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert port_configs.live_shapes(got) == jax_configs.live_shapes(want)


def test_shape_grid_and_families_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert port_configs.LONG_OK_FAMILIES == jax_configs.LONG_OK_FAMILIES
    for name in ("DENSE", "MOE", "HYBRID", "SSM", "AUDIO", "VLM"):
        assert getattr(port_configs, name) == getattr(jax_configs, name)
    for cls in ("MoEConfig", "MLAConfig", "SSMConfig", "XLSTMConfig", "ModelConfig", "ShapeCase"):
        assert [f.name for f in dataclasses.fields(getattr(port_base, cls))] == [
            f.name for f in dataclasses.fields(getattr(jax_configs, cls))], cls


def test_llama3_8b_source_copied_as_it_stands():
    assert port_configs.get_config("llama3-8b").source == "arXiv:2407.21783; unverified"


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", SERVED_IDS)
def test_decoder_shapes_are_the_jax_param_specs(arch, reduced):
    got, want = port_configs.get_config(arch), jax_configs.get_config(arch)
    if reduced:
        got, want = got.reduced(), want.reduced()
    assert decoder_shapes(got) == [(n, tuple(s.shape)) for n, s in named_tensors(JaxLM(want).param_specs()).items()]


def test_gemma2_shapes_have_post_norms_and_no_head():
    names = [n for n, _ in decoder_shapes(port_configs.get_config("gemma2-2b"))]
    assert "head" not in names and "layers/attn/post_ln" in names and "layers/ffn/post_ln" in names
    llama = [n for n, _ in decoder_shapes(port_configs.get_config("llama3-8b"))]
    assert "head" in llama and not any("post_ln" in n for n in llama)


@pytest.mark.parametrize("arch", PORTED_IDS + ("internvl2-2b",))
def test_build_model_builds_the_dense_ids(arch):
    """The dense ids, and dbrx-132b (MoE, no MLA) and internvl2-2b (the
    dense decoder behind its patches) beside them."""
    cfg = port_configs.get_config(arch)
    model = build_model(cfg)
    assert isinstance(model, DecoderLM) and model.cfg is cfg
    assert model.is_moe == (cfg.moe is not None) and model.n_prefix == 0
    want = [cfg.sliding_window if (cfg.alt_local_global and i % 2 == 0) else 0 for i in range(cfg.num_layers)]
    assert model.windows == want


@pytest.mark.parametrize("arch", ("internvl2-2b",) + OTHER_IDS)
def test_build_model_refuses_the_families_not_ported(arch):
    """Each family the port has no model for is refused with its slice
    named; internvl2-2b (the VLM family), refused until its slice was in,
    now builds, full and reduced (the case kept its name)."""
    cfg = port_configs.get_config(arch)
    if arch == "internvl2-2b":
        check_ported(cfg.reduced())
        assert isinstance(build_model(cfg), DecoderLM) and cfg.num_patches == 256
        return
    with pytest.raises(NotImplementedError, match=WAITS_FOR[cfg.family]):
        build_model(cfg)
    with pytest.raises(NotImplementedError, match=WAITS_FOR[cfg.family]):
        check_ported(cfg.reduced())


@pytest.mark.parametrize("reduced", [False, True])
def test_build_model_takes_deepseek_v3s_mla(reduced):
    """deepseek-v3 (MoE with MLA attention, full and reduced) builds: MLA
    attention in every layer, three dense prefix layers (one reduced)."""
    cfg = port_configs.get_config("deepseek-v3-671b")
    cfg = cfg.reduced() if reduced else cfg
    check_ported(cfg)
    model = build_model(cfg)
    assert model.is_mla and model.is_moe and model.seq_axis == 1
    assert (model.n_prefix, model.n_scan) == (cfg.moe.first_dense, cfg.num_layers - cfg.moe.first_dense)
    assert model.windows == [0] * model.n_scan


def test_mla_and_moe_build_in_a_dense_family_config():
    """MLA and routed experts build in a dense-family config too (with
    deepseek-v3's latent attention, shared expert and dense prefix), as
    the JAX ``DecoderLM`` takes them by ``cfg.mla`` and ``cfg.moe``, not by
    family; training takes both, in a VLM config too, and still refuses
    an audio config with its slice named."""
    base = port_configs.get_config("llama3-8b")
    ds = port_configs.get_config("deepseek-v3-671b")
    mla = dataclasses.replace(base, mla=ds.mla)
    assert build_model(mla).is_mla
    check_trainable(mla)
    vlm = next(port_configs.get_config(a) for a in SERVED_IDS if port_configs.get_config(a).family == port_base.VLM)
    check_trainable(dataclasses.replace(vlm, mla=ds.mla))
    assert build_model(dataclasses.replace(vlm, mla=ds.mla)).is_mla
    audio = next(port_configs.get_config(a) for a in OTHER_IDS if port_configs.get_config(a).family == port_base.AUDIO)
    with pytest.raises(NotImplementedError, match="audio slice"):
        check_trainable(dataclasses.replace(audio, mla=ds.mla))
    cfg = dataclasses.replace(base, moe=ds.moe)
    check_trainable(cfg)
    model = build_model(cfg)
    assert model.is_moe and not model.is_mla and (model.n_prefix, model.n_scan) == (3, base.num_layers - 3)


def _tiny_deepseek():
    return port_configs.get_config("deepseek-v3-671b").reduced()


@pytest.mark.parametrize("entry", ["make_train_step", "make_grpo_step", "TrainerWorker", "launch.train"])
def test_training_entry_points_refuse_mla_naming_its_slice(entry, capsys):
    """Every training entry point takes the reduced deepseek-v3 (MLA at
    q/k 16 + 8, v 16) on the host now that its slice is in (the test kept
    its name from when they refused it): a train step and a GRPO step with
    a finite loss, a TrainerWorker that registers its weights, and
    ``launch.train`` printing a finite loss a step."""
    import math
    import re

    import numpy as np

    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.models.params import init_params
    from repro_torch.rl import loop
    from repro_torch.training import AdamW, make_grpo_step, make_train_step

    cfg = _tiny_deepseek()
    if entry == "launch.train":
        train_main.main(["--arch", "deepseek-v3-671b", "--device", "cpu", "--steps", "1", "--batch", "2",
                         "--seq", "12"])
        losses = [float(x) for x in re.findall(r"loss (\S+)", capsys.readouterr().out)]
        assert len(losses) == 1 and math.isfinite(losses[0])
        return
    if entry == "TrainerWorker":
        hub = TensorHubClient(ReferenceServer(), device="cpu")
        trainer = loop.TrainerWorker(hub, loop.RLConfig(model_name="t"), cfg, [])
        assert trainer.model.is_mla and set(trainer.params) == {n for n, _ in decoder_shapes(cfg)}
        trainer.close()
        return
    model, opt = build_model(cfg), AdamW(lr=1e-3)
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, "cpu")
    state = opt.init(params)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int64))
    if entry == "make_train_step":
        _, _, metrics = make_train_step(model, cfg, opt)(params, state, {"tokens": tokens})
    else:
        mask = torch.zeros((2, 11), dtype=torch.bool)
        mask[:, 5:] = True
        batch = {"tokens": tokens, "behavior_logprobs": torch.full((2, 11), -5.0), "loss_mask": mask,
                 "advantages": torch.tensor([0.5, -0.5])}
        _, _, metrics = make_grpo_step(model, cfg, opt)(params, state, batch)
    assert math.isfinite(float(metrics["loss"]))


def test_serve_answers_a_reduced_deepseek_v3():
    rows = serve_main.serve(_tiny_deepseek(), requests=2, prompt_len=6, gen_len=3, rounds=2, device="cpu",
                            dtype=torch.float32)
    assert [r["version"] for r in rows] == [0, 0] and all(r["tokens"] == 6 for r in rows)


@pytest.mark.parametrize("entry,arch", REFUSED, ids=[f"{e}-{a}" for e, a in REFUSED])
def test_entry_points_exit_with_the_slice_a_family_waits_for(arch, entry, capsys):
    main = serve_main.main if entry == "serve" else train_main.main
    if (entry, arch) == ("train", "internvl2-2b"):  # the reduced config's 4 patches before 8 tokens
        import math
        import re

        main(["--arch", arch, "--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "12"])
        losses = [float(x) for x in re.findall(r"loss (\S+)", capsys.readouterr().out)]
        assert len(losses) == 1 and math.isfinite(losses[0])
        return
    with pytest.raises(SystemExit) as exc:
        main(["--arch", arch, "--device", "cpu"])
    assert exc.value.code == 2
    assert WAITS_FOR[port_configs.get_config(arch).family] in capsys.readouterr().err


@pytest.mark.parametrize("entry", ["serve", "train"])
def test_entry_points_refuse_an_unknown_arch(entry, capsys):
    main = serve_main.main if entry == "serve" else train_main.main
    with pytest.raises(SystemExit):
        main(["--arch", "gemma2-9b", "--device", "cpu"])
    assert "gemma2-2b" in capsys.readouterr().err  # the choices are the registry's


def test_train_entry_point_trains_the_reduced_dbrx(capsys):
    """``--arch dbrx-132b`` trains the reduced dbrx (8 experts, top-2)."""
    import re

    train_main.main(["--arch", "dbrx-132b", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"])
    losses = [float(x) for x in re.findall(r"loss (\S+)", capsys.readouterr().out)]
    assert len(losses) == 2 and all(x == x and abs(x) < 100 for x in losses)


def test_serve_answers_a_reduced_dbrx():
    rows = serve_main.serve(port_configs.get_config("dbrx-132b").reduced(), requests=2, prompt_len=6, gen_len=3,
                            rounds=2, device="cpu", dtype=torch.float32)
    assert [r["version"] for r in rows] == [0, 0] and all(r["tokens"] == 6 for r in rows)


def test_serve_refuses_a_depth_that_does_not_fit_before_allocating(monkeypatch, capsys):
    """dbrx's 40 layers are 263 GB a copy: refused with the depth flag named,
    before any weight is allocated (``init_params`` would raise here)."""
    monkeypatch.setattr(serve_main, "device_memory", lambda device: 80 * 10**9)
    monkeypatch.setattr(serve_main, "init_params", lambda *a, **k: pytest.fail("allocated"))
    with pytest.raises(SystemExit) as exc:
        serve_main.main(["--arch", "dbrx-132b", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "526.4 GB" in err and "--layers" in err


def test_serve_refuses_deepseek_v3s_61_layers_and_takes_4(monkeypatch, capsys):
    """deepseek-v3's 61 layers are 1.3 TB a copy: refused with the depth
    flag named before any weight is allocated; its 4 least layers (15.1 B
    parameters, 60.4 GB for the two copies) pass the check."""
    monkeypatch.setattr(serve_main, "device_memory", lambda device: 80 * 10**9)
    monkeypatch.setattr(serve_main, "init_params", lambda *a, **k: pytest.fail("allocated"))
    with pytest.raises(SystemExit) as exc:
        serve_main.main(["--arch", "deepseek-v3-671b", "--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "2684.1 GB" in err and "--layers" in err
    served = []
    monkeypatch.setattr(serve_main, "serve", lambda cfg, **kw: served.append(cfg))
    serve_main.main(["--arch", "deepseek-v3-671b", "--layers", "4", "--device", "cpu"])
    assert served[0].num_layers == 4 and 2 * 2 * served[0].param_count() == 60_444_114_944
