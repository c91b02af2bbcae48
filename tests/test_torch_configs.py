"""The port's config registry against the JAX package's, on the CPU.

Every id of ``ARCH_IDS``: the port's ``get_config(id)`` equals the JAX
one field for field (nested sub-configs and ``source`` included), and so
do ``reduced()``, ``param_count()``, ``active_param_count()``,
``live_shapes()`` and the shape grid; for the four dense ids, full and
reduced, the port's parameter names, shapes and order are the JAX
``DecoderLM``'s. A family the port has no model for is refused with the
slice it waits for, by ``build_model`` and by both entry points.
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
from repro_torch.models import build_model, check_ported  # noqa: E402
from repro_torch.models.lm import DecoderLM  # noqa: E402
from repro_torch.models.params import decoder_shapes  # noqa: E402

DENSE_IDS = ("llama3-8b", "yi-34b", "deepseek-coder-33b", "gemma2-2b")
OTHER_IDS = tuple(a for a in jax_configs.ARCH_IDS if a not in DENSE_IDS)
#: what the refusal of each family that is not ported names
WAITS_FOR = {"moe": "MoE", "vlm": "VLM", "hybrid": "hybrid", "ssm": "SSM", "audio": "audio"}


def test_registry_ids_equal():
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert list(port_configs.all_configs()) == list(jax_configs.all_configs())
    assert set(DENSE_IDS) | set(OTHER_IDS) == set(port_configs.ARCH_IDS)


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
@pytest.mark.parametrize("arch", DENSE_IDS)
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


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_build_model_builds_the_dense_ids(arch):
    cfg = port_configs.get_config(arch)
    model = build_model(cfg)
    assert isinstance(model, DecoderLM) and model.cfg is cfg
    want = [cfg.sliding_window if (cfg.alt_local_global and i % 2 == 0) else 0 for i in range(cfg.num_layers)]
    assert model.windows == want


@pytest.mark.parametrize("arch", OTHER_IDS)
def test_build_model_refuses_the_families_not_ported(arch):
    cfg = port_configs.get_config(arch)
    with pytest.raises(NotImplementedError, match=WAITS_FOR[cfg.family]):
        build_model(cfg)
    with pytest.raises(NotImplementedError, match=WAITS_FOR[cfg.family]):
        check_ported(cfg.reduced())


def test_mla_and_moe_are_refused_in_a_dense_family_config():
    base = port_configs.get_config("llama3-8b")
    ds = port_configs.get_config("deepseek-v3-671b")
    with pytest.raises(NotImplementedError, match="MLA"):
        check_ported(dataclasses.replace(base, mla=ds.mla))
    with pytest.raises(NotImplementedError, match="MoE"):
        check_ported(dataclasses.replace(base, moe=ds.moe))


@pytest.mark.parametrize("arch", OTHER_IDS)
@pytest.mark.parametrize("entry", ["serve", "train"])
def test_entry_points_exit_with_the_slice_a_family_waits_for(arch, entry, capsys):
    main = serve_main.main if entry == "serve" else train_main.main
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
