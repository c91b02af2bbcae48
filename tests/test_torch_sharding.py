"""The port's logical axes and sharding rules against the JAX package's, on
the CPU.

Every parameter of the ten archs, full and reduced, carries the JAX
``ParamSpec``'s shape, axes, init and scale, and so does every cache
tensor of the decoding families (``ring`` included); ``init_params`` draws
what it drew before the specs carried the init rules (checksums pinned).
The port's ``spec_for`` gives the JAX ``PartitionSpec``'s entries for every
one of those tensors under the three rule tables on the 16x16 and 2x16x16
production meshes, and on the JAX package's own rule cases;
``placements_for`` translates specs into DTensor placements and refuses
what DTensor cannot nest; the 1x1 smoke mesh runs here over gloo when the
CPU is asked for. The 2x4 placements over eight processes are in
``tests/test_torch_moe_shardmap.py``.
"""

import hashlib

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402

import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch import MeshShape, make_production_mesh, make_smoke_mesh, mesh_num_devices  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    ParamSpec, decoder_shapes, decoder_specs, init_params, named_specs, param_specs, spec, stack_layers, tree_size,
)
from repro_torch.sharding import (  # noqa: E402
    LONG_SERVE_RULES, SERVE_RULES, TRAIN_RULES, constrain, placements_for, rules_for, sharding_for, spec_for,
    tree_shardings,
)
from test_training_checkpoint import make_abstract_mesh  # noqa: E402

ARCHS = tuple(port_configs.ARCH_IDS)
#: the archs with a cache (every family but the encoder)
DECODING = tuple(a for a in ARCHS if not port_configs.get_config(a).encoder_only)
TABLES = {"train": (TRAIN_RULES, jax_rules.TRAIN_RULES), "serve": (SERVE_RULES, jax_rules.SERVE_RULES),
          "long_serve": (LONG_SERVE_RULES, jax_rules.LONG_SERVE_RULES)}
MESHES = {"16x16": ((16, 16), ("data", "model")), "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

#: sha256 (first 16 hex digits) of every reduced arch's ``init_params``
#: (names and bytes in order, seed 7 on the CPU) in f32 and bf16, taken
#: before the specs carried the init rules
INIT_SUMS = {
    "dbrx-132b": ("6defa959b85b719f", "d520b88998614db6"),
    "deepseek-v3-671b": ("5c855a56cd2c7ab4", "1c4d6d05e0901a1d"),
    "llama3-8b": ("671fac859b3a12a8", "e15e47843db1cab6"),
    "deepseek-coder-33b": ("671fac859b3a12a8", "e15e47843db1cab6"),
    "gemma2-2b": ("ef0bcd1605d7e007", "1bd0f98bdddc1713"),
    "yi-34b": ("671fac859b3a12a8", "e15e47843db1cab6"),
    "internvl2-2b": ("671fac859b3a12a8", "e15e47843db1cab6"),
    "zamba2-2.7b": ("d3aa8bf7a61d239b", "f0a10363fa89b33a"),
    "xlstm-350m": ("8d83cb7a1a991df5", "d1e6b0e810508654"),
    "hubert-xlarge": ("31814d8b9078267d", "9ff167fda6e78daf"),
}


def _cfgs(arch, reduced):
    got, want = port_configs.get_config(arch), jax_configs.get_config(arch)
    return (got.reduced(), want.reduced()) if reduced else (got, want)


def _fields(p):
    return tuple(p.shape), tuple(p.axes), p.init, p.scale


def _jax_named(tree):
    return [(n, _fields(p)) for n, p in named_tensors(tree).items()]


def _port_named(tree):
    return [(n, _fields(p)) for n, p in named_specs(tree)]


def _cache_trees(arch, reduced, ring):
    pcfg, jcfg = _cfgs(arch, reduced)
    return (build_model(pcfg).cache_specs(2, 8192, ring=ring),
            jax_build_model(jcfg).cache_specs(2, 8192, ring=ring))


# -- the specs ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_are_the_jax_param_specs(arch, reduced):
    pcfg, jcfg = _cfgs(arch, reduced)
    want = _jax_named(jax_build_model(jcfg).param_specs())
    assert [(n, _fields(p)) for n, p in decoder_specs(pcfg)] == want
    assert decoder_shapes(pcfg) == [(n, f[0]) for n, f in want]
    assert tree_size(param_specs(pcfg)) == sum(int(torch.tensor(f[0]).prod()) for _, f in want)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("arch", DECODING)
def test_cache_specs_are_the_jax_cache_specs(arch, ring):
    for reduced in (False, True):
        port, jax_tree = _cache_trees(arch, reduced, ring)
        assert _port_named(port) == _jax_named(jax_tree)


@pytest.mark.parametrize("arch", DECODING)
def test_init_cache_follows_the_cache_specs(arch):
    cfg = port_configs.get_config(arch).reduced()
    model = build_model(cfg)
    cache = model.init_cache(2, 24, torch.bfloat16, "cpu")
    specs = dict(named_specs(model.cache_specs(2, 24)))
    got = dict(_named_tensors(cache))
    assert list(got) == list(specs)
    for n, t in got.items():
        assert tuple(t.shape) == specs[n].shape, n


def _named_tensors(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else ((k, tree[k]) for k in sorted(tree))
    for key, v in items:
        if isinstance(v, torch.Tensor):
            yield f"{prefix}{key}", v
        else:
            yield from _named_tensors(v, f"{prefix}{key}/")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_unchanged(arch):
    cfg = port_configs.get_config(arch).reduced()
    for dtype, want in zip((torch.float32, torch.bfloat16), INIT_SUMS[arch]):
        params = init_params(cfg, torch.Generator().manual_seed(7), dtype, device="cpu")
        h = hashlib.sha256()
        for n, t in params.items():
            h.update(n.encode())
            h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest()[:16] == want, (arch, dtype)


def test_spec_helpers():
    p = spec((4, 8), ("embed", None), init="zeros", scale=0.5)
    assert p == ParamSpec((4, 8), ("embed", None), "zeros", 0.5)
    with pytest.raises(ValueError, match="2 axes"):
        ParamSpec((4,), ("embed", None))
    stacked = stack_layers({"a": p, "b": [p]}, 3)
    assert stacked["a"] == ParamSpec((3, 4, 8), ("layers", "embed", None), "zeros", 0.5)
    assert stacked["b"][0] == stacked["a"] and tree_size(stacked) == 2 * 3 * 32
    twice = stack_layers(stack_layers({"w": p}, 2), 5)["w"]
    assert twice.shape == (5, 2, 4, 8) and twice.axes == ("layers", "layers", "embed", None)


# -- spec_for ------------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_is_the_jax_spec_for(arch, mesh):
    """Every parameter and cache tensor, full and reduced, under the three
    tables: the port on its mesh description, JAX on an ``AbstractMesh``."""
    shape, names = MESHES[mesh]
    port_mesh, jax_mesh = MeshShape(shape, names), make_abstract_mesh(shape, names)
    assert port_mesh == make_production_mesh(multi_pod=len(shape) == 3)
    for reduced in (False, True):
        pcfg, _ = _cfgs(arch, reduced)
        tensors = [p for _, p in decoder_specs(pcfg)]
        if arch in DECODING:
            for ring in (False, True):
                tensors += [p for _, p in named_specs(_cache_trees(arch, reduced, ring)[0])]
        for port_rules, jax_table in TABLES.values():
            for p in tensors:
                want = jax_rules.spec_for(p.shape, p.axes, jax_table, jax_mesh)
                assert spec_for(p.shape, p.axes, port_rules, port_mesh) == tuple(want), (arch, p)
                assert spec_for(p.shape, p.axes, port_rules, dict(zip(names, shape))) == tuple(want)


POD = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
POD_PORT = make_production_mesh(multi_pod=True)


def test_divisibility_fallback():
    # gemma2: 4 kv heads cannot shard 16 ways -> replicated
    args = ((4, 32, 256), ("kv_heads", None, "head_dim"))
    assert spec_for(*args, TRAIN_RULES, POD_PORT) == (None, None, "model")
    assert tuple(jax_rules.spec_for(*args, jax_rules.TRAIN_RULES, POD)) == (None, None, "model")


def test_first_fit_conflict():
    # [experts, embed, expert_mlp]: experts takes model; expert_mlp skipped
    args = ((16, 7168, 2048), ("experts", "embed", "expert_mlp"))
    assert spec_for(*args, TRAIN_RULES, POD_PORT) == ("model", ("pod", "data"), None)
    assert tuple(jax_rules.spec_for(*args, jax_rules.TRAIN_RULES, POD)) == ("model", ("pod", "data"), None)


def test_serve_ep_over_two_axes():
    args = ((256, 7168, 2048), ("experts", "embed", "expert_mlp"))
    assert spec_for(*args, SERVE_RULES, POD_PORT) == (("data", "model"), None, None)
    assert jax_rules.spec_for(*args, jax_rules.SERVE_RULES, POD) == PartitionSpec(("data", "model"), None, None)
    # the composite fallback: 16 experts do not split 256 ways, they split the model axis
    assert spec_for((16, 7168, 2048), args[1], SERVE_RULES, POD_PORT) == ("model", None, None)


def test_single_pod_mesh_drops_pod_axis():
    assert spec_for((256, 4096), ("batch", None), TRAIN_RULES, make_production_mesh()) == ("data", None)
    assert mesh_num_devices(make_production_mesh()) == 256 and mesh_num_devices(POD_PORT) == 512


def test_rule_tables_and_rules_for_are_the_jax_ones():
    for port_rules, jax_table in TABLES.values():
        assert port_rules.mapping == jax_table.mapping
        assert port_rules.lookup(None) == () and port_rules.lookup("no such axis") == ()
    assert rules_for("train") is TRAIN_RULES and rules_for("prefill", global_batch=8) is SERVE_RULES
    assert rules_for("decode", global_batch=1) is LONG_SERVE_RULES
    with pytest.raises(ValueError, match="unknown step kind"):
        rules_for("eval")
    with pytest.raises(ValueError, match="axis names"):
        MeshShape((16, 16), ("data",))


# -- placements ---------------------------------------------------------------------------


def test_placements_for_nests_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape((2, 4), ("data", "model"))
    assert placements_for((None, None), mesh) == (Replicate(), Replicate())
    assert placements_for(("model", "data"), mesh) == (Shard(1), Shard(0))
    assert placements_for((None, ("data", "model"), None), mesh) == (Shard(1), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        placements_for((("model", "data"),), mesh)
    with pytest.raises(ValueError, match="not all of the mesh"):
        placements_for(("pod", None), mesh)
    with pytest.raises(ValueError, match="shards two dimensions"):
        placements_for(("model", "model"), mesh)


@pytest.fixture()
def smoke_mesh():
    mesh = make_smoke_mesh("cpu")
    yield mesh
    dist.destroy_process_group()


def test_smoke_mesh_replicates_every_tensor(smoke_mesh):
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    assert smoke_mesh.mesh_dim_names == ("data", "model") and tuple(smoke_mesh.shape) == (1, 1)
    assert smoke_mesh.device_type == "cpu" and mesh_num_devices(smoke_mesh) == 1
    cfg = port_configs.get_config("llama3-8b")
    shardings = tree_shardings(param_specs(cfg), SERVE_RULES, smoke_mesh)
    leaves = [sharding_for(p, SERVE_RULES, smoke_mesh) for _, p in decoder_specs(cfg)]
    assert len(leaves) == len(decoder_shapes(cfg)) and shardings["embed"] == leaves[0]
    assert all(pl == (Replicate(), Replicate()) for pl in leaves)
    x = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    dt = distribute_tensor(x, smoke_mesh, leaves[0])
    assert isinstance(dt, DTensor) and torch.equal(dt.to_local(), x) and torch.equal(dt.full_tensor(), x)
    assert constrain(x, ("batch", None), SERVE_RULES, smoke_mesh) is x
    moved = constrain(dt, ("batch", None), SERVE_RULES, smoke_mesh)
    assert moved.placements == (Replicate(), Replicate()) and torch.equal(moved.to_local(), x)
    assert make_smoke_mesh("cpu").mesh_dim_names == ("data", "model")  # a running world-1 group is reused


def test_smoke_mesh_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.core import TensorHubError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(TensorHubError, match="CUDA is not available"):
        make_smoke_mesh()
    assert not dist.is_initialized()
