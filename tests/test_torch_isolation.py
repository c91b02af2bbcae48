"""The port stands alone: it imports no JAX, nothing of the JAX package
and no ``ml_dtypes``, neither in its source (lazy imports included) nor
at run time; and its entry points default to the card, never quietly to
the host."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as port_core  # noqa: E402
from repro_torch.transfer.engine import WorkerStore  # noqa: E402
from repro_torch.transfer.simcluster import SimCluster, make_manifest  # noqa: E402  (imported beside the card checks)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = [
    (re.compile(r"^\s*(import|from)\s+jax\b", re.M), "imports jax"),
    (re.compile(r"^\s*from\s+repro(\.|\s)", re.M), "imports the JAX package"),
    (re.compile(r"^\s*import\s+repro(\.|\s|$|,)", re.M), "imports the JAX package"),
    (re.compile(r"ml_dtypes"), "mentions ml_dtypes"),
    (re.compile(r"\bTPU\b|\bTpuHW\b"), "names the TPU profile (the port's is hardware.H100)"),
]


#: every module of the port, each imported by the fresh-process probe
_MODULES = [
    "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint",
    "repro_torch.configs",
    "repro_torch.configs.base",
    "repro_torch.configs.gemma2_2b",
    "repro_torch.configs.paper_workloads",
    "repro_torch.core.client",
    "repro_torch.core.failover",
    "repro_torch.core.server",
    "repro_torch.data.synthetic",
    "repro_torch.kernels.build",
    "repro_torch.kernels.checksum",
    "repro_torch.kernels.flash_attention",
    "repro_torch.kernels.mla_decode",
    "repro_torch.kernels.quant",
    "repro_torch.kernels.quant.fused",
    "repro_torch.kernels.repack",
    "repro_torch.launch.cells",
    "repro_torch.launch.dryrun",
    "repro_torch.launch.mesh",
    "repro_torch.launch.networked",
    "repro_torch.launch.op_costs",
    "repro_torch.launch.roofline",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
    "repro_torch.models",
    "repro_torch.models.blocks",
    "repro_torch.models.layers",
    "repro_torch.models.lm",
    "repro_torch.models.optim",
    "repro_torch.models.params",
    "repro_torch.net",
    "repro_torch.net.client",
    "repro_torch.net.controller",
    "repro_torch.net.data",
    "repro_torch.net.httpd",
    "repro_torch.net.protocol",
    "repro_torch.net.service",
    "repro_torch.net.worker",
    "repro_torch.obs.export",
    "repro_torch.obs.rpc",
    "repro_torch.resharding.executor",
    "repro_torch.resharding.layout",
    "repro_torch.resharding.planner",
    "repro_torch.resharding.rowgrid",
    "repro_torch.rl.loop",
    "repro_torch.sharding",
    "repro_torch.sharding.rules",
    "repro_torch.training",
    "repro_torch.training.objectives",
    "repro_torch.training.optimizer",
    "repro_torch.training.steps",
    "repro_torch.transfer.codec",
    "repro_torch.transfer.engine",
    "repro_torch.transfer.faults",
    "repro_torch.transfer.hardware",
    "repro_torch.transfer.simcluster",
    "repro_torch.transfer.simnet",
]


def test_static_scan_of_port_sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    names = {".".join(f.relative_to(PORT.parent).with_suffix("").parts) for f in files}
    names = {n[: -len(".__init__")] if n.endswith(".__init__") else n for n in names}
    assert set(_MODULES) <= names
    bad = [
        f"{f.relative_to(ROOT)}: {why}"
        for f in files
        for rx, why in _FORBIDDEN
        if rx.search(f.read_text())
    ]
    assert not bad, bad


_PROBE = r"""
import importlib
import sys
import torch
import repro_torch
from repro_torch.core import ReferenceServer, TensorHubClient
from repro_torch.models.params import llama3_8b_shapes
from repro_torch.resharding import tp_shard

for m in MODULES:
    importlib.import_module(m)

hub = TensorHubClient(ReferenceServer(), device="cpu", chunk_bytes=1 << 16)
g = torch.Generator().manual_seed(0)
w = {"w": torch.randn(1 << 16, generator=g).to(torch.bfloat16), "b": torch.randn(8, generator=g)}
pub = hub.open("m", "pub", 1, 0, datacenter="dc0")
pub.register(w)
pub.publish(0)
for dc in ("dc0", "dc1"):
    r = hub.open("m", "r-" + dc, 1, 0, datacenter=dc)
    r.register({k: torch.zeros_like(v) for k, v in w.items()})
    r.replicate(0, timeout=30)
assert torch.equal(hub.registry.get("r-dc0", 0).get("w"), w["w"])
assert set(hub.transport.wire_bytes) == {"rdma", "vpc_up"}
llama3_8b_shapes(2)
# a resharded pull (TP-1 -> TP-2): planner, executor and plain repack
g2 = {"m": torch.randn(64, 64, generator=g)}
pub2 = hub.open("m2", "pub", 1, 0)
pub2.register(g2, layout=tp_shard(g2, 0, 1)[1])
pub2.publish(0)
r2 = hub.open("m2", "r", 2, 0)
local, lay = tp_shard(g2, 0, 2)
r2.register({"m": torch.zeros_like(local["m"])}, layout=lay)
r2.replicate(0, timeout=30)
assert torch.equal(r2.store.get("m"), local["m"]) and r2.intervals_pulled > 0
# the serving path: a tiny llama3-style decoder served from a replica
import dataclasses
from repro_torch.configs.llama3_8b import CONFIG
from repro_torch.launch.serve import serve
tiny = dataclasses.replace(CONFIG, num_layers=1, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab=256)
assert len(serve(tiny, requests=2, prompt_len=3, gen_len=2, rounds=1, device="cpu")) == 1
# every arch of the registry resolves; a gemma2 (window, softcaps, tied) serves too
from repro_torch.configs import ARCH_IDS, get_config
assert all(get_config(a).name == a for a in ARCH_IDS)
g2 = dataclasses.replace(get_config("gemma2-2b").reduced(), d_model=64)
assert len(serve(g2, requests=2, prompt_len=12, gen_len=2, rounds=1, device="cpu")) == 1
# and a deepseek-v3 (MLA: the expanded prefill, the absorbed decode; routed experts)
ds = get_config("deepseek-v3-671b").reduced()
assert len(serve(ds, requests=2, prompt_len=5, gen_len=2, rounds=1, device="cpu")) == 1
# the training path: a GRPO step through the trainer, and launch/train.py with a checkpoint
import tempfile
from repro_torch.launch.train import main as train_main
from repro_torch.rl.loop import RLConfig, TrainerWorker
trainer = TrainerWorker(hub, RLConfig(model_name="t", prompt_len=2, group_size=2), tiny, [])
toks = torch.randint(0, 256, (2, 5), generator=g)
m = trainer.train_on([{"tokens": toks, "behavior_logprobs": torch.zeros(2, 3), "rewards": [0.0, 1.0]}])
assert m["version"] == 1
with tempfile.TemporaryDirectory() as d:
    train_main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "8", "--ckpt-dir", d, "--ckpt-every", "1"])
# the networked deployment: a controller and two workers over localhost sockets
from repro_torch.net import ControlServer, NetWorker, ReferenceService
ctrl = ControlServer(ReferenceService(ReferenceServer())).start()
pub_w = NetWorker("pub", address=ctrl.address, device="cpu")
rd_w = NetWorker("rd", address=ctrl.address, device="cpu")
hp = pub_w.open("n", "pub", 1, 0)
hp.register(w)
hp.publish(0)
hr = rd_w.open("n", "r", 1, 0, datacenter="dc1")
hr.register({k: torch.zeros_like(v) for k, v in w.items()})
hr.replicate(0, timeout=30)
assert rd_w.transport.conn_opens > 0 and torch.equal(hr.store.get("b"), w["b"])
for x in (rd_w, pub_w, ctrl):
    (x.close if hasattr(x, "close") else x.shutdown)()
# the simulator on the H100 profile: Table 3's 9B published, replicated
# across datacenters over int8 and updated; a TP-4 -> TP-2 resharded pull
from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.transfer.faults import FaultPlan, FaultSpec
from repro_torch.transfer.simcluster import SimCluster
w9 = WORKLOADS["9B"]
cl = SimCluster(wan_codec="int8", telemetry=True)
tr = cl.add_replica("m", "tr", w9.num_shards, unit_bytes=w9.unit_bytes(8))
ro = cl.add_replica("m", "ro", w9.num_shards, datacenter="dc1", unit_bytes=w9.unit_bytes(8))
tr.open(), ro.open()
cl.run()
cl.install_faults(FaultPlan(seed=1, faults=(FaultSpec("slow", "tr", severity=0.5),)))
for v in range(2):
    tr.publish(v)
    cl.run()
    ev = (ro.replicate if v == 0 else ro.update)("latest")
    cl.run()
    assert ev.triggered and ev.error is None
    tr.unpublish()
    cl.run()
assert cl.link_class_bytes()["vpc_up"] > 0 and cl.recorder.events
cl = SimCluster(wan_codec="int8")
tr = cl.add_replica("m", "tr", 4, global_unit_bytes=[1 << 28] * 8)
ro = cl.add_replica("m", "ro", 2, datacenter="dc1", global_unit_bytes=[1 << 28] * 8)
tr.open(), ro.open()
cl.run()
tr.publish(0)
cl.run()
ev = ro.replicate("latest")
cl.run()
assert ev.triggered and ev.error is None and cl.stall_decomposition(["ro"])["decode"] > 0
# the VLM family: internvl2-2b's reduced config, patches before the tokens, one LM train step
from repro_torch.models import build_model
from repro_torch.models.params import init_params
from repro_torch.training import AdamW, make_train_step
vlm = get_config("internvl2-2b").reduced()
vp = init_params(vlm, torch.Generator().manual_seed(0), torch.float32, "cpu")
opt = AdamW(lr=1e-3)
vb = {"tokens": torch.randint(0, vlm.vocab, (2, 6), generator=g), "patches": torch.zeros(2, vlm.num_patches, vlm.d_model)}
_, _, vm = make_train_step(build_model(vlm), vlm, opt)(vp, opt.init(vp), vb)
assert torch.isfinite(vm["loss"])
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro.")
    or m.startswith("ml_dtypes")
)
print("BAD", bad)
"""


def test_runtime_imports_in_a_fresh_process():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "-c", f"MODULES = {_MODULES!r}\n" + _PROBE], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("module", [
    "repro_torch.data.synthetic", "repro_torch.kernels.flash_attention", "repro_torch.launch.serve",
    "repro_torch.models.blocks", "repro_torch.models.layers", "repro_torch.models.lm",
    "repro_torch.models.params", "repro_torch.rl.loop", "repro_torch.training", "repro_torch.checkpoint",
    "repro_torch.launch.train", "repro_torch.core.failover", "repro_torch.net", "repro_torch.net.controller",
    "repro_torch.kernels.mla_decode",
    "repro_torch.transfer.simnet", "repro_torch.transfer.simcluster", "repro_torch.configs.paper_workloads",
    "repro_torch.transfer.faults", "repro_torch.transfer.hardware",
    "repro_torch.net.worker", "repro_torch.launch.networked", "repro_torch.configs", "repro_torch.models",
    "repro_torch.sharding", "repro_torch.sharding.rules", "repro_torch.launch.mesh", "repro_torch.models.optim",
    "repro_torch.launch.roofline", "repro_torch.launch.op_costs", "repro_torch.launch.cells",
    "repro_torch.launch.dryrun",
])
def test_serving_modules_import_first(module):
    """Each module of the serving path imports as the first one of a
    process (the transfer engine and the client import each other)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", f"import {module}"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        port_core.TensorHubClient(port_core.ReferenceServer())
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        WorkerStore("w")
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu")
    assert hub.device == torch.device("cpu")
    # the simulator needs no card: its int8 wire ratio is the codec's size formula
    assert 0 < SimCluster(wan_codec="int8").codec_ratio("int8", make_manifest([1 << 20] * 4, "float32")) < 0.26


def test_store_refuses_tensors_on_another_device():
    store = WorkerStore("w", device="cpu")
    with pytest.raises(port_core.TensorHubError, match="holds its buffers on cpu"):
        store.register({"x": torch.zeros(4, device="meta")})


def test_networked_entry_points_raise_without_a_card(monkeypatch):
    """A worker process's networked stack defaults to the card and
    raises without one, before it binds a socket or reads an address."""
    from repro_torch.launch.networked import main as networked_main
    from repro_torch.net import NetWorker, RemoteTransport, WorkerDataServer
    from repro_torch.transfer.engine import WorkerRegistry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: NetWorker("w", address="127.0.0.1:9"),
        lambda: WorkerDataServer(WorkerRegistry()),
        lambda: RemoteTransport(WorkerRegistry(), lambda *_: None),
        lambda: networked_main([]),
    ):
        with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
            make()
