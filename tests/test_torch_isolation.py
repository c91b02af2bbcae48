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

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_FORBIDDEN = [
    (re.compile(r"^\s*(import|from)\s+jax\b", re.M), "imports jax"),
    (re.compile(r"^\s*from\s+repro(\.|\s)", re.M), "imports the JAX package"),
    (re.compile(r"^\s*import\s+repro(\.|\s|$|,)", re.M), "imports the JAX package"),
    (re.compile(r"ml_dtypes"), "mentions ml_dtypes"),
]


def test_static_scan_of_port_sources():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 10
    bad = [
        f"{f.relative_to(ROOT)}: {why}"
        for f in files
        for rx, why in _FORBIDDEN
        if rx.search(f.read_text())
    ]
    assert not bad, bad


_PROBE = r"""
import sys
import torch
import repro_torch
from repro_torch.core import ReferenceServer, TensorHubClient
from repro_torch.models.params import llama3_8b_shapes

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
        [sys.executable, "-c", _PROBE], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        port_core.TensorHubClient(port_core.ReferenceServer())
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        WorkerStore("w")
    hub = port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu")
    assert hub.device == torch.device("cpu")


def test_store_refuses_tensors_on_another_device():
    store = WorkerStore("w", device="cpu")
    with pytest.raises(port_core.TensorHubError, match="holds its buffers on cpu"):
        store.register({"x": torch.zeros(4, device="meta")})
