"""CUDA kernels of the port against their plain versions on the card, and
one small transfer through the client on the card. Marked ``gpu``: they
skip where there is no CUDA device, and run on the card with

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import checksum as ck  # noqa: E402
from repro_torch.kernels import quant as qk  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.parametrize("nbytes", [1, 3, 4, 5, 15, 16, 17, 4097, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("offset", [0, 1, 3, 16])
def test_checksum_kernel_equals_plain(dev, nbytes, offset):
    g = torch.Generator(device=dev).manual_seed(nbytes + offset)
    raw = torch.randint(0, 256, (nbytes + 32,), dtype=torch.uint8, generator=g, device=dev)
    buf = raw[offset : offset + nbytes]
    before = ck.LAUNCHES.value
    got = ck.checksum_words(buf).to(torch.int64) & 0xFFFFFFFF
    assert ck.LAUNCHES.value == before + 1
    assert torch.equal(got, ck.checksum_words_plain(buf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_001])
def test_quant_kernel_equals_plain(dev, dtype, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randn(n, generator=g, device=dev, dtype=dtype) * 3
    x[: min(n, 256)] = 0  # an all-zero first row
    q1, s1 = qk.quantize_rows(x)
    q2, s2 = qk.quantize_rows_plain(x)
    assert torch.equal(q1, q2)
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


def test_quant_kernel_unaligned_input(dev):
    x = torch.randn(4096 + 1, device=dev)[1:]  # 4-byte but not 16-byte aligned
    q1, s1 = qk.quantize_rows(x)
    q2, s2 = qk.quantize_rows_plain(x)
    assert torch.equal(q1, q2) and torch.equal(s1, s2)


def test_transfer_on_the_card(dev):
    from repro_torch.core import ReferenceServer, TensorHubClient

    hub = TensorHubClient(ReferenceServer(), chunk_bytes=1 << 20)
    g = torch.Generator(device=dev).manual_seed(0)
    w = {"w": torch.randn(3 << 20, generator=g, device=dev, dtype=torch.bfloat16)}
    pub = hub.open("m", "pub", 1, 0, datacenter="dc0")
    pub.register(w)
    pub.publish(0)
    r = hub.open("m", "r", 1, 0, datacenter="dc1")
    r.register({"w": torch.zeros_like(w["w"])})
    r.replicate(0, timeout=60)
    got = r.store.get("w").float().cpu().numpy()
    want = w["w"].float().cpu().numpy()
    assert r.store.get("w").device == dev
    assert np.max(np.abs(got - want)) / np.max(np.abs(want)) < 0.01
