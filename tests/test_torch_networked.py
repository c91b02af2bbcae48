"""The port's networked demo as real processes: ``python -m
repro_torch.launch.networked --device cpu`` spawns a controller and three
workers over localhost sockets, and every reader must print the digest
the JAX package's demo prints for the same weights. Marked
``networked``: excluded from the default run, run with ``-m networked``.
"""

import re
import subprocess
import sys

import pytest

from procs import build_env

pytestmark = pytest.mark.networked


def _digests(module, *extra):
    out = subprocess.run(
        [sys.executable, "-m", module, "--linger", "5", *extra],
        capture_output=True, text=True, timeout=240, env=build_env(extra={"JAX_PLATFORMS": "cpu"}),
    )
    assert out.returncode == 0, out.stdout + out.stderr
    return re.findall(r"rank(\d) \S+ v0 digest=([0-9a-f]{64})(?: (MATCH|MISMATCH))?", out.stdout)


def test_port_demo_digest_equals_the_jax_demo():
    port = _digests("repro_torch.launch.networked", "--device", "cpu")
    jax = _digests("repro.launch.networked")
    assert sorted(r for r, _, _ in port) == ["0", "1", "2"]
    assert {d for _, d, _ in port} == {d for _, d, _ in jax} and len({d for _, d, _ in jax}) == 1
    assert [s for _, _, s in port if s] == ["MATCH", "MATCH"]
