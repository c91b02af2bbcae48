"""Networked deployment demo: one controller + N worker processes.

``python -m repro_torch.launch.networked`` spawns the real multi-process
topology over localhost sockets: a WAL-backed controller
(``repro_torch.net.controller``) plus ``--workers`` worker processes.
Worker rank 0 publishes a deterministically-seeded model; every other rank
replicates it over the socketed data plane and prints a SHA-256 digest
of the bytes it holds — all ranks printing the same digest is the
demo's proof of byte-identical delivery.

The weights are made with numpy from the same seed as the JAX package's
demo (``repro.launch.networked``) and moved to each worker's device, so
the digest is the same one that demo prints for the same
``--tensors``/``--dim``. Workers hold them on the card unless
``--device cpu`` is given; without a card the default raises.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional


def _worker_main(args: argparse.Namespace) -> int:
    # imports deferred: the parent (spawner) role needs none of them
    import numpy as np
    import torch

    from repro_torch.net.data import host_bytes
    from repro_torch.net.worker import NetWorker

    rank = args.rank
    rng = np.random.default_rng(1234)  # same stream every rank: rank 0
    # publishes exactly what the others expect to receive
    weights = {
        f"layer{i}": rng.standard_normal(
            (args.dim, args.dim), dtype=np.float32
        )
        for i in range(args.tensors)
    }
    digest_src = hashlib.sha256(
        b"".join(weights[k].tobytes() for k in sorted(weights))
    ).hexdigest()

    worker = NetWorker(f"worker{rank}", addr_file=args.addr_file, device=args.device)
    dev = worker.hub.device
    try:
        if rank == 0:
            h = worker.open("demo", "trainer", 1, 0)
            h.register({k: torch.from_numpy(v).to(dev) for k, v in weights.items()})
            h.publish(0)
            print(f"rank0 published v0 digest={digest_src}", flush=True)
            time.sleep(args.linger)  # keep serving until readers finish
        else:
            h = worker.open("demo", f"rollout{rank}", 1, 0)
            h.register({k: torch.zeros(v.shape, dtype=torch.float32, device=dev) for k, v in weights.items()})
            h.replicate(0)
            got = hashlib.sha256(
                b"".join(host_bytes(h.store.get(k)) for k in sorted(weights))
            ).hexdigest()
            status = "MATCH" if got == digest_src else "MISMATCH"
            print(f"rank{rank} replicated v0 digest={got} {status}", flush=True)
            return 0 if got == digest_src else 1
    finally:
        worker.close()
    return 0


def main(argv: Optional[list] = None) -> int:
    p = argparse.ArgumentParser(description="TensorHub networked demo")
    p.add_argument("--workers", type=int, default=3,
                   help="total worker processes (rank 0 publishes)")
    p.add_argument("--tensors", type=int, default=4)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heartbeat-timeout", type=float, default=5.0)
    p.add_argument("--run-dir", default=None,
                   help="WAL + address file directory (default: a tempdir)")
    p.add_argument("--linger", type=float, default=20.0,
                   help="seconds rank 0 keeps serving after publishing")
    p.add_argument("--device", default="cuda",
                   help="where the workers hold their weights (cuda or cpu)")
    # internal: worker-role reentry
    p.add_argument("--role", choices=("spawner", "worker"), default="spawner")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--addr-file", default=None)
    args = p.parse_args(argv)

    if args.role == "worker":
        return _worker_main(args)

    from repro_torch.core.client import resolve_device

    resolve_device(args.device)  # no card for the default: fail before spawning
    run_dir = args.run_dir or tempfile.mkdtemp(prefix="tensorhub-net-")
    addr_file = os.path.join(run_dir, "controller.addr")
    wal = os.path.join(run_dir, "controller.wal")
    controller = subprocess.Popen(
        [
            sys.executable, "-m", "repro_torch.net.controller",
            "--addr-file", addr_file, "--wal", wal,
            "--heartbeat-timeout", str(args.heartbeat_timeout),
        ],
    )
    print(f"controller pid={controller.pid} run_dir={run_dir}", flush=True)
    workers = []
    try:
        common = [
            sys.executable, "-m", "repro_torch.launch.networked",
            "--role", "worker", "--addr-file", addr_file,
            "--tensors", str(args.tensors), "--dim", str(args.dim),
            "--linger", str(args.linger), "--device", args.device,
        ]
        workers.append(subprocess.Popen(common + ["--rank", "0"]))
        time.sleep(0.5)  # let the publish land before readers race it
        for rank in range(1, args.workers):
            workers.append(subprocess.Popen(common + ["--rank", str(rank)]))
        rc = 0
        for w in workers[1:]:
            rc |= w.wait()
        workers[0].terminate()
        workers[0].wait()
        return rc
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
        controller.terminate()
        controller.wait()


if __name__ == "__main__":
    sys.exit(main())
