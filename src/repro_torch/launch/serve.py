"""Serving entry point: a decoder LM answered from a TensorHub replica (Fig. 4b).

A publisher registers the ``--arch`` model (llama3-8b by default; any id
of the registry, ``repro_torch.configs.ARCH_IDS``) at its published widths
(bf16, random weights from ``--seed``) and publishes v0; a
:class:`RolloutWorker` replicates it into its own buffers on the same
device and answers ``--rounds`` batches of ``--requests`` prompts
(prefill, then ``--gen-len`` decode steps through the flash-attention
kernel), calling ``update("latest")`` between batches. ``--layers`` cuts
the depth (default: the arch's own; two replicas of llama3-8b's 32 layers
take 32 GB); the widths are never cut. A depth whose two copies (the
publisher's and the rollout's) do not fit the device's memory is refused
before anything is allocated: dbrx-132b's 40 layers are 264 GB a copy, so
it is served with ``--layers`` (deepseek-v3-671b's 61 layers are 1.3 TB a
copy; its 4 least layers, three dense and one of routed experts, 30.2
GB). The dense family (llama3-8b, yi-34b, deepseek-coder-33b, gemma2-2b),
the routed experts of dbrx-132b and deepseek-v3-671b's MLA attention
(prefill through the flash kernel at q/k 192, v 128; decode through the
absorbed-latent ``mla_decode`` kernel) are ported; another arch exits
with the slice it waits for. Requests are token prompts, as the JAX
package's ``launch/serve.py``: a VLM (internvl2-2b), whose requests carry
patches, is refused here and served through ``DecoderLM.prefill`` with
``batch["patches"]``.

    python -m repro_torch.launch.serve --requests 16 --prompt-len 512 --gen-len 64
    python -m repro_torch.launch.serve --arch gemma2-2b --requests 4 --prompt-len 4608 --gen-len 64
    python -m repro_torch.launch.serve --arch dbrx-132b --layers 4 --requests 4 --prompt-len 512 --gen-len 16
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --layers 4

It runs on the card by default and raises without one; ``--device cpu``
runs the plain attention on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import threading
import time
from typing import Dict, List

import torch

from repro_torch.configs import ARCH_IDS, VLM, ModelConfig, get_config
from repro_torch.core import ReferenceServer, TensorHubClient
from repro_torch.core.client import resolve_device
from repro_torch.data.synthetic import PromptSet
from repro_torch.models import check_ported
from repro_torch.models.params import init_params
from repro_torch.rl.loop import RLConfig, RolloutWorker


def device_memory(device: torch.device) -> int:
    """Bytes the device can hold: the card's total memory, or the host's
    physical memory for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(
    model_cfg: ModelConfig,
    *,
    requests: int,
    prompt_len: int,
    gen_len: int,
    rounds: int,
    seed: int = 0,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> List[Dict]:
    """Publish random weights, replicate them into a rollout worker and
    serve ``rounds`` batches; one dict of timings a round."""
    hub = TensorHubClient(ReferenceServer(), device=device)
    dev = hub.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    trainer = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    trainer.register(init_params(model_cfg, gen, dtype, dev))
    trainer.publish(0)
    cfg = RLConfig(
        prompt_len=prompt_len, response_len=gen_len, num_prompts=requests, group_size=1, seed=seed
    )
    worker = RolloutWorker(
        "rollout-0", hub, cfg, model_cfg, PromptSet(model_cfg.vocab, prompt_len, seed=seed),
        [], threading.Event(), dtype=dtype,
    )
    t0 = time.perf_counter()
    worker.connect(timeout=600)
    _sync(dev)
    print(f"replicate: {time.perf_counter() - t0:.3f}s for {trainer.store.total_bytes / 1e9:.2f} GB", flush=True)
    out = []
    for rnd in range(rounds):
        _sync(dev)
        t0 = time.perf_counter()
        rec = worker.serve_batch(rnd)
        dt = time.perf_counter() - t0  # ends in the rewards' host copy of the tokens
        toks = requests * gen_len
        row = dict(round=rnd, seconds=dt, tokens=toks, tokens_per_s=toks / dt,
                   mean_logprob=float(rec["behavior_logprobs"].mean()), version=rec["version"])
        out.append(row)
        print(
            f"round {rnd}: {requests} requests x {gen_len} new tokens in {dt:.2f}s "
            f"({toks / dt:.1f} tok/s), mean logprob {row['mean_logprob']:.3f}, v{rec['version']}",
            flush=True,
        )
        worker.pull_latest()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS, help="model config (registry id)")
    ap.add_argument("--requests", type=int, default=8, help="batch of requests")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="depth (default: the arch's own; widths stay published)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    try:
        check_ported(cfg)
        if cfg.family == VLM:
            raise NotImplementedError(f"{cfg.name}: a VLM request carries patches, and these requests are "
                                      "token prompts; serve it through DecoderLM.prefill with batch['patches']")
    except NotImplementedError as e:
        ap.exit(2, f"{ap.prog}: {e}\n")
    cfg = dataclasses.replace(cfg, num_layers=args.layers or cfg.num_layers)
    copies = 2 * cfg.param_count() * torch.finfo(torch.bfloat16).bits // 8  # the publisher's and the rollout's
    room = device_memory(resolve_device(args.device))
    if copies > room:
        ap.exit(2, f"{ap.prog}: {cfg.name} at {cfg.num_layers} layers needs {copies / 1e9:.1f} GB for the "
                   f"publisher's and the rollout's copies, more than the {room / 1e9:.1f} GB of the device; "
                   "cut the depth with --layers\n")
    serve(cfg, requests=args.requests, prompt_len=args.prompt_len, gen_len=args.gen_len,
          rounds=args.rounds, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
