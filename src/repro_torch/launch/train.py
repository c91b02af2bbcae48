"""Training entry point: a model of the registry (``--arch``, llama3-8b by
default; ``reduced()`` unless ``--full-config``) against the synthetic
bigram stream, with checkpointing, restart-recovery and optional
TensorHub publishing of every step's weights (the co-located Fig. 4a
pattern). The port's counterpart of the JAX package's
``launch/train.py``, with its arguments.

    python -m repro_torch.launch.train --steps 50
    python -m repro_torch.launch.train --arch gemma2-2b --steps 50
    python -m repro_torch.launch.train --arch dbrx-132b --steps 50     # the reduced dbrx: 8 experts, top-2
    python -m repro_torch.launch.train --arch deepseek-v3-671b --steps 50   # MLA at q/k 16 + 8, v 16
    python -m repro_torch.launch.train --arch internvl2-2b --full-config --batch 2 --seq 512   # 256 patches + 256 tokens
    python -m repro_torch.launch.train --steps 50 --resume --ckpt-dir ckpt   # restart from the latest checkpoint

It runs on the card by default and raises without one; ``--device cpu``
runs on the host. The dense decoder (llama3-8b, yi-34b,
deepseek-coder-33b, gemma2-2b), the routed experts of dbrx-132b,
deepseek-v3-671b's MLA attention (the reduced deepseek-v3's attention, q/k
24 and v 16 in f32, runs the f32 forward and the CUDA-core backward on the
card) and internvl2-2b are ported; another arch exits with the slice it
waits for. A VLM (internvl2-2b) trains as the JAX package's, ``num_patches``
patch embeddings before ``--seq`` less ``num_patches`` tokens of each
sequence, with one difference: the patches standing in for the vision
frontend are seeded normal draws at the embedding's scale
(:func:`stand_in_patches`) where the JAX package feeds zeros. An all-zero
row's RMS norm passes its gradient on at 1/sqrt(eps) = 1000 times, so
through 16 or more layers (internvl2-2b has 24) the zero rows' gradients
overflow f32 and every weight gradient turns NaN, in both packages.
With ``--publish`` the trainer registers its parameters
themselves with a local TensorHub, and each step (which writes them in
place) is published from those buffers with no copy.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.configs import ARCH_IDS, VLM, get_config
from repro_torch.data.synthetic import BigramStream
from repro_torch.models import build_model, check_trainable
from repro_torch.models.params import init_params
from repro_torch.training import AdamW, cosine_schedule, make_train_step
from repro_torch.transfer.engine import resolve_device


def stand_in_patches(cfg, batch: int, seed: int, step: int) -> np.ndarray:
    """A VLM's patch embeddings for training step ``step``: ``[batch,
    num_patches, d_model]`` f32, normal at the embedding's std
    ``1/sqrt(vocab)``, from a generator seeded by ``(seed, step)`` (numpy's,
    so the card and the host draw the same patches)."""
    rng = np.random.default_rng([seed, step])
    shape = (batch, cfg.num_patches, cfg.d_model)
    return (rng.standard_normal(shape) / np.sqrt(cfg.vocab)).astype(np.float32)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="llama3-8b", choices=ARCH_IDS, help="model config (registry id)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--full-config", action="store_true", help="use the full published config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--publish", action="store_true", help="publish every version into a local TensorHub")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    try:
        check_trainable(cfg)
        model = build_model(cfg)
    except NotImplementedError as e:
        ap.exit(2, f"{ap.prog}: {e}\n")

    dev = resolve_device(args.device)
    opt = AdamW(lr=args.lr, schedule=cosine_schedule(10, args.steps), weight_decay=0.01)
    train_step = make_train_step(model, cfg, opt, accum=args.accum)

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), torch.float32, dev)
    opt_state = opt.init(params)
    start_step = 0
    stream = BigramStream(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch, seed=args.seed)

    if args.resume and args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            (saved, opt_state), start_step, meta = ckpt_lib.restore(args.ckpt_dir, (params, opt_state))
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved[name])  # in place: the buffers stay the ones registered below
            stream.offset = meta.get("stream_offset", start_step)
            print(f"resumed from step {start_step} (stream offset {stream.offset})", flush=True)

    hub_handle = None
    if args.publish:
        from repro_torch.core import ReferenceServer, TensorHubClient

        hub = TensorHubClient(ReferenceServer(), device=dev)
        hub_handle = hub.open("train-model", "trainer-0", num_shards=1, shard_idx=0, retain="latest")
        hub_handle.register(params)
        hub_handle.publish(start_step)

    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev, torch.int64) for k, v in stream.next_batch().items()}
        if cfg.family == VLM:  # the vision frontend's stand-in, the tokens cut to fit
            batch["patches"] = torch.from_numpy(stand_in_patches(cfg, args.batch, args.seed, step)).to(dev)
            batch["tokens"] = batch["tokens"][:, : args.seq - cfg.num_patches]
        if hub_handle is not None:
            hub_handle.unpublish()  # the step writes the registered buffers
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if hub_handle is not None:
            hub_handle.publish(step + 1)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['accuracy']):.3f} "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = ckpt_lib.save(
                args.ckpt_dir, step + 1, (params, opt_state), metadata={"stream_offset": stream.offset}
            )
            print(f"checkpointed -> {path}", flush=True)
    if hub_handle is not None:
        hub_handle.close()


if __name__ == "__main__":
    main()
