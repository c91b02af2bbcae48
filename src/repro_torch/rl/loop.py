"""The RL loop wired through TensorHub (paper Fig. 4), with both sides
serving and training from TensorHub buffers.

The port's copy of ``RLConfig``, ``sample_responses``, ``RolloutWorker``
and ``TrainerWorker`` from the JAX package's ``rl/loop.py``.

* Rollout (Fig. 4b): a worker holds the model in its device memory as a
  TensorHub replica: it registers zero buffers, ``replicate("latest")``
  fills them, and it serves every batch straight from
  ``handle.store.tensors()`` — the weights the worker already holds are
  the storage (ROS, the paper's reference-oriented storage). Between
  batches, on the same thread, ``update("latest")`` writes the next
  version into the same buffers in place, so the JAX loop's per-step
  rebuild of the parameter tree has no counterpart here.
* Trainer (Fig. 4a): the trainer registers its parameters themselves and
  publishes v0; a step is unpublish -> one GRPO step that writes the new
  parameters and moments in place (``training.AdamW``) -> publish the
  next version, which ``publish`` reads from the same buffers, so the JAX
  trainer's copy of every parameter into its registered buffers has no
  counterpart either.

Both sides take every ported family that decodes: the decoder (dense, MoE,
MLA), the hybrid (zamba2) and the xLSTM (xlstm-350m), whose registered
buffers are the ``HybridLM``'s and the ``XLSTMLM``'s names
(:func:`repro_torch.models.params.decoder_shapes`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import TensorHubClient
from repro_torch.core.errors import StaleHandleError, TensorHubError
from repro_torch.data.synthetic import PromptSet
from repro_torch.models import build_model, check_trainable
from repro_torch.models.lm import DecoderLM, HybridLM, XLSTMLM
from repro_torch.models.params import decoder_shapes, init_params
from repro_torch.training import AdamW, group_relative_advantages, make_grpo_step


@dataclasses.dataclass
class RLConfig:
    model_name: str = "actor"
    num_steps: int = 20
    prompt_len: int = 8
    response_len: int = 24
    num_prompts: int = 4
    group_size: int = 4  # responses per prompt (GRPO group)
    lr: float = 1e-3
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10


def sample_responses(
    model: Union[DecoderLM, HybridLM, XLSTMLM],
    params,
    prompts: torch.Tensor,  # [B, prompt_len] int64
    response_len: int,
    generator: torch.Generator,
    *,
    return_logits: bool = False,
):
    """Autoregressive sampling: prefill, then ``response_len`` decode
    steps (the last one's logits go unused, as in the JAX loop), for the
    decoder, for the hybrid (whose decode carries its Mamba2 blocks'
    conv rows and states beside the shared block's K/V) and for the xLSTM
    (whose cache is its blocks' recurrent states). Returns
    ``(sequences [B, prompt_len + response_len], logprobs [B,
    response_len])`` of the sampled tokens and, with ``return_logits``,
    the f32 logits each token was sampled from ``[B, response_len,
    vocab]``. Tokens are drawn by the Gumbel-max rule (as
    ``jax.random.categorical``) from ``generator``'s uniforms; they differ
    from the JAX package's, whose random bits torch cannot reproduce."""
    b, plen = prompts.shape
    total = plen + response_len
    logits, cache, cache_len = model.prefill(params, {"tokens": prompts}, max_len=total)
    toks = torch.zeros((b, total), dtype=torch.int64, device=prompts.device)
    toks[:, :plen] = prompts
    lps, kept = [], []
    for t in range(response_len):
        last = logits[:, -1].float()
        lp = torch.log_softmax(last, dim=-1)
        u = torch.rand(lp.shape, generator=generator, device=lp.device).clamp_(min=torch.finfo(torch.float32).tiny)
        nxt = torch.argmax(lp - torch.log(-torch.log(u)), dim=-1)  # [B]
        lps.append(lp.gather(-1, nxt[:, None])[:, 0])
        if return_logits:
            kept.append(last)
        toks[:, plen + t] = nxt
        logits, cache = model.decode(params, cache, nxt[:, None], cache_len)
        cache_len += 1
    out = (toks, torch.stack(lps, dim=1))
    return out + (torch.stack(kept, dim=1),) if return_logits else out


def batch_seed(name: str, step: int) -> int:
    """A sampling seed per (worker, step), the same in every process (the
    JAX loop hashes the pair with Python's salted ``hash``)."""
    return zlib.crc32(f"{name}/{step}".encode()) & 0x7FFFFFFF


class RolloutWorker(threading.Thread):
    """Fig. 4b: a standalone rollout worker that holds the model as a
    TensorHub replica on ``hub``'s device (the card by default) and pulls
    new weights between batches.

    ``run`` loops ``serve_batch`` / ``pull_latest`` until ``stop`` is set;
    a caller that paces the rounds itself calls ``connect``,
    ``serve_batch`` and ``pull_latest`` directly, on one thread."""

    def __init__(
        self,
        name: str,
        hub: TensorHubClient,
        cfg: RLConfig,
        model_cfg: ModelConfig,
        prompts: PromptSet,
        out_queue: List,
        stop: threading.Event,
        *,
        datacenter: str = "dc0",
        is_spot: bool = False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__(name=name, daemon=True)
        self.hub = hub
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.model = build_model(model_cfg)
        self.prompts = prompts
        self.out_queue = out_queue
        self.stop_event = stop
        self.datacenter = datacenter
        self.is_spot = is_spot
        self.dtype = dtype
        self.device = hub.device
        self.replica_name = name
        self.steps_done = 0
        self.weights_version: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.handle = None
        #: the replica's registered buffers, which the model reads in place
        self.params: Dict[str, torch.Tensor] = {}

    def run(self) -> None:  # exercised by the CPU scenario test
        try:
            self._run()
        except BaseException as e:  # surfaced to the caller through ``error``
            self.error = e

    def _run(self) -> None:
        self.connect()
        step = 0
        while not self.stop_event.is_set():
            self.serve_batch(step)
            step += 1
            try:
                self.pull_latest()
            except (StaleHandleError, TensorHubError):
                break
        self.handle.close()

    def connect(self, *, timeout: Optional[float] = None) -> int:
        """Open this worker's handle, register zero buffers on its device
        and replicate the latest published version into them."""
        self.handle = self.hub.open(
            self.cfg.model_name, self.replica_name, num_shards=1, shard_idx=0,
            datacenter=self.datacenter, is_spot=self.is_spot,
        )
        self.handle.register({
            n: torch.zeros(s, dtype=self.dtype, device=self.device)
            for n, s in decoder_shapes(self.model_cfg)
        })
        self.weights_version = self.handle.replicate("latest", timeout=timeout)
        self.params = self.handle.store.tensors()
        return self.weights_version

    def serve_batch(self, step: int, *, keep_logits: bool = False) -> Dict[str, Any]:
        """Answer one batch of ``num_prompts * group_size`` requests from
        the prompt set's ``step``; the record (tokens and logprobs on the
        device, rewards on the host) goes to ``out_queue`` and is
        returned. ``keep_logits`` adds each step's logits
        (``step_logits``)."""
        cfg = self.cfg
        prompts = torch.from_numpy(self.prompts.sample(cfg.num_prompts * cfg.group_size, step))
        prompts = prompts.to(device=self.device, dtype=torch.int64)
        gen = torch.Generator(device=self.device).manual_seed(batch_seed(self.replica_name, step))
        out = sample_responses(
            self.model, self.params, prompts, cfg.response_len, gen, return_logits=keep_logits
        )
        seqs, lps = out[0], out[1]
        rec = {
            "tokens": seqs,
            "behavior_logprobs": lps,
            "rewards": self.prompts.reward(seqs.cpu().numpy(), cfg.prompt_len),
            "version": self.weights_version,
            "worker": self.replica_name,
        }
        if keep_logits:
            rec["step_logits"] = out[2]
        self.out_queue.append(rec)
        self.steps_done += 1
        return rec

    def pull_latest(self) -> bool:
        """``update("latest")`` into the registered buffers; True if a
        newer version was pulled."""
        if self.handle.update("latest"):
            self.weights_version = self.handle.current_version
            return True
        return False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TrainerWorker:
    """Fig. 4a trainer side, driven synchronously by the caller: on
    ``hub``'s device (the card by default), in ``dtype``.

    Its parameters are ``init_params`` of ``model_cfg`` from a generator
    seeded with ``cfg.seed`` on that device, or ``params`` (tensors on the
    device, e.g. carried from the JAX package); it registers them with
    TensorHub as they are and publishes v0. With ``keep_grads`` each
    step's gradients stay in ``last_grads``."""

    def __init__(
        self,
        hub: TensorHubClient,
        cfg: "RLConfig",
        model_cfg: ModelConfig,
        rollout_queue: List,
        *,
        datacenter: str = "dc0",
        dtype: torch.dtype = torch.float32,
        params: Optional[Mapping[str, torch.Tensor]] = None,
        keep_grads: bool = False,
    ) -> None:
        self.hub = hub
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.device = hub.device
        self.dtype = dtype
        check_trainable(model_cfg)  # before any weight is allocated: a family the port does not know is refused
        self.model = build_model(model_cfg)
        self.queue = rollout_queue
        self.opt = AdamW(lr=cfg.lr, weight_decay=0.0)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
            params = init_params(model_cfg, gen, dtype, self.device)
        self.last_grads: Optional[Dict[str, torch.Tensor]] = {} if keep_grads else None
        self.rl_step = make_grpo_step(self.model, model_cfg, self.opt, grads_out=self.last_grads)
        self.handle = hub.open(
            cfg.model_name, "trainer-0", num_shards=1, shard_idx=0,
            retain="latest", datacenter=datacenter,
        )
        self.version = 0
        self.metrics_log: List[Dict[str, float]] = []
        self.handle.register(dict(params))
        #: the registered buffers: the step writes them, publish reads them
        self.params = self.handle.store.tensors()
        self.opt_state = self.opt.init(self.params)
        t0 = time.perf_counter()
        self.handle.publish(self.version)
        _sync(self.device)
        #: host seconds of the last publish (and of the last ``train_on``'s
        #: step), each ended by a device synchronize
        self.last_timings: Dict[str, float] = {"publish_seconds": time.perf_counter() - t0}

    def wait_for_rollouts(self, n: int, timeout: float = 120.0) -> List[Dict]:
        deadline = time.monotonic() + timeout
        while len(self.queue) < n:
            if time.monotonic() > deadline:
                raise TimeoutError("rollouts did not arrive in time")
            time.sleep(0.01)
        return [self.queue.pop(0) for _ in range(n)]

    def batch_from(self, rollouts: List[Dict]) -> Dict[str, torch.Tensor]:
        """The GRPO batch of ``rollouts``, on the trainer's device: tokens,
        the behavior logprobs placed in the shifted ``[B, S-1]`` frame
        (position p-1 predicts token p), group-relative advantages of the
        rewards and the response-token mask."""
        cfg, dev = self.cfg, self.device
        tokens = torch.cat([torch.as_tensor(r["tokens"]).to(dev, torch.int64) for r in rollouts])
        lps = torch.cat([torch.as_tensor(r["behavior_logprobs"]).to(dev, torch.float32) for r in rollouts])
        rewards = np.concatenate([np.asarray(r["rewards"]) for r in rollouts])
        adv = group_relative_advantages(torch.from_numpy(rewards).to(dev), cfg.group_size)
        total = tokens.shape[1]
        blp = torch.zeros((tokens.shape[0], total - 1), dtype=torch.float32, device=dev)
        blp[:, cfg.prompt_len - 1 :] = lps
        loss_mask = torch.zeros((tokens.shape[0], total - 1), dtype=torch.bool, device=dev)
        loss_mask[:, cfg.prompt_len - 1 :] = True
        return {"tokens": tokens, "behavior_logprobs": blp, "advantages": adv, "loss_mask": loss_mask}

    def train_on(self, rollouts: List[Dict]) -> Dict[str, float]:
        """One GRPO step on ``rollouts``: unpublish, step in place, publish
        the next version; returns the JAX trainer's metric keys."""
        batch = self.batch_from(rollouts)
        rewards = np.concatenate([np.asarray(r["rewards"]) for r in rollouts])
        # Fig. 4a: unpublish -> mutate -> publish the new version
        self.handle.unpublish()
        _sync(self.device)
        t0 = time.perf_counter()
        _, self.opt_state, metrics = self.rl_step(self.params, self.opt_state, batch)
        _sync(self.device)
        t1 = time.perf_counter()
        self.version += 1
        self.handle.publish(self.version)
        _sync(self.device)
        self.last_timings = {"step_seconds": t1 - t0, "publish_seconds": time.perf_counter() - t1}
        out = {k: float(v) for k, v in metrics.items()}
        out["mean_reward"] = float(rewards.mean())
        out["version"] = self.version
        self.metrics_log.append(out)
        return out

    def close(self) -> None:
        self.handle.close()
