"""The rollout side of the RL loop, served from TensorHub replica buffers
(paper Fig. 4b).

The port's copy of ``RLConfig``, ``sample_responses`` and
``RolloutWorker`` from the JAX package's ``rl/loop.py``. A rollout worker
holds the model in its device memory as a TensorHub replica: it registers
zero buffers, ``replicate("latest")`` fills them, and it serves every
batch straight from ``handle.store.tensors()`` — the weights the worker
already holds are the storage (ROS, the paper's reference-oriented
storage). Between batches, on the same thread, ``update("latest")``
writes the next version into the same buffers in place, so the JAX
loop's per-step rebuild of the parameter tree has no counterpart here.

``TrainerWorker`` waits for the training slice.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.llama3_8b import DecoderConfig
from repro_torch.core import TensorHubClient
from repro_torch.core.errors import StaleHandleError, TensorHubError
from repro_torch.data.synthetic import PromptSet
from repro_torch.models.lm import DecoderLM
from repro_torch.models.params import decoder_shapes


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
    model: DecoderLM,
    params,
    prompts: torch.Tensor,  # [B, prompt_len] int64
    response_len: int,
    generator: torch.Generator,
    *,
    return_logits: bool = False,
):
    """Autoregressive sampling: prefill, then ``response_len`` decode
    steps (the last one's logits go unused, as in the JAX loop). Returns
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
        model_cfg: DecoderConfig,
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
        self.model = DecoderLM(model_cfg)
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
