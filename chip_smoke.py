#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs a CUDA device and the CUDA toolkit (``nvcc``); without a card it
exits non-zero before printing any result. Phases, each printed on its own
lines, any failure exiting non-zero:

1. The card: torch and CUDA versions, and ``nvidia-smi``'s name and power
   limit line.
2. The kernels: builds the CUDA sources of ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a, then holds each kernel bit-equal to its plain
   PyTorch version on the card at the transfer path's shapes, and times
   kernel, plain version and a device-to-device ``copy_`` of the same bytes
   (median of CUDA-event timings) beside the bytes bound. Flash
   attention's backward: dQ, dK, dV of the autograd Function (the forward
   route writing the rows' log-sum-exp, then the backward route: the
   three tensor-core kernels of ``flash_attention_bwd_tc.cu`` in bf16, the
   three CUDA-core kernels (pre, dK/dV, dQ) of ``flash_attention_bwd.cu``
   in f32 and f16 and at head_dim 16/32; at head_dim 256 each route's pre
   and its one dK/dV + dQ launch, dkdv_dq) against autograd through the
   plain attention at the GRPO step's shape in bf16, f32 and f16 and at
   its edges (S = 77, G 1/4/7/8/64, kv_len < Sk with NaN in the dead K/V
   slots, q_offset > 0, softcap, head_dim 64, 32, 16), each within
   tests/test_kernels.py's tolerance of the gradient's max |value| and
   bit-equal on a second run; the log-sum-exp against logsumexp of the
   plain scores; both backward routes timed on the same bf16 inputs
   beside the plain backward and SDPA's at the training shape, and the
   CUDA-core route beside SDPA's backward, and the f32 forward route
   beside SDPA's forward, at the f32 training shape. The sliding window
   (gemma2's local layers): every forward route that takes a call, named,
   against the plain version with windows of less than a tile (8), 64,
   100 and 4096, offsets, kv_len < Sk with NaN past it, softcap 50 and
   head_dim 256 on every route; the tensor-core forward at head_dim 256
   (G 2 and 7, with and without the log-sum-exp); both backward routes
   with those windows at head_dim 64/128/256 and at head_dim 256 in bf16
   (tensor_core), f32 and f16 (cuda_core), bit-equal on a rerun; gemma2's
   prefill attention (tensor_core route, beside the f32 route that took it
   before) and decode step (decode route) timed with its window of 4096
   and without, and its windowed backward at [2, 8/4, 4672, 256] in bf16
   (tensor_core, beside cuda_core) and f32 (cuda_core), each beside the
   plain version, the bound and SDPA without the softcap (its backend
   named). dbrx-132b's GQA group of 6 on the routes phase 11 takes: the
   tensor_core forward at q [4,48,512,128], k/v [4,8,512,128], the decode
   route at q [4,48,1,128] against 528 keys and the tensor_core backward
   at [4,48/8,576,128], each against its plain version and timed beside
   it and SDPA. ``checksum_words`` and ``quantize_rows`` on a bf16 tensor
   of more than 2^31 elements (dbrx's w_gate at 4 layers, [4,16,6144,10752]),
   bit-equal to their plain versions taken in pieces. deepseek-v3's MLA:
   the tensor_core forward at q/k 192, v 128 (the served prefill q/k
   [4,128,512,192], v [4,128,512,128] causal, S = 77, kv_len < Sk with
   NaN past it, q_offset > 0, a GQA group of 4) and the ``mla_decode``
   kernel (4 x 128 heads against 528 of 528 slots, kv_len 1, 65, 300 and
   527 with NaN in the dead slots, B = 1, 16 heads) against their plain
   versions, bit-equal on a rerun, each timed with the L2 cold beside the
   plain version, the bound and SDPA (its backend named). deepseek-v3
   trained: the tensor_core backward at (192, 128) (pre, then the one
   dkdv_dq launch; phase 12's training shape q/k [4,128,576,192], v
   [4,128,576,128] causal, G 1 and 2, S = 77, kv_len < Sk with NaN past it,
   q_offset > 0) against the plain backward, bit-equal on a rerun, dV at
   v's width, timed cold beside its kernels' split, the plain backward, the
   bound and SDPA's backward; the reduced config's (24, 16) on the f32
   forward (with the lse) and the cuda_core backward in f32, bf16 and f16
   against the plain versions, timed at phase 7's shape. internvl2-2b's
   GQA group of 2 at phase 14's shapes: the tensor_core forward at the
   served prefill (q [4,16,768,128], k/v [4,8,768,128] causal), the decode
   route against the 832 slots (kv_len 769, 800 and 832, NaN past it),
   and at the f32 training shape [2,16/8,512,128] the f32 forward with its
   lse and the cuda_core backward, each against its plain version,
   bit-equal on a rerun and timed beside it and SDPA. zamba2-2.7b's shared
   block at head_dim 80 and G 1 (``hybrid_attention_checks``): the decode
   route's split kernel at 80 in bf16 and f32 at kv_len 1, 63, 64, 65 and
   576, over a 4096-slot ring (``causal=False``), with a softcap, a window
   and a chunk of 4 rows, NaN past kv_len, and at phase 16's launch shapes
   (q [8,32,1,80] against [8,32,576,80] bf16, and against an f32 ring of
   4096 live slots), timed beside SDPA and the K/V bytes' bound; and the
   other three head_dim-80 kernels causal at phase 16's prefill and
   training shapes.
3. Transfer at full width: llama3-8b at its published widths in bf16, depth
   cut from 32 to 10 layers, weights from a seeded generator on the card.
   A trainer (dc0) publishes v0; rollout-0 (dc0) replicates over raw and
   rollout-1 (dc1) over int8; the trainer unpublishes, perturbs 1/8 of its
   256-element rows in place and publishes v1; both rollouts update
   (rollout-1 over delta:int8). rollout-0 must equal the trainer and
   rollout-1 the plain-version codec applied to the same bytes; both
   kernels' launch counters must rise on this path.
4. Resharded transfer at full width: the same model, published by a
   trainer group at TP-4 (dc0) and pulled by two rollout groups at TP-2,
   ``roll-int8`` (dc1, int8 wire frames decoded by the fused dequant+gather
   kernel) and ``roll-raw`` (dc0, staged, repacked by the gather kernel);
   then the trainer perturbs 1/8 of its rows and publishes v1 and both
   groups update. roll-raw must equal the trainer's bytes resharded to
   TP-2, roll-int8 the plain-version int8 codec's round trip of the
   trainer's TP-4 units resharded to TP-2; all four kernels' launch
   counters must rise on this path.
5. Serving at full width: flash attention held against its plain version
   on each of its three routes, GQA groups of 7 and 64 and NaN in the dead
   cache slots included (phase 2 above also times each route's
   kernel at the serving path's prefill and decode shapes beside the f32 route's
   kernel, the plain version and ``scaled_dot_product_attention``); then
   llama3-8b at all 32 layers in bf16 served from a TensorHub replica: a
   trainer publishes v0, a ``RolloutWorker`` replicates and answers 16
   requests of 512 prompt tokens with 64 new tokens each; the trainer
   perturbs 1/8 of its rows and publishes v1, the worker updates in place
   and answers again. The rollout must equal the trainer bit for bit, its
   logprobs and every step's logits must match a teacher-forced
   ``forward`` with the plain attention on the trainer's weights, round 1
   must differ from round 0, and flash attention must launch exactly 32 x
   (1 + 64) times a round: 32 on the tensor-core route (prefill), 32 x 64
   on the decode route and none on the f32 route.
6. The RL loop at full width (paper Fig. 4): llama3-8b at its published
   widths, 4 layers, bf16. A ``TrainerWorker`` publishes v0 (dc0); a
   ``RolloutWorker`` (dc0, raw) replicates it and serves 4 prompts x 4
   responses of 512 + 64 tokens; their rewards are replaced by seeded
   draws (a random-weight model scores 0, which would zero the step); the
   trainer runs one GRPO step (flash forward on the tensor-core route, the
   tensor-core backward kernels, AdamW in place) and publishes v1; the worker updates
   in place and serves again. The replica must equal the trainer bit for
   bit at v0 and v1, every tensor must get a finite nonzero gradient
   within a bf16 bound of a reference step with the plain attention (and
   within phase 2's tolerance of a step with the same kernel forward and
   the plain backward) and change from v0 to v1, round 1's logits must match a teacher-forced
   forward on v1, and a step must launch 4 tensor-core forwards and 4 of
   each tensor-core backward kernel (none on the decode or f32 routes, none
   of the CUDA-core backward). A profiled second step gives the step's
   device time by kernel.
7. The training entry point at its defaults: ``python -m
   repro_torch.launch.train`` (the reduced llama3-8b, head_dim 16, f32)
   for two steps on the card, then with ``--arch gemma2-2b`` (the reduced
   gemma2: window 8, softcaps, tied embeddings), then ``--arch gemma2-2b
   --full-config --batch 2 --seq 512`` (all 26 layers at the published
   widths, head_dim 256, f32), then ``--arch deepseek-v3-671b`` (the
   reduced deepseek-v3, MLA at q/k 24, v 16, f32); the losses must be
   finite (llama3-8b's those of earlier runs, 6.1012 and 6.0542) and every
   layer of every step must launch the f32 route and the CUDA-core
   backward, and no tensor-core kernel.
8. The networked deployment on the card: llama3-8b at phase 3's widths
   and depth, bf16. ``python -m repro_torch.net.controller`` (WAL-backed,
   host only), a publisher process (``chip_smoke.py --publisher``, a
   ``NetWorker`` on the card publishing phase 3's weights at TP-1 and at
   TP-4) and this process as the reader, a ``NetWorker`` on the same card
   whose every read crosses a localhost socket: a raw replicate (dc0)
   bit-equal to its own regeneration of the weights, an int8 replicate
   (dc1) bit-equal to the plain-version codec, TP-4 -> TP-2 resharded
   replicates over int8 (``raw_wire`` frames, the fused kernel) and raw
   (the gather kernel), a raw replicate through a SIGKILL of the
   controller mid-pull (restarted from its WAL on a new port; the
   reader's ``AddressWatcher`` fails it over; bit-identical), and a
   delta:int8 update to v1 bit-equal to the plain delta codec with no
   stale-base fallback. Each pull prints its seconds, GB/s, wire ratio,
   remote pulls and connection counts beside phase 3/4's in-process
   seconds; then ``python -m repro_torch.launch.networked`` at its
   defaults, whose readers must print ``MATCH`` and the digest numpy
   computes from rng 1234. The four byte kernels must launch on this
   path (the reader's launches plus those the publisher reports).
9. Dense archs from the config registry, each served from a replica and
   updated as in phase 5 and held to its gates: gemma2-2b at its published
   widths and all 26 layers (bf16, 5.2 GB a replica; 4 requests of 4608
   prompt tokens + 64 new, so the window of 4096 bites on the last 512
   prompt positions and every decode step; 26 tensor-core and 26 x 64
   decode-route launches a round), then yi-34b and deepseek-coder-33b at
   their published widths cut to 4 layers (4 x (512 + 16); G = 7 on the
   tensor-core and decode routes). Prefill and decode tokens/s and peak
   memory for each.
10. The RL loop of phase 6 at gemma2-2b's published widths and all 26
   layers, bf16: 2 prompts x 2 responses of 512 + 64 tokens, one GRPO
   step, publish v1, update, serve again, under phase 6's gates; the step
   must launch 26 tensor-core forwards and 26 of each tensor-core
   backward kernel with the window passed on the even layers, and nothing
   on the f32, decode or CUDA-core kernels.

11. Routed experts: dbrx-132b at its published widths (16 experts, top-4,
   d_expert 10752), bf16. Served as in phase 9 at 4 of its 40 layers (4 x
   (512 + 16); 4 tensor-core and 64 decode-route launches a round), each
   round held to phase 5's bounds against a replay of its calls with the
   plain attention (an expert's capacity follows a call's token count:
   the replay's calls route as many tokens as the served ones), the
   teacher-forced check held too where neither side dropped a pair; the
   pairs routed and dropped over capacity, and the token rows whose
   expert set differs between the two, printed. Then phase 6's RL loop
   at 1 layer, 2 prompts x 2 responses of 512 + 64, its gradient gates
   taken 2.5 GB of reference gradients at a time.

12. MLA attention: deepseek-v3-671b at its published widths (d_model
   7168, 128 heads, q_lora 1536, kv_lora 512, qk 128 + 64, v 128, 256
   experts top-8 + 1 shared, d_expert 2048, d_ff_dense 18432, vocab
   129280), bf16, served as phase 11 at 4 of its 61 layers (3 dense + 1
   MoE; 15.11 B parameters, 30.2 GB a copy) before and after an update:
   each round launches 4 tensor-core forwards at (192, 128) and 4 x 16
   ``mla_decode`` kernels and nothing on the decode or f32 routes, and is
   held against a replay of its calls with the plain attention and
   ``mla_decode_plain`` that follows the served experts; a profiled
   decode step's device time by kernel class. Then phase 6's RL loop at 4
   layers and 16 of its 256 experts (top-8), every width as published
   (4.54 B parameters): 2 prompts x 2 responses of 512 + 64, one GRPO step
   on the tensor-core forward and backward at (192, 128) (4 of each a
   step), publish v1, update, round 1 on ``mla_decode``, under phase 6's
   gates (the gradients taken 2.5 GB at a time) and a peak under 80 GB.

13. The simulator (``repro_torch.transfer.simcluster``) on the H100
   profile, on this host's CPU, at Table 3's sizes: Fig. 9's standalone
   publish -> replicate -> update (9B, 36B, 260B; 1T is left out, minutes
   of host time a run), Fig. 11's elastic replicate of 260B with 1 and 6
   spot replicas, Fig. 12's cross-DC seeding over raw, int8 and
   delta:int8, and a cross-DC TP-4 -> TP-2 int8 pull that reaches the
   fused decode's drain. Each runs twice with the same stalls and link
   bytes; every reader ends at the published version, its stall parts
   summing to its stall; the cross-DC update carries one copy's wire
   bytes over the WAN; the resharded pull's decode part under H100 is no
   larger than under an 819 GB/s profile. A ``sim`` line prints each
   scenario's stalls, WAN bytes and wall seconds, and the profile's
   modeled drain (HBM / 3) beside phase 2's measured ``dequant_gather``
   and ``copy_`` rates.

14. The VLM family: internvl2-2b at its published widths and all 24
   layers (d_model 2048, 16 query and 8 KV heads of 128, d_ff 8192, vocab
   92553, 256 patches), bf16, served from a rollout replica's registered
   buffers: 4 x (256 patches + 512 tokens) prefilled, 64 tokens decoded
   against 832 slots, before and after an update to v1, held to phase 5's
   gates against a teacher-forced forward with the plain attention; each
   round launches 24 tensor-core forwards and 24 x 64 decode-route ones.
   The prefill and decode steps are then timed on the model as
   ``build_model`` builds it (the default attention). Then ``launch.train --arch internvl2-2b --full-config`` for two f32
   steps of 2 x (256 stand-in patches + 256 tokens) on the f32 forward and
   the cuda_core backward.

15. The audio family: hubert-xlarge at its published widths and all 48
   layers (``audio_arch``): encoded from a replica before and after an
   update, one bf16 masked-prediction step, ``launch.train`` for two f32
   steps.

16. The hybrid family: zamba2-2.7b at its published widths cut to 18 of
   its 54 layers (3 of its 9 groups of 6 Mamba2 blocks, one shared
   attention block of 32 heads of 80 after each), bf16, served from a
   rollout replica's registered buffers: 8 x 512 tokens prefilled (3
   tensor-core forwards), 64 decoded (3 x 64 decode-route launches at
   head_dim 80 against 576 slots), before and after an update to v1, every logit finite and
   within phase 5's gates of a replay of the round's calls with the plain
   attention (the teacher-forced forward's distance printed: bf16 rounding
   alone moves it past them, tools/hybrid_bf16_noise.py);
   the same requests on the weights in f32 (the f32 prefill route and the
   decode kernel in f32) held to phase 5's gates; the ring-buffer window
   decode from ``init_cache(..., ring=True)`` on the f32 weights, its
   window cut to 64 so that it wraps in 100 steps, then 4 steps at 4096
   live slots, held to the plain attention; phase 6's RL loop at 2 x 2 x
   (512 + 64) in f32; ``launch.train --arch zamba2-2.7b --full-config`` for
   two f32 steps. Profiles of a bf16 prefill, a decode step and a GRPO
   forward and backward by kernel class, with the Mamba2 blocks' share
   (``ssd_share``).

17. The SSM family: xlstm-350m at its published widths cut to 6 of its 24
   layers (``xlstm_arch``: 3 pairs of one mLSTM block, 4 heads of 512, and
   one sLSTM block, 4 heads of 256; no attention, no kernel of its own), bf16,
   served from a raw rollout replica's registered buffers: 8 x 512 tokens
   prefilled, 64 decoded, before and after an update to v1, beside a dc1
   replica pulled over int8 and updated over delta:int8 and held bit-equal
   to the plain codec (phase 3's check); the bf16 rounds' distances to the
   teacher-forced forward printed, an f32 round of the same requests held
   to phase 5's gates and bit-equal on a rerun; the block forms in f32
   (the chunked mLSTM against its parallel form, forward and input
   gradient, at T = 512; 16 one-step recurrences against the chunked form
   and the folded state; the sLSTM split at 5) within 2e-3; phase 6's RL
   loop in f32 at 2 x 2 x (512 + 64), its gradients against the step with
   the mLSTM on its parallel form within 1e-3 (rel. L2); ``launch.train
   --arch xlstm-350m --full-config`` for two f32 steps of 2 x 512. The
   prefill and a decode step timed and profiled, with the mLSTM and sLSTM
   blocks' shares of their spans (``xlstm_share``).
18. Sharding and flags: the 1x1 smoke mesh (``launch.make_smoke_mesh``,
   NCCL at world size 1) with the serve rules' placements of every
   llama3-8b tensor (all replicated) and a 1 GiB tensor distributed over
   it and back bit-equal; H3 (``optimizations(mesh=, shardmap_moe=True)``)
   on a reduced dbrx layer, from plain and placed tensors, taking the
   reference's ``tp <= 1`` fallback bit-equal to ``moe_apply``; H2's
   ``rms_norm`` (``lowp_norm``) at [16 x 512, 4096] bf16, off and on, each
   within 2e-2 of the f32 norm in float64 and timed beside one bf16 read
   and write at the memory rate; a bf16 llama3-8b prefill (16 x 512, 32
   layers) and a bf16 hubert-xlarge encode (8 x 1000 frames, 48 layers),
   each with H2 off and on: wall and device time, the elementwise share of
   device time, the flash launches (32 and 48 on the tensor-core route a
   call) and the H2 logits' distance from the H2-off logits (printed, not
   gated).
19. The sharded train step on the smoke mesh (``sharded_step``): llama3-8b
   at its published widths and 4 layers, bf16 with f32 moments, one LM
   batch of 4 x 512, three ``make_train_step`` steps from the same
   parameters and moments: (a) on plain tensors, (b) on DTensors placed by
   ``TRAIN_RULES`` (``sharding.place_tree``), (c) the same under H1 (K/V
   broadcast to the 32 query heads: the tensor-core forward and backward
   at G = 1, [4,32/32,512,128]). (b)'s gradients within 1e-6 (rel. L2) of
   (a)'s; (c)'s loss within 1e-3, gradients within 2e-2 and parameters
   after the step within 5e-3 of (a)'s; every turn one tensor-core forward
   and backward a layer. Each step's seconds, host return time, peak
   memory and a profiled turn's idle share; then the G = 1 forward and
   backward held to their plain versions and timed cold beside SDPA
   (cuDNN where it takes the call) and their bounds.

20. The dry run and its cost model (``cost_model``): (a) the dry run
   (``launch.dryrun.run_cell``) of llama3-8b's three cells and dbrx-132b's
   ``train_4k`` on the faked 16x16 mesh, in a process of its own on the
   host's CPU started with the script (``--dryrun``), each cell's counts,
   three terms and fractions printed, a cell that does not trace failing
   the run; (b) llama3-8b's ``prefill_32k`` (1 sequence, 32 layers),
   ``decode_32k`` (8 sequences, 32768 slots) and ``train_4k`` (2 x 4096, 4
   layers) on the 1x1 NCCL smoke mesh through the cells' step functions
   and the kernel operators (bit-equal to the default path at one layer),
   timed with CUDA events, counted by ``launch.op_costs`` on the real
   tensors and held equal in dot FLOPs and collectives to the same cell
   traced on fake tensors at world 1; the tensor-core forward at 32768
   query rows, the decode route at 32768 slots and the training shape's
   forward and backward held to their plain versions and timed.

A ``kernels`` JSON line (launches over phases 3 to 20; flash
   attention's entry carries a ``routes`` field with each route's times,
   bound and launches, the ``f32`` route's timed at the f32 training
   shape at the f32 peak; the backward has one entry a route,
   ``flash_attention_bwd/tensor_core`` timed at the bf16 training shape and
   ``flash_attention_bwd/cuda_core`` at the f32 one), then the last line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
try:  # the card's published peaks, the port's H100 profile: one source for every bound
    from repro_torch.transfer.hardware import H100
except ImportError:  # run from the root of a checkout: its src/ joins the path
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.transfer.hardware import H100
    except ImportError as e:
        sys.exit(f"chip_smoke: run from the root of a checkout ({e})")
SEED = 0
NUM_LAYERS = 10  # of llama3-8b's 32: three replicas and their delta bases fit one 80 GB card
GIB = 1 << 30
MASK32 = 0xFFFFFFFF
SRC_TP, DST_TP = 4, 2  # phase 4: trainer and rollout tensor-parallel degrees
W_GATE = "layers/ffn/w_gate"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def memory_rate(name: str) -> tuple:
    """Published HBM rate of the card, by its name."""
    if "PCIe" in name:
        return "H100 PCIe", 2.0e12
    if "NVL" in name:
        return "H100 NVL", 3.9e12
    return "H100 SXM", H100.hbm_bw


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median of per-call CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


PROFILE_ATTEMPTS = 3  # profiler sessions tried before a trace counts as empty


def traced(torch, run, activities):
    """``torch.profiler`` over ``run()``, ended by a synchronize: the
    trace's events and the wall seconds of ``run``. Now and then a
    session records no device activity at all; such a session is retried
    in a fresh one (a line says so), up to ``PROFILE_ATTEMPTS``, and an
    empty trace is returned only when every attempt was empty."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            return events, wall
        emit("profiler_retry", attempt=attempt, why="the trace holds no device activity")
    return [], wall


def device_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the summed duration of the
    kernels it launches, traced by ``torch.profiler`` over ``reps`` calls.
    For calls shorter than their host launch, where a CUDA-event pair
    around one call measures the host's enqueue as well. Where the
    profiler records nothing in every attempt, the time of the ``reps``
    calls back to back between two CUDA events, over ``reps`` (a line
    says so)."""
    from torch.profiler import ProfilerActivity

    for _ in range(warmup):
        fn()

    def run():
        for _ in range(reps):
            fn()

    events, _ = traced(torch, run, [ProfilerActivity.CUDA])
    if events:
        return sum(e.time_range.elapsed_us() for e in events) / reps * 1e-3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    emit("device_ms_by_events", why="the profiler recorded no device activity", reps=reps)
    return a.elapsed_time(b) / reps


def cold_ms(torch, fn, flush, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn`` with the L2 cache
    evicted before it, as a layer's attention finds it after the other
    layers' weights have streamed through: ``flush`` (a buffer larger than
    the 50 MB L2) is filled first, and the fill outlasts the host's
    enqueue of ``fn``, so the events time the device alone."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_split_ms(torch, call, flush, reps: int = 20, match: str = "flash_bwd") -> dict:
    """Each kernel's mean device time in ms over ``reps`` calls of
    ``call``, by its name (those holding ``match``), from profiler traces:
    ``cold`` with the L2 filled before every call, ``warm`` with calls back
    to back."""
    import re

    from torch.profiler import ProfilerActivity

    out = {}
    for mode in ("cold", "warm"):
        def run():
            for _ in range(reps):
                if mode == "cold":
                    flush.zero_()
                call()

        events, _ = traced(torch, run, [ProfilerActivity.CUDA])
        sums = {}
        for e in events:
            if match in e.name:
                name = re.search(rf"{match}\w*(<[^>]*>)?", e.name).group(0)
                sums[name] = sums.get(name, 0.0) + e.time_range.elapsed_us() * 1e-3 / reps
        out[mode] = sums
    return out


# -- phase 2: kernels against their plain versions ----------------------------


def kernel_checks(torch, dev, bw: float) -> dict:
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import quant as qk
    from repro_torch.transfer.checksum import ZERO_STANDIN, checksum

    g = torch.Generator(device=dev).manual_seed(SEED)
    w_gate_bytes = NUM_LAYERS * 4096 * 14336 * 2
    embed_bytes = 128256 * 4096 * 2
    ln_bucket_bytes = 4096 * 2 + 2 * NUM_LAYERS * 4096 * 2
    raw = torch.randint(0, 256, (w_gate_bytes + 64,), dtype=torch.uint8, generator=g, device=dev)
    cases = {
        "w_gate unit": raw[:w_gate_bytes],
        "w_gate first 1 GiB chunk": raw[:GIB],
        "embed unit": raw[:embed_bytes],
        "ln compact bucket": raw[:ln_bucket_bytes],
        "1 B": raw[:1],
        "3 B": raw[:3],
        "5 B": raw[:5],
        "4097 B": raw[:4097],
        "unaligned view +1, 64 MiB + 3": raw[1 : 1 + (64 << 20) + 3],
        "unaligned view +3, 4097 B": raw[3 : 3 + 4097],
        "zero fold": torch.zeros(4096, dtype=torch.uint8, device=dev),
    }
    worst = 0
    for label, buf in cases.items():
        got = ck.checksum_words(buf).to(torch.int64) & MASK32
        want = ck.checksum_words_plain(buf)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        emit("checksum_check", case=label, nbytes=buf.numel(), equal=err == 0)
        check(err == 0, f"checksum kernel != plain version on {label}")
    check(checksum(cases["zero fold"]) == ZERO_STANDIN, "zero fold not remapped")

    chunk = cases["w_gate first 1 GiB chunk"]
    dst = torch.empty_like(chunk)
    ck_ms = time_ms(torch, lambda: ck.checksum_words(chunk), reps=20)
    ck_plain_ms = time_ms(torch, lambda: ck.checksum_words_plain(chunk), reps=3, warmup=1)
    ck_copy_ms = time_ms(torch, lambda: dst.copy_(chunk), reps=20)
    ck_bound_ms = chunk.numel() / bw * 1e3
    del raw, cases, chunk, dst
    torch.cuda.empty_cache()

    q_cases = {}
    n_chunk = GIB // 2  # a 1 GiB bf16 chunk
    q_cases["1 GiB bf16 chunk"] = torch.randn(n_chunk, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
    q_cases["f32, 16M + 77"] = torch.randn((16 << 20) + 77, generator=g, device=dev, dtype=torch.float32)
    q_cases["f16, 16M"] = torch.randn(16 << 20, generator=g, device=dev, dtype=torch.float16)
    q_cases["bf16 ragged tail, 1M + 77"] = torch.randn((1 << 20) + 77, generator=g, device=dev, dtype=torch.bfloat16)
    zero_rows = torch.randn(256 * 64 + 5, generator=g, device=dev, dtype=torch.float32)
    zero_rows[256 * 3 : 256 * 4] = 0.0  # an all-zero row: scale 1e-12
    zero_rows[256 * 64 :] = 0.0  # an all-zero ragged tail row
    q_cases["all-zero rows"] = zero_rows
    q_worst = 0.0
    for label, x in q_cases.items():
        q1, s1 = qk.quantize_rows(x)
        q2, s2 = qk.quantize_rows_plain(x)
        torch.cuda.synchronize()
        q_err = int((q1.to(torch.int16) - q2.to(torch.int16)).abs().max())
        s_err = float((s1 - s2).abs().max())
        bits_equal = torch.equal(q1, q2) and torch.equal(s1.view(torch.int32), s2.view(torch.int32))
        q_worst = max(q_worst, q_err, s_err)
        emit("quant_check", case=label, n=x.numel(), dtype=str(x.dtype), equal=bits_equal)
        check(bits_equal, f"quant kernel != plain version on {label}")
    check(float(qk.quantize_rows(zero_rows)[1][3]) == float(torch.tensor(1e-12)), "zero-row scale")

    x = q_cases["1 GiB bf16 chunk"]
    rows = -(-x.numel() // qk.ROW_LEN)
    xdst = torch.empty_like(x)
    q_ms = time_ms(torch, lambda: qk.quantize_rows(x), reps=20)
    q_plain_ms = time_ms(torch, lambda: qk.quantize_rows_plain(x), reps=3, warmup=1)
    q_copy_ms = time_ms(torch, lambda: xdst.copy_(x), reps=20)
    q_bytes = x.numel() * 2 + x.numel() + 4 * rows  # read bf16, write int8 q and f32 scales
    q_bound_ms = q_bytes / bw * 1e3
    del q_cases, x, xdst, zero_rows
    torch.cuda.empty_cache()

    copy_gbps = GIB / (ck_copy_ms * 1e-3) * 2 / 1e9  # a copy reads and writes every byte
    emit(
        "kernel_times",
        checksum={"bytes": GIB, "ms": ck_ms, "plain_ms": ck_plain_ms, "copy_ms": ck_copy_ms,
                  "bound_ms": ck_bound_ms, "achieved_GBps": GIB / (ck_ms * 1e-3) / 1e9},
        quantize_rows={"bytes_moved": q_bytes, "ms": q_ms, "plain_ms": q_plain_ms,
                       "copy_ms": q_copy_ms, "bound_ms": q_bound_ms,
                       "achieved_GBps": q_bytes / (q_ms * 1e-3) / 1e9},
        measured_copy_GBps=copy_gbps,
    )
    return {
        "checksum": dict(
            name="checksum", route="cuda",
            source="src/repro_torch/kernels/csrc/checksum.cu",
            replaces="src/repro/kernels/checksum/kernel.py:47",
            max_abs_err=worst, ms=ck_ms, plain_ms=ck_plain_ms, bound_ms=ck_bound_ms,
            bound_by="bytes", library_ms=None, copy_ms=ck_copy_ms,
            timed_shape="uint8[1073741824] (1 GiB chunk)", matched=True,
            counter=ck.LAUNCHES,
        ),
        "quantize_rows": dict(
            name="quantize_rows", route="cuda",
            source="src/repro_torch/kernels/csrc/quant.cu",
            replaces="src/repro/kernels/quant/kernel.py:30",
            max_abs_err=q_worst, ms=q_ms, plain_ms=q_plain_ms, bound_ms=q_bound_ms,
            bound_by="bytes", library_ms=None, copy_ms=q_copy_ms,
            timed_shape="bfloat16[536870912] (1 GiB chunk)", matched=True,
            counter=qk.LAUNCHES,
        ),
    }


def shape_manifest(torch, glob, shard: int, tp: int):
    """The manifest a TP-``tp`` shard of ``glob`` registers, built from
    shapes alone (meta tensors), and the shard's layout."""
    from repro_torch.core.meta import ShardManifest, build_units
    from repro_torch.resharding import tp_shard
    from repro_torch.transfer.engine import tensor_meta

    local, lay = tp_shard(glob, shard, tp)
    metas = [tensor_meta(n, a, lay[n]) for n, a in local.items()]
    units = build_units(metas)
    return ShardManifest(tensors=tuple(metas), units=tuple(units), checksums=(0,) * len(units)), local, lay


def w_gate_executor(torch, dev, codec: str):
    """The TP-2 destination unit of ``layers/ffn/w_gate`` (the largest
    unit of phase 4, tied with w_up and w_down) as phase 4 plans it from
    the TP-4 source. Planned from shapes alone: the plan of a plain unit
    does not depend on the other tensors."""
    from repro_torch.resharding import ReshardExecutor, layout_from_manifests, plan_shard

    glob = {W_GATE: torch.empty((NUM_LAYERS, 4096, 14336), dtype=torch.bfloat16, device="meta")}
    src = {i: shape_manifest(torch, glob, i, SRC_TP)[0] for i in range(SRC_TP)}
    dst = shape_manifest(torch, glob, 0, DST_TP)[0]
    plan = plan_shard(
        layout_from_manifests(src, SRC_TP), layout_from_manifests({0: dst}, DST_TP), 0,
        num_dest_units=dst.num_units, codec=codec,
    )
    return ReshardExecutor(plan, dst, device=dev)


def byte_err(torch, got, want) -> int:
    """Largest difference between two byte tensors, byte by byte (0 when
    they are bit-equal): the outputs mix dtypes, so bytes are the common
    unit."""
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0


def gather_map(torch, runs, out_nbytes: int, staging_nbytes: int, dev):
    """The per-byte int32 index map the TPU kernel gathers through
    (``build_gather_map``): uncovered bytes point at an appended zero."""
    idx = torch.full((out_nbytes,), staging_nbytes, dtype=torch.int32, device=dev)
    for s_off, d_off, n in runs:
        idx[d_off : d_off + n] = torch.arange(s_off, s_off + n, dtype=torch.int32, device=dev)
    return idx


def reshard_kernel_checks(torch, dev, bw: float) -> dict:
    """Phase 2 for the resharding kernels: the gather and the fused
    dequant+gather held bit-equal to their plain versions, then timed at
    the main path's shape (the TP-2 shard of w_gate with its real runs)."""
    from repro_torch.kernels import repack as rk
    from repro_torch.kernels.quant import fused as fk
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.transfer.codec import Int8Codec, as_bytes, parse_int8_frame

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def rand_bytes(n):
        return torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g, device=dev)

    # -- gather_bytes --------------------------------------------------------
    ex = w_gate_executor(torch, dev, "raw")
    unit = ex.manifest.units[0]
    real_runs = ex.instructions(unit.index)
    check(len(real_runs) == SRC_TP * NUM_LAYERS // DST_TP, f"w_gate runs: {len(real_runs)}")
    staging = rand_bytes(ex.staging_bytes(unit.index))
    g_cases = {f"w_gate TP-2 unit, {len(real_runs)} real runs": (staging, real_runs, unit.nbytes)}
    for seed in range(4):
        n = (1 << 20) * (seed + 1) + 7 * seed + 1
        runs = rk.random_runs(seed, n)
        buf = rand_bytes(n + 16)
        g_cases[f"random tiling {seed}, {len(runs)} runs, {n} B"] = (buf, runs, n)
        g_cases[f"random tiling {seed} with gaps"] = (buf, runs[::2], n)
    buf = rand_bytes((1 << 20) + 64)
    for mod in (1, 2, 3):
        for smod, dmod in ((mod, mod), (mod, 0), (0, mod), (mod, 16 - mod)):
            n = (1 << 19) + 5
            runs = [(smod, 64 + dmod, n), (smod + n, dmod, 48)]
            g_cases[f"offsets src {smod} / dst {dmod} mod 16"] = (buf, runs, 64 + dmod + n + 3)
    g_cases["gaps: two runs, 3 B between, 9 B after"] = (buf, [(5, 0, 1000), (1005, 1003, 4000)], 5012)
    g_worst = 0  # largest byte difference, kernel against plain version
    for label, (src, runs, n) in g_cases.items():
        covered = rk.covers([(d, k) for _, d, k in runs], n)
        got = rk.gather_bytes(src, runs, n)
        want = rk.repack_plain(src, runs, n)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        g_worst = max(g_worst, byte_err(torch, got, want))
        emit("gather_check", case=label, nbytes=n, runs=len(runs), covered=covered, equal=equal)
        check(equal, f"gather kernel != plain version on {label}")
    g_ms = time_ms(torch, lambda: rk.gather_bytes(staging, real_runs, unit.nbytes), reps=20)
    g_plain_ms = time_ms(torch, lambda: rk.repack_plain(staging, real_runs, unit.nbytes), reps=10)
    padded = torch.cat([staging, torch.zeros(1, dtype=torch.uint8, device=dev)])
    idx = gather_map(torch, real_runs, unit.nbytes, staging.numel(), dev)
    check(torch.equal(torch.index_select(padded, 0, idx), rk.gather_bytes(staging, real_runs, unit.nbytes)),
          "index_select yardstick != gather kernel")
    g_lib_ms = time_ms(torch, lambda: torch.index_select(padded, 0, idx), reps=10)
    gdst = torch.empty_like(staging)
    g_copy_ms = time_ms(torch, lambda: gdst.copy_(staging), reps=20)
    g_bound_ms = 2 * unit.nbytes / bw * 1e3  # every byte read once and written once
    del g_cases, staging, padded, idx, gdst, buf
    torch.cuda.empty_cache()

    # -- dequant_gather ------------------------------------------------------
    plain_codec = Int8Codec(quantize=quantize_rows_plain)

    def frame(dtype, n, poison=False):
        x = torch.randn(n, generator=g, device=dev, dtype=torch.float32).mul_(2).to(dtype)
        if poison:
            x[n // 2] = float("inf")  # ships as a passthrough frame
        name = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64"}[dtype]
        return parse_int8_frame(plain_codec.encode(x.view(torch.uint8), name))

    def pack(specs):
        """(frame, lead, nbytes, gap) -> placements, 24 bytes uncovered at the end."""
        pos, out = 0, []
        for f, lead, nbytes, gap in specs:
            pos += gap
            out.append((f, lead, nbytes, pos))
            pos += nbytes
        return out, pos + 24

    f_cases = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32, torch.float64):
        isz = torch.empty((), dtype=dtype).element_size()
        ragged = frame(dtype, (1 << 20) + 77)
        f_cases[f"{dtype}: lead/tail trim, ragged last row, passthrough, gap"] = pack([
            (ragged, 256 * isz, ((1 << 20) + 77 - 256 - 100) * isz, 0),
            (frame(dtype, 513), 3 * isz, 510 * isz, 2 * isz),
            (frame(dtype, 300, poison=True), 4 * isz, 200 * isz, 0),
            (ragged, ((1 << 20) + 77 - 90) * isz, 90 * isz, 0),  # the ragged row's tail
        ])
    f_cases["mixed dtypes in one unit, byte-misaligned"] = pack([
        (frame(torch.float64, 600), 8 * 7, 8 * 500, 0),
        (frame(torch.bfloat16, 513), 3, 2 * 400 + 1, 1),
        (frame(torch.float32, 256), 0, 4 * 256, 3),
        (frame(torch.float16, 300, poison=True), 1, 97, 0),
        (frame(torch.float16, 900), 2 * 256, 2 * 644, 0),
    ])
    # the main path's shape: w_gate's TP-2 unit from its TP-4 source's
    # int8 interval frames
    ex8 = w_gate_executor(torch, dev, "int8")
    unit8, placed = next(ex8.unit_batches())
    src_data = [
        torch.randn((NUM_LAYERS, 4096 // SRC_TP, 14336), generator=g, device=dev,
                    dtype=torch.float32).mul_(0.02).to(torch.bfloat16)
        for _ in range(SRC_TP)
    ]
    codec = Int8Codec()
    real = []
    for p in placed:
        iv = p.interval
        view = as_bytes(src_data[iv.source_shard])[iv.read_offset : iv.read_offset + iv.read_nbytes]
        real.append((parse_int8_frame(codec.encode(view, "bfloat16")), iv.lead, iv.nbytes, p.unit_offset))
    del src_data
    main_label = f"w_gate TP-2 unit, {len(real)} real int8 placements"
    f_cases[main_label] = (real, unit8.nbytes)
    f_worst = 0
    for label, (placements, n) in f_cases.items():
        got = fk.fused_repack(placements, n)
        want = fk.fused_repack_plain(placements, n)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        f_worst = max(f_worst, byte_err(torch, got, want))
        emit("dequant_gather_check", case=label, nbytes=n, placements=len(placements), equal=equal)
        check(equal, f"fused dequant+gather kernel != plain version on {label}")
    f_ms = time_ms(torch, lambda: fk.fused_repack(real, unit8.nbytes), reps=20)
    f_plain_ms = time_ms(torch, lambda: fk.fused_repack_plain(real, unit8.nbytes), reps=5, warmup=1)
    fout = fk.fused_repack(real, unit8.nbytes)
    fdst = torch.empty_like(fout)
    f_copy_ms = time_ms(torch, lambda: fdst.copy_(fout), reps=20)
    elems = unit8.nbytes // 2
    f_bytes = elems + 4 * -(-elems // 256) + unit8.nbytes  # q, scales, bf16 output
    f_bound_ms = f_bytes / bw * 1e3
    del f_cases, real, fout, fdst
    torch.cuda.empty_cache()

    emit(
        "reshard_kernel_times",
        gather_bytes={"shape": f"uint8[{unit.nbytes}], {len(real_runs)} runs", "ms": g_ms,
                      "plain_ms": g_plain_ms, "index_select_ms": g_lib_ms, "copy_ms": g_copy_ms,
                      "bound_ms": g_bound_ms,
                      "achieved_GBps": 2 * unit.nbytes / (g_ms * 1e-3) / 1e9},
        dequant_gather={"shape": f"bf16[{elems}] from int8, {len(placed)} placements",
                        "bytes_moved": f_bytes, "ms": f_ms, "plain_ms": f_plain_ms,
                        "copy_ms": f_copy_ms, "bound_ms": f_bound_ms,
                        "achieved_GBps": f_bytes / (f_ms * 1e-3) / 1e9},
    )
    return {
        "gather_bytes": dict(
            name="gather_bytes", route="cuda",
            source="src/repro_torch/kernels/csrc/repack.cu",
            replaces="src/repro/kernels/repack/kernel.py:35",
            max_abs_err=g_worst, ms=g_ms, plain_ms=g_plain_ms, bound_ms=g_bound_ms,
            bound_by="bytes", library_ms=g_lib_ms, copy_ms=g_copy_ms,
            timed_shape=f"uint8[{unit.nbytes}] ({W_GATE} TP-2 unit, {len(real_runs)} runs)",
            matched=True, counter=rk.LAUNCHES,
        ),
        "dequant_gather": dict(
            name="dequant_gather", route="cuda",
            source="src/repro_torch/kernels/csrc/fused.cu",
            replaces="src/repro/kernels/quant/fused.py:159",
            max_abs_err=f_worst, ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound_ms,
            bound_by="bytes", library_ms=None, copy_ms=f_copy_ms, output_bytes=unit8.nbytes,
            timed_shape=f"int8 -> bfloat16[{elems}] ({W_GATE} TP-2 unit, {len(placed)} placements)",
            matched=True, counter=fk.LAUNCHES,
        ),
    }


# -- phase 3: the transfer path at full width ----------------------------------


def max_rel_err(torch, got, want) -> float:
    g = got.to(torch.float32)
    w = want.to(torch.float32)
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-12)


def timed_step(torch, dev, hub, counters, total, steps, label, fn, **tags) -> None:
    """Run one step of a transfer path, ended by a device synchronize;
    record and print its seconds, payload GB/s, bytes per link class and
    kernel launches."""
    torch.cuda.synchronize(dev)
    before = {k: c.value for k, c in counters.items()}
    wire0 = dict(hub.transport.wire_bytes)
    dec0 = dict(hub.transport.decoded_bytes)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    wire = {k: v - wire0.get(k, 0) for k, v in hub.transport.wire_bytes.items() if v - wire0.get(k, 0)}
    dec = {k: v - dec0.get(k, 0) for k, v in hub.transport.decoded_bytes.items() if v - dec0.get(k, 0)}
    launches = {k: c.value - before[k] for k, c in counters.items()}
    rec = dict(seconds=dt, payload_bytes=total, GBps=total / dt / 1e9, wire_bytes=wire,
               decoded_bytes=dec, launches=launches,
               wire_ratio={k: wire[k] / dec[k] for k in wire if dec.get(k)})
    steps[label] = rec
    emit("step", **tags, step=label, **rec)


def transfer(torch, dev, counters, shapes, chunk_bytes) -> dict:
    """Drive publish -> replicate -> update through the client; return the
    kernels' launch counts on that path."""
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.transfer.codec import DeltaCodec, Int8Codec

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    weights = {
        n: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02) for n, s in shapes
    }
    total = sum(w.nbytes for w in weights.values())
    emit("model", config="llama3-8b", shapes=dict(shapes), dtype="bfloat16", bytes=total)

    torch.cuda.reset_peak_memory_stats(dev)
    server = ReferenceServer()
    hub = TensorHubClient(server, device=dev, chunk_bytes=chunk_bytes)
    trainer = hub.open("m", "trainer", 1, 0, datacenter="dc0")
    trainer.register(weights)
    r0 = hub.open("m", "rollout-0", 1, 0, datacenter="dc0")
    r1 = hub.open("m", "rollout-1", 1, 0, datacenter="dc1")
    r0.register({n: torch.zeros_like(w) for n, w in weights.items()})
    r1.register({n: torch.zeros_like(w) for n, w in weights.items()})
    units = trainer.store.units
    check(any(u.nbytes > chunk_bytes for u in units), "no unit above the chunk threshold")
    check(any(u.is_compact for u in units), "no compact bucket")
    plain_int8 = Int8Codec(quantize=quantize_rows_plain)
    plain_delta = DeltaCodec("int8", quantize=quantize_rows_plain)
    steps = {}

    def step(label, fn):
        timed_step(torch, dev, hub, counters, total, steps, label, fn)

    def r0_equals_trainer():
        for n, w in trainer.store.tensors().items():
            check(torch.equal(r0.store.get(n), w), f"rollout-0 {n} != trainer")

    def rel_err_r1():
        worst = max(max_rel_err(torch, r1.store.get(n), w) for n, w in trainer.store.tensors().items())
        check(worst < 0.01, f"rollout-1 max relative error {worst} >= 1%")
        return worst

    for c in counters.values():
        c.reset()
    step("publish v0", lambda: trainer.publish(0))
    step("replicate rollout-0 (raw)", lambda: r0.replicate(0, timeout=600))
    r0_equals_trainer()
    step("replicate rollout-1 (int8)", lambda: r1.replicate(0, timeout=600))

    def perturb_and_publish():
        trainer.unpublish()
        gp = torch.Generator(device=dev).manual_seed(SEED + 2)
        for w in trainer.store.tensors().values():
            flat = w.view(-1)
            full = flat.numel() // 256 * 256
            rows = flat[:full].view(-1, 256)[::8]  # 1/8 of the 256-element rows, in place
            rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
        trainer.publish(1)

    step("unpublish, perturb 1/8 rows, publish v1", perturb_and_publish)
    step("update rollout-0 (raw)", lambda: check(r0.update("latest"), "rollout-0 not updated"))
    step("update rollout-1 (delta:int8)", lambda: check(r1.update("latest"), "rollout-1 not updated"))
    launches = {k: c.value for k, c in counters.items()}  # the main path's launches, read now
    peak = torch.cuda.max_memory_allocated(dev)

    r0_equals_trainer()
    check(hub.transport.delta_stale_fallbacks == 0, "delta fell back to int8 (stale base)")
    check(server.stats.get("delta_assignments", 0) >= 1, "no delta assignment negotiated")
    i8 = steps["replicate rollout-1 (int8)"]["wire_ratio"].get("vpc_up", 1.0)
    dl = steps["update rollout-1 (delta:int8)"]["wire_ratio"].get("vpc_up", 1.0)
    check(i8 < 0.52, f"int8 wire ratio {i8}")
    check(dl < 0.2, f"delta wire ratio {dl}")
    # rollout-1 against the plain-version codec on the same bytes, unit by
    # unit (chunks are row aligned, so a whole-unit encoding is identical)
    for u in units:
        v1 = trainer.store._gather_unit(u)
        dtype = trainer.store.unit_dtype(u)
        wire = plain_delta.encode(v1, dtype, base=trainer.store.base_unit(u))
        want = plain_delta.decode(wire, base=r1.store.base_unit(u))
        check(torch.equal(r1.store._gather_unit(u), want), f"rollout-1 unit {u.name} != plain delta codec")
        held_v0 = plain_int8.decode(plain_int8.encode(trainer.store.base_unit(u), dtype))
        check(torch.equal(r1.store.base_unit(u), held_v0), f"rollout-1 v0 unit {u.name} != plain int8 codec")
    worst = rel_err_r1()
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the transfer path")
    emit("transfer_result", launches=launches, max_memory_allocated=peak,
         rollout1_max_rel_err=worst, int8_wire_ratio=i8, delta_wire_ratio=dl,
         server_stats={k: v for k, v in server.stats.items() if v})
    return dict(launches, step_seconds={label: rec["seconds"] for label, rec in steps.items()})


# -- phase 4: resharded transfer at full width --------------------------------


def run_group(handles, fn, timeout: float = 600.0) -> None:
    """One thread per shard, joined with a timeout; the first failure
    re-raised here."""
    errs = []

    def wrap(h):
        try:
            fn(h)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    ts = [threading.Thread(target=wrap, args=(h,), daemon=True) for h in handles]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout)
    check(not any(t.is_alive() for t in ts), "a shard thread did not finish in time")
    if errs:
        raise errs[0]


def meta_globals(torch, layouts):
    """The trainer's global tensors as meta tensors (shapes only), from
    its per-tensor ``(global_shape, offset)`` layout."""
    return {n: torch.empty(gshape, dtype=torch.bfloat16, device="meta") for n, (gshape, _) in layouts.items()}


def reshard_transfer(torch, dev, counters, shapes, chunk_bytes) -> dict:
    """Drive publish (TP-4) -> resharded replicate (TP-2, raw and int8) ->
    update through the client; return the kernels' launch counts on that
    path."""
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.resharding import layout_from_manifests, plan_shard, tp_shard
    from repro_torch.transfer.codec import Int8Codec

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    server = ReferenceServer()
    hub = TensorHubClient(server, device=dev, chunk_bytes=chunk_bytes)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = [hub.open("m", "trainer", SRC_TP, i, datacenter="dc0") for i in range(SRC_TP)]
    local = [{} for _ in range(SRC_TP)]
    lay = [{} for _ in range(SRC_TP)]
    for name, shape in shapes:  # one global tensor at a time, cut into owned shards
        w = torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02)
        for i in range(SRC_TP):
            part, lay_i = tp_shard({name: w}, i, SRC_TP)
            local[i][name] = part[name].clone()
            lay[i].update(lay_i)
        del w
    for h in trainer:
        h.register(local[h.shard_idx], layout=lay[h.shard_idx])
    del local
    total = sum(t.nbytes for h in trainer for t in h.store.tensors().values())
    emit("model", config="llama3-8b", layers=NUM_LAYERS, dtype="bfloat16", bytes=total,
         trainer_tp=SRC_TP, rollout_tp=DST_TP)
    # host time of the planning each destination shard's pull starts with
    # (layouts from the manifests, then plan_shard), at this layout
    src_manifests = {h.shard_idx: h.store.build_manifest(with_checksums=False) for h in trainer}
    plan_s = {}
    for codec in ("raw", "int8"):
        t0 = time.perf_counter()
        plan = plan_shard(
            layout_from_manifests(src_manifests, SRC_TP),
            layout_from_manifests({0: shape_manifest(torch, meta_globals(torch, lay[0]), 0, DST_TP)[0]}, DST_TP),
            0, codec=codec,
        )
        plan_s[codec] = time.perf_counter() - t0
    emit("plan", seconds_per_dest_shard=plan_s, intervals_per_dest_shard=len(plan.intervals))

    def rollout(name, dc):
        hs = [hub.open("m", name, DST_TP, i, datacenter=dc) for i in range(DST_TP)]
        for h in hs:
            _, metas, lay_i = shape_manifest(torch, meta_globals(torch, lay[0]), h.shard_idx, DST_TP)
            h.register({n: torch.zeros_like(m, device=dev) for n, m in metas.items()}, layout=lay_i)
        return hs

    # roll-int8 pulls first in each step: while the trainer alone holds a
    # version it is the only source, so roll-int8 reshards from it (the
    # server prefers a same-layout source, and a finished roll-raw would be one)
    roll_i8 = rollout("roll-int8", "dc1")
    roll_raw = rollout("roll-raw", "dc0")
    names = [n for n, _ in shapes]
    steps = {}

    def step(label, fn):
        timed_step(torch, dev, hub, counters, total, steps, label, fn, path="phase 4, resharded")

    def trainer_global(name, roundtrip=None):
        """The trainer's tensor assembled from its TP-4 shards; with
        ``roundtrip``, each shard's carrying unit goes through it first."""
        gshape, _ = lay[0][name]
        out = torch.empty(gshape, dtype=torch.bfloat16, device=dev)
        for h in trainer:
            st = h.store
            part = st.get(name)
            if roundtrip is not None:
                u = st.units[st._unit_of[name]]
                dec = roundtrip(st._gather_unit(u), st.unit_dtype(u))
                off = 0 if not u.is_compact else next(o for n, o, _ in u.layout if n == name)
                part = dec[off : off + part.nbytes].view(torch.bfloat16).view(part.shape)
            _, offset = st.layouts[name]
            out[tuple(slice(o, o + d) for o, d in zip(offset, part.shape))] = part
        return out

    plain_int8 = Int8Codec(quantize=quantize_rows_plain)

    def int8_roundtrip(payload, dtype):
        return plain_int8.decode(plain_int8.encode(payload, dtype))

    def check_rollouts(version):
        worst = 0.0
        for name in names:
            want = trainer_global(name)
            want8 = trainer_global(name, int8_roundtrip)
            for i in range(DST_TP):
                ref = tp_shard({name: want}, i, DST_TP)[0][name]
                ref8 = tp_shard({name: want8}, i, DST_TP)[0][name]
                check(torch.equal(roll_raw[i].store.get(name), ref), f"v{version} roll-raw {i} {name} != trainer")
                got8 = roll_i8[i].store.get(name)
                check(torch.equal(got8, ref8), f"v{version} roll-int8 {i} {name} != plain int8 round trip")
                worst = max(worst, max_rel_err(torch, got8, ref))
            del want, want8
        check(worst < 0.01, f"v{version} roll-int8 max relative error {worst} >= 1%")
        for h in roll_raw + roll_i8:
            check(h.intervals_pulled > 0, f"{h.replica}/{h.shard_idx} pulled no interval (not resharded)")
        return worst

    for c in counters.values():
        c.reset()
    step("publish v0 (trainer TP-4)", lambda: run_group(trainer, lambda h: h.publish(0)))
    step("replicate roll-int8 (TP-4 -> TP-2, int8, dc1)",
         lambda: run_group(roll_i8, lambda h: h.replicate(0, timeout=600)))
    step("replicate roll-raw (TP-4 -> TP-2, raw, dc0)",
         lambda: run_group(roll_raw, lambda h: h.replicate(0, timeout=600)))
    launches_v0 = {k: c.value for k, c in counters.items()}
    err_v0 = check_rollouts(0)
    check(launches_v0 == {k: c.value for k, c in counters.items()}, "the checks launched a kernel")

    def perturb_and_publish():
        run_group(trainer, lambda h: h.unpublish())
        gp = torch.Generator(device=dev).manual_seed(SEED + 4)
        for h in trainer:
            for w in h.store.tensors().values():
                flat = w.view(-1)
                full = flat.numel() // 256 * 256
                rows = flat[:full].view(-1, 256)[::8]  # 1/8 of the 256-element rows, in place
                rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
        run_group(trainer, lambda h: h.publish(1))

    step("unpublish, perturb 1/8 rows, publish v1", perturb_and_publish)
    step("update roll-int8 (int8: delta collapses on a reshard)",
         lambda: run_group(roll_i8, lambda h: check(h.update("latest"), "roll-int8 not updated")))
    step("update roll-raw", lambda: run_group(roll_raw, lambda h: check(h.update("latest"), "roll-raw not updated")))
    launches = {k: c.value for k, c in counters.items()}  # the main path's launches, read now
    peak = torch.cuda.max_memory_allocated(dev)
    err_v1 = check_rollouts(1)
    ratios = {label: rec["wire_ratio"].get("vpc_up") for label, rec in steps.items() if "roll-int8" in label}
    for label, r in ratios.items():
        check(r is not None and r < 0.52, f"{label}: WAN wire ratio {r}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the resharded path")
    emit("reshard_result", launches=launches, max_memory_allocated=peak,
         roll_int8_max_rel_err={"v0": err_v0, "v1": err_v1}, int8_wire_ratio=ratios,
         intervals_pulled={f"{h.replica}/{h.shard_idx}": h.intervals_pulled for h in roll_i8 + roll_raw},
         server_stats={k: v for k, v in server.stats.items() if v})
    return dict(launches, step_seconds={label: rec["seconds"] for label, rec in steps.items()})


# -- phase 5: flash attention and llama3-8b serving at full width -------------

#: tolerances of the flash kernel against its plain version, as
#: tests/test_kernels.py: |got - want| <= tol + tol * |want|; f16 (not in
#: test_kernels.py's sweep) at 2e-3: the kernels compute in f32 and round
#: once, as the plain version does, and f16 rounds 8x finer than bf16
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}
#: tests/test_kernels.py's shapes (b, hq, hkv, sq, sk, d, causal, softcap)
KERNEL_SHAPES = [
    (2, 4, 2, 128, 128, 64, True, 0.0),
    (1, 8, 8, 256, 256, 128, True, 50.0),
    (2, 4, 1, 96, 160, 64, False, 0.0),
    (1, 2, 2, 384, 384, 256, True, 0.0),
    (1, 16, 4, 64, 64, 128, True, 0.0),
    (1, 2, 2, 200, 200, 64, True, 0.0),
]
#: head_dims the f32 route and the cuda_core backward take below 64 (the
#: reduced configs'), and f16: (b, hq, hkv, sq, sk, d, causal, softcap)
NARROW_SHAPES = [
    (8, 4, 4, 64, 64, 16, True, 0.0),  # launch.train's reduced llama3-8b
    (2, 8, 2, 77, 77, 16, True, 0.0),
    (2, 8, 2, 100, 160, 32, False, 0.0),
    (1, 8, 8, 96, 96, 32, True, 30.0),
]
#: GQA groups of 7 (yi-34b and deepseek-coder-33b: 56 query heads on 8 KV
#: heads) and 64 (MAX_GROUP), Sq and Sk off the tile edges:
#: (b, hq, hkv, sq, sk, d, kw)
GROUP_SHAPES = [
    (1, 56, 8, 129, 129, 128, dict(causal=True)),
    (1, 28, 4, 127, 200, 64, dict(causal=True, q_offset=60, kv_len=187)),
    (1, 64, 1, 65, 65, 128, dict(causal=True)),
    (1, 64, 2, 63, 63, 32, dict(causal=True, softcap=30.0)),
]
#: calls whose K and V hold NaN in the slots at and past kv_len (a dead
#: cache slot): no product may read them (b, hq, hkv, sq, sk, d, kw)
NAN_TAIL_SHAPES = [
    (2, 32, 8, 256, 400, 128, dict(causal=False, kv_len=300)),
    (1, 56, 8, 65, 577, 64, dict(causal=True, q_offset=500, kv_len=565)),
    (2, 8, 2, 100, 160, 32, dict(causal=False, kv_len=120)),
    (2, 32, 8, 1, 577, 128, dict(causal=True, q_offset=400, kv_len=401)),  # a decode step
]
#: sliding-window calls (gemma2's local layers) on every route that takes
#: them, K/V NaN past kv_len where ``nan``: (b, hq, hkv, sq, sk, d, kw)
WINDOW_SHAPES = [
    (2, 8, 4, 300, 300, 256, dict(causal=True, window=8)),  # a window inside one tile, head_dim 256
    (2, 8, 4, 300, 300, 128, dict(causal=True, window=8)),
    (2, 8, 4, 400, 400, 128, dict(causal=True, window=100, softcap=50.0)),
    (1, 8, 4, 700, 700, 256, dict(causal=True, window=100, softcap=50.0)),
    (1, 8, 4, 600, 600, 128, dict(causal=True, window=4096)),  # wider than the keys
    (1, 8, 4, 4200, 4200, 128, dict(causal=True, window=4096)),  # gemma2's window, biting past 4096
    (1, 8, 4, 64, 800, 128, dict(causal=True, q_offset=600, kv_len=664, window=100, nan=True)),
    (2, 8, 4, 1, 4700, 256, dict(causal=True, q_offset=4671, kv_len=4672, window=4096, softcap=50.0, nan=True)),
    (2, 8, 4, 4, 800, 256, dict(causal=True, q_offset=700, kv_len=704, window=8, nan=True)),  # a decode chunk
    (1, 56, 8, 129, 400, 128, dict(causal=True, q_offset=200, kv_len=329, window=64, nan=True)),  # G 7
    (1, 8, 4, 200, 300, 64, dict(causal=False, kv_len=250, window=64, nan=True)),
]
#: the tensor-core forward at head_dim 256 (gemma2's prefill and training
#: forward, gemma2's 8/4 heads): windows of 8, 64, 100 and 4096, softcap 50,
#: G 2 and 7, kv_len < Sk with NaN past it, q_offset > 0; each with and
#: without the log-sum-exp: (b, hq, hkv, sq, sk, kw)
TC256_SHAPES = [
    (2, 8, 4, 300, 300, dict(causal=True, softcap=50.0)),
    (1, 8, 4, 600, 600, dict(causal=True, window=8, softcap=50.0)),
    (1, 8, 4, 400, 400, dict(causal=True, window=64)),
    (1, 8, 4, 700, 700, dict(causal=True, window=100, softcap=50.0)),
    (1, 8, 4, 4200, 4200, dict(causal=True, window=4096, softcap=50.0)),  # gemma2's window, biting past 4096
    (1, 56, 8, 129, 400, dict(causal=True, q_offset=200, kv_len=329, window=64, nan=True)),  # G 7
    (2, 8, 4, 130, 500, dict(causal=False, kv_len=450, nan=True)),
    (1, 8, 4, 77, 300, dict(causal=True, q_offset=200, kv_len=277, window=100, softcap=50.0, nan=True)),
    # the wide plan's 128-row item edges, a cached prefix, NaN past kv_len
    *((2, 8, 4, sq, sq + 70, dict(causal=True, q_offset=40, kv_len=sq + 40, softcap=50.0, nan=True))
      for sq in (127, 128, 129, 255, 256, 257, 511, 512, 513)),
    (2, 64, 64, 257, 257, dict(causal=True, window=100, softcap=50.0)),  # heads of their own K/V: the head-major list
]
SERVE_BATCH, PROMPT_LEN, GEN_LEN = 16, 512, 64
BF16_TFLOPS = H100.peak_flops_bf16  # dense bf16 and f16 (the tensor cores' peak)


def sdpa_backend(torch, call):
    """The first of SDPA's backends, in PyTorch's order of preference,
    that takes ``call`` (which runs SDPA): its name, to time it under."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                call()
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise SmokeFailure("no SDPA backend takes the call")


def nan_tail(qkv, kv_len: int):
    """q, k, v with NaN in K and V at and past ``kv_len``, and beside them
    k and v with zeros there: what the plain version reads (0 x NaN is NaN
    in its products; the kernels must never read the dead slots)."""
    q, k, v = qkv
    kz, vz = k.clone(), v.clone()
    kz[:, :, kv_len:] = 0
    vz[:, :, kv_len:] = 0
    k[:, :, kv_len:] = float("nan")
    v[:, :, kv_len:] = float("nan")
    return q, k, v, kz, vz


def live_pairs(sq: int, kv_len: int, causal: bool, q_offset: int, window: int = 0) -> int:
    """(query, key) pairs a call must score: what this run's data needs
    (the keys row i at position q_offset + i sees: below kv_len, causal
    up to itself, within the window)."""
    total = 0
    for i in range(sq):
        pos = q_offset + i
        hi = min(kv_len, pos + 1) if causal else kv_len
        lo = max(0, pos - window + 1) if window > 0 else 0
        total += max(0, hi - lo)
    return total


def live_keys(sq: int, kv_len: int, causal: bool, q_offset: int, window: int = 0) -> int:
    """Keys some query row sees: the K and V rows a call must read."""
    hi = min(kv_len, q_offset + sq) if causal else kv_len
    return hi - (max(0, q_offset - window + 1) if window > 0 else 0)


def flash_bound_ms(q, k, kv_len: int, causal: bool, q_offset: int, bw: float, peak: float = BF16_TFLOPS,
                   window: int = 0):
    """The larger of the FLOP time (4 D flops a live pair a query head, at
    ``peak``: the bf16 tensor-core peak unless given) and the byte time (q
    and o once, the live keys of k and v once, at the memory rate)."""
    b, hq, sq, d = q.shape
    hkv = k.shape[1]
    flops = 4 * b * hq * d * live_pairs(sq, kv_len, causal, q_offset, window)
    nbytes = 2 * q.numel() * q.element_size() + 2 * b * hkv * live_keys(sq, kv_len, causal, q_offset, window) * d * k.element_size()
    t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


def flash_checks(torch, dev, bw: float) -> dict:
    """Flash attention against its plain version on every route: the
    serving path's prefill (tensor-core route) and decode step at the split
    edges (decode route), a long and an offset prefill, decode at a
    4096-slot cache and tests/test_kernels.py's shapes in f32 and bf16; each
    call must bump its route's counter. Then, at the prefill and decode
    shapes, the route's kernel timed beside the f32 route's kernel on the same
    inputs (the f32 route, called directly), the plain version and
    scaled_dot_product_attention, each with the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 20)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return [torch.randn(s, generator=g, device=dev, dtype=torch.float32).to(dtype)
                for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]

    bf16 = torch.bfloat16
    max_len = PROMPT_LEN + GEN_LEN
    prefill = qkv(SERVE_BATCH, 32, 8, PROMPT_LEN, PROMPT_LEN, 128, bf16)
    decode = qkv(SERVE_BATCH, 32, 8, 1, max_len, 128, bf16)
    cases = {"prefill [16,32/8,512,128] bf16 causal": (prefill, dict(causal=True), "bfloat16")}
    for kv_len in (1, 17, 63, 64, 65, 128, 129, 513, 576):
        cases[f"decode [16,32/8,1,128] vs cache 576, kv_len {kv_len}"] = (
            decode, dict(causal=True, q_offset=kv_len - 1, kv_len=kv_len), "bfloat16")
    decode32 = [t.float() for t in decode]
    for kv_len in (1, 65, 576):
        cases[f"decode [16,32/8,1,128] f32 vs cache 576, kv_len {kv_len}"] = (
            decode32, dict(causal=True, q_offset=kv_len - 1, kv_len=kv_len), "float32")
    long_cache = qkv(2, 32, 8, 1, 4096, 128, bf16)
    cases["decode [2,32/8,1,128] vs cache 4096, kv_len 4096"] = (
        long_cache, dict(causal=True, q_offset=4095, kv_len=4096), "bfloat16")
    cases["decode chunk [2,32/8,16,128] at 500 vs cache 576"] = (
        qkv(2, 32, 8, 16, max_len, 128, bf16), dict(causal=True, q_offset=500, kv_len=516), "bfloat16")
    cases["long [1,32/8,4096,128] bf16 causal"] = (qkv(1, 32, 8, 4096, 4096, 128, bf16), dict(causal=True), "bfloat16")
    cases["offset prefill [2,32/8,64,128] at 300 vs cache 576"] = (
        qkv(2, 32, 8, 64, max_len, 128, bf16), dict(causal=True, q_offset=300, kv_len=364), "bfloat16")
    for dtype, name in ((torch.float32, "float32"), (bf16, "bfloat16"), (torch.float16, "float16")):
        for b, hq, hkv, sq, sk, d, causal, cap in KERNEL_SHAPES + NARROW_SHAPES:
            cases[f"test_kernels [{b},{hq}/{hkv},{sq}x{sk},{d}] causal={causal} softcap={cap} {name}"] = (
                qkv(b, hq, hkv, sq, sk, d, dtype), dict(causal=causal, softcap=cap), name)
        for b, hq, hkv, sq, sk, d, kw in GROUP_SHAPES:
            cases[f"G {hq // hkv} [{b},{hq}/{hkv},{sq}x{sk},{d}] {kw} {name}"] = (
                qkv(b, hq, hkv, sq, sk, d, dtype), dict(kw), name)
        for b, hq, hkv, sq, sk, d, kw in NAN_TAIL_SHAPES:
            cases[f"NaN past kv_len [{b},{hq}/{hkv},{sq}x{sk},{d}] {kw} {name}"] = (
                nan_tail(qkv(b, hq, hkv, sq, sk, d, dtype), kw["kv_len"]), dict(kw), name)
    worst_abs, worst_ratio = 0.0, 0.0
    worst_route = {r: 0.0 for r in fa.ROUTES}
    for label, ((q, k, v, *zeroed), kw, dname) in cases.items():
        route = fa._route(q, k)
        before = fa.LAUNCHES.value, fa.ROUTE_LAUNCHES[route].value
        got = fa.flash_attention(q, k, v, **kw).float()
        check((fa.LAUNCHES.value, fa.ROUTE_LAUNCHES[route].value) == (before[0] + 1, before[1] + 1),
              f"flash kernel not launched on its route ({route}) on {label}")
        want = fa.attention_plain(q, *(zeroed or (k, v)), **kw).float()
        torch.cuda.synchronize()
        tol = FLASH_TOL[dname]
        diff = (got - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())  # <= 1 passes
        worst_abs = max(worst_abs, float(diff.max()))
        worst_ratio = max(worst_ratio, ratio)
        worst_route[route] = max(worst_route[route], ratio)
        emit("flash_check", case=label, route=route, max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio)
        check(ratio <= 1.0 and torch.isfinite(got).all().item(), f"flash kernel != plain version on {label} ({route})")
    del cases, got, want, diff, decode32, long_cache
    torch.cuda.empty_cache()

    # the sliding window on every route that takes the call, each named
    for b, hq, hkv, sq, sk, d, kw in WINDOW_SHAPES:
        kw = dict(kw)
        nan = kw.pop("nan", False)
        for dtype, dname in ((torch.float32, "float32"), (bf16, "bfloat16")):
            q, k, v = qkv(b, hq, hkv, sq, sk, d, dtype)
            k_want, v_want = k, v
            if nan:
                q, k, v, k_want, v_want = nan_tail((q, k, v), kw["kv_len"])
            want = fa.attention_plain(q, k_want, v_want, **kw).float()
            takes = {"f32": True, "tensor_core": dtype == bf16 and d in fa.TC_HEAD_DIMS,
                     "decode": sq * (hq // hkv) <= fa.DECODE_ROWS and d in fa.HEAD_DIMS}
            for route in (r for r, ok in takes.items() if ok):
                label = f"window [{b},{hq}/{hkv},{sq}x{sk},{d}] {kw}{' NaN past kv_len' if nan else ''} {dname}"
                before = fa.ROUTE_LAUNCHES[route].value
                got = fa.launch_route(route, q, k, v, **kw).float()
                check(fa.ROUTE_LAUNCHES[route].value == before + 1, f"{route} not launched on {label}")
                torch.cuda.synchronize()
                tol = FLASH_TOL[dname]
                diff = (got - want).abs()
                ratio = float((diff / (tol + tol * want.abs())).max())
                worst_abs = max(worst_abs, float(diff.max()))
                worst_ratio = max(worst_ratio, ratio)
                worst_route[route] = max(worst_route[route], ratio)
                emit("flash_check", case=label, route=route, max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio)
                check(ratio <= 1.0 and torch.isfinite(got).all().item(), f"{route} != plain version on {label}")
            del q, k, v, k_want, v_want, want, got, diff
    torch.cuda.empty_cache()

    # the tensor-core forward at head_dim 256, named, with and without the
    # log-sum-exp (the serving and the training call)
    for b, hq, hkv, sq, sk, kw in TC256_SHAPES:
        kw = dict(kw)
        nan = kw.pop("nan", False)
        q, k, v = qkv(b, hq, hkv, sq, sk, 256, bf16)
        k_want, v_want = k, v
        if nan:
            q, k, v, k_want, v_want = nan_tail((q, k, v), kw["kv_len"])
        label = f"tensor_core head_dim 256 [{b},{hq}/{hkv},{sq}x{sk}] {kw}{' NaN past kv_len' if nan else ''}"
        want = fa.attention_plain(q, k_want, v_want, **kw).float()
        before = fa.ROUTE_LAUNCHES["tensor_core"].value
        got = fa.launch_route("tensor_core", q, k, v, **kw)
        out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, **kw)
        check(fa.ROUTE_LAUNCHES["tensor_core"].value == before + 2, f"tensor_core not launched on {label}")
        lse_want = fa.attention_lse_plain(q, k_want, **kw)
        torch.cuda.synchronize()
        tol = FLASH_TOL["bfloat16"]
        diff = (got.float() - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())
        lse_ratio = float(((lse - lse_want).abs() / (2e-5 + 2e-5 * lse_want.abs())).max())
        worst_abs = max(worst_abs, float(diff.max()))
        worst_ratio = max(worst_ratio, ratio)
        worst_route["tensor_core"] = max(worst_route["tensor_core"], ratio)
        emit("flash_check", case=label, route="tensor_core", max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio,
             lse_err_over_tol=lse_ratio, same_with_lse=bool(torch.equal(out, got)))
        check(ratio <= 1.0 and torch.isfinite(got).all().item(), f"tensor_core != plain version on {label}")
        check(lse_ratio <= 1.0 and torch.equal(out, got), f"tensor_core lse != logsumexp of the plain scores on {label}")
        del q, k, v, k_want, v_want, want, got, out, lse, lse_want, diff
    torch.cuda.empty_cache()
    softcap_checks(torch, dev, fa)

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    # timings at the serving path's shapes (the decode step at a full cache):
    # the route's kernel, the f32 route's kernel on the same inputs,
    # the plain version and SDPA
    times = {}
    for label, route, (q, k, v), kw, sdpa in (
        ("prefill", "tensor_core", prefill, dict(causal=True), lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        ("decode", "decode", decode, dict(causal=True, q_offset=max_len - 1, kv_len=max_len),
         lambda q, k, v: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)),
    ):
        check(fa._route(q, k) == route, f"{label} shape routed to {fa._route(q, k)}")
        calls = {
            "kernel": lambda: fa.flash_attention(q, k, v, **kw),
            "f32_route": lambda: fa.launch_route("f32", q, k, v, **kw),
            "plain": lambda: fa.attention_plain(q, k, v, **kw),
            "sdpa": lambda: sdpa(q, k, v),
        }
        # the device's time a call with the L2 cache cold (the serving path's
        # case), in turns kernel, f32 route, plain, SDPA, kernel; beside it the
        # kernels' device time with the inputs warm in L2 (profiler) and the
        # CUDA-event time of one eager call, host launch included
        cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        again = cold_ms(torch, calls["kernel"], flush)
        warm = {n: device_ms(torch, f, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        call_ms = {n: time_ms(torch, f, reps=10 if n == "plain" else 30) for n, f in calls.items()}
        out = calls["kernel"]().float()
        lib_err = float((calls["sdpa"]().float() - out).abs().max())
        f32_err = float((calls["f32_route"]().float() - out).abs().max())
        bound, by, flops, nbytes = flash_bound_ms(q, k, kw.get("kv_len", k.shape[2]), True, kw.get("q_offset", 0), bw)
        ms = cold["kernel"]
        times[label] = dict(route=route, shape=f"q {list(q.shape)}, k/v {list(k.shape)} bf16", ms=ms, ms_again=again,
                            f32_route_ms=cold["f32_route"], plain_ms=cold["plain"], sdpa_ms=cold["sdpa"],
                            warm_device_ms=warm, call_ms=call_ms, speedup_over_f32_route=cold["f32_route"] / ms,
                            sdpa_over_kernel=cold["sdpa"] / ms,
                            sdpa_max_abs_diff=lib_err, f32_route_max_abs_diff=f32_err, bound_ms=bound, bound_by=by,
                            flops=flops, bytes=nbytes, achieved_TFLOPs=flops / (ms * 1e-3) / 1e12,
                            achieved_GBps=nbytes / (ms * 1e-3) / 1e9)
    emit("flash_times", **times)
    pre, dec = times["prefill"], times["decode"]
    del prefill, decode
    torch.cuda.empty_cache()
    gemma2 = gemma2_attention_times(torch, fa, qkv, flush, bw)
    del flush
    torch.cuda.empty_cache()
    csrc = "src/repro_torch/kernels/csrc/"
    routes = {
        "tensor_core": dict(source=csrc + "flash_attention_tc.cu", timed_shape=pre["shape"] + " (prefill, causal)",
                            ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
                            bound_by=pre["bound_by"], library_ms=pre["sdpa_ms"], err_over_tol=worst_route["tensor_core"]),
        "decode": dict(source=csrc + "flash_decode.cu", timed_shape=dec["shape"] + " (decode step, kv_len 576)",
                       ms=dec["ms"], plain_ms=dec["plain_ms"], bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                       library_ms=dec["sdpa_ms"], err_over_tol=worst_route["decode"]),
        # its own times (the f32 training shape at the f32 peak) come from
        # phase 2's backward checks (main); the bf16 serving inputs' beside
        "f32": dict(source=csrc + "flash_attention.cu", err_over_tol=worst_route["f32"],
                    on_bf16_serving_inputs=dict(prefill_ms=pre["f32_route_ms"], decode_ms=dec["f32_route_ms"],
                                                prefill_bound_ms_bf16_peak=pre["bound_ms"])),
    }
    routes["tensor_core"]["gemma2_prefill"] = gemma2["prefill"]
    routes["decode"]["gemma2_decode"] = gemma2["decode"]
    return {
        "flash_attention": dict(
            name="flash_attention", route="cuda",
            source=csrc + "flash_attention_tc.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:96",
            max_abs_err=worst_abs, err_over_tol=worst_ratio,
            ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"], bound_by=pre["bound_by"],
            library_ms=pre["sdpa_ms"], timed_shape=pre["shape"] + " (prefill, causal, tensor_core route)",
            routes=routes, counter=fa.LAUNCHES,
        ),
    }


#: the softcapped score's agreement with the backward's recomputation
#: (tanhf), as a share of c
SOFTCAP_TOL = 1e-6


def softcap_checks(torch, dev, fa) -> None:
    """The wide plans' softcap (ex2.approx, rcp.approx) on the card, read
    from the lse of rows that meet one key each (window 1; q and k at head
    dim 256 with one nonzero element, so the dot is exact and the scaled
    score is a bf16 sweep through +-12 c): against c tanh(x / c) in double
    and in f32 on the card (what the backward recomputes), at c = 50 and 30."""
    n = 8192
    for c in (50.0, 30.0):
        x = torch.linspace(-12 * c, 12 * c, n, device=dev).to(torch.bfloat16)
        q = torch.zeros((1, 1, n, 256), device=dev, dtype=torch.bfloat16)
        k = torch.zeros_like(q)
        q[0, 0, :, 0] = x
        k[0, 0, :, 0] = 16.0
        _, lse = fa.launch_route("tensor_core", q, k, k, causal=True, window=1, softcap=c, with_lse=True)
        got, xd = lse[0, 0].double(), x.double()
        err64 = (got - c * torch.tanh(xd / c)).abs()
        err32 = (got - (c * torch.tanh(x.float() / c)).double()).abs()
        worst = int(err64.argmax())
        emit("flash_softcap_check", softcap=c, samples=n, max_err_vs_tanh_f64=float(err64.max()),
             max_err_vs_tanh_f32_on_card=float(err32.max()), over_c_f64=float(err64.max()) / c,
             over_c_f32=float(err32.max()) / c, worst_at_score=float(xd[worst]), tol=f"{SOFTCAP_TOL} c")
        check(float(err64.max()) <= SOFTCAP_TOL * c and float(err32.max()) <= SOFTCAP_TOL * c,
              f"the tensor-core softcap strays from c tanh(x / c) at c = {c}")


#: gemma2-2b's attention at phase 9's serving shape: 4 requests of 4608
#: prompt tokens (+ 64 new), 8 query and 4 KV heads of 256, bf16, softcap 50
GEMMA2_B, GEMMA2_PROMPT, GEMMA2_GEN, GEMMA2_WINDOW = 4, 4608, 64, 4096


def gemma2_attention_times(torch, fa, qkv, flush, bw) -> dict:
    """gemma2's prefill attention on the tensor_core route (beside it the
    f32 route's kernel, which took it before head_dim 256 had a
    tensor-core forward) and a decode step on the decode route, each with
    the window of its local layers (4096) and without (its global layers):
    the kernel (L2 cold), the plain version and SDPA on the same shape
    without the softcap (no PyTorch call has a tanh softcap, so SDPA
    computes a lighter function; K/V repeated to the query heads outside
    the timing, the window as a boolean mask; the backend named), beside
    the bound (bf16 inputs: the bf16 peak; and the f32 FMA peak the f32
    route computes at). Like for like at the prefill, the kernel also
    without the softcap (``ms_softcap_0``) and, on the global case, SDPA
    with ``is_causal`` and no mask (``library_ms_is_causal``), which lets
    cuDNN skip the masked tiles."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    out = {}
    cap = 50.0
    for label, sq, route in (("prefill", GEMMA2_PROMPT, "tensor_core"), ("decode", 1, "decode")):
        kv_len = GEMMA2_PROMPT + (GEMMA2_GEN if label == "decode" else 0)
        q_offset = kv_len - sq
        q, k, v = qkv(GEMMA2_B, 8, 4, sq, kv_len, 256, torch.bfloat16)
        check(fa._route(q, k) == route, f"gemma2 {label} shape routed to {fa._route(q, k)}")
        k8, v8 = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
        for window in (GEMMA2_WINDOW, 0):
            kw = dict(causal=True, softcap=cap, q_offset=q_offset, kv_len=kv_len, window=window)
            qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
            kpos = torch.arange(kv_len, device=q.device)[None, :]
            mask = (kpos <= qpos) & ((kpos > qpos - window) if window else True)
            sdpa = lambda: F.scaled_dot_product_attention(q, k8, v8, attn_mask=mask)  # noqa: E731
            backend = sdpa_backend(torch, sdpa)
            calls = {
                "kernel": lambda: fa.flash_attention(q, k, v, **kw),
                "plain": lambda: fa.attention_plain(q, k, v, **kw),
            }
            if label == "prefill":  # the route that took it before head_dim 256 had a tensor-core forward
                calls["f32_route"] = lambda: fa.launch_route("f32", q, k, v, **kw)
                # like for like with SDPA: the kernel without the softcap
                calls["kernel_softcap_0"] = lambda: fa.flash_attention(q, k, v, **dict(kw, softcap=0.0))
            cold = {n: cold_ms(torch, f, flush, reps=3 if n in ("plain", "f32_route") else 10) for n, f in calls.items()}
            with sdpa_kernel([backend]):
                cold["sdpa_no_softcap"] = cold_ms(torch, sdpa, flush, reps=10)
            causal_sdpa = {}
            if label == "prefill" and not window:  # causal without a mask: cuDNN skips the masked tiles
                def sdpa_causal():
                    return F.scaled_dot_product_attention(q, k8, v8, is_causal=True)

                causal_backend = sdpa_backend(torch, sdpa_causal)
                with sdpa_kernel([causal_backend]):
                    causal_sdpa = dict(library_ms_is_causal=cold_ms(torch, sdpa_causal, flush, reps=10),
                                       library_backend_is_causal=str(causal_backend))
            got, want = calls["kernel"]().float(), calls["plain"]().float()
            err = float((got - want).abs().max())
            ratio = float(((got - want).abs() / (FLASH_TOL["bfloat16"] * (1 + want.abs()))).max())
            bound, by, flops, nbytes = flash_bound_ms(q, k, kv_len, True, q_offset, bw, window=window)
            f32_bound = max(flops / F32_TFLOPS * 1e3, nbytes / bw * 1e3)
            name = f"{label} window {window}" if window else f"{label} global"
            out.setdefault(label, {})[name] = dict(
                route=route, shape=f"q {list(q.shape)}, k/v {list(k.shape)} bf16 causal softcap {cap}",
                ms=cold["kernel"], plain_ms=cold["plain"], library_ms=cold["sdpa_no_softcap"],
                f32_route_ms=cold.get("f32_route"), library_backend=str(backend),
                library_note="SDPA without the softcap (a lighter function), K/V repeated to 8 heads",
                ms_softcap_0=cold.get("kernel_softcap_0"), **causal_sdpa,
                bound_ms=bound, bound_by=by, bound_ms_f32_peak=f32_bound, flops=flops, bytes=nbytes,
                max_abs_err_vs_plain=err, err_over_tol=ratio)
            emit("flash_gemma2_times", case=name, **out[label][name])
            check(ratio <= 1.0, f"gemma2 {name}: kernel != plain version")
            del got, want
        del q, k, v, k8, v8, mask
        torch.cuda.empty_cache()
    return out


# -- phase 2: flash attention's backward --------------------------------------

#: the GRPO step's attention at phase 6's batch: 4 prompts x 4 responses of
#: 512 + 64 tokens, llama3-8b's 32/8 heads of 128
TRAIN_B, TRAIN_S = 16, 576
F32_TFLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def bwd_bound_ms(q, k, kv_len: int, causal: bool, q_offset: int, bw: float, peak: float, window: int = 0, v=None):
    """The larger of the FLOP time (five products a live pair a query head:
    S, dQ and dK of 2 D flops, dP and dV of 2 Dv, D q/k's width and Dv v's,
    k's unless ``v`` is given) and the byte time (q, dQ, k, dK, v, dV, o,
    dO once each and the lse)."""
    b, hq, sq, d = q.shape
    v = k if v is None else v
    dv, es = v.shape[3], q.element_size()
    flops = 2 * (3 * d + 2 * dv) * b * hq * live_pairs(sq, kv_len, causal, q_offset, window)
    nbytes = 2 * es * (q.numel() + k.numel() + v.numel() + b * hq * sq * dv) + 4 * b * hq * sq
    t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


#: elements a gradient comparison takes at a time (f32 temporaries of
#: 512 MB: a dbrx layer's expert stack is 1.06 G elements)
GRAD_SLICE = 1 << 27


def _slices(got, want):
    a, b = got.reshape(-1), want.reshape(-1)
    for i in range(0, a.numel(), GRAD_SLICE):
        yield a[i : i + GRAD_SLICE].float(), b[i : i + GRAD_SLICE].float()


def grad_err(torch, got, want) -> float:
    """max |got - want| over max |want|: the norm the backward's gradients
    are held to, tests/test_kernels.py's tolerance taken relative to each
    gradient's largest value (a gradient has no scale of its own). Taken a
    slice at a time, so no f32 copy of a whole gradient is made."""
    diff = scale = 0.0
    for a, b in _slices(got, want):
        diff, scale = max(diff, float((a - b).abs().max())), max(scale, float(b.abs().max()))
    return diff / max(scale, 1e-30)


def rel_l2(torch, got, want) -> float:
    """|got - want| over |want| in the L2 norm (sums of squares a slice at
    a time)."""
    num = den = 0.0
    for a, b in _slices(got, want):
        num, den = num + float((a - b).square().sum()), den + float(b.square().sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def flash_backward_checks(torch, dev, bw: float) -> dict:
    """The backward routes through the autograd Function against autograd
    through the plain attention: ``tensor_core`` (csrc/flash_attention_bwd_tc.cu)
    on the bf16 cases and ``cuda_core`` (csrc/flash_attention_bwd.cu) on the
    f32 and f16 cases and the narrow heads (head_dim 16/32), at the GRPO
    step's shape and at the edges (S = 77, G 1/4/8, kv_len < Sk, q_offset
    > 0, softcap, head_dim 64), with windows of 8, 64, 100 and 4096 at
    head_dim 64/128/256 and at gemma2's head_dim 256, every case run twice
    for bit-equal gradients; gemma2's windowed backward timed
    (gemma2_backward_times) and the head_dim-256 kernels at the shapes the
    main path launches them (gemma2_launch_shape_times); the log-sum-exp of the tensor_core and f32 forwards against
    logsumexp of the plain scores; then, at the training shape, both
    routes timed on the same bf16 inputs beside the plain backward and
    SDPA's, the cuda_core route at the f32 training shape beside SDPA's f32
    backward, and the f32 route's forward beside its plain version and
    SDPA (row 5c)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def qkv(b, hq, hkv, sq, sk, d, dtype):
        return [rand(s, dtype) for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]

    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    cases = {}
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32"), (f16, "float16")):
        cases[f"train [16,32/8,576,128] causal {name}"] = (TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, dtype, {})
        cases[f"S 77 [2,32/8,77,128] causal {name}"] = (2, 32, 8, 77, 77, 128, dtype, {})
        for hq, hkv in ((8, 8), (16, 4), (32, 4)):
            cases[f"G {hq // hkv} [2,{hq}/{hkv},200,128] causal {name}"] = (2, hq, hkv, 200, 200, 128, dtype, {})
        cases[f"kv_len 300 of 400 [2,32/8,256x400,128] not causal {name}"] = (
            2, 32, 8, 256, 400, 128, dtype, dict(causal=False, kv_len=300))
        cases[f"q_offset 200 [2,32/8,64x320,128] kv_len 264 {name}"] = (
            2, 32, 8, 64, 320, 128, dtype, dict(q_offset=200, kv_len=264))
        cases[f"softcap 50 [2,16/8,256,128] causal {name}"] = (2, 16, 8, 256, 256, 128, dtype, dict(softcap=50.0))
        cases[f"head_dim 64 [2,32/8,300,64] causal {name}"] = (2, 32, 8, 300, 300, 64, dtype, {})
        for b, hq, hkv, sq, sk, d, kw in GROUP_SHAPES:
            cases[f"G {hq // hkv} [{b},{hq}/{hkv},{sq}x{sk},{d}] {kw} {name}"] = (b, hq, hkv, sq, sk, d, dtype, kw)
        for b, hq, hkv, sq, sk, d, kw in NAN_TAIL_SHAPES:
            cases[f"NaN past kv_len [{b},{hq}/{hkv},{sq}x{sk},{d}] {kw} {name}"] = (
                b, hq, hkv, sq, sk, d, dtype, dict(kw, nan_tail=True))
    for dtype, name in ((f32, "float32"), (bf16, "bfloat16"), (f16, "float16")):
        for b, hq, hkv, sq, sk, d, causal, cap in NARROW_SHAPES:
            cases[f"head_dim {d} [{b},{hq}/{hkv},{sq}x{sk}] causal={causal} softcap={cap} {name}"] = (
                b, hq, hkv, sq, sk, d, dtype, dict(causal=causal, softcap=cap))
        cases[f"head_dim 32 q_offset 200 [1,8/2,64x300] kv_len 264 {name}"] = (
            1, 8, 2, 64, 300, 32, dtype, dict(q_offset=200, kv_len=264))
        # the window on both backward routes (bf16 at head_dim 64/128/256 on
        # tensor_core, the rest on cuda_core): launch.train's reduced gemma2,
        # windows of 8, 64, 100 and 4096 inside a tile and across tiles, with
        # softcap, offset, NaN past kv_len, G 7 and without causality
        cases[f"window 8 softcap 50 [8,4/4,64x64,16] (reduced gemma2) {name}"] = (
            8, 4, 4, 64, 64, 16, dtype, dict(window=8, softcap=50.0))
        cases[f"window 8 [2,8/2,200x200,32] {name}"] = (2, 8, 2, 200, 200, 32, dtype, dict(window=8))
        for d in (64, 128, 256):
            cases[f"window 8 [2,8/4,300x300,{d}] {name}"] = (2, 8, 4, 300, 300, d, dtype, dict(window=8))
            cases[f"window 100 softcap 50 [2,8/4,400x400,{d}] {name}"] = (
                2, 8, 4, 400, 400, d, dtype, dict(window=100, softcap=50.0))
            cases[f"window 64 q_offset 200 kv_len 329 [1,56/8,129x400,{d}] {name}"] = (
                1, 56, 8, 129, 400, d, dtype, dict(q_offset=200, kv_len=329, window=64, nan_tail=True))
            cases[f"window 64 not causal kv_len 250 [1,8/4,200x300,{d}] {name}"] = (
                1, 8, 4, 200, 300, d, dtype, dict(causal=False, kv_len=250, window=64, nan_tail=True))
            cases[f"window 4096 [1,8/4,600x600,{d}] {name}"] = (1, 8, 4, 600, 600, d, dtype, dict(window=4096))
        # head_dim 256 (gemma2: 8/4 heads, softcap 50), window 4096 biting
        # past 4096 keys
        cases[f"head_dim 256 softcap 50 [2,8/4,300x300] {name}"] = (2, 8, 4, 300, 300, 256, dtype, dict(softcap=50.0))
        cases[f"head_dim 256 G 7 [1,56/8,129x129] {name}"] = (1, 56, 8, 129, 129, 256, dtype, {})
        cases[f"head_dim 256 q_offset 200 kv_len 264 [2,8/4,64x320] {name}"] = (
            2, 8, 4, 64, 320, 256, dtype, dict(q_offset=200, kv_len=264, nan_tail=True))
        cases[f"window 4096 softcap 50 [1,8/4,4200x4200,256] {name}"] = (
            1, 8, 4, 4200, 4200, 256, dtype, dict(window=4096, softcap=50.0))
    worst = {e: 0.0 for r in fa.BWD_KERNELS for e in (r, r + "_256")}
    worst_abs = dict(worst)
    for label, (b, hq, hkv, sq, sk, d, dtype, kw) in cases.items():
        kw = dict(dict(causal=True), **kw)
        q, k, v = qkv(b, hq, hkv, sq, sk, d, dtype)
        kz, vz = k, v  # what the plain version reads
        if kw.pop("nan_tail", False):
            q, k, v, kz, vz = nan_tail((q, k, v), kw["kv_len"])
        dout = rand(q.shape, dtype)
        route, bwd_route = fa._route(q, k, grad=True), fa._bwd_route(q)

        def grads():
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
            r_before = fa.ROUTE_LAUNCHES[route].value
            got = torch.autograd.grad(fa.flash_attention(*leaves, **kw), leaves, dout)
            want = {f"{bwd_route}/{n}": 1 for n in fa.bwd_kernels(d)}
            check({n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == {n: want.get(n, 0) for n in before}
                  and fa.ROUTE_LAUNCHES[route].value == r_before + 1, f"backward kernels not launched on {label}")
            return got

        got = grads()
        again = grads()
        ref = [t.clone().requires_grad_() for t in (q, kz, vz)]
        want = torch.autograd.grad(fa.attention_plain(*ref, **kw), ref, dout)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dtype).split(".")[1]]
        errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        finite = all(bool(torch.isfinite(a).all()) for a in got)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        e = bwd_route + ("_256" if "dkdv_dq" in fa.bwd_kernels(d) else "")
        worst[e] = max(worst[e], max(errs.values()) / tol)
        worst_abs[e] = max(worst_abs[e], max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)))
        emit("flash_bwd_check", case=label, forward_route=route, backward_route=bwd_route, rel_err=errs, tol=tol,
             finite=finite, bit_equal_rerun=same)
        check(finite and max(errs.values()) <= tol, f"backward kernels != autograd of the plain version on {label}")
        check(same, f"two runs of the {bwd_route} backward differ on {label}")
        del q, k, v, kz, vz, dout, got, again, ref, want
    torch.cuda.empty_cache()

    # the log-sum-exp the forwards write for the backward
    lse_worst = 0.0
    for route, dtype in (("tensor_core", bf16), ("f32", f32), ("f32", bf16), ("f32", f16)):
        for b, hq, hkv, sq, sk, d, kw in ((TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, dict(causal=True)),
                                          (2, 32, 8, 77, 300, 64, dict(causal=True, q_offset=200, kv_len=277)),
                                          (2, 16, 8, 256, 256, 128, dict(causal=False, softcap=50.0, kv_len=200)),
                                          (8, 4, 4, 64, 64, 16, dict(causal=True))):
            if route == "tensor_core" and d not in fa.TC_HEAD_DIMS:
                continue
            q, k, v = qkv(b, hq, hkv, sq, sk, d, dtype)
            out, lse = fa.launch_route(route, q, k, v, with_lse=True, **kw)
            want = fa.attention_lse_plain(q, k, **kw)
            err = float(((lse - want).abs() / (2e-5 + 2e-5 * want.abs())).max())
            lse_worst = max(lse_worst, err)
            emit("flash_lse_check", route=route, dtype=str(dtype), shape=[b, hq, hkv, sq, sk, d], kw=kw,
                 max_abs_err=float((lse - want).abs().max()), err_over_tol=err)
            check(err <= 1.0 and torch.equal(out, fa.launch_route(route, q, k, v, **kw)),
                  f"lse of the {route} forward != logsumexp of the plain scores")
    del q, k, v, out, lse, want
    torch.cuda.empty_cache()

    # timings at the training shape (bf16): both backward routes on the same
    # inputs, the plain backward and SDPA's backward (autograd through
    # scaled_dot_product_attention, its forward kept out of the timing); then
    # the cuda_core route and SDPA's backward at the training shape in f32
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    times = {}
    for dtype, name in ((bf16, "bfloat16"), (f32, "float32")):
        q, k, v = qkv(TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, dtype)
        dout = rand(q.shape, dtype)
        out, lse = fa.launch_route(fa._route(q, k, grad=True), q, k, v, with_lse=True, causal=True)
        sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True, enable_gqa=True)
        calls = {r: (lambda r=r: fa.launch_backward(q, k, v, out, lse, dout, causal=True, route=r))
                 for r in fa.BWD_KERNELS if dtype == bf16 or r == "cuda_core"}
        calls["plain"] = lambda: fa.attention_backward_plain(q, k, v, out, lse, dout, causal=True)
        calls["sdpa"] = lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True)
        slow = ("plain", "cuda_core")
        cold = {n: cold_ms(torch, f, flush, reps=5 if n in slow else 20) for n, f in calls.items()}
        again = {n: cold_ms(torch, calls[n], flush, reps=5 if n in slow else 20) for n in fa.BWD_KERNELS if n in calls}
        warm = {n: device_ms(torch, f, reps=5 if n in slow else 20) for n, f in calls.items()}
        ref = calls["sdpa"]()
        diff = {n: max(grad_err(torch, a, w) for a, w in zip(calls[n](), ref)) for n in fa.BWD_KERNELS if n in calls}
        for r in fa.BWD_KERNELS:
            if r not in calls:
                continue
            peak = F32_TFLOPS if dtype == f32 else BF16_TFLOPS  # the peak for the inputs' type, either route
            bound, by, flops, nbytes = bwd_bound_ms(q, k, TRAIN_S, True, 0, bw, peak)
            ms = cold[r]
            times[f"{r} {name}"] = dict(
                route=r, shape=f"q {list(q.shape)}, k/v {list(k.shape)} {name} causal", ms=ms, ms_again=again[r],
                plain_ms=cold["plain"], sdpa_ms=cold["sdpa"], warm_device_ms=warm, bound_ms=bound, bound_by=by,
                peak_TFLOPs=peak / 1e12, flops=flops, bytes=nbytes, achieved_TFLOPs=flops / (ms * 1e-3) / 1e12,
                sdpa_over_kernel=cold["sdpa"] / ms, sdpa_rel_diff=diff[r])
            emit("flash_bwd_times", **times[f"{r} {name}"])
        del q, k, v, dout, out, lse, sq_, sk_, sv_, sdpa_out, calls, ref
        torch.cuda.empty_cache()

    gemma2 = gemma2_backward_times(torch, fa, rand, flush, bw)
    at_launch = gemma2_launch_shape_times(torch, fa, rand, flush, bw)

    # row 5c: the f32 route's forward at the training shape in f32
    q, k, v = qkv(TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, f32)
    calls = {
        "kernel": lambda: fa.launch_route("f32", q, k, v, causal=True),
        "plain": lambda: fa.attention_plain(q, k, v, causal=True),
        "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
    }
    cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
    warm = {n: device_ms(torch, f, reps=5 if n == "plain" else 20) for n, f in calls.items()}
    sdpa_diff = float((calls["sdpa"]() - calls["kernel"]()).abs().max())
    b32, by32, flops32, bytes32 = flash_bound_ms(q, k, TRAIN_S, True, 0, bw, peak=F32_TFLOPS)
    f32_times = dict(shape=f"q {list(q.shape)}, k/v {list(k.shape)} f32 causal", ms=cold["kernel"],
                     plain_ms=cold["plain"], library_ms=cold["sdpa"], warm_device_ms=warm, bound_ms=b32,
                     bound_by=by32, flops=flops32, bytes=bytes32, sdpa_max_abs_diff=sdpa_diff)
    emit("flash_f32_route_times", **f32_times)
    del q, k, v, calls, flush
    torch.cuda.empty_cache()
    csrc = "src/repro_torch/kernels/csrc/"
    # one kernels-line entry a route, each timed where its route runs: the
    # tensor_core route at the bf16 training shape, the cuda_core route at
    # the f32 one (its bf16 run on the tensor_core route's inputs beside it)
    entries = {}
    for r, source, t in (("tensor_core", "flash_attention_bwd_tc.cu", times["tensor_core bfloat16"]),
                         ("cuda_core", "flash_attention_bwd.cu", times["cuda_core float32"])):
        entries[f"flash_attention_bwd/{r}"] = dict(
            name=f"flash_attention_bwd/{r}", route="cuda", source=csrc + source,
            replaces="src/repro/kernels/flash_attention/kernel.py:96",
            replaces_note="the backward of row 5's kernel: the JAX package has no Pallas backward and "
                          "differentiates its jnp chunked_attention (src/repro/models/layers.py:81)",
            max_abs_err=worst_abs[r], err_over_tol=worst[r], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["sdpa_ms"],
            warm_device_ms=t["warm_device_ms"][r], timed_shape=t["shape"],
            counter=fa.BWD_LAUNCHES[f"{r}/dkdv"],  # every call launches its route's dK/dV kernel once
        )
    entries["flash_attention_bwd/cuda_core"]["bfloat16_on_tensor_core_inputs"] = times["cuda_core bfloat16"]
    # head_dim 256: pre, then one launch of its dK/dV and dQ items (dkdv_dq),
    # an entry a route, timed where the main path launches it (phase 10's
    # bf16 step, phase 7's f32 gemma2) and at gemma2's 4672 rows
    for r, source, case, g2 in (("tensor_core", "flash_attention_bwd_tc.cu", "phase 10 backward", "tensor_core bfloat16"),
                                ("cuda_core", "flash_attention_bwd.cu", "phase 7 backward", "cuda_core float32")):
        t = at_launch[case]
        entries[f"flash_attention_bwd/{r}_256"] = dict(
            name=f"flash_attention_bwd/{r}_256", route="cuda", source=csrc + source,
            replaces="src/repro/kernels/flash_attention/kernel.py:96",
            replaces_note="the backward of row 5's kernel at head_dim 256 (gemma2), and on tensor_core at (q/k, v) "
                          "(192, 128) (deepseek-v3's MLA; its record is mla_192_128): pre, then one persistent "
                          "launch of the dK/dV and dQ items (dkdv_dq)",
            max_abs_err=worst_abs[r + "_256"], err_over_tol=worst[r + "_256"], ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=t["library_ms"],
            library_note=t["library_note"], kernels_ms=t["kernels_ms"], timed_shape=t["shape"],
            gemma2_backward=gemma2[g2], counter=fa.BWD_LAUNCHES[f"{r}/dkdv_dq"],  # once a call at head_dim 256
        )
    return dict(entries, f32_route_training_shape=f32_times, lse_err_over_tol=lse_worst,
                gemma2_phase10_forward=at_launch["phase 10 forward"])


#: gemma2's windowed attention backward: 2 sequences of 4672 (phase 9's
#: 4608 + 64), 8 query and 4 KV heads of 256, softcap 50, window 4096
GEMMA2_BWD_B, GEMMA2_BWD_S = 2, 4672


def gemma2_backward_times(torch, fa, rand, flush, bw) -> dict:
    """gemma2's windowed attention backward at its widths, in bf16 (its
    route, tensor_core, beside the cuda_core route on the same inputs) and
    in f32 (cuda_core, the route launch.train's f32 step takes): each
    route's three kernels (L2 cold), the plain backward and SDPA's backward
    without the softcap (K/V repeated to the query heads, the window as a
    boolean mask, its forward out of the timing; the backend named), beside
    the bound at the inputs' peak."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    out = {}
    kw = dict(causal=True, softcap=50.0, window=GEMMA2_WINDOW)
    s = GEMMA2_BWD_S
    pos = torch.arange(s, device=flush.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - GEMMA2_WINDOW)
    for dtype, name in ((torch.bfloat16, "bfloat16"), (torch.float32, "float32")):
        q = rand((GEMMA2_BWD_B, 8, s, 256), dtype)
        k, v = rand((GEMMA2_BWD_B, 4, s, 256), dtype), rand((GEMMA2_BWD_B, 4, s, 256), dtype)
        dout = rand(q.shape, dtype)
        o, lse = fa.launch_route(fa._route(q, k, grad=True), q, k, v, with_lse=True, **kw)
        sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)))
        backend = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(sq_, sk_, sv_, attn_mask=mask))
        with sdpa_kernel([backend]):
            sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, attn_mask=mask)
        routes = ("tensor_core", "cuda_core") if dtype == torch.bfloat16 else ("cuda_core",)
        calls = {r: (lambda r=r: fa.launch_backward(q, k, v, o, lse, dout, route=r, **kw)) for r in routes}
        calls["plain"] = lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, **kw)
        calls["sdpa_no_softcap"] = lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True)
        cold = {n: cold_ms(torch, f, flush, reps=3 if n in ("plain", "cuda_core") else 10) for n, f in calls.items()}
        want = calls["plain"]()
        peak = F32_TFLOPS if dtype == torch.float32 else BF16_TFLOPS
        bound, by, flops, nbytes = bwd_bound_ms(q, k, s, True, 0, bw, peak, window=GEMMA2_WINDOW)
        for r in routes:
            got = calls[r]()
            errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
            out[f"{r} {name}"] = dict(
                route=r, shape=f"q {list(q.shape)}, k/v {list(k.shape)} {name} causal softcap 50 window {GEMMA2_WINDOW}",
                ms=cold[r], plain_ms=cold["plain"], library_ms=cold["sdpa_no_softcap"], library_backend=str(backend),
                library_note="SDPA's backward without the softcap (a lighter function), K/V repeated to 8 heads",
                bound_ms=bound, bound_by=by, peak_TFLOPs=peak / 1e12, flops=flops, bytes=nbytes,
                achieved_TFLOPs=flops / (cold[r] * 1e-3) / 1e12, rel_err_vs_plain=errs,
                tol=FLASH_TOL[name])
            emit("flash_gemma2_bwd_times", **out[f"{r} {name}"])
            check(max(errs.values()) <= FLASH_TOL[name], f"gemma2 backward {r} {name}: kernels != plain backward")
            del got
        del q, k, v, dout, o, lse, sq_, sk_, sv_, sdpa_out, calls, want
        torch.cuda.empty_cache()
    return out


#: where the main path launches the head_dim-256 attention: phase 10's GRPO
#: step (2 x 2 sequences of 512 + 64, bf16) and phase 7's ``launch.train
#: --arch gemma2-2b --full-config --batch 2 --seq 512`` (f32); gemma2's
#: local layers (window 4096, which does not bite at these lengths), 8/4
#: heads of 256, softcap 50
GEMMA2_LAUNCH_SHAPES = {"phase 10": (4, 576, "bfloat16"), "phase 7": (2, 512, "float32")}


def gemma2_launch_shape_times(torch, fa, rand, flush, bw) -> dict:
    """gemma2's head_dim-256 attention timed where the main path launches
    it (``GEMMA2_LAUNCH_SHAPES``): the tensor_core forward (with the lse, as
    training calls it) and backward at phase 10's shape, the cuda_core
    backward at phase 7's, each with the L2 cold beside the plain version,
    the bound at the inputs' peak and SDPA on the same shape without the
    softcap (``is_causal``, no mask: the window does not bite; K/V repeated
    to the query heads outside the timing; its forward out of the
    backward's timing; the backend named)."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    out = {}
    kw = dict(causal=True, softcap=50.0, window=GEMMA2_WINDOW)
    for phase, (b, s, name) in GEMMA2_LAUNCH_SHAPES.items():
        dtype = getattr(torch, name)
        q = rand((b, 8, s, 256), dtype)
        k, v = rand((b, 4, s, 256), dtype), rand((b, 4, s, 256), dtype)
        dout = rand(q.shape, dtype)
        route, bwd_route = fa._route(q, k, grad=True), fa._bwd_route(q)
        o, lse = fa.launch_route(route, q, k, v, with_lse=True, **kw)
        k8, v8 = k.repeat_interleave(2, 1), v.repeat_interleave(2, 1)
        peak = F32_TFLOPS if dtype == torch.float32 else BF16_TFLOPS
        shape = f"q {list(q.shape)}, k/v {list(k.shape)} {name} causal softcap 50 window {GEMMA2_WINDOW}"
        if route == "tensor_core":  # the forward as the step calls it
            def sdpa():
                return F.scaled_dot_product_attention(q, k8, v8, is_causal=True)

            backend = sdpa_backend(torch, sdpa)
            calls = {"kernel": lambda: fa.launch_route(route, q, k, v, with_lse=True, **kw),
                     "plain": lambda: fa.attention_plain(q, k, v, **kw)}
            cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
            with sdpa_kernel([backend]):
                cold["sdpa"] = cold_ms(torch, sdpa, flush, reps=20)
            bound, by, flops, nbytes = flash_bound_ms(q, k, s, True, 0, bw, peak=peak, window=GEMMA2_WINDOW)
            out[f"{phase} forward"] = dict(
                route=route, shape=shape + ", with the lse", ms=cold["kernel"], plain_ms=cold["plain"],
                library_ms=cold["sdpa"], library_backend=str(backend),
                library_note="SDPA is_causal without the softcap (a lighter function), K/V repeated to 8 heads",
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes)
            emit("flash_launch_shape_times", case=f"{phase} forward", **out[f"{phase} forward"])
        sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k8, v8))
        backend = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True))
        with sdpa_kernel([backend]):
            sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True)
        calls = {"kernel": lambda: fa.launch_backward(q, k, v, o, lse, dout, route=bwd_route, **kw),
                 "plain": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, **kw),
                 "sdpa": lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True)}
        cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        split = kernel_split_ms(torch, calls["kernel"], flush)  # pre, then the one dkdv_dq launch
        want = calls["plain"]()
        errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), calls["kernel"](), want)}
        bound, by, flops, nbytes = bwd_bound_ms(q, k, s, True, 0, bw, peak, window=GEMMA2_WINDOW)
        out[f"{phase} backward"] = dict(
            route=bwd_route, shape=shape, ms=cold["kernel"], kernels_ms=split, plain_ms=cold["plain"],
            library_ms=cold["sdpa"],
            library_backend=str(backend),
            library_note="SDPA's backward is_causal without the softcap (a lighter function), K/V repeated to 8 heads",
            bound_ms=bound, bound_by=by, peak_TFLOPs=peak / 1e12, flops=flops, bytes=nbytes,
            achieved_TFLOPs=flops / (cold["kernel"] * 1e-3) / 1e12, rel_err_vs_plain=errs, tol=FLASH_TOL[name])
        emit("flash_launch_shape_times", case=f"{phase} backward", **out[f"{phase} backward"])
        check(max(errs.values()) <= FLASH_TOL[name],
              f"gemma2 {phase} backward ({bwd_route}): kernels != plain backward")
        del q, k, v, dout, o, lse, k8, v8, sq_, sk_, sv_, sdpa_out, calls, want
        torch.cuda.empty_cache()
    return out


#: dbrx-132b's attention at phase 11's shapes: 48 query and 8 KV heads of
#: 128 (G = 6); the GRPO step's 2 x 2 sequences of 512 + 64
DBRX_HEADS = (48, 8)
DBRX_TRAIN_B, DBRX_TRAIN_S = 4, 576


def dbrx_attention_checks(torch, dev, bw: float) -> dict:
    """dbrx's GQA group of 6 on the three routes phase 11 takes, each held
    to its plain version at phase 2's tolerances and timed with the L2
    cold beside the plain version and SDPA (``enable_gqa``), with the
    bound: the tensor_core forward at the served prefill (q [4,48,512,128],
    k/v [4,8,512,128], causal), the decode route at the last served decode
    step (q [4,48,1,128] against 528 keys) and the tensor_core backward at
    the GRPO step's [4,48/8,576,128] (through the autograd Function, twice
    for bit-equal gradients, against autograd of the plain attention)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 110)

    def rand(shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    hq, hkv = DBRX_HEADS
    tol = FLASH_TOL["bfloat16"]
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {}
    total = DBRX_PROMPT + DBRX_GEN
    for label, route, sq, kw, sdpa_kw in (
        ("prefill", "tensor_core", DBRX_PROMPT, dict(causal=True), dict(is_causal=True)),
        ("decode", "decode", 1, dict(causal=True, q_offset=total - 1, kv_len=total), {}),
    ):
        sk = kw.get("kv_len", sq)
        q, k, v = rand((DBRX_B, hq, sq, 128)), rand((DBRX_B, hkv, sk, 128)), rand((DBRX_B, hkv, sk, 128))
        check(fa._route(q, k) == route, f"dbrx {label} routed to {fa._route(q, k)}")
        before = fa.ROUTE_LAUNCHES[route].value
        got = fa.flash_attention(q, k, v, **kw).float()
        check(fa.ROUTE_LAUNCHES[route].value == before + 1, f"{route} not launched on dbrx {label}")
        want = fa.attention_plain(q, k, v, **kw).float()
        diff = (got - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())
        shape = f"q {list(q.shape)}, k/v {list(k.shape)} bf16 causal"
        emit("flash_check", case=f"dbrx {label} G 6 {shape}", route=route, max_abs_err=float(diff.max()), tol=tol,
             err_over_tol=ratio)
        check(ratio <= 1.0 and torch.isfinite(got).all().item(), f"{route} != plain version on dbrx {label}")
        calls = {
            "kernel": lambda: fa.flash_attention(q, k, v, **kw),
            "plain": lambda: fa.attention_plain(q, k, v, **kw),
            "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa_kw),
        }
        cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        bound, by, flops, nbytes = flash_bound_ms(q, k, sk, True, kw.get("q_offset", 0), bw)
        out[label] = dict(route=route, shape=shape, ms=cold["kernel"], plain_ms=cold["plain"],
                          library_ms=cold["sdpa"], bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                          max_abs_err=float(diff.max()), err_over_tol=ratio,
                          sdpa_max_abs_diff=float((calls["sdpa"]().float() - got).abs().max()))
        emit("flash_dbrx_times", case=label, **out[label])
        del q, k, v, got, want, diff, calls

    q = rand((DBRX_TRAIN_B, hq, DBRX_TRAIN_S, 128))
    k, v = rand((DBRX_TRAIN_B, hkv, DBRX_TRAIN_S, 128)), rand((DBRX_TRAIN_B, hkv, DBRX_TRAIN_S, 128))
    dout = rand(q.shape)
    route, bwd_route = fa._route(q, k, grad=True), fa._bwd_route(q)
    check((route, bwd_route) == ("tensor_core", "tensor_core"), f"dbrx's step routed to {route}/{bwd_route}")

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
        got = torch.autograd.grad(fa.flash_attention(*leaves, causal=True), leaves, dout)
        check(all(fa.BWD_LAUNCHES[f"tensor_core/{n}"].value == before[f"tensor_core/{n}"] + 1
                  for n in fa.bwd_kernels(128)), "tensor_core backward not launched on dbrx's step")
        return got

    got, again = grads(), grads()
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref, causal=True), ref, dout)
    errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    shape = f"q {list(q.shape)}, k/v {list(k.shape)} bf16 causal"
    emit("flash_bwd_check", case=f"dbrx step G 6 {shape}", forward_route=route, backward_route=bwd_route,
         rel_err=errs, tol=tol, finite=finite, bit_equal_rerun=same)
    check(finite and max(errs.values()) <= tol and same, "tensor_core backward != autograd of the plain version "
          "on dbrx's step, or two runs differ")
    o, lse = fa.launch_route(route, q, k, v, with_lse=True, causal=True)
    sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True, enable_gqa=True)
    calls = {
        "kernel": lambda: fa.launch_backward(q, k, v, o, lse, dout, causal=True, route="tensor_core"),
        "plain": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, causal=True),
        "sdpa": lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True),
    }
    cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
    bound, by, flops, nbytes = bwd_bound_ms(q, k, DBRX_TRAIN_S, True, 0, bw, BF16_TFLOPS)
    out["backward"] = dict(route="tensor_core", shape=shape, ms=cold["kernel"], plain_ms=cold["plain"],
                           library_ms=cold["sdpa"], bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                           rel_err_vs_plain=errs, err_over_tol=max(errs.values()) / tol,
                           max_abs_err=max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)),
                           sdpa_rel_diff=max(grad_err(torch, a, w) for a, w in zip(got, calls["sdpa"]())))
    emit("flash_dbrx_times", case="backward", **out["backward"])
    del q, k, v, dout, got, again, ref, want, o, lse, sq_, sk_, sv_, sdpa_out, calls, flush
    torch.cuda.empty_cache()
    return out


#: deepseek-v3's expanded MLA prefill on the tensor_core route's (192, 128)
#: plan: (b, hq, hkv, sq, sk, kw); the served shape first (phase 12: 4
#: requests of 512 prompt tokens, 128 heads), then S = 77, kv_len < Sk with
#: NaN past it, q_offset > 0 and a GQA group of 4
MLA_TC_SHAPES = [
    (4, 128, 128, 512, 512, dict(causal=True)),
    (2, 16, 16, 77, 77, dict(causal=True)),
    (2, 16, 16, 256, 400, dict(causal=False, kv_len=300, nan=True)),
    (1, 16, 16, 64, 600, dict(causal=True, q_offset=500, kv_len=564, nan=True)),
    (1, 32, 8, 130, 130, dict(causal=True)),
    # the wide plan's 128-row item edges, a cached prefix, NaN past kv_len
    *((2, 16, 16, sq, sq + 70, dict(causal=True, q_offset=40, kv_len=sq + 40, nan=True))
      for sq in (127, 128, 129, 255, 256, 257, 511, 512, 513)),
]
MLA_QK, MLA_V, MLA_R, MLA_ROPE = 192, 128, 512, 64  # deepseek-v3's widths
#: the absorbed decode on the mla_decode kernel: (b, heads, slots, kv_len,
#: NaN in the dead slots); the served step's last (4 x 128 heads against
#: 528 of 528 slots) first, a long cache (8192 slots) last, with NaN past a
#: kv_len off the 32-key tiles
MLA_DECODE_CASES = [
    (4, 128, 528, 528, False),
    (4, 128, 528, 1, True),
    (4, 128, 528, 65, True),
    (4, 128, 528, 527, True),
    (4, 128, 528, 300, True),
    (1, 128, 528, 528, False),
    (4, 16, 528, 400, True),
    (4, 128, 8192, 8192, False),
    (4, 128, 8192, 4099, True),
]
#: the cases timed: the served step and the long cache
MLA_DECODE_TIMED = {(4, 128, 528, 528, False): "served", (4, 128, 8192, 8192, False): "long_cache"}
MLA_DECODE_TOL = 2e-5  # f32, of the output's max |value|: the kernel and the reference are f32 throughout


def mla_bound_ms(b, hq, hkv, sq, kv_len, causal, q_offset, bw, *, d=MLA_QK, dv=MLA_V, peak=BF16_TFLOPS, esize=2):
    """The (d, dv) forward's bound, (192, 128) in bf16 unless given: the
    larger of 2 (d + dv) flops a live (query, key) pair a head at ``peak``,
    and the bytes (``esize`` an element) of q and o once and the live keys
    of k and v once at the memory rate."""
    pairs = live_pairs(sq, kv_len, causal, q_offset)
    flops = 2 * b * hq * pairs * (d + dv)
    keys = live_keys(sq, kv_len, causal, q_offset)
    nbytes = esize * (b * hq * sq * (d + dv) + b * hkv * keys * (d + dv))
    t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


def mla_decode_bound_ms(b, heads, kv_len, bw):
    """The absorbed decode's bound: the queries (bf16), the live latent
    rows and rope keys (bf16) read once and the f32 output written once at
    the memory rate, against 2 (576 + 512) operations a (head, slot) at the
    peak of the inputs' type (bf16, 989 TFLOP/s)."""
    w = MLA_R + MLA_ROPE
    nbytes = 2 * b * heads * w + 2 * b * kv_len * w + 4 * b * heads * MLA_R
    flops = 2 * b * heads * kv_len * (w + MLA_R)
    t_ops, t_bytes = flops / BF16_TFLOPS * 1e3, nbytes / bw * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes"), flops, nbytes


def mla_attention_checks(torch, dev, bw: float) -> dict:
    """deepseek-v3's two attention kernels against their plain versions on
    the card, each case twice for bit-equal reruns: the tensor_core forward
    at q/k 192 and v 128 (``MLA_TC_SHAPES``, bf16 tolerance) and the
    absorbed-latent ``mla_decode`` kernel (``MLA_DECODE_CASES``, within 2e-5
    of the output's max |value|). Both timed with the L2 cold at the
    served shapes (the decode also at a long cache, ``MLA_DECODE_TIMED``)
    beside the plain version, the bound and SDPA (E 192, Ev 128, causal for
    the prefill; one KV head of E 576, Ev 512 with ``enable_gqa`` and the
    scale 1/sqrt(192) for the decode), its backend named, or "none ran"
    (its math backend expands K/V to every head: 9 GB at 8192 slots). Returns
    the tensor_core route's (192, 128) record and the ``mla_decode``
    kernel's entry."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md

    g = torch.Generator(device=dev).manual_seed(SEED + 120)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    tol = FLASH_TOL["bfloat16"]
    worst_tc = (0.0, 0.0)
    prefill = None
    for b, hq, hkv, sq, sk, kw in MLA_TC_SHAPES:
        kw = dict(kw)
        nan = kw.pop("nan", False)
        q, k, v = rand(b, hq, sq, MLA_QK), rand(b, hkv, sk, MLA_QK), rand(b, hkv, sk, MLA_V)
        kz, vz = k, v
        if nan:
            kz, vz = k.clone(), v.clone()
            kz[:, :, kw["kv_len"]:] = 0
            vz[:, :, kw["kv_len"]:] = 0
            k[:, :, kw["kv_len"]:] = float("nan")
            v[:, :, kw["kv_len"]:] = float("nan")
        label = f"mla tensor_core [{b},{hq}/{hkv},{sq}x{sk}] q/k 192 v 128 {kw}{' NaN past kv_len' if nan else ''}"
        check(fa._route(q, k, v=v) == "tensor_core", f"{label} routed to {fa._route(q, k, v=v)}")
        before = fa.ROUTE_LAUNCHES["tensor_core"].value
        got = fa.flash_attention(q, k, v, **kw)
        again = fa.flash_attention(q, k, v, **kw)
        check(fa.ROUTE_LAUNCHES["tensor_core"].value == before + 2, f"tensor_core not launched on {label}")
        want = fa.attention_plain(q, kz, vz, **kw).float()
        diff = (got.float() - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())
        same = bool(torch.equal(got, again))
        worst_tc = (max(worst_tc[0], float(diff.max())), max(worst_tc[1], ratio))
        emit("flash_check", case=label, route="tensor_core", max_abs_err=float(diff.max()), tol=tol,
             err_over_tol=ratio, bit_equal_rerun=same)
        check(ratio <= 1.0 and same and torch.isfinite(got).all().item(),
              f"tensor_core != plain version on {label}, or two runs differ")
        if prefill is None:  # the served shape: timed
            calls = {"kernel": lambda: fa.flash_attention(q, k, v, **kw),
                     "plain": lambda: fa.attention_plain(q, k, v, **kw),
                     "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)}
            backend = sdpa_backend(torch, calls["sdpa"])
            cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
            bound, by, flops, nbytes = mla_bound_ms(b, hq, hkv, sq, sk, True, 0, bw)
            prefill = dict(route="tensor_core", shape=f"q/k [{b},{hq},{sq},192], v [{b},{hkv},{sk},128] bf16 causal",
                           ms=cold["kernel"], plain_ms=cold["plain"], library_ms=cold["sdpa"],
                           library=f"scaled_dot_product_attention ({backend.name})", bound_ms=bound, bound_by=by,
                           flops=flops, bytes=nbytes, achieved_TFLOPs=flops / (cold["kernel"] * 1e-3) / 1e12,
                           sdpa_max_abs_diff=float((calls["sdpa"]().float() - got.float()).abs().max()))
            emit("flash_mla_times", case="prefill", **prefill)
            del calls
        del q, k, v, kz, vz, got, again, want, diff
    prefill.update(max_abs_err=worst_tc[0], err_over_tol=worst_tc[1])
    torch.cuda.empty_cache()

    worst, decode = (0.0, 0.0), {}
    for b, h, smax, kv_len, nan in MLA_DECODE_CASES:
        qa, qr = rand(b, h, 1, MLA_R), rand(b, h, 1, MLA_ROPE)
        ckv, kr = rand(b, smax, MLA_R), rand(b, smax, MLA_ROPE)
        if nan:
            ckv[:, kv_len:] = float("nan")
            kr[:, kv_len:] = float("nan")
        scale = 1.0 / math.sqrt(MLA_QK)
        label = f"mla_decode [{b},{h}] heads vs {kv_len} of {smax} slots{' NaN past kv_len' if nan else ''}"
        before = md.LAUNCHES.value
        got = md.mla_decode(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)
        again = md.mla_decode(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)
        check(md.LAUNCHES.value == before + 2, f"mla_decode not launched on {label}")
        want = md.mla_decode_plain(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)
        err = float((got - want).abs().max())
        ratio = err / (MLA_DECODE_TOL * float(want.abs().max()))
        same = bool(torch.equal(got, again))
        worst = (max(worst[0], err), max(worst[1], ratio))
        emit("mla_decode_check", case=label, max_abs_err=err, tol=f"{MLA_DECODE_TOL} of max |value|",
             err_over_tol=ratio, bit_equal_rerun=same, splits=md.split_plan(kv_len, b, h))
        check(ratio <= 1.0 and same and torch.isfinite(got).all().item(),
              f"mla_decode != plain version on {label}, or two runs differ")
        timed = MLA_DECODE_TIMED.get((b, h, smax, kv_len, nan))
        if timed:
            q576 = torch.cat([qa, qr], -1)
            k576, v512 = torch.cat([ckv, kr], -1)[:, None], ckv[:, None]

            def sdpa():
                return F.scaled_dot_product_attention(q576, k576, v512, enable_gqa=True, scale=scale)

            try:
                backend = sdpa_backend(torch, sdpa).name
            except SmokeFailure:  # a backend out of memory is one that does not take the call
                backend = None
                torch.cuda.empty_cache()
            calls = {"kernel": lambda: md.mla_decode(qa, qr, ckv, kr, kv_len=kv_len, scale=scale),
                     "plain": lambda: md.mla_decode_plain(qa, qr, ckv, kr, kv_len=kv_len, scale=scale)}
            if backend is not None:
                calls["sdpa"] = sdpa
            cold = {n: cold_ms(torch, f, flush) for n, f in calls.items()}
            warm = {n: device_ms(torch, f) for n, f in calls.items()}
            bound, by, flops, nbytes = mla_decode_bound_ms(b, h, kv_len, bw)
            decode[timed] = dict(
                shape=f"q_abs [{b},{h},1,512], q_rope [{b},{h},1,64], ckv [{b},{smax},512], "
                      f"krope [{b},{smax},64] bf16, kv_len {kv_len}",
                ms=cold["kernel"], plain_ms=cold["plain"], library_ms=cold.get("sdpa"),
                library=(f"scaled_dot_product_attention ({backend}), one KV head of E 576, Ev 512"
                         if backend else "none ran"),
                warm_device_ms=warm, bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                splits=md.split_plan(kv_len, b, h),
                sdpa_max_abs_diff=float((sdpa().float()[..., :MLA_R] - got).abs().max()) if backend else None)
            emit("mla_decode_times", case=timed, **decode[timed])
            del q576, k576, v512, calls
        del qa, qr, ckv, kr, got, again, want
    del flush
    torch.cuda.empty_cache()
    served = decode["served"]
    entry = dict(name="mla_decode", route="cuda", source="src/repro_torch/kernels/csrc/mla_decode.cu",
                 replaces="src/repro/models/blocks.py:184", max_abs_err=worst[0], err_over_tol=worst[1],
                 ms=served["ms"], plain_ms=served["plain_ms"], bound_ms=served["bound_ms"],
                 bound_by=served["bound_by"], library_ms=served["library_ms"], library=served["library"],
                 timed_shape=served["shape"], long_cache=decode["long_cache"], counter=md.LAUNCHES)
    return {"mla_prefill": prefill, "mla_decode": entry}


#: the (192, 128) tensor-core backward's cases: phase 12's training shape
#: (2 prompts x 2 responses of 512 + 64, 128 heads of their own K/V) first,
#: then G 1 and 2 off the 64-row tiles, kv_len < Sk with NaN past it, a
#: q_offset
MLA_BWD_SHAPES = [
    (4, 128, 128, 576, 576, dict(causal=True)),
    (2, 16, 16, 77, 77, dict(causal=True)),
    (2, 16, 8, 130, 130, dict(causal=True)),
    (2, 16, 16, 256, 400, dict(causal=False, kv_len=300, nan=True)),
    (1, 16, 8, 64, 600, dict(causal=True, q_offset=500, kv_len=564, nan=True)),
]
#: the reduced deepseek-v3's (q/k, v) = (16 + 8, 16) on the CUDA-core
#: routes: phase 7's shape (launch.train's 8 x 64, 4 heads) first, then Sq
#: off the tiles, G 4, kv_len < Sk with NaN past it, a q_offset
MLA_NARROW_QK, MLA_NARROW_V = 24, 16
MLA_NARROW_SHAPES = [
    (8, 4, 4, 64, 64, dict(causal=True)),
    (2, 4, 4, 77, 77, dict(causal=True)),
    (1, 8, 2, 130, 130, dict(causal=True)),
    (2, 4, 4, 100, 200, dict(causal=False, kv_len=150, nan=True)),
    (1, 8, 2, 64, 300, dict(causal=True, q_offset=200, kv_len=264, nan=True)),
]


def backward_twice(torch, fa, route, label, q, k, v, out, lse, dout, kw):
    """The call's gradients on ``route`` (each of its kernels launched once)
    and a rerun's."""
    before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
    got = fa.launch_backward(q, k, v, out, lse, dout, **kw)
    want = {f"{route}/{n}": 1 for n in fa.bwd_kernels(q.shape[3], v.shape[3])}
    check({n: c.value - before[n] for n, c in fa.BWD_LAUNCHES.items()} == {n: want.get(n, 0) for n in before},
          f"{route} backward kernels not launched on {label}")
    return got, fa.launch_backward(q, k, v, out, lse, dout, **kw)


def held_backward(torch, label, route, got, again, want, q, k, v, tol):
    """Gradients ``got`` against ``want`` within ``tol`` of each one's max
    |value|, finite, of q's, k's and v's shapes, bit-equal to a rerun's
    ``again``; returns the worst |difference| and error over ``tol``."""
    errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    shapes = [list(t.shape) for t in got] == [list(t.shape) for t in (q, k, v)]
    emit("flash_bwd_check", case=label, backward_route=route, rel_err=errs, tol=tol, finite=finite,
         bit_equal_rerun=same, dv_shape=list(got[2].shape))
    check(finite and shapes and max(errs.values()) <= tol, f"backward kernels != plain backward on {label}")
    check(same, f"two runs of the {route} backward differ on {label}")
    return max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)), max(errs.values()) / tol


def mla_training_checks(torch, dev, bw: float) -> dict:
    """deepseek-v3's attention gradients on their kernels, each case twice
    for bit-equal reruns: the tensor_core backward at (192, 128) in bf16
    (``MLA_BWD_SHAPES``, pre and the one dkdv_dq launch, dV at v's width)
    against ``attention_backward_plain`` on the forward's own output and
    lse, within the bf16 tolerance of each gradient's max |value|, timed
    with the L2 cold at phase 12's training shape beside its kernels' split,
    the plain backward, the bound and SDPA's backward (its backend named);
    and the reduced config's (24, 16) (``MLA_NARROW_SHAPES``) in f32, bf16
    and f16 on the f32 forward (with the lse) and the cuda_core backward
    against the plain versions, timed at phase 7's shape in f32 beside the
    plain versions, the bounds at the f32 peak and SDPA."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 130)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def inputs(b, hq, hkv, sq, sk, d, dv, dtype, kw):
        q, k, v = rand((b, hq, sq, d), dtype), rand((b, hkv, sk, d), dtype), rand((b, hkv, sk, dv), dtype)
        kz, vz = k, v
        if kw.pop("nan", False):
            q, k, v, kz, vz = nan_tail((q, k, v), kw["kv_len"])
        return q, k, v, rand((b, hq, sq, dv), dtype), kz, vz

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    tol = FLASH_TOL["bfloat16"]
    worst, timed = (0.0, 0.0), None
    for b, hq, hkv, sq, sk, kw in MLA_BWD_SHAPES:
        kw = dict(kw)
        q, k, v, dout, kz, vz = inputs(b, hq, hkv, sq, sk, MLA_QK, MLA_V, torch.bfloat16, kw)
        label = f"mla tensor_core backward [{b},{hq}/{hkv},{sq}x{sk}] q/k 192 v 128 {kw}"
        check(fa._bwd_route(q, v) == "tensor_core", f"{label} routed to {fa._bwd_route(q, v)}")
        out, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, **kw)
        got, again = backward_twice(torch, fa, "tensor_core", label, q, k, v, out, lse, dout, kw)
        want = fa.attention_backward_plain(q, kz, vz, out, lse, dout, **kw)
        err = held_backward(torch, label, "tensor_core", got, again, want, q, k, v, tol)
        worst = (max(worst[0], err[0]), max(worst[1], err[1]))
        del got, again, want
        if timed is None:  # phase 12's training shape
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]

            def sdpa_grads():
                return torch.autograd.grad(F.scaled_dot_product_attention(*leaves, is_causal=True), leaves, dout)

            backend = sdpa_backend(torch, sdpa_grads)
            with sdpa_kernel([backend]):
                sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
            calls = {"kernel": lambda: fa.launch_backward(q, k, v, out, lse, dout, **kw),
                     "plain": lambda: fa.attention_backward_plain(q, k, v, out, lse, dout, **kw),
                     "sdpa": lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)}
            cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
            warm = device_ms(torch, calls["kernel"])
            split = kernel_split_ms(torch, calls["kernel"], flush)
            bound, by, flops, nbytes = bwd_bound_ms(q, k, sk, True, 0, bw, BF16_TFLOPS, v=v)
            timed = dict(route="tensor_core", shape=f"q/k [{b},{hq},{sq},192], v [{b},{hkv},{sk},128] bf16 causal",
                         ms=cold["kernel"], warm_device_ms=warm, kernels_ms=split, plain_ms=cold["plain"],
                         library_ms=cold["sdpa"], library=f"scaled_dot_product_attention backward ({backend.name})",
                         bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                         achieved_TFLOPs=flops / (cold["kernel"] * 1e-3) / 1e12,
                         sdpa_rel_diff=max(grad_err(torch, a, w) for a, w in zip(calls["kernel"](), calls["sdpa"]())))
            emit("flash_mla_bwd_times", **timed)
            del leaves, sdpa_out, calls
        del q, k, v, dout, kz, vz, out, lse
        torch.cuda.empty_cache()
    timed.update(max_abs_err=worst[0], err_over_tol=worst[1])

    # (24, 16) on the CUDA-core routes
    fwd_worst, bwd_worst, narrow = (0.0, 0.0), (0.0, 0.0), {}
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[1]
        tol = FLASH_TOL[name]
        for b, hq, hkv, sq, sk, kw in MLA_NARROW_SHAPES:
            kw = dict(kw)
            q, k, v, dout, kz, vz = inputs(b, hq, hkv, sq, sk, MLA_NARROW_QK, MLA_NARROW_V, dtype, kw)
            label = f"mla (24, 16) [{b},{hq}/{hkv},{sq}x{sk}] {kw} {name}"
            check(fa._route(q, k, grad=True, v=v) == "f32" and fa._bwd_route(q, v) == "cuda_core",
                  f"{label}: routes {fa._route(q, k, grad=True, v=v)}, {fa._bwd_route(q, v)}")
            before = fa.ROUTE_LAUNCHES["f32"].value
            out, lse = fa.launch_route("f32", q, k, v, with_lse=True, **kw)
            same = bool(torch.equal(out, fa.launch_route("f32", q, k, v, **kw)))
            check(fa.ROUTE_LAUNCHES["f32"].value == before + 2, f"f32 route not launched on {label}")
            want = fa.attention_plain(q, kz, vz, **kw).float()
            diff = (out.float() - want).abs()
            ratio = float((diff / (tol + tol * want.abs())).max())
            lse_want = fa.attention_lse_plain(q, kz, **kw)
            lse_ratio = float(((lse - lse_want).abs() / (2e-5 + 2e-5 * lse_want.abs())).max())
            fwd_worst = (max(fwd_worst[0], float(diff.max())), max(fwd_worst[1], ratio, lse_ratio))
            emit("flash_check", case=label, route="f32", max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio,
                 lse_err_over_tol=lse_ratio, bit_equal_rerun=same)
            check(ratio <= 1.0 and lse_ratio <= 1.0 and same and bool(torch.isfinite(out).all()),
                  f"f32 route != plain version on {label}, or two runs differ")
            got, again = backward_twice(torch, fa, "cuda_core", label, q, k, v, out, lse, dout, kw)
            err = held_backward(torch, label, "cuda_core", got, again,
                                fa.attention_backward_plain(q, kz, vz, out, lse, dout, **kw), q, k, v, tol)
            bwd_worst = (max(bwd_worst[0], err[0]), max(bwd_worst[1], err[1]))
            if dtype == torch.float32 and not narrow:  # phase 7's shape: timed
                sdpa_fwd = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
                calls = {"forward": lambda: fa.launch_route("f32", q, k, v, with_lse=True, **kw),
                         "forward_plain": lambda: fa.attention_plain(q, k, v, **kw), "forward_sdpa": sdpa_fwd,
                         "backward": lambda: fa.launch_backward(q, k, v, out, lse, dout, **kw),
                         "backward_plain": lambda: fa.attention_backward_plain(q, k, v, out, lse, dout, **kw),
                         "backward_sdpa": lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)}
                cold = {n: cold_ms(torch, f, flush) for n, f in calls.items()}
                warm = {n: device_ms(torch, calls[n]) for n in ("forward", "backward")}
                fb = mla_bound_ms(b, hq, hkv, sq, sk, True, 0, bw, d=MLA_NARROW_QK, dv=MLA_NARROW_V, peak=F32_TFLOPS,
                                  esize=4)
                bb = bwd_bound_ms(q, k, sk, True, 0, bw, F32_TFLOPS, v=v)
                shape = f"q/k [{b},{hq},{sq},24], v [{b},{hkv},{sk},16] f32 causal"
                for part, bound in (("forward", fb), ("backward", bb)):
                    narrow[part] = dict(shape=shape + (", with the lse" if part == "forward" else ""),
                                        ms=cold[part], warm_device_ms=warm[part], plain_ms=cold[f"{part}_plain"],
                                        library_ms=cold[f"{part}_sdpa"], library=f"scaled_dot_product_attention {part}",
                                        bound_ms=bound[0], bound_by=bound[1], flops=bound[2], bytes=bound[3])
                    emit("flash_mla_narrow_times", part=part, **narrow[part])
                del leaves, sdpa_out, calls
            del q, k, v, dout, kz, vz, out, lse, got, again
    del flush
    torch.cuda.empty_cache()
    narrow["forward"].update(max_abs_err=fwd_worst[0], err_over_tol=fwd_worst[1])
    narrow["backward"].update(max_abs_err=bwd_worst[0], err_over_tol=bwd_worst[1])
    return {"mla_backward": timed, "narrow_forward": narrow["forward"], "narrow_backward": narrow["backward"]}


#: the decode steps of phase 14 held to the plain version: the first (the
#: cache's first generated slot), one in the middle and the last, against
#: its 832 slots, NaN in K and V past kv_len where it is short of them
VLM_DECODE_KV = (769, 800, 832)


def vlm_attention_checks(torch, dev, bw: float) -> dict:
    """internvl2-2b's attention (16 query and 8 KV heads of 128: G 2) at
    the shapes phase 14 launches, each held to its plain version at phase
    2's tolerances and run twice for bit-equal results: the tensor_core
    forward at the served prefill (q [4,16,768,128], k/v [4,8,768,128]
    causal, bf16), the decode route at the served decode steps (q
    [4,16,1,128] against the 832 slots, ``VLM_DECODE_KV``), and at the f32
    training shape [2,16/8,512,128] causal the f32 forward with its lse and
    the cuda_core backward on the forward's own output. The last decode
    step, the prefill, the forward and the backward are each timed with the
    L2 cold beside the plain version and SDPA (``enable_gqa``; the backward
    with K/V repeated to 16 heads), with the bound at the inputs' peak."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config("internvl2-2b")
    hq, hkv, d, p = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.num_patches
    g = torch.Generator(device=dev).manual_seed(SEED + 150)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    def held(label, route, got, again, want, tol):
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        same = bool(torch.equal(got, again))
        emit("flash_check", case=label, route=route, max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio,
             bit_equal_rerun=same)
        check(ratio <= 1.0 and bool(torch.isfinite(got).all()), f"{route} != plain version on {label}")
        check(same, f"two runs of the {route} route differ on {label}")
        return float(diff.max()), ratio

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    tol = FLASH_TOL["bfloat16"]
    out = {}
    total = p + VLM_PROMPT + VLM_GEN
    served = [("prefill", "tensor_core", p + VLM_PROMPT, p + VLM_PROMPT, dict(causal=True), dict(is_causal=True))]
    served += [(f"decode kv_len {n}", "decode", 1, total, dict(causal=True, q_offset=n - 1, kv_len=n), {})
               for n in VLM_DECODE_KV]
    worst = {"tensor_core": (0.0, 0.0), "decode": (0.0, 0.0)}
    for label, route, sq, sk, kw, sdpa_kw in served:
        q = rand((VLM_B, hq, sq, d), torch.bfloat16)
        k, v = rand((VLM_B, hkv, sk, d), torch.bfloat16), rand((VLM_B, hkv, sk, d), torch.bfloat16)
        kz, vz = k, v
        if kw.get("kv_len", sk) < sk:
            q, k, v, kz, vz = nan_tail((q, k, v), kw["kv_len"])
        shape = f"q {list(q.shape)}, k/v {list(k.shape)} bf16 causal" + "".join(f", kv_len {n}" for n in
                                                                             [kw.get("kv_len")] if n)
        check(fa._route(q, k) == route, f"internvl2 {label} routed to {fa._route(q, k)}")
        before = fa.ROUTE_LAUNCHES[route].value
        got, again = fa.flash_attention(q, k, v, **kw), fa.flash_attention(q, k, v, **kw)
        check(fa.ROUTE_LAUNCHES[route].value == before + 2, f"{route} not launched on internvl2 {label}")
        err = held(f"internvl2 {label} G 2 {shape}", route, got, again, fa.attention_plain(q, kz, vz, **kw), tol)
        worst[route] = tuple(max(a, b) for a, b in zip(worst[route], err))
        if label in ("prefill", f"decode kv_len {total}"):  # the served prefill and the last decode step: timed
            calls = {"kernel": lambda: fa.flash_attention(q, k, v, **kw),
                     "plain": lambda: fa.attention_plain(q, k, v, **kw),
                     "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **sdpa_kw)}
            cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
            bound, by, flops, nbytes = flash_bound_ms(q, k, kw.get("kv_len", sk), True, kw.get("q_offset", 0), bw)
            key = "prefill" if route == "tensor_core" else "decode"
            out[key] = dict(route=route, shape=shape, ms=cold["kernel"], plain_ms=cold["plain"],
                            library_ms=cold["sdpa"], bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                            sdpa_max_abs_diff=float((calls["sdpa"]().float() - got.float()).abs().max()))
            emit("flash_internvl2_times", case=key, **out[key])
            del calls
        del q, k, v, kz, vz, got, again
    out["prefill"].update(max_abs_err=worst["tensor_core"][0], err_over_tol=worst["tensor_core"][1])
    out["decode"].update(max_abs_err=worst["decode"][0], err_over_tol=worst["decode"][1])

    # the f32 training shape: the f32 forward with its lse, the cuda_core backward
    f32, tol, s = torch.float32, FLASH_TOL["float32"], VLM_TRAIN_SEQ
    q = rand((VLM_TRAIN_B, hq, s, d), f32)
    k, v = rand((VLM_TRAIN_B, hkv, s, d), f32), rand((VLM_TRAIN_B, hkv, s, d), f32)
    dout, kw = rand(q.shape, f32), dict(causal=True)
    shape = f"q {list(q.shape)}, k/v {list(k.shape)} f32 causal"
    route, bwd_route = fa._route(q, k, grad=True), fa._bwd_route(q)
    check((route, bwd_route) == ("f32", "cuda_core"), f"internvl2's f32 step routed to {route}/{bwd_route}")
    before = fa.ROUTE_LAUNCHES["f32"].value
    o, lse = fa.launch_route("f32", q, k, v, with_lse=True, **kw)
    again = fa.launch_route("f32", q, k, v, with_lse=True, **kw)
    check(fa.ROUTE_LAUNCHES["f32"].value == before + 2, "f32 route not launched on internvl2's training shape")
    fwd_err = held(f"internvl2 training forward G 2 {shape}, with the lse", "f32", o, again[0],
                   fa.attention_plain(q, k, v, **kw), tol)
    lse_want = fa.attention_lse_plain(q, k, **kw)
    lse_ratio = float(((lse - lse_want).abs() / (2e-5 + 2e-5 * lse_want.abs())).max())
    emit("flash_lse_check", case=f"internvl2 training forward {shape}", err_over_tol=lse_ratio,
         bit_equal_rerun=bool(torch.equal(lse, again[1])))
    check(lse_ratio <= 1.0 and torch.equal(lse, again[1]), "f32 route's lse != logsumexp of the plain scores on "
          "internvl2's training shape, or two runs differ")
    label = f"internvl2 training backward G 2 {shape}"
    got, rerun = backward_twice(torch, fa, "cuda_core", label, q, k, v, o, lse, dout, kw)
    bwd_err = held_backward(torch, label, "cuda_core", got, rerun,
                            fa.attention_backward_plain(q, k, v, o, lse, dout, **kw), q, k, v, tol)
    k16, v16 = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
    leaves = [t.clone().requires_grad_() for t in (q, k16, v16)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    calls = {"forward": lambda: fa.launch_route("f32", q, k, v, with_lse=True, **kw),
             "forward_plain": lambda: fa.attention_plain(q, k, v, **kw),
             "forward_sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
             "backward": lambda: fa.launch_backward(q, k, v, o, lse, dout, **kw),
             "backward_plain": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, **kw),
             "backward_sdpa": lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)}
    cold = {n: cold_ms(torch, f, flush, reps=5 if n.endswith("plain") else 20) for n, f in calls.items()}
    bounds = {"forward": flash_bound_ms(q, k, s, True, 0, bw, peak=F32_TFLOPS),
              "backward": bwd_bound_ms(q, k, s, True, 0, bw, F32_TFLOPS)}
    for part, (err, route_) in (("forward", (fwd_err, "f32")), ("backward", (bwd_err, "cuda_core"))):
        bound, by, flops, nbytes = bounds[part]
        out[f"train_{part}"] = dict(
            route=route_, shape=shape + (", with the lse" if part == "forward" else ""), ms=cold[part],
            plain_ms=cold[f"{part}_plain"], library_ms=cold[f"{part}_sdpa"],
            library=f"scaled_dot_product_attention {part} f32" + (", K/V repeated to 16 heads" if part == "backward"
                                                                  else ", enable_gqa"),
            bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, max_abs_err=err[0], err_over_tol=err[1])
        emit("flash_internvl2_times", case=f"train_{part}", **out[f"train_{part}"])
    out["train_forward"]["lse_err_over_tol"] = lse_ratio
    del q, k, v, dout, o, lse, again, got, rerun, k16, v16, leaves, sdpa_out, calls, flush
    torch.cuda.empty_cache()
    return out


#: hubert-xlarge's attention (16 query and 16 KV heads of 80) at the edges
#: phase 2 holds its four head_dim-80 kernels to, beside phase 15's launch
#: shapes: (b, hq, hkv, sq, sk, causal, q_offset, kv_len, window, softcap);
#: S = 77, causal and not, G 1, 2 and 4, a softcap of 50, windows of 64 and
#: 4096, q_offset > 0, kv_len < Sk with NaN in the slots past it
HUBERT_EDGES = [
    (2, 16, 16, 77, 77, False, 0, None, 0, 0.0),
    (2, 16, 16, 77, 77, True, 0, None, 0, 0.0),
    (1, 16, 8, 300, 300, False, 0, None, 0, 50.0),
    (1, 16, 4, 300, 300, True, 0, None, 64, 0.0),
    (1, 16, 16, 64, 400, True, 300, 364, 0, 0.0),
    (1, 16, 8, 200, 260, False, 0, 230, 4096, 0.0),
]


def hubert_attention_checks(torch, dev, bw: float) -> dict:
    """hubert-xlarge's attention at head_dim 80 on the four kernels phase 15
    launches, each held to its plain version at phase 2's tolerances and
    run twice for bit-equal results: first at phase 15's launch shapes,
    bidirectional at G 1 (the tensor_core forward at the encode's
    [8,16/16,1000,80] bf16 without and with the lse, the tensor_core
    backward at the bf16 step's [4,16/16,1000,80] on its forward's output,
    the f32 forward with its lse at ``launch.train``'s f32 step,
    [2,16/16,1000,80], and the cuda_core backward on that output), then at
    ``HUBERT_EDGES`` (bf16 on the tensor_core forward and backward, f32 and
    f16 on the f32 forward and the cuda_core backward). Each launch shape is
    timed with the L2 cold beside the plain version and SDPA (its backend
    named), with the bound at the true width 80 and the inputs' peak; the
    backwards also by kernel."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config("hubert-xlarge")
    hq, hkv, d, s = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, AUDIO_FRAMES
    check(d == 80 and hq == hkv, f"hubert-xlarge's attention: {hq}/{hkv} heads of {d}")
    g = torch.Generator(device=dev).manual_seed(SEED + 160)

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    worst = {}

    def note(key, err):
        worst[key] = tuple(max(a, b) for a, b in zip(worst.get(key, (0.0, 0.0)), err))

    def forward(label, route, q, k, v, kz, vz, kw, with_lse=True):
        tol = FLASH_TOL[str(q.dtype).split(".")[1]]
        before = fa.ROUTE_LAUNCHES[route].value
        got, again = (fa.launch_route(route, q, k, v, with_lse=with_lse, **kw) for _ in range(2))
        check(fa.ROUTE_LAUNCHES[route].value == before + 2, f"{route} not launched on {label}")
        out, out2 = (got[0], again[0]) if with_lse else (got, again)
        want = fa.attention_plain(q, kz, vz, **kw).float()
        diff = (out.float() - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())
        same = bool(torch.equal(out, out2))
        lse_ratio = None
        if with_lse:
            lse_want = fa.attention_lse_plain(q, kz, **kw)
            lse_ratio = float(((got[1] - lse_want).abs() / (2e-5 + 2e-5 * lse_want.abs())).max())
            same = same and bool(torch.equal(got[1], again[1]))
        emit("flash_check", case=label, route=route, max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio,
             lse_err_over_tol=lse_ratio, bit_equal_rerun=same)
        check(ratio <= 1.0 and (lse_ratio is None or lse_ratio <= 1.0) and bool(torch.isfinite(out).all()),
              f"{route} != plain version on {label}")
        check(same, f"two runs of the {route} route differ on {label}")
        note(route, (float(diff.max()), max(ratio, lse_ratio or 0.0)))
        return got

    def backward(label, route, q, k, v, kz, vz, o, lse, dout, kw):
        tol = FLASH_TOL[str(q.dtype).split(".")[1]]
        check(fa._bwd_route(q) == route, f"{label}: backward routed to {fa._bwd_route(q)}")
        got, again = backward_twice(torch, fa, route, label, q, k, v, o, lse, dout, kw)
        want = fa.attention_backward_plain(q, kz, vz, o, lse, dout, **kw)
        note(f"bwd/{route}", held_backward(torch, label, route, got, again, want, q, k, v, tol))

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {}

    def sdpa_ms(call):
        backend = sdpa_backend(torch, call)
        with sdpa_kernel([backend]):
            return cold_ms(torch, call, flush), str(backend)

    # phase 15's launch shapes: the encode, the bf16 step, launch.train's f32 step
    bf16, f32, kw = torch.bfloat16, torch.float32, dict(causal=False)
    q = rand((AUDIO_B, hq, s, d), bf16)
    k, v = rand((AUDIO_B, hkv, s, d), bf16), rand((AUDIO_B, hkv, s, d), bf16)
    shape = f"q {list(q.shape)}, k/v {list(k.shape)} bf16 bidirectional"
    check(fa._route(q, k) == fa._route(q, k, grad=True) == "tensor_core",
          f"hubert's encode routed to {fa._route(q, k)}")
    forward(f"hubert encode {shape}", "tensor_core", q, k, v, k, v, kw, with_lse=False)
    forward(f"hubert encode {shape}, with the lse", "tensor_core", q, k, v, k, v, kw)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
    library_ms, backend = sdpa_ms(sdpa)
    bound, by, flops, nbytes = flash_bound_ms(q, k, s, False, 0, bw)
    encode = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    out["encode"] = dict(route="tensor_core", shape=shape, ms=cold_ms(torch, encode, flush),
                         warm_device_ms=device_ms(torch, encode),
                         plain_ms=cold_ms(torch, lambda: fa.attention_plain(q, k, v, **kw), flush, reps=5),
                         library_ms=library_ms, library=f"scaled_dot_product_attention ({backend})",
                         bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                         sdpa_max_abs_diff=float((sdpa().float() - encode().float()).abs().max()))
    emit("flash_hubert_times", case="encode", **out["encode"])
    del q, k, v

    for label, dtype, b, fwd_route, bwd_route in (("train_bf16", bf16, AUDIO_TRAIN_B, "tensor_core", "tensor_core"),
                                                  ("train_f32", f32, AUDIO_F32_B, "f32", "cuda_core")):
        q = rand((b, hq, s, d), dtype)
        k, v = rand((b, hkv, s, d), dtype), rand((b, hkv, s, d), dtype)
        dout = rand(q.shape, dtype)
        name = str(dtype).split(".")[1]
        shape = f"q {list(q.shape)}, k/v {list(k.shape)} {name} bidirectional"
        check((fa._route(q, k, grad=True), fa._bwd_route(q)) == (fwd_route, bwd_route),
              f"hubert's {label} routed to {fa._route(q, k, grad=True)}/{fa._bwd_route(q)}")
        o, lse = forward(f"hubert {label} forward {shape}, with the lse", fwd_route, q, k, v, k, v, kw)
        backward(f"hubert {label} backward {shape}", bwd_route, q, k, v, k, v, o, lse, dout, kw)
        peak = BF16_TFLOPS if dtype == bf16 else F32_TFLOPS
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        bwd_backend = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(*leaves))
        with sdpa_kernel([bwd_backend]):  # the backward runs the backend its forward took
            sdpa_out = F.scaled_dot_product_attention(*leaves)
        calls = {"forward": lambda: fa.launch_route(fwd_route, q, k, v, with_lse=True, **kw),
                 "backward": lambda: fa.launch_backward(q, k, v, o, lse, dout, **kw)}
        plain = {"forward": lambda: fa.attention_plain(q, k, v, **kw),
                 "backward": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, **kw)}
        sdpas = {"forward": lambda: F.scaled_dot_product_attention(q, k, v),
                 "backward": lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)}
        bounds = {"forward": flash_bound_ms(q, k, s, False, 0, bw, peak=peak),
                  "backward": bwd_bound_ms(q, k, s, False, 0, bw, peak)}
        for part, route in (("forward", fwd_route), ("backward", bwd_route)):
            if part == "forward" and dtype == bf16:
                continue  # the encode's kernel at twice the batch, timed above
            if part == "forward":
                library_ms, backend = sdpa_ms(sdpas[part])
            else:
                library_ms, backend = cold_ms(torch, sdpas[part], flush), str(bwd_backend)
            bound, by, flops, nbytes = bounds[part]
            key = f"{label}_{part}"
            out[key] = dict(route=route, shape=shape + (", with the lse" if part == "forward" else ""),
                            ms=cold_ms(torch, calls[part], flush), warm_device_ms=device_ms(torch, calls[part]),
                            plain_ms=cold_ms(torch, plain[part], flush, reps=5), library_ms=library_ms,
                            library=f"scaled_dot_product_attention {part} ({backend})", bound_ms=bound, bound_by=by,
                            flops=flops, bytes=nbytes)
            if part == "backward":
                out[key]["kernels_ms"] = kernel_split_ms(torch, calls[part], flush)
            emit("flash_hubert_times", case=key, **out[key])
        del q, k, v, dout, o, lse, leaves, sdpa_out, calls, plain, sdpas
        torch.cuda.empty_cache()

    # the edges, on all four kernels (f16 on the CUDA-core pair)
    for b, hq_, hkv_, sq, sk, causal, q_offset, kv_len, window, cap in HUBERT_EDGES:
        ekw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=cap)
        for dtype, fwd_route, bwd_route in ((bf16, "tensor_core", "tensor_core"), (f32, "f32", "cuda_core"),
                                            (torch.float16, "f32", "cuda_core")):
            q = rand((b, hq_, sq, d), dtype)
            k, v = rand((b, hkv_, sk, d), dtype), rand((b, hkv_, sk, d), dtype)
            kz, vz = k, v
            if kv_len is not None:
                q, k, v, kz, vz = nan_tail((q, k, v), kv_len)
            dout = rand(q.shape, dtype)
            label = (f"hubert edge G {hq_ // hkv_} q {list(q.shape)}, k/v {list(k.shape)} {str(dtype).split('.')[1]} "
                     f"causal {causal} q_offset {q_offset} kv_len {kv_len} window {window} softcap {cap}")
            check(fa._route(q, k, grad=True) == fwd_route, f"{label}: routed to {fa._route(q, k, grad=True)}")
            o, lse = forward(label, fwd_route, q, k, v, kz, vz, ekw)
            backward(label + " backward", bwd_route, q, k, v, kz, vz, o, lse, dout, ekw)
            del q, k, v, kz, vz, dout, o, lse
    del flush
    torch.cuda.empty_cache()
    for key, entry in (("tensor_core", out["encode"]), ("f32", out["train_f32_forward"]),
                       ("bwd/tensor_core", out["train_bf16_backward"]), ("bwd/cuda_core", out["train_f32_backward"])):
        entry.update(max_abs_err=worst[key][0], err_over_tol=worst[key][1])
    return out


#: the decode kernel at head_dim 80 (zamba2's 32 query and 32 KV heads, G 1)
#: at the edges phase 2 holds it to: (b, sq, sk, causal, q_offset, kv_len,
#: window, softcap); kv_len 1, 63, 64, 65 and 576 behind the 576 slots a
#: served decode step attends over, the 4096-slot ring (causal=False, every
#: slot live, and a ring not yet full with a softcap), a window, and a chunk
#: of 4 rows; K and V past kv_len hold NaN
HYBRID_DECODE_EDGES = [
    (8, 1, 576, True, 0, 1, 0, 0.0),
    (8, 1, 576, True, 62, 63, 0, 0.0),
    (8, 1, 576, True, 63, 64, 0, 0.0),
    (8, 1, 576, True, 64, 65, 0, 0.0),
    (8, 1, 576, True, 575, 576, 0, 0.0),
    (8, 1, 4096, False, 0, 4096, 0, 0.0),
    (8, 1, 4096, False, 0, 2000, 0, 30.0),
    (4, 1, 1024, True, 899, 900, 256, 0.0),
    (4, 4, 600, True, 500, 504, 0, 0.0),
]


def hybrid_attention_checks(torch, dev, bw: float) -> dict:
    """zamba2-2.7b's shared-block attention at head_dim 80 (32 query and 32
    KV heads) on the kernels phase 16 launches, each held to its plain
    version at phase 2's tolerances and run twice for bit-equal results.
    The decode route's split kernel at 80 (new here), in bf16 and f32, at
    ``HYBRID_DECODE_EDGES`` and at phase 16's launch shapes: a served decode
    step, q [8,32,1,80] against k/v [8,32,576,80] bf16, and a ring step at
    the published window, q [8,32,1,80] f32 against an f32 ring of 4096
    live slots (``causal=False``), each timed with the L2 cold beside the
    plain version, SDPA (its backend named) and the bound (the live K/V
    bytes over the memory rate). Then the other three head_dim-80 kernels,
    causal (phase 2 holds them bidirectional at hubert's shapes): the tensor_core forward
    at the served prefill, q/k/v [8,32,512,80] bf16; the tensor_core forward
    with its lse and backward at the GRPO step's [4,32,576,80] bf16; the
    f32 forward with its lse and the cuda_core backward at ``launch.train``'s
    f32 step, [2,32,512,80]; each timed the same way, the backwards also by
    kernel. Every decode-sized call must count on ``ROUTE_LAUNCHES["decode"]``."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config("zamba2-2.7b")
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    check(d == 80 and hq == hkv, f"zamba2's attention: {hq}/{hkv} heads of {d}")
    g = torch.Generator(device=dev).manual_seed(SEED + 190)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(dtype)

    worst = {}

    def note(key, err):
        worst[key] = tuple(max(a, b) for a, b in zip(worst.get(key, (0.0, 0.0)), err))

    def forward(label, route, q, k, v, kz, vz, kw, with_lse=True):
        tol = FLASH_TOL[str(q.dtype).split(".")[1]]
        before = fa.ROUTE_LAUNCHES[route].value
        if route == "decode":  # through the wrapper, which must pick it
            check(fa._route(q, k) == "decode", f"{label}: routed to {fa._route(q, k)}")
            got, again = (fa.flash_attention(q, k, v, **kw) for _ in range(2))
        else:
            got, again = (fa.launch_route(route, q, k, v, with_lse=with_lse, **kw) for _ in range(2))
        check(fa.ROUTE_LAUNCHES[route].value == before + 2, f"{route} not launched on {label}")
        out, out2 = (got[0], again[0]) if with_lse and route != "decode" else (got, again)
        want = fa.attention_plain(q, kz, vz, **kw).float()
        diff = (out.float() - want).abs()
        ratio = float((diff / (tol + tol * want.abs())).max())
        same = bool(torch.equal(out, out2))
        lse_ratio = None
        if with_lse and route != "decode":
            lse_want = fa.attention_lse_plain(q, kz, **kw)
            lse_ratio = float(((got[1] - lse_want).abs() / (2e-5 + 2e-5 * lse_want.abs())).max())
            same = same and bool(torch.equal(got[1], again[1]))
        emit("flash_check", case=label, route=route, max_abs_err=float(diff.max()), tol=tol, err_over_tol=ratio,
             lse_err_over_tol=lse_ratio, bit_equal_rerun=same)
        check(ratio <= 1.0 and (lse_ratio is None or lse_ratio <= 1.0) and bool(torch.isfinite(out).all()),
              f"{route} != plain version on {label}")
        check(same, f"two runs of the {route} route differ on {label}")
        note(route, (float(diff.max()), max(ratio, lse_ratio or 0.0)))
        return got

    def backward(label, route, q, k, v, o, lse, dout, kw):
        tol = FLASH_TOL[str(q.dtype).split(".")[1]]
        check(fa._bwd_route(q) == route, f"{label}: backward routed to {fa._bwd_route(q)}")
        got, again = backward_twice(torch, fa, route, label, q, k, v, o, lse, dout, kw)
        want = fa.attention_backward_plain(q, k, v, o, lse, dout, **kw)
        note(f"bwd/{route}", held_backward(torch, label, route, got, again, want, q, k, v, tol))

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {}

    def sdpa_ms(call):
        backend = sdpa_backend(torch, call)
        with sdpa_kernel([backend]):
            return cold_ms(torch, call, flush), str(backend)

    # the decode kernel at 80: the edges in both dtypes
    decode_before = fa.ROUTE_LAUNCHES["decode"].value
    n_decode = 0
    for b, sq, sk, causal, q_offset, kv_len, window, cap in HYBRID_DECODE_EDGES:
        kw = dict(causal=causal, q_offset=q_offset, kv_len=kv_len, window=window, softcap=cap)
        for dtype in (bf16, f32):
            q = rand((b, hq, sq, d), dtype)
            k, v = rand((b, hkv, sk, d), dtype), rand((b, hkv, sk, d), dtype)
            kz, vz = k, v
            if kv_len < sk:
                q, k, v, kz, vz = nan_tail((q, k, v), kv_len)
            label = (f"zamba2 decode edge q {list(q.shape)}, k/v {list(k.shape)} {str(dtype).split('.')[1]} "
                     f"causal {causal} q_offset {q_offset} kv_len {kv_len} window {window} softcap {cap}")
            forward(label, "decode", q, k, v, kz, vz, kw, with_lse=False)
            n_decode += 2
            del q, k, v, kz, vz
    counted = fa.ROUTE_LAUNCHES["decode"].value - decode_before
    check(counted == n_decode, f"the decode route counted {counted} of the {n_decode} calls at head_dim 80")

    # phase 16's decode shapes, timed: the served step (bf16, 576 slots) and the ring at 4096 (f32)
    for key, dtype, sk, kw in (("decode", bf16, HYBRID_PROMPT + HYBRID_GEN,
                                dict(causal=True, q_offset=HYBRID_PROMPT + HYBRID_GEN - 1)),
                               ("ring", f32, cfg.sliding_window, dict(causal=False))):
        q = rand((HYBRID_B, hq, 1, d), dtype)
        k, v = rand((HYBRID_B, hkv, sk, d), dtype), rand((HYBRID_B, hkv, sk, d), dtype)
        name = str(dtype).split(".")[1]
        shape = f"q {list(q.shape)}, k/v {list(k.shape)} {name}" + (", ring (causal=False)" if key == "ring" else "")
        forward(f"zamba2 {key} {shape}", "decode", q, k, v, k, v, kw, with_lse=False)
        call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731 (every key visible: no mask)
        library_ms, backend = sdpa_ms(sdpa)
        bound, by, flops, nbytes = flash_bound_ms(q, k, sk, kw["causal"], kw.get("q_offset", 0), bw,
                                                  peak=BF16_TFLOPS if dtype == bf16 else F32_TFLOPS)
        out[key] = dict(route="decode", shape=shape, ms=cold_ms(torch, call, flush), warm_device_ms=device_ms(torch, call),
                        plain_ms=cold_ms(torch, lambda: fa.attention_plain(q, k, v, **kw), flush, reps=5),
                        library_ms=library_ms, library=f"scaled_dot_product_attention ({backend})",
                        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                        sdpa_max_abs_diff=float((sdpa().float() - call().float()).abs().max()))
        emit("flash_zamba2_times", case=key, **out[key])
        del q, k, v

    # the prefill: the tensor_core forward, causal
    s = HYBRID_PROMPT
    q = rand((HYBRID_B, hq, s, d), bf16)
    k, v = rand((HYBRID_B, hkv, s, d), bf16), rand((HYBRID_B, hkv, s, d), bf16)
    shape = f"q {list(q.shape)}, k/v {list(k.shape)} bf16 causal"
    kw = dict(causal=True)
    check(fa._route(q, k) == "tensor_core", f"zamba2's prefill routed to {fa._route(q, k)}")
    forward(f"zamba2 prefill {shape}", "tensor_core", q, k, v, k, v, kw, with_lse=False)
    call = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    library_ms, backend = sdpa_ms(sdpa)
    bound, by, flops, nbytes = flash_bound_ms(q, k, s, True, 0, bw)
    out["prefill"] = dict(route="tensor_core", shape=shape, ms=cold_ms(torch, call, flush),
                          warm_device_ms=device_ms(torch, call),
                          plain_ms=cold_ms(torch, lambda: fa.attention_plain(q, k, v, **kw), flush, reps=5),
                          library_ms=library_ms, library=f"scaled_dot_product_attention is_causal ({backend})",
                          bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                          sdpa_max_abs_diff=float((sdpa().float() - call().float()).abs().max()))
    emit("flash_zamba2_times", case="prefill", **out["prefill"])
    del q, k, v

    # the GRPO step (bf16) and launch.train's f32 step: forward with the lse, backward
    for label, dtype, b, s, fwd_route, bwd_route in (
            ("train_bf16", bf16, HYBRID_RL_PROMPTS * HYBRID_RL_GROUP, PROMPT_LEN + GEN_LEN, "tensor_core", "tensor_core"),
            ("train_f32", f32, HYBRID_TRAIN_B, HYBRID_TRAIN_SEQ, "f32", "cuda_core")):
        q = rand((b, hq, s, d), dtype)
        k, v = rand((b, hkv, s, d), dtype), rand((b, hkv, s, d), dtype)
        dout = rand(q.shape, dtype)
        name = str(dtype).split(".")[1]
        shape = f"q {list(q.shape)}, k/v {list(k.shape)} {name} causal"
        check((fa._route(q, k, grad=True), fa._bwd_route(q)) == (fwd_route, bwd_route),
              f"zamba2's {label} routed to {fa._route(q, k, grad=True)}/{fa._bwd_route(q)}")
        o, lse = forward(f"zamba2 {label} forward {shape}, with the lse", fwd_route, q, k, v, k, v, kw)
        backward(f"zamba2 {label} backward {shape}", bwd_route, q, k, v, o, lse, dout, kw)
        peak = BF16_TFLOPS if dtype == bf16 else F32_TFLOPS
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        bwd_backend = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(*leaves, is_causal=True))
        with sdpa_kernel([bwd_backend]):  # the backward runs the backend its forward took
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)
        calls = {"forward": lambda: fa.launch_route(fwd_route, q, k, v, with_lse=True, **kw),
                 "backward": lambda: fa.launch_backward(q, k, v, o, lse, dout, **kw)}
        plain = {"forward": lambda: fa.attention_plain(q, k, v, **kw),
                 "backward": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, **kw)}
        sdpas = {"forward": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                 "backward": lambda: torch.autograd.grad(sdpa_out, leaves, dout, retain_graph=True)}
        bounds = {"forward": flash_bound_ms(q, k, s, True, 0, bw, peak=peak),
                  "backward": bwd_bound_ms(q, k, s, True, 0, bw, peak)}
        for part, route in (("forward", fwd_route), ("backward", bwd_route)):
            if part == "forward":
                library_ms, backend = sdpa_ms(sdpas[part])
            else:
                library_ms, backend = cold_ms(torch, sdpas[part], flush), str(bwd_backend)
            bound, by, flops, nbytes = bounds[part]
            key = f"{label}_{part}"
            out[key] = dict(route=route, shape=shape + (", with the lse" if part == "forward" else ""),
                            ms=cold_ms(torch, calls[part], flush), warm_device_ms=device_ms(torch, calls[part]),
                            plain_ms=cold_ms(torch, plain[part], flush, reps=5), library_ms=library_ms,
                            library=f"scaled_dot_product_attention {part} is_causal ({backend})", bound_ms=bound,
                            bound_by=by, flops=flops, bytes=nbytes)
            if part == "backward":
                out[key]["kernels_ms"] = kernel_split_ms(torch, calls[part], flush)
            emit("flash_zamba2_times", case=key, **out[key])
        del q, k, v, dout, o, lse, leaves, sdpa_out, calls, plain, sdpas
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    for key, entry in (("decode", out["decode"]), ("tensor_core", out["prefill"]), ("f32", out["train_f32_forward"]),
                       ("bwd/tensor_core", out["train_bf16_backward"]), ("bwd/cuda_core", out["train_f32_backward"])):
        entry.update(max_abs_err=worst[key][0], err_over_tol=worst[key][1])
    out["ring"].update(max_abs_err=worst["decode"][0], err_over_tol=worst["decode"][1])
    out["train_bf16_forward"].update(max_abs_err=worst["tensor_core"][0], err_over_tol=worst["tensor_core"][1])
    return out


#: phase 2's tensor of more than 2^31 elements: dbrx's stacked w_gate at
#: phase 11's 4 layers, [4, 16, 6144, 10752] in bf16 (4.23 G elements, 8.46 GB)
BIG_SHAPE = (4, 16, 6144, 10752)
#: bytes of the plain checksum's pieces: a multiple of 2^16 words, so every
#: piece's words carry the weights they carry in the whole buffer and the
#: pieces' sums add up to the whole's
PLAIN_PIECE_BYTES = 256 << 20


def big_tensor_checks(torch, dev, bw: float) -> dict:
    """``checksum_words`` and ``quantize_rows`` on a bf16 tensor of more
    than 2^31 elements (every index past 2^31 reached in 64 bits), each
    held bit-equal to its plain version: the checksum of the whole buffer
    against the plain version's sums over 256 MiB pieces folded mod 2^32,
    and its last 64 MiB (a view that starts past 2^32 bytes) against the
    plain version of the same view; every int8 row and scale against the
    plain version a 2^27-element piece at a time, its last rows among
    them. Each timed once on the whole tensor beside its bytes bound."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import quant as qk

    n = math.prod(BIG_SHAPE)
    check(n > 2**31, "the big tensor is not past 2^31 elements")
    g = torch.Generator(device=dev).manual_seed(SEED + 111)
    x = torch.empty(n, dtype=torch.bfloat16, device=dev)
    for i in range(0, n, GRAD_SLICE):
        x[i : i + GRAD_SLICE].normal_(generator=g).mul_(0.0128)
    raw = x.view(torch.uint8)
    out = {}

    got = ck.checksum_words(raw).to(torch.int64) & MASK32
    want = torch.zeros(2, dtype=torch.int64, device=dev)
    for i in range(0, raw.numel(), PLAIN_PIECE_BYTES):
        want = (want + ck.checksum_words_plain(raw[i : i + PLAIN_PIECE_BYTES])) & MASK32
    tail = raw[-(64 << 20):]
    tail_equal = torch.equal(ck.checksum_words(tail).to(torch.int64) & MASK32, ck.checksum_words_plain(tail))
    ms = time_ms(torch, lambda: ck.checksum_words(raw), reps=3, warmup=1)
    out["checksum"] = dict(shape=f"bfloat16{list(BIG_SHAPE)} as uint8[{raw.numel()}]", equal=torch.equal(got, want),
                           last_64_MiB_equal=tail_equal, ms=ms, bound_ms=raw.numel() / bw * 1e3)
    emit("checksum_check", case="past 2^31 elements", **out["checksum"])
    check(out["checksum"]["equal"] and tail_equal, "checksum kernel != plain version past 2^31 elements")

    q, scales = qk.quantize_rows(x)
    equal, pieces = True, 0
    for i in range(0, n, GRAD_SLICE):
        q2, s2 = qk.quantize_rows_plain(x[i : i + GRAD_SLICE])
        r = i // qk.ROW_LEN
        equal &= torch.equal(q[i : i + GRAD_SLICE], q2) and torch.equal(
            scales[r : r + s2.numel()].view(torch.int32), s2.view(torch.int32))
        pieces += 1
        del q2, s2
    ms = time_ms(torch, lambda: qk.quantize_rows(x), reps=3, warmup=1)
    rows = n // qk.ROW_LEN
    out["quantize_rows"] = dict(shape=f"bfloat16{list(BIG_SHAPE)}", equal=bool(equal), pieces=pieces, ms=ms,
                                bound_ms=(2 * n + n + 4 * rows) / bw * 1e3)
    emit("quant_check", case="past 2^31 elements", **out["quantize_rows"])
    check(equal, "quant kernel != plain version past 2^31 elements")
    del x, raw, q, scales
    torch.cuda.empty_cache()
    return out


#: bound on |port - reference| for logits and logprobs at full width in
#: bf16 (see PERF.md): the rollout's prefill/decode (flash kernel, decode
#: matmuls of one token a row) against a teacher-forced forward (plain
#: attention, whole-sequence matmuls) on the same bf16 weights
LOGIT_MAX_ABS, LOGIT_MEAN_ABS = 0.5, 0.05


def check_served_round(torch, reference, weights, rec, version, tag: str = "serve_check", chunk: int = 4,
                       gate: bool = True, patches=None) -> dict:
    """A served round's logprobs and every step's logits against a
    teacher-forced forward of the whole sequence on ``weights`` with the
    plain attention (``reference``), ``chunk`` sequences at a time; held
    to the ``LOGIT_*`` bounds unless ``gate`` is off. A VLM's requests
    carry ``patches`` ``[B, P, d_model]``, placed before the tokens."""
    seqs, lps, steps = rec["tokens"], rec["behavior_logprobs"], rec["step_logits"]
    plen = seqs.shape[1] - steps.shape[1]
    first = plen + (0 if patches is None else patches.shape[1])  # the first generated token's position
    lp_err, logit_max, logit_sum = 0.0, 0.0, 0.0
    for c in range(0, seqs.shape[0], chunk):
        batch = {"tokens": seqs[c : c + chunk]}
        if patches is not None:
            batch["patches"] = patches[c : c + chunk]
        with torch.no_grad():
            ref = reference.forward(weights, batch)
        ref = ref[:, first - 1 : -1]  # the logits each generated token was drawn from
        lp_ref = torch.log_softmax(ref, -1).gather(-1, seqs[c : c + chunk, plen:, None])[..., 0]
        lp_err = max(lp_err, float((lps[c : c + chunk] - lp_ref).abs().max()))
        d = (steps[c : c + chunk] - ref).abs()
        logit_max = max(logit_max, float(d.max()))
        logit_sum += float(d.double().sum())
        del ref, lp_ref, d
    logit_mean = logit_sum / steps.numel()
    res = dict(version=version, logprob_max_abs_err=lp_err, logit_max_abs_err=logit_max,
               logit_mean_abs_err=logit_mean, logit_abs_max=float(steps.abs().max()),
               all_finite=bool(torch.isfinite(steps).all()), mean_logprob=float(lps.mean()))
    if gate:
        emit(tag, **res)
        check_gates(res, version)
    return res


def check_gates(res: dict, version: int) -> None:
    check(res["all_finite"], f"v{version}: non-finite logits")
    lp_err, logit_max, logit_mean = res["logprob_max_abs_err"], res["logit_max_abs_err"], res["logit_mean_abs_err"]
    check(lp_err <= LOGIT_MAX_ABS, f"v{version}: logprob error {lp_err} > {LOGIT_MAX_ABS}")
    check(logit_max <= LOGIT_MAX_ABS, f"v{version}: logit error {logit_max} > {LOGIT_MAX_ABS}")
    check(logit_mean <= LOGIT_MEAN_ABS, f"v{version}: mean logit error {logit_mean} > {LOGIT_MEAN_ABS}")


def replay_round(torch, reference, weights, rec, prompt_len: int):
    """The served round's calls again with ``reference`` (the plain
    attention) on ``weights``: the prefill of its prompts, then one decode
    step a sampled token, as ``sample_responses`` made them; the logits
    each token was drawn from, ``[B, gen, vocab]`` f32."""
    seqs = rec["tokens"]
    steps = []
    with torch.no_grad():
        logits, cache, n = reference.prefill(weights, {"tokens": seqs[:, :prompt_len]}, max_len=seqs.shape[1])
        for t in range(prompt_len, seqs.shape[1]):
            steps.append(logits[:, -1].float())
            logits, cache = reference.decode(weights, cache, seqs[:, t : t + 1], n)
            n += 1
    return torch.stack(steps, 1)


class RecordedRoutes:
    """Within ``with``: every ``moe_apply`` call's experts (``top_e``) and
    router logits (f32), in call order, recorded where ``blocks.route``
    returns them, and the (token, slot) pairs routed and dropped over
    capacity (``blocks.DROPPED``, set to 0 on entry). With ``pins`` (an
    earlier record's experts, one entry a call, taken in turn) each call
    follows the pinned experts instead of its own top-k, weighted by its
    own probabilities."""

    def __init__(self, pins=None):
        self.pins = pins

    def __enter__(self):
        import torch

        from repro_torch.models import blocks

        self.blocks, self.route, self.calls, self.logits = blocks, blocks.route, [], []

        def recording(cfg, p, flat, experts=None):
            if self.pins is not None:
                experts = self.pins[len(self.calls) % len(self.pins)]
            top_p, top_e = self.route(cfg, p, flat, experts)
            with torch.no_grad():
                self.logits.append((flat.detach() @ p["router"].detach()).float())
            self.calls.append(top_e)
            return top_p, top_e

        blocks.DROPPED.reset()
        blocks.route = recording
        return self

    def __exit__(self, *exc):
        self.blocks.route = self.route
        self.routed, self.dropped = self.blocks.DROPPED.routed, self.blocks.DROPPED.dropped

    def flips(self, other: "RecordedRoutes") -> dict:
        """This record's expert sets against ``other``'s router logits on
        the same calls (``other`` pinned to this record, so both saw the
        same tokens routed alike): the token rows whose experts are not
        ``other``'s own top-k, and whether each is explained by the two
        runs' router-logit difference: the row's margin (``other``'s k-th
        largest logit less its least logit among this record's experts)
        at most twice the row's largest |logit difference|, so a tie
        within the difference decided it. Also the largest |difference|."""
        check(len(self.calls) <= len(other.calls), f"{len(self.calls)} MoE calls against {len(other.calls)}")
        rows = flipped = unexplained = 0
        worst_gap, worst_margin = 0.0, 0.0
        for top_e, mine, theirs in zip(self.calls, self.logits, other.logits):
            k = top_e.shape[-1]
            gap = (mine - theirs).abs().amax(-1)
            kth = theirs.topk(k, dim=-1).values[:, -1]
            margin = kth - theirs.gather(-1, top_e).amin(-1)
            own = (top_e.sort(-1).values != theirs.topk(k, dim=-1).indices.sort(-1).values).any(-1)
            rows += top_e.shape[0]
            flipped += int(own.sum())
            unexplained += int((own & (margin > 2 * gap + 1e-6)).sum())
            worst_gap = max(worst_gap, float(gap.max()))
            worst_margin = max(worst_margin, float(margin.max()))
        return dict(token_rows=rows, flipped_rows=flipped, unexplained_rows=unexplained,
                    router_logit_max_abs_diff=worst_gap, flip_margin_max=worst_margin)


def check_moe_round(torch, reference, weights, rec, version, served: RecordedRoutes, *, prompt_len: int,
                    tag: str, chunk: int = 4) -> dict:
    """A served round of a MoE model against a replay of its calls with the
    plain attention (``replay_round``) that follows the served routing.
    Two discrete choices would otherwise part the runs on noise: an
    expert's capacity follows each call's token count (a teacher-forced
    forward of the whole sequences routes more tokens at a larger capacity
    and drops other pairs), and a token whose router logits nearly tie
    picks its experts by the last bits (at random weights the tokens'
    router logits crowd together, PERF.md section 6). So the replay routes
    as many tokens a call and takes the served experts, weighted by its
    own probabilities: the logprobs and every step's logits are held to
    phase 5's ``LOGIT_*`` bounds, the router logits of the two to
    ``LOGIT_MAX_ABS``, both must drop the same number of pairs, and every
    token row whose served experts are not the replay's own top-k must be
    one whose margin the router-logit difference explains
    (``RecordedRoutes.flips``). The teacher-forced check
    (``check_served_round``) is held too where the served round and the
    forward both dropped nothing, and printed as not held otherwise."""
    seqs, lps, steps = rec["tokens"], rec["behavior_logprobs"], rec["step_logits"]
    with RecordedRoutes(pins=served.calls) as replayed:
        ref = replay_round(torch, reference, weights, rec, prompt_len)
    check(len(replayed.calls) == len(served.calls), f"v{version}: the replay made {len(replayed.calls)} MoE calls, "
          f"the served round {len(served.calls)}")
    lp_ref = torch.log_softmax(ref, -1).gather(-1, seqs[:, prompt_len:, None])[..., 0]
    d = (steps - ref).abs()
    res = dict(version=version, reference="replay of the served calls and routing, plain attention",
               logprob_max_abs_err=float((lps - lp_ref).abs().max()), logit_max_abs_err=float(d.max()),
               logit_mean_abs_err=float(d.double().mean()), logit_abs_max=float(steps.abs().max()),
               all_finite=bool(torch.isfinite(steps).all()), mean_logprob=float(lps.mean()),
               moe_calls=len(served.calls), routed_pairs=served.routed, dropped_pairs_served=served.dropped,
               dropped_pairs_replay=replayed.dropped, routing=served.flips(replayed))
    del ref, lp_ref, d
    with RecordedRoutes() as forward:
        tf = check_served_round(torch, reference, weights, rec, version, tag=f"{tag} teacher-forced", chunk=chunk,
                                gate=False)
    res["teacher_forced"] = dict(tf, dropped_pairs=forward.dropped,
                                 held=served.dropped == 0 and forward.dropped == 0)
    emit(tag, **res)
    check_gates(res, version)
    routing = res["routing"]
    check(routing["router_logit_max_abs_diff"] <= LOGIT_MAX_ABS,
          f"v{version}: router logits {routing['router_logit_max_abs_diff']} apart from the replay's")
    check(routing["unexplained_rows"] == 0, f"v{version}: {routing['unexplained_rows']} token rows took experts "
          "the router-logit difference does not explain")
    check(res["dropped_pairs_served"] == res["dropped_pairs_replay"],
          f"v{version}: the replay, routed alike, dropped {res['dropped_pairs_replay']} pairs, "
          f"the served round {res['dropped_pairs_served']}")
    if res["teacher_forced"]["held"]:
        check_gates(tf, version)
    return res


def routes_of(cfg, pins=None):
    """``RecordedRoutes`` (following ``pins``) for a MoE model, else a
    context that records nothing."""
    import contextlib

    return RecordedRoutes(pins) if cfg.moe is not None else contextlib.nullcontext()


def check_round(torch, cfg, reference, weights, rec, version, served, *, tag: str, chunk: int = 4) -> dict:
    """A served round held to phase 5's gates: against a replay of its
    calls for a MoE model (``check_moe_round``), else against a
    teacher-forced forward (``check_served_round``)."""
    if cfg.moe is None:
        return check_served_round(torch, reference, weights, rec, version, tag=tag, chunk=chunk)
    prompt_len = rec["tokens"].shape[1] - rec["step_logits"].shape[1]
    return check_moe_round(torch, reference, weights, rec, version, served, prompt_len=prompt_len, tag=tag,
                           chunk=chunk)


def device_profile(torch, fn, *, cpu: bool = True) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device time
    of its kernels by name: busy seconds (kernels of one stream do not
    overlap), the wall seconds ended by a synchronize, the idle share, and
    the kernels that took the most time. A session that records no device
    activity is retried (``traced``), so ``fn`` may run more than once.
    ``cpu=False`` records the device's activity alone: the same kernels,
    and far fewer events to read back where a call launches ~100k kernels
    (the xLSTM's sLSTM loop)."""
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu else [ProfilerActivity.CUDA]
    events, wall = traced(torch, fn, activities)
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() * 1e-6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_by_name = {n[:60]: t for n, t in by_name.items() if "flash" in n}  # every route's kernels
    flash = sum(flash_by_name.values())
    by_class = {}
    for n, t in by_name.items():
        c = kernel_class(n)
        by_class[c] = by_class.get(c, 0.0) + t
    return dict(wall_seconds=wall, device_busy_seconds=busy,
                idle_share=(1 - busy / wall) if busy else None, flash_seconds=flash,
                flash_share_of_busy=flash / busy if busy else None, flash_kernels=flash_by_name,
                by_class={c: dict(seconds=t, share=t / busy) for c, t in by_class.items()} if busy else {},
                kernels=len(by_name), top=[dict(name=n[:90], seconds=t, share=t / busy) for n, t in top])


def kernel_class(name: str) -> str:
    """A kernel's class by its name: the port's kernels by theirs
    (csrc/*.cu),
    cuBLAS's GEMMs (``nvjet``, ``gemm``, ``sm90_xmma``), PyTorch's
    elementwise and copy kernels, its reductions (softmax, sums, norms)."""
    n = name.lower()
    if "flash_bwd" in n:
        return "flash backward"
    if "flash" in n:
        return "flash forward"
    if "mla_decode" in n:
        return "mla decode"
    if any(k in n for k in ("checksum_kernel", "quant_kernel", "gather_runs_kernel", "dequant_gather_kernel")):
        return "transfer kernels"
    if "nvjet" in n or "gemm" in n or "xmma" in n or "cutlass" in n:
        return "gemm"
    if "softmax" in n or "reduce" in n or "norm" in n:
        return "reduction"
    if "elementwise" in n or "copy" in n or "fill" in n or "index" in n or "scatter" in n or "gather" in n:
        return "elementwise"
    return "other"


def serve_two_rounds(torch, dev, counters, cfg, *, batch: int, prompt_len: int, gen_len: int, want_route: dict,
                     label: str, seed: int, ref_batch: int = 4, init=None, delta_base: bool = True,
                     want_latent: int = 0) -> dict:
    """``cfg`` at its published widths in bf16, served from a TensorHub
    replica: a trainer (dc0) publishes v0, a RolloutWorker (dc0, raw)
    replicates and answers round 0 (``batch`` requests of ``prompt_len``
    tokens + ``gen_len`` new); the trainer perturbs 1/8 of its rows and
    publishes v1, the worker updates in place and answers round 1 on the
    same prompts. Each round is held to phase 5's gates: the replica
    bit-equal to the trainer, every step's logits and the logprobs within
    ``LOGIT_*`` of a teacher-forced forward with the plain attention on
    the trainer's weights (``ref_batch`` sequences at a time), round 1
    apart from round 0, ``want_route`` flash launches by route a round and
    ``want_latent`` launches of the ``mla_decode`` kernel (an MLA model's
    decode steps; the plain reference runs ``mla_decode_plain`` there).
    ``init`` may rescale the seeded weights in place before they are
    registered; ``delta_base`` is the hub's (``TensorHubClient``).
    Returns the worker, the launches (read right after the rounds), the
    timings and the checks; then the prefill alone is timed."""
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import PromptSet
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES, attention_plain
    from repro_torch.kernels.mla_decode import LAUNCHES as LATENT_LAUNCHES
    from repro_torch.kernels.mla_decode import mla_decode_plain
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.rl.loop import RLConfig, RolloutWorker

    flash = counters["flash_attention"]
    torch.cuda.reset_peak_memory_stats(dev)
    for c in [*counters.values(), *ROUTE_LAUNCHES.values()]:
        c.reset()
    hub = TensorHubClient(ReferenceServer(), device=dev, delta_base=delta_base)
    trainer = hub.open("actor", "trainer", 1, 0, datacenter="dc0")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed), torch.bfloat16, dev)
    if init is not None:
        init(params)
    trainer.register(params)
    del params
    weights = trainer.store.tensors()
    nparams = sum(w.numel() for w in weights.values())
    emit("model", config=cfg.name, layers=cfg.num_layers, dtype="bfloat16", params=nparams,
         bytes=2 * nparams, init_seconds=time.perf_counter() - t0)
    trainer.publish(0)
    rl = RLConfig(model_name="actor", prompt_len=prompt_len, response_len=gen_len,
                  num_prompts=batch, group_size=1, seed=SEED)
    served = []  # the worker's out_queue, emptied after each round's checks
    worker = RolloutWorker("rollout-0", hub, rl, cfg, PromptSet(cfg.vocab, prompt_len, seed=SEED), served,
                           threading.Event(), datacenter="dc0", dtype=torch.bfloat16)
    reference = build_model(cfg, attention=attention_plain, latent_attention=mla_decode_plain)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    def equal_to_trainer(when):
        for n, w in trainer.store.tensors().items():
            check(torch.equal(worker.params[n], w), f"{label} {when}: rollout {n} != trainer")

    _, replicate_s = timed(lambda: worker.connect(timeout=600))
    equal_to_trainer("after replicate")
    rounds, checks = [], []
    per_round = sum(want_route.values())
    for step in range(2):
        if step:
            def perturb_and_publish():
                trainer.unpublish()
                gp = torch.Generator(device=dev).manual_seed(SEED + 31)
                for w in trainer.store.tensors().values():
                    flat = w.view(-1)
                    full = flat.numel() // 256 * 256
                    rows = flat[:full].view(-1, 256)[::8]  # 1/8 of the 256-element rows, in place
                    rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
                trainer.publish(1)

            _, publish_s = timed(perturb_and_publish)
            updated, update_s = timed(worker.pull_latest)
            check(updated and worker.weights_version == 1, f"{label}: the rollout did not update to v1")
            equal_to_trainer("after update")
        before = {k: c.value for k, c in counters.items()}
        before_route = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
        before_latent = LATENT_LAUNCHES.value
        with routes_of(cfg) as routing:
            rec, round_s = timed(lambda: worker.serve_batch(step, keep_logits=True))
        n = flash.value - before["flash_attention"]
        by_route = {r: c.value - before_route[r] for r, c in ROUTE_LAUNCHES.items()}
        latent = LATENT_LAUNCHES.value - before_latent
        check(n == per_round, f"{label} round {step}: {n} flash launches, want {per_round}")
        check(by_route == want_route, f"{label} round {step}: flash launches by route {by_route}, want {want_route}")
        check(latent == want_latent, f"{label} round {step}: {latent} mla_decode launches, want {want_latent}")
        check(rec["version"] == step, f"{label} round {step} served v{rec['version']}")
        rounds.append(dict(round=step, version=rec["version"], seconds=round_s, flash_launches=n,
                           flash_launches_by_route=by_route, mla_decode_launches=latent,
                           generated_tokens=batch * gen_len))
        mid = {k: c.value for k, c in counters.items()}
        checks.append(check_round(torch, cfg, reference, trainer.store.tensors(), rec, step, routing,
                                  tag="serve_check" if label == "llama3-8b" else f"serve_check {label}",
                                  chunk=ref_batch))
        check(mid == {k: c.value for k, c in counters.items()}, f"{label}: the checks launched a kernel")
        if step == 0:
            first0 = rec["step_logits"][:, 0].clone()  # the prompts' next-token logits under v0
        else:
            delta = float((rec["step_logits"][:, 0] - first0).abs().mean())
            emit("serve_v1_vs_v0", config=cfg.name, prompt_logits_mean_abs_diff=delta)
            check(delta > 10 * LOGIT_MEAN_ABS, f"{label}: round 1 logits barely differ from round 0's ({delta})")
        del rec
        served.clear()
    launches = {k: c.value for k, c in counters.items()}  # the main path's launches, read now
    launches["flash_attention_routes"] = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    check(launches["flash_attention"] == 2 * per_round, f"{label}: flash launches over the two rounds")

    # the prefill alone at the same shapes (launches after the read above)
    prompts = torch.from_numpy(worker.prompts.sample(batch, 1)).to(dev, torch.int64)
    prefill_s = statistics.median(
        timed(lambda: worker.model.prefill(worker.params, {"tokens": prompts}, max_len=prompt_len + gen_len))[1]
        for _ in range(3)
    )
    r1 = rounds[1]["seconds"]
    return dict(worker=worker, prompts=prompts, launches=launches, rounds=rounds, checks=checks, peak=peak,
                replicate_s=replicate_s, publish_s=publish_s, update_s=update_s, prefill_s=prefill_s,
                prefill_tokens_per_s=batch * prompt_len / prefill_s,
                decode_tokens_per_s=batch * gen_len / (r1 - prefill_s), round_tokens_per_s=batch * gen_len / r1)


def serving(torch, dev, counters, smi: str) -> dict:
    """llama3-8b at its published widths and all 32 layers in bf16,
    served from a TensorHub replica: a trainer (dc0) publishes v0, a
    RolloutWorker (dc0, raw) replicates and answers round 0; the trainer
    perturbs 1/8 of its rows and publishes v1, the worker updates and
    answers round 1 on the same prompts. Returns the kernels' launches on
    that path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import _route, launch_route
    from repro_torch.models.lm import DecoderLM

    cfg = get_config("llama3-8b")
    want_route = {"decode": cfg.num_layers * GEN_LEN, "tensor_core": cfg.num_layers, "f32": 0}
    res = serve_two_rounds(torch, dev, counters, cfg, batch=SERVE_BATCH, prompt_len=PROMPT_LEN, gen_len=GEN_LEN,
                           want_route=want_route, label="llama3-8b", seed=SEED + 30)
    worker, prompts, launches = res["worker"], res["prompts"], res["launches"]

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    # where a round's time goes: the prefill, then a few decode steps, profiled
    n_dec = min(8, GEN_LEN)
    cache = {}

    def prefill():
        cache["state"] = worker.model.prefill(worker.params, {"tokens": prompts}, max_len=PROMPT_LEN + GEN_LEN)

    def decode_steps():
        logits, kv, n = cache["state"]
        for _ in range(n_dec):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            logits, kv = worker.model.decode(worker.params, kv, nxt, n)
            n += 1

    emit("serve_profile", card=smi, prefill=device_profile(torch, prefill),
         decode_steps=n_dec, decode=device_profile(torch, decode_steps))

    # a decode step's wall time with its attention on the decode route and
    # on the f32 route's kernel, in turns on this host: the step is
    # host-bound and hosts differ between runs, so routes compare here only
    def f32_route_attention(q, k, v, **kw):
        return launch_route("f32" if q.shape[2] == 1 else _route(q, k), q, k, v, **kw)

    def step_ms(model):
        logits, kv, n = model.prefill(worker.params, {"tokens": prompts}, max_len=PROMPT_LEN + GEN_LEN)
        times = []
        for _ in range(n_dec):
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            (logits, kv), t = timed(lambda: model.decode(worker.params, kv, nxt, n))
            times.append(t * 1e3)
            n += 1
        return statistics.median(times)

    f32_model = DecoderLM(cfg, attention=f32_route_attention)
    steps_ms = {"decode route": step_ms(worker.model), "f32 route": step_ms(f32_model),
                "decode route again": step_ms(worker.model)}
    emit("serve_decode_step", card=smi, layers=cfg.num_layers, median_ms=steps_ms)
    del cache
    emit("serve_result", card=smi, replicate_seconds=res["replicate_s"], publish_v1_seconds=res["publish_s"],
         update_seconds=res["update_s"], rounds=res["rounds"],
         prefill_seconds=res["prefill_s"], prefill_tokens_per_s=res["prefill_tokens_per_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"], round_tokens_per_s=res["round_tokens_per_s"],
         max_memory_allocated=res["peak"], launches=launches, checks=res["checks"])
    return launches


# -- phase 6: the RL loop at full width (train -> publish -> update) --------------

TRAIN_LAYERS = 4  # of llama3-8b's 32: a trainer with f32 moments beside a replica and the step's logits
#: bound on each tensor's gradient against the reference step's (plain
#: attention, forward and backward by autograd), as the relative L2 error
#: |kernel step - reference| / |reference|. The two forwards differ at
#: bf16's rounding (the tensor-core kernel rounds P to bf16; phase 5
#: bounds the logits they give), and the logits are themselves bf16 matmul
#: outputs (an ulp is 2^-8 of |logit|, 0.016-0.03 at the |logit| of 4-6 a
#: random llama3-8b gives), so the log-softmax's gradient, which every
#: tensor's gradient carries, moves by a few percent where a logit rounds
#: the other way: 5e-2 is about three such ulps. The gradients of ``head``
#: and ``final_ln``, which no attention backward reaches, show that floor.
GRAD_TOL_PLAIN = 5e-2
#: bound on each tensor's gradient against a step with the same kernel
#: forward and the plain backward (``attention_backward_plain``), which
#: isolates the backward kernels: phase 2's norm (max |difference| over
#: max |value|) and bf16 tolerance (tests/test_kernels.py)
GRAD_TOL_BWD = 2e-2


def attention_widths(cfg) -> tuple:
    """(q/k, v) head_dims of a config's flash attention calls: MLA's
    expanded form's (qk_nope + qk_rope, v_head_dim), else the head_dim
    twice (``cfg.resolved_head_dim`` is d_model / heads for MLA, not the
    attention's width)."""
    if cfg.mla is not None:
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def attention_layers(cfg) -> int:
    """Attention calls in one pass through a config's model: one a layer,
    but the hybrid's one shared block after each group of
    ``ssm.shared_block_every`` Mamba2 blocks (zamba2: 9 of 54 layers), and
    none in the xLSTM (xlstm-350m)."""
    from repro_torch.configs.base import HYBRID, SSM

    if cfg.family == SSM:
        return 0
    return cfg.num_layers // cfg.ssm.shared_block_every if cfg.family == HYBRID else cfg.num_layers


def attention_windows(cfg) -> list:
    """The window each attention call of a pass gets: ``_layer_windows``'
    for the decoder, 0 for each of the hybrid's shared-block calls, none
    for the xLSTM."""
    from repro_torch.configs.base import HYBRID, SSM
    from repro_torch.models.lm import _layer_windows

    return [0] * attention_layers(cfg) if cfg.family in (HYBRID, SSM) else _layer_windows(cfg)


def grads_in_parts(torch, loss_fn, params, batch, budget):
    """``value_and_grad`` of ``loss_fn`` for a part of the tensors at a
    time, in registration order: yields ``(gradients of the part,
    metrics)``, each part's gradients at most ``budget`` bytes (a tensor
    larger than that alone; ``None``: every tensor at once). The other
    tensors take no gradient, so autograd computes none for them; the
    caller compares a part and drops it before the next is made."""
    parts, part, size = [], [], 0
    for n, p in params.items():
        nbytes = p.numel() * p.element_size()
        if part and budget is not None and size + nbytes > budget:
            parts.append(part)
            part, size = [], 0
        part.append(n)
        size += nbytes
    parts.append(part)
    for names in parts:
        leaves = {n: p.detach().requires_grad_(n in names) for n, p in params.items()}
        with torch.enable_grad():
            loss, metrics = loss_fn(leaves, batch)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[n] for n in names])))
        del loss, leaves
        yield grads, {k: v.detach() for k, v in metrics.items()}
        del grads


def backward_kernels_check(torch, fa, cfg, trainer, batch, grad_budget, label) -> dict:
    """The backward kernels alone, on the trainer's weights and ``batch``
    (the step's launches already read): the trainer's model against one
    whose attention runs the same kernel forward and the plain backward,
    each tensor's gradient within ``GRAD_TOL_BWD``. Returns the errors."""
    from repro_torch.models import build_model
    from repro_torch.training.steps import make_grpo_loss_fn

    class KernelForwardPlainBackward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, kw):
            out, lse = fa.launch_route(fa._route(q, k, grad=True, v=v), q, k, v, with_lse=True, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.kw = kw
            return out

        @staticmethod
        def backward(ctx, dout):
            return (*fa.attention_backward_plain(*ctx.saved_tensors, dout, **ctx.kw), None)

    isolated = build_model(cfg, attention=lambda q, k, v, **kw: KernelForwardPlainBackward.apply(q, k, v, kw))
    # the behavior logprobs of v1 itself, so every ratio is 1 and no clip
    # zeroes a gradient (against the served v0 logprobs a step may leave
    # every ratio clipped, and both gradients 0)
    with torch.no_grad():
        logits = trainer.model.forward(trainer.params, {"tokens": batch["tokens"]})
        lp = torch.log_softmax(logits[:, :-1].float(), -1).gather(-1, batch["tokens"][:, 1:, None])[..., 0]
        on_policy = dict(batch, behavior_logprobs=torch.where(batch["loss_mask"], lp, 0.0))
        del logits, lp
    # the two steps a part of the tensors at a time, each part compared and
    # dropped before the next
    bwd_errs, bwd_l2 = {}, {}
    for (g_kernel, m_kernel), (g_plain_bwd, m_plain_bwd) in zip(
            grads_in_parts(torch, make_grpo_loss_fn(trainer.model), trainer.params, on_policy, grad_budget),
            grads_in_parts(torch, make_grpo_loss_fn(isolated), trainer.params, on_policy, grad_budget)):
        check(torch.equal(m_kernel["loss"], m_plain_bwd["loss"]), f"{label}: the two steps' forwards differ")
        for n, g in g_kernel.items():
            check(float(g.abs().max()) > 0, f"{label} {n}: zero gradient in the backward kernels' check")
            bwd_errs[n] = grad_err(torch, g, g_plain_bwd[n])
            bwd_l2[n] = rel_l2(torch, g, g_plain_bwd[n])
        del g_kernel, g_plain_bwd, g
    emit("train_bwd_check", config=label, loss=float(m_kernel["loss"]), loss_plain_backward=float(m_plain_bwd["loss"]),
         grad_max_err_over_max=bwd_errs, grad_rel_l2=bwd_l2, tol=GRAD_TOL_BWD)
    for n, e in bwd_errs.items():
        check(e <= GRAD_TOL_BWD, f"{label} {n}: the backward kernels' gradient differs from the plain backward's by {e}")
    return bwd_errs


def rl_loop(torch, dev, counters, smi: str, *, cfg=None, num_prompts: int = 4, group_size: int = 4,
            init=None, grad_budget=None, delta_base: bool = True, dtype=None, grad_tol: float = GRAD_TOL_PLAIN,
            profile: bool = True) -> dict:
    """Paper Fig. 4 at a config's published widths in bf16 (``dtype``: the
    trainer's and the rollout's; in f32 the prefill and the step's forward
    take the ``f32`` route and the backward ``cuda_core``) (llama3-8b cut
    to 4 layers unless ``cfg`` is given): a TrainerWorker publishes v0
    (dc0); a RolloutWorker (dc0, raw) replicates it and serves round 0
    (``num_prompts`` x ``group_size`` responses of 512 prompt tokens + 64
    new); the trainer runs one GRPO step on the card (forward on the
    tensor-core flash route, the tensor-core backward kernels, AdamW in
    place) and publishes v1; the worker updates in place and serves round
    1. Every layer's attention in the step must get its window (the
    forward and the backward are recorded as they are called). ``init``
    may rescale the seeded weights in place before the trainer registers
    them. The gradient gates compare ``grad_budget`` bytes of reference
    gradients at a time (``grads_in_parts``; all at once by default): the
    reference step runs after the step, on the rollout's v0 replica, bit
    for bit the trainer's v0. A MoE model's served rounds are held against
    replays of their calls (``check_moe_round``); ``delta_base`` is the
    hub's. An MLA model (deepseek-v3) serves its decode steps on the
    ``mla_decode`` kernel (none on the decode route) and steps on the
    tensor-core forward and backward at (192, 128); its references decode
    with ``mla_decode_plain``. The hybrid (zamba2) attends once a group of
    Mamba2 blocks (``attention_layers``), through its shared block's
    weights. The xLSTM (xlstm-350m) attends nowhere: its reference runs the
    mLSTM on the quadratic parallel form (``mlstm="parallel"``) where the
    step runs the chunked form, its gradients held within ``grad_tol``
    (relative L2), and it launches no flash kernel (the backward kernels'
    isolated check has nothing to hold). ``profile`` runs a second step under
    the profiler (``train_profile``). Returns the kernels' launches on that
    path."""
    import numpy as np

    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import PromptSet
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, ROUTE_LAUNCHES, attention_plain
    from repro_torch.kernels.mla_decode import LAUNCHES as LATENT_LAUNCHES
    from repro_torch.kernels.mla_decode import mla_decode_plain
    from repro_torch.configs.base import HYBRID, SSM
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.rl.loop import RLConfig, RolloutWorker, TrainerWorker
    from repro_torch.training.steps import make_grpo_loss_fn

    cfg = cfg or dataclasses.replace(CONFIG, num_layers=TRAIN_LAYERS)
    label = cfg.name
    rl = RLConfig(model_name="actor", prompt_len=PROMPT_LEN, response_len=GEN_LEN, num_prompts=num_prompts,
                  group_size=group_size, seed=SEED + 50)
    bwd = {f"flash_attention_bwd_{n}": c for n, c in BWD_LAUNCHES.items()}
    routes = {f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()}
    every = {**counters, **bwd, **routes, "mla_decode": LATENT_LAUNCHES}
    widths = attention_widths(cfg)
    n_attn = attention_layers(cfg)  # attention calls a pass
    decode_steps = n_attn * GEN_LEN  # on the mla_decode kernel for MLA, else on the decode route
    torch.cuda.reset_peak_memory_stats(dev)
    for c in every.values():
        c.reset()

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    def counts():
        return {k: c.value for k, c in every.items()}

    hub = TensorHubClient(ReferenceServer(), device=dev, delta_base=delta_base)
    queue = []
    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    bwd_route = "tensor_core" if bf16 else "cuda_core"
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(rl.seed), dtype, dev)
    if init is not None:
        init(params)
    trainer, init_s = timed(lambda: TrainerWorker(hub, rl, cfg, queue, datacenter="dc0", dtype=dtype,
                                                  params=params, keep_grads=True))
    del params
    publish0_s = trainer.last_timings["publish_seconds"]
    nparams = sum(t.numel() for t in trainer.params.values())
    emit("model", config=label, layers=cfg.num_layers, dtype=str(dtype).split(".")[1], params=nparams,
         bytes=torch.finfo(dtype).bits // 8 * nparams,
         trainer_init_and_publish_seconds=init_s, publish_v0_seconds=publish0_s)
    worker = RolloutWorker("rollout-0", hub, rl, cfg, PromptSet(cfg.vocab, PROMPT_LEN, seed=SEED), queue,
                           threading.Event(), datacenter="dc0", dtype=dtype)
    hybrid, xlstm = cfg.family == HYBRID, cfg.family == SSM
    if xlstm:
        reference = build_model(cfg, mlstm="parallel")
    else:
        reference = build_model(cfg, attention=attention_plain,
                                **({} if hybrid else {"latent_attention": mla_decode_plain}))

    def replica_equals_trainer(when):
        for n, w in trainer.params.items():
            check(torch.equal(worker.params[n], w), f"{label} {when}: rollout {n} != trainer")

    _, replicate_s = timed(lambda: worker.connect(timeout=600))
    check(worker.weights_version == 0, f"{label}: the rollout did not replicate v0")
    replica_equals_trainer("v0")
    before = counts()
    with routes_of(cfg) as served0:
        rec0, round0_s = timed(lambda: worker.serve_batch(0, keep_logits=True))
    round0 = {k: v - before[k] for k, v in counts().items()}
    mla = cfg.mla is not None
    want0 = {"flash_route_tensor_core": n_attn * bf16, "flash_route_decode": 0 if mla else decode_steps,
             "flash_route_f32": n_attn * (not bf16), "mla_decode": decode_steps if mla else 0}
    check({k: round0[k] for k in want0} == want0, f"{label} round 0 launches {round0}, want {want0}")
    mid = counts()
    check0 = check_round(torch, cfg, reference, trainer.params, rec0, 0, served0, tag="rl_serve_check")
    check(mid == counts(), "the checks launched a kernel")
    served_rewards = rec0["rewards"].copy()
    # a random-weight model almost never continues the prompts' bigram
    # chains, so every reward is 0, every advantage is 0 and the step
    # (weight_decay 0) would change nothing: rewards from a seeded generator
    # stand in for a scorer, so the step moves every tensor
    rec0["rewards"] = np.random.default_rng(SEED + 51).random(rec0["rewards"].shape).astype(np.float32)
    print(f"{label}: round 0 rewards {served_rewards.tolist()} replaced by seeded uniform [0, 1) draws "
          "(a random-weight model scores 0, so the GRPO advantages and step would be 0)", flush=True)
    rollouts = trainer.wait_for_rollouts(1, timeout=60)
    batch = trainer.batch_from(rollouts)

    # the reference's first part once before the step as well, its
    # gradients dropped: the timed step then finds the caching allocator's
    # blocks and cuBLAS's plans warm, as when the whole reference step ran
    # first (the reference proper runs after the step, below)
    mid = counts()
    warm = grads_in_parts(torch, make_grpo_loss_fn(reference), trainer.params, batch, grad_budget)
    next(warm)
    warm.close()
    check(mid == counts(), "the reference step launched a flash kernel")

    # the step, with the window each layer's forward and backward get
    # recorded where the Function calls the kernels' wrappers
    windows = {"forward": [], "backward": []}
    wrappers = fa.launch_route, fa.launch_backward

    def launch_route(route, q, k, v, **kw):
        windows["forward"].append(int(kw.get("window", 0)))
        return wrappers[0](route, q, k, v, **kw)

    def launch_backward(*args, **kw):
        windows["backward"].append(int(kw.get("window", 0)))
        return wrappers[1](*args, **kw)

    before = counts()
    fa.launch_route, fa.launch_backward = launch_route, launch_backward
    try:
        with routes_of(cfg) as step_routes:
            metrics, train_s = timed(lambda: trainer.train_on(rollouts))
    finally:
        fa.launch_route, fa.launch_backward = wrappers
    step_s, publish1_s = trainer.last_timings["step_seconds"], trainer.last_timings["publish_seconds"]
    step_launches = {k: v - before[k] for k, v in counts().items()}
    launched = {f"{bwd_route}/{n}" for n in fa.bwd_kernels(*widths)}
    want = {"flash_route_tensor_core": n_attn * bf16, "flash_route_decode": 0, "flash_route_f32": n_attn * (not bf16),
            **{f"flash_attention_bwd_{n}": n_attn * (n in launched) for n in BWD_LAUNCHES}}
    check({k: step_launches[k] for k in want} == want, f"{label} GRPO step launches {step_launches}, want {want}")
    layer_windows = attention_windows(cfg)
    check(windows["forward"] == layer_windows and windows["backward"][::-1] == layer_windows,
          f"{label}: the step's windows {windows}, the layers' {layer_windows}")
    check(metrics["version"] == 1 and trainer.version == 1, f"{label}: the trainer did not publish v1")

    # every tensor got a finite nonzero gradient matching the reference
    # step's: the same batch on the same v0 weights (the rollout's replica,
    # which has not updated yet), with the plain attention (autograd
    # through it; launches no kernel), ``grad_budget`` bytes at a time; a
    # MoE model's reference follows the step's routing (check_moe_round)
    grads = trainer.last_grads
    check(set(grads) == set(trainer.params), "a parameter got no gradient")
    grad_errs, grad_max, grad_l2 = {}, {}, {}
    for n, g in grads.items():
        check(g is not None and bool(torch.isfinite(g).all()), f"{label} {n}: gradient missing or not finite")
        grad_max[n] = float(g.abs().max())
        check(grad_max[n] > 0, f"{label} {n}: zero gradient")
    mid = counts()
    t0, parts = time.perf_counter(), 0
    with routes_of(cfg, pins=step_routes.calls if cfg.moe is not None else None) as ref_routes:
        for part, ref_metrics in grads_in_parts(torch, make_grpo_loss_fn(reference), worker.params, batch,
                                                grad_budget):
            parts += 1
            for n, r in part.items():
                grad_errs[n] = grad_err(torch, grads[n], r)
                grad_l2[n] = rel_l2(torch, grads[n], r)
            del part, r
    torch.cuda.synchronize(dev)
    ref_s = time.perf_counter() - t0
    check(mid == counts(), "the reference step launched a flash kernel")
    attn = (("layers/attn/wq_b", "layers/attn/wkv_a", "layers/attn/wkv_b_k", "layers/attn/wkv_b_v", "layers/attn/ln")
            if mla else () if xlstm else
            tuple(f"{'shared_attn' if hybrid else 'layers/attn'}/{n}" for n in ("wq", "wk", "wv", "ln")))
    for name in attn:
        check(grad_max[name] > 0, f"{label} {name}: no gradient through the flash attention")
    loss_err = abs(metrics["loss"] - float(ref_metrics["loss"]))
    adv_max = float(batch["advantages"].abs().max())
    moe = {} if cfg.moe is None else dict(
        step_dropped_pairs=step_routes.dropped, step_routed_pairs=step_routes.routed,
        reference_dropped_pairs_per_pass=ref_routes.dropped / parts, routing=step_routes.flips(ref_routes))
    emit("train_check", config=label, loss=metrics["loss"], reference_loss=float(ref_metrics["loss"]),
         loss_abs_err=loss_err, loss_bound=LOGIT_MEAN_ABS * adv_max, grad_rel_l2=grad_l2, grad_tol=grad_tol,
         grad_max_err_over_max=grad_errs, grad_abs_max=grad_max, windows=windows, metrics=metrics,
         reference_parts=parts, **moe)
    # the loss is a mean of ratio x advantage over the response tokens, and a
    # ratio moves with its logprob: the serving bound on mean logprob error
    # times the largest |advantage| bounds the loss's
    check(loss_err <= LOGIT_MEAN_ABS * adv_max,
          f"{label}: loss {metrics['loss']} vs reference {float(ref_metrics['loss'])}")
    for n, e in grad_l2.items():
        check(e <= grad_tol, f"{label} {n}: gradient differs from the reference step's by {e} (relative L2)")
    if moe:
        check(moe["reference_dropped_pairs_per_pass"] == moe["step_dropped_pairs"],
              f"{label}: the reference, routed alike, dropped other pairs than the step")
        check(moe["routing"]["unexplained_rows"] == 0 and moe["routing"]["router_logit_max_abs_diff"] <= LOGIT_MAX_ABS,
              f"{label}: the step's routing against the reference's router logits: {moe['routing']}")

    # every tensor moved (the rollout still holds v0), then the update. A
    # tensor none of whose values AdamW's first step (|update| <= lr) can
    # move in its dtype is listed instead: where lr is below a quarter of
    # eps x |w| for every value, the step is below half the spacing there
    # (zamba2's d_skip, ones in bf16: spacing 2^-7, lr 1e-3)
    frozen = []
    for n, w in trainer.params.items():
        if torch.equal(worker.params[n], w) and bool((torch.finfo(w.dtype).eps * w.float().abs() / 4 > rl.lr).all()):
            frozen.append(n)
            continue
        check(not torch.equal(worker.params[n], w), f"{label} {n} did not change from v0 to v1")
    if frozen:
        emit("rl_frozen_by_rounding", config=label, lr=rl.lr, tensors=frozen)
    updated, update_s = timed(worker.pull_latest)
    check(updated and worker.weights_version == 1, f"{label}: the rollout did not update to v1")
    replica_equals_trainer("v1")
    before = counts()
    with routes_of(cfg) as served1:
        rec1, round1_s = timed(lambda: worker.serve_batch(0, keep_logits=True))
    round1 = {k: v - before[k] for k, v in counts().items()}
    check(rec1["version"] == 1 and round1 == round0, f"{label} round 1 launches {round1}, round 0 {round0}")
    launches = counts()  # the main path's launches, read now
    peak = torch.cuda.max_memory_allocated(dev)
    check(peak < 80e9, f"{label}: peak {peak} bytes")
    check1 = check_round(torch, cfg, reference, trainer.params, rec1, 1, served1, tag="rl_serve_check")
    delta = float((rec1["step_logits"][:, 0] - rec0["step_logits"][:, 0]).abs().mean())
    check(delta > 10 * LOGIT_MEAN_ABS, f"{label}: round 1's first logits barely differ from round 0's ({delta})")
    for k in ("checksum", *(() if xlstm else ("flash_attention",)), *(("mla_decode",) if mla else ()),
              *(() if xlstm else (f"flash_attention_bwd_{bwd_route}/{n}" for n in fa.bwd_kernels(*widths)))):
        check(launches[k] > 0, f"kernel {k} was not launched on the RL loop")
    del rec0, rec1, grads
    queue.clear()
    trainer.last_grads.clear()
    bwd_errs = {}
    if not xlstm:  # the backward kernels alone: a model without attention launches none
        bwd_errs = backward_kernels_check(torch, fa, cfg, trainer, batch, grad_budget, label)

    # where a GRPO step's device time goes (a second step, v1 -> v2, with
    # the launches above already read)
    if profile:
        prof = device_profile(torch, lambda: trainer.train_on(rollouts))
        emit("train_profile", config=label, card=smi, step=prof,
             profiled_step_seconds=trainer.last_timings["step_seconds"])
    tokens = batch["tokens"].numel()
    emit("rl_result", config=label, card=smi, layers=cfg.num_layers, params=nparams, replicate_seconds=replicate_s,
         publish_v0_seconds=publish0_s, publish_v1_seconds=publish1_s, train_on_seconds=train_s,
         train_step_seconds=step_s, reference_step_seconds=ref_s,
         training_tokens=tokens, training_tokens_per_s=tokens / step_s,
         update_seconds=update_s, round_seconds=[round0_s, round1_s], max_memory_allocated=peak,
         launches_per_step=step_launches, launches=launches, checks=[check0, check1], loss_abs_err=loss_err,
         grad_rel_l2_max=max(grad_l2.values()), grad_bwd_err_max=max(bwd_errs.values(), default=None))
    out = {k: launches[k] for k in counters}
    out["flash_attention_bwd_by_kernel"] = {n: launches[f"flash_attention_bwd_{n}"] for n in BWD_LAUNCHES}
    out["flash_attention_routes"] = {r: launches[f"flash_route_{r}"] for r in ROUTE_LAUNCHES}
    trainer.close()
    return out


# -- phase 10: the RL loop at gemma2-2b's published widths --------------------------

#: phase 10's rollouts: 2 prompts x 2 responses of 512 + 64 tokens (2304
#: training positions). 4 prompts did not fit one 80 GB card: the trainer's
#: 31.4 GB (bf16 parameters and gradients, f32 moments), the replica and
#: the reference step's gradients (5.2 GB each), 26 layers' activations and
#: the softcapped 256000-wide f32 logits of 4608 positions reached 72 GB
#: allocated in the loss's log-softmax and asked for 4.4 GB more (PERF.md
#: section 4); the width and depth stay as published
GEMMA2_RL_PROMPTS, GEMMA2_RL_GROUP = 2, 2


def gemma2_rl_loop(torch, dev, counters, smi: str) -> dict:
    """Phase 6's RL loop and gates at gemma2-2b's published widths and all
    26 layers, bf16 (window 4096 on the even layers, softcaps 50 and 30,
    tied embedding drawn at std 1/sqrt(d_model) as in phase 9). At 576
    positions the window does not bite in the step; phase 2 holds the
    windowed backward at full width."""
    from repro_torch.configs import get_config

    cfg = get_config("gemma2-2b")

    def init(params):
        params["embed"].mul_(math.sqrt(cfg.vocab / cfg.d_model))

    return rl_loop(torch, dev, counters, smi, cfg=cfg, num_prompts=GEMMA2_RL_PROMPTS, group_size=GEMMA2_RL_GROUP,
                   init=init)


# -- phase 7: the training entry point at its defaults ---------------------------------


#: phase 7's llama3-8b losses on the card before the config registry came
#: (the reduced config, seed 0): the registry must not move them
TRAIN_ENTRY_LOSSES = [6.1012, 6.0542]


#: phase 7's gemma2-2b at its published widths and all 26 layers, f32:
#: parameters, gradients and two AdamW moments (42 GB) beside 2 x 512
#: positions' 256000-wide logits and their copies
GEMMA2_FULL_ARGV = ["--arch", "gemma2-2b", "--full-config", "--batch", "2", "--seq", "512"]


def train_entry_point(torch, counters) -> dict:
    """``python -m repro_torch.launch.train`` at its defaults (the reduced
    llama3-8b: head_dim 16, f32, on the card), two steps, then again with
    ``--arch gemma2-2b`` (the reduced gemma2: head_dim 16, window 8,
    softcaps 50 and 30, tied embeddings, f32), then with ``--arch gemma2-2b
    --full-config`` (all 26 layers at the published widths, head_dim 256,
    window 4096, f32; 2 x 512 tokens), then with ``--arch deepseek-v3-671b``
    (the reduced deepseek-v3: MLA attention at q/k 16 + 8, v 16, 1 dense
    and 3 MoE layers, f32): the losses must be finite (llama3-8b's those of
    earlier runs), and the f32 route's forward and the cuda_core backward
    must run every layer of every step (at head_dim 256 for the full gemma2,
    at (24, 16) for deepseek-v3; each record names the attention's (q/k, v)
    widths), the tensor-core kernels none. Returns the kernels' launches on
    that path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, ROUTE_LAUNCHES

    steps = 2
    every = {**counters, **{f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    for arch, extra in (("llama3-8b", []), ("gemma2-2b", ["--arch", "gemma2-2b"]),
                        ("gemma2-2b full", GEMMA2_FULL_ARGV), ("deepseek-v3-671b", ["--arch", "deepseek-v3-671b"])):
        cfg = get_config("gemma2-2b") if "--full-config" in extra else get_config(arch).reduced()
        _, losses = train_run(torch, every, ["--steps", str(steps)] + extra, cfg, steps)
        if arch == "llama3-8b":
            check(losses == TRAIN_ENTRY_LOSSES, f"llama3-8b losses {losses}, before {TRAIN_ENTRY_LOSSES}")
    launches = {k: c.value for k, c in every.items()}
    out = {k: launches[k] for k in counters}
    out["flash_attention_bwd_by_kernel"] = {n: launches[f"flash_attention_bwd_{n}"] for n in BWD_LAUNCHES}
    out["flash_attention_routes"] = {r: launches[f"flash_route_{r}"] for r in ROUTE_LAUNCHES}
    return out


def train_run(torch, every, argv, cfg, steps: int):
    """One ``launch.train.main(argv)`` on the card, ``cfg`` the config it
    trains: its losses must be finite and every attention call of every
    step (``attention_layers``) must launch the f32 route's forward and the
    cuda_core backward, and no tensor-core or decode kernel. Returns the run's launches by counter of
    ``every`` (read right after it) and its losses."""
    import contextlib
    import io
    import re

    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, bwd_kernels
    from repro_torch.launch import train

    layers, widths = attention_layers(cfg), attention_widths(cfg)
    torch.cuda.reset_peak_memory_stats()
    before = {k: c.value for k, c in every.items()}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    run = {k: c.value - before[k] for k, c in every.items()}  # this run's launches, read now
    losses = [float(x) for x in re.findall(r"loss (\S+)", buf.getvalue())]
    emit("train_entry_point", argv=argv, layers=layers, attention_qk_v=list(widths), losses=losses,
         seconds=seconds, launches=run, max_memory_allocated=torch.cuda.max_memory_allocated())
    gc.collect()
    torch.cuda.empty_cache()
    check(len(losses) == steps and all(math.isfinite(x) for x in losses), f"{argv}: train entry point losses {losses}")
    launched = {f"cuda_core/{n}" for n in bwd_kernels(*widths)}
    want = {"flash_route_f32": steps * layers, "flash_route_tensor_core": 0, "flash_route_decode": 0,
            **{f"flash_attention_bwd_{n}": steps * layers * (n in launched) for n in BWD_LAUNCHES}}
    check({k: run[k] for k in want} == want, f"{argv}: train entry point launches {run}, want {want}")
    return run, losses


@contextlib.contextmanager
def train_config(cfg):
    """Within ``with``: ``launch.train``'s registry lookup answers ``cfg``
    for ``cfg``'s id, so ``--arch <id> --full-config`` trains ``cfg`` (the
    published widths at a cut depth)."""
    from repro_torch.launch import train

    lookup = train.get_config
    train.get_config = lambda arch: cfg if arch == cfg.name else lookup(arch)
    try:
        yield
    finally:
        train.get_config = lookup


# -- phase 8: the networked deployment on the card ---------------------------------

NET_LAYERS = NUM_LAYERS  # phase 3/4's depth: 6.46 GB a replica
NET_THROTTLE_S = 0.5  # each remote read's stretch while the controller is killed mid-pull
#: the publisher's models: one a pull, so that no replica of the reader is
#: a source of another pull and every read crosses the socket (replica
#: names are unique across models: a worker's registry and the peer
#: directory key stores by replica and shard)
NET_MODELS = ("m-raw", "m-int8", "m-fo")
NET_TP_MODELS = ("m-tp-int8", "m-tp-raw")


def net_weights(torch, dev, shapes):
    """Phase 3's weights: seeded bf16 on ``dev``, in ``shapes`` order."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    return {n: torch.randn(s, generator=g, device=dev, dtype=torch.bfloat16).mul_(0.02) for n, s in shapes}


def perturb_rows(torch, dev, tensors) -> None:
    """Phase 3's v1: 1/8 of each tensor's 256-element rows, in place."""
    gp = torch.Generator(device=dev).manual_seed(SEED + 2)
    for w in tensors:
        flat = w.view(-1)
        rows = flat[: flat.numel() // 256 * 256].view(-1, 256)[::8]
        rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))


def net_counters():
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import quant as qk
    from repro_torch.kernels import repack as rk
    from repro_torch.kernels.quant import fused as fk

    return {"checksum": ck.LAUNCHES, "quantize_rows": qk.LAUNCHES, "gather_bytes": rk.LAUNCHES,
            "dequant_gather": fk.LAUNCHES}


def publisher_main(argv) -> int:
    """Phase 8's publisher process (``chip_smoke.py --publisher``): a
    ``NetWorker`` on the card that makes phase 3's weights, publishes v0
    of every phase 8 model (TP-1, and TP-4 as phase 4's trainer), then
    takes commands on stdin: ``v1`` (unpublish m-int8, perturb, publish
    v1), ``report`` (its kernel counters and peak memory as one JSON
    line), ``exit``."""
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--addr-file", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--shapes", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.net import NetWorker
    from repro_torch.resharding import tp_shard

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        build.library()  # the library phase 2 built, found by its sources' hash
    shapes = [(n, tuple(s)) for n, s in json.loads(args.shapes)]
    weights = net_weights(torch, dev, shapes)
    shards, lays = [{} for _ in range(SRC_TP)], [{} for _ in range(SRC_TP)]
    for name, w in weights.items():
        for i in range(SRC_TP):
            part, lay = tp_shard({name: w}, i, SRC_TP)
            shards[i][name] = part[name].clone()
            lays[i].update(lay)
    counters = net_counters()
    for c in counters.values():
        c.reset()
    worker = NetWorker("publisher", addr_file=args.addr_file, device=dev)
    try:
        tp1 = {m: worker.open(m, f"trainer-{m}", 1, 0, datacenter="dc0") for m in NET_MODELS}
        for h in tp1.values():
            h.register(weights)  # the same buffers under each model
            h.publish(0)
        for m in NET_TP_MODELS:
            group = [worker.open(m, f"trainer-{m}", SRC_TP, i, datacenter="dc0") for i in range(SRC_TP)]
            for h in group:
                h.register(shards[h.shard_idx], layout=lays[h.shard_idx])
            run_group(group, lambda h: h.publish(0))
        print("PUBLISHED", flush=True)
        for line in sys.stdin:
            cmd = line.strip()
            if cmd == "v1":
                h = tp1["m-int8"]
                h.unpublish()
                perturb_rows(torch, dev, h.store.tensors().values())
                h.publish(1)
                print("V1", flush=True)
            elif cmd == "report":
                peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
                print(json.dumps({"publisher": {"launches": {k: c.value for k, c in counters.items()},
                                                "max_memory_allocated": peak,
                                                "remote_pulls": worker.transport.remote_pulls}}), flush=True)
            elif cmd == "exit":
                break
    finally:
        worker.close()
    return 0


class Child:
    """A child process whose stdout lines are read by a thread, so a wait
    for a line has a deadline; stdin is a pipe for commands."""

    def __init__(self, argv, env):
        import queue

        self.argv = argv
        self.popen = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, env=env)
        self.lines = queue.Queue()
        self.out = []
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.popen.stdout:
            self.out.append(line)
            self.lines.put(line)
        self.lines.put(None)

    def expect(self, prefix: str, timeout: float) -> str:
        import queue

        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                line = None
            check(line is not None, f"{self.argv[1:4]}: no {prefix!r} line (output: {''.join(self.out)[-2000:]})")
            if line.startswith(prefix):
                return line.strip()

    def send(self, cmd: str) -> None:
        self.popen.stdin.write(cmd + "\n")
        self.popen.stdin.flush()

    def stop(self) -> None:
        if self.popen.poll() is None:
            self.popen.kill()
        self.popen.wait()


def networked(torch, dev, counters, shapes, chunk_bytes, inproc) -> dict:
    """Phase 8: controller, publisher and reader as three processes on one
    card, the data plane over localhost sockets. Returns the four byte
    kernels' launches over the phase (the reader's and the publisher's)."""
    import hashlib
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np

    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.net import NetWorker
    from repro_torch.net.data import host_bytes
    from repro_torch.resharding import tp_shard
    from repro_torch.transfer.codec import DeltaCodec, Int8Codec
    from repro_torch.transfer.engine import WorkerStore

    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(ROOT / "src"), os.environ.get("PYTHONPATH")])))
    run_dir = tempfile.mkdtemp(prefix="chip-smoke-net-")
    wal, addr = os.path.join(run_dir, "controller.wal"), os.path.join(run_dir, "controller.addr")
    ctrl_argv = [sys.executable, "-m", "repro_torch.net.controller", "--wal", wal, "--addr-file", addr]
    children = []

    def spawn(argv):
        children.append(Child(argv, env))
        return children[-1]

    total = sum(math.prod(s) * 2 for _, s in shapes)
    emit("networked_model", config="llama3-8b", layers=NET_LAYERS, dtype="bfloat16", bytes=total,
         cut=f"depth {NET_LAYERS} of 32 layers (phase 3/4's), widths as published")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    reader = None
    try:
        ctrl = spawn(ctrl_argv)
        ctrl_addr = ctrl.expect("READY", 120).split()[1]
        pub = spawn([sys.executable, str(ROOT / "chip_smoke.py"), "--publisher", "--addr-file", addr,
                     "--device", str(dev), "--shapes", json.dumps(shapes)])
        reader = NetWorker("reader", addr_file=addr, device=dev, chunk_bytes=chunk_bytes)
        pub.expect("PUBLISHED", 600)
        v0 = net_weights(torch, dev, shapes)  # the reader's own regeneration
        oracle = WorkerStore("oracle", device=dev)
        oracle.register(v0)
        plain_int8 = Int8Codec(quantize=quantize_rows_plain)
        plain_delta = DeltaCodec("int8", quantize=quantize_rows_plain)
        tr = reader.transport
        steps, launches = {}, {k: 0 for k in counters}

        def step(label, fn, inproc_key=None, **tags):
            sync()
            before = {k: c.value for k, c in counters.items()}
            conn0 = (tr.remote_pulls, tr.conn_opens, tr.conn_reuses)
            wire0, dec0 = dict(tr.wire_bytes), dict(tr.decoded_bytes)
            t0 = time.perf_counter()
            fn()
            sync()
            dt = time.perf_counter() - t0
            for k, c in counters.items():
                launches[k] += c.value - before[k]
            wire = sum(tr.wire_bytes.values()) - sum(wire0.values())
            dec = sum(tr.decoded_bytes.values()) - sum(dec0.values())
            rec = dict(seconds=dt, payload_bytes=total, GBps=total / dt / 1e9, wire_bytes=wire,
                       decoded_bytes=dec, wire_ratio=wire / dec if dec else None,
                       remote_pulls=tr.remote_pulls - conn0[0], conn_opens=tr.conn_opens - conn0[1],
                       conn_reuses=tr.conn_reuses - conn0[2],
                       in_process_seconds=inproc.get(inproc_key), **tags)
            steps[label] = rec
            emit("networked_step", step=label, **rec)
            check(rec["conn_opens"] + rec["conn_reuses"] > 0, f"{label}: no read crossed a socket")

        def frozen(fn):
            """Run a check, which must launch no kernel (only the steps
            count as the path's launches)."""
            before = {k: c.value for k, c in counters.items()}
            fn()
            check(before == {k: c.value for k, c in counters.items()}, f"{fn.__name__} launched a kernel")

        def close(*handles):
            for h in handles:
                h.close()
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()

        for c in counters.values():
            c.reset()
        # 1. raw replicate (dc0), bit-equal to the reader's regeneration
        r0 = reader.open("m-raw", "rollout-0", 1, 0, datacenter="dc0")
        r0.register({n: torch.zeros_like(w) for n, w in v0.items()})
        step("replicate raw (dc0)", lambda: r0.replicate(0, timeout=600), "replicate rollout-0 (raw)")

        def raw_equal():
            for n, w in v0.items():
                check(torch.equal(r0.store.get(n), w), f"networked raw replica {n} != regeneration")
        frozen(raw_equal)
        close(r0)
        del r0

        # 2. int8 replicate (dc1), bit-equal to the plain-version codec
        r1 = reader.open("m-int8", "rollout-1", 1, 0, datacenter="dc1")
        r1.register({n: torch.zeros_like(w) for n, w in v0.items()})
        step("replicate int8 (dc1)", lambda: r1.replicate(0, timeout=600), "replicate rollout-1 (int8)")

        def int8_equal():
            for u in oracle.units:
                want = plain_int8.decode(plain_int8.encode(oracle._gather_unit(u), oracle.unit_dtype(u)))
                check(torch.equal(r1.store._gather_unit(u), want), f"networked int8 unit {u.name} != plain codec")
        frozen(int8_equal)

        # 3-4. TP-4 -> TP-2, int8 (dc1, wire frames decoded by the fused
        # kernel) and raw (dc0, staged, repacked by the gather kernel)
        def tp2_group(model, replica, dc):
            hs = [reader.open(model, replica, DST_TP, i, datacenter=dc) for i in range(DST_TP)]
            for h in hs:
                local, lay = tp_shard(v0, h.shard_idx, DST_TP)
                h.register({n: torch.zeros_like(t) for n, t in local.items()}, layout=lay)
            return hs

        tp4 = []
        for i in range(SRC_TP):
            local, lay = tp_shard(v0, i, SRC_TP)
            st = WorkerStore(f"oracle-tp{i}", device=dev)
            st.register(local, layout=lay)
            tp4.append(st)

        def int8_global(name):
            """v0 assembled from its TP-4 shards, each shard's carrying
            unit through the plain int8 codec first (phase 4's oracle)."""
            out = torch.empty_like(v0[name])
            for st in tp4:
                part = st.get(name)
                u = st.units[st._unit_of[name]]
                dec = plain_int8.decode(plain_int8.encode(st._gather_unit(u), st.unit_dtype(u)))
                off = 0 if not u.is_compact else next(o for n, o, _ in u.layout if n == name)
                part = dec[off : off + part.nbytes].view(torch.bfloat16).view(part.shape)
                _, offset = st.layouts[name]
                out[tuple(slice(o, o + d) for o, d in zip(offset, part.shape))] = part
            return out

        ri = tp2_group("m-tp-int8", "roll-int8", "dc1")
        step("replicate TP-4 -> TP-2 (int8, dc1)", lambda: run_group(ri, lambda h: h.replicate(0, timeout=600)),
             "replicate roll-int8 (TP-4 -> TP-2, int8, dc1)")

        def tp_int8_equal():
            for name in v0:
                want = int8_global(name)
                for h in ri:
                    check(torch.equal(h.store.get(name), tp_shard({name: want}, h.shard_idx, DST_TP)[0][name]),
                          f"networked roll-int8 {h.shard_idx} {name} != plain int8 round trip")
            for h in ri:
                check(h.intervals_pulled > 0, "networked roll-int8 pulled no interval")
        frozen(tp_int8_equal)
        close(*ri)
        del ri
        rr = tp2_group("m-tp-raw", "roll-raw", "dc0")
        step("replicate TP-4 -> TP-2 (raw, dc0)", lambda: run_group(rr, lambda h: h.replicate(0, timeout=600)),
             "replicate roll-raw (TP-4 -> TP-2, raw, dc0)")

        def tp_raw_equal():
            for name, w in v0.items():
                for h in rr:
                    check(torch.equal(h.store.get(name), tp_shard({name: w}, h.shard_idx, DST_TP)[0][name]),
                          f"networked roll-raw {h.shard_idx} {name} != regeneration")
            for h in rr:
                check(h.intervals_pulled > 0, "networked roll-raw pulled no interval")
        frozen(tp_raw_equal)
        close(*rr)
        del rr, tp4

        # 5. the controller SIGKILLed mid-pull, restarted from its WAL
        rf = reader.open("m-fo", "rollout-fo", 1, 0, datacenter="dc0")
        rf.register({n: torch.zeros_like(w) for n, w in v0.items()})
        failover = {}

        def pull_through_a_kill():
            nonlocal ctrl
            done = []
            tr.throttle_s = NET_THROTTLE_S
            dec0 = sum(tr.decoded_bytes.values())
            t = threading.Thread(target=lambda: done.append(rf.replicate(0, timeout=600)), daemon=True)
            t.start()
            deadline = time.monotonic() + 120
            while sum(tr.decoded_bytes.values()) == dec0:
                check(time.monotonic() < deadline and t.is_alive(), "the failover pull never started")
                time.sleep(0.005)
            ctrl.popen.send_signal(signal.SIGKILL)
            ctrl.popen.wait()
            t_kill = time.perf_counter()
            failover["payload_at_kill"] = sum(tr.decoded_bytes.values()) - dec0
            ctrl = spawn(ctrl_argv)
            failover["new_address"] = ctrl.expect("READY", 120).split()[1]
            failover["restart_s"] = time.perf_counter() - t_kill
            t.join(timeout=600)
            check(done == [0], "the pull did not complete after the controller restart")
            sync()
            failover["kill_to_complete_s"] = time.perf_counter() - t_kill
            tr.throttle_s = 0.0

        step("replicate raw through a controller SIGKILL (dc0)", pull_through_a_kill, None,
             throttle_s=NET_THROTTLE_S)
        gauges = reader.remote().service_metrics()["gauges"]
        failover["recovery_s"] = gauges["failover_last_recovery_seconds"]
        failover["wal_records"] = gauges.get("oplog_committed_records")
        emit("networked_failover", old_address=ctrl_addr, **failover)
        check(0 < failover["payload_at_kill"] < total, f"the kill did not land mid-pull: {failover}")
        check(reader.remote().address == failover["new_address"] != ctrl_addr, "the reader did not fail over")

        def failover_equal():
            for n, w in v0.items():
                check(torch.equal(rf.store.get(n), w), f"failover replica {n} != regeneration")
        frozen(failover_equal)
        close(rf)
        del rf

        # 6. v1 and the delta:int8 update of the int8 replica
        pub.send("v1")
        pub.expect("V1", 600)
        step("update int8 -> delta:int8 (dc1)", lambda: check(r1.update("latest"), "rollout-1 not updated"),
             "update rollout-1 (delta:int8)")
        check(tr.delta_stale_fallbacks == 0, "delta fell back to int8 (stale base)")
        v1 = net_weights(torch, dev, shapes)
        perturb_rows(torch, dev, v1.values())
        v1_store = WorkerStore("oracle-v1", device=dev)
        v1_store.register(v1)

        def delta_equal():
            for u in oracle.units:
                dtype = oracle.unit_dtype(u)
                wire = plain_delta.encode(v1_store._gather_unit(u), dtype, base=oracle._gather_unit(u))
                want = plain_delta.decode(wire, base=r1.store.base_unit(u))
                check(torch.equal(r1.store._gather_unit(u), want), f"networked delta unit {u.name} != plain codec")
        delta_equal()  # not frozen: the codec's base digest is a checksum (not a step, so not counted)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        del v1, v1_store, r1

        # 7. launch.networked at its defaults, every rank holding the
        # digest numpy computes from rng 1234
        rng = np.random.default_rng(1234)
        ref = {f"layer{i}": rng.standard_normal((256, 256), dtype=np.float32) for i in range(4)}
        want_digest = hashlib.sha256(b"".join(ref[k].tobytes() for k in sorted(ref))).hexdigest()
        t0 = time.perf_counter()
        demo = subprocess.run([sys.executable, "-m", "repro_torch.launch.networked"], env=env,
                              capture_output=True, text=True, timeout=300)
        ranks = [ln for ln in demo.stdout.splitlines() if ln.startswith("rank") and "replicated" in ln]
        emit("launch_networked", argv=[], rc=demo.returncode, seconds=time.perf_counter() - t0, ranks=ranks)
        check(demo.returncode == 0 and len(ranks) == 2, f"launch.networked: {demo.stdout[-1500:]} {demo.stderr[-1500:]}")
        for ln in ranks:
            check(ln.endswith("MATCH") and f"digest={want_digest}" in ln, f"launch.networked rank: {ln}")

        host_copies = host_copy_rates(torch, dev, oracle, total, steps["replicate raw (dc0)"]["seconds"])

        pub.send("report")
        pub_report = json.loads(pub.expect('{"publisher"', 120))["publisher"]
        pub.send("exit")
        pub.popen.wait(timeout=120)
        digest = hashlib.sha256(b"".join(host_bytes(w) for w in v0.values())).hexdigest()
    finally:
        if reader is not None:
            reader.close()
        for c in children:
            c.stop()
        shutil.rmtree(run_dir, ignore_errors=True)
    out = {k: launches[k] + pub_report["launches"][k] for k in counters}
    emit("networked_result", seconds=time.perf_counter() - t_phase, reader_launches=launches,
         publisher_launches=pub_report["launches"], launches=out,
         max_memory_allocated={"reader": peak, "publisher": pub_report["max_memory_allocated"]},
         v0_sha256=digest, failover=failover, host_copies=host_copies)
    return out


# -- phase 9: dense archs from the registry ------------------------------------------

#: depth of yi-34b and deepseek-coder-33b here: a replica of all 60-62
#: layers is 66-68 GB in bf16, and the trainer's and the rollout's two do
#: not fit one 80 GB card; their widths stay as published
DENSE_CUT_LAYERS = 4
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 512, 16
#: gemma2's phase 9 prefill tokens/s when its attention ran on the f32
#: route, before head_dim 256 had a tensor-core forward (an NVIDIA H100
#: 80GB HBM3 at 700 W, PERF.md section 5), printed beside this run's
GEMMA2_F32_ROUTE_PREFILL_TOKENS_PER_S = 31.5e3


def dense_archs(torch, dev, counters, smi: str) -> dict:
    """The registry's dense archs served from a TensorHub replica, each
    held to phase 5's gates (``serve_two_rounds``): gemma2-2b at its
    published widths and all 26 layers (4 requests of 4608 prompt tokens +
    64 new: the window of 4096 bites on the last 512 prompt positions and
    on every decode step), then yi-34b and deepseek-coder-33b at their
    published widths, cut to 4 layers (4 x (512 + 16)). gemma2's tied
    embedding is drawn at std 1/sqrt(d_model), where the init rule's
    1/sqrt(vocab) would give logits of ~0.1 and no gate a bite. Returns
    the kernels' launches over the phase."""
    from repro_torch.configs import get_config

    total = {k: 0 for k in counters}
    total["flash_attention_routes"] = {}
    plan = [
        ("gemma2-2b", None, GEMMA2_B, GEMMA2_PROMPT, GEMMA2_GEN, 1),
        ("yi-34b", DENSE_CUT_LAYERS, DENSE_BATCH, DENSE_PROMPT, DENSE_GEN, 4),
        ("deepseek-coder-33b", DENSE_CUT_LAYERS, DENSE_BATCH, DENSE_PROMPT, DENSE_GEN, 4),
    ]
    for i, (arch, layers, batch, plen, glen, ref_batch) in enumerate(plan):
        cfg = get_config(arch)
        if layers is not None:
            print(f"phase 9: {arch} cut from {cfg.num_layers} to {layers} layers, widths as published", flush=True)
            cfg = dataclasses.replace(cfg, num_layers=layers)
        n = cfg.num_layers
        want_route = {"decode": n * glen, "tensor_core": n, "f32": 0}  # bf16 prefill at 128 and 256

        def init(params, cfg=cfg):
            if cfg.tie_embeddings:
                params["embed"].mul_(math.sqrt(cfg.vocab / cfg.d_model))

        t0 = time.perf_counter()
        res = serve_two_rounds(torch, dev, counters, cfg, batch=batch, prompt_len=plen, gen_len=glen,
                               want_route=want_route, label=arch, seed=SEED + 90 + i, ref_batch=ref_batch, init=init)
        emit("dense_arch_result", card=smi, config=arch, layers=n, of_layers=get_config(arch).num_layers,
             requests=batch, prompt_len=plen, gen_len=glen, window=cfg.sliding_window,
             replicate_seconds=res["replicate_s"], update_seconds=res["update_s"], rounds=res["rounds"],
             prefill_seconds=res["prefill_s"], prefill_tokens_per_s=res["prefill_tokens_per_s"],
             decode_tokens_per_s=res["decode_tokens_per_s"], round_tokens_per_s=res["round_tokens_per_s"],
             max_memory_allocated=res["peak"], launches=res["launches"], checks=res["checks"],
             seconds=time.perf_counter() - t0,
             **({"prefill_tokens_per_s_on_the_f32_route": GEMMA2_F32_ROUTE_PREFILL_TOKENS_PER_S}
                if arch == "gemma2-2b" else {}))
        for k in counters:
            total[k] += res["launches"][k]
        for r, c in res["launches"]["flash_attention_routes"].items():
            total["flash_attention_routes"][r] = total["flash_attention_routes"].get(r, 0) + c
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return total


# -- phase 11: routed experts (dbrx-132b) at their published widths -------------------

#: dbrx-132b's serving depth here: 3.26 B parameters a layer (6.5 GB in
#: bf16), so the trainer's and the rollout's copies of 4 of its 40 layers
#: (14.27 B parameters, 28.5 GB a copy) take 57 GB of the 80; widths as published
DBRX_SERVE_LAYERS = 4
DBRX_B, DBRX_PROMPT, DBRX_GEN = 4, 512, 16
#: its training depth: at 1 layer (4.49 B parameters) the trainer's bf16
#: parameters and gradients and f32 AdamW moments (54 GB) and the
#: rollout's replica (9 GB) leave ~15 GB for the step's activations and
#: the gradient gates
DBRX_TRAIN_LAYERS = 1
DBRX_RL_PROMPTS, DBRX_RL_GROUP = 2, 2
#: reference gradients phase 11's gates hold at once: 2.5 GB, against 9 GB
#: for all of them (one expert stack's 2.1 GB, or a few smaller tensors)
DBRX_GRAD_BUDGET = 5 * GIB // 2
#: phase 11's hubs keep no delta base: the snapshot of the retiring
#: version a delta update reads (the trainer's at unpublish, the rollout's
#: at update) is one more copy of the weights on the card each, 28.5 GB at
#: 4 layers beside the two copies; every pull here is raw (dc0), so no
#: delta is negotiated, and none is lost
DBRX_DELTA_BASE = False


def moe_arch(torch, dev, counters, smi: str) -> dict:
    """dbrx-132b at its published widths (16 experts, top-4, d_expert
    10752, 48/8 heads of 128, vocab 100352), bf16: served from a TensorHub
    replica at 4 of its 40 layers through ``serve_two_rounds`` (4 x (512 +
    16); a round launches 4 tensor-core and 4 x 16 decode-route flash
    calls), each round held against a replay of its calls with the plain
    attention (capacity follows a call's token count), the pairs dropped
    over capacity printed; then at 1 layer through ``rl_loop`` (2 prompts x
    2 responses of 512 + 64: one GRPO step on the tensor-core forward and
    backward, publish v1, update, serve again), its gradient gates taken
    ``DBRX_GRAD_BUDGET`` bytes at a time. Returns the kernels' launches on
    both paths."""
    from repro_torch.configs import get_config

    cfg = get_config("dbrx-132b")
    serve_cfg = dataclasses.replace(cfg, num_layers=DBRX_SERVE_LAYERS)
    print(f"phase 11: {cfg.name} served at {DBRX_SERVE_LAYERS} and trained at {DBRX_TRAIN_LAYERS} of its "
          f"{cfg.num_layers} layers, widths as published", flush=True)
    want_route = {"decode": DBRX_SERVE_LAYERS * DBRX_GEN, "tensor_core": DBRX_SERVE_LAYERS, "f32": 0}
    t0 = time.perf_counter()
    res = serve_two_rounds(torch, dev, {k: c for k, c in counters.items() if not k.startswith("flash_attention_bwd")},
                           serve_cfg, batch=DBRX_B, prompt_len=DBRX_PROMPT, gen_len=DBRX_GEN, want_route=want_route,
                           label=cfg.name, seed=SEED + 110, ref_batch=DBRX_B, delta_base=DBRX_DELTA_BASE)
    mo = cfg.moe
    emit("moe_arch_result", card=smi, config=cfg.name, layers=DBRX_SERVE_LAYERS, of_layers=cfg.num_layers,
         experts=mo.num_experts, top_k=mo.top_k, d_expert=mo.d_expert, capacity_factor=mo.capacity_factor,
         requests=DBRX_B, prompt_len=DBRX_PROMPT, gen_len=DBRX_GEN,
         replicate_seconds=res["replicate_s"], publish_v1_seconds=res["publish_s"], update_seconds=res["update_s"],
         rounds=res["rounds"], prefill_seconds=res["prefill_s"], prefill_tokens_per_s=res["prefill_tokens_per_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"], round_tokens_per_s=res["round_tokens_per_s"],
         max_memory_allocated=res["peak"], launches=res["launches"],
         dropped_pairs_by_round=[c["dropped_pairs_served"] for c in res["checks"]],
         routed_pairs_by_round=[c["routed_pairs"] for c in res["checks"]],
         flipped_rows_by_round=[c["routing"]["flipped_rows"] for c in res["checks"]], checks=res["checks"],
         seconds=time.perf_counter() - t0)
    served = res["launches"]
    # where a served round's time goes: the prefill, then a few decode steps
    worker, prompts, cache = res["worker"], res["prompts"], {}
    n_dec = min(8, DBRX_GEN)

    def prefill():
        cache["state"] = worker.model.prefill(worker.params, {"tokens": prompts}, max_len=DBRX_PROMPT + DBRX_GEN)

    def decode_steps():
        logits, kv, n = cache["state"]
        for _ in range(n_dec):
            logits, kv = worker.model.decode(worker.params, kv, logits[:, -1].argmax(-1, keepdim=True), n)
            n += 1

    emit("moe_serve_profile", card=smi, config=cfg.name, layers=DBRX_SERVE_LAYERS,
         prefill=device_profile(torch, prefill), decode_steps=n_dec, decode=device_profile(torch, decode_steps))
    del res, worker, cache
    gc.collect()
    torch.cuda.empty_cache()
    trained = rl_loop(torch, dev, counters, smi, cfg=dataclasses.replace(cfg, num_layers=DBRX_TRAIN_LAYERS),
                      num_prompts=DBRX_RL_PROMPTS, group_size=DBRX_RL_GROUP, grad_budget=DBRX_GRAD_BUDGET,
                      delta_base=DBRX_DELTA_BASE)
    out = {k: served.get(k, 0) + trained[k] for k in counters}
    out["flash_attention_routes"] = {r: served["flash_attention_routes"][r] + c
                                     for r, c in trained["flash_attention_routes"].items()}
    out["flash_attention_bwd_by_kernel"] = trained["flash_attention_bwd_by_kernel"]
    return out


# -- phase 12: MLA attention (deepseek-v3-671b) at its published widths -----------------

#: deepseek-v3-671b's serving depth here: its 3 dense prefix layers and 1
#: of routed experts, the least depth with a MoE layer (15.11 B
#: parameters, 30.2 GB a copy in bf16, the trainer's and the rollout's
#: 60.4 GB of the 80); widths as published
DS_SERVE_LAYERS = 4
DS_B, DS_PROMPT, DS_GEN = 4, 512, 16
#: its training cut: the 3 dense prefix layers and 1 MoE layer (fewer makes
#: ``param_count`` negative), 16 of its 256 routed experts (top-8 kept),
#: every width as published: 4.54 B parameters, the trainer's bf16 weights
#: and gradients and f32 AdamW moments 54.5 GB beside the rollout's 9.1 GB
#: replica, dbrx's budget at 1 layer (phase 11)
DS_TRAIN_LAYERS, DS_TRAIN_EXPERTS = 4, 16
DS_RL_PROMPTS, DS_RL_GROUP = 2, 2


def mla_arch(torch, dev, counters, smi: str) -> dict:
    """deepseek-v3-671b at its published widths (d_model 7168, 128 heads,
    MLA with q_lora 1536, kv_lora 512, qk 128 + 64, v 128; 256 experts
    top-8 + 1 shared of 2048, a dense FFN of 18432 in its first three
    layers; vocab 129280), bf16, served from a TensorHub replica at 4 of
    its 61 layers through ``serve_two_rounds`` (4 x (512 + 16); hubs
    without delta bases, as phase 11's): each round's prefill launches 4
    tensor-core forwards at q/k 192, v 128, its decode steps 4 x 16
    ``mla_decode`` kernels and nothing on the decode or f32 routes, held
    against a replay of its calls with ``attention_plain`` and
    ``mla_decode_plain`` that follows the served experts. Then a profiled
    decode step's device time by kernel class. Then the training half, as
    phase 11's: ``rl_loop`` at ``DS_TRAIN_LAYERS`` layers and
    ``DS_TRAIN_EXPERTS`` experts (2 prompts x 2 responses of 512 + 64; one
    GRPO step on the tensor-core forward and backward at (192, 128), publish
    v1, update, serve round 1 on ``mla_decode``), its gradient gates taken
    ``DBRX_GRAD_BUDGET`` bytes at a time. Returns the kernels' launches on
    both paths."""
    from repro_torch.configs import get_config

    cfg = get_config("deepseek-v3-671b")
    serve_cfg = dataclasses.replace(cfg, num_layers=DS_SERVE_LAYERS)
    print(f"phase 12: {cfg.name} served at {DS_SERVE_LAYERS} of its {cfg.num_layers} layers "
          f"({cfg.moe.first_dense} dense, {DS_SERVE_LAYERS - cfg.moe.first_dense} of routed experts), "
          "widths as published", flush=True)
    want_route = {"decode": 0, "tensor_core": DS_SERVE_LAYERS, "f32": 0}
    t0 = time.perf_counter()
    res = serve_two_rounds(torch, dev, {k: c for k, c in counters.items() if not k.startswith("flash_attention_bwd")},
                           serve_cfg, batch=DS_B, prompt_len=DS_PROMPT, gen_len=DS_GEN, want_route=want_route,
                           label=cfg.name, seed=SEED + 120, ref_batch=DS_B, delta_base=False,
                           want_latent=DS_SERVE_LAYERS * DS_GEN)
    mo, ml = cfg.moe, cfg.mla
    served = res["launches"]
    worker, prompts, cache = res["worker"], res["prompts"], {}

    def prefill():
        cache["state"] = worker.model.prefill(worker.params, {"tokens": prompts}, max_len=DS_PROMPT + DS_GEN)

    def decode_step():
        logits, kv, n = cache["state"]
        cache["state"] = worker.model.decode(worker.params, kv, logits[:, -1].argmax(-1, keepdim=True), n) + (n + 1,)

    prefill()
    decode_step()  # warm
    profile = device_profile(torch, decode_step)
    emit("mla_arch_result", card=smi, config=cfg.name, layers=DS_SERVE_LAYERS, of_layers=cfg.num_layers,
         dense_prefix=mo.first_dense, experts=mo.num_experts, top_k=mo.top_k, shared=mo.num_shared,
         mla=dataclasses.asdict(ml), requests=DS_B, prompt_len=DS_PROMPT, gen_len=DS_GEN,
         replicate_seconds=res["replicate_s"], publish_v1_seconds=res["publish_s"], update_seconds=res["update_s"],
         rounds=res["rounds"], prefill_seconds=res["prefill_s"], prefill_tokens_per_s=res["prefill_tokens_per_s"],
         decode_tokens_per_s=res["decode_tokens_per_s"], round_tokens_per_s=res["round_tokens_per_s"],
         max_memory_allocated=res["peak"], launches=served,
         dropped_pairs_by_round=[c["dropped_pairs_served"] for c in res["checks"]],
         routed_pairs_by_round=[c["routed_pairs"] for c in res["checks"]],
         flipped_rows_by_round=[c["routing"]["flipped_rows"] for c in res["checks"]], checks=res["checks"],
         seconds=time.perf_counter() - t0)
    emit("mla_serve_profile", card=smi, config=cfg.name, layers=DS_SERVE_LAYERS, decode_step=profile)
    check(res["peak"] < 80e9, f"{cfg.name}: peak {res['peak']} bytes")
    del res, worker, cache
    gc.collect()
    torch.cuda.empty_cache()
    train_cfg = dataclasses.replace(cfg, num_layers=DS_TRAIN_LAYERS,
                                    moe=dataclasses.replace(mo, num_experts=DS_TRAIN_EXPERTS))
    print(f"phase 12: {cfg.name} trained at {DS_TRAIN_LAYERS} layers and {DS_TRAIN_EXPERTS} of its "
          f"{mo.num_experts} experts (top-{mo.top_k}), widths as published", flush=True)
    trained = rl_loop(torch, dev, counters, smi, cfg=train_cfg, num_prompts=DS_RL_PROMPTS, group_size=DS_RL_GROUP,
                      grad_budget=DBRX_GRAD_BUDGET, delta_base=False)
    gc.collect()
    torch.cuda.empty_cache()
    out = {k: served.get(k, 0) + trained[k] for k in counters}
    out["flash_attention_routes"] = {r: served["flash_attention_routes"][r] + c
                                     for r, c in trained["flash_attention_routes"].items()}
    out["flash_attention_bwd_by_kernel"] = trained["flash_attention_bwd_by_kernel"]
    return out


# -- phase 13: the simulator on the H100 profile, at Table 3's sizes ---------------

#: Table 3's workloads the simulator runs here; 1T (48 trainer replicas x 16
#: shards, 16 rollout replicas) takes minutes of host time a run and is left out
SIM_STANDALONE = ("9B", "36B", "260B")
SIM_STEPS = 2  # Fig. 9's training steps a standalone run takes
SIM_ELASTIC = (1, 6)  # Fig. 11's spot replicas beside the standalone one (260B)
#: Fig. 12's cross-DC seeding (9B): the WAN codec each run negotiates; the
#: delta's share of rows changed between versions is cross_dc.py's 1/8
SIM_CROSS_DC = {"raw": dict(wan_codec="raw", wan_delta=False), "int8": dict(wan_codec="int8", wan_delta=False),
                "delta:int8": dict(wan_codec="int8", wan_delta=True, delta_kept_frac=0.125)}
SIM_RESHARD_UNITS = 16  # reshard.py's units a TP-4 shard of 36B
#: the resharded pull's decode part is compared against a profile of this
#: HBM rate (the fused decode drains at a third of it)
SIM_SLOW_HBM = 819e9


def sim_standalone(sc, w):
    """Fig. 9 (``benchmarks/standalone.py``): co-located trainers publish
    each step, every standalone rollout replicates v0 and updates to v1."""
    cl = sc.SimCluster()
    units = w.unit_bytes(64)
    trainers = [cl.add_replica("m", f"tr{i}", w.num_shards, unit_bytes=units) for i in range(w.num_trainer_replicas)]
    readers = [cl.add_replica("m", f"ro{i}", w.num_shards, unit_bytes=units) for i in range(w.num_standalone_replicas)]
    for r in trainers + readers:
        r.open()
    cl.run()
    for step in range(SIM_STEPS):
        for t in trainers:
            t.publish(step)
        cl.run()
        for r in readers:
            (r.replicate if step == 0 else r.update)("latest")
        cl.run()
        if step < SIM_STEPS - 1:
            for t in trainers:
                t.unpublish()
            cl.run()
    return cl, readers, SIM_STEPS - 1, {}


def sim_elastic(sc, w, n_elastic: int):
    """Fig. 11 (``benchmarks/elastic.py``): one standalone and ``n_elastic``
    spot replicas replicate 260B at once."""
    cl = sc.SimCluster()
    units = w.unit_bytes(64)
    trainers = [cl.add_replica("m", f"tr{i}", w.num_shards, unit_bytes=units) for i in range(w.num_trainer_replicas)]
    readers = [cl.add_replica("m", "sa0", w.num_shards, unit_bytes=units)]
    readers += [cl.add_replica("m", f"el{i}", w.num_shards, unit_bytes=units, is_spot=True) for i in range(n_elastic)]
    for r in trainers + readers:
        r.open()
    cl.run()
    for t in trainers:
        t.publish(0)
    cl.run()
    for r in readers:
        r.replicate("latest")
    cl.run()
    return cl, readers, 0, {}


def sim_cross_dc(sc, w, **kw):
    """Fig. 12 (``benchmarks/cross_dc.py``): trainers in dc0, rollouts in
    dc1; v0 everywhere first, then the measured warm update to v1, the
    rollouts polling ``update("latest")``. Returns the WAN bytes of the
    update beside one copy's wire bytes (the codec's ratio over a shard
    manifest x shard bytes x shards)."""
    cl = sc.SimCluster(**kw)
    units = w.unit_bytes(64)
    trainers = [cl.add_replica("m", f"tr{i}", w.num_shards, datacenter="dc0", unit_bytes=units)
                for i in range(w.num_trainer_replicas)]
    readers = [cl.add_replica("m", f"ro{i}", w.num_shards, datacenter="dc1", unit_bytes=units)
               for i in range(w.standalone_gpus // w.num_shards)]
    for r in trainers + readers:
        r.open()
    cl.run()
    for t in trainers:
        t.publish(0)
    cl.run()
    for r in readers:
        r.replicate("latest")
    cl.run()
    for t in trainers:
        t.unpublish()
    cl.run()
    for r in readers:  # measure only the v0 -> v1 update
        for s in r.shards:
            s.worker.total_stall = 0.0
            s.worker.stall_parts.clear()
    wan_before = cl.link_class_bytes().get("vpc_up", 0.0)
    for t in trainers:
        t.publish(1)
    cl.run()

    def poller(rep):
        while True:
            results = []
            for s in rep.shards:
                results.append((yield from s.g_update("latest")))
            if results[0]:
                return
            yield cl.env.timeout(0.2)

    for r in readers:
        cl.env.process(poller(r))
    cl.run(until=120.0)
    codec = f"delta:{kw['wan_codec']}" if kw["wan_delta"] else kw["wan_codec"]
    ratio = cl.codec_ratio(codec, readers[0].manifest_for(0))
    wan = cl.link_class_bytes().get("vpc_up", 0.0) - wan_before
    return cl, readers, 1, dict(codec=codec, wire_ratio=ratio, wan_update_bytes=wan,
                                one_copy_wire_bytes=ratio * w.shard_bytes * w.num_shards)


def sim_reshard(sc, w, **kw):
    """``benchmarks/reshard.py``'s ``_sim_reshard``: a TP-4 publisher (dc0)
    and a TP-2 rollout (dc1) over int8 frames, whose fused decode drains at
    a third of the profile's HBM rate; ``kw`` go to ``SimCluster``."""
    cl = sc.SimCluster(wan_codec="int8", **kw)
    units = [b * w.num_shards for b in w.unit_bytes(SIM_RESHARD_UNITS)]
    tr = cl.add_replica("m", "tr0", 4, global_unit_bytes=units)
    ro = cl.add_replica("m", "ro0", 2, datacenter="dc1", global_unit_bytes=units)
    tr.open()
    ro.open()
    cl.run()
    tr.publish(0)
    cl.run()
    ro.replicate("latest")
    cl.run()
    return cl, [ro], 0, {}


def sim_result(cl, readers, version: int, label: str) -> dict:
    """A scenario's gates and figures: every reader at ``version``, each
    reader's stall parts summing to its stall."""
    names = [r.name for r in readers]
    for n in names:
        got = cl.server.replica_version("m", n)
        check(got == version, f"{label}: reader {n} at v{got}, want v{version}")
    for r in readers:
        for s in r.shards:
            w = s.worker
            check(math.isclose(sum(w.stall_parts.values()), w.total_stall, rel_tol=1e-9, abs_tol=1e-12),
                  f"{label}: {r.name}/{s.idx}'s stall parts {w.stall_parts} do not sum to {w.total_stall}")
    per = cl.per_worker_stalls(names)
    return dict(total_stall_s=sum(per), per_reader_stall_s=per, decomposition=cl.stall_decomposition(names),
                link_class_bytes=cl.link_class_bytes(), virtual_s=cl.env.now)


def simulator(smi: str, drain: dict) -> dict:
    """The port's ``SimCluster`` on the H100 profile (this host's CPU; it
    touches no tensor) at Table 3's sizes: Fig. 9's standalone stall (9B,
    36B, 260B), Fig. 11's elastic replicate (260B at 1 and 6 spot
    replicas), Fig. 12's cross-DC seeding (raw, int8, delta:int8) and a
    cross-DC TP-4 -> TP-2 int8 pull. Each scenario runs twice and must give
    the same stalls and link bytes; every reader must end at the published
    version with its stall parts summing to its stall; the cross-DC
    update's WAN bytes must be one copy's wire bytes; the resharded pull's
    decode part under H100 must be no larger than under an 819 GB/s
    profile. ``drain`` holds phase 2's measured fused decode and copy
    rates, printed beside the profile's modeled drain."""
    from repro_torch.configs.paper_workloads import WORKLOADS
    from repro_torch.transfer import hardware
    from repro_torch.transfer import simcluster as sc

    check(sc.H100 is hardware.H100, "the simulator's profile is not hardware.H100")
    plan = [(f"standalone {n}", lambda n=n: sim_standalone(sc, WORKLOADS[n])) for n in SIM_STANDALONE]
    plan += [(f"elastic 260B x{k}", lambda k=k: sim_elastic(sc, WORKLOADS["260B"], k)) for k in SIM_ELASTIC]
    plan += [(f"cross-DC {c}", lambda kw=kw: sim_cross_dc(sc, WORKLOADS["9B"], **kw)) for c, kw in SIM_CROSS_DC.items()]
    plan += [("reshard TP-4 -> TP-2 int8", lambda: sim_reshard(sc, WORKLOADS["36B"]))]
    scenarios = {}
    for label, build in plan:
        runs = []
        for _ in range(2):
            t0 = time.perf_counter()
            cl, readers, version, extra = build()
            runs.append(dict(sim_result(cl, readers, version, label), wall_s=time.perf_counter() - t0, **extra))
            del cl, readers
        a, b = runs
        check(a["per_reader_stall_s"] == b["per_reader_stall_s"] and a["link_class_bytes"] == b["link_class_bytes"],
              f"{label}: a second run gave other stalls or link bytes")
        if "wan_update_bytes" in a:
            check(math.isclose(a["wan_update_bytes"], a["one_copy_wire_bytes"], rel_tol=1e-6),
                  f"{label}: the update carried {a['wan_update_bytes']} WAN bytes, one copy is "
                  f"{a['one_copy_wire_bytes']}")
        rec = dict(a, wall_s=[a["wall_s"], b["wall_s"]])
        scenarios[label] = rec
        emit("sim_scenario", scenario=label, **rec)
    # the one device constant: the resharded pull's decode under H100 and under a slower profile
    label = "reshard TP-4 -> TP-2 int8"
    fast = scenarios[label]["decomposition"]
    saved = sc.H100
    sc.H100 = hardware.GpuHW(hbm_bw=SIM_SLOW_HBM)
    try:
        cl, readers, version, _ = sim_reshard(sc, WORKLOADS["36B"])
        slow = sim_result(cl, readers, version, label + " at 819 GB/s")["decomposition"]
    finally:
        sc.H100 = saved
    check(fast["decode"] <= slow["decode"], f"decode part {fast['decode']} under H100 > {slow['decode']} at 819 GB/s")
    check({k: v for k, v in fast.items() if k != "decode"} == {k: v for k, v in slow.items() if k != "decode"},
          "the profile moved a stall part other than decode")
    modeled = hardware.H100.hbm_bw / 3.0
    rec = dict(card=smi, profile=dataclasses.asdict(hardware.H100), modeled_drain_Bps=modeled,
               measured=drain, measured_over_modeled=drain["dequant_gather_output_Bps"] / modeled,
               reshard_decode_s={"H100": fast["decode"], "819 GB/s": slow["decode"]},
               scenarios={k: dict(total_stall_s=v["total_stall_s"], max_reader_stall_s=max(v["per_reader_stall_s"]),
                                  readers=len(v["per_reader_stall_s"]),
                                  wan_bytes=v["link_class_bytes"].get("vpc_up", 0.0), wall_s=v["wall_s"],
                                  **({"wan_update_bytes": v["wan_update_bytes"]} if "wan_update_bytes" in v else {}))
                          for k, v in scenarios.items()})
    emit("sim", **rec)
    return rec


# -- phase 14: the VLM family (internvl2-2b) at its published widths ----------------

#: 4 requests of 256 patches + 512 prompt tokens, 64 new tokens each:
#: every decode step attends over a cache of 832 slots
VLM_B, VLM_PROMPT, VLM_GEN = 4, 512, 64
#: phase 7's launch.train at internvl2-2b's published widths, f32: 2 x
#: (256 stand-in patches + 256 tokens)
VLM_TRAIN_B, VLM_TRAIN_SEQ = 2, 512
VLM_TRAIN_ARGV = ["--arch", "internvl2-2b", "--full-config", "--batch", str(VLM_TRAIN_B), "--seq", str(VLM_TRAIN_SEQ)]


def vlm_arch(torch, dev, counters, smi: str) -> dict:
    """internvl2-2b (arXiv:2404.16821) at its published widths and all 24
    layers in bf16 (d_model 2048, 16 query and 8 KV heads of 128, d_ff
    8192, vocab 92553, untied head, 256 patches, rope theta 1e6): a trainer
    (dc0) publishes v0, a rollout replica (dc0, raw) replicates it, and
    the model reads its parameters from the replica's registered buffers:
    it prefills 4 x (256 patches + 512 tokens), the patches random bf16
    from ``SEED`` at the embedding's scale, and decodes 64 tokens greedily;
    the trainer perturbs 1/8 of its rows and publishes v1, the replica
    updates in place, and the same requests are served again. The replica
    must be bit-equal to the trainer after each pull, each round's logits
    within phase 5's gates of a teacher-forced forward with the plain
    attention, round 1 apart from round 0, and each round must launch 24
    tensor-core forwards (q [4,16,768,128], k/v [4,8,768,128]), 24 x 64
    decode-route ones and none on the f32 route. Then ``launch.train
    --arch internvl2-2b --full-config`` for two f32 steps: finite losses,
    the f32 forward and the cuda_core backward on every layer. Returns
    the kernels' launches on both paths."""
    from repro_torch.configs import get_config
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import PromptSet
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, ROUTE_LAUNCHES, attention_plain
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params

    cfg = get_config("internvl2-2b")
    p = cfg.num_patches
    every = {**counters, **{f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    hub = TensorHubClient(ReferenceServer(), device=dev)
    trainer = hub.open("vlm", "trainer", 1, 0, datacenter="dc0")
    trainer.register(init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 140), torch.bfloat16, dev))
    trainer.publish(0)
    weights = trainer.store.tensors()
    nparams = sum(w.numel() for w in weights.values())
    rollout = hub.open("vlm", "rollout-0", 1, 0, datacenter="dc0")
    rollout.register({n: torch.zeros_like(w) for n, w in weights.items()})
    nbytes = rollout.store.total_bytes
    emit("model", config=cfg.name, layers=cfg.num_layers, dtype="bfloat16", params=nparams, bytes=nbytes)
    _, replicate_s = timed(lambda: rollout.replicate(0, timeout=600))

    def equal_to_trainer(when):
        for n, w in trainer.store.tensors().items():
            check(torch.equal(rollout.store.get(n), w), f"{cfg.name} {when}: rollout {n} != trainer")

    equal_to_trainer("after replicate")
    params = rollout.store.tensors()  # the registered buffers: an update is seen by the next round
    calls = set()  # each attention call's (route, q shape, k/v shape)

    def attention(q, k, v, **kw):
        calls.add((fa._route(q, k, v=v), tuple(q.shape), tuple(k.shape)))
        return fa.flash_attention(q, k, v, **kw)

    model = build_model(cfg, attention=attention)
    reference = build_model(cfg, attention=attention_plain)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    scale = 1.0 / math.sqrt(cfg.vocab)  # init_params' std of the embedding
    patches = torch.randn((VLM_B, p, cfg.d_model), generator=gen, device=dev).mul_(scale).to(torch.bfloat16)
    prompts = torch.from_numpy(PromptSet(cfg.vocab, VLM_PROMPT, seed=SEED).sample(VLM_B, 0)).to(dev, torch.int64)
    max_len = p + VLM_PROMPT + VLM_GEN
    want_route = {"tensor_core": cfg.num_layers, "decode": cfg.num_layers * VLM_GEN, "f32": 0}
    hd, hq, hkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    want_calls = {("tensor_core", (VLM_B, hq, p + VLM_PROMPT, hd), (VLM_B, hkv, p + VLM_PROMPT, hd)),
                  ("decode", (VLM_B, hq, 1, hd), (VLM_B, hkv, max_len, hd))}

    def serve():
        """Prefill, then ``VLM_GEN`` greedy decode steps (the last one's
        logits unused, as ``sample_responses``)."""
        logits, cache, n = model.prefill(params, {"tokens": prompts, "patches": patches}, max_len=max_len)
        toks, lps, steps = [], [], []
        for _ in range(VLM_GEN):
            last = logits[:, -1].float()
            nxt = last.argmax(-1)
            steps.append(last)
            lps.append(torch.log_softmax(last, -1).gather(-1, nxt[:, None])[:, 0])
            toks.append(nxt)
            logits, cache = model.decode(params, cache, nxt[:, None], n)
            n += 1
        check(n == max_len, f"{cfg.name}: the decode ended at cache length {n}, want {max_len}")
        return dict(tokens=torch.cat([prompts, torch.stack(toks, 1)], 1), behavior_logprobs=torch.stack(lps, 1),
                    step_logits=torch.stack(steps, 1))

    rounds, checks = [], []
    for step in range(2):
        if step:
            def perturb_and_publish():
                trainer.unpublish()
                gp = torch.Generator(device=dev).manual_seed(SEED + 31)
                for w in trainer.store.tensors().values():
                    flat = w.view(-1)
                    rows = flat[: flat.numel() // 256 * 256].view(-1, 256)[::8]  # 1/8 of the rows, in place
                    rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
                trainer.publish(1)

            _, publish_s = timed(perturb_and_publish)
            updated, update_s = timed(lambda: rollout.update("latest"))
            check(updated and rollout.current_version == 1, f"{cfg.name}: the rollout did not update to v1")
            equal_to_trainer("after update")
        before = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
        calls.clear()
        with torch.no_grad():
            rec, round_s = timed(serve)
        by_route = {r: c.value - before[r] for r, c in ROUTE_LAUNCHES.items()}
        check(by_route == want_route, f"{cfg.name} round {step}: flash launches by route {by_route}, want {want_route}")
        check(calls == want_calls, f"{cfg.name} round {step}: attention calls {calls}, want {want_calls}")
        rounds.append(dict(round=step, version=step, seconds=round_s, flash_launches_by_route=by_route,
                           attention_calls=sorted([r, list(q), list(k)] for r, q, k in calls),
                           generated_tokens=VLM_B * VLM_GEN))
        mid = {k: c.value for k, c in every.items()}
        checks.append(check_served_round(torch, reference, trainer.store.tensors(), rec, step,
                                         tag=f"serve_check {cfg.name}", chunk=1, patches=patches))
        check(mid == {k: c.value for k, c in every.items()}, f"{cfg.name}: the checks launched a kernel")
        if step == 0:
            first0 = rec["step_logits"][:, 0].clone()
        else:
            delta = float((rec["step_logits"][:, 0] - first0).abs().mean())
            check(delta > 10 * LOGIT_MEAN_ABS, f"{cfg.name}: round 1 logits barely differ from round 0's ({delta})")
        del rec
    served = {k: c.value for k, c in every.items()}  # the serving path's launches, read now
    serve_peak = torch.cuda.max_memory_allocated(dev)
    check(served["checksum"] > 0, f"{cfg.name}: the publish -> replicate -> update path launched no checksum")

    # the prefill and a decode step alone, at the served shapes (after the read above), on the model as
    # build_model builds it: its default attention, without the recording wrapper's host work
    plain = build_model(cfg)
    with torch.no_grad():
        pb = {"tokens": prompts, "patches": patches}
        prefill_s = statistics.median(timed(lambda: plain.prefill(params, pb, max_len=max_len))[1] for _ in range(3))
        _, cache, n = plain.prefill(params, pb, max_len=max_len)
        nxt = prompts[:, -1:]
        steps_s = [timed(lambda: plain.decode(params, cache, nxt, n + i))[1] for i in range(min(8, VLM_GEN))]
    decode_step_s = statistics.median(steps_s)
    del cache, plain
    hub_bytes = {"replicate_GBps": nbytes / replicate_s / 1e9, "update_GBps": nbytes / update_s / 1e9}
    emit("vlm_arch_result", card=smi, config=cfg.name, layers=cfg.num_layers, params=nparams, bytes=nbytes,
         requests=VLM_B, patches=p, prompt_len=VLM_PROMPT, gen_len=VLM_GEN, cache_slots=max_len,
         replicate_seconds=replicate_s, publish_v1_seconds=publish_s, update_seconds=update_s, **hub_bytes,
         rounds=rounds, timed_model="build_model(cfg), default attention", prefill_seconds=prefill_s,
         prefill_positions_per_s=VLM_B * (p + VLM_PROMPT) / prefill_s,
         prefill_tokens_per_s=VLM_B * VLM_PROMPT / prefill_s, decode_step_seconds=decode_step_s,
         decode_tokens_per_s=VLM_B / decode_step_s, round_tokens_per_s=VLM_B * VLM_GEN / rounds[1]["seconds"],
         max_memory_allocated=serve_peak, launches=served, checks=checks)
    del model, reference, params, weights, patches, hub, trainer, rollout
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.launch import train

    steps, step_s = 2, []
    make_step = train.make_train_step

    def timed_steps(*a, **kw):  # each step's seconds, ended by a synchronize
        step = make_step(*a, **kw)

        def run(*args):
            out, seconds = timed(lambda: step(*args))
            step_s.append(seconds)
            return out

        return run

    train.make_train_step = timed_steps
    try:
        trained, losses = train_run(torch, every, ["--steps", str(steps)] + VLM_TRAIN_ARGV, cfg, steps)
    finally:
        train.make_train_step = make_step
    emit("vlm_train_result", card=smi, config=cfg.name, layers=cfg.num_layers, dtype="float32", losses=losses,
         batch=VLM_TRAIN_B, positions=VLM_TRAIN_SEQ, step_seconds=step_s,
         positions_per_s=VLM_TRAIN_B * VLM_TRAIN_SEQ / step_s[-1],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=trained)
    launches = {k: served[k] + trained[k] for k in every}  # the timed prefill and decode steps left out
    out = {k: launches[k] for k in counters}
    out["flash_attention_routes"] = {r: launches[f"flash_route_{r}"] for r in ROUTE_LAUNCHES}
    out["flash_attention_bwd_by_kernel"] = {n: launches[f"flash_attention_bwd_{n}"] for n in BWD_LAUNCHES}
    return out


# -- phase 15: the audio family (hubert-xlarge) at its published widths --------------

#: 8 clips of 20 s at HuBERT's 50 frames a second, encoded each round; the
#: bf16 training step takes 4 of them, phase 15's launch.train f32 step 2
AUDIO_B, AUDIO_FRAMES, AUDIO_TRAIN_B, AUDIO_F32_B = 8, 1000, 4, 2
AUDIO_TRAIN_ARGV = ["--arch", "hubert-xlarge", "--full-config", "--batch", str(AUDIO_F32_B), "--seq",
                    str(AUDIO_FRAMES)]
#: sequences a reference gradient takes at a time (the plain attention
#: keeps each layer's f32 scores and softmax, 128 MB a sequence a layer)
AUDIO_REF_CHUNK = 1


def audio_arch(torch, dev, counters, smi: str) -> dict:
    """hubert-xlarge (arXiv:2106.07447) at its published widths and all 48
    layers in bf16 (d_model 1280, 16 heads of 80, d_ff 5120, vocab 504,
    frames of 512, rope theta 1e4): a trainer (dc0) holds seeded weights,
    registers and publishes v0; a rollout replica (dc0, raw) replicates it,
    and ``EncoderLM.forward`` reads the replica's registered buffers to
    encode 8 x 1000 frames (``audio_batch`` from ``SEED``). Then one bf16
    masked-prediction step on the trainer through ``make_train_step``, AdamW
    in place on its registered buffers, over 4 x 1000 frames; the trainer
    publishes v1, the replica updates in place and encodes again. Gates:
    the replica bit-equal to the trainer after each pull; each round's
    logits within phase 5's gates of a forward with the plain attention on
    the trainer's weights; round 1 apart from round 0; every tensor's
    gradient (taken on v0, beside the step) finite, nonzero and within
    ``GRAD_TOL_PLAIN`` of the plain attention's (its reference taken
    ``AUDIO_REF_CHUNK`` sequences at a time, each part weighted by its share
    of the masked positions); an encode launches exactly 48 tensor_core
    forwards at [8,16,1000,80] bidirectional and nothing else, the step 48
    and 48 of each tensor_core backward kernel, none on cuda_core. Then
    ``launch.train --arch hubert-xlarge --full-config`` for two f32 steps of
    2 x 1000 frames: finite losses, the f32 forward and the cuda_core
    backward on every layer. Times are taken on ``build_model(cfg)``'s
    default attention; a recording wrapper only asserts routes and shapes.
    Returns the main path's launches: the two encodes, the step and the
    f32 steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import audio_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, ROUTE_LAUNCHES, attention_plain
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.training.steps import make_loss_fn, value_and_grad

    cfg = get_config("hubert-xlarge")
    layers, hq, d, s = cfg.num_layers, cfg.num_heads, cfg.resolved_head_dim, AUDIO_FRAMES
    every = {**counters, **{f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    main = dict.fromkeys(every, 0)  # the main path's launches, span by span

    def counts():
        return {k: c.value for k, c in every.items()}

    def span(fn):
        """``fn()`` on the main path: its launches added to ``main``."""
        before = counts()
        out = fn()
        for k, v in counts().items():
            main[k] += v - before[k]
        return out, {k: v - before[k] for k, v in counts().items()}

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats(dev)
    hub = TensorHubClient(ReferenceServer(), device=dev)
    trainer = hub.open("audio", "trainer", 1, 0, datacenter="dc0")
    trainer.register(init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 150), torch.bfloat16, dev))
    span(lambda: trainer.publish(0))
    weights = trainer.store.tensors()  # the registered buffers: the step writes them in place
    nparams = sum(w.numel() for w in weights.values())
    rollout = hub.open("audio", "rollout-0", 1, 0, datacenter="dc0")
    rollout.register({n: torch.zeros_like(w) for n, w in weights.items()})
    nbytes = rollout.store.total_bytes
    emit("model", config=cfg.name, layers=layers, dtype="bfloat16", params=nparams, bytes=nbytes)
    (_, pulled), replicate_s = timed(lambda: span(lambda: rollout.replicate(0, timeout=600)))

    def equal_to_trainer(when):
        for n, w in trainer.store.tensors().items():
            check(torch.equal(rollout.store.get(n), w), f"{cfg.name} {when}: rollout {n} != trainer")

    equal_to_trainer("after replicate")
    params = rollout.store.tensors()  # the registered buffers: an update is seen by the next encode
    calls = set()  # each attention call's (route, q shape, k/v shape, causal)

    def attention(q, k, v, **kw):
        calls.add((fa._route(q, k, grad=torch.is_grad_enabled() and q.requires_grad, v=v), tuple(q.shape),
                   tuple(k.shape), kw["causal"]))
        return fa.flash_attention(q, k, v, **kw)

    model = build_model(cfg, attention=attention)
    reference = build_model(cfg, attention=attention_plain)
    plain = build_model(cfg)  # as a user builds it: the default attention, timed
    drawn = audio_batch(AUDIO_B, s, cfg.frontend_dim, cfg.vocab, SEED)
    frames = {"frames": torch.from_numpy(drawn["frames"]).to(dev)}
    drawn = audio_batch(AUDIO_TRAIN_B, s, cfg.frontend_dim, cfg.vocab, SEED + 1)
    train_batch = {k: torch.from_numpy(v).to(dev) for k, v in drawn.items()}
    want_route = {"tensor_core": layers, "decode": 0, "f32": 0}

    def encode_round(step):
        """An encode through the recording model (routes and shapes), its
        logits against the plain attention on the trainer's weights, and
        the same encode timed on the default model."""
        calls.clear()
        with torch.no_grad():
            logits, launched = span(lambda: model.forward(params, frames))
        by_route = {r: launched[f"flash_route_{r}"] for r in ROUTE_LAUNCHES}
        check(by_route == want_route, f"{cfg.name} round {step}: flash launches by route {by_route}, want {want_route}")
        check(not any(launched[f"flash_attention_bwd_{n}"] for n in BWD_LAUNCHES),
              f"{cfg.name}: an encode ran a backward")
        want_calls = {("tensor_core", (AUDIO_B, hq, s, d), (AUDIO_B, cfg.num_kv_heads, s, d), False)}
        check(calls == want_calls, f"{cfg.name} round {step}: attention calls {calls}, want {want_calls}")
        mid = counts()
        err_max, err_sum = 0.0, 0.0
        with torch.no_grad():
            for c in range(0, AUDIO_B, 2):
                ref = reference.forward(trainer.store.tensors(), {"frames": frames["frames"][c : c + 2]})
                diff = (logits[c : c + 2] - ref).abs()
                err_max, err_sum = max(err_max, float(diff.max())), err_sum + float(diff.double().sum())
                del ref, diff
        check(mid == counts(), f"{cfg.name}: the reference encode launched a kernel")
        res = dict(version=step, logit_max_abs_err=err_max, logit_mean_abs_err=err_sum / logits.numel(),
                   logit_abs_max=float(logits.abs().max()), all_finite=bool(torch.isfinite(logits).all()),
                   shape=list(logits.shape))
        emit("encode_check", config=cfg.name, **res)
        check(res["all_finite"] and logits.shape == (AUDIO_B, s, cfg.vocab), f"{cfg.name} v{step}: encode output")
        check(err_max <= LOGIT_MAX_ABS and res["logit_mean_abs_err"] <= LOGIT_MEAN_ABS,
              f"{cfg.name} v{step}: logits {err_max} (max), {res['logit_mean_abs_err']} (mean) from the plain forward")
        with torch.no_grad():
            secs = [timed(lambda: plain.forward(params, frames))[1] for _ in range(3)]
        return logits, dict(res, encode_seconds=secs, frames_per_s=AUDIO_B * s / statistics.median(secs),
                            launches=by_route, attention_calls=sorted([r, list(q), list(k), c] for r, q, k, c in calls))

    logits0, round0 = encode_round(0)
    serve_peak = torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():  # where an encode's device time goes (off the main path's counts)
        encode_profile = device_profile(torch, lambda: plain.forward(params, frames))

    # the gradient on v0 (the replica has not updated: it holds v0 too),
    # through the recording model, against the plain attention's
    calls.clear()
    torch.cuda.reset_peak_memory_stats(dev)
    before = counts()
    grads, metrics = value_and_grad(make_loss_fn(model, cfg), weights, train_batch)
    launched = {k: v - before[k] for k, v in counts().items()}
    bwd_names = {f"tensor_core/{n}" for n in fa.bwd_kernels(d)}
    want = {"flash_route_tensor_core": layers, "flash_route_decode": 0, "flash_route_f32": 0,
            **{f"flash_attention_bwd_{n}": layers * (n in bwd_names) for n in BWD_LAUNCHES}}
    check({k: launched[k] for k in want} == want, f"{cfg.name} gradient launches {launched}, want {want}")
    want_calls = {("tensor_core", (AUDIO_TRAIN_B, hq, s, d), (AUDIO_TRAIN_B, cfg.num_kv_heads, s, d), False)}
    check(calls == want_calls, f"{cfg.name} step: attention calls {calls}, want {want_calls}")
    grad_max = {}
    for n, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"{cfg.name} {n}: gradient not finite")
        grad_max[n] = float(g.abs().max())
        check(grad_max[n] > 0, f"{cfg.name} {n}: zero gradient")
    mid = counts()
    mask = train_batch["mask"]
    total = float(mask.sum())
    ref = {n: torch.zeros(g.shape, dtype=torch.float32, device=dev) for n, g in grads.items()}
    ref_loss = 0.0
    for c in range(0, AUDIO_TRAIN_B, AUDIO_REF_CHUNK):  # each part's loss is its masked mean: weighted by its share
        part = {k: v[c : c + AUDIO_REF_CHUNK] for k, v in train_batch.items()}
        share = float(part["mask"].sum()) / total
        g, m = value_and_grad(make_loss_fn(reference, cfg), params, part)
        ref_loss += share * float(m["loss"])
        for n in ref:
            ref[n].add_(g[n].float(), alpha=share)
        del g
    check(mid == counts(), f"{cfg.name}: the reference gradient launched a kernel")
    grad_l2 = {n: rel_l2(torch, grads[n], ref[n]) for n in grads}
    loss_err = abs(float(metrics["loss"]) - ref_loss)
    emit("train_check", config=cfg.name, loss=float(metrics["loss"]), reference_loss=ref_loss, loss_abs_err=loss_err,
         grad_rel_l2=grad_l2, grad_tol=GRAD_TOL_PLAIN, grad_abs_max=grad_max,
         reference_parts=AUDIO_TRAIN_B // AUDIO_REF_CHUNK)
    for n, e in grad_l2.items():
        check(e <= GRAD_TOL_PLAIN, f"{cfg.name} {n}: gradient differs from the plain attention's by {e} (relative L2)")
    check(loss_err <= LOGIT_MEAN_ABS, f"{cfg.name}: loss {float(metrics['loss'])} vs reference {ref_loss}")
    del grads, ref
    gc.collect()
    torch.cuda.empty_cache()

    # the step, timed on the default model, AdamW in place on the trainer's registered buffers
    opt = AdamW(lr=1e-3, weight_decay=0.01)  # launch.train's rate
    state = opt.init(weights)
    train_step = make_train_step(plain, cfg, opt)
    trainer.unpublish()  # the step writes the registered buffers
    (_, step_launches), step_s = timed(lambda: span(lambda: train_step(weights, state, train_batch)))
    check({k: step_launches[k] for k in want} == want, f"{cfg.name} step launches {step_launches}, want {want}")
    _, publish_s = timed(lambda: span(lambda: trainer.publish(1)))
    train_peak = torch.cuda.max_memory_allocated(dev)
    # where the step's forward and backward go (the v1 weights, unchanged: no update)
    grad_profile = device_profile(torch, lambda: value_and_grad(make_loss_fn(plain, cfg), weights, train_batch))
    for n, w in weights.items():
        check(not torch.equal(params[n], w), f"{cfg.name} {n} did not change from v0 to v1")
    del state, opt, train_step
    gc.collect()
    torch.cuda.empty_cache()
    (updated, pulled1), update_s = timed(lambda: span(lambda: rollout.update("latest")))
    check(updated and rollout.current_version == 1, f"{cfg.name}: the rollout did not update to v1")
    equal_to_trainer("after update")
    logits1, round1 = encode_round(1)
    # the step shows above the encode's own distance from the plain forward
    delta = float((logits1 - logits0).abs().mean())
    noise = max(round0["logit_mean_abs_err"], round1["logit_mean_abs_err"])
    check(delta > 2 * noise and delta > 0, f"{cfg.name}: round 1 logits barely differ from round 0's ({delta}, "
          f"the encodes' own error {noise})")
    check(main["checksum"] > 0, f"{cfg.name}: the publish -> replicate -> update path launched no checksum")
    emit("audio_arch_result", card=smi, config=cfg.name, layers=layers, params=nparams, bytes=nbytes,
         frames=[AUDIO_B, s], replicate_seconds=replicate_s, update_seconds=update_s, publish_v1_seconds=publish_s,
         replicate_GBps=nbytes / replicate_s / 1e9, update_GBps=nbytes / update_s / 1e9,
         timed_model="build_model(cfg), default attention", rounds=[round0, round1],
         round1_vs_round0_mean_abs=delta, train_frames=[AUDIO_TRAIN_B, s], step_seconds=step_s,
         step_frames_per_s=AUDIO_TRAIN_B * s / step_s, step_launches=step_launches, loss=float(metrics["loss"]),
         serve_max_memory_allocated=serve_peak, train_max_memory_allocated=train_peak,
         encode_profile=encode_profile, gradient_profile=grad_profile)
    del model, reference, plain, params, weights, hub, trainer, rollout, logits0, logits1, frames, train_batch
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.launch import train

    steps, step_secs = 2, []
    make_step = train.make_train_step

    def timed_steps(*a, **kw):  # each step's seconds, ended by a synchronize
        step = make_step(*a, **kw)

        def run(*args):
            out, seconds = timed(lambda: step(*args))
            step_secs.append(seconds)
            return out

        return run

    train.make_train_step = timed_steps
    try:
        trained, losses = train_run(torch, every, ["--steps", str(steps)] + AUDIO_TRAIN_ARGV, cfg, steps)
    finally:
        train.make_train_step = make_step
    for k, v in trained.items():
        main[k] += v
    emit("audio_train_result", card=smi, config=cfg.name, layers=layers, dtype="float32", losses=losses,
         batch=AUDIO_F32_B, frames=s, step_seconds=step_secs, frames_per_s=AUDIO_F32_B * s / step_secs[-1],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=trained)
    out = {k: main[k] for k in counters}
    out["flash_attention_routes"] = {r: main[f"flash_route_{r}"] for r in ROUTE_LAUNCHES}
    out["flash_attention_bwd_by_kernel"] = {n: main[f"flash_attention_bwd_{n}"] for n in BWD_LAUNCHES}
    return out


# -- phase 16: the hybrid family (zamba2-2.7b) at its published widths -------------

#: zamba2's depth: 3 of its 9 groups of 6 Mamba2 blocks, each followed by a
#: call of the shared block, at the published widths (all 54 layers took
#: phase 16 149-185 s of the script's 1200 s limit)
HYBRID_LAYERS = 18
#: 8 requests of 512 prompt tokens, 64 new tokens each: every decode step's
#: 3 shared-block calls attend over 576 slots
HYBRID_B, HYBRID_PROMPT, HYBRID_GEN = 8, 512, 64
#: the ring decode: the window cut to 64 slots so that the ring wraps within
#: ``HYBRID_RING_STEPS`` steps of ``HYBRID_B`` sequences, then
#: ``HYBRID_RING_LONG`` steps at the published 4096 slots, every slot live
HYBRID_RING_WINDOW, HYBRID_RING_STEPS, HYBRID_RING_LONG = 64, 100, 4
#: phase 16's GRPO step through the RL loop: 2 prompts x 2 responses of
#: 512 + 64 tokens (phase 10's)
HYBRID_RL_PROMPTS, HYBRID_RL_GROUP = 2, 2
#: reference gradients phase 16's f32 RL loop holds at once (its f32
#: trainer keeps 38.8 GB of parameters, gradients and moments); its hubs
#: keep no delta base, whose snapshots of the retiring f32 version (9.7 GB
#: each) left the update's 5.4 GiB staging buffer no room on an 80 GB card
HYBRID_GRAD_BUDGET = 5 * GIB
#: launch.train at zamba2's published widths and ``HYBRID_LAYERS``, f32: 2 x 512
HYBRID_TRAIN_B, HYBRID_TRAIN_SEQ = 2, 512
HYBRID_TRAIN_ARGV = ["--arch", "zamba2-2.7b", "--full-config", "--batch", str(HYBRID_TRAIN_B), "--seq",
                     str(HYBRID_TRAIN_SEQ)]


def bf16_round_distances(torch, reference, weights, rec, version, name: str) -> dict:
    """A served bf16 round's distances to a replay of its calls with the
    plain attention (``replay_round``: the same prefill and decode ops, only
    the attention differs), held to phase 5's gates, and to the
    teacher-forced forward (the chunked scan over the whole sequence where
    the round ran the prefill's chunks and one-step recurrences), printed
    only: bf16 rounding alone moves the teacher-forced logits past phase 5's
    gates (0.71 max at ``HYBRID_LAYERS``; at all 54 random-init Mamba2 layers
    the replay's too, tools/hybrid_bf16_noise.py). The round must be finite.
    Returns the distances."""
    prompt_len = rec["tokens"].shape[1] - rec["step_logits"].shape[1]
    steps = rec["step_logits"]
    ref = replay_round(torch, reference, weights, rec, prompt_len)
    d = (steps - ref).abs()
    res = dict(version=version, gated=True, reference="replay of the served calls, plain attention",
               logit_max_abs_err=float(d.max()), logit_mean_abs_err=float(d.double().mean()),
               logit_abs_max=float(steps.abs().max()), all_finite=bool(torch.isfinite(steps).all()),
               mean_logprob=float(rec["behavior_logprobs"].mean()))
    del ref, d
    res["teacher_forced"] = check_served_round(torch, reference, weights, rec, version, chunk=2, gate=False)
    emit(f"serve_check {name} bfloat16", **res)
    check(res["all_finite"], f"{name} v{version}: non-finite logits")
    check(res["logit_max_abs_err"] <= LOGIT_MAX_ABS and res["logit_mean_abs_err"] <= LOGIT_MEAN_ABS,
          f"{name} v{version}: the bf16 round's logits against a replay with the plain attention {res}")
    return res


class SSDSpans:
    """Within ``with``: a CUDA event pair around every Mamba2 block call
    (``repro_torch.models.ssd.ssd_block_apply``, which ``HybridLM`` reaches
    through its module at each call, the recompute in a backward included),
    so ``ms()`` sums the blocks' spans on the stream: their share of a
    call's device time, the gaps between their kernels included. A
    recompute (``torch.utils.checkpoint``) that stops once it has the
    tensors the backward needs is spanned up to there."""

    def __enter__(self):
        import torch

        from repro_torch.models import ssd

        self.ssd, self.apply, self.pairs = ssd, ssd.ssd_block_apply, []

        def spanned(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            try:  # a backward's recompute stops early by an exception once it has what it needs
                return self.apply(*a, **kw)
            finally:
                end.record()
                self.pairs.append((start, end))

        ssd.ssd_block_apply = spanned
        return self

    def __exit__(self, *exc):
        self.ssd.ssd_block_apply = self.apply

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def ssd_share(torch, fn) -> dict:
    """``fn()`` between two CUDA events, with ``SSDSpans``: the call's
    device span in ms, the Mamba2 blocks' summed spans and their share."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with SSDSpans() as spans:
        start.record()
        fn()
        end.record()
        ssd_ms = spans.ms()
    total = start.elapsed_time(end)
    return dict(span_ms=total, ssd_ms=ssd_ms, ssd_share=ssd_ms / total, ssd_calls=len(spans.pairs))


def hybrid_arch(torch, dev, counters, smi: str) -> dict:
    """zamba2-2.7b (arXiv:2411.15242) at its published widths, its depth cut
    to ``HYBRID_LAYERS`` (18 of 54), in bf16 (d_model 2560; Mamba2 blocks of
    80 SSD heads of 64, state 64, conv 4, chunk 256, in groups of 6, each
    group followed by the one shared attention block, 32 query and 32 KV
    heads of 80, and its SwiGLU MLP of 10240; vocab 32000, untied head). Serving: a trainer (dc0)
    publishes v0, a rollout replica (dc0, raw) replicates it, and the model
    reads its parameters from the replica's registered buffers: it
    prefills 8 x 512 tokens and decodes 64 greedily; the trainer perturbs
    1/8 of its rows and publishes v1, the replica updates in place, and the
    same requests are served again. The replica must be bit-equal to the
    trainer after each pull, round 1 apart from round 0, every logit
    finite, and each round must launch one tensor-core forward a group (q/k/v
    [8,32,512,80]) and 64 decode-route ones a group (q [8,32,1,80] against
    [8,32,576,80]), none on f32; each bf16 round within phase 5's gates of
    a replay of its calls with the plain attention, its distance to the
    teacher-forced forward printed (``bf16_round_distances``: bf16 rounding
    alone moves that one past the gates). The f32 round: the same
    requests on v1 cast to f32, one f32-route prefill and 64 decode
    launches a group in f32, within phase 5's gates of the teacher-forced f32
    forward with the plain attention. The ring decode, on the f32 weights:
    from ``init_cache(..., ring=True)``, the window cut to 64 slots so that
    it wraps, 100 steps of 8 sequences, then 4 steps at the published 4096
    slots with every slot live (the ring filled with seeded K/V, the steps
    at position 4196), each step's logits within phase 5's gates of the
    same steps with the plain attention, one decode launch a group a step. The
    prefill and a decode step are timed on ``build_model(cfg)``'s default
    attention, and the prefill profiled (kernel classes; the Mamba2 blocks'
    share by CUDA events, ``ssd_share``). Then phase 6's RL loop at 2 x 2 x
    (512 + 64) in f32 (``rl_loop``: trainer -> publish -> rollout update,
    the f32 forward and the cuda_core backward, gradients held to the plain
    attention's and to the plain backward's, finite; bf16 gradients of
    these 54 layers are rounding noise), a bf16 GRPO forward and backward at
    its batch profiled the same way (the tensor_core forward and backward), and
    ``launch.train --arch zamba2-2.7b --full-config`` at the same depth
    (``train_config``) for two f32 steps of 2 x 512 on the f32 forward and
    the cuda_core backward. Returns the main
    path's launches: the served rounds, the ring decode, the RL loop and the
    f32 steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import PromptSet
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, ROUTE_LAUNCHES, attention_plain
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.training.steps import make_grpo_loss_fn, value_and_grad

    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=HYBRID_LAYERS)
    check(cfg.num_layers % cfg.ssm.shared_block_every == 0, f"{cfg.name}: {cfg.num_layers} layers are not whole groups")
    n_attn, hq, hkv, d = attention_layers(cfg), cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    check(d == 80 and hq == hkv, f"{cfg.name}: {hq}/{hkv} heads of {d}")
    every = {**counters, **{f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t

    def routes_since(before):
        return {r: c.value - before[r] for r, c in ROUTE_LAUNCHES.items()}

    hub = TensorHubClient(ReferenceServer(), device=dev)
    trainer = hub.open("hybrid", "trainer", 1, 0, datacenter="dc0")
    trainer.register(init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 200), torch.bfloat16, dev))
    trainer.publish(0)
    weights = trainer.store.tensors()
    nparams = sum(w.numel() for w in weights.values())
    rollout = hub.open("hybrid", "rollout-0", 1, 0, datacenter="dc0")
    rollout.register({n: torch.zeros_like(w) for n, w in weights.items()})
    nbytes = rollout.store.total_bytes
    emit("model", config=cfg.name, layers=cfg.num_layers, attention_calls=n_attn, dtype="bfloat16", params=nparams,
         bytes=nbytes)
    _, replicate_s = timed(lambda: rollout.replicate(0, timeout=600))

    def equal_to_trainer(when):
        for n, w in trainer.store.tensors().items():
            check(torch.equal(rollout.store.get(n), w), f"{cfg.name} {when}: rollout {n} != trainer")

    equal_to_trainer("after replicate")
    params = rollout.store.tensors()  # the registered buffers: an update is seen by the next round
    calls = set()  # each attention call's (route, q shape, k/v shape, causal)

    def attention(q, k, v, **kw):
        calls.add((fa._route(q, k, v=v), tuple(q.shape), tuple(k.shape), bool(kw.get("causal", True))))
        return fa.flash_attention(q, k, v, **kw)

    model = build_model(cfg, attention=attention)
    reference = build_model(cfg, attention=attention_plain)
    prompts = torch.from_numpy(PromptSet(cfg.vocab, HYBRID_PROMPT, seed=SEED).sample(HYBRID_B, 0)).to(dev, torch.int64)
    max_len = HYBRID_PROMPT + HYBRID_GEN
    want_route = {"tensor_core": n_attn, "decode": n_attn * HYBRID_GEN, "f32": 0}
    want_calls = {("tensor_core", (HYBRID_B, hq, HYBRID_PROMPT, d), (HYBRID_B, hkv, HYBRID_PROMPT, d), True),
                  ("decode", (HYBRID_B, hq, 1, d), (HYBRID_B, hkv, max_len, d), True)}

    def serve(params=params):
        """Prefill, then ``HYBRID_GEN`` greedy decode steps (the last one's
        logits unused, as ``sample_responses``)."""
        logits, cache, n = model.prefill(params, {"tokens": prompts}, max_len=max_len)
        toks, lps, steps = [], [], []
        for _ in range(HYBRID_GEN):
            last = logits[:, -1].float()
            nxt = last.argmax(-1)
            steps.append(last)
            lps.append(torch.log_softmax(last, -1).gather(-1, nxt[:, None])[:, 0])
            toks.append(nxt)
            logits, cache = model.decode(params, cache, nxt[:, None], n)
            n += 1
        check(n == max_len, f"{cfg.name}: the decode ended at cache length {n}, want {max_len}")
        return dict(tokens=torch.cat([prompts, torch.stack(toks, 1)], 1), behavior_logprobs=torch.stack(lps, 1),
                    step_logits=torch.stack(steps, 1))

    rounds, checks = [], []
    for step in range(2):
        if step:
            def perturb_and_publish():
                trainer.unpublish()
                gp = torch.Generator(device=dev).manual_seed(SEED + 31)
                for w in trainer.store.tensors().values():
                    flat = w.view(-1)
                    rows = flat[: flat.numel() // 256 * 256].view(-1, 256)[::8]  # 1/8 of the rows, in place
                    rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
                trainer.publish(1)

            _, publish_s = timed(perturb_and_publish)
            updated, update_s = timed(lambda: rollout.update("latest"))
            check(updated and rollout.current_version == 1, f"{cfg.name}: the rollout did not update to v1")
            equal_to_trainer("after update")
        before = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
        calls.clear()
        with torch.no_grad():
            rec, round_s = timed(serve)
        by_route = routes_since(before)
        check(by_route == want_route, f"{cfg.name} round {step}: flash launches by route {by_route}, want {want_route}")
        check(calls == want_calls, f"{cfg.name} round {step}: attention calls {calls}, want {want_calls}")
        rounds.append(dict(round=step, version=step, seconds=round_s, flash_launches_by_route=by_route,
                           attention_calls=sorted([r, list(q), list(k), c] for r, q, k, c in calls),
                           generated_tokens=HYBRID_B * HYBRID_GEN, tokens_per_s=HYBRID_B * HYBRID_GEN / round_s))
        mid = {k: c.value for k, c in every.items()}
        checks.append(bf16_round_distances(torch, reference, trainer.store.tensors(), rec, step, cfg.name))
        check(mid == {k: c.value for k, c in every.items()}, f"{cfg.name}: the checks launched a kernel")
        if step == 0:
            first0 = rec["step_logits"][:, 0].clone()
        else:
            delta = float((rec["step_logits"][:, 0] - first0).abs().mean())
            check(delta > 10 * LOGIT_MEAN_ABS, f"{cfg.name}: round 1 logits barely differ from round 0's ({delta})")
        del rec
    # the gated round: the same requests on v1 cast to f32, through the f32 kernels (the prefill on the f32
    # route, every decode step on the decode kernel at head_dim 80 in f32), against the teacher-forced f32
    # forward with the plain attention
    w32 = {n: w.float() for n, w in trainer.store.tensors().items()}
    before = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
    calls.clear()
    with torch.no_grad():
        rec, round_s = timed(lambda: serve(w32))
    by_route = routes_since(before)
    want32 = {"tensor_core": 0, "decode": n_attn * HYBRID_GEN, "f32": n_attn}
    check(by_route == want32, f"{cfg.name} f32 round: flash launches by route {by_route}, want {want32}")
    rounds.append(dict(round=2, version=1, dtype="float32", seconds=round_s, flash_launches_by_route=by_route,
                       attention_calls=sorted([r, list(q), list(k), c] for r, q, k, c in calls),
                       generated_tokens=HYBRID_B * HYBRID_GEN, tokens_per_s=HYBRID_B * HYBRID_GEN / round_s))
    mid = {k: c.value for k, c in every.items()}
    checks.append(check_served_round(torch, reference, w32, rec, 1, tag=f"serve_check {cfg.name} float32", chunk=2))
    check(mid == {k: c.value for k, c in every.items()}, f"{cfg.name}: the checks launched a kernel")
    del rec
    serve_peak = torch.cuda.max_memory_allocated(dev)

    # the ring decode (f32 weights, the gated dtype): the window cut so that the ring wraps, then the
    # published 4096 slots all live
    print(f"phase 16: the ring decode's window cut from {cfg.sliding_window} to {HYBRID_RING_WINDOW} slots so that "
          f"it wraps within {HYBRID_RING_STEPS} steps; then {HYBRID_RING_LONG} steps at {cfg.sliding_window} slots "
          "with every slot live", flush=True)
    ring = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 201)
    for label, window, steps, start in (("wrapping", HYBRID_RING_WINDOW, HYBRID_RING_STEPS, 0),
                                        ("published_window", cfg.sliding_window, HYBRID_RING_LONG,
                                         cfg.sliding_window + 100)):
        rcfg = dataclasses.replace(cfg, sliding_window=window)
        rmodel, rref = build_model(rcfg), build_model(rcfg, attention=attention_plain)
        cache = rmodel.init_cache(HYBRID_B, window, torch.float32, dev, ring=True)
        check(cache["attn"]["k"].shape == (n_attn, HYBRID_B, hkv, window, d) and cache["attn"]["k"].dtype == torch.float32,
              f"{cfg.name}: ring cache {tuple(cache['attn']['k'].shape)} {cache['attn']['k'].dtype}")
        if start:  # every slot live: the ring as if ``start`` steps had filled it
            for t in cache["attn"].values():
                t.normal_(generator=gen)
        ref_cache = {part: {n: t.clone() for n, t in entries.items()} for part, entries in cache.items()}
        toks = torch.randint(0, cfg.vocab, (HYBRID_B, steps), generator=gen, device=dev)
        before = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
        worst_max, err_sum, n_el, finite = 0.0, 0.0, 0, True
        ring_s = []
        with torch.no_grad():
            for i in range(steps):
                got, secs = timed(lambda: rmodel.decode(w32, cache, toks[:, i : i + 1], start + i, ring=True)[0])
                ring_s.append(secs)
                mid = {r: c.value for r, c in ROUTE_LAUNCHES.items()}
                want, _ = rref.decode(w32, ref_cache, toks[:, i : i + 1], start + i, ring=True)
                check(routes_since(mid) == {r: 0 for r in ROUTE_LAUNCHES}, f"{cfg.name}: the ring reference launched")
                diff = (got - want).abs()
                finite = finite and bool(torch.isfinite(got).all())
                worst_max = max(worst_max, float(diff.max()))
                err_sum += float(diff.double().sum())
                n_el += diff.numel()
        by_route = routes_since(before)
        want_ring = {"tensor_core": 0, "decode": n_attn * steps, "f32": 0}
        ring[label] = dict(window=window, steps=steps, first_position=start, batch=HYBRID_B,
                           logit_max_abs_err=worst_max, logit_mean_abs_err=err_sum / n_el, all_finite=finite,
                           flash_launches_by_route=by_route, step_seconds_median=statistics.median(ring_s))
        emit("ring_check", config=cfg.name, case=label, **ring[label])
        check(by_route == want_ring, f"{cfg.name} ring {label}: launches {by_route}, want {want_ring}")
        check(finite and worst_max <= LOGIT_MAX_ABS and err_sum / n_el <= LOGIT_MEAN_ABS,
              f"{cfg.name} ring {label}: logits against the plain attention's {ring[label]}")
        del cache, ref_cache, rmodel, rref
        torch.cuda.empty_cache()
    served = {k: c.value for k, c in every.items()}  # the serving path's launches, read now
    check(served["checksum"] > 0, f"{cfg.name}: the publish -> replicate -> update path launched no checksum")

    # the prefill and a decode step alone, at the served shapes, on the model as build_model builds it
    plain = build_model(cfg)
    with torch.no_grad():
        pb = {"tokens": prompts}
        prefill_s = statistics.median(timed(lambda: plain.prefill(params, pb, max_len=max_len))[1] for _ in range(3))
        _, cache, n = plain.prefill(params, pb, max_len=max_len)
        nxt = prompts[:, -1:]
        k = min(8, HYBRID_GEN - 2)  # timed steps; two more are traced, all within the cache's slots
        steps_s = [timed(lambda: plain.decode(params, cache, nxt, n + i))[1] for i in range(k)]
        prefill_ssd = ssd_share(torch, lambda: plain.prefill(params, pb, max_len=max_len))
        decode_ssd = ssd_share(torch, lambda: plain.decode(params, cache, nxt, n + k))
        prefill_prof = device_profile(torch, lambda: plain.prefill(params, pb, max_len=max_len))
        decode_prof = device_profile(torch, lambda: plain.decode(params, cache, nxt, n + k + 1))
    decode_step_s = statistics.median(steps_s)
    del cache, plain
    emit("hybrid_serve_profile", card=smi, config=cfg.name, prefill=prefill_prof, prefill_ssd=prefill_ssd,
         decode_step=decode_prof, decode_ssd=decode_ssd)
    hub_bytes = {"replicate_GBps": nbytes / replicate_s / 1e9, "update_GBps": nbytes / update_s / 1e9}
    emit("hybrid_arch_result", card=smi, config=cfg.name, layers=cfg.num_layers, attention_calls=n_attn, params=nparams,
         bytes=nbytes, requests=HYBRID_B, prompt_len=HYBRID_PROMPT, gen_len=HYBRID_GEN, cache_slots=max_len,
         replicate_seconds=replicate_s, publish_v1_seconds=publish_s, update_seconds=update_s, **hub_bytes,
         rounds=rounds, ring=ring, timed_model="build_model(cfg), default attention", prefill_seconds=prefill_s,
         prefill_tokens_per_s=HYBRID_B * HYBRID_PROMPT / prefill_s, decode_step_seconds=decode_step_s,
         decode_tokens_per_s=HYBRID_B / decode_step_s,
         round_tokens_per_s=HYBRID_B * HYBRID_GEN / rounds[1]["seconds"], prefill_ssd_share=prefill_ssd["ssd_share"],
         decode_ssd_share=decode_ssd["ssd_share"], max_memory_allocated=serve_peak, launches=served, checks=checks)
    del model, reference, params, weights, prompts, hub, trainer, rollout, w32
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6's RL loop and gates at zamba2's widths, in f32 (it resets the counters: the served launches
    # were read above): bf16 gradients of the random-init layers are rounding noise
    # (tools/hybrid_bf16_noise.py), so
    # the gradient gates hold in f32, on the f32 forward and the cuda_core backward at head_dim 80
    rl = rl_loop(torch, dev, counters, smi, cfg=cfg, num_prompts=HYBRID_RL_PROMPTS, group_size=HYBRID_RL_GROUP,
                 dtype=torch.float32, grad_budget=HYBRID_GRAD_BUDGET, delta_base=False)
    gc.collect()
    torch.cuda.empty_cache()

    # a GRPO forward and backward at the RL loop's batch (bf16, 4 x 576), profiled: the kernel classes and the
    # Mamba2 blocks' forward and recompute spans (their backward's kernels are not in the spans)
    b, s = HYBRID_RL_PROMPTS * HYBRID_RL_GROUP, PROMPT_LEN + GEN_LEN
    wts = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 202), torch.bfloat16, dev)
    tg = torch.Generator(device=dev).manual_seed(SEED + 203)
    mask = torch.zeros((b, s - 1), dtype=torch.bool, device=dev)
    mask[:, PROMPT_LEN - 1 :] = True
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=tg, device=dev),
             "behavior_logprobs": torch.where(mask, -10.5, 0.0), "loss_mask": mask,
             "advantages": torch.randn(b, generator=tg, device=dev)}
    loss_fn = make_grpo_loss_fn(build_model(cfg))
    value_and_grad(loss_fn, wts, batch)  # warm
    step_ssd = ssd_share(torch, lambda: value_and_grad(loss_fn, wts, batch))
    step_prof = device_profile(torch, lambda: value_and_grad(loss_fn, wts, batch))
    emit("hybrid_step_profile", card=smi, config=cfg.name, batch=[b, s], dtype="bfloat16",
         what="GRPO loss forward and backward (value_and_grad), AdamW excluded", step=step_prof,
         ssd_forward_and_recompute=step_ssd)
    del wts, batch, loss_fn
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.launch import train

    steps, step_s = 2, []
    make_step = train.make_train_step

    def timed_steps(*a, **kw):  # each step's seconds, ended by a synchronize
        step_fn = make_step(*a, **kw)

        def run(*args):
            res, seconds = timed(lambda: step_fn(*args))
            step_s.append(seconds)
            return res

        return run

    train.make_train_step = timed_steps
    try:
        with train_config(cfg):
            trained, losses = train_run(torch, every, ["--steps", str(steps)] + HYBRID_TRAIN_ARGV, cfg, steps)
    finally:
        train.make_train_step = make_step
    emit("hybrid_train_result", card=smi, config=cfg.name, layers=cfg.num_layers, dtype="float32", losses=losses,
         batch=HYBRID_TRAIN_B, positions=HYBRID_TRAIN_SEQ, step_seconds=step_s,
         tokens_per_s=HYBRID_TRAIN_B * HYBRID_TRAIN_SEQ / step_s[-1],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=trained)
    out = {k: served[k] + rl[k] + trained[k] for k in counters}
    out["flash_attention_routes"] = {r: served[f"flash_route_{r}"] + rl["flash_attention_routes"][r]
                                     + trained[f"flash_route_{r}"] for r in ROUTE_LAUNCHES}
    out["flash_attention_bwd_by_kernel"] = {n: served[f"flash_attention_bwd_{n}"] + rl["flash_attention_bwd_by_kernel"][n]
                                            + trained[f"flash_attention_bwd_{n}"] for n in BWD_LAUNCHES}
    return out


# -- phase 17: the SSM family (xlstm-350m) at its published widths ------------------

#: 8 requests of 512 prompt tokens, 64 new tokens each
XLSTM_B, XLSTM_PROMPT, XLSTM_GEN = 8, 512, 64
#: xlstm-350m's depth: 3 of its 12 (mLSTM, sLSTM) pairs at the published
#: widths (all 24 layers took phase 17 98-160 s of the script's 1200 s limit)
XLSTM_LAYERS = 6
#: phase 17's GRPO step through the RL loop (f32): 2 prompts x 2 responses
#: of 512 + 64 tokens. The step is host-bound (autograd through the sLSTM
#: steps), and a second step under the profiler reads back ~1M events for
#: minutes (PERF.md section 6), so the loop profiles no step
XLSTM_RL_PROMPTS, XLSTM_RL_GROUP = 2, 2
#: each tensor's gradient in the RL loop's step against the same step with
#: the mLSTM on its quadratic parallel form, relative L2. The two forms are
#: equal in exact arithmetic and differ in f32 by the order of their sums,
#: which random-init layers amplify: 1.4e-4 apart at 6 layers, 5-9% at 24
#: (tools/xlstm_grad_noise.py on the card, PERF.md section 6), a wrong
#: gradient's distance being ~1
XLSTM_GRAD_TOL = 1e-3
#: the block checks' bound, tests/test_blocks.py's (``allclose`` at rtol =
#: atol = 2e-3), at T = 512 (two chunks of 256), 16 one-step recurrences
#: after 496 positions, the sLSTM split at 5
XLSTM_BLOCK_TOL, XLSTM_BLOCK_T, XLSTM_STEPS, XLSTM_SPLIT = 2e-3, 512, 16, 5
#: launch.train at xlstm-350m's published widths and ``XLSTM_LAYERS``, f32: 2 x 512
XLSTM_TRAIN_B, XLSTM_TRAIN_SEQ = 2, 512
XLSTM_TRAIN_ARGV = ["--arch", "xlstm-350m", "--full-config", "--batch", str(XLSTM_TRAIN_B), "--seq",
                    str(XLSTM_TRAIN_SEQ)]


class XLSTMSpans:
    """Within ``with``: a CUDA event pair around every mLSTM and every sLSTM
    block call (``repro_torch.models.xlstm_blocks.mlstm_block_apply`` and
    ``slstm_block_apply``, which ``XLSTMLM`` reaches through the module at
    each call), so ``ms()`` sums each kind's spans on the stream: their
    share of a call's device time, the gaps between their kernels
    included."""

    KINDS = ("mlstm_block_apply", "slstm_block_apply")

    def __enter__(self):
        import torch

        from repro_torch.models import xlstm_blocks

        self.mod, self.fns, self.pairs = xlstm_blocks, {k: getattr(xlstm_blocks, k) for k in self.KINDS}, {}

        def spanned(kind):
            fn = self.fns[kind]

            def call(*a, **kw):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    return fn(*a, **kw)
                finally:
                    end.record()
                    self.pairs.setdefault(kind, []).append((start, end))

            return call

        for k in self.KINDS:
            setattr(xlstm_blocks, k, spanned(k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.fns.items():
            setattr(self.mod, k, fn)

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in self.pairs.get(k, [])) for k in self.KINDS}


def xlstm_share(torch, fn) -> dict:
    """``fn()`` between two CUDA events, with ``XLSTMSpans``: the call's
    device span in ms, the mLSTM and sLSTM blocks' summed spans and their
    shares of it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with XLSTMSpans() as spans:
        start.record()
        fn()
        end.record()
        by_kind = spans.ms()
    total = start.elapsed_time(end)
    m, s = by_kind["mlstm_block_apply"], by_kind["slstm_block_apply"]
    return dict(span_ms=total, mlstm_ms=m, slstm_ms=s, mlstm_share=m / total, slstm_share=s / total,
                mlstm_calls=len(spans.pairs.get("mlstm_block_apply", [])),
                slstm_calls=len(spans.pairs.get("slstm_block_apply", [])))


def allclose_err(torch, got, want, tol: float) -> float:
    """The largest ``|got - want| / (tol (1 + |want|))``: at most 1 where
    ``torch.allclose(got, want, rtol=tol, atol=tol)`` holds."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (tol * (1 + w.abs()))).max())


def xlstm_block_checks(torch, dev, cfg, weights) -> dict:
    """The block forms at xlstm-350m's widths in f32 on the card, on pair 0's
    blocks of ``weights`` (f32), within tests/test_blocks.py's 2e-3
    (``allclose_err`` <= 1): one mLSTM block's chunked form at T = 512 (two
    chunks of 256) against its quadratic parallel form, the output and the
    input's gradient; 16 one-step recurrences after a chunked prefix of 496
    positions against the chunked form over all 512, their final state
    against the parallel form's folded state (under one stabiliser); the
    sLSTM over 512 positions split at 5 against the whole sequence."""
    from repro_torch.models import xlstm_blocks as xb

    m = {n.rsplit("/", 1)[-1]: t[0, 0] for n, t in weights.items() if n.startswith("pairs/mlstm/")}
    s = {n.rsplit("/", 1)[-1]: t[0] for n, t in weights.items() if n.startswith("pairs/slstm/")}
    g = torch.Generator(device=dev).manual_seed(SEED + 301)
    t, k = XLSTM_BLOCK_T, XLSTM_STEPS
    x = torch.randn(2, t, cfg.d_model, generator=g, device=dev)
    cot = torch.randn(2, t, cfg.d_model, generator=g, device=dev)
    res = {}

    def grad_of(form):
        xg = x.clone().requires_grad_(True)
        with torch.enable_grad():
            out, state = xb.mlstm_block_apply(cfg, m, xg, form=form)
            (gx,) = torch.autograd.grad((out * cot).sum(), xg)
        return out.detach(), {n: v.detach() for n, v in state.items()}, gx

    chunked, c_state, c_grad = grad_of("chunked")
    parallel, p_state, p_grad = grad_of("parallel")
    res["mlstm_chunked_vs_parallel"] = dict(
        T=t, chunks=-(-t // 256), output_err_over_tol=allclose_err(torch, chunked, parallel, XLSTM_BLOCK_TOL),
        input_grad_err_over_tol=allclose_err(torch, c_grad, p_grad, XLSTM_BLOCK_TOL),
        output_max_abs_err=float((chunked - parallel).abs().max()),
        input_grad_max_abs_err=float((c_grad - p_grad).abs().max()), input_grad_abs_max=float(p_grad.abs().max()))
    with torch.no_grad():
        _, state = xb.mlstm_block_apply(cfg, m, x[:, : t - k])
        outs = []
        for i in range(t - k, t):
            o, state = xb.mlstm_block_apply(cfg, m, x[:, i : i + 1], cache=state)
            outs.append(o)
        steps = torch.cat(outs, 1)
    state_errs = {}
    for n in ("c", "n"):  # each form's state under its own stabiliser m: brought to the steps'
        shape = (*p_state["m"].shape, *([1] * (p_state[n].dim() - 2)))
        folded = p_state[n] * torch.exp(p_state["m"] - state["m"]).reshape(shape)
        state_errs[n] = allclose_err(torch, state[n], folded, XLSTM_BLOCK_TOL)
    res["mlstm_steps_vs_chunked"] = dict(
        prefix=t - k, steps=k, output_err_over_tol=allclose_err(torch, steps, chunked[:, t - k :], XLSTM_BLOCK_TOL),
        folded_state_err_over_tol=state_errs, output_max_abs_err=float((steps - chunked[:, t - k :]).abs().max()))
    with torch.no_grad():
        whole, whole_s = xb.slstm_block_apply(cfg, s, x)
        a, st = xb.slstm_block_apply(cfg, s, x[:, :XLSTM_SPLIT])
        b, split_s = xb.slstm_block_apply(cfg, s, x[:, XLSTM_SPLIT:], cache=st)
    res["slstm_split_vs_whole"] = dict(
        T=t, split=XLSTM_SPLIT, output_err_over_tol=allclose_err(torch, torch.cat([a, b], 1), whole, XLSTM_BLOCK_TOL),
        state_err_over_tol={n: allclose_err(torch, split_s[n], whole_s[n], XLSTM_BLOCK_TOL) for n in ("h", "c", "n")})
    emit("xlstm_block_check", config=cfg.name, dtype="float32", tol=XLSTM_BLOCK_TOL, **res)
    for label, r in res.items():
        for key, v in r.items():
            if key.endswith("err_over_tol"):
                for part, e in (v.items() if isinstance(v, dict) else [("", v)]):
                    check(math.isfinite(e) and e <= 1, f"{cfg.name} {label} {key} {part}: {e} over the tolerance")
    return res


def xlstm_arch(torch, dev, counters, smi: str) -> dict:
    """xlstm-350m (arXiv:2405.04517) at its published widths, its depth cut
    to ``XLSTM_LAYERS`` (6 of 24) (d_model 1024, pairs of one mLSTM block,
    d_in 2048 in 4 heads of 512, and one sLSTM block, 4 heads of 256; vocab
    50304, untied head).
    No attention and no kernel of its own: its blocks are PyTorch ops.
    Serving, bf16: a trainer (dc0) publishes v0; a rollout replica (dc0,
    raw) replicates it and the model reads its parameters from the
    replica's registered buffers: it prefills 8 x 512 tokens (the chunked
    mLSTM, the sLSTM loop) and decodes 64 greedily (one step of each
    block's recurrence a token); a second replica (dc1) replicates v0 over
    ``int8``. The trainer perturbs 1/8 of its rows and publishes v1; the
    raw replica updates in place and the dc1 one over ``delta:int8``, and
    the same requests are served again. The raw replica must be bit-equal
    to the trainer after each pull, the dc1 one bit-equal to the plain
    codec's decode of the same bytes (phase 3's check), round 1 apart from
    round 0, every logit finite; each bf16 round's distances to the
    teacher-forced forward are printed, not gated (bf16 rounding alone moves
    this model's logits past phase 5's gates). The gated round: the same
    requests on v1 cast to f32, within phase 5's gates of the teacher-forced
    f32 forward, and bit-equal on a rerun. The block forms in f32 at these
    widths (``xlstm_block_checks``). The prefill and a decode step timed on
    ``build_model(cfg)``, profiled by kernel class, and the mLSTM and sLSTM
    blocks' shares of their spans (``xlstm_share``).
    Then phase 6's RL loop at 2 x 2 x (512 + 64) in f32 (``rl_loop``: its
    gradients held to the step with the mLSTM on its parallel form within
    ``XLSTM_GRAD_TOL``), and
    ``launch.train --arch xlstm-350m --full-config`` at the same depth
    (``train_config``) for two f32 steps of 2 x 512. An ``xlstm_phase_seconds`` line gives each part's seconds. Returns
    the main path's launches: the served rounds and pulls, the RL loop and
    the f32 steps (no flash kernel anywhere)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ReferenceServer, TensorHubClient
    from repro_torch.data.synthetic import PromptSet
    from repro_torch.kernels.flash_attention import BWD_LAUNCHES, ROUTE_LAUNCHES
    from repro_torch.kernels.quant import quantize_rows_plain
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.transfer.codec import DeltaCodec, Int8Codec

    cfg = dataclasses.replace(get_config("xlstm-350m"), num_layers=XLSTM_LAYERS)
    check(attention_layers(cfg) == 0, f"{cfg.name}: {attention_layers(cfg)} attention calls")
    part_s, mark = {}, [time.perf_counter()]

    def lap(part):  # the seconds since the last lap
        now = time.perf_counter()
        part_s[part] = now - mark[0]
        mark[0] = now
    every = {**counters, **{f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    torch.cuda.reset_peak_memory_stats(dev)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize(dev)
        return res, time.perf_counter() - t

    server = ReferenceServer()
    hub = TensorHubClient(server, device=dev)
    trainer = hub.open("xlstm", "trainer", 1, 0, datacenter="dc0")
    trainer.register(init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 300), torch.bfloat16, dev))
    _, publish0_s = timed(lambda: trainer.publish(0))
    weights = trainer.store.tensors()
    nparams = sum(w.numel() for w in weights.values())
    rollout = hub.open("xlstm", "rollout-0", 1, 0, datacenter="dc0")
    rollout.register({n: torch.zeros_like(w) for n, w in weights.items()})
    remote = hub.open("xlstm", "rollout-1", 1, 0, datacenter="dc1")
    remote.register({n: torch.zeros_like(w) for n, w in weights.items()})
    nbytes = rollout.store.total_bytes
    emit("model", config=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model, attention_calls=0, dtype="bfloat16",
         params=nparams, param_count=cfg.param_count(), bytes=nbytes, tensors=len(weights))
    _, replicate_s = timed(lambda: rollout.replicate(0, timeout=600))
    _, replicate_int8_s = timed(lambda: remote.replicate(0, timeout=600))

    def equal_to_trainer(when):
        for n, w in trainer.store.tensors().items():
            check(torch.equal(rollout.store.get(n), w), f"{cfg.name} {when}: rollout {n} != trainer")

    equal_to_trainer("after replicate")
    params = rollout.store.tensors()  # the registered buffers: an update is seen by the next round
    model = build_model(cfg)
    prompts = torch.from_numpy(PromptSet(cfg.vocab, XLSTM_PROMPT, seed=SEED).sample(XLSTM_B, 0)).to(dev, torch.int64)

    def serve(params=params):
        """Prefill, then ``XLSTM_GEN`` greedy decode steps (the last one's
        logits unused, as ``sample_responses``)."""
        logits, cache, n = model.prefill(params, {"tokens": prompts})
        toks, lps, steps = [], [], []
        for _ in range(XLSTM_GEN):
            last = logits[:, -1].float()
            nxt = last.argmax(-1)
            steps.append(last)
            lps.append(torch.log_softmax(last, -1).gather(-1, nxt[:, None])[:, 0])
            toks.append(nxt)
            logits, cache = model.decode(params, cache, nxt[:, None], n)
            n += 1
        check(all(t.dtype == torch.float32 for part in cache.values() for t in part.values()),
              f"{cfg.name}: the recurrent cache is not f32")
        return dict(tokens=torch.cat([prompts, torch.stack(toks, 1)], 1), behavior_logprobs=torch.stack(lps, 1),
                    step_logits=torch.stack(steps, 1))

    rounds, checks = [], []
    for step in range(2):
        if step:
            def perturb_and_publish():
                trainer.unpublish()
                gp = torch.Generator(device=dev).manual_seed(SEED + 302)
                for w in trainer.store.tensors().values():
                    flat = w.view(-1)
                    rows = flat[: flat.numel() // 256 * 256].view(-1, 256)[::8]  # 1/8 of the rows, in place
                    rows.add_(torch.randn(rows.shape, generator=gp, device=dev, dtype=torch.bfloat16).mul_(0.01))
                trainer.publish(1)

            _, publish_s = timed(perturb_and_publish)
            updated, update_s = timed(lambda: rollout.update("latest"))
            check(updated and rollout.current_version == 1, f"{cfg.name}: the rollout did not update to v1")
            equal_to_trainer("after update")
            updated, update_delta_s = timed(lambda: remote.update("latest"))
            check(updated and remote.current_version == 1, f"{cfg.name}: the dc1 replica did not update to v1")
        with torch.no_grad():
            rec, round_s = timed(serve)
        rounds.append(dict(round=step, version=step, dtype="bfloat16", seconds=round_s,
                           generated_tokens=XLSTM_B * XLSTM_GEN, tokens_per_s=XLSTM_B * XLSTM_GEN / round_s))
        mid = {k: c.value for k, c in every.items()}
        res = check_served_round(torch, model, trainer.store.tensors(), rec, step, chunk=XLSTM_B, gate=False)
        res["gated"] = False
        emit(f"serve_check {cfg.name} bfloat16", **res)
        check(res["all_finite"], f"{cfg.name} v{step}: non-finite logits")
        checks.append(res)
        check(mid == {k: c.value for k, c in every.items()}, f"{cfg.name}: the checks launched a kernel")
        if step == 0:
            first0 = rec["step_logits"][:, 0].clone()
        else:
            delta = float((rec["step_logits"][:, 0] - first0).abs().mean())
            check(delta > 10 * LOGIT_MEAN_ABS, f"{cfg.name}: round 1 logits barely differ from round 0's ({delta})")
        del rec
    served = {k: c.value for k, c in every.items()}  # the serving path's launches, read now
    lap("publish_replicate_serve_update_serve")

    # the dc1 replica against the plain-version codec on the same bytes, unit
    # by unit (phase 3's check): v0 as the int8 codec decodes it, v1 as the
    # delta:int8 codec decodes it against that base
    plain_int8 = Int8Codec(quantize=quantize_rows_plain)
    plain_delta = DeltaCodec("int8", quantize=quantize_rows_plain)
    check(hub.transport.delta_stale_fallbacks == 0, f"{cfg.name}: delta fell back to int8 (stale base)")
    check(server.stats.get("delta_assignments", 0) >= 1, f"{cfg.name}: no delta assignment negotiated")
    worst = 0.0
    for u in trainer.store.units:
        dtype = trainer.store.unit_dtype(u)
        wire = plain_delta.encode(trainer.store._gather_unit(u), dtype, base=trainer.store.base_unit(u))
        check(torch.equal(remote.store._gather_unit(u), plain_delta.decode(wire, base=remote.store.base_unit(u))),
              f"{cfg.name}: dc1 unit {u.name} != the plain delta codec")
        held_v0 = plain_int8.decode(plain_int8.encode(trainer.store.base_unit(u), dtype))
        check(torch.equal(remote.store.base_unit(u), held_v0), f"{cfg.name}: dc1 v0 unit {u.name} != the plain int8 codec")
    for n, w in trainer.store.tensors().items():
        worst = max(worst, max_rel_err(torch, remote.store.get(n), w))
    check(worst < 0.01, f"{cfg.name}: dc1 replica max relative error {worst} >= 1%")
    units = trainer.store.units
    codec = dict(units=len(units), dc1_max_rel_err=worst, int8_replicate_seconds=replicate_int8_s,
                 delta_update_seconds=update_delta_s,
                 wire_bytes={k: v for k, v in hub.transport.wire_bytes.items() if v},
                 decoded_bytes={k: v for k, v in hub.transport.decoded_bytes.items() if v},
                 r_gates_units=sorted(u.name for u in units if any("r_gates" in n for n in (u.members or (u.name,)))),
                 server_stats={k: v for k, v in server.stats.items() if v})
    emit("codec_check", config=cfg.name, **codec)
    after_codec = {k: c.value for k, c in every.items()}  # the plain codecs' checksums launch the kernel
    lap("codec_check")

    # the gated round: the same requests on v1 cast to f32, against the teacher-forced f32 forward, then again
    w32 = {n: w.float() for n, w in trainer.store.tensors().items()}
    f32_rounds = []
    for again in range(2):
        with torch.no_grad():
            rec, round_s = timed(lambda: serve(w32))
        f32_rounds.append(rec)
        rounds.append(dict(round=2 + again, version=1, dtype="float32", seconds=round_s,
                           generated_tokens=XLSTM_B * XLSTM_GEN, tokens_per_s=XLSTM_B * XLSTM_GEN / round_s))
    rerun_equal = all(torch.equal(f32_rounds[0][k], f32_rounds[1][k]) for k in f32_rounds[0])
    check(rerun_equal, f"{cfg.name}: the f32 round's rerun is not bit-equal")
    checks.append(check_served_round(torch, model, w32, f32_rounds[0], 1, tag=f"serve_check {cfg.name} float32",
                                     chunk=XLSTM_B))
    del f32_rounds, rec
    serve_peak = torch.cuda.max_memory_allocated(dev)
    lap("f32_rounds")
    blocks = xlstm_block_checks(torch, dev, cfg, w32)
    lap("block_checks")
    check({k: c.value for k, c in every.items()} == after_codec, f"{cfg.name}: the f32 rounds launched a kernel")

    # the prefill and a decode step alone, at the served shapes, on the model as build_model builds it
    plain = build_model(cfg)
    with torch.no_grad():
        pb = {"tokens": prompts}
        prefill_s = statistics.median(timed(lambda: plain.prefill(params, pb))[1] for _ in range(3))
        _, cache, n = plain.prefill(params, pb)
        nxt = prompts[:, -1:]
        steps_s = [timed(lambda: plain.decode(params, cache, nxt, n + i))[1] for i in range(8)]
        prefill_share = xlstm_share(torch, lambda: plain.prefill(params, pb))
        decode_share = xlstm_share(torch, lambda: plain.decode(params, cache, nxt, n))
        prefill_prof = device_profile(torch, lambda: plain.prefill(params, pb), cpu=False)
        decode_prof = device_profile(torch, lambda: plain.decode(params, cache, nxt, n), cpu=False)
    decode_step_s = statistics.median(steps_s)
    del cache, plain
    lap("timed_and_profiled")
    emit("xlstm_serve_profile", card=smi, config=cfg.name, prefill=prefill_prof, prefill_blocks=prefill_share,
         decode_step=decode_prof, decode_blocks=decode_share)
    emit("xlstm_arch_result", card=smi, config=cfg.name, layers=cfg.num_layers, params=nparams, bytes=nbytes,
         requests=XLSTM_B, prompt_len=XLSTM_PROMPT, gen_len=XLSTM_GEN, publish_v0_seconds=publish0_s,
         replicate_seconds=replicate_s, publish_v1_seconds=publish_s, update_seconds=update_s,
         replicate_GBps=nbytes / replicate_s / 1e9, update_GBps=nbytes / update_s / 1e9, rounds=rounds,
         f32_rerun_bit_equal=rerun_equal, timed_model="build_model(cfg)", prefill_seconds=prefill_s,
         prefill_tokens_per_s=XLSTM_B * XLSTM_PROMPT / prefill_s, decode_step_seconds=decode_step_s,
         decode_tokens_per_s=XLSTM_B / decode_step_s, prefill_mlstm_share=prefill_share["mlstm_share"],
         prefill_slstm_share=prefill_share["slstm_share"], decode_mlstm_share=decode_share["mlstm_share"],
         decode_slstm_share=decode_share["slstm_share"], max_memory_allocated=serve_peak, launches=served,
         checks=checks, block_checks=blocks)
    for k in ("checksum", "quantize_rows"):
        check(served[k] > 0, f"{cfg.name}: the publish -> replicate -> update path launched no {k}")
    check(not any(v for k, v in served.items() if k.startswith("flash")),
          f"{cfg.name}: a flash kernel was launched ({served})")
    del model, params, weights, prompts, hub, trainer, rollout, remote, w32
    gc.collect()
    torch.cuda.empty_cache()

    # phase 6's RL loop at xlstm-350m's widths in f32 (it resets the counters: the served launches were read
    # above), its gradients held to the step with the mLSTM on its parallel form
    rl = rl_loop(torch, dev, counters, smi, cfg=cfg, num_prompts=XLSTM_RL_PROMPTS, group_size=XLSTM_RL_GROUP,
                 dtype=torch.float32, grad_tol=XLSTM_GRAD_TOL, profile=False)
    gc.collect()
    torch.cuda.empty_cache()
    lap("rl_loop")

    from repro_torch.launch import train

    steps, step_s = 2, []
    make_step = train.make_train_step

    def timed_steps(*a, **kw):  # each step's seconds, ended by a synchronize
        step_fn = make_step(*a, **kw)

        def run(*args):
            res, seconds = timed(lambda: step_fn(*args))
            step_s.append(seconds)
            return res

        return run

    train.make_train_step = timed_steps
    try:
        with train_config(cfg):
            trained, losses = train_run(torch, every, ["--steps", str(steps)] + XLSTM_TRAIN_ARGV, cfg, steps)
    finally:
        train.make_train_step = make_step
    lap("launch_train")
    emit("xlstm_phase_seconds", config=cfg.name, card=smi, **part_s, total=sum(part_s.values()))
    emit("xlstm_train_result", card=smi, config=cfg.name, layers=cfg.num_layers, dtype="float32", losses=losses,
         batch=XLSTM_TRAIN_B, positions=XLSTM_TRAIN_SEQ, step_seconds=step_s,
         tokens_per_s=XLSTM_TRAIN_B * XLSTM_TRAIN_SEQ / step_s[-1],
         max_memory_allocated=torch.cuda.max_memory_allocated(), launches=trained)
    out = {k: served[k] + rl[k] + trained[k] for k in counters}
    check(not any(v for k, v in out.items() if k.startswith("flash")), f"{cfg.name}: a flash kernel was launched")
    return out


# -- phase 18: sharding and flags (the smoke mesh, H3's fallback, H2) --------------

#: H2's norm alone: phase 5's prefill rows at llama3-8b's width
H2_NORM_SHAPE = (SERVE_BATCH * PROMPT_LEN, 4096)
H2_NORM_TOL = 2e-2  # bf16, of the f32 norm's max |value|
SMOKE_MESH_BYTES = GIB
H3_TOKENS = (4, 512)  # the reduced dbrx layer's input, batch x sequence
H2_PASSES = 2  # each H2 setting's turns in a model
H2_TIMED = 2  # calls a turn timed by the host clock, and then profiled


def sharding_flags(torch, dev, counters, smi: str, bw: float) -> dict:
    """Phase 18: the smoke mesh and its placements, H3's fallback on it,
    H2's norm alone and in llama3-8b's prefill and hubert's encode (see the
    module's docstring). Returns the flash launches of the two models'
    calls with H2 off and on (the logits', the timed and the profiled ones)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import audio_batch
    from repro_torch.kernels.flash_attention import ROUTE_LAUNCHES
    from repro_torch.launch import make_smoke_mesh, mesh_num_devices
    from repro_torch.models import blocks, build_model, optim
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.params import decoder_specs, init_params
    from repro_torch.sharding import SERVE_RULES, placements_for, sharding_for, spec_for

    # the smoke mesh: every llama3-8b tensor replicated, 1 GiB there and back
    mesh = make_smoke_mesh(dev)
    check(dist.get_backend() == "nccl" and mesh_num_devices(mesh) == 1, f"smoke mesh {mesh}")
    llama = get_config("llama3-8b")
    placed = {n: sharding_for(p, SERVE_RULES, mesh) for n, p in decoder_specs(llama)}
    check(all(pl == (Replicate(), Replicate()) for pl in placed.values()), f"smoke mesh placements {placed}")
    big = torch.randn(SMOKE_MESH_BYTES // 4, generator=torch.Generator(device=dev).manual_seed(SEED + 180),
                      device=dev)
    dt = distribute_tensor(big, mesh, placed["embed"])
    round_trip = bool(torch.equal(dt.to_local(), big) and torch.equal(dt.full_tensor(), big))
    check(round_trip, "a tensor distributed over the smoke mesh came back changed")
    emit("smoke_mesh", card=smi, backend=dist.get_backend(), shape=list(mesh.shape), names=list(mesh.mesh_dim_names),
         tensors=len(placed), placements=sorted({str(pl) for pl in placed.values()}), bytes=big.numel() * 4,
         bit_equal=round_trip)
    del big, dt

    # H3 on one device: the reference's tp <= 1 fallback, bit-equal to moe_apply
    dbrx = get_config("dbrx-132b").reduced()
    params = init_params(dbrx, torch.Generator(device=dev).manual_seed(SEED + 181), torch.bfloat16, dev)
    layer = {n: params[f"layers/ffn/{n}"][0] for n in blocks.moe_specs(dbrx)}
    x = torch.randn(*H3_TOKENS, dbrx.d_model, generator=torch.Generator(device=dev).manual_seed(SEED + 182),
                    device=dev).to(torch.bfloat16)
    specs = blocks.moe_specs(dbrx)
    with torch.no_grad():
        want = blocks.moe_apply(dbrx, layer, x)
        with optim.optimizations(mesh=mesh, shardmap_moe=True):
            plain = blocks.moe_apply_shardmap(dbrx, layer, x)
            xd = distribute_tensor(x, mesh, placements_for(spec_for(tuple(x.shape), ("batch", "seq", "act_embed"),
                                                                    SERVE_RULES, mesh), mesh))
            dts = blocks.moe_apply_shardmap(
                dbrx, {n: distribute_tensor(t, mesh, sharding_for(specs[n], SERVE_RULES, mesh)) for n, t in layer.items()},
                xd)
    h3 = dict(plain_bit_equal=bool(torch.equal(plain, want)), dtensor=isinstance(dts, DTensor),
              dtensor_bit_equal=bool(torch.equal(dts.full_tensor(), want)), same_placements=dts.placements == xd.placements)
    emit("h3_fallback", card=smi, config=dbrx.name, tokens=list(H3_TOKENS), **h3)
    check(all(h3.values()), f"H3 on the smoke mesh is not moe_apply: {h3}")
    del params, layer
    dist.destroy_process_group()

    # H2's norm alone, off and on, against the f32 norm in float64
    g = torch.Generator(device=dev).manual_seed(SEED + 183)
    xn = (torch.randn(H2_NORM_SHAPE, generator=g, device=dev) * 3).to(torch.bfloat16)
    gamma = (torch.randn(H2_NORM_SHAPE[-1], generator=g, device=dev) * 0.3).to(torch.bfloat16)
    xd64 = xn.double()
    exact = xd64 * torch.rsqrt(xd64.square().mean(-1, keepdim=True) + 1e-6) * (1 + gamma.double())
    scale = float(exact.abs().max())
    del xd64
    norm = {label: dict(ms_by_turn=[]) for label in ("off", "on")}
    for label, on in (("off", False), ("on", True), ("on", True), ("off", False)):  # in turns
        with optim.optimizations(lowp_norm=on):
            out = rms_norm(xn, gamma)
            norm[label]["ms_by_turn"].append(time_ms(torch, lambda: rms_norm(xn, gamma), reps=20))
        err = float((out.double() - exact).abs().max()) / scale
        norm[label]["err_over_max"] = err
        check(err <= H2_NORM_TOL, f"H2 {label}: rms_norm {err} of the f32 norm's max from it")
    for r in norm.values():
        r["ms"] = statistics.median(r["ms_by_turn"])
    bound_ms = 2 * xn.numel() * xn.element_size() / bw * 1e3
    emit("h2_norm", card=smi, shape=list(H2_NORM_SHAPE), dtype="bfloat16", bound_ms=bound_ms, bound_by="bytes",
         **norm, on_over_off=norm["on"]["ms"] / norm["off"]["ms"])
    del xn, exact

    # H2 in the models: llama3-8b's prefill and hubert's encode, off and on
    every = {**counters, **{f"flash_route_{r}": c for r, c in ROUTE_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    hubert = get_config("hubert-xlarge")
    cases = {
        "llama3-8b_prefill": (llama, lambda: {"tokens": torch.randint(0, llama.vocab, (SERVE_BATCH, PROMPT_LEN),
                                                                      generator=torch.Generator(device=dev).manual_seed(
                                                                          SEED + 184), device=dev)},
                              lambda m, p, b: m.prefill(p, b, max_len=PROMPT_LEN)[0], llama.num_layers),
        "hubert_encode": (hubert, lambda: {"frames": torch.from_numpy(audio_batch(
            AUDIO_B, AUDIO_FRAMES, hubert.frontend_dim, hubert.vocab, SEED)["frames"]).to(dev)},
                          lambda m, p, b: m.forward(p, b), hubert.num_layers),
    }
    models = {}
    for name, (cfg, make_batch, call, layers) in cases.items():
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 185), torch.bfloat16, dev)
        model, batch = build_model(cfg), make_batch()
        logits, calls = {}, []
        runs = {label: dict(wall=[], busy=[], idle=[], by_class={}, flash_launches=dict.fromkeys(ROUTE_LAUNCHES, 0))
                for label in ("off", "on")}

        def run():
            calls.append(1)
            return call(model, params, batch)

        # the settings in turns, twice (off, on, off, on): a drift of the
        # card's clocks between them shows as a spread, not as H2's effect
        for label, on in (("off", False), ("on", True)) * H2_PASSES:
            r = runs[label]
            before = {k: c.value for k, c in every.items()}
            calls.clear()
            with torch.no_grad(), optim.optimizations(lowp_norm=on):
                if label not in logits:
                    logits[label] = run()
                    torch.cuda.synchronize(dev)
                for _ in range(H2_TIMED):
                    t0 = time.perf_counter()
                    run()
                    torch.cuda.synchronize(dev)
                    r["wall"].append(time.perf_counter() - t0)
                n0 = len(calls)
                prof = device_profile(torch, lambda: [run() for _ in range(H2_TIMED)])
                per_call = H2_TIMED / (len(calls) - n0)  # a retried trace ran the calls again
            r["busy"].append(prof["device_busy_seconds"] * 1e3 * per_call / H2_TIMED)
            r["idle"].append(prof["idle_share"])
            for c, v in prof["by_class"].items():
                r["by_class"].setdefault(c, []).append(v["seconds"] * 1e3 * per_call / H2_TIMED)
            launched = {k[len("flash_route_"):]: every[k].value - before[k] for k in every if k.startswith("flash_route_")}
            want = {"tensor_core": len(calls) * layers, "decode": 0, "f32": 0}
            check(launched == want, f"{name} H2 {label}: flash launches by route {launched}, want {want}")
            for k, n in launched.items():
                r["flash_launches"][k] += n
        for label, r in runs.items():
            busy = statistics.mean(r["busy"])
            runs[label] = dict(
                wall_ms=statistics.median(r["wall"]) * 1e3, device_ms=busy, device_ms_by_pass=r["busy"],
                idle_share_by_pass=r["idle"],
                class_ms={c: statistics.mean(v) for c, v in r["by_class"].items()},
                elementwise_share=statistics.mean(r["by_class"].get("elementwise", [0.0])) / busy,
                flash_launches=r["flash_launches"])
        ok = all(bool(torch.isfinite(t).all()) for t in logits.values())
        check(ok and logits["on"].shape == logits["off"].shape, f"{name}: H2 logits not finite or of another shape")
        diff = (logits["on"] - logits["off"]).abs()
        models[name] = dict(layers=layers, shape=list(logits["on"].shape), **runs,
                            h2_logit_max_abs_diff=float(diff.max()), h2_logit_mean_abs_diff=float(diff.mean()),
                            logit_abs_max=float(logits["off"].abs().max()),
                            device_ms_on_over_off=runs["on"]["device_ms"] / runs["off"]["device_ms"])
        emit("h2_model", card=smi, case=name, dtype="bfloat16", **models[name])
        del params, model, batch, logits, diff
        gc.collect()
        torch.cuda.empty_cache()
    out = {k: every[k].value for k in counters}
    out["flash_attention_routes"] = {r: every[f"flash_route_{r}"].value for r in ROUTE_LAUNCHES}
    return out


# -- phase 19: the sharded train step (H1 over a DeviceMesh) on the smoke mesh ---------

#: phase 19's batch: one LM batch of 4 sequences of 512 tokens, llama3-8b at
#: ``TRAIN_LAYERS``
SHARDED_B, SHARDED_S = 4, 512
SHARDED_TURNS = 3  # synchronized turns of each step after its gated one, for its seconds
#: (b), the DTensor step, against (a), the plain one: each gradient's
#: relative L2 (bit-equal expected: on the 1x1 mesh every op runs on whole
#: tensors)
SHARDED_GRAD_TOL = 1e-6
#: (c), the DTensor step under H1, against (a): the loss (relative) and the
#: parameters after the step (max |difference|); its gradients within
#: ``GRAD_TOL_BWD`` (relative L2): the attention runs at G = 1 on K/V
#: broadcast to the 32 query heads, and the broadcast's backward sums each
#: KV head's four gradients in bf16
SHARDED_LOSS_TOL, SHARDED_PARAM_TOL = 1e-3, 5e-3


def sharded_step(torch, dev, counters, smi: str, bw: float) -> dict:
    """Phase 19: llama3-8b at its published widths and ``TRAIN_LAYERS`` in
    bf16 with f32 moments, one LM batch of ``SHARDED_B`` x ``SHARDED_S``,
    three steps of ``make_train_step`` (AdamW's defaults, its gradient clip
    through ``global_norm``) from the same parameters and moments: (a) on
    plain tensors; (b) on DTensors placed by ``TRAIN_RULES`` on the 1x1
    NCCL smoke mesh (``place_tree``; the batch placed by ``("batch",
    "seq")``); (c) the same under H1 (``shard_attn_heads``: K/V broadcast
    to the 32 query heads, the attention on each rank's local block, here
    the whole [4,32,512,128]). The parameters and moments are those after
    one warm step of (a), kept as one host copy and written back into the
    one trainer's tensors before each step. Gates: (b)'s gradients within
    ``SHARDED_GRAD_TOL`` of (a)'s; (c)'s loss, gradients and parameters
    after the step within ``SHARDED_LOSS_TOL``, ``GRAD_TOL_BWD`` and
    ``SHARDED_PARAM_TOL``; every attention call of (a) and (b) at q
    [4,32,512,128], k/v [4,8,512,128] and of (c) at k/v [4,32,512,128] (G
    = 1), each turn launching one tensor-core forward and each tensor-core
    backward kernel a layer. Each step's seconds (median of
    ``SHARDED_TURNS`` synchronized turns after the gated one), the seconds
    its call takes to return (the host's enqueue), its peak memory and one
    profiled turn's device busy time and idle share. Then the G = 1
    forward and backward alone (``g1_attention_times``). Returns the
    steps' launches and the G = 1 records."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import make_smoke_mesh
    from repro_torch.models import build_model, optim
    from repro_torch.models.params import decoder_specs, init_params
    from repro_torch.sharding import TRAIN_RULES, place_tree, placements_for, spec_for
    from repro_torch.training import AdamW, AdamWState, make_train_step, steps

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=TRAIN_LAYERS)
    layers, hq, hkv, d = cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    every = {**counters, **{f"flash_route_{r}": c for r, c in fa.ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in fa.BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    mesh = make_smoke_mesh(dev)
    check(dist.get_backend() == "nccl", f"smoke mesh backend {dist.get_backend()}")
    calls = set()

    def attention(q, k, v, **kw):
        calls.add((fa._route(q, k, v=v, grad=True), tuple(q.shape), tuple(k.shape)))
        return fa.flash_attention(q, k, v, **kw)

    model = build_model(cfg, attention=attention)
    opt = AdamW()
    train_step = make_train_step(model, cfg, opt)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 190), torch.bfloat16, dev)
    tokens = torch.randint(0, cfg.vocab, (SHARDED_B, SHARDED_S), generator=torch.Generator(device=dev).manual_seed(
        SEED + 191), device=dev)
    batch = {"tokens": tokens}
    state = opt.init(params)
    _, state, _ = train_step(params, state, batch)  # the warm step: moments of a trainer under way
    host = {k: {n: t.to("cpu", copy=True) for n, t in tree.items()} for k, tree in (("params", params), ("mu", state.mu),
                                                                     ("nu", state.nu))}
    warm_step = state.step
    specs = dict(decoder_specs(cfg))
    placed = place_tree(params, specs, TRAIN_RULES, mesh)
    placed_state = AdamWState(warm_step, place_tree(state.mu, specs, TRAIN_RULES, mesh),
                              place_tree(state.nu, specs, TRAIN_RULES, mesh))
    tspec = spec_for(tuple(tokens.shape), ("batch", "seq"), TRAIN_RULES, mesh)
    placed_batch = {"tokens": distribute_tensor(tokens, mesh, placements_for(tspec, mesh))}
    torch.cuda.synchronize(dev)

    def local(t):
        return t.to_local() if optim.is_dtensor(t) else t

    def restore(p, st):
        for key, tree in (("params", p), ("mu", st.mu), ("nu", st.nu)):
            for n, t in tree.items():
                local(t).copy_(host[key][n])
        return AdamWState(warm_step, st.mu, st.nu)

    value_and_grad, seen = steps.value_and_grad, {}

    def recording(*a, **kw):  # the gated turn's gradients and metrics
        grads, metrics = value_and_grad(*a, **kw)
        seen.update(grads={n: local(g) for n, g in grads.items()}, metrics=metrics)
        return grads, metrics

    cases = {"a_plain": (params, state, batch, {}),
             "b_dtensor": (placed, placed_state, placed_batch, {}),
             "c_dtensor_h1": (placed, placed_state, placed_batch, dict(mesh=mesh, shard_attn_heads=True))}
    want_launches = {"flash_route_tensor_core": layers, "flash_route_decode": 0, "flash_route_f32": 0,
                     **{f"flash_attention_bwd_{n}": layers * (n.startswith("tensor_core/") and n.split("/")[1]
                                                              in fa.bwd_kernels(d)) for n in fa.BWD_LAUNCHES}}
    results, ref = {}, {}
    for label, (p, st, b, flags) in cases.items():
        st = restore(p, st)
        calls.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        before = {k: c.value for k, c in every.items()}
        steps.value_and_grad = recording
        try:
            with optim.optimizations(**flags):
                _, _, metrics = train_step(p, st, b)
        finally:
            steps.value_and_grad = value_and_grad
        torch.cuda.synchronize(dev)
        turn = {k: every[k].value - before[k] for k in want_launches}
        check(turn == want_launches, f"phase 19 {label}: a step's launches {turn}, want {want_launches}")
        kv = hq if flags else hkv
        want_calls = {("tensor_core", (SHARDED_B, hq, SHARDED_S, d), (SHARDED_B, kv, SHARDED_S, d))}
        check(calls == want_calls, f"phase 19 {label}: attention calls {calls}, want {want_calls}")
        loss = float(metrics["loss"])
        grads = seen.pop("grads")
        after = {n: local(t) for n, t in p.items()}
        rec = dict(loss=loss, attention_calls=sorted([r, list(q), list(k)] for r, q, k in calls),
                   launches_per_turn=turn)
        if label == "a_plain":
            ref = dict(loss=loss, grads={n: g.clone() for n, g in grads.items()},
                       params={n: t.clone() for n, t in after.items()})
        else:
            errs = {n: rel_l2(torch, grads[n].float(), ref["grads"][n].float()) for n in ref["grads"]}
            rec.update(grad_rel_l2=errs, grad_rel_l2_max=max(errs.values()),
                       grads_bit_equal=all(torch.equal(grads[n], ref["grads"][n]) for n in ref["grads"]),
                       loss_rel_diff=abs(loss - ref["loss"]) / abs(ref["loss"]),
                       param_max_abs_diff=max(float((after[n].float() - ref["params"][n].float()).abs().max())
                                              for n in after))
        del grads, after
        wall, host_s = [], []
        with optim.optimizations(**flags):
            for _ in range(SHARDED_TURNS):
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                train_step(p, st, b)
                host_s.append(time.perf_counter() - t0)
                torch.cuda.synchronize(dev)
                wall.append(time.perf_counter() - t0)
            prof = device_profile(torch, lambda: train_step(p, st, b))
        rec.update(step_seconds=statistics.median(wall), step_seconds_by_turn=wall,
                   host_return_seconds=statistics.median(host_s), max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                   device_busy_seconds=prof["device_busy_seconds"], idle_share=prof["idle_share"],
                   by_class={c: v["seconds"] for c, v in prof["by_class"].items()})
        results[label] = rec
        emit("sharded_step", card=smi, case=label, config=cfg.name, layers=layers, batch=[SHARDED_B, SHARDED_S],
             dtype="bfloat16", moments="float32", **rec)
    launches = {k: c.value for k, c in every.items()}  # the main path's, read now
    a = results["a_plain"]
    for label in ("b_dtensor", "c_dtensor_h1"):
        r = results[label]
        r.update(over_a=r["step_seconds"] / a["step_seconds"], extra_seconds=r["step_seconds"] - a["step_seconds"],
                 extra_host_return_seconds=r["host_return_seconds"] - a["host_return_seconds"],
                 extra_share_of_step=(r["step_seconds"] - a["step_seconds"]) / r["step_seconds"])
    b_, c_ = results["b_dtensor"], results["c_dtensor_h1"]
    emit("sharded_step_result", card=smi, config=cfg.name,
         seconds={k: v["step_seconds"] for k, v in results.items()},
         host_return_seconds={k: v["host_return_seconds"] for k, v in results.items()},
         idle_share={k: v["idle_share"] for k, v in results.items()},
         over_a={k: results[k]["over_a"] for k in ("b_dtensor", "c_dtensor_h1")},
         extra_share_of_step={k: results[k]["extra_share_of_step"] for k in ("b_dtensor", "c_dtensor_h1")},
         b_grad_rel_l2_max=b_["grad_rel_l2_max"], b_grads_bit_equal=b_["grads_bit_equal"],
         c_loss_rel_diff=c_["loss_rel_diff"], c_grad_rel_l2_max=c_["grad_rel_l2_max"],
         c_param_max_abs_diff=c_["param_max_abs_diff"],
         gates=dict(b_grad=SHARDED_GRAD_TOL, c_loss=SHARDED_LOSS_TOL, c_grad=GRAD_TOL_BWD, c_param=SHARDED_PARAM_TOL))
    worst_b = max(b_["grad_rel_l2"].items(), key=lambda kv: kv[1])
    check(b_["grad_rel_l2_max"] <= SHARDED_GRAD_TOL, f"phase 19: the DTensor step's gradient of {worst_b[0]} is "
                                                     f"{worst_b[1]} (rel. L2) from the plain step's")
    check(c_["loss_rel_diff"] <= SHARDED_LOSS_TOL, f"phase 19: H1's loss {c_['loss']} against {a['loss']}")
    check(c_["grad_rel_l2_max"] <= GRAD_TOL_BWD, f"phase 19: H1's gradients {c_['grad_rel_l2']}")
    check(c_["param_max_abs_diff"] <= SHARDED_PARAM_TOL, f"phase 19: H1's parameters {c_['param_max_abs_diff']} away")
    del params, state, placed, placed_state, ref, host, model, train_step, batch, placed_batch, tokens
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    g1 = g1_attention_times(torch, dev, bw, (SHARDED_B, hq, SHARDED_S, d))
    out = {k: launches[k] for k in counters}
    out["flash_attention_routes"] = {r: launches[f"flash_route_{r}"] for r in fa.ROUTE_LAUNCHES}
    out["flash_attention_bwd_by_kernel"] = {n: launches[f"flash_attention_bwd_{n}"] for n in fa.BWD_LAUNCHES}
    out["g1"] = g1
    return out


def g1_attention_times(torch, dev, bw: float, shape) -> dict:
    """Phase 19's attention alone: the tensor_core forward and backward at
    G = 1 (q/k/v ``shape`` = [4,32,512,128] bf16 causal, H1's K/V broadcast
    to the query heads), each held to its plain version at phase 2's
    tolerances (the backward through the autograd Function, twice for
    bit-equal gradients, against autograd of the plain attention) and timed
    with the L2 cold beside the plain version and SDPA with ``is_causal``
    (cuDNN's backend where it takes the call, named), with the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 192)

    def rand():
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    q, k, v = rand(), rand(), rand()
    tol = FLASH_TOL["bfloat16"]
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    label = f"q/k/v {list(shape)} bf16 causal, G 1"
    check(fa._route(q, k) == "tensor_core", f"G 1 routed to {fa._route(q, k)}")
    got = fa.flash_attention(q, k, v, causal=True).float()
    want = fa.attention_plain(q, k, v, causal=True).float()
    diff = (got - want).abs()
    ratio = float((diff / (tol + tol * want.abs())).max())
    emit("flash_check", case=f"phase 19 {label}", route="tensor_core", max_abs_err=float(diff.max()), tol=tol,
         err_over_tol=ratio)
    check(ratio <= 1.0 and bool(torch.isfinite(got).all()), "tensor_core != plain version at G 1")
    backend = sdpa_backend(torch, lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    calls = {"kernel": lambda: fa.flash_attention(q, k, v, causal=True),
             "plain": lambda: fa.attention_plain(q, k, v, causal=True),
             "sdpa": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)}
    with sdpa_kernel([backend]):
        cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        sdpa_diff = float((calls["sdpa"]().float() - got).abs().max())
    bound, by, flops, nbytes = flash_bound_ms(q, k, shape[2], True, 0, bw)
    out = {"forward": dict(route="tensor_core", shape=label, ms=cold["kernel"], plain_ms=cold["plain"],
                           library_ms=cold["sdpa"], library=str(backend), bound_ms=bound, bound_by=by, flops=flops,
                           bytes=nbytes, max_abs_err=float(diff.max()), err_over_tol=ratio,
                           sdpa_max_abs_diff=sdpa_diff)}
    emit("flash_g1_times", case="forward", card_rate=bw, **out["forward"])
    del got, want, diff

    dout = rand()

    def grads():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = {n: c.value for n, c in fa.BWD_LAUNCHES.items()}
        res = torch.autograd.grad(fa.flash_attention(*leaves, causal=True), leaves, dout)
        check(all(fa.BWD_LAUNCHES[f"tensor_core/{n}"].value == before[f"tensor_core/{n}"] + 1
                  for n in fa.bwd_kernels(shape[3])), "tensor_core backward not launched at G 1")
        return res

    got, again = grads(), grads()
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fa.attention_plain(*ref, causal=True), ref, dout)
    errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    emit("flash_bwd_check", case=f"phase 19 {label}", forward_route="tensor_core", backward_route=fa._bwd_route(q),
         rel_err=errs, tol=tol, finite=finite, bit_equal_rerun=same)
    check(finite and max(errs.values()) <= tol and same, "tensor_core backward != autograd of the plain version at "
          "G 1, or two runs differ")
    o, lse = fa.launch_route("tensor_core", q, k, v, with_lse=True, causal=True)
    sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel([backend]):
        sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True)
        calls = {"kernel": lambda: fa.launch_backward(q, k, v, o, lse, dout, causal=True, route="tensor_core"),
                 "plain": lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, causal=True),
                 "sdpa": lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True)}
        cold = {n: cold_ms(torch, f, flush, reps=5 if n == "plain" else 20) for n, f in calls.items()}
        sdpa_rel = max(grad_err(torch, a, w) for a, w in zip(got, calls["sdpa"]()))
    bound, by, flops, nbytes = bwd_bound_ms(q, k, shape[2], True, 0, bw, BF16_TFLOPS)
    out["backward"] = dict(route="tensor_core", shape=label, ms=cold["kernel"], plain_ms=cold["plain"],
                           library_ms=cold["sdpa"], library=str(backend), bound_ms=bound, bound_by=by, flops=flops,
                           bytes=nbytes, rel_err_vs_plain=errs, err_over_tol=max(errs.values()) / tol,
                           max_abs_err=max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)),
                           sdpa_rel_diff=sdpa_rel)
    emit("flash_g1_times", case="backward", card_rate=bw, **out["backward"])
    del q, k, v, dout, got, again, ref, want, o, lse, sq_, sk_, sv_, sdpa_out, calls, flush
    torch.cuda.empty_cache()
    return out


# -- phase 20: the dry run and its cost model -------------------------------------------

#: (a): the cells the dry run traces on the faked 16x16 mesh, in a process of
#: its own on the host's CPU, started with the script and read in phase 20
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"), ("llama3-8b", "decode_32k"),
                ("dbrx-132b", "train_4k"), ("deepseek-v3-671b", "decode_32k"), ("internvl2-2b", "decode_32k"),
                ("hubert-xlarge", "prefill_32k"))
DRYRUN_TIMEOUT = 900.0  # seconds the script waits for the dry run at phase 20 (it runs beside phases 2-19)
DRYRUN_THREADS = 2  # its intra-op threads: the phases beside it keep the host's other cores
#: (b): llama3-8b's three cells on the card, cut to it: shape -> (batch, layers).
#: prefill_32k at 1 of its 32 sequences (16.1 GB of weights, 4.3 GB of
#: cache), decode_32k at 8 of 128 (one data rank's share on 16; 34.4 GB of
#: cache of 32768 slots), train_4k at 2 x 4096 and 4 layers (f32 moments
#: and the 4.2 GB of f32 logits beside the weights)
CARD_CELLS = {"prefill_32k": (1, 32), "decode_32k": (8, 32), "train_4k": (2, 4)}
CARD_TURNS = 3  # timed calls of each cell after its warm-up and its counted call


def dryrun_child_main(argv) -> int:
    """``chip_smoke.py --dryrun``: phase 20 (a) in a process of its own,
    started with the script and the card hidden from it: the fake process
    group of 256 ranks (``launch.dryrun.start_fake_world``) and
    ``DRYRUN_CELLS`` through ``launch.dryrun.run_cell`` (nothing
    allocated, no card touched), one ``dryrun_cell`` JSON line a cell
    (``"ok": false`` with the error where a cell does not trace)."""
    import torch

    from repro_torch.launch.dryrun import run_cell, start_fake_world

    del argv
    torch.set_num_threads(DRYRUN_THREADS)
    start_fake_world(256)
    ok = True
    for arch, shape in DRYRUN_CELLS:
        try:
            rec = run_cell(arch, shape, multi_pod=False, verbose=False)
        except Exception as e:  # noqa: BLE001 - reported, and the parent fails the run on it
            rec = {"arch": arch, "shape": shape, "ok": False, "error": f"{type(e).__name__}: {e}"}
            ok = False
        emit("dryrun_cell", **rec)
    return 0 if ok else 1


def start_dryrun():
    """The dry run's process (:func:`dryrun_child_main`), the card hidden,
    its output into a temporary file: ``(process, file)``."""
    import os
    import tempfile

    log = tempfile.TemporaryFile(mode="w+")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun"], stdout=log,
                            stderr=subprocess.STDOUT, env=env, cwd=str(ROOT), text=True)
    return proc, log


def finish_dryrun(child) -> list:
    """Phase 20 (a)'s records: wait for the dry run (``DRYRUN_TIMEOUT``),
    kill it past that, and fail the run unless every cell traced."""
    proc, log = child
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"phase 20: the dry run took over {DRYRUN_TIMEOUT} s")
    log.seek(0)
    lines = log.read().splitlines()
    log.close()
    recs = []
    for ln in lines:
        if ln.startswith('{"phase": "dryrun_cell"'):
            recs.append(json.loads(ln))
    if rc != 0 or len(recs) != len(DRYRUN_CELLS) or not all(r["ok"] for r in recs):
        print("\n".join(lines[-40:]), flush=True)
        raise SmokeFailure(f"phase 20: the dry run exited {rc} with {[(r['arch'], r['shape'], r.get('error')) for r in recs]}")
    for r in recs:
        print(json.dumps(r), flush=True)
    return recs


def cost_model_kernels(torch, dev, bw: float) -> dict:
    """The kernels at the shapes phase 20 gives them that no earlier phase
    does, each held to its plain version at phase 2's tolerance and timed
    with the L2 cold beside the plain version and SDPA (its backend named)
    and its bound: the tensor-core forward at llama3-8b's prefill of one
    32768-token sequence (q [1,32,32768,128], k/v [1,8,...]; the plain
    version, whose f32 scores of 32 heads at once would take 137 GB, runs a
    query head at a time against its KV head, every head held and the whole
    loop timed), the
    decode route at 32768 slots and batch 8 (q [8,32,1,128], the split plan
    of ``split_plan``), and the tensor-core forward (with the lse) and
    backward at the training shape [2,32/8,4096,128]."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 200)
    tol = FLASH_TOL["bfloat16"]
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(bf16)

    def held(label, route, got, want):
        diff = (got.float() - want.float()).abs()
        ratio = float((diff / (tol + tol * want.float().abs())).max())
        emit("flash_check", case=f"phase 20 {label}", route=route, max_abs_err=float(diff.max()), tol=tol,
             err_over_tol=ratio)
        check(ratio <= 1.0 and bool(torch.isfinite(got).all()), f"phase 20: {route} != plain version on {label}")
        return float(diff.max()), ratio

    out = {}
    # the prefill of one 32768-token sequence
    s = 32768
    q, k, v = rand(1, 32, s, 128), rand(1, 8, s, 128), rand(1, 8, s, 128)
    label = f"q [1,32,{s},128], k/v [1,8,{s},128] bf16 causal"
    check(fa._route(q, k) == "tensor_core", f"phase 20: the long prefill routed to {fa._route(q, k)}")
    group = q.shape[1] // k.shape[1]

    def plain_by_head():
        return torch.cat([fa.attention_plain(q[:, h:h + 1], k[:, h // group:h // group + 1],
                                             v[:, h // group:h // group + 1], causal=True)
                          for h in range(q.shape[1])], dim=1)

    err, ratio = held(label + " (every query head)", "tensor_core", fa.launch_route("tensor_core", q, k, v, causal=True),
                      plain_by_head())
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    backend = sdpa_backend(torch, sdpa)
    with sdpa_kernel([backend]):
        cold = {"kernel": cold_ms(torch, lambda: fa.launch_route("tensor_core", q, k, v, causal=True), flush, reps=5),
                "plain": cold_ms(torch, plain_by_head, flush, reps=1, warmup=0),
                "sdpa": cold_ms(torch, sdpa, flush, reps=5)}
    bound, by, flops, nbytes = flash_bound_ms(q, k, s, True, 0, bw)
    out["prefill_32k"] = dict(route="tensor_core", shape=label, ms=cold["kernel"], plain_ms=cold["plain"],
                              library_ms=cold["sdpa"], library=str(backend), bound_ms=bound, bound_by=by,
                              flops=flops, bytes=nbytes, max_abs_err=err, err_over_tol=ratio)
    emit("cost_model_kernel", case="prefill_32k", card_rate=bw, **out["prefill_32k"])
    del q, k, v
    torch.cuda.empty_cache()

    # a decode step at 32768 slots, batch 8
    q, k, v = rand(8, 32, 1, 128), rand(8, 8, s, 128), rand(8, 8, s, 128)
    kw = dict(causal=True, q_offset=s - 1, kv_len=s)
    label = f"q [8,32,1,128] vs k/v [8,8,{s},128] bf16, kv_len {s}"
    check(fa._route(q, k) == "decode", f"phase 20: the decode step routed to {fa._route(q, k)}")
    keys, nsplit = fa.split_plan(s, 8 * 8)
    err, ratio = held(label, "decode", fa.launch_route("decode", q, k, v, **kw), fa.attention_plain(q, k, v, **kw))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)  # noqa: E731
    backend = sdpa_backend(torch, sdpa)
    with sdpa_kernel([backend]):
        cold = {"kernel": cold_ms(torch, lambda: fa.launch_route("decode", q, k, v, **kw), flush),
                "plain": cold_ms(torch, lambda: fa.attention_plain(q, k, v, **kw), flush, reps=5),
                "sdpa": cold_ms(torch, sdpa, flush)}
    bound, by, flops, nbytes = flash_bound_ms(q, k, s, True, s - 1, bw)
    out["decode_32k"] = dict(route="decode", shape=label, split_plan=[keys, nsplit], ms=cold["kernel"],
                             plain_ms=cold["plain"], library_ms=cold["sdpa"], library=str(backend), bound_ms=bound,
                             bound_by=by, flops=flops, bytes=nbytes, max_abs_err=err, err_over_tol=ratio)
    emit("cost_model_kernel", case="decode_32k", card_rate=bw, **out["decode_32k"])
    del q, k, v
    torch.cuda.empty_cache()

    # the training shape: the forward with the lse, and the backward
    b, s = 2, 4096
    q, k, v, dout = rand(b, 32, s, 128), rand(b, 8, s, 128), rand(b, 8, s, 128), rand(b, 32, s, 128)
    label = f"q [{b},32,{s},128], k/v [{b},8,{s},128] bf16 causal"
    o, lse = fa.launch_route("tensor_core", q, k, v, causal=True, with_lse=True)
    err, ratio = held(label + " with the lse", "tensor_core", o, fa.attention_plain(q, k, v, causal=True))
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)  # noqa: E731
    backend = sdpa_backend(torch, sdpa)
    with sdpa_kernel([backend]):
        cold = {"kernel": cold_ms(torch, lambda: fa.launch_route("tensor_core", q, k, v, causal=True, with_lse=True),
                                  flush),
                "plain": cold_ms(torch, lambda: fa.attention_plain(q, k, v, causal=True), flush, reps=3, warmup=1),
                "sdpa": cold_ms(torch, sdpa, flush)}
    bound, by, flops, nbytes = flash_bound_ms(q, k, s, True, 0, bw)
    out["train_4k_forward"] = dict(route="tensor_core", shape=label + ", with the lse", ms=cold["kernel"],
                                   plain_ms=cold["plain"], library_ms=cold["sdpa"], library=str(backend),
                                   bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, max_abs_err=err,
                                   err_over_tol=ratio)
    emit("cost_model_kernel", case="train_4k_forward", card_rate=bw, **out["train_4k_forward"])
    got = fa.launch_backward(q, k, v, o, lse, dout, causal=True, route="tensor_core")
    want = fa.attention_backward_plain(q, k, v, o, lse, dout, causal=True)
    errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    emit("flash_bwd_check", case=f"phase 20 {label}", backward_route="tensor_core", rel_err=errs, tol=tol)
    check(max(errs.values()) <= tol and all(bool(torch.isfinite(a).all()) for a in got),
          f"phase 20: the tensor_core backward != its plain version on {label}: {errs}")
    max_abs = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
    del got, want
    sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel([backend]):
        sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True, enable_gqa=True)
        cold = {"kernel": cold_ms(torch, lambda: fa.launch_backward(q, k, v, o, lse, dout, causal=True,
                                                                    route="tensor_core"), flush),
                "plain": cold_ms(torch, lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, causal=True), flush,
                                 reps=3, warmup=1),
                "sdpa": cold_ms(torch, lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True),
                                flush)}
    bound, by, flops, nbytes = bwd_bound_ms(q, k, s, True, 0, bw, BF16_TFLOPS)
    out["train_4k_backward"] = dict(route="tensor_core", shape=label, ms=cold["kernel"], plain_ms=cold["plain"],
                                    library_ms=cold["sdpa"], library=str(backend), bound_ms=bound, bound_by=by,
                                    flops=flops, bytes=nbytes, rel_err_vs_plain=errs, max_abs_err=max_abs,
                                    err_over_tol=max(errs.values()) / tol)
    emit("cost_model_kernel", case="train_4k_backward", card_rate=bw, **out["train_4k_backward"])
    del q, k, v, dout, o, lse, sq_, sk_, sv_, sdpa_out, flush
    torch.cuda.empty_cache()
    return out


def card_cell_inputs(torch, dev, mesh, cfg, case, params):
    """A cut cell's inputs on the card, placed on the smoke mesh as the
    dry run's cell places them (``cells.build_cell``'s rules and specs):
    the batch, a decode's cache (random, drawn a layer at a time) and its
    tokens; a train step's AdamW state."""
    from repro_torch.launch.cells import input_specs
    from repro_torch.models.params import decoder_specs
    from repro_torch.sharding import place_tree, rules_for
    from repro_torch.training import AdamW

    rules = rules_for(case.kind, global_batch=case.global_batch)
    g = torch.Generator(device=dev).manual_seed(SEED + 201)
    placed = place_tree(params, dict(decoder_specs(cfg)), rules, mesh)
    if case.kind == "train":
        tokens = torch.randint(0, cfg.vocab, (case.global_batch, case.seq_len), generator=g, device=dev)
        (spec_, _), = input_specs(cfg, case).values()
        opt = AdamW()
        return (placed, opt.init(placed), {"tokens": place_tree(tokens, spec_, rules, mesh)})
    if case.kind == "prefill":
        tokens = torch.randint(0, cfg.vocab, (case.global_batch, case.seq_len), generator=g, device=dev)
        (spec_, _), = input_specs(cfg, case).values()
        return (placed, {"tokens": place_tree(tokens, spec_, rules, mesh)})
    from repro_torch.models import build_model
    from repro_torch.models.params import spec

    model = build_model(cfg)
    cache = model.init_cache(case.global_batch, case.seq_len, torch.bfloat16, dev, mesh=mesh)
    for tree in cache["layers"].values():
        for layer in tree.to_local():
            layer.normal_(generator=g)
    tokens = torch.randint(0, cfg.vocab, (case.global_batch, 1), generator=g, device=dev)
    return (placed, cache, place_tree(tokens, spec((case.global_batch, 1), ("batch", None)), rules, mesh),
            case.seq_len - 1)


def cost_model(torch, dev, counters, smi: str, bw: float, child) -> dict:
    """Phase 20: the dry run and its cost model on the card. (a) The dry
    run's records of ``DRYRUN_CELLS`` on the faked 16x16 mesh (its process
    started with the script, :func:`finish_dryrun`): each cell's counts,
    three terms, dominant term and fractions printed; a cell that does not
    trace fails the run. (b) llama3-8b's three cells at its published
    widths, cut to the card (``CARD_CELLS``), on the 1x1 NCCL smoke mesh
    through the cells' model (the attention through the kernel operators)
    and step functions: first each cell's step at one layer with the
    operators and with the default ``flash_attention`` path, logits (and a
    train step's loss and gradients) bit-equal, else the run fails; then,
    with every count at 0, each cell's warm-up call, one call under the
    counting mode of ``launch.op_costs`` on the real tensors and
    ``CARD_TURNS`` calls timed with CUDA events; the launch counts read
    (each call of the prefill 32 tensor-core forwards, of the decode 32
    decode-route launches, of the train step 4 tensor-core forwards and 4
    of each tensor-core backward kernel), and the real run's dot FLOPs and
    collective counts held equal to those of the same cell traced on fake
    tensors at world 1 (``op_costs.analyze_cell``: cut depths extended,
    so the extension is held to a full-depth run too). Each cell's
    measured seconds beside the trace's bound, their ratio and the model
    FLOPs' share of the card's peak, and ``max_memory_allocated`` beside
    the trace's argument + output bytes. The kernels at the shapes new to
    them first (:func:`cost_model_kernels`). Returns the launches."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeCase
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import make_smoke_mesh
    from repro_torch.launch.cells import _model, local_bytes
    from repro_torch.launch.op_costs import analyze_cell, count
    from repro_torch.launch.roofline import model_flops, roofline_from_costs
    from repro_torch.models import build_model
    from repro_torch.models.params import init_params
    from repro_torch.training import AdamW, make_decode_step, make_prefill_step, make_train_step

    t_phase = time.perf_counter()
    dry = finish_dryrun(child)
    for r in dry:
        emit("cost_model_dryrun", card=smi, torch=r["torch"], arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
             trace_s=r["trace_s"],
             depths=r["depths"], flops_per_device=r["flops_per_device"], hbm_bytes_per_device=r["hbm_bytes_per_device"],
             collective_counts=r["collective_counts"], collective_bytes=r["collective_bytes"],
             collective_bytes_by_link=r["collective_bytes_by_link"], compute_s=r["compute_s"],
             memory_s=r["memory_s"], collective_s=r["collective_s"], dominant=r["dominant"],
             model_flops=r["model_flops"], model_flops_fraction=r["model_flops_fraction"],
             roofline_fraction=r["roofline_fraction"], memory_analysis=r["memory_analysis"])
    kernels = cost_model_kernels(torch, dev, bw)
    mesh = make_smoke_mesh(dev)
    check(dist.get_backend() == "nccl", f"smoke mesh backend {dist.get_backend()}")
    base = get_config("llama3-8b")

    def cut(shape):
        b, layers = CARD_CELLS[shape]
        c = SHAPES[shape]
        return dataclasses.replace(base, num_layers=layers), ShapeCase(c.name, c.seq_len, b, c.kind)

    def step_of(model, cfg, kind):
        if kind == "train":
            return make_train_step(model, cfg, AdamW())
        return make_prefill_step(model) if kind == "prefill" else make_decode_step(model)

    # the operators against the default path, one layer of each cell, bit for bit
    for shape in CARD_CELLS:
        cfg, case = cut(shape)
        cfg = dataclasses.replace(cfg, num_layers=1)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 202), torch.bfloat16, dev)
        outs = {}
        for label, model in (("operator", _model(cfg)), ("default", build_model(cfg))):
            args = card_cell_inputs(torch, dev, mesh, cfg, case, {n: t.clone() for n, t in params.items()})
            if case.kind == "train":
                from repro_torch.training import steps

                loss_fn = steps.make_loss_fn(model, cfg)
                grads, metrics = steps.value_and_grad(loss_fn, args[0], args[2])
                with torch.no_grad():
                    logits = model.forward(args[0], args[2])
                outs[label] = [logits.to_local(), metrics["loss"], *(g.to_local() for g in grads.values())]
            else:
                with torch.no_grad():
                    res = step_of(model, cfg, case.kind)(*args)
                outs[label] = [res[0].to_local()] + [t.to_local() for t in res[1]["layers"].values()]
            del args
        same = all(torch.equal(a, b) for a, b in zip(outs["operator"], outs["default"]))
        emit("cost_model_operator_check", case=shape, layers=1, tensors=len(outs["operator"]), bit_equal=same)
        check(same, f"phase 20 {shape}: the kernel operators' results differ from the default path's")
        del outs, params
    gc.collect()
    torch.cuda.empty_cache()

    every = {**counters, **{f"flash_route_{r}": c for r, c in fa.ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in fa.BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    results, params = {}, None
    calls = 2 + CARD_TURNS  # the warm-up, the counted call, the timed ones
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        cfg, case = cut(shape)
        if params is None or shape == "train_4k":
            params = None
            gc.collect()
            torch.cuda.empty_cache()
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 203), torch.bfloat16, dev)
        args = card_cell_inputs(torch, dev, mesh, cfg, case, params)
        step = step_of(_model(cfg), cfg, case.kind)
        before = {k: c.value for k, c in every.items()}
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = step(*args)  # the warm-up
        del out
        costs, out = count(step, *args)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        head = out[2]["loss"] if case.kind == "train" else out[0]
        head = head.full_tensor() if hasattr(head, "full_tensor") else head
        want_shape = () if case.kind == "train" else (case.global_batch, 1, cfg.vocab)
        check(tuple(head.shape) == want_shape and bool(torch.isfinite(head).all()),
              f"phase 20 {shape}: output {tuple(head.shape)} (want {want_shape}), finite {bool(torch.isfinite(head).all())}")
        del out, head
        times = []
        for _ in range(CARD_TURNS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) * 1e-3)
        turn = {k: every[k].value - before[k] for k in every}
        layers = cfg.num_layers
        want = {"flash_route_tensor_core": 0, "flash_route_decode": 0, "flash_route_f32": 0}
        want["flash_route_decode" if case.kind == "decode" else "flash_route_tensor_core"] = calls * layers
        for n in fa.BWD_LAUNCHES:
            route, kernel = n.split("/")
            want[f"flash_attention_bwd_{n}"] = (calls * layers if case.kind == "train" and route == "tensor_core"
                                                 and kernel in fa.bwd_kernels(cfg.resolved_head_dim) else 0)
        got = {k: turn[k] for k in want}
        check(got == want, f"phase 20 {shape}: launches {got}, want {want}")
        t0 = time.perf_counter()
        traced = analyze_cell("llama3-8b", shape, mesh, cfg=cfg, case=case)
        trace_s = time.perf_counter() - t0
        fake = traced["costs"]
        same = fake.dot_flops == costs.dot_flops and fake.collective_counts == costs.collective_counts
        roof = roofline_from_costs(fake, 1)
        mf = model_flops(cfg, case)
        measured = statistics.median(times)
        rec = dict(torch=torch.__version__, config=cfg.name, layers=layers, batch=case.global_batch, seq_len=case.seq_len, kind=case.kind,
                   seconds=measured, seconds_by_turn=times, bound_s=roof.bound_s, over_bound=measured / roof.bound_s,
                   dominant=roof.dominant, compute_s=roof.compute_s, memory_s=roof.memory_s,
                   collective_s=roof.collective_s, model_flops=mf,
                   model_flops_share_of_peak=mf / (measured * H100.peak_flops_bf16),
                   traced=dict(dot_flops=fake.dot_flops, hbm_bytes=fake.hbm_bytes,
                               collective_counts=fake.collective_counts, depths=traced["depths"], trace_s=trace_s,
                               argument_bytes=traced["argument_bytes"], output_bytes=traced["output_bytes"]),
                   real=dict(dot_flops=costs.dot_flops, hbm_bytes=costs.hbm_bytes,
                             collective_counts=costs.collective_counts),
                   counts_equal=same, max_memory_allocated=peak,
                   traced_argument_plus_output_bytes=traced["argument_bytes"] + traced["output_bytes"],
                   input_bytes=local_bytes(args), launches_per_call={k: v // calls for k, v in want.items() if v})
        results[shape] = rec
        emit("cost_model_cell", card=smi, case=shape, **rec)
        check(same, f"phase 20 {shape}: the real run counted {costs.dot_flops} FLOPs, {costs.collective_counts}, the "
                    f"fake trace {fake.dot_flops}, {fake.collective_counts}")
        del args, step, costs, traced
    launches = {k: c.value for k, c in every.items()}
    del params
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    emit("cost_model_result", card=smi, seconds=time.perf_counter() - t_phase,
         cells={k: dict(seconds=v["seconds"], bound_s=v["bound_s"], over_bound=v["over_bound"],
                        dominant=v["dominant"], model_flops_share_of_peak=v["model_flops_share_of_peak"])
                for k, v in results.items()},
         dryrun={f"{r['arch']} {r['shape']}": dict(dominant=r["dominant"], roofline_fraction=r["roofline_fraction"],
                                                   model_flops_fraction=r["model_flops_fraction"]) for r in dry})
    out = {k: launches[k] for k in counters}
    out["flash_attention_routes"] = {r: launches[f"flash_route_{r}"] for r in fa.ROUTE_LAUNCHES}
    out["flash_attention_bwd_by_kernel"] = {n: launches[f"flash_attention_bwd_{n}"] for n in fa.BWD_LAUNCHES}
    out["kernels"] = kernels
    return out


# -- phase 21: the attention families' sharded steps on the smoke mesh ------------------

#: decode steps of each served run of phase 21 (a) and (c): DTensor's host
#: dispatch makes a step of internvl2-2b's 24 layers cost a few hundred ms
FAMILY_GEN = 4
FAMILY_TURNS = 2  # timed calls of each step after its gated one
#: (c) internvl2-2b's train step: 2 x (256 patches + 256 tokens), bf16, f32 moments
FAMILY_VLM_TRAIN_B, FAMILY_VLM_TRAIN_TOKENS = 2, 256
#: the latent decode at the local block one rank of a 16x16 mesh gives it
#: in deepseek-v3's decode_32k cell: 128 / 16 sequences, 128 / 16 heads
#: (8 of a block's 64 rows live), 32768 slots
MLA_LOCAL_B, MLA_LOCAL_H, MLA_LOCAL_SLOTS = 8, 8, 32768
#: the (192, 128) forward and backward at 8 of deepseek-v3's 128 heads (16-way
#: model axis), phase 21 (b)'s batch of 4 sequences of PROMPT_LEN + GEN_LEN
MLA_LOCAL_TC = (4, 8, PROMPT_LEN + GEN_LEN)


def _local(t):
    """A DTensor's local block (at world 1, the whole tensor); anything else as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _synced_s(torch, dev, fn) -> float:
    """Seconds of one call of ``fn`` between two synchronizes."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def family_serve(torch, dev, every, mesh, cfg, params, batch, steps, *, want: dict, settings: dict, smi: str) -> dict:
    """Phase 21's serving half for one model: ``prefill`` of ``batch`` and
    ``len(steps)`` ``decode`` steps of the given tokens, on the plain
    parameters and then, under each of ``settings`` (flag dicts: H3 off and
    on), on the same parameters placed by ``SERVE_RULES`` on the smoke mesh
    (``place_tree``: at world 1 the blocks are the tensors themselves), the
    batch and tokens placed by their logical axes and the cache made placed
    (``init_cache(mesh=)``). Gates: every logit and the cache after the
    last step bit-equal to the plain run's; each run's launches ``want``.
    Each run's prefill and decode-step seconds (medians of ``FAMILY_TURNS``
    timed runs after the gated one) and one profiled prefill's and decode
    step's idle share. Returns the records by run."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.launch.cells import _INPUT_AXES
    from repro_torch.models import build_model, optim
    from repro_torch.models.params import decoder_specs, spec
    from repro_torch.sharding import SERVE_RULES, place_tree

    model = build_model(cfg)
    max_len = cfg.num_patches + batch["tokens"].shape[1] + len(steps)
    placed = place_tree(params, dict(decoder_specs(cfg)), SERVE_RULES, mesh)
    shared = all(_local(placed[n]).data_ptr() == t.data_ptr() for n, t in params.items())
    pbatch = {k: place_tree(t, spec(tuple(t.shape), _INPUT_AXES[k][: t.ndim]), SERVE_RULES, mesh)
              for k, t in batch.items()}
    psteps = [place_tree(t, spec(tuple(t.shape), ("batch", None)), SERVE_RULES, mesh) for t in steps]
    runs = {"plain": (params, batch, steps, {})}
    runs.update({f"dtensor_{k}": (placed, pbatch, psteps, dict(mesh=mesh, **f)) for k, f in settings.items()})
    results, ref = {}, None
    for label, (p, b, toks, flags) in runs.items():
        state = {}

        def prefill():
            state["c"] = model.prefill(p, b, max_len=max_len)

        def decode(i):
            logits, cache, n = state["c"]
            logits, cache = model.decode(p, cache, toks[i], n)
            state["c"] = (logits, cache, n + 1)

        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad(), optim.optimizations(**flags):
            before = {k: c.value for k, c in every.items()}
            prefill()
            outs = [_local(state["c"][0]).clone()]
            for i in range(len(toks)):
                decode(i)
                outs.append(_local(state["c"][0]).clone())
            torch.cuda.synchronize(dev)
            got = {k: every[k].value - before[k] for k in want}
            check(got == want, f"phase 21 {cfg.name} {label}: launches {got}, want {want}")
            cache = [_local(t) for t in tree_leaves(state["c"][1])]
            rec = dict(launches=got)
            if ref is None:
                ref = (outs, cache)
            else:
                same = [torch.equal(a, w) for a, w in zip(outs, ref[0])]
                same_cache = all(torch.equal(a, w) for a, w in zip(cache, ref[1]))
                rec.update(logits_bit_equal=all(same), cache_bit_equal=same_cache,
                           max_abs_logit_diff=max(float((a - w).abs().max()) for a, w in zip(outs, ref[0])))
                check(all(same) and same_cache and len(cache) == len(ref[1]),
                      f"phase 21 {cfg.name} {label}: logits {same} and cache {same_cache} against the plain run's")
            del outs, cache
            pre_s, step_s = [], []
            for _ in range(FAMILY_TURNS):
                pre_s.append(_synced_s(torch, dev, prefill))
                step_s.extend(_synced_s(torch, dev, lambda: decode(i)) for i in range(len(toks)))
            prof_pre = device_profile(torch, prefill)
            prof_step = device_profile(torch, lambda: decode(0))
        rec.update(prefill_seconds=statistics.median(pre_s), decode_step_seconds=statistics.median(step_s),
                   prefill_idle_share=prof_pre["idle_share"], decode_idle_share=prof_step["idle_share"],
                   prefill_busy_seconds=prof_pre["device_busy_seconds"],
                   decode_busy_seconds=prof_step["device_busy_seconds"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        results[label] = rec
        emit("sharded_family_serve", card=smi, config=cfg.name, layers=cfg.num_layers, case=label,
             batch={k: list(t.shape) for k, t in batch.items()}, decode_steps=len(steps),
             blocks_share_storage=shared, **rec)
        del state
    return results


def family_encode(torch, dev, every, mesh, cfg, params, frames, *, want: dict, smi: str) -> dict:
    """Phase 21 (d)'s serving half: the encoder's encode (its serving
    step, ``EncoderLM.forward``) of ``frames`` on the plain parameters and
    on the same parameters placed by ``SERVE_RULES``, the frames by
    ``("batch", "seq", None)``. Gates: the logits bit-equal, each run's
    launches ``want``. Each run's seconds (median of ``FAMILY_TURNS`` timed
    encodes after the gated one) and one profiled encode's idle share."""
    from repro_torch.launch.cells import _INPUT_AXES
    from repro_torch.models import build_model
    from repro_torch.models.params import decoder_specs, spec
    from repro_torch.sharding import SERVE_RULES, place_tree

    model = build_model(cfg)
    placed = place_tree(params, dict(decoder_specs(cfg)), SERVE_RULES, mesh)
    pframes = place_tree(frames, spec(tuple(frames.shape), _INPUT_AXES["frames"]), SERVE_RULES, mesh)
    results, ref = {}, None
    for label, (p, f) in {"plain": (params, frames), "dtensor": (placed, pframes)}.items():
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            before = {k: c.value for k, c in every.items()}
            logits = _local(model.forward(p, {"frames": f}))
            torch.cuda.synchronize(dev)
            got = {k: every[k].value - before[k] for k in want}
            check(got == want, f"phase 21 {cfg.name} {label} encode: launches {got}, want {want}")
            rec = dict(launches=got, logits_shape=list(logits.shape), finite=bool(torch.isfinite(logits).all()))
            if ref is None:
                ref = logits
            else:
                same = torch.equal(logits, ref)
                rec.update(logits_bit_equal=same, max_abs_logit_diff=float((logits - ref).abs().max()))
                check(same and rec["finite"], f"phase 21 {cfg.name}: the DTensor encode's logits differ from the plain")
            del logits
            times = [_synced_s(torch, dev, lambda: model.forward(p, {"frames": f})) for _ in range(FAMILY_TURNS)]
            prof = device_profile(torch, lambda: model.forward(p, {"frames": f}))
        rec.update(encode_seconds=statistics.median(times), idle_share=prof["idle_share"],
                   device_busy_seconds=prof["device_busy_seconds"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        results[label] = rec
        emit("sharded_family_encode", card=smi, config=cfg.name, layers=cfg.num_layers, case=label,
             frames=list(frames.shape), **rec)
    return results


class DigestingAdamW:
    """AdamW that first records each gradient it is handed by its local
    block's 64-bit digest (``transfer.checksum``, the ``checksum_words``
    kernel's fold) and its f32 norm, one tensor at a time: two steps'
    gradients compared without holding two gradient trees."""

    def __init__(self, opt):
        self.opt, self.digests = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        from repro_torch.transfer.checksum import checksum

        if self.digests is None:
            self.digests = {n: (checksum(_local(g)), float(_local(g).float().norm())) for n, g in grads.items()}
        return self.opt.update(grads, state, params)


def family_train(torch, dev, every, mesh, cfg, make_params, batch, *, want: dict, smi: str) -> dict:
    """Phase 21's training half for one model: one ``make_train_step``
    (bf16 parameters, f32 AdamW moments from zero) on the plain parameters
    ``make_params()``, then on a second draw of them (the same seed: the
    same bits) placed by ``TRAIN_RULES`` on the smoke mesh with the batch
    placed by its logical axes. Gates: the loss, every gradient's digest
    and norm (:class:`DigestingAdamW`) and every parameter's digest after
    the step bit-equal; each step's launches ``want``. Each step's seconds
    (median of ``FAMILY_TURNS`` timed steps after the gated one; the
    parameters move on), one profiled step's idle share and the peak
    memory. Returns the records by run."""
    from repro_torch.launch.cells import _INPUT_AXES
    from repro_torch.models import build_model
    from repro_torch.models.params import decoder_specs, spec
    from repro_torch.sharding import TRAIN_RULES, place_tree
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.transfer.checksum import checksum

    model = build_model(cfg)
    results, ref = {}, None
    for label in ("plain", "dtensor"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = make_params()
        b = batch
        if label == "dtensor":
            params = place_tree(params, dict(decoder_specs(cfg)), TRAIN_RULES, mesh)
            b = {k: place_tree(t, spec(tuple(t.shape), _INPUT_AXES[k][: t.ndim]), TRAIN_RULES, mesh)
                 for k, t in batch.items()}
        opt = DigestingAdamW(AdamW())
        state = opt.init(params)
        step = make_train_step(model, cfg, opt)
        before = {k: c.value for k, c in every.items()}
        _, state, metrics = step(params, state, b)
        torch.cuda.synchronize(dev)
        got = {k: every[k].value - before[k] for k in want}
        check(got == want, f"phase 21 {cfg.name} {label} step: launches {got}, want {want}")
        loss = float(metrics["loss"])
        after = {n: checksum(_local(t)) for n, t in params.items()}
        rec = dict(loss=loss, launches=got)
        if ref is None:
            ref = dict(loss=loss, grads=opt.digests, params=after)
        else:
            grads_same = opt.digests == ref["grads"]
            params_same = after == ref["params"]
            rec.update(loss_bit_equal=loss == ref["loss"], grads_bit_equal=grads_same, params_bit_equal=params_same,
                       gradients=len(opt.digests))
            bad = [n for n in ref["grads"] if opt.digests.get(n) != ref["grads"][n]]
            check(loss == ref["loss"] and grads_same and params_same,
                  f"phase 21 {cfg.name}: the DTensor step's loss {loss} (plain {ref['loss']}), gradients "
                  f"{bad[:4]} differ, parameters equal {params_same}")
        times = [_synced_s(torch, dev, lambda: step(params, state, b)) for _ in range(FAMILY_TURNS)]
        prof = device_profile(torch, lambda: step(params, state, b))
        rec.update(step_seconds=statistics.median(times), step_seconds_by_turn=times,
                   idle_share=prof["idle_share"], device_busy_seconds=prof["device_busy_seconds"],
                   max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        results[label] = rec
        emit("sharded_family_train", card=smi, config=cfg.name, layers=cfg.num_layers, case=label,
             batch={k: list(t.shape) for k, t in batch.items()}, dtype="bfloat16", moments="float32", **rec)
        del params, state, step, opt, b, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return results


def mla_local_block_times(torch, dev, bw: float) -> dict:
    """The MLA kernels at the local blocks one rank of a 16x16 mesh gives
    them: ``mla_decode`` at ``MLA_LOCAL_*`` (q_abs [8,8,1,512] against 32768
    slots of [8,32768,512]: 8 of a block's 64 ``wgmma`` rows live) and the
    (192, 128) ``tensor_core`` forward (with the lse) and backward at 8
    heads (``MLA_LOCAL_TC``), each held to its plain version (the decode
    within ``MLA_DECODE_TOL`` of its max |value|, the attention within
    phase 2's bf16 tolerance) and timed with the L2 cold beside the plain
    version, SDPA (its backend named, or "none ran") and the bound."""
    import torch.nn.functional as F
    from torch.nn.attention import sdpa_kernel

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md

    g = torch.Generator(device=dev).manual_seed(SEED + 210)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=torch.float32).to(torch.bfloat16)

    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {}
    b, h, s = MLA_LOCAL_B, MLA_LOCAL_H, MLA_LOCAL_SLOTS
    qa, qr, ckv, kr = rand(b, h, 1, MLA_R), rand(b, h, 1, MLA_ROPE), rand(b, s, MLA_R), rand(b, s, MLA_ROPE)
    scale = 1.0 / math.sqrt(MLA_QK)
    got = md.mla_decode(qa, qr, ckv, kr, kv_len=s, scale=scale)
    want = md.mla_decode_plain(qa, qr, ckv, kr, kv_len=s, scale=scale)
    err = float((got - want).abs().max())
    ratio = err / (MLA_DECODE_TOL * float(want.abs().max()))
    label = f"q_abs [{b},{h},1,512], q_rope [{b},{h},1,64], ckv [{b},{s},512], krope [{b},{s},64] bf16, kv_len {s}"
    emit("mla_decode_check", case=f"phase 21 {label}", max_abs_err=err, tol=f"{MLA_DECODE_TOL} of max |value|",
         err_over_tol=ratio, splits=md.split_plan(s, b, h))
    check(ratio <= 1.0 and bool(torch.isfinite(got).all()), f"phase 21: mla_decode != plain version on {label}")
    q576, k576, v512 = torch.cat([qa, qr], -1), torch.cat([ckv, kr], -1)[:, None], ckv[:, None]

    def sdpa():
        return F.scaled_dot_product_attention(q576, k576, v512, enable_gqa=True, scale=scale)

    try:
        backend = sdpa_backend(torch, sdpa).name
    except (SmokeFailure, torch.OutOfMemoryError):  # a backend out of memory is one that does not take the call
        backend = None
        torch.cuda.empty_cache()
    calls = {"kernel": lambda: md.mla_decode(qa, qr, ckv, kr, kv_len=s, scale=scale),
             "plain": lambda: md.mla_decode_plain(qa, qr, ckv, kr, kv_len=s, scale=scale)}
    if backend is not None:
        calls["sdpa"] = sdpa
    cold = {n: cold_ms(torch, f, flush, reps=5 if n != "kernel" else 20) for n, f in calls.items()}
    bound, by, flops, nbytes = mla_decode_bound_ms(b, h, s, bw)
    out["mla_decode"] = dict(shape=label, ms=cold["kernel"], plain_ms=cold["plain"], library_ms=cold.get("sdpa"),
                             library=(f"scaled_dot_product_attention ({backend}), one KV head of E 576, Ev 512"
                                      if backend else "none ran"),
                             bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, live_rows_of_block=f"{h} of 64",
                             splits=md.split_plan(s, b, h), max_abs_err=err, err_over_tol=ratio)
    emit("mla_local_times", case="mla_decode", card_rate=bw, **out["mla_decode"])
    del qa, qr, ckv, kr, got, want, q576, k576, v512, calls
    torch.cuda.empty_cache()

    b, h, s = MLA_LOCAL_TC
    tol = FLASH_TOL["bfloat16"]
    q, k, v, dout = rand(b, h, s, MLA_QK), rand(b, h, s, MLA_QK), rand(b, h, s, MLA_V), rand(b, h, s, MLA_V)
    label = f"q/k [{b},{h},{s},192], v [{b},{h},{s},128] bf16 causal"
    check(fa._route(q, k, v=v) == "tensor_core", f"phase 21: {label} routed to {fa._route(q, k, v=v)}")
    o, lse = fa.launch_route("tensor_core", q, k, v, causal=True, with_lse=True)
    want = fa.attention_plain(q, k, v, causal=True).float()
    diff = (o.float() - want).abs()
    ratio = float((diff / (tol + tol * want.abs())).max())
    emit("flash_check", case=f"phase 21 {label}", route="tensor_core", max_abs_err=float(diff.max()), tol=tol,
         err_over_tol=ratio)
    check(ratio <= 1.0 and bool(torch.isfinite(o).all()), f"phase 21: tensor_core != plain version on {label}")
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
    backend = sdpa_backend(torch, sdpa)
    with sdpa_kernel([backend]):
        cold = {"kernel": cold_ms(torch, lambda: fa.launch_route("tensor_core", q, k, v, causal=True, with_lse=True),
                                  flush),
                "plain": cold_ms(torch, lambda: fa.attention_plain(q, k, v, causal=True), flush, reps=5),
                "sdpa": cold_ms(torch, sdpa, flush)}
    bound, by, flops, nbytes = mla_bound_ms(b, h, h, s, s, True, 0, bw)
    out["forward"] = dict(route="tensor_core", shape=label + ", with the lse", ms=cold["kernel"],
                          plain_ms=cold["plain"], library_ms=cold["sdpa"], library=str(backend), bound_ms=bound,
                          bound_by=by, flops=flops, bytes=nbytes, max_abs_err=float(diff.max()), err_over_tol=ratio)
    emit("mla_local_times", case="tensor_core_forward", card_rate=bw, **out["forward"])
    got = fa.launch_backward(q, k, v, o, lse, dout, causal=True, route="tensor_core")
    want = fa.attention_backward_plain(q, k, v, o, lse, dout, causal=True)
    errs = {n: grad_err(torch, a, w) for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    emit("flash_bwd_check", case=f"phase 21 {label}", backward_route="tensor_core", rel_err=errs, tol=tol)
    check(max(errs.values()) <= tol and all(bool(torch.isfinite(a).all()) for a in got),
          f"phase 21: the tensor_core backward != its plain version on {label}: {errs}")
    max_abs = max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))
    del got, want
    sq_, sk_, sv_ = (t.clone().requires_grad_() for t in (q, k, v))
    with sdpa_kernel([backend]):
        sdpa_out = F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True)
        cold = {"kernel": cold_ms(torch, lambda: fa.launch_backward(q, k, v, o, lse, dout, causal=True,
                                                                    route="tensor_core"), flush),
                "plain": cold_ms(torch, lambda: fa.attention_backward_plain(q, k, v, o, lse, dout, causal=True), flush,
                                 reps=5),
                "sdpa": cold_ms(torch, lambda: torch.autograd.grad(sdpa_out, (sq_, sk_, sv_), dout, retain_graph=True),
                                flush)}
    bound, by, flops, nbytes = bwd_bound_ms(q, k, s, True, 0, bw, BF16_TFLOPS, v=v)
    out["backward"] = dict(route="tensor_core", shape=label, ms=cold["kernel"], plain_ms=cold["plain"],
                           library_ms=cold["sdpa"], library=str(backend), bound_ms=bound, bound_by=by, flops=flops,
                           bytes=nbytes, rel_err_vs_plain=errs, max_abs_err=max_abs,
                           err_over_tol=max(errs.values()) / tol)
    emit("mla_local_times", case="tensor_core_backward", card_rate=bw, **out["backward"])
    del q, k, v, dout, o, lse, sq_, sk_, sv_, sdpa_out, flush
    torch.cuda.empty_cache()
    return out


def sharded_families(torch, dev, counters, smi: str, bw: float) -> dict:
    """Phase 21: the attention families' sharded serving and train steps on
    the 1x1 NCCL smoke mesh, each against its plain run, bit for bit (at
    world 1 the same kernels run on the whole tensors). (a) deepseek-v3-671b
    at its published widths, bf16, phase 12's serving depth (3 dense prefix
    layers and 1 of 256 routed experts) and batch (``DS_B`` x
    ``DS_PROMPT``), ``FAMILY_GEN`` decode steps, on DTensors placed by
    ``SERVE_RULES`` with H3 off and on (MLA's expanded prefill on the
    (192, 128) ``tensor_core`` forward, its absorbed decode on
    ``mla_decode``). (b) Its train step at phase 12's training cut (4
    layers, 16 experts) and step shape (``DS_RL_PROMPTS`` x ``DS_RL_GROUP``
    sequences of ``PROMPT_LEN + GEN_LEN``, one LM batch), on DTensors
    placed by ``TRAIN_RULES``. (c) internvl2-2b at 24 layers: phase 14's
    serving batch (``VLM_B`` x (256 patches + ``VLM_PROMPT``)) and a train
    step of ``FAMILY_VLM_TRAIN_B`` x (256 + ``FAMILY_VLM_TRAIN_TOKENS``).
    (d) hubert-xlarge at 48 layers: phase 15's encode (``AUDIO_B`` x
    ``AUDIO_FRAMES``) and its bf16 masked-prediction step
    (``AUDIO_TRAIN_B``). Then the MLA kernels at the 16-way local blocks
    (:func:`mla_local_block_times`), after the launches are read. Returns
    the launches and those records."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import make_smoke_mesh
    from repro_torch.launch.train import stand_in_patches
    from repro_torch.models.params import init_params

    t_phase = time.perf_counter()
    every = {**counters, **{f"flash_route_{r}": c for r, c in fa.ROUTE_LAUNCHES.items()},
             **{f"flash_attention_bwd_{n}": c for n, c in fa.BWD_LAUNCHES.items()}}
    for c in every.values():
        c.reset()
    mesh = make_smoke_mesh(dev)
    check(dist.get_backend() == "nccl", f"smoke mesh backend {dist.get_backend()}")
    g = torch.Generator(device=dev).manual_seed(SEED + 211)
    bf16 = torch.bfloat16

    def tokens(cfg, *shape):
        return torch.randint(0, cfg.vocab, shape, generator=g, device=dev)

    def none(**kw):
        want = {"flash_route_tensor_core": 0, "flash_route_decode": 0, "flash_route_f32": 0, "mla_decode": 0}
        want.update({f"flash_attention_bwd_{n}": 0 for n in fa.BWD_LAUNCHES})
        want.update(kw)
        return want

    def bwd(layers, d, dv=None):  # the tensor-core backward kernels a step launches, one each a layer
        return {f"flash_attention_bwd_tensor_core/{n}": layers for n in fa.bwd_kernels(d, dv)}

    serve, train = {}, {}
    # (a) deepseek-v3 served
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=DS_SERVE_LAYERS)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 212), bf16, dev)
    layers = cfg.num_layers
    want = none(flash_route_tensor_core=layers, mla_decode=layers * FAMILY_GEN)
    serve[cfg.name] = family_serve(torch, dev, every, mesh, cfg, params, {"tokens": tokens(cfg, DS_B, DS_PROMPT)},
                                   [tokens(cfg, DS_B, 1) for _ in range(FAMILY_GEN)], want=want,
                                   settings={"h3_off": {}, "h3_on": dict(shardmap_moe=True)}, smi=smi)
    del params
    # (b) its train step
    mo = cfg.moe
    cfg = dataclasses.replace(cfg, num_layers=DS_TRAIN_LAYERS, moe=dataclasses.replace(mo, num_experts=DS_TRAIN_EXPERTS))
    seed = SEED + 213
    want = none(flash_route_tensor_core=cfg.num_layers, **bwd(cfg.num_layers, MLA_QK, MLA_V))
    train[cfg.name] = family_train(
        torch, dev, every, mesh, cfg, lambda: init_params(cfg, torch.Generator(device=dev).manual_seed(seed), bf16, dev),
        {"tokens": tokens(cfg, DS_RL_PROMPTS * DS_RL_GROUP, PROMPT_LEN + GEN_LEN)}, want=want, smi=smi)
    # (c) internvl2-2b
    cfg = get_config("internvl2-2b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 214), bf16, dev)
    layers, d = cfg.num_layers, cfg.resolved_head_dim
    patches = torch.from_numpy(stand_in_patches(cfg, VLM_B, SEED, 214)).to(dev, bf16)
    want = none(flash_route_tensor_core=layers, flash_route_decode=layers * FAMILY_GEN)
    serve[cfg.name] = family_serve(torch, dev, every, mesh, cfg, params,
                                   {"tokens": tokens(cfg, VLM_B, VLM_PROMPT), "patches": patches},
                                   [tokens(cfg, VLM_B, 1) for _ in range(FAMILY_GEN)], want=want,
                                   settings={"h3_off": {}}, smi=smi)
    del params, patches
    seed = SEED + 215
    patches = torch.from_numpy(stand_in_patches(cfg, FAMILY_VLM_TRAIN_B, SEED, 215)).to(dev, bf16)
    want = none(flash_route_tensor_core=layers, **bwd(layers, d))
    train[cfg.name] = family_train(
        torch, dev, every, mesh, cfg, lambda: init_params(cfg, torch.Generator(device=dev).manual_seed(seed), bf16, dev),
        {"tokens": tokens(cfg, FAMILY_VLM_TRAIN_B, FAMILY_VLM_TRAIN_TOKENS), "patches": patches}, want=want, smi=smi)
    del patches
    # (d) hubert-xlarge: the encode, then the masked-prediction step
    cfg = get_config("hubert-xlarge")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED + 216), bf16, dev)
    layers, d = cfg.num_layers, cfg.resolved_head_dim
    frames = torch.randn(AUDIO_B, AUDIO_FRAMES, cfg.frontend_dim, generator=g, device=dev).to(bf16)
    serve[cfg.name] = family_encode(torch, dev, every, mesh, cfg, params, frames,
                                    want=none(flash_route_tensor_core=layers), smi=smi)
    del params, frames
    seed = SEED + 217
    batch = {"frames": torch.randn(AUDIO_TRAIN_B, AUDIO_FRAMES, cfg.frontend_dim, generator=g, device=dev).to(bf16),
             "targets": tokens(cfg, AUDIO_TRAIN_B, AUDIO_FRAMES),
             "mask": torch.rand(AUDIO_TRAIN_B, AUDIO_FRAMES, generator=g, device=dev) < 0.5}
    want = none(flash_route_tensor_core=layers, **bwd(layers, d))
    train[cfg.name] = family_train(
        torch, dev, every, mesh, cfg, lambda: init_params(cfg, torch.Generator(device=dev).manual_seed(seed), bf16, dev),
        batch, want=want, smi=smi)
    del batch
    launches = {k: c.value for k, c in every.items()}  # the main path's, read now
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    local = mla_local_block_times(torch, dev, bw)
    emit("sharded_families_result", card=smi, seconds=time.perf_counter() - t_phase,
         serve={m: {k: dict(prefill_seconds=r.get("prefill_seconds"), decode_step_seconds=r.get("decode_step_seconds"),
                            encode_seconds=r.get("encode_seconds"), idle_share=r.get("decode_idle_share",
                                                                                      r.get("idle_share")))
                    for k, r in runs.items()} for m, runs in serve.items()},
         train={m: {k: dict(step_seconds=r["step_seconds"], idle_share=r["idle_share"],
                            max_memory_allocated=r["max_memory_allocated"]) for k, r in runs.items()}
                for m, runs in train.items()},
         local_kernels={k: dict(ms=v["ms"], plain_ms=v["plain_ms"], library_ms=v["library_ms"], bound_ms=v["bound_ms"])
                        for k, v in local.items()})
    out = {k: launches[k] for k in counters if k != "checksum"}  # the digests check the steps: not the path
    out["flash_attention_routes"] = {r: launches[f"flash_route_{r}"] for r in fa.ROUTE_LAUNCHES}
    out["flash_attention_bwd_by_kernel"] = {n: launches[f"flash_attention_bwd_{n}"] for n in fa.BWD_LAUNCHES}
    out["local"] = local
    return out


def host_copy_rates(torch, dev, store, total: int, raw_pull_s: float) -> dict:
    """The three host stages every byte of a socketed raw pull passes, one
    after another (a single-source pull runs one read at a time), each
    timed alone on a 1 GiB chunk of the largest unit: off the card into
    pageable memory (the source), through a localhost TCP socket from
    Python (send and receive into a preallocated buffer), and from
    pageable memory onto the card (the reader). Their sum over the
    replica's bytes, beside the raw pull's seconds, says how much of the
    pull the host copies explain."""
    import socket

    src = store._gather_unit(max(store.units, key=lambda u: u.nbytes))[:GIB]
    n = src.numel()
    host = src.cpu()
    rbuf = bytearray(n)
    lsock = socket.create_server(("127.0.0.1", 0))
    cli = socket.create_connection(lsock.getsockname())
    conn, _ = lsock.accept()

    def tcp():
        sender = threading.Thread(target=lambda: conn.sendall(memoryview(host.numpy())))
        sender.start()
        view, got = memoryview(rbuf), 0
        while got < n:
            got += cli.recv_into(view[got:])
        sender.join()

    def seconds(fn, reps=3):
        ts = []
        for _ in range(reps):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    try:
        rates = {"d2h_GBps": n / seconds(lambda: src.cpu()) / 1e9,
                 "tcp_GBps": n / seconds(tcp) / 1e9,
                 "h2d_GBps": n / seconds(lambda: torch.frombuffer(rbuf, dtype=torch.uint8).to(dev)) / 1e9}
    finally:
        for sk in (cli, conn, lsock):
            sk.close()
    serial_s = sum(total / (r * 1e9) for r in rates.values())
    rec = dict(rates, chunk_bytes=n, serial_estimate_s=serial_s, raw_pull_s=raw_pull_s,
               share_of_raw_pull=serial_s / raw_pull_s)
    emit("networked_host_copies", **rec)
    return rec


def sass_counts(so, match: str) -> dict:
    """The HGMMA and UTMALDG instructions in the SASS of a library's
    kernels whose (mangled) names hold ``match``, counted by kernel and by
    their full opcode (shape and types), from ``cuobjdump -sass``."""
    import collections
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if match in m.group(1) else None
            continue
        op = re.search(r"\b(HGMMA\S*|UTMALDG\S*)", line) if fn else None
        if op:
            counts.setdefault(fn, collections.Counter())[op.group(1)] += 1
    return {f: dict(c) for f, c in counts.items()}


def ptxas_lines(log: str) -> list:
    """ptxas's register and spill lines of a build log, each prefixed with
    the kernel it describes (demangled where ``c++filt`` is on the path)."""
    import re
    import shutil

    out, name = [], ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            if shutil.which("c++filt"):
                name = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
        elif "registers" in ln or "spill" in ln:
            out.append(f"{name} | {ln.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    part, bw = memory_rate(name)
    emit("card", torch=torch.__version__, cuda=torch.version.cuda, name=name,
         bound_rate=f"{part} {bw / 1e12} TB/s")
    print(smi, flush=True)
    child = start_dryrun()  # phase 20 (a), on the host's CPU beside the card's phases
    try:
        return run_phases(torch, dev, name, smi, bw, child)
    finally:
        if child[0].poll() is None:
            child[0].kill()
            child[0].wait()


def run_phases(torch, dev, name: str, smi: str, bw: float, child) -> int:

    from repro_torch.core.meta import DEFAULT_CHUNK_BYTES
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import bwd_kernels
    from repro_torch.models.params import llama3_8b_shapes

    t0 = time.perf_counter()
    so = build.build()
    build.library()
    log = so.with_suffix(".log")
    emit("build", seconds=time.perf_counter() - t0, library=str(so.relative_to(ROOT)),
         ptxas=ptxas_lines(log.read_text()) if log.exists() else [])

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    phase_s = {}
    t0 = time.perf_counter()
    kernels = kernel_checks(torch, dev, bw)
    kernels.update(reshard_kernel_checks(torch, dev, bw))
    kernels.update(flash_checks(torch, dev, bw))
    bwd = flash_backward_checks(torch, dev, bw)
    f32 = bwd.pop("f32_route_training_shape")
    kernels["flash_attention"]["routes"]["f32"].update(
        timed_shape=f32["shape"], ms=f32["ms"], warm_device_ms=f32["warm_device_ms"]["kernel"],
        plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"], bound_by=f32["bound_by"], library_ms=f32["library_ms"])
    kernels["flash_attention"]["lse_err_over_tol"] = bwd.pop("lse_err_over_tol")
    kernels["flash_attention"]["routes"]["tensor_core"]["gemma2_phase10_forward"] = bwd.pop("gemma2_phase10_forward")
    kernels.update(bwd)
    dbrx = dbrx_attention_checks(torch, dev, bw)
    fwd, bwd_tc = kernels["flash_attention"], kernels["flash_attention_bwd/tensor_core"]
    fwd["routes"]["tensor_core"]["dbrx_prefill"] = dbrx["prefill"]
    fwd["routes"]["decode"]["dbrx_decode"] = dbrx["decode"]
    bwd_tc["dbrx_backward"] = dbrx["backward"]
    mla = mla_attention_checks(torch, dev, bw)
    fwd["routes"]["tensor_core"]["mla_prefill"] = mla["mla_prefill"]
    kernels["mla_decode"] = mla["mla_decode"]
    trained = mla_training_checks(torch, dev, bw)
    bwd_tc256, bwd_cc = kernels["flash_attention_bwd/tensor_core_256"], kernels["flash_attention_bwd/cuda_core"]
    bwd_tc256["mla_192_128"] = trained["mla_backward"]
    fwd["routes"]["f32"]["mla_24_16"] = trained["narrow_forward"]
    bwd_cc["mla_24_16"] = trained["narrow_backward"]
    vlm = vlm_attention_checks(torch, dev, bw)
    fwd["routes"]["tensor_core"]["internvl2_prefill"] = vlm["prefill"]
    fwd["routes"]["decode"]["internvl2_decode"] = vlm["decode"]
    fwd["routes"]["f32"]["internvl2_train_forward"] = vlm["train_forward"]
    bwd_cc["internvl2_backward"] = vlm["train_backward"]
    hubert = hubert_attention_checks(torch, dev, bw)
    fwd["routes"]["tensor_core"]["hubert_encode"] = hubert["encode"]
    fwd["routes"]["f32"]["hubert_train_forward"] = hubert["train_f32_forward"]
    bwd_tc["hubert_backward"] = hubert["train_bf16_backward"]
    bwd_cc["hubert_backward"] = hubert["train_f32_backward"]
    hyb = hybrid_attention_checks(torch, dev, bw)
    fwd["routes"]["decode"]["zamba2_decode"] = hyb["decode"]
    fwd["routes"]["decode"]["zamba2_ring"] = hyb["ring"]
    fwd["routes"]["tensor_core"]["zamba2_prefill"] = hyb["prefill"]
    fwd["routes"]["tensor_core"]["zamba2_train_forward"] = hyb["train_bf16_forward"]
    fwd["routes"]["f32"]["zamba2_train_forward"] = hyb["train_f32_forward"]
    bwd_tc["zamba2_backward"] = hyb["train_bf16_backward"]
    bwd_cc["zamba2_backward"] = hyb["train_f32_backward"]
    for entry, cases in ((fwd, (dbrx["prefill"], dbrx["decode"], mla["mla_prefill"], trained["narrow_forward"],
                                vlm["prefill"], vlm["decode"], vlm["train_forward"], hubert["encode"],
                                hubert["train_f32_forward"], hyb["decode"], hyb["ring"], hyb["prefill"],
                                hyb["train_bf16_forward"], hyb["train_f32_forward"])),
                         (bwd_tc, (dbrx["backward"], hubert["train_bf16_backward"], hyb["train_bf16_backward"])),
                         (bwd_tc256, (trained["mla_backward"],)),
                         (bwd_cc, (trained["narrow_backward"], vlm["train_backward"], hubert["train_f32_backward"],
                                   hyb["train_f32_backward"]))):
        entry["max_abs_err"] = max([entry["max_abs_err"]] + [c["max_abs_err"] for c in cases])
        entry["err_over_tol"] = max([entry["err_over_tol"]] + [c["err_over_tol"] for c in cases])
    for kernel, rec in big_tensor_checks(torch, dev, bw).items():
        kernels[kernel]["past_2_31_elements"] = rec
    phase_s["2 kernels"] = time.perf_counter() - t0
    counters = {k: v.pop("counter") for k, v in kernels.items()}
    shapes = llama3_8b_shapes(num_layers=NUM_LAYERS)
    transfer_counters = {k: c for k, c in counters.items() if not k.startswith(("flash_attention", "mla_decode"))}
    t0 = time.perf_counter()
    phase3 = transfer(
        torch, dev, {k: counters[k] for k in ("checksum", "quantize_rows")}, shapes, DEFAULT_CHUNK_BYTES
    )
    gc.collect()  # phase 3's replicas and snapshots go before phase 4 allocates
    torch.cuda.empty_cache()
    phase_s["3 transfer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase4 = reshard_transfer(torch, dev, transfer_counters, shapes, DEFAULT_CHUNK_BYTES)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["4 reshard"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase5 = serving(torch, dev, {k: c for k, c in counters.items() if not k.startswith("flash_attention_bwd")}, smi)
    gc.collect()  # phase 5's 32-layer replicas go before the trainer allocates
    torch.cuda.empty_cache()
    phase_s["5 serving"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase6 = rl_loop(torch, dev, counters, smi)
    gc.collect()
    torch.cuda.empty_cache()
    phase_s["6 rl loop"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase7 = train_entry_point(torch, counters)
    phase_s["7 train entry point"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    net_shapes = llama3_8b_shapes(num_layers=NET_LAYERS)
    inproc = {**phase3["step_seconds"], **phase4["step_seconds"]}
    phase8 = networked(torch, dev, transfer_counters, net_shapes, DEFAULT_CHUNK_BYTES, inproc)
    for k, n in phase8.items():
        check(n > 0, f"kernel {k} was not launched on the networked path")
    phase_s["8 networked"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase9 = dense_archs(torch, dev, {k: c for k, c in counters.items() if not k.startswith("flash_attention_bwd")}, smi)
    phase_s["9 dense archs"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase10 = gemma2_rl_loop(torch, dev, counters, smi)
    phase_s["10 gemma2 rl loop"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase11 = moe_arch(torch, dev, counters, smi)
    phase_s["11 moe arch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase12 = mla_arch(torch, dev, counters, smi)
    phase_s["12 mla arch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    fused = kernels["dequant_gather"]
    out_bytes = fused["output_bytes"]
    simulator(smi, {"dequant_gather_shape": fused["timed_shape"], "dequant_gather_ms": fused["ms"],
                    "dequant_gather_output_Bps": out_bytes / (fused["ms"] * 1e-3),
                    "copy_ms": fused["copy_ms"], "copy_output_Bps": out_bytes / (fused["copy_ms"] * 1e-3),
                    "copy_moved_Bps": 2 * out_bytes / (fused["copy_ms"] * 1e-3)})
    phase_s["13 simulator"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase14 = vlm_arch(torch, dev, counters, smi)
    phase_s["14 vlm arch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase15 = audio_arch(torch, dev, counters, smi)
    phase_s["15 audio arch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase16 = hybrid_arch(torch, dev, counters, smi)
    phase_s["16 hybrid arch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase17 = xlstm_arch(torch, dev, counters, smi)
    phase_s["17 xlstm arch"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase18 = sharding_flags(torch, dev, {k: c for k, c in counters.items() if not k.startswith("flash_attention_bwd")},
                             smi, bw)
    phase_s["18 sharding and flags"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase19 = sharded_step(torch, dev, counters, smi, bw)
    g1 = phase19.pop("g1")
    fwd["routes"]["tensor_core"]["llama3_8b_h1_g1"] = g1["forward"]
    bwd_tc["llama3_8b_h1_g1_backward"] = g1["backward"]
    for entry, case in ((fwd, g1["forward"]), (bwd_tc, g1["backward"])):
        entry["max_abs_err"] = max(entry["max_abs_err"], case["max_abs_err"])
        entry["err_over_tol"] = max(entry["err_over_tol"], case["err_over_tol"])
    phase_s["19 sharded step"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase20 = cost_model(torch, dev, counters, smi, bw, child)
    ck = phase20.pop("kernels")
    fwd["routes"]["tensor_core"]["llama3_8b_prefill_32k"] = ck["prefill_32k"]
    fwd["routes"]["decode"]["llama3_8b_decode_32k"] = ck["decode_32k"]
    fwd["routes"]["tensor_core"]["llama3_8b_train_4k"] = ck["train_4k_forward"]
    bwd_tc["llama3_8b_train_4k_backward"] = ck["train_4k_backward"]
    for entry, case in ((fwd, ck["prefill_32k"]), (fwd, ck["decode_32k"]), (fwd, ck["train_4k_forward"]),
                        (bwd_tc, ck["train_4k_backward"])):
        entry["max_abs_err"] = max(entry["max_abs_err"], case["max_abs_err"])
        entry["err_over_tol"] = max(entry["err_over_tol"], case["err_over_tol"])
    phase_s["20 cost model"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase21 = sharded_families(torch, dev, counters, smi, bw)
    loc = phase21.pop("local")
    kernels["mla_decode"]["local_16way"] = loc["mla_decode"]
    fwd["routes"]["tensor_core"]["mla_local_16way"] = loc["forward"]
    bwd_tc256["mla_local_16way_backward"] = loc["backward"]
    for entry, case in ((kernels["mla_decode"], loc["mla_decode"]), (fwd, loc["forward"]), (bwd_tc256, loc["backward"])):
        entry["max_abs_err"] = max(entry["max_abs_err"], case["max_abs_err"])
        entry["err_over_tol"] = max(entry["err_over_tol"], case["err_over_tol"])
    phase_s["21 sharded families"] = time.perf_counter() - t0
    phases = (phase3, phase4, phase5, phase6, phase7, phase8, phase9, phase10, phase11, phase12, phase14, phase15,
              phase16, phase17, phase18, phase19, phase20, phase21)
    launches = {k: sum(ph.get(k, 0) for ph in phases) for k in counters}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was launched on no main path")
    attention_phases = (phase5, phase6, phase7, phase9, phase10, phase11, phase12, phase14, phase15,
                        phase16, phase18, phase19, phase20, phase21)  # with attention
    for r in phase5["flash_attention_routes"]:
        kernels["flash_attention"]["routes"][r]["launches"] = sum(ph["flash_attention_routes"][r] for ph in attention_phases)
    training_phases = (phase6, phase7, phase10, phase11, phase12, phase14, phase15,
                       phase16, phase19, phase20, phase21)  # the paths with the backward
    by_kernel = {n: sum(ph["flash_attention_bwd_by_kernel"][n] for ph in training_phases)
                 for n in phase6["flash_attention_bwd_by_kernel"]}
    for k, entry in kernels.items():
        if k.startswith("flash_attention_bwd/"):  # pre counts every call of its route, at any head_dim
            route = k.split("/")[1]
            base, d = (route[:-4], 256) if route.endswith("_256") else (route, 128)
            names = {f"{base}/{n}" for n in bwd_kernels(d)}
            entry["launches_by_kernel"] = {n: c for n, c in by_kernel.items() if n in names}
    emit("launches", phase3=phase3, phase4=phase4, phase5=phase5, phase6=phase6, phase7=phase7,
         phase8=phase8, phase9=phase9, phase10=phase10, phase11=phase11, phase12=phase12, phase14=phase14,
         phase15=phase15, phase16=phase16, phase17=phase17, phase18=phase18, phase19=phase19, phase20=phase20,
         phase21=phase21, phase_seconds=phase_s)
    print(json.dumps({"kernels": [dict(v, launches=launches[k]) for k, v in kernels.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--publisher"]:
        sys.exit(publisher_main(sys.argv[2:]))
    if sys.argv[1:2] == ["--dryrun"]:
        sys.exit(dryrun_child_main(sys.argv[2:]))
    sys.exit(main())
