"""The port's trainer side of the RL loop, its checkpoints and its training
entry point, on the CPU.

* The loop: a ``TrainerWorker`` and ``RolloutWorker``s on one hub,
  stepped by hand and on threads: versions advance, the replica equals
  the trainer bit for bit after each update, the metric keys are the JAX
  trainer's.
* ``train_on`` against the JAX ``TrainerWorker.train_on`` on the same
  rollouts and parameters carried across (a small GQA 4:1 llama in f32):
  metrics within 2e-5 (``tests/test_kernels.py``'s f32), the gradients
  within 1e-4 of each tensor's max |value|, the new parameters within 1e-6
  apart from the elements where AdamW's first update ``~ lr * sign(g)``
  turns on a rounding-level difference in g (counted; see
  ``tests/test_torch_training.py``).
* Checkpoints: port -> port, JAX -> port and port -> JAX round trips in
  f32 (bit for bit), bf16 as the JAX package writes it, the atomic
  ``.tmp`` commit and ``LATEST``.
* ``launch/train.py``: 2 steps with ``--ckpt-dir``, then ``--resume`` to 4,
  bit-equal to 4 steps without a restart.
"""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ml_dtypes = pytest.importorskip("ml_dtypes")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jax_core  # noqa: E402
from repro import checkpoint as jax_ckpt  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.models.params import named_tensors  # noqa: E402
from repro.rl.loop import RLConfig as JaxRLConfig  # noqa: E402
from repro.rl.loop import TrainerWorker as JaxTrainer  # noqa: E402
from repro.training import AdamW as JaxAdamW  # noqa: E402
from repro.training import objectives as jobj  # noqa: E402

import repro_torch.core as port_core  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.configs.llama3_8b import CONFIG as PORT_LLAMA  # noqa: E402
from repro_torch.data.synthetic import PromptSet  # noqa: E402
from repro_torch.launch import train as train_main  # noqa: E402
from repro_torch.models.params import from_numpy, init_params  # noqa: E402
from repro_torch.rl import RLConfig, RolloutWorker, TrainerWorker  # noqa: E402
from repro_torch.training import AdamW  # noqa: E402

SMALL = dict(num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, d_ff=256, vocab=512)
JAX_CFG = dataclasses.replace(get_config("llama3-8b"), **SMALL)
PORT_CFG = dataclasses.replace(PORT_LLAMA, **SMALL)
TINY = dataclasses.replace(PORT_LLAMA, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128, vocab=256)
JAX_METRIC_KEYS = {"loss", "mean_ratio", "mean_advantage", "mean_reward", "version"}
LOSS_TOL, GRAD_TOL, OPT_TOL, FLIP_FLOOR = 2e-5, 1e-4, 1e-6, 1e-5


def _hub():
    return port_core.TensorHubClient(port_core.ReferenceServer(), device="cpu", chunk_bytes=1 << 16)


def _equal_to_trainer(worker, trainer):
    for n, t in trainer.params.items():
        assert torch.equal(worker.params[n], t), n


# -- the loop ------------------------------------------------------------------------


def test_trainer_and_rollout_on_one_hub_for_three_steps():
    hub = _hub()
    rl = RLConfig(prompt_len=5, response_len=6, num_prompts=2, group_size=4, lr=1e-2)
    queue = []
    trainer = TrainerWorker(hub, rl, TINY, queue, keep_grads=True)
    assert trainer.device == torch.device("cpu") and trainer.version == 0
    assert not any(p.requires_grad for p in trainer.params.values())
    worker = RolloutWorker("rollout-0", hub, rl, TINY, PromptSet(TINY.vocab, rl.prompt_len), queue,
                           threading.Event())
    assert worker.connect(timeout=30) == 0
    _equal_to_trainer(worker, trainer)
    rng = np.random.default_rng(0)
    for step in range(3):
        before = {n: t.clone() for n, t in trainer.params.items()}
        rec = worker.serve_batch(step)
        assert rec["version"] == step
        # a random-weight model scores ~0 everywhere: spread the rewards so
        # the advantages (and the step) are not zero
        rec["rewards"] = rng.random(rec["rewards"].shape).astype(np.float32)
        m = trainer.train_on(trainer.wait_for_rollouts(1, timeout=5))
        assert set(m) == JAX_METRIC_KEYS and m["version"] == step + 1
        assert all(np.isfinite(v) for v in m.values())
        assert set(trainer.last_grads) == set(trainer.params)
        for n, t in trainer.params.items():
            assert not torch.equal(t, before[n]), f"step {step}: {n} did not move"
        assert worker.pull_latest() and worker.weights_version == step + 1
        _equal_to_trainer(worker, trainer)
    assert [m["version"] for m in trainer.metrics_log] == [1, 2, 3]
    assert set(trainer.last_timings) == {"step_seconds", "publish_seconds"}
    trainer.close()


@pytest.mark.timeout(300)
def test_threaded_loop_as_the_jax_integration_test():
    """tests/test_rl_integration.py's scenario on the port: two rollout
    threads and a trainer."""
    cfg = RLConfig(num_steps=3, prompt_len=6, response_len=8, num_prompts=2, group_size=2)
    server = port_core.ReferenceServer()
    hub = port_core.TensorHubClient(server, device="cpu")
    prompts = PromptSet(vocab=TINY.vocab, prompt_len=cfg.prompt_len)
    queue, stop = [], threading.Event()
    trainer = TrainerWorker(hub, cfg, TINY, queue)
    workers = [RolloutWorker(f"rollout-{i}", hub, cfg, TINY, prompts, queue, stop) for i in range(2)]
    for w in workers:
        w.start()
    try:
        for step in range(cfg.num_steps):
            deadline = time.monotonic() + 240
            while len(queue) < 2:
                for w in workers:
                    if w.error:
                        raise w.error
                assert time.monotonic() < deadline, "rollouts stalled"
                time.sleep(0.05)
            m = trainer.train_on([queue.pop(0), queue.pop(0)])
            assert m["version"] == step + 1
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=90)
    for w in workers:
        if w.error:
            raise w.error
    trainer.close()
    assert server.stats["publishes"] >= cfg.num_steps
    assert server.stats["replications_completed"] >= 2
    assert all(w.weights_version is not None and w.weights_version >= 1 for w in workers)


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        TrainerWorker(port_core.TensorHubClient(port_core.ReferenceServer()), RLConfig(), TINY, [])


# -- train_on against the JAX trainer ------------------------------------------------------


def _rollouts(seed, n_rec, per_rec, prompt_len, response_len, vocab):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_rec):
        out.append({
            "tokens": rng.integers(0, vocab, size=(per_rec, prompt_len + response_len)).astype(np.int32),
            "behavior_logprobs": (-6.2 + 0.3 * rng.standard_normal((per_rec, response_len))).astype(np.float32),
            "rewards": rng.random(per_rec).astype(np.float32),
        })
    return out


def test_train_on_matches_the_jax_trainer():
    rl_kw = dict(prompt_len=5, response_len=7, num_prompts=2, group_size=4, lr=1e-3, seed=3)
    jhub = jax_core.TensorHubClient(jax_core.ReferenceServer())
    jt = JaxTrainer(jhub, JaxRLConfig(**rl_kw), JAX_CFG, [])
    v0 = {k: np.array(v) for k, v in named_tensors(jt.params).items()}
    rollouts = _rollouts(9, 2, 4, rl_kw["prompt_len"], rl_kw["response_len"], SMALL["vocab"])

    pt = TrainerWorker(_hub(), RLConfig(**rl_kw), PORT_CFG, [], params=from_numpy(v0, "cpu"), keep_grads=True)
    batch = pt.batch_from(rollouts)  # on the host: JAX's construction, element for element
    total = rl_kw["prompt_len"] + rl_kw["response_len"]
    want_blp = np.zeros((8, total - 1), np.float32)
    want_blp[:, rl_kw["prompt_len"] - 1:] = np.concatenate([r["behavior_logprobs"] for r in rollouts])
    assert np.array_equal(batch["behavior_logprobs"].numpy(), want_blp)
    assert np.array_equal(batch["loss_mask"].numpy(), want_blp != 0)
    np.testing.assert_allclose(batch["advantages"].numpy(), np.asarray(jobj.group_relative_advantages(
        jnp.asarray(np.concatenate([r["rewards"] for r in rollouts])), 4)), rtol=LOSS_TOL, atol=LOSS_TOL)

    got = pt.train_on(rollouts)
    want = jt.train_on(rollouts)
    assert set(got) == set(want) == JAX_METRIC_KEYS
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_TOL, atol=LOSS_TOL, err_msg=k)

    # the JAX step's gradients on the same batch, for the flip-prone elements
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jbatch["tokens"] = jbatch["tokens"].astype(jnp.int32)
    template = jt.model.init(jax.random.PRNGKey(0), jnp.float32)
    jv0 = jax.tree.unflatten(jax.tree.structure(template), [jnp.asarray(v0[k]) for k in named_tensors(template)])

    def jloss(p):
        logits = jt.model.forward(p, {"tokens": jbatch["tokens"]})
        return jobj.grpo_loss(logits, jbatch["tokens"], jbatch["behavior_logprobs"], jbatch["advantages"],
                              jbatch["loss_mask"])[0]

    jg = {k: np.asarray(v) for k, v in named_tensors(jax.grad(jloss)(jv0)).items()}
    v1 = {k: np.asarray(v) for k, v in named_tensors(jt.params).items()}
    for n, g in jg.items():
        pg = pt.last_grads[n].numpy()
        assert np.max(np.abs(pg - g)) <= GRAD_TOL * np.max(np.abs(g)), n
        keep = ((g == 0) & (pg == 0)) | ((np.sign(g) == np.sign(pg)) & (np.minimum(np.abs(g), np.abs(pg)) > FLIP_FLOOR))
        assert keep.mean() >= 0.95, (n, int((~keep).sum()))
        np.testing.assert_allclose(pt.params[n].numpy()[keep], v1[n][keep], rtol=OPT_TOL, atol=OPT_TOL, err_msg=n)
    # the published v1 is the trainer's buffers
    assert pt.handle.store.get("embed").data_ptr() == pt.params["embed"].data_ptr()
    jt.close()
    pt.close()


# -- checkpoints ------------------------------------------------------------------------


def _port_tree(dtype, seed=0):
    params = init_params(TINY, torch.Generator().manual_seed(seed), dtype, "cpu")
    opt = AdamW(state_dtype=dtype)
    state = opt.init(params)
    g = torch.Generator().manual_seed(seed + 1)
    for d in (state.mu, state.nu):
        for t in d.values():
            t.copy_(torch.randn(t.shape, generator=g))
    return params, state._replace(step=7)


def _jax_tree(dtype):
    from repro.models.lm import DecoderLM as JaxLM

    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                               d_ff=128, vocab=256)
    params = JaxLM(jcfg).init(jax.random.PRNGKey(1), jdt)
    opt = JaxAdamW(state_dtype=jdt)
    state = opt.init(params)
    state = state._replace(step=jnp.asarray(5, jnp.int32),
                           mu=jax.tree.map(lambda x: x + 0.25, state.mu), nu=jax.tree.map(lambda x: x + 0.5, state.nu))
    return params, state


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_port_trees_equal(a, b):
    (pa, sa), (pb, sb) = a, b
    assert sa.step == sb.step
    for x, y in ((pa, pb), (sa.mu, sb.mu), (sa.nu, sb.nu)):
        assert list(x) == list(y)
        for n in x:
            assert x[n].dtype == y[n].dtype and torch.equal(_bits(x[n]), _bits(y[n])), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_port_to_port(tmp_path, dtype):
    tree = _port_tree(dtype)
    path = ckpt.save(str(tmp_path), 7, tree, metadata={"stream_offset": 12})
    assert os.path.basename(path) == "step_00000007" and ckpt.latest_step(str(tmp_path)) == 7
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json").read_text())
    assert manifest["leaves"]["0/layers/attn/wq"]["dtype"] == ("bfloat16" if dtype == torch.bfloat16 else "float32")
    assert manifest["leaves"]["1/step"] == {"file": "shard_00000.npz", "shape": [], "dtype": "int32"}
    template = _port_tree(dtype, seed=5)
    got, step, meta = ckpt.restore(str(tmp_path), template)
    assert step == 7 and meta == {"stream_offset": 12}
    _assert_port_trees_equal(got, tree)


def test_checkpoint_leaf_names_are_the_jax_tree_paths(tmp_path):
    params, state = _jax_tree(torch.float32)
    jax_ckpt.save(str(tmp_path / "jax"), 1, (params, state))
    ckpt.save(str(tmp_path / "port"), 1, _port_tree(torch.float32))
    names = [json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text())["leaves"] for d in ("jax", "port")]
    assert names[0].keys() == names[1].keys()
    assert {k: v["shape"] for k, v in names[0].items()} == {k: v["shape"] for k, v in names[1].items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path, dtype):
    """f32 and bf16: the JAX package writes a bf16 leaf as |V2 words with
    the manifest dtype "bfloat16"; the port restores it bit for bit."""
    params, state = _jax_tree(dtype)
    jax_ckpt.save(str(tmp_path), 5, (params, state), metadata={"stream_offset": 3})
    got, step, meta = ckpt.restore(str(tmp_path), _port_tree(dtype))
    assert step == 5 and meta == {"stream_offset": 3} and got[1].step == 5
    want = (from_numpy({k: np.asarray(v) for k, v in named_tensors(params).items()}, "cpu"),
            got[1]._replace(mu=from_numpy({k: np.asarray(v) for k, v in named_tensors(state.mu).items()}, "cpu"),
                            nu=from_numpy({k: np.asarray(v) for k, v in named_tensors(state.nu).items()}, "cpu")))
    _assert_port_trees_equal(got, want)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    params, state = _jax_tree(torch.float32)
    tree = _port_tree(torch.float32)
    ckpt.save(str(tmp_path), 7, tree, metadata={"stream_offset": 9})
    (jp, js), step, meta = jax_ckpt.restore(str(tmp_path), (params, state))
    assert step == 7 and meta == {"stream_offset": 9} and int(js.step) == 7
    for name, t in tree[0].items():
        assert np.array_equal(np.asarray(named_tensors(jp)[name]), t.numpy()), name
    for name, t in tree[1].mu.items():
        assert np.array_equal(np.asarray(named_tensors(js.mu)[name]), t.numpy()), name


def test_bf16_checkpoints_are_the_same_bytes_in_both_packages(tmp_path):
    """A bf16 leaf: the port writes what the JAX package writes (|V2 words,
    manifest dtype "bfloat16"), byte for byte. Neither package's bf16 file
    restores in JAX: jnp.asarray cannot cast |V2 to bfloat16 (the JAX
    package's own round trip fails the same way), so bf16 crosses from JAX
    to the port and from the port to the port, not back into JAX."""
    params, state = _jax_tree(torch.bfloat16)
    jax_ckpt.save(str(tmp_path / "jax"), 1, (params, state))
    port_tree = ckpt.restore(str(tmp_path / "jax"), _port_tree(torch.bfloat16))[0]
    ckpt.save(str(tmp_path / "port"), 1, port_tree)
    files = [np.load(tmp_path / d / "step_00000001" / "shard_00000.npz") for d in ("jax", "port")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        a, b = files[0][k], files[1][k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    manifests = [json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text()) for d in ("jax", "port")]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    for d in ("jax", "port"):
        with pytest.raises(ValueError):
            jax_ckpt.restore(str(tmp_path / d), (params, state))


def test_checkpoint_commit_is_atomic(tmp_path, monkeypatch):
    tree = _port_tree(torch.float32)
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 1, tree)
    (tmp_path / "step_00000002.tmp").mkdir()  # a save that died before its rename
    (tmp_path / "step_00000002.tmp" / "junk").write_text("x")
    assert ckpt.latest_step(str(tmp_path)) == 1

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        ckpt.save(str(tmp_path), 3, tree)
    monkeypatch.undo()
    assert ckpt.latest_step(str(tmp_path)) == 1  # LATEST still points at the committed step
    assert not (tmp_path / "step_00000003").exists()
    got, step, _ = ckpt.restore(str(tmp_path), _port_tree(torch.float32, seed=4))
    assert step == 1
    _assert_port_trees_equal(got, tree)
    ckpt.save(str(tmp_path), 2, tree)  # a save over the dead .tmp clears it
    assert ckpt.latest_step(str(tmp_path)) == 2 and not (tmp_path / "step_00000002.tmp").exists()
    assert (tmp_path / "LATEST").read_text() == "step_00000002"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST", "step_00000001", "step_00000002",
                                                          "step_00000003.tmp"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), tree)


# -- the training entry point ----------------------------------------------------------------------


def _train_args(tmp_path, *extra):
    return ["--device", "cpu", "--batch", "2", "--seq", "16", "--ckpt-every", "2", *extra]


def test_train_entry_point_resumes_where_it_stopped(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    train_main.main(_train_args(tmp_path, "--steps", "2", "--ckpt-dir", a))
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "checkpointed ->" in out and ckpt.latest_step(a) == 2
    train_main.main(_train_args(tmp_path, "--steps", "4", "--ckpt-dir", a, "--resume", "--publish"))
    out = capsys.readouterr().out
    assert "resumed from step 2 (stream offset 2)" in out and ckpt.latest_step(a) == 4
    train_main.main(_train_args(tmp_path, "--steps", "4", "--ckpt-dir", b))  # the same 4 steps without a restart
    cfg = PORT_LLAMA.reduced()
    template = (init_params(cfg, torch.Generator().manual_seed(9), torch.float32, "cpu"), None)
    template = (template[0], AdamW().init(template[0]))
    got, _, meta_a = ckpt.restore(a, template)
    want, _, meta_b = ckpt.restore(b, template)
    assert meta_a == meta_b == {"stream_offset": 4}
    _assert_port_trees_equal(got, want)


def test_train_entry_point_at_its_defaults_on_the_cpu(capsys):
    """The reduced config's defaults (head_dim 16, f32) for two steps: the
    card takes them on the f32 route and the cuda_core backward."""
    import re

    from repro_torch.kernels import flash_attention as fa

    train_main.main(["--device", "cpu", "--steps", "2"])
    losses = [float(x) for x in re.findall(r"loss (\S+)", capsys.readouterr().out)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    cfg = PORT_LLAMA.reduced()
    hd = cfg.d_model // cfg.num_heads
    q = torch.empty((8, cfg.num_heads, 64, hd), device="meta")
    k = torch.empty((8, cfg.num_kv_heads, 64, hd), device="meta")
    assert hd == 16 and fa._route(q, k, grad=True) == "f32" and fa._bwd_route(q) == "cuda_core"


def test_train_entry_point_takes_llama3_8b_only(capsys):
    with pytest.raises(SystemExit):
        train_main.main(["--arch", "gemma2-9b", "--device", "cpu"])
    assert "llama3-8b" in capsys.readouterr().err


def test_train_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(port_core.TensorHubError, match="CUDA is not available"):
        train_main.main(["--steps", "1"])
