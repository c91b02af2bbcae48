"""The port's dry run and its cost model (``launch/{roofline,op_costs,cells,dryrun}``)
against the JAX package's and against hand counts, on the CPU.

In this process: ``model_flops`` and ``active_param_count`` equal to the
JAX package's for every live cell, ``live_cells()`` equal to the JAX list,
the roofline's terms against hand values, ``op_costs.analyze`` of plain
products against hand counts, the kernel operators equal to the functions
they wrap on the CPU (forward and gradient, bit for bit) with fakes of the
real shapes and dtypes, and their FLOP formulas against a brute count of
the live pairs of the attention's mask.

Every trace on a fake process group runs in ``tests/torch_dryrun_worker.py``
(three processes started side by side, each part under its own deadline
from its own start, and read by the tests of its own records only: a part
that fails errors its own tests), never in a pytest worker: ``analyze`` of DTensor products on the fake 2x4 mesh against hand
counts; the trip-count extension of ``analyze_cell`` equal, every field,
to a full-depth trace for narrowed llama3-8b, gemma2-2b, dbrx and
deepseek-v3 (a dense prefix before its MoE stack) in each kind; the
length extension of ``analyze_cell`` equal, every field, to a
whole-length trace for a narrowed xlstm-350m's train and prefill steps; a
narrowed dense prefill's per-device dot FLOPs equal to the formula; one
MLA decode layer's collectives, one all-reduce of its output projection
whatever the cache's length; one shared block of zamba2's ring decode,
its collectives the same whatever the ring's length; one shared block
of zamba2's decode over a plain cache, attending where the cache lies,
its collectives the same whatever the cache's length; the embedding
lookup by vocab block, its collectives the same whatever the vocabulary;
every leaf of every live cell placed as the JAX ``spec_for`` places it,
on the 16x16 and the 2x16x16 meshes; and the ``--all`` run tracing all
31 live cells and exiting 0.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import cells as jax_cells  # noqa: E402
from repro.launch import hlo_stats  # noqa: E402
from repro.models import active_param_count as jax_active_param_count  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.params import ParamSpec as JaxParamSpec  # noqa: E402
from repro.sharding import rules as jax_rules  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mla_decode as md  # noqa: E402
from repro_torch.launch import cells, op_costs, roofline  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import active_param_count  # noqa: E402
from repro_torch.sharding import placements_for  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_sharded_step import once  # noqa: E402
from test_training_checkpoint import make_abstract_mesh  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "torch_dryrun_worker.py")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: each worker part's deadline, seconds from its start: about 3x its time alone on an idle 8-core CPU (dense 92 s,
#: gated 79 s, all 93 s) would be under the 420 s all three shared before, which each keeps
DEADLINES = {"dense": 420.0, "gated": 420.0, "all": 420.0}
LIVE = jax_cells.live_cells()


# -- arithmetic: model FLOPs, the cells, the roofline ------------------------------------------


@pytest.mark.parametrize("arch,shape", LIVE, ids=[f"{a}-{s}" for a, s in LIVE])
def test_model_flops_equal_the_jax_package(arch, shape):
    jcfg = jax_get_config(arch)
    assert active_param_count(get_config(arch)) == jax_active_param_count(jcfg, jax_build_model(jcfg))
    assert roofline.model_flops(get_config(arch), SHAPES[shape]) == hlo_stats.model_flops(jcfg, JAX_SHAPES[shape])


def test_live_cells_equal_the_jax_package():
    assert cells.live_cells() == LIVE
    assert len(LIVE) == 31


def test_roofline_terms_against_hand_values():
    stats = roofline.CollectiveStats({"all-gather": 6_000, "all-reduce": 0, "reduce-scatter": 4_000, "all-to-all": 0,
                                      "collective-permute": 0},
                                     {"all-gather": 2, "all-reduce": 0, "reduce-scatter": 1, "all-to-all": 0,
                                      "collective-permute": 0}, {"nvlink": 9e9, "rdma": 1e9})
    r = roofline.Roofline(flops_per_device=989e12 * 0.5, hbm_bytes_per_device=3.35e12 * 0.25,
                          collective_bytes_per_device=1e10, chips=4, collectives=stats)
    assert stats.total_bytes == 10_000
    assert r.compute_s == pytest.approx(0.5, rel=1e-12)
    assert r.memory_s == pytest.approx(0.25, rel=1e-12)
    assert r.collective_s == pytest.approx(9e9 / 450e9 + 1e9 / 25e9, rel=1e-12)  # 0.02 + 0.04
    assert r.dominant == "compute" and r.bound_s == r.compute_s
    assert r.model_flops_fraction(989e12) == pytest.approx(0.5, rel=1e-12)  # of 4 x 0.5 x 989e12 traced
    assert r.roofline_fraction(989e12) == pytest.approx(0.25 / 0.5, rel=1e-12)  # 989e12 / (4 x 989e12) = 0.25 s
    slow = dataclasses.replace(r, collectives=roofline.CollectiveStats({}, {}, {"nvlink": 0, "rdma": 25e9}))
    assert slow.collective_s == pytest.approx(1.0) and slow.dominant == "collective"
    assert roofline.link_of(range(8)) == "nvlink" and roofline.link_of(range(16)) == "rdma"
    assert roofline.link_of([0, 16, 32]) == "rdma" and roofline.link_of([3]) == "nvlink"


def test_analyze_plain_products_against_hand_counts():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    c = op_costs.analyze(lambda x, y: x @ y, a, b)
    assert c.dot_flops == 2 * 8 * 4 * 16 and c.hbm_bytes == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    x, y = torch.randn(3, 8, 16), torch.randn(3, 16, 5)
    c = op_costs.analyze(torch.bmm, x, y)
    assert c.dot_flops == 2 * 3 * 8 * 5 * 16 and c.hbm_bytes == 4 * (3 * 8 * 16 + 3 * 16 * 5 + 3 * 8 * 5)
    c = op_costs.analyze(lambda x, y: torch.einsum("bij,bjk->bik", x, y), x, y)
    assert c.dot_flops == 2 * 3 * 8 * 5 * 16
    bias = torch.randn(4)
    c = op_costs.analyze(torch.addmm, bias, a, b)
    assert c.dot_flops == 2 * 8 * 4 * 16
    # views are free; a copy reads and writes; an in-place write counts its operands once
    c = op_costs.analyze(lambda t: t.t().reshape(-1), a)
    assert c.dot_flops == 0 and c.hbm_bytes == 2 * 4 * 8 * 16
    dst = torch.zeros(4, 10)
    c = op_costs.analyze(lambda d, s: d[:, 2:5].copy_(s), dst, torch.ones(4, 3))
    assert c.hbm_bytes == 2 * 4 * 4 * 3
    assert not any(c.collective_counts.values())


CASES = [  # (sq, kv_len, causal, q_offset, window)
    (16, 16, True, 0, 0), (16, 40, True, 24, 0), (1, 33, True, 32, 0), (12, 30, False, 0, 0),
    (20, 20, True, 0, 6), (7, 50, True, 43, 9), (9, 40, True, 3, 4), (33, 64, False, 0, 0),
]


@pytest.mark.parametrize("sq,kv_len,causal,q_offset,window", CASES)
def test_flop_formulas_against_brute_counts(sq, kv_len, causal, q_offset, window):
    """The live pairs of the kernels' formulas against the mask's own
    count, and the FLOP counter's total of the operators' forward and
    backward against the formulas."""
    brute = int(fa._mask(sq, torch.arange(kv_len + 3), causal, q_offset, kv_len, window).expand(sq, -1).sum())
    assert fa.live_pairs(sq, kv_len, causal, q_offset, window) == brute
    b, hq, hkv, d = 2, 4, 2, 16
    q = torch.randn(b, hq, sq, d, requires_grad=True)
    k = torch.randn(b, hkv, kv_len + 3, d, requires_grad=True)
    v = torch.randn(b, hkv, kv_len + 3, d, requires_grad=True)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fa.flash_attention_op(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, window=window)
        out.sum().backward()
    assert counter.get_total_flops() == 2 * (d + d) * b * hq * brute + 2 * (4 * d + 3 * d) * b * hq * brute
    assert fa.forward_flops(b, hq, sq, 24, 16, kv_len=kv_len, causal=causal, q_offset=q_offset,
                            window=window) == 2 * 40 * b * hq * brute
    costs = op_costs.analyze(lambda *t: fa.flash_attention_op(*t, causal=causal, q_offset=q_offset, kv_len=kv_len,
                                                              window=window), q.detach(), k.detach(), v.detach())
    assert costs.dot_flops == 2 * (d + d) * b * hq * brute


OP_CASES = [  # (hq, hkv, sq, sk, d, dv, dtype, kw)
    (4, 2, 16, 16, 32, 32, torch.float32, dict(causal=True)),
    (4, 2, 1, 40, 64, 64, torch.bfloat16, dict(causal=True, q_offset=30, kv_len=31)),
    (4, 4, 20, 20, 16, 16, torch.float32, dict(causal=True, window=6, softcap=5.0)),
    (2, 1, 12, 12, 24, 16, torch.float32, dict(causal=True)),
    (4, 2, 9, 9, 16, 16, torch.float16, dict(causal=False)),
]


@pytest.mark.parametrize("case", OP_CASES, ids=[f"{c[6]}-{c[4]}-{sorted(c[7].items())}" for c in OP_CASES])
def test_flash_operator_equals_the_wrapped_function_on_the_cpu(case):
    """On the CPU the operator is the wrapped function bit for bit, forward
    and gradient, and its fake gives the real shapes and dtypes
    (``torch.library.opcheck`` checks the fakes, the autograd registration
    and the schema on the real call too)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    hq, hkv, sq, sk, d, dv, dtype, kw = case
    g = torch.Generator().manual_seed(sq * 31 + sk)
    q = torch.randn(2, hq, sq, d, generator=g).to(dtype)
    k = torch.randn(2, hkv, sk, d, generator=g).to(dtype)
    v = torch.randn(2, hkv, sk, dv, generator=g).to(dtype)
    assert torch.equal(fa.flash_attention_op(q, k, v, **kw), fa.flash_attention(q, k, v, **kw))
    dout = torch.randn(2, hq, sq, dv, generator=g).to(dtype)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*leaves, **kw), leaves, dout)

    assert all(torch.equal(a, b) for a, b in zip(grads(fa.flash_attention_op), grads(fa.flash_attention)))
    with FakeTensorMode() as mode:
        fake = fa.flash_attention_op(*(mode.from_tensor(t) for t in (q, k, v)), **kw)
    assert (tuple(fake.shape), fake.dtype) == ((2, hq, sq, dv), dtype)
    flags = (kw.get("causal", True), float(kw.get("softcap", 0.0)), kw.get("q_offset", 0), kw.get("kv_len", sk),
             kw.get("window", 0))
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default, (q.requires_grad_(), k, v, *flags, True))
    out, lse = fa.attention_plain(q.detach(), k, v, **kw), fa.attention_lse_plain(q.detach(), k, **kw)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_backward.default,
                          (q.detach(), k, v, out, lse, dout, *flags))


def test_mla_operator_equals_the_wrapped_function_on_the_cpu():
    from torch._subclasses.fake_tensor import FakeTensorMode

    g = torch.Generator().manual_seed(3)
    args = (torch.randn(2, 4, 1, 16, generator=g), torch.randn(2, 4, 1, 8, generator=g),
            torch.randn(2, 20, 16, generator=g), torch.randn(2, 20, 8, generator=g))
    assert torch.equal(md.mla_decode_op(*args, kv_len=13, scale=0.25), md.mla_decode(*args, kv_len=13, scale=0.25))
    with FakeTensorMode() as mode:
        fake = md.mla_decode_op(*(mode.from_tensor(t) for t in args), kv_len=13, scale=0.25)
    assert (tuple(fake.shape), fake.dtype) == ((2, 4, 1, 16), torch.float32)
    torch.library.opcheck(torch.ops.repro_torch.mla_decode.default, (*args, 13, 0.25))


def test_mla_formula_against_hand_count():
    from torch.utils.flop_counter import FlopCounterMode

    b, h, r, rd, kv = 2, 4, 16, 8, 11
    with FlopCounterMode(display=False) as counter:
        md.mla_decode_op(torch.randn(b, h, 1, r), torch.randn(b, h, 1, rd), torch.randn(b, 20, r),
                         torch.randn(b, 20, rd), kv_len=kv, scale=0.3)
    assert counter.get_total_flops() == md.decode_flops(b, h, 1, r, rd, kv_len=kv) == 2 * (r + rd + 2 * r) * b * h * kv


# -- the traces on a fake process group ---------------------------------------------------------


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """``records(part)``: one worker part's records, the three parts started
    side by side at the first call and each read when a test first asks for
    it, under its own deadline from its start."""
    work = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = {}

    @once
    def records(part):
        if not procs:
            for name in DEADLINES:
                procs[name] = (subprocess.Popen([sys.executable, WORKER, work, name], stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True, env=env), time.monotonic())
        proc, start = procs[part]
        try:
            log, _ = proc.communicate(timeout=max(DEADLINES[part] - (time.monotonic() - start), 1.0))
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            raise AssertionError(f"dry-run worker part {part} still running after {DEADLINES[part]} s: {log[-3000:]}")
        assert proc.returncode == 0 and "DRYRUN_WORKER_OK" in log, (part, log[-3000:])
        with open(os.path.join(work, f"{part}.json")) as fh:
            return json.load(fh)

    yield records
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _zero():
    return {k: 0 for k in roofline.COLLECTIVES}


def test_analyze_dtensor_products_against_hand_counts(worker):
    """On the fake 2x4 mesh (ranks 0-7: one node): x [8, 16] f32, w [16,
    12] f32. Rows over data times columns over model: one local [4, 16] x
    [16, 3] product, no collective. Contracted dimension over model: a
    local [8, 4] x [4, 12] product whose partial sum is all-reduced into
    the replicated [8, 12] (384 bytes over NVLink). Rows over data
    gathered whole: one all-gather of [8, 16] (512 bytes)."""
    hand = worker("dense")["hand"]
    mm = hand["mm_sharded"]
    assert mm["dot_flops"] == 2 * 4 * 3 * 16 and mm["hbm_bytes"] == 4 * (4 * 16 + 16 * 3 + 4 * 3)
    assert mm["collective_counts"] == _zero()
    red = hand["mm_contracted"]
    assert red["dot_flops"] == 2 * 8 * 12 * 4
    assert red["collective_counts"] == dict(_zero(), **{"all-reduce": 1})
    assert red["collective_bytes"] == dict(_zero(), **{"all-reduce": 8 * 12 * 4})
    assert red["collective_bytes_by_link"] == {"nvlink": 384, "rdma": 0}
    assert red["hbm_bytes"] == 4 * (8 * 4 + 4 * 12 + 8 * 12) + 2 * 4 * 8 * 12  # the product, the all-reduce's in and out
    gat = hand["gather_rows"]
    assert gat["collective_counts"] == dict(_zero(), **{"all-gather": 1})
    assert gat["collective_bytes"] == dict(_zero(), **{"all-gather": 8 * 16 * 4})
    assert gat["hbm_bytes"] == 4 * (4 * 16 + 8 * 16) and gat["dot_flops"] == 0


TRIPS = [f"{a}/{s}" for a in ("llama3-8b", "gemma2-2b", "dbrx-132b", "deepseek-v3-671b")
         for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("cell", TRIPS)
def test_trip_count_extension_equals_a_full_depth_trace(worker, cell):
    rec = worker("dense" if cell.startswith("llama3-8b/") else "gated")["trips"][cell]
    assert rec["layers"] > max(rec["depths"])  # extended, not traced at full depth
    assert rec["extended"] == rec["full"]
    assert rec["full"]["dot_flops"] > 0


def test_dense_prefill_dot_flops_equal_the_formula(worker):
    """A dense prefill on the 2x4 mesh under ``SERVE_RULES``, every width
    dividing the 4-way model axis: each data rank's b = B / 2 sequences;
    the q, k, v, o and MLP products on each model rank's quarter of their
    output (or input) features; the attention on each model rank's
    quarter of the query heads, beside their KV heads (the KV heads divide
    the model axis, so the attention runs where they lie), causal; the
    head on the last position's quarter of the vocabulary."""
    rec = worker("dense")["dense"]
    cfg, b, s = rec["cfg"], rec["batch"] // 2, rec["seq"]
    d, hq, hkv, hd, ff, vocab = (cfg[k] for k in ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff", "vocab"))
    t = b * s
    proj = 2 * t * (d * hq * hd // 4 + 2 * d * hkv * hd // 4 + hq * hd // 4 * d + 3 * d * ff // 4)
    attn = 2 * (hd + hd) * b * hq // 4 * (s * (s + 1) // 2)
    head = 2 * b * 1 * d * vocab // 4
    assert rec["costs"]["dot_flops"] == cfg["num_layers"] * (proj + attn) + head


@pytest.mark.parametrize("slots", [64, 256])
def test_mla_decode_layer_moves_no_collective_that_grows_with_the_cache(worker, slots):
    """One MLA decode layer on the fake 2x4 mesh under ``SERVE_RULES``
    (reduced deepseek-v3, 4 query heads over the 4-way model axis, batch 8
    over the 2-way data axis, a latent cache of 64 or 256 slots placed
    ``("batch", "seq", "kv_lora")``): each rank scores its own query heads
    against its batch block of the cache, so its only collective is one
    all-reduce of the output projection's partial sum, ``B/dp x 1 x d x
    2`` bytes (bf16), the same at both lengths, and no all-gather. The
    latent attention saw [B/2, H/4, 1, R] against [B/2, slots, R]."""
    rec = worker("dense")["mla_decode"][str(slots)]
    cfg, b = rec["cfg"], rec["batch"]
    wo_partial = b // 2 * 1 * cfg["d_model"] * 2
    costs = rec["costs"]
    assert costs["collective_counts"] == dict(_zero(), **{"all-reduce": 1})
    assert costs["collective_bytes"] == dict(_zero(), **{"all-reduce": wo_partial})
    assert costs["collective_bytes"] == worker("dense")["mla_decode"]["64"]["costs"]["collective_bytes"]
    r = cfg["kv_lora_rank"]
    assert rec["latent_calls"] == [[[b // 2, cfg["num_heads"] // 4, 1, r], [b // 2, slots, r]]]
    assert costs["hbm_bytes"] > b // 2 * slots * r * 2  # the cache block is read


@pytest.mark.parametrize("slots", [64, 256])
def test_ring_decode_layer_moves_no_collective_that_grows_with_the_ring(worker, slots):
    """One shared attention block of zamba2's ring decode on the fake 2x4
    mesh under ``LONG_SERVE_RULES`` (reduced zamba2, batch 1, a ring of 64
    or 256 f32 slots placed ``("batch", "kv_heads", "seq", "head_dim")``:
    its slots over the 2-way data axis, its 4 KV heads over the 4-way
    model axis): each rank attends over its own block of slots, every slot
    valid past the ring's first turn, and the ranks' outputs and
    log-sum-exps are merged by one all-gather over the data axis, so the
    collectives are the same at both lengths, kind for kind and byte for
    byte: the merge's gather moves each rank's ``hd + 1`` f32 a query row,
    not the ring. The attention saw [1, H/4, 1, hd] against [1, Hkv/4,
    slots/2, hd]."""
    rec = worker("dense")["ring_decode"][str(slots)]
    cfg = rec["cfg"]
    costs = rec["costs"]
    assert costs["collective_counts"] == worker("dense")["ring_decode"]["64"]["costs"]["collective_counts"]
    assert costs["collective_bytes"] == worker("dense")["ring_decode"]["64"]["costs"]["collective_bytes"]
    assert costs["collective_counts"]["all-gather"] >= 1
    h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    assert rec["calls"] == [[[1, h // 4, 1, hd], [1, hkv // 4, slots // 2, hd], slots // 2]]
    assert costs["hbm_bytes"] > 2 * slots // 2 * hkv // 4 * hd * 4  # the K and V blocks are read


@pytest.mark.parametrize("slots", [64, 256])
def test_shared_decode_layer_attends_where_the_cache_lies(worker, slots):
    """One shared attention block of zamba2's decode over a plain cache on
    the fake 2x4 mesh under ``SERVE_RULES`` (reduced zamba2, batch 8, a
    bf16 cache of 64 or 256 slots placed ``("batch", "kv_heads", "seq",
    "head_dim")``: its batch over the 2-way data axis, its 4 KV heads over
    the 4-way model axis): each rank attends on its own block of the batch
    and the KV heads, beside their query heads, so no all-gather moves the
    cache and the collectives are the same at both lengths, kind for kind
    and byte for byte (what remains is the MLP's and the output
    projection's, which DTensor places by the layer's widths). The
    attention saw [B/2, H/4, 1, hd] against [B/2, Hkv/4, slots, hd]."""
    rec = worker("gated")["shared_decode"][str(slots)]
    cfg, b = rec["cfg"], rec["batch"]
    costs = rec["costs"]
    assert costs["collective_counts"] == worker("gated")["shared_decode"]["64"]["costs"]["collective_counts"]
    assert costs["collective_bytes"] == worker("gated")["shared_decode"]["64"]["costs"]["collective_bytes"]
    h, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    assert rec["calls"] == [[[b // 2, h // 4, 1, hd], [b // 2, hkv // 4, slots, hd]]]
    assert costs["hbm_bytes"] > 2 * b // 2 * hkv // 4 * slots * hd * 2  # the K and V blocks are read


def test_embedding_lookup_moves_no_collective_that_grows_with_the_vocab(worker):
    """The embedding lookup of a bf16 table [vocab, 64] whose vocab lies
    over the 4-way model axis of the fake 2x4 mesh (``SERVE_RULES``), for
    tokens [8, 4] placed by ``("batch", "seq")``: each rank looks up the
    tokens of its batch block that fall in its own rows, and one
    reduce-scatter of its [B/2, S, 64] partial rows over the model axis
    (bf16) sums them into the placement DTensor's own lookup gives its
    result, the width split over the model axis: [B/2, S, 64/4] a rank.
    The same at a vocabulary of 1024 and of 8192; nothing gathers the
    table."""
    small, large = (worker("gated")["embed_lookup"][v] for v in ("1024", "8192"))
    assert small["placements"] == large["placements"]
    assert [p[0] for p in small["placements"]] == ["R", "S"] and "0" in small["placements"][1]  # vocab over model
    assert small["costs"]["collective_counts"] == large["costs"]["collective_counts"]
    assert small["costs"]["collective_bytes"] == large["costs"]["collective_bytes"]
    assert small["costs"]["collective_counts"] == dict(_zero(), **{"reduce-scatter": 1})
    assert small["costs"]["collective_bytes"] == dict(_zero(), **{"reduce-scatter": 8 // 2 * 4 * 64 // 4 * 2})


def test_lookup_fallback_gives_the_placements_dtensor_picks_at_full_size(worker):
    """Where a PyTorch release cannot propagate DTensor's own lookup (2.11
    refuses tokens split over pod and data), the vocab-block lookup leaves
    its result where DTensor picks at the published widths: the width
    split over every mesh dimension that splits the table, the tokens'
    placement on the others. Five full-size cells (serving and training
    tables, batch 1, the xLSTM) on both production meshes, each the same
    both ways."""
    got = worker("gated")["lookup_fallback"]
    assert len(got) == 10
    for cell, (probed, fallback) in got.items():
        assert probed == fallback, cell


@pytest.mark.parametrize("shape", ["prefill_32k", "train_4k"])
def test_length_extension_equals_a_whole_length_trace(worker, shape):
    """A narrowed xlstm-350m (one mLSTM and one sLSTM block) at 10 chunks
    of the mLSTM (the worker cuts its chunk to 16 tokens) on the fake 2x4
    mesh: ``analyze_cell`` traces it at whole numbers of chunks until two
    increments repeat exactly and extends the last to 10 chunks; every
    field equals one trace at the whole length."""
    rec = worker("dense")["seq_trips"][shape]
    assert rec["seq_lens"] and max(rec["seq_lens"]) < rec["tokens"] and rec["seq_times"] >= 1
    assert rec["extended"] == rec["full"]
    assert rec["full"]["dot_flops"] > 0


def _jax_leaves(arch, shape):
    """``{leaf name: (shape, axes)}`` of the JAX cell of ``arch`` x
    ``shape``, named as the worker names the port's, its kind and rules."""
    cfg = jax_get_config(arch)
    case = JAX_SHAPES[shape]
    model = jax_build_model(cfg)

    def named(tree, prefix):
        out = {}
        if isinstance(tree, JaxParamSpec):
            return {prefix[:-1]: tree}
        items = enumerate(tree) if isinstance(tree, (list, tuple)) else ((k, tree[k]) for k in sorted(tree))
        for k, v in items:
            out.update(named(v, f"{prefix}{k}/"))
        return out

    leaves = {}
    params = named(model.param_specs(), "")
    kind = case.kind  # an encoder's live cells are train and prefill (its encode)
    for n, p in params.items():
        leaves[f"params/{n}"] = (p.shape, p.axes)
        if kind == "train":
            leaves[f"mu/{n}"] = leaves[f"nu/{n}"] = (p.shape, p.axes)
    if kind == "decode":
        ring = case.name == "long_500k" and cfg.family == "hybrid"
        for n, p in named(model.cache_specs(case.global_batch, case.seq_len, ring=ring), "").items():
            leaves[f"cache/{n}"] = (p.shape, p.axes)
        leaves["batch/tokens"] = ((case.global_batch, 1), ("batch", None))
    else:
        for n, st in model.input_specs(case).items():
            leaves[f"batch/{n}"] = (tuple(st.shape), jax_cells._INPUT_AXES[n][: len(st.shape)])
    return kind, leaves, jax_rules.rules_for(case.kind, global_batch=case.global_batch)


MESHES = {"single": ((16, 16), ("data", "model")), "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", LIVE, ids=[f"{a}-{s}" for a, s in LIVE])
def test_cell_leaves_are_placed_as_the_jax_cell(worker, arch, shape, mesh):
    got = worker("dense" if mesh == "single" else "gated")["leaves"][mesh][f"{arch}/{shape}"]
    kind, want, rules = _jax_leaves(arch, shape)
    assert got["kind"] == kind
    assert set(got["leaves"]) == set(want)
    dims, names = MESHES[mesh]
    jax_mesh, port_mesh = make_abstract_mesh(dims, names), MeshShape(dims, names)
    for name, (shp, axes) in want.items():
        leaf = got["leaves"][name]
        assert tuple(leaf["shape"]) == tuple(shp), name
        spec = tuple(jax_rules.spec_for(shp, axes, rules, jax_mesh))
        assert leaf["placements"] == [str(p) for p in placements_for(spec, port_mesh)], (name, spec)
        if name.startswith(("params/", "mu/", "nu/")):
            assert leaf["dtype"] == ("torch.bfloat16" if name.startswith("params/") else "torch.float32"), name


def test_dryrun_all_refuses_exactly_the_two_recurrent_families(worker):
    """``--all`` (every config cut by ``reduced()``) exits 0 and writes a
    record a cell, all 31 traced, the hybrid's and the xLSTM's 8 among
    them: the two families it once refused are refused no more, so the
    set refused is empty. Every record carries the JAX record's keys and
    names the PyTorch release; the xLSTM's train and prefill cells are
    counted over cut lengths, extended."""
    rec = worker("all")["all"]
    assert rec["rc"] == 0
    by_cell = {(r["arch"], r["shape"]): r for r in rec["cells"].values()}
    assert set(by_cell) == set(LIVE) and len(by_cell) == 31
    for (arch, shape), r in by_cell.items():
        assert r["torch"] == torch.__version__, arch
        assert r["ok"], (arch, shape, r.get("error"))
        assert ("seq_lens" in r) == (arch == "xlstm-350m" and shape in ("train_4k", "prefill_32k")), (arch, shape)
        for key in ("flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device", "collective_counts",
                    "collective_bytes", "compute_s", "memory_s", "collective_s", "dominant", "model_flops",
                    "model_flops_fraction", "roofline_fraction", "memory_analysis", "trace_s", "chips"):
            assert key in r, (arch, key)
        assert r["chips"] == 256 and r["mesh"] == "16x16" and r["flops_per_device"] > 0
