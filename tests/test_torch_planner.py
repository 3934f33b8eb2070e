"""Drift guard: the port's copy of the numpy-only planner, configs and
control planes must stay the JAX package's.

The port imports nothing of ``repro``, so it carries copies of
``repro/core``, the configs it runs, ``repro/obs``, ``repro/adapt`` and
``repro/elastic``'s health monitor, fault scenarios and controller.
Each copied file must equal its original with only the package name in
imports changed, the copied planner must return the same schedule and
bucket times, and the port's per-leaf time model (the repartitioner's
input) must equal JAX's, as must the registry's ids, its long-context
variant and ``config_for_shape``.
"""
import dataclasses
import re
from pathlib import Path

import jax
import pytest

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.configs import ARCH_NAMES, SHAPES, config_for_shape, get_config
from repro.configs import reduce_for_smoke
from repro.core.deft import Planner as JPlanner
from repro.core.deft import PlanRequest as JPlanRequest
from repro.core.profiler import HardwareModel as JHardwareModel
from repro.launch.train import build_schedule as jax_build_schedule
from repro.train.bucketing import build_leaf_time_model as jax_leaf_model
from repro.models.model import init_params as jax_init_params
from repro_torch.configs import ARCH_NAMES as T_ARCH_NAMES
from repro_torch.configs import SHAPES as T_SHAPES
from repro_torch.configs import config_for_shape as t_config_for_shape
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core.deft import Planner, PlanRequest
from repro_torch.core.profiler import HardwareModel
from repro_torch.launch.train import build_schedule
from repro_torch.models.model import init_params
from repro_torch.train.bucketing import build_leaf_time_model
from repro_torch.tree import tree_leaves

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = sorted(
    [f"core/{p.name}" for p in (SRC / "repro" / "core").glob("*.py")]
    + ["configs/base.py", "configs/shapes.py", "configs/gemma2_2b.py",
       "configs/qwen3_4b.py",
       "configs/recurrentgemma_9b.py", "configs/rwkv6_1_6b.py",
       "configs/seamless_m4t_large_v2.py", "configs/llama_3_2_vision_90b.py",
       "configs/starcoder2_7b.py", "configs/deepseek_7b.py",
       "configs/deepseek_v2_236b.py", "configs/llama4_maverick_400b_a17b.py"]
    + [f"{pkg}/{p.name}" for pkg in ("obs", "adapt")
       for p in (SRC / "repro" / pkg).glob("*.py")]
    + ["elastic/health.py", "elastic/faults.py", "elastic/controller.py"]
)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_is_verbatim(rel):
    orig = (SRC / "repro" / rel).read_text()
    want = re.sub(
        r"\brepro\.(core|configs|obs|adapt|elastic|train\.bucketing)",
        r"repro_torch.\1", orig)
    assert (SRC / "repro_torch" / rel).read_text() == want


ARCHS = ["gemma2-2b", "qwen3-4b", "recurrentgemma-9b", "rwkv6-1.6b",
         "seamless-m4t-large-v2", "llama-3.2-vision-90b", "starcoder2-7b",
         "deepseek-7b", "deepseek-v2-236b", "llama4-maverick-400b-a17b"]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_time_model_matches_jax(arch, smoke):
    """The per-leaf atoms over a meta tree equal JAX's over its
    ``eval_shape`` tree, and so do the bucket times they price."""
    cfg, tcfg = get_config(arch), t_get_config(arch)
    if smoke:
        cfg, tcfg = reduce_for_smoke(cfg), t_reduce(tcfg)
    jp = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    jm = jax_leaf_model(jp, cfg, JHardwareModel(dp_degree=2), 64, 2)
    tm = build_leaf_time_model(init_params(tcfg, device="meta"), tcfg,
                               HardwareModel(dp_degree=2), 64, 2)
    assert (tm.order, tm.fwd_s, tm.elems) == (jm.order, jm.fwd_s, jm.elems)
    bo, nb = tm.partition(150_000)
    assert (bo, nb) == jm.partition(150_000)
    assert dataclasses.astuple(tm.with_coverage_rate(bo, nb, 1.8)
                               .bucket_times(bo, nb)) == \
        dataclasses.astuple(jm.with_coverage_rate(bo, nb, 1.8)
                            .bucket_times(bo, nb))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match(arch):
    assert dataclasses.asdict(t_get_config(arch)) == \
        dataclasses.asdict(get_config(arch))
    assert dataclasses.asdict(t_reduce(t_get_config(arch))) == \
        dataclasses.asdict(reduce_for_smoke(get_config(arch)))


def test_registry_and_config_for_shape_match():
    """The ten ids (the long-context variant kept out of them), the
    ``gemma2-2b-longctx`` entry and every (arch, shape) substitution."""
    assert sorted(T_ARCH_NAMES) == sorted(ARCH_NAMES) == sorted(ARCHS)
    assert dataclasses.asdict(t_get_config("gemma2-2b-longctx")) == \
        dataclasses.asdict(get_config("gemma2-2b-longctx"))
    assert [dataclasses.astuple(s) for s in T_SHAPES] == \
        [dataclasses.astuple(s) for s in SHAPES]
    for arch in ARCHS:
        for shape in SHAPES:
            assert dataclasses.asdict(t_config_for_shape(arch, shape.name)) \
                == dataclasses.asdict(config_for_shape(arch, shape.name))
    assert t_config_for_shape("gemma2-2b", "long_500k").name == \
        "gemma2-2b-longctx"


def test_recurrentgemma_smoke_cut():
    """One Griffin period (rglru, rglru, local_attn) at smoke widths."""
    cfg = t_reduce(t_get_config("recurrentgemma-9b"))
    assert [s.kind for s in cfg.layer_specs()] == ["rglru", "rglru",
                                                   "local_attn"]
    assert (cfg.n_layers, cfg.lru_width, cfg.n_heads, cfg.n_kv_heads,
            cfg.sliding_window, cfg.embedding_multiplier) == \
        (3, 256, 4, 1, 64, 16.0)


def test_rwkv6_smoke_cut():
    """A period-1 stack of rwkv blocks at smoke widths: the time-mix head
    size stays d_model // n_heads = 64 although head_dim is cut to 32."""
    cfg = t_reduce(t_get_config("rwkv6-1.6b"))
    assert [s.kind for s in cfg.layer_specs()] == ["rwkv", "rwkv"]
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
            cfg.d_ff, cfg.norm, cfg.tie_embeddings) == \
        (2, 256, 4, 32, 512, "layernorm", False)
    assert cfg.d_model // cfg.n_heads == 64


def test_rwkv6_leaves_outnumber_the_formula():
    """The planner buckets real leaves: rwkv6-1.6b has 1,499,107,328
    parameters as leaves, 19,171,328 more than ``total_params()``, whose
    time-mix formula leaves out the ddlerp and decay adapters."""
    cfg = t_get_config("rwkv6-1.6b")
    n = sum(x.numel() for x in tree_leaves(init_params(cfg, device="meta")))
    assert n == 1_499_107_328
    assert n - cfg.total_params() == 19_171_328


def test_rwkv6_full_schedule_matches_jax():
    """The rwkv6-1.6b cell's plan (batch 1, sequence 8192, partition
    200,000, coverage rate 1.8) over the real leaves: 14 buckets, period 4,
    3 updates a period, merged batch sizes (1, 2, 1), rotation on — the
    same from both planners."""
    kw = dict(dp=1, seq_len=8192, per_device_batch=1,
              partition_elems=200_000, coverage_rate=1.8)
    cfg, tcfg = get_config("rwkv6-1.6b"), t_get_config("rwkv6-1.6b")
    jp = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    jb, jnb, _, jplan = jax_build_schedule(jp, cfg, **kw)
    tb, tnb, _, tplan = build_schedule(init_params(tcfg, device="meta"),
                                       tcfg, **kw)
    assert (tb, tnb) == (jb, jnb)
    ts = tplan.schedule
    assert _phases(ts) == _phases(jplan.schedule)
    assert (tnb, ts.period, ts.updates_per_period,
            tuple(ts.batch_size_sequence)) == (14, 4, 3, (1, 2, 1))
    assert any(ph.rotate for ph in ts.phases)


def _phases(schedule):
    return [dataclasses.astuple(p) for p in schedule.phases]


@pytest.mark.parametrize("arch,dp,part,cr", [
    ("gemma2-2b", 1, 120_000, 1.8),
    ("gemma2-2b", 2, 200_000, 1.8),
    ("qwen3-4b", 1, 150_000, 0.5),
    ("qwen3-4b", 4, 150_000, 2.5),
])
def test_build_schedule_matches_jax(arch, dp, part, cr):
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = t_reduce(t_get_config(arch))
    jp = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    kw = dict(dp=dp, seq_len=64, per_device_batch=2, partition_elems=part,
              coverage_rate=cr)
    jb, jnb, jt, jplan = jax_build_schedule(jp, cfg, **kw)
    tb, tnb, tt, tplan = build_schedule(init_params(tcfg, device="meta"),
                                        tcfg, **kw)
    assert (tb, tnb) == (jb, jnb)
    assert dataclasses.astuple(tt) == dataclasses.astuple(jt)
    js, ts = jplan.schedule, tplan.schedule
    assert _phases(ts) == _phases(js)
    assert (ts.period, ts.updates_per_period, ts.batch_size_sequence) == \
        (js.period, js.updates_per_period, js.batch_size_sequence)
    assert tplan.verdict.ratio == jplan.verdict.ratio
    assert tplan.scheduler_cfg.capacity_factor == \
        jplan.scheduler_cfg.capacity_factor


def test_candidate_and_arch_planning_match_jax():
    """The simulator-scored candidates path and the analytic-profile
    (arch) path of Planner.plan agree between the copies."""
    jcfg, tcfg = get_config("gemma2-2b"), t_get_config("gemma2-2b")
    ja = JPlanner().plan(JPlanRequest(arch=jcfg, seq_len=2048))
    ta = Planner().plan(PlanRequest(arch=tcfg, seq_len=2048))
    assert _phases(ta.schedule) == _phases(ja.schedule)
    assert dataclasses.astuple(ta.times) == dataclasses.astuple(ja.times)
    cands_j = (("a", ja.times), ("b", dataclasses.replace(
        ja.times, comm=tuple(2 * c for c in ja.times.comm))))
    cands_t = (("a", ta.times), ("b", dataclasses.replace(
        ta.times, comm=tuple(2 * c for c in ta.times.comm))))
    jc = JPlanner().plan(JPlanRequest(candidates=cands_j))
    tc = Planner().plan(PlanRequest(candidates=cands_t))
    assert tc.winner_tag == jc.winner_tag
    assert _phases(tc.schedule) == _phases(jc.schedule)
