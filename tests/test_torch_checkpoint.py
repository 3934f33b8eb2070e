"""The port's checkpoints against the JAX package's format and resume.

* Keys and files: the port's ``encode`` of ``DeftRuntime.state_to_tree``
  has JAX's ``_flatten`` keys for the same state (replicated f32, sharded
  with the gather skip, a bf16sr master), its sidecar equals JAX's apart
  from ``treedef``, its layout descriptor equals JAX's, and every npz
  member's ``.npy`` bytes equal JAX's write of the same values (bf16
  leaves included: numpy's ``<V2``).  ``schedule_digest`` of the copied
  schedule equals JAX's.
* Cross-package, both ways (f32 replicated, sharded with the gather
  skip): JAX writes (``state_to_tree`` + ``save`` +
  ``save_layout_descriptor``) and the port's ``restore_runtime_state``
  reads, then the port writes (``save_checkpoint``) and JAX's reads; each
  read-back state equals the written arrays bitwise (params, m, v, step,
  cur, fut, pgather) and resumes at the same cycle position.  A bf16sr
  state round-trips bitwise port to port.
* Mid-cycle resume: an uninterrupted ``train`` run equals, bitwise, the
  same run saved mid-cycle and resumed through ``restore_runtime_state``
  (replicated f32, sharded with the skip, streamed, the precision path),
  and a DDP baseline run resumed from its tree.
* Refused resumes: a schedule-digest mismatch restarts the cycle and
  drops the gather cache with JAX's warning (the same lines as JAX's
  restore of the same files); a truncated newest npz and a missing
  sidecar fall back to the previous step.
* A SIGUSR1 during a run checkpoints at the top of the next step and
  stops it; the previous handler is back, and the resumed run is bitwise
  the uninterrupted one.
"""
import json
import os
import signal
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config, reduce_for_smoke
from repro.core.precision import PrecisionPolicy as JaxPolicy
from repro.elastic.faults import truncate_checkpoint
from repro.launch.train import build_schedule as jax_build_schedule
from repro.launch.train import restore_runtime_state as jax_restore_state
from repro.models.model import init_params as jax_init_params
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro_torch.checkpoint import (
    decode,
    encode,
    latest_step,
    load_layout_descriptor,
    save,
    save_layout_descriptor,
    schedule_digest,
    valid_steps,
)
from repro_torch.checkpoint.checkpoint import load_arrays
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.core.precision import PrecisionPolicy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.train import (
    build_schedule,
    init_distributed,
    restore_runtime_state,
    save_checkpoint,
    train,
)
from repro_torch.models.model import init_params
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout, flatten_buckets
from repro_torch.train.runtime import DeftRuntime
from repro_torch.tree import tree_leaves

ARCH, B, S, PART, LR = "qwen3-4b", 2, 32, 250_000, 1e-3
CASES = ("f32", "sharded", "bf16sr")


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def setup():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), cfg))
    meta = init_params(tcfg, device="meta")
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    tb, tnb, _, tplan = build_schedule(
        meta, tcfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    return dict(cfg=cfg, tcfg=tcfg, jparams=jparams, meta=meta, jb=jb,
                jnb=jnb, jsched=jplan.schedule, tsched=tplan.schedule)


def _runtimes(su, case):
    """(JAX runtime, port runtime) of one case on the same layout and
    schedule."""
    nb = su["jnb"]
    jlay = jax_layout(su["jparams"], su["jb"], nb)
    lay = build_bucket_layout(su["meta"], su["jb"], nb)
    if case == "bf16sr":
        jlay = jlay.with_precision(JaxPolicy(wire=("f32",) * nb,
                                             master="bf16sr"))
        lay = lay.with_precision(PrecisionPolicy(wire=("f32",) * nb,
                                                 master="bf16sr"))
    sharded = case == "sharded"
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jr = jrt.DeftRuntime(su["cfg"], jax_adamw(LR), su["jsched"], jlay, mesh,
                         config=jrt.RuntimeConfig(fsdp=sharded))
    rt = DeftRuntime(su["tcfg"], adamw(LR), su["tsched"], lay, device="cpu",
                     fsdp=sharded)
    assert rt.gather_skip == jr.stats()["gather_skip"] == sharded
    return jr, rt, mesh


def _random_arrays(rt, seed):
    """Random values for every leaf of ``rt.checkpoint_struct()`` (as
    ``encode`` gives them), with the flat buffers' padded tails zero."""
    rng = np.random.default_rng(seed)
    lay = rt.layout
    out = {}
    for key, leaf in encode_struct(rt.checkpoint_struct()).items():
        shape, dtype = leaf
        if dtype == torch.int32:
            out[key] = np.asarray(7, np.int32)
            continue
        x = rng.standard_normal(shape).astype(np.float32)
        if key.startswith(("cur", "fut", "pgather")):
            b = int(key.split("[")[1].rstrip("]"))
            x[..., lay.sizes[b]:] = 0
        if dtype == torch.bfloat16:
            x = torch.from_numpy(x).bfloat16().view(torch.int16).numpy() \
                .view("V2")
        out[key] = x
    return out


def encode_struct(like):
    """{key: (shape, dtype)} of a meta-tensor tree, in ``encode``'s keys."""
    from repro_torch.checkpoint.checkpoint import _items

    return {k: (tuple(t.shape), t.dtype) for k, t in _items(like)}


def _jax_tree(jr, arrays):
    """JAX arrays for ``jr.checkpoint_struct()`` from the encoded dict (a
    2-byte void leaf is bf16 bits)."""
    struct = jr.checkpoint_struct()
    paths, treedef = jax.tree_util.tree_flatten_with_path(struct)
    leaves = []
    for path, _ in paths:
        a = arrays["/".join(jckpt._path_str(p) for p in path)]
        if a.dtype == np.dtype("V2"):
            a = a.view(np.int16).view(ml_dtypes.bfloat16)
        leaves.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _bits(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16 or a.dtype == np.dtype("V2"):
        return a.view(np.int16)
    return a


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("case", CASES)
def test_keys_sidecar_and_bytes_match_jax(group, setup, tmp_path, case):
    jr, rt, mesh = _runtimes(setup, case)
    arrays = _random_arrays(rt, seed=CASES.index(case))
    with jax.set_mesh(mesh):
        jtree = jr.state_to_tree(jr.tree_to_state(_jax_tree(jr, arrays)))
        jflat = jckpt._flatten(jtree)
        jpath = jckpt.save(str(tmp_path / "jax"), 3, jtree)
        jckpt.save_layout_descriptor(
            str(tmp_path / "jax"), 3, jr.layout, next_phase=1,
            digest=jckpt.schedule_digest(jr.schedule))
    tree = rt.state_to_tree(rt.tree_to_state(decode(arrays,
                                                    rt.checkpoint_struct(),
                                                    device="cpu")))
    got = encode(tree)
    assert sorted(got) == sorted(jflat) == sorted(arrays)
    for k, a in got.items():
        assert a.dtype == arrays[k].dtype, k
        assert np.array_equal(_bits(a), _bits(arrays[k])), k
        assert np.array_equal(_bits(a), _bits(jflat[k])), k
    path = save(str(tmp_path / "port"), 3, tree)
    save_layout_descriptor(str(tmp_path / "port"), 3, rt.layout,
                           next_phase=1,
                           digest=schedule_digest(rt.schedule))
    # the .npy members byte for byte (bf16 leaves as numpy's <V2)
    assert _members(path) == _members(jpath)
    if case == "bf16sr":
        heads = [v[:60] for k, v in _members(path).items()
                 if k.startswith("params/")]
        assert heads and all(b"'descr': '<V2'" in h for h in heads)
    side = {}
    for who in ("jax", "port"):
        with open(tmp_path / who / "ckpt_00000003.json") as f:
            meta = json.load(f)
        assert meta.pop("treedef")
        with open(tmp_path / who / "layout_00000003.json") as f:
            side[who] = (meta, json.load(f))
    assert side["port"] == side["jax"]
    # a bf16sr master round-trips bitwise through the port's files
    state, step = restore_runtime_state(rt, str(tmp_path / "jax"),
                                        setup["meta"], log=lambda s: None)
    assert step == 3
    back = encode(rt.state_to_tree(state))
    assert sorted(back) == sorted(encode_struct(rt.checkpoint_struct()))
    for k in back:
        assert np.array_equal(_bits(back[k]), _bits(arrays[k])), k


def test_schedule_digest_matches_jax(setup):
    assert schedule_digest(setup["tsched"]) == \
        jckpt.schedule_digest(setup["jsched"])
    for wire, master, cr in (("int8", "bf16sr", 7.2), ("auto", "f32", 4.0)):
        _, _, _, jp = jax_build_schedule(
            setup["jparams"], setup["cfg"], dp=1, seq_len=S,
            per_device_batch=B, partition_elems=PART, coverage_rate=cr,
            wire_precision=wire, master_dtype=master)
        _, _, _, tp = build_schedule(
            setup["meta"], setup["tcfg"], dp=1, seq_len=S,
            per_device_batch=B, partition_elems=PART, coverage_rate=cr,
            wire_precision=wire, master_dtype=master)
        assert schedule_digest(tp.schedule) == \
            jckpt.schedule_digest(jp.schedule)


def _check_state(rt, state, arrays):
    """The resident state holds exactly the written arrays."""
    lay = rt.layout
    t = lambda k: torch.from_numpy(arrays[k])
    order = list(encode_struct(rt.checkpoint_struct()))   # leaf order
    leaves = lambda name: [t(k) for k in order if k.startswith(name + "/")]
    for name, bufs in (("params", state["pbuf"]),
                       ("opt/m", state["opt"]["m"]),
                       ("opt/v", state["opt"]["v"])):
        for got, want in zip(bufs, flatten_buckets(lay, leaves(name))):
            assert torch.equal(got, want), name
    assert int(state["opt"]["step"]) == int(arrays["opt/step"])
    assert state["opt"]["step"].dtype == torch.int32
    for b in range(lay.n_buckets):
        for name in ("cur", "fut"):
            assert torch.equal(state[name][b], t(f"{name}/[{b}]")[0])
        if "pgather" in state:
            assert torch.equal(state["pgather"][b], t(f"pgather/[{b}]"))
        assert not state["gbuf"][b].any()


@pytest.mark.parametrize("case", ["f32", "sharded"])
def test_cross_package_both_ways(group, setup, tmp_path, case, capsys):
    jr, rt, mesh = _runtimes(setup, case)
    arrays = _random_arrays(rt, seed=10 + CASES.index(case))
    # JAX writes, the port reads
    d = str(tmp_path / "jax")
    with jax.set_mesh(mesh):
        jstate = jr.tree_to_state(_jax_tree(jr, arrays))
        jckpt.save(d, 5, jr.state_to_tree(jstate))
        jckpt.save_layout_descriptor(
            d, 5, jr.layout, next_phase=jr.phase_in_cycle(5),
            digest=jckpt.schedule_digest(jr.schedule))
    logs = []
    state, step = restore_runtime_state(rt, d, setup["meta"], log=logs.append)
    assert step == 5 and logs == ["resumed checkpoint step 5"]
    assert ("pgather" in state) == (case == "sharded")
    _check_state(rt, state, arrays)
    assert rt.phase_in_cycle(5) == 5 % rt.period
    # the port writes, JAX reads
    d2 = str(tmp_path / "port")
    rt.reset_cycle(1)            # a cycle begun at step 1: 5 is at 4 % period
    assert save_checkpoint(d2, 5, rt, state).endswith("ckpt_00000005.npz")
    written = load_arrays(d2, 5)
    assert sorted(written) == sorted(arrays)
    for k in written:
        assert np.array_equal(written[k], arrays[k]), k
    capsys.readouterr()
    with jax.set_mesh(mesh):
        jstate2, jstep = jax_restore_state(jr, d2, setup["jparams"])
        back = {k: np.asarray(v) for k, v in
                jckpt._flatten(jr.state_to_tree(jstate2)).items()}
    assert jstep == 5
    assert capsys.readouterr().out.strip() == "resumed checkpoint step 5"
    assert sorted(back) == sorted(arrays)
    for k in back:
        assert np.array_equal(back[k], arrays[k]), k
    assert jr.phase_in_cycle(5) == rt.phase_in_cycle(5) == (5 - 1) % rt.period


# ---------------------------------------------------------------------------
# Resume through the launcher
# ---------------------------------------------------------------------------
RUN = dict(batch=B, seq=S, device="cpu", partition_elems=PART,
           log=lambda s: None)
# case -> (train() options, steps before the save, steps in all)
RESUME = {
    "f32": ({}, 2, 5),
    "sharded": ({"fsdp": True}, 2, 5),
    "decoupled": ({"fsdp": True, "decoupled": True}, 2, 5),
    "precision": ({"fsdp": True, "wire_precision": "int8",
                   "master_dtype": "bf16sr", "compute_dtype": "bf16",
                   "coverage_rate": 7.2}, 3, 6),
    "ddp": ({"scheduler": "ddp"}, 2, 4),
}


def _final(res):
    """Every tensor of a run's final state (the DDP state is a tree)."""
    st = dict(res["state"])
    st.pop("gbuf", None)
    return [x.clone() for x in tree_leaves(st)]


@pytest.mark.parametrize("case", list(RESUME))
def test_mid_cycle_resume_is_bitwise(group, setup, tmp_path, case):
    kw, k, n = RESUME[case]
    whole = train(setup["tcfg"], steps=n, **RUN, **kw)
    d = str(tmp_path)
    first = train(setup["tcfg"], steps=k, ckpt=d, **RUN, **kw)
    rt = first["runtime"]
    assert latest_step(d) == k
    if rt is not None:
        assert rt.phase_in_cycle(k) != 0
        assert any(x.any() for x in first["state"]["cur"]
                   + first["state"]["fut"])
    if rt is not None and rt.gather_skip:
        # the resumed position reads the saved gather cache
        assert not rt.schedule.phases[rt.phase_in_cycle(k) - 1].do_update
        assert any(key.startswith("pgather") for key in load_arrays(d, k))
    logs = []
    rest = train(setup["tcfg"], steps=n - k, ckpt=d, resume=True,
                 **dict(RUN, log=logs.append), **kw)
    assert rest["start_step"] == k
    assert f"resumed checkpoint step {k}" in logs
    assert first["losses"] + rest["losses"] == whole["losses"]
    for a, b in zip(_final(rest), _final(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert latest_step(d) == n


def test_digest_mismatch_restarts_cycle(group, setup, tmp_path, capsys):
    """Saved mid-cycle under the period-3 schedule, restored under another
    schedule over the same layout: the cycle restarts at the checkpoint
    step and the gather cache is cold, with the warning JAX prints for
    the same files and the port's own on the live accumulators."""
    d = str(tmp_path)
    train(setup["tcfg"], steps=2, ckpt=d, fsdp=True, **RUN)
    cr = 4.0
    _, _, _, tp = build_schedule(
        setup["meta"], setup["tcfg"], dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=cr)
    lay = build_bucket_layout(setup["meta"], setup["jb"], setup["jnb"])
    rt = DeftRuntime(setup["tcfg"], adamw(LR), tp.schedule, lay,
                     device="cpu", fsdp=True)
    assert rt.gather_skip
    assert schedule_digest(tp.schedule) != schedule_digest(setup["tsched"])
    logs = []
    state, step = restore_runtime_state(rt, d, setup["meta"], log=logs.append)
    assert step == 2 and rt.phase_in_cycle(2) == 0
    assert not any(p.any() for p in state["pgather"])
    assert logs[0].startswith("resume: WARNING schedule digest mismatch at "
                              "step 2 (saved ")
    # saved at position 2 of 3 with live accumulators: the port warns
    assert logs[1].startswith("resume: WARNING checkpoint step 2 was saved "
                              "at cycle position 2 with live accumulators")
    assert logs[2] == "resumed checkpoint step 2 (cycle restarted)"
    # JAX restores the same files under the same schedule alike
    cfg = setup["cfg"]
    _, _, _, jp = jax_build_schedule(
        setup["jparams"], cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=cr)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jr = jrt.DeftRuntime(cfg, jax_adamw(LR), jp.schedule,
                         jax_layout(setup["jparams"], setup["jb"],
                                    setup["jnb"]),
                         mesh, config=jrt.RuntimeConfig(fsdp=True))
    capsys.readouterr()
    with jax.set_mesh(mesh):
        jstate, jstep = jax_restore_state(jr, d, setup["jparams"])
    assert jstep == 2 and jr.phase_in_cycle(2) == 0
    # the same lines, without the port's own accumulator warning
    assert capsys.readouterr().out.splitlines() == [logs[0], logs[2]]
    for got, want in zip(state["pbuf"], jstate["pbuf"]):
        assert np.array_equal(got.numpy(), np.asarray(want))
    # step 2 now dispatches position 0, which gathers every bucket (the
    # old cycle's position 2 would have reused the cache)
    rt.step(2, state, make_batch(setup["tcfg"], 0, 2, B, S, device="cpu"))
    assert rt.last_collectives["param_gather"] == setup["jnb"]


def test_torn_and_uncommitted_checkpoints_fall_back(group, setup, tmp_path):
    d = str(tmp_path)
    train(setup["tcfg"], steps=3, ckpt=d, ckpt_every=1, **RUN)
    assert valid_steps(d) == [1, 2, 3]
    truncate_checkpoint(d, 3)                # a writer killed mid-save
    rt = train(setup["tcfg"], steps=0, **RUN)["runtime"]
    logs = []
    state, step = restore_runtime_state(rt, d, setup["meta"], log=logs.append)
    assert step == 2 and logs == ["resumed checkpoint step 2"]
    os.remove(os.path.join(d, "ckpt_00000002.json"))   # never committed
    assert latest_step(d) == 1
    state, step = restore_runtime_state(rt, d, setup["meta"], log=logs.append)
    assert step == 1
    # no staging leftovers either way
    assert not [f for f in os.listdir(d) if f.startswith(".ckpt_")]
    # the descriptor rebuilds the layout the checkpoint was written under
    assert load_layout_descriptor(d, 1, setup["meta"])[0] == rt.layout


def test_preemption_signal_checkpoints_and_stops(group, setup, tmp_path):
    d, before = str(tmp_path), signal.getsignal(signal.SIGUSR1)

    def preempt(step, *_):
        if step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)

    logs = []
    cut = train(setup["tcfg"], steps=5, ckpt=d, on_step=preempt,
                **dict(RUN, log=logs.append))
    assert cut["halted"] and len(cut["losses"]) == 2
    assert valid_steps(d) == [2]
    assert f"preemption signal {int(signal.SIGUSR1)}: checkpointing and " \
        f"exiting cleanly" in logs
    assert signal.getsignal(signal.SIGUSR1) is before
    rest = train(setup["tcfg"], steps=3, ckpt=d, resume=True, **RUN)
    whole = train(setup["tcfg"], steps=5, **RUN)
    assert cut["losses"] + rest["losses"] == whole["losses"]
