"""Port parity of the encoder-decoder and cross-attention families against
the JAX package, on the same numpy params, tokens and stub memory.

* Loss and every gradient leaf of ``loss_fn`` against ``jax.value_and_grad``
  of JAX's (rtol 1e-4, atol 1e-5, tests/test_torch_model.py's limits), with
  the param tree's paths and stacked shapes equal to JAX's:
  seamless-m4t-large-v2 smoke (2 encoder and 2 decoder layers, 16 frames),
  llama-3.2-vision-90b at 5 layers (one whole pattern period, so one gated
  cross block; 3 layers hold none) with its gate opened to 0.5 (at 0,
  ``tanh(0)`` zeroes the block and every cross weight's gradient), and the
  two dense configs starcoder2-7b (window 64 < seq 96) and deepseek-7b.
  seamless's ungated ``cross.gate`` gets gradient exactly 0 in both.
* The modules alone against JAX: ``encode``, ``apply_cross_attention``
  gated and ungated (Sq 48 against 16 memory positions, a softcap on the
  gated case), ``cross_kv`` with ``use_qk_norm`` on.
* ``DeftRuntime`` on seamless smoke over two periods against JAX's
  (tests/test_torch_runtime.py's atol 1e-4); the unused gate stays 0.
  The sharded engine at one shard and the streamed one are bitwise that
  replicated run, and the streamed census touches the encoder's buckets
  first (the encoder runs before the decoder's embedding lookup).
* The DDP step against JAX's: the unused gate's gradient is 0 and it is
  unmoved.
* ``launch.train.train`` at 2 spawned gloo ranks equals one rank over the
  whole batch (the memory splits with the tokens).
* ``make_batch``: the text batches' digest is pinned from before the stub
  memory existed; ``memory`` is f32 [B, M, d], N(0, 0.02^2), a pure
  function of ``(seed, step)`` that leaves the tokens as they are.
* A checkpoint of a seamless smoke state is JAX's byte for byte (keys
  ``encoder/...`` and ``.../cross/...`` included).
"""
import dataclasses
import hashlib
import multiprocessing as mp
import os
import socket
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config, reduce_for_smoke
from repro.launch.train import build_schedule as jax_build_schedule
from repro.models import attention as jattn
from repro.models.model import encode as jax_encode
from repro.models.model import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim.optimizers import adamw as jax_adamw
from repro.train import runtime as jrt
from repro.train.bucketing import build_bucket_layout as jax_layout
from repro.train.steps import init_train_state as jax_init_train_state
from repro_torch.checkpoint import decode, encode, save
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.train import build_schedule, init_distributed, train
from repro_torch.models import attention as tattn
from repro_torch.models.model import encode as t_encode
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.optimizers import adamw
from repro_torch.train.bucketing import build_bucket_layout
from repro_torch.train.runtime import (
    DeftRuntime,
    init_ddp_state,
    make_ddp_step,
    phase_collectives,
)
from repro_torch.tree import tree_flatten_with_path, tree_leaves

RTOL, ATOL = 1e-4, 1e-5
PARAM_ATOL = 1e-4                 # tests/test_torch_runtime.py's
ENCDEC = "seamless-m4t-large-v2"
B, S, PART, LR = 2, 48, 300_000, 1e-3


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree):
    return ["/".join(p) for p, _ in tree_flatten_with_path(tree)]


def _batches(tcfg, n, batch=B, seq=S):
    """(port batches, JAX batches) of the port's numpy stream."""
    port = [make_batch(tcfg, 0, i, batch, seq, device="cpu") for i in range(n)]
    as_jax = lambda bt: {k: jnp.asarray(v.numpy().astype(np.int32)
                                        if k != "memory" else v.numpy())
                         for k, v in bt.items()}
    return port, [as_jax(bt) for bt in port]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
# The 5-layer VLM's embedding-table gradient (the Zipf tokens repeat, so
# a row sums many occurrences that largely cancel) reads 120 of its 131,072
# elements beyond atol 1e-5 + rtol 1e-4, all within 1e-4.  That is f32
# summation noise on both sides: against JAX's loss_fn in float64 (x64 on,
# its own init draw), the port's f32 gradient had 52 elements beyond those
# limits and JAX's jitted f32 one 154.  So that one leaf allows 0.2% of its
# elements up to 10 x atol.
VLM_MAX_OVER = 0.002
LEAF_ATOL = 1e-3
# (arch, layers, seq, gate): the VLM's gate opened so the cross block counts
MODEL_CASES = [
    pytest.param(ENCDEC, 2, 48, None, id="seamless"),
    pytest.param("llama-3.2-vision-90b", 5, 48, 0.5, id="vlm-5layers"),
    pytest.param("starcoder2-7b", 2, 96, None, id="starcoder2"),
    pytest.param("deepseek-7b", 2, 48, None, id="deepseek"),
]


@pytest.mark.parametrize("arch,n_layers,seq,gate", MODEL_CASES)
def test_loss_and_grads_match_jax(arch, n_layers, seq, gate):
    """Every gradient leaf within rtol 1e-4 / atol 1e-5 (tighter for a leaf
    of small gradients, LEAF_ATOL), but for a share VLM_MAX_OVER of the
    VLM's embedding table, held to atol 1e-4."""
    cfg = reduce_for_smoke(get_config(arch), n_layers)
    tcfg = t_reduce(t_get_config(arch), n_layers)
    params_np = _np(jax_init_params(jax.random.PRNGKey(0), cfg))
    if gate is not None:
        params_np = jax.tree_util.tree_map_with_path(
            lambda p, x: np.full_like(x, gate)
            if getattr(p[-1], "key", None) == "gate" else x, params_np)
    tp = init_params(tcfg, seed=1, device="cpu")
    assert _paths(tp) == _paths(params_np)
    assert [tuple(x.shape) for x in tree_leaves(tp)] == \
        [x.shape for x in jax.tree.leaves(params_np)]
    (bt,), (jbt,) = _batches(tcfg, 1, seq=seq)
    assert ("memory" in bt) == (cfg.modality != "text")
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, cfg, jbt), has_aux=True))(params_np)
    params = params_from_numpy(params_np, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    loss, parts = loss_fn(params, tcfg, bt)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL, atol=ATOL)
    assert float(parts["aux"]) == 0.0
    got = tree_flatten_with_path(params)
    want = jax.tree.leaves(_np(jgrads))
    assert len(got) == len(want)
    unused = []
    n_over = 0
    for (path, p), g in zip(got, want):
        name = "/".join(path)
        if p.grad is None:           # a leaf the loss never reads
            unused.append(name)
        tg = p.grad.numpy() if p.grad is not None else np.zeros_like(g)
        if gate is not None and name == "embed/table":
            n_over += int(np.sum(np.abs(tg - g) > ATOL + RTOL * np.abs(g)))
            np.testing.assert_allclose(tg, g, rtol=RTOL, atol=10 * ATOL,
                                       err_msg=name)
            continue
        # a leaf whose gradient is small (the VLM's cross block reads the
        # 0.02-scale memory: its wq/wk gradients are ~1e-6) is held to a
        # thousandth of its own largest element instead
        atol = min(ATOL, LEAF_ATOL * float(np.abs(g).max()))
        np.testing.assert_allclose(tg, g, rtol=RTOL, atol=atol, err_msg=name)
    assert n_over <= VLM_MAX_OVER * params["embed"]["table"].numel(), n_over
    grads = dict(zip(_paths(params), want))
    # only the enc-dec block's ungated cross.gate is never read: JAX
    # gives it gradient 0
    assert unused == (["stack/0/cross/gate"] if arch == ENCDEC else [])
    if arch == ENCDEC:
        # the encoder's leaves get a gradient through the decoder's
        # cross-attention
        assert all(np.abs(g).max() > 0 for k, g in grads.items()
                   if k.startswith("encoder/"))
        assert not np.any(grads["stack/0/cross/gate"])
    if gate is not None:
        assert [s.kind for s in tcfg.layer_specs()][-1] == "cross_attn"
        for w in ("wq", "wk", "wv", "wo", "gate"):
            assert np.abs(grads[f"stack/4/mixer/{w}"]).max() > 0, w


def test_vlm_default_smoke_cut_has_no_cross_block():
    """reduce_for_smoke's 3 layers leave the VLM's period-5 pattern no
    whole period: a tail of three attn layers and no cross block."""
    tcfg = t_reduce(t_get_config("llama-3.2-vision-90b"))
    assert [s.kind for s in tcfg.layer_specs()] == ["attn"] * 3
    assert "cross" not in str(_paths(init_params(tcfg, device="meta")))


def _module_case(name):
    cfg = reduce_for_smoke(get_config(ENCDEC))
    if name == "cross_kv_qk_norm":
        cfg = dataclasses.replace(cfg, use_qk_norm=True)
    if name == "cross_gated":
        cfg = dataclasses.replace(cfg, attn_logit_softcap=30.0)
    rng = np.random.default_rng(5)
    p = _np(jattn.init_cross_attention(jax.random.PRNGKey(2), cfg))
    p = {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.5
             if k in ("gate", "q_norm", "k_norm") else v)
         for k, v in p.items()}
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, cfg.n_modal_tokens,
                               cfg.d_model)).astype(np.float32)
    return cfg, p, x, mem


@pytest.mark.parametrize("name", ["encode", "cross", "cross_gated",
                                  "cross_kv_qk_norm"])
def test_modules_match_jax(name):
    """Outputs within rtol 1e-4 / atol 1e-5, and the gradients of a random
    projection of them w.r.t. every input and param too."""
    if name == "encode":
        cfg = reduce_for_smoke(get_config(ENCDEC))
        tcfg = t_reduce(t_get_config(ENCDEC))
        p = _np(jax_init_params(jax.random.PRNGKey(3), cfg))
        mem = np.random.default_rng(6).standard_normal(
            (B, cfg.n_modal_tokens, cfg.d_model)).astype(np.float32)
        args = ({"encoder": p["encoder"]}, mem)
        jfn = lambda p, m: jax_encode(p, cfg, m)
        tfn = lambda p, m: t_encode(p, tcfg, m)
    else:
        cfg, p, x, mem = _module_case(name)
        # only the params the module reads: each gets a gradient
        if name == "cross_kv_qk_norm":
            args = ({k: p[k] for k in ("wk", "wv", "k_norm")}, mem)
            jfn = lambda p, m: jnp.concatenate(jattn.cross_kv(p, m, cfg), -1)
            tfn = lambda p, m: torch.cat(tattn.cross_kv(p, m, cfg), -1)
        else:
            gated = name == "cross_gated"
            if not gated:
                del p["gate"]
            args = (p, x, mem)
            jfn = lambda p, x, m: jattn.apply_cross_attention(
                p, x, jattn.cross_kv(p, m, cfg), cfg=cfg, gated=gated)
            tfn = lambda p, x, m: tattn.apply_cross_attention(
                p, x, tattn.cross_kv(p, m, cfg), cfg=cfg, gated=gated)
    jout = np.asarray(jax.jit(jfn)(*args))
    w = np.random.default_rng(7).standard_normal(jout.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * w),
                              argnums=tuple(range(len(args)))))(*args)
    targs = params_from_numpy(args, device="cpu")
    for t in tree_leaves(targs):
        t.requires_grad_(True)
    out = tfn(*targs)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL,
                               atol=ATOL)
    torch.sum(out * torch.from_numpy(w)).backward()
    for t, g in zip(tree_leaves(targs), jax.tree.leaves(_np(jgrads))):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def plan():
    cfg = reduce_for_smoke(get_config(ENCDEC))
    tcfg = t_reduce(t_get_config(ENCDEC))
    jparams = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0),
                                                     cfg))
    jb, jnb, _, jplan = jax_build_schedule(
        jparams, cfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    meta = init_params(tcfg, device="meta")
    tb, tnb, _, tplan = build_schedule(
        meta, tcfg, dp=1, seq_len=S, per_device_batch=B,
        partition_elems=PART, coverage_rate=1.8)
    assert (tb, tnb) == (jb, jnb)
    sched = tplan.schedule
    # a delayed-update schedule: merged updates
    assert max(sched.batch_size_sequence) > 1
    params = _np(jax_init_params(jax.random.PRNGKey(0), cfg))
    return dict(cfg=cfg, tcfg=tcfg, jparams=jparams, meta=meta, jb=jb,
                jnb=jnb, jsched=jplan.schedule, sched=sched, params=params)


def _gates(tree):
    return [x for p, x in zip(_paths(tree), tree_leaves(tree))
            if p.endswith("cross/gate")]


def _port_run(su, n_steps, **kw):
    layout = build_bucket_layout(su["meta"], su["jb"], su["jnb"])
    rt = DeftRuntime(su["tcfg"], adamw(LR), su["sched"], layout,
                     device="cpu", **kw)
    state = rt.state_from_params(params_from_numpy(su["params"],
                                                   device="cpu"))
    losses = []
    for i, bt in enumerate(_batches(su["tcfg"], n_steps)[0]):
        state, m = rt.step(i, state, bt)
        losses.append(float(m["loss"]))
    return rt, state, losses


def test_encdec_runtime_matches_jax_over_two_periods(group, single_mesh,
                                                     plan):
    su = plan
    sched, jsched = su["sched"], su["jsched"]
    n_steps = 2 * sched.period
    _, jbatches = _batches(su["tcfg"], n_steps)
    with single_mesh:
        jr = jrt.DeftRuntime(su["cfg"], jax_adamw(LR), jsched,
                             jax_layout(su["jparams"], su["jb"], su["jnb"]),
                             single_mesh)
        jstate = jr.init_state(jax.random.PRNGKey(0))   # su["params"]
        jlosses = []
        for i, bt in enumerate(jbatches):
            jstate, m = jr.step(i, jstate, bt)
            jlosses.append(float(m["loss"]))
        jfinal = _np(jr.params_tree(jstate))
    rt, state, losses = _port_run(su, n_steps)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for i in range(n_steps):
        assert phase_collectives(sched.phases[i % sched.period]) == \
            jrt.phase_collectives(jsched.phases[i % jsched.period])
    final = rt.params_tree(state)
    for a, b in zip(tree_leaves(final), jax.tree.leaves(jfinal)):
        np.testing.assert_allclose(a.numpy(), b, atol=PARAM_ATOL, rtol=0)
    # the enc-dec block's gate is never read: it stays 0 in both
    gates = _gates(final)
    assert gates and all(not g.any() for g in gates)
    assert all(not np.any(g) for p, g in zip(_paths(jfinal),
                                             jax.tree.leaves(jfinal))
               if p.endswith("cross/gate"))


def test_encdec_sharded_and_streamed_are_bitwise_burst(group, plan):
    """One shard with the gather skip, and the same streamed, against the
    replicated run: every loss and param bitwise; the streamed census
    touches the encoder's buckets before the embedding's."""
    su = plan
    n = su["sched"].period + 1
    _, base, lb = _port_run(su, n)
    for kw in (dict(fsdp=True), dict(fsdp=True, decoupled=True)):
        rt, state, losses = _port_run(su, n, **kw)
        assert losses == lb, kw
        for a, b in zip(state["pbuf"], base["pbuf"]):
            assert torch.equal(a, b), kw
    touched = rt.last_stream["touched"]
    lay = rt.layout
    paths = _paths(su["meta"])
    enc = sorted({lay.bucket_of_leaf[i] for i, p in enumerate(paths)
                  if p.startswith("encoder/stack/")})
    # the encoder's leaves fill buckets in ascending order, and the
    # embedding's bucket comes after them unless it shares one
    assert list(touched[:len(enc)]) == enc
    emb = lay.bucket_of_leaf[paths.index("embed/table")]
    assert emb in enc or touched.index(emb) >= len(enc)
    assert sorted(touched) == list(range(lay.n_buckets))


def test_encdec_ddp_step_matches_jax(group, single_mesh, plan):
    su = plan
    opt = jax_adamw(LR)
    port_batches, jbatches = _batches(su["tcfg"], 2)
    with single_mesh:
        jstate = jax_init_train_state(jax.random.PRNGKey(0), su["cfg"], opt)
        params = _np(jstate["params"])
        step = jrt.make_ddp_step(su["cfg"], opt, donate=False)
        for bt in jbatches:
            jstate, jm = step(jstate, bt)
    state = init_ddp_state(su["tcfg"], adamw(LR),
                           params=params_from_numpy(params, device="cpu"))
    tstep = make_ddp_step(su["tcfg"], adamw(LR))
    for bt in port_batches:
        state, m = tstep(state, bt)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    for a, b in zip(tree_leaves(state["params"]),
                    jax.tree.leaves(_np(jstate["params"]))):
        np.testing.assert_allclose(a.numpy(), b, atol=PARAM_ATOL, rtol=0)
    gates = _gates(state["params"])
    assert gates and all(not g.any() for g in gates)
    assert all(not g.any() for g in _gates(state["opt"]["m"]))


def _launch():
    """``train`` on seamless smoke over a global batch of 4 (this rank's
    slice), on the schedule planned for two ranks whatever the world;
    returns the final params then the losses."""
    cfg = t_reduce(t_get_config(ENCDEC))
    two = build_schedule(init_params(cfg, device="meta"), cfg, dp=2,
                         seq_len=32, per_device_batch=2, partition_elems=PART,
                         coverage_rate=1.8)[3].schedule
    res = train(cfg, steps=6, batch=4, seq=32, partition_elems=PART,
                device="cpu", reroute=lambda schedule, times: (two, None),
                log=lambda s: None)
    assert res["schedule"] is two
    rt, state = res["runtime"], res["state"]
    out = [p.numpy().copy() for p in tree_leaves(rt.params_tree(state))]
    return out + [np.array(res["losses"])]


def _launch_rank(rank, world, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 *_launch())
    finally:
        dist.destroy_process_group()


def test_launcher_two_gloo_ranks_equal_one_rank(group, tmp_path):
    """Each rank takes half of every global batch, ``memory`` included:
    the two ranks end where one rank over the whole batch does."""
    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_launch_rank, args=(r, 2, port,
                                                    str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    one = _launch()
    for p in procs:
        p.join(timeout=240)
        assert not p.is_alive() and p.exitcode == 0
    for r in range(2):
        f = np.load(tmp_path / f"rank{r}.npz")
        two = [f[f"arr_{i}"] for i in range(len(f.files))]
        assert len(two) == len(one)
        np.testing.assert_allclose(two[-1], one[-1], rtol=1e-5)  # losses
        for a, b in zip(two[:-1], one[:-1]):
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the batches
# ---------------------------------------------------------------------------
# sha256 of gemma2-2b's int64 tokens, taken before the stub memory existed:
# (seed, step, batch, seq) -> digest
TEXT_DIGESTS = {
    (0, 0, 2, 64): "33d2f078af690fa0ff71a3f811325eabed1b38d32fb9eb3dd356e389d5d030d9",
    (0, 7, 1, 96): "de25a322d479c7c4ee48980260bc234b8b0a7d4db31ba925b0c4d1e7e538d49c",
    (3, 2, 4, 32): "26f2c98c951806d462c233561a6f97868a2f52c643de886713f251d9eaa10e7d",
}


@pytest.mark.parametrize("key", sorted(TEXT_DIGESTS))
def test_text_batches_unchanged(key):
    seed, step, b, s = key
    bt = make_batch(t_get_config("gemma2-2b"), seed, step, b, s, device="cpu")
    assert sorted(bt) == ["labels", "tokens"]
    assert hashlib.sha256(bt["tokens"].numpy().tobytes()).hexdigest() == \
        TEXT_DIGESTS[key]


@pytest.mark.parametrize("arch", [ENCDEC, "llama-3.2-vision-90b"])
def test_stub_memory(arch):
    cfg = t_reduce(t_get_config(arch))
    bt = make_batch(cfg, 4, 3, 3, 16, device="cpu")
    mem = bt["memory"]
    assert mem.dtype == torch.float32
    assert tuple(mem.shape) == (3, cfg.n_modal_tokens, cfg.d_model)
    assert abs(float(mem.std()) - 0.02) < 0.002
    assert abs(float(mem.mean())) < 0.002
    again = make_batch(cfg, 4, 3, 3, 16, device="cpu")
    assert torch.equal(again["memory"], mem)
    for other in ((4, 4), (5, 3)):
        assert not torch.equal(
            make_batch(cfg, *other, 3, 16, device="cpu")["memory"], mem)
    # the memory's stream leaves the tokens as a text config draws them
    text = make_batch(dataclasses.replace(cfg, modality="text"), 4, 3, 3, 16,
                      device="cpu")
    assert sorted(text) == ["labels", "tokens"]
    assert torch.equal(text["tokens"], bt["tokens"])


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------
def _members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_encdec_checkpoint_is_jax_byte_for_byte(group, single_mesh, plan,
                                                tmp_path):
    """A seamless smoke state after a few steps, saved by either package:
    the same keys and the same npz members, byte for byte."""
    su = plan
    rt, state, _ = _port_run(su, 2)
    tree = rt.state_to_tree(state)
    arrays = encode(tree)
    assert any(k.startswith("params/encoder/stack/") for k in arrays)
    assert any("/cross/" in k for k in arrays)
    path = save(str(tmp_path / "port"), 2, tree)
    with single_mesh:
        jr = jrt.DeftRuntime(su["cfg"], jax_adamw(LR), su["jsched"],
                             jax_layout(su["jparams"], su["jb"], su["jnb"]),
                             single_mesh)
        struct = jr.checkpoint_struct()
        paths, treedef = jax.tree_util.tree_flatten_with_path(struct)
        jtree = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(arrays["/".join(jckpt._path_str(p) for p in pth)])
            for pth, _ in paths])
        jtree = jr.state_to_tree(jr.tree_to_state(jtree))
        assert sorted(jckpt._flatten(jtree)) == sorted(arrays)
        jpath = jckpt.save(str(tmp_path / "jax"), 2, jtree)
    assert _members(path) == _members(jpath)
    back = encode(rt.state_to_tree(rt.tree_to_state(
        decode(arrays, rt.checkpoint_struct(), device="cpu"))))
    for k, a in arrays.items():
        assert np.array_equal(back[k], a), k
