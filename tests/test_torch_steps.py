"""Port parity of the per-leaf train steps (``repro_torch.train.steps``)
against the JAX package's ``train/steps.py``, on the tiny qwen3 of
``tests/_torch_tiny.py`` fed the same numpy batches:

* ``make_deft_step_fns`` over two periods at coverage rate 1.8 (period 3,
  a delayed update of k 3 after a rotation) against JAX's: every loss and
  every param within rtol 1e-4 / atol 1e-5, and each phase's collectives
  equal to one a synced leaf plus one a metric (the loss and each part);
* the per-leaf steps of both packages against a hand replay of the
  gradient-accumulation reference in each package's own ops (JAX's
  ``test_train_steps.py`` replay), within its 5e-5 after every step, at
  coverage rate 1.8 and, for the port alone, at 0.5 (every bucket on the
  secondary link);
* the DDP baseline with ``microbatch=2`` against JAX's ``ddp_train_step
  (microbatch=2)`` and against the port's ``microbatch=1``;
* ``apply_updates_`` bitwise ``apply_updates`` (AdamW and SGD, f32 and bf16
  params), and both against JAX's ``apply_updates`` on bf16 params;
* ``deft_rs_phase_step`` refused, naming ROADMAP item 8.

Two JAX step sets are compiled (the per-leaf steps and the DDP step), and
one JAX gradient and update function; the params and batches are the
port's (``_torch_tiny.drawn_tiny``), fed to both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
import _torch_tiny as T
from repro.optim.optimizers import adamw as jax_adamw
from repro.optim.optimizers import apply_updates as jax_apply_updates
from repro.optim.optimizers import init_opt_state as jax_init_opt_state
from repro.optim.optimizers import sgd_momentum as jax_sgd
from repro.train.steps import ddp_train_step as jax_ddp_train_step
from repro.train.steps import make_deft_step_fns as jax_make_deft_step_fns
from repro_torch.launch.train import init_distributed
from repro_torch.models.model import loss_fn
from repro_torch.optim.optimizers import (
    adamw,
    apply_updates,
    apply_updates_,
    init_opt_state,
    sgd_momentum,
)
from repro_torch.train.runtime import init_ddp_state, make_ddp_step
from repro_torch.train.steps import (
    deft_rs_phase_step,
    init_train_state,
    make_deft_step_fns,
    phase_collectives_per_leaf,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

LR = T.LR
PE_DELAYED, PE_SECONDARY = 40_000, 20_000     # period 3 at CR 1.8; 1 at 0.5
RTOL, ATOL = 1e-4, 1e-5
REPLAY_TOL = 5e-5                             # JAX's test_train_steps.py:118


@pytest.fixture(scope="module")
def group():
    init_distributed(torch.device("cpu"))


@pytest.fixture(scope="module")
def tiny():
    return T.drawn_tiny(6)


@pytest.fixture(scope="module")
def delayed(tiny):
    """(bucket_of, schedule) at coverage rate 1.8."""
    bo, nb, _, sched, _ = T.plan(tiny, PE_DELAYED, 1.8)
    assert max(p.update_k for p in sched.phases) > 1 and sched.period > 1
    assert any(p.rotate for p in sched.phases)
    return bo, sched


def _jax_phases(sched):
    """The port's schedule as the JAX package's ``PhaseSpec`` tuple."""
    from repro.core.scheduler import PhaseSpec

    return tuple(PhaseSpec(**p.__dict__) for p in sched.phases)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def jax_per_leaf(tiny, delayed, single_mesh):
    """JAX's per-leaf steps over two periods: losses and every step's
    params (numpy leaves)."""
    bo, sched = delayed
    opt = jax_adamw(LR)
    params = jax.tree.map(jnp.asarray, tiny.jparams)
    zeros = lambda: jax.tree.map(lambda p: jnp.zeros((1,) + p.shape), params)
    state = {"params": params, "opt": jax_init_opt_state(opt, params),
             "cur": zeros(), "fut": zeros()}
    losses, params = [], []
    with single_mesh:
        fns = jax_make_deft_step_fns(
            tiny.cfg, opt, type("S", (), {"phases": _jax_phases(sched)}),
            bo, single_mesh)
        for i in range(2 * sched.period):
            state, m = fns[i % sched.period](state, T.jb(tiny, i))
            assert bool(m["updated"]) == sched.phases[i % sched.period] \
                .do_update
            losses.append(float(m["loss"]))
            params.append(_np(state["params"]))
    return losses, params


def _port_per_leaf(tiny, bo, sched, n_steps, hook=None):
    """The port's per-leaf steps from the shared params; ``hook(i, fn, state,
    metrics)`` after each step.  Returns (losses, final params)."""
    fns = make_deft_step_fns(tiny.tcfg, adamw(LR), sched, bo)
    # one callable per distinct phase, shared by the positions repeating it
    assert len({id(f) for f in fns}) == len(set(sched.phases))
    state = init_train_state(tiny.tcfg, adamw(LR), deft=True,
                             params=tiny.params, device="cpu")
    losses = []
    for i in range(n_steps):
        fn = fns[i % sched.period]
        state, m = fn(state, T.tb(tiny, i))
        losses.append(float(m["loss"]))
        if hook is not None:
            hook(i, fn, state, m)
    return losses, state


def test_per_leaf_steps_match_jax(group, tiny, delayed, jax_per_leaf):
    """Two periods against JAX's per-leaf steps; every phase issues one
    collective a synced leaf and one a metric."""
    bo, sched = delayed
    jlosses, jparams = jax_per_leaf

    def hook(i, fn, state, m):
        ph = fn.phase
        synced = sum(1 for b in bo if (ph.rotate and ph.route_new[b] == "sync")
                     or ph.sync_cur[b])
        n_parts = len([k for k in m if k not in ("loss", "updated", "k")])
        assert n_parts == 2                     # ce, aux
        assert fn.last_collectives == phase_collectives_per_leaf(
            ph, bo, n_parts)
        assert sum(fn.last_collectives.values()) == synced + 1 + n_parts
        assert m["updated"] == ph.do_update and m["k"] == ph.update_k
        np.testing.assert_allclose(float(m["loss"]), jlosses[i], rtol=RTOL,
                                   atol=ATOL)

    losses, state = _port_per_leaf(tiny, bo, sched, 2 * sched.period, hook)
    assert int(state["opt"]["step"]) == 2 * sched.updates_per_period
    for a, b in zip(tree_leaves(state["params"]), jparams[-1]):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL, atol=ATOL)
    # this rank's own accumulators, shaped as the params
    assert [tuple(c.shape) for c in tree_leaves(state["cur"])] == \
        [tuple(p.shape) for p in tree_leaves(state["params"])]


class _Replay:
    """The gradient-accumulation reference of JAX's ``test_train_steps.py``:
    PhaseSpec semantics replayed on whole gradient trees, in one
    package's ops (``grad(params, batch)`` -> leaves, ``apply(params,
    grads, opt, scale)`` -> (params, opt), on leaf lists)."""

    def __init__(self, params, opt_state, grad, apply):
        self.params, self.opt = params, opt_state
        self.grad, self.apply = grad, apply
        self.cur = [p * 0 for p in params]
        self.fut = [p * 0 for p in params]

    def step(self, ph, batch):
        g = self.grad(self.params, batch)
        if ph.rotate:
            gen = [a + b for a, b in zip(g, self.fut)]
            self.fut = [f * 0 for f in self.fut]
        else:
            self.fut = [f + a for f, a in zip(self.fut, g)]
            gen = None
        if ph.do_update:
            src = self.cur if ph.update_source == "cur" else gen
            self.params, self.opt = self.apply(self.params, src, self.opt,
                                               1.0 / ph.update_k)
            self.cur = gen if ph.update_source == "cur" else \
                [c * 0 for c in self.cur]
        elif ph.rotate:
            self.cur = gen


def _port_replay(tiny):
    struct = tiny.params

    def grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in params]
        loss, _ = loss_fn(tree_unflatten(struct, leaves), tiny.tcfg, batch)
        return list(torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True))

    def apply(params, grads, opt, scale):
        p, o = apply_updates(adamw(LR), tree_unflatten(struct, params),
                             tree_unflatten(struct, grads), opt,
                             grad_scale=scale)
        return tree_leaves(p), o

    params = [p.clone() for p in tree_leaves(tiny.params)]
    return _Replay(params, init_opt_state(adamw(LR), tiny.params), grad,
                   apply)


def _max_diff(got, want) -> float:
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
               for a, b in zip(got, want))


@pytest.mark.parametrize("cr", [0.5, 1.8])
def test_port_per_leaf_matches_accumulation_reference(group, tiny, cr):
    """The port's per-leaf steps against the replay in the port's ops after
    every step of two periods (at 0.5 every synced bucket rides the
    secondary link)."""
    bo, _, _, sched, _ = T.plan(tiny, PE_DELAYED if cr > 1 else PE_SECONDARY,
                                cr)
    if cr > 1:
        assert sched.updates_per_period < sched.period
    else:
        assert all(all(p.secondary) for p in sched.phases)
    ref = _port_replay(tiny)

    def hook(i, fn, state, m):
        ref.step(fn.phase, T.tb(tiny, i))
        diff = _max_diff([p.numpy() for p in tree_leaves(state["params"])],
                         [p.numpy() for p in ref.params])
        assert diff < REPLAY_TOL, f"step {i}: params diverge by {diff}"

    _port_per_leaf(tiny, bo, sched, 2 * sched.period, hook)


def test_jax_per_leaf_matches_accumulation_reference(tiny, delayed,
                                                     jax_per_leaf):
    """JAX's per-leaf steps of the parity test against the same replay in
    JAX's ops (a jitted ``jax.grad``, JAX's ``apply_updates``)."""
    from repro.models.model import loss_fn as jax_loss_fn

    bo, sched = delayed
    treedef = jax.tree.structure(tiny.jparams)
    opt = jax_adamw(LR)
    gfn = jax.jit(jax.grad(lambda p, b: jax_loss_fn(p, tiny.cfg, b)[0]))

    def grad(params, batch):
        return jax.tree.leaves(gfn(jax.tree.unflatten(treedef, params),
                                   batch))

    update = jax.jit(lambda p, g, o, s: jax_apply_updates(
        opt, p, g, o, grad_scale=s))

    def apply(params, grads, opt_state, scale):
        p, o = update(jax.tree.unflatten(treedef, params),
                      jax.tree.unflatten(treedef, grads), opt_state,
                      jnp.float32(scale))
        return jax.tree.leaves(p), o

    ref = _Replay(jax.tree.leaves(tiny.jparams),
                  jax_init_opt_state(opt, tiny.jparams), grad, apply)
    for i, want in enumerate(jax_per_leaf[1]):
        ref.step(sched.phases[i % sched.period], T.jb(tiny, i))
        diff = _max_diff(want, ref.params)
        assert diff < REPLAY_TOL, f"step {i}: params diverge by {diff}"


def test_ddp_microbatch_matches_jax(group, tiny, single_mesh):
    """``microbatch=2`` against JAX's ``ddp_train_step(microbatch=2)`` over
    two steps, and against the port's ``microbatch=1``."""
    opt = jax_adamw(LR)
    params = jax.tree.map(jnp.asarray, tiny.jparams)
    jstate = {"params": params, "opt": jax_init_opt_state(opt, params)}
    step = jax.jit(functools.partial(jax_ddp_train_step, cfg=tiny.cfg,
                                     opt_spec=opt, microbatch=2))
    with single_mesh:
        jm = []
        for i in range(2):
            jstate, m = step(jstate, T.jb(tiny, i))
            jm.append({k: float(v) for k, v in m.items()})

    runs = {}
    for mb in (2, 1):
        state = init_ddp_state(tiny.tcfg, adamw(LR),
                               params=tree_map(torch.clone, tiny.params))
        fn = make_ddp_step(tiny.tcfg, adamw(LR), microbatch=mb)
        ms = []
        for i in range(2):
            state, m = fn(state, T.tb(tiny, i))
            ms.append(m)
        runs[mb] = (ms, [p.numpy() for p in tree_leaves(state["params"])])
    ms, params = runs[2]
    for m, want in zip(ms, jm):
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(m[k]), want[k], rtol=RTOL,
                                       atol=ATOL)
        assert m["updated"] and want["updated"]
    for a, b in zip(params, _np(jstate["params"])):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    # two halves of a batch are the batch: the mean of the halves' losses
    # and gradients is the whole batch's, up to rounding
    for m, m1 in zip(ms, runs[1][0]):
        np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                                   rtol=RTOL)
    for a, b in zip(params, runs[1][1]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_in_place_update_is_bitwise_pure(name, dtype):
    """``apply_updates_`` bitwise ``apply_updates`` (weight decay, clipping
    on), the params kept at their dtype; the pure update against JAX's on
    the same values."""
    rng = np.random.default_rng(3)
    make = lambda s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    tree = lambda f: {"a": f((4, 33)), "b": (f((7,)), f((2, 3, 5)))}
    params = tree(lambda s: make(s).to(dtype))
    grads = tree(lambda s: make(s) * 10)
    spec = (adamw(LR, weight_decay=0.1) if name == "adamw"
            else sgd_momentum(0.01, weight_decay=0.1))
    opt = init_opt_state(spec, params)
    for x in tree_leaves(opt):
        if x.ndim:
            x.copy_(make(tuple(x.shape)).abs() * 1e-3)
    pure_p, pure_o = apply_updates(spec, params, grads, opt, grad_scale=0.5)
    clone = lambda t: tree_map(torch.clone, t)
    p2, o2 = apply_updates_(spec, clone(params), clone(grads), clone(opt),
                            grad_scale=0.5)
    for a, b in zip(tree_leaves((pure_p, pure_o)), tree_leaves((p2, o2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(p.dtype == dtype for p in tree_leaves(p2))

    jspec = (jax_adamw(LR, weight_decay=0.1) if name == "adamw"
             else jax_sgd(0.01, weight_decay=0.1))
    to_j = lambda t: tree_map(
        lambda x: jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32), t)
    jp, jo = jax_apply_updates(jspec, to_j(params), to_j(grads),
                               {k: to_j(v) for k, v in opt.items()},
                               grad_scale=0.5)
    for a, b in zip(tree_leaves(pure_p), tree_leaves(jp)):
        assert str(b.dtype) == str(a.dtype).replace("torch.", "")
        # bf16: each side rounds its f32 result once; one ulp apart at most
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b, np.float32),
            **(dict(rtol=0, atol=1e-6) if dtype == torch.float32
               else dict(rtol=2.0 ** -7, atol=0)))


def test_fsdp_per_leaf_steps_refused(tiny, delayed):
    bo, sched = delayed
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        deft_rs_phase_step({}, {})
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        make_deft_step_fns(tiny.tcfg, adamw(LR), sched, bo, fsdp=True)
