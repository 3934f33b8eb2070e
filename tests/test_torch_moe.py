"""Port parity of the MoE FFN and the two MoE families against the JAX
package, on the same numpy params, inputs and batches.

* ``top_k_lower_first`` against ``jax.lax.top_k`` on rows with ties
  (values and indices equal: ties go to the lower expert).
* ``apply_moe`` against JAX's on deepseek-v2-236b-smoke's MoE (4 experts,
  top-2, one shared expert) with the shared experts at capacity factor
  0.5, where queues overflow, and without them at the default 1.25, and
  on llama4-maverick-400b-a17b-smoke's (top-1, overflowing): the same slot of every
  (token, choice) and the same drop set as JAX's exclusive-cumsum
  dispatch, and output, aux and the gradients of x and of every param
  leaf (through an output cotangent and aux) within rtol 1e-4 /
  atol 1e-5 (f32 on the CPU, other summation orders).
* ``loss_fn`` and every gradient leaf of llama4-maverick-400b-a17b-smoke
  (through the chunked LM head) against ``jax.value_and_grad`` of JAX's
  (rtol 1e-4, atol 1e-5, as tests/test_torch_model.py) on a batch of the
  port's stream (as tests/test_torch_encdec.py feeds JAX), the aux part
  nonzero and equal, and the param tree's shapes JAX's
  (``_torch_tiny.loss_and_grads_match_jax``, which tests/test_torch_mla.py
  runs on deepseek-v2-236b-smoke beside its engine test), at the params
  of the port's init (``_torch_tiny.smoke_params``).
* llama4-maverick-400b-a17b-smoke (MoE without MLA) on the precision
  path through ``launch.train.train`` on the CPU: int8 wires, a bf16sr
  master and bf16 compute run with finite losses and a bf16 master.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.models import moe as jmoe
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.launch.train import init_distributed, train
from repro_torch.models.moe import apply_moe, route, top_k_lower_first
from repro_torch.tree import tree_flatten_with_path, tree_leaves

from _torch_tiny import loss_and_grads_match_jax, smoke_params

RTOL, ATOL = 1e-4, 1e-5
DEEPSEEK, LLAMA4 = "deepseek-v2-236b", "llama4-maverick-400b-a17b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 4, size=(64, 8)).astype(np.float32) / 4
    for k in (1, 2, 6):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = top_k_lower_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@functools.lru_cache(maxsize=None)
def _jax_moe_params(arch):
    """JAX's ``init_moe`` for ``arch``'s smoke config (key 1), as numpy:
    drawn once a module, the cases without shared experts drop them."""
    cfg = reduce_for_smoke(get_config(arch))
    return _np(jax.jit(lambda k: jmoe.init_moe(k, cfg))(jax.random.PRNGKey(1)))


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_slots(jp, x, cfg, cf):
    """JAX's dispatch of ``apply_moe`` (repro/models/moe.py, the lines from
    the router to ``slot_token``): (top_e, slot_token [E, C], pos [T*k]),
    jitted (op by op, its compiles take longer)."""
    me = cfg.moe
    t = x.shape[0] * x.shape[1]
    e, k = me.n_experts, me.experts_per_token
    xt = x.reshape(t, -1)
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    cap = int(max(1, np.ceil(t * k / e * cf)))
    choice_e = top_e.reshape(-1)
    choice_t = jnp.repeat(jnp.arange(t), k)
    onehot = jax.nn.one_hot(choice_e, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    slot_token = jnp.full((e, cap), t, jnp.int32)
    slot_token = slot_token.at[choice_e, pos].set(choice_t, mode="drop")
    return top_e, slot_token, pos


# (arch, shared experts, capacity factor)
MOE_CASES = [
    pytest.param(DEEPSEEK, True, 0.5, id="deepseek-shared-overflow"),
    pytest.param(DEEPSEEK, False, 1.25, id="deepseek-routed-only"),
    pytest.param(LLAMA4, True, 0.5, id="llama4-top1-overflow"),
]


@pytest.mark.parametrize("arch,shared,cf", MOE_CASES)
def test_apply_moe_matches_jax(arch, shared, cf):
    cfg = reduce_for_smoke(get_config(arch))
    tcfg = t_reduce(t_get_config(arch))
    if not shared:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, n_shared_experts=0))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, n_shared_experts=0))
    jp = jax.tree.map(jnp.asarray, {k: v for k, v in
                                    _jax_moe_params(arch).items()
                                    if shared or k != "shared"})
    assert ("shared" in jp) == shared
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    c_aux = 3.0

    @jax.jit
    def jax_run(p, xx, ww):
        out, vjp = jax.vjp(
            lambda p_, x_: jmoe.apply_moe(p_, x_, cfg=cfg, capacity_factor=cf),
            p, xx)
        return out, vjp((ww, jnp.float32(c_aux)))

    (jy, jaux), (jgp, jgx) = jax_run(jp, jnp.asarray(x), jnp.asarray(w))

    params = params_from_numpy(_np(jp), device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = apply_moe(params, tx, cfg=tcfg, capacity_factor=cf)
    (torch.sum(y * torch.from_numpy(w)) + c_aux * aux).backward()

    # the same slots and drops as JAX's dispatch
    top_e, slot_token, pos = map(np.asarray,
                                 _jax_slots(jp, jnp.asarray(x), cfg, cf))
    cap = slot_token.shape[1]
    xt = tx.detach().reshape(-1, cfg.d_model)
    probs = torch.softmax((xt @ params["router"].detach()).float(), -1)
    t_top = top_k_lower_first(probs, cfg.moe.experts_per_token)[1]
    np.testing.assert_array_equal(t_top.numpy(), top_e)
    t_slot_token, choice_slot = route(t_top, cfg.moe.n_experts, cap)
    np.testing.assert_array_equal(
        t_slot_token.reshape(cfg.moe.n_experts, cap).numpy(), slot_token)
    dropped = (choice_slot.reshape(-1) == cfg.moe.n_experts * cap).numpy()
    np.testing.assert_array_equal(dropped, pos >= cap)
    assert dropped.any() == (cf < 1)

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=ATOL)
    assert float(aux) > 0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               rtol=RTOL, atol=ATOL)
    got = tree_flatten_with_path(params)
    want = jax.tree.leaves(jgp)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg="/".join(path))


def test_loss_and_grads_match_jax():
    """llama4-maverick-400b-a17b-smoke through the chunked LM head."""
    loss_and_grads_match_jax(LLAMA4, 48, 24,
                             jax.tree.map(jnp.asarray, smoke_params(LLAMA4)))


def test_llama4_takes_the_precision_path():
    init_distributed(torch.device("cpu"))
    cfg = t_reduce(t_get_config(LLAMA4))
    res = train(cfg, steps=4, batch=2, seq=32, device="cpu",
                wire_precision="int8", master_dtype="bf16sr",
                compute_dtype="bf16", partition_elems=100_000,
                log=lambda s: None)
    assert all(np.isfinite(res["losses"]))
    assert res["runtime"].stats()["sharded_state"]       # needs_fsdp
    assert all(b.dtype == torch.bfloat16 for b in res["state"]["pbuf"])
