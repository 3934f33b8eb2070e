"""Port parity: loss and per-leaf gradients of ``repro_torch.models`` against
``jax.value_and_grad(repro.models.model.loss_fn)`` on the smoke configs.

Params come from the JAX initializer and cross as numpy through
``repro_torch.convert``; batches are the JAX package's ``make_batch``.
Tolerance: f32 on the CPU in both packages, with different summation
orders (XLA vs ATen reductions, blockwise vs naive softmax) — rtol 1e-4,
atol 1e-5 on the loss and on every gradient leaf.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.data.pipeline import make_batch
from repro.models.model import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.models.model import init_params, loss_fn
from repro_torch.tree import tree_flatten_with_path, tree_leaves

RTOL, ATOL = 1e-4, 1e-5


def _jax_case(arch, batch, seq, loss_chunk, n_layers=2):
    cfg = reduce_for_smoke(get_config(arch), n_layers)
    params = jax_init_params(jax.random.PRNGKey(0), cfg)
    data = make_batch(cfg, 0, 0, batch, seq)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, cfg, data, loss_chunk=loss_chunk),
        has_aux=True))(params)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return to_np(params), to_np(data), float(loss), to_np(grads)


# gemma2 smoke: window 64 < seq 96, so the sliding window really masks;
# softcaps 50/30, GQA 4H/2KV, head_dim 32.  qwen3 smoke: qk-norm, silu.
# recurrentgemma smoke: (rglru, rglru, local_attn) with MQA 4H/1KV, window
# 64 < seq 80, lru_width 256; 3 layers are one stacked period, 5 layers a
# period plus a 2-layer tail (rglru, rglru) outside the stack.
# rwkv6 smoke: period-1 stack of rwkv blocks (time-mix with 4 heads of size
# 64, channel-mix), layernorm, untied head; seq 80 takes the WKV token loop
# in both packages, seq 176 the chunked pair (ragged against T = 32).
@pytest.mark.parametrize("arch,seq,loss_chunk,n_layers", [
    pytest.param("gemma2-2b", 96, 0, 2, id="gemma2-2b-96-0"),
    pytest.param("gemma2-2b", 96, 40, 2, id="gemma2-2b-96-40"),
    pytest.param("qwen3-4b", 48, 0, 2, id="qwen3-4b-48-0"),
    pytest.param("recurrentgemma-9b", 80, 0, 3, id="recurrentgemma-9b-80-0"),
    pytest.param("recurrentgemma-9b", 80, 32, 5,
                 id="recurrentgemma-9b-80-32-5layers"),
    pytest.param("rwkv6-1.6b", 80, 0, 2, id="rwkv6-1.6b-80-0"),
    pytest.param("rwkv6-1.6b", 176, 0, 2, id="rwkv6-1.6b-176-0"),
    pytest.param("rwkv6-1.6b", 80, 32, 3, id="rwkv6-1.6b-80-32-3layers"),
])
def test_loss_and_grads_match_jax(arch, seq, loss_chunk, n_layers):
    params_np, data, jloss, jgrads = _jax_case(arch, 2, seq, loss_chunk,
                                               n_layers)
    cfg = t_reduce(t_get_config(arch), n_layers)
    params = params_from_numpy(params_np, device="cpu")
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(np.asarray(v)).long() for k, v in data.items()}
    loss, parts = loss_fn(params, cfg, batch, loss_chunk=loss_chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL, atol=ATOL)
    assert float(parts["aux"]) == 0.0
    got = tree_flatten_with_path(params)
    want = tree_leaves(jgrads)
    assert len(got) == len(want)
    for (path, p), g in zip(got, want):
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg="/".join(path))


@pytest.mark.parametrize("arch,n_layers", [
    pytest.param("gemma2-2b", 2, id="gemma2-2b"),
    pytest.param("qwen3-4b", 2, id="qwen3-4b"),
    pytest.param("recurrentgemma-9b", 3, id="recurrentgemma-9b"),
    pytest.param("recurrentgemma-9b", 5, id="recurrentgemma-9b-5layers"),
    pytest.param("rwkv6-1.6b", 2, id="rwkv6-1.6b"),
    pytest.param("rwkv6-1.6b", 3, id="rwkv6-1.6b-3layers")])
def test_param_tree_matches_jax_structure(arch, n_layers):
    """init_params builds the JAX package's tree: same paths, same
    stacked shapes, same leaf order; convert round-trips bitwise."""
    cfg = t_reduce(t_get_config(arch), n_layers)
    jcfg = reduce_for_smoke(get_config(arch), n_layers)
    jp = jax.eval_shape(lambda: jax_init_params(jax.random.PRNGKey(0), jcfg))
    jpaths = [tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    tp = init_params(cfg, seed=3, device="cpu")
    assert [p for p, _ in tree_flatten_with_path(tp)] == jpaths
    assert [tuple(x.shape) for x in tree_leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    back = params_from_numpy(params_to_numpy(tp), device="cpu")
    for a, b in zip(tree_leaves(tp), tree_leaves(back)):
        assert torch.equal(a, b)
    # same seed, same draws; meta device draws nothing
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(tp), tree_leaves(init_params(cfg, seed=3, device="cpu"))))
    assert all(x.device.type == "meta"
               for x in tree_leaves(init_params(cfg, device="meta")))
