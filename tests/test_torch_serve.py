"""Port parity of the serving path (``init_cache``, ``prefill``,
``decode_step`` and every block kind's cache branch) against the JAX
package, on the CPU.

* The seven families of ``tests/test_decode_equivalence.py`` at smoke
  size (B 2, S 24, prefill 16, capacity factor 16): the cache after
  prefill leaf for leaf and every decode step's logits against JAX's
  jitted ``prefill`` / ``decode_step`` (``pos`` traced) on the same numpy
  params, tokens and memory, rtol 1e-4 / atol 1e-5 (f32 on the CPU,
  other summation orders: ``test_torch_model.py``'s limits; the RWKV-6
  WKV's state, whose elements reach 20 here, within ``test_torch_rwkv6.
  py``'s rtol = atol = 1e-4 for the WKV's S_final); and the
  port's prefill + decode against its own ``forward``, max |diff| / max
  |ref| < 2e-4 (the bound of JAX's decode-equivalence test).  At smoke
  size the VLM's three layers hold no gated cross block, so it runs again
  at 5 layers (one whole pattern period) with its gate opened to 0.5, as
  ``test_torch_encdec.py`` runs it: its cross K/V cached at prefill and
  read at each decode step.  Its logits are held within atol 1e-4: the two
  packages' training forwards alone, no cache, differ by up to 4.8e-5 on
  it (logits of magnitude 3).
* gemma2's ring cache decoding past the smoke window of 64 (one prompt
  token, 134 decode steps): every step against JAX's and against the
  port's ``forward``.
* ``attention_reference`` against JAX's ``ref.py`` over ``q_offset``, a
  ragged ``kv_length``, window, softcap and GQA.
* A decode step with a ragged ``kv_length [B]`` (qwen3-4b-smoke, the
  port's post-prefill cache carried to JAX through ``cache_to_numpy``).
* A full cache of another dtype than the compute's is refused by both
  packages (JAX's ``dynamic_update_slice``); a bf16 ring rounds the f32
  K/V as JAX's scatter does.
* MLA's absorbed decode with a ragged ``kv_length``: JAX's compares the
  [B] lengths with the key axis (``attention.py:331``) and raises at B 2;
  the port refuses it too, and each row at B 1 with its own length
  matches JAX's.
* MoE decode at the default capacity factor 1.25, where the capacity
  binds (deepseek-v2-236b-smoke at B 8: the logits differ from those at
  capacity 16), against JAX's.
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduce_for_smoke
from repro.kernels.flash_attention.ref import attention_reference as jax_ref
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import (
    cache_from_numpy,
    cache_to_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.kernels.flash_attention import attention_reference
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel
from repro_torch.tree import tree_flatten_with_path

from _torch_tiny import smoke_params

FAMILIES = [
    "qwen3-4b",                # dense GQA + qk-norm
    "gemma2-2b",               # local + global, softcaps, post-norms
    "deepseek-v2-236b",        # MLA + MoE
    "rwkv6-1.6b",              # rwkv recurrence
    "recurrentgemma-9b",       # rglru + local attention hybrid
    "seamless-m4t-large-v2",   # enc-dec cross attention
    "llama-3.2-vision-90b",    # gated cross-attention VLM
]
# (arch, smoke layers, the logits' atol)
CASES = [pytest.param(arch, 2, 1e-5, id=arch) for arch in FAMILIES] + [
    pytest.param("llama-3.2-vision-90b", 5, 1e-4,
                 id="llama-3.2-vision-90b-5")]
VLM_GATE = 0.5
B, S, N_PREFILL, CAP = 2, 24, 16, 16.0
RTOL, ATOL = 1e-4, 1e-5
WKV_STATE_ATOL = 1e-4        # the WKV's S_final limit (test_torch_rwkv6.py)
DECODE_BOUND = 2e-4


def _cfgs(arch, n_layers=2):
    return (reduce_for_smoke(get_config(arch), n_layers),
            t_reduce(t_get_config(arch), n_layers))


def _inputs(cfg, batch, seq, seed):
    """Numpy tokens [batch, seq] and, for a non-text config, the stub
    frontend's memory [batch, M, d]."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    memory = None
    if cfg.modality != "text":
        memory = rng.standard_normal(
            (batch, max(cfg.n_modal_tokens, 1), cfg.d_model)
        ).astype(np.float32)
    return tokens, memory


@functools.lru_cache(maxsize=None)
def _jax_steps(arch, cap, ragged=False, n_layers=2):
    """JAX's ``prefill`` and ``decode_step`` of ``arch``'s smoke config,
    jitted once each (``pos`` traced; ``kv_length`` passed when
    ``ragged``)."""
    cfg = _cfgs(arch, n_layers)[0]
    pre = jax.jit(lambda p, t, c, m: jmodel.prefill(
        p, cfg, t, c, memory=m, capacity_factor=cap))
    if ragged:
        dec = jax.jit(lambda p, t, c, pos, kl: jmodel.decode_step(
            p, cfg, t, c, pos, kv_length=kl, capacity_factor=cap))
    else:
        dec = jax.jit(lambda p, t, c, pos: jmodel.decode_step(
            p, cfg, t, c, pos, capacity_factor=cap))
    return pre, dec


@functools.lru_cache(maxsize=None)
def _params(arch, n_layers=2):
    """(JAX params, port params) from ``smoke_params`` (at another depth
    the port's init, seed 0, with every gate opened): never written."""
    if n_layers == 2:
        np_params = smoke_params(arch)
    else:
        np_params = jax.tree_util.tree_map_with_path(
            lambda path, x: np.full_like(x, VLM_GATE)
            if getattr(path[-1], "key", None) == "gate" else x,
            params_to_numpy(tmodel.init_params(_cfgs(arch, n_layers)[1],
                                               seed=0, device="cpu")))
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_numpy(np_params, device="cpu"))


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol, err_msg=what)


def _caches_close(got, want):
    """A port cache as numpy (``cache_to_numpy``) against JAX's, leaf for
    leaf: tree, shapes and dtypes equal, values within the limits."""
    got = tree_flatten_with_path(got)
    want = jax.tree.leaves(want)
    assert len(got) == len(want) > 0
    for (path, a), b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, "/".join(path)
        wkv = path[-2:] == ("state", "s")
        _close(a, b, "cache " + "/".join(path),
               atol=WKV_STATE_ATOL if wkv else ATOL)


def _port_decode(arch, tokens, memory, cap, n_prefill, n_layers=2):
    """Prefill ``n_prefill`` tokens, then decode the rest one by one: (the
    logits [B, n, V] of the prefill's last position and of every decode
    step, the cache after prefill as numpy)."""
    tcfg = _cfgs(arch, n_layers)[1]
    params = _params(arch, n_layers)[1]
    batch, seq = tokens.shape
    cache = tmodel.init_cache(tcfg, batch, seq, device="cpu",
                              prefill_chunk=n_prefill)
    mem = None if memory is None else torch.from_numpy(memory)
    prompt = torch.from_numpy(tokens[:, :n_prefill])
    got = [tmodel.prefill(params, tcfg, prompt, cache, memory=mem,
                          capacity_factor=cap)]
    filled = cache_to_numpy(cache)
    for i in range(n_prefill, seq):
        got.append(tmodel.decode_step(params, tcfg,
                                      torch.from_numpy(tokens[:, i]), cache,
                                      i, capacity_factor=cap))
    return torch.stack(got, dim=1).numpy(), filled


def _jax_decode(arch, tokens, memory, cap, n_prefill, n_layers=2):
    """The same through JAX's jitted ``prefill`` / ``decode_step``."""
    cfg = _cfgs(arch, n_layers)[0]
    jparams = _params(arch, n_layers)[0]
    pre, dec = _jax_steps(arch, cap, n_layers=n_layers)
    batch, seq = tokens.shape
    cache = jmodel.init_cache(cfg, batch, seq, prefill_chunk=n_prefill)
    last, cache = pre(jparams, jnp.asarray(tokens[:, :n_prefill]), cache,
                      None if memory is None else jnp.asarray(memory))
    want, filled = [last], jax.tree.map(np.asarray, cache)
    for i in range(n_prefill, seq):
        logits, cache = dec(jparams, jnp.asarray(tokens[:, i]), cache,
                            jnp.int32(i))
        want.append(logits)
    return np.stack([np.asarray(w) for w in want], axis=1), filled


def _port_forward(arch, tokens, memory, cap, n_layers=2):
    """The port's training ``forward`` logits over every position."""
    tcfg = _cfgs(arch, n_layers)[1]
    params = _params(arch, n_layers)[1]
    with torch.inference_mode():
        mem = None if memory is None else torch.from_numpy(memory)
        if tcfg.is_encoder_decoder:
            mem = tmodel.encode(params, tcfg, mem)
        logits, _ = tmodel.forward(params, tcfg, torch.from_numpy(tokens),
                                   memory=mem, capacity_factor=cap,
                                   remat=False)
    return logits.numpy()


def _rel_err(got, want):
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-6))


@pytest.mark.parametrize("arch,n_layers,logits_atol", CASES)
def test_prefill_then_decode_matches_jax(arch, n_layers, logits_atol):
    cfg = _cfgs(arch, n_layers)[0]
    tokens, memory = _inputs(cfg, B, S, seed=1)
    got, tcache = _port_decode(arch, tokens, memory, CAP, N_PREFILL, n_layers)
    want, jcache = _jax_decode(arch, tokens, memory, CAP, N_PREFILL, n_layers)
    _caches_close(tcache, jcache)
    for i in range(got.shape[1]):
        _close(got[:, i], want[:, i],
               f"logits at position {N_PREFILL - 1 + i}", atol=logits_atol)
    # decode equivalence: prefill + decode against the port's own forward
    full = _port_forward(arch, tokens, memory, CAP,
                         n_layers)[:, N_PREFILL - 1:]
    err = _rel_err(got, full)
    assert err < DECODE_BOUND, f"{arch}: decode diverges from forward ({err})"


def test_ring_cache_long_decode_matches_jax():
    """gemma2's local layers decode far past the window: the ring of 64
    slots is rewritten twice over, against JAX's ring and the forward."""
    arch = "gemma2-2b"
    cfg = _cfgs(arch)[0]
    assert cfg.sliding_window == 64
    seq = cfg.sliding_window * 2 + 7
    tokens, _ = _inputs(cfg, 1, seq, seed=2)
    got, tcache = _port_decode(arch, tokens, None, 1.25, 1)
    want, _ = _jax_decode(arch, tokens, None, 1.25, 1)
    rings = [leaf for path, leaf in tree_flatten_with_path(tcache)
             if path[-1] == "k" and leaf.shape[-3] == cfg.sliding_window]
    assert rings, "no local layer's cache is a ring of the window's size"
    for i in range(got.shape[1]):
        _close(got[:, i], want[:, i], f"logits at position {i}")
    err = _rel_err(got, _port_forward(arch, tokens, None, 1.25))
    assert err < DECODE_BOUND, f"ring decode diverges from forward ({err})"


def test_attention_reference_matches_jax():
    rng = np.random.default_rng(3)
    b, sq, sk, h, kvh, d = 3, 5, 19, 8, 2, 32
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    kv_length = np.array([19, 11, 14], np.int32)
    for kw in (dict(causal=True, q_offset=11),
               dict(causal=True, window=6, softcap=5.0, q_offset=9),
               dict(causal=False, softcap=3.0)):
        for kl in (None, kv_length):
            want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           kv_length=None if kl is None else jnp.asarray(kl),
                           **kw)
            got = attention_reference(
                torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                kv_length=None if kl is None else torch.from_numpy(kl), **kw)
            _close(got.numpy(), want, f"{kw} kv_length={kl}")


def test_ragged_kv_length_decode_matches_jax():
    """One decode step of qwen3-4b-smoke whose rows see 21 and 13 keys of
    the cache: JAX decodes from the port's post-prefill cache, carried
    across through numpy, and the caches after the step agree."""
    arch = "qwen3-4b"
    cfg, tcfg = _cfgs(arch)
    jparams, params = _params(arch)
    tokens, _ = _inputs(cfg, B, 21, seed=4)
    cache = tmodel.init_cache(tcfg, B, 24, device="cpu", prefill_chunk=20)
    tmodel.prefill(params, tcfg, torch.from_numpy(tokens[:, :20]), cache)
    filled = cache_to_numpy(cache)
    kv_length = np.array([21, 13], np.int32)
    _, dec = _jax_steps(arch, 1.25, ragged=True)
    want, jcache = dec(jparams, jnp.asarray(tokens[:, 20]),
                       jax.tree.map(jnp.asarray, filled), jnp.int32(20),
                       jnp.asarray(kv_length))
    carried = cache_from_numpy(filled, device="cpu")
    got = tmodel.decode_step(params, tcfg, torch.from_numpy(tokens[:, 20]),
                             carried, 20,
                             kv_length=torch.from_numpy(kv_length))
    _close(got.numpy(), want, "ragged decode logits")
    _caches_close(cache_to_numpy(carried), jcache)
    full = tmodel.decode_step(params, tcfg, torch.from_numpy(tokens[:, 20]),
                              cache, 20)
    np.testing.assert_array_equal(full.numpy()[0], got.numpy()[0])
    assert not np.allclose(full.numpy()[1], got.numpy()[1], atol=1e-3), \
        "the shorter row's kv_length changed nothing"


def test_cache_dtype_rules_match_jax():
    """qwen3-4b-smoke's full caches in bf16 under f32 params: both packages
    refuse the write.  A gemma2-2b-smoke local layer's bf16 ring under f32
    params: the K/V it holds after a prefill within one bf16 rounding step
    of JAX's, the attention over them within the f32 limits."""
    arch = "qwen3-4b"
    cfg, tcfg = _cfgs(arch)
    jparams, params = _params(arch)
    tokens, _ = _inputs(cfg, B, 16, seed=9)
    with pytest.raises(TypeError, match="dtype"):
        jax.jit(lambda p_, t_, c_: jmodel.prefill(p_, cfg, t_, c_))(
            jparams, jnp.asarray(tokens),
            jmodel.init_cache(cfg, B, 24, dtype=jnp.bfloat16))
    with pytest.raises(TypeError, match="dtype"):
        tmodel.prefill(params, tcfg, torch.from_numpy(tokens),
                       tmodel.init_cache(tcfg, B, 24, device="cpu",
                                         dtype=torch.bfloat16))
    cfg, tcfg = _cfgs("gemma2-2b")
    jp = jax.jit(lambda k: jattn.init_attention(k, cfg))(jax.random.PRNGKey(3))
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(10).standard_normal(
        (B, 16, cfg.d_model)).astype(np.float32)
    jc = jattn.make_kv_cache(cfg, B, 200, window=64, dtype=jnp.bfloat16,
                             prefill_chunk=16)
    with warnings.catch_warnings():     # JAX warns of the scatter's cast
        warnings.simplefilter("ignore", FutureWarning)
        want, jc = jax.jit(lambda p_, x_, c_: jattn.apply_self_attention(
            p_, x_, cfg=cfg, window=64, cache=c_))(jp, jnp.asarray(x), jc)
    tc = tattn.make_kv_cache(tcfg, B, 200, window=64, device="cpu",
                             dtype=torch.bfloat16, prefill_chunk=16)
    with torch.inference_mode():
        got = tattn.apply_self_attention(p, torch.from_numpy(x), cfg=tcfg,
                                         window=64, cache=tc)
    for name in ("k", "v"):         # one bf16 rounding step apart at most
        assert tc[name].dtype == torch.bfloat16
        np.testing.assert_allclose(tc[name].float().numpy(),
                                   np.asarray(jc[name], np.float32),
                                   rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_mla_decode_takes_one_kv_length_as_jax_does():
    arch = "deepseek-v2-236b"
    cfg, tcfg = _cfgs(arch)
    jp = jax.jit(lambda k: jattn.init_mla(k, cfg))(jax.random.PRNGKey(7))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(8)
    prompt = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv_length = np.array([21, 13], np.int32)
    jax_mla = jax.jit(lambda p_, x_, c_, pos, kl: jattn.apply_mla(
        p_, x_, cfg=cfg, pos=pos, cache=c_, kv_length=kl), static_argnums=3)
    with pytest.raises(ValueError, match="broadcast"):
        jax_mla(jp, jnp.asarray(x), jattn.make_mla_cache(cfg, 2, 24), 20,
                jnp.asarray(kv_length))
    with torch.inference_mode():
        cache = tattn.make_mla_cache(tcfg, 2, 24, device="cpu")
        tattn.apply_mla(params, torch.from_numpy(prompt), cfg=tcfg, pos=0,
                        cache=cache)
        with pytest.raises(ValueError, match="one kv_length"):
            tattn.apply_mla(params, torch.from_numpy(x), cfg=tcfg, pos=20,
                            cache=cache,
                            kv_length=torch.from_numpy(kv_length))
    # each row alone, with its own length
    for row in range(2):
        rows = slice(row, row + 1)
        with torch.inference_mode():
            cache = tattn.make_mla_cache(tcfg, 1, 24, device="cpu")
            tattn.apply_mla(params, torch.from_numpy(prompt[rows]), cfg=tcfg,
                            pos=0, cache=cache)
            got = tattn.apply_mla(params, torch.from_numpy(x[rows]), cfg=tcfg,
                                  pos=20, cache=cache,
                                  kv_length=torch.from_numpy(kv_length[rows]))
        _, jc = jax_mla(jp, jnp.asarray(prompt[rows]),
                        jattn.make_mla_cache(cfg, 1, 24), 0, None)
        want, _ = jax_mla(jp, jnp.asarray(x[rows]), jc, 20,
                          jnp.asarray(kv_length[rows]))
        _close(got.numpy(), want, f"row {row}")


def test_moe_decode_at_default_capacity_matches_jax():
    """deepseek-v2-236b-smoke at B 8 with JAX's default capacity factor
    1.25: a decode step dispatches 8 tokens over 4 experts' queues of 5
    slots, top-2.  The capacity binds (the logits differ from the port's
    at capacity 16), and the port drops as JAX drops."""
    arch = "deepseek-v2-236b"
    cfg = _cfgs(arch)[0]
    tokens, _ = _inputs(cfg, 8, 19, seed=5)
    got, tcache = _port_decode(arch, tokens, None, 1.25, 16)
    want, jcache = _jax_decode(arch, tokens, None, 1.25, 16)
    _caches_close(tcache, jcache)
    for i in range(got.shape[1]):
        _close(got[:, i], want[:, i], f"logits at position {15 + i}")
    roomy = _port_decode(arch, tokens, None, CAP, 16)[0]
    for i in range(got.shape[1]):
        assert not np.allclose(roomy[:, i], got[:, i], atol=1e-3), \
            f"capacity 1.25 dropped nothing at position {15 + i}"
