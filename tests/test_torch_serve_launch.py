"""The port's serving launcher (``repro_torch.launch.serve``) against the JAX
package's serve steps, on the CPU.

* ``serve`` (greedy) on qwen3-4b-smoke's params (``_torch_tiny.
  smoke_params``) and numpy prompts: its tokens equal a loop over JAX's
  jitted ``prefill_serve_step`` / ``decode_serve_step`` on the same params
  and prompts (argmax of each step's logits), and its logits each step's
  within rtol 1e-4 / atol 1e-5; a temperature run samples from its own
  ``torch.Generator``, the same tokens for the same seed.
* ``python -m repro_torch.launch.serve --arch qwen3-4b --smoke --device
  cpu`` prints the JAX launcher's three lines.
"""
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _torch_threads  # noqa: F401  (one CPU thread a test process)
from repro.configs import get_config, reduce_for_smoke
from repro.serve.steps import (
    decode_serve_step,
    make_serve_cache,
    prefill_serve_step,
)
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduce_for_smoke as t_reduce
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import serve

from _torch_tiny import smoke_params

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-4b"
B, PROMPT, GEN = 3, 20, 10
RTOL, ATOL = 1e-4, 1e-5


def _jax_serve(cfg, jparams, prompts):
    """JAX's launcher loop, greedy: (tokens [B, GEN], logits [B, GEN, V])."""
    pre = jax.jit(functools.partial(prefill_serve_step, cfg=cfg))
    dec = jax.jit(functools.partial(decode_serve_step, cfg=cfg))
    cache = make_serve_cache(cfg, B, PROMPT + GEN, dtype=jnp.float32,
                             prefill_chunk=PROMPT)
    logits, cache = pre(jparams, jnp.asarray(prompts), cache)
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    tokens, all_logits = [token], [logits]
    for i in range(GEN - 1):
        logits, cache = dec(jparams, token, cache, jnp.int32(PROMPT + i))
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        tokens.append(token)
        all_logits.append(logits)
    return (np.stack([np.asarray(t) for t in tokens], axis=1),
            np.stack([np.asarray(x) for x in all_logits], axis=1))


def test_greedy_serve_matches_jax_serve_steps():
    cfg = reduce_for_smoke(get_config(ARCH))
    tcfg = t_reduce(t_get_config(ARCH))
    np_params = smoke_params(ARCH)
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    want_tokens, want_logits = _jax_serve(
        cfg, jax.tree.map(jnp.asarray, np_params), prompts)
    params = params_from_numpy(np_params, device="cpu")
    out = serve(tcfg, params, torch.from_numpy(prompts).long(), GEN)
    assert out.tokens.shape == (B, GEN) and out.logits.shape == (
        B, GEN, tcfg.vocab_size)
    np.testing.assert_array_equal(out.tokens.numpy(), want_tokens)
    np.testing.assert_allclose(out.logits.numpy(), want_logits, rtol=RTOL,
                               atol=ATOL)
    assert out.prefill_s > 0 and out.decode_s > 0
    sampled = [serve(tcfg, params, torch.from_numpy(prompts).long(), GEN,
                     temperature=1.0,
                     generator=torch.Generator().manual_seed(7)).tokens
               for _ in range(2)]
    assert torch.equal(*sampled)
    assert not torch.equal(sampled[0], out.tokens)


def test_launcher_prints_the_jax_lines():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "arch=qwen3-4b-smoke requests=8 prompt=48 gen=24"
    assert re.fullmatch(r"prefill [\d.]+ms; decode [\d.]+ms/token "
                        r"\(\d+ tok/s\)", lines[1]), lines[1]
    m = re.fullmatch(r"first request tokens: \[([\d, ]+)\]", lines[2])
    assert m and len(m.group(1).split(",")) == 24, lines[2]
