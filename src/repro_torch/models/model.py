"""Full model of the port: init / encode / forward / loss over any
ArchConfig (attention, MLA, cross-attention, RG-LRU and RWKV-6 kinds,
dense or MoE FFNs; tied or untied LM head, RMS or layer norm).

Port of ``repro/models/model.py``.  The parameter tree is the
JAX package's: ``embed``, ``final_norm``, optional ``head``, the
``prefix`` / ``stack`` / ``tail`` block tuples, with each ``stack`` entry
holding one pattern position's weights stacked over the periods, and for
an encoder-decoder the ``encoder`` (its blocks stacked over its layers,
and its own ``final_norm``).  Where JAX scans the period body, the port
loops over the periods (a stacked leaf is unbound once per forward, so
its gradient comes back stacked); ``jax.checkpoint`` remat becomes
``torch.utils.checkpoint``, which takes the cross-attention memory as an
input of its own so its gradient reaches the encoder.  The encoder runs
without remat, as JAX's ``encode`` scans without ``jax.checkpoint``.

Serving: ``init_cache`` builds the decode cache in JAX's tree (the
``prefix`` / ``stack`` / ``tail`` tuples of ``init_block_cache``'s, each
``stack`` entry's leaves stacked over the periods), and ``forward`` given
a ``cache`` runs at absolute position ``pos`` and writes it in place: the
period loop takes each period's views of the stacked cache as it takes
the params'.  ``prefill`` (encoding an enc-dec's memory first, storing
the cross-attention K/V) returns the last position's logits, the LM head
applied to that position alone; ``decode_step`` feeds one token a row.
Both run under ``torch.inference_mode()`` without remat.

Over a 'model' mesh axis (``tp``, a ``sharding.tp.ModelParallel``) the
dense decoders, the RG-LRU and RWKV-6 families and an encoder-decoder run
tensor-parallel on this rank's shards of the params: the embedding over
its vocab rows (``vocab_embed``), the blocks over its heads, 'lru'
channels and ff columns (the encoder's too), the LM head over its vocab
slice and the cross entropy through ``vocab_parallel_nll``; every rank
computes the same loss.  Where the vocab does not split (seamless's
256,206 rows), the table and the head run whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models.blocks import (
    apply_block,
    check_model_parallel,
    init_block,
    init_block_cache,
)
from repro_torch.models.common import (
    apply_norm,
    cross_entropy_loss,
    dense_init,
    embed_init,
    init_norm,
    softcap,
    token_nll,
)
from repro_torch.sharding.tp import copy_in, vocab_embed
from repro_torch.tree import tree_dense, tree_leaves, tree_unflatten


# the encoder's blocks: bidirectional self-attention and a dense FFN
_ENCODER_SPEC = LayerSpec("attn", "dense")


@dataclasses.dataclass(frozen=True)
class StackLayout:
    prefix_specs: Tuple[LayerSpec, ...]
    period: int
    n_periods: int
    tail_specs: Tuple[LayerSpec, ...]

    @property
    def n_layers(self) -> int:
        return (len(self.prefix_specs) + self.period * self.n_periods
                + len(self.tail_specs))


def stack_layout(cfg: ArchConfig) -> StackLayout:
    specs = cfg.layer_specs()
    n = len(specs)
    prefix = cfg.moe.first_k_dense if cfg.moe else 0
    p = cfg.pattern_period
    n_periods = (n - prefix) // p
    tail = n - prefix - n_periods * p
    return StackLayout(
        prefix_specs=specs[:prefix],
        period=p,
        n_periods=n_periods,
        tail_specs=specs[n - tail:] if tail else (),
    )


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                dtype=torch.float32) -> Dict:
    """Random params from a ``torch.Generator`` seeded with ``seed``
    (``device="meta"`` gives a shapes-only tree and draws nothing)."""
    device = torch.device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    kw = dict(device=device, dtype=dtype)
    lay = stack_layout(cfg)
    params: Dict[str, Any] = {
        "embed": {"table": embed_init(gen, cfg.vocab_size, cfg.d_model, **kw)},
        "final_norm": init_norm(cfg.norm, cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, cfg.d_model, cfg.vocab_size, **kw)}
    params["prefix"] = tuple(
        init_block(gen, cfg, dataclasses.replace(spec, ffn="dense"), **kw)
        for spec in lay.prefix_specs
    )
    params["stack"] = tuple(
        init_block(gen, cfg, cfg.layer_pattern[j], lead=(lay.n_periods,), **kw)
        if lay.n_periods else {}
        for j in range(lay.period)
    )
    params["tail"] = tuple(init_block(gen, cfg, spec, **kw)
                           for spec in lay.tail_specs)
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "stack": init_block(gen, cfg, _ENCODER_SPEC,
                                lead=(cfg.n_encoder_layers,), **kw),
            "final_norm": init_norm(cfg.norm, cfg.d_model, **kw),
        }
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda",
               dtype=torch.float32, prefill_chunk: int = 1) -> Dict:
    """The decode cache of ``batch`` rows of up to ``max_len`` positions
    (a local layer's ring sized for chunks of ``prefill_chunk``)."""
    kw = dict(device=device, dtype=dtype, prefill_chunk=prefill_chunk)
    lay = stack_layout(cfg)
    return {
        "prefix": tuple(
            init_block_cache(cfg, dataclasses.replace(s, ffn="dense"), batch,
                             max_len, **kw)
            for s in lay.prefix_specs),
        "stack": tuple(
            init_block_cache(cfg, cfg.layer_pattern[j], batch, max_len,
                             lead=(lay.n_periods,), **kw)
            if lay.n_periods else {}
            for j in range(lay.period)),
        "tail": tuple(init_block_cache(cfg, s, batch, max_len, **kw)
                      for s in lay.tail_specs),
    }


def _period_views(stacked, n_periods: int):
    """Per-period trees of views into one stacked pattern position (every
    leaf of a lazy position materializes here, JAX's ``lax.scan``
    boundary)."""
    leaves = tree_leaves(stacked)
    unbound = [leaf.unbind(0) for leaf in leaves]
    return [tree_unflatten(stacked, [u[i] for u in unbound])
            for i in range(n_periods)]


def encode(params, cfg: ArchConfig, modal_embeds: torch.Tensor, *,
           attn_impl: Optional[str] = None, tp=None) -> torch.Tensor:
    """The bidirectional encoder over the stub frontend's embeddings
    [B, M, d] -> its final-norm output [B, M, d] (no remat).  With ``tp``
    (a ``ModelParallel``) its blocks run over this rank's heads and ff
    columns, and the output, the memory of every cross layer, goes out
    through ``copy_in``: each cross layer's K/V projection on this rank
    reads only its own heads' columns, so the memory's gradient is summed
    over 'model' here, once a step, not once a cross layer."""
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} has no encoder")
    enc = params["encoder"]
    x = modal_embeds
    for p in _period_views(enc["stack"], cfg.n_encoder_layers):
        x, _ = apply_block(p, x, cfg=cfg, spec=_ENCODER_SPEC, causal=False,
                           attn_impl=attn_impl, tp=tp)
    x = apply_norm(enc["final_norm"], x, cfg.norm)
    return x if tp is None else copy_in(x, tp)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, pos: int = 0,
            kv_length: Optional[torch.Tensor] = None,
            fill_cross_cache: bool = False, capacity_factor: float = 1.25,
            remat: bool = True, head: bool = True,
            attn_impl: Optional[str] = None,
            scan_impl: Optional[str] = None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,V], aux), aux the sum of the MoE blocks' load
    balance losses (0 without MoE); with ``head=False`` the final-norm
    hidden states [B,S,d] replace the logits.  ``memory`` [B, M, d] is
    what the cross-attention blocks attend to (the encoder's output, or
    the stub frontend's embeddings).  With a ``cache`` (``init_cache``)
    ``tokens`` sit at absolute positions ``pos``.. and every block writes
    its cache in place (``fill_cross_cache``: the cross-attention K/V of
    ``memory`` too).  ``tp`` (a ``ModelParallel``) runs the model
    tensor-parallel over the 'model' axis on this rank's shards of the
    params: the embedding over its vocab rows, the blocks over its heads,
    'lru' channels and ff columns, the logits of its vocab slice (where
    the vocab splits); an encoder-decoder's ``memory`` is then
    ``encode(..., tp=tp)``'s."""
    lay = stack_layout(cfg)
    if tp is not None:
        check_model_parallel(cfg)
    if _vocab_tp(cfg, tp) is not None:
        x = vocab_embed(params["embed"]["table"], tokens, tp)
    else:
        x = params["embed"]["table"][tokens]
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block_kw = dict(cfg=cfg, pos=pos, kv_length=kv_length,
                    fill_cross_cache=fill_cross_cache,
                    capacity_factor=capacity_factor, attn_impl=attn_impl,
                    scan_impl=scan_impl, tp=tp)

    def run(p, x, spec, c):
        fn = lambda p_, x_, m_: apply_block(p_, x_, spec=spec, memory=m_,
                                            cache=c, **block_kw)
        if remat:
            # a lazy (streamed) block is materialized here, at the
            # checkpoint boundary, so the recompute never gathers; the
            # memory goes in as an input, so its gradient flows out; the
            # (x, aux) tuple comes out of the region with both gradients
            return checkpoint(fn, tree_dense(p), x, memory,
                              use_reentrant=False, preserve_rng_state=False)
        return fn(p, x, memory)

    caches = cache if cache is not None else {
        "prefix": (None,) * len(lay.prefix_specs),
        "stack": (None,) * lay.period, "tail": (None,) * len(lay.tail_specs)}
    for i, spec in enumerate(lay.prefix_specs):
        x, a = run(params["prefix"][i], x,
                   dataclasses.replace(spec, ffn="dense"), caches["prefix"][i])
        aux = aux + a
    if lay.n_periods:
        views = [_period_views(params["stack"][j], lay.n_periods)
                 for j in range(lay.period)]
        cviews = [_period_views(c, lay.n_periods) if c is not None
                  else [None] * lay.n_periods for c in caches["stack"]]
        for i in range(lay.n_periods):
            for j in range(lay.period):
                x, a = run(views[j][i], x, cfg.layer_pattern[j], cviews[j][i])
                aux = aux + a
    for i, spec in enumerate(lay.tail_specs):
        x, a = run(params["tail"][i], x, spec, caches["tail"][i])
        aux = aux + a
    x = apply_norm(params["final_norm"], x, cfg.norm)
    if not head:
        return x, aux
    return head_logits(params, cfg, x, tp=tp), aux


def head_logits(params, cfg: ArchConfig, x: torch.Tensor, tp=None
                ) -> torch.Tensor:
    """Final-norm hidden states -> vocab logits (+ final softcap); with
    ``tp`` and the vocab split over 'model', the logits of this rank's
    vocab slice (the softcap is elementwise)."""
    if _vocab_tp(cfg, tp) is not None:
        x = copy_in(x, tp)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = x @ params["head"]["w"]
    if cfg.final_logit_softcap:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def _vocab_tp(cfg: ArchConfig, tp):
    """``tp`` where the vocab splits over 'model' (the embedding, the LM
    head and the cross entropy run on this rank's vocab slice), else
    None."""
    if tp is not None and tp.split("vocab", cfg.vocab_size):
        return tp
    return None


def chunked_ce(params, cfg: ArchConfig, x: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor], chunk: int, tp=None
               ) -> torch.Tensor:
    """Sequence-chunked LM head + cross entropy: each chunk's logits are
    recomputed in the backward (checkpoint), so the live logits buffer is
    [B, chunk, V] in both passes ([B, chunk, V / model] with ``tp``)."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)

    def body(xc, yc, mc):
        logits = head_logits(params, cfg, xc, tp=tp).float()
        return torch.sum(token_nll(logits, yc, _vocab_tp(cfg, tp)) * mc)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(body, x[:, sl], targets[:, sl], mask[:, sl],
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True, loss_chunk: int = 0,
            attn_impl: Optional[str] = None, scan_impl: Optional[str] = None,
            tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy plus the MoE aux loss; ``loss_chunk > 0``
    takes the chunked LM-head path.  ``batch`` holds tokens, labels and,
    for a non-text modality, the stub frontend's ``memory`` (encoded first
    in an encoder-decoder).  ``tp`` (a ``ModelParallel``) runs it
    tensor-parallel over the 'model' axis on this rank's shards of the
    params; the loss is the same on every model rank.  Returns (loss +
    aux, {"ce", "aux"})."""
    memory = batch.get("memory")
    if cfg.is_encoder_decoder:
        if tp is not None:
            check_model_parallel(cfg)
        memory = encode(params, cfg, memory, attn_impl=attn_impl, tp=tp)
    if loss_chunk:
        x, aux = forward(params, cfg, batch["tokens"], memory=memory,
                         remat=remat, head=False, attn_impl=attn_impl,
                         scan_impl=scan_impl, tp=tp)
        mask = batch.get("mask")
        loss = chunked_ce(params, cfg, x[:, :-1], batch["labels"][:, 1:],
                          mask[:, 1:] if mask is not None else None,
                          loss_chunk, tp=tp)
    else:
        logits, aux = forward(params, cfg, batch["tokens"], memory=memory,
                              remat=remat, attn_impl=attn_impl,
                              scan_impl=scan_impl, tp=tp)
        loss = cross_entropy_loss(logits[:, :-1], batch["labels"][:, 1:],
                                  batch.get("mask"), tp=_vocab_tp(cfg, tp))
    return loss + aux, {"ce": loss, "aux": aux}


@torch.inference_mode()
def prefill(params, cfg: ArchConfig, tokens: torch.Tensor, cache: Dict, *,
            memory: Optional[torch.Tensor] = None,
            capacity_factor: float = 1.25,
            attn_impl: Optional[str] = None,
            scan_impl: Optional[str] = None) -> torch.Tensor:
    """Fill ``cache`` (in place) with a prompt ``tokens`` [B, S]; returns the
    last position's logits [B, V] (the LM head applied to it alone)."""
    if cfg.is_encoder_decoder and memory is not None:
        memory = encode(params, cfg, memory, attn_impl=attn_impl)
    x, _ = forward(params, cfg, tokens, memory=memory, cache=cache, pos=0,
                   fill_cross_cache=True, capacity_factor=capacity_factor,
                   remat=False, head=False, attn_impl=attn_impl,
                   scan_impl=scan_impl)
    return head_logits(params, cfg, x[:, -1:])[:, 0]


@torch.inference_mode()
def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: Dict,
                pos: int, *, kv_length: Optional[torch.Tensor] = None,
                capacity_factor: float = 1.25,
                attn_impl: Optional[str] = None,
                scan_impl: Optional[str] = None) -> torch.Tensor:
    """One decode step: ``token`` [B] at absolute position ``pos`` (an int);
    writes ``cache`` in place and returns the logits [B, V]."""
    logits, _ = forward(params, cfg, token[:, None], cache=cache, pos=pos,
                        kv_length=kv_length, capacity_factor=capacity_factor,
                        remat=False, attn_impl=attn_impl,
                        scan_impl=scan_impl)
    return logits[:, 0]
