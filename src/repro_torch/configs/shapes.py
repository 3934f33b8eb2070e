"""The four assigned input shapes.

``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the batched
prefill; ``decode_32k`` and ``long_500k`` lower ``serve_step`` — ONE new
token against a KV cache / recurrent state of ``seq_len``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def get_shape(name: str) -> InputShape:
    return SHAPES_BY_NAME[name]
