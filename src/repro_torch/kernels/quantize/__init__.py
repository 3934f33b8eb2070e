from repro_torch.kernels.quantize.ops import (
    HashIndex,
    cast_compute,
    dequantize_int8,
    dequantize_int8_cuda,
    dequantize_int8_plain,
    int8_scales,
    quantize_dequantize_int8,
    quantize_int8,
    quantize_int8_cuda,
    quantize_int8_plain,
    stochastic_round_bf16,
    stochastic_round_bf16_cuda,
    stochastic_round_bf16_plain,
    wire_seed,
)

__all__ = [
    "HashIndex", "cast_compute", "dequantize_int8", "dequantize_int8_cuda",
    "dequantize_int8_plain", "int8_scales", "quantize_dequantize_int8",
    "quantize_int8", "quantize_int8_cuda", "quantize_int8_plain",
    "stochastic_round_bf16", "stochastic_round_bf16_cuda",
    "stochastic_round_bf16_plain", "wire_seed",
]
