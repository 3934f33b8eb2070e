from repro_torch.kernels.quantize.ops import (
    cast_compute,
    dequantize_int8,
    dequantize_int8_cuda,
    dequantize_int8_plain,
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
    "cast_compute", "dequantize_int8", "dequantize_int8_cuda",
    "dequantize_int8_plain", "quantize_dequantize_int8", "quantize_int8",
    "quantize_int8_cuda", "quantize_int8_plain", "stochastic_round_bf16",
    "stochastic_round_bf16_cuda", "stochastic_round_bf16_plain", "wire_seed",
]
