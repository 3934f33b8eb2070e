"""Hand-written Hopper (sm_90a) kernels of the port, each beside its plain
PyTorch version and a launch counter.

Every TPU kernel of the JAX package (each function that reaches
``pl.pallas_call``) and where it stands in the port:

| Pallas entry (src/repro/kernels/...)                      | Computes                                   | Port |
|-----------------------------------------------------------|--------------------------------------------|------|
| flash_attention/kernel.py::flash_attention_pallas (:103)  | online-softmax attention forward, GQA,     | flash_attention/csrc/flash_fwd.cu (CUDA), |
|                                                           | causal/window skip, softcap; f32 or bf16   | f32 inputs, split-TF32 wgmma (a split |
|                                                           | in, f32 accumulate, q's dtype out          | pass, then hi.hi + hi.lo + lo.hi); |
|                                                           |                                            | flash_attention/csrc/flash_fwd_sm90.cu |
|                                                           |                                            | (CUDA), bf16 inputs, TMA + wgmma |
| bucket_update/kernel.py::bucket_update_pallas (:129)      | fused AdamW / SGD over one flat bucket     | bucket_update/csrc/bucket_update.cu (CUDA) |
| quantize/kernel.py::stochastic_round_bf16_pallas (:69)    | seeded stochastic rounding f32 -> bf16     | quantize/csrc/quantize.cu (CUDA) |
| quantize/kernel.py::quantize_int8_pallas (:112)           | per-128-lane-row absmax int8 quantization  | quantize/csrc/quantize.cu (CUDA) |
| quantize/kernel.py::dequantize_int8_pallas (:149)         | int8 * row scale                           | quantize/csrc/quantize.cu (CUDA) |
| rglru/kernel.py::rglru_scan_pallas (:49)                  | linear recurrence h_t = a_t h_{t-1} + b_t  | rglru/csrc/rglru_scan.cu (CUDA), |
|                                                           |                                            | forward and reverse-scan backward |
| rwkv6/kernel.py::rwkv6_pallas (:85)                       | chunked (T = 32) RWKV-6 WKV with a [D, D]  | rwkv6/csrc/rwkv6.cu (CUDA), |
|                                                           | state per head, D 32 or 64                 | forward and backward, each |
|                                                           |                                            | chunk-parallel passes around |
|                                                           |                                            | an elementwise chunk scan |

The flash-attention backward is plain PyTorch (a port of the JAX
package's ``flash.py`` recompute backward; the TPU kernel has none).  The
RG-LRU scan's and the RWKV-6 WKV's backwards are kernels of the port's own
(the TPU kernels have none either): the scan run in reverse, and the WKV's
per-chunk rdᵀ·do contributions, an elementwise reverse scan of the state
cotangent, one gradient pass per chunk and du's sum.

On the CPU each wrapper runs its plain version (``PYTHONPATH=src python -m
pytest -q tests/test_torch_rwkv6.py`` holds the WKV's against the JAX
package); on the card ``python3 chip_smoke.py`` and ``python -m pytest
--noconftest -m gpu tests/test_torch_gpu.py`` hold every kernel against
its plain version, and ``python -m repro_torch.launch.train --arch
rwkv6-1.6b --batch 1 --seq 8192 --loss-chunk 1024`` trains through them.

Kernels are compiled by ``build.py`` at first use on a CUDA tensor,
never at import.
"""
