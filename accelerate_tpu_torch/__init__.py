"""accelerate-tpu on PyTorch and CUDA: the port of ``accelerate_tpu`` to an
NVIDIA H100.

The port serves llama models through a paged continuous-batching engine,
with speculative decoding and quantized-resident (int8/int4) weights. Its
kernels are hand-written CUDA for ``sm_90a``: paged decode attention
(``csrc/paged_decode.cu``), the speculative verify attention
(``csrc/paged_verify.cu``) and the fused dequant-matmul
(``csrc/quant_matmul.cu``). Entry points run on CUDA unless the caller
passes ``device="cpu"``; on the CPU every kernel takes its plain PyTorch
version.
"""

from .big_modeling import dispatch_model, make_layered_device_map
from .models import Llama, generate, get_config
from .ops.paged_attention import paged_decode_attention, paged_verify_attention
from .ops.quant_matmul import quant_dot, quant_matmul
from .serving import ServingEngine, SpeculativeConfig
from .utils.params import load_jax_params
from .utils.quantization import QuantizationConfig, QuantizedWeight

__all__ = [
    "Llama",
    "QuantizationConfig",
    "QuantizedWeight",
    "ServingEngine",
    "SpeculativeConfig",
    "dispatch_model",
    "generate",
    "get_config",
    "load_jax_params",
    "make_layered_device_map",
    "paged_decode_attention",
    "paged_verify_attention",
    "quant_dot",
    "quant_matmul",
]
