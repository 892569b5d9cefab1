"""accelerate-tpu on PyTorch and CUDA: the port of ``accelerate_tpu`` to an
NVIDIA H100.

This slice serves llama models through a paged continuous-batching engine
whose decode attention is a hand-written CUDA kernel for ``sm_90a``
(``csrc/paged_decode.cu``). Entry points run on CUDA unless the caller passes
``device="cpu"``; on the CPU every kernel takes its plain PyTorch version.
"""

from .models import Llama, generate, get_config
from .ops.paged_attention import paged_decode_attention
from .serving import ServingEngine
from .utils.params import load_jax_params

__all__ = [
    "Llama",
    "ServingEngine",
    "generate",
    "get_config",
    "load_jax_params",
    "paged_decode_attention",
]
