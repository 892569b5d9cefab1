"""Hardware peak-FLOPs lookup for MFU derivation.

Counterpart of ``accelerate_tpu/telemetry/flops.py``. The model-side FLOPs
estimate lives in ``models/config.py`` (``train_flops_per_step``); this
module owns the hardware side: the dense bf16 tensor-core peak of one card,
keyed by ``torch.cuda.get_device_name()``. Sources: NVIDIA's data sheets
(SXM parts, dense rates without sparsity, at the full power limit). A key is
the device name without the vendor's prefix: ``"NVIDIA H100 80GB HBM3"``
looks up ``"H100 80GB HBM3"``.
``chip_smoke.py``'s MFU and the telemetry hub both read this table, so a
smoke run and a live run agree on what "MFU 0.4" means.

A card the table does not know gets no peak: MFU is then absent, with a
warning, rather than computed against a guess.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..logging import get_logger

logger = get_logger(__name__)

PEAK_BF16_FLOPS = {
    "H100 80GB HBM3": 989e12,  # H100 SXM
}


@functools.cache
def _warn_unknown(name: str) -> None:
    logger.warning(f"no bf16 peak is known for {name!r} (telemetry/flops.py PEAK_BF16_FLOPS): MFU is not reported")


def device_peak_flops(device=None) -> Optional[float]:
    """Peak bf16 FLOPs/sec of this process's card, or None: on the CPU (MFU
    would be noise, not signal), and on a card the table does not know."""
    if not torch.cuda.is_available():
        return None
    if device is not None and torch.device(device).type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    peak = PEAK_BF16_FLOPS.get(name.removeprefix("NVIDIA "))
    if peak is None:
        _warn_unknown(name)
    return peak
