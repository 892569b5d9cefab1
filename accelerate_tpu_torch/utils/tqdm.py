"""A tqdm bar shown by the main process only (counterpart of
``accelerate_tpu/utils/tqdm.py``)."""

from __future__ import annotations


def tqdm(*args, main_process_only: bool = True, **kwargs):
    try:
        from tqdm.auto import tqdm as _tqdm
    except ImportError as e:
        raise ImportError("tqdm is required for accelerate_tpu_torch.utils.tqdm") from e

    if main_process_only:
        from ..state import job_process_index

        kwargs["disable"] = kwargs.get("disable", False) or job_process_index() != 0
    return _tqdm(*args, **kwargs)
