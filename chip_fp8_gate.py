#!/usr/bin/env python3
"""Phase 28's fp8 gates of ``chip_smoke.py`` held against a fault, on one GPU.

Run from the repository root: ``python3 chip_fp8_gate.py``. One process's
first gradients and first loss of llama-125m under
``mixed_precision="fp8"`` (B=8 at S=1024, ``fused_adamw(3e-4)``), then
phase 28's two-process fp8 step under ``ParallelismConfig(tensor=2)`` two
ways: sound, and with each operand's e4m3 scale taken from the process's
own slice instead of the whole tensor (patched in at run time, in the two
processes only). For each it prints the first loss's relative gap and
every leaf's first-gradient gap (the norm of the difference over the
leaf's norm) against the one process, beside the limits phase 28 holds
(``FP8_TP_LOSS_RTOL``, ``FP8_TP_GRAD_RTOL``). It exits non-zero when the
sound run misses a gate or the faulty one passes both, and without a card.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

FAULTS = ("sound", "per-shard-scale")


def fp8_with(grads_dir: str, fault: str) -> dict:
    """``chip_smoke.fp8_tp_job`` in this process of the pair, with ``fault``
    patched into the fp8 product first."""
    from accelerate_tpu_torch.ops import fp8

    if fault == "per-shard-scale":
        forward = fp8._Fp8Dot.forward

        def per_shard(ctx, x, w, margin, groups):
            return forward(ctx, x, w, margin, groups._replace(x=None, w=None))

        fp8._Fp8Dot.forward = staticmethod(per_shard)
    return cs.fp8_tp_job(grads_dir)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_fp8_gate: no CUDA device", file=sys.stderr)
        return 1
    from accelerate_tpu_torch.launchers import debug_launcher

    card = cs.phase_environment()
    cs.reset_training_state()
    want, one = cs.fp8_one_process()
    print(f"[fp8-gate] one process: first loss {one} [{card}]", flush=True)
    passed = {}
    for fault in FAULTS:
        with tempfile.TemporaryDirectory(prefix="chip-fp8-gate-") as tmp:
            ranks = debug_launcher(fp8_with, args=(tmp, fault), num_processes=2, timeout=600)
            gap, gaps = cs.fp8_tp_gaps(ranks, tmp, want, one)
        passed[fault] = gap <= cs.FP8_TP_LOSS_RTOL and max(gaps.values()) <= cs.FP8_TP_GRAD_RTOL
        print(f"[fp8-gate] {fault}: first loss {ranks[0]['fp8_losses'][0]}, relative gap {gap:.3e} (tolerance "
              f"{cs.FP8_TP_LOSS_RTOL}); first gradients' gaps min {min(gaps.values()):.3e}, median "
              f"{float(np.median(list(gaps.values()))):.3e}, max {max(gaps.values()):.3e} (tolerance "
              f"{cs.FP8_TP_GRAD_RTOL}), by leaf { {k: round(v, 5) for k, v in gaps.items()} }; "
              f"{'passes' if passed[fault] else 'fails'} [{card}]", flush=True)
    return 0 if passed["sound"] and not any(passed[f] for f in FAULTS[1:]) else 1


if __name__ == "__main__":
    sys.exit(main())
