#!/usr/bin/env python3
"""Phase 24's fp32 parity gates of ``chip_smoke.py`` held against two
faults, on one GPU.

Run from the repository root: ``python3 chip_gpt2_gate.py``. gpt2-124m fp32
at full depth, B=2 S=1024: the plain attention and plain adamw once, then
the kernels three ways: sound; with the flash backward's dq zeroed; with
the fused adamw kernel given bias corrections of 1 (each fault patched in
at run time). For each it prints the losses' relative gap, and every leaf's
gap (the norm of the difference over the leaf's norm) in the first
gradients and in the update over 3 steps, beside the tolerances phase 24
holds (``GPT2_LOSS_RTOL``, ``GPT2_GRAD_RTOL``, ``GPT2_UPDATE_RTOL``). It
exits non-zero when the sound run misses a gate or a faulty one passes
them all, and without a card.
"""

from __future__ import annotations

import functools
import sys

import torch

import chip_smoke as cs
from accelerate_tpu_torch.ops import fused_adamw as fused

FAULTS = ("sound", "zero-dq", "no-bias-correction")


def kernels_with(fault: str, batch) -> dict:
    """``chip_smoke.gpt2_parity_run("kernels")`` with ``fault`` patched in."""
    dq_kernel, adamw_kernel = cs.fa.flash_backward_dq, fused.adamw_leaf
    if fault == "zero-dq":
        @functools.wraps(dq_kernel)  # the wrapper counts its launches on the name it is called by
        def zero_dq(*args, **kwargs):
            dq, *rest = dq_kernel(*args, **kwargs)
            return (dq * 0, *rest)

        cs.fa.flash_backward_dq = zero_dq
    elif fault == "no-bias-correction":
        @functools.wraps(adamw_kernel)
        def uncorrected(p, mu, nu, g, bc, hp):
            adamw_kernel(p, mu, nu, g, torch.ones_like(bc), hp)

        fused.adamw_leaf = uncorrected
    try:
        return cs.gpt2_parity_run("kernels", batch)
    finally:
        cs.fa.flash_backward_dq, fused.adamw_leaf = dq_kernel, adamw_kernel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gpt2_gate: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_environment()
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = cs.gpt2_parity_batch()
    want = cs.gpt2_parity_run("plain", batch)
    print(f"[gpt2-gate] plain: losses {want['losses']} [{card}]", flush=True)
    passed = {}
    for fault in FAULTS:
        got = kernels_with(fault, batch)
        gaps = cs.gpt2_parity_gaps(got, want)
        passed[fault] = cs.gpt2_parity_passes(*gaps)
        print(f"[gpt2-gate] {fault}: losses {got['losses']}, {cs.gpt2_gap_line(*gaps)}; by leaf, gradients "
              f"{ {k: float(f'{v:.3e}') for k, v in gaps[1].items()} }, updates "
              f"{ {k: float(f'{v:.3e}') for k, v in gaps[2].items()} }; "
              f"{'passes' if passed[fault] else 'fails'} [{card}]", flush=True)
    return 0 if passed["sound"] and not any(passed[f] for f in FAULTS[1:]) else 1


if __name__ == "__main__":
    sys.exit(main())
