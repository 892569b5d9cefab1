#!/usr/bin/env python3
"""Phase 21's gates of ``chip_smoke.py`` held against two faults, on one GPU.

Run from the repository root: ``python3 chip_ring_gate.py``. One process's
first gradients and losses on phase 21's batches (llama-125m bf16, B=4 at
S=8192, ``fused_adamw(3e-4)``), then phase 21's two-process ring three
ways: sound; with its past blocks dropped from the merge; with its hops
sending back zero gradients (each fault patched in at run time, in the
ring's processes only). For each it prints the losses' relative gaps and
every leaf's first-gradient gap (the norm of the difference over the leaf's
norm) against the one process, beside the tolerances phase 21 holds
(``RING_LOSS_RTOL``, ``RING_GRAD_RTOL``). It exits non-zero when the sound
ring misses a gate or a faulty one passes both, and without a card.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

import chip_smoke as cs

FAULTS = ("sound", "drop-past", "zero-hop-grad")


def ring_with(path: str, fault: str) -> dict:
    """``chip_smoke.train_ring_pair`` in this process of the ring, with
    ``fault`` patched into the ring first."""
    from accelerate_tpu_torch.parallel import ring_attention as ra

    if fault == "drop-past":
        block = ra.flash_attention_block

        def past_dropped(q, k, v, kv_mask=None, *, q_offset=None, kv_offset=None, **kwargs):
            out, lse = block(q, k, v, kv_mask, q_offset=q_offset, kv_offset=kv_offset, **kwargs)
            if kv_offset < q_offset:  # weighs 0 in the merge
                return out * 0, lse * 0 + ra.NEG_INF
            return out, lse

        ra.flash_attention_block = past_dropped
    elif fault == "zero-hop-grad":
        backward = ra._Rotate.backward

        def zero_back(ctx, grad):
            received, *rest = backward(ctx, grad)  # the hop still runs: every process posts it
            return (received * 0, *rest)

        ra._Rotate.backward = staticmethod(zero_back)
    return cs.train_ring_pair(path)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_ring_gate: no CUDA device", file=sys.stderr)
        return 1
    from accelerate_tpu_torch.launchers import debug_launcher

    card = cs.phase_environment()
    cs.reset_training_state()
    accelerator, model = cs.train_setup("llama-125m", "bf16", cs.fused_adamw(cs.ADAMW_LR))
    batches = [{"input_ids": torch.tensor(b, device="cuda")} for b in cs.ring_pair_batches()]
    want = cs.first_grads(accelerator, model, accelerator._optimizers[-1], batches[0], None)
    step = accelerator.compiled_step(cs.Llama.loss_fn(model))
    single = [float(step(b)) for b in batches]
    del accelerator, model, step
    torch.cuda.empty_cache()
    print(f"[ring-gate] one process: losses {single} [{card}]", flush=True)
    passed = {}
    for fault in FAULTS:
        with tempfile.TemporaryDirectory(prefix="chip-ring-gate-") as tmp:
            path = os.path.join(tmp, "grads.pt")
            ranks = debug_launcher(ring_with, args=(path, fault), num_processes=2, timeout=600)
            gaps = cs.leaf_gaps(torch.load(path), want)
        loss_gaps = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], single)]
        passed[fault] = max(loss_gaps) <= cs.RING_LOSS_RTOL and max(gaps.values()) <= cs.RING_GRAD_RTOL
        print(f"[ring-gate] {fault}: losses {ranks[0]['losses']}, relative gaps "
              f"{[f'{g:.3e}' for g in loss_gaps]} (tolerance {cs.RING_LOSS_RTOL}); first gradients' gaps "
              f"min {min(gaps.values()):.3e}, median {float(np.median(list(gaps.values()))):.3e}, max "
              f"{max(gaps.values()):.3e} (tolerance {cs.RING_GRAD_RTOL}), by leaf "
              f"{ {k: round(v, 5) for k, v in gaps.items()} }; {'passes' if passed[fault] else 'fails'} "
              f"[{card}]", flush=True)
    return 0 if passed["sound"] and not any(passed[f] for f in FAULTS[1:]) else 1


if __name__ == "__main__":
    sys.exit(main())
