#!/usr/bin/env python3
"""This checkout of the PyTorch/CUDA port against another one, on one GPU.

Run from the repository root: ``python3 chip_compare.py OTHER_ROOT``, where
OTHER_ROOT is another checkout (say, the parent commit unpacked with ``git
archive``). Each tree runs in a process of its own, in the order other,
this, this, other, so that a drift of the card shows as a difference
between the two runs of one tree. Each run builds its kernels, times the
whole flash attention backward as autograd runs it (``torch.autograd.grad``
through the flash function, bf16, at ``chip_smoke.FLASH_GEOMETRIES``, one
JSON line each) and runs ``chip_smoke.phase_training`` (the bf16 llama-125m
step at B=32 S=1024 and B=8 S=4096). It needs a CUDA card and exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def run_one(tag: str) -> None:
    """One tree's measurements, from that tree's root (the current directory)."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from accelerate_tpu_torch.ops import flash_attention as fa

    card = cs.phase_environment()
    rng = np.random.default_rng(cs.SEED)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for name, geometry in cs.FLASH_GEOMETRIES.items():
        c = cs.flash_case(rng, geometry, torch.bfloat16)
        leaves = [c[n].detach().clone().requires_grad_() for n in "qkv"]
        out = fa._FlashAttention.apply(*leaves, c["mask"], c["limit"], c["causal"], c["scale"])
        ms = cs.time_ms(lambda: torch.autograd.grad(out, leaves, c["do"], retain_graph=True), flush, iters=20)
        print(json.dumps({"tree": tag, "geometry": name, "backward_ms": ms, "card": card}), flush=True)
        del c, leaves, out
        torch.cuda.empty_cache()
    cs.phase_training(card)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    trees = {"other": os.path.abspath(sys.argv[1]), "this": os.path.dirname(os.path.abspath(__file__))}
    for tag in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tag], cwd=trees[tag],
                              capture_output=True, text=True)
        print(f"[compare] {tag} ({trees[tag]}): exit {proc.returncode}", flush=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.startswith(("{", "[train]", "[env] device", "Traceback")) or "Error" in line:
                print(line, flush=True)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
