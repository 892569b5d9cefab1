#!/usr/bin/env python3
"""This checkout of the PyTorch/CUDA port against another one, on one GPU.

Run from the repository root: ``python3 chip_compare.py OTHER_ROOT [PART
...]``, where OTHER_ROOT is another checkout (say, the parent commit
unpacked with ``git archive``) and each PART one of:

- ``paged``: the paged decode and verify kernels in bf16 at
  ``chip_smoke.GEOMETRIES`` (decode, and verify at each of the phase-5
  windows), one JSON line each; a geometry the other tree's kernels refuse
  prints as such;
- ``serving``: one serving pass of phase 3 (llama-1b bf16, 16 requests x 64
  new tokens), its decode step p50 and p99;
- ``flash``: the flash forward, dq and dk/dv kernels without a bias, each
  alone, and the whole backward as autograd runs it (``torch.autograd.grad``
  through the flash function), bf16, at ``chip_smoke.FLASH_GEOMETRIES``;
- ``training``: ``chip_smoke.phase_training`` (the bf16 llama-125m step at
  B=32 S=1024 and B=8 S=4096);
- ``sass``: no timing: both trees' flash sources (``flash_fwd.cu``,
  ``flash_bwd.cu``) compiled to machine code, and every kernel of the other
  tree held against this tree's of the same name (a template argument
  ``false`` that this tree appends, a variant the other lacks, dropped),
  instruction by instruction with constants and addresses masked: one JSON
  line a kernel that differs, and a count of those that do not.

Without a PART it runs the four timed parts. Each tree runs in a process of its own, in
the order other, this, this, other, so that a drift of the card shows as a
difference between the two runs of one tree; both run this tree's
geometries. Each run builds its kernels. It needs a CUDA card and exits
non-zero without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

PARTS = ("paged", "serving", "flash", "training")
SASS_SOURCES = ("flash_fwd", "flash_bwd")


def paged(cs, tag, card, flush, geometries, windows) -> None:
    import numpy as np
    import torch

    from accelerate_tpu_torch import paged_decode_attention, paged_verify_attention

    rng = np.random.default_rng(cs.SEED)
    for name, (slots, nh, kv, d, ps, pps, lengths) in geometries.items():
        for window in [None, *windows.get(name, (cs.SPEC_K + 1, 1))]:
            case = cs.make_case(rng, slots, nh, kv, d, ps, pps, lengths, torch.bfloat16, window=window)
            fn = paged_decode_attention if window is None else paged_verify_attention
            line = {"tree": tag, "kernel": "decode" if window is None else "verify", "geometry": name,
                    "window": window, "card": card}
            try:
                fn(**case)
            except ValueError as err:  # a geometry past what the other tree's kernels take
                print(json.dumps({**line, "unsupported": str(err)}), flush=True)
                continue
            print(json.dumps({**line, "ms": cs.time_ms(lambda: fn(**case), flush)}), flush=True)
            del case
            torch.cuda.empty_cache()


def serving(cs, tag, card) -> None:
    import numpy as np
    import torch

    from accelerate_tpu_torch import Llama, ServingEngine

    model = Llama("llama-1b", dtype=torch.bfloat16, seed=cs.SEED)
    engine = ServingEngine(model, num_slots=8, max_len=1024, page_size=16, prefill_chunk=64)
    engine.warmup()
    for prompt in cs.serving_prompts(np.random.default_rng(cs.SEED), model.config.vocab_size):
        engine.submit(prompt, max_new_tokens=64)
    engine.run()
    m = engine.metrics()
    print(json.dumps({"tree": tag, "serving": "llama-1b bf16", "decode_p50_ms": m["per_token_p50_ms"],
                      "decode_p99_ms": m["per_token_p99_ms"], "steps": m["steps"], "card": card}), flush=True)
    del engine, model
    torch.cuda.empty_cache()


def flash(cs, tag, card, flush) -> None:
    import numpy as np
    import torch

    from accelerate_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(cs.SEED)
    for name, geometry in cs.FLASH_GEOMETRIES.items():
        c = cs.flash_case(rng, geometry, torch.bfloat16)
        leaves = [c[n].detach().clone().requires_grad_() for n in "qkv"]
        # trees before the flash forward became an operator name it _FlashAttention.apply
        attend = getattr(fa, "flash_attention_core", None) or fa._FlashAttention.apply
        out = attend(*leaves, c["mask"], c["limit"], c["causal"], c["scale"])
        ms = cs.time_ms(lambda: torch.autograd.grad(out, leaves, c["do"], retain_graph=True), flush, iters=20)
        args = (c["q"], c["k"], c["v"], c["mask"], c["limit"])
        fwd_out, lse = fa.flash_forward(*args, c["causal"], c["scale"])
        _, delta = fa.flash_backward_dq(*args, c["do"], lse, fwd_out, c["causal"], c["scale"])
        kernels = {
            "fwd_ms": cs.time_ms(lambda: fa.flash_forward(*args, c["causal"], c["scale"]), flush, iters=20),
            "dq_ms": cs.time_ms(lambda: fa.flash_backward_dq(*args, c["do"], lse, fwd_out, c["causal"], c["scale"]),
                                flush, iters=20),
            "dkv_ms": cs.time_ms(lambda: fa.flash_backward_dkv(*args, c["do"], lse, delta, c["causal"], c["scale"]),
                                 flush, iters=20),
        }
        print(json.dumps({"tree": tag, "geometry": name, "backward_ms": ms, **kernels, "card": card}), flush=True)
        del c, leaves, out, fwd_out, lse, delta
        torch.cuda.empty_cache()


def run_one(tag: str, parts: list, shapes: dict) -> None:
    """One tree's measurements, from that tree's root (the current directory)."""
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs

    card = cs.phase_environment()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    if "paged" in parts:
        paged(cs, tag, card, flush, shapes["geometries"], shapes["windows"])
    if "flash" in parts:
        flash(cs, tag, card, flush)
    if "training" in parts:
        cs.phase_training(card)
    if "serving" in parts:  # last: the flash launches of earlier trees fail after a serving pass
        serving(cs, tag, card)


def kernel_sass(cubin: str, cuobjdump: str) -> dict:
    """``{kernel name and template arguments: [instructions]}`` of a cubin,
    NOPs dropped, constants and addresses masked."""
    import re

    listing = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in listing.splitlines():
        found = re.match(r"\s+Function : (\S+)", line)
        if found:
            # the identifier after its length prefix, and its int and bool template arguments
            ident = re.search(r"\d((?:flash|dbias)\w*?_kernel)(I(?:L[ib]\d+E)+E)?", found.group(1))
            name = ident.group(1) + (ident.group(2) or "")
            out[name] = []
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "", line).strip()
            if not ins.startswith("NOP"):
                out[name].append(re.sub(r"0x[0-9a-f]+", "#", ins))
    return out


def sass(other_root: str) -> None:
    """Each flash kernel's machine code in both trees (``sass`` above)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from accelerate_tpu_torch.ops.runtime import NVCC_FLAGS, _nvcc

    roots = {"other": other_root, "this": os.path.dirname(os.path.abspath(__file__))}
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        def build(job):
            tag, name = job
            cubin = os.path.join(tmp, f"{tag}_{name}.cubin")
            source = os.path.join(roots[tag], "accelerate_tpu_torch", "csrc", f"{name}.cu")
            subprocess.run([_nvcc(), *flags, "-cubin", "-o", cubin, source], check=True)
            return kernel_sass(cubin, cuobjdump)

        jobs = [(tag, name) for tag in roots for name in SASS_SOURCES]
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(zip(jobs, pool.map(build, jobs)))
    for name in SASS_SOURCES:
        other, this = built[("other", name)], built[("this", name)]
        same, matched = 0, set()
        for kernel, code in sorted(other.items()):
            match = kernel
            while match not in this and match.endswith("EE") and match.count("Lb0E") < 4:
                match = match[:-1] + "Lb0EE"  # this tree appends a template argument `false`
            mine = this.get(match)
            matched.add(match)
            if mine == code:
                same += 1
                continue
            differing = None if mine is None else sum(a != b for a, b in zip(code, mine)) + abs(len(code) - len(mine))
            print(json.dumps({"source": f"{name}.cu", "kernel": kernel, "this": match, "other_instructions": len(code),
                              "this_instructions": None if mine is None else len(mine), "differing": differing}),
                  flush=True)
        print(json.dumps({"source": f"{name}.cu", "identical": same, "of": len(other),
                          "this_only": sorted(set(this) - matched)}), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--one":
        run_one(sys.argv[2], sys.argv[3].split(","), json.loads(sys.argv[4]))
        return 0
    parts = sys.argv[2:] or list(PARTS)
    if len(sys.argv) < 2 or any(p not in (*PARTS, "sass") for p in parts):
        print(__doc__, file=sys.stderr)
        return 2
    if "sass" in parts:
        sass(os.path.abspath(sys.argv[1]))
        parts = [p for p in parts if p != "sass"]
        if not parts:
            return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke  # this tree's geometries, measured on both trees

    shapes = json.dumps({"geometries": chip_smoke.GEOMETRIES, "windows": chip_smoke.WINDOWS})
    trees = {"other": os.path.abspath(sys.argv[1]), "this": os.path.dirname(os.path.abspath(__file__))}
    for tag in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", tag, ",".join(parts), shapes],
                              cwd=trees[tag], capture_output=True, text=True)
        print(f"[compare] {tag} ({trees[tag]}): exit {proc.returncode}", flush=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            if line.startswith(("{", "[train]", "[env] device", "Traceback")) or "Error" in line:
                print(line, flush=True)
        if proc.returncode != 0:
            print("\n".join(proc.stderr.splitlines()[-30:]), flush=True)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
