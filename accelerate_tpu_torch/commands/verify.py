"""`accelerate-tpu-torch verify-checkpoint <dir>`: offline checkpoint
validation and repair.

Counterpart of ``accelerate_tpu/commands/verify.py``, over the port's
``fault_tolerance.py``; the two packages share the checkpoint format, so
either command judges either package's checkpoints alike. A checkpoint
directory is checked against its ``manifest.json`` (completeness, each
file's size, CRC32 checksums) without a card. ``<dir>`` is one checkpoint
(it holds a manifest) or a base directory (every ``checkpoint_<n>`` in it
is checked). Exit code 0: everything checked is complete and resumable; 1
lists every problem found.

``--repair`` cleans up as well: torn ``*.tmp`` staging directories are
removed and checkpoints that fail verification are pruned (auto-resume
skips them already), printing what went. The newest valid checkpoint is
never touched.
"""

from __future__ import annotations

import os
import shutil
import sys


def register_subcommand(subparsers):
    parser = subparsers.add_parser(
        "verify-checkpoint",
        help="Validate (and optionally repair) checkpoint dirs offline (sizes + checksums)",
    )
    parser.add_argument(
        "checkpoint_dir",
        help="One checkpoint directory (contains manifest.json) or a base dir of checkpoint_<n> dirs",
    )
    parser.add_argument(
        "--no-checksums",
        action="store_true",
        help="Skip CRC32 verification (sizes/completeness only — fast on huge checkpoints)",
    )
    parser.add_argument(
        "--repair",
        action="store_true",
        help="GC torn *.tmp staging dirs and prune checkpoints that fail verification "
        "(prints what was removed)",
    )
    parser.set_defaults(func=run)
    return parser


def _verify_one(directory: str, check_checksums: bool, problems=None) -> int:
    from ..fault_tolerance import read_manifest, verify_checkpoint

    if problems is None:
        problems = verify_checkpoint(directory, check_checksums=check_checksums)
    if problems:
        for problem in problems:
            print(f"FAIL {directory}: {problem}", file=sys.stderr)
        return 1
    manifest = read_manifest(directory) or {}
    files = manifest.get("files", {})
    total = sum(meta.get("size", 0) for meta in files.values())
    step = manifest.get("step")
    detail = f"{len(files)} files, {total / 2**20:.1f} MiB"
    if step is not None:
        detail += f", step {step}"
    print(f"OK {directory}: {detail}")
    return 0


def run(args) -> int:
    from ..fault_tolerance import (
        garbage_collect_torn,
        list_checkpoints,
        verify_checkpoint,
    )
    from ..utils.constants import CHECKPOINT_MANIFEST_NAME

    base = args.checkpoint_dir
    check = not args.no_checksums
    is_single = os.path.exists(os.path.join(base, CHECKPOINT_MANIFEST_NAME))
    targets = [base] if is_single else list_checkpoints(base)

    verified_clean = False
    if args.repair:
        removed = []
        # torn staging debris first (never shadows valid checkpoints, but
        # wastes space and confuses `ls`-level ops). abspath: a relative
        # single-checkpoint arg must not dirname down to "" and skip the GC
        gc_base = (
            os.path.dirname(os.path.abspath(base.rstrip(os.sep))) if is_single else base
        )
        removed += garbage_collect_torn(gc_base)
        pruned = []
        for path in targets:
            problems = verify_checkpoint(path, check_checksums=check)
            if problems:
                shutil.rmtree(path, ignore_errors=True)
                pruned.append((path, problems))
        for path in removed:
            print(f"REMOVED torn staging dir {path}")
        for path, problems in pruned:
            print(f"PRUNED invalid checkpoint {path}: {problems[0]}"
                  + (f" (+{len(problems) - 1} more)" if len(problems) > 1 else ""))
        if not removed and not pruned:
            print(f"REPAIR {base}: nothing to remove")
        doomed = {path for path, _ in pruned}
        targets = [path for path in targets if path not in doomed]
        verified_clean = True  # every survivor passed the repair pass's verify

    if not targets:
        if args.repair:
            return 0
        print(f"FAIL {base}: no checkpoints found", file=sys.stderr)
        return 1
    worst = 0
    for path in targets:
        # after a repair pass, survivors verified clean moments ago — report
        # without re-reading (CRC'ing multi-GB checkpoints twice is real I/O)
        worst = max(worst, _verify_one(path, check, problems=[] if verified_clean else None))
    return worst
