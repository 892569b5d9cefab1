"""`accelerate-tpu-torch estimate-memory`: a static memory estimate for a
model.

Counterpart of ``accelerate_tpu/commands/estimate.py``, with its flags,
columns and output. Three input forms:

- a registry name (``llama-7b``): the exact count, ``models.param_count``;
- ``params=N``: a raw parameter count;
- a checkpoint path (file or directory): shapes and dtypes from the
  safetensors headers (an 8-byte length and JSON: no tensor byte is read)
  or the ``.npz`` members' headers, sharded or not;
- a HF ``config.json`` (a file, or a directory holding one and no
  weights): mapped to the zoo's ``TransformerConfig``
  (``models.config.config_from_hf_json``), exact with no weights present.

The KV-cache column reads ``serving/kv_cache.py``, the ZeRO and buddy
columns ``parallel/zero.py``. Nothing here touches a card.
"""

from __future__ import annotations

import json
import os
import struct


def register_subcommand(subparsers):
    parser = subparsers.add_parser(
        "estimate-memory", help="Estimate device memory for training/inference of a model"
    )
    parser.add_argument(
        "model_name",
        help="Built-in model name (e.g. llama-7b, bert-base), params=N, or a "
        "checkpoint path (.safetensors/.npz file or directory)",
    )
    parser.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16", "int8"])
    parser.add_argument(
        "--max-seq-len", type=int, default=None,
        help="KV-cache sequence capacity for the inference column "
        "(default: the model config's max_seq_len)",
    )
    parser.add_argument(
        "--batch", type=int, default=1,
        help="Concurrent sequences (serving slots) for the KV-cache estimate",
    )
    parser.add_argument(
        "--page-size", type=int, default=16,
        help="Tokens per KV page for the paged-pool estimate (the serving "
        "engine's default layout); the dense slab is printed for comparison",
    )
    parser.add_argument(
        "--replicas", type=int, default=8,
        help="Data-parallel replicas for the ZeRO column: optimizer state + "
        "gradient bytes PER CHIP when the update is sharded (the default "
        "training path on a multi-chip mesh)",
    )
    parser.add_argument(
        "--elastic-redundancy", type=int, default=0, choices=(0, 1), metavar="N",
        help="Buddy copies per ZeRO shard for elastic training "
        "(resilience/elastic.py): adds a per-chip column pricing the mirror "
        "(params + optimizer state, 1/replicas each) that lets a host loss "
        "recover in-memory instead of from checkpoint. 0 or 1 — the runtime "
        "supports a single buddy roll (ElasticConfig rejects more)",
    )
    parser.set_defaults(func=run)
    return parser


# safetensors dtype tags and numpy dtype names → bytes per element
_STORED_DTYPE_BYTES = {
    "F64": 8, "F32": 4, "F16": 2, "BF16": 2, "I64": 8, "I32": 4, "I16": 2,
    "I8": 1, "U8": 1, "BOOL": 1,
    "float64": 8, "float32": 4, "float16": 2, "bfloat16": 2, "int64": 8,
    "int32": 4, "int16": 2, "int8": 1, "uint8": 1, "bool": 1,
}


def _safetensors_entries(path: str) -> dict[str, tuple[tuple, str]]:
    """{tensor name: (shape, dtype tag)} from the header only."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return {
        k: (tuple(v["shape"]), v["dtype"]) for k, v in header.items() if k != "__metadata__"
    }


def _npz_entries(path: str) -> dict[str, tuple[tuple, str]]:
    """{name: (shape, dtype)} from each zip member's .npy header."""
    import zipfile

    from numpy.lib import format as npf

    out = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            with z.open(name) as f:
                version = npf.read_magic(f)
                if version == (1, 0):
                    shape, _, dtype = npf.read_array_header_1_0(f)
                else:
                    shape, _, dtype = npf.read_array_header_2_0(f)
            key = name[:-4] if name.endswith(".npy") else name
            out[key] = (shape, dtype.name)
    return out


def checkpoint_entries(path: str) -> dict[str, tuple[tuple, str]]:
    """Tensor shapes/dtypes for a checkpoint file or directory, header-only."""
    if os.path.isfile(path):
        files = [path]
    else:
        names = sorted(os.listdir(path))
        # prefer index-listed shards (canonical), else every weights file
        indexed: set[str] = set()
        for name in names:
            if name.endswith(".index.json"):
                with open(os.path.join(path, name)) as f:
                    indexed.update(json.load(f).get("weight_map", {}).values())
        chosen = sorted(indexed) if indexed else [
            n for n in names if n.endswith((".safetensors", ".npz"))
        ]
        files = [os.path.join(path, n) for n in chosen]
    if not files:
        raise FileNotFoundError(f"No .safetensors/.npz weights under {path!r}")
    entries: dict[str, tuple[tuple, str]] = {}
    for f in files:
        entries.update(_npz_entries(f) if f.endswith(".npz") else _safetensors_entries(f))
    return entries


_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "int4": 0.5, "fp8": 1}


def _convert_bytes(size: float) -> str:
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if size < 1024:
            return f"{size:.2f} {unit}"
        size /= 1024
    return f"{size:.2f} PB"


def count_params(model_name: str) -> int:
    if model_name.startswith("params="):
        return int(float(model_name.split("=", 1)[1]))
    from ..models import get_config, param_count

    return param_count(get_config(model_name))


def _config_json_path(path: str) -> str | None:
    """The config.json to estimate from, when the path is config-only."""
    if os.path.isfile(path):
        return path if path.endswith(".json") else None
    candidate = os.path.join(path, "config.json")
    has_weights = any(
        name.endswith((".safetensors", ".npz")) for name in os.listdir(path)
    )
    # weights present → the header route is exact for the actual checkpoint
    return candidate if os.path.exists(candidate) and not has_weights else None


def run(args) -> int:
    config = None  # set when the input names a known geometry → KV estimate
    config_json = _config_json_path(args.model_name) if os.path.exists(args.model_name) else None
    if config_json is not None:
        from ..models.config import config_from_hf_json, param_count

        config = config_from_hf_json(config_json)
        n = param_count(config)
        print(
            f"Config: {config_json} — arch {config.arch}, "
            f"{config.num_layers} layers, hidden {config.hidden_size}, "
            f"{n:,} parameters ({n / 1e9:.2f}B)"
        )
    elif os.path.exists(args.model_name):
        entries = checkpoint_entries(args.model_name)
        import numpy as np

        n = sum(int(np.prod(shape)) for shape, _ in entries.values())
        stored = sum(
            int(np.prod(shape)) * _STORED_DTYPE_BYTES.get(dtype, 4)
            for shape, dtype in entries.values()
        )
        largest_key, (largest_shape, largest_dtype) = max(
            entries.items(), key=lambda kv: int(np.prod(kv[1][0]))
        )
        print(
            f"Checkpoint: {args.model_name} — {len(entries)} tensors, "
            f"{n:,} parameters, {_convert_bytes(stored)} stored"
        )
        print(f"Largest tensor: {largest_key} {list(largest_shape)} {largest_dtype}")
    else:
        n = count_params(args.model_name)
        if not args.model_name.startswith("params="):
            from ..models import get_config

            config = get_config(args.model_name)
        print(f"Model: {args.model_name} — {n / 1e9:.2f}B parameters")

    # KV cache for serving: without it, serve sizing is silently off by
    # 2·L·KV·D·S·B bytes per replica — often the difference between a model
    # "fitting" and OOMing the moment slots fill. The decoder-only formula
    # covers the archs the serving engine decodes (llama/gpt2); bert has no
    # decode cache and t5's per-stack layers + cross-attention cache need a
    # different formula, so both are skipped LOUDLY rather than printed
    # wrong. The cache dtype follows the compute dtype (weight-only int8/int4
    # still decode with a bf16 cache).
    kv_batch = getattr(args, "batch", None) or 1
    kv_seq = getattr(args, "max_seq_len", None)
    kv_page = getattr(args, "page_size", None) or 16
    kv_fn = None
    if config is not None and config.arch in ("llama", "gpt2"):
        from ..serving.kv_cache import kv_cache_bytes, paged_kv_cache_bytes

        kv_seq = kv_seq or config.max_seq_len
        dense_fn = lambda dtype_bytes: kv_cache_bytes(config, kv_batch, kv_seq, dtype_bytes)  # noqa: E731
        # the serving engine pages by default, so the +kv column prices the
        # paged pool (+ its int32 page tables); the dense slab stays printed
        # for comparison — at capacity parity the pool costs one extra (null)
        # page, and the savings come from provisioning below parity for the
        # observed working set (bench: serving_paged_hbm_bytes_per_req)
        kv_fn = lambda dtype_bytes: sum(  # noqa: E731
            paged_kv_cache_bytes(
                config, kv_batch, kv_seq, page_size=kv_page, dtype_bytes=dtype_bytes
            )
        )
        pool, table = paged_kv_cache_bytes(config, kv_batch, kv_seq, page_size=kv_page)
        print(
            f"KV cache (batch={kv_batch}, seq={kv_seq}): "
            f"{_convert_bytes(dense_fn(2))} bf16 / {_convert_bytes(dense_fn(4))} fp32 "
            f"dense slab"
        )
        print(
            f"Paged KV (page_size={kv_page}, capacity parity): pool "
            f"{_convert_bytes(pool)} + page tables {_convert_bytes(table)} bf16 — "
            f"a request only holds pages for tokens it produced"
        )
    elif kv_seq is not None:
        reason = (
            "needs a model config (registry name or config.json)"
            if config is None
            else f"decoder-only formula does not cover arch {config.arch!r}"
        )
        print(f"KV cache: {reason}, skipping")

    # ZeRO column: the sharded update (parallel/zero.py — the default training
    # path on a multi-chip mesh) holds 1/N of the optimizer state and reduced
    # gradient per chip, so the train budget that used to be 4 bytes/param of
    # state per chip becomes 12/N + params — visible here BEFORE anyone runs a
    # step, same as the KV column prices serving.
    from ..parallel.zero import elastic_redundancy_bytes, zero_update_state_bytes

    replicas = max(int(getattr(args, "replicas", 1) or 1), 1)
    redundancy = max(int(getattr(args, "elastic_redundancy", 0) or 0), 0)
    show_elastic = replicas > 1 and redundancy > 0
    zero_col = f" | {f'+adam/chip @{replicas} (ZeRO)':>22}" if replicas > 1 else ""
    # the buddy-mirror column sits NEXT TO the ZeRO column it duplicates:
    # elastic redundancy is priced as extra bytes on top of the sharded state
    elastic_col = f" | {f'+buddy/chip x{redundancy}':>16}" if show_elastic else ""
    kv_col = f" | {'+kv (serve)':>12}" if kv_fn is not None else ""
    header = f"{'dtype':>10} | {'params':>10} | {'+grads':>10} | {'+adam (train)':>14}{zero_col}{elastic_col}{kv_col}"
    print(header)
    print("-" * len(header))
    for dtype in args.dtypes:
        b = _DTYPE_BYTES[dtype]
        params = n * b
        # grads stored in the same dtype; Adam keeps two fp32 moments + fp32 master params
        train = params + n * b + n * 4 * 3
        row = f"{dtype:>10} | {_convert_bytes(params):>10} | {_convert_bytes(params * 2):>10} | {_convert_bytes(train):>14}"
        if replicas > 1:
            opt_chip, grad_chip = zero_update_state_bytes(n, b, replicas)
            # params are stored sharded too under ZeRO, but the forward
            # gathers them, so the per-chip working set still prices them full
            row += f" | {_convert_bytes(params + grad_chip + opt_chip):>22}"
        if show_elastic:
            row += f" | {_convert_bytes(elastic_redundancy_bytes(n, b, replicas, redundancy)):>16}"
        if kv_fn is not None:
            serve = params + kv_fn(4 if dtype == "float32" else 2)
            row += f" | {_convert_bytes(serve):>12}"
        print(row)
    if replicas > 1:
        print(
            f"ZeRO column: optimizer state (12 B/param fp32) and gradients "
            f"sharded 1/{replicas} per chip; reduce-scatter -> sharded adamw "
            f"-> all-gather (docs/performance.md)"
        )
    if show_elastic:
        print(
            f"Buddy column: {redundancy} mirror(s) of each chip's 1/{replicas} "
            f"param + optimizer shard on a different host — a host loss "
            f"recovers in-memory via the elastic ladder (docs/resilience.md)"
        )
    elif redundancy > 0:
        # asked-for but unpriceable: say so instead of dropping the column
        print(
            "Elastic redundancy: needs --replicas N > 1 (the buddy mirrors "
            "1/N ZeRO shards; with one replica there is nothing sharded to "
            "mirror) — column skipped"
        )
    return 0
