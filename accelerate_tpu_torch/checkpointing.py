"""Checkpoint save and load of the whole training state.

Counterpart of ``accelerate_tpu/checkpointing.py``, in its on-disk format,
so a checkpoint written by either package resumes in the other::

    model_<i>.safetensors     the params, flattened to "a/b/c" keys
                              (model_<i>.npz where safetensors is missing)
    optimizer_<i>.npz         the optimizer state's leaves ``leaf_<j>`` in
                              optax's leaf order (``utils.params.state_leaves``)
                              and ``__meta__``: the step count, and the fp16
                              loss scale and growth tracker
    scheduler_<i>.json        each prepared scheduler's counter
    random_states_<p>.pkl     the RNG snapshot of process p (utils/random.py)
    custom_checkpoint_<i>.pkl each object registered for checkpointing
    manifest.json             sizes and CRC32s of the files (fault_tolerance.py)

As in the reference, the fp16 loss scale rides in the optimizer's
``__meta__`` (the reference names a ``scaler_<i>.json`` it never writes).
Saves are atomic: staged into ``<dir>.tmp``, committed by a rename after
the manifest is written (``fault_tolerance.py``). The reference's
``atomic=False`` (write in place, no manifest) has no caller in the port and
is left out.

Across processes the unsharded format holds the whole state (gathered:
every process takes part, the main process writes), and ``sharded=True``
writes the JAX package's sharded format: each process writes only the
chunks it holds (``model_<i>.shard<p>.safetensors`` with a
``.index.json`` naming each chunk ``"path@start0,start1,..."`` by its global
offset), so neither side gathers. A leaf split over the tensor axis is
written as this process's slice; gpt2's fused ``wqkv``, whose process holds
the q, k and v columns of its heads, as three chunks, one a block. Either format loads into any number of
processes, and into the JAX package on any mesh, since the chunks carry
their offsets. A load first crosses the chaos harness's I/O probe
(``resilience.chaos.probe_io``): an injected transient ``EIO`` rides the
caller's retry policy (``CheckpointManager.resume`` wraps a load at one
process).
"""

from __future__ import annotations

import glob
import json
import os
import pickle
import re
import shutil
from typing import Optional

import numpy as np
import torch

from .logging import get_logger
from .ops.operations import to_numpy
from .state import PartialState
from .utils.constants import CHECKPOINT_DIR_PREFIX
from .utils.params import host_tensor, state_leaves, state_paths, state_unflatten, tree_leaves, tree_paths
from .utils.random import restore_rng_state, rng_state

logger = get_logger(__name__)

MODEL_FILE = "model_{i}.safetensors"
OPTIMIZER_FILE = "optimizer_{i}.npz"
OPTIMIZER_SHARDED_FILE = "optimizer_{i}.safetensors"
OPTIMIZER_META_FILE = "optimizer_{i}.meta.json"
SCHEDULER_FILE = "scheduler_{i}.json"
RNG_FILE = "random_states_{p}.pkl"
CUSTOM_FILE = "custom_checkpoint_{i}.pkl"


def flatten_params(params: dict) -> dict[str, np.ndarray]:
    """A param tree as ``{"a/b/c": host numpy}``."""
    return {path: to_numpy(leaf) for path, leaf in tree_paths(params)}


@torch.no_grad()
def unflatten_into(params: dict, flat: dict[str, np.ndarray]) -> dict:
    """Copy ``flat``'s values into the tensors of ``params``, in place (a
    prepared model's params are its module's own parameters, which the
    optimizer holds too), each cast to its tensor's dtype. Raises
    ``KeyError`` for a missing path and ``ValueError`` for a shape."""
    for path, leaf in tree_paths(params):
        if path not in flat:
            raise KeyError(f"checkpoint missing parameter {path!r}")
        value = np.asarray(flat[path])
        if value.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {path}: checkpoint {value.shape} vs model {tuple(leaf.shape)}")
        leaf.copy_(host_tensor(value).to(leaf.dtype))
    return params


# ---------------------------------------------------------------------------
# model weights (shard files and their index)
# ---------------------------------------------------------------------------


def _parse_size(size: str | int) -> int:
    if isinstance(size, int):
        return size
    match = re.fullmatch(r"(\d+(?:\.\d+)?)\s*([KMGT]?B)", size.strip(), re.IGNORECASE)
    if not match:
        raise ValueError(f"Cannot parse size {size!r}")
    mult = {"B": 1, "KB": 2**10, "MB": 2**20, "GB": 2**30, "TB": 2**40}[match.group(2).upper()]
    return int(float(match.group(1)) * mult)


def has_safetensors() -> bool:
    try:
        import safetensors.numpy  # noqa: F401
    except ImportError:
        return False
    return True


def _save_flat(flat: dict[str, np.ndarray], path: str, safe_serialization: bool = True) -> None:
    """Write ``flat`` as safetensors, or as the ``.npz`` sibling where
    safetensors is not installed or not asked for."""
    if safe_serialization and has_safetensors():
        from safetensors.numpy import save_file

        save_file(flat, path)
    else:
        np.savez(path.replace(".safetensors", ".npz"), **flat)


def _load_flat(path: str) -> dict[str, np.ndarray]:
    if path.endswith(".safetensors"):
        # the writer falls back to .npz without safetensors: so does the reader
        npz_sibling = path.replace(".safetensors", ".npz")
        if os.path.exists(path):
            from safetensors.numpy import load_file

            return load_file(path)
        if not os.path.exists(npz_sibling):
            raise FileNotFoundError(f"Neither {path} nor {npz_sibling} exists")
        path = npz_sibling
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def save_model_weights(
    params: dict,
    save_directory: str,
    max_shard_size: str | int = "10GB",
    safe_serialization: bool = True,
    weights_name: str = "model.safetensors",
) -> None:
    """Write a model's weights (whole: the main process writes), split into
    files of at most ``max_shard_size`` with an
    ``<weights_name>.index.json`` when one file would be larger."""
    state = PartialState()
    flat = flatten_params(params)
    if not state.is_main_process:
        state.wait_for_everyone()
        return
    os.makedirs(save_directory, exist_ok=True)
    limit = _parse_size(max_shard_size)
    shards: list[dict[str, np.ndarray]] = [{}]
    sizes = [0]
    for key, value in flat.items():
        if sizes[-1] + value.nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = value
        sizes[-1] += value.nbytes
    if len(shards) == 1:
        _save_flat(shards[0], os.path.join(save_directory, weights_name), safe_serialization)
    else:
        base, ext = os.path.splitext(weights_name)
        weight_map = {}
        for i, shard in enumerate(shards):
            shard_name = f"{base}-{i + 1:05d}-of-{len(shards):05d}{ext}"
            _save_flat(shard, os.path.join(save_directory, shard_name), safe_serialization)
            for key in shard:
                weight_map[key] = shard_name
        index = {"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}
        with open(os.path.join(save_directory, f"{weights_name}.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    state.wait_for_everyone()


def _chunk_key(path: str, start: tuple[int, ...]) -> str:
    return f"{path}@{','.join(map(str, start))}"


def _save_chunks(entries: list, save_directory: str, weights_name: str, safe_serialization: bool,
                 layout=None) -> None:
    """Write this process's chunks of ``(path, leaf, spec)`` entries (each
    leaf this process's shard under ``layout``, or whole without one) and
    their index, in the JAX package's sharded format."""
    state = PartialState()
    os.makedirs(save_directory, exist_ok=True)
    proc = state.process_index
    chunks: dict[str, np.ndarray] = {}
    tensors: dict[str, dict] = {}
    for path, leaf, spec in entries:
        value = to_numpy(leaf)
        if layout is None:
            shape, pieces, writes = value.shape, [((0,) * value.ndim, value)], state.is_main_process
        else:
            shape, writes = layout.full_shape(value.shape, spec), layout.writes_chunk(spec)
            pieces = layout.chunks(value, spec) if writes else []
        tensors[path] = {"shape": list(shape), "dtype": str(value.dtype)}
        if writes:
            for start, piece in pieces:  # a fused weight split as blocks: a chunk a block
                chunks[_chunk_key(path, start)] = np.array(piece, order="C")  # keeps a scalar 0-d
    base, ext = os.path.splitext(weights_name)
    shard_name = f"{base}.shard{proc:05d}{ext}"
    _save_flat(chunks, os.path.join(save_directory, shard_name), safe_serialization)
    if not safe_serialization or not has_safetensors():
        shard_name = shard_name.replace(".safetensors", ".npz")
    index = {
        "metadata": {"format": "accelerate-tpu-sharded", "process": proc},
        "tensors": tensors,
        "chunks": {key: shard_name for key in chunks},
    }
    with open(os.path.join(save_directory, f"{base}.shard{proc:05d}.index.json"), "w") as f:
        json.dump(index, f, indent=2)
    state.wait_for_everyone()


def save_model_weights_sharded(params: dict, save_directory: str, weights_name: str = "model.safetensors",
                               safe_serialization: bool = True, layout=None) -> None:
    """Each process writes only the chunks it holds of the params stored
    under ``layout`` (a ``parallel.zero.ShardedLayout``; None: whole params,
    written by the main process): ``{base}.shard{p:05d}{ext}`` keyed
    ``"path@start"`` and its ``.index.json``. A collective barrier ends it."""
    specs = layout.pspecs if layout is not None else [()] * len(tree_leaves(params))
    entries = [(path, leaf, spec) for (path, leaf), spec in zip(tree_paths(params), specs)]
    _save_chunks(entries, save_directory, weights_name, safe_serialization, layout)


def is_sharded_checkpoint(directory: str, weights_name: str = "model.safetensors") -> bool:
    base, _ = os.path.splitext(weights_name)
    return bool(glob.glob(os.path.join(directory, f"{base}.shard*.index.json")))


def load_model_weights_sharded(directory: str, weights_name: str = "model.safetensors") -> dict[str, np.ndarray]:
    """The flat weights of a sharded checkpoint (the JAX package's
    ``sharded=True``), put together from its chunks, which carry their
    global offsets. Raises where a chunk is missing."""
    base, _ = os.path.splitext(weights_name)
    index_files = sorted(glob.glob(os.path.join(directory, f"{base}.shard*.index.json")))
    if not index_files:
        raise FileNotFoundError(f"No sharded index files for {weights_name} under {directory}")
    tensors: dict[str, dict] = {}
    chunk_files: dict[str, str] = {}
    for index_path in index_files:
        with open(index_path) as f:
            index = json.load(f)
        tensors.update(index["tensors"])
        chunk_files.update(index["chunks"])
    out: dict[str, np.ndarray] = {}
    covered: dict[str, int] = {}
    by_file: dict[str, list[str]] = {}
    for key, fname in chunk_files.items():
        by_file.setdefault(fname, []).append(key)
    for fname, keys in by_file.items():
        data = _load_flat(os.path.join(directory, fname))
        for key in keys:
            path, _, start_s = key.rpartition("@")
            start = tuple(int(s) for s in start_s.split(",")) if start_s else ()
            chunk = data[key]
            if path not in out:
                out[path] = np.empty(tuple(tensors[path]["shape"]), dtype=chunk.dtype)
            if chunk.ndim == 0:
                out[path] = chunk
                covered[path] = covered.get(path, 0) + 1
            else:
                out[path][tuple(slice(o, o + s) for o, s in zip(start, chunk.shape))] = chunk
                covered[path] = covered.get(path, 0) + chunk.size
    incomplete = [
        path for path, meta in tensors.items() if covered.get(path, 0) != max(int(np.prod(meta["shape"])), 1)
    ]
    if incomplete:
        raise FileNotFoundError(
            f"Sharded checkpoint has missing/incomplete chunks for: {sorted(incomplete)[:5]} "
            "(a shard file and its .index.json were likely lost)"
        )
    return out


def load_model_weights(path: str) -> dict[str, np.ndarray]:
    """A flat weight dict from a file, a shard index, or a directory."""
    if os.path.isdir(path):
        for candidate in ("model.safetensors", "model.safetensors.index.json", "model.npz"):
            full = os.path.join(path, candidate)
            if os.path.exists(full):
                path = full
                break
        else:
            raise FileNotFoundError(f"No model weights found under {path}")
    if path.endswith(".index.json"):
        with open(path) as f:
            index = json.load(f)
        directory = os.path.dirname(path)
        flat: dict[str, np.ndarray] = {}
        for shard_name in sorted(set(index["weight_map"].values())):
            flat.update(_load_flat(os.path.join(directory, shard_name)))
        return flat
    return _load_flat(path)


# ---------------------------------------------------------------------------
# the whole accelerator state
# ---------------------------------------------------------------------------


def _resolve_save_dir(accelerator, output_dir: Optional[str]) -> str:
    # no rotation here: old checkpoints go only after the new one is
    # committed, so a kill mid-save never destroys the last good one
    project = accelerator.project_configuration
    if project.automatic_checkpoint_naming:
        base = os.path.join(project.project_dir or output_dir or ".", "checkpoints")
        os.makedirs(base, exist_ok=True)
        target = os.path.join(base, f"{CHECKPOINT_DIR_PREFIX}_{project.iteration}")
        if os.path.exists(target):
            raise ValueError(f"Checkpoint directory {target} already exists: bump project_configuration.iteration.")
        return target
    if output_dir is None:
        raise ValueError("save_state needs output_dir (or automatic_checkpoint_naming).")
    return output_dir


def _remove_stale_format(output_dir: str, sharded: bool, num_models: int, num_optimizers: int) -> None:
    """Saving into a reused directory must leave no file of the other
    format behind: the loader would find it first and restore stale state."""
    doomed: list[str] = []
    for i in range(num_models):
        base, _ = os.path.splitext(MODEL_FILE.format(i=i))
        if sharded:
            doomed += [os.path.join(output_dir, MODEL_FILE.format(i=i)),
                       os.path.join(output_dir, f"{base}.npz")]
            doomed += glob.glob(os.path.join(output_dir, f"{MODEL_FILE.format(i=i)}.index.json"))
        else:
            doomed += glob.glob(os.path.join(output_dir, f"{base}.shard*"))
    for i in range(num_optimizers):
        base, _ = os.path.splitext(OPTIMIZER_SHARDED_FILE.format(i=i))
        if sharded:
            doomed.append(os.path.join(output_dir, OPTIMIZER_FILE.format(i=i)))
        else:
            doomed += glob.glob(os.path.join(output_dir, f"{base}.shard*"))
            doomed.append(os.path.join(output_dir, OPTIMIZER_META_FILE.format(i=i)))
    for path in doomed:
        if os.path.exists(path):
            os.remove(path)


def save_accelerator_state(
    accelerator,
    output_dir: Optional[str] = None,
    safe_serialization: bool = True,
    sharded: bool = False,
    manifest_metadata: Optional[dict] = None,
) -> str:
    """Save the whole accelerator state; returns the checkpoint directory.

    Every file is staged into ``<output_dir>.tmp``, the manifest written
    and only then the directory renamed into place, so a kill at
    any instant leaves the previous checkpoint or the new one, never a torn
    one. Under ``automatic_checkpoint_naming`` with ``total_limit`` the
    rotation runs after the commit. ``manifest_metadata`` (what
    ``CheckpointManager`` passes: step, epoch, loader positions) rides in
    the manifest. Across processes it is a collective: the main process
    stages, writes the shared files and commits; each process writes its
    RNG snapshot, and under ``sharded=True`` its own chunks."""
    from . import fault_tolerance as _ft

    state = PartialState()
    final_dir = _resolve_save_dir(accelerator, output_dir)
    output_dir = _ft.staging_dir_for(final_dir)
    if state.is_main_process:
        if accelerator.project_configuration.automatic_checkpoint_naming:
            _ft.garbage_collect_torn(os.path.dirname(final_dir))
        elif os.path.exists(output_dir):
            shutil.rmtree(output_dir, ignore_errors=True)
    state.wait_for_everyone()
    os.makedirs(output_dir, exist_ok=True)
    logger.info(f"Saving current state to {final_dir} (staged atomically)")

    for hook in accelerator._save_model_hooks:
        hook(accelerator._models, [], output_dir)
    if state.is_main_process:
        _remove_stale_format(output_dir, sharded, len(accelerator._models), len(accelerator._optimizers))
    state.wait_for_everyone()

    for i, model in enumerate(accelerator._models):
        if sharded:
            save_model_weights_sharded(model.params, output_dir, weights_name=MODEL_FILE.format(i=i),
                                       safe_serialization=safe_serialization, layout=model.layout)
        else:
            save_model_weights(model.full_params(), output_dir, safe_serialization=safe_serialization,
                               weights_name=MODEL_FILE.format(i=i))
    for i, optimizer in enumerate(accelerator._optimizers):
        meta = {"step_count": optimizer.step_count}
        if optimizer.scaler is not None:
            meta["scale"] = float(optimizer.scale)
            meta["growth_tracker"] = int(optimizer.growth_tracker)
        if sharded:
            # the moments are the largest sharded state: each process writes its own chunks
            leaves = state_leaves(optimizer.opt_state)
            specs = optimizer.state_specs or [()] * len(leaves)
            entries = list(zip(state_paths(optimizer.opt_state), leaves, specs))
            _save_chunks(entries, output_dir, OPTIMIZER_SHARDED_FILE.format(i=i), safe_serialization,
                         optimizer.layout)
            if state.is_main_process:
                with open(os.path.join(output_dir, OPTIMIZER_META_FILE.format(i=i)), "w") as f:
                    json.dump(meta, f)
        else:
            opt_state = optimizer.state_dict()["opt_state"]  # whole: a collective across processes
            if state.is_main_process:
                arrays = {f"leaf_{j}": to_numpy(leaf) for j, leaf in enumerate(state_leaves(opt_state))}
                arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
                np.savez(os.path.join(output_dir, OPTIMIZER_FILE.format(i=i)), **arrays)
    if state.is_main_process:
        for i, scheduler in enumerate(accelerator._schedulers):
            with open(os.path.join(output_dir, SCHEDULER_FILE.format(i=i)), "w") as f:
                json.dump(scheduler.state_dict(), f)
        for i, obj in enumerate(accelerator._custom_objects):
            with open(os.path.join(output_dir, CUSTOM_FILE.format(i=i)), "wb") as f:
                pickle.dump(obj.state_dict(), f)
    with open(os.path.join(output_dir, RNG_FILE.format(p=state.process_index)), "wb") as f:
        pickle.dump(rng_state(), f)
    state.wait_for_everyone()

    if state.is_main_process:
        _ft._run_fault_hook("staged", output_dir)
        metadata = dict(manifest_metadata or {})
        metadata["sharded"] = sharded
        _ft.write_manifest(output_dir, _ft.build_manifest(output_dir, step=metadata.get("step"), metadata=metadata))
        _ft._run_fault_hook("manifest", output_dir)
        _ft.commit_checkpoint(output_dir, final_dir)
    state.wait_for_everyone()

    project = accelerator.project_configuration
    if project.automatic_checkpoint_naming:
        project.iteration += 1
        if state.is_main_process and project.total_limit is not None:
            existing = _ft.list_checkpoints(os.path.dirname(final_dir))
            for stale in existing[: max(len(existing) - project.total_limit, 0)]:
                logger.info(f"Deleting {stale} to respect total_limit={project.total_limit}")
                shutil.rmtree(stale, ignore_errors=True)
        state.wait_for_everyone()
    return final_dir


@torch.no_grad()
def _load_params(model, flat: dict[str, np.ndarray]) -> None:
    """Whole weights into a prepared model: into its params, or, where its
    layout stores them split, each process's shard."""
    layout = model.layout
    if layout is None or not layout.shards_params:
        unflatten_into(model.params, flat)
        return
    from .parallel.zero import shard_of

    for (path, leaf), spec in zip(tree_paths(model.params), layout.pspecs):
        if path not in flat:
            raise KeyError(f"checkpoint missing parameter {path!r}")
        full = host_tensor(flat[path])
        leaf.copy_(shard_of(full, spec, layout.mesh).to(leaf.dtype))


def load_accelerator_state(
    accelerator,
    input_dir: Optional[str] = None,
    load_kwargs: Optional[dict] = None,  # noqa: ARG001 - parity
    check_checksums: bool = True,
) -> None:
    """Restore a checkpoint of either package. ``input_dir="auto"`` takes the
    newest checkpoint under the project's ``checkpoints`` directory whose
    manifest verifies (``check_checksums=False`` checks sizes only);
    ``None`` takes the newest one under automatic naming."""
    from .fault_tolerance import latest_valid_checkpoint, list_checkpoints

    state = PartialState()
    project = accelerator.project_configuration
    if input_dir == "auto":
        base = os.path.join(project.project_dir or ".", "checkpoints")
        input_dir = latest_valid_checkpoint(base, check_checksums=check_checksums)
        if input_dir is None:
            raise FileNotFoundError(f"No valid checkpoint under {base} for resume='auto'")
    elif input_dir is None:
        if not project.automatic_checkpoint_naming:
            raise ValueError("load_state needs input_dir (or automatic_checkpoint_naming).")
        base = os.path.join(project.project_dir or ".", "checkpoints")
        checkpoints = list_checkpoints(base)
        if not checkpoints:
            raise FileNotFoundError(f"No checkpoints under {base}")
        input_dir = checkpoints[-1]
    logger.info(f"Loading states from {input_dir}")
    from .resilience.chaos import probe_io

    probe_io("checkpoint_load")

    for hook in accelerator._load_model_hooks:
        hook(accelerator._models, input_dir)

    for i, model in enumerate(accelerator._models):
        weights_name = MODEL_FILE.format(i=i)
        if is_sharded_checkpoint(input_dir, weights_name):
            flat = load_model_weights_sharded(input_dir, weights_name)
        else:
            index = os.path.join(input_dir, f"{weights_name}.index.json")
            flat = load_model_weights(index if os.path.exists(index) else os.path.join(input_dir, weights_name))
        _load_params(model, flat)
    for i, optimizer in enumerate(accelerator._optimizers):
        if is_sharded_checkpoint(input_dir, OPTIMIZER_SHARDED_FILE.format(i=i)):
            flat = load_model_weights_sharded(input_dir, OPTIMIZER_SHARDED_FILE.format(i=i))
            leaves = [flat[path] for path in state_paths(optimizer.opt_state)]
            with open(os.path.join(input_dir, OPTIMIZER_META_FILE.format(i=i))) as f:
                meta = json.load(f)
        else:
            with np.load(os.path.join(input_dir, OPTIMIZER_FILE.format(i=i)), allow_pickle=False) as z:
                meta = json.loads(bytes(z["__meta__"]).decode())
                leaves = [z[f"leaf_{j}"] for j in range(len(z.files) - 1)]
        sd = {"opt_state": state_unflatten(optimizer.opt_state, leaves), "step_count": meta["step_count"]}
        if "scale" in meta:
            sd["scale"] = meta["scale"]
            sd["growth_tracker"] = meta["growth_tracker"]
        optimizer.load_state_dict(sd)
    for i, scheduler in enumerate(accelerator._schedulers):
        with open(os.path.join(input_dir, SCHEDULER_FILE.format(i=i))) as f:
            scheduler.load_state_dict(json.load(f))
    for i, obj in enumerate(accelerator._custom_objects):
        with open(os.path.join(input_dir, CUSTOM_FILE.format(i=i)), "rb") as f:
            obj.load_state_dict(pickle.load(f))
    rng_path = os.path.join(input_dir, RNG_FILE.format(p=state.process_index))
    if os.path.exists(rng_path):
        with open(rng_path, "rb") as f:
            restore_rng_state(pickle.load(f))
    state.wait_for_everyone()
