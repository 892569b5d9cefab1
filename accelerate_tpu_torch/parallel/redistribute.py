"""One redistribution primitive for every recovery path, across processes.

Counterpart of ``accelerate_tpu/parallel/redistribute.py`` on
``torch.distributed``. A sharded leaf lives as one shard tensor on each
process; where the JAX package reads a sharding's device-to-index map, the
port reads a :class:`ProcessSharding`: the member (a process's identity:
its rank in the job as it was started) at each position of the mesh, the
mesh's axis sizes and the leaf's spec (``parallel/sharding.py``). Moving a
tree from one layout to another (a shrink onto the survivors of a lost
host, a regrow onto a returning one, a new factoring of the batch axes) is
the same problem on every path, and this module is its one solution:

- **Planned, then executed.** :func:`plan_redistribute` reads shapes,
  dtypes and shardings only, never shard data (meta tensors plan as well as
  real ones), and decides the whole transfer before a byte moves: the rung
  (the staged exchange, or the host relay), each leaf's kind (``identity``,
  ``collective_permute``, ``all_to_all``, ``device_put``, as the JAX plan
  names them from the two maps), and the chunks that keep every stage under
  ``RedistributeConfig(max_scratch_bytes=)``. Lost members, or a buddy
  copy to merge, select the relay, whose plan step is the coverage verdict
  (:func:`tree_covered`) the elastic ladder keys on.
- **The staged rung** moves, stage by stage (a slab of a leaf along its
  largest dim), only the boxes each process's new shard needs from the
  shards that hold them: point-to-point sends between the members (staged
  through host copies where gloo carries CUDA tensors,
  ``parallel/compat.py``), a local copy where a process already holds the
  box. A stage's messages are its scratch.
- **The host relay** puts each leaf together whole in host memory on every
  member, one leaf at a time (each source region broadcast once by the
  first live process that holds it, its primary or its buddy copy), and
  cuts the new shard out of it: the rung that stitches a buddy copy in
  after a loss, and the staged rung's fallback.
- **Transactional.** Nothing is donated: every new shard is a new
  contiguous tensor (the fused adamw kernel updates each shard leaf in
  place), and the source stays intact until the whole tree and the epoch
  fence pass. A stage killed by the chaos plan (``redistribute_fail_at``,
  ``redistribute_fail_stage``) falls to the relay, or fails naming the
  stage under ``force_path="staged"``.
- **Epoch-fenced.** :class:`EpochFence` re-reads the membership store at
  plan time and at commit: a transfer planned under an epoch the view has
  left raises ``StaleEpochError`` and its new tensors are dropped.
- **Observable.** Every transfer writes one ``{"kind": "redistribute"}``
  record: rung, stage kinds, bytes moved, peak scratch against the bound,
  wall time, outcome.

Every process of the communication group runs the same plan in the same
order (the plan is deterministic from metadata), so the point-to-point
messages pair up without a handshake. :func:`paged_transfer` is the KV
handoff's leg of the same primitive: one stage per page.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..logging import get_logger
from ..utils.constants import CANONICAL_MESH_AXES
from .compat import staged
from .sharding import Spec, _entry_axes, _entry_blocks

logger = get_logger(__name__)

# the bound on what one stage holds in flight: 64 MiB, small enough that a
# recovery transfer cannot run the survivors it saves out of memory
DEFAULT_MAX_SCRATCH_BYTES = 64 << 20


class RedistributeError(RuntimeError):
    """A redistribution that could not complete on any rung; the message
    names the failing stage."""


class RedistributeStageFailure(RedistributeError):
    """One stage died mid-transfer (chaos, or a real copy failure). The
    source is intact: the caller decides the fallback."""

    def __init__(self, message: str, *, stage: int, kind: str, leaf: str):
        super().__init__(message)
        self.stage = int(stage)
        self.kind = kind
        self.leaf = leaf


@dataclass(frozen=True)
class RedistributeConfig:
    """Policy for one transfer: ``max_scratch_bytes`` bounds what a stage
    holds in flight; ``force_path`` pins a rung (``"staged"``: a failed
    stage fails the transfer, naming it; ``"relay"``: the host relay only;
    None: the plan decides and the ladder degrades)."""

    max_scratch_bytes: int = DEFAULT_MAX_SCRATCH_BYTES
    force_path: Optional[str] = None  # None | "staged" | "relay"

    def __post_init__(self):
        if self.force_path not in (None, "staged", "relay"):
            raise ValueError(f"force_path must be None, 'staged' or 'relay', got {self.force_path!r}")
        if int(self.max_scratch_bytes) <= 0:
            raise ValueError("max_scratch_bytes must be positive")


@dataclass(frozen=True)
class Stage:
    """One unit of the decomposition; ``index`` is what the chaos leg
    targets. ``chunk`` is the ``(dim, start, size)`` slab of the leaf it
    moves, or None for the whole leaf."""

    index: int
    leaf: str
    kind: str  # identity | collective_permute | all_to_all | device_put | host_relay
    nbytes: int
    chunk: Optional[tuple[int, int, int]] = None


@dataclass
class RedistributePlan:
    """The decomposition, decided from metadata before a byte moves;
    ``covered`` (the relay rung) is the coverage verdict."""

    rung: str  # "staged" | "host_relay"
    reason: str
    stages: list[Stage] = field(default_factory=list)
    num_leaves: int = 0
    total_bytes: int = 0
    peak_scratch_bytes: int = 0
    max_scratch_bytes: int = DEFAULT_MAX_SCRATCH_BYTES
    covered: bool = True

    @property
    def stage_kinds(self) -> dict:
        return dict(Counter(s.kind for s in self.stages))


class EpochFence:
    """The membership zombie fence on a transfer's commit: the epoch the
    transfer was planned under; :meth:`check` re-reads the store and raises
    ``StaleEpochError`` when the view has moved on."""

    def __init__(self, store: Any, epoch: int):
        self.store = store
        self.epoch = int(epoch)

    def check(self) -> None:
        from ..resilience.membership import EPOCH_KEY, StaleEpochError

        current = self.store.read(EPOCH_KEY)
        if current is not None and int(current.get("epoch", 0)) > self.epoch:
            raise StaleEpochError("redistribute/commit", self.epoch, int(current["epoch"]))


# -- where a leaf's shards live ------------------------------------------------------


@dataclass(frozen=True)
class ProcessSharding:
    """A leaf's layout over processes: ``members[i]`` holds the shard of
    mesh position ``i`` (row-major over the canonical axes, data
    outermost: the process index order), ``sizes`` the mesh's axis sizes,
    ``spec`` the leaf's spec. A member is a process's identity that
    outlives a process group (its rank when the job started)."""

    members: tuple
    sizes: tuple  # ((axis, size), ...) over the canonical axes
    spec: Spec

    @classmethod
    def of(cls, members: Sequence[int], sizes: Mapping[str, int], spec: Spec) -> "ProcessSharding":
        full = tuple((axis, int(sizes.get(axis, 1))) for axis in CANONICAL_MESH_AXES)
        if int(np.prod([s for _, s in full])) != len(members):
            raise ValueError(f"{len(members)} members do not fill a mesh of {dict(full)}")
        return cls(tuple(int(m) for m in members), full, tuple(spec))

    @property
    def size_map(self) -> dict:
        return dict(self.sizes)

    def _split(self):
        """``(dim, axes, blocks)`` for each dim the spec splits."""
        sizes = self.size_map
        out = []
        for dim, entry in enumerate(self.spec):
            axes = tuple(a for a in _entry_axes(entry) if sizes.get(a, 1) > 1)
            if axes:
                out.append((dim, axes, _entry_blocks(entry)))
        return out

    def shard_shape(self, shape: tuple) -> tuple:
        sizes = self.size_map
        out = list(shape)
        for dim, axes, blocks in self._split():
            count = int(np.prod([sizes[a] for a in axes]))
            if out[dim] % (count * blocks):
                raise ValueError(f"spec {self.spec} does not divide dim {dim} of {tuple(shape)} over {axes}")
            out[dim] //= count
        return tuple(out)

    def global_shape(self, shard_shape: tuple) -> tuple:
        sizes = self.size_map
        out = list(shard_shape)
        for dim, axes, _ in self._split():
            out[dim] *= int(np.prod([sizes[a] for a in axes]))
        return tuple(out)

    def pieces(self, shape: tuple, position: int) -> tuple:
        """The pieces of the whole leaf mesh position ``position`` holds:
        ``(box, local)`` pairs, ``box`` a ``(start, stop)`` per dim of the
        whole leaf, ``local`` where the piece starts in the shard tensor
        (one piece, or one a block where the spec splits a dim as blocks)."""
        from ..state import rank_coords

        sizes = self.size_map
        self.shard_shape(shape)  # the spec divides the leaf
        coords = rank_coords(position, sizes)
        per_dim = [[((0, n), 0)] for n in shape]
        for dim, axes, blocks in self._split():
            count = int(np.prod([sizes[a] for a in axes]))
            index = 0
            for axis in axes:
                index = index * sizes[axis] + coords[axis]
            block = shape[dim] // blocks
            width = block // count
            per_dim[dim] = [((j * block + index * width, j * block + (index + 1) * width), j * width)
                            for j in range(blocks)]
        return tuple((tuple(b for b, _ in combo), tuple(o for _, o in combo))
                     for combo in itertools.product(*per_dim))

    def indices_map(self, shape: tuple) -> dict:
        """``{member: region}``, a region being the boxes of its pieces: the
        port's ``devices_indices_map``."""
        return {m: tuple(box for box, _ in self.pieces(shape, i)) for i, m in enumerate(self.members)}

    def rolled(self, stride: int) -> "ProcessSharding":
        """The same spec over the member list rolled by ``stride``: the
        buddy layout, each region held one host over."""
        return ProcessSharding(tuple(np.roll(np.asarray(self.members), stride).tolist()), self.sizes, self.spec)


def _nbytes(shape: tuple, dtype: torch.dtype) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def _leaf_covered(shape: tuple, src: ProcessSharding, lost: set, buddy: Optional[ProcessSharding] = None) -> bool:
    """Whether the live holders (primary, and buddy) of a leaf's regions
    tile it: read from the shardings only."""
    needed = set(src.indices_map(shape).values())
    have = set()
    for sharding in (src, buddy):
        if sharding is None:
            continue
        have.update(r for m, r in sharding.indices_map(shape).items() if m not in lost)
    return needed <= have


def tree_covered(shapes: Sequence[tuple], src_shardings: Sequence[ProcessSharding], lost_ids: set,
                 buddy_shardings: Optional[Sequence[ProcessSharding]] = None) -> bool:
    """Whether every leaf survives the loss of ``lost_ids`` (metadata only;
    ``shapes`` are the whole leaves')."""
    buddies = buddy_shardings if buddy_shardings is not None else [None] * len(shapes)
    return all(_leaf_covered(tuple(s), src, set(lost_ids), b) for s, src, b in zip(shapes, src_shardings, buddies))


def _leaf_kind(shape: tuple, src: ProcessSharding, dst: ProcessSharding) -> str:
    """The collective one leaf's relayout is, from the two maps (the JAX
    plan's decomposition)."""
    smap, dmap = src.indices_map(shape), dst.indices_map(shape)
    if smap == dmap:
        return "identity"
    if smap.keys() == dmap.keys():
        if Counter(smap.values()) == Counter(dmap.values()):
            return "collective_permute"  # the same tiling, shards change owners
        return "all_to_all"  # the tiling changes
    if set(smap) & set(dmap):
        return "all_to_all"
    return "device_put"  # disjoint member sets


def _chunk_stages(shape: tuple, nbytes: int, max_scratch: int, dst: Optional[ProcessSharding] = None):
    """The leaf's largest dim cut into slabs of at most ``max_scratch``
    bytes, each a multiple of the destination's tiling of that dim; None
    when the leaf moves whole."""
    if nbytes <= max_scratch or not shape or max(shape) <= 1:
        return None
    axis = int(np.argmax(shape))
    dim = int(shape[axis])
    parts = max(dim // int(dst.shard_shape(tuple(shape))[axis]), 1) if dst is not None else 1
    row_bytes = max(nbytes // dim, 1)
    size = max(int(max_scratch // row_bytes), 1)
    size = max((size // parts) * parts, parts)
    if size >= dim:
        return None
    return [(axis, start, min(size, dim - start)) for start in range(0, dim, size)]


def _global_shapes(leaves: Sequence, src_shardings: Sequence[ProcessSharding]) -> list[tuple]:
    return [src.global_shape(tuple(leaf.shape)) for leaf, src in zip(leaves, src_shardings)]


def plan_redistribute(
    tree: Sequence,
    dst_shardings: Sequence[ProcessSharding],
    *,
    src_shardings: Sequence[ProcessSharding],
    lost_device_ids: "frozenset[int] | set[int]" = frozenset(),
    buddy_shardings: Optional[Sequence[ProcessSharding]] = None,
    config: Optional[RedistributeConfig] = None,
    paths: Optional[Sequence[str]] = None,
) -> RedistributePlan:
    """Decide the transfer of ``tree`` (this process's shard of each leaf:
    only its shape and dtype are read, so meta tensors plan) from
    ``src_shardings`` to ``dst_shardings``. Lost members, or buddy copies
    to stitch in, take the host relay, whose plan step is the coverage
    verdict; a pure relayout takes the staged rung. ``lost_device_ids``
    are members, named as in the JAX plan."""
    config = config or RedistributeConfig()
    leaves = list(tree)
    if len(dst_shardings) != len(leaves) or len(src_shardings) != len(leaves):
        raise ValueError(f"redistribute: {len(leaves)} leaves but {len(src_shardings)} source and "
                         f"{len(dst_shardings)} destination shardings")
    lost = set(lost_device_ids)
    paths = list(paths) if paths is not None else [f"[{i}]" for i in range(len(leaves))]
    shapes = _global_shapes(leaves, src_shardings)
    sizes = [_nbytes(s, leaf.dtype) for s, leaf in zip(shapes, leaves)]
    total = sum(sizes)

    relay_reason = None
    if config.force_path == "relay":
        relay_reason = "forced by config"
    elif lost:
        relay_reason = f"{len(lost)} lost member(s): survivors-only host read"
    elif buddy_shardings is not None:
        relay_reason = "buddy merge: two source copies stitch on host"
    if relay_reason is not None:
        covered = tree_covered(shapes, src_shardings, lost, buddy_shardings)
        stages = [Stage(index=i, leaf=path, kind="host_relay", nbytes=n) for i, (path, n) in enumerate(zip(paths, sizes))]
        return RedistributePlan(rung="host_relay", reason=relay_reason, stages=stages, num_leaves=len(leaves),
                                total_bytes=total, peak_scratch_bytes=max(sizes, default=0),
                                max_scratch_bytes=int(config.max_scratch_bytes), covered=covered)

    stages: list[Stage] = []
    peak = 0
    for path, shape, nbytes, src, dst in zip(paths, shapes, sizes, src_shardings, dst_shardings):
        kind = _leaf_kind(shape, src, dst)
        if kind == "identity":
            continue  # nothing moves; the shard is copied in place of itself
        chunks = _chunk_stages(shape, nbytes, int(config.max_scratch_bytes), dst)
        if chunks is None:
            stages.append(Stage(index=len(stages), leaf=path, kind=kind, nbytes=nbytes))
            peak = max(peak, nbytes)
            continue
        dim = shape[chunks[0][0]]
        for axis, start, size in chunks:
            chunk_bytes = nbytes * size // dim
            stages.append(Stage(index=len(stages), leaf=path, kind=kind, nbytes=chunk_bytes,
                                chunk=(axis, start, size)))
            peak = max(peak, chunk_bytes)
    return RedistributePlan(rung="staged", reason="pure relayout: every source shard readable", stages=stages,
                            num_leaves=len(leaves), total_bytes=total, peak_scratch_bytes=peak,
                            max_scratch_bytes=int(config.max_scratch_bytes))


# -- execution ---------------------------------------------------------------------


def _intersect(a: tuple, b: tuple) -> Optional[tuple]:
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def _local(tensor: torch.Tensor, box: tuple, piece_box: tuple, local: tuple) -> torch.Tensor:
    """The view of ``tensor`` (a shard) holding ``box`` of the whole leaf,
    given the piece it lies in."""
    index = tuple(slice(lo - p0 + o, hi - p0 + o) for (lo, hi), (p0, _), o in zip(box, piece_box, local))
    return tensor[index]


class _Exchange:
    """This process's place among the members of one transfer, and each
    member's rank in the default group."""

    def __init__(self, member: int, rank_of: Optional[Mapping[int, int]], device):
        self.member = int(member)
        self.group = dist.group.WORLD
        self.rank_of = rank_of
        self.device = device

    def rank(self, member: int) -> int:
        return int(self.rank_of[member]) if self.rank_of is not None else int(member)


def _holders(shape, src: ProcessSharding, lost: set, buddy: Optional[ProcessSharding]) -> list:
    """Each distinct source region with its live holders in preference
    order: ``(region, [(member, position, is_buddy), ...])``, regions in
    order of their first position."""
    regions: dict = {}
    for sharding, is_buddy in ((src, False), (buddy, True)):
        if sharding is None:
            continue
        for position, m in enumerate(sharding.members):
            if m in lost:
                continue
            region = tuple(box for box, _ in sharding.pieces(shape, position))
            regions.setdefault(region, []).append((m, position, is_buddy))
    for position in range(len(src.members)):
        region = tuple(box for box, _ in src.pieces(shape, position))
        regions.setdefault(region, [])
    return list(regions.items())


def _staged_leaf(shape, leaf, src, dst, slab, ex: _Exchange, dtype, out: Optional[torch.Tensor], tag0: int):
    """One stage of the staged rung: every box of the slab a member's new
    shard needs, sent by a live holder (or copied, where the member holds
    it); returns the new shard (allocated on first use) and the next tag."""
    me = ex.member
    if out is None and me in dst.members:
        out = torch.empty(dst.shard_shape(shape), dtype=dtype, device=ex.device)
    sends, recvs = [], []
    tag = tag0
    for region, holders in _holders(shape, src, set(), None):
        if not holders:
            raise RedistributeError("internal: a source region with no live holder on the staged rung")
        src_pieces = src.pieces(shape, holders[0][1])
        for j, d in enumerate(dst.members):
            local_holder = next((h for h in holders if h[0] == d), None)
            owner = local_holder or holders[0]
            for (pbox, plocal), (qbox, qlocal) in itertools.product(src_pieces, dst.pieces(shape, j)):
                box = _intersect(pbox, qbox)
                if box is not None and slab is not None:
                    box = _intersect(box, slab)
                if box is None:
                    continue
                tag += 1
                if owner[0] == d:
                    if d == me:
                        _local(out, box, qbox, qlocal).copy_(_local(leaf, box, pbox, plocal))
                elif owner[0] == me:
                    sends.append((_local(leaf, box, pbox, plocal), d, tag))
                elif d == me:
                    recvs.append((_local(out, box, qbox, qlocal), owner[0], tag))
    _post(sends, recvs, ex)
    return out, tag


def _post(sends: list, recvs: list, ex: _Exchange) -> None:
    """Post every send and receive of a stage, wait for all, copy the
    received boxes into place."""
    if not sends and not recvs:
        return
    host = staged(ex.group, ex.device)
    works, landed, held = [], [], []
    for view, peer, tag in sends:
        buf = view.to("cpu") if host else view.contiguous()
        held.append(buf)  # a send's buffer lives until its wait
        works.append(dist.isend(buf, ex.rank(peer), group=ex.group, tag=tag))
    for view, peer, tag in recvs:
        buf = torch.empty(view.shape, dtype=view.dtype, device="cpu" if host else view.device)
        works.append(dist.irecv(buf, ex.rank(peer), group=ex.group, tag=tag))
        landed.append((view, buf))
    for work in works:
        work.wait()
    for view, buf in landed:
        view.copy_(buf)


def assemble_from_survivors(shape: tuple, leaf, src: ProcessSharding, lost_ids: set, ex: _Exchange,
                            buddy_leaf=None, buddy: Optional[ProcessSharding] = None) -> Optional[torch.Tensor]:
    """The whole leaf in host memory on every member of the group, put
    together from live shards only: each source region broadcast once by
    its first live holder (its primary, else its buddy copy). A shard on a
    lost member is never read. None when the live shards do not cover the
    leaf (checked from metadata, before a byte moves). A collective."""
    if not _leaf_covered(shape, src, set(lost_ids), buddy):
        return None
    me = ex.member
    dtype = leaf.dtype
    whole = torch.empty(shape, dtype=dtype)
    comm = torch.device("cpu") if dist.get_backend(ex.group) == "gloo" else ex.device
    for region, holders in _holders(shape, src, set(lost_ids), buddy):
        if not holders:
            continue  # covered by another region's pieces (replicated over the lost ones)
        owner = holders[0]
        position = owner[1]
        sharding = buddy if owner[2] else src
        pieces = sharding.pieces(shape, position)
        shard_shape = sharding.shard_shape(shape)
        if owner[0] == me:
            buf = (buddy_leaf if owner[2] else leaf).detach().to(comm).contiguous()
        else:
            buf = torch.empty(shard_shape, dtype=dtype, device=comm)
        dist.broadcast(buf, ex.rank(owner[0]), group=ex.group)
        host = buf.cpu()
        for box, local in pieces:
            whole[tuple(slice(lo, hi) for lo, hi in box)] = _local(host, box, box, local)
    return whole


def _cut(whole: torch.Tensor, dst: ProcessSharding, position: int, device) -> torch.Tensor:
    """A member's new shard of a whole leaf: its own contiguous tensor."""
    shape = tuple(whole.shape)
    out = torch.empty(dst.shard_shape(shape), dtype=whole.dtype)
    for box, local in dst.pieces(shape, position):
        _local(out, box, box, local).copy_(whole[tuple(slice(lo, hi) for lo, hi in box)])
    return out.to(device)


def relay_tree(tree: Sequence, src_shardings: Sequence[ProcessSharding], lost_ids: set, buddy_tree: Optional[Sequence],
               buddy_shardings: Optional[Sequence[ProcessSharding]], dst_shardings: Sequence[ProcessSharding],
               ex: _Exchange) -> list:
    """The host relay: each leaf put together on the host of every member
    from live shards, its new shard cut out, the host copy dropped: peak
    host memory is one leaf. Callers check coverage first."""
    shapes = _global_shapes(tree, src_shardings)
    out = []
    for i, (shape, leaf, src, dst) in enumerate(zip(shapes, tree, src_shardings, dst_shardings)):
        buddy_leaf = buddy_tree[i] if buddy_tree is not None else None
        buddy = buddy_shardings[i] if buddy_shardings is not None else None
        whole = assemble_from_survivors(shape, leaf, src, lost_ids, ex, buddy_leaf, buddy)
        if whole is None:
            raise RedistributeError("internal: relay_tree called for a leaf whose surviving shards do not cover "
                                    "it (coverage must be checked first)")
        out.append(_cut(whole, dst, dst.members.index(ex.member), ex.device) if ex.member in dst.members else None)
    return out


def redistribute(
    tree: Sequence,
    dst_shardings: Sequence[ProcessSharding],
    *,
    src_shardings: Sequence[ProcessSharding],
    member: int,
    rank_of: Optional[Mapping[int, int]] = None,
    device=None,
    config: Optional[RedistributeConfig] = None,
    lost_device_ids: "frozenset[int] | set[int]" = frozenset(),
    buddy_tree: Optional[Sequence] = None,
    buddy_shardings: Optional[Sequence[ProcessSharding]] = None,
    fault_plan: Any = None,
    epoch_fence: Optional[EpochFence] = None,
    probe: Optional[Callable[[], None]] = None,
    telemetry: Any = None,
    trace_id: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
) -> list:
    """Move ``tree`` (this process's shard of each leaf; a member that holds
    none, a returning process, passes meta tensors of the source shard
    shapes) from ``src_shardings`` onto ``dst_shardings`` and return this
    process's new shards: the commit (None for a leaf of a process that is
    not a destination member). A collective over the default group;
    ``rank_of`` gives each member's rank in it (default: the member
    itself). Transactional: the source is never written, and any
    failure before the return leaves it as it was.

    ``lost_device_ids`` and ``buddy_tree``/``buddy_shardings`` select the
    host relay (the elastic shrink). ``epoch_fence`` is checked at plan
    time and at commit. ``probe`` runs before each stage (the caller's own
    window). ``fault_plan`` (default: the activated chaos plan) kills a
    named stage: the staged rung then falls back to the relay, or fails
    naming the stage under ``force_path="staged"``."""
    from ..resilience import chaos as chaos_mod
    from ..resilience.membership import StaleEpochError

    config = config or RedistributeConfig()
    if fault_plan is None:
        fault_plan = chaos_mod.active_plan()
    tree = list(tree)
    if device is None:
        device = next((x.device for x in tree if x.device.type != "meta"), None)
        if device is None:
            raise ValueError("redistribute: a process holding no shard must name its device")
    ex = _Exchange(member, rank_of, torch.device(device))
    seq = _next_seq()
    t0 = time.perf_counter()
    lost = set(lost_device_ids)
    plan = plan_redistribute(tree, dst_shardings, src_shardings=src_shardings, lost_device_ids=lost,
                             buddy_shardings=buddy_shardings if buddy_tree is not None else None, config=config,
                             paths=paths)
    base = {
        "transfer": seq, "path": plan.rung, "leaves": plan.num_leaves, "stages": len(plan.stages),
        "stage_kinds": plan.stage_kinds, "bytes_moved": plan.total_bytes,
        "peak_scratch_bytes": plan.peak_scratch_bytes, "max_scratch_bytes": plan.max_scratch_bytes,
    }
    if trace_id is not None:
        base["trace_id"] = trace_id

    def _emit(outcome: str, **extra) -> None:
        if telemetry is not None and getattr(telemetry, "enabled", False):
            telemetry.write_record("redistribute", {**base, "outcome": outcome,
                                                    "wall_time_s": round(time.perf_counter() - t0, 6), **extra})

    def _fenced(new_tree):
        if epoch_fence is not None:
            try:
                epoch_fence.check()
            except StaleEpochError:
                _emit("stale_epoch_write_rejected")
                raise
        return new_tree

    def _fire(stage: Stage) -> None:
        if fault_plan is not None and fault_plan.redistribute_fail(seq, stage.index, stage.kind):
            raise RedistributeStageFailure(
                f"redistribute transfer {seq} lost stage {stage.index} ({stage.kind}, leaf {stage.leaf}) "
                "mid-transfer", stage=stage.index, kind=stage.kind, leaf=stage.leaf)
        if probe is not None:
            probe()

    if epoch_fence is not None:
        try:  # a process already fenced out must not start reading shards it no longer owns
            epoch_fence.check()
        except StaleEpochError:
            _emit("stale_epoch_write_rejected")
            raise

    def _relay(lost_ids, buddies, buddy_sh):
        return relay_tree(tree, src_shardings, lost_ids, buddies, buddy_sh, dst_shardings, ex)

    if plan.rung == "host_relay":
        if not plan.covered:
            _emit("failed", error="uncovered")
            raise RedistributeError(
                f"redistribute: surviving shards do not cover the tree ({len(lost)} lost member(s)); no rung "
                "can move state that no longer exists: the caller's ladder falls to its next rung")
        for stage in plan.stages:
            _fire(stage)
        out = _fenced(_relay(lost, buddy_tree, buddy_shardings))
        _emit("committed")
        return out

    by_leaf: dict[str, list[Stage]] = {}
    for stage in plan.stages:
        by_leaf.setdefault(stage.leaf, []).append(stage)
    names = list(paths) if paths is not None else [f"[{i}]" for i in range(len(tree))]
    shapes = _global_shapes(tree, src_shardings)
    try:
        new, tag = [], 0
        for name, shape, leaf, src, dst in zip(names, shapes, tree, src_shardings, dst_shardings):
            stages = by_leaf.get(name, [])
            if not stages:  # identity: this process's shard, as its own tensor
                new.append(leaf.detach().clone(memory_format=torch.contiguous_format)
                           if ex.member in dst.members else None)
                continue
            out = None
            for stage in stages:
                _fire(stage)
                slab = None
                if stage.chunk is not None:
                    dim, start, size = stage.chunk
                    slab = tuple((start, start + size) if d == dim else (0, n) for d, n in enumerate(shape))
                out, tag = _staged_leaf(shape, leaf, src, dst, slab, ex, leaf.dtype, out, tag)
            new.append(out)
        out = _fenced(new)
        _emit("committed")
        return out
    except RedistributeStageFailure as failure:
        detail = {"failed_stage": failure.stage, "failed_stage_kind": failure.kind, "failed_leaf": failure.leaf}
        if config.force_path == "staged":
            _emit("failed", **detail)
            raise RedistributeError(
                f"staged redistribution failed at stage {failure.stage} ({failure.kind}, leaf {failure.leaf}) and "
                "the host-relay fallback is disabled (force_path='staged')") from failure
        logger.warning(f"redistribute: stage {failure.stage} ({failure.kind}) failed: falling back to the host relay")
        out = _fenced(_relay(set(), None, None))
        _emit("fell_back", **detail)
        return out


# -- the transfer sequence the chaos legs index ----------------------------------------

_SEQ_LOCK = threading.Lock()
_TRANSFER_SEQ = 0


def _next_seq() -> int:
    global _TRANSFER_SEQ
    with _SEQ_LOCK:
        seq = _TRANSFER_SEQ
        _TRANSFER_SEQ += 1
        return seq


def reset_transfer_seq() -> None:
    """Re-zero the process-wide transfer counter the chaos leg indexes."""
    global _TRANSFER_SEQ
    with _SEQ_LOCK:
        _TRANSFER_SEQ = 0


# -- the paged-transfer leg (the KV handoff's wire) ---------------------------------------


def paged_transfer(
    extract: Callable[[list], tuple],
    pages: list,
    *,
    fault_plan: Any = None,
    probe: Optional[Callable[[], None]] = None,
    telemetry: Any = None,
    trace_id: Optional[str] = None,
) -> tuple:
    """Move ``pages``' K and V blocks through ``extract`` (the source
    engine's ``extract_pages``) and return them: one stage per page, the
    page being the chunk. The source engine copies them to the host in one
    gather and one copy per pool, the destination's ``adopt_kv`` copies them
    up: the host relay. The chaos plan's ``redistribute_fail`` legs kill a
    named page-read stage here (:class:`RedistributeStageFailure`), and
    ``probe`` (the router's handoff stall/loss window) fires between
    deciding to move and the read. The commit (adoption and the source's
    ``release_parked``) stays with the router, whose retry-then-re-prefill
    ladder is this transfer's fallback."""
    from ..resilience import chaos as chaos_mod

    if fault_plan is None:
        fault_plan = chaos_mod.active_plan()
    seq = _next_seq()
    t0 = time.perf_counter()
    n = len(pages)
    if fault_plan is not None:
        for stage in range(n):
            if fault_plan.redistribute_fail(seq, stage, "paged_extract"):
                raise RedistributeStageFailure(
                    f"redistribute transfer {seq} lost page-read stage {stage} of {n} mid-transfer",
                    stage=stage, kind="paged_extract", leaf=f"page[{stage}]",
                )
    if probe is not None:
        probe()
    k_blocks, v_blocks = extract(pages)
    moved = int(k_blocks.nbytes + v_blocks.nbytes)
    if telemetry is not None and getattr(telemetry, "enabled", False):
        payload = {
            "transfer": seq,
            "path": "host_relay",
            "leaves": 2,
            "stages": n,
            "stage_kinds": {"paged_extract": n},
            "bytes_moved": moved,
            "peak_scratch_bytes": moved // max(n, 1),
            "max_scratch_bytes": moved // max(n, 1),
            "outcome": "committed",
            "wall_time_s": time.perf_counter() - t0,
        }
        if trace_id is not None:
            payload["trace_id"] = trace_id
        telemetry.write_record("redistribute", payload)
    return k_blocks, v_blocks
