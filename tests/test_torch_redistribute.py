"""The redistribution primitive across processes (``parallel/redistribute.py``)
against the JAX package's on its 8-device mesh.

The plan is metadata: the port's plan of a geometry (members for devices,
the mesh's axis sizes, a spec for a ``PartitionSpec``) must name the same
rung, kinds, stage counts, stage sizes and coverage as the JAX package's
``plan_redistribute`` of the same geometry, and it must read no shard data
(meta tensors plan). The transfers run in the shared launch of 4 gloo
processes (``torch_shared.elastic_launch``): random leaves relaid 4 -> 3
-> 4 (the departing process only sends, then only receives), the staged
rung against the host relay, a chaos-killed stage, the forced staged rung,
a zombie transfer. Tolerance: 0 everywhere (a transfer copies).
"""

import os
import sys

import numpy as np
import pytest

import jax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch

from accelerate_tpu.parallel.redistribute import RedistributeConfig as JaxRedistributeConfig
from accelerate_tpu.parallel.redistribute import plan_redistribute as jax_plan_redistribute
from accelerate_tpu_torch.parallel.redistribute import (
    ProcessSharding,
    RedistributeConfig,
    RedistributeError,
    plan_redistribute,
    redistribute,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_shared import elastic_launch  # noqa: E402


@pytest.fixture(scope="module")
def launch(request, tmp_path_factory):
    return elastic_launch(request, tmp_path_factory)


def _geometry(members, axes_sizes, spec):
    """One layout in both packages: the JAX sharding over those devices and
    the port's over those members."""
    devices = np.asarray(jax.devices())[np.asarray(members)]
    names = tuple(axes_sizes)
    mesh = Mesh(devices.reshape(tuple(axes_sizes.values())), names)
    return NamedSharding(mesh, P(*spec)), ProcessSharding.of(members, axes_sizes, spec)


# (shape, source geometry, destination geometry): members, axis sizes, spec
GEOMETRIES = {
    "permute": ((64,), (range(8), {"data": 8}, ("data",)),
                (np.roll(np.arange(8), 1), {"data": 8}, ("data",))),
    "reshard": ((64,), (range(8), {"data": 8}, ("data",)), (range(8), {"data": 8}, ())),
    "cross": ((32,), (range(4), {"data": 4}, ("data",)), (range(4, 8), {"data": 4}, ("data",))),
    "identity": ((64, 8), (range(8), {"data": 8}, ("data",)), (range(8), {"data": 8}, ("data",))),
    "shrink": ((96, 12), (range(8), {"data": 8}, ("data",)), (range(6), {"data": 6}, (None, "data"))),
    "regrow": ((48, 16), (range(6), {"data": 6}, ("data",)), (range(8), {"data": 8}, ("data",))),
    "folded": ((64, 32), (range(8), {"data": 4, "fsdp": 2}, (("fsdp", "data"),)),
               (range(8), {"data": 2, "fsdp": 4}, (None, "fsdp"))),
}


def _both(names, scratch=None, lost=(), buddy_roll=None):
    """The JAX plan and the port's of the named geometries, the port's over
    meta tensors (no data)."""
    jax_tree, jax_dst, jax_buddy, leaves, src, dst, buddies = {}, {}, {}, [], [], [], []
    for name in names:
        shape, (sm, ss, sspec), (dm, ds, dspec) = GEOMETRIES[name]
        jsrc, psrc = _geometry(list(sm), ss, sspec)
        jdst, pdst = _geometry(list(dm), ds, dspec)
        value = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        jax_tree[name] = jax.device_put(value, jsrc)
        jax_dst[name] = jdst
        leaves.append(torch.empty(psrc.shard_shape(shape), device="meta"))
        src.append(psrc)
        dst.append(pdst)
        if buddy_roll is not None:
            rolled = np.roll(np.asarray(list(sm)), buddy_roll)
            jb, pb = _geometry(list(rolled), ss, sspec)
            jax_buddy[name] = jax.device_put(value, jb)
            buddies.append(pb)
    jconfig = JaxRedistributeConfig(max_scratch_bytes=scratch) if scratch else None
    pconfig = RedistributeConfig(max_scratch_bytes=scratch) if scratch else None
    jplan = jax_plan_redistribute(jax_tree, jax_dst, lost_device_ids=set(lost),
                                  buddy_tree=jax_buddy if buddy_roll is not None else None, config=jconfig)
    # the JAX tree's leaves are in sorted key order
    order = sorted(range(len(names)), key=lambda i: names[i])
    pplan = plan_redistribute([leaves[i] for i in order], [dst[i] for i in order],
                              src_shardings=[src[i] for i in order], lost_device_ids=set(lost),
                              buddy_shardings=[buddies[i] for i in order] if buddy_roll is not None else None,
                              config=pconfig)
    return jplan, pplan


@pytest.mark.parametrize("names, scratch", [
    (("permute", "reshard", "cross"), None),
    (("identity",), None),
    (("shrink", "regrow", "folded"), None),
    (("shrink", "regrow", "folded", "permute"), 512),
    (("shrink",), 2048),
])
def test_plan_kinds_and_stages_equal_the_jax_plan(names, scratch):
    """The rung, each stage's kind, size and chunk, the peak scratch and
    the totals: the JAX package's, from metadata alone (the port's leaves
    are meta tensors)."""
    jplan, pplan = _both(names, scratch)
    assert pplan.rung == jplan.rung == "staged"
    assert pplan.stage_kinds == jplan.stage_kinds
    assert [(s.kind, s.nbytes, s.chunk) for s in pplan.stages] == [(s.kind, s.nbytes, s.chunk) for s in jplan.stages]
    assert (pplan.peak_scratch_bytes, pplan.total_bytes, pplan.num_leaves) == (
        jplan.peak_scratch_bytes, jplan.total_bytes, jplan.num_leaves)
    if names == ("permute", "reshard", "cross"):
        assert pplan.stage_kinds == {"collective_permute": 1, "all_to_all": 1, "device_put": 1}
    if names == ("identity",):
        assert pplan.stages == []


def test_rung_decision_and_coverage_equal_the_jax_plan():
    """Lost members, or a buddy copy to stitch in, take the host relay; the
    coverage verdict (a lost shard with no buddy does not cover; its buddy
    one host over does; a shard and its buddy both lost do not) is the
    JAX package's."""
    for lost, roll in (({7}, None), ({7}, 1), ({0, 1}, 2), ({0, 2}, 2), ((), 1)):
        jplan, pplan = _both(("shrink", "regrow"), lost=lost, buddy_roll=roll)
        assert pplan.rung == jplan.rung == "host_relay"
        assert pplan.covered == jplan.covered, (lost, roll)
        assert [(s.kind, s.nbytes) for s in pplan.stages] == [(s.kind, s.nbytes) for s in jplan.stages]
    assert not _both(("shrink",), lost={7})[1].covered
    assert _both(("shrink",), lost={7}, buddy_roll=1)[1].covered


def test_an_uncovered_transfer_fails_before_a_byte_moves():
    """The relay of a tree its survivors do not cover fails loudly, naming
    the next rung, without a collective (no process group is needed)."""
    src = [ProcessSharding.of(range(8), {"data": 8}, ("data",))]
    dst = [ProcessSharding.of(range(4), {"data": 4}, ("data",))]
    with pytest.raises(RedistributeError, match="do not cover"):
        redistribute([torch.zeros(8)], dst, src_shardings=src, member=0, lost_device_ids={7})
    with pytest.raises(ValueError, match="does not divide"):
        ProcessSharding.of(range(3), {"data": 3}, ("data",)).shard_shape((64,))


def test_roundtrips_and_the_staged_rung_equal_the_relay_bit_for_bit(launch):
    """4 -> 3 -> 4 on the staged rung (scratch bounds of 64 B, 4 KiB and 1
    MiB: many stages, some, one a leaf) lands every leaf bit for bit, the
    shrink equals the host relay's, and the departing process holds
    nothing; every process plans the same."""
    ranks = [r["redistribute"] for r in launch["port"]]
    for r in ranks:
        assert r["roundtrip"] == [True, True, True]
        assert r["plans"] == ranks[0]["plans"]
    small, middle, whole = ranks[0]["plans"]
    assert len(small["stages"]) > len(middle["stages"]) >= len(whole["stages"]) == 5
    assert all(p["rung"] == "staged" for p in ranks[0]["plans"])


def test_a_killed_stage_falls_to_the_relay_and_forced_staged_fails_naming_it(launch):
    """Stage 2 of transfer 0 killed by the chaos plan: the relay completes
    it bit for bit from the intact source, recorded ``fell_back`` with the
    stage; with ``force_path="staged"`` the kill fails the transfer naming
    its stage."""
    for r in (x["redistribute"] for x in launch["port"]):
        killed = r["killed"]
        assert killed["source_intact"] and killed["result"]
        [record] = killed["records"]
        assert record["outcome"] == "fell_back" and record["failed_stage"] == 2 and record["path"] == "staged"
        assert "stage 1" in r["forced"] and "force_path='staged'" in r["forced"]


def test_a_zombie_transfer_is_refused_at_commit(launch):
    """The membership view moves on mid-transfer: every process's commit
    is refused (``StaleEpochError``), recorded, and the source stays."""
    for r in (x["redistribute"] for x in launch["port"]):
        zombie = r["zombie"]
        assert "epoch 3" in zombie["error"] and "epoch 4" in zombie["error"]
        assert zombie["outcomes"] == ["stale_epoch_write_rejected"] and zombie["source_intact"]
