"""LocalSGD across processes (``parallel/local_sgd.py``): the port with one
worker a process, 4 gloo processes on the CPU (the shared launch,
``torch_shared.elastic_launch``), against the JAX package's ``LocalSGD``
with 4 workers (``ParallelismConfig(data=4, fsdp=2)`` on its 8 devices):
worker i of each takes rows ``6i:6i+6`` of every global batch of 24.

Tolerances, and why (llama-tiny, fp32, adamw 1e-3, 4 steps):
- losses (the mean over the workers): rtol 1e-5 against the JAX package's;
- each worker's replica against the JAX worker's after every step: the
  largest difference within ``2 * lr * steps`` and the mean one within
  1e-5 (Adam moves a param by about ``lr`` a step whatever its gradient's
  size, as ``test_torch_parallel.py`` holds trained params);
- after a sync the replicas are bit-equal on every process (one
  all-reduce, the same division), and equal the mean of the four within
  1e-6 of the largest magnitude (fp32 sums of four in another order);
- the model's params after the context: the average, bit for bit.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_shared import elastic_launch  # noqa: E402

LR = 1e-3
STEPS = 4


@pytest.fixture(scope="module")
def launch(request, tmp_path_factory):
    return elastic_launch(request, tmp_path_factory)


def _close(port: dict, jax: dict, steps: int):
    for name in port:
        diff = np.abs(port[name] - jax[name])
        assert diff.max() <= 2 * LR * steps, (name, diff.max())
        assert diff.mean() <= 1e-5, (name, diff.mean())


@pytest.mark.parametrize("name, k", [("k2", 2), ("k1", 1)])
def test_replicas_diverge_between_syncs_and_average_at_them(launch, name, k):
    """Each process's replica against the JAX worker's after every step;
    between syncs the replicas differ, after a sync they are bit-equal on
    every process and equal the mean of the four replicas just before it;
    the model holds the average after the context."""
    ranks = [r["local_sgd"][name] for r in launch["port"]]
    jax_run = launch["jax_local_sgd"][name]
    np.testing.assert_allclose(ranks[0]["losses"], jax_run["losses"], rtol=1e-5)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    syncs = 0
    for step in range(STEPS):
        for worker, r in enumerate(ranks):
            jax_worker = {key: value[worker] for key, value in jax_run["replicas"][step].items()}
            _close(r["replicas"][step], jax_worker, step + 1)
        replicas = [r["replicas"][step] for r in ranks]
        same = all(np.array_equal(replicas[0][key], x[key]) for x in replicas for key in x)
        assert same == ((step + 1) % k == 0), step
        if same:
            before = [r["presync"][syncs] for r in ranks]
            for key in before[0]:
                mean = np.mean([b[key] for b in before], axis=0)
                assert np.abs(replicas[0][key] - mean).max() <= 1e-6 * max(float(np.abs(mean).max()), 1.0), key
            syncs += 1
    # the exit's sync averages replicas that are equal already: the last one stands
    for r in ranks:
        assert all(np.array_equal(r["final"][key], ranks[0]["replicas"][-1][key]) for key in r["final"])
    _close(ranks[0]["final"], jax_run["final"], STEPS)


def test_disabled_is_the_synchronous_step(launch):
    """``enabled=False``: every step all-reduces the gradients and updates
    the same replica on every process, as the JAX package's single update
    on the global batch."""
    ranks = [r["local_sgd"]["off"] for r in launch["port"]]
    jax_run = launch["jax_local_sgd"]["off"]
    np.testing.assert_allclose(ranks[0]["losses"], jax_run["losses"], rtol=1e-5)
    for step in range(STEPS):
        replicas = [r["replicas"][step] for r in ranks]
        assert all(np.array_equal(replicas[0][key], x[key]) for x in replicas for key in x)
        _close(replicas[0], jax_run["replicas"][step], step + 1)
    _close(ranks[0]["final"], jax_run["final"], STEPS)


def test_step_outside_the_context_raises(launch):
    """As in the JAX package: ``step`` outside ``with LocalSGD(...)``
    raises before any collective."""
    for r in launch["port"]:
        for name in ("k2", "k1", "off"):
            assert "outside the context manager" in r["local_sgd"][name]["outside"]


def test_local_sgd_needs_its_parts():
    from accelerate_tpu_torch import LocalSGD

    with pytest.raises(ValueError, match="prepared model"):
        LocalSGD(None, None, None)
