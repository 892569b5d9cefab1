"""The port's checkpoints (``accelerate_tpu_torch/checkpointing.py``,
``fault_tolerance.py``) on the CPU, against the JAX package's (oracles
``tests/test_checkpointing.py`` and ``tests/test_fault_tolerance.py``).

Across packages, both ways: a llama-tiny run of one package's
``Accelerator`` (a shuffled loader, gradient accumulation 2, a schedule)
saves at step 3, mid epoch, under ``CheckpointManager``; the other package
resumes it with ``resume("auto")`` and ``resumed_loader`` and trains 3
steps, and its losses are held to those of the first package's run going on
from the same point. Tolerance: rtol 1e-5 on the losses (fp32; the two
frameworks sum in other orders, as ``tests/test_torch_training.py``
explains) and, on the params after the 3 steps, at most ``2 * lr * 3`` apart
anywhere and 1e-5 on average (Adam moves a param by up to ``lr`` a step
whatever the gradient's size, so a gradient near 0 that rounds differently
can move it by up to ``2 * lr``).

Within the port, exactly: a run stopped by SIGTERM, saved at the step
boundary and resumed by a fresh ``Accelerator`` equals the run that was
never stopped, bit for bit. On the CPU that needs
``torch.use_deterministic_algorithms(True)``: without it two uninterrupted
runs differ in the last bits, since the embedding's backward accumulates
rows from several threads in no fixed order."""

import os
import pickle
import signal
import zlib

import numpy as np
import optax
import pytest
import torch

import jax

from accelerate_tpu import Accelerator as JaxAccelerator
from accelerate_tpu import CheckpointManager as JaxCheckpointManager
from accelerate_tpu import FullyShardedDataParallelPlugin, ParallelismConfig
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.state import PartialState as JaxPartialState
from accelerate_tpu.utils import random as jax_random
from accelerate_tpu_torch import (
    Accelerator,
    CompilationConfig,
    Llama,
    ProjectConfiguration,
    adamw,
    fused_adamw,
    latest_valid_checkpoint,
    verify_checkpoint,
)
from accelerate_tpu_torch import fault_tolerance as ft
from accelerate_tpu_torch.checkpointing import (
    is_sharded_checkpoint,
    load_model_weights,
    load_model_weights_sharded,
    save_model_weights,
)
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.utils import memory
from accelerate_tpu_torch.utils import random as port_random
from accelerate_tpu_torch.utils.params import flatten_tree

LR = 1e-3
ROWS, TOKENS, BATCH, ACCUM = 40, 65, 4, 2  # 10 micro-batches, 5 steps an epoch


def _reset():
    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState, AcceleratorState, GradientState,
                PartialState):
        cls._reset_state()


@pytest.fixture(autouse=True)
def fresh_state():
    _reset()
    yield
    _reset()


@pytest.fixture
def deterministic():
    previous = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(previous)


class Tokens:
    def __init__(self, seed=0):
        self.tokens = np.random.default_rng(seed).integers(0, 1024, (ROWS, TOKENS)).astype(np.int32)

    def __len__(self):
        return ROWS

    def __getitem__(self, i):
        return {"input_ids": self.tokens[i]}


def schedule(count):
    return LR / (1 + 0.05 * count)


def _jax_run(tx):
    acc = JaxAccelerator(gradient_accumulation_steps=ACCUM, parallelism=ParallelismConfig(zero_stage=0))
    loader = acc.prepare_data_loader(Tokens(), batch_size=BATCH, shuffle=True, seed=42, prefetch=0)
    model, optimizer, loader, scheduler = acc.prepare(JaxLlama("llama-tiny"), tx, loader, schedule)
    return acc, model, optimizer, loader, scheduler, JaxLlama.loss_fn(model.module)


def _port_run(tx):
    acc = Accelerator(gradient_accumulation_steps=ACCUM, device="cpu",
                      compilation_config=CompilationConfig(flash_attention_min_seq=0))
    loader = acc.prepare_data_loader(Tokens(), batch_size=BATCH, shuffle=True, seed=42, prefetch=0)
    model, optimizer, loader, scheduler = acc.prepare(Llama("llama-tiny", device="cpu", seed=0), tx, loader,
                                                      schedule)
    return acc, model, optimizer, loader, scheduler, Llama.loss_fn(model.module)


def _train(run, manager, until, resume=None, kill_at=None, epochs=2):
    """The user's loop under ``manager`` until optimizer step ``until``:
    returns each step's loss (the mean over its micro-batches) and the step
    reached. ``kill_at`` sends SIGTERM before that micro-batch."""
    acc, model, optimizer, loader, scheduler, loss_fn = run
    step = resume.step if resume else 0
    losses, window, seen = [], [], 0
    for epoch in range(resume.epoch if resume else 0, epochs):
        loader.set_epoch(epoch)
        for batch in manager.resumed_loader(loader, resume, epoch):
            if seen == kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            seen += 1
            with acc.accumulate(model):
                window.append(float(acc.backward(loss_fn, batch)))
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
            if not acc.sync_gradients:
                continue
            step += 1
            losses.append(float(np.mean(window)))
            window = []
            if manager.should_save(step):
                manager.save(step, epoch=epoch)
            if manager.exit_requested or step == until:
                return losses, step
        resume = None
    return losses, step


def _jax_flat(params):
    return {k.replace(".", "/"): np.asarray(v) for k, v in flatten_tree(jax.tree.map(np.asarray, params))}


def _port_flat(params):
    return {k.replace(".", "/"): v.detach().numpy() for k, v in flatten_tree(params)}


def _assert_params_close(want, got, steps):
    assert set(want) == set(got)
    for key in want:
        diff = np.abs(got[key] - want[key])
        assert diff.max() <= 2 * LR * steps and diff.mean() <= 1e-5, f"{key}: {diff.max()}, {diff.mean()}"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages_and_training_goes_on(direction, tmp_path):
    """One package trains 3 steps and saves (mid epoch 0, loader position
    6); the other resumes and trains steps 4-6 (the last in epoch 1). JAX to
    the port uses ``optax.adamw(schedule)`` and ``adamw(schedule)`` (optax's
    scheduled state), the port to JAX ``fused_adamw`` and ``optax.adamw``."""
    if direction == "jax_to_port":
        first, second = (lambda: _jax_run(optax.adamw(schedule))), (lambda: _port_run(adamw(schedule)))
        first_manager, second_manager = JaxCheckpointManager, ft.CheckpointManager
    else:
        first, second = (lambda: _port_run(fused_adamw(LR))), (lambda: _jax_run(optax.adamw(LR)))
        first_manager, second_manager = ft.CheckpointManager, JaxCheckpointManager
    run = first()
    manager = first_manager(run[0], str(tmp_path), save_interval=3, handle_signals=())
    _, step = _train(run, manager, until=3)
    assert step == 3 and os.listdir(tmp_path) == ["checkpoint_3"]
    manager.save_interval = None  # the first run goes on from the same point, saving nothing more
    want, _ = _train(run, manager, until=6, resume=_position(tmp_path))
    want_params = run[1].params
    want_flat = _port_flat(want_params) if direction == "port_to_jax" else _jax_flat(want_params)

    _reset()
    run = second()
    manager = second_manager(run[0], str(tmp_path), handle_signals=())
    resume = manager.resume("auto")
    assert (resume.step, resume.epoch, resume.dataloaders[0]) == (3, 0, {"epoch": 0, "position": 6})
    got, step = _train(run, manager, until=6, resume=resume)
    assert step == 6 and len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_flat = _jax_flat(run[1].params) if direction == "port_to_jax" else _port_flat(run[1].params)
    _assert_params_close(want_flat, got_flat, 3)


def _position(path):
    """Where the first run stands after its save: the ResumePoint its own
    manifest describes, so it goes on exactly as the other package will."""
    return ft.ResumePoint(path=str(path / "checkpoint_3"), step=3, epoch=0,
                          dataloaders=[{"epoch": 0, "position": 6}])


def test_resumed_run_equals_the_uninterrupted_run_bit_for_bit(deterministic, tmp_path):
    """Run A trains 10 steps; run B takes SIGTERM mid step 4, saves once at
    its boundary and stops; run C, a fresh Accelerator, resumes and trains
    to step 10. C's losses and final params equal A's exactly."""
    run = _port_run(fused_adamw(LR))
    want, _ = _train(run, ft.CheckpointManager(run[0], str(tmp_path / "a"), handle_signals=()), until=10)
    want_params = {k: v.copy() for k, v in _port_flat(run[1].params).items()}

    _reset()
    run = _port_run(fused_adamw(LR))
    with ft.CheckpointManager(run[0], str(tmp_path / "b")) as manager:
        losses, step = _train(run, manager, until=10, kill_at=6)
        assert step == 4 and manager.exit_requested and os.listdir(tmp_path / "b") == ["checkpoint_4"]
    assert losses == want[:4]

    _reset()
    run = _port_run(fused_adamw(LR))
    manager = run[0].checkpoint_manager(str(tmp_path / "b"), handle_signals=())
    resume = manager.resume("auto")
    got, step = _train(run, manager, until=10, resume=resume)
    assert step == 10 and got == want[4:]
    got_params = _port_flat(run[1].params)
    assert all(np.array_equal(got_params[k], want_params[k]) for k in want_params)
    assert run[4].step_count == 20  # the scheduler's counter came back too (adjust_scheduler ticks)


class _Linear(torch.nn.Module):
    """A model of two leaves with the port's ``apply`` and ``param_tree``."""

    def __init__(self, rows=8, cols=4):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(rows, cols))
        self.b = torch.nn.Parameter(torch.zeros(cols))

    def param_tree(self):
        return {"w": self.w, "b": self.b}

    @staticmethod
    def apply(params, x):
        return x @ params["w"] + params["b"]


def _linear_loss(params, batch):
    return ((_Linear.apply(params, batch["x"]) - 1.0) ** 2).mean()


def _linear_accelerator(**kwargs):
    acc = Accelerator(device="cpu", **kwargs)
    model, optimizer = acc.prepare(_Linear(), fused_adamw(1e-2))
    return acc, model, optimizer


def _linear_step(acc, optimizer):
    acc.backward(_linear_loss, {"x": torch.ones(2, 8)})
    optimizer.step()
    optimizer.zero_grad()


def test_sigterm_leads_to_one_save_at_the_next_boundary(tmp_path):
    """The handler only sets a flag; the save happens once, at the step
    boundary, and the previous handler is back after the manager."""
    before = signal.getsignal(signal.SIGTERM)
    acc, _, optimizer = _linear_accelerator()
    saves = []
    with acc.checkpoint_manager(str(tmp_path), save_interval=100) as manager:
        for step in range(1, 6):
            _linear_step(acc, optimizer)
            if step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
                assert os.listdir(tmp_path) == []  # nothing saved from the handler
            if manager.should_save(step):
                saves.append(manager.save(step))
            if manager.exit_requested:
                break
    assert step == 2 and saves == [str(tmp_path / "checkpoint_2")] and not manager.should_save(3)
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("damage", ["flip_a_byte", "truncate", "delete"])
def test_manifest_catches_damage_and_auto_resume_skips_it(damage, tmp_path):
    """Three committed checkpoints; the newest is damaged after its commit:
    ``verify_checkpoint`` names the file and ``resume("auto")`` takes the
    one before it."""
    acc, model, optimizer = _linear_accelerator()
    manager = acc.checkpoint_manager(str(tmp_path), handle_signals=())
    for step in (1, 2, 3):
        _linear_step(acc, optimizer)
        manager.save(step)
    target = tmp_path / "checkpoint_3" / "optimizer_0.npz"
    data = bytearray(target.read_bytes())
    if damage == "flip_a_byte":
        data[len(data) // 2] ^= 0x01
        target.write_bytes(bytes(data))
    elif damage == "truncate":
        target.write_bytes(bytes(data[:-7]))
    else:
        target.unlink()
    problems = verify_checkpoint(str(tmp_path / "checkpoint_3"))
    assert len(problems) == 1 and "optimizer_0.npz" in problems[0]
    assert verify_checkpoint(str(tmp_path / "checkpoint_2")) == []
    assert latest_valid_checkpoint(str(tmp_path)) == str(tmp_path / "checkpoint_2")
    assert manager.resume("auto").step == 2
    with pytest.raises(ValueError, match="Refusing"):
        manager.resume(str(tmp_path / "checkpoint_3"))


def test_torn_save_keeps_the_previous_checkpoint_and_is_collected(tmp_path, monkeypatch):
    """A save killed after its files are staged leaves a ``.tmp``
    directory: the committed checkpoint is untouched, ``resume("auto")``
    skips the torn one, and the next save collects it."""
    acc, model, optimizer = _linear_accelerator()
    manager = acc.checkpoint_manager(str(tmp_path), handle_signals=())
    _linear_step(acc, optimizer)
    manager.save(1)
    _linear_step(acc, optimizer)

    def kill(stage, directory):
        if stage == "manifest":
            raise KeyboardInterrupt("killed between the manifest and the rename")

    monkeypatch.setattr(ft, "fault_injection_hook", kill)
    with pytest.raises(KeyboardInterrupt):
        manager.save(2)
    monkeypatch.setattr(ft, "fault_injection_hook", None)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_1", "checkpoint_2.tmp"]
    assert manager.latest_valid() == str(tmp_path / "checkpoint_1")
    assert ft.garbage_collect_torn(str(tmp_path)) == [str(tmp_path / "checkpoint_2.tmp")]
    os.makedirs(tmp_path / "checkpoint_5.tmp")
    manager.save(3)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_1", "checkpoint_3"]


@pytest.mark.parametrize("how", ["manager", "automatic_naming"])
def test_total_limit_rotation_keeps_the_newest(how, tmp_path):
    """Five saves with ``total_limit=2``: the two newest stay, rotated after
    each commit; under automatic naming ``load_state()`` takes the newest."""
    if how == "manager":
        acc, model, optimizer = _linear_accelerator()
        manager = acc.checkpoint_manager(str(tmp_path / "checkpoints"), total_limit=2, handle_signals=())
        save = manager.save
    else:
        project = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=2)
        acc, model, optimizer = _linear_accelerator(project_config=project)
        save = lambda step: acc.save_state()  # noqa: E731,ARG005
    weights = []
    for step in range(5):
        _linear_step(acc, optimizer)
        weights.append(model.params["w"].detach().clone())
        save(step)
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_3", "checkpoint_4"]
    with torch.no_grad():
        model.params["w"].zero_()
    if how == "automatic_naming":
        acc.load_state()
    else:
        acc.load_state(str(tmp_path / "checkpoints" / "checkpoint_4"))
    assert torch.equal(model.params["w"], weights[-1])


def test_state_files_are_the_jax_packages_format(tmp_path):
    """The file names, the optimizer's ``leaf_<j>`` in optax's order with
    ``__meta__``, the scheduler's json and an RNG pickle that the JAX
    package restores: its keystore takes the seed of the last ``set_seed``."""
    acc, model, optimizer = _linear_accelerator()
    scheduler = acc.prepare_scheduler(schedule)
    port_random.set_seed(17)
    _linear_step(acc, optimizer)
    scheduler.step()
    path = acc.save_state(str(tmp_path / "ckpt"))
    names = sorted(os.listdir(path))
    assert names == ["manifest.json", "model_0.safetensors", "optimizer_0.npz", "random_states_0.pkl",
                     "scheduler_0.json"]
    with np.load(os.path.join(path, "optimizer_0.npz")) as z:
        assert sorted(z.files) == ["__meta__"] + [f"leaf_{j}" for j in range(5)]
        assert z["leaf_0"].dtype == np.int32 and int(z["leaf_0"]) == 1  # adam's count
        np.testing.assert_array_equal(z["leaf_1"], optimizer.opt_state[0].mu["b"].numpy())  # keys sorted
    with open(os.path.join(path, "random_states_0.pkl"), "rb") as f:
        state = pickle.load(f)
    assert state["jax_keystore"] == {"seed": 17, "count": 0}
    assert state["torch_cpu"].dtype == np.uint8
    jax_random.restore_rng_state(state)
    assert jax_random._KEYSTORE.state() == {"seed": 17, "count": 0}
    assert np.random.get_state()[1].tolist() == state["numpy"][1].tolist()


def test_port_restores_the_rng_state_of_either_package(tmp_path):
    """From its own file the port's generators continue where they were;
    from the JAX package's file (no torch state) they restart from the
    keystore's seed, as ``set_seed`` leaves them."""
    port_random.set_seed(5)
    torch.randn(3, generator=port_random.generator("cpu"))
    saved = port_random.rng_state()
    want = torch.randn(4, generator=port_random.generator("cpu")), torch.randn(4)
    port_random.restore_rng_state(pickle.loads(pickle.dumps(saved)))
    got = torch.randn(4, generator=port_random.generator("cpu")), torch.randn(4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    jax_random.set_seed(9)
    port_random.restore_rng_state(jax_random.rng_state())
    got = torch.randn(4, generator=port_random.generator("cpu"))
    port_random.set_seed(9)
    assert torch.equal(got, torch.randn(4, generator=port_random.generator("cpu")))


@pytest.mark.parametrize("saved, cards", [(1, 4), (2, 2), (2, 1), (1, 0)])
def test_cuda_rng_states_go_to_the_cards_there_are(saved, cards, monkeypatch):
    """A snapshot's global CUDA states go to the cards of the same index, as
    many as both have (a 1-card checkpoint resumed where 4 are visible
    restores card 0); states with no card to take them are left out with a
    warning, never silently. The CUDA calls are stood in for on the CPU."""
    port_random.set_seed(3)
    snapshot = port_random.rng_state()
    snapshot["torch_cuda"] = [np.full(16, i, np.uint8) for i in range(saved)]
    restored = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_rng_state", lambda s, device: restored.append((device, int(s[0]))))
    if saved > cards:
        with pytest.warns(UserWarning, match=f"CUDA states of {saved} cards"):
            port_random.restore_rng_state(snapshot)
    else:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            port_random.restore_rng_state(snapshot)
    n = min(saved, cards)
    assert restored == [(i, i) for i in range(n)]


def test_port_reads_a_sharded_checkpoint_of_the_jax_package(tmp_path):
    """The JAX package's ``sharded=True`` save at one process over an fsdp
    mesh of 2 (each weight in chunks): the port puts the chunks together
    into its params and optimizer state; its own sharded save (one process:
    each leaf one whole chunk) writes the same format back."""
    plugin = FullyShardedDataParallelPlugin(stage=3, min_weight_size=16)
    jacc = JaxAccelerator(parallelism=ParallelismConfig(fsdp=2), fsdp_plugin=plugin)

    class JaxLinear:
        def init(self, rng):
            return {"w": jax.random.normal(rng, (8, 4)), "b": jax.numpy.arange(4.0)}

        @staticmethod
        def apply(params, x):
            return x @ params["w"] + params["b"]

    jmodel = jacc.prepare(JaxLinear())
    jopt = jacc.prepare_optimizer(optax.adamw(1e-2))
    jacc.backward(lambda p, b: ((JaxLinear.apply(p, b["x"]) - 1.0) ** 2).mean(), {"x": np.ones((2, 8), np.float32)})
    jopt.step()
    jacc.save_state(str(tmp_path / "sharded"), sharded=True)
    assert any(".shard" in n for n in os.listdir(tmp_path / "sharded"))

    _reset()
    acc = Accelerator(device="cpu")
    model, optimizer = acc.prepare(_Linear(), adamw(1e-2))
    acc.load_state(str(tmp_path / "sharded"))
    np.testing.assert_array_equal(model.params["w"].detach().numpy(), np.asarray(jmodel.params["w"]))
    np.testing.assert_array_equal(optimizer.opt_state[0].nu["w"].numpy(), np.asarray(jopt.opt_state[0].nu["w"]))
    assert int(optimizer.opt_state[0].count) == 1 and optimizer.step_count == 1
    acc.save_state(str(tmp_path / "mine"), sharded=True)
    assert is_sharded_checkpoint(str(tmp_path / "mine"), "model_0.safetensors")
    flat = load_model_weights_sharded(str(tmp_path / "mine"), "model_0.safetensors")
    np.testing.assert_array_equal(flat["w"], np.asarray(jmodel.params["w"]))


def test_model_weights_split_into_shards_with_an_index(tmp_path):
    PartialState(device="cpu")
    params = {"a": torch.arange(64.0).reshape(8, 8), "b": {"c": torch.ones(300)}}
    save_model_weights(params, str(tmp_path), max_shard_size="1KB")
    assert "model.safetensors.index.json" in os.listdir(tmp_path)
    flat = load_model_weights(str(tmp_path))
    np.testing.assert_array_equal(flat["a"], params["a"].numpy())
    np.testing.assert_array_equal(flat["b/c"], np.ones(300, np.float32))


def test_npz_fallback_without_safetensors(tmp_path, monkeypatch):
    """Where ``safetensors`` is missing the weights go to ``model_0.npz``,
    which both packages read back."""
    from accelerate_tpu_torch import checkpointing

    monkeypatch.setattr(checkpointing, "has_safetensors", lambda: False)
    acc, model, optimizer = _linear_accelerator()
    path = acc.save_state(str(tmp_path / "npz"))
    assert "model_0.npz" in os.listdir(path) and "model_0.safetensors" not in os.listdir(path)
    with torch.no_grad():
        model.params["w"].zero_()
    acc.load_state(path)
    assert torch.equal(model.params["w"], torch.ones(8, 4))
    from accelerate_tpu.checkpointing import load_model_weights as jax_load

    np.testing.assert_array_equal(jax_load(os.path.join(path, "model_0.safetensors"))["w"], np.ones((8, 4)))


def test_transient_io_errors_retry_and_oom_is_recognised(monkeypatch):
    """The I/O classifier agrees with the JAX package's; a transient error
    retries with backoff, a real one propagates; the OOM classifier knows
    torch's error and ``find_executable_batch_size`` halves past it."""
    from accelerate_tpu.utils.memory import is_transient_io_error as jax_transient

    errors = [OSError(5, "Input/output error"), OSError(2, "No such file: checkpoint_429"),
              RuntimeError("Stale file handle"), ValueError("Input/output error"), OSError("Connection reset")]
    assert [memory.is_transient_io_error(e) for e in errors] == [jax_transient(e) for e in errors]
    sleeps = []
    monkeypatch.setattr(memory.time, "sleep", sleeps.append)
    calls = []

    @memory.retry_transient_io(base_delay=0.5)
    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError(5, "Input/output error")
        return "ok"

    assert flaky() == "ok" and sleeps == [0.5, 1.0]
    with pytest.raises(FileNotFoundError):
        memory.retry_transient_io(lambda: open("/nonexistent/x"))()
    assert memory.should_reduce_batch_size(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried"))
    assert not memory.should_reduce_batch_size(RuntimeError("shape mismatch"))
    tried = []

    @memory.find_executable_batch_size(starting_batch_size=64)
    def train(batch_size):
        tried.append(batch_size)
        if batch_size > 16:
            raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return batch_size

    assert train() == 16 and tried == [64, 32, 16]


def test_crc_matches_zlib(tmp_path):
    path = tmp_path / "f.bin"
    data = os.urandom(3 * (1 << 20) + 17)
    path.write_bytes(data)
    assert ft._file_crc32(str(path)) == format(zlib.crc32(data) & 0xFFFFFFFF, "08x")
