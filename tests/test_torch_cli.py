"""The port's CLI (``accelerate_tpu_torch.commands``) against the JAX
package's (``accelerate_tpu.commands``), on the same inputs, on the CPU.

- the launcher's environment in ``Accelerator``: both packages take the
  accumulation steps and the seed from the same names;
- flags: every subcommand both packages register has the same flags,
  defaults and choices, but for ``DIFFERENCES`` (each from the port's
  process model: one process per card);
- ``config --default`` writes the same YAML, and each package loads the
  other's;
- ``launch``'s environment: ``build_env`` is the JAX package's for the same
  flags, environment and config file, and each process adds only its
  coordinates;
- ``estimate-memory``, ``verify-checkpoint`` and ``trace``: the same output
  and exit code on the same inputs (the checkpoint format is shared);
- the menu's cases of ``tests/test_menu.py`` and ``notebook_launcher``;
- processes: ``launch --num_processes 2`` of the multiprocess script on the
  CPU over gloo, ``test --device cpu``, and a launch that fails fast, each
  run once per session (``torch_shared.once``).
"""

import argparse
import contextlib
import importlib
import io
import json
import os
import pty
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from torch_shared import once

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMANDS = ("config", "env", "estimate", "launch", "profile", "serve_bench", "test", "trace", "verify")
# flags only the port has, by subcommand, each from its process model
DIFFERENCES = {
    # the world spread over machines (one process per card; the JAX package
    # runs one per host, so its --process_id is the whole placement)
    "launch": {"--num_machines", "--machine_rank"},
    # launch never moves a script off the card: the script is told where to run
    "test": {"--device"},
    # the engine's device (a CPU run is asked for, as everywhere in the port)
    "serve-bench": {"--device"},
}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _reset_states():
    from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
    from accelerate_tpu.state import GradientState as JaxGradientState
    from accelerate_tpu.state import PartialState as JaxPartialState
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    for cls in (JaxAcceleratorState, JaxGradientState, JaxPartialState, AcceleratorState, GradientState,
                PartialState):
        cls._reset_state()


def _subparsers(package: str) -> dict:
    parser = argparse.ArgumentParser()
    subparsers = parser.add_subparsers()
    for name in COMMANDS:
        importlib.import_module(f"{package}.commands.{name}").register_subcommand(subparsers)
    return dict(subparsers.choices)


def _flags(parser) -> dict:
    """Every action but help: (dest, default, choices, nargs, type,
    required, const, kind)."""
    out = {}
    for action in parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        key = action.option_strings[0] if action.option_strings else action.dest
        out[key] = (action.dest, action.default, tuple(action.choices) if action.choices else None, action.nargs,
                    getattr(action.type, "__name__", action.type), action.required, action.const,
                    type(action).__name__)
    return out


def _parse(package: str, argv: list):
    return _subparsers(package)[argv[0]].parse_args(argv[1:])


def _run(package: str, argv: list) -> tuple:
    """``(exit code, stdout, stderr)`` of a subcommand run in this process."""
    args = _parse(package, argv)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = args.func(args)
    return code, out.getvalue(), err.getvalue()


# -- the launcher's environment in Accelerator ---------------------------------


def test_accelerator_reads_the_launchers_accumulation_steps_and_seed():
    """With no plugin and no argument, ``ACCELERATE_GRADIENT_ACCUMULATION_
    STEPS`` sets the window, and ``ACCELERATE_SEED`` seeds numpy: the same
    window and the same draw from both packages' ``Accelerator``."""
    from accelerate_tpu import Accelerator as JaxAccelerator
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils import patch_environment

    draws = {}
    with patch_environment(ACCELERATE_GRADIENT_ACCUMULATION_STEPS=4, ACCELERATE_SEED=7):
        for name, build in (("jax", JaxAccelerator), ("port", lambda: Accelerator(device="cpu"))):
            _reset_states()
            np.random.seed(123)
            accelerator = build()
            draws[name] = (accelerator.gradient_accumulation_steps, np.random.rand(4))
    _reset_states()
    assert draws["jax"][0] == draws["port"][0] == 4
    np.testing.assert_array_equal(draws["port"][1], draws["jax"][1])
    np.random.seed(7)
    np.testing.assert_array_equal(draws["port"][1], np.random.rand(4))


def test_accelerator_argument_beats_the_launchers_steps():
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils import patch_environment

    with patch_environment(ACCELERATE_GRADIENT_ACCUMULATION_STEPS=4):
        _reset_states()
        assert Accelerator(device="cpu", gradient_accumulation_steps=2).gradient_accumulation_steps == 2
    _reset_states()


def test_every_name_build_env_writes_is_read_by_the_port():
    """``ACCELERATE_MIXED_PRECISION``, ``ACCELERATE_DEBUG_MODE`` and the axis
    sizes, as the JAX package's ``build_env`` writes them, reach the port's
    state and ``ParallelismConfig``."""
    from accelerate_tpu_torch.state import AcceleratorState
    from accelerate_tpu_torch.utils import ParallelismConfig, patch_environment

    sizes = dict(ACCELERATE_DATA_PARALLEL_SIZE=1, ACCELERATE_FSDP_SIZE=2, ACCELERATE_TENSOR_SIZE=3,
                 ACCELERATE_SEQUENCE_SIZE=4, ACCELERATE_PIPELINE_SIZE=5, ACCELERATE_EXPERT_SIZE=6)
    with patch_environment(**sizes):
        config = ParallelismConfig.from_env()
    assert (config.data, config.fsdp, config.tensor, config.sequence, config.pipeline, config.expert) == (
        1, 2, 3, 4, 5, 6)
    with patch_environment(ACCELERATE_MIXED_PRECISION="bf16", ACCELERATE_DEBUG_MODE=1):
        _reset_states()
        state = AcceleratorState(device="cpu")
        assert state.mixed_precision == "bf16" and state.debug
    _reset_states()


# -- flags ----------------------------------------------------------------------


def test_cli_registers_every_ported_subcommand():
    from accelerate_tpu_torch.commands.cli import build_parser

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        build_parser().print_help()
    for name in ("config", "env", "launch", "test", "estimate-memory", "verify-checkpoint", "trace", "profile",
                 "serve-bench"):
        assert name in out.getvalue()


@pytest.mark.parametrize("name", ["config", "env", "estimate-memory", "launch", "profile", "serve-bench", "test",
                                  "trace", "verify-checkpoint"])
def test_subcommand_flags_match_the_jax_package(name):
    jax_flags = _flags(_subparsers("accelerate_tpu")[name])
    port_flags = _flags(_subparsers("accelerate_tpu_torch")[name])
    extra = DIFFERENCES.get(name, set())
    assert set(port_flags) - set(jax_flags) == extra
    assert set(jax_flags) <= set(port_flags)
    for flag, spec in jax_flags.items():
        assert port_flags[flag] == spec, flag


# -- config -----------------------------------------------------------------------


def test_config_default_writes_the_jax_packages_yaml(tmp_path):
    from accelerate_tpu.commands import config as jax_config
    from accelerate_tpu_torch.commands import config

    for package, path in (("accelerate_tpu", tmp_path / "jax.yaml"), ("accelerate_tpu_torch", tmp_path / "port.yaml")):
        code, out, _ = _run(package, ["config", "--default", "--config_file", str(path)])
        assert code == 0 and str(path) in out
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()
    assert config.load_config_from_file(str(tmp_path / "jax.yaml")) == jax_config.default_config()
    assert jax_config.load_config_from_file(str(tmp_path / "port.yaml")) == config.default_config()
    # each package's default file is its own
    assert config.DEFAULT_CONFIG_FILE != jax_config.DEFAULT_CONFIG_FILE
    assert os.path.basename(os.path.dirname(config.DEFAULT_CONFIG_FILE)) == "accelerate_tpu_torch"


def test_config_questionnaire_writes_the_jax_packages_answers(tmp_path, monkeypatch):
    from accelerate_tpu.commands import config as jax_config
    from accelerate_tpu_torch.commands import config

    answers = ["2", "", "", "2", "", "", "", "4"]  # the menu takes the plain fallback (no terminal)
    monkeypatch.setattr("sys.stdin", type("S", (), {"isatty": lambda self: False})())
    built = {}
    for name, module in (("jax", jax_config), ("port", config)):
        feed = iter(answers)
        monkeypatch.setattr("builtins.input", lambda prompt="", feed=feed: next(feed))
        with contextlib.redirect_stdout(io.StringIO()):
            built[name] = module.build_config_interactive()
    assert built["port"] == built["jax"]
    assert built["port"]["num_processes"] == 2 and built["port"]["gradient_accumulation_steps"] == 4


# -- launch's environment -------------------------------------------------------------

LAUNCH_CASES = {
    "flags": ([], {}, None),
    "env over config": (["--mixed_precision", "fp16"], {"ACCELERATE_TENSOR_SIZE": "2", "ACCELERATE_SEED": "3"},
                        {"mixed_precision": "bf16", "seed": 9, "parallelism": {"tensor": 4, "fsdp": 2}}),
    "config only": ([], {}, {"mixed_precision": "no", "num_processes": 4, "coordinator_address": "node0:1234",
                             "gradient_accumulation_steps": 8, "seed": 5,
                             "parallelism": {"data": 2, "fsdp": 2, "pipeline": 1, "expert": 1, "sequence": 1,
                                             "tensor": 1}}),
    "debug and every axis": (["--debug", "--data_parallel_size", "2", "--fsdp_size", "1", "--tensor_size", "1",
                              "--sequence_size", "1", "--pipeline_size", "1", "--expert_size", "1",
                              "--process_id", "0", "--coordinator_address", "localhost:8476"], {}, None),
}
# the names each process adds to build_env's
PER_PROCESS = {"RANK", "WORLD_SIZE", "LOCAL_RANK", "ACCELERATE_PROCESS_ID", "ACCELERATE_NUM_PROCESSES",
               "ACCELERATE_INIT_METHOD", "OMP_NUM_THREADS", "PYTHONPATH"}


@pytest.mark.parametrize("case", sorted(LAUNCH_CASES))
def test_launch_env_is_the_jax_packages_plus_each_process_coordinates(case, tmp_path, monkeypatch):
    from accelerate_tpu.commands import launch as jax_launch
    from accelerate_tpu_torch.commands import launch

    flags, env, config = LAUNCH_CASES[case]
    for key in [k for k in os.environ if k.startswith("ACCELERATE_")] + ["OMP_NUM_THREADS"]:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    config_file = tmp_path / "config.yaml"
    if config is not None:
        config_file.write_text(yaml.safe_dump(config))
    argv = ["launch", "--config_file", str(config_file), "--num_processes", "2", "--gradient_accumulation_steps",
            "3", *flags, "train.py", "--lr", "1"]
    if case == "config only":
        argv = [a for a in argv if a not in ("--num_processes", "2")]
    want = jax_launch.build_env(_parse("accelerate_tpu", argv))
    args = _parse("accelerate_tpu_torch", argv)
    got = launch.build_env(args)
    assert got == want
    assert launch.script_command(args)[1:] == ["train.py", "--lr", "1"]

    world = int(want["ACCELERATE_NUM_PROCESSES"])
    machines = 1
    if case == "config only":  # a coordinator: this machine is one of two
        machines = args.num_machines = 2
        args.machine_rank = 1
    per_machine = world // machines
    processes = launch.process_envs(args, got, str(tmp_path))
    assert len(processes) == per_machine
    rendezvous = "tcp://node0:1234" if case == "config only" else (
        "tcp://localhost:8476" if "--coordinator_address" in flags else f"file://{tmp_path}/store")
    for local, env_of in enumerate(processes):
        rank = (machines - 1) * per_machine + local
        assert {k: v for k, v in env_of.items() if k not in PER_PROCESS} == {
            k: v for k, v in want.items() if k not in PER_PROCESS}
        assert (env_of["RANK"], env_of["WORLD_SIZE"], env_of["LOCAL_RANK"]) == (str(rank), str(world), str(local))
        assert (env_of["ACCELERATE_PROCESS_ID"], env_of["ACCELERATE_NUM_PROCESSES"]) == (str(rank), str(world))
        assert env_of["ACCELERATE_INIT_METHOD"] == rendezvous
        assert env_of["OMP_NUM_THREADS"] == "1"
        assert env_of["PYTHONPATH"].split(os.pathsep)[0] == REPO_ROOT


def test_launch_without_a_card_or_a_count_raises_naming_the_flag(monkeypatch):
    from accelerate_tpu_torch.commands import launch

    monkeypatch.delenv("ACCELERATE_NUM_PROCESSES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="--num_processes"):
        launch.world_size({})
    with pytest.raises(ValueError, match="coordinator_address"):
        launch.rendezvous({}, 2, "/unused")


def test_profile_sets_the_window_and_refuses_a_port(tmp_path, monkeypatch):
    from accelerate_tpu.commands import profile as jax_profile
    from accelerate_tpu_torch.commands import profile
    from accelerate_tpu_torch.telemetry.profiler import NO_SERVER

    monkeypatch.delenv("ACCELERATE_NUM_PROCESSES", raising=False)
    argv = ["profile", "--output-dir", str(tmp_path), "--start-step", "3", "--num-steps", "2", "--num_processes", "1",
            "train.py"]
    assert profile.build_env(_parse("accelerate_tpu_torch", argv)) == jax_profile.build_env(
        _parse("accelerate_tpu", argv))
    with pytest.raises(ValueError, match="no counterpart"):
        profile.build_env(_parse("accelerate_tpu_torch", argv[:1] + ["--port", "9012"] + argv[1:]))
    assert "no counterpart" in NO_SERVER


# -- estimate-memory -------------------------------------------------------------------


def _write_checkpoints(root):
    """An .npz checkpoint, a sharded safetensors directory with its index,
    and an HF config.json without weights."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    npz = root / "weights.npz"
    np.savez(npz, embed=rng.normal(size=(64, 16)).astype(np.float32), head=np.zeros((16, 3), np.float16),
             step=np.zeros((), np.int64))
    sharded = root / "sharded"
    sharded.mkdir()
    weight_map = {}
    for i, shard in enumerate(({"a.w": np.ones((8, 8), np.float32)}, {"b.w": np.ones((32, 4), np.float16),
                                                                      "b.bias": np.ones(4, np.float32)})):
        name = f"model-0000{i + 1}-of-00002.safetensors"
        save_file(shard, str(sharded / name))
        weight_map.update({k: name for k in shard})
    (sharded / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    (sharded / "stray.safetensors").write_bytes(b"not listed in the index")
    hf = root / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama", "vocab_size": 1000, "hidden_size": 256,
        "intermediate_size": 512, "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
        "max_position_embeddings": 512, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
        "tie_word_embeddings": False}))
    return {"npz": str(npz), "sharded": str(sharded), "hf": str(hf)}


ESTIMATE_CASES = {
    "llama-7b": ["llama-7b"],
    "gpt2-1.5b": ["gpt2-1.5b", "--batch", "4", "--max-seq-len", "1024"],
    "bert-base": ["bert-base", "--max-seq-len", "128"],
    "t5-base": ["t5-base", "--replicas", "1"],
    "params": ["params=1.3e9", "--dtypes", "float32", "bfloat16", "int4", "fp8"],
    "npz": ["{npz}"],
    "sharded safetensors": ["{sharded}", "--replicas", "16"],
    "hf config": ["{hf}", "--page-size", "32"],
    "elastic redundancy": ["llama-7b", "--elastic-redundancy", "1", "--replicas", "4"],
    "elastic redundancy one replica": ["llama-1b", "--elastic-redundancy", "1", "--replicas", "1"],
}


@pytest.mark.parametrize("case", sorted(ESTIMATE_CASES))
def test_estimate_memory_prints_the_jax_packages_numbers(case, tmp_path):
    paths = _write_checkpoints(tmp_path)
    argv = ["estimate-memory"] + [a.format(**paths) for a in ESTIMATE_CASES[case]]
    want = _run("accelerate_tpu", argv)
    got = _run("accelerate_tpu_torch", argv)
    assert got == want
    assert want[0] == 0 and "|" in want[1]


def test_elastic_redundancy_bytes_matches_the_jax_package():
    from accelerate_tpu.parallel.zero import elastic_redundancy_bytes as jax_bytes
    from accelerate_tpu_torch.parallel.zero import elastic_redundancy_bytes

    for n, b, replicas, redundancy in ((7_000_000_000, 2, 8, 1), (1_234_567, 4, 3, 1), (10, 0.5, 4, 0),
                                       (999, 1, 1, 1), (5, 2, 0, 2)):
        assert elastic_redundancy_bytes(n, b, replicas, redundancy) == jax_bytes(n, b, replicas, redundancy)


# -- verify-checkpoint ----------------------------------------------------------------


def _port_checkpoints(base: str) -> None:
    """Two checkpoints of a small model, saved by the port's manager."""
    from accelerate_tpu_torch import Accelerator, adamw
    from accelerate_tpu_torch.test_utils.training import RegressionModel

    _reset_states()
    accelerator = Accelerator(device="cpu")
    model, optimizer = accelerator.prepare(RegressionModel(), adamw(1e-2))
    manager = accelerator.checkpoint_manager(base, handle_signals=())
    batch = {"x": torch.arange(4.0), "y": torch.ones(4)}
    for step in (1, 2):
        accelerator.backward(RegressionModel.loss_fn, batch)
        optimizer.step()
        optimizer.zero_grad()
        manager.save(step)
    _reset_states()


def _corrupt(directory: str) -> None:
    """One byte of the first file the manifest lists, flipped in place."""
    with open(os.path.join(directory, "manifest.json")) as f:
        name = sorted(json.load(f)["files"])[0]
    path = os.path.join(directory, name)
    with open(path, "r+b") as f:
        byte = f.read(1)
        f.seek(0)
        f.write(bytes([byte[0] ^ 0xFF]))


VERIFY_CASES = {
    "ok": ([], lambda base: None),
    "ok one checkpoint": (["/checkpoint_2"], lambda base: None),
    "corrupted": ([], lambda base: _corrupt(os.path.join(base, "checkpoint_1"))),
    "corrupted no checksums": (["--no-checksums"], lambda base: _corrupt(os.path.join(base, "checkpoint_1"))),
    "repair": (["--repair"], lambda base: (_corrupt(os.path.join(base, "checkpoint_1")),
                                           os.makedirs(os.path.join(base, "checkpoint_3.tmp")))),
}


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_verify_checkpoint_gives_the_jax_packages_verdict(case, tmp_path):
    saved = str(tmp_path / "saved")
    _port_checkpoints(saved)
    extra, damage = VERIFY_CASES[case]
    base = str(tmp_path / "checkpoints")
    target = base + extra[0] if extra and extra[0].startswith("/") else base
    flags = [a for a in extra if not a.startswith("/")]
    results = {}
    for package in ("accelerate_tpu", "accelerate_tpu_torch"):
        shutil.rmtree(base, ignore_errors=True)
        shutil.copytree(saved, base)
        damage(base)
        code, out, err = _run(package, ["verify-checkpoint", target, *flags])
        results[package] = (code, out, err, sorted(os.listdir(base)))
    assert results["accelerate_tpu_torch"] == results["accelerate_tpu"]
    want_code = 1 if case.startswith("corrupted") and "no checksums" not in case else 0
    assert results["accelerate_tpu"][0] == want_code
    if case == "repair":
        assert results["accelerate_tpu"][3] == ["checkpoint_2"]


# -- trace ---------------------------------------------------------------------------


def _trace_jsonl(path) -> None:
    """Traced requests of a scripted fleet (fixed stamps) as the telemetry
    hub writes them: one handed off between pools, one shed, one plain."""
    from accelerate_tpu_torch.telemetry import RequestTracer

    tracer = RequestTracer()
    t = 100.0
    for rid, (replica, handoff, reason) in enumerate((("p0", "d1", "length"), ("p0", None, "shed"),
                                                      ("r2", None, "eos"))):
        tracer.begin(rid, stamp=t + rid, prompt_len=8 + rid)
        tracer.span_start(rid, "queued", stamp=t + rid, replica=replica)
        tracer.span_end(rid, "queued", stamp=t + rid + 0.25)
        tracer.span_start(rid, "prefill", stamp=t + rid + 0.25, replica=replica)
        tracer.span_end(rid, "prefill", stamp=t + rid + 0.5)
        if handoff:
            tracer.span_start(rid, "handoff_attempt", stamp=t + rid + 0.5, replica=replica)
            tracer.span_end(rid, "handoff_attempt", stamp=t + rid + 0.75)
            replica = handoff
        tracer.event(rid, "first_token", stamp=t + rid + 0.8, replica=replica)
        tracer.span_start(rid, "decode", stamp=t + rid + 0.8, replica=replica)
        tracer.mark_decode(rid, 4, t + rid + 1.0)
        tracer.retire(rid, reason, stamp=t + rid + 1.5 + rid, replica=replica)
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "step", "step": 1}) + "\n")
        for record in tracer.completed:
            f.write(json.dumps({"kind": "trace", **record}) + "\n")
        f.write('{"kind": "trace", "torn')  # a crashed run's last line


@pytest.mark.parametrize("flags", [[], ["--summary", "--top", "2"], ["--request-id", "0"], ["--trace-id", "none"]],
                         ids=["all", "summary", "request", "no match"])
def test_trace_writes_the_jax_packages_perfetto_json(flags, tmp_path):
    jsonl = tmp_path / "telemetry.jsonl"
    _trace_jsonl(jsonl)
    results = {}
    for package in ("accelerate_tpu", "accelerate_tpu_torch"):
        out_path = tmp_path / f"{package}.json"
        code, out, err = _run(package, ["trace", str(tmp_path), "--out", str(out_path), *flags])
        payload = json.loads(out_path.read_text()) if out_path.exists() else None
        results[package] = (code, out.replace(str(out_path), "OUT"), err, payload)
    assert results["accelerate_tpu_torch"] == results["accelerate_tpu"]
    assert results["accelerate_tpu"][0] == (1 if "none" in flags else 0)


# -- the menu (tests/test_menu.py's cases) ---------------------------------------------------


def _plain_stdin(monkeypatch):
    monkeypatch.setattr("sys.stdin", type("S", (), {"isatty": lambda self: False})())


def test_menu_plain_fallback_default(monkeypatch):
    from accelerate_tpu_torch.commands.menu import BulletMenu

    _plain_stdin(monkeypatch)
    monkeypatch.setattr("builtins.input", lambda prompt="": "")
    assert BulletMenu("pick", ["a", "b", "c"], default=1).run() == 1


def test_menu_plain_fallback_by_index_and_name(monkeypatch):
    from accelerate_tpu_torch.commands.menu import BulletMenu, select

    _plain_stdin(monkeypatch)
    monkeypatch.setattr("builtins.input", lambda prompt="": "2")
    assert BulletMenu("pick", ["a", "b", "c"]).run() == 2
    monkeypatch.setattr("builtins.input", lambda prompt="": "fp16")
    assert select("precision?", ["no", "fp16", "bf16"], "bf16") == "fp16"


def test_menu_plain_fallback_rejects_out_of_range(monkeypatch):
    from accelerate_tpu_torch.commands.menu import BulletMenu

    _plain_stdin(monkeypatch)
    monkeypatch.setattr("builtins.input", lambda prompt="": "7")
    with pytest.raises(ValueError, match="out of range"):
        BulletMenu("pick", ["a", "b"]).run()


def _drive_tty(script: str, keys, ready: bytes) -> str:
    """Run ``script`` on a pty; send ``keys`` once ``ready`` is drawn
    (before that the child's terminal is still in canonical mode)."""
    import select as select_mod

    # the menu module alone, by path: the package's __init__ would import torch
    path = os.path.join(REPO_ROOT, "accelerate_tpu_torch", "commands", "menu.py")
    prelude = ("import importlib.util;"
               f"spec = importlib.util.spec_from_file_location('menu', {path!r});"
               "menu = importlib.util.module_from_spec(spec); spec.loader.exec_module(menu)\n")
    master, slave = pty.openpty()
    proc = subprocess.Popen([sys.executable, "-c", prelude + script], stdin=slave, stdout=slave,
                            stderr=subprocess.DEVNULL, close_fds=True)
    os.close(slave)
    out, sent = b"", False
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        readable, _, _ = select_mod.select([master], [], [], 0.2)
        if readable:
            try:
                chunk = os.read(master, 1024)
            except OSError:
                break  # the child exited and released the terminal
            if not chunk:
                break
            out += chunk
        if not sent and ready in out:
            time.sleep(0.3)  # let the cbreak setting land
            os.write(master, keys)
            sent = True
        if proc.poll() is not None and not readable:
            break
    proc.wait(timeout=10)
    os.close(master)
    return out.decode(errors="replace")


PICK = "print('PICKED', menu.BulletMenu('pick', ['no', 'fp16', 'bf16']).run())"


def test_menu_tty_arrow_navigation():
    assert "PICKED 2" in _drive_tty(PICK, b"\x1b[B\x1b[B\r", b"bf16")  # down, down, enter


def test_menu_tty_digit_jump_and_wraparound():
    assert "PICKED 2" in _drive_tty(PICK, b"\x1b[A\r", b"bf16")  # up from 0 wraps to the last
    assert "PICKED 1" in _drive_tty(PICK, b"1\r", b"bf16")


def test_menu_tty_eof_raises_instead_of_spinning():
    """Ctrl-D in cbreak (a 0-byte read) raises EOFError; the menu does not spin."""
    script = "try:\n    menu.BulletMenu('pick', ['a', 'b']).run()\nexcept EOFError:\n    print('EOF-OK')\n"
    assert "EOF-OK" in _drive_tty(script, b"\x04", b"b\r\n")


def test_menu_ss3_arrows_navigate():
    assert "PICKED 1" in _drive_tty(PICK, b"\x1bOB\r", b"bf16")  # SS3 down


# -- notebook_launcher -------------------------------------------------------------------------


def _precision_and_device():
    from accelerate_tpu_torch import Accelerator

    accelerator = Accelerator(device="cpu")
    return accelerator.mixed_precision, str(accelerator.device), os.environ.get("ACCELERATE_MIXED_PRECISION")


def test_notebook_launcher_runs_one_process_inline(monkeypatch):
    from accelerate_tpu_torch import notebook_launcher

    monkeypatch.delenv("ACCELERATE_MIXED_PRECISION", raising=False)
    _reset_states()
    assert notebook_launcher(_precision_and_device, num_processes=1, mixed_precision="bf16") == (
        "bf16", "cpu", "bf16")
    assert "ACCELERATE_MIXED_PRECISION" not in os.environ
    _reset_states()


def test_notebook_launcher_rejects_a_bad_precision_and_no_card(monkeypatch):
    from accelerate_tpu_torch import notebook_launcher

    with pytest.raises(ValueError, match="mixed_precision"):
        notebook_launcher(_precision_and_device, num_processes=1, mixed_precision="fp64")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="num_processes"):
        notebook_launcher(_precision_and_device)


# -- processes (each launch once per session) ------------------------------------------------------


def _cli(args: list, timeout: float = 240) -> dict:
    """One CLI command from a clean environment: its exit code, output and
    seconds."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_")
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "OMP_NUM_THREADS")}
    env["PYTHONPATH"] = REPO_ROOT + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env["XDG_CACHE_HOME"] = os.path.join(REPO_ROOT, "_scratch", "no-config")  # no default config file
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "accelerate_tpu_torch.commands.cli", *args], cwd=REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return {"code": out.returncode, "stdout": out.stdout, "stderr": out.stderr, "seconds": time.monotonic() - t0}


def test_launch_runs_the_multiprocess_script_in_two_processes(request, tmp_path_factory):
    result = once(request, tmp_path_factory, "cli_launch_multiprocess", lambda: _cli(
        ["launch", "--num_processes", "2", "-m", "accelerate_tpu_torch.test_utils.scripts.multiprocess_script",
         "--device", "cpu", "--backend", "gloo"]))
    assert result["code"] == 0, result["stderr"][-3000:]
    lines = [json.loads(line) for line in result["stdout"].splitlines() if line.startswith('{"multiprocess_ok"')]
    assert lines == [{"multiprocess_ok": True, "processes": 2, "ranks": [0, 1], "devices": ["cpu", "cpu"],
                      "backend": "gloo"}]


def test_test_command_passes_on_the_cpu(request, tmp_path_factory):
    """``test --device cpu``: the sanity script in one process, its training
    held against its own plain loop inside."""
    result = once(request, tmp_path_factory, "cli_test_cpu", lambda: _cli(["test", "--device", "cpu"]))
    assert result["code"] == 0, result["stderr"][-3000:]
    assert "All distributed correctness checks passed." in result["stdout"]
    assert "Test is a success!" in result["stdout"]


def test_launch_fails_fast_with_the_failing_processs_code(request, tmp_path_factory):
    def run():
        script = tmp_path_factory.mktemp("fail_fast") / "fail_fast.py"
        script.write_text("import os, sys, time\nif os.environ['RANK'] == '1':\n    sys.exit(3)\ntime.sleep(120)\n")
        return _cli(["launch", "--num_processes", "2", str(script)])

    result = once(request, tmp_path_factory, "cli_fail_fast", run)
    assert result["code"] == 3, result["stderr"][-3000:]
    assert "process 1 of 2 exited with code 3" in result["stderr"]
    assert result["seconds"] < 60  # the sleeping process is stopped a few seconds after the failure
