"""The port's big-model inference (``accelerate_tpu_torch/big_modeling.py``,
``utils/modeling.py``, ``utils/offload.py``) against the JAX package's
(``accelerate_tpu/big_modeling.py``; its tests ``tests/test_big_modeling.py``)
on the CPU, at three-layer tiny configs of llama, gpt2, bert and t5.

Tolerances:

- the shape tree of ``init_empty_weights``, the component sizes and the auto
  device maps (plain and quantized, explicit budgets; llama-70b from shapes)
  equal the JAX package's exactly; an offload folder written by either
  package reads in the other with the bfloat16 bytes identical;
- streamed forward logits under device, cpu, disk and mixed maps match the
  JAX package's ``StreamedModel`` at rtol 1e-4 / atol 1e-5 (the tolerance
  of ``tests/test_torch_models.py``: fp32 sums in other orders);
- within the port, streamed logits equal the all-device dispatch's bit for
  bit, with groups of one layer and of every layer;
- greedy streamed ``generate`` tokens equal the JAX package's exactly;
- int8 and int4 ``load_and_quantize_model`` logits match the JAX package's
  at rtol 1e-5 / atol 1e-5 (``tests/test_torch_quantization.py``'s fp32
  tolerance);
- evict/restore, the hook chain and the engine over a disk-placed model
  give the same outputs exactly as the resident model.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models import GPT2 as JaxGPT2
from accelerate_tpu.models import T5 as JaxT5
from accelerate_tpu.models import Bert as JaxBert
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.utils import modeling as jmodeling
from accelerate_tpu.utils import offload as joffload
from accelerate_tpu.utils import quantization as jquant
from accelerate_tpu_torch import (
    GPT2,
    T5,
    Bert,
    Llama,
    QuantizationConfig,
    ServingEngine,
    cpu_offload,
    cpu_offload_with_hook,
    dispatch_model,
    init_empty_weights,
    load_and_quantize_model,
    load_checkpoint_and_dispatch,
)
from accelerate_tpu_torch import big_modeling as bm
from accelerate_tpu_torch.models import get_config
from accelerate_tpu_torch.utils import modeling, offload
from accelerate_tpu_torch.utils.hf_import import export_hf_llama

RTOL, ATOL = 1e-4, 1e-5
FAMILIES = {  # name: (JAX class, port class, registry config)
    "llama": (JaxLlama, Llama, "llama-tiny"),
    "gpt2": (JaxGPT2, GPT2, "gpt2-tiny"),
    "bert": (JaxBert, Bert, "bert-tiny"),
    "t5": (JaxT5, T5, "t5-tiny"),
}
MAPS = ("device", "cpu", "disk", "mixed")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _inputs(family, vocab):
    rng = np.random.default_rng(len(family))
    ids = rng.integers(1, vocab, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 9:] = 0
    if family == "bert":
        return (ids, mask, rng.integers(0, 2, (2, 12)).astype(np.int32))
    if family == "t5":
        return (ids, rng.integers(1, vocab, (2, 7)).astype(np.int32), mask)
    return (ids, mask)


def _map(model, kind):
    """The named device map: every layer at one target, or mixed (layers by
    index over cpu, disk, device; the first resident component on disk,
    the second in host memory)."""
    names = list(modeling.named_component_sizes(model))
    if kind != "mixed":
        return bm.make_layered_device_map(model, kind)
    residents = [n for n in names if not n.startswith("layers.")]
    out = {n: "device" for n in residents}
    out[residents[0]], out[residents[1]] = "disk", "cpu"
    for i, n in enumerate(n for n in names if n.startswith("layers.")):
        out[n] = ("cpu", "disk", "device")[i % 3]
    return out


def _params(port_model, seed):
    """Seeded numpy params in the JAX layout, from the port's shape tree:
    matrices at 0.5/sqrt(fan-in), vectors (norms, biases) about 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, leaf in modeling._iter_flat(init_empty_weights(port_model)):
        shape = tuple(leaf.shape)
        value = rng.normal(0.0, 0.5 / np.sqrt(shape[-2]), shape) if len(shape) > 1 + key.startswith(
            ("layers/", "encoder/")) else 1.0 + 0.1 * rng.normal(size=shape)
        out[key] = value.astype(np.float32)
    return modeling._unflatten(out)


class Zoo:
    """Per family, built on first use (a test worker pays for the families
    its tests need): the JAX model, the numpy params, a port model on
    ``meta``, the inputs, and the JAX ``StreamedModel``'s logits under the
    mixed map."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.cases: dict = {}
        self.wants: dict = {}

    def __getitem__(self, family):
        if family not in self.cases:
            jax_cls, port_cls, name = FAMILIES[family]
            cfg = get_config(name).replace(num_layers=3)
            port_model = port_cls(cfg, device="meta")
            self.cases[family] = (jax_cls(cfg), _params(port_model, len(family)), port_model,
                                  _inputs(family, cfg.vocab_size))
        return self.cases[family]

    def want(self, family):
        if family not in self.wants:
            jax_model, params, port_model, inputs = self[family]
            streamed = jbm.dispatch_model(jax_model, params, _map(port_model, "mixed"),
                                          offload_dir=str(self.tmp.mktemp(f"jax-{family}")), dtype=jnp.float32)
            self.wants[family] = np.asarray(streamed(*(jnp.asarray(x) for x in inputs)))
        return self.wants[family]


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    return Zoo(tmp_path_factory)


def test_init_empty_weights_is_the_jax_shape_tree_and_allocates_nothing(zoo):
    for family in FAMILIES:
        jax_model, _, port_model, _ = zoo[family]
        abstract = jbm.init_empty_weights(jax_model)
        want = {k: (tuple(v.shape), np.dtype(v.dtype)) for k, v in jmodeling._iter_flat(abstract)}
        tree = init_empty_weights(port_model)
        got = {k: (tuple(v.shape), np.dtype(str(v.dtype).split(".")[-1])) for k, v in modeling._iter_flat(tree)}
        assert got == want, family
        assert all(v.device.type == "meta" for _, v in modeling._iter_flat(tree))
    real = Llama("llama-tiny", device="cpu")
    assert all(v.device.type == "meta" for _, v in modeling._iter_flat(init_empty_weights(real)))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sizes_and_auto_maps_equal_the_jax_package(zoo, family):
    """Component sizes and the greedy map at explicit budgets that spill over
    all three targets, plain and at int8/int4 layer bytes."""
    jax_model, _, port_model, _ = zoo[family]
    for dtype_bytes in (4, 2):
        assert modeling.named_component_sizes(port_model, dtype_bytes) == jmodeling.named_component_sizes(
            jax_model, dtype_bytes)
    assert modeling.compute_module_sizes(port_model, 4) == jmodeling.compute_module_sizes(jax_model, 4)
    sizes = modeling.named_component_sizes(port_model, 2)
    layer = sizes["layers.0"]
    resident = sum(v for k, v in sizes.items() if not k.startswith("layers."))
    budget = {"device": resident + 3 * layer, "cpu": layer + 1}
    for layer_bytes in (None, 1, 0.5):
        want = jmodeling.infer_auto_device_map(jax_model, max_memory=budget, dtype_bytes=2,
                                               layer_dtype_bytes=layer_bytes)
        got = modeling.infer_auto_device_map(port_model, max_memory=budget, dtype_bytes=2,
                                             layer_dtype_bytes=layer_bytes, device="cpu")
        assert got == want
    plain = modeling.infer_auto_device_map(port_model, max_memory=budget, dtype_bytes=2, device="cpu")
    assert set(plain.values()) == {"device", "cpu", "disk"}


def test_llama_70b_auto_map_from_shapes_alone():
    """llama-70b on ``meta``: the map equals the JAX package's and no byte
    of its weights exists."""
    model = Llama("llama-70b", device="meta")
    budget = {"device": "40GB", "cpu": "60GB"}
    got = modeling.infer_auto_device_map(model, max_memory=budget, device="cpu")
    assert got == jmodeling.infer_auto_device_map(JaxLlama("llama-70b"), max_memory=budget)
    assert {"device", "cpu", "disk"} == set(got.values())
    assert all(p.device.type == "meta" for p in model.parameters())
    assert modeling.get_max_memory(device="cpu")["device"] == int(2**34 * 0.9)


def test_tied_parameters_and_byte_sizes_as_the_jax_package():
    """Ties are the same object or views of the same bytes (a reshape ties,
    disjoint slices do not); retying points a group at one leaf."""
    base = np.arange(24, dtype=np.float32)
    shared = np.ones((2, 3), np.float32)
    tree = {"a": base[:12], "b": base[12:], "c": base[:12].reshape(3, 4), "d": shared,
            "e": {"f": shared}, "g": np.zeros(2, np.float32)}
    assert modeling.find_tied_parameters(tree) == jmodeling.find_tied_parameters(tree) == [
        ["a", "c"], ["d", "e/f"]]
    t = torch.zeros(4)
    port_tree = {"x": t, "y": {"z": t}, "w": torch.zeros(4), "v": t.view(2, 2)}
    assert modeling.find_tied_parameters(port_tree) == [["v", "x", "y/z"]]
    untied = {"x": torch.zeros(4), "y": {"z": torch.ones(4)}}
    retied = modeling.retie_parameters(untied, [["x", "y/z"]])
    assert retied["y"]["z"] is retied["x"]
    for dtype, np_dtype in ((torch.bfloat16, "float16"), (torch.float32, "float32"), (torch.int8, "int8")):
        assert modeling.dtype_byte_size(dtype) == jmodeling.dtype_byte_size(np_dtype)


def test_offload_folders_cross_between_packages(tmp_path):
    """A folder the JAX package writes reads in the port, and the reverse:
    bfloat16 (ml_dtypes there, 2-byte words here), fp32 and a scalar."""
    import ml_dtypes

    rng = np.random.default_rng(0)
    bf16 = rng.normal(size=(5, 7)).astype(ml_dtypes.bfloat16)
    fp32 = rng.normal(size=(3,)).astype(np.float32)
    joffload.offload_state_dict(str(tmp_path / "jax"), {"w": bf16, "b": fp32, "s": np.float32(2.5)})
    loaded = offload.OffloadedWeightsLoader(save_folder=str(tmp_path / "jax"))
    assert loaded["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(loaded["w"].view(torch.int16).numpy(), bf16.view(np.int16))
    np.testing.assert_array_equal(loaded["b"].numpy(), fp32)
    assert loaded["s"].shape == () and float(loaded["s"]) == 2.5
    view = offload.PrefixedDataset(offload.OffloadedWeightsLoader({"x.a": 1}, str(tmp_path / "jax")), "x.")
    assert list(view) == ["a"] and view["a"] == 1

    weights = {"w": torch.from_numpy(bf16.view(np.int16).copy()).view(torch.bfloat16),
               "b": torch.from_numpy(fp32), "s": torch.tensor(2.5)}
    offload.offload_state_dict(str(tmp_path / "port"), weights)
    back = joffload.OffloadedWeightsLoader(save_folder=str(tmp_path / "port"))
    assert back["w"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(np.asarray(back["w"]).view(np.int16), bf16.view(np.int16))
    np.testing.assert_array_equal(back["b"], fp32)
    assert float(back["s"]) == 2.5


def test_offload_reads_bf16_where_numpy_has_no_bfloat16(tmp_path, monkeypatch):
    """The card's machine has no ``ml_dtypes``, so numpy knows no
    "bfloat16" there (here JAX registers it): the port never asks numpy."""
    real = np.dtype

    def numpy_without_ml_dtypes(name, *args, **kwargs):
        if str(name) in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
            raise TypeError(f"data type {name!r} not understood")
        return real(name, *args, **kwargs)

    weight = torch.randn(3, 4).to(torch.bfloat16)
    index = offload.offload_weight(weight, "w", str(tmp_path), {})
    monkeypatch.setattr(np, "dtype", numpy_without_ml_dtypes)
    assert torch.equal(offload.load_offloaded_weight(str(tmp_path / "w.dat"), index["w"]), weight)


@pytest.mark.parametrize("kind", MAPS)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_streamed_forward_matches_the_jax_streamed_model(zoo, family, kind, tmp_path):
    _, params, port_model, inputs = zoo[family]
    want = zoo.want(family)
    streamed = dispatch_model(port_model, params, _map(port_model, kind), offload_dir=str(tmp_path),
                              dtype=torch.float32, device="cpu")
    got = streamed(*inputs)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert streamed.hf_device_map == _map(port_model, kind)
    if kind == "disk":
        assert sorted(os.listdir(tmp_path))[-1] == "layers.2.packed.dat"
        assert streamed.streamed_bytes == 3 * streamed.packer.layer_nbytes


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_streamed_equals_all_device_bit_for_bit_at_any_group_size(zoo, family, tmp_path):
    _, params, port_model, inputs = zoo[family]
    device = dispatch_model(port_model, params, _map(port_model, "device"), dtype=torch.float32, device="cpu")
    want = device(*inputs)
    for window in (1, 1 << 30):
        streamed = dispatch_model(port_model, params, _map(port_model, "mixed"), offload_dir=str(tmp_path),
                                  dtype=torch.float32, stream_window_bytes=window, device="cpu")
        assert streamed.group_size == (1 if window == 1 else 3)
        assert torch.equal(streamed(*inputs), want)


def test_streamed_ignores_a_stale_attention_hook(zoo):
    """A hook left on the model (a ring or flash ``attention_fn``) does not
    reach the streamed layers: the padding mask in the carry holds."""
    def stale(*args, **kwargs):
        raise AssertionError("the streamed forward called the model's attention hook")

    stale.supports_bias = True
    for family in ("bert", "llama", "t5"):
        _, params, port_model, inputs = zoo[family]
        want = zoo.want(family)
        port_model.attention_fn = stale
        try:
            got = cpu_offload(port_model, params, dtype=torch.float32, device="cpu")(*inputs)
        finally:
            port_model.attention_fn = None
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("family", ["llama", "gpt2", "t5"])
def test_streamed_generate_matches_the_jax_package(zoo, family, tmp_path):
    jax_model, params, port_model, inputs = zoo[family]
    prompt = inputs[0][:, :5]
    folder = str(tmp_path)
    jax_streamed = jbm.dispatch_model(jax_model, params, _map(port_model, "cpu"), dtype=jnp.float32)
    want = jax_streamed.generate(jnp.asarray(prompt), max_new_tokens=4)
    for window in (1, 1 << 30):
        streamed = dispatch_model(port_model, params, _map(port_model, "mixed"), offload_dir=folder,
                                  dtype=torch.float32, stream_window_bytes=window, device="cpu")
        got = streamed.generate(prompt, max_new_tokens=4)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    on_device = streamed.generate(prompt, max_new_tokens=4, return_device=True)
    assert isinstance(on_device, torch.Tensor) and np.array_equal(on_device.numpy(), want)
    sampled = streamed.generate(prompt, max_new_tokens=4, temperature=1.0,
                                rng=torch.Generator().manual_seed(3))
    again = streamed.generate(prompt, max_new_tokens=4, temperature=1.0, rng=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(sampled, again)


def test_bert_has_no_streamed_decode(zoo):
    _, params, port_model, _ = zoo["bert"]
    with pytest.raises(TypeError, match="streamed-decode"):
        cpu_offload(port_model, params, dtype=torch.float32, device="cpu").generate(np.ones((1, 3)))


@pytest.mark.parametrize("bits", [8, 4])
def test_load_and_quantize_matches_the_jax_package(zoo, bits, tmp_path):
    jax_model, params, port_model, inputs = zoo["llama"]
    dm = _map(port_model, "mixed")
    want = jbm.load_and_quantize_model(
        jax_model, jquant.QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4), params=params,
        device_map=dm, offload_dir=str(tmp_path / "jax"), dtype=jnp.float32)(*(jnp.asarray(x) for x in inputs))
    streamed = load_and_quantize_model(
        port_model, QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4), params=params,
        device_map=dm, offload_dir=str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(streamed(*inputs).numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert streamed.packer.bits == bits


def test_auto_map_and_hf_checkpoint_dispatch(zoo, tmp_path):
    """``load_checkpoint_and_dispatch`` of an HF-layout llama checkpoint
    under ``"auto"`` with budgets that spill to cpu and disk, against the
    all-device dispatch of the same params."""
    from accelerate_tpu_torch.checkpointing import _save_flat

    _, params, port_model, inputs = zoo["llama"]
    _save_flat(export_hf_llama(params, port_model.config), str(tmp_path / "model.safetensors"))
    sizes = modeling.named_component_sizes(port_model, 4)
    resident = sum(v for k, v in sizes.items() if not k.startswith("layers."))
    budget = {"device": resident + 3 * sizes["layers.0"], "cpu": sizes["layers.0"]}
    streamed = load_checkpoint_and_dispatch(port_model, str(tmp_path), max_memory=budget,
                                            offload_dir=str(tmp_path / "offload"), dtype=torch.float32,
                                            device="cpu")
    assert list(streamed.hf_device_map.values())[-3:] == ["device", "cpu", "disk"]
    want = dispatch_model(port_model, params, _map(port_model, "device"), dtype=torch.float32, device="cpu")
    assert torch.equal(streamed(*inputs), want(*inputs))
    auto = dispatch_model(port_model, params, dtype=torch.float32, device="cpu")
    assert set(auto.hf_device_map.values()) == {"device"}


def test_evict_restore_and_evicted_generate(zoo):
    _, params, port_model, inputs = zoo["llama"]
    lm = dispatch_model(port_model, params, _map(port_model, "device"), dtype=torch.float32, device="cpu")
    before = lm(*inputs)
    tokens = lm.generate(inputs[0][:, :4], max_new_tokens=3)
    lm.evict()
    assert not any(lm.layer_on_device)
    assert all(v is lm._host_shadow["resident"][k] for k, v in lm.resident.items())
    assert torch.equal(lm(*inputs), before)  # executing restores
    assert all(lm.layer_on_device)
    lm.evict()
    np.testing.assert_array_equal(lm.generate(inputs[0][:, :4], max_new_tokens=3), tokens)
    lm.evict().restore()
    assert all(lm.layer_on_device) and torch.equal(lm(*inputs), before)


def test_cpu_offload_with_hook_starts_evicted_and_chains(zoo):
    _, params, port_model, inputs = zoo["llama"]
    other = {**params, "final_norm": params["final_norm"] * 2}
    lm_a, hook_a = cpu_offload_with_hook(port_model, params, dtype=torch.float32, device="cpu")
    lm_b, hook_b = cpu_offload_with_hook(port_model, other, dtype=torch.float32, device="cpu",
                                         prev_module_hook=hook_a)
    assert not any(lm_a.layer_on_device) and not any(lm_b.layer_on_device)
    out_a = lm_a(*inputs)
    assert all(lm_a.layer_on_device)
    out_b = lm_b(*inputs)
    assert not any(lm_a.layer_on_device) and all(lm_b.layer_on_device)
    assert not torch.equal(out_a, out_b)
    assert torch.equal(lm_b(*inputs), out_b) and torch.equal(lm_a(*inputs), out_a)
    hook_b.offload()
    assert not any(lm_b.layer_on_device)
    hook_b.remove()
    assert lm_b._prev_hook is None


def test_dispatch_refuses_a_model_without_the_stream_protocol():
    class NotStreamable:
        pass

    with pytest.raises(TypeError, match="stream"):
        dispatch_model(NotStreamable(), {"layers": {"w": np.zeros((2, 4))}}, {}, device="cpu")
    model = Llama("llama-tiny", device="cpu")
    with pytest.raises(ValueError, match="offload_dir"):
        dispatch_model(model, device_map=bm.make_layered_device_map(model, "disk"), device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        dispatch_model(model, device_map={"layers.0": "device"}, device="cpu")


def test_engine_serves_a_disk_placed_model(zoo, tmp_path):
    """``from_streamed`` of a disk-placed llama gives the resident engine's tokens."""
    _, params, port_model, _ = zoo["llama"]
    cfg = port_model.config
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, (n,)).astype(np.int32) for n in (4, 19)]
    geometry = dict(num_slots=2, max_len=64, page_size=16, device="cpu")
    plain = Llama(cfg, device="meta")
    resident = dispatch_model(plain, params, _map(plain, "device"), dtype=torch.float32, device="cpu")
    want = ServingEngine.from_streamed(resident, **geometry).generate_many(prompts, max_new_tokens=5)
    served = Llama(cfg, device="meta")
    streamed = dispatch_model(served, params, _map(served, "disk"), offload_dir=str(tmp_path),
                              dtype=torch.float32, device="cpu")
    engine = ServingEngine.from_streamed(streamed, **geometry)
    assert served.device.type == "cpu"
    for got, ref in zip(engine.generate_many(prompts, max_new_tokens=5), want):
        np.testing.assert_array_equal(got, ref)
