"""The port's weight-only quantization and quantized-resident serving
(accelerate_tpu_torch/utils/quantization.py, ops/quant_matmul.py,
big_modeling.py, ServingEngine.from_streamed) against the JAX package's, on
the CPU.

The JAX side's fused dequant-matmul runs as its own tests run it: the
Pallas kernel in interpret mode. On CPU tensors the port's
``quant_matmul`` is its plain version (dequantize, then matmul); the CUDA
kernel is held against that plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Tolerances against the JAX kernel: rtol 1e-5, atol 1e-5 in fp32 (fp32 sums
in another order); rtol 1e-2, atol 1e-2 in bf16 (both round the output to
bf16 once, so they may differ by one unit in the last place)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from accelerate_tpu.big_modeling import dispatch_model as jax_dispatch_model
from accelerate_tpu.big_modeling import make_layered_device_map as jax_layered_map
from accelerate_tpu.models import Llama as JaxLlama
from accelerate_tpu.ops.quant_matmul import quant_matmul as jax_quant_matmul
from accelerate_tpu.serving import ServingEngine as JaxServingEngine
from accelerate_tpu.utils import quantization as jax_quant
from accelerate_tpu_torch import Llama, ServingEngine, load_jax_params
from accelerate_tpu_torch.big_modeling import dispatch_model, make_layered_device_map
from accelerate_tpu_torch.ops.quant_matmul import (
    BLOCK_K,
    BLOCK_N,
    SMS,
    quant_dot,
    quant_matmul,
    quant_matmul_reference,
    quant_plan,
)
from accelerate_tpu_torch.utils.quantization import (
    QuantizationConfig,
    QuantizedWeight,
    quantize_weight,
    unpack_int4,
)

TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread: the suite runs several workers on the host's
    cores, and torch's spinning threads slow each other down many times."""
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_is_bit_equal_to_jax(bits):
    """The host quantizer is a copy: same int8 bytes, same fp32 scales, for
    a plain matrix and a stacked one."""
    rng = np.random.default_rng(bits)
    for shape in ((64, 48), (4, 16, 6)):
        w = rng.normal(size=shape).astype(np.float32)
        q, scale = quantize_weight(w, bits=bits)
        jq, jscale = jax_quant.quantize_weight(w, bits=bits)
        assert q.dtype == jq.dtype == np.int8
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(scale, jscale)
    if bits == 4:
        with pytest.raises(ValueError, match="even leading dim"):
            quantize_weight(np.ones((3, 4), np.float32), bits=4)


def test_unpack_int4_all_nibble_values():
    """Every byte value, so every one of the 16 nibble values in both the
    low and the high position, unpacks as the JAX package's does."""
    packed = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    got = unpack_int4(torch.from_numpy(packed)).numpy()
    want = np.asarray(jax_quant.unpack_int4(jnp.asarray(packed)))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (32, 16)
    assert sorted(set(got[0::2].ravel())) == sorted(set(got[1::2].ravel())) == list(range(-8, 8))


def _quantized(rng, shape, bits, dtype=torch.float32):
    """The same packed weight for both packages."""
    w = rng.normal(size=shape).astype(np.float32)
    q, scale = quantize_weight(w, bits=bits)
    port = QuantizedWeight(torch.from_numpy(q), torch.from_numpy(scale), bits, dtype)
    jax_dtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return port, jax_quant.QuantizedWeight(jnp.asarray(q), jnp.asarray(scale), bits, jax_dtype)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weight_geometry_matches_jax(bits):
    """shape (logical: axis -2 doubles for int4), ndim and nbytes, per layer
    and stacked; a stacked weight's [i] is layer i, and dequantize agrees."""
    rng = np.random.default_rng(3)
    layers = [_quantized(rng, (16, 6), bits) for _ in range(3)]
    stacked = QuantizedWeight(
        torch.stack([p.q for p, _ in layers]), torch.stack([p.scale for p, _ in layers]), bits,
        torch.float32,
    )
    jax_stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *[j for _, j in layers])
    for port, jw in [layers[0], (stacked, jax_stacked)]:
        assert port.shape == jw.shape and port.ndim == jw.ndim and port.nbytes == jw.nbytes
    assert stacked.shape == (3, 16, 6)
    np.testing.assert_array_equal(
        stacked.dequantize().float().numpy(), np.asarray(jax_stacked.dequantize(), np.float32)
    )
    for i, (port, _) in enumerate(layers):
        assert torch.equal(stacked[i].q, port.q) and torch.equal(stacked[i].scale, port.scale)
    with pytest.raises(IndexError):
        layers[0][0][0]


QUANT_CASES = {
    # name: (x shape, K, N): a batched activation, K over several of the
    # JAX kernel's 512-deep blocks, and an N that is no multiple of 128
    "batched": ((2, 5), 64, 48),
    "blocked_k": ((3,), 2048, 16),
    "n_not_128": ((4,), 256, 200),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", sorted(QUANT_CASES))
def test_quant_plain_matches_jax_kernel(case, bits, dtype):
    """The port's plain version against the Pallas ``quant_matmul``
    (interpret mode) on the same packed weight; on CPU tensors the wrapper
    is that plain version and launches nothing."""
    lead, k, n = QUANT_CASES[case]
    rng = np.random.default_rng(k + n + bits)
    port_w, jax_w = _quantized(rng, (k, n), bits, dtype)
    x = (rng.normal(size=lead + (k,)) / np.sqrt(k)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    before = quant_matmul.launches
    got = quant_matmul(xt, port_w)
    assert quant_matmul.launches == before and got.dtype == dtype
    assert tuple(got.shape) == lead + (n,)
    torch.testing.assert_close(got, quant_matmul_reference(xt, port_w), rtol=0, atol=0)
    torch.testing.assert_close(quant_dot(xt, port_w), got, rtol=0, atol=0)
    want = np.asarray(jax_quant_matmul(jnp.asarray(xt.float().numpy()).astype(jax_w.dtype), jax_w), np.float32)
    tol = TOLERANCE[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_quant_wrapper_rejects_a_mismatched_contraction():
    rng = np.random.default_rng(5)
    w, _ = _quantized(rng, (32, 8), 8)
    with pytest.raises(ValueError, match="contraction"):
        quant_matmul(torch.ones((2, 16)), w)
    with pytest.raises(ValueError, match="per-layer"):
        quant_matmul(torch.ones((2, 32)), QuantizedWeight(w.q[None], w.scale[None], 8))
    plain = torch.full((8, 3), 2.0)
    torch.testing.assert_close(quant_dot(torch.ones((2, 8)), plain), torch.ones((2, 8)) @ plain)


PLAN_SHAPES = [(2048, 2048), (2048, 5504), (5504, 2048), (98, 61), (2048, 1001), (256, 64)]


def _covered(extent: int, tile: int, count: int) -> np.ndarray:
    """How many of ``count`` tiles of ``tile`` rows cover each index of
    ``range(extent)`` (tiles past the extent are cut there)."""
    hits = np.zeros(extent, np.int64)
    for i in range(count):
        hits[i * tile:min((i + 1) * tile, extent)] += 1
    return hits


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kn", PLAN_SHAPES, ids=[f"{k}x{n}" for k, n in PLAN_SHAPES])
@pytest.mark.parametrize("m", [1, 8, 40, 64, 65, 512])
def test_quant_plan_covers_every_output_and_k_row_once(m, kn, bits):
    """The bf16 kernel's plan: its row, column and K tiles cover every M,
    N and K index exactly once (no split owns no K tile), and a grid whose
    output tiles leave half the SMs idle splits K into one wave: at most a
    block per SM, at least half the SMs busy unless every K tile is a
    split of its own."""
    k, n = kn
    plan = quant_plan(m, k, n, bits)
    assert plan.m_tile % 8 == 0 and 8 <= plan.m_tile <= 64 and plan.m_tile >= min(m, 64)
    assert (_covered(m, plan.m_tile, plan.m_tiles) == 1).all()
    assert (_covered(n, BLOCK_N, plan.n_tiles) == 1).all()
    assert plan.k_tiles == -(-k // BLOCK_K)
    assert (_covered(k, plan.tiles_per_split * BLOCK_K, plan.splits) == 1).all()
    assert (plan.splits - 1) * plan.tiles_per_split < plan.k_tiles  # the last split has a tile
    tiles = plan.m_tiles * plan.n_tiles
    if 2 * tiles > SMS or plan.k_tiles == 1:
        assert plan.splits == 1
    else:
        assert plan.splits > 1 and plan.blocks <= SMS
        assert 2 * plan.blocks > SMS or plan.splits == plan.k_tiles


def test_quant_plan_of_the_decode_step():
    """llama-1b's decode projections at 8 slots: N = 2048 gives 16 column
    tiles, so K splits 8 ways (128 blocks); N = 5504 gives 43, K splits 3
    ways (129 blocks); K = 5504 has 43 K tiles in 8 splits of up to 6. A
    512-row prefill has 128 or more output tiles and does not split."""
    assert quant_plan(8, 2048, 2048, 8)[2:] == (16, 16, 8, 2)
    assert quant_plan(8, 2048, 5504, 8)[2:] == (43, 16, 3, 6)
    assert quant_plan(8, 5504, 2048, 4)[2:] == (16, 43, 8, 6)
    assert quant_plan(512, 2048, 5504, 8).splits == 1
    assert quant_plan(512, 2048, 2048, 8).splits == 1
    with pytest.raises(ValueError):
        quant_plan(8, 2048, 2048, 2)


# -- quantized-resident serving ---------------------------------------------------


def _layer_bytes(model):
    return sum(getattr(model.layers, name).nbytes if isinstance(getattr(model.layers, name), QuantizedWeight)
               else getattr(model.layers, name).numel() * getattr(model.layers, name).element_size()
               for name in ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down"))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_resident_serving_matches_jax(bits):
    """llama-tiny through ``dispatch_model(..., quantization=...)`` with
    layers in host memory, then ``ServingEngine.from_streamed``: matrices
    stay packed, ``quant_dot`` is installed, the tokens equal the JAX
    engine's ``from_streamed(use_kernels=True)``, and the resident layer
    bytes are under half of the unquantized fp32 ones."""
    config = QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4)
    jax_model = JaxLlama("llama-tiny")  # fresh: from_streamed installs its hook on the model
    params = jax_model.init(jax.random.key(0))
    host = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, jax_model.config.vocab_size, (n,)).astype(np.int32) for n in (5, 19)]
    geometry = dict(num_slots=2, max_len=64, page_size=16)

    jax_streamed = jax_dispatch_model(
        jax_model, jax.tree.map(jnp.array, params), jax_layered_map(jax_model, "cpu"),
        dtype=jnp.float32, quantization=jax_quant.QuantizationConfig(
            load_in_8bit=bits == 8, load_in_4bit=bits == 4),
    )
    want = JaxServingEngine.from_streamed(jax_streamed, use_kernels=True, **geometry).generate_many(
        prompts, max_new_tokens=6
    )

    model = load_jax_params(Llama("llama-tiny", device="cpu"), host)
    streamed = dispatch_model(
        model, host, make_layered_device_map(model, "cpu"), dtype=torch.float32,
        quantization=config, device="cpu",
    )
    engine = ServingEngine.from_streamed(streamed, device="cpu", **geometry)
    assert model.dot_fn is quant_dot and isinstance(model.layers.wq, QuantizedWeight)
    assert model.layers.wq.bits == bits and model.layers.attn_norm.dtype == torch.float32
    got = engine.generate_many(prompts, max_new_tokens=6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    plain = load_jax_params(Llama("llama-tiny", device="cpu"), host)
    unquantized = dispatch_model(plain, None, make_layered_device_map(plain, "device"),
                                 dtype=torch.float32, device="cpu")
    ServingEngine.from_streamed(unquantized, device="cpu", **geometry)
    assert plain.dot_fn is None and not isinstance(plain.layers.wq, QuantizedWeight)
    assert _layer_bytes(model) * 2 < _layer_bytes(plain)


def test_unquantized_streamer_serves_as_before():
    """An unquantized streamer dequantizes nothing, installs no hook and
    serves the model's own tokens."""
    model = Llama("llama-tiny", device="cpu", seed=3)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 1024, (n,)).astype(np.int32) for n in (4, 21)]
    geometry = dict(num_slots=2, max_len=64, page_size=16, device="cpu")
    want = ServingEngine(model, **geometry).generate_many(prompts, max_new_tokens=5)
    streamed = dispatch_model(model, None, make_layered_device_map(model, "cpu"),
                              dtype=torch.float32, device="cpu")
    engine = ServingEngine.from_streamed(streamed, **geometry)
    assert model.dot_fn is None
    for g, w in zip(engine.generate_many(prompts, max_new_tokens=5), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_from_streamed_holds_each_layer_once(bits):
    """Device-placed layers are rebound to rows of the stacked buffer the
    model serves: the streamer and the model share one copy of every
    layer, and each row still holds what was packed."""
    model = Llama("llama-tiny", device="cpu", seed=2)
    quantization = None if bits is None else QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4)
    streamed = dispatch_model(model, None, make_layered_device_map(model, "device"),
                              dtype=torch.float32, quantization=quantization, device="cpu")
    packed = [tuple(t.clone() for t in buf) if bits else buf.clone() for buf in streamed.layer_buffers]
    ServingEngine.from_streamed(streamed, num_slots=2, max_len=32, page_size=16, device="cpu")
    wq = model.layers.wq
    served = (wq.q if bits else wq).untyped_storage().data_ptr()
    for buf, want in zip(streamed.layer_buffers, packed):
        rows = buf if bits else (buf,)
        assert rows[0].untyped_storage().data_ptr() == served
        for got, ref in zip(rows, want if bits else (want,)):
            assert torch.equal(got, ref)


def test_from_streamed_refuses_a_foreign_projection_hook():
    """A model whose projections another hook owns is not served from a
    quantized streamer: dequantized weights through that hook would run
    something else in the kernel's place."""
    model = Llama("llama-tiny", device="cpu", seed=0)
    model.dot_fn = lambda a, w: a @ w
    streamed = dispatch_model(model, None, make_layered_device_map(model, "device"), dtype=torch.float32,
                              quantization=QuantizationConfig(load_in_8bit=True), device="cpu")
    with pytest.raises(ValueError, match="dot_fn"):
        ServingEngine.from_streamed(streamed, num_slots=2, max_len=32, page_size=16, device="cpu")


@pytest.mark.parametrize("what", ["auto_map", "disk", "generate", "evict", "restore", "forward"])
def test_unported_big_model_paths_raise(what, tmp_path):
    """The big-model paths around a quantized streamer (once unported, now
    the big-model slice) run: an auto map, disk placement, the streamed
    forward, ``generate``, evict and restore each give the all-device
    quantized model's outputs exactly."""
    model = Llama("llama-tiny", device="cpu", seed=0)
    int8 = QuantizationConfig(load_in_8bit=True)
    ids = np.random.default_rng(4).integers(1, 1024, (1, 6)).astype(np.int32)
    device = dispatch_model(model, device_map=make_layered_device_map(model, "device"), device="cpu",
                            dtype=torch.float32, quantization=int8)
    if what == "auto_map":
        streamed = dispatch_model(model, device="cpu", dtype=torch.float32, quantization=int8)
        assert set(streamed.hf_device_map.values()) == {"device"}
    elif what == "disk":
        streamed = dispatch_model(model, device_map=make_layered_device_map(model, "disk"), device="cpu",
                                  dtype=torch.float32, quantization=int8, offload_dir=str(tmp_path))
        assert sorted(os.listdir(tmp_path))[:2] == ["index.json", "layers.0.packed.0.dat"]
    else:
        streamed = dispatch_model(model, device_map=make_layered_device_map(model, "cpu"), device="cpu",
                                  dtype=torch.float32, quantization=int8)
    if what == "generate":
        np.testing.assert_array_equal(streamed.generate(ids, max_new_tokens=4),
                                      device.generate(ids, max_new_tokens=4))
        return
    if what == "evict":
        device.evict()
        assert not any(device.layer_on_device)
    elif what == "restore":
        device.evict().restore()
        assert all(device.layer_on_device)
    assert torch.equal(streamed(ids), device(ids))
