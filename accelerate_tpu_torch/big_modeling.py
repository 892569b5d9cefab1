"""Big-model placement for serving: device maps, packed layers, int8/int4.

Counterpart of the part of ``accelerate_tpu/big_modeling.py`` that
quantized-resident serving reaches. ``dispatch_model`` places a llama's or
a gpt2's components by an explicit device map: the non-layer weights
(embeddings, final norm, head) as tensors, each layer packed into one contiguous buffer
(:class:`LayerPacker`) or, with a :class:`QuantizationConfig`, into an int8
buffer of per-output-channel quantized matrices plus an fp32 sidecar of
scales and vectors (:class:`QuantizedLayerPacker`, quantized on the host
with numpy). ``"device"`` puts a component on the card, ``"cpu"`` keeps it in
host memory. ``ServingEngine.from_streamed`` then reassembles the model on
the device, keeping quantized matrices packed.

Not in the port yet (ROADMAP.md, open item 2): ``"disk"`` placement and
``"auto"`` maps (``infer_auto_device_map``), the streamed forward and
``generate``, ``evict``/``restore`` and ``cpu_offload_with_hook``. Each
raises ``NotImplementedError``; none runs something else in its place.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .models.bert import Bert
from .models.gpt2 import GPT2
from .models.llama import Llama
from .ops.runtime import resolve_device
from .utils.quantization import QuantizationConfig, QuantizedWeight, dequantize_weight, quantize_weight

NOT_PORTED = "not in the port yet (ROADMAP.md, open item 2: the rest of the big-model slice)"


def _iter_flat(tree, prefix: str = ""):
    """Depth-first ``(key, leaf)`` pairs with "/"-joined keys, sorted per
    level: the component and packing order of the JAX package."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _iter_flat(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, value in flat.items():
        node = out
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _host_fp32(leaf) -> np.ndarray:
    """A weight as a writable host fp32 array (tensors of any device and
    dtype; arrays are copied, as a read-only one cannot back a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.array(leaf, np.float32)


def _device_put_packed(buf, device):
    """One copy per buffer; quantized layers are (int8 data, fp32 sidecar) pairs."""
    if isinstance(buf, tuple):
        return tuple(part.to(device) for part in buf)
    return buf.to(device)


class LayerPacker:
    """Fixed layout of one layer in a single contiguous buffer of ``dtype``,
    derived from the stacked-layers tree (leaves ``[L, ...]``) in sorted key
    order, identical on pack and unpack."""

    def __init__(self, stacked_layers: Any, dtype):
        self.dtype = dtype
        self.shapes: dict[str, tuple] = {
            key: tuple(leaf.shape[1:]) for key, leaf in _iter_flat(stacked_layers)
        }
        self.offsets: dict[str, tuple[int, int]] = {}
        offset = 0
        for key, shape in self.shapes.items():
            size = int(np.prod(shape)) if shape else 1
            self.offsets[key] = (offset, size)
            offset += size
        self.total = offset

    def pack(self, layer: Mapping[str, Any]) -> torch.Tensor:
        buf = torch.empty((self.total,), dtype=self.dtype)
        flat = dict(_iter_flat(layer))
        for key, (offset, size) in self.offsets.items():
            buf[offset : offset + size] = torch.from_numpy(_host_fp32(flat[key]).ravel())
        return buf

    def unpack(self, buf: torch.Tensor) -> dict:
        """Views of one layer's weights, nested as in the JAX layer dict; a
        stacked ``[L, total]`` buffer gives ``[L, ...]`` views."""
        lead = tuple(buf.shape[:-1])
        out = {}
        for key, (offset, size) in self.offsets.items():
            out[key] = buf[..., offset : offset + size].reshape(lead + self.shapes[key])
        return _unflatten(out)


class QuantizedLayerPacker:
    """Layer packer with weight-only int8/int4 quantization: matrix leaves
    are quantized per output channel into one contiguous int8 buffer;
    vectors (norms, biases) and the per-channel scales ride in an fp32 sidecar.
    ``skip`` keeps leaves whose name holds one of its substrings in full
    precision."""

    def __init__(self, stacked_layers: Any, dtype, bits: int = 8, skip: Optional[list[str]] = None):
        self.dtype = dtype
        self.bits = bits
        skip = skip or []
        self.shapes: dict[str, tuple] = {
            key: tuple(leaf.shape[1:]) for key, leaf in _iter_flat(stacked_layers)
        }
        self.quant_keys = [
            k for k, shape in self.shapes.items() if len(shape) >= 2 and not any(s in k for s in skip)
        ]
        self.full_keys = [k for k in self.shapes if k not in self.quant_keys]

        self.q_offsets: dict[str, tuple[int, int]] = {}
        offset = 0
        for key in self.quant_keys:
            size = int(np.prod(self.shapes[key]))
            if bits == 4:
                size //= 2
            self.q_offsets[key] = (offset, size)
            offset += size
        self.q_total = offset

        self.f_offsets: dict[str, tuple[int, int]] = {}
        offset = 0
        for key in self.full_keys:
            size = int(np.prod(self.shapes[key])) if self.shapes[key] else 1
            self.f_offsets[key] = (offset, size)
            offset += size
        for key in self.quant_keys:  # per-output-channel scales
            size = self.shapes[key][-1]
            self.f_offsets[f"{key}@scale"] = (offset, size)
            offset += size
        self.f_total = offset

    def pack(self, layer: Mapping[str, Any]) -> tuple[torch.Tensor, torch.Tensor]:
        """Quantize one layer on the host: ``(int8 data, fp32 sidecar)``."""
        flat = dict(_iter_flat(layer))
        qbuf = np.empty((self.q_total,), np.int8)
        fbuf = np.empty((self.f_total,), np.float32)
        for key in self.quant_keys:
            q, scale = quantize_weight(_host_fp32(flat[key]), bits=self.bits)
            offset, size = self.q_offsets[key]
            qbuf[offset : offset + size] = q.ravel()
            f_off, f_size = self.f_offsets[f"{key}@scale"]
            fbuf[f_off : f_off + f_size] = scale
        for key in self.full_keys:
            offset, size = self.f_offsets[key]
            fbuf[offset : offset + size] = _host_fp32(flat[key]).ravel()
        return torch.from_numpy(qbuf), torch.from_numpy(fbuf)

    def unpack(self, bufs, quantized_resident: bool = False) -> dict:
        """Unpack one layer on the buffers' device, or every layer of stacked
        ``[L, total]`` buffers as ``[L, ...]`` leaves. ``quantized_resident``
        keeps 2-D matrix leaves packed as :class:`QuantizedWeight` views
        for the fused dequant-matmul; otherwise, and for every other leaf,
        dequantize to ``dtype``. One slicing of the layout serves both."""
        qbuf, fbuf = bufs
        lead = tuple(qbuf.shape[:-1])
        out = {}
        for key in self.quant_keys:
            shape = self.shapes[key]
            offset, size = self.q_offsets[key]
            stored = (shape[0] // 2,) + shape[1:] if self.bits == 4 else shape
            q = qbuf[..., offset : offset + size].reshape(lead + stored)
            f_off, f_size = self.f_offsets[f"{key}@scale"]
            scale = fbuf[..., f_off : f_off + f_size]
            if quantized_resident and len(shape) == 2:
                out[key] = QuantizedWeight(q, scale, self.bits, self.dtype)
            else:  # the scale broadcasts over every axis but the last
                scale = scale.reshape(lead + (1,) * (len(shape) - 1) + shape[-1:])
                out[key] = dequantize_weight(q, scale, self.bits, self.dtype)
        for key in self.full_keys:
            offset, size = self.f_offsets[key]
            out[key] = fbuf[..., offset : offset + size].reshape(lead + self.shapes[key]).to(self.dtype)
        return _unflatten(out)


def component_names(model: Llama | GPT2) -> list[str]:
    """The placement components: every non-layer weight by name, and
    ``layers.<i>`` for each layer (the JAX package's component keys)."""
    names = [key for key in model.param_tree() if key != "layers"]
    return sorted(names) + [f"layers.{i}" for i in range(model.config.num_layers)]


def make_layered_device_map(model: Llama | GPT2, layer_target: str) -> dict[str, str]:
    """Device map sending every ``layers.*`` component to ``layer_target``
    (``"device"`` or ``"cpu"``) and every other component to the device."""
    return {
        key: (layer_target if key.startswith("layers.") else "device")
        for key in component_names(model)
    }


def check_device_map(model: Llama | GPT2, device_map: dict[str, str]) -> None:
    """Every component covered, every target known."""
    missing = sorted(set(component_names(model)) - set(device_map))
    if missing:
        raise ValueError(f"device_map does not cover: {missing[:8]}{'...' if len(missing) > 8 else ''}")
    targets = set(device_map.values())
    if "disk" in targets:
        raise NotImplementedError(f"disk placement is {NOT_PORTED}")
    unknown = targets - {"device", "cpu"}
    if unknown:
        raise ValueError(f"Unknown device_map targets: {unknown} (use device/cpu)")


def _place_components(params, device_map, dtype, device, quantization=None):
    """Resident non-layer leaves (tensors in ``dtype``, on the device or in
    host memory) and one packed buffer per layer."""
    resident: dict[str, Any] = {}
    for key, leaf in _iter_flat({k: v for k, v in params.items() if k != "layers"}):
        host = torch.from_numpy(_host_fp32(leaf)).to(dtype)
        target = device_map.get(key.replace("/", "."), "device")
        resident[key] = host.to(device) if target == "device" else host

    if quantization is not None:
        packer: Any = QuantizedLayerPacker(
            params["layers"], dtype, bits=quantization.bits, skip=quantization.skip_modules
        )
    else:
        packer = LayerPacker(params["layers"], dtype)
    stacked = dict(_iter_flat(params["layers"]))
    num_layers = next(iter(stacked.values())).shape[0]
    layer_buffers: list[Any] = []
    layer_on_device: list[bool] = []
    for i in range(num_layers):
        packed = packer.pack({k: v[i] for k, v in stacked.items()})
        on_device = device_map.get(f"layers.{i}", "device") == "device"
        layer_buffers.append(_device_put_packed(packed, device) if on_device else packed)
        layer_on_device.append(on_device)
    return resident, packer, layer_buffers, layer_on_device


class StreamedModel:
    """A placed model: resident components (``resident``, flat "/"-keyed)
    and packed per-layer buffers, each on the device or in host memory.
    ``ServingEngine.from_streamed`` serves it (``resident_tree``,
    ``layer_buffers``, ``packer``); its streamed execution is not ported."""

    def __init__(self, model: Llama | GPT2, resident: dict, layer_buffers: list, layer_on_device: list,
                 packer, dtype, device):
        self.model = model
        self.resident = resident
        self.layer_buffers = layer_buffers
        self.layer_on_device = layer_on_device
        self.packer = packer
        self.dtype = dtype
        self.device = device

    def resident_tree(self) -> dict:
        """The nested non-layer params, every leaf on the device."""
        return _unflatten({key: value.to(self.device) for key, value in self.resident.items()})

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(f"the streamed forward is {NOT_PORTED}")

    def generate(self, *args, **kwargs):
        raise NotImplementedError(f"streamed generate is {NOT_PORTED}")

    def evict(self):
        raise NotImplementedError(f"evict/restore is {NOT_PORTED}")

    def restore(self):
        raise NotImplementedError(f"evict/restore is {NOT_PORTED}")


def dispatch_model(
    model: Llama | GPT2,
    params: Optional[dict] = None,
    device_map: dict[str, str] | str = "auto",
    dtype: torch.dtype = torch.bfloat16,
    quantization: Optional[QuantizationConfig] = None,
    device=None,
) -> StreamedModel:
    """Place ``model``'s components per ``device_map`` and return the
    :class:`StreamedModel`. ``params`` is the JAX-layout param tree (numpy
    arrays or tensors, any dtype); None takes the model's own weights.
    ``quantization`` packs the layer matrices as int8/int4 (W8A16/W4A16).
    ``device`` (None = CUDA) is where ``"device"`` components go."""
    if isinstance(model, Bert):
        raise NotImplementedError(f"dispatching bert (its streaming protocol) is {NOT_PORTED}")
    if not isinstance(model, (Llama, GPT2)):
        raise TypeError(f"{type(model).__name__} cannot be dispatched: the port places llama and gpt2 models")
    if isinstance(device_map, str):
        raise NotImplementedError(f"device_map={device_map!r} (infer_auto_device_map) is {NOT_PORTED}")
    check_device_map(model, device_map)
    device = resolve_device(device)
    if params is None:
        params = model.param_tree()
    resident, packer, layer_buffers, layer_on_device = _place_components(
        params, device_map, dtype, device, quantization=quantization
    )
    return StreamedModel(model, resident, layer_buffers, layer_on_device, packer, dtype, device)
