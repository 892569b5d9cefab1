"""Big-model inference: shapes without weights, device maps, streamed execution.

Counterpart of ``accelerate_tpu/big_modeling.py``. ``dispatch_model``
places a model's components by a device map (explicit, or ``"auto"`` from
the memory budget, ``utils/modeling.infer_auto_device_map``): the non-layer
weights as tensors, each layer packed into one contiguous buffer
(:class:`LayerPacker`) or, with a :class:`QuantizationConfig`, into an int8
buffer of per-output-channel quantized matrices plus an fp32 sidecar
(:class:`QuantizedLayerPacker`, quantized on the host). ``"device"`` puts a
component on the card, ``"cpu"`` in page-locked host memory (pinned once,
here), ``"disk"`` in a memmap under ``offload_dir`` (``utils/offload.py``).
The returned :class:`StreamedModel` runs any model with the stream protocol
(``stream_prefix``/``stream_layer``/``stream_suffix``; llama, gpt2, bert,
t5), ``generate`` with the decode protocol, and serves through
``ServingEngine.from_streamed``.

Streaming. Layers run in groups whose size comes from
``stream_window_bytes`` (two groups must fit the window). The layers of a
group that are not on the card are copied into one of two device buffers
owned for the run, on a copy stream of its own: group i+1's copy is issued
before group i's compute, the compute stream waits on the copy's event, and
a buffer is filled again only after an event says the compute that read it
is done. A page-locked layer copies straight to the card (non-blocking); a
memmap (a disk layer, which cannot be pinned) or other pageable buffer goes
through one of two pinned bounce buffers, reused only once the copy that
read it is done. Streamed and resident layers unpack from the same packed
layout, streamed ones by views of their byte slice of the group buffer
(``packer.from_bytes``). The device holds the resident components, the
device-placed layers and at most the two group buffers. On the CPU
(``device="cpu"``) the same buffers are filled by plain copies.

The streamed layers attend and dequantize in plain PyTorch (the JAX
package's streamed layers run no kernel either); ``from_streamed`` serves
through the paged decode kernel and, quantized, the dequant-matmul.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .models.generation import make_sampler
from .ops.runtime import resolve_device
from .utils.modeling import (
    _iter_flat,
    _unflatten,
    abstract_params,
    check_device_map,
    infer_auto_device_map,
    named_component_sizes,
)
from .utils.offload import load_offloaded_weight, offload_weight, save_offload_index
from .utils.quantization import QuantizationConfig, QuantizedWeight, dequantize_weight, quantize_weight

# default device budget of the two streamed layer groups
DEFAULT_STREAM_WINDOW_BYTES = 512 << 20
# a streamed layer's slot in a group buffer starts at a multiple of this
SLOT_ALIGN = 256


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


def init_empty_weights(model) -> dict:
    """The model's param tree (JAX key paths) as ``meta`` tensors of its
    shapes and dtypes: zero bytes on the card and on the host. Build the
    model itself on ``device="meta"`` to hold no weight at all."""
    return abstract_params(model)


init_on_device = init_empty_weights


def _host_fp32(leaf) -> np.ndarray:
    """A weight as a writable host fp32 array (tensors of any device and
    dtype; arrays are copied, as a read-only one cannot back a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.array(leaf, np.float32)


def _host_tensor(leaf) -> torch.Tensor:
    """A weight as a CPU tensor, sharing a writable numpy array's memory
    (copied otherwise: a read-only array cannot back a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    array = np.asarray(leaf)
    return torch.from_numpy(array if array.flags.writeable else array.copy())


def _parts(buf) -> tuple:
    """A packed layer's tensors: one, or a quantized (int8, fp32) pair."""
    return buf if isinstance(buf, tuple) else (buf,)


def _map_packed(buf, fn):
    out = tuple(fn(part) for part in _parts(buf))
    return out if isinstance(buf, tuple) else out[0]


def _device_put_packed(buf, device):
    """One copy per buffer; quantized layers are (int8 data, fp32 sidecar) pairs."""
    return _map_packed(buf, lambda part: part.to(device))


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

    @property
    def layer_nbytes(self) -> int:
        """Packed bytes of one layer."""
        return self.total * self.dtype.itemsize

    def pack(self, layer: Mapping[str, Any]) -> torch.Tensor:
        buf = torch.empty((self.total,), dtype=self.dtype)
        flat = dict(_iter_flat(layer))
        for key, (offset, size) in self.offsets.items():
            buf[offset : offset + size] = _host_tensor(flat[key]).reshape(-1)
        return buf

    def byte_parts(self, buf) -> list[tuple[int, torch.Tensor]]:
        """``(offset, bytes)`` of a packed layer in its streamed slot."""
        return [(0, buf.view(torch.uint8))]

    def from_bytes(self, u8: torch.Tensor) -> dict:
        """One layer's views of its byte slice of a group buffer."""
        return self.unpack(u8[: self.layer_nbytes].view(self.dtype))

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
        # in a streamed slot the fp32 sidecar follows the int8 data, aligned
        self.f_start = _round_up(self.q_total, 16)

    @property
    def layer_nbytes(self) -> int:
        """Bytes of one layer in its streamed slot: int8 data, then the fp32 sidecar."""
        return self.f_start + 4 * self.f_total

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

    def byte_parts(self, buf) -> list[tuple[int, torch.Tensor]]:
        q, f = buf
        return [(0, q.view(torch.uint8)), (self.f_start, f.view(torch.uint8))]

    def from_bytes(self, u8: torch.Tensor) -> dict:
        """One layer from its byte slice of a group buffer: the int8 data
        and the fp32 sidecar, split and viewed (dequantized as ``unpack``)."""
        q = u8[: self.q_total].view(torch.int8)
        f = u8[self.f_start : self.f_start + 4 * self.f_total].view(torch.float32)
        return self.unpack((q, f))

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


class _GroupStager:
    """The double buffer of one run (a forward, or a whole ``generate``):
    two device group buffers, and on the card a copy stream, the events that
    order the copies against the compute, and two pinned bounce buffers for
    pageable layers. Iterating yields ``(indices, layer param dicts)`` per
    group; the next group's copy is issued before the current one is
    yielded, and the buffer is released when the consumer comes back."""

    def __init__(self, streamed: "StreamedModel"):
        self.streamed = streamed
        self.groups = streamed._group_indices()
        self.slot_bytes = streamed._layer_bytes()
        device = streamed.device
        self.cuda = device.type == "cuda"
        on = streamed.layer_on_device
        width = max((sum(not on[i] for i in g) for g in self.groups), default=0) * self.slot_bytes
        self.bufs = [torch.empty(width, dtype=torch.uint8, device=device) for _ in range(2)] if width else []
        self.ready: list = [None, None]  # copy-stream events: the buffer is filled
        self.free: list = [None, None]  # compute-stream events: the buffer's reads are done
        self.bounce: list = []
        self.bounce_free: list = [None, None]
        if self.cuda and width:
            self.copy_stream = torch.cuda.Stream(device)
            for buf in self.bufs:  # the copy stream writes them: its work holds their blocks too
                buf.record_stream(self.copy_stream)
            pageable = max((sum(self.slot_bytes for i in g if not on[i] and not self._pinned(i))
                            for g in self.groups), default=0)
            if pageable:
                self.bounce = [torch.empty(pageable, dtype=torch.uint8, pin_memory=True) for _ in range(2)]

    def _pinned(self, i: int) -> bool:
        return all(part.is_pinned() for part in _parts(self.streamed.layer_buffers[i]))

    def _stage(self, gi: int) -> None:
        """Issue the copies of group ``gi``'s streamed layers into buffer ``gi % 2``."""
        streamed, slot = self.streamed, gi % 2
        streamed_layers = [i for i in self.groups[gi] if not streamed.layer_on_device[i]]
        if not streamed_layers:
            return
        buf, packer = self.bufs[slot], streamed.packer
        copies = []  # (destination, source) byte ranges
        for n, i in enumerate(streamed_layers):
            for offset, part in packer.byte_parts(streamed.layer_buffers[i]):
                start = n * self.slot_bytes + offset
                copies.append((buf[start : start + part.numel()], part))
                streamed.streamed_bytes += part.numel()
        if not self.cuda:
            for dst, src in copies:
                dst.copy_(src)
            return
        with torch.cuda.stream(self.copy_stream):
            if self.free[slot] is not None:
                self.copy_stream.wait_event(self.free[slot])
            bounced, at = [], 0
            for dst, src in copies:
                if src.is_pinned():
                    dst.copy_(src, non_blocking=True)
                else:
                    bounced.append((dst, at, src))
                    at += src.numel()
            if bounced:
                bounce = self.bounce[slot]
                if self.bounce_free[slot] is not None:
                    self.bounce_free[slot].synchronize()  # its last copy to the card is done
                for dst, at, src in bounced:
                    bounce[at : at + src.numel()].copy_(src)
                for dst, at, src in bounced:
                    dst.copy_(bounce[at : at + src.numel()], non_blocking=True)
                self.bounce_free[slot] = torch.cuda.Event()
                self.bounce_free[slot].record(self.copy_stream)
            self.ready[slot] = torch.cuda.Event()
            self.ready[slot].record(self.copy_stream)

    def _layers(self, gi: int) -> list[dict]:
        """Group ``gi``'s layer param dicts, the compute stream made to wait
        on its copy."""
        streamed, slot = self.streamed, gi % 2
        if self.cuda and self.ready[slot] is not None:
            torch.cuda.current_stream(streamed.device).wait_event(self.ready[slot])
            self.ready[slot] = None
        out, n = [], 0
        for i in self.groups[gi]:
            if streamed.layer_on_device[i]:
                out.append(streamed.packer.unpack(streamed.layer_buffers[i]))
            else:
                start = n * self.slot_bytes
                out.append(streamed.packer.from_bytes(self.bufs[slot][start : start + self.slot_bytes]))
                n += 1
        return out

    def _release(self, gi: int) -> None:
        if self.cuda and self.bufs:
            self.free[gi % 2] = torch.cuda.Event()
            self.free[gi % 2].record(torch.cuda.current_stream(self.streamed.device))

    def __iter__(self):
        if not self.groups:
            return
        self._stage(0)
        for gi, idx in enumerate(self.groups):
            if gi + 1 < len(self.groups):
                self._stage(gi + 1)
            yield idx, self._layers(gi)
            self._release(gi)


def _to_device(value, device):
    """A user input (array or tensor) on the run's device; others as they are."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=device)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return value


class StreamedModel:
    """A placed model: resident components (``resident``, flat "/"-keyed)
    and packed per-layer buffers, each on the device, in pinned host memory
    or on disk. Calling it runs the model's stream protocol with the
    streaming described in the module docstring; ``generate`` runs its
    decode protocol; ``ServingEngine.from_streamed`` serves it
    (``resident_tree``, ``layer_buffers``, ``layer_on_device``, ``packer``,
    ``device``). ``streamed_bytes`` counts the bytes the last run copied to
    the device."""

    def __init__(self, model, resident: dict, layer_buffers: list, layer_on_device: list, packer, dtype,
                 device, stream_window_bytes: int = DEFAULT_STREAM_WINDOW_BYTES,
                 host_shadow: Optional[dict] = None):
        self.model = model
        self.config = getattr(model, "config", None)
        self.resident = resident
        self.layer_buffers = layer_buffers
        self.layer_on_device = layer_on_device
        self.packer = packer
        self.dtype = dtype
        self.device = device
        self.hf_device_map: dict[str, str] = {}
        # two groups (the double buffer) fit the window; a window under one
        # layer still streams, a layer at a time
        self.stream_window_bytes = stream_window_bytes
        per_group = max(1, (stream_window_bytes // 2) // max(self._layer_bytes(), 1))
        self.group_size = int(min(per_group, max(len(layer_buffers), 1)))
        # host copies of the device-placed buffers: evict() frees the card
        # with no device-to-host copy
        self._host_shadow = host_shadow or {"resident": {}, "layers": {}}
        self._evicted = False
        # another model's offload hook, run before this one executes
        self._prev_hook: Optional["UserOffloadHook"] = None
        self.streamed_bytes = 0

    def _layer_bytes(self) -> int:
        """Bytes of one layer's slot in a group buffer."""
        return _round_up(self.packer.layer_nbytes, SLOT_ALIGN)

    def _group_indices(self) -> list[list[int]]:
        L, g = len(self.layer_buffers), self.group_size
        return [list(range(i, min(i + g, L))) for i in range(0, L, g)]

    # -- evict / restore (one card's memory shared by several models) ---------

    def evict(self) -> "StreamedModel":
        """Point every device-placed buffer back at its host copy, freeing
        the card's memory this model holds (nothing is copied back). The
        next :meth:`restore`, or any execution, uploads the same set again."""
        if self._evicted:
            return self
        for key, host in self._host_shadow["resident"].items():
            self.resident[key] = host
        for i, packed in self._host_shadow["layers"].items():
            self.layer_buffers[i] = packed
            self.layer_on_device[i] = False
        self._evicted = True
        return self

    def restore(self) -> "StreamedModel":
        """Upload the device-placed buffers again after an evict."""
        if not self._evicted:
            return self
        for key in self._host_shadow["resident"]:
            self.resident[key] = self.resident[key].to(self.device)
        for i in self._host_shadow["layers"]:
            self.layer_buffers[i] = _device_put_packed(self.layer_buffers[i], self.device)
            self.layer_on_device[i] = True
        self._evicted = False
        return self

    def _before_execute(self) -> None:
        """Evict the previous model of a hook chain, then make this one resident."""
        if self._prev_hook is not None:
            self._prev_hook.offload()
        if self._evicted:
            self.restore()

    def resident_tree(self) -> dict:
        """The nested non-layer params, every leaf on the device (host and
        disk components are copied there; pinned ones without blocking)."""
        out = {}
        for key, value in self.resident.items():
            if value.device != self.device:
                pinned = self.device.type == "cuda" and value.is_pinned()
                self.streamed_bytes += value.numel() * value.element_size()
                value = value.to(self.device, non_blocking=pinned)
            out[key] = value
        return _unflatten(out)

    @torch.no_grad()
    def __call__(self, *args, **kwargs):
        self._before_execute()
        self.streamed_bytes = 0
        args = [_to_device(a, self.device) for a in args]
        kwargs = {k: _to_device(v, self.device) for k, v in kwargs.items()}
        resident = self.resident_tree()
        carry = self.model.stream_prefix(resident, *args, **kwargs)
        for _, layers in _GroupStager(self):
            for lp in layers:
                carry = self.model.stream_layer(carry, lp)
        return self.model.stream_suffix(resident, carry)

    # -- streamed KV-cache decode -------------------------------------------

    def _decode(self, resident, current, caches, length, max_len, stager, **prefix_kwargs):
        """One decode step over every layer group: last-position logits."""
        carry = self.model.decode_prefix(resident, current, length, max_len, **prefix_kwargs)
        for idx, layers in stager:
            for i, lp in zip(idx, layers):
                carry, _ = self.model.stream_layer_cached(carry, lp, caches[i], length)
        return self.model.decode_suffix(resident, carry)

    def _prepare_decode(self, temperature: float, rng):
        if not hasattr(self.model, "stream_layer_cached"):
            raise TypeError(
                f"{type(self.model).__name__} has no streamed-decode protocol "
                "(init_layer_cache/decode_prefix/stream_layer_cached/decode_suffix)"
            )
        self._before_execute()
        self.streamed_bytes = 0
        if rng is None and temperature > 0.0:
            rng = torch.Generator(device=self.device).manual_seed(0)
        return make_sampler(temperature), rng

    def _caches(self, batch: int, max_len: int) -> list[dict]:
        return [self.model.init_layer_cache(batch, max_len, self.dtype, device=self.device)
                for _ in range(len(self.layer_buffers))]

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None, return_device: bool = False):
        """Streamed KV-cache decode: every step streams the layers again.
        Greedy at temperature 0, else categorical from ``rng`` (seed 0 on
        the device when None). The tokens stay on the device until one copy
        at the end; ``return_device`` returns the device tensor instead.
        Returns ``[B, S + max_new_tokens]`` int32 ids."""
        sample, rng = self._prepare_decode(temperature, rng)
        ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=self.device)
        b, s = ids.shape
        max_len = s + max_new_tokens
        caches = self._caches(b, max_len)
        resident = self.resident_tree()
        stager = _GroupStager(self)
        tokens, current, length = [ids], ids, 0
        for _ in range(max_new_tokens):
            logits = self._decode(resident, current, caches, length, max_len, stager)
            length += current.shape[1]
            current = sample(logits, rng)[:, None]
            tokens.append(current)
        out = torch.cat(tokens, dim=1)
        return out if return_device else out.cpu().numpy()


class Seq2SeqStreamedModel(StreamedModel):
    """The executor of an encoder-decoder model (T5). The forward is
    :class:`StreamedModel`'s (the model's ``stream_prefix`` runs the
    encoder). ``generate`` runs the resident encoder once over
    ``input_ids`` (no hooks), then streams the decoder stack each step from
    ``config.decoder_start_token_id``, the encoder output feeding every
    layer's cross-attention."""

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 20, temperature: float = 0.0,
                 rng: Optional[torch.Generator] = None, return_device: bool = False, attention_mask=None):
        """Returns the decoder sequence ``[B, 1 + max_new_tokens]``, start
        token included."""
        sample, rng = self._prepare_decode(temperature, rng)
        ids = torch.as_tensor(np.asarray(input_ids, np.int32), device=self.device)
        b = ids.shape[0]
        max_len = 1 + max_new_tokens
        caches = self._caches(b, max_len)
        resident = self.resident_tree()
        if attention_mask is not None:
            attention_mask = torch.as_tensor(np.asarray(attention_mask, np.int32), device=self.device)
            enc_mask = attention_mask[:, None, None, :].bool()
        else:
            enc_mask = torch.ones((b, 1, 1, ids.shape[1]), dtype=torch.bool, device=self.device)
        enc_out = self.model.encode(resident, ids, attention_mask, use_hooks=False)
        stager = _GroupStager(self)
        current = torch.full((b, 1), self.config.decoder_start_token_id, dtype=torch.int32, device=self.device)
        tokens, length = [current], 0
        for _ in range(max_new_tokens):
            logits = self._decode(resident, current, caches, length, max_len, stager,
                                  enc_out=enc_out, enc_mask=enc_mask)
            length += 1
            current = sample(logits, rng)[:, None]
            tokens.append(current)
        out = torch.cat(tokens, dim=1)
        return out if return_device else out.cpu().numpy()


def _pin(tensor: torch.Tensor, device) -> torch.Tensor:
    """Page-locked on the card's host (a copy, once); as it is on the CPU."""
    return tensor.pin_memory() if device.type == "cuda" else tensor


def _place_components(params, device_map, offload_dir, dtype, device, quantization=None):
    """Resident non-layer leaves (tensors in ``dtype``) and one packed buffer
    per layer, each at its target, and the host shadow of every
    device-placed buffer (for evict). Disk components go to memmaps under
    ``offload_dir`` with one ``index.json``."""
    disk_index: dict = {}

    def to_disk(tensor: torch.Tensor, name: str) -> torch.Tensor:
        if offload_dir is None:
            raise ValueError(f"device_map places {name} on disk — pass offload_dir")
        os.makedirs(offload_dir, exist_ok=True)
        offload_weight(tensor, name, offload_dir, disk_index)
        return load_offloaded_weight(os.path.join(offload_dir, f"{name}.dat"), disk_index[name])

    resident: dict[str, Any] = {}
    host_shadow: dict[str, Any] = {"resident": {}, "layers": {}}
    for key, leaf in _iter_flat({k: v for k, v in params.items() if k != "layers"}):
        host = _host_tensor(leaf).to(dtype, copy=True)
        name = key.replace("/", ".")
        target = device_map.get(name, "device")
        if target == "device":
            resident[key] = host.to(device)
            host_shadow["resident"][key] = host
        elif target == "cpu":
            resident[key] = _pin(host, device)
        elif target == "disk":
            resident[key] = to_disk(host, name)
        else:
            raise ValueError(f"Unknown target {target!r} for {key}")

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
        target = device_map.get(f"layers.{i}", "device")
        if target == "device":
            layer_buffers.append(_device_put_packed(packed, device))
            host_shadow["layers"][i] = packed
        elif target == "cpu":
            layer_buffers.append(_map_packed(packed, lambda part: _pin(part, device)))
        elif target == "disk":
            parts = _parts(packed)
            names = [f"layers.{i}.packed" + (f".{j}" if len(parts) > 1 else "") for j in range(len(parts))]
            on_disk = tuple(to_disk(part, name) for part, name in zip(parts, names))
            layer_buffers.append(on_disk if isinstance(packed, tuple) else on_disk[0])
        else:
            raise ValueError(f"Unknown target {target!r} for layers.{i}")
        layer_on_device.append(target == "device")
    if disk_index:
        save_offload_index(disk_index, offload_dir)
    return resident, packer, layer_buffers, layer_on_device, host_shadow


def dispatch_model(
    model,
    params: Optional[dict] = None,
    device_map: dict[str, str] | str = "auto",
    max_memory: Optional[dict] = None,
    offload_dir: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    quantization: Optional[QuantizationConfig] = None,
    stream_window_bytes: int = DEFAULT_STREAM_WINDOW_BYTES,
    device=None,
) -> StreamedModel:
    """Place ``model``'s components per ``device_map`` and return the
    streaming executor (:class:`Seq2SeqStreamedModel` for an
    encoder-decoder). ``params`` is the JAX-layout param tree (numpy arrays
    or tensors, any dtype); None takes the model's own weights.
    ``device_map="auto"`` fills the device, then host memory, then disk
    within ``max_memory`` (``utils/modeling.get_max_memory``), sizing
    quantized layers at their quantized bytes. ``quantization`` packs the
    layer matrices as int8/int4 (W8A16/W4A16). ``device`` (None = CUDA) is
    where ``"device"`` components go and the model runs."""
    if not hasattr(model, "stream_layer"):
        raise TypeError(
            f"{type(model).__name__} cannot be dispatched: implement the stream "
            "protocol (stream_prefix/stream_layer/stream_suffix)"
        )
    device = resolve_device(device)
    if isinstance(device_map, str):
        if device_map != "auto":
            raise ValueError(f"device_map must be a dict or 'auto', got {device_map!r}")
        layer_dtype_bytes = quantization.bits / 8 if quantization is not None else None
        device_map = infer_auto_device_map(model, max_memory=max_memory, dtype_bytes=dtype.itemsize,
                                           layer_dtype_bytes=layer_dtype_bytes, device=device)
    check_device_map(model, device_map)
    if params is None:
        params = model.param_tree()
    resident, packer, layer_buffers, layer_on_device, host_shadow = _place_components(
        params, device_map, offload_dir, dtype, device, quantization=quantization
    )
    cls = Seq2SeqStreamedModel if getattr(model, "is_encoder_decoder", False) else StreamedModel
    dispatched = cls(model, resident, layer_buffers, layer_on_device, packer, dtype, device,
                     stream_window_bytes=stream_window_bytes, host_shadow=host_shadow)
    dispatched.hf_device_map = dict(device_map)
    return dispatched


def make_layered_device_map(model, layer_target: str) -> dict[str, str]:
    """Device map sending every ``layers.*`` component to ``layer_target``
    (device, cpu or disk) and every other component to the device."""
    return {key: (layer_target if key.startswith("layers.") else "device")
            for key in named_component_sizes(model)}


def cpu_offload(model, params: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16,
                device=None) -> StreamedModel:
    """Every layer streamed from pinned host memory on every run."""
    return dispatch_model(model, params, make_layered_device_map(model, "cpu"), dtype=dtype, device=device)


def disk_offload(model, params: Optional[dict] = None, offload_dir: Optional[str] = None,
                 dtype: torch.dtype = torch.bfloat16, device=None) -> StreamedModel:
    """Every layer streamed from memmaps under ``offload_dir``."""
    return dispatch_model(model, params, make_layered_device_map(model, "disk"), offload_dir=offload_dir,
                          dtype=dtype, device=device)


class UserOffloadHook:
    """The user's handle to evict a dispatched model: ``offload()`` frees
    its device memory; the model restores itself on its next execution."""

    def __init__(self, streamed: StreamedModel):
        self.model = streamed

    def offload(self) -> None:
        self.model.evict()

    def remove(self) -> None:
        """Detach the chained previous model's hook."""
        self.model._prev_hook = None


def cpu_offload_with_hook(model, params: Optional[dict] = None, dtype: torch.dtype = torch.bfloat16,
                          prev_module_hook: Optional[UserOffloadHook] = None,
                          device=None) -> tuple[StreamedModel, UserOffloadHook]:
    """Several models taking turns on one card. The model is placed in
    pinned host memory and starts evicted, with every component's restore
    target the device: its first execution uploads it all, and it stays
    resident until its hook's ``offload()``. Chained through
    ``prev_module_hook``, running a model first evicts the previous one, so
    only the running model is resident::

        lm1, hook1 = cpu_offload_with_hook(model1, params1)
        lm2, hook2 = cpu_offload_with_hook(model2, params2, prev_module_hook=hook1)
        lm1(x); lm2(y)   # model1 is evicted before model2 uploads
        hook2.offload()
    """
    all_cpu = {key: "cpu" for key in named_component_sizes(model)}
    dispatched = dispatch_model(model, params, all_cpu, dtype=dtype, device=device)
    dispatched._host_shadow = {
        "resident": dict(dispatched.resident),
        "layers": dict(enumerate(dispatched.layer_buffers)),
    }
    dispatched._evicted = True
    dispatched._prev_hook = prev_module_hook
    return dispatched, UserOffloadHook(dispatched)


def load_checkpoint_and_dispatch(
    model,
    checkpoint: str,
    device_map: dict[str, str] | str = "auto",
    max_memory: Optional[dict] = None,
    offload_dir: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    stream_window_bytes: int = DEFAULT_STREAM_WINDOW_BYTES,
    device=None,
) -> StreamedModel:
    """Read a checkpoint (the native flat layout, or the HuggingFace layout
    of llama, gpt2, bert or t5; ``utils/hf_import.py``) and dispatch it.
    ``model`` may be built on ``device="meta"``: its own weights are never
    read."""
    from .utils.hf_import import load_checkpoint_in_model

    params = load_checkpoint_in_model(model, checkpoint)
    return dispatch_model(model, params, device_map=device_map, max_memory=max_memory,
                          offload_dir=offload_dir, dtype=dtype, stream_window_bytes=stream_window_bytes,
                          device=device)


def load_and_quantize_model(
    model,
    quantization_config: QuantizationConfig,
    weights_location: Optional[str] = None,
    params: Optional[dict] = None,
    device_map: dict[str, str] | str = "auto",
    max_memory: Optional[dict] = None,
    offload_dir: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    stream_window_bytes: int = DEFAULT_STREAM_WINDOW_BYTES,
    device=None,
) -> StreamedModel:
    """Load a checkpoint (or take ``params``) and dispatch it with the layer
    matrices quantized to int8/int4 on the host (per-output-channel scales,
    dequantized on the device as each layer runs)."""
    if params is None:
        if weights_location is None:
            raise ValueError("Pass weights_location (a checkpoint) or params.")
        from .utils.hf_import import load_checkpoint_in_model

        params = load_checkpoint_in_model(model, weights_location)
    return dispatch_model(model, params, device_map=device_map, max_memory=max_memory,
                          offload_dir=offload_dir, dtype=dtype, quantization=quantization_config,
                          stream_window_bytes=stream_window_bytes, device=device)
