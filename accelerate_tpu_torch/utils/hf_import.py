"""Import HuggingFace-layout checkpoints into the port's param trees.

Counterpart of ``accelerate_tpu/utils/hf_import.py``. The torch naming is
translated into the JAX layout the port's models keep (stacked layers on a
leading axis, ``[in, out]`` projections), as numpy leaves:

- a torch ``nn.Linear.weight`` is ``[out, in]``: every Linear projection is
  transposed on import (gpt2's Conv1D weights are ``[in, out]`` already);
- the per-layer tensors ``model.layers.{i}.*`` stack on a leading axis;
- tied embeddings: without ``lm_head.weight`` a llama config must say
  ``tie_embeddings=True``; a present lm_head equal to the embedding is the
  serialized tie and is dropped, a different one raises.

Reads a single ``model.safetensors``, a ``model.safetensors.index.json``
shard index, or a directory holding either, through the port's own reader
(``checkpointing._load_flat``: safetensors where installed, the ``.npz``
sibling where not). Covers llama, gpt2, bert and t5.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Optional

import numpy as np

from ..logging import get_logger
from .modeling import _iter_flat, abstract_params

logger = get_logger(__name__)

# torch-name → (our path, needs_transpose). {i} is the layer index.
_HF_LLAMA_LAYER_MAP = {
    "model.layers.{i}.self_attn.q_proj.weight": ("layers/wq", True),
    "model.layers.{i}.self_attn.k_proj.weight": ("layers/wk", True),
    "model.layers.{i}.self_attn.v_proj.weight": ("layers/wv", True),
    "model.layers.{i}.self_attn.o_proj.weight": ("layers/wo", True),
    "model.layers.{i}.mlp.gate_proj.weight": ("layers/w_gate", True),
    "model.layers.{i}.mlp.up_proj.weight": ("layers/w_up", True),
    "model.layers.{i}.mlp.down_proj.weight": ("layers/w_down", True),
    "model.layers.{i}.input_layernorm.weight": ("layers/attn_norm", False),
    "model.layers.{i}.post_attention_layernorm.weight": ("layers/mlp_norm", False),
}


def load_hf_state_dict(path: str) -> dict[str, np.ndarray]:
    """Flat ``{torch_name: numpy}`` from a file, a shard index or a directory."""
    from ..checkpointing import _load_flat

    if os.path.isdir(path):
        for candidate in ("model.safetensors.index.json", "model.safetensors", "model.npz"):
            full = os.path.join(path, candidate)
            if os.path.exists(full):
                path = full
                break
        else:
            raise FileNotFoundError(f"No HF-layout weights under {path}")
    if path.endswith(".index.json"):
        with open(path) as f:
            index = json.load(f)
        directory = os.path.dirname(path)
        flat: dict[str, np.ndarray] = {}
        for shard in sorted(set(index["weight_map"].values())):
            flat.update(_load_flat(os.path.join(directory, shard)))
        return flat
    return _load_flat(path)


def _tree_astype(tree, dtype):
    """Cast every floating leaf (numpy) of a nested dict to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _tree_astype(v, dtype) for k, v in tree.items()}
    return tree.astype(dtype) if np.issubdtype(tree.dtype, np.floating) else tree


def looks_like_hf_checkpoint(flat: dict) -> bool:
    prefixes = ("model.", "transformer.", "bert.", "encoder.block.", "decoder.block.")
    return any(k.startswith(prefixes) or k in ("lm_head.weight", "shared.weight") for k in flat)


def _taker(flat: dict, consumed: set):
    def take(name: str, transpose: bool) -> np.ndarray:
        if name not in flat:
            raise KeyError(f"HF checkpoint is missing {name!r}")
        consumed.add(name)
        value = np.asarray(flat[name])
        return value.T if transpose else value

    return take


def import_hf_llama(flat: dict[str, np.ndarray], config, dtype: Optional[Any] = None) -> dict:
    """HF-layout flat dict -> the llama param tree (numpy leaves). Raises
    ``KeyError`` for a missing tensor and ``ValueError`` for a shape off the
    config, so a wrong config fails loudly instead of truncating."""
    if getattr(config, "num_experts", 1) > 1:
        raise NotImplementedError(
            "HF llama checkpoint interop covers the dense family; MoE variants "
            "use the native checkpoint format (save_model_weights)."
        )
    L, h = config.num_layers, config.hidden_size
    consumed: set[str] = set()
    take = _taker(flat, consumed)
    params: dict[str, Any] = {
        "embed_tokens": take("model.embed_tokens.weight", False),
        "final_norm": take("model.norm.weight", False),
    }
    layers: dict[str, np.ndarray] = {}
    for torch_tpl, (ours, transpose) in _HF_LLAMA_LAYER_MAP.items():
        layers[ours.split("/")[1]] = np.stack([take(torch_tpl.format(i=i), transpose) for i in range(L)])
    params["layers"] = layers

    if "lm_head.weight" in flat:
        head = take("lm_head.weight", True)  # [h, v]
        if config.tie_embeddings:
            if not np.array_equal(head, params["embed_tokens"].T):
                raise ValueError(
                    "config.tie_embeddings=True but the checkpoint carries a "
                    "distinct lm_head — set tie_embeddings=False for this model"
                )
            logger.info("Dropping tied lm_head (reusing embed_tokens)")
        else:
            params["lm_head"] = head
    elif not config.tie_embeddings:
        raise KeyError(
            "HF checkpoint has no lm_head.weight and config.tie_embeddings is "
            "False — either the checkpoint is tied (set tie_embeddings=True) or "
            "it is incomplete"
        )

    d, nh, nkv, i_sz = config.dim_per_head, config.num_heads, config.kv_heads, config.intermediate_size
    expect = {"embed_tokens": (config.vocab_size, h), "final_norm": (h,)}
    layer_expect = {
        "wq": (L, h, nh * d), "wk": (L, h, nkv * d), "wv": (L, h, nkv * d), "wo": (L, nh * d, h),
        "w_gate": (L, h, i_sz), "w_up": (L, h, i_sz), "w_down": (L, i_sz, h),
        "attn_norm": (L, h), "mlp_norm": (L, h),
    }
    for key, shape in expect.items():
        if tuple(params[key].shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {params[key].shape} != config shape {shape}")
    for key, shape in layer_expect.items():
        if tuple(layers[key].shape) != shape:
            raise ValueError(f"layers/{key}: checkpoint shape {layers[key].shape} != config shape {shape}")

    unused = set(flat) - consumed - {"model.rotary_emb.inv_freq"} - {
        k for k in flat if re.fullmatch(r"model\.layers\.\d+\.self_attn\.rotary_emb\.inv_freq", k)
    }
    if unused:
        logger.warning(f"Ignoring {len(unused)} unused checkpoint tensors: {sorted(unused)[:5]}...")
    return params if dtype is None else _tree_astype(params, np.dtype(dtype))


def export_hf_llama(params: dict, config) -> dict[str, np.ndarray]:
    """Inverse of :func:`import_hf_llama`: the llama tree -> HF torch naming
    (contiguous arrays, as torch's are, ready for any writer)."""
    flat: dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _numpy(params["embed_tokens"]),
        "model.norm.weight": _numpy(params["final_norm"]),
    }
    for torch_tpl, (ours, transpose) in _HF_LLAMA_LAYER_MAP.items():
        stacked = _numpy(params["layers"][ours.split("/")[1]])
        for i in range(config.num_layers):
            flat[torch_tpl.format(i=i)] = np.ascontiguousarray(stacked[i].T if transpose else stacked[i])
    if "lm_head" in params:
        flat["lm_head.weight"] = np.ascontiguousarray(_numpy(params["lm_head"]).T)
    return flat


def _numpy(leaf) -> np.ndarray:
    """A leaf (numpy, or a CPU or CUDA tensor of a numpy dtype) as numpy."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# torch-name template → (our '/'-joined path with a stacked leading dim,
# needs_transpose). GPT-2 uses Conv1D modules stored [in, out] — the SAME
# layout as ours, so nothing transposes; Linear-based models (bert, t5)
# store [out, in] and transpose on import.
_HF_GPT2_LAYER_MAP = {
    "transformer.h.{i}.ln_1.weight": ("layers/attn_norm_scale", False),
    "transformer.h.{i}.ln_1.bias": ("layers/attn_norm_bias", False),
    "transformer.h.{i}.attn.c_attn.weight": ("layers/wqkv", False),
    "transformer.h.{i}.attn.c_attn.bias": ("layers/bqkv", False),
    "transformer.h.{i}.attn.c_proj.weight": ("layers/wo", False),
    "transformer.h.{i}.attn.c_proj.bias": ("layers/bo", False),
    "transformer.h.{i}.ln_2.weight": ("layers/mlp_norm_scale", False),
    "transformer.h.{i}.ln_2.bias": ("layers/mlp_norm_bias", False),
    "transformer.h.{i}.mlp.c_fc.weight": ("layers/w_up", False),
    "transformer.h.{i}.mlp.c_fc.bias": ("layers/b_up", False),
    "transformer.h.{i}.mlp.c_proj.weight": ("layers/w_down", False),
    "transformer.h.{i}.mlp.c_proj.bias": ("layers/b_down", False),
}
_HF_GPT2_TOP_MAP = {
    "transformer.wte.weight": ("embed_tokens", False),
    "transformer.wpe.weight": ("embed_positions", False),
    "transformer.ln_f.weight": ("final_norm_scale", False),
    "transformer.ln_f.bias": ("final_norm_bias", False),
}
_HF_GPT2_IGNORE = (r"transformer\.h\.\d+\.attn\.(bias|masked_bias)", r"lm_head\.weight")

_HF_BERT_LAYER_MAP = {
    "bert.encoder.layer.{i}.attention.self.query.weight": ("layers/wq", True),
    "bert.encoder.layer.{i}.attention.self.query.bias": ("layers/bq", False),
    "bert.encoder.layer.{i}.attention.self.key.weight": ("layers/wk", True),
    "bert.encoder.layer.{i}.attention.self.key.bias": ("layers/bk", False),
    "bert.encoder.layer.{i}.attention.self.value.weight": ("layers/wv", True),
    "bert.encoder.layer.{i}.attention.self.value.bias": ("layers/bv", False),
    "bert.encoder.layer.{i}.attention.output.dense.weight": ("layers/wo", True),
    "bert.encoder.layer.{i}.attention.output.dense.bias": ("layers/bo", False),
    "bert.encoder.layer.{i}.attention.output.LayerNorm.weight": ("layers/attn_norm_scale", False),
    "bert.encoder.layer.{i}.attention.output.LayerNorm.bias": ("layers/attn_norm_bias", False),
    "bert.encoder.layer.{i}.intermediate.dense.weight": ("layers/w_up", True),
    "bert.encoder.layer.{i}.intermediate.dense.bias": ("layers/b_up", False),
    "bert.encoder.layer.{i}.output.dense.weight": ("layers/w_down", True),
    "bert.encoder.layer.{i}.output.dense.bias": ("layers/b_down", False),
    "bert.encoder.layer.{i}.output.LayerNorm.weight": ("layers/mlp_norm_scale", False),
    "bert.encoder.layer.{i}.output.LayerNorm.bias": ("layers/mlp_norm_bias", False),
}
_HF_BERT_TOP_MAP = {
    "bert.embeddings.word_embeddings.weight": ("embeddings/word", False),
    "bert.embeddings.position_embeddings.weight": ("embeddings/position", False),
    "bert.embeddings.token_type_embeddings.weight": ("embeddings/token_type", False),
    "bert.embeddings.LayerNorm.weight": ("embeddings/norm_scale", False),
    "bert.embeddings.LayerNorm.bias": ("embeddings/norm_bias", False),
    "bert.pooler.dense.weight": ("pooler/w", True),
    "bert.pooler.dense.bias": ("pooler/b", False),
    "classifier.weight": ("classifier/w", True),
    "classifier.bias": ("classifier/b", False),
}
_HF_BERT_IGNORE = (r"bert\.embeddings\.position_ids", r"cls\..*")

_HF_T5_LAYER_MAP = {
    "encoder.block.{i}.layer.0.SelfAttention.q.weight": ("encoder/wq", True),
    "encoder.block.{i}.layer.0.SelfAttention.k.weight": ("encoder/wk", True),
    "encoder.block.{i}.layer.0.SelfAttention.v.weight": ("encoder/wv", True),
    "encoder.block.{i}.layer.0.SelfAttention.o.weight": ("encoder/wo", True),
    "encoder.block.{i}.layer.0.layer_norm.weight": ("encoder/attn_norm", False),
    "encoder.block.{i}.layer.1.DenseReluDense.wi.weight": ("encoder/wi", True),
    "encoder.block.{i}.layer.1.DenseReluDense.wo.weight": ("encoder/wo_ff", True),
    "encoder.block.{i}.layer.1.layer_norm.weight": ("encoder/mlp_norm", False),
    "decoder.block.{i}.layer.0.SelfAttention.q.weight": ("layers/self_wq", True),
    "decoder.block.{i}.layer.0.SelfAttention.k.weight": ("layers/self_wk", True),
    "decoder.block.{i}.layer.0.SelfAttention.v.weight": ("layers/self_wv", True),
    "decoder.block.{i}.layer.0.SelfAttention.o.weight": ("layers/self_wo", True),
    "decoder.block.{i}.layer.0.layer_norm.weight": ("layers/self_norm", False),
    "decoder.block.{i}.layer.1.EncDecAttention.q.weight": ("layers/cross_wq", True),
    "decoder.block.{i}.layer.1.EncDecAttention.k.weight": ("layers/cross_wk", True),
    "decoder.block.{i}.layer.1.EncDecAttention.v.weight": ("layers/cross_wv", True),
    "decoder.block.{i}.layer.1.EncDecAttention.o.weight": ("layers/cross_wo", True),
    "decoder.block.{i}.layer.1.layer_norm.weight": ("layers/cross_norm", False),
    "decoder.block.{i}.layer.2.DenseReluDense.wi.weight": ("layers/wi", True),
    "decoder.block.{i}.layer.2.DenseReluDense.wo.weight": ("layers/wo_ff", True),
    "decoder.block.{i}.layer.2.layer_norm.weight": ("layers/mlp_norm", False),
}
_HF_T5_TOP_MAP = {
    "shared.weight": ("shared_embed", False),
    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": ("enc_rel_bias", False),
    "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": ("dec_rel_bias", False),
    "encoder.final_layer_norm.weight": ("enc_final_norm", False),
    "decoder.final_layer_norm.weight": ("dec_final_norm", False),
}
_HF_T5_IGNORE = (
    r"(encoder|decoder)\.embed_tokens\.weight",  # alias of shared.weight
    r"lm_head\.weight",  # tied copy only — untied heads raise (see below)
)

_HF_FAMILY_TABLES = {
    "gpt2": (_HF_GPT2_LAYER_MAP, _HF_GPT2_TOP_MAP, _HF_GPT2_IGNORE),
    "bert": (_HF_BERT_LAYER_MAP, _HF_BERT_TOP_MAP, _HF_BERT_IGNORE),
    "t5": (_HF_T5_LAYER_MAP, _HF_T5_TOP_MAP, _HF_T5_IGNORE),
}



def _set_path(tree: dict, path: str, value) -> None:
    node = tree
    parts = path.split("/")
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node[parts[-1]] = value


def _abstract_shapes(config) -> dict[str, tuple]:
    """``{"a/b": shape}`` of the config's model, from a ``meta`` model."""
    from ..models import _ARCHS

    model = _ARCHS[config.arch](config, device="meta")
    return {k: tuple(v.shape) for k, v in _iter_flat(abstract_params(model))}


def import_hf_family(flat: dict[str, np.ndarray], config, dtype: Optional[Any] = None) -> dict:
    """Table-driven HF-layout translation for gpt2, bert and t5 (llama has
    its tie-aware :func:`import_hf_llama`). Shapes are checked against the
    config's model built on ``meta``."""
    layer_map, top_map, ignore = _HF_FAMILY_TABLES[config.arch]
    consumed: set[str] = set()
    take = _taker(flat, consumed)
    params: dict[str, Any] = {}
    for torch_name, (ours, transpose) in top_map.items():
        _set_path(params, ours, take(torch_name, transpose))
    for torch_tpl, (ours, transpose) in layer_map.items():
        _set_path(params, ours, np.stack([take(torch_tpl.format(i=i), transpose)
                                          for i in range(config.num_layers)]))

    if config.arch == "t5" and "lm_head.weight" in flat:
        # the port's T5 computes logits from the shared embedding: a
        # checkpoint whose head differs (tie_word_embeddings=False) is refused
        if not np.array_equal(np.asarray(flat["lm_head.weight"]), np.asarray(flat["shared.weight"])):
            raise ValueError(
                "HF t5 checkpoint carries an UNTIED lm_head.weight "
                "(tie_word_embeddings=False); this T5 family computes logits "
                "from the shared embedding — untied-head checkpoints are not "
                "supported."
            )

    unused = {k for k in set(flat) - consumed if not any(re.fullmatch(p, k) for p in ignore)}
    if unused:
        logger.warning(f"Ignoring {len(unused)} unused checkpoint tensors: {sorted(unused)[:5]}...")

    expected = _abstract_shapes(config)
    got = {k: tuple(v.shape) for k, v in _iter_flat(params)}
    if expected.keys() != got.keys():
        missing = sorted(expected.keys() - got.keys())
        extra = sorted(got.keys() - expected.keys())
        raise KeyError(f"HF import tree mismatch: missing {missing[:5]}, extra {extra[:5]}")
    for key, shape in expected.items():
        if got[key] != shape:
            raise ValueError(f"{key}: checkpoint shape {got[key]} != config shape {shape}")
    return params if dtype is None else _tree_astype(params, np.dtype(dtype))


def export_hf_family(params: dict, config) -> dict[str, np.ndarray]:
    """Inverse of :func:`import_hf_family`: the tree -> HF torch naming."""
    layer_map, top_map, _ = _HF_FAMILY_TABLES[config.arch]

    def get(path: str) -> np.ndarray:
        node = params
        for part in path.split("/"):
            node = node[part]
        return _numpy(node)

    flat: dict[str, np.ndarray] = {}
    for torch_name, (ours, transpose) in top_map.items():
        value = get(ours)
        flat[torch_name] = np.ascontiguousarray(value.T if transpose else value)
    for torch_tpl, (ours, transpose) in layer_map.items():
        stacked = get(ours)
        for i in range(config.num_layers):
            flat[torch_tpl.format(i=i)] = np.ascontiguousarray(stacked[i].T if transpose else stacked[i])
    return flat


def load_checkpoint_in_model(model, checkpoint_path: str, dtype=None) -> dict:
    """Read an HF-layout or a native-layout checkpoint for ``model`` and
    return its param tree (numpy leaves; nothing is placed on a device).
    The native layout is the port's and the JAX package's flat
    ``"layers/wq"`` keys (``save_model_weights``)."""
    flat = load_hf_state_dict(checkpoint_path)
    if looks_like_hf_checkpoint(flat):
        arch = getattr(model.config, "arch", "llama")
        if arch in _HF_FAMILY_TABLES:
            return import_hf_family(flat, model.config, dtype=dtype)
        return import_hf_llama(flat, model.config, dtype=dtype)
    shapes = {k: tuple(v.shape) for k, v in _iter_flat(abstract_params(model))}
    params: dict = {}
    for key, shape in shapes.items():
        if key not in flat:
            raise KeyError(f"checkpoint missing parameter {key!r}")
        value = np.asarray(flat[key])
        if value.shape != shape:
            raise ValueError(f"shape mismatch for {key}: checkpoint {value.shape} vs model {shape}")
        _set_path(params, key, value)
    return params if dtype is None else _tree_astype(params, np.dtype(dtype))
