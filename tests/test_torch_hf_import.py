"""The port's HuggingFace-layout checkpoints (``accelerate_tpu_torch/utils/
hf_import.py``, ``models/config.py config_from_hf_json``) against the JAX
package's (``accelerate_tpu/utils/hf_import.py``; its tests
``tests/test_hf_import.py``) on the CPU, for llama, gpt2, bert and t5 at
tiny configs with seeded numpy params.

Tolerance: none. Export and import move arrays without arithmetic, so the
port's exported dicts, imported trees and loaded checkpoints equal the JAX
package's bit for bit, and the configs equal field for field. The error
cases raise the JAX package's exception types."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from accelerate_tpu.models.config import config_from_hf_json as jax_config_from_hf_json
from accelerate_tpu.utils import hf_import as jhf
from accelerate_tpu_torch.checkpointing import _save_flat
from accelerate_tpu_torch.models import GPT2, T5, Bert, Llama, get_config
from accelerate_tpu_torch.models.config import config_from_hf_json
from accelerate_tpu_torch.utils import export_hf_llama, import_hf_llama, load_checkpoint_in_model
from accelerate_tpu_torch.utils import hf_import
from accelerate_tpu_torch.utils.modeling import _iter_flat, _unflatten, abstract_params

CLASSES = {"llama": Llama, "gpt2": GPT2, "bert": Bert, "t5": T5}
CONFIGS = {"llama": "llama-tiny", "gpt2": "gpt2-tiny", "bert": "bert-tiny", "t5": "t5-tiny"}


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    previous = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(previous)


def _case(family, **changes):
    """(meta model, seeded numpy params in the JAX layout)."""
    config = get_config(CONFIGS[family]).replace(**changes)
    model = CLASSES[family](config, device="meta")
    rng = np.random.default_rng(len(family))
    params = {k: rng.normal(size=tuple(v.shape)).astype(np.float32)
              for k, v in _iter_flat(abstract_params(model))}
    return model, _unflatten(params)


def _export(family, params, config):
    if family == "llama":
        return export_hf_llama(params, config), jhf.export_hf_llama(params, config)
    return hf_import.export_hf_family(params, config), jhf.export_hf_family(params, config)


def _assert_trees_equal(got, want):
    got, want = dict(_iter_flat(got)), dict(_iter_flat(want))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("family", sorted(CLASSES))
def test_export_import_and_load_equal_the_jax_package(family, tmp_path):
    model, params = _case(family)
    config = model.config
    flat, jax_flat = _export(family, params, config)
    assert flat.keys() == jax_flat.keys()
    for key in flat:
        np.testing.assert_array_equal(flat[key], jax_flat[key], err_msg=key)
    importer = import_hf_llama if family == "llama" else hf_import.import_hf_family
    jax_importer = jhf.import_hf_llama if family == "llama" else jhf.import_hf_family
    back = importer(flat, config)
    _assert_trees_equal(back, jax_importer(flat, config))
    _assert_trees_equal(back, params)
    half = importer(flat, config, dtype=np.float16)
    assert all(v.dtype == np.float16 for _, v in _iter_flat(half))

    _save_flat(flat, str(tmp_path / "model.safetensors"))
    loaded = load_checkpoint_in_model(model, str(tmp_path))
    _assert_trees_equal(loaded, params)
    _assert_trees_equal(loaded, jhf.load_checkpoint_in_model(model, str(tmp_path)))


def test_sharded_index_npz_sibling_and_native_layout(tmp_path):
    """A two-shard ``model.safetensors.index.json``, the ``.npz`` the writer
    leaves where safetensors is missing, and the native ``"layers/wq"``
    layout all load to the same tree."""
    model, params = _case("llama")
    flat = export_hf_llama(params, model.config)
    keys = sorted(flat)
    shards = {"model-1.safetensors": keys[: len(keys) // 2], "model-2.safetensors": keys[len(keys) // 2:]}
    for name, names in shards.items():
        _save_flat({k: flat[k] for k in names}, str(tmp_path / name))
    weight_map = {k: name for name, names in shards.items() for k in names}
    (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    _assert_trees_equal(load_checkpoint_in_model(model, str(tmp_path)), params)

    npz = tmp_path / "npz"
    npz.mkdir()
    _save_flat(flat, str(npz / "model.safetensors"), safe_serialization=False)
    assert [p.name for p in npz.iterdir()] == ["model.npz"]
    _assert_trees_equal(load_checkpoint_in_model(model, str(npz)), params)

    native = tmp_path / "native"
    native.mkdir()
    _save_flat(dict(_iter_flat(params)), str(native / "model.safetensors"))
    _assert_trees_equal(load_checkpoint_in_model(model, str(native)), params)
    _assert_trees_equal(load_checkpoint_in_model(model, str(native)),
                        jhf.load_checkpoint_in_model(_jax_llama(model.config), str(native)))
    with pytest.raises(FileNotFoundError):
        load_checkpoint_in_model(model, str(tmp_path / "missing-dir-not-made"))


def _jax_llama(config):
    from accelerate_tpu.models import Llama as JaxLlama

    return JaxLlama(config)


def test_tied_llama_copy_is_dropped_and_distinct_head_raises():
    model, params = _case("llama", tie_embeddings=True)
    assert "lm_head" not in params
    flat = export_hf_llama(params, model.config)
    flat["lm_head.weight"] = params["embed_tokens"].copy()
    assert "lm_head" not in import_hf_llama(flat, model.config)
    flat["lm_head.weight"] = np.random.default_rng(0).normal(size=params["embed_tokens"].shape).astype(np.float32)
    for importer in (import_hf_llama, jhf.import_hf_llama):
        with pytest.raises(ValueError, match="distinct lm_head"):
            importer(flat, model.config)


def test_error_cases_raise_as_in_the_jax_package():
    model, params = _case("llama")
    flat = export_hf_llama(params, model.config)
    missing_head = {k: v for k, v in flat.items() if k != "lm_head.weight"}
    with pytest.raises(KeyError, match="tie_embeddings"):
        import_hf_llama(missing_head, model.config)
    wider = dataclasses.replace(model.config, intermediate_size=model.config.intermediate_size * 2)
    with pytest.raises(ValueError, match="shape"):
        import_hf_llama(flat, wider)
    with pytest.raises(KeyError, match="missing"):
        import_hf_llama({k: v for k, v in flat.items() if "layers.1.mlp" not in k}, model.config)
    with pytest.raises(NotImplementedError, match="MoE"):
        import_hf_llama(flat, model.config.replace(num_experts=4))

    t5, t5_params = _case("t5")
    t5_flat = hf_import.export_hf_family(t5_params, t5.config)
    t5_flat["lm_head.weight"] = t5_flat["shared.weight"].copy()
    hf_import.import_hf_family(t5_flat, t5.config)  # the serialized tie drops
    t5_flat["lm_head.weight"] = t5_flat["shared.weight"] + 1.0
    with pytest.raises(ValueError, match="UNTIED"):
        hf_import.import_hf_family(t5_flat, t5.config)

    gpt2, gpt2_params = _case("gpt2")
    gpt2_flat = hf_import.export_hf_family(gpt2_params, gpt2.config)
    with pytest.raises(KeyError, match="missing"):
        hf_import.import_hf_family({k: v for k, v in gpt2_flat.items() if k != "transformer.wpe.weight"},
                                   gpt2.config)
    with pytest.raises(ValueError, match="shape"):
        hf_import.import_hf_family(gpt2_flat, gpt2.config.replace(max_seq_len=gpt2.config.max_seq_len * 2))


HF_CONFIGS = {
    "llama": {"model_type": "llama", "vocab_size": 1000, "hidden_size": 64, "intermediate_size": 176,
              "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2,
              "max_position_embeddings": 512, "rope_theta": 500000.0, "rms_norm_eps": 1e-6,
              "tie_word_embeddings": True},
    "mistral": {"model_type": "mistral", "vocab_size": 1000, "hidden_size": 64, "intermediate_size": 176,
                "num_hidden_layers": 2, "num_attention_heads": 8, "head_dim": 16},
    "gpt2": {"model_type": "gpt2", "vocab_size": 500, "n_embd": 48, "n_layer": 2, "n_head": 4,
             "n_positions": 128, "layer_norm_epsilon": 1e-5},
    "bert": {"model_type": "bert", "vocab_size": 700, "hidden_size": 32, "intermediate_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 2, "max_position_embeddings": 64,
             "type_vocab_size": 3},
    "t5": {"model_type": "t5", "vocab_size": 600, "d_model": 32, "d_ff": 64, "num_layers": 2,
           "num_heads": 4, "d_kv": 8, "relative_attention_num_buckets": 16, "decoder_start_token_id": 0},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_config_from_hf_json_agrees_with_the_jax_package(name, tmp_path):
    cfg = HF_CONFIGS[name]
    want = dataclasses.asdict(jax_config_from_hf_json(cfg))
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    for source in (cfg, str(tmp_path), str(tmp_path / "config.json")):
        assert dataclasses.asdict(config_from_hf_json(source)) == want
    with pytest.raises(ValueError, match="Unsupported model_type"):
        config_from_hf_json({**cfg, "model_type": "falcon"})
    if name == "t5":
        with pytest.raises(ValueError, match="asymmetric"):
            config_from_hf_json({**cfg, "num_decoder_layers": 3})
