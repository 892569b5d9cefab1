"""Shared helpers of the port's examples: the self-contained tokenizer and
the tiny bundled MRPC-like dataset (``examples/data/mrpc_tiny.csv``, read
where it lies in the repository).

A copy of ``examples/example_utils.py``, not an import: the port imports
nothing of the JAX package's tree. Sentences are hash-tokenized into a fixed
vocabulary (no network, no pretrained tokenizer); the pair encoding
([CLS] s1 [SEP] s2 [SEP]), the padding and the metric are the reference's.
"""

from __future__ import annotations

import csv
import os

import numpy as np

PAD, CLS, SEP, UNK = 0, 1, 2, 3
_RESERVED = 4

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DATA_PATH = os.path.join(REPO_ROOT, "examples", "data", "mrpc_tiny.csv")


def tokenize(text: str, vocab_size: int) -> list[int]:
    """Deterministic hash tokenizer: word -> id in [4, vocab_size)."""
    ids = []
    for word in text.lower().split():
        word = word.strip(".,!?\"'")
        if not word:
            continue
        # FNV-1a, stable across processes (unlike Python's salted hash())
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        ids.append(_RESERVED + h % (vocab_size - _RESERVED))
    return ids


def encode_pair(s1: str, s2: str, vocab_size: int, max_len: int) -> dict[str, np.ndarray]:
    """[CLS] s1 [SEP] s2 [SEP] with padding, mask, and segment ids."""
    a, b = tokenize(s1, vocab_size), tokenize(s2, vocab_size)
    ids = [CLS] + a + [SEP] + b + [SEP]
    types = [0] * (len(a) + 2) + [1] * (len(b) + 1)
    ids, types = ids[:max_len], types[:max_len]
    pad = max_len - len(ids)
    return {
        "input_ids": np.asarray(ids + [PAD] * pad, np.int32),
        "attention_mask": np.asarray([1] * len(ids) + [0] * pad, np.int32),
        "token_type_ids": np.asarray(types + [0] * pad, np.int32),
    }


class PairClassificationDataset:
    """Map-style dataset over the bundled CSV (label,sentence1,sentence2)."""

    def __init__(self, path: str = DATA_PATH, vocab_size: int = 1024, max_len: int = 64):
        self.rows = []
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                self.rows.append(
                    (row["sentence1"], row["sentence2"], 1 if row["label"] == "equivalent" else 0)
                )
        self.vocab_size = vocab_size
        self.max_len = max_len

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> dict[str, np.ndarray]:
        s1, s2, label = self.rows[i]
        item = encode_pair(s1, s2, self.vocab_size, self.max_len)
        item["labels"] = np.asarray(label, np.int32)
        return item


def accuracy_f1(predictions: np.ndarray, references: np.ndarray) -> dict[str, float]:
    """The MRPC metric pair (accuracy + F1), computed locally."""
    predictions = np.asarray(predictions)
    references = np.asarray(references)
    accuracy = float((predictions == references).mean())
    tp = float(((predictions == 1) & (references == 1)).sum())
    fp = float(((predictions == 1) & (references == 0)).sum())
    fn = float(((predictions == 0) & (references == 1)).sum())
    f1 = 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0
    return {"accuracy": round(accuracy, 4), "f1": round(f1, 4)}


class Subset:
    """Index-view over a map-style dataset."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


def train_eval_split(dataset, eval_fraction: float = 0.25, seed: int = 0):
    """Deterministic shuffled train/eval split used by every example."""
    n_eval = max(int(len(dataset) * eval_fraction), 1)
    indices = np.random.default_rng(seed).permutation(len(dataset))
    return Subset(dataset, indices[n_eval:]), Subset(dataset, indices[:n_eval])
