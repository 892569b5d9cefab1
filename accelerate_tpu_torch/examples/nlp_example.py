"""The canonical training loop: BERT sequence classification on an MRPC-like
paraphrase task, on the PyTorch port.

The port's copy of ``examples/nlp_example.py``: the user keeps the loop, and
``Accelerator`` -> ``prepare`` -> ``backward`` -> ``gather_for_metrics``
run it on one card (or on the CPU). The schedule is optax's
``warmup_cosine_decay_schedule`` formula (``scheduler.py``), the optimizer
the port's ``adamw(schedule)``. The reference's ``end_training`` closes its
trackers, which the port does not have yet (ROADMAP item 19).

Run (one CUDA card, or ``--device cpu``):
    python -m accelerate_tpu_torch.examples.nlp_example --mixed_precision bf16
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..accelerator import Accelerator
from ..models import Bert
from ..ops.fused_adamw import adamw
from ..scheduler import warmup_cosine_decay_schedule
from ..utils.random import set_seed
from .example_utils import PairClassificationDataset, accuracy_f1, train_eval_split

EVAL_BATCH_SIZE = 16


def get_dataloaders(accelerator: Accelerator, batch_size: int, max_len: int, vocab_size: int):
    """Train/eval loaders over the bundled dataset (deterministic split)."""
    dataset = PairClassificationDataset(vocab_size=vocab_size, max_len=max_len)
    train_set, eval_set = train_eval_split(dataset)
    train_loader = accelerator.prepare_data_loader(train_set, batch_size=batch_size, shuffle=True, seed=42)
    eval_loader = accelerator.prepare_data_loader(eval_set, batch_size=EVAL_BATCH_SIZE, shuffle=False)
    return train_loader, eval_loader


def training_function(config: dict, args: argparse.Namespace, params: Optional[dict] = None,
                      losses: Optional[list] = None) -> dict:
    """Train and evaluate; returns the last epoch's metric. ``params`` (a
    JAX-layout tree of numpy arrays) replaces the seeded initial weights,
    and ``losses`` collects every step's loss: the parity test's hooks."""
    accelerator = Accelerator(mixed_precision=args.mixed_precision, device=args.device)
    set_seed(int(config["seed"]))

    model = Bert("bert-tiny", device=accelerator.device, seed=int(config["seed"]))
    cfg = model.config
    train_loader, eval_loader = get_dataloaders(
        accelerator, int(config["batch_size"]), max_len=64, vocab_size=cfg.vocab_size
    )

    steps_per_epoch = len(train_loader)
    warmup_steps = max(1, steps_per_epoch // 2)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=config["lr"],
        warmup_steps=warmup_steps,
        decay_steps=max(steps_per_epoch * int(config["num_epochs"]), warmup_steps + 1),
    )
    model = accelerator.prepare_model(model, params=params)
    model, optimizer, scheduler = accelerator.prepare(model, adamw(schedule), schedule)
    loss_fn = Bert.loss_fn(accelerator.unwrap_model(model))

    eval_metric: dict = {}
    for epoch in range(int(config["num_epochs"])):
        train_loader.set_epoch(epoch)
        for batch in train_loader:
            with accelerator.accumulate(model):
                loss = accelerator.backward(loss_fn, batch)
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad()
            if losses is not None:
                losses.append(float(loss))

        predictions, references = [], []
        for batch in eval_loader:
            with torch.no_grad():
                logits = model.module.apply(
                    model.params, batch["input_ids"], batch["attention_mask"], batch["token_type_ids"]
                )
            preds, refs = accelerator.gather_for_metrics((logits.argmax(dim=-1), batch["labels"]))
            predictions.append(preds.cpu().numpy())
            references.append(refs.cpu().numpy())
        eval_metric = accuracy_f1(np.concatenate(predictions), np.concatenate(references))
        accelerator.print(f"epoch {epoch}: {eval_metric}")
    return eval_metric


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Canonical training-loop example.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16"],
        help="Compute precision policy (params stay fp32).",
    )
    parser.add_argument("--num_epochs", type=int, default=3)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--device", type=str, default=None, help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    config = {"lr": args.lr, "num_epochs": args.num_epochs, "seed": 42, "batch_size": args.batch_size}
    return training_function(config, args)


if __name__ == "__main__":
    main()
