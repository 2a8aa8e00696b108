"""Offline IL (behaviour cloning) CLI of the port (the JAX package's
`cli/train_offline.py`, which replaces the reference's
training/offline/train_pl.py launcher):

    python -m safevla_tpu_torch.cli.train_offline --data-dir /path/to/CHORES \
        offline.per_device_batch_size=16 offline.sliding_window=50

The trainer runs on the card (`main(argv, device="cpu")` runs it on the
CPU, as the tests do), with one policy tower (`model.num_towers=1`, as in
JAX). Checkpoints go to `<train.output_dir>/offline/step_<n>/`.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--subset", default="train")
    parser.add_argument("--val-subset", default=None)
    parser.add_argument("overrides", nargs="*")
    args = parser.parse_args(argv)

    import numpy as np

    from safevla_tpu_torch.config import Config, apply_overrides
    from safevla_tpu_torch.data.chores import ChoresDataset, collate_window_batch
    from safevla_tpu_torch.training.offline import OfflineTrainer
    from safevla_tpu_torch.utils.wandb_logging import WandbLogger

    cfg = apply_overrides(Config(), args.overrides)
    cfg.model = dataclasses.replace(cfg.model, num_towers=1)

    ds = ChoresDataset(
        args.data_dir,
        args.subset,
        sliding_window=cfg.offline.sliding_window,
        max_samples=cfg.offline.max_samples,
        reduce_action_redundancy=args.subset == "train",
    )
    val_ds = (
        ChoresDataset(
            args.data_dir,
            args.val_subset,
            sliding_window=cfg.offline.sliding_window,
            max_samples=cfg.offline.eval_max_samples,
        )
        if args.val_subset
        else None
    )

    bsz = cfg.offline.per_device_batch_size
    rng = np.random.default_rng(cfg.train.seed)

    def train_batches():
        order = rng.permutation(len(ds))
        for i in range(0, len(order) - bsz + 1, bsz):
            samples = [ds[j] for j in order[i : i + bsz]]
            yield collate_window_batch(samples, cfg.offline.sliding_window, ds.pad_token)

    def val_batches():
        for i in range(0, len(val_ds) - bsz + 1, bsz):
            samples = [val_ds[j] for j in range(i, i + bsz)]
            yield collate_window_batch(samples, cfg.offline.sliding_window, val_ds.pad_token)

    def curriculum(epoch: int):
        # last-steps-biased sampling ramps in late training
        # (reference train_pl.py:209-228)
        ds.set_prob_sample_last_steps(cfg.offline.prob_sample_last_steps)

    out = os.path.join(cfg.train.output_dir, "offline")
    logger = WandbLogger(output_dir=out)
    trainer = OfflineTrainer(cfg, device=device)
    try:
        trainer.fit(
            train_batches,
            val_batches=val_batches if val_ds else None,
            log_fn=lambda m, s: logger.log(m, s, prefix="offline"),
            curriculum_fn=curriculum,
            output_dir=out,
            logger=logger,
        )
    finally:
        logger.finish()


if __name__ == "__main__":
    main()
