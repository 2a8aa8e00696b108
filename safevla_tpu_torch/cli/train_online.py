"""Online safe-RL training CLI of the port (the JAX package's
`cli/train_online.py`, which replaces scripts/train.sh + the fire-exposed
runner, reference training/online/dinov2_vits_tsfm_base.py:395-402,
allenact_trainer.py:47-72):

    python -m safevla_tpu_torch.cli.train_online --fake-env \
        train.task_type=FetchType model.critic_type=discrete \
        lagrange.cost_limit=2.31 train.num_train_processes=32

Any config leaf is overridable as section.field=value; every task type of
`tasks.REGISTERED_TASKS` trains, with the `linear`, `mlp` or `discrete`
(HL-Gauss) critic. The policy trains on the card (`main(..., device="cpu")`
trains on the CPU, as the tests do). `--smoke` builds the JAX CLI's tiny
model (with the critic type asked for) on 4 streams x 8 steps.
`--fake-env` trains on FakeController streams; without it the streams run
AI2-THOR (`StretchController`, which needs `ai2thor`) over the task specs of
`--data-dir` (an Hdf5TaskSpecs directory) and the houses of `--houses-dir`,
in a worker process each unless `--env-workers` says otherwise.

On N GPUs, one process per GPU (JAX's `mesh` branch, cli/train_online.py:74):

    torchrun --nproc-per-node N -m safevla_tpu_torch.cli.train_online \
        --fake-env mesh.dp=N ...

or N processes with SAFEVLA_COORDINATOR=host:port SAFEVLA_NUM_PROCESSES=N
SAFEVLA_PROCESS_ID=<rank>. When the environment names more than one process
the CLI joins the group (`parallel.initialize_multihost`, NCCL on the card,
gloo on the CPU), builds the mesh from `mesh.dp` / `mesh.mdl` and trains
data-parallel; only rank 0 writes the logs and the checkpoints. The port
keeps no compile cache, so the JAX CLI's cache set-up has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys


def _process_count() -> int:
    """The processes the environment names (the SAFEVLA_* variables or torchrun's)."""
    return int(os.environ.get("SAFEVLA_NUM_PROCESSES") or os.environ.get("WORLD_SIZE") or 1)


def main(argv=None, device="cuda"):
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--fake-env", action="store_true",
                        help="use FakeController streams (no simulator)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny model + fake env: verify the pipeline in minutes")
    parser.add_argument("--data-dir", default=None,
                        help="task-spec dataset dir (hdf5 layout)")
    parser.add_argument("--houses-dir", default=None)
    parser.add_argument("--env-workers", type=int, default=None,
                        help="simulator worker processes (default: one per stream)")
    parser.add_argument("--max-wall-seconds", type=float, default=None)
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from safevla_tpu_torch.config import Config, apply_overrides
    from safevla_tpu_torch.launch import make_fake_sampler_factory, make_thor_sampler_factory
    from safevla_tpu_torch.parallel.distributed import initialize_multihost, is_primary_host, shutdown_multihost
    from safevla_tpu_torch.parallel.mesh import make_mesh
    from safevla_tpu_torch.training.online import OnlineTrainer
    from safevla_tpu_torch.utils.wandb_logging import WandbLogger

    cfg = apply_overrides(Config(), args.overrides)

    if args.smoke:
        from safevla_tpu_torch.config import ModelConfig
        from safevla_tpu_torch.models import vit as vitmod

        vitmod.VIT_CONFIGS["smoke_tiny"] = vitmod.DinoViTConfig(
            embed_dim=32, depth=1, num_heads=2, img_height=28, img_width=42,
            patch_size=14,
        )
        cfg.model = ModelConfig(
            hidden_size=64, num_tx_layers=2, num_tx_heads=4, goal_dims=64,
            text_embed_size=64, combiner_layers=1, combiner_heads=4,
            combiner_ffn_dim=128, dino_compressor_hidden_out_dims=(64, 64),
            vision_backbone="smoke_tiny", vision_feature_dim=32,
            vision_grid=(7, 12), image_size=(28, 42), max_steps=16,
            text_max_tokens=8, num_towers=3, compute_dtype="float32",
            critic_type=cfg.model.critic_type,
        )
        cfg.ppo.num_steps = 8
        cfg.train.num_train_processes = min(cfg.train.num_train_processes, 4)
        cfg.train.max_steps = 16
        cfg.train.total_steps = min(cfg.train.total_steps, 96)
        args.fake_env = True

    if args.fake_env:
        factory = make_fake_sampler_factory(cfg)
        num_workers = args.env_workers or 0
    else:
        assert args.data_dir, "--data-dir required for simulator training"
        factory = make_thor_sampler_factory(
            cfg, args.data_dir, args.houses_dir, mode="train"
        )
        num_workers = (
            args.env_workers
            if args.env_workers is not None
            else cfg.train.num_train_processes
        )

    # a caller that joined the group already (a test's rank) keeps it
    joined = _process_count() > 1 and not dist.is_initialized()
    if joined:
        initialize_multihost(device=device)
    mesh = make_mesh(dp=cfg.mesh.dp, mdl=cfg.mesh.mdl) if dist.is_initialized() else None
    try:
        out = os.path.join(cfg.train.output_dir, cfg.train.tag)
        logger = WandbLogger(output_dir=out, config={"overrides": args.overrides}) if is_primary_host() else None
        trainer = OnlineTrainer(
            cfg,
            factory,
            num_workers=num_workers,
            log_fn=lambda m, s: logger.log(m, s),  # called on the primary rank only
            device=device,
            mesh=mesh,
        )
        try:
            return trainer.train(max_wall_seconds=args.max_wall_seconds)
        finally:
            trainer.close()
            if logger is not None:
                logger.finish()
    finally:
        if joined:
            shutdown_multihost()


if __name__ == "__main__":
    main()
