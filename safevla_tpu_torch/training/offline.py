"""Offline imitation learning (behaviour cloning) trainer.

Counterpart of `safevla_tpu/training/offline.py` (the reference's Lightning
trainer, training/offline/train_pl.py:82-494): the offline model IS the
online PolicyTower (one tower, actor and critic heads), so IL -> RL init is
a copy of the tower weights.

One BC step: uint8 frames of both cameras -> augment (the epoch's
AugmentParams) -> normalise -> the frozen DINOv2 on all 2*B*T frames in one
call (no autograd: the ViT and T5 never train) -> `forward_seq` with one
episode per row (traj_idx 0, not_reset 1) -> cross-entropy with ignore index
-1 -> AdamW (optax.adamw's arithmetic, algo/optim.py) on the tower weights,
in place.

Differences from the JAX package, each by design:
  * the policy's tower weights and the AdamW moments are updated in place
    (JAX returns new arrays): keep the returned BCTrainState, never step an
    old one again;
  * the epoch's augmentation is drawn from a `torch.Generator` seeded with
    7 (JAX: `PRNGKey(7)`): the same seed gives other draws than JAX's;
  * `prepared_batches`' worker thread collates, tokenizes and copies into
    pinned host memory; the consumer (`attach_text`) issues the uploads as
    non-blocking copies on the step's own stream, so no upload can race the
    step that reads it, and the pinned buffers are freed by the caching
    host allocator once their copies have run;
  * metrics stay device tensors through the epoch and are read once at its
    end, as JAX reads them (no host synchronisation per step).

Data parallel (`mesh`, JAX's: the batch over dp, the state replicated):
each rank steps on its rows of every batch (`fit` takes them from the host
batch every rank reads), rank 0's weights and AdamW moments are broadcast at
`init_state`, and the gradients are all-reduced (one flat buffer) before the
step. The BC loss is a masked mean, so the global loss is sum(nll * valid)
over every rank's rows / sum(valid) over every rank's, not a mean of the
rank means (which differs when the ranks hold unequal counts of valid
targets): each rank's loss is its own sum over the global count, scaled by
the rank count, and the accuracy and the eval step's loss take the same
global sums. `fit` gathers the eval predictions for F1, and logs and
checkpoints from the primary rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from safevla_tpu_torch import resolve_device
from safevla_tpu_torch.algo.optim import AdamState, adamw_init, adamw_step, global_norm
from safevla_tpu_torch.config import Config
from safevla_tpu_torch.constants import rgb_norm_constants
from safevla_tpu_torch.models.actor_critic import SafeVLAPolicy
from safevla_tpu_torch.parallel.distributed import is_primary_host
from safevla_tpu_torch.parallel.mesh import Mesh, all_reduce_mean_, all_reduce_sum, world_size
from safevla_tpu_torch.preprocessing.augment import (
    apply_augment,
    identity_augment_params,
    sample_augment_params,
)
from safevla_tpu_torch.preprocessing.tokenize import InstructionTokenizer
from safevla_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from safevla_tpu_torch.utils.profiling import span

# the host batch's arrays that go to the device, and their dtypes there
_BATCH_KEYS = ("rgb_nav", "rgb_manip", "last_actions", "actions", "time_ids", "an_object_is_in_hand")


@dataclasses.dataclass
class BCTrainState:
    tower_params: Dict[str, torch.nn.Parameter]  # the policy's tower parameters (live)
    # {"vit": ..., "t5": ...}: the frozen encoders' state dicts (live)
    frozen_params: Dict[str, Dict[str, torch.Tensor]]
    opt_state: AdamState
    step: int
    epoch: int


def cross_entropy_ignore_index(logits, targets, ignore_index: int = -1):
    """Mean CE over non-ignored positions (reference nn.CrossEntropyLoss(ignore_index=-1))."""
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe_targets[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)


def _masked_means(mesh: Optional[Mesh], logits, targets, ignore_index: int = -1):
    """The masked loss and accuracy over every rank's rows (this device's
    without a mesh): (this rank's loss, whose rank-mean gradient is the
    global loss's gradient; the global loss; the global accuracy; preds;
    valid). One all-reduce of (sum of nll, valid count, correct count); each
    sum is counted mdl times over the ranks, the ratios are not."""
    valid = targets != ignore_index
    safe_targets = torch.where(valid, targets, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll_sum = torch.sum(-torch.gather(logp, -1, safe_targets[..., None])[..., 0] * valid)
    preds = torch.argmax(logits.detach(), dim=-1)
    sums = torch.stack([nll_sum.detach(), valid.sum().float(), ((preds == targets) * valid).sum().float()])
    sums = all_reduce_sum(mesh, sums)
    count = torch.clamp(sums[1], min=1)
    return nll_sum * world_size(mesh) / count, sums[0] / count, sums[2] / count, preds, valid


class OfflineTrainer:
    """BC on one device (`device="cuda"` by default; "cpu" runs the kernels'
    plain versions). The policy is built from a generator seeded with
    cfg.train.seed, with cfg.model as given (the CLI sets num_towers=1)."""

    def __init__(self, cfg: Config, mesh: Optional[Mesh] = None, device="cuda"):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.policy = SafeVLAPolicy(
            cfg.model, device=self.device, generator=torch.Generator().manual_seed(cfg.train.seed)
        )
        self.policy.vit.requires_grad_(False)
        self.policy.t5.requires_grad_(False)
        self.tokenizer = InstructionTokenizer(cfg.model.text_backbone, cfg.model.text_max_tokens)
        self.lr = cfg.offline.lr
        self._aug_gen = torch.Generator().manual_seed(7)
        means, stds = rgb_norm_constants(cfg.model.vision_backbone)
        self._means = torch.tensor(means, dtype=torch.float32, device=self.device)
        self._stds = torch.tensor(stds, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None) -> BCTrainState:
        """A train state over the policy's tower weights (refilled from
        `generator` first when one is given), fresh AdamW moments, step and
        epoch 0; on a mesh, rank 0's weights and moments on every rank."""
        if generator is not None:
            self.policy.init_params(generator)
        self.policy.towers.requires_grad_(True)
        params = dict(self.policy.towers.named_parameters())
        opt_state = adamw_init(list(params.values()))
        if self.mesh is not None:
            frozen = [*self.policy.vit.state_dict().values(), *self.policy.t5.state_dict().values()]
            self.mesh.replicate(list(params.values()) + opt_state.mu + opt_state.nu, frozen)
        return BCTrainState(
            tower_params=params,
            frozen_params={"vit": self.policy.vit.state_dict(), "t5": self.policy.t5.state_dict()},
            opt_state=opt_state,
            step=0,
            epoch=0,
        )

    # ------------------------------------------------------------------
    def restore_state(
        self,
        ckpt_dir: str,
        restart_optimizer: Optional[bool] = None,
    ) -> Optional[BCTrainState]:
        """Resume from the latest checkpoint in `ckpt_dir`, or None if empty.

        With `restart_optimizer` (default from cfg.offline.restart_optimizer)
        only the model weights are taken from the checkpoint; the AdamW state
        is freshly initialized (the reference's optimizer whose
        load_state_dict is a no-op, train_pl.py:74-80)."""
        step_dir = latest_checkpoint(ckpt_dir)
        if step_dir is None:
            return None
        restored = restore_checkpoint(step_dir, self.init_state())
        if restart_optimizer is None:
            restart_optimizer = self.cfg.offline.restart_optimizer
        if restart_optimizer:
            restored = dataclasses.replace(
                restored, opt_state=adamw_init(list(restored.tower_params.values()))
            )
        return restored

    # ------------------------------------------------------------------
    def sample_prediction_rows(self, host_batch, preds, out_dir: str, max_rows: int = 10):
        """Per-sample (task, video, gt actions, predicted actions) rows for a
        wandb table (reference train_pl.py:107-142 log_videos)."""
        from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS
        from safevla_tpu_torch.utils.video import save_video

        def names(idxs, valid):
            return [
                ALL_STRETCH_ACTIONS[i] if 0 <= i < len(ALL_STRETCH_ACTIONS) else str(i)
                for i, v in zip(idxs, valid)
                if v
            ]

        rows = []
        for b in range(min(max_rows, len(host_batch["instructions"]))):
            valid = host_batch["actions"][b] != -1
            frames = np.concatenate(
                [host_batch["rgb_nav"][b][valid], host_batch["rgb_manip"][b][valid]], axis=2
            )
            path = save_video(list(frames), os.path.join(out_dir, "samples", f"sample_{b}.mp4"))
            rows.append(
                [
                    host_batch["instructions"][b],
                    path,
                    names(host_batch["actions"][b], valid),
                    names(preds[b], valid),
                ]
            )
        return rows

    # ------------------------------------------------------------------
    def _forward(self, batch, aug):
        return self._tower_logits(batch, self._vision(batch, aug))

    def _vision(self, batch, aug):
        """Both cameras' uint8 frames -> augmented, normalised -> the frozen
        ViT's features (2B, T, ...), outside autograd (span `step.vision`)."""
        b, t = batch["rgb_nav"].shape[:2]
        with span("step.vision"), torch.no_grad():  # nothing of the frozen ViT is kept for autograd
            imgs = torch.cat([batch["rgb_nav"], batch["rgb_manip"]], dim=0)
            imgs = imgs.reshape((-1,) + imgs.shape[2:])
            x01 = apply_augment(imgs.float() / 255.0, aug)
            feats = self.policy.encode_images((x01 - self._means) / self._stds)
            del imgs, x01
        return feats.reshape((2 * b, t) + feats.shape[1:])

    def _tower_logits(self, batch, feats):
        """The tower's forward_seq over the ViT's features -> logits (B, T, A)."""
        b, t = batch["rgb_nav"].shape[:2]
        out = self.policy.forward_seq(
            feats[:b],
            feats[b:],
            batch["text_hidden"],
            batch["text_mask"],
            batch["last_actions"],
            # not_reset gates the prev-action null token; the BC windows carry
            # explicit start tokens in last_actions, so keep the gate open
            torch.ones((b, t), dtype=torch.int32, device=self.device),
            batch["an_object_is_in_hand"],
            batch["time_ids"],
            # one episode per row: plain causal mask via constant traj index
            torch.zeros((b, t), dtype=torch.int32, device=self.device),
        )
        return out.logits

    def _bc_loss(self, batch, aug):
        feats = self._vision(batch, aug)
        with span("step.forward"):
            logits = self._tower_logits(batch, feats)
            loss, bc_loss, acc, _, _ = _masked_means(self.mesh, logits, batch["actions"])
        return loss, {"bc_loss": bc_loss, "accuracy": acc}

    def _bc_step(self, state: BCTrainState, batch, aug):
        """One BC step -> (the new state, metrics as 0-d device tensors). The
        tower weights and the AdamW moments are updated in place. The step is
        the span `step`; its parts `step.vision`, `step.forward`,
        `step.backward` and `step.optimizer`."""
        with span("step"):
            params = list(state.tower_params.values())
            loss, metrics = self._bc_loss(batch, aug)
            with span("step.backward"):
                # a leaf the loss does not reach (the critic head) gets no gradient:
                # optax still counts and decays it (adamw_step takes None as zeros)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                all_reduce_mean_(self.mesh, [g for g in grads if g is not None])  # the same leaves on every rank
            with span("step.optimizer"):
                with torch.no_grad():
                    metrics["grad_norm"] = global_norm([g for g in grads if g is not None])
                opt_state = adamw_step(params, grads, state.opt_state, self.lr)
            return dataclasses.replace(state, opt_state=opt_state, step=state.step + 1), metrics

    @torch.no_grad()
    def _eval_step(self, state: BCTrainState, batch):
        logits = self._forward(batch, identity_augment_params())
        _, loss, acc, preds, valid = _masked_means(self.mesh, logits, batch["actions"])
        return {"val_loss": loss, "val_accuracy": acc, "preds": preds, "valid": valid}

    # ------------------------------------------------------------------
    def host_prepare(self, host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Host side of batch prep (thread-safe: it reads no train state):
        tokenize, and the batch's arrays as CPU tensors, in pinned memory
        when the trainer runs on the card (so their uploads can be
        asynchronous). The span `data.prepare`."""
        with span("data.prepare"):
            tokens, mask = self.tokenizer.encode_batch(host_batch["instructions"])
            arrays = {k: host_batch[k] for k in _BATCH_KEYS}
            arrays["_text_tokens"], arrays["text_mask"] = tokens, mask
            pin = self.device.type == "cuda"
            out = {}
            for k, a in arrays.items():
                t = torch.from_numpy(np.ascontiguousarray(a))
                out[k] = t.pin_memory() if pin else t
            return out

    @torch.no_grad()
    def attach_text(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Upload a `host_prepare` batch (non-blocking copies on the current
        stream: the step that reads them is queued after them) and encode
        its instructions with the frozen T5 (span `step.text`)."""
        with span("step.text"):
            out = {k: v.to(self.device, non_blocking=True) for k, v in batch.items()}
            tokens = out.pop("_text_tokens")
            out["text_hidden"] = self.policy.encode_text(tokens, out["text_mask"])
            return out

    def prepare_batch(self, host_batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Tokenize, upload and encode the instructions of one host batch."""
        return self.attach_text(self.host_prepare(host_batch))

    def prepared_batches(self, host_batches: Iterable[Dict[str, Any]]):
        """Iterate host-prepared batches with IO overlapped: a daemon thread
        decodes / collates / tokenizes / pins up to
        `cfg.offline.prefetch_batches` ahead while the device trains on the
        current batch (the step's kernels are queued asynchronously, so the
        thread owns the host between steps). Yields `host_prepare` output;
        the consumer finishes with `attach_text`. Synchronous prep when
        prefetch_batches == 0."""
        depth = int(self.cfg.offline.prefetch_batches)
        if depth <= 0:
            for hb in host_batches:
                yield self.host_prepare(hb)
            return
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=depth)
        sentinel = object()
        errs: list = []
        stop = threading.Event()  # set when the consumer abandons the generator

        def _put(item) -> bool:
            # bounded put that re-checks the stop flag, so the thread exits
            # (and its pinned batches free) when the consumer stops early
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for hb in host_batches:
                    if stop.is_set() or not _put(self.host_prepare(hb)):
                        return
            except BaseException as e:  # surface decode errors on the consumer
                errs.append(e)
            finally:
                _put(sentinel)

        threading.Thread(target=worker, daemon=True, name="bc-batch-prep").start()
        try:
            while True:
                with span("data.wait"):
                    item = q.get()
                if item is sentinel:
                    if errs:
                        raise errs[0]
                    return
                yield item
        finally:
            stop.set()
            # drain whatever the worker already queued so its buffers free
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def per_action_f1(self, preds: np.ndarray, targets: np.ndarray) -> Dict[str, float]:
        """Macro/per-action F1 (reference train_pl.py F1 metrics)."""
        from safevla_tpu_torch.constants import ALL_STRETCH_ACTIONS

        out = {}
        f1s = []
        for a, name in enumerate(ALL_STRETCH_ACTIONS):
            tp = np.sum((preds == a) & (targets == a))
            fp = np.sum((preds == a) & (targets != a) & (targets != -1))
            fn = np.sum((preds != a) & (targets == a))
            denom = 2 * tp + fp + fn
            f1 = 2 * tp / denom if denom > 0 else 0.0
            out[f"f1/{name}"] = float(f1)
            if (targets == a).any():
                f1s.append(f1)
        out["f1/macro"] = float(np.mean(f1s)) if f1s else 0.0
        return out

    # ------------------------------------------------------------------
    def fit(
        self,
        train_batches: Callable[[], Iterable[Dict[str, Any]]],
        val_batches: Optional[Callable[[], Iterable[Dict[str, Any]]]] = None,
        num_epochs: Optional[int] = None,
        state: Optional[BCTrainState] = None,
        log_fn: Optional[Callable[[Dict[str, Any], int], None]] = None,
        curriculum_fn: Optional[Callable[[int], None]] = None,
        output_dir: Optional[str] = None,
        logger=None,
    ) -> BCTrainState:
        cfg = self.cfg
        out_dir = output_dir or os.path.join(cfg.train.output_dir, "offline")
        if state is None:
            state = self.restore_state(out_dir)
            if state is not None:
                print(f"[bc] resumed from {out_dir} @ epoch {state.epoch}", flush=True)
        state = state if state is not None else self.init_state()
        log_fn = log_fn or (lambda m, s: print(f"[bc {s}] {m}", flush=True))
        num_epochs = num_epochs or cfg.offline.num_epochs

        for epoch in range(state.epoch, num_epochs):
            if curriculum_fn:
                curriculum_fn(epoch)
            t0 = time.time()
            n = 0
            aug = (
                sample_augment_params(self._aug_gen, version=cfg.train.augmentation_version)
                if cfg.train.use_data_augmentation
                else identity_augment_params()
            )
            metrics: Dict[str, torch.Tensor] = {}
            for pb in self.prepared_batches(map(self._rank_rows, train_batches())):
                state, metrics = self._bc_step(state, self.attach_text(pb), aug)
                n += 1
            log = {k: float(v) for k, v in metrics.items()}  # the epoch's one device read
            log["epoch_seconds"] = time.time() - t0
            log["batches"] = n

            if val_batches is not None:
                preds_all, targets_all, losses = [], [], []
                sample_rows = None
                for host_batch in map(self._rank_rows, val_batches()):
                    ev = self._eval_step(state, self.prepare_batch(host_batch))
                    preds_all.append(ev["preds"].cpu().numpy())
                    targets_all.append(np.asarray(host_batch["actions"]))
                    losses.append(float(ev["val_loss"]))
                    if sample_rows is None and logger is not None and is_primary_host():
                        sample_rows = self.sample_prediction_rows(host_batch, preds_all[-1], out_dir)
                if self.mesh is not None:  # every dp shard's rows, once each
                    parts = self.mesh.gather_objects((preds_all, targets_all))[:: self.mesh.mdl]
                    preds_all = [p for part, _ in parts for p in part]
                    targets_all = [t for _, part in parts for t in part]
                if losses:
                    preds = np.concatenate([p.ravel() for p in preds_all])
                    targets = np.concatenate([t.ravel() for t in targets_all])
                    log["val_loss"] = float(np.mean(losses))
                    log.update(self.per_action_f1(preds, targets))
                if sample_rows and hasattr(logger, "log_table"):
                    logger.log_table(
                        f"video_action_table/val/{state.step}",
                        ["Task", "Video", "Actions_gt", "Actions_pred"],
                        sample_rows,
                        state.step,
                    )

            state = dataclasses.replace(state, epoch=state.epoch + 1)
            if is_primary_host():
                log_fn(log, state.step)
            save_checkpoint(out_dir, state, state.step)  # the primary rank's alone
            if self.mesh is not None:
                self.mesh.barrier()
        return state

    def _rank_rows(self, host_batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of a host batch (every value is per row); the
        whole batch without a mesh."""
        if self.mesh is None:
            return host_batch
        rows = self.mesh.rows(len(host_batch["instructions"]))
        return {k: v[rows] for k, v in host_batch.items()}
