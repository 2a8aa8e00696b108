"""Copy of `safevla_tpu/utils/wandb_logging.py`.

Weights & Biases logging with resumable run ids.

Counterpart of reference utils/wandb_logging.py (SimpleWandbLogging):
train/valid/test metric streams with per-metric step keys and a run id
persisted to disk so crashed runs resume into the same wandb run. All wandb
usage is gated: without the package (or offline), logging degrades to jsonl
files in the output dir.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class WandbLogger:
    def __init__(
        self,
        project: str = "",
        entity: str = "",
        name: Optional[str] = None,
        output_dir: str = "output",
        config: Optional[Dict[str, Any]] = None,
    ):
        self.project = project
        self.entity = entity
        self.name = name
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._run = None
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        if project:
            try:  # pragma: no cover - needs wandb + network
                import wandb

                run_id = self._load_or_create_run_id()
                self._run = wandb.init(
                    project=project,
                    entity=entity or None,
                    name=name,
                    id=run_id,
                    resume="allow",
                    config=config or {},
                )
            except Exception as e:
                print(f"wandb unavailable ({e}); falling back to jsonl logging")

    def _run_id_path(self) -> str:
        return os.path.join(self.output_dir, "wandb_run_id.txt")

    def _load_or_create_run_id(self) -> str:
        """Persisted run id -> crash recovery resumes the same wandb run
        (reference wandb_logging.py:26-53)."""
        path = self._run_id_path()
        if os.path.exists(path):
            with open(path) as f:
                return f.read().strip()
        import secrets

        run_id = secrets.token_hex(8)
        with open(path, "w") as f:
            f.write(run_id)
        return run_id

    def log(self, metrics: Dict[str, Any], step: int, prefix: str = "train"):
        payload = {f"{prefix}/{k}": v for k, v in metrics.items()}
        payload["step"] = step
        payload["_ts"] = time.time()
        self._jsonl.write(json.dumps(payload, default=float) + "\n")
        self._jsonl.flush()
        if self._run is not None:
            self._run.log(payload, step=step)

    def log_table(self, name: str, columns, rows, step: int):
        if self._run is not None:  # pragma: no cover
            import wandb

            self._run.log({name: wandb.Table(columns=columns, data=rows)}, step=step)
        else:
            self._jsonl.write(
                json.dumps({"table": name, "columns": columns, "rows": rows, "step": step},
                           default=float) + "\n"
            )
            self._jsonl.flush()

    def finish(self):
        self._jsonl.close()
        if self._run is not None:
            self._run.finish()
