"""Metrics logging: JSONL always, wandb opt-in.

Copy of `flash_attention_tpu/training/metrics.py` (plain Python): metrics
go to a JSONL file (and stdout via the trainer), and to wandb when
requested and importable, never as a hard dependency.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Any


class MetricsLogger:
    def __init__(
        self,
        out_dir: str | None = None,
        *,
        wandb_log: bool = False,
        wandb_project: str = "flash-attention-tpu",
        run_name: str | None = None,
        config: dict | None = None,
    ):
        self._file = None
        if out_dir is not None:
            path = pathlib.Path(out_dir)
            path.mkdir(parents=True, exist_ok=True)
            self._file = (path / "metrics.jsonl").open("a")
        self._wandb = None
        if wandb_log:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(
                    project=wandb_project, name=run_name, config=config or {}
                )
            except ImportError:
                import logging

                logging.getLogger(__name__).warning(
                    "wandb_log=True but wandb is not installed; JSONL only"
                )

    def log(self, record: dict[str, Any]) -> None:
        record = {"ts": time.time(), **record}
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb is not None:
            self._wandb.log(record)

    def summary(self, record: dict[str, Any]) -> None:
        """Final summary (the reference writes exceptions/final losses to
        wandb.summary, demo/train.py:275-279)."""
        if self._wandb is not None:
            for k, v in record.items():
                self._wandb.summary[k] = v
        self.log({"summary": record})

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
