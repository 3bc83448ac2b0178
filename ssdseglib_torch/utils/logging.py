"""Structured training logs (copy of ssdseglib_tpu/utils/logging.py, standard
library only).

The reference has no structured logging or experiment tracking (SURVEY.md
§5: metrics only surface through Keras `fit` console output).  Here every
epoch's metrics stream to a JSONL file that downstream tooling (plots,
dashboards, regression checks) can consume, alongside the console line.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics log with wall-clock stamps."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._fh = open(path, "a")
        self._t0 = time.time()

    def log(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        entry = {"time": round(time.time(), 3),
                 "elapsed_s": round(time.time() - self._t0, 3)}
        if step is not None:
            entry["step"] = int(step)
        entry.update(
            {k: (float(v) if hasattr(v, "__float__") else v)
             for k, v in record.items()}
        )
        self._fh.write(json.dumps(entry) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
