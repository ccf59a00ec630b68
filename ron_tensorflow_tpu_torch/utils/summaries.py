"""Scalar metrics logging: a JSONL stream.

A copy of `ron_tensorflow_tpu/utils/summaries.py` (ref: ron_net.py:331-372).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, directory: str, filename: str = "metrics.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, filename)
        self._f = open(self._path, "a", buffering=1)

    def write(self, step: int, metrics: Dict[str, float], prefix: Optional[str] = None):
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}/{k}" if prefix else k
            try:
                row[key] = float(v)
            except (TypeError, ValueError):
                row[key] = str(v)
        self._f.write(json.dumps(row) + "\n")

    def close(self):
        self._f.close()
