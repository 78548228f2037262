"""The metrics log.

Port of ``image_search_engine_for_historical_research_tpu/utils/profiling.py``'s
``MetricsLogger``, the append-only jsonl log the trainer writes its epochs
to. The JAX module's ``Timer``, ``block`` and ``device_trace`` have no
caller in the port (``chip_smoke.py`` times with CUDA events and traces with
``torch.profiler`` directly) and are not copied.
"""

from __future__ import annotations

import json
import os
import time
from typing import List


class MetricsLogger:
    """Append-only jsonl metrics log (the reference's tensorboard
    SummaryWriter, ``main_train.py:438-456``): one ``{"step", "time", ...}``
    record a line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=float) + "\n")

    def read(self) -> List[dict]:
        out = []
        try:
            with open(self.path) as f:
                for line in f:
                    out.append(json.loads(line))
        except FileNotFoundError:
            pass
        return out
