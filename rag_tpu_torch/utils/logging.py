"""Structured metric logging: a JSONL event stream.

Counterpart of rag_tpu/utils/logging.py::MetricWriter. Each record is one
line of ``events.jsonl``: {"ts", "tag", "step", "values"} for scalars or
{"ts", "tag", "step", "text"} for text, the same records rag_tpu writes.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, log_dir: Optional[str] = None, echo: bool = False):
        self.echo = echo
        self.fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.fh = open(os.path.join(log_dir, "events.jsonl"), "a")

    def _write(self, rec: Dict) -> None:
        if self.fh:
            self.fh.write(json.dumps(rec) + "\n")
            self.fh.flush()

    def scalars(self, tag: str, values: Dict[str, float], step: int = 0):
        rec = {"ts": time.time(), "tag": tag, "step": step,
               "values": {k: float(v) for k, v in values.items()}}
        self._write(rec)
        if self.echo:
            print(f"{tag}[{step}]: {rec['values']}")

    def text(self, tag: str, value: str, step: int = 0):
        self._write({"ts": time.time(), "tag": tag, "step": step,
                     "text": value})
        if self.echo:
            print(f"{tag}[{step}]: {value}")

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None
