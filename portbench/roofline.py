"""A kernel's share of its roofline from the frozen byte model
(``bytemodel.py``), the table of peaks (``peaks.json``) and the kernel's
device time in the trace."""
from __future__ import annotations

import json
import pathlib

from . import trace

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent / "peaks.json").read_text())


def share(run, model: str, kernel: str):
    if run.trace is None or not run.kernel_bytes or model not in run.kernel_bytes:
        return None
    peak = PEAKS.get(run.device_kind)
    seconds = trace.op_seconds(run.trace, kernel)
    if peak is None or seconds <= 0:
        return None
    return 100.0 * run.kernel_bytes[model] / peak["hbm_bytes_per_s"] / seconds
