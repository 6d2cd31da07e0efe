"""Checkpointing: atomic step snapshots, async save, restart (the port of
the JAX package's ``train/checkpoint.py``).

Layout:  <dir>/step_<n>/
            manifest.json          flat-key -> {file, shape, dtype}
            arrays/<i>.npy         one file per leaf (copied to the host)
            .complete              commit marker (atomic rename-last)

Fault-tolerance contract:
  * saves are crash-safe: a snapshot without ``.complete`` is ignored by
    ``latest_step`` (a died writer never corrupts restart);
  * ``save_async`` copies every tensor to the host before it returns and
    writes on a worker thread: training, whose optimizer updates the
    parameters in place, goes on during the write;
  * ``restore`` puts every leaf on the device the caller names (the
    reference's ``shardings``, for one card);
  * data-pipeline state (step, shard cursor, rng) rides in the same manifest.

The layout and keys are the reference's, so a float32 checkpoint written
by either package restores in the other.  The reference's fault, not
copied (ROADMAP C.11): it writes a bfloat16 leaf through ``np.save`` as
raw ``|V2`` bytes that its ``restore`` cannot turn back into an array.
Here a bfloat16 leaf is written as its 16 bits (``<u2``) with ``"dtype":
"bfloat16"`` in the manifest and restored as bfloat16; a reference
bfloat16 leaf (``|V2``, the same bits) restores too.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np
import torch

from ..core.queries_torch import resolve_device

_BF16 = "bfloat16"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}#/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix_keys(node):
        if isinstance(node, dict):
            out = {}
            lst = node and all(k.endswith("#") for k in node)
            if lst:
                return [
                    fix_keys(node[k])
                    for k in sorted(node, key=lambda s: int(s[:-1]))
                ]
            for k, v in node.items():
                out[k] = fix_keys(v)
            return out
        return node

    return fix_keys(root)


def _to_host(v) -> tuple[np.ndarray, str]:
    """A host copy of a leaf (never a view of a tensor that may change)
    and its manifest dtype."""
    if isinstance(v, torch.Tensor):
        t = v.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    a = np.array(v)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == _BF16:                  # our <u2 bits, or the reference's |V2 bytes
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- discovery ---------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / ".complete").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: dict | None = None) -> None:
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self._write(step, host, extra or {})

    def save_async(self, step: int, tree, extra: dict | None = None) -> None:
        """Copies every leaf to the host now, writes on a worker thread."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self._thread = threading.Thread(
            target=self._write, args=(step, host, extra or {}), daemon=True
        )
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict, extra: dict) -> None:
        path = self.dir / f"step_{step}"
        tmp = self.dir / f".tmp_step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for i, (key, (arr, dtype)) in enumerate(host.items()):
            np.save(tmp / "arrays" / f"{i}.npy", arr)
            manifest["leaves"][key] = {
                "file": f"arrays/{i}.npy",
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if path.exists():
            shutil.rmtree(path)
        tmp.rename(path)
        (path / ".complete").touch()  # commit marker
        self._gc()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int | None = None, device=None):
        """Returns ``(tree, extra)`` of ``step`` (the latest complete one
        unless given), or ``(None, None)`` if there is none; every leaf a
        tensor on ``device`` (the card unless named) in its saved dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        device = resolve_device(device)
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat = {}
        for key, meta in manifest["leaves"].items():
            flat[key] = _from_host(np.load(path / meta["file"]), meta["dtype"], device)
        return _unflatten(flat), manifest["extra"]
