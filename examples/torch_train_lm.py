"""End-to-end training on the PyTorch port: train a ~100M-param qwen3-family
model for a few hundred steps on the FMBI-sharded synthetic pipeline, with
checkpointing, on the card (``--device cpu`` runs it on the host).

    PYTHONPATH=src python examples/torch_train_lm.py            # ~100M, 200 steps
    PYTHONPATH=src python examples/torch_train_lm.py --tiny     # seconds-scale demo

Checkpoints go under the system's temporary directory (``TMPDIR``); a
second run resumes from the latest one.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.launch import train as train_mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args()

    tmp = tempfile.gettempdir()
    if args.tiny:
        argv = [
            "--arch", "qwen3-0.6b", "--steps", str(args.steps or 30),
            "--batch", "8", "--seq", "128", "--reduced",
            "--ckpt-dir", os.path.join(tmp, "repro_torch_train_lm_tiny"), "--lr", "1e-3",
        ]
    else:
        # ~100M params: qwen3 wiring at d_model=768, 12 layers
        cfg = get_config("qwen3-0.6b")
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab=32768, dtype="float32",
            chunk_q=256,
        )
        total, _ = cfg.params_count()
        print(f"training {cfg.name}-100m: {total/1e6:.0f}M params")
        from repro_torch.configs import base as cfg_base

        cfg_base.register(dataclasses.replace(cfg, name="qwen3-100m"))
        argv = [
            "--arch", "qwen3-100m", "--steps", str(args.steps or 200),
            "--batch", "4", "--seq", "512",
            "--ckpt-dir", os.path.join(tmp, "repro_torch_train_lm_100m"), "--lr", "3e-4",
            "--micro", "2",
        ]
    if args.device:
        argv += ["--device", args.device]
    losses = train_mod.main(argv)
    if losses and losses[-1] < losses[0]:
        print("training signal confirmed: loss decreased")
    return 0


if __name__ == "__main__":
    sys.exit(main())
