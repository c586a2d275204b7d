"""Publish a training checkpoint of the port as a lean, content-addressed
artifact: the port of the JAX package's ``tools/publish_model.py``
(reference ``tools/publish_model.py``: strip the optimizer state and stamp
the output name with the first 8 hex digits of a content hash)::

    python -m vss_cffm_tpu_torch.tools.publish_model work_dirs/cffm_b1/ckpt published/cffm_b1 \\
        [--step N]

The input is a ``CheckpointManager`` directory written by the train CLI
(``ckpt_<step>.pt`` with the model's, the optimizer's and the scheduler's
state); the output is the directory ``<out>-<sha8>`` holding the model's
``state_dict`` alone as step 0 (``ckpt_0.pt``) with the CLASSES / PALETTE /
config metadata carried over (``metadata_0.json``), which
``apis.init_segmentor(cfg, checkpoint=...)`` and the test CLI read as they
read the source. The hash is a sha256 over the state dict in sorted key
order (each key, dtype, shape and the tensor's bytes). A file operation on
the host: it loads the checkpoint onto the CPU and touches no device, so it
takes no ``--device``.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil

import torch

from ..train import CheckpointManager

__all__ = ["content_hash", "publish", "main"]


def content_hash(state_dict: dict) -> str:
    """sha256 hex digest over the tensors in sorted key order."""
    h = hashlib.sha256()
    for key in sorted(state_dict):
        t = state_dict[key].detach().cpu().contiguous()
        h.update(key.encode())
        h.update(str(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def publish(in_dir: str, out_dir: str, step: int | None = None) -> str:
    """Write the published directory of ``in_dir``'s checkpoint at ``step``
    (the latest by default); returns its path."""
    src = CheckpointManager(in_dir)
    step = step if step is not None else src.latest_step()
    if step is None:
        raise SystemExit(f"no checkpoints in {in_dir}")
    lean = src.read(step)["model"]
    out = os.path.abspath(out_dir.rstrip("/")) + f"-{content_hash(lean)[:8]}"
    if os.path.exists(out):
        shutil.rmtree(out)
    CheckpointManager(out, max_to_keep=1).save_weights(lean, 0, src.metadata(step))
    return out


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(description="Process a checkpoint to be published")
    ap.add_argument("in_dir", help="input CheckpointManager directory")
    ap.add_argument("out_dir", help="output checkpoint directory (sha8 appended)")
    ap.add_argument("--step", type=int, default=None, help="step to publish (default: latest)")
    args = ap.parse_args(argv)
    out = publish(args.in_dir, args.out_dir, args.step)
    print(out)
    return out


if __name__ == "__main__":
    main()
