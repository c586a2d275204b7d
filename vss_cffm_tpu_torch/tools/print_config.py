"""Print the fully resolved experiment config as JSON (the port's copy of
``tools/print_config.py``, reference ``tools/print_config.py``)::

    python -m vss_cffm_tpu_torch.tools.print_config CONFIG [--options k=v ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from ..config import apply_overrides, load_config

__all__ = ["to_dict", "main"]


def to_dict(cfg):
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Print the resolved experiment config.")
    ap.add_argument("config")
    ap.add_argument("--options", nargs="*", default=[])
    args = ap.parse_args(argv)
    cfg = apply_overrides(load_config(args.config), args.options)
    print(json.dumps(to_dict(cfg), indent=2))


if __name__ == "__main__":
    main()
