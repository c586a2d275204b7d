"""A benchmark root of tiny cells for the harness tests: a copy of
``BENCHMARK.json``'s structure with one tiny configuration and its cells."""

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

TRAIN = {"clips": 2, "frames": 4, "crop": [64, 64], "ignore_share": 0.05, "pool": 3,
         "start_iter": 16000, "warmup_steps": 1, "traced_steps": 1, "ref_remat": False}
# limits of the tiny cell, set as the real cells' are, at this size on the
# CPU: between the program's largest reading over six seeds (loss 1.6e-6,
# median leaf 0.0032, worst change 0.077) and the fp8 control's smallest over
# three (1.2e-5, 0.0110, 0.121), for the change the state left unchanged (1.0)
TRAIN_LIMITS = {"loss_rel": 6e-6, "grad_median_rel": 0.0065, "delta_leaf_rel": 0.35}


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "portbench", "configs", "cffm_b1.json")) as f:
        cfg = json.load(f)
    cfg.update(port_config="portbench.tests.tiny_port_config", embed_dims=[8, 16, 24, 32],
               depths=[1, 1, 2, 1], num_heads=[1, 2, 3, 4], embed_dim=16, num_classes=16,
               decoder=dict(cfg["decoder"], dim=16, depth=1, num_heads=2),
               crop_size=[64, 64], img_scale=[96, 64], samples_per_gpu=2)
    return cfg


def make_root(tmp: str) -> str:
    """A checkout-like directory: ``portbench/`` copied, the tiny
    configuration, traffic and cell added, a BENCHMARK.json naming them."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = os.path.join(root, "portbench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    with open(os.path.join(pb, "traffic", "tiny_train.json"), "w") as f:
        json.dump({"driver": "train", "params": TRAIN}, f)
    with open(os.path.join(pb, "workloads", "tiny.train.json"), "w") as f:
        json.dump({"limits": TRAIN_LIMITS}, f)
    bench["workloads"].append({"name": "tiny.train", "config": "tiny", "traffic": "tiny_train",
                               "chips": 1, "why": "harness test"})
    bench["configs"].append({"name": "tiny", "source": "test", "reduced": [],
                             "file": "portbench/configs/tiny.json", "why": "harness test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cffm_b1.train_g8" in m.get("workloads", []):
            m["workloads"].append("tiny.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root
