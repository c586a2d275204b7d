"""PyTorch port, the experiment configs against the JAX package's:

- each of the thirteen configs the port copies (``cffm_b{0,1,2,5}_vspw_160k``,
  ``cffm_b{0,1,2,5}_vspw_gene_prototype``, ``cffm_b{0,1,2,5}_vspw_finetune_40k``,
  ``segformer_b0_image``)
  loaded by the JAX ``load_config``
  and by the port's in one process, in both orders, and compared field by
  field: every field the port's dataclasses have, the model's included
  (``SegmentorConfig``, the MiT config it derives, the head, the decoder,
  the loss), with the JAX-only fields listed by name below;
- ``apply_overrides`` on every port config, against the JAX one;
- ``load_config`` of a user's config that imports a sibling file by its bare
  name; ``tools/print_config``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import pytest

from vss_cffm_tpu.config import apply_overrides as jax_apply_overrides
from vss_cffm_tpu.config import load_config as jax_load_config
from vss_cffm_tpu_torch.config import ExperimentConfig, apply_overrides, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "configs")
PORT_DIR = os.path.join(REPO, "vss_cffm_tpu_torch", "configs")
NAMES = [f"cffm_b{v}_vspw_{kind}" for kind in ("160k", "gene_prototype", "finetune_40k")
         for v in (0, 1, 2, 5)] + ["segformer_b0_image"]

# fields of the JAX dataclasses that the port does not have, and why
JAX_ONLY = {
    ("SegmentorConfig", "embed_impl"): "the im2col stage-1 embed is TPU layout tuning",
    ("MiTConfig", "embed_impl"): "the same field, as the backbone config carries it",
    ("CFFMDecoderConfig", "infer_kv_layout"): "the packed / grouped K/V layout is TPU tuning",
}


def _fresh_imports() -> None:
    """Forget the config modules, so that each case loads them anew in its order."""
    for name in list(sys.modules):
        if (name in NAMES or name == "user_config"
                or name.startswith("vss_cffm_tpu_torch.configs.")):
            del sys.modules[name]


def _compare(port, jax, path: str, jax_only: set) -> int:
    """Every field of the port's dataclass ``port`` equals the JAX one's; the
    JAX fields the port lacks are collected. Returns the fields compared."""
    if dataclasses.is_dataclass(port):
        assert dataclasses.is_dataclass(jax), path
        pf = {f.name for f in dataclasses.fields(port)}
        jf = {f.name for f in dataclasses.fields(jax)}
        assert pf <= jf, (path, pf - jf)
        jax_only.update((type(jax).__name__, n) for n in jf - pf)
        n = sum(_compare(getattr(port, f), getattr(jax, f), f"{path}.{f}", jax_only)
                for f in sorted(pf))
        if hasattr(port, "backbone_config"):
            n += _compare(port.backbone_config, jax.backbone_config, f"{path}.backbone_config",
                          jax_only)
        return n
    assert port == jax, (path, port, jax)
    assert type(port) is type(jax), (path, type(port), type(jax))
    return 1


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
@pytest.mark.parametrize("name", NAMES)
def test_port_config_equals_the_jax_config(name, order):
    _fresh_imports()
    loads = {"jax": lambda: jax_load_config(os.path.join(JAX_DIR, name + ".py")),
             "port": lambda: load_config(os.path.join(PORT_DIR, name + ".py"))}
    first = "jax" if order == "jax_first" else "port"
    got = {first: loads[first]()}
    second = "port" if first == "jax" else "jax"
    got[second] = loads[second]()
    assert isinstance(got["port"], ExperimentConfig)
    assert type(got["port"].model).__module__ == "vss_cffm_tpu_torch.config"
    jax_only: set = set()
    n = _compare(got["port"], got["jax"], name, jax_only)
    assert n > 60
    assert jax_only == set(JAX_ONLY), jax_only ^ set(JAX_ONLY)
    pm = got["port"].model
    assert pm.arch == ("image" if name.startswith("segformer") else "cffm")
    assert pm.head.mode == ("finetune" if name.endswith("finetune_40k") else "cffm")
    _fresh_imports()


OVERRIDES = ["data.batch_size=2", "optim.max_iters=4", "log_interval=1",
             "checkpoint_interval=2", "model.head.decoder.use_checkpoint=true",
             "model.train_block_impl=ffn,ffn,ffn,", "data.crop_size=64,64", "bf16=false",
             "model.head.loss.use_ohem=true", "seed=3"]


@pytest.mark.parametrize("name", NAMES)
def test_overrides_on_every_port_config(name):
    cfg = apply_overrides(load_config(os.path.join(PORT_DIR, name + ".py")), OVERRIDES)
    jcfg = jax_apply_overrides(jax_load_config(os.path.join(JAX_DIR, name + ".py")), OVERRIDES)
    assert cfg.model.head.decoder.use_checkpoint is True
    assert cfg.model.train_block_impl == ("ffn", "ffn", "ffn", None)
    assert (cfg.data.batch_size, cfg.optim.max_iters, cfg.data.crop_size) == (2, 4, (64, 64))
    assert cfg.bf16 is False and cfg.seed == 3 and cfg.model.head.loss.use_ohem is True
    _compare(cfg, jcfg, name, set())
    with pytest.raises(ValueError):  # the port refuses a short tuple (ADVICE.md)
        apply_overrides(cfg, ["model.train_block_impl=ffn,ffn"])


def test_user_config_imports_a_sibling(tmp_path):
    (tmp_path / "my_base.py").write_text(
        "from vss_cffm_tpu_torch.config import ExperimentConfig, DataConfig\n"
        "def config():\n"
        "    return ExperimentConfig(data=DataConfig(batch_size=2), work_dir='w')\n")
    (tmp_path / "my_exp.py").write_text(
        "import dataclasses\n"
        "from my_base import config as base\n"
        "def config():\n"
        "    return dataclasses.replace(base(), log_interval=7)\n")
    path_before = list(sys.path)
    try:
        cfg = load_config(str(tmp_path / "my_exp.py"))
    finally:
        sys.modules.pop("my_base", None)
    assert sys.path == path_before
    assert (cfg.data.batch_size, cfg.log_interval, cfg.work_dir) == (2, 7, "w")
    assert cfg.model.backbone == "mit_b1"
    (tmp_path / "bad.py").write_text("def config():\n    return 1\n")
    with pytest.raises(TypeError):
        load_config(str(tmp_path / "bad.py"))


def test_print_config(capsys):
    from vss_cffm_tpu_torch.tools import print_config

    print_config.main([os.path.join(PORT_DIR, "cffm_b5_vspw_gene_prototype.py"),
                       "--options", "data.batch_size=2"])
    out = json.loads(capsys.readouterr().out)
    assert out["model"]["backbone"] == "mit_b5"
    assert out["model"]["head"]["decoder"]["depth"] == 4
    assert out["proto"] == {"n_clusters": 100, "num_frames": 10, "kmeans_iters": 10}
    assert out["data"]["batch_size"] == 2
    assert out["work_dir"] == "work_dirs/cffm_b5_vspw_gene_prototype"
