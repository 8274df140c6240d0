"""The port's config tree, `mava_tpu_torch/configs/`, is the JAX package's,
`mava_tpu/configs/`: the same relative paths, each pair parsing to the same
object, and the port's `load_config` composing every default config and every
(env, scenario) pair to the dict that the JAX loader composes, each over its
own tree. `load_config(config_dir=...)` reads the tree it is given."""

from pathlib import Path

import pytest
import yaml

from mava_tpu.utils.config import load_config as jax_load_config
from mava_tpu_torch.utils.config import CONFIG_DIR, load_config
from test_config_matrix import _env_for

ROOT = Path(__file__).resolve().parent.parent
JAX_TREE, PORT_TREE = ROOT / "mava_tpu" / "configs", ROOT / "mava_tpu_torch" / "configs"


def yaml_paths(tree: Path):
    return sorted(p.relative_to(tree).as_posix() for p in tree.rglob("*.yaml"))


DEFAULTS = sorted(p.stem for p in JAX_TREE.glob("default_*.yaml"))
SCENARIOS = sorted(p.stem for p in (JAX_TREE / "env" / "scenario").glob("*.yaml"))


def test_the_port_reads_its_own_tree():
    assert CONFIG_DIR == PORT_TREE
    assert yaml_paths(PORT_TREE) == yaml_paths(JAX_TREE)
    assert len(DEFAULTS) == 7 and len(SCENARIOS) > 40


@pytest.mark.parametrize("path", sorted(set(yaml_paths(JAX_TREE)) | set(yaml_paths(PORT_TREE))))
def test_each_file_parses_to_the_same_object(path):
    assert (JAX_TREE / path).is_file() and (PORT_TREE / path).is_file(), path
    assert yaml.safe_load((PORT_TREE / path).read_text()) == \
        yaml.safe_load((JAX_TREE / path).read_text())


@pytest.mark.parametrize("default", DEFAULTS)
def test_every_default_composes_as_the_jax_loader(default):
    assert load_config(default).to_dict() == jax_load_config(default).to_dict()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_every_scenario_composes_as_the_jax_loader(scenario):
    overrides = [f"env={_env_for(scenario)}", f"env/scenario={scenario}"]
    assert load_config("default_ff_ippo", overrides).to_dict() == \
        jax_load_config("default_ff_ippo", overrides).to_dict()


def test_config_dir_reads_the_given_tree(tmp_path):
    (tmp_path / "arch").mkdir()
    (tmp_path / "arch" / "small.yaml").write_text("num_envs: 3\nseed: 1\n")
    (tmp_path / "default_mine.yaml").write_text(
        "defaults:\n  arch: small\nsystem:\n  lr: 1e-3\n")
    cfg = load_config("default_mine", ["arch.seed=5"], config_dir=tmp_path)
    assert cfg.to_dict() == {"arch": {"num_envs": 3, "seed": 5}, "system": {"lr": 1e-3}}
    with pytest.raises(FileNotFoundError):
        load_config("default_ff_ippo", config_dir=tmp_path)
