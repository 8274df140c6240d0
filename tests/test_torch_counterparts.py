"""Every module of `mava_tpu/` has its counterpart in `mava_tpu_torch/`.

The port mirrors the JAX package file for file: each `.py` module of
`mava_tpu/` has a module at the same relative path in `mava_tpu_torch/`,
except where `RENAMED` says where it went (the Pallas GRU became the CUDA op
and its kernels, the JAX helpers the conversion utilities). Every program of
the JAX package (a module of `advanced_usage/` or `systems/` that defines
`main`) has a `main` in its counterpart, and no module of the port refuses a
behaviour with `NotImplementedError` except those in `ALLOWED_REFUSALS`, which
the JAX package refuses too. Read from the source files (`ast`), importing
neither package.

The port's data and the repo's tools too: every YAML file of
`mava_tpu/configs/` has its copy at the same path under
`mava_tpu_torch/configs/` (`tests/test_torch_configs.py` holds them equal),
and every root `scripts/*.py` its counterpart in `mava_tpu_torch/scripts/`
but those in `NOT_PORTED` (ROADMAP's "What is not ported": TPU tools;
`scripts/tpu_queue/` is a directory and not walked).
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX, PORT = ROOT / "mava_tpu", ROOT / "mava_tpu_torch"

# A JAX module -> the port's files that take its place.
RENAMED = {
    "ops/pallas_gru.py": ("ops/gru.py", "csrc/gru_sequence.cu"),
    "utils/jax_utils.py": ("utils/convert.py",),
}
# (port module, function) of each allowed `raise NotImplementedError`: an
# unknown network kind in the config, which the JAX package's registry refuses
# too (a KeyError there).
ALLOWED_REFUSALS = {("networks/factory.py", "_lookup")}
# Root scripts with no counterpart: the TPU queue's summary, the
# `jax.distributed` smoke over CPU processes, and the TPU A/B scripts.
NOT_PORTED = {"harvest_queue.py", "multiproc_smoke.py"}
NOT_PORTED_PREFIX = "profile_"
SCRIPTS = ROOT / "scripts"


def modules(package: Path):
    return sorted(p.relative_to(package).as_posix() for p in package.rglob("*.py")
                  if "__pycache__" not in p.parts)


def tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def defines_main(path: Path) -> bool:
    return any(isinstance(node, ast.FunctionDef) and node.name == "main"
               for node in tree(path).body)


def programs():
    """The JAX package's programs: its `advanced_usage/` and `systems/`
    modules that define `main`."""
    return [m for m in modules(JAX)
            if m.split("/")[0] in ("advanced_usage", "systems") and defines_main(JAX / m)]


def refusals(path: Path):
    """(function, line) of every `raise NotImplementedError` in a module."""
    found = []

    def walk(node, function):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                else function
            if isinstance(child, ast.Raise) and child.exc is not None:
                exc = child.exc.func if isinstance(child.exc, ast.Call) else child.exc
                if isinstance(exc, ast.Name) and exc.id == "NotImplementedError":
                    found.append((function, child.lineno))
            walk(child, name)

    walk(tree(path), None)
    return found


def test_the_packages_hold_modules():
    assert len(modules(JAX)) > 50 and len(programs()) > 10


@pytest.mark.parametrize("module", modules(JAX))
def test_every_jax_module_has_a_counterpart(module):
    for target in RENAMED.get(module, (module,)):
        assert (PORT / target).is_file(), f"mava_tpu/{module}: no mava_tpu_torch/{target}"


@pytest.mark.parametrize("program", programs())
def test_every_jax_program_has_a_main_in_the_port(program):
    assert defines_main(PORT / program), f"mava_tpu_torch/{program} defines no main()"


def root_scripts():
    return sorted(p.name for p in SCRIPTS.glob("*.py"))


@pytest.mark.parametrize("config", sorted(p.relative_to(JAX).as_posix()
                                          for p in (JAX / "configs").rglob("*.yaml")))
def test_every_jax_config_has_its_copy_in_the_port(config):
    assert (PORT / config).is_file(), f"mava_tpu/{config}: no mava_tpu_torch/{config}"


@pytest.mark.parametrize("script", root_scripts())
def test_every_root_script_has_a_counterpart(script):
    if script in NOT_PORTED or script.startswith(NOT_PORTED_PREFIX):
        assert not (PORT / "scripts" / script).exists(), f"{script} is ported: drop it from NOT_PORTED"
        return
    assert (PORT / "scripts" / script).is_file(), f"scripts/{script}: no mava_tpu_torch/scripts/{script}"


def test_the_not_ported_scripts_exist():
    """`NOT_PORTED` names scripts that are there; none is stale."""
    assert NOT_PORTED <= set(root_scripts())
    assert any(s.startswith(NOT_PORTED_PREFIX) for s in root_scripts())


def test_the_renamed_modules_are_gone_from_the_port():
    """A renamed module has no file of its old name in the port."""
    for module in RENAMED:
        assert not (PORT / module).exists(), module


def test_no_port_module_refuses_outside_the_allow_list():
    found = {(module, function, line) for module in modules(PORT)
             for function, line in refusals(PORT / module)}
    unexpected = sorted(f for f in found if f[:2] not in ALLOWED_REFUSALS)
    assert not unexpected, f"NotImplementedError raised at {unexpected}"
    assert {f[:2] for f in found} == ALLOWED_REFUSALS  # the allow-list holds nothing stale
