"""The port's quickstart, `python -m mava_tpu_torch.examples.quickstart`, and its
notebook `mava_tpu_torch/examples/Quickstart.ipynb`, run end to end at the JAX
twins' shrunken sizes (`tests/test_quickstart.py`,
`tests/test_quickstart_notebook.py`) on the CPU, which each is asked for: the
script with `+arch.device=cpu`, the notebook with its CPU line uncommented.
Without that request both ask for the card, and here that raises."""

import importlib.util
import os
import sys

import nbformat
import pytest
from nbclient import NotebookClient

from mava_tpu_torch.examples import quickstart
from test_quickstart import TINY
from test_quickstart_notebook import TINY as NOTEBOOK_TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = os.path.join(REPO, "mava_tpu_torch", "examples", "Quickstart.ipynb")
CPU_LINE = '# DEVICE = torch.device("cpu")'


def test_quickstart_defaults_are_the_reference_ones():
    spec = importlib.util.spec_from_file_location(
        "jax_quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    assert quickstart.QUICKSTART_DEFAULTS == reference.QUICKSTART_DEFAULTS


def test_quickstart_runs_on_the_cpu_when_asked(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["quickstart"] + TINY + ["+arch.device=cpu"])
    result = quickstart.main()
    assert isinstance(result, float) and result == result


def test_quickstart_asks_for_the_card(monkeypatch, capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here")
    monkeypatch.setattr(sys, "argv", ["quickstart"] + TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available; pass \\+arch.device=cpu"):
        quickstart.main()


def test_notebook_has_no_device_switch():
    """The device is one line, the card's; a switch on `cuda.is_available`
    would hide which device ran."""
    nb = nbformat.read(NB, as_version=4)
    code = "\n".join(c.source for c in nb.cells if c.cell_type == "code")
    assert "cuda.is_available" not in code
    assert 'DEVICE = torch.device("cuda")' in code and CPU_LINE in code
    assert "jax" not in code and "mava_tpu." not in code


def test_notebook_executes_on_the_cpu(monkeypatch, tmp_path):
    nb = nbformat.read(NB, as_version=4)
    patched = cpu_forced = False
    for cell in nb.cells:
        if cell.cell_type != "code":
            continue
        if "total_timesteps=300000" in cell.source:
            start = cell.source.index("[")
            end = cell.source.index("]") + 2  # include "],"
            cell.source = cell.source[:start] + NOTEBOOK_TINY.strip() + cell.source[end:]
            patched = True
        if CPU_LINE in cell.source:
            cell.source = cell.source.replace(CPU_LINE, CPU_LINE[2:])
            cpu_forced = True
    assert patched, "config cell not found: the notebook's layout changed"
    assert cpu_forced, "the CPU line not found: the notebook's layout changed"

    # The kernel runs in `tmp_path` (the GIF goes there) with the repo on its path.
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    client = NotebookClient(nb, timeout=300, kernel_name="python3",
                            resources={"metadata": {"path": str(tmp_path)}})
    client.execute()

    out_text = "".join(
        "".join(o.get("text", "") for o in c.get("outputs", []) if o.get("output_type") == "stream")
        for c in nb.cells if c.cell_type == "code"
    )
    assert "eval return" in out_text
    assert "wrote results/render/quickstart_lbf.gif" in out_text
    assert (tmp_path / "results" / "render" / "quickstart_lbf.gif").stat().st_size > 0
