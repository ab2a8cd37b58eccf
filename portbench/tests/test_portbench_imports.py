"""What a run loads: no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or ``ptwt_tpu`` (compared whole: the port's name begins with
the JAX package's), and nothing of the port in the plain reference."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
CHECKOUT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ptwt_tpu"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_file_of_the_harness_imports_jax(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert not (_imports(path) & (FORBIDDEN | {"ptwt_tpu_torch", "portbench"}))
    text = path.read_text()
    assert "ptwt_tpu" not in text.replace("ptwt's", "")


_PROBE = """
import json, sys, time
sys.path[:0] = [{src!r}, {checkout!r}]
import torch
torch.set_num_threads(1)
from portbench.tests._small import CELLS, run_small
{what}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(what: str) -> set:
    code = _PROBE.format(src=str(CHECKOUT / "src"), checkout=str(CHECKOUT), what=what)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_mix_loads_no_jax():
    loaded = _loaded("for c in CELLS:\n    run_small(c, trace_on=True)")
    assert "ptwt_tpu_torch" in loaded
    assert not (loaded & FORBIDDEN)


def test_the_reference_alone_loads_nothing_of_the_port():
    loaded = _loaded(
        "import portbench.reference.checks, portbench.reference.control, portbench.reference.bank_losses\n"
        "assert 'ptwt_tpu_torch' not in sys.modules"
    )
    assert "ptwt_tpu_torch" not in loaded and not (loaded & FORBIDDEN)
