"""The port's package surface, read from the file system only: every
module file of the JAX package has its counterpart at the same path in
``deeplearning4j_tpu_torch/``, both packages list the same lazy
submodules, and no file of the port imports ``jax`` or the JAX package.
"""

import ast
import os
import re
from pathlib import Path

import pytest

_REPO = Path(__file__).resolve().parents[1]
REF, PORT = _REPO / "deeplearning4j_tpu", _REPO / "deeplearning4j_tpu_torch"


def _files(root, suffixes):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.suffix in suffixes and "__pycache__" not in p.parts)


def _submodules(root):
    tree = ast.parse((root / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "_SUBMODULES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{root}/__init__.py has no _SUBMODULES")


@pytest.mark.parametrize("suffix", [".py", ".cpp"])
def test_every_reference_module_has_its_counterpart(suffix):
    missing = sorted(set(_files(REF, {suffix})) - set(_files(PORT, {suffix})))
    assert not missing, f"not ported: {missing}"


def test_the_lazy_submodules_are_the_references():
    ref, port = _submodules(REF), _submodules(PORT)
    assert port == ref
    for name in port:
        assert (PORT / name).is_dir() or (PORT / f"{name}.py").is_file()


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|deeplearning4j_tpu)"
                     r"(?![\w])", re.MULTILINE)


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = []
    for rel in _files(PORT, {".py"}):
        text = (PORT / rel).read_text(encoding="utf-8")
        for m in _IMPORT.finditer(text):
            offenders.append(f"{rel}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_the_import_check_sees_an_import():
    """The pattern catches the forms it guards against, and not the port's
    own name."""
    for line in ("import jax", "from jax import numpy", "  import jax.numpy",
                 "from deeplearning4j_tpu.nn import x",
                 "import deeplearning4j_tpu"):
        assert _IMPORT.search(line), line
    for line in ("from deeplearning4j_tpu_torch import nn",
                 "import deeplearning4j_tpu_torch.rng", "# import jax",
                 "x = 'import jax'", "import jaxtyping"):
        assert not _IMPORT.search(line), line


def test_the_examples_mirror_the_reference_scripts():
    ref = {f for f in os.listdir(_REPO / "examples") if f.endswith(".py")}
    port = {f for f in os.listdir(PORT / "examples")
            if f.endswith(".py") and not f.startswith("_")}
    assert port == ref
