"""Nothing under portbench/ imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "raht3dgs_tpu"}


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in sources() if os.sep + "reference" + os.sep in p),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_stands_apart(path):
    assert "raht3dgs_tpu_torch" not in set(top_names(path))


def test_whole_names():
    """The program's package shares the JAX package's prefix and is no
    match."""
    import raht3dgs_tpu_torch  # noqa: F401

    from portbench import run

    assert run.forbidden_modules() == []
