"""Nothing the benchmark loads imports JAX or the JAX package, and its
reference imports nothing of the program: each imported module's top-level
name compared whole (``qwen_tts_tpu_torch`` is the port, allowed outside the
reference)."""

import ast
import os

import _paths

FORBIDDEN = {"jax", "jaxlib", "flax", "qwen_tts_tpu"}
PORT = "qwen_tts_tpu_torch"


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def _sources():
    for base, dirs, files in os.walk(_paths.BENCH):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_jax_anywhere():
    found = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: m for p, m in found.items() if m}


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(_paths.BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = set(_imports(os.path.join(ref, f)))
            assert PORT not in names and not names & FORBIDDEN, f


def test_weights_import_nothing_of_the_program():
    # The weights are the benchmark's inputs, made without the program.
    names = set(_imports(os.path.join(_paths.BENCH, "weights.py")))
    assert PORT not in names and not names & FORBIDDEN


def test_whole_names_compared():
    # The port's name begins with the JAX package's; only whole names count.
    import harness

    assert "qwen_tts_tpu_torch" not in FORBIDDEN
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "qwen_tts_tpu")
