"""Nothing the benchmark runs loads JAX, flax or the JAX package
(top-level module names compared whole: rag_tpu_torch is the program,
rag_tpu is not), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rag_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        assert not _imports(p) & FORBIDDEN, p


def test_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").rglob("*.py"):
        names = _imports(p)
        assert not any(n.startswith("rag_tpu") for n in names), p
        assert "harness" not in names, p


def _loaded(code):
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            + code + "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, check=True, cwd=str(ROOT))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _loaded(
        "import run, calibrate\n"
        "from harness import serve, train, work, trace, inputs, spec\n"
        "import reference.net, reference.train\n"
        "import rag_tpu_torch.continual.inference, rag_tpu_torch.train.trainer\n"
        "import rag_tpu_torch.continual.state\n"
        "for m in spec.load('ds4-serve-cam1').per_layer:\n"
        "    spec.reader(m['name'])")
    assert not loaded & FORBIDDEN
    assert "rag_tpu_torch" in loaded


def test_reference_alone_loads_no_program():
    loaded = _loaded("import reference.net, reference.train")
    assert not any(m.startswith("rag_tpu") for m in loaded)
    assert not loaded & FORBIDDEN


def test_run_guard_names_whole_top_level_modules():
    sys.path.insert(0, str(BENCH))
    import run

    before = run.forbidden_modules()
    try:
        sys.modules["rag_tpu_torch_x"] = sys
        sys.modules["jaxlib_x.y"] = sys
        sys.modules["jaxlib.y"] = sys
        assert run.forbidden_modules() == sorted(set(before) | {"jaxlib"})
    finally:
        for k in ("rag_tpu_torch_x", "jaxlib_x.y", "jaxlib.y"):
            sys.modules.pop(k, None)
