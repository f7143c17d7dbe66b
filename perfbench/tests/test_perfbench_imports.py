"""Nothing the benchmark runs loads JAX or the JAX package (ptdn_tpu),
compared by whole top-level module names (ptdn_tpu_torch, the program,
begins with ptdn_tpu and is allowed), and the reference imports none of
the program."""

import ast
import json
import pathlib
import subprocess
import sys

from perfbench import harness

BENCH = pathlib.Path(harness.__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ptdn_tpu"}


def modules():
    out = []
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(BENCH.parent).with_suffix("")
        if "tests" in rel.parts:
            continue
        out.append(".".join(rel.parts[:-1] if rel.name == "__init__"
                            else rel.parts))
    return out


def imported_tops(path: pathlib.Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_the_benchmark_runs_loads_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules()!r}:\n"
        "    importlib.import_module(m)\n"
        # what the harness imports of the program when it builds a cell
        "import ptdn_tpu_torch.engine, ptdn_tpu_torch.scene\n"
        "import ptdn_tpu_torch.utils.config\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "perfbench" in tops and "ptdn_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_no_source_imports_jax_and_the_reference_none_of_the_program():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.relative_to(BENCH).parts:
            continue
        tops = imported_tops(p)
        assert not tops & FORBIDDEN, (p, tops & FORBIDDEN)
        if "reference" in p.relative_to(BENCH).parts or \
                p.parent.name in ("work", "metrics"):
            assert "ptdn_tpu_torch" not in tops, p


def test_the_harness_reads_no_benchmarks_folder():
    for p in BENCH.rglob("*.py"):
        if "tests" not in p.relative_to(BENCH).parts:
            assert "benchmarks" not in p.read_text(), p
    assert "benchmarks/" not in (BENCH.parent / "BENCHMARK.json").read_text()
