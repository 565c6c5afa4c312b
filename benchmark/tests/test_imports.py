"""What the benchmark's processes may load."""

import ast
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "epidemicmodeling_tpu"}


def loaded_in_fresh_process(code: str) -> set:
    """Top-level names in sys.modules after ``code`` runs in a new
    interpreter at the root of the checkout."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split("
         "'.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    names = loaded_in_fresh_process(
        "from benchmark import run, entries, readings, compare, trace\n"
        "from benchmark.metrics import _lib\n"
        "from benchmark.entries import _xprize\n"
        "_xprize.program()\n"
        "for e in ('run_pipeline', 'prescribe_from_checkpoint',\n"
        "          'forecast_quality_assessment'):\n"
        "    entries.load(e)\n"
        "for m in ('ekf6_roofline.pipeline', 'mfu.sweep'):\n"
        "    run.reader(m)")
    assert "epidemicmodeling_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = loaded_in_fresh_process(
        "import benchmark.reference.plain, benchmark.compare, "
        "benchmark.data, benchmark.counts")
    assert not names & (FORBIDDEN | {"epidemicmodeling_torch"})


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark" / "reference").glob("*.py")))
def test_reference_sources_import_no_program(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN | {
                "epidemicmodeling_torch", "benchmark"}, (path, n)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "epidemicmodeling_torch_extra",
                        sys.modules["json"])
    assert run.forbidden_modules() == sorted(
        n for n in FORBIDDEN if n in {m.split(".")[0] for m in sys.modules})
    monkeypatch.setitem(sys.modules, "epidemicmodeling_tpu.fake",
                        sys.modules["json"])
    assert "epidemicmodeling_tpu" in run.forbidden_modules()


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints no result; so
    it does in a directory holding only BENCHMARK.json and benchmark/."""
    for cwd in (ROOT, tmp_path):
        if cwd is tmp_path:
            import shutil
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
            shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload",
             "xprize-backtest", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
