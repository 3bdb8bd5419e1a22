"""The reference against the port's CPU path, through whole runs of the
harness at a tiny database (2 species x 3 genomes, four ks), and what a
run may import."""

import ast
import io
import json
import os

import pytest

from bench_tiny import CELLS, core, run_tiny


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_run_is_correct(cell):
    out, err = io.StringIO(), io.StringIO()
    r = run_tiny(cell, out=out, err=err)
    assert r["correct"] is True, r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert all(c["limit"] == 0 and c["value"] == 0 for c in r["compared"].values())
    assert "setup_s" in r["metrics"]
    last = out.getvalue().splitlines()[-1]
    assert json.loads(last) == r
    assert err.getvalue().splitlines()[-1].startswith("compared ")


@pytest.mark.parametrize("cell", ["exp1.4x8x5mbp", "ksweep.4x8x5mbp"])
def test_tiny_traced_run(cell):
    r = run_tiny(cell, traced=True, out=io.StringIO(), err=io.StringIO())
    assert r["correct"] is True
    per_layer = {m["name"] for m in core.cell_metrics(core.spec(), cell, True)}
    # no device on the CPU: the rooflines and the idle share read nothing, never 0
    assert set(r["metrics"]) <= per_layer
    assert not any(n.startswith(("sort_roofline", "scan_roofline", "device_idle"))
                   for n in r["metrics"])
    assert "breakdown" in r and r["device"]["window_s"] > 0
    assert not core.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(core.BENCH_DIR, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for name in _imports(os.path.join(ref, f)):
                assert name.split(".")[0] not in ("khoice_tpu_torch", "khoice_tpu", "jax",
                                                  "jaxlib", "flax"), (f, name)


def test_benchmark_imports_no_tool_of_the_repo():
    for dirpath, _dirs, files in os.walk(core.BENCH_DIR):
        for f in files:
            if f.endswith(".py"):
                for name in _imports(os.path.join(dirpath, f)):
                    assert name.split(".")[0] not in ("tools", "bench_torch", "chip_smoke",
                                                      "bench", "khoice_tpu", "jax"), (f, name)
