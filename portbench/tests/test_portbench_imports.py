"""Nothing the benchmark loads brings in JAX or the JAX package.

The check compares the top-level name of every loaded module (the part
before the first dot) whole, so the port, whose name begins with the JAX
package's, does not trip it. It runs in a fresh interpreter, after a
whole CPU run of a tiny cell of each entry, so that everything a run
imports (the port's modes, trainer, engines and kernels' wrappers) is
loaded.
"""
import os
import subprocess
import sys

from conftest import BENCH, ROOT

SCRIPT = r"""
import runpy, sys
sys.path[:0] = [{bench!r}, {root!r}]
runpy.run_path({run!r}, run_name="portbench_run")
from harness import cells, runner
from pecanpy_tpu_torch.models import base
base.Base.STREAMING_TOKEN_THRESHOLD = 0
for name, cell in cells.all_cells().items():
    cell.graph_generator()
    for m in cell.per_layer:
        cell.metric_reader(m.name)
for name in ("uniform1m.walks", "uniform1m.embed"):
    cell = cells.resolve(name)
    cell.config["graph"]["params"]["num_nodes"] = 1500
    result, _ = runner.run_cell(cell, 3, 0.01, True, "cpu", 0.0)
    assert result["correct"]
print("FORBIDDEN", runner.forbidden_modules())
print("PORT", "pecanpy_tpu_torch" in sys.modules)
"""


def test_no_jax_after_a_run():
    code = SCRIPT.format(bench=BENCH, root=ROOT, run=os.path.join(BENCH, "run.py"))
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout and "PORT True" in out.stdout


def test_forbidden_names_are_compared_whole():
    from harness import runner

    sys.modules.setdefault("pecanpy_tpu_torch_probe", sys)
    try:
        assert "pecanpy_tpu_torch_probe" not in runner.forbidden_modules()
    finally:
        sys.modules.pop("pecanpy_tpu_torch_probe", None)
    assert set(runner.FORBIDDEN) == {"jax", "jaxlib", "flax", "pecanpy_tpu"}


def test_run_exits_nonzero_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "uniform1m.walks", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
