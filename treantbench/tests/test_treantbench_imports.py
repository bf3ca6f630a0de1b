"""Nothing the benchmark runs loads JAX or the JAX package."""

from __future__ import annotations

import subprocess
import sys

from treantbench.tests import tiny

SCRIPT = """
import pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import treantbench
for m in pkgutil.walk_packages(treantbench.__path__, "treantbench."):
    if ".tests" not in m.name:
        __import__(m.name)
from treantbench.harness import bench, cli
for m in bench.load_benchmark()["per_layer"]:
    bench.reader(m["name"])
import repro_torch.core, repro_torch.core.dashboard, repro_torch.core.treant
import repro_torch.kernels.segment_aggregate.ops
print(cli.forbidden_modules(), sorted({{m.split(".")[0] for m in sys.modules}} & {{"repro_torch"}}))
"""


def test_harness_loads_no_jax_and_not_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=str(tiny.ROOT), src=str(tiny.ROOT / "src"))],
        capture_output=True, text=True, timeout=120, cwd=tiny.ROOT,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[-2] == "[] ['repro_torch']"


def test_forbidden_names_compare_whole():
    from treantbench.harness import cli

    assert cli.forbidden_modules(["repro_torch.core", "jaxtyping", "reprox.a", "flaxen"]) == []
    assert cli.forbidden_modules(["repro.core", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "repro"]
