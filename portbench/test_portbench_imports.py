"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Top-level module names are
compared whole: ``stable_diffusion_tpu_torch`` (the program) begins with
``stable_diffusion_tpu`` (the JAX package) and is not it.

Two looks: every import statement in the benchmark's files (those inside
functions too), and the modules a fresh interpreter holds after importing
the entry, the drivers, the readers, the reference and the program modules
the drivers call."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from portbench import harness

BENCH = Path(harness.__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "stable_diffusion_tpu"}
PROGRAM = "stable_diffusion_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_sources_import_no_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imported_tops(f) & JAX
        assert not bad, f"{f.relative_to(BENCH)} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert PROGRAM not in tops, f"{f.relative_to(BENCH)} imports the program"
        assert tops <= {"__future__", "dataclasses", "math", "typing", "numpy", "torch",
                        "portbench"}, f"{f.name}: {tops}"
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith("portbench"):
                assert node.module.startswith("portbench.reference"), node.module


SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import portbench.reference.nets, portbench.reference.sampling, portbench.reference.train
ref_only = sorted({m.split(".")[0] for m in sys.modules})
from portbench import harness
for d in sorted((harness.BENCH / "drivers").glob("[a-z]*.py")):
    harness.load_file(d)
for m in sorted((harness.BENCH / "metrics").glob("*.py")):
    harness.load_file(m)
import stable_diffusion_tpu_torch.pipeline, stable_diffusion_tpu_torch.training
import stable_diffusion_tpu_torch.ops.conv, stable_diffusion_tpu_torch.ops.flash_attention
print(json.dumps({"ref_only": ref_only, "all": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_loaded_modules_hold_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(harness.ROOT)], capture_output=True,
                         text=True, timeout=300, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert PROGRAM not in mods["ref_only"]
    assert not set(mods["all"]) & JAX, set(mods["all"]) & JAX
    assert PROGRAM in mods["all"]
