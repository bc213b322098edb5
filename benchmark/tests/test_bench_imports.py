"""No module the runner or the reference imports is JAX or the JAX
package (top-level names compared whole: ``gligen_tpu_torch`` is not
``gligen_tpu``), and the reference imports nothing of the program."""

import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import ROOT

PROBE = """
import sys, json
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.', 1)[0] for m in sys.modules}})))
"""


def top_level_modules(imports: str):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, check=True, timeout=300)
    import json

    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_runner_and_its_drivers_load_no_jax_module():
    mods = top_level_modules(
        "import benchmark.run, benchmark.harness, benchmark.traffic.gen_closed, "
        "benchmark.traffic.train_steps, benchmark.calibrate\n"
        "import gligen_tpu_torch.inference.pipeline, gligen_tpu_torch.training.train_step")
    assert not mods & set(harness.FORBIDDEN), mods & set(harness.FORBIDDEN)
    assert "gligen_tpu_torch" in mods


def test_the_reference_imports_nothing_of_the_program():
    mods = top_level_modules(
        "import benchmark.reference.model, benchmark.reference.generate, "
        "benchmark.reference.train, benchmark.reference.params")
    assert not mods & (set(harness.FORBIDDEN) | {"gligen_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gligen_tpu_torch_fake", sys)
    assert "gligen_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in harness.forbidden_modules()
