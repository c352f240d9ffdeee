"""What the benchmark loads: nothing whose top-level name (the part
before the first dot, compared whole) is jax, jaxlib, flax or the JAX
package, and the reference nothing of the port either."""

import json
import subprocess
import sys

from perfbench.common import FORBIDDEN, ROOT

HARNESS = ["perfbench.run", "perfbench.calibrate",
           "perfbench.entries.segment", "perfbench.entries.frames",
           "perfbench.entries.finetune", "perfbench.faults",
           "whisperseg_torch.segmenter", "whisperseg_torch.training.trainer",
           "whisperseg_torch.data"]
REFERENCE = ["perfbench.reference.model", "perfbench.reference.frontend",
             "perfbench.reference.targets"]


def loaded_tops(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0",
                              "HOME": "/nonexistent"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    tops = loaded_tops(HARNESS)
    assert not tops & set(FORBIDDEN)
    assert "whisperseg_torch" in tops   # the whole name, not a prefix match


def test_the_reference_loads_nothing_of_the_port():
    tops = loaded_tops(REFERENCE)
    assert not tops & set(FORBIDDEN + ("whisperseg_torch",))
