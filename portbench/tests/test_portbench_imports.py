"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), and the references load nothing of the
program."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = os.path.dirname(harness.HERE)


def loaded_after(code: str) -> set:
    script = (f"import sys; sys.path.insert(0, {ROOT!r}); {code}; "
              "import json; print(json.dumps(sorted({m.split('.')[0] for m "
              "in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True, cwd=ROOT,
                         env=dict(os.environ, USE_FLAX="0", USE_TF="0"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_references_load_no_program_and_no_jax():
    mods = loaded_after("import portbench.reference.qwen3, "
                        "portbench.reference.gpt2")
    assert not mods & set(harness.FORBIDDEN)
    assert "neuralnetworklibrary_tpu_torch" not in mods


def test_the_harness_loads_no_jax():
    mods = loaded_after(
        "from portbench import harness, control; "
        "b = harness.manifest(); "
        "[harness.layer_metric(m['name']) for m in b['per_layer']]; "
        "[harness.family(harness.resolve(w['name'], b)['config']) "
        "for w in b['workloads']]; "
        "import neuralnetworklibrary_tpu_torch.learner, "
        "neuralnetworklibrary_tpu_torch.utils.llama_convert, "
        "neuralnetworklibrary_tpu_torch.applications.text")
    assert "neuralnetworklibrary_tpu_torch" in mods
    assert not mods & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    assert "neuralnetworklibrary_tpu_torch" not in harness.FORBIDDEN
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in sys.modules} & set(harness.FORBIDDEN))
