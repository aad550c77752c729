"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level names (the program's name begins with the JAX package's);
the reference imports nothing of the program either."""
import ast
import glob
import json
import os
import subprocess
import sys

import pb_small
from harness import guard

BENCH = pb_small.BENCH
ROOT = os.path.dirname(BENCH)
PROGRAM = "project3_cuda_path_tracer_tpu_torch"


def test_forbidden_compares_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
             "project3_cuda_path_tracer_tpu",
             "project3_cuda_path_tracer_tpu.ops",
             PROGRAM, PROGRAM + ".ops.wavefront", "jaxtyping", "numpy"]
    assert guard.forbidden(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "project3_cuda_path_tracer_tpu", "project3_cuda_path_tracer_tpu.ops"]


def _modules_after(code: str) -> list:
    """sys.modules of a fresh interpreter after `code`."""
    prog = ("import sys\nsys.path[:0] = [%r, %r]\n" % (BENCH, ROOT) + code
            + "\nimport json\nprint(json.dumps(sorted(sys.modules)))")
    p = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """A whole small run, through every mix and reader, in a fresh process."""
    mods = _modules_after(
        "import torch\n"
        "sys.path.insert(0, %r)\n" % os.path.join(BENCH, "tests")
        + "import pb_small\n"
        "from harness import runner\n"
        "for name in ('cornell-nee-render', 'cornell-train'):\n"
        "    c = pb_small.cell(name)\n"
        "    runner.run(c, 7, 0.1, True, torch.device('cpu'), 0.0)\n")
    assert PROGRAM in {m.split(".")[0] for m in mods}
    assert guard.forbidden(mods) == []


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after("import reference.scene, reference.tracer, "
                          "reference.train")
    tops = {m.split(".")[0] for m in mods}
    assert PROGRAM not in tops and not guard.forbidden(mods)


def test_reference_sources_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in guard.FORBIDDEN + (PROGRAM,), (path, n)
