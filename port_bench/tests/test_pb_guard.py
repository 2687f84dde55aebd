"""Nothing the benchmark runs loads JAX, its libraries, the JAX package or
bench.py, and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

from port_bench.harness import registry
from port_bench.harness.guard import FORBIDDEN, forbidden_modules

HERE = os.path.join(registry.ROOT, "port_bench")


def test_names_are_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "soft_robot_control_tpu", "soft_robot_control_tpu.ops",
              "bench", "soft_robot_control_tpu_torch",
              "soft_robot_control_tpu_torch.ops.build", "jaxtyping",
              "benchmark", "port_bench.harness.cli"]
    assert forbidden_modules(loaded) == [
        "bench", "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "soft_robot_control_tpu", "soft_robot_control_tpu.ops"]


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _files(folder):
    for d, _, names in os.walk(folder):
        yield from (os.path.join(d, n) for n in names if n.endswith(".py"))


def test_no_file_imports_jax_and_the_reference_not_the_program():
    for path in _files(HERE):
        assert not set(_imports(path)) & set(FORBIDDEN), path
    for path in _files(os.path.join(HERE, "reference")):
        assert "soft_robot_control_tpu_torch" not in set(_imports(path)), \
            path


def test_a_run_loads_no_jax_module():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from port_bench.harness import registry\n"
        "from port_bench.harness.cli import run_cell\n"
        "from port_bench.harness.guard import forbidden_modules\n"
        "line, _ = run_cell('diamond_rollouts', 7, 1.5, False, 'cpu',\n"
        "    bench=registry.benchmark(),\n"
        "    traffic_overrides={'batch': 8, 'steps': 5, 'pool': 1})\n"
        "assert 'soft_robot_control_tpu_torch' in sys.modules\n"
        "print(forbidden_modules())\n" % registry.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_a_run_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "diamond_rollouts", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300,
        cwd=registry.ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
