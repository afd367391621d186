"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads no part of the port either (top-level names, compared whole:
the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

from portbench import harness

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=harness.ROOT, imports=imports)],
                         capture_output=True, text=True, timeout=300, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_its_entries_load_no_jax():
    tops = _loaded("import portbench.run, portbench.harness as h\n"
                   "for e in ('odometry_window', 'slam_run'): h.entry(e)\n"
                   "import hdl_graph_slam_tpu_torch.pipeline, hdl_graph_slam_tpu_torch.frontend.window\n"
                   "import json, os\n"
                   "b = json.load(open(os.path.join(h.ROOT, 'BENCHMARK.json')))\n"
                   "[h.metric_reader(m['name']) for m in b['per_layer']]")
    assert "hdl_graph_slam_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "hdl_graph_slam_tpu"}


def test_the_reference_loads_neither_jax_nor_the_port():
    tops = _loaded("import portbench.reference, portbench.reference.check, portbench.course, portbench.roofline")
    assert not tops & {"jax", "jaxlib", "flax", "hdl_graph_slam_tpu", "hdl_graph_slam_tpu_torch"}


def test_the_guard_compares_whole_top_level_names():
    port = ["hdl_graph_slam_tpu_torch", "hdl_graph_slam_tpu_torch.ops.knn", "jaxlike", "flaxen.x"]
    assert harness.forbidden_loaded(port) == []
    assert harness.forbidden_loaded(port + ["jax.numpy", "hdl_graph_slam_tpu.ops"]) == ["hdl_graph_slam_tpu", "jax"]
