"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain references import nothing of the program.  Module names are
compared by their whole top-level name: the port's name begins with the
JAX package's, so a prefix test would be wrong."""

import os
import subprocess
import sys

from benchmark import harness

JAX_NAMES = {"jax", "jaxlib", "flax", "hierarchical_block_sparse_lib_tpu"}
PORT = "hierarchical_block_sparse_lib_tpu_torch"


def modules(*sub):
    """Dotted names of the benchmark's modules under `sub` (tests aside)."""
    out = []
    top = os.path.join(harness.BENCH_DIR, *sub)
    for dirpath, dirs, files in os.walk(top):
        dirs[:] = [d for d in dirs if d not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f[:-3]), harness.ROOT)
                out.append(rel.replace(os.sep, "."))
    return sorted(out)


def loaded_top_names(names):
    code = ("import importlib.util, sys\n"
            f"for n in {names!r}:\n"
            "    path = n.replace('.', '/') + '.py'\n"
            "    spec = importlib.util.spec_from_file_location(n, path)\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    sys.modules[n] = mod\n"
            "    spec.loader.exec_module(mod)\n"
            "print(' '.join(sorted({k.split('.')[0] for k in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=harness.ROOT))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(p.stdout.split())


def test_benchmark_loads_no_jax():
    names = modules()
    assert "benchmark.run" in names and "benchmark.metrics.leaf_gflops" in names
    tops = loaded_top_names(names)
    assert PORT in tops
    assert not tops & JAX_NAMES


def test_reference_loads_nothing_of_the_program():
    tops = loaded_top_names(modules("reference"))
    assert PORT not in tops and not tops & JAX_NAMES
