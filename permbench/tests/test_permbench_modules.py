import subprocess
import sys

from permbench import harness


def test_forbidden_by_whole_top_level_name():
    mods = ["jax", "jax.numpy", "superman_tpu", "superman_tpu.ops.ryser",
            "superman_tpu_torch", "superman_tpu_torch.ops", "jaxtyping",
            "flax.linen", "jaxlib.xla_client", "numpy"]
    assert harness.forbidden_modules(mods) == ["flax", "jax", "jaxlib",
                                               "superman_tpu"]
    assert harness.forbidden_modules(["superman_tpu_torch",
                                      "superman_tpu_torch.api",
                                      "jaxtyping", "numpy"]) == []


def test_a_run_loads_neither():
    """A whole small run, traced, in a fresh process: what the harness
    and the program load holds no forbidden module."""
    code = ("import sys\n"
            "from permbench.tests.conftest import run_small\n"
            "from permbench import harness\n"
            "for name in ('erdos_int_dense.n32', 'erdos_int_dense.exact_n30'):\n"
            "    assert run_small(name, traced=True)['correct']\n"
            "print(harness.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
