"""What the package needs from its installation: no flax or orbax on the
main path, and a compilation cache only where an entry point asks."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_FLAX = r"""
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("flax", "orbax"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import littlemcmc_tpu as lmc

trace, stats = lmc.sample(
    logp_dlogp_func=lambda x: (-0.5 * jnp.sum(x ** 2), -x), model_ndim=2,
    chains=4, tune=50, draws=50, random_seed=0, progressbar=False)
assert trace.shape == (4, 50, 2), trace.shape
assert not [m for m in sys.modules if m.split(".")[0] in ("flax", "orbax")]
print("SAMPLED_WITHOUT_FLAX")
"""

_CACHE = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import littlemcmc_tpu
print("AFTER_IMPORT", jax.config.jax_compilation_cache_dir)
from littlemcmc_tpu.utils.compile_cache import enable_compile_cache
print("HELPER", enable_compile_cache())
print("CONFIG", jax.config.jax_compilation_cache_dir)
"""


def _python(code, **env):
    full = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(env)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=full)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                if " " in line)


def test_import_and_sample_without_flax():
    proc = subprocess.run([sys.executable, "-c", _NO_FLAX], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SAMPLED_WITHOUT_FLAX" in proc.stdout


def test_compile_cache_defaults_to_the_repo_directory():
    out = _python(_CACHE)
    assert out["AFTER_IMPORT"] == "None"  # importing the package sets nothing
    assert out["HELPER"] == os.path.join(REPO, ".jax_cache")
    assert out["CONFIG"] == out["HELPER"]


def test_compile_cache_honours_the_environment_variable(tmp_path):
    out = _python(_CACHE, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out["HELPER"] == str(tmp_path)
    assert out["CONFIG"] == str(tmp_path)
