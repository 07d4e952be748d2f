"""The port runs without jax and without the JAX package: every
nvfpcc_tpu_torch module imports, and a toy decode runs on the CPU, in a
process where importing jax or ``nvfpcc_tpu`` fails; no source line of the
port or of ``chip_smoke.py`` imports either. The graph = eager check that
``chip_smoke.py`` and ``tools/ctx_recipe.py`` share tells a one-ulp
difference from equal trees."""

import os
import re
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    def blocked(name):
        return (name == "jax" or name.startswith(("jax.", "jaxlib"))
                or name == "nvfpcc_tpu" or name.startswith("nvfpcc_tpu."))

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, BlockJax())
    import nvfpcc_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(nvfpcc_tpu_torch.__path__, "nvfpcc_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    from nvfpcc_tpu_torch import codec
    points, info = codec.decode(codec.load_pack("tests/fixtures/packs/pack_v1.pk"), "cpu")
    assert len(points) > 0 and info["n_blocks"] == 3
    assert not any(blocked(m) for m in sys.modules)
    print("NOJAX_OK", len(names), len(points))
    """
)


def test_port_imports_and_decodes_with_jax_blocked():
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout


# `import jax`, `from jax...`, `import nvfpcc_tpu[.x]`, `from nvfpcc_tpu[.x] import`;
# not nvfpcc_tpu_torch
_FORBIDDEN = re.compile(r"^(import jax|from jax|import nvfpcc_tpu(\.|\s|,|$)|from nvfpcc_tpu(\.|\s))")


def _port_sources():
    yield os.path.join(ROOT, "chip_smoke.py")
    for dirpath, _, files in os.walk(os.path.join(ROOT, "nvfpcc_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_import_in_the_port_sources():
    sources = list(_port_sources())
    assert len(sources) > 20
    for entry in ("parallel/mesh.py", "tools/dryrun_multichip.py", "tools/rd_sweep.py", "tools/encode_eval.py",
                  "tools/pipeline_demo.py", "tools/bench.py", "tools/entry.py", "train/graphs.py",
                  "tools/graph_check.py", "tools/ctx_recipe.py"):
        assert os.path.join(ROOT, "nvfpcc_tpu_torch", entry) in sources
    for path in sources:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                assert not _FORBIDDEN.match(s), (path, s)


def test_forbidden_import_pattern():
    for bad in ("import jax", "import nvfpcc_tpu", "import nvfpcc_tpu.cli", "from nvfpcc_tpu import cli",
                "from nvfpcc_tpu.coder import huffman", "import nvfpcc_tpu as N"):
        assert _FORBIDDEN.match(bad), bad
    for ok in ("import nvfpcc_tpu_torch", "from nvfpcc_tpu_torch.coder import huffman",
               "from nvfpcc_tpu_torch import codec", "import numpy as np"):
        assert not _FORBIDDEN.match(ok), ok


def test_layer_map_names_every_subpackage():
    """The package docstring's layer map names every top-level module and
    subpackage of the port, every entropy mode, and the modules that
    joined after the first slice."""
    import pkgutil

    import nvfpcc_tpu_torch

    doc = nvfpcc_tpu_torch.__doc__
    names = [m.name for m in pkgutil.iter_modules(nvfpcc_tpu_torch.__path__)]
    assert {"parallel", "train", "kernels", "tools"} <= set(names)
    for name in names:
        assert f"``{name}``" in doc, name
    for name in ("channel", "spatio", "gmm", "factorized", "ctx", "ctx_ar", "train/ctx_fit.py",
                 "coder/ctx_coder.py", "metrics/d2.py"):
        assert name in doc, name


def test_bits_equal_reports_a_one_ulp_difference():
    import numpy as np

    from nvfpcc_tpu_torch.tools.graph_check import bits_equal

    rng = np.random.default_rng(0)
    a = {"params/w": rng.normal(size=(3, 4)).astype(np.float32), "step": np.asarray(7),
         "rows": rng.normal(size=(2, 12)).astype(np.float32)}
    b = {k: v.copy() for k, v in a.items()}
    assert bits_equal(a, b) == []
    b["params/w"][1, 2] = np.nextafter(b["params/w"][1, 2], np.float32(np.inf))
    assert bits_equal(a, b) == ["params/w"]
    # -0.0 == 0.0 as numbers, not as bits; a missing key or another shape differs too
    c = {**a, "rows": np.zeros((2, 12), np.float32)}
    d = {**a, "rows": -np.zeros((2, 12), np.float32)}
    assert bits_equal(c, d) == ["rows"]
    assert bits_equal(a, {k: v for k, v in a.items() if k != "step"}) == ["step"]
    assert bits_equal(a, {**a, "rows": a["rows"].reshape(12, 2)}) == ["rows"]
