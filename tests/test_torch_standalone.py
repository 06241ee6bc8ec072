"""The port stands alone: it runs with JAX blocked (a Hadamard smooth-pulse
and example 05's open-system problem, one IPM iteration each, in a
subprocess), and no module of it, nor chip_smoke.py, imports JAX or the
JAX package.  This file imports neither."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import numpy as np, quantumcollocation_tpu_torch as qt\n"
        "from quantumcollocation_tpu_torch import bench_util as bu\n"
        "p = qt.UnitarySmoothPulseProblem(qt.QuantumSystem(qt.GATES['Z'], "
        "[qt.GATES['X'], qt.GATES['Y']]), qt.GATES['H'], 7, 0.2, "
        "piccolo_options=qt.PiccoloOptions(verbose=False), "
        "rng=np.random.default_rng(0), device='cpu')\n"
        "r = p.solve_batched(p.initial_decision(2), max_iter=1)\n"
        "d = bu.density_problem(T=7, device='cpu')\n"
        "rd = d.solve_batched(bu.density_seeds(d, 2, 0), max_iter=1)\n"
        "assert d.nlp.analytic is None\n"
        "assert 'quantumcollocation_tpu' not in sys.modules\n"
        "print('ok', int(r.n_iter[0]), int(rd.n_iter[0]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "1", "1"]


def test_source_imports_neither_jax_nor_the_jax_package():
    imports = re.compile(
        r"^\s*(import|from)\s+(jax\b|quantumcollocation_tpu\b(?!_torch))", re.M
    )
    dynamic = re.compile(r"(import_module|__import__)\(\s*[\"'](jax|quantumcollocation_tpu\b(?!_torch))")
    files = list((ROOT / "quantumcollocation_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        text = f.read_text()
        assert not imports.search(text), f
        assert not dynamic.search(text), f
