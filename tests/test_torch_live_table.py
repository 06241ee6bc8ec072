"""Port parity: the live iteration table (print_level >= 5).

The same T=11 Hadamard problem solved through each package's
problem.solve at print_level 5, float64 on the CPU (the JAX side on its
XLA KKT backend): the header line exactly, and every row's numbers parsed
back and held to within one unit of the last digit the row prints (the
iterates agree to far below that, tests/test_torch_solve.py); the
iteration and line-search counts exactly.
"""

import re

import numpy as np
import torch
from jax_reference import unoptimized_jax_compiles  # noqa: F401 (an autouse fixture)

import quantumcollocation_tpu as qct
import quantumcollocation_tpu_torch as qt
from quantumcollocation_tpu_torch import interop

# small tensors: one intra-op thread, so a CPU test run with several
# workers does not oversubscribe the cores its other tests share
torch.set_num_threads(1)

HEADER = ("iter      objective    inf_pr    inf_du  lg(mu)     ||d||  lg(rg)  alpha_du  "
          "alpha_pr  ls")


def _table(out):
    lines = out.splitlines()
    start = lines.index(next(line for line in lines if line.lstrip().startswith("iter")))
    rows = []
    for line in lines[start + 1:]:
        if not re.match(r"^\s*\d+\s", line):
            break
        rows.append(line)
    return lines[start], rows


def _unit(token):
    """One unit of the last printed digit of a number token."""
    mant, _, exp = token.partition("e")
    decimals = len(mant.partition(".")[2])
    return 10.0 ** (-decimals + (int(exp) if exp else 0))


def test_live_table_matches_jax(capsys):
    opts = dict(print_level=5, tol=1e-6, line_search="filter")
    pj = qct.UnitarySmoothPulseProblem(
        qct.QuantumSystem(qct.GATES["Z"], [qct.GATES["X"], qct.GATES["Y"]]), qct.GATES["H"], 11,
        0.2, Q=100.0, R=1e-2, ipopt_options=qct.SolverOptions(kkt_backend="xla", **opts),
        piccolo_options=qct.PiccoloOptions(verbose=False), rng=np.random.default_rng(0),
    )
    pt, _ = interop.unitary_smooth_pulse_from_arrays(
        interop.problem_arrays(pj), Q=100.0, R=1e-2, ipopt_options=qt.SolverOptions(**opts),
        piccolo_options=qt.PiccoloOptions(verbose=False), device="cpu",
    )
    capsys.readouterr()
    pj.solve(max_iter=6)
    head_j, rows_j = _table(capsys.readouterr().out)
    pt.solve(max_iter=6)
    head_t, rows_t = _table(capsys.readouterr().out)
    assert head_t == head_j == HEADER
    assert len(rows_t) == len(rows_j) == 6
    for k, (rt, rj) in enumerate(zip(rows_t, rows_j)):
        tt, tj = rt.split(), rj.split()
        assert len(tt) == len(tj) == 10, (rt, rj)
        assert (tt[0], tt[-1]) == (tj[0], tj[-1]) == (str(k), tj[-1]), (rt, rj)
        for a, b in zip(tt[1:-1], tj[1:-1]):
            if b == "-":  # lg(rg) without regularization
                assert a == b, (rt, rj)
                continue
            assert abs(float(a) - float(b)) <= 1.01 * _unit(b), (rt, rj)
