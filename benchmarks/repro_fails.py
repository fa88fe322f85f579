"""Dev repro for the round-1 failing cases:
truck_trailer, swimmer, GL2 on free-t0/tf Mayer. Run on CPU for a fast loop.

Usage: python benchmarks/repro_fails.py [names...] [grid=N] [scheme='name'] [opt=val...]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import os, sys, time

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import ctdirect_tpu as ct
from ctdirect_tpu.solver.interface import solve_docp
from ctdirect_tpu.solver.ipm import IPMOptions
from ctdirect_tpu.problems import get_problem

CASES = {
    "truck_trailer": 59.28,
    "swimmer": 0.984273,
    "double_integrator_freet0tf": 8.0,
}

args = sys.argv[1:] or list(CASES)
extra, meta = {}, {"grid": 100, "scheme": "trapeze"}
for kv in [a for a in args if "=" in a]:
    k, v = kv.split("=", 1)
    (meta if k in meta else extra)[k] = eval(v)
which = [a for a in args if "=" not in a]

for name in which:
    target = CASES.get(name)
    p = get_problem(name)
    grid = meta["grid"]
    scheme = meta["scheme"]
    if name == "double_integrator_freet0tf":
        grid, scheme = 25, "gauss_legendre_2"
    d = ct.transcribe(p.ocp, grid_size=grid, scheme=scheme)
    o = IPMOptions(tol=1e-6, max_iter=1000, **extra)
    t0 = time.time()
    s = solve_docp(d, init=p.init, options=o)
    dt = time.time() - t0
    tref = target if target is not None else s.objective
    ok = "OK " if (s.successful and abs(s.objective - tref) <= 1e-2 * abs(tref)) else "FAIL"
    print(
        f"{ok} {name:32s} grid={grid} {scheme} obj={s.objective:.6f} target={target} "
        f"it={s.iterations} status={s.message} viol={s.constraints_violation:.2e} {dt:.1f}s",
        flush=True,
    )
