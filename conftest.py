"""Session config for the whole tree: one thread budget for every test
process.

torch's intra-op pool is OpenMP's, and OpenMP sizes it from
``OMP_NUM_THREADS`` when torch first loads.  Left unset, each process takes
every core, so the xdist workers and the processes that tests spawn (gloo
ranks, launchers, killed-and-restarted children) oversubscribe the machine
against each other and against the reference's JAX tests.  This file is
loaded before any test module imports torch; the workers and every process
they spawn inherit the variable.  A value that the caller has set wins.

Two threads, not one: the whole tier-1 run (six workers on eight cores)
took 983-1 039 s with two and 1 014-1 125 s with one.
"""
import os

THREADS = 2

os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
