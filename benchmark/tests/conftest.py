"""The benchmark's own tests run from the repository root, on the CPU at
a tiny size; those that need a CUDA card are marked ``gpu`` and skip
inside the test without one.  Nothing here imports JAX."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
