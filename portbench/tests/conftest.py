"""The benchmark's tests import ``portbench`` from the root of the checkout
and ``tiny`` from here."""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parents[1], HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
