"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository's root (the ``gpu`` marker is registered in its pytest.ini)."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)
