"""The harness's modules and the program importable from the tests."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for path in (str(BENCH), str(BENCH.parent)):
    if path not in sys.path:
        sys.path.insert(0, path)
