"""The benchmark's own tests: run from the repository root,
`python -m pytest ronbench/tests -q`. Tests that need a card carry the
`cuda` marker and decide inside the test whether one is present."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
