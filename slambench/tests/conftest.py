"""The benchmark's own tests: python -m pytest slambench/tests -q (from the
repository root; the tests marked `cuda` skip without a card)."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (BENCH, os.path.dirname(BENCH)):
    if path not in sys.path:
        sys.path.insert(0, path)
