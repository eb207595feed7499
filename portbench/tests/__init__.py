"""CPU tests of the benchmark (``pytest portbench/tests``); the card's tests
carry the ``gpu`` marker and skip without a card."""
import pathlib
import sys

_SRC = str(pathlib.Path(__file__).resolve().parents[2] / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
