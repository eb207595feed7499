"""``python -m repro_torch.check [--device cpu]``: the port's contract
gate (see ``cli``)."""
import sys

from repro_torch.check.cli import main

if __name__ == "__main__":
    sys.exit(main())
