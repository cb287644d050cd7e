"""``python -m kvedge_torch serve|train|eval ...`` (see ``cli.py``)."""

import sys

from kvedge_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
