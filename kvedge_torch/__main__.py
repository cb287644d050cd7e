"""``python -m kvedge_torch serve ...`` (see ``runtime/serve.py``)."""

import sys

from kvedge_torch.runtime.serve import main

if __name__ == "__main__":
    sys.exit(main())
