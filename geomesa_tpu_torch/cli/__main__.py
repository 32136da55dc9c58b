"""``python -m geomesa_tpu_torch.cli`` — the tools runner entry point
(tools/Runner.scala:21-26 analog)."""

import sys

from .main import main

if __name__ == "__main__":
    sys.exit(main())
