"""``python -m planeverb_tpu_torch`` — sandbox CLI entry point."""

import sys

from planeverb_tpu_torch.sandbox.cli import main

if __name__ == "__main__":
    sys.exit(main())
