"""One SDXL generation (counterpart of scripts/sdxl_example.py):

    python -m distrifuser_tpu_torch.cli.sdxl_example --model_path /path/to/sdxl-base-1.0
"""

import sys

from .common import run_example


def main(argv=None) -> int:
    return run_example("sdxl", argv)


if __name__ == "__main__":
    sys.exit(main())
