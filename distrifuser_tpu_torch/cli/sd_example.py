"""One SD 1.x / 2.x generation at the reference's sd_example point: 512 x 512,
guidance 7.5, ``stale_gn`` (counterpart of scripts/sd_example.py):

    python -m distrifuser_tpu_torch.cli.sd_example --model_path /path/to/sd-v1-5
"""

import sys

from .common import run_example


def main(argv=None) -> int:
    return run_example("sd", argv)


if __name__ == "__main__":
    sys.exit(main())
