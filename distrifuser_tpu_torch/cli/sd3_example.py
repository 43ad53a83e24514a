"""One SD3 (MMDiT) generation at the published point: flow-euler, guidance
7, 28 steps (counterpart of scripts/sd3_example.py):

    python -m distrifuser_tpu_torch.cli.sd3_example --model_path /path/to/sd3-medium
    python -m distrifuser_tpu_torch.cli.sd3_example --device cpu --random_weights \\
        --tiny_model --image_size 256 256 --num_inference_steps 4

``--random_weights`` without ``--tiny_model`` builds SD3-medium's widths
(the MMDiT, CLIP-L and bigG, the SD3 VAE; no T5) with seeded random
weights; ``--init_image`` runs img2img through the flow ``add_noise``.
"""

import sys

from .common import family_parser, run_example


def build_parser():
    return family_parser("sd3", prompt="a photo of an astronaut riding a horse on mars")


def main(argv=None) -> int:
    return run_example("sd3", argv, build_parser())


if __name__ == "__main__":
    sys.exit(main())
