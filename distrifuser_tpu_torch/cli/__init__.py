"""Command-line scripts of the port: the counterparts of scripts/sdxl_example.py,
scripts/sd_example.py, scripts/dit_example.py, scripts/sd3_example.py and
scripts/run_sdxl.py.

    python -m distrifuser_tpu_torch.cli.sdxl_example --random_weights
    python -m distrifuser_tpu_torch.cli.sd_example --model_path /path/to/sd-v1-5
    python -m distrifuser_tpu_torch.cli.dit_example --model /path/to/PixArt-XL-2-1024-MS
    python -m distrifuser_tpu_torch.cli.sd3_example --model_path /path/to/sd3-medium
    torchrun --nproc_per_node 4 -m distrifuser_tpu_torch.cli.run_sdxl \\
        --random_weights --mode benchmark --output_type latent
"""
