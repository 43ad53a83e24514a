"""SDXL generation or latency benchmark (counterpart of scripts/run_sdxl.py).

``--mode benchmark`` keeps the reference's protocol: ``--warmup_times``
untimed runs, then ``--test_times`` timed runs, each ended by
``torch.cuda.synchronize()`` on the card; the latencies are sorted, the
``--ignore_ratio`` share of them trimmed off the two ends, and rank 0
prints the mean of the rest.  ``--output_type latent`` leaves the VAE
decode out, as the reference's benchmark does.  ``--profile_dir`` writes a
``torch.profiler`` trace (Chrome trace format) of one generation per rank,
after one untimed one; ``--dump_hlo`` is refused: the port compiles no HLO.

    python -m distrifuser_tpu_torch.cli.run_sdxl --random_weights --mode benchmark
    torchrun --nproc_per_node 4 -m distrifuser_tpu_torch.cli.run_sdxl \\
        --random_weights --mode benchmark --output_type latent
"""

import argparse
import os
import sys
import time

import torch

from .common import (add_distri_args, config_from_args, finish_distributed,
                     generation_kwargs, img2img_kwargs, init_distributed,
                     is_main_process, load_pipeline, save_images)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_distri_args(parser)
    parser.add_argument("--mode", type=str, default="generation",
                        choices=["generation", "benchmark"])
    parser.add_argument("--warmup_times", type=int, default=5)
    parser.add_argument("--test_times", type=int, default=20)
    parser.add_argument("--ignore_ratio", type=float, default=0.2)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of one generation here "
                        "(trace_rank<r>.json, Chrome trace format)")
    parser.add_argument("--dump_hlo", type=str, default=None,
                        help="refused: the port compiles no HLO (its UNet steps are "
                        "CUDA graphs)")
    return parser


def trimmed_mean(latencies, ignore_ratio):
    """(mean of the sorted latencies without ``ignore_ratio`` of them,
    half at each end; runs kept)."""
    latencies = sorted(latencies)
    trim = int(len(latencies) * ignore_ratio / 2)
    kept = latencies[trim:len(latencies) - trim] or latencies
    return sum(kept) / len(kept), len(kept)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.dump_hlo:
        parser.error("--dump_hlo: the port compiles no HLO (its UNet steps are CUDA "
                     "graphs); --profile_dir writes a torch.profiler trace instead")
    i2i = img2img_kwargs(args)  # a bad path fails before the model loads
    init_distributed(args.device)
    try:
        cfg = config_from_args(args, parser.error)
        pipeline = load_pipeline("sdxl", args, cfg, parser.error)
        call = generation_kwargs(args, i2i)

        def sync():
            if cfg.device.type == "cuda":
                torch.cuda.synchronize(cfg.device)

        def run(seed):
            out = pipeline(seed=seed, **call)
            sync()
            return out

        if args.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            run(args.seed)  # capture and first-call work outside the trace
            activities = [ProfilerActivity.CPU]
            if cfg.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                run(args.seed)
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, f"trace_rank{cfg.rank}.json")
            prof.export_chrome_trace(path)
            if is_main_process():
                print(f"trace written to {path}")

        if args.mode == "generation":
            save_images(run(args.seed), args)
        else:
            for _ in range(args.warmup_times):
                run(args.seed)
            latencies = []
            for i in range(args.test_times):
                t0 = time.perf_counter()
                run(args.seed + i)
                latencies.append(time.perf_counter() - t0)
            mean, kept = trimmed_mean(latencies, args.ignore_ratio)
            if is_main_process():
                print(f"Latency: {mean:.5f} s (trimmed mean of {kept}/{len(latencies)} "
                      "runs)", flush=True)
        del pipeline  # graphs holding NCCL work go before the process group
    finally:
        finish_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
