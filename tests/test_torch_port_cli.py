"""PyTorch port: the command-line scripts (distrifuser_tpu_torch/cli/).

Their flags are the JAX scripts' flags (scripts/common.py
``add_distri_args``, and run_sdxl.py's own, read from its source) plus
``--device``, with the same defaults and choices; each builds the config
the JAX script builds or is refused before a model loads; on the CPU at
the tiny size the benchmark mode prints its trimmed-mean latency line
(also at two gloo ranks under torchrun), the SD example runs img2img from
an image file, and ``--profile_dir`` writes a trace.
"""

import argparse
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from distrifuser_tpu_torch.cli import common, run_sdxl, sd_example, sdxl_example

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))

import common as jax_common  # noqa: E402

TINY = ["--device", "cpu", "--random_weights", "--tiny_model", "--image_size", "128",
        "--num_inference_steps", "2"]


def _actions(parser):
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings
            and a.option_strings[0] != "-h"}


def _jax_run_sdxl_flags():
    """The flags scripts/run_sdxl.py adds beside ``add_distri_args``."""
    tree = ast.parse((ROOT / "scripts" / "run_sdxl.py").read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"}


def test_flags_equal_the_jax_scripts_plus_device():
    jax_parser, port_parser = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_common.add_distri_args(jax_parser)
    common.add_distri_args(port_parser)
    want, got = _actions(jax_parser), _actions(port_parser)
    assert set(got) == set(want) | {"--device"}
    for flag, action in want.items():
        assert (got[flag].default, got[flag].choices, got[flag].nargs, got[flag].type) == (
            action.default, action.choices, action.nargs, action.type), flag
    run_flags = set(_actions(run_sdxl.build_parser()))
    assert run_flags == set(want) | _jax_run_sdxl_flags() | {"--device"}
    assert _jax_run_sdxl_flags() == {"--mode", "--warmup_times", "--test_times",
                                     "--ignore_ratio", "--profile_dir", "--dump_hlo"}


def _config(argv):
    parser = argparse.ArgumentParser()
    common.add_distri_args(parser)
    return common.config_from_args(parser.parse_args(argv), parser.error)


def test_config_from_flags():
    cfg = _config(["--device", "cpu"])
    assert (cfg.height, cfg.width, cfg.do_classifier_free_guidance, cfg.mode,
            cfg.use_cuda_graph, cfg.vae_sp, cfg.dtype) == (
        1024, 1024, True, "corrected_async_gn", True, True, torch.float32)
    cfg = _config(["--device", "cpu", "--guidance_scale", "1", "--image_size", "512",
                   "--no_cuda_graph", "--no_vae_sp", "--weight_quant", "int8",
                   "--sync_mode", "stale_gn", "--warmup_steps", "2", "--batch_size", "2",
                   "--hybrid_loop"])
    assert (cfg.height, cfg.width, cfg.do_classifier_free_guidance, cfg.mode,
            cfg.use_cuda_graph, cfg.vae_sp, cfg.weight_quant, cfg.quant_compute,
            cfg.warmup_steps, cfg.batch_size) == (
        512, 512, False, "stale_gn", False, False, "int8", "auto", 2, 2)
    cfg = _config(["--device", "cpu", "--image_size", "768", "512"])
    assert (cfg.height, cfg.width) == (768, 512)


@pytest.mark.parametrize("flags", [
    ["--attn_impl", "ring"],
    ["--comm_compress", "int8"],
    ["--comm_compress", "int8_residual", "--refresh_fraction", "0.5"],
    ["--comm_batch", "--comm_compress", "fp8"],
])
def test_comm_knob_flags_pass_through_as_in_the_jax_scripts(flags):
    parser = argparse.ArgumentParser()
    jax_common.add_distri_args(parser)
    want = jax_common.config_from_args(parser.parse_args(flags))
    got = _config(["--device", "cpu"] + flags)
    for name in ("attn_impl", "comm_batch", "comm_compress", "refresh_fraction"):
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("flags, message", [
    (["--dump_hlo", "x.hlo"], "no HLO"),
    (["--attn_impl", "usp", "--ulysses_degree", "2"], "must divide the sp degree"),
    (["--attn_impl", "ulysses"], "DiT strategy"),
    (["--pipe_patches", "4"], "no pipeline to stream patches through"),
    (["--refresh_fraction", "0.3"], "1/k"),
    (["--comm_batch", "--refresh_fraction", "0.5"], "mutually exclusive"),
    (["--dp_degree", "2"], "must divide world size 1"),
    (["--scheduler", "flow-euler"], "'flow-euler' on DistriSDXLPipeline"),
    (["--parallelism", "pipefusion"], "DiT strategy"),
    (["--device", "cpu"], "--random_weights"),
])
def test_refused_flags(capsys, flags, message):
    argv = flags if "--random_weights" in message else TINY + flags
    with pytest.raises(SystemExit) as e:
        run_sdxl.main(argv)
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_benchmark_mode_prints_trimmed_mean(capsys):
    assert run_sdxl.main(TINY + ["--mode", "benchmark", "--warmup_times", "1",
                                 "--test_times", "5", "--ignore_ratio", "0.4",
                                 "--output_type", "latent"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and lines[0].startswith("Latency: ")
    assert lines[0].endswith("s (trimmed mean of 3/5 runs)")
    assert float(lines[0].split()[1]) > 0


@pytest.mark.parametrize("n, ratio, kept", [(20, 0.2, 16), (3, 0.2, 3), (5, 0.4, 3),
                                            (2, 1.0, 2)])
def test_trimmed_mean_follows_the_reference(n, ratio, kept):
    lat = list(np.random.RandomState(n).rand(n))
    mean, k = run_sdxl.trimmed_mean(lat, ratio)
    trim = int(n * ratio / 2)
    ref = sorted(lat)[trim:n - trim] or sorted(lat)
    assert k == kept == len(ref) and mean == pytest.approx(sum(ref) / len(ref))


def test_examples_generate_and_img2img(tmp_path):
    from PIL import Image

    init = tmp_path / "init.png"
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype(np.uint8)).save(init)
    out = tmp_path / "sd.png"
    assert sd_example.main(TINY + ["--init_image", str(init), "--strength", "0.5",
                                   "--num_inference_steps", "4",
                                   "--output_path", str(out)]) == 0
    assert Image.open(out).size == (32, 32)
    assert (tmp_path / "sd.WEIGHTLESS_TOKENIZER.txt").exists()
    out = tmp_path / "xl.png"
    assert sdxl_example.main(TINY + ["--num_images_per_prompt", "2",
                                     "--output_path", str(out)]) == 0
    assert Image.open(tmp_path / "xl_0.png").size == Image.open(tmp_path / "xl_1.png").size
    with pytest.raises(FileNotFoundError):  # the image is read before the model
        sd_example.main(TINY + ["--init_image", str(tmp_path / "missing.png")])


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    assert run_sdxl.main(TINY + ["--profile_dir", str(tmp_path), "--output_type", "latent",
                                 "--num_inference_steps", "1"]) == 0
    assert (tmp_path / "trace_rank0.json").stat().st_size > 0
    assert "trace written to" in capsys.readouterr().out


def test_torchrun_two_cpu_ranks():
    """``torchrun`` at two gloo ranks (CFG 2 x sp 1): rank 0 prints the
    latency line, once."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "distrifuser_tpu_torch.cli.run_sdxl", *TINY,
           "--mode", "benchmark", "--warmup_times", "0", "--test_times", "2",
           "--output_type", "latent"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert [line for line in out.stdout.splitlines() if line.startswith("Latency: ")
            ] and out.stdout.count("Latency: ") == 1
