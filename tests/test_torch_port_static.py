"""PyTorch port: import hygiene and device resolution.

The port and ``chip_smoke.py`` must import neither ``jax`` nor the JAX
package (an AST walk over every source), and the port must refuse to run
quietly on the CPU when no card is present.
"""

import ast
from pathlib import Path

import pytest
import torch

from distrifuser_tpu_torch import DistriConfig
from distrifuser_tpu_torch.utils.env import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "distrifuser_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "distrifuser_tpu", "tests")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def test_port_has_sources():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "flash_attention.py", "quant_matmul.py", "unet.py",
            "pipelines.py"} <= names
    for source in ("flash_attention.cu", "quant_matmul.cu"):
        assert (ROOT / "distrifuser_tpu_torch" / "csrc" / source).exists()


def test_config_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistriConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


def test_config_cpu_defaults_and_refusals(monkeypatch):
    cfg = DistriConfig(device="cpu")
    assert cfg.device == torch.device("cpu") and cfg.dtype == torch.float32
    assert not cfg.cfg_split and (cfg.latent_height, cfg.latent_width) == (128, 128)
    monkeypatch.setenv("WORLD_SIZE", "2")  # one of two torchrun ranks
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        DistriConfig(device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(ValueError, match="mode"):
        DistriConfig(device="cpu", mode="bogus")
    with pytest.raises(ValueError, match="parallelism"):
        DistriConfig(device="cpu", parallelism="bogus")
    with pytest.raises(ValueError, match="multiples of 8"):
        DistriConfig(device="cpu", height=1001)


def test_flash_wrapper_rejects_non_cuda_non_cpu_device():
    from distrifuser_tpu_torch.ops.flash_attention import flash_sdpa

    q = torch.zeros(1, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_sdpa(q, q, q, heads=1)
