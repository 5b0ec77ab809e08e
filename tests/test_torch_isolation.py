"""The port stands alone: it imports nothing of JAX or of the JAX
package, and its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train.loop import train  # noqa: E402
from repro_torch.train.orchestrator import run_myrmics_training  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "examples").glob("*_torch.py")))


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    assert path.exists(), path
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_importing_every_port_module_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=120)
    assert r.returncode == 0, r.stderr


ENTRY_POINTS = {
    "LM": lambda cfg, tmp: LM(cfg),
    "ServingEngine": lambda cfg, tmp: ServingEngine(cfg),
    "train": lambda cfg, tmp: train(cfg, steps=1, ckpt_dir=str(tmp)),
    "run_myrmics_training": lambda cfg, tmp: run_myrmics_training(cfg, steps=1),
    "launch.train": lambda cfg, tmp: launch_train.main(
        ["--arch", "qwen2_0_5b", "--steps", "1", "--ckpt-dir", str(tmp)]),
    "launch.serve": lambda cfg, tmp: launch_serve.main(["--arch", "qwen2_0_5b"]),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(name, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["prog"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name](get_config("qwen2_0_5b").smoke(), tmp_path / "ckpt")
    assert not (tmp_path / "ckpt").exists()      # raised before touching the disk


def test_cpu_only_when_asked():
    assert LM(get_config("qwen2_0_5b").smoke(), device="cpu").device.type == "cpu"


def test_non_dense_families_name_their_roadmap_item():
    for arch in ("llama32_vision_90b", "granite_moe_3b", "whisper_base"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            LM(get_config(arch).smoke(), device="cpu")


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "zamba2_2_7b"])
def test_ssm_families_construct_and_a_bf16_scan_names_its_roadmap_item(arch):
    assert LM(get_config(arch).smoke(), device="cpu").cfg.family in ("ssm", "hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP.md .*SSM training"):
        LM(replace(get_config(arch).smoke(), ssm_scan_dtype="bfloat16"), device="cpu")


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    """A tensor that is not on the CPU never reaches the plain version:
    here a meta tensor is refused, as a CUDA tensor without a kernel
    would be."""
    q = torch.empty((1, 8, 2, 32), device="meta")
    k = torch.empty((1, 8, 1, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q[:, :1], k, k, torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_bwd(q, k, k, q, q, torch.empty((1, 2, 8), device="meta"), True)
    x = torch.empty((1, 8, 16), device="meta")
    A, bc = torch.empty((16, 4), device="meta"), torch.empty((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan(x, x, A, bc, bc, torch.empty((16,), device="meta"))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build, "BUILD_ROOT", Path("/nonexistent/build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
