"""Rules of the PyTorch port: it imports neither JAX nor the JAX package,
and it never falls back from the card to the CPU (kernel wrappers, forward
and backward, and the entry points)."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference_package(path):
    assert path.exists(), path
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in BANNED, f"{path.relative_to(ROOT)} imports {mod}"


def test_cuda_impl_never_falls_back_to_cpu():
    from repro_torch.kernels.flash_attention import flash_attention_fwd_cuda
    from repro_torch.kernels.ops import FlashConfig

    with pytest.raises(ValueError, match="needs CUDA tensors"):
        FlashConfig(impl="cuda").resolve_impl(torch.device("cpu"))
    assert FlashConfig(impl="auto").resolve_impl(torch.device("cpu")) == "torch"
    assert FlashConfig(impl="auto").resolve_impl(torch.device("cuda", 0)) == "cuda"
    x = torch.zeros((1, 4, 1, 32))
    p = torch.zeros((1, 4), dtype=torch.int32)
    before = flash_attention_fwd_cuda.launches
    with pytest.raises(ValueError, match="must be on"):
        flash_attention_fwd_cuda(x, x, x, p, p, causal=True, window=None, scale=1.0)
    assert flash_attention_fwd_cuda.launches == before


@pytest.mark.parametrize("name", ["flash_attention_bwd_dq_cuda", "flash_attention_bwd_dkv_cuda"])
def test_backward_wrappers_never_fall_back_to_cpu(name):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    wrapper = getattr(fa, name)
    x = torch.zeros((1, 4, 1, 32))
    p = torch.zeros((1, 4), dtype=torch.int32)
    rows = torch.zeros((1, 4, 1))
    before = wrapper.launches
    with pytest.raises(ValueError, match="must be on"):
        wrapper(x, x, x, p, p, x, rows, rows, rows, causal=True, window=None, scale=1.0)
    assert wrapper.launches == before
    # impl="cuda" through the autograd Function refuses CPU tensors as well
    q = x.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.flash_attention(q, x, x, causal=True, impl="cuda")
    assert wrapper.launches == before


def test_engine_on_cuda_without_a_card_raises(monkeypatch):
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import ParallelContext
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServingEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["qwen3-1.7b"].reduced(n_layers=1, d_model=64, n_heads=2, n_kv_heads=2,
                                      d_head=32, d_ff=64, vocab_size=31)
    bundle = build_model(cfg, ParallelContext(device="cpu"))
    params = bundle.init(0)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        ServingEngine(bundle, params, max_batch=1, max_len=16, device="cuda")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        from repro_torch.launch.serve import main

        main(["--reduced"])
