"""The port stands alone: importing every ``repro_torch`` module pulls in
neither JAX nor the JAX package, and entry points default to the card."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_import_pulls_in_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.fixture
def no_card(monkeypatch):
    """Entry points must refuse to run when no card is present, whatever
    machine the test runs on."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_card, tmp_path):
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.model import build_model

    cfg = get_arch("qwen2.5-3b-smoke")
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        lm.init_decode_state(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        params_from_jax({"embed": [[0.0]], "layers": {}})
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        serve.main(["--arch", "qwen2.5-3b-smoke"])
    from repro_torch.launch import steps, train
    from repro_torch.optim.optimizers import OptConfig
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        steps.init_train_state(cfg, OptConfig())
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(["--arch", "qwen2.5-3b-smoke"])
    ckpt_dir = tmp_path / "ckpt"
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train.main(["--arch", "qwen2.5-3b-smoke", "--ckpt-dir",
                    str(ckpt_dir), "--ckpt-every", "2", "--fail-at", "1",
                    "--resume"])
    assert not ckpt_dir.exists()
    import torch.distributed as dist
    from repro_torch.distributed.fault_tolerance import ElasticPlan
    from repro_torch.launch.mesh import make_mesh_for
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        make_mesh_for(1)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ElasticPlan(1, 1).make_mesh()
    assert not dist.is_initialized()
    from repro_torch.caffe import Net, Solver, lenet_mnist, \
        lenet_mnist_solver
    from repro_torch.convert import caffe_params_from_jax
    from repro_torch.data.synthetic import (ImageStream, ImageStreamSpec,
                                            mnist_like)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        Net(lenet_mnist()).init(gen, 4)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        Solver(Net(lenet_mnist()), lenet_mnist_solver()).init(gen)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        ImageStream(ImageStreamSpec((1, 28, 28), 10, 4))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        mnist_like(4)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        caffe_params_from_jax({"ip": {"w": [[0.0]]}})


def test_build_needs_no_toolchain_at_import():
    """The kernel library's name is a hash of the sources; nothing is built
    or probed until the first launch on a CUDA tensor."""
    from repro_torch.kernels import _build

    assert {p.name for p in _build.sources()} == {
        "gemm.cu", "gemm_tc.cu", "gemm_f32.cu", "rmsnorm.cu", "eltwise.cu",
        "flash_attention.cu", "flash_attention_bwd.cu",
        "flash_attention_bwd_tc.cu", "flash_attention_tc.cu",
        "flash_decode_split.cu", "flash_chunk_tc.cu", "ssd_scan.cu",
        "im2col.cu", "pooling.cu", "softmax_xent.cu", "conv_direct.cu",
        "page_copy.cu"}
    assert _build._LIB is None
    assert _build.library_path().parent == _build.BUILD_DIR
