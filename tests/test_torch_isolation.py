"""The PyTorch port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` pulls in neither JAX nor the JAX package, and the entry
points refuse to run without a CUDA device unless asked for the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import configs
from repro_torch.cache import DiffusionPipeline
from repro_torch.convert import params_from_numpy
from repro_torch.core import diffusion, executor, solvers
from repro_torch.data import synthetic
from repro_torch.launch import serve, serve_diffusion

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
need = {"repro_torch.launch.serve", "repro_torch.kernels.ssd",
        "repro_torch.models.ssm", "repro_torch.configs.mamba2_1p3b",
        "repro_torch.serve.engine", "repro_torch.slo.policy",
        "repro_torch.obs.tracer", "repro_torch.launch.serve_diffusion",
        "repro_torch.core.fused", "repro_torch.core.cuda_graphs",
        "repro_torch.configs.opensora_v12", "repro_torch.data.synthetic",
        "repro_torch.core.solvers", "repro_torch.configs.qwen3_14b",
        "repro_torch.kernels.products", "repro_torch.configs.gemma2_9b",
        "repro_torch.configs.minicpm3_4b", "repro_torch.models.rglru",
        "repro_torch.kernels.rglru", "repro_torch.configs.recurrentgemma_2b"}
print("MISSING", sorted(need - set(sys.modules)))
"""


def test_no_jax_and_no_reference_package_imported():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    assert "MISSING []" in out.stdout, out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_points_raise_without_cuda(no_cuda, device):
    cfg = configs.get("dit-xl-256", "smoke")
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.SmoothCacheExecutor(cfg, solvers.ddim(4), **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionPipeline(cfg, solvers.ddim(4), **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        diffusion.init_params(torch.Generator(), cfg, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros(2, np.float32)}, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device(device)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_diffusion.random_params(torch.Generator(), cfg, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_diffusion.main([*(["--device", device] if device else [])])


@pytest.mark.parametrize("device", [None, "cuda"])
def test_video_entry_points_raise_without_cuda(no_cuda, device):
    """The OpenSora path's entry points: the pipeline and executor with
    rectified flow, the parameters, and the synthetic text memory."""
    cfg = configs.get("opensora-v12", "smoke")
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="CUDA"):
        DiffusionPipeline(cfg, solvers.rectified_flow(4), cfg_scale=7.0,
                          **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        executor.SmoothCacheExecutor(cfg, solvers.rectified_flow(4), **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        diffusion.init_params(torch.Generator(), cfg, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.text_memory(torch.Generator(), 1, 8, cfg.cond_dim, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic.CondLatents(cfg.latent_shape, cfg.cond_dim, 8, 1).batch_at(
            0, **kw)
    pipe = DiffusionPipeline(cfg, solvers.rectified_flow(2), device="cpu")
    params = diffusion.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    mem = synthetic.text_memory(torch.Generator().manual_seed(1), 1, 8,
                                cfg.cond_dim, device="cpu")
    x = pipe.generate(params, torch.Generator().manual_seed(2), 1,
                      memory=mem)
    assert x.shape == (1,) + cfg.latent_shape and x.device.type == "cpu"


@pytest.mark.parametrize("device", [None, "cuda"])
def test_lm_entry_points_raise_without_cuda(no_cuda, device):
    cfg = configs.get("mamba2-1.3b", "smoke")
    kw = {} if device is None else {"device": device}
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.init_params(torch.Generator(), cfg, **kw)
    params = serve.init_params(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    prompts = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.generate(cfg, params, prompts, 2, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-1.3b", *(["--device", device]
                                               if device else [])])


def test_cpu_only_when_asked(no_cuda):
    cfg = configs.get("dit-xl-256", "smoke")
    ex = executor.SmoothCacheExecutor(cfg, solvers.ddim(4), device="cpu")
    assert ex.device.type == "cpu"
    params = diffusion.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
    assert all(a.device.type == "cpu"
               for a in params["backbone"]["stages"][0][0]["mixer"].values())
    lm = configs.get("mamba2-1.3b", "smoke")
    params = serve.init_params(torch.Generator().manual_seed(0), lm,
                               device="cpu")
    assert all(a.device.type == "cpu" for a in (
        params["embed"], params["stages"][0][0]["mixer"]["in_proj"],
        params["stages"][0][0]["mixer"]["out_norm"]["scale"]))
    out = serve.generate(lm, params, torch.zeros(1, 4, dtype=torch.long), 2,
                         device="cpu")
    assert out.shape == (1, 2) and out.device.type == "cpu"
