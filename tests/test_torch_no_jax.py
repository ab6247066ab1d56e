"""The PyTorch port stands alone: it imports no JAX, and its entry points
run on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from deep_recommenders_torch.datasets import default_movielens_features
from deep_recommenders_torch.device import resolve_device
from deep_recommenders_torch.examples import (
    train_deepfm_on_movielens,
    train_transformer_on_imdb,
)
from deep_recommenders_torch.models.ranking import DeepFM
from deep_recommenders_torch.training import DeviceData, Trainer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import pkgutil, sys
import deep_recommenders_torch
for m in pkgutil.walk_packages(deep_recommenders_torch.__path__,
                               "deep_recommenders_torch."):
    __import__(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                    "deep_recommenders_tpu"))
print(len([m for m in sys.modules if m.startswith("deep_recommenders_torch")]))
assert not bad, bad
for name in ("ops.retrieval", "ops.topk", "models.retrieval.two_tower",
             "models.retrieval.factorized_top_k",
             "examples.train_two_tower_on_movielens", "parallel",
             "parallel.distributed", "parallel.mesh", "parallel.sharding",
             "embedding.sharded", "native"):
    assert "deep_recommenders_torch." + name in sys.modules, name
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=_ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 60  # every module was imported


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    model = DeepFM(default_movielens_features(), embedding_dim=4,
                   hidden=(4,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, torch.optim.Adam(model.parameters()))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceData.from_numpy({"a": np.zeros(4, np.int32)},
                              np.zeros((4, 1), np.float32), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_deepfm_on_movielens.main(["--num-ratings", "100"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_transformer_on_imdb.main(["--epochs", "1"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_fails_without_cuda(no_cuda, capsys):
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_example_runs_on_cpu_when_asked(capsys):
    result = train_deepfm_on_movielens.main([
        "--num-ratings", "3000", "--epochs", "1", "--batch-size", "256",
        "--embedding-dim", "4", "--device", "cpu",
    ])
    assert len(result["history"]) == 1
    assert 0.0 <= result["history"][0]["auc"] <= 1.0
    assert "final: auc=" in capsys.readouterr().out
