"""The port's CTR examples on the CPU at a tiny size (``--device cpu``):
FM writes a checkpoint, FNN restores it and warm-starts (or trains from
scratch without one), Wide & Deep trains with its crosses under FTRL and
Adam, and DeepFM trains with ``--bf16``; without a card each raises unless
asked for the CPU."""

import numpy as np
import pytest
import torch

from deep_recommenders_torch.examples import (
    train_deepfm_on_movielens,
    train_fm_on_movielens,
    train_fnn_on_movielens,
    train_wdl_on_movielens,
)
from deep_recommenders_torch.training import restore_checkpoint

TINY = ["--num-ratings", "3000", "--epochs", "1", "--batch-size", "256",
        "--embedding-dim", "4", "--device", "cpu"]


def _trained(result):
    assert len(result["history"]) == 1
    assert 0.0 <= result["history"][0]["auc"] <= 1.0
    assert np.isfinite(result["step_losses"]).all()


def test_fm_then_fnn_warm_started(tmp_path, capsys):
    path = str(tmp_path / "fm")
    fm = train_fm_on_movielens.main(TINY + ["--export", path])
    _trained(fm)
    state = restore_checkpoint(fm["checkpoint"])
    assert state["embeddings.table"].shape == (10044, 4)
    fnn = train_fnn_on_movielens.main(TINY + ["--warm-up-from", path])
    _trained(fnn)
    assert fnn["warm_started"]
    out = capsys.readouterr().out
    assert "exported FM params" in out and "warm-started from" in out


def test_fnn_trains_from_scratch_without_a_checkpoint(tmp_path, capsys):
    result = train_fnn_on_movielens.main(
        TINY + ["--warm-up-from", str(tmp_path / "missing")])
    _trained(result)
    assert not result["warm_started"]
    assert "training from scratch" in capsys.readouterr().out


def test_wdl_example_with_crosses_and_ftrl(capsys):
    result = train_wdl_on_movielens.main(TINY)
    _trained(result)
    assert 0.0 < result["wide_sparsity"] <= 1.0  # L1 0.5 zeroes weights
    assert "wide-weight sparsity (FTRL L1)" in capsys.readouterr().out


def test_deepfm_example_bf16(capsys):
    result = train_deepfm_on_movielens.main(TINY + ["--bf16"])
    _trained(result)
    assert "final: auc=" in capsys.readouterr().out


@pytest.mark.parametrize("example", [train_fm_on_movielens,
                                     train_fnn_on_movielens,
                                     train_wdl_on_movielens])
def test_examples_default_to_the_card(monkeypatch, example):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--num-ratings", "100"])
