"""The port's training loop, checkpoints and `cli train` on the CPU, torch
only, at a tiny size: `train()` prints one JSON line per step, saves a
checkpoint at the end and resumes from it (weights, optimizer moments and
step restored exactly); CheckpointManager keeps the newest `max_to_keep`;
`cli train` runs on the CPU only when asked (no CUDA here: the default
device raises)."""

import json

import pytest
import torch

from infgen_torch import cli
from infgen_torch.config import Config
from infgen_torch.train.checkpoint import CheckpointManager
from infgen_torch.train.loop import OverfitDataset, SyntheticDataset, train
from infgen_torch.train.train_step import Trainer

from test_torch_layers import one_torch_thread  # noqa: F401 (autouse)

CFG = dict(max_agents=12, max_map_tokens=64, num_agent_layers=1,
           num_seed_layers=1, num_map_layers=1, hidden_dim=32, num_heads=2,
           head_dim=16, num_freq_bands=8, train_batch_size=2)


def test_train_resumes_from_its_checkpoint(tmp_path):
    cfg = Config(**CFG)
    data = OverfitDataset(SyntheticDataset(cfg, size=4), 2)
    lines = []
    first, hist = train(cfg, data, str(tmp_path), max_steps=2, device="cpu",
                        log_fn=lines.append)
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2

    back = Trainer(cfg, "cpu")
    assert ckpt.restore(back) == 2 and back.step == 2
    for a, b in zip(first.model.parameters(), back.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(first.optimizer.nu, back.optimizer.nu):
        assert torch.equal(a, b)
    assert back.optimizer.count == first.optimizer.count == 2

    lines.clear()
    _, hist = train(cfg, data, str(tmp_path), max_steps=3, device="cpu",
                    log_fn=lines.append)
    assert json.loads(lines[0]) == {"resumed_step": 2}
    assert [h["step"] for h in hist] == [3]
    assert ckpt.all_steps() == [2, 3]


def test_checkpoint_manager_keeps_newest(tmp_path):
    cfg = Config(**CFG)
    trainer = Trainer(cfg, "cpu")
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 5, 9):
        ckpt.save(step, trainer)
    assert ckpt.all_steps() == [5, 9] and ckpt.latest_step() == 9


def test_cli_train_on_cpu(tmp_path, capsys):
    path = tmp_path / "tiny.yaml"
    path.write_text("\n".join(f"{k}: {v}" for k, v in CFG.items()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", "--synthetic", "--config", str(path),
                      "--steps", "1"])
    cli.main(["train", "--synthetic", "--config", str(path), "--steps", "2",
              "--batch", "1", "--device", "cpu", "--pallas-attention"])
    *steps, summary = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(summary)
    assert len(steps) == 2 and summary["steps"] == 2
    assert summary["use_pallas_attention"] and summary["batch"] == 1
    # CPU: the plain twin, no launch; the recompute backward ran for each
    # eligible call (3 per forward at this depth)
    assert summary["kernel_launches"]["r_biased_attention"] == 0
    assert summary["rba_backward_calls"] == 2 * 3
