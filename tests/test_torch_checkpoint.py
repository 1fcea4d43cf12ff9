"""The port's checkpoints (``repro_torch.checkpoint.checkpoint``): the JAX
package's on-disk layout (``step_%08d/`` with ``manifest.json`` and
``shard_0.npz`` of ``leaf_i``), an atomic publish, retention of the newest
3, async saves, and restores that give back every leaf bit for bit, bf16
leaves and the AdamW state (moments and step count) included."""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_lm
from repro_torch.optim.adamw import OptConfig, init_opt
from repro_torch.tree import named_leaves


def _trained_tree(dtype="float32"):
    """A reduced LM's parameters in ``dtype`` and an AdamW after one step
    (nonzero moments, count 1)."""
    cfg = get_config("smollm-135m").reduced()
    model = init_lm(cfg, seed=0, device="cpu").to(getattr(torch, dtype))
    params = list(model.parameters())
    opt = init_opt(OptConfig(lr=1e-3), params)
    g = torch.Generator().manual_seed(1)
    opt.apply([torch.randn(p.shape, generator=g) for p in params])
    return model, opt


def _assert_bit_equal(got, want):
    assert [p for p, _ in named_leaves(got)] == \
        [p for p, _ in named_leaves(want)]
    for (name, a), (_, b) in zip(named_leaves(got), named_leaves(want)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a.view(torch.uint8) if a.dim() else a,
                               b.view(torch.uint8) if b.dim() else b), name
        else:
            assert type(a) is type(b) and a == b, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(tmp_path, dtype):
    model, opt = _trained_tree(dtype)
    tree = {"params": model, "opt": opt.state_dict(),
            "extra": [torch.arange(5, dtype=torch.int32), 2.5]}
    path = ckpt.save(str(tmp_path), 7, tree, meta={"note": "x"})
    assert path.endswith("step_00000007")
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert man["step"] == 7 and man["meta"] == {"note": "x"}
    assert man["n_leaves"] == len(named_leaves(tree))
    assert ("bfloat16" in man["dtypes"]) == (dtype == "bfloat16")
    data = np.load(tmp_path / "step_00000007" / "shard_0.npz")
    assert sorted(data.files) == sorted(f"leaf_{i}"
                                        for i in range(man["n_leaves"]))

    # Restore into a fresh tree of the same structure.
    fresh, fresh_opt = _trained_tree(dtype)
    like = {"params": fresh, "opt": init_opt(
        OptConfig(), list(fresh.parameters())).state_dict(),
        "extra": [torch.zeros(5, dtype=torch.int32), 0.0]}
    got, step = ckpt.restore(str(tmp_path), like)
    assert step == 7
    assert got["opt"]["count"] == opt.count == 1
    want = {"params": dict(model.named_parameters()), "opt": opt.state_dict(),
            "extra": tree["extra"]}
    _assert_bit_equal(got, want)

    # The restored state loads into an optimizer that resumes the schedule.
    fresh_opt.load_state_dict(got["opt"])
    assert fresh_opt.count == 1
    for a, b in zip(fresh_opt.state_dict()["m"], opt.state_dict()["m"]):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_retention_keeps_three_and_no_tmp_is_left(tmp_path):
    tree = {"w": torch.ones(3)}
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, {"w": tree["w"] * step})
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["step_00000003", "step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    got, step = ckpt.restore(str(tmp_path), tree, step=4)
    assert step == 4 and torch.equal(got["w"], torch.full((3,), 4.0))


def test_save_async_then_wait_pending(tmp_path):
    w = torch.arange(6, dtype=torch.float32)
    t = ckpt.save_async(str(tmp_path), 2, {"w": w})
    assert isinstance(t, threading.Thread)
    w += 100  # the snapshot was taken before the call returned
    ckpt.wait_pending(str(tmp_path))
    assert not t.is_alive()
    got, step = ckpt.restore(str(tmp_path), {"w": w})
    assert step == 2 and torch.equal(got["w"], torch.arange(6.0))
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())


def test_missing_checkpoint_raises(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), {"w": torch.zeros(1)})
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(1)}, step=9)


def test_restore_refuses_another_structure(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(1)})
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"v": torch.zeros(1)})
