"""``DevicePreloader`` on the card: the pinned arena, the copy stream and
its events, against the host rows bit for bit.

This file imports no JAX, so it also runs on a machine with a GPU and no
JAX installed:

    python -m pytest --noconftest tests/test_torch_preload.py -q

Every test here needs a card and skips without one (the CPU side of the
preloader is held against the JAX package's in tests/test_torch_data.py).
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.parallel.accelerate import PlacedBatch, accelerate
from dlrover_tpu_torch.trainer.data import DevicePreloader


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned memory, copy stream)")
    return torch.device("cuda")


def _host(n, seed=0):
    """Batches large enough (64 MiB + 4 MiB) that a copy still in flight
    when its slot is refilled would show in the rows."""
    rs = np.random.RandomState(seed)
    return [{"a": rs.randint(0, 1 << 30, size=(4096, 4096)).astype(np.int32),
             "b": rs.randn(1024, 1024).astype(np.float32)}
            for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("background", [False, True])
def test_slots_are_refilled_only_after_their_copy(card, background):
    """The consumer keeps its stream busy after each batch, so copies
    queue behind one another; every batch must still be its host rows,
    from an arena of prefetch + 1 slots a key."""
    host = _host(10)
    w = torch.randn(8192, 8192, device=card)
    pre = DevicePreloader(host, prefetch=2, background=background)
    copies = []
    for batch in pre:
        assert all(t.device.type == "cuda" for t in batch.values())
        for _ in range(3):
            w = (w @ w).clamp_(-1, 1)
        copies.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    assert pre.arena_slots() == 2 * 3
    pre.close()
    if background:
        assert not pre._bg_thread.is_alive()
    assert len(copies) == len(host)
    for got, want in zip(copies, host):
        for k in want:
            assert got[k].cpu().numpy().tobytes() == want[k].tobytes()


@pytest.mark.cuda
def test_placed_by_shard_batch_on_the_card(card):
    """With an ``AccelerateResult`` the rows go through its
    ``shard_batch`` on the copy stream; the trainer's own call passes the
    placed batch through."""

    def init_fn(gen):
        return {"w": torch.randn(3, 2, generator=gen, device=gen.device)}

    def loss_fn(params, batch, rng):
        return (batch["x"] @ params["w"]).pow(2).mean(), {}

    rs = np.random.RandomState(1)
    host = [{"x": rs.randn(8, 3).astype(np.float32)} for _ in range(5)]
    result = accelerate(init_fn, loss_fn,
                        lambda p: torch.optim.SGD(p, lr=0.1), host[0],
                        device="cuda")
    state = result.init_fn(0)
    pre = DevicePreloader(host, sharding=result, prefetch=2, global_rows=8)
    for batch, want in zip(pre, host):
        assert isinstance(batch, PlacedBatch)
        again = result.shard_batch(batch)
        assert type(again) is dict and all(again[k] is batch[k]
                                           for k in batch)
        state, _ = result.train_step(state, batch)
        assert batch["x"].cpu().numpy().tobytes() == want["x"].tobytes()
    pre.close()
    assert state.step == 5
