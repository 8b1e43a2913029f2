"""The rank launcher (mrhash_tpu_torch/parallel/launch.py) on the CPU.

1. A run that does not finish by its deadline raises TimeoutError naming
   the ranks still running, soon after the deadline, and leaves no rank's
   process behind.
2. The backend is checked before any process starts ("mpi" and NCCL on
   the CPU raise ValueError); a run's results come back in rank order with
   every tensor turned into numpy: 2 ranks, each map after 2 frames equal
   to its owner's share of the single-process map's keys.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

import sharding_helpers as SH
from mrhash_tpu_torch.core.state import MapConfig
from mrhash_tpu_torch.parallel import launch
from mrhash_tpu_torch.parallel import sharding as S


def _frames(n):
    depth = np.full((SH.ROWS, SH.COLS), 2.0, np.float32)
    rgb = np.full((SH.ROWS, SH.COLS, 3), 128, np.uint8)
    frame = (SH.EYE, SH.ZERO, depth, rgb)
    return [frame] * n                  # pickled once, referenced n times


def test_run_past_its_deadline_raises_naming_the_ranks():
    deadline = 6.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] of 2 did not "
                       r"finish within 6.0 s"):
        launch.run_ranks(S.run_frames, 2, backend="gloo", device="cpu",
                         timeout_s=deadline,
                         args=(MapConfig(**SH.CFG), "rgbd", SH.CAM,
                               _frames(5000), None, None))
    assert time.monotonic() - t0 < deadline + 10.0
    assert not multiprocessing.active_children()


def test_backend_checked_and_results_in_rank_order():
    cfg = MapConfig(**SH.CFG)
    for backend, device in (("mpi", "cpu"), ("nccl", "cpu")):
        with pytest.raises(ValueError):
            launch.run_ranks(S.run_frames, 2, backend=backend, device=device,
                             timeout_s=SH.TIMEOUT_S, args=())
    frames = _frames(2)
    results = launch.run_ranks(S.run_frames, 2, backend="gloo", device="cpu",
                               timeout_s=SH.TIMEOUT_S,
                               args=(cfg, "rgbd", SH.CAM, frames, None, None))
    single = SH.run_single(cfg, "rgbd", frames)
    occ = single["table"]["ptr"] != -2
    keys = single["table"]["pos"][occ]
    owner = S.owner_of(torch.from_numpy(keys), 2).numpy()
    for r, res in enumerate(results):
        t = res["state"]["table"]
        assert isinstance(t["pos"], np.ndarray)
        mine = t["pos"][t["ptr"] != -2]
        assert set(map(tuple, mine.tolist())) == \
            set(map(tuple, keys[owner == r].tolist())), r
        assert res["stats"][-1]["frame"] == 1
