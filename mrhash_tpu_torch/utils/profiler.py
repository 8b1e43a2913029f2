"""Per-frame timing profilers (a copy of mrhash_tpu/utils/profiler.py),
mirroring the text-file format of the reference's Profiler / CUDAProfiler
(mrhash/src/sdf/cuda_utils.cuh:102-194): each write() appends one line
`elapsed_ms num_events avg_ms num_elements` to ./<name>.txt.  Events are
host wall clock around a step that ends in a device sync.

stage() names a step of the frame for torch.profiler.

COUNTS is the process's one registry of event counts: the kernels'
launches (under their wrappers' names, e.g. "fused_integrate_rows") and
"host_syncs", the host's reads of device values that the frame step
makes.  Each sync site of the frame step goes through host_int,
host_bool, host_list, nonzero, pick, upload or unique_rows, which
count the syncs a call makes on a card whatever the device (one, or
unique_rows' six), so a count is a property of the code path: on a card
each is one stream synchronization, on the CPU none.  A caller
takes a count as the difference of two readings (since()).
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.profiler import record_function

COUNTS: collections.Counter = collections.Counter()
SYNCS = "host_syncs"
# torch.unique(dim=0, return_inverse=True)'s thrust steps on a card
# (torch 2.11, CUDA 12.8, H100; tests/test_torch_tracing.py's gpu case)
UNIQUE_ROWS_SYNCS = 6


def since(mark: int, name: str = SYNCS) -> int:
    """COUNTS[name] less an earlier reading `mark`."""
    return COUNTS[name] - mark


def host_int(t) -> int:
    """int(t) of a one-element tensor: one counted sync."""
    COUNTS[SYNCS] += 1
    return int(t)


def host_bool(t) -> bool:
    """bool(t) of a one-element tensor: one counted sync."""
    COUNTS[SYNCS] += 1
    return bool(t)


def host_list(t) -> list:
    """t.tolist(): one counted sync."""
    COUNTS[SYNCS] += 1
    return t.tolist()


def nonzero(mask):
    """Positions (int64) of the set entries of `mask`, flat: the count
    reaches the host, one counted sync."""
    COUNTS[SYNCS] += 1
    return torch.nonzero(mask).flatten()


def pick(t, mask):
    """t[mask] for a bool mask (a nonzero underneath): one counted sync."""
    COUNTS[SYNCS] += 1
    return t[mask]


def put(t, index, value):
    """t[index] = value for a Python number along t's first dimension, as
    index_fill_, which takes the number as a kernel argument: no upload,
    no sync (`t[index] = number` uploads the number from host memory, a
    sync on a card)."""
    t.index_fill_(0, index.reshape(-1), value)


def unique_rows(t):
    """torch.unique(t, dim=0, return_inverse=True): UNIQUE_ROWS_SYNCS
    counted syncs."""
    COUNTS[SYNCS] += UNIQUE_ROWS_SYNCS
    return torch.unique(t, dim=0, return_inverse=True)


def upload(a, device, dtype=None):
    """A number, tuple, array or tensor as a tensor on `device`
    (torch.as_tensor): from host memory a copy from pageable memory, one
    counted sync; a tensor already on an accelerator is not counted."""
    if not (torch.is_tensor(a) and a.device.type != "cpu"):
        COUNTS[SYNCS] += 1
    return torch.as_tensor(a, dtype=dtype, device=device)


def stage(name: str):
    """A torch.profiler range named `name` while a profiler runs, else a
    no-op: an idle record_function costs ~10 us of host time per range."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return contextlib.nullcontext()


class Profiler:
    def __init__(self, name: str, enabled: bool = True, directory: str = "."):
        self.name = name
        self.enabled = enabled
        self.path = f"{directory}/{name}.txt"
        self._events: list[float] = []
        self._fh = None

    @contextlib.contextmanager
    def event(self):
        """RAII event (CUDAProfiler::CUDAEvent)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        self._events.append((time.perf_counter() - t0) * 1e3)

    def write(self, num_elements: int = 0):
        """Flush accumulated events as one line (CUDAProfiler::write)."""
        if not self.enabled or not self._events:
            self._events = []
            return
        if self._fh is None:
            self._fh = open(self.path, "w")
        elapsed = sum(self._events)
        n = len(self._events)
        self._fh.write(f"{elapsed} {n} {elapsed / n} {num_elements}\n")
        self._fh.flush()
        self._events = []

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
