"""Per-frame timing profilers (a copy of mrhash_tpu/utils/profiler.py),
mirroring the text-file format of the reference's Profiler / CUDAProfiler
(mrhash/src/sdf/cuda_utils.cuh:102-194): each write() appends one line
`elapsed_ms num_events avg_ms num_elements` to ./<name>.txt.  Events are
host wall clock around a step that ends in a device sync.

stage() names a step of the frame for torch.profiler.
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch.profiler import record_function


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

    def add_ms(self, ms: float):
        if self.enabled:
            self._events.append(ms)

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

    @property
    def last_total_ms(self):
        return sum(self._events)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
