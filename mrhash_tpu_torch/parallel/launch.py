"""One process per rank: the torch counterpart of the JAX package's
jax.sharding.Mesh.  The JAX module is one program whose arrays shard_map
splits over devices; here each rank is its own process, holding its own
state on its own device, and the frame step calls collectives on its
group (PORT_NOTES.md P63).

`run_ranks(fn, n, backend=..., device=..., timeout_s=..., args=...)`
spawns n processes (start method "spawn"), which meet through a file in a
fresh temporary directory (a fixed TCP port would clash between
concurrent runs), and calls `fn(group, *args)` in each, `group` being the
rank's RankGroup.  `fn` must be a module-level function of an importable
module (the child imports it by name).  The call returns each rank's
result, every tensor in it turned into numpy, in rank order.  It joins
with a deadline: a rank that exits non-zero or does not finish in time
raises, naming the rank, and the other ranks are stopped.

The backend is the caller's choice, never a retry after a failed init:
"nccl" for one rank per card, "gloo" on the CPU and for several ranks on
one card (NCCL refuses two ranks on one device; gloo takes a card's
tensors for every collective the steps call, P67).
"""
from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch

BACKENDS = ("gloo", "nccl")


class RankGroup:
    """This rank's view of its process group: `rank`, `size`, the
    `device` its state lives on, and the collectives the sharded steps
    call.  With `timed` set, each collective synchronizes the device
    before and after it and adds its seconds to `comm_s`."""

    _OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}

    def __init__(self, rank: int, size: int, device):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.timed = False
        self.comm_s = 0.0

    @contextlib.contextmanager
    def _clock(self):
        if not self.timed:
            yield
            return
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(self.device)
        self.comm_s += time.perf_counter() - t0

    def all_gather(self, t):
        """Every rank's `t` (equal shapes), stacked in rank order:
        [size, *t.shape]."""
        import torch.distributed as dist
        with self._clock():
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t)
            return torch.stack(parts)

    def all_reduce(self, t, op: str):
        """`t` reduced over the ranks with op "sum", "min" or "max", in
        place."""
        import torch.distributed as dist
        with self._clock():
            dist.all_reduce(t, op=getattr(dist.ReduceOp, self._OPS[op]))
        return t

    def gather_object(self, obj):
        """Every rank's picklable `obj`, as a list in rank order on rank 0,
        None elsewhere."""
        import torch.distributed as dist
        with self._clock():
            out = [None] * self.size if self.rank == 0 else None
            dist.gather_object(obj, out, dst=0)
            return out


def rank_device(device, rank: int, backend: str) -> torch.device:
    """The device of `rank`: "cuda" under NCCL is one card per rank
    (cuda:rank, modulo the cards present); any other device, all ranks on
    that device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if backend == "nccl":
            return torch.device("cuda", rank % torch.cuda.device_count())
        return torch.device("cuda", 0)
    return dev


def to_numpy(obj):
    """`obj` with every tensor in it (through dicts, lists and tuples)
    turned into a numpy array."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def _rank_main(rank, fn, n, backend, device, init_method, timeout_s, args,
               out_dir):
    """A rank's process: set its device and thread count, join the group,
    run fn, write its result (or its traceback) to out_dir."""
    import torch.distributed as dist
    try:
        dev = rank_device(device, rank, backend)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=timeout_s))
        result = to_numpy(fn(RankGroup(rank, n, dev), *args))
        dist.destroy_process_group()
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        with open(path + ".tmp", "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        # no interpreter teardown: a process group whose peer is gone can
        # hang its destructor
        os._exit(1)


def _failure(out_dir, failed, procs):
    """The message for the ranks that failed: the first to fail (by the
    time its traceback was written) with its traceback."""
    errs = {}
    for r in failed:
        try:
            with open(os.path.join(out_dir, f"rank{r}.err")) as f:
                t, tb = f.read().split("\n", 1)
            errs[r] = (float(t), tb)
        except (OSError, ValueError):
            errs[r] = (float("inf"), "")
    first = min(failed, key=lambda r: errs[r][0])
    return (f"rank {first} of {len(procs)} failed (exit code "
            f"{procs[first].exitcode}; ranks failed: {sorted(failed)}):\n"
            f"{errs[first][1]}")


def run_ranks(fn, n: int, *, backend: str, device, timeout_s: float,
              args=()):
    """Run `fn(group, *args)` on n ranks, one process each, and return
    their results (tensors as numpy) in rank order.  Raises RuntimeError
    naming the first rank that fails, or TimeoutError naming the ranks
    still running after `timeout_s` seconds (the process group's own
    timeout too); the other ranks are stopped either way."""
    import torch.multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError("backend 'nccl' needs device 'cuda'")
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="mrhash_ranks_")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = []
    try:
        for r in range(n):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                r, fn, n, backend, device, init, timeout_s, tuple(args),
                out_dir))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(out_dir, failed, procs))
            running = [r for r, p in enumerate(procs) if p.exitcode is None]
            if not running:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {running} of {n} did not finish "
                                   f"within {timeout_s} s")
            procs[running[0]].join(0.05)
        results = []
        for r in range(n):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
