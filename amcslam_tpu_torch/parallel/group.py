"""Ranks and their collectives: the port's counterpart of the reference's
`Mesh` / `shard_map` / `psum` plumbing.

The reference runs a sharded solver as one SPMD program over a mesh axis
and sums across it with `jax.lax.psum`. Here a shard is a process: a rank of
`torch.distributed`, started by `run_ranks`, runs the ordinary closures on
its block and sums with `all_reduce_sum`. Only `all_reduce` (and
`broadcast`) are used, because those are the collectives the gloo backend
supports on CUDA tensors: several ranks can then share one card through
gloo, and ranks with a card each can use NCCL.

`run_ranks` takes its device and backend from the caller; nothing here
picks gloo in place of NCCL or the CPU in place of a card.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over the ranks of `group` in place (one `dist.all_reduce`);
    returns `t`. Every rank gets the same bits."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The largest of the ranks' 0-d `x`, exact: each rank writes its value
    into its own slot of a zero vector and the vectors are summed (adding
    zeros rounds nothing)."""
    slots = x.new_zeros(dist.get_world_size(group))
    slots[dist.get_rank(group)] = x
    return all_reduce_sum(slots, group).max()


def _to_host(x):
    """Tensors in a result (nested in tuples, lists, dicts and NamedTuples)
    as numpy arrays, so they pickle by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(fn, rank, world_size, init_method, device, backend, args, timeout_s, results):
    """Body of one rank: join the group, run fn, report its result or its
    traceback on `results`."""
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        out = _to_host(fn(rank, dist.group.WORLD, dev, *args))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the caller, which raises it
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *, device, backend: str, args: tuple = (),
              deadline_s: float = 600.0) -> list:
    """Run `fn(rank, group, device, *args)` in `world_size` new processes
    (the `spawn` start method) joined in one process group; return their
    results by rank, tensors as numpy arrays.

    `fn` must be importable by its module path (a function of a package,
    not of a test file or `__main__`), and `args` picklable. `device` is one
    device for every rank or a sequence of one per rank; `backend` is
    "gloo" or "nccl". The group meets through a `file://` store in a
    temporary directory. Each rank runs with one intra-op thread.

    Raises if a rank raises (with its traceback) or dies, and when
    `deadline_s` passes first; every rank still running is then killed, so
    a rank that waits in a collective no other rank reaches cannot hang the
    caller. A kernel library the ranks launch must be built by the caller
    before this call (`_build.build`): the ranks only load it."""
    if isinstance(device, (str, torch.device)):
        devices = [str(device)] * world_size
    else:
        devices = [str(d) for d in device]
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = time.monotonic() + deadline_s
    out: dict[int, Any] = {}
    with tempfile.TemporaryDirectory(prefix="amcslam_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init, devices[r], backend, args,
                                   deadline_s, results))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
            while len(out) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {world_size - len(out)} of {world_size} "
                                       f"ranks still running after {deadline_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_ranks: rank {dead[0]} died with exit code "
                                           f"{procs[dead[0]].exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} raised:\n{payload}")
                out[rank] = payload
        finally:
            # after a failure the other ranks may wait in a collective for
            # ever: kill them at once; after success give them time to exit
            grace = 10.0 if len(out) == world_size else 0.0
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=grace)
                    if p.is_alive():
                        p.kill()
                        p.join()
            results.close()
    return [out[r] for r in range(world_size)]


def sequence(rank: int, group, device, jobs: Sequence[tuple[Callable, tuple]]) -> dict:
    """A rank function that runs `jobs`, (fn, args) pairs of rank functions,
    one after another in one process group, so that one `run_ranks` call
    pays the ranks' start-up once. Returns {"results": in job order,
    "seconds": each job's (host clock), "started": the wall-clock time
    (`time.time()`) at which the rank began its first job}."""
    started = time.time()
    results, seconds = [], []
    for fn, args in jobs:
        t0 = time.perf_counter()
        results.append(fn(rank, group, device, *args))
        seconds.append(time.perf_counter() - t0)
    return {"results": results, "seconds": seconds, "started": started}
