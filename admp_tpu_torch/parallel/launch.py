"""Start the ranks of a torch.distributed process group as processes, and
build the two-axis (data x model) groups.

``launch(fn, world_size, args)`` spawns ``world_size`` processes, each a rank
of a process group on a ``FileStore`` in a temporary directory, runs
``fn(rank, world_size, *args)`` in each and returns their results, rank 0
first. A rank that raises or dies fails the launch: the other ranks, which
may wait in a collective for it, are stopped, and the error is raised in the
caller with that rank's traceback. ``start`` returns the running ranks, so
the caller can work while they do. ``fn`` and ``args`` go to the ranks
pickled in a file of the launch's temporary directory (``fn`` by import
path, so the caller's main module must be importable: its code under
``if __name__ == "__main__":``), and the results come back pickled through
a queue: return numpy arrays or numbers.

On one card the ranks share it over gloo (NCCL refuses two ranks on one
GPU); across cards NCCL is the backend.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world_size, backend, store_path, job_path, results,
               threads):
    torch.set_num_threads(threads)
    try:
        with open(job_path, "rb") as f:
            fn, args = pickle.load(f)  # written by this launch's parent
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size)
        out = fn(rank, world_size, *args)
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which stops the rest
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        raise
    results.put((rank, True, out))
    results.close()
    results.join_thread()


class Ranks:
    """The processes of one launch; ``results()`` waits for them."""

    def __init__(self, fn, world_size: int, args=(), backend: str = "gloo",
                 timeout: float = 1800.0, threads: int = 1):
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory()
        store = os.path.join(self._tmp.name, "store")
        # fn and args go through a file: a spawned child that dies before it
        # reads a large argument from its pipe would block Process.start
        job = os.path.join(self._tmp.name, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, args), f)
        self._queue = ctx.Queue()
        self._deadline = time.monotonic() + timeout
        self.world_size = world_size
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, world_size, backend, store, job,
                              self._queue, threads))
            for r in range(world_size)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.stop()
            raise

    def results(self):
        """Every rank's result, rank 0 first; raises the first failure."""
        got = {}
        try:
            while len(got) < self.world_size:
                try:
                    rank, ok, payload = self._queue.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} of {self.world_size} exited "
                            f"with code {self._procs[dead[0]].exitcode} "
                            "without a report") from None
                    if time.monotonic() > self._deadline:
                        left = sorted(set(range(self.world_size)) - set(got))
                        raise TimeoutError(
                            f"ranks {left} did not finish in time") from None
                    continue
                if not ok:
                    raise RuntimeError(
                        f"rank {rank} of {self.world_size} failed:\n{payload}")
                got[rank] = payload
            for p in self._procs:
                p.join(timeout=60)
        finally:
            self.stop()
        return [got[r] for r in range(self.world_size)]

    def stop(self):
        """Stop every rank still running and remove the store."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            if p.pid is None:
                continue
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()


def start(fn, world_size: int, args=(), backend: str = "gloo",
          timeout: float = 1800.0, threads: int = 1) -> Ranks:
    """Spawn the ranks and return at once (see the module docstring)."""
    return Ranks(fn, world_size, args, backend, timeout, threads)


def launch(fn, world_size: int, args=(), backend: str = "gloo",
           timeout: float = 1800.0, threads: int = 1):
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks
    and return their results, rank 0 first."""
    return start(fn, world_size, args, backend, timeout, threads).results()


def mesh_groups(data_size: int, model_size: int):
    """(data group, model group) of this rank on a data x model mesh of the
    world, rank = d * model_size + m (admp_tpu's ``Mesh(devices.reshape(
    data, model), ('data', 'model'))``). The model group is this rank's row
    (its data index), the data group its column. Every rank creates every
    group, rows first, in the same order, as torch.distributed requires."""
    world = dist.get_world_size()
    if data_size * model_size != world:
        raise ValueError(f"mesh {data_size} x {model_size} != world {world}")
    rank = dist.get_rank()
    rows = [dist.new_group([d * model_size + m for m in range(model_size)])
            for d in range(data_size)]
    cols = [dist.new_group([d * model_size + m for d in range(data_size)])
            for m in range(model_size)]
    return cols[rank % model_size], rows[rank // model_size]
