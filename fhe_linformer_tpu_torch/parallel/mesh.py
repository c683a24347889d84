"""The device mesh over `torch.distributed`, its block layouts, and a
launcher that runs a worker function on `world` spawned ranks.

The mesh (the JAX package's `parallel/mesh.py`) has two axes:

  * `dp`   - the ciphertext-batch axis (tokens, chunks): ops along it are
             independent;
  * `limb` - the RNS limb axis: the NTT and elementwise products are
             limb-local; the base conversions of a key switch sum across
             limbs and become collectives (`parallel/ksprod.py`).

Rank r sits at (dp, limb) = divmod(r, limb), as the JAX package reshapes
its device list.  Where the JAX package commits arrays to shardings, the
port hands each rank its block: `ct_block` (a batch over dp, limbs over
limb: `ct_sharding`), `limb_block` (limbs over limb, the same on every dp
rank: `limb_sharding`); a replicated array is the whole array on every
rank.

`launch(worker, world, *args)` runs `worker(rank, world, *args)` on
`world` processes started with the `spawn` method, after an initialised
process group (a `FileStore` in a fresh temporary directory, so concurrent
launches never share a port or a file), and returns each rank's result
with its tensors as numpy arrays.  It raises when a rank raises, exits
non-zero or outlives the timeout.  Workers live in this package, so a
child imports the port and nothing else.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .comm import TRANSPORTS, Comm


def block(n: int, parts: int, index: int) -> slice:
    """Block `index` of `parts` equal blocks of range(n)."""
    if n % parts:
        raise ValueError(f"{n} does not divide into {parts} blocks")
    per = n // parts
    return slice(index * per, (index + 1) * per)


@dataclass
class Mesh:
    """This rank's view of a (dp x limb) mesh: the axis sizes, its
    coordinates, and a Comm over its line along each axis."""
    shape: dict
    coords: dict
    comms: dict

    def ct_block(self, batch: int, rows: int) -> tuple[slice, slice]:
        """This rank's (batch, limb-row) block of a (batch, rows, N)
        array."""
        return (block(batch, self.shape["dp"], self.coords["dp"]),
                block(rows, self.shape["limb"], self.coords["limb"]))

    def limb_block(self, rows: int) -> slice:
        """This rank's row block of a (rows, N) table."""
        return block(rows, self.shape["limb"], self.coords["limb"])


def make_mesh(dp: int = 1, limb: int = 1) -> Mesh:
    """The (dp x limb) mesh over the initialised world group, whose size
    must be dp * limb; its collectives use the world group's backend.
    Every rank must call it (it creates the axis groups)."""
    world = dist.get_world_size()
    if dp * limb != world:
        raise ValueError(f"a {dp} x {limb} mesh needs {dp * limb} ranks, "
                         f"the group has {world}")
    transport = dist.get_backend()
    rank = dist.get_rank()
    coords = {"dp": rank // limb, "limb": rank % limb}
    comms = {}
    for i in range(dp):              # every rank creates every group
        g = dist.new_group([i * limb + j for j in range(limb)])
        if i == coords["dp"]:
            comms["limb"] = Comm(g, transport)
    for j in range(limb):
        g = dist.new_group([i * limb + j for i in range(dp)])
        if j == coords["limb"]:
            comms["dp"] = Comm(g, transport)
    return Mesh({"dp": dp, "limb": limb}, coords, comms)


def _to_host(obj):
    """obj with every tensor as a numpy array (results cross the process
    boundary by value, not through shared memory)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, store, transport, timeout, threads, worker,
               args, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            transport, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            out = _to_host(worker(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def launch(worker, world: int, *args, transport: str = "gloo",
           timeout: float = 600.0, threads: int | None = None) -> list:
    """[worker(rank, world, *args) for each rank], run on `world` spawned
    processes in one process group.  `worker` must be a module-level
    function; `args` and the results are pickled (tensors in the results
    come back as numpy arrays).  `threads` sets each rank's torch CPU
    threads.  Raises RuntimeError when a rank fails and TimeoutError when
    the ranks have not all finished within `timeout` seconds; stops every
    process it started either way."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r} is not one of "
                         f"{TRANSPORTS}")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="fhe-dist-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, world, os.path.join(tmp, "store"), transport, timeout,
        threads, worker, args, results)) for rank in range(world)]
    out = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < world:          # drain before joining
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))}"
                                   f" did not finish within {timeout} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # a rank that died without reporting (killed, crashed)
                    time.sleep(1.0)
                    if results.empty():
                        raise RuntimeError(
                            f"ranks {dead} exited with codes "
                            f"{[procs[r].exitcode for r in dead]} and no "
                            "result") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            out[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited non-zero or hung: {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]

