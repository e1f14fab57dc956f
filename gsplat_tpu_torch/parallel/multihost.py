"""Process-group start-up and process-sharded camera sampling (PyTorch port
of ``gsplat_tpu/parallel/multihost.py``).

The JAX module starts ``jax.distributed`` so that every process sees the
global device set.  Here every device is a process of its own (one rank a
device), so ``init_multihost`` starts the ``torch.distributed`` group that
all of the port's parallel paths reduce over, on one host or many:

    torchrun --nproc_per_node N -m gsplat_tpu_torch.scripts.train \\
        -s <data> --data_parallel N
    python -m gsplat_tpu_torch.scripts.train -s <data> --data_parallel -1 \\
        --multihost --coordinator_address <host0>:1234 \\
        --num_processes <world> --process_id <rank>

``ShardedCameraSampler`` is the JAX class as it is: every rank draws the
same global camera order from ``seed`` and takes its own slice of it.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# a rank that does not come up (or a peer that died) raises after this long
# in place of waiting for ever; long enough for rank 0's evaluation and
# file writes, which the other ranks wait out in their next collective
TIMEOUT = datetime.timedelta(minutes=30)


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *, device="cuda",
                   backend: Optional[str] = None,
                   timeout: datetime.timedelta = TIMEOUT,
                   store: Optional[dist.Store] = None):
    """Start the ``torch.distributed`` process group.  Returns ``(rank,
    world_size)``, as the JAX function returns ``(process_index,
    process_count)``.

    With ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` the group starts over ``tcp://``; with ``store``, a
    store every rank reaches (``spawn_local``'s), and those two counts it
    starts on that store; without either it reads the environment
    ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  The backend is NCCL on ``device="cuda"``
    and gloo on ``"cpu"``; ``backend`` names another one explicitly.  On
    the card the rank takes device ``LOCAL_RANK`` (torchrun's), or its
    rank modulo the host's device count.  A group that is already up is
    returned as it is."""
    dev = torch.device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = coordinator_address or store is not None
    if explicit and (num_processes is None or process_id is None):
        raise ValueError("--coordinator_address needs --num_processes and "
                         "--process_id")
    rank = process_id if explicit else int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: device='cuda' but "
                               "torch.cuda.is_available() is False")
        # before the group starts, so that NCCL binds this rank's device
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if store is not None:
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    elif coordinator_address:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


class ShardedCameraSampler:
    """Deterministic process-sharded camera sampler.

    Every process runs the identical RNG stream (seeded only by ``seed``), so
    all processes agree on the global camera order for every step without
    communicating; process ``p`` takes rows ``[p*k, (p+1)*k)`` of each global
    batch of ``k * process_count`` cameras. The shuffle semantics mirror the
    reference's random-pop stack (train.py:95-97): a global epoch is a
    permutation of all cameras, consumed batch-by-batch, reshuffled when
    fewer than one global batch remains (partial epochs wrap, so every step
    has a full batch and all processes stay in lockstep).
    """

    def __init__(self, n_cameras: int, per_process: int, process_index: int,
                 process_count: int, seed: int = 0):
        if n_cameras <= 0:
            raise ValueError("need at least one camera")
        self.n_cameras = n_cameras
        self.per_process = per_process
        self.process_index = process_index
        self.process_count = process_count
        self.global_batch = per_process * process_count
        self._rng = np.random.default_rng(seed)
        self._stack: list[int] = []

    def _refill(self):
        # identical permutation on every process: the rng stream depends
        # only on (seed, number of prior refills)
        self._stack.extend(self._rng.permutation(self.n_cameras).tolist())

    def sample_global(self) -> list[int]:
        """The full global batch for this step (same on every process)."""
        while len(self._stack) < self.global_batch:
            self._refill()
        out = self._stack[: self.global_batch]
        del self._stack[: self.global_batch]
        return out

    def sample(self) -> list[int]:
        """This process's local slice of the step's global batch."""
        g = self.sample_global()
        p = self.process_index
        return g[p * self.per_process: (p + 1) * self.per_process]


def make_global_batch(mesh, local_batch):
    """The identity.  The JAX function assembles every process's cameras
    into one global array for the ``data``-mesh step; here each rank is one
    device and its step takes its own cameras, which it already holds.
    The name stays so that code written against the JAX module reads the
    same."""
    return local_batch


def launched() -> bool:
    """Whether a launcher (``torchrun``) started this process as a rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_ranks(data_parallel: int, tile_parallel: int, device) -> int:
    """How many ranks a command line started alone runs: the devices the
    JAX CLI would use.  On the card ``data_parallel`` -1 takes every GPU
    left after the tile slices and N is clamped to them; on the CPU N is
    taken as asked and -1 is one rank (the JAX package sees one CPU
    device)."""
    tile = max(1, tile_parallel)
    dp = 1 if data_parallel in (0, 1) else data_parallel
    if torch.device(device).type == "cuda":
        avail = torch.cuda.device_count()
        if tile > avail:
            raise ValueError(f"--tile_parallel {tile} needs {tile} GPUs, "
                             f"have {avail}")
        return tile * (avail // tile if dp < 0 else min(dp, avail // tile))
    return tile * max(dp, 1)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, n, port, device, args):
    if torch.device(device).type == "cpu":
        # n ranks share the host's cores (torchrun sets OMP_NUM_THREADS=1
        # for the same reason): oversubscribed intra-op threads spin.  An
        # OMP_NUM_THREADS the caller set is kept.
        torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", 0))
                              or max(1, (os.cpu_count() or 1) // n))
    store = dist.TCPStore("127.0.0.1", port, n, is_master=False,
                          timeout=TIMEOUT)
    init_multihost(None, n, rank, device=device, store=store)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn_local(fn, n: int, args=(), device="cuda"):
    """Run ``fn(*args)`` in ``n`` local ranks (``torch.multiprocessing``,
    spawned), each in the group ``init_multihost`` starts on a TCP store
    this process holds on 127.0.0.1; returns when every rank has ended and
    raises if one failed (the others are then stopped).  ``fn`` must be
    importable by name.

    The store binds its port (the kernel's choice) before the ranks start
    and keeps it until they end, so no other process can take the port
    between its choice and the ranks' rendezvous."""
    import torch.multiprocessing as mp
    store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                          wait_for_workers=False, timeout=TIMEOUT)
    mp.spawn(_rank_main, args=(fn, n, store.port, str(device), args),
             nprocs=n, join=True)
