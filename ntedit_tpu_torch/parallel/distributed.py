"""Multi-host runtime on torch.distributed: joining the process group,
each process's share of the work, and gathering records.

The counterpart of the JAX package's parallel/distributed.py.  Every
process runs the same program; ``initialize`` joins the default process
group, and the mesh programs (parallel/mesh.py) run over it.  The data flow
of a multi-host polish run (cli._run_engine_multihost): each process owns a
contiguous slice of the input contigs (``process_slice``), polishes them on
its own device, renders each contig's three output fragments, and rank 0
writes the merged files in input order after ``gather_records``.

One backend per kind of tensor: ``"cpu:gloo,cuda:nccl"`` when the run is on
the card, ``"gloo"`` under ``--device cpu``.  Records travel as CPU tensors,
so over gloo; device tensors travel over NCCL.  NCCL creates its
communicator at the first CUDA collective, so processes that only gather
records (two ranks sharing one card, which NCCL refuses) never create one.
Each rank's device is ``cuda:{local_rank}``: the launcher's ``LOCAL_RANK``
where it sets one, else the rank modulo the number of cards.

Single-process, every helper is the identity.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = datetime.timedelta(seconds=120)  # a dead rank fails its peers instead of hanging them


def backend_for(device) -> str:
    """The process group's backend for a run on ``device``."""
    return "gloo" if torch.device(device).type == "cpu" else "cpu:gloo,cuda:nccl"


def initialize_from_env(device="cuda") -> bool:
    """Join the process group from the environment; the command line calls
    this once ``--device`` is known (cli.main).  Launch every rank with

        NTEDIT_TPU_COORDINATOR=host:port
        NTEDIT_TPU_NUM_PROCESSES=N
        NTEDIT_TPU_PROCESS_ID=i        python -m ntedit_tpu_torch ...

    or set NTEDIT_TPU_DISTRIBUTED=1 to take a launcher's ``env://``
    variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; torchrun sets
    them).  With neither set it does nothing.  True when this call joined
    the group."""
    if os.environ.get("NTEDIT_TPU_DISTRIBUTED") == "1":
        return initialize(init_method="env://", device=device)
    coord = os.environ.get("NTEDIT_TPU_COORDINATOR")
    if not coord:
        return False
    return initialize(
        coordinator_address=coord,
        num_processes=int(os.environ["NTEDIT_TPU_NUM_PROCESSES"]),
        process_id=int(os.environ["NTEDIT_TPU_PROCESS_ID"]),
        device=device,
    )


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    init_method: Optional[str] = None,
) -> bool:
    """Join the default process group: at ``tcp://<coordinator_address>``
    with ``num_processes`` ranks, this one ``process_id``, or at
    ``init_method`` (a URL; ``env://`` reads the launcher's variables).
    No-op when already joined, or single-process with no coordinator.
    Asking for CUDA without a card raises.  True when this call joined."""
    if dist.is_initialized():
        return False
    if init_method is None:
        if coordinator_address is None and num_processes in (None, 1):
            return False  # single-process run: nothing to join
        init_method = f"tcp://{coordinator_address}"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run the "
                           "ranks on the CPU over gloo")
    kw = {} if num_processes is None else {"world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend_for(device), init_method=init_method, timeout=TIMEOUT,
                            **kw)
    return True


def shutdown() -> None:
    """Leave the default process group.  Its threads then stop before the
    interpreter's teardown, which aborts a rank ("terminate called without
    an active exception") when it meets them running."""
    dist.destroy_process_group()


def active() -> bool:
    """True when this run spans more than one process."""
    return dist.is_initialized() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{local_rank}`` for CUDA (see the module
    docstring), the CPU for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the "
                           "plain torch version on the CPU")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def process_slice(n_items: int) -> slice:
    """The contiguous range of work items this process owns (contigs or
    contig windows), split evenly in input order so that the merged output
    is deterministic."""
    p = world_size()
    i = rank()
    per = -(-n_items // p)
    return slice(i * per, min(n_items, (i + 1) * per))


def gather_records(local_blobs: list) -> list:
    """Allgather each process's record list; returns their concatenation in
    rank order (rank 0's records first).  Identity single-process.

    Records are Python objects; they travel pickled as a padded byte
    tensor on the CPU, so over gloo (their volume is small: edits, not
    sequence)."""
    if world_size() == 1:
        return list(local_blobs)
    payload = torch.from_numpy(np.frombuffer(pickle.dumps(local_blobs), dtype=np.uint8).copy())
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(world_size())]
    dist.all_gather(sizes, torch.tensor([payload.numel()], dtype=torch.int64))
    m = max(int(s) for s in sizes)
    padded = torch.zeros(m, dtype=torch.uint8)
    padded[: payload.numel()] = payload
    parts = [torch.empty(m, dtype=torch.uint8) for _ in sizes]
    dist.all_gather(parts, padded)
    out = []
    for part, size in zip(parts, sizes):
        out.extend(pickle.loads(part[: int(size)].numpy().tobytes()))
    return out
