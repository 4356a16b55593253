"""Multi-process runs (the reference's MPI nodes) over ``torch.distributed``.

The reference's CMPIManager broadcasts the configuration, exchanges device
and domain censuses and runs the halo and time-step collectives
(src/MPI/CMPIManager.cpp).  The JAX package gets all of it from
``jax.distributed`` and a mesh spanning every host.  Here every process
(rank) runs the same program on the same config path, a mesh's blocks are
dealt out to the ranks in contiguous row-major groups (``parallel/mesh.py``),
and the cross-rank traffic of a run is explicit (``parallel/halo_deep.py``):
halo strips by point-to-point sends, the CFL maxima by an all-gather folded
in rank order, the NaN probe's and the volume's per-block sums by an
all-gather added in block order, output chunks by an all-gather of the
ranks' parts.

The backend is gloo, on the CPU and on the card alike: every strip and
scalar is staged through host buffers.  Nothing picks NCCL or falls back
from it.  A launch, one process per rank:

    python -m hipims_tpu_torch -c model.xml --mesh 4 \\
        --distributed 127.0.0.1:29500,2,0      # and ...,2,1 for rank 1

or ``--distributed env`` under ``torchrun`` (MASTER_ADDR, MASTER_PORT,
RANK, WORLD_SIZE).  Without a process group every function here answers
for one process and runs no collective.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

BACKEND = "gloo"
# A mismatched collective raises after this long instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)


def parse_spec(spec: str):
    """The CLI's ``--distributed SPEC``: ``env`` gives None (everything
    from the environment), ``addr:port,num_processes,process_id`` gives
    (``addr:port``, n, pid).  Raises ValueError on anything else."""
    spec = spec.strip()
    if spec.lower() == "env":
        return None
    parts = [p.strip() for p in spec.split(",")]
    try:
        addr, n, pid = parts
        host, port = addr.rsplit(":", 1)
        n, pid, port = int(n), int(pid), int(port)
    except ValueError:
        raise ValueError(f"--distributed {spec!r}: expected 'env' or "
                         "'addr:port,num_processes,process_id'") from None
    if not host or n < 1 or not 0 <= pid < n or not 0 < port < 65536:
        raise ValueError(f"--distributed {spec!r}: need a host, a port in "
                         "1..65535, num_processes >= 1 and 0 <= process_id "
                         "< num_processes")
    return addr, n, pid


def initialize_cluster(coordinator_address=None, num_processes=None,
                       process_id=None) -> bool:
    """Join the process group under gloo: from the environment
    (``init_method="env://"``) without arguments, else at
    ``tcp://coordinator_address``.  Returns True; an already initialised
    group is success, any other failure propagates (a half-initialised
    cluster must not fall back to one process)."""
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        dist.init_process_group(BACKEND, init_method="env://",
                                timeout=TIMEOUT)
    else:
        dist.init_process_group(
            BACKEND, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=TIMEOUT)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """Rank 0 (or the only process): the one that logs and writes
    (reference: rank-0-only console, src/main.cpp:561-578)."""
    return rank() == 0


def rank_device(platform: str = "gpu") -> torch.device:
    """This rank's device: the CPU, or ``cuda:(LOCAL_RANK or rank) %
    device_count()``, so ranks on a host with one card share it.  Raises
    without CUDA on "gpu"."""
    if platform == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible for this rank")
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % count)


def host_summary() -> dict:
    """This process's place in the cluster (the reference's device census,
    CMPIManager.cpp:257-360): its index and the count, the backend, its
    visible devices and the devices of every rank summed as each sees them
    (two ranks sharing a card count it twice).  Collective under a process
    group."""
    count = torch.cuda.device_count()
    local = ([f"cuda:{i}" for i in range(count)] if count else ["cpu"])
    counts = all_gather_host(torch.tensor([len(local)]), [1] * world_size())
    return dict(process_index=rank(), process_count=world_size(),
                backend=dist.get_backend() if dist.is_initialized() else None,
                local_devices=local,
                global_device_count=int(sum(int(c) for c in counts)))


def gather_to_host(array) -> np.ndarray:
    """The whole global array as a host numpy array on every process: a
    tensor or array (a mesh run's assembled state is whole on every rank
    already), or a mesh plane (``HaloDeepBlocks.plane``), whose rows are
    all-gathered from the ranks that own them."""
    if isinstance(array, torch.Tensor):
        return array.cpu().numpy()
    if isinstance(array, np.ndarray):
        return array
    return array.host_rows(0, array.shape[0])


def all_gather_host(part: torch.Tensor, sizes) -> list:
    """Every rank's 1-D host ``part`` (``sizes[r]`` values on rank r; the
    sizes are known everywhere), in rank order: one all-gather of the
    parts padded to the largest, as JAX's ``process_allgather`` pads.  The
    bytes move as they are, so -0.0 and NaN arrive as sent."""
    part = part.reshape(-1).cpu()
    if world_size() == 1:
        return [part]
    width = max(max(sizes), 1)
    padded = torch.zeros(width, dtype=part.dtype)
    padded[:part.numel()] = part
    out = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(out, padded)
    return [o[:n] for o, n in zip(out, sizes)]


def max_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The max of a 0-d tensor over the ranks, on its device: the ranks'
    values all-gathered and folded with ``torch.maximum`` in rank order,
    so a NaN on any rank propagates (gloo's ReduceOp.MAX drops one held
    by rank 1 or above).  One host read."""
    if world_size() == 1:
        return value
    parts = all_gather_host(value.detach().reshape(1),
                            [1] * world_size())
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out.reshape(()).to(value.device)


def barrier():
    """Wait for every rank (nothing without a process group)."""
    if world_size() > 1:
        dist.barrier()
