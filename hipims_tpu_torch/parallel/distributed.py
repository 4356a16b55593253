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

Two groups, chosen by placement, never by failure.  The world group is
gloo and carries the host traffic: output chunks and cell samples
(``all_gather_host``), the batches' elapsed seconds, the census and the
barrier.  After a gloo census of every rank's (host name, card), a run on
the GPU whose ranks all hold cards of their own also opens a device group
under NCCL (``open_groups``): the halo strips, the CFL maxima and the NaN
probe's sums then move card to card, and a lock-step step reads nothing
back to the host.  Ranks that share a card (NCCL refuses two ranks on one
device), or a run on the CPU, get no device group, and every strip and
scalar is staged through host buffers over gloo.  A failure to open the
NCCL group raises; nothing swaps it for gloo.  A launch, one process per
rank:

    python -m hipims_tpu_torch -c model.xml --mesh 4 \\
        --distributed 127.0.0.1:29500,2,0      # and ...,2,1 for rank 1

or ``--distributed env`` under ``torchrun`` (MASTER_ADDR, MASTER_PORT,
RANK, WORLD_SIZE, LOCAL_RANK):

    torchrun --nproc-per-node 4 -m hipims_tpu_torch -c model.xml \\
        --distributed env --mesh-shape 2x2

Without a process group every function here answers for one process and
runs no collective.
"""

from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

BACKEND = "gloo"
# The device group's backend, where the placement allows one.
DEVICE_BACKEND = "nccl"
# A mismatched collective raises after this long instead of hanging.
TIMEOUT = datetime.timedelta(seconds=120)

# The group that moves device tensors between ranks (None: host-staged).
_device_group = None


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
    ``tcp://coordinator_address``.  The device group is opened apart, by
    ``open_groups`` once the platform is known.  Returns True; an already
    initialised group is success, any other failure propagates (a
    half-initialised cluster must not fall back to one process)."""
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


def census(platform: str) -> list:
    """Every rank's (host name, device) in rank order, by one gloo
    all-gather (collective)."""
    mine = (socket.gethostname(), str(rank_device(platform)))
    out = [None] * world_size()
    dist.all_gather_object(out, mine)
    return [tuple(e) for e in out]


def device_backend(entries, platform: str):
    """The device group's backend for a census ``entries``: NCCL when the
    platform is the GPU and no two ranks name one card of one host, else
    None (strips and scalars staged through the host).  A rule of
    placement: NCCL refuses two ranks on one device."""
    if platform != "gpu" or len(entries) < 2:
        return None
    return DEVICE_BACKEND if len(set(entries)) == len(entries) else None


def open_groups(platform: str):
    """Take the census and open the device group its placement allows
    (``device_backend``); collective.  Returns the device group's backend
    or None."""
    backend = device_backend(census(platform), platform)
    if backend is not None:
        open_device_group(backend)
    return backend


def open_device_group(backend: str):
    """Open the group that moves device tensors between ranks under
    ``backend`` (every rank calls it): under NCCL, on this rank's card,
    made current first.  Its first operation is an all-reduce that every
    rank joins, as NCCL's point-to-point needs.  A failure raises."""
    global _device_group
    device = torch.device("cpu")
    if backend == "nccl":
        device = rank_device("gpu")
        torch.cuda.set_device(device)
    group = dist.new_group(backend=backend, timeout=TIMEOUT)
    dist.all_reduce(torch.zeros(1, device=device), group=group)
    _device_group = group
    return group


def device_group():
    """The device group (None: strips and scalars go through the host)."""
    return _device_group


def groups() -> dict:
    """The groups of this process: the world group's backend (None
    without a process group) and the device group's (None: host-staged).
    Not collective."""
    if not dist.is_initialized():
        return dict(world=None, device=None)
    return dict(world=dist.get_backend(),
                device=(None if _device_group is None
                        else dist.get_backend(_device_group)))


def shutdown():
    """Leave the process group (every group of it); nothing without
    one."""
    global _device_group
    _device_group = None
    if dist.is_initialized():
        dist.destroy_process_group()


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
    CMPIManager.cpp:257-360): its index and the count, the backend, the
    device group's backend (``groups``), its visible devices and the
    devices of every rank summed as each sees them (two ranks sharing a
    card count it twice).  Collective under a process group."""
    count = torch.cuda.device_count()
    local = ([f"cuda:{i}" for i in range(count)] if count else ["cpu"])
    counts = all_gather_host(torch.tensor([len(local)]), [1] * world_size())
    return dict(process_index=rank(), process_count=world_size(),
                backend=groups()["world"], device_backend=groups()["device"],
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


def all_gather_device(part: torch.Tensor) -> list:
    """Every rank's ``part`` (one shape and dtype on every rank) in rank
    order, gathered on the device group where the tensors lie: no host
    read.  Only with a device group."""
    part = part.contiguous()
    out = [torch.empty_like(part) for _ in range(world_size())]
    dist.all_gather(out, part, group=_device_group)
    return out


def max_over_ranks(value: torch.Tensor) -> torch.Tensor:
    """The max of a 0-d tensor over the ranks, on its device: the ranks'
    values all-gathered and folded with ``torch.maximum`` in rank order,
    so a NaN on any rank propagates (gloo's ReduceOp.MAX drops one held
    by rank 1 or above; NCCL's MAX is not relied on either).  On the
    device group no host read; host-staged one."""
    if world_size() == 1:
        return value
    if _device_group is not None:
        parts = all_gather_device(value.detach().reshape(1))
    else:
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
