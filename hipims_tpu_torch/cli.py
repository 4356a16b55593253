"""Console entry point (reference: src/main.cpp:59-159, 376-459, 464-579).

Usage:
    python -m hipims_tpu_torch -c model.xml [-q] [-n] [--platform cpu]
        [--checkpoint run.npz] [--resume run.npz]
        [--mesh N] [--mesh-shape RxC] [--io-mode auto|gather|stream]
        [--distributed env|addr:port,num_processes,process_id]

The reference's own command line (``-c model.xml -m -x dir -s``) runs
too: ``-m`` and ``-x`` are accepted and ignored, each with a note.

Runs on the first CUDA device unless ``--platform cpu`` is given, in which
case the plain PyTorch versions of the kernels run on the CPU.  ``--mesh``
and ``--mesh-shape`` split the grid into blocks stepped in halo-deep
windows (``parallel/``): on the visible CUDA devices, several blocks to a
card where there are fewer cards than blocks, or all on the CPU.
``--io-mode stream`` (and the default "auto" at 16 M cells and more)
writes every output event from bounded row chunks
(runtime/sharded_io.py), on one device and under a mesh.

``--distributed`` runs one process per rank under torch.distributed
(parallel/distributed.py), every rank with the same arguments but its own
process id: the mesh's blocks are dealt out to the ranks (each rank's on
its own device, ``cuda:(LOCAL_RANK or rank) % count``), and without
``--mesh`` every rank runs the whole grid.  The world group is gloo; where
every rank holds a card of its own, a device group under NCCL moves the
halo strips and maxima card to card, and where ranks share a card (or on
the CPU) they go through the host: the placement decides, and the log's
``Cluster:`` line says which.  Rank 0 alone logs and writes files; every
rank runs the output events, whose reads are collective.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="hipims-tpu-torch",
        description="2D shallow-water flood simulator (PyTorch + CUDA)")
    ap.add_argument("--config-file", "-c", required=True,
                    help="XML configuration file (HiPIMS schema)")
    ap.add_argument("--log-file", "-l", default=None)
    ap.add_argument("--quiet-mode", "-q", "-s", action="store_true",
                    help="no user feedback (-s is the reference's alias)")
    ap.add_argument("--disable-screen", "-n", action="store_true",
                    help="plain line-by-line progress output")
    ap.add_argument("--mpi-mode", "-m", action="store_true",
                    help="accepted for reference compatibility (ignored)")
    ap.add_argument("--code-dir", "-x", default=None,
                    help="accepted for reference compatibility; there is "
                         "no OpenCL code to locate (ignored)")
    ap.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                    help="gpu (default: the first CUDA device) or cpu "
                         "(plain PyTorch versions of the kernels)")
    ap.add_argument("--precision", default=None,
                    choices=("double", "float", "compensated"),
                    help="override the XML floatingPointPrecision")
    ap.add_argument("--mass-balance", action="store_true",
                    help="log the domain water volume at every output time")
    ap.add_argument("--io-mode", default=None,
                    choices=("auto", "gather", "stream"),
                    help="output events: 'gather' (a host copy of the "
                         "grid), 'stream' (bounded row chunks) or 'auto' "
                         "(stream from 16 M cells; the default)")
    ap.add_argument("--checkpoint", default=None, metavar="FILE",
                    help="(re)write a resumable checkpoint (.npz) at "
                         "every output time")
    ap.add_argument("--resume", default=None, metavar="FILE",
                    help="resume from a checkpoint written with "
                         "--checkpoint (skips already-written outputs)")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="split the grid into N blocks (a most-square "
                         "mesh), stepped in halo-deep windows")
    ap.add_argument("--mesh-shape", default=None, metavar="RxC",
                    help="explicit mesh shape, e.g. 2x2")
    ap.add_argument("--distributed", default=None, metavar="SPEC",
                    help="multi-process run: 'env' (MASTER_ADDR, "
                         "MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets "
                         "them) or 'addr:port,num_processes,process_id'")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.distributed is None:
        return _main(args, False)
    from .parallel import distributed
    from .utils.logging import Logger
    try:
        distributed.initialize_cluster(
            *(distributed.parse_spec(args.distributed) or ()))
    except ValueError as e:
        # A bad SPEC, or 'env' without the rendezvous variables.
        Logger(quiet=True).error(str(e))
        return 1
    try:
        rc = _main(args, True)
        if rc == 0:
            distributed.barrier()
        return rc
    finally:
        distributed.shutdown()


def _main(args, cluster: bool):
    """The run; ``cluster`` when this process is one rank of several."""
    from .io.xml_config import load_config
    from .parallel.distributed import (host_summary, is_coordinator,
                                       open_groups, rank_device)
    from .runtime.progress import ProgressReporter
    from .utils.logging import Logger

    # Rank 0 alone logs (reference: rank-0-only console,
    # src/main.cpp:561-578).
    coordinator = is_coordinator()
    log = Logger(path=args.log_file if coordinator else None,
                 quiet=args.quiet_mode or not coordinator)
    log.block("Model configuration")
    if args.mpi_mode:
        log.line("note: --mpi-mode is a no-op here; multi-process runs "
                 "use --distributed (rank gating is automatic)")
    if args.code_dir:
        log.line("note: --code-dir ignored (no OpenCL sources to locate)")
    try:
        model = load_config(args.config_file)
    except FileNotFoundError as e:
        log.error(f"Cannot open model file: {e.filename or e}")
        return 1
    except (ValueError, KeyError) as e:
        log.error(f"Invalid model configuration: {e}")
        return 1

    if args.platform == "gpu":
        if not torch.cuda.is_available():
            log.error("--platform gpu: CUDA is not available (no device or "
                      "a CPU-only PyTorch); pass --platform cpu to run the "
                      "plain versions on the CPU")
            return 1
    device = rank_device(args.platform)
    if cluster:
        # The census picks the device group (collective on every rank).
        open_groups(args.platform)
        summary = host_summary()
        strips = ("card to card" if summary["device_backend"]
                  else "through the host")
        log.line(f"  Cluster:     {summary['process_count']} ranks, "
                 f"backend {summary['backend']}, device group "
                 f"{summary['device_backend'] or 'none'} (strips and "
                 f"maxima {strips}), "
                 f"{summary['global_device_count']} device(s) as the ranks "
                 "see them")

    log.line(f"  Name:        {model.name}")
    log.line(f"  Scheme:      {model.config.scheme}")
    log.line(f"  Duration:    {model.config.duration:.0f} s")
    log.line(f"  Output freq: {model.config.output_frequency:.0f} s")
    if args.precision:
        model.config.dtype = {"double": "float64", "float": "float32",
                              "compensated": "float32c"}[args.precision]
    if args.io_mode:
        model.config.io_mode = args.io_mode
    log.line(f"  Grid:        {model.domain.rows} x {model.domain.cols} "
             f"@ {model.domain.dx} m")
    log.line(f"  Precision:   {model.config.dtype}")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    log.line(f"  Device:      {device} ({name})"
             + (" on rank 0" if cluster else ""))

    mesh = None
    if args.mesh or args.mesh_shape:
        from .parallel import make_mesh
        try:
            shape = None
            if args.mesh_shape:
                a, b = args.mesh_shape.lower().split("x")
                shape = (int(a), int(b))
            n = args.mesh or shape[0] * shape[1]
            mesh = make_mesh(n, shape=shape,
                             devices=[device] * n if device.type == "cpu"
                             else None)
        except ValueError as e:
            log.error(f"Invalid mesh: {e}")
            return 1
        log.line(f"  Mesh:        {mesh.shape} ({mesh.devices.size} "
                 "blocks)")
    elif cluster:
        log.line("  Mesh:        none: every rank runs the whole grid, "
                 "rank 0 writes")

    try:
        sim = model.simulation(device=device, mesh=mesh)
    except ValueError as e:
        log.error(f"Invalid model configuration: {e}")
        return 1
    if mesh is not None:
        # The per-block table (the reference's per-domain table,
        # src/CModel.cpp:343-462) and the exchange window.
        from .runtime.progress import device_table
        for ln in device_table(sim):
            log.line(ln)
        log.line(f"  Window:      {sim.window} step(s) per halo exchange")
    # Every rank runs the output events (their reads are collective);
    # rank 0 alone writes the files.
    sim.write_outputs = coordinator
    if args.resume:
        from .runtime.checkpoint import load_checkpoint
        try:
            load_checkpoint(args.resume, sim)
        except (ValueError, FileNotFoundError) as e:
            log.error(f"Cannot resume: {e}")
            return 1
        log.line(f"  Resumed:     t={sim.t:.1f} s from {args.resume}")
    if args.checkpoint:
        sim.checkpoint_path = args.checkpoint
    if args.mass_balance:
        # The volume is collective across processes: every rank sums it,
        # rank 0 logs it.
        inner_writer = sim.output_writer
        vol0 = sim.volume()

        def mass_writer(view, t):
            if inner_writer is not None:
                inner_writer(view, t)
            vol = sim.volume()
            log.line(f"  Mass balance: t={t:.1f}s volume={vol:.3f} m3 "
                     f"(delta {vol - vol0:+.3f} vs start)")

        sim.output_writer = mass_writer
    reporter = ProgressReporter(log, sim,
                                quiet=args.quiet_mode or not coordinator)

    log.block("Simulation")
    t0 = time.monotonic()
    try:
        sim.run(progress=reporter)
    except KeyboardInterrupt:
        log.line("Interrupted — writing final state")
        sim.emit_output(sim.t)
        return 2
    wall = time.monotonic() - t0
    reporter.final(wall)
    if mesh is not None:
        log.line(f"  Windows re-run: {sim.window_reruns}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
