"""Simulation master loop, on one device or on a mesh of blocks.

A batch is a Python loop of K steps of on-device work: boundaries ->
scheme step with its CFL partial max (on the card: kernel K1 for Godunov,
K4 for partial-inertial, the MUSCL predictor + corrector kernels for
MUSCL-Hancock) -> the time
controller ``advance`` (on the card one kernel, which also folds the
scheme kernel's CFL partials).  dt and t stay on the device as 0-d tensors,
and the reference's negative-dt suspension makes steps past the sync time
idle, so the host reads back once per batch (t, dt, counters), like the
reference's readKeyStatistics, and sizes the next batch toward a
wall-clock target like its adaptive queue
(src/Schemes/CSchemeGodunov.cpp:1147-1369, 1419-1448).  A batch so sized
is also bounded by the steps its sync point leaves, estimated from that
read (``_batch_steps``), so few of its steps idle past the sync.

Given a ``parallel.Mesh``, the grid is split into its (py, px) blocks,
each halo-extended on its device, and a batch is K exchange windows of
``window`` steps (``parallel/halo_deep.py``): ``forecast_window`` steps
under ``sync_method="forecast"``, otherwise 1.  The state and comp
properties then assemble the blocks' owned cells into one full-grid copy
on the first block's device, and setting them scatters a full grid back
into the blocks.  Under a process group (``parallel/distributed.py``)
each rank holds its own blocks and the carry on its first block's device;
the assembly, the volume and every output read are collective, every rank
runs the output event's writers and checkpoint (each gating its files on
the snapshot's ``write_files``), and every rank sizes its batches from the
slowest rank's elapsed time, so all run the same batches.

An output event reads the state in one of two ways (``io_streaming``).
Gathered, it copies each plane to the host once (``_OutputSnapshot``; under
a mesh, the assembled copy).  Streamed (``io_mode="stream"``, or "auto" at
``io_stream_cells`` cells and more), nothing is assembled: the planes stay
on the device (``_StreamingSnapshot``, runtime/sharded_io.py), on one
device and under a mesh alike.  Either snapshot is read the same way: the
writers and the checkpoint read row chunks (the gathered copy is one
chunk), the gauges a few cells, and the mass balance is a sum on the
device.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..domain import Domain
from ..models import Scheme, get_scheme
from ..ops.boundaries import apply_boundaries, interior_force_mask
from ..ops.godunov import SchemeParams
from ..ops.kernels.muscl_split import muscl_step_split
from ..ops.kernels.stencil import stencil_step
from ..ops.kernels.timestep import advance
from ..ops.timestep import TimestepParams
from ..parallel import distributed
from ..parallel.halo_deep import HaloDeepBlocks
from ..parallel.mesh import Mesh
from ..state import DomainStatic, FlowState, initial_carry
from ..utils.trace import span
from . import sharded_io


@dataclasses.dataclass
class SimulationConfig:
    """Run configuration (reference: <simulation> parameters,
    src/CModel.cpp:65-133, and per-scheme <parameter>s,
    src/Schemes/CSchemeGodunov.cpp:113-338).  The JAX package's fields and
    defaults, less its choice of kernel backend."""

    scheme: str = "godunov"
    duration: float = 3600.0
    output_frequency: float = 600.0
    courant: float = 0.5
    initial_timestep: float = 0.01
    timestep_mode: str = "cfl"          # "cfl" | "fixed"
    fixed_timestep: float = 0.1
    friction: bool = True
    dry_threshold: float = C.VERY_SMALL
    dtype: str = "float64"              # "float32" | "float64" | "float32c"
                                        # (f32 state + Neumaier-compensated
                                        # z accumulation)
    batch_size: int = 64                # steps per host read
    batch_auto: bool = True             # adapt batch toward target seconds
    batch_target_seconds: float = 0.5
    sync_tolerance: float = 1e-5        # output-time match tolerance
    muscl_variant: Optional[str] = None
    sync_method: str = "timestep"       # mesh: "timestep" (an exchange
                                        # every step) | "forecast"
                                        # (halo-deep windows)
    forecast_window: int = 8            # steps per exchange in forecast
    forecast_dt: str = "window"         # "window" (frozen speed, one max
                                        # per window, re-run on a broken
                                        # margin) | "step" (lock-step)
    forecast_dt_safety: float = 1.05    # frozen-speed inflation margin
    io_mode: str = "auto"               # "gather" (a host copy of the
                                        # grid per event) | "stream"
                                        # (bounded row chunks) | "auto"
                                        # (stream from io_stream_cells)
    io_stream_cells: int = 16_000_000   # auto threshold (cells)
    io_chunk_mb: int = 64               # host budget per chunk set


class _Snapshot:
    """What an output event's writers and checkpoint read, whichever way
    it was taken: each plane (``plane``) as a source of row chunks of at
    most ``chunk_rows`` rows, the grid's chunks (``stream_chunks``) and a
    few cells (``sample_cells``).  The volume is the simulation's
    (``Simulation.volume``, a sum on the device); every other attribute
    is the simulation's too."""

    def output_view(self):
        return self

    def stream_chunks(self, reverse=False):
        """Yield (row0, FlowState, DomainStatic) of host arrays, row chunks
        of the grid, south first (north first with ``reverse=True``)."""
        planes = [self.plane(n)
                  for n in FlowState._fields + DomainStatic._fields]
        rows = self._sim.domain.rows
        for r0 in sharded_io.chunk_starts(rows, self.chunk_rows, reverse):
            n = min(self.chunk_rows, rows - r0)
            with span("hipims.output.snapshot"):
                arrs = [sharded_io.host_rows(p, r0, n) for p in planes]
            yield r0, FlowState(*arrs[:4]), DomainStatic(*arrs[4:])

    def sample_cells(self, rows, cols):
        """(FlowState, DomainStatic) of the cells (rows[k], cols[k]) as (K,)
        host arrays."""
        with span("hipims.output.snapshot"):
            vals = [sharded_io.host_cells(self.plane(n), rows, cols)
                    for n in FlowState._fields + DomainStatic._fields]
        return FlowState(*vals[:4]), DomainStatic(*vals[4:])

    def __getattr__(self, name):
        if name == "_sim":
            raise AttributeError(name)
        return getattr(self._sim, name)


class _OutputSnapshot(_Snapshot):
    """One output event's host copy of the state and the static fields,
    shared by the writers and the checkpoint, so an event copies the state
    off the device once (under a mesh, one assembled copy), and read as
    one chunk.  The grid is never padded, so the full and the logical
    arrays are the same."""

    streaming = False

    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self.write_files = sim.write_outputs
        self.state_full = FlowState(*(a.cpu().numpy() for a in sim.state))
        self.state_logical = self.state_full
        self.static_logical = sim.static_logical
        self.chunk_rows = sim.domain.rows

    def plane(self, name):
        """Plane ``name`` (a FlowState or DomainStatic field, or "comp") as
        a host array; the comp plane, which only a checkpoint reads, is
        copied when asked for."""
        if name == "comp":
            return self._sim.comp.cpu().numpy()
        if name in FlowState._fields:
            return getattr(self.state_full, name)
        return getattr(self.static_logical, name)


class _StreamingSnapshot(_Snapshot):
    """One output event's bounded-memory view: no plane is copied to the
    host whole, or assembled on a device.  Row chunks of at most
    ``chunk_rows`` rows go to the host, and sampled cells are indexed on
    the device with only their values copied.  The full-grid attributes
    of the gathered snapshot raise."""

    streaming = True

    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self.write_files = sim.write_outputs
        # Six planes move per chunk set (4 state + 2 static).
        self.chunk_rows = sharded_io.chunk_rows_for(
            sim.domain.cols, n_fields=6, budget_mb=sim.config.io_chunk_mb)

    def plane(self, name):
        """Plane ``name`` (a FlowState or DomainStatic field, or "comp")
        as a source of row chunks: the tensor on one device, an
        ``OwnedPlane`` under a mesh."""
        sim = self._sim
        if sim._blocks is not None:
            return sim._blocks.plane(name)
        if name == "comp":
            return sim._comp
        if name in FlowState._fields:
            return getattr(sim._state, name)
        return getattr(sim._static, name)

    def __getattr__(self, name):
        if name in ("state_logical", "static_logical", "state_full",
                    "static_full", "comp_full"):
            raise AttributeError(
                f"{name} is unavailable on a streaming output snapshot "
                "(io_mode='stream'): it would copy the full grid to the "
                "host. Use stream_chunks(), sample_cells() or volume(), "
                "or set io_mode='gather'.")
        return super().__getattr__(name)


def _wet_sum(z, zmax, zb):
    """Sum of max(z - zb, 0) in float64 over the cells whose zmax is not
    NODATA, on the planes' device (a 0-d tensor)."""
    h = (z.double() - zb.double()).clamp_min(0.0)
    return h.masked_fill(zmax <= C.NODATA, 0.0).sum()


class Simulation:
    """The simulation loop, on one device or on a mesh of blocks."""

    def __init__(self, domain: Domain, config: SimulationConfig,
                 boundaries: Sequence = (),
                 output_writer: Optional[Callable] = None, *,
                 device=None, mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a hipims_tpu_torch.parallel.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        if config.forecast_dt not in ("window", "step"):
            raise ValueError(f"forecast_dt must be 'window' or 'step', "
                             f"got {config.forecast_dt!r}")
        if config.forecast_dt_safety < 1.0:
            raise ValueError("forecast_dt_safety must be >= 1.0 "
                             f"(got {config.forecast_dt_safety})")
        if mesh is not None:
            # The carry and the assembled state live on the device of this
            # rank's first block.
            first = mesh.first_device(distributed.rank())
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {first}")
            device = first
        elif device is None:
            raise TypeError("Simulation needs a device (or a mesh)")
        self.domain = domain
        self.config = config
        self.device = torch.device(device)
        self.mesh = mesh
        self.output_writer = output_writer
        self.scheme: Scheme = get_scheme(config.scheme)

        dtype = torch.float64 if config.dtype == "float64" else torch.float32
        self.dtype = dtype
        self.compensated = config.dtype == "float32c"

        # Closed-edge walls span the scheme's static ring; single precision
        # shifts the vertical datum out of the arithmetic (Domain.build).
        state, static = domain.build(
            dtype=dtype, device=self.device,
            edge_wall_width=self.scheme.radius,
            datum_shift=(config.dtype != "float64"))
        self.carry = initial_carry(dtype, self.device,
                                   dt0=config.initial_timestep)
        comp = torch.zeros_like(state.z) if self.compensated else None
        self._static_host_cache = None

        self.params = SchemeParams(
            dx=domain.dx, dy=domain.dy,
            very_small=config.dry_threshold,
            quite_small=config.dry_threshold * 10.0,
            friction=config.friction,
            datum=domain.datum)
        self.ts_params = TimestepParams(
            courant=config.courant,
            dynamic=(config.timestep_mode == "cfl"),
            fixed_dt=config.fixed_timestep,
            simplified_speed=self.scheme.simplified_speed)
        if mesh is None:
            self.window = 1
            self._blocks = None
            self._state, self._static, self._comp = state, static, comp
            self.boundaries = tuple(b.to(self.device, dtype, domain)
                                    for b in boundaries)
            # Forcing is allowed on the grid minus the static ring.
            self._force_mask = interior_force_mask(
                state.z.shape, self.scheme.radius, self.device)
        else:
            # The blocks fit the window to their halos (``HaloDeepBlocks``).
            self.boundaries = tuple(boundaries)
            self._blocks = HaloDeepBlocks(
                mesh, self.scheme, self.params, self.ts_params,
                self.boundaries, domain, state, static, comp,
                (max(1, int(config.forecast_window))
                 if config.sync_method == "forecast" else 1),
                config.duration, self._step, config.forecast_dt,
                config.forecast_dt_safety)
            self.window = self._blocks.window
        # Batches count exchange windows under a mesh.
        self._batch_size = max(1, int(config.batch_size))
        self._host_carry = self._read_carry()
        self.total_steps = 0
        self.total_skipped = 0
        # Batches that the steps left to their sync point cut short.
        self.batches_bounded = 0
        # Output events: writers write files where write_outputs is set
        # (every rank runs them: their reads are collective across
        # processes); a checkpoint is (re)written at every event when
        # checkpoint_path is set (runtime/checkpoint.py).  wall_start is set
        # by run().
        self.write_outputs = True
        self.checkpoint_path = None
        self.wall_start = None

    # ------------------------------------------------------------------
    @property
    def state(self) -> FlowState:
        """The state; under a mesh, a full-grid copy assembled from the
        blocks on the first block's device."""
        return self._state if self._blocks is None else self._blocks.state()

    @state.setter
    def state(self, value: FlowState):
        if self._blocks is None:
            self._state = value
        else:
            self._blocks.load_state(value)

    @property
    def comp(self):
        """The compensated-f32 residue plane of z (None unless f32c); a
        full-grid copy under a mesh, as ``state``."""
        return self._comp if self._blocks is None else self._blocks.comp()

    @comp.setter
    def comp(self, value):
        if self._blocks is None:
            self._comp = value
        else:
            self._blocks.load_comp(value)

    @property
    def static(self) -> DomainStatic:
        return (self._static if self._blocks is None
                else self._blocks.static())

    @property
    def window_reruns(self) -> int:
        """Windows re-run from their saved start because the observed
        speed broke the frozen margin (``forecast_dt="window"``)."""
        return 0 if self._blocks is None else self._blocks.reruns

    @property
    def windows(self) -> int:
        """Exchange windows stepped under a mesh, re-runs included (0 on
        one device)."""
        return 0 if self._blocks is None else self._blocks.windows

    # ------------------------------------------------------------------
    def _step(self, state: FlowState, static: DomainStatic, comp, carry,
              boundaries, mask, *, origin=None, logical=None,
              speed_window=None, partials=False):
        """One step of one array: ``boundaries`` (forcing only where
        ``mask`` is set), then the scheme's fused step and its CFL speed;
        returns (state, speed, comp).  The one place a scheme is mapped to
        its kernels: ``_run_batch`` steps the grid with it, and every mesh
        block steps through it (``HaloDeepBlocks``), with the block's
        ``origin``, ``logical`` and ``speed_window``
        (``stencil.stencil_step``).  With ``partials`` the speed is the
        scheme kernel's unreduced CFL partials, which advance's kernel
        folds in its own launch."""
        params = self.params
        if boundaries:
            with span("hipims.step.boundaries"):
                bout = apply_boundaries(boundaries, state, static, carry.t,
                                        carry.dt, carry.t_hydro, params, mask,
                                        comp=comp)
            state, comp = bout if comp is not None else (bout, None)
        # The mesh options go only to a block's step: a step put in the
        # kernels' place on one device (a planted fault) need not take them.
        mesh = ({} if origin is None else
                dict(origin=origin, logical=logical, speed_window=speed_window))
        with span("hipims.step.scheme"):
            if self.scheme.name == "muscl-hancock":
                out = muscl_step_split(state, static, carry.dt, params,
                                       self.config.muscl_variant, comp,
                                       partials=partials, **mesh)
            else:
                out = stencil_step(
                    self.scheme.name, state, static, carry.dt, params,
                    comp=comp, simplified_speed=self.ts_params.simplified_speed,
                    partials=partials, **mesh)
        return out[0], out[1], (out[2] if comp is not None else None)

    def _run_batch(self, state: FlowState, carry, static: DomainStatic,
                   sync_time, comp, n_steps: int):
        """K steps of on-device work; nothing here reads back to the host.
        Same signature and result as the JAX package's jitted batch."""
        with span("hipims.batch"):
            for _ in range(n_steps):
                state, speed, comp = self._step(
                    state, static, comp, carry, self.boundaries,
                    self._force_mask, partials=True)
                with span("hipims.step.advance"):
                    carry = advance(carry, speed, sync_time,
                                    self.config.duration, self.params.dx,
                                    self.ts_params)
            # NaN/Inf probe: a diverged state never reaches dt/t (non-finite
            # cells mask as dry in the CFL), so fold a zero-scaled state sum
            # into a statistic the host reads anyway: finite states add 0,
            # divergence turns it NaN.
            poison = 0.0 * torch.sum(state.z)
            carry = carry._replace(
                batch_dt_total=carry.batch_dt_total + poison)
        return state, carry, comp

    def _read_carry(self):
        """The batch's one host read: (t, dt, batch_dt_total, successful,
        skipped) in one transfer."""
        c = self.carry
        return torch.stack([c.t.double(), c.dt.double(),
                            c.batch_dt_total.double(),
                            c.batch_successful.double(),
                            c.batch_skipped.double()]).cpu().numpy()

    # ------------------------------------------------------------------
    def run_to(self, target_time: float,
               progress: Optional[Callable] = None):
        """Advance the simulation until the clock reaches target_time."""
        # The clock carries the state dtype; a non-representable target
        # can only be matched to ~ulp(t), so the tolerance scales with the
        # clock magnitude in f32 runs.
        eps = float(torch.finfo(self.dtype).eps)
        tol = max(self.config.sync_tolerance, 8.0 * eps * abs(target_time))
        sync = torch.tensor(target_time, dtype=self.dtype,
                            device=self.device)
        auto = self.config.batch_auto
        idled = True
        while True:
            before = self._host_carry
            t_now = float(before[0])
            # Under wall-clock batches the batch that reaches the sync
            # runs at least one idle step past it, as an unbounded one
            # does: the first resets the hydrological accumulator.
            if t_now >= target_time - tol and (idled or not auto):
                break
            n_units = self._batch_steps(target_time)
            if n_units < self._batch_size:
                self.batches_bounded += 1
            t0 = time.perf_counter()
            if self._blocks is None:
                self._state, self.carry, self._comp = self._run_batch(
                    self._state, self.carry, self._static, sync,
                    self._comp, n_units)
            else:
                self.carry = self._blocks.run_batch(self.carry, sync,
                                                    n_units)
            with span("hipims.batch.read"):
                host = self._read_carry()
            self._host_carry = host
            elapsed = time.perf_counter() - t0
            if self._blocks is not None and self._blocks.distributed:
                elapsed = self._agree(host, elapsed)
            t_new, dt_now, total, ok, skipped = host
            if not np.isfinite(t_new) or np.isnan(dt_now) or np.isnan(total):
                # dt = +/-inf is NOT divergence: a dry domain has zero wave
                # speed and fast-forwards with a clamped timestep.
                raise RuntimeError(
                    f"Simulation diverged (t={t_new}, dt={dt_now}); "
                    "the CFL wave speed became non-finite")
            self.total_steps = int(ok)
            self.total_skipped = int(skipped)
            # A batch begun at a sync idles its first step (dt < 0 there).
            idled = skipped - before[4] > (1 if before[1] <= 0.0 else 0)
            if progress is not None:
                progress(self, t_new, elapsed)
            if auto:
                # A batch its sync point cut short is read as a whole
                # batch at the same seconds a unit.
                self._adapt_batch(elapsed * self._batch_size / n_units)
            if t_new <= t_now and dt_now <= 0.0 \
                    and t_new < target_time - tol:
                raise RuntimeError(
                    f"Simulation stalled at t={t_new:.6f}s "
                    f"(dt={dt_now:.3e})")

    def _batch_steps(self, target_time: float) -> int:
        """The next batch's length, in steps (exchange windows under a
        mesh): the batch size, and under wall-clock sizing no more than
        the steps left to ``target_time`` need.  Those are estimated from
        the last host read as ceil((target - t) / dt), with dt's magnitude
        (negative at a sync) under the controller's early and maximum
        caps, then given 1/16 and 8 steps more and rounded up to a
        multiple of 8: a batch still reaches its sync point, and idles
        past it, when dt shrinks a little; one that falls short is
        followed by another, bounded afresh (under frozen-speed windows
        that batch seeds its first window's speed afresh, as a wall-clock
        batch of another size would).  A dt of 0 or non-finite (a dry
        domain) bounds nothing.  A pure function of the host read, which
        every rank of a process group shares."""
        if not self.config.batch_auto:
            return self._batch_size
        t, dt = float(self._host_carry[0]), abs(float(self._host_carry[1]))
        if not (math.isfinite(dt) and dt > 0.0):
            return self._batch_size
        ts = self.ts_params
        if t < ts.early_duration:
            dt = min(dt, ts.early_limit)
        dt = min(dt, ts.maximum)
        left = math.ceil(max(target_time - t, 0.0) / dt)
        steps = 8 * math.ceil((math.ceil(1.0625 * left) + 8) / 8)
        return min(self._batch_size, -(-steps // self.window))

    @staticmethod
    def _agree(host, elapsed: float) -> float:
        """Across processes, after a batch: every rank's carry read and
        elapsed seconds, all-gathered.  The carries must be equal (each
        rank advances its own copy from the same speeds), and the batch
        took the slowest rank's time, which every rank then sizes its next
        batch from: batches seed their first frozen-speed window afresh,
        so ranks on batches of their own would step different windows."""
        world = distributed.world_size()
        with span("hipims.batch.agree"):
            vals = distributed.all_gather_host(
                torch.from_numpy(np.append(host, elapsed)), [6] * world)
        for r, v in enumerate(vals):
            if not np.array_equal(v[:5].numpy(), host, equal_nan=True):
                raise RuntimeError(f"rank {r}'s carry {v[:5].tolist()} "
                                   f"differs from this rank's "
                                   f"{host.tolist()}")
        return max(float(v[5]) for v in vals)

    def _adapt_batch(self, elapsed: float):
        """Size batches (of steps, or of windows under a mesh) toward the
        wall-clock target, in powers of two between 8 and 4096 (reference:
        CSchemeGodunov.cpp:1419-1448), from the seconds a whole batch of
        the current size took."""
        target = self.config.batch_target_seconds
        if not (elapsed < target / 2 and self._batch_size < 4096) and \
                not (elapsed > target * 2 and self._batch_size > 8):
            return
        per_unit = max(elapsed / self._batch_size, 1e-9)
        ideal = max(1.0, target / per_unit)
        size = 8
        while size * 2 <= min(ideal, 4096):
            size *= 2
        self._batch_size = max(8, size)

    # ------------------------------------------------------------------
    def io_streaming(self) -> bool:
        """True when output events take the bounded-memory streamed path
        (runtime/sharded_io.py) instead of a host copy of the grid."""
        mode = self.config.io_mode
        if mode in ("stream", "gather"):
            return mode == "stream"
        return self.domain.cell_count >= self.config.io_stream_cells

    def output_view(self) -> _Snapshot:
        """A snapshot of the run for an output event: the streamed view,
        or a host copy of the state (``io_streaming``)."""
        with span("hipims.output.snapshot"):
            return (_StreamingSnapshot(self) if self.io_streaming()
                    else _OutputSnapshot(self))

    def emit_output(self, t: float):
        """One output event: take a snapshot (``output_view``), write the
        checkpoint (when checkpoint_path is set) and run the writers.  On
        every rank: their reads are collective across processes, and each
        writes files only where the snapshot's ``write_files`` is set (the
        checkpoint on rank 0)."""
        if self.output_writer is None and self.checkpoint_path is None:
            return
        with span("hipims.output.event"):
            snap = self.output_view()
            if self.checkpoint_path is not None:
                from .checkpoint import save_checkpoint
                with span("hipims.output.checkpoint"):
                    save_checkpoint(self.checkpoint_path, self,
                                    snapshot=snap)
            if self.output_writer is not None:
                self.output_writer(snap, t)

    def run(self, progress: Optional[Callable] = None):
        """Full run with outputs at every output_frequency interval.  On a
        resumed simulation, output events at or before the resume time
        are skipped (they belong to the original run)."""
        cfg = self.config
        self.wall_start = time.monotonic()
        t_start = self.t
        n_outputs = int(round(cfg.duration / cfg.output_frequency))
        for i in range(1, n_outputs + 1):
            target = min(i * cfg.output_frequency, cfg.duration)
            if target <= t_start + cfg.sync_tolerance:
                continue
            self.run_to(target, progress=progress)
            self.emit_output(target)
        if self.t < cfg.duration - cfg.sync_tolerance:
            self.run_to(cfg.duration, progress=progress)
            self.emit_output(cfg.duration)
        return self.state

    # ------------------------------------------------------------------
    @property
    def t(self) -> float:
        return float(self._host_carry[0])

    @property
    def state_logical(self) -> FlowState:
        """Host copy of the state (the logical grid is the whole grid)."""
        return FlowState(*(a.cpu().numpy() for a in self.state))

    @property
    def static_logical(self) -> DomainStatic:
        """Host copy of the static fields, copied once."""
        if self._static_host_cache is None:
            self._static_host_cache = DomainStatic(
                *(a.cpu().numpy() for a in self.static))
        return self._static_host_cache

    def depth(self) -> np.ndarray:
        st = self.state_logical
        h = np.asarray(st.z) - np.asarray(self.static_logical.zb)
        h[np.asarray(st.zmax) <= C.NODATA] = 0.0
        return np.maximum(h, 0.0)

    def volume(self) -> float:
        """The domain's water volume [m^3] (reference: the per-domain
        volume sum, src/Domain/Cartesian/CDomainCartesian.cpp:743-760),
        summed in float64 on the device(s), so no output event copies a
        plane for it; under a mesh, each block's owned cells, then the
        blocks in block order (across processes, their sums all-gathered
        first, so every rank returns the one-process value)."""
        if self._blocks is None:
            total = float(_wet_sum(self._state.z, self._state.zmax,
                                   self._static.zb))
        else:
            blocks = self._blocks
            parts = zip(*(blocks.owned(n) for n in ("z", "zmax", "zb")))
            sums = blocks.exchange(
                {b.index: _wet_sum(z, zmax, zb).reshape(1).cpu()
                 for (b, z), (_, zmax), (_, zb) in parts}, lambda b: 1)
            total = sum(float(sums[b.index]) for b in blocks.layout)
        return total * self.domain.dx * self.domain.dy
