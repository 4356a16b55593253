"""Simulation master loop, single device.

A batch is a Python loop of K steps of on-device work: boundaries ->
scheme step with its CFL partial max (on the card: kernel K1 for Godunov,
the MUSCL predictor + corrector kernels for MUSCL-Hancock) -> the time
controller ``advance``.  dt and t stay on the device as 0-d tensors,
and the reference's negative-dt suspension makes steps past the sync time
idle, so the host reads back once per batch (t, dt, counters), like the
reference's readKeyStatistics, and sizes the next batch toward a
wall-clock target like its adaptive queue
(src/Schemes/CSchemeGodunov.cpp:1147-1369, 1419-1448).
"""

from __future__ import annotations

import dataclasses
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
from ..ops.timestep import TimestepParams, advance
from ..state import DomainStatic, FlowState, initial_carry
from .output import domain_volume


@dataclasses.dataclass
class SimulationConfig:
    """Run configuration (reference: <simulation> parameters,
    src/CModel.cpp:65-133, and per-scheme <parameter>s,
    src/Schemes/CSchemeGodunov.cpp:113-338).  Same fields and defaults as
    the JAX package; the mesh, forecast and streaming fields are validated
    but their paths are not ported yet."""

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
    kernel_backend: str = "auto"
    muscl_variant: Optional[str] = None
    sync_method: str = "timestep"
    forecast_window: int = 8
    forecast_dt: str = "window"
    forecast_dt_safety: float = 1.05
    io_mode: str = "auto"               # "gather" | "stream" | "auto"
    io_stream_cells: int = 16_000_000   # auto threshold (cells)
    io_chunk_mb: int = 64


class _OutputSnapshot:
    """One output event's host copy of the state and static fields; every
    other attribute is the simulation's."""

    def __init__(self, sim: "Simulation"):
        self._sim = sim
        self.state_logical = FlowState(*(a.cpu().numpy() for a in sim.state))
        self.static_logical = sim.static_logical

    def __getattr__(self, name):
        if name == "_sim":
            raise AttributeError(name)
        return getattr(self._sim, name)


class Simulation:
    """Single-domain simulation loop on one device."""

    def __init__(self, domain: Domain, config: SimulationConfig,
                 boundaries: Sequence = (),
                 output_writer: Optional[Callable] = None, *,
                 device, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device (mesh) runs are not ported to "
                "hipims_tpu_torch yet; see ROADMAP.md (queue 1)")
        if config.forecast_dt not in ("window", "step"):
            raise ValueError(f"forecast_dt must be 'window' or 'step', "
                             f"got {config.forecast_dt!r}")
        if config.forecast_dt_safety < 1.0:
            raise ValueError("forecast_dt_safety must be >= 1.0 "
                             f"(got {config.forecast_dt_safety})")
        if config.io_mode == "stream" or (
                config.io_mode == "auto"
                and domain.cell_count >= config.io_stream_cells):
            raise NotImplementedError(
                f"streamed output I/O (io_mode={config.io_mode!r}, "
                f"{domain.cell_count} cells, auto threshold "
                f"{config.io_stream_cells}) is not ported yet; use "
                "io_mode='gather' (ROADMAP.md, queue 1)")
        self.domain = domain
        self.config = config
        self.device = torch.device(device)
        self.output_writer = output_writer
        self.scheme: Scheme = get_scheme(config.scheme)

        dtype = torch.float64 if config.dtype == "float64" else torch.float32
        self.dtype = dtype
        self.compensated = config.dtype == "float32c"
        self.boundaries = tuple(b.to(self.device, dtype) for b in boundaries)

        # Closed-edge walls span the scheme's static ring; single precision
        # shifts the vertical datum out of the arithmetic (Domain.build).
        self.state, self.static = domain.build(
            dtype=dtype, device=self.device,
            edge_wall_width=self.scheme.radius,
            datum_shift=(config.dtype != "float64"))
        self.carry = initial_carry(dtype, self.device,
                                   dt0=config.initial_timestep)
        self.comp = (torch.zeros_like(self.state.z) if self.compensated
                     else None)
        self._static_host_cache = None
        # Forcing is allowed on the grid minus the static ring.
        self._force_mask = interior_force_mask(
            self.state.z.shape, self.scheme.radius, self.device)

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
        self._batch_size = max(1, int(config.batch_size))
        self._host_carry = self._read_carry()
        self.total_steps = 0
        self.total_skipped = 0

    # ------------------------------------------------------------------
    def _run_batch(self, state: FlowState, carry, static: DomainStatic,
                   sync_time, comp, n_steps: int):
        """K steps of on-device work; nothing here reads back to the host.
        Same signature and result as the JAX package's jitted batch."""
        params, ts = self.params, self.ts_params
        mask = self._force_mask
        end_time = self.config.duration
        for _ in range(n_steps):
            bout = apply_boundaries(self.boundaries, state, static, carry.t,
                                    carry.dt, carry.t_hydro, params, mask,
                                    comp=comp)
            state, comp = bout if comp is not None else (bout, None)
            if self.scheme.name == "muscl-hancock":
                out = muscl_step_split(state, static, carry.dt, params,
                                       self.config.muscl_variant, comp)
            else:
                out = stencil_step(self.scheme.name, state, static,
                                   carry.dt, params, comp=comp,
                                   simplified_speed=ts.simplified_speed)
            state, speed = out[:2]
            if comp is not None:
                comp = out[2]
            carry = advance(carry, speed, sync_time, end_time, params.dx, ts)
        # NaN/Inf probe: a diverged state never reaches dt/t (non-finite
        # cells mask as dry in the CFL), so fold a zero-scaled state sum
        # into a statistic the host reads anyway: finite states add 0,
        # divergence turns it NaN.
        poison = 0.0 * torch.sum(state.z)
        carry = carry._replace(batch_dt_total=carry.batch_dt_total + poison)
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
        while True:
            t_now = float(self._host_carry[0])
            if t_now >= target_time - tol:
                break
            t0 = time.perf_counter()
            self.state, self.carry, self.comp = self._run_batch(
                self.state, self.carry, self.static, sync, self.comp,
                self._batch_size)
            host = self._read_carry()
            self._host_carry = host
            elapsed = time.perf_counter() - t0
            t_new, dt_now, total, ok, skipped = host
            if not np.isfinite(t_new) or np.isnan(dt_now) or np.isnan(total):
                # dt = +/-inf is NOT divergence: a dry domain has zero wave
                # speed and fast-forwards with a clamped timestep.
                raise RuntimeError(
                    f"Simulation diverged (t={t_new}, dt={dt_now}); "
                    "the CFL wave speed became non-finite")
            self.total_steps = int(ok)
            self.total_skipped = int(skipped)
            if progress is not None:
                progress(self, t_new, elapsed)
            if self.config.batch_auto:
                self._adapt_batch(elapsed)
            if t_new <= t_now and dt_now <= 0.0 \
                    and t_new < target_time - tol:
                raise RuntimeError(
                    f"Simulation stalled at t={t_new:.6f}s "
                    f"(dt={dt_now:.3e})")

    def _adapt_batch(self, elapsed: float):
        """Size batches toward the wall-clock target, in powers of two
        between 8 and 4096 (reference: CSchemeGodunov.cpp:1419-1448)."""
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
    def emit_output(self, t: float):
        """One output event: gather the state to the host once, then run
        the writers."""
        if self.output_writer is not None:
            self.output_writer(_OutputSnapshot(self), t)

    def run(self, progress: Optional[Callable] = None):
        """Full run with outputs at every output_frequency interval."""
        cfg = self.config
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
        return domain_volume(self, self.domain)
