"""Halo-deep stepping over a mesh of blocks ("forecast" sync).

The reference's novel multi-domain mode lets each domain free-run several
iterations between halo exchanges, bounded by the halo depth ("rollback
limit" = overlap - 1; reference: src/Domain/CDomainBase.cpp:163-174,
CSchemeGodunov.cpp:1273-1305).  The JAX package runs it as a
``shard_map`` window (``hipims_tpu/parallel/halo_deep.py``); here the same
window runs over ``HaloDeepBlocks``, in one process or across the ranks of
a process group (below):

  1. every block of the mesh holds its share of the grid halo-EXTENDED by
     ``halo_pads`` cells a side, in a zero frame where the block meets the
     grid's edge; the static fields' halos are filled once;
  2. at the top of every exchange window the state's (and comp's) halo
     strips are copied from the neighbours' owned cells, rows full-width
     first and then columns full-height, so the corners arrive in two
     hops; every neighbour's values are taken before any block steps;
  3. the window runs ``window`` steps (1 under ``sync_method="timestep"``):
     each step applies the boundaries on the extended block (``mask`` =
     off the logical ring in global coordinates) and runs the scheme's
     fused step with the block's ``origin``, the logical grid and its
     owned-cell ``speed_window`` (on the card K1, K4, or K2/K5a-P + K3/K5a-C;
     on the CPU their plain versions).  Each step invalidates one more
     halo ring, so the owned cells stay exact;
  4. the time controller runs as in the reference, in one of two modes:
     lock-step (one global max over the blocks' owned-cell speeds per step:
     the analogue of MPI_Allreduce(MIN), src/MPI/CMPIManager.cpp:837-889),
     or, with ``forecast_dt="window"`` and a window above 1 under a CFL
     timestep, a frozen speed times ``dt_safety`` for the whole window, one
     max per window, and a re-run from the window's saved start when the
     observed speed breaks the margin (at most 4 re-runs, after which the
     window is accepted as the JAX package accepts it; ``reruns`` counts
     them).

The blocks stay extended between batches: the state never passes through
one full-grid tensor on the way.  Re-extending it at each batch, as the
JAX package does because its sharded arrays hold no halos, would give the
same values, since every halo cell inside the grid is refreshed at the top
of each window and every one outside it is a zero of the frame.  What
differs from the JAX package by design: the pads are ``window * radius +
1`` with no rounding (its Pallas branch rounds them to 64 for the TPU's
DMA alignment, which the CUDA kernels do not have), blocks may differ by a
row or a column (``mesh.block_spans``), and where not even a window of one
step fits a block, ``Simulation`` raises where the JAX package falls back
to per-step GSPMD halos (ROADMAP.md section 3).

Host reads: in one process lock-step reads nothing; window mode reads one
0-d tensor per window, the ``violated`` predicate (and one more per
re-run), as the JAX package's ``while_loop`` reads it on the device.  In
one process the blocks may lie on several cards (``mesh.make_mesh`` deals
them round-robin): a strip between two of them is a peer copy, and each
block's 0-d maximum is copied to the carry's card; neither waits for the
host, and each block's boundary pass and kernel run on its own card.

Across processes (``parallel/distributed.py``) the geometry stays global:
every rank knows every block's ``own``, ``origin`` and pads, and holds the
tensors, boundaries and force masks of its own blocks only.  A halo strip
between two of its blocks is still copied in place; one between ranks is
sent and received (``dist.batch_isend_irecv``, the rows pass completing
before the columns pass, every rank posting in the same global pair
order).  Each rank takes the ``torch.maximum`` of its blocks' speeds,
then the ranks' values are all-gathered and folded in rank order
(``distributed.max_over_ranks``: gloo's ReduceOp.MAX drops a NaN from
rank 1 or above), so every rank holds the same speed, advances its own
copy of the carry alike and takes the same re-run decisions.  The NaN
probe all-gathers the blocks' sums and adds them in block order, as one
process does.  With the device group (NCCL: ranks on cards of their own,
``distributed.open_groups``) the strips, maxima and sums move card to
card as device tensors, and a lock-step step makes no host read (the
reference's per-step MPI_Allreduce, src/MPI/CMPIManager.cpp:837-889, stays
on the device); window mode reads its one ``violated`` per window, as in
one process.  Without it (ranks sharing a card, or the CPU) every strip
and scalar is staged through host buffers over gloo: one host read per
lock-step step, and one per window in window mode.

Output events read the blocks in one of two ways.  The gathered path's
``state``, ``static`` and ``comp`` assemble each plane's owned cells into
one full-grid tensor on the first local block's device.  The streamed
path (runtime/sharded_io.py) assembles nothing: an ``OwnedPlane`` copies a
row chunk of the grid to the host from the owned cells of each block the
rows cross, samples cells on the blocks that own them, and ``owned`` gives
the owned views a volume sums block by block.  Across processes each rank
fills the parts its blocks own and the rest arrives by one all-gather of
the ranks' parts (``distributed.all_gather_host``), so every rank holds
the whole chunk, cell sample or grid, as JAX's ``process_allgather``
gives it: collective, so every rank makes the same reads.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..ops.boundaries import apply_boundaries, interior_force_mask
from ..ops.kernels.muscl_split import muscl_step_split
from ..ops.kernels.stencil import stencil_step
from ..ops.timestep import advance, max_wave_speed
from ..state import DomainStatic, FlowState, StepCarry
from . import distributed
from .mesh import Mesh, block_geometry

# Re-runs of one window before it is accepted as it stands
# (hipims_tpu/parallel/halo_deep.py:334-362).
MAX_RERUNS = 4


def halo_pads(window: int, radius: int):
    """(pad_r, pad_c) halo depths for one exchange window: the cells a
    window of ``window`` steps invalidates, ``window * radius``, plus one,
    since the outermost extended ring never updates.  The JAX package's
    Pallas branch rounds these up for the TPU's DMA alignment; the CUDA
    kernels take any shape, so the port keeps its XLA branch's pads."""
    need = window * radius + 1
    return need, need


def extend(full, own, pads, device):
    """The block ``own`` = (r0, nr, c0, nc) of the full-grid plane
    ``full``, extended by ``pads`` cells a side on ``device``: cells
    inside the grid take the grid's values, cells outside it are 0 (the
    JAX package's zero frame; they lie on the logical ring, so every step
    freezes them, and outside the owned window, so no CFL max sees
    them)."""
    rows, cols = full.shape
    r0, nr, c0, nc = own
    pr, pc = pads
    out = torch.zeros((nr + 2 * pr, nc + 2 * pc), dtype=full.dtype,
                      device=device)
    y0, y1 = max(r0 - pr, 0), min(r0 + nr + pr, rows)
    x0, x1 = max(c0 - pc, 0), min(c0 + nc + pc, cols)
    oy, ox = r0 - pr, c0 - pc
    out[y0 - oy:y1 - oy, x0 - ox:x1 - ox].copy_(full[y0:y1, x0:x1])
    return out


@dataclasses.dataclass
class Block:
    """One block of the mesh: where it lies, and its extended planes."""

    index: tuple                    # (iy, ix) in the mesh
    rank: int                       # the process that owns it
    device: torch.device
    own: tuple                      # (r0, nr, c0, nc) of the logical grid
    origin: tuple                   # global index of the extended [0, 0]
    speed_window: tuple             # the owned cells in the extended array
    static: DomainStatic = None     # this rank's blocks only, from here on
    boundaries: tuple = ()
    force_mask: torch.Tensor = None
    state: FlowState = None
    comp: torch.Tensor = None

    @property
    def interior(self):
        r0, nr, c0, nc = self.speed_window
        return slice(r0, r0 + nr), slice(c0, c0 + nc)


def _max_on(values, device):
    """The max of 0-d tensors, on ``device`` (NaN propagates)."""
    out = None
    for v in values:
        v = v.to(device)
        out = v if out is None else torch.maximum(out, v)
    return out


def _carry_on(carry: StepCarry, device) -> StepCarry:
    """``carry`` on ``device`` (itself when it is there already)."""
    if carry.t.device == device:
        return carry
    return StepCarry(*(v.to(device) for v in carry))


def _strip(a, axis, start, stop):
    """Rows (axis 0) or columns (axis 1) [start, stop) of ``a``."""
    return a[start:stop] if axis == 0 else a[:, start:stop]


class HaloDeepBlocks:
    """The blocks of a mesh run and their halo-deep window (module
    docstring): ``layout`` is every block of the mesh, ``blocks`` this
    rank's (all of them in one process).  ``run_batch`` advances the
    carry, which lives on the first local block's device, by
    ``n_windows`` windows."""

    def __init__(self, mesh: Mesh, scheme, params, ts_params,
                 boundaries: Sequence, domain, state: FlowState,
                 static: DomainStatic, comp, window: int, end_time: float,
                 muscl_variant=None, dt_mode: str = "window",
                 dt_safety: float = 1.05):
        self.mesh = mesh
        self.scheme = scheme
        self.params = params
        self.ts_params = ts_params
        self.window = window
        self.end_time = end_time
        self.muscl_variant = muscl_variant
        self.dt_safety = dt_safety
        self.logical = (domain.rows, domain.cols)
        self.pads = halo_pads(window, scheme.radius)
        # Fixed dt opts out of the CFL law: its windows run lock-step, as
        # the JAX package's (hipims_tpu/parallel/halo_deep.py:293-298).
        self.amortise = (dt_mode == "window" and window > 1
                         and ts_params.dynamic)
        self.reruns = 0
        self.rank = distributed.rank()
        self.distributed = distributed.world_size() > 1
        # Device tensors between ranks on this group; None: host-staged.
        self.device_group = distributed.device_group()
        pr, pc = self.pads
        self.layout, self.blocks = [], []
        for (iy, ix), own in sorted(block_geometry(*self.logical,
                                                   mesh.shape).items()):
            r0, nr, c0, nc = own
            b = Block(index=(iy, ix), rank=int(mesh.ranks[iy, ix]),
                      device=mesh.devices[iy, ix], own=own,
                      origin=(r0 - pr, c0 - pc),
                      speed_window=(pr, nr, pc, nc))
            self.layout.append(b)
            if b.rank != self.rank:
                continue
            shape = (nr + 2 * pr, nc + 2 * pc)
            b.static = DomainStatic(*(extend(a, own, self.pads, b.device)
                                      for a in static))
            b.boundaries = tuple(b_.to(b.device, state.z.dtype, domain,
                                       origin=b.origin, shape=shape)
                                 for b_ in boundaries)
            b.force_mask = interior_force_mask(shape, scheme.radius,
                                               b.device, b.origin,
                                               self.logical)
            self.blocks.append(b)
        if not self.blocks:
            raise ValueError(f"rank {self.rank} owns no block of the "
                             f"{mesh.shape} mesh")
        self._staging = {}
        self.load_state(state)
        self.load_comp(comp)

    # ------------------------------------------------------------------
    # The full grid in and out.
    def load_state(self, state: FlowState):
        """Scatter a full-grid state into this rank's blocks (and their
        halos)."""
        for b in self.blocks:
            b.state = FlowState(*(extend(a, b.own, self.pads, b.device)
                                  for a in state))

    def load_comp(self, comp):
        """Scatter a full-grid comp plane (or None) into this rank's
        blocks."""
        for b in self.blocks:
            b.comp = (None if comp is None
                      else extend(comp, b.own, self.pads, b.device))

    def exchange(self, parts, count):
        """{block index: 1-D host tensor} for every block of the mesh from
        ``parts``, the same for this rank's blocks, given ``count(block)``,
        the length of any block's part (known on every rank).  One
        all-gather across processes; ``parts`` itself in one."""
        if not self.distributed:
            return parts
        sizes = [0] * distributed.world_size()
        for b in self.layout:
            sizes[b.rank] += count(b)
        got = distributed.all_gather_host(
            torch.cat([parts[b.index].reshape(-1) for b in self.blocks]),
            sizes)
        out, offsets = dict(parts), [0] * len(sizes)
        for b in self.layout:
            n, o = count(b), offsets[b.rank]
            if b.rank != self.rank:
                out[b.index] = got[b.rank][o:o + n]
            offsets[b.rank] += n
        return out

    def _assemble(self, planes):
        """One full-grid tensor on the first local block's device from the
        blocks' owned cells of ``planes`` (one plane per local block); the
        other ranks' blocks arrive by ``exchange``."""
        out = torch.empty(self.logical, dtype=planes[0].dtype,
                          device=self.blocks[0].device)
        parts = {}
        for b, a in zip(self.blocks, planes):
            r0, nr, c0, nc = b.own
            out[r0:r0 + nr, c0:c0 + nc].copy_(a[b.interior])
            if self.distributed:
                parts[b.index] = a[b.interior].reshape(-1).cpu()
        if self.distributed:
            got = self.exchange(parts, lambda b: b.own[1] * b.own[3])
            for b in self.layout:
                if b.rank != self.rank:
                    r0, nr, c0, nc = b.own
                    out[r0:r0 + nr, c0:c0 + nc].copy_(
                        got[b.index].reshape(nr, nc))
        return out

    def state(self) -> FlowState:
        return FlowState(*(self._assemble([b.state[k] for b in self.blocks])
                           for k in range(4)))

    def static(self) -> DomainStatic:
        return DomainStatic(*(self._assemble([b.static[k]
                                              for b in self.blocks])
                              for k in range(2)))

    def comp(self):
        if self.blocks[0].comp is None:
            return None
        return self._assemble([b.comp for b in self.blocks])

    # ------------------------------------------------------------------
    # Reads that assemble nothing (streamed output events).
    def owned(self, name):
        """[(block, view)]: the owned cells of plane ``name`` (a FlowState
        or DomainStatic field, or "comp") in each local block, as views."""
        out = []
        for b in self.blocks:
            if name == "comp":
                a = b.comp
            elif name in FlowState._fields:
                a = getattr(b.state, name)
            else:
                a = getattr(b.static, name)
            out.append((b, a[b.interior]))
        return out

    def plane(self, name) -> "OwnedPlane":
        return OwnedPlane(self, name)

    # ------------------------------------------------------------------
    # The exchange.
    def _refresh_all(self, states, comps):
        """Refresh the halo strips of every plane of ``states`` and
        ``comps`` (one per local block) from the neighbours' owned cells:
        rows full-width first, then columns full-height, which carries
        the corners in two hops."""
        planes = [[st[k] for st in states] for k in range(4)]
        if comps[0] is not None:
            planes.append(list(comps))
        grids = [{b.index: a for b, a in zip(self.blocks, pl)}
                 for pl in planes]
        py, px = self.mesh.shape
        self._pass(grids, [((iy, ix), (iy + 1, ix)) for iy in range(py - 1)
                           for ix in range(px)], 0)
        self._pass(grids, [((iy, ix), (iy, ix + 1)) for ix in range(px - 1)
                           for iy in range(py)], 1)

    def _pass(self, grids, pairs, axis):
        """One pass along ``axis`` (0 rows, 1 columns): each neighbour pair
        (lo, hi) gives hi its low halo from lo's owned cells and lo its
        high halo from hi's.  Every strip read is owned cells and every
        strip written is halo, so the order within a pass does not
        matter.  Pairs of this rank's blocks copy in place (a peer copy
        between two cards); a pair across ranks sends its strip and
        receives the other's through buffers (``_post``), and the pass
        returns once all have landed.

        Every rank posts its sends and receives in the one global pair
        order below, strip by strip.  Correctness depends on it: NCCL
        ignores tags and matches the sends and receives between two ranks
        by the order in which they are posted, and gloo by tag."""
        p = self.pads[axis]
        ranks = {b.index: b.rank for b in self.layout}
        ops, landings = [], []
        for i, (li, hi_) in enumerate(pairs):
            if self.rank not in (ranks[li], ranks[hi_]):
                continue
            for k, grid in enumerate(grids):
                lo, hi = grid.get(li), grid.get(hi_)
                tag = 2 * (i * len(grids) + k)
                if lo is not None:
                    n = lo.shape[axis] - 2 * p
                if lo is not None and hi is not None:
                    _strip(hi, axis, 0, p).copy_(_strip(lo, axis, n, n + p))
                    _strip(lo, axis, n + p, None).copy_(
                        _strip(hi, axis, p, 2 * p))
                elif lo is not None:
                    self._post(ops, landings, axis, ranks[hi_],
                               _strip(lo, axis, n, n + p), tag,
                               _strip(lo, axis, n + p, None), tag + 1)
                else:
                    self._post(ops, landings, axis, ranks[li],
                               _strip(hi, axis, p, 2 * p), tag + 1,
                               _strip(hi, axis, 0, p), tag)
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for dst, buf in landings:
                dst.copy_(buf)

    def _post(self, ops, landings, axis, peer, send, send_tag, recv,
              recv_tag):
        """Queue one strip out to ``peer`` and one in from it, each through
        a contiguous buffer of its exact shape and dtype, kept per (axis,
        tag) for the next exchange: on the device group a device buffer
        beside the strip (NCCL takes contiguous tensors only, and a column
        strip is not one), else a host buffer (pinned for a card's
        strips; gloo checks neither shape nor dtype)."""
        group = self.device_group

        def buffer(key, like):
            buf = self._staging.get(key)
            if buf is None:
                buf = (torch.empty(like.shape, dtype=like.dtype,
                                   device=like.device) if group is not None
                       else torch.empty(like.shape, dtype=like.dtype,
                                        pin_memory=like.is_cuda))
                self._staging[key] = buf
            return buf

        out = buffer((axis, send_tag), send)
        out.copy_(send)
        into = buffer((axis, recv_tag), recv)
        ops.append(dist.P2POp(dist.isend, out, peer, group=group,
                              tag=send_tag))
        ops.append(dist.P2POp(dist.irecv, into, peer, group=group,
                              tag=recv_tag))
        landings.append((recv, into))

    # ------------------------------------------------------------------
    # Steps.
    def _one_step(self, b: Block, st: FlowState, cm, carry: StepCarry):
        """Boundaries and the fused step on one extended block; returns
        (new_state, owned max speed, new comp).  No exchange, no
        controller."""
        c = _carry_on(carry, b.device)
        params = self.params
        bout = apply_boundaries(b.boundaries, st, b.static, c.t, c.dt,
                                c.t_hydro, params, b.force_mask, comp=cm)
        st, cm = bout if cm is not None else (bout, None)
        mesh = dict(origin=b.origin, logical=self.logical,
                    speed_window=b.speed_window)
        if self.scheme.name == "muscl-hancock":
            out = muscl_step_split(st, b.static, c.dt, params,
                                   self.muscl_variant, cm, **mesh)
        else:
            out = stencil_step(self.scheme.name, st, b.static, c.dt, params,
                               comp=cm,
                               simplified_speed=self.ts_params
                               .simplified_speed, **mesh)
        return out[0], out[1], (out[2] if cm is not None else None)

    def _step_all(self, states, comps, carry):
        """One step of every local block from the same carry; returns the
        new states and comps and the max of their owned maxima on the
        carry's device (this rank's only)."""
        out = [self._one_step(b, st, cm, carry)
               for b, st, cm in zip(self.blocks, states, comps)]
        return ([o[0] for o in out], [o[2] for o in out],
                _max_on((o[1] for o in out), carry.t.device))

    def _advance(self, carry, speed, sync_time):
        return advance(carry, speed, sync_time, self.end_time,
                       self.params.dx, self.ts_params)

    def _frozen_window(self, states, comps, carry, g, sync_time):
        """``window`` steps on the frozen speed ``g`` (dt from g *
        dt_safety through the controller's clamp ladder), and the max
        speed observed over them on every rank."""
        smax = torch.zeros_like(g)
        for _ in range(self.window):
            states, comps, local = self._step_all(states, comps, carry)
            carry = self._advance(carry, g * self.dt_safety, sync_time)
            smax = torch.maximum(smax, local)
        return states, comps, carry, distributed.max_over_ranks(smax)

    def owned_max_speed(self, carry):
        """The max wave speed over every block's owned cells."""
        return distributed.max_over_ranks(_max_on((max_wave_speed(
            *(a[b.interior] for a in b.state), b.static.zb[b.interior],
            self.params.quite_small, self.ts_params.simplified_speed)
            for b in self.blocks), carry.t.device))

    def run_batch(self, carry: StepCarry, sync_time, n_windows: int):
        """``n_windows`` exchange windows of ``window`` steps each; returns
        the carry, with the batch's NaN probe folded in."""
        states = [b.state for b in self.blocks]
        comps = [b.comp for b in self.blocks]
        ts, dx, safety = self.ts_params, self.params.dx, self.dt_safety
        # One max seeds the first window's frozen speed.
        g = self.owned_max_speed(carry) if self.amortise else None
        for _ in range(n_windows):
            self._refresh_all(states, comps)
            if not self.amortise:
                for _ in range(self.window):
                    states, comps, gmax = self._step_all(states, comps,
                                                         carry)
                    gmax = distributed.max_over_ranks(gmax)
                    carry = self._advance(carry, gmax, sync_time)
                continue
            saved = (states, comps, carry)
            states, comps, carry, gobs = self._frozen_window(
                states, comps, carry, g, sync_time)
            # The window's dts came from g * dt_safety: valid iff the
            # observed speed kept within the margin.  ~(<=): a NaN
            # observed speed counts as violated.
            tries = 0
            while tries < MAX_RERUNS and bool(~(gobs <= g * safety)):
                # A non-finite observed speed carries no value: double the
                # frozen speed (halve the dt) instead.
                g = torch.where(torch.isfinite(gobs), gobs, g * 2.0)
                s0, m0, c0 = saved
                # The carried-in dt came from the stale speed: cap it too,
                # keeping the negative-dt suspension.
                dt_cap = ts.courant * dx / (g * safety)
                c0 = c0._replace(dt=torch.where(
                    c0.dt > 0.0, torch.minimum(c0.dt, dt_cap), c0.dt))
                states, comps, carry, gobs = self._frozen_window(
                    s0, m0, c0, g, sync_time)
                tries += 1
                self.reruns += 1
            # The observed max seeds the next window's frozen speed.
            g = gobs
        for b, st, cm in zip(self.blocks, states, comps):
            b.state, b.comp = st, cm
        # NaN/Inf probe, as in Simulation._run_batch: divergence poisons
        # the batch statistic the host reads.  Every block's sum, added in
        # block order on every rank.
        sums = {b.index: torch.sum(b.state.z[b.interior]).reshape(1)
                for b in self.blocks}
        if self.distributed and self.device_group is not None:
            # Each rank's blocks are a contiguous run of the layout, so the
            # ranks' parts in rank order are the blocks in block order.
            got = torch.cat(distributed.all_gather_device(
                torch.cat([sums[b.index] for b in self.blocks])))
            sums = {b.index: got[k] for k, b in enumerate(self.layout)}
        elif self.distributed:
            sums = self.exchange({k: v.cpu() for k, v in sums.items()},
                                 lambda b: 1)
        poison = None
        for b in self.layout:
            s = sums[b.index].reshape(()).to(carry.t.device)
            poison = s if poison is None else poison + s
        return carry._replace(batch_dt_total=carry.batch_dt_total
                              + 0.0 * poison)


class OwnedPlane:
    """One plane of a mesh run read through the blocks' owned cells, never
    assembled: its grid ``shape``, its host ``dtype`` (numpy), rows copied
    to the host (``host_rows``) and cells sampled (``host_cells``).  It
    reads the blocks' planes when called, so it follows the run.  Across
    processes each read is collective and every rank gets the whole
    answer."""

    def __init__(self, blocks: HaloDeepBlocks, name: str):
        self._blocks = blocks
        self._name = name
        self.shape = blocks.logical
        self._torch_dtype = blocks.owned(name)[0][1].dtype
        self.dtype = torch.empty((), dtype=self._torch_dtype).numpy().dtype

    def _part(self, values):
        return torch.from_numpy(np.ascontiguousarray(values).reshape(-1))

    def host_rows(self, r0: int, n: int) -> np.ndarray:
        """Rows [r0, r0 + n) of the grid as one host array, each block's
        part copied from its owned cells into its columns."""
        out = np.empty((n, self.shape[1]), dtype=self.dtype)

        def span(b):
            br0, bnr = b.own[:2]
            return max(r0, br0), min(r0 + n, br0 + bnr)

        parts = {}
        for b, a in self._blocks.owned(self._name):
            (lo, hi), br0, bc0, bnc = span(b), b.own[0], b.own[2], b.own[3]
            if lo < hi:
                rows = a[lo - br0:hi - br0].cpu().numpy()
                out[lo - r0:hi - r0, bc0:bc0 + bnc] = rows
            else:
                rows = np.empty((0, bnc), self.dtype)
            parts[b.index] = self._part(rows)
        if self._blocks.distributed:
            def count(b):
                lo, hi = span(b)
                return max(hi - lo, 0) * b.own[3]
            got = self._blocks.exchange(parts, count)
            for b in self._blocks.layout:
                (lo, hi), bc0, bnc = span(b), b.own[2], b.own[3]
                if b.rank != self._blocks.rank and lo < hi:
                    out[lo - r0:hi - r0, bc0:bc0 + bnc] = \
                        got[b.index].numpy().reshape(hi - lo, bnc)
        return out

    def host_cells(self, rows, cols) -> np.ndarray:
        """The (K,) values at cells (rows[k], cols[k]), each read on the
        device of the block that owns it."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        cols = np.asarray(cols, dtype=np.int64).reshape(-1)
        out = np.empty(rows.shape, dtype=self.dtype)

        def mine(b):
            br0, bnr, bc0, bnc = b.own
            return ((rows >= br0) & (rows < br0 + bnr)
                    & (cols >= bc0) & (cols < bc0 + bnc))

        parts = {}
        for b, a in self._blocks.owned(self._name):
            m = mine(b)
            ri = torch.as_tensor(rows[m] - b.own[0], device=a.device)
            ci = torch.as_tensor(cols[m] - b.own[2], device=a.device)
            out[m] = a[ri, ci].cpu().numpy()
            parts[b.index] = self._part(out[m])
        if self._blocks.distributed:
            got = self._blocks.exchange(parts, lambda b: int(mine(b).sum()))
            for b in self._blocks.layout:
                if b.rank != self._blocks.rank:
                    out[mine(b)] = got[b.index].numpy()
        return out
