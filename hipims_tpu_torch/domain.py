"""Cartesian domain: geometry, static fields, initial state, edge treatment.

The host-side description stays numpy; ``Domain.build`` materialises the
device tensors.  Closed ("wall") edges are raised to 9999.9 on the
never-updated edge ring AFTER the initial conditions are evaluated, as in
the reference's applyDomainModifications (reference:
src/Domain/Cartesian/CDomainCartesian.cpp:773-799,
src/Schemes/CSchemeGodunov.cpp:1057).  Edges are 'closed' unless
configured 'open'.  There is no tile padding: tensors have exactly the
raster's shape.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import constants as C
from .state import DomainStatic, make_initial_state

EDGES = ("north", "east", "south", "west")


@dataclasses.dataclass
class Domain:
    """Host-side description of one Cartesian simulation domain."""

    zb: np.ndarray                       # bed elevation (rows, cols)
    manning: np.ndarray
    dx: float
    dy: float
    xll: float = 0.0                     # lower-left corner (world coords)
    yll: float = 0.0
    active: Optional[np.ndarray] = None  # False = disabled (-9999) cells
    edge_treatment: dict = dataclasses.field(
        default_factory=lambda: {e: "closed" for e in EDGES})

    _depth: Optional[np.ndarray] = None
    _fsl: Optional[np.ndarray] = None
    _qx: Optional[np.ndarray] = None
    _qy: Optional[np.ndarray] = None

    def __post_init__(self):
        self.zb = np.asarray(self.zb, dtype=np.float64)
        if self.manning is None:
            self.manning = np.zeros_like(self.zb)
        elif np.isscalar(self.manning):
            self.manning = np.full_like(self.zb, float(self.manning))
        else:
            self.manning = np.asarray(self.manning, dtype=np.float64)
        if self.active is None:
            # NODATA bed cells are disabled (reference handleInputData,
            # src/Domain/CDomain.cpp:294-397).
            self.active = self.zb > C.NODATA + 0.5
        # Vertical datum removed from device-side elevations (set by
        # build(datum_shift=True); 0 until then).
        self.datum = 0.0
        # Pristine bed: initial conditions always evaluate against it, so
        # build() stays idempotent after the walls are raised.
        self._zb0 = self.zb.copy()

    @property
    def rows(self):
        return self.zb.shape[0]

    @property
    def cols(self):
        return self.zb.shape[1]

    @property
    def cell_count(self):
        return self.zb.size

    def set_initial_depth(self, depth):
        self._depth = np.broadcast_to(np.asarray(depth, np.float64),
                                      self.zb.shape)

    def set_initial_fsl(self, fsl):
        self._fsl = np.broadcast_to(np.asarray(fsl, np.float64),
                                    self.zb.shape)

    def set_initial_discharge(self, qx=None, qy=None):
        if qx is not None:
            self._qx = np.broadcast_to(np.asarray(qx, np.float64),
                                       self.zb.shape)
        if qy is not None:
            self._qy = np.broadcast_to(np.asarray(qy, np.float64),
                                       self.zb.shape)

    def apply_edge_treatment(self, width: int = 1):
        """Raise bed walls ``width`` cells wide (the scheme's static-ring
        width) on closed edges, so closed domains conserve mass exactly
        for every scheme; 'open' leaves the static ring as a fixed-state
        ghost row."""
        zb = self.zb
        w = max(1, int(width))
        if self.edge_treatment.get("north") == "closed":
            zb[-w:, :] = C.CLOSED_EDGE_ELEVATION
        if self.edge_treatment.get("south") == "closed":
            zb[:w, :] = C.CLOSED_EDGE_ELEVATION
        if self.edge_treatment.get("east") == "closed":
            zb[:, -w:] = C.CLOSED_EDGE_ELEVATION
        if self.edge_treatment.get("west") == "closed":
            zb[:, :w] = C.CLOSED_EDGE_ELEVATION

    def build(self, dtype, device, apply_edges=True, edge_wall_width=1,
              datum_shift=False):
        """Materialise (FlowState, DomainStatic) tensors on ``device``.

        ``datum_shift`` stores elevations relative to ``self.datum`` =
        floor(min enabled bed).  floor() keeps the shift exactly
        representable in both precisions, so zb - z0 rounds once.  The
        -9999 disabled and 9999.9 wall sentinels are never shifted.
        Single-precision runs shift; f64 runs stay absolute."""
        z0 = 0.0
        if datum_shift:
            enabled0 = self.active & (self._zb0 < 9999.0)
            if enabled0.any():
                z0 = float(np.floor(self._zb0[enabled0].min()))
        self.datum = z0

        zb_init = np.where(self.active, self._zb0 - z0, self._zb0)
        fsl = None if self._fsl is None else self._fsl - z0
        state = make_initial_state(zb_init, depth=self._depth, fsl=fsl,
                                   qx=self._qx, qy=self._qy,
                                   active=self.active, dtype=dtype,
                                   device=device)
        if apply_edges:
            self.apply_edge_treatment(width=edge_wall_width)
        zb_static = np.where(self.active & (self.zb < 9999.0),
                             self.zb - z0, self.zb)

        static = DomainStatic(
            zb=torch.as_tensor(zb_static, device=device).to(dtype),
            manning=torch.as_tensor(self.manning, device=device).to(dtype))
        return state, static
