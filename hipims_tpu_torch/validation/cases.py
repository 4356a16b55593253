"""Closed-form shallow-water solutions for validation.

Three classical cases:

* Thacker's planar sloshing in a parabolic bowl (frictionless): tests
  numerical diffusion and moving wet/dry fronts against an exact
  oscillation (reference analogue: tools/model-builder/tests/
  TestSloshingBowl.js).
* Stoker's wet-bed dam break: exact rarefaction + shock solution.
* Ritter's dry-bed dam break: exact rarefaction fan with a dry front
  (reference analogue: TestDamBreakEmergingBed.js).
"""

from __future__ import annotations

import dataclasses

import numpy as np

G = 9.81


# ------------------------------------------------------------- Thacker ----

@dataclasses.dataclass
class SloshingBowl:
    """Planar oscillation in the 1-D parabolic bowl zb = h0 * x^2 / a^2.

    Exact frictionless solution (Thacker 1981): uniform velocity
    u(t) = -(g A / w) sin(w t), planar surface
    z(x, t) = A cos(w t) x + b0 - (g A^2 / (4 w^2)) cos(2 w t),
    with w^2 = 2 g h0 / a^2.
    """

    h0: float = 10.0      # bowl depth scale
    a: float = 3000.0     # bowl half-width scale
    amp: float = 0.002    # surface slope amplitude A
    b0: float = 10.0      # mean surface level (= h0: centre depth h0,
                          # shoreline at x = +-a)

    @property
    def omega(self) -> float:
        return np.sqrt(2.0 * G * self.h0) / self.a

    @property
    def period(self) -> float:
        return 2.0 * np.pi / self.omega

    def bed(self, x):
        return self.h0 * (np.asarray(x) ** 2) / self.a ** 2

    def surface(self, x, t):
        w = self.omega
        a_t = self.amp * np.cos(w * t)
        beta = self.b0 - (G * self.amp ** 2 / (4.0 * w ** 2)) \
            * np.cos(2.0 * w * t)
        z = a_t * np.asarray(x) + beta
        return np.maximum(z, self.bed(x))

    def velocity(self, t):
        return -(G * self.amp / self.omega) * np.sin(self.omega * t)

    def depth(self, x, t):
        return self.surface(x, t) - self.bed(x)


def sloshing_bowl(n=128, pad=1.3, **kw):
    """Build (x, zb, z0) 1-D arrays for a sloshing-bowl run plus the case
    object.  ``pad`` widens the domain beyond the initial shoreline."""
    case = SloshingBowl(**kw)
    # Initial shoreline where surface(t=0) meets the bed.
    x_max = case.a * pad
    x = np.linspace(-x_max, x_max, n)
    zb = case.bed(x)
    z0 = case.surface(x, 0.0)
    return x, zb, z0, case


# ------------------------------------------------------------- Stoker -----

def stoker_wet_dam_break(h_l, h_r, x, t, x0=0.0):
    """Exact wet-bed dam-break profile (Stoker 1957).

    Returns (h, u) at positions x and time t for initial depths h_l > h_r
    separated at x0.  The intermediate depth solves the shock condition;
    found by bisection.
    """
    cl = np.sqrt(G * h_l)

    def f(hm):
        cm = np.sqrt(G * hm)
        # Shock speed from Rankine-Hugoniot:
        s = hm / (hm - h_r) * np.sqrt(0.5 * G * h_r / hm * (hm + h_r)) \
            if hm > h_r else np.inf
        um = 2.0 * (cl - cm)
        return um - (hm - h_r) * np.sqrt(0.5 * G * (hm + h_r)
                                         / (hm * h_r))

    lo, hi = h_r * (1 + 1e-12), h_l
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(mid) > 0:
            lo = mid
        else:
            hi = mid
    hm = 0.5 * (lo + hi)
    cm = np.sqrt(G * hm)
    um = 2.0 * (cl - cm)
    s = hm * um / (hm - h_r)   # shock speed from mass conservation

    xi = (np.asarray(x) - x0) / max(t, 1e-300)
    h = np.empty_like(xi)
    u = np.empty_like(xi)
    # Regions: undisturbed left | rarefaction | plateau | shock | right.
    left = xi <= -cl
    fan = (xi > -cl) & (xi <= um - cm)
    plat = (xi > um - cm) & (xi <= s)
    right = xi > s
    h[left] = h_l
    u[left] = 0.0
    h[fan] = (2.0 * cl - xi[fan]) ** 2 / (9.0 * G)
    u[fan] = 2.0 / 3.0 * (xi[fan] + cl)
    h[plat] = hm
    u[plat] = um
    h[right] = h_r
    u[right] = 0.0
    return h, u


# ------------------------------------------------------------- Ritter -----

def ritter_dry_dam_break(h_l, x, t, x0=0.0):
    """Exact dry-bed dam-break profile (Ritter 1892): rarefaction fan with
    front at x0 + 2 c_l t."""
    cl = np.sqrt(G * h_l)
    xi = (np.asarray(x) - x0) / max(t, 1e-300)
    h = np.zeros_like(xi)
    u = np.zeros_like(xi)
    left = xi <= -cl
    fan = (xi > -cl) & (xi < 2.0 * cl)
    h[left] = h_l
    h[fan] = (2.0 * cl - xi[fan]) ** 2 / (9.0 * G)
    u[fan] = 2.0 / 3.0 * (xi[fan] + cl)
    return h, u
