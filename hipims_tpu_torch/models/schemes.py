"""Scheme definitions.  Names match the reference's configuration
vocabulary (reference: src/Schemes/CScheme.cpp:141-175).

First-order Godunov and MUSCL-Hancock are ported; the partial-inertial
scheme is listed in ROADMAP.md (queue 1) and raises until it lands.
"""

from __future__ import annotations

from typing import NamedTuple


class Scheme(NamedTuple):
    """A scheme's name (which ``Simulation._run_batch`` dispatches on) and
    the metadata the runtime needs."""

    name: str
    simplified_speed: bool    # CFL uses sqrt(gh) only (inertial)
    radius: int               # stencil radius = static-ring width


SCHEMES = {
    "godunov": Scheme("godunov", simplified_speed=False, radius=1),
    "muscl-hancock": Scheme("muscl-hancock", simplified_speed=False,
                            radius=2),
}
NOT_PORTED = ("inertial",)


def get_scheme(name: str) -> Scheme:
    key = name.strip().lower().replace("_", "-")
    if key in NOT_PORTED:
        raise NotImplementedError(
            f"scheme '{key}' is not ported to hipims_tpu_torch yet; see "
            "ROADMAP.md (queue 1)")
    if key not in SCHEMES:
        raise ValueError(f"Unknown scheme '{name}'; expected one of "
                         f"{sorted(SCHEMES) + list(NOT_PORTED)}")
    return SCHEMES[key]
