"""Physical and numerical constants for the shallow-water core.

Mirrors the compile-time constants the reference injects into its device code
(reference: src/OpenCL/Executors/CLUniversalHeader.clh:33 GRAVITY;
src/Schemes/CLDynamicTimestep.clh:24-29 timestep limits;
src/Schemes/CSchemeGodunov.cpp:56-57 dry thresholds;
src/Schemes/CLSchemeInertial.clh:24 Froude limit;
src/Boundaries/CLBoundaries.clh:28 hydrological timestep).

In the reference these become ``#define`` specialisation constants at OpenCL
JIT time.  Here they are Python constants; the CUDA sources in ``csrc/``
repeat the ones the fused step kernel needs (``swe_common.cuh``), and
``tests/test_torch_import.py`` holds the two copies equal.
"""

GRAVITY = 9.81

# Depth below which a cell is considered dry ("VERY_SMALL") and the slightly
# larger threshold used by the CFL reduction ("QUITE_SMALL" = 10x).
VERY_SMALL = 1e-10
QUITE_SMALL = 1e-9

# Noise guards for the wet/dry STOPPING conditions in SINGLE precision
# (f32/f32c) only.  The reference compares strictly against 0.0
# (src/Schemes/CLSchemeGodunov.clc:105-133), which is correct in f64 where
# symmetric cross-fluxes cancel exactly — but in f32, rounding leaves
# ghost velocities pointing at dry/wall faces (~1e-7 after one step,
# growing with step count), and a strict test then zeroes the cell's
# ENTIRE discharge (both components), repeatedly killing the along-flow
# momentum at fronts beside walls (measured: 0.11 m mean depth error on
# the Stoker dam break vs 0.009 in f64).  A toward-dry velocity is
# treated as zero unless it exceeds BOTH
#   * STOP_FLOW_EPS (absolute, m/s or m^2/s): two decades above f32 ulp
#     noise on O(1) flows, five below any physical flow; and
#   * STOP_FLOW_REL x the tangential flow magnitude on the same side:
#     accumulated rounding noise is generated BY the tangential flow and
#     stays ~1e-5 of it even after 1e5 steps, while a genuine wall
#     collision or dry-cell drain has a dominant normal component — so
#     the relative term makes the guard robust to unbounded accumulation.
# f64 keeps the strict comparisons for bit parity with the reference and
# the oracle transcriptions.
STOP_FLOW_EPS = 1e-6
STOP_FLOW_REL = 1e-3

# Sentinel marking a disabled cell in the state arrays. A disabled cell has
# z == zmax == NODATA and never updates; neighbours see it as dry.
NODATA = -9999.0

# Bed elevation used to impose a closed ("wall") domain edge.
CLOSED_EDGE_ELEVATION = 9999.9

# Dynamic timestep controls.
TIMESTEP_MINIMUM = 1e-10
TIMESTEP_MAXIMUM = 15.0
TIMESTEP_EARLY_LIMIT = 0.1
TIMESTEP_EARLY_LIMIT_DURATION = 60.0
TIMESTEP_START_MINIMUM = 1e-10
TIMESTEP_START_MINIMUM_DURATION = 1.0

# Hydrological processes (rainfall/losses) accumulate over their own, larger
# timestep before being applied.
TIMESTEP_HYDROLOGICAL = 1.0

# Froude-number discharge limiter for the partial-inertial scheme.
FROUDE_LIMIT = 0.8

# MINMOD/MINBEE limiter coefficient (reference:
# src/Schemes/Limiters/CLSlopeLimiterMINMOD.clh:23).
MINBEE_BETA = 1.0
