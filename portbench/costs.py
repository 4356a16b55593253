"""The yardstick's table of peaks and its bytes model.

Peak: NVIDIA's H100 SXM data sheet, HBM3 at 3.35 TB/s, at the card's full
700 W; every run prints the card's power limit beside its numbers.  The
float32 peak outside the tensor cores (67 TFLOP/s) binds no step: the
kernels issue a few hundred operations per 48 bytes.

Bytes: a step of any scheme reads each cell's state planes once and
writes them once: z, zmax, qx, qy, zb and n in, z, zmax, qx, qy out, and
under compensated float32 the residue plane in and out (the planes of
chip_smoke.py ``KERNEL_COST`` for K1, K4 and K5b, a07496d; its operation
counts are a hand estimate and are not copied).  Counted for every cell,
wet or dry: a kernel that skipped dry cells' discharges could beat this
bound on a mostly dry grid, which no cell here is.
"""

HBM_BYTES_PER_S = 3.35e12

PLANES_IN, PLANES_OUT = 6, 4
BYTES_PER_VALUE = {"float32": 4, "float32c": 4, "float64": 8}


def step_bytes(cells, precision):
    """Bytes one step of ``cells`` cells must move in ``precision``
    ("float32", "float32c" or "float64")."""
    planes = PLANES_IN + PLANES_OUT + (2 if precision == "float32c" else 0)
    return planes * BYTES_PER_VALUE[precision] * cells


def step_bound_s(cells, precision):
    """The least seconds a step could take: its bytes over the HBM rate."""
    return step_bytes(cells, precision) / HBM_BYTES_PER_S
