"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case carries the ``cuda`` marker and skips without a CUDA device.
This module imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips the repo's conftest.py, which sets up JAX).  The
inputs are the adversarial wet/dry random domain of chip_smoke.py, made
with numpy from a seed.  Tolerances: float64 to 1e-12 (bit-equal is
expected under --fmad=false), float32 to rtol 1e-5 / atol 1e-6, and the
true surface z + comp to 1e-6.  At the ragged shapes every kernel is held
to its plain version bit for bit (torch.equal), K4 under three layouts of
the Manning n, K5b also at chunk heights of 1 to 64 rows, and the
recompute chain and K5b to split12.  In mesh mode (a halo-extended block:
``origin``, ``logical``, ``speed_window``) K1, K4, K3, K5a-C and K5b equal
their plain versions bit for bit, their owned cells equal the whole-grid
kernel's, and the one-device defaults given outright change nothing.  A
2x2 mesh dealt over two or more cards in one process equals one card
(lock-step: the one-device run; windows: the same mesh on one card); it
skips where fewer than two cards are visible.  K1
and the split12 pair K2 + K3 also match the port's numpy oracles
(ops/oracle.py, ops/oracle_muscl.py: the JAX package's per-cell
transcriptions of the reference) to 1e-12 in float64, a reference that
does not share the plain versions' code.
"""

import numpy as np
import pytest
import torch

from chip_smoke import ONE_MANNING, patch_manning, random_domain
from hipims_tpu_torch.ops.godunov import SchemeParams
from hipims_tpu_torch.ops.kernels import muscl_split as ms
from hipims_tpu_torch.ops.kernels import stencil as st
from hipims_tpu_torch.ops.oracle import godunov_step_oracle
from hipims_tpu_torch.ops.oracle_muscl import muscl_step_oracle
from hipims_tpu_torch.ops.timestep import max_wave_speed
from hipims_tpu_torch.parallel.halo_deep import extend
from hipims_tpu_torch.state import DomainStatic, FlowState

MODES = ["f64", "f32", "f32c"]
PARAMS = SchemeParams(2.0, 2.0)
# Ragged shapes: all ring for K3 and K5a-C (3x3), one strip of the
# row-marching kernels or less, several chunks, (65, 121), one row past a
# chunk and one column past a strip of the one-lane halo (K1, K3, K4), and
# (65, 113), the same for the two-lane halo of K5a-C, whose warps own 28
# columns (tests/test_torch_geometry.py).
RAGGED = [(3, 3), (5, 5), (4, 37), (33, 65), (130, 97), (65, 121),
          (65, 113)]
# K4's Manning layouts beside random_domain's one value per cell (never
# shared; test_kernels_bit_equal_at_ragged_shapes): one value (each face's
# discharge shared by its two cells), one value per 5x7 patch and one per
# 10x10 patch (shared inside a patch, not across its edges: both branches
# in one warp).
MANNING = ["one", "patches", "blocks"]


def _manning(layout, rows, cols):
    if layout == "one":
        return np.full((rows, cols), ONE_MANNING)
    return patch_manning(rows, cols, *{"patches": (5, 7),
                                       "blocks": (10, 10)}[layout])


def _inputs(mode, rows=32, cols=128, manning=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dtype = torch.float64 if mode == "f64" else torch.float32
    arrs = list(random_domain(0, rows, cols))
    if manning is not None:
        arrs[5] = _manning(manning, rows, cols)
    t = [torch.as_tensor(a, device="cuda").to(dtype) for a in arrs]
    comp = None
    if mode == "f32c":
        rng = np.random.default_rng(1)
        comp = torch.as_tensor(rng.uniform(-1e-7, 1e-7, (rows, cols)),
                               device="cuda").to(dtype)
    dt = torch.tensor(0.05, dtype=dtype, device="cuda")
    return FlowState(*t[:4]), DomainStatic(*t[4:]), comp, dt


def _tol(mode):
    return (dict(rtol=1e-12, atol=1e-12) if mode == "f64"
            else dict(rtol=1e-5, atol=1e-6))


def _assert_step_close(got, want, mode):
    """(new_state, speed[, comp]) results: fields, speed, z + comp."""
    tol = _tol(mode)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), **tol)
    assert float(got[1]) == pytest.approx(float(want[1]), rel=tol["rtol"])
    if len(got) == 3:
        np.testing.assert_allclose(
            (got[0].z.double() + got[2].double()).cpu().numpy(),
            (want[0].z.double() + want[2].double()).cpu().numpy(),
            rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_k1_matches_plain(mode):
    """K1 on the card against its plain version on the same card."""
    state, static, comp, dt = _inputs(mode)
    before = st.godunov_fused.launches
    got = st.stencil_step("godunov", state, static, dt, PARAMS, comp=comp)
    want = st.stencil_step_plain(state, static, dt, PARAMS, comp=comp)
    assert st.godunov_fused.launches == before + 1
    _assert_step_close(got, want, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["godunov", "muscl-hancock"])
@pytest.mark.parametrize("friction", [True, False])
@pytest.mark.parametrize("shape", [(32, 128), (65, 121)])
def test_kernels_match_the_numpy_oracle(scheme, friction, shape):
    """K1, and K2 + K3 (``muscl_step_split``, split12), in float64 on the
    card against the per-cell oracle on the host."""
    state, static, _, dt = _inputs("f64", *shape)
    params = SchemeParams(2.0, 2.0, friction=friction)
    if scheme == "godunov":
        launches = (st.godunov_fused,)
        before = [k.launches for k in launches]
        got = st.stencil_step(scheme, state, static, dt, params)
        oracle = godunov_step_oracle
    else:
        launches = (ms.muscl_predict, ms.muscl_correct)
        before = [k.launches for k in launches]
        got = ms.muscl_step_split(state, static, dt, params, "split12")
        oracle = muscl_step_oracle
    assert [k.launches for k in launches] == [b + 1 for b in before]
    host = [a.cpu().numpy() for a in (*state, *static)]
    want = oracle(*host, 0.05, 2.0, 2.0, friction=friction)
    for g, w, name in zip(got[0], want, ("z", "zmax", "qx", "qy")):
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-12,
                                   atol=1e-12, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["inertial", "muscl-hancock"])
@pytest.mark.parametrize("mode", MODES)
def test_k4_k5b_match_plain(scheme, mode):
    """K4 (partial-inertial, sqrt(gh) CFL speed) and K5b (the fused MUSCL
    step) on the card against their plain versions on the same card; each
    launch counts on its own wrapper only."""
    state, static, comp, dt = _inputs(mode)
    simplified = scheme == "inertial"
    kernel = {"inertial": st.inertial_fused,
              "muscl-hancock": st.muscl_fused}[scheme]
    before = [k.launches for k in st.KERNELS]
    got = st.stencil_step(scheme, state, static, dt, PARAMS, comp=comp,
                          simplified_speed=simplified)
    want = st.PLAIN[scheme](state, static, dt, PARAMS, comp=comp,
                            simplified_speed=simplified)
    assert [k.launches for k in st.KERNELS] == [
        n + (k is kernel) for n, k in zip(before, st.KERNELS)]
    _assert_step_close(got, want, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128), *RAGGED])
@pytest.mark.parametrize("mode", MODES)
def test_k5b_equals_split12_on_card(mode, shape):
    """K5b is the corrector of K3 and K5a-C with its slopes and base
    predicted by K2's own half step: it equals split12 (K2 -> K3) and
    recompute (K5a-P -> K5a-C) bit for bit, fields, max speed and comp."""
    state, static, comp, dt = _inputs(mode, *shape)
    a = st.stencil_step("muscl-hancock", state, static, dt, PARAMS,
                        comp=comp)
    for variant in ("split12", "recompute"):
        b = ms.muscl_step_split(state, static, dt, PARAMS, variant, comp)
        for x, y in zip([*a[0], a[1], *a[2:]], [*b[0], b[1], *b[2:]]):
            assert torch.equal(x, y), variant


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 8, 15, 64])
@pytest.mark.parametrize("mode", MODES)
def test_k5b_bit_equal_by_chunk_height(mode, chunk):
    """K5b at a given number of rows per block equals its plain version
    bit for bit at 3x3 (all ring) and at 4 chunks + 1 rows by 113
    columns: one row past a chunk and one column past a 112-column strip
    (two halo lanes)."""
    for shape in ((3, 3), (4 * chunk + 1, 113)):
        state, static, comp, dt = _inputs(mode, *shape)
        before = st.muscl_fused.launches
        got = ms._fused_cuda(state, static, dt, PARAMS, comp, chunk=chunk)
        want = ms.muscl_step_plain(state, static, dt, PARAMS, comp=comp)
        assert st.muscl_fused.launches == before
        for g, w in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
            assert torch.equal(g, w), shape


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["split12", "recompute"])
@pytest.mark.parametrize("mode", MODES)
def test_muscl_kernels_match_plain(variant, mode):
    """K2 + K3 (split12) or K5a-P + K5a-C (recompute) against their plain
    versions on the same card: every predictor plane, then the
    corrector's result from the plain predictor planes."""
    state, static, comp, dt = _inputs(mode)
    store = variant == "split12"
    pred_k, corr_k = ((ms.muscl_predict, ms.muscl_correct) if store else
                      (ms.muscl_predict_base, ms.muscl_correct_recompute))
    before = (pred_k.launches, corr_k.launches)
    pred = pred_k(state, static, dt, PARAMS)
    want_pred = ms.muscl_predict_plain(state, static, dt, PARAMS,
                                       store_slopes=store)
    np.testing.assert_allclose(pred.cpu().numpy(), want_pred.cpu().numpy(),
                               **_tol(mode))
    got = corr_k(state, static, want_pred, dt, PARAMS, comp=comp)
    want = ms.muscl_correct_plain(state, static, want_pred, dt, PARAMS,
                                  comp=comp)
    assert (pred_k.launches, corr_k.launches) == (before[0] + 1,
                                                  before[1] + 1)
    _assert_step_close(got, want, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("manning", MANNING)
def test_k4_bit_equal_by_manning_layout(manning, mode, shape):
    """K4 computes a face's shared flow once and applies each cell's n to
    it, sharing the whole discharge where the two cells' n agree; either
    way it equals its plain version bit for bit."""
    state, static, comp, dt = _inputs(mode, *shape, manning=manning)
    got, want = _plain_and_kernel("K4", state, static, comp, dt)
    for g, w in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128), *RAGGED])
@pytest.mark.parametrize("mode", MODES)
def test_muscl_variants_equal_on_card(mode, shape):
    """The recompute corrector rebuilds exactly the slopes K2 stores:
    split12 (K2 -> K3) and recompute (K5a-P -> K5a-C, two halo lanes) give
    the same bits, fields, max speed and comp."""
    state, static, comp, dt = _inputs(mode, *shape)
    a = ms.muscl_step_split(state, static, dt, PARAMS, "split12", comp)
    b = ms.muscl_step_split(state, static, dt, PARAMS, "recompute", comp)
    for x, y in zip([*a[0], a[1], *a[2:]], [*b[0], b[1], *b[2:]]):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_muscl_kernels_reject_bad_inputs():
    state, static, comp, dt = _inputs("f32")
    with pytest.raises(ValueError, match="predictor planes"):
        ms.muscl_correct(state, static, torch.zeros_like(state.z), dt,
                         PARAMS)
    with pytest.raises(ValueError, match="dt must be"):
        ms.muscl_predict(state, static, dt.double(), PARAMS)


def _plain_and_kernel(name, state, static, comp, dt, **mesh):
    """(kernel result, plain result) of kernel ``name`` on the inputs, with
    the ``mesh`` options; the correctors take the plain predictor's
    planes."""
    pred = ms.muscl_predict_plain(state, static, dt, PARAMS)
    base = pred[:4].contiguous()
    return {
        "K1": lambda: (
            st.godunov_fused(state, static, dt, PARAMS, comp=comp, **mesh),
            st.stencil_step_plain(state, static, dt, PARAMS, comp=comp,
                                  **mesh)),
        "K3": lambda: (
            ms.muscl_correct(state, static, pred, dt, PARAMS, comp=comp,
                             **mesh),
            ms.muscl_correct_plain(state, static, pred, dt, PARAMS,
                                   comp=comp, **mesh)),
        "K4": lambda: (
            st.inertial_fused(state, static, dt, PARAMS, comp=comp, **mesh),
            st.inertial_step_plain(state, static, dt, PARAMS, comp=comp,
                                   **mesh)),
        "K5a-C": lambda: (
            ms.muscl_correct_recompute(state, static, base, dt, PARAMS,
                                       comp=comp, **mesh),
            ms.muscl_correct_plain(state, static, base, dt, PARAMS,
                                   comp=comp, **mesh)),
        "K5b": lambda: (
            st.muscl_fused(state, static, dt, PARAMS, comp=comp, **mesh),
            st.muscl_step_plain(state, static, dt, PARAMS, comp=comp,
                                **mesh)),
    }[name]()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["K1", "K3", "K4", "K5a-C", "K5b"])
def test_kernels_bit_equal_at_ragged_shapes(name, mode, shape):
    """The row-marching K1, K3, K4 and K5a-C, and K5b on its own launch
    path, equal their plain versions bit for bit: fields, max speed and
    comp."""
    state, static, comp, dt = _inputs(mode, *shape)
    got, want = _plain_and_kernel(name, state, static, comp, dt)
    for g, w in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        assert torch.equal(g, w)


MESH_KERNELS = ["K1", "K3", "K4", "K5a-C", "K5b"]


def _mesh_options(rows, cols):
    """A block whose [0, 0] is the global cell (-3, 50) of a grid that
    ends 5 columns before the block does: the logical ring crosses it on
    its north and east sides; it owns all but 5 rows and 9 columns a
    side."""
    return dict(origin=(-3, 50), logical=(rows + 40, 50 + cols - 5),
                speed_window=(5, rows - 10, 9, cols - 18))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 128), (65, 121), (65, 113)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MESH_KERNELS)
def test_mesh_mode_kernels_bit_equal(name, mode, shape):
    """K1, K4, K3, K5a-C and K5b with a block's origin, logical grid and
    owned window equal their plain versions bit for bit, at an aligned
    shape and at the ragged ones of either halo width."""
    state, static, comp, dt = _inputs(mode, *shape)
    got, want = _plain_and_kernel(name, state, static, comp, dt,
                                  **_mesh_options(*shape))
    for g, w in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("own", [(0, 40, 0, 50), (40, 41, 60, 70),
                                 (81, 49, 130, 67)])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MESH_KERNELS)
def test_mesh_mode_owned_cells_equal_the_whole_grid(name, mode, own):
    """One step of a block of the 130 x 197 grid, extended by 3 cells a
    side into a zero frame (the halo-deep window's layout): its owned
    cells equal the whole-grid kernel's same cells, bit for bit, and its
    max speed is the max over them."""
    state, static, comp, dt = _inputs(mode, 130, 197)
    pad = 3
    r0, nr, c0, nc = own

    def ext(a):
        return None if a is None else extend(a, own, (pad, pad), a.device)

    block = (FlowState(*map(ext, state)), DomainStatic(*map(ext, static)),
             ext(comp))
    whole, _ = _plain_and_kernel(name, state, static, comp, dt)
    got, _ = _plain_and_kernel(
        name, *block, dt, origin=(r0 - pad, c0 - pad), logical=(130, 197),
        speed_window=(pad, nr, pad, nc))
    mine = (slice(pad, pad + nr), slice(pad, pad + nc))
    theirs = (slice(r0, r0 + nr), slice(c0, c0 + nc))
    for g, w in zip([*got[0], *got[2:]], [*whole[0], *whole[2:]]):
        assert torch.equal(g[mine], w[theirs])
    new = whole[0]
    assert torch.equal(got[1], max_wave_speed(
        *(a[theirs] for a in new), static.zb[theirs], PARAMS.quite_small,
        name == "K4"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MESH_KERNELS)
def test_mesh_defaults_change_nothing(name, mode):
    """The one-device options given outright launch the same bits as no
    options."""
    rows, cols = 65, 121
    state, static, comp, dt = _inputs(mode, rows, cols)
    plain, _ = _plain_and_kernel(name, state, static, comp, dt)
    given, _ = _plain_and_kernel(name, state, static, comp, dt,
                                 origin=(0, 0), logical=(rows, cols),
                                 speed_window=(0, rows, 0, cols))
    for g, w in zip([*given[0], *given[1:]], [*plain[0], *plain[1:]]):
        assert torch.equal(g, w)


def _nan_manning_inputs(mode):
    """_inputs at 33x65 with a NaN Manning n in one wet interior cell;
    returns them and that cell."""
    state, static, comp, dt = _inputs(mode, 33, 65)
    depth = (state.z - static.zb).cpu().numpy()
    wet = np.argwhere(depth[2:-2, 2:-2] > 0.5) + 2
    r, c = (int(v) for v in wet[len(wet) // 2])
    manning = static.manning.clone()
    manning[r, c] = float("nan")
    return (state, DomainStatic(static.zb, manning), comp, dt), (r, c)


def _assert_bit_equal_nan(got, want):
    for g, w in zip([*got[0], *got[1:]], [*want[0], *want[1:]]):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["K1", "K3", "K5a-C", "K5b"])
def test_nan_reaches_the_max_speed(name, mode):
    """A NaN Manning n in one wet interior cell turns that cell's
    discharge NaN through friction while its depth stays finite, so the
    kernel's max speed is NaN, as the plain version's; kernel and plain
    version agree bit for bit, NaN for NaN."""
    inputs, _ = _nan_manning_inputs(mode)
    got, want = _plain_and_kernel(name, *inputs)
    _assert_bit_equal_nan(got, want)
    assert torch.isnan(want[1]) and torch.isnan(got[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_k4_nan_manning_stays_out_of_the_max_speed(mode):
    """K4 with a NaN Manning n in one wet interior cell: every wet face of
    that cell carries its n, so its surface and discharges turn NaN (its
    neighbours, whose n differs, apply their own).  The sqrt(g h) speed
    counts a cell as wet only where h > qs, which a NaN depth is not, so
    the NaN stays in the state and the max speed is finite, in the plain
    version as in the JAX package's max_wave_speed.  Kernel and plain
    version agree bit for bit, NaN for NaN."""
    inputs, (r, c) = _nan_manning_inputs(mode)
    got, want = _plain_and_kernel("K4", *inputs)
    _assert_bit_equal_nan(got, want)
    assert torch.isnan(got[0].z[r, c]) and torch.isnan(want[0].z[r, c])
    assert not torch.isnan(got[1]) and not torch.isnan(want[1])


# ---------------------------------------------------------------------------
# Streamed output I/O on the card (runtime/sharded_io.py).

def _stream_sim(io_mode, mesh_shape, writer_dir):
    """A circular dam at 61 x 67 in f32c on the card (on a lock-step mesh
    of ``mesh_shape`` blocks sharing it), 8-row chunks, with depth (TIFF),
    fsl (ASC) and maxdepth (HFA) rasters and depth gauges."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from hipims_tpu_torch.domain import Domain
    from hipims_tpu_torch.parallel import make_mesh
    from hipims_tpu_torch.runtime import Simulation, SimulationConfig
    from hipims_tpu_torch.runtime import output as out

    rows, cols = 61, 67
    yy, xx = np.mgrid[0:rows, 0:cols]
    dom = Domain(zb=0.3 * np.sin(yy / 5.0) * np.cos(xx / 7.0),
                 manning=0.02, dx=2.0, dy=2.0)
    dom.set_initial_depth(np.where(
        np.hypot(yy - rows / 2, xx - cols / 2) * 2.0 <= rows / 2.5, 1.5,
        0.1))
    cfg = SimulationConfig(duration=8.0, output_frequency=4.0,
                           dtype="float32c", batch_size=8, batch_auto=False,
                           io_mode=io_mode, io_chunk_mb=0)
    mesh = None if mesh_shape is None else make_mesh(shape=mesh_shape)
    sim = Simulation(dom, cfg, device=None if mesh else "cuda", mesh=mesh)
    sim.output_writer = out.CompositeOutputWriter([
        out.RasterOutputWriter(
            [dict(value="depth", format="tif", target="depth_%t.tif"),
             dict(value="fsl", format="asc", target="fsl_%t.asc"),
             dict(value="maxdepth", format="hfa", target="md_%t.img")],
            str(writer_dir), dom),
        out.GaugeOutputWriter("depth", [(40.0, 40.0, "G1"),
                                        (96.0, 100.0, "G2")],
                              writer_dir / "gauges.csv", dom)])
    sim.checkpoint_path = writer_dir / "ck.npz"
    return sim


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_streamed_outputs_equal_gathered_on_card(tmp_path, mesh_shape):
    """On CUDA tensors, with and without a 2x2 mesh: the streamed rasters
    (TIFF, ASC, HFA) and gauge CSV are the gathered run's bytes, the
    checkpoints' members are equal, and the volumes, float64 sums on the
    card, equal the float64 host sum of the state (rel 1e-12)."""
    files, volumes = {}, {}
    for mode in ("gather", "stream"):
        sim = _stream_sim(mode, mesh_shape, tmp_path / mode)
        sim.run()
        volumes[mode] = sim.volume()
        st, zb = sim.state_logical, sim.static_logical.zb
        h = np.maximum(st.z.astype(np.float64) - zb, 0.0)
        h[st.zmax <= -9999.0] = 0.0
        assert volumes[mode] == pytest.approx(
            h.sum() * sim.domain.dx * sim.domain.dy, rel=1e-12)
        files[mode] = {p.name: p.read_bytes()
                       for p in (tmp_path / mode).iterdir()
                       if p.suffix != ".npz"}
    assert len(files["gather"]) == 7 and files["gather"] == files["stream"]
    with np.load(tmp_path / "gather" / "ck.npz") as g, \
            np.load(tmp_path / "stream" / "ck.npz") as s:
        assert g.files == s.files and "comp" in s.files
        for k in g.files:
            np.testing.assert_array_equal(g[k], s[k], err_msg=k)
    assert volumes["stream"] == pytest.approx(volumes["gather"], rel=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh_shape", [None, (2, 2)])
def test_chunk_copies_read_cuda_planes(tmp_path, mesh_shape):
    """A streamed snapshot's chunks come from the CUDA planes (a tensor,
    or a mesh's blocks) and re-assemble to them; sampled cells equal the
    planes' values."""
    from hipims_tpu_torch.runtime import sharded_io as sio
    from hipims_tpu_torch.runtime.simulation import _StreamingSnapshot

    sim = _stream_sim("stream", mesh_shape, tmp_path)
    sim.run_to(4.0)
    snap = _StreamingSnapshot(sim)
    plane = snap.plane("z")
    if mesh_shape is None:
        assert plane.is_cuda
    else:
        assert all(a.is_cuda for _, a in sim._blocks.owned("z"))
    want = sim.state.z.cpu().numpy()
    for reverse in (False, True):
        got = np.full_like(want, np.nan)
        for r0, chunk in sio.stream_rows(plane, 8, reverse=reverse):
            assert isinstance(chunk, np.ndarray) and chunk.shape[0] <= 8
            got[r0:r0 + chunk.shape[0]] = chunk
        np.testing.assert_array_equal(got, want)
    rows, cols = [3, 30, 31, 60], [0, 33, 34, 66]
    np.testing.assert_array_equal(sio.host_cells(plane, rows, cols),
                                  want[rows, cols])


# ---------------------------------------------------------------------------
# A mesh over several cards in one process (parallel/halo_deep.py).

def _dam_sim(mesh, sync):
    """_stream_sim's circular dam in f32c, lock-step or in windows of 3,
    fixed batches of 8, on ``mesh`` (or cuda:0 without one)."""
    from hipims_tpu_torch.domain import Domain
    from hipims_tpu_torch.runtime import Simulation, SimulationConfig

    rows, cols = 61, 67
    yy, xx = np.mgrid[0:rows, 0:cols]
    dom = Domain(zb=0.3 * np.sin(yy / 5.0) * np.cos(xx / 7.0),
                 manning=0.02, dx=2.0, dy=2.0)
    dom.set_initial_depth(np.where(
        np.hypot(yy - rows / 2, xx - cols / 2) * 2.0 <= rows / 2.5, 1.5,
        0.1))
    cfg = SimulationConfig(duration=8.0, output_frequency=8.0,
                           dtype="float32c", batch_size=8, batch_auto=False,
                           sync_method=sync, forecast_window=3)
    return Simulation(dom, cfg, device=None if mesh else "cuda:0",
                      mesh=mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("sync", ["timestep", "forecast"])
def test_mesh_over_cards_equals_one_card(sync):
    """A 2x2 mesh dealt round-robin over the visible cards (two or more):
    each block's boundary pass and kernel run on its own card, strips
    cross as peer copies and the maxima meet on the carry's card.
    Lock-step equals the one-device run bit for bit; windows of 3 equal
    the same mesh on one card in state, comp, steps and re-runs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2+ CUDA devices")
    from hipims_tpu_torch.parallel import make_mesh

    cards = make_mesh(shape=(2, 2))
    assert len({str(d) for d in cards.devices.flat}) == min(
        4, torch.cuda.device_count())
    ref = _dam_sim(None if sync == "timestep"
                   else make_mesh(shape=(2, 2),
                                  devices=[torch.device("cuda", 0)] * 4),
                   sync)
    sim = _dam_sim(cards, sync)
    for s in (ref, sim):
        s.run()
    assert sim.t == ref.t and sim.total_steps == ref.total_steps
    assert sim.window_reruns == ref.window_reruns
    for a, b in zip([*sim.state, sim.comp], [*ref.state, ref.comp]):
        assert a.device == torch.device("cuda", 0)
        assert torch.equal(a, b.to(a.device))
    for b in sim._blocks.blocks:
        assert all(a.device == b.device for a in (*b.state, b.comp))
