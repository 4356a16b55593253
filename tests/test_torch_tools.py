"""The port's host tools against the JAX package's, on the CPU: every
model-builder type, whole and decomposed, writes the same files byte for
byte; the validation closed forms agree to 1e-15; the BNG tile tool gives
the same names, coordinates and mosaics."""

import numpy as np
import pytest

from hipims_tpu.tools import bng as jbng
from hipims_tpu.tools.model_builder import BUILDERS as J_BUILDERS
from hipims_tpu.tools.model_builder import main as j_main
from hipims_tpu.validation import cases as jcases
from hipims_tpu_torch.io.raster import Raster, write_raster
from hipims_tpu_torch.tools import bng
from hipims_tpu_torch.tools.model_builder import BUILDERS
from hipims_tpu_torch.tools.model_builder import main as t_main
from hipims_tpu_torch.validation import cases


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("extra", [
    [], ["--decompose", "2"],
    ["--decompose", "3", "--decompose-overlap", "6", "--sync-method",
     "forecast"]], ids=["whole", "two-bands", "three-bands-forecast"])
@pytest.mark.parametrize("kind", sorted(J_BUILDERS))
def test_model_builder_writes_the_jax_builders_bytes(tmp_path, kind, extra,
                                                     capsys):
    assert set(BUILDERS) == set(J_BUILDERS)
    args = ["-t", kind, "--resolution", "4"] if kind == "pluvial" \
        else ["-t", kind]
    assert t_main([*args, "-d", str(tmp_path / "torch"), *extra]) == 0
    assert j_main([*args, "-d", str(tmp_path / "jax"), *extra]) == 0
    got, want = _files(tmp_path / "torch"), _files(tmp_path / "jax")
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    xml = next(n for n in got if n.suffix == ".xml")
    assert got[xml].count(b"<domain ") == (int(extra[1]) if extra else 1)


def test_validation_closed_forms_match_jax():
    x = np.linspace(-50.0, 50.0, 401)
    for t in (0.0, 0.7, 3.0, 9.5):
        for got, want in ((cases.stoker_wet_dam_break(2.0, 0.3, x, t, 1.5),
                           jcases.stoker_wet_dam_break(2.0, 0.3, x, t,
                                                       1.5)),
                          (cases.ritter_dry_dam_break(1.2, x, t, -2.0),
                           jcases.ritter_dry_dam_break(1.2, x, t, -2.0))):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-15, atol=1e-15)
    (gx, gzb, gz0, gcase), (wx, wzb, wz0, wcase) = (
        cases.sloshing_bowl(n=64), jcases.sloshing_bowl(n=64))
    for g, w in ((gx, wx), (gzb, wzb), (gz0, wz0)):
        np.testing.assert_allclose(g, w, rtol=1e-15, atol=1e-15)
    for t in (0.0, 1.3, gcase.period / 3):
        np.testing.assert_allclose(gcase.surface(gx, t),
                                   wcase.surface(wx, t), rtol=1e-15,
                                   atol=1e-15)
        assert gcase.velocity(t) == pytest.approx(wcase.velocity(t),
                                                  rel=1e-15, abs=1e-15)


def test_bng_matches_jax(tmp_path):
    for e, n in ((424520, 565146), (530000, 180000), (0, 0),
                 (699999, 1299999), (700001, 0)):
        for p in range(6):
            assert bng.en_to_ref(e, n, p) == jbng.en_to_ref(e, n, p)
    for ref in ("NZ26", "TQ3080", "SV0000000000"):
        assert bng.ref_to_en(ref) == jbng.ref_to_en(ref)
    with pytest.raises(ValueError):
        bng.ref_to_en("not a ref!")
    for ext in ((424000, 565000, 436000, 567000),
                (421000, 561000, 424000, 563000)):
        assert bng.tile_names_for_extent(*ext) == \
            jbng.tile_names_for_extent(*ext)
    # Two 10 km tiles at 100 m, written by the port's raster writer.
    for tile, value in (("NZ26", 10.0), ("NZ36", 20.0)):
        e, n = bng.ref_to_en(tile)
        data = np.full((100, 100), value)
        data[0, 0] = value + 1.0
        write_raster(tmp_path / f"LIDAR-DTM-2M-{tile}.asc",
                     Raster.from_domain_array(data, xll=e, yll=n,
                                              cell_size=100.0))
    ext = (425000, 561000, 437000, 566000)
    got, got_missing = bng.mosaic_extent(tmp_path, *ext, 100.0)
    want, want_missing = jbng.mosaic_extent(tmp_path, *ext, 100.0)
    np.testing.assert_array_equal(got, want)
    assert got_missing == want_missing
    assert {10.0, 20.0} <= set(np.unique(got))
