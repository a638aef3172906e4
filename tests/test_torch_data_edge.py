"""The data edge of the PyTorch port against the JAX package: ``skyio``
(the A-team fixture and a DP3 makesourcedb file), ``fits_io`` and
``imager.image_to_fits``, ``ms_io`` (stores, reads, ``extract_dataset``)
and ``dataset.calibration_sky``.

Tolerances: the text parsers, the converted files, the FITS files and
the ``TABLE.sct`` stores are exact (byte-identical files); the sky arrays
and the per-cluster metadata are float32 coordinate math in two
libraries, rtol 1e-5 / atol 1e-7 (tests/test_torch_demixing.py's COORD).
"""

import math

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import dataset as jdataset
from smartcal_tpu.cal import fits_io as jfits
from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import ms_io as jms
from smartcal_tpu.cal import skyio as jsky
from smartcal_tpu.envs.radio import RadioBackend
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.cal import dataset as tdataset
from smartcal_tpu_torch.cal import fits_io as tfits
from smartcal_tpu_torch.cal import imager as timager
from smartcal_tpu_torch.cal import ms_io as tms
from smartcal_tpu_torch.cal import skyio as tsky

COORD = dict(rtol=1e-5, atol=1e-7)
SKY_FIELDS = ("lmn", "flux_coef", "f0", "gauss", "is_gauss", "cluster")

MAKESOURCEDB = """\
format = Name, Type, Patch, Ra, Dec, I, Q, U, V, ReferenceFrequency='134e6', SpectralIndex='[]', MajorAxis, MinorAxis, Orientation
 , , CasA, 23:23:24.0, +58.48.54.0
casa_1, POINT, CasA, 23:23:24.0, +58.48.54.0, 8000.0, 0, 0, 0, 134e6, [-0.7, 0.02], , ,
casa_2, GAUSSIAN, CasA, 23:23:27.1, +58.49.00.0, 2000.0, 0, 0, 0, 134e6, [-0.6], 120.0, 60.0, 30.0
 , , Target, 12:00:00.0, +45.00.00.0
t_1, POINT, Target, 12:00:00.0, +45.00.00.0, 2.5, 0, 0, 0, , [], , ,
t_2, POINT, Target, 12:00:10.0, -0.5123, 1.0, 0, 0, 0, , [], , ,
"""


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _same_sky(t, j):
    assert t.n_clusters == j.n_clusters
    for f in SKY_FIELDS:
        np.testing.assert_allclose(getattr(t, f).numpy(),
                                   np.asarray(getattr(j, f)), **COORD)


@pytest.fixture(scope="module")
def episode():
    be = RadioBackend(n_stations=6, n_times=8, tdelta=4, npix=8,
                      admm_iters=2, lbfgs_iters=3, init_iters=4)
    return be.new_demixing_episode(jax.random.PRNGKey(7), 4)[0]


# -- skyio -------------------------------------------------------------------

def test_fixture_sky_matches():
    sky_p, clus_p, rho_p = tdataset.ateam_paths()
    assert all(_same_bytes(a, b) for a, b in zip(tdataset.ateam_paths(),
                                                 jdataset.ateam_paths()))
    assert tsky.parse_cluster_file(clus_p) == jsky.parse_cluster_file(clus_p)
    ts, js = tsky.parse_sky_model(sky_p), jsky.parse_sky_model(sky_p)
    assert list(ts) == list(js)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    for a, b in zip(tsky.read_rho(rho_p, 5), jsky.read_rho(rho_p, 5)):
        np.testing.assert_array_equal(a, b)
    ra0, dec0 = 1.2, 0.9
    _same_sky(tsky.build_sky_arrays(sky_p, clus_p, ra0, dec0),
              jsky.build_sky_arrays(sky_p, clus_p, ra0, dec0))


def test_makesourcedb_parse_and_conversion_match(tmp_path):
    model = tmp_path / "model.txt"
    model.write_text(MAKESOURCEDB)
    assert tsky.parse_makesourcedb(str(model)) == \
        jsky.parse_makesourcedb(str(model))
    outs = {}
    for name, mod in (("port", tsky), ("jax", jsky)):
        paths = [str(tmp_path / f"{name}.{ext}")
                 for ext in ("sky", "cluster", "rho")]
        outs[name] = paths, mod.convert_dp3_skymodel(str(model), *paths,
                                                     start_cluster=3)
        bbs = str(tmp_path / f"{name}.bbs")
        rows = [("P0", 1.0, -0.3, 2.0, -0.7, 0.0, 0.0, 0.0, 140e6),
                ("G1", 1.1, 0.4, 1.0, -0.5, 1e-4, 5e-5, 0.3, 150e6)]
        mod.write_bbs_skymodel(bbs, rows, 150e6)
        outs[name] += (bbs,)
    assert outs["port"][1] == outs["jax"][1] == 2
    for a, b in zip(outs["port"][0] + [outs["port"][2]],
                    outs["jax"][0] + [outs["jax"][2]]):
        assert _same_bytes(a, b)
    sky_p, clus_p, _ = outs["port"][0]
    _same_sky(tsky.build_sky_arrays(sky_p, clus_p, 3.1, 0.8),
              jsky.build_sky_arrays(sky_p, clus_p, 3.1, 0.8))


def test_solutions_text_round_trip_matches(tmp_path):
    rng = np.random.default_rng(0)
    J = (rng.standard_normal((3, 2 * 4 * 2, 2))
         + 1j * rng.standard_normal((3, 2 * 4 * 2, 2))).astype(np.complex64)
    tsky.write_solutions(str(tmp_path / "t.sol"), 150e6, J, 4)
    jsky.write_solutions(str(tmp_path / "j.sol"), 150e6, J, 4)
    assert _same_bytes(tmp_path / "t.sol", tmp_path / "j.sol")
    f, back = tsky.read_solutions(str(tmp_path / "j.sol"))
    assert f == pytest.approx(150e6)
    np.testing.assert_allclose(back, J, rtol=1e-5)


# -- FITS --------------------------------------------------------------------

def test_fits_files_byte_identical(tmp_path):
    rng = np.random.default_rng(1)
    paths = {"port": [], "jax": []}
    for i in range(3):
        img = rng.standard_normal((16, 12)).astype(np.float32) * 1e-3
        kw = dict(ra0=0.3 + i, dec0=-0.2, cell_rad=2e-5, freq=140e6 + i,
                  bmaj=0.01, bmin=0.005, bpa=10.0 * i, object_name="x'y",
                  extra={"NOTE": "a/b", "ITER": i})
        for name, mod in (("port", tfits), ("jax", jfits)):
            p = str(tmp_path / f"{name}{i}.fits")
            mod.write_image(p, img, **kw)
            paths[name].append(p)
        assert _same_bytes(paths["port"][-1], paths["jax"][-1])
        a, ha = tfits.read_image(paths["jax"][-1])
        b, hb = jfits.read_image(paths["jax"][-1])
        np.testing.assert_array_equal(a, b)
        assert ha == hb
    tfits.fits_mean(paths["port"], str(tmp_path / "tm.fits"), vmax=1.0)
    jfits.fits_mean(paths["jax"], str(tmp_path / "jm.fits"), vmax=1.0)
    assert _same_bytes(tmp_path / "tm.fits", tmp_path / "jm.fits")


def test_image_to_fits_byte_identical(tmp_path, episode):
    img = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    tep = interop.episode_from_numpy(episode)
    timager.image_to_fits(str(tmp_path / "t.fits"), torch.from_numpy(img),
                          tep.obs)
    jimager.image_to_fits(str(tmp_path / "j.fits"), img, episode.obs)
    assert _same_bytes(tmp_path / "t.fits", tmp_path / "j.fits")


# -- ms_io -------------------------------------------------------------------

def test_ms_stores_byte_identical_and_cross_read(tmp_path, episode):
    tep = interop.episode_from_numpy(episode)
    tlist = tms.observation_to_ms_set(str(tmp_path / "t"), tep.obs, tep.V)
    jlist = jms.observation_to_ms_set(str(tmp_path / "j"), episode.obs,
                                      np.asarray(episode.V))
    assert len(tlist) == len(jlist) == episode.V.shape[0]
    for t, j in zip(tlist, jlist):
        assert tms.is_sct_ms(t) and jms.is_sct_ms(j)
        assert _same_bytes(f"{t}/{tms.SCT}", f"{j}/{jms.SCT}")
        for reader in (tms, jms):
            for a, b in zip(reader.read_corr(t, "DATA"),
                            jms.read_corr(j, "DATA")):
                np.testing.assert_array_equal(a, b)
        assert tms.ms_info(j)._asdict().keys() == jms.ms_info(t)._asdict(
        ).keys()
        for a, b in zip(tms.ms_info(j), jms.ms_info(t)):
            np.testing.assert_array_equal(a, b)
    # the round trip gives back the simulated visibilities
    uu, _, _, xx, _, _, yy = tms.read_corr(tlist[0], "DATA")
    V = episode.V[0]
    Vc = (np.asarray(V)[..., 0] + 1j * np.asarray(V)[..., 1]).reshape(-1, 4)
    np.testing.assert_array_equal(xx, Vc[:, 0].astype(np.complex64))
    np.testing.assert_array_equal(yy, Vc[:, 3].astype(np.complex64))
    np.testing.assert_array_equal(
        uu, np.asarray(episode.obs.uvw).reshape(-1, 3)[:, 0])


def test_ms_mutations_match(tmp_path, episode):
    tep = interop.episode_from_numpy(episode)
    t = tms.observation_to_ms_set(str(tmp_path / "t"), tep.obs, tep.V)[1]
    j = jms.observation_to_ms_set(str(tmp_path / "j"), episode.obs,
                                  np.asarray(episode.V))[1]
    for mod, path in ((tms, t), (jms, j)):
        _, _, _, xx, xy, yx, yy = mod.read_corr(path, "DATA")
        mod.write_corr(path, 2 * xx, xy, yx, 3 * yy, colname="CORRECTED")
        mod.add_column(path, "MODEL_DATA")
        mod.change_freq(path, 123e6)
        mod.add_noise(path, 2.0, rng=np.random.default_rng(3))
    assert _same_bytes(f"{t}/{tms.SCT}", f"{j}/{jms.SCT}")


def test_extract_dataset_same_rng(tmp_path, episode):
    tep = interop.episode_from_numpy(episode)
    tlist = tms.observation_to_ms_set(str(tmp_path / "t"), tep.obs, tep.V,
                                      basename="SB")
    jlist = jms.observation_to_ms_set(str(tmp_path / "j"), episode.obs,
                                      np.asarray(episode.V), basename="SB")
    tout = tms.extract_dataset(tlist, 4.0, Nf=3,
                               rng=np.random.default_rng(4),
                               outdir=str(tmp_path / "t"))
    jout = jms.extract_dataset(jlist, 4.0, Nf=3,
                               rng=np.random.default_rng(4),
                               outdir=str(tmp_path / "j"))
    for t, j in zip(tout, jout):
        assert _same_bytes(f"{t}/{tms.SCT}", f"{j}/{jms.SCT}")
    assert tms.ms_info(tout[0]).n_times == jms.ms_info(jout[0]).n_times


# -- calibration sky ---------------------------------------------------------

def _same_calsky(t, j):
    _same_sky(t.sky, j.sky)
    for f in ("separations", "azimuth", "elevation", "rho"):
        np.testing.assert_allclose(getattr(t, f), np.asarray(getattr(j, f)),
                                   rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("K,synthetic", [(6, False), (3, False), (4, True)])
def test_calibration_sky_matches(K, synthetic):
    args = (1.1, 0.85, 4.2e9, 150e6)
    _same_calsky(tdataset.calibration_sky(*args, K=K, synthetic=synthetic),
                 jdataset.calibration_sky(*args, K=K, synthetic=synthetic))


def test_calibration_sky_user_model_matches(tmp_path):
    model = tmp_path / "model.txt"
    model.write_text(MAKESOURCEDB)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    sky_p, clus_p, rho_p, K = tdataset.assemble_real_sky(
        str(model), str(tmp_path / "t"), num_patches=2)
    jout = jdataset.assemble_real_sky(str(model), str(tmp_path / "j"),
                                      num_patches=2)
    assert K == jout[3] == 7
    for a, b in zip((sky_p, clus_p, rho_p), jout[:3]):
        assert _same_bytes(a, b)
    args = (math.radians(180.0), math.radians(45.0), 4.2e9, 150e6)
    _same_calsky(
        tdataset.calibration_sky(*args, K=K, sky_path=sky_p,
                                 cluster_path=clus_p, rho_path=rho_p),
        jdataset.calibration_sky(*args, K=K, sky_path=sky_p,
                                 cluster_path=clus_p, rho_path=rho_p))
    with pytest.raises(ValueError):
        tdataset.calibration_sky(*args, K=K, sky_path=sky_p)
