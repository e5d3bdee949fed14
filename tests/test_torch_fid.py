"""The port's FID (`metrics/fid.py`) against the JAX package's: each
extractor on the same images and weights, the Fréchet distance on the same
features, whole-path `compute_fid` where the covariances have full rank,
the refusal to stand a proxy in for standard FID, and the Inception
bootstrap (`app/download_models.py`) with its fetch stubbed: nothing here
touches the network.

Tolerances, each derived:
  * pixel features: the same numpy code, so bit-identical; the Fréchet
    distance on identical features within 1e-9 relative (the same scipy
    call on the same float64 matrices);
  * classifier features within 1e-5 * max|feature| (both packages in full
    f32 at the shrunk 32-64² input, `small_classifiers`); Inception pool3
    within 1e-5 * max|feature| (`tests/test_torch_inception.py`);
  * `compute_fid` with the classifier extractor (N = 520 > 512 dimensions;
    the live channels' covariance has full rank): within `frechet_bound` of
    the two packages' features, the most the exact Fréchet distance can
    move for feature differences of that size (derived in its docstring),
    plus 1e-9 relative for sqrtm's own rounding of a full-rank product.
"""
import contextlib
import functools
import hashlib

import numpy as np
import pytest
import torch

import synt_isic_tpu.metrics.fid as jax_fid
import synt_isic_tpu_torch.metrics.fid as port_fid
from synt_isic_tpu_torch.app.download_models import fetch_inception_weights
from synt_isic_tpu_torch.io.pth import save_checkpoint
from synt_isic_tpu_torch.models.inception_v3 import (expected_inception_state_shapes,
                                                     random_inception_state)

from tests.torch_port_fixtures import classifier_pair, one_thread, small_classifiers  # noqa: F401

FEATURE_TOL = 1e-5
SQRTM_RTOL = 1e-9


def frechet_bound(fa, fb, ga, gb) -> float:
    """The largest |FID(fa, fb) - FID(ga, gb)| of the EXACT Fréchet
    distance that feature differences of these sizes allow. With X the
    centred features (n rows) and S = XᵀX / (n-1), Tr S = ||X||_F² / (n-1)
    and Tr (Sa Sb)^{1/2} = ||Xa Xbᵀ||_* / sqrt((na-1)(nb-1)) (the nonzero
    eigenvalues of Sa Sb are the squared singular values of Xa Xbᵀ over
    (na-1)(nb-1)); ||A B||_* <= ||A||_F ||B||_F bounds each term's change,
    at any n, full rank or not."""
    fa, fb, ga, gb = (np.asarray(f, np.float64) for f in (fa, fb, ga, gb))
    xa, xb = fa - fa.mean(0), fb - fb.mean(0)
    da = np.linalg.norm((ga - ga.mean(0)) - xa)
    db = np.linalg.norm((gb - gb.mean(0)) - xb)
    na, nb = len(fa) - 1, len(fb) - 1
    a, b = np.linalg.norm(xa), np.linalg.norm(xb)
    m = np.linalg.norm(fa.mean(0) - fb.mean(0))
    dm = np.linalg.norm((ga.mean(0) - gb.mean(0)) - (fa.mean(0) - fb.mean(0)))
    return float(2 * m * dm + dm ** 2 + (2 * a * da + da ** 2) / na
                 + (2 * b * db + db ** 2) / nb
                 + 2 * (da * b + a * db + da * db) / np.sqrt(na * nb))


@contextlib.contextmanager
def classifier_input_in_fid(size: int):
    """`small_classifiers(size)`, and the same for each FID module's own
    name of the classifier preprocessing."""
    patch = pytest.MonkeyPatch()
    for module in (jax_fid, port_fid):
        patch.setattr(module, "preprocess_for_classifier",
                      functools.partial(module.preprocess_for_classifier, size=size))
    try:
        with small_classifiers(size):
            yield
    finally:
        patch.undo()


def _images(n, size, seed):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def test_pixel_extractor_and_pixel_frechet_match_jax():
    imgs = _images(6, 33, 0)
    got = port_fid.PixelFeatureExtractor()(imgs)
    np.testing.assert_array_equal(got, jax_fid.PixelFeatureExtractor()(imgs))
    assert got.shape == (6, 192)
    tiny = _images(2, 5, 1)
    np.testing.assert_array_equal(port_fid.PixelFeatureExtractor(4)(tiny),
                                  jax_fid.PixelFeatureExtractor(4)(tiny))
    a, b = _images(40, 16, 2), _images(40, 16, 3) * 0.5
    assert port_fid.pixel_frechet(a, b, grid=2) == pytest.approx(
        jax_fid.pixel_frechet(a, b, grid=2), rel=SQRTM_RTOL)


def test_classifier_extractor_matches_jax():
    jax_clf, port_clf = classifier_pair(num_classes=7)
    imgs = _images(5, 48, 4)
    with classifier_input_in_fid(64):
        want = jax_fid.FeatureExtractor(jax_clf, batch_size=2)(imgs)
        got = port_fid.FeatureExtractor(port_clf, batch_size=2)(imgs)
    assert got.shape == want.shape == (5, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL * np.abs(want).max())
    assert port_fid.FeatureExtractor(port_clf)(imgs[:0]).shape == (0, 512)


def test_inception_extractor_matches_jax(tmp_path):
    path = tmp_path / "inception_v3.pth"
    save_checkpoint({k: torch.from_numpy(v) for k, v in random_inception_state(3).items()},
                    str(path))
    imgs = _images(3, 64, 5)
    want = jax_fid.InceptionFeatureExtractor(str(path), batch_size=2)(imgs)
    port = port_fid.InceptionFeatureExtractor(str(path), batch_size=2, device="cpu")
    assert port.pretrained
    got = port(imgs)
    assert got.shape == want.shape == (3, 2048) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL * np.abs(want).max())
    assert port(imgs[:0]).shape == (0, 2048)
    # without a path: seeded random weights, labelled as not pretrained
    assert not port_fid.InceptionFeatureExtractor(device="cpu").pretrained


def test_frechet_distance_closed_form_and_jax():
    """Isotropic Gaussians: d² = ||mu1-mu2||² + (sqrt(s1)-sqrt(s2))²·D; the
    same features in both packages give the same distance."""
    d = 16
    mu1, mu2 = np.zeros(d), np.ones(d) * 0.5
    got = port_fid.frechet_distance(mu1, np.eye(d), mu2, np.eye(d) * 2.25)
    assert got == pytest.approx(0.25 * d + (1.0 - 1.5) ** 2 * d, rel=1e-6)
    assert port_fid.frechet_distance(mu1, np.eye(d), mu1, np.eye(d)) == pytest.approx(
        0.0, abs=1e-8)
    rng = np.random.default_rng(6)
    fa, fb = rng.normal(size=(64, d)), rng.normal(0.3, 1.2, size=(48, d))
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in (fa, fb)]
    assert port_fid.frechet_distance(*stats[0], *stats[1]) == pytest.approx(
        jax_fid.frechet_distance(*stats[0], *stats[1]), rel=SQRTM_RTOL)


def test_frechet_bound_holds_at_small_n():
    """The bound `frechet_bound` derives holds where sqrtm is ill-conditioned
    (n = 8 rows of 64 dimensions): the exact distances, from the singular
    values, move within it."""
    def exact(fa, fb):
        xa, xb = fa - fa.mean(0), fb - fb.mean(0)
        na, nb = len(fa) - 1, len(fb) - 1
        nuclear = np.linalg.svd(xa @ xb.T, compute_uv=False).sum()
        return (np.sum((fa.mean(0) - fb.mean(0)) ** 2) + np.sum(xa ** 2) / na
                + np.sum(xb ** 2) / nb - 2 * nuclear / np.sqrt(na * nb))

    rng = np.random.default_rng(7)
    fa, fb = rng.normal(size=(8, 64)), rng.normal(0.2, 1.1, size=(8, 64))
    ga, gb = (f + 1e-3 * rng.normal(size=f.shape) for f in (fa, fb))
    bound = frechet_bound(fa, fb, ga, gb)
    assert abs(exact(ga, gb) - exact(fa, fb)) <= bound
    assert bound < 1e-2 * exact(fa, fb)
    # and at full rank sqrtm gives the exact distance
    fa, fb = rng.normal(size=(200, 16)), rng.normal(0.1, 0.9, size=(200, 16))
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in (fa, fb)]
    assert port_fid.frechet_distance(*stats[0], *stats[1]) == pytest.approx(
        exact(fa, fb), rel=SQRTM_RTOL)


def test_compute_fid_matches_jax_pixel_extractor():
    """192-d pooled pixels, 200 images a set: full rank."""
    a, b = _images(200, 16, 8), np.tanh(_images(200, 16, 9) * 2)
    got = port_fid.compute_fid(a, b, port_fid.PixelFeatureExtractor())
    assert got == pytest.approx(jax_fid.compute_fid(a, b, jax_fid.PixelFeatureExtractor()),
                                rel=SQRTM_RTOL)


def test_compute_fid_matches_jax_classifier_extractor():
    """512-d classifier features, 520 images a set (more samples than
    dimensions), at a 32² classifier input. The random ResNet leaves some
    channels dead (zero for every image, in both packages): their rows
    and columns of the covariances are exactly zero, which sqrtm keeps
    apart, and the live channels' covariance has full rank."""
    jax_clf, port_clf = classifier_pair(num_classes=7)
    a, b = _images(520, 16, 10), np.tanh(_images(520, 16, 11) * 2)
    with classifier_input_in_fid(32):
        jax_ex, port_ex = jax_fid.FeatureExtractor(jax_clf), port_fid.FeatureExtractor(port_clf)
        want = jax_fid.compute_fid(a, b, jax_ex)
        got = port_fid.compute_fid(a, b, port_ex)
        ja, jb, pa, pb = jax_ex(a), jax_ex(b), port_ex(a), port_ex(b)
    for jf, pf in ((ja, pa), (jb, pb)):
        live = (pf != 0).any(axis=0)
        np.testing.assert_array_equal(live, (jf != 0).any(axis=0))
        assert np.linalg.matrix_rank(np.cov(pf[:, live].astype(np.float64),
                                            rowvar=False)) == live.sum()
    bound = frechet_bound(ja, jb, pa, pb)
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= bound + SQRTM_RTOL * abs(want), (got, want, bound)


def test_require_standard_refuses_fallback(tmp_path):
    with pytest.raises(FileNotFoundError, match="standard FID") as err:
        port_fid.default_extractor(checkpoints_dir=str(tmp_path), require_standard=True,
                                   device="cpu")
    assert "python -m synt_isic_tpu_torch.app.download_models" in str(err.value)
    assert isinstance(port_fid.default_extractor(checkpoints_dir=str(tmp_path), device="cpu"),
                      port_fid.FeatureExtractor)


def test_extractors_never_fall_back_to_the_cpu(tmp_path):
    """Without a device named, the extractors take CUDA, and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_fid.InceptionFeatureExtractor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_fid.FeatureExtractor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_fid.default_extractor(checkpoints_dir=str(tmp_path))


def _payload(tmp_path, state):
    path = tmp_path / "payload.pth"
    save_checkpoint({k: torch.as_tensor(v) for k, v in state.items()}, str(path))
    return path, hashlib.sha256(path.read_bytes()).hexdigest()[:8]


def _fetch_from(path):
    def fetch(url, dest):
        dest.write_bytes(path.read_bytes())
        return True
    return fetch


def test_inception_bootstrap_with_stubbed_fetch(tmp_path):
    """fetch (stubbed) -> sha256 check -> the port's manifest validation ->
    installed as checkpoints/inception_v3.pth, which the FID path then takes."""
    zeros = {k: np.zeros(s, np.float32) for k, s in expected_inception_state_shapes().items()}
    payload, digest8 = _payload(tmp_path, zeros)
    ckpt = tmp_path / "checkpoints"
    assert fetch_inception_weights(ckpt, sha256_prefix=digest8, fetch=_fetch_from(payload))
    assert (ckpt / "inception_v3.pth").exists()
    ex = port_fid.default_extractor(checkpoints_dir=str(ckpt), require_standard=True,
                                    device="cpu")
    assert isinstance(ex, port_fid.InceptionFeatureExtractor) and ex.pretrained


def test_inception_bootstrap_rejects_bad_checksum(tmp_path):
    def fetch(url, dest):
        dest.write_bytes(b"not the weights")
        return True

    ckpt = tmp_path / "checkpoints"
    assert not fetch_inception_weights(ckpt, fetch=fetch)
    assert not (ckpt / "inception_v3.pth").exists()


def test_inception_bootstrap_rejects_wrong_architecture(tmp_path):
    """Right checksum, wrong structure: the port's loader refuses the
    install."""
    payload, digest8 = _payload(tmp_path, {"conv.weight": np.zeros((3, 3), np.float32)})
    ckpt = tmp_path / "checkpoints"
    assert not fetch_inception_weights(ckpt, sha256_prefix=digest8, fetch=_fetch_from(payload))
    assert not (ckpt / "inception_v3.pth").exists()


def test_downloaded_checkpoints_are_extracted_and_validated_offline(tmp_path, capsys):
    """The downloader's archive path without the network: a zip the test
    writes is extracted into the checkpoints folder, and every
    `unet_*_best.pth` is read by the port's `io/pth.py` and checked
    against the UNet manifest: a full-width checkpoint passes, a truncated
    file is counted bad."""
    import zipfile

    from synt_isic_tpu_torch.app.download_models import (extract_checkpoints,
                                                         validate_downloaded)
    from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig

    torch.save(UNet2D(UNet2DConfig()).state_dict(), tmp_path / "unet_MEL_best.pth")
    archive = tmp_path / "models_checkpoints.zip"
    with zipfile.ZipFile(archive, "w") as zf:
        zf.write(tmp_path / "unet_MEL_best.pth", "unet_MEL_best.pth")
        zf.writestr("unet_NV_best.pth", b"truncated")
    ckpt = tmp_path / "checkpoints"
    extract_checkpoints(archive, ckpt)
    assert validate_downloaded(ckpt) == 1
    out = capsys.readouterr().out
    assert "ok unet_MEL_best.pth" in out and "!! unet_NV_best.pth: unreadable" in out
