"""The port's interventions, regions (and its C++ morphology), CFI,
statistics battery and fairness audit against the JAX package's, on the
same seeded inputs: a ResNet-18 with the same numpy weights in both
packages, its input shrunk to 64² in both (`small_classifiers`), 32²
images.

The JAX interventions' draws are recomputed from their key and injected
through the port's `noise=` and `uniform=`. Tolerances: deterministic
interventions 1e-6, noise and shuffle exactly; CFI and the fairness
auditor's probabilities 1e-5 (f32 networks whose convolutions sum in
another order); regions, statistics and the audit on equal probabilities
equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from synt_isic_tpu.xai.cfi import compute_causal_shift_comprehensive as jax_cfi
from synt_isic_tpu.xai.fairness import FairnessAuditor as JaxFairnessAuditor
from synt_isic_tpu.xai.fairness import estimate_phototype_mask as jax_phototype_mask
from synt_isic_tpu.xai.interventions import (
    counterfactual_intervention_advanced as jax_intervention)
from synt_isic_tpu.xai.regions import select_regions_advanced as jax_regions
from synt_isic_tpu.xai.stats import statistical_validation_comprehensive as jax_stats
from synt_isic_tpu_torch import native
from synt_isic_tpu_torch.xai import (INTERVENTION_TYPES, compute_causal_shift_comprehensive,
                                     counterfactual_intervention_advanced,
                                     select_regions_advanced,
                                     statistical_validation_comprehensive)
from synt_isic_tpu_torch.xai.fairness import FairnessAuditor, estimate_phototype_mask

from tests.torch_port_fixtures import classifier_pair, small_classifiers

NUM_CLASSES, TARGET, SIZE = 8, 2, 32


@pytest.fixture(scope="module")
def clfs():
    with small_classifiers():
        yield classifier_pair(NUM_CLASSES)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return (0.95 * np.tanh(rng.normal(size=(2, SIZE, SIZE, 3)))).astype(np.float32)


def _mask():
    return np.random.default_rng(12).random((SIZE, SIZE)) < 0.3


def _jax_draws(itype, key, shape):
    """The draws the JAX intervention takes from `key`, as the port's seams
    take them."""
    b, h, w, c = shape
    if itype == "shuffle":
        keys = jax.random.split(key, b * c).reshape(b, c, 2)
        r1 = np.stack([np.stack([np.asarray(jax.random.uniform(keys[i, j], (h * w,)))
                                 for j in range(c)], axis=-1) for i in range(b)])
        return {"uniform": r1}
    if itype in ("noise", "gaussian_noise", "unknown"):
        return {"noise": np.asarray(jax.random.normal(key, shape))}
    return {}


@pytest.mark.parametrize("itype", INTERVENTION_TYPES + ["unknown"])
def test_interventions_match_jax(frames, itype):
    image, mask, key = frames[:1], _mask(), jax.random.PRNGKey(5)
    want = jax_intervention(jnp.asarray(image), mask, itype, key=key)
    got = counterfactual_intervention_advanced(torch.from_numpy(image), mask, itype,
                                               **_jax_draws(itype, key, image.shape))
    exact = itype in ("noise", "shuffle", "unknown")
    for name in ("modified_image", "intervention", "mask_tensor", "difference"):
        g, w = got[name].numpy(), np.asarray(want[name])
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    for name, value in want["statistics"].items():
        if isinstance(value, str):
            assert got["statistics"][name] == value
        else:
            assert got["statistics"][name] == pytest.approx(value, abs=1e-6), name


def test_shuffle_permutes_within_the_mask(frames):
    mask = _mask()
    out = counterfactual_intervention_advanced(torch.from_numpy(frames[:1]), mask, "shuffle",
                                               generator=torch.Generator().manual_seed(1))
    got = out["modified_image"].numpy()[0]
    assert np.array_equal(got[~mask], np.clip(frames[0][~mask], -1, 1))
    for ch in range(3):
        assert np.array_equal(np.sort(got[mask][:, ch]), np.sort(frames[0][mask][:, ch]))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("region_type", ["top", "bottom"])
def test_regions_equal_jax(use_native, region_type):
    if use_native and not native.available():
        pytest.fail("g++ could not build the port's morphology library")
    attr = np.random.default_rng(13).normal(size=(1, SIZE, SIZE, 3)).astype(np.float32)
    want = jax_regions(attr, k_percent=10, region_type=region_type, use_native=use_native)
    got = select_regions_advanced(attr, k_percent=10, region_type=region_type,
                                  use_native=use_native)
    assert np.array_equal(got["mask"], want["mask"])
    assert got["threshold"] == want["threshold"]
    assert got["statistics"] == want["statistics"]
    assert got["metadata"] == want["metadata"]


@pytest.mark.parametrize("connectivity", [1, 2])
def test_native_morphology_equals_scipy(connectivity):
    rng = np.random.default_rng(14)
    structure = ndimage.generate_binary_structure(2, connectivity)
    for _ in range(4):
        mask = rng.random((48, 48)) < rng.uniform(0.05, 0.6)
        assert np.array_equal(native.binary_closing(mask, connectivity, 2),
                              ndimage.binary_closing(mask, structure=structure, iterations=2))
        assert np.array_equal(native.binary_opening(mask, connectivity, 1),
                              ndimage.binary_opening(mask, structure=structure, iterations=1))
        labels, n = native.label(mask, connectivity)
        assert n == ndimage.label(mask, structure=structure)[1]
        assert np.array_equal(labels > 0, mask)
        kept = native.remove_small_components(mask, 6, connectivity)
        ref, num = ndimage.label(mask, structure=structure)
        sizes = ndimage.sum(mask, ref, range(1, num + 1))
        assert np.array_equal(kept, np.isin(ref, np.where(sizes >= 6)[0] + 1))


def _assert_numbers_close(got, want, atol, path=""):
    """Same keys and types; floats within atol, everything else equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _assert_numbers_close(got[key], want[key], atol, f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_numbers_close(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=atol), path
    else:
        assert got == want, path


def test_cfi_matches_jax(clfs, frames):
    jclf, clf = clfs
    modified = np.clip(frames[:1] * 0.5 + 0.2, -1, 1)
    want = jax_cfi(jclf, jnp.asarray(frames[:1]), jnp.asarray(modified), TARGET)
    got = compute_causal_shift_comprehensive(clf, frames[:1], modified, TARGET)
    _assert_numbers_close(got, want, 1e-5)


def test_statistics_equal_on_equal_inputs():
    rng = np.random.default_rng(15)
    top, bottom = rng.normal(1.0, 1.0, 9), rng.normal(0.2, 0.8, 7)
    want = jax_stats(top, bottom, n_bootstrap=200, n_permutations=500, seed=3)
    got = statistical_validation_comprehensive(top, bottom, n_bootstrap=200,
                                               n_permutations=500, seed=3)
    for result in (want, got):
        result["metadata"].pop("analysis_timestamp")
    assert got == want


# -- fairness -----------------------------------------------------------------------------------

def test_fairness_audit_matches_jax(clfs):
    jclf, clf = clfs
    rng = np.random.default_rng(16)
    images = rng.integers(0, 256, size=(20, SIZE, SIZE, 3), dtype=np.uint8)
    images[:10] //= 3                                  # a darker half
    group = estimate_phototype_mask(images)
    assert np.array_equal(group, jax_phototype_mask(images))
    aud = FairnessAuditor(clf, batch_size=8)
    probs = aud.probabilities(images)
    floats = images.astype(np.float32) / 127.5 - 1.0
    np.testing.assert_allclose(probs, clf.get_probabilities(floats).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs, np.asarray(jclf.get_probabilities(jnp.asarray(floats))),
                               rtol=0, atol=1e-5)
    # the audit itself on the same probabilities (the JAX auditor's
    # scoring is its classifier's, compared above)
    jaud = JaxFairnessAuditor(jclf)
    jaud.probabilities = lambda _: probs
    labels = rng.integers(0, 7, size=20)
    want = jaud.audit(images, group, target_class=TARGET, labels=labels)
    got = aud.audit(images, group, target_class=TARGET, labels=labels)
    for result in (want, got):
        for part in ("confidence", "target_class_scores"):
            stats = result[part]["statistics"]
            if stats is not None:
                stats["metadata"].pop("analysis_timestamp")
    _assert_numbers_close(got, want, 0.0)
