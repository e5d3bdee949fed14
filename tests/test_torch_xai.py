"""The port's XAI attribution (input gradients, IG, patch-SHAP,
Time-SHAP, Grad-CAM) against the JAX package's on the same seeded inputs:
a ResNet-18 with the same numpy weights in both packages, its input
shrunk to 64² in both (`classifier_input`), 32² frames and 8-pixel SHAP
patches. The interventions, regions, CFI, statistics and the fairness
audit are in `test_torch_xai_parts.py`.

Every random draw of the JAX side is recomputed from its key chain and
injected into the port through its keyword seams (`baseline=`,
`patch_masks=`, `permutations=`), so the numbers compare. Tolerances:
gradients and attributions 1e-4 · max|value| (f32 networks whose
convolutions sum in another order, the JAX side at `highest` matmul
precision); Time-SHAP 1e-5; the coalitional estimator 1e-6 and an
efficiency gap under 1e-5; Grad-CAM 1e-3 on maps in [0,1].
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.xai.attribution import XAIAnalyzer as JaxXAIAnalyzer
from synt_isic_tpu.xai.gradcam import compute_gradcam as jax_gradcam
from synt_isic_tpu_torch.xai import XAIAnalyzer, compute_gradcam

from tests.torch_port_fixtures import classifier_pair, small_classifiers

NUM_CLASSES, TARGET = 8, 2
SIZE, PATCH, N_FRAMES = 32, 8, 3
IG_STEPS, SHAP_SAMPLES = 8, 16
TIMESTEPS = [900.0, 500.0, 0.0]


@pytest.fixture(scope="module")
def clfs():
    with small_classifiers():
        yield classifier_pair(NUM_CLASSES)


@pytest.fixture(scope="module")
def frames():
    """Frames strictly inside (-1, 1). At exactly ±1 the classifier's clip
    has a kink, and an IG point b + α(x - b) that lands on it one ulp to
    either side (an FMA or not) takes another gradient; the clipped
    frames of `test_input_gradient_matches_jax` check the kink itself."""
    rng = np.random.default_rng(11)
    return (0.95 * np.tanh(rng.normal(size=(N_FRAMES, SIZE, SIZE, 3)))).astype(np.float32)


@pytest.fixture(scope="module")
def analyzers(clfs):
    jclf, clf = clfs
    kw = dict(ig_n_steps=IG_STEPS, shap_n_samples=SHAP_SAMPLES, shap_patch_size=PATCH, seed=0)
    return JaxXAIAnalyzer(jclf, **kw), XAIAnalyzer(clf, **kw)


def close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def jax_noise_baseline(jan, shape):
    return np.asarray(jan._get_baseline(jnp.zeros(shape), "noise"))


def next_subkey(jan):
    """The key the JAX analyzer's next `_next_key()` will hand out."""
    return jax.random.split(jan._key)[1]


# -- classifier gradients and IG ----------------------------------------------------------

def test_input_gradient_matches_jax(clfs):
    """Clipped frames: pixels at exactly ±1 take half the gradient in both
    packages (the clip's max-then-min)."""
    jclf, clf = clfs
    rng = np.random.default_rng(10)
    x = np.clip(rng.normal(size=(2, SIZE, SIZE, 3)) * 0.7, -1, 1).astype(np.float32)
    assert (np.abs(x) == 1).any()
    want = np.asarray(jclf.input_gradient(jnp.asarray(x), TARGET))
    close(clf.input_gradient(x, TARGET).numpy(), want)


@pytest.fixture(scope="module")
def jax_ig(analyzers, frames):
    """The JAX package's frame-batched IG and the noise baseline it drew."""
    jan, _ = analyzers
    want = np.asarray(jan.compute_ig_frames(jnp.asarray(frames), TARGET))
    return want, jax_noise_baseline(jan, (1, SIZE, SIZE, 3))


@pytest.mark.parametrize("batch_size", [128, 4])
def test_ig_frames_match_jax(clfs, frames, jax_ig, batch_size):
    """Frame-batched IG, the α points in one chunk and in two."""
    want, baseline = jax_ig
    an = XAIAnalyzer(clfs[1], ig_n_steps=IG_STEPS, batch_size=batch_size)
    close(an.compute_ig_frames(frames, TARGET, baseline=baseline).numpy(), want)
    # IG of a frame at its own baseline is 0
    zero = an.compute_ig_frames(frames[:1], TARGET, baseline=frames[:1])
    assert torch.count_nonzero(zero) == 0


def test_integrated_gradients_match_jax(analyzers, frames, jax_ig):
    """IG of one image is the same function as the frame-batched one's
    (the JAX package's `_build_ig` and `_build_ig_frames` agree), so it is
    held to the JAX frame IG of that frame."""
    want, baseline = jax_ig
    _, an = analyzers
    got = an.compute_integrated_gradients(frames[1:2], TARGET, baseline=baseline)
    close(got.numpy(), want[1:2])


def test_gradient_attribution_is_the_input_gradient(analyzers, clfs, frames):
    _, an = analyzers
    assert torch.equal(an.compute_gradient_attribution(frames[:1], TARGET),
                       clfs[1].input_gradient(frames[:1], TARGET))


# -- patch-SHAP ----------------------------------------------------------------------------

def test_shap_frames_match_jax(analyzers, frames):
    """Frame-batched patch-SHAP with the JAX masks, frame i's recomputed
    from fold_in(key, i); and one image's SHAP, the same function, with
    frame 1's masks."""
    jan, an = analyzers
    key = next_subkey(jan)
    want = np.asarray(jan.compute_shap_frames(jnp.asarray(frames), TARGET))
    masks = np.stack([np.asarray(jax.random.bernoulli(
        jax.random.fold_in(key, i), 0.5, (SHAP_SAMPLES, SIZE // PATCH, SIZE // PATCH)))
        for i in range(N_FRAMES)])
    close(an.compute_shap_frames(frames, TARGET, patch_masks=masks).numpy(), want)
    got = an.compute_shap_approximation(frames[1:2], TARGET, patch_masks=masks[1])
    close(got.numpy(), want[1:2])


def test_shap_frame_masks_depend_only_on_frame_index(clfs, frames):
    """Frame i's masks come from (the call's seed, i): the first two frames
    of a three-frame call equal a two-frame call's."""
    a = XAIAnalyzer(clfs[1], shap_n_samples=SHAP_SAMPLES, shap_patch_size=PATCH, seed=5)
    b = XAIAnalyzer(clfs[1], shap_n_samples=SHAP_SAMPLES, shap_patch_size=PATCH, seed=5)
    assert torch.equal(a.compute_shap_frames(frames, TARGET)[:2],
                       b.compute_shap_frames(frames[:2], TARGET))


# -- Time-SHAP --------------------------------------------------------------------------------

def test_time_shap_matches_jax(analyzers, frames):
    jan, an = analyzers
    want_imp, want_raw = jan.compute_time_shap(jnp.asarray(frames), TIMESTEPS, TARGET)
    imp, raw = an.compute_time_shap(frames, TIMESTEPS, TARGET)
    np.testing.assert_allclose(imp, want_imp, rtol=0, atol=1e-5)
    np.testing.assert_allclose(raw["probability_scores"], want_raw["probability_scores"],
                               rtol=0, atol=1e-5)
    assert raw["timesteps"] == want_raw["timesteps"]


def test_time_shap_coalitional_matches_jax(analyzers, frames):
    jan, an = analyzers
    _, raw = jan.compute_time_shap(jnp.asarray(frames), TIMESTEPS, TARGET)
    scores = raw["confidence_scores"]
    n_perm = 32
    key = next_subkey(jan)
    want = jan.compute_time_shap_coalitional(jnp.asarray(frames), TIMESTEPS, TARGET,
                                             n_permutations=n_perm, frame_scores=scores)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N_FRAMES))(
        jax.random.split(key, n_perm)))
    got = an.compute_time_shap_coalitional(frames, TIMESTEPS, TARGET, n_permutations=n_perm,
                                           frame_scores=scores, permutations=perms)
    np.testing.assert_allclose(got["shapley_values"], want["shapley_values"], rtol=0,
                               atol=1e-6)
    assert abs(got["efficiency_gap"]) < 1e-5 and abs(want["efficiency_gap"]) < 1e-5
    # the port's own draw, scoring the frames itself
    own = an.compute_time_shap_coalitional(frames, TIMESTEPS, TARGET, n_permutations=64)
    assert abs(own["efficiency_gap"]) < 1e-5
    np.testing.assert_allclose(own["frame_scores"], scores, rtol=0, atol=1e-5)


# -- Grad-CAM ------------------------------------------------------------------------------------

def test_gradcam_matches_jax(clfs, frames):
    jclf, clf = clfs
    want = jax_gradcam(jclf, jnp.asarray(frames), TARGET)
    got = compute_gradcam(clf, frames, TARGET)
    assert got.shape == (N_FRAMES, 224, 224)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_combined_attribution_is_the_weighted_sum(clfs, frames):
    """IG then SHAP from one seed chain, weighted 0.5 each (the pipeline's
    blend), with the reference's per-method details; 'gradient' is the
    input gradient, and an unknown method is passed over but keeps its
    share of the default weights."""
    kw = dict(ig_n_steps=IG_STEPS, shap_n_samples=SHAP_SAMPLES, shap_patch_size=PATCH, seed=3)
    combined, details = XAIAnalyzer(clfs[1], **kw).compute_combined_attribution(
        frames[:1], TARGET)
    an = XAIAnalyzer(clfs[1], **kw)
    ig = an.compute_integrated_gradients(frames[:1], TARGET)
    shap = an.compute_shap_approximation(frames[:1], TARGET)
    torch.testing.assert_close(combined, 0.5 * ig + 0.5 * shap)
    assert details["ig"]["max_attribution"] == pytest.approx(float(ig.abs().max()))
    assert set(details) == {"ig", "shap"} and details["shap"]["weight"] == 0.5
    grad, details = an.compute_combined_attribution(frames[:1], TARGET,
                                                    methods=("gradient", "other"))
    torch.testing.assert_close(grad, 0.5 * clfs[1].input_gradient(frames[:1], TARGET))
    assert set(details) == {"gradient"}
