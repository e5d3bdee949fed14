"""The port's bilinear resize against `jax.image.resize(..., "bilinear")`,
which antialiases on an axis that shrinks: the helper itself at the sizes
the classifier (224) and Inception (299) preprocessing meet, one
non-square case with one axis growing and one shrinking, and the
classifier's preprocessing of a 256² image, a frame size larger than the
classifier's input.

Tolerance 5e-5 on [-1, 1] images: the f32 rounding of the sample positions
(JAX and PyTorch compute them in different orders) moves a weight by up to
half an ulp of a position below 384, 2^-17, times an image step of up to 2
(measured 1.7e-5 at 384 -> 299; 1.2e-7 where no axis shrinks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.models.classifier import preprocess_for_classifier as jax_preprocess
from synt_isic_tpu_torch.models.classifier import preprocess_for_classifier
from synt_isic_tpu_torch.ops.resize import resize_bilinear

TOL = 5e-5


def _images(h, w, seed=0, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("src, dst", [((128, 128), (224, 224)), ((128, 128), (299, 299)),
                                      ((256, 256), (224, 224)), ((384, 384), (299, 299)),
                                      ((100, 160), (224, 75))])
def test_resize_matches_jax_image_resize(src, dst):
    x = _images(*src)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, *dst, 3), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("size", [128, 256])
def test_preprocess_for_classifier_matches_jax(size):
    """At 256² the classifier shrinks the frame to 224: the JAX package
    antialiases there, which plain bilinear interpolation does not (0.4
    apart). The ImageNet normalisation divides by std >= 0.224."""
    x = _images(size, size, seed=1)
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    got = preprocess_for_classifier(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL / 0.224)
