"""The port's lesion classifier (ResNet-18 and `LesionClassifier`) against
the JAX package's, on seeded numpy weights carried across with
`state_dict_from_jax`.

Tolerances: logits within 1e-4 · max|logit| (f32 on both sides, the JAX
side at `highest` matmul precision, so the two differ by the order of
their convolution sums); the preprocessing within 1e-6 (one bilinear
interpolation and an affine map in f32). The JAX side is jitted once per
input shape and shared by every test of this file.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.models.classifier import LesionClassifier as JaxLesionClassifier
from synt_isic_tpu.models.classifier import preprocess_for_classifier as jax_preprocess
from synt_isic_tpu.models.resnet18 import ResNet18 as JaxResNet18
from synt_isic_tpu.models.resnet18 import ResNet18Config as JaxResNet18Config
import synt_isic_tpu.models.classifier as jax_classifier_module
from synt_isic_tpu_torch.io.pth import save_checkpoint
from synt_isic_tpu_torch.models.classifier import (SCORE_EPS, LesionClassifier,
                                                   preprocess_for_classifier)

from tests.torch_port_fixtures import (_resnet_shapes, classifier_input, jax_resnet_params,
                                       port_resnet)

NUM_CLASSES = 8


@functools.cache
def jax_apply(num_classes: int):
    """The JAX ResNet's logits of an NHWC batch at its own size, jitted."""
    model = JaxResNet18(config=JaxResNet18Config(num_classes=num_classes))
    return jax.jit(lambda p, x: model.apply({"params": p}, x))


def jax_logits(params, x: np.ndarray, num_classes: int = NUM_CLASSES) -> np.ndarray:
    with jax.default_matmul_precision("highest"):
        return np.asarray(jax_apply(num_classes)(params, jnp.asarray(x)))


@pytest.fixture(scope="module")
def params():
    return jax_resnet_params(NUM_CLASSES, seed=0)


def _images(shape, seed=1):
    return np.clip(np.random.default_rng(seed).normal(size=shape) * 0.5, -1, 1).astype(np.float32)


def test_logits_match_jax_at_64(params):
    x = np.random.default_rng(2).normal(size=(3, 64, 64, 3)).astype(np.float32)
    want = jax_logits(params, x)
    got = port_resnet(params)(torch.from_numpy(x).permute(0, 3, 1, 2)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_features_and_logits_pieces(params):
    """The Grad-CAM target is layer4[-1].conv2's output, and the tail rerun
    from it gives the same logits as the forward."""
    model = port_resnet(params)
    x = torch.from_numpy(_images((2, 3, 64, 64)))
    logits, act, block_input = model.features_and_logits(x)
    assert act.shape == (2, 512, 2, 2) and block_input.shape == (2, 512, 2, 2)
    torch.testing.assert_close(logits, model(x), rtol=0, atol=1e-5)
    torch.testing.assert_close(act, model.layer4[1].conv2(
        torch.relu(model.layer4[1].bn1(model.layer4[1].conv1(block_input)))))
    torch.testing.assert_close(model.logits_from_activation(act, block_input), logits)


def test_preprocess_matches_jax_128_to_224():
    x = _images((2, 128, 128, 3)) * 1.2        # some values past [-1, 1]: the clip
    want = np.asarray(jax_preprocess(jnp.asarray(x)))
    got = preprocess_for_classifier(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the border rows and columns: half-pixel centres clamp to the edge there
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()
    np.testing.assert_allclose(got[:, [0, 1, -2, -1]], want[:, [0, 1, -2, -1]], rtol=0,
                               atol=1e-6)


def test_full_size_forward_at_batch_1(params):
    """One 128² image through the 224² preprocessing and the whole network."""
    x = _images((1, 128, 128, 3), seed=3)
    want = jax_logits(params, np.asarray(jax_preprocess(jnp.asarray(x))))
    clf = LesionClassifier(port_resnet(params), device="cpu")
    got = clf.logits(x).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_scores_and_predictions(params):
    with classifier_input(64):
        clf = LesionClassifier(port_resnet(params), device="cpu")
        x = _images((4, 32, 32, 3), seed=4)
        logits = clf.logits(x)
        probs = clf.get_probabilities(x)
        torch.testing.assert_close(probs, torch.softmax(logits, -1))
        torch.testing.assert_close(clf.get_per_class_score(x, 3),
                                   torch.log(probs[:, 3] + SCORE_EPS))
        torch.testing.assert_close(clf.get_confidence(x, 3), probs[:, 3])
        assert torch.equal(clf.predict(x), logits.argmax(-1))
        x1 = torch.from_numpy(x[0])                       # one HWC image batches itself
        torch.testing.assert_close(clf.logits(x1), logits[:1])
        torch.testing.assert_close(clf.score_fn(3)(torch.from_numpy(x)),
                                   clf.get_per_class_score(x, 3))


def _torchvision_state(params, prefix: str):
    """A torchvision-style `classifier.pth` state: the port's names under
    `prefix`, each BatchNorm's `num_batches_tracked`, wrapped in
    `model_state_dict`."""
    state = {}
    for key, value in port_resnet(params).state_dict().items():
        state[prefix + key] = value
        if key.endswith("running_var"):
            state[prefix + key.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    return {"model_state_dict": state}


@pytest.mark.parametrize("num_classes", [NUM_CLASSES, NUM_CLASSES - 1])
def test_from_checkpoint_matches_jax(params, tmp_path, monkeypatch, num_classes):
    """A `model.`-prefixed, wrapped checkpoint with 8 outputs: the same
    {loaded, skipped} counts as the JAX package (the fc pair skipped when
    the classifier has 7 outputs) and, at 8 outputs, the same logits."""
    path = tmp_path / "classifier.pth"
    torch.save(_torchvision_state(params, "model."), path)
    # the JAX constructor's own random init runs the network at 224²;
    # its values are overwritten or unused here, so take zeros of the shape
    monkeypatch.setattr(jax_classifier_module, "init_resnet_params",
                        lambda model, rng, image_size=224: jax.tree_util.tree_map(
                            lambda s: jnp.zeros(s.shape, s.dtype),
                            _resnet_shapes(model.config.num_classes)))
    jclf, jcounts = JaxLesionClassifier.from_checkpoint(str(path), num_classes=num_classes)
    clf, counts = LesionClassifier.from_checkpoint(str(path), num_classes=num_classes,
                                                   device="cpu")
    assert counts == jcounts
    assert counts == ({"loaded": 102, "skipped": 0} if num_classes == NUM_CLASSES
                      else {"loaded": 100, "skipped": 2})
    if num_classes == NUM_CLASSES:
        x = _images((2, 64, 64, 3), seed=5)
        want = jax_logits(jclf.params, x)
        got = clf.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_from_checkpoint_reads_save_checkpoint_files(params, tmp_path):
    """A bare state dict as the port's `save_checkpoint` writes it loads
    whole."""
    path = tmp_path / "classifier.pth"
    save_checkpoint(port_resnet(params).state_dict(), str(path))
    clf, counts = LesionClassifier.from_checkpoint(str(path), num_classes=NUM_CLASSES,
                                                   device="cpu")
    assert counts == {"loaded": 102, "skipped": 0}
    for key, value in port_resnet(params).state_dict().items():
        assert torch.equal(clf.model.state_dict()[key], value), key


def test_random_init_is_seeded_and_has_no_gradients():
    a = LesionClassifier.random_init(num_classes=NUM_CLASSES, seed=3, device="cpu")
    b = LesionClassifier.random_init(num_classes=NUM_CLASSES, seed=3, device="cpu")
    c = LesionClassifier.random_init(num_classes=NUM_CLASSES, seed=4, device="cpu")
    sa, sb, sc = (m.model.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["conv1.weight"], sc["conv1.weight"])
    assert a.model.fc.out_features == NUM_CLASSES
    assert not any(p.requires_grad for p in a.model.parameters())


def test_entry_points_default_to_cuda():
    """Without a device the classifier takes CUDA, and raises without it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LesionClassifier.random_init()


def test_inference_tensors_are_copied(params):
    """A trajectory the sampler kept under inference_mode can be
    differentiated: `as_input` copies inference tensors."""
    with classifier_input(64):
        clf = LesionClassifier(port_resnet(params), device="cpu")
        with torch.inference_mode():
            x = torch.from_numpy(_images((2, 32, 32, 3), seed=6)) * 1.0
        assert x.is_inference()
        grad = clf.input_gradient(x, 2)
        assert grad.shape == x.shape and not grad.is_inference()
