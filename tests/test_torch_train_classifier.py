"""The port's classifier training against the JAX package's, on the CPU,
at num_classes=3 and 32x32 inputs (as `tests/test_train_classifier.py`).

Parameters and running statistics are made with numpy and carried into both
packages' `ResNet18Trainable`; both compute in f32 (the JAX side at highest
matmul precision), so only the order of summation differs. Tolerances are
stated at each test.
"""
import csv

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import synt_isic_tpu.models.classifier as jax_clf
from synt_isic_tpu.train import data as jax_data
from synt_isic_tpu.train import train_classifier as jax_tc
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.models import classifier as port_clf
from synt_isic_tpu_torch.models.classifier import LesionClassifier
from synt_isic_tpu_torch.train import __main__ as train_main
from synt_isic_tpu_torch.train import data, train_classifier as tc

from tests.torch_port_fixtures import jax_resnet_params, small_classifiers

NUM_CLASSES = 3
LR = 3e-4


def _split(tree):
    """A frozen-layout ResNet tree -> (params, batch_stats) of the trainable
    model (the statistics `mean`/`var` go to batch_stats)."""
    params, stats = {}, {}
    for name, value in tree.items():
        if isinstance(value, dict):
            params[name], sub = _split(value)
            if sub:
                stats[name] = sub
        elif name in ("mean", "var"):
            stats[name] = value
        else:
            params[name] = value
    return params, stats


@pytest.fixture(scope="module")
def tree():
    return jax_resnet_params(NUM_CLASSES, seed=4)


def _port_model(tree):
    model = tc.ResNet18Trainable(NUM_CLASSES)
    model.load_state_dict(state_dict_from_jax(tree), strict=True)
    return model.train()


def _toy_batch(rng, n=8, size=32):
    """Class k = an image dominated by channel k (the JAX test's)."""
    labels = rng.integers(0, NUM_CLASSES, n)
    images = rng.normal(0, 0.1, (n, size, size, 3)).astype(np.float32)
    for i, k in enumerate(labels):
        images[i, :, :, k] += 1.0
    return images, labels.astype(np.int64)


def _stats_close(model, stats, rtol):
    """The running statistics to `rtol`, or `rtol` of the tensor's largest
    entry (a mean that cancels to near 0 keeps only f32 rounding)."""
    want = state_dict_from_jax(jax.device_get(stats))
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=rtol * float(w.abs().max()), err_msg=name)
    return len(want)


def test_train_forward_and_batch_stats_match_jax(tree):
    """Train-mode logits within 1e-4 * max|logit|, and the running
    statistics after the forward to rtol 1e-5: Flax moves the running
    variance by the BIASED batch variance, which at layer4's 1x1 maps over
    8 images is 7/8 of the unbiased one `nn.BatchNorm2d` would take."""
    images, _ = _toy_batch(np.random.default_rng(0))
    params, stats = _split(tree)
    jmodel = jax_tc.ResNet18Trainable(num_classes=NUM_CLASSES)
    with jax.default_matmul_precision("highest"):
        want, updates = jax.jit(lambda p, s, x: jmodel.apply(
            {"params": p, "batch_stats": s}, x, train=True, mutable=["batch_stats"]))(
            params, stats, jnp.asarray(images))
    model = _port_model(tree)
    got = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert _stats_close(model, updates["batch_stats"], rtol=1e-5) == 2 * 20


def test_three_steps_match_jax(tree):
    """Three Adam steps from the same weights on the same toy batches:
    accuracies equal; the first loss to rtol 1e-5 and the next two to rtol
    1e-3; parameters to 6 * lr; running statistics after the first step
    (from the same weights) to rtol 1e-5, after the third to rtol 1e-2
    (the batch means follow the weights, apart by up to 6 * lr). Adam's
    first steps move every weight by about +-lr whatever its gradient's
    size, so a weight whose gradient is rounding noise (the gradients agree
    to 6e-5 of each leaf's largest) can move the other way, 2 * lr apart
    per step (one weight of 11M came out 3.3 * lr apart after three), and
    layer4's BatchNorm over 1x1 maps of 8 images makes the loss sensitive
    to that: 3.4e-4 apart after the second step."""
    params, stats = _split(tree)
    cfg = jax_tc.ClassifierTrainConfig(num_classes=NUM_CLASSES, image_size=32, batch_size=8,
                                       learning_rate=LR, bf16_compute=False)
    tx = optax.adam(cfg.learning_rate)
    jstate = jax_tc.ClassifierTrainState(params=params, batch_stats=stats,
                                         opt_state=tx.init(params),
                                         step=jnp.zeros((), jnp.int32))
    rng = np.random.default_rng(1)
    batches = [_toy_batch(rng) for _ in range(3)]
    with jax.default_matmul_precision("highest"):
        jstep = jax_tc.make_classifier_train_step(
            jax_tc.ResNet18Trainable(num_classes=NUM_CLASSES), tx)
        want, first_stats = [], None
        for images, labels in batches:
            jstate, loss, acc = jstep(jstate, jnp.asarray(images), jnp.asarray(labels))
            want.append((float(loss), float(acc)))
            first_stats = first_stats or jax.device_get(jstate.batch_stats)

    model = _port_model(tree)
    state = tc.ClassifierTrainState(model=model, optimizer=torch.optim.Adam(
        model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8))
    step = tc.make_classifier_train_step()
    got = []
    for images, labels in batches:
        got.append(tuple(float(v) for v in step(state, images, labels)))
        if state.step == 1:
            _stats_close(model, first_stats, rtol=1e-5)
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=1e-5)
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=1e-3)
    assert [g[1] for g in got] == [w[1] for w in want]
    assert state.step == 3
    want_params = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name].numpy(), rtol=0,
                                   atol=6 * LR, err_msg=name)
    _stats_close(model, jstate.batch_stats, rtol=1e-2)


def test_exported_classifier_loads_in_both_packages(tree, tmp_path, monkeypatch):
    """`classifier.pth` loads with nothing skipped into both packages'
    `LesionClassifier.from_checkpoint` (the JAX one over a numpy init in
    place of its 224x224 Flax init); their logits agree within 1e-4 *
    max|logit| (inputs shrunk to 64x64 in both), and the port's equal the
    trained model's eval-mode logits on the same input."""
    model = _port_model(tree)
    state = tc.ClassifierTrainState(model=model, optimizer=torch.optim.Adam(model.parameters()))
    path = str(tmp_path / "classifier.pth")
    tc.export_classifier_pth(state, path)
    monkeypatch.setattr(jax_clf, "init_resnet_params",
                        lambda m, key: jax_resnet_params(m.config.num_classes, seed=9))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    with small_classifiers(64):
        port, counts = LesionClassifier.from_checkpoint(path, num_classes=NUM_CLASSES,
                                                        device="cpu")
        assert counts == {"loaded": len(model.state_dict()), "skipped": 0}
        jax_side, jax_counts = jax_clf.LesionClassifier.from_checkpoint(
            path, num_classes=NUM_CLASSES)
        assert jax_counts["skipped"] == 0 and jax_counts["loaded"] > 0
        got = port.logits(x)
        want = np.asarray(jax_side.logits(jnp.asarray(x)))
        trained = model.eval()(port_clf.preprocess_for_classifier(torch.from_numpy(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert torch.equal(got, trained.detach())


def _image_folder(root, labels, missing=("ISIC_9999999",)):
    """JPEGs of seeded noise and a one-hot CSV over the 7 ISIC columns (the
    CSV also names images that are not in the folder)."""
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    names = [f"ISIC_{i:07d}" for i in range(len(labels))]
    for name in names:
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            img_dir / f"{name}.jpg")
    csv_path = root / "groundtruth.csv"
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["image", "MEL", "NV", "BCC", "AKIEC", "BKL", "DF", "VASC"])
        for name, label in [*zip(names, labels), *((m, 0) for m in missing)]:
            w.writerow([name, *("1.0" if c == label else "0.0" for c in range(7))])
    return img_dir, csv_path


def test_multiclass_dataset_matches_jax(tmp_path):
    """The same rows (per-class seeded subsets without pandas) and the same
    first batch, value for value."""
    img_dir, csv_path = _image_folder(tmp_path, [1, 0, 4, 1, 1, 0, 4, 1, 4, 1, 0])
    kw = dict(image_size=32, max_samples_per_class=3, seed=5)
    want = jax_data.MultiClassDataset(str(img_dir), str(csv_path), **kw)
    got = data.MultiClassDataset(str(img_dir), str(csv_path), **kw)
    assert got.data == [(str(i), int(lab)) for i, lab in
                        zip(want.data["image"], want.data["label"])]
    assert len(got) == 9
    (wi, wl), = [next(want.batches(4, np.random.default_rng(0), classifier_size=48))]
    (gi, gl), = [next(got.batches(4, np.random.default_rng(0), classifier_size=48))]
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    assert gi.dtype == np.float32 and gi.shape == (4, 48, 48, 3)


def test_entry_point_trains_the_classifier_on_cpu(tmp_path):
    """`--train-classifier --device cpu` writes a `classifier.pth` that the
    port's XAI classifier loads with nothing skipped."""
    img_dir, csv_path = _image_folder(tmp_path, [1, 0, 4, 1, 0, 4, 1, 0])
    rc = train_main.main(["--train-classifier", "--device", "cpu", "--no-bf16",
                          "--data-dir", str(img_dir), "--csv", str(csv_path),
                          "--epochs", "1", "--batch", "4", "--image-size", "32",
                          "--checkpoints", str(tmp_path / "out")])
    assert rc == 0
    _, counts = LesionClassifier.from_checkpoint(str(tmp_path / "out" / "classifier.pth"),
                                                 device="cpu")
    assert counts["skipped"] == 0 and counts["loaded"] == 102
