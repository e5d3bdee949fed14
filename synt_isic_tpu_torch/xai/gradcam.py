"""Grad-CAM over the classifier's last convolution, by autograd.

The port of `synt_isic_tpu/xai/gradcam.py`. Parity target: the
reference's pytorch_grad_cam block (`xai/XAI.py:2941-3170`): the CAM of
`classifier.model.layer4[-1].conv2` (`XAI.py:2947`), per trajectory frame,
and the jet overlay (`overlay_cam_on_image`, `show_cam_on_image`).

The ResNet exposes `features_and_logits` (the target activation as an
output) and `logits_from_activation` (the tail rerun from it), so the
activation's gradient is one `torch.autograd.grad` over a whole frame
batch, with no hooks:
    w_c = mean over space of dy/dA_c,
    CAM = relu(Σ_c w_c · A_c), min-max per image,
resized bilinearly as `jax.image.resize` does (`ops/resize.py`) to the
classifier's input size.

With a mesh (reference `gradcam.py:35-56, 106`) the frame batch is padded
by repeating its last frame and split over the mesh's 'data' axis, each
shard's CAMs computed on its device's classifier replica; every CAM is
its own image's, so the result does not depend on the layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.classifier import LesionClassifier
from ..ops.resize import resize_bilinear
from ..parallel.replicas import run_per_device, sampling_replica
from ..parallel.sharded_sampler import shard_frames
from .attribution import check_mesh


def compute_gradcam(classifier: LesionClassifier, images, target_class: int,
                    output_size: int = 224, mesh=None,
                    mesh_axis: str = "data") -> np.ndarray:
    """images: (B,H,W,C) in [-1,1] diffusion space. Returns (B, output_size,
    output_size) CAMs in [0,1]."""
    if check_mesh(mesh, mesh_axis) is not None:
        frames = classifier.as_input(images)
        spans, padded = shard_frames(frames, mesh, mesh_axis)
        cams = run_per_device([d for d, _, _ in spans], lambda k: compute_gradcam(
            sampling_replica(classifier, spans[k][0]),
            padded[spans[k][1]:spans[k][2]], target_class, output_size))
        return np.concatenate(cams)[:frames.shape[0]]
    _, act, block_input = classifier.gradcam_tensors(images)
    act = act.requires_grad_(True)
    with torch.enable_grad():
        out = classifier.logits_from_activation(act, block_input)
        (grads,) = torch.autograd.grad(out[:, int(target_class)].sum(), act)
    with torch.no_grad():
        weights = grads.mean(dim=(2, 3))                                  # (B, C)
        cam = torch.relu(torch.einsum("bchw,bc->bhw", act, weights))
        lo = cam.amin(dim=(1, 2), keepdim=True)
        hi = cam.amax(dim=(1, 2), keepdim=True)
        cam = (cam - lo) / (hi - lo + 1e-7)
        cam = resize_bilinear(cam[:, None], (output_size, output_size))[:, 0]
        return torch.clamp(cam, 0.0, 1.0).cpu().numpy()


def overlay_cam_on_image(rgb01: np.ndarray, cam: np.ndarray,
                         alpha: float = 0.5) -> np.ndarray:
    """`show_cam_on_image` equivalent: the jet-coloured CAM blended onto the
    RGB image. rgb01: (H,W,3) floats in [0,1]; cam: (H,W) in [0,1].
    Returns uint8 (H,W,3)."""
    import matplotlib.cm as mpl_cm

    heat = mpl_cm.jet(np.clip(cam, 0, 1))[..., :3]
    blended = alpha * heat + (1 - alpha) * np.clip(rgb01, 0, 1)
    blended = blended / max(blended.max(), 1e-7)
    return (blended * 255).astype(np.uint8)
