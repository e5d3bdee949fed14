"""Attribution methods: Integrated Gradients, patch-SHAP, Time-SHAP.

The port of `synt_isic_tpu/xai/attribution.py`. Parity targets in the
reference (`xai/XAI.py`):
  * `compute_integrated_gradients` :1039-1109: IG with `riemann_right`
    quadrature (alpha_k = k/n, k = 1..n) over a noise baseline (0.1·N(0,1),
    cached per shape), gradient-attribution fallback;
  * `compute_shap_approximation` :1111-1177: random 16-px patch masks,
    zero baseline, mean masked-score contribution over n_samples;
  * `compute_time_shap` :1179-1234: per-frame classifier confidence and
    per-class score, min-max-normalised importance;
  * `compute_combined_attribution` :1236-1291: weighted sum.
`compute_time_shap_coalitional` is the permutation-sampled Shapley
estimator over timesteps (cummax over the drawn order, then a segment sum
of the marginals).

Batching: IG's alpha points go through the classifier in chunks of
`_largest_divisor(n, batch_size)` (the whole-trajectory path) and one
backward of the summed score gives every point's gradient (frozen
BatchNorm keeps each image's score its own); SHAP's masked copies go in
chunks likewise, without autograd, so peak memory stays bounded. Frames
are NHWC, on the classifier's device.

Randomness: a seed chain (`numpy.random.default_rng(seed)`) hands each
draw a fresh CPU `torch.Generator`, so the card and the CPU draw the same
numbers. The masks of frame i come from a stream that depends only on
(the call's seed, i). Every draw has a keyword seam (`baseline=`,
`patch_masks=`, `permutations=`) so tests can inject another
implementation's draws.

Mesh (`mesh=`, `set_mesh`, reference `attribution.py:93, 146, 384`): the
frame-batched kernels (IG and patch-SHAP over a trajectory, the Time-SHAP
scoring) split the frame axis over the mesh's 'data' axis, padded by
repeating the last frame, each shard on its device with that device's
classifier replica (`parallel.replicas`), one host thread per distinct
device. Every frame runs the same per-frame code with the same draws (the
masks of frame i depend on i alone), so the result does not depend on the
layout. On a 2-D ('data', 'model') mesh the frames split over 'data' on
each row's first device and the 'model' axis replicates, as JAX's
`shard_map` with `P()` does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.classifier import LesionClassifier, SCORE_EPS
from ..parallel.replicas import run_per_device, sampling_replica
from ..parallel.sharded_sampler import shard_frames, sharded_scores
# the one stride-1 count_include_pad average pool, shared with the blur
# intervention so the blur baseline and the blur intervention cannot drift
from .interventions import _avg_pool_same


def check_mesh(mesh, axis: str = "data"):
    """`mesh` when XAI can shard over its `axis` (None passes; a mesh
    without that axis raises). The shards are the first devices of the
    mesh's rows (`Mesh.shard_devices`), so a 'model' axis replicates."""
    if mesh is not None:
        mesh.shard_devices(axis)
    return mesh


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of n not exceeding cap (the batch width of a chunked
    pass)."""
    return next(c for c in range(min(n, cap), 0, -1) if n % c == 0)


def _stream_generator(seed: int, index: int) -> torch.Generator:
    """A CPU generator whose stream depends only on (seed, index)."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


class XAIAnalyzer:
    """Attribution engine over a `LesionClassifier`."""

    def __init__(self, classifier: LesionClassifier,
                 ig_n_steps: int = 50,
                 shap_n_samples: int = 512,
                 shap_patch_size: int = 16,
                 batch_size: int = 128,
                 seed: int = 0,
                 verbose: bool = False,
                 mesh=None,
                 mesh_axis: str = "data"):
        self.classifier = classifier
        self.ig_n_steps = ig_n_steps
        self.shap_n_samples = shap_n_samples
        self.shap_patch_size = shap_patch_size
        self.batch_size = batch_size
        self.verbose = verbose
        self._seeds = np.random.default_rng(seed)
        self._baseline_cache: Dict[Tuple, torch.Tensor] = {}
        self.set_mesh(mesh, mesh_axis)

    def set_mesh(self, mesh, axis: str = "data") -> None:
        """Shard the frame-batched kernels over `mesh` (or not, with None)."""
        self.mesh = check_mesh(mesh, axis)
        self.mesh_axis = axis

    def _over_frames(self, frames: torch.Tensor, per_frame) -> torch.Tensor:
        """`per_frame(classifier, frame, i)` stacked over every frame: on the
        classifier's device, or with a mesh, each shard of the frame axis
        (padded with the last frame) on its device and classifier replica."""
        if self.mesh is None:
            return torch.stack([per_frame(self.classifier, f, i)
                                for i, f in enumerate(frames)])
        spans, padded = shard_frames(frames, self.mesh, self.mesh_axis)
        s = frames.shape[0]

        def work(k: int) -> torch.Tensor:
            d, a, b = spans[k]
            clf = sampling_replica(self.classifier, d)
            return torch.stack([per_frame(clf, padded[i].to(d), min(i, s - 1))
                                for i in range(a, b)]).to(frames.device)

        return torch.cat(run_per_device([d for d, _, _ in spans], work))[:s]

    # -- RNG ------------------------------------------------------------------------
    def _next_seed(self) -> int:
        return int(self._seeds.integers(2 ** 63))

    def _next_generator(self) -> torch.Generator:
        return torch.Generator().manual_seed(self._next_seed())

    def _draw_patch_masks(self, n_frames: int, n: int, ph: int, pw: int) -> torch.Tensor:
        """(n_frames, n, ph, pw) bool patch masks, p = 0.5; frame i's from
        the stream of (this call's seed, i)."""
        seed = self._next_seed()
        return torch.stack([torch.rand((n, ph, pw), generator=_stream_generator(seed, i)) < 0.5
                            for i in range(n_frames)])

    def _draw_permutations(self, n_permutations: int, n_frames: int) -> torch.Tensor:
        """(n_permutations, n_frames) random orders of the frames."""
        return torch.rand((n_permutations, n_frames), generator=self._next_generator()).argsort(1)

    # -- baselines (reference XAI.py:1010-1037) ---------------------------------------
    def _get_baseline(self, image: torch.Tensor, baseline_type: str = "noise") -> torch.Tensor:
        cache_key = (baseline_type, tuple(image.shape))
        if cache_key not in self._baseline_cache:
            if baseline_type == "noise":
                draw = torch.randn(tuple(image.shape), generator=self._next_generator())
                base = 0.1 * draw.to(image.device)
            elif baseline_type == "blur":
                base = _avg_pool_same(image, 31)
            else:  # 'zero' and unknown types
                base = torch.zeros_like(image)
            self._baseline_cache[cache_key] = base
        return self._baseline_cache[cache_key]

    # -- Integrated Gradients ------------------------------------------------------------
    def _ig_frame(self, frame: torch.Tensor, baseline: torch.Tensor, target_class: int,
                  n_steps: int, chunk: int,
                  classifier: Optional[LesionClassifier] = None) -> torch.Tensor:
        """(x - x') · (1/n) Σ_k ∂F(x' + α_k (x - x'))/∂x, α_k = k/n, the
        α points `chunk` at a time, through `classifier` (default: this
        analyzer's)."""
        clf = classifier or self.classifier
        baseline = baseline.to(frame.device)
        alphas = torch.arange(1, n_steps + 1, dtype=torch.float32, device=frame.device) / n_steps
        diff = frame - baseline
        total = torch.zeros_like(frame)
        for start in range(0, n_steps, chunk):
            points = baseline[None] + alphas[start:start + chunk, None, None, None] * diff[None]
            total += clf.input_gradient(points, target_class).sum(dim=0)
        return diff * (total / n_steps)

    def compute_integrated_gradients(self, image, target_class: int,
                                     n_steps: Optional[int] = None,
                                     baseline_type: str = "noise",
                                     baseline: Optional[Any] = None) -> torch.Tensor:
        """IG of one image, (1,H,W,C). `baseline` replaces the drawn one."""
        image = self.classifier.as_input(image)
        n = int(n_steps or self.ig_n_steps)
        baseline = (self.classifier.as_input(baseline) if baseline is not None
                    else self._get_baseline(image, baseline_type))
        chunk = max(1, min(n, self.batch_size))
        if n % chunk:
            chunk = n   # one batch when not evenly divisible, as the reference
        return self._ig_frame(image[0], baseline[0], int(target_class), n, chunk)[None]

    def compute_gradient_attribution(self, image, target_class: int) -> torch.Tensor:
        """Plain input-gradient fallback (reference `XAI.py:1089-1109`)."""
        return self.classifier.input_gradient(image, target_class)

    def compute_ig_frames(self, frames, target_class: int,
                          n_steps: Optional[int] = None,
                          baseline_type: str = "noise",
                          baseline: Optional[Any] = None) -> torch.Tensor:
        """IG for every trajectory frame, (S,H,W,C). The baseline is shared
        across frames (reference semantics: cached per shape); `baseline`
        ((H,W,C) or (1,H,W,C)) replaces the drawn one."""
        frames = self.classifier.as_input(_stack_trajectory(frames))
        n = int(n_steps or self.ig_n_steps)
        baseline = (self.classifier.as_input(baseline) if baseline is not None
                    else self._get_baseline(frames[:1], baseline_type))[0]
        chunk = _largest_divisor(n, self.batch_size)
        return self._over_frames(frames, lambda clf, f, i: self._ig_frame(
            f, baseline, int(target_class), n, chunk, clf))

    # -- patch SHAP ------------------------------------------------------------------------
    def _shap_frame(self, frame: torch.Tensor, patch_masks: torch.Tensor,
                    target_class: int, patch_size: int, chunk: int,
                    classifier: Optional[LesionClassifier] = None) -> torch.Tensor:
        """Mean masked-score contribution against the zero image, per
        pixel, broadcast over channels, through `classifier` (default: this
        analyzer's)."""
        n = patch_masks.shape[0]
        masks = (patch_masks.to(frame.device)
                 .repeat_interleave(patch_size, dim=1)
                 .repeat_interleave(patch_size, dim=2).to(frame.dtype))     # (n, H, W)
        clf = classifier or self.classifier
        scores = torch.cat([clf.get_per_class_score(frame[None] * masks[s:s + chunk, :, :, None],
                                                    target_class)
                            for s in range(0, n, chunk)])
        base = clf.get_per_class_score(torch.zeros_like(frame)[None], target_class)[0]
        attr2d = torch.einsum("n,nhw->hw", scores - base, masks) / n
        return attr2d[:, :, None].expand(frame.shape)

    def compute_shap_approximation(self, image, target_class: int,
                                   n_samples: Optional[int] = None,
                                   patch_size: Optional[int] = None,
                                   patch_masks: Optional[Any] = None) -> torch.Tensor:
        """Patch-SHAP of one image, (1,H,W,C). `patch_masks` ((n, H/p, W/p)
        bool) replaces the drawn masks."""
        image = self.classifier.as_input(image)
        n = int(n_samples or self.shap_n_samples)
        p = int(patch_size or self.shap_patch_size)
        _, h, w, _ = image.shape
        masks = (torch.as_tensor(np.array(patch_masks)) if patch_masks is not None
                 else torch.rand((n, h // p, w // p), generator=self._next_generator()) < 0.5)
        chunk = max(1, min(n, self.batch_size))
        if n % chunk:
            chunk = n
        return self._shap_frame(image[0], masks, int(target_class), p, chunk)[None]

    def compute_shap_frames(self, frames, target_class: int,
                            n_samples: Optional[int] = None,
                            patch_size: Optional[int] = None,
                            patch_masks: Optional[Any] = None) -> torch.Tensor:
        """Patch-SHAP for every frame, (S,H,W,C). `patch_masks` ((S, n, H/p,
        W/p) bool) replaces the drawn masks."""
        frames = self.classifier.as_input(_stack_trajectory(frames))
        n = int(n_samples or self.shap_n_samples)
        p = int(patch_size or self.shap_patch_size)
        s, h, w, _ = frames.shape
        masks = (torch.as_tensor(np.array(patch_masks)) if patch_masks is not None
                 else self._draw_patch_masks(s, n, h // p, w // p))
        chunk = _largest_divisor(n, self.batch_size)
        return self._over_frames(frames, lambda clf, f, i: self._shap_frame(
            f, masks[i], int(target_class), p, chunk, clf))

    # -- Time-SHAP ---------------------------------------------------------------------------
    def _frame_probabilities(self, frames: torch.Tensor) -> np.ndarray:
        """Classifier probabilities of a stack of frames: in chunks on the
        classifier's device, or one shard per mesh device."""
        if self.mesh is not None:
            return sharded_scores(
                lambda shard: sampling_replica(self.classifier, shard.device)
                .get_probabilities(shard), frames, self.mesh, self.mesh_axis)
        return np.concatenate([
            self.classifier.get_probabilities(frames[s:s + self.batch_size]).cpu().numpy()
            for s in range(0, frames.shape[0], self.batch_size)])

    def compute_time_shap(self, trajectory, timesteps: Sequence[float], target_class: int
                          ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Per-frame importance over the denoising trajectory, all frames
        scored in batches."""
        p = self._frame_probabilities(_stack_trajectory(trajectory))
        prob_scores = p[:, target_class]
        confidence_scores = np.log(prob_scores + SCORE_EPS)

        rng = confidence_scores.max() - confidence_scores.min()
        if len(confidence_scores) > 1 and rng > 1e-6:
            importance = (confidence_scores - confidence_scores.min()) / rng
        else:
            importance = np.ones_like(confidence_scores) / len(confidence_scores)

        raw = {
            "confidence_scores": confidence_scores,
            "probability_scores": prob_scores,
            "timesteps": list(timesteps),
        }
        return importance, raw

    def compute_time_shap_coalitional(self, trajectory, timesteps, target_class: int,
                                      n_permutations: int = 64,
                                      baseline: str = "first",
                                      frame_scores: Optional[np.ndarray] = None,
                                      permutations: Optional[Any] = None) -> Dict[str, Any]:
        """Shapley values over timesteps by permutation sampling.

        A coalition S of frames reveals its latest frame (closest to t=0);
        v(S) is that frame's classifier score, v(∅) the baseline frame's.
        v depends only on the largest index in S, so each permutation's
        marginals are a cummax over the drawn order; the efficiency axiom
        Σφ = v(full) − v(∅) holds by construction. `frame_scores` (from
        `compute_time_shap`) saves the classifier pass; `permutations`
        ((P, S) ints) replaces the drawn ones.
        """
        frames = _stack_trajectory(trajectory)
        s = frames.shape[0]
        if frame_scores is None:
            p = self._frame_probabilities(frames)
            frame_scores = np.log(p[:, target_class] + SCORE_EPS)
        else:
            frame_scores = np.asarray(frame_scores, np.float64)
            if frame_scores.shape[0] != s:
                raise ValueError(f"frame_scores has {frame_scores.shape[0]} entries for "
                                 f"{s} trajectory frames")
        v_empty = frame_scores[0] if baseline == "first" else 0.0

        perms = (torch.as_tensor(np.array(permutations), dtype=torch.int64)
                 if permutations is not None else self._draw_permutations(n_permutations, s))
        scores = torch.as_tensor(np.array(frame_scores, np.float32))
        vals = scores[torch.cummax(perms, dim=1).values]      # v after each draw
        prev = torch.cat([torch.full((perms.shape[0], 1), float(np.float32(v_empty))),
                          vals[:, :-1]], dim=1)
        phi = (torch.zeros(s).index_add_(0, perms.reshape(-1), (vals - prev).reshape(-1))
               / perms.shape[0]).numpy()
        return {
            "shapley_values": phi,
            "efficiency_gap": float(phi.sum() - (frame_scores[-1] - v_empty)),
            "frame_scores": frame_scores,
            "timesteps": list(timesteps),
            "n_permutations": n_permutations,
        }

    # -- combined ------------------------------------------------------------------------------
    def compute_combined_attribution(self, image, target_class: int,
                                     methods: Sequence[str] = ("ig", "shap"),
                                     weights: Optional[Sequence[float]] = None
                                     ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Weighted combination (reference `XAI.py:1236-1291`)."""
        if weights is None:
            weights = [1.0 / len(methods)] * len(methods)
        attributions: List[torch.Tensor] = []
        details: Dict[str, Any] = {}
        for method, weight in zip(methods, weights):
            if method == "ig":
                attr = self.compute_integrated_gradients(image, target_class)
            elif method == "shap":
                attr = self.compute_shap_approximation(image, target_class)
            elif method == "gradient":
                attr = self.compute_gradient_attribution(image, target_class)
            else:
                continue
            attributions.append(attr * weight)
            details[method] = {
                "weight": float(weight),
                "mean_attribution": float(attr.abs().mean()),
                "max_attribution": float(attr.abs().max()),
            }
        if not attributions:
            raise RuntimeError("no attribution method produced a result")
        return torch.stack(attributions).sum(dim=0), details


def _stack_trajectory(trajectory) -> torch.Tensor:
    """A list of (H,W,C)/(1,H,W,C) frames or an (S,[1,]H,W,C) array or
    tensor -> an (S,H,W,C) f32 tensor where it already lies."""
    def tensor(x):
        return (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))).float()

    if isinstance(trajectory, (list, tuple)):
        frames = [tensor(f) for f in trajectory]
        return torch.stack([f[0] if f.ndim == 4 else f for f in frames])
    frames = tensor(trajectory)
    return frames[:, 0] if frames.ndim == 5 else frames
