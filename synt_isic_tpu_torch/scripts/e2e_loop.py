"""Close the FULL loop on actual data, asset-free (VERDICT r2 #2):

The port of `scripts/e2e_loop.py`: the same loop, report keys and flags,
with `--device` (default cuda; raises without CUDA unless `--device cpu`)
in place of `--cpu`. Training runs through the port's `train_class` (on
CUDA the hand-written attention kernels and the f32-statistics GroupNorm
unless `--no-train-fused`; `--remat` as `UNet2D(remat=)` spells it),
sampling through `ImageGenerator`, the XAI through the integrated
analyzer.

    procedural dataset -> train DDPM on device -> torch-format checkpoint
    -> ImageGenerator sampling (DDIM-50 AND DPM-Solver++-20, full artifact
    path: PNG + sidecar + CSV) -> integrated XAI pipeline on a captured
    trajectory -> FID-proxy of both samplers vs held-out data.

This is the one integration seam no unit test crosses (reference shape:
`diffusion/train_diffusion.py:201-266` -> `generate_test.py` -> `XAI.py`),
and it gives DPM-Solver++ its first production-shape sample-quality
evidence: FID(DPM-20) is directly comparable to FID(DDIM-50) against the
same held-out set with the same extractor.

Reference FID anchors emitted alongside: FID(train vs held-out) — the
same-distribution floor — and FID(noise vs held-out) — a garbage ceiling.
A converged sampler must land FAR below the ceiling; how close it gets to
the floor measures sample quality.

Usage:
    python -m synt_isic_tpu_torch.scripts.e2e_loop --size 128 --epochs 120 \
        --out artifacts/e2e_loop
Tiny CPU smoke (`run_loop(..., with_classifier=False, device="cpu")` in
process, as tests/test_torch_e2e_loop.py runs it; `main` always trains the
classifier at 224², which the CPU takes minutes for):
    python -m synt_isic_tpu_torch.scripts.e2e_loop --size 32 --epochs 2 \
        --train-images 16 --heldout 16 --sample-count 4 --ddim-steps 4 \
        --dpm-steps 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import List, Optional


def small_unet_config(size: int):
    """Quarter-width version of the flagship topology (same block types,
    attention at the same stages) — converges in minutes on one chip."""
    from ..models.unet2d import UNet2DConfig

    if size >= 64:
        return UNet2DConfig(
            sample_size=size, layers_per_block=2,
            block_out_channels=(32, 64, 96, 96), attention_head_dim=8,
            norm_num_groups=16,
            down_block_types=("DownBlock2D", "DownBlock2D",
                              "AttnDownBlock2D", "DownBlock2D"),
            up_block_types=("UpBlock2D", "AttnUpBlock2D",
                            "UpBlock2D", "UpBlock2D"))
    return UNet2DConfig(
        sample_size=size, layers_per_block=1,
        block_out_channels=(16, 32, 32), attention_head_dim=8,
        norm_num_groups=8,
        down_block_types=("DownBlock2D", "AttnDownBlock2D", "DownBlock2D"),
        up_block_types=("UpBlock2D", "AttnUpBlock2D", "UpBlock2D"))


def unet_config(size: int, width: str = "quarter"):
    """'full' = the flagship ~25M topology that matches the reference
    checkpoints exactly (the reference's `core/generator/model_manager.py:
    173-194` — UNet2DConfig defaults); 'quarter' = the fast evidence
    topology used for CPU seam tests and round-2/3 chip loops."""
    if width == "full":
        from ..models.unet2d import UNet2DConfig

        return UNet2DConfig(sample_size=size)
    if width != "quarter":
        raise ValueError(f"unknown width {width!r} (quarter|full)")
    return small_unet_config(size)


def load_generated_images(class_dir: Path, limit: int) -> "np.ndarray":
    import numpy as np
    from PIL import Image

    files = sorted(class_dir.glob("ISIC_*.png"))[:limit]
    arrs = [np.asarray(Image.open(f).convert("RGB"), np.float32) / 255.0
            for f in files]
    return np.stack(arrs) * 2.0 - 1.0


def run_loop(out_dir: str, class_name: str = "MEL", size: int = 128,
             train_images: int = 256, heldout: int = 128, epochs: int = 120,
             batch_size: int = 32, sample_count: int = 64,
             ddim_steps: int = 50, dpm_steps: int = 20,
             fast_scheduler: str = "dpm_solver",
             xai_ig: int = 16, xai_shap: int = 64, with_gradcam: bool = True,
             seed: int = 0, skip_train: bool = False,
             offset_noise: float = 0.05, with_classifier: bool = True,
             clf_per_class: int = 64, clf_epochs: int = 8,
             clf_hard: float = 0.0, clf_label_noise: float = 0.0,
             width: str = "quarter", remat=False,
             train_fused: bool = True, resume: bool = False,
             timestep_spacing: str = "trailing", log=print,
             device: Optional[str] = None) -> dict:
    """`device`: CUDA unless the caller names another (raises when CUDA is
    asked for and absent)."""
    import numpy as np
    import torch

    from ..generator import ImageGenerator
    from ..metrics.fid import FeatureExtractor, PixelFeatureExtractor
    from ..model_manager import resolve_device
    from ..train.procedural import ProceduralDataset, procedural_images
    from ..train.train_ddpm import TrainConfig, train_class

    device = resolve_device(device)

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    ckpt_dir = out / "checkpoints"
    report: dict = {"class": class_name, "size": size, "width": width,
                    "train_images": train_images, "epochs": epochs}

    # --- 1. data -----------------------------------------------------------
    t0 = time.time()
    on_accel = device.type != "cpu"
    # device-resident dataset on an accelerator: no per-step host transfer
    dataset = ProceduralDataset(class_name, train_images, size, seed=seed,
                                device=device if on_accel else None)
    held = procedural_images(class_name, heldout, size, seed=seed,
                             start_index=10_000_000)  # disjoint index range
    log(f"[e2e] dataset: {train_images} train + {heldout} held-out "
        f"{size}x{size} ({time.time() - t0:.1f}s)")

    # --- 2. train ----------------------------------------------------------
    cfg = unet_config(size, width)
    from ..models.unet2d import UNet2D

    # remat: rematerialize UNet blocks in the backward pass — activation
    # memory drops enough to double the training batch.
    # train_fused (CUDA only): the training model rides the SAME
    # hand-written attention as the sampling path — K4, the kernel forward
    # with its saved statistics and the recompute backward, keeps the
    # (B,H,T,T) tensors on chip in both directions — plus fast_norm
    # (f32-statistics GroupNorm without f32 activation copies). Weights
    # are f32, seeded from `seed`; the compute is bf16
    fused = bool(train_fused and on_accel)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = UNet2D(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                       remat=remat, use_fused_attention=fused, fast_norm=fused)
    report["train_fused"] = fused
    # snapshot sparingly: each snapshot round pulls ~100 MB of params +
    # optimizer state device->host, which on a throttled link costs more
    # than many epochs of compute
    # offset_noise: without it the trained model's global hue drifts per
    # sample (non-zero terminal SNR of the image-mean channel under the
    # linear beta schedule — see TrainConfig.offset_noise); color
    # postprocessing only papers over that, offset noise fixes it at the root
    # quality levers beyond reference parity (all individually unit-tested,
    # all default-off in TrainConfig itself):
    #   * cosine LR with warmup — anneal instead of jittering at 1e-4;
    #   * min-SNR-5 loss weighting — faster convergence of the mid/high-noise
    #     steps that dominate sample structure;
    #   * deterministic-probe best selection (eval_every) — per-epoch train
    #     loss over ~10 random-t steps is too noisy to select checkpoints on
    #     (measured: noisy-best scored pixel-Frechet 22.4 where the final
    #     EMA scored 11.1 on the same run).
    tcfg = TrainConfig(image_size=size, batch_size=min(batch_size, train_images),
                       epochs=epochs, ema_decay=0.9995, seed=seed,
                       learning_rate=2e-4, lr_schedule="cosine",
                       warmup_steps=500, min_snr_gamma=5.0,
                       eval_every=25, eval_probe_images=16, eval_t_points=8,
                       offset_noise=offset_noise,
                       snapshot_every=max(5, epochs // 6))
    best_ckpt = ckpt_dir / f"unet_{class_name}_best.pth"
    if skip_train and not best_ckpt.exists():
        raise FileNotFoundError(
            f"--skip-train: no checkpoint at {best_ckpt} — point --out at a "
            f"directory holding a previous run's checkpoints/ (refusing to "
            f"silently fall through to an hours-long retrain)")
    if skip_train:
        # reuse the checkpoint from a previous run — re-scoring samplers or
        # metrics does not require an hour of retraining
        from ..io.color_stats import update_color_statistics_file
        from ..train.train_ddpm import dataset_color_statistics

        stats = dataset_color_statistics(dataset)
        if stats is not None:
            update_color_statistics_file(
                ckpt_dir / "color_statistics.json", class_name, stats)
        report["train"] = {"reused_checkpoint": str(best_ckpt)}
        log(f"[e2e] skip-train: reusing {best_ckpt}")
    else:
        t0 = time.time()
        train_result = train_class(class_name, dataset, str(ckpt_dir), tcfg,
                                   model=model, resume=resume, log=log, device=device)
        train_s = time.time() - t0
        # a resumed run whose snapshot had every epoch done runs none
        history = train_result["history"] or [None]
        report["train"] = {"best_loss": train_result["best_loss"],
                           "steps": train_result["steps"],
                           "first_epoch_loss": history[0],
                           "last_epoch_loss": history[-1],
                           "best_val": train_result.get("best_val"),
                           "seconds": round(train_s, 1)}
        log(f"[e2e] trained {train_result['steps']} steps in {train_s:.0f}s: "
            f"loss {history[0]} -> {history[-1]}")

    # --- 2b. train the lesion classifier on the procedural classes ---------
    # Upgrades the rest of the loop from random-init to LEARNED features:
    # XAI attributions explain a classifier that actually discriminates the
    # classes, and the proxy-FID embedding becomes meaningful. Also the
    # first end-to-end exercise of train/train_classifier.py on real
    # hardware (the reference ships no classifier training at all).
    trained_clf = None
    if with_classifier:
        from ..models.classifier import LesionClassifier, preprocess_for_classifier
        from ..train.train_classifier import ClassifierTrainConfig, train_classifier
        from ..utils.config import CLASS_NAMES

        clf_path = ckpt_dir / "classifier.pth"
        clf_classes = [class_name] + [c for c in ("NV", "VASC", "MEL")
                                      if c != class_name][:2]
        labels_all, imgs_all = [], []
        for cname in clf_classes:
            # clf_hard>0: parameter-blended confusable stream (VERDICT r3
            # #5) so the probe operates at non-saturated accuracy
            imgs_all.append(procedural_images(cname, clf_per_class, size,
                                              seed=seed, start_index=20_000_000,
                                              hard=clf_hard))
            labels_all += [CLASS_NAMES.index(cname)] * clf_per_class
        clf_imgs = np.concatenate(imgs_all)
        clf_labels = np.asarray(labels_all, np.int32)
        clf_rng = np.random.default_rng(seed + 7)
        if clf_label_noise > 0.0:
            flip = clf_rng.random(len(clf_labels)) < clf_label_noise
            wrong = clf_rng.integers(0, len(CLASS_NAMES), len(clf_labels))
            clf_labels = np.where(flip, wrong, clf_labels).astype(np.int32)
            log(f"[e2e] classifier label noise: flipped {int(flip.sum())}"
                f"/{len(clf_labels)} training labels")
        clf_bs = min(32, len(clf_imgs))

        def clf_batches(epoch):
            # NHWC ImageNet-normalised, as the classifier's train step takes
            order = clf_rng.permutation(len(clf_imgs))
            for s in range(0, len(order) - clf_bs + 1, clf_bs):
                idx = order[s:s + clf_bs]
                x = torch.from_numpy(clf_imgs[idx]).to(device)
                yield (preprocess_for_classifier(x).permute(0, 2, 3, 1),
                       clf_labels[idx])

        t0 = time.time()
        clf_result = train_classifier(
            clf_batches, ClassifierTrainConfig(epochs=clf_epochs,
                                               batch_size=clf_bs, seed=seed),
            checkpoint_path=str(clf_path), log=log, device=device)
        # reload through the production checkpoint path (partial-merge load)
        trained_clf, counts = LesionClassifier.from_checkpoint(str(clf_path),
                                                               device=device)
        # held-out eval at the SAME hardness and over ALL probe classes —
        # the saturation verdict must reflect the problem the classifier
        # actually faces, not an easier single-class slice
        held_imgs, held_lbls = [], []
        for cname in clf_classes:
            held_imgs.append(procedural_images(
                cname, min(64, heldout), size, seed=seed,
                start_index=30_000_000, hard=clf_hard))
            held_lbls += [CLASS_NAMES.index(cname)] * len(held_imgs[-1])
        held_clf = np.concatenate(held_imgs)
        pred = trained_clf.predict(held_clf).cpu().numpy()
        heldout_acc = float(np.mean(pred == np.asarray(held_lbls)))
        report["classifier"] = {
            "classes": clf_classes, "train_acc": clf_result["best_acc"],
            "hard": clf_hard, "label_noise": clf_label_noise,
            # renamed from 'heldout_acc_target_class' (pre-round-4 reports):
            # the eval is multi-class over clf_classes at `hard`, so the
            # old single-class name made cross-round comparisons
            # apples-to-oranges; a new key keeps the metrics distinct
            "heldout_acc_all_classes": heldout_acc,
            "loaded_tensors": counts["loaded"], "skipped": counts["skipped"],
            "seconds": round(time.time() - t0, 1)}
        log(f"[e2e] classifier: train_acc={clf_result['best_acc']:.3f} "
            f"heldout_acc={heldout_acc:.3f} ({report['classifier']['seconds']}s)")

    # --- 3. sample through the production engine (both samplers) -----------
    # Two passes per sampler with the SAME seed: the raw model output (the
    # convergence verdict must judge the model, not the color-postprocessing
    # stage, which moment-matches toward the very statistics the metric
    # measures) and the postprocessed PRODUCTION output path (training wrote
    # color_statistics.json, so the moment-matching stage runs exactly as it
    # would on real checkpoints).
    # timestep_spacing defaults to 'trailing' (beyond-reference few-step
    # fix): measured -15% (DDIM-50) to -42% (DPM-20) pixel-Fréchet vs the
    # reference's leading spacing on this loop's own checkpoint — recorded
    # in the report and in every sidecar, so reproduction stays exact
    report["timestep_spacing"] = timestep_spacing
    # The 20-step rung's solver is configurable: at FULL width the
    # deterministic DPM-Solver++(2M) misses the strict bar (5.90 vs 4.51)
    # while the SDE variant passes outright (3.24) — the flagship-scale
    # frontier, artifacts/sampler_ladder_full.json. Report keys keep the
    # historical "dpm" names; the scheduler actually used is recorded.
    report["fast_scheduler"] = fast_scheduler
    samples: dict = {}
    for name, scheduler, steps in (("ddim", "ddim", ddim_steps),
                                   ("dpm", fast_scheduler, dpm_steps)):
        for variant, postproc in (("raw", False), ("post", True)):
            gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=cfg,
                                 compute_dtype=torch.bfloat16, device=device)
            gen.scheduler_kind = scheduler
            gen.timestep_spacing = timestep_spacing
            gen.set_inference_steps(steps)
            gen.set_generation_seed(seed + 1)
            gen.batch_size = min(sample_count, 64)
            gen.save_trajectory = False
            run_dir = out / (f"samples_{name}{steps}" if postproc
                             else f"samples_{name}{steps}_raw")
            t0 = time.time()
            result = gen.generate_images([(class_name, sample_count)],
                                         str(run_dir), postprocess=postproc)
            if "error" in result:
                raise RuntimeError(f"{name} sampling failed: {result['error']}")
            imgs = load_generated_images(run_dir / class_name, sample_count)
            samples[f"{name}_{variant}"] = imgs
            if postproc:
                report[f"sample_{name}"] = {
                    "scheduler": scheduler,
                    "steps": steps, "count": int(len(imgs)),
                    "img_per_s": result["images_per_second"],
                    "seconds": round(time.time() - t0, 1)}
                log(f"[e2e] {name}-{steps}: {len(imgs)} images at "
                    f"{result['images_per_second']} img/s")

    # --- 4. XAI on a captured trajectory from the TRAINED model ------------
    from ..xai.integration import IntegratedXAIAnalyzer

    gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=cfg,
                         compute_dtype=torch.bfloat16, device=device)
    gen.set_inference_steps(ddim_steps)
    gen.scheduler_kind = "ddim"
    gen.timestep_spacing = timestep_spacing
    gen.set_generation_seed(seed + 2)
    analyzer = IntegratedXAIAnalyzer(
        classifier=trained_clf,        # trained on the procedural classes
        verbose=False, ig_n_steps=xai_ig, shap_n_samples=xai_shap,
        n_bootstrap=200, n_permutations=500, save_figures=True,
        with_gradcam=with_gradcam, with_sanity=False,
        # axiom-faithful Time-SHAP stage in the real run's artifacts
        coalitional_shap=True, coalitional_permutations=256, device=device)
    gen.set_xai_analyzer(analyzer)
    gen.set_xai_frequency(1)
    xai_dir = out / "xai_run"
    t0 = time.time()
    result = gen.generate_images([(class_name, 1)], str(xai_dir),
                                 postprocess=False)
    if "error" in result:
        raise RuntimeError(f"XAI generation failed: {result['error']}")
    xai_out = list((xai_dir / "xai_results" / class_name).glob("*"))
    artifact_runs = [p for p in xai_out if p.is_dir()]
    n_artifacts = sum(len(list(p.glob("*"))) for p in artifact_runs)
    report["xai"] = {"runs": len(artifact_runs), "artifacts": n_artifacts,
                     "seconds": round(time.time() - t0, 1)}
    if n_artifacts == 0:
        raise RuntimeError("XAI pipeline produced no artifacts")
    log(f"[e2e] XAI: {n_artifacts} artifacts in {report['xai']['seconds']}s")

    # --- 5. FID-proxy: both samplers vs held-out ---------------------------
    # Classifier-feature extractor (no Inception weights needed) — the SAME
    # extractor on every side makes the comparison valid; labeled as proxy.
    from ..metrics.fid import frechet_distance

    rng = np.random.default_rng(seed)
    noise_imgs = rng.uniform(-1, 1, held.shape).astype(np.float32)
    image_sets = {"train": np.asarray(dataset.images[:heldout]),
                  # same-distribution floor at the SAMPLER'S sample count:
                  # with n=64 even a perfect sampler scores above the
                  # 128-vs-128 floor (covariance estimator noise) — this
                  # anchor says how much of the gap is just n
                  "train_n": np.asarray(dataset.images[:sample_count]),
                  "held": held, "noise": noise_imgs, **samples}
    pairs = [("train_vs_heldout_floor", "train", "held"),
             ("train_smalln_vs_heldout_floor", "train_n", "held"),
             ("noise_vs_heldout_ceiling", "noise", "held"),
             ("ddim_vs_heldout", "ddim_raw", "held"),
             ("dpm_vs_heldout", "dpm_raw", "held"),
             ("ddim_vs_dpm", "ddim_raw", "dpm_raw"),
             ("ddim_post_vs_heldout", "ddim_post", "held"),
             ("dpm_post_vs_heldout", "dpm_post", "held")]

    def battery(extractor):
        # embed each image set ONCE; Fréchet math then runs on statistics
        stats = {}
        for key, imgs in image_sets.items():
            f = np.asarray(extractor(imgs), np.float64)
            stats[key] = (f.mean(axis=0), np.cov(f, rowvar=False))
        return {name: frechet_distance(*stats[a], *stats[b])
                for name, a, b in pairs}

    # Two embeddings, same battery:
    #   * pixel: deterministic pooled-pixel Fréchet — weight-free and
    #     trustworthy (a random-init CNN can rank noise above structured
    #     samples), so the convergence VERDICT uses this one;
    #   * proxy: classifier-feature Fréchet, kept for continuity with the
    #     deployed default_extractor fallback path.
    pix = battery(PixelFeatureExtractor())
    prox = battery(FeatureExtractor(classifier=trained_clf, device=device))
    report["fid_pixel"] = {k: round(float(v), 4) for k, v in pix.items()}
    report["fid_proxy"] = {k: round(float(v), 3) for k, v in prox.items()}
    report["fid_extractor"] = (
        "pixel_pooled_192d (deterministic, verdict metric) + "
        "classifier_features_512d "
        + ("(TRAINED on the procedural classes — learned-feature Fréchet)"
           if trained_clf is not None else "(random-init proxy)")
        + ". Same extractor on all sides of each battery — cross-sampler "
        "comparison is valid; absolute values are not Inception-FID. "
        "*_vs_heldout rows judge RAW model output; *_post_vs_heldout rows "
        "are the production path incl. color postprocessing.")
    ceiling = pix["noise_vs_heldout_ceiling"]
    # Quality bar: an order of magnitude under the garbage ceiling in the
    # deterministic pixel embedding, judged on RAW samples (postprocessing
    # moment-matches toward the dataset statistics and must not be allowed
    # to manufacture convergence). Two separate claims, both reported:
    #   * model_converged — the MODEL, judged through the quality-anchor
    #     sampler (DDIM at the reference's default steps);
    #   * sampler_within_bar — per-sampler step adequacy at the configured
    #     step counts (a fast solver can trade quality for steps on a
    #     given checkpoint; scripts/sampler_ladder.py maps that frontier).
    # `converged` stays the STRICT conjunction (unchanged semantics).
    report["quality_bar"] = round(0.1 * ceiling, 4)
    report["model_converged"] = bool(pix["ddim_vs_heldout"] < 0.1 * ceiling)
    report["sampler_within_bar"] = {
        f"ddim{ddim_steps}": bool(pix["ddim_vs_heldout"] < 0.1 * ceiling),
        f"dpm{dpm_steps}": bool(pix["dpm_vs_heldout"] < 0.1 * ceiling)}
    report["converged"] = bool(pix["ddim_vs_heldout"] < 0.1 * ceiling
                               and pix["dpm_vs_heldout"] < 0.1 * ceiling)
    log(f"[e2e] pixel-Frechet: floor={pix['train_vs_heldout_floor']:.3f} "
        f"ddim={pix['ddim_vs_heldout']:.3f} dpm={pix['dpm_vs_heldout']:.3f} "
        f"post=({pix['ddim_post_vs_heldout']:.3f},"
        f"{pix['dpm_post_vs_heldout']:.3f}) "
        f"ceiling={pix['noise_vs_heldout_ceiling']:.3f}")
    log(f"[e2e] FID-proxy: floor={prox['train_vs_heldout_floor']:.2f} "
        f"ddim={prox['ddim_vs_heldout']:.2f} dpm={prox['dpm_vs_heldout']:.2f} "
        f"ceiling={prox['noise_vs_heldout_ceiling']:.2f}")

    # visual evidence strip: held-out reference | 4 DDIM | 4 DPM samples
    try:
        from PIL import Image
        to8 = lambda a: ((np.asarray(a) + 1) * 127.5).clip(0, 255).astype(np.uint8)  # noqa: E731
        strip = np.concatenate([to8(held[0])]
                               + [to8(samples["ddim_post"][i]) for i in range(4)]
                               + [to8(samples["dpm_post"][i]) for i in range(4)],
                               axis=1)
        Image.fromarray(strip).save(out / "samples_preview.png")
        report["preview"] = str(out / "samples_preview.png")
    except Exception:
        pass

    (out / "report.json").write_text(json.dumps(report, indent=2))
    log(f"[e2e] report -> {out / 'report.json'}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="artifacts/e2e_loop")
    p.add_argument("--class", dest="class_name", default="MEL")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--train-images", type=int, default=256)
    p.add_argument("--heldout", type=int, default=128)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--sample-count", type=int, default=64)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--dpm-steps", type=int, default=20)
    p.add_argument("--fast-scheduler", default="dpm_solver",
                   choices=("ddim", "dpm_solver", "dpm_solver_sde", "unipc"),
                   help="solver for the few-step rung (report keys keep "
                        "the historical 'dpm' names; the scheduler used is "
                        "recorded). At full width dpm_solver_sde passes the "
                        "strict bar that dpm_solver misses")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--width", choices=("quarter", "full"), default="quarter",
                   help="'full' = flagship ~25M topology (reference "
                        "checkpoint architecture); 'quarter' = fast "
                        "evidence topology")
    p.add_argument("--clf-hard", type=float, default=0.0,
                   help="classifier-probe confusability in [0,1] — blends "
                        "class parameters toward random confusers so the "
                        "probe does not saturate at 100%% accuracy")
    p.add_argument("--clf-label-noise", type=float, default=0.0,
                   help="fraction of classifier training labels flipped "
                        "to a random class")
    p.add_argument("--remat", nargs="?", const="all", default=False,
                   choices=("all", "hires", "attn", "dots"),
                   help="rematerialize UNet blocks in training backward "
                        "(fits larger batches); bare flag = all blocks, or "
                        "pick a policy mode")
    p.add_argument("--no-train-fused", action="store_true",
                   help="train through the plain PyTorch attention instead of "
                        "the hand-written kernel forward + backward")
    p.add_argument("--timestep-spacing", choices=("leading", "trailing"),
                   default="trailing",
                   help="'trailing' (default) = few-step quality fix; "
                        "'leading' = exact reference scheduler parity")
    p.add_argument("--offset-noise", type=float, default=0.05,
                   help="offset-noise strength for training (controls the "
                        "global-hue channel; see TrainConfig.offset_noise)")
    p.add_argument("--skip-train", action="store_true",
                   help="reuse an existing unet_<CLASS>_best.pth in the "
                        "output checkpoints dir instead of retraining")
    p.add_argument("--resume", action="store_true",
                   help="continue a killed run from the trainer's "
                        "train_state_<CLASS>.pt snapshot (params + "
                        "optimizer state) at the epoch after the "
                        "snapshot's; --epochs is the run's total")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to train, sample and score on")
    args = p.parse_args(argv)

    report = run_loop(args.out, class_name=args.class_name, size=args.size,
                      train_images=args.train_images, heldout=args.heldout,
                      epochs=args.epochs, batch_size=args.batch,
                      sample_count=args.sample_count,
                      ddim_steps=args.ddim_steps, dpm_steps=args.dpm_steps,
                      fast_scheduler=args.fast_scheduler,
                      seed=args.seed, skip_train=args.skip_train,
                      offset_noise=args.offset_noise, width=args.width,
                      remat=args.remat, train_fused=not args.no_train_fused,
                      resume=args.resume, clf_hard=args.clf_hard,
                      clf_label_noise=args.clf_label_noise,
                      timestep_spacing=args.timestep_spacing, device=args.device)
    print(json.dumps({"e2e_loop": "ok", "converged": report["converged"],
                      "model_converged": report["model_converged"],
                      "sampler_within_bar": report["sampler_within_bar"],
                      "fid_pixel": report["fid_pixel"],
                      "fid_proxy": report["fid_proxy"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
