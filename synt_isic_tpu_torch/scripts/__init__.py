"""Entry points that score and check image sets and checkpoints, each the
port of the JAX package's script of the same name under `scripts/`, with
its flags and report keys and `--device` (default cuda; cpu only when
asked) in place of `--cpu`:

    python -m synt_isic_tpu_torch.scripts.eval_fid --a DIR_A --b DIR_B
    python -m synt_isic_tpu_torch.scripts.fairness_audit --images DIR
    python -m synt_isic_tpu_torch.scripts.parity_gauntlet --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.e2e_loop --out DIR
    python -m synt_isic_tpu_torch.scripts.score_checkpoint --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.sampler_ladder --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.distill_ladder --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.augment_eval --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.train_family --out DIR
    python -m synt_isic_tpu_torch.scripts.score_family --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.rescore_family_consistency --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.e2e_conditional --out DIR

and the tool scripts, each the port of the JAX script of the same name
(`--device` where it runs a model; `convert_checkpoint` and
`convert_inception` stay on the host):

    python -m synt_isic_tpu_torch.scripts.smoke_generate --checkpoints DIR
    python -m synt_isic_tpu_torch.scripts.convert_checkpoint inspect DIR/unet_MEL_best.pth
    python -m synt_isic_tpu_torch.scripts.convert_inception --out DIR/inception_v3.pth
    python -m synt_isic_tpu_torch.scripts.warm_cache

Each has `main(argv=None, model_config=None)`. `ladder_common` holds the
scoring battery the ladders share.
"""
