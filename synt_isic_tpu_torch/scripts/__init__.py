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

`ladder_common` holds the scoring battery the ladders share.
"""
