"""Validation CLI (ref: tools/validate_3d.py — without the reference's latent
argument-shift bug; this delegates to the same path as evaluate)."""

from selfpose3d_tpu_torch.cli.evaluate import main

if __name__ == "__main__":
    main()
