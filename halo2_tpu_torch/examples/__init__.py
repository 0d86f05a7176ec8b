"""Port counterparts of the reference's examples/*.py, importing only the
port; each runs with `python -m halo2_tpu_torch.examples.<name>`, on the
card unless its `main` is given `device="cpu"`."""
